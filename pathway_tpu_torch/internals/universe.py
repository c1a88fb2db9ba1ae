"""Universes — key-set identities and their subset/equality reasoning.

Parity with reference ``internals/{universe,universes,universe_solver}.py``.
The reference's solver encodes set relations as SAT clauses over "an
arbitrary element x" (var_U ⇔ x ∈ U) and answers subset queries by
unsatisfiability (``universe_solver.py:38-41,130``). This build uses the
SAME encoding with a built-in DPLL solver (unit propagation + branching) —
clause sets are tiny (2-3 literals, one var per universe), so no external
python-sat dependency is needed, and entailments like "the union of
disjoint subsets covering U equals U" hold exactly.
"""

from __future__ import annotations

import itertools


class Universe:
    _ids = itertools.count()

    def __init__(self):
        self.id = next(Universe._ids)
        # Table.update_id_type override: the dtype of row ids is a property
        # of the KEY SPACE, so it rides the universe and flows to every
        # derived (subset) universe automatically
        self.id_dtype = None

    def __repr__(self):
        return f"Universe({self.id})"

    def subset(self) -> "Universe":
        u = Universe()
        u.id_dtype = self.id_dtype
        register_subset(u, self)
        return u

    def superset(self) -> "Universe":
        u = Universe()
        register_subset(self, u)
        return u


def _sat(clauses: list[tuple[int, ...]]) -> bool:
    """Satisfiability of a CNF (lists of non-zero int literals) via DPLL."""

    def simplify(cls, lit):
        out = []
        for c in cls:
            if lit in c:
                continue
            if -lit in c:
                c = tuple(x for x in c if x != -lit)
                if not c:
                    return None  # conflict
            out.append(c)
        return out

    def propagate(cls):
        while True:
            unit = next((c[0] for c in cls if len(c) == 1), None)
            if unit is None:
                return cls
            cls = simplify(cls, unit)
            if cls is None:
                return None

    # iterative DPLL (explicit stack): components can hold thousands of
    # universes in a long-lived process; recursing per decision would hit
    # Python's recursion limit
    stack = [list(clauses)]
    while stack:
        cls = propagate(stack.pop())
        if cls is None:
            continue
        if not cls:
            return True
        lit = cls[0][0]
        for branch_lit in (lit, -lit):
            branch = simplify(cls, branch_lit)
            if branch is not None:
                stack.append(branch)
    return False


class UniverseSolver:
    """SAT-backed set-relation solver (reference ``UniverseSolver``)."""

    def __init__(self):
        self._vars: dict[int, int] = {}  # universe id -> SAT var
        self._var_counter = itertools.count(start=1)
        self._clauses: list[tuple[int, ...]] = []
        # var -> clause indices touching it: queries solve only the
        # connected component of the queried vars, so the process-global
        # solver stays fast no matter how many graphs a process builds
        self._by_var: dict[int, list[int]] = {}
        self._cache: dict[tuple[int, int], bool] = {}

    def _var(self, u: Universe) -> int:
        v = self._vars.get(u.id)
        if v is None:
            v = next(self._var_counter)
            self._vars[u.id] = v
        return v

    def _add(self, *clause: int) -> None:
        idx = len(self._clauses)
        self._clauses.append(tuple(clause))
        for lit in clause:
            self._by_var.setdefault(abs(lit), []).append(idx)
        self._cache.clear()

    def _relevant(self, *seed_vars: int) -> list[tuple[int, ...]]:
        """Clauses in the connected component of the seed vars."""
        seen_vars = set(seed_vars)
        seen_clauses: set[int] = set()
        stack = list(seed_vars)
        while stack:
            v = stack.pop()
            for ci in self._by_var.get(v, ()):
                if ci in seen_clauses:
                    continue
                seen_clauses.add(ci)
                for lit in self._clauses[ci]:
                    av = abs(lit)
                    if av not in seen_vars:
                        seen_vars.add(av)
                        stack.append(av)
        return [self._clauses[ci] for ci in seen_clauses]

    # ------------------------------------------------------------ register
    def register_as_subset(self, sub: Universe, sup: Universe) -> None:
        # x∈sub => x∈sup
        self._add(-self._var(sub), self._var(sup))

    def register_as_equal(self, a: Universe, b: Universe) -> None:
        self.register_as_subset(a, b)
        self.register_as_subset(b, a)

    def register_as_disjoint(self, a: Universe, b: Universe) -> None:
        # not (x∈a and x∈b)
        self._add(-self._var(a), -self._var(b))

    def register_as_intersection(self, result: Universe, *args: Universe) -> None:
        for arg in args:
            self.register_as_subset(result, arg)
        # (all args) => result
        self._add(self._var(result), *[-self._var(a) for a in args])

    def register_as_union(self, result: Universe, *args: Universe) -> None:
        for arg in args:
            self.register_as_subset(arg, result)
        # result => (some arg)
        self._add(-self._var(result), *[self._var(a) for a in args])

    def register_as_difference(
        self, result: Universe, left: Universe, right: Universe
    ) -> None:
        """result = left - right."""
        self.register_as_subset(result, left)
        self.register_as_disjoint(result, right)
        # (left and not right) => result
        self._add(self._var(result), -self._var(left), self._var(right))

    # --------------------------------------------------------------- query
    def query_is_subset(self, sub: Universe, sup: Universe) -> bool:
        a, b = self._var(sub), self._var(sup)
        if a == b:
            return True
        key = (a, b)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        # sub ⊆ sup iff (clauses ∧ x∈sub ∧ x∉sup) is UNSAT
        res = not _sat(self._relevant(a, b) + [(a,), (-b,)])
        self._cache[key] = res
        return res

    def query_are_equal(self, a: Universe, b: Universe) -> bool:
        return self.query_is_subset(a, b) and self.query_is_subset(b, a)

    def query_are_disjoint(self, a: Universe, b: Universe) -> bool:
        # disjoint iff (x∈a ∧ x∈b) is UNSAT
        va, vb = self._var(a), self._var(b)
        return not _sat(self._relevant(va, vb) + [(va,), (vb,)])

    # ------------------------------------------------------------- derive
    def get_subset(self, superset: Universe) -> Universe:
        u = Universe()
        self.register_as_subset(u, superset)
        return u

    def get_superset(self, subset: Universe) -> Universe:
        u = Universe()
        self.register_as_subset(subset, u)
        return u

    def get_intersection(self, *universes: Universe) -> Universe:
        # an existing universe already a subset of all → reuse (keeps
        # restrict/intersect from inventing fresh key identities)
        for u in universes:
            if all(self.query_is_subset(u, other) for other in universes):
                return u
        inter = Universe()
        self.register_as_intersection(inter, *universes)
        return inter

    def get_union(self, *universes: Universe) -> Universe:
        for u in universes:
            if all(self.query_is_subset(other, u) for other in universes):
                return u
        union = Universe()
        self.register_as_union(union, *universes)
        return union

    def get_difference(self, a: Universe, b: Universe) -> Universe:
        diff = Universe()
        self.register_as_difference(diff, a, b)
        return diff


GLOBAL_SOLVER = UniverseSolver()


def register_subset(sub: Universe, sup: Universe) -> None:
    GLOBAL_SOLVER.register_as_subset(sub, sup)


def register_equal(a: Universe, b: Universe) -> None:
    GLOBAL_SOLVER.register_as_equal(a, b)


def _as_universe(x) -> Universe:
    return x if isinstance(x, Universe) else x._universe


def promise_are_pairwise_disjoint(*tables_or_universes) -> None:
    """Declare pairwise-disjoint key sets (reference
    ``universes.promise_are_pairwise_disjoint``) — recorded as SAT clauses
    so e.g. a union of disjoint subsets covering U entails equality to U."""
    us = [_as_universe(x) for x in tables_or_universes]
    for i, a in enumerate(us):
        for b in us[i + 1:]:
            GLOBAL_SOLVER.register_as_disjoint(a, b)


def promise_are_equal(*tables_or_universes) -> None:
    """Declare the arguments (tables or universes) share one key set
    (reference ``pathway.universes.promise_are_equal``)."""
    us = [_as_universe(x) for x in tables_or_universes]
    for other in us[1:]:
        register_equal(us[0], other)


def promise_is_subset_of(sub, sup) -> None:
    register_subset(_as_universe(sub), _as_universe(sup))
