"""Incremental reducer accumulators.

Parity with reference ``src/engine/reduce.rs`` (Reducer enum: Count, FloatSum,
IntSum, ArraySum, Unique, Min, ArgMin, Max, ArgMax, SortedTuple, Tuple, Any,
Stateful, Earliest, Latest). Each accumulator supports add with positive and
negative diffs (retraction-correct), like the semigroup/full-state split in
the reference.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.engine.value import ERROR


class Accumulator:
    def add(self, args: tuple, diff: int, time: int) -> None:
        raise NotImplementedError

    def compute(self) -> Any:
        raise NotImplementedError

    def is_empty(self) -> bool:
        raise NotImplementedError


class CountAcc(Accumulator):
    __slots__ = ("n",)

    def __init__(self):
        self.n = 0

    def add(self, args, diff, time):
        self.n += diff

    def compute(self):
        return self.n

    def is_empty(self):
        return self.n == 0


class SumAcc(Accumulator):
    __slots__ = ("total", "n")

    def __init__(self):
        self.total = 0
        self.n = 0

    def add(self, args, diff, time):
        v = args[0]
        if v is ERROR:
            return
        contrib = v * diff
        if isinstance(self.total, int) and self.total == 0 and not isinstance(v, (int, float)):
            self.total = contrib
        else:
            self.total = self.total + contrib
        self.n += diff

    def compute(self):
        return self.total

    def is_empty(self):
        return self.n == 0


class MeanAcc(Accumulator):
    __slots__ = ("total", "n")

    def __init__(self):
        self.total = 0.0
        self.n = 0

    def add(self, args, diff, time):
        v = args[0]
        if v is ERROR:
            return
        self.total += v * diff
        self.n += diff

    def compute(self):
        return self.total / self.n if self.n else ERROR

    def is_empty(self):
        return self.n == 0


class _MultisetAcc(Accumulator):
    """Multiset of argument tuples — full-state reducers. Stores original
    args keyed by a hashable encoding (ndarrays etc. normalized)."""

    __slots__ = ("_entries",)

    def __init__(self):
        self._entries: dict[Any, list] = {}  # hkey -> [args, count]

    def add(self, args, diff, time):
        hk = _hashable(args)
        entry = self._entries.get(hk)
        if entry is None:
            entry = [args, 0]
            self._entries[hk] = entry
        entry[1] += diff
        if entry[1] == 0:
            del self._entries[hk]

    def items(self):
        for entry in self._entries.values():
            yield entry[0], entry[1]

    def is_empty(self):
        return not self._entries


def _hashable_one(a):
    if isinstance(a, np.ndarray):
        return ("__nd__", tuple(a.ravel().tolist()), a.shape)
    if isinstance(a, (tuple, list)):
        return tuple(_hashable_one(x) for x in a)
    if isinstance(a, dict):
        return tuple(sorted((k, _hashable_one(v)) for k, v in a.items()))
    return a


def _hashable(args: tuple):
    return tuple(_hashable_one(a) for a in args)


def _unhash(v):
    return v


class MinAcc(_MultisetAcc):
    def compute(self):
        vals = [a[0] for a, _c in self.items() if a[0] is not ERROR and a[0] is not None]
        return min(vals) if vals else ERROR


class MaxAcc(_MultisetAcc):
    def compute(self):
        vals = [a[0] for a, _c in self.items() if a[0] is not ERROR and a[0] is not None]
        return max(vals) if vals else ERROR


class ArgMinAcc(_MultisetAcc):
    # args = (value, key_pointer)
    def compute(self):
        entries = [a for a, _c in self.items() if a[0] is not ERROR]
        if not entries:
            return ERROR
        return min(entries, key=lambda t: (t[0], t[1]))[1]


class ArgMaxAcc(_MultisetAcc):
    def compute(self):
        entries = [a for a, _c in self.items() if a[0] is not ERROR]
        if not entries:
            return ERROR
        return max(entries, key=lambda t: (t[0], _NegOrder(t[1])))[1]


class _NegOrder:
    """Reverses tie-breaking so argmax picks the smallest key on ties."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __gt__(self, other):
        return other.v > self.v

    def __eq__(self, other):
        return other.v == self.v


class UniqueAcc(_MultisetAcc):
    def compute(self):
        vals = []
        seen = set()
        for a, _c in self.items():
            hk = _hashable_one(a[0])
            if hk not in seen:
                seen.add(hk)
                vals.append(a[0])
        if len(vals) != 1:
            return ERROR
        return vals[0]


class AnyAcc(_MultisetAcc):
    def compute(self):
        entries = [a for a, _c in self.items()]
        if not entries:
            return ERROR
        return sorted(entries, key=lambda t: repr(t))[0][0]


class SortedTupleAcc(_MultisetAcc):
    __slots__ = ("skip_nones",)

    def __init__(self, skip_nones: bool = False):
        super().__init__()
        self.skip_nones = skip_nones

    def compute(self):
        out = []
        for a, c in self.items():
            v = a[0]
            if v is None and self.skip_nones:
                continue
            out.extend([v] * c)
        try:
            return tuple(sorted(out))
        except TypeError:
            return tuple(out)


class TupleAcc(_MultisetAcc):
    """Ordered tuple: by (time, key) of arrival, or by the user's
    ``groupby(sort_by=...)`` key first (time as tie-break) when
    ``user_order`` is set; args = (value, order_key)."""

    __slots__ = ("skip_nones", "user_order", "_times")

    def __init__(self, skip_nones: bool = False, user_order: bool = False):
        super().__init__()
        self.skip_nones = skip_nones
        self.user_order = user_order
        self._times: dict[Any, int] = {}

    def add(self, args, diff, time):
        hk = _hashable(args)
        if hk not in self._times:
            self._times[hk] = time
        entry = self._entries.get(hk)
        if entry is None:
            entry = [args, 0]
            self._entries[hk] = entry
        entry[1] += diff
        if entry[1] == 0:
            del self._entries[hk]
            self._times.pop(hk, None)

    def compute(self):
        items = []
        for hk, (args, c) in self._entries.items():
            v, order = args[0], args[1] if len(args) > 1 else None
            if v is None and self.skip_nones:
                continue
            t = self._times.get(hk, 0)
            sort_key = (order, t) if self.user_order else (t, order)
            items.extend([(sort_key, v)] * max(c, 0))
        try:
            items.sort(key=lambda t: t[0])
        except TypeError:
            items.sort(key=lambda t: repr(t[0]))
        return tuple(v for _o, v in items)


class NdarrayAcc(TupleAcc):
    def compute(self):
        vals = super().compute()
        return np.array(vals)


class EarliestAcc(Accumulator):
    """Earliest/latest need to know WHICH insertion a retraction cancels;
    value-based matching guesses wrong whenever duplicates were inserted at
    different times (FIFO eviction retracts the OLD copy). The groupby
    passes each row's engine key (``wants_key``), and entries are kept per
    row key, so a retraction cancels exactly its row's insertion time."""

    wants_key = True

    __slots__ = ("_by_key", "_live")

    def __init__(self):
        # row key -> list of [args, insert_time, count]
        self._by_key: dict[Any, list[list]] = {}
        self._live = 0

    def add(self, args, diff, time, key=None):
        lst = self._by_key.setdefault(key, [])
        self._live += diff
        if diff > 0:
            remaining = diff
            h = _hashable(args)
            # settle out-of-order retraction debt first
            for e in lst:
                if remaining == 0:
                    break
                if e[2] < 0 and _hashable(e[0]) == h:
                    take = min(remaining, -e[2])
                    e[2] += take
                    remaining -= take
            if remaining:
                for e in lst:
                    if e[1] == time and e[2] > 0 and _hashable(e[0]) == h:
                        e[2] += remaining
                        break
                else:
                    lst.append([args, time, remaining])
            self._by_key[key] = [e for e in lst if e[2] != 0]
            if not self._by_key[key]:
                del self._by_key[key]
            return
        # retraction: cancel this row key's matching-value entries (oldest
        # first), one multiplicity unit at a time (consolidate may sum
        # several retractions into one diff)
        remaining = -diff
        h = _hashable(args)
        for e in sorted(lst, key=lambda e: e[1]):
            if remaining == 0:
                break
            if e[2] > 0 and _hashable(e[0]) == h:
                take = min(remaining, e[2])
                e[2] -= take
                remaining -= take
        if remaining:
            # out-of-order retraction (deletion seen before its insertion):
            # record the debt; a later insertion with matching value cancels
            lst.append([args, time, -remaining])
        self._by_key[key] = [e for e in lst if e[2] != 0]
        if not self._by_key[key]:
            del self._by_key[key]

    def is_empty(self):
        return self._live <= 0

    def _best(self, select):
        live = [
            e for lst in self._by_key.values() for e in lst if e[2] > 0
        ]
        if not live:
            return ERROR
        return select(live, key=lambda e: e[1])[0][0]

    def compute(self):
        return self._best(min)


class LatestAcc(EarliestAcc):
    def compute(self):
        return self._best(max)


class StatefulAcc(Accumulator):
    """Arbitrary Python combine (reference ``Reducer::Stateful``).

    Retractions recompute from the retained multiset: net counts per row are
    maintained, and compute() replays only rows with positive net count.
    """

    __slots__ = ("combine_fn", "_net")

    def __init__(self, combine_fn: Callable):
        self.combine_fn = combine_fn
        self._net: dict[Any, list] = {}  # hashable -> [args, net_count]

    def add(self, args, diff, time):
        hk = _hashable(args)
        entry = self._net.get(hk)
        if entry is None:
            entry = [args, 0]
            self._net[hk] = entry
        entry[1] += diff
        if entry[1] == 0:
            del self._net[hk]

    def compute(self):
        rows = [
            (args, count) for args, count in self._net.values() if count > 0
        ]
        return self.combine_fn(None, rows)

    def is_empty(self):
        return not self._net


REDUCER_FACTORIES: dict[str, Callable[..., Accumulator]] = {
    "count": CountAcc,
    "sum": SumAcc,
    "int_sum": SumAcc,
    "float_sum": SumAcc,
    "array_sum": SumAcc,
    "npsum": SumAcc,
    "avg": MeanAcc,
    "min": MinAcc,
    "max": MaxAcc,
    "argmin": ArgMinAcc,
    "argmax": ArgMaxAcc,
    "unique": UniqueAcc,
    "any": AnyAcc,
    "earliest": EarliestAcc,
    "latest": LatestAcc,
}


def make_accumulator(name: str, kwargs: dict) -> Accumulator:
    if name == "sorted_tuple":
        return SortedTupleAcc(skip_nones=kwargs.get("skip_nones", False))
    if name == "tuple":
        return TupleAcc(
            skip_nones=kwargs.get("skip_nones", False),
            user_order=kwargs.get("user_order", False),
        )
    if name == "ndarray":
        return NdarrayAcc(
            skip_nones=kwargs.get("skip_nones", False),
            user_order=kwargs.get("user_order", False),
        )
    if name == "stateful":
        return StatefulAcc(kwargs["combine_fn"])
    factory = REDUCER_FACTORIES.get(name)
    if factory is None:
        raise ValueError(f"unknown reducer {name!r}")
    return factory()
