"""Engine operator graph.

The analog of the reference's ``Graph`` trait + dataflow construction
(``src/engine/graph.rs``, ``src/engine/dataflow.rs``), redesigned: operators
are columnar-batch transformers wired into a DAG; a scheduler pumps logical
epochs through the DAG in timestamp order (totally-ordered times make
epoch-synchronous execution equivalent to differential dataflow's
single-dimension case).
"""

from __future__ import annotations

import itertools
from typing import Callable, Iterable

from pathway_tpu_torch.engine.batch import Batch


class Node:
    """Base engine operator."""

    _ids = itertools.count()

    def __init__(self, graph: "EngineGraph", inputs: list["Node"], column_names: list[str], name: str = ""):
        self.id = next(Node._ids)
        self.graph = graph
        self.inputs = list(inputs)
        self.column_names = list(column_names)
        self.name = name or type(self).__name__
        # user-frame attribution (reference internals/trace.py): captured at
        # build time, used to re-point engine errors at the user's code line
        from pathway_tpu_torch.internals.trace import capture_trace

        self.trace = capture_trace(skip=2)
        graph.add_node(self)

    def __repr__(self):
        return f"<{self.name}#{self.id}>"

    # --- execution interface ---
    def step(self, time: int, ins: list[Batch | None]) -> Batch | None:
        """Process one epoch's input deltas; return output deltas."""
        raise NotImplementedError

    def on_time_end(self, time: int) -> list[tuple[int, Batch]]:
        """Called after epoch ``time`` is complete everywhere; may emit
        deltas at strictly later times (buffer releases, async results)."""
        return []

    def reset(self) -> None:
        """Drop run-scoped state (engine graphs can be executed repeatedly)."""

    # sparse epoch stepping: when False (default) the scheduler SKIPS this
    # node's step() in epochs where every input delta is None and nothing
    # was injected for it — every shipped operator no-ops on an all-None
    # step, so skipping is free. Operators with step-side effects that must
    # run every epoch (ExchangeNode serving its peers) set this True.
    always_step: bool = False

    # nodes whose reset() clears run outputs rather than dataflow state
    # (capture / subscribe / sink), and plan nodes whose members are all
    # stateless: not stateful, so no exchange is spliced before them and
    # operator persistence neither snapshots them nor degrades for them
    # (JAX's ``_persist_exempt``, folded into this one flag)
    _output_side: bool = False

    # --- operator persistence (reference: operator_snapshot.rs) ---
    # attribute names holding this operator's run-scoped state; () = either
    # stateless or not snapshottable (see is_stateful / _output_side)
    _state_attrs: tuple[str, ...] = ()

    def is_stateful(self) -> bool:
        """Whether the operator keeps dataflow state across epochs: the
        multi-process splice routes its input rows to their owner process
        first (``engine/exchange.py:splice_exchanges``), and
        operator-persisting mode needs its snapshot to restore a run."""
        cls = type(self)
        return cls.reset is not Node.reset and not self._output_side

    def state_snapshot(self) -> bytes | None:
        """This operator's state for operator-persisting mode, as store
        bytes (``engine.state.host_state``: a tensor in it in its host
        form), or None if it is stateless / not snapshottable."""
        if not self._state_attrs:
            return None
        import logging

        from pathway_tpu_torch.engine.state import host_state

        try:
            return host_state({a: getattr(self, a) for a in self._state_attrs})
        except Exception as exc:  # non-picklable state (e.g. closures)
            logging.getLogger("pathway_tpu_torch").warning(
                "operator %s state not snapshottable (%s); next run will "
                "fall back to input-snapshot replay",
                self,
                exc,
            )
            return None

    def state_restore(self, state: bytes) -> None:
        """Restore state produced by :meth:`state_snapshot`; its tensors
        come back on the devices they were on."""
        from pathway_tpu_torch.engine.state import place_state

        for attr, value in place_state(state).items():
            setattr(self, attr, value)


class FusedChainNode(Node):
    """Execution-plan node running a linear chain of stateless per-row
    operators as ONE step per epoch.

    The scheduler's epoch pump pays, per operator per epoch, a Python
    dispatch, a ``Batch`` rematerialization and a consolidate pass — the
    "engine tax" that put the engine-level ingest path at 0.76x of the
    kernel-level headline. A chain of stateless per-row operators
    (select / filter / remove_errors / column projection) needs none of
    that: the composed column program can run over the raw
    ``(keys, cols, diffs)`` arrays once per batch. Filter masks apply
    immediately (row narrowing stays in chain order, so error-log and
    value semantics are byte-identical to the unfused graph), no
    intermediate ``Batch`` objects exist, and the scheduler consolidates
    once at the chain's tail instead of once per member.

    This is a PLAN node, not a graph node: it is built by
    :func:`fuse_chains` from a scheduler's topo order, takes over the tail
    member's id (so downstream input lookups and injections keep working)
    and is never registered in the user's :class:`EngineGraph` — the global
    graph stays untouched and later runs can plan differently.
    """

    _output_side = True  # members are all stateless; reset() just chains

    def __init__(self, members: list[Node], stages: list[Callable]):
        # deliberately NOT calling Node.__init__: no fresh id, no trace
        # capture, no graph registration
        head, tail = members[0], members[-1]
        self.id = tail.id
        self.graph = tail.graph
        self.inputs = list(head.inputs)
        self.column_names = list(tail.column_names)
        self.name = "Fused[" + "+".join(m.name for m in members) + "]"
        self.trace = tail.trace
        self.members = list(members)
        self._stages = list(stages)

    def reset(self) -> None:
        for m in self.members:
            m.reset()

    def step(self, time: int, ins: list[Batch | None]) -> Batch | None:
        (batch,) = ins
        if batch is None or len(batch) == 0:
            return None
        keys, cols, diffs = batch.keys, batch.cols, batch.diffs
        for member, stage in zip(self.members, self._stages):
            try:
                res = stage(keys, cols, diffs)
            except Exception as exc:
                # re-point the error at the MEMBER's user frame, not the
                # chain's tail (add_error_trace is idempotent: the
                # scheduler's outer handler won't re-attribute)
                from pathway_tpu_torch.internals.trace import add_error_trace

                raise add_error_trace(exc, member.trace)
            if res is None:
                return None
            keys, cols, diffs = res
        return Batch(keys, cols, diffs)


def fuse_chains(
    order: list[Node], targets: Iterable[Node] | None = None
) -> tuple[list[Node], list[list[Node]]]:
    """Rewrite a scheduler plan: collapse linear chains of stateless
    per-row operators into :class:`FusedChainNode` instances.

    A node joins a chain when ``operators.core.fusable_stage`` recognises
    it (stateless Rowwise / Filter / SelectColumns / RemoveErrors with the
    default ``on_time_end`` and no flush hook) AND the chain link is
    private: the upstream member has exactly one consumer within ``order``
    and is not a requested target (targets' outputs must stay visible under
    their own id; only a chain TAIL may be a target, since the fused node
    inherits the tail's id). Chains shorter than two nodes are left alone.

    Returns ``(new_order, chains)`` — ``new_order`` has each chain replaced
    by its fused node at the tail's position (topologically sound: the
    fused node's inputs are the head's inputs, which precede the head).
    The input ``order`` and the underlying graph are not mutated.
    """
    from pathway_tpu_torch.engine.operators.core import fusable_stage

    stage_of: dict[int, Callable] = {}
    for n in order:
        st = fusable_stage(n)
        if st is not None:
            stage_of[n.id] = st
    if not stage_of:
        return list(order), []
    order_ids = {n.id for n in order}
    target_ids = {t.id for t in targets} if targets is not None else set()
    consumers: dict[int, list[Node]] = {}
    for n in order:
        for i in n.inputs:
            if i.id in order_ids:
                consumers.setdefault(i.id, []).append(n)

    def extends(up: Node) -> Node | None:
        """The unique fusable consumer ``up`` can chain into, if any."""
        if up.id in target_ids:
            return None
        outs = consumers.get(up.id, ())
        if len(outs) != 1:
            return None
        nxt = outs[0]
        return nxt if nxt.id in stage_of else None

    chains: list[list[Node]] = []
    in_chain: set[int] = set()
    for n in order:  # topo order: heads are visited before their members
        if n.id not in stage_of or n.id in in_chain:
            continue
        inp = n.inputs[0]
        if inp.id in stage_of and extends(inp) is n:
            continue  # n belongs to the chain started at its ancestor
        chain = [n]
        while True:
            nxt = extends(chain[-1])
            if nxt is None:
                break
            chain.append(nxt)
        if len(chain) >= 2:
            chains.append(chain)
            in_chain.update(m.id for m in chain)

    if not chains:
        return list(order), []
    fused_by_tail = {
        chain[-1].id: FusedChainNode(chain, [stage_of[m.id] for m in chain])
        for chain in chains
    }
    new_order: list[Node] = []
    for n in order:
        fused = fused_by_tail.get(n.id)
        if fused is not None:
            new_order.append(fused)
        elif n.id not in in_chain:
            new_order.append(n)
    return new_order, chains


class EngineGraph:
    def __init__(self, parent: "EngineGraph | None" = None):
        self.nodes: list[Node] = []
        self.parent = parent

    def add_node(self, node: Node) -> None:
        self.nodes.append(node)

    def topo_order(self, targets: Iterable[Node] | None = None) -> list[Node]:
        """Topological order of nodes reaching ``targets`` (tree-shaken);
        all nodes if targets is None."""
        if targets is None:
            wanted = set(n.id for n in self.nodes)
        else:
            wanted = set()
            stack = list(targets)
            while stack:
                n = stack.pop()
                if n.id in wanted:
                    continue
                wanted.add(n.id)
                stack.extend(i for i in n.inputs if i.graph is self)
        order: list[Node] = []
        seen: set[int] = set()

        def visit(n: Node):
            if n.id in seen or n.id not in wanted:
                return
            seen.add(n.id)
            for i in n.inputs:
                if i.graph is self:
                    visit(i)
            order.append(n)

        for n in self.nodes:
            visit(n)
        return order

    def reset_all(self) -> None:
        for n in self.nodes:
            n.reset()
