"""``pw.iterate`` — fixed-point iteration.

Parity with reference ``Table.iterate``/``pw.iterate`` (engine ``iterate``,
dataflow.rs:3737; Python ``IterateOperator``): run a body function mapping
tables to tables until the iterated tables stop changing (or iteration_limit).

Engine design: the body is captured once as a sub-dataflow; each outer epoch
that changes the inputs recomputes the fixpoint and emits the output delta
(non-incremental across iterations, incremental at the outer boundary — the
totally-ordered-time analog of nested differential scopes). Each round runs
the sub-dataflow on a nested ``Scheduler``: one thread, UDFs on the blocking
path, and with several processes the same lockstep loop as the outer run
under the node's private control-tag namespace.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from pathway_tpu_torch.engine.batch import Batch
from pathway_tpu_torch.engine.graph import EngineGraph, Node
from pathway_tpu_torch.engine.operators.core import InputNode, diff_tables
from pathway_tpu_torch.engine.operators.output import CaptureNode
from pathway_tpu_torch.engine.scheduler import Scheduler
from pathway_tpu_torch.engine.state import TableState, rows_equal
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.universe import Universe


class _IterationResult(dict):
    """Mapping of output name -> Table, attribute-accessible."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)


class IterateNode(Node):
    """Engine node embedding a sub-dataflow executed to fixpoint."""

    def __init__(
        self,
        graph,
        outer_inputs: list[Node],
        subgraph: EngineGraph,
        sub_inputs: list[InputNode],  # iterated entry nodes
        sub_outputs: list[Node],  # corresponding body outputs (same order)
        result_node_index: int,
        iteration_limit: int | None,
        name="Iterate",
    ):
        super().__init__(
            graph,
            outer_inputs,
            sub_outputs[result_node_index].column_names,
            name,
        )
        self.subgraph = subgraph
        self.sub_inputs = sub_inputs
        self.sub_outputs = sub_outputs
        self.result_node_index = result_node_index
        self.iteration_limit = iteration_limit
        self._in_states = [TableState(i.column_names) for i in outer_inputs]
        self._emitted: dict[int, tuple] = {}
        # multi-process fixpoint coordination (set by splice_exchanges):
        # rounds run in LOCKSTEP across processes, rows hopping through the
        # exchanges spliced into the subgraph; barriers are tagged from a
        # private control namespace so concurrent sibling iterates and the
        # outer scheduler's rounds can never collide
        self.exchange_ctx = None
        self.ctl_base = 0
        self._ctl_seq = 0
        # the fixpoint state of EVERY output after the latest epoch's run —
        # sibling nodes (other outputs of a multi-table iterate) read from
        # here instead of re-running the shared subgraph (which would both
        # duplicate the distributed fixpoint per output and race on shared
        # node state / exchange tags under threads > 1)
        self._epoch_results: list[dict[int, tuple]] = [{} for _ in sub_outputs]
        # fixpoint rounds run since the run started (each one a nested
        # scheduler over the subgraph)
        self.rounds = 0

    @property
    def always_step(self) -> bool:
        # under a peer mesh every epoch opens with a control_allgather — a
        # collective; a process skipping the step (no local deltas) while a
        # peer enters it would wedge the round. Single-process fixpoints
        # no-op on all-None input, so the sparse-stepping skip stays valid.
        return self.exchange_ctx is not None

    def reset(self):
        self._in_states = [TableState(i.column_names) for i in self.inputs]
        self._emitted = {}
        self._epoch_results = [{} for _ in self.sub_outputs]
        self.rounds = 0

    def ensure_captures(self) -> list[CaptureNode]:
        if not hasattr(self, "_captures"):
            self._captures = [CaptureNode(self.subgraph, o) for o in self.sub_outputs]
        return self._captures

    def _next_ctl_tag(self) -> int:
        """Next tag from this node's private monotonic namespace (~17e9
        tags at 1<<34 spacing — enough for any run length; allocation is
        lockstep across processes so tags always line up)."""
        tag = self.ctl_base + self._ctl_seq
        self._ctl_seq += 1
        return tag

    def step(self, time, ins):
        changed = False
        for st, batch in zip(self._in_states, ins):
            if batch is not None and len(batch) > 0:
                st.apply(batch)
                changed = True
        ctx = self.exchange_ctx
        if ctx is not None:
            # every process must enter the fixpoint together (the rounds
            # exchange rows): agree whether ANY shard changed this epoch
            states = ctx.control_allgather(self._next_ctl_tag(), changed)
            if not any(states.values()):
                return None
        elif not changed:
            return None
        # fixpoint: current collections start as the outer inputs
        currents = [dict(st.rows) for st in self._in_states]
        limit = self.iteration_limit if self.iteration_limit is not None else 10_000

        def tables_equal(a, b):
            return all(
                set(x) == set(y) and all(rows_equal(x[k], y[k]) for k in x)
                for x, y in zip(a, b)
            )

        for _round in range(limit):
            outs = self._run_body(currents)
            converged = tables_equal(outs, currents)
            currents = outs
            if ctx is not None:
                # the fixpoint is GLOBAL: loop until every shard is stable
                states = ctx.control_allgather(self._next_ctl_tag(), converged)
                converged = all(states.values())
            if converged:
                break
        self._epoch_results = currents
        result = currents[self.result_node_index]
        out = diff_tables(self._emitted, result, self.column_names)
        self._emitted = result
        return out

    def _round_config(self):
        """The outer run's config with one thread (a pool per round would
        leak workers; the subgraph is small anyway)."""
        from pathway_tpu_torch.internals import config as config_mod

        sched = getattr(self, "scheduler", None)
        outer = sched.config if sched is not None else config_mod.active()
        return dataclasses.replace(outer, threads=1)

    def _run_body(self, currents: list[dict[int, tuple]]) -> list[dict[int, tuple]]:
        captures = self.ensure_captures()
        self.rounds += 1
        # one Scheduler per fixpoint round. Several processes: the
        # sub-scheduler runs the SAME lockstep loop as the outer one (the
        # subgraph is already spliced, so its splice pass is a no-op) under
        # a private control-tag block; its exchanges are served even by
        # processes whose shard is empty.
        ctx = self.exchange_ctx
        sched = Scheduler(
            self.subgraph, captures, config=self._round_config(), exchange_ctx=ctx,
            ctl_tag_alloc=self._next_ctl_tag if ctx is not None else None,
            allow_deferred=False,
        )
        for n in sched.order:
            n.reset()
        for inp in self.sub_inputs:
            sched.register_source(inp, 0)
        for inp, rows in zip(self.sub_inputs, currents):
            if rows:
                batch = Batch.from_rows(inp.column_names, [(k, r, 1) for k, r in rows.items()])
                sched.inject(inp, 0, batch)
            sched.close_source(inp)
        # static tables built INSIDE the body (debug tables, constants) are
        # registered as parse-graph static sources on subgraph nodes: feed
        # them each round (process 0 only under a mesh — the subgraph's
        # exchanges route rows to their owners, same as the outer run)
        order_ids = {n.id for n in sched.order}
        inject_static = ctx is None or ctx.process_id == 0
        for node, provider in G.static_sources.values():
            if node.graph is self.subgraph and node.id in order_ids:
                sched.register_source(node, 0)
                if inject_static:
                    batch = provider()
                    if batch is not None and len(batch) > 0:
                        sched.inject(node, 0, batch)
                sched.close_source(node)
        sched.run()
        # no teardown_exchanges here — the subgraph splice belongs to the
        # OUTER scheduler's teardown, and the mesh stays open
        sched.shutdown()
        return [dict(c.state.rows) for c in captures]


class IterateSiblingNode(Node):
    """A secondary output of a multi-table ``pw.iterate``: reads the
    primary IterateNode's cached fixpoint results instead of re-running
    the shared subgraph (one distributed fixpoint per epoch total). Taking
    the primary as input pins the topo order: the primary's level always
    completes before siblings step, even with threads > 1."""

    # reads the primary's ``_epoch_results`` side channel, which can change
    # even when the primary's OWN output delta (this node's input) is None —
    # must not be skipped by the scheduler's sparse stepping
    always_step = True

    def __init__(self, graph, primary: IterateNode, result_node_index: int,
                 name="IterateOut"):
        super().__init__(
            graph,
            [primary],
            primary.sub_outputs[result_node_index].column_names,
            name,
        )
        self.primary = primary
        self.result_node_index = result_node_index
        self._emitted: dict[int, tuple] = {}

    def reset(self):
        self._emitted = {}

    def step(self, time, ins):
        result = self.primary._epoch_results[self.result_node_index]
        out = diff_tables(self._emitted, result, self.column_names)
        self._emitted = dict(result)
        return out


def iterate(
    body: Callable,
    iteration_limit: int | None = None,
    **kwargs,
):
    """Iterate ``body`` to fixpoint over the keyword tables.

    ``body`` receives tables (same names as kwargs) and returns a dict /
    namespace of tables with the same keys; iteration continues until
    nothing changes.
    """
    from pathway_tpu_torch.internals import parse_graph as pg
    from pathway_tpu_torch.internals.table import Table

    if iteration_limit is not None and not isinstance(iteration_limit, int):
        raise TypeError(
            "iteration_limit must be an int; pass tables as keyword "
            "arguments: pw.iterate(body, t=t)"
        )
    names = list(kwargs.keys())
    outer_tables: list[Table] = [kwargs[n] for n in names]

    subgraph = EngineGraph(parent=G.engine_graph)
    sub_inputs: list[InputNode] = []
    sub_tables: list[Table] = []
    # build placeholder tables backed by subgraph input nodes
    outer_engine_graph = G.engine_graph
    pg.G.engine_graph = subgraph
    try:
        for t in outer_tables:
            inode = InputNode(subgraph, list(t.column_names()), name="IterateIn")
            sub_inputs.append(inode)
            sub_tables.append(Table(inode, t._schema, Universe()))
        result = body(**dict(zip(names, sub_tables)))
        returned_bare_table = isinstance(result, Table)
        if isinstance(result, dict):
            result_items = list(result.items())
        elif isinstance(result, Table):
            if len(names) != 1:
                raise ValueError(
                    "iterate body returned a single table but was given "
                    f"{len(names)} tables; return a dict instead"
                )
            result_items = [(names[0], result)]
        else:
            result_items = [(n, getattr(result, n)) for n in names]
    finally:
        pg.G.engine_graph = outer_engine_graph

    # the iterated outputs, aligned with inputs by name
    out_by_name = dict(result_items)
    sub_outputs = []
    for n in names:
        if n not in out_by_name:
            raise ValueError(f"iterate body must return table {n!r}")
        sub_outputs.append(out_by_name[n]._node)

    # loud error instead of silent emptiness: a body that closes over an
    # OUTER table would compute every round against zero rows (the sub-run
    # feeds only the iterated entry tables)
    stack: list[Node] = list(sub_outputs)
    seen: set[int] = set()
    while stack:
        nd = stack.pop()
        if nd.id in seen:
            continue
        seen.add(nd.id)
        for i in nd.inputs:
            if i.graph is subgraph:
                stack.append(i)
            else:
                raise ValueError(
                    f"pw.iterate body references outer table node "
                    f"{i.name!r}: pass outer tables as pw.iterate keyword "
                    "arguments (and return them unchanged) so every "
                    "iteration round sees their rows"
                )

    results = _IterationResult()
    # ONE IterateNode runs the fixpoint (emitting output 0); the other
    # outputs are sibling views over its cached per-output results
    primary = IterateNode(
        G.engine_graph,
        [t._node for t in outer_tables],
        subgraph,
        sub_inputs,
        sub_outputs,
        0,
        iteration_limit,
    )
    results[names[0]] = Table(primary, out_by_name[names[0]]._schema, Universe())
    for idx, n in enumerate(names[1:], start=1):
        node = IterateSiblingNode(G.engine_graph, primary, idx)
        results[n] = Table(node, out_by_name[n]._schema, Universe())
    # mirror the body's return shape (reference behavior): a bare table
    # comes back bare; a dict/namespace keeps attribute access even for one
    # table
    if len(names) == 1 and returned_bare_table:
        return results[names[0]]
    return results


def iterate_universe(body, **kwargs):
    return iterate(body, **kwargs)
