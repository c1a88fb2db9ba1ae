"""DataIndex — the retrieval API of record (reference
``stdlib/indexing/data_index.py``: InnerIndex:206, DataIndex:278, query:349,
query_as_of_now:412).

A DataIndex wraps a data table + an inner index over one of its columns;
``query_as_of_now`` answers each query once against the live index and joins
back requested data columns (collapsed into rank-ordered tuples or flattened
one-row-per-match).
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals import thisclass
from pathway_tpu_torch.internals.desugaring import substitute
from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference


class InnerIndex:
    """Base inner index: knows how to turn the indexed column (and queries)
    into index/query vectors and an engine index factory."""

    def __init__(self, data_column: ColumnReference, metadata_column=None):
        self.data_column = data_column
        self.metadata_column = metadata_column

    @property
    def data_table(self):
        return self.data_column.table

    def index_vector_expr(self) -> ColumnExpression:
        return self.data_column

    def query_vector_expr(self, query_column: ColumnExpression) -> ColumnExpression:
        return query_column

    def make_factory(self):
        raise NotImplementedError

    def score_to_dist(self, score_expr: ColumnExpression) -> ColumnExpression:
        return -score_expr


class DataIndex:
    def __init__(self, data_table, inner_index: InnerIndex):
        self.data_table = data_table
        self.inner_index = inner_index

    def query_as_of_now(
        self,
        query_column: ColumnExpression,
        *,
        number_of_matches: int | ColumnExpression = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: ColumnExpression | None = None,
    ):
        return self._query(
            query_column,
            number_of_matches=number_of_matches,
            collapse_rows=collapse_rows,
            with_distances=with_distances,
            metadata_filter=metadata_filter,
        )

    def query(
        self,
        query_column: ColumnExpression,
        *,
        number_of_matches: int | ColumnExpression = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: ColumnExpression | None = None,
    ):
        # full (non-as-of-now) mode would re-answer queries on index change;
        # the as-of-now engine path is used for both (documented divergence,
        # matching the dominant RAG usage).
        return self._query(
            query_column,
            number_of_matches=number_of_matches,
            collapse_rows=collapse_rows,
            with_distances=with_distances,
            metadata_filter=metadata_filter,
        )

    def _query(
        self,
        query_column,
        *,
        number_of_matches,
        collapse_rows,
        with_distances,
        metadata_filter,
    ):
        inner = self.inner_index
        query_table = (
            query_column.table
            if isinstance(query_column, ColumnReference)
            else query_column._tables()[0]
        )
        query_column = substitute(query_column, {thisclass.this: query_table})
        limit_expr = (
            number_of_matches
            if isinstance(number_of_matches, ColumnExpression)
            else expr_mod.ColumnConstExpression(int(number_of_matches))
        )
        reply = self.data_table._external_index_as_of_now(
            inner.make_factory(),
            query_table,
            index_column=inner.index_vector_expr(),
            query_column=inner.query_vector_expr(query_column),
            index_filter_data_column=inner.metadata_column,
            query_filter_column=metadata_filter,
            query_responses_limit_column=limit_expr,
        )
        # reply: keyed by query id, _pw_index_reply = ((ptr, score), ...)
        with_qid = reply.with_columns(
            __qid=expr_mod.ColumnReference(reply, "id")
        )
        flat = with_qid.flatten(with_qid._pw_index_reply)
        matched = flat.select(
            __qid=flat["__qid"],
            __ptr=flat._pw_index_reply.get(0),
            __score=flat._pw_index_reply.get(1),
        )
        data = self.data_table
        data_cols = [c for c in data.column_names()]
        # pointer GATHER, not a hash join: ``__ptr`` IS the data row key
        # (the index replies with row pointers), so IxNode looks replies
        # up against the data table's state directly — a hash join here
        # would re-shuffle the whole data table (with its vectors) into
        # join buckets just to serve key-equality lookups
        target = data.ix(matched["__ptr"])
        joined = matched.select(
            matched["__qid"],
            matched["__score"],
            **{c: target[c] for c in data_cols},
        )
        if collapse_rows:
            grouped = joined.groupby(joined["__qid"])
            agg = {
                c: reducers.tuple(
                    expr_mod.make_tuple(-joined["__score"], joined[c])
                )
                for c in data_cols
            }
            agg["_pw_index_reply_score"] = reducers.tuple(joined["__score"])
            red = grouped.reduce(__qid=joined["__qid"], **agg)

            def sort_tuples(pairs):
                pairs = sorted(pairs, key=lambda p: p[0])
                return tuple(p[1] for p in pairs)

            rekeyed = red.with_id(red["__qid"])
            out_exprs = {
                c: expr_mod.apply_with_type(
                    sort_tuples, dt.ANY_TUPLE, rekeyed[c]
                )
                for c in data_cols
            }
            if with_distances:
                out_exprs["_pw_dist"] = expr_mod.apply_with_type(
                    lambda scores: tuple(sorted((-s for s in scores))),
                    dt.ANY_TUPLE,
                    rekeyed["_pw_index_reply_score"],
                )
            collapsed = rekeyed.select(**out_exprs)
            # left-join onto the full query universe (queries with no match
            # get empty tuples)
            empty = query_table.select(
                **{c: expr_mod.ColumnConstExpression(()) for c in data_cols},
                **(
                    {"_pw_dist": expr_mod.ColumnConstExpression(())}
                    if with_distances
                    else {}
                ),
            )
            result = empty.update_rows(
                collapsed.promise_universe_is_subset_of(empty)
            )
            return result
        else:
            out = {c: joined[c] for c in data_cols}
            if with_distances:
                out["_pw_dist"] = -joined["__score"]
            out["_pw_query_id"] = joined["__qid"]
            return joined.select(**out)
