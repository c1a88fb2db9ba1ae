"""Hybrid retrieval with Reciprocal Rank Fusion (reference
``stdlib/indexing/hybrid_index.py:14``): fuse rankings from several
DataIndexes (e.g. vector KNN + BM25).

Each sub-index is asked for twice the matches; a match scores
``1 / (k + rank + 1)`` in each ranking it appears in, summed, and the
fused ranking keeps the top ``number_of_matches`` (ties in first-seen
order). A sub-index's equal scores come back in the order their rows
arrived, which follows the query row's id (a REST request's is random);
the port orders them by the row's ``repr`` before fusing, so a query's
fused answer is one function of the sub-indexes' scores (JAX fuses them
in arrival order). Beyond JAX's facade, ``number_of_matches`` may be a
column and ``with_distances=True`` adds ``_pw_dist`` (minus the fused
score, lowest first), which ``DocumentStore.retrieve_query`` asks for.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference


class HybridIndex:
    def __init__(self, inner_indexes: list, k: float = 60.0):
        self.inner_indexes = inner_indexes
        self.k = k


def canonical_ranking(rows, dists) -> list[str]:
    """A sub-index's matches as ``repr(row)`` keys, best first, equal
    distances ordered by the key."""
    return [key for _d, key in sorted(zip(dists, map(repr, rows)))]


def rrf_fuse(rankings, limit: int, k: float = 60.0) -> list[tuple[Any, float]]:
    """Reciprocal Rank Fusion of ``rankings`` (lists of hashable matches,
    best first): ``[(match, fused score)]``, best first, at most ``limit``,
    ties in first-seen order."""
    scores: dict[Any, float] = {}
    for ranking in rankings:
        for rank, match in enumerate(ranking):
            scores[match] = scores.get(match, 0.0) + 1.0 / (k + rank + 1)
    return sorted(scores.items(), key=lambda kv: -kv[1])[:limit]


class HybridIndexDataIndex:
    """DataIndex-like facade fusing results of several DataIndexes."""

    def __init__(self, indexes: list, k: float = 60.0):
        self.indexes = indexes
        self.k = k

    def query_as_of_now(
        self,
        query_column,
        *,
        number_of_matches: int | ColumnExpression = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter=None,
    ):
        if not collapse_rows:
            raise NotImplementedError("hybrid index returns collapsed rows")
        k_rrf = self.k
        sub_results = [
            idx.query_as_of_now(
                query_column,
                number_of_matches=number_of_matches * 2,
                collapse_rows=True,
                with_distances=True,
                metadata_filter=metadata_filter,
            )
            for idx in self.indexes
        ]
        data_cols = [c for c in sub_results[0].column_names() if c != "_pw_dist"]
        base = sub_results[0]
        # zip sub-results per query key (same universe: the query table)
        packed_cols = {}
        for i, sub in enumerate(sub_results):
            for c in [*data_cols, "_pw_dist"]:
                packed_cols[f"__s{i}_{c}"] = sub[c]
        if isinstance(number_of_matches, ColumnExpression):
            query_table = (
                query_column.table
                if isinstance(query_column, ColumnReference)
                else query_column._tables()[0]
            )
            limits = query_table.select(__limit=number_of_matches)
            packed_cols["__limit"] = limits.restrict(base)["__limit"]
        else:
            packed_cols["__limit"] = expr_mod.ColumnConstExpression(int(number_of_matches))
        packed = base.select(**packed_cols)

        n_idx = len(sub_results)
        n_cols = len(data_cols)
        width = n_cols + 1  # the data columns, then the distances

        def fuse(limit, *tuples_per_index):
            # tuples_per_index: for each sub-index, the per-column tuples in
            # rank order and the distances; a match is identified by its
            # whole row
            rows: dict[str, tuple] = {}
            rankings = []
            for i in range(n_idx):
                cols = tuples_per_index[i * width : i * width + n_cols]
                sub_rows = [tuple(col[r] for col in cols) for r in range(len(cols[0]))]
                rows.update((repr(row), row) for row in sub_rows)
                rankings.append(canonical_ranking(sub_rows, tuples_per_index[i * width + n_cols]))
            ranked = rrf_fuse(rankings, int(limit), k_rrf)
            fused_cols = [tuple(rows[key][ci] for key, _s in ranked) for ci in range(n_cols)]
            fused_cols.append(tuple(-s for _key, s in ranked))
            return tuple(fused_cols)

        fused = packed.select(
            __fused=expr_mod.apply_with_type(
                fuse,
                dt.ANY_TUPLE,
                packed["__limit"],
                *[packed[f"__s{i}_{c}"] for i in range(n_idx) for c in [*data_cols, "_pw_dist"]],
            )
        )
        out = {
            c: expr_mod.GetExpression(fused["__fused"], ci, check_if_exists=False)
            for ci, c in enumerate(data_cols)
        }
        if with_distances:
            out["_pw_dist"] = expr_mod.GetExpression(
                fused["__fused"], n_cols, check_if_exists=False)
        return fused.select(**out)

    query = query_as_of_now


@dataclass
class HybridIndexFactory:
    retriever_factories: list = field(default_factory=list)
    k: float = 60.0

    def build_index(self, data_column, data_table, metadata_column=None):
        indexes = [
            f.build_index(data_column, data_table, metadata_column=metadata_column)
            for f in self.retriever_factories
        ]
        return HybridIndexDataIndex(indexes, self.k)
