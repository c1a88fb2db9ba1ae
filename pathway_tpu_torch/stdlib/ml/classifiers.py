"""LSH-based kNN classifiers (counterpart of
``pathway_tpu/stdlib/ml/classifiers.py``; reference ``stdlib/ml/classifiers/``:
``_lsh.py``, ``_knn_lsh.py:63-325``, ``_clustering_via_lsh.py:31``).

The classifier keeps the reference's public API — ``knn_lsh_classifier_train``
returns a query callable ``(queries, k, with_distances) -> Table`` — but the
dataflow shape is our own: instead of materialising ``L`` per-band candidate
columns and merging them with ``update_rows``, both sides flatten their bucket
vectors to ``(band, bucket)`` rows and meet in a single join, with candidate
sets collected by one groupby.  Distances for the (small) candidate sets are
computed host-side per query; the exact path on the card is
``knn_classifier`` over ``stdlib/ml/index.KNNIndex``.

``clustering_via_lsh`` runs the representatives' k-means on the card
(``ops/ivf.kmeans_fit``) with TF32 off: the initial centroids are picked on
the host in numpy exactly as JAX picks them, so labels equal JAX's but at
near-ties of the f32 distances.
"""

from __future__ import annotations

import builtins
from collections import Counter
from typing import Literal

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals.schema import Schema
from pathway_tpu_torch.stdlib.ml._lsh import (
    generate_cosine_lsh_bucketer,
    generate_euclidean_lsh_bucketer,
    lsh,
)
from pathway_tpu_torch.stdlib.ml.index import KNNIndex
from pathway_tpu_torch.stdlib.utils.col import groupby_reduce_majority

DistanceTypes = Literal["euclidean", "cosine"]


class DataPoint(Schema):
    data: np.ndarray


class MetaDataSchema(Schema):
    metadata: dict


def _euclidean_distance(data_table: np.ndarray, query_point: np.ndarray) -> np.ndarray:
    return np.sum((data_table - query_point) ** 2, axis=1).astype(float)


def compute_cosine_dist(data_table: np.ndarray, query_point: np.ndarray) -> np.ndarray:
    return 1 - np.dot(data_table, query_point) / (
        np.linalg.norm(data_table, axis=1) * np.linalg.norm(query_point)
    )


def _metadata_matches(flt, metadata) -> bool:
    if flt is None:
        return True
    from pathway_tpu_torch.engine.operators.external_index import _eval_jmespath_subset

    try:
        doc = metadata.value if hasattr(metadata, "value") else metadata
        return bool(_eval_jmespath_subset(flt, doc))
    except Exception:
        return False


def knn_lsh_generic_classifier_train(data, lsh_projection, distance_function, L: int):
    """Index ``data.data`` under ``lsh_projection``; return a query callable.

    ``L`` is accepted for reference-API parity only: the bucketer already
    encodes its band count in the vectors it emits.

    Both data and queries flatten their ``L``-band bucket vectors into
    ``(band_index, bucket_id)`` rows; a single equi-join pairs queries with
    data rows sharing any band bucket, and a groupby per query collects the
    candidate set for the host-side distance + top-k step.
    """
    has_metadata = "metadata" in data.column_names()

    def bucket_rows(table):
        tagged = table.select(
            buckets=expr_mod.apply(
                lambda x: [(i, int(b)) for i, b in enumerate(lsh_projection(x))],
                table.data,
            )
        )
        flat = tagged.flatten(tagged.buckets, origin_id="origin_id")
        return flat.select(
            flat.origin_id,
            band=expr_mod.GetExpression(flat.buckets, 0, check_if_exists=False),
            bucket=expr_mod.GetExpression(flat.buckets, 1, check_if_exists=False),
        )

    data_buckets = bucket_rows(data)

    def lsh_perform_query(queries, k=None, with_distances: bool = False):
        if k is not None:
            queries += queries.select(k=k)
        has_filter = "metadata_filter" in queries.column_names()

        query_buckets = bucket_rows(queries)
        matched = query_buckets.join(
            data_buckets,
            query_buckets.band == data_buckets.band,
            query_buckets.bucket == data_buckets.bucket,
        ).select(
            query_id=query_buckets.origin_id,
            data_id=data_buckets.origin_id,
        )
        grouped = matched.groupby(matched.query_id).reduce(
            matched.query_id,
            ids=reducers.sorted_tuple(matched.data_id),
        )
        candidates = grouped.select(
            grouped.query_id,
            ids=expr_mod.apply_with_type(
                lambda t: builtins.tuple(dict.fromkeys(t)), dt.ANY, grouped.ids
            ),
        )

        def knns(querypoint, ids_tuple, k, metadata_filter, vectors, metadatas):
            # ids are already deduplicated upstream (dict.fromkeys per query)
            cand_ids, cand_vecs = [], []
            for cid, vec, md in zip(ids_tuple, vectors, metadatas):
                if _metadata_matches(metadata_filter, md):
                    cand_ids.append(cid)
                    cand_vecs.append(vec)
            if not cand_ids:
                return []
            dists = distance_function(np.array(cand_vecs), np.asarray(querypoint))
            neighs = min(int(k), len(cand_ids))
            order = np.argsort(dists, kind="stable")[:neighs]
            return [(cand_ids[i], float(dists[i])) for i in order]

        flat_cand = candidates.flatten(candidates.ids)
        flat_cand += flat_cand.select(
            vec=data.ix(flat_cand.ids).data,
            md=(data.ix(flat_cand.ids).metadata if has_metadata else None),
        )
        gathered = flat_cand.groupby(flat_cand.query_id).reduce(
            flat_cand.query_id,
            ids=reducers.tuple(flat_cand.ids),
            vectors=reducers.tuple(flat_cand.vec),
            metadatas=reducers.tuple(flat_cand.md),
        )

        joined = queries.join_left(gathered, queries.id == gathered.query_id).select(
            query_id=queries.id,
            data=queries.data,
            k=queries.k,
            metadata_filter=(queries.metadata_filter if has_filter else None),
            ids=expr_mod.coalesce(gathered.ids, ()),
            vectors=expr_mod.coalesce(gathered.vectors, ()),
            metadatas=expr_mod.coalesce(gathered.metadatas, ()),
        )
        knn_result = joined.select(
            joined.query_id,
            knns_ids_with_dists=expr_mod.apply_with_type(
                lambda qp, ids_t, kk, mf, vecs, mds: (
                    knns(qp, ids_t, kk, mf, vecs, mds) if ids_t else []
                ),
                dt.ANY,
                joined.data,
                joined.ids,
                joined.k,
                joined.metadata_filter,
                joined.vectors,
                joined.metadatas,
            ),
        )
        if not with_distances:
            knn_result = knn_result.select(
                knn_result.query_id,
                knns_ids=expr_mod.apply_with_type(
                    lambda pairs: tuple(p[0] for p in pairs),
                    dt.ANY,
                    knn_result.knns_ids_with_dists,
                ),
            )
        return knn_result

    return lsh_perform_query


def knn_lsh_classifier_train(
    data, L: int, type: DistanceTypes = "euclidean", **kwargs  # noqa: A002
):
    """Build an LSH index over ``data``; dispatches on distance type.
    Reference ``_knn_lsh.py:63``."""
    if type == "euclidean":
        projection = generate_euclidean_lsh_bucketer(
            kwargs["d"], kwargs["M"], L, kwargs["A"]
        )
        return knn_lsh_generic_classifier_train(
            data, projection, _euclidean_distance, L
        )
    elif type == "cosine":
        projection = generate_cosine_lsh_bucketer(kwargs["d"], kwargs["M"], L)
        return knn_lsh_generic_classifier_train(data, projection, compute_cosine_dist, L)
    raise ValueError(
        f"Not supported `type` {type} in knn_lsh_classifier_train. "
        "The allowed values are 'euclidean' and 'cosine'."
    )


def knn_lsh_euclidean_classifier_train(data, d, M, L, A):
    """Euclidean-distance LSH index (reference ``_knn_lsh.py:293``)."""
    projection = generate_euclidean_lsh_bucketer(d, M, L, A)
    return knn_lsh_generic_classifier_train(data, projection, _euclidean_distance, L)


def knn_lsh_classify(knn_model, data_labels, queries, k):
    """Label queries by majority vote over the ``k`` nearest data points
    (reference ``_knn_lsh.py:306``)."""
    knns = knn_model(queries, k)
    votes = knns.flatten(knns.knns_ids)
    votes += votes.select(label=data_labels.ix(votes.knns_ids).label)
    nonempty = votes.groupby(votes.query_id).reduce(
        votes.query_id,
        predicted_label=expr_mod.apply_with_type(
            lambda ls: Counter(ls).most_common(1)[0][0],
            dt.ANY,
            reducers.tuple(votes.label),
        ),
    )
    rekeyed = nonempty.with_id(nonempty.query_id)
    nonempty = rekeyed.select(rekeyed.predicted_label)
    empty = queries.select(predicted_label=None)
    return empty.update_cells(nonempty.promise_universe_is_subset_of(empty))


# Back-compat aliases kept from the first cut of this module.
knn_lsh_train = knn_lsh_classifier_train


class Label:
    """API-parity marker (reference ``_clustering_via_lsh.py:Label``) — the
    label column contract of ``clustering_via_lsh`` output; not a Schema."""

    label: int


def np_divide(data: np.ndarray, other: float) -> np.ndarray:
    return data / other


def _kmeans_labels(vectors, weights, k: int, device) -> list[int]:
    """Labels of the representatives ``vectors`` (weights ``weights``):
    the ``k`` heaviest start the centroids (numpy on the host, JAX's
    order at ties), then k-means and the nearest centroid on ``device``
    as f32 torch ops, TF32 off."""
    import torch

    from pathway_tpu_torch.ops.ivf import kmeans_fit

    host = np.array(vectors, dtype=np.float32)
    w = np.asarray(weights, dtype=np.float32)
    init = host[np.argsort(-w)[:k]]
    if init.shape[0] < k:
        reps = -(-k // max(init.shape[0], 1))
        init = np.tile(init, (reps, 1))[:k]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        arr = torch.from_numpy(host).to(device)
        centroids = kmeans_fit(arr, torch.from_numpy(init).to(device))
        d2 = ((arr * arr).sum(dim=1, keepdim=True)
              + (centroids * centroids).sum(dim=1)[None, :]
              - 2.0 * arr @ centroids.T)
        return [int(x) for x in torch.argmin(d2, dim=1).cpu().numpy()]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def clustering_via_lsh(data, bucketer, k: int, *, device=None):
    """(Pre)clustering via LSH (reference ``_clustering_via_lsh.py:31``):
    bucket representatives (weighted means) are k-means-clustered on the
    card (``ops/ivf.kmeans_fit``; ``device=None`` is CUDA, as every port
    entry point), then every row takes the majority label over the buckets
    it fell into."""
    from pathway_tpu_torch.device import resolve_device
    from pathway_tpu_torch.stdlib.utils.col import apply_all_rows

    dev = resolve_device(device)

    flat_data = lsh(data, bucketer, origin_id="data_id", include_data=True)

    reduced = flat_data.groupby(flat_data.bucketing, flat_data.band).reduce(
        flat_data.bucketing,
        flat_data.band,
        sum=reducers.npsum(flat_data.data),
        count=reducers.count(),
    )
    representatives = reduced.select(
        reduced.bucketing,
        reduced.band,
        data=expr_mod.apply(np_divide, reduced.sum, reduced.count),
        weight=reduced.count,
    )

    def clustering(vectors, weights):
        return _kmeans_labels(vectors, weights, k, dev)

    labels = apply_all_rows(
        representatives.data,
        representatives.weight,
        fun=clustering,
        result_col_name="label",
    )
    representatives += labels
    votes = flat_data.join(
        representatives,
        flat_data.bucketing == representatives.bucketing,
        flat_data.band == representatives.band,
    ).select(
        flat_data.data_id,
        representatives.label,
    )

    result = groupby_reduce_majority(votes.data_id, votes.label)
    return result.select(label=result.majority).with_id(result.data_id)


def knn_classifier(data, labels, queries, k: int = 3, *, n_dimensions: int = 0,
                   distance_type: str = "euclidean", device=None):
    """Exact classification on the card: brute-force KNN (``KNNIndex``,
    ``device=None`` is CUDA) + majority vote (the fast path this framework
    prefers over LSH approximation).
    ``labels`` must share ``data``'s universe; its label column is joined
    onto the index rows so each neighborhood carries its labels."""
    label_name = (
        labels.column_names()[0] if hasattr(labels, "column_names") else "label"
    )
    combined = data + labels.select(**{label_name: labels[label_name]})
    index = KNNIndex(combined.data, combined, n_dimensions=n_dimensions,
                     distance_type=distance_type, device=device)
    neighbors = index.get_nearest_items(queries.data, k=k)

    def majority(ls):
        if not ls:
            return None
        return Counter(ls).most_common(1)[0][0]

    return neighbors.select(
        predicted_label=expr_mod.apply_with_type(majority, dt.ANY, neighbors[label_name])
    )
