"""Fuzzy joins (counterpart of ``pathway_tpu/stdlib/ml/smart_table_ops.py``,
reference ``stdlib/ml/smart_table_ops/_fuzzy_join.py``):
match rows of two tables by weighted feature overlap, normalized by
feature frequency, resolved to a near-1-1 matching by per-side argmax.

Pipeline: column(s) → feature bags (tokens/letters) → (node, feature,
weight) edge tables → frequency-normalized pair scores → mutual-argmax
matching.  Rare features pair directly through a feature equi-join; heavy
features (≥ HEAVY_LIGHT_THRESHOLD occurrences) only re-score pairs the
light features already produced, avoiding the quadratic blowup.
"""

from __future__ import annotations

import math
from enum import IntEnum, auto
from typing import Any, Callable

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals.api import Pointer
from pathway_tpu_torch.internals.schema import Schema


class Node(Schema):
    pass


class Feature(Schema):
    weight: float
    normalization_type: int


class Edge(Schema):
    node: Pointer
    feature: Pointer
    weight: float


class JoinResult(Schema):
    left: Pointer
    right: Pointer
    weight: float


def _tokenize(obj: Any) -> Any:
    return str(obj).split()


def _letters(obj: Any) -> Any:
    return [c.lower() for c in str(obj) if c.isalnum()]


class FuzzyJoinFeatureGeneration(IntEnum):
    AUTO = auto()
    TOKENIZE = auto()
    LETTERS = auto()

    @property
    def generate(self) -> Callable[[Any], Any]:
        if self == FuzzyJoinFeatureGeneration.LETTERS:
            return _letters
        return _tokenize


def _discrete_weight(cnt: float) -> float:
    return 0.0 if cnt == 0 else 1 / (2 ** math.ceil(math.log2(cnt)))


def _discrete_logweight(cnt: float) -> float:
    return 0.0 if cnt == 0 else 1 / math.ceil(math.log2(cnt + 1))


class FuzzyJoinNormalization(IntEnum):
    WEIGHT = auto()
    LOGWEIGHT = auto()
    NONE = auto()

    @property
    def normalize(self) -> Callable[[float], float]:
        if self == FuzzyJoinNormalization.WEIGHT:
            return _discrete_weight
        if self == FuzzyJoinNormalization.LOGWEIGHT:
            return _discrete_logweight
        return lambda cnt: cnt


def _concatenate_columns(table):
    return table.select(
        desc=expr_mod.apply(
            lambda *args: " ".join(str(a) for a in args),
            *[table[name] for name in table.column_names()],
        )
    )


def _edges_and_features(tab, col, feature_generation, normalization):
    """Build the (node, feature, weight) edge table and the feature table
    for one side."""
    bags = tab.select(
        feature=expr_mod.apply(feature_generation.generate, col)
    )
    bags = bags.flatten(bags.feature, origin_id="origin_id")
    features = bags.groupby(bags.feature).reduce(
        normalization_type=int(normalization),
        weight=1.0,
    )
    edges = bags.select(
        node=bags.origin_id,
        feature=features.pointer_from(bags.feature),
        weight=1.0,
    )
    return edges, features


def smart_fuzzy_match(
    left_col,
    right_col,
    *,
    by_hand_match=None,
    normalization=FuzzyJoinNormalization.LOGWEIGHT,
    feature_generation=FuzzyJoinFeatureGeneration.AUTO,
    HEAVY_LIGHT_THRESHOLD: int = 100,
):
    """Fuzzy-match two string columns; returns a JoinResult table
    (reference ``_fuzzy_join.py:199``)."""
    left, right = left_col.table, right_col.table
    self_match = left is right and left_col.name == right_col.name

    edges_left, features_left = _edges_and_features(
        left, left_col, feature_generation, normalization
    )
    if self_match:
        return fuzzy_self_match(
            edges_left, features_left, by_hand_match, HEAVY_LIGHT_THRESHOLD
        )
    edges_right, features_right = _edges_and_features(
        right, right_col, feature_generation, normalization
    )
    features = features_left.update_rows(features_right)
    return fuzzy_match(
        edges_left, edges_right, features, by_hand_match, HEAVY_LIGHT_THRESHOLD
    )


def fuzzy_self_match(
    edges, features, by_hand_match=None, HEAVY_LIGHT_THRESHOLD: int = 100
):
    """Match a table against itself (reference ``_fuzzy_join.py:249``)."""
    return _fuzzy_match(
        edges,
        edges,
        features,
        symmetric=True,
        HEAVY_LIGHT_THRESHOLD=HEAVY_LIGHT_THRESHOLD,
        by_hand_match=by_hand_match,
    )


def fuzzy_match(
    edges_left, edges_right, features, by_hand_match=None,
    HEAVY_LIGHT_THRESHOLD: int = 100,
):
    """Match two edge tables over shared features (reference
    ``_fuzzy_join.py:265``)."""
    return _fuzzy_match(
        edges_left,
        edges_right,
        features,
        symmetric=False,
        HEAVY_LIGHT_THRESHOLD=HEAVY_LIGHT_THRESHOLD,
        by_hand_match=by_hand_match,
    )


def fuzzy_match_with_hint(
    edges_left, edges_right, features, by_hand_match,
    HEAVY_LIGHT_THRESHOLD: int = 100,
):
    """Like ``fuzzy_match`` but with hand-matched pairs pinned
    (reference ``_fuzzy_join.py:282``)."""
    return _fuzzy_match(
        edges_left,
        edges_right,
        features,
        symmetric=False,
        HEAVY_LIGHT_THRESHOLD=HEAVY_LIGHT_THRESHOLD,
        by_hand_match=by_hand_match,
    )


def fuzzy_match_tables(
    left_table,
    right_table,
    *,
    by_hand_match=None,
    normalization=FuzzyJoinNormalization.LOGWEIGHT,
    feature_generation=FuzzyJoinFeatureGeneration.AUTO,
    left_projection: dict | None = None,
    right_projection: dict | None = None,
):
    """Fuzzy-match whole tables; columns optionally projected into named
    buckets matched bucket-against-bucket (reference ``_fuzzy_join.py:106``)."""
    left_projection = left_projection or {}
    right_projection = right_projection or {}
    if not left_projection or not right_projection:
        left = _concatenate_columns(left_table)
        right = _concatenate_columns(right_table)
        return smart_fuzzy_match(
            left.desc,
            right.desc,
            by_hand_match=by_hand_match,
            normalization=normalization,
            feature_generation=feature_generation,
        )

    buckets_left: dict[str, list] = {}
    buckets_right: dict[str, list] = {}
    order: list[str] = []
    for col, b in left_projection.items():
        if b not in order:
            order.append(b)
        buckets_left.setdefault(b, []).append(col)
    for col, b in right_projection.items():
        if b not in order:
            order.append(b)
        buckets_right.setdefault(b, []).append(col)

    partial = []
    for b in order:
        lt = left_table.select(**{c: left_table[c] for c in buckets_left.get(b, [])})
        rt = right_table.select(
            **{c: right_table[c] for c in buckets_right.get(b, [])}
        )
        partial.append(
            fuzzy_match_tables(
                lt,
                rt,
                by_hand_match=by_hand_match,
                normalization=normalization,
                feature_generation=feature_generation,
            )
        )
    matchings = partial[0].concat_reindex(*partial[1:])
    merged = matchings.groupby(matchings.left, matchings.right).reduce(
        matchings.left,
        matchings.right,
        weight=reducers.sum(matchings.weight),
    )
    if by_hand_match is not None:
        # every bucket appended the hand pairs, so the sum above multiplied
        # their weight by the bucket count; pin the original weights back
        merged = merged.with_id_from(merged.left, merged.right).update_rows(
            by_hand_match.with_id_from(by_hand_match.left, by_hand_match.right)
        )
    return merged


def _filter_out_matched_by_hand(edges_left, edges_right, symmetric, by_hand_match):
    matched_left = by_hand_match.select(node=by_hand_match.left)
    matched_right = by_hand_match.select(node=by_hand_match.right)
    if symmetric:
        matched_left = matched_left.concat_reindex(matched_right)
        matched_right = matched_left
    taken_l = matched_left.groupby(matched_left.node).reduce(matched_left.node)
    taken_r = matched_right.groupby(matched_right.node).reduce(matched_right.node)

    def keep(edges, taken):
        j = edges.join_left(taken, edges.node == taken.node, id=edges.id).select(
            hit=taken.node
        )
        return edges.filter(
            expr_mod.apply_with_type(lambda h: h is None, bool, j.restrict(edges).hit)
        )

    out_l = keep(edges_left, taken_l)
    out_r = out_l if symmetric else keep(edges_right, taken_r)
    return out_l, out_r


def _fuzzy_match(
    edges_left,
    edges_right,
    features,
    *,
    symmetric: bool,
    HEAVY_LIGHT_THRESHOLD: int,
    by_hand_match=None,
):
    if by_hand_match is not None:
        edges_left, edges_right = _filter_out_matched_by_hand(
            edges_left, edges_right, symmetric, by_hand_match
        )

    if symmetric:
        all_edges = edges_left
    else:
        all_edges = edges_left.concat_reindex(edges_right)
    features_cnt = features.select(cnt=0).update_rows(
        all_edges.groupby(id=all_edges.feature).reduce(cnt=reducers.count())
    )

    def split(edges):
        heavy = edges.filter(
            features_cnt.ix(edges.feature).cnt >= HEAVY_LIGHT_THRESHOLD
        )
        light = edges.filter(
            features_cnt.ix(edges.feature).cnt < HEAVY_LIGHT_THRESHOLD
        )
        return heavy, light

    left_heavy, left_light = split(edges_left)
    if symmetric:
        right_heavy, right_light = left_heavy, left_light
    else:
        right_heavy, right_light = split(edges_right)

    features_normalized = features.select(
        weight=features.weight
        * expr_mod.apply_with_type(
            lambda cnt, ntype: FuzzyJoinNormalization(ntype).normalize(cnt),
            float,
            features_cnt.restrict(features).cnt,
            features.normalization_type,
        )
    )

    # rare features generate candidate pairs directly; side markers
    # (thisclass.left/right) keep the sides distinct in the symmetric
    # self-join case where both operands are the same table object
    from pathway_tpu_torch.internals import thisclass

    light_pairs = left_light.join(
        right_light,
        thisclass.left.feature == thisclass.right.feature,
    ).select(
        left=thisclass.left.node,
        right=thisclass.right.node,
        weight=thisclass.left.weight
        * thisclass.right.weight
        * features_normalized.ix(thisclass.left.feature).weight,
    )
    if symmetric:
        light_pairs = light_pairs.filter(light_pairs.left != light_pairs.right)
    light_pairs = light_pairs.groupby(light_pairs.left, light_pairs.right).reduce(
        light_pairs.left,
        light_pairs.right,
        weight=reducers.sum(light_pairs.weight),
    )

    # heavy features only add weight to pairs the light ones already found
    lh = light_pairs.join(left_heavy, light_pairs.left == left_heavy.node).select(
        left=light_pairs.left,
        right=light_pairs.right,
        feature=left_heavy.feature,
        lw=left_heavy.weight,
    )
    heavy_pairs = lh.join(
        right_heavy,
        lh.right == right_heavy.node,
        lh.feature == right_heavy.feature,
    ).select(
        left=lh.left,
        right=lh.right,
        weight=lh.lw
        * right_heavy.weight
        * features_normalized.ix(lh.feature).weight,
    )

    node_node = light_pairs.concat_reindex(heavy_pairs)
    node_node = node_node.groupby(node_node.left, node_node.right).reduce(
        node_node.left,
        node_node.right,
        weight=reducers.sum(node_node.weight),
    )
    # pseudo-weight makes (w, a, b) and (w, b, a) compare identically, so the
    # two argmax passes agree on symmetric inputs
    node_node = node_node.with_columns(
        weight=expr_mod.if_else(
            node_node.left < node_node.right,
            expr_mod.make_tuple(node_node.weight, node_node.left, node_node.right),
            expr_mod.make_tuple(node_node.weight, node_node.right, node_node.left),
        )
    )

    by_left = node_node.groupby(node_node.left).reduce(
        node_node.left,
        ptr=reducers.argmax(node_node.weight),
        weight=reducers.max(node_node.weight),
    )
    by_left = by_left.select(
        by_left.left, by_left.weight, right=node_node.ix(by_left.ptr).right
    )
    by_right = by_left.groupby(by_left.right).reduce(
        by_left.right,
        ptr=reducers.argmax(by_left.weight),
        weight=reducers.max(by_left.weight),
    )
    matched = by_right.select(
        by_right.right,
        by_right.weight,
        left=by_left.ix(by_right.ptr).left,
    )

    if symmetric:
        matched = matched.filter(matched.left < matched.right)

    result = matched.select(
        matched.left,
        matched.right,
        weight=expr_mod.GetExpression(matched.weight, 0, check_if_exists=False),
    )
    if by_hand_match is not None:
        result = result.concat_reindex(by_hand_match)
    return result


def smart_fuzzy_join(left, right, left_column=None, right_column=None, **kwargs):
    """Back-compat convenience wrapper: fuzzy-match a column of each table
    (defaults to the first column); returns (left, right, weight) rows."""
    lcol = left_column if left_column is not None else left[left.column_names()[0]]
    rcol = right_column if right_column is not None else right[right.column_names()[0]]
    return smart_fuzzy_match(lcol, rcol, **kwargs)
