"""Argmin/argmax row filtering helpers (counterpart of
``pathway_tpu/stdlib/utils/filtering.py``)."""

from __future__ import annotations

from pathway_tpu_torch.internals import reducers


def argmin_rows(table, *on, what):
    ids = table.groupby(*on).reduce(argmin_id=reducers.argmin(what))
    return _pick(table, ids)


def argmax_rows(table, *on, what):
    ids = table.groupby(*on).reduce(argmin_id=reducers.argmax(what))
    return _pick(table, ids)


def _pick(table, ids):
    reindexed = ids.with_id(ids.argmin_id)
    return table.restrict(reindexed)
