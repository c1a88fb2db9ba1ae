"""``pw.reducers`` — aggregation function surface.

Parity with reference ``python/pathway/internals/reducers.py`` (count, sum,
min, max, argmin, argmax, unique, any, sorted_tuple, tuple, ndarray, npsum,
avg, earliest, latest) plus ``stateful_many``/``stateful_single`` and
``udf_reducer`` from ``custom_reducers.py``.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals.expression import ReducerExpression


class Reducer:
    def __init__(self, name: str, needs_id: bool = False, needs_order: bool = False):
        self.name = name
        self.needs_id = needs_id
        self.needs_order = needs_order

    def __repr__(self):
        return f"<reducer {self.name}>"


_COUNT = Reducer("count")
_SUM = Reducer("sum")
_MIN = Reducer("min")
_MAX = Reducer("max")
_ARGMIN = Reducer("argmin", needs_id=True)
_ARGMAX = Reducer("argmax", needs_id=True)
_UNIQUE = Reducer("unique")
_ANY = Reducer("any")
_SORTED_TUPLE = Reducer("sorted_tuple")
_TUPLE = Reducer("tuple", needs_order=True)
_NDARRAY = Reducer("ndarray", needs_order=True)
_AVG = Reducer("avg")
_EARLIEST = Reducer("earliest")
_LATEST = Reducer("latest")
_NPSUM = Reducer("npsum")


def count(*args) -> ReducerExpression:
    return ReducerExpression(_COUNT, *args)


def sum(expr) -> ReducerExpression:  # noqa: A001
    return ReducerExpression(_SUM, expr)


def npsum(expr) -> ReducerExpression:
    return ReducerExpression(_NPSUM, expr)


def int_sum(expr) -> ReducerExpression:
    """Deprecated alias of ``sum`` (reference ``reducers.int_sum``,
    internals/reducers.py:611)."""
    import warnings

    warnings.warn(
        "Reducer pathway.reducers.int_sum is deprecated, use "
        "pathway.reducers.sum instead.",
        stacklevel=2,
    )
    return sum(expr)


def min(expr) -> ReducerExpression:  # noqa: A001
    return ReducerExpression(_MIN, expr)


def max(expr) -> ReducerExpression:  # noqa: A001
    return ReducerExpression(_MAX, expr)


def argmin(expr) -> ReducerExpression:
    return ReducerExpression(_ARGMIN, expr)


def argmax(expr) -> ReducerExpression:
    return ReducerExpression(_ARGMAX, expr)


def unique(expr) -> ReducerExpression:
    return ReducerExpression(_UNIQUE, expr)


def any(expr) -> ReducerExpression:  # noqa: A001
    return ReducerExpression(_ANY, expr)


def sorted_tuple(expr, *, skip_nones: bool = False) -> ReducerExpression:
    return ReducerExpression(_SORTED_TUPLE, expr, skip_nones=skip_nones)


def tuple(expr, *, skip_nones: bool = False) -> ReducerExpression:  # noqa: A001
    return ReducerExpression(_TUPLE, expr, skip_nones=skip_nones)


def ndarray(expr, *, skip_nones: bool = False) -> ReducerExpression:
    return ReducerExpression(_NDARRAY, expr, skip_nones=skip_nones)


def avg(expr) -> ReducerExpression:
    return ReducerExpression(_AVG, expr)


def earliest(expr) -> ReducerExpression:
    return ReducerExpression(_EARLIEST, expr)


def latest(expr) -> ReducerExpression:
    return ReducerExpression(_LATEST, expr)


def stateful_many(combine_fn: Callable) -> Callable[..., ReducerExpression]:
    """Arbitrary Python state over many rows:
    ``combine_fn(state, rows: list[(args_tuple, diff)]) -> state``."""

    def reducer(*args) -> ReducerExpression:
        r = Reducer("stateful")
        expr = ReducerExpression(r, *args, combine_fn=combine_fn)
        return expr

    return reducer


def stateful_single(combine_fn: Callable) -> Callable[..., ReducerExpression]:
    def wrapper(state, rows):
        for args, diff in rows:
            for _ in range(diff):
                state = combine_fn(state, *args)
        return state

    return stateful_many(wrapper)


def udf_reducer(reducer_cls):
    """Build a reducer from a :class:`BaseCustomAccumulator` subclass."""

    def reducer(*args) -> ReducerExpression:
        def combine_fn(state, rows):
            acc = None
            for args_, diff in rows:
                if diff <= 0:
                    continue
                for _ in range(diff):
                    nxt = reducer_cls.from_row(list(args_))
                    if acc is None:
                        acc = nxt
                    else:
                        acc.update(nxt)
            return acc.compute_result() if acc is not None else None

        r = Reducer("stateful")
        return ReducerExpression(r, *args, combine_fn=combine_fn)

    return reducer
