"""Temporal type plumbing (reference ``stdlib/temporal/utils.py``)."""

from __future__ import annotations

import datetime
from typing import Any, Union

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.type_interpreter import infer_dtype

TimeEventType = Union[int, float, datetime.datetime]
IntervalType = Union[int, float, datetime.timedelta]


def get_default_origin(time_event_type: dt.DType) -> TimeEventType:
    """Default window origin per time dtype; 1973 starts on a Monday so
    week-wide windows align to Mondays (reference ``utils.py:16``). pandas
    is imported only for the datetime dtypes."""
    if time_event_type == dt.INT:
        return 0
    if time_event_type == dt.FLOAT:
        return 0.0
    tz = {dt.DATE_TIME_NAIVE: None, dt.DATE_TIME_UTC: "UTC"}[time_event_type]
    import pandas as pd

    return pd.Timestamp(year=1973, month=1, day=1, tz=tz)


def zero_length_interval(interval_type: type[IntervalType]) -> IntervalType:
    if issubclass(interval_type, datetime.timedelta):
        return datetime.timedelta(0)
    if issubclass(interval_type, bool):
        raise TypeError("unsupported interval type")
    if issubclass(interval_type, int):
        return 0
    if issubclass(interval_type, float):
        return 0.0
    raise TypeError("unsupported interval type")


_TIME_EVENT_DTYPES = (dt.INT, dt.FLOAT, dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC)
_INTERVAL_DTYPES = (dt.INT, dt.FLOAT, dt.DURATION, dt.DURATION)


def check_joint_types(parameters: dict[str, tuple[Any, Any]]) -> None:
    """Verify that time/interval arguments use a consistent family:
    (int, int), (float, float) or (datetime, timedelta)
    (reference ``utils.py:46``)."""
    parameters = {
        name: (variable, expected)
        for name, (variable, expected) in parameters.items()
        if variable is not None
    }
    if not parameters:
        return

    def possible(expected) -> tuple[dt.DType, ...]:
        if expected is TimeEventType:
            return _TIME_EVENT_DTYPES
        if expected is IntervalType:
            return _INTERVAL_DTYPES
        raise ValueError("Type has to be either TimeEventType or IntervalType.")

    def dtype_of(variable) -> dt.DType:
        from pathway_tpu_torch.internals.expression import ColumnExpression

        if isinstance(variable, ColumnExpression):
            table = None
            tables = variable._tables()
            if tables:
                table = tables[0]
            try:
                return infer_dtype(variable, table)
            except Exception:
                return dt.ANY
        return dt.wrap(type(variable))

    types = {name: dtype_of(v) for name, (v, _e) in parameters.items()}
    for i in range(len(_TIME_EVENT_DTYPES)):
        candidate = {
            name: possible(expected)[i]
            for name, (_v, expected) in parameters.items()
        }
        if all(
            types[name] == candidate[name] or types[name] == dt.ANY
            for name in parameters
        ):
            return
    expected_str = " or ".join(
        repr(
            tuple(
                possible(expected)[i] for _n, (_v, expected) in parameters.items()
            )
        )
        for i in range(len(_TIME_EVENT_DTYPES))
    )
    raise TypeError(
        f"Arguments ({', '.join(parameters)}) have to be of types "
        f"{expected_str} but are of types "
        f"{tuple(types[n] for n in parameters)!r}."
    )
