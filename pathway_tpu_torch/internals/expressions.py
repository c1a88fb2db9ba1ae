"""``expr.dt`` / ``expr.str`` / ``expr.num`` method namespaces.

Parity with reference ``python/pathway/internals/expressions/{date_time,string,
numerical}.py``. Each method builds a :class:`MethodCallExpression` with a
namespaced method name; the engine's vectorized evaluator implements them over
whole columns (pandas string/datetime kernels — far faster than the
reference's per-row interpreter).
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    MethodCallExpression,
    smart_coerce,
)


class _Namespace:
    def __init__(self, expr: ColumnExpression):
        self._expr = expr

    def _call(self, method: str, *args, return_type=None, **kwargs):
        return MethodCallExpression(
            method, self._expr, *args, return_type=return_type, **kwargs
        )


class StringNamespace(_Namespace):
    def lower(self):
        return self._call("str.lower", return_type=dt.STR)

    def upper(self):
        return self._call("str.upper", return_type=dt.STR)

    def reversed(self):
        return self._call("str.reversed", return_type=dt.STR)

    def len(self):
        return self._call("str.len", return_type=dt.INT)

    def strip(self, chars=None):
        return self._call("str.strip", smart_coerce(chars), return_type=dt.STR)

    def lstrip(self, chars=None):
        return self._call("str.lstrip", smart_coerce(chars), return_type=dt.STR)

    def rstrip(self, chars=None):
        return self._call("str.rstrip", smart_coerce(chars), return_type=dt.STR)

    def startswith(self, prefix):
        return self._call("str.startswith", smart_coerce(prefix), return_type=dt.BOOL)

    def endswith(self, suffix):
        return self._call("str.endswith", smart_coerce(suffix), return_type=dt.BOOL)

    def swapcase(self):
        return self._call("str.swapcase", return_type=dt.STR)

    swap_case = swapcase  # pre-r3 spelling kept for compatibility

    def title(self):
        return self._call("str.title", return_type=dt.STR)

    def capitalize(self):
        return self._call("str.capitalize", return_type=dt.STR)

    def casefold(self):
        return self._call("str.casefold", return_type=dt.STR)

    def count(self, sub, start=None, end=None):
        return self._call(
            "str.count",
            smart_coerce(sub),
            smart_coerce(start),
            smart_coerce(end),
            return_type=dt.INT,
        )

    def find(self, sub, start=None, end=None):
        return self._call(
            "str.find",
            smart_coerce(sub),
            smart_coerce(start),
            smart_coerce(end),
            return_type=dt.INT,
        )

    def rfind(self, sub, start=None, end=None):
        return self._call(
            "str.rfind",
            smart_coerce(sub),
            smart_coerce(start),
            smart_coerce(end),
            return_type=dt.INT,
        )

    def removeprefix(self, prefix):
        return self._call("str.removeprefix", smart_coerce(prefix), return_type=dt.STR)

    def removesuffix(self, suffix):
        return self._call("str.removesuffix", smart_coerce(suffix), return_type=dt.STR)

    def replace(self, old, new, count=-1):
        return self._call(
            "str.replace",
            smart_coerce(old),
            smart_coerce(new),
            smart_coerce(count),
            return_type=dt.STR,
        )

    def split(self, sep=None, maxsplit=-1):
        return self._call(
            "str.split",
            smart_coerce(sep),
            smart_coerce(maxsplit),
            return_type=dt.List(dt.STR),
        )

    def slice(self, start, end):
        return self._call(
            "str.slice", smart_coerce(start), smart_coerce(end), return_type=dt.STR
        )

    def parse_int(self, optional: bool = False):
        rt = dt.Optional(dt.INT) if optional else dt.INT
        return self._call("str.parse_int", optional=optional, return_type=rt)

    def parse_float(self, optional: bool = False):
        rt = dt.Optional(dt.FLOAT) if optional else dt.FLOAT
        return self._call("str.parse_float", optional=optional, return_type=rt)

    def parse_bool(
        self,
        true_values=("on", "true", "yes", "1"),
        false_values=("off", "false", "no", "0"),
        optional: bool = False,
    ):
        rt = dt.Optional(dt.BOOL) if optional else dt.BOOL
        return self._call(
            "str.parse_bool",
            true_values=tuple(true_values),
            false_values=tuple(false_values),
            optional=optional,
            return_type=rt,
        )

    def to_bytes(self, encoding: str = "utf-8"):
        return self._call("str.to_bytes", encoding=encoding, return_type=dt.BYTES)

    def contains(self, sub):
        return self._call("str.contains", smart_coerce(sub), return_type=dt.BOOL)


class DateTimeNamespace(_Namespace):
    def nanosecond(self):
        return self._call("dt.nanosecond", return_type=dt.INT)

    def microsecond(self):
        return self._call("dt.microsecond", return_type=dt.INT)

    def millisecond(self):
        return self._call("dt.millisecond", return_type=dt.INT)

    def second(self):
        return self._call("dt.second", return_type=dt.INT)

    def minute(self):
        return self._call("dt.minute", return_type=dt.INT)

    def hour(self):
        return self._call("dt.hour", return_type=dt.INT)

    def day(self):
        return self._call("dt.day", return_type=dt.INT)

    def month(self):
        return self._call("dt.month", return_type=dt.INT)

    def year(self):
        return self._call("dt.year", return_type=dt.INT)

    def weekday(self):
        """Monday=0 .. Sunday=6 (reference ``dt.weekday``)."""
        return self.day_of_week()

    def day_of_week(self):
        return self._call("dt.day_of_week", return_type=dt.INT)

    def day_of_year(self):
        return self._call("dt.day_of_year", return_type=dt.INT)

    def timestamp(self, unit: str | None = None):
        return self._call("dt.timestamp", unit=unit, return_type=dt.FLOAT if unit else dt.INT)

    def strftime(self, fmt):
        return self._call("dt.strftime", smart_coerce(fmt), return_type=dt.STR)

    def strptime(self, fmt, contains_timezone: bool | None = None):
        rt = dt.DATE_TIME_UTC if contains_timezone else dt.DATE_TIME_NAIVE
        return self._call(
            "dt.strptime", smart_coerce(fmt), contains_timezone=contains_timezone, return_type=rt
        )

    def to_utc(self, from_timezone: str):
        return self._call("dt.to_utc", from_timezone=from_timezone, return_type=dt.DATE_TIME_UTC)

    def to_naive_in_timezone(self, timezone: str):
        return self._call(
            "dt.to_naive_in_timezone", timezone=timezone, return_type=dt.DATE_TIME_NAIVE
        )

    def add_duration_in_timezone(self, duration, timezone: str):
        return self._call(
            "dt.add_duration_in_timezone", smart_coerce(duration), timezone=timezone
        )

    def subtract_duration_in_timezone(self, duration, timezone: str):
        return self._call(
            "dt.subtract_duration_in_timezone", smart_coerce(duration), timezone=timezone
        )

    def subtract_date_time_in_timezone(self, other, timezone: str):
        return self._call(
            "dt.subtract_date_time_in_timezone",
            smart_coerce(other),
            timezone=timezone,
            return_type=dt.DURATION,
        )

    def round(self, duration):
        return self._call("dt.round", smart_coerce(duration))

    def floor(self, duration):
        return self._call("dt.floor", smart_coerce(duration))

    def from_timestamp(self, unit: str):
        return self._call("dt.from_timestamp", unit=unit, return_type=dt.DATE_TIME_NAIVE)

    def utc_from_timestamp(self, unit: str):
        return self._call("dt.utc_from_timestamp", unit=unit, return_type=dt.DATE_TIME_UTC)

    def to_duration(self, unit: str):
        return self._call("dt.to_duration", unit=unit, return_type=dt.DURATION)

    # Duration accessors
    def nanoseconds(self):
        return self._call("dt.nanoseconds", return_type=dt.INT)

    def microseconds(self):
        return self._call("dt.microseconds", return_type=dt.INT)

    def milliseconds(self):
        return self._call("dt.milliseconds", return_type=dt.INT)

    def seconds(self):
        return self._call("dt.seconds", return_type=dt.INT)

    def minutes(self):
        return self._call("dt.minutes", return_type=dt.INT)

    def hours(self):
        return self._call("dt.hours", return_type=dt.INT)

    def days(self):
        return self._call("dt.days", return_type=dt.INT)

    def weeks(self):
        return self._call("dt.weeks", return_type=dt.INT)


class NumericalNamespace(_Namespace):
    def abs(self):
        return self._call("num.abs")

    def round(self, decimals=0):
        return self._call("num.round", smart_coerce(decimals))

    def fill_na(self, default_value):
        return self._call("num.fill_na", smart_coerce(default_value))
