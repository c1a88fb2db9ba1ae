"""Datetime value types.

The reference engine implements DateTimeNaive/DateTimeUtc/Duration natively over
chrono (reference ``src/engine/time.rs``). Here they are thin pandas Timestamp /
Timedelta subclasses: pandas gives nanosecond resolution and tz-handling, while
the engine stores them in dense ``int64`` nanosecond columns so temporal
arithmetic vectorizes.
"""

from __future__ import annotations

import pandas as pd


class DateTimeNaive(pd.Timestamp):
    """Timezone-unaware datetime."""

    def __new__(cls, *args, **kwargs):
        obj = pd.Timestamp.__new__(cls, *args, **kwargs)
        if obj.tzinfo is not None:
            raise ValueError("DateTimeNaive cannot have a timezone")
        return obj


class DateTimeUtc(pd.Timestamp):
    """Timezone-aware datetime (canonicalized to UTC)."""

    def __new__(cls, *args, **kwargs):
        obj = pd.Timestamp.__new__(cls, *args, **kwargs)
        if obj.tzinfo is None:
            raise ValueError("DateTimeUtc must have a timezone")
        return obj


class Duration(pd.Timedelta):
    """Time span."""

    def __new__(cls, *args, **kwargs):
        return pd.Timedelta.__new__(cls, *args, **kwargs)
