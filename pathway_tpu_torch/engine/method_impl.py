"""Implementations of ``expr.str`` / ``expr.dt`` / ``expr.num`` methods.

Dispatched by namespaced method name from the expression evaluator; pandas
supplies the datetime kernels (reference: ``src/engine/time.rs`` chrono ops),
imported where they run, so a program without datetimes never loads it.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.engine.value import ERROR
from pathway_tpu_torch.internals.errors import get_global_error_log


def _rowwise(fn: Callable, *arrays, n: int) -> np.ndarray:
    out = np.empty(n, dtype=object)
    for i in range(n):
        args = [a[i] for a in arrays]
        if any(a is ERROR for a in args):
            out[i] = ERROR
            continue
        try:
            out[i] = fn(*args)
        except Exception as exc:  # noqa: BLE001
            get_global_error_log().log(f"{type(exc).__name__}: {exc}")
            out[i] = ERROR
    return out


_UNIT_NS = {
    "ns": 1,
    "us": 10**3,
    "ms": 10**6,
    "s": 10**9,
}


def _dur_ns(d) -> int:
    import pandas as pd

    return pd.Timedelta(d).value


def _wrap_ts(ts: "pd.Timestamp"):
    from pathway_tpu_torch.internals.datetime_types import DateTimeNaive, DateTimeUtc

    if ts.tzinfo is not None:
        return DateTimeUtc(ts)
    return DateTimeNaive(ts)


def dispatch(method: str, args: list[np.ndarray], kwargs: dict, n: int) -> np.ndarray:
    ns, _, name = method.partition(".")
    if ns == "str":
        return _dispatch_str(name, args, kwargs, n)
    if ns == "dt":
        return _dispatch_dt(name, args, kwargs, n)
    if ns == "num":
        return _dispatch_num(name, args, kwargs, n)
    if method == "to_string":
        from pathway_tpu_torch.engine.expression_eval import _to_string

        return _rowwise(_to_string, args[0], n=n)
    raise ValueError(f"unknown method {method!r}")


def _dispatch_str(name: str, args, kwargs, n) -> np.ndarray:
    a = args[0]
    rest = args[1:]
    simple = {
        "lower": lambda s: s.lower(),
        "upper": lambda s: s.upper(),
        "reversed": lambda s: s[::-1],
        "len": len,
        "swapcase": lambda s: s.swapcase(),
        "title": lambda s: s.title(),
        "capitalize": lambda s: s.capitalize(),
        "casefold": lambda s: s.casefold(),
    }
    if name in simple:
        return _rowwise(simple[name], a, n=n)
    if name in ("strip", "lstrip", "rstrip"):
        return _rowwise(lambda s, c: getattr(s, name)(c), a, rest[0], n=n)
    if name == "startswith":
        return _rowwise(lambda s, p: s.startswith(p), a, rest[0], n=n)
    if name == "endswith":
        return _rowwise(lambda s, p: s.endswith(p), a, rest[0], n=n)
    if name == "count":
        return _rowwise(
            lambda s, sub, st, en: s.count(sub, st, en), a, *rest, n=n
        )
    if name == "find":
        return _rowwise(lambda s, sub, st, en: s.find(sub, st, en), a, *rest, n=n)
    if name == "rfind":
        return _rowwise(lambda s, sub, st, en: s.rfind(sub, st, en), a, *rest, n=n)
    if name == "removeprefix":
        return _rowwise(lambda s, p: s.removeprefix(p), a, rest[0], n=n)
    if name == "removesuffix":
        return _rowwise(lambda s, p: s.removesuffix(p), a, rest[0], n=n)
    if name == "replace":
        return _rowwise(
            lambda s, old, new, cnt: s.replace(old, new, cnt if cnt is not None else -1),
            a,
            *rest,
            n=n,
        )
    if name == "split":
        def _split(s, sep, maxsplit):
            parts = s.split(sep, maxsplit if maxsplit is not None else -1)
            return tuple(parts)

        return _rowwise(_split, a, *rest, n=n)
    if name == "slice":
        return _rowwise(lambda s, st, en: s[st:en], a, *rest, n=n)
    if name == "parse_int":
        optional = kwargs.get("optional", False)

        def _pi(s):
            try:
                return int(s.strip())
            except Exception:
                if optional:
                    return None
                raise

        return _rowwise(_pi, a, n=n)
    if name == "parse_float":
        optional = kwargs.get("optional", False)

        def _pf(s):
            try:
                return float(s.strip())
            except Exception:
                if optional:
                    return None
                raise

        return _rowwise(_pf, a, n=n)
    if name == "parse_bool":
        optional = kwargs.get("optional", False)
        true_values = tuple(v.lower() for v in kwargs.get("true_values", ()))
        false_values = tuple(v.lower() for v in kwargs.get("false_values", ()))

        def _pb(s):
            low = s.strip().lower()
            if low in true_values:
                return True
            if low in false_values:
                return False
            if optional:
                return None
            raise ValueError(f"cannot parse {s!r} as bool")

        return _rowwise(_pb, a, n=n)
    if name == "to_bytes":
        enc = kwargs.get("encoding", "utf-8")
        return _rowwise(lambda s: s.encode(enc), a, n=n)
    if name == "contains":
        return _rowwise(lambda s, sub: sub in s, a, rest[0], n=n)
    raise ValueError(f"unknown str method {name!r}")


def _dispatch_dt(name: str, args, kwargs, n) -> np.ndarray:
    import pandas as pd

    from pathway_tpu_torch.internals.datetime_types import (
        DateTimeNaive,
        DateTimeUtc,
        Duration,
    )

    a = args[0]
    rest = args[1:]
    ts_fields = {
        "nanosecond": lambda t: pd.Timestamp(t).nanosecond,
        "microsecond": lambda t: pd.Timestamp(t).microsecond,
        "millisecond": lambda t: pd.Timestamp(t).microsecond // 1000,
        "second": lambda t: pd.Timestamp(t).second,
        "minute": lambda t: pd.Timestamp(t).minute,
        "hour": lambda t: pd.Timestamp(t).hour,
        "day": lambda t: pd.Timestamp(t).day,
        "month": lambda t: pd.Timestamp(t).month,
        "year": lambda t: pd.Timestamp(t).year,
        "day_of_week": lambda t: pd.Timestamp(t).dayofweek,
        "day_of_year": lambda t: pd.Timestamp(t).dayofyear,
    }
    if name in ts_fields:
        return _rowwise(ts_fields[name], a, n=n)
    if name == "timestamp":
        unit = kwargs.get("unit")
        if unit is None:
            return _rowwise(lambda t: pd.Timestamp(t).value, a, n=n)
        div = _UNIT_NS[unit]
        return _rowwise(lambda t: pd.Timestamp(t).value / div, a, n=n)
    if name == "strftime":
        return _rowwise(lambda t, f: pd.Timestamp(t).strftime(_convert_fmt(f)), a, rest[0], n=n)
    if name == "strptime":
        contains_tz = kwargs.get("contains_timezone")

        def _strptime(s, f):
            ts = pd.to_datetime(s, format=_convert_fmt(f))
            if contains_tz and ts.tzinfo is None:
                ts = ts.tz_localize("UTC")
            return _wrap_ts(ts)

        return _rowwise(_strptime, a, rest[0], n=n)
    if name == "to_utc":
        tz = kwargs["from_timezone"]
        return _rowwise(
            lambda t: DateTimeUtc(pd.Timestamp(t).tz_localize(tz).tz_convert("UTC")),
            a,
            n=n,
        )
    if name == "to_naive_in_timezone":
        tz = kwargs["timezone"]
        return _rowwise(
            lambda t: DateTimeNaive(pd.Timestamp(t).tz_convert(tz).tz_localize(None)),
            a,
            n=n,
        )
    if name == "add_duration_in_timezone":
        tz = kwargs["timezone"]

        def _add(t, d):
            base = pd.Timestamp(t)
            if base.tzinfo is None:
                return _wrap_ts((base.tz_localize(tz) + d).tz_localize(None))
            return _wrap_ts(base + d)

        return _rowwise(_add, a, rest[0], n=n)
    if name == "subtract_duration_in_timezone":
        tz = kwargs["timezone"]

        def _sub(t, d):
            base = pd.Timestamp(t)
            if base.tzinfo is None:
                return _wrap_ts((base.tz_localize(tz) - d).tz_localize(None))
            return _wrap_ts(base - d)

        return _rowwise(_sub, a, rest[0], n=n)
    if name == "subtract_date_time_in_timezone":
        def _sub2(t, o):
            return Duration(pd.Timestamp(t) - pd.Timestamp(o))

        return _rowwise(_sub2, a, rest[0], n=n)
    if name == "round":
        return _rowwise(lambda t, d: _wrap_ts(pd.Timestamp(t).round(pd.Timedelta(d))), a, rest[0], n=n)
    if name == "floor":
        return _rowwise(lambda t, d: _wrap_ts(pd.Timestamp(t).floor(pd.Timedelta(d))), a, rest[0], n=n)
    if name == "from_timestamp":
        unit = kwargs["unit"]
        return _rowwise(
            lambda v: DateTimeNaive(pd.Timestamp(int(v * _UNIT_NS[unit]))), a, n=n
        )
    if name == "utc_from_timestamp":
        unit = kwargs["unit"]
        return _rowwise(
            lambda v: DateTimeUtc(pd.Timestamp(int(v * _UNIT_NS[unit]), tz="UTC")),
            a,
            n=n,
        )
    if name == "to_duration":
        unit = kwargs["unit"]
        return _rowwise(lambda v: Duration(int(v * _UNIT_NS[unit]), unit="ns"), a, n=n)
    dur_fields = {
        "nanoseconds": lambda d: _dur_ns(d),
        "microseconds": lambda d: _dur_ns(d) // 10**3,
        "milliseconds": lambda d: _dur_ns(d) // 10**6,
        "seconds": lambda d: _dur_ns(d) // 10**9,
        "minutes": lambda d: _dur_ns(d) // (60 * 10**9),
        "hours": lambda d: _dur_ns(d) // (3600 * 10**9),
        "days": lambda d: _dur_ns(d) // (86400 * 10**9),
        "weeks": lambda d: _dur_ns(d) // (7 * 86400 * 10**9),
    }
    if name in dur_fields:
        return _rowwise(dur_fields[name], a, n=n)
    raise ValueError(f"unknown dt method {name!r}")


def _convert_fmt(fmt: str) -> str:
    # the reference accepts chrono %f variants; pandas uses python strftime
    return fmt


def _dispatch_num(name: str, args, kwargs, n) -> np.ndarray:
    a = args[0]
    rest = args[1:]
    if name == "abs":
        return _rowwise(abs, a, n=n)
    if name == "round":
        return _rowwise(lambda v, d: round(v, d) if d else float(round(v)) if isinstance(v, float) else round(v), a, rest[0], n=n)
    if name == "fill_na":
        def _fill(v, d):
            if v is None:
                return d
            if isinstance(v, float) and v != v:  # NaN
                return d
            return v

        out = np.empty(n, dtype=object)
        for i in range(n):
            v = a[i]
            d = rest[0][i]
            if v is ERROR:
                out[i] = ERROR
            else:
                out[i] = _fill(v, d)
        return out
    raise ValueError(f"unknown num method {name!r}")
