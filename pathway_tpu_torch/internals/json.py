"""``pw.Json`` — immutable JSON value wrapper.

Parity with reference ``python/pathway/internals/json.py`` (``pw.Json``): a
wrapper over parsed JSON data supporting indexing, ``as_*`` coercions and
equality; engine columns of dtype JSON store these on the host (irregular data
never goes to the device).
"""

from __future__ import annotations

import json as _json
from typing import Any, Iterator


class Json:
    __slots__ = ("_value",)

    # convenience parse/serialize
    @staticmethod
    def parse(s: str | bytes) -> "Json":
        return Json(_json.loads(s))

    @staticmethod
    def dumps(obj: Any) -> str:
        return _json.dumps(unwrap_json(obj), separators=(",", ":"), sort_keys=False)

    def __init__(self, value: Any = None):
        if isinstance(value, Json):
            value = value._value
        self._value = value

    @property
    def value(self) -> Any:
        return self._value

    def __getitem__(self, key) -> "Json":
        v = self._value
        try:
            return Json(v[key])
        except (KeyError, IndexError, TypeError):
            raise

    def get(self, key, default=None):
        v = self._value
        try:
            return Json(v[key])
        except (KeyError, IndexError, TypeError):
            return default

    def __iter__(self) -> Iterator["Json"]:
        if isinstance(self._value, list):
            return (Json(v) for v in self._value)
        if isinstance(self._value, dict):
            return (Json(k) for k in self._value)
        raise TypeError(f"Json {self._value!r} is not iterable")

    def __len__(self) -> int:
        return len(self._value)

    def __contains__(self, item) -> bool:
        if isinstance(item, Json):
            item = item._value
        return item in self._value

    def __eq__(self, other) -> bool:
        if isinstance(other, Json):
            return self._value == other._value
        return self._value == other

    def __hash__(self) -> int:
        return hash(Json.dumps(self._value))

    def __repr__(self) -> str:
        return f"pw.Json({self._value!r})"

    def __str__(self) -> str:
        return Json.dumps(self._value)

    def __bool__(self) -> bool:
        return bool(self._value)

    # typed coercions (raise on mismatch, like the reference)
    def as_int(self) -> int:
        v = self._value
        if isinstance(v, bool) or not isinstance(v, int):
            raise ValueError(f"Json {v!r} is not an int")
        return v

    def as_float(self) -> float:
        v = self._value
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ValueError(f"Json {v!r} is not a float")
        return float(v)

    def as_str(self) -> str:
        if not isinstance(self._value, str):
            raise ValueError(f"Json {self._value!r} is not a str")
        return self._value

    def as_bool(self) -> bool:
        if not isinstance(self._value, bool):
            raise ValueError(f"Json {self._value!r} is not a bool")
        return self._value

    def as_list(self) -> list:
        if not isinstance(self._value, list):
            raise ValueError(f"Json {self._value!r} is not a list")
        return self._value

    def as_dict(self) -> dict:
        if not isinstance(self._value, dict):
            raise ValueError(f"Json {self._value!r} is not a dict")
        return self._value

    NULL: "Json"


Json.NULL = Json(None)


def unwrap_json(obj: Any) -> Any:
    if isinstance(obj, Json):
        return unwrap_json(obj._value)
    if isinstance(obj, dict):
        return {k: unwrap_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [unwrap_json(v) for v in obj]
    return obj
