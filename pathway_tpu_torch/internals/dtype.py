"""Data types for the pathway_tpu_torch type system.

Capability parity with the reference type lattice (see reference
``python/pathway/internals/dtype.py``), re-designed around a small set of
singleton/interned type objects so dtype equality is fast ``is`` comparison.

Dtypes matter for two things here:
  * schema validation / expression type inference (host side), and
  * column storage planning — numeric dtypes map to dense numpy/JAX arrays
    (vectorizable), everything else to object arrays on the host.
"""

from __future__ import annotations

import datetime
import typing
from abc import ABC, abstractmethod
from typing import Any, Callable, Mapping

import numpy as np


class DType(ABC):
    """Base class of all pathway_tpu_torch dtypes."""

    _cache: dict[Any, DType] = {}

    def __new__(cls, *args):
        key = (cls, args)
        if key not in DType._cache:
            obj = super().__new__(cls)
            obj._init(*args)
            DType._cache[key] = obj
        return DType._cache[key]

    def _init(self, *args) -> None:
        pass

    @abstractmethod
    def __repr__(self) -> str: ...

    @property
    @abstractmethod
    def typehint(self) -> Any: ...

    def is_value_compatible(self, value: Any) -> bool:
        """Runtime check whether ``value`` inhabits this dtype."""
        raise NotImplementedError

    @property
    def numpy_dtype(self) -> np.dtype:
        """Storage dtype for engine columns; ``object`` if irregular."""
        return np.dtype(object)

    def is_optional(self) -> bool:
        return False

    def strip_optional(self) -> DType:
        return self

    @property
    def max_size(self) -> float:
        return float("inf")

    def __call__(self, *args):
        return self


class _SimpleDType(DType):
    def _init(self, name: str, hint: Any, np_dtype, py_types: tuple) -> None:
        self._name = name
        self._hint = hint
        self._np_dtype = np.dtype(np_dtype) if np_dtype is not None else np.dtype(object)
        self._py_types = py_types

    def __repr__(self) -> str:
        return self._name

    @property
    def typehint(self) -> Any:
        return self._hint

    @property
    def numpy_dtype(self) -> np.dtype:
        return self._np_dtype

    def is_value_compatible(self, value: Any) -> bool:
        if self is FLOAT and isinstance(value, (int, np.integer)):
            return True  # int widens to float
        if self is BOOL and not isinstance(value, (bool, np.bool_)):
            return False
        if self is INT and isinstance(value, (bool, np.bool_)):
            return False
        return isinstance(value, self._py_types)


INT = _SimpleDType("INT", int, np.int64, (int, np.integer))
FLOAT = _SimpleDType("FLOAT", float, np.float64, (float, int, np.floating, np.integer))
BOOL = _SimpleDType("BOOL", bool, np.bool_, (bool, np.bool_))
STR = _SimpleDType("STR", str, None, (str,))
BYTES = _SimpleDType("BYTES", bytes, None, (bytes,))


class _NoneDType(DType):
    def __repr__(self) -> str:
        return "NONE"

    @property
    def typehint(self) -> Any:
        return None

    def is_value_compatible(self, value: Any) -> bool:
        return value is None


NONE = _NoneDType()


class _AnyDType(DType):
    def __repr__(self) -> str:
        return "ANY"

    @property
    def typehint(self) -> Any:
        return Any

    def is_value_compatible(self, value: Any) -> bool:
        return True


ANY = _AnyDType()


class _DateTimeNaive(DType):
    def __repr__(self) -> str:
        return "DATE_TIME_NAIVE"

    @property
    def typehint(self) -> Any:
        from pathway_tpu_torch.internals.datetime_types import DateTimeNaive

        return DateTimeNaive

    def is_value_compatible(self, value: Any) -> bool:
        return (
            isinstance(value, datetime.datetime) and value.tzinfo is None
        ) or (hasattr(value, "tz") and getattr(value, "tz", None) is None and hasattr(value, "to_pydatetime"))


class _DateTimeUtc(DType):
    def __repr__(self) -> str:
        return "DATE_TIME_UTC"

    @property
    def typehint(self) -> Any:
        from pathway_tpu_torch.internals.datetime_types import DateTimeUtc

        return DateTimeUtc

    def is_value_compatible(self, value: Any) -> bool:
        return isinstance(value, datetime.datetime) and value.tzinfo is not None


class _Duration(DType):
    def __repr__(self) -> str:
        return "DURATION"

    @property
    def typehint(self) -> Any:
        from pathway_tpu_torch.internals.datetime_types import Duration

        return Duration

    def is_value_compatible(self, value: Any) -> bool:
        return isinstance(value, datetime.timedelta) or (
            hasattr(value, "to_pytimedelta")
        )


DATE_TIME_NAIVE = _DateTimeNaive()
DATE_TIME_UTC = _DateTimeUtc()
DURATION = _Duration()


class _Json(DType):
    def __repr__(self) -> str:
        return "JSON"

    @property
    def typehint(self) -> Any:
        from pathway_tpu_torch.internals.json import Json

        return Json

    def is_value_compatible(self, value: Any) -> bool:
        from pathway_tpu_torch.internals.json import Json

        return isinstance(value, (Json, dict, list, str, int, float, bool)) or value is None


JSON = _Json()


class Pointer(DType):
    """Row-reference dtype; optionally schema-typed (``Pointer[MySchema]``)."""

    def _init(self, wrapped=None) -> None:
        self.wrapped = wrapped

    def __repr__(self) -> str:
        if self.wrapped is not None:
            return f"POINTER({getattr(self.wrapped, '__name__', self.wrapped)})"
        return "POINTER"

    @property
    def typehint(self) -> Any:
        from pathway_tpu_torch.internals.api import Pointer as PointerValue

        return PointerValue

    @property
    def numpy_dtype(self) -> np.dtype:
        return np.dtype(object)

    def is_value_compatible(self, value: Any) -> bool:
        from pathway_tpu_torch.internals.api import Pointer as PointerValue

        return isinstance(value, PointerValue)


ANY_POINTER = Pointer(None)


class Array(DType):
    """N-dimensional numeric array dtype (``np.ndarray`` values).

    ``n_dim=None`` means unknown rank. ``wrapped`` is the element dtype
    (INT or FLOAT). These columns are the dense vectorizable ones.
    """

    def _init(self, n_dim=None, wrapped=FLOAT) -> None:
        self.n_dim = n_dim
        self.wrapped = wrapped

    def __repr__(self) -> str:
        return f"Array({self.n_dim}, {self.wrapped})"

    @property
    def typehint(self) -> Any:
        return np.ndarray

    def is_value_compatible(self, value: Any) -> bool:
        if not isinstance(value, np.ndarray):
            # the port's device arrays are torch tensors
            import torch

            return isinstance(value, torch.Tensor)
        return self.n_dim is None or value.ndim == self.n_dim


ANY_ARRAY = Array(None, ANY)
INT_ARRAY = Array(None, INT)
FLOAT_ARRAY = Array(None, FLOAT)


class Tuple(DType):
    def _init(self, *args) -> None:
        self.args = args

    def __repr__(self) -> str:
        return f"Tuple({', '.join(map(repr, self.args))})"

    @property
    def typehint(self) -> Any:
        if not self.args:
            return typing.Tuple
        return typing.Tuple[tuple(a.typehint for a in self.args)]

    def is_value_compatible(self, value: Any) -> bool:
        if not isinstance(value, (tuple, list)):
            return False
        if len(self.args) != len(value):
            return False
        return all(a.is_value_compatible(v) for a, v in zip(self.args, value))


class List(DType):
    """Homogeneous variable-length tuple (``List(INT)`` ≈ ``tuple[int, ...]``)."""

    def _init(self, wrapped=ANY) -> None:
        self.wrapped = wrapped

    def __repr__(self) -> str:
        return f"List({self.wrapped!r})"

    @property
    def typehint(self) -> Any:
        return typing.Tuple[self.wrapped.typehint, ...]

    def is_value_compatible(self, value: Any) -> bool:
        return isinstance(value, (tuple, list)) and all(
            self.wrapped.is_value_compatible(v) for v in value
        )


ANY_TUPLE = List(ANY)


class Optional(DType):
    def __new__(cls, arg):
        if arg is NONE or arg is ANY or isinstance(arg, Optional) or arg is JSON:
            return arg
        return super().__new__(cls, arg)

    def _init(self, wrapped) -> None:
        self.wrapped = wrapped

    def __repr__(self) -> str:
        return f"Optional({self.wrapped!r})"

    @property
    def typehint(self) -> Any:
        return typing.Optional[self.wrapped.typehint]

    def is_optional(self) -> bool:
        return True

    def strip_optional(self) -> DType:
        return self.wrapped

    def is_value_compatible(self, value: Any) -> bool:
        return value is None or self.wrapped.is_value_compatible(value)


class Callable_(DType):
    def _init(self, arg_types=..., return_type=ANY) -> None:
        self.arg_types = arg_types
        self.return_type = return_type

    def __repr__(self) -> str:
        return "Callable(...)"

    @property
    def typehint(self) -> Any:
        return Callable


class Future(DType):
    """Result of an async UDF that has not been awaited yet (``Future(T)``)."""

    def __new__(cls, arg):
        if isinstance(arg, Future):
            return arg
        return super().__new__(cls, arg)

    def _init(self, wrapped) -> None:
        self.wrapped = wrapped

    def __repr__(self) -> str:
        return f"Future({self.wrapped!r})"

    @property
    def typehint(self) -> Any:
        return self.wrapped.typehint

    def is_value_compatible(self, value: Any) -> bool:
        from pathway_tpu_torch.internals.api import Pending

        return value is Pending or self.wrapped.is_value_compatible(value)


_SIMPLE_FROM_HINT: dict[Any, DType] = {}


def _build_hint_table():
    from pathway_tpu_torch.internals import json as js
    from pathway_tpu_torch.internals import api

    _SIMPLE_FROM_HINT.update(
        {
            int: INT,
            float: FLOAT,
            bool: BOOL,
            str: STR,
            bytes: BYTES,
            type(None): NONE,
            None: NONE,
            Any: ANY,
            datetime.datetime: DATE_TIME_NAIVE,
            datetime.timedelta: DURATION,
            js.Json: JSON,
            dict: JSON,
            np.ndarray: ANY_ARRAY,
            api.Pointer: ANY_POINTER,
            tuple: ANY_TUPLE,
            list: ANY_TUPLE,
        }
    )


class _DatetimeHints:
    """The pandas-backed datetime types as hints, looked up only once
    ``internals.datetime_types`` is loaded: a hint of those types means the
    user imported them (and pandas), and nothing else imports pandas."""

    _NAMES = {"DateTimeNaive": "DATE_TIME_NAIVE", "DateTimeUtc": "DATE_TIME_UTC",
              "Duration": "DURATION"}

    @staticmethod
    def _module():
        import sys

        return sys.modules.get("pathway_tpu_torch.internals.datetime_types")

    def __contains__(self, hint) -> bool:
        mod = self._module()
        return mod is not None and any(
            hint is getattr(mod, n) for n in self._NAMES)

    def __getitem__(self, hint) -> "DType":
        mod = self._module()
        for n, d in self._NAMES.items():
            if hint is getattr(mod, n):
                return globals()[d]
        raise KeyError(hint)


_DATETIME_HINTS = _DatetimeHints()


def wrap(input_type: Any) -> DType:
    """Convert a Python type hint (or a DType) to a DType."""
    if isinstance(input_type, DType):
        return input_type
    if not _SIMPLE_FROM_HINT:
        _build_hint_table()
    if input_type in _SIMPLE_FROM_HINT:
        return _SIMPLE_FROM_HINT[input_type]
    if input_type in _DATETIME_HINTS:
        return _DATETIME_HINTS[input_type]
    origin = typing.get_origin(input_type)
    args = typing.get_args(input_type)
    import types as _types

    if origin is typing.Union or origin is _types.UnionType:
        non_none = [a for a in args if a is not type(None)]
        has_none = len(non_none) != len(args)
        if len(non_none) == 1:
            inner = wrap(non_none[0])
            return Optional(inner) if has_none else inner
        return ANY
    if origin in (tuple, typing.Tuple):
        if len(args) == 2 and args[1] is Ellipsis:
            return List(wrap(args[0]))
        return Tuple(*[wrap(a) for a in args])
    if origin in (list, typing.List):
        return List(wrap(args[0]) if args else ANY)
    if origin is np.ndarray:
        # np.ndarray[Any, np.dtype[np.int64]] style hints
        try:
            el = args[1]
            el_args = typing.get_args(el)
            if el_args and np.issubdtype(el_args[0], np.integer):
                return Array(None, INT)
            if el_args and np.issubdtype(el_args[0], np.floating):
                return Array(None, FLOAT)
        except Exception:
            pass
        return ANY_ARRAY
    # Pointer[Schema]
    from pathway_tpu_torch.internals.api import Pointer as PointerValue

    if origin is PointerValue or input_type is PointerValue:
        if args:
            return Pointer(args[0])
        return ANY_POINTER
    from pathway_tpu_torch.internals import schema as schema_mod

    if isinstance(input_type, type) and issubclass(input_type, schema_mod.Schema):
        return Pointer(input_type)
    if isinstance(input_type, type):
        return ANY
    return ANY


def lub(*dtypes: DType) -> DType:
    """Least upper bound of dtypes (used by if_else, concat, coalesce)."""
    dtypes = tuple(dict.fromkeys(dtypes))
    if len(dtypes) == 0:
        return ANY
    if len(dtypes) == 1:
        return dtypes[0]
    result = dtypes[0]
    for dt in dtypes[1:]:
        result = _lub2(result, dt)
    return result


def _lub2(a: DType, b: DType) -> DType:
    if a is b:
        return a
    if a is ANY or b is ANY:
        return ANY
    if a is NONE:
        return Optional(b)
    if b is NONE:
        return Optional(a)
    a_opt, b_opt = a.is_optional(), b.is_optional()
    if a_opt or b_opt:
        inner = _lub2(a.strip_optional(), b.strip_optional())
        if inner is ANY:
            return ANY
        return Optional(inner)
    if {a, b} == {INT, FLOAT}:
        return FLOAT
    if isinstance(a, Pointer) and isinstance(b, Pointer):
        return ANY_POINTER
    if isinstance(a, Array) and isinstance(b, Array):
        return Array(
            a.n_dim if a.n_dim == b.n_dim else None,
            a.wrapped if a.wrapped is b.wrapped else ANY,
        )
    if isinstance(a, (Tuple, List)) and isinstance(b, (Tuple, List)):
        return ANY_TUPLE
    return ANY


def is_subclass(sub: DType, sup: DType) -> bool:
    """dtype subtyping: may a column of type ``sub`` be used where ``sup`` is expected."""
    if sub is sup or sup is ANY:
        return True
    if sub is ANY:
        return False
    if sub is NONE:
        return sup.is_optional() or sup is NONE or sup is JSON
    if sup.is_optional() and not sub.is_optional():
        return is_subclass(sub, sup.strip_optional())
    if sub.is_optional():
        return sup.is_optional() and is_subclass(
            sub.strip_optional(), sup.strip_optional()
        )
    if sub is INT and sup is FLOAT:
        return True
    if isinstance(sub, Pointer) and isinstance(sup, Pointer):
        return sup.wrapped is None or sub.wrapped is sup.wrapped
    if isinstance(sub, Array) and isinstance(sup, Array):
        dim_ok = sup.n_dim is None or sup.n_dim == sub.n_dim
        el_ok = sup.wrapped is ANY or sup.wrapped is sub.wrapped or (
            sub.wrapped is INT and sup.wrapped is FLOAT
        )
        return dim_ok and el_ok
    if isinstance(sub, Tuple) and isinstance(sup, List):
        return all(is_subclass(a, sup.wrapped) for a in sub.args)
    if isinstance(sub, Tuple) and isinstance(sup, Tuple):
        return len(sub.args) == len(sup.args) and all(
            is_subclass(x, y) for x, y in zip(sub.args, sup.args)
        )
    if isinstance(sub, List) and isinstance(sup, List):
        return is_subclass(sub.wrapped, sup.wrapped)
    return False


def coerce_value(value: Any, dtype: DType):
    """Coerce a raw input value to dtype's canonical representation."""
    from pathway_tpu_torch.internals.api import ERROR

    if value is ERROR:
        return value
    if value is None:
        return None
    if dtype is FLOAT and isinstance(value, (int, np.integer)):
        return float(value)
    if dtype is INT and isinstance(value, np.integer):
        return int(value)
    if dtype is BOOL and isinstance(value, np.bool_):
        return bool(value)
    if dtype.is_optional():
        return coerce_value(value, dtype.strip_optional())
    if isinstance(dtype, List) or isinstance(dtype, Tuple):
        if isinstance(value, list):
            return tuple(value)
    return value


def dtype_of_value(value: Any) -> DType:
    from pathway_tpu_torch.internals.api import Pointer as PointerValue, ERROR
    from pathway_tpu_torch.internals.json import Json

    if value is None:
        return NONE
    if value is ERROR:
        return ANY
    if isinstance(value, (bool, np.bool_)):
        return BOOL
    if isinstance(value, (int, np.integer)):
        return INT
    if isinstance(value, (float, np.floating)):
        return FLOAT
    if isinstance(value, str):
        return STR
    if isinstance(value, bytes):
        return BYTES
    if isinstance(value, PointerValue):
        return ANY_POINTER
    if isinstance(value, Json):
        return JSON
    # the pandas-backed datetime types subclass datetime / timedelta
    if isinstance(value, datetime.datetime):
        return DATE_TIME_UTC if value.tzinfo is not None else DATE_TIME_NAIVE
    if isinstance(value, datetime.timedelta):
        return DURATION
    if isinstance(value, np.ndarray):
        if np.issubdtype(value.dtype, np.integer):
            return Array(value.ndim, INT)
        if np.issubdtype(value.dtype, np.floating):
            return Array(value.ndim, FLOAT)
        return Array(value.ndim, ANY)
    if isinstance(value, (tuple, list)):
        return Tuple(*[dtype_of_value(v) for v in value])
    if isinstance(value, dict):
        return JSON
    if callable(value):
        return Callable_()
    return ANY
