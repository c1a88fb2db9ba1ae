"""Schema system — class-based table schemas.

Parity with reference ``python/pathway/internals/schema.py``: metaclass
collects annotations into column definitions (dtype, primary key, default,
append_only properties); helpers build schemas from types/dicts/pandas.
"""

from __future__ import annotations

import typing
from dataclasses import dataclass
from typing import Any, Iterable, Mapping

from pathway_tpu_torch.internals import dtype as dt


_no_default = object()


@dataclass(frozen=True)
class ColumnDefinition:
    dtype: dt.DType
    primary_key: bool = False
    default_value: Any = _no_default
    append_only: bool | None = None
    name: str | None = None

    @property
    def has_default_value(self) -> bool:
        return self.default_value is not _no_default


def column_definition(
    *,
    primary_key: bool = False,
    default_value: Any = _no_default,
    dtype: Any = None,
    name: str | None = None,
    append_only: bool | None = None,
) -> Any:
    """Column marker used as a class-body default in Schema definitions."""
    return ColumnDefinition(
        dtype=dt.wrap(dtype) if dtype is not None else dt.ANY,
        primary_key=primary_key,
        default_value=default_value,
        append_only=append_only,
        name=name,
    )


class SchemaProperties:
    def __init__(self, append_only: bool | None = None):
        self.append_only = append_only


class SchemaMetaclass(type):
    __columns__: dict[str, ColumnDefinition]
    __append_only__: bool

    def __init__(cls, name, bases, namespace, append_only: bool | None = None, **kwargs):
        super().__init__(name, bases, namespace)
        columns: dict[str, ColumnDefinition] = {}
        for base in bases:
            if hasattr(base, "__columns__"):
                columns.update(base.__columns__)
        hints = namespace.get("__annotations__", {})
        module = namespace.get("__module__")
        localns = dict(namespace)
        for col_name, hint in hints.items():
            if col_name.startswith("__"):
                continue
            try:
                if isinstance(hint, str):
                    import sys

                    globalns = getattr(sys.modules.get(module), "__dict__", {})
                    hint = eval(hint, globalns, localns)  # noqa: S307
            except Exception:
                hint = Any
            dtype = dt.wrap(hint)
            definition = namespace.get(col_name, None)
            if isinstance(definition, ColumnDefinition):
                columns[definition.name or col_name] = ColumnDefinition(
                    dtype=dtype if definition.dtype is dt.ANY else definition.dtype,
                    primary_key=definition.primary_key,
                    default_value=definition.default_value,
                    append_only=definition.append_only,
                    name=definition.name or col_name,
                )
            else:
                columns[col_name] = ColumnDefinition(dtype=dtype, name=col_name)
        cls.__columns__ = columns
        cls.__append_only__ = bool(append_only) if append_only is not None else False

    def __or__(cls, other: "SchemaMetaclass") -> "SchemaMetaclass":
        columns = dict(cls.__columns__)
        for name, col in other.__columns__.items():
            if name in columns and columns[name].dtype is not col.dtype:
                raise TypeError(
                    f"cannot merge schemas: column {name!r} has conflicting types"
                )
            columns[name] = col
        return schema_builder_from_definitions(columns, name=f"{cls.__name__}|{other.__name__}")

    def __getitem__(cls, item):
        return cls  # generic subscripting tolerated

    def column_names(cls) -> list[str]:
        return list(cls.__columns__.keys())

    def columns(cls) -> Mapping[str, ColumnDefinition]:
        return dict(cls.__columns__)

    def keys(cls):
        return cls.__columns__.keys()

    def primary_key_columns(cls) -> list[str] | None:
        pkeys = [n for n, c in cls.__columns__.items() if c.primary_key]
        return pkeys or None

    def typehints(cls) -> dict[str, Any]:
        return {n: c.dtype.typehint for n, c in cls.__columns__.items()}

    def _dtypes(cls) -> dict[str, dt.DType]:
        return {n: c.dtype for n, c in cls.__columns__.items()}

    def default_values(cls) -> dict[str, Any]:
        # cached per schema class: connectors call this once per RECORD on
        # the parse hot path (schema classes are never mutated after build).
        # Wrapped read-only so a caller mutating the result cannot corrupt
        # every later record's defaults.
        cached = cls.__dict__.get("_default_values_cache")
        if cached is None:
            import types as _types

            cached = _types.MappingProxyType(
                {
                    n: c.default_value
                    for n, c in cls.__columns__.items()
                    if c.has_default_value
                }
            )
            cls._default_values_cache = cached
        return cached

    def with_types(cls, **kwargs) -> "SchemaMetaclass":
        columns = dict(cls.__columns__)
        for name, hint in kwargs.items():
            if name not in columns:
                raise ValueError(f"schema has no column {name!r}")
            old = columns[name]
            columns[name] = ColumnDefinition(
                dtype=dt.wrap(hint),
                primary_key=old.primary_key,
                default_value=old.default_value,
                append_only=old.append_only,
                name=old.name,
            )
        return schema_builder_from_definitions(columns, name=cls.__name__)

    update_types = with_types

    def without(cls, *columns_to_remove) -> "SchemaMetaclass":
        names = {
            c if isinstance(c, str) else c.name for c in columns_to_remove
        }
        columns = {
            n: c for n, c in cls.__columns__.items() if n not in names
        }
        return schema_builder_from_definitions(columns, name=cls.__name__)

    def update_properties(cls, **kwargs) -> "SchemaMetaclass":
        return schema_builder_from_definitions(
            dict(cls.__columns__), name=cls.__name__, **kwargs
        )

    @property
    def universe_properties(cls) -> SchemaProperties:
        return SchemaProperties(append_only=cls.__append_only__)

    def __repr__(cls):
        cols = ", ".join(f"{n}: {c.dtype!r}" for n, c in cls.__columns__.items())
        return f"<pw.Schema {cls.__name__}({cols})>"

    def assert_matches_schema(
        cls,
        other: "SchemaMetaclass",
        *,
        allow_superset: bool = True,
        ignore_primary_keys: bool = True,
    ) -> None:
        for name, col in cls.__columns__.items():
            if name not in other.__columns__:
                raise AssertionError(f"column {name!r} missing")
            if not dt.is_subclass(other.__columns__[name].dtype, col.dtype):
                raise AssertionError(
                    f"column {name!r}: {other.__columns__[name].dtype!r} "
                    f"does not match {col.dtype!r}"
                )
        if not allow_superset:
            extra = set(other.__columns__) - set(cls.__columns__)
            if extra:
                raise AssertionError(f"unexpected columns: {sorted(extra)}")


class Schema(metaclass=SchemaMetaclass):
    """Base class for user-defined table schemas:

    >>> class InputSchema(pw.Schema):
    ...     name: str
    ...     age: int
    """

    def __init_subclass__(cls, /, append_only: bool | None = None, **kwargs):
        super().__init_subclass__(**kwargs)


_anon_counter = 0


def schema_builder_from_definitions(
    columns: dict[str, ColumnDefinition], name: str | None = None, **props
) -> SchemaMetaclass:
    global _anon_counter
    _anon_counter += 1
    name = name or f"AnonymousSchema_{_anon_counter}"
    cls = SchemaMetaclass(name, (Schema,), {"__annotations__": {}}, **props)
    cls.__columns__ = dict(columns)
    if "append_only" in props:
        cls.__append_only__ = bool(props["append_only"])
    return cls


def schema_from_types(_name: str | None = None, **kwargs) -> SchemaMetaclass:
    """``pw.schema_from_types(a=int, b=str)``"""
    columns = {
        n: ColumnDefinition(dtype=dt.wrap(t), name=n) for n, t in kwargs.items()
    }
    return schema_builder_from_definitions(columns, name=_name)


def schema_from_dict(
    columns: Mapping[str, Any], *, name: str | None = None
) -> SchemaMetaclass:
    defs: dict[str, ColumnDefinition] = {}
    for col, spec in columns.items():
        if isinstance(spec, dict):
            defs[col] = ColumnDefinition(
                dtype=dt.wrap(spec.get("dtype", Any)),
                primary_key=spec.get("primary_key", False),
                default_value=spec.get("default_value", _no_default),
                name=col,
            )
        else:
            defs[col] = ColumnDefinition(dtype=dt.wrap(spec), name=col)
    return schema_builder_from_definitions(defs, name=name)


def schema_builder(
    columns: Mapping[str, ColumnDefinition],
    *,
    name: str | None = None,
    properties: SchemaProperties | None = None,
) -> SchemaMetaclass:
    defs = {}
    for col, cd in columns.items():
        defs[col] = ColumnDefinition(
            dtype=cd.dtype,
            primary_key=cd.primary_key,
            default_value=cd.default_value,
            append_only=cd.append_only,
            name=cd.name or col,
        )
    props = {}
    if properties is not None:
        props["append_only"] = properties.append_only
    return schema_builder_from_definitions(defs, name=name, **props)


_NP_TO_HINT = {
    "i": int,
    "u": int,
    "f": float,
    "b": bool,
    "O": Any,
    "U": str,
    "S": bytes,
    "M": None,
    "m": None,
}


def schema_from_pandas(
    df, *, id_from: list[str] | None = None, name: str | None = None, exclude_columns: Iterable[str] = ()
) -> SchemaMetaclass:
    import pandas as pd

    defs: dict[str, ColumnDefinition] = {}
    id_from = id_from or []
    for col in df.columns:
        if col in exclude_columns:
            continue
        kind = df[col].dtype.kind
        if kind == "M":
            dtype = (
                dt.DATE_TIME_UTC
                if getattr(df[col].dtype, "tz", None) is not None
                else dt.DATE_TIME_NAIVE
            )
        elif kind == "m":
            dtype = dt.DURATION
        elif kind == "O":
            vals = [v for v in df[col] if v is not None and not (isinstance(v, float) and pd.isna(v))]
            dtype = dt.lub(*[dt.dtype_of_value(v) for v in vals]) if vals else dt.ANY
        else:
            hint = _NP_TO_HINT.get(kind, Any)
            dtype = dt.wrap(hint)
        defs[str(col)] = ColumnDefinition(
            dtype=dtype, primary_key=str(col) in id_from, name=str(col)
        )
    return schema_builder_from_definitions(defs, name=name)


def schema_from_csv(path: str, *, name: str | None = None, **kwargs) -> SchemaMetaclass:
    import pandas as pd

    df = pd.read_csv(path, nrows=100, **kwargs)
    return schema_from_pandas(df, name=name)
