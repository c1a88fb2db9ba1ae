"""Bridge between the Python API layer and the execution engine.

The reference's ``internals/api.py`` wraps the PyO3 extension module
``pathway.engine``; here the engine lives in ``pathway_tpu_torch.engine`` (Python
orchestration + numpy/JAX kernels + optional C++ native helpers), and this
module re-exports its value-level surface.
"""

from __future__ import annotations

from typing import Any, TypeVar, Generic

from pathway_tpu_torch.engine.value import (
    ERROR,
    Pending,
    Pointer,
    hash_values,
    ref_scalar,
    ref_scalar_with_instance,
    shard_of_key,
)

TSchema = TypeVar("TSchema")

Value = Any
CapturedStream = list


class PathwayType:
    """Engine-level type tags (reference python_api.rs PathwayType enum)."""

    ANY = "any"
    STRING = "string"
    INT = "int"
    BOOL = "bool"
    FLOAT = "float"
    POINTER = "pointer"
    DATE_TIME_NAIVE = "date_time_naive"
    DATE_TIME_UTC = "date_time_utc"
    DURATION = "duration"
    ARRAY = "array"
    JSON = "json"
    TUPLE = "tuple"
    BYTES = "bytes"
    PY_OBJECT_WRAPPER = "py_object_wrapper"


class PyObjectWrapper(Generic[TSchema]):
    """Marks an arbitrary Python object traveling through the engine
    (reference ``Value::PyObjectWrapper``)."""

    __slots__ = ("value", "_serializer")

    def __init__(self, value: Any, *, _serializer: Any = None):
        self.value = value
        self._serializer = _serializer

    def __repr__(self) -> str:
        return f"pw.wrap_py_object({self.value!r})"

    def __eq__(self, other):
        return isinstance(other, PyObjectWrapper) and self.value == other.value

    def __hash__(self):
        return hash(("PyObjectWrapper", id(self.value)))


def wrap_py_object(value: Any, *, serializer: Any = None) -> PyObjectWrapper:
    return PyObjectWrapper(value, _serializer=serializer)


def unwrap_py_object(value: Any) -> Any:
    if isinstance(value, PyObjectWrapper):
        return value.value
    return value


class SessionType:
    NATIVE = "native"
    UPSERT = "upsert"


class ConnectorMode:
    STATIC = "static"
    STREAMING = "streaming"


class ReadMethod:
    BY_LINE = "by_line"
    FULL = "full"


class PersistenceMode:
    BATCH = "batch"
    SPEEDRUN_REPLAY = "speedrun_replay"
    REALTIME_REPLAY = "realtime_replay"
    PERSISTING = "persisting"
    SELECTIVE_PERSISTING = "selective_persisting"
    UDF_CACHING = "udf_caching"
    OPERATOR_PERSISTING = "operator_persisting"


class SnapshotAccess:
    RECORD = "record"
    REPLAY = "replay"
    FULL = "full"
    OFFSETS_ONLY = "offsets_only"


class MonitoringLevel:
    NONE = 0
    IN_OUT = 1
    ALL = 2
    AUTO = 3
    AUTO_ALL = 4


__all__ = [
    "ERROR",
    "Pending",
    "Pointer",
    "PyObjectWrapper",
    "wrap_py_object",
    "unwrap_py_object",
    "hash_values",
    "ref_scalar",
    "ref_scalar_with_instance",
    "shard_of_key",
    "PathwayType",
    "SessionType",
    "ConnectorMode",
    "ReadMethod",
    "PersistenceMode",
    "SnapshotAccess",
    "MonitoringLevel",
    "Value",
    "CapturedStream",
]
