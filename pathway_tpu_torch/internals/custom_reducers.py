"""Custom accumulator-based reducers (reference ``internals/custom_reducers.py``).

``BaseCustomAccumulator`` + ``pw.reducers.udf_reducer`` let users define
aggregations as Python classes with from_row/update/compute_result (and
optionally retract for retraction support).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any


class BaseCustomAccumulator(ABC):
    @classmethod
    @abstractmethod
    def from_row(cls, row: list) -> "BaseCustomAccumulator": ...

    @abstractmethod
    def update(self, other: "BaseCustomAccumulator") -> None: ...

    @abstractmethod
    def compute_result(self) -> Any: ...

    def retract(self, other: "BaseCustomAccumulator") -> None:
        raise NotImplementedError(
            "this accumulator does not support retraction"
        )
