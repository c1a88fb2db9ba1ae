"""Join mode enum (reference ``internals/join_mode.py``). String ``how=``
values remain accepted everywhere; the enum is the documented public form
(``pw.JoinMode.INNER``)."""

from __future__ import annotations

from enum import Enum


class JoinMode(Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    OUTER = "outer"
