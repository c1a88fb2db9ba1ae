"""Monitoring levels (reference ``internals/monitoring.py``).

``MonitoringLevel`` is the JAX package's enum, member for member. The
port carries no live dashboard yet (ROADMAP A13): ``pw.run`` takes the
levels that resolve to ``NONE`` — ``NONE`` itself, and ``None`` / ``AUTO``
/ ``AUTO_ALL`` when standard error is not a terminal, as JAX resolves them
— and raises for a level that would start the dashboard.
"""

from __future__ import annotations

import enum


class MonitoringLevel(enum.Enum):
    AUTO = 0
    AUTO_ALL = 1
    NONE = 2
    IN_OUT = 3
    ALL = 4


def resolve_level(level) -> MonitoringLevel:
    """``level`` (a member, its name, or None) resolved against standard
    error's terminal state, as JAX's ``maybe_start_monitor`` does: None
    and the AUTO levels mean NONE off a terminal."""
    import sys

    if isinstance(level, str):
        level = MonitoringLevel[level.upper()]
    if level is None or level in (MonitoringLevel.AUTO, MonitoringLevel.AUTO_ALL):
        if not sys.stderr.isatty():
            return MonitoringLevel.NONE
        return (MonitoringLevel.ALL if level == MonitoringLevel.AUTO_ALL
                else MonitoringLevel.IN_OUT)
    return level
