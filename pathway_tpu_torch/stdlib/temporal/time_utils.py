"""Clock streams and inactivity detection (reference
``stdlib/temporal/time_utils.py``)."""

from __future__ import annotations

import datetime
import time

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals.schema import Schema
from pathway_tpu_torch.io.python import ConnectorSubject


class TimestampSchema(Schema):
    # the dtype, not the pandas-backed class: importing this module does
    # not import pandas
    timestamp_utc: dt.DATE_TIME_UTC


class TimestampSubject(ConnectorSubject):
    """Emits the current UTC time every ``refresh_rate``; exits promptly
    when the connector is stopped."""

    def __init__(self, refresh_rate: datetime.timedelta) -> None:
        super().__init__()
        self._refresh_rate = refresh_rate
        self._stopped = False

    def run(self) -> None:
        while not self._stopped and not self._connector_stopping():
            now_utc = datetime.datetime.now(datetime.timezone.utc)
            self.next(timestamp_utc=now_utc)
            self.commit()
            deadline = time.monotonic() + self._refresh_rate.total_seconds()
            while time.monotonic() < deadline:
                if self._stopped or self._connector_stopping():
                    return
                time.sleep(min(0.1, self._refresh_rate.total_seconds()))

    def _connector_stopping(self) -> bool:
        c = self._connector
        return c is not None and c.should_stop()

    def on_stop(self) -> None:
        self._stopped = True


# memoized per (refresh_rate, engine graph): a cleared graph must get a
# fresh stream, not a Table bound to dead nodes
_utc_now_memo: dict = {}


def utc_now(refresh_rate: datetime.timedelta = datetime.timedelta(seconds=60)):
    """A continuously updating stream of the current UTC time
    (reference ``time_utils.py:utc_now``); one stream per refresh rate per
    engine graph."""
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.io import python as io_python

    key = (refresh_rate, id(G.engine_graph))
    if key not in _utc_now_memo:
        _utc_now_memo[key] = io_python.read(
            TimestampSubject(refresh_rate=refresh_rate),
            schema=TimestampSchema,
        )
    return _utc_now_memo[key]


def inactivity_detection(
    event_time_column,
    allowed_inactivity_period,
    refresh_rate: datetime.timedelta = datetime.timedelta(seconds=1),
    instance=None,
):
    """Flag inactivity gaps longer than ``allowed_inactivity_period`` and the
    events that resume activity (reference ``time_utils.py:52``).  Returns
    (inactivities, resumed_activities) with columns ``inactive_t`` /
    ``resumed_t`` (+ ``instance`` when given).  Assumes event times track
    current UTC."""
    events_t = event_time_column.table.select(t=event_time_column, instance=instance)

    now_t = utc_now(refresh_rate=refresh_rate)
    # build-time cutoff avoids alerting while backfilling historical events
    started_at = datetime.datetime.now(datetime.timezone.utc)
    grouped = events_t.groupby(events_t.instance).reduce(
        events_t.instance, latest_t=reducers.max(events_t.t)
    )
    latest_t = grouped.filter(grouped.latest_t > started_at)
    joined = now_t.asof_now_join(latest_t).select(
        timestamp_utc=now_t.timestamp_utc,
        instance=latest_t.instance,
        latest_t=latest_t.latest_t,
    )
    stale = joined.filter(
        joined.latest_t + allowed_inactivity_period < joined.timestamp_utc
    )
    inactivities = (
        stale.groupby(stale.latest_t, stale.instance)
        .reduce(stale.latest_t, stale.instance)
    )
    inactivities = inactivities.select(
        instance=inactivities.instance, inactive_t=inactivities.latest_t
    )

    latest_inactivity = inactivities.groupby(inactivities.instance).reduce(
        inactivities.instance,
        inactive_t=reducers.latest(inactivities.inactive_t),
    )
    resumed_joined = events_t.asof_now_join(
        latest_inactivity, events_t.instance == latest_inactivity.instance
    ).select(
        t=events_t.t,
        instance=events_t.instance,
        inactive_t=latest_inactivity.inactive_t,
    )
    after = resumed_joined.filter(resumed_joined.t > resumed_joined.inactive_t)
    resumed_activities = after.groupby(after.inactive_t, after.instance).reduce(
        after.instance, resumed_t=reducers.min(after.t)
    )
    if instance is None:
        inactivities = inactivities.without("instance")
        resumed_activities = resumed_activities.without("instance")
    return inactivities, resumed_activities
