"""Fleet supervisor: health checks, drain and respawn, SLO elasticity
(counterpart of ``pathway_tpu/serving/fleet.py``).

:class:`FleetManager` owns the replica lifecycle around a
:class:`~pathway_tpu_torch.serving.router.FleetRouter`:

* the health pass probes every member (``replica.healthy()``; the
  ``replica.health`` chaos site injects probe failures). A member that has
  never probed healthy keeps ``boot_grace_s`` first, unless its process
  has exited (a process replica that died booting); after it, a member
  failing ``fail_threshold`` probes in a row is drained (off the ring, its
  in-flight requests re-queue inside ``FleetCompletion.wait``), stopped,
  and respawned through ``ExponentialBackoffRetryStrategy``;
* elasticity reads each member's ``scrape()`` and reduces the SLO burn
  signals (``engine.slo.max_burn``: both windows must burn). Burn at or
  over ``burn_up_threshold`` adds a replica up to ``max_replicas``; burn
  at or under ``burn_down_threshold`` drops the newest down to
  ``min_replicas``, one step per cooldown. With no objective anywhere
  there is no signal and the fleet keeps its size.

Clock and sleep are injectable, so the policy runs on a fake clock;
:meth:`FleetManager.tick` drives it by hand and
:meth:`FleetManager.run_in_thread` every ``health_interval_s``. The
defaults are the JAX flag defaults: 2 replicas, between 1 and 4, a health
pass every 500 ms.
"""

from __future__ import annotations

import threading
import time

from pathway_tpu_torch.analysis.annotations import guarded_by
from pathway_tpu_torch.analysis.runtime import make_lock
from pathway_tpu_torch.engine import chaos, slo
from pathway_tpu_torch.internals.retries import ExponentialBackoffRetryStrategy
from pathway_tpu_torch.serving.router import FleetRouter


@guarded_by(_fail_counts="_lock", _seq="_lock", _events="_lock",
            _respawns="_lock", _last_scale_at="_lock", _last_burn="_lock",
            _spawned_at="_lock", _ever_ready="_lock",
            _burn_signal_seen="_lock")
class FleetManager:
    """Supervises ``factory(replica_id) -> replica`` instances. The
    bookkeeping below the router (failure counts, spawn times, events,
    respawns, scaling and burn state) is guarded by ``_lock``."""

    def __init__(self, factory, *, router: FleetRouter | None = None,
                 replicas: int = 2, min_replicas: int = 1, max_replicas: int = 4,
                 health_interval_s: float = 0.5, boot_grace_s: float = 0.0,
                 fail_threshold: int = 1, burn_up_threshold: float = 1.0,
                 burn_down_threshold: float = 0.25, scale_cooldown_s: float = 5.0,
                 respawn: ExponentialBackoffRetryStrategy | None = None,
                 clock=None, sleep=None) -> None:
        self.factory = factory
        self.router = router if router is not None else FleetRouter()
        self.min_replicas = int(min_replicas)
        self.max_replicas = max(int(max_replicas), self.min_replicas)
        self.initial_replicas = min(max(int(replicas), self.min_replicas),
                                    self.max_replicas)
        self.health_interval_s = float(health_interval_s)
        self.boot_grace_s = max(0.0, float(boot_grace_s))
        self.fail_threshold = max(1, int(fail_threshold))
        self.burn_up_threshold = float(burn_up_threshold)
        self.burn_down_threshold = float(burn_down_threshold)
        self.scale_cooldown_s = float(scale_cooldown_s)
        # bounded attempts and a capped delay: a replica that cannot come
        # back leaves the fleet smaller (replica_up shows it)
        self.respawn = respawn if respawn is not None else ExponentialBackoffRetryStrategy(
            max_retries=3, initial_delay=50, backoff_factor=2.0, jitter_ms=0,
            max_delay_ms=1000)
        self._clock = clock if clock is not None else time.monotonic
        self._sleep = sleep if sleep is not None else time.sleep
        self._lock = make_lock("serving.fleet")
        self._fail_counts: dict = {}
        self._spawned_at: dict = {}
        self._ever_ready: set = set()
        self._seq = 0
        self._events: list = []  # (kind, replica_id): spawns, drains, scaling
        self._respawns = 0
        self._last_scale_at = float("-inf")
        self._last_burn = 0.0
        self._burn_signal_seen = False
        self._chaos_health = chaos.site("replica.health")
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------

    def _next_id(self) -> str:
        with self._lock:
            rid = f"replica-{self._seq}"
            self._seq += 1
            return rid

    def spawn_one(self) -> str:
        """Build one replica through the factory and join it to the ring;
        a factory error propagates."""
        rid = self._next_id()
        replica = self.factory(rid)
        self.router.add_replica(replica)
        with self._lock:
            self._spawned_at[rid] = self._clock()
            self._events.append(("spawn", rid))
        return rid

    def start(self) -> "FleetManager":
        """Bring the fleet to its initial size (no supervisor thread: call
        :meth:`run_in_thread` or :meth:`tick`)."""
        while len(self.router) < self.initial_replicas:
            self.spawn_one()
        return self

    def stop_one(self, replica_id: str, *, kind: str = "scale_down") -> None:
        replica = self.router.remove_replica(replica_id)
        with self._lock:
            self._fail_counts.pop(replica_id, None)
            self._spawned_at.pop(replica_id, None)
            self._ever_ready.discard(replica_id)
            self._events.append((kind, replica_id))
        if replica is not None:
            try:
                replica.stop()
            except Exception:  # noqa: BLE001 - a dead replica may refuse teardown
                pass

    def shutdown(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        for rid in list(self.router.replicas()):
            self.stop_one(rid, kind="shutdown")

    # -- supervision -------------------------------------------------------

    def _probe(self, replica) -> bool:
        if self._chaos_health is not None:
            self._chaos_health.maybe_fail()
        return bool(replica.healthy())

    def health_pass(self) -> list:
        """One probe sweep: drain and respawn dead members; returns the ids
        drained."""
        drained = []
        now = self._clock()
        for rid, replica in self.router.replicas().items():
            try:
                ok = self._probe(replica)
            except Exception:  # noqa: BLE001 - an injected fault or a probe error
                ok = False
            with self._lock:
                if ok:
                    self._fail_counts[rid] = 0
                    self._ever_ready.add(rid)
                    continue
                # a replica process that has exited is not booting: it is
                # drained at once, not after its grace
                proc = getattr(replica, "proc", None)
                exited = proc is not None and proc.poll() is not None
                booting = (rid not in self._ever_ready and not exited
                           and now - self._spawned_at.get(rid, float("-inf"))
                           < self.boot_grace_s)
                if booting:
                    continue
                self._fail_counts[rid] = self._fail_counts.get(rid, 0) + 1
                dead = self._fail_counts[rid] >= self.fail_threshold
            if dead:
                self.stop_one(rid, kind="drain")
                drained.append(rid)
                self._respawn_replica()
        return drained

    def _respawn_replica(self) -> str | None:
        """Replace a drained replica (up to the maximum), with bounded
        exponential backoff between factory attempts."""
        if len(self.router) >= self.max_replicas:
            return None
        try:
            rid = self.respawn.invoke_sync(self.spawn_one, sleep=self._sleep)
        except Exception:  # noqa: BLE001 - every attempt failed
            with self._lock:
                self._events.append(("respawn_failed", None))
            return None
        with self._lock:
            self._respawns += 1
            if self._events and self._events[-1] == ("spawn", rid):
                self._events[-1] = ("respawn", rid)
        return rid

    # -- elasticity ----------------------------------------------------------

    def burn(self) -> float:
        """The fleet's scale pressure: the largest reduced burn over the
        members' scrapes. Whether any member reported an objective is kept
        apart: no objective means no signal, not a healthy idle fleet."""
        worst, seen = 0.0, False
        for replica in self.router.replicas().values():
            try:
                snap = replica.scrape() or {}
            except Exception:  # noqa: BLE001 - unreachable: the health pass's job
                continue
            state = snap.get("slo") or {}
            seen = seen or bool(slo.burn_signals(state))
            worst = max(worst, slo.max_burn(state))
        with self._lock:
            self._last_burn = worst
            self._burn_signal_seen = seen
        return worst

    def elasticity_pass(self) -> str | None:
        """Scale one step per cooldown on the burn signal."""
        burn = self.burn()
        with self._lock:
            if not self._burn_signal_seen:
                return None
        now = self._clock()
        n = len(self.router)
        with self._lock:
            if now - self._last_scale_at < self.scale_cooldown_s:
                return None
        action = None
        if burn >= self.burn_up_threshold and n < self.max_replicas:
            self.spawn_one()
            action = "scale_up"
        elif burn <= self.burn_down_threshold and n > self.min_replicas:
            # the newest goes first: the oldest hold the warmest caches
            def seq(rid: str) -> int:
                tail = rid.rsplit("-", 1)[-1]
                return int(tail) if tail.isdigit() else -1

            self.stop_one(max(self.router.ring.members(), key=seq), kind="scale_down")
            action = "scale_down"
        if action is not None:
            with self._lock:
                self._last_scale_at = now
        return action

    def tick(self) -> dict:
        """One supervisor iteration: the health pass, then elasticity."""
        drained = self.health_pass()
        action = self.elasticity_pass()
        return {"drained": drained, "scale": action, "size": len(self.router)}

    # -- reporting and the loop ------------------------------------------------

    def state(self) -> dict:
        with self._lock:
            events = list(self._events)
            respawns = self._respawns
            burn = self._last_burn
            fails = dict(self._fail_counts)
        return {
            "replicas": {rid: self._replica_info(r, fails.get(rid, 0))
                         for rid, r in self.router.replicas().items()},
            "size": len(self.router),
            "min": self.min_replicas,
            "max": self.max_replicas,
            "burn": burn,
            "respawns": respawns,
            "events": events[-50:],
            "ring_members": self.router.ring.members(),
        }

    @staticmethod
    def _replica_info(replica, fails: int) -> dict:
        """A member's kind and failure count; a process replica's URL and
        pid too (what an operator needs to reach or signal it)."""
        info = {"kind": getattr(replica, "kind", "?"), "consecutive_failures": fails}
        if getattr(replica, "base_url", None):
            info["url"] = replica.base_url
        proc = getattr(replica, "proc", None)
        if proc is not None:
            info["pid"] = proc.pid
        return info

    def run_in_thread(self) -> "FleetManager":
        if self._thread is not None:
            return self
        self._stop_evt.clear()

        def loop() -> None:
            while not self._stop_evt.wait(self.health_interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 - a failed sweep must not end supervision
                    continue

        self._thread = threading.Thread(target=loop, name="fleet-supervisor", daemon=True)
        self._thread.start()
        return self
