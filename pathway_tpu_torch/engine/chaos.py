"""Deterministic, site-addressable fault injection for the serving stack
(counterpart of ``pathway_tpu/engine/chaos.py``).

The fault-tolerance layer (supervised serving loops, per-request
isolation, shedding) is only trustworthy if its failure paths run on
every test run, and faults from real hardware are neither deterministic
nor cheap. Named injection points ("sites") sit on the paths that talk to
the card; each armed site rolls a seeded per-site RNG and raises a typed
:class:`InjectedFault` at the configured rate. Tests read provenance off
the exception's ``site`` and ``seq``, and the seed makes a chaos trace
replayable: a (seed, site) pair faults on the same operation numbers here
and in the JAX package.

Sites in the port (grep for ``chaos.site(``):

* ``decode.admit``    — per-request admission work of the decode server
                        (request-scoped: supervision fails one request)
* ``decode.dispatch`` — the decode-chunk dispatch (loop-scoped:
                        supervision restarts the serving loop)
* ``embed.h2d``       — the ingest pipeline's host-to-device staging
* ``query.tick``      — one ``QueryServer`` tick's group dispatch
* ``router.forward``  — the fleet router's dispatch to a replica
                        (request-scoped: the router fails over to the
                        next candidate)
* ``replica.health``  — the fleet manager's health probe (probe-scoped:
                        enough faults in a row drain and respawn the
                        replica)

:func:`configure` takes the place of ``PATHWAY_TPU_CHAOS``,
``PATHWAY_TPU_CHAOS_SEED`` and ``PATHWAY_TPU_CHAOS_SITES``: a fault rate
in [0, 1] (default 0), the seed, and comma-separated site names or dotted
prefixes (empty arms every site). A holder builds its site once, at
construction, and :func:`site` returns ``None`` while the rate is 0, so
the off position costs the hot path one ``is not None`` check.
"""

from __future__ import annotations

import random
import threading
import zlib

_rate = 0.0
_seed = 0
_sites = ""


def configure(rate: float = 0.0, seed: int = 0, sites: str = "") -> None:
    """Set the fault rate, the seed and the armed sites for sites built
    from now on (the defaults are the JAX flag defaults: chaos off)."""
    global _rate, _seed, _sites
    _rate = float(rate)
    _seed = int(seed)
    _sites = str(sites)


class InjectedFault(RuntimeError):
    """A fault raised by an armed chaos site, never by real code, so
    tests and the error log can attribute it unambiguously."""

    def __init__(self, site: str, seq: int):
        super().__init__(f"injected fault at {site} (op #{seq})")
        self.site = site
        self.seq = seq


class ChaosSite:
    """One armed injection point: a per-site deterministic RNG and an
    operation counter, so the Nth pass through a site faults (or not)
    identically across runs with the same seed."""

    def __init__(self, name: str, rate: float, seed: int):
        self.name = name
        self.rate = float(rate)
        # hash() is randomized per process; crc32 keeps (seed, name) ->
        # schedule stable across processes, runs and the two packages
        self._rng = random.Random((int(seed) << 32) ^ zlib.crc32(name.encode()))
        self._lock = threading.Lock()
        self._seq = 0

    def maybe_fail(self) -> None:
        """Count one operation; raise :class:`InjectedFault` at the
        configured rate. Called BEFORE the guarded operation, so a fault
        never leaves device or host state torn."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            fault = self._rng.random() < self.rate
        if fault:
            raise InjectedFault(self.name, seq)


def _armed(name: str, sites_spec: str) -> bool:
    entries = [s.strip() for s in sites_spec.split(",") if s.strip()]
    if not entries:
        return True
    return any(name == e or name.startswith(e + ".") for e in entries)


def site(name: str) -> ChaosSite | None:
    """The injection point ``name`` under the current settings, or
    ``None`` when chaos is off or the site is filtered out."""
    if _rate <= 0.0 or not _armed(name, _sites):
        return None
    return ChaosSite(name, min(_rate, 1.0), _seed)
