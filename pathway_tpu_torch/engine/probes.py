"""The port's prefix-cache ledger, speculative-decode ledger and
pipeline-stage timer (the prefix, spec and stage parts of
``pathway_tpu/engine/probes.py``).

Process-wide counters behind one lock, as in the JAX package: the prefix
cache (``engine/prefix_cache.py``) and the serving loop account hit and
miss tokens, inserted, evicted, demoted and promoted blocks, and the
arena's resident bytes; the serving loop accounts drafted, accepted and
emitted spec tokens and the int8 pool's saved KV bytes; ``record_stage``
accumulates host seconds per pipeline stage (the tier-2 export and h2d
copies). Recording is always on: the port reads no environment variable.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_prefix: dict[str, float] = {}
_cached_bytes: float | None = None  # gauge; None until first recorded
_spec: dict[str, float] = {}
_stage_seconds: dict[str, float] = {}
_stage_items: dict[str, float] = {}


def record_prefix(kind: str, n: float = 1) -> None:
    """Account ``n`` of ``kind`` (``hit_tokens`` / ``miss_tokens`` /
    ``requests`` / ``hit_requests`` / ``inserted_blocks`` /
    ``evicted_blocks`` / ``copy_bytes`` / ``cached_bytes`` / the tier-2
    kinds). ``cached_bytes`` is a running delta, negative on eviction, kept
    as a gauge. ``copy_bytes`` counts device bytes duplicated to serve a
    hit (the dense pool's arena-to-slot copies; paged hits share blocks and
    leave it at zero). Thread-safe."""
    global _cached_bytes
    with _lock:
        if kind == "cached_bytes":
            _cached_bytes = (_cached_bytes or 0.0) + n
        else:
            _prefix[kind] = _prefix.get(kind, 0.0) + n


def prefix_stats() -> dict:
    """Snapshot: raw counters plus the token-level ``hit_rate`` (hit tokens
    over hit + miss tokens; 0.0 before any prompt), ``prefill_tokens_saved``
    (the hit tokens) and the tier-2 lookups, hits and ``hit_rate_t2``."""
    with _lock:
        c = dict(_prefix)
        if _cached_bytes is not None:
            c["cached_bytes"] = _cached_bytes
    hit = c.get("hit_tokens", 0)
    miss = c.get("miss_tokens", 0)
    total = hit + miss
    t2_l = c.get("t2_lookups", 0)
    t2_h = c.get("t2_hits", 0)
    return {
        "counts": {k: (int(v) if float(v).is_integer() else v)
                   for k, v in c.items()},
        "hit_rate": round(hit / total, 4) if total else 0.0,
        "prefill_tokens_saved": int(hit),
        "evicted_blocks": int(c.get("evicted_blocks", 0)),
        "cached_bytes": int(c.get("cached_bytes", 0)),
        "copy_bytes": int(c.get("copy_bytes", 0)),
        "hit_rate_t2": round(t2_h / t2_l, 4) if t2_l else 0.0,
        "t2_lookups": int(t2_l),
        "t2_hits": int(t2_h),
        "t2_hit_blocks": int(c.get("t2_hit_blocks", 0)),
        "t2_demoted_blocks": int(c.get("t2_demoted_blocks", 0)),
        "t2_promoted_blocks": int(c.get("t2_promoted_blocks", 0)),
    }


def reset_prefix_stats() -> None:
    global _cached_bytes
    with _lock:
        _prefix.clear()
        _cached_bytes = None


def record_spec(kind: str, n: float = 1) -> None:
    """Account ``n`` of ``kind`` (``drafted`` / ``accepted`` / ``emitted``
    / ``verify_steps`` / ``draft_steps`` / ``dispatches`` /
    ``kv_bytes_saved``). ``verify_steps`` counts full-model lane-cycles
    (the unit one plain decode lane-step also costs), ``emitted`` every
    token produced (accepted drafts plus one certain token a lane-cycle).
    Thread-safe."""
    record_spec_many(**{kind: n})


def record_spec_many(**counts: float) -> None:
    """:func:`record_spec` for several kinds under one lock acquisition
    (the serving loop flushes a drain's six counters at once)."""
    with _lock:
        for kind, n in counts.items():
            _spec[kind] = _spec.get(kind, 0.0) + n


def spec_stats() -> dict:
    """Snapshot: raw counters plus ``acceptance_rate`` (accepted / drafted;
    0.0 before any draft ran), ``tokens_per_dispatch`` (emitted /
    verify_steps; 1.0 is the plain-decode baseline, 0.0 before any verify)
    and ``kv_bytes_saved``."""
    with _lock:
        c = dict(_spec)
    drafted = c.get("drafted", 0)
    verify = c.get("verify_steps", 0)
    return {
        "counts": {k: int(v) for k, v in c.items()},
        "acceptance_rate": round(c.get("accepted", 0) / drafted, 4) if drafted else 0.0,
        "tokens_per_dispatch": round(c.get("emitted", 0) / verify, 4) if verify else 0.0,
        "kv_bytes_saved": int(c.get("kv_bytes_saved", 0)),
    }


def reset_spec_stats() -> None:
    with _lock:
        _spec.clear()


def record_stage(stage: str, seconds: float, items: int = 1) -> None:
    """Accumulate ``seconds`` of host time and ``items`` for pipeline
    ``stage``. Thread-safe: stage workers call it."""
    with _lock:
        _stage_seconds[stage] = _stage_seconds.get(stage, 0.0) + seconds
        _stage_items[stage] = _stage_items.get(stage, 0.0) + items


def stage_seconds() -> dict[str, float]:
    with _lock:
        return dict(_stage_seconds)


def stage_items() -> dict[str, float]:
    with _lock:
        return dict(_stage_items)


def reset_stage_seconds() -> None:
    with _lock:
        _stage_seconds.clear()
        _stage_items.clear()
