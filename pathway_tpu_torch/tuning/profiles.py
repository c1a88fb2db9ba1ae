"""Workload profiles for the autotuner (counterpart of
``pathway_tpu/tuning/profiles.py``).

A :class:`WorkloadProfile` is a seeded trace shape plus the slice of the
knob table worth searching for it and the SLO objectives a winning config
must hold. ``run_trial`` plays one profile against the real serving or
ingest stack in-process (a continuous ``DecoderChat`` or a pipelined
``SentenceEmbedderModel``) and scores it off the metrics registry: tok/s,
TTFT / e2e p95, occupancy, prefix hit rate, shed and restart counts.

JAX applies a trial's flags through ``flag_overrides``; the port turns
them into constructor arguments through the knob table
(``internals/config.py`` ``knob_arguments``). The chaos and SLO settings
are module-wide in the port (``engine/chaos.py`` and ``engine/slo.py``
``configure``), so a trial sets them before it builds its chat and
restores the previous settings when it ends, whatever happens.

Trials are deterministic given ``(profile, scale, seed)``: arrivals and
prompt tails come from a profile-keyed ``np.random.default_rng`` (equal
to JAX's bit for bit), and decoding is greedy. Entry points run on the
card unless given ``device="cpu"``.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field

import numpy as np

from pathway_tpu_torch.internals.config import knob_arguments

_REQ_TIMEOUT_S = 120.0


class _CharTok:
    """1-token-per-char toy tokenizer (the bench serving traces' shape):
    keeps trial prompts byte-countable and vocab tiny."""

    eos_id = None  # budget-bounded: every request costs max_new tokens

    def encode(self, text):
        return [(ord(c) % 96) + 1 for c in text]

    def decode(self, ids):
        return "".join(chr((int(i) % 96) + 32) for i in ids)


@dataclass(frozen=True)
class WorkloadProfile:
    """One named trace shape + its searchable flag slice.

    ``headline``/``direction`` name the metric a trial is ranked by
    (``"max"`` throughput-like, ``"min"`` latency-like). ``tunables``
    are the JAX flag names the tuner may vary — each must carry a
    ``Tunable`` spec in the knob table. ``base_flags`` pin the scenario
    itself (e.g. the tenant scheduler ON for the burst profile) and apply
    to every arm, including the all-defaults baseline. ``slo`` arms the
    watchdog objectives for the validation leg; ``chaos_sites`` names the
    sites the chaos drill arms (empty = no serving fault surface, skip the
    drill)."""

    name: str
    doc: str
    headline: str
    direction: str  # "max" | "min"
    tunables: tuple[str, ...]
    base_flags: dict = field(default_factory=dict)
    slo: dict = field(default_factory=dict)
    # the drill arms the request-scoped admission site only: dispatch
    # faults kill the whole serving loop and burn the restart budget,
    # which is a fleet-level recovery story, not a per-config one
    chaos_sites: str = "decode.admit"
    kind: str = "serving"  # "serving" | "ingest"
    # trace shape (serving)
    nreq: int = 24
    max_new: int = 12
    n_slots: int = 4
    chunk_steps: int = 4
    lam: float = 40.0  # Poisson arrival rate, requests/s
    head_len: int = 48
    tail_len: int = 8
    prompt_cap: int = 64
    burst: int = 0  # >0: arrivals come in back-to-back bursts this size
    tenants: tuple[str, ...] = ()
    # trace shape (ingest)
    rows: int = 96
    dup_rate: float = 0.5


PROFILES: dict[str, WorkloadProfile] = {
    p.name: p
    for p in [
        WorkloadProfile(
            name="long_doc_rag",
            doc="Long-document RAG: distinct ~88-token prompts, short "
                "answers — admission cost dominates, so chunked-prefill "
                "shape and the disagg prefill lane set the TTFT tail.",
            headline="ttft_p95_ms", direction="min",
            tunables=(
                "PATHWAY_TPU_PREFILL_CHUNK",
                "PATHWAY_TPU_CHUNKED_PREFILL",
                "PATHWAY_TPU_PREFILL_OVERLAP",
                "PATHWAY_TPU_DISAGG",
                "PATHWAY_TPU_DISAGG_PREFILL_BUDGET",
            ),
            slo={"PATHWAY_TPU_SLO_E2E_P95_MS": "30000"},
            nreq=20, max_new=8, n_slots=4, chunk_steps=4, lam=30.0,
            head_len=80, tail_len=8, prompt_cap=96,
        ),
        WorkloadProfile(
            name="shared_prefix_chat",
            doc="Chat/RAG serving with a shared system-prompt head and "
                "short distinct tails — the prefix KV cache, speculative "
                "depth and admission batching set steady-state tok/s.",
            headline="tok_s", direction="max",
            tunables=(
                "PATHWAY_TPU_PREFIX_CACHE",
                "PATHWAY_TPU_PREFIX_CACHE_MB",
                "PATHWAY_TPU_PREFIX_BLOCK",
                "PATHWAY_TPU_SPEC_DECODE",
                "PATHWAY_TPU_SPEC_DECODE_K",
                "PATHWAY_TPU_CHUNK_AUTOTUNE",
                "PATHWAY_TPU_BATCH_ADMIT",
            ),
            slo={"PATHWAY_TPU_SLO_E2E_P95_MS": "30000"},
            nreq=24, max_new=16, n_slots=4, chunk_steps=4, lam=40.0,
            head_len=48, tail_len=8, prompt_cap=64,
        ),
        WorkloadProfile(
            name="multi_tenant_burst",
            doc="Two tenants (prod:batch at 3:1 weight), arrivals in "
                "back-to-back bursts — fairness budgets and refill "
                "policy set the end-to-end tail.",
            headline="e2e_p95_ms", direction="min",
            tunables=(
                "PATHWAY_TPU_TENANT_BUDGET",
                "PATHWAY_TPU_EAGER_REFILL",
                "PATHWAY_TPU_BATCH_ADMIT",
                "PATHWAY_TPU_SPEC_DECODE",
            ),
            base_flags={
                "PATHWAY_TPU_TENANT_SCHED": "1",
                "PATHWAY_TPU_TENANT_WEIGHTS": "prod:3,batch:1",
            },
            slo={"PATHWAY_TPU_SLO_E2E_P95_MS": "30000"},
            nreq=24, max_new=12, n_slots=4, chunk_steps=4, lam=60.0,
            head_len=40, tail_len=8, prompt_cap=64, burst=6,
            tenants=("prod", "prod", "prod", "batch"),
        ),
        WorkloadProfile(
            name="retraction_heavy_ingest",
            doc="Churny ingest: half the rows are re-ingested duplicates "
                "of earlier ones — pipeline depth and queue bound set "
                "rows/s through the tokenize→h2d→dispatch stages.",
            headline="rows_per_s", direction="max",
            tunables=(
                "PATHWAY_TPU_PIPELINE_DEPTH",
                "PATHWAY_TPU_PIPELINE_QUEUE",
            ),
            chaos_sites="", kind="ingest",
            rows=96, dup_rate=0.5,
        ),
        WorkloadProfile(
            name="smoke",
            doc="Seconds-scale CI profile (`cli tune smoke --smoke`): a "
                "tiny shared-head trace over one axis, just enough to "
                "keep the search/validate/persist path from rotting.",
            headline="tok_s", direction="max",
            tunables=("PATHWAY_TPU_PREFILL_CHUNK",),
            nreq=6, max_new=8, n_slots=4, chunk_steps=4, lam=50.0,
            head_len=24, tail_len=8, prompt_cap=48,
        ),
    ]
}


def get_profile(profile) -> WorkloadProfile:
    if isinstance(profile, WorkloadProfile):
        return profile
    try:
        return PROFILES[str(profile)]
    except KeyError:
        raise KeyError(
            f"unknown workload profile {profile!r}; "
            f"available: {sorted(PROFILES)}"
        ) from None


# --------------------------------------------------------------------- #
# shared trial resources (built once per process and device — trials vary
# knobs, so the decoder weights are shared across every candidate)

_DECODER_RES: dict = {}


def decoder_resources(device=None):
    """(params, cfg, tokenizer) for the serving profiles: a tiny decoder
    (vocab 128, hidden 32, 4 layers, 4 heads, f32), shared process-wide,
    on ``device`` (the card by default). JAX draws it with ``PRNGKey(0)``,
    which torch cannot reproduce: this one comes from a seeded
    ``torch.Generator``. ``run_trial(..., resources=)`` substitutes a
    checkpoint."""
    import torch

    from pathway_tpu_torch.device import resolve_device
    from pathway_tpu_torch.models import decoder as D

    dev = resolve_device(device)
    if str(dev) not in _DECODER_RES:
        cfg = D.DecoderConfig(
            vocab_size=128, hidden=32, layers=4, heads=4, intermediate=64,
            max_position=256, dtype=torch.float32,
        )
        params = D.init_params(torch.Generator().manual_seed(0), cfg)
        params = D.map_params(lambda t: t.to(dev), params)
        _DECODER_RES[str(dev)] = (params, cfg, _CharTok())
    return _DECODER_RES[str(dev)]


def _profile_rng(profile: WorkloadProfile, seed: int) -> np.random.Generator:
    return np.random.default_rng(
        (zlib.crc32(profile.name.encode()) << 8) ^ (int(seed) & 0xFFFFFFFF)
    )


def _prompts(profile: WorkloadProfile, nreq: int, rng) -> list[str]:
    if profile.head_len >= 40:
        head = "c" * (profile.head_len - 8) + "ontext: "
    else:
        head = "c" * profile.head_len
    out = []
    for k in range(nreq):
        tail = f"q{k:02d}" + "".join(
            chr(97 + int(c)) for c in rng.integers(0, 26, profile.tail_len)
        )
        out.append(head + tail[:profile.tail_len].ljust(profile.tail_len, "x"))
    return out


def _arrivals(profile: WorkloadProfile, nreq: int, rng) -> np.ndarray:
    gaps = rng.exponential(1.0 / profile.lam, nreq)
    if profile.burst > 0:
        # burst arrivals: every request inside a burst lands with its
        # burst head; the exponential gap survives only between bursts
        for k in range(nreq):
            if k % profile.burst:
                gaps[k] = 0.0
    return np.cumsum(gaps)


def _percentile_ms(samples_s: list[float], q: float) -> float:
    if not samples_s:
        return 0.0
    return round(float(np.percentile(np.asarray(samples_s) * 1e3, q)), 2)


def _serving_trial(
    profile: WorkloadProfile, nreq: int, resources, seed: int,
    deadline_s: float | None, chat_args: dict, device,
) -> dict:
    from pathway_tpu_torch.engine import probes
    from pathway_tpu_torch.xpacks.llm.llms import DecoderChat

    params, cfg, tok = resources
    rng = _profile_rng(profile, seed)
    prompts = _prompts(profile, nreq, rng)
    arrivals = _arrivals(profile, nreq, rng)
    t_start = time.perf_counter()
    chat = DecoderChat(
        params=params, cfg=cfg, tokenizer=tok,
        max_new_tokens=profile.max_new, temperature=0.0,
        max_prompt_tokens=profile.prompt_cap, continuous=True,
        n_slots=profile.n_slots, chunk_steps=profile.chunk_steps,
        device=device, **chat_args,
    )
    aborted = False
    latched = False
    try:
        # warm the kernels and the allocator outside the timed window
        for r in chat.submit_batch([prompts[0]]):
            r.done.wait(timeout=_REQ_TIMEOUT_S)
        probes.reset_prefix_stats()
        probes.reset_latency_metrics()
        t0 = time.perf_counter()
        reqs = []
        for k in range(nreq):
            if deadline_s is not None and (
                time.perf_counter() - t_start
            ) > deadline_s:
                aborted = True  # obviously-bad trial: stop feeding it
                break
            now = time.perf_counter() - t0
            if arrivals[k] > now:
                time.sleep(arrivals[k] - now)
            kw = {}
            if profile.tenants:
                kw["tenant"] = profile.tenants[k % len(profile.tenants)]
            try:
                reqs.append(chat.submit_batch([prompts[k]], **kw)[0])
            except RuntimeError:
                # serving loop latched dead (e.g. chaos drill exhausted
                # the restart budget): a losing config, not a crash
                latched = True
                break
        ttft, e2e, tokens, failures, terminal_ok = [], [], 0, 0, not latched
        for k, r in enumerate(reqs):
            if not r.done.wait(timeout=_REQ_TIMEOUT_S):
                terminal_ok = False
                continue
            if r.text is None:
                failures += 1
                continue
            tokens += len(r.tokens)
            if r.first_token_at is not None:
                ttft.append(r.first_token_at - t0 - arrivals[k])
            e2e.append(time.perf_counter() - t0 - arrivals[k])
        wall = max(time.perf_counter() - t0, 1e-9)
        st = dict(chat._server.stats)
        lat = probes.latency_summary(phase="decode")
        ps = probes.prefix_stats()
        slot_steps = int(st.get("slot_steps_total", 0))
        steps = int(st.get("steps", 0))
        return {
            "profile": profile.name,
            "requests": len(reqs),
            "tok_s": round(tokens / wall, 2),
            "ttft_p95_ms": _percentile_ms(ttft, 95),
            "ttft_p50_ms": _percentile_ms(ttft, 50),
            "e2e_p95_ms": _percentile_ms(e2e, 95),
            "e2e_p50_ms": (
                (lat.get("e2e_seconds") or {}).get("p50_ms")
                or _percentile_ms(e2e, 50)
            ),
            # JAX's formula, the other way round from server.occupancy():
            # no profile ranks by it
            "occupancy": round(
                slot_steps / max(steps * profile.n_slots, 1), 4
            ),
            "prefix_hit_rate": ps.get("hit_rate", 0.0),
            "shed": int(st.get("shed", 0)),
            "restarts": int(st.get("restarts", 0)),
            "failures": failures,
            "terminal_ok": terminal_ok,
            "aborted": aborted,
            "wall_s": round(wall, 3),
        }
    finally:
        chat.close()


# the ingest profile's encoder: JAX's MINILM_L6 cut to 2 layers, hidden 32
_INGEST_CFG = dict(layers=2, hidden=32, heads=4, intermediate=64,
                   vocab_size=500, max_position=32)


def _ingest_trial(
    profile: WorkloadProfile, rows: int, seed: int,
    deadline_s: float | None, embed_args: dict, device,
) -> dict:
    import dataclasses

    from pathway_tpu_torch.models.embedder import SentenceEmbedderModel
    from pathway_tpu_torch.models.tokenizer import HashTokenizer
    from pathway_tpu_torch.models.transformer import MINILM_L6

    rng = _profile_rng(profile, seed)
    uniq = max(1, int(rows * (1.0 - profile.dup_rate)))
    texts = [
        "doc %03d " % k + "".join(
            chr(97 + int(c)) for c in rng.integers(0, 26, 24)
        )
        for k in range(uniq)
    ]
    # retraction-heavy stream: re-ingested duplicates interleave with
    # fresh rows, exactly the upsert/remove churn shape
    stream = [texts[int(rng.integers(0, uniq))] for _ in range(rows)]
    cfg = dataclasses.replace(MINILM_L6, **_INGEST_CFG)
    # JAX builds the default 30,522-id tokenizer over the 500-row table and
    # its gather clamps the ids; torch's raises, so the ids fit the table
    model = SentenceEmbedderModel(
        cfg=cfg, tokenizer=HashTokenizer(vocab_size=cfg.vocab_size, max_length=16),
        max_length=16, device=device, **embed_args)
    aborted = False
    t_start = time.perf_counter()
    try:
        # warm (the allocator, the kernel's first launch) outside the
        # timed window
        model.embed_batch(stream[:4])
        t0 = time.perf_counter()
        handles, done = [], 0
        batch = 8
        for i in range(0, len(stream), batch):
            if deadline_s is not None and (
                time.perf_counter() - t_start
            ) > deadline_s:
                aborted = True
                break
            handles.append(model.embed_submit(stream[i:i + batch]))
            done += len(stream[i:i + batch])
        outs = model.embed_resolve(handles)
        wall = max(time.perf_counter() - t0, 1e-9)
        n_rows = int(sum(o.shape[0] for o in outs))
        return {
            "profile": profile.name,
            "requests": done,
            "rows_per_s": round(n_rows / wall, 2),
            "tok_s": 0.0,
            "shed": 0,
            "restarts": 0,
            "failures": 0,
            "terminal_ok": n_rows == done,
            "aborted": aborted,
            "wall_s": round(wall, 3),
        }
    finally:
        model.close()


def run_trial(
    profile,
    flags: dict,
    *,
    scale: float = 1.0,
    seed: int = 0,
    deadline_s: float | None = None,
    resources=None,
    arm_slo: bool = False,
    device=None,
) -> dict:
    """Play one profile trace under ``flags`` and return its metrics.

    ``flags`` (JAX flag name → raw value), on top of the profile's
    ``base_flags``, become the arguments of what the trial builds (the
    chat or the embedder) and the chaos / SLO settings, which are set for
    the trial and restored after it. ``scale`` multiplies the request
    count (successive halving re-runs survivors at larger scales);
    ``deadline_s`` is the early-abort budget — a trial past it stops
    submitting and comes back with ``aborted=True`` (the search scores it
    -inf).

    ``arm_slo=True`` additionally resets the watchdog with the profile's
    ``slo`` objectives (which must be part of ``flags``), ticks it after
    the trace, and reports ``slo_alerting`` / ``slo_breaches`` — the
    validation leg."""
    from pathway_tpu_torch.engine import chaos, slo

    profile = get_profile(profile)
    merged = dict(profile.base_flags)
    merged.update(flags)
    args = knob_arguments(merged)
    prev_chaos, prev_slo = chaos.settings(), slo.settings()
    touch_slo = arm_slo or "slo" in args
    try:
        chaos.configure(**{**prev_chaos, **args.get("chaos", {})})
        if touch_slo:
            # configure() drops the watchdog, so the trial's is built
            # from these objectives
            slo.configure(**{**prev_slo, **args.get("slo", {})})
        if profile.kind == "ingest":
            rows = max(16, int(round(profile.rows * scale)))
            metrics = _ingest_trial(profile, rows, seed, deadline_s,
                                    args.get("SentenceEmbedderModel", {}), device)
        else:
            nreq = max(4, int(round(profile.nreq * scale)))
            metrics = _serving_trial(
                profile, nreq, resources or decoder_resources(device), seed,
                deadline_s, args.get("DecoderChat", {}), device,
            )
        if arm_slo:
            wd = slo.get_watchdog()
            wd.tick()
            state = wd.state()
            metrics["slo_alerting"] = list(state["alerting"])
            metrics["slo_breaches"] = int(state["breaches"])
        return metrics
    finally:
        chaos.configure(**prev_chaos)
        if touch_slo:
            slo.configure(**prev_slo)
