#!/usr/bin/env python3
"""What the port's telemetry (metrics on, the default) costs the serving
loop and the ingest pipeline, on one GPU.

Decoder: ``chip_smoke.py`` phase 6's server (GPT-2 small at full width,
bf16, seeded random weights, int8 weights through the wq kernel, a paged
pool with the paged decode kernel and flash chunked prefill, spec decode
and autotune off) serves phase 6's 48 requests ``--rounds`` times per arm,
metrics on and off in turns (on, off, off, on, ...), the prefix tree
dropped between runs. Ingest: phase 8's defaults seam (MiniLM-L6, 32,768
docs in batches of 4,096), a fresh seam per run, in the same turns. Then
one more metrics-on run of each with every telemetry call timed on the
host (the span methods, the registry writes and the server's gauge,
fragmentation and attention-ledger helpers; nested calls counted once), so
the telemetry's own host seconds stand beside the run's wall.

Prints one line per run, a summary per path (median and quartiles of each
arm, the pairs the on arm won, telemetry host ms per run and per decode
chunk) and the card's name and power limit, and writes the same as JSON to
``--out``. Run from the repository root:

    python3 tools/telemetry_cost.py [--rounds 4] [--out build/telemetry_cost.json]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class HostTimer:
    """Host seconds spent inside the wrapped telemetry functions, across
    threads; a call made from inside another timed call is not counted
    again."""

    def __init__(self):
        self.seconds = 0.0
        self.calls = 0
        self._lock = threading.Lock()
        self._depth = threading.local()
        self._undo: list = []

    def wrap(self, owner, name: str) -> None:
        fn = getattr(owner, name)
        timer = self

        @functools.wraps(fn)
        def timed(*a, **k):
            depth = getattr(timer._depth, "n", 0)
            timer._depth.n = depth + 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                timer._depth.n = depth
                if depth == 0:
                    dt = time.perf_counter() - t0
                    with timer._lock:
                        timer.seconds += dt
                        timer.calls += 1

        setattr(owner, name, timed)
        self._undo.append((owner, name, fn))

    def undo(self) -> None:
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)
        self._undo.clear()


def telemetry_timer() -> HostTimer:
    from pathway_tpu_torch.engine import probes, tracing
    from pathway_tpu_torch.models import embedder as E
    from pathway_tpu_torch.xpacks.llm import llms as L

    t = HostTimer()
    for name in ("event", "finish"):
        t.wrap(tracing.Span, name)
    for name in ("counter_add", "counter_add_many", "gauge_set", "gauge_add",
                 "gauge_max", "observe"):
        t.wrap(probes.MetricsRegistry, name)
    t.wrap(tracing, "start_span")
    for name in ("_update_fragmentation", "_publish_occupancy", "_record_attn"):
        t.wrap(L._ContinuousServer, name)
    t.wrap(E, "_record_encoder_attn")
    return t


def quartiles(xs: list) -> list:
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return [round(v, 3) for v in q]


def summary(runs: list, key: str) -> dict:
    on = [r[key] for r in runs if r["metrics"]]
    off = [r[key] for r in runs if not r["metrics"]]
    # the runs come in pairs of one on and one off, in alternating order
    pairs = [(runs[i], runs[i + 1]) for i in range(0, len(runs) - 1, 2)]
    won = sum(1 for a, b in pairs
              if (a if a["metrics"] else b)[key] > (b if a["metrics"] else a)[key])
    return {"on_median": statistics.median(on), "off_median": statistics.median(off),
            "on_quartiles": quartiles(on), "off_quartiles": quartiles(off),
            "on_over_off": statistics.median(on) / statistics.median(off),
            "pairs_on_higher": won, "pairs": len(pairs)}


def run_decoder(C, dev, rounds: int) -> dict:
    from pathway_tpu_torch import DecoderChat
    from pathway_tpu_torch.engine import probes, tracing

    _, _, common = C.decoder_setup(dev)
    chat = DecoderChat(paged_kv=True, paged_kv_block=C.BLOCK, paged_kernel=True,
                       flash_prefill=True, **common)
    srv = chat.server
    C.serve(chat, C.make_prompts(4, 16, 200, seed=99))  # warm-up
    srv.prefix_reset()
    prompts = C.make_prompts(C.N_REQUESTS, 16, 480, seed=1)

    def one(on: bool, timer: HostTimer | None = None) -> dict:
        probes.set_metrics(on)
        probes.REGISTRY.reset()
        tracing.reset_traces()
        chunks0 = srv.stats["chunks"]
        try:
            out = C.serve(chat, prompts)
        finally:
            probes.set_metrics(True)
        srv.prefix_reset()
        r = {"metrics": on, "tok_per_s": out["tok_per_s"], "wall_s": out["wall_s"],
             "ttft_p50_ms": out["ttft_p50_s"] * 1e3, "chunks": srv.stats["chunks"] - chunks0}
        if timer is not None:
            r.update(telemetry_ms=timer.seconds * 1e3, telemetry_calls=timer.calls)
        return r

    runs = []
    for i in range(rounds):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            runs.append(one(on))
            C.info(f"decoder run {len(runs)}: {runs[-1]}")
    timer = telemetry_timer()
    try:
        timed = one(True, timer)
    finally:
        timer.undo()
    chat.close()
    timed["telemetry_ms_per_chunk"] = timed["telemetry_ms"] / max(timed["chunks"], 1)
    timed["telemetry_share_of_wall"] = timed["telemetry_ms"] / (timed["wall_s"] * 1e3)
    C.info(f"decoder timed run (metrics on): {timed}")
    return {"runs": runs, "tok_per_s": summary(runs, "tok_per_s"),
            "ttft_p50_ms": summary(runs, "ttft_p50_ms"), "timed": timed}


def run_ingest(C, dev, rounds: int) -> dict:
    from pathway_tpu_torch.engine import probes

    docs, _ = C.corpus()
    warm = [d + " warm" for d in docs[:C.INGEST_BATCH]]

    def one(on: bool, timer: HostTimer | None = None) -> dict:
        probes.set_metrics(on)
        try:
            emb = C.seam(dev)
            emb.resolve_batch([emb.submit_batch(warm)], timeout=600)
            if timer is not None:
                timer.seconds, timer.calls = 0.0, 0
            out = C.ingest(emb, docs)
            emb.close()
        finally:
            probes.set_metrics(True)
        r = {"metrics": on, "docs_per_s": out["docs_per_s"], "wall_s": out["wall_s"]}
        if timer is not None:
            r.update(telemetry_ms=timer.seconds * 1e3, telemetry_calls=timer.calls,
                     telemetry_share_of_wall=timer.seconds / out["wall_s"])
        return r

    runs = []
    for i in range(rounds):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            runs.append(one(on))
            C.info(f"ingest run {len(runs)}: {runs[-1]}")
    timer = telemetry_timer()
    try:
        timed = one(True, timer)
    finally:
        timer.undo()
    C.info(f"ingest timed run (metrics on): {timed}")
    return {"runs": runs, "docs_per_s": summary(runs, "docs_per_s"), "timed": timed}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default="build/telemetry_cost.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("telemetry_cost: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from pathway_tpu_torch import kernels, native

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(1) as pool:
        tok_build = pool.submit(native.build)
        kernels.build()
        tok_build.result()
    dev = torch.device("cuda", 0)
    result = {"gpu": gpu, "decoder": run_decoder(C, dev, args.rounds),
              "ingest": run_ingest(C, dev, args.rounds)}
    for path, keys in (("decoder", ("tok_per_s", "ttft_p50_ms")), ("ingest", ("docs_per_s",))):
        for k in keys:
            C.info(f"{path} {k} [{gpu}]: {result[path][k]}")
        C.info(f"{path} telemetry host time [{gpu}]: {result[path]['timed']}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(result, f, indent=1)
    print(gpu, flush=True)
    print(json.dumps({k: result[k] for k in ("gpu",)} | {
        p: {k: v for k, v in result[p].items() if k != "runs"} for p in ("decoder", "ingest")}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
