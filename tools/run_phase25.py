#!/usr/bin/env python3
"""Run ``chip_smoke.py`` phase 25 alone: the builds, phase 4's MiniLM-L6
(bf16, seed 0, without its ingest) and phase 6's GPT-2 small params, then
``run_tuning_airbyte`` with all its bars: (a) the autotuner over
``shared_prefix_chat`` with its trials serving on the card, (b)
``retraction_heavy_ingest``, (c) an Airbyte source through ``pw.sql`` and a
row transformer into the embed UDF. With ``--phase11-bursts N`` it first
runs phase 11 (a)-(b) and (e) (telemetry on the card, the occupancy gauge
against ``server.occupancy()``) with bursts of N requests. Prints the
card's name and power limit first:

    python3 tools/run_phase25.py --phase11-bursts 24
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    import chip_smoke as C
    from pathway_tpu_torch import SentenceEmbedderModel, kernels, native
    from pathway_tpu_torch.models.transformer import MINILM_L6

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--phase11-bursts", type=int, default=0,
                    help="run phase 11 (a) first with bursts of this many requests (0: skip)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("run_phase25: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    gpu = C.gpu_line()
    print(gpu, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py's main
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(native.build), pool.submit(native.build, native._ENGINE_SRC)]
        kernels.build()
        for b in builds:
            b.result()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    docs, queries = C.corpus()
    params, _, common = C.decoder_setup(dev)
    if args.phase11_bursts:
        C.N_REQUESTS = args.phase11_bursts
        print("phase 11 launches", C.run_telemetry_serving(dev, gpu, common), flush=True)
    out = {"emb": SentenceEmbedderModel(MINILM_L6, max_length=64, device=dev)}
    for _ in range(args.reps):
        tuned, launches = C.run_tuning_airbyte(dev, gpu, params, out, docs, queries)
        print("launches", tuned, "flash_attn (b)+(c)", launches, flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
