#!/usr/bin/env python3
"""Run ``chip_smoke.py`` phase 23 alone on the card, ``--reps`` times: the
builds, phase 4's MiniLM-L6 (bf16, seeded random weights), then
``run_cdc_share`` with all its bars. Each rep prints the phase's figures
(A's rows/s, the handoff, compactions, B's import wall and query
latencies, recall, the ``flash_attn`` launches) beside the card's name and
power limit:

    python3 tools/run_phase23.py --reps 2
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("run_phase23: no CUDA device", file=sys.stderr)
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
    docs, queries = C.corpus()
    model = SentenceEmbedderModel(MINILM_L6, max_length=64, device=torch.device("cuda", 0))
    for _ in range(args.reps):
        print("launches", C.run_cdc_share(gpu, {"emb": model}, docs, queries), flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
