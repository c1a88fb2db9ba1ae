#!/usr/bin/env python3
"""Run ``chip_smoke.py`` phase 26 alone: the builds, phase 4's main path
(MiniLM-L6, bf16, seed 0: its model and its pipeline over the 32,768-doc
corpus) and phase 6's GPT-2 small settings, then
``run_sanitizer_demo_slides`` with all its bars: (a) serving and retrieves
under the lock sanitizer against a sanitizer-off arm, (b) ``pw.demo``'s
replayed CSV into the index with the OpenTelemetry exporter on, (c) slides
through ``SlideParser`` and ``OpenAIChat`` into a ``DocumentStore``. Prints
the card's name and power limit first:

    python3 tools/run_phase26.py
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
    from pathway_tpu_torch import kernels, native
    from pathway_tpu_torch.models.transformer import MINILM_L6

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("run_phase26: no CUDA device", file=sys.stderr)
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
    C.run_main_path(dev, docs[:512], queries[:16], MINILM_L6, batch=256, rerank_k=8,
                    n_lat=2)
    out = C.run_main_path(dev, docs, queries, MINILM_L6)
    _, _, common = C.decoder_setup(dev)
    print(f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    for _ in range(args.reps):
        print("launches", C.run_sanitizer_demo_slides(gpu, common, out, docs, queries),
              flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
