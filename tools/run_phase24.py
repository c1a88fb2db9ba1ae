#!/usr/bin/env python3
"""Run ``chip_smoke.py`` phase 24 (training on the card) alone, ``--reps``
times: the builds, then ``run_training`` with all its bars. Each rep
prints the phase's figures (the step ms, tokens/s and peak memory of the
contrastive and causal-LM steps, the sharded steps against the unsharded,
the answer gate's steps, wall, loss and accuracy, the spawned children's
shares, the launches) beside the card's name and power limit:

    python3 tools/run_phase24.py --reps 1
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

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("run_phase24: no CUDA device", file=sys.stderr)
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
    dev = torch.device("cuda", 0)
    for _ in range(args.reps):
        print("launches", C.run_training(dev, gpu, docs, queries), flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
