#!/usr/bin/env python3
"""Time the decoder's kernels of the checkout in the current directory.

Runs ``chip_smoke.py``'s kernel functions (each kernel against its plain
version, then timed at its main-path shape: ``time_flash_attn`` at the
ingest shape, and the decoder's phase-5 kernels) from the ``chip_smoke``
and ``pathway_tpu_torch`` found in the working directory, and prints one
JSON line with the card's name and power limit. Running it from two
checkouts in one command compares two versions of the kernels on one card:

    (cd old && python3 /path/to/tools/time_kernels.py --tag old)
    python3 tools/time_kernels.py --tag new

``--only paged_attn_decode,flash_attn`` times a subset.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="")
    ap.add_argument("--only", default="",
                    help="comma-separated kernel names (default: all)")
    args = ap.parse_args()
    only = set(filter(None, args.only.split(",")))
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    def want(*names):
        return not only or bool(only & set(names))

    rows = {}
    if want("flash_attn"):
        from pathway_tpu_torch import HashTokenizer
        from pathway_tpu_torch.models.tokenizer import pad_to_buckets

        docs, _ = C.corpus()
        _, mask = pad_to_buckets(*HashTokenizer(max_length=64)(docs[:C.INGEST_BATCH]))
        rows["flash_attn"] = C.time_flash_attn(dev, torch.from_numpy(mask).to(dev))
    if want("paged_attn_decode"):
        rows["paged_attn_decode"] = C.check_paged_decode(dev)
    if want("flash_chunk_attn", "flash_chunk_attn_paged"):
        rows["flash_chunk_attn"], rows["flash_chunk_attn_paged"] = C.check_flash_chunk(dev)
    if want("wq_matmul"):
        rows["wq_matmul"] = C.check_wq_matmul(dev)
    keep = ("ms", "ms_l2_cold", "ms_m64", "split_ms", "library_ms", "plain_ms", "bound_ms",
            "max_abs_err")
    print(json.dumps({"tag": args.tag, "gpu": gpu, "cwd": os.getcwd(),
                      "kernels": {n: {k: r[k] for k in keep if k in r} for n, r in rows.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
