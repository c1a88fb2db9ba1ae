#!/usr/bin/env python3
"""Write the vectors of ``chip_smoke.py`` phase 14 (b)'s HNSW arm to an
``.npz``: the first 4,096 corpus embeddings and the 64 query embeddings of
a full-width MiniLM-L6 (bf16, seeded random weights, bench.py's config2
corpus, seed 7), f32, as the phase hands them to ``HnswIndex``.

HNSW is host numpy, so its recall on these vectors can then be read on any
machine, beside the JAX package's index over the same vectors:

    python3 tools/ann_vectors.py --out chiprun_out/ann_vectors.npz   # on the card
    JAX_PLATFORMS=cpu python3 -m tests.test_torch_hnsw chiprun_out/ann_vectors.npz
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    import chip_smoke as C
    from pathway_tpu_torch import SentenceEmbedderModel
    from pathway_tpu_torch.models.transformer import MINILM_L6

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/ann_vectors.npz")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ann_vectors: no CUDA device", file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    docs, queries = C.corpus()
    emb = SentenceEmbedderModel(MINILM_L6, max_length=64, device=torch.device("cuda", 0))
    vecs = np.concatenate([emb.embed_batch(docs[s : s + C.INGEST_BATCH])
                           for s in range(0, C.HNSW_DOCS, C.INGEST_BATCH)])
    qv = emb.embed_batch(queries)
    emb.close()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(args.out, docs=vecs[: C.HNSW_DOCS].astype(np.float32),
             queries=qv.astype(np.float32), gpu=np.array(gpu))
    print(f"ann_vectors [{gpu}]: {C.HNSW_DOCS} docs and {len(queries)} queries of width "
          f"{vecs.shape[1]} -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
