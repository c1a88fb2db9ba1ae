#!/usr/bin/env python3
"""Where the time goes on the port's main paths, on one GPU.

RAG path (``--path rag``): builds the same full-width pipeline as
``chip_smoke.py`` (MiniLM-L6, bf16, seeded random weights, 32,768 docs),
then traces ingest of one 4,096-doc batch of new texts, single-query
retrieve (k=10) and single-query retrieve + rerank (k=32).

Decoder path (``--path decoder``): GPT-2 small at full width, bf16, seeded
random weights, int8 weights through the wq kernel, a paged KV pool of 16
slots (blocks of 64, cache_len 704) filled with prompts of 256 tokens;
traces one decode chunk (16 steps over 16 active slots, paged decode
kernel) and one 64-token prefill piece at offset 192 (flash chunk kernel),
the serving loop's two device calls, without the loop's thread.

Retrieval variants (``--path variants``, ``chip_smoke.py`` phase 14's
settings): one 4,096-doc embed through the bf16 and the int8 MiniLM-L6;
IVF-Flat search of 64 queries over the 32,768 embeddings (64 cells, bf16
cells) at nprobe 8 and 64; one query (k=32) through the encoder cascade
and through the MaxSim cascade over the doc-token bank (doc_seq 96, dc 32).

Each phase is traced with ``torch.profiler``; the tool prints the host
wall time, the device busy time (sum of kernel times on the one stream),
the device idle share, and the kernels with the most device time. Run from
the repository root:

    python3 tools/profile_rag_path.py [--path rag|decoder|variants|all]
                                      [--out build/profile.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def traced(fn, reps: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + e.self_device_time_total
    busy_ms = sum(per_kernel.values()) / 1e3 / reps
    wall_ms = wall * 1e3 / reps
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "top_kernels_ms": [[k[:90], v / 1e3 / reps] for k, v in top],
        "reps": reps,
    }


def decoder_phases() -> dict:
    import numpy as np
    import torch

    import chip_smoke as C
    from pathway_tpu_torch.models import decoder as D

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(D.GPT2_SMALL, wq_kernel=True)
    params = D.quantize_params(D.map_params(
        lambda t: t.to(dev), D.init_params(torch.Generator().manual_seed(0), cfg)), cfg)
    B, M, P, n = C.N_SLOTS, C.CACHE_LEN // C.BLOCK, C.PIECE, 256
    pool = D.paged_pool_init(params, cfg, B, C.CACHE_LEN, B * M + 1, C.BLOCK)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 256, (1, n)).astype(np.int32)).to(dev)
    ones = torch.ones_like(ids)
    pos = torch.arange(n, dtype=torch.int32, device=dev)[None]

    def piece(slot, o, last=False):
        D.pool_prefill_chunk(params, ids[:, o:o + P], ones[:, o:o + P], pos[:, o:o + P],
                             pool, slot, o, n, cfg, first=o == 0, last=last, flash=True)

    for slot in range(B):
        D.paged_table_set(pool, slot, np.arange(1, M + 1, dtype=np.int32) + slot * M)
        for o in range(0, n, P):
            piece(slot, o, last=o + P >= n)
    active = torch.ones(B, dtype=torch.bool, device=dev)

    def chunk():
        D.pool_decode_chunk(params, pool, active, None, cfg, 16, paged_kernel=True)
        pool["write"].fill_(n)  # rewind the cursors: every rep decodes the same span
        pool["pos"].fill_(n)

    return {
        "decode_chunk_16_steps": traced(chunk, 3),
        "prefill_piece_64": traced(lambda: piece(0, 192), 10),
    }


def rag_phases() -> dict:
    import torch

    import chip_smoke as C
    from pathway_tpu_torch.models.transformer import MINILM_L6

    docs, queries = C.corpus()
    pipe = C.run_main_path(torch.device("cuda", 0), docs, queries, MINILM_L6)["pipe"]
    # every call adds texts never seen before (a warm-up and two traced
    # reps), so each batch tokenizes afresh instead of hitting the memo
    batches = iter([([f"x{i}_{j}" for j in range(C.INGEST_BATCH)],
                     [f"{d} extra{i}" for d in docs[: C.INGEST_BATCH]]) for i in range(3)])

    def ingest():
        pipe.add(*next(batches))

    return {
        "retrieve_k10": traced(lambda: pipe.retrieve([queries[0]], k=10), 10),
        "retrieve_rerank_k32": traced(lambda: pipe.retrieve_rerank(queries[1], k=32), 5),
        "ingest_batch_4096": traced(ingest, 2),  # last: it grows the corpus
    }


def variants_phases() -> dict:
    import numpy as np
    import torch

    import chip_smoke as C
    from pathway_tpu_torch import CrossEncoderModel, FusedRAGPipeline, SentenceEmbedderModel
    from pathway_tpu_torch.models.transformer import MINILM_L6
    from pathway_tpu_torch.ops.ivf import IvfFlatIndex

    dev = torch.device("cuda", 0)
    docs, queries = C.corpus()
    batch = docs[: C.INGEST_BATCH]
    emb = SentenceEmbedderModel(MINILM_L6, max_length=64, device=dev)
    q8 = SentenceEmbedderModel(MINILM_L6, max_length=64, device=dev, weight_quant="int8")
    out = {"embed_4096_bf16": traced(lambda: emb.embed_batch(batch), 3),
           "embed_4096_int8": traced(lambda: q8.embed_batch(batch), 3)}
    q8.close()
    vecs = np.concatenate([emb.embed_batch(docs[s : s + C.INGEST_BATCH])
                           for s in range(0, len(docs), C.INGEST_BATCH)])
    qv = emb.embed_batch(queries)
    ivf = IvfFlatIndex(MINILM_L6.hidden, device=dev)
    for s in range(0, len(docs), C.INGEST_BATCH):
        ivf.add(list(range(s, s + C.INGEST_BATCH)), vecs[s : s + C.INGEST_BATCH])
    for nprobe in (8, ivf.n_cells):
        ivf.nprobe = nprobe
        out[f"ivf_search_64q_nprobe{nprobe}"] = traced(lambda: ivf.search(qv, C.TOP_K), 5)
    del ivf
    ce = CrossEncoderModel(MINILM_L6, device=dev)
    pipe = FusedRAGPipeline(emb, ce, reserved_space=len(docs), doc_seq=C.LATE_SEQ,
                            pair_seq=160, late_interaction=True, late_dim=C.LATE_DC,
                            rerank_cascade=True)
    for s in range(0, len(docs), C.INGEST_BATCH):
        pipe.add([f"k{i}" for i in range(s, s + C.INGEST_BATCH)], docs[s : s + C.INGEST_BATCH])
    out["maxsim_cascade_k32"] = traced(lambda: pipe.retrieve_rerank(queries[0], C.RERANK_K), 5)
    pipe.late_interaction = False
    out["encoder_cascade_k32"] = traced(lambda: pipe.retrieve_rerank(queries[0], C.RERANK_K), 5)
    for holder in (pipe, emb, ce):
        holder.close()
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("rag", "decoder", "variants", "all"), default="all")
    ap.add_argument("--out", default="build/profile.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_rag_path: no CUDA device", file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    phases = {}
    if args.path in ("rag", "all"):
        phases.update(rag_phases())
    if args.path in ("decoder", "all"):
        phases.update(decoder_phases())
    if args.path in ("variants", "all"):
        phases.update(variants_phases())
    result = {"gpu": gpu, "torch": torch.__version__, "phases": phases}
    for name, ph in phases.items():
        print(f"{name} [{gpu}]: wall {ph['wall_ms']:.3f} ms, device busy "
              f"{ph['device_busy_ms']:.3f} ms, idle share {ph['device_idle_share']:.3f}")
        for k, v in ph["top_kernels_ms"]:
            print(f"    {v:9.4f} ms  {k}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
