#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (pathway_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every kernel of the port from pathway_tpu_torch/csrc
   and the C++ tokenizers from pathway_tpu_torch/native, all at once;
3. kernel vs plain: ``flash_attn`` against ``flash_attn_reference`` on the
   card (ragged masks, an all-masked row, causal and not, f32 and bf16; and
   the decoder's case: head_dim 64, causal, left-padded), then timed at the
   ingest shape beside the plain version, one PyTorch library call and the
   card's bound;
4. RAG main path at full MiniLM-L6 width, bf16, seeded random weights:
   ingest 32,768 docs through FusedRAGPipeline, retrieve (recall@10
   against exact f32 scoring of the port's own f32 embeddings), single and
   batched retrieve + rerank; the attention launch count must show that
   every encode went through the kernel; a small input is checked against
   the same model run on the CPU;
5. the decoder's kernels against their plain versions on the card:
   ``paged_attn_decode`` (bf16 and int8 K/V, ragged masks, an empty slot,
   sentinel tails, shuffled physical blocks), ``flash_chunk_attn`` and
   ``flash_chunk_attn_paged`` (starts 0, 64 and 640, dead tiles, int8; the
   paged variant equal to the dense one on the gathered row), ``wq_matmul``
   (the four GPT-2 shapes, M in {1, 16, 64, 200}, an N no tile divides);
   each timed at its main-path shape beside its plain version, its bound
   and one PyTorch library call (``scaled_dot_product_attention`` on the
   gathered rows for the paged kernels); the chunk kernel's grid and the
   paged decode kernel's split plans side by side; ``wq_matmul`` also over 12 layers' distinct
   weights (past the L2 cache) and at a prefill piece's 64 rows, and
   whether ``torch._weight_int8pack_mm`` runs on the card (its time is the
   row's library call when it does);
6. the answer-LLM main path at full GPT-2-small width, bf16, seeded random
   weights, a byte-level tokenizer: ``DecoderChat(continuous=True)`` over a
   paged KV pool with the paged decode kernel, flash chunked prefill and
   int8 weights through the wq kernel serves 24 greedy requests; launch
   counts must show every decode step, prefill piece and layer product
   went through its kernel; 8 requests are held against the port's static
   ``generate``; then a short run with int8 K/V, a dense-pool run (whole-
   prompt admission through the causal ``flash_attn``), and an f32 check of
   a small input, card against CPU. The prefix cache is on, as its default;
   the random prompts share almost no block, so each run prints its stats;
7. shared-prompt serving through the prefix cache at the same width: the
   chunk and decode kernels over rows whose leading blocks are shared,
   against their plain versions; a paged pool serves a warm-up request and
   then 24 more at once behind one 256-token head (every one a hit of 4
   shared blocks, every suffix piece and decode step through its kernel),
   beside the same 49 prompts with the cache off; a dense pool's arena
   serves 16 requests behind a 128-token head; a paged tier 1 of 3 blocks
   with a 64 MB host tier demotes six 192-token heads and promotes the
   first back, beside the same trace without tier 2. Greedy streams must be
   equal token for token to the cache-off (or tier-2-off) arm;
8. ingest through the embedder seam (``SentenceTransformerEmbedder``) at
   the same MiniLM-L6 width and corpus: 8 ``submit_batch`` of 4,096 docs,
   then one ``resolve_batch``, in five arms: (a) serial (no pipeline,
   Python tokenize, no memo, no dedup), (b) the defaults, (c) the defaults
   with ``fused_h2d=False``, (d) (b)'s seam re-ingesting the corpus's last
   8,192 docs, which its default dedup LRU of 8,192 texts still holds, (e)
   a re-ingest of those docs with a seeded quarter rewritten. (b) and (c)
   must be byte-equal to (a), (d) all dedup hits with 0 ``flash_attn``
   launches and (b)'s vectors, (e) exactly the rewritten docs as misses,
   byte-equal to a serial embed of the same miss batches; every other
   encode goes through the kernel. Prints docs/s, stage ms per batch and
   host tokenize ms (Python, native, memo hit; ids equal over the corpus);
9. checkpoints written in a temporary directory and loaded on the card: a
   seeded MiniLM-L6 ``model.safetensors`` with a synthetic 30,522-token
   ``vocab.txt`` through ``load_encoder_checkpoint`` and
   ``WordPieceTokenizer`` (card vs CPU in f32; native WordPiece ids equal
   the Python ids over the corpus), and a seeded GPT-2-small
   ``pytorch_model.bin`` served by ``DecoderChat(checkpoint_path=...)``
   with phase 6's settings, held against the static path with phase 6's
   first-token bars;
10. self-speculative decode and chunk-steps autotune, the answer LLM's
   default decode schedule (phases 6, 7 and 9 pin both off, so their
   launch bars stay per decode step): (a) f32 at full GPT-2-small width, a
   dense pool of 16 slots with prompts of 16-480 tokens: ``pool_decode_spec``
   with the auto draft (3 layers, k = 3) and with a full-depth draft against
   ``pool_decode_chunk`` greedy, equal streams but where the plain run's
   top-2 logit gap is under 1e-4; (b) phase 6's 24 requests (bf16, int8
   weights through ``wq_matmul``, paged pool with the paged kernel) served
   with spec and autotune off, with the defaults, and with an 11-layer
   draft (autotune off): all first tokens equal to the spec-off arm, at
   least 3/8 of the streams equal, and ``wq_matmul`` launched for every
   draft step and verify layer; (c) spec off, autotune on against off over
   48 requests in 6 seeded waves of 8 (both branches of the step choice):
   streams equal token for token. Prints tokens/s, TTFT p50, acceptance,
   tokens per dispatch, the latch, spec dispatches and the histogram of
   chunk steps;
11. telemetry on the card (metrics are on by default, as in JAX, so
   phases 4-10 ran with them): (a) phase 6's 24-request burst on one
   server with metrics on, then off: streams equal token for token,
   no span and an empty registry when off, 24 complete ordered decode
   spans when on, the registry's TTFT histogram (32 observations, p50
   within one log-2 bucket of the requests' own), the occupancy gauge
   equal to ``occupancy()``, the fragmentation in [0, 1); decode tokens/s
   and TTFT p50 on against off; (b) the HBM ledger of that server: the
   weights' bytes, the pool components summing to ``pool_bytes``, the total
   within ``torch.cuda.memory_allocated``; (c) phase 8's defaults seam,
   fresh each run, on, then off: embeddings byte-identical, 8 embed
   spans with ordered events, ``embed_dispatch`` and the encoder's
   attention bytes per batch that reached the device, docs/s on against
   off; (d) one ``retrieve`` and one ``retrieve_rerank`` on phase 4's
   pipeline add one dispatch each and 8 dense retrieval queries; (e) the
   JSONL flight recorder holds a burst's 8 decode spans after ``close()``;
12. supervision and the query server (the JAX defaults: the degradation
   ladder on, chaos off, no restarts): (a) phase 6's burst with the
   defaults against ``degradation=False``, on, then off: streams equal
   24/24, tokens/s and TTFT p50 ratios; (b) ``decode`` chaos at rate 0.05
   (seed 0) with ``serve_restarts=8``, ``serve_retries=3``: the burst, and
   16 requests on a dense pool (whole-prompt causal ``flash_attn``
   admissions in distinct buckets, prefix cache off) in three rounds;
   every request terminal within a bound, every unfailed stream equal to
   its chaos-off stream, restarts counted by ``serve_restarts``,
   ``memory_allocated`` within one pool of chaos off, the HBM ledger's
   ``kv_blocks`` unchanged; (c) ``serve_queue=8`` under the burst (shed
   requests decode to ``shed:queue_full`` with ``retry_after``, counted by
   ``requests_shed``), then ``request_deadline_ms`` at half of (a)'s TTFT
   p50 (deadline sheds, no admission after a deadline); (d) the ladder
   stepped to 1, 2, 3 by an always-failing objective on an injected clock:
   ``max_new`` clamped, no spec dispatch at level 2, priority 0 shed at 3;
   (e) phase 8's defaults seam with ``embed.h2d`` chaos at 0.2, with and
   without retries: resolved batches byte-equal to chaos off, spent
   budgets raise ``InjectedFault`` at resolve as the site's schedule says;
   (f) ``QueryServer`` at its defaults under 128 Poisson queries (half
   retrieve k=10, half rerank k=32) from 8 threads at twice the per-call
   path's rate: keys equal the per-call path's but at near-ties, fewer
   dispatches than requests, latencies of both paths; the rerank cascade
   (depth 3, 28 of 32) with top-8 overlap >= 0.9 against the full rerank;
   ``query.tick`` chaos with ``serve_restarts=2``. Phase 12 drives all five
   kernel entry points;
13. the serving features JAX keeps off by default, at phase 6's settings:
   (a) phase 6's burst with ``disagg`` off, then on (budget 1):
   streams equal 24/24, ``kv_migrated_blocks`` the sum of the handed-off
   rows' block counts, ``lane_stats()`` back to zero; decode tokens/s, TTFT
   p50 and TPOT p99 from the request spans; (b) ``tenant_sched`` with one
   tenant and no budget (streams equal), then tenants ``a:3,b:1``, 12
   requests each at once, under a budget of 12 answers' tokens: every
   request terminal, streams equal to scheduling off, preemptions and an
   unpark onto the parked row, ``kv_parked_bytes`` 0, every block back in
   the allocator, the bytes held (requested of the allocator) equal to
   the scheduling-off server's, the a:b ratio of the first 16 admissions; a dense pool of 8
   slots under 16 requests (phase 12 (b)'s prompts) preempts with streams
   equal; (c) two ``InProcessReplica`` behind a ``FleetRouter`` at
   affinity 4: 24 requests behind 4 heads of 256 tokens (each head on one
   replica, every later request a prefix hit, streams equal a single
   server's), ``router.forward`` chaos at 0.2 (every request terminal,
   answered streams equal), one ``FleetManager.tick()`` under
   ``replica.health`` chaos (one drain, one respawn, 8/8 answered after),
   and ``memory_allocated`` back within one pool after the shutdown; the
   HBM ledger holds both replicas' pools and weights (twice one
   replica's), at most ``memory_allocated``, and drops them at shutdown;
14. the RAG retrieval variants at phase 4's settings (full MiniLM-L6, the
   32,768-doc corpus, 64 queries): (a) ``weight_quant="int8"`` encoders:
   phase 8's defaults seam without dedup, off / on / on / off (each arm's
   ingests byte-equal), the int8 marker and dtypes, per-row cosine int8 vs
   bf16 >= 0.99, recall@10 of the int8 corpus >= 0.9 against exact f32
   scoring, the HBM ledger holding both arms (the int8 arm's
   ``weights.embedder`` = int8 payloads + scales + the bf16 rest) and
   dropping them at ``close()``, one int8 ``CrossEncoderModel`` rerank at k=32 (top-8 overlap
   reported), docs/s on and off; (b) ``IvfFlatIndex`` at JAX's defaults
   (64 cells) over the corpus's embeddings, TF32 off: recall@10 against
   ``BruteForceKnnIndex`` at nprobe 8, 16, 64 (not falling; exhaustive
   probing equal but at near-ties), int8 cells, ``add_device`` equal to
   ``add``, 1,024 removed keys never returned, search ms beside brute
   force; ``HnswIndex`` (host numpy) over the first 1,024 docs (its Python
   inserts took ~57 s at 4,096): recall@10 against
   the f32 brute-force index at expansion_search 64 (the default,
   reported) and 128
   (>= 0.9), insert and search times; (c) ``FusedRAGPipeline(
   late_interaction=True, rerank_cascade=True)`` at doc_seq 96, dc 32:
   the ``late_bank`` gauge exactly live rows x 3,456 bytes; the full
   rerank, the encoder cascade and the MaxSim cascade over the 64 queries
   at k=32 (p50 ms, top-8 overlap, FLOPs a pair by stage; batched MaxSim
   equal to the per-query loop but at near-ties); 1,024 retractions lower
   the gauge by exactly their bytes; 512 docs added with the flag off
   backfill at one query; ``QueryServer`` over the MaxSim cascade equal to
   the per-call path but at near-ties; ``close()`` lets the bank go; (d) ``ListwiseLLMReranker`` over a
   phase-6 ``DecoderChat`` (GPT-2-small, int8 weights, paged, 32 new
   tokens, prompts up to 992 tokens, the largest window of 8, 6, 4 whose
   prompts fit whole) on 8 queries at k=16: every request terminal within
   a bound, spans of tenant ``rerank``, rows permutations of the
   cross-encoder's with the scores kept, ``llm_rerank`` pairs counted,
   replies that parsed reported. Phase 14's launches of ``flash_attn``
   ((a)'s int8 arms only, (c), (d)) and of the decoder's three kernels ((d)) must be
   positive;
15. the parallel layer and the serving mesh (``pathway_tpu_torch.parallel``;
   virtual mesh positions on the one card): (a) phase 6's server (bf16, int8
   weights, paged pool, the paged, chunk and wq kernels; spec and autotune
   pinned off as in phases 6-13) serves 16 requests with a 1x1x1 mesh and
   without, on / off / off / on: streams equal token for token; (b) tensor-parallel serving at
   the JAX bench's full mesh config (f32, vocab 256, hidden 64, 4 layers, 8
   heads, ffn 128, 8 slots, chunks of 8, 16 requests x 24 tokens) on
   (data=1, fsdp=2, tp=4) over 8 positions, a paged pool with f32 and int8
   weights and a dense pool (f32), each against its no-mesh arm: streams
   equal, every decode chunk, prefill piece and whole-prompt admission
   launching ``paged_attn_decode``, ``flash_chunk_attn(_paged)`` or the
   causal ``flash_attn`` (and ``wq_matmul``) once per layer, step and tp
   shard, KV bytes per position = total / tp, the HBM ledger over the 8
   positions, tokens/s on and off;
   (c) phase 4's 32,768 embeddings in ``ShardedKnnIndex`` and an exhaustive
   ``ShardedIvfIndex`` at dp=4 against the brute-force index (keys equal but
   at near-ties, search ms beside it), and ``FusedRAGPipeline(
   mesh_retrieval=...)`` through ``QueryServer`` against its per-call path;
   (d) ``encode_sequence_parallel`` at MiniLM-L6 width (f32) on 4 x 64-token
   shards against the ``flash_attn`` encode, within 2e-3 at live positions;
   (e) GPT-2 small (int8) saved from the 1x1x1 mesh and (b)'s int8 config
   from the tp=4 mesh (``save_checkpoint``), each loaded back bitwise on the
   host and on its mesh;
16. the dataflow engine (``import pathway_tpu_torch as pw``) at the full
   width of ``bench.py``'s ``config4_streaming_engine``, at half its docs
   (the script's time): 49,152 docs of 24
   words (7-word vocabulary, seed 11) through an ``InMemoryKafkaBroker``,
   full MiniLM-L6 as the ``SentenceTransformerEmbedder`` UDF
   (``max_batch_size=1024``) into a ``DataIndex`` over ``BruteForceKnn``
   (reserved N + 512, cosine), 2 live queries at k = 10 that arrive once
   half the docs are embedded, ``subscribe`` on both tables, ``pw.run()``;
   after a warm pass over the pow2 batch buckets, one rep each of (a) the
   UDF ``deferred=True``, (b) ``deferred=False`` and (c) the direct path
   (the same texts through ``SentenceEmbedderModel`` and
   ``BruteForceKnnIndex.add``), in turns. Every doc reaches the subscriber,
   each engine vector within cosine 0.9999 of the direct one for its text,
   both queries answered with 10 matches whose scores equal the cosine of
   the query and row vectors within 2e-2 (the bf16 corpus), (a)'s and (b)'s
   final tables equal; (d) 4,096 static docs and 64 queries through
   ``DataIndex.query`` equal ``BruteForceKnnIndex.search`` over the direct
   embeddings but at ties within 1e-3. Prints docs/s with the ratios to
   (c), ``LAST_RUN_STATS.engine_tax()``, the phase's ``flash_attn``
   launches (at least one a layer per encode) and the device idle share of
   each rep (CUDA-event times of each encode size over the wall: an
   estimate);
17. the RAG applications through ``pw.run()`` and their REST servers at
   the same widths (``BASELINE.json`` configs 2 and 3): phase 4's corpus
   as a document table (no pandas), phase 4's MiniLM-L6 as the embed UDF
   at ``max_batch_size=1024`` and its cross-encoder as the
   ``CrossEncoderReranker`` UDF, phase 6's server (paged, int8 weights)
   as the answer UDF; every server binds 127.0.0.1 on port 0 and every
   wait is bounded. (a) ``VectorStoreServer(...).run_server``:
   ``/v1/statistics`` reads 32,768 files, ``/v1/inputs`` lists them, 64
   ``VectorStoreClient`` queries at k=10 one at a time equal a direct
   ``BruteForceKnnIndex`` search over the model's own embeddings but at
   score gaps < 1e-3, scores within 2e-2, recall@10 >= 0.9 against phase
   4's exact f32 scoring; (b) ``rerank_route`` (retrieve k=32, a flatten,
   the cross-encoder UDF, a groupby with ``reducers.tuple``,
   ``rerank_topk_filter`` k=10, a join back by id) on the server of (c):
   8 queries one at a time, scores within 2e-2 of the cross-encoder
   called directly on the same pairs, the top 10 equal but at near-ties,
   one score a pair and one encode a query (the answered query's
   retraction replays); (c) ``BaseRAGQuestionAnswerer(...,
   search_topk=6)`` with ``build_server`` / ``run_server``: 8 questions at
   once from 8 threads to ``/v1/pw_ai_answer``, exactly 8 requests at
   the continuous server, 6 context docs each, each answer the served
   request's text, held against the static ``generate`` on the same
   (cut) prompt ids with phase 6's bars. Prints docs/s through
   ``pw.run()``, REST p50 / p99 beside phase 4's direct p50s, TTFT and
   end-to-end p50, the prompts cut, and the phase's launches (each of
   ``flash_attn``, ``flash_chunk_attn_paged``, ``paged_attn_decode`` and
   ``wq_matmul`` above zero, ``flash_attn`` at least a layer an encode);
18. BASELINE configs 1, 2 and 5 as users write them, through the file
   connectors and the index factories, at phase 4's MiniLM-L6 and corpus:
   (a) the 32,768 docs in 8 CSV files, ``pw.io.csv.read(mode="static")``
   -> the embed UDF (``max_batch_size=1024``) -> ``pw.io.jsonlines.write``,
   beside the same program into ``pw.io.null.write`` and the direct path
   (the texts through the model in the UDF's batches), one rep of each in
   turns: every doc written once, vectors within cosine 0.9999 of the
   direct ones; (b) the first 256 docs one file each,
   ``pw.io.fs.read(format="binary", with_metadata=True, mode="streaming")``
   into a ``DocumentStore`` served by ``DocumentStoreServer`` on port 0,
   once for each of ``BruteForceKnnFactory``, ``UsearchKnnFactory``,
   ``IvfKnnFactory`` (its defaults, and nprobe 64 of 64 cells) and
   ``HybridIndexFactory([BruteForceKnnFactory, TantivyBM25Factory])``: 64
   queries at k=10 one at a time over ``/v1/retrieve`` (p50 / p99,
   recall@10 against exact f32 scoring; brute force >= 0.9, exhaustive IVF
   equal to brute force but at near-ties, the hybrid's replies equal an
   RRF computed on the host from its two sub-indexes' own replies over two
   more routes), then 32 files out and 64 in, waited for until the
   store lists exactly the files left: 4 new docs' own texts find them,
   no deleted doc returned; (c) ``BruteForceKnnFactory(mesh=)`` and
   ``IvfKnnFactory(mesh=, nprobe=n_cells)`` over 4 virtual positions of the
   card index (a)'s 32,768 vectors through ``DataIndex`` in ``pw.run()``:
   ``retrieval_backend_stats()`` names the sharded index, top-10 keys equal
   the unsharded brute force's but at near-ties, search ms of the 64
   queries beside it. Phase 18 runs ``flash_attn`` only, once a layer an
   encode;
19. an event-time windowed embed stream through ``pw.temporal`` at phase
   16's width: its 49,152 docs, each with a topic (``i % 8``) and an event
   time ``t = i + j`` (``j`` a seeded jitter in [-512, 512]), a seeded 1%
   of them late (a ``t`` from the stream's first quarter, produced last),
   through an ``InMemoryKafkaBroker`` fed in commits of 1,024 docs (each
   taken by the reader before the next: every epoch holds at most 1,024)
   into phase 16's deferred MiniLM-L6 UDF; 64 queries follow on a second
   topic. (a) ``windowby(t, sliding(hop=2048, duration=8192),
   common_behavior(delay=1024, cutoff=4096), instance=topic).reduce(topic,
   start, n=count(), centroid=npsum(vec), last=max(t))``: the windows,
   counts and last times equal a host computation from the in-order docs,
   no late doc counted, each centroid within cosine 0.9999 of the sum of
   its docs' direct embeddings; (b) ``windows.diff(start, n,
   instance=topic)`` (``Table.sort`` and ``SortNode``) equals the host's;
   (c) ``interval_join(queries, docs, interval(-4096, 0), topic ==
   topic)`` scored by ``pw.apply`` and reduced per query to ``argmax`` and
   ``max``: each best doc equals host brute force over the direct
   embeddings in its topic and interval but at gaps < 1e-3, scores within
   2e-2; (d) ``asof_join`` of the queries to their topic's windows on
   ``last``: the latest window at or before each query, cos(query,
   centroid) within 2e-2 of the host's. The windowed program and the same
   feed without windows run one rep each, in turns; prints docs/s of both
   and their ratio, the reader's epochs, ``op_step_seconds`` / ``op_rows``
   of the Buffer, Freeze, Sort, IntervalJoin and AsofJoin nodes
   (``probes.engine_snapshot()``) and the phase's ``flash_attn`` launches
   (at least one a layer an encode);
20. two processes sharing the card (``EngineConfig(processes=2,
   process_id=, first_port=)``, the TCP row exchange): each child is this
   script with ``--phase20-child`` and a spec, told its process id and
   ports, loading the kernels phase 2 built (a missing one fails; none is
   built) and phase 4's MiniLM-L6 (bf16, seed 0) on ``cuda:0``; every wait
   is bounded and a child that exits non-zero fails the phase. (a) phase
   4's 32,768 docs in 8 CSV files (4 a process by the reader's path hash),
   ``pw.io.csv.read(mode="static")`` -> the deferred embed UDF
   (``max_batch_size=1024``) -> ``DataIndex(BruteForceKnn)`` and
   ``pw.io.null.write``; 64 queries from one more file, let through once a
   count of the embedded docs reaches 32,768 (the index answers as of
   now), answered with k=10 into ``pw.io.jsonlines.write`` (shards ``.0``
   / ``.1``); one process and two, one rep each, in turns: the processes
   embedded disjoint shares of every doc, every process's index holds all
   32,768 rows, each query answered once after folding the shards' update
   streams, each top-10 equal to the one-process run's but at score gaps
   < 1e-3, recall@10 >= 0.9 against phase 4's exact f32 scoring; (b) the
   first 4,096 docs, each querying the index for its 5 nearest others
   once all are in, edges at cosine >= ``MP_TAU`` both ways: connected
   components by min-label propagation under ``pw.iterate`` and
   ``pw.graphs.bellman_ford`` from doc 0 over 1 - cos, one process and
   two: each equal to a host union-find / Dijkstra over the edges the run
   wrote, 10-90% of the docs in shared components, the arms' component
   counts equal unless an edge lies within 1e-3 of tau. Prints docs/s of
   each arm (over the slower child's ``pw.run()`` wall) and their ratio,
   each child's docs, exchanged rows, bytes and control rounds,
   ``flash_attn`` launches (added to the kernels line) and peak
   ``torch.cuda.max_memory_allocated``; (b)'s rounds, the Iterate nodes'
   step seconds and ``op_step_seconds``, and the components;
21. ``pw.ml``, ``rag_eval`` with the observability routes, and the fleet
   over processes: (a) phase 4's first 8,192 docs (a quarter of the corpus, for
   the script's time; and its 64 queries) through
   the embed UDF (batches of 1,024) into
   ``clustering_via_lsh(generate_cosine_lsh_bucketer(384, M=10, L=4,
   seed=0), k=64)`` (the representatives' k-means on the card) and
   ``knn_classifier`` (k = 10) over its labels, in one ``pw.run()``: the
   engine's representatives equal the host's (band, bucket) groups in the
   order it hands them over; each doc's label a majority of its bands'
   labels from a host clustering (JAX's init in numpy, its k-means steps
   in f64) for at least 99% of the docs; each prediction a majority label
   of the host's exact top 10 over the program's vectors but at a near-tie
   10th/11th score; ``fuzzy_match_tables`` of the first 512 doc texts
   against copies with one word changed matches at least 95% to their
   original. Prints docs/s of the program, the representatives' count, the
   card k-means ms (CUDA events), the fuzzy join's s and the
   ``flash_attn`` launches; (b) ``rag_eval.generate_qa_dataset(16,
   seed=0)`` through ``run_rag_eval`` over a
   ``BaseRAGQuestionAnswerer`` (MiniLM-L6 bf16, phase 6's server): 16
   answered, 8 of them against the
   static path: at least 7/8 first tokens equal, and each stream equal up
   to a near-tie (where it parts, the served token within 0.1 of the
   static top logit; accuracy printed, not judged: the weights are
   random); the same answerer behind its REST
   server in ``pw.run(with_http_server=True)``: the metrics server's
   ``/metrics`` holds the engine and serving families and ``/healthz``
   answers 200, ``GET /debug/profile?ms=500`` (``profile_dir`` set) during
   a question writes a ``torch.profiler`` trace naming the paged-decode and
   chunk kernels, and a server without ``profile_dir`` refuses in JAX's
   shape; (c) ``python -m pathway_tpu_torch fleet serve --fleet`` with 1
   and with 2 replicas, each replica this script with
   ``--phase21-replica`` (phase 6's server on ``cuda:0`` behind a REST
   server, the kernels loaded from phase 2's build), both fleets booted at
   once: 8 questions over the router's ``/v1/pw_ai_answer``, 2 behind
   each of 4 shared 256-byte heads (the heads' first, then the rest),
   answers of 2 replicas equal 1 replica's; then a replica SIGKILLed 0.3 s
   into a burst: every request answered or shed, the replica drained and
   a new one spawned, ``fleet stats --url`` listing 2 members. Prints the walls
   and tokens/s of 1 and 2 replicas and their ratio, each replica's peak
   ``max_memory_allocated`` and launches, and the respawn time; each
   fleet's and replica's output is under ``chiprun_out/phase21``. Prints
   the script's wall after the last phase:
22. persistence: a streaming RAG ingest that stops or is killed and
   resumes exactly once, over phase 4's MiniLM-L6 and the first 16,384
   docs of its corpus in 8 CSV files (``persistent_id="docs"``) -> the
   deferred embed UDF (no dedup) -> ``DataIndex``, a JSON-lines sink of
   doc ids, and phase 4's 64 queries answered once the index holds every
   doc. Each arm's run 1 sees files 1-4 and its run 2 (a fresh graph, the
   same store) all 8: (a) ``persisting`` on a filesystem store: each run's
   sink holds each of its docs once, the resumed index equals an
   uninterrupted run's (16,384 rows, the same keys and device bytes), the
   top-10 equal the uninterrupted run's but at score gaps < 1e-3, run 2
   replays 8,256 rows and its ``flash_attn`` launches cover the replayed
   and the new rows; (b) this script with ``--phase22-child`` running
   (a)'s program streaming, SIGKILLed once its sink holds rows, then
   restarted with all 8 files: (a)'s bars; (c) ``udf_caching``: run 2's
   encodes are files 5-8's and the queries' only, the replayed rows'
   vectors (``DiskCache`` hits) byte-equal to run 1's, its ``flash_attn``
   launches those of its missed batches run again alone; (d)
   ``operator_persisting``: an embed UDF giving CUDA tensors (not
   deterministic, so its operator keeps them) -> groupby file -> count
   and the sum of each vector's first component: run 2 restores the
   operators, its replay cache's 16,384 tensors on the card, encodes files
   5-8 only, and the groups over both runs' sinks equal an uninterrupted
   run's within 1e-4 of their sums of magnitudes; with the index, run 2
   falls back to input replay and meets (a)'s bars. Prints each run's
   wall, ``flash_attn`` launches, replayed rows, replay s, restored
   operators and the store's bytes;
23. a CDC-fed index shared through an export, over phase 4's MiniLM-L6:
   program A reads ``pw.io.debezium`` over the in-process broker (16,384
   creates of phase 4's first docs, then 2,048 seeded text updates and
   1,024 deletes in commits of 512 while it streams) and
   ``pw.io.sqlite.read(mode="streaming")`` over a sqlite3 file of the next
   4,096 docs (after its first poll a writer commits 512 updates and 256
   deletes), embeds both through the deferred embed UDF into
   ``pw.export_table`` and ``pw.io.postgres.write_snapshot`` of (doc_id,
   source) through a sqlite3 connection factory, and takes a
   ``consistent_handoff()`` once 4,096 rows are in. Program B, a fresh
   graph once A ended, ``pw.import_table(follow=True)`` into a brute-force
   ``DataIndex`` on the card, answers phase 4's 64 queries one at a time
   through ``pw.io.python``. Bars: the final export holds 19,200 rows with
   the keys and final texts of a plain-Python model of the changes and
   vectors within cosine 0.9999 of direct encodes; the handoff's snapshot
   plus its queued updates equal the final export by cell bytes; the
   export compacted; the sink equals the model's live set; B imported the
   export byte for byte; each top-10 equals a direct
   ``BruteForceKnnIndex`` but at gaps < 1e-3, no deleted doc returned,
   scores those of the final vectors, recall@10 >= 0.9 against exact f32
   scoring; ``flash_attn`` launched for every encode. Prints A's rows/s,
   the handoff's frontier and rows, the compactions, B's import wall and
   query p50 / p99, the launches. Then 3,500 CUDA tensor rows, each
   updated by a retraction holding a distinct tensor of equal bytes,
   through an export (which compacts), an import and a ``LiveTable``:
   each row once, at its new value, on the card;
24. training on the card (``pathway_tpu_torch.models.train``: the dense
   forward, no kernel in a step; AdamW with optax's defaults): (a) the
   contrastive step at full MiniLM-L6 width (bf16 compute, f32 params, lr
   2e-5) over 20 distinct batches of 64 (query, doc) pairs of phase 4's
   corpus (the query a doc's first half of words; phase 4's tokenizer and
   buckets): at step 1 every leaf's gradient finite and non-zero but the
   pooler's (mean pooling never reads it; zero in JAX too), ``qkv_w`` and
   ``attn_out_w`` non-zero in every layer; no ``flash_attn`` launch in a
   step; a held batch's loss lower after the 20 steps; one f32 step on 8
   pairs equal to the CPU's (loss within 1e-5, every param within 1e-4,
   TF32 off and restored); the dp=4 x tp=2 step over ``[cuda:0] * 8`` (a
   tensor a position) against the unsharded step, two steps each: losses
   within 1e-3 relative, the second lower, replicas bitwise equal; then the
   trained params through ``FusedRAGPipeline`` (the ``flash_attn`` kernel)
   over the 32,768 docs: 64 docs' embeddings within cosine 0.9999 of the
   training forward's, recall@10 against exact f32 scoring printed (no
   bar). (b) the causal-LM step at GPT-2-small width (bf16 compute, f32
   params, the byte tokenizer): 10 steps of the corpus's text in 8 rows
   of 256 tokens, row 0 left-padded by 64: every leaf's gradient finite at
   step 1, the repeated batch's loss falling, no ``flash_attn`` launch; the
   dp=2 x tp=4 step (the 50,257-row ``wte`` replicated) against the
   unsharded one as in (a). (c) ``tests/test_rag_eval.py``'s answer gate:
   its decoder (vocab 97, hidden 64, 2 layers, 4 heads, ffn 128, f32)
   trained from scratch on the card on its 4,000 training facts (lr 3e-3,
   batches of 64 from ``np.random.default_rng(0)``, stopping once the loss
   is under 0.21 at a multiple of 30 steps, at most 900; final loss < 0.3);
   ``flash_chunk_attn_paged`` and ``paged_attn_decode`` against their plain
   versions at its 4 heads x 16 (f32); ``run_rag_eval`` over the 40 held-out
   facts through BM25 top-1 and a continuous ``DecoderChat`` (paged, the
   paged kernel, flash prefill, 6 new tokens): ``accuracy_contains`` >= 0.6
   and every decode step and prefill piece through its kernel. (d)
   ``python -m pathway_tpu_torch spawn -n 2`` running this script with
   ``--phase24-child``: 4,096 of phase 4's docs in 8 CSV files through the
   embed UDF on ``cuda:0`` into JSON lines, in a ``pw.run()`` given no
   config: the two children's shares disjoint and covering every doc, the
   vectors within cosine 0.9999 of a direct encode; then ``spawn-from-env``
   (``PATHWAY_SPAWN_ARGS='-n 1 -t 1'``) running a ``pw.debug`` program (a
   CSV round trip); both start after (a) and run beside (b) and (c), for
   the script's time. Prints each objective's step ms (CUDA events), tokens/s
   and peak ``max_memory_allocated``, the gate's steps, wall, final loss,
   accuracy and launches, and the phase's wall;
25. the autotuner with its trials on the card, and an Airbyte source
   through ``pw.sql``: (a) ``tuning.Autotuner`` over ``shared_prefix_chat``
   with phase 6's server settings as base flags under JAX's names (paged
   KV, the paged kernel, flash prefill, int8 weights, the wq kernel),
   phase 6's GPT-2 small params with the profile's char tokenizer, 4
   candidates (the baseline one of them), 2 halving rounds from scale 0.5,
   seed 0, and the SLO leg and chaos drill (``decode.admit`` at 0.25) of
   its validation: every trial builds its server and ends ``terminal_ok``
   (or was aborted); each trial's server shows every prefill piece, plain
   decode step, draft step and layer product through
   ``flash_chunk_attn_paged``, ``paged_attn_decode`` and ``wq_matmul``
   (phase 10's counting); after each trial the chaos and SLO settings are
   back to their defaults; the winner's artifact loads, a
   ``DecoderChat(tuned_config=...)`` holds the winner's values, and its
   greedy streams over 8 prompts equal those of a chat given the values
   explicitly (both with spec and chunk autotune off unless the winner sets
   them: plain decode on a paged pool is schedule-invariant). Each trial's
   flags, scale and headline are printed, the winner against the baseline
   printed, not judged; (b) ``retraction_heavy_ingest`` at its own size
   (JAX's tiny encoder, 3 candidates, one round): every batch through
   ``flash_attn``; (c) a connector script written into a temporary
   directory emits 4,096 RECORD messages of phase 4's corpus, read by
   ``pw.io.airbyte.read(mode="static")`` through an
   ``ExecutableAirbyteSource``; ``pw.sql`` keeps 2,048 (``doc_id % 3 <> 1
   AND doc_id < 3072``); a ``pw.transformer`` adds the word count; phase
   4's MiniLM-L6 as the embed UDF feeds a ``DataIndex`` on the card, which
   phase 4's first 8 queries ask once every kept doc is in, in one
   ``pw.run()``: the kept rows and word counts equal a host model, the
   vectors within cosine 0.9999 of direct encodes, ``flash_attn`` launched
   for every encode, each top-10 equal a direct index but at gaps < 1e-3;
26. the lock sanitizer under serving, the OpenTelemetry exporter and the
   last modules on the card: (a) ``analysis.runtime.configure(enabled=True)``
   and ``enable()``, then a continuous ``DecoderChat`` at phase 6's settings
   (paged KV, the paged kernel, flash prefill, int8 weights through the wq
   kernel) serves 16 greedy requests while two threads send 32 retrieves to
   a ``QueryServer`` on phase 4's pipeline; no sanitizer report, every lock
   the two servers built a ``SanitizedLock``, the streams equal a
   sanitizer-off server's (plain ``threading`` locks) token for token,
   every decode step, prefill piece and layer product through its kernel and
   every retrieve's encode through ``flash_attn``; a seeded inversion on two
   named locks after the burst is reported; both arms' tokens/s printed, not
   judged. (b) with a recording stand-in for the OpenTelemetry SDK in
   ``sys.modules`` and ``pw.set_monitoring_config(server_endpoint=...)``,
   ``pw.demo.replay_csv`` streams 512 docs of phase 4's corpus (one commit
   a row) from a CSV file through the embed UDF into a ``DataIndex`` on the
   card, and phase 4's first 8 queries ask once every doc is in, in one
   ``pw.run()``: the rows equal the CSV, the vectors within cosine 0.9999 of
   direct encodes, each top-10 equal a direct index's but at gaps < 1e-3,
   every encode through ``flash_attn``; the recorder holds one
   ``pathway-tpu.run`` span naming the ``llm`` xpack; then 8 requests to
   (a)'s chat give one exported span each with JAX's ``pathway_tpu.*``
   attribute keys and the ring span's events; the exporter's time a span is
   printed. (c) a stand-in ``openai`` module answers ``OpenAIChat``'s
   chat-completions calls with the text of the page whose index the image
   carries; ``SlideParser(llm=OpenAIChat(...), page_renderer=...)`` reads 8
   decks of 4 PIL pages inside a ``DocumentStore`` whose chunks go through
   the embed UDF on the card, then 8 retrieves: the chunks and their page
   metadata equal a host model, one vision call a page, each page's text
   retrieves that page first, every encode through ``flash_attn``.

The last two lines of stdout are the kernels JSON line and the result
line ``{"ok": true, "device": {...}}``. Imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

T_START = time.perf_counter()

# tolerances of the kernel against its plain version: the kernel keeps
# scores and probabilities in f32; it differs from the dense f32 plain
# version in summation order and its fast exp only
ATOL = {"float32": 1e-4, "bfloat16": 2e-3}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak, same sheet

N_DOCS, INGEST_BATCH, N_QUERIES, TOP_K, RERANK_K = 32768, 4096, 64, 10, 32
# the decoder main path: GPT-2 small, 16 slots, chunks of 16 steps, 64 new
# tokens, prompts up to 512 tokens in pieces of 64, paged blocks of 64
# (cache_len 512 + 64 + 5 * 16 = 656, rounded up to 704)
# 32 requests a burst (48 until the script's time asked for less)
N_REQUESTS, MAX_NEW, N_SLOTS, CACHE_LEN, BLOCK, PIECE = 24, 64, 16, 704, 64, 64
# the card's bf16 noise against the port's static path: first-token logits
# (spread ~0.55 with random weights) within 0.1; at least 7 of 8 first
# tokens and 3 of 8 whole streams equal
LOGIT_TOL, MIN_FIRST_EQUAL, MIN_STREAMS_EQUAL = 0.1, 7, 3
# phase 7: one paged block of GPT-2 small's K+V in bf16 is 2 * 12 layers *
# 12 heads * 64 tokens * 64 * 2 bytes = 2,359,296 bytes; tier 1 of the
# tier-2 run holds 3 of them
KV_BLOCK_BYTES = 2 * 12 * 12 * BLOCK * 64 * 2
SHARED_HEAD, DENSE_HEAD, T2_HEAD = 256, 128, 192
# phase 11: MiniLM-L6's layers, and the ingest's batches of INGEST_BATCH
MINILM_LAYERS, INGEST_BATCHES = 6, N_DOCS // INGEST_BATCH
# each kernel's current design, as its source describes it
DESIGN = {
    "flash_attn": "bf16: mma.sync m16n8k16, persistent blocks over 64-row groups, "
                  "2-stage cp.async ring; f32: CUDA-core FMA",
    "flash_chunk_attn": "bf16: mma.sync, split over the cache + combine kernel",
    "flash_chunk_attn_paged": "bf16: mma.sync, split over the cache + combine kernel, "
                              "block-table addressing",
    "paged_attn_decode": "bf16: flash-decoding splits combined in a cluster, 2-stage "
                         "cp.async ring, a lane per 16-byte chunk; f32: a block per "
                         "(slot, head)",
    "wq_matmul": "bf16: mma.sync, split K reduced in a cluster",
}


def info(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events). The
    card first sleeps long enough for the host to queue every call, so the
    events bracket the calls' device work back to back, not the host's
    rate of issuing them (a small kernel runs faster than Python calls
    it)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0  # an upper bound on one call's issue time
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0, 2 * iters * host_s + 0.01) * 2e9))  # ~2 GHz clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def corpus(seed: int = 7, n_queries: int = N_QUERIES):
    """bench.py's config2 corpus recipe: a seeded 3,000-word pool, 12
    words a doc, 6 a query (more queries extend the same sequence)."""
    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    words = np.array(sorted({
        "".join(rng.choice(letters, rng.integers(3, 9))) for _ in range(3000)
    }))
    docs = [" ".join(rng.choice(words, 12)) for _ in range(N_DOCS)]
    queries = [" ".join(rng.choice(words, 6)) for _ in range(n_queries)]
    return docs, queries


# ---------------------------------------------------------------- phase 3
def check_flash_attn(dev) -> float:
    """Kernel vs plain version at the encoder's widths; returns the max
    abs error over all cases."""
    import torch

    from pathway_tpu_torch.models import flash_attention as FA

    g = torch.Generator().manual_seed(0)
    worst = 0.0
    for S in (16, 32, 64, 160, 256):
        B, nh, hd = 64, 12, 32
        lens = torch.randint(1, S + 1, (B,), generator=g)
        lens[0], lens[1] = 0, S  # an all-masked row and a full one
        mask = (torch.arange(S)[None, :] < lens[:, None]).to(torch.int32).to(dev)
        base = [torch.randn((B, nh, S, hd), generator=g) for _ in range(3)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dev, dtype) for t in base)
            for causal in (False, True):
                out = FA.flash_attn(q, k, v, mask, causal=causal)
                torch.cuda.synchronize()
                ref = FA.flash_attn_reference(q, k, v, mask, causal=causal)
                err = (out - ref).abs().max().item()
                name = str(dtype).split(".")[-1]
                info(f"flash_attn S={S} {name} causal={causal}: "
                     f"max_abs_err={err:.3e} (atol {ATOL[name]})")
                if not err <= ATOL[name]:
                    raise AssertionError(f"flash_attn disagrees with its plain version: {err}")
                if not torch.all(out[0] == 0):
                    raise AssertionError("all-masked row is not exact zeros")
                worst = max(worst, err)
    # the decoder's whole-prompt admission: head_dim 64, causal, left-padded
    for S in (64, 128, 512):
        B, nh, hd = 16, 12, 64
        lens = torch.randint(1, S + 1, (B,), generator=g)
        lens[0] = S
        mask = (torch.arange(S)[None, :] >= (S - lens)[:, None]).to(torch.int32).to(dev)
        base = [torch.randn((B, nh, S, hd), generator=g) for _ in range(3)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dev, dtype) for t in base)
            out = FA.flash_attn(q, k, v, mask, causal=True)
            torch.cuda.synchronize()
            ref = FA.flash_attn_reference(q, k, v, mask, causal=True)
            err = (out - ref).abs().max().item()
            name = str(dtype).split(".")[-1]
            info(f"flash_attn hd=64 S={S} {name} causal left-padded: "
                 f"max_abs_err={err:.3e} (atol {ATOL[name]})")
            if not err <= ATOL[name]:
                raise AssertionError(f"flash_attn (hd 64, causal) disagrees: {err}")
            worst = max(worst, err)
    return worst


def time_flash_attn(dev, mask) -> dict:
    """Kernel, plain version and library call on the ingest shape: q/k/v
    (4096, 12, S, 32) bf16 with the mask of a real ingest batch."""
    import torch
    import torch.nn.functional as F

    from pathway_tpu_torch.models import flash_attention as FA

    B, S = mask.shape
    nh, hd = 12, 32
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((B, nh, S, hd), generator=g).to(dev, torch.bfloat16)
               for _ in range(3))
    out = FA.flash_attn(q, k, v, mask, causal=False)
    torch.cuda.synchronize()
    ref = FA.flash_attn_reference(q, k, v, mask, causal=False)
    err = (out - ref).abs().max().item()
    if not err <= ATOL["bfloat16"]:
        raise AssertionError(f"flash_attn disagrees at the ingest shape: {err}")
    ms = cuda_time_ms(lambda: FA.flash_attn(q, k, v, mask, causal=False), 50)
    plain_ms = cuda_time_ms(
        lambda: FA.flash_attn_reference(q, k, v, mask, causal=False), 10)
    bool_mask = (mask > 0)[:, None, None, :]
    library_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bool_mask), 50)
    n_bytes = 3 * q.numel() * q.element_size() + mask.numel() * 4 + out.numel() * 4
    live_cols = mask.sum(dim=1).double()
    # every query row (of S) attends its row's live columns: q.k and p.v
    flops = float((live_cols * S).sum().item()) * nh * hd * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "shape": [B, nh, S, hd],
    }


# ---------------------------------------------------------------- phase 4
def run_main_path(device, docs, queries, cfg, batch: int = INGEST_BATCH,
                  rerank_k: int = RERANK_K, n_lat: int = 24):
    """Drive the port's RAG main path once through its entry points.
    Returns the measurements and the number of encoder calls made."""
    import torch

    from pathway_tpu_torch import CrossEncoderModel, FusedRAGPipeline, SentenceEmbedderModel

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    emb = SentenceEmbedderModel(cfg, max_length=64, device=device)
    ce = CrossEncoderModel(cfg, device=device)
    pipe = FusedRAGPipeline(emb, ce, reserved_space=len(docs), doc_seq=32,
                            pair_seq=160)
    keys = [f"k{i}" for i in range(len(docs))]
    encodes = 0

    sync()
    t0 = time.perf_counter()
    for s in range(0, len(docs), batch):
        pipe.add(keys[s : s + batch], docs[s : s + batch])
        encodes += 1
    sync()
    ingest_s = time.perf_counter() - t0

    res = pipe.retrieve(queries, k=TOP_K)
    encodes += 1
    # truth: exact f32 host scoring of the port's own f32 embeddings
    corpus_v = []
    for s in range(0, len(docs), batch):
        h, m = emb.embed_device(docs[s : s + batch])
        corpus_v.append(h[:m].cpu().numpy())
        encodes += 1
    h, m = emb.embed_device(queries)
    encodes += 1
    q_v = h[:m].cpu().numpy()
    truth = np.argsort(-(q_v @ np.concatenate(corpus_v).T), axis=1, kind="stable")[:, :TOP_K]
    hits = sum(len({int(k[1:]) for k, _ in row} & set(truth[i].tolist()))
               for i, row in enumerate(res))
    recall = hits / (len(queries) * TOP_K)

    lat = []
    for i in range(n_lat):
        t0 = time.perf_counter()
        pipe.retrieve([queries[i % len(queries)]], k=TOP_K)
        lat.append(time.perf_counter() - t0)
        encodes += 1

    rr_lat, rerank_rows = [], []
    for i in range(8):
        t0 = time.perf_counter()
        rerank_rows.append(pipe.retrieve_rerank(queries[i], k=rerank_k))
        rr_lat.append(time.perf_counter() - t0)
        encodes += 2  # query embed + pair cross-encode
    t0 = time.perf_counter()
    rerank_rows += pipe.retrieve_rerank_batch(queries[8:16], k=rerank_k)
    batch_ms = (time.perf_counter() - t0) * 1e3
    encodes += 2

    live = set(keys)
    for row in res:
        if len(row) != TOP_K or not all(np.isfinite(s) for _, s in row):
            raise AssertionError("retrieve returned a short or non-finite row")
    for row in rerank_rows:
        got = [k for k, _ in row]
        if len(got) != rerank_k or len(set(got)) != rerank_k or not set(got) <= live:
            raise AssertionError("a rerank row is not a permutation of live keys")
        scores = [s for _, s in row]
        if not all(np.isfinite(scores)) or scores != sorted(scores, reverse=True):
            raise AssertionError("rerank scores are non-finite or out of order")
    return {
        "ingest_docs_per_s": len(docs) / ingest_s,
        "recall_at_10": recall,
        "retrieve_p50_ms": statistics.median(lat) * 1e3,
        "rerank_p50_ms": statistics.median(rr_lat) * 1e3,
        "rerank_batch8_ms": batch_ms,
        "encodes": encodes, "truth": truth,
        "emb": emb, "ce": ce, "pipe": pipe,
    }


def check_against_cpu(emb, cfg, docs, queries) -> None:
    """The same seeded models on the CPU (plain PyTorch path, no kernel)
    must agree with the card on a small input: the bf16 main-path
    embedder within bf16 noise (cosine >= 0.99), and the full-width model
    in f32 tightly (cosine >= 0.99999, rerank scores within 1e-5: f32
    everywhere, only summation order differs)."""
    import dataclasses

    import torch

    from pathway_tpu_torch import CrossEncoderModel, SentenceEmbedderModel

    texts, pairs = docs[:32], list(zip(queries[:16], docs[:16]))
    a = emb.embed_batch(texts)
    b = SentenceEmbedderModel(cfg, max_length=64, device="cpu").embed_batch(texts)
    if a.shape != (32, cfg.hidden) or not np.all(np.isfinite(a)):
        raise AssertionError("card embeddings have the wrong shape or are not finite")
    cos = float(np.min(np.sum(a * b, axis=1)))
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    e32 = [SentenceEmbedderModel(f32, max_length=64, device=d).embed_batch(texts)
           for d in (emb.device, "cpu")]
    cos32 = float(np.min(np.sum(e32[0] * e32[1], axis=1)))
    s32 = [CrossEncoderModel(f32, device=d).score_batch(pairs) for d in (emb.device, "cpu")]
    score_err = float(np.max(np.abs(s32[0] - s32[1])))
    info(f"card vs cpu: bf16 min embedding cosine {cos:.6f} (>= 0.99); f32 min "
         f"cosine {cos32:.7f} (>= 0.99999), max rerank score diff {score_err:.3e} "
         f"(<= 1e-5, scores up to {float(np.max(np.abs(s32[1]))):.4f})")
    if not (cos >= 0.99 and cos32 >= 0.99999 and score_err <= 1e-5):
        raise AssertionError("the card disagrees with the CPU on a small input")


# ---------------------------------------------------------------- phase 5
def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """Least time the card could take: bytes over the memory rate or
    operations over the bf16 peak, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def paged_case(g, dev, quant: bool, lens):
    """Decode-shape operands: 16 slots x 12 heads x head_dim 64, blocks of
    64, 11 a slot, shuffled physical ids, sentinel block 0 zero, each
    slot's table past its live length pointing at the sentinel."""
    import torch

    B, nh, hd, Bk, M = N_SLOTS, 12, 64, BLOCK, CACHE_LEN // BLOCK
    n_blocks = B * M + 1
    q = torch.randn((B, nh, hd), generator=g).to(dev, torch.bfloat16)
    if quant:
        kb, vb = (torch.randint(-127, 128, (n_blocks, nh, Bk, hd), generator=g,
                                dtype=torch.int8).to(dev) for _ in range(2))
        kbs, vbs = (torch.empty((n_blocks, nh, Bk, 1)).uniform_(0.005, 0.03, generator=g)
                    .to(dev) for _ in range(2))
    else:
        kb, vb = (torch.randn((n_blocks, nh, Bk, hd), generator=g).to(dev, torch.bfloat16)
                  for _ in range(2))
        kbs = vbs = None
    for t in (kb, vb, kbs, vbs):
        if t is not None:
            t[0] = 0
    tbl = (torch.randperm(n_blocks - 1, generator=g)[: B * M] + 1).reshape(B, M)
    for b in range(B):
        tbl[b, (int(lens[b]) + Bk - 1) // Bk:] = 0
    mask = (torch.arange(M * Bk)[None, :] < lens[:, None]).to(torch.int32)
    return [q, kb, vb, kbs, vbs, tbl.to(torch.int32).to(dev), mask.to(dev)]


def check_paged_decode(dev) -> dict:
    import torch
    import torch.nn.functional as F

    from pathway_tpu_torch.models import paged_attention as PA

    g = torch.Generator().manual_seed(2)
    worst = 0.0
    timed = None
    for quant in (False, True):
        # main-path live lengths (prompt 16..480 + up to 64 new), one empty
        # slot, one ragged inside its first block
        lens = torch.randint(16, 545, (N_SLOTS,), generator=g)
        lens[0], lens[1] = 0, 5
        args = paged_case(g, dev, quant, lens)
        out = PA.paged_attn_decode(*args)
        torch.cuda.synchronize()
        ref = PA.paged_attn_decode_reference(*args)
        err = (out.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=1e-3)
        if not torch.all(out[0] == 0):
            raise AssertionError("paged_attn_decode: the empty slot is not exact zeros")
        if any(t is not None and bool(torch.any(t[0] != 0)) for t in args[1:5]):
            raise AssertionError("paged_attn_decode: the sentinel block changed")
        info(f"paged_attn_decode {'int8' if quant else 'bf16'} K/V: max_abs_err={err:.3e} "
             f"(rtol 2^-7, atol 1e-3: one bf16 ulp of the output)")
        worst = max(worst, err)
        if not quant:
            timed = (args, lens)
    args, lens = timed
    live = int(lens.sum())
    nh, hd = 12, 64
    n_bytes = (nbytes(args[0], args[5], args[6]) + nbytes(args[0])
               + live * nh * hd * 2 * args[1].element_size())
    b_ms, b_by = bound(n_bytes, 4.0 * live * nh * hd)
    # the library yardstick: one scaled_dot_product_attention call on the
    # K/V rows gathered once beforehand (the gather is not timed) with the
    # boolean slot mask; the port never calls it
    q, kb, vb, _, _, tbl, mask = args
    k_rows, v_rows = PA.gather_rows(kb, tbl), PA.gather_rows(vb, tbl)
    attn_mask = (mask > 0)[:, None, None, :]
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], k_rows, v_rows, attn_mask=attn_mask), 200)
    # the split plans of the bf16 design side by side, each checked first
    B, M = tbl.shape
    split_ms = {}
    ref = PA.paged_attn_decode_reference(*args)
    for cols in PA.SPLIT_CANDIDATES:
        def fn(cols=cols):
            return PA._launch(*args, torch.empty_like(q), hd ** -0.5, split_cols=cols)
        torch.testing.assert_close(fn().float(), ref.float(), rtol=2 ** -7, atol=1e-3)
        plan = PA.decode_plan(M, BLOCK, cols)
        name = f"{plan.entries} entries x {plan.n_splits} splits, {plan.blocks(B, nh)} blocks"
        split_ms[name] = cuda_time_ms(fn, 200)
    return {
        "max_abs_err": worst,
        "ms": cuda_time_ms(lambda: PA.paged_attn_decode(*args), 200),
        "plain_ms": cuda_time_ms(lambda: PA.paged_attn_decode_reference(*args), 20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        "split_ms": split_ms,
        "shape": f"16 slots x 12 heads x 64, block 64, {live} live columns",
    }


def chunk_case(g, dev, quant: bool, start: int):
    import torch

    nh, T, hd, C = 12, PIECE, 64, CACHE_LEN
    q = torch.randn((nh, T, hd), generator=g).to(dev, torch.bfloat16)
    if quant:
        k, v = (torch.randint(-127, 128, (nh, C, hd), generator=g, dtype=torch.int8).to(dev)
                for _ in range(2))
        ks, vs = (torch.empty((nh, C, 1)).uniform_(0.005, 0.03, generator=g).to(dev)
                  for _ in range(2))
    else:
        k, v = (torch.randn((nh, C, hd), generator=g).to(dev, torch.bfloat16)
                for _ in range(2))
        ks = vs = None
    row_mask = (torch.arange(C) < start + T).to(torch.int32)
    return q, k, v, ks, vs, row_mask.to(dev)


def to_blocks(g, row, dev):
    """A dense (heads, C, d) row cut into shuffled physical blocks of BLOCK
    columns behind a table row; block 0 stays the zero sentinel."""
    import torch

    if row is None:
        return None, None
    nh, C, d = row.shape
    M = C // BLOCK
    perm = (torch.randperm(M + 4, generator=g)[:M] + 1).to(dev)
    planes = torch.zeros((M + 5, nh, BLOCK, d), dtype=row.dtype, device=dev)
    planes[perm.long()] = row.reshape(nh, M, BLOCK, d).transpose(0, 1)
    return planes, perm.to(torch.int32)


def check_flash_chunk(dev) -> tuple[dict, dict]:
    import torch
    import torch.nn.functional as F

    from pathway_tpu_torch.models import flash_attention as FA

    g = torch.Generator().manual_seed(3)
    worst = {"dense": 0.0, "paged": 0.0}
    for quant in (False, True):
        for start in (0, 64, 640):
            q, k, v, ks, vs, row_mask = chunk_case(g, dev, quant, start)
            row_mask[start // 2::9] = 0  # holes among the live columns
            out = FA.flash_chunk_attn(q, k, v, row_mask, start, k_scale=ks, v_scale=vs)
            torch.cuda.synchronize()
            ref = FA.flash_chunk_attn_reference(q, k, v, row_mask, start,
                                                k_scale=ks, v_scale=vs)
            err = (out - ref).abs().max().item()
            # the same cache as shuffled physical blocks behind a table row
            gp = torch.Generator().manual_seed(start + quant)
            (kb, tbl), (vb, _), (kbs, _), (vbs, _) = (
                to_blocks(gp.manual_seed(7), t, dev) for t in (k, v, ks, vs))
            paged = FA.flash_chunk_attn_paged(q, kb, vb, kbs, vbs, tbl, row_mask, start)
            torch.cuda.synchronize()
            ref_p = FA.flash_chunk_attn_paged_reference(q, kb, vb, kbs, vbs, tbl,
                                                        row_mask, start)
            err_p = (paged - ref_p).abs().max().item()
            info(f"flash_chunk_attn start={start} {'int8' if quant else 'bf16'} K/V: "
                 f"dense max_abs_err={err:.3e}, paged {err_p:.3e} (atol 2e-3); "
                 f"paged == dense on the gathered row: {torch.equal(paged, out)}")
            if not (err <= 2e-3 and err_p <= 2e-3):
                raise AssertionError("flash_chunk_attn disagrees with its plain version")
            if not torch.equal(paged, out):
                raise AssertionError("flash_chunk_attn_paged differs from the dense variant")
            worst["dense"] = max(worst["dense"], err)
            worst["paged"] = max(worst["paged"], err_p)
    # timed at the longest piece the main path gives: queries 448..511
    start = 448
    q, k, v, _, _, row_mask = chunk_case(g, dev, False, start)
    (kb, tbl), (vb, _) = (to_blocks(g.manual_seed(11), t, dev) for t in (k, v))
    T, C, nh, hd = PIECE, CACHE_LEN, 12, 64
    live = start + T
    cols = torch.arange(C, device=dev)
    allowed = (row_mask > 0)[None, :] & (cols[None, :] <= start + torch.arange(T, device=dev)[:, None])
    attn_mask = allowed[None, None]
    lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q[None], k[None], v[None], attn_mask=attn_mask), 100)
    flops = 4.0 * nh * hd * sum(start + t + 1 for t in range(T))
    n_bytes = nbytes(q, row_mask) + nh * T * hd * 4 + live * nh * hd * 2 * k.element_size()
    rows = {}
    for name, fn, plain, extra in (
        ("dense",
         lambda: FA.flash_chunk_attn(q, k, v, row_mask, start),
         lambda: FA.flash_chunk_attn_reference(q, k, v, row_mask, start), 0),
        ("paged",
         lambda: FA.flash_chunk_attn_paged(q, kb, vb, None, None, tbl, row_mask, start),
         lambda: FA.flash_chunk_attn_paged_reference(q, kb, vb, None, None, tbl, row_mask, start),
         nbytes(tbl)),
    ):
        b_ms, b_by = bound(n_bytes + extra, flops)
        rows[name] = {
            "max_abs_err": worst[name], "ms": cuda_time_ms(fn, 100),
            "plain_ms": cuda_time_ms(plain, 20), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib,
            "shape": f"64 queries at 448 over 512 live of 704 columns, 12 heads x 64, bf16",
        }
    # the split-width candidates of the bf16 design, side by side (dense),
    # each checked against the plain version first
    rows["dense"]["blocks"] = FA.chunk_plan(nh, T, C, start, hd).blocks(nh)
    rows["dense"]["split_ms"] = {}
    ref = FA.flash_chunk_attn_reference(q, k, v, row_mask, start)
    for cols in FA.SPLIT_CANDIDATES:
        def fn(cols=cols):
            return FA._launch_chunk(q, k, v, None, None, None, row_mask, start, C, C,
                                    hd ** -0.5, split_cols=cols)
        err = (fn() - ref).abs().max().item()
        if not err <= 2e-3:
            raise AssertionError(f"chunk split width {cols} disagrees: {err}")
        blocks = FA.chunk_plan(nh, T, C, start, hd, cols).blocks(nh)
        rows["dense"]["split_ms"][f"{cols} columns, {blocks} blocks"] = cuda_time_ms(fn, 100)
    return rows["dense"], rows["paged"]


WQ_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768))


def check_wq_matmul(dev) -> dict:
    import torch

    from pathway_tpu_torch.models import wq_matmul as WQ

    g = torch.Generator().manual_seed(4)
    worst = 0.0

    def operands(M, K, N):
        return (torch.randn((M, K), generator=g).to(dev, torch.bfloat16),
                torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8).to(dev),
                torch.empty((1, N)).uniform_(1e-4, 1e-2, generator=g).to(dev))

    for K, N in WQ_SHAPES + ((768, 2309),):  # 2309: no tile of 32 divides it
        for M in (1, 16, 64, 200):
            x, w, s = operands(M, K, N)
            out = WQ.wq_matmul(x, w, s)
            torch.cuda.synchronize()
            ref = WQ.wq_matmul_reference(x, w, s)
            err = (out - ref).abs().max().item()
            top = ref.abs().max().item()
            if not err <= 1e-5 * top:
                raise AssertionError(f"wq_matmul {M}x{K}x{N}: err {err} > 1e-5 x {top}")
            worst = max(worst, err)
    info(f"wq_matmul: max_abs_err={worst:.3e} over the GPT-2 shapes and M in "
         f"{{1, 16, 64, 200}} (each within 1e-5 of its largest output)")
    # timed: one decode layer's four products at M = 16, as PR 2 timed them
    # (one layer's weights, 7.7 MB, stay in the 50 MB L2 between calls)
    ops = [operands(N_SLOTS, K, N) for K, N in WQ_SHAPES]
    n_bytes = sum(nbytes(x, w, s) + x.shape[0] * w.shape[1] * 4 for x, w, s in ops)
    flops = sum(2.0 * x.shape[0] * x.shape[1] * w.shape[1] for x, w, _ in ops)
    b_ms, b_by = bound(n_bytes, flops)
    # a decode step's weights: 12 layers' distinct weights (~85 MB, past L2)
    layers = [[(ops[i][0],) + operands(N_SLOTS, K, N)[1:] for i, (K, N) in enumerate(WQ_SHAPES)]
              for _ in range(12)]
    # a prefill piece: M = 64
    ops64 = [operands(PIECE, K, N) for K, N in WQ_SHAPES]
    lib_ms, probe = None, int8pack_probe(ops)
    if probe["fn"] is not None:
        lib_ms = cuda_time_ms(probe["fn"], 100)
    info(f"torch._weight_int8pack_mm on the card: {probe['text']}")
    plans = {f"{K}x{N}": WQ.wq_plan(N_SLOTS, K, N).blocks for K, N in WQ_SHAPES}
    return {
        "max_abs_err": worst,
        "ms": cuda_time_ms(lambda: [WQ.wq_matmul(*o) for o in ops], 100),
        "ms_l2_cold": cuda_time_ms(
            lambda: [WQ.wq_matmul(*o) for layer in layers for o in layer], 20) / 12,
        "ms_m64": cuda_time_ms(lambda: [WQ.wq_matmul(*o) for o in ops64], 100),
        "plain_ms": cuda_time_ms(lambda: [WQ.wq_matmul_reference(*o) for o in ops], 30),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "library_probe": probe["text"], "blocks": plans,
        "shape": "one decode layer: M=16 at 768x2304, 768x768, 768x3072, 3072x768",
    }


def int8pack_probe(ops) -> dict:
    """Whether ``torch._weight_int8pack_mm`` (x (M, K), w^T (N, K) int8,
    per-column scales) runs on the card: f32 scales, then bf16 scales (the
    dtype of x). Returns a callable over the four products (transposed
    weights made here, outside any timing) and what the probe saw; the port
    never calls it."""
    import torch

    from pathway_tpu_torch.models import wq_matmul as WQ

    wts = [w.t().contiguous() for _, w, _ in ops]
    seen = []
    for dt in (torch.float32, torch.bfloat16):
        scales = [s.reshape(-1).to(dt) for _, _, s in ops]
        try:
            outs = [torch._weight_int8pack_mm(x, wt, sc) for (x, _, _), wt, sc in zip(ops, wts, scales)]
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 -- the probe records any refusal
            seen.append(f"{str(dt)[6:]} scales: {type(e).__name__}: {str(e).splitlines()[0][:200]}")
            continue
        err = max(((o.float() - WQ.wq_matmul_reference(*op)).abs().max()
                   / WQ.wq_matmul_reference(*op).abs().max()).item()
                  for o, op in zip(outs, ops))
        seen.append(f"{str(dt)[6:]} scales: runs, {outs[0].dtype} out, max error "
                    f"{err:.2e} of the largest output")
        return {"fn": lambda: [torch._weight_int8pack_mm(x, wt, sc) for (x, _, _), wt, sc
                               in zip(ops, wts, scales)],
                "text": f"torch {torch.__version__}: " + "; ".join(seen)}
    return {"fn": None, "text": f"torch {torch.__version__}: " + "; ".join(seen)}


# ---------------------------------------------------------------- phase 6
def byte_tokenizer():
    """GPT-2's byte-level tokenizer with the 256 byte symbols and no merges:
    one id per byte, no EOS."""
    from pathway_tpu_torch.models.bpe import BPETokenizer, bytes_to_unicode

    b2u = bytes_to_unicode()
    return BPETokenizer({b2u[i]: i for i in range(256)}, [])


def make_prompts(n: int, lo: int, hi: int, seed: int) -> list[str]:
    """Seeded ASCII prompts of lo..hi bytes (= tokens)."""
    rng = np.random.default_rng(seed)
    chars = np.array(list("abcdefghijklmnopqrstuvwxyz     ,."))
    return ["".join(rng.choice(chars, int(n_tok)))
            for n_tok in rng.integers(lo, hi + 1, n)]


def counters():
    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.models import paged_attention as PA
    from pathway_tpu_torch.models import wq_matmul as WQ

    return {"flash_attn": FA.flash_attn, "flash_chunk_attn": FA.flash_chunk_attn,
            "flash_chunk_attn_paged": FA.flash_chunk_attn_paged,
            "paged_attn_decode": PA.paged_attn_decode, "wq_matmul": WQ.wq_matmul}


def serve(chat, prompts: list[str], gaps=()) -> dict:
    """One run of the server through DecoderChat's entry points, with every
    kernel count set to 0 just before and read just after; with ``gaps``
    (seconds) the prompts arrive in len(gaps) + 1 equal waves. A dead loop,
    a short stream or a dropped tier-2 promotion fails the run."""
    import torch

    for f in counters().values():
        f.launches = 0
    s0 = dict(chat.server.stats)
    n_wave = len(prompts) // (len(gaps) + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = chat.submit_batch(prompts[:n_wave])
    for i, gap in enumerate(gaps, 1):
        time.sleep(gap)
        reqs += chat.submit_batch(prompts[i * n_wave:(i + 1) * n_wave])
    texts = chat.resolve_batch([reqs])[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: f.launches for n, f in counters().items()}
    stats = {k: v - s0[k] for k, v in chat.server.stats.items()}
    if chat.server.failed is not None:
        raise AssertionError(f"the serving loop died: {chat.server.failed!r}")
    if chat.server.stats["t2_dropped"]:
        raise AssertionError("a tier-2 promotion was dropped")
    for r, t in zip(reqs, texts):
        if t is None or len(r.tokens) != MAX_NEW:  # no EOS in a byte vocab
            raise AssertionError(f"a request finished with {len(r.tokens)} tokens")
    n_tok = sum(len(r.tokens) for r in reqs)
    ttft = [r.first_token_at - r.submitted_at for r in reqs]
    return {"reqs": reqs, "wall_s": wall, "launches": launches, "stats": stats,
            "tok_per_s": n_tok / wall, "ttft_p50_s": statistics.median(ttft)}


def require(cond: bool, what: str) -> None:
    info(f"  check: {what}: {'ok' if cond else 'FAILED'}")
    if not cond:
        raise AssertionError(what)


def paged_first_logits(chat, ids: list[int]):
    """The first-token logits of ``ids`` through the server's paged path:
    right-padded pieces of PIECE tokens into a one-slot paged pool, flash
    chunk attention, the chat's (int8, wq-kernel) weights."""
    import torch

    from pathway_tpu_torch.models import decoder as D

    dev, cfg = chat.device, chat.cfg
    M = CACHE_LEN // BLOCK
    pool = D.paged_pool_init(chat.params, cfg, 1, CACHE_LEN, M + 1, BLOCK)
    D.paged_table_set(pool, 0, np.arange(1, M + 1, dtype=np.int32))
    n = len(ids)
    W = -(-n // PIECE) * PIECE
    r_ids = np.zeros((1, W), np.int32)
    r_mask = np.zeros((1, W), np.int32)
    r_ids[0, :n], r_mask[0, :n] = ids, 1
    pos = np.minimum(np.arange(W), n - 1)[None].astype(np.int32)
    for o in range(0, W, PIECE):
        last = o + PIECE >= W
        t = [torch.from_numpy(a[:, o:o + PIECE]).to(dev) for a in (r_ids, r_mask, pos)]
        D.pool_prefill_chunk(chat.params, *t, pool, 0, o, n, cfg, first=o == 0,
                             last=last, last_col=(n - 1) - (W - PIECE) if last else None,
                             flash=True)
    return pool["logits"][0]


def hold_against_static(chat, prompts, reqs) -> dict:
    """8 requests against the port's own static path on the card: dense
    whole-prompt prefill (first-token logits) and ``generate`` (streams)."""
    import torch

    from pathway_tpu_torch.models import decoder as D

    tok, dev, cfg = chat.tokenizer, chat.device, chat.cfg
    diffs, first_eq, streams_eq = [], 0, 0
    for p, r in zip(prompts[:8], reqs[:8]):
        ids = tok.encode(p)
        x = torch.tensor([ids], dtype=torch.int32, device=dev)
        m = torch.ones_like(x)
        static_logits, _ = D.prefill(chat.params, x, m, cfg, len(ids))
        served = paged_first_logits(chat, ids)
        diffs.append((served - static_logits[0]).abs().max().item())
        toks = D.generate(chat.params, x, m, cfg, MAX_NEW)[0].tolist()
        first_eq += int(r.tokens[0] == toks[0] == int(static_logits[0].argmax()))
        streams_eq += int(r.tokens == toks)
    return {"max_logit_diff": max(diffs), "first_equal": first_eq,
            "streams_equal": streams_eq}


def check_decoder_against_cpu(params, tok) -> None:
    """f32 at GPT-2 widths, 2 layers, int8 weights: the same paged serving
    pool functions (flash chunk pieces, paged-kernel decode, wq kernel) on
    the card and on the CPU (plain versions) agree on a small input."""
    import dataclasses

    import torch

    from pathway_tpu_torch.models import decoder as D

    cfg = dataclasses.replace(D.GPT2_SMALL, layers=2, dtype=torch.float32, wq_kernel=True)
    small = {k: v for k, v in params.items() if k != "layers"}
    small["layers"] = {k: v[:2] for k, v in params["layers"].items()}
    prompts = make_prompts(2, 40, 150, seed=5)
    out = {}
    for dev in ("cuda", "cpu"):
        p = D.quantize_params(D.map_params(lambda t: t.to(dev), small), cfg)
        M = CACHE_LEN // BLOCK
        pool = D.paged_pool_init(p, cfg, 2, CACHE_LEN, 2 * M + 1, BLOCK)
        for slot, text in enumerate(prompts):
            D.paged_table_set(pool, slot, np.arange(1, M + 1, dtype=np.int32) + slot * M)
            ids = tok.encode(text)
            n = len(ids)
            W = -(-n // PIECE) * PIECE
            a = np.zeros((3, 1, W), np.int32)
            a[0, 0, :n], a[1, 0, :n] = ids, 1
            a[2, 0] = np.minimum(np.arange(W), n - 1)
            for o in range(0, W, PIECE):
                last = o + PIECE >= W
                t = [torch.from_numpy(a[i][:, o:o + PIECE]).to(dev) for i in range(3)]
                D.pool_prefill_chunk(p, *t, pool, slot, o, n, cfg, first=o == 0, last=last,
                                     last_col=(n - 1) - (W - PIECE) if last else None,
                                     flash=True)
        first = pool["logits"].clone()
        pool, toks = D.pool_decode_chunk(p, pool, np.array([True, True]), None, cfg, 8,
                                         paged_kernel=True)
        out[dev] = (first.cpu(), pool["logits"].cpu(), toks.cpu())
    d0 = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    d1 = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    same = torch.equal(out["cuda"][2], out["cpu"][2])
    info(f"decoder card vs cpu (f32, 2 layers, int8 weights, paged + flash + wq kernels): "
         f"first-token logits max diff {d0:.3e}, after 8 steps {d1:.3e} (<= 1e-3), "
         f"tokens equal: {same}")
    require(d0 <= 1e-3 and d1 <= 1e-3 and same, "the card agrees with the CPU in f32")


def prefix_line(st: dict) -> str:
    return (f"{st['prefix_requests']} lookups, {st['prefix_hit_requests']} hits, "
            f"{st['prefix_hit_tokens']} hit tokens, {st['prefix_miss_tokens']} miss tokens")


def decoder_setup(dev):
    """GPT-2 small's seeded random weights, the byte tokenizer and the
    serving settings the decoder phases share."""
    import torch

    from pathway_tpu_torch.models import decoder as D

    params = D.init_params(torch.Generator().manual_seed(0), D.GPT2_SMALL)
    tok = byte_tokenizer()
    # plain chunks of fixed size, so the launch bars of phases 6, 7 and 9
    # count per decode step; phase 10 drives the spec and autotune defaults
    common = dict(params=params, cfg=D.GPT2_SMALL, tokenizer=tok, continuous=True,
                  n_slots=N_SLOTS, chunk_steps=16, max_new_tokens=MAX_NEW,
                  max_prompt_tokens=512, prefill_chunk=PIECE, weight_quant="int8",
                  wq_kernel=True, spec_decode=False, chunk_autotune=False, device=dev)
    return params, tok, common


def run_decoder(dev, gpu: str, params, tok, common) -> dict:
    """Phase 6; returns the summed launches of every decoder run."""
    from pathway_tpu_torch import DecoderChat

    t0 = time.perf_counter()
    chat = DecoderChat(paged_kv=True, paged_kv_block=BLOCK, paged_kernel=True,
                       flash_prefill=True, **common)
    info(f"decoder: GPT-2 small (vocab 50257, hidden 768, 12 layers, 12 heads, ffn "
         f"3072), seeded random weights, int8 weights; cache_len {chat.server.cache_len}, "
         f"{chat.server._total_blocks} blocks of {BLOCK}; set-up {time.perf_counter() - t0:.1f} s")
    require(chat.server.cache_len == CACHE_LEN, "paged cache_len is 704")
    serve(chat, make_prompts(4, 16, 200, seed=99))  # warm-up, outside the counts
    prompts = make_prompts(N_REQUESTS, 16, 480, seed=1)
    total = {n: 0 for n in counters()}
    out = serve(chat, prompts)
    st, ln = out["stats"], out["launches"]
    info(f"decoder main run [{gpu}]: {N_REQUESTS} requests x {MAX_NEW} tokens in "
         f"{out['wall_s']:.3f} s wall; decode {out['tok_per_s']:.1f} tokens/s; TTFT p50 "
         f"{out['ttft_p50_s'] * 1e3:.1f} ms; {st['decode_steps']} decode steps in "
         f"{st['chunks']} chunks, {st['prefill_chunks']} prefill pieces; launches {ln}")
    require(ln["paged_attn_decode"] >= 12 * st["decode_steps"] > 0,
            "every decode step and layer went through paged_attn_decode")
    require(ln["flash_chunk_attn_paged"] >= 12 * st["prefill_chunks"] > 0,
            "every prefill piece and layer went through flash_chunk_attn_paged")
    require(ln["wq_matmul"] >= 48 * (st["decode_steps"] + st["prefill_chunks"]),
            "every layer product went through wq_matmul")
    info(f"  prefix cache (default on): {prefix_line(st)}")
    total = {n: total[n] + ln[n] for n in total}
    chat.close()
    main_run = (chat, prompts, out["reqs"])

    chat = DecoderChat(paged_kv=True, paged_kv_block=BLOCK, paged_kernel=True,
                       flash_prefill=True, kv_quant="int8", **common)
    out = serve(chat, make_prompts(16, 16, 480, seed=2))
    st, ln = out["stats"], out["launches"]
    info(f"decoder int8-KV run [{gpu}]: 16 requests in {out['wall_s']:.3f} s wall; decode "
         f"{out['tok_per_s']:.1f} tokens/s; TTFT p50 {out['ttft_p50_s'] * 1e3:.1f} ms; "
         f"launches {ln}")
    require(ln["paged_attn_decode"] >= 12 * st["decode_steps"] > 0
            and ln["flash_chunk_attn_paged"] >= 12 * st["prefill_chunks"] > 0,
            "the int8-KV run went through the fused int8 kernels")
    info(f"  prefix cache (default on): {prefix_line(st)}")
    total = {n: total[n] + ln[n] for n in total}
    chat.close()

    chat = DecoderChat(paged_kv=False, flash_prefill=True, **common)
    prompts = make_prompts(12, 8, 64, seed=3) + make_prompts(4, 100, 200, seed=4)
    out = serve(chat, prompts)
    st, ln = out["stats"], out["launches"]
    info(f"decoder dense-pool run [{gpu}]: 16 requests in {out['wall_s']:.3f} s wall; "
         f"decode {out['tok_per_s']:.1f} tokens/s; TTFT p50 {out['ttft_p50_s'] * 1e3:.1f} "
         f"ms; {st['admit_dispatches']} whole-prompt admissions, {st['prefill_chunks']} "
         f"pieces; launches {ln}")
    require(ln["flash_attn"] >= 12 * st["admit_dispatches"] > 0,
            "every whole-prompt admission went through the causal flash_attn")
    require(ln["flash_chunk_attn"] >= 12 * st["prefill_chunks"] > 0,
            "every dense prefill piece went through flash_chunk_attn")
    require(ln["wq_matmul"] >= 48 * (st["decode_steps"] + st["prefill_chunks"]
                                     + st["admit_dispatches"]),
            "every layer product of the dense run went through wq_matmul")
    info(f"  prefix cache (default on): {prefix_line(st)}")
    total = {n: total[n] + ln[n] for n in total}
    chat.close()
    check_decoder_against_cpu(params, tok)
    held = hold_against_static(*main_run)
    info(f"decoder vs the port's static generate (8 requests of the main run): "
         f"first-token logits max diff {held['max_logit_diff']:.4f} (<= {LOGIT_TOL}); "
         f"first tokens equal {held['first_equal']}/8 (>= {MIN_FIRST_EQUAL}); 64-token "
         f"streams equal {held['streams_equal']}/8 (>= {MIN_STREAMS_EQUAL})")
    require(held["max_logit_diff"] <= LOGIT_TOL and held["first_equal"] >= MIN_FIRST_EQUAL
            and held["streams_equal"] >= MIN_STREAMS_EQUAL,
            "the server agrees with the static path")
    return total


# ---------------------------------------------------------------- phase 7
def check_shared_blocks(dev) -> None:
    """The paged kernels at the main-path widths over a cached head shared
    copy-on-write: two table rows whose first 4 entries are the same
    physical blocks; a suffix piece at start 256 over the second row (chunk
    kernel) and one decode step over both rows, each against its plain
    version; the shared blocks must not change."""
    import torch

    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.models import paged_attention as PA

    g = torch.Generator().manual_seed(12)
    nh, hd, M, n_shared = 12, 64, CACHE_LEN // BLOCK, SHARED_HEAD // BLOCK
    n_blocks = 2 * M + 1
    kb, vb = (torch.randn((n_blocks, nh, BLOCK, hd), generator=g).to(dev, torch.bfloat16)
              for _ in range(2))
    kb[0], vb[0] = 0, 0
    ids = torch.randperm(n_blocks - 1, generator=g) + 1
    tbl = torch.stack([ids[:M], torch.cat([ids[:n_shared], ids[M:2 * M - n_shared]])])
    tbl = tbl.to(torch.int32).to(dev)
    before = (kb.clone(), vb.clone())
    cols = torch.arange(CACHE_LEN)
    row_mask = (cols < SHARED_HEAD + PIECE).to(torch.int32).to(dev)
    q = torch.randn((nh, PIECE, hd), generator=g).to(dev, torch.bfloat16)
    out = FA.flash_chunk_attn_paged(q, kb, vb, None, None, tbl[1], row_mask, SHARED_HEAD)
    torch.cuda.synchronize()
    ref = FA.flash_chunk_attn_paged_reference(q, kb, vb, None, None, tbl[1], row_mask,
                                              SHARED_HEAD)
    err = (out - ref).abs().max().item()
    lens = torch.tensor([SHARED_HEAD + 200, SHARED_HEAD + 17])
    mask = (cols[None, :] < lens[:, None]).to(torch.int32).to(dev)
    qd = torch.randn((2, nh, hd), generator=g).to(dev, torch.bfloat16)
    dec = PA.paged_attn_decode(qd, kb, vb, None, None, tbl, mask)
    torch.cuda.synchronize()
    ref_d = PA.paged_attn_decode_reference(qd, kb, vb, None, None, tbl, mask)
    info(f"shared prefix blocks: flash_chunk_attn_paged at start {SHARED_HEAD} "
         f"max_abs_err={err:.3e} (atol 2e-3); paged_attn_decode max_abs_err="
         f"{(dec.float() - ref_d.float()).abs().max().item():.3e} (rtol 2^-7, atol 1e-3)")
    require(err <= 2e-3, "the chunk kernel over shared blocks agrees with its plain version")
    torch.testing.assert_close(dec.float(), ref_d.float(), rtol=2 ** -7, atol=1e-3)
    require(torch.equal(before[0], kb) and torch.equal(before[1], vb),
            "the kernels left the shared blocks unchanged")


def shared_prompts(head_len: int, lens: list[int], seed: int) -> list[str]:
    """One seeded head of ``head_len`` tokens, then a seeded suffix of each
    length in ``lens``."""
    rng = np.random.default_rng(seed)
    chars = np.array(list("abcdefghijklmnopqrstuvwxyz     ,."))
    head = "".join(rng.choice(chars, head_len))
    return [head + "".join(rng.choice(chars, int(k))) for k in lens]


def counting(D, names):
    """Wrap the decoder's pool functions ``names`` in call counters (the
    server calls them through the module); returns the counts and an undo."""
    calls = {n: 0 for n in names}
    orig = {n: getattr(D, n) for n in names}

    def wrap(n):
        def f(*a, **k):
            calls[n] += 1
            return orig[n](*a, **k)
        return f

    for n in names:
        setattr(D, n, wrap(n))
    return calls, lambda: [setattr(D, n, f) for n, f in orig.items()]


def streams(out) -> list:
    return [r.tokens for r in out["reqs"]]


def run_shared_prompt(gpu: str, tok, common) -> dict:
    """Phase 7; returns the summed launches of its cache-on runs."""
    from pathway_tpu_torch import DecoderChat
    from pathway_tpu_torch.engine import probes
    from pathway_tpu_torch.models import decoder as D

    total = {n: 0 for n in counters()}
    paged = dict(paged_kv=True, paged_kv_block=BLOCK, paged_kernel=True, flash_prefill=True)

    # paged tier 1: a warm-up request, then N_REQUESTS at once behind one head
    rng = np.random.default_rng(71)
    lens = rng.integers(16, 225, N_REQUESTS + 1).tolist()
    prompts = shared_prompts(SHARED_HEAD, lens, seed=70)
    arms = {}
    for on in (True, False):
        probes.reset_prefix_stats()
        chat = DecoderChat(prefix_cache=on, **paged, **common)
        warm = serve(chat, prompts[:1])
        out = serve(chat, prompts[1:])
        arms[on] = (warm, out, probes.prefix_stats())
        chat.close()
    (warm, out, ledger), (warm_off, out_off, _) = arms[True], arms[False]
    st, ln = out["stats"], out["launches"]
    suffix_pieces = sum(-(-k // PIECE) for k in lens[1:])
    for on, (w, o, _) in arms.items():
        info(f"shared-prompt paged run [{gpu}], cache {'on' if on else 'off'}: {N_REQUESTS} "
             f"requests behind a {SHARED_HEAD}-token head in {o['wall_s']:.3f} s wall "
             f"(warm-up request {w['wall_s']:.3f} s); decode {o['tok_per_s']:.1f} "
             f"tokens/s; TTFT p50 {o['ttft_p50_s'] * 1e3:.1f} ms; "
             f"{o['stats']['prefill_chunks']} prefill pieces; {prefix_line(o['stats'])}; "
             f"launches {o['launches']}")
    require(st["prefix_hit_requests"] == N_REQUESTS
            and st["prefix_hit_tokens"] == N_REQUESTS * SHARED_HEAD,
            f"all {N_REQUESTS} requests hit the {SHARED_HEAD}-token head")
    require(st["prefill_chunks"] == suffix_pieces,
            f"only the suffixes were prefilled ({suffix_pieces} pieces)")
    require(ln["flash_chunk_attn_paged"] >= 12 * st["prefill_chunks"] > 0,
            "every suffix piece and layer went through flash_chunk_attn_paged")
    require(ln["paged_attn_decode"] >= 12 * st["decode_steps"] > 0,
            "every decode step and layer went through paged_attn_decode")
    require(ledger["copy_bytes"] == 0, "paged hits shared blocks, copying no KV")
    require(streams(warm) + streams(out) == streams(warm_off) + streams(out_off),
            "cache-on streams equal the cache-off streams token for token (49)")
    total = {n: total[n] + warm["launches"][n] + ln[n] for n in total}

    # dense arena: a warm-up request, then 15 at once behind one head; every
    # prompt fills its 256-token bucket, so the cache-off admission (left-
    # padded to the bucket) lays tokens out as a hit (right-padded) does
    prompts = shared_prompts(DENSE_HEAD, [256 - DENSE_HEAD] * 16, seed=80)
    arms = {}
    for on in (True, False):
        calls, undo = counting(D, ("kv_extract", "pool_admit_cached"))
        try:
            chat = DecoderChat(paged_kv=False, flash_prefill=True, prefix_cache=on,
                               **common)
            warm = serve(chat, prompts[:1])
            out = serve(chat, prompts[1:])
            chat.close()
        finally:
            undo()
        arms[on] = (warm, out, calls)
    (warm, out, calls), (warm_off, out_off, _) = arms[True], arms[False]
    st, ln = out["stats"], out["launches"]
    for on, (w, o, c) in arms.items():
        info(f"dense-arena run [{gpu}], cache {'on' if on else 'off'}: 15 requests behind "
             f"a {DENSE_HEAD}-token head in {o['wall_s']:.3f} s wall; TTFT p50 "
             f"{o['ttft_p50_s'] * 1e3:.1f} ms; {o['stats']['prefill_chunks']} prefill "
             f"pieces; {prefix_line(o['stats'])}; calls {c}; launches {o['launches']}")
    require(st["prefix_hit_requests"] >= 15 and calls["pool_admit_cached"] >= 15
            and calls["kv_extract"] >= 1,
            "kv_extract published the head and pool_admit_cached seeded >= 15 hits")
    require(ln["flash_chunk_attn"] >= 12 * st["prefill_chunks"] > 0,
            "every dense suffix piece and layer went through flash_chunk_attn")
    require(streams(warm) + streams(out) == streams(warm_off) + streams(out_off),
            "dense cache-on streams equal the cache-off streams token for token (16)")
    total = {n: total[n] + warm["launches"][n] + ln[n] for n in total}

    # tier 2: six 192-token heads churn a 3-block tier 1 into a 64 MB host
    # tier; the first head comes back (a tier-2 hit, promoted), then again
    heads = [shared_prompts(T2_HEAD, [0], seed=90 + i)[0] for i in range(6)]
    trace = [h + "?" for h in heads] + [heads[0] + "?"]
    arms = {}
    for t2_mb in (64.0, 0.0):
        probes.reset_prefix_stats()
        probes.reset_stage_seconds()
        chat = DecoderChat(prefix_cache_mb=3 * KV_BLOCK_BYTES / 2 ** 20,
                           prefix_t2_mb=t2_mb, **paged, **common)
        runs = [serve(chat, [p]) for p in trace]
        drained = chat.server.t2_drain(timeout=60)
        runs.append(serve(chat, [heads[0] + "!"]))
        resident = chat.server.prefix.match(tok.encode(heads[0]))[0]
        stats = {k: sum(r["stats"][k] for r in runs) for k in runs[0]["stats"]}
        arms[t2_mb] = (runs, stats, probes.prefix_stats(), probes.stage_seconds(),
                       probes.stage_items(), drained, resident, chat.server.prefix)
        chat.close()
    runs, st, ledger, secs, items, drained, resident, prefix = arms[64.0]
    runs_off = arms[0.0][0]
    info(f"tier-2 run [{gpu}]: tier 1 {prefix.capacity_blocks} blocks, tier 2 "
         f"{prefix.tier2.capacity_blocks} blocks; {ledger['t2_demoted_blocks']} blocks "
         f"demoted, {ledger['t2_lookups']} lookups, {ledger['t2_hits']} hits, "
         f"{st['t2_promoted_blocks']} blocks promoted; export "
         f"{secs.get('t2_export', 0.0) * 1e3:.3f} ms for {items.get('t2_export', 0):.0f} "
         f"blocks, h2d {secs.get('t2_h2d', 0.0) * 1e3:.3f} ms for "
         f"{items.get('t2_h2d', 0):.0f} blocks; resident match {resident} blocks; TTFT "
         f"of the returning head {runs[6]['ttft_p50_s'] * 1e3:.1f} ms, of the last "
         f"request {runs[7]['ttft_p50_s'] * 1e3:.1f} ms (tier-2 off: "
         f"{arms[0.0][0][7]['ttft_p50_s'] * 1e3:.1f} ms)")
    require(drained, "every tier-2 promotion landed within 60 s")
    require(st["t2_hit_requests"] >= 1 and st["t2_promoted_blocks"] >= 1
            and st["t2_promoted_blocks"] == ledger["t2_hit_blocks"],
            "the returning head hit tier 2 and every hit block was promoted")
    require(resident == T2_HEAD // BLOCK, "the promoted head is resident (3 blocks)")
    require(arms[0.0][1]["t2_hit_requests"] == 0 and arms[0.0][7].tier2 is None,
            "the tier-2-off arm has no host tier")
    require([t for r in runs for t in streams(r)] == [t for r in runs_off for t in streams(r)],
            "tier-2 streams equal the tier-2-off streams token for token (8)")
    for r in runs:
        total = {n: total[n] + r["launches"][n] for n in total}
    return total


# ---------------------------------------------------------------- phase 8
def seam(dev, dedup: bool = True, native: bool = True, memo: bool = True, **model_kw):
    """The embedder seam over a fresh full-width MiniLM-L6 (bf16, seed 0,
    max_length 64), with the seam's default dedup LRU."""
    from pathway_tpu_torch import HashTokenizer
    from pathway_tpu_torch.models.embedder import SentenceEmbedderModel
    from pathway_tpu_torch.models.transformer import MINILM_L6
    from pathway_tpu_torch.xpacks.llm import SentenceTransformerEmbedder

    model = SentenceEmbedderModel(MINILM_L6, max_length=64, device=dev,
                                  tokenizer=HashTokenizer(max_length=64, native=native,
                                                          memo=memo),
                                  **model_kw)
    return SentenceTransformerEmbedder(model, dedup=dedup)


def ingest(emb, docs) -> dict:
    """One ingest through the engine's two-phase protocol: every batch of
    INGEST_BATCH through ``submit_batch``, then one ``resolve_batch``; the
    flash_attn count and the stage timer set to 0 just before, read after."""
    import torch

    from pathway_tpu_torch.engine import probes
    from pathway_tpu_torch.models import flash_attention as FA

    n_batches = -(-len(docs) // INGEST_BATCH)
    s0 = dict(emb.dedup_stats)
    FA.flash_attn.launches = 0
    probes.reset_stage_seconds()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [emb.submit_batch(docs[s : s + INGEST_BATCH])
               for s in range(0, len(docs), INGEST_BATCH)]
    out = emb.resolve_batch(handles, timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vecs = np.stack([v for batch in out for v in batch])
    if vecs.shape != (len(docs), emb.get_embedding_dimension()) or not np.all(np.isfinite(vecs)):
        raise AssertionError("the seam returned vectors of the wrong shape or not finite")
    return {"vecs": vecs, "n": len(docs), "wall_s": wall, "docs_per_s": len(docs) / wall,
            "launches": FA.flash_attn.launches,
            "stage_ms": {k: v / n_batches * 1e3 for k, v in probes.stage_seconds().items()},
            "hits": emb.dedup_stats["hits"] - s0["hits"],
            "misses": emb.dedup_stats["misses"] - s0["misses"]}


def tokenize_ms(docs) -> dict:
    """Host tokenize ms per INGEST_BATCH docs on this corpus: the Python
    path, the native path and native memo hits; native and memo ids must
    equal the Python ids over every doc."""
    from pathway_tpu_torch import HashTokenizer

    def run(tok):
        ids, ms = [], []
        for s in range(0, len(docs), INGEST_BATCH):
            t0 = time.perf_counter()
            ids.append(tok(docs[s : s + INGEST_BATCH], max_length=64)[0])
            ms.append((time.perf_counter() - t0) * 1e3)
        return ids, statistics.mean(ms)

    py_ids, py_ms = run(HashTokenizer(native=False, memo=False))
    nat_ids, nat_ms = run(HashTokenizer(memo=False))
    memo = HashTokenizer()
    run(memo)  # fills the memo
    hit_ids, hit_ms = run(memo)
    same = all(np.array_equal(a, b) and np.array_equal(a, c)
               for a, b, c in zip(py_ids, nat_ids, hit_ids))
    return {"python": py_ms, "native": nat_ms, "memo_hit": hit_ms, "same": same}


def run_ingest_seam(dev, gpu: str, docs) -> int:
    """Phase 8; returns its flash_attn launches."""
    import torch

    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.models.embedder import embed_fn
    from pathway_tpu_torch.models.tokenizer import pad_to_buckets
    from pathway_tpu_torch.xpacks.llm.embedders import DEDUP_MAX

    layers, n_batches = 6, N_DOCS // INGEST_BATCH
    tk = tokenize_ms(docs)
    info(f"host tokenize per {INGEST_BATCH} docs [{gpu}]: python {tk['python']:.3f} ms, "
         f"native {tk['native']:.3f} ms, memo hit {tk['memo_hit']:.3f} ms")
    require(tk["same"], f"native and memo-hit ids equal the Python ids over all {N_DOCS} docs")

    warm = [d + " warm" for d in docs[:INGEST_BATCH]]
    arms = {}
    for name, kw in (("a", dict(pipeline=False, native=False, memo=False, dedup=False)),
                     ("b", {}), ("c", dict(fused_h2d=False))):
        emb = seam(dev, **kw)
        emb.resolve_batch([emb.submit_batch(warm)], timeout=600)  # outside the counts
        emb.dedup_stats = {"hits": 0, "misses": 0}
        arms[name] = (emb, ingest(emb, docs))
    # (b)'s dedup LRU keeps DEDUP_MAX texts: the corpus's last ones
    emb_b, tail = arms["b"][0], N_DOCS - DEDUP_MAX
    re_docs = docs[tail:]
    arms["d"] = (emb_b, ingest(emb_b, re_docs))
    rng = np.random.default_rng(11)
    edited = set(rng.choice(len(re_docs), len(re_docs) // 4, replace=False).tolist())
    docs_e = list(re_docs)
    for i in sorted(edited):
        words = re_docs[i].split()
        words[int(rng.integers(len(words)))] = "edited"
        docs_e[i] = " ".join(words)
    arms["e"] = (emb_b, ingest(emb_b, docs_e))

    # device busy time of one batch's encode, for the idle shares
    ids, mask = pad_to_buckets(*emb_b.model.tokenizer(docs[:INGEST_BATCH], max_length=64))
    ids, mask = (torch.from_numpy(a).to(dev) for a in (ids, mask))
    busy_ms = cuda_time_ms(lambda: embed_fn(emb_b.model.params, ids, mask,
                                            emb_b.model.cfg), 3, warmup=1)
    FA.flash_attn.launches = 0
    labels = {"a": "serial (pipeline, native, memo, dedup off)", "b": "defaults",
              "c": "defaults, fused_h2d off",
              "d": f"re-ingest of the last {DEDUP_MAX}, all dedup hits",
              "e": f"re-ingest of the last {DEDUP_MAX}, a quarter rewritten"}
    for name, (_, r) in arms.items():
        st = r["stage_ms"]
        # an estimate, not a trace: the busy time of one full batch's encode
        # times the encodes, over the wall time; (e)'s miss batches are smaller
        idle = ("not measured" if name == "e" else
                f"{1.0 - busy_ms * r['launches'] / layers / (r['wall_s'] * 1e3):.3f}")
        info(f"ingest seam ({name}) {labels[name]} [{gpu}]: {r['docs_per_s']:.1f} docs/s "
             f"({r['wall_s'] * 1e3:.3f} ms for {r['n']}); stage ms per batch: "
             + ", ".join(f"{k} {st.get(k, 0.0):.3f}" for k in ("tokenize", "h2d", "dispatch",
                                                              "drain"))
             + f"; flash_attn launches {r['launches']}; dedup hits {r['hits']}, misses "
             f"{r['misses']}; device idle share estimate {idle} (device busy {busy_ms:.3f} ms "
             f"a batch)")
    a, b, c, d, e = (arms[k][1] for k in "abcde")
    for name in "abc":
        require(arms[name][1]["launches"] >= layers * n_batches,
                f"({name}): every encode went through flash_attn "
                f"({arms[name][1]['launches']} >= {layers * n_batches})")
    require(np.array_equal(b["vecs"], a["vecs"]), "(b) byte-equal to (a)")
    require(np.array_equal(c["vecs"], a["vecs"]), "(c) byte-equal to (a)")
    require(b["misses"] == len(set(docs)) and b["hits"] == N_DOCS - len(set(docs)),
            "(b) embedded every distinct doc once")
    n_re = len(re_docs)
    require(d["hits"] == n_re and d["misses"] == 0 and d["launches"] == 0,
            f"(d) served all {n_re} from the dedup with 0 flash_attn launches")
    require(np.array_equal(d["vecs"], b["vecs"][tail:]), "(d) vectors equal (b)'s")
    new = sorted(edited)
    fresh = {docs_e[i] for i in new} - set(re_docs)
    require(e["misses"] == len(fresh) and e["hits"] == n_re - len(fresh),
            f"(e) exactly the {len(fresh)} rewritten docs are misses")
    kept = np.array(sorted(set(range(n_re)) - edited))
    require(np.array_equal(e["vecs"][kept], b["vecs"][tail + kept]),
            "(e) unchanged docs keep (b)'s vectors")
    serial = arms["a"][0].model
    same = True
    for s in range(0, n_re, INGEST_BATCH):
        rows = [i for i in new if s <= i < s + INGEST_BATCH and docs_e[i] in fresh]
        miss = list(dict.fromkeys(docs_e[i] for i in rows))  # the batch's miss subset
        ref = dict(zip(miss, serial.embed_batch(miss)))
        same &= all(np.array_equal(e["vecs"][i], ref[docs_e[i]]) for i in rows)
    require(same, "(e) rewritten docs byte-equal to a serial embed of the same miss batches")
    require(e["launches"] >= layers * (n_re // INGEST_BATCH),
            "(e) every miss batch went through flash_attn")
    for emb, _ in arms.values():
        emb.close()
    return sum(arms[k][1]["launches"] for k in "abce")


# ---------------------------------------------------------------- phase 9
def write_safetensors(path, tensors: dict) -> None:
    """numpy f32 arrays -> ``model.safetensors`` (u64 header length, JSON
    header of dtype / shape / byte offsets, the raw little-endian data)."""
    header, offset = {}, 0
    for name, a in tensors.items():
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for a in tensors.values():
            f.write(np.ascontiguousarray(a, dtype="<f4").tobytes())


def minilm_checkpoint(path, cfg) -> None:
    """A seeded random ``BertModel`` of ``cfg``'s widths (MiniLM-L6) under HF
    names (torch Linear layout, out x in), its ``config.json`` and a
    synthetic ``vocab.txt`` of ``cfg.vocab_size`` (30,522) tokens: BERT's
    specials at their ids, single characters, all two- and three-letter
    words, their ``##`` continuations, filler."""
    import itertools
    import os

    rng = np.random.default_rng(5)
    V, H, L, I = cfg.vocab_size, cfg.hidden, cfg.layers, cfg.intermediate

    def normal(*shape):
        return rng.normal(0.0, 0.02, shape).astype(np.float32)

    def ln(prefix, sd):
        sd[prefix + ".weight"] = (1.0 + rng.normal(0, 0.1, H)).astype(np.float32)
        sd[prefix + ".bias"] = normal(H)

    sd = {"embeddings.word_embeddings.weight": normal(V, H),
          "embeddings.position_embeddings.weight": normal(512, H),
          "embeddings.token_type_embeddings.weight": normal(2, H)}
    ln("embeddings.LayerNorm", sd)
    for i in range(L):
        p = f"encoder.layer.{i}."
        for m in ("query", "key", "value"):
            sd[p + f"attention.self.{m}.weight"] = normal(H, H)
            sd[p + f"attention.self.{m}.bias"] = normal(H)
        sd[p + "attention.output.dense.weight"] = normal(H, H)
        sd[p + "attention.output.dense.bias"] = normal(H)
        ln(p + "attention.output.LayerNorm", sd)
        sd[p + "intermediate.dense.weight"] = normal(I, H)
        sd[p + "intermediate.dense.bias"] = normal(I)
        sd[p + "output.dense.weight"] = normal(H, I)
        sd[p + "output.dense.bias"] = normal(H)
        ln(p + "output.LayerNorm", sd)
    sd["pooler.dense.weight"], sd["pooler.dense.bias"] = normal(H, H), normal(H)
    write_safetensors(os.path.join(path, "model.safetensors"), sd)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "bert", "vocab_size": V, "hidden_size": H,
                   "num_hidden_layers": L, "num_attention_heads": cfg.heads,
                   "intermediate_size": I, "max_position_embeddings": 512,
                   "type_vocab_size": 2, "layer_norm_eps": 1e-12, "hidden_act": "gelu"}, f)
    letters = "abcdefghijklmnopqrstuvwxyz"
    singles = list(letters + "0123456789") + [chr(c) for c in range(33, 127)
                                              if not chr(c).isalnum()]
    words = ["".join(w) for n in (2, 3) for w in itertools.product(letters, repeat=n)]
    tokens = [f"[unused{i}]" for i in range(100)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tokens[0] = "[PAD]"
    tokens += singles + words + ["##" + t for t in list(letters + "0123456789") + words[:676]]
    tokens += [f"[unused{i}]" for i in range(100, 100 + V - len(tokens))]
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(tokens) + "\n")


def gpt2_checkpoint(path, cfg) -> None:
    """A seeded random GPT-2 state dict of ``cfg``'s widths (GPT-2 small)
    under HF names (Conv1D layout, in x out) as ``pytorch_model.bin``, its
    ``config.json`` and phase 6's 256-symbol byte-level ``vocab.json`` /
    ``merges.txt``."""
    import os

    import torch

    from pathway_tpu_torch.models.bpe import bytes_to_unicode

    g = torch.Generator().manual_seed(9)
    H, L, I = cfg.hidden, cfg.layers, cfg.intermediate
    V, P = cfg.vocab_size, cfg.max_position

    def normal(*shape):
        return torch.randn(shape, generator=g) * 0.02

    sd = {"transformer.wte.weight": normal(V, H), "transformer.wpe.weight": normal(P, H),
          "transformer.ln_f.weight": torch.ones(H), "transformer.ln_f.bias": torch.zeros(H)}
    for i in range(L):
        p = f"transformer.h.{i}."
        for n in ("ln_1", "ln_2"):
            sd[p + n + ".weight"], sd[p + n + ".bias"] = torch.ones(H), normal(H)
        sd[p + "attn.c_attn.weight"], sd[p + "attn.c_attn.bias"] = normal(H, 3 * H), normal(3 * H)
        sd[p + "attn.c_proj.weight"], sd[p + "attn.c_proj.bias"] = normal(H, H), normal(H)
        sd[p + "mlp.c_fc.weight"], sd[p + "mlp.c_fc.bias"] = normal(H, I), normal(I)
        sd[p + "mlp.c_proj.weight"], sd[p + "mlp.c_proj.bias"] = normal(I, H), normal(H)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "gpt2", "vocab_size": V, "n_positions": P, "n_embd": H,
                   "n_layer": L, "n_head": cfg.heads}, f)
    b2u = bytes_to_unicode()
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({b2u[i]: i for i in range(256)}, f)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")


def run_checkpoints(dev, gpu: str, docs) -> dict:
    """Phase 9; returns the launches of its kernel runs."""
    import dataclasses
    import os
    import tempfile

    import torch

    from pathway_tpu_torch import DecoderChat
    from pathway_tpu_torch.models import decoder as D
    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.models.checkpoint import load_encoder_checkpoint
    from pathway_tpu_torch.models.embedder import SentenceEmbedderModel
    from pathway_tpu_torch.models.params import from_jax_params
    from pathway_tpu_torch.models.tokenizer import WordPieceTokenizer
    from pathway_tpu_torch.models.transformer import MINILM_L6
    from pathway_tpu_torch.xpacks.llm import SentenceTransformerEmbedder

    total = {n: 0 for n in counters()}
    with tempfile.TemporaryDirectory() as tmp:
        enc_dir, dec_dir = os.path.join(tmp, "minilm"), os.path.join(tmp, "gpt2")
        os.mkdir(enc_dir)
        os.mkdir(dec_dir)
        t0 = time.perf_counter()
        minilm_checkpoint(enc_dir, MINILM_L6)
        gpt2_checkpoint(dec_dir, D.GPT2_SMALL)
        info(f"checkpoints written in {time.perf_counter() - t0:.1f} s: MiniLM-L6 "
             f"model.safetensors {os.path.getsize(os.path.join(enc_dir, 'model.safetensors'))} "
             f"B, GPT-2 small pytorch_model.bin "
             f"{os.path.getsize(os.path.join(dec_dir, 'pytorch_model.bin'))} B")

        vocab = os.path.join(enc_dir, "vocab.txt")
        wp_py = WordPieceTokenizer.from_vocab_file(vocab, max_length=64, native=False,
                                                   memo=False)
        wp_nat = WordPieceTokenizer.from_vocab_file(vocab, max_length=64, memo=False)
        ms = {"python": [], "native": []}
        same = True
        for s in range(0, len(docs), INGEST_BATCH):
            outs = []
            for name, tok in (("python", wp_py), ("native", wp_nat)):
                t1 = time.perf_counter()
                outs.append(tok(docs[s : s + INGEST_BATCH]))
                ms[name].append((time.perf_counter() - t1) * 1e3)
            same &= all(np.array_equal(x, y) for x, y in zip(*outs))
        info(f"WordPiece tokenize per {INGEST_BATCH} docs [{gpu}]: python "
             f"{statistics.mean(ms['python']):.3f} ms, native {statistics.mean(ms['native']):.3f} ms")
        require(same, f"native WordPiece ids equal the Python ids over all {len(docs)} docs")

        np_params, cfg, head = load_encoder_checkpoint(enc_dir)
        require(head is None and cfg == MINILM_L6, "the MiniLM-L6 config loaded from config.json")
        texts = docs[:64]
        f32 = dataclasses.replace(cfg, dtype=torch.float32)
        FA.flash_attn.launches = 0
        e32 = [SentenceEmbedderModel(f32, params=from_jax_params(np_params),
                                     tokenizer=WordPieceTokenizer.from_vocab_file(vocab),
                                     max_length=64, device=d, pipeline=False).embed_batch(texts)
               for d in (dev, "cpu")]
        cos = float(np.min(np.sum(e32[0] * e32[1], axis=1)))
        total["flash_attn"] += FA.flash_attn.launches
        info(f"checkpoint encoder card vs cpu (f32, WordPiece): min cosine {cos:.7f} "
             f"(>= 0.99999); flash_attn launches {FA.flash_attn.launches}")
        require(cos >= 0.99999 and FA.flash_attn.launches >= cfg.layers,
                "the checkpoint-loaded encoder on the card agrees with the CPU")

        emb = SentenceTransformerEmbedder(SentenceEmbedderModel(
            cfg, params=from_jax_params(np_params),
            tokenizer=WordPieceTokenizer.from_vocab_file(vocab), max_length=64, device=dev))
        emb.resolve_batch([emb.submit_batch([d + " warm" for d in docs[:256]])], timeout=600)
        part = docs[: 2 * INGEST_BATCH]
        r = ingest(emb, part)
        emb.close()
        total["flash_attn"] += r["launches"]
        info(f"checkpoint encoder ingest, WordPiece, defaults [{gpu}]: {r['docs_per_s']:.1f} "
             f"docs/s over {len(part)} docs; flash_attn launches {r['launches']}")
        require(r["launches"] >= cfg.layers * 2 and r["misses"] == len(set(part))
                and np.allclose(np.linalg.norm(r["vecs"], axis=1), 1.0, atol=1e-3),
                "the checkpoint-loaded ingest went through flash_attn, unit vectors")

        t0 = time.perf_counter()
        chat = DecoderChat(checkpoint_path=dec_dir, continuous=True, n_slots=N_SLOTS,
                           chunk_steps=16, max_new_tokens=MAX_NEW, max_prompt_tokens=512,
                           prefill_chunk=PIECE, weight_quant="int8", wq_kernel=True,
                           paged_kv=True, paged_kv_block=BLOCK, paged_kernel=True,
                           flash_prefill=True, spec_decode=False, chunk_autotune=False,
                           device=dev)
        info(f"DecoderChat(checkpoint_path=...): loaded in {time.perf_counter() - t0:.1f} s")
        require(dataclasses.replace(chat.cfg, wq_kernel=False) == D.GPT2_SMALL
                and chat.tokenizer.vocab_size == 256,
                "GPT-2 small and the byte-level tokenizer loaded from the directory")
        serve(chat, make_prompts(4, 16, 200, seed=98))  # warm-up, outside the counts
        prompts = make_prompts(8, 16, 480, seed=12)
        out = serve(chat, prompts)
        st, ln = out["stats"], out["launches"]
        info(f"checkpoint decoder [{gpu}]: 8 requests x {MAX_NEW} tokens in "
             f"{out['wall_s']:.3f} s wall; decode {out['tok_per_s']:.1f} tokens/s; launches {ln}")
        require(ln["paged_attn_decode"] >= 12 * st["decode_steps"] > 0
                and ln["flash_chunk_attn_paged"] >= 12 * st["prefill_chunks"] > 0
                and ln["wq_matmul"] >= 48 * (st["decode_steps"] + st["prefill_chunks"]),
                "the checkpoint-loaded server went through the paged, chunk and wq kernels")
        total = {n: total[n] + ln[n] for n in total}
        chat.close()
        held = hold_against_static(chat, prompts, out["reqs"])
        info(f"checkpoint decoder vs the port's static generate (8 requests): first-token "
             f"logits max diff {held['max_logit_diff']:.4f} (<= {LOGIT_TOL}); first tokens "
             f"equal {held['first_equal']}/8 (>= {MIN_FIRST_EQUAL}); 64-token streams equal "
             f"{held['streams_equal']}/8")
        require(held["max_logit_diff"] <= LOGIT_TOL and held["first_equal"] >= MIN_FIRST_EQUAL,
                "the checkpoint-loaded server agrees with the static path")
    return total


# ---------------------------------------------------------------- phase 10
SPEC_K, TOP2_TIE = 3, 1e-4


def plain_greedy_with_gaps(params, pool, cfg, n_new: int):
    """Plain greedy ``pool_decode_chunk``, one step a call over every lane:
    each lane's tokens and, for each token, the top-2 gap of the staged
    logits it was taken from."""
    import torch

    from pathway_tpu_torch.models import decoder as D

    active = np.ones(pool["logits"].shape[0], bool)
    toks, gaps = [], []
    for _ in range(n_new):
        top2 = pool["logits"].topk(2, dim=-1).values
        gaps.append(top2[:, 0] - top2[:, 1])
        pool, t = D.pool_decode_chunk(params, pool, active, None, cfg, 1)
        toks.append(t[0])
    return torch.stack(toks, 1).cpu().tolist(), torch.stack(gaps, 1).cpu().tolist()


def spec_streams(params, pool, cfg, n_new: int, draft_layers: int):
    """``pool_decode_spec`` four cycles a call, each lane active until it
    has ``n_new`` tokens; returns the streams and the acceptance rate."""
    from pathway_tpu_torch.models import decoder as D

    out = [[] for _ in range(pool["logits"].shape[0])]
    drafted = accepted = 0
    while True:
        need = np.array([len(s) < n_new for s in out])
        if not need.any():
            break
        pool, toks, emit = D.pool_decode_spec(params, pool, need, cfg, 4,
                                              draft_layers=draft_layers, n_spec=SPEC_K)
        toks, emit = toks.cpu().numpy(), emit.cpu().numpy()
        for b in np.nonzero(need)[0]:
            for c in range(toks.shape[0]):
                out[b].extend(toks[c, b, :emit[c, b]].tolist())
        drafted += 4 * int(need.sum()) * SPEC_K
        accepted += int(emit[:, need].sum()) - 4 * int(need.sum())
    return [s[:n_new] for s in out], accepted / drafted


def check_spec_pool(dev, gpu: str, params, tok) -> None:
    """Phase 10a: f32 at full GPT-2-small width, 16 prompts of 16-480
    tokens left-padded to 512 in a dense pool; spec with the auto draft and
    with a full-depth draft against plain greedy. A divergence is allowed
    only where the plain run's top-2 logit gap is under TOP2_TIE."""
    import dataclasses

    import torch

    from pathway_tpu_torch.models import decoder as D

    cfg = dataclasses.replace(D.GPT2_SMALL, dtype=torch.float32)
    p = D.map_params(lambda t: t.to(dev), params)
    S, C = 512, 640
    ids = np.zeros((N_SLOTS, S), np.int32)
    mask = np.zeros((N_SLOTS, S), np.int32)
    for r, text in enumerate(make_prompts(N_SLOTS, 16, 480, seed=10)):
        e = tok.encode(text)
        ids[r, S - len(e):], mask[r, S - len(e):] = e, 1
    pool = D.pool_admit_batch(p, torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev),
                              D.pool_init(p, cfg, N_SLOTS, C), list(range(N_SLOTS)), cfg)
    plain, gaps = plain_greedy_with_gaps(p, {k: v.clone() for k, v in pool.items()}, cfg,
                                         MAX_NEW)
    for name, dl in (("auto draft (3 layers)", max(1, cfg.layers // 4)),
                     ("full-depth draft (12 layers)", cfg.layers)):
        got, rate = spec_streams(p, {k: v.clone() for k, v in pool.items()}, cfg, MAX_NEW, dl)
        div = []
        for b in range(N_SLOTS):
            j = next((i for i, (x, y) in enumerate(zip(got[b], plain[b])) if x != y), None)
            if j is not None:
                div.append((b, j, gaps[b][j]))
        info(f"spec vs plain greedy [{gpu}], f32 GPT-2 small, dense pool, {name}, k={SPEC_K}: "
             f"acceptance {rate:.4f}; {N_SLOTS - len(div)}/{N_SLOTS} streams of {MAX_NEW} "
             f"equal; divergences (lane, position, plain top-2 gap): {div}")
        require(all(g < TOP2_TIE for _, _, g in div),
                f"{name}: every divergence is at a near-tie (top-2 gap < {TOP2_TIE})")


def step_histogram(D):
    """Wrap the decoder's two decode dispatches (the server calls them
    through the module) to count each dispatch's steps or cycles; returns
    the histogram and an undo. A paged pool's gathered view re-enters the
    same function, which is not counted again."""
    hist: dict = {}
    depth = [0]
    chunk, spec = D.pool_decode_chunk, D.pool_decode_spec

    def count(key, fn, *a, **kw):
        if depth[0] == 0:
            hist[key] = hist.get(key, 0) + 1
        depth[0] += 1
        try:
            return fn(*a, **kw)
        finally:
            depth[0] -= 1

    def plain(params, pool, active, gen, cfg, n_steps, **kw):
        return count(f"plain {n_steps}", chunk, params, pool, active, gen, cfg, n_steps, **kw)

    def cycles(params, pool, active, cfg, n_cycles, **kw):
        return count(f"spec {n_cycles}", spec, params, pool, active, cfg, n_cycles, **kw)

    D.pool_decode_chunk, D.pool_decode_spec = plain, cycles

    def undo():
        D.pool_decode_chunk, D.pool_decode_spec = chunk, spec
    return hist, undo


def run_spec_serving(gpu: str, tok, common) -> dict:
    """Phases 10b and 10c; returns their summed launches."""
    from pathway_tpu_torch import DecoderChat
    from pathway_tpu_torch.engine import probes
    from pathway_tpu_torch.models import decoder as D

    base = dict(common, paged_kv=True, paged_kv_block=BLOCK, paged_kernel=True,
                flash_prefill=True)
    total = {n: 0 for n in counters()}
    # a throwaway server warms the spec path's shapes (its latch state and
    # prefix tree must not carry into a measured arm)
    chat = DecoderChat(**dict(base, spec_decode=None, chunk_autotune=None))
    serve(chat, make_prompts(4, 16, 200, seed=99))
    chat.close()

    prompts = make_prompts(N_REQUESTS, 16, 480, seed=1)
    arms = {"spec and autotune off": dict(spec_decode=False, chunk_autotune=False),
            "defaults (spec and autotune on)": dict(spec_decode=None, chunk_autotune=None),
            "11-layer draft, autotune off": dict(spec_decode=None, spec_draft_layers=11,
                                                 chunk_autotune=False)}
    runs = {}
    for name, kw in arms.items():
        chat = DecoderChat(**dict(base, **kw))
        srv = chat.server
        probes.reset_spec_stats()
        hist, undo = step_histogram(D)
        try:
            out = serve(chat, prompts)
        finally:
            undo()
            chat.close()
        st, ln, L = out["stats"], out["launches"], srv.cfg.layers
        plain_steps = st["decode_steps"] - st["spec_cycles"]
        latch = (f"engaged at drain {srv.spec_latched_at}" if srv.spec_latched_at
                 else "not engaged")
        info(f"spec serving [{gpu}], {name}: {N_REQUESTS} requests x {MAX_NEW} tokens in "
             f"{out['wall_s']:.3f} s wall; decode {out['tok_per_s']:.1f} tokens/s; TTFT p50 "
             f"{out['ttft_p50_s'] * 1e3:.1f} ms; spec {srv.spec_decode} (draft "
             f"{srv.spec_draft_layers} layers, k {srv.spec_k}); acceptance "
             f"{srv.spec_acceptance():.4f}, tokens per dispatch {srv.tokens_per_dispatch():.4f}; "
             f"latch {latch}; {st['spec_dispatches']} spec dispatches ({st['spec_cycles']} "
             f"cycles), {plain_steps} plain steps in {st['chunks'] - st['spec_dispatches']} "
             f"chunks; chunk steps histogram {dict(sorted(hist.items()))}; ledger "
             f"{probes.spec_stats()}; launches {ln}")
        require(ln["flash_chunk_attn_paged"] >= L * st["prefill_chunks"] > 0,
                f"{name}: every prefill piece went through flash_chunk_attn_paged")
        require(ln["paged_attn_decode"] >= L * plain_steps,
                f"{name}: every plain decode step went through paged_attn_decode")
        wq_spec = 4 * (srv.spec_draft_layers * srv.spec_k + L) * st["spec_cycles"]
        wq_need = wq_spec + 4 * L * (plain_steps + st["prefill_chunks"])
        require(ln["wq_matmul"] >= wq_need,
                f"{name}: every draft step, verify layer, plain step and piece went "
                f"through wq_matmul ({ln['wq_matmul']} >= {wq_need}, {wq_spec} of them "
                f"for the spec cycles)")
        require((st["spec_dispatches"] > 0) == srv.spec_decode,
                f"{name}: spec dispatches ran exactly when spec is on")
        total = {n: total[n] + ln[n] for n in total}
        runs[name] = out
    off = [r.tokens for r in runs["spec and autotune off"]["reqs"]]
    for name in list(arms)[1:]:
        got = [r.tokens for r in runs[name]["reqs"]]
        first = sum(a[0] == b[0] for a, b in zip(got, off))
        same = sum(a == b for a, b in zip(got, off))
        info(f"  {name} vs spec off: first tokens equal {first}/{N_REQUESTS}; "
             f"{MAX_NEW}-token streams equal {same}/{N_REQUESTS} (>= {N_REQUESTS * 3 // 8})")
        require(first == N_REQUESTS and same >= N_REQUESTS * 3 // 8,
                f"{name}: the spec streams agree with spec off")

    # 10c: autotune on against off, spec off, 6 seeded waves of 8
    prompts = make_prompts(48, 16, 480, seed=13)
    gaps = np.random.default_rng(13).uniform(0.05, 0.5, 5).tolist()
    waves = {}
    for on in (True, False):
        chat = DecoderChat(**dict(base, spec_decode=False, chunk_autotune=on))
        srv = chat.server
        pick, branches = srv._pick_steps, {"queue": 0, "arrival gap": 0, "no estimate": 0}

        def counted(q, srv=srv, pick=pick, branches=branches):
            if q > 0:
                branches["queue"] += 1
            elif srv._arrival_ema is None or not srv._step_wall_ema:
                branches["no estimate"] += 1
            else:
                branches["arrival gap"] += 1
            return pick(q)

        srv._pick_steps = counted
        hist, undo = step_histogram(D)
        try:
            out = serve(chat, prompts, gaps)
        finally:
            undo()
            chat.close()
        ln = out["launches"]
        info(f"autotune {'on' if on else 'off'} [{gpu}], spec off, 6 waves of 8 (gaps "
             f"{[round(g, 3) for g in gaps]} s): {out['wall_s']:.3f} s wall; decode "
             f"{out['tok_per_s']:.1f} tokens/s; TTFT p50 {out['ttft_p50_s'] * 1e3:.1f} ms; "
             f"step choices {branches}; chunk steps histogram {dict(sorted(hist.items()))}; "
             f"launches {ln}")
        require(ln["paged_attn_decode"] >= srv.cfg.layers * out["stats"]["decode_steps"] > 0,
                "every decode step went through paged_attn_decode")
        total = {n: total[n] + ln[n] for n in total}
        waves[on] = (out, branches)
    (on_out, branches), (off_out, _) = waves[True], waves[False]
    require(branches["queue"] > 0 and branches["arrival gap"] > 0,
            "autotune chose steps under queue pressure and from the arrival gap")
    require(streams(on_out) == streams(off_out),
            "autotune on streams equal autotune off token for token (48)")
    return total


# ---------------------------------------------------------------- phase 11
SPAN_ORDER = ("enqueue", "admit", "first_token", "drain")
INGEST_EVENTS = ["enqueue", "admit", "tokenize", "h2d", "dispatch", "drain"]


def first_times(span: dict) -> dict:
    out: dict = {}
    for e in span["events"]:
        out.setdefault(e["name"], e["t_ms"])
    return out


def gauges_caught_up(srv, probes, timeout: float = 10.0) -> bool:
    """Wait (bounded) until the occupancy gauge holds the server's current
    occupancy: the loop writes it when it goes idle after a burst."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if probes.serving_snapshot()["occupancy"].get(srv._trace_tag) == round(
                srv.occupancy(), 4):
            return True
        time.sleep(0.005)
    return False


def telemetry_arm(chat, prompts, on: bool) -> dict:
    """One serve() of ``prompts`` with metrics on or off, the registry and
    the trace ring emptied just before; the prefix tree is dropped after,
    so every arm admits the same prompts cold."""
    from pathway_tpu_torch.engine import probes, tracing

    probes.set_metrics(on)
    probes.REGISTRY.reset()
    tracing.reset_traces()
    try:
        out = serve(chat, prompts)
        srv = chat.server
        out["caught_up"] = (not on) or gauges_caught_up(srv, probes)
        out["spans"] = chat.recent_traces()
        out["snapshot"] = probes.REGISTRY.snapshot()
        out["serving"] = probes.serving_snapshot()
        out["occupancy"] = srv.occupancy()
        out["frag"] = srv.kv_fragmentation()
        out["ttft_hist"] = probes.REGISTRY.hist_summary("ttft_seconds", phase="decode")
    finally:
        probes.set_metrics(True)
    srv.prefix_reset()
    return out


def run_telemetry_serving(dev, gpu: str, common) -> dict:
    """Phase 11 (a), (b) and (e); returns the launches of its runs."""
    import tempfile

    import torch

    from pathway_tpu_torch import DecoderChat
    from pathway_tpu_torch.engine import probes, tracing
    from pathway_tpu_torch.models import decoder as D

    probes.reset_hbm_stats()
    chat = DecoderChat(paged_kv=True, paged_kv_block=BLOCK, paged_kernel=True,
                       flash_prefill=True, **common)
    srv = chat.server
    # (b) the HBM ledger, recorded at weight placement and pool build
    hbm = probes.hbm_stats()
    comps = dict(hbm["current_bytes"])
    weights = sum(t.numel() * t.element_size() for t in D._tensor_leaves(chat.params))
    allocated = torch.cuda.memory_allocated(dev)
    info(f"telemetry (b) HBM ledger [{gpu}]: {comps}; total "
         f"{hbm['current_total_bytes']} bytes, torch.cuda.memory_allocated {allocated}")
    require(comps.pop("weights.decoder") == weights,
            f"(b) weights.decoder equals the served params' bytes ({weights})")
    require(sum(comps.values()) == D.pool_bytes(srv.pool),
            f"(b) the pool components sum to pool_bytes ({D.pool_bytes(srv.pool)})")
    require(hbm["current_total_bytes"] <= allocated,
            "(b) the ledger total is at most torch.cuda.memory_allocated")

    # (a) metrics on against off, phase 6's burst: one pair of arms, on, off
    serve(chat, make_prompts(4, 16, 200, seed=99))  # warm-up, outside the counts
    srv.prefix_reset()
    prompts = make_prompts(N_REQUESTS, 16, 480, seed=1)
    runs = [(on, telemetry_arm(chat, prompts, on)) for on in (True, False)]
    total = {n: sum(r["launches"][n] for _, r in runs) for n in counters()}
    streams = [[r.tokens for r in out["reqs"]] for _, out in runs]
    for i, (on, out) in enumerate(runs):
        info(f"telemetry (a) run {i + 1}, metrics {'on' if on else 'off'} [{gpu}]: "
             f"{N_REQUESTS} requests in {out['wall_s']:.3f} s wall; decode "
             f"{out['tok_per_s']:.1f} tokens/s; TTFT p50 {out['ttft_p50_s'] * 1e3:.1f} ms; "
             f"spans {len(out['spans'])}")
    require(all(s == streams[0] for s in streams),
            f"(a) the {N_REQUESTS} greedy streams are equal token for token, metrics on and off")
    for on, out in runs:
        if not on:
            require(out["spans"] == [] and out["snapshot"] == {
                "counters": {}, "gauges": {}, "histograms": {}},
                "(a) metrics off: no span, an empty registry snapshot")
            continue
        spans = out["spans"]
        ordered = all(
            all(k in first_times(s) for k in SPAN_ORDER)
            and [first_times(s)[k] for k in SPAN_ORDER] == sorted(
                first_times(s)[k] for k in SPAN_ORDER)
            and s["metrics"]["queue_wait_ms"] <= s["metrics"]["ttft_ms"]
            <= s["metrics"]["e2e_ms"] and s["attrs"]["tokens"] == MAX_NEW
            for s in spans)
        require(len(spans) == N_REQUESTS and ordered,
                f"(a) {N_REQUESTS} complete decode spans, enqueue <= admit <= first_token "
                f"<= drain and queue_wait <= ttft <= e2e in each")
        h = out["ttft_hist"]
        require(h is not None, "(a) the ttft_seconds histogram has observations")
        ratio = h["p50"] / out["ttft_p50_s"]
        info(f"  registry TTFT p50 {h['p50'] * 1e3:.1f} ms over {h['count']} vs "
             f"first_token_at p50 {out['ttft_p50_s'] * 1e3:.1f} ms (ratio {ratio:.4f}); "
             f"occupancy {out['occupancy']:.4f}; kv fragmentation {out['frag']}")
        require(h["count"] == N_REQUESTS and 0.5 <= ratio <= 2.0,
                f"(a) ttft_seconds counts {N_REQUESTS}, its p50 within one log-2 bucket "
                f"of serve()'s")
        require(out["caught_up"] and out["serving"]["occupancy"] == {
            srv._trace_tag: round(out["occupancy"], 4)},
            "(a) serving_snapshot()['occupancy'] equals server.occupancy()")
        require(0.0 <= out["frag"]["current"] < 1.0,
                "(a) kv_fragmentation()['current'] in [0, 1)")
    arm = {on: [out for o, out in runs if o == on] for on in (True, False)}
    tps = {on: statistics.mean(o["tok_per_s"] for o in arm[on]) for on in arm}
    ttft = {on: statistics.mean(o["ttft_p50_s"] for o in arm[on]) * 1e3 for on in arm}
    info(f"telemetry (a) cost [{gpu}]: decode tokens/s on {tps[True]:.1f} / off "
         f"{tps[False]:.1f} (on/off {tps[True] / tps[False]:.4f}); TTFT p50 ms on "
         f"{ttft[True]:.1f} / off {ttft[False]:.1f} (on/off {ttft[True] / ttft[False]:.4f})")

    # (e) the flight recorder around a burst of 8
    with tempfile.TemporaryDirectory() as tmp:
        tracing.configure(trace_dir=tmp)
        try:
            out = serve(chat, make_prompts(8, 16, 200, seed=12))
            total = {n: total[n] + out["launches"][n] for n in total}
            chat.close()
        finally:
            tracing.configure()
        path = f"{tmp}/trace-{os.getpid()}.jsonl"
        with open(path, encoding="utf-8") as f:
            recs = [json.loads(line) for line in f if line.strip()]
    info(f"telemetry (e) flight recorder: {len(recs)} lines after close()")
    require(len(recs) == 8 and all(r["kind"] == "decode" and r["server"] == srv._trace_tag
                                   for r in recs),
            "(e) the recorder file holds the burst's 8 decode lines after close()")
    return total


def run_telemetry_ingest(dev, gpu: str, docs) -> int:
    """Phase 11 (c): the defaults seam with metrics on and off, in turns;
    returns the flash_attn launches of its ingests."""
    from pathway_tpu_torch.engine import probes
    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.models.tokenizer import pad_to_buckets

    warm = [d + " warm" for d in docs[:INGEST_BATCH]]
    runs, launches = [], 0
    for on in (True, False):
        probes.set_metrics(on)
        try:
            emb = seam(dev)
            model = emb.model
            emb.resolve_batch([emb.submit_batch(warm)], timeout=600)  # outside the counts
            sent = []  # the miss batches that reached the device
            submit = model.embed_submit

            def recording(texts, submit=submit, sent=sent):
                sent.append(list(texts))
                return submit(texts)

            model.embed_submit = recording
            probes.REGISTRY.reset()
            model_spans0 = len(model.recent_traces())
            r = ingest(emb, docs)
            r.update(spans=model.recent_traces()[model_spans0:], sent=sent,
                     snapshot=probes.REGISTRY.snapshot(), dispatch=probes.dispatch_counts(),
                     attn=probes.attn_stats())
            launches += r["launches"]
            emb.close()
        finally:
            probes.set_metrics(True)
        runs.append((on, r, model))
    for i, (on, r, _) in enumerate(runs):
        info(f"telemetry (c) ingest run {i + 1}, metrics {'on' if on else 'off'} [{gpu}]: "
             f"{r['docs_per_s']:.1f} docs/s ({r['wall_s'] * 1e3:.3f} ms for {r['n']}); "
             f"{len(r['sent'])} batches to the device, spans {len(r['spans'])}")
    require(all(np.array_equal(r["vecs"], runs[0][1]["vecs"]) for _, r, _ in runs),
            "(c) embeddings byte-identical with metrics on and off")
    for on, r, model in runs:
        if not on:
            require(r["spans"] == [] and r["snapshot"] == {
                "counters": {}, "gauges": {}, "histograms": {}},
                "(c) metrics off: no span, an empty registry snapshot")
            continue
        n_dev = r["launches"] // MINILM_LAYERS
        require(len(r["spans"]) == INGEST_BATCHES == len(r["sent"]) and all(
            [e["name"] for e in s["events"]] == INGEST_EVENTS for s in r["spans"]),
            f"(c) {INGEST_BATCHES} embed spans, events in the order {INGEST_EVENTS}")
        require(r["dispatch"].get("embed_dispatch") == len(r["sent"]) == n_dev,
                f"(c) embed_dispatch counts the {n_dev} batches that reached the device")
        cfg, want = model.cfg, 0
        for texts in r["sent"]:
            B, S = pad_to_buckets(*model.tokenizer(texts, max_length=64))[0].shape
            want += cfg.layers * FA.attn_bytes_flash(S, S, cfg.heads, cfg.head_dim, batch=B)
        require(r["attn"]["bytes"].get("encoder") == want,
                f"(c) attn_stats encoder bytes equal the formula over those batches ({want})")
    dps = {on: statistics.mean(r["docs_per_s"] for o, r, _ in runs if o == on)
           for on in (True, False)}
    info(f"telemetry (c) cost [{gpu}]: ingest docs/s on {dps[True]:.1f} / off "
         f"{dps[False]:.1f} (on/off {dps[True] / dps[False]:.4f})")
    return launches


def check_query_dispatches(pipe, queries) -> int:
    """Phase 11 (d): one retrieve and one retrieve_rerank on phase 4's
    pipeline; returns their flash_attn launches."""
    from pathway_tpu_torch.engine import probes
    from pathway_tpu_torch.models import flash_attention as FA

    d0, r0 = probes.dispatch_counts(), probes.retrieval_backend_stats().get("dense", 0)
    FA.flash_attn.launches = 0
    pipe.retrieve(queries[:8], k=TOP_K)
    pipe.retrieve_rerank(queries[8], k=RERANK_K)
    launches = FA.flash_attn.launches
    d1, r1 = probes.dispatch_counts(), probes.retrieval_backend_stats().get("dense", 0)
    delta = {k: d1.get(k, 0) - d0.get(k, 0) for k in set(d0) | set(d1)}
    delta = {k: v for k, v in delta.items() if v}
    info(f"telemetry (d) queries: dispatch delta {delta}, dense retrieval queries +{r1 - r0}")
    require(delta == {"fused_retrieve": 1, "fused_retrieve_rerank": 1} and r1 - r0 == 8,
            "(d) one fused_retrieve and one fused_retrieve_rerank dispatch; dense +8 queries")
    return launches


# ---------------------------------------------------------------- phase 12
# the query server's keys may swap with the per-call path's only where the
# per-call scores at that rank lie within one bf16 ulp of 1.0 (an encode
# at another batch height rounds differently)
TIE_TOL = 8e-3
# phase 12 (f): half retrieve (k = TOP_K), half rerank (k = RERANK_K); 256
# until the script's time took phase 25
N_QS = 128


def bounded_serve(chat, prompts, timeout: float = 600.0, groups=None, after_submit=None,
                  **kw) -> dict:
    """One run of ``prompts`` submitted at once through DecoderChat, every
    kernel count set to 0 just before and read just after; ``groups``
    (``(tenant, prompts)`` pairs) submits each group with its tenant
    instead, one right after another; ``after_submit`` is called with the
    requests once all are submitted. Failed and shed requests are
    allowed, but every request must be terminal within ``timeout``
    seconds."""
    import torch

    for f in counters().values():
        f.launches = 0
    s0 = dict(chat.server.stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = []
    for tenant, batch in groups or [("default", prompts)]:
        reqs += chat.submit_batch(batch, tenant=tenant, **kw)
    if after_submit is not None:
        after_submit(reqs)
    end = time.monotonic() + timeout
    for r in reqs:
        if not r.done.wait(max(0.0, end - time.monotonic())):
            raise AssertionError(f"a request was not terminal within {timeout} s")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    texts = chat.resolve_batch([reqs])[0]
    served = [r for r in reqs if r.text is not None]
    ttft = [r.first_token_at - r.submitted_at for r in served if r.first_token_at]
    return {"reqs": reqs, "texts": texts, "wall_s": wall,
            "launches": {n: f.launches for n, f in counters().items()},
            "stats": {k: v - s0.get(k, 0) for k, v in chat.server.stats.items()},
            "served": len(served), "tok_per_s": sum(len(r.tokens) for r in served) / wall,
            "ttft_p50_s": statistics.median(ttft) if ttft else float("nan")}


class TimedLadder:
    """A degradation controller behind a host timer: counts the serving
    loop's ladder reads and the seconds they take."""

    def __init__(self, ctl):
        self.ctl, self.calls, self.seconds = ctl, 0, 0.0

    def maybe_evaluate(self) -> int:
        t0 = time.perf_counter()
        try:
            return self.ctl.maybe_evaluate()
        finally:
            self.seconds += time.perf_counter() - t0
            self.calls += 1


def add_launches(total: dict, out: dict) -> None:
    for n, v in out["launches"].items():
        total[n] += v


def free_chats(*chats) -> None:
    """Shut the servers down and release their pools and weights."""
    import gc

    import torch

    for chat in chats:
        chat.close()
    del chats
    gc.collect()
    torch.cuda.synchronize()


def dense_prompts() -> list[str]:
    """16 prompts for the dense pool: four whole-prompt admissions in four
    distinct pow2 buckets (so no admission is ever batched with another,
    and a stream does not depend on which requests share a tick), twelve
    of 65-200 tokens prefilled in pieces."""
    short = [make_prompts(1, n, n, seed=30 + i)[0] for i, n in enumerate((6, 12, 30, 60))]
    return short + make_prompts(12, 65, 200, seed=34)


def run_supervision_serving(dev, gpu: str, common) -> dict:
    """Phase 12 (a)-(d); returns the launches of its runs."""
    import gc

    import torch

    from pathway_tpu_torch import DecoderChat
    from pathway_tpu_torch.engine import chaos, probes, slo
    from pathway_tpu_torch.models import decoder as D
    from pathway_tpu_torch.xpacks.llm import decode_serve_error

    paged = dict(paged_kv=True, paged_kv_block=BLOCK, paged_kernel=True, flash_prefill=True)
    total = {n: 0 for n in counters()}
    prompts = make_prompts(N_REQUESTS, 16, 480, seed=1)

    # (a) the defaults (degradation on, no objective) against degradation off
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    on = DecoderChat(**paged, **common)
    serve(on, make_prompts(4, 16, 200, seed=99))  # warm-up, outside the counts
    on.server.prefix_reset()
    mem_off = torch.cuda.memory_allocated(dev) - base  # one server, chaos off
    require(on.server._degrade is slo.get_degradation_controller()
            and not on.server._degrade.watchdog.objectives,
            "(a) the default server reads the shared ladder, with no objective declared")
    off = DecoderChat(degradation=False, **paged, **common)
    serve(off, make_prompts(4, 16, 200, seed=99))
    off.server.prefix_reset()
    chats = {True: on, False: off}
    # the ladder's own host time: every read of the "on" arm timed
    timed = TimedLadder(on.server._degrade)
    on.server._degrade = timed
    runs = []
    for arm in (True, False):
        out = serve(chats[arm], prompts)
        chats[arm].server.prefix_reset()
        runs.append((arm, out))
        add_launches(total, out)
        info(f"supervision (a) degradation {'on' if arm else 'off'} [{gpu}]: {N_REQUESTS} "
             f"requests in {out['wall_s']:.3f} s wall; decode {out['tok_per_s']:.1f} "
             f"tokens/s; TTFT p50 {out['ttft_p50_s'] * 1e3:.1f} ms; level "
             f"{chats[arm].server._degradation_level}")
    ref = [r.tokens for r in runs[0][1]["reqs"]]
    require(all([r.tokens for r in out["reqs"]] == ref for _, out in runs),
            f"(a) the {N_REQUESTS} streams are equal token for token, degradation on and off")
    tps = {a: statistics.mean(o["tok_per_s"] for x, o in runs if x == a) for a in chats}
    ttft = {a: statistics.mean(o["ttft_p50_s"] for x, o in runs if x == a) * 1e3 for a in chats}
    info(f"supervision (a) cost [{gpu}]: decode tokens/s on {tps[True]:.1f} / off "
         f"{tps[False]:.1f} (on/off {tps[True] / tps[False]:.4f}); TTFT p50 ms on "
         f"{ttft[True]:.1f} / off {ttft[False]:.1f} (on/off {ttft[True] / ttft[False]:.4f})")
    on_wall = runs[0][1]["wall_s"]
    info(f"supervision (a) ladder reads timed [{gpu}]: {timed.calls} reads, "
         f"{timed.seconds * 1e3:.3f} ms host time in the {on_wall:.3f} s burst with "
         f"degradation on ({100 * timed.seconds / on_wall:.4f}% of wall, "
         f"{timed.seconds / max(timed.calls, 1) * 1e6:.2f} us a read)")
    free_chats(on, off)
    del on, off, chats
    ttft_p50_ms = ttft[True]

    # (b) decode chaos: the burst on the paged pool, then 16 requests on a
    # dense pool (prefix cache off: a dense hit admits right-padded, so a
    # restart that empties the tree would change a stream's rounding)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    chaos.configure(rate=0.05, seed=0, sites="decode")
    try:
        chat = DecoderChat(serve_restarts=8, serve_retries=3, **paged, **common)
    finally:
        chaos.configure()
    srv = chat.server
    kv0 = probes.hbm_stats()["current_bytes"]["kv_blocks"]
    probes.REGISTRY.remove("serve_restarts")
    out = bounded_serve(chat, prompts)
    add_launches(total, out)
    st = out["stats"]
    mem_chaos = torch.cuda.memory_allocated(dev) - base
    unfailed = [(r, w) for r, w in zip(out["reqs"], ref) if r.text is not None]
    counted = probes.REGISTRY.labelled("serve_restarts", "server").get(srv._trace_tag, 0)
    info(f"supervision (b) decode chaos, paged burst [{gpu}]: {out['served']}/{N_REQUESTS} "
         f"served in {out['wall_s']:.3f} s wall; restarts {st['restarts']} (counter "
         f"{counted:g}), request retries {st['request_retries']}, failures "
         f"{st['request_failures']}; memory_allocated {mem_chaos} vs {mem_off} chaos off "
         f"(pool_bytes {D.pool_bytes(srv.pool)}); launches {out['launches']}")
    require(all(r.tokens == w for r, w in unfailed),
            "(b) every unfailed stream equals its chaos-off stream token for token")
    require(st["restarts"] >= 1 and st["restarts"] == counted,
            "(b) the burst restarted the loop, and serve_restarts counts every restart")
    require(abs(mem_chaos - mem_off) <= D.pool_bytes(srv.pool),
            "(b) memory_allocated after the restarts within one pool's bytes of chaos off")
    require(probes.hbm_stats()["current_bytes"]["kv_blocks"] == kv0
            == D.pool_component_device_bytes(srv.pool)["kv_blocks"]["0"],
            "(b) the HBM ledger's kv_blocks unchanged, equal to the rebuilt pool's")
    free_chats(chat)
    del chat, srv

    dense = dict(paged_kv=False, flash_prefill=True, prefix_cache=False)
    d_prompts = dense_prompts()
    ref_chat = DecoderChat(**dense, **common)
    d_ref = bounded_serve(ref_chat, d_prompts)
    add_launches(total, d_ref)
    require(d_ref["served"] == len(d_prompts), "(b) the dense chaos-off run served all 16")
    d_ref = [r.tokens for r in d_ref["reqs"]]
    free_chats(ref_chat)
    del ref_chat
    chaos.configure(rate=0.05, seed=0, sites="decode")
    try:
        chat = DecoderChat(serve_restarts=8, serve_retries=3, **dense, **common)
    finally:
        chaos.configure()
    d_st, equal, served = {}, True, 0
    for _ in range(3):  # three rounds: a 16-request round makes ~6 dispatches
        out = bounded_serve(chat, d_prompts)
        add_launches(total, out)
        for k, v in out["stats"].items():
            d_st[k] = d_st.get(k, 0) + v
        equal &= all(r.tokens == w for r, w in zip(out["reqs"], d_ref) if r.text is not None)
        served += out["served"]
    info(f"supervision (b) decode chaos, dense pool, 3 rounds of 16 [{gpu}]: {served}/48 "
         f"served; restarts {d_st['restarts']}, request retries {d_st['request_retries']}, "
         f"failures {d_st['request_failures']}; {d_st['admit_dispatches']} whole-prompt "
         f"admissions, {d_st['prefill_chunks']} pieces")
    require(equal, "(b) every unfailed dense stream equals its chaos-off stream")
    require(d_st["restarts"] + d_st["request_retries"] + d_st["request_failures"] >= 1,
            "(b) chaos hit the dense run")
    free_chats(chat)
    del chat

    # (c) shedding: a queue bound of 8 under the burst, then deadlines
    probes.REGISTRY.remove("requests_shed")
    chat = DecoderChat(serve_queue=8, **paged, **common)
    out = bounded_serve(chat, prompts)
    add_launches(total, out)
    shed = [(r, t) for r, t in zip(out["reqs"], out["texts"]) if r.text is None]
    shed_counted = probes.REGISTRY.labelled("requests_shed", "reason")
    info(f"supervision (c) serve_queue=8 [{gpu}]: {out['served']} served, {len(shed)} shed "
         f"in {out['wall_s']:.3f} s wall; requests_shed {shed_counted}")
    require(shed and all(decode_serve_error(t) == {"reason": "shed:queue_full",
                                                   "retry_after": 1.0} for _, t in shed),
            "(c) shed requests decode to shed:queue_full with retry_after 1.0")
    require(shed_counted == {"queue_full": float(out["stats"]["shed"])}
            and out["stats"]["shed"] == len(shed),
            "(c) requests_shed{reason=queue_full} equals stats['shed']")
    require(all(r.tokens == w for r, w in zip(out["reqs"], ref) if r.text is not None),
            "(c) served requests equal their streams in (a)")
    free_chats(chat)
    del chat
    deadline_ms = ttft_p50_ms / 2
    chat = DecoderChat(request_deadline_ms=deadline_ms, **paged, **common)
    stalled = {}

    def stall(reqs):
        # a loop stalled past every deadline, made certain: with the
        # admission lock held it admits nothing, so each request still
        # queued (N_REQUESTS > N_SLOTS) is past its deadline at the sweep
        # that follows. Left to the host's timing, the sweep and the
        # in-flight sheds that free slots race, and the queue may drain
        # into slots before its deadline. The stall starts once the slots
        # are full, as in a burst the card is still serving.
        first = min(r.deadline for r in reqs) - 0.1
        while chat.server.free and time.monotonic() < first:
            time.sleep(0.005)
        with chat.server.lock:
            stalled["queued"] = len(chat.server.queue)
            time.sleep(max(0.0, max(r.deadline for r in reqs) - time.monotonic()) + 0.05)

    out = bounded_serve(chat, prompts, after_submit=stall)
    add_launches(total, out)
    reasons: dict = {}
    for r in out["reqs"]:
        reasons[r.error_reason] = reasons.get(r.error_reason, 0) + 1
    ids = {r.span.request_id for r in out["reqs"]}
    late = [s for s in chat.recent_traces() if s["id"] in ids and any(
        e["name"] == "admit" and e["t_ms"] > deadline_ms + 1.0 for e in s["events"])]
    info(f"supervision (c) request_deadline_ms={deadline_ms:.1f} [{gpu}]: outcomes "
         f"{reasons}; {stalled['queued']} queued when the loop stalled past the deadlines; "
         f"admissions after their deadline {len(late)}")
    require(reasons.get("shed:deadline", 0) >= stalled["queued"] >= 1,
            "(c) every request queued through the stall shed as deadline")
    require(not late, "(c) no request admitted after its deadline")
    require(all(r.tokens == w for r, w in zip(out["reqs"], ref) if r.text is not None),
            "(c) served requests equal their streams in (a)")
    free_chats(chat)
    del chat

    # (d) the ladder, stepped by an objective that always fails on an
    # injected clock; spec decode on, as the JAX default
    clock = [1000.0]
    wd = slo.SloWatchdog([slo.Objective("ttft_p95", "ceiling", 1.0, sample=lambda: 1e9,
                                        unit="ms")], clock=lambda: clock[0])
    ctl = slo.DegradationController(wd, step_s=5.0)
    spec = dict(common, spec_decode=True)
    half = MAX_NEW // 2
    for level in (1, 2, 3):
        wd.tick()
        ctl.evaluate()
        require(ctl.level() == level, f"(d) the controller stepped to level {level}")
        chat = DecoderChat(**paged, **spec)  # fresh: its spec latch is not tripped
        chat.server._degrade = ctl
        # the idle loop reads the ladder every tick; admit only after it has
        end = time.monotonic() + 10.0
        while chat.server._degradation_level != level and time.monotonic() < end:
            time.sleep(0.005)
        require(chat.server._degradation_level == level,
                f"(d) the server reads level {level} from the controller")
        if level < 3:
            out = bounded_serve(chat, make_prompts(16, 16, 200, seed=40 + level))
            add_launches(total, out)
            st, ln = out["stats"], out["launches"]
            lens = {len(r.tokens) for r in out["reqs"]}
            info(f"supervision (d) level {level} [{gpu}]: {out['served']}/16 served, "
                 f"stream lengths {sorted(lens)}; spec dispatches {st['spec_dispatches']}, "
                 f"{st['decode_steps']} decode steps in {st['chunks']} chunks; launches {ln}")
            require(out["served"] == 16 and lens == {half}
                    and all(r.max_new == half for r in out["reqs"]),
                    f"(d) level {level}: every admitted max_new clamped to {half}")
            if level == 2:
                require(st["spec_dispatches"] == 0
                        and ln["paged_attn_decode"] >= 12 * st["decode_steps"] > 0,
                        "(d) level 2: only plain chunks, no spec dispatch")
                chat.server._degrade = None
                chat.server._degradation_level = 0
                out = bounded_serve(chat, make_prompts(8, 16, 200, seed=45))
                add_launches(total, out)
                require(out["stats"]["spec_dispatches"] > 0,
                        "(d) the same server dispatches spec again at level 0")
        else:
            out = bounded_serve(chat, make_prompts(8, 16, 200, seed=46), priority=0)
            high = bounded_serve(chat, make_prompts(8, 16, 200, seed=47), priority=1)
            add_launches(total, out)
            add_launches(total, high)
            lows = {r.error_reason for r in out["reqs"]}
            info(f"supervision (d) level 3 [{gpu}]: priority 0 outcomes {lows}; priority 1 "
                 f"{high['served']}/8 served")
            require(lows == {"shed:degraded"}, "(d) level 3: priority-0 requests shed")
            require(high["served"] == 8 and all(len(r.tokens) == half for r in high["reqs"]),
                    "(d) level 3: priority-1 requests served (clamped)")
        free_chats(chat)
        del chat
        clock[0] += 5.0
    return total


def run_ingest_chaos(dev, gpu: str, docs) -> int:
    """Phase 12 (e): phase 8's defaults seam with ``embed.h2d`` at rate 0.2;
    returns the flash_attn launches of its ingests."""
    from pathway_tpu_torch.engine import chaos
    from pathway_tpu_torch.models import flash_attention as FA

    warm = [d + " warm" for d in docs[:INGEST_BATCH]]
    emb = seam(dev)
    emb.resolve_batch([emb.submit_batch(warm)], timeout=600)
    off = ingest(emb, docs)
    emb.close()
    launches = off["launches"]
    batches = [docs[s:s + INGEST_BATCH] for s in range(0, N_DOCS, INGEST_BATCH)]
    for restarts in (1, 0):
        chaos.configure(rate=0.2, seed=0, sites="embed.h2d")
        try:
            emb = seam(dev, serve_restarts=restarts, serve_retries=3)
            # the pipeline, and its site, is built at the first submit
            emb.resolve_batch([emb.submit_batch(warm)], timeout=600)
        finally:
            chaos.configure()
        retries = emb.model.h2d_retries
        site, expect = chaos.ChaosSite("embed.h2d", 0.2, 0), []
        for _ in range(1 + len(batches)):  # the warm batch, then the corpus
            ok = False
            for _ in range(retries + 1):
                try:
                    site.maybe_fail()
                    ok = True
                    break
                except chaos.InjectedFault:
                    pass
            expect.append(ok)
        FA.flash_attn.launches = 0
        handles = [emb.submit_batch(b) for b in batches]
        got, equal, raised = [], True, 0
        for i, h in enumerate(handles):
            try:
                vecs = np.stack(emb.resolve_batch([h], timeout=600)[0])
                equal &= np.array_equal(vecs, off["vecs"][i * INGEST_BATCH:(i + 1) * INGEST_BATCH])
                got.append(True)
            except chaos.InjectedFault as exc:
                raised += int(exc.site == "embed.h2d")
                got.append(False)
        launches += FA.flash_attn.launches
        ops = emb.model._pipeline._chaos_h2d._seq
        emb.close()
        info(f"supervision (e) ingest chaos, serve_restarts={restarts} (h2d retries "
             f"{retries}) [{gpu}]: {sum(got)}/{len(batches)} batches resolved, {raised} raised "
             f"InjectedFault; site operations {ops}")
        require(got == expect[1:] and raised == got.count(False),
                "(e) the batches that spent their budget raise InjectedFault at resolve, "
                "as the site's schedule says; none is dropped")
        require(equal, "(e) every resolved batch is byte-equal to chaos off")
        if restarts:
            require(all(got) and ops > 1 + len(batches),
                    "(e) with retries every fault was retried away")
        else:
            require(not all(got), "(e) without retries a fault reaches resolve")
    return launches


def ranks_agree(want, got, tol: float = TIE_TOL) -> bool:
    """``got``'s keys equal ``want``'s wherever the per-call score at that
    rank is not within ``tol`` of a neighbour's. At the last rank the
    neighbour below is not in the row: there the two rows' own scores at
    that rank must be within ``tol``."""
    if len(want) != len(got):
        return False
    ws, gs = [s for _, s in want], [s for _, s in got]
    for j, ((wk, _), (gk, _)) in enumerate(zip(want, got)):
        if wk != gk:
            near = [abs(ws[j] - ws[i]) for i in (j - 1, j + 1) if 0 <= i < len(ws)]
            if j == len(ws) - 1:
                near.append(abs(gs[j] - ws[j]))
            if min(near) > tol:
                return False
    return True


def poisson_submit(srv, items, rate: float, threads: int = 8, seed: int = 0):
    """Submit ``items`` ((text, k, rerank)) from ``threads`` threads, each
    with exponential gaps at ``rate / threads`` a second; returns the
    handles in ``items`` order."""
    handles = [None] * len(items)

    def worker(t):
        rng = np.random.default_rng(seed + t)
        for i in range(t, len(items), threads):
            time.sleep(float(rng.exponential(threads / rate)))
            text, k, rerank = items[i]
            handles[i] = srv.submit(text, k, rerank=rerank)

    with ThreadPoolExecutor(threads) as ex:
        list(ex.map(worker, range(threads)))
    return handles


def wait_all(handles, timeout: float = 300.0):
    """(results, errors), every handle terminal within ``timeout``."""
    end = time.monotonic() + timeout
    results, errors = [], []
    for h in handles:
        if not h.done.wait(max(0.0, end - time.monotonic())):
            raise AssertionError(f"a query was not terminal within {timeout} s")
        results.append(h.result)
        errors.append(h.error)
    return results, errors


def run_query_server(pipe, gpu: str) -> int:
    """Phase 12 (f); returns its flash_attn launches."""
    from pathway_tpu_torch import QueryServer
    from pathway_tpu_torch.engine import chaos, probes
    from pathway_tpu_torch.models import flash_attention as FA

    _, qs = corpus(n_queries=N_QS)
    items = [(q, RERANK_K if i % 2 else TOP_K, bool(i % 2)) for i, q in enumerate(qs)]
    FA.flash_attn.launches = 0
    # the per-call path, one query at a time
    per_call, lat = [], {False: [], True: []}
    t0 = time.perf_counter()
    for text, k, rerank in items:
        t1 = time.perf_counter()
        per_call.append(pipe.retrieve_rerank(text, k) if rerank else pipe.retrieve([text], k)[0])
        lat[rerank].append(time.perf_counter() - t1)
    rate = len(items) / (time.perf_counter() - t0)

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs) * 1e3, q))

    d0 = probes.dispatch_counts()
    with QueryServer(pipe) as srv:
        t0 = time.perf_counter()
        handles = poisson_submit(srv, items, 2 * rate)
        results, errors = wait_all(handles)
        wall = time.perf_counter() - t0
        st = srv.stats()
    d1 = probes.dispatch_counts()
    agree = [ranks_agree(w, g) for w, g in zip(per_call, results)]
    swaps = sum(sum(a[0] != b[0] for a, b in zip(w, g)) for w, g in zip(per_call, results))
    slat = {r: [h.latency_s for h, (_, _, rr) in zip(handles, items) if rr == r]
            for r in (False, True)}
    info(f"supervision (f) per-call path [{gpu}]: {rate:.1f} queries/s sustained; retrieve "
         f"p50 {pct(lat[False], 50):.3f} / p99 {pct(lat[False], 99):.3f} ms, rerank p50 "
         f"{pct(lat[True], 50):.3f} / p99 {pct(lat[True], 99):.3f} ms")
    info(f"supervision (f) QueryServer defaults, {N_QS} Poisson arrivals at {2 * rate:.1f}/s "
         f"from 8 threads [{gpu}]: {wall:.3f} s wall; mean batch {st['mean_batch']}, "
         f"{st['dispatches']} dispatches / {st['requests']} requests = "
         f"{st['dispatches'] / st['requests']:.4f}; retrieve p50 {pct(slat[False], 50):.3f} / "
         f"p99 {pct(slat[False], 99):.3f} ms, rerank p50 {pct(slat[True], 50):.3f} / p99 "
         f"{pct(slat[True], 99):.3f} ms; batch sizes {st['batch_hist']}; {sum(agree)}/{N_QS} "
         f"rows agree with the per-call path ({swaps} positions differ)")
    require(not any(errors) and not st["failed"], "(f) every query answered")
    require(all(agree), f"(f) keys equal the per-call path's but at per-call near-ties "
                        f"(within {TIE_TOL})")
    require(st["dispatches"] < st["requests"] and st["requests"] == N_QS,
            "(f) concurrent queries coalesced: fewer dispatches than requests")
    delta = {k: d1.get(k, 0) - d0.get(k, 0) for k in ("fused_retrieve", "fused_retrieve_rerank")}
    require(sum(delta.values()) == st["dispatches"],
            f"(f) one fused dispatch per (kind, k) group a tick ({delta})")

    # the cascade, 28 of 32 surviving depth 3, over the first 64 rerank queries
    rr = [(i, it) for i, it in enumerate(items) if it[2]][:64]
    pipe.rerank_cascade, pipe.rerank_cascade_depth = True, 3
    pipe.rerank_cascade_survivors, pipe.rerank_seed_weight = 28, 0.25
    try:
        c0 = probes.dispatch_counts().get("fused_rerank_cascade", 0)
        with QueryServer(pipe) as srv:
            casc, cerr = wait_all(poisson_submit(srv, [it for _, it in rr], 2 * rate))
            cst = srv.stats()
        counted = probes.dispatch_counts().get("fused_rerank_cascade", 0) - c0
        _, _, _, order = pipe.retrieve_rerank_batch_device([it[0] for _, it in rr], RERANK_K)
        perm = all(sorted(row) == list(range(RERANK_K)) for row in order.cpu().tolist())
    finally:
        pipe.rerank_cascade = False
        pipe.rerank_cascade_depth = pipe.rerank_cascade_survivors = 0
    overlap = statistics.mean(
        len({k for k, _ in c[:8]} & {k for k, _ in per_call[i][:8]}) / 8
        for c, (i, _) in zip(casc, rr))
    info(f"supervision (f) cascade (depth 3, 28 of {RERANK_K}, seed weight 0.25) [{gpu}]: "
         f"mean top-8 overlap with the full rerank {overlap:.4f} over {len(rr)} queries; "
         f"fused_rerank_cascade dispatches {counted} ({cst['dispatches']} server dispatches, "
         f"mean batch {cst['mean_batch']})")
    require(not any(cerr) and all(len({k for k, _ in c}) == RERANK_K for c in casc) and perm,
            "(f) cascade rows answered, order a permutation in every row")
    require(overlap >= 0.9, "(f) cascade top-8 overlap >= 0.9 against the full rerank")
    require(counted == cst["dispatches"] > 0,
            "(f) fused_rerank_cascade counted once per server dispatch")

    # query.tick chaos, supervised
    chaos.configure(rate=0.2, seed=0, sites="query.tick")
    try:
        srv = QueryServer(pipe, serve_restarts=2)
    finally:
        chaos.configure()
    with srv:
        sub = items[:64]
        results, errors = wait_all(poisson_submit(srv, sub, 2 * rate))
        faults = [e for e in errors if e is not None]
        ok = all(isinstance(e, chaos.InjectedFault) and e.site == "query.tick" for e in faults)
        agree = all(ranks_agree(per_call[i], r) for i, (r, e) in enumerate(zip(results, errors))
                    if e is None)
        after, after_err = wait_all([srv.submit(t, k, rerank=r) for t, k, r in items[:16]])
        cst = srv.stats()
    info(f"supervision (f) query.tick chaos at 0.2, serve_restarts=2 [{gpu}]: "
         f"{len(faults)}/{len(sub)} "
         f"failed with the injected fault, {cst['group_failures']} group failures, failed "
         f"{cst['failed']}; afterwards {sum(e is None for e in after_err)}/16 served")
    require(ok and faults and agree, "(f) chaos: every query terminal, faults isolated with "
                                     "provenance, the rest equal the per-call path")
    require(not cst["failed"] and any(e is None for e in after_err),
            "(f) the server still serves after the chaos")
    return FA.flash_attn.launches


# ---------------------------------------------------------------- phase 13
TENANT_W = "a:3,b:1"
# tenant a's weighted share of the 16 slots, in decode tokens: a reaches
# its budget at 12 admissions, while b still waits
TENANT_BUDGET = 12 * MAX_NEW
FLEET_HEADS = 4


def span_latency(spans) -> dict:
    """TTFT p50 and TPOT p99 (ms) over finished decode spans."""
    ttft = [s["metrics"]["ttft_ms"] for s in spans if "ttft_ms" in s["metrics"]]
    tpot = sorted(s["metrics"]["tpot_ms"] for s in spans if "tpot_ms" in s["metrics"])
    return {"ttft_p50_ms": statistics.median(ttft),
            "tpot_p99_ms": tpot[min(len(tpot) - 1, int(0.99 * len(tpot)))]}


def row_blocks(srv, n: int) -> int:
    """Blocks of a paged request's row: its prompt right-padded to whole
    pieces, its answer and the in-flight slack, in blocks of BLOCK."""
    width = -(-n // PIECE) * PIECE
    cover = min(CACHE_LEN, width + MAX_NEW + (srv.pipeline_depth + 1) * srv._slack)
    return -(-cover // BLOCK)


def wait_until(cond, what: str, timeout: float = 30.0) -> None:
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def fleet_serve(router, prompts, timeout: float = 600.0) -> dict:
    """Route ``prompts`` through the fleet at once, the kernel counts set
    to 0 just before; every request must be terminal within ``timeout``."""
    import torch

    for f in counters().values():
        f.launches = 0
    t0 = time.perf_counter()
    fcs = [router.submit(p) for p in prompts]
    end = time.monotonic() + timeout
    for fc in fcs:
        if not fc.wait(timeout=max(0.0, end - time.monotonic())):
            raise AssertionError(f"a fleet request was not terminal within {timeout} s")
    torch.cuda.synchronize()
    return {"fcs": fcs, "wall_s": time.perf_counter() - t0,
            "launches": {n: f.launches for n, f in counters().items()}}


def run_lanes_tenants_fleet(dev, gpu: str, common) -> dict:
    """Phase 13; returns the launches of its runs."""
    import gc

    import torch

    from pathway_tpu_torch import DecoderChat, serving
    from pathway_tpu_torch.engine import chaos, probes, tracing
    from pathway_tpu_torch.models import decoder as D

    paged = dict(paged_kv=True, paged_kv_block=BLOCK, paged_kernel=True, flash_prefill=True)
    total = {n: 0 for n in counters()}
    prompts = make_prompts(N_REQUESTS, 16, 480, seed=1)
    n_tok = [len(common["tokenizer"].encode(p)) for p in prompts]

    # (a) disaggregated lanes against interleaved prefill: one pair, off, on
    off = DecoderChat(disagg=False, **paged, **common)
    serve(off, make_prompts(4, 16, 200, seed=99))  # warm-up, outside the counts
    off.server.prefix_reset()
    on = DecoderChat(disagg=True, disagg_prefill_budget=1, **paged, **common)
    serve(on, make_prompts(4, 16, 200, seed=99))
    on.server.prefix_reset()
    chats, runs = {False: off, True: on}, []
    for arm in (False, True):
        tracing.reset_traces()
        out = serve(chats[arm], prompts)
        srv = chats[arm].server
        out.update(span_latency(chats[arm].recent_traces()))
        srv.prefix_reset()
        add_launches(total, out)
        runs.append((arm, out))
        st = out["stats"]
        info(f"lanes (a) disagg {'on' if arm else 'off'} [{gpu}]: {N_REQUESTS} requests in "
             f"{out['wall_s']:.3f} s wall; decode {out['tok_per_s']:.1f} tokens/s; TTFT p50 "
             f"{out['ttft_p50_ms']:.1f} ms; TPOT p99 {out['tpot_p99_ms']:.2f} ms; "
             f"kv_migrated_blocks {st['kv_migrated_blocks']}; launches {out['launches']}")
        want = sum(row_blocks(srv, n) for n in n_tok) if arm else 0
        require(st["kv_migrated_blocks"] == want,
                f"(a) kv_migrated_blocks is the sum of the handed-off rows ({want})")
        wait_until(lambda: srv.lane_stats() == {"prefill": 0, "decode": 0}, "idle lanes")
    ref = [r.tokens for r in runs[0][1]["reqs"]]
    require(all([r.tokens for r in o["reqs"]] == ref for _, o in runs),
            f"(a) the {N_REQUESTS} streams are equal token for token, disagg on and off")
    info("  check: (a) lane_stats() back to {prefill: 0, decode: 0} after each burst: ok")
    for key, fmt in (("tok_per_s", "{:.1f}"), ("ttft_p50_ms", "{:.1f}"),
                     ("tpot_p99_ms", "{:.2f}")):
        v = {a: statistics.mean(o[key] for x, o in runs if x == a) for a in chats}
        info(f"lanes (a) {key} [{gpu}]: on {fmt.format(v[True])} / off "
             f"{fmt.format(v[False])} (on/off {v[True] / v[False]:.4f})")
    free_chats(on, off)
    del on, off, chats, srv  # srv would keep the last server's pool alive

    # (b) tenants: one tenant and no budget (idle), then a:3,b:1 under a
    # budget that preempts, then a dense pool
    sched = DecoderChat(tenant_sched=True, **paged, **common)
    out = serve(sched, prompts)
    add_launches(total, out)
    require([r.tokens for r in out["reqs"]] == ref and out["stats"]["preemptions"] == 0,
            f"(b) idle scheduler: the {N_REQUESTS} streams equal scheduling off")
    free_chats(sched)
    del sched
    # the contended arm and scheduling off, each a fresh server measured
    # alike: memory_allocated over the baseline after its burst
    half = N_REQUESTS // 2
    groups = [("a", prompts[:half]), ("b", prompts[half:])]
    mems = {}
    for arm in (False, True):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        base_req = torch.cuda.memory_stats(dev)["requested_bytes.all.current"]
        kw = dict(tenant_sched=True, tenant_budget=TENANT_BUDGET,
                  tenant_weights=TENANT_W) if arm else {}
        chat = DecoderChat(**kw, **paged, **common)
        srv = chat.server
        serve(chat, make_prompts(4, 16, 200, seed=99))
        srv.prefix_reset()
        order = []
        if arm:
            charge = srv._tenants.charge
            srv._tenants.charge = lambda t, n: (order.append(t), charge(t, n))
        out = bounded_serve(chat, None, groups=groups)
        add_launches(total, out)
        st = out["stats"]
        first = order[:N_SLOTS]
        label = f"{TENANT_W}, budget {TENANT_BUDGET} tokens" if arm else "scheduling off"
        info(f"tenants (b) {label} [{gpu}]: {N_REQUESTS} requests in {out['wall_s']:.3f} s "
             f"wall; decode {out['tok_per_s']:.1f} tokens/s; preemptions "
             f"{st['preemptions']}, unparked {st['unparked']}, admissions "
             f"{st['admitted']}; first {N_SLOTS} admissions "
             f"a:b = {first.count('a')}:{first.count('b')}; launches {out['launches']}")
        require([r.tokens for r in out["reqs"]] == ref,
                f"(b) the {N_REQUESTS} streams equal (a)'s token for token")
        wait_until(lambda: srv.lane_stats() == {"prefill": 0, "decode": 0}, "idle lanes")
        parked = probes.kv_parked_value(server=srv._trace_tag)
        srv.prefix_reset()
        if arm:
            require(st["preemptions"] > 0 and st["unparked"] >= 1,
                    "(b) budget preemption parked a row and an unpark took it back")
            require(parked == 0.0 and not srv._parked,
                    "(b) the kv_parked_bytes gauge is 0 after the burst")
            require(srv._tenants.stats()["inflight"] == {}, "(b) every charge was credited back")
        require(srv._allocator.n_free == srv._total_blocks - 1,
                "(b) every block is back in the allocator")
        del out, srv
        gc.collect()
        torch.cuda.synchronize()
        ms = torch.cuda.memory_stats(dev)
        mems[arm] = (torch.cuda.memory_allocated(dev) - base,
                     ms["allocated_bytes.small_pool.current"],
                     ms["allocated_bytes.large_pool.current"],
                     ms["requested_bytes.all.current"] - base_req)
        free_chats(chat)
        del chat
    info(f"  memory_allocated over the baseline (small pool, large pool; bytes requested "
         f"over the baseline): scheduling on {mems[True]}, off {mems[False]}")
    # the bytes the servers asked for, not the allocator's blocks: best-fit
    # reuse can hold the same (16, 50257) f32 logits in a block 2,048 bytes
    # larger in one arm (a remainder under 1 MB is never split off)
    require(mems[True][3] == mems[False][3],
            "(b) the memory held equals the scheduling-off server's (bytes requested)")

    dense = dict(paged_kv=False, flash_prefill=True, prefix_cache=False, n_slots=8)
    d_common = {k: v for k, v in common.items() if k != "n_slots"}
    d_prompts = dense_prompts()
    d_groups = [("a", d_prompts[0::2]), ("b", d_prompts[1::2])]
    d_out = {}
    for on_ in (False, True):
        kw = dict(tenant_sched=True, tenant_budget=6 * MAX_NEW, tenant_weights=TENANT_W) \
            if on_ else {}
        chat = DecoderChat(**dense, **kw, **d_common)
        d_out[on_] = bounded_serve(chat, None, groups=d_groups)
        add_launches(total, d_out[on_])
        free_chats(chat)
        del chat
    st = d_out[True]["stats"]
    info(f"tenants (b) dense pool, 8 slots, 16 requests [{gpu}]: preemptions "
         f"{st['preemptions']}, {st['admit_dispatches']} whole-prompt admissions, "
         f"{st['prefill_chunks']} pieces; launches {d_out[True]['launches']}")
    require([r.tokens for r in d_out[True]["reqs"]] == [r.tokens for r in d_out[False]["reqs"]],
            "(b) dense pool: the 16 streams equal scheduling off")
    require(st["preemptions"] > 0, "(b) the dense pool preempted")

    # (c) two replicas on the one card behind the router at affinity 4
    # 4 heads, two owned by each replica of the ring the router will
    # build; each head's questions are under one block, so a replica's
    # tree holds only its heads' blocks (phase 7's 64 MB budget, no
    # eviction)
    tok = common["tokenizer"]
    ring = serving.HashRing()
    for rid in ("replica-0", "replica-1"):
        ring.add(rid)
    rng = np.random.default_rng(131)
    heads, owners, seed = [], [], 130
    while len(heads) < FLEET_HEADS:
        group = shared_prompts(SHARED_HEAD, rng.integers(1, BLOCK, N_REQUESTS // FLEET_HEADS)
                               .tolist(), seed=seed)
        seed += 1
        owner = ring.lookup(serving.head_block_key(tok.encode(group[0]), block=BLOCK, blocks=4))
        if owners.count(owner) < FLEET_HEADS // 2:
            heads.append(group)
            owners.append(owner)
    firsts = [g[0] for g in heads]
    rest = [p for g in heads for p in g[1:]]
    single = DecoderChat(**paged, **common)
    w = serve(single, firsts)
    o = serve(single, rest)
    fleet_ref = streams(w) + streams(o)
    free_chats(single)
    del single
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    replicas = {}

    def factory(rid):
        replicas[rid] = DecoderChat(**paged, **common)
        return serving.InProcessReplica(rid, replicas[rid])

    def probe_faults(seed: int) -> list:
        site = chaos.ChaosSite("replica.health", 0.5, seed)
        out = []
        for _ in range(2):
            try:
                site.maybe_fail()
                out.append(False)
            except chaos.InjectedFault:
                out.append(True)
        return out

    # the manager's health site is armed at construction and probes only
    # in tick(): a seed whose first two probes pass, then fault, drains one
    seed = next(s for s in range(1000) if probe_faults(s) == [False, True])
    serving.configure(enabled=True)
    chaos.configure(rate=0.5, seed=seed, sites="replica.health")
    try:
        manager = serving.build_fleet(factory, router=serving.FleetRouter(
            affinity_blocks=4, block=BLOCK, tokenize=tok.encode), replicas=2,
            min_replicas=2, max_replicas=2)
    finally:
        chaos.configure()
        serving.configure()
    pool_bytes = D.pool_bytes(replicas["replica-0"].server.pool)
    one = pool_bytes + sum(t.numel() * t.element_size()
                           for t in D._tensor_leaves(replicas["replica-0"].params))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev) - base
    info(f"fleet (c) memory_allocated with 2 replicas: {held} bytes over the baseline "
         f"(one replica's weights and pool: {one})")
    require(held >= 2 * one, "(c) memory_allocated holds both replicas' weights and pools")
    # the HBM ledger keys entries by owner: both replicas' pools and weights
    # are on it, within what the card holds, and gone after the shutdown
    want = {c: 2 * sum(d.values())
            for c, d in D.pool_component_device_bytes(replicas["replica-0"].server.pool).items()}
    want["weights.decoder"] = 2 * (one - pool_bytes)
    hbm = probes.hbm_stats()
    ledger = {c: hbm["current_bytes"].get(c, 0) for c in want}
    info(f"fleet (c) HBM ledger with 2 replicas: {ledger} (twice one replica's: {want}); "
         f"total {hbm['current_total_bytes']} bytes, memory_allocated "
         f"{torch.cuda.memory_allocated(dev)}")
    require(ledger == want, "(c) the HBM ledger holds both replicas' pools and weights")
    require(hbm["current_total_bytes"] <= torch.cuda.memory_allocated(dev),
            "(c) the ledger total is at most torch.cuda.memory_allocated")
    router = manager.router
    f1 = fleet_serve(router, firsts)
    f2 = fleet_serve(router, rest)
    add_launches(total, f1)
    add_launches(total, f2)
    fcs = f1["fcs"] + f2["fcs"]
    per = N_REQUESTS // FLEET_HEADS - 1
    by_head = [{fc.replica_id for fc in [f1["fcs"][h]] + f2["fcs"][h * per:(h + 1) * per]}
               for h in range(FLEET_HEADS)]
    hits = sum(c.server.stats["prefix_hit_requests"] for c in replicas.values())
    hit_tok = sum(c.server.stats["prefix_hit_tokens"] for c in replicas.values())
    info(f"fleet (c) 2 replicas, {N_REQUESTS} requests behind {FLEET_HEADS} heads of "
         f"{SHARED_HEAD} tokens [{gpu}]: {f1['wall_s']:.3f} + {f2['wall_s']:.3f} s wall "
         f"(one server: {w['wall_s']:.3f} + {o['wall_s']:.3f} s); "
         f"heads on {[sorted(s) for s in by_head]}; prefix hits {hits} ({hit_tok} tokens); "
         f"launches {f2['launches']}")
    require([sorted(s) for s in by_head] == [[o] for o in owners],
            "(c) each head's requests landed on its ring owner, two heads a replica")
    require(hits == len(rest) and hit_tok == len(rest) * SHARED_HEAD,
            "(c) every request after a head's first hit the prefix cache")
    bad = [i for i, (fc, w_) in enumerate(zip(fcs, fleet_ref)) if fc.tokens != w_]

    def first_diff(a, b) -> int:
        return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), -1)

    info(f"  streams equal to one server's: {N_REQUESTS - len(bad)}/{N_REQUESTS}; differing: "
         + (", ".join(f"#{i} on {fcs[i].replica_id} ({len(fcs[i].tokens)} tokens, from "
                      f"{first_diff(fcs[i].tokens, fleet_ref[i])}, {fcs[i].error_reason})"
                      for i in bad) or "none"))
    require(not bad and all(fc.text is not None for fc in fcs),
            f"(c) the fleet's {N_REQUESTS} streams equal a single server's")

    chaos.configure(rate=0.2, seed=0, sites="router.forward")
    try:
        c_router = serving.FleetRouter(affinity_blocks=4, block=BLOCK, tokenize=tok.encode)
    finally:
        chaos.configure()
    for rep in router.replicas().values():
        c_router.add_replica(rep)
    cf = fleet_serve(c_router, firsts + rest)
    add_launches(total, cf)
    answered = [(fc, w_) for fc, w_ in zip(cf["fcs"], fleet_ref) if fc.text is not None]
    moved = sum(len(fc.attempts) > 1 for fc in cf["fcs"])
    info(f"fleet (c) router.forward chaos 0.2 seed 0 [{gpu}]: {len(answered)}/{N_REQUESTS} "
         f"answered, {moved} failed over, "
         f"{sum(fc.error_reason == 'fleet:no_replica' for fc in cf['fcs'])} with no replica")
    require(all(fc.done.is_set() for fc in cf["fcs"]), "(c) every request is terminal under chaos")
    require(all(fc.tokens == w_ for fc, w_ in answered),
            "(c) every answered stream equals the single server's")

    tick = manager.tick()
    st = manager.state()
    drains = [e for e in st["events"] if e[0] == "drain"]
    info(f"fleet (c) replica.health chaos 0.5 seed {seed}, one tick [{gpu}]: {tick}; "
         f"events {st['events']}")
    require(len(drains) == 1 and st["respawns"] == 1 and len(router) == 2,
            "(c) one drain and one respawn")
    after = fleet_serve(router, rest[:8])
    add_launches(total, after)
    require(all(fc.text is not None for fc in after["fcs"])
            and [fc.tokens for fc in after["fcs"]] == fleet_ref[FLEET_HEADS:FLEET_HEADS + 8],
            "(c) the fleet answers 8/8 after the respawn, equal to the single server")
    manager.shutdown()
    del manager, router, c_router, rep, replicas, cf, f1, f2, after, fcs, answered
    gc.collect()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated(dev) - base
    info(f"  memory_allocated after the fleet's shutdown: {left} bytes over the baseline "
         f"(one pool: {pool_bytes})")
    require(abs(left) <= pool_bytes, "(c) memory_allocated back within one pool of the baseline")
    gone = {c: probes.hbm_stats()["current_bytes"].get(c, 0) for c in want}
    require(not any(gone.values()), f"(c) the replicas' entries left the HBM ledger ({gone})")
    return total


# ---------------------------------------------------------------- phase 14
# the RAG retrieval variants at phase 4's settings: the bank's doc width
# and token width, the retraction and backfill sizes, HNSW's cut of the
# corpus (a Python insert loop: 4,096 docs took ~57 s of the script's
# time), the listwise stage's queries and depth
LATE_SEQ, LATE_DC, N_RETRACT, N_BACKFILL, HNSW_DOCS = 96, 32, 1024, 512, 1024
LLM_QUERIES, LLM_K, LLM_NEW = 8, 16, 32


def recall_at(hits, truth) -> float:
    """Mean |hits & truth| / |truth| over queries (keys are corpus rows)."""
    return float(np.mean([len(set(h) & set(t)) / len(t) for h, t in zip(hits, truth)]))


def near_tie_swaps(got, want, scores, tol: float = TIE_TOL) -> tuple[int, bool]:
    """(keys of ``want`` missing from ``got``, every one a near-tie): a key
    may be missing only where its score lies within ``tol`` of the last
    score ``got`` kept."""
    missing, ok = 0, True
    for g, w, s in zip(got, want, scores):
        gone = [i for i, k in enumerate(w) if k not in set(g)]
        missing += len(gone)
        ok &= all(abs(s[i] - s[-1]) <= tol for i in gone)
    return missing, ok


def run_int8_encoders(dev, gpu: str, docs, queries, pipe) -> int:
    """Phase 14 (a); returns the flash_attn launches of the int8 arms
    (not of the bf16 arm, the f32 truth or the bf16 rerank beside them)."""
    import dataclasses

    import torch

    from pathway_tpu_torch import CrossEncoderModel, SentenceEmbedderModel
    from pathway_tpu_torch.engine import probes
    from pathway_tpu_torch.models import decoder as D
    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.models.transformer import MINILM_L6

    launches = 0
    # phase 8's defaults seam without dedup (each arm must encode); each
    # model holds its own entry on the HBM ledger
    arms = {"off": seam(dev, dedup=False), "on": seam(dev, dedup=False, weight_quant="int8")}
    params = arms["on"].model.params
    emb = params["embeddings"]
    owned = {n: probes.hbm_owner_bytes(a.model.hbm_owner) for n, a in arms.items()}
    ledger = owned["on"].get("weights.embedder", 0)
    bf16 = sum(D.params_device_bytes(arms["off"].model.params).values())
    quantized = ("qkv_w", "attn_out_w", "mlp_in_w", "mlp_out_w")
    int8 = sum(t.numel() for t in D._tensor_leaves(params) if t.dtype == torch.int8)
    scales = 4 * (emb["word_scale"].numel()
                  + sum(params["layers"][n + "_scale"].numel() for n in quantized))
    rest = sum(t.numel() * t.element_size() for t in D._tensor_leaves(params)
               if t.dtype == torch.bfloat16)
    info(f"int8 encoders (a) [{gpu}]: weights.embedder {ledger} bytes = int8 payloads {int8} "
         f"+ scales {scales} + bf16 rest {rest}; the bf16 arm's entry "
         f"{owned['off'].get('weights.embedder', 0)} (its weights: {bf16})")
    require(emb["word"].dtype == torch.int8 and emb["word_scale"].dtype == torch.float32
            and all(params["layers"][n].dtype == torch.int8
                    and params["layers"][n + "_scale"].dtype == torch.float32
                    for n in quantized),
            "(a) the int8 marker, payloads and f32 scales are there")
    require(owned["on"] == {"weights.embedder": int8 + scales + rest}
            and owned["off"] == {"weights.embedder": bf16},
            "(a) the ledger holds both arms: the int8 arm's weights.embedder equals its int8 "
            "payloads plus the scales (and the bf16 rest), the bf16 arm's its weights")
    runs = {"off": [], "on": []}
    for name in ("off", "on", "on", "off"):
        r = ingest(arms[name], docs)
        if name == "on":
            launches += r["launches"]
        runs[name].append(r)
    vec = {n: runs[n][0]["vecs"] for n in runs}
    same = all(np.array_equal(runs[n][0]["vecs"], runs[n][1]["vecs"]) for n in runs)
    cos = np.sum(vec["on"] * vec["off"], axis=1)
    # truth: exact f32 scoring of an f32 model's embeddings (same seeded weights)
    f32 = SentenceEmbedderModel(dataclasses.replace(MINILM_L6, dtype=torch.float32),
                                max_length=64, device=dev)
    c32 = np.concatenate([f32.embed_batch(docs[s : s + INGEST_BATCH])
                          for s in range(0, len(docs), INGEST_BATCH)])
    truth = np.argsort(-(f32.embed_batch(queries) @ c32.T), axis=1, kind="stable")[:, :TOP_K]
    FA.flash_attn.launches = 0
    q8 = arms["on"].model.embed_batch(queries)
    launches += FA.flash_attn.launches
    f32.close()
    hits = np.argsort(-(q8 @ vec["on"].T), axis=1, kind="stable")[:, :TOP_K]
    recall = recall_at(hits, truth)
    dps = {n: [r["docs_per_s"] for r in runs[n]] for n in runs}
    info(f"int8 encoders (a) ingest {len(docs)} docs, defaults seam without dedup, off/on/on/off "
         f"[{gpu}]: docs/s off {dps['off']}, on {dps['on']}; per-row cosine int8 vs bf16 min "
         f"{float(cos.min()):.6f} mean {float(cos.mean()):.6f}; recall@10 of the int8 corpus "
         f"{recall:.4f} against exact f32 scoring")
    require(same, "(a) each arm's two ingests are byte-equal")
    require(float(cos.min()) >= 0.99, "(a) per-row cosine int8 vs bf16 >= 0.99")
    require(recall >= 0.9, "(a) recall@10 of the int8 corpus >= 0.9 against exact f32 scoring")
    for a in arms.values():
        a.close()
    require(not any(probes.hbm_owner_bytes(a.model.hbm_owner) for a in arms.values()),
            "(a) close() drops both arms from the ledger")

    # one int8 cross-encoder rerank at k=32 beside the bf16 one (phase 4's
    # pipeline, its reranker swapped for the call)
    base = [pipe.retrieve_rerank(q, k=RERANK_K) for q in queries[:8]]
    ce, pipe.reranker = pipe.reranker, CrossEncoderModel(MINILM_L6, device=dev,
                                                         weight_quant="int8")
    FA.flash_attn.launches = 0
    try:
        q_rows = [pipe.retrieve_rerank(q, k=RERANK_K) for q in queries[:8]]
    finally:
        pipe.reranker.close()
        pipe.reranker = ce
    launches += FA.flash_attn.launches
    overlap = statistics.mean(len({k for k, _ in a[:8]} & {k for k, _ in b[:8]}) / 8
                              for a, b in zip(q_rows, base))
    info(f"int8 encoders (a) CrossEncoderModel(weight_quant='int8') rerank k={RERANK_K}, 8 "
         f"queries [{gpu}]: top-8 overlap with the bf16 rerank {overlap:.4f} (reported)")
    require(all(sorted(k for k, _ in a) == sorted(k for k, _ in b) for a, b in zip(q_rows, base)),
            "(a) the int8 rerank reorders the same candidates")
    return launches


def run_ann(dev, gpu: str, docs, queries) -> None:
    """Phase 14 (b): IVF-Flat and HNSW beside the brute-force index."""
    import torch

    from pathway_tpu_torch import BruteForceKnnIndex, SentenceEmbedderModel
    from pathway_tpu_torch.models.transformer import MINILM_L6
    from pathway_tpu_torch.ops.hnsw import HnswIndex
    from pathway_tpu_torch.ops.ivf import IvfFlatIndex

    require(torch.backends.cuda.matmul.allow_tf32 is False,
            "(b) TF32 is off: k-means and the IVF products run in full f32")
    emb = SentenceEmbedderModel(MINILM_L6, max_length=64, device=dev)
    vecs = np.concatenate([emb.embed_batch(docs[s : s + INGEST_BATCH])
                           for s in range(0, len(docs), INGEST_BATCH)])
    qv = emb.embed_batch(queries)
    emb.close()
    rows = list(range(len(docs)))

    def timed(fn, reps: int = 5) -> tuple:
        out = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / reps * 1e3

    bf = BruteForceKnnIndex(MINILM_L6.hidden, reserved_space=len(docs), device=dev)
    bf.add(rows, vecs)
    exact, bf_ms = timed(lambda: bf.search(qv, TOP_K))
    ex_keys = [[k for k, _ in r] for r in exact]
    ex_scores = [[s for _, s in r] for r in exact]

    def build(dtype=torch.bfloat16, device_add=False):
        ix = IvfFlatIndex(MINILM_L6.hidden, device=dev, dtype=dtype)
        t0 = time.perf_counter()
        for s in range(0, len(docs), INGEST_BATCH):
            if device_add:
                ix.add_device(rows[s : s + INGEST_BATCH],
                              torch.from_numpy(vecs[s : s + INGEST_BATCH]).to(dev))
            else:
                ix.add(rows[s : s + INGEST_BATCH], vecs[s : s + INGEST_BATCH])
        torch.cuda.synchronize()
        return ix, time.perf_counter() - t0

    def probe(ix, nprobe):
        ix.nprobe = nprobe
        res, ms = timed(lambda: ix.search(qv, TOP_K))
        return [[k for k, _ in r] for r in res], ms

    ivf, build_s = build()
    rec, ms = {}, {}
    keys = {}
    for npr in (8, 16, ivf.n_cells):
        keys[npr], ms[npr] = probe(ivf, npr)
        rec[npr] = recall_at(keys[npr], ex_keys)
    missing, ties = near_tie_swaps(keys[ivf.n_cells], ex_keys, ex_scores)
    q8, build8_s = build(torch.int8)
    rec8 = {}
    for npr in (8, q8.n_cells):
        k8, _ = probe(q8, npr)
        rec8[npr] = recall_at(k8, ex_keys)
    dv, _ = build(device_add=True)
    same = {}
    for npr in (8, dv.n_cells):
        kd, _ = probe(dv, npr)
        ivf.nprobe = npr
        kh, _ = probe(ivf, npr)
        same[npr] = sum(a == b for a, b in zip(kd, kh))
    info(f"ann (b) IvfFlatIndex 64 cells over {len(docs)} MiniLM-L6 embeddings [{gpu}]: build "
         f"{build_s:.3f} s (int8 cells {build8_s:.3f} s), cell capacity {ivf.cell_cap}; recall@10 "
         f"vs BruteForceKnnIndex at nprobe 8 / 16 / 64: {rec[8]:.4f} / {rec[16]:.4f} / "
         f"{rec[ivf.n_cells]:.4f}; search ms for {len(queries)} queries {ms[8]:.3f} / "
         f"{ms[16]:.3f} / {ms[ivf.n_cells]:.3f} (brute force {bf_ms:.3f}); exhaustive probing "
         f"misses {missing} keys, all near-ties: {ties}; int8 cells recall@10 at nprobe 8 / 64 "
         f"{rec8[8]:.4f} / {rec8[q8.n_cells]:.4f}; add_device rows equal to add at nprobe 8 / "
         f"64: {same[8]} / {same[dv.n_cells]} of {len(queries)}")
    require(ties, "(b) exhaustive probing returns the brute-force top 10 but at near-ties")
    require(rec[8] <= rec[16] <= rec[ivf.n_cells],
            "(b) recall@10 does not fall from nprobe 8 to 16 to 64 (nested probes)")
    kd, _ = probe(dv, dv.n_cells)
    require(same[dv.n_cells] == len(queries) or all(
        ranks_agree([(k, s) for k, s in zip(w, ws)], [(k, s) for k, s in zip(g, ws)])
        for g, w, ws in zip(kd, ex_keys, ex_scores)),
        "(b) add_device and add give equal search results (exhaustive probing)")
    gone = rows[:N_RETRACT]
    ivf.remove(gone)
    after, _ = probe(ivf, ivf.n_cells)
    back = [[k for k, _ in r] for r in ivf.search(vecs[:64], TOP_K)]
    require(len(ivf) == len(docs) - N_RETRACT
            and not set(gone) & {k for r in after + back for k in r},
            f"(b) after removing {N_RETRACT} keys none of them is returned")
    del ivf, q8, dv

    n = HNSW_DOCS
    hn = HnswIndex(MINILM_L6.hidden)
    t0 = time.perf_counter()
    for s in range(0, n, 512):
        hn.add(rows[s : s + 512], vecs[s : s + 512])
    insert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hres = hn.search(qv, TOP_K)
    search_ms = (time.perf_counter() - t0) * 1e3
    # exact scoring, as tests/test_hnsw.py's numpy truth: the brute-force
    # index in f32 (the bf16 one reorders these crowded random-weight
    # embeddings at its rounding)
    small = BruteForceKnnIndex(MINILM_L6.hidden, reserved_space=n, device=dev,
                               dtype=torch.float32, f32_scores=True)
    small.add(rows[:n], vecs[:n])
    truth = [[k for k, _ in r] for r in small.search(qv, TOP_K)]
    h_rec = {hn.ef_search: recall_at([[k for k, _ in r] for r in hres], truth)}
    # the default expansion_search (64) falls short of the bar on this data;
    # the same graph searched wider
    hn.ef_search = 128
    h_rec[128] = recall_at([[k for k, _ in r] for r in hn.search(qv, TOP_K)], truth)
    info(f"ann (b) HnswIndex (host numpy) over the first {n} docs [{gpu} host]: insert "
         f"{insert_s:.3f} s, search {search_ms:.3f} ms for {len(queries)} queries "
         f"(expansion_search 64); recall@10 vs the f32 BruteForceKnnIndex at "
         f"expansion_search 64 / 128: {h_rec[64]:.4f} / {h_rec[128]:.4f}")
    require(h_rec[128] >= 0.9, "(b) HNSW recall@10 >= 0.9 against the exact brute-force "
                               "index (expansion_search 128)")


def run_late_bank(dev, gpu: str, docs, queries):
    """Phase 14 (c); returns (flash_attn launches, embedder, cross-encoder)."""
    import torch

    from pathway_tpu_torch import (CrossEncoderModel, FusedRAGPipeline, QueryServer,
                                   SentenceEmbedderModel)
    from pathway_tpu_torch.engine import probes
    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.models.transformer import MINILM_L6
    from pathway_tpu_torch.ops.late_bank import bank_row_bytes

    emb = SentenceEmbedderModel(MINILM_L6, max_length=64, device=dev)
    ce = CrossEncoderModel(MINILM_L6, device=dev)
    FA.flash_attn.launches = 0
    pipe = FusedRAGPipeline(emb, ce, reserved_space=len(docs), doc_seq=LATE_SEQ,
                            pair_seq=160, late_interaction=True, late_dim=LATE_DC,
                            rerank_cascade=True)
    keys = [f"k{i}" for i in range(len(docs))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, len(docs), INGEST_BATCH):
        pipe.add(keys[s : s + INGEST_BATCH], docs[s : s + INGEST_BATCH])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    row = bank_row_bytes(LATE_SEQ, LATE_DC)

    def gauge():
        return probes.hbm_owner_bytes(pipe.hbm_owner).get("late_bank", 0)

    info(f"late bank (c) {len(docs)} docs at doc_seq {LATE_SEQ}, dc {LATE_DC} [{gpu}]: ingest "
         f"with the bank build {build_s:.3f} s ({len(docs) / build_s:.1f} docs/s); late_bank "
         f"{gauge()} bytes (= {len(docs)} x {row})")
    require(gauge() == len(docs) * row == probes.hbm_stats()["current_bytes"]["late_bank"],
            "(c) the late_bank gauge equals live rows x bank_row_bytes(96, 32)")

    arms = {"full": dict(rerank_cascade=False, late_interaction=False),
            "encoder cascade": dict(rerank_cascade=True, late_interaction=False),
            "maxsim cascade": dict(rerank_cascade=True, late_interaction=True)}
    rows, p50, flops = {}, {}, {}
    for name, kw in arms.items():
        pipe.__dict__.update(kw)
        c0 = probes.cascade_stats()
        rows[name] = pipe.retrieve_rerank_batch(queries, RERANK_K)
        c1 = probes.cascade_stats()
        flops[name] = {st: (c1["gflops"].get(st, 0) - c0["gflops"].get(st, 0)) * 1e9
                       / max(1, c1["pairs"].get(st, 0) - c0["pairs"].get(st, 0))
                       for st in ("cheap", "maxsim", "full")
                       if c1["pairs"].get(st, 0) > c0["pairs"].get(st, 0)}
        lat, loop = [], []
        for q in queries:
            t1 = time.perf_counter()
            loop.append(pipe.retrieve_rerank(q, RERANK_K))
            lat.append(time.perf_counter() - t1)
        p50[name] = statistics.median(lat) * 1e3
        if name == "maxsim cascade":
            agree = [ranks_agree(b, lo) for b, lo in zip(rows[name], loop)]
    overlap = {n: statistics.mean(len({k for k, _ in a[:8]} & {k for k, _ in b[:8]}) / 8
                                  for a, b in zip(rows[n], rows["full"])) for n in rows}
    info(f"late bank (c) {len(queries)} queries at k={RERANK_K} [{gpu}]: p50 ms per query "
         + ", ".join(f"{n} {p50[n]:.3f}" for n in p50) + "; top-8 overlap with the full rerank "
         + ", ".join(f"{n} {overlap[n]:.4f}" for n in overlap if n != "full")
         + f"; FLOPs a pair by stage {flops}; batched MaxSim rows equal to the per-query loop "
         f"{sum(agree)}/{len(agree)}")
    require(all(agree), "(c) batched MaxSim results equal a per-query loop but at near-ties")
    require(all(sorted(k for k, _ in a) == sorted(k for k, _ in b)
                for a, b in zip(rows["maxsim cascade"], rows["full"])),
            "(c) the MaxSim cascade reorders the full rerank's candidates")

    before = gauge()
    pipe.remove(keys[:N_RETRACT])
    require(before - gauge() == N_RETRACT * row,
            f"(c) retracting {N_RETRACT} docs lowers the gauge by exactly their bytes")
    pipe.late_interaction = False
    extra = [f"x{i}" for i in range(N_BACKFILL)]
    pipe.add(extra, docs[:N_BACKFILL])
    pipe.late_interaction = True
    d0 = probes.dispatch_counts().get("late_bank_build", 0)
    pipe.retrieve_rerank(queries[0], RERANK_K)
    built = probes.dispatch_counts().get("late_bank_build", 0) - d0
    require(built == N_BACKFILL // 256 and bool(pipe._bank_valid[: pipe.index.n].all())
            and gauge() == pipe.index.n * row,
            f"(c) one query backfilled the {N_BACKFILL} docs added with the flag off "
            f"({built} bank builds)")

    with QueryServer(pipe) as srv:
        served, errs = wait_all([srv.submit(q, RERANK_K, rerank=True) for q in queries])
    per_call = [pipe.retrieve_rerank(q, RERANK_K) for q in queries]
    agree = [ranks_agree(w, g) for w, g in zip(per_call, served)]
    info(f"late bank (c) QueryServer over the MaxSim cascade [{gpu}]: {sum(agree)}/"
         f"{len(queries)} rows agree with the per-call path")
    require(not any(errs) and all(agree),
            "(c) QueryServer's keys equal the per-call path's but at near-ties")
    pipe.close()
    require(gauge() == 0, "(c) close() lets the bank go and drops it from the ledger")
    return FA.flash_attn.launches, emb, ce


def run_llm_rerank(dev, gpu: str, common, emb, ce, docs, queries) -> dict:
    """Phase 14 (d); returns the launches of its run."""
    import threading

    import torch

    from pathway_tpu_torch import DecoderChat, FusedRAGPipeline
    from pathway_tpu_torch.engine import probes, tracing
    from pathway_tpu_torch.xpacks.llm import ListwiseLLMReranker

    chat = DecoderChat(paged_kv=True, paged_kv_block=BLOCK, paged_kernel=True,
                       flash_prefill=True, **dict(common, max_new_tokens=LLM_NEW,
                                                   max_prompt_tokens=1024 - LLM_NEW))
    cap = chat.max_prompt_tokens
    pipe = FusedRAGPipeline(emb, ce, reserved_space=len(docs), doc_seq=32, pair_seq=160,
                            llm_reranker=ListwiseLLMReranker(chat), llm_rerank=False)
    keys = [f"k{i}" for i in range(len(docs))]
    for s in range(0, len(docs), INGEST_BATCH):
        pipe.add(keys[s : s + INGEST_BATCH], docs[s : s + INGEST_BATCH])
    qs = queries[:LLM_QUERIES]
    base = pipe.retrieve_rerank_batch(qs, LLM_K)

    def longest(rr) -> int:
        """Tokens of the longest prompt a round can send: the query with
        the window's longest candidates, framed as the chat frames it."""
        return max(len(chat.tokenizer.encode(chat._format_prompt([{
            "role": "user", "content": rr._window_prompt(q, sorted(
                (pipe._text_by_key[k] for k, _ in row), key=len)[-rr.window:])}])))
            for q, row in zip(qs, base))

    # the largest window whose prompts fit whole within GPT-2's positions
    rr = next(r for r in (ListwiseLLMReranker(chat, window=w, stride=w // 2) for w in (8, 6, 4))
              if longest(r) <= cap)
    pipe.llm_reranker, pipe.llm_rerank = rr, True
    parsed = []
    parse = rr._parse_permutation
    rr._parse_permutation = lambda text, n: parsed.append(parse(text, n)) or parsed[-1]
    tracing.reset_traces()
    for f in counters().values():
        f.launches = 0
    c0 = probes.cascade_stats()["pairs"].get("llm_rerank", 0)
    out: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    worker = threading.Thread(
        target=lambda: out.update(rows=pipe.retrieve_rerank_batch(qs, LLM_K)), daemon=True)
    worker.start()
    worker.join(600.0)
    wall = time.perf_counter() - t0
    launches = {n: f.launches for n, f in counters().items()}
    spans = chat.recent_traces()
    pairs = probes.cascade_stats()["pairs"].get("llm_rerank", 0) - c0
    n_windows = sum(len(rr._window_starts(len(r))) for r in base)
    failed = chat.server.failed
    chat.close()
    require(not worker.is_alive() and failed is None,
            "(d) every listwise request terminal within 600 s, the serving loop alive")
    got = out["rows"]
    info(f"listwise (d) GPT-2-small, int8 weights, paged, window {rr.window}, stride "
         f"{rr.stride}, {LLM_QUERIES} queries at k={LLM_K} [{gpu}]: {wall:.3f} s wall, "
         f"{wall / LLM_QUERIES * 1e3:.1f} ms a query; {n_windows} windows, longest prompt "
         f"{longest(rr)} tokens (cap {cap}, + {LLM_NEW} new); replies that parsed "
         f"{sum(p is not None for p in parsed)}/{len(parsed)}; llm_rerank pairs {pairs}; "
         f"launches {launches}")
    require(all(sorted(k for k, _ in g) == sorted(k for k, _ in b) and dict(g) == dict(b)
                for g, b in zip(got, base)),
            "(d) every row is a permutation of its cross-encoder row, scores kept")
    require(pairs == LLM_QUERIES * LLM_K, "(d) the llm_rerank pairs are counted")
    require(len(spans) == n_windows == len(parsed)
            and {sp["attrs"]["tenant"] for sp in spans} == {"rerank"},
            "(d) one request a window, every request span of tenant rerank")
    require(max(sp["attrs"]["prompt_tokens"] for sp in spans) <= longest(rr) <= cap,
            "(d) every window prompt fits the cache whole")
    pipe.close()
    emb.close()
    ce.close()
    return launches


# ---------------------------------------------------------------- phase 15
# the parallel layer and the serving mesh. (b) runs JAX's bench config for
# mesh serving (bench.py's config6_mesh_serving, full mode): f32, vocab 256,
# hidden 64, 4 layers, 8 heads, ffn 128, 8 slots, chunks of 8, 16 requests of
# 24 tokens, on (data=1, fsdp=2, tp=4) over 8 virtual positions of the card
# (GPT-2 small's vocab of 50,257 divides no tp > 1)
TP_REQUESTS, TP_NEW, TP_SLOTS, TP_CHUNK, TP_PIECE = 16, 24, 8, 8, 16
N_TRIVIAL, RING_SP, RING_SHARD, RING_TOL = 16, 4, 64, 2e-3


def tp_config():
    import torch

    from pathway_tpu_torch.models import decoder as D

    return D.DecoderConfig(vocab_size=256, hidden=64, layers=4, heads=8, intermediate=128,
                           max_position=256, dtype=torch.float32)


def run_mesh_trivial(dev, gpu: str, common) -> dict:
    """Phase 15 (a); returns its launches. Spec and autotune stay pinned off
    as in phases 6-13: with them a bf16 stream depends on the schedule
    (verify and plain steps differ in their products' M), and the two arms
    must run the same code to be compared byte for byte."""
    from pathway_tpu_torch import DecoderChat
    from pathway_tpu_torch.parallel import make_serving_mesh

    prompts = make_prompts(N_TRIVIAL, 16, 480, seed=15)
    total, outs = {n: 0 for n in counters()}, {True: [], False: []}
    mesh1 = make_serving_mesh([dev])
    for on in (True, False, False, True):  # in turns: the host clock drifts
        chat = DecoderChat(paged_kv=True, paged_kv_block=BLOCK, paged_kernel=True,
                           flash_prefill=True, mesh=mesh1 if on else None, **common)
        out = serve(chat, prompts)
        add_launches(total, out)
        outs[on].append(out)
        info(f"mesh (a) {'1x1x1 mesh' if on else 'no mesh'} [{gpu}]: {N_TRIVIAL} requests "
             f"in {out['wall_s']:.3f} s wall; decode {out['tok_per_s']:.1f} tokens/s; "
             f"launches {out['launches']}")
        free_chats(chat)
    ref = streams(outs[False][0])
    same = min(sum(a == b for a, b in zip(streams(o), ref)) for o in outs[True] + outs[False])
    ratio = (statistics.mean(o["tok_per_s"] for o in outs[True])
             / statistics.mean(o["tok_per_s"] for o in outs[False]))
    info(f"mesh (a) [{gpu}]: tokens/s 1x1x1 mesh / no mesh {ratio:.4f} (means of 2)")
    require(same == N_TRIVIAL, f"(a) the 1x1x1 mesh serves the mesh-off streams token for "
                               f"token ({same}/{N_TRIVIAL}, every arm)")
    return total


def per_dispatch(D):
    """Wrap the decode chunk, the prefill piece and the whole-prompt
    admissions: each call records its name, its steps (1 for the others)
    and the launches it made."""
    names = ("pool_decode_chunk", "pool_prefill_chunk", "pool_admit", "pool_admit_batch")
    orig = {n: getattr(D, n) for n in names}
    rec = []

    def wrap(n):
        def f(*a, **k):
            before = {m: c.launches for m, c in counters().items()}
            out = orig[n](*a, **k)
            rec.append((n, a[5] if n == "pool_decode_chunk" else 1,
                        {m: c.launches - before[m] for m, c in counters().items()}))
            return out
        return f

    for n in names:
        setattr(D, n, wrap(n))
    return rec, lambda: [setattr(D, n, f) for n, f in orig.items()]


def run_mesh_tp(dev, gpu: str, tok) -> tuple[dict, dict]:
    """Phase 15 (b); returns its launches and the int8 arm's sharded params."""
    import torch

    from pathway_tpu_torch import DecoderChat
    from pathway_tpu_torch.engine import probes
    from pathway_tpu_torch.models import decoder as D
    from pathway_tpu_torch.parallel import ShardedTensor, make_serving_mesh

    cfg = tp_config()
    params = D.init_params(torch.Generator().manual_seed(0), cfg)
    mesh = make_serving_mesh([dev] * 8, data=1, fsdp=2, tp=4)
    tp, L = 4, cfg.layers
    prompts = make_prompts(TP_REQUESTS, 8, 60, seed=16)
    total, kept = {n: 0 for n in counters()}, None
    for quant, paged in ((None, True), ("int8", True), (None, False)):
        texts, tps = {}, {}
        what = f"{'paged' if paged else 'dense'} pool, weights {quant or 'f32'}"
        for arm in (mesh, None):
            probes.reset_hbm_stats()
            chat = DecoderChat(params=params, cfg=cfg, tokenizer=tok, continuous=True,
                               n_slots=TP_SLOTS, chunk_steps=TP_CHUNK, max_new_tokens=TP_NEW,
                               max_prompt_tokens=64, prefill_chunk=TP_PIECE, pipeline_depth=2,
                               paged_kv=paged, paged_kernel=paged, flash_prefill=True,
                               weight_quant=quant, wq_kernel=bool(quant), spec_decode=False,
                               chunk_autotune=False, device=dev, mesh=arm)
            chat.resolve_batch([chat.submit_batch(prompts[:1])])  # warm-up
            rec, undo = per_dispatch(D)
            for c in counters().values():
                c.launches = 0
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                reqs = chat.submit_batch(prompts)
                out = chat.resolve_batch([reqs])[0]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                undo()
            launches = {n: c.launches for n, c in counters().items()}
            require(chat.server.failed is None and all(
                t is not None and len(r.tokens) == TP_NEW for r, t in zip(reqs, out)),
                f"(b) every request of the {'tp=4' if arm else 'no-mesh'} arm served "
                f"{TP_NEW} tokens")
            texts[arm is not None] = [r.tokens for r in reqs]
            tps[arm is not None] = TP_REQUESTS * TP_NEW / wall
            k = tp if arm is not None else 1
            piece, dec_ = "pool_prefill_chunk", "pool_decode_chunk"
            bad = [(n, s, d) for n, s, d in rec if d != {
                "flash_attn": L * k if n.startswith("pool_admit") else 0,
                "flash_chunk_attn": L * k if n == piece and not paged else 0,
                "flash_chunk_attn_paged": L * k if n == piece and paged else 0,
                "paged_attn_decode": s * L * k if n == dec_ and paged else 0,
                "wq_matmul": s * L * 4 * k if quant else 0}]
            n_dec = sum(n == dec_ for n, _, _ in rec)
            require(not bad and n_dec > 0 and len(rec) > n_dec,
                    f"(b) {'tp=4' if arm else 'no mesh'}, {what}: every one of {n_dec} decode "
                    f"chunks and {len(rec) - n_dec} prefill dispatches launched each kernel "
                    f"once per layer (per step) and per tp shard ({k}){bad[:1]}")
            add_launches(total, {"launches": launches})
            if arm is not None:
                srv = chat.server
                comp = "kv_blocks" if paged else "slot_pool"
                per_pos = D.pool_component_device_bytes(srv.pool)[comp]
                whole = D.pool_component_bytes(srv.pool)[comp]
                require(isinstance(srv.pool["kb" if paged else "k"], ShardedTensor)
                        and sorted(per_pos) == [str(i) for i in range(8)]
                        and all(v * tp == whole for v in per_pos.values()),
                        f"(b) KV bytes per mesh position {sorted(set(per_pos.values()))} = "
                        f"total {whole} / tp")
                ledger = probes.hbm_stats()["per_device_bytes"]
                require(set(ledger) >= {str(i) for i in range(8)},
                        "(b) the HBM ledger holds all 8 mesh positions")
                if quant and paged:
                    kept = srv.params
            info(f"mesh (b) {'tp=4 (data=1, fsdp=2)' if arm else 'no mesh'}, {what} "
                 f"[{gpu}]: {TP_REQUESTS} x {TP_NEW} tokens in {wall:.3f} s; "
                 f"{tps[arm is not None]:.1f} tokens/s; launches {launches}")
            free_chats(chat)
        same = sum(a == b for a, b in zip(texts[True], texts[False]))
        info(f"mesh (b) {what} [{gpu}]: tokens/s tp=4 / no mesh {tps[True] / tps[False]:.3f}")
        require(same == TP_REQUESTS, f"(b) {what}: tp=4 streams equal the no-mesh streams "
                                     f"({same}/{TP_REQUESTS})")
    require(all(v > 0 for v in total.values()), "(b) drove all five kernel entry points")
    return total, kept


def run_mesh_retrieval(dev, gpu: str, out, docs, queries) -> int:
    """Phase 15 (c); returns its flash_attn launches."""
    from pathway_tpu_torch import FusedRAGPipeline, QueryServer
    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.parallel import ShardedIvfIndex, ShardedKnnIndex, make_mesh

    pipe, emb = out["pipe"], out["emb"]
    n = pipe.index.n
    keys = list(pipe.index._keys[:n])
    vecs = pipe.index._corpus[:n].float().cpu().numpy()
    FA.flash_attn.launches = 0
    qv = emb.embed_batch(queries)
    mesh = make_mesh([dev] * 4, dp=4)
    exact, bf_ms = time_fn(lambda: pipe.index.search(qv, TOP_K))
    want = [[k for k, _ in r] for r in exact]
    scores = [[s for _, s in r] for r in exact]
    knn = ShardedKnnIndex(mesh, emb.cfg.hidden, reserved_space=n)
    for k_, v in zip(keys, vecs):
        knn.add(k_, v)
    ivf = ShardedIvfIndex(mesh, emb.cfg.hidden, n_cells=16, nprobe=16)
    t0 = time.perf_counter()
    ivf.add_bulk(keys, vecs)
    build_s = time.perf_counter() - t0
    for name, ix in (("ShardedKnnIndex", knn), ("ShardedIvfIndex nprobe=n_cells", ivf)):
        got, ms = time_fn(lambda ix=ix: ix.search(qv, TOP_K))
        missing, ties = near_tie_swaps([[k for k, _ in r] for r in got], want, scores)
        info(f"mesh (c) {name} dp=4 over {n} docs [{gpu}]: search {ms:.3f} ms for "
             f"{len(queries)} queries (brute force {bf_ms:.3f} ms); keys missing {missing}")
        require(ties, f"(c) {name}: keys equal brute force's but at near-ties")
    info(f"mesh (c) ShardedIvfIndex add_bulk of {n} docs: {build_s:.2f} s")
    mpipe = FusedRAGPipeline(emb, None, reserved_space=n, doc_seq=32, pair_seq=160,
                             mesh_retrieval=mesh)
    for s in range(0, len(docs), INGEST_BATCH):
        mpipe.add([f"k{i}" for i in range(s, s + INGEST_BATCH)], docs[s:s + INGEST_BATCH])
    require(len(mpipe.sharded_index) == len(docs), "(c) the pipeline mirrors every doc")
    per_call = [mpipe.retrieve([q], TOP_K)[0] for q in queries]
    with QueryServer(mpipe) as srv:
        handles = [srv.submit(q, TOP_K) for q in queries]
        served = [h.wait(120) for h in handles]
    agree = all(ranks_agree(w, g) for w, g in zip(per_call, served))
    info(f"mesh (c) FusedRAGPipeline(mesh_retrieval) through QueryServer: {len(queries)} "
         f"queries, ranks agree with the per-call path: {agree}")
    require(agree, "(c) QueryServer over the sharded mirror equals the per-call path but "
                   "at near-ties")
    mpipe.close()
    return FA.flash_attn.launches


def run_ring_attention(dev, gpu: str) -> int:
    """Phase 15 (d); returns the baseline encode's flash_attn launches."""
    import dataclasses

    import torch

    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.models import transformer as T
    from pathway_tpu_torch.parallel import Mesh, encode_sequence_parallel

    cfg = dataclasses.replace(T.MINILM_L6, dtype=torch.float32)
    params = T.map_params(lambda t: t.to(dev), T.init_params(15, cfg))
    S = RING_SP * RING_SHARD
    rng = np.random.default_rng(15)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, S)).astype(np.int32)).to(dev)
    mask = torch.ones((2, S), dtype=torch.int32, device=dev)
    mask[1, S - 40:] = 0
    mesh = Mesh([dev] * RING_SP, (RING_SP,), ("sp",))
    FA.flash_attn.launches = 0
    ref = T.encode(params, ids, mask, cfg)
    launches = FA.flash_attn.launches
    got = encode_sequence_parallel(params, ids, mask, cfg, mesh)
    live = mask.bool()[:, :, None].expand_as(ref)
    err = (got - ref).abs()[live].max().item()
    _, ring_ms = time_fn(lambda: encode_sequence_parallel(params, ids, mask, cfg, mesh))
    _, flash_ms = time_fn(lambda: T.encode(params, ids, mask, cfg))
    info(f"mesh (d) ring attention, MiniLM-L6 f32, sp={RING_SP} x {RING_SHARD} tokens, "
         f"batch 2 [{gpu}]: max abs diff at live positions vs the flash_attn encode "
         f"{err:.3e} (<= {RING_TOL}); {ring_ms:.3f} ms vs {flash_ms:.3f} ms")
    require(err <= RING_TOL and launches == cfg.layers,
            "(d) the sequence-parallel encode equals the flash_attn encode")
    return launches


def time_fn(fn, reps: int = 5):
    import torch

    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / reps * 1e3


def same_tree(a: dict, b: dict) -> bool:
    """Leaf for leaf bitwise equal (sharded leaves gathered)."""
    import torch

    from pathway_tpu_torch.parallel import ShardedTensor

    def flat(t, p=""):
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                yield from flat(v, p + k + "/")
            else:
                v = v.gather() if isinstance(v, ShardedTensor) else v
                v = v.cpu()
                yield p + k, v.view(torch.int16) if v.dtype == torch.bfloat16 else v

    fa, fb = dict(flat(a)), dict(flat(b))
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]) for k in fa)


def run_mesh_checkpoints(dev, gpu: str, params, tp_params) -> None:
    """Phase 15 (e): GPT-2 small saved from the one-position mesh, (b)'s
    config saved from the tp=4 mesh; each back bitwise on the host and on
    its mesh."""
    import tempfile

    from pathway_tpu_torch.models import checkpoint as C
    from pathway_tpu_torch.models import decoder as D
    from pathway_tpu_torch.parallel import ShardedTensor, make_serving_mesh

    with tempfile.TemporaryDirectory() as tmp:
        mesh1 = make_serving_mesh([dev])
        qp = D.quantize_params(D.map_params(lambda t: t.to(dev), params), D.GPT2_SMALL)
        placed = D.shard_decoder_params(qp, D.GPT2_SMALL, mesh1)
        t0 = time.perf_counter()
        C.save_checkpoint(f"{tmp}/gpt2", placed, mesh=mesh1)
        save_s = time.perf_counter() - t0
        host = C.load_checkpoint(f"{tmp}/gpt2", weight_quant="int8")
        on1 = C.load_checkpoint(f"{tmp}/gpt2", mesh=mesh1, weight_quant="int8")
        require(same_tree(host, qp) and same_tree(on1, qp)
                and on1["wte"].device.type == "cuda",
                f"(e) GPT-2 small (int8) from the 1x1x1 mesh back bitwise on the host and "
                f"the mesh (save {save_s:.1f} s)")
        mesh8 = make_serving_mesh([dev] * 8, data=1, fsdp=2, tp=4)
        C.save_checkpoint(f"{tmp}/tp", tp_params, mesh=mesh8)
        layout = C.checkpoint_layout(f"{tmp}/tp")
        host = C.load_checkpoint(f"{tmp}/tp", weight_quant="int8")
        on8 = C.load_checkpoint(f"{tmp}/tp", mesh=mesh8, weight_quant="int8")
        require(layout["mesh"]["shape"] == [1, 2, 4] and same_tree(host, tp_params)
                and same_tree(on8, tp_params)
                and isinstance(on8["layers"]["qkv_w"], ShardedTensor),
                "(e) (b)'s int8 config from the tp=4 mesh back bitwise on the host and "
                "resharded on the mesh")


# ---------------------------------------------------------------- phase 16
# the dataflow engine's config-4 program (bench.py's
# config4_streaming_engine, full mode): 6 x 16,384 docs of 24 words from a
# 7-word vocabulary (seed 11) through an in-process Kafka broker, full
# MiniLM-L6 at max_batch_size 1024, the brute-force index reserved at
# N + 512, cosine; 2 live queries at k = 10; one rep of each arm in turns
# (a second rep did not fit the script's time once phase 21 came)
# (the whole script stays near half its time limit).
# (d): 4,096 static docs and 64 queries through DataIndex.query
C4_DOCS, C4_REPS, C4_BATCH, C4_K = 6 * 8192, 1, 1024, 10
C4_WORDS = ["alpha", "beta", "gamma", "delta", "stream", "tensor", "index"]
C4_QUERIES = ["alpha stream tensor", "delta index beta"]
C4_STATIC_DOCS, C4_STATIC_QUERIES = 4096, 64
# the reply's scores come from the bf16 corpus and a bf16-rounded query
C4_SCORE_TOL, C4_COS_MIN, C4_TIE_TOL = 2e-2, 0.9999, 1e-3


def c4_texts(n: int, seed: int = 11, words: int = 24) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(C4_WORDS, words)) for _ in range(n)]


class EncodeCount:
    """Counts the encodes a model runs (the batches of ``embed_submit``
    that reach the device) by batch size, and keeps their texts;
    ``flash_attn`` must launch once a layer for each."""

    def __init__(self, model):
        self.model, self.sizes, self.batches = model, [], []
        self._submit = model.embed_submit

        def submit(texts):
            if texts:
                self.sizes.append(len(texts))
                self.batches.append(list(texts))
            return self._submit(texts)

        model.embed_submit = submit

    def reset(self) -> None:
        self.sizes, self.batches = [], []

    def close(self) -> None:
        self.model.embed_submit = self._submit


def encode_busy_ms(model, texts, sizes) -> float:
    """Device ms of the encodes of ``sizes`` rows each, from CUDA-event
    times of one encode per distinct padded batch (queue held): an
    estimate of a run's device busy time, not a trace."""
    import torch

    from pathway_tpu_torch.models.embedder import embed_fn
    from pathway_tpu_torch.models.tokenizer import pad_to_buckets

    per = {}
    total = 0.0
    for n in sizes:
        if n not in per:
            ids, mask = pad_to_buckets(*model.tokenizer(texts[:n], max_length=model.max_length))
            ids, mask = (torch.from_numpy(a).to(model.device) for a in (ids, mask))
            per[n] = cuda_time_ms(lambda: embed_fn(model.params, ids, mask, model.cfg),
                                  3, warmup=1)
        total += per[n]
    return total


def c4_stream(pw, emb, payloads, n: int, timeout: float = 600.0) -> dict:
    """The config-4 program once: docs from a Kafka broker through the
    embed UDF into a DataIndex; 2 live queries arrive once half the docs
    are embedded and are answered as of that moment. Returns the embedded
    rows by row key, the replies and the run's wall."""
    import threading

    from pathway_tpu_torch.io.kafka import InMemoryKafkaBroker

    pw.clear_graph()
    broker = InMemoryKafkaBroker()
    for p in payloads:
        broker.produce("docs", p)
    broker.close()

    class DocSchema(pw.Schema):
        id: int
        text: str

    class QuerySchema(pw.Schema):
        qtext: str

    rows, replies, lock = {}, {}, threading.Lock()
    half = threading.Event()

    class LiveQueries(pw.io.python.ConnectorSubject):
        def run(self):
            if not half.wait(timeout):
                raise TimeoutError("half of the docs never arrived")
            for q in C4_QUERIES:
                self.next(qtext=q)
            self.commit()

    docs = pw.io.kafka.read(broker, topic="docs", schema=DocSchema)
    embedded = docs.select(docs.id, vec=emb(docs.text))
    index = pw.indexing.DataIndex(embedded, pw.indexing.BruteForceKnn(
        embedded.vec, dimensions=emb.get_embedding_dimension(), reserved_space=n + 512,
        metric="cos"))
    queries = pw.io.python.read(LiveQueries(), schema=QuerySchema)
    q_emb = queries.select(queries.qtext, qvec=emb(queries.qtext))
    res = index.query_as_of_now(q_emb.qvec, number_of_matches=C4_K, with_distances=True)
    res = res.select(res.vec, res._pw_dist, qtext=q_emb.restrict(res).qtext)

    def on_doc(key, row, time, is_addition):
        with lock:
            if is_addition:
                rows[key.value] = row["vec"]
            else:
                rows.pop(key.value, None)
            if len(rows) * 2 >= n:
                half.set()

    def on_reply(key, row, time, is_addition):
        with lock:
            if is_addition:
                replies[row["qtext"]] = (row["vec"], row["_pw_dist"])

    pw.io.subscribe(embedded, on_change=on_doc)
    pw.io.subscribe(res, on_change=on_reply)
    connectors = list(pw.G.connectors)

    def stopper():  # a bound on the run, not its end: the broker closes itself
        deadline = time.time() + timeout
        while time.time() < deadline:
            with lock:
                if len(rows) >= n and len(replies) >= len(C4_QUERIES):
                    return
            time.sleep(0.05)
        half.set()
        for c in connectors:
            c._stop.set()
            c.close()

    threading.Thread(target=stopper, daemon=True).start()
    t0 = time.perf_counter()
    pw.run()
    wall = time.perf_counter() - t0
    from pathway_tpu_torch.internals.run import LAST_RUN_STATS

    return {"rows": rows, "replies": replies, "wall_s": wall, "docs_per_s": len(rows) / wall,
            "tax": LAST_RUN_STATS.engine_tax()}


def c4_direct(model, texts) -> dict:
    """(c): the same texts straight through the model and the index, in
    the UDF's batches: every batch submitted, one resolve, one add."""
    import torch

    from pathway_tpu_torch import BruteForceKnnIndex

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [model.embed_submit(texts[s : s + C4_BATCH])
               for s in range(0, len(texts), C4_BATCH)]
    vecs = np.concatenate(model.embed_resolve(handles, 600))
    index = BruteForceKnnIndex(model.cfg.hidden, reserved_space=len(texts) + 512,
                               metric="cos", device=model.device)
    index.add(list(range(len(texts))), vecs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"vecs": vecs, "index": index, "wall_s": wall, "docs_per_s": len(texts) / wall}


def c4_check_stream(out: dict, keys: np.ndarray, direct: np.ndarray, qvecs: dict,
                    name: str) -> None:
    """Every doc reached the subscriber, each vector within cosine
    C4_COS_MIN of the direct one for its text, each live query answered
    with scores equal to the cosine of its vector and the row's."""
    rows = out["rows"]
    require(len(rows) == len(keys) and set(rows) == set(keys.tolist()),
            f"({name}) every doc reached the embedded subscriber ({len(rows)} rows)")
    got = np.stack([rows[k] for k in keys.tolist()]).astype(np.float32)
    cos = np.sum(got * direct, axis=1) / (np.linalg.norm(got, axis=1)
                                          * np.linalg.norm(direct, axis=1))
    require(cos.min() >= C4_COS_MIN,
            f"({name}) engine vectors within cosine {C4_COS_MIN} of the direct ones "
            f"(min {cos.min():.6f})")
    require(sorted(out["replies"]) == sorted(C4_QUERIES),
            f"({name}) both live queries answered")
    worst = 0.0
    for q, (vecs, dists) in out["replies"].items():
        require(len(vecs) == C4_K and len(dists) == C4_K,
                f"({name}) query {q!r} answered with {C4_K} matches")
        for v, d in zip(vecs, dists):
            worst = max(worst, abs(float(np.dot(qvecs[q], v)) + d))
    require(worst <= C4_SCORE_TOL,
            f"({name}) reply scores equal cos(query, row) within {C4_SCORE_TOL} "
            f"(max diff {worst:.2e})")


def c4_static(pw, emb, model, gpu: str) -> int:
    """(d): static docs and queries through DataIndex.query, against
    BruteForceKnnIndex.search over the direct embeddings. ``emb`` must be
    blocking: docs and queries then reach the index in one epoch, the docs
    first. Returns the engine run's flash_attn launches."""
    from pathway_tpu_torch import BruteForceKnnIndex
    from pathway_tpu_torch.models import flash_attention as FA

    texts = c4_texts(C4_STATIC_DOCS, seed=12)
    q_texts = c4_texts(C4_STATIC_QUERIES, seed=13, words=6)
    pw.clear_graph()
    docs = pw.debug.table_from_rows(pw.schema_from_types(doc=int, text=str),
                                    list(enumerate(texts)))
    embedded = docs.select(docs.doc, vec=emb(docs.text))
    index = pw.indexing.DataIndex(embedded, pw.indexing.BruteForceKnn(
        embedded.vec, dimensions=model.cfg.hidden, reserved_space=C4_STATIC_DOCS,
        metric="cos"))
    queries = pw.debug.table_from_rows(pw.schema_from_types(q=str),
                                       [(q,) for q in q_texts])
    res = index.query(queries.select(queries.q, qv=emb(queries.q)).qv,
                      number_of_matches=C4_K, with_distances=True)
    res = res.select(res.doc, res._pw_dist, q=queries.restrict(res).q)
    before = FA.flash_attn.launches
    t0 = time.perf_counter()
    got = pw.debug.table_to_dicts(res)[1]
    wall = time.perf_counter() - t0
    launches = FA.flash_attn.launches - before
    ref_index = BruteForceKnnIndex(model.cfg.hidden, reserved_space=C4_STATIC_DOCS,
                                   metric="cos", device=model.device)
    # in the UDF's batches: a bf16 encode's rounding follows its batch height
    ref_index.add(list(range(C4_STATIC_DOCS)), np.concatenate(
        [model.embed_batch(texts[s : s + C4_BATCH])
         for s in range(0, C4_STATIC_DOCS, C4_BATCH)]))
    want = dict(zip(q_texts, ref_index.search(model.embed_batch(q_texts), C4_K)))
    by_q = {got["q"][k]: [(d, -s) for d, s in zip(got["doc"][k], got["_pw_dist"][k])]
            for k in got["q"]}
    agree = sum(ranks_agree(want[q], by_q[q], C4_TIE_TOL) for q in q_texts)
    info(f"engine (d) static DataIndex.query, {C4_STATIC_DOCS} docs x {C4_STATIC_QUERIES} "
         f"queries [{gpu}]: {wall:.3f} s; replies equal BruteForceKnnIndex.search but at "
         f"ties within {C4_TIE_TOL}: {agree}/{C4_STATIC_QUERIES}")
    require(len(by_q) == C4_STATIC_QUERIES and agree == C4_STATIC_QUERIES,
            "(d) the static replies equal the direct index's")
    require(launches >= MINILM_LAYERS * (-(-C4_STATIC_DOCS // C4_BATCH) + 1),
            f"(d) every encode went through flash_attn ({launches})")
    return launches


def run_engine_config4(dev, gpu: str) -> int:
    """Phase 16; returns its flash_attn launches."""
    import gc

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import BruteForceKnnIndex
    from pathway_tpu_torch.engine.value import keys_for_value_columns
    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.xpacks.llm import SentenceTransformerEmbedder

    t16 = time.perf_counter()
    texts = c4_texts(C4_DOCS)
    payloads = [json.dumps({"id": i, "text": t}).encode() for i, t in enumerate(texts)]
    # the broker's row keys: Key::for_values(topic, offset), as the reader makes them
    keys = keys_for_value_columns([np.full(C4_DOCS, "docs", dtype=object),
                                   np.arange(C4_DOCS).astype(object)], C4_DOCS)
    deferred = SentenceTransformerEmbedder("minilm-l6", max_batch_size=C4_BATCH,
                                           deferred=True, device=dev)
    model = deferred.model
    blocking = SentenceTransformerEmbedder(model, max_batch_size=C4_BATCH, deferred=False)
    # warm the pow2 batch buckets, the query bucket and the index, as bench does
    warm_index = BruteForceKnnIndex(model.cfg.hidden, reserved_space=C4_DOCS + 512,
                                    metric="cos", device=dev)
    for b in (8, 16, 32, 64, 128, 256, 512, 1024):
        warm_index.add(list(range(b)), model.embed_batch(texts[:b]))
    model.embed_batch(C4_QUERIES)
    warm_index.search(model.embed_batch(C4_QUERIES), C4_K)
    del warm_index
    qvecs = dict(zip(C4_QUERIES, model.embed_batch(C4_QUERIES)))

    counter = EncodeCount(model)
    FA.flash_attn.launches = 0
    arms = {"a": [], "b": [], "c": []}
    direct = None
    for rep in range(C4_REPS):
        for name in "abc":
            counter.reset()
            if name == "c":
                out = c4_direct(model, texts)
                direct = out["vecs"]
                out.pop("index")
            else:
                emb = deferred if name == "a" else blocking
                emb._dedup.clear()  # every rep embeds cold, as bench does
                out = c4_stream(pw, emb, payloads, C4_DOCS)
            out["encodes"] = list(counter.sizes)
            arms[name].append(out)
            gc.collect()
    launches = FA.flash_attn.launches
    n_encodes = sum(len(r["encodes"]) for rs in arms.values() for r in rs)
    for name in "ab":
        for r in arms[name]:
            c4_check_stream(r, keys, direct, qvecs, name)
    # the deferred and blocking final tables: same keys, vectors within cosine
    a_rows, b_rows = arms["a"][-1]["rows"], arms["b"][-1]["rows"]
    ab = np.array([float(np.dot(a_rows[k], b_rows[k])) for k in keys.tolist()])
    require(a_rows.keys() == b_rows.keys() and ab.min() >= C4_COS_MIN,
            f"(a) and (b) give the same embedded table (min cosine {ab.min():.6f})")
    require(launches >= MINILM_LAYERS * n_encodes,
            f"every encode of phase 16 went through flash_attn ({launches} >= "
            f"{MINILM_LAYERS} x {n_encodes})")
    med = {n: statistics.median(r["docs_per_s"] for r in arms[n]) for n in arms}
    labels = {"a": "engine, deferred", "b": "engine, blocking", "c": "direct"}
    for name in "abc":
        rs = arms[name]
        busy = [encode_busy_ms(model, texts, r["encodes"]) for r in rs]
        idle = [1.0 - b / (r["wall_s"] * 1e3) for b, r in zip(busy, rs)]
        info(f"engine ({name}) {labels[name]} [{gpu}]: docs/s "
             + ", ".join(f"{r['docs_per_s']:.1f}" for r in rs)
             + f" (median {med[name]:.1f}, {med[name] / med['c']:.4f}x (c)); wall s "
             + ", ".join(f"{r['wall_s']:.3f}" for r in rs)
             + f"; encodes {len(rs[0]['encodes'])} a rep; device idle share estimate "
             + ", ".join(f"{x:.3f}" for x in idle)
             + f" (device busy ms {', '.join(f'{b:.1f}' for b in busy)})")
        if name != "c":
            info(f"engine ({name}) LAST_RUN_STATS.engine_tax() of each rep: "
                 + "; ".join(json.dumps(r["tax"]) for r in rs))
    # blocking: a deferred UDF injects its chunks when they resolve, so an
    # as-of-now query could be answered before every static doc is indexed
    static_launches = c4_static(pw, blocking, model, gpu)
    counter.close()
    info(f"engine: phase 16 flash_attn launches {launches} in (a)-(c), {static_launches} "
         f"in (d); {time.perf_counter() - t16:.1f} s")
    launches += static_launches
    deferred.close()
    del arms, direct
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 17
# BASELINE configs 2 and 3 through pw.run() and the REST servers: phase 4's
# corpus, the embed UDF at its bench batch, 8 questions in (b) and (c) (16
# until the script's time ran short), a
# reply score's tolerance against the direct path and the near-tie gap
RAG_BATCH, RAG_QUESTIONS, RAG_CONTEXT = 1024, 8, 6
RAG_SCORE_TOL, RAG_TIE_TOL = 2e-2, 1e-3
RAG_HOST = "127.0.0.1"
RAG_TIMEOUT = 300.0  # a bound on each wait: server start, a request, a join


def rag_docs_table(pw, docs):
    """Phase 4's corpus as a document table without pandas: ``data`` and
    ``_metadata`` (``path`` = the doc's index, ``modified_at``)."""
    schema = pw.schema_from_types(data=str, _metadata=pw.Json)
    return pw.debug.table_from_rows(schema, [
        (d, pw.Json({"path": f"doc{i}", "modified_at": i})) for i, d in enumerate(docs)])


def rerank_route(pw, llm, store, reranker, webserver, k_retrieve: int = RERANK_K,
                 k_keep: int = TOP_K) -> None:
    """(b): BASELINE config 3's rerank stage as a user writes it, one REST
    route: ``retrieve_query`` (k_retrieve), a flatten over the docs, the
    cross-encoder UDF on each (doc, query) pair, a groupby per query with
    ``reducers.tuple``, ``rerank_topk_filter`` (k_keep) and a join back to
    the query by id. The reply is ``{"docs": [...], "scores": [...]}``."""

    class RerankQuerySchema(pw.Schema):
        query: str

    queries, writer = pw.io.http.rest_connector(
        webserver=webserver, route="/v1/rerank", schema=RerankQuerySchema,
        methods=("POST",), delete_completed_queries=True)
    retrieved = store.retrieve_query(queries.select(
        query=queries.query, k=k_retrieve, metadata_filter=None, filepath_globpattern=None))
    with_docs = queries.with_columns(docs=retrieved.promise_universes_are_equal(queries).result)

    @pw.udf
    def doc_list(result) -> tuple:
        return tuple(pw.Json(d) for d in result.value)

    @pw.udf
    def doc_text(doc) -> str:
        return doc.value["text"]

    pairs = with_docs.select(qid=with_docs.id, query=with_docs.query,
                             doc=doc_list(with_docs.docs))
    pairs = pairs.flatten(pairs.doc)
    scored = pairs.select(pairs.qid, pairs.doc, score=reranker(doc_text(pairs.doc), pairs.query))
    grouped = scored.groupby(scored.qid).reduce(
        scored.qid, docs=pw.reducers.tuple(scored.doc), scores=pw.reducers.tuple(scored.score))
    top = grouped.select(grouped.qid, top=llm.rerankers.rerank_topk_filter(
        grouped.docs, grouped.scores, k_keep))

    @pw.udf
    def as_result(top) -> pw.Json:
        docs, scores = top
        return pw.Json({"docs": [d.value for d in docs], "scores": [float(s) for s in scores]})

    writer(queries.join(top, queries.id == top.qid, id=queries.id).select(
        result=as_result(top.top)))


class LiveRun:
    """``run`` (default ``pw.run``) on a thread until every REST route of
    the current graph answers; ``stop()`` stops the run's connectors and
    joins the thread. Every wait is bounded."""

    def __init__(self, pw, webserver, run=None):
        import threading

        self.connectors = list(pw.G.connectors)
        self.webserver, self.error = webserver, None

        def body():
            try:
                (run or pw.run)()
            except BaseException as exc:  # noqa: BLE001 - raised by stop()
                self.error = exc

        self.thread = threading.Thread(target=body, daemon=True, name="phase17-run")
        self.thread.start()
        routes = {c.route for c in self.connectors if hasattr(c, "route")}
        deadline = time.monotonic() + RAG_TIMEOUT
        while not (webserver._started.is_set()
                   and routes <= {r for _m, r in webserver._routes}):
            if time.monotonic() > deadline or not self.thread.is_alive():
                raise AssertionError(f"the REST routes never came up ({self.error!r})")
            time.sleep(0.02)
        self.base = f"http://{RAG_HOST}:{webserver.port}"

    def stop(self) -> None:
        for c in self.connectors:
            c._stop.set()
            c.close()
        self.thread.join(RAG_TIMEOUT)
        require(not self.thread.is_alive() and self.error is None,
                f"the run ended within {RAG_TIMEOUT:.0f} s of its stop ({self.error!r})")
        require(not self.webserver._started.is_set(), "the web server stopped with the run")


def post(url: str, payload: dict):
    """(reply JSON, wall ms) of one POST; a non-200 reply raises."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=RAG_TIMEOUT) as resp:
        body = resp.read()
        status = resp.status
    ms = (time.perf_counter() - t0) * 1e3
    if status != 200:
        raise AssertionError(f"{url}: HTTP {status}")
    return json.loads(body), ms


class Counted:
    """Counts the rows a model method is called with (by call), as an
    instance attribute over the bound method; ``close()`` restores it."""

    def __init__(self, model, name: str):
        self.model, self.name, self.calls = model, name, []
        self._orig = getattr(model, name)
        self._own = name in vars(model)  # an earlier Counted's wrapper

        def wrapped(rows, *a, **kw):
            self.calls.append(len(rows))
            return self._orig(rows, *a, **kw)

        setattr(model, name, wrapped)

    def close(self) -> None:
        if self._own:
            setattr(self.model, self.name, self._orig)
        else:
            delattr(self.model, self.name)


def pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def rag_direct(model, docs):
    """The direct path's corpus: every doc embedded by the model in the
    UDF's batches (a bf16 encode's rounding follows its batch), in a
    ``BruteForceKnnIndex`` keyed by the doc's index."""
    from pathway_tpu_torch import BruteForceKnnIndex

    vecs = np.concatenate([model.embed_batch(docs[s : s + RAG_BATCH])
                           for s in range(0, len(docs), RAG_BATCH)])
    index = BruteForceKnnIndex(model.cfg.hidden, reserved_space=len(docs), metric="cos",
                               device=model.device)
    index.add(list(range(len(docs))), vecs)
    return index


def vector_store_arm(pw, llm, model, docs, queries) -> dict:
    """(a) BASELINE config 2: ``VectorStoreServer(...).run_server`` over the
    corpus; 64 queries at k=10, one at a time, through
    ``VectorStoreClient``. Returns the replies and the times."""
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory

    pw.clear_graph()
    emb = llm.SentenceTransformerEmbedder(model, max_batch_size=RAG_BATCH)
    vs = llm.VectorStoreServer(rag_docs_table(pw, docs), embedder=emb,
                               index_factory=BruteForceKnnFactory(
                                   dimensions=model.cfg.hidden, embedder=emb,
                                   reserved_space=len(docs), metric="cos", device=model.device))
    t0 = time.perf_counter()
    server = vs.run_server(host=RAG_HOST, port=0, threaded=True)
    rest = [c for c in pw.G.connectors if hasattr(c, "route")]
    live = LiveRun(pw, rest[0].webserver, run=server.join)
    client = llm.VectorStoreClient(host=RAG_HOST, port=live.webserver.port, timeout=RAG_TIMEOUT)
    try:
        stats = client.get_vectorstore_statistics()  # answered once the corpus is indexed
        ingest_s = time.perf_counter() - t0
        lat, replies = [], []
        for q in queries:
            t1 = time.perf_counter()
            replies.append(client.query(q, k=TOP_K))
            lat.append((time.perf_counter() - t1) * 1e3)
        inputs = client.get_input_files()
    finally:
        live.stop()
    return {"stats": stats, "inputs": inputs, "replies": replies, "lat": lat,
            "ingest_s": ingest_s}


def rerank_and_answer_arms(pw, llm, chat, model, ce, docs, queries) -> tuple[dict, dict]:
    """(b) and (c) on one server over one ``DocumentStore`` of the corpus:
    ``BaseRAGQuestionAnswerer`` with ``build_server`` / ``run_server``,
    and ``rerank_route`` (BASELINE config 3's rerank stage) on the same
    web server. After a ``/v1/statistics`` request (answered once the
    corpus is indexed), (b) sends the queries to ``/v1/rerank`` one at a
    time, then (c) sends them at once from as many client threads to
    ``/v1/pw_ai_answer`` with ``return_context_docs``. Returns (b)'s replies,
    walls and the rows of each cross-encoder and query encode its queries
    caused (retractions included), and (c)'s replies by question, walls,
    and every request the continuous server took with its (cut) prompt ids
    and its full prompt string."""
    import threading

    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory

    pw.clear_graph()
    emb = llm.SentenceTransformerEmbedder(model, max_batch_size=RAG_BATCH)
    store = llm.DocumentStore(rag_docs_table(pw, docs), retriever_factory=BruteForceKnnFactory(
        dimensions=model.cfg.hidden, embedder=emb, reserved_space=len(docs), metric="cos",
        device=model.device))
    qa = llm.BaseRAGQuestionAnswerer(chat, store, search_topk=RAG_CONTEXT)
    qa.build_server(RAG_HOST, 0)
    rerank_route(pw, llm, store, llm.CrossEncoderReranker(ce), qa.server.webserver)
    submitted, prompts = [], []
    server_submit, format_prompt = chat.server.submit, chat._format_prompt

    def submit(ids, *a, **kw):
        req = server_submit(ids, *a, **kw)
        submitted.append((list(ids), req))
        return req

    def fmt(messages):
        p = format_prompt(messages)
        prompts.append(p)
        return p

    chat.server.submit, chat._format_prompt = submit, fmt
    live = LiveRun(pw, qa.server.webserver, run=qa.run_server)
    try:
        post(f"{live.base}/v1/statistics", {})
        b = {"replies": [], "lat": []}
        pairs, encodes = Counted(ce, "score_submit"), Counted(model, "embed_submit")
        try:
            for q in queries:
                reply, ms = post(f"{live.base}/v1/rerank", {"query": q})
                b["replies"].append(reply)
                b["lat"].append(ms)
            # the last query's retraction is through once one more epoch ran
            post(f"{live.base}/v1/statistics", {})
        finally:
            pairs.close()
            encodes.close()
        b["pairs"], b["encodes"] = pairs.calls, encodes.calls
        c = {"replies": {}, "walls": {}}
        barrier = threading.Barrier(len(queries))

        def ask(q):
            barrier.wait(RAG_TIMEOUT)
            c["replies"][q], c["walls"][q] = post(f"{live.base}/v1/pw_ai_answer",
                                                  {"prompt": q, "return_context_docs": True})

        threads = [threading.Thread(target=ask, args=(q,)) for q in queries]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(RAG_TIMEOUT)
        c["wall_s"] = time.perf_counter() - t0
    finally:
        live.stop()
        del chat.server.submit, chat._format_prompt
    c["submitted"], c["prompts"] = submitted, prompts
    return b, c


def run_rag_apps(dev, gpu: str, out: dict, docs, queries, common) -> dict:
    """Phase 17; returns its launches of the five kernel entry points."""
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import DecoderChat
    from pathway_tpu_torch.models import decoder as D
    from pathway_tpu_torch.xpacks import llm

    t17 = time.perf_counter()
    model, ce = out["emb"], out["ce"]
    direct_index = rag_direct(model, docs)
    # phase 6's server: a paged pool through the paged decode kernel,
    # flash chunked prefill, int8 weights through wq_matmul
    chat = DecoderChat(paged_kv=True, paged_kv_block=BLOCK, paged_kernel=True,
                       flash_prefill=True, **common)
    serve(chat, make_prompts(4, 16, 200, seed=99))  # warm-up, outside the counts
    qs = queries[:RAG_QUESTIONS]

    # the three programs, every kernel count zeroed just before them and
    # read just after; the direct path they are held against runs later
    for f in counters().values():
        f.launches = 0
    all_encodes = [Counted(model, "embed_submit"), Counted(ce, "score_submit")]
    try:
        a = vector_store_arm(pw, llm, model, docs, queries)
        b, c = rerank_and_answer_arms(pw, llm, chat, model, ce, docs, qs)
    finally:
        for counted in reversed(all_encodes):
            counted.close()
    torch.cuda.synchronize()
    launches = {n: f.launches for n, f in counters().items()}
    n_encodes = sum(len(x.calls) for x in all_encodes)
    pw.clear_graph()

    # (a): the direct path, recall against phase 4's exact f32 truth
    require(a["stats"]["file_count"] == len(docs),
            f"(a) /v1/statistics file_count {a['stats']['file_count']} = {len(docs)}")
    require(len(a["inputs"]) == len(docs), f"(a) /v1/inputs lists {len(a['inputs'])} docs")
    agree, worst, hits = 0, 0.0, 0
    for i, (q, reply) in enumerate(zip(queries, a["replies"])):
        got = [(int(d["metadata"]["path"][3:]), -d["dist"]) for d in reply]
        want = direct_index.search(model.embed_batch([q]), TOP_K)[0]
        agree += ranks_agree(want, got, RAG_TIE_TOL)
        want_s = dict(want)
        worst = max([worst] + [abs(sc - want_s[k]) for k, sc in got if k in want_s])
        hits += len({k for k, _ in got} & set(out["truth"][i].tolist()))
    recall = hits / (len(queries) * TOP_K)
    lat = a["lat"]
    info(f"rag (a) VectorStoreServer [{gpu}]: ingest {len(docs) / a['ingest_s']:.1f} docs/s "
         f"through pw.run() ({a['ingest_s']:.3f} s to the first /v1/statistics reply); "
         f"/v1/retrieve over REST p50 {pct(lat, 50):.3f} ms, p99 {pct(lat, 99):.3f} ms "
         f"(k={TOP_K}, {len(queries)} queries one at a time); phase 4's direct retrieve p50 "
         f"{out['retrieve_p50_ms']:.3f} ms; replies equal the direct index but at gaps < "
         f"{RAG_TIE_TOL}: {agree}/{len(queries)}; max score diff {worst:.2e}; "
         f"recall@10 {recall:.4f}")
    require(agree == len(queries), "(a) replies equal the direct index but at near-ties")
    require(worst <= RAG_SCORE_TOL, f"(a) scores within {RAG_SCORE_TOL} of the direct path")
    require(recall >= 0.9, f"(a) recall@10 {recall:.4f} >= 0.9 against exact f32 scoring")

    # (b): each reply against the cross-encoder called directly on the
    # same pairs (the 32 candidates the direct index retrieves)
    agree, worst = 0, 0.0
    for q, reply in zip(qs, b["replies"]):
        cand = [k for k, _ in direct_index.search(model.embed_batch([q]), RERANK_K)[0]]
        got_keys = [int(d["metadata"]["path"][3:]) for d in reply["docs"]]
        extra = [k for k in got_keys if k not in cand]
        scores = ce.score_batch([(q, docs[k]) for k in cand])
        direct = dict(zip(cand, (float(x) for x in scores)))
        if extra:
            direct.update(zip(extra, (float(x) for x in ce.score_batch(
                [(q, docs[k]) for k in extra]))))
        order = np.argsort(-np.asarray(scores, dtype=np.float64), kind="stable")[:TOP_K]
        want = [(cand[j], float(scores[j])) for j in order]
        got = list(zip(got_keys, reply["scores"]))
        agree += ranks_agree(want, got, RAG_TIE_TOL)
        worst = max([worst] + [abs(sc - direct[k]) for k, sc in got])
    info(f"rag (b) rerank route [{gpu}]: retrieve k={RERANK_K} -> cross-encoder -> top "
         f"{TOP_K} over REST p50 {pct(b['lat'], 50):.3f} ms, p99 {pct(b['lat'], 99):.3f} ms "
         f"({RAG_QUESTIONS} queries one at a time); phase 4's direct retrieve+rerank p50 "
         f"{out['rerank_p50_ms']:.3f} ms; top {TOP_K} equal the direct path but at gaps < "
         f"{RAG_TIE_TOL}: {agree}/{RAG_QUESTIONS}; max score diff {worst:.2e}; cross-encoder "
         f"rows {sum(b['pairs'])} in {len(b['pairs'])} calls, query encodes {b['encodes']}")
    require(agree == RAG_QUESTIONS, "(b) the kept top 10 equal the direct path's but at near-ties")
    require(worst <= RAG_SCORE_TOL, f"(b) scores within {RAG_SCORE_TOL} of the direct CrossEncoder")
    require(b["pairs"] == [RERANK_K] * RAG_QUESTIONS,
            "(b) one cross-encoder score a (query, doc) pair: retractions replay")
    require(b["encodes"] == [1] * RAG_QUESTIONS, "(b) one encode a query")

    # (c): each answer against the static path on the same prompt ids
    require(len(c["submitted"]) == RAG_QUESTIONS,
            f"(c) exactly {RAG_QUESTIONS} requests reached the continuous server "
            f"({len(c['submitted'])})")
    require(sorted(c["replies"]) == sorted(qs), "(c) every question answered")
    cap = chat._prompt_cap(MAX_NEW)
    n_cut = sum(len(chat.tokenizer.encode(p)) > cap for p in c["prompts"])
    first_eq = streams_eq = 0
    for q in qs:
        # the question closes its prompt, so the cut ids still hold it
        (ids, req), = [(i, r) for i, r in c["submitted"] if q in chat.tokenizer.decode(i)]
        reply = c["replies"][q]
        require(reply["response"] == req.text, "(c) the reply is the served request's text")
        require(len(reply["context_docs"]) == RAG_CONTEXT, f"(c) {RAG_CONTEXT} context docs")
        x = torch.tensor([ids], dtype=torch.int32, device=dev)
        toks = D.generate(chat.params, x, torch.ones_like(x), chat.cfg, MAX_NEW)[0].tolist()
        first_eq += int(req.tokens[0] == toks[0])
        streams_eq += int(req.tokens == toks)
    ttft = [(r.first_token_at - r.submitted_at) * 1e3 for _, r in c["submitted"]]
    e2e = list(c["walls"].values())
    info(f"rag (c) BaseRAGQuestionAnswerer [{gpu}]: {RAG_QUESTIONS} questions at once over "
         f"REST in {c['wall_s']:.3f} s; TTFT p50 {pct(ttft, 50):.1f} ms (serving spans), "
         f"end-to-end p50 {pct(e2e, 50):.1f} ms, p99 {pct(e2e, 99):.1f} ms over HTTP; "
         f"{n_cut}/{RAG_QUESTIONS} prompts cut to the last {cap} tokens as JAX cuts them; "
         f"against the static path: first tokens {first_eq}/{RAG_QUESTIONS}, whole streams "
         f"{streams_eq}/{RAG_QUESTIONS}")
    require(first_eq * 8 >= MIN_FIRST_EQUAL * RAG_QUESTIONS,
            f"(c) at least {MIN_FIRST_EQUAL}/8 first tokens equal the static path")
    require(streams_eq * 8 >= MIN_STREAMS_EQUAL * RAG_QUESTIONS,
            f"(c) at least {MIN_STREAMS_EQUAL}/8 whole streams equal the static path")
    free_chats(chat)

    info(f"rag: phase 17 launches {launches}; {n_encodes} encoder calls "
         f"({len(all_encodes[0].calls)} embed, {len(all_encodes[1].calls)} cross-encoder); "
         f"{time.perf_counter() - t17:.1f} s")
    require(all(launches[n] > 0 for n in ("flash_attn", "flash_chunk_attn_paged",
                                          "paged_attn_decode", "wq_matmul")),
            "phase 17 drove flash_attn, flash_chunk_attn_paged, paged_attn_decode and wq_matmul")
    require(launches["flash_attn"] >= MINILM_LAYERS * n_encodes,
            f"every encode of phase 17 went through flash_attn ({launches['flash_attn']} >= "
            f"{MINILM_LAYERS} x {n_encodes})")
    return launches


# ---------------------------------------------------------------- phase 18
# BASELINE configs 1, 2 and 5 as users write them, at phase 4's MiniLM-L6
# bf16 and corpus: (a) its 32,768 docs in 8 CSV files read statically
# through the embed UDF at batches of 1,024 into a JSON-lines file, beside
# the same program into the null sink and the direct path, FS_REPS reps of
# the three arms in turns; (b) its first FS_DOCS docs (256; 4,096 took the
# uSearch arm's host HNSW 65-110 s, then 1,024 and, until the script's time
# took phase 25, 512), one file each, watched by pw.io.fs.read into a
# DocumentStore served over REST, once a factory; 64 queries one at a time
# at k = 10, then FS_GONE files out (evenly spaced) and FS_NEW in, and the
# new and deleted docs' own texts asked for (FS_PROBES each); (c) the
# brute-force and IVF factories routed over FS_MESH virtual positions of
# the card.
# one rep of (a)'s arms (a second did not fit the script's time with phase 21)
FS_FILES, FS_REPS, FS_DOCS, FS_NEW, FS_GONE, FS_PROBES, FS_MESH = 8, 1, 256, 64, 32, 4, 4
FS_REFRESH = 0.5  # s between the streaming reader's scans: its default
FS_FACTORIES = ("brute_force", "usearch", "ivf", "ivf_exhaustive", "hybrid")


def write_csv_corpus(path: str, docs) -> None:
    """(a)'s input: ``docs`` split in FS_FILES CSV files of ``doc,text``."""
    import csv

    os.makedirs(path)
    per = -(-len(docs) // FS_FILES)
    for f in range(FS_FILES):
        with open(os.path.join(path, f"part{f}.csv"), "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["doc", "text"])
            w.writerows((i, docs[i]) for i in range(f * per, min((f + 1) * per, len(docs))))


def fs_config1_arm(pw, llm, model, src: str, out: str | None) -> float:
    """(a) engine: CSV files -> the embed UDF -> a JSON-lines file (no
    file: ``pw.io.null.write``); the run's wall in s."""
    import torch

    pw.clear_graph()
    emb = llm.SentenceTransformerEmbedder(model, max_batch_size=RAG_BATCH)

    class DocSchema(pw.Schema):
        doc: int
        text: str

    docs = pw.io.csv.read(src, schema=DocSchema, mode="static")
    vecs = docs.select(docs.doc, vec=emb(docs.text))
    if out is None:
        pw.io.null.write(vecs)
    else:
        pw.io.jsonlines.write(vecs, out)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pw.run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def fs_direct_arm(model, docs) -> tuple[np.ndarray, float]:
    """(a) direct: the same texts through the model in the UDF's batches."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [model.embed_submit(docs[s : s + RAG_BATCH]) for s in range(0, len(docs), RAG_BATCH)]
    vecs = np.concatenate(model.embed_resolve(handles, 600))
    torch.cuda.synchronize()
    return vecs, time.perf_counter() - t0


def fs_config1(pw, llm, model, docs, tmp: str, gpu: str) -> np.ndarray:
    """(a); returns the direct path's vectors."""
    src = os.path.join(tmp, "csv")
    write_csv_corpus(src, docs)
    walls = {"engine": [], "null sink": [], "direct": []}
    outs, direct = [], None
    for rep in range(FS_REPS):
        out = os.path.join(tmp, f"vecs{rep}.jsonl")
        walls["engine"].append(fs_config1_arm(pw, llm, model, src, out))
        outs.append(out)
        walls["null sink"].append(fs_config1_arm(pw, llm, model, src, None))
        direct, wall = fs_direct_arm(model, docs)
        walls["direct"].append(wall)
    pw.clear_graph()
    for rep, out in enumerate(outs):
        with open(out) as fh:
            n_lines = sum(1 for _ in fh)
        require(n_lines == len(docs), f"(a) rep {rep}: {n_lines} lines for {len(docs)} docs")
    with open(outs[0]) as fh:
        recs = [json.loads(line) for line in fh]
    require(all(r["diff"] == 1 for r in recs), "(a) one insertion a doc, no retraction")
    got = {r["doc"]: r["vec"] for r in recs}
    require(sorted(got) == list(range(len(docs))), "(a) every doc written once")
    vecs = np.asarray([got[i] for i in range(len(docs))], dtype=np.float32)
    cos = np.sum(vecs * direct, axis=1) / (np.linalg.norm(vecs, axis=1)
                                           * np.linalg.norm(direct, axis=1))
    rate = {a: [len(docs) / w for w in ws] for a, ws in walls.items()}
    med = {a: statistics.median(r) for a, r in rate.items()}
    info(f"files (a) config 1: {len(docs)} docs in {FS_FILES} CSV files -> embed UDF (batches "
         f"of {RAG_BATCH}) -> pw.io.jsonlines.write [{gpu}]: docs/s "
         + ", ".join(f"{r:.1f}" for r in rate["engine"])
         + f" (median {med['engine']:.1f}, {med['engine'] / med['direct']:.4f}x direct); "
         f"into pw.io.null.write " + ", ".join(f"{r:.1f}" for r in rate["null sink"])
         + f" (median {med['null sink']:.1f}, {med['null sink'] / med['direct']:.4f}x direct); "
         f"direct docs/s " + ", ".join(f"{r:.1f}" for r in rate["direct"])
         + f" (median {med['direct']:.1f}); arms in turns; min cosine to direct {cos.min():.6f}")
    require(cos.min() >= C4_COS_MIN, f"(a) vectors within cosine {C4_COS_MIN} of the direct ones")
    return direct


def sub_index_route(pw, store, i: int, route: str, webserver) -> None:
    """(b): a REST route answering from the i-th sub-index of the store's
    hybrid index, its own reply to ``{"query", "k"}`` as the store's."""
    from pathway_tpu_torch.internals.json import unwrap_json

    class SubQuerySchema(pw.Schema):
        query: str
        k: int

    queries, writer = pw.io.http.rest_connector(
        webserver=webserver, route=route, schema=SubQuerySchema, methods=("POST",),
        delete_completed_queries=True)
    m = store.index.indexes[i].query_as_of_now(queries.query, number_of_matches=queries.k,
                                               with_distances=True)

    @pw.udf
    def as_docs(texts, metas, dists) -> pw.Json:
        return pw.Json([{"text": t, "metadata": unwrap_json(meta) or {}, "dist": float(d)}
                        for t, meta, d in zip(texts, metas, dists)])

    writer(m.select(result=as_docs(m.text, m.metadata, m._pw_dist)))


def store_factory(pw, name: str, emb, dim: int):
    ix = pw.indexing
    knn = ix.BruteForceKnnFactory(dimensions=dim, embedder=emb, reserved_space=FS_DOCS + FS_NEW,
                                  metric="cos")
    return {
        "brute_force": lambda: knn,
        "usearch": lambda: ix.UsearchKnnFactory(dimensions=dim, embedder=emb, metric="cos"),
        "ivf": lambda: ix.IvfKnnFactory(dimensions=dim, embedder=emb, metric="cos"),
        "ivf_exhaustive": lambda: ix.IvfKnnFactory(dimensions=dim, embedder=emb, metric="cos",
                                                   nprobe=64),
        "hybrid": lambda: ix.HybridIndexFactory([knn, ix.TantivyBM25Factory()]),
    }[name]()


def doc_index(d: dict) -> int:
    return int(os.path.basename(d["metadata"]["path"])[3:8])


def wait_files(base: str, names: set) -> None:
    """Until the store holds the docs of exactly the files ``names``: its
    count first, then its list of inputs (a scan that caught the
    directory mid-change can show the right count with other files)."""
    deadline = time.monotonic() + RAG_TIMEOUT
    while True:
        if post(f"{base}/v1/statistics", {})[0]["file_count"] == len(names):
            inputs = post(f"{base}/v1/inputs",
                          {"metadata_filter": None, "filepath_globpattern": None})[0]
            if {os.path.basename(m["path"]) for m in inputs} == names:
                return
        if time.monotonic() > deadline:
            raise AssertionError(f"the store did not hold its {len(names)} files within "
                                 f"{RAG_TIMEOUT} s")
        time.sleep(0.05)


def doc_file(i: int) -> str:
    return f"doc{i:05d}.txt"


def store_arm(pw, llm, model, name: str, docs, queries, tmp: str) -> dict:
    """(b) one factory: the corpus written one file a doc, the store
    served until it holds every doc, the queries one at a time, then
    FS_NEW files in and FS_GONE out and the probes."""
    d = os.path.join(tmp, f"store-{name}")
    os.makedirs(d)
    for i in range(FS_DOCS):
        with open(os.path.join(d, doc_file(i)), "wb") as fh:
            fh.write(docs[i].encode())
    pw.clear_graph()
    emb = llm.SentenceTransformerEmbedder(model, max_batch_size=RAG_BATCH)
    files = pw.io.fs.read(d, format="binary", with_metadata=True, mode="streaming",
                          refresh_interval=FS_REFRESH)
    store = llm.DocumentStore(files, retriever_factory=store_factory(pw, name, emb,
                                                                     model.cfg.hidden))
    server = llm.DocumentStoreServer(RAG_HOST, 0, store)
    if name == "hybrid":
        for i in range(2):
            sub_index_route(pw, store, i, f"/v1/sub{i}", server.webserver)
    t0 = time.perf_counter()
    live = LiveRun(pw, server.webserver)
    out = {"lat": [], "replies": [], "subs": [[], []]}
    try:
        wait_files(live.base, {doc_file(i) for i in range(FS_DOCS)})
        out["ingest_s"] = time.perf_counter() - t0
        for q in queries:
            reply, ms = post(f"{live.base}/v1/retrieve", {"query": q, "k": TOP_K})
            out["replies"].append(reply)
            out["lat"].append(ms)
        if name == "hybrid":
            for i in range(2):
                out["subs"][i] = [post(f"{live.base}/v1/sub{i}", {"query": q, "k": 2 * TOP_K})[0]
                                  for q in queries]
        gone = list(range(0, FS_DOCS, FS_DOCS // FS_GONE))
        t1 = time.perf_counter()
        for i in gone:
            os.unlink(os.path.join(d, doc_file(i)))
        for i in range(FS_DOCS, FS_DOCS + FS_NEW):
            with open(os.path.join(d, doc_file(i)), "wb") as fh:
                fh.write(docs[i].encode())
        wait_files(live.base, {doc_file(i) for i in range(FS_DOCS + FS_NEW)}
                   - {doc_file(i) for i in gone})
        out["change_s"] = time.perf_counter() - t1
        new = list(range(FS_DOCS, FS_DOCS + FS_NEW, FS_NEW // FS_PROBES))
        out["fresh"] = [doc_index(post(f"{live.base}/v1/retrieve",
                                       {"query": docs[i], "k": 1})[0][0]) == i for i in new]
        after = [post(f"{live.base}/v1/retrieve", {"query": q, "k": TOP_K})[0]
                 for q in [docs[i] for i in gone[:FS_PROBES]] + list(queries)]
        out["gone_hits"] = sum(doc_index(x) in set(gone) for reply in after for x in reply)
    finally:
        live.stop()
    pw.clear_graph()
    return out


def hybrid_keys(reply) -> list:
    """The hybrid's match keys of a REST reply, in its order."""
    import pathway_tpu_torch as pw

    return [repr((d["text"], pw.Json(d["metadata"]))) for d in reply]


def fs_config2(pw, llm, model, docs, queries, gpu: str, tmp: str) -> None:
    """(b)."""
    from pathway_tpu_torch.stdlib.indexing.hybrid_index import canonical_ranking, rrf_fuse

    # truth: exact f32 host scoring of the port's own embeddings of the corpus
    corpus_v = np.concatenate([model.embed_batch(docs[s : min(s + RAG_BATCH, FS_DOCS)])
                               for s in range(0, FS_DOCS, RAG_BATCH)]).astype(np.float32)
    q_v = model.embed_batch(queries).astype(np.float32)
    truth = np.argsort(-(q_v @ corpus_v.T), axis=1, kind="stable")[:, :TOP_K]
    arms = {name: store_arm(pw, llm, model, name, docs, queries, tmp) for name in FS_FACTORIES}
    recall = {}
    for name, a in arms.items():
        hits = sum(len({doc_index(x) for x in reply} & set(truth[i].tolist()))
                   for i, reply in enumerate(a["replies"]))
        recall[name] = hits / (len(queries) * TOP_K)
        info(f"files (b) config 2, {name} [{gpu}]: {FS_DOCS} files -> pw.io.fs.read(binary, "
             f"metadata, streaming) -> DocumentStoreServer: ingest {FS_DOCS / a['ingest_s']:.1f} "
             f"docs/s ({a['ingest_s']:.3f} s until it held the {FS_DOCS} files); /v1/retrieve p50 "
             f"{pct(a['lat'], 50):.3f} ms, p99 {pct(a['lat'], 99):.3f} ms (k={TOP_K}, "
             f"{len(queries)} queries one at a time); recall@10 {recall[name]:.4f} against exact "
             f"f32 scoring; -{FS_GONE} files +{FS_NEW} held in {a['change_s']:.3f} s; "
             f"new docs found {sum(a['fresh'])}/{FS_PROBES}; deleted docs returned "
             f"{a['gone_hits']}")
        require(all(a["fresh"]), f"(b) {name}: a new doc's own text finds it")
        require(a["gone_hits"] == 0, f"(b) {name}: no deleted doc is returned")
        require(all(len(r) == TOP_K for r in a["replies"]), f"(b) {name}: {TOP_K} docs a reply")
    require(recall["brute_force"] >= 0.9, f"(b) brute force recall@10 {recall['brute_force']:.4f}")
    bf = [[(doc_index(x), -x["dist"]) for x in r] for r in arms["brute_force"]["replies"]]
    ivf = [[(doc_index(x), -x["dist"]) for x in r] for r in arms["ivf_exhaustive"]["replies"]]
    agree = sum(ranks_agree(w, g, RAG_TIE_TOL) for w, g in zip(bf, ivf))
    info(f"files (b) IVF at nprobe 64 of 64 cells equal brute force but at gaps < {RAG_TIE_TOL}: "
         f"{agree}/{len(queries)}")
    require(agree == len(queries), "(b) exhaustive IVF equals brute force")
    h = arms["hybrid"]
    fused_eq = 0
    for reply, s0, s1 in zip(h["replies"], *h["subs"]):
        want = rrf_fuse([canonical_ranking([(x["text"], pw.Json(x["metadata"])) for x in s],
                                           [x["dist"] for x in s]) for s in (s0, s1)], TOP_K)
        fused_eq += (hybrid_keys(reply) == [k for k, _ in want]
                     and [x["dist"] for x in reply] == [-s for _k, s in want])
    info(f"files (b) hybrid top-{TOP_K} equal an RRF (k=60) of its two sub-indexes' own "
         f"replies at {2 * TOP_K}, computed on the host: {fused_eq}/{len(queries)}")
    require(fused_eq == len(queries), "(b) the hybrid's replies equal the host RRF")


def fs_config5(pw, model, vecs: np.ndarray, queries, dev, gpu: str) -> None:
    """(c): phase 4's vectors through DataIndex in pw.run(), unsharded and
    routed by ``mesh=`` to the sharded IVF over FS_MESH virtual positions
    (exhaustive probing); then each index's search of the queries timed."""
    import torch

    from pathway_tpu_torch.engine import probes
    from pathway_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh([dev] * FS_MESH, dp=FS_MESH, tp=1)
    q_v = model.embed_batch(queries).astype(np.float32)
    ix = pw.indexing
    dim = model.cfg.hidden
    facs = {
        "unsharded": ix.BruteForceKnnFactory(dimensions=dim, reserved_space=len(vecs)),
        "brute_force_mesh": ix.BruteForceKnnFactory(dimensions=dim, mesh=mesh),
        "ivf_mesh": ix.IvfKnnFactory(dimensions=dim, mesh=mesh, n_cells=64, nprobe=64),
    }
    got, search_ms = {}, {}
    probes.reset_retrieval_backend_stats()
    for name, fac in facs.items():
        pw.clear_graph()
        docs_t = pw.debug.table_from_rows(pw.schema_from_types(doc=int, vec=np.ndarray),
                                          [(i, vecs[i]) for i in range(len(vecs))])
        q_t = pw.debug.table_from_rows(pw.schema_from_types(q=int, qv=np.ndarray),
                                       [(j, q_v[j]) for j in range(len(q_v))])
        res = fac.build_index(docs_t.vec, docs_t).query_as_of_now(
            q_t.qv, number_of_matches=TOP_K, with_distances=True)
        res = res.select(res.doc, res._pw_dist, q=q_t.restrict(res).q)
        _, cols = pw.debug.table_to_dicts(res)
        got[name] = {cols["q"][k]: list(zip(cols["doc"][k], (-d for d in cols["_pw_dist"][k])))
                     for k in cols["q"]}
        index = fac.build_inner_index(None).make_factory().make_instance()
        index.add(list(range(len(vecs))), vecs)
        index.search(q_v, TOP_K)  # warm
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            index.search(q_v, TOP_K)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        search_ms[name] = statistics.median(ts)
        del index
    pw.clear_graph()
    stats = probes.retrieval_backend_stats()
    # bf16 cells scored apart from the brute force's bf16 corpus: phase
    # 15's near-tie gap
    agree = {n: sum(ranks_agree(got["unsharded"][q], got[n][q], TIE_TOL)
                    for q in range(len(q_v))) for n in ("brute_force_mesh", "ivf_mesh")}
    info(f"files (c) config 5 on one card: {len(vecs)} vectors through DataIndex in pw.run(), "
         f"mesh of {FS_MESH} virtual positions [{gpu}]: retrieval backends {stats}; top-{TOP_K} "
         f"equal the unsharded brute force's but at gaps < {TIE_TOL}: "
         + ", ".join(f"{n} {a}/{len(q_v)}" for n, a in agree.items())
         + f"; search ms of {len(q_v)} queries " + ", ".join(f"{n} {ms:.3f}"
                                                             for n, ms in search_ms.items()))
    require(stats.get("sharded_ivf", 0) >= 2 * len(q_v), "(c) the sharded index answered")
    require(all(a == len(q_v) for a in agree.values()),
            "(c) the mesh factories' top keys equal the unsharded brute force's")


def run_file_connectors(dev, gpu: str, out: dict, docs, queries) -> dict:
    """Phase 18 over phase 4's model; returns its launches of the five
    kernel entry points."""
    import tempfile

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.xpacks import llm

    t18 = time.perf_counter()
    model = out["emb"]
    model.embed_batch(docs[:RAG_BATCH])  # warm the batch bucket, outside the counts
    for f in counters().values():
        f.launches = 0
    counter = EncodeCount(model)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            vecs = fs_config1(pw, llm, model, docs, tmp, gpu)
            fs_config2(pw, llm, model, docs, queries, gpu, tmp)
        fs_config5(pw, model, vecs, queries, dev, gpu)
    finally:
        counter.close()
    torch.cuda.synchronize()
    launches = {n: f.launches for n, f in counters().items()}
    info(f"files: phase 18 launches {launches}; {len(counter.sizes)} encodes; "
         f"{time.perf_counter() - t18:.1f} s")
    require(launches["flash_attn"] >= MINILM_LAYERS * len(counter.sizes) > 0,
            f"every encode of phase 18 went through flash_attn ({launches['flash_attn']} >= "
            f"{MINILM_LAYERS} x {len(counter.sizes)})")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 19
# an event-time windowed embed stream: phase 16's corpus and deferred
# MiniLM-L6 UDF, each doc with a topic (i % W_TOPICS) and an event time
# t = i + j, j a seeded jitter in [-W_JITTER, W_JITTER]; a seeded 1% of the
# docs are late, a t from the stream's first quarter, produced last. The
# broker is fed in commits of W_COMMIT docs, each taken by the reader
# before the next is produced, so no epoch holds more: every in-order doc
# is kept (its window closes >= W_CUTOFF - W_JITTER after it) and every
# late doc lies >= 12,288 behind the watermark and is dropped. 64 queries
# follow on a second topic. The windowed program and the same feed without
# windows run W_REPS reps each, in turns.
W_TOPICS, W_HOP, W_DURATION, W_DELAY, W_CUTOFF, W_JITTER = 8, 2048, 8192, 1024, 4096, 512
# one rep of each arm (a second did not fit the script's time with phase 21)
W_LATE, W_COMMIT, W_QUERIES, W_LOOKBACK, W_REPS = 0.01, 1024, 64, 4096, 1
W_OPERATORS = ("Buffer", "Freeze", "Sort", "IntervalJoin", "AsofJoin")


def w_feed(texts: list[str], seed: int = 19) -> dict:
    """Phase 19's docs and queries: event times, the late docs, the
    payloads in the order they are produced."""
    rng = np.random.default_rng(seed)
    n = len(texts)
    t = np.arange(n) + rng.integers(-W_JITTER, W_JITTER + 1, n)
    late = np.sort(rng.choice(n, int(n * W_LATE), replace=False))
    t[late] = rng.integers(0, n // 4, len(late))
    is_late = np.zeros(n, dtype=bool)
    is_late[late] = True
    order = np.concatenate([np.flatnonzero(~is_late), late])
    payloads = [json.dumps({"doc": int(i), "topic": int(i % W_TOPICS), "t": int(t[i]),
                            "text": texts[i]}).encode() for i in order]
    q_t = np.sort(rng.integers(W_DURATION, n, W_QUERIES))
    q_texts = c4_texts(W_QUERIES, seed=20, words=6)
    queries = [{"q": j, "topic": j % W_TOPICS, "t": int(q_t[j]), "text": q_texts[j]}
               for j in range(W_QUERIES)]
    return {"t": t, "topic": np.arange(n) % W_TOPICS, "late": is_late, "payloads": payloads,
            "queries": queries,
            "q_payloads": [json.dumps(q).encode() for q in queries]}


def paced_feed(broker, connectors, topic: str, payloads, chunk: int, timeout: float) -> None:
    """Produces ``payloads`` in commits of ``chunk``, each once the topic's
    reader has taken the one before: no epoch of the reader holds more
    than ``chunk`` rows."""
    reader = next(c for c in connectors if getattr(c, "topic", None) == topic)
    deadline = time.time() + timeout
    for s in range(0, len(payloads), chunk):
        for p in payloads[s : s + chunk]:
            broker.produce(topic, p)
        end = min(s + chunk, len(payloads))
        while reader._offset < end:
            if time.time() > deadline:
                raise TimeoutError(f"the {topic!r} reader stalled at {reader._offset}")
            time.sleep(0.001)


def w_program(pw, docs, queries) -> dict:
    """(a) the windows, (b) their diff, (c) each query's best doc of its
    topic in the lookback interval, (d) each query's latest window."""
    windows = docs.windowby(
        docs.t, window=pw.temporal.sliding(hop=W_HOP, duration=W_DURATION),
        behavior=pw.temporal.common_behavior(delay=W_DELAY, cutoff=W_CUTOFF),
        instance=docs.topic).reduce(
        pw.this.topic, start=pw.this._pw_window_start, n=pw.reducers.count(),
        centroid=pw.reducers.npsum(pw.this.vec), last=pw.reducers.max(pw.this.t))
    diffs = windows.diff(windows.start, windows.n, instance=windows.topic)
    pairs = pw.temporal.interval_join(
        queries, docs, queries.t, docs.t, pw.temporal.interval(-W_LOOKBACK, 0),
        queries.topic == docs.topic).select(
        q=pw.left.q, doc=pw.right.doc,
        score=pw.apply(lambda a, b: float(np.dot(a, b)), pw.left.vec, pw.right.vec))
    best = pairs.groupby(pairs.q).reduce(pairs.q, arg=pw.reducers.argmax(pairs.score),
                                         top=pw.reducers.max(pairs.score))
    best = best.select(best.q, best.top, doc=pairs.ix(best.arg).doc)
    asof = pw.temporal.asof_join(
        queries, windows, queries.t, windows.last, queries.topic == windows.topic).select(
        q=pw.left.q, start=pw.right.start, last=pw.right.last,
        cos=pw.apply(lambda a, c: float(np.dot(a, c) / np.linalg.norm(c)),
                     pw.left.vec, pw.right.centroid))
    return {"windows": windows, "diffs": diffs, "best": best, "asof": asof}


def w_stream(pw, emb, feed: dict, windowed: bool, timeout: float = 600.0) -> dict:
    """One rep: the docs, then the queries, through the paced broker into
    the embed UDF and, when ``windowed``, the temporal program. Returns
    the final tables, the run's wall and the docs reader's commits."""
    import threading

    from pathway_tpu_torch.internals import run as run_mod
    from pathway_tpu_torch.io.kafka import InMemoryKafkaBroker

    pw.clear_graph()
    broker = InMemoryKafkaBroker()

    class DocSchema(pw.Schema):
        doc: int
        topic: int
        t: int
        text: str

    class QuerySchema(pw.Schema):
        q: int
        topic: int
        t: int
        text: str

    docs = pw.io.kafka.read(broker, topic="docs", schema=DocSchema)
    docs = docs.with_columns(vec=emb(docs.text))
    queries = pw.io.kafka.read(broker, topic="queries", schema=QuerySchema)
    queries = queries.with_columns(vec=emb(queries.text))
    tables = (w_program(pw, docs, queries) if windowed
              else {"docs": docs.select(docs.doc), "queries": queries.select(queries.q)})
    finals = {name: {} for name in tables}
    lock = threading.Lock()

    def sink(rows):
        def on_change(key, row, time, is_addition):
            with lock:
                if is_addition:
                    rows[key.value] = row
                elif rows.get(key.value) == row:
                    del rows[key.value]
        return on_change

    for name, tab in tables.items():
        pw.io.subscribe(tab, on_change=sink(finals[name]))
    connectors = list(pw.G.connectors)
    failure = []

    def feeder():
        try:
            paced_feed(broker, connectors, "docs", feed["payloads"], W_COMMIT, timeout)
            paced_feed(broker, connectors, "queries", feed["q_payloads"], W_QUERIES, timeout)
        except Exception as exc:  # noqa: BLE001 - raised below
            failure.append(exc)
        finally:
            broker.close()

    thread = threading.Thread(target=feeder, daemon=True)
    t0 = time.perf_counter()
    thread.start()
    pw.run()
    wall = time.perf_counter() - t0
    thread.join(timeout)
    require(not failure and not thread.is_alive(), f"the paced feed ran to its end {failure}")
    reader = next(c for c in connectors if getattr(c, "topic", None) == "docs")
    stats = run_mod.LAST_RUN_STATS.connectors[reader.node.id]
    return {"finals": finals, "wall_s": wall, "docs_per_s": len(feed["t"]) / wall,
            "epochs": stats.commits, "rows_read": stats.rows_read}


def w_host(feed: dict, vecs: np.ndarray) -> dict:
    """The windows from the in-order docs' times on the host:
    {(topic, start): (n, last, centroid)}; every doc lies in
    W_DURATION / W_HOP windows."""
    keep = np.flatnonzero(~feed["late"])
    t, topic = feed["t"][keep], feed["topic"][keep]
    per = W_DURATION // W_HOP
    starts = np.concatenate([(t // W_HOP - k) * W_HOP for k in range(per)])
    topics = np.tile(topic, per)
    members = np.tile(keep, per)
    times = np.tile(t, per)
    order = np.lexsort((starts, topics))
    starts, topics, members, times = (a[order] for a in (starts, topics, members, times))
    head = np.flatnonzero(np.r_[True, (starts[1:] != starts[:-1]) | (topics[1:] != topics[:-1])])
    sums = np.add.reduceat(vecs[members], head, axis=0)
    counts = np.diff(np.r_[head, len(starts)])
    lasts = np.maximum.reduceat(times, head)
    return {(int(topics[h]), int(starts[h])): (int(c), int(last), s)
            for h, c, last, s in zip(head, counts, lasts, sums)}


def w_check(out: dict, feed: dict, host: dict, vecs: np.ndarray, qvecs: np.ndarray) -> dict:
    """(a)-(d) of one windowed rep against the host; returns the counts
    that were printed."""
    f = out["finals"]
    got = {(r["topic"], r["start"]): r for r in f["windows"].values()}
    require(got.keys() == host.keys() and all(
        (got[k]["n"], got[k]["last"]) == host[k][:2] for k in host),
        f"(a) {len(got)} windows, their counts and last times equal the host's from the "
        f"in-order docs ({len(host)} windows)")
    counted = sum(r["n"] for r in got.values())
    require(counted == (W_DURATION // W_HOP) * int((~feed["late"]).sum()),
            f"(a) no late doc counted ({counted} window memberships)")
    cos = np.array([float(np.dot(got[k]["centroid"], host[k][2])
                          / np.linalg.norm(got[k]["centroid"]) / np.linalg.norm(host[k][2]))
                    for k in host])
    require(cos.min() >= C4_COS_MIN, f"(a) centroids within cosine {C4_COS_MIN} of the sum "
                                     f"of the direct embeddings (min {cos.min():.6f})")
    diffs = {(r["topic"], r["start"]): r["diff_n"] for r in f["diffs"].values()}
    want = {k: (host[k][0] - host[(k[0], k[1] - W_HOP)][0]
                if (k[0], k[1] - W_HOP) in host else None) for k in host}
    require(diffs == want, f"(b) the diff of {len(diffs)} windows equals the host's")
    best = {r["q"]: r for r in f["best"].values()}
    agree = near = 0
    worst = 0.0
    for q in feed["queries"]:
        cand = np.flatnonzero((feed["topic"] == q["topic"])
                              & (feed["t"] - q["t"] >= -W_LOOKBACK) & (feed["t"] <= q["t"]))
        scores = vecs[cand] @ qvecs[q["q"]]
        top2 = np.sort(scores)[-2:]
        row = best.get(q["q"])
        if row is None:
            continue
        worst = max(worst, abs(row["top"] - float(top2[-1])))
        if row["doc"] == int(cand[int(np.argmax(scores))]):
            agree += 1
        elif top2[-1] - top2[0] < C4_TIE_TOL:
            near += 1
    require(agree + near == W_QUERIES and worst <= C4_SCORE_TOL,
            f"(c) best docs equal host brute force {agree}/{W_QUERIES} (+{near} at gaps < "
            f"{C4_TIE_TOL}), scores within {C4_SCORE_TOL} (max diff {worst:.2e})")
    asof = {r["q"]: r for r in f["asof"].values()}
    joined, worst_asof = 0, 0.0
    for q in feed["queries"]:
        latest = max(v[1] for k, v in host.items() if k[0] == q["topic"] and v[1] <= q["t"])
        row = asof.get(q["q"])
        if row is None or (q["topic"], row["start"]) not in host:
            continue
        c = host[(q["topic"], row["start"])][2]
        joined += row["last"] == latest == host[(q["topic"], row["start"])][1]
        worst_asof = max(worst_asof, abs(row["cos"] - float(
            np.dot(qvecs[q["q"]], c) / np.linalg.norm(c))))
    require(joined == W_QUERIES and worst_asof <= C4_SCORE_TOL,
            f"(d) {joined}/{W_QUERIES} queries joined to their topic's latest window at or "
            f"before them, cos(query, centroid) within {C4_SCORE_TOL} of the host's "
            f"(max diff {worst_asof:.2e})")
    return {"windows": len(got), "agree": agree, "near": near, "cos_min": float(cos.min()),
            "score_diff": worst, "asof_diff": worst_asof}


def run_temporal_stream(dev, gpu: str) -> int:
    """Phase 19; returns its flash_attn launches."""
    import gc

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import probes
    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.xpacks.llm import SentenceTransformerEmbedder

    t19 = time.perf_counter()
    texts = c4_texts(C4_DOCS)
    feed = w_feed(texts)
    emb = SentenceTransformerEmbedder("minilm-l6", max_batch_size=C4_BATCH, deferred=True,
                                      device=dev)
    model = emb.model
    for b in (8, 16, 32, 64, 128, 256, 512, 1024):  # the pow2 batch buckets, as phase 16
        model.embed_batch(texts[:b])
    counter = EncodeCount(model)
    FA.flash_attn.launches = 0
    # the direct embeddings, in the UDF's batches
    vecs = np.concatenate(model.embed_resolve(
        [model.embed_submit(texts[s : s + C4_BATCH]) for s in range(0, C4_DOCS, C4_BATCH)],
        600))
    qvecs = model.embed_batch([q["text"] for q in feed["queries"]])
    host = w_host(feed, vecs)
    arms = {"plain": [], "windowed": []}
    for _rep in range(W_REPS):
        for name in arms:
            emb._dedup.clear()  # every rep embeds cold
            probes.reset_engine_stats()
            out = w_stream(pw, emb, feed, windowed=name == "windowed")
            if name == "windowed":
                ops = probes.engine_snapshot()["operators"]
                out["ops"] = {n: ops.get(n) for n in W_OPERATORS}
                out["check"] = w_check(out, feed, host, vecs, qvecs)
            else:
                require(len(out["finals"]["docs"]) == C4_DOCS
                        and len(out["finals"]["queries"]) == W_QUERIES,
                        "(plain) every doc and query reached the subscriber")
            out.pop("finals")
            arms[name].append(out)
            gc.collect()
    launches = FA.flash_attn.launches
    n_encodes = len(counter.sizes)
    counter.close()
    require(all(r["rows_read"] == C4_DOCS and r["epochs"] >= C4_DOCS // W_COMMIT
                for rs in arms.values() for r in rs),
            f"every rep read {C4_DOCS} docs in commits of at most {W_COMMIT}")
    med = {n: statistics.median(r["docs_per_s"] for r in rs) for n, rs in arms.items()}
    for name, rs in arms.items():
        info(f"temporal ({name}) [{gpu}]: docs/s " + ", ".join(
            f"{r['docs_per_s']:.1f}" for r in rs) + f" (median {med[name]:.1f}); wall s "
             + ", ".join(f"{r['wall_s']:.3f}" for r in rs) + "; epochs "
             + ", ".join(str(r["epochs"]) for r in rs))
    info(f"temporal: windowed / plain docs/s {med['windowed'] / med['plain']:.4f}")
    for i, r in enumerate(arms["windowed"]):
        info(f"temporal (windowed) rep {i} checks: {json.dumps(r['check'])}")
        info(f"temporal (windowed) rep {i} op_step_seconds / op_rows: "
             + json.dumps(r["ops"]))
    info(f"temporal: phase 19 flash_attn launches {launches}; {n_encodes} encodes; "
         f"{len(feed['late'].nonzero()[0])} late docs; {time.perf_counter() - t19:.1f} s")
    require(launches >= MINILM_LAYERS * n_encodes > 0,
            f"every encode of phase 19 went through flash_attn ({launches} >= "
            f"{MINILM_LAYERS} x {n_encodes})")
    emb.close()
    del vecs, arms
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 20
# several processes on the one card: (a) config 1's CSV corpus into the
# index in one process and in two, in turns, queries answered by the index
# once it holds the whole corpus; (b) the similarity graph of the first
# 4,096 docs (each doc's 5 nearest others at cosine >= MP_TAU) under
# pw.iterate (connected components) and pw.graphs.bellman_ford. Every child
# is this script run with --phase20-child and a spec; it loads the kernels
# the parent built and never builds one.
MP_FILES, MP_REPS, MP_K, MP_B_DOCS, MP_NN = 8, 2, 10, 4096, 5
MP_SCORE_TOL, MP_TAU_NEAR = 1e-3, 1e-3
# the edge threshold on the port's own bf16 MiniLM-L6 embeddings (random
# weights, seed 0) of phase 4's first 4,096 docs, fixed from the 5-NN
# cosines of a first chip run (H100 80GB HBM3, 700 W: every one in
# [0.955, 0.967], median 0.9609) so that half the docs share a component
MP_TAU = 0.9623
MP_TIMEOUT = 300.0  # a bound on each child group


def mp_balanced_names(base: str, n_files: int, processes: int = 2) -> list[str]:
    """``n_files`` CSV paths under ``base`` that split evenly between
    ``processes`` by the reader's path hash (a keyless source shards whole
    files): each process then reads an equal share."""
    from pathway_tpu_torch.engine.value import hash_values, shard_of_key

    if n_files < processes:
        return [os.path.join(base, f"part{f}.csv") for f in range(n_files)]
    for salt in range(10_000):
        paths = [os.path.join(base, f"part{f}-{salt}.csv") for f in range(n_files)]
        owners = [shard_of_key(hash_values(p), processes) for p in paths]
        if all(owners.count(p) == n_files // processes for p in range(processes)):
            return paths
    raise AssertionError("no balanced file names")


def mp_write_csv(base: str, header: list[str], rows: list[tuple], n_files: int) -> None:
    import csv

    os.makedirs(base)
    per = -(-len(rows) // n_files)
    for f, path in enumerate(mp_balanced_names(base, n_files)):
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(header)
            w.writerows(rows[f * per : (f + 1) * per])


def mp_doc_schemas(pw):
    class DocSchema(pw.Schema):
        doc: int
        text: str

    class QuerySchema(pw.Schema):
        q: int
        text: str

    return DocSchema, QuerySchema


def mp_program_a(pw, emb, spec: dict, knn_kw: dict) -> list:
    """(a): CSV docs -> the embed UDF -> the index (and the null sink);
    the queries of one more file, once the index holds every doc (it
    answers as of now), -> k nearest -> JSON lines. Returns the list the
    embedded doc numbers of this process are appended to."""
    DocSchema, QuerySchema = mp_doc_schemas(pw)
    docs = pw.io.csv.read(spec["docs_dir"], schema=DocSchema, mode="static")
    vecs = docs.select(docs.doc, vec=emb(docs.text))
    pw.io.null.write(vecs)
    seen: list = []
    pw.io.subscribe(vecs, on_change=lambda key, row, time, is_addition: seen.append(
        row["doc"]) if is_addition else None)
    index = pw.indexing.DataIndex(vecs, pw.indexing.BruteForceKnn(
        vecs.vec, dimensions=spec["dim"], reserved_space=spec["n_docs"], metric="cos",
        **knn_kw))
    total = vecs.reduce(n=pw.reducers.count())
    queries = pw.io.csv.read(spec["q_dir"], schema=QuerySchema, mode="static")
    ready = queries.filter(total.ix_ref().n == spec["n_docs"])
    qv = ready.select(ready.q, qv=emb(ready.text))
    res = index.query(qv.qv, number_of_matches=spec["k"], with_distances=True)
    res = res.select(q=qv.restrict(res).q, docs=res.doc, dist=res._pw_dist)
    pw.io.jsonlines.write(res, spec["out_a"])
    return seen


def mp_neighbours(docs, dists) -> tuple:
    return tuple((int(d), -float(s)) for d, s in zip(docs, dists))


def mp_program_b(pw, emb, spec: dict, knn_kw: dict) -> None:
    """(b): the first docs embedded into the index; once it holds them all,
    each doc's nearest others at cosine >= tau are edges (both ways);
    connected components by min-label propagation under pw.iterate, and
    pw.graphs.bellman_ford from doc 0 over weight 1 - cos. Writes the
    5-NN pairs, the edges, the labels and the distances as JSON lines."""
    DocSchema, _ = mp_doc_schemas(pw)
    docs = pw.io.csv.read(spec["b_dir"], schema=DocSchema, mode="static")
    vecs = docs.select(docs.doc, vec=emb(docs.text))
    index = pw.indexing.DataIndex(vecs, pw.indexing.BruteForceKnn(
        vecs.vec, dimensions=spec["dim"], reserved_space=spec["n_b"], metric="cos", **knn_kw))
    total = vecs.reduce(n=pw.reducers.count())
    ready = vecs.filter(total.ix_ref().n == spec["n_b"])
    res = index.query(ready.vec, number_of_matches=spec["nn"] + 1, with_distances=True)
    nbrs = res.select(u=ready.restrict(res).doc,
                      nb=pw.apply(mp_neighbours, res.doc, res._pw_dist))
    flat = nbrs.flatten(nbrs.nb)
    pairs = flat.select(u=flat.u, v=pw.apply_with_type(lambda p: p[0], int, flat.nb),
                        cos=pw.apply_with_type(lambda p: p[1], float, flat.nb))
    pairs = pairs.filter(pairs.u != pairs.v)
    pw.io.jsonlines.write(pairs, os.path.join(spec["out_b"], "nn.jsonl"))
    edges = pairs.filter(pairs.cos >= spec["tau"])
    und = edges.select(u=edges.u, v=edges.v, w=1.0 - edges.cos).concat_reindex(
        edges.select(u=edges.v, v=edges.u, w=1.0 - edges.cos))
    verts = vecs.select(n=vecs.doc)
    labels0 = verts.groupby(verts.n).reduce(verts.n, label=pw.reducers.min(verts.n))

    def spread(labels, und):
        cand = labels.join(und, labels.n == und.u).select(n=und.v, label=labels.label)
        both = labels.select(labels.n, labels.label).concat_reindex(cand)
        return dict(labels=both.groupby(both.n).reduce(both.n,
                                                       label=pw.reducers.min(both.label)),
                    und=und)

    labels = pw.iterate(spread, labels=labels0, und=und).labels
    pw.io.jsonlines.write(labels, os.path.join(spec["out_b"], "labels.jsonl"))
    vt = vecs.select(doc=vecs.doc, is_source=vecs.doc == 0).with_id_from(pw.this.doc)
    ge = und.select(u=vt.pointer_from(und.u), v=vt.pointer_from(und.v), dist=und.w)
    sp = pw.graphs.bellman_ford(vt, ge)
    dists = sp.join(vt, sp.id == vt.id).select(vt.doc, d=sp.dist_from_source)
    pw.io.jsonlines.write(dists, os.path.join(spec["out_b"], "dists.jsonl"))


def mp_model(spec: dict):
    """The child's encoder: phase 4's MiniLM-L6 (bf16, seeded) on the card,
    or the tests' small encoder from its pickled weights on the CPU."""
    import pickle

    import torch

    from pathway_tpu_torch import SentenceEmbedderModel
    from pathway_tpu_torch.models.transformer import MINILM_L6, TransformerConfig

    if spec["model"] == "minilm":
        return SentenceEmbedderModel(MINILM_L6, max_length=64, device=spec["device"])
    from pathway_tpu_torch.models.params import from_jax_params
    from pathway_tpu_torch.models.tokenizer import HashTokenizer

    m = spec["model"]
    with open(m["params"], "rb") as fh:
        npp = pickle.load(fh)
    cfg = TransformerConfig(**m["cfg"], dtype=getattr(torch, m["dtype"]))
    return SentenceEmbedderModel(cfg, params=from_jax_params(npp),
                                 tokenizer=HashTokenizer(vocab_size=m["cfg"]["vocab_size"],
                                                         max_length=m["max_len"]),
                                 max_length=m["max_len"], device=spec["device"])


def mp_load_kernels() -> list[str]:
    """Load every kernel library and the engine's loops from the build
    directory the parent filled; a missing one fails (a child never
    builds)."""
    from pathway_tpu_torch import kernels, native

    missing = [str(kernels._lib_path(n)) for n in kernels.KERNELS
               if not kernels._lib_path(n).exists()]
    missing += [str(native.lib_path(s)) for s in (None, native._ENGINE_SRC)
                if not native.lib_path(s).exists()]
    if missing:
        raise RuntimeError(f"kernels not built by the parent: {missing}")
    for n in kernels.KERNELS:
        kernels.library(n)
    native.lib()
    native.engine_lib()
    return sorted(kernels.KERNELS)


def mp_barrier(spec: dict) -> None:
    """Wait until every child of the arm is ready (its model built and
    warm), so that no child's run wall holds another's start-up."""
    def ready(pid):
        return os.path.join(spec["tmp"], f"{spec['tag']}-{spec['attempt']}-ready-{pid}")

    open(ready(spec["pid"]), "w").close()
    deadline = time.monotonic() + MP_TIMEOUT
    while not all(os.path.exists(ready(p)) for p in range(spec["processes"])):
        if time.monotonic() > deadline:
            raise TimeoutError("the other children of the arm never got ready")
        time.sleep(0.01)


def mp_child(spec_path: str) -> int:
    """A child of phase 20: one process of an arm. Writes its results as
    JSON to ``spec["result"]``."""
    import hashlib

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import probes
    from pathway_tpu_torch.engine.operators.external_index import ExternalIndexNode
    from pathway_tpu_torch.internals import run as run_mod
    from pathway_tpu_torch.internals.iterate import IterateNode
    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.xpacks.llm import SentenceTransformerEmbedder

    with open(spec_path) as fh:
        spec = json.load(fh)
    cuda = spec["device"].startswith("cuda")
    out = {"pid": spec["pid"], "loaded": mp_load_kernels() if cuda else []}
    model = mp_model(spec)
    emb = SentenceTransformerEmbedder(model, max_batch_size=spec["batch"], deferred=True)
    for b in (8, 16, 32, 64, 128, 256, 512, 1024):  # the pow2 batch buckets
        if b <= spec["batch"]:
            model.embed_batch([f"warm {i}" for i in range(b)])
    knn_kw = {} if cuda else {"device": "cpu"}
    mp_barrier(spec)
    FA.flash_attn.launches = 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def config(arm):
        return pw.EngineConfig(processes=spec["processes"], process_id=spec["pid"],
                               first_port=spec["ports"][arm])

    def run(arm):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        pw.run(config=config(arm))
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    if "a" in spec["arms"]:
        pw.clear_graph()
        seen = mp_program_a(pw, emb, spec, knn_kw)
        node = next(n for n in pw.G.engine_graph.nodes if isinstance(n, ExternalIndexNode))
        wall = run("a")
        keys = np.sort(np.asarray(node._index._keys, dtype=np.uint64))
        ops = sorted(run_mod.LAST_RUN_STATS.operators.values(), key=lambda o: -o.total_time_s)
        out["a"] = {"wall_s": wall, "docs": sorted(seen), "index_rows": len(node._index),
                    "index_keys": hashlib.sha256(keys.tobytes()).hexdigest(),
                    "exchange": dict(run_mod.LAST_RUN_STATS.exchange),
                    "top_ops": [(o.name, round(o.total_time_s, 4), o.rows_in, o.epochs)
                                for o in ops[:8]]}
    if "b" in spec["arms"]:
        emb._dedup.clear()  # (b)'s docs are (a)'s first: embed them again
        pw.clear_graph()
        probes.reset_engine_stats()
        mp_program_b(pw, emb, spec, knn_kw)
        iters = [n for n in pw.G.engine_graph.nodes if isinstance(n, IterateNode)]
        wall = run("b")
        stats = run_mod.LAST_RUN_STATS
        out["b"] = {"wall_s": wall, "exchange": dict(stats.exchange),
                    "rounds": [n.rounds for n in iters],
                    "iterate_step_s": [stats.operators[n.id].total_time_s
                                       if n.id in stats.operators else 0.0 for n in iters],
                    "op_step": probes.engine_snapshot()["operators"].get("Iterate")}
    pw.clear_graph()
    emb.close()
    out["flash_attn"] = FA.flash_attn.launches
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    tmp = spec["result"] + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(out, fh)
    os.replace(tmp, spec["result"])
    return 0


def mp_free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def mp_arm(base: dict, processes: int, arms: str, tag: str, tries: int = 3) -> list[dict]:
    """Run one arm: ``processes`` children at once, each told its process
    id and the mesh's first ports; every wait bounded, every child stopped.
    A port range taken meanwhile (EADDRINUSE) is retried with a fresh one.
    Returns the children's results."""
    import subprocess

    for attempt in range(tries):
        ports = {"a": mp_free_port(), "b": mp_free_port()}
        procs, specs = [], []
        for pid in range(processes):
            spec = dict(base, pid=pid, processes=processes, arms=arms, ports=ports, tag=tag,
                        attempt=attempt,
                        out_a=os.path.join(base["tmp"], f"{tag}-a.jsonl"),
                        out_b=os.path.join(base["tmp"], f"{tag}-b"),
                        result=os.path.join(base["tmp"], f"{tag}-{pid}.json"))
            os.makedirs(spec["out_b"], exist_ok=True)
            path = os.path.join(base["tmp"], f"{tag}-{pid}-spec.json")
            with open(path, "w") as fh:
                json.dump(spec, fh)
            log = open(os.path.join(base["tmp"], f"{tag}-{pid}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--phase20-child", path],
                stdout=log, stderr=subprocess.STDOUT, cwd=base["tmp"]), log))
            specs.append(spec)
        deadline = time.monotonic() + MP_TIMEOUT
        try:
            for p, _log in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(30)
                log.close()
        logs = []
        for spec in specs:
            with open(os.path.join(base["tmp"], f"{tag}-{spec['pid']}.log")) as fh:
                logs.append(fh.read())
        rcs = [p.returncode for p, _ in procs]
        if any(rcs) and attempt + 1 < tries and any("Address already in use" in t for t in logs):
            continue
        for spec, rc, text in zip(specs, rcs, logs):
            if rc != 0:
                raise AssertionError(f"phase 20 {tag} child {spec['pid']} exited {rc}:\n"
                                     f"{text[-4000:]}")
        results = []
        for spec in specs:
            with open(spec["result"]) as fh:
                results.append(json.load(fh))
        return results
    raise AssertionError("unreachable")


def mp_fold(rows: list[dict], key: tuple, val: tuple) -> dict:
    """An update stream folded to its final state: {key: value} of the live
    rows; a key with two live rows means a lost retraction."""
    def frozen(x):
        return tuple(frozen(y) for y in x) if isinstance(x, list) else x

    net: dict = {}
    for r in rows:
        k = (tuple(r[c] for c in key), tuple(frozen(r[c]) for c in val))
        net[k] = net.get(k, 0) + r["diff"]
    out: dict = {}
    for (k, v), c in net.items():
        if c:
            if c != 1 or k in out:
                raise AssertionError(f"phase 20: {k} has live rows {out.get(k)}, {v} "
                                     f"(count {c}): a retraction was lost")
            out[k] = v
    return out


def mp_shards(path: str, processes: int) -> list[dict]:
    paths = [path] if processes == 1 else [f"{path}.{p}" for p in range(processes)]
    rows = []
    for p in paths:
        if os.path.exists(p):
            with open(p) as fh:
                rows.extend(json.loads(line) for line in fh)
    return rows


def mp_replies(base: dict, tag: str, processes: int) -> dict:
    """(a)'s replies: {query: [(doc, score)]} folded over the shards."""
    rows = mp_shards(os.path.join(base["tmp"], f"{tag}-a.jsonl"), processes)
    folded = mp_fold(rows, ("q",), ("docs", "dist"))
    return {k[0]: [(int(d), -float(s)) for d, s in zip(*v)] for k, v in folded.items()}


def mp_graph(base: dict, tag: str, processes: int) -> dict:
    """(b)'s written tables, folded: the 5-NN pairs, the edges kept at tau,
    the component labels and the distances from doc 0."""
    out_b = os.path.join(base["tmp"], f"{tag}-b")
    pairs = mp_fold(mp_shards(os.path.join(out_b, "nn.jsonl"), processes), ("u", "v"), ("cos",))
    labels = mp_fold(mp_shards(os.path.join(out_b, "labels.jsonl"), processes), ("n",),
                     ("label",))
    dists = mp_fold(mp_shards(os.path.join(out_b, "dists.jsonl"), processes), ("doc",), ("d",))
    return {"pairs": {k: v[0] for k, v in pairs.items()},
            "labels": {k[0]: v[0] for k, v in labels.items()},
            "dists": {k[0]: float(v[0]) for k, v in dists.items()}}


def mp_host_graph(pairs: dict, n: int, tau: float) -> tuple[dict, dict]:
    """Union-find components (labelled by their smallest doc) and Dijkstra
    distances from doc 0 over the pairs at cosine >= tau, both ways."""
    import heapq

    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    adj: dict = {}
    for (u, v), c in pairs.items():
        if c >= tau:
            a, b = find(u), find(v)
            if a != b:
                parent[max(a, b)] = min(a, b)
            w = 1.0 - c
            adj.setdefault(u, []).append((v, w))
            adj.setdefault(v, []).append((u, w))
    labels = {}
    for x in range(n):
        labels[x] = find(x)
    small = {}
    for x, r in labels.items():
        small[r] = min(small.get(r, x), x)
    labels = {x: small[r] for x, r in labels.items()}
    dist = {0: 0.0}
    heap = [(0.0, 0)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist.get(u, float("inf")):
            continue
        for v, w in adj.get(u, ()):
            nd = d + w
            if nd < dist.get(v, float("inf")):
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return labels, {x: dist.get(x, float("inf")) for x in range(n)}


def mp_check_graph(g: dict, n: int, tau: float, arm: str) -> dict:
    labels, dists = mp_host_graph(g["pairs"], n, tau)
    require(g["labels"] == labels,
            f"(b) {arm}: the pw.iterate components equal a host union-find over its edges")
    require(g["dists"].keys() == dists.keys() and all(
        (g["dists"][x] == dists[x] == float("inf")) or abs(g["dists"][x] - dists[x]) < 1e-9
        for x in dists), f"(b) {arm}: bellman_ford equals a host Dijkstra over its edges")
    sizes: dict = {}
    for lab in labels.values():
        sizes[lab] = sizes.get(lab, 0) + 1
    shared = sum(s for s in sizes.values() if s > 1) / n
    return {"components": len(sizes), "shared": shared,
            "reached": sum(1 for d in dists.values() if d < float("inf")),
            "edges": sum(1 for c in g["pairs"].values() if c >= tau),
            "near_tau": sum(1 for c in g["pairs"].values() if abs(c - tau) < MP_TAU_NEAR)}


# one rep of (a) a process count (a second did not fit the script's time with
# phase 21)
MP_PLAN = ((1, "ab", "p1r0"), (2, "ab", "p2r0"))


def mp_setup(tmp: str, docs: list[str], queries: list[str], n_b: int) -> dict:
    """Writes the inputs under ``tmp``; returns the spec the children share."""
    mp_write_csv(os.path.join(tmp, "docs"), ["doc", "text"], list(enumerate(docs)), MP_FILES)
    mp_write_csv(os.path.join(tmp, "queries"), ["q", "text"], list(enumerate(queries)), 1)
    mp_write_csv(os.path.join(tmp, "graph"), ["doc", "text"], list(enumerate(docs[:n_b])),
                 MP_FILES)
    return {"tmp": tmp, "docs_dir": os.path.join(tmp, "docs"),
            "q_dir": os.path.join(tmp, "queries"), "b_dir": os.path.join(tmp, "graph"),
            "n_docs": len(docs), "n_q": len(queries), "n_b": n_b, "k": MP_K, "nn": MP_NN}


def mp_run(base: dict, plan=MP_PLAN) -> dict:
    """Every arm of ``plan`` in its order: {tag: (processes, children's results)}."""
    return {tag: (n, mp_arm(base, n, arms, tag)) for n, arms, tag in plan}


def mp_check(base: dict, runs: dict, truth=None) -> dict:
    """Holds phase 20's runs to its bars (see the module docstring); returns
    what it measured, by tag."""
    n_docs, n_b = base["n_docs"], base["n_b"]
    ref = mp_replies(base, "p1r0", 1)
    report = {}
    for tag, (n, kids) in runs.items():
        a = [k["a"] for k in kids]
        shares = [set(x["docs"]) for x in a]
        require(sum(len(s) for s in shares) == n_docs and set().union(*shares) == set(
            range(n_docs)), f"(a) {tag}: the processes embedded disjoint shares of every doc")
        require(all(shares), f"(a) {tag}: every process embedded a share")
        require(all(x["index_rows"] == n_docs for x in a) and len({x["index_keys"] for x in a}) == 1,
                f"(a) {tag}: every process's index holds all {n_docs} rows")
        got = mp_replies(base, tag, n)
        require(sorted(got) == list(range(base["n_q"])) and all(
            len(r) == base["k"] for r in got.values()),
            f"(a) {tag}: each query answered exactly once with {base['k']} docs")
        agree = sum(ranks_agree(ref[q], got[q], MP_SCORE_TOL) for q in got)
        require(agree == len(got), f"(a) {tag}: top-{base['k']} equal the one-process run's "
                                   f"but at score gaps < {MP_SCORE_TOL} ({agree}/{len(got)})")
        rep = {"processes": n, "docs_per_s": n_docs / max(x["wall_s"] for x in a),
               "walls": [x["wall_s"] for x in a], "docs": [len(s) for s in shares],
               "exchange_a": [x["exchange"] for x in a], "top_ops": [x["top_ops"] for x in a],
               "flash_attn": [k["flash_attn"] for k in kids],
               "peak_bytes": [k["peak_bytes"] for k in kids],
               "loaded": [k["loaded"] for k in kids]}
        if truth is not None:
            hits = sum(len({d for d, _ in got[q]} & set(truth[q].tolist())) for q in got)
            rep["recall"] = hits / (len(got) * base["k"])
            require(rep["recall"] >= 0.9, f"(a) {tag}: recall@10 {rep['recall']:.4f} >= 0.9")
        if "b" in kids[0]:
            rep["graph"] = mp_check_graph(mp_graph(base, tag, n), n_b, base["tau"], tag)
            rep["b"] = [k["b"] for k in kids]
            require(0.1 <= rep["graph"]["shared"] <= 0.9,
                    f"(b) {tag}: {rep['graph']['shared']:.3f} of the docs share a component "
                    f"at tau {base['tau']} (10-90% wanted)")
        report[tag] = rep
    g1, g2 = report["p1r0"]["graph"], report["p2r0"]["graph"]
    require(g1["components"] == g2["components"] or g1["near_tau"] or g2["near_tau"],
            "(b) the two arms' component counts are equal (no edge within "
            f"{MP_TAU_NEAR} of tau)")
    return report


def run_multiprocess(gpu: str, docs, queries, truth) -> int:
    """Phase 20 on the card; returns its children's flash_attn launches."""
    import tempfile

    import torch

    from pathway_tpu_torch.models.transformer import MINILM_L6

    t20 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        base = mp_setup(tmp, docs, queries, MP_B_DOCS)
        base.update(dim=MINILM_L6.hidden, tau=MP_TAU, batch=RAG_BATCH, model="minilm",
                    device="cuda:0")
        runs = mp_run(base)
        g = mp_graph(base, "p1r0", 1)
        cos = np.sort(np.asarray(list(g["pairs"].values())))
        info(f"multiprocess (b): 5-NN cosines of the first {MP_B_DOCS} docs: quantiles "
             + ", ".join(f"{q}: {np.quantile(cos, q):.4f}" for q in (0.05, 0.25, 0.5, 0.75, 0.95))
             + f"; tau {MP_TAU}")
        report = mp_check(base, runs, truth)
    launches = 0
    for tag, rep in report.items():
        launches += sum(rep["flash_attn"])
        info(f"multiprocess (a) {tag} [{gpu}]: {rep['processes']} process(es), docs/s "
             f"{rep['docs_per_s']:.1f} (walls s {', '.join(f'{w:.3f}' for w in rep['walls'])}); "
             f"docs a process {rep['docs']}; recall@10 {rep['recall']:.4f}; flash_attn "
             f"{rep['flash_attn']}; peak bytes {rep['peak_bytes']}; exchange "
             + json.dumps(rep["exchange_a"]) + "; operators by step s (name, s, rows in, "
             "epochs) " + json.dumps(rep["top_ops"]))
        require(all(len(x) == 4 for x in rep["loaded"]),
                f"{tag}: every child loaded the four kernel libraries")
        require(all(x > 0 for x in rep["flash_attn"]), f"{tag}: every child ran flash_attn")
        if "graph" in rep:
            gr = rep["graph"]
            info(f"multiprocess (b) {tag} [{gpu}]: {gr['components']} components, "
                 f"{gr['shared']:.3f} of the docs in shared ones, {gr['edges']} edges "
                 f"({gr['near_tau']} within {MP_TAU_NEAR} of tau), {gr['reached']} reached "
                 f"from doc 0; iterate rounds {[b['rounds'] for b in rep['b']]}, Iterate step "
                 f"s {[[round(s, 4) for s in b['iterate_step_s']] for b in rep['b']]}, "
                 f"op_step_seconds {json.dumps([b['op_step'] for b in rep['b']])}; walls s "
                 f"{[round(b['wall_s'], 3) for b in rep['b']]}; exchange "
                 + json.dumps([b["exchange"] for b in rep["b"]]))
    med = {n: statistics.median(r["docs_per_s"] for r in report.values() if r["processes"] == n)
           for n in (1, 2)}
    info(f"multiprocess: docs/s two processes / one {med[2] / med[1]:.4f} (medians "
         f"{med[1]:.1f}, {med[2]:.1f}); phase 20 flash_attn launches {launches}; "
         f"{time.perf_counter() - t20:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 21
# pw.ml, rag_eval with the observability routes, and the fleet over
# processes. (a): phase 4's first ML_DOCS docs through the embed UDF (batches of 1,024)
# into clustering_via_lsh (cosine bucketer over 384 dims, 10 hashes a band,
# 4 bands, seed 0; k = 64) and knn_classifier (64 queries, k = 10); the
# fuzzy join over ML_FUZZY_DOCS doc texts. (b): rag_eval's dataset of
# EVAL_N questions. (c): 8 questions, 2 on each of 4 shared 256-byte heads,
# through `python -m pathway_tpu_torch fleet serve` over 1 and 2 replica
# processes.
ML_BATCH, ML_K, ML_M, ML_L, ML_SEED, ML_KNN_K = 1024, 64, 10, 4, 0, 10
ML_TIE_REL, ML_MAX_DISAGREE, ML_FUZZY_DOCS, ML_FUZZY_MIN = 1e-3, 0.01, 512, 0.95
# (a)'s depth, a quarter of the corpus, and (b)'s questions: each halved
# twice from 32,768 docs and 64 questions for the script's time
ML_DOCS = 8192
EVAL_N, EVAL_HELD = 16, 8
P21_HEADS, P21_PER_HEAD, P21_HEAD_LEN = 4, 2, 256
P21_TIMEOUT = 300.0  # a bound on each wait: a boot, a burst, a respawn, a stop
# a replica not ready this long after its start is drained and respawned
# (JAX's CLI default; a replica boots in 20-40 s)
P21_BOOT_GRACE = 120.0
KERNEL_NAME = r"(\w*kernel\w*)"  # a kernel's own name in a demangled trace name


def ml_rep_groups(vecs: np.ndarray, bucketer) -> tuple[list, np.ndarray]:
    """The LSH representatives as the engine groups them: ``(band, bucket)``
    groups in the order ``apply_all_rows`` hands them to the clustering
    (sorted by the group's row key) and each doc's group per band."""
    from pathway_tpu_torch.engine.value import hash_values

    members: dict = {}
    rows = [[(i, int(b)) for i, b in enumerate(bucketer(v))] for v in vecs]
    for j, r in enumerate(rows):
        for g in r:
            members.setdefault(g, []).append(j)
    order = sorted(members, key=lambda g: hash_values(*g) & 0xFFFFFFFFFFFFFFFF)
    pos = {g: n for n, g in enumerate(order)}
    doc_groups = np.array([[pos[g] for g in r] for r in rows], dtype=np.int64)
    return [members[g] for g in order], doc_groups


def ml_host_kmeans(reps: np.ndarray, w: np.ndarray, k: int, n_iters: int = 10):
    """JAX's clustering of the representatives on the host: the init as
    JAX picks it (numpy, f32 weights), then its k-means steps and the
    nearest centroid in f64. Returns the labels and each representative's
    near-tie flag (its two nearest centroids within ML_TIE_REL)."""
    host = np.asarray(reps, dtype=np.float32)
    init = host[np.argsort(-np.asarray(w, dtype=np.float32))[:k]]
    if init.shape[0] < k:
        init = np.tile(init, (-(-k // max(init.shape[0], 1)), 1))[:k]
    v, c = host.astype(np.float64), init.astype(np.float64)

    def dist2(c):
        return (v * v).sum(1)[:, None] + (c * c).sum(1)[None, :] - 2.0 * v @ c.T

    for _ in range(n_iters):
        a = dist2(c).argmin(1)
        sums = np.zeros_like(c)
        np.add.at(sums, a, v)
        counts = np.bincount(a, minlength=k)[:, None].astype(np.float64)
        c = np.where(counts > 0, sums / np.maximum(counts, 1.0), c)
    d2 = dist2(c)
    two = np.sort(d2, axis=1)[:, :2]
    near = (two[:, 1] - two[:, 0]) <= ML_TIE_REL * np.maximum(np.abs(two[:, 1]), 1e-12)
    return d2.argmin(1), near


def majority_set(labels) -> set:
    from collections import Counter

    counts = Counter(labels).most_common()
    return {v for v, c in counts if c == counts[0][1]}


def ml_program(pw, emb, docs, queries, *, dims: int, k: int, knn_k: int, device,
               bucketer=None) -> dict:
    """(a)'s program, one pw.run(): the texts through the embed UDF into
    clustering_via_lsh and, over its labels, knn_classifier of the
    queries. The clustering's input (the representatives and weights the
    engine hands it) is recorded. Returns the vectors, labels and
    predictions by row, the run's wall and the recorded input."""
    from pathway_tpu_torch.stdlib.ml import classifiers
    from pathway_tpu_torch.stdlib.ml._lsh import generate_cosine_lsh_bucketer

    bucketer = bucketer or generate_cosine_lsh_bucketer(dims, M=ML_M, L=ML_L, seed=ML_SEED)
    pw.clear_graph()
    schema = pw.schema_from_types(i=int, text=str)
    d = pw.debug.table_from_rows(schema, [(i, t) for i, t in enumerate(docs)])
    q = pw.debug.table_from_rows(schema, [(i, t) for i, t in enumerate(queries)])
    vecs = d.select(d.i, data=emb(d.text))
    qvecs = q.select(q.i, data=emb(q.text))
    labels = classifiers.clustering_via_lsh(vecs, bucketer, k=k, device=device)
    preds = classifiers.knn_classifier(vecs.select(vecs.data), labels, qvecs.select(qvecs.data),
                                       k=knn_k, n_dimensions=dims, distance_type="cosine",
                                       device=device)
    out = {"vecs": {}, "qvecs": {}, "labels": {}, "preds": {}, "kmeans_in": []}

    def keep(name, col=None):
        def on_change(key, row, time, is_addition):
            if is_addition:
                out[name][key.value] = row if col is None else row[col]
            else:
                out[name].pop(key.value, None)
        return on_change

    pw.io.subscribe(vecs, on_change=keep("vecs"))
    pw.io.subscribe(qvecs, on_change=keep("qvecs"))
    pw.io.subscribe(labels, on_change=keep("labels", "label"))
    pw.io.subscribe(preds, on_change=keep("preds", "predicted_label"))
    orig = classifiers._kmeans_labels

    def recorded(v, w, kk, dev):
        got = orig(v, w, kk, dev)
        out["kmeans_in"].append((np.array(v, dtype=np.float32), np.asarray(w), got))
        return got

    classifiers._kmeans_labels = recorded
    try:
        t0 = time.perf_counter()
        pw.run()
        out["wall_s"] = time.perf_counter() - t0
    finally:
        classifiers._kmeans_labels = orig
    pw.clear_graph()
    out["bucketer"] = bucketer
    return out


def ml_check(out: dict, k: int, knn_k: int) -> dict:
    """Holds (a)'s program to its host references (see the module
    docstring); returns the counts it printed."""
    n = len(out["vecs"])
    keys = sorted(out["vecs"], key=lambda kk: out["vecs"][kk]["i"])
    vecs = np.stack([np.asarray(out["vecs"][kk]["data"], dtype=np.float32) for kk in keys])
    require(len(out["kmeans_in"]) == 1, "(a) the representatives were clustered once")
    reps, w, rep_labels = out["kmeans_in"][0]
    members, doc_groups = ml_rep_groups(vecs, out["bucketer"])
    host_means = np.stack([vecs[m].astype(np.float64).mean(0) for m in members])
    require([len(m) for m in members] == [int(x) for x in w]
            and np.abs(host_means - reps).max() < 1e-4,
            f"(a) the engine's {len(w)} representatives equal the host's groups, in its order")
    ref, near = ml_host_kmeans(reps, w, k)
    port_rep = np.asarray(rep_labels)
    labels = np.array([out["labels"][kk] for kk in keys])
    ref_sets = [majority_set(ref[g]) for g in doc_groups]
    bad = [j for j in range(n) if labels[j] not in ref_sets[j]]
    tie_bad = sum(bool(near[doc_groups[j]].any()) for j in bad)
    qkeys = sorted(out["qvecs"], key=lambda kk: out["qvecs"][kk]["i"])
    qv = np.stack([np.asarray(out["qvecs"][kk]["data"], dtype=np.float32) for kk in qkeys])
    scores = (qv @ vecs.T) / np.outer(np.linalg.norm(qv, axis=1), np.linalg.norm(vecs, axis=1))
    agree = boundary = 0
    for r, kk in enumerate(qkeys):
        order = np.argsort(-scores[r], kind="stable")
        tie = scores[r][order[knn_k - 1]] - scores[r][order[knn_k]] < RAG_TIE_TOL
        ok = out["preds"][kk] in majority_set(labels[order[:knn_k]])
        agree += ok
        boundary += (not ok) and tie
    return {"n": n, "reps": len(w), "rep_disagree": int((port_rep != ref).sum()),
            "rep_near": int(near.sum()), "bad": len(bad), "tie_bad": tie_bad,
            "agree": agree, "boundary": boundary, "n_q": len(qkeys),
            "reps_vecs": reps, "reps_w": w}


def fuzzy_changed(texts: list[str], seed: int = 21) -> list[str]:
    """Each text with one seeded word replaced by a word no text has."""
    rng = np.random.default_rng(seed)
    out = []
    for t in texts:
        ws = t.split()
        ws[int(rng.integers(0, len(ws)))] = f"zq{int(rng.integers(0, 10 ** 6))}"
        out.append(" ".join(ws))
    return out


def fuzzy_arm(pw, texts: list[str]) -> dict:
    """fuzzy_match_tables of ``texts`` against their changed copies;
    returns the matched (left index, right index) pairs and the wall."""
    from pathway_tpu_torch.internals.run import capture_table
    from pathway_tpu_torch.stdlib.ml.smart_table_ops import fuzzy_match_tables

    pw.clear_graph()
    schema = pw.schema_from_types(text=str)
    changed = fuzzy_changed(texts)
    left = pw.debug.table_from_rows(schema, [(t,) for t in texts])
    right = pw.debug.table_from_rows(schema, [(t,) for t in changed])
    keys = []
    for tab, side in ((left, texts), (right, changed)):
        pos = {t: i for i, t in enumerate(side)}
        keys.append({k: pos[r[0]] for k, r in capture_table(tab).state.rows.items()})
    t0 = time.perf_counter()
    cap = capture_table(fuzzy_match_tables(left, right))
    wall = time.perf_counter() - t0
    cols = list(cap.column_names)
    li, ri = cols.index("left"), cols.index("right")
    pairs = [(keys[0][r[li].value], keys[1][r[ri].value]) for r in cap.state.rows.values()]
    pw.clear_graph()
    return {"pairs": pairs, "wall_s": wall}


def run_ml(dev, gpu: str, out: dict, docs, queries) -> int:
    """Phase 21 (a); returns its flash_attn launches."""
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.ops.ivf import kmeans_fit
    from pathway_tpu_torch.xpacks.llm import SentenceTransformerEmbedder

    model = out["emb"]
    emb = SentenceTransformerEmbedder(model, max_batch_size=ML_BATCH)
    FA.flash_attn.launches = 0
    res = ml_program(pw, emb, docs, queries, dims=model.cfg.hidden, k=ML_K, knn_k=ML_KNN_K,
                     device=dev)
    torch.cuda.synchronize()
    launches = FA.flash_attn.launches
    chk = ml_check(res, ML_K, ML_KNN_K)
    reps = torch.from_numpy(chk["reps_vecs"]).to(dev)
    init = torch.from_numpy(chk["reps_vecs"][np.argsort(-chk["reps_w"].astype(np.float32))
                                             [:ML_K]]).to(dev)
    km_ms = cuda_time_ms(lambda: kmeans_fit(reps, init), 5)
    info(f"ml (a) {len(docs)} docs -> embed UDF (batches of {ML_BATCH}) -> clustering_via_lsh "
         f"(cosine, M={ML_M}, L={ML_L}, k={ML_K}) + knn_classifier ({len(queries)} queries, "
         f"k={ML_KNN_K}) in one pw.run() [{gpu}]: {len(docs) / res['wall_s']:.1f} docs/s "
         f"({res['wall_s']:.3f} s); {chk['reps']} representatives; k-means on the card "
         f"{km_ms:.4f} ms (CUDA events, 10 steps); flash_attn launches {launches}")
    info(f"ml (a) labels against the host (f64 k-means from the same init): representatives "
         f"labelled apart {chk['rep_disagree']}/{chk['reps']} ({chk['rep_near']} near-ties); "
         f"docs whose label is not a majority of their bands' host labels {chk['bad']}/"
         f"{chk['n']} ({chk['tie_bad']} of them touch a near-tie); knn_classifier predictions "
         f"a majority label of the host's exact top {ML_KNN_K} {chk['agree']}/{chk['n_q']} "
         f"({chk['boundary']} others at a near-tie 10th/11th score)")
    require(chk["n"] == len(docs) and len(res["labels"]) == len(docs), "(a) every doc labelled")
    require(chk["bad"] <= ML_MAX_DISAGREE * chk["n"],
            f"(a) at most {ML_MAX_DISAGREE:.0%} of the docs labelled apart from the host")
    require(chk["agree"] + chk["boundary"] == chk["n_q"],
            "(a) each prediction is a majority label of the host's exact top 10 but at near-ties")
    require(launches >= MINILM_LAYERS * -(-(len(docs) + len(queries)) // ML_BATCH),
            "(a) the embeds went through flash_attn")
    fz = fuzzy_arm(pw, docs[:ML_FUZZY_DOCS])
    hits = sum(i == j for i, j in fz["pairs"])
    info(f"ml (a) fuzzy_match_tables of {ML_FUZZY_DOCS} doc texts against copies with one word "
         f"changed [{gpu}]: {fz['wall_s']:.3f} s; {len(fz['pairs'])} pairs, {hits} matched to "
         f"their original")
    require(hits >= ML_FUZZY_MIN * ML_FUZZY_DOCS,
            f"(a) at least {ML_FUZZY_MIN:.0%} of the texts matched to their original")
    return launches


def get_json(url: str, timeout: float = 30.0):
    """(status, JSON body or None) of one GET; HTTP errors are returned."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            status, body = resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        status, body = exc.code, exc.read()
    try:
        return status, json.loads(body)
    except ValueError:
        return status, body.decode("utf-8", "replace")


def run_rag_eval_phase(dev, gpu: str, out: dict, common) -> dict:
    """Phase 21 (b); returns its launches of the five kernel entry points."""
    import tempfile
    import threading

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import DecoderChat
    from pathway_tpu_torch.internals import run as run_mod
    from pathway_tpu_torch.models import decoder as D
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory
    from pathway_tpu_torch.xpacks import llm
    from pathway_tpu_torch.xpacks.llm import rag_eval
    from pathway_tpu_torch.xpacks.llm.servers import BaseRestServer

    t0 = time.perf_counter()
    model = out["emb"]
    samples = rag_eval.generate_qa_dataset(EVAL_N, seed=0)
    chat = DecoderChat(paged_kv=True, paged_kv_block=BLOCK, paged_kernel=True,
                       flash_prefill=True, **common)
    serve(chat, make_prompts(4, 16, 200, seed=99))  # warm-up, outside the counts

    def qa_over(samples):
        emb = llm.SentenceTransformerEmbedder(model, max_batch_size=RAG_BATCH)
        store = llm.DocumentStore(rag_eval.docs_table(samples), retriever_factory=(
            BruteForceKnnFactory(dimensions=model.cfg.hidden, embedder=emb, metric="cos",
                                 device=model.device)))
        return llm.BaseRAGQuestionAnswerer(chat, store)

    submitted = []
    server_submit = chat.server.submit

    def submit(ids, *a, **kw):
        req = server_submit(ids, *a, **kw)
        submitted.append((list(ids), req))
        return req

    chat.server.submit = submit
    for f in counters().values():
        f.launches = 0
    try:
        pw.clear_graph()
        t1 = time.perf_counter()
        res = rag_eval.run_rag_eval(qa_over(samples), samples)
        eval_s = time.perf_counter() - t1
        torch.cuda.synchronize()
        # the same answerer behind its REST server in pw.run(with_http_server=True),
        # with /debug/profile enabled
        pw.clear_graph()
        prof_dir = tempfile.mkdtemp(prefix="p21-profile-")
        qa = qa_over(samples)
        qa.build_server(RAG_HOST, 0, profile_dir=prof_dir)
        cfg = pw.EngineConfig(metrics_first_port=0)
        live = LiveRun(pw, qa.server.webserver,
                       run=lambda: qa.run_server(with_http_server=True, config=cfg))
        try:
            wait_until(lambda: run_mod.METRICS_SERVER is not None, "the metrics server",
                       RAG_TIMEOUT)
            mbase = f"http://{RAG_HOST}:{run_mod.METRICS_SERVER.port}"
            got = {}
            prof = threading.Thread(target=lambda: got.setdefault(
                "profile", get_json(f"{live.base}/debug/profile?ms=500", RAG_TIMEOUT)))
            prof.start()
            time.sleep(0.05)
            got["answer"] = post(f"{live.base}/v1/pw_ai_answer",
                                 {"prompt": samples[0].question})[0]
            prof.join(RAG_TIMEOUT)
            m_status, m_text = get_json(mbase + "/metrics")
            h_status, _ = get_json(mbase + "/healthz")
            q_status, q_text = get_json(f"{live.base}/metrics")
        finally:
            live.stop()
        require(run_mod.METRICS_SERVER is None, "(b) the metrics server stopped with the run")
        off = BaseRestServer(RAG_HOST, 0)
        off.start_observability_endpoints()
        off.webserver.start()
        try:
            refused = get_json(f"http://{RAG_HOST}:{off.webserver.port}/debug/profile?ms=500")
        finally:
            off.webserver.stop()
    finally:
        del chat.server.submit
    torch.cuda.synchronize()
    launches = {n: f.launches for n, f in counters().items()}
    pw.clear_graph()

    info(f"rag_eval (b) {EVAL_N} questions through run_rag_eval over BaseRAGQuestionAnswerer "
         f"(MiniLM-L6 bf16, phase 6's server) [{gpu}]: {eval_s:.3f} s; n {res['n']}; accuracy "
         f"contains {res['accuracy_contains']:.4f}, exact {res['accuracy_exact']:.4f} (random "
         f"weights: not a quality figure)")
    require(res["n"] == EVAL_N, f"(b) run_rag_eval answered {EVAL_N} questions")
    by_q = {r[0]: r[1] for r in res["results"]}
    held = [s.question for s in samples[:: EVAL_N // EVAL_HELD]]
    first_eq = streams_eq = 0
    gaps = []
    for q in held:
        matches = [(i, r) for i, r in submitted[:EVAL_N] if q in chat.tokenizer.decode(i)]
        require(len(matches) == 1, f"(b) one request served for {q!r}")
        ids, req = matches[0]
        require(by_q[q] == req.text, "(b) the response is the served request's text")
        x = torch.tensor([ids], dtype=torch.int32, device=dev)
        toks = D.generate(chat.params, x, torch.ones_like(x), chat.cfg, MAX_NEW)[0].tolist()
        first_eq += int(req.tokens[0] == toks[0])
        streams_eq += int(req.tokens == toks)
        j = next((t for t, (a, b) in enumerate(zip(req.tokens, toks)) if a != b), None)
        if j is not None:
            # the static path's logits where the streams part: the served
            # token must be within LOGIT_TOL of the static argmax there
            y = torch.tensor([ids + req.tokens[:j]], dtype=torch.int32, device=dev)
            lg = D.forward(chat.params, y, torch.ones_like(y), chat.cfg)[0, -1].float()
            gaps.append(float(lg.max() - lg[req.tokens[j]]))
    info(f"rag_eval (b) against the static path ({EVAL_HELD} of the {EVAL_N}): first tokens "
         f"{first_eq}/{EVAL_HELD}, whole streams {streams_eq}/{EVAL_HELD}; where a stream "
         f"parts, the served token's static logit below the static top "
         f"{sorted(round(g, 4) for g in gaps)}")
    require(first_eq * 8 >= MIN_FIRST_EQUAL * EVAL_HELD,
            f"(b) at least {MIN_FIRST_EQUAL}/8 first tokens equal the static path")
    require(all(g <= LOGIT_TOL for g in gaps),
            f"(b) every stream equals the static path's up to a near-tie (the served token "
            f"within {LOGIT_TOL} of the static top logit where they part)")
    engine_fams = ("pathway_logical_time", "pathway_connector_rows_read_total",
                   "pathway_tpu_op_rows_total")
    serving_fams = ("pathway_tpu_ttft_seconds_count", "pathway_tpu_e2e_seconds_count")
    info(f"rag_eval (b) pw.run(with_http_server=True): /metrics {m_status} ({len(m_text)} "
         f"bytes), /healthz {h_status}; the QA server's /metrics {q_status}")
    require(m_status == 200 and all(f in m_text for f in engine_fams + serving_fams),
            "(b) the metrics server's /metrics holds the engine and serving families")
    require(h_status == 200 and q_status == 200 and "# EOF" in q_text,
            "(b) /healthz and the QA server's /metrics answer 200")
    p_status, p = got["profile"]
    require(p_status == 200 and isinstance(p, dict) and "trace" in p,
            f"(b) /debug/profile?ms=500 wrote a trace ({p!r})")
    trace = json.load(open(p["trace"]))
    kernels = sorted({e["name"] for e in trace["traceEvents"]
                      if e.get("cat") == "kernel" and e.get("name")})
    ours = [k for k in kernels if any(s in k for s in ("paged_split_kernel", "chunk_attn",
                                                        "wq_matmul"))]
    info(f"rag_eval (b) /debug/profile during a question: {p['ms']} ms, activities "
         f"{p['activities']}, {len(trace['traceEvents'])} events, {len(kernels)} kernel names, "
         f"of them the port's: {sorted({re.search(KERNEL_NAME, k).group(1) for k in ours})}")
    require(any("paged_split_kernel" in k for k in kernels)
            and any("chunk_attn" in k for k in kernels),
            "(b) the trace names the paged-decode and chunk kernels")
    r_status, r = refused
    info(f"rag_eval (b) /debug/profile without profile_dir: {r_status} {r}")
    require(r_status == 200 and isinstance(r, dict) and set(r) == {"error"}
            and r["error"].startswith("profiling disabled"),
            "(b) without profile_dir the route refuses in JAX's shape")
    require(got["answer"].get("response") is not None, "(b) the profiled question answered")
    free_chats(chat)
    info(f"rag_eval: phase 21 (b) launches {launches}; {time.perf_counter() - t0:.1f} s")
    require(all(launches[n] > 0 for n in ("flash_attn", "flash_chunk_attn_paged",
                                          "paged_attn_decode", "wq_matmul")),
            "(b) drove flash_attn, flash_chunk_attn_paged, paged_attn_decode and wq_matmul")
    return launches


# (c): the fleet over processes
def p21_replica(argv: list[str]) -> int:
    """A replica of phase 21 (c): phase 6's server (paged, int8 weights,
    greedy) on cuda:0 behind a REST server on ``--port``, the kernels
    loaded from the parent's build (a missing one fails). /v1/pw_ai_answer
    answers ``{"response": ...}``; GET /v1/phase21 reports this process's
    peak memory and kernel launches."""
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import DecoderChat
    from pathway_tpu_torch.xpacks.llm.llms import prompt_chat_single_qa
    from pathway_tpu_torch.xpacks.llm.servers import BaseRestServer

    port = int(argv[argv.index("--port") + 1])
    mp_load_kernels()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _params, _tok, common = decoder_setup(dev)
    chat = DecoderChat(paged_kv=True, paged_kv_block=BLOCK, paged_kernel=True,
                       flash_prefill=True, **common)
    serve(chat, make_prompts(4, 16, 200, seed=99))  # warm-up, outside the counts
    for f in counters().values():
        f.launches = 0

    class Question(pw.Schema):
        prompt: str

    def answer(q):
        reply = chat(prompt_chat_single_qa(q.prompt))
        return q.select(result=pw.apply_with_type(lambda r: pw.Json({"response": r}), pw.Json,
                                                  reply))

    srv = BaseRestServer(RAG_HOST, port)
    srv.serve("/v1/pw_ai_answer", Question, answer)
    srv.webserver._register("/v1/phase21", ["GET"], lambda _p: {
        "pid": os.getpid(), "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "launches": {n: f.launches for n, f in counters().items()}})
    srv.run()
    return 0


def p21_prompts() -> tuple[list[str], list[str]]:
    """P21_HEADS shared heads of P21_HEAD_LEN bytes, two owned by each
    member of a two-replica ring (the router's character keys), and
    P21_PER_HEAD questions behind each: (firsts, the rest)."""
    from pathway_tpu_torch import serving
    from pathway_tpu_torch.serving.router import _char_tokenize

    ring = serving.HashRing()
    for rid in ("replica-0", "replica-1"):
        ring.add(rid)
    rng = np.random.default_rng(211)
    heads, owners, seed = [], [], 210
    while len(heads) < P21_HEADS:
        group = shared_prompts(P21_HEAD_LEN, rng.integers(8, 64, P21_PER_HEAD).tolist(),
                               seed=seed)
        seed += 1
        owner = ring.lookup(serving.head_block_key(
            _char_tokenize(group[0]), block=serving.affinity_block_tokens(), blocks=4))
        if owners.count(owner) < P21_HEADS // 2:
            heads.append(group)
            owners.append(owner)
    return [g[0] for g in heads], [p for g in heads for p in g[1:]]


def p21_fleet(n: int, port: int, logdir: str, replica: list[str], env=None):
    """``python -m pathway_tpu_torch fleet serve --fleet -n n`` over the
    replica program ``replica``, its own output and each replica's in
    ``logdir``."""
    os.makedirs(logdir, exist_ok=True)
    log = open(os.path.join(logdir, "fleet.log"), "wb")
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "pathway_tpu_torch", "fleet", "serve", "--fleet", "-n", str(n),
         "--port", str(port), "--boot-grace", str(P21_BOOT_GRACE), "--health-interval", "0.5",
         "--replica-log-dir", logdir, *replica], cwd=here, stdout=log,
        stderr=subprocess.STDOUT, env=env)
    proc.log = log
    return proc


def p21_state(base: str) -> dict | None:
    try:
        status, state = get_json(base + "/v1/fleet", 10.0)
    except OSError:
        return None
    return state if status == 200 else None


def p21_ready(base: str, n: int) -> bool:
    from pathway_tpu_torch.serving import HttpReplica

    state = p21_state(base)
    return bool(state and state["size"] == n and all(
        HttpReplica(rid, info["url"]).healthy() for rid, info in state["replicas"].items()))


def p21_ask(base: str, prompt: str) -> tuple[int, object]:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + "/v1/pw_ai_answer", method="POST",
                                 data=json.dumps({"prompt": prompt}).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=P21_TIMEOUT) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode("utf-8", "replace")
    except OSError as exc:  # the router dropped the request: a failure
        return 0, repr(exc)


def p21_burst(base: str, prompts: list[str], on_start=None) -> dict:
    """``prompts`` at once from as many threads; returns statuses and
    replies by prompt and the wall."""
    out = {}
    with ThreadPoolExecutor(len(prompts)) as pool:
        t0 = time.perf_counter()
        futs = {p: pool.submit(p21_ask, base, p) for p in prompts}
        if on_start is not None:
            on_start()
        for p, f in futs.items():
            out[p] = f.result(timeout=P21_TIMEOUT)
    return {"replies": out, "wall_s": time.perf_counter() - t0}


def p21_stop(proc) -> int:
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=P21_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        proc.log.close()


def run_fleet_processes(gpu: str, logdir: str, replica: list[str] | None = None,
                        env=None) -> dict:
    """Phase 21 (c); returns the replicas' launches of the five kernel
    entry points. ``replica`` is the replica program (default: this script
    with ``--phase21-replica``); it must serve GET /v1/phase21 as
    :func:`p21_replica` does."""
    import contextlib
    import io
    import signal

    from pathway_tpu_torch import cli
    from pathway_tpu_torch.serving import free_port

    t0 = time.perf_counter()
    replica = replica or [sys.executable, os.path.abspath(__file__), "--phase21-replica"]
    firsts, rest = p21_prompts()
    ports = {1: free_port(), 2: free_port()}
    bases = {n: f"http://{RAG_HOST}:{p}" for n, p in ports.items()}
    fleets = {n: p21_fleet(n, ports[n], os.path.join(logdir, f"fleet{n}"), replica, env)
              for n in (1, 2)}
    launches = {n: 0 for n in counters()}

    def child_stats(base):
        state = p21_state(base) or {"replicas": {}}
        return {rid: get_json(info["url"] + "/v1/phase21")[1]
                for rid, info in state["replicas"].items()}

    try:
        for n in (1, 2):
            wait_until(lambda n=n: p21_ready(bases[n], n), f"{n} ready replica(s)", P21_TIMEOUT)
            require(fleets[n].poll() is None, f"(c) the {n}-replica fleet is up")
        boot_s = time.perf_counter() - t0
        arms = {}
        for n in (1, 2):
            a = p21_burst(bases[n], firsts)
            b = p21_burst(bases[n], rest)
            replies = {**a["replies"], **b["replies"]}
            bad = [(s, str(r)[:200]) for s, r in replies.values() if s != 200]
            if bad:
                info(f"  (c) {n} replica(s): {len(bad)} not answered, e.g. {bad[:3]}; walls "
                     f"{a['wall_s']:.1f} + {b['wall_s']:.1f} s; fleet {p21_state(bases[n])}")
            require(not bad, f"(c) {n} replica(s): every question answered")
            arms[n] = {"answers": {p: r["response"] for p, (_s, r) in replies.items()},
                       "wall_s": a["wall_s"] + b["wall_s"], "children": child_stats(bases[n])}
            if n == 1:
                for st in arms[1]["children"].values():
                    for k, v in st["launches"].items():
                        launches[k] += v
                require(p21_stop(fleets[1]) == 0, "(c) the 1-replica fleet stopped cleanly")
        n_q = len(firsts) + len(rest)
        equal = sum(arms[1]["answers"][p] == arms[2]["answers"][p] for p in firsts + rest)
        tps = {n: n_q * MAX_NEW / arms[n]["wall_s"] for n in (1, 2)}
        info(f"fleet (c) over processes, {n_q} questions behind {P21_HEADS} heads of "
             f"{P21_HEAD_LEN} bytes [{gpu}]: 1 replica {arms[1]['wall_s']:.3f} s wall, "
             f"{tps[1]:.1f} tokens/s; 2 replicas {arms[2]['wall_s']:.3f} s wall, {tps[2]:.1f} "
             f"tokens/s; ratio (2 over 1) {arms[2]['wall_s'] / arms[1]['wall_s']:.4f} wall, "
             f"{tps[2] / tps[1]:.4f} tokens/s; both fleets booted in {boot_s:.1f} s; answers "
             f"equal {equal}/{n_q}")
        for n in (1, 2):
            for rid, st in sorted(arms[n]["children"].items()):
                info(f"  {n}-replica fleet {rid} (pid {st['pid']}): peak "
                     f"max_memory_allocated {st['max_memory_allocated']} bytes; launches "
                     f"{st['launches']}")
        require(equal == n_q, "(c) the 2-replica answers equal the 1-replica run's")
        # failover: one replica killed mid-burst
        state = p21_state(bases[2])
        victim = sorted(state["replicas"].items())[0]
        killed_at = []

        def kill():
            time.sleep(0.3)
            os.kill(victim[1]["pid"], signal.SIGKILL)
            killed_at.append(time.perf_counter())

        before = child_stats(bases[2])
        f = p21_burst(bases[2], firsts + rest, on_start=kill)
        codes = [s for s, _ in f["replies"].values()]
        answered = sum(c == 200 for c in codes)
        shed = sum(c == 503 for c in codes)
        same = sum(s == 200 and r["response"] == arms[1]["answers"][p]
                   for p, (s, r) in f["replies"].items())
        # the manager's respawn (its process started; booting it is what
        # both fleets' start-up already measured)
        wait_until(lambda: (p21_state(bases[2]) or {}).get("respawns", 0) >= 1
                   and p21_state(bases[2])["size"] == 2, "the respawn", P21_TIMEOUT)
        respawn_s = time.perf_counter() - killed_at[0]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["fleet", "stats", "--url", bases[2]])
        listing = buf.getvalue()
        info(f"fleet (c) SIGKILL of {victim[0]} (pid {victim[1]['pid']}) 0.3 s into a burst of "
             f"{n_q} [{gpu}]: {answered} answered ({same} equal to the 1-replica run), {shed} "
             f"shed, {n_q - answered - shed} failed; drained and a new replica spawned "
             f"{respawn_s:.1f} s after the kill; fleet stats --url:")
        for line in listing.splitlines():
            info(f"    {line}")
        require(answered + shed == n_q, "(c) every request answered, shed or failed over")
        require(rc == 0 and listing.count("kind=http") == 2 and "respawn" in listing,
                "(c) fleet stats --url lists 2 members after the respawn")
        # the survivor's launches now, the victim's before the kill (the new
        # replica is still booting: it has launched nothing)
        state = p21_state(bases[2])
        counted = [get_json(info["url"] + "/v1/phase21")[1]["launches"]
                   for rid, info in state["replicas"].items() if rid in before]
        for counts in counted + [before[victim[0]]["launches"]]:
            for k, v in counts.items():
                launches[k] += v
        pids = [info["pid"] for info in p21_state(bases[2])["replicas"].values()]
        require(p21_stop(fleets[2]) == 0, "(c) the 2-replica fleet stopped cleanly")
        wait_until(lambda: not any(os.path.exists(f"/proc/{p}")
                                   and open(f"/proc/{p}/stat").read().split()[2] != "Z"
                                   for p in pids), "the replicas to exit", 60)
    finally:
        for proc in fleets.values():
            if proc.poll() is None:
                p21_stop(proc)
    info(f"fleet: phase 21 (c) replica launches {launches}; {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 22
# persistence on the card: a streaming RAG ingest (CSV files -> the deferred
# embed UDF -> DataIndex) that stops or is killed and resumes exactly once,
# over phase 4's MiniLM-L6 (bf16, seeded) and the first P22_DOCS docs of its
# corpus in P22_FILES CSV files (phase 20's layout at half depth). Run 1 of
# each arm sees files 1-4, run 2 (a fresh graph, the same store) all 8.
# (a) persisting, a filesystem store: every doc id once in each run's sink,
# the index holding every doc, the top-10 of phase 4's 64 queries equal an
# uninterrupted one-run arm's but at score gaps < P22_SCORE_TOL, run 2's
# flash_attn launches covering the replayed and the new rows; (b) a child
# process streaming (a)'s program, SIGKILLed once its sink holds rows, then
# restarted with all files: (a)'s bars; (c) udf_caching: run 2's replayed
# rows DiskCache hits byte-equal to run 1's vectors, its flash_attn launches
# those of its missed batches alone; (d) operator_persisting: an embed UDF
# giving CUDA tensors (not deterministic, so its operator keeps them in its
# replay cache) -> groupby file -> count and the sum of each vector's first
# component: run 2 restores every operator, the replay cache's tensors back
# on the card, embeds files 5-8 only and equals the uninterrupted run within
# P22_SUM_TOL relative; with the index, run 2 falls back to input replay
# and gives (a)'s answer.
P22_FILES, P22_DOCS, P22_K, P22_SCORE_TOL, P22_SUM_TOL = 8, 16384, 10, 1e-3, 1e-4
P22_TIMEOUT = 300.0  # a bound on each wait of the phase


def p22_setup(tmp: str, docs: list[str], queries: list[str]) -> dict:
    """Writes ``docs`` as 8 files and the query file under ``tmp``;
    returns the spec every arm shares (a device and a model to add)."""
    import csv

    os.makedirs(os.path.join(tmp, "files"))
    per = len(docs) // P22_FILES
    files = []
    for f in range(P22_FILES):
        path = os.path.join(tmp, "files", f"part{f}.csv")
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["doc", "text"])
            w.writerows((i, docs[i]) for i in range(f * per, (f + 1) * per))
        files.append(path)
    mp_write_csv(os.path.join(tmp, "queries"), ["q", "text"], list(enumerate(queries)), 1)
    return {"tmp": tmp, "files": files, "q_dir": os.path.join(tmp, "queries"),
            "n_docs": len(docs), "n_q": len(queries), "per_file": per, "k": P22_K,
            "batch": RAG_BATCH, "knn": {}}


def p22_stage(spec: dict, arm: str, upto: int) -> str:
    """The docs directory of ``arm``, holding the first ``upto`` files
    (hard links: the reader keys rows by path, so each arm keeps its own)."""
    d = os.path.join(spec["tmp"], arm, "docs")
    os.makedirs(d, exist_ok=True)
    for path in spec["files"][:upto]:
        dst = os.path.join(d, os.path.basename(path))
        if not os.path.exists(dst):
            os.link(path, dst)
    return d


def p22_program(pw, emb, spec: dict, docs_dir: str, out: str, *, index: bool = True,
                mode: str = "static", vecs_seen: dict | None = None) -> None:
    """CSV docs (persistent id ``docs``) -> the embed UDF -> the index and a
    JSON-lines sink of doc ids (``out``-ids.jsonl); the queries (persistent
    id ``queries``), once the index holds every doc, -> top-k ->
    ``out``-replies.jsonl. ``vecs_seen`` gets each inserted doc's vector."""
    DocSchema, QuerySchema = mp_doc_schemas(pw)
    docs = pw.io.csv.read(docs_dir, schema=DocSchema, mode=mode, refresh_interval=0.1,
                          persistent_id="docs")
    vecs = docs.select(docs.doc, vec=emb(docs.text))
    pw.io.jsonlines.write(vecs.select(vecs.doc), out + "-ids.jsonl")
    if vecs_seen is not None:
        pw.io.subscribe(vecs, on_change=lambda key, row, time, is_addition: vecs_seen.__setitem__(
            row["doc"], np.asarray(row["vec"]).tobytes()) if is_addition else None)
    if not index:
        return
    index_ = pw.indexing.DataIndex(vecs, pw.indexing.BruteForceKnn(
        vecs.vec, dimensions=spec["dim"], reserved_space=spec["n_docs"], metric="cos",
        **spec["knn"]))
    total = vecs.reduce(n=pw.reducers.count())
    queries = pw.io.csv.read(spec["q_dir"], schema=QuerySchema, mode="static",
                             persistent_id="queries")
    ready = queries.filter(total.ix_ref().n == spec["n_docs"])
    qv = ready.select(ready.q, qv=emb(ready.text))
    res = index_.query(qv.qv, number_of_matches=spec["k"], with_distances=True)
    res = res.select(q=qv.restrict(res).q, docs=res.doc, dist=res._pw_dist)
    pw.io.jsonlines.write(res, out + "-replies.jsonl")


def p22_read(path: str) -> list[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.endswith("\n")]


def p22_ids(out: str) -> dict:
    """{doc: net count} of a run's id sink."""
    net: dict = {}
    for r in p22_read(out + "-ids.jsonl"):
        net[r["doc"]] = net.get(r["doc"], 0) + r["diff"]
    return {d: c for d, c in net.items() if c}


def p22_replies(out: str) -> dict:
    folded = mp_fold(p22_read(out + "-replies.jsonl"), ("q",), ("docs", "dist"))
    return {k[0]: [(int(d), -float(s)) for d, s in zip(*v)] for k, v in folded.items()}


def p22_index(pw) -> tuple[int, int, str]:
    """(rows, device bytes of its tensors, sha256 of its sorted keys) of
    the graph's index."""
    import hashlib

    from pathway_tpu_torch.engine.operators.external_index import ExternalIndexNode

    node = next(n for n in pw.G.engine_graph.nodes if isinstance(n, ExternalIndexNode))
    idx = node._index
    keys = np.sort(np.asarray(idx._keys, dtype=np.uint64))
    nbytes = sum(t.numel() * t.element_size() for t in (idx._corpus, idx._valid))
    return len(idx), nbytes, hashlib.sha256(keys.tobytes()).hexdigest()


def p22_sync() -> None:
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def p22_run(pw, cfg) -> tuple[float, int, dict]:
    """One run: (wall s, flash_attn launches, the run's persistence stats)."""
    from pathway_tpu_torch.internals import run as run_mod
    from pathway_tpu_torch.models import flash_attention as FA

    FA.flash_attn.launches = 0
    p22_sync()
    t0 = time.perf_counter()
    pw.run(persistence_config=cfg)
    p22_sync()
    wall = time.perf_counter() - t0
    return wall, FA.flash_attn.launches, dict(run_mod.LAST_PERSISTENCE_STATS or {})


def p22_store_bytes(store: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(store) for f in fs)


def p22_cfg(pw, store: str, mode: str = "persisting"):
    return pw.persistence.Config(backend=pw.persistence.Backend.filesystem(store),
                                 persistence_mode=mode)


def p22_check_ids(out: str, n: int, what: str) -> None:
    ids = p22_ids(out)
    require(ids == {d: 1 for d in range(n)}, f"{what}: each of docs 0-{n - 1} once in the sink "
            f"({len(ids)} live, {sum(1 for c in ids.values() if c != 1)} not once)")


def p22_check_top(ref: dict, got: dict, what: str) -> None:
    require(sorted(got) == sorted(ref) and len(ref) > 0
            and all(len(r) == P22_K for r in got.values()),
            f"{what}: each query answered once with {P22_K} docs")
    agree = sum(ranks_agree(ref[q], got[q], P22_SCORE_TOL) for q in got)
    require(agree == len(got), f"{what}: top-{P22_K} equal the uninterrupted arm's but at score "
                               f"gaps < {P22_SCORE_TOL} ({agree}/{len(got)})")


def p22_line(gpu: str, arm: str, runs: list, store: str) -> str:
    return (f"persistence ({arm}) [{gpu}]: " + "; ".join(
        f"{name} wall {w:.3f} s, flash_attn {fl}, replayed rows {st.get('replayed_rows', 0)}, "
        f"replay {st.get('replay_s', 0.0):.4f} s, restored operators "
        f"{st.get('restored_operators', 0)}, written {st.get('snapshot_bytes', 0)} log + "
        f"{st.get('operator_state_bytes', 0)} operator bytes" for name, w, fl, st in runs)
        + f"; store {p22_store_bytes(store)} bytes")


def p22_persisting(pw, llm, model, spec: dict, gpu: str) -> tuple[int, dict]:
    """(a), then the uninterrupted arm every arm is held against (the same
    files, a fresh store); returns (flash_attn launches, its replies)."""
    tmp = spec["tmp"]
    emb = llm.SentenceTransformerEmbedder(model, max_batch_size=RAG_BATCH, deferred=True,
                                          dedup=False)
    d = p22_stage(spec, "a", 4)
    runs, ix = [], {}
    for name, upto, store in (("run 1", 4, "store"), ("run 2", P22_FILES, "store"),
                              ("uninterrupted", P22_FILES, "store-whole")):
        p22_stage(spec, "a", upto)
        pw.clear_graph()
        out = os.path.join(tmp, "a", name.replace(" ", ""))
        p22_program(pw, emb, spec, d, out)
        wall, fl, st = p22_run(pw, p22_cfg(pw, os.path.join(tmp, "a", store)))
        runs.append((name, wall, fl, st))
        ix[name] = p22_index(pw)
        p22_check_ids(out, spec["per_file"] * upto, f"(a) {name}")
    pw.clear_graph()
    ref = p22_replies(os.path.join(tmp, "a", "uninterrupted"))
    got, whole = ix["run 2"], ix["uninterrupted"]
    require(got[0] == spec["n_docs"] and got == whole, f"(a): the resumed index holds {got[0]} rows, "
            f"{got[1]} device bytes, keys {got[2][:12]}; the uninterrupted one {whole[0]}, "
            f"{whole[1]}, {whole[2][:12]}")
    p22_check_top(ref, p22_replies(os.path.join(tmp, "a", "run2")), "(a)")
    require(runs[1][3]["replayed_rows"] == spec["n_docs"] // 2 + spec["n_q"],
            f"(a) run 2 replayed {runs[1][3]['replayed_rows']} rows")
    if spec["device"] != "cpu":
        need = MINILM_LAYERS * (spec["n_docs"] // RAG_BATCH)
        require(runs[1][2] >= need, f"(a) run 2's flash_attn launches {runs[1][2]} cover the "
                                    f"replayed and new rows ({need})")
    info(p22_line(gpu, "a", runs, os.path.join(tmp, "a", "store"))
         + f"; index rows {got[0]}, index device bytes {got[1]} (uninterrupted {whole[1]})")
    return sum(r[2] for r in runs), ref


def p22_udf_caching(pw, llm, model, spec: dict, ref: dict, gpu: str) -> int:
    """(c); returns its flash_attn launches."""
    from pathway_tpu_torch.models import flash_attention as FA

    tmp = spec["tmp"]
    emb = llm.SentenceTransformerEmbedder(model, max_batch_size=RAG_BATCH, deferred=True,
                                          dedup=False)
    d = p22_stage(spec, "c", 4)
    store = os.path.join(tmp, "c", "store")
    runs, seen = [], []
    for run, upto in ((1, 4), (2, P22_FILES)):
        p22_stage(spec, "c", upto)
        pw.clear_graph()
        seen.append({})
        p22_program(pw, emb, spec, d, os.path.join(tmp, "c", f"run{run}"), vecs_seen=seen[-1])
        enc = EncodeCount(model)
        try:
            wall, fl, st = p22_run(pw, p22_cfg(pw, store, "udf_caching"))
        finally:
            enc.close()
        runs.append((f"run {run}", wall, fl, st, enc.batches))
    pw.clear_graph()
    p22_check_ids(os.path.join(tmp, "c", "run2"), spec["n_docs"], "(c) run 2")
    p22_check_top(ref, p22_replies(os.path.join(tmp, "c", "run2")), "(c)")
    import csv

    missed = [t for b in runs[1][4] for t in b]
    new_texts = set()
    for path in spec["files"][P22_FILES // 2:]:
        with open(path, newline="") as fh:
            new_texts.update(r["text"] for r in csv.DictReader(fh))
    require(len(missed) == spec["n_docs"] // 2 + spec["n_q"]
            and sum(t in new_texts for t in missed) == spec["n_docs"] // 2,
            f"(c) run 2 encoded {len(missed)} rows: files 5-8's and the queries' only")
    require(all(seen[1][i] == seen[0][i] for i in range(spec["n_docs"] // 2)),
            "(c) the replayed rows' vectors (DiskCache hits) byte-equal to run 1's")
    # the same batches straight through the model: files 5-8's (and the
    # queries') alone
    FA.flash_attn.launches = 0
    model.embed_resolve([model.embed_submit(b) for b in runs[1][4]], P22_TIMEOUT)
    p22_sync()
    direct = FA.flash_attn.launches
    require(runs[1][2] == direct, f"(c) run 2's flash_attn launches {runs[1][2]} equal its "
                                  f"missed batches' alone ({direct})")
    info(p22_line(gpu, "c", [r[:4] for r in runs], store)
         + f"; run 2 encoded batches {[len(b) for b in runs[1][4]]}")
    return sum(r[2] for r in runs)


def p22_tensor_udf(pw, model):
    """The embed UDF of (d): a batch's vectors as CUDA tensors, straight
    from the encoder, one row each. Not deterministic, so its operator
    keeps each row's value in its replay cache (operator state)."""
    @pw.udf(batch=True, deterministic=False, max_batch_size=RAG_BATCH)
    def embed_t(texts: list[str]) -> list[object]:
        out, n = model.embed_device(list(texts))
        return list(out[:n].unbind(0))

    return embed_t


def p22_groups_program(pw, udf, spec: dict, docs_dir: str, out: str) -> None:
    """(d) without the index: the docs -> ``udf`` -> by file: the count
    and the sums of each vector's first component and of its magnitude."""
    DocSchema, _ = mp_doc_schemas(pw)
    per = spec["per_file"]
    docs = pw.io.csv.read(docs_dir, schema=DocSchema, mode="static", persistent_id="docs")
    vecs = docs.select(docs.doc, vec=udf(docs.text))
    firsts = vecs.select(file=pw.apply_with_type(lambda d: d // per, int, vecs.doc),
                         v0=pw.apply_with_type(lambda v: float(v[0]), float, vecs.vec))
    firsts = firsts.select(firsts.file, firsts.v0,
                           a0=pw.apply_with_type(abs, float, firsts.v0))
    groups = firsts.groupby(firsts.file).reduce(
        firsts.file, n=pw.reducers.count(), s=pw.reducers.sum(firsts.v0),
        a=pw.reducers.sum(firsts.a0))
    pw.io.jsonlines.write(groups, out + "-groups.jsonl")


def p22_groups(*outs: str) -> dict:
    """{file: (n, s, a)} folded over the sinks of ``outs`` in order."""
    rows = [r for o in outs for r in p22_read(o + "-groups.jsonl")]
    return {k[0]: v for k, v in mp_fold(rows, ("file",), ("n", "s", "a")).items()}


def p22_operator_persisting(pw, llm, model, spec: dict, ref: dict, gpu: str) -> int:
    """(d); returns its flash_attn launches."""
    from pathway_tpu_torch.engine.operators.core import RowwiseNode

    tmp = spec["tmp"]
    udf = p22_tensor_udf(pw, model)
    d = p22_stage(spec, "d", 4)
    runs, encoded, cache = [], [], None
    for name, upto, store in (("run 1", 4, "store"), ("run 2", P22_FILES, "store"),
                              ("uninterrupted", P22_FILES, "store-whole")):
        p22_stage(spec, "d", upto)
        pw.clear_graph()
        p22_groups_program(pw, udf, spec, d, os.path.join(tmp, "d", name.replace(" ", "")))
        rowwise = [n for n in pw.G.engine_graph.nodes
                   if isinstance(n, RowwiseNode) and n.is_stateful()]
        rows = []
        real = model.embed_device

        def counted(texts, _real=real):
            rows.append(len(texts))
            return _real(texts)

        model.embed_device = counted
        try:
            wall, fl, st = p22_run(pw, p22_cfg(pw, os.path.join(tmp, "d", store),
                                               "operator_persisting"))
        finally:
            del model.embed_device
        runs.append((name, wall, fl, st))
        encoded.append(sum(rows))
        if name == "run 2":
            require(len(rowwise) == 1, "(d): one stateful rowwise operator (the embed UDF's)")
            cache = rowwise[0]._replay_cache
    pw.clear_graph()
    require(runs[1][3]["restored_operators"] >= 2,
            f"(d) run 2 restored {runs[1][3]['restored_operators']} operators")
    vals = [e[1]["vec"] for e in cache.values()]
    dev = model.device
    require(len(vals) == spec["n_docs"] and all(v.device == dev for v in vals),
            f"(d) run 2's replay cache holds {len(vals)} rows, every one a tensor on {dev}")
    require(encoded[1] == spec["n_docs"] // 2,
            f"(d) run 2 encoded {encoded[1]} rows: files 5-8 only")
    got = p22_groups(os.path.join(tmp, "d", "run1"), os.path.join(tmp, "d", "run2"))
    want = p22_groups(os.path.join(tmp, "d", "uninterrupted"))
    require(sorted(got) == sorted(want) == list(range(P22_FILES)) and all(
        got[f][0] == want[f][0] == spec["per_file"]
        and abs(got[f][1] - want[f][1]) <= P22_SUM_TOL * want[f][2] for f in want),
        f"(d) the resumed groups equal the uninterrupted run's within {P22_SUM_TOL} of the "
        f"sum of magnitudes: {got} vs {want}")
    worst = max(abs(got[f][1] - want[f][1]) / want[f][2] for f in want)
    info(p22_line(gpu, "d", runs, os.path.join(tmp, "d", "store"))
         + f"; encoded rows {encoded}; worst group sum gap / sum of magnitudes {worst:.3e}")
    # (d) with the index: the index keeps no snapshot, so run 2 replays its
    # inputs (with JAX's warning) and answers as (a) does
    emb = llm.SentenceTransformerEmbedder(model, max_batch_size=RAG_BATCH, deferred=True,
                                          dedup=False)
    d = p22_stage(spec, "d-index", 4)
    runs_ix = []
    for run, upto in ((1, 4), (2, P22_FILES)):
        p22_stage(spec, "d-index", upto)
        pw.clear_graph()
        p22_program(pw, emb, spec, d, os.path.join(tmp, "d-index", f"run{run}"))
        wall, fl, st = p22_run(pw, p22_cfg(pw, os.path.join(tmp, "d-index", "store"),
                                           "operator_persisting"))
        runs_ix.append((f"run {run}", wall, fl, st))
    pw.clear_graph()
    require(runs_ix[1][3]["restored_operators"] == 0, "(d) with the index: no operator restored")
    p22_check_ids(os.path.join(tmp, "d-index", "run2"), spec["n_docs"],
                  "(d) with the index, run 2")
    p22_check_top(ref, p22_replies(os.path.join(tmp, "d-index", "run2")), "(d) with the index")
    info(p22_line(gpu, "d with the index", runs_ix, os.path.join(tmp, "d-index", "store")))
    return sum(r[2] for r in runs) + sum(r[2] for r in runs_ix)


def p22_child(spec_path: str) -> int:
    """(b)'s child: (a)'s program streaming until the stop marker exists,
    then one more pass; writes its results as JSON to ``spec["result"]``."""
    import threading

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.xpacks import llm

    with open(spec_path) as fh:
        spec = json.load(fh)
    if spec["device"].startswith("cuda"):
        mp_load_kernels()
    model = mp_model(spec)
    emb = llm.SentenceTransformerEmbedder(model, max_batch_size=spec["batch"], deferred=True,
                                          dedup=False)
    for b in (64, 128, 256, 512, 1024):  # the pow2 batch buckets
        if b <= spec["batch"]:
            model.embed_batch([f"warm {i}" for i in range(b)])
    pw.clear_graph()
    p22_program(pw, emb, spec, spec["docs_dir"], spec["out"], mode="streaming")
    conns = list(pw.G.connectors)

    def stopper():
        while not os.path.exists(spec["stop"]):
            time.sleep(0.05)
        for c in conns:
            c._stop.set()  # the reader ends its pass, then closes

    threading.Thread(target=stopper, daemon=True).start()
    wall, fl, st = p22_run(pw, p22_cfg(pw, spec["store"]))
    out = {"wall_s": wall, "flash_attn": fl, "stats": st, "index": p22_index(pw)}
    pw.clear_graph()
    emb.close()
    p22_sync()
    tmp = spec["result"] + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(out, fh)
    os.replace(tmp, spec["result"])
    return 0


def p22_sigkill(spec: dict, ref: dict, gpu: str) -> int:
    """(b); returns the restarted child's flash_attn launches."""
    tmp = os.path.join(spec["tmp"], "b")
    d = p22_stage(spec, "b", 4)
    base = dict(spec, docs_dir=d, store=os.path.join(tmp, "store"), stop=os.path.join(tmp, "stop"))

    def child(tag: str):
        sp = dict(base, out=os.path.join(tmp, tag), result=os.path.join(tmp, f"{tag}.json"))
        path = os.path.join(tmp, f"{tag}-spec.json")
        with open(path, "w") as fh:
            json.dump(sp, fh)
        log = open(os.path.join(tmp, f"{tag}.log"), "w")
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--phase22-child",
                                 path], stdout=log, stderr=subprocess.STDOUT, cwd=tmp)
        return proc, log, sp

    def tail(tag: str) -> str:
        with open(os.path.join(tmp, f"{tag}.log")) as fh:
            return fh.read()[-4000:]

    t0 = time.perf_counter()
    proc, log, sp = child("child1")
    try:
        deadline = time.monotonic() + P22_TIMEOUT
        ids = sp["out"] + "-ids.jsonl"
        while time.monotonic() < deadline and proc.poll() is None and not (
                os.path.exists(ids) and p22_read(ids)):
            time.sleep(0.05)
        if proc.poll() is not None or not (os.path.exists(ids) and p22_read(ids)):
            raise AssertionError(f"(b) child 1 put no row in its sink:\n{tail('child1')}")
        at_kill = len(p22_read(ids))
        proc.kill()  # SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(30)
        log.close()
    p22_stage(spec, "b", P22_FILES)
    open(base["stop"], "w").close()
    proc, log, sp = child("child2")
    try:
        proc.wait(timeout=P22_TIMEOUT)
    except subprocess.TimeoutExpired:
        pass
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        log.close()
    if proc.returncode != 0:
        raise AssertionError(f"(b) the restarted child exited {proc.returncode}:\n"
                             f"{tail('child2')}")
    with open(sp["result"]) as fh:
        res = json.load(fh)
    p22_check_ids(sp["out"], spec["n_docs"], "(b) the restarted child")
    p22_check_top(ref, p22_replies(sp["out"]), "(b)")
    require(res["index"][0] == spec["n_docs"], f"(b) the restarted child's index holds "
                                         f"{res['index'][0]} rows")
    st = res["stats"]
    info(f"persistence (b) [{gpu}]: child 1 killed with {at_kill} rows in its sink; the restart "
         f"wall {res['wall_s']:.3f} s, flash_attn {res['flash_attn']}, replayed rows "
         f"{st.get('replayed_rows', 0)}, replay {st.get('replay_s', 0.0):.4f} s; store "
         f"{p22_store_bytes(base['store'])} bytes; {time.perf_counter() - t0:.1f} s with both "
         f"children's start-up")
    return res["flash_attn"]


def p22_arms(pw, llm, model, spec: dict, gpu: str) -> dict:
    """Phase 22's four arms in their order; {arm: flash_attn launches}."""
    launches = {}
    launches["a"], ref = p22_persisting(pw, llm, model, spec, gpu)
    launches["b"] = p22_sigkill(spec, ref, gpu)
    launches["c"] = p22_udf_caching(pw, llm, model, spec, ref, gpu)
    launches["d"] = p22_operator_persisting(pw, llm, model, spec, ref, gpu)
    return launches


def run_persistence(gpu: str, out: dict, docs, queries) -> int:
    """Phase 22 on the card; returns its flash_attn launches (the restarted
    child's included)."""
    import tempfile

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.models.transformer import MINILM_L6
    from pathway_tpu_torch.xpacks import llm

    t22 = time.perf_counter()
    torch.cuda.empty_cache()
    model = out["emb"]
    model.embed_batch(docs[:RAG_BATCH])  # warm the batch bucket, outside the counts
    with tempfile.TemporaryDirectory() as tmp:
        spec = p22_setup(tmp, docs[:P22_DOCS], queries)
        spec.update(dim=MINILM_L6.hidden, device="cuda:0", model="minilm")
        launches = p22_arms(pw, llm, model, spec, gpu)
    require(all(v > 0 for v in launches.values()), "phase 22: every arm ran flash_attn")
    info(f"persistence: phase 22 flash_attn launches {launches}; "
         f"{time.perf_counter() - t22:.1f} s")
    return sum(launches.values())


# ---------------------------------------------------------------- phase 23
# a CDC-fed index shared through an export, over phase 4's MiniLM-L6 (bf16,
# seeded). Program A: pw.io.debezium over the in-process broker (topic
# docs, primary key doc_id) carries P23_DBZ creates, then, while the run
# streams, P23_UPD updates rewriting a doc's text and P23_DEL deletes in a
# seeded order, in commits of P23_CHUNK; pw.io.sqlite.read(mode="streaming")
# reads a sqlite3 file holding the next P23_SQL docs, and after its first
# poll a writer commits P23_SQL_UPD updates and P23_SQL_DEL deletes. Both go
# through the deferred embed UDF (flash_attn) into pw.export_table and
# pw.io.postgres.write_snapshot of (doc_id, source) over a sqlite3
# connection factory. A consistent_handoff() is taken once P23_HANDOFF_AT
# rows are in. Program B, a fresh graph once A ended: pw.import_table(follow=
# True) into a brute-force DataIndex on the card, phase 4's 64 queries one
# at a time through pw.io.python. The texts of updates come from the corpus
# past the docs read.
P23_DBZ, P23_SQL, P23_UPD, P23_DEL, P23_SQL_UPD, P23_SQL_DEL = 16384, 4096, 2048, 1024, 512, 256
P23_CHUNK, P23_HANDOFF_AT, P23_K, P23_BATCH = 512, 4096, 10, 1024
P23_COS_MIN, P23_TIE_TOL, P23_SCORE_TOL = 0.9999, 1e-3, 2e-2
# B's replies against a host model of the bf16 index on B's own inputs: the
# card and the host may normalise a query a last f32 place apart, which can
# flip one bf16 rounding, one bf16 ulp of a query cell (2^-12 at 0.05) times
# a corpus cell (<= 0.2): 5e-5 at most. Summation order alone moves ~1e-7.
P23_SIM_TOL = 5e-5
P23_TENSOR_ROWS = 3500  # updated tensor rows: 10,500 history entries, past compaction
P23_TIMEOUT = 300.0  # a bound on each wait of the phase


def p23_spec(**kw) -> dict:
    spec = {"dbz": P23_DBZ, "sql": P23_SQL, "upd": P23_UPD, "del": P23_DEL,
            "sql_upd": P23_SQL_UPD, "sql_del": P23_SQL_DEL, "chunk": P23_CHUNK,
            "handoff_at": P23_HANDOFF_AT, "k": P23_K, "batch": P23_BATCH, "knn": {},
            "tensor_rows": P23_TENSOR_ROWS, "timeout": P23_TIMEOUT}
    spec.update(kw)
    return spec


def p23_envelope(op: str, before=None, after=None) -> bytes:
    return json.dumps({"payload": {"op": op, "before": before, "after": after}}).encode()


def p23_plan(spec: dict, docs: list[str], seed: int = 23) -> dict:
    """The changes of the phase and a plain-Python model of their end: the
    create envelopes, the later ones (updates and deletes in a seeded
    order), the sqlite rows and the writer's statements, and the final
    ``{doc_id: (text, source)}``."""
    rng = np.random.default_rng(seed)
    n_dbz, n_sql = spec["dbz"], spec["sql"]
    state = {i: (docs[i], "debezium") for i in range(n_dbz)}
    sql_rows = [(n_dbz + j, docs[n_dbz + j], "sqlite") for j in range(n_sql)]
    state.update({i: (t, s) for i, t, s in sql_rows})
    creates = [p23_envelope("c", after={"doc_id": i, "text": state[i][0], "source": "debezium"})
               for i in range(n_dbz)]
    pick = rng.permutation(n_dbz)
    base = n_dbz + n_sql
    ops = [("u", int(i), docs[base + j]) for j, i in enumerate(pick[:spec["upd"]])]
    ops += [("d", int(i), None) for i in pick[spec["upd"]:spec["upd"] + spec["del"]]]
    changes = []
    for o in rng.permutation(len(ops)):
        op, i, text = ops[o]
        before = {"doc_id": i, "text": state[i][0], "source": "debezium"}
        if op == "u":
            changes.append(p23_envelope("u", before, dict(before, text=text)))
            state[i] = (text, "debezium")
        else:
            changes.append(p23_envelope("d", before))
            del state[i]
    spick = n_dbz + rng.permutation(n_sql)
    sbase = base + spec["upd"]
    sql_upd = [(docs[sbase + j], int(i)) for j, i in enumerate(spick[:spec["sql_upd"]])]
    sql_del = [(int(i),) for i in spick[spec["sql_upd"]:spec["sql_upd"] + spec["sql_del"]]]
    for text, i in sql_upd:
        state[i] = (text, "sqlite")
    for (i,) in sql_del:
        del state[i]
    return {"creates": creates, "changes": changes, "sql_rows": sql_rows,
            "sql_upd": sql_upd, "sql_del": sql_del, "final": state,
            "n_events": n_dbz + len(changes) + n_sql + len(sql_upd) + len(sql_del)}


def p23_doc_schema(pw):
    class DocSchema(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        text: str
        source: str

    return DocSchema


def p23_program_a(pw, llm, model, spec: dict, plan: dict, tmp: str) -> dict:
    """Program A (see above): runs it to its end and returns the export,
    the handoff taken mid-stream with its queued updates, the sink's path,
    the wall and the encodes."""
    import sqlite3
    import threading

    from pathway_tpu_torch.internals.exported import _FINISHED
    from pathway_tpu_torch.io.kafka import InMemoryKafkaBroker

    db, sink = os.path.join(tmp, "docs.db"), os.path.join(tmp, "sink.db")
    with sqlite3.connect(db) as c:
        c.execute("CREATE TABLE docs (doc_id INTEGER PRIMARY KEY, text TEXT, source TEXT)")
        c.executemany("INSERT INTO docs VALUES (?, ?, ?)", plan["sql_rows"])
    with sqlite3.connect(sink) as c:
        # keyed as a Postgres table behind write_snapshot would be
        c.execute("CREATE TABLE live (doc_id INTEGER PRIMARY KEY, source TEXT)")
    pw.clear_graph()
    broker = InMemoryKafkaBroker()
    for p in plan["creates"]:
        broker.produce("docs", p)
    schema = p23_doc_schema(pw)
    emb = llm.SentenceTransformerEmbedder(model, max_batch_size=spec["batch"], deferred=True)
    dbz = pw.io.debezium.read(broker, "docs", schema=schema)
    sql = pw.io.sqlite.read(db, "docs", schema, mode="streaming")
    docs_t = dbz.concat(sql)
    vecs = docs_t.select(docs_t.doc_id, docs_t.text, docs_t.source, vec=emb(docs_t.text))
    exported = pw.export_table(vecs)
    pw.io.postgres.write_snapshot(vecs.select(vecs.doc_id, vecs.source), table_name="live",
                                  primary_key=["doc_id"],
                                  connection_factory=lambda: sqlite3.connect(sink))
    # the live {doc_id: text}, applied an epoch at a time, retractions first
    live, pending, lock = {}, [], threading.Lock()
    counts = {"rows": 0, "sqlite": 0}

    def on_change(key, row, time, is_addition):
        pending.append((row["doc_id"], row["text"], row["source"], is_addition))

    def on_time_end(time):
        with lock:
            for d, t, _s, add in pending:
                if not add and live.get(d) == t:
                    del live[d]
            for d, t, s, add in pending:
                if add:
                    live[d] = t
                    counts["rows"] += 1
                    counts["sqlite"] += s == "sqlite"
            pending.clear()

    pw.io.subscribe(vecs, on_change=on_change, on_time_end=on_time_end)
    conns = list(pw.G.connectors)
    poller = next(c for c in conns if type(c).__name__ == "_SqliteConnector")
    want = {i: t for i, (t, _s) in plan["final"].items()}
    got: dict = {}

    def feed():
        deadline = time.time() + spec["timeout"]

        def wait(cond, what):
            while True:
                with lock:
                    if cond():
                        return
                if time.time() > deadline:
                    raise TimeoutError(f"phase 23: {what}")
                time.sleep(0.005)

        try:
            wait(lambda: counts["rows"] >= spec["handoff_at"], "the handoff's rows")
            got["handoff"] = exported.consistent_handoff()
            got["handoff_rows_seen"] = counts["rows"]
            wait(lambda: counts["sqlite"] >= spec["sql"], "the sqlite reader's first poll")
            with sqlite3.connect(db) as c:
                c.executemany("UPDATE docs SET text = ? WHERE doc_id = ?", plan["sql_upd"])
                c.executemany("DELETE FROM docs WHERE doc_id = ?", plan["sql_del"])
            # the later envelopes in commits of spec["chunk"], each produced
            # once the reader took the one before
            reader = next(c for c in conns if type(c).__name__ == "_DebeziumConnector")
            n0 = len(plan["creates"])
            wait(lambda: reader._offset >= n0, "the creates read")
            changes = plan["changes"]
            for s in range(0, len(changes), spec["chunk"]):
                for p in changes[s : s + spec["chunk"]]:
                    broker.produce("docs", p)
                end = n0 + min(s + spec["chunk"], len(changes))
                wait(lambda end=end: reader._offset >= end, "the reader's pace")
            broker.close()  # the Debezium reader drains the log and ends
            wait(lambda: live == want, "A's live rows equal the model's")
        except BaseException as exc:  # noqa: BLE001 - raised after the run
            got["error"] = exc
            broker.close()
            for c in conns:
                c._stop.set()
        finally:
            poller._stop.set()  # the sqlite reader ends its pass and closes

    counter = EncodeCount(model)
    feeder = threading.Thread(target=feed, daemon=True)
    t0 = time.perf_counter()
    feeder.start()
    pw.run()
    wall = time.perf_counter() - t0
    feeder.join(spec["timeout"])
    counter.close()
    if "error" in got:
        raise got["error"]
    frontier, h_rows, q = got["handoff"]
    queued = []
    while True:
        item = q.get(timeout=spec["timeout"])
        if item is _FINISHED:
            break
        queued.append(item)
    return {"exported": exported, "handoff": (frontier, h_rows, queued),
            "handoff_rows_seen": got["handoff_rows_seen"], "sink": sink, "wall_s": wall,
            "encodes": list(counter.sizes)}


def p23_check_a(a: dict, plan: dict, model, spec: dict) -> dict:
    """A's bars: the final export against the model and direct encodes, the
    handoff plus its queued updates against the final export, compaction,
    the Postgres sink. Returns the final rows by doc id."""
    import sqlite3
    from collections import Counter

    from pathway_tpu_torch.engine.value import hash_values
    from pathway_tpu_torch.persistence.snapshot import row_identities

    exported, final = a["exported"], plan["final"]
    snap = exported.snapshot_at(exported.frontier())
    n_want = spec["dbz"] - spec["del"] + spec["sql"] - spec["sql_del"]
    require(len(final) == n_want and len(snap) == n_want,
            f"phase 23: A's final export holds {n_want} rows ({len(snap)})")
    rows = {}
    for key, (doc_id, text, source, vec) in snap:
        rows[doc_id] = (key, text, source, np.asarray(vec, dtype=np.float32),
                        np.asarray(vec).tobytes())
    require(len(rows) == len(snap) and set(rows) == set(final),
            "phase 23: the export's docs are the model's, each live once")
    require(all(k == hash_values(d) and (t, s) == final[d]
                for d, (k, t, s, _v, _b) in rows.items()),
            "phase 23: every exported row has the model's key and final text (no retracted "
            "or pre-update row)")
    ids = sorted(rows)
    texts = [final[d][0] for d in ids]
    direct = np.concatenate([model.embed_batch(texts[s : s + spec["batch"]])
                             for s in range(0, len(texts), spec["batch"])]).astype(np.float32)
    got = np.stack([rows[d][3] for d in ids])
    cos = np.sum(got * direct, axis=1) / (np.linalg.norm(got, axis=1)
                                          * np.linalg.norm(direct, axis=1))
    require(cos.min() >= P23_COS_MIN,
            f"phase 23: exported vectors within cosine {P23_COS_MIN} of direct encodes "
            f"(min {cos.min():.6f})")
    frontier, h_rows, queued = a["handoff"]
    require(a["handoff_rows_seen"] >= spec["handoff_at"] and frontier < exported.frontier(),
            "phase 23: the handoff was taken mid-stream")
    rid = row_identities([r for _k, r in h_rows] + [r for _t, _k, r, _d in queued]
                         + [r for _k, r in snap])
    net: Counter = Counter()
    for (k, _r), i in zip(h_rows, rid):
        net[(k, i)] += 1
    for (_t, k, _r, d), i in zip(queued, rid[len(h_rows):]):
        net[(k, i)] += d
    net = Counter({kr: n for kr, n in net.items() if n})
    final_ids = Counter((k, i) for (k, _r), i in zip(snap, rid[len(h_rows) + len(queued):]))
    require(net == final_ids, "phase 23: the handoff's snapshot plus its queued updates equal "
            "the final export by cell bytes")
    require(exported.compactions >= 1, "phase 23: the export compacted its history")
    with sqlite3.connect(a["sink"]) as c:
        sink_rows = sorted(c.execute("SELECT doc_id, source FROM live").fetchall())
    require(sink_rows == sorted((d, s) for d, (_t, s) in final.items()),
            "phase 23: the Postgres snapshot sink equals the model's live set")
    return {"rows": rows, "ids": ids, "direct": direct, "cos_min": float(cos.min()),
            "handoff_frontier": frontier, "handoff_rows": len(h_rows),
            "handoff_queued": len(queued), "final_frontier": exported.frontier(),
            "history": len(exported._history), "compactions": exported.compactions}


def p23_program_b(pw, llm, model, spec: dict, exported, queries: list[str], n_rows: int) -> dict:
    """Program B: the import into a brute-force DataIndex, then the queries
    one at a time once every row is in. Returns the imported rows, the
    replies by query, the import's wall and each query's latency."""
    import threading

    pw.clear_graph()
    qemb = llm.SentenceTransformerEmbedder(model, max_batch_size=spec["batch"], deferred=False)
    imported = pw.import_table(exported)
    index = pw.indexing.DataIndex(imported, pw.indexing.BruteForceKnn(
        imported.vec, dimensions=model.cfg.hidden, reserved_space=n_rows + 512, metric="cos",
        **spec["knn"]))
    ready = threading.Event()
    answered = [threading.Event() for _ in queries]
    state = {"rows": {}, "replies": {}, "lat": {}, "sent": {}, "qvecs": {}, "import_s": None}
    lock = threading.Lock()

    class QuerySchema(pw.Schema):
        qid: int
        text: str

    class Queries(pw.io.python.ConnectorSubject):
        def run(self):
            if not ready.wait(spec["timeout"]):
                raise TimeoutError("phase 23: the import never completed")
            for i, q in enumerate(queries):
                state["sent"][i] = time.perf_counter()
                self.next(qid=i, text=q)
                self.commit()
                if not answered[i].wait(spec["timeout"]):
                    raise TimeoutError(f"phase 23: query {i} was not answered")

    qt = pw.io.python.read(Queries(), schema=QuerySchema)
    qv = qt.select(qt.qid, qv=qemb(qt.text))
    res = index.query_as_of_now(qv.qv, number_of_matches=spec["k"], with_distances=True)
    res = res.select(res.doc_id, res._pw_dist, qid=qv.restrict(res).qid)

    now = time.perf_counter

    def on_row(key, row, time, is_addition):
        with lock:
            if is_addition:
                state["rows"][key.value] = (row["doc_id"], np.asarray(row["vec"]).tobytes())
            else:
                state["rows"].pop(key.value, None)
            if len(state["rows"]) >= n_rows and not ready.is_set():
                state["import_s"] = now() - t0
                ready.set()

    def on_reply(key, row, time, is_addition):
        if is_addition:
            i = row["qid"]
            state["lat"][i] = now() - state["sent"][i]
            state["replies"][i] = (list(row["doc_id"]), list(row["_pw_dist"]))
            answered[i].set()

    def on_query(key, row, time, is_addition):
        if is_addition:
            state["qvecs"][row["qid"]] = np.asarray(row["qv"], dtype=np.float32)

    pw.io.subscribe(imported, on_change=on_row)
    pw.io.subscribe(qv, on_change=on_query)
    pw.io.subscribe(res, on_change=on_reply)
    counter = EncodeCount(model)
    t0 = now()
    pw.run()
    wall = now() - t0
    counter.close()
    state.update(wall_s=wall, encodes=list(counter.sizes))
    return state


def p23_check_b(b: dict, a_rows: dict, ids: list, direct: np.ndarray, model, spec: dict,
                queries: list[str], final: dict) -> dict:
    """B's bars: the import equal to the final export; every reply equal to
    a direct BruteForceKnnIndex over the final vectors but at gaps under
    P23_TIE_TOL, and to a host model of the bf16 index on B's own inputs
    but at gaps under P23_SIM_TOL; no deleted doc; recall@10 against exact
    f32 scoring no lower than the host model's, which is the most the bf16
    index can reach on these vectors."""
    import torch

    from pathway_tpu_torch import BruteForceKnnIndex

    imported = {k: (d, v) for k, (d, v) in b["rows"].items()}
    require(len(imported) == len(a_rows) and all(
        imported.get(k) == (d, raw) for d, (k, _t, _s, _v, raw) in a_rows.items()),
        "phase 23: B imported the final export (keys, docs and vector bytes)")
    nq, k = len(queries), spec["k"]
    require(sorted(b["replies"]) == list(range(nq)) and sorted(b["qvecs"]) == list(range(nq)),
            f"phase 23: all {nq} queries answered")
    # each query encoded alone, as B's blocking UDF did (a bf16 encode's
    # rounding follows its batch)
    qvecs = np.stack([model.embed_batch([q])[0] for q in queries]).astype(np.float32)
    ref = BruteForceKnnIndex(model.cfg.hidden, reserved_space=len(ids), metric="cos",
                             device=model.device)
    ref.add(ids, direct)
    want = ref.search(qvecs, k)
    pos = {d: j for j, d in enumerate(ids)}
    exact = (qvecs / np.linalg.norm(qvecs, axis=1, keepdims=True)) @ (
        direct / np.linalg.norm(direct, axis=1, keepdims=True)).T
    truth = np.argsort(-exact, axis=1, kind="stable")[:, :k]
    # the host model of the index: B's imported vectors and B's query
    # vectors, unit rows in f32, rounded to bf16, products and sums in f64
    unit = lambda x: x / np.linalg.norm(x, axis=1, keepdims=True)  # noqa: E731
    bf = lambda x: torch.from_numpy(np.ascontiguousarray(x)).bfloat16().double().numpy()  # noqa: E731
    sim = bf(unit(np.stack([b["qvecs"][i] for i in range(nq)]))) @ bf(
        unit(np.stack([a_rows[d][3] for d in ids]))).T
    sim_top = np.argsort(-sim, axis=1, kind="stable")[:, :k]
    agree, sim_agree, hits, host_hits, worst, sim_worst, deleted = 0, 0, 0, 0, 0.0, 0.0, 0
    for i in range(nq):
        docs_i, dists = b["replies"][i]
        deleted += len(set(docs_i) - set(final))
        got = [(d, -s) for d, s in zip(docs_i, dists)]
        agree += ranks_agree(want[i], got, P23_TIE_TOL)
        sim_agree += ranks_agree([(ids[j], float(sim[i, j])) for j in sim_top[i]], got,
                                 P23_SIM_TOL)
        truth_i = {ids[j] for j in truth[i]}
        hits += len(set(docs_i) & truth_i)
        host_hits += len({ids[j] for j in sim_top[i]} & truth_i)
        for d, s in got:
            if d in pos:
                worst = max(worst, abs(float(exact[i, pos[d]]) - s))
                sim_worst = max(sim_worst, abs(float(sim[i, pos[d]]) - s))
    recall, host_recall = hits / (nq * k), host_hits / (nq * k)
    require(deleted == 0, f"phase 23: no reply holds a deleted doc ({deleted})")
    require(agree == nq, f"phase 23: every top-{k} equals the direct index's but at gaps < "
            f"{P23_TIE_TOL} ({agree}/{nq})")
    require(worst <= P23_SCORE_TOL,
            f"phase 23: reply scores are the final vectors' within {P23_SCORE_TOL} ({worst:.2e})")
    require(sim_agree == nq and sim_worst <= P23_SIM_TOL,
            f"phase 23: every top-{k} and its scores equal the host model of the bf16 index "
            f"but at gaps < {P23_SIM_TOL} ({sim_agree}/{nq}, scores {sim_worst:.2e})")
    info(f"  recall@10 against exact f32 scoring {recall:.4f}; the host model of the bf16 "
         f"index {host_recall:.4f}")
    require(hits >= host_hits - 1,
            f"phase 23: recall@10 against exact f32 scoring {recall:.4f} is the host model's "
            f"{host_recall:.4f} but for one near-tie")
    lat = sorted(b["lat"].values())
    return {"recall": recall, "host_recall": host_recall, "agree": agree,
            "sim_agree": sim_agree, "score_diff": worst, "sim_score_diff": sim_worst,
            "p50_ms": 1e3 * float(np.percentile(lat, 50)),
            "p99_ms": 1e3 * float(np.percentile(lat, 99))}


def p23_tensor_cells(pw, dev, n: int, timeout: float) -> dict:
    """An export, an import and a LiveTable of tensor cells on ``dev``: n
    rows at time 2, each updated at time 4 by a retraction holding a
    distinct tensor of the old bytes and an insertion of a new value (3n
    history entries: past 10,000 the export compacts). The snapshot, the
    handoff, the import and the live table must each hold every row once
    at its new value, on ``dev``."""
    import torch

    from pathway_tpu_torch.engine.operators.core import InputNode
    from pathway_tpu_torch.internals.table import Table
    from pathway_tpu_torch.internals.universe import Universe
    from pathway_tpu_torch.io._streams import StaticStreamConnector
    from pathway_tpu_torch.persistence.snapshot import row_identities

    def vec(x):
        return torch.full((8,), float(x), device=dev)

    rows = [(k, (k, vec(k)), 2, 1) for k in range(n)]
    rows += [e for k in range(n) for e in ((k, (k, vec(k)), 4, -1), (k, (k, vec(k + 0.5)), 4, 1))]

    def source():
        node = InputNode(pw.G.engine_graph, ["doc", "vec"], name="tensor-cells")
        pw.G.register_connector(StaticStreamConnector(node, rows, ["doc", "vec"]))
        return Table(node, pw.schema_from_types(doc=int, vec=torch.Tensor), Universe())

    want = [(k, k, [k + 0.5] * 8) for k in range(n)]

    def values(pairs):
        on_dev = all(r[1].device == torch.device(dev) for _k, r in pairs)
        return on_dev, sorted((int(k), r[0], r[1].tolist()) for k, r in pairs)

    pw.clear_graph()
    exported = pw.export_table(source())
    pw.run()
    snap = exported.snapshot_at(exported.frontier())
    _f, h_rows, _q = exported.consistent_handoff()
    require(values(snap) == (True, want) and exported.compactions >= 1,
            f"phase 23: an export of {n} updated tensor rows on {dev} keeps each row once at "
            f"its new value ({exported.compactions} compactions)")
    require(row_identities([r for _k, r in h_rows]) == row_identities([r for _k, r in snap]),
            "phase 23: the tensor export's handoff equals its snapshot")
    pw.clear_graph()
    got = {}
    pw.io.subscribe(pw.import_table(exported), on_change=lambda key, row, time, is_addition:
                    got.__setitem__(key.value, (row["doc"], row["vec"])) if is_addition
                    else got.pop(key.value, None))
    pw.run()
    require(values(list(got.items())) == (True, want),
            "phase 23: the tensor export imports into a second graph")
    pw.clear_graph()
    lt = pw.LiveTable(source())
    require(lt.wait(timeout) and not lt.failed(), "phase 23: a LiveTable of tensor rows ran")
    require(values(list(lt._rows.items())) == (True, want),
            "phase 23: the LiveTable keeps each updated tensor row once at its new value")
    pw.clear_graph()
    return {"tensor_rows": n, "tensor_compactions": exported.compactions}


def p23_phase(pw, llm, model, spec: dict, docs: list[str], queries: list[str], tmp: str,
              gpu: str) -> dict:
    """Phase 23's programs and bars; returns the figures it prints and its
    flash_attn launches with the encodes they must cover."""
    from pathway_tpu_torch.models import flash_attention as FA

    plan = p23_plan(spec, docs)
    model.embed_batch(docs[: spec["batch"]])  # warm the batch bucket, outside the counts
    l0 = FA.flash_attn.launches
    a = p23_program_a(pw, llm, model, spec, plan, tmp)
    la = FA.flash_attn.launches - l0
    ca = p23_check_a(a, plan, model, spec)
    l0 = FA.flash_attn.launches
    b = p23_program_b(pw, llm, model, spec, a["exported"], queries, len(ca["rows"]))
    lb = FA.flash_attn.launches - l0
    cb = p23_check_b(b, ca["rows"], ca["ids"], ca["direct"], model, spec, queries, plan["final"])
    cells = p23_tensor_cells(pw, model.device, spec["tensor_rows"], spec["timeout"])
    pw.clear_graph()
    out = {"launches": la + lb, "encodes": len(a["encodes"]) + len(b["encodes"]),
           "a_rows_per_s": plan["n_events"] / a["wall_s"], "a_wall_s": a["wall_s"],
           "n_events": plan["n_events"], "b_wall_s": b["wall_s"], "import_s": b["import_s"],
           **ca, **cb, **cells}
    for drop in ("rows", "ids", "direct"):
        out.pop(drop)
    info(f"cdc share [{gpu}]: A {plan['n_events']} events (envelopes and sqlite rows) in "
         f"{a['wall_s']:.3f} s, {out['a_rows_per_s']:.1f} rows/s, {len(ca['ids'])} live rows, "
         f"min cosine to direct encodes {ca['cos_min']:.6f}")
    info(f"cdc share [{gpu}]: handoff at frontier {ca['handoff_frontier']} with "
         f"{ca['handoff_rows']} rows + {ca['handoff_queued']} queued updates (final frontier "
         f"{ca['final_frontier']}); compactions {ca['compactions']}, history "
         f"{ca['history']} entries")
    info(f"cdc share [{gpu}]: B import {b['import_s']:.3f} s of a {b['wall_s']:.3f} s run; "
         f"{len(queries)} queries one at a time p50 {cb['p50_ms']:.3f} ms p99 "
         f"{cb['p99_ms']:.3f} ms; recall@10 {cb['recall']:.4f} (host model of the bf16 "
         f"index {cb['host_recall']:.4f}); top-{spec['k']} equal the direct index "
         f"{cb['agree']}/{len(queries)}, the host model {cb['sim_agree']}/{len(queries)} "
         f"(scores within {cb['sim_score_diff']:.2e}); flash_attn launches {la} (A) + {lb} (B) over "
         f"{out['encodes']} encodes")
    return out


def run_cdc_share(gpu: str, out: dict, docs, queries) -> int:
    """Phase 23 on the card; returns its flash_attn launches."""
    import tempfile

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.xpacks import llm

    t23 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        res = p23_phase(pw, llm, out["emb"], p23_spec(), docs, queries, tmp, gpu)
    require(res["launches"] >= MINILM_LAYERS * res["encodes"],
            f"phase 23: every encode went through flash_attn ({res['launches']} >= "
            f"{MINILM_LAYERS} x {res['encodes']})")
    info(f"cdc share: phase 23 flash_attn launches {res['launches']}; "
         f"{time.perf_counter() - t23:.1f} s")
    return res["launches"]


# ---------------------------------------------------------------- phase 24
P24_STEPS, P24_PAIRS, P24_LR = 20, 64, 2e-5        # (a): JAX's learning rate
P24_LM_STEPS, P24_LM_ROWS, P24_LM_SEQ, P24_LM_PAD = 10, 8, 256, 64  # (b)
P24_GATE_CAP, P24_GATE_EVERY, P24_GATE_STOP = 900, 30, 0.21          # (c): the fixture's
P24_GATE_SEQ, P24_GATE_BATCH, P24_GATE_LR, P24_GATE_MIN = 144, 64, 3e-3, 0.6
P24_GATE_TEMPLATE = "context: {context}\nquestion: {query}\nanswer:"
P24_SPAWN_DOCS, P24_TIMEOUT = 4096, 300.0                           # (d)
P24_REL_TOL = 1e-3  # sharded against unsharded losses, bf16 compute


class P24CharTokenizer:
    """``tests/test_rag_eval.py``'s tokenizer: printable ASCII to ids
    1..95, pad 0, no EOS."""

    eos_id = None

    def encode(self, text):
        return [max(1, min(95, ord(c) - 31)) for c in text]

    def decode(self, ids):
        return "".join(chr(int(i) + 31) for i in ids if int(i) > 0)


def p24_threefry(key, counts) -> tuple:
    """JAX's threefry2x32 (20 rounds) of ``key`` over the 64-bit counts
    ``0 .. counts - 1`` (high words 0), in numpy."""
    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

    k = [np.uint32(key[0]), np.uint32(key[1])]
    k.append(k[0] ^ k[1] ^ np.uint32(0x1BD11BDA))
    x = [np.zeros(counts, np.uint32) + k[0], np.arange(counts, dtype=np.uint32) + k[1]]
    for i in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = rotl(x[1], r) ^ x[0]
        x[0] = x[0] + k[(i + 1) % 3]
        x[1] = x[1] + k[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def p24_jax_normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in f32 (threefry bits, JAX's
    uniform on (-1, 1), XLA's single-precision erfinv polynomial): equal to
    JAX's draws within 5e-7 (``log1p`` rounds differently)."""
    b1, b2 = p24_threefry(key, int(np.prod(shape)))
    f = (((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    x = np.maximum(lo, f * (np.float32(1) - lo) + lo)
    w = -np.log1p(-x * x)
    small = w < 5
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3))
    p = np.zeros_like(x)
    for a, b in zip((2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
                    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)):
        p = np.where(small, np.float32(a), np.float32(b)) + p * w
    return (np.float32(np.sqrt(2)) * p * x).astype(np.float32).reshape(shape)


def p24_fixture_params(cfg) -> dict:
    """The gate fixture's initial decoder weights: JAX's
    ``decoder.init_params(jax.random.PRNGKey(0), cfg)`` drawn in numpy
    (the keys of ``jax.random.split(key, 8)``, each leaf's normal times its
    scale), in the port's layout, on the CPU."""
    import torch

    b1, b2 = p24_threefry((0, 0), 8)
    keys = list(zip(b1, b2))
    n, h, i = cfg.layers, cfg.hidden, cfg.intermediate

    def normal(k, shape, scale=0.02):
        return torch.from_numpy(p24_jax_normal(keys[k], shape) * np.float32(scale))

    def const(v, *shape):
        return torch.full(shape, float(v), dtype=torch.float32)

    return {
        "wte": normal(0, (cfg.vocab_size, h)),
        "wpe": normal(1, (cfg.max_position, h), 0.01),
        "layers": {
            "ln1_scale": const(1, n, h), "ln1_bias": const(0, n, h),
            "qkv_w": normal(2, (n, h, 3 * h)), "qkv_b": const(0, n, 3 * h),
            "attn_out_w": normal(3, (n, h, h)), "attn_out_b": const(0, n, h),
            "ln2_scale": const(1, n, h), "ln2_bias": const(0, n, h),
            "mlp_in_w": normal(4, (n, h, i)), "mlp_in_b": const(0, n, i),
            "mlp_out_w": normal(5, (n, i, h)), "mlp_out_b": const(0, n, h),
        },
        "ln_f_scale": const(1, h), "ln_f_bias": const(0, h),
    }


def p24_decoder_view(sample) -> str:
    """What the served decoder sees of a sample (the gate's
    ``_decoder_view``): the template over the doc with its path tag, in the
    chat's user/assistant wrapping."""
    context = f"{sample.doc} (path: {sample.path})"
    rag = P24_GATE_TEMPLATE.format(context=context, query=sample.question)
    return f"user: {rag}\nassistant:"


def p24_step_ms(step, state, batches) -> tuple:
    """``step`` over ``batches`` with a CUDA event pair around each call;
    returns the state, the losses (tensors, read once at the end) and each
    step's device-timeline ms."""
    import torch

    events, losses = [], []
    for batch in batches:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, loss = step(state, batch)
        e1.record()
        events.append((e0, e1))
        losses.append(loss)
    torch.cuda.synchronize()
    return state, [float(v) for v in losses], [a.elapsed_time(b) for a, b in events]


def p24_leaves(params: dict) -> dict:
    """A params tree's leaves by ``group/name`` (the trees are two deep)."""
    return {f"{k}/{k2}" if k2 else k: t for k, v in params.items()
            for k2, t in (v.items() if isinstance(v, dict) else [("", v)])}


def p24_grad_check(loss, params, what: str, unread=()) -> None:
    """Every leaf's gradient finite; non-zero but for the ``unread`` leaves
    (which the objective never reads: zero in JAX too); the attention
    projections non-zero in every layer."""
    import torch

    from pathway_tpu_torch.models import count_params

    flat = p24_leaves(params)
    names, leaves = list(flat), list(flat.values())
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    zero = [n for n, g in zip(names, grads) if not bool(g.abs().max() > 0)]
    layers = params["layers"]["qkv_w"].shape[0]
    attn = {n: g for n, g in zip(names, grads) if n in ("layers/qkv_w", "layers/attn_out_w")}
    per_layer = all(bool(g[i].abs().max() > 0) for g in attn.values() for i in range(layers))
    info(f"  {what}: {len(leaves)} leaves ({count_params(params):,} params), all "
         f"finite {finite}; zero gradients {zero or 'none'} (expected: {list(unread) or 'none'})")
    require(finite and sorted(zero) == sorted(unread) and len(attn) == 2 and per_layer,
            f"{what}: every leaf's gradient finite, non-zero but for the leaves the loss "
            f"never reads, qkv_w and attn_out_w non-zero in every layer")


def p24_sharded(init, make_step, cfg, specs, batch, dp: int, tp: int, dev) -> dict:
    """dp x tp over ``[dev] * 8`` (a tensor a position, as distinct cards
    would hold) against the unsharded step, two steps each from one seed:
    losses, bitwise-equal replicas, shards of their boxes."""
    import torch

    from pathway_tpu_torch.models import train as TT
    from pathway_tpu_torch.models import transformer as TTr
    from pathway_tpu_torch.parallel.mesh import _box, make_mesh, place_pytree

    state, tx = init()
    copy = TTr.map_params(lambda t: t.detach().clone(), state.params)
    plain = TT.TrainState(copy, tx.init(copy), 0)
    pstep = make_step(cfg, tx)
    mesh = make_mesh([dev] * 8, dp=dp, tp=tp)
    params = place_pytree(state.params, mesh, specs, share=False)
    del state
    state = TT.TrainState(params, tx.init(params), 0)
    step = make_step(cfg, tx)
    state, losses, ms = p24_step_ms(step, state, [batch, batch])
    plain, plain_losses, plain_ms = p24_step_ms(pstep, plain, [batch, batch])
    equal = boxed = True
    flat = p24_leaves(params)
    for st in flat.values():
        by_box = {}
        for p in range(mesh.size):
            box = _box(mesh, st.spec, st.global_shape, p)
            shard = st.shards[st.index[p]]
            boxed &= tuple(shard.shape) == tuple(n for _, n in box)
            equal &= bool(torch.equal(by_box.setdefault(box, shard), shard))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    out = {"losses": losses, "plain_losses": plain_losses, "rel": rel, "equal": equal,
           "boxed": boxed, "ms": ms, "plain_ms": plain_ms,
           "positions": len({id(t) for st in flat.values() for t in st.shards})}
    del state, plain, params
    return out


def p24_pairs(docs, tok, lo: int, n: int) -> dict:
    """(query, doc) pairs ``lo .. lo + n`` of the corpus: the query is the
    doc's first half of words; phase 4's tokenizer and buckets."""
    import torch

    from pathway_tpu_torch.models.tokenizer import pad_to_buckets

    texts = docs[lo:lo + n]
    qs = [" ".join(t.split()[: len(t.split()) // 2]) for t in texts]
    out = {}
    for side, xs in (("q", qs), ("d", texts)):
        ids, mask = pad_to_buckets(*tok(xs))
        out[f"{side}_ids"] = torch.from_numpy(ids[:n].astype(np.int64))
        out[f"{side}_mask"] = torch.from_numpy(mask[:n].astype(np.int64))
    return out


def p24_contrastive(dev, gpu: str, docs, queries) -> int:
    """(a); returns its flash_attn launches (the trained-params ingest)."""
    import dataclasses

    import torch

    from pathway_tpu_torch import FusedRAGPipeline, HashTokenizer, SentenceEmbedderModel
    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.models import train as TT
    from pathway_tpu_torch.models import transformer as TTr
    from pathway_tpu_torch.models.tokenizer import pad_to_buckets

    cfg = TTr.MINILM_L6  # bf16 compute, f32 params
    tok = HashTokenizer(max_length=64)

    def to(batch, d=dev):
        return {k: v.to(d) for k, v in batch.items()}

    batches = [to(p24_pairs(docs, tok, i * P24_PAIRS, P24_PAIRS)) for i in range(P24_STEPS)]
    held = to(p24_pairs(docs, tok, P24_STEPS * P24_PAIRS, P24_PAIRS))
    state, tx = TT.init_train_state(0, cfg, learning_rate=P24_LR, device=dev)
    step = TT.make_train_step(cfg, tx)
    with torch.no_grad():
        held0 = float(TT.contrastive_loss(state.params, held, cfg))
    p24_grad_check(TT.contrastive_loss(state.params, batches[0], cfg), state.params,
                   "(a) step 1", unread=("pooler/w", "pooler/b"))
    FA.flash_attn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, losses, ms = p24_step_ms(step, state, batches)
    peak = torch.cuda.max_memory_allocated()
    require(FA.flash_attn.launches == 0, "(a) no flash_attn launch during a step")
    with torch.no_grad():
        held1 = float(TT.contrastive_loss(state.params, held, cfg))
    tokens = sum(int(b["q_mask"].sum()) + int(b["d_mask"].sum()) for b in batches[1:])
    step_ms = statistics.median(ms[1:])
    info(f"(a) contrastive MiniLM-L6 (bf16 compute, f32 params, lr {P24_LR}) [{gpu}]: "
         f"{P24_STEPS} steps of {P24_PAIRS} pairs; step {step_ms:.3f} ms median (CUDA "
         f"events; first {ms[0]:.3f}); {tokens / (sum(ms[1:]) / 1e3):.1f} live tokens/s; "
         f"peak max_memory_allocated {peak / 2**20:.1f} MiB; losses {losses[0]:.4f} -> "
         f"{losses[-1]:.4f}; held batch {held0:.4f} -> {held1:.4f}")
    require(held1 < held0, "(a) the held batch's loss fell over the 20 steps")

    # one f32 step, card against CPU, TF32 off for the check
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        c32 = dataclasses.replace(cfg, dtype=torch.float32)
        small = p24_pairs(docs, tok, 0, 8)
        outs = []
        for d in (dev, "cpu"):
            s, t = TT.init_train_state(0, c32, learning_rate=P24_LR, device=d)
            s, loss = TT.make_train_step(c32, t)(s, to(small, d))
            outs.append((float(loss), [x.detach().cpu() for x in TT.param_leaves(s.params)]))
        (l_card, p_card), (l_cpu, p_cpu) = outs
        diffs = [float((a - b).abs().max()) for a, b in zip(p_card, p_cpu)]
        info(f"  (a) one f32 step card vs CPU (TF32 off) [{gpu}]: loss {l_card:.7f} vs "
             f"{l_cpu:.7f}; "
             f"max param diff {max(diffs):.3e} over {len(diffs)} leaves")
        require(abs(l_card - l_cpu) <= 1e-5 and max(diffs) <= 1e-4,
                "(a) the f32 step on the card equals the CPU's (loss 1e-5, params 1e-4)")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

    sh = p24_sharded(lambda: TT.init_train_state(0, cfg, learning_rate=P24_LR, device=dev),
                     TT.make_train_step, cfg, TTr.param_partition_specs(cfg), batches[0], 4, 2,
                     dev)
    info(f"  (a) dp=4 x tp=2 over [cuda:0] * 8 ({sh['positions']} shard tensors) [{gpu}]: "
         f"losses {sh['losses']} vs unsharded {sh['plain_losses']} (max rel "
         f"{sh['rel']:.2e}); step ms {[round(x, 3) for x in sh['ms']]} vs "
         f"{[round(x, 3) for x in sh['plain_ms']]}; replicas bitwise equal {sh['equal']}")
    require(sh["rel"] <= P24_REL_TOL and sh["losses"][1] < sh["losses"][0] and sh["equal"]
            and sh["boxed"], "(a) the sharded step equals the unsharded one, replicas equal")

    # the trained params served through the flash_attn kernel
    trained = TTr.map_params(lambda t: t.detach(), state.params)
    model = SentenceEmbedderModel(cfg, params=trained, max_length=64, device=dev)
    probe = docs[:64]
    ids, mask = (torch.from_numpy(a.astype(np.int64)).to(dev)
                 for a in pad_to_buckets(*tok(probe)))
    kernel_vecs = model.embed_batch(probe)

    def min_cos(params):
        with torch.no_grad():
            v = TT._embed(params, ids, mask, cfg)[:64].float().cpu().numpy()
        return float(np.min(np.sum(v * kernel_vecs, axis=1) / (
            np.linalg.norm(v, axis=1) * np.linalg.norm(kernel_vecs, axis=1))))

    # the same weights the kernel reads (the embedder stores every leaf in
    # bf16, layernorms included, as JAX's), and the f32 masters
    cos, cos_f32 = min_cos(model.params), min_cos(trained)
    FA.flash_attn.launches = 0
    pipe = FusedRAGPipeline(model, None, reserved_space=len(docs), doc_seq=32)
    keys = [f"k{i}" for i in range(len(docs))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, len(docs), INGEST_BATCH):
        pipe.add(keys[s:s + INGEST_BATCH], docs[s:s + INGEST_BATCH])
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    res = pipe.retrieve(queries, k=TOP_K)
    launches = FA.flash_attn.launches
    corpus_v = np.concatenate([model.embed_batch(docs[s:s + INGEST_BATCH])
                               for s in range(0, len(docs), INGEST_BATCH)])
    q_v = model.embed_batch(queries)
    truth = np.argsort(-(q_v @ corpus_v.T), axis=1, kind="stable")[:, :TOP_K]
    recall = sum(len({int(k[1:]) for k, _ in row} & set(truth[i].tolist()))
                 for i, row in enumerate(res)) / (len(queries) * TOP_K)
    info(f"  (a) trained params through FusedRAGPipeline [{gpu}]: {len(docs)} docs in "
         f"{ingest_s:.3f} s ({len(docs) / ingest_s:.1f} docs/s); flash_attn launches "
         f"{launches}; min cosine over 64 docs of the kernel's embeddings vs the training "
         f"forward's on the served (bf16-stored) weights {cos:.6f}, on the f32 masters "
         f"{cos_f32:.6f}; "
         f"recall@10 against exact f32 scoring {recall:.4f} (no bar; random weights "
         f"gave 0.8922 in phase 23)")
    require(launches >= cfg.layers * (len(docs) // INGEST_BATCH + 1),
            "(a) the trained-params ingest went through flash_attn")
    require(cos >= 0.9999, "(a) kernel embeddings within cosine 0.9999 of training's")
    pipe.close()
    model.close()
    return launches


def p24_lm_batch(tok, docs, dev) -> dict:
    """(b)'s batch: the corpus's text in 8 rows of 256 byte tokens, the
    first row left-padded by 64."""
    import torch

    ids = tok.encode(" ".join(docs[:2048]))[: P24_LM_ROWS * P24_LM_SEQ]
    ids = torch.tensor(ids, dtype=torch.int64).view(P24_LM_ROWS, P24_LM_SEQ)
    mask = torch.ones_like(ids)
    ids[0, :P24_LM_PAD] = 0
    mask[0, :P24_LM_PAD] = 0
    return {"ids": ids.to(dev), "mask": mask.to(dev)}


def p24_lm(dev, gpu: str, docs) -> None:
    """(b)."""
    import torch

    from pathway_tpu_torch.models import decoder as D
    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.models import train as TT
    from pathway_tpu_torch.parallel.mesh import make_mesh, spec_dropping_nondividing

    cfg = D.GPT2_SMALL  # bf16 compute, f32 params
    batch = p24_lm_batch(byte_tokenizer(), docs, dev)
    state, tx = TT.init_decoder_train_state(0, cfg, device=dev)
    step = TT.make_decoder_train_step(cfg, tx)
    p24_grad_check(TT.lm_loss(state.params, batch, cfg), state.params, "(b) step 1")
    FA.flash_attn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, losses, ms = p24_step_ms(step, state, [batch] * P24_LM_STEPS)
    peak = torch.cuda.max_memory_allocated()
    tokens = int(batch["mask"].sum())
    step_ms = statistics.median(ms[1:])
    info(f"(b) causal LM GPT-2 small (bf16 compute, f32 params, lr 3e-4) [{gpu}]: "
         f"{P24_LM_STEPS} steps of {P24_LM_ROWS} x {P24_LM_SEQ} tokens (row 0 left-padded "
         f"by {P24_LM_PAD}); step {step_ms:.3f} ms median (CUDA events; first {ms[0]:.3f}); "
         f"{tokens / (step_ms / 1e3):.1f} tokens/s; peak max_memory_allocated "
         f"{peak / 2**20:.1f} MiB; losses {[round(x, 4) for x in losses]}")
    require(FA.flash_attn.launches == 0, "(b) no flash_attn launch during a step")
    require(losses[-1] < losses[0], "(b) the loss on the repeated batch fell")
    mesh = make_mesh([dev] * 8, dp=2, tp=4)

    def lenient(node, sp):
        return {k: lenient(v, sp[k]) if isinstance(v, dict)
                else spec_dropping_nondividing(sp[k], tuple(v.shape), mesh)
                for k, v in node.items()}

    # the 50,257-row wte replicates over tp=4
    specs = lenient(state.params, D.param_partition_specs(cfg))
    del state, tx, step
    sh = p24_sharded(lambda: TT.init_decoder_train_state(0, cfg, device=dev),
                     TT.make_decoder_train_step, cfg, specs, batch, 2, 4, dev)
    info(f"  (b) dp=2 x tp=4 over [cuda:0] * 8 ({sh['positions']} shard tensors) [{gpu}]: "
         f"losses {sh['losses']} vs unsharded {sh['plain_losses']} (max rel "
         f"{sh['rel']:.2e}); step ms {[round(x, 3) for x in sh['ms']]} vs "
         f"{[round(x, 3) for x in sh['plain_ms']]}; replicas bitwise equal {sh['equal']}")
    require(sh["rel"] <= P24_REL_TOL and sh["losses"][1] < sh["losses"][0] and sh["equal"]
            and sh["boxed"], "(b) the sharded LM step equals the unsharded one, replicas equal")
    torch.cuda.empty_cache()


def p24_gate_batches(train, rng, tok, dev):
    """The ``trained_decoder`` fixture's batches: 64 training samples drawn
    with ``rng``, the decoder's view and the answer, cut to 144 tokens."""
    import torch

    while True:
        idx = rng.integers(0, len(train), P24_GATE_BATCH)
        seqs, lens = [], []
        for i in idx:
            s = train[int(i)]
            ids = tok.encode(p24_decoder_view(s) + " " + s.answer)[:P24_GATE_SEQ]
            lens.append(len(ids))
            seqs.append(ids + [0] * (P24_GATE_SEQ - len(ids)))
        mask = (np.arange(P24_GATE_SEQ)[None, :] < np.array(lens)[:, None]).astype(np.int64)
        yield {"ids": torch.tensor(seqs, dtype=torch.int64).to(dev),
               "mask": torch.from_numpy(mask).to(dev)}


def p24_small_kernels(dev, cfg, block: int) -> dict:
    """``flash_chunk_attn_paged`` and ``paged_attn_decode`` against their
    plain versions at the gate decoder's shapes: f32, 4 heads x 16."""
    import torch

    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.models import paged_attention as PA

    g = torch.Generator().manual_seed(24)
    nh, hd, M = cfg.heads, cfg.head_dim, 176 // block
    errs = {}
    B = 8
    n_blocks = B * M + 1
    q = torch.randn((B, nh, hd), generator=g).to(dev)
    kb, vb = (torch.randn((n_blocks, nh, block, hd), generator=g).to(dev) for _ in range(2))
    kb[0] = vb[0] = 0
    lens = torch.randint(1, M * block + 1, (B,), generator=g)
    lens[0] = 0
    tbl = (torch.randperm(n_blocks - 1, generator=g)[: B * M] + 1).reshape(B, M)
    for b in range(B):
        tbl[b, (int(lens[b]) + block - 1) // block:] = 0
    tbl = tbl.to(torch.int32).to(dev)
    mask = (torch.arange(M * block)[None, :] < lens[:, None]).to(torch.int32).to(dev)
    args = (q, kb, vb, None, None, tbl, mask)
    out = PA.paged_attn_decode(*args)
    ref = PA.paged_attn_decode_reference(*args)
    errs["paged_attn_decode"] = float((out - ref).abs().max())
    for start in (0, 64, 128):
        T = 16
        qc = torch.randn((nh, T, hd), generator=g).to(dev)
        row = tbl[1:2].clone()
        row_mask = (torch.arange(M * block) < start + T).to(torch.int32).to(dev)
        row_mask[start // 2::7] = 0
        o = FA.flash_chunk_attn_paged(qc, kb, vb, None, None, row[0], row_mask, start)
        r = FA.flash_chunk_attn_paged_reference(qc, kb, vb, None, None, row[0], row_mask, start)
        errs["flash_chunk_attn_paged"] = max(errs.get("flash_chunk_attn_paged", 0.0),
                                             float((o - r).abs().max()))
    torch.cuda.synchronize()
    return errs


def p24_gate(dev, gpu: str) -> dict:
    """(c); returns its launches of the five kernel entry points."""
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import DecoderChat
    from pathway_tpu_torch.models import decoder as D
    from pathway_tpu_torch.models import train as TT
    from pathway_tpu_torch.stdlib.indexing.bm25 import TantivyBM25Factory
    from pathway_tpu_torch.xpacks.llm import rag_eval
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
    from pathway_tpu_torch.xpacks.llm.question_answering import (
        BaseRAGQuestionAnswerer,
        SimpleContextProcessor,
    )

    pool = rag_eval.generate_qa_dataset(4040, seed=1)
    evals, train = pool[:40], pool[40:]
    require(not {s.answer for s in evals} & {s.answer for s in train},
            "(c) the eval facts are disjoint from the training facts")
    tok = P24CharTokenizer()
    cfg = D.DecoderConfig(vocab_size=97, hidden=64, layers=2, heads=4, intermediate=128,
                          max_position=P24_GATE_SEQ + 16, dtype=torch.float32)
    tx = TT.AdamW(P24_GATE_LR)

    def fixture_state(d):
        params = D.map_params(lambda t: t.to(d), p24_fixture_params(cfg))
        return TT.TrainState(params, tx.init(params), 0)

    first = next(p24_gate_batches(train, np.random.default_rng(0), tok, "cpu"))
    outs = []
    for d in (dev, "cpu"):
        s, loss = TT.make_decoder_train_step(cfg, tx)(fixture_state(d),
                                                      {k: v.to(d) for k, v in first.items()})
        outs.append((float(loss), [x.detach().cpu() for x in TT.param_leaves(s.params)]))
    diff = max(float((a - b).abs().max()) for a, b in zip(outs[0][1], outs[1][1]))
    info(f"  (c) one f32 step card vs CPU (TF32 off) [{gpu}]: loss {outs[0][0]:.7f} vs "
         f"{outs[1][0]:.7f}; max param diff {diff:.3e}")
    require(abs(outs[0][0] - outs[1][0]) <= 1e-5 and diff <= 1e-4,
            "(c) the f32 LM step on the card equals the CPU's (loss 1e-5, params 1e-4)")
    state = fixture_state(dev)
    step = TT.make_decoder_train_step(cfg, tx)
    batches = p24_gate_batches(train, np.random.default_rng(0), tok, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, steps, seen = None, 0, []
    for steps in range(1, P24_GATE_CAP + 1):
        state, loss = step(state, next(batches))
        if steps % P24_GATE_EVERY == 0:
            seen.append(round(float(loss), 4))
            if seen[-1] < P24_GATE_STOP:
                break
    loss = float(loss)
    train_s = time.perf_counter() - t0
    info(f"(c) the RAG gate's decoder (vocab 97, hidden 64, 2 layers, 4 heads, ffn 128, f32; "
         f"JAX's PRNGKey(0) init) trained on the card [{gpu}]: {steps} steps of "
         f"{P24_GATE_BATCH} x {P24_GATE_SEQ} in {train_s:.3f} s ({train_s / steps * 1e3:.3f} "
         f"ms a step, host clock); final loss {loss:.4f} (< 0.3); every {P24_GATE_EVERY} "
         f"steps {seen}")
    require(loss < 0.3, "(c) the decoder learned the answer-copy task")
    block = 16
    errs = p24_small_kernels(dev, cfg, block)
    info(f"  (c) kernels vs plain at 4 heads x 16, f32 [{gpu}]: max abs err {errs} (atol 1e-4)")
    require(all(v <= ATOL["float32"] for v in errs.values()),
            "(c) paged_attn_decode and flash_chunk_attn_paged agree at head_dim 16")
    trained = D.map_params(lambda t: t.detach(), state.params)
    chat = DecoderChat(params=trained, cfg=cfg, tokenizer=tok, max_new_tokens=6,
                       continuous=True, n_slots=8, chunk_steps=8,
                       max_prompt_tokens=P24_GATE_SEQ, prefill_chunk=64,
                       spec_decode=False, chunk_autotune=False, paged_kv=True,
                       paged_kv_block=block, paged_kernel=True, flash_prefill=True,
                       device=dev)
    pw.clear_graph()
    store = DocumentStore(rag_eval.docs_table(evals), retriever_factory=TantivyBM25Factory())
    qa = BaseRAGQuestionAnswerer(chat, store, search_topk=1, prompt_template=P24_GATE_TEMPLATE,
                                 context_processor=SimpleContextProcessor())
    for f in counters().values():
        f.launches = 0
    s0 = dict(chat.server.stats)
    t0 = time.perf_counter()
    out = rag_eval.run_rag_eval(qa, evals)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    ln = {n: f.launches for n, f in counters().items()}
    st = {k: v - s0[k] for k, v in chat.server.stats.items()}
    pw.clear_graph()
    chat.close()
    info(f"  (c) run_rag_eval over BM25 top-1 and the continuous DecoderChat (paged, paged "
         f"kernel, flash prefill, 6 new tokens) [{gpu}]: {out['n']} questions in "
         f"{eval_s:.3f} s; accuracy_contains {out['accuracy_contains']:.3f} (>= "
         f"{P24_GATE_MIN}), exact {out['accuracy_exact']:.3f}; {st['decode_steps']} decode "
         f"steps, {st['prefill_chunks']} prefill pieces; launches {ln}")
    require(out["n"] == len(evals), "(c) every question answered")
    require(out["accuracy_contains"] >= P24_GATE_MIN, "(c) the answer gate: accuracy >= 0.6")
    require(ln["paged_attn_decode"] >= cfg.layers * st["decode_steps"] > 0,
            "(c) every decode step and layer went through paged_attn_decode")
    require(ln["flash_chunk_attn_paged"] >= cfg.layers * st["prefill_chunks"] > 0,
            "(c) every prefill piece and layer went through flash_chunk_attn_paged")
    return ln


def p24_child(spec_path: str) -> int:
    """A child of (d) under ``spawn``: CSV docs -> the embed UDF on the
    card -> a JSON-lines sink, in a ``pw.run()`` given no config (spawn's
    is the default). Writes its launches to a file of its own."""
    import uuid

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import SentenceEmbedderModel
    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.models.transformer import MINILM_L6
    from pathway_tpu_torch.xpacks import llm

    with open(spec_path) as fh:
        spec = json.load(fh)
    if spec["device"].startswith("cuda"):
        mp_load_kernels()
    model = SentenceEmbedderModel(MINILM_L6, max_length=64, device=spec["device"])
    emb = llm.SentenceTransformerEmbedder(model, max_batch_size=RAG_BATCH)
    DocSchema, _ = mp_doc_schemas(pw)
    docs = pw.io.csv.read(spec["src"], schema=DocSchema, mode="static")
    pw.io.jsonlines.write(docs.select(docs.doc, vec=emb(docs.text)), spec["out"])
    FA.flash_attn.launches = 0
    pw.run()
    with open(os.path.join(spec["results"], f"{uuid.uuid4().hex}.json"), "w") as fh:
        json.dump({"flash_attn": FA.flash_attn.launches}, fh)
    return 0


P24_DEBUG_PROG = """import sys
import pathway_tpu_torch as pw
t = pw.debug.table_from_markdown('word | n\\nalpha | 1\\nbeta | 2')
pw.debug.table_to_csv(t, sys.argv[1])
pw.clear_graph()
back = pw.debug.table_from_csv(sys.argv[1])
pw.debug.compute_and_print(back.select(back.word, m=back.n * 10), include_id=False)
"""


def p24_spawn_start(dev, docs) -> dict:
    """(d), started: ``spawn -n 2`` over this script's ``--phase24-child``
    and ``spawn-from-env`` over a ``pw.debug`` program, both at once, each
    with its output in a file; the caller goes on meanwhile."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="p24-")
    src, results = os.path.join(tmp, "csv"), os.path.join(tmp, "results")
    os.makedirs(results)
    mp_write_csv(src, ["doc", "text"], list(enumerate(docs[:P24_SPAWN_DOCS])), FS_FILES)
    spec = {"src": src, "out": os.path.join(tmp, "vecs.jsonl"), "results": results,
            "device": str(dev), "tmp": tmp}
    spec_path = os.path.join(tmp, "spec.json")
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    prog = os.path.join(tmp, "debug_prog.py")
    with open(prog, "w") as fh:
        fh.write(P24_DEBUG_PROG)
    cli = [sys.executable, "-m", "pathway_tpu_torch"]
    runs = {
        "spawn": (cli + ["spawn", "-n", "2", "--first-port", str(mp_free_port()),
                         os.path.join(root, "chip_smoke.py"), "--phase24-child", spec_path],
                  None),
        "spawn-from-env": (cli + ["spawn-from-env", sys.executable, prog,
                                  os.path.join(tmp, "t.csv")],
                           dict(os.environ, PATHWAY_SPAWN_ARGS="-n 1 -t 1")),
    }
    spec["procs"] = {}
    for name, (argv, env) in runs.items():
        out = open(os.path.join(tmp, f"{name}.out"), "w+")
        spec["procs"][name] = (subprocess.Popen(argv, cwd=root, env=env, stdout=out,
                                                stderr=subprocess.STDOUT), out)
    spec["t0"] = time.perf_counter()
    return spec


def p24_spawn_finish(spec: dict, dev, gpu: str, docs) -> int:
    """(d), waited for (bounded; every process stopped) and checked;
    returns the children's flash_attn launches."""
    from pathway_tpu_torch import SentenceEmbedderModel
    from pathway_tpu_torch.models.transformer import MINILM_L6

    codes, outs, walls = {}, {}, {}
    try:
        for name, (proc, out) in spec["procs"].items():
            left = max(1.0, P24_TIMEOUT - (time.perf_counter() - spec["t0"]))
            try:
                codes[name] = proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                codes[name] = None
            walls[name] = time.perf_counter() - spec["t0"]
            out.seek(0)
            outs[name] = out.read()
    finally:
        for proc, out in spec["procs"].values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    if codes["spawn"] != 0:
        info(outs["spawn"][-6000:])
    require(codes["spawn"] == 0, "(d) spawn --processes 2 exited 0")
    shares = []
    for p in range(2):
        with open(f"{spec['out']}.{p}") as fh:
            shares.append({r["doc"]: r["vec"] for r in map(json.loads, fh) if r["diff"] == 1})
    ids = [set(s) for s in shares]
    require(not ids[0] & ids[1] and ids[0] | ids[1] == set(range(P24_SPAWN_DOCS)),
            "(d) the children's shares are disjoint and cover all 4,096 docs")
    got = {**shares[0], **shares[1]}
    vecs = np.asarray([got[i] for i in range(P24_SPAWN_DOCS)], dtype=np.float32)
    model = SentenceEmbedderModel(MINILM_L6, max_length=64, device=dev)
    direct = np.concatenate([model.embed_batch(docs[s:s + RAG_BATCH])
                             for s in range(0, P24_SPAWN_DOCS, RAG_BATCH)])
    model.close()
    cos = np.sum(vecs * direct, axis=1) / (np.linalg.norm(vecs, axis=1)
                                           * np.linalg.norm(direct, axis=1))
    launches = 0
    for name in os.listdir(spec["results"]):
        with open(os.path.join(spec["results"], name)) as fh:
            launches += json.load(fh)["flash_attn"]
    info(f"(d) python -m pathway_tpu_torch spawn -n 2 [{gpu}]: {P24_SPAWN_DOCS} docs in "
         f"{FS_FILES} CSV files -> embed UDF on {dev} -> JSON lines, done "
         f"{walls['spawn']:.1f} s after its start (the children's start included; (b) and "
         f"(c) ran meanwhile); shares {len(ids[0])} + {len(ids[1])}; min cosine to a direct "
         f"encode {cos.min():.6f}; flash_attn launches {launches}")
    require(cos.min() >= C4_COS_MIN, f"(d) vectors within cosine {C4_COS_MIN} of a direct encode")
    require(len(os.listdir(spec["results"])) == 2 and launches >= MINILM_LAYERS * 2,
            "(d) both children embedded through flash_attn")
    lines = [ln.split() for ln in outs["spawn-from-env"].strip().splitlines()]
    info(f"  (d) spawn-from-env (PATHWAY_SPAWN_ARGS='-n 1 -t 1') running a pw.debug program "
         f"[{gpu}]: "
         f"exit {codes['spawn-from-env']} after {walls['spawn-from-env']:.1f} s, printed "
         f"{[ln for ln in lines if len(ln) == 2]}")
    require(codes["spawn-from-env"] == 0 and ["alpha", "10"] in lines
            and ["beta", "20"] in lines, "(d) spawn-from-env ran the pw.debug program")
    return launches


def run_training(dev, gpu: str, docs, queries) -> tuple[int, dict]:
    """Phase 24; returns (a)'s and (d)'s flash_attn launches and (c)'s
    launches of the five entry points. (d)'s processes run while (b) and
    (c) train and serve (the script's time); (a)'s steps are timed alone."""
    t0 = time.perf_counter()
    launches = p24_contrastive(dev, gpu, docs, queries)
    t1 = time.perf_counter()
    spawned = p24_spawn_start(dev, docs)
    p24_lm(dev, gpu, docs)
    t2 = time.perf_counter()
    gate = p24_gate(dev, gpu)
    t3 = time.perf_counter()
    launches += p24_spawn_finish(spawned, dev, gpu, docs)
    t4 = time.perf_counter()
    info(f"phase 24 [{gpu}]: {t4 - t0:.1f} s ((a) {t1 - t0:.1f}; with (d) running: (b) "
         f"{t2 - t1:.1f}, (c) {t3 - t2:.1f}; then (d) {t4 - t3:.1f})")
    return launches, gate


# ---------------------------------------------------------------- phase 25
# the autotuner with its trials on the card, and an Airbyte source through
# pw.sql and a row transformer into the embed UDF. (a) shared_prefix_chat
# with phase 6's server settings as base flags (JAX's names), phase 6's
# GPT-2 small params with the profile's char tokenizer, P25_TRIALS
# candidates (the baseline one of them), P25_ROUNDS halving rounds from
# scale P25_SCALE, seed 0, the chaos drill at the Autotuner's default rate;
# (b) retraction_heavy_ingest at its own size (JAX's tiny encoder); (c)
# P25_RECORDS RECORD messages of phase 4's corpus from a connector script,
# P25_SQL keeping about half, the first P25_QUERIES of phase 4's queries.
P25_BASE = {"PATHWAY_TPU_PAGED_KV": "1", "PATHWAY_TPU_PAGED_KERNEL": "1",
            "PATHWAY_TPU_FLASH_PREFILL": "1", "PATHWAY_TPU_WEIGHT_QUANT": "int8",
            "PATHWAY_TPU_WQ_KERNEL": "1"}
P25_TRIALS, P25_ROUNDS, P25_SCALE, P25_INGEST_TRIALS = 4, 2, 0.5, 3
P25_RECORDS, P25_QUERIES, P25_K, P25_TIE_TOL = 4096, 8, 10, 1e-3
P25_TIMEOUT = 300.0  # a bound on (c)'s wait for its docs
P25_SQL = "SELECT doc_id, text FROM docs WHERE doc_id % 3 <> 1 AND doc_id < 3072"
P25_CONNECTOR = r'''
import argparse, json, sys

p = argparse.ArgumentParser()
p.add_argument("action")
p.add_argument("--config")
p.add_argument("--catalog")
p.add_argument("--state")
a = p.parse_args()

def emit(m):
    sys.stdout.write(json.dumps(m) + "\n")

if a.action == "spec":
    emit({"type": "SPEC", "spec": {"connectionSpecification": {}}})
elif a.action == "discover":
    emit({"type": "CATALOG", "catalog": {"streams": [
        {"name": "docs", "supported_sync_modes": ["full_refresh"]}]}})
elif a.action == "read":
    with open(json.load(open(a.config))["docs"]) as f:
        docs = json.load(f)
    for i, text in enumerate(docs):
        emit({"type": "RECORD", "record": {"stream": "docs",
                                           "data": {"doc_id": i, "text": text}}})
    emit({"type": "STATE", "state": {"done": len(docs)}})
'''


class P25Trials:
    """While open, every ``DecoderChat`` the tuner builds is recorded at
    its close (its server's stats, the spec settings and the kernel
    launches over its life), and every trial checks after it ends that the
    chaos and SLO settings are back to their defaults."""

    def __init__(self):
        self.chats: list[dict] = []
        self.restored: list[bool] = []

    def __enter__(self):
        import torch

        from pathway_tpu_torch.engine import chaos, slo
        from pathway_tpu_torch.tuning import profiles
        from pathway_tpu_torch.xpacks.llm import llms

        chats, restored = self.chats, self.restored
        defaults = (chaos.settings(), slo.settings())
        self._real_chat, self._real_trial = llms.DecoderChat, profiles.run_trial

        class Recorded(self._real_chat):
            def __init__(self, *a, **kw):
                self._p25_before = {n: f.launches for n, f in counters().items()}
                super().__init__(*a, **kw)

            def close(self):
                super().close()
                torch.cuda.synchronize()
                srv = self.server
                chats.append({
                    "stats": dict(srv.stats), "spec": srv.spec_decode, "k": srv.spec_k,
                    "draft": srv.spec_draft_layers, "layers": srv.cfg.layers,
                    "launches": {n: f.launches - self._p25_before[n]
                                 for n, f in counters().items()}})

        def checked(*a, **kw):
            try:
                return self._real_trial(*a, **kw)
            finally:
                restored.append((chaos.settings(), slo.settings()) == defaults)

        llms.DecoderChat, profiles.run_trial = Recorded, checked
        return self

    def __exit__(self, *exc):
        from pathway_tpu_torch.tuning import profiles
        from pathway_tpu_torch.xpacks.llm import llms

        llms.DecoderChat, profiles.run_trial = self._real_chat, self._real_trial


def p25_trial_lines(profile, result) -> None:
    for t in result.trials:
        m = t["metrics"] or {}
        info(f"  trial {json.dumps(t['flags'], sort_keys=True)} scale {t['scale']}: "
             f"{profile.headline} {m.get(profile.headline)}, score {t['score']}, "
             f"terminal_ok {m.get('terminal_ok')}, aborted {m.get('aborted')}, wall_s "
             f"{m.get('wall_s')}" + (f", error {m['error']}" if "error" in m else ""))
    for r in result.rejected:
        info(f"  rejected {json.dumps(r['flags'], sort_keys=True)}: {r['reason']}")
    info(f"  winner {json.dumps(result.winner, sort_keys=True)}: score "
         f"{result.winner_score} against the baseline's {result.baseline_score} (printed, "
         f"not judged: noise-bound)")
    for t in result.trials:
        m = t["metrics"] or {}
        require("error" not in m and (m.get("aborted") or m.get("terminal_ok")),
                f"trial {json.dumps(t['flags'], sort_keys=True)} at scale {t['scale']} "
                f"built its server and ended terminal_ok (or was aborted)")


def p25_tuner(dev, gpu: str, params) -> dict:
    """Phase 25 (a); returns its launches of the five entry points."""
    import dataclasses
    import tempfile

    import torch

    from pathway_tpu_torch import DecoderChat, tuning
    from pathway_tpu_torch.internals import config as config_mod
    from pathway_tpu_torch.models import decoder as D
    from pathway_tpu_torch.tuning import profiles

    t0 = time.perf_counter()
    profile = dataclasses.replace(tuning.PROFILES["shared_prefix_chat"], base_flags=P25_BASE)
    cfg = D.GPT2_SMALL
    # phase 6's params on the card once; each trial's chat serves them in
    # bf16 with int8 weights
    resources = (D.map_params(lambda t: t.to(dev), params), cfg, profiles._CharTok())
    for f in counters().values():
        f.launches = 0
    with P25Trials() as rec:
        tuner = tuning.Autotuner(profile, seed=0, max_trials=P25_TRIALS, rounds=P25_ROUNDS,
                                 base_scale=P25_SCALE, resources=resources, device=dev)
        result = tuner.run()
    info(f"tune (a) {profile.name} at GPT-2 small [{gpu}]: {len(result.trials)} trials, "
         f"{len(rec.chats)} servers with the validation legs, "
         f"{time.perf_counter() - t0:.1f} s; base flags {json.dumps(P25_BASE, sort_keys=True)}")
    p25_trial_lines(profile, result)
    for leg in ("slo", "chaos"):
        m = result.validation.get(leg) or {}
        info(f"  validation {leg}: terminal_ok {m.get('terminal_ok')}, shed {m.get('shed')}, "
             f"failures {m.get('failures')}, restarts {m.get('restarts')}, "
             f"{profile.headline} {m.get(profile.headline)}")
    require(len(rec.restored) == len(rec.chats) and all(rec.restored),
            f"after each of the {len(rec.restored)} trials the chaos and SLO settings are "
            f"back to their defaults")
    for i, c in enumerate(rec.chats):
        st, ln, L = c["stats"], c["launches"], c["layers"]
        plain = st["decode_steps"] - st["spec_cycles"]
        wq_need = (4 * (c["draft"] * c["k"] + L) * st["spec_cycles"]
                   + 4 * L * (plain + st["prefill_chunks"]))
        ok = (ln["flash_chunk_attn_paged"] >= L * st["prefill_chunks"] > 0
              and ln["paged_attn_decode"] >= L * plain and ln["wq_matmul"] >= wq_need
              and (st["spec_dispatches"] > 0) <= c["spec"])
        if not ok:
            info(f"  server {i}: stats {st}; launches {ln}; spec {c['spec']}")
        require(ok, f"trial server {i}: every prefill piece, decode step and layer product "
                    f"went through flash_chunk_attn_paged, paged_attn_decode and wq_matmul")
    launches = {n: sum(c["launches"][n] for c in rec.chats) for n in counters()}

    with tempfile.TemporaryDirectory() as tmp:
        path = tuning.save_artifact(result, os.path.join(tmp, "tuned.json"))
        flags = config_mod.load_tuned_config(path)
        require(flags == result.winner, f"the artifact loads with the winner's flags {flags}")
        base = dict(params=resources[0], cfg=cfg, tokenizer=profiles._CharTok(),
                    max_new_tokens=profile.max_new, temperature=0.0,
                    max_prompt_tokens=profile.prompt_cap, continuous=True,
                    n_slots=profile.n_slots, chunk_steps=profile.chunk_steps, device=dev,
                    **config_mod.knob_arguments(P25_BASE)["DecoderChat"])
        winner = config_mod.knob_arguments(flags).get("DecoderChat", {})
        # plain decode on a paged pool is schedule-invariant: both chats
        # pin spec and chunk autotune off unless the winner sets them
        pins = {k: v for k, v in (("spec_decode", False), ("chunk_autotune", False))
                if k not in winner}
        prompts = profiles._prompts(profile, 8, profiles._profile_rng(profile, 5))
        got = {}
        for name, kw in (("tuned", dict(tuned_config=path)), ("explicit", winner)):
            for f in counters().values():
                f.launches = 0
            chat = DecoderChat(**base, **pins, **kw)
            try:
                if name == "tuned":
                    require(all(chat.knobs[a] == v for a, v in winner.items()),
                            f"DecoderChat(tuned_config=...) has the winner's values {winner}")
                reqs = chat.submit_batch(prompts)
                done = [r.done.wait(120.0) and r.text is not None for r in reqs]
                require(all(done), f"({name}) the 8 requests finished")
                got[name] = [r.tokens for r in reqs]
            finally:
                chat.close()
            torch.cuda.synchronize()
            launches = {n: launches[n] + f.launches for n, f in counters().items()}
        snap = config_mod.tuned_config_snapshot()
        info(f"  tuned chat: knobs from the artifact {winner}, pins {pins}; "
             f"unified_snapshot()['tuning'] flags {snap['flags']}, shadowed_by_args "
             f"{snap['shadowed_by_args']}")
        require(got["tuned"] == got["explicit"],
                "the tuned chat's 8 greedy streams equal the explicit chat's token for token")
    config_mod.clear_tuned_configs()
    info(f"tune (a): launches {launches}; {time.perf_counter() - t0:.1f} s")
    return launches


def p25_ingest_tuner(dev, gpu: str) -> int:
    """Phase 25 (b); returns its flash_attn launches."""
    from pathway_tpu_torch import tuning
    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.models.embedder import SentenceEmbedderModel
    from pathway_tpu_torch.tuning import profiles

    t0 = time.perf_counter()
    profile = tuning.PROFILES["retraction_heavy_ingest"]
    encodes = [0]
    real = SentenceEmbedderModel.embed_submit

    def counted(self, texts):
        encodes[0] += bool(texts)
        return real(self, texts)

    FA.flash_attn.launches = 0
    SentenceEmbedderModel.embed_submit = counted
    try:
        result = tuning.Autotuner(profile, seed=0, max_trials=P25_INGEST_TRIALS, rounds=1,
                                  device=dev).run()
    finally:
        SentenceEmbedderModel.embed_submit = real
    launches = FA.flash_attn.launches
    layers = profiles._INGEST_CFG["layers"]
    info(f"tune (b) {profile.name}, JAX's tiny encoder [{gpu}]: {len(result.trials)} trials, "
         f"{encodes[0]} encodes, flash_attn launches {launches}; "
         f"{time.perf_counter() - t0:.1f} s")
    p25_trial_lines(profile, result)
    require(launches >= layers * encodes[0] > 0,
            f"(b) every batch went through flash_attn ({launches} >= {layers} x {encodes[0]})")
    return launches


def p25_airbyte_sql(dev, gpu: str, out: dict, docs, queries) -> int:
    """Phase 25 (c); returns its flash_attn launches."""
    import tempfile
    import threading

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import BruteForceKnnIndex
    from pathway_tpu_torch.io.airbyte import ExecutableAirbyteSource
    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.xpacks import llm

    t0 = time.perf_counter()
    model = out["emb"]
    texts, q_texts = docs[:P25_RECORDS], queries[:P25_QUERIES]
    model.embed_batch(texts[:RAG_BATCH])  # warm the batch bucket, outside the counts
    kept = {i: (texts[i], len(texts[i].split())) for i in range(P25_RECORDS)
            if i % 3 != 1 and i < 3072}
    rows, replies, lock = {}, {}, threading.Lock()
    counter = EncodeCount(model)
    FA.flash_attn.launches = 0
    try:
        with tempfile.TemporaryDirectory() as tmp:
            with open(os.path.join(tmp, "docs.json"), "w") as f:
                json.dump(texts, f)
            script = os.path.join(tmp, "connector.py")
            with open(script, "w") as f:
                f.write(P25_CONNECTOR)
            pw.clear_graph()
            source = ExecutableAirbyteSource(f"{sys.executable} {script}",
                                             config={"docs": os.path.join(tmp, "docs.json")},
                                             streams=["docs"])
            raw = pw.io.airbyte.read(streams=["docs"], mode="static", _source=source)
            table = raw.select(doc_id=pw.this.data["doc_id"].as_int(unwrap=True),
                               text=pw.this.data["text"].as_str(unwrap=True))
            sel = pw.sql(P25_SQL, docs=table)

            @pw.transformer
            class words:
                class table(pw.ClassArg):
                    text = pw.input_attribute()

                    @pw.output_attribute
                    def n_words(self) -> int:
                        return len(self.text.split())

            tagged = sel.with_columns(n_words=words(table=sel).table.n_words)
            emb = llm.SentenceTransformerEmbedder(model, max_batch_size=RAG_BATCH)
            vecs = tagged.select(tagged.doc_id, tagged.n_words, vec=emb(tagged.text))
            index = pw.indexing.DataIndex(vecs, pw.indexing.BruteForceKnn(
                vecs.vec, dimensions=model.cfg.hidden, reserved_space=P25_RECORDS,
                metric="cos", device=model.device))
            indexed = threading.Event()

            class Queries(pw.io.python.ConnectorSubject):
                def run(self):  # asked once every kept doc is in the index
                    if not indexed.wait(P25_TIMEOUT):
                        raise TimeoutError("the kept docs never all reached the index")
                    for q in q_texts:
                        self.next(q=q)
                    self.commit()

            qt = pw.io.python.read(Queries(), schema=pw.schema_from_types(q=str))
            res = index.query_as_of_now(qt.select(qt.q, qv=emb(qt.q)).qv,
                                        number_of_matches=P25_K, with_distances=True)
            res = res.select(res.doc_id, res._pw_dist, q=qt.restrict(res).q)

            def on_row(key, row, time, is_addition):
                with lock:
                    if is_addition:
                        rows[key.value] = (row["doc_id"], row["n_words"], row["vec"])
                    else:
                        rows.pop(key.value, None)
                    if len(rows) >= len(kept):
                        indexed.set()

            def on_reply(key, row, time, is_addition):
                with lock:
                    if is_addition:
                        replies[row["q"]] = list(zip(row["doc_id"], row["_pw_dist"]))

            pw.io.subscribe(vecs, on_change=on_row)
            pw.io.subscribe(res, on_change=on_reply)
            torch.cuda.synchronize()
            t_run = time.perf_counter()
            pw.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_run
    finally:
        counter.close()
    launches = FA.flash_attn.launches
    n_encodes = len(counter.sizes)
    got = {d: (w, v) for d, w, v in rows.values()}
    info(f"airbyte (c) {P25_RECORDS} RECORD messages -> pw.io.airbyte.read -> pw.sql "
         f"({P25_SQL!r}) -> pw.transformer -> embed UDF -> DataIndex [{gpu}]: "
         f"{len(got)} rows kept, pw.run() {wall:.3f} s ({P25_RECORDS / wall:.1f} records/s); "
         f"{n_encodes} encodes, flash_attn launches {launches}")
    require(len(rows) == len(got) == len(kept) and sorted(got) == sorted(kept),
            f"(c) the kept rows are the host model's {len(kept)}")
    require(all(got[d][0] == kept[d][1] for d in kept),
            "(c) the transformer's n_words equals the host model's for every row")
    ids = sorted(kept)
    direct = np.concatenate([model.embed_batch([kept[d][0] for d in ids[s:s + RAG_BATCH]])
                             for s in range(0, len(ids), RAG_BATCH)]).astype(np.float32)
    vec = np.asarray([got[d][1] for d in ids], dtype=np.float32)
    cos = np.sum(vec * direct, axis=1) / (np.linalg.norm(vec, axis=1)
                                          * np.linalg.norm(direct, axis=1))
    require(cos.min() >= C4_COS_MIN,
            f"(c) vectors within cosine {C4_COS_MIN} of direct encodes (min {cos.min():.6f})")
    require(launches >= MINILM_LAYERS * n_encodes > 0,
            f"(c) every encode went through flash_attn ({launches} >= {MINILM_LAYERS} x "
            f"{n_encodes})")
    ref = BruteForceKnnIndex(model.cfg.hidden, reserved_space=len(ids), metric="cos",
                             device=model.device)
    ref.add(ids, direct)
    want = dict(zip(q_texts, ref.search(model.embed_batch(q_texts), P25_K)))
    agree = sum(q in replies and ranks_agree(want[q], [(d, -s) for d, s in replies[q]],
                                             P25_TIE_TOL) for q in q_texts)
    info(f"  top-{P25_K} of {P25_QUERIES} queries equal a direct index but at gaps < "
         f"{P25_TIE_TOL}: {agree}/{P25_QUERIES}; phase {time.perf_counter() - t0:.1f} s")
    require(agree == P25_QUERIES, "(c) the replies equal the direct index's")
    pw.clear_graph()
    return launches


def run_tuning_airbyte(dev, gpu: str, params, out: dict, docs, queries) -> tuple[dict, int]:
    """Phase 25; returns (a)'s launches of the five entry points and (b)'s
    and (c)'s flash_attn launches."""
    t0 = time.perf_counter()
    tuned = p25_tuner(dev, gpu, params)
    t1 = time.perf_counter()
    launches = p25_ingest_tuner(dev, gpu)
    t2 = time.perf_counter()
    launches += p25_airbyte_sql(dev, gpu, out, docs, queries)
    t3 = time.perf_counter()
    info(f"phase 25 [{gpu}]: {t3 - t0:.1f} s ((a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, "
         f"(c) {t3 - t2:.1f})")
    return tuned, launches


# ---------------------------------------------------------------- phase 26
P26_REQUESTS, P26_RETRIEVES, P26_WRITE_REQUESTS = 16, 32, 8
# (b)'s feed commits one row an epoch: on the H100, 4,096 docs took
# 41.7-57.1 s and 2,048 docs 39.1 s of pw.run() at 52.3-98.3 docs/s
# (PERF.md), over the phase's ~30 s
P26_DOCS, P26_QUERIES, P26_K, P26_TIE_TOL = 512, 8, 10, 1e-3
P26_DECKS, P26_PAGES = 8, 4
P26_TIMEOUT = 300.0  # a bound on each wait of the phase
P26_ENDPOINT = "localhost:4317"  # handed to the recording exporter, never dialled
P26_OTEL_MODULES = (
    "opentelemetry", "opentelemetry.trace", "opentelemetry.sdk",
    "opentelemetry.sdk.resources", "opentelemetry.sdk.trace",
    "opentelemetry.sdk.trace.export", "opentelemetry.exporter",
    "opentelemetry.exporter.otlp", "opentelemetry.exporter.otlp.proto",
    "opentelemetry.exporter.otlp.proto.grpc",
    "opentelemetry.exporter.otlp.proto.grpc.trace_exporter",
)


class P26Recorder:
    """A recording stand-in for the OpenTelemetry SDK, installed in
    ``sys.modules`` while open: the machine with the card may lack the
    ``opentelemetry`` packages, and the phase must not depend on a
    collector. Every finished span is kept as (name, attributes, events)."""

    def __init__(self):
        import threading

        self.spans: list[tuple] = []
        self.lock = threading.Lock()
        self._tls = threading.local()
        self._saved: dict = {}

    def __enter__(self):
        import importlib.machinery
        import types
        from contextlib import contextmanager

        rec = self

        class Span:
            def __init__(self, name):
                self.name, self.attributes, self.events = name, {}, []

            def set_attribute(self, k, v):
                self.attributes[k] = v

            def add_event(self, name, attributes):
                self.events.append((name, dict(attributes)))

        class Tracer:
            @contextmanager
            def start_as_current_span(self, name):
                span = Span(name)
                stack = rec._stack()
                stack.append(span)
                try:
                    yield span
                finally:
                    stack.pop()
                    with rec.lock:
                        rec.spans.append((span.name, span.attributes, span.events))

        class Provider:
            def __init__(self, resource=None):
                self.resource = resource

            def add_span_processor(self, processor):
                self.processor = processor

            def shutdown(self):
                pass

        mods = {name: types.ModuleType(name) for name in P26_OTEL_MODULES}
        mods["opentelemetry.trace"].get_tracer = lambda name, tracer_provider=None: Tracer()
        mods["opentelemetry.trace"].get_current_span = (
            lambda: rec._stack()[-1] if rec._stack() else Span("none"))
        mods["opentelemetry"].trace = mods["opentelemetry.trace"]
        mods["opentelemetry.sdk.resources"].Resource = types.SimpleNamespace(
            create=lambda attrs: dict(attrs))
        mods["opentelemetry.sdk.trace"].TracerProvider = Provider
        mods["opentelemetry.sdk.trace.export"].BatchSpanProcessor = lambda exporter: exporter
        mods["opentelemetry.exporter.otlp.proto.grpc.trace_exporter"].OTLPSpanExporter = (
            lambda endpoint: endpoint)
        for name, mod in mods.items():
            mod.__spec__ = importlib.machinery.ModuleSpec(name, None)
            self._saved[name] = sys.modules.get(name)
            sys.modules[name] = mod
        return self

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def __exit__(self, *exc):
        for name, mod in self._saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod

    def mark(self) -> int:
        with self.lock:
            return len(self.spans)

    def since(self, mark: int) -> list[tuple]:
        with self.lock:
            return list(self.spans[mark:])


def p26_serve_arm(chat, qs, prompts, queries) -> dict:
    """One burst: ``prompts`` through ``chat``'s entry points while two
    threads send ``queries`` to the query server ``qs`` one at a time; every
    kernel count set to 0 just before, read just after."""
    import threading

    import torch

    from pathway_tpu_torch.engine import probes

    for f in counters().values():
        f.launches = 0
    s0 = dict(chat.server.stats)
    d0 = probes.dispatch_counts().get("fused_retrieve", 0)
    answers, errors = {}, []

    def client(part):
        try:
            for q in part:
                answers[q] = qs.submit(q, TOP_K).wait(P26_TIMEOUT)
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(queries[i::2],)) for i in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    reqs = chat.submit_batch(prompts)
    texts = chat.resolve_batch([reqs])[0]
    torch.cuda.synchronize()
    decode_wall = time.perf_counter() - t0
    for t in threads:
        t.join(P26_TIMEOUT)
    torch.cuda.synchronize()
    require(not errors and not any(t.is_alive() for t in threads),
            f"(a) every retrieve answered ({errors[:1]})")
    if chat.server.failed is not None:
        raise AssertionError(f"the serving loop died: {chat.server.failed!r}")
    require(all(t is not None and len(r.tokens) == MAX_NEW for r, t in zip(reqs, texts)),
            f"(a) every request finished with {MAX_NEW} tokens")
    return {"tokens": [list(r.tokens) for r in reqs],
            "tok_per_s": sum(len(r.tokens) for r in reqs) / decode_wall,
            "answers": answers,
            "launches": {n: f.launches for n, f in counters().items()},
            "stats": {k: v - s0[k] for k, v in chat.server.stats.items()},
            "retrieve_dispatches": probes.dispatch_counts().get("fused_retrieve", 0) - d0}


def p26_sanitized_serving(gpu: str, common, pipe, queries):
    """Phase 26 (a); returns its launches and the sanitizer-on chat, kept
    open for (b)."""
    import threading

    from pathway_tpu_torch import DecoderChat, QueryServer
    from pathway_tpu_torch.analysis import runtime

    prompts = make_prompts(P26_REQUESTS, 16, 480, seed=26)
    qtexts = (queries * (P26_RETRIEVES // len(queries) + 1))[:P26_RETRIEVES]
    kw = dict(paged_kv=True, paged_kv_block=BLOCK, paged_kernel=True, flash_prefill=True,
              **common)
    arms = {}
    chat_on = None
    for on in (True, False):
        runtime.configure(enabled=on)
        runtime.reset()
        if on:
            runtime.enable()
        chat = DecoderChat(**kw)
        qs = QueryServer(pipe)
        locks = [chat.server.lock, qs._cond._lock, qs._stats_lock]
        try:
            arms[on] = p26_serve_arm(chat, qs, prompts, qtexts)
            arms[on]["locks"] = locks
            arms[on]["reports"] = runtime.reports()
        finally:
            qs.shutdown()
            if on:
                runtime.disable()
                runtime.configure(enabled=False)
                chat_on = chat
            else:
                chat.close()
    on, off = arms[True], arms[False]
    # the zero above is not vacuous: the same sanitizer reports a seeded
    # A -> B, B -> A inversion on two named locks
    runtime.configure(enabled=True)
    a, b = runtime.make_lock("phase26.A"), runtime.make_lock("phase26.B")
    runtime.configure(enabled=False)

    def nest(x, y):
        with x:
            with y:
                pass

    nest(a, b)
    t = threading.Thread(target=nest, args=(b, a))
    t.start()
    t.join(P26_TIMEOUT)
    seeded = runtime.reports("order-inversion")
    runtime.reset()
    st, ln = on["stats"], on["launches"]
    info(f"sanitizer (a) [{gpu}]: {P26_REQUESTS} requests x {MAX_NEW} tokens with "
         f"{P26_RETRIEVES} retrieves from 2 threads; sanitizer on {on['tok_per_s']:.1f} "
         f"tokens/s, off {off['tok_per_s']:.1f} tokens/s (on/off {on['tok_per_s'] / off['tok_per_s']:.4f}); "
         f"reports on {len(on['reports'])}; seeded inversion reports {len(seeded)}; "
         f"launches on {ln}, retrieve dispatches {on['retrieve_dispatches']}")
    require(on["reports"] == [], "(a) no sanitizer report under the burst")
    require(all(isinstance(lk, runtime.SanitizedLock) for lk in on["locks"]),
            "(a) every lock the two servers built is a SanitizedLock")
    require(not any(isinstance(lk, runtime.SanitizedLock) for lk in off["locks"]),
            "(a) the sanitizer-off servers hold plain threading locks")
    require(len(seeded) >= 1 and {seeded[0]["first"], seeded[0]["second"]}
            == {"phase26.A", "phase26.B"}, "(a) the seeded inversion is reported")
    require(on["tokens"] == off["tokens"], f"(a) the {P26_REQUESTS} streams equal the "
            "sanitizer-off server's token for token")
    require(sorted(on["answers"]) == sorted(set(qtexts))
            and all(len(v) == TOP_K for v in on["answers"].values()),
            f"(a) every retrieve answered with {TOP_K} keys")
    require(ln["paged_attn_decode"] >= 12 * st["decode_steps"] > 0,
            "(a) every decode step and layer went through paged_attn_decode")
    require(ln["flash_chunk_attn_paged"] >= 12 * st["prefill_chunks"] > 0,
            "(a) every prefill piece and layer went through flash_chunk_attn_paged")
    require(ln["wq_matmul"] >= 48 * (st["decode_steps"] + st["prefill_chunks"]),
            "(a) every layer product went through wq_matmul")
    require(ln["flash_attn"] >= MINILM_LAYERS * on["retrieve_dispatches"] > 0,
            "(a) every retrieve's encode went through flash_attn")
    return ln, chat_on


def p26_demo_exporter(gpu: str, out: dict, docs, queries, chat, rec) -> dict:
    """Phase 26 (b): ``pw.demo.replay_csv`` into the embed UDF and a
    ``DataIndex`` on the card with the exporter on, then requests to (a)'s
    chat; returns the launches."""
    import tempfile
    import threading

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch import BruteForceKnnIndex
    from pathway_tpu_torch.engine import tracing
    from pathway_tpu_torch.xpacks import llm

    model = out["emb"]
    texts, q_texts = docs[:P26_DOCS], queries[:P26_QUERIES]
    rows, replies, lock = {}, {}, threading.Lock()
    export_s = [0.0, 0]
    real_export = tracing._export_otel

    def timed_export(span_dict):
        t = time.perf_counter()
        real_export(span_dict)
        export_s[0] += time.perf_counter() - t
        export_s[1] += 1

    tracing._export_otel = timed_export
    tracing._telemetry = None  # built anew, against the recorder
    pw.set_monitoring_config(server_endpoint=P26_ENDPOINT)
    counter = EncodeCount(model)
    for f in counters().values():
        f.launches = 0
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "docs.csv")
            import csv

            with open(path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["doc_id", "text"])
                w.writerows((i, t) for i, t in enumerate(texts))
            pw.clear_graph()

            class Doc(pw.Schema):
                doc_id: int
                text: str

            table = pw.demo.replay_csv(path, schema=Doc, input_rate=0)
            emb = llm.SentenceTransformerEmbedder(model, max_batch_size=RAG_BATCH)
            vecs = table.select(table.doc_id, table.text, vec=emb(table.text))
            index = pw.indexing.DataIndex(vecs, pw.indexing.BruteForceKnn(
                vecs.vec, dimensions=model.cfg.hidden, reserved_space=P26_DOCS,
                metric="cos", device=model.device))
            indexed = threading.Event()

            class Queries(pw.io.python.ConnectorSubject):
                def run(self):  # asked once every doc is in the index
                    if not indexed.wait(P26_TIMEOUT):
                        raise TimeoutError("the demo stream never reached the index whole")
                    for q in q_texts:
                        self.next(q=q)
                    self.commit()

            qt = pw.io.python.read(Queries(), schema=pw.schema_from_types(q=str))
            res = index.query_as_of_now(qt.select(qt.q, qv=emb(qt.q)).qv,
                                        number_of_matches=P26_K, with_distances=True)
            res = res.select(res.doc_id, res._pw_dist, q=qt.restrict(res).q)

            def on_row(key, row, time, is_addition):
                with lock:
                    if is_addition:
                        rows[row["doc_id"]] = (row["text"], row["vec"])
                    if len(rows) >= P26_DOCS:
                        indexed.set()

            def on_reply(key, row, time, is_addition):
                with lock:
                    if is_addition:
                        replies[row["q"]] = list(zip(row["doc_id"], row["_pw_dist"]))

            pw.io.subscribe(vecs, on_change=on_row)
            pw.io.subscribe(res, on_change=on_reply)
            mark = rec.mark()
            torch.cuda.synchronize()
            t_run = time.perf_counter()
            pw.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_run
            run_spans = [s for s in rec.since(mark) if s[0] == "pathway-tpu.run"]
            spans_in_run, export_in_run = export_s[1], export_s[0]
        n_encodes = len(counter.sizes)
        launches = {n: f.launches for n, f in counters().items()}
        # 8 requests to (a)'s chat, each finished span exported once
        mark = rec.mark()
        reqs = chat.submit_batch(make_prompts(P26_WRITE_REQUESTS, 16, 200, seed=27))
        chat.resolve_batch([reqs])
        for r in reqs:
            require(r.done.wait(P26_TIMEOUT), "(b) a request finished")
        decode_spans = [s for s in rec.since(mark) if s[0] == "pathway_tpu.decode"]
        ring = {str(t["id"]): t for t in chat.recent_traces()}
        launches = {n: launches[n] + f.launches for n, f in counters().items()}
    finally:
        counter.close()
        tracing._export_otel = real_export
        pw.set_monitoring_config(server_endpoint=None)
        tracing._telemetry = None
    info(f"demo + exporter (b) [{gpu}]: pw.demo.replay_csv of {P26_DOCS} docs -> embed UDF "
         f"-> DataIndex, {P26_QUERIES} queries, one pw.run() {wall:.3f} s "
         f"({P26_DOCS / wall:.1f} docs/s); {n_encodes} encodes, flash_attn launches "
         f"{launches['flash_attn']}; exporter: {spans_in_run} spans in the run, "
         f"{export_in_run * 1e3:.3f} ms exporting ({export_in_run / wall * 100:.4f}% of the "
         f"run's wall, {export_in_run / max(spans_in_run, 1) * 1e6:.2f} us a span)")
    require(sorted(rows) == list(range(P26_DOCS))
            and all(rows[i][0] == texts[i] for i in range(P26_DOCS)),
            "(b) the rows equal the CSV's")
    direct = np.concatenate([model.embed_batch(texts[s:s + RAG_BATCH])
                             for s in range(0, P26_DOCS, RAG_BATCH)]).astype(np.float32)
    vec = np.asarray([rows[i][1] for i in range(P26_DOCS)], dtype=np.float32)
    cos = np.sum(vec * direct, axis=1) / (np.linalg.norm(vec, axis=1)
                                          * np.linalg.norm(direct, axis=1))
    require(cos.min() >= C4_COS_MIN,
            f"(b) vectors within cosine {C4_COS_MIN} of direct encodes (min {cos.min():.6f})")
    require(launches["flash_attn"] >= MINILM_LAYERS * n_encodes > 0,
            "(b) every encode went through flash_attn")
    ref = BruteForceKnnIndex(model.cfg.hidden, reserved_space=P26_DOCS, metric="cos",
                             device=model.device)
    ref.add(list(range(P26_DOCS)), direct)
    want = dict(zip(q_texts, ref.search(model.embed_batch(q_texts), P26_K)))
    agree = sum(q in replies and ranks_agree(want[q], [(d, -s) for d, s in replies[q]],
                                             P26_TIE_TOL) for q in q_texts)
    require(agree == P26_QUERIES,
            f"(b) each top-{P26_K} equals a direct index's but at gaps < {P26_TIE_TOL} "
            f"({agree}/{P26_QUERIES})")
    require(len(run_spans) == 1 and run_spans[0][1]["operators"] > 0
            and "llm" in run_spans[0][1]["xpacks"].split(","),
            f"(b) one pathway-tpu.run span naming the llm xpack ({run_spans[:1]})")
    keys_ok = all(
        {"pathway_tpu.request_id", "pathway_tpu.server"}
        | {f"pathway_tpu.{k}" for k in ring[s[1]["pathway_tpu.request_id"]]["metrics"]}
        == set(s[1]) and [e[0] for e in s[2]]
        == [e["name"] for e in ring[s[1]["pathway_tpu.request_id"]]["events"]]
        for s in decode_spans if s[1]["pathway_tpu.request_id"] in ring)
    ids = [s[1]["pathway_tpu.request_id"] for s in decode_spans]
    info(f"  exporter: {len(decode_spans)} decode spans for {P26_WRITE_REQUESTS} requests, "
         f"attribute keys {sorted(decode_spans[0][1]) if decode_spans else []}")
    require(len(decode_spans) == P26_WRITE_REQUESTS == len(set(ids))
            and all(i in ring for i in ids) and keys_ok,
            "(b) one exported span per finished request, with JAX's attribute keys")
    pw.clear_graph()
    return launches


def p26_page(idx: int):
    """A slide page image whose first pixel carries its index (the fake
    vision model reads it back)."""
    import PIL.Image

    px = np.full((48, 64, 3), 255, dtype=np.uint8)
    px[0, 0] = (idx // 256, idx % 256, 7)
    px[8:40, 8:56] = (idx * 37) % 256
    return PIL.Image.fromarray(px)


def p26_fake_openai(texts: list[str], calls: list):
    """A stand-in ``openai`` module: chat completions over a vision message
    answer with the text of the page whose index the image's first pixel
    carries (the PNG is decoded from the message's data URL)."""
    import base64
    import importlib.machinery
    import io
    import types

    import PIL.Image

    class Completions:
        async def create(self, **kw):
            url = kw["messages"][-1]["content"][1]["image_url"]["url"]
            img = PIL.Image.open(io.BytesIO(base64.b64decode(url.split(",", 1)[1])))
            r, g, _ = img.convert("RGB").getpixel((0, 0))
            calls.append((kw["model"], r * 256 + g))
            content = f"slide {r * 256 + g}: {texts[r * 256 + g]}"
            return types.SimpleNamespace(choices=[types.SimpleNamespace(
                message=types.SimpleNamespace(content=content))])

    class AsyncOpenAI:
        def __init__(self, **kw):
            self.chat = types.SimpleNamespace(completions=Completions())

    mod = types.ModuleType("openai")
    mod.__spec__ = importlib.machinery.ModuleSpec("openai", None)
    mod.AsyncOpenAI = AsyncOpenAI
    return mod


def p26_slides(gpu: str, out: dict, docs) -> int:
    """Phase 26 (c): 8 decks of 4 pages through ``SlideParser`` with an
    ``OpenAIChat`` inside a ``DocumentStore``, the chunks through the embed
    UDF on the card, then a retrieve; returns the flash_attn launches."""
    import threading

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory
    from pathway_tpu_torch.xpacks import llm
    from pathway_tpu_torch.xpacks.llm.parsers import SlideParser

    model = out["emb"]
    n = P26_DECKS * P26_PAGES
    texts = docs[:n]
    decks = {f"deck{d}".encode(): [p26_page(d * P26_PAGES + p) for p in range(P26_PAGES)]
             for d in range(P26_DECKS)}
    host = sorted((f"slide {d * P26_PAGES + p}: {texts[d * P26_PAGES + p]}",
                   (f"deck{d}.pdf", p + 1, P26_PAGES))
                  for d in range(P26_DECKS) for p in range(P26_PAGES))
    calls: list = []
    saved = sys.modules.get("openai")
    sys.modules["openai"] = p26_fake_openai(texts, calls)
    chunks, replies, lock = {}, {}, threading.Lock()
    q_idx = [0, 5, 10, 15, 20, 25, 30, 31]
    counter = EncodeCount(model)
    FA.flash_attn.launches = 0
    try:
        pw.clear_graph()
        schema = pw.schema_from_types(data=bytes, _metadata=pw.Json)
        deck_table = pw.debug.table_from_rows(schema, [
            (k, pw.Json({"path": f"{k.decode()}.pdf"})) for k in decks])
        parser = SlideParser(llm=llm.llms.OpenAIChat(model="gpt-4o-mini"),
                             page_renderer=lambda data: decks[data])
        emb = llm.SentenceTransformerEmbedder(model, max_batch_size=RAG_BATCH)
        store = llm.DocumentStore(deck_table, retriever_factory=BruteForceKnnFactory(
            dimensions=model.cfg.hidden, embedder=emb, reserved_space=n, metric="cos",
            device=model.device), parser=parser)
        indexed = threading.Event()

        class Queries(pw.io.python.ConnectorSubject):
            def run(self):  # asked once every chunk is in
                if not indexed.wait(P26_TIMEOUT):
                    raise TimeoutError("the slide chunks never all reached the store")
                for i in q_idx:
                    self.next(query=f"slide {i}: {texts[i]}", k=1, metadata_filter=None,
                              filepath_globpattern=None)
                self.commit()

        qt = pw.io.python.read(Queries(), schema=llm.DocumentStore.RetrieveQuerySchema)
        res = store.retrieve_query(qt)
        res = res.select(res.result, query=qt.restrict(res).query)

        def on_chunk(key, row, time, is_addition):
            with lock:
                if is_addition:
                    m = row["metadata"].value
                    chunks[key.value] = (row["text"], (m["path"], m["page_number"],
                                                       m["page_count"]))
                if len(chunks) >= n:
                    indexed.set()

        def on_reply(key, row, time, is_addition):
            with lock:
                if is_addition:
                    replies[row["query"]] = row["result"].value

        pw.io.subscribe(store.chunked_docs, on_change=on_chunk)
        pw.io.subscribe(res, on_change=on_reply)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pw.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        counter.close()
        if saved is None:
            sys.modules.pop("openai", None)
        else:
            sys.modules["openai"] = saved
    launches, n_encodes = FA.flash_attn.launches, len(counter.sizes)
    got = sorted(chunks.values())
    info(f"slides (c) [{gpu}]: {P26_DECKS} decks x {P26_PAGES} pages -> SlideParser("
         f"OpenAIChat) -> DocumentStore -> embed UDF, {len(q_idx)} retrieves; pw.run() "
         f"{wall:.3f} s; {len(calls)} vision calls, {n_encodes} encodes, flash_attn "
         f"launches {launches}")
    require(got == host, "(c) the chunks and their page metadata equal the host model's")
    require(len(calls) == n and all(m == "gpt-4o-mini" for m, _ in calls),
            "(c) one vision call a page, with the chat's model")
    top = {q: (r[0]["text"], r[0]["metadata"]["page_number"]) for q, r in replies.items()
           if r}
    require(all(top.get(f"slide {i}: {texts[i]}") == (f"slide {i}: {texts[i]}",
                                                         i % P26_PAGES + 1)
                for i in q_idx), "(c) each page's own text retrieves that page first")
    require(launches >= MINILM_LAYERS * n_encodes > 0,
            "(c) every encode went through flash_attn")
    pw.clear_graph()
    return launches


def run_sanitizer_demo_slides(gpu: str, common, out: dict, docs, queries) -> dict:
    """Phase 26; returns the launches of the five entry points."""
    t0 = time.perf_counter()
    a, chat = p26_sanitized_serving(gpu, common, out["pipe"], queries)
    t1 = time.perf_counter()
    try:
        with P26Recorder() as rec:
            b = p26_demo_exporter(gpu, out, docs, queries, chat, rec)
    finally:
        chat.close()
    t2 = time.perf_counter()
    c = p26_slides(gpu, out, docs)
    t3 = time.perf_counter()
    info(f"phase 26 [{gpu}]: {t3 - t0:.1f} s ((a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, "
         f"(c) {t3 - t2:.1f})")
    launches = {n: a[n] + b[n] for n in a}
    launches["flash_attn"] += c
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    from pathway_tpu_torch import HashTokenizer, kernels, native
    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.models.tokenizer import pad_to_buckets
    from pathway_tpu_torch.models.transformer import MINILM_L6

    def done(n: int) -> None:  # where the script's time goes, for the next cut
        info(f"phase {n} done at {time.perf_counter() - T_START:.1f} s [{gpu}]")

    # phase 1: device
    gpu = gpu_line()
    info(f"gpu: {gpu}")
    info(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
         f"{torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32

    done(1)
    # phase 2: build (the CUDA kernels, the C++ tokenizers and the engine's
    # C++ loops at once)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        tok_build = pool.submit(native.build)
        engine_build = pool.submit(native.build, native._ENGINE_SRC)
        kernels.build()
        tok_lib, engine_lib = tok_build.result(), engine_build.result()
    info(f"build: {time.perf_counter() - t0:.1f} s for {sorted(kernels.KERNELS)}, "
         f"{tok_lib.name} and {engine_lib.name}")

    done(2)
    # phase 3: kernel vs plain
    worst = check_flash_attn(dev)
    docs, queries = corpus()
    _, mask = pad_to_buckets(*HashTokenizer(max_length=64)(docs[:INGEST_BATCH]))
    timing = time_flash_attn(dev, torch.from_numpy(mask).to(dev))
    info(f"flash_attn at {timing['shape']} bf16 [{gpu}]: kernel {timing['ms']:.4f} ms, "
         f"plain {timing['plain_ms']:.4f} ms, sdpa {timing['library_ms']:.4f} ms, "
         f"bound {timing['bound_ms']:.4f} ms ({timing['bound_by']}), "
         f"max abs err over all cases {worst:.3e}")

    done(3)
    # phase 4: main path (warm the libraries first, outside the count)
    run_main_path(dev, docs[:512], queries[:16], MINILM_L6, batch=256,
                  rerank_k=8, n_lat=2)
    FA.flash_attn.launches = 0
    out = run_main_path(dev, docs, queries, MINILM_L6)
    launches = FA.flash_attn.launches
    need = MINILM_L6.layers * out["encodes"]
    info(f"main path: {out['encodes']} encoder calls, flash_attn launches "
         f"{launches} (need >= {need})")
    if launches < need:
        raise AssertionError("an encode did not go through the flash_attn kernel")
    info(f"ingest [{gpu}]: {out['ingest_docs_per_s']:.1f} docs/s over {N_DOCS} docs")
    info(f"retrieve [{gpu}]: p50 {out['retrieve_p50_ms']:.3f} ms (1 query, k={TOP_K}); "
         f"recall@10 {out['recall_at_10']:.4f}")
    info(f"retrieve+rerank [{gpu}]: p50 {out['rerank_p50_ms']:.3f} ms (1 query, k={RERANK_K}); "
         f"batch of 8 {out['rerank_batch8_ms']:.3f} ms")
    if out["recall_at_10"] < 0.9:
        raise AssertionError(f"recall@10 {out['recall_at_10']:.4f} < 0.9")
    check_against_cpu(out["emb"], MINILM_L6, docs, queries)

    done(4)
    # phase 5: the decoder's kernels against their plain versions, timed
    rows = {"paged_attn_decode": check_paged_decode(dev)}
    rows["flash_chunk_attn"], rows["flash_chunk_attn_paged"] = check_flash_chunk(dev)
    rows["wq_matmul"] = check_wq_matmul(dev)
    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        info(f"{name} at {r['shape']} [{gpu}]: kernel {r['ms']:.4f} ms, plain "
             f"{r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.4f} ms "
             f"({r['bound_by']}), max abs err {r['max_abs_err']:.3e}")
    r = rows["wq_matmul"]
    info(f"wq_matmul [{gpu}]: per decode layer L2-cold (12 layers' weights) "
         f"{r['ms_l2_cold']:.4f} ms, prefill piece (M = 64) {r['ms_m64']:.4f} ms; "
         f"blocks per product at M = 16 {r['blocks']}")
    r = rows["flash_chunk_attn"]
    info(f"flash_chunk_attn [{gpu}]: {r['blocks']} blocks; split widths "
         + "; ".join(f"{c}: {ms:.4f} ms" for c, ms in r["split_ms"].items()))
    info(f"paged_attn_decode [{gpu}]: split plans "
         + "; ".join(f"{c}: {ms:.4f} ms" for c, ms in rows["paged_attn_decode"]["split_ms"].items()))

    done(5)
    # phase 6: the answer-LLM main path
    params, tok, common = decoder_setup(dev)
    dec = run_decoder(dev, gpu, params, tok, common)

    done(6)
    # phase 7: shared-prompt serving through the prefix cache
    check_shared_blocks(dev)
    shared = run_shared_prompt(gpu, tok, common)
    dec = {n: dec[n] + shared[n] for n in dec}

    done(7)
    # phase 8: ingest through the embedder seam at full MiniLM-L6 width
    seam_launches = run_ingest_seam(dev, gpu, docs)

    done(8)
    # phase 9: checkpoints on the card
    ckpt = run_checkpoints(dev, gpu, docs)
    dec = {n: dec[n] + ckpt[n] for n in dec}

    done(9)
    # phase 10: spec decode and chunk autotune, the default decode schedule
    check_spec_pool(dev, gpu, params, tok)
    spec = run_spec_serving(gpu, tok, common)
    dec = {n: dec[n] + spec[n] for n in dec}

    done(10)
    # phase 11: telemetry on the card, metrics on (the default) against off
    tele = run_telemetry_serving(dev, gpu, common)
    dec = {n: dec[n] + tele[n] for n in dec}
    seam_launches += run_telemetry_ingest(dev, gpu, docs)
    launches += check_query_dispatches(out["pipe"], queries)

    done(11)
    # phase 12: supervision and the query server
    sup = run_supervision_serving(dev, gpu, common)
    sup["flash_attn"] += run_ingest_chaos(dev, gpu, docs) + run_query_server(out["pipe"], gpu)
    info(f"supervision: phase 12 launches {sup}")
    require(all(v > 0 for v in sup.values()), "phase 12 drove all five kernel entry points")
    dec = {n: dec[n] + sup[n] for n in dec}

    done(12)
    # phase 13: disaggregated lanes, tenant scheduling, the serving fleet
    lanes = run_lanes_tenants_fleet(dev, gpu, common)
    info(f"lanes, tenants and fleet: phase 13 launches {lanes}")
    require(all(lanes[n] > 0 for n in ("flash_chunk_attn_paged", "paged_attn_decode",
                                       "wq_matmul")),
            "phase 13 drove flash_chunk_attn_paged, paged_attn_decode and wq_matmul")
    dec = {n: dec[n] + lanes[n] for n in dec}

    done(13)
    # phase 14: the RAG retrieval variants at phase 4's settings
    variants = run_int8_encoders(dev, gpu, docs, queries, out["pipe"])
    run_ann(dev, gpu, docs, queries)
    late, l_emb, l_ce = run_late_bank(dev, gpu, docs, queries)
    listwise = run_llm_rerank(dev, gpu, common, l_emb, l_ce, docs, queries)
    info(f"retrieval variants: phase 14 flash_attn launches (a)-(c) {variants + late}, "
         f"(d) {listwise}")
    require(variants > 0 and late > 0 and all(
        listwise[n] > 0 for n in ("flash_attn", "flash_chunk_attn_paged", "paged_attn_decode",
                                  "wq_matmul")),
            "phase 14 drove flash_attn in (a)-(c) and flash_attn, flash_chunk_attn_paged, "
            "paged_attn_decode and wq_matmul in (d)")
    launches += variants + late
    dec = {n: dec[n] + listwise[n] for n in dec}

    done(14)
    # phase 15: the parallel layer and the serving mesh
    t15 = time.perf_counter()
    trivial = run_mesh_trivial(dev, gpu, common)
    tp_launches, tp_params = run_mesh_tp(dev, gpu, tok)
    launches += run_mesh_retrieval(dev, gpu, out, docs, queries)
    launches += run_ring_attention(dev, gpu)
    run_mesh_checkpoints(dev, gpu, params, tp_params)
    mesh_launches = {n: trivial[n] + tp_launches[n] for n in dec}
    info(f"mesh: phase 15 serving launches {mesh_launches}; "
         f"{time.perf_counter() - t15:.1f} s")
    dec = {n: dec[n] + mesh_launches[n] for n in dec}

    done(15)
    # phase 16: the dataflow engine's config-4 program at full width
    launches += run_engine_config4(dev, gpu)

    done(16)
    # phase 17: BASELINE configs 2 and 3 through pw.run() and the REST servers
    rag = run_rag_apps(dev, gpu, out, docs, queries, common)
    dec = {n: dec[n] + rag[n] for n in dec}

    done(17)
    # phase 18: BASELINE configs 1, 2 and 5 through the file connectors and
    # the index factories
    files = run_file_connectors(dev, gpu, out, docs, queries)
    dec = {n: dec[n] + files[n] for n in dec}

    done(18)
    # phase 19: an event-time windowed embed stream through pw.temporal
    launches += run_temporal_stream(dev, gpu)

    done(19)
    # phase 20: two processes sharing the card (the row exchange, iterate)
    launches += run_multiprocess(gpu, docs, queries, out["truth"])

    done(20)
    # phase 21: pw.ml, rag_eval with the observability routes, the fleet
    # over processes
    t21 = time.perf_counter()
    launches += run_ml(dev, gpu, out, docs[:ML_DOCS], queries)
    ev = run_rag_eval_phase(dev, gpu, out, common)
    fl = run_fleet_processes(gpu, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                               "chiprun_out", "phase21"))
    require(all(fl[n] > 0 for n in ("flash_chunk_attn_paged", "paged_attn_decode", "wq_matmul")),
            "(c) the replicas drove flash_chunk_attn_paged, paged_attn_decode and wq_matmul")
    dec = {n: dec[n] + ev[n] + fl[n] for n in dec}
    info(f"phase 21: {time.perf_counter() - t21:.1f} s")

    done(21)
    # phase 22: persistence, a streaming RAG ingest that stops or is killed
    # and resumes exactly once
    launches += run_persistence(gpu, out, docs, queries)

    done(22)
    # phase 23: a CDC-fed index shared through an export (Debezium and
    # SQLite into the embed UDF, export_table, import_table in a second
    # program, a Postgres snapshot sink)
    launches += run_cdc_share(gpu, out, docs, queries)

    done(23)
    # phase 24: training on the card (contrastive and causal LM, dp x tp
    # sharded steps, the RAG answer gate on a decoder trained here, spawn)
    trained, gate = run_training(dev, gpu, docs, queries)
    launches += trained
    dec = {n: dec[n] + gate[n] for n in dec}

    done(24)
    # phase 25: the autotuner with its trials on the card; an Airbyte
    # source through pw.sql and a row transformer into the embed UDF
    tuned, p25_launches = run_tuning_airbyte(dev, gpu, params, out, docs, queries)
    launches += p25_launches
    dec = {n: dec[n] + tuned[n] for n in dec}

    done(25)
    # phase 26: serving under the lock sanitizer, the demo stream into the
    # index with the OpenTelemetry exporter on, slides through a client UDF
    p26 = run_sanitizer_demo_slides(gpu, common, out, docs, queries)
    launches += p26["flash_attn"]
    dec = {n: dec[n] + (p26[n] if n != "flash_attn" else 0) for n in dec}
    info(f"phase 26 launches {p26}")

    done(26)

    kernel_rows = [{
        "name": "flash_attn", "route": "cuda",
        "source": "pathway_tpu_torch/csrc/flash_attn.cu",
        "replaces": "pathway_tpu/models/flash_attention.py:116",
        "design": DESIGN["flash_attn"],
        "launches": launches + seam_launches + dec["flash_attn"],
        "max_abs_err": max(worst, timing["max_abs_err"]), "ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": timing["library_ms"],
    }]
    for name, src, replaces in (
        ("flash_chunk_attn", "flash_chunk.cu", "pathway_tpu/models/flash_attention.py:263"),
        ("flash_chunk_attn_paged", "flash_chunk.cu", "pathway_tpu/models/flash_attention.py:263"),
        ("paged_attn_decode", "paged_attn.cu", "pathway_tpu/models/paged_attention.py:49"),
        ("wq_matmul", "wq_matmul.cu", "pathway_tpu/models/wq_matmul.py:64"),
    ):
        r = rows[name]
        kernel_rows.append({
            "name": name, "route": "cuda", "source": f"pathway_tpu_torch/csrc/{src}",
            "replaces": replaces, "design": DESIGN[name], "launches": dec[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **{k: r[k] for k in ("ms_l2_cold", "ms_m64", "split_ms") if k in r},
        })
    info(f"chip_smoke: {time.perf_counter() - T_START:.1f} s wall")
    print(gpu, flush=True)
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase20-child"]:
        sys.exit(mp_child(sys.argv[2]))
    if sys.argv[1:2] == ["--phase21-replica"]:
        sys.exit(p21_replica(sys.argv[2:]))
    if sys.argv[1:2] == ["--phase22-child"]:
        sys.exit(p22_child(sys.argv[2]))
    if sys.argv[1:2] == ["--phase24-child"]:
        sys.exit(p24_child(sys.argv[2]))
    sys.exit(main())
