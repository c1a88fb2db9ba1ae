"""The port stands alone: no module of pathway_tpu_torch, nor
chip_smoke.py or tools/, imports JAX or the JAX package or reads a
``PATHWAY_TPU_*`` environment variable; every CUDA source
is bound in kernels.py, and the C++ tokenizer source lives in the port;
entry points (the embedder and reranker seams and the checkpoint loaders'
entry points included) refuse to run on the CPU unless asked; CPU tensors
never launch a kernel; the decoder server refuses the JAX serving features
it does not carry and constructs the ones it does. The dataflow engine's
modules are under the same scans; its embed UDF and KNN index refuse the
CPU unless asked, and a config-4 program on CPU tensors launches no
kernel."""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import pathway_tpu_torch
from pathway_tpu_torch import (
    BruteForceKnnIndex,
    CrossEncoderModel,
    HashTokenizer,
    SentenceEmbedderModel,
)
from pathway_tpu_torch import DecoderChat, kernels
from pathway_tpu_torch.device import resolve_device
from pathway_tpu_torch.models import decoder as TD
from pathway_tpu_torch.models import flash_attention as TFA
from pathway_tpu_torch.models import paged_attention as TPA
from pathway_tpu_torch.models import wq_matmul as TWQ
from pathway_tpu_torch.models.bpe import BPETokenizer, bytes_to_unicode
from pathway_tpu_torch.models.transformer import TransformerConfig

ROOT = Path(pathway_tpu_torch.__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "pathway_tpu")


def _sources():
    files = sorted((ROOT / "pathway_tpu_torch").rglob("*.py"))
    return files + sorted((ROOT / "tools").glob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_port_imports_no_jax_and_no_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree)
           if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
    assert not bad, f"{path.name} imports {bad}"


def test_source_scan_sees_the_whole_package():
    names = {p.name for p in _sources()}
    assert {"chip_smoke.py", "flash_attention.py", "fused_query.py",
            "knn.py", "kernels.py", "profile_rag_path.py", "decoder.py",
            "paged_attention.py", "wq_matmul.py", "bpe.py", "llms.py",
            "prefix_cache.py", "probes.py", "async_runtime.py",
            "checkpoint.py", "embedders.py", "rerankers.py", "tokenizer.py",
            "embedder.py", "tracing.py", "http_server.py"} <= names
    assert ROOT / "pathway_tpu_torch" / "native" / "__init__.py" in _sources()
    for rel in ("engine/tracing.py", "internals/http_server.py"):
        assert ROOT / "pathway_tpu_torch" / rel in _sources()


def test_source_scan_sees_the_retrieval_variants():
    names = {p.name for p in _sources()}
    assert {"ivf.py", "hnsw.py", "late_bank.py", "transformer.py", "cross_encoder.py",
            "query_server.py"} <= names


def test_source_scan_sees_the_parallel_layer():
    files = set(_sources())
    pkg = ROOT / "pathway_tpu_torch"
    for rel in ("parallel/__init__.py", "parallel/mesh.py", "parallel/distributed.py",
                "parallel/sharded_knn.py", "parallel/sharded_ivf.py",
                "parallel/ring_attention.py", "engine/state.py", "models/moe.py",
                "models/pipeline.py"):
        assert pkg / rel in files, rel


def test_source_scan_sees_the_engine():
    files = set(_sources())
    pkg = ROOT / "pathway_tpu_torch"
    for rel in ("engine/value.py", "engine/xxh64.py", "engine/batch.py",
                "engine/clock.py", "engine/graph.py", "engine/scheduler.py",
                "engine/expression_eval.py", "engine/method_impl.py",
                "engine/reducers_impl.py", "engine/operators/core.py",
                "engine/operators/reduce.py", "engine/operators/output.py",
                "engine/operators/external_index.py", "internals/config.py",
                "internals/table.py", "internals/run.py", "internals/udfs/__init__.py",
                "internals/udfs/executors.py", "internals/udfs/caches.py",
                "io/kafka.py", "io/python.py", "io/_streams.py", "io/_utils.py",
                "debug/__init__.py", "stdlib/indexing/data_index.py",
                "stdlib/indexing/nearest_neighbors.py", "xpacks/llm/embedders.py"):
        assert pkg / rel in files, rel


def test_source_scan_sees_the_rag_apps():
    files = set(_sources())
    pkg = ROOT / "pathway_tpu_torch"
    for rel in ("engine/operators/join.py", "internals/joins.py", "internals/join_mode.py",
                "internals/monitoring.py", "io/http.py", "xpacks/llm/__init__.py",
                "xpacks/llm/_utils.py", "xpacks/llm/constants.py",
                "xpacks/llm/_parser_utils.py", "xpacks/llm/prompts.py",
                "xpacks/llm/splitters.py", "xpacks/llm/parsers.py",
                "xpacks/llm/rerankers.py", "xpacks/llm/llms.py",
                "xpacks/llm/document_store.py", "xpacks/llm/vector_store.py",
                "xpacks/llm/question_answering.py", "xpacks/llm/servers.py"):
        assert pkg / rel in files, rel


def test_source_scan_sees_the_connectors_and_exports():
    files = set(_sources())
    pkg = ROOT / "pathway_tpu_torch"
    for rel in ("io/_object_store.py", "io/s3.py", "io/s3_csv.py", "io/minio.py",
                "io/pyfilesystem.py", "io/gdrive.py", "io/debezium.py", "io/deltalake.py",
                "io/sqlite.py", "io/postgres.py", "io/nats.py", "io/mongodb.py",
                "io/elasticsearch.py", "io/bigquery.py", "io/pubsub.py", "io/logstash.py",
                "io/slack.py", "io/redpanda.py", "internals/exported.py",
                "internals/interactive.py", "stdlib/stateful/__init__.py"):
        assert pkg / rel in files, rel


def test_source_scan_sees_training_and_the_launcher():
    files = set(_sources())
    pkg = ROOT / "pathway_tpu_torch"
    for rel in ("models/train.py", "cli.py", "internals/run.py", "debug/__init__.py",
                "io/kafka.py", "io/python.py"):
        assert pkg / rel in files, rel
    assert ROOT / "tools" / "run_phase24.py" in files


def test_training_entry_points_raise_without_cuda(monkeypatch):
    """The train states are made on the card unless asked for the CPU."""
    from pathway_tpu_torch.models import train as TT

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(vocab_size=64, hidden=16, layers=1, heads=2, intermediate=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_train_state(0, cfg)
    dcfg, _params, _tok = _tiny_decoder()
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_decoder_train_state(0, dcfg)
    state, _tx = TT.init_train_state(0, cfg, device="cpu")
    assert state.params["layers"]["qkv_w"].device.type == "cpu"


def test_rag_app_udfs_raise_without_cuda(monkeypatch):
    """The reranker and answer-LLM UDFs run on the card unless asked."""
    from pathway_tpu_torch.xpacks.llm import EncoderReranker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(vocab_size=64, hidden=16, layers=1, heads=2, intermediate=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        EncoderReranker(SentenceEmbedderModel(cfg))
    with pytest.raises(RuntimeError, match="CUDA"):
        EncoderReranker("minilm-l6")
    dcfg, params, tok = _tiny_decoder()
    with pytest.raises(RuntimeError, match="CUDA"):
        DecoderChat(params=params, cfg=dcfg, tokenizer=tok, max_new_tokens=2)


def test_rag_program_on_cpu_launches_nothing():
    """A RAG program on CPU tensors (the embed UDF into a DocumentStore,
    the cross-encoder UDF, a continuous DecoderChat as the answer UDF)
    takes every plain path: no kernel launch."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.models import flash_attention as FA
    from pathway_tpu_torch.xpacks import llm

    cfg = TransformerConfig(vocab_size=1000, hidden=16, layers=1, heads=2, intermediate=32)
    tok1k = HashTokenizer(vocab_size=1000)
    emb = llm.SentenceTransformerEmbedder(SentenceEmbedderModel(cfg, tokenizer=tok1k,
                                                                device="cpu"))
    rr = llm.CrossEncoderReranker(CrossEncoderModel(cfg, tokenizer=tok1k, device="cpu"))
    dcfg, params, tok = _tiny_decoder()
    chat = DecoderChat(params=params, cfg=dcfg, tokenizer=tok, max_new_tokens=2,
                       continuous=True, n_slots=2, device="cpu")
    counts = [FA.flash_attn, FA.flash_chunk_attn, FA.flash_chunk_attn_paged,
              TPA.paged_attn_decode, TWQ.wq_matmul]
    before = [f.launches for f in counts]
    try:
        pw.clear_graph()
        docs = pw.debug.table_from_rows(pw.schema_from_types(data=str),
                                        [("alpha beta",), ("gamma delta",)])
        store = llm.DocumentStore(docs, retriever_factory=pw.indexing.BruteForceKnnFactory(
            dimensions=16, embedder=emb, device="cpu"))
        qa = llm.BaseRAGQuestionAnswerer(chat, store, search_topk=1)
        queries = pw.debug.table_from_rows(pw.schema_from_types(
            prompt=str, filters=str | None, model=str | None, return_context_docs=bool),
            [("alpha?", None, None, True)])
        answers = qa.answer_query(queries)
        scored = docs.select(s=rr(docs.data, docs.data))
        assert len(pw.debug.table_to_dicts(answers)[1]["result"]) == 1
        assert len(pw.debug.table_to_dicts(scored)[1]["s"]) == 2
    finally:
        chat.close()
        pw.clear_graph()
    assert [f.launches for f in counts] == before


def test_engine_device_seams_raise_without_cuda(monkeypatch):
    """The embed UDF (blocking or deferred) and the KNN index of a
    ``DataIndex`` run on the card unless asked for the CPU."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.xpacks.llm import SentenceTransformerEmbedder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for deferred in (False, True):
        with pytest.raises(RuntimeError, match="CUDA"):
            SentenceTransformerEmbedder(deferred=deferred)
    pw.clear_graph()
    docs = pw.debug.table_from_rows(pw.schema_from_types(vec=np.ndarray),
                                    [(np.ones(4),)])
    index = pw.indexing.DataIndex(docs, pw.indexing.BruteForceKnn(docs.vec, dimensions=4))
    res = index.query(docs.vec, number_of_matches=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        pw.debug.table_to_dicts(res)


def test_engine_on_cpu_launches_nothing():
    """The embed UDF through the engine, deferred and blocking, on CPU
    tensors takes the plain attention: no kernel launch."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.xpacks.llm import SentenceTransformerEmbedder

    cfg = TransformerConfig(vocab_size=1000, hidden=16, layers=1, heads=2,
                            intermediate=32)
    model = SentenceEmbedderModel(cfg, tokenizer=HashTokenizer(vocab_size=1000),
                                  device="cpu")
    before = TFA.flash_attn.launches
    for deferred in (True, False):
        pw.clear_graph()
        docs = pw.debug.table_from_rows(pw.schema_from_types(text=str),
                                        [("a b c",), ("d e",)])
        emb = SentenceTransformerEmbedder(model, deferred=deferred)
        vecs = pw.debug.table_to_dicts(docs.select(v=emb(docs.text)))[1]["v"]
        assert len(vecs) == 2
    assert TFA.flash_attn.launches == before


def test_engine_reads_no_environment_and_has_one_config():
    """The engine's switches are ``EngineConfig`` fields with JAX's flag
    defaults; several processes take their process id and first port as
    fields too (a launcher's child passes them), and an id out of range is
    refused."""
    from pathway_tpu_torch.internals.config import EngineConfig

    cfg = EngineConfig()
    assert (cfg.fusion, cfg.columnar_subscribe, cfg.drain_coalesce,
            cfg.drain_coalesce_max, cfg.epoch_closeout, cfg.op_metrics,
            cfg.terminate_on_error, cfg.threads, cfg.processes, cfg.process_id,
            cfg.first_port) == (True, True, True, 8, True, True, True, 1, 1, 0, 10000)
    assert EngineConfig(processes=2, process_id=1).process_id == 1
    with pytest.raises(ValueError, match="process_id"):
        EngineConfig(processes=2, process_id=2)


def test_retrieval_variants_raise_without_cuda(monkeypatch):
    """The IVF index and the int8 encoders run on the card unless asked;
    the host-side HNSW index has no device to refuse."""
    from pathway_tpu_torch.ops.hnsw import HnswIndex
    from pathway_tpu_torch.ops.ivf import IvfFlatIndex

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(vocab_size=64, hidden=16, layers=1, heads=2, intermediate=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        IvfFlatIndex(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        SentenceEmbedderModel(cfg, weight_quant="int8")
    with pytest.raises(RuntimeError, match="CUDA"):
        CrossEncoderModel(cfg, weight_quant="int8")
    assert IvfFlatIndex(8, device="cpu")._cells.device.type == "cpu"
    assert len(HnswIndex(8)) == 0


def _environ_reads(tree):
    """Names read from the environment: ``os.environ[...]``,
    ``os.environ.get(...)`` / ``.setdefault`` / ``.pop``, ``os.getenv(...)``
    and ``environ`` imported bare, with a constant name."""
    def is_environ(node):
        return ((isinstance(node, ast.Attribute) and node.attr == "environ")
                or (isinstance(node, ast.Name) and node.id == "environ"))

    for node in ast.walk(tree):
        arg = None
        if isinstance(node, ast.Subscript) and is_environ(node.value):
            arg = node.slice
        elif isinstance(node, ast.Call) and node.args:
            f = node.func
            if isinstance(f, ast.Attribute) and is_environ(f.value):
                arg = node.args[0]
            elif (isinstance(f, ast.Attribute) and f.attr == "getenv") or (
                    isinstance(f, ast.Name) and f.id == "getenv"):
                arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            yield arg.value


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_port_reads_no_pathway_tpu_environment_variable(path):
    """The port's switches are constructor arguments and module functions
    (``probes.set_metrics``, ``tracing.configure``), never a JAX flag."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _environ_reads(tree) if n.startswith("PATHWAY_TPU_")]
    assert not bad, f"{path.name} reads {bad}"


def test_environment_scan_sees_every_read_form():
    src = ("import os\nfrom os import environ, getenv\n"
           "a = os.environ['PATHWAY_TPU_A']\nb = os.environ.get('PATHWAY_TPU_B')\n"
           "c = os.getenv('PATHWAY_TPU_C', '1')\nd = environ['PATHWAY_TPU_D']\n"
           "e = getenv('PATHWAY_TPU_E')\nf = os.environ.get('HOME')\n")
    assert sorted(_environ_reads(ast.parse(src))) == [
        "HOME", "PATHWAY_TPU_A", "PATHWAY_TPU_B", "PATHWAY_TPU_C", "PATHWAY_TPU_D",
        "PATHWAY_TPU_E"]


def test_native_tokenizer_source_is_the_ports_own():
    """The C++ tokenizers build from the port's own source into the port's
    build directory, and name only the tokenizer functions."""
    from pathway_tpu_torch import native

    assert native._SRC == ROOT / "pathway_tpu_torch" / "native" / "_tokenize.cpp"
    assert native.BUILD_DIR == ROOT / "build" / "pathway_tpu_torch"
    text = native._SRC.read_text()
    table = text[text.index("static PyMethodDef methods[]"):]
    names = sorted(set(re.findall(r'\{"(\w+)", py_', table)))
    assert names == ["hash_tokenize", "wordpiece_free", "wordpiece_load",
                     "wordpiece_tokenize"]


def test_every_cuda_source_is_bound():
    """Each csrc/*.cu is one kernel library of kernels.py, and each bound
    symbol is defined extern "C" in its source."""
    sources = {p.name for p in kernels.CSRC.glob("*.cu")}
    bound = {src for src, _ in kernels.KERNELS.values()}
    assert sources == bound == {"flash_attn.cu", "flash_chunk.cu",
                                "paged_attn.cu", "wq_matmul.cu"}
    for src, fns in kernels.KERNELS.values():
        text = (kernels.CSRC / src).read_text()
        for fn in fns:
            assert f'extern "C" cudaError_t {fn}(' in text, (src, fn)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(vocab_size=64, hidden=16, layers=1, heads=2,
                            intermediate=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        SentenceEmbedderModel()
    with pytest.raises(RuntimeError, match="CUDA"):
        CrossEncoderModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        BruteForceKnnIndex(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    from pathway_tpu_torch.xpacks.llm import CrossEncoderReranker, SentenceTransformerEmbedder

    with pytest.raises(RuntimeError, match="CUDA"):
        SentenceTransformerEmbedder()
    with pytest.raises(RuntimeError, match="CUDA"):
        CrossEncoderReranker(custom_kwargs=dict(cfg=cfg))
    dcfg, params, tok = _tiny_decoder()
    for continuous in (False, True):
        with pytest.raises(RuntimeError, match="CUDA"):
            DecoderChat(params=params, cfg=dcfg, tokenizer=tok, continuous=continuous)
    chat = DecoderChat(params=params, cfg=dcfg, tokenizer=tok, max_new_tokens=2,
                       device="cpu")
    assert len(chat(["ab"])) == 1


def _tiny_decoder():
    dcfg = TD.DecoderConfig(vocab_size=256, hidden=16, layers=1, heads=2,
                            intermediate=32, max_position=128, dtype=torch.float32)
    b2u = bytes_to_unicode()
    tok = BPETokenizer({b2u[i]: i for i in range(256)}, [])
    return dcfg, TD.init_params(torch.Generator().manual_seed(0), dcfg), tok


def test_flash_attn_on_cpu_launches_nothing():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 2, 8, 8)).astype(np.float32))
    mask = torch.ones((2, 8), dtype=torch.int32)
    before = TFA.flash_attn.launches
    TFA.flash_attn(q, q, q, mask, causal=False)
    cfg = TransformerConfig(vocab_size=1000, hidden=16, layers=1, heads=2,
                            intermediate=32)
    SentenceEmbedderModel(cfg, tokenizer=HashTokenizer(vocab_size=1000),
                          device="cpu")(["a b c"])
    assert TFA.flash_attn.launches == before


def test_decoder_kernels_on_cpu_launch_nothing():
    """A paged, int8-weight, int8-KV server run with every kernel route on
    (and a dense one with flash prefill) launches no kernel on the CPU."""
    dcfg, params, tok = _tiny_decoder()
    counters = (TPA.paged_attn_decode, TFA.flash_chunk_attn,
                TFA.flash_chunk_attn_paged, TWQ.wq_matmul, TFA.flash_attn)
    before = [f.launches for f in counters]
    for kw in (dict(paged_kv=True, paged_kernel=True, kv_quant="int8"),
               dict(paged_kv=False)):
        chat = DecoderChat(params=params, cfg=dcfg, tokenizer=tok,
                           max_new_tokens=4, max_prompt_tokens=32, continuous=True,
                           n_slots=2, chunk_steps=2, prefill_chunk=8,
                           flash_prefill=True, weight_quant="int8", wq_kernel=True,
                           device="cpu", **kw)
        try:
            out = chat(["a short one", "a prompt long enough for two pieces"])
        finally:
            chat.close()
        assert len(out) == 2 and chat.server.stats["decode_steps"] > 0
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("feature", [
    # nothing JAX's server carries is left out since the serving mesh was
    # ported: the features once refused beside it now construct
    dict(mesh="mesh1", disagg=True), dict(mesh="mesh2", tenant_sched=True),
    dict(mesh="mesh2"),
])
def test_server_refuses_features_left_out(feature):
    from pathway_tpu_torch.parallel import make_serving_mesh
    from pathway_tpu_torch.xpacks.llm import llms

    assert llms._UNPORTED == ()
    n = int(feature["mesh"][-1])
    feature = dict(feature, mesh=make_serving_mesh(["cpu"] * n, tp=n))
    dcfg, params, tok = _tiny_decoder()
    chat = DecoderChat(params=params, cfg=dcfg, tokenizer=tok, continuous=True,
                       max_new_tokens=2, device="cpu", **feature)
    try:
        assert chat.server.mesh is feature["mesh"]
    finally:
        chat.close()


def test_unported_is_empty_and_mesh_is_accepted_on_cpu():
    """``mesh=`` serves on the CPU through the plain versions: the streams
    equal the mesh-off ones and no kernel launches."""
    from pathway_tpu_torch.parallel import ShardedTensor, make_serving_mesh
    from pathway_tpu_torch.xpacks.llm import llms

    assert llms._UNPORTED == ()
    dcfg, params, tok = _tiny_decoder()
    counters = (TPA.paged_attn_decode, TFA.flash_chunk_attn,
                TFA.flash_chunk_attn_paged, TWQ.wq_matmul, TFA.flash_attn)
    before = [f.launches for f in counters]
    outs = []
    for mesh in (None, make_serving_mesh(["cpu"] * 2, data=1, fsdp=1, tp=2)):
        chat = DecoderChat(params=params, cfg=dcfg, tokenizer=tok, max_new_tokens=4,
                           max_prompt_tokens=32, continuous=True, n_slots=2,
                           chunk_steps=2, prefill_chunk=8, paged_kv=True,
                           paged_kernel=True, flash_prefill=True, weight_quant="int8",
                           wq_kernel=True, device="cpu", mesh=mesh)
        try:
            outs.append(chat(["a short one", "a prompt long enough for two pieces"]))
            if mesh is not None:
                assert isinstance(chat.server.pool["kb"], ShardedTensor)
        finally:
            chat.close()
    assert outs[0] == outs[1]
    assert [f.launches for f in counters] == before


def test_server_constructs_spec_decode_and_chunk_autotune():
    """Speculative decode and chunk autotune are carried: asked for, a
    2-layer greedy server constructs with both on and serves."""
    dcfg, params, tok = _tiny_decoder()
    dcfg = TD.DecoderConfig(**{**dcfg.__dict__, "layers": 2})
    params = TD.init_params(torch.Generator().manual_seed(0), dcfg)
    chat = DecoderChat(params=params, cfg=dcfg, tokenizer=tok, continuous=True,
                       max_new_tokens=4, max_prompt_tokens=16, n_slots=2,
                       spec_decode=True, chunk_autotune=True, device="cpu")
    try:
        srv = chat.server
        assert srv.spec_decode and srv.chunk_autotune
        assert srv._step_cands == [16, 8, 4] and srv.spec_draft_layers == 1
        req = srv.submit(tok.encode("ab"), 4)
        assert req.done.wait(60) and len(req.tokens) == 4
        assert srv.stats["spec_dispatches"] > 0
    finally:
        chat.close()
    assert not srv.thread.is_alive()


def test_source_scan_sees_the_tuner_and_the_sql_surface():
    files = set(_sources())
    pkg = ROOT / "pathway_tpu_torch"
    for rel in ("tuning/__init__.py", "tuning/profiles.py", "tuning/search.py",
                "io/airbyte.py", "internals/row_transformer.py", "internals/sql.py",
                "internals/yaml_loader.py", "asynchronous.py",
                "engine/operators/row_transformer.py"):
        assert pkg / rel in files, rel


def test_yaml_and_google_are_imported_lazily():
    """The card's machine has no ``yaml``: importing the package, the
    Airbyte reader and the YAML loader must not need it (nor
    ``google.oauth2``)."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['yaml'] = None; sys.modules['google'] = None\n"
            "import pathway_tpu_torch as pw, pathway_tpu_torch.io.airbyte\n"
            "import pathway_tpu_torch.internals.yaml_loader\n"
            "print(pw.load_yaml.__name__, pw.io.airbyte.read.__name__)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["load_yaml", "read"]


def test_source_scan_sees_the_last_modules():
    files = set(_sources())
    pkg = ROOT / "pathway_tpu_torch"
    for rel in ("analysis/__init__.py", "analysis/__main__.py", "analysis/annotations.py",
                "analysis/core.py", "analysis/flag_hygiene.py", "analysis/jit_purity.py",
                "analysis/kill_switch.py", "analysis/lock_discipline.py",
                "analysis/runtime.py", "internals/telemetry.py", "demo/__init__.py",
                "stdlib/viz/plotting.py", "stdlib/viz/table_viz.py",
                "xpacks/connectors/sharepoint/__init__.py", "optional_import.py",
                "native/binding.py"):
        assert pkg / rel in files, rel
    assert ROOT / "tools" / "run_phase26.py" in files


def test_optional_sdks_are_imported_lazily():
    """Importing the package, the analysis CLI, the clients, viz and
    SharePoint needs none of the optional SDKs (none is on the card's
    machine): each is imported when its class is built or called."""
    import subprocess
    import sys

    sdks = ("openai", "litellm", "cohere", "flashrank", "google.generativeai",
            "bokeh", "panel", "office365", "opentelemetry", "pdf2image")
    code = ("import sys\n"
            f"for m in {sdks!r}: sys.modules[m] = None\n"
            "import pathway_tpu_torch as pw, pathway_tpu_torch.analysis.__main__\n"
            "from pathway_tpu_torch.xpacks.llm import embedders, llms, parsers, rerankers\n"
            "from pathway_tpu_torch.xpacks.connectors import sharepoint\n"
            "print(pw.viz.__name__, pw.demo.__name__, llms.OpenAIChat.__name__,\n"
            "      parsers._LazyVisionLLM._inner)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["pathway_tpu_torch.stdlib.viz", "pathway_tpu_torch.demo",
                                   "OpenAIChat", "None"]
