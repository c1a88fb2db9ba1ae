"""The port stands alone: no module of pathway_tpu_torch, nor
chip_smoke.py or tools/, imports JAX or the JAX package or reads a
``PATHWAY_TPU_*`` environment variable; every CUDA source
is bound in kernels.py, and the C++ tokenizer source lives in the port;
entry points (the embedder and reranker seams and the checkpoint loaders'
entry points included) refuse to run on the CPU unless asked; CPU tensors
never launch a kernel; the decoder server refuses the JAX serving features
it does not carry and constructs the ones it does."""

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
    dict(disagg=True), dict(tenant_sched=True), dict(mesh=object()),
])
def test_server_refuses_features_left_out(feature):
    dcfg, params, tok = _tiny_decoder()
    with pytest.raises(NotImplementedError, match="not ported"):
        DecoderChat(params=params, cfg=dcfg, tokenizer=tok, continuous=True,
                    device="cpu", **feature)


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
