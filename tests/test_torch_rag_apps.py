"""The RAG applications served over REST by both packages, at a small
size, threaded on port 0: ``VectorStoreServer.run_server`` answers
``/v1/retrieve``, ``/v1/statistics`` and ``/v1/inputs`` with equal replies
(scores within 1e-4); ``QASummaryRestServer`` (``build_server`` /
``run_server`` of ``BaseRAGQuestionAnswerer``) answers ``/v1/pw_ai_answer``
and ``/v1/pw_ai_summary`` with equal greedy answers, the port's
``DecoderChat`` continuous on the CPU with JAX's decoder weights, each
question reaching its server once although the answered query is
retracted; and ``chip_smoke.py`` phase 17 (b)'s config-3 rerank route
keeps equal top-k. The encoders are ``tests/test_xpack_llm.py``'s TINY
shape in f32 with shared weights. Every wait is bounded."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from pathway_tpu.models import MINILM_L6 as J_MINILM
from pathway_tpu.models.cross_encoder import CrossEncoderModel as JCross
from pathway_tpu.models.embedder import SentenceEmbedderModel as JEmbed
from pathway_tpu.models.tokenizer import HashTokenizer as JTok
from pathway_tpu.xpacks import llm as jllm
from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel as TCross
from pathway_tpu_torch.models.embedder import SentenceEmbedderModel as TEmbed
from pathway_tpu_torch.models.params import from_jax_params
from pathway_tpu_torch.models.tokenizer import HashTokenizer as TTok
from pathway_tpu_torch.models.transformer import MINILM_L6 as T_MINILM
from pathway_tpu_torch.xpacks import llm as tllm
from tests.torch_engine import PACKAGES, PW
from tests.torch_rest import LiveRun, post_json

LLM = {"jax": jllm, "torch": tllm}
SHAPE = dict(layers=2, hidden=32, heads=4, intermediate=64, vocab_size=500, max_position=64)
N_DOCS, SCORE_TOL = 40, 1e-4
QUESTIONS = ["what is alpha beta?", "tell me about delta", "stream tensor index"]


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)


@pytest.fixture(scope="module")
def models():
    import jax.numpy as jnp

    jcfg = dataclasses.replace(J_MINILM, **SHAPE, dtype=jnp.float32)
    tcfg = dataclasses.replace(T_MINILM, **SHAPE, dtype=torch.float32)
    jemb = JEmbed(cfg=jcfg, max_length=32, tokenizer=JTok(vocab_size=500, max_length=32))
    temb = TEmbed(cfg=tcfg, max_length=32, params=from_jax_params(_np_tree(jemb.params)),
                  tokenizer=TTok(vocab_size=500, max_length=32), device="cpu")
    jce = JCross(cfg=jcfg, max_length=64, tokenizer=JTok(vocab_size=500, max_length=64))
    tce = TCross(cfg=tcfg, max_length=64, params=from_jax_params(_np_tree(jce.params)),
                 head=from_jax_params(_np_tree(jce.head)),
                 tokenizer=TTok(vocab_size=500, max_length=64), device="cpu")
    yield {"jax": (jemb, jce), "torch": (temb, tce)}
    jemb.close()
    temb.close()


def _corpus():
    rng = np.random.default_rng(5)
    words = ["alpha", "beta", "gamma", "delta", "stream", "tensor", "index", "chip", "fuse"]
    return [" ".join(rng.choice(words, 8)) for _ in range(N_DOCS)]


def _docs(pw):
    schema = pw.schema_from_types(data=str, _metadata=pw.Json)
    return pw.debug.table_from_rows(schema, [
        (d, pw.Json({"path": f"doc{i}", "modified_at": i})) for i, d in enumerate(_corpus())])


def _strip_dists(docs):
    return [{k: v for k, v in d.items() if k != "dist"} for d in docs]


def _stats(stats):
    """A statistics reply without ``late_bank_bytes``: each package's
    process-wide HBM gauge, which holds what earlier tests of the process
    left in it."""
    assert stats["late_bank_bytes"] >= 0
    return {k: v for k, v in stats.items() if k != "late_bank_bytes"}


def _assert_docs_equal(got, want):
    assert _strip_dists(got) == _strip_dists(want)
    np.testing.assert_allclose([d["dist"] for d in got], [d["dist"] for d in want],
                               rtol=0, atol=SCORE_TOL)


# --------------------------------------------------------- VectorStoreServer

def test_vector_store_server_replies_equal_jax(models):
    replies = {}
    for pkg in PACKAGES:
        pw, llm = PW[pkg], LLM[pkg]
        pw.clear_graph()
        emb = llm.embedders.SentenceTransformerEmbedder(models[pkg][0])
        vs = llm.VectorStoreServer(_docs(pw), embedder=emb)
        server = vs.run_server(host="127.0.0.1", port=0, threaded=True)
        live = LiveRun(pkg, run=server.join)
        client = llm.VectorStoreClient(host="127.0.0.1", port=live.webserver.port, timeout=60)
        try:
            replies[pkg] = {
                "retrieve": [client.query(q, k=3) for q in QUESTIONS],
                "filtered": client.query("alpha", k=5, metadata_filter="path == 'doc3'"),
                "stats": client.get_vectorstore_statistics(),
                "inputs": client.get_input_files(),
            }
        finally:
            live.stop()
            pw.clear_graph()
    got, want = replies["torch"], replies["jax"]
    for g, w in zip(got["retrieve"], want["retrieve"], strict=True):
        assert len(g) == 3
        _assert_docs_equal(g, w)
    _assert_docs_equal(got["filtered"], want["filtered"])
    assert _stats(got["stats"]) == _stats(want["stats"]) and got["stats"]["file_count"] == N_DOCS
    assert got["inputs"] == want["inputs"] and len(got["inputs"]) == N_DOCS


# ------------------------------------------------------ QASummaryRestServer

def _decoders():
    import jax
    import jax.numpy as jnp

    from pathway_tpu.models import decoder as JD
    from pathway_tpu.models.bpe import BPETokenizer as JBPE
    from pathway_tpu.models.bpe import bytes_to_unicode as j_b2u
    from pathway_tpu.xpacks.llm.llms import TPUDecoderChat
    from pathway_tpu_torch.models import decoder as TD
    from pathway_tpu_torch.models.bpe import BPETokenizer as TBPE
    from pathway_tpu_torch.models.bpe import bytes_to_unicode as t_b2u

    shape = dict(vocab_size=256, hidden=32, layers=2, heads=4, intermediate=64,
                 max_position=256)
    # the seeded init's weights (std 0.02) scaled up: at that std a 2-layer
    # model's next token hardly depends on the prompt, and the answers
    # must differ between questions
    jparams = jax.tree.map(lambda a: a * 20.0 if a.ndim >= 2 else a, JD.init_params(
        jax.random.PRNGKey(3), JD.DecoderConfig(**shape, dtype=jnp.float32)))
    jtok = JBPE({c: i for i, c in j_b2u().items()}, [])
    ttok = TBPE({c: i for i, c in t_b2u().items()}, [])
    jchat = TPUDecoderChat(params=jparams, cfg=JD.DecoderConfig(**shape, dtype=jnp.float32),
                           tokenizer=jtok, max_new_tokens=6)
    tchat = tllm.DecoderChat(params=from_jax_params(jax.tree.map(np.asarray, jparams)),
                             cfg=TD.DecoderConfig(**shape, dtype=torch.float32), tokenizer=ttok,
                             max_new_tokens=6, continuous=True, n_slots=4, chunk_steps=4,
                             spec_decode=False, device="cpu")
    return {"jax": jchat, "torch": tchat}


def test_qa_summary_rest_server_answers_equal_jax(models):
    chats = _decoders()
    submitted = []
    orig = chats["torch"].server.submit

    def counting_submit(ids, *a, **kw):
        submitted.append(list(ids))
        return orig(ids, *a, **kw)

    chats["torch"].server.submit = counting_submit
    replies = {}
    try:
        for pkg in PACKAGES:
            pw, llm = PW[pkg], LLM[pkg]
            pw.clear_graph()
            emb = llm.embedders.SentenceTransformerEmbedder(models[pkg][0])
            store = llm.DocumentStore(_docs(pw), retriever_factory=_factory(pkg, emb))
            qa = llm.BaseRAGQuestionAnswerer(chats[pkg], store, search_topk=2)
            qa.build_server("127.0.0.1", 0)
            live = LiveRun(pkg, webserver=qa.server.webserver, run=qa.run_server)
            try:
                out = {q: post_json(f"{live.base}/v1/pw_ai_answer",
                                    {"prompt": q, "return_context_docs": True})
                       for q in QUESTIONS}
                out["summary"] = post_json(f"{live.base}/v1/pw_ai_summary",
                                           {"text_list": ["alpha beta", "gamma delta"]})
                out["v2"] = post_json(f"{live.base}/v2/answer", {"prompt": QUESTIONS[0]})
                out["stats"] = post_json(f"{live.base}/v1/statistics", {})
                out["list"] = post_json(f"{live.base}/v1/pw_list_documents", {})
                # concurrent questions: each still reaches the server once
                par = {}

                def ask(q):
                    par[q] = post_json(f"{live.base}/v1/pw_ai_answer", {"prompt": q})

                threads = [threading.Thread(target=ask, args=(q,)) for q in QUESTIONS]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(60)
                out["parallel"] = par
                replies[pkg] = out
            finally:
                live.stop()
                pw.clear_graph()
    finally:
        chats["torch"].close()
    got, want = replies["torch"], replies["jax"]
    for q in QUESTIONS:
        assert got[q]["response"] == want[q]["response"]
        _assert_docs_equal(got[q]["context_docs"], want[q]["context_docs"])
        assert got["parallel"][q] == want["parallel"][q] == {"response": want[q]["response"]}
    assert got["summary"] == want["summary"] and got["v2"] == want["v2"]
    assert _stats(got["stats"]) == _stats(want["stats"]) and got["list"] == want["list"]
    assert len({got[q]["response"] for q in QUESTIONS}) > 1, "answers follow the question"
    # one request a question (+ the summary and /v2/answer), though every
    # answered query is retracted: the replay cache answers the retraction
    assert len(submitted) == 2 * len(QUESTIONS) + 2


def _factory(pkg, emb):
    kw = {"device": "cpu"} if pkg == "torch" else {}
    return PW[pkg].indexing.BruteForceKnnFactory(dimensions=32, embedder=emb, **kw)


# ------------------------------------------------ phase 17 (b)'s rerank route

def test_config3_rerank_route_top_k_equals_jax(models):
    replies, pairs = {}, {}
    for pkg in PACKAGES:
        pw, llm = PW[pkg], LLM[pkg]
        pw.clear_graph()
        emb = llm.embedders.SentenceTransformerEmbedder(models[pkg][0])
        store = llm.DocumentStore(_docs(pw), retriever_factory=_factory(pkg, emb))
        ce = models[pkg][1]
        calls = pairs[pkg] = []
        score_submit = ce.score_submit

        def counting(p, _f=score_submit, _c=calls):
            _c.append(len(p))
            return _f(p)

        ce.score_submit = counting
        webserver = pw.io.http.PathwayWebserver("127.0.0.1", 0)
        chip_smoke.rerank_route(pw, llm, store, llm.rerankers.CrossEncoderReranker(ce),
                                webserver, k_retrieve=8, k_keep=3)
        live = LiveRun(pkg, webserver=webserver)
        try:
            replies[pkg] = [post_json(f"{live.base}/v1/rerank", {"query": q}) for q in QUESTIONS]
        finally:
            live.stop()
            pw.clear_graph()
            del ce.score_submit
    for g, w in zip(replies["torch"], replies["jax"], strict=True):
        assert len(g["docs"]) == 3
        _assert_docs_equal(g["docs"], w["docs"])
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=SCORE_TOL)
        assert g["scores"] == sorted(g["scores"], reverse=True)
    # the port scores each pair once; JAX scores a retracted query's pairs
    # again (its cross-encoder UDF is deterministic)
    assert pairs["torch"] == [8] * len(QUESTIONS)
    assert sum(pairs["jax"]) >= sum(pairs["torch"])
