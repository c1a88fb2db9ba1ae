"""The LLM xpack of the port held against the JAX package's: the
counterparts of ``tests/test_xpack_llm.py`` and of the applicable parts
of ``tests/test_xpack_matrix.py`` (the SlideParser cases wait with the
parser). Each program runs through both packages and the results must be
equal: retrieve, statistics, inputs, the splitters, the prompts, the base
and adaptive QA, and the keys of ``:309``. Reranker scores agree within
the encoders' cross-framework f32 tolerance (``atol=1e-4``, as in
``tests/test_torch_transformer.py``), so the models here compute in f32
(``test_xpack_llm.py``'s ``TINY`` computes in bf16). The fully local RAG
loop's port ``DecoderChat`` (on the CPU) carries JAX's decoder weights and
answers with ``TPUDecoderChat``'s greedy response.

``TokenCountSplitter`` counts with tiktoken where its encoding loads;
tiktoken fetches an encoding's file over the network on first use, so
these tests pin the whitespace count on both packages."""

import dataclasses
import json

import numpy as np
import pandas as pd
import pytest
import torch

import pathway_tpu as JPW
import pathway_tpu_torch as TPW
from pathway_tpu.internals.json import unwrap_json as j_unwrap
from pathway_tpu.models import MINILM_L6 as J_MINILM
from pathway_tpu.models.cross_encoder import CrossEncoderModel as JCross
from pathway_tpu.models.embedder import SentenceEmbedderModel as JEmbed
from pathway_tpu.models.tokenizer import HashTokenizer as JTok
from pathway_tpu.xpacks import llm as jllm
from pathway_tpu.xpacks.llm import llms as j_llms
from pathway_tpu.xpacks.llm import rerankers as j_rerankers
from pathway_tpu_torch.internals.json import unwrap_json as t_unwrap
from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel as TCross
from pathway_tpu_torch.models.embedder import SentenceEmbedderModel as TEmbed
from pathway_tpu_torch.models.params import from_jax_params
from pathway_tpu_torch.models.tokenizer import HashTokenizer as TTok
from pathway_tpu_torch.models.transformer import MINILM_L6 as T_MINILM
from pathway_tpu_torch.xpacks import llm as tllm
from tests.torch_engine import PACKAGES, PW, final_state

LLM = {"jax": jllm, "torch": tllm}
SHAPE = dict(layers=2, hidden=32, heads=4, intermediate=64, vocab_size=500, max_position=64)
TINY = {
    "jax": dataclasses.replace(J_MINILM, **SHAPE, dtype=__import__("jax").numpy.float32),
    "torch": dataclasses.replace(T_MINILM, **SHAPE, dtype=torch.float32),
}
ATOL = 1e-4


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)


@pytest.fixture(scope="module")
def encoders():
    """The JAX TINY embedder and cross-encoder (seeded) and the port's
    with the same weights and tokenizer, f32, on the CPU."""
    jemb = JEmbed(cfg=TINY["jax"], max_length=16, tokenizer=JTok(vocab_size=500, max_length=16))
    temb = TEmbed(cfg=TINY["torch"], max_length=16, params=from_jax_params(_np_tree(jemb.params)),
                  tokenizer=TTok(vocab_size=500, max_length=16), device="cpu")
    jce = JCross(cfg=TINY["jax"], max_length=32, tokenizer=JTok(vocab_size=500, max_length=32))
    tce = TCross(cfg=TINY["torch"], max_length=32, params=from_jax_params(_np_tree(jce.params)),
                 head=from_jax_params(_np_tree(jce.head)),
                 tokenizer=TTok(vocab_size=500, max_length=32), device="cpu")
    yield {"jax": (jemb, jce), "torch": (temb, tce)}
    for m in (jemb, temb):
        m.close()


# -- mocks (reference tests/mocks.py), one per package -----------------------

def _fake_embeddings_model(pw):
    @pw.udf
    def fake_embeddings_model(x: str) -> np.ndarray:
        return np.array([1.0, 1.0, 0.0]) if "foo" in (x or "") else np.array([0.0, 1.0, 1.0])

    return fake_embeddings_model


def _chats(pkg):
    base = LLM[pkg].llms.BaseChat
    msgs_to_list = (j_llms if pkg == "jax" else tllm.llms)._messages_to_list

    class IdentityMockChat(base):
        def __wrapped__(self, messages, **kwargs) -> str:
            return "mock: " + msgs_to_list(messages)[-1]["content"]

    class NoInfoThenAnswerChat(base):
        def __init__(self, min_context_words: int):
            super().__init__()
            self.min_context_words = min_context_words

        def __wrapped__(self, messages, **kwargs) -> str:
            content = msgs_to_list(messages)[-1]["content"]
            if len(content.split()) >= self.min_context_words:
                return "the answer"
            return "No information found."

    return IdentityMockChat, NoInfoThenAnswerChat


def _docs_table(pw):
    return pw.debug.table_from_pandas(pd.DataFrame({
        "data": ["foo bar baz documents about foo", "completely different animal text"],
        "_metadata": [pw.Json({"path": "a.txt", "modified_at": 1}),
                      pw.Json({"path": "b.txt", "modified_at": 2})],
    }))


def _factory(pkg, **kw):
    if pkg == "torch":
        kw["device"] = "cpu"
    return PW[pkg].indexing.BruteForceKnnFactory(**kw)


def _store(pkg, **kwargs):
    pw = PW[pkg]
    return LLM[pkg].DocumentStore(
        _docs_table(pw),
        retriever_factory=_factory(pkg, dimensions=3, embedder=_fake_embeddings_model(pw)),
        **kwargs)


def _json_rows(pkg, table, col="result"):
    """{row id: unwrapped JSON} of a result column, after one run."""
    if pkg == "torch":
        from pathway_tpu_torch.internals import run as run_mod
    else:
        from pathway_tpu.internals import run as run_mod
    cap = run_mod.capture_table(table)
    i = list(cap.column_names).index(col)
    unwrap = t_unwrap if pkg == "torch" else j_unwrap
    return {int(k): unwrap(row[i]) for k, row in cap.state.rows.items()}


def _both(build, col="result"):
    """{pkg: {row id: JSON}} of ``build(pkg)``'s result table."""
    out = {}
    for pkg in PACKAGES:
        PW[pkg].clear_graph()
        out[pkg] = _json_rows(pkg, build(pkg), col)
        PW[pkg].clear_graph()
    return out


def _assert_close(got, want, path="reply"):
    """Equal JSON but floats, which agree within ``ATOL`` (the two
    packages' KNN scores differ in the last bits of f32)."""
    if isinstance(want, float):
        assert abs(got - want) < ATOL, path
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


def _query_table(pw, **cols):
    return pw.debug.table_from_pandas(pd.DataFrame(cols))


# -- embedders ---------------------------------------------------------------

def test_sentence_transformer_embedder_batched_equals_jax(encoders):
    texts = ["hello world", "tpu native framework", "a third text"]
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        emb = LLM[pkg].embedders.SentenceTransformerEmbedder(encoders[pkg][0])
        assert emb.get_embedding_dimension() == 32
        t = pw.debug.table_from_pandas(pd.DataFrame({"text": texts}))
        rows, cols = final_state(pkg, t.select(vec=emb(t.text)))
        out[pkg] = rows
    assert out["torch"].keys() == out["jax"].keys()
    for k, row in out["torch"].items():
        got = np.frombuffer(row[0][3], dtype=np.dtype(row[0][1]))
        want = np.frombuffer(out["jax"][k][0][3], dtype=np.dtype(out["jax"][k][0][1]))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        np.testing.assert_allclose(np.linalg.norm(got), 1.0, atol=1e-3)


def test_embedder_batch_cache_calls_equal_jax():
    calls = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        seen = calls[pkg] = []

        class CountingEmbedder(LLM[pkg].embedders.BaseEmbedder):
            def __init__(self):
                super().__init__(batch=True, cache_strategy=pw.udfs.InMemoryCache())

            def __wrapped__(self, input, **kwargs):
                seen.append(list(input))
                return [np.ones(3) for _ in input]

        t = pw.debug.table_from_pandas(pd.DataFrame({"text": ["a", "a", "b"]}))
        final_state(pkg, t.select(vec=CountingEmbedder()(t.text)))
    assert calls["torch"] == calls["jax"]
    flat = [x for batch in calls["torch"] for x in batch]
    assert sorted(flat) == ["a", "b"]


# -- rerankers ---------------------------------------------------------------

def test_cross_encoder_reranker_scores_equal_jax(encoders):
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        rr = LLM[pkg].rerankers.CrossEncoderReranker(encoders[pkg][1])
        t = pw.debug.table_from_pandas(pd.DataFrame(
            {"doc": ["foo article", "bar piece", None], "query": ["foo", "foo", "bar"]}))
        rows, cols = final_state(pkg, t.select(score=rr(pw.this.doc, pw.this.query)))
        out[pkg] = {k: r[0] for k, r in rows.items()}
    assert out["torch"].keys() == out["jax"].keys()
    for k, s in out["torch"].items():
        assert isinstance(s, float)
        assert abs(s - out["jax"][k]) < ATOL


@pytest.mark.parametrize("rr_name", ["CrossEncoderReranker", "EncoderReranker"])
def test_rerankers_two_phase_matches_blocking_and_jax(encoders, rr_name):
    docs = ["alpha beta gamma", "delta stream tensor", "index chip fuse"]
    queries = ["alpha beta", "alpha beta", "tensor stream"]
    scores = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        model = encoders[pkg][1 if rr_name == "CrossEncoderReranker" else 0]
        rr = getattr(LLM[pkg].rerankers, rr_name)(model, max_batch_size=2)
        blocking = rr.__wrapped__(docs, queries)
        h1 = rr.submit_batch(docs[:2], queries[:2])
        h2 = rr.submit_batch(docs[2:], queries[2:])
        piped = [s for chunk in rr.resolve_batch([h1, h2]) for s in chunk]
        assert len(piped) == 3
        np.testing.assert_allclose(piped, blocking, rtol=0, atol=1e-5)
        pw.clear_graph()
        t = pw.debug.table_from_pandas(pd.DataFrame({"doc": docs, "q": queries}))
        rows, _ = final_state(pkg, t.select(score=rr(t.doc, t.q)))
        np.testing.assert_allclose(sorted(r[0] for r in rows.values()), sorted(blocking),
                                   rtol=0, atol=1e-5)
        pw.clear_graph()
        scores[pkg] = blocking
    np.testing.assert_allclose(scores["torch"], scores["jax"], rtol=0, atol=ATOL)


def test_encoder_reranker_cosine_orders_as_jax(encoders):
    got = {}
    for pkg in PACKAGES:
        rr = LLM[pkg].rerankers.EncoderReranker(encoders[pkg][0])
        got[pkg] = rr.__wrapped__(["hello there", "hello there"],
                                  ["hello there", "entirely unrelated words apple"])
        assert got[pkg][0] > got[pkg][1]
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=0, atol=ATOL)


def test_encoder_reranker_rides_embed_dedup(encoders):
    """The port's embedder dedup is a constructor argument (JAX reads
    ``PATHWAY_TPU_EMBED_DEDUP``): 4 query rows collapse to one miss, the
    scores identical to dedup off, the two-phase path too."""
    model = encoders["torch"][0]
    docs = ["aa bb", "cc dd", "ee ff", "aa bb"]
    queries = ["the query"] * len(docs)
    off = tllm.rerankers.EncoderReranker(model, custom_kwargs={"dedup": False})
    on = tllm.rerankers.EncoderReranker(model)
    ref = off.__wrapped__(list(docs), list(queries))
    np.testing.assert_allclose(on.__wrapped__(list(docs), list(queries)), ref, rtol=0, atol=0)
    assert on.embedder.dedup_stats["misses"] == 4 and on.embedder.dedup_stats["hits"] >= 4
    (scores,) = on.resolve_batch([on.submit_batch(list(docs), list(queries))])
    np.testing.assert_allclose(scores, ref, rtol=0, atol=0)


def test_rerank_topk_filter_equals_jax():
    cases = [
        (("a", "b", "c", "d"), (0.1, 0.9, 0.5, 0.2), 2),
        ([f"d{i}" for i in range(6)], [0.5, 0.9, 0.5, 0.9, 0.5, 0.1], 5),  # ties by index
        (["a", "b", "c"], [0.2, 0.9, 0.5], 50),
        (["a", "b", "c"], [0.2, 0.9, 0.5], 0),
        (["a", "b", "c"], [0.2, 0.9, 0.5], -3),
        (["a", "b", "c"], [0.7], 9),
    ]
    for docs, scores, k in cases:
        want = j_rerankers.rerank_topk_filter.__wrapped__(list(docs), list(scores), k)
        assert tllm.rerankers.rerank_topk_filter.__wrapped__(list(docs), list(scores), k) == want
    assert tllm.rerankers.rerank_topk_filter.__wrapped__(
        [f"d{i}" for i in range(6)], [0.5, 0.9, 0.5, 0.9, 0.5, 0.1], 5)[0] == [
        "d1", "d3", "d0", "d2", "d4"]
    # through the engine, as tests/test_xpack_llm.py runs it
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        t = pw.debug.table_from_pandas(pd.DataFrame({"x": [1]}))
        rows, _ = final_state(pkg, t.select(out=LLM[pkg].rerankers.rerank_topk_filter(
            ("a", "b", "c", "d"), (0.1, 0.9, 0.5, 0.2), 2)))
        out[pkg] = rows
        pw.clear_graph()
    assert out["torch"] == out["jax"]


def test_llm_reranker_equals_jax():
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()

        class DigitChat(LLM[pkg].llms.BaseChat):
            def __wrapped__(self, messages, **kwargs) -> str:
                return "4"

        t = pw.debug.table_from_pandas(pd.DataFrame({"d": ["doc"], "q": ["q"]}))
        out[pkg], _ = final_state(pkg, t.select(
            score=LLM[pkg].rerankers.LLMReranker(DigitChat())(pw.this.d, pw.this.q)))
        pw.clear_graph()
    assert out["torch"] == out["jax"]
    assert list(out["torch"].values())[0] == (4.0,)


def test_listwise_reranker_udf_equals_jax():
    """The UDF form over ``pw.Json`` docs with a scripted chat: each row's
    docs come back reordered as JAX's."""
    out = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()

        class Chat:
            batch = False
            deterministic = True

            def __wrapped__(self, messages, **kwargs):
                return "[2] > [1]"

            def __call__(self, batch, **kwargs):
                return [self.__wrapped__(m) for m in batch]

        rr = LLM[pkg].rerankers.ListwiseLLMReranker(Chat(), window=4, stride=2)
        docs = [(pw.Json({"text": "one"}), pw.Json({"text": "two"}), pw.Json({"text": "three"}))]
        t = pw.debug.table_from_pandas(pd.DataFrame({"q": ["query"], "docs": docs}))
        rows, _ = final_state(pkg, t.select(ranked=rr(t.docs, t.q)))
        out[pkg] = rows
        pw.clear_graph()
    assert out["torch"] == out["jax"]


def test_unwrap_doc_texts_equals_jax():
    docs = [TPW.Json({"text": "a"}), {"text": "b"}, "c"]
    jdocs = [JPW.Json({"text": "a"}), {"text": "b"}, "c"]
    assert (tllm.rerankers.unwrap_doc_texts.__wrapped__(docs)
            == j_rerankers.unwrap_doc_texts.__wrapped__(jdocs) == ["a", "b", "c"])


# -- splitters / parsers / prompts -------------------------------------------

SPLIT_TEXTS = [
    "One two three four five. Six seven eight nine ten. Eleven twelve thirteen fourteen fifteen.",
    " ".join(f"w{i}" for i in range(20)),
    "para one here.\n\npara two is a bit longer.\n\npara three.",
    "",
    " ".join(["w"] * 450),
]


@pytest.mark.parametrize("i", range(len(SPLIT_TEXTS)))
@pytest.mark.parametrize("cfg", [(3, 10), (3, 6), (1, 3)])
def test_token_count_splitter_equals_jax(i, cfg):
    j = LLM["jax"].splitters.TokenCountSplitter(min_tokens=cfg[0], max_tokens=cfg[1])
    t = LLM["torch"].splitters.TokenCountSplitter(min_tokens=cfg[0], max_tokens=cfg[1])
    j._encoder = t._encoder = False  # whitespace count: no encoding download
    want = j.__wrapped__(SPLIT_TEXTS[i])
    assert t.__wrapped__(SPLIT_TEXTS[i]) == want
    for text, meta in want:
        assert isinstance(meta, dict)
        assert len(text.split()) <= max(cfg[1], 1) + 2


@pytest.mark.parametrize("i", range(len(SPLIT_TEXTS)))
@pytest.mark.parametrize("size,overlap", [(4, 0), (4, 1), (200, 0)])
def test_recursive_splitter_equals_jax(i, size, overlap):
    want = LLM["jax"].splitters.RecursiveSplitter(chunk_size=size, chunk_overlap=overlap
                                                   ).__wrapped__(SPLIT_TEXTS[i])
    got = LLM["torch"].splitters.RecursiveSplitter(chunk_size=size, chunk_overlap=overlap
                                                    ).__wrapped__(SPLIT_TEXTS[i])
    assert got == want


def test_null_splitter_and_chunk_texts_equal_jax():
    for text in SPLIT_TEXTS:
        assert (tllm.splitters.null_splitter.__wrapped__(text)
                == jllm.splitters.null_splitter.__wrapped__(text))
        for mw in (3, 200):
            assert (tllm.splitters.chunk_texts.__wrapped__(text, max_words=mw)
                    == jllm.splitters.chunk_texts.__wrapped__(text, max_words=mw))
    assert len(tllm.splitters.chunk_texts.__wrapped__(" ".join(["w"] * 450), max_words=200)) == 3


def test_parsers_equal_jax():
    for raw in ("hello".encode(), "héllo".encode(), "plain str", b"\xff\xfe bad"):
        assert (tllm.parsers.ParseUtf8().__wrapped__(raw)
                == jllm.parsers.ParseUtf8().__wrapped__(raw))
    assert tllm.parsers.Utf8Parser is tllm.parsers.ParseUtf8
    for name, pkg_name in (("ParseUnstructured", "unstructured"), ("PypdfParser", "pypdf"),
                           ("OpenParse", "openparse")):
        try:
            __import__(pkg_name)
        except ImportError:
            for llm in (jllm, tllm):
                with pytest.raises(ImportError, match=pkg_name):
                    getattr(llm.parsers, name)()


def test_prompts_equal_jax():
    jp, tp = jllm.prompts, tllm.prompts
    for name in ("prompt_qa", "prompt_short_qa", "prompt_citing_qa"):
        assert getattr(tp, name).__wrapped__("what is x", "x is a letter") == getattr(
            jp, name).__wrapped__("what is x", "x is a letter")
    assert tp.prompt_summarize.__wrapped__(["a", "b"]) == jp.prompt_summarize.__wrapped__(["a", "b"])
    for name in ("prompt_query_rewrite_hyde", "prompt_query_rewrite"):
        assert getattr(tp, name).__wrapped__("q?") == getattr(jp, name).__wrapped__("q?")
    for name in ("BASE_PROMPT_TEMPLATE", "STRICT_JSON_PROMPT_TEMPLATE", "SUMMARIZE_TEMPLATE",
                 "DEFAULT_JSON_TABLE_PARSE_PROMPT", "DEFAULT_MD_TABLE_PARSE_PROMPT",
                 "DEFAULT_IMAGE_PARSE_PROMPT"):
        assert getattr(tp, name) == getattr(jp, name)
    tpl = tp.RAGPromptTemplate(template="Q: {query} C: {context}")
    assert tpl.as_udf().__wrapped__("myctx", "myq") == "Q: myq C: myctx" == jp.RAGPromptTemplate(
        template="Q: {query} C: {context}").as_udf().__wrapped__("myctx", "myq")
    for bad in ("no placeholders", "{context} only", "{context} {query} {other}"):
        for mod in (jp, tp):
            with pytest.raises(ValueError):
                mod.RAGPromptTemplate(template=bad)
    docs = ["first source", {"text": "second source"}]
    for strict in (False, True):
        assert tp.prompt_qa_geometric_rag("q", docs, strict_prompt=strict) == \
            jp.prompt_qa_geometric_rag("q", docs, strict_prompt=strict)
    for text in ("Paris [1] and [3].", "none", "[2][2] x [9]"):
        assert tp.parse_cited_response(text, ["a", "b", "c"]) == jp.parse_cited_response(
            text, ["a", "b", "c"])
    ft = tp.RAGFunctionPromptTemplate(lambda query, context: f"{query}|{context}")
    assert ft.as_udf().__wrapped__(query="q", context="c") == "q|c"


def test_chat_helpers_equal_jax():
    j = json.loads(str(tllm.llms.prompt_chat_single_qa.__wrapped__("hello")))
    assert j == json.loads(str(j_llms.prompt_chat_single_qa.__wrapped__("hello")))
    assert j[0] == {"role": "user", "content": "hello"}
    msgs = [{"role": "user", "content": "hi"}]
    assert tllm.llms._messages_to_list(TPW.Json(msgs)) == msgs == j_llms._messages_to_list(
        JPW.Json(msgs))
    assert tllm.llms._messages_to_list(msgs) == msgs
    assert tllm.llms._messages_to_list("hi") == msgs
    long = [{"role": "user", "content": "x" * 300}]
    for verbose in (False, True):
        assert tllm.llms._prep_message_log(long, verbose) == j_llms._prep_message_log(
            long, verbose)


# -- document store ----------------------------------------------------------

def _retrieve_queries(pw, query="foo", k=1, glob=None):
    return _query_table(pw, query=[query], k=[k], metadata_filter=[None],
                        filepath_globpattern=[glob])


@pytest.mark.parametrize("k", [1, 2])
def test_document_store_retrieve_equals_jax(k):
    out = _both(lambda pkg: _store(pkg).retrieve_query(_retrieve_queries(PW[pkg], k=k)))
    assert out["torch"] == out["jax"]
    (docs,) = out["torch"].values()
    assert len(docs) == k and "foo" in docs[0]["text"] and docs[0]["metadata"]["path"] == "a.txt"


def _no_late_bank(out):
    """Statistics replies without ``late_bank_bytes``: each package's
    process-wide HBM gauge, which holds what earlier tests left in it."""
    for replies in out.values():
        for stats in replies.values():
            assert stats.pop("late_bank_bytes") >= 0
    return out


def test_document_store_statistics_equals_jax():
    out = _no_late_bank(_both(lambda pkg: _store(pkg).statistics_query(
        _query_table(PW[pkg], _dummy=[1]).without("_dummy"))))
    assert out["torch"] == out["jax"]
    (stats,) = out["torch"].values()
    assert stats["file_count"] == 2 and stats["last_modified"] == 2


def test_document_store_inputs_equals_jax():
    out = _both(lambda pkg: _store(pkg).inputs_query(
        _query_table(PW[pkg], metadata_filter=[None], filepath_globpattern=[None])))
    assert out["torch"] == out["jax"]
    (inputs,) = out["torch"].values()
    assert sorted(i["path"] for i in inputs) == ["a.txt", "b.txt"]


def test_document_store_with_splitter_equals_jax():
    def build(pkg):
        sp = LLM[pkg].splitters.TokenCountSplitter(min_tokens=1, max_tokens=3)
        sp._encoder = False
        return _store(pkg, splitter=sp).retrieve_query(_retrieve_queries(PW[pkg], k=2))

    out = _both(build)
    assert out["torch"] == out["jax"]
    (docs,) = out["torch"].values()
    assert len(docs) == 2


def _fake_embedder(text: str):
    import zlib

    rng = np.random.default_rng(zlib.crc32((text or "").encode()))
    v = rng.normal(size=8)
    return v / np.linalg.norm(v)


def _bytes_store(pkg, data, paths):
    pw = PW[pkg]
    docs = pw.debug.table_from_pandas(pd.DataFrame(
        {"data": data, "_metadata": [{"path": p} for p in paths]}))
    # a UDF: ``tests/test_xpack_matrix.py`` passes the bare function, which
    # the index then calls once on the column expression (one constant
    # vector for every row and query, from the expression's hash)
    return LLM[pkg].DocumentStore(docs, retriever_factory=_factory(
        pkg, dimensions=8, embedder=pw.udf(_fake_embedder)))


def test_vector_store_retrieve_topk_order_equals_jax():
    out = _both(lambda pkg: _bytes_store(
        pkg, [b"alpha doc", b"beta doc", b"gamma doc"], ["a.txt", "b.txt", "c.txt"]
    ).retrieve_query(_retrieve_queries(PW[pkg], query="alpha doc", k=2)))
    _assert_close(out["torch"], out["jax"])
    (results,) = out["torch"].values()
    assert results[0]["text"] == "alpha doc" and results[0]["dist"] <= results[1]["dist"]


def test_document_store_glob_filter_equals_jax():
    out = _both(lambda pkg: _bytes_store(pkg, [b"alpha", b"beta"], ["k/a.txt", "other/b.md"])
                .retrieve_query(_retrieve_queries(PW[pkg], query="alpha", k=5, glob="k/*.txt")))
    _assert_close(out["torch"], out["jax"])
    (results,) = out["torch"].values()
    assert [r["metadata"]["path"] for r in results] == ["k/a.txt"]


def test_vector_store_statistics_counts_equals_jax():
    out = _no_late_bank(_both(lambda pkg: _bytes_store(pkg, [b"alpha", b"beta"], ["a", "b"])
                              .statistics_query(_query_table(PW[pkg], req=[1]))))
    assert out["torch"] == out["jax"]
    assert list(out["torch"].values())[0]["file_count"] == 2


def test_glob_filter_does_not_cross_directories():
    from pathway_tpu.engine.operators.external_index import _glob_match as jg
    from pathway_tpu_torch.engine.operators.external_index import _glob_match as tg

    for pat, path in (("k/*.txt", "k/a.txt"), ("k/*.txt", "k/sub/a.txt"),
                      ("k/**/*.txt", "k/sub/a.txt"), ("k/??.txt", "k/ab.txt"),
                      ("k/??.txt", "k/a/b.txt")):
        assert tg(pat, path) == jg(pat, path)


def test_statistics_and_inputs_preserve_query_keys():
    """Response rows keep the query rows' keys (REST futures correlate by
    them), the same keys in both packages."""
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        store = _store(pkg)
        stats_q = _query_table(pw, _d=[1, 2]).without("_d")
        qrows, _ = final_state(pkg, stats_q)
        rrows, _ = final_state(pkg, store.statistics_query(stats_q))
        assert set(qrows) == set(rrows) and len(rrows) == 2
        in_q = _query_table(pw, metadata_filter=[None], filepath_globpattern=[None])
        qrows2, _ = final_state(pkg, in_q)
        rrows2, _ = final_state(pkg, store.inputs_query(in_q))
        assert set(qrows2) == set(rrows2)
        pw.clear_graph()


def test_document_store_component_imports_raise_as_jax():
    for llm in (jllm, tllm):
        with pytest.raises(ImportError):
            llm.DocumentStore.from_llamaindex_components(
                None, None, transformations=[object()])
        with pytest.raises(ImportError):
            llm.VectorStoreServer.from_langchain_components(embedder=None)


# -- RAG QA ------------------------------------------------------------------

def _answer_queries(pw, prompts=("what about foo?",), ctx=True):
    return _query_table(pw, prompt=list(prompts), filters=[None] * len(prompts),
                        model=[None] * len(prompts),
                        return_context_docs=[ctx] * len(prompts))


@pytest.mark.parametrize("ctx", [True, False])
def test_base_rag_answer_equals_jax(ctx):
    def build(pkg):
        identity, _ = _chats(pkg)
        qa = LLM[pkg].BaseRAGQuestionAnswerer(identity(), _store(pkg), search_topk=2)
        return qa.answer_query(_answer_queries(PW[pkg], ("what about foo?", "and bar?"), ctx))

    out = _both(build)
    assert out["torch"] == out["jax"]
    for result in out["torch"].values():
        assert result["response"].startswith("mock: ")
        assert ("context_docs" in result) == ctx
        if ctx:
            assert len(result["context_docs"]) == 2


def test_base_rag_templates_and_context_equal_jax():
    def build(pkg):
        identity, _ = _chats(pkg)
        llm = LLM[pkg]
        qa = llm.BaseRAGQuestionAnswerer(
            identity(), _store(pkg), search_topk=1,
            prompt_template="C={context} Q={query}",
            context_processor=llm.SimpleContextProcessor(
                context_metadata_keys=["path", "modified_at"], docs_separator=" | "))
        return qa.answer_query(_answer_queries(PW[pkg]))

    out = _both(build)
    assert out["torch"] == out["jax"]
    (result,) = out["torch"].values()
    assert "C=foo bar baz documents about foo (path: a.txt, modified_at: 1) Q=" in result["response"]


def test_base_rag_summarize_equals_jax():
    def build(pkg):
        identity, _ = _chats(pkg)
        qa = LLM[pkg].BaseRAGQuestionAnswerer(identity(), _store(pkg))
        return qa.summarize_query(_query_table(PW[pkg], text_list=[("alpha", "beta")],
                                               model=[None]))

    out = _both(build)
    assert out["torch"] == out["jax"]
    assert "alpha" in list(out["torch"].values())[0]["response"]


def test_base_rag_retrieve_statistics_list_documents_equal_jax():
    for method, q in (("retrieve", lambda pw: _retrieve_queries(pw, k=2)),
                      ("statistics", lambda pw: _query_table(pw, x=[1]).without("x")),
                      ("list_documents", lambda pw: _query_table(
                          pw, metadata_filter=[None], filepath_globpattern=[None]))):
        def build(pkg, method=method, q=q):
            identity, _ = _chats(pkg)
            qa = LLM[pkg].BaseRAGQuestionAnswerer(identity(), _store(pkg))
            return getattr(qa, method)(q(PW[pkg]))

        out = _both(build)
        if method == "statistics":
            out = _no_late_bank(out)
        assert out["torch"] == out["jax"], method


@pytest.mark.parametrize("min_words", [5, 20, 10_000])
def test_adaptive_rag_escalates_equals_jax(min_words):
    def build(pkg):
        _, noinfo = _chats(pkg)
        qa = LLM[pkg].AdaptiveRAGQuestionAnswerer(
            noinfo(min_context_words=min_words), _store(pkg),
            n_starting_documents=1, factor=2, max_iterations=3)
        return qa.answer_query(_query_table(PW[pkg], prompt=["what about foo?"], filters=[None]))

    out = _both(build)
    assert out["torch"] == out["jax"]
    want = "No information found." if min_words == 10_000 else "the answer"
    assert list(out["torch"].values())[0]["response"] == want


def test_geometric_strategy_direct_call_equals_jax():
    answers = {}
    for pkg in PACKAGES:
        _, noinfo = _chats(pkg)
        answers[pkg] = LLM[pkg].answer_with_geometric_rag_strategy(
            "q", ["one two three", "four five six", "seven eight"], noinfo(min_context_words=9),
            "C {context} Q {query}", n_starting_documents=1, factor=2, max_iterations=3)
    assert answers["torch"] == answers["jax"] == "the answer"


def test_deck_retriever_equals_jax():
    out = _both(lambda pkg: LLM[pkg].DeckRetriever(_store(pkg), search_topk=1).answer_query(
        _query_table(PW[pkg], prompt=["foo"])))
    assert out["torch"] == out["jax"]


def test_rag_client_urls_equal_jax():
    from pathway_tpu.xpacks.llm.question_answering import RAGClient as J

    for kw in ({"host": "h", "port": 443}, {"host": "h", "port": 8000}, {"url": "http://x:1"}):
        assert tllm.RAGClient(**kw).url == J(**kw).url
    for bad in ({}, {"url": "u", "host": "h"}):
        for cls in (J, tllm.RAGClient):
            with pytest.raises(ValueError):
                cls(**bad)


def test_fully_local_rag_loop_with_decoder_chat(encoders):
    """The zero-network RAG loop on both packages: documents embedded by
    the TINY encoder (shared f32 weights), retrieved through
    DocumentStore, answered by the decoder: JAX's ``TPUDecoderChat`` and
    the port's ``DecoderChat`` on the CPU carrying the same weights. The
    greedy responses are equal."""
    import jax
    import jax.numpy as jnp

    from pathway_tpu.models import decoder as JD
    from pathway_tpu.xpacks.llm.llms import TPUDecoderChat
    from pathway_tpu_torch.models import decoder as TD
    from tests.utils import ToyCharTokenizer

    jcfg = JD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4, intermediate=64,
                            max_position=64, dtype=jnp.float32)
    tcfg = TD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4, intermediate=64,
                            max_position=64, dtype=torch.float32)
    jparams = JD.init_params(jax.random.PRNGKey(0), jcfg)
    chats = {
        "jax": TPUDecoderChat(params=jparams, cfg=jcfg, tokenizer=ToyCharTokenizer(max_len=24),
                              max_new_tokens=6),
        "torch": tllm.DecoderChat(params=from_jax_params(jax.tree.map(np.asarray, jparams)),
                                  cfg=tcfg, tokenizer=ToyCharTokenizer(max_len=24),
                                  max_new_tokens=6, device="cpu"),
    }

    def build(pkg):
        pw = PW[pkg]
        encoder = LLM[pkg].embedders.SentenceTransformerEmbedder(encoders[pkg][0])
        store = LLM[pkg].DocumentStore(_docs_table(pw), retriever_factory=_factory(
            pkg, dimensions=32, embedder=encoder))
        qa = LLM[pkg].BaseRAGQuestionAnswerer(chats[pkg], store, search_topk=2)
        return qa.answer_query(_answer_queries(pw, ("what is foo?", "animal?")))

    out = _both(build)
    assert out["torch"].keys() == out["jax"].keys()
    for k, result in out["torch"].items():
        want = out["jax"][k]
        assert result["response"] == want["response"]
        # the real encoder's distances agree within f32 tolerance
        for got_doc, want_doc in zip(result["context_docs"], want["context_docs"], strict=True):
            assert abs(got_doc.pop("dist") - want_doc.pop("dist")) < ATOL
            assert got_doc == want_doc
        assert isinstance(result["response"], str) and len(result["response"]) == 6
        assert len(result["context_docs"]) == 2
    assert tllm.DecoderChat.__mro__[1] is tllm.BaseChat
    assert chats["torch"].deterministic and chats["torch"].batch


# -- helpers of the pack -----------------------------------------------------

def test_pack_utils_equal_jax():
    from pathway_tpu.xpacks.llm import _parser_utils as jpu
    from pathway_tpu.xpacks.llm import _utils as ju
    from pathway_tpu.xpacks.llm import constants as jc
    from pathway_tpu_torch.xpacks.llm import _parser_utils as tpu
    from pathway_tpu_torch.xpacks.llm import _utils as tu
    from pathway_tpu_torch.xpacks.llm import constants as tc

    docs = [TPW.Json({"text": "a", "metadata": TPW.Json({"p": 1})}), {"text": "b"}, "c"]
    jdocs = [JPW.Json({"text": "a", "metadata": JPW.Json({"p": 1})}), {"text": "b"}, "c"]
    assert tu.combine_metadata(docs) == ju.combine_metadata(jdocs)

    def f(a, b=1, *args, c, **kw):
        return a

    assert tu.get_func_arg_names(f) == ju.get_func_arg_names(f) == ["a", "b", "c"]
    assert tu.unwrap_udf(tllm.splitters.null_splitter)("x") == [("x", {})]

    async def add(x, y):
        return x + y

    assert tu._coerce_sync(add)(1, 2) == ju._coerce_sync(add)(1, 2) == 3
    assert tc.DEFAULT_VISION_MODEL == jc.DEFAULT_VISION_MODEL
    import PIL.Image

    img = PIL.Image.fromarray(np.arange(60 * 40 * 3, dtype=np.uint8).reshape(40, 60, 3))
    small = tpu.maybe_downscale(img, 100, 30)
    assert small.size == jpu.maybe_downscale(img, 100, 30).size == (30, 20)
    assert tpu.img_to_b64(img) == jpu.img_to_b64(img)
    with pytest.raises(ImportError):
        import asyncio

        asyncio.run(tpu.parse_image_details("b64", None))


def test_slides_document_store_parsed_documents_equal_jax():
    out = _both(lambda pkg: LLM[pkg].SlidesDocumentStore(
        _docs_table(PW[pkg]), retriever_factory=_factory(
            pkg, dimensions=3, embedder=_fake_embeddings_model(PW[pkg]))
    ).parsed_documents_query(_query_table(PW[pkg], x=[1]).without("x")))
    assert out["torch"] == out["jax"]
    (docs,) = out["torch"].values()
    assert sorted(d["metadata"]["path"] for d in docs) == ["a.txt", "b.txt"]


def test_geometric_strategy_from_index_equals_jax():
    def build(pkg):
        pw = PW[pkg]
        _, noinfo = _chats(pkg)
        store = _store(pkg)
        questions = _query_table(pw, prompt=["what about foo?", "animals?"])
        return LLM[pkg].answer_with_geometric_rag_strategy_from_index(
            questions, store.index, "text", noinfo(min_context_words=12),
            "C {context} Q {query}", n_starting_documents=1, factor=2, max_iterations=2)

    out = _both(build)
    assert out["torch"] == out["jax"]
    assert list(out["torch"].values()) == ["the answer"] * 2
