"""The port's ``xpacks/llm/rag_eval.py`` held against the JAX package's
(the bar is ``tests/test_rag_eval.py``): the synthesized datasets are
equal sample for sample over several ``n`` and seeds, and so are the
document and query tables built from them; scoring agrees; BM25 over the
port's ``DocumentStore`` returns each fact's one document, as in JAX's
retrieval-grounding gate; and ``run_rag_eval`` over a
``BaseRAGQuestionAnswerer`` with the small encoder (f32, shared weights)
and a small decoder (JAX's seeded weights, the port's continuous server on
the CPU) gives JAX's greedy responses, question for question."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pathway_tpu.xpacks.llm import rag_eval as J
from pathway_tpu_torch.xpacks.llm import rag_eval as T
from tests.torch_engine import PACKAGES, PW, final_state

RE = {"jax": J, "torch": T}


@pytest.mark.parametrize("n,seed", [(1, 0), (64, 0), (100, 3), (4040, 1)])
def test_generate_qa_dataset_equals_jax(n, seed):
    got, want = T.generate_qa_dataset(n, seed=seed), J.generate_qa_dataset(n, seed=seed)
    assert [dataclasses.astuple(s) for s in got] == [dataclasses.astuple(s) for s in want]
    assert len(got) == n


def test_dataset_is_retrieval_grounded():
    samples = T.generate_qa_dataset(100, seed=3)
    for s in samples:
        holders = [t for t in samples if s.answer in t.doc]
        assert holders == [s]
        assert s.answer not in s.path and s.answer not in s.question


def test_docs_and_queries_tables_equal_jax():
    for make in ("docs_table", "queries_table"):
        out = []
        for pkg in PACKAGES:
            PW[pkg].clear_graph()
            out.append(final_state(pkg, getattr(RE[pkg], make)(RE[pkg].generate_qa_dataset(12))))
            PW[pkg].clear_graph()
        assert out[1] == out[0], make
        assert len(out[1][0]) == 12


@pytest.mark.parametrize("response,expected", [
    ("  4821. ", "4821"), ("the code is 4821", "4821"), ("4822", "4821"),
    ("Code:\n 4821!", "4821"), ("", "4821")])
def test_scoring_normalization(response, expected):
    assert T.score_answer(response, expected) == J.score_answer(response, expected)
    assert T.normalize_answer(response) == J.normalize_answer(response)
    if response.strip().startswith("4821"):
        assert T.score_answer(response, expected) == (True, True)


def test_rag_retrieval_grounding_gate():
    """BM25 over the port's DocumentStore returns the one document that
    holds each fact, and the same documents as JAX's."""
    samples = T.generate_qa_dataset(4040, seed=1)[:40]
    replies = {}
    for pkg in PACKAGES:
        pw = PW[pkg]
        pw.clear_graph()
        llm = _llm(pkg)
        store = llm.DocumentStore(RE[pkg].docs_table(samples),
                                  retriever_factory=pw.indexing.TantivyBM25Factory())
        queries = pw.debug.table_from_rows(
            pw.schema_from_types(query=str, k=int, metadata_filter=str | None,
                                 filepath_globpattern=str | None),
            [(s.question, 1, None, None) for s in samples])
        replies[pkg] = _by_query(pkg, queries, store.retrieve_query(queries), "query")
        pw.clear_graph()
    by_question = {s.question: s for s in samples}
    assert set(replies["torch"]) == set(by_question)
    for q, docs in replies["torch"].items():
        assert len(docs) == 1 and by_question[q].answer in docs[0]["text"]
        assert [d["text"] for d in docs] == [d["text"] for d in replies["jax"][q]]


def _llm(pkg):
    from pathway_tpu.xpacks import llm as jllm
    from pathway_tpu_torch.xpacks import llm as tllm

    return jllm if pkg == "jax" else tllm


def _capture(pkg, table):
    if pkg == "torch":
        from pathway_tpu_torch.internals.run import capture_table
    else:
        from pathway_tpu.internals.run import capture_table
    return capture_table(table)


def _by_query(pkg, queries, res, col):
    from pathway_tpu_torch.internals.json import unwrap_json

    q_cap, cap = _capture(pkg, queries), _capture(pkg, res)
    qi = list(q_cap.column_names).index(col)
    ri = list(cap.column_names).index("result")
    q_rows = dict(q_cap.state.rows)
    return {q_rows[k][qi]: unwrap_json(getattr(r[ri], "value", r[ri]))
            for k, r in dict(cap.state.rows).items()}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)


@pytest.fixture(scope="module")
def stacks():
    """Both packages' small encoder (f32, shared weights) and decoder
    (JAX's seeded weights scaled so answers follow the prompt)."""
    import jax.numpy as jnp

    from pathway_tpu.models import MINILM_L6 as J_MINILM
    from pathway_tpu.models import decoder as JD
    from pathway_tpu.models.bpe import BPETokenizer as JBPE
    from pathway_tpu.models.bpe import bytes_to_unicode as j_b2u
    from pathway_tpu.models.embedder import SentenceEmbedderModel as JEmbed
    from pathway_tpu.models.tokenizer import HashTokenizer as JTok
    from pathway_tpu.xpacks.llm.llms import TPUDecoderChat
    from pathway_tpu_torch.models import decoder as TD
    from pathway_tpu_torch.models.bpe import BPETokenizer as TBPE
    from pathway_tpu_torch.models.bpe import bytes_to_unicode as t_b2u
    from pathway_tpu_torch.models.embedder import SentenceEmbedderModel as TEmbed
    from pathway_tpu_torch.models.params import from_jax_params
    from pathway_tpu_torch.models.tokenizer import HashTokenizer as TTok
    from pathway_tpu_torch.models.transformer import MINILM_L6 as T_MINILM
    from pathway_tpu_torch.xpacks.llm import DecoderChat

    shape = dict(layers=2, hidden=32, heads=4, intermediate=64, vocab_size=500,
                 max_position=64)
    jemb = JEmbed(cfg=dataclasses.replace(J_MINILM, **shape, dtype=jnp.float32), max_length=32,
                  tokenizer=JTok(vocab_size=500, max_length=32))
    temb = TEmbed(cfg=dataclasses.replace(T_MINILM, **shape, dtype=torch.float32),
                  max_length=32, params=from_jax_params(_np_tree(jemb.params)),
                  tokenizer=TTok(vocab_size=500, max_length=32), device="cpu")
    dshape = dict(vocab_size=256, hidden=32, layers=2, heads=4, intermediate=64,
                  max_position=256)
    jparams = jax.tree.map(lambda a: a * 20.0 if a.ndim >= 2 else a, JD.init_params(
        jax.random.PRNGKey(3), JD.DecoderConfig(**dshape, dtype=jnp.float32)))
    jchat = TPUDecoderChat(params=jparams, cfg=JD.DecoderConfig(**dshape, dtype=jnp.float32),
                           tokenizer=JBPE({c: i for i, c in j_b2u().items()}, []),
                           max_new_tokens=6)
    tchat = DecoderChat(params=from_jax_params(jax.tree.map(np.asarray, jparams)),
                        cfg=TD.DecoderConfig(**dshape, dtype=torch.float32),
                        tokenizer=TBPE({c: i for i, c in t_b2u().items()}, []),
                        max_new_tokens=6, continuous=True, n_slots=4, chunk_steps=4,
                        spec_decode=False, device="cpu")
    yield {"jax": (jemb, jchat), "torch": (temb, tchat)}
    tchat.close()
    jemb.close()
    temb.close()


TEMPLATE = "context: {context}\nquestion: {query}\nanswer:"


@pytest.mark.timeout(300)
def test_run_rag_eval_greedy_responses_equal_jax(stacks):
    samples = T.generate_qa_dataset(8, seed=0)
    out = {}
    for pkg in PACKAGES:
        pw, llm = PW[pkg], _llm(pkg)
        emb_model, chat = stacks[pkg]
        pw.clear_graph()
        kw = {"device": "cpu"} if pkg == "torch" else {}
        emb = llm.embedders.SentenceTransformerEmbedder(emb_model)
        store = llm.DocumentStore(
            RE[pkg].docs_table(samples),
            retriever_factory=pw.indexing.BruteForceKnnFactory(dimensions=32, embedder=emb,
                                                               **kw))
        qa = llm.BaseRAGQuestionAnswerer(chat, store, search_topk=1, prompt_template=TEMPLATE,
                                         context_processor=llm.SimpleContextProcessor())
        out[pkg] = RE[pkg].run_rag_eval(qa, samples)
        pw.clear_graph()
    got, want = out["torch"], out["jax"]
    assert got["n"] == want["n"] == len(samples)
    assert sorted(got["results"]) == sorted(want["results"])
    assert (got["accuracy_exact"], got["accuracy_contains"]) == (
        want["accuracy_exact"], want["accuracy_contains"])
    assert len({r[1] for r in got["results"]}) > 1, "answers follow the question"
