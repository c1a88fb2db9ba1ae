"""The port's listwise LLM rerank against the JAX package (after
tests/test_late_interaction.py:311-380).

* ``_window_prompt`` strings byte-equal to JAX's; ``_parse_permutation``
  and ``_window_starts`` equal to JAX's on seeded replies and lengths;
  ``rerank_batch`` over one scripted chat equal to JAX's.
* The pipeline's final stage: off never consults the LLM; a permutation
  reorders and every document keeps its cross-encoder score; the window
  bubbles bottom-up; a malformed or failed reply keeps the incoming order.
* One run through the port's CPU ``DecoderChat(continuous=True)`` at a
  tiny width: every window request terminal within a bound, spans of
  tenant ``rerank``, rows that are permutations.

Every wait is bounded.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from pathway_tpu.models import decoder as JD
from pathway_tpu.xpacks.llm.llms import encode_serve_error as j_encode_serve_error
from pathway_tpu.xpacks.llm.rerankers import ListwiseLLMReranker as JListwise
from pathway_tpu_torch import CrossEncoderModel, FusedRAGPipeline, SentenceEmbedderModel
from pathway_tpu_torch.engine import probes, tracing
from pathway_tpu_torch.models import decoder as TD
from pathway_tpu_torch.models.params import from_jax_params
from pathway_tpu_torch.models.tokenizer import HashTokenizer
from pathway_tpu_torch.xpacks.llm import DecoderChat, ListwiseLLMReranker, encode_serve_error
from tests.torch_parity import configs, np_encoder_params, np_head
from tests.utils import ToyCharTokenizer

WAIT = 60.0
WORDS = np.array(["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta"])


class _ScriptedChat:
    """A stand-in chat: pops canned replies, records prompts, refuses to
    be consulted when ``forbid``. The JAX reranker calls ``__wrapped__``
    per message (``batch = False``); the port's calls the chat with the
    round's message lists."""

    batch = False
    deterministic = True

    def __init__(self, replies=(), forbid=False):
        self.replies = list(replies)
        self.forbid = forbid
        self.prompts = []

    def __wrapped__(self, messages, **kwargs):
        assert not self.forbid, "LLM consulted with llm_rerank off"
        self.prompts.append(messages[0]["content"])
        return self.replies.pop(0) if self.replies else ""

    def __call__(self, batch, **kwargs):
        return [self.__wrapped__(m, **kwargs) for m in batch]


def _pair(**kw):
    return ListwiseLLMReranker(_ScriptedChat(), **kw), JListwise(_ScriptedChat(), **kw)


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_window_prompt_is_byte_equal_to_jax(n):
    t, j = _pair()
    rng = np.random.default_rng(n)
    docs = [" ".join(rng.choice(WORDS, int(rng.integers(1, 9)))) for _ in range(n)]
    for query in ("what is delta", "", "café — 東京 [1] > [2]"):
        assert t._window_prompt(query, docs) == j._window_prompt(query, docs)


def test_parse_permutation_and_window_starts_equal_jax():
    rng = np.random.default_rng(0)
    replies = ["[2] > [1] > [3]", "[3] [3] [1]", "no ids", "", None, "[9] > [0] > [2]",
               "[1]>[2]>[3]>[4]", "Answer: [4] > [2]", encode_serve_error("shed:queue_full"),
               j_encode_serve_error("serve_failed", retry_after=0.5)]
    for _ in range(40):
        ids = rng.integers(0, 11, int(rng.integers(0, 9)))
        replies.append(" > ".join(f"[{i}]" for i in ids))
    for window, stride in ((8, 4), (4, 2), (2, 1), (5, 5)):
        t, j = _pair(window=window, stride=stride)
        for reply in replies:
            for n in (1, 3, 4, 8):
                assert t._parse_permutation(reply, n) == j._parse_permutation(reply, n)
        for n in range(0, 40):
            assert t._window_starts(n) == j._window_starts(n)


def test_constructor_bounds_match_jax():
    for kw in (dict(window=1), dict(window=4, stride=0), dict(window=4, stride=5)):
        with pytest.raises(ValueError):
            ListwiseLLMReranker(_ScriptedChat(), **kw)
        with pytest.raises(ValueError):
            JListwise(_ScriptedChat(), **kw)


@pytest.mark.parametrize("window,stride", [(4, 2), (3, 1), (8, 4)])
def test_rerank_batch_over_a_scripted_chat_equals_jax(window, stride):
    rng = np.random.default_rng(window * 10 + stride)
    queries = [f"q{i}" for i in range(4)]
    docs_lists = [[f"d{i}-{j}" for j in range(n)] for i, n in enumerate((9, 1, 4, 0))]
    replies = []
    for _ in range(40):
        perm = rng.permutation(window) + 1
        kind = rng.integers(0, 4)
        replies.append("garbage" if kind == 0 else " > ".join(f"[{i}]" for i in perm[:window - kind + 1]))
    tchat, jchat = _ScriptedChat(replies), _ScriptedChat(replies)
    got = ListwiseLLMReranker(tchat, window=window, stride=stride).rerank_batch(queries, docs_lists)
    want = JListwise(jchat, window=window, stride=stride).rerank_batch(queries, docs_lists)
    assert got == want
    assert tchat.prompts == jchat.prompts
    for perm, docs in zip(got, docs_lists):
        assert sorted(perm) == list(range(len(docs)))


def test_listwise_sliding_window_bubbles_bottom_up():
    # round 1 (start 2, docs c d e f): best-last -> f e d c
    # round 2 (start 0, docs a b f e): f first -> f a b e
    chat = _ScriptedChat(["[4] > [3] > [2] > [1]", "[3] > [1] > [2] > [4]"])
    rr = ListwiseLLMReranker(chat, window=4, stride=2)
    assert rr.rerank_batch(["q"], [["a", "b", "c", "d", "e", "f"]])[0] == [5, 0, 1, 4, 3, 2]
    assert len(chat.prompts) == 2
    chat = _ScriptedChat(["[2]"])  # partial: ranked ids first, the rest in order
    assert ListwiseLLMReranker(chat, window=4, stride=2).rerank_batch(
        ["q"], [["a", "b", "c"]])[0] == [1, 0, 2]
    chat = _ScriptedChat(forbid=True)  # degenerate lists never consult the model
    assert ListwiseLLMReranker(chat, window=4, stride=2).rerank_batch(
        ["q", "r"], [["only"], []]) == [[0], []]
    chat = _ScriptedChat([encode_serve_error("deadline")])  # a failed request
    assert ListwiseLLMReranker(chat, window=4).rerank_batch(["q"], [["a", "b"]]) == [[0, 1]]


# ------------------------------------------------------------ the pipeline
@pytest.fixture(scope="module")
def models():
    _, tcfg = configs("float32")
    tok = HashTokenizer(vocab_size=1000)
    emb = SentenceEmbedderModel(tcfg, params=from_jax_params(np_encoder_params(70)),
                                tokenizer=tok, max_length=32, device="cpu")
    rr = CrossEncoderModel(tcfg, params=from_jax_params(np_encoder_params(71, 1.0, 0.3)),
                           head=from_jax_params(np_head(72, 1.0)), tokenizer=tok,
                           device="cpu")
    yield emb, rr
    emb.close()


def _make_pipe(models, **kw):
    emb, rr = models
    p = FusedRAGPipeline(emb, rr, reserved_space=64, doc_seq=16, pair_seq=48, **kw)
    rng = np.random.default_rng(13)
    p.docs = [" ".join(rng.choice(WORDS, 6)) for _ in range(32)]
    p.add([f"k{i}" for i in range(32)], p.docs)
    p.query = " ".join(rng.choice(WORDS, 5))
    return p


def test_llm_rerank_off_never_consults_the_llm(models):
    chat = _ScriptedChat(forbid=True)
    p = _make_pipe(models, llm_reranker=ListwiseLLMReranker(chat, window=4, stride=2))
    base = _make_pipe(models)
    assert p.llm_rerank is False and base._text_by_key == {}  # the JAX default; no texts kept
    assert p.retrieve_rerank(p.query, k=8) == base.retrieve_rerank(p.query, k=8)
    assert p.retrieve_rerank_batch([p.query] * 2, 8) == base.retrieve_rerank_batch(
        [p.query] * 2, 8)


def test_llm_rerank_permutes_the_order_and_keeps_the_scores(models):
    chat = _ScriptedChat(["[4] > [3] > [2] > [1]"])
    p = _make_pipe(models, llm_reranker=ListwiseLLMReranker(chat, window=4, stride=4))
    base = p.retrieve_rerank(p.query, k=4)
    p.llm_rerank = True
    before = probes.cascade_stats()["pairs"].get("llm_rerank", 0)
    out = p.retrieve_rerank(p.query, k=4)
    assert [key for key, _ in out] == [key for key, _ in reversed(base)]
    assert dict(out) == dict(base)  # scores ride with their keys
    assert probes.cascade_stats()["pairs"]["llm_rerank"] == before + 4
    assert len(chat.prompts) == 1
    texts = dict(zip([f"k{i}" for i in range(32)], p.docs))
    assert f"[1] {texts[base[0][0]]}" in chat.prompts[0]  # doc texts reached the prompt
    chat.replies = ["no identifiers here at all"]
    assert p.retrieve_rerank(p.query, k=4) == base
    p.remove([base[0][0]])
    assert base[0][0] not in p._text_by_key and len(p._text_by_key) == 31


# ----------------------------------------------- through the port's server
def test_listwise_rounds_through_the_continuous_server():
    cfg = TD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4, intermediate=64,
                           max_position=256, dtype=torch.float32)
    jcfg = JD.DecoderConfig(vocab_size=128, hidden=32, layers=2, heads=4, intermediate=64,
                            max_position=256)
    params = from_jax_params(jax.tree.map(np.asarray, JD.init_params(jax.random.PRNGKey(3),
                                                                      jcfg)))
    tracing.reset_traces()
    chat = DecoderChat(params=params, cfg=cfg, tokenizer=ToyCharTokenizer(400),
                       max_new_tokens=8, max_prompt_tokens=96, continuous=True, n_slots=4,
                       chunk_steps=4, pipeline_depth=2, prefill_chunk=8, device="cpu",
                       paged_kv=True, paged_kv_block=8)
    rr = ListwiseLLMReranker(chat, window=4, stride=2, max_new_tokens=8)
    docs_lists = [[f"doc {i} {' '.join(WORDS[:i + 2])}" for i in range(n)] for n in (6, 4, 1)]
    out: dict = {}

    def run():
        out["perms"] = rr.rerank_batch(["which is delta", "theta?", "x"], docs_lists)

    try:
        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(WAIT)
        assert not t.is_alive(), "a listwise round did not finish"
        srv = chat.server
        assert srv.failed is None
        spans = chat.recent_traces()
    finally:
        chat.close()
    perms = out["perms"]
    for perm, docs in zip(perms, docs_lists):
        assert sorted(perm) == list(range(len(docs)))
    # rounds: 2 windows for 6 docs, 1 for 4, none for 1 -> 3 requests, each
    # a prompt longer than max_prompt_tokens (cut to it, as any chat prompt)
    assert len(spans) == 3 and {s["attrs"]["tenant"] for s in spans} == {"rerank"}
    assert all(s["attrs"]["prompt_tokens"] <= 96 for s in spans)
