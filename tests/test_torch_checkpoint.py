"""The port's HF checkpoint loaders (``pathway_tpu_torch/models/checkpoint.py``)
and the entry points that take a checkpoint, after the JAX package's
tests/test_checkpoint.py and tests/test_decoder.py: random-init
``transformers`` models are written in both HF formats under ``tmp_path``,
loaded by the port (and by the JAX package), and run.

Tolerances, as the JAX tests set them:
* encoder hidden states and cross-encoder scores in f32: 2e-4 against
  ``transformers`` at live positions;
* bf16 pooled embeddings: 1e-2 a component, cosine > 0.999;
* GPT-2 logits in f32: 1e-2 at live positions;
* the port's loaders against the JAX loaders: array-equal;
* greedy tokens (f32): equal to JAX static ``generate``.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pathway_tpu.models import checkpoint as JC  # noqa: E402
from pathway_tpu_torch.models import checkpoint as TC  # noqa: E402
from pathway_tpu_torch.models import decoder as TD  # noqa: E402
from pathway_tpu_torch.models.bpe import BPETokenizer, bytes_to_unicode  # noqa: E402
from pathway_tpu_torch.models.cross_encoder import CrossEncoderModel, score_fn  # noqa: E402
from pathway_tpu_torch.models.embedder import SentenceEmbedderModel, embed_fn  # noqa: E402
from pathway_tpu_torch.models.params import from_jax_params  # noqa: E402
from pathway_tpu_torch.models.transformer import encode  # noqa: E402

SMALL = dict(
    vocab_size=512,
    hidden_size=32,
    num_hidden_layers=2,
    num_attention_heads=4,
    intermediate_size=64,
    max_position_embeddings=64,
    type_vocab_size=2,
    layer_norm_eps=1e-12,
    hidden_act="gelu",
)


def _save(state: dict, path, fmt: str) -> None:
    if fmt == "safetensors":
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in state.items()},
                  str(path / "model.safetensors"))
    else:
        torch.save(state, str(path / "pytorch_model.bin"))


def _make_bert(tmp_path, fmt="safetensors", seed=0, head=False):
    torch.manual_seed(seed)
    if head:
        model = transformers.BertForSequenceClassification(
            transformers.BertConfig(**SMALL, num_labels=1)).eval()
    else:
        model = transformers.BertModel(transformers.BertConfig(**SMALL)).eval()
    (tmp_path / "config.json").write_text(json.dumps({**SMALL, "model_type": "bert"}))
    _save(model.state_dict(), tmp_path, fmt)
    return model


def _inputs(batch=3, seq=10, vocab=512, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, size=(batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), dtype=np.int32)
    mask[1, 6:] = 0  # one padded row exercises the mask path
    ids[1, 6:] = 0
    return ids, mask


def _f32(cfg):
    return dataclasses.replace(cfg, dtype=torch.float32)


def _tree_equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _tree_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ encoder
@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_converted_bert_matches_transformers_and_jax_loader(tmp_path, fmt):
    model = _make_bert(tmp_path, fmt)
    cfg = _f32(TC.config_from_hf(str(tmp_path)))
    state = TC.load_hf_state_dict(str(tmp_path))
    np_params = TC.params_from_hf_bert(state, cfg)
    _tree_equal(np_params, JC.params_from_hf_bert(
        JC.load_hf_state_dict(str(tmp_path)), JC.config_from_hf(str(tmp_path))))
    ids, mask = _inputs()
    with torch.no_grad():
        ref = model(input_ids=_t(ids).long(), attention_mask=_t(mask).long()
                    ).last_hidden_state.numpy()
    got = encode(from_jax_params(np_params), _t(ids), _t(mask), cfg).numpy()
    m = mask[:, :, None].astype(bool)
    assert np.max(np.abs((got - ref) * m)) < 2e-4


def test_converted_bert_bf16_embedding_within_tolerance(tmp_path):
    model = _make_bert(tmp_path)
    params, cfg, head = TC.load_encoder_checkpoint(str(tmp_path))
    assert head is None and cfg.dtype == torch.bfloat16
    ids, mask = _inputs()
    with torch.no_grad():
        hidden = model(input_ids=_t(ids).long(), attention_mask=_t(mask).long()
                       ).last_hidden_state
    m_t = _t(mask).float()[:, :, None]
    ref = torch.nn.functional.normalize((hidden * m_t).sum(1) / m_t.sum(1), dim=-1).numpy()
    got = embed_fn(from_jax_params(params), _t(ids), _t(mask), cfg).numpy()
    assert np.max(np.abs(got - ref)) < 1e-2
    assert np.min(np.sum(got * ref, axis=1)) > 0.999


def test_token_type_ids_affect_output(tmp_path):
    model = _make_bert(tmp_path)
    cfg = _f32(TC.config_from_hf(str(tmp_path)))
    params = from_jax_params(TC.params_from_hf_bert(TC.load_hf_state_dict(str(tmp_path)), cfg))
    ids, mask = _inputs()
    types = np.zeros_like(ids)
    types[:, 5:] = 1
    with torch.no_grad():
        ref = model(input_ids=_t(ids).long(), attention_mask=_t(mask).long(),
                    token_type_ids=_t(types).long()).last_hidden_state.numpy()
    got = encode(params, _t(ids), _t(mask), cfg, _t(types)).numpy()
    m = mask[:, :, None].astype(bool)
    assert np.max(np.abs((got - ref) * m)) < 2e-4


def test_cross_encoder_head_matches_transformers_and_jax_loader(tmp_path):
    clf = _make_bert(tmp_path, seed=3, head=True)
    params, cfg, head = TC.load_encoder_checkpoint(str(tmp_path))
    jparams, _, jhead = JC.load_encoder_checkpoint(str(tmp_path))
    _tree_equal(params, jparams)
    _tree_equal(head, jhead)
    cfg = _f32(cfg)
    ids, mask = _inputs()
    types = np.zeros_like(ids)
    types[:, 5:] = 1
    with torch.no_grad():
        ref = clf(input_ids=_t(ids).long(), attention_mask=_t(mask).long(),
                  token_type_ids=_t(types).long()).logits.numpy()[:, 0]
    got = score_fn(from_jax_params(params), from_jax_params(head), _t(ids), _t(mask),
                   cfg, _t(types)).numpy()
    assert np.max(np.abs(got - ref)) < 2e-4


def test_safetensors_reader_matches_torch_and_widens_bf16(tmp_path):
    from safetensors.torch import save_file

    _make_bert(tmp_path)
    st = TC.read_safetensors(str(tmp_path / "model.safetensors"))
    torch.manual_seed(0)
    ref = transformers.BertModel(transformers.BertConfig(**SMALL)).state_dict()
    assert set(st) <= set(ref)
    for name, a in st.items():
        assert np.array_equal(a, ref[name].numpy()), name
    g = torch.Generator().manual_seed(4)
    mixed = {"bf": torch.randn((3, 5), generator=g).bfloat16(),
             "f16": torch.randn((4,), generator=g).half(),
             "i64": torch.arange(6).reshape(2, 3)}
    save_file(mixed, str(tmp_path / "mixed.safetensors"))
    got = TC.read_safetensors(str(tmp_path / "mixed.safetensors"))
    want = JC.read_safetensors(str(tmp_path / "mixed.safetensors"))
    assert got["bf"].dtype == np.float32
    assert np.array_equal(got["bf"], mixed["bf"].float().numpy())
    for k in mixed:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


def test_prefix_stripping_and_missing_head(tmp_path):
    model = _make_bert(tmp_path)
    sd = {f"bert.{k}": v.numpy() for k, v in model.state_dict().items()}
    cfg = TC.config_from_hf(str(tmp_path))
    assert TC.params_from_hf_bert(sd, cfg)["embeddings"]["word"].shape == (512, 32)
    with pytest.raises(KeyError):
        TC.classifier_head_from_hf({"embeddings.word_embeddings.weight": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="hidden_act"):
        TC.config_from_hf({**SMALL, "hidden_act": "relu"})
    assert TC.has_checkpoint_weights(str(tmp_path))
    assert not TC.has_checkpoint_weights(str(tmp_path / "nope"))
    with pytest.raises(FileNotFoundError):
        TC.load_hf_state_dict(str(tmp_path / "config.json").rsplit("/", 1)[0] + "/sub")


def _write_vocab(tmp_path, words):
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    (tmp_path / "vocab.txt").write_text("\n".join(specials + words) + "\n")


def test_from_pretrained_end_to_end(tmp_path):
    """Checkpoint dir + tokenizer files -> the port's embedder with the
    saved weights; its vectors match the transformers mean-pooling
    pipeline within bf16 noise, and the JAX embedder's."""
    from pathway_tpu.models.embedder import SentenceEmbedderModel as JEmbed

    model = _make_bert(tmp_path)
    _write_vocab(tmp_path, ["hello", "world", "stream", "##ing", "data"])
    emb = SentenceEmbedderModel.from_pretrained(str(tmp_path), max_length=16, device="cpu")
    try:
        texts = ["hello world", "streaming data hello"]
        out = emb.embed_batch(texts)
    finally:
        emb.close()
    assert out.shape == (2, 32)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)
    tok = transformers.BertTokenizerFast(vocab_file=str(tmp_path / "vocab.txt"))
    enc = tok(texts, return_tensors="pt", padding=True)
    with torch.no_grad():
        hidden = model(input_ids=enc["input_ids"],
                       attention_mask=enc["attention_mask"]).last_hidden_state
    m = enc["attention_mask"][:, :, None].float()
    ref = torch.nn.functional.normalize((hidden * m).sum(1) / m.sum(1), dim=-1).numpy()
    assert np.max(np.abs(out - ref)) < 1e-2
    jm = JEmbed.from_pretrained(str(tmp_path), max_length=16)
    try:
        jout = jm.embed_batch(texts)
    finally:
        jm.close()
    assert np.min(np.sum(out * jout, axis=1)) > 0.999


def test_xpack_embedder_loads_checkpoint_dir(tmp_path):
    from pathway_tpu_torch.xpacks.llm import SentenceTransformerEmbedder

    _make_bert(tmp_path)
    _write_vocab(tmp_path, ["hello", "world"])
    emb = SentenceTransformerEmbedder(model=str(tmp_path), device="cpu")
    direct = SentenceEmbedderModel.from_pretrained(str(tmp_path), device="cpu")
    try:
        out = emb(["hello world"])
        assert out[0].shape == (32,)
        # the weights came from the checkpoint, not random init
        np.testing.assert_allclose(out[0], direct.embed_batch(["hello world"])[0],
                                   atol=1e-5)
    finally:
        emb.close()
        direct.close()
    only_tok = tmp_path / "tok"
    only_tok.mkdir()
    _write_vocab(only_tok, ["hello"])
    (only_tok / "config.json").write_text(json.dumps({"model_type": "bert"}))
    emb = SentenceTransformerEmbedder(model=str(only_tok), device="cpu", pipeline=False)
    assert emb.model.cfg.hidden == 384  # tokenizer files only: from_local


def test_xpack_reranker_loads_checkpoint_dir(tmp_path):
    from pathway_tpu.xpacks.llm.rerankers import CrossEncoderReranker as JRerank
    from pathway_tpu_torch.xpacks.llm import CrossEncoderReranker

    _make_bert(tmp_path, seed=5, head=True)
    _write_vocab(tmp_path, ["hello", "world", "query", "doc"])
    rr = CrossEncoderReranker(model_name=str(tmp_path), custom_kwargs=dict(device="cpu"))
    docs, queries = ["hello doc", "world"], ["query world", "query"]
    scores = rr(docs, queries)
    assert len(scores) == 2 and all(isinstance(s, float) for s in scores)
    want = JRerank(model_name=str(tmp_path)).__wrapped__(docs, queries)
    assert np.max(np.abs(np.array(scores) - np.array(want))) < 1e-2
    no_head = tmp_path / "plain"
    no_head.mkdir()
    _make_bert(no_head)
    with pytest.raises(ValueError, match="classifier head"):
        CrossEncoderModel.from_pretrained(str(no_head), device="cpu")


# ------------------------------------------------------------------ decoder
GPT2 = dict(vocab_size=257, n_positions=64, n_embd=48, n_layer=3, n_head=4)


def _gpt2_dir(tmp_path, fmt="bin"):
    """A random-init GPT-2 with the byte-level vocab: 256 byte symbols,
    no merges, and <|endoftext|> at 256."""
    torch.manual_seed(0)
    m = transformers.GPT2LMHeadModel(transformers.GPT2Config(**GPT2)).eval()
    (tmp_path / "config.json").write_text(json.dumps({**GPT2, "model_type": "gpt2"}))
    # the causal-mask buffers are not weights, and lm_head is tied to wte
    _save({k: v for k, v in m.state_dict().items()
           if k.split(".")[-2:] not in (["attn", "bias"], ["attn", "masked_bias"])
           and k != "lm_head.weight"}, tmp_path, fmt)
    b2u = bytes_to_unicode()
    vocab = {b2u[i]: i for i in range(256)}
    vocab["<|endoftext|>"] = 256
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n")
    return m


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_hf_gpt2_logits_parity_and_jax_loader(tmp_path, fmt):
    m = _gpt2_dir(tmp_path, fmt)
    params, cfg = TC.load_decoder_checkpoint(str(tmp_path))
    assert (cfg.vocab_size, cfg.hidden, cfg.layers, cfg.heads, cfg.intermediate) == \
        (257, 48, 3, 4, 192)
    jparams, jcfg = JC.load_decoder_checkpoint(str(tmp_path))
    _tree_equal(params, jparams)
    assert (jcfg.hidden, jcfg.layers, jcfg.max_position) == (cfg.hidden, cfg.layers,
                                                             cfg.max_position)
    cfg = _f32(cfg)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 257, (3, 10)).astype(np.int64)
    mask = np.ones((3, 10), np.int64)
    mask[2, :4] = 0
    pos = np.clip(np.cumsum(mask, 1) - 1, 0, None)
    with torch.no_grad():
        ref = m(input_ids=_t(ids), attention_mask=_t(mask),
                position_ids=_t(pos)).logits.numpy()
    got = TD.forward(from_jax_params(params), _t(ids.astype(np.int32)),
                     _t(mask.astype(np.int32)), cfg).float().numpy()
    drift = np.abs(got - ref)[mask.astype(bool)].max()
    assert drift < 1e-2, f"logit drift {drift}"


PROMPTS = ["hello world", "the quick brown fox", "a", "checkpoint loading on the card"]


@pytest.fixture(scope="module")
def gpt2_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("gpt2")
    _gpt2_dir(path)
    return path


@pytest.fixture(scope="module")
def jax_greedy(gpt2_dir):
    """JAX static greedy generate of each prompt on the same checkpoint."""
    from pathway_tpu.models import decoder as JD
    from pathway_tpu.models.bpe import BPETokenizer as JBPE

    jparams, jcfg = JC.load_decoder_checkpoint(str(gpt2_dir))
    jparams = jax.tree.map(jnp.asarray, jparams)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    tok = JBPE.from_dir(str(gpt2_dir))
    out = []
    for p in PROMPTS:
        ids = tok.encode(p)
        out.append(np.asarray(JD.generate(
            jparams, jnp.asarray([ids], jnp.int32), jnp.ones((1, len(ids)), jnp.int32),
            jcfg, 6))[0].tolist())
    return out


@pytest.mark.parametrize("continuous", [False, True])
def test_decoder_chat_from_checkpoint_matches_jax_generate(gpt2_dir, jax_greedy, continuous):
    from pathway_tpu_torch.xpacks.llm import DecoderChat

    cfg = _f32(TC.decoder_config_from_hf(str(gpt2_dir)))
    kw = dict(continuous=True, n_slots=2, chunk_steps=2, prefill_chunk=8,
              paged_kv=True, paged_kv_block=8, paged_kernel=True,
              flash_prefill=True) if continuous else {}
    chat = DecoderChat(checkpoint_path=str(gpt2_dir), cfg=cfg, max_new_tokens=6,
                       max_prompt_tokens=32, device="cpu", **kw)
    try:
        assert isinstance(chat.tokenizer, BPETokenizer)
        got = chat(PROMPTS)
        if continuous:
            reqs = chat.submit_batch(PROMPTS)
            for r in reqs:
                assert r.done.wait(60)
            assert [r.tokens for r in reqs] == jax_greedy
    finally:
        chat.close()
    assert got == [chat.tokenizer.decode(t) for t in jax_greedy]


def test_decoder_chat_needs_a_checkpoint_or_params():
    from pathway_tpu_torch.xpacks.llm import DecoderChat

    with pytest.raises(ValueError, match="checkpoint_path"):
        DecoderChat(device="cpu")
