"""The port's tokenizers: the C++ batch path (``pathway_tpu_torch/native``)
against the port's Python path and the JAX package's tokenizers, the encode
memo, and the native build's failure modes.

Every comparison of ids is exact: the same hash, vocab and layout on every
path. Rows with non-ASCII bytes (Unicode case folding, accent stripping)
re-tokenize in Python on the native path, as in the JAX package, and are
compared like every other row.
"""

import gc
import json

import numpy as np
import pytest

from pathway_tpu.models.tokenizer import HashTokenizer as JHash
from pathway_tpu.models.tokenizer import WordPieceTokenizer as JWordPiece
from pathway_tpu_torch import native
from pathway_tpu_torch.models import tokenizer as T
from pathway_tpu_torch.models.tokenizer import HashTokenizer, WordPieceTokenizer

# the JAX package's native-vs-Python cases (tests/test_native.py)
HASH_CASES = [
    ["5K run", "İstanbul"],  # Unicode case folding changes word ids
    ["Hello World foo-BAR 123", "", "émigré café ™ x", "a" * 500],
    ["plain ascii", "MORE ascii 42", "x " * 200],
]

# tests/test_wordpiece.py
VOCAB = (
    ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    + ["the", "quick", "brown", "fox", "jump", "##ed", "##ing", "##s",
       "run", "over", "lazy", "dog", "stream", "tensor", "in", "##dex",
       "!", ",", ".", "?", "'", "un", "##aff", "##able"]
    + list("abcdefghijklmnopqrstuvwxyz0123456789")
    + ["##" + c for c in "abcdefghijklmnopqrstuvwxyz0123456789"]
)
WP_TEXTS = [
    "The quick brown fox JUMPED over the lazy dog!",
    "unaffable streams, indexing?",
    "zzz unknownword the",
    "",
    "a b c 1 2 3 . . .",
    "x" * 250,  # > 200-char word -> [UNK]
    "  spaces   and\ttabs\nnewlines  ",
    "café junÉ the",  # NFD accent strip
    "naïve fox",
    "İstanbul run",  # dotted capital I case folding
]


def _random_texts(seed: int, n: int) -> list[str]:
    """Seeded texts over ASCII letters, digits, punctuation, whitespace,
    control characters and a few non-ASCII letters."""
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
                    "     \t\n.,!?'-#\x01\x7f") + ["é", "İ", "K", "ß", "東"]
    out = []
    for _ in range(n):
        chars = rng.choice(alphabet, int(rng.integers(0, 80)))
        if rng.random() < 0.7:  # most rows stay ASCII, as real corpora do
            chars = [c for c in chars if ord(c) < 128]
        out.append("".join(chars))
    return out


# ------------------------------------------------------------------- hashing
@pytest.mark.parametrize("case", range(len(HASH_CASES)))
@pytest.mark.parametrize("vocab", [1000, 30522])
def test_hash_native_equals_python_and_jax(case, vocab):
    texts = HASH_CASES[case]
    nat = HashTokenizer(vocab_size=vocab, max_length=64, memo=False)
    py = HashTokenizer(vocab_size=vocab, max_length=64, native=False, memo=False)
    jax_tok = JHash(vocab_size=vocab, max_length=64)
    for kw in ({}, {"pad_to": 80}, {"max_length": 8}, {"pad_to": 3}):
        got = nat(texts, **kw)
        for want in (py(texts, **kw), jax_tok(texts, **kw)):
            for a, b in zip(got, want):
                assert a.dtype == b.dtype == np.int32
                assert np.array_equal(a, b), (texts, kw)


def test_hash_native_fallback_rows_are_the_non_ascii_ones():
    ids, fallback = native.hash_tokenize(["abc", "İx", "", "é"], 16, 999, 30522 - 999)
    assert fallback == [1, 3]
    assert ids.flags.writeable and ids.shape == (4, 3)


@pytest.mark.parametrize("seed", [0, 1])
def test_hash_random_texts_native_python_jax(seed):
    texts = _random_texts(seed, 300)
    nat = HashTokenizer(max_length=32, memo=False)
    py = HashTokenizer(max_length=32, native=False, memo=False)
    for a, b, c in zip(nat(texts), py(texts), JHash(max_length=32)(texts)):
        assert np.array_equal(a, b) and np.array_equal(a, c)


# ----------------------------------------------------------------- WordPiece
@pytest.fixture()
def hf_tokenizer(tmp_path):
    transformers = pytest.importorskip("transformers")
    p = tmp_path / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n")
    return transformers.BertTokenizer(vocab_file=str(p), do_lower_case=True)


def test_wordpiece_matches_transformers(hf_tokenizer):
    ids, mask = WordPieceTokenizer(VOCAB, max_length=32)(WP_TEXTS)
    for i, t in enumerate(WP_TEXTS):
        expect = hf_tokenizer(t, truncation=True, max_length=32)["input_ids"]
        assert [int(x) for x in ids[i][: int(mask[i].sum())]] == expect, t


@pytest.mark.parametrize("kw", [{}, {"pad_to": 40}, {"max_length": 6}])
def test_wordpiece_native_equals_python_and_jax(kw):
    nat = WordPieceTokenizer(VOCAB, max_length=32, memo=False)
    py = WordPieceTokenizer(VOCAB, max_length=32, native=False, memo=False)
    want_jax = JWordPiece(VOCAB, max_length=32)(WP_TEXTS, **kw)
    got = nat(WP_TEXTS, **kw)
    for want in (py(WP_TEXTS, **kw), want_jax):
        for a, b in zip(got, want):
            assert np.array_equal(a, b), kw


@pytest.mark.parametrize("seed", [2, 3])
def test_wordpiece_random_texts_native_python_jax(seed):
    texts = _random_texts(seed, 300)
    nat = WordPieceTokenizer(VOCAB, max_length=48, memo=False)
    py = WordPieceTokenizer(VOCAB, max_length=48, native=False, memo=False)
    for a, b, c in zip(nat(texts), py(texts), JWordPiece(VOCAB, max_length=48)(texts)):
        assert np.array_equal(a, b) and np.array_equal(a, c)


@pytest.mark.parametrize("native_path", [True, False])
def test_wordpiece_duplicate_vocab_entries_keep_last_id(native_path):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "run", "##s", "run"]
    ids, mask = WordPieceTokenizer(vocab, max_length=8, native=native_path)(["run runs"])
    assert [int(x) for x in ids[0][: int(mask[0].sum())]] == [2, 6, 6, 5, 3]


def test_wordpiece_vocab_file_round_trip(tmp_path):
    p = tmp_path / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n")
    wp = WordPieceTokenizer.from_vocab_file(str(p), max_length=16)
    assert wp.vocab_size == len(VOCAB)
    ids, mask = wp(["the fox runs"])
    assert ids[0][0] == wp.cls_id
    assert ids[0][int(mask[0].sum()) - 1] == wp.sep_id


def test_wordpiece_pad_to_and_mask_contract():
    ids, mask = WordPieceTokenizer(VOCAB, max_length=16)(["the fox", "the"], pad_to=12)
    assert ids.shape == (2, 12) and mask.shape == (2, 12)
    assert mask[0].sum() == 4 and mask[1].sum() == 3
    assert (ids[mask == 0] == 0).all()


def test_wordpiece_cased_vocab_needs_the_python_path():
    """The C++ path lowercases every row, so a cased vocab must say
    native=False; it then keeps its cased ids, as the JAX tokenizer does."""
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "Hello", "hello"]
    with pytest.raises(ValueError, match="native=False"):
        WordPieceTokenizer(vocab, max_length=8, lowercase=False)
    wp = WordPieceTokenizer(vocab, max_length=8, lowercase=False, native=False)
    ids, mask = wp(["Hello hello"])
    want = JWordPiece(vocab, max_length=8, lowercase=False)(["Hello hello"])
    assert [int(x) for x in ids[0][: int(mask[0].sum())]] == [2, 4, 5, 3]
    assert np.array_equal(ids, want[0]) and np.array_equal(mask, want[1])


def test_wordpiece_tiny_max_length():
    wp = WordPieceTokenizer(VOCAB, max_length=16)
    for ml in (1, 2, 3):
        ids, mask = wp(["the quick brown fox"], max_length=ml)
        got = [int(x) for x in ids[0][: int(mask[0].sum())]]
        assert got[0] == wp.cls_id and got[-1] == wp.sep_id
        assert len(got) <= max(ml, 2)


def test_wordpiece_vocab_handle_freed_and_reused():
    wp1 = WordPieceTokenizer(VOCAB, max_length=8)
    wp1(["the"])  # binds the native handle
    h1 = wp1._native_handle
    del wp1
    gc.collect()
    wp2 = WordPieceTokenizer(VOCAB, max_length=8)
    wp2(["the"])
    assert wp2._native_handle == h1  # the freed slot is reused, not leaked


def test_wordpiece_control_chars_removed_not_split(hf_tokenizer):
    texts = ["ab\x01cd the", "run\x0bning", "fox\x7fes"]
    nat = WordPieceTokenizer(VOCAB, max_length=16, memo=False)(texts)
    py = WordPieceTokenizer(VOCAB, max_length=16, native=False, memo=False)(texts)
    assert all(np.array_equal(a, b) for a, b in zip(nat, py))
    for i, t in enumerate(texts):
        expect = hf_tokenizer(t, truncation=True, max_length=16)["input_ids"]
        assert [int(x) for x in nat[0][i][: int(nat[1][i].sum())]] == expect, t


# ---------------------------------------------------------------------- memo
@pytest.mark.parametrize("native_path", [True, False])
def test_hash_memo_parity(native_path):
    """The memo's answer equals the unmemoized one, and JAX's, with one
    entry per distinct text (tests/test_prefix_cache.py's memo case)."""
    texts = ["alpha beta", "gamma", "alpha beta", ""]
    cold = HashTokenizer(vocab_size=1000, native=native_path, memo=False)(texts, pad_to=16)
    tok = HashTokenizer(vocab_size=1000, native=native_path)
    warm1 = tok(texts, pad_to=16)
    warm2 = tok(texts, pad_to=16)  # all hits
    assert len(tok._memo) == 3
    jax_out = JHash(vocab_size=1000)(texts, pad_to=16)
    for a, b, c, d in zip(cold, warm1, warm2, jax_out):
        assert np.array_equal(a, b) and np.array_equal(a, c) and np.array_equal(a, d)


@pytest.mark.parametrize("native_path", [True, False])
def test_wordpiece_memo_parity(native_path):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", "world",
             "hel", "##lo", "##rld", "wo"]
    texts = ["hello world", "world", "hello world"]
    cold = WordPieceTokenizer(vocab, native=native_path, memo=False)(texts, pad_to=8)
    tok = WordPieceTokenizer(vocab, native=native_path)
    warm1 = tok(texts, pad_to=8)
    warm2 = tok(texts, pad_to=8)
    assert len(tok._memo) == 2
    jax_out = JWordPiece(vocab)(texts, pad_to=8)
    for a, b, c, d in zip(cold, warm1, warm2, jax_out):
        assert np.array_equal(a, b) and np.array_equal(a, c) and np.array_equal(a, d)


def test_memo_width_is_this_batch_and_lru_is_bounded(monkeypatch):
    """Width is the longest row of THIS batch (floor 2), never a width
    remembered from an earlier batch; the LRU drops its oldest entry past
    MEMO_MAX, and max_length is part of the key."""
    monkeypatch.setattr(T, "MEMO_MAX", 3)
    tok = HashTokenizer(vocab_size=1000)
    long_ids, _ = tok(["one two three four five six"])
    assert long_ids.shape == (1, 8)
    ids, mask = tok(["one", "one two three four five six"][:1])
    assert ids.shape == (1, 3) and mask.sum() == 3
    ids, _ = tok([""])
    assert ids.shape == (1, 2)
    tok(["a b"], max_length=3)
    assert len(tok._memo) == 3  # "one ... six" was the oldest and went
    keys = list(tok._memo.entries)
    assert ("one two three four five six", 256) not in keys
    assert ("a b", 3) in keys
    a, _ = tok(["a b"], max_length=3)
    b, _ = tok(["a b"])
    assert a.shape == (1, 3) and b.shape == (1, 4)


# --------------------------------------------------------------- the build
def test_native_library_is_built_under_build_dir():
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.name.startswith("_tokenize-")


def test_failed_build_raises_and_leaves_nothing(tmp_path, monkeypatch):
    bad = tmp_path / "_tokenize.cpp"
    bad.write_text("#include <Python.h>\nthis is not C++;\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="build failed"):
        native.build()
    assert list((tmp_path / "build").iterdir()) == []


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()


def test_non_string_rows_raise_on_both_paths():
    for nat in (True, False):
        with pytest.raises((TypeError, AttributeError)):
            HashTokenizer(native=nat, memo=False)([object()])


def test_tokenizer_defaults_are_the_jax_flag_defaults():
    tok = HashTokenizer()
    assert tok.native is True and tok._memo is not None
    wp = WordPieceTokenizer(VOCAB)
    assert wp.native is True and wp._memo is not None
    assert T.MEMO_MAX == 65536


def test_load_tokenizer_semantics(tmp_path):
    """No path: a HashTokenizer. A path: the local HF tokenizer through
    transformers, with the same ids as the JAX package's adapter."""
    assert isinstance(T.load_tokenizer(None, max_length=32), HashTokenizer)
    pytest.importorskip("transformers")
    from pathway_tpu.models.tokenizer import load_tokenizer as j_load

    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "bert"}))
    got, want = T.load_tokenizer(str(tmp_path), 16), j_load(str(tmp_path), 16)
    for kw in ({}, {"pad_to": 20}):
        for a, b in zip(got(WP_TEXTS[:4], **kw), want(WP_TEXTS[:4], **kw)):
            assert np.array_equal(a, b)
    pairs = [("the fox", "lazy dog"), ("run", "")]
    for a, b in zip(got.encode_pairs(pairs, return_types=True),
                    want.encode_pairs(pairs, return_types=True)):
        assert np.array_equal(a, b)
    # an explicit path that does not load raises; it never falls back
    with pytest.raises((OSError, ValueError)):
        T.load_tokenizer(str(tmp_path / "missing"))
