"""Tokenizers of the port (counterpart of ``pathway_tpu/models/tokenizer.py``).

* ``HashTokenizer``: vocab-free and deterministic. Lowercases, splits on
  ASCII alphanumeric runs and maps each word into the vocab range with a
  stable FNV-1a hash, behind a BERT-compatible id layout
  (``[CLS] ... [SEP]``).
* ``WordPieceTokenizer``: BERT's basic tokenization and greedy
  longest-match WordPiece over a plain vocab (``vocab.txt``).
* ``load_tokenizer(path)``: a local HuggingFace tokenizer through
  ``transformers`` when a path is given, a ``HashTokenizer`` otherwise.

Both own tokenizers encode a batch in the C++ extension of
``pathway_tpu_torch/native`` (``native=True``, built at first use; a
failed build raises). Rows holding non-ASCII bytes re-tokenize in Python,
because Unicode case folding and accent stripping are part of the
semantics; ``native=False`` runs every row in Python. With ``memo=True``
each instance keeps a ``(text, max_length)``-keyed LRU of token
sequences and encodes only the rows it has not seen. Every path gives the
same ids as the JAX package for the same text.
"""

from __future__ import annotations

import itertools
import re
import threading
import unicodedata
from collections import OrderedDict
from typing import Sequence

import numpy as np

from pathway_tpu_torch import native as native_mod
from pathway_tpu_torch.ops import next_pow2

PAD_ID = 0
CLS_ID = 101
SEP_ID = 102
UNK_ID = 100

_WORD_RE = re.compile(r"[a-z0-9]+")

# entries per tokenizer instance in the encode memo
MEMO_MAX = 65536


def _fnv1a(s: str) -> int:
    h = 0xCBF29CE484222325
    for b in s.encode("utf-8"):
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _scatter_rows(flat: np.ndarray, lens: np.ndarray, width: int, pad_id: int):
    """Rows laid end to end in ``flat`` (row r has ``lens[r]`` ids) ->
    right-padded (ids, mask) int32 of ``width`` columns, rows longer than
    ``width`` cut. One vectorized scatter: the boolean mask selects the
    live cells in row-major order, the order of ``flat``."""
    full = max(width, int(lens.max(initial=0)))
    live = np.arange(full)[None, :] < lens[:, None]
    ids = np.full((len(lens), full), pad_id, dtype=np.int32)
    ids[live] = flat
    if full > width:
        return np.ascontiguousarray(ids[:, :width]), live[:, :width].astype(np.int32)
    return ids, live.astype(np.int32)


def _pad_rows(seqs: list, width: int, pad_id: int = PAD_ID):
    """Lists of ids -> right-padded (ids, mask) int32 of ``width`` columns."""
    lens = np.fromiter(map(len, seqs), dtype=np.int64, count=len(seqs))
    flat = np.fromiter(itertools.chain.from_iterable(seqs), dtype=np.int32,
                       count=int(lens.sum()))
    return _scatter_rows(flat, lens, width, pad_id)


def _batch_width(seqs: list, pad_to: int | None) -> int:
    """``pad_to``, or the longest sequence of this batch; at least 2."""
    return max(pad_to or max((len(s) for s in seqs), default=2), 2)


class _EncodeMemo:
    """A ``(text, max_length)``-keyed LRU of token sequences, bounded at
    ``MEMO_MAX`` entries. A sequence is kept as the bytes of its int32 ids:
    bytes are not tracked by the garbage collector, and a batch's rows are
    joined and scattered into the padded matrix without a Python loop.
    Lookups and fills take a lock: the ingest pipeline's tokenize worker
    and the caller's thread may share a tokenizer."""

    def __init__(self):
        self.entries: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.entries)

    def batch(self, texts: list, ml: int, pad_to: int | None, pad_id: int,
              encode_batch):
        """Serve rows from the memo and encode only the miss subset through
        ``encode_batch`` (tokenization is per row, so a subset batch gives
        the rows the full batch would). The padding contract is the
        unmemoized one: width ``pad_to``, or the longest sequence in this
        batch, at least 2."""
        keys = [(t, ml) for t in texts]
        with self._lock:
            rows = list(map(self.entries.get, keys))
            miss = [i for i, r in enumerate(rows) if r is None]
            if len(miss) < len(keys):
                touch = self.entries.move_to_end
                for k, r in zip(keys, rows):
                    if r is not None:
                        touch(k)
        if miss:
            m_ids, m_mask = encode_batch([texts[i] for i in miss])
            buf, w = np.ascontiguousarray(m_ids, dtype=np.int32).tobytes(), 4 * m_ids.shape[1]
            new = [buf[j * w : j * w + 4 * n]
                   for j, n in enumerate(m_mask.sum(axis=1).tolist())]
            for i, r in zip(miss, new):
                rows[i] = r
            with self._lock:
                self.entries.update(zip([keys[i] for i in miss], new))
                while len(self.entries) > MEMO_MAX:
                    self.entries.popitem(last=False)
        lens = np.fromiter(map(len, rows), dtype=np.int64, count=len(rows)) // 4
        width = max(pad_to or int(lens.max(initial=2)), 2)
        return _scatter_rows(np.frombuffer(b"".join(rows), dtype=np.int32), lens,
                             width, pad_id)


def _finish_native_batch(ids, lens, fallback, retokenize, pad_id, pad_to):
    """Shared tail of a native batch: patch in the rows re-tokenized in
    Python (widening if needed), apply ``pad_to``, and build the attention
    mask from per-row ``lens`` when given, else from ``ids != pad_id``
    (valid where no real id equals the pad id)."""
    if fallback:
        if lens is not None:
            lens = lens.copy()
        seqs = {i: retokenize(i) for i in fallback}
        need = max(len(s) for s in seqs.values())
        if need > ids.shape[1]:
            ids = np.pad(ids, ((0, 0), (0, need - ids.shape[1])),
                         constant_values=pad_id)
        for i, s in seqs.items():
            ids[i, : len(s)] = s
            if lens is not None:
                lens[i] = len(s)
    if pad_to is not None:
        if ids.shape[1] < pad_to:
            ids = np.pad(ids, ((0, 0), (0, pad_to - ids.shape[1])),
                         constant_values=pad_id)
        elif ids.shape[1] > pad_to:
            ids = ids[:, :pad_to]
    if lens is None:
        mask = (ids != pad_id).astype(np.int32)
    else:
        mask = (np.arange(ids.shape[1])[None, :] < lens[:, None]).astype(np.int32)
    return ids, mask


class HashTokenizer:
    """Deterministic hashing tokenizer with a BERT-compatible id layout."""

    def __init__(self, vocab_size: int = 30522, max_length: int = 256,
                 native: bool = True, memo: bool = True):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.native = bool(native)
        # ids < reserved are for specials: BERT-style 999 for full vocabs,
        # compact layout for small (test) vocabs
        self._reserved = 999 if vocab_size >= 2000 else SEP_ID + 1
        self._span = max(1, vocab_size - self._reserved)
        self._memo = _EncodeMemo() if memo else None

    def _word_id(self, w: str) -> int:
        return self._reserved + (_fnv1a(w) % self._span)

    def tokenize_ids(self, text: str, max_length: int | None = None) -> list[int]:
        ml = max_length or self.max_length
        ids = [CLS_ID]
        for w in _WORD_RE.findall(text.lower()):
            if len(ids) >= ml - 1:
                break
            ids.append(self._word_id(w))
        ids.append(SEP_ID)
        return ids

    def __call__(
        self,
        texts: Sequence[str],
        max_length: int | None = None,
        pad_to: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batch-encode. Returns (input_ids, attention_mask) int32/int32,
        padded to ``pad_to`` (or the longest sequence, at least 2)."""
        texts = list(texts)
        ml = max_length or self.max_length
        if self._memo is not None:
            return self._memo.batch(texts, ml, pad_to, PAD_ID,
                                    lambda sub: self._encode_batch(sub, ml, None))
        return self._encode_batch(texts, ml, pad_to)

    def _encode_batch(self, texts: list, ml: int, pad_to: int | None):
        if self.native:
            ids, fallback = native_mod.hash_tokenize(texts, ml, self._reserved,
                                                     self._span)
            # every real id is > 0, so the mask is ids != PAD_ID
            return _finish_native_batch(
                ids, None, fallback, lambda i: self.tokenize_ids(texts[i], ml),
                PAD_ID, pad_to)
        seqs = [self.tokenize_ids(t, ml) for t in texts]
        return _pad_rows(seqs, _batch_width(seqs, pad_to))

    def pair(self, a: str, b: str, max_length: int | None = None) -> list[int]:
        """[CLS] a [SEP] b [SEP] — cross-encoder input layout."""
        ml = max_length or self.max_length
        half = (ml - 3) // 2
        ids = [CLS_ID]
        for w in _WORD_RE.findall(a.lower())[:half]:
            ids.append(self._word_id(w))
        ids.append(SEP_ID)
        for w in _WORD_RE.findall(b.lower())[: ml - 1 - len(ids)]:
            ids.append(self._word_id(w))
        ids.append(SEP_ID)
        return ids

    def encode_pairs(
        self,
        pairs: Sequence[tuple[str, str]],
        max_length: int | None = None,
        pad_to: int | None = None,
        return_types: bool = False,
    ):
        seqs = [self.pair(a, b, max_length) for a, b in pairs]
        width = pad_to or max((len(s) for s in seqs), default=2)
        ids, mask = _pad_rows(seqs, width)
        if not return_types:
            return ids, mask
        # segment ids: 0 through the first [SEP] inclusive, 1 after (BERT
        # pair layout)
        types = np.zeros_like(ids)
        for r, s in enumerate(seqs):
            if SEP_ID in s:
                first_sep = s.index(SEP_ID)
                types[r, first_sep + 1 : len(s)] = 1
        return ids, mask, types


class WordPieceTokenizer:
    """BERT-style WordPiece tokenizer from a plain vocab: basic
    tokenization (lowercase, accent stripping, punctuation split, control
    characters removed) and greedy longest-match pieces, the ids
    ``transformers.BertTokenizer`` gives over the same vocab.

    Vocab: a list of token strings (index = id), a {token: id} dict, or
    :meth:`from_vocab_file` for a one-token-per-line ``vocab.txt``. The
    C++ batch path lowercases, so a cased vocab (``lowercase=False``)
    needs ``native=False``.
    """

    def __init__(self, vocab, max_length: int = 256, lowercase: bool = True,
                 native: bool = True, memo: bool = True):
        if isinstance(vocab, dict):
            self.vocab = dict(vocab)
            tokens = [None] * (max(vocab.values()) + 1 if vocab else 0)
            for t, i in vocab.items():
                tokens[i] = t
            self._tokens = ["" if t is None else t for t in tokens]
        else:
            self._tokens = list(vocab)
            self.vocab = {t: i for i, t in enumerate(self._tokens)}
        if native and not lowercase:
            raise ValueError("the native WordPiece path lowercases every row: a "
                             "cased vocab needs native=False")
        self.max_length = max_length
        self.lowercase = lowercase
        self.native = bool(native)
        self.vocab_size = len(self._tokens)
        self.cls_id = self.vocab.get("[CLS]", CLS_ID)
        self.sep_id = self.vocab.get("[SEP]", SEP_ID)
        self.unk_id = self.vocab.get("[UNK]", UNK_ID)
        self.pad_id = self.vocab.get("[PAD]", PAD_ID)
        self._memo = _EncodeMemo() if memo else None
        self._native_handle = None
        self._handle_lock = threading.Lock()
        if self.pad_id in (self.cls_id, self.sep_id):
            raise ValueError("[PAD] id must differ from [CLS]/[SEP]")

    def __del__(self):
        if getattr(self, "_native_handle", None) is not None:
            try:
                native_mod.wordpiece_free(self._native_handle)
            except Exception:  # noqa: BLE001 - interpreter shutdown
                pass

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        with open(path, encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f]
        while tokens and tokens[-1] == "":
            tokens.pop()
        return cls(tokens, **kw)

    # -- Python path (full Unicode) ----------------------------------------
    @staticmethod
    def _is_punct(ch: str) -> bool:
        cp = ord(ch)
        if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (
            123 <= cp <= 126
        ):
            return True
        return unicodedata.category(ch).startswith("P")

    def _basic_tokens(self, text: str) -> list[str]:
        if self.lowercase:
            text = unicodedata.normalize("NFD", text.lower())
            text = "".join(ch for ch in text if unicodedata.category(ch) != "Mn")
        out: list[str] = []
        word: list[str] = []
        for ch in text:
            cp = ord(ch)
            if ch in (" ", "\t", "\n", "\r") or unicodedata.category(ch) == "Zs":
                if word:
                    out.append("".join(word))
                    word = []
            elif (cp < 0x20 and ch not in "\t\n\r") or cp == 0x7F:
                continue  # control chars are removed
            elif self._is_punct(ch):
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out

    def _word_pieces(self, word: str) -> list[int]:
        if len(word) > 200:  # BERT max_input_chars_per_word
            return [self.unk_id]
        pieces: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece_id = None
            while end > start:
                piece_id = self.vocab.get(("##" if start else "") + word[start:end])
                if piece_id is not None:
                    break
                end -= 1
            if piece_id is None:
                return [self.unk_id]
            pieces.append(piece_id)
            start = end
        return pieces

    def tokenize_ids(self, text: str, max_length: int | None = None) -> list[int]:
        ml = max_length or self.max_length
        pieces: list[int] = []
        for tok in self._basic_tokens(text):
            pieces.extend(self._word_pieces(tok))
        return [self.cls_id] + pieces[: max(ml - 2, 0)] + [self.sep_id]

    # -- batch encode (HashTokenizer's contract) ---------------------------
    def __call__(
        self,
        texts: Sequence[str],
        max_length: int | None = None,
        pad_to: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        ml = max_length or self.max_length
        texts = list(texts)
        if self._memo is not None:
            return self._memo.batch(texts, ml, pad_to, self.pad_id,
                                    lambda sub: self._encode_batch(sub, ml, None))
        return self._encode_batch(texts, ml, pad_to)

    def _handle(self) -> int:
        with self._handle_lock:
            if self._native_handle is None:
                self._native_handle = native_mod.wordpiece_load(self._tokens)
            return self._native_handle

    def _encode_batch(self, texts: list, ml: int, pad_to: int | None):
        if self.native:
            ids, lens, fallback = native_mod.wordpiece_tokenize(
                self._handle(), texts, ml, self.cls_id, self.sep_id,
                self.unk_id, self.pad_id)
            return _finish_native_batch(
                ids, lens, fallback, lambda i: self.tokenize_ids(texts[i], ml),
                self.pad_id, pad_to)
        seqs = [self.tokenize_ids(t, ml) for t in texts]
        return _pad_rows(seqs, _batch_width(seqs, pad_to), self.pad_id)


def pad_to_buckets(ids: np.ndarray, mask: np.ndarray,
                   types: np.ndarray | None = None,
                   row_lo: int = 8, seq_lo: int = 16):
    """Pad a tokenized batch up to pow2 (rows, seq) buckets.

    Padded rows and columns carry mask 0 (and type 0). Returns
    ``(ids, mask)`` or ``(ids, mask, types)`` matching the inputs."""
    rows = next_pow2(ids.shape[0], row_lo)
    seq = next_pow2(ids.shape[1], seq_lo)
    grow = ((0, rows - ids.shape[0]), (0, seq - ids.shape[1]))
    ids = np.pad(ids, grow)
    mask = np.pad(mask, grow)
    if types is None:
        return ids, mask
    return ids, mask, np.pad(types, grow)


class _HFTokenizerAdapter:
    """A ``transformers`` tokenizer behind the HashTokenizer interface."""

    def __init__(self, tok, max_length: int = 256):
        self._tok = tok
        self.max_length = max_length
        self.vocab_size = tok.vocab_size

    def __call__(self, texts, max_length=None, pad_to=None):
        enc = self._tok(
            list(texts),
            truncation=True,
            max_length=max_length or self.max_length,
            padding="max_length" if pad_to else "longest",
        )
        ids = np.asarray(enc["input_ids"], dtype=np.int32)
        mask = np.asarray(enc["attention_mask"], dtype=np.int32)
        if pad_to and ids.shape[1] < pad_to:
            ids = np.pad(ids, ((0, 0), (0, pad_to - ids.shape[1])))
            mask = np.pad(mask, ((0, 0), (0, pad_to - mask.shape[1])))
        return ids, mask

    def encode_pairs(self, pairs, max_length=None, pad_to=None,
                     return_types=False):
        enc = self._tok(
            [p[0] for p in pairs], [p[1] for p in pairs],
            truncation=True,
            max_length=max_length or self.max_length,
            padding="max_length" if pad_to else "longest",
        )
        ids = np.asarray(enc["input_ids"], dtype=np.int32)
        mask = np.asarray(enc["attention_mask"], dtype=np.int32)
        if not return_types:
            return ids, mask
        if "token_type_ids" in enc:
            types = np.asarray(enc["token_type_ids"], dtype=np.int32)
        else:
            types = np.zeros_like(ids)
        return ids, mask, types


def load_tokenizer(path_or_name: str | None = None, max_length: int = 256):
    """A local HF tokenizer when a path is given (through ``transformers``,
    imported here; raises where it is missing), a ``HashTokenizer``
    otherwise. A path that fails to load raises: hash ids against weights
    trained for the HF vocab would corrupt embeddings silently."""
    if path_or_name:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(path_or_name, local_files_only=True)
        return _HFTokenizerAdapter(tok, max_length)
    return HashTokenizer(max_length=max_length)
