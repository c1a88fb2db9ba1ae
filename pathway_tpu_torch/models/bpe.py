"""GPT-2 byte-level BPE tokenizer, pure Python (the port's own copy of
``pathway_tpu/models/bpe.py``; same ids for the same vocab and merges).

Loads the standard local checkpoint artifacts (``vocab.json`` +
``merges.txt``). A tokenizer built from the 256 byte symbols and no merges
is the byte-level tokenizer the decoder runs with random weights.

Implements the three GPT-2 specifics exactly:

* byte→unicode remap (every byte gets a printable codepoint so BPE operates
  on visible characters and round-trips arbitrary bytes),
* the pre-tokenization split (contractions / letter runs / digit runs /
  other runs, each with an optional leading space; whitespace runs keep
  their final space attached to the next token),
* lowest-rank-first pair merging over each pre-token.
"""

from __future__ import annotations

import json
import os
import unicodedata
from collections import OrderedDict
from functools import lru_cache

# whole-text encode memo bound (the JAX package's default tokenize cache)
_MEMO_MAX = 65536


@lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """The GPT-2 printable-byte table: printable ASCII + latin-1 blocks map
    to themselves, everything else to 256+offset."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_digit(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def pretokenize(text: str) -> list[str]:
    """GPT-2's split regex, hand-rolled (``re`` lacks ``\\p{L}``):
    ``'s|'t|'re|'ve|'m|'ll|'d| ?L+| ?N+| ?[^\\sLN]+|\\s+(?!\\S)|\\s+``.
    A whitespace run followed by a non-space keeps its LAST space attached
    to the next token; the rest of the run is its own token."""
    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        for c in _CONTRACTIONS:
            if text.startswith(c, i):
                out.append(c)
                i += len(c)
                break
        else:
            if ch.isspace():
                j = i
                while j < n and text[j].isspace():
                    j += 1
                if j < n and j - i >= 1 and not text[j].isspace():
                    # last space of the run prefixes the next token
                    if j - i > 1:
                        out.append(text[i : j - 1])
                    i = j - 1
                    ch = text[i]
                    j = i + 1
                    if ch == " ":
                        # " word" / " 12" / " +++" with the space attached
                        k = j
                        if k < n and _is_letter(text[k]):
                            while k < n and _is_letter(text[k]):
                                k += 1
                        elif k < n and _is_digit(text[k]):
                            while k < n and _is_digit(text[k]):
                                k += 1
                        else:
                            while (
                                k < n
                                and not text[k].isspace()
                                and not _is_letter(text[k])
                                and not _is_digit(text[k])
                            ):
                                k += 1
                        out.append(text[i:k])
                        i = k
                    else:  # non-space whitespace char directly before token
                        out.append(text[i:j])
                        i = j
                else:
                    out.append(text[i:j])
                    i = j
            elif _is_letter(ch):
                j = i
                while j < n and _is_letter(text[j]):
                    j += 1
                out.append(text[i:j])
                i = j
            elif _is_digit(ch):
                j = i
                while j < n and _is_digit(text[j]):
                    j += 1
                out.append(text[i:j])
                i = j
            else:
                j = i
                while (
                    j < n
                    and not text[j].isspace()
                    and not _is_letter(text[j])
                    and not _is_digit(text[j])
                ):
                    j += 1
                out.append(text[i:j])
                i = j
    return out


class BPETokenizer:
    """Encode/decode against a local ``vocab.json`` + ``merges.txt`` pair."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 eos_token: str = "<|endoftext|>"):
        self.vocab = dict(vocab)
        self.decoder = {v: k for k, v in self.vocab.items()}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_enc = bytes_to_unicode()
        self.byte_dec = {v: k for k, v in self.byte_enc.items()}
        self.eos_id = self.vocab.get(eos_token)
        self._cache: dict[str, list[str]] = {}
        # whole-text encode memo: the serving path re-encodes the shared
        # prompt head + template per request; the per-pretoken _cache saves
        # the merge loops but still walks pretokenize() over the full text
        self._encode_memo: OrderedDict[str, list[int]] = OrderedDict()
        self._warned_unknown = False

    @classmethod
    def from_dir(cls, path: str, **kw) -> "BPETokenizer":
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges: list[tuple[str, str]] = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _bpe(self, token: str) -> list[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        parts = list(token)
        while len(parts) > 1:
            best = None
            best_rank = None
            for pair in zip(parts, parts[1:]):
                r = self.ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = pair, r
            if best is None:
                break
            merged: list[str] = []
            i = 0
            while i < len(parts):
                if (
                    i + 1 < len(parts)
                    and (parts[i], parts[i + 1]) == best
                ):
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        if len(self._cache) < 65536:
            self._cache[token] = parts
        return parts

    def encode(self, text: str) -> list[int]:
        memo = self._encode_memo
        got = memo.get(text)
        if got is not None:
            memo.move_to_end(text)
            return list(got)
        ids: list[int] = []
        for pre in pretokenize(text):
            mapped = "".join(self.byte_enc[b] for b in pre.encode("utf-8"))
            for piece in self._bpe(mapped):
                pid = self.vocab.get(piece)
                if pid is None:
                    # unknown piece: fall back to per-character ids.  A full
                    # GPT-2 vocab has all 256 byte symbols, so misses only
                    # happen with truncated/non-standard vocabs — skip those
                    # characters (never inject an arbitrary id) and warn once
                    for c in piece:
                        cid = self.vocab.get(c)
                        if cid is not None:
                            ids.append(cid)
                        elif not self._warned_unknown:
                            self._warned_unknown = True
                            import warnings

                            warnings.warn(
                                "BPETokenizer: vocab lacks byte symbol "
                                f"{c!r}; dropping it (truncated vocab?)",
                                stacklevel=2,
                            )
                else:
                    ids.append(pid)
        memo[text] = list(ids)
        if len(memo) > _MEMO_MAX:
            memo.popitem(last=False)
        return ids

    def decode(self, ids) -> str:
        chars = "".join(self.decoder.get(int(i), "") for i in ids)
        data = bytes(self.byte_dec.get(c, 32) for c in chars)
        return data.decode("utf-8", errors="replace")
