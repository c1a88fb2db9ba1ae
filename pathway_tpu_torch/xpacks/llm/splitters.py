"""Text splitter UDFs (reference ``xpacks/llm/splitters.py``).

``TokenCountSplitter`` chunks by token count, counted with tiktoken's
``encoding_name`` when tiktoken is installed and its encoding can be
loaded (imported at the first count, as in JAX), else by whitespace words.
tiktoken fetches an encoding's file over the network on its first use,
so an air-gapped host without a cached copy counts words.
"""

from __future__ import annotations

import re
import unicodedata

import pathway_tpu_torch as pw


@pw.udf
def null_splitter(txt: str) -> list[tuple[str, dict]]:
    """No-op splitter: one chunk per document (reference ``null_splitter``,
    splitters.py:13)."""
    return [(txt, {})]


def _normalize_unicode(text: str) -> str:
    return unicodedata.normalize("NFKC", text)


_SENTENCE_BREAK = re.compile(r"(?<=[.!?])\s+|\n{2,}")


class TokenCountSplitter(pw.UDF):
    """Split text into chunks of ``min_tokens``..``max_tokens`` tokens,
    preferring sentence boundaries (reference ``TokenCountSplitter``,
    splitters.py:34-120, which counts tokens with tiktoken)."""

    def __init__(
        self,
        min_tokens: int = 50,
        max_tokens: int = 500,
        encoding_name: str = "cl100k_base",
    ):
        super().__init__(deterministic=True)
        self.min_tokens = min_tokens
        self.max_tokens = max_tokens
        self.encoding_name = encoding_name
        self._encoder = None

    def _count_tokens(self, text: str) -> int:
        enc = self._get_encoder()
        if enc is not None:
            return len(enc.encode(text))
        # whitespace-word count approximates wordpiece count closely enough
        # for chunk sizing
        return max(1, len(text.split()))

    def _get_encoder(self):
        if self._encoder is None:
            try:
                import tiktoken

                self._encoder = tiktoken.get_encoding(self.encoding_name)
            except Exception:  # noqa: BLE001 - gated dependency
                self._encoder = False
        return self._encoder or None

    def __wrapped__(self, txt: str, **kwargs) -> list[tuple[str, dict]]:
        text = _normalize_unicode(txt or "")
        if not text.strip():
            return []
        sentences = [s for s in _SENTENCE_BREAK.split(text) if s.strip()]
        chunks: list[tuple[str, dict]] = []
        current: list[str] = []
        current_tokens = 0
        for sentence in sentences:
            stoks = self._count_tokens(sentence)
            if stoks > self.max_tokens:
                # hard-split an oversized sentence by words
                words = sentence.split()
                step = max(1, self.max_tokens)
                for i in range(0, len(words), step):
                    part = " ".join(words[i : i + step])
                    if current:
                        chunks.append((" ".join(current), {}))
                        current, current_tokens = [], 0
                    chunks.append((part, {}))
                continue
            if current_tokens + stoks > self.max_tokens and current_tokens >= self.min_tokens:
                chunks.append((" ".join(current), {}))
                current, current_tokens = [], 0
            current.append(sentence)
            current_tokens += stoks
        if current:
            chunks.append((" ".join(current), {}))
        return chunks


class RecursiveSplitter(pw.UDF):
    """Recursively split on separators until chunks fit ``chunk_size``
    (langchain-style; reference exposes this via langchain adapters)."""

    def __init__(
        self,
        chunk_size: int = 500,
        chunk_overlap: int = 0,
        separators: list[str] | None = None,
    ):
        super().__init__(deterministic=True)
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.separators = separators or ["\n\n", "\n", ". ", " "]

    def _split(self, text: str, seps: list[str]) -> list[str]:
        if len(text.split()) <= self.chunk_size or not seps:
            return [text] if text.strip() else []
        sep, rest = seps[0], seps[1:]
        parts = text.split(sep)
        out: list[str] = []
        buf = ""
        for p in parts:
            candidate = (buf + sep + p) if buf else p
            if len(candidate.split()) > self.chunk_size:
                if buf:
                    out.extend(self._split(buf, rest) if len(buf.split()) > self.chunk_size else [buf])
                buf = p
            else:
                buf = candidate
        if buf:
            out.extend(self._split(buf, rest) if len(buf.split()) > self.chunk_size else [buf])
        return out

    def __wrapped__(self, txt: str, **kwargs) -> list[tuple[str, dict]]:
        chunks = self._split(_normalize_unicode(txt or ""), self.separators)
        if self.chunk_overlap > 0 and len(chunks) > 1:
            # prepend the tail of the previous chunk to each following chunk
            overlapped = [chunks[0]]
            for prev, cur in zip(chunks, chunks[1:]):
                tail = " ".join(prev.split()[-self.chunk_overlap:])
                overlapped.append(f"{tail} {cur}" if tail else cur)
            chunks = overlapped
        return [(c, {}) for c in chunks]


@pw.udf
def chunk_texts(text: str, max_words: int = 200) -> list[str]:
    """Simple word-window chunker used by demos."""
    words = (text or "").split()
    return [
        " ".join(words[i : i + max_words]) for i in range(0, len(words), max_words)
    ] or [""]
