"""DocumentStore — live parse→split→index pipeline over document sources
(reference ``xpacks/llm/document_store.py:32-529``).

The store consumes one or more connector tables of raw documents
(``data: bytes|str`` + optional ``_metadata: Json``), runs parser →
post-processors → splitter, and maintains a retriever index over the
chunks (the port's brute-force KNN with its corpus on the card; the BM25
and hybrid factories are not ported yet, ROADMAP A13). Query tables are answered live:
``retrieve_query`` / ``statistics_query`` / ``inputs_query`` mirror the
reference's REST surface.

The statistics and inputs answers are joins: the chunk count and the
modification times are one-row reductions crossed with each other (a
join on no key), and each query row joins them keeping its own key
(``id=pw.left.id``), so the REST connector finds its pending request.

Re-ingest cost: when a source file is edited and re-read, the pipeline
re-derives every chunk of that file, but most chunks are byte-identical to
their previous versions. The embedding stage
(``SentenceTransformerEmbedder``, ``dedup=True`` by default) keeps a
content-keyed LRU of recent chunk embeddings, so unchanged chunks reuse
their vector instead of re-dispatching to the card.
"""

from __future__ import annotations

from typing import Callable, Iterable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.json import Json, unwrap_json
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing import DataIndex
from pathway_tpu_torch.stdlib.indexing.retrievers import AbstractRetrieverFactory
from pathway_tpu_torch.xpacks.llm.parsers import ParseUtf8


class _DocSchema(schema_mod.Schema):
    pass


def _ensure_tables(docs: Table | Iterable[Table]) -> list[Table]:
    if isinstance(docs, Table):
        return [docs]
    return list(docs)


class DocumentStore:
    """Builds and serves a live document index (reference ``DocumentStore``,
    document_store.py:32)."""

    class RetrieveQuerySchema(schema_mod.Schema):
        query: str
        k: int
        metadata_filter: str | None
        filepath_globpattern: str | None

    class StatisticsQuerySchema(schema_mod.Schema):
        pass

    class InputsQuerySchema(schema_mod.Schema):
        metadata_filter: str | None
        filepath_globpattern: str | None

    class QueryResultSchema(schema_mod.Schema):
        result: dt.JSON

    def __init__(
        self,
        docs: Table | Iterable[Table],
        retriever_factory: AbstractRetrieverFactory,
        parser: pw.UDF | None = None,
        splitter: pw.UDF | None = None,
        doc_post_processors: list[Callable] | None = None,
    ):
        self.docs = _ensure_tables(docs)
        self.retriever_factory = retriever_factory
        self.parser = parser if parser is not None else ParseUtf8()
        self.splitter = splitter
        self.doc_post_processors = doc_post_processors or []
        self.build_pipeline()

    @classmethod
    def from_langchain_components(
        cls, docs, retriever_factory, parser=None, splitter=None, **kwargs
    ):
        """Use a langchain text splitter (reference
        ``from_langchain_components``, document_store.py:87)."""
        split_fn = None
        if splitter is not None:
            @pw.udf
            def split_fn(text: str) -> list[tuple[str, dict]]:
                return [(chunk, {}) for chunk in splitter.split_text(text)]

        return cls(docs, retriever_factory, parser=parser, splitter=split_fn, **kwargs)

    @classmethod
    def from_llamaindex_components(
        cls, docs, retriever_factory, parser=None, transformations=None, **kwargs
    ):
        """Use llama-index node transformations (reference
        ``from_llamaindex_components``, document_store.py:128)."""
        split_fn = None
        if transformations:
            try:
                from llama_index.core.ingestion.pipeline import run_transformations
                from llama_index.core.schema import BaseNode, MetadataMode, TextNode
            except ImportError as exc:  # pragma: no cover - gated dependency
                raise ImportError(
                    "from_llamaindex_components requires `llama-index-core`"
                ) from exc

            @pw.udf
            def split_fn(text: str) -> list[tuple[str, dict]]:
                starting_node: list[BaseNode] = [TextNode(text=text)]
                final_nodes = run_transformations(starting_node, transformations)
                return [
                    (node.get_content(metadata_mode=MetadataMode.NONE), node.extra_info)
                    for node in final_nodes
                ]

        return cls(docs, retriever_factory, parser=parser, splitter=split_fn, **kwargs)

    # -- pipeline ----------------------------------------------------------

    def parse_documents(self, input_docs: Table) -> Table:
        parser = self.parser

        @pw.udf
        def parse_with_meta(data, metadata) -> list:
            chunks = parser.__wrapped__(data)
            base = unwrap_json(metadata) if metadata is not None else {}
            out = []
            for text, meta in chunks:
                merged = dict(base or {})
                merged.update(meta or {})
                out.append(Json({"text": text, "metadata": merged}))
            return out

        has_meta = "_metadata" in input_docs.column_names()
        meta_col = input_docs._metadata if has_meta else None
        parsed = input_docs.select(
            parts=parse_with_meta(
                input_docs.data,
                meta_col if meta_col is not None else None,
            )
        )
        flat = parsed.flatten(parsed.parts)
        return flat.select(
            text=pw.apply_with_type(lambda p: str(unwrap_json(p).get("text", "")), str, flat.parts),
            metadata=pw.apply_with_type(
                lambda p: Json(unwrap_json(p).get("metadata", {})), dt.JSON, flat.parts
            ),
        )

    def post_process_docs(self, parsed_docs: Table) -> Table:
        processors = self.doc_post_processors
        if not processors:
            return parsed_docs

        @pw.udf
        def post_proc(text: str) -> str:
            for proc in processors:
                text = proc(text)
            return text

        return parsed_docs.with_columns(text=post_proc(parsed_docs.text))

    def split_docs(self, post_processed_docs: Table) -> Table:
        if self.splitter is None:
            return post_processed_docs
        splitter = self.splitter

        @pw.udf
        def split_with_meta(text: str, metadata) -> list:
            chunks = splitter.__wrapped__(text)
            base = unwrap_json(metadata) if metadata is not None else {}
            out = []
            for chunk in chunks:
                if isinstance(chunk, tuple):
                    ctext, cmeta = chunk
                else:
                    ctext, cmeta = chunk, {}
                merged = dict(base or {})
                merged.update(cmeta or {})
                out.append(Json({"text": str(ctext), "metadata": merged}))
            return out

        split = post_processed_docs.select(
            parts=split_with_meta(post_processed_docs.text, post_processed_docs.metadata)
        )
        flat = split.flatten(split.parts)
        return flat.select(
            text=pw.apply_with_type(lambda p: str(unwrap_json(p).get("text", "")), str, flat.parts),
            metadata=pw.apply_with_type(
                lambda p: Json(unwrap_json(p).get("metadata", {})), dt.JSON, flat.parts
            ),
        )

    def build_pipeline(self) -> None:
        docs = self.docs[0] if len(self.docs) == 1 else self.docs[0].concat_reindex(*self.docs[1:])
        self.input_docs = docs
        self.parsed_docs = self.parse_documents(docs)
        processed = self.post_process_docs(self.parsed_docs)
        self.chunked_docs = self.split_docs(processed)
        self._index: DataIndex = self.retriever_factory.build_index(
            self.chunked_docs.text,
            self.chunked_docs,
            metadata_column=self.chunked_docs.metadata,
        )

    @property
    def index(self) -> DataIndex:
        return self._index

    # -- query surfaces ----------------------------------------------------

    @staticmethod
    def merge_filters(queries: Table) -> Table:
        """Combine ``metadata_filter`` and ``filepath_globpattern`` into one
        filter expression (reference ``merge_filters``,
        document_store.py:356)."""

        @pw.udf
        def _merge(metadata_filter, globpattern) -> str | None:
            parts = []
            if metadata_filter:
                parts.append(str(metadata_filter))
            if globpattern:
                parts.append(f"glob(path, '{globpattern}')")
            return " && ".join(parts) if parts else None

        return queries.with_columns(
            metadata_filter=_merge(queries.metadata_filter, queries.filepath_globpattern)
        ).without("filepath_globpattern")

    def retrieve_query(self, retrieval_queries: Table) -> Table:
        """Answer retrieval queries live (reference ``retrieve_query``,
        document_store.py:426)."""
        queries = self.merge_filters(retrieval_queries)
        matches = self._index.query_as_of_now(
            queries.query,
            number_of_matches=queries.k,
            collapse_rows=True,
            with_distances=True,
            metadata_filter=queries.metadata_filter,
        )

        @pw.udf
        def format_docs(texts, metadatas, dists) -> Json:
            docs = []
            for text, meta, dist in zip(texts, metadatas, dists):
                docs.append(
                    {
                        "text": text,
                        "metadata": unwrap_json(meta) if meta is not None else {},
                        "dist": float(dist),
                    }
                )
            return Json(docs)

        return matches.select(
            result=format_docs(matches.text, matches.metadata, matches._pw_dist)
        )

    def statistics_query(self, info_queries: Table) -> Table:
        """Index health statistics (reference ``statistics_query``,
        document_store.py:323)."""
        chunked = self.chunked_docs

        counts = chunked.reduce(count=pw.reducers.count())

        @pw.udf
        def _mtime(meta) -> float:
            m = unwrap_json(meta) or {}
            return float(m.get("modified_at", 0) or 0)

        times = chunked.select(m=_mtime(chunked.metadata)).reduce(
            last_modified=pw.reducers.max(pw.this.m),
            last_indexed=pw.reducers.max(pw.this.m),
        )

        @pw.udf
        def format_stats(count, last_modified, last_indexed) -> Json:
            # late-interaction bank health rides the same statistics
            # surface: current device bytes of the `late_bank` HBM
            # component (0 when no late-interaction bank was built).
            # Retraction/compaction lower it live, mirroring the IVF row
            # lifecycle the file_count tracks.
            from pathway_tpu_torch.engine.probes import hbm_stats

            late = hbm_stats()["current_bytes"].get("late_bank", 0)
            return Json(
                {
                    "file_count": int(count or 0),
                    "last_modified": last_modified,
                    "last_indexed": last_indexed,
                    "late_bank_bytes": int(late),
                }
            )

        combined = counts.join(times).select(
            counts.count, times.last_modified, times.last_indexed
        )
        # keep the query-side keys (id=pw.left.id) so REST responses
        # correlate back to their pending requests
        stats = info_queries.join(combined, how="left", id=pw.left.id).select(
            result=format_stats(pw.this.count, pw.this.last_modified, pw.this.last_indexed)
        )
        return stats

    def inputs_query(self, input_queries: Table) -> Table:
        """List indexed source documents (reference ``inputs_query``,
        document_store.py:385)."""
        parsed = self.parsed_docs
        queries = self.merge_filters(input_queries)

        @pw.udf
        def _meta(meta) -> Json:
            return Json(unwrap_json(meta) or {})

        metas = parsed.select(m=_meta(parsed.metadata)).reduce(
            metadatas=pw.reducers.tuple(pw.this.m)
        )

        @pw.udf
        def format_inputs(metadatas, metadata_filter) -> Json:
            from pathway_tpu_torch.engine.operators.external_index import _apply_filter

            seen: dict[str, dict] = {}
            for meta in metadatas or ():
                m = unwrap_json(meta) or {}
                if metadata_filter and not _apply_filter(metadata_filter, m):
                    continue
                path = str(m.get("path", ""))
                seen[path] = m
            return Json(list(seen.values()))

        return queries.join(metas, how="left", id=pw.left.id).select(
            result=format_inputs(pw.this.metadatas, pw.this.metadata_filter)
        )


class SlidesDocumentStore(DocumentStore):
    """DocumentStore variant exposing parsed slide pages (reference
    ``SlidesDocumentStore``, document_store.py:471)."""

    def parsed_documents_query(self, parse_docs_queries: Table) -> Table:
        parsed = self.parsed_docs
        collected = parsed.reduce(
            docs=pw.reducers.tuple(
                pw.apply_with_type(
                    lambda t, m: Json({"text": t, "metadata": unwrap_json(m) or {}}),
                    dt.JSON,
                    parsed.text,
                    parsed.metadata,
                )
            )
        )

        @pw.udf
        def format_inputs(docs) -> Json:
            return Json([unwrap_json(d) for d in (docs or ())])

        return parse_docs_queries.join(collected, how="left", id=pw.left.id).select(
            result=format_inputs(pw.this.docs)
        )
