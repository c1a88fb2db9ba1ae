"""VectorStoreServer — embed→index→retrieve REST service (reference
``xpacks/llm/vector_store.py:39-769``).

The classic Pathway vector-store surface: document connector tables go
through parse → post-process → split → embed on the card (the embedder
UDF, a batched encoder call per microbatch) → brute-force KNN with its
corpus on the card; a REST endpoint (``io/http.py``'s standard-library
server) answers ``/v1/retrieve | /v1/statistics | /v1/inputs`` live.
``VectorStoreClient`` is the matching HTTP client.

Without an ``index_factory`` the index is a ``BruteForceKnnFactory`` on
the embedder's device (the card unless the embedder was built with
``device="cpu"``).
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory, DataIndex
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore

logger = logging.getLogger(__name__)


class VectorStoreServer:
    """Live vector store with REST endpoints (reference
    ``VectorStoreServer``, vector_store.py:39)."""

    def __init__(
        self,
        *docs: Table,
        embedder: Callable[[str], Any],
        parser: Callable[[bytes], list[tuple[str, dict]]] | None = None,
        splitter: Callable[[str], list[tuple[str, dict]]] | None = None,
        doc_post_processors: list[Callable[[str], str]] | None = None,
        index_factory: Any = None,
    ):
        self.embedder = embedder
        if index_factory is None:
            dim = (
                embedder.get_embedding_dimension()
                if hasattr(embedder, "get_embedding_dimension")
                else None
            )
            index_factory = BruteForceKnnFactory(
                dimensions=dim, embedder=embedder,
                device=getattr(embedder, "device", None))
        elif getattr(index_factory, "embedder", None) is None and hasattr(
            index_factory, "embedder"
        ):
            index_factory.embedder = embedder
        self.index_factory = index_factory
        self.document_store = DocumentStore(
            list(docs),
            retriever_factory=index_factory,
            parser=parser,
            splitter=splitter,
            doc_post_processors=doc_post_processors,
        )
        self._server_thread: threading.Thread | None = None

    @classmethod
    def from_langchain_components(
        cls, *docs, embedder, parser=None, splitter=None, **kwargs
    ):
        """Build from langchain embeddings + text splitter (reference
        ``from_langchain_components``, vector_store.py:93)."""
        try:
            from langchain_core.embeddings import Embeddings  # noqa: F401
        except ImportError as exc:  # pragma: no cover - gated dependency
            raise ImportError("requires langchain-core") from exc

        @pw.udf
        async def langchain_embedder(x: str):
            import numpy as np

            res = await embedder.aembed_documents([x or "."])
            return np.array(res[0])

        split_fn = None
        if splitter is not None:
            @pw.udf
            def split_fn(text: str) -> list[tuple[str, dict]]:
                return [(chunk, {}) for chunk in splitter.split_text(text)]

        return cls(*docs, embedder=langchain_embedder, parser=parser, splitter=split_fn, **kwargs)

    @classmethod
    def from_llamaindex_components(cls, *docs, transformations, parser=None, **kwargs):
        """Build from llama-index transformations, the last being an embedder
        (reference ``from_llamaindex_components``, vector_store.py:137)."""
        try:
            from llama_index.core.base.embeddings.base import BaseEmbedding
        except ImportError as exc:  # pragma: no cover - gated dependency
            raise ImportError("requires llama-index-core") from exc
        embedders = [t for t in transformations if isinstance(t, BaseEmbedding)]
        if len(embedders) != 1:
            raise ValueError("expected exactly one embedder in transformations")
        li_embedder = embedders[0]
        transformations = [t for t in transformations if not isinstance(t, BaseEmbedding)]

        @pw.udf
        async def embedder(x: str):
            import numpy as np

            return np.array(await li_embedder.aget_text_embedding(x or "."))

        splitter = None
        if transformations:
            from llama_index.core.ingestion.pipeline import run_transformations
            from llama_index.core.schema import BaseNode, MetadataMode, TextNode

            @pw.udf
            def splitter(text: str) -> list[tuple[str, dict]]:
                nodes: list[BaseNode] = [TextNode(text=text)]
                final = run_transformations(nodes, transformations)
                return [
                    (n.get_content(metadata_mode=MetadataMode.NONE), n.extra_info)
                    for n in final
                ]

        return cls(*docs, embedder=embedder, parser=parser, splitter=splitter, **kwargs)

    # -- query handlers (delegate to the document store) -------------------

    class RetrieveQuerySchema(schema_mod.Schema):
        query: str
        k: int
        metadata_filter: str | None
        filepath_globpattern: str | None

    StatisticsQuerySchema = DocumentStore.StatisticsQuerySchema
    InputsQuerySchema = DocumentStore.InputsQuerySchema

    def retrieve_query(self, retrieval_queries: Table) -> Table:
        return self.document_store.retrieve_query(retrieval_queries)

    def statistics_query(self, info_queries: Table) -> Table:
        return self.document_store.statistics_query(info_queries)

    def inputs_query(self, input_queries: Table) -> Table:
        return self.document_store.inputs_query(input_queries)

    @property
    def index(self) -> DataIndex:
        return self.document_store.index

    def late_bank_bytes(self) -> int:
        """Current device bytes of the late-interaction doc-token bank
        (the ``late_bank`` HBM-ledger component) behind this store — the
        number ``/v1/statistics`` reports as ``late_bank_bytes``. Falls on
        document retraction, mirroring the IVF row lifecycle."""
        from pathway_tpu_torch.engine.probes import hbm_stats

        return int(hbm_stats()["current_bytes"].get("late_bank", 0))

    def run_server(
        self,
        host: str = "0.0.0.0",  # noqa: S104
        port: int = 8000,
        threaded: bool = False,
        with_cache: bool = True,
        cache_backend=None,
        terminate_on_error: bool = True,
    ):
        """Serve ``/v1/retrieve``, ``/v1/statistics``, ``/v1/inputs``
        (reference ``run_server``, vector_store.py:478)."""
        from pathway_tpu_torch.io.http import PathwayWebserver, rest_connector

        webserver = PathwayWebserver(host, port)

        routes = [
            ("/v1/retrieve", self.RetrieveQuerySchema, self.retrieve_query, ("GET", "POST")),
            ("/v1/statistics", self.StatisticsQuerySchema, self.statistics_query, ("GET", "POST")),
            ("/v1/inputs", self.InputsQuerySchema, self.inputs_query, ("GET", "POST")),
        ]
        for route, schema, handler, methods in routes:
            queries, writer = rest_connector(
                webserver=webserver,
                route=route,
                schema=schema,
                methods=methods,
                delete_completed_queries=True,
            )
            writer(handler(queries))

        def run():
            pw.run(monitoring_level=pw.MonitoringLevel.NONE)

        if threaded:
            t = threading.Thread(target=run, daemon=True, name="VectorStoreServer")
            t.start()
            self._server_thread = t
            return t
        run()

    def __repr__(self):
        return f"VectorStoreServer({self.index_factory!r})"


class SlidesVectorStoreServer(VectorStoreServer):
    """Parity stub for the slides-oriented store (reference
    ``SlidesVectorStoreServer``, vector_store.py:588)."""


class VectorStoreClient:
    """HTTP client for a VectorStoreServer (reference ``VectorStoreClient``,
    vector_store.py:651)."""

    def __init__(
        self,
        host: str | None = None,
        port: int | None = None,
        url: str | None = None,
        timeout: int = 15,
        additional_headers: dict | None = None,
    ):
        if url is None:
            if host is None:
                raise ValueError("either url or host must be given")
            url = f"http://{host}:{port or 80}"
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.additional_headers = additional_headers or {}

    def _post(self, route: str, payload: dict) -> Any:
        from pathway_tpu_torch.xpacks.llm._utils import post_json

        return post_json(
            self.url + route, payload, self.additional_headers, self.timeout
        )

    def query(
        self, query: str, k: int = 3, metadata_filter: str | None = None,
        filepath_globpattern: str | None = None,
    ) -> list[dict]:
        data = self._post(
            "/v1/retrieve",
            {
                "query": query,
                "k": k,
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
        )
        return data

    __call__ = query

    def get_vectorstore_statistics(self) -> dict:
        return self._post("/v1/statistics", {})

    def get_input_files(
        self, metadata_filter: str | None = None, filepath_globpattern: str | None = None
    ) -> list:
        return self._post(
            "/v1/inputs",
            {"metadata_filter": metadata_filter, "filepath_globpattern": filepath_globpattern},
        )
