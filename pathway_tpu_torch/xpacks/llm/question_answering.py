"""RAG question-answering pipelines (reference
``xpacks/llm/question_answering.py:28-1007``).

``BaseRAGQuestionAnswerer`` wires retrieve (KNN on the card) → context
build → chat;
``AdaptiveRAGQuestionAnswerer`` escalates document count geometrically until
the model answers. Answer/summarize/statistics REST endpoints are provided by
``build_server`` (see ``servers.py``).
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from typing import Any

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.json import Json, unwrap_json
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.xpacks.llm._utils import Doc, _coerce_sync
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
from pathway_tpu_torch.xpacks.llm.llms import BaseChat
from pathway_tpu_torch.xpacks.llm.prompts import (
    BASE_PROMPT_TEMPLATE,
    SUMMARIZE_TEMPLATE,
)

logger = logging.getLogger(__name__)


def _limit_documents(documents: list[str], k: int) -> list[str]:
    return documents[:k]


def _docs_to_dicts(docs: Any) -> list[dict]:
    docs = unwrap_json(docs)
    out = []
    for d in docs or ():
        d = unwrap_json(d)
        if isinstance(d, dict):
            out.append(d)
        else:
            out.append({"text": str(d)})
    return out


class BaseContextProcessor(ABC):
    """Turns retrieved docs into the prompt context string (reference
    ``BaseContextProcessor``, question_answering.py:221)."""

    def maybe_unwrap_docs(self, docs) -> list[dict]:
        return _docs_to_dicts(docs)

    def apply(self, docs) -> str:
        return self.docs_to_context(self.maybe_unwrap_docs(docs))

    @abstractmethod
    def docs_to_context(self, docs: list[dict] | list[Doc]) -> str: ...

    def as_udf(self) -> pw.UDF:
        processor = self

        @pw.udf
        def context_processor_udf(docs) -> str:
            return processor.apply(docs)

        return context_processor_udf


class SimpleContextProcessor(BaseContextProcessor):
    """Joins doc texts, optionally with selected metadata (reference
    ``SimpleContextProcessor``, question_answering.py:257)."""

    def __init__(self, context_metadata_keys: list[str] | None = None, docs_separator: str = "\n\n"):
        self.context_metadata_keys = context_metadata_keys or ["path"]
        self.docs_separator = docs_separator

    def docs_to_context(self, docs: list[dict] | list[Doc]) -> str:
        parts = []
        for doc in docs:
            text = str(doc.get("text", ""))
            meta = doc.get("metadata") or {}
            meta = unwrap_json(meta) or {}
            tags = ", ".join(
                f"{k}: {meta[k]}" for k in self.context_metadata_keys if k in meta
            )
            parts.append(f"{text} ({tags})" if tags else text)
        return self.docs_separator.join(parts)


class BaseQuestionAnswerer(ABC):
    """REST-servable QA surface (reference ``BaseQuestionAnswerer``,
    question_answering.py:288)."""

    AnswerQuerySchema: type = schema_mod.schema_from_types(prompt=str)
    RetrieveQuerySchema = DocumentStore.RetrieveQuerySchema
    StatisticsQuerySchema = DocumentStore.StatisticsQuerySchema
    InputsQuerySchema = DocumentStore.InputsQuerySchema

    @abstractmethod
    def answer_query(self, pw_ai_queries: Table) -> Table: ...


class SummaryQuestionAnswerer(BaseQuestionAnswerer):
    SummarizeQuerySchema: type = schema_mod.schema_from_types(text_list=dt.ANY)

    @abstractmethod
    def summarize_query(self, summarize_queries: Table) -> Table: ...


class BaseRAGQuestionAnswerer(SummaryQuestionAnswerer):
    """Standard RAG pipeline (reference ``BaseRAGQuestionAnswerer``,
    question_answering.py:314): retrieve k docs → context → prompt → chat."""

    class AnswerQuerySchema(schema_mod.Schema):
        prompt: str
        filters: str | None
        model: str | None
        return_context_docs: bool | None

    class SummarizeQuerySchema(schema_mod.Schema):
        text_list: dt.ANY
        model: str | None

    def __init__(
        self,
        llm: BaseChat,
        indexer: DocumentStore | Any,
        *,
        default_llm_name: str | None = None,
        short_prompt_template: Any = None,
        long_prompt_template: Any = None,
        summarize_template: Any = None,
        search_topk: int = 6,
        prompt_template: str | Any | None = None,
        context_processor: BaseContextProcessor | None = None,
    ):
        self.llm = llm
        self.indexer = indexer
        self.default_llm_name = default_llm_name
        self.search_topk = search_topk
        if prompt_template is None:
            prompt_template = long_prompt_template or short_prompt_template
        if prompt_template is None:
            self.prompt_template: Any = BASE_PROMPT_TEMPLATE
        elif isinstance(prompt_template, str):
            if "{context}" not in prompt_template or "{query}" not in prompt_template:
                raise ValueError(
                    "prompt_template must contain {context} and {query} placeholders"
                )
            self.prompt_template = prompt_template
        elif callable(prompt_template) or isinstance(prompt_template, pw.UDF):
            self.prompt_template = prompt_template
        else:
            raise TypeError(
                f"prompt_template must be a str, callable or UDF, got {prompt_template!r}"
            )
        self.summarize_template = summarize_template or SUMMARIZE_TEMPLATE
        self.context_processor = context_processor or SimpleContextProcessor()
        self.server = None
        self._pending_endpoints: list = []

    # -- the pipeline ------------------------------------------------------

    def answer_query(self, pw_ai_queries: Table) -> Table:
        """Answer queries against the live index (reference ``answer_query``,
        question_answering.py:451)."""
        queries = pw_ai_queries.select(
            query=pw.this.prompt,
            k=self.search_topk,
            metadata_filter=pw.this.filters,
            filepath_globpattern=None,
            prompt=pw.this.prompt,
            return_context_docs=pw.this.return_context_docs,
        )
        retrieved = self.indexer.retrieve_query(
            queries.select(
                query=pw.this.query,
                k=pw.this.k,
                metadata_filter=pw.this.metadata_filter,
                filepath_globpattern=pw.this.filepath_globpattern,
            )
        )
        with_docs = queries.with_columns(
            docs=retrieved.promise_universes_are_equal(queries).result,
        )
        context_udf = self.context_processor.as_udf()
        template = self.prompt_template
        if isinstance(template, pw.UDF):
            prompt_expr = template(pw.this.prompt, context_udf(pw.this.docs))
        else:
            build = (
                (lambda context, query: template.format(context=context, query=query))
                if isinstance(template, str)
                else template
            )

            @pw.udf
            def build_prompt(query: str, context: str) -> str:
                return build(context=context, query=query)

            prompt_expr = build_prompt(pw.this.prompt, context_udf(pw.this.docs))

        prompts = with_docs.with_columns(rag_prompt=prompt_expr)
        llm = self.llm

        answers = prompts.with_columns(
            response=llm(
                pw.apply_with_type(
                    lambda p: Json([{"role": "user", "content": p}]),
                    dt.JSON,
                    pw.this.rag_prompt,
                )
            )
        )

        @pw.udf
        def format_answer(response, docs, return_context_docs) -> Json:
            out: dict = {"response": response}
            if return_context_docs:
                out["context_docs"] = _docs_to_dicts(docs)
            return Json(out)

        return answers.select(
            result=format_answer(pw.this.response, pw.this.docs, pw.this.return_context_docs)
        )

    def summarize_query(self, summarize_queries: Table) -> Table:
        """Summarize a list of texts (reference ``summarize_query``,
        question_answering.py:491)."""
        llm = self.llm
        template = self.summarize_template

        @pw.udf
        def build_prompt(text_list) -> Json:
            texts = [str(t) for t in unwrap_json(text_list) or ()]
            prompt = template.format(text="\n\n".join(texts))
            return Json([{"role": "user", "content": prompt}])

        answers = summarize_queries.with_columns(
            response=llm(build_prompt(pw.this.text_list))
        )
        return answers.select(
            result=pw.apply_with_type(lambda r: Json({"response": r}), dt.JSON, pw.this.response)
        )

    def retrieve(self, retrieve_queries: Table) -> Table:
        return self.indexer.retrieve_query(retrieve_queries)

    def statistics(self, statistics_queries: Table) -> Table:
        return self.indexer.statistics_query(statistics_queries)

    def list_documents(self, list_documents_queries: Table) -> Table:
        return self.indexer.inputs_query(list_documents_queries)

    # -- serving -----------------------------------------------------------

    def build_server(self, host: str, port: int, **rest_kwargs) -> None:
        """Create the QA REST server (reference ``build_server``,
        question_answering.py:527)."""
        from pathway_tpu_torch.xpacks.llm.servers import QASummaryRestServer

        self.server = QASummaryRestServer(host, port, self, **rest_kwargs)

    def run_server(self, *args, **kwargs):
        if self.server is None:
            raise ValueError("call build_server first")
        return self.server.run(*args, **kwargs)


def answer_with_geometric_rag_strategy(
    questions: Table | Any,
    documents: Any,
    llm: BaseChat,
    prompt_template: str,
    n_starting_documents: int,
    factor: int,
    max_iterations: int,
    strict_prompt: bool = False,
) -> Any:
    """Ask with n docs, retry with factor*n docs while the answer is
    "no information" (reference ``answer_with_geometric_rag_strategy``,
    question_answering.py:97). Host-side loop over the chat callable."""
    chat = _coerce_sync(llm.__wrapped__)

    def answer_one(question: str, docs: list[str]) -> str:
        n = n_starting_documents
        for _ in range(max_iterations):
            context = "\n\n".join(_limit_documents(docs, n))
            prompt = prompt_template.format(context=context, query=question)
            response = chat([{"role": "user", "content": prompt}])
            if response and "no information" not in str(response).lower():
                return str(response)
            n *= factor
        return "No information found."

    @pw.udf
    def geometric_udf(question: str, docs) -> str:
        doc_texts = [
            str(d.get("text", "") if isinstance(d, dict) else d)
            for d in (_docs_to_dicts(docs))
        ]
        return answer_one(question, doc_texts)

    if isinstance(questions, Table):
        return questions.select(
            result=geometric_udf(pw.this.prompt, pw.this.docs)
        )
    return answer_one(questions, documents)


def answer_with_geometric_rag_strategy_from_index(
    questions: Table,
    index,
    documents_column,
    llm: BaseChat,
    prompt_template: str,
    n_starting_documents: int,
    factor: int,
    max_iterations: int,
    strict_prompt: bool = False,
) -> Table:
    """Geometric strategy fed straight from a DataIndex (reference
    ``answer_with_geometric_rag_strategy_from_index``,
    question_answering.py:162)."""
    max_docs = n_starting_documents * factor ** (max_iterations - 1)
    matches = index.query_as_of_now(
        questions.prompt, number_of_matches=max_docs, collapse_rows=True
    )
    col = documents_column if isinstance(documents_column, str) else documents_column._name
    with_docs = questions.with_columns(
        docs=matches.promise_universes_are_equal(questions)[col]
    )
    return answer_with_geometric_rag_strategy(
        with_docs, None, llm, prompt_template, n_starting_documents, factor,
        max_iterations, strict_prompt,
    )


class AdaptiveRAGQuestionAnswerer(BaseRAGQuestionAnswerer):
    """Adaptive RAG: geometric document-count escalation (reference
    ``AdaptiveRAGQuestionAnswerer``, question_answering.py:620)."""

    def __init__(
        self,
        llm: BaseChat,
        indexer: DocumentStore | Any,
        *,
        default_llm_name: str | None = None,
        n_starting_documents: int = 2,
        factor: int = 2,
        max_iterations: int = 4,
        strict_prompt: bool = False,
        **kwargs,
    ):
        super().__init__(llm, indexer, default_llm_name=default_llm_name, **kwargs)
        self.n_starting_documents = n_starting_documents
        self.factor = factor
        self.max_iterations = max_iterations
        self.strict_prompt = strict_prompt

    def answer_query(self, pw_ai_queries: Table) -> Table:
        """reference ``answer_query``, question_answering.py:709"""
        max_docs = self.n_starting_documents * self.factor ** (self.max_iterations - 1)
        queries = pw_ai_queries.select(
            query=pw.this.prompt,
            k=max_docs,
            metadata_filter=pw.this.filters,
            filepath_globpattern=None,
            prompt=pw.this.prompt,
        )
        retrieved = self.indexer.retrieve_query(
            queries.select(
                query=pw.this.query,
                k=pw.this.k,
                metadata_filter=pw.this.metadata_filter,
                filepath_globpattern=pw.this.filepath_globpattern,
            )
        )
        with_docs = queries.with_columns(
            docs=retrieved.promise_universes_are_equal(queries).result
        )
        template = (
            self.prompt_template
            if isinstance(self.prompt_template, str)
            else BASE_PROMPT_TEMPLATE
        )
        answered = answer_with_geometric_rag_strategy(
            with_docs,
            None,
            self.llm,
            template,
            self.n_starting_documents,
            self.factor,
            self.max_iterations,
            self.strict_prompt,
        )
        return answered.select(
            result=pw.apply_with_type(
                lambda r: Json({"response": r}), dt.JSON, pw.this.result
            )
        )


class DeckRetriever(BaseQuestionAnswerer):
    """Slide-deck retriever app (reference ``DeckRetriever``,
    question_answering.py:736)."""

    excluded_response_metadata = ["b64_image"]

    def __init__(self, indexer, *, search_topk: int = 6):
        self.indexer = indexer
        self.search_topk = search_topk
        self.server = None

    def answer_query(self, pw_ai_queries: Table) -> Table:
        queries = pw_ai_queries.select(
            query=pw.this.prompt,
            k=self.search_topk,
            metadata_filter=None,
            filepath_globpattern=None,
        )
        return self.indexer.retrieve_query(queries)


def send_post_request(url: str, data: dict, headers: dict | None = None,
                      timeout: int | None = None):
    """POST JSON and return the decoded JSON response (reference
    ``question_answering.py:send_post_request``)."""
    from pathway_tpu_torch.xpacks.llm._utils import post_json

    return post_json(url, data, headers, timeout)


class RAGClient:
    """HTTP client for RAG apps served by ``QARestServer`` /
    ``QASummaryRestServer`` (reference ``question_answering.py:854``)."""

    def __init__(
        self,
        host: str | None = None,
        port: int | None = None,
        url: str | None = None,
        timeout: int | None = 90,
        additional_headers: dict | None = None,
    ):
        from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreClient

        err = "Either (`host` and `port`) or `url` must be provided, but not both."
        if url is not None:
            if host is not None or port is not None:
                raise ValueError(err)
            self.url = url
        else:
            if host is None:
                raise ValueError(err)
            port = port or 80
            protocol = "https" if port == 443 else "http"
            self.url = f"{protocol}://{host}:{port}"

        self.timeout = timeout
        self.additional_headers = additional_headers or {}
        self.index_client = VectorStoreClient(
            url=self.url,
            timeout=self.timeout,
            additional_headers=self.additional_headers,
        )

    def retrieve(self, query: str, k: int = 3, metadata_filter: str | None = None,
                 filepath_globpattern: str | None = None):
        """Closest documents from the store for ``query``."""
        return self.index_client.query(
            query=query, k=k, metadata_filter=metadata_filter,
            filepath_globpattern=filepath_globpattern,
        )

    def statistics(self):
        """Index statistics."""
        return self.index_client.get_vectorstore_statistics()

    def pw_ai_answer(self, prompt: str, filters: str | None = None,
                     model: str | None = None):
        """RAG answer for ``prompt`` with optional metadata ``filters``."""
        payload: dict = {"prompt": prompt}
        if filters:
            payload["filters"] = filters
        if model:
            payload["model"] = model
        return send_post_request(
            f"{self.url}/v1/pw_ai_answer", payload, self.additional_headers,
            timeout=self.timeout,
        )

    answer = pw_ai_answer

    def pw_ai_summary(self, text_list, model: str | None = None):
        """Summarize ``text_list`` server-side."""
        payload: dict = {"text_list": list(text_list)}
        if model:
            payload["model"] = model
        return send_post_request(
            f"{self.url}/v1/pw_ai_summary", payload, self.additional_headers,
            timeout=self.timeout,
        )

    summarize = pw_ai_summary

    def pw_list_documents(self, filters: str | None = None, keys=("path",)):
        """List indexed documents, projecting metadata to ``keys``."""
        payload: dict = {}
        if filters:
            payload["metadata_filter"] = filters
        response = send_post_request(
            f"{self.url}/v1/pw_list_documents", payload, self.additional_headers,
            timeout=self.timeout,
        )
        if not response:
            return []
        if keys:
            return [{k: v for k, v in dc.items() if k in keys} for dc in response]
        return response
