"""Prompt templates for RAG question answering (reference
``xpacks/llm/prompts.py`` — templates re-written, same roles: short QA over
retrieved context, strict-JSON citation variant, summarization).
"""

from __future__ import annotations

import functools
import re
from abc import ABC, abstractmethod

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.udfs import udf as pw_udf

BASE_PROMPT_TEMPLATE = (
    "Answer the question using only the context below. "
    "Reply with a short answer; if the context does not contain the answer, "
    "reply exactly `No information found.`\n\n"
    "Context:\n{context}\n\nQuestion: {query}\nAnswer:"
)

STRICT_JSON_PROMPT_TEMPLATE = (
    "You answer questions from provided context documents only.\n"
    "Respond with a single JSON object: "
    '{{"answer": "<short answer or `No information found.`>"}}.\n\n'
    "Context:\n{context}\n\nQuestion: {query}\nJSON:"
)

SUMMARIZE_TEMPLATE = (
    "Summarize the following texts into one concise paragraph, keeping the "
    "key facts:\n\n{text}\n\nSummary:"
)


@pw.udf
def prompt_qa(query: str, context: str) -> str:
    """Build the default QA prompt (reference ``prompt_qa``)."""
    return BASE_PROMPT_TEMPLATE.format(context=context, query=query)


@pw.udf
def prompt_short_qa(query: str, context: str) -> str:
    return (
        "Give the shortest possible factual answer (a few words) based only "
        f"on this context:\n{context}\n\nQuestion: {query}\nAnswer:"
    )


@pw.udf
def prompt_citing_qa(query: str, context: str) -> str:
    return (
        "Answer from the context and cite the source file of each fact in "
        f"brackets.\n\nContext:\n{context}\n\nQuestion: {query}\nAnswer:"
    )


@pw.udf
def prompt_summarize(text_list: list[str]) -> str:
    return SUMMARIZE_TEMPLATE.format(text="\n\n".join(text_list))


@pw.udf
def prompt_query_rewrite_hyde(query: str) -> str:
    return (
        "Write a short hypothetical passage that would answer the question "
        f"below (used for retrieval only).\nQuestion: {query}\nPassage:"
    )


@pw.udf
def prompt_query_rewrite(query: str) -> str:
    return (
        "Rewrite the user question as a concise search query, keeping all "
        f"named entities.\nQuestion: {query}\nSearch query:"
    )


# ---------------------------------------------------------------------------
# prompt template classes (reference ``prompts.py:11-99``; implemented
# without pydantic — validation happens in __init__)


class BasePromptTemplate(ABC):
    """A prompt template that can be instantiated as a UDF
    (reference ``prompts.py:11``)."""

    @abstractmethod
    def as_udf(self, **kwargs): ...


class FunctionPromptTemplate(BasePromptTemplate):
    """Wraps a callable or UDF as a prompt template
    (reference ``prompts.py:19``)."""

    def __init__(self, function_template=None, **kwargs):
        if function_template is None:
            function_template = kwargs.pop("template", None)
        if function_template is None:
            raise ValueError("function_template is required")
        self.function_template = function_template

    def as_udf(self, **kwargs):
        from pathway_tpu_torch.internals.udfs import UDF

        if isinstance(self.function_template, UDF):
            return self.function_template
        return pw_udf(functools.partial(self.function_template, **kwargs))


class StringPromptTemplate(BasePromptTemplate):
    """A ``str.format`` template over ``context``/``query`` columns
    (reference ``prompts.py:34``)."""

    def __init__(self, template: str):
        self.template = template

    def format(self, **kwargs) -> str:
        return self.template.format(**kwargs)

    def as_udf(self, **kwargs):
        def udf_formatter(context: str, query: str) -> str:
            return self.format(query=query, context=context, **kwargs)

        return pw_udf(udf_formatter)


class RAGPromptTemplate(StringPromptTemplate):
    """StringPromptTemplate validated to carry exactly ``{context}`` and
    ``{query}`` placeholders (reference ``prompts.py:61``)."""

    def __init__(self, template: str):
        if "{context}" not in template or "{query}" not in template:
            raise ValueError(
                "Template must contain `{context}` and `{query}` placeholders."
            )
        try:
            template.format(context=" ", query=" ")
        except KeyError:
            raise ValueError(
                "RAG prompt template expects `context` and `query` placeholders only."
            )
        super().__init__(template)


class RAGFunctionPromptTemplate(FunctionPromptTemplate):
    """FunctionPromptTemplate validated to accept context/query kwargs
    (reference ``prompts.py:79``)."""

    def __init__(self, function_template=None, **kwargs):
        super().__init__(function_template, **kwargs)
        from pathway_tpu_torch.internals.udfs import UDF

        fn = (
            self.function_template.__wrapped__
            if isinstance(self.function_template, UDF)
            else self.function_template
        )
        import inspect

        try:
            inspect.signature(fn).bind(query=" ", context=" ")
        except TypeError as e:
            raise ValueError(
                "RAG prompt template expects `context` and `query` placeholders "
                "only.\n" + str(e)
            )


def prompt_qa_geometric_rag(
    query: str,
    docs,
    information_not_found_response: str = "No information found.",
    additional_rules: str = "",
    strict_prompt: bool = False,
) -> str:
    """Citation-style QA prompt over numbered sources (reference
    ``prompts.py:194``); ``strict_prompt`` requests parsable-JSON answers
    for local models."""
    pieces = []
    for i, doc in enumerate(docs, 1):
        text = doc if isinstance(doc, str) else doc["text"]
        pieces.append(f"Source {i}: {text}")
    context_str = "\n".join(pieces)
    if strict_prompt:
        head = (
            "Use the below articles to answer the subsequent question. If the "
            f'answer cannot be found in the articles, write "'
            f'{information_not_found_response}" Do not explain.\n'
            "ONLY RESPOND IN PARSABLE JSON WITH THE ONLY KEY `answer`.\n"
            "When referencing information from a source, cite the appropriate "
            "source(s) using their corresponding numbers. Every answer should "
            "include at least one source citation."
        )
    else:
        head = (
            "Use the below articles to answer the subsequent question. If the "
            f'answer cannot be found in the articles, write "'
            f'{information_not_found_response}" Do not answer in full '
            "sentences.\nWhen referencing information from a source, cite the "
            "appropriate source(s) using their corresponding numbers. Every "
            "answer should include at least one source citation."
        )
    return (
        f"{head}\n{additional_rules}\n"
        f"Sources:\n{context_str}\n"
        f"Query: {query}\nAnswer:"
    )


def parse_cited_response(response_text: str, docs):
    """Split a cited answer into (clean_text, cited_docs); citations are
    ``[n]`` markers resolved against ``docs`` (reference ``prompts.py:316``)."""
    cited_idx = sorted(
        {int(cite[1:-1]) - 1 for cite in re.findall(r"\[\d+\]", response_text)}
    )
    citations = [docs[i] for i in cited_idx if 0 <= i < len(docs)]
    clean = re.sub(r"\s*\[\d+\]", "", response_text).strip()
    return clean, citations


DEFAULT_JSON_TABLE_PARSE_PROMPT = (
    "Explain the given table in JSON format in detail. Do not skip any "
    "information in the table."
)
DEFAULT_MD_TABLE_PARSE_PROMPT = (
    "Explain the given table in markdown format in detail. Do not skip any "
    "information in the table."
)
DEFAULT_IMAGE_PARSE_PROMPT = (
    "Explain the given image in detail. List all the objects and their "
    "attributes you can see."
)
