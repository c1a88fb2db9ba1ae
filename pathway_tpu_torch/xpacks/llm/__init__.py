"""LLM pack of the port (counterpart of ``pathway_tpu/xpacks/llm``;
reference ``python/pathway/xpacks/llm/``).

The device stages run on the card through the port's models: the embedder
UDF (``SentenceTransformerEmbedder``), the reranker UDFs
(``CrossEncoderReranker``, ``EncoderReranker``, ``ListwiseLLMReranker``)
and the answer LLM (``DecoderChat``, a batched ``BaseChat``). The
application layer is JAX's: ``DocumentStore`` and ``VectorStoreServer``
over a ``DataIndex``, ``BaseRAGQuestionAnswerer`` and its adaptive
variant, and the REST servers (``servers.py``) over ``pw.io.http``. The
API-client chats, embedders and reranker (OpenAI, LiteLLM, Gemini, Cohere,
a ``transformers`` pipeline, FlashRank) and the vision parsers keep JAX's
signatures, in ``llms``, ``embedders``, ``rerankers`` and ``parsers``.
"""

from pathway_tpu_torch.xpacks.llm import (
    embedders,
    llms,
    parsers,
    prompts,
    rerankers,
    splitters,
)
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore, SlidesDocumentStore
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
from pathway_tpu_torch.xpacks.llm.llms import (
    BaseChat,
    DecoderChat,
    decode_serve_error,
    encode_serve_error,
)
from pathway_tpu_torch.xpacks.llm.question_answering import (
    AdaptiveRAGQuestionAnswerer,
    BaseContextProcessor,
    BaseQuestionAnswerer,
    BaseRAGQuestionAnswerer,
    DeckRetriever,
    RAGClient,
    SimpleContextProcessor,
    SummaryQuestionAnswerer,
    answer_with_geometric_rag_strategy,
    answer_with_geometric_rag_strategy_from_index,
)
from pathway_tpu_torch.xpacks.llm.rerankers import (
    CrossEncoderReranker,
    EncoderReranker,
    ListwiseLLMReranker,
)
from pathway_tpu_torch.xpacks.llm.servers import (
    BaseRestServer,
    DocumentStoreServer,
    QARestServer,
    QASummaryRestServer,
    serve_callable,
)
from pathway_tpu_torch.ops.fused_query import FusedRAGPipeline
from pathway_tpu_torch.xpacks.llm.vector_store import (
    SlidesVectorStoreServer,
    VectorStoreClient,
    VectorStoreServer,
)

__all__ = [
    "FusedRAGPipeline",
    "embedders",
    "llms",
    "parsers",
    "prompts",
    "rerankers",
    "splitters",
    "BaseChat",
    "CrossEncoderReranker",
    "DecoderChat",
    "EncoderReranker",
    "ListwiseLLMReranker",
    "SentenceTransformerEmbedder",
    "decode_serve_error",
    "encode_serve_error",
    "DocumentStore",
    "SlidesDocumentStore",
    "AdaptiveRAGQuestionAnswerer",
    "BaseContextProcessor",
    "BaseQuestionAnswerer",
    "BaseRAGQuestionAnswerer",
    "DeckRetriever",
    "RAGClient",
    "SimpleContextProcessor",
    "SummaryQuestionAnswerer",
    "answer_with_geometric_rag_strategy",
    "answer_with_geometric_rag_strategy_from_index",
    "BaseRestServer",
    "DocumentStoreServer",
    "QARestServer",
    "QASummaryRestServer",
    "serve_callable",
    "SlidesVectorStoreServer",
    "VectorStoreClient",
    "VectorStoreServer",
]
