"""pathway_tpu_torch — the PyTorch/CUDA port of pathway_tpu for one
NVIDIA H100.

It carries the RAG main path: hashing or WordPiece tokenizer (C++ batch
loops, an encode memo) -> MiniLM-style encoder (attention through a
hand-written CUDA flash-attention kernel) -> sentence embedder (a threaded
ingest pipeline, and a text -> vector dedup in the
``SentenceTransformerEmbedder`` seam) and brute-force KNN index ->
cross-encoder rerank, in ``FusedRAGPipeline``; HF checkpoint loaders for
the encoders and the decoder; and the answer LLM: a GPT-2-family decoder served by
``DecoderChat`` (batch-static, or a continuous-batching server over a dense
or paged KV pool, with a prefix KV cache and its host tier) with CUDA
kernels for chunked prefill, paged decode and int8-weight products;
``QueryServer`` micro-batches concurrent queries into one pipeline call a
tick. Entry points run on CUDA unless given ``device="cpu"``. The package
imports neither JAX nor ``pathway_tpu``.

The RAG retrieval variants JAX keeps off by default are off here too:
int8 encoder weights (``weight_quant="int8"``), the IVF-Flat index on the
card (``IvfFlatIndex``) and the host-side HNSW graph (``HnswIndex``), the
late-interaction doc-token bank with its MaxSim cascade
(``FusedRAGPipeline(late_interaction=True)``) and the listwise LLM rerank
(``llm_reranker=ListwiseLLMReranker(chat), llm_rerank=True``).

Telemetry is on by default, as in JAX: ``engine.probes`` holds the
metrics registry and its ledgers (``serving_snapshot()``,
``set_metrics(False)`` turns every write off), ``engine.tracing`` the
per-request spans (``recent_traces``, ``configure(trace_dir=...)`` for a
JSONL flight recorder), and ``internals.http_server`` the registry's
OpenMetrics text.

Supervision follows JAX's defaults: ``engine.slo`` (the SLO watchdog and
the degradation ladder the decode server reads, ``slo.configure``),
``engine.chaos`` (fault injection sites, off until ``chaos.configure``),
and the servers' ``serve_restarts`` / ``serve_retries`` /
``request_deadline_ms`` / ``serve_queue`` / ``degradation`` arguments.

The serving features JAX keeps off by default are off here too: the
decode server's prefill lane (``disagg``) and tenant scheduling with
preemption (``tenant_sched``), and ``serving``, a fleet of in-process
replicas behind a prefix-affinity router (``serving.build_fleet``).

``parallel`` is the single-controller mesh layer (device meshes whose
positions may be virtual shards of one card, sharded tensors and their
collectives, sharded KNN and IVF, ring attention, the multi-process
bootstrap). It carries the serving mesh (``DecoderChat(mesh=...)``:
tensor-parallel blocks and a head-sharded KV pool), the embedder's
``mesh=``, ``FusedRAGPipeline(mesh_retrieval=...)``, the MoE block and the
pipelined encoder (``models/moe.py``, ``models/pipeline.py``) and the
checkpoint format both packages read (``models/checkpoint.py``
``save_checkpoint`` / ``load_checkpoint``).

The dataflow engine is the ``pw`` namespace, as in JAX
(``import pathway_tpu_torch as pw``): ``Table`` and ``Schema``, the
expression and reducer API, UDFs (``pw.udf``, ``pw.UDF``, batched and
deferred two-phase UDFs), joins (``Table.join*``, ``pw.left`` /
``pw.right``, ``JoinMode``), ``pw.io`` (``python``, ``kafka`` with its
in-process broker, ``http``'s REST connector, ``null``, ``subscribe``),
``pw.debug``, ``pw.indexing`` (``DataIndex`` over ``BruteForceKnn``) and
``pw.run``, whose engine switches are one ``EngineConfig``
(``pw.run(config=...)``; JAX's defaults, no environment variable). The
engine is host Python and numpy with C++ loops for keys, consolidation
and the hash join; the device work of a program is its UDFs' and
indexes'. On it run the RAG applications of ``xpacks.llm``:
``DocumentStore``, ``VectorStoreServer``, ``BaseRAGQuestionAnswerer`` and
the REST servers, with the embedder, reranker and answer-LLM UDFs on the
card. ``pw.temporal`` (windows with their behaviours, the asof, interval,
window and asof-now joins), ``Table.sort`` / ``diff`` / ``interpolate``
(``pw.ordered``, ``pw.statistical``) and the sorted index are host
operators too, as are ``pw.iterate`` (a body run to its fixpoint on a
nested scheduler), ``pw.graphs`` and ``Table._gradual_broadcast``.
``EngineConfig(processes=N, process_id=p, first_port=...)`` makes a run
one of N processes on the host that exchange rows over TCP before each
stateful operator (``engine/exchange.py``); each process keeps its own
device work. ``pw.ml`` (LSH classifiers, ``clustering_via_lsh`` with its
k-means on the card, ``knn_classifier``, the fuzzy join) and
``pw.utils`` are JAX's; ``pw.run(monitoring_level=..., with_http_server=
True)`` draws the live dashboard and serves the run's metrics;
``python -m pathway_tpu_torch`` is the CLI (``stats``, ``watch``, ``fleet
serve`` over replica processes, ``replay``). ``pw.persistence`` logs the
sources and operator state and resumes a run exactly once. ``pw.io``
carries JAX's connectors but Airbyte (the object stores, S3 and its
vendors, Debezium, Delta Lake, SQLite, Postgres and the thin writers,
each behind JAX's client seam); ``pw.export_table`` / ``pw.import_table``
hand a live table to a second program, ``Table.live()`` keeps one in the
background (``LiveTable``), and ``pw.stateful.deduplicate`` is JAX's.
The pandas-backed datetime types load on first use, so a program
without datetimes runs without pandas.
"""

from pathway_tpu_torch.device import resolve_device
from pathway_tpu_torch.internals import dtype as _dt
from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals import universe as _universe_mod
from pathway_tpu_torch.internals.api import (
    ERROR,
    Pending,
    PersistenceMode,
    Pointer,
    PyObjectWrapper,
    unwrap_py_object,
    wrap_py_object,
)
from pathway_tpu_torch.internals.api import PathwayType as Type
from pathway_tpu_torch.internals.config import EngineConfig, set_license_key, set_monitoring_config
from pathway_tpu_torch.internals.custom_reducers import BaseCustomAccumulator
from pathway_tpu_torch.internals.errors import global_error_log, local_error_log
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    apply,
    apply_async,
    apply_async_with_type,
    apply_fully_async,
    apply_with_type,
    cast,
    coalesce,
    declare_type,
    fill_error,
    if_else,
    make_tuple,
    require,
    unwrap,
)
from pathway_tpu_torch.internals.groupbys import GroupedJoinResult, GroupedTable
from pathway_tpu_torch.internals.join_mode import JoinMode
from pathway_tpu_torch.internals.joins import (
    JoinResult,
    OuterJoinResult,
    groupby,
    join,
    join_inner,
    join_left,
    join_outer,
    join_right,
)
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.monitoring import MonitoringLevel
from pathway_tpu_torch.internals.parse_graph import G, clear_graph
from pathway_tpu_torch.internals.run import run, run_all
from pathway_tpu_torch.internals.schema import (
    ColumnDefinition,
    Schema,
    SchemaProperties,
    column_definition,
    schema_builder,
    schema_from_csv,
    schema_from_dict,
    schema_from_pandas,
    schema_from_types,
)
from pathway_tpu_torch.internals.table import Joinable, Table, TableLike
from pathway_tpu_torch.internals.table_slice import TableSlice
from pathway_tpu_torch.internals.thisclass import left, right, this
from pathway_tpu_torch.internals import udfs
from pathway_tpu_torch.internals.udfs import (
    UDF,
    UDFAsync,
    UDFSync,
    async_executor,
    auto_executor,
    fully_async_executor,
    sync_executor,
    udf,
    udf_async,
)
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch import debug, io, persistence  # noqa: E402
from pathway_tpu_torch.stdlib import graphs, indexing, ml, ordered, stateful, statistical, temporal, utils  # noqa: E402
from pathway_tpu_torch.internals.interactive import (  # noqa: E402
    LiveTable,
    enable_interactive_mode,
)
from pathway_tpu_torch.internals.exported import (  # noqa: E402
    ExportedTable,
    export_table,
    import_table,
)
from pathway_tpu_torch.stdlib.utils.async_transformer import AsyncTransformer  # noqa: E402
from pathway_tpu_torch.stdlib.utils.pandas_transformer import pandas_transformer  # noqa: E402
from pathway_tpu_torch.internals.iterate import iterate, iterate_universe  # noqa: E402
from pathway_tpu_torch.stdlib.temporal import (  # noqa: E402
    AsofJoinResult,
    IntervalJoinResult,
    WindowJoinResult,
)
from pathway_tpu_torch.engine import probes, tracing
from pathway_tpu_torch.models import (
    MINILM_L6,
    CrossEncoderModel,
    HashTokenizer,
    SentenceEmbedderModel,
    TransformerConfig,
)
from pathway_tpu_torch.ops.fused_query import FusedRAGPipeline
from pathway_tpu_torch.ops.hnsw import HnswIndex
from pathway_tpu_torch.ops.ivf import IvfFlatIndex
from pathway_tpu_torch.ops.knn import BruteForceKnnIndex
from pathway_tpu_torch.ops.query_server import QueryServer
from pathway_tpu_torch.xpacks.llm import DecoderChat

PointerType = Pointer
DATE_TIME_NAIVE = _dt.DATE_TIME_NAIVE
DATE_TIME_UTC = _dt.DATE_TIME_UTC
DURATION = _dt.DURATION

universes = _universe_mod

_DATETIME_TYPES = ("DateTimeNaive", "DateTimeUtc", "Duration")


def __getattr__(name: str):
    # the datetime types subclass pandas' Timestamp / Timedelta: imported
    # (with pandas) on first use only
    if name in _DATETIME_TYPES:
        from pathway_tpu_torch.internals import datetime_types

        return getattr(datetime_types, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_DATETIME_TYPES))


def assert_table_has_schema(
    table: Table,
    schema,
    *,
    allow_superset: bool = True,
    ignore_primary_keys: bool = True,
) -> None:
    schema.assert_matches_schema(
        table.schema,
        allow_superset=allow_superset,
        ignore_primary_keys=ignore_primary_keys,
    )


def table_transformer(fn=None, **kwargs):
    """Decorator marking a function as a table -> table transformer (no
    checks, as in JAX)."""

    def wrap(f):
        return f

    if fn is not None:
        return wrap(fn)
    return wrap


__all__ = [
    "Table",
    "TableLike",
    "TableSlice",
    "GroupedTable",
    "GroupedJoinResult",
    "Joinable",
    "JoinMode",
    "JoinResult",
    "OuterJoinResult",
    "AsofJoinResult",
    "IntervalJoinResult",
    "WindowJoinResult",
    "join",
    "join_inner",
    "join_left",
    "join_right",
    "join_outer",
    "groupby",
    "left",
    "right",
    "MonitoringLevel",
    "PersistenceMode",
    "persistence",
    "UDFAsync",
    "UDFSync",
    "Schema",
    "Json",
    "Pointer",
    "Duration",
    "DateTimeNaive",
    "DateTimeUtc",
    "UDF",
    "udf",
    "udf_async",
    "udfs",
    "this",
    "reducers",
    "apply",
    "apply_with_type",
    "apply_async",
    "apply_async_with_type",
    "apply_fully_async",
    "cast",
    "coalesce",
    "declare_type",
    "if_else",
    "make_tuple",
    "require",
    "unwrap",
    "fill_error",
    "iterate",
    "iterate_universe",
    "LiveTable",
    "enable_interactive_mode",
    "ExportedTable",
    "export_table",
    "import_table",
    "stateful",
    "graphs",
    "run",
    "run_all",
    "EngineConfig",
    "G",
    "clear_graph",
    "debug",
    "io",
    "indexing",
    "ml",
    "utils",
    "AsyncTransformer",
    "pandas_transformer",
    "set_license_key",
    "set_monitoring_config",
    "ordered",
    "statistical",
    "temporal",
    "column_definition",
    "schema_from_types",
    "schema_from_dict",
    "schema_from_pandas",
    "schema_builder",
    "global_error_log",
    "ERROR",
    "Pending",
    "BruteForceKnnIndex",
    "CrossEncoderModel",
    "DecoderChat",
    "FusedRAGPipeline",
    "HashTokenizer",
    "HnswIndex",
    "IvfFlatIndex",
    "MINILM_L6",
    "QueryServer",
    "SentenceEmbedderModel",
    "TransformerConfig",
    "probes",
    "resolve_device",
    "tracing",
]
