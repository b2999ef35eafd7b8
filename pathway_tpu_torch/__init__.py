"""pathway_tpu_torch — ``pathway_tpu`` ported to PyTorch and CUDA for one
NVIDIA H100.

Use it like the JAX package::

    import pathway_tpu_torch as pw

    t = pw.debug.table_from_markdown('''
    value
    1
    2''')
    result = t.reduce(total=pw.reducers.sum(pw.this.value))
    pw.debug.compute_and_print(result)

What is ported: the live-RAG loop's ops (``pathway_tpu_torch.ops``: the hash
and WordPiece tokenizers, microbatch padding, the pre-LN sentence encoder and
the exact BERT block of HuggingFace checkpoints (``from_pretrained``) with
their hand-written Hopper attention kernel, the brute-force KNN index, the
cross-encoder), the weight bridge from the JAX package's parameter trees
(``pathway_tpu_torch.convert``), the dataflow engine and the Table API
(``engine/``, ``internals/``), the Python and file connectors (``io.fs``,
``csv``, ``jsonlines``, ``plaintext``, ``null``), ``subscribe``, the REST
serving plane (``io.http``: ``rest_connector`` on an HTTP/1.1 server of the
standard library), the
debug surface, the index family as dataflow operators (``stdlib.indexing``:
brute-force KNN on the card, the tiered index with its hot shard on the card
over a host IVF cold tier, IVF-flat, usearch, LSH, BM25 and hybrid), the
fused device tier of chain fusion, and the LLM xpack's RAG surface
(``xpacks.llm``: embedders, rerankers, chats, parsers, splitters,
DocumentStore, question answering and its REST servers), and the temporal
and stateful Table API (windows, behaviors, interval/asof/as-of-now and window
joins, sort/diff, deduplicate, interpolate, gradual broadcast, ``pw.temporal``,
``pw.stateful``, ``pw.utils``, ``AsyncTransformer``), the flow plane
(``pw.flow``: credit gates, interactive/bulk admission, the AIMD microbatch
controller, under ``PATHWAY_FLOW=on``), ``pw.iterate``, ``stdlib.graphs`` and
``stdlib.ml``, persistence (``pw.persistence``: input logs, operator
snapshots, the index's incremental snapshots) with exactly-once delivery
(``pw.delivery``, ``pw.io.fs.write(..., delivery="exactly_once")``), and the
rest of the Table API surface (``pw.sql``, ``pw.load_yaml``,
``pw.export_table``/``import_table``, the row-transformer API, interactive
mode, ``pw.universes``, ``stdlib.viz``), and multi-worker execution
(``pw.run(n_workers=N)`` on threads, a ``PATHWAY_PROCESSES`` cluster over
TCP, the on-device key exchange, the sharded KNN index, heartbeats and
``pw.resilience.Supervisor``; ``pathway_tpu_torch.parallel``). The other
planes raise
``NotImplementedError("later slice: <plane>")`` where a call reaches them.

Entry points that touch a model or an index run on the card unless the caller
passes ``device="cpu"``. Importing the package loads no ``torch``: a UDF, an
index or a kernel imports it when it is built.
"""

from __future__ import annotations

from pathway_tpu_torch.internals.dtype import DateTimeNaive, DateTimeUtc, Duration, Pointer
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.schema import (
    ColumnDefinition,
    Schema,
    column_definition,
    schema_from_dict,
    schema_from_types,
)
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    apply,
    apply_async,
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
from pathway_tpu_torch.internals.thisclass import left, right, this
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.groupbys import GroupedTable
from pathway_tpu_torch.internals.joins import JoinResult
from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals.reducers import BaseCustomAccumulator
from pathway_tpu_torch.internals.udfs import (
    UDF,
    AsyncExecutor,
    CacheStrategy,
    DefaultCache,
    DiskCache,
    ExponentialBackoffRetryStrategy,
    FixedDelayRetryStrategy,
    FullyAsyncExecutor,
    InMemoryCache,
    SyncExecutor,
    async_executor,
    fully_async_executor,
    udf,
)
from pathway_tpu_torch.internals.run import MonitoringLevel, run, run_all
from pathway_tpu_torch.internals.exported import ExportedTable, export_table, import_table
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.errors import ERROR as _ERROR  # noqa: F401
from pathway_tpu_torch.internals.errors import PENDING

from pathway_tpu_torch import debug, delivery, demo, elastic, io, observability, persistence, resilience, stdlib, universes, xpacks
from pathway_tpu_torch import flow
from pathway_tpu_torch.stdlib import temporal, indexing, ml, graphs, statistical, stateful
from pathway_tpu_torch.stdlib import utils as utils
from pathway_tpu_torch.stdlib.utils.async_transformer import AsyncTransformer
from pathway_tpu_torch.stdlib.utils.pandas_transformer import pandas_transformer
import pathway_tpu_torch.xpacks.llm  # noqa: E402,F401  (pw.xpacks.llm)
from pathway_tpu_torch.internals.iterate import iterate, iterate_universe
from pathway_tpu_torch.internals.yaml_loader import load_yaml

__version__ = "0.1.0"


def global_error_log():
    from pathway_tpu_torch.internals.error_log import global_error_log as _gel

    return _gel()


def sql(query: str, **tables):
    from pathway_tpu_torch.internals.sql import sql as _sql

    return _sql(query, **tables)


from pathway_tpu_torch.internals.interactive import (  # noqa: E402
    LiveTable,
    enable_interactive_mode,
    live,
)
from pathway_tpu_torch.internals.row_transformer import (  # noqa: E402
    ClassArg,
    attribute,
    input_attribute,
    input_method,
    method,
    output_attribute,
    transformer,
)


def set_slo(route: str | None = None, *, p99_ms: float | None = None,
            availability: float | None = None) -> None:
    """Declare a serving SLO for the health plane (``PATHWAY_HEALTH``):
    ``p99_ms`` bounds a route's p99 latency (route=None applies to all
    routes), ``availability`` sets the pod-wide success-ratio target. The
    burn-rate evaluator (``observability/health.py``) alerts when the error
    budget burns faster than the fast AND slow window thresholds."""
    from pathway_tpu_torch.observability.health import set_slo as _set_slo

    _set_slo(route, p99_ms=p99_ms, availability=availability)


def set_monitoring_config(*, server_endpoint: str | None = None, **kwargs) -> None:
    """Configure trace export. ``trace_file=...`` writes an OTLP/JSON trace
    document per run (``internals/telemetry.py``), ``metrics_file=...`` an
    OTLP/JSON metrics document; pass ``None`` explicitly to clear one — calls
    setting only other knobs leave it alone. ``server_endpoint`` (an OTLP
    collector URL) is accepted but inert, as in the reference."""
    from pathway_tpu_torch.internals import telemetry as _telemetry

    _telemetry.set_monitoring_config(**kwargs)


__all__ = [
    "Table",
    "Schema",
    "ColumnDefinition",
    "ColumnExpression",
    "ColumnReference",
    "GroupedTable",
    "JoinResult",
    "Json",
    "Pointer",
    "DateTimeNaive",
    "DateTimeUtc",
    "Duration",
    "MonitoringLevel",
    "UDF",
    "BaseCustomAccumulator",
    "apply",
    "apply_async",
    "apply_with_type",
    "cast",
    "coalesce",
    "column_definition",
    "declare_type",
    "fill_error",
    "if_else",
    "left",
    "make_tuple",
    "reducers",
    "require",
    "right",
    "run",
    "run_all",
    "schema_from_dict",
    "schema_from_types",
    "this",
    "udf",
    "unwrap",
    "debug",
    "io",
    "stdlib",
    "indexing",
    "xpacks",
    "PENDING",
    "G",
    "global_error_log",
    "flow",
    "delivery",
    "demo",
    "elastic",
    "persistence",
    "observability",
    "resilience",
    "set_monitoring_config",
    "set_slo",
    "temporal",
    "stateful",
    "statistical",
    "utils",
    "AsyncTransformer",
    "pandas_transformer",
    "universes",
    "iterate",
    "sql",
    "load_yaml",
    "export_table",
    "import_table",
    "ExportedTable",
    "LiveTable",
    "enable_interactive_mode",
    "live",
    "ClassArg",
    "attribute",
    "input_attribute",
    "input_method",
    "method",
    "output_attribute",
    "transformer",
]
