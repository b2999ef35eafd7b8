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
tokenizer, microbatch padding, the pre-LN sentence encoder with its
hand-written Hopper attention kernel, the brute-force KNN index, the
cross-encoder), the weight bridge from the JAX package's parameter trees
(``pathway_tpu_torch.convert``), the dataflow engine and the Table API
(``engine/``, ``internals/``), the Python connector and ``subscribe``, the
debug surface, the brute-force KNN index as a dataflow operator
(``stdlib.indexing``) and the local embedder and rerankers
(``xpacks.llm``). The other planes raise
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
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.errors import ERROR as _ERROR  # noqa: F401
from pathway_tpu_torch.internals.errors import PENDING

from pathway_tpu_torch import debug, io, stdlib, xpacks
from pathway_tpu_torch.stdlib import indexing
import pathway_tpu_torch.xpacks.llm  # noqa: E402,F401  (pw.xpacks.llm)

__version__ = "0.1.0"


def global_error_log():
    from pathway_tpu_torch.internals.error_log import global_error_log as _gel

    return _gel()


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
]
