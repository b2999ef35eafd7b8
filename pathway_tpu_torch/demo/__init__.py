"""``pw.demo`` — synthetic stream generators for tests and tutorials.

Mirrors the reference's ``python/pathway/demo/__init__.py:28-256``
(``generate_custom_stream``, ``range_stream``, ``noisy_linear_stream``,
``replay_csv``, ``replay_csv_with_time``). Carried from
``pathway_tpu/demo/__init__.py``; the CSV replays parse each field with
``io._format.coerce_scalar`` (the filesystem reader's own parsing).
"""

from __future__ import annotations

import csv as _csv
import random
import time as _time
from typing import Any, Callable

from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io.python import ConnectorSubject, read


def generate_custom_stream(
    value_generators: dict[str, Callable[[int], Any]],
    *,
    schema: schema_mod.SchemaMetaclass,
    nb_rows: int | None = None,
    input_rate: float = 1000.0,
    autocommit_duration_ms: int = 20,
    **kwargs: Any,
) -> Table:
    class _GenSubject(ConnectorSubject):
        def run(self) -> None:
            i = 0
            delay = 1.0 / input_rate if input_rate > 0 else 0.0
            while nb_rows is None or i < nb_rows:
                row = {name: gen(i) for name, gen in value_generators.items()}
                self.next(**row)
                i += 1
                if delay:
                    _time.sleep(delay)

    return read(_GenSubject(), schema=schema, autocommit_duration_ms=autocommit_duration_ms)


def range_stream(
    nb_rows: int = 30,
    offset: int = 0,
    input_rate: float = 1000.0,
    autocommit_duration_ms: int = 20,
) -> Table:
    schema = schema_mod.schema_from_types(value=int)
    return generate_custom_stream(
        {"value": lambda i: i + offset},
        schema=schema,
        nb_rows=nb_rows,
        input_rate=input_rate,
        autocommit_duration_ms=autocommit_duration_ms,
    )


def noisy_linear_stream(
    nb_rows: int = 10, input_rate: float = 1000.0, **kwargs: Any
) -> Table:
    schema = schema_mod.schema_from_types(x=float, y=float)
    rng = random.Random(0)
    return generate_custom_stream(
        {"x": lambda i: float(i), "y": lambda i: float(i) + rng.uniform(-1, 1)},
        schema=schema,
        nb_rows=nb_rows,
        input_rate=input_rate,
    )


def replay_csv(
    path: str,
    *,
    schema: schema_mod.SchemaMetaclass,
    input_rate: float = 1000.0,
) -> Table:
    from pathway_tpu_torch.io._format import coerce_scalar as _coerce

    dtypes = schema.dtypes()
    cols = schema.column_names()

    class _ReplaySubject(ConnectorSubject):
        def run(self) -> None:
            delay = 1.0 / input_rate if input_rate > 0 else 0.0
            with open(path, newline="") as f:
                for rec in _csv.DictReader(f):
                    self.next(**{c: _coerce(rec.get(c, ""), dtypes[c]) for c in cols})
                    if delay:
                        _time.sleep(delay)

    return read(_ReplaySubject(), schema=schema)


def replay_csv_with_time(
    path: str,
    *,
    schema: schema_mod.SchemaMetaclass,
    time_column: str,
    unit: str = "s",
    autocommit_ms: int = 100,
    speedup: float = 1.0,
) -> Table:
    from pathway_tpu_torch.io._format import coerce_scalar as _coerce

    dtypes = schema.dtypes()
    cols = schema.column_names()
    div = {"s": 1.0, "ms": 1e3, "us": 1e6, "ns": 1e9}[unit]

    class _ReplayTimedSubject(ConnectorSubject):
        def run(self) -> None:
            start_wall = _time.time()
            start_t: float | None = None
            with open(path, newline="") as f:
                for rec in _csv.DictReader(f):
                    row = {c: _coerce(rec.get(c, ""), dtypes[c]) for c in cols}
                    t = float(row[time_column]) / div
                    if start_t is None:
                        start_t = t
                    target = start_wall + (t - start_t) / speedup
                    now = _time.time()
                    if target > now:
                        _time.sleep(target - now)
                    self.next(**row)

    return read(_ReplayTimedSubject(), schema=schema)
