"""Parser / Formatter abstraction — the seam between raw connector payloads and
typed engine rows.

Role of the reference's ``src/connectors/data_format.rs``: ``Parser``
(``:246`` — DsvParser:763, IdentityParser:843, DebeziumMessageParser:1433,
JsonLinesParser:1565, TransparentParser:1671) turns a raw message into
``ParsedEvent::{Insert,Delete}``; ``Formatter`` (``:442`` — DsvFormatter:924,
SingleColumnFormatter:991, JsonLinesFormatter:1932, NullFormatter:1976) renders an
output diff row into sink payloads. Every connector composes one of each, so new
transports (Kafka, S3, sockets…) cost only a Reader/Writer, and new encodings cost
only a Parser/Formatter.
"""

from __future__ import annotations

import csv as _csv
import io as _io
import json as _json
from dataclasses import dataclass, field
from typing import Any, Iterable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod


# --------------------------------------------------------------------------- events
@dataclass
class RawMessage:
    """One transport-level message (Kafka record, file line, socket frame)."""

    value: bytes | str
    key: bytes | str | None = None
    metadata: dict[str, Any] = field(default_factory=dict)


@dataclass
class ParsedEvent:
    """Typed row delta produced by a parser (``ParsedEvent::{Insert,Delete}``,
    ``data_format.rs:93``). ``values`` follow the parser schema's column order.
    ``tombstone`` marks a Debezium null-payload key-death record: ``values``
    carry only the primary-key fields (from the message key) and consumers in
    upsert sessions translate it to a keyed delete, while diff-native sessions
    ignore it (the preceding ``op: d`` event already retracted the row)."""

    values: tuple
    diff: int = 1
    tombstone: bool = False


def coerce_scalar(tok: Any, d: dt.DType) -> Any:
    """Parse one textual token into the schema dtype; parse failures become the
    ERROR value (``Value::Error`` poisoning, not an abort)."""
    d = dt.unoptionalize(d)
    try:
        if tok is None:
            return None
        if d == dt.INT:
            return int(tok)
        if d == dt.FLOAT:
            return float(tok)
        if d == dt.BOOL:
            if isinstance(tok, bool):
                return tok
            return str(tok).strip().lower() in ("true", "1", "yes", "t")
        if d == dt.JSON:
            from pathway_tpu_torch.internals.json import Json

            if isinstance(tok, Json):
                return tok
            if isinstance(tok, (dict, list, int, float, bool)):
                return Json(tok)
            return Json(_json.loads(tok))
        if d == dt.BYTES:
            return tok.encode() if isinstance(tok, str) else tok
        if d == dt.STR and isinstance(tok, bytes):
            return tok.decode(errors="replace")
        return tok
    except (ValueError, TypeError):
        from pathway_tpu_torch.internals.errors import ERROR

        return ERROR


def _as_text(raw: bytes | str) -> str:
    return raw.decode(errors="replace") if isinstance(raw, bytes) else raw


# --------------------------------------------------------------------------- parsers
class Parser:
    """Turns one RawMessage into typed ParsedEvents."""

    def __init__(self, schema: schema_mod.SchemaMetaclass):
        self.schema = schema
        self.columns = schema.column_names()
        self.dtypes = schema.dtypes()

    def parse(self, message: RawMessage) -> list[ParsedEvent]:
        raise NotImplementedError

    def _row_from_mapping(self, rec: dict) -> tuple:
        return tuple(coerce_scalar(rec.get(c), self.dtypes[c]) for c in self.columns)


class DsvParser(Parser):
    """Delimiter-separated values; one message = one record. Fields follow the
    schema's column order (Kafka-style headerless lines)."""

    def __init__(self, schema, delimiter: str = ","):
        super().__init__(schema)
        self.delimiter = delimiter

    def parse(self, message: RawMessage) -> list[ParsedEvent]:
        text = _as_text(message.value)
        reader = _csv.reader(_io.StringIO(text), delimiter=self.delimiter)
        out = []
        for rec in reader:
            if not rec:
                continue
            out.append(
                ParsedEvent(
                    tuple(
                        coerce_scalar(tok, self.dtypes[c])
                        for tok, c in zip(rec, self.columns)
                    )
                )
            )
        return out


class JsonLinesParser(Parser):
    """One JSON object per message (or per line of a multi-line message)."""

    def parse(self, message: RawMessage) -> list[ParsedEvent]:
        out = []
        for line in _as_text(message.value).splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = _json.loads(line)
            except ValueError:
                from pathway_tpu_torch.internals.errors import ERROR

                out.append(ParsedEvent(tuple(ERROR for _ in self.columns)))
                continue
            out.append(ParsedEvent(self._row_from_mapping(rec)))
        return out


class IdentityParser(Parser):
    """Raw payload into the single ``data`` column (plaintext/binary streams)."""

    def parse(self, message: RawMessage) -> list[ParsedEvent]:
        (col,) = self.columns
        return [ParsedEvent((coerce_scalar(message.value, self.dtypes[col]),))]


class TransparentParser(Parser):
    """Values already arrive as tuples in schema order (in-process sources)."""

    def parse(self, message: RawMessage) -> list[ParsedEvent]:
        return [ParsedEvent(tuple(message.value))]


def rows_from_bytes(data: bytes, fmt: str, schema) -> list[tuple]:
    """Decode one whole payload (file / object) into schema-ordered rows —
    the ONE per-format recipe shared by the fs and s3 connectors so format
    semantics (csv coercion, JSON wrapping) cannot drift between them."""
    cols = schema.column_names()
    dtypes = schema.dtypes()
    if fmt == "binary":
        return [(data,)]
    text = data.decode(errors="replace")
    if fmt in ("plaintext_by_file", "plaintext_by_object"):
        return [(text,)]
    if fmt == "plaintext":
        return [(line,) for line in text.splitlines()]
    if fmt == "csv":
        rows = []
        for rec in _csv.DictReader(_io.StringIO(text)):
            rows.append(tuple(coerce_scalar(rec.get(c, ""), dtypes[c]) for c in cols))
        return rows
    if fmt in ("json", "jsonlines"):
        from pathway_tpu_torch.internals.json import Json

        rows = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            rec = _json.loads(line)
            row = []
            for c in cols:
                v = rec.get(c)
                d = dt.unoptionalize(dtypes[c])
                if d == dt.JSON and not isinstance(v, Json):
                    v = Json(v)
                row.append(v)
            rows.append(tuple(row))
        return rows
    raise ValueError(f"unknown format {fmt!r}")


class DebeziumMessageParser(Parser):
    """CDC envelopes: ``{"payload": {"op": c|r|u|d, "before": …, "after": …}}``
    (reference ``DebeziumMessageParser:1433``, standard + MongoDB dialects).

    All four ops are handled: ``c``/``r`` insert ``after``; ``u`` retracts
    ``before`` and inserts ``after``; ``d`` retracts ``before``. Messages may
    arrive with or without the Connect ``{"schema": …, "payload": …}`` wrapper
    (both key and value sides). A null value / ``"payload": null`` is the
    Debezium log-compaction tombstone: with ``tombstones=True`` it parses into
    a pk-only event (pk fields unwrapped from the message key, ``diff=-1``,
    ``tombstone=True``) that upsert consumers turn into a keyed delete;
    with the default ``tombstones=False`` it is silently skipped — diff-native
    consumers already saw the retraction in the preceding ``op: d`` event."""

    def __init__(self, schema, tombstones: bool = False):
        super().__init__(schema)
        self.tombstones = tombstones

    @staticmethod
    def _unwrap(rec):
        """Strip the Kafka Connect schema block when present."""
        if isinstance(rec, dict) and "payload" in rec:
            return rec["payload"]
        return rec

    def _tombstone(self, message: RawMessage) -> list[ParsedEvent]:
        if not self.tombstones or message.key is None:
            return []
        try:
            krec = _json.loads(_as_text(message.key))
        except ValueError:
            return []
        kpayload = self._unwrap(krec)
        if not isinstance(kpayload, dict):
            return []
        return [
            ParsedEvent(self._row_from_mapping(kpayload), diff=-1, tombstone=True)
        ]

    def parse(self, message: RawMessage) -> list[ParsedEvent]:
        text = _as_text(message.value).strip() if message.value is not None else ""
        if not text or text == "null":
            return self._tombstone(message)
        rec = _json.loads(text)
        payload = self._unwrap(rec)
        if payload is None:
            return self._tombstone(message)
        op = payload.get("op", "c")
        before, after = payload.get("before"), payload.get("after")
        if isinstance(before, str):  # MongoDB dialect ships embedded JSON strings
            before = _json.loads(before)
        if isinstance(after, str):
            after = _json.loads(after)
        out = []
        if op in ("d", "u") and before is not None:
            out.append(ParsedEvent(self._row_from_mapping(before), diff=-1))
        if op in ("c", "r", "u") and after is not None:
            out.append(ParsedEvent(self._row_from_mapping(after), diff=1))
        return out


# ------------------------------------------------------------------------ formatters
class Formatter:
    """Renders one output diff row into a sink payload."""

    def __init__(self, columns: list[str]):
        self.columns = columns

    def format(self, key: int, row: tuple, time: int, diff: int) -> bytes:
        raise NotImplementedError


def _plain(v: Any) -> Any:
    import numpy as np

    from pathway_tpu_torch.internals.json import Json

    if isinstance(v, Json):
        return v.value
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, tuple):
        return [_plain(x) for x in v]
    if isinstance(v, bytes):
        return v.decode(errors="replace")
    return v


class JsonLinesFormatter(Formatter):
    def format(self, key: int, row: tuple, time: int, diff: int) -> bytes:
        rec = {c: _plain(v) for c, v in zip(self.columns, row)}
        rec["time"] = time
        rec["diff"] = diff
        return _json.dumps(rec).encode()


class DsvFormatter(Formatter):
    def __init__(self, columns: list[str], delimiter: str = ","):
        super().__init__(columns)
        self.delimiter = delimiter

    def format(self, key: int, row: tuple, time: int, diff: int) -> bytes:
        buf = _io.StringIO()
        w = _csv.writer(buf, delimiter=self.delimiter)
        w.writerow([_plain(v) for v in row] + [time, diff])
        return buf.getvalue().rstrip("\r\n").encode()


class SingleColumnFormatter(Formatter):
    """Emits exactly one column's value as the payload."""

    def __init__(self, columns: list[str], column: str):
        super().__init__(columns)
        self.index = columns.index(column)

    def format(self, key: int, row: tuple, time: int, diff: int) -> bytes:
        v = row[self.index]
        if isinstance(v, bytes):
            return v
        return str(_plain(v)).encode()


class NullFormatter(Formatter):
    def format(self, key: int, row: tuple, time: int, diff: int) -> bytes:
        return b""


# ------------------------------------------------------------------------- registry
def parser_for(
    format: str,  # noqa: A002
    schema: schema_mod.SchemaMetaclass,
    **kwargs: Any,
) -> Parser:
    if format in ("csv", "dsv"):
        return DsvParser(schema, delimiter=kwargs.get("delimiter", ","))
    if format in ("json", "jsonlines"):
        return JsonLinesParser(schema)
    if format in ("plaintext", "raw", "binary", "identity"):
        return IdentityParser(schema)
    if format == "debezium":
        return DebeziumMessageParser(schema)
    raise ValueError(f"unknown input format {format!r}")


def formatter_for(format: str, columns: list[str], **kwargs: Any) -> Formatter:  # noqa: A002
    if format in ("csv", "dsv"):
        return DsvFormatter(columns, delimiter=kwargs.get("delimiter", ","))
    if format in ("json", "jsonlines"):
        return JsonLinesFormatter(columns)
    if format in ("plaintext", "raw", "single_column"):
        return SingleColumnFormatter(columns, kwargs.get("column", columns[0]))
    if format == "null":
        return NullFormatter(columns)
    raise ValueError(f"unknown output format {format!r}")
