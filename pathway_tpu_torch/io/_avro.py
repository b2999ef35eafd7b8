"""Minimal pure-Python Avro Object Container File codec.

Backs the Iceberg connector (``io/iceberg.py``): Iceberg manifests and
manifest lists are Avro files (reference ``IcebergBatchWriter`` writes them
through iceberg-rust, ``src/connectors/data_lake/iceberg.rs``; the port
needs no Avro library). Implements the container spec
(magic ``Obj\\x01``, metadata map with schema JSON + null codec, sync-marker
delimited blocks) and the binary encoding for the types Iceberg metadata
needs: null, boolean, int/long (zigzag varint), float, double, string, bytes,
fixed, records, arrays, maps, and ``[null, X]`` unions.
"""

from __future__ import annotations

import io
import json
import os
import struct
from typing import Any

_MAGIC = b"Obj\x01"


# ----------------------------------------------------------------- encoding
def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _write_long(buf: io.BytesIO, n: int) -> None:
    n = _zigzag(n) & 0xFFFFFFFFFFFFFFFF
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.write(bytes([b | 0x80]))
        else:
            buf.write(bytes([b]))
            return


def _read_long(buf) -> int:
    shift = 0
    acc = 0
    while True:
        (b,) = buf.read(1)
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            return _unzigzag(acc)
        shift += 7


def _write_bytes(buf: io.BytesIO, b: bytes) -> None:
    _write_long(buf, len(b))
    buf.write(b)


def _read_bytes(buf) -> bytes:
    return buf.read(_read_long(buf))


def _branch_for(value: Any, branches: list) -> int:
    """Union branch index for a value (null vs the single non-null branch —
    the only union shape Iceberg metadata uses)."""
    for i, b in enumerate(branches):
        if value is None and b == "null":
            return i
        if value is not None and b != "null":
            return i
    raise ValueError(f"no union branch for {value!r} in {branches}")


def write_datum(buf: io.BytesIO, schema: Any, value: Any) -> None:
    if isinstance(schema, list):  # union
        i = _branch_for(value, schema)
        _write_long(buf, i)
        return write_datum(buf, schema[i], value)
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            for f in schema["fields"]:
                write_datum(
                    buf, f["type"], value.get(f["name"]) if value else None
                )
            return
        if t == "array":
            items = value or []
            if items:
                _write_long(buf, len(items))
                for it in items:
                    write_datum(buf, schema["items"], it)
            _write_long(buf, 0)
            return
        if t == "map":
            entries = value or {}
            if entries:
                _write_long(buf, len(entries))
                for k, v in entries.items():
                    _write_bytes(buf, str(k).encode())
                    write_datum(buf, schema["values"], v)
            _write_long(buf, 0)
            return
        if t == "fixed":
            assert len(value) == schema["size"]
            buf.write(value)
            return
        return write_datum(buf, t, value)  # {"type": "string"} primitive form
    if schema == "null":
        return
    if schema == "boolean":
        buf.write(b"\x01" if value else b"\x00")
        return
    if schema in ("int", "long"):
        _write_long(buf, int(value))
        return
    if schema == "float":
        buf.write(struct.pack("<f", float(value)))
        return
    if schema == "double":
        buf.write(struct.pack("<d", float(value)))
        return
    if schema == "string":
        _write_bytes(buf, str(value).encode())
        return
    if schema == "bytes":
        _write_bytes(buf, bytes(value))
        return
    raise ValueError(f"unsupported avro type {schema!r}")


def read_datum(buf, schema: Any) -> Any:
    if isinstance(schema, list):
        return read_datum(buf, schema[_read_long(buf)])
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            return {f["name"]: read_datum(buf, f["type"]) for f in schema["fields"]}
        if t == "array":
            out = []
            while True:
                n = _read_long(buf)
                if n == 0:
                    return out
                if n < 0:  # block with byte size prefix
                    _read_long(buf)
                    n = -n
                for _ in range(n):
                    out.append(read_datum(buf, schema["items"]))
        if t == "map":
            out = {}
            while True:
                n = _read_long(buf)
                if n == 0:
                    return out
                if n < 0:
                    _read_long(buf)
                    n = -n
                for _ in range(n):
                    k = _read_bytes(buf).decode()
                    out[k] = read_datum(buf, schema["values"])
        if t == "fixed":
            return buf.read(schema["size"])
        return read_datum(buf, t)
    if schema == "null":
        return None
    if schema == "boolean":
        return buf.read(1) == b"\x01"
    if schema in ("int", "long"):
        return _read_long(buf)
    if schema == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if schema == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if schema == "string":
        return _read_bytes(buf).decode()
    if schema == "bytes":
        return _read_bytes(buf)
    raise ValueError(f"unsupported avro type {schema!r}")


# ---------------------------------------------------------------- container
def write_container(
    path: str, schema: dict, records: list[dict], metadata: dict | None = None
) -> None:
    """One-block Avro Object Container File (null codec)."""
    body = io.BytesIO()
    for rec in records:
        write_datum(body, schema, rec)
    payload = body.getvalue()
    sync = os.urandom(16)
    out = io.BytesIO()
    out.write(_MAGIC)
    meta = {"avro.schema": json.dumps(schema), "avro.codec": "null"}
    for k, v in (metadata or {}).items():
        meta[k] = v
    _write_long(out, len(meta))
    for k, v in meta.items():
        _write_bytes(out, k.encode())
        _write_bytes(out, v.encode() if isinstance(v, str) else v)
    _write_long(out, 0)
    out.write(sync)
    _write_long(out, len(records))
    _write_long(out, len(payload))
    out.write(payload)
    out.write(sync)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(out.getvalue())
    os.replace(tmp, path)


def read_container(path: str) -> tuple[dict, list[dict]]:
    """→ (writer schema, records)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    buf = io.BytesIO(raw)
    assert buf.read(4) == _MAGIC, f"not an avro container: {path}"
    meta: dict[str, bytes] = {}
    while True:
        n = _read_long(buf)
        if n == 0:
            break
        if n < 0:
            _read_long(buf)
            n = -n
        for _ in range(n):
            k = _read_bytes(buf).decode()
            meta[k] = _read_bytes(buf)
    schema = json.loads(meta["avro.schema"])
    codec = meta.get("avro.codec", b"null")
    if codec not in (b"null", "null"):
        raise NotImplementedError(f"avro codec {codec!r} unsupported")
    sync = buf.read(16)
    records: list[dict] = []
    while buf.tell() < len(raw):
        count = _read_long(buf)
        _size = _read_long(buf)
        for _ in range(count):
            records.append(read_datum(buf, schema))
        assert buf.read(16) == sync, f"sync marker mismatch in {path}"
    return schema, records
