"""The port's file connectors (``pathway_tpu_torch/io``: ``_format``, ``fs``,
``csv``, ``jsonlines``, ``plaintext``, ``null``) against the JAX package's.

Parsers and formatters give the reference's values and bytes; every read,
static and in bounded streaming mode (``_bounded=True``: the poller stops
once a scan finds nothing new), gives the reference's update stream, keys
included; every write gives the reference's file bytes. Static row keys are
salted with ``hash(path)``, which changes from process to process but not
within one, so both packages' keys are compared within this process.
"""

from __future__ import annotations

import json

import pytest

import pathway_tpu
import pathway_tpu.io
import pathway_tpu_torch
from pathway_tpu.io import _format as R
from pathway_tpu_torch.io import _format as T
from test_torch_llm_xpack import assert_same_streams, final_rows


def _schema(mod, **types):
    return mod.schema_from_types(**types)


@pytest.fixture
def tree(tmp_path):
    """csv, jsonlines and text files in two directories."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    (tmp_path / "a" / "one.csv").write_text("k,name,score\n1,alpha,1.5\n2,beta,oops\n")
    (tmp_path / "b" / "two.csv").write_text('k,name,score\n3,"gam,ma",-2\n')
    (tmp_path / "a" / "r.jsonl").write_text(
        '{"k": 1, "name": "x", "tags": {"t": [1, 2]}}\n\n{"k": 2, "name": "y", "tags": null}\n'
    )
    (tmp_path / "b" / "notes.txt").write_text("first line\nsecond line\n\nfourth\n")
    return tmp_path


# ------------------------------------------------------------ parsers/formatters
def _events(mod, fmt, schema, value, **kw):
    parser = mod.parser_for(fmt, schema, **kw)
    return [(e.values, e.diff, e.tombstone) for e in parser.parse(mod.RawMessage(value))]


def _plain_events(events):
    return [(tuple(getattr(v, "value", "ERROR" if type(v).__name__ == "_Error" else v) for v in vals), d, t)
            for vals, d, t in events]


@pytest.mark.parametrize(
    "fmt,types,value,kw",
    [
        ("csv", dict(a=int, b=str, c=float), "1,x,2.5\n2,y,bad\n", {}),
        ("dsv", dict(a=int, b=bool), "7;true\n8;0\n", {"delimiter": ";"}),
        ("json", dict(a=int, j=dict), '{"a": 1, "j": {"x": 1}}\nnot json\n{"a": "2"}\n', {}),
        ("plaintext", dict(data=str), b"raw bytes \xff", {}),
        ("binary", dict(data=bytes), "text as bytes", {}),
        ("debezium", dict(id=int, v=str),
         '{"payload": {"op": "u", "before": {"id": 1, "v": "a"}, "after": {"id": 1, "v": "b"}}}', {}),
        ("debezium", dict(id=int, v=str), '{"schema": {}, "payload": {"op": "d", "before": {"id": 2, "v": "z"}}}', {}),
        ("debezium", dict(id=int, v=str), "null", {}),
    ],
)
def test_parsers_match_reference(fmt, types, value, kw):
    got = _plain_events(_events(T, fmt, _schema(pathway_tpu_torch, **types), value, **kw))
    want = _plain_events(_events(R, fmt, _schema(pathway_tpu, **types), value, **kw))
    assert got == want
    assert got or value == "null"  # a tombstone without a key yields nothing


def test_debezium_tombstones_match_reference():
    msg_r = R.RawMessage(None, key='{"payload": {"id": 5}}')
    msg_t = T.RawMessage(None, key='{"payload": {"id": 5}}')
    r = R.DebeziumMessageParser(_schema(pathway_tpu, id=int, v=str), tombstones=True).parse(msg_r)
    t = T.DebeziumMessageParser(_schema(pathway_tpu_torch, id=int, v=str), tombstones=True).parse(msg_t)
    assert [(e.values, e.diff, e.tombstone) for e in t] == [(e.values, e.diff, e.tombstone) for e in r]
    assert t[0].tombstone and t[0].diff == -1


@pytest.mark.parametrize("fmt,kw", [("csv", {}), ("dsv", {"delimiter": "|"}), ("json", {}),
                                    ("plaintext", {"column": "b"}), ("null", {})])
def test_formatters_match_reference(fmt, kw):
    import numpy as np

    cols = ["a", "b", "c"]
    rows = [
        (1, "x,y", pathway_tpu.Json({"k": [1, 2]})),
        (np.int64(2), b"raw", (1, 2)),
        (3.5, None, True),
    ]
    rows_t = [tuple(pathway_tpu_torch.Json(v.value) if isinstance(v, pathway_tpu.Json) else v for v in r) for r in rows]
    rf, tf = R.formatter_for(fmt, cols, **kw), T.formatter_for(fmt, cols, **kw)
    for r, t in zip(rows, rows_t):
        assert tf.format(7, t, 4, -1) == rf.format(7, r, 4, -1)


@pytest.mark.parametrize("fmt", ["binary", "plaintext_by_file", "plaintext", "csv", "json"])
def test_rows_from_bytes_matches_reference(fmt):
    data = b'{"a": 1, "b": {"x": 2}}\n{"a": 3}\n' if fmt == "json" else b"a,b\n1,2\n3,\n"
    types = dict(a=int, b=dict) if fmt == "json" else dict(a=int, b=str)
    if fmt in ("binary", "plaintext_by_file", "plaintext"):
        types = dict(data=bytes if fmt == "binary" else str)
    got = T.rows_from_bytes(data, fmt, _schema(pathway_tpu_torch, **types))
    want = R.rows_from_bytes(data, fmt, _schema(pathway_tpu, **types))
    norm = lambda rows: [tuple(getattr(v, "value", v) for v in r) for r in rows]  # noqa: E731
    assert norm(got) == norm(want) and got


def test_unknown_formats_raise():
    with pytest.raises(ValueError, match="unknown input format"):
        T.parser_for("xml", _schema(pathway_tpu_torch, a=int))
    with pytest.raises(ValueError, match="unknown output format"):
        T.formatter_for("xml", ["a"])
    with pytest.raises(ValueError, match="unknown format"):
        T.rows_from_bytes(b"", "xml", _schema(pathway_tpu_torch, a=int))


# ------------------------------------------------------------------------ reads
READS = {
    "csv_static": lambda pw, root: pw.io.csv.read(
        str(root / "*" / "*.csv"), schema=pw.schema_from_types(k=int, name=str, score=float), mode="static"
    ),
    "csv_dir_static_metadata": lambda pw, root: pw.io.fs.read(
        str(root / "a"), format="csv", mode="static", with_metadata=True,
        schema=pw.schema_from_types(k=int, name=str, score=float),
    ),
    "csv_primary_key": lambda pw, root: pw.io.csv.read(
        str(root / "*" / "*.csv"), mode="static",
        schema=pw.schema_from_dict({"k": {"dtype": int, "primary_key": True}, "name": str, "score": float})
        if hasattr(pw, "schema_from_dict") else None,
    ),
    "jsonlines_static": lambda pw, root: pw.io.jsonlines.read(
        str(root / "a" / "*.jsonl"), schema=pw.schema_from_types(k=int, name=str, tags=dict), mode="static"
    ),
    "plaintext_static": lambda pw, root: pw.io.plaintext.read(str(root / "b" / "*.txt"), mode="static"),
    "plaintext_by_file": lambda pw, root: pw.io.fs.read(str(root / "b"), format="plaintext_by_file", mode="static"),
    "binary_static": lambda pw, root: pw.io.fs.read(str(root), format="binary", mode="static"),
    "csv_streaming": lambda pw, root: pw.io.csv.read(
        str(root / "*" / "*.csv"), schema=pw.schema_from_types(k=int, name=str, score=float), _bounded=True
    ),
    "plaintext_streaming": lambda pw, root: pw.io.plaintext.read(str(root / "b" / "*.txt"), _bounded=True),
    "binary_streaming_interactive": lambda pw, root: pw.io.fs.read(
        str(root / "a"), format="binary", _bounded=True, service_class="interactive"
    ),
}


@pytest.mark.parametrize("name", sorted(READS))
def test_reads_match_reference(name, tree):
    build = READS[name]
    drop = ("seen_at",) if "metadata" in name else ()
    live = "streaming" in name
    assert_same_streams(lambda pw: build(pw, tree), drop=drop, live=live)
    pathway_tpu_torch.G.clear()
    rows = pathway_tpu_torch.debug._capture(build(pathway_tpu_torch, tree)).rows
    pathway_tpu_torch.G.clear()
    assert rows


def test_static_keys_are_salted_by_path_within_a_process(tree):
    def build(pw):
        S = pw.schema_from_types(data=str)
        return {
            "one": pw.io.fs.read(str(tree / "b"), format="plaintext", schema=S, mode="static"),
            "two": pw.io.fs.read(str(tree / "b" / "notes.txt"), format="plaintext", schema=S, mode="static"),
        }

    out = assert_same_streams(build)
    keys = lambda s: {k for _t, k, _d, _r in s}  # noqa: E731
    assert keys(out["one"]) and not keys(out["one"]) & keys(out["two"])


def test_read_without_schema_needs_a_text_format(tree):
    with pytest.raises(ValueError, match="schema required"):
        pathway_tpu_torch.io.fs.read(str(tree), format="csv", mode="static")


@pytest.mark.parametrize("flow", ["off", "on"])
def test_reader_service_classes_are_served_in_arrival_order(tree, flow, monkeypatch):
    """fs.read's streaming default is the flow plane's ``bulk`` class. With
    the plane off every reader class is served in arrival order; with it on
    (``PATHWAY_FLOW=on``) the gated reads give the reference's rows and
    keys. An unknown class is refused as the reference refuses it."""
    monkeypatch.setenv("PATHWAY_FLOW", flow)
    for sc in ("bulk", "interactive", " BULK "):
        got = {}
        for pw in (pathway_tpu_torch, pathway_tpu):
            pw.G.clear()
            t = pw.io.plaintext.read(str(tree / "b" / "*.txt"), _bounded=True, service_class=sc)
            got[pw] = final_rows([(0, k, d, r) for (_t, k, d, r) in pw.debug._capture(t).deltas])
            pw.G.clear()
        assert got[pathway_tpu_torch] == got[pathway_tpu] and len(got[pathway_tpu_torch]) == 4
    with pytest.raises(ValueError, match="service_class must be one of"):
        pathway_tpu_torch.io.fs.read(str(tree), format="binary", service_class="batch")


# ----------------------------------------------------------------------- writes
def _md(pw):
    return pw.debug.table_from_markdown(
        """
        k | name  | score | __time__ | __diff__
        1 | alpha | 1.5   | 2        | 1
        2 | beta  | 2.0   | 2        | 1
        1 | alpha | 1.5   | 4        | -1
        3 | gam   | -0.5  | 4        | 1
        """
    )


@pytest.mark.parametrize("how", ["csv", "jsonlines", "fs_csv", "fs_json", "fs_csv_sharded", "fs_json_sharded"])
def test_writes_match_reference(how, tmp_path):
    def write(pw, path):
        pw.G.clear()
        t = _md(pw)
        if how == "csv":
            pw.io.csv.write(t, str(path))
        elif how == "jsonlines":
            pw.io.jsonlines.write(t, str(path))
        else:
            fmt = "csv" if "csv" in how else "json"
            pw.io.fs.write(t, str(path), format=fmt, sharded=how.endswith("sharded"))
        pw.run()
        pw.G.clear()
        return path.read_bytes()

    got = write(pathway_tpu_torch, tmp_path / "port.out")
    want = write(pathway_tpu, tmp_path / "ref.out")
    assert got == want and got
    if "json" in how:
        assert [json.loads(line)["diff"] for line in got.decode().splitlines()] == [1, 1, -1, 1]
    assert not list(tmp_path.glob("*.part-*"))


def test_null_sink_runs_the_pipeline(tmp_path):
    seen = []
    for pw in (pathway_tpu_torch, pathway_tpu):
        pw.G.clear()
        t = _md(pw)
        pw.io.null.write(t.select(x=pw.apply(lambda k: seen.append((pw.__name__, k)) or k, t.k)))
        pw.run()
        pw.G.clear()
    port = sorted(k for n, k in seen if n == "pathway_tpu_torch")
    assert port and port == sorted(k for n, k in seen if n == "pathway_tpu")


def test_writer_cut_sites_raise_later_slice(tmp_path, monkeypatch):
    # the flow plane is ported: a bulk-class writer writes the reference's bytes
    written = []
    for side in (pathway_tpu_torch, pathway_tpu):
        side.G.clear()
        side.io.fs.write(_md(side), str(tmp_path / f"{side.__name__}.csv"), service_class="bulk")
        side.run()
        side.G.clear()
        written.append((tmp_path / f"{side.__name__}.csv").read_bytes())
    assert written[0] == written[1] and written[0]
    pw = pathway_tpu_torch
    t = _md(pw)
    with pytest.raises(NotImplementedError, match="later slice: delivery"):
        pw.io.fs.write(t, str(tmp_path / "o.csv"), delivery="exactly_once")
    monkeypatch.setenv("PATHWAY_DELIVERY", "exactly_once")
    with pytest.raises(NotImplementedError, match="later slice: delivery"):
        pw.io.csv.write(t, str(tmp_path / "o.csv"))
    monkeypatch.delenv("PATHWAY_DELIVERY")
    with pytest.raises(ValueError, match="expected 'off' or 'exactly_once'"):
        pw.io.fs.write(t, str(tmp_path / "o.csv"), delivery="twice")
    with pytest.raises(FileNotFoundError, match="output directory does not exist"):
        pw.io.fs.write(t, str(tmp_path / "missing" / "o.csv"))
    with pytest.raises(ValueError, match="unknown format"):
        pw.io.fs.write(t, str(tmp_path / "o.xml"), format="xml")


@pytest.mark.parametrize("elastic", ["off", "manual"])
def test_stale_sharded_parts(elastic, tmp_path, monkeypatch):
    """Part files of a run with more workers: refused with the reference's
    message, or, with the elastic plane asked for, a later slice."""
    pw = pathway_tpu_torch
    monkeypatch.setenv("PATHWAY_ELASTIC", elastic)
    out = tmp_path / "o.csv"
    (tmp_path / "o.csv.part-0003").write_text("stale\n")
    pw.io.fs.write(_md(pw), str(out), sharded=True)
    err = (NotImplementedError, "later slice: elastic") if elastic == "manual" else (RuntimeError, "at least 4 workers")
    with pytest.raises(err[0], match=err[1]):
        pw.run()
