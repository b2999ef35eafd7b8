"""The port's SQLite connector and its client-gated connectors
(``pathway_tpu_torch/io``: ``sqlite``, ``_gated``, ``mongodb``,
``elasticsearch``, ``bigquery``, ``nats``, ``gdrive``, ``iceberg``'s REST
catalog) against the JAX package's, mirroring
``tests/test_connectors_extra.py``'s sqlite and gated cases.

A static snapshot's update stream is compared exactly, keys included (the
key salt is ``hash(table_name)``, stable within this process); the
streaming upsert case compares the final state by key and the totals the
subscriber saw. Gated writers raise the reference's error type with the
reference's message on both packages. Importing every new module loads
neither JAX nor the JAX package.
"""

from __future__ import annotations

import sqlite3
import subprocess
import sys
import threading
import time

import pytest

from torch_connector_helpers import both, capture, collect, run_live, same


def _mk_db(path):
    con = sqlite3.connect(path)
    con.execute("CREATE TABLE items (id INTEGER PRIMARY KEY, name TEXT, qty INTEGER)")
    con.executemany("INSERT INTO items VALUES (?, ?, ?)", [(1, "a", 10), (2, "b", 20), (3, "c", 30)])
    con.commit()
    con.close()


def _pk_schema(pw):
    class PkS(pw.Schema):
        id: int = pw.column_definition(primary_key=True)
        name: str
        qty: int

    return PkS


def test_sqlite_static(tmp_path):
    db = str(tmp_path / "t.db")
    _mk_db(db)
    stream = same(lambda pw: capture(pw, pw.io.sqlite.read(db, "items", _pk_schema(pw), mode="static")))
    assert sorted(row for _t, _k, _d, row in stream) == [(1, "a", 10), (2, "b", 20), (3, "c", 30)]


def test_sqlite_streaming_upserts(tmp_path):
    """Each package streams its own copy of the table; one row is updated
    mid-run. The live rows by key (primary-key keys) and the totals the
    subscriber saw end alike: 60, then 75."""

    def scenario(pw, name):
        db = str(tmp_path / f"{name}.db")
        _mk_db(db)
        t = pw.io.sqlite.read(db, "items", _pk_schema(pw), mode="streaming", poll_interval=0.05)
        rows = collect(pw, t, column="")
        g = t.groupby().reduce(total=pw.reducers.sum(t.qty))
        totals = []
        pw.io.subscribe(g, on_change=lambda key, row, time, is_addition: totals.append(row["total"])
                        if is_addition else None)

        def mutate():
            time.sleep(0.4)
            con = sqlite3.connect(db)
            con.execute("UPDATE items SET qty = 25 WHERE id = 1")
            con.commit()
            con.close()

        threading.Thread(target=mutate, daemon=True).start()
        run_live(pw, lambda: totals[-1:] == [75], settle=0.1)
        return rows, totals

    (ref_rows, ref_totals), (port_rows, port_totals) = (
        both(lambda pw: scenario(pw, pw.__name__))
    )
    assert ref_totals[0] == port_totals[0] == 60 and ref_totals[-1] == port_totals[-1] == 75
    assert sorted(port_rows.values(), key=str) == sorted(ref_rows.values(), key=str)
    assert len(port_rows) == 3


def test_sqlite_static_keys_follow_the_table_name(tmp_path):
    """Two tables of one file with the same rows: under a primary key the
    row keys come from the key columns alone (the same in both tables);
    without one they are salted with the table name (other keys). Both
    packages give the same keys."""
    db = str(tmp_path / "t.db")
    _mk_db(db)
    con = sqlite3.connect(db)
    con.execute("CREATE TABLE other AS SELECT * FROM items")
    con.commit()
    con.close()

    def keys(pw):
        out = []
        for schema in (_pk_schema(pw), pw.schema_from_types(id=int, name=str, qty=int)):
            for table in ("items", "other"):
                pw.G.clear()
                got = capture(pw, pw.io.sqlite.read(db, table, schema, mode="static"))
                out.append(sorted(k for _t, k, _d, _r in got))
        return out

    pk_items, pk_other, items, other = same(keys)
    assert pk_items == pk_other
    assert set(items).isdisjoint(other)


def _gated_calls(pw):
    """Each gated entry point, called as a user would without its client
    library: the error's type and message."""
    schema = pw.schema_from_types(v=int)
    t = pw.debug.table_from_rows(schema, [(1,)])
    calls = {
        "iceberg_rest": lambda: pw.io.iceberg.read("https://catalog:8181", ["ns"], "t", schema=schema),
        "mongodb": lambda: pw.io.mongodb.write(t, "mongodb://x:27017", "db", "c"),
        "elasticsearch": lambda: pw.io.elasticsearch.write(t, "http://es:9200", None, "idx"),
        "bigquery": lambda: pw.io.bigquery.write(t, "ds", "tab", "/nonexistent.json"),
        "nats": lambda: pw.io.nats.read("nats://x:4222", "topic", format="plaintext"),
        "gdrive_credentials": lambda: pw.io.gdrive.read("root", service_user_credentials_file="/nonexistent.json"),
        "gdrive_no_client": lambda: pw.io.gdrive.read("root"),
        "postgres": lambda: pw.io.postgres.write(None, {}, "t"),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except Exception as e:  # noqa: BLE001 - the error is what is compared
            out[name] = (type(e).__name__, str(e))
    return out


def test_gated_connectors_raise_clearly():
    got = same(_gated_calls)
    assert got["iceberg_rest"][0] == "NotImplementedError" and "REST catalog" in got["iceberg_rest"][1]
    assert got["postgres"][0] == "NotImplementedError" and "psycopg2" in got["postgres"][1]
    assert got["gdrive_no_client"][0] == "ValueError" and "client=" in got["gdrive_no_client"][1]
    assert "google-api-python-client" in got["gdrive_credentials"][1]
    for name in ("mongodb", "elasticsearch", "bigquery", "nats"):
        assert got[name] is not None, name


def test_gate_helper_matches_the_reference():
    from pathway_tpu.io import _gated as R
    from pathway_tpu_torch.io import _gated as T

    errs = []
    for mod in (R, T):
        with pytest.raises(NotImplementedError) as e:
            mod.gate("thing", "the `thing` client")(1, x=2)
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "pw.io.thing requires the `thing` client" in errs[1]


def test_every_io_module_of_the_reference_is_ported_without_jax():
    import pathway_tpu.io
    import pathway_tpu_torch.io

    assert pathway_tpu_torch.io.__all__ == pathway_tpu.io.__all__
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "import pathway_tpu_torch\n"
         "import pathway_tpu_torch.io\n"
         "from pathway_tpu_torch.io import (_avro, _gated, airbyte, bigquery, deltalake, elasticsearch,\n"
         "    gdrive, iceberg, logstash, mongodb, nats, pubsub, pyfilesystem, slack, sqlite)\n"
         "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
         " or m == 'pathway_tpu' or m.startswith('pathway_tpu.'))\n"
         "print(bad)\n"
         "sys.exit(1 if bad else 0)\n"],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
