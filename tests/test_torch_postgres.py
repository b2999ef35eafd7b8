"""The Postgres connector on the port: a mirror of the reference's
``tests/test_gated_connectors.py`` Postgres cases with ``pathway_tpu_torch_torch``
in place of ``pathway_tpu_torch``, over the same recording DBAPI connection (no
``psycopg2`` on either machine): the updates-mode writer's statements and
the snapshot writer's upserts and deletes, each held to the reference's
expectations on the same inputs.
"""

from __future__ import annotations

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.parse_graph import G


class FakeCursor:
    def __init__(self, log):
        self.log = log

    def execute(self, stmt, params=None):
        self.log.append((stmt, tuple(params) if params is not None else None))

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class FakeConnection:
    def __init__(self):
        self.executed: list = []
        self.commits = 0

    def cursor(self):
        return FakeCursor(self.executed)

    def commit(self):
        self.commits += 1


def test_postgres_write_updates_mode():
    con = FakeConnection()
    G.clear()
    t = pw.debug.table_from_rows(
        pw.schema_from_types(w=str, n=int), [("a", 1), ("b", 2)]
    )
    pw.io.postgres.write(t, {"connection": con}, "t_out")
    pw.run(monitoring_level="none")
    assert con.commits >= 1
    stmts = [s for s, _ in con.executed]
    assert all("INSERT INTO t_out" in s for s in stmts)
    vals = sorted(p[:2] for _, p in con.executed)
    assert vals == [("a", 1), ("b", 2)]
    # diff column present and positive for inserts
    assert all(p[-1] == 1 for _, p in con.executed)


def test_postgres_write_snapshot_upserts_and_deletes():
    con = FakeConnection()
    G.clear()

    class PkS(pw.Schema):
        w: str = pw.column_definition(primary_key=True)
        n: int

    t = pw.debug.table_from_rows(
        PkS,
        [("a", 1, 0, 1), ("a", 1, 1, -1), ("a", 5, 1, 1), ("b", 2, 1, 1)],
        is_stream=True,
    )
    pw.io.postgres.write_snapshot(t, {"connection": con}, "t_snap", ["w"])
    pw.run(monitoring_level="none")
    text = " ".join(s for s, _ in con.executed).upper()
    assert "T_SNAP" in text
    # snapshot mode must upsert (insert/update) — the final state is (a,5),(b,2)
    last_a = [p for s, p in con.executed if p and p[0] == "a"][-1]
    assert 5 in last_a
