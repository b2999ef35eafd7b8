"""In-process file-backed Postgres stand-in (DBAPI shape) for the driverless
test image.

``psycopg2`` is not available here, but the exactly-once delivery tests need a
sink with REAL transaction semantics that survives SIGKILL: committed state
must be durable across processes, uncommitted state must vanish with the dying
connection. :class:`FakePostgres` provides exactly that — a pickle file updated
tmp+rename+fsync per ``commit()`` (the same atomic-replace discipline as the
persistence backends), with a regex interpreter for the narrow SQL dialect the
``io.postgres`` writers emit:

- ``CREATE TABLE [IF NOT EXISTS] t (col TYPE ..., PRIMARY KEY (a, b))``
- ``INSERT INTO t (cols) VALUES (%s, ...)`` with optional
  ``ON CONFLICT (pk) DO UPDATE SET c = EXCLUDED.c, ...``
- ``DELETE FROM t WHERE a = %s [AND b = %s ...]``
- ``SELECT <1 | * | cols> FROM t [WHERE a = %s ...] [ORDER BY cols]``

Inject it through the settings dict:
``{"connection_factory": FakePostgres(path).connect}``.
"""

from __future__ import annotations

import os
import pickle
import re
import threading


class FakePostgresError(Exception):
    pass


# -- durable state -------------------------------------------------------------
def _load(path: str) -> dict:
    try:
        with open(path, "rb") as fh:
            return pickle.load(fh)
    except (FileNotFoundError, EOFError, pickle.UnpicklingError):
        return {}


def _store(path: str, state: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(state, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


# -- SQL dialect ---------------------------------------------------------------
_CREATE = re.compile(
    r"^\s*CREATE\s+TABLE\s+(?:IF\s+NOT\s+EXISTS\s+)?(\w+)\s*\((.*)\)\s*$",
    re.I | re.S,
)
_INSERT = re.compile(
    r"^\s*INSERT\s+INTO\s+(\w+)\s*\(([^)]*)\)\s*VALUES\s*\(([^)]*)\)"
    r"(?:\s+ON\s+CONFLICT\s*\(([^)]*)\)\s*DO\s+UPDATE\s+SET\s+(.*))?\s*$",
    re.I | re.S,
)
_DELETE = re.compile(r"^\s*DELETE\s+FROM\s+(\w+)\s+WHERE\s+(.*)$", re.I | re.S)
_SELECT = re.compile(
    r"^\s*SELECT\s+(.*?)\s+FROM\s+(\w+)"
    r"(?:\s+WHERE\s+(.+?))?(?:\s+ORDER\s+BY\s+(.+?))?\s*$",
    re.I | re.S,
)
_WHERE_EQ = re.compile(r"(\w+)\s*=\s*%s", re.I)


def _split_top(text: str) -> list[str]:
    """Split on commas outside parentheses (column defs vs composite PK)."""
    out: list[str] = []
    depth = 0
    cur: list[str] = []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    tail = "".join(cur).strip()
    if tail:
        out.append(tail)
    return out


def _parse_create(name: str, body: str) -> tuple:
    cols: list[str] = []
    pk: list[str] = []
    for item in _split_top(body):
        up = item.upper()
        if up.startswith("PRIMARY KEY"):
            inner = item[item.index("(") + 1 : item.rindex(")")]
            pk = [c.strip() for c in inner.split(",") if c.strip()]
            continue
        col = item.split()[0]
        cols.append(col)
        if "PRIMARY KEY" in up:
            pk.append(col)
    return ("create", name, cols, pk)


def _apply(state: dict, op: tuple) -> None:
    kind = op[0]
    if kind == "create":
        _, name, cols, pk = op
        state.setdefault(name, {"cols": cols, "pk": pk, "rows": []})
        return
    name = op[1]
    t = state.get(name)
    if t is None:
        raise FakePostgresError(f'relation "{name}" does not exist')
    if kind == "insert":
        _, _name, cols, values, conflict_pk = op
        row = dict(zip(cols, values))
        if conflict_pk:
            for existing in t["rows"]:
                if all(existing.get(c) == row[c] for c in conflict_pk):
                    existing.update(row)
                    return
            t["rows"].append(row)
            return
        pk = t.get("pk") or []
        if pk and all(c in row for c in pk):
            for existing in t["rows"]:
                if all(existing.get(c) == row.get(c) for c in pk):
                    raise FakePostgresError(
                        f"duplicate key value violates unique constraint "
                        f'on "{name}" ({", ".join(pk)})'
                    )
        t["rows"].append(row)
    elif kind == "delete":
        _, _name, where = op
        t["rows"] = [
            r
            for r in t["rows"]
            if not all(r.get(c) == v for c, v in where)
        ]


# -- DBAPI surface -------------------------------------------------------------
class FakeCursor:
    def __init__(self, con: "FakePostgresConnection"):
        self._con = con
        self._result: list[tuple] = []

    def __enter__(self) -> "FakeCursor":
        return self

    def __exit__(self, *a) -> bool:
        return False

    def execute(self, sql: str, params=()) -> None:
        self._result = self._con._execute(sql, tuple(params or ()))

    def fetchone(self):
        return self._result[0] if self._result else None

    def fetchall(self) -> list[tuple]:
        return list(self._result)

    def close(self) -> None:
        pass


class FakePostgresConnection:
    """One transaction at a time: executes buffer ops, ``commit()`` re-reads
    the base file, applies them, and atomically replaces it — a SIGKILL before
    commit leaves the file untouched (the crash-window contract the delivery
    transport's per-epoch transactions rely on)."""

    def __init__(self, path: str):
        self.path = path
        self._pending: list[tuple] = []
        self._lock = threading.Lock()

    def cursor(self) -> FakeCursor:
        return FakeCursor(self)

    def commit(self) -> None:
        with self._lock:
            if not self._pending:
                return
            state = _load(self.path)
            for op in self._pending:
                _apply(state, op)
            _store(self.path, state)
            self._pending = []

    def rollback(self) -> None:
        with self._lock:
            self._pending = []

    def close(self) -> None:
        self._pending = []

    # -- statement interpreter -------------------------------------------------
    def _execute(self, sql: str, params: tuple) -> list[tuple]:
        m = _CREATE.match(sql)
        if m:
            self._pending.append(_parse_create(m.group(1), m.group(2)))
            return []
        m = _INSERT.match(sql)
        if m:
            name, cols_s, values_s, conflict_s, _set_s = m.groups()
            cols = [c.strip() for c in cols_s.split(",") if c.strip()]
            n_ph = values_s.count("%s")
            if n_ph != len(params) or n_ph != len(cols):
                raise FakePostgresError(
                    f"INSERT INTO {name}: {len(cols)} columns, {n_ph} "
                    f"placeholders, {len(params)} parameters"
                )
            conflict_pk = (
                [c.strip() for c in conflict_s.split(",") if c.strip()]
                if conflict_s
                else None
            )
            self._pending.append(
                ("insert", name, cols, list(params), conflict_pk)
            )
            return []
        m = _DELETE.match(sql)
        if m:
            name, where_s = m.groups()
            where = list(zip(_WHERE_EQ.findall(where_s), params))
            self._pending.append(("delete", name, where))
            return []
        m = _SELECT.match(sql)
        if m:
            return self._select(*m.groups(), params)
        raise FakePostgresError(f"unsupported SQL: {sql!r}")

    def _view(self) -> dict:
        state = _load(self.path)
        for op in self._pending:
            _apply(state, op)
        return state

    def _select(self, cols_expr, name, where_s, order_s, params) -> list[tuple]:
        t = self._view().get(name)
        if t is None:
            raise FakePostgresError(f'relation "{name}" does not exist')
        rows = t["rows"]
        if where_s:
            pairs = list(zip(_WHERE_EQ.findall(where_s), params))
            rows = [r for r in rows if all(r.get(c) == v for c, v in pairs)]
        if order_s:
            keys = [c.strip() for c in order_s.split(",") if c.strip()]
            rows = sorted(rows, key=lambda r: tuple(r.get(c) for c in keys))
        cols_expr = cols_expr.strip()
        if cols_expr == "1":
            return [(1,) for _ in rows]
        if cols_expr == "*":
            cols = t["cols"]
        else:
            cols = [c.strip() for c in cols_expr.split(",") if c.strip()]
        return [tuple(r.get(c) for c in cols) for r in rows]


class FakePostgres:
    """Handle on one database file; every :meth:`connect` call opens an
    independent transaction scope over the same durable state."""

    def __init__(self, path: str):
        self.path = path

    def connect(self) -> FakePostgresConnection:
        return FakePostgresConnection(self.path)

    def dump(self, table: str, order_by: list[str] | None = None) -> list[tuple]:
        """Committed rows of ``table`` as column-ordered tuples (test oracle)."""
        t = _load(self.path).get(table)
        if t is None:
            return []
        rows = t["rows"]
        if order_by:
            rows = sorted(rows, key=lambda r: tuple(r.get(c) for c in order_by))
        return [tuple(r.get(c) for c in t["cols"]) for r in rows]
