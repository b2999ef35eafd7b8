"""``pw.sql`` — SQL → Table API translation.

The reference routes SQL through sqlglot (``internals/sql.py``); sqlglot is not
in this environment, so this module carries its own tokenizer + recursive-
descent parser for the documented subset the reference supports: SELECT
expression lists with aliases and arithmetic/boolean operators, FROM with
INNER/LEFT/RIGHT/FULL JOIN ... ON equality chains, WHERE, GROUP BY + HAVING,
the standard aggregates (COUNT/SUM/MIN/MAX/AVG), UNION [ALL] / INTERSECT, and
WITH common table expressions. Queries lower onto the same Table operators the
reference's translation targets (filter/select/join/groupby/reduce/concat).

Carried from ``pathway_tpu/internals/sql.py`` with imports rewritten.
"""

from __future__ import annotations

import re
from typing import Any

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals.table import Table

# ------------------------------------------------------------------ tokenizer

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d+|\d+)
  | (?P<str>'(?:[^']|'')*')
  | (?P<op><=|>=|<>|!=|=|<|>|\+|-|\*|/|%|\(|\)|,|\.)
  | (?P<name>[A-Za-z_][A-Za-z_0-9]*)
    """,
    re.VERBOSE,
)

_KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "join", "inner",
    "left", "right", "full", "outer", "on", "and", "or", "not", "as",
    "union", "all", "intersect", "with", "null", "true", "false", "is",
    "count", "sum", "min", "max", "avg",
}


class _Tok:
    __slots__ = ("kind", "value")

    def __init__(self, kind: str, value: Any):
        self.kind = kind  # num | str | op | name | kw | end
        self.value = value

    def __repr__(self) -> str:
        return f"{self.kind}:{self.value!r}"


def _tokenize(q: str) -> list[_Tok]:
    out: list[_Tok] = []
    pos = 0
    q = q.strip().rstrip(";")
    while pos < len(q):
        m = _TOKEN_RE.match(q, pos)
        if m is None:
            raise ValueError(f"pw.sql: cannot tokenize at {q[pos:pos + 20]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        if m.lastgroup == "num":
            text = m.group()
            out.append(_Tok("num", float(text) if "." in text else int(text)))
        elif m.lastgroup == "str":
            out.append(_Tok("str", m.group()[1:-1].replace("''", "'")))
        elif m.lastgroup == "op":
            out.append(_Tok("op", m.group()))
        else:
            name = m.group()
            kind = "kw" if name.lower() in _KEYWORDS else "name"
            out.append(_Tok(kind, name.lower() if kind == "kw" else name))
    out.append(_Tok("end", None))
    return out


# ------------------------------------------------------------------ parser


class _Parser:
    def __init__(self, toks: list[_Tok]):
        self.toks = toks
        self.i = 0

    def peek(self) -> _Tok:
        return self.toks[self.i]

    def next(self) -> _Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, value: Any = None) -> _Tok | None:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind: str, value: Any = None) -> _Tok:
        t = self.accept(kind, value)
        if t is None:
            raise ValueError(f"pw.sql: expected {value or kind}, got {self.peek()!r}")
        return t

    # statement := [WITH name AS (select) [, ...]] select_set
    def statement(self) -> dict:
        ctes: list[tuple[str, dict]] = []
        if self.accept("kw", "with"):
            while True:
                name = self.expect("name").value
                self.expect("kw", "as")
                self.expect("op", "(")
                ctes.append((name, self.select_set()))
                self.expect("op", ")")
                if not self.accept("op", ","):
                    break
        node = self.select_set()
        node["ctes"] = ctes
        self.expect("end")
        return node

    # select_set := select { (UNION [ALL] | INTERSECT) select }
    def select_set(self) -> dict:
        node = self.select()
        while True:
            if self.accept("kw", "union"):
                all_ = bool(self.accept("kw", "all"))
                node = {"op": "union", "all": all_, "left": node, "right": self.select()}
            elif self.accept("kw", "intersect"):
                node = {"op": "intersect", "left": node, "right": self.select()}
            else:
                return node

    def select(self) -> dict:
        self.expect("kw", "select")
        items: list[tuple[str | None, dict]] = []
        if self.accept("op", "*"):
            items.append((None, {"k": "star"}))
        else:
            while True:
                e = self.expr()
                alias = None
                if self.accept("kw", "as"):
                    alias = self.expect("name").value
                elif self.peek().kind == "name":
                    alias = self.next().value
                items.append((alias, e))
                if not self.accept("op", ","):
                    break
        self.expect("kw", "from")
        table = self.expect("name").value
        joins: list[dict] = []
        while True:
            how = None
            if self.accept("kw", "join"):
                how = "inner"
            elif self.accept("kw", "inner"):
                self.expect("kw", "join")
                how = "inner"
            elif self.accept("kw", "left"):
                self.accept("kw", "outer")
                self.expect("kw", "join")
                how = "left"
            elif self.accept("kw", "right"):
                self.accept("kw", "outer")
                self.expect("kw", "join")
                how = "right"
            elif self.accept("kw", "full"):
                self.accept("kw", "outer")
                self.expect("kw", "join")
                how = "outer"
            else:
                break
            jt = self.expect("name").value
            self.expect("kw", "on")
            cond = self.expr()
            joins.append({"table": jt, "how": how, "on": cond})
        where = self.expr() if self.accept("kw", "where") else None
        group: list[dict] | None = None
        having = None
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            group = [self.expr()]
            while self.accept("op", ","):
                group.append(self.expr())
            if self.accept("kw", "having"):
                having = self.expr()
        return {
            "op": "select", "items": items, "table": table, "joins": joins,
            "where": where, "group": group, "having": having,
        }

    # expression grammar: or > and > not > comparison > add > mul > unary > atom
    def expr(self) -> dict:
        node = self.and_()
        while self.accept("kw", "or"):
            node = {"k": "bin", "op": "|", "l": node, "r": self.and_()}
        return node

    def and_(self) -> dict:
        node = self.not_()
        while self.accept("kw", "and"):
            node = {"k": "bin", "op": "&", "l": node, "r": self.not_()}
        return node

    def not_(self) -> dict:
        if self.accept("kw", "not"):
            return {"k": "not", "e": self.not_()}
        return self.cmp()

    def cmp(self) -> dict:
        node = self.add()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "<>", "!=", "<", "<=", ">", ">="):
            self.next()
            op = {"=": "==", "<>": "!=", "!=": "!="}.get(t.value, t.value)
            return {"k": "bin", "op": op, "l": node, "r": self.add()}
        if self.accept("kw", "is"):
            neg = bool(self.accept("kw", "not"))
            self.expect("kw", "null")
            return {"k": "isnull", "e": node, "neg": neg}
        return node

    def add(self) -> dict:
        node = self.mul()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                node = {"k": "bin", "op": t.value, "l": node, "r": self.mul()}
            else:
                return node

    def mul(self) -> dict:
        node = self.unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                node = {"k": "bin", "op": t.value, "l": node, "r": self.unary()}
            else:
                return node

    def unary(self) -> dict:
        if self.accept("op", "-"):
            return {"k": "neg", "e": self.unary()}
        return self.atom()

    def atom(self) -> dict:
        t = self.peek()
        if self.accept("op", "("):
            node = self.expr()
            self.expect("op", ")")
            return node
        if t.kind == "num" or t.kind == "str":
            self.next()
            return {"k": "const", "v": t.value}
        if t.kind == "kw" and t.value in ("null", "true", "false"):
            self.next()
            return {"k": "const", "v": {"null": None, "true": True, "false": False}[t.value]}
        if t.kind == "kw" and t.value in ("count", "sum", "min", "max", "avg"):
            self.next()
            self.expect("op", "(")
            if t.value == "count" and self.accept("op", "*"):
                self.expect("op", ")")
                return {"k": "agg", "fn": "count", "arg": None}
            arg = self.expr()
            self.expect("op", ")")
            return {"k": "agg", "fn": t.value, "arg": arg}
        if t.kind == "name":
            self.next()
            if self.accept("op", "."):
                col = self.expect("name").value
                return {"k": "col", "table": t.value, "name": col}
            return {"k": "col", "table": None, "name": t.value}
        raise ValueError(f"pw.sql: unexpected token {t!r}")


# ------------------------------------------------------------------ translate


class _Scope:
    """Column resolution over the current materialization: ``frames`` maps
    table name → {user column → materialized column}, in FROM/JOIN order, so
    same-named columns of joined tables never shadow each other."""

    def __init__(self, table: Table, frames: dict[str, dict[str, str]]):
        self.table = table
        self.frames = frames

    def resolve(self, tname: str | None, col: str):
        if tname is not None:
            if tname not in self.frames:
                raise ValueError(f"pw.sql: unknown table {tname!r}")
            frame = self.frames[tname]
            if col not in frame:
                raise ValueError(f"pw.sql: no column {col!r} in table {tname!r}")
            return self.table[frame[col]]
        for frame in self.frames.values():
            if col in frame:
                return self.table[frame[col]]
        raise ValueError(f"pw.sql: unknown column {col!r}")


def _build_expr(node: dict, scope: _Scope, in_agg: bool = False):
    import operator as op

    k = node["k"]
    if k == "const":
        return expr_mod.wrap(node["v"])
    if k == "col":
        return scope.resolve(node["table"], node["name"])
    if k == "neg":
        return -_build_expr(node["e"], scope, in_agg)
    if k == "not":
        return ~_build_expr(node["e"], scope, in_agg)
    if k == "isnull":
        e = _build_expr(node["e"], scope, in_agg)
        return e.is_not_none() if node["neg"] else e.is_none()
    if k == "bin":
        l = _build_expr(node["l"], scope, in_agg)
        r = _build_expr(node["r"], scope, in_agg)
        return {
            "+": op.add, "-": op.sub, "*": op.mul, "/": op.truediv, "%": op.mod,
            "==": op.eq, "!=": op.ne, "<": op.lt, "<=": op.le, ">": op.gt,
            ">=": op.ge, "&": op.and_, "|": op.or_,
        }[node["op"]](l, r)
    if k == "agg":
        if not in_agg:
            raise ValueError("pw.sql: aggregate used outside an aggregation context")
        arg = None if node["arg"] is None else _build_expr(node["arg"], scope)
        return {
            "count": lambda a: reducers.count(),
            "sum": lambda a: reducers.sum(a),
            "min": lambda a: reducers.min(a),
            "max": lambda a: reducers.max(a),
            "avg": lambda a: reducers.avg(a),
        }[node["fn"]](arg)
    raise ValueError(f"pw.sql: unhandled expression node {k!r}")


def _has_agg(node: dict) -> bool:
    if not isinstance(node, dict) or "k" not in node:
        return False
    if node["k"] == "agg":
        return True
    return any(_has_agg(v) for v in node.values() if isinstance(v, dict))


def _unique_name(base: str, taken: dict) -> str:
    """SQL result columns never silently collide: later duplicates get _1, _2…"""
    if base not in taken:
        return base
    n = 1
    while f"{base}_{n}" in taken:
        n += 1
    return f"{base}_{n}"


def _default_name(node: dict, i: int) -> str:
    if node["k"] == "col":
        return node["name"]
    if node["k"] == "agg":
        return node["fn"]
    return f"_col_{i}"


def _split_eq_conds(node: dict) -> list[dict]:
    """Flatten ON a.x = b.y AND ... into a list of equality nodes."""
    if node["k"] == "bin" and node["op"] == "&":
        return _split_eq_conds(node["l"]) + _split_eq_conds(node["r"])
    return [node]


def _extract_having_aggs(node: dict, found: list[dict]) -> dict:
    """Replace aggregate nodes with references to hidden reduce columns."""
    if node["k"] == "agg":
        name = f"__having_{len(found)}"
        found.append(node)
        return {"k": "col", "table": None, "name": name}
    out = dict(node)
    for key, v in node.items():
        if isinstance(v, dict) and "k" in v:
            out[key] = _extract_having_aggs(v, found)
    return out


def _translate_select(node: dict, env: dict[str, Table]) -> Table:
    base_name = node["table"]
    if base_name not in env:
        raise ValueError(f"pw.sql: unknown table {base_name!r}")
    current: Table = env[base_name]
    # frames: table name -> {user col -> materialized col in `current`}
    frames: dict[str, dict[str, str]] = {
        base_name: {c: c for c in current.column_names()}
    }

    for j in node["joins"]:
        jt_name = j["table"]
        if jt_name not in env:
            raise ValueError(f"pw.sql: unknown table {jt_name!r}")
        jt = env[jt_name]
        jt_frames = {**frames, jt_name: {c: c for c in jt.column_names()}}

        class _JoinScope:
            def resolve(self, tname, col):
                if tname == jt_name:
                    return jt[col]
                if tname is not None:
                    return _Scope(current, frames).resolve(tname, col)
                for frame in frames.values():
                    if col in frame:
                        return current[frame[col]]
                if col in jt.column_names():
                    return jt[col]
                raise ValueError(f"pw.sql: unknown column {col!r}")

        jscope = _JoinScope()
        conds = []
        for c in _split_eq_conds(j["on"]):
            if not (c["k"] == "bin" and c["op"] == "=="):
                raise ValueError("pw.sql: JOIN ON supports equality conditions")
            conds.append(_build_expr(c["l"], jscope) == _build_expr(c["r"], jscope))
        joined = current.join(jt, *conds, how=j["how"])
        # materialize BOTH sides under unique names: same-named columns of
        # different tables must never shadow each other
        cols: dict[str, Any] = {}
        new_frames: dict[str, dict[str, str]] = {}
        for tn, frame in jt_frames.items():
            new_frames[tn] = {}
            src = jt if tn == jt_name else current
            for cn, mat in frame.items():
                uname = f"__{tn}__{cn}"
                cols[uname] = src[mat if tn != jt_name else cn]
                new_frames[tn][cn] = uname
        current = joined.select(**cols)
        frames = new_frames

    scope = _Scope(current, frames)
    if node["where"] is not None:
        current = current.filter(_build_expr(node["where"], scope))
        scope = _Scope(current, frames)

    items = node["items"]
    if node["group"] is not None:
        key_refs = []
        for g in node["group"]:
            if g["k"] != "col":
                raise ValueError("pw.sql: GROUP BY supports plain columns")
            key_refs.append(scope.resolve(g["table"], g["name"]))
        grouped = current.groupby(*[current[r.name] for r in key_refs])
        out: dict[str, Any] = {}
        for i, (alias, e) in enumerate(items):
            if e["k"] == "star":
                raise ValueError("pw.sql: SELECT * with GROUP BY is not supported")
            out[_unique_name(alias or _default_name(e, i), out)] = _build_expr(
                e, scope, in_agg=True
            )
        having = node["having"]
        hidden: list[dict] = []
        if having is not None:
            having = _extract_having_aggs(having, hidden)
            for i, agg_node in enumerate(hidden):
                out[f"__having_{i}"] = _build_expr(agg_node, scope, in_agg=True)
        result = grouped.reduce(**out)
        if having is not None:
            hv_scope = _Scope(result, {"": {c: c for c in result.column_names()}})
            result = result.filter(_build_expr(having, hv_scope))
            if hidden:
                keep = [c for c in result.column_names() if not c.startswith("__having_")]
                result = result.select(**{c: result[c] for c in keep})
        return result

    if any(_has_agg(e) for (_a, e) in items if e["k"] != "star"):
        out = {}
        for i, (alias, e) in enumerate(items):
            out[_unique_name(alias or _default_name(e, i), out)] = _build_expr(
                e, scope, in_agg=True
            )
        return current.reduce(**out)

    if len(items) == 1 and items[0][1]["k"] == "star":
        if not node["joins"]:
            return current
        out = {}
        for tn, frame in frames.items():
            for cn, mat in frame.items():
                out[_unique_name(cn, out)] = current[mat]
        return current.select(**out)
    out = {}
    for i, (alias, e) in enumerate(items):
        if e["k"] == "star":
            for tn, frame in frames.items():
                for cn, mat in frame.items():
                    out[_unique_name(cn, out)] = current[mat]
            continue
        out[_unique_name(alias or _default_name(e, i), out)] = _build_expr(e, scope)
    return current.select(**out)


def _distinct(t: Table) -> Table:
    cols = t.column_names()
    return t.groupby(*[t[c] for c in cols]).reduce(
        **{c: t[c] for c in cols}
    )


def _translate(node: dict, env: dict[str, Table]) -> Table:
    if node["op"] == "select":
        return _translate_select(node, env)
    left = _translate(node["left"], env)
    right = _translate(node["right"], env)
    if node["op"] == "union":
        merged = Table.concat_reindex(left, right)
        return merged if node.get("all") else _distinct(merged)
    if node["op"] == "intersect":
        return _distinct(left).intersect(_distinct(right))
    raise ValueError(f"pw.sql: unhandled set op {node['op']!r}")


def sql(query: str, **tables: Table) -> Table:
    """Translate a SQL query over the given tables (``pw.sql`` surface; see
    the module docstring for the supported subset)."""
    ast = _Parser(_tokenize(query)).statement()
    env = dict(tables)
    for name, cte in ast.get("ctes", []):
        env[name] = _translate(cte, env)
    return _translate(ast, env)
