"""Minimal metadata-filter evaluator.

The reference filters index candidates with JMESPath boolean queries
(``src/external_integration/mod.rs:373`` via the jmespath crate;
``DocumentStore.merge_filters`` generates expressions like
``contains(path, 'foo')``, ``globmatch('*.md', path)``, combined with ``&&``/``||``).
jmespath isn't available in this image, so this module evaluates the subset those
call sites actually produce: field paths, string/number literals, ``==``/``!=``,
``contains(a, b)``, ``globmatch(pattern, path)``, ``starts_with``/``ends_with``,
parentheses, ``&&``/``||``/``!``.
"""

from __future__ import annotations

import fnmatch
import re
from typing import Any, Callable

_TOKEN = re.compile(
    r"""\s*(?:
        (?P<lpar>\()|(?P<rpar>\))|
        (?P<and>&&)|(?P<or>\|\|)|(?P<not>!(?!=))|
        (?P<eq>==)|(?P<ne>!=)|
        (?P<comma>,)|
        (?P<str>'(?:[^'\\]|\\.)*'|`[^`]*`|"(?:[^"\\]|\\.)*")|
        (?P<num>-?\d+(?:\.\d+)?)|
        (?P<name>[A-Za-z_][A-Za-z0-9_.]*)
    )""",
    re.VERBOSE,
)

_FUNCS: dict[str, Callable[..., Any]] = {
    "contains": lambda a, b: (b in a) if a is not None else False,
    "globmatch": lambda pat, s: fnmatch.fnmatch(str(s or ""), str(pat)),
    "starts_with": lambda a, b: str(a or "").startswith(str(b)),
    "ends_with": lambda a, b: str(a or "").endswith(str(b)),
}


def _tokenize(src: str) -> list[tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN.match(src, pos)
        if m is None:
            if src[pos:].strip() == "":
                break
            raise ValueError(f"bad filter syntax at {src[pos:]!r}")
        pos = m.end()
        for kind, val in m.groupdict().items():
            if val is not None:
                out.append((kind, val))
                break
    return out


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def eat(self, kind=None):
        tok = self.peek()
        if kind is not None and tok[0] != kind:
            raise ValueError(f"expected {kind}, got {tok}")
        self.i += 1
        return tok

    def parse_or(self):
        node = self.parse_and()
        while self.peek()[0] == "or":
            self.eat()
            rhs = self.parse_and()
            node = ("or", node, rhs)
        return node

    def parse_and(self):
        node = self.parse_not()
        while self.peek()[0] == "and":
            self.eat()
            rhs = self.parse_not()
            node = ("and", node, rhs)
        return node

    def parse_not(self):
        if self.peek()[0] == "not":
            self.eat()
            return ("not", self.parse_not())
        return self.parse_cmp()

    def parse_cmp(self):
        node = self.parse_atom()
        if self.peek()[0] in ("eq", "ne"):
            op = self.eat()[0]
            rhs = self.parse_atom()
            node = (op, node, rhs)
        return node

    def parse_atom(self):
        kind, val = self.peek()
        if kind == "lpar":
            self.eat()
            node = self.parse_or()
            self.eat("rpar")
            return node
        if kind == "str":
            self.eat()
            body = val[1:-1]
            if "\\" in body:
                body = re.sub(r"\\(.)", r"\1", body)
            return ("lit", body)
        if kind == "num":
            self.eat()
            return ("lit", float(val) if "." in val else int(val))
        if kind == "name":
            self.eat()
            if self.peek()[0] == "lpar":  # function call
                self.eat()
                args = []
                while self.peek()[0] != "rpar":
                    args.append(self.parse_or())
                    if self.peek()[0] == "comma":
                        self.eat()
                self.eat("rpar")
                return ("call", val, args)
            return ("field", val)
        raise ValueError(f"unexpected token {kind}:{val}")


def _lookup(metadata: Any, path: str) -> Any:
    cur = metadata
    for part in path.split("."):
        if cur is None:
            return None
        if hasattr(cur, "value"):  # pw.Json wrapper
            cur = cur.value
        if isinstance(cur, dict):
            cur = cur.get(part)
        else:
            cur = getattr(cur, part, None)
    if hasattr(cur, "value"):
        cur = cur.value
    return cur


def _eval(node, metadata) -> Any:
    op = node[0]
    if op == "lit":
        return node[1]
    if op == "field":
        return _lookup(metadata, node[1])
    if op == "call":
        fn = _FUNCS.get(node[1])
        if fn is None:
            raise ValueError(f"unsupported filter function {node[1]!r}")
        return fn(*[_eval(a, metadata) for a in node[2]])
    if op == "eq":
        return _eval(node[1], metadata) == _eval(node[2], metadata)
    if op == "ne":
        return _eval(node[1], metadata) != _eval(node[2], metadata)
    if op == "and":
        return bool(_eval(node[1], metadata)) and bool(_eval(node[2], metadata))
    if op == "or":
        return bool(_eval(node[1], metadata)) or bool(_eval(node[2], metadata))
    if op == "not":
        return not bool(_eval(node[1], metadata))
    raise AssertionError(node)


def compile_filter(expression: str | None) -> Callable[[Any], bool]:
    """Compile a filter string to a metadata → bool predicate. None → accept all."""
    if expression is None:
        return lambda _md: True
    ast = _Parser(_tokenize(expression)).parse_or()
    return lambda md: bool(_eval(ast, md))
