"""Universes (row key-sets) and subset reasoning.

Mirrors the role of the reference's ``internals/universe.py`` +
``internals/universe_solver.py``: a ``Universe`` is the identity of a table's key set;
operators derive sub/super/equal universes, and ``promise_*`` calls let users assert
relations the solver can't infer. Powers ``with_universe_of``, same-universe checks in
``update_cells``/zip-like ``select`` across tables, and restrict/intersect typing.
"""

from __future__ import annotations

import itertools

_ids = itertools.count()


class Universe:
    __slots__ = ("id",)

    def __init__(self) -> None:
        self.id = next(_ids)

    def __repr__(self) -> str:
        return f"Universe({self.id})"

    def subset(self) -> "Universe":
        u = Universe()
        solver().register_subset(u, self)
        return u

    def superset(self) -> "Universe":
        u = Universe()
        solver().register_subset(self, u)
        return u


class UniverseSolver:
    """Tracks equality (union-find) and subset (DAG over representatives)."""

    def __init__(self) -> None:
        self._parent: dict[int, int] = {}
        self._subsets: dict[int, set[int]] = {}  # rep -> set of reps it is a subset of

    def _find(self, x: int) -> int:
        p = self._parent.get(x, x)
        if p == x:
            return x
        r = self._find(p)
        self._parent[x] = r
        return r

    def register_equal(self, a: Universe, b: Universe) -> None:
        ra, rb = self._find(a.id), self._find(b.id)
        if ra != rb:
            self._parent[ra] = rb
            self._subsets.setdefault(rb, set()).update(self._subsets.pop(ra, set()))

    def register_subset(self, sub: Universe, sup: Universe) -> None:
        self._subsets.setdefault(self._find(sub.id), set()).add(self._find(sup.id))

    def query_are_equal(self, a: Universe, b: Universe) -> bool:
        return self._find(a.id) == self._find(b.id)

    def query_is_subset(self, sub: Universe, sup: Universe) -> bool:
        start, goal = self._find(sub.id), self._find(sup.id)
        if start == goal:
            return True
        seen: set[int] = set()
        stack = [start]
        while stack:
            cur = stack.pop()
            if cur == goal:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(self._find(s) for s in self._subsets.get(cur, ()))
        return False


_solver = UniverseSolver()


def solver() -> UniverseSolver:
    return _solver


def reset_solver() -> None:
    global _solver
    _solver = UniverseSolver()
