"""Run a reference test module's own tests through both packages.

The reference's tests of the engine's core Table API (``tests/test_table_ops.py``
and the nine files beside it) each compare one package with fixed
expectations. Their mirrors (``tests/test_torch_<name>.py``) hold the port
to the reference itself: every test function of the reference file is a
named case, and a case runs the reference test's body twice in this
process, unedited, first as written (``import pathway_tpu as pw``), then
with ``pathway_tpu`` read as ``pathway_tpu_torch`` (its helpers from
``tests/utils.py`` read the same way). The port's run therefore meets the
reference test's own assertions. While each body runs, a recorder keeps
what the package produced:

- the update stream ``(time, key, diff, values)`` of every table captured
  (``CaptureNode``: ``rows_of``, ``deltas_of``, ``compute_and_print``,
  ``table_to_pandas`` ...), keys included, consolidated per tick (the net
  diff of each (time, key, values));
- every ``pw.io.subscribe`` callback ``(key, values, time, is_addition)``;
- the exception type of every ``pw.run`` that raised, and the error log's
  entries ``(operator, message)`` at the end of the body;
- the operands of every comparison the body asserts (``assert a == b``,
  rewritten to record ``a`` and ``b`` and compare them as written);
- the results of the module-level functions a file names as probes (the
  dtype lattice, key hashing, column storage: tests that build no table).

The two recordings must be equal. Values compare as both packages' values
do (numpy scalars as Python scalars, the error value by name, pointers and
Json by content). Cases whose rows land in wall-clock ticks (a live
``pw.io.python`` subject, a REST round trip, an async UDF) compare the
final rows by key instead of the ticks. Both parse graphs are cleared
before each run, and ``PATHWAY_ENGINE_JAX=cpu`` keeps a large block's fused
device tier on the host (the port's device tier is the card).
"""

from __future__ import annotations

import ast
import functools
import importlib
import itertools
import operator
import re
import sys
import types
from collections import Counter
from pathlib import Path
from typing import Any, Callable

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch

TESTS = Path(__file__).resolve().parent
PACKAGES = ("pathway_tpu", "pathway_tpu_torch")
#: the name each package's copy of ``tests/utils.py`` is imported under
_UTILS = {"pathway_tpu": "_torch_mirror_ref_utils", "pathway_tpu_torch": "_torch_mirror_port_utils"}


def _source(src: str, package: str) -> str:
    """``src`` bound to ``package``: ``pathway_tpu`` read as the package,
    and ``tests/utils.py`` imported as that package's recorded copy."""
    if package == "pathway_tpu_torch":
        src = re.sub(r"\bpathway_tpu\b", "pathway_tpu_torch", src)
    utils = _UTILS[package]
    src = re.sub(r"""(["'])tests\.utils\1""", f'"{utils}"', src)
    return re.sub(r"^(\s*)from (tests\.)?utils import", rf"\1from {utils} import", src, flags=re.M)


class _RecordAsserts(ast.NodeTransformer):
    """``assert a == b`` (any comparison chain) becomes ``assert
    __mirror_cmp__([a, b], ["Eq"]), <message>``: the same comparison on the
    same operands, each operand recorded, so that what a test compares is
    compared between the packages too."""

    def visit_Assert(self, node: ast.Assert) -> ast.Assert:
        self.generic_visit(node)
        if isinstance(node.test, ast.Compare):
            operands = ast.List(elts=[node.test.left, *node.test.comparators], ctx=ast.Load())
            ops = ast.List(elts=[ast.Constant(type(o).__name__) for o in node.test.ops], ctx=ast.Load())
            node.test = ast.Call(func=ast.Name("__mirror_cmp__", ast.Load()), args=[operands, ops], keywords=[])
            if node.msg is None:
                node.msg = ast.Call(func=ast.Name("__mirror_last__", ast.Load()), args=[], keywords=[])
        return node


_OPS = {
    "Eq": operator.eq, "NotEq": operator.ne, "Lt": operator.lt, "LtE": operator.le, "Gt": operator.gt,
    "GtE": operator.ge, "Is": operator.is_, "IsNot": operator.is_not,
    "In": lambda a, b: a in b, "NotIn": lambda a, b: a not in b,
}
#: the asserted comparisons of the run in progress: (ops, normalised operands)
_asserted: list = []


def _mirror_cmp(operands: list, ops: list) -> bool:
    _asserted.append((tuple(ops), [norm(x) for x in operands]))
    return all(_OPS[op](operands[i], operands[i + 1]) for i, op in enumerate(ops))


def _mirror_last() -> str:
    ops, operands = _asserted[-1]
    return f"{ops}: {operands!r}"[:2000]


def _exec(name: str, path: Path, src: str) -> types.ModuleType:
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    mod.__mirror_cmp__, mod.__mirror_last__ = _mirror_cmp, _mirror_last
    tree = ast.fix_missing_locations(_RecordAsserts().visit(ast.parse(src, str(path))))
    # the module's own file name in every frame: provenance notes name it
    exec(compile(tree, str(path), "exec"), mod.__dict__)
    return mod


@functools.cache
def module(ref: str, package: str) -> types.ModuleType:
    """The reference test module ``tests/<ref>.py`` bound to ``package``."""
    path = TESTS / f"{ref}.py"
    _utils(package)
    return _exec(f"_torch_mirror_{package}_{ref}", path, _source(path.read_text(), package))


def _utils(package: str) -> None:
    """Import ``tests/utils.py`` for ``package`` under its mirror name."""
    name = _UTILS[package]
    if name not in sys.modules:
        utils = TESTS / "utils.py"
        sys.modules[name] = _exec(name, utils, _source(utils.read_text(), package))


def _param_sets(fn: Callable) -> list[tuple[str, dict]]:
    """(id, kwargs) of every case pytest's ``parametrize`` marks give ``fn``,
    ids as pytest writes them (values joined by ``-``, nearest mark first)."""
    marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
    if not marks:
        return [(fn.__name__, {})]
    axes = []
    for m in marks:
        names = [n.strip() for n in m.args[0].split(",")] if isinstance(m.args[0], str) else list(m.args[0])
        axes.append([(names, v if len(names) > 1 else (v,)) for v in m.args[1]])
    out = []
    for combo in itertools.product(*axes):
        kwargs, ids = {}, []
        for names, vals in combo:
            kwargs.update(zip(names, vals))
            ids.extend(str(v) for v in vals)
        out.append((f"{fn.__name__}[{'-'.join(ids)}]", kwargs))
    return out


def cases(ref: str) -> list[str]:
    """Every case of the reference file, by id: one per test function, and
    one per parameter set of a parametrised one."""
    mod = module(ref, "pathway_tpu")
    fns = [v for k, v in vars(mod).items() if k.startswith("test_") and callable(v)]
    return [cid for fn in fns for cid, _kw in _param_sets(fn)]


def reference_tests(ref: str) -> list[str]:
    mod = module(ref, "pathway_tpu")
    return [k for k, v in vars(mod).items() if k.startswith("test_") and callable(v)]


def _resolve(mod: types.ModuleType, case: str) -> tuple[Callable, dict]:
    fn = getattr(mod, case.split("[", 1)[0])
    return fn, dict(_param_sets(fn))[case]


# ------------------------------------------------------------------ recording


def norm(v: Any) -> Any:
    """A value as both packages' values compare."""
    t = type(v)
    if t.__name__ == "_Error":
        return "ERROR"
    if t.__name__ == "Json" and hasattr(v, "value"):
        return ("Json", norm(v.value))
    if t.__name__ == "Pointer" and not isinstance(v, type):
        return ("Pointer", str(v))
    if isinstance(v, (np.datetime64, np.timedelta64)):
        return ("dt", str(v))
    if isinstance(v, np.generic):
        return norm(v.item())
    if isinstance(v, float) and v != v:
        return ("nan",)
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.shape, tuple(norm(x) for x in v.ravel().tolist()))
    if isinstance(v, type) or callable(v) and hasattr(v, "__qualname__") and not hasattr(v, "__self__"):
        return ("named", getattr(v, "__qualname__", repr(v)))
    if isinstance(v, dict):
        return tuple(sorted(((repr(norm(k)), norm(x)) for k, x in v.items()), key=repr))
    if isinstance(v, (set, frozenset)):
        return ("set", tuple(sorted((norm(x) for x in v), key=repr)))
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, tuple(norm(x) for x in v))
    if t.__module__.split(".")[0] in PACKAGES:
        return (t.__name__, str(v))
    return v


def _sort_key(x: Any) -> str:
    return repr(x)


class Recorder:
    """What one package produced while a test body ran."""

    def __init__(self, package: str, probes: dict[str, Callable] | None = None,
                 test_module: types.ModuleType | None = None):
        self.package = package
        self.test_module = test_module
        self.pw = importlib.import_module(package)
        self.captures: list = []
        self.subscribers: list[list] = []
        self.raised: list[str] = []
        self.probed: list = []
        self.probes = probes or {}

    def install(self, monkeypatch) -> None:
        """Patch the package's capture node, ``pw.io.subscribe``, ``pw.run``
        and the probes to record into this recorder (undone with
        ``monkeypatch``)."""
        ops = importlib.import_module(f"{self.package}.engine.operators")
        init = ops.CaptureNode.__init__
        captures = self.captures

        def capture_init(node, *a, **kw):
            init(node, *a, **kw)
            captures.append(node)

        io = self.pw.io
        subscribe = io.subscribe
        subscribers = self.subscribers

        def recorded_subscribe(table, on_change=None, *a, **kw):
            events: list = []
            subscribers.append(events)
            user = on_change

            def on_change_recorded(*ca, **ckw):
                named = dict(zip(("key", "row", "time", "is_addition"), ca), **ckw)
                events.append((int(named["key"]), norm(named["row"]), named["time"], named["is_addition"]))
                return user(*ca, **ckw)

            return subscribe(table, on_change_recorded if user is not None else None, *a, **kw)

        run = self.pw.run
        raised = self.raised

        def recorded_run(*a, **kw):
            try:
                return run(*a, **kw)
            except BaseException as e:
                raised.append(type(e).__name__)
                raise

        monkeypatch.setattr(ops.CaptureNode, "__init__", capture_init)
        monkeypatch.setattr(io, "subscribe", recorded_subscribe)
        monkeypatch.setattr(self.pw, "run", recorded_run)
        for path, normalize in self.probes.items():
            owner, attr = path.rsplit(".", 1)
            target = importlib.import_module(f"{self.package}.{owner}")
            fn = getattr(target, attr)
            probe = self._probe(path, fn, normalize)
            monkeypatch.setattr(target, attr, probe)
            # a name the test module imported with ``from ... import``
            for name, value in vars(self.test_module or types.ModuleType("_")).items():
                if value is fn:
                    monkeypatch.setattr(self.test_module, name, probe)

    def _probe(self, path: str, fn: Callable, normalize: Callable) -> Callable:
        probed = self.probed
        body = getattr(self.test_module, "__file__", None)

        @functools.wraps(fn)
        def probe(*a, **kw):
            out = fn(*a, **kw)
            # calls the test body makes (not the package's own calls inside)
            if sys._getframe(1).f_code.co_filename == body:
                probed.append((path, normalize(out)))
            return out

        return probe

    def streams(self) -> list:
        """Each capture's update stream, consolidated: the net diff per
        (time, key, values), zeros dropped, in a fixed order. On several
        worker threads both packages may emit a row's retraction and its
        re-insertion in one tick, or not, run to run; consolidated, the
        streams are equal tick by tick."""
        out = []
        for node in self.captures:
            net: Counter = Counter()
            rows = {}
            for (t, k, d, row) in node.deltas:
                entry = (t, int(k), _sort_key(norm(tuple(row))))
                net[entry] += d
                rows[entry] = norm(tuple(row))
            out.append(sorted(((t, k, n, rows[(t, k, r)]) for (t, k, r), n in net.items() if n), key=_sort_key))
        return out

    def error_log(self) -> list:
        entries = importlib.import_module(f"{self.package}.internals.error_log")._entries
        return [(str(op), str(msg)) for (op, msg, _t) in entries]


def _final(stream: list) -> dict:
    """Net rows by key of an update stream."""
    net: Counter = Counter()
    for t, k, d, row in stream:
        net[(k, _sort_key(row))] += d
    return {key: n for key, n in net.items() if n}


def _final_events(events: list) -> dict:
    net: Counter = Counter()
    for k, row, _t, add in events:
        net[(k, _sort_key(row))] += 1 if add else -1
    return {key: n for key, n in net.items() if n}


def run_case(ref: str, case: str, monkeypatch, tmp_path, *, final_only: bool = False,
             probes: dict[str, Callable] | None = None, rewrite: Callable[[str], str] | None = None) -> dict:
    """Run ``case`` of ``tests/<ref>.py`` through the reference and the port
    and compare what each produced; returns both recordings. The body's own
    assertions run on each package's output (an assertion error fails the
    case). ``final_only``: compare final rows by key, not ticks."""
    monkeypatch.setenv("PATHWAY_ENGINE_JAX", "cpu")
    got = {}
    for package in PACKAGES:
        mod = module(ref, package) if rewrite is None else _rewritten(ref, package, rewrite)
        fn, kwargs = _resolve(mod, case)
        rec = Recorder(package, probes, mod)
        for pkg in PACKAGES:
            importlib.import_module(pkg).G.clear()
        params = fn.__code__.co_varnames[: fn.__code__.co_argcount]
        if "monkeypatch" in params:
            kwargs["monkeypatch"] = monkeypatch
        if "tmp_path" in params:
            (tmp_path / package).mkdir(exist_ok=True)
            kwargs["tmp_path"] = tmp_path / package
        _asserted.clear()
        with pytest.MonkeyPatch.context() as scoped:
            rec.install(scoped)
            fn(**kwargs)
            errors = rec.error_log()
        asserted = list(_asserted)
        streams = rec.streams()
        got[package] = {
            "streams": [_final(s) for s in streams] if final_only else streams,
            "subscribers": [_final_events(e) for e in rec.subscribers] if final_only else
            [sorted(e, key=_sort_key) for e in rec.subscribers],
            "raised": rec.raised,
            "error_log": errors,
            "probed": rec.probed,
            "asserted": asserted,
        }
        for pkg in PACKAGES:
            importlib.import_module(pkg).G.clear()
    want, port = got["pathway_tpu"], got["pathway_tpu_torch"]
    for what in ("raised", "error_log", "probed", "asserted", "subscribers", "streams"):
        assert port[what] == want[what], (
            f"{case}: the port's {what} differ from the reference's: {_first_difference(port[what], want[what])}"
        )
    return got


def _first_difference(got: list, want: list) -> str:
    if len(got) != len(want):
        return f"{len(got)} recorded against {len(want)}"
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            if isinstance(a, (list, dict)) and isinstance(b, (list, dict)):
                extra = [x for x in a if x not in b][:3]
                missing = [x for x in b if x not in a][:3]
                return f"item {i}: the port's extra {extra}, missing {missing}"
            return f"item {i}: {a!r} against {b!r}"
    return "equal"



def _rewritten(ref: str, package: str, rewrite: Callable[[str], str]) -> types.ModuleType:
    """The module with ``rewrite`` applied to its source (a fixed port made
    free, say), bound to ``package``."""
    path = TESTS / f"{ref}.py"
    _utils(package)
    return _exec(f"_torch_mirror_{package}_{ref}_rw", path, _source(rewrite(path.read_text()), package))
