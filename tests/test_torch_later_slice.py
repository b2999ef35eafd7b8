"""The port's later-slice guard: the temporal and stateful Table methods and
``pw.iterate`` / ``pw.iterate_universe`` are ported, the planes still to port
raise ``NotImplementedError("later slice:
...")`` where a call reaches them, and importing the temporal stdlib loads
no JAX."""

from __future__ import annotations

import pytest

import pathway_tpu_torch as pw
from test_torch_import import _run

_MD = """
    t | v | g
    1 | 10 | a
    2 | 30 | b
    4 | 20 | a
"""


def _table():
    return pw.debug.table_from_markdown(_MD)


def _thresholds():
    return pw.debug.table_from_rows(
        pw.schema_from_types(lower=float, value=float, upper=float), [(0.0, 1.0, 2.0)]
    )


#: method -> a call of it; each builds its node without raising
PORTED = {
    "deduplicate": lambda t: t.deduplicate(value=t.v, acceptor=lambda new, old: new > old),
    "asof_join": lambda t: t.asof_join(_table(), t.t, pw.this.t),
    "asof_now_join": lambda t: t.asof_now_join(_table(), t.g == pw.right.g),
    "sort": lambda t: t.sort(t.t),
    "interpolate": lambda t: t.interpolate(t.t, t.v),
    "_gradual_broadcast": lambda t: t._gradual_broadcast(
        (th := _thresholds()), th.lower, th.value, th.upper
    ),
    "diff": lambda t: t.diff(t.t, t.v),
    "windowby": lambda t: t.windowby(t.t, window=pw.temporal.tumbling(duration=2)).reduce(
        n=pw.reducers.count()
    ),
    "interval_join": lambda t: t.interval_join(
        (o := _table()), t.t, o.t, pw.temporal.interval(-1, 1)
    ),
    "_buffer": lambda t: t._buffer(t.t + 1, t.t),
    "_forget": lambda t: t._forget(t.t + 1, t.t),
    "_freeze": lambda t: t._freeze(t.t + 1, t.t),
    "_forget_immediately": lambda t: t._forget_immediately(),
}


@pytest.mark.parametrize("method", sorted(PORTED))
def test_ported_table_method_no_longer_raises_later_slice(method):
    pw.G.clear()
    t = _table()
    try:
        out = PORTED[method](t)
    except NotImplementedError as e:  # pragma: no cover - the failure reported
        pytest.fail(f"Table.{method} raised {e!r}")
    # the result runs: its rows (or, for a join, its selected rows) compute
    table = out.select(pw.left.t) if hasattr(out, "_materialize") else out
    pw.debug.table_to_dicts(table)
    pw.G.clear()


#: a package-level entry a later slice ported -> a call of it that runs
PORTED_SURFACE = {
    "iterate": lambda: pw.iterate(lambda t: t.with_columns(v=t.v // 2), iteration_limit=2, t=_table()),
    "iterate_universe": lambda: pw.iterate(
        lambda t: t.filter(t.v > 15), t=pw.iterate_universe(_table())
    ),
}


@pytest.mark.parametrize("entry", sorted(PORTED_SURFACE))
def test_ported_surface_entry_runs(entry):
    pw.G.clear()
    try:
        out = PORTED_SURFACE[entry]()
    except NotImplementedError as e:  # pragma: no cover - the failure reported
        pytest.fail(f"pw.{entry} raised {e!r}")
    values = sorted(pw.debug.table_to_pandas(out)["v"].tolist())
    assert values == {"iterate": [2, 5, 7], "iterate_universe": [20, 30]}[entry]
    pw.G.clear()


#: still-cut entry -> a call that reaches it, and the plane it names
CUT = {
    "sql": (lambda: pw.sql("SELECT v FROM t", t=_table()), "sql"),
    "load_yaml": (lambda: pw.load_yaml("a: 1"), "yaml_loader"),
    "ClassArg": (lambda: type("Row", (pw.ClassArg,), {}), "row_transformer"),
    "transformer": (lambda: pw.transformer(object), "row_transformer"),
    "import_table": (lambda: pw.import_table(None), "exported"),
    "export_table": (lambda: pw.export_table(_table()), "exported"),
    "universes": (lambda: pw.universes.promise_is_subset_of(_table(), _table()), "universes"),
    "live": (lambda: pw.live(_table()), "interactive"),
}


@pytest.mark.parametrize("entry", sorted(CUT))
def test_still_cut_entry_raises_later_slice(entry):
    call, plane = CUT[entry]
    with pytest.raises(NotImplementedError, match=f"later slice: {plane}"):
        call()
    pw.G.clear()


def test_temporal_stdlib_imports_without_jax():
    proc = _run(
        "import sys\n"
        "import pathway_tpu_torch\n"
        "import pathway_tpu_torch.stdlib.temporal\n"
        "import pathway_tpu_torch.stdlib.utils.async_transformer\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pathway_tpu' or m.startswith('pathway_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_surface_names_match_the_reference_exports():
    """The names the reference exports for this slice are on the port's
    package (``pathway_tpu/__init__.py``'s temporal/stateful/utils imports)."""
    for name in ("temporal", "stateful", "statistical", "utils", "AsyncTransformer", "pandas_transformer"):
        assert hasattr(pw, name), name
        assert name in pw.__all__, name
    assert {"ordered", "temporal", "stateful", "statistical", "utils"} <= set(pw.stdlib.__all__)
    assert callable(pw.temporal.windowby_impl) and callable(pw.stateful.deduplicate)
