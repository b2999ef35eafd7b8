"""Legacy ``@pw.transformer`` class syntax (reference:
``internals/row_transformer.py`` + ``graph_runner/row_transformer_operator_
handler.py`` — recursive per-row computers over "complex columns").

Mini-implementation with the same user contract: a transformer class holds
inner ``ClassArg`` classes (one per table); ``input_attribute()`` fields read
the input column of the same name, ``@output_attribute`` methods compute
per-row values that may read other attributes of the same row, other rows via
``self.transformer.<table>[pointer]``, and ``self.id``. Evaluation is
memoized per (table, row, attribute) with cycle detection.

Like the reference's, this API is for small control tables: each tick
re-evaluates over full table snapshots (the hot path belongs to the columnar
relational operators).

Carried from ``pathway_tpu/internals/row_transformer.py`` with imports
rewritten."""

from __future__ import annotations

from typing import Any, Callable

import pathway_tpu_torch as pw


class _InputAttribute:
    pass


def input_attribute(type: Any = None):  # noqa: A002 — reference-parity name
    return _InputAttribute()


class _OutputAttribute:
    def __init__(self, fn: Callable, output: bool = True):
        self.fn = fn
        self.output = output
        self.name = fn.__name__


def output_attribute(fn: Callable) -> _OutputAttribute:
    return _OutputAttribute(fn, output=True)


def attribute(fn: Callable) -> _OutputAttribute:
    """Computed per-row attribute excluded from the output schema."""
    return _OutputAttribute(fn, output=False)


def method(fn: Callable):
    raise NotImplementedError("@pw.method on row transformers is not supported yet")


def input_method(type: Any = None):  # noqa: A002
    raise NotImplementedError("input_method on row transformers is not supported yet")


class ClassArgMeta(type):
    def __new__(mcs, name, bases, ns, output: Any = None, **kwargs):
        cls = super().__new__(mcs, name, bases, ns)
        cls._output_schema = output
        cls._input_attrs = [k for k, v in ns.items() if isinstance(v, _InputAttribute)]
        cls._computed = {
            k: v for k, v in ns.items() if isinstance(v, _OutputAttribute)
        }
        return cls


class ClassArg(metaclass=ClassArgMeta):
    pass


class _RowView:
    __slots__ = ("_rt", "_table", "_key")

    def __init__(self, rt: "_EvalRuntime", table: str, key: int):
        self._rt = rt
        self._table = table
        self._key = key

    @property
    def id(self) -> int:
        return self._key

    @property
    def transformer(self) -> "_TransformerView":
        return _TransformerView(self._rt)

    def pointer_from(self, *args, **kwargs):
        raise NotImplementedError

    def __getattr__(self, name: str):
        return self._rt.eval_attr(self._table, self._key, name)


class _TableView:
    __slots__ = ("_rt", "_table")

    def __init__(self, rt: "_EvalRuntime", table: str):
        self._rt = rt
        self._table = table

    def __getitem__(self, key) -> _RowView:
        return _RowView(self._rt, self._table, int(key))


class _TransformerView:
    __slots__ = ("_rt",)

    def __init__(self, rt: "_EvalRuntime"):
        self._rt = rt

    def __getattr__(self, name: str):
        return _TableView(self._rt, name)


class _EvalRuntime:
    """Memoized recursive attribute evaluation over full-table snapshots."""

    def __init__(self, specs: dict[str, type], snapshots: dict[str, dict[int, dict]]):
        self.specs = specs
        self.snapshots = snapshots
        self.memo: dict[tuple[str, int, str], Any] = {}
        self.in_flight: set[tuple[str, int, str]] = set()

    def eval_attr(self, table: str, key: int, name: str):
        spec = self.specs[table]
        rows = self.snapshots[table]
        if key not in rows:
            raise KeyError(f"transformer: no row {key!r} in table {table!r}")
        if name in spec._input_attrs:
            return rows[key][name]
        computed = spec._computed.get(name)
        if computed is None:
            raise AttributeError(f"transformer table {table!r} has no attribute {name!r}")
        memo_key = (table, key, name)
        if memo_key in self.memo:
            return self.memo[memo_key]
        if memo_key in self.in_flight:
            raise RecursionError(
                f"transformer: cyclic attribute dependency at {table}.{name}"
            )
        self.in_flight.add(memo_key)
        try:
            value = computed.fn(_RowView(self, table, key))
        finally:
            self.in_flight.discard(memo_key)
        self.memo[memo_key] = value
        return value


def transformer(cls: type):
    """Decorator turning a class of inner ``ClassArg`` classes into a callable
    over tables; the result object exposes one output table per inner class."""
    specs: dict[str, type] = {
        k: v
        for k, v in vars(cls).items()
        if isinstance(v, type) and issubclass(v, ClassArg)
    }
    if not specs:
        raise TypeError("@pw.transformer needs at least one inner ClassArg class")
    order = list(specs)

    class _Result:
        def __init__(self, outputs: dict[str, "pw.Table"]):
            for name, table in outputs.items():
                setattr(self, name, table)

    def run(*tables: "pw.Table", **named: "pw.Table") -> _Result:
        if len(tables) > len(order):
            raise TypeError(
                f"transformer takes {len(order)} tables ({order}), got {len(tables)}"
            )
        bound: dict[str, pw.Table] = dict(zip(order, tables))
        dupes = set(bound) & set(named)
        if dupes:
            raise TypeError(f"transformer tables passed twice: {sorted(dupes)}")
        bound.update(named)
        missing = set(order) - set(bound)
        if missing:
            raise TypeError(f"transformer missing tables: {sorted(missing)}")

        # gather every table into ONE snapshot blob (tagged rows concat into a
        # single global reduce, so one empty input can't empty the others)
        col_lists = {name: bound[name].column_names() for name in order}
        tagged = []
        for n_idx, name in enumerate(order):
            t = bound[name]
            cols = col_lists[name]
            tagged.append(
                t.select(
                    p=pw.apply(
                        lambda i, *vs, tag=n_idx: (tag, int(i), vs),
                        t.id,
                        *[t[c] for c in cols],
                    )
                )
            )
        cat = tagged[0] if len(tagged) == 1 else pw.Table.concat_reindex(*tagged)
        combined = cat.reduce(all=pw.reducers.sorted_tuple(cat.p))

        outputs: dict[str, pw.Table] = {}
        for out_name in order:
            spec = specs[out_name]
            out_attrs = [k for k, v in spec._computed.items() if v.output]

            def evaluate(all_rows, out_name=out_name, out_attrs=out_attrs):
                snapshots: dict[str, dict[int, dict]] = {n: {} for n in order}
                for tag, key, vals in all_rows:
                    name = order[tag]
                    snapshots[name][key] = dict(zip(col_lists[name], vals))
                rt = _EvalRuntime(specs, snapshots)
                return tuple(
                    (key,) + tuple(rt.eval_attr(out_name, key, a) for a in out_attrs)
                    for key in snapshots[out_name]
                )

            applied = combined.select(out=pw.apply(evaluate, combined.all))
            flat = applied.flatten(applied.out)
            unpacked = flat.select(
                idd=pw.apply(lambda r: r[0], flat.out),
                **{
                    a: pw.apply(lambda r, j=j: r[1 + j], flat.out)
                    for j, a in enumerate(out_attrs)
                },
            )
            rekeyed = unpacked.with_id(unpacked.idd)
            out = rekeyed.select(**{a: rekeyed[a] for a in out_attrs})
            if spec._output_schema is not None:
                out = out.update_types(**spec._output_schema.typehints())
            outputs[out_name] = out
        return _Result(outputs)

    run.__name__ = cls.__name__
    return run
