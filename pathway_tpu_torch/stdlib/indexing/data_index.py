"""InnerIndex / DataIndex — search results joined back to payload columns.

API parity with the reference's ``stdlib/indexing/data_index.py:206,278``: an
``InnerIndex`` answers queries with lists of (doc id, score); ``DataIndex`` joins
those ids back to the data table's columns, either collapsed (one row per query,
tuple-valued columns, score-descending order) or flat (one row per match).

The inner index runs as an engine :class:`ExternalIndexNode`; queries through
``query_as_of_now`` are answered against index state at arrival and never revised
(the serving discipline, SURVEY §3.3), while ``query`` keeps answers consistent
under doc updates (one batched re-search per doc tick).

Carried from ``pathway_tpu/stdlib/indexing/data_index.py``, with the fabric
plane's replica capture of as-of-now indexes (``fabric/index_replica.py``).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.internals.logical import LogicalNode
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing._engine import ExternalIndexNode, IndexBackend, MergeIndexRepliesNode

_SCORE = "_pw_index_reply_score"
_INDEX_REPLY = "_pw_index_reply"


class InnerIndex:
    """Engine-backed index over ``data_column`` of ``data_table``."""

    def __init__(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
        backend_factory: Callable[[], IndexBackend] | None = None,
        item_transform: Callable[[Table, Any], ColumnExpression] | None = None,
    ):
        self.data_column = data_column
        self.data_table: Table = data_column.table
        self.metadata_column = metadata_column
        self.backend_factory = backend_factory
        # maps a (table, raw item expr) to what the backend indexes/searches
        # (e.g. embedder application for vector indexes)
        self.item_transform = item_transform or (lambda _table, e: e)

    def _docs_table(self, with_payload: bool = False) -> Table:
        table = self.data_table
        item = self.item_transform(table, self.data_column)
        meta = self.metadata_column if self.metadata_column is not None else None
        cols = {"__item": item}
        cols["__meta"] = meta if meta is not None else 0
        if with_payload:
            # replica-served retrieval: the raw document text rides the doc
            # rows so the changelog feed can cast it (the __item column is the
            # embedded vector — not enough to rebuild the response payload)
            cols["__payload"] = self.data_column
        return table.select(**cols)

    def _raw_reply(
        self,
        query_column: ColumnReference,
        number_of_matches: Any,
        metadata_filter: Any,
        as_of_now: bool,
    ) -> Table:
        qtable: Table = query_column.table
        qitem = self.item_transform(qtable, query_column)
        cols = {"__item": qitem}
        cols["__k"] = number_of_matches if number_of_matches is not None else 3
        cols["__filter"] = metadata_filter if metadata_filter is not None else None
        queries = qtable.select(**cols)
        cap = None
        if as_of_now:
            from pathway_tpu_torch.fabric import index_replica as _index_replica

            cap = _index_replica.current_capture()
            if cap is not None:
                cap.bind(self)
                if cap.composite:
                    # hybrid/composite retrieval: one replica can't reproduce
                    # the composition — leave the nodes uncaptured (the route
                    # always forwards)
                    cap = None
        docs = self._docs_table(with_payload=cap is not None)
        factory = self.backend_factory
        if cap is None:
            make = lambda: ExternalIndexNode(factory, as_of_now=as_of_now)  # noqa: E731
        else:

            def make(_cap=cap, _factory=factory, _aon=as_of_now):
                node = ExternalIndexNode(_factory, as_of_now=_aon)
                # every worker of every process builds its own instance;
                # each one feeds the same route (disjoint doc shards)
                _cap.attach_node(node)
                return node

        node = LogicalNode(
            make,
            [docs._node, queries._node],
            name="external_index",
        )
        merge = LogicalNode(
            lambda: MergeIndexRepliesNode(), [node], name="index_merge"
        )
        schema = schema_mod.schema_from_dtypes({_INDEX_REPLY: dt.ANY})
        return Table(merge, schema, qtable._universe.subset())

    def query(self, query_column, *, number_of_matches=3, metadata_filter=None):
        return self._raw_reply(query_column, number_of_matches, metadata_filter, False)

    def query_as_of_now(self, query_column, *, number_of_matches=3, metadata_filter=None):
        return self._raw_reply(query_column, number_of_matches, metadata_filter, True)


class _DataIndexResult:
    """select()-able view over (query table × collapsed/flat matches); resolves
    ``pw.left`` to the query table's columns and ``pw.right`` to the joined data
    columns. In flat mode the query columns are materialized onto the match rows
    (prefixed ``__q_``) since each query yields many match rows."""

    def __init__(
        self,
        query_table: Table,
        right: Table,
        left_to_right_universe: bool,
        left_prefix: str | None = None,
    ):
        self._query_table = query_table
        self._right = right
        self._same_universe = left_to_right_universe
        self._left_prefix = left_prefix

    def _left_col(self, name: str):
        if self._left_prefix is not None:
            return self._right[f"{self._left_prefix}{name}"]
        return self._query_table[name]

    def _resolve(self, e):
        from pathway_tpu_torch.internals import expression as expr_mod

        e = expr_mod.wrap(e)
        qcols = set(self._query_table.column_names())

        def walk(x):
            if isinstance(x, ColumnReference) and x.table is None:
                side = getattr(x, "_placeholder_side", "this")
                if side == "left":
                    return self._left_col(x.name)
                if side == "right":
                    return self._right[x.name]
                if x.name in self._right.column_names():
                    return self._right[x.name]
                if x.name in qcols:
                    return self._left_col(x.name)
                raise KeyError(f"column {x.name!r} in neither side of the index result")
            if isinstance(x, ColumnReference) and x.table is self._query_table:
                return self._left_col(x.name)
            args = x._args()
            if not args:
                return x
            return x._with_args(tuple(walk(a) for a in args))

        return walk(e)

    def select(self, *args, **kwargs) -> Table:
        from pathway_tpu_torch.internals import expression as expr_mod

        exprs = {}
        for a in args:
            bound = self._resolve(a)
            name = expr_mod.smart_name(bound)
            if name is None:
                raise ValueError("positional select args must be column references")
            exprs[name] = bound
        for n, e in kwargs.items():
            exprs[n] = self._resolve(e)
        base = self._right.with_universe_of(self._query_table) if self._same_universe else self._right
        # expressions may span query table + right table (same universe)
        return base.select(**exprs)


class DataIndex:
    """Reference ``DataIndex``: inner index + payload join."""

    def __init__(self, data_table: Table, inner_index: InnerIndex):
        self.data_table = data_table
        self.inner_index = inner_index

    def _query_impl(
        self,
        query_column: ColumnReference,
        number_of_matches,
        collapse_rows: bool,
        metadata_filter,
        as_of_now: bool,
    ):
        import pathway_tpu_torch as pw

        qtable: Table = query_column.table
        raw = (
            self.inner_index.query_as_of_now(
                query_column,
                number_of_matches=number_of_matches,
                metadata_filter=metadata_filter,
            )
            if as_of_now
            else self.inner_index.query(
                query_column,
                number_of_matches=number_of_matches,
                metadata_filter=metadata_filter,
            )
        )
        # flatten replies → one row per (query, match)
        rep = raw.select(reply=raw[_INDEX_REPLY], __qid=raw.id)
        flat = rep.flatten(rep.reply)
        flat = flat.select(
            __qid=flat["__qid"],
            __doc=pw.this.reply.get(0),
            __score=pw.apply_with_type(lambda r: float(r[1]), dt.FLOAT, pw.this.reply),
        )
        data_cols = self.data_table.column_names()
        ixed = self.data_table.ix(flat["__doc"], optional=True)  # one shared join
        matched = flat.with_columns(**{n: ixed[n] for n in data_cols})
        if not collapse_rows:
            # flat mode: one row per match; pull query columns onto the match rows
            q_ixed = qtable.ix(matched["__qid"])
            with_q = matched.with_columns(
                **{f"__q_{n}": q_ixed[n] for n in qtable.column_names()},
                **{_SCORE: matched["__score"]},
            )
            return _DataIndexResult(
                qtable, with_q, left_to_right_universe=False, left_prefix="__q_"
            )
        # collapse: per query, score-ordered tuples of each data column
        # equal scores ordered by the match row's key (the order a single
        # worker's rows arrive in): the reference sorts by -score alone, so
        # on several workers tied hits follow arrival
        grouped = matched.groupby(
            matched["__qid"], id=matched["__qid"],
            sort_by=pw.make_tuple(-matched["__score"], matched.id),
        )
        agg = {n: pw.reducers.tuple(matched[n]) for n in data_cols}
        agg[_SCORE] = pw.reducers.tuple(matched["__score"])
        collapsed = grouped.reduce(**agg)
        # queries with zero matches have no group — pad with None (reference:
        # left join; DocumentStore coalesces to ())
        out_cols = data_cols + [_SCORE]
        if as_of_now:
            # serving discipline: an as-of-now query emits NOTHING until the
            # index has answered it, so the pad universe is the ANSWERED
            # replies (``rep`` rows exist exactly then; ``()`` for zero
            # matches). Padding over the full query universe raced the
            # answer: the reply can land ticks after arrival (the query
            # embedding rides the cross-tick microbatch path), and a REST
            # client would be resolved with the provisional padded row.
            base = rep.select(
                **{n: pw.declare_type(dt.ANY, None) for n in out_cols}
            )
        else:
            base = qtable.select(
                **{n: pw.declare_type(dt.ANY, None) for n in out_cols}
            )
        padded = base.update_cells(collapsed.promise_universe_is_subset_of(base))
        return _DataIndexResult(qtable, padded, left_to_right_universe=True)

    def query(self, query_column, *, number_of_matches=3, collapse_rows=True, metadata_filter=None):
        return self._query_impl(
            query_column, number_of_matches, collapse_rows, metadata_filter, False
        )

    def query_as_of_now(
        self, query_column, *, number_of_matches=3, collapse_rows=True, metadata_filter=None
    ):
        return self._query_impl(
            query_column, number_of_matches, collapse_rows, metadata_filter, True
        )
