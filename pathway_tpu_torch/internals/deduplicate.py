"""``Table.deduplicate`` — acceptor-driven per-instance latest-accepted-row.

Engine counterpart of the reference's deduplicate operator
(``src/engine/dataflow.rs`` ``deduplicate`` + ``stdlib/stateful/deduplicate.py``):
for every ``instance`` the node remembers the last *accepted* value; a new row's
value is passed to ``acceptor(new_value, previous_accepted)`` and, if accepted,
the previously emitted row for that instance is retracted and the new one
emitted. Append-only (like the reference's stateful reducers, retractions of
input rows are rejected).

Carried from ``pathway_tpu/internals/deduplicate.py``.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.engine.blocks import DeltaBatch
from pathway_tpu_torch.engine.graph import Node
from pathway_tpu_torch.internals.keys import stable_hash_obj
from pathway_tpu_torch.internals.logical import LogicalNode
from pathway_tpu_torch.internals.universe import Universe


class DeduplicateNode(Node):
    name = "deduplicate"

    snapshot_attrs = ("state",)

    def __init__(
        self,
        columns: list[str],
        value_col: str,
        instance_col: str | None,
        acceptor: Callable[[Any, Any], bool],
    ):
        super().__init__(n_inputs=1)
        self.columns = columns
        self.value_col = value_col
        self.instance_col = instance_col
        self.acceptor = acceptor
        # instance-hash -> (accepted value, emitted row tuple)
        self.state: dict[int, tuple[Any, tuple]] = {}

    def exchange_key(self, port):
        if self.instance_col is None:
            from pathway_tpu_torch.engine.graph import SOLO

            return SOLO  # one global instance: serial
        col = self.instance_col

        def key_fn(batch, c=col):
            arr = batch.data[c]
            return np.fromiter(
                (int(stable_hash_obj(v)) for v in arr), dtype=np.uint64, count=len(arr)
            )

        return key_fn

    def process(self, inputs, time):
        batch = inputs[0]
        if batch is None or not len(batch):
            return []
        if (batch.diffs < 0).any():
            raise RuntimeError(
                "deduplicate is append-only: retractions in its input are not supported"
            )
        cols = [batch.data[c] for c in self.columns]
        vals = batch.data[self.value_col]
        if self.instance_col is None:
            inst_keys = [0] * len(batch)
        else:
            inst_arr = batch.data[self.instance_col]
            inst_keys = [int(stable_hash_obj(v)) for v in inst_arr]
        out_keys: list[int] = []
        out_diffs: list[int] = []
        out_rows: list[tuple] = []
        for i in range(len(batch)):
            ik = inst_keys[i]
            prev = self.state.get(ik)
            new_val = vals[i]
            if prev is not None and not self.acceptor(new_val, prev[0]):
                continue
            row = tuple(c[i] for c in cols)
            if prev is not None:
                out_keys.append(ik)
                out_diffs.append(-1)
                out_rows.append(prev[1])
            out_keys.append(ik)
            out_diffs.append(1)
            out_rows.append(row)
            self.state[ik] = (new_val, row)
        if not out_keys:
            return []
        return [DeltaBatch.from_rows(out_keys, out_rows, self.columns, time, diffs=out_diffs)]


def deduplicate_impl(table, *, value=None, instance=None, acceptor=None):
    from pathway_tpu_torch.internals.table import Table

    if value is None or acceptor is None:
        raise ValueError("deduplicate requires value= and acceptor=")
    value_ref = table._bind(value)
    inst_ref = table._bind(instance) if instance is not None else None
    cols = table._schema.column_names()
    pre = table  # rows flow through unchanged; the node reads raw columns
    value_name = value_ref.name
    inst_name = inst_ref.name if inst_ref is not None else None
    node = LogicalNode(
        lambda: DeduplicateNode(cols, value_name, inst_name, acceptor),
        [pre._node],
        name="deduplicate",
    )
    return Table(node, table._schema, Universe())
