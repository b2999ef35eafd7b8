"""Chain-fusion pass: whole-tick compiled dataflow (ROADMAP #3).

Before r15 every operator in a tick launched separately from Python —
``Scheduler._sweep`` walked nodes one at a time, and at small (64–1k row)
ticks the per-node dispatch (drain / stats / route / accept bookkeeping plus
the O(all nodes) quiescence scans) dominated the tick budget. This module
inverts the execution model: **chains become the unit of dispatch**.

At graph finalization :func:`build_plan` identifies maximal linear operator
chains — runs of nodes where each link is single-producer/single-consumer on
its port, every member uses the scheduler's default ``poll``/``on_frontier``
(no self-scheduled emissions outside ``process``), and, on exchange-aware
runtimes (sharded/cluster), every interior link is exchange-free (the rows
would have stayed on the producing worker anyway). Each chain executes as
**one sweep step**: batches hand off member to member in-process, with no
intermediate ``accept``/``drain``/``_route`` round-trips. A chain step runs
at its *tail's* topological position, which makes the execution order —
and therefore the raw delta stream — byte-identical to the unfused sweep
(all producers of any member have already run when the step fires; interior
links are single-consumer so nothing else can observe the handoff).

Within a chain, consecutive *expression* members (``FilterNode`` /
``RowwiseNode`` / ``SelectColumnsNode`` whose ASTs ride on the node) further
collapse into a :class:`ComposedSegment`: one program over ``(keys, diffs,
columns)`` with no intermediate ``DeltaBatch`` construction; for the
whitelisted numeric expression subset (``expression_vm.infer_fused_dtype``)
it is a flat register program whose filters fold into one lane mask, and —
for big blocks — the **device tier** (``PATHWAY_FUSE_JAX``): the same stages
as torch ops over the padded block (``expression_vm.trace_fused``), filters
accumulating one lane mask. Inputs pad to the power-of-two buckets of
``torch_kernels._bucket``, so the set of block shapes (and the caching
allocator's block sizes) stays closed under row-count churn.

Carried from ``pathway_tpu/engine/fusion.py``, whose device tier is one
jitted, buffer-donating XLA kernel per segment. The port's differences:
- the device follows the port's rule: the card, or an error without CUDA;
  ``PATHWAY_ENGINE_JAX=cpu`` pins it to CPU tensors (tests);
- a failure on the device tier raises, where the reference logs a warning
  and falls back to numpy for the rest of the process;
- torch has no buffer donation (reference ``jax_kernels._donate_active``):
  each tick's blocks are freed after the launch and the caching allocator
  hands their blocks to the next tick.

An audit-edge-sampled tick (``aud`` non-None) keeps a segment on the host
program, as in the reference: the device tier's single lane mask cannot
attribute per-member edge counts, so ``run`` skips ``_run_device`` there and
the register program or the numpy path record them (``_note_edges``). An
unaudited tick's route is unchanged.

``PATHWAY_FUSE=off`` restores the one-node-per-step sweep exactly.

The plan also precomputes which nodes actually override ``poll`` /
``on_frontier`` / ``on_tick_complete`` so the tick loops visit only those —
the empty-tick short-circuit: a quiescent graph no longer pays a
run-annotated no-op call per node per phase.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.engine.blocks import DeltaBatch, concat_batches
from pathway_tpu_torch.engine.graph import END_OF_STREAM, Node
from pathway_tpu_torch.internals.trace import annotate as _annotate
from pathway_tpu_torch.internals.trace import run_annotated as _run_annotated


def _overrides(node: Node, method: str) -> bool:
    """Does this node override ``method`` (class- or instance-level)?"""
    return (
        getattr(type(node), method, None) is not getattr(Node, method)
        or method in node.__dict__
    )


def _chain_member_ok(node: Node, interior: bool = False) -> bool:
    """May this node belong to a fused chain? It must be a processing node
    (not a polled source) whose only emission path is ``process`` — a node
    that emits from ``poll`` or ``on_frontier`` schedules itself outside the
    sweep and must keep its own dispatch slot. A non-HEAD member
    additionally must not override ``accept``: the in-process carry handoff
    bypasses accept entirely, so a node that filters or latches inside it
    (e.g. iterate's port-tag gate) would silently lose that logic."""
    return (
        node.n_inputs >= 1
        and not _overrides(node, "poll")
        and not _overrides(node, "on_frontier")
        and not (interior and _overrides(node, "accept"))
    )


def _composable(node: Node) -> bool:
    """Can this member lower into a ComposedSegment stage (its expression
    AST is attached, or it is a pure column re-pick)?"""
    from pathway_tpu_torch.engine import operators as ops

    if isinstance(node, ops.FilterNode):
        return node.expr is not None
    if isinstance(node, ops.RowwiseNode):
        return node.exprs is not None
    return isinstance(node, ops.SelectColumnsNode)


# --------------------------------------------------------------- composed segment


class ComposedSegment:
    """A run of >=2 consecutive expression members compiled into one block
    program. The numpy path evaluates stage by stage over bare
    ``(keys, diffs, columns)`` — same ``eval_expr`` calls as the member
    nodes, minus the per-member DeltaBatch construction — so values are
    byte-identical to member-by-member execution. When every stage is in the
    whitelist and the batch's column dtypes are numeric
    (``expression_vm.infer_fused_dtype``), the segment runs as one flat
    register program, or on the device tier: the same stages as torch ops
    (``expression_vm.trace_fused``). The whitelist is chosen so that both
    give the same bits as the numpy path (elementwise IEEE ops, exact
    integer ops, no value-dependent fallbacks); a device-tier failure
    raises."""

    __slots__ = ("nodes", "stages", "label", "_kernels", "_device_cfg")

    def __init__(self, nodes: list[Node]):
        from pathway_tpu_torch.engine import operators as ops

        self.nodes = nodes
        self.stages: list[tuple] = []
        for n in nodes:
            if isinstance(n, ops.FilterNode):
                self.stages.append(("filter", n, n.expr))
            elif isinstance(n, ops.RowwiseNode):
                self.stages.append(("rowwise", n, list(n.exprs.items())))
            else:  # SelectColumnsNode
                self.stages.append(("select", n, n.columns, n.rename))
        self.label = "+".join(n.name for n in nodes)
        # dtype signature -> _CompiledSegment | None (None = ineligible)
        self._kernels: dict[tuple, Any] = {}
        self._device_cfg: tuple | None = None

    # ---------------------------------------------------------------- execute
    def run(self, batch: DeltaBatch, time: int, aud: Any = None) -> DeltaBatch:
        """Execute the segment over one block. ``aud`` non-None = this tick
        is audit-edge-sampled: per-member (keys, diffs) edge recordings are
        emitted exactly as the member-by-member sweep would (the monitors
        read only keys/diffs/len of each edge batch)."""
        if not len(batch):
            return batch
        names = list(batch.data.keys())
        sig = tuple((c, batch.data[c].dtype.char) for c in names)
        ent = self._kernels.get(sig, _MISSING)
        if ent is _MISSING:
            ent = self._compile(names, {c: batch.data[c].dtype for c in names})
            self._kernels[sig] = ent
        if ent is None:
            # outside the whitelist (object columns, UDFs, excluded ops):
            # stage-by-stage eval_expr, still one sweep step
            return self._run_numpy(batch, time, aud)
        if aud is None and self._device_wanted(len(batch)):
            # audited ticks stay on the host program: the device tier's
            # single lane mask cannot attribute per-member edge counts
            return self._run_device(ent, batch, time)
        return self._run_fast(ent.fast, batch, time, aud)

    def _device_wanted(self, n: int) -> bool:
        """Reference ``_jax_wanted``: ``on`` always, ``auto`` for blocks of at
        least ``PATHWAY_FUSE_JAX_MIN_ROWS`` rows, ``off`` never."""
        mode, min_rows = self._device_mode()
        if mode == "off":
            return False
        return mode == "on" or n >= min_rows

    def _device_mode(self) -> tuple:
        # resolved once per segment per run-phase: three env reads per tick
        # showed up in the reference's small-tick profile
        mode = self._device_cfg
        if mode is None:
            from pathway_tpu_torch.internals.config import get_pathway_config

            cfg = get_pathway_config()
            mode = self._device_cfg = (cfg.fuse_jax, cfg.fuse_jax_min_rows)
        return mode

    def _run_fast(
        self, prog, batch: DeltaBatch, time: int, aud: Any = None
    ) -> DeltaBatch:
        """Flat compiled register program: same ufuncs and values as the
        generic VM, none of its recursion, per-op errstate, per-stage dict
        rebuilds or per-filter compactions. Filters fold into ONE lane mask
        (later stages compute over excluded lanes too, safe because the
        whitelist has no value-dependent failure modes) and the block compacts once at the end, over the output
        columns only. Surviving lanes keep their values and order, so the
        result is byte-identical to compact-at-every-filter."""
        from pathway_tpu_torch.engine import operators as ops

        from pathway_tpu_torch.internals import trace as _trace

        keys = batch.keys
        diffs = batch.diffs
        data = batch.data
        n = len(keys)
        regs: list = [data[c] for c in prog.in_names]
        mask: np.ndarray | None = None
        counts: list[int] = [n]  # survivor count at each filter boundary
        masks: list | None = [] if aud is not None else None
        # each instruction carries its owning member node: a raise inside the
        # compiled program (the whitelist should preclude one, but numpy can
        # still fail structurally) must attribute to the MEMBER, not fall
        # through to whatever node label the thread last ran (the
        # run_annotated discipline, same as _run_numpy's per-stage pin)
        prev_node = getattr(_trace._tls, "node", None)
        try:
            with np.errstate(all="ignore"):
                for kind, fns, owner in prog.instrs:
                    _trace._tls.node = owner
                    if kind == 0:  # rowwise batch of expr evaluations
                        for fn in fns:
                            regs.append(fn(regs, keys))
                    else:  # filter: fold into the lane mask
                        m = fns(regs, keys)
                        if not isinstance(m, np.ndarray):
                            m = np.full(n, bool(m))
                        mask = m if mask is None else mask & m
                        counts.append(int(mask.sum()))
                        if masks is not None:
                            masks.append(mask)
        except Exception as e:
            owner = getattr(_trace._tls, "node", None)
            if owner is not None and owner is not prev_node:
                _annotate(e, owner.name, getattr(owner, "user_trace", None))
            raise
        finally:
            _trace._tls.node = prev_node
        if mask is not None:
            idx = np.flatnonzero(mask)
            out = {
                name: (
                    regs[j][idx]
                    if isinstance(regs[j], np.ndarray)
                    else np.full(len(idx), regs[j])
                )
                for name, j in prog.out_pairs
            }
            out_keys = keys[idx]
            out_diffs = diffs[idx]
        else:
            out = {name: _as_col(regs[j], n) for name, j in prog.out_pairs}
            out_keys = keys
            out_diffs = diffs
        # stats: exact per-member counts, reconstructed from the filter
        # boundary survivor counts (the r12 cardinality gauges read these
        # as exact rows — a member behind a 1%-selective filter must not
        # report the whole block as its input)
        ci = 0
        for node in self.nodes:
            node.stats_rows_in += counts[ci]
            if isinstance(node, ops.FilterNode):
                ci += 1
            if node is not self.nodes[-1] and counts[ci]:
                node.stats_rows_out += counts[ci]
        if masks is not None:
            edges = [(keys, diffs)]
            for m in masks:
                i = np.flatnonzero(m)
                edges.append((keys[i], diffs[i]))
            self._note_edges(aud, edges)
        return DeltaBatch(out_keys, out_diffs, out, time)

    def _note_edges(self, aud, edges: list) -> None:
        """Per-member edge recordings for an audit-sampled tick: members
        between two filters all see the post-filter (keys, diffs)."""
        from pathway_tpu_torch.engine import operators as ops

        i = 0
        cur = _EdgeView(*edges[0])
        for st in self.stages:
            node = st[1]
            ins = [cur]
            if isinstance(node, ops.FilterNode):
                i += 1
                cur = _EdgeView(*edges[min(i, len(edges) - 1)])
            aud.note_edge(node, ins, [cur])

    def _run_numpy(
        self, batch: DeltaBatch, time: int, aud: Any = None
    ) -> DeltaBatch:
        from pathway_tpu_torch.engine.expression_vm import EvalContext, eval_expr
        from pathway_tpu_torch.internals import trace as _trace

        keys = batch.keys
        diffs = batch.diffs
        data = batch.data
        n = len(keys)
        edges: list | None = [(keys, diffs)] if aud is not None else None
        prev_node = getattr(_trace._tls, "node", None)
        try:
            for st in self.stages:
                node = st[1]
                # row-level error reports attribute to the member whose
                # stage is executing (the run_annotated discipline)
                _trace._tls.node = node
                node.stats_rows_in += n
                try:
                    if st[0] == "filter":
                        ctx = EvalContext(_make_lookup(data, keys), n)
                        mask = np.asarray(eval_expr(st[2], ctx))
                        if mask.dtype != np.bool_:
                            from pathway_tpu_torch.internals.errors import ERROR

                            mask = np.fromiter(
                                (
                                    v is not None and v is not ERROR and bool(v)
                                    for v in mask
                                ),
                                dtype=bool,
                                count=len(mask),
                            )
                        idx = np.flatnonzero(mask)
                        keys = keys[idx]
                        diffs = diffs[idx]
                        data = {c: a[idx] for c, a in data.items()}
                        n = len(keys)
                        if edges is not None:
                            edges.append((keys, diffs))
                    elif st[0] == "rowwise":
                        ctx = EvalContext(_make_lookup(data, keys), n)
                        data = {
                            name: np.asarray(eval_expr(e, ctx)) for name, e in st[2]
                        }
                    else:  # select
                        _, _, columns, rename = st
                        data = {rename.get(c, c): data[c] for c in columns}
                except Exception as e:
                    _annotate(e, node.name, getattr(node, "user_trace", None))
                    raise
                if n and node is not self.nodes[-1]:
                    # the final stage's emission count is booked by the chain
                    # executor / router, exactly once
                    node.stats_rows_out += n
        finally:
            _trace._tls.node = prev_node
        if edges is not None:
            self._note_edges(aud, edges)
        return DeltaBatch(keys, diffs, data, time)

    # ------------------------------------------------------------ compilation
    def _compile(self, in_names: list[str], dtypes: dict[str, np.dtype]):
        """Check the segment against the fused whitelist under these input
        dtypes; returns a :class:`_CompiledSegment` (flat register program)
        or None when any stage leaves the
        whitelist. Selects/renames compile away entirely (a register
        remapping); filters fold into one lane mask applied at the end
        (see _run_fast)."""
        from pathway_tpu_torch.engine.expression_vm import compile_fast, infer_fused_dtype

        cur = dict(dtypes)
        slots = {name: i for i, name in enumerate(in_names)}
        nregs = len(in_names)
        instrs: list[tuple] = []
        for st in self.stages:
            if st[0] == "filter":
                d = infer_fused_dtype(st[2], cur)
                if d is None or d.kind != "b":
                    return None
                instrs.append((1, compile_fast(st[2], cur, slots), st[1]))
            elif st[0] == "rowwise":
                from pathway_tpu_torch.internals.expression import ColumnReference

                nxt_d: dict[str, np.dtype] = {}
                nxt_s: dict[str, int] = {}
                fns: list = []
                for name, e in st[2]:
                    d = infer_fused_dtype(e, cur)
                    if d is None:
                        return None
                    nxt_d[name] = d
                    if isinstance(e, ColumnReference) and e.name != "id":
                        # bare column pass-through (the bulk of every select
                        # and all of rename): alias the existing register —
                        # no instruction, no runtime cost
                        nxt_s[name] = slots[e.name]
                        continue
                    fns.append(compile_fast(e, cur, slots))
                    nxt_s[name] = nregs
                    nregs += 1
                if fns:
                    instrs.append((0, fns, st[1]))
                cur, slots = nxt_d, nxt_s
            else:
                _, _, columns, rename = st
                if any(c not in cur for c in columns):
                    return None
                cur = {rename.get(c, c): cur[c] for c in columns}
                slots = {rename.get(c, c): slots[c] for c in columns}
        prog = _FastProgram(
            list(in_names), instrs, [(name, j) for name, j in slots.items()]
        )
        return _CompiledSegment(prog, list(in_names), list(cur.keys()))

    def _run_device(self, ent: "_CompiledSegment", batch: DeltaBatch, time: int) -> DeltaBatch:
        """Reference ``_seg_run_jax``: the block padded to its power-of-two
        bucket, on the device tier's device, one fetch of the mask and the
        output columns."""
        import torch

        from pathway_tpu_torch.engine import torch_kernels as K
        from pathway_tpu_torch.engine.expression_vm import from_torch_lanes, to_torch_lanes

        kern = ent.device_kernel(self)
        n = len(batch)
        bs = K._bucket(n)
        dev = K._device()

        def lanes(a: np.ndarray):
            if bs != n:
                a = np.concatenate([a, np.zeros(bs - n, dtype=a.dtype)])
            return to_torch_lanes(a, dev), a.dtype

        keys = lanes(batch.keys)
        cols = [lanes(batch.data[c]) for c in ent.in_names]
        with torch.inference_mode():
            mask, outs = kern(keys, cols)
            mask = mask[:n].cpu().numpy()
            outs = [from_torch_lanes(t[:n], d) for t, d in outs]
        K._note("fused", dev)
        # stats: the single fused lane mask can't attribute per-member
        # intermediate counts — block-in is booked for every member (the
        # device tier engages on large blocks / explicit opt-in; the register
        # program and the unfused sweep keep the gauges exact)
        for node in self.nodes:
            node.stats_rows_in += n
        idx = np.flatnonzero(mask)
        data = {name: o[idx] for name, o in zip(ent.out_names, outs)}
        out = DeltaBatch(batch.keys[idx], batch.diffs[idx], data, time)
        if len(out):
            for node in self.nodes[:-1]:
                node.stats_rows_out += len(out)
        return out


class _FastProgram:
    __slots__ = ("in_names", "instrs", "out_pairs")

    def __init__(self, in_names, instrs, out_pairs):
        self.in_names = in_names
        self.instrs = instrs
        self.out_pairs = out_pairs


class _CompiledSegment:
    """One (segment, input dtype signature) compilation: the flat numpy
    program plus the lazily built device kernel for the same stages."""

    __slots__ = ("fast", "in_names", "out_names", "_device")

    def __init__(self, fast: list[tuple], in_names: list[str], out_names: list[str]):
        self.fast = fast
        self.in_names = in_names
        self.out_names = out_names
        self._device: Callable | None = None

    def device_kernel(self, seg: "ComposedSegment") -> Callable:
        """Reference ``jax_kernel``: ``kernel(keys, cols) -> (mask, outs)``
        over ``(tensor, numpy dtype)`` lanes. Filters fold into one lane mask
        and filtered-out lanes keep computing downstream stages — the
        whitelist has no value-dependent failure modes, and masked lanes are
        dropped on the host."""
        if self._device is not None:
            return self._device
        from pathway_tpu_torch.engine.expression_vm import trace_fused

        in_names, out_names, stages = self.in_names, self.out_names, seg.stages

        def kernel(keys, cols):
            import torch

            env = dict(zip(in_names, cols))
            mask = None
            for st in stages:
                if st[0] == "filter":
                    m = trace_fused(st[2], env, keys)[0]
                    mask = m if mask is None else mask & m
                elif st[0] == "rowwise":
                    env = {name: trace_fused(e, env, keys) for name, e in st[2]}
                else:
                    _, _, columns, rename = st
                    env = {rename.get(c, c): env[c] for c in columns}
            if mask is None:
                mask = torch.ones(keys[0].shape, dtype=torch.bool, device=keys[0].device)
            return mask, [env[c] for c in out_names]

        from pathway_tpu_torch.observability import device as _dev_prof

        # device plane: call/shape telemetry per fused segment, at the
        # reference's label
        self._device = _dev_prof.traced_jit(f"engine.fused_chain/{seg.label}", kernel)
        return self._device


_MISSING = object()


class _EdgeView:
    """Lightweight (keys, diffs) view handed to the audit plane's edge
    monitors for fused-segment members — ``_EdgeStats.note`` reads exactly
    ``keys``/``diffs``/``len`` of each edge batch."""

    __slots__ = ("keys", "diffs")

    def __init__(self, keys: np.ndarray, diffs: np.ndarray):
        self.keys = keys
        self.diffs = diffs

    def __len__(self) -> int:
        return len(self.keys)


def _as_col(v, n: int) -> np.ndarray:
    """A fast-program result as a column: arrays pass through, a scalar
    (pure-const expression) broadcasts to the block length — the array
    ``eval_expr`` would have built for the same constant."""
    if isinstance(v, np.ndarray):
        return v
    return np.full(n, v)


def _make_lookup(data: dict, keys: np.ndarray) -> Callable:
    def lookup(ref):
        if ref.name == "id":
            return keys
        return data[ref.name]

    return lookup


# -------------------------------------------------------------------- fused chain


class FusedChain:
    """One maximal linear chain, executed as a single sweep step at the
    tail's topological position."""

    __slots__ = ("members", "in_ports", "pos", "label", "units", "tail")

    def __init__(self, members: list[Node], in_ports: dict[int, int]):
        self.members = members
        self.in_ports = in_ports  # node_index -> chain-fed port (heads absent)
        self.tail = members[-1]
        self.pos = self.tail.node_index
        self.label = "+".join(m.name for m in members)
        # units: composable runs collapsed into ComposedSegments (segments
        # serve audit-sampled ticks too — they reconstruct exact per-member
        # edge recordings, see ComposedSegment._note_edges)
        self.units = self._build_units(members)

    def _build_units(self, members: list[Node]) -> list[tuple]:
        units: list[tuple] = []
        run: list[Node] = []

        def flush() -> None:
            if not run:
                return
            if len(run) >= 2:
                units.append(("seg", ComposedSegment(list(run))))
            else:
                units.append(("node", run[0]))
            run.clear()

        for m in members:
            if _composable(m):
                run.append(m)
                continue
            flush()
            units.append(("node", m))
        flush()
        return units

    def operator_ids(self) -> str:
        return "+".join(str(m.node_index) for m in self.members)

    @staticmethod
    def _stamp(node: Node, time: int, lat: float | None) -> None:
        """Monitoring probes for a member fed by in-process hand-off (it
        never drains): advance its last-processed logical time and carry
        the step's measured queue latency, so the /status latency/lag
        fields stay live under fusion."""
        if time is not None and time != END_OF_STREAM and time > node.stats_last_time:
            node.stats_last_time = time
        if lat is not None:
            node.stats_latency_ms = lat
            node.stats_latency_ewma_ms = (
                lat
                if node.stats_latency_ewma_ms == 0.0
                else 0.8 * node.stats_latency_ewma_ms + 0.2 * lat
            )

    def execute(
        self,
        time: int,
        lock: "threading.Lock | None",
        aud: Any = None,
    ) -> tuple[list[DeltaBatch], bool, int, int]:
        """Run the chain to its tail; returns ``(tail_out, processed,
        rows_in, rows_out)``. ``aud`` non-None = this tick is edge-sampled:
        every unit emits the per-member edge recordings the unfused sweep
        would (node units via ``note_edge`` directly, segments via their
        stage-boundary (keys, diffs) views)."""
        units = self.units
        carry: DeltaBatch | None = None
        processed = False
        rows_in_total = 0
        out: list[DeltaBatch] = []
        last = len(units) - 1
        step_lat: float | None = None
        for ui, unit in enumerate(units):
            kind, payload = unit
            first = payload.nodes[0] if kind == "seg" else payload
            if first.has_pending():
                if lock is None:
                    ins = first.drain()
                else:
                    with lock:
                        ins = first.drain()
                step_lat = first.stats_latency_ms
            else:
                ins = None
            if ins is None and carry is None:
                continue  # quiet here; a later member may still have pending
            processed = True
            if kind == "seg":
                seg: ComposedSegment = payload
                batch_in = ins[0] if ins is not None else None
                if carry is not None:
                    batch_in = (
                        carry
                        if batch_in is None
                        else concat_batches([batch_in, carry])
                    )
                carry = None
                if batch_in is not None and len(batch_in):
                    rows_in_total += len(batch_in)
                    for n_ in seg.nodes if ins is None else seg.nodes[1:]:
                        self._stamp(n_, batch_in.time, step_lat)
                    result = seg.run(batch_in, time, aud)
                    if len(result):
                        carry = result
                        if ui == last:
                            out = [result]
                        else:
                            seg.nodes[-1].stats_rows_out += len(result)
            else:
                node: Node = payload
                if ins is None:
                    ins = [None] * node.n_inputs
                if carry is not None:
                    p = self.in_ports.get(node.node_index, 0)
                    ins[p] = (
                        carry if ins[p] is None else concat_batches([ins[p], carry])
                    )
                    self._stamp(node, carry.time, step_lat)
                    carry = None
                rows_in = sum(len(b) for b in ins if b is not None)
                rows_in_total += rows_in
                node.stats_rows_in += rows_in
                emitted = _run_annotated(node, node.process, ins, time)
                if aud is not None:
                    aud.note_edge(node, ins, emitted)
                emitted = [b for b in emitted if b is not None and not b.is_empty]
                if ui == last:
                    out = emitted
                elif emitted:
                    for b in emitted:
                        node.stats_rows_out += len(b)
                    carry = concat_batches(emitted)
        rows_out = sum(len(b) for b in out)
        return out, processed, rows_in_total, rows_out


# --------------------------------------------------------------------------- plan


class Step:
    __slots__ = ("pos", "node", "chain")

    def __init__(self, pos: int, node: Node | None, chain: FusedChain | None):
        self.pos = pos
        self.node = node
        self.chain = chain


class Plan:
    """Execution plan for one engine graph: sweep steps ordered by position
    (a chain runs at its tail's index), plus the poll/frontier/tick-complete
    visit lists (only nodes that actually override those hooks)."""

    __slots__ = (
        "steps",
        "by_pos",
        "pos_of",
        "pollers",
        "frontier_nodes",
        "tick_complete_nodes",
        "chains",
    )

    def __init__(self, graph) -> None:
        nodes = graph.nodes
        self.pollers = [n for n in nodes if _overrides(n, "poll")]
        self.frontier_nodes = [n for n in nodes if _overrides(n, "on_frontier")]
        self.tick_complete_nodes = [
            n for n in nodes if _overrides(n, "on_tick_complete")
        ]
        self.steps: list[Step] = []
        self.by_pos: dict[int, Step] = {}
        self.pos_of: list[int] = [0] * len(nodes)
        self.chains: list[FusedChain] = []

    def _finish(self, graph, chains: list[FusedChain]) -> None:
        in_chain: dict[int, FusedChain] = {}
        for ch in chains:
            for m in ch.members:
                in_chain[m.node_index] = ch
        for node in graph.nodes:
            ch = in_chain.get(node.node_index)
            if ch is None:
                step = Step(node.node_index, node, None)
                self.steps.append(step)
                self.pos_of[node.node_index] = node.node_index
            else:
                self.pos_of[node.node_index] = ch.pos
                if node is ch.tail:
                    self.steps.append(Step(ch.pos, None, ch))
        self.steps.sort(key=lambda s: s.pos)
        self.by_pos = {s.pos: s for s in self.steps}
        self.chains = chains


def build_plan(graph, exchange_aware: bool, transient: bool = False) -> Plan | None:
    """Compute the sweep plan for ``graph``, or **None** when
    ``PATHWAY_FUSE=off`` — the escape hatch disables the whole r15
    execution model (chains, dirty-step scheduling, hook visit lists) and
    the runtimes fall back to their r14 full-scan loops verbatim.
    ``exchange_aware=True`` (sharded/cluster runtimes) restricts interior
    links to exchange-free consumers — fusing across an exchange would move
    rows off the worker the unfused routing would have placed them on.
    ``transient=True`` (short-lived inner graphs rebuilt per use, e.g.
    iterate's fixed-point body) pins the segments' device tier off."""
    from pathway_tpu_torch.internals.config import get_pathway_config

    if get_pathway_config().fuse != "on":
        return None
    plan = Plan(graph)
    chains: list[FusedChain] = []
    nodes = graph.nodes
    in_count: dict[tuple[int, int], int] = {}
    for pi, cons in graph.edges.items():
        for ci, port in cons:
            key = (ci, port)
            in_count[key] = in_count.get(key, 0) + 1
    assigned = [False] * len(nodes)
    for h in range(len(nodes)):
        if assigned[h] or not _chain_member_ok(nodes[h]):
            continue
        chain = [h]
        ports: dict[int, int] = {}
        cur = h
        while True:
            edges = graph.edges.get(cur, [])
            if len(edges) != 1:
                break
            ci, port = edges[0]
            nxt = nodes[ci]
            if ci <= cur or assigned[ci] or not _chain_member_ok(nxt, interior=True):
                break
            if in_count.get((ci, port), 0) != 1:
                break
            if exchange_aware and nxt.exchange_key(port) is not None:
                break
            chain.append(ci)
            ports[ci] = port
            cur = ci
        if len(chain) >= 2:
            for i in chain:
                assigned[i] = True
            chains.append(FusedChain([nodes[i] for i in chain], ports))
    if transient:
        for ch in chains:
            for kind, payload in ch.units:
                if kind == "seg":
                    payload._device_cfg = ("off", 0)
    plan._finish(graph, chains)
    return plan
