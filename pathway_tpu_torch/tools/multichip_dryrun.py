"""Single-device forward step and multi-shard dry run of the port.

Counterpart of the JAX package's ``__graft_entry__.py`` (``entry`` and
``dryrun_multichip``). ``entry()`` returns the flagship model's forward (the
sentence encoder) with example arguments. ``dryrun_multichip(n)`` lays
``n`` logical shards on one device (the card by default, the CPU when the
caller asks for it) and runs, each checked:

- one TP/DP contrastive training step on a ``("data", "model")`` grid
  (``model`` = 2 when n >= 4 and n is even): the batch split on ``data``,
  the Megatron column/row split of the matrices and the vocabulary split of
  the embeddings on ``model``, equal to the unsharded step within
  :data:`STEP_TOL`;
- the sharded KNN index's self-nearest-neighbour search;
- ``exchange_by_key`` against a host groupby;
- the sharded dataflow (join, groupby, window, retractions) on n workers
  against one worker, and the production device plane
  (``PATHWAY_DEVICE_EXCHANGE=on``) on min(4, n) workers against one worker,
  with rows verifiably exchanged on the device.

The reference uses 4 heads of 16 at d 64; the port's attention takes head
widths of 32, 64 and 128, so the step here uses 2 heads of 32.

Run: ``python -m pathway_tpu_torch.tools.multichip_dryrun [N] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

#: each leaf of the sharded step's parameters and momenta within this share
#: of the leaf's largest value of the unsharded step's (the row-parallel
#: partial products are summed in another order than the whole product)
STEP_TOL = 1e-4


def entry(device=None):
    """The encoder's forward with example ``(params, ids, mask)``."""
    from pathway_tpu_torch._device import resolve_device
    from pathway_tpu_torch.convert import tree_map
    from pathway_tpu_torch.ops.encoder import EncoderConfig, encode, init_params

    dev = resolve_device(device)
    cfg = EncoderConfig(vocab_size=8192, d_model=256, n_heads=4, n_layers=4, d_ff=1024, max_len=128)
    params = tree_map(lambda t: t.to(dev), init_params(cfg, torch.Generator().manual_seed(0)))

    def forward(params, token_ids, mask):
        return encode(params, cfg, token_ids, mask)

    ids = np.random.default_rng(0).integers(3, cfg.vocab_size, size=(8, 64)).astype(np.int64)
    mask = np.ones((8, 64), dtype=bool)
    return forward, (params, torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))


def _close_trees(want, got, tol: float, what: str) -> float:
    """Largest per-leaf error over the leaf's largest value; raises above
    ``tol``."""
    from pathway_tpu_torch.convert import tree_leaves

    worst = 0.0
    for w, g in zip(tree_leaves(want), tree_leaves(got)):
        scale = max(float(w.abs().max()), 1e-6)
        err = float((w.float() - g.float().to(w.device)).abs().max()) / scale
        worst = max(worst, err)
    assert worst <= tol, f"{what}: sharded step off the unsharded by {worst} of a leaf's max"
    return worst


def _dryrun_train_step(n_devices: int, device: torch.device) -> dict:
    from pathway_tpu_torch.convert import tree_map
    from pathway_tpu_torch.ops import encoder as E
    from pathway_tpu_torch.parallel.mesh import device_mesh

    model_par = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    n_data = n_devices // model_par
    mesh = device_mesh({"data": n_data, "model": model_par}, devices=[device] * n_devices)
    cfg = E.EncoderConfig(
        vocab_size=512, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=32, dtype=torch.float32
    )
    params = tree_map(lambda t: t.to(device), E.init_params(cfg, torch.Generator().manual_seed(0)))
    opt = tree_map(torch.zeros_like, params)
    B, L = 2 * n_data, 16
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(B, L))).to(device)
    mask = torch.ones((B, L), dtype=torch.bool, device=device)
    batch = (ids, mask, ids, mask)

    shardings = E.param_shardings(cfg, mesh)
    sp, so = E.shard_params(params, shardings), E.shard_params(opt, shardings)
    t0 = time.perf_counter()
    sp, so, loss = E.contrastive_train_step(sp, cfg, so, batch, lr=1e-2)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    step_s = time.perf_counter() - t0
    assert np.isfinite(float(loss)), f"non-finite training loss {loss}"
    want_p, want_o, want_loss = E.contrastive_train_step(params, cfg, opt, batch, lr=1e-2)
    assert abs(float(loss) - float(want_loss)) <= STEP_TOL * abs(float(want_loss)), (loss, want_loss)
    err_p = _close_trees(want_p, E.unshard_params(sp), STEP_TOL, "parameters")
    err_o = _close_trees(want_o, E.unshard_params(so), STEP_TOL, "momenta")
    return {
        "mesh": mesh.shape, "batch": [B, L], "loss": float(loss), "unsharded_loss": float(want_loss),
        "param_err": err_p, "momentum_err": err_o, "step_s": step_s,
    }


def _dryrun_knn(n_devices: int, device: torch.device, rng) -> None:
    from pathway_tpu_torch.ops.knn import ShardedBruteForceKnnIndex
    from pathway_tpu_torch.parallel.mesh import device_mesh

    knn_mesh = device_mesh(devices=[device] * n_devices)
    index = ShardedBruteForceKnnIndex(dimension=16, mesh=knn_mesh, axis="data")
    vecs = rng.normal(size=(64, 16)).astype(np.float32)
    for i, v in enumerate(vecs):
        index.add(i, v)
    hits = index.search(vecs[:4], k=3)
    assert [h[0][0] for h in hits] == [0, 1, 2, 3], f"self-NN mismatch: {hits}"


def _dryrun_exchange(n_devices: int, device: torch.device, rng) -> None:
    """Rows re-shard by key over the mesh, then segment-sum: equal to the
    host groupby."""
    from pathway_tpu_torch.parallel.device_exchange import exchange_by_key, join_keys_u64, split_keys_u64
    from pathway_tpu_torch.parallel.mesh import device_mesh

    knn_mesh = device_mesh(devices=[device] * n_devices)
    cap = 16
    n_rows = n_devices * cap
    ex_keys = (rng.integers(0, 12, n_rows).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) | np.uint64(1)
    ex_vals = rng.integers(0, 50, n_rows).astype(np.int32)
    o_keys, _, o_valid, (o_vals,) = exchange_by_key(
        knn_mesh, "data", split_keys_u64(ex_keys), np.ones(n_rows, dtype=np.int32), [ex_vals],
        np.ones(n_rows, dtype=bool),
    )
    kk = join_keys_u64(o_keys.cpu().numpy())
    ok = o_valid.cpu().numpy()
    got: dict = {}
    for k, v in zip(kk[ok], o_vals.cpu().numpy()[ok]):
        got[int(k)] = got.get(int(k), 0) + int(v)
    want: dict = {}
    for k, v in zip(ex_keys, ex_vals):
        want[int(k)] = want.get(int(k), 0) + int(v)
    assert got == want, "device exchange lost or invented rows"


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The dry run on ``n_devices`` logical shards of ``device`` (default:
    the card; ``"cpu"`` when asked). Raises on the first failed check;
    returns what it measured."""
    from pathway_tpu_torch._device import resolve_device

    dev = resolve_device(device)
    out = {"n_devices": n_devices, "device": str(dev)}
    out["train_step"] = _dryrun_train_step(n_devices, dev)
    rng = np.random.default_rng(0)
    _dryrun_knn(n_devices, dev, rng)
    _dryrun_exchange(n_devices, dev, rng)
    _dryrun_sharded_dataflow(n_devices)
    out["device_plane_rows"] = _dryrun_production_device_plane(min(4, n_devices))
    return out


def _dryrun_production_device_plane(n_workers: int) -> int:
    """The sharded engine with the device exchange as its routing path
    (``PATHWAY_DEVICE_EXCHANGE=on``): a groupby on ``n_workers`` equals one
    worker's and moves its rows over the device plane. Returns the rows
    exchanged."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import operators as ops
    from pathway_tpu_torch.internals.logical import LogicalNode
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.parallel.sharded import ShardedRuntime

    prev = os.environ.get("PATHWAY_DEVICE_EXCHANGE")
    os.environ["PATHWAY_DEVICE_EXCHANGE"] = "on"
    try:
        results = {}
        plane_rows = 0
        for n in (1, n_workers):
            G.clear()
            rng = np.random.default_rng(9)
            rows = list(zip(rng.integers(0, 20, 1000).tolist(), rng.integers(0, 100, 1000).tolist()))
            t = pw.debug.table_from_rows(pw.schema_from_types(k=int, v=int), rows)
            g = t.groupby(t.k).reduce(t.k, s=pw.reducers.sum(t.v), c=pw.reducers.count())
            holder = {}

            def factory():
                node = ops.CaptureNode(g.column_names())
                holder["n"] = node
                return node

            lnode = LogicalNode(factory, [g._node], name="capture")
            rt = ShardedRuntime(n_workers=n, autocommit_duration_ms=5)
            rt.run([lnode])
            results[n] = dict(holder["n"].current)
            if n > 1:
                plane_rows = rt.device_plane.rows_exchanged
            G.clear()
        assert results[1] == results[n_workers], "device-plane sharded run diverged from single-worker"
        assert plane_rows > 0, "production routing never used the device plane"
        return int(plane_rows)
    finally:
        if prev is None:
            os.environ.pop("PATHWAY_DEVICE_EXCHANGE", None)
        else:
            os.environ["PATHWAY_DEVICE_EXCHANGE"] = prev


def _build_dataflow_pipeline():
    import pathway_tpu_torch as pw

    t = pw.debug.table_from_markdown(
        """
        k | v | s | __time__ | __diff__
        1 | 3  | 10 | 2 | 1
        2 | 4  | 20 | 2 | 1
        3 | 7  | 30 | 2 | 1
        1 | 5  | 40 | 4 | 1
        1 | 3  | 10 | 6 | -1
        4 | 11 | 25 | 6 | 1
        """
    )
    d = pw.debug.table_from_rows(pw.schema_from_types(k=int, name=str), [(i, f"g{i % 2}") for i in range(1, 5)])
    j = t.join(d, t.k == d.k).select(name=d.name, v=t.v, s=t.s)
    g = j.groupby(j.name).reduce(j.name, total=pw.reducers.sum(j.v), c=pw.reducers.count())
    w = j.windowby(j.s, window=pw.temporal.tumbling(duration=15), instance=j.name).reduce(
        name=pw.this._pw_instance, start=pw.this._pw_window_start, tot=pw.reducers.sum(pw.this.v)
    )
    return g, w


def _dryrun_sharded_dataflow(n_workers: int) -> None:
    """Join + groupby + window + retractions on ``n_workers`` equal one
    worker's output."""
    from pathway_tpu_torch.debug import _capture
    from pathway_tpu_torch.internals.parse_graph import G

    results = {}
    for n in (1, n_workers):
        G.clear()
        g, w = _build_dataflow_pipeline()
        results[n] = (dict(_capture(g, n_workers=n).rows), dict(_capture(w, n_workers=n).rows))
        G.clear()
    assert results[1] == results[n_workers], f"sharded dataflow diverged from single-worker: {results}"


def main(argv=None) -> None:
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=4)
    ap.add_argument("--device", default=None, help="cpu, or a card (default: the card)")
    args = ap.parse_args(argv)
    print(json.dumps(dryrun_multichip(args.n_devices, device=args.device)))


if __name__ == "__main__":
    main()
