"""On-device key-shard exchange for relational blocks (SURVEY §5.8 end state).

Carried from ``pathway_tpu/parallel/device_exchange.py``, where the exchange
is an XLA function (``shard_map`` over a mesh with one ``lax.all_to_all``);
here it is torch ops over the logical shards of a
:class:`~pathway_tpu_torch.parallel.mesh.DeviceMesh`. NUMERIC column blocks
are re-sharded **on device**: rows move as dense tensors, with the shard
function identical to the host plane — both go through the ONE placement
authority ``internals/keys.shard_of_keys`` (low key bits mod worker count,
``shard.rs`` parity). The modulo below is the ``dest=None`` fast path only;
callers with their own placement pass explicit ``dest``.

Shape discipline (as in the reference): every shard holds a fixed
``capacity``-row block with a validity mask; each source shard buckets its
rows by destination into an ``(n_shards, capacity)`` staging tensor (stable
position within the bucket; invalid rows go to a discarded bucket); the
exchange hands block ``[src, dst]`` to shard ``dst``; the output stays padded
at ``n_shards*capacity`` rows per shard with a validity mask. Where every
shard sits on one device, the exchange is one permutation of the staging
tensor on that device; where shards sit on distinct devices, blocks are
copied between devices. No ``torch.distributed`` collective is involved: the
reference's exchange also stays within one process's mesh (cross-process rows
take the cluster's TCP links, ``parallel/device_plane.py``).

The fused variant nets in-flight churn after the exchange: per destination,
a lexsort by (valid, key, digest) from successive stable sorts, a segment sum
of the diffs, and every (key, digest) group whose diffs sum to ZERO comes
back invalidated. Groups with a nonzero net keep ALL their rows, original
diffs and arrival positions (join arrangements carry multiplicity as physical
rows), so the output equals the plain exchange minus cancelled groups.
"""

from __future__ import annotations

import numpy as np
import torch

from pathway_tpu_torch.internals.keys import SHARD_MASK
from pathway_tpu_torch.observability import device as _dev_prof

#: unsigned dtypes staged through their signed view of the same width (torch
#: indexes and fills these only through such a view)
_SIGNED_VIEW = {
    torch.uint16: torch.int16,
    torch.uint32: torch.int32,
    torch.uint64: torch.int64,
}


def _tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _signed(t: torch.Tensor) -> torch.Tensor:
    v = _SIGNED_VIEW.get(t.dtype)
    return t if v is None else t.view(v)


def _stage(shard: torch.Tensor, arrs: list[torch.Tensor], n: int) -> list[torch.Tensor]:
    """Bucket each source shard's rows by destination.

    ``shard`` is ``[S, cap]`` int64 destinations in ``[0, n]`` (``n`` = the
    discarded bucket of invalid rows). Returns each array staged as
    ``[S, n, cap, ...]``: row ``i`` of source ``s`` lands at
    ``[s, shard[s, i], pos]`` with ``pos`` its stable position among the
    source's rows of that destination; unfilled slots are zero."""
    s_n, cap = shard.shape
    dev = shard.device
    onehot = (shard[:, None, :] == torch.arange(n + 1, device=dev)[None, :, None]).to(torch.int32)
    pos_all = torch.cumsum(onehot, dim=2, dtype=torch.int32) - 1
    pos = torch.gather(pos_all, 1, shard[:, None, :])[:, 0, :].long()
    src = torch.arange(s_n, device=dev)[:, None].expand(s_n, cap)
    idx = (src.reshape(-1), shard.reshape(-1), pos.reshape(-1))
    out = []
    for a in arrs:
        a = _signed(a)
        buf = torch.zeros((s_n, n + 1, cap) + tuple(a.shape[2:]), dtype=a.dtype, device=dev)
        buf.index_put_(idx, a.reshape((s_n * cap,) + tuple(a.shape[2:])))
        out.append(buf[:, :n])
    return out


def _destinations(hi_lo: torch.Tensor, valid: torch.Tensor, dest, n: int) -> torch.Tensor:
    """``[S, cap]`` destination per row: explicit ``dest`` or the key's low
    shard bits modulo ``n``; invalid rows go to bucket ``n``."""
    if dest is not None:
        shard = dest.long()
    else:
        lo = hi_lo[1].long() & 0xFFFFFFFF
        shard = (lo & (SHARD_MASK & 0xFFFFFFFF)) % n
    return torch.where(valid, shard, torch.full_like(shard, n))


def _consolidate(hi, lo, dhi, dlo, diff, valid) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused netting over ``[D, L]`` received rows (one row of the batch per
    destination): invalidate every (key, digest) group whose diffs sum to 0."""
    d_n, length = hi.shape
    order = torch.arange(length, device=hi.device).expand(d_n, length)
    inv = (~valid).long()
    # lexsort by (inv, hi, lo, dhi, dlo): stable sorts, least significant first
    for key in (dlo, dhi, lo, hi, inv):
        _, o = torch.sort(torch.gather(key, 1, order), dim=1, stable=True)
        order = torch.gather(order, 1, o)
    g = lambda x: torch.gather(x, 1, order)  # noqa: E731
    hi_s, lo_s, dhi_s, dlo_s = g(hi), g(lo), g(dhi), g(dlo)
    v_s, d_s = g(valid), g(diff.long())
    same_prev = (
        (hi_s[:, 1:] == hi_s[:, :-1])
        & (lo_s[:, 1:] == lo_s[:, :-1])
        & (dhi_s[:, 1:] == dhi_s[:, :-1])
        & (dlo_s[:, 1:] == dlo_s[:, :-1])
        & (v_s[:, 1:] == v_s[:, :-1])
    )
    newg = torch.cat([torch.ones((d_n, 1), dtype=torch.bool, device=hi.device), ~same_prev], dim=1)
    seg = torch.cumsum(newg.long(), dim=1) - 1
    sums = torch.zeros((d_n, length), dtype=torch.int64, device=hi.device).scatter_add_(1, seg, d_s)
    keep_s = v_s & (torch.gather(sums, 1, seg) != 0)
    out_valid = torch.zeros_like(valid).scatter_(1, order, keep_s)
    out_diff = torch.where(out_valid, diff, torch.zeros_like(diff))
    return out_diff, out_valid


def _exchange_blocks(keys, diffs, valid, cols, dest, dig, n: int):
    """The exchange over ``[S, cap]`` source blocks all on one device.
    Returns ``[n, n*cap]`` received blocks (keys as ``[2, n, n*cap]``)."""
    s_n, cap = valid.shape
    shard = _destinations(keys, valid, dest, n)
    arrs = [keys[0], keys[1], diffs, valid] + list(cols)
    if dig is not None:
        arrs += [dig[0], dig[1]]
    staged = _stage(shard, arrs, n)
    # block [src, dst] → shard dst: one permutation of the staging tensor
    recv = [
        s.transpose(0, 1).reshape((n, s_n * cap) + tuple(s.shape[3:])) for s in staged
    ]
    return recv


def _unview(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.view(dtype) if t.dtype != dtype else t


def exchange_by_key_shards(mesh, axis: str, keys, diffs, cols, valid, dest=None, dig=None):
    """:func:`exchange_by_key` with the output left per shard: a list with,
    for each shard ``d``, ``(keys [2, n*cap], diffs, valid, cols)`` on shard
    ``d``'s device."""
    devices = mesh.shard_devices(axis)
    n = len(devices)
    fn = _FUSED if dig is not None else _ALL_TO_ALL
    return fn(devices, n, keys, diffs, cols, valid, dest, dig)


@torch.inference_mode()
def _exchange_impl(devices, n, keys, diffs, cols, valid, dest, dig):
    first = devices[0]
    total = int(np.shape(valid)[0])
    if total % n:
        raise ValueError(f"{total} rows do not split into {n} equal shard blocks")
    cap = total // n
    col_dtypes = [
        c.dtype if isinstance(c, torch.Tensor) else torch.from_numpy(np.zeros(0, c.dtype)).dtype
        for c in cols
    ]
    one_device = all(d == first for d in devices)
    if one_device:
        place = lambda x: None if x is None else _tensor(x, first)  # noqa: E731
        k = _signed(place(keys)).long() & 0xFFFFFFFF
        k = k.reshape(2, n, cap)
        dg = None if dig is None else (_signed(place(dig)).long() & 0xFFFFFFFF).reshape(2, n, cap)
        ds = None if dest is None else place(dest).reshape(n, cap)
        recv = _exchange_blocks(
            k,
            place(diffs).reshape(n, cap),
            place(valid).reshape(n, cap),
            [place(c).reshape((n, cap) + tuple(np.shape(c)[1:])) for c in cols],
            ds,
            dg,
            n,
        )
        per_dest = [[r[d] for r in recv] for d in range(n)]
    else:
        # shards on distinct devices: stage on each source's device, then copy
        # each [src, dst] block to the destination's device
        staged_by_src = []
        for s, dev in enumerate(devices):
            sl = slice(s * cap, (s + 1) * cap)
            k = (_signed(_tensor(keys[:, sl], dev)).long() & 0xFFFFFFFF)[:, None, :]
            take = lambda x, dev=dev, sl=sl: None if x is None else _tensor(x[sl], dev)  # noqa: E731
            dg = None
            if dig is not None:
                dg = (_signed(_tensor(dig[:, sl], dev)).long() & 0xFFFFFFFF)[:, None, :]
            ds = None if dest is None else take(dest)[None, :]
            staged_by_src.append(
                _exchange_blocks(
                    k, take(diffs)[None, :], take(valid)[None, :],
                    [take(c)[None] for c in cols], ds, dg, n,
                )
            )
        per_dest = []
        for d, dev in enumerate(devices):
            per_dest.append(
                [
                    torch.cat([staged_by_src[s][j][d].to(dev) for s in range(n)])
                    for j in range(len(staged_by_src[0]))
                ]
            )
    out = []
    n_cols = len(cols)
    for d, parts in enumerate(per_dest):
        hi, lo, diff, val = parts[0], parts[1], parts[2], parts[3]
        cs = parts[4 : 4 + n_cols]
        if dig is not None:
            diff, val = _consolidate(
                hi[None], lo[None], parts[4 + n_cols][None], parts[5 + n_cols][None],
                diff[None], val[None],
            )
            diff, val = diff[0], val[0]
        out.append((_u32(torch.stack([hi, lo])), diff, val, [_unview(c, dt) for c, dt in zip(cs, col_dtypes)]))
    return out


#: the device plane's accounting labels, as in the reference
_ALL_TO_ALL = _dev_prof.traced_jit("device_exchange.all_to_all", _exchange_impl)
_FUSED = _dev_prof.traced_jit("device_exchange.fused_consolidate", _exchange_impl)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values → uint32 of the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32).view(torch.uint32)


def exchange_by_key(mesh, axis: str, keys, diffs, cols, valid, dest=None, dig=None):
    """Re-shard padded per-shard blocks so every row lands on the shard owning
    its key shard (host-plane parity: ``internals/keys.shard_of_keys``,
    re-exported as ``mesh.shard_of_keys``).

    Inputs are GLOBAL arrays (numpy or torch) laid out shard after shard on
    their first dim (``cap`` rows each): ``keys`` uint32 (2, n_shards*cap) as
    (hi, lo) pairs, ``diffs`` int32, ``valid`` bool, ``cols`` list of numeric
    arrays. Returns the same structure with per-shard row counts expanded to
    ``n_shards*cap`` (masked), as torch tensors on the first shard's device.

    ``dest`` (int32, optional) routes each row to an explicit shard index
    instead of its key-shard — the cluster plane uses this to map GLOBAL
    worker shards onto the process-local mesh.

    ``dig`` (uint32 (2, n) row-digest pairs, optional) selects the FUSED
    consolidate+exchange: (key, digest) groups whose diffs net to zero are
    invalidated after the exchange; surviving rows keep their original diffs
    and arrival positions.
    """
    per = exchange_by_key_shards(mesh, axis, keys, diffs, cols, valid, dest=dest, dig=dig)
    first = per[0][1].device
    keys_out = torch.cat([p[0].to(first) for p in per], dim=1)
    diffs_out = torch.cat([p[1].to(first) for p in per])
    valid_out = torch.cat([p[2].to(first) for p in per])
    cols_out = [torch.cat([p[3][j].to(first) for p in per]) for j in range(len(cols))]
    return keys_out, diffs_out, valid_out, cols_out


def split_keys_u64(keys: np.ndarray) -> np.ndarray:
    """uint64 host keys → (2, n) uint32 (hi, lo) device representation."""
    k = keys.astype(np.uint64)
    return np.stack(
        [(k >> np.uint64(32)).astype(np.uint32), (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)]
    )


def join_keys_u64(pairs) -> np.ndarray:
    pairs = np.asarray(pairs)
    return (pairs[0].astype(np.uint64) << np.uint64(32)) | pairs[1].astype(np.uint64)
