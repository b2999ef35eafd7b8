"""Stable 64-bit row keys and vectorized hashing.

The reference keys every row with a 128-bit xxh3 ``Key`` whose low 16 bits pick the
worker shard (``src/engine/value.rs:41,38``, ``src/engine/dataflow/shard.rs:15-20``).
Here keys are uint64 (numpy-native, JAX-native) produced by a splitmix64-style mixer
for numeric columns — fully vectorized over column blocks — and a blake2b(8) digest
for object columns. The low ``SHARD_BITS`` bits still select the shard so device
placement over a mesh axis is a bitmask, exactly as in the reference.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Any, Iterable

import numpy as np

SHARD_BITS = 16
SHARD_MASK = np.uint64((1 << SHARD_BITS) - 1)

_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over uint64 arrays."""
    with np.errstate(over="ignore"):
        x = (x + _GOLDEN).astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * _M1
        x = (x ^ (x >> np.uint64(27))) * _M2
        x = x ^ (x >> np.uint64(31))
    return x


def _mix2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        return splitmix64(a * np.uint64(0x100000001B3) ^ b)


def _canonical_bytes(v: Any) -> bytes:
    """Canonical encoding for stable cross-run hashing of scalar values."""
    if v is None:
        return b"\x00N"
    if isinstance(v, bool) or isinstance(v, np.bool_):
        return b"\x01" + (b"1" if v else b"0")
    if isinstance(v, (int, np.integer)):
        iv = int(v)
        if -(2**63) <= iv < 2**63:
            return b"\x02" + struct.pack("<q", iv)
        return b"\x02" + struct.pack("<Q", iv & 0xFFFFFFFFFFFFFFFF)
    if isinstance(v, (float, np.floating)):
        f = float(v)
        if f == 0.0:
            f = 0.0  # normalize -0.0
        return b"\x03" + struct.pack("<d", f)
    if isinstance(v, str):
        return b"\x04" + v.encode("utf-8")
    if isinstance(v, bytes):
        return b"\x05" + v
    if isinstance(v, np.datetime64):
        return b"\x07" + struct.pack("<q", v.astype("datetime64[ns]").astype(np.int64))
    if isinstance(v, np.timedelta64):
        return b"\x08" + struct.pack("<q", v.astype("timedelta64[ns]").astype(np.int64))
    if isinstance(v, np.ndarray):
        return b"\x09" + v.tobytes() + str(v.shape).encode()
    if isinstance(v, (tuple, list)):
        out = [b"\x06", struct.pack("<i", len(v))]
        for item in v:
            b = _canonical_bytes(item)
            out.append(struct.pack("<i", len(b)))
            out.append(b)
        return b"".join(out)
    # Json / arbitrary objects
    return b"\x0A" + repr(v).encode("utf-8")


_U64_MASK = 0xFFFFFFFFFFFFFFFF


def _splitmix64_int(x: int) -> int:
    """Scalar splitmix64 over native Python ints — bit-identical to
    :func:`splitmix64` but without numpy array/errstate overhead."""
    x = (x + 0x9E3779B97F4A7C15) & _U64_MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _U64_MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _U64_MASK
    return x ^ (x >> 31)


_NONE_SEED = 0xA5C9

# Deployment-stable salt for key hashing. pwhash64 is a fast NON-
# CRYPTOGRAPHIC hash (like the reference engine's key hashing): with the
# default salt an adversary who fully controls input keys can engineer
# collisions. Deployments ingesting untrusted keys can set PATHWAY_HASH_SALT
# to make the chain unpredictable; it must be identical on every process of a
# cluster and across restarts of a persisted pipeline. The salt covers every
# value-derived path — str/bytes (seed), int/float/bool/datetime (pre-mix
# xor, scalar AND vectorized), None, and the blake2b fallback (keyed) — and
# is a no-op when unset, so default-salt hashes are unchanged.
import os as _os

_HASH_SALT = (
    _splitmix64_int(int(_os.environ["PATHWAY_HASH_SALT"]) & _U64_MASK)
    if "PATHWAY_HASH_SALT" in _os.environ
    else 0
)
_SALT_U64 = np.uint64(_HASH_SALT)
_SALT_KEY = _HASH_SALT.to_bytes(8, "little") if _HASH_SALT else b""


def _salted(bits: np.ndarray) -> np.ndarray:
    """XOR the salt into a uint64 array — identity (no extra array pass on the
    hot per-tick hashing path) when no salt is configured."""
    return bits ^ _SALT_U64 if _HASH_SALT else bits


def _pwhash_bytes(b: bytes, tag: int) -> int:
    """splitmix64 over zero-padded little-endian 8-byte chunks, seeded with a
    type tag and the length — the pure-Python mirror of
    ``native/pwhash.c::pwhash_bytes`` (the two MUST stay bit-identical)."""
    n = len(b)
    h = _splitmix64_int(tag ^ _HASH_SALT ^ n)
    full = n - (n % 8)
    for i in range(0, full, 8):
        h = _splitmix64_int(h ^ int.from_bytes(b[i : i + 8], "little"))
    if full < n:
        h = _splitmix64_int(h ^ int.from_bytes(b[full:], "little"))
    return h


def stable_hash_obj(v: Any) -> np.uint64:
    # Scalars that can also live in typed numpy columns MUST hash identically to
    # hash_column's vectorized paths — join/group keys may see the same value in
    # either storage (e.g. int64 column on one side, object column on the other).
    if v is None:
        # double-mixed so the colliding integer pre-image is a pseudo-random
        # 64-bit value, not the small literal 0xA5C9
        return np.uint64(_splitmix64_int(_splitmix64_int(_NONE_SEED ^ _HASH_SALT)))
    # datetime64/timedelta64 must precede the integer branch: timedelta64
    # subclasses np.signedinteger, and int() of a non-ns timedelta64 raises
    if isinstance(v, np.datetime64):
        ns = int(v.astype("datetime64[ns]").astype(np.int64))
        return np.uint64(_splitmix64_int((ns ^ _HASH_SALT) & _U64_MASK))
    if isinstance(v, np.timedelta64):
        ns = int(v.astype("timedelta64[ns]").astype(np.int64))
        return np.uint64(_splitmix64_int((ns ^ _HASH_SALT) & _U64_MASK))
    if isinstance(v, (bool, np.bool_, int, np.integer)):
        return np.uint64(_splitmix64_int((int(v) ^ _HASH_SALT) & _U64_MASK))
    if isinstance(v, (float, np.floating)):
        f = np.float64(v) + 0.0  # normalize -0.0
        return np.uint64(_splitmix64_int(int(f.view(np.uint64)) ^ _HASH_SALT))
    if isinstance(v, str):
        return np.uint64(_pwhash_bytes(v.encode("utf-8"), 0x04))
    if isinstance(v, bytes):
        return np.uint64(_pwhash_bytes(v, 0x05))
    digest = hashlib.blake2b(
        _canonical_bytes(v), digest_size=8, key=_SALT_KEY
    ).digest()
    return np.uint64(int.from_bytes(digest, "little"))


_hash_obj_ufunc = np.frompyfunc(stable_hash_obj, 1, 1)

# C kernel for the object-column loop (lazily built; None -> pure Python)
from pathway_tpu_torch.native import try_load as _try_load_native  # noqa: E402

_pwhash_native = _try_load_native("pwhash")

_INT_TYPES = (bool, np.bool_, int, np.int64, np.int32, np.intp)
_FLOAT_TYPES = (float, np.float64, np.float32)


def hash_column(col: np.ndarray) -> np.ndarray:
    """Vectorized stable hash of one column → uint64 array."""
    kind = col.dtype.kind
    if kind in ("i", "u", "b"):
        return splitmix64(_salted(col.astype(np.uint64, copy=False)))
    if kind == "f":
        # normalize -0.0 → 0.0 so equal floats hash equal
        c = col + 0.0
        bits = c.view(np.uint64) if c.dtype == np.float64 else c.astype(np.float64).view(np.uint64)
        return splitmix64(_salted(bits))
    if kind == "M":
        # normalize to ns so equal instants in different units hash equal (and
        # match stable_hash_obj / _canonical_bytes)
        return splitmix64(_salted(col.astype("datetime64[ns]").astype(np.int64).astype(np.uint64)))
    if kind == "m":
        return splitmix64(_salted(col.astype("timedelta64[ns]").astype(np.int64).astype(np.uint64)))
    if kind == "O" and len(col) > 16:
        # homogeneous-scalar fast path: coerce to a typed array and take the
        # vectorized branch (they hash identically by construction)
        types = {type(v) for v in col}
        try:
            if types and all(issubclass(t, _INT_TYPES) for t in types):
                return splitmix64(_salted(col.astype(np.int64).astype(np.uint64)))
            if types and all(issubclass(t, _FLOAT_TYPES) for t in types):
                c = col.astype(np.float64) + 0.0
                return splitmix64(_salted(c.view(np.uint64)))
        except (TypeError, ValueError, OverflowError):
            pass
    if _pwhash_native is not None:
        return _pwhash_native.hash_obj_array(col, stable_hash_obj, _HASH_SALT)
    return _hash_obj_ufunc(col).astype(np.uint64)


def row_keys(columns: Iterable[np.ndarray], n: int | None = None, salt: int = 0) -> np.ndarray:
    """Combine per-column hashes into row keys (order-sensitive)."""
    cols = list(columns)
    if not cols:
        assert n is not None
        return splitmix64(np.arange(n, dtype=np.uint64) + np.uint64(salt))
    h = np.full(len(cols[0]), np.uint64(salt) ^ np.uint64(0xA076_1D64_78BD_642F), dtype=np.uint64)
    for c in cols:
        h = _mix2(h, hash_column(np.asarray(c)))
    return h


def ref_scalar(*values: Any, salt: int = 0) -> np.uint64:
    """Key for a single row from its id-column values (``pw.Table.pointer_from``)."""
    if not values:
        return splitmix64(np.asarray([salt], dtype=np.uint64))[0]
    cols = [np.asarray([v]) if not isinstance(v, str) else np.asarray([v], dtype=object) for v in values]
    return row_keys(cols, salt=salt)[0]


def tie_order(key: Any) -> int:
    """Canonical total order on doc keys for score-tie breaking, shared by the
    KNN kernels, host-side decode, BM25/hybrid ranking, and the sharded-index
    reply merge. Hash order (not numeric order): uniform high bits for EVERY
    key type, so the device kernels' 30-bit composite tie-break is a true
    prefix of this order even for small integer keys (numeric order has empty
    top bits there and would degrade to slot order on device)."""
    return int(stable_hash_obj(key))


def tie_order_u64(keys: np.ndarray) -> np.ndarray:
    """Vectorized :func:`tie_order` for uint64/int key arrays (bit-identical
    to ``stable_hash_obj`` on python ints)."""
    return splitmix64(_salted(keys.astype(np.uint64)))


def combine_keys(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Key for pairs of rows (join outputs: key(left,right) — analogous to the
    reference deriving join ids from both side ids)."""
    return _mix2(a.astype(np.uint64), b.astype(np.uint64))


def shard_of(keys: np.ndarray) -> np.ndarray:
    return (keys & SHARD_MASK).astype(np.int32)


def shard_of_keys(
    keys: np.ndarray, n_shards: int, shard_map=None
) -> np.ndarray:
    """THE worker-placement formula — every layer (host exchange in
    ``parallel/cluster``/``parallel/sharded``, the device exchange dest in
    ``parallel/device_plane``, elastic rebucketing in ``elastic/reshard``, and
    fabric door routing in ``fabric/routing``) routes keys through this one
    helper so the ownership rule cannot drift between layers.

    Default rule (reference ``shard.rs:15-20`` parity): low ``SHARD_BITS`` of
    the key modulo the worker count. When a versioned shard map is passed
    (``internals/shardmap.ShardMap``, the ``PATHWAY_SHARDMAP`` plane), ownership
    is its segment table instead — contiguous residue ranges per worker, so a
    rescale moves only re-mapped ranges instead of re-dealing every residue.
    """
    if shard_map is not None:
        return shard_map.owner_of_keys(keys)
    return ((keys.astype(np.uint64, copy=False) & SHARD_MASK) % np.uint64(n_shards)).astype(
        np.int32
    )


def sequential_keys(start: int, n: int, salt: int = 0) -> np.ndarray:
    return splitmix64(np.arange(start, start + n, dtype=np.uint64) ^ np.uint64(salt))
