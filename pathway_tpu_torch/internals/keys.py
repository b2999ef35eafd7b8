"""Stable 64-bit key hashing: the part of ``pathway_tpu/internals/keys.py``
that the KNN tie-break needs, copied so the port never imports the JAX
package. ``tie_order`` here is bit-identical to the reference's under the same
``PATHWAY_HASH_SALT``, so both packages break equal scores the same way.
(The reference's C ``pwhash`` kernel only speeds up whole object columns; the
pure-Python ``_pwhash_bytes`` is its bit-identical mirror and is all a
per-key tie order needs.)
"""

from __future__ import annotations

import hashlib
import os
import struct
from typing import Any

import numpy as np

_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_U64_MASK = 0xFFFFFFFFFFFFFFFF
_NONE_SEED = 0xA5C9


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over uint64 arrays."""
    with np.errstate(over="ignore"):
        x = (x + _GOLDEN).astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * _M1
        x = (x ^ (x >> np.uint64(27))) * _M2
        x = x ^ (x >> np.uint64(31))
    return x


def _splitmix64_int(x: int) -> int:
    """Scalar splitmix64 over Python ints, bit-identical to :func:`splitmix64`."""
    x = (x + 0x9E3779B97F4A7C15) & _U64_MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _U64_MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _U64_MASK
    return x ^ (x >> 31)


# Deployment-stable salt: unset means no salt. It must be the same on every
# process of a deployment, and the same as the JAX package sees, for the two
# packages' tie orders to agree.
_HASH_SALT = (
    _splitmix64_int(int(os.environ["PATHWAY_HASH_SALT"]) & _U64_MASK)
    if "PATHWAY_HASH_SALT" in os.environ
    else 0
)
_SALT_U64 = np.uint64(_HASH_SALT)
_SALT_KEY = _HASH_SALT.to_bytes(8, "little") if _HASH_SALT else b""


def _salted(bits: np.ndarray) -> np.ndarray:
    return bits ^ _SALT_U64 if _HASH_SALT else bits


def _canonical_bytes(v: Any) -> bytes:
    """Canonical encoding of a value for the blake2b fallback of
    :func:`stable_hash_obj` (tuples, lists, arrays, arbitrary objects)."""
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
    return b"\x0A" + repr(v).encode("utf-8")


def _pwhash_bytes(b: bytes, tag: int) -> int:
    """splitmix64 over zero-padded little-endian 8-byte chunks, seeded with a
    type tag and the length."""
    n = len(b)
    h = _splitmix64_int(tag ^ _HASH_SALT ^ n)
    full = n - (n % 8)
    for i in range(0, full, 8):
        h = _splitmix64_int(h ^ int.from_bytes(b[i : i + 8], "little"))
    if full < n:
        h = _splitmix64_int(h ^ int.from_bytes(b[full:], "little"))
    return h


def stable_hash_obj(v: Any) -> np.uint64:
    """Stable 64-bit hash of one value (same bits as the reference's)."""
    if v is None:
        return np.uint64(_splitmix64_int(_splitmix64_int(_NONE_SEED ^ _HASH_SALT)))
    # datetime64/timedelta64 before the integer branch: timedelta64 subclasses
    # np.signedinteger
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
    digest = hashlib.blake2b(_canonical_bytes(v), digest_size=8, key=_SALT_KEY).digest()
    return np.uint64(int.from_bytes(digest, "little"))


def tie_order(key: Any) -> int:
    """Canonical total order on doc keys for score-tie breaking: hash order,
    so the KNN's 30-bit composite tie-break is a true prefix of it for every
    key type, small integers included."""
    return int(stable_hash_obj(key))


def tie_order_u64(keys: np.ndarray) -> np.ndarray:
    """Vectorized :func:`tie_order` for integer key arrays."""
    return splitmix64(_salted(keys.astype(np.uint64)))
