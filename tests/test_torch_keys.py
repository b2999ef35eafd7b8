"""The port's row keys against the JAX package's, bit for bit.

Every key the engine emits comes from these functions, so the parity tests of
the engine compare keys exactly only if these agree. The port's object-column
hash runs through its own build of ``native/pwhash.c`` and through the
pure-Python mirror; both must give the reference's bits.
"""

from __future__ import annotations

import numpy as np
import pytest

from pathway_tpu.internals import keys as J
from pathway_tpu_torch.internals import keys as T

_PTR = int(J.ref_scalar("doc", 7))  # a row key, as Pointer columns hold them

_OBJECT_VALUES = [
    0, 1, -1, 2**63 - 1, -(2**63), 2**64 - 1, True, False,
    0.0, -0.0, 1.5, -2.25, float("inf"), float("nan"),
    "", "a", "héllo wörld", "x" * 17,
    b"", b"\x00\x01", b"bytes of some length",
    None, (1, "a"), (None, (2.5, b"z")), (),
    np.uint64(_PTR), _PTR, np.int64(-5), np.float32(0.5),
]


@pytest.fixture(params=["native", "python"])
def port_keys(request, monkeypatch):
    """The port's keys module with its C object-column kernel, or without."""
    if request.param == "native":
        if T._pwhash_native is None:
            pytest.fail("the port's native pwhash did not build (a C compiler is present here)")
    else:
        monkeypatch.setattr(T, "_pwhash_native", None)
    return T


def _object_col(values) -> np.ndarray:
    col = np.empty(len(values), dtype=object)
    col[:] = values
    return col


def _typed_columns() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    return {
        "int64": rng.integers(-(2**62), 2**62, 50),
        "uint64_high": np.array([2**63, 2**64 - 1, 0, 1, 2**63 + 5], dtype=np.uint64),
        "float64": rng.normal(size=50),
        "float32": rng.normal(size=50).astype(np.float32),
        "bool": rng.integers(0, 2, 50).astype(bool),
        "neg_zero": np.array([0.0, -0.0, 1.0]),
        "datetime": np.array(["2026-01-01T00:00:00", "1999-12-31T23:59:59"], dtype="datetime64[s]"),
        "timedelta": np.array([1, -3, 0], dtype="timedelta64[ms]"),
        "long_ints_as_objects": _object_col([int(x) for x in range(40)]),
        "long_floats_as_objects": _object_col([x / 3 for x in range(40)]),
    }


@pytest.mark.parametrize("name", sorted(_typed_columns()))
def test_hash_column_typed(name, port_keys):
    col = _typed_columns()[name]
    np.testing.assert_array_equal(port_keys.hash_column(col), J.hash_column(col))


def test_hash_column_objects(port_keys):
    col = _object_col(_OBJECT_VALUES)
    got = port_keys.hash_column(col)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, J.hash_column(col))


def test_stable_hash_obj_each_value():
    for v in _OBJECT_VALUES:
        assert T.stable_hash_obj(v) == J.stable_hash_obj(v), v


def test_row_keys_and_combine(port_keys):
    cols = [
        _object_col(["a", "b", None, "a"]),
        np.array([1, 2, 3, 1]),
        np.array([0.5, -0.0, 2.0, 0.5]),
        _object_col([(1, 2), b"x", _PTR, None]),
    ]
    for salt in (0, 7, 2**63 + 1):
        np.testing.assert_array_equal(
            port_keys.row_keys(cols, salt=salt), J.row_keys(cols, salt=salt)
        )
    np.testing.assert_array_equal(port_keys.row_keys([], n=5), J.row_keys([], n=5))
    a = J.row_keys(cols[:1])
    b = J.sequential_keys(3, 4)
    np.testing.assert_array_equal(port_keys.combine_keys(a, b), J.combine_keys(a, b))
    np.testing.assert_array_equal(port_keys.sequential_keys(3, 4, salt=9), J.sequential_keys(3, 4, salt=9))


@pytest.mark.parametrize(
    "values",
    [(), (1,), ("doc", 7), (None,), (b"raw", -1.5), ((1, "t"),), (np.uint64(_PTR),), (2**64 - 1,)],
)
def test_ref_scalar(values):
    assert T.ref_scalar(*values) == J.ref_scalar(*values)
    assert T.ref_scalar(*values, salt=3) == J.ref_scalar(*values, salt=3)


def test_shard_placement():
    keys = J.row_keys([np.arange(100)])
    np.testing.assert_array_equal(T.shard_of(keys), J.shard_of(keys))
    for n in (1, 3, 8):
        np.testing.assert_array_equal(T.shard_of_keys(keys, n), J.shard_of_keys(keys, n))
