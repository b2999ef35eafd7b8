"""The reference's ``tests/test_core_types.py`` on the port, case by case:
the dtype lattice, key hashing and schemas.

Mirrors its 10 test functions, each a case of ``test_mirror`` under its own
name (a parametrised one once per parameter set):
test_wrap_basic, test_optional_collapse, test_subtype, test_lca,
test_key_hash_deterministic_and_vectorized, test_key_hash_int_float_equal,
test_shard_bits, test_schema_class, test_schema_algebra,
test_schema_from_dict.

Each case runs the reference test's body unedited on ``pathway_tpu`` and
on ``pathway_tpu_torch``: the port's update streams ``(time, key, diff,
values)``, subscriber callbacks, raised exception types and error log must
equal the reference's, keys included, and the reference test's own
assertions run on the port's output (``tests/torch_mirror_helpers.py``).
These tests build no table: the values the body's calls return (probes)
are recorded and compared between the packages.
"""

from __future__ import annotations

import pytest

from torch_mirror_helpers import cases, run_case, reference_tests

REF = "test_core_types"

#: the reference's test functions this file mirrors
MIRRORED = (
    "test_wrap_basic",
    "test_optional_collapse",
    "test_subtype",
    "test_lca",
    "test_key_hash_deterministic_and_vectorized",
    "test_key_hash_int_float_equal",
    "test_shard_bits",
    "test_schema_class",
    "test_schema_algebra",
    "test_schema_from_dict",
)
FINAL_ONLY: set[str] = set()

#: the body's calls recorded and compared: the dtype lattice and key hashing
PROBES = {
    "internals.dtype.wrap": repr,
    "internals.dtype.types_lca": repr,
    "internals.dtype.is_subtype": bool,
    "internals.keys.hash_column": lambda a: a.tolist(),
    "internals.keys.row_keys": lambda a: [int(x) for x in a],
    "internals.keys.ref_scalar": int,
    "internals.keys.sequential_keys": lambda a: a.tolist(),
    "internals.keys.shard_of": lambda a: a.tolist(),
}


@pytest.mark.parametrize("case", cases(REF))
def test_mirror(case, monkeypatch, tmp_path):
    run_case(REF, case, monkeypatch, tmp_path, final_only=case.split("[", 1)[0] in FINAL_ONLY, probes=PROBES)


def test_every_reference_test_has_a_case():
    """The reference file's test functions are the ones this file names,
    so a test added there shows up here."""
    assert tuple(reference_tests(REF)) == MIRRORED
