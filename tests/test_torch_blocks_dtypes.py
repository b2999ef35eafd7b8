"""The reference's ``tests/test_blocks_dtypes.py`` on the port, case by case:
column storage dtypes (engine.blocks.make_column).

Mirrors its 4 test functions, each a case of ``test_mirror`` under its own
name (a parametrised one once per parameter set):
test_bool_column_stays_typed_without_none,
test_bool_column_with_none_falls_back_to_object, test_int_column_typed,
test_float_column_none_becomes_nan.

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

REF = "test_blocks_dtypes"

#: the reference's test functions this file mirrors
MIRRORED = (
    "test_bool_column_stays_typed_without_none",
    "test_bool_column_with_none_falls_back_to_object",
    "test_int_column_typed",
    "test_float_column_none_becomes_nan",
)
FINAL_ONLY: set[str] = set()

#: the body's calls recorded and compared: the column each call builds
PROBES = {
    "engine.blocks.make_column": lambda col: (col.dtype.str, repr(col.tolist())),
}


@pytest.mark.parametrize("case", cases(REF))
def test_mirror(case, monkeypatch, tmp_path):
    run_case(REF, case, monkeypatch, tmp_path, final_only=case.split("[", 1)[0] in FINAL_ONLY, probes=PROBES)


def test_every_reference_test_has_a_case():
    """The reference file's test functions are the ones this file names,
    so a test added there shows up here."""
    assert tuple(reference_tests(REF)) == MIRRORED
