"""The reference's ``tests/test_joins.py`` on the port, case by case:
joins (inner, left, right, outer, multi-condition and expression keys, this-
resolution, select star, incremental streams, pad flips, filter, reduce,
id=left).

Mirrors its 13 test functions, each a case of ``test_mirror`` under its own
name (a parametrised one once per parameter set):
test_inner_join, test_left_join, test_right_join, test_outer_join,
test_join_multi_condition, test_join_expression_keys,
test_join_this_resolution, test_join_select_star,
test_incremental_join_stream, test_left_join_pad_flips_incrementally,
test_join_filter, test_join_reduce, test_join_id_left.

Each case runs the reference test's body unedited on ``pathway_tpu`` and
on ``pathway_tpu_torch``: the port's update streams ``(time, key, diff,
values)``, subscriber callbacks, raised exception types and error log must
equal the reference's, keys included, and the reference test's own
assertions run on the port's output (``tests/torch_mirror_helpers.py``).
"""

from __future__ import annotations

import pytest

from torch_mirror_helpers import cases, run_case, reference_tests

REF = "test_joins"

#: the reference's test functions this file mirrors
MIRRORED = (
    "test_inner_join",
    "test_left_join",
    "test_right_join",
    "test_outer_join",
    "test_join_multi_condition",
    "test_join_expression_keys",
    "test_join_this_resolution",
    "test_join_select_star",
    "test_incremental_join_stream",
    "test_left_join_pad_flips_incrementally",
    "test_join_filter",
    "test_join_reduce",
    "test_join_id_left",
)
FINAL_ONLY: set[str] = set()


@pytest.mark.parametrize("case", cases(REF))
def test_mirror(case, monkeypatch, tmp_path):
    run_case(REF, case, monkeypatch, tmp_path, final_only=case.split("[", 1)[0] in FINAL_ONLY)


def test_every_reference_test_has_a_case():
    """The reference file's test functions are the ones this file names,
    so a test added there shows up here."""
    assert tuple(reference_tests(REF)) == MIRRORED
