"""The reference's ``tests/test_expressions.py`` on the port, case by case:
expressions (arithmetic, division by zero, comparisons, if_else/coalesce,
apply, casts, the str and dt namespaces, durations, tuples, pointers, None
handling, sync and async UDFs).

Mirrors its 16 test functions, each a case of ``test_mirror`` under its own
name (a parametrised one once per parameter set):
test_arithmetic, test_division_by_zero_is_error, test_comparisons_and_bool,
test_if_else_coalesce, test_apply, test_apply_with_type_and_exceptions,
test_cast, test_str_namespace, test_parse_and_to_string, test_dt_namespace,
test_duration_ops, test_make_tuple_and_get, test_pointer_from_consistency,
test_is_none_and_unwrap, test_udf_sync, test_udf_async.

Each case runs the reference test's body unedited on ``pathway_tpu`` and
on ``pathway_tpu_torch``: the port's update streams ``(time, key, diff,
values)``, subscriber callbacks, raised exception types and error log must
equal the reference's, keys included, and the reference test's own
assertions run on the port's output (``tests/torch_mirror_helpers.py``).
Timing-dependent cases compare final rows by key (their rows land in wall-
clock ticks): test_udf_async.
"""

from __future__ import annotations

import pytest

from torch_mirror_helpers import cases, run_case, reference_tests

REF = "test_expressions"

#: the reference's test functions this file mirrors
MIRRORED = (
    "test_arithmetic",
    "test_division_by_zero_is_error",
    "test_comparisons_and_bool",
    "test_if_else_coalesce",
    "test_apply",
    "test_apply_with_type_and_exceptions",
    "test_cast",
    "test_str_namespace",
    "test_parse_and_to_string",
    "test_dt_namespace",
    "test_duration_ops",
    "test_make_tuple_and_get",
    "test_pointer_from_consistency",
    "test_is_none_and_unwrap",
    "test_udf_sync",
    "test_udf_async",
)
#: cases compared by their final rows (rows land in wall-clock ticks)
FINAL_ONLY = {"test_udf_async"}


@pytest.mark.parametrize("case", cases(REF))
def test_mirror(case, monkeypatch, tmp_path):
    run_case(REF, case, monkeypatch, tmp_path, final_only=case.split("[", 1)[0] in FINAL_ONLY)


def test_every_reference_test_has_a_case():
    """The reference file's test functions are the ones this file names,
    so a test added there shows up here."""
    assert tuple(reference_tests(REF)) == MIRRORED
