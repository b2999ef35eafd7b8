"""The reference's ``tests/test_reducers.py`` on the port, case by case:
reducers (sum/count/min/max/avg, tuples, unique/any, argmin/argmax,
earliest/latest, retractions, stateful and UDF reducers, global reduce).

Mirrors its 11 test functions, each a case of ``test_mirror`` under its own
name (a parametrised one once per parameter set):
test_basic_reducers, test_tuple_reducers, test_unique_and_any,
test_argmin_argmax, test_earliest_latest_with_stream,
test_incremental_updates_emit_retractions,
test_group_disappears_on_full_retraction, test_stateful_single,
test_udf_reducer, test_expression_over_reducers, test_global_reduce.

Each case runs the reference test's body unedited on ``pathway_tpu`` and
on ``pathway_tpu_torch``: the port's update streams ``(time, key, diff,
values)``, subscriber callbacks, raised exception types and error log must
equal the reference's, keys included, and the reference test's own
assertions run on the port's output (``tests/torch_mirror_helpers.py``).
"""

from __future__ import annotations

import pytest

from torch_mirror_helpers import cases, run_case, reference_tests

REF = "test_reducers"

#: the reference's test functions this file mirrors
MIRRORED = (
    "test_basic_reducers",
    "test_tuple_reducers",
    "test_unique_and_any",
    "test_argmin_argmax",
    "test_earliest_latest_with_stream",
    "test_incremental_updates_emit_retractions",
    "test_group_disappears_on_full_retraction",
    "test_stateful_single",
    "test_udf_reducer",
    "test_expression_over_reducers",
    "test_global_reduce",
)
FINAL_ONLY: set[str] = set()


@pytest.mark.parametrize("case", cases(REF))
def test_mirror(case, monkeypatch, tmp_path):
    run_case(REF, case, monkeypatch, tmp_path, final_only=case.split("[", 1)[0] in FINAL_ONLY)


def test_every_reference_test_has_a_case():
    """The reference file's test functions are the ones this file names,
    so a test added there shows up here."""
    assert tuple(reference_tests(REF)) == MIRRORED
