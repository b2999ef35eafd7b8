"""The reference's ``tests/test_engine_perf_paths.py`` on the port, case by case:
the vectorized first-load paths against the incremental ones (joins and
groupbys fed by a live subject, datetime group values, outer-join padding,
columnar groupbys).

Mirrors its 9 test functions, each a case of ``test_mirror`` under its own
name (a parametrised one once per parameter set):
test_join_groupby_first_load_then_deltas,
test_outer_join_first_load_then_retraction,
test_groupby_first_load_then_retraction_stream,
test_outer_join_float_pad_retraction_consistency,
test_groupby_datetime_group_values_stable_across_paths,
test_join_datetime_value_through_first_load,
test_outer_join_streaming_padding_flips_match_static,
test_groupby_columnar_streaming_matches_static,
test_groupby_decolumnarize_on_object_column.

Each case runs the reference test's body unedited on ``pathway_tpu`` and
on ``pathway_tpu_torch``: the port's update streams ``(time, key, diff,
values)``, subscriber callbacks, raised exception types and error log must
equal the reference's, keys included, and the reference test's own
assertions run on the port's output (``tests/torch_mirror_helpers.py``).
Timing-dependent cases compare final rows by key (their rows land in wall-
clock ticks): test_join_groupby_first_load_then_deltas,
test_outer_join_first_load_then_retraction,
test_outer_join_float_pad_retraction_consistency.
"""

from __future__ import annotations

import pytest

from torch_mirror_helpers import cases, run_case, reference_tests

REF = "test_engine_perf_paths"

#: the reference's test functions this file mirrors
MIRRORED = (
    "test_join_groupby_first_load_then_deltas",
    "test_outer_join_first_load_then_retraction",
    "test_groupby_first_load_then_retraction_stream",
    "test_outer_join_float_pad_retraction_consistency",
    "test_groupby_datetime_group_values_stable_across_paths",
    "test_join_datetime_value_through_first_load",
    "test_outer_join_streaming_padding_flips_match_static",
    "test_groupby_columnar_streaming_matches_static",
    "test_groupby_decolumnarize_on_object_column",
)
#: cases compared by their final rows (rows land in wall-clock ticks)
FINAL_ONLY = {"test_join_groupby_first_load_then_deltas", "test_outer_join_first_load_then_retraction", "test_outer_join_float_pad_retraction_consistency"}


@pytest.mark.parametrize("case", cases(REF))
def test_mirror(case, monkeypatch, tmp_path):
    run_case(REF, case, monkeypatch, tmp_path, final_only=case.split("[", 1)[0] in FINAL_ONLY)


def test_every_reference_test_has_a_case():
    """The reference file's test functions are the ones this file names,
    so a test added there shows up here."""
    assert tuple(reference_tests(REF)) == MIRRORED
