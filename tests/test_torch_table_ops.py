"""The reference's ``tests/test_table_ops.py`` on the port, case by case:
the Table API's core operations (select, rename, filter, split, concat,
update_rows/cells, difference/intersect/restrict, with_id_from, flatten, ix,
having, cast, groupby with a custom id, same-tick nets).

Mirrors its 22 test functions, each a case of ``test_mirror`` under its own
name (a parametrised one once per parameter set):
test_select_and_rename, test_star_select, test_with_columns_without,
test_filter_keeps_keys, test_split, test_concat_and_reindex,
test_update_rows, test_update_cells, test_difference_intersect_restrict,
test_with_id_from_stable, test_flatten, test_flatten_origin_id, test_ix,
test_ix_ref, test_having, test_multi_table_select_same_universe,
test_cast_to_types, test_groupby_with_custom_id, test_empty_table,
test_combine_same_tick_insert_retract_nets_out,
test_update_rows_with_swapped_column_order,
test_update_rows_output_stays_typed.

Each case runs the reference test's body unedited on ``pathway_tpu`` and
on ``pathway_tpu_torch``: the port's update streams ``(time, key, diff,
values)``, subscriber callbacks, raised exception types and error log must
equal the reference's, keys included, and the reference test's own
assertions run on the port's output (``tests/torch_mirror_helpers.py``).
"""

from __future__ import annotations

import pytest

from torch_mirror_helpers import cases, run_case, reference_tests

REF = "test_table_ops"

#: the reference's test functions this file mirrors
MIRRORED = (
    "test_select_and_rename",
    "test_star_select",
    "test_with_columns_without",
    "test_filter_keeps_keys",
    "test_split",
    "test_concat_and_reindex",
    "test_update_rows",
    "test_update_cells",
    "test_difference_intersect_restrict",
    "test_with_id_from_stable",
    "test_flatten",
    "test_flatten_origin_id",
    "test_ix",
    "test_ix_ref",
    "test_having",
    "test_multi_table_select_same_universe",
    "test_cast_to_types",
    "test_groupby_with_custom_id",
    "test_empty_table",
    "test_combine_same_tick_insert_retract_nets_out",
    "test_update_rows_with_swapped_column_order",
    "test_update_rows_output_stays_typed",
)
FINAL_ONLY: set[str] = set()


@pytest.mark.parametrize("case", cases(REF))
def test_mirror(case, monkeypatch, tmp_path):
    run_case(REF, case, monkeypatch, tmp_path, final_only=case.split("[", 1)[0] in FINAL_ONLY)


def test_every_reference_test_has_a_case():
    """The reference file's test functions are the ones this file names,
    so a test added there shows up here."""
    assert tuple(reference_tests(REF)) == MIRRORED
