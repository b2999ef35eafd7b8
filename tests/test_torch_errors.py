"""The reference's ``tests/test_errors.py`` on the port, case by case:
the error policy (terminate_on_error, ERROR poisoning through joins and
reducers, the global error log, the env knob, sharded runs, operator
persistence on a cluster, user provenance).

Mirrors its 11 test functions, each a case of ``test_mirror`` under its own
name (a parametrised one once per parameter set):
test_terminate_on_error_default_aborts,
test_terminate_on_error_false_logs_and_poisons,
test_policy_restored_after_run, test_global_error_log_table,
test_error_log_cleared_with_graph,
test_error_poisons_through_join_and_groupby_with_retraction,
test_unique_reducer_ambiguity_is_reported,
test_terminate_on_error_env_config, test_sharded_terminate_on_error_aborts,
test_operator_persisting_attaches_to_cluster,
test_error_carries_user_provenance.

Each case runs the reference test's body unedited on ``pathway_tpu`` and
on ``pathway_tpu_torch``: the port's update streams ``(time, key, diff,
values)``, subscriber callbacks, raised exception types and error log must
equal the reference's, keys included, and the reference test's own
assertions run on the port's output (``tests/torch_mirror_helpers.py``).
"""

from __future__ import annotations

import pytest

from torch_mirror_helpers import cases, run_case, reference_tests

REF = "test_errors"

#: the reference's test functions this file mirrors
MIRRORED = (
    "test_terminate_on_error_default_aborts",
    "test_terminate_on_error_false_logs_and_poisons",
    "test_policy_restored_after_run",
    "test_global_error_log_table",
    "test_error_log_cleared_with_graph",
    "test_error_poisons_through_join_and_groupby_with_retraction",
    "test_unique_reducer_ambiguity_is_reported",
    "test_terminate_on_error_env_config",
    "test_sharded_terminate_on_error_aborts",
    "test_operator_persisting_attaches_to_cluster",
    "test_error_carries_user_provenance",
)
FINAL_ONLY: set[str] = set()


@pytest.mark.parametrize("case", cases(REF))
def test_mirror(case, monkeypatch, tmp_path):
    run_case(REF, case, monkeypatch, tmp_path, final_only=case.split("[", 1)[0] in FINAL_ONLY)


def test_every_reference_test_has_a_case():
    """The reference file's test functions are the ones this file names,
    so a test added there shows up here."""
    assert tuple(reference_tests(REF)) == MIRRORED
