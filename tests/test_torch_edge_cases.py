"""The reference's ``tests/test_edge_cases.py`` on the port, case by case:
edge cases (window cutoff, delay and keep_results on late data, interval
joins with behaviors, outer joins feeding groupbys and chained, None keys,
sub-universes, a REST round trip).

Mirrors its 11 test functions, each a case of ``test_mirror`` under its own
name (a parametrised one once per parameter set):
test_window_cutoff_drops_late_data,
test_window_without_cutoff_accepts_late_data,
test_window_delay_batches_updates,
test_window_keep_results_false_forgets_old_windows,
test_interval_join_with_behavior_ignores_late_left_row,
test_outer_join_padded_rows_feed_groupby, test_chained_outer_joins,
test_outer_join_none_keys_match_as_values,
test_left_join_then_filter_restores_subuniverse,
test_outer_join_streaming_universe_consistency, test_rest_server_round_trip.

Each case runs the reference test's body unedited on ``pathway_tpu`` and
on ``pathway_tpu_torch``: the port's update streams ``(time, key, diff,
values)``, subscriber callbacks, raised exception types and error log must
equal the reference's, keys included, and the reference test's own
assertions run on the port's output (``tests/torch_mirror_helpers.py``).
Timing-dependent cases compare final rows by key (their rows land in wall-
clock ticks): test_rest_server_round_trip.
The REST round trip serves on a free port of its own per run (the
reference test's fixed port is rewritten), under its own time limit.
"""

from __future__ import annotations

import socket
import threading

import pytest

from torch_mirror_helpers import cases, run_case, reference_tests

REF = "test_edge_cases"

#: the reference's test functions this file mirrors
MIRRORED = (
    "test_window_cutoff_drops_late_data",
    "test_window_without_cutoff_accepts_late_data",
    "test_window_delay_batches_updates",
    "test_window_keep_results_false_forgets_old_windows",
    "test_interval_join_with_behavior_ignores_late_left_row",
    "test_outer_join_padded_rows_feed_groupby",
    "test_chained_outer_joins",
    "test_outer_join_none_keys_match_as_values",
    "test_left_join_then_filter_restores_subuniverse",
    "test_outer_join_streaming_universe_consistency",
    "test_rest_server_round_trip",
)
#: cases compared by their final rows (rows land in wall-clock ticks)
FINAL_ONLY = {"test_rest_server_round_trip"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _own_port(src: str) -> str:
    """The REST round trip on a free port of its own (the reference test
    binds a fixed one, which another worker's run may hold)."""
    return src.replace("28913", str(_free_port()))


REST_TIMEOUT_S = 120



@pytest.mark.parametrize("case", cases(REF))
def test_mirror(case, monkeypatch, tmp_path):
    name = case.split("[", 1)[0]
    if name != "test_rest_server_round_trip":
        run_case(REF, case, monkeypatch, tmp_path, final_only=name in FINAL_ONLY)
        return
    # under its own time limit: the body blocks in pw.run until its client
    # stops the run
    out: dict = {}

    def go():
        try:
            run_case(REF, case, monkeypatch, tmp_path, final_only=True, rewrite=_own_port)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out["error"] = e

    th = threading.Thread(target=go, daemon=True)
    th.start()
    th.join(REST_TIMEOUT_S)
    assert not th.is_alive(), f"the REST round trip did not end within {REST_TIMEOUT_S} s"
    if "error" in out:
        raise out["error"]


def test_every_reference_test_has_a_case():
    """The reference file's test functions are the ones this file names,
    so a test added there shows up here."""
    assert tuple(reference_tests(REF)) == MIRRORED
