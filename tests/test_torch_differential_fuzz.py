"""The reference's ``tests/test_differential_fuzz.py`` on the port, case by case:
the seeded differential fuzz (random pipelines streamed against one static
load, on 1 and 4 workers).

Mirrors its 2 test functions, each a case of ``test_mirror`` under its own
name (a parametrised one once per parameter set):
test_streamed_equals_static, test_streamed_equals_static_across_workers.

Each case runs the reference test's body unedited on ``pathway_tpu`` and
on ``pathway_tpu_torch``: the port's update streams ``(time, key, diff,
values)``, subscriber callbacks, raised exception types and error log must
equal the reference's, keys included, and the reference test's own
assertions run on the port's output (``tests/torch_mirror_helpers.py``).
"""

from __future__ import annotations

import pytest

from torch_mirror_helpers import cases, run_case, reference_tests

REF = "test_differential_fuzz"

#: the reference's test functions this file mirrors
MIRRORED = (
    "test_streamed_equals_static",
    "test_streamed_equals_static_across_workers",
)
FINAL_ONLY: set[str] = set()


@pytest.mark.parametrize("case", cases(REF))
def test_mirror(case, monkeypatch, tmp_path):
    run_case(REF, case, monkeypatch, tmp_path, final_only=case.split("[", 1)[0] in FINAL_ONLY)


def test_every_reference_test_has_a_case():
    """The reference file's test functions are the ones this file names,
    so a test added there shows up here."""
    assert tuple(reference_tests(REF)) == MIRRORED
