"""The port's copy of the microbatch helpers against the JAX package's."""

import numpy as np
import pytest

from pathway_tpu.ops import microbatch as J
from pathway_tpu_torch.ops import microbatch as T


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 100, 511, 512, 513, 5000])
def test_bucket_size_matches_reference(n):
    assert T.bucket_size(n) == J.bucket_size(n)
    assert T.bucket_size(n, 16, T.LENGTH_MAX_BUCKET) == J.bucket_size(n, 16, J.LENGTH_MAX_BUCKET)


def test_max_batch_knob(monkeypatch):
    monkeypatch.setenv("PATHWAY_MICROBATCH_MAX_BATCH", "64")
    assert T.bucket_size(1000) == J.bucket_size(1000) == 64
    monkeypatch.setenv("PATHWAY_MICROBATCH_MAX_BATCH", "0")
    with pytest.raises(ValueError, match=">= 1"):
        T.microbatch_max_batch()
    monkeypatch.setenv("PATHWAY_MICROBATCH_MAX_BATCH", "many")
    with pytest.raises(ValueError, match="must be an integer"):
        T.microbatch_max_batch()


def test_dispatcher_pads_to_buckets_and_keeps_order():
    seen = []

    def fn(items):
        seen.append(len(items))
        return [x * 2 for x in items]

    d = T.MicrobatchDispatcher(fn, max_batch=16)
    assert d.map(list(range(37))) == [x * 2 for x in range(37)]
    assert seen == [16, 16, 8]
    for x in range(20):
        d.submit(x)
    assert d.flush(only_full=True) == [x * 2 for x in range(16)]
    assert len(d) == 4
    with pytest.raises(ValueError, match="results"):
        T.MicrobatchDispatcher(lambda items: items[:1], max_batch=8).map([1, 2])


def test_pad_ragged_2d_matches_reference():
    rows = [np.arange(3), np.arange(20), np.arange(1)]
    for a, b in zip(T.pad_ragged_2d(rows), J.pad_ragged_2d(rows)):
        np.testing.assert_array_equal(a, b)
