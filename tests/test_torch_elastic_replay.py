"""A rescale that restores by replaying a whole live-RAG stream, held
against the reference (``tests/torch_replay_probe.py``: 1,024 docs, then
128 queries, in 64-row ticks; 2 workers, then 3 from the same store).

The replay puts every logged doc and query into one tick. Whether each
query of that tick sees every doc depends on when the embedder's microbatch
buffers flush. With the flush deadline at 0 (each tick's rows embedded in
that tick) or held past the run (embedded at its end), both packages answer
after the replay exactly as before it, and the port's answers equal the
reference's: the same (query, rank, doc) rows, KNN and rerank scores within
1e-5 (f32). At the default deadline (the autocommit period, a wall-clock
age) the replayed answers vary from run to run on both packages, so no case
pins them; ``python tests/torch_replay_probe.py`` counts them.
"""

from __future__ import annotations

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu_torch

from torch_replay_probe import models, rescale

TOL = 1e-5


@pytest.fixture(scope="module")
def both_models():
    return models()


@pytest.mark.parametrize("flush_ms", ["0", "3600000"])
def test_whole_stream_replay_after_a_rescale_matches_the_reference(both_models, monkeypatch, flush_ms):
    monkeypatch.setenv("PATHWAY_ELASTIC", "manual")
    monkeypatch.setenv("PATHWAY_MICROBATCH", "auto")
    monkeypatch.setenv("PATHWAY_MICROBATCH_FLUSH_MS", flush_ms)
    out = {}
    for name, pw in (("ref", pathway_tpu), ("port", pathway_tpu_torch)):
        emb, rr, factory = both_models[name]
        out[name] = rescale(pw, emb, rr, factory, f"replay-parity-{name}-{flush_ms}")
        whole, replayed = out[name]
        assert len(whole) == 128 * 5, (name, len(whole))
        assert set(replayed) == set(whole), (name, len(set(whole) - set(replayed)), len(set(replayed) - set(whole)))
    for i in (0, 1):
        ref, port = out["ref"][i], out["port"][i]
        assert set(port) == set(ref)
        got = np.array([port[k] for k in sorted(ref)], dtype=np.float64)
        want = np.array([ref[k] for k in sorted(ref)], dtype=np.float64)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
