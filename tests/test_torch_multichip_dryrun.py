"""The port's counterpart of ``__graft_entry__.py``:
``pathway_tpu_torch.tools.multichip_dryrun`` on the CPU. ``dryrun_multichip(8)``
runs a 4 x 2 TP/DP contrastive step (equal to the unsharded step within
``STEP_TOL`` of each leaf's largest value), the sharded KNN self-search, the
key exchange against a host groupby, and the sharded dataflow and the device
plane against one worker; ``entry()``'s forward against the reference's
``entry()`` with the same weights (f32 products on both: 1e-5)."""

from __future__ import annotations

import jax
import numpy as np
import torch

from pathway_tpu_torch.tools import multichip_dryrun as M


def test_dryrun_multichip_on_eight_cpu_shards():
    out = M.dryrun_multichip(8, device="cpu")
    step = out["train_step"]
    assert step["mesh"] == {"data": 4, "model": 2} and step["batch"] == [8, 16]
    assert np.isfinite(step["loss"])
    assert step["param_err"] <= M.STEP_TOL and step["momentum_err"] <= M.STEP_TOL
    assert out["device_plane_rows"] > 0


def test_dryrun_on_an_odd_count_keeps_one_model_shard():
    step = M._dryrun_train_step(3, torch.device("cpu"))
    assert step["mesh"] == {"data": 3, "model": 1}


def test_entry_forward_matches_the_reference_entry():
    import sys
    import os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as ref
    from pathway_tpu_torch.convert import params_from_numpy

    fwd_j, (pj, ids, mask) = ref.entry()
    want = np.asarray(jax.jit(fwd_j)(pj, ids, mask).astype(np.float32))
    fwd_t, (_, ids_t, mask_t) = M.entry(device="cpu")
    assert ids_t.shape == ids.shape and mask_t.shape == mask.shape
    got = fwd_t(params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu"), torch.from_numpy(ids).long(),
                torch.from_numpy(mask))
    # bf16 activations in both packages (EncoderConfig's default)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-2)
