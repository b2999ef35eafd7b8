"""The port's flat attention against the JAX package's Pallas kernel (run in
interpret mode on the CPU, as the JAX package's own tests run it) and against
its XLA attention for lengths outside the Pallas envelope.

Tolerances: f32 at rtol = atol = 1e-5 (the two sides sum in another order,
nothing else differs). bf16: 2^-7 · (|ref| + max|v|) — one bf16 ulp (at most
2^-7 of a value) of the output, plus one ulp of every prob that rounds the
other way, which moves the output by at most 2^-7 · Σ p·|v| ≤ 2^-7 · max|v|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu_torch.ops import _build
from pathway_tpu_torch.ops import attention_kernel as A


def _inputs(B, L, H, hd, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    D = H * hd
    q, k, v = (rng.standard_normal((B, L, D)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, L), bool)
    mask[:, L - L // 4 :] = False  # padded tail
    mask[0, :] = False  # fully masked row: mean of v, not NaN
    return q, k, v, mask


def _sdpa_ref(q, k, v, mask, H, dtype):
    from pathway_tpu.ops import encoder as E

    B, L, D = q.shape
    hd = D // H
    to = lambda a: jnp.asarray(a, dtype).reshape(B, L, H, hd)
    out = E._sdpa(to(q), to(k), to(v), jnp.asarray(mask), hd ** -0.5).reshape(B, L, D)
    return np.asarray(out.astype(jnp.float32))


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def test_plain_matches_pallas_kernel_in_interpret_mode_f32():
    from pathway_tpu.ops.attention_kernel import _attention_short_impl

    B, L, H, hd = 16, 64, 6, 64
    q, k, v, mask = _inputs(B, L, H, hd, seed=3)
    ref = _attention_short_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        H, hd ** -0.5, 8, interpret=True,
    )
    out = A.attention_short_flat_plain(_torch(q), _torch(k), _torch(v), torch.from_numpy(mask), H, hd ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    mean_v = np.broadcast_to(v[0].mean(axis=0), out[0].shape)
    np.testing.assert_allclose(out[0].numpy(), mean_v, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,L,H,hd", [(10, 256, 6, 64), (1, 16, 6, 64), (3, 40, 2, 32), (2, 512, 2, 64), (2, 200, 2, 128)])
def test_plain_matches_xla_attention_outside_pallas_envelope_f32(B, L, H, hd):
    q, k, v, mask = _inputs(B, L, H, hd, seed=L)
    ref = _sdpa_ref(q, k, v, mask, H, jnp.float32)
    out = A.attention_short_flat(_torch(q), _torch(k), _torch(v), torch.from_numpy(mask), H, hd ** -0.5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,L", [(4, 128), (10, 256), (1, 16)])
def test_plain_matches_xla_attention_bf16(B, L):
    H, hd = 6, 64
    q, k, v, mask = _inputs(B, L, H, hd, seed=7 + L)
    # both sides start from the same bf16 values
    q, k, v = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (q, k, v))
    ref = _sdpa_ref(q, k, v, mask, H, jnp.bfloat16)
    bf = torch.bfloat16
    out = A.attention_short_flat(_torch(q, bf), _torch(k, bf), _torch(v, bf), torch.from_numpy(mask), H, hd ** -0.5)
    assert out.dtype == bf
    tol = 2.0 ** -7 * (np.abs(ref) + np.abs(v).max())
    assert (np.abs(out.float().numpy() - ref) <= tol).all()


def test_wrapper_reads_strided_qkv_split_and_counts_no_cpu_launch():
    B, L, H, hd = 2, 32, 2, 64
    D = H * hd
    qkv = torch.from_numpy(np.random.default_rng(0).standard_normal((B, L, 3 * D)).astype(np.float32))
    q, k, v = qkv.split(D, dim=-1)
    mask = torch.ones(B, L, dtype=torch.bool)
    mask[1, 20:] = False
    before = A.LAUNCHES
    out = A.attention_short_flat(q, k, v, mask, H, 0.125)
    ref = A.attention_short_flat_plain(q.contiguous(), k.contiguous(), v.contiguous(), mask, H, 0.125)
    assert torch.equal(out, ref)
    assert A.LAUNCHES == before


@pytest.mark.parametrize(
    "shape,heads,dtype,mask_dtype,match",
    [
        ((2, 16, 96), 2, torch.float32, torch.bool, "head width 48"),
        ((2, 600, 128), 2, torch.float32, torch.bool, "L=600"),
        ((2, 16, 128), 2, torch.float16, torch.bool, "float32 or bfloat16"),
        ((2, 16, 128), 2, torch.float32, torch.int32, "mask must be bool"),
        ((1, 512, 256), 2, torch.float32, torch.bool, "shared memory"),
    ],
)
def test_wrapper_rejects_outside_the_kernel_envelope(shape, heads, dtype, mask_dtype, match):
    x = torch.zeros(shape, dtype=dtype)
    m = torch.ones(shape[:2], dtype=mask_dtype)
    with pytest.raises(ValueError, match=match):
        A.attention_short_flat(x, x, x, m, heads, 0.125)


@pytest.mark.parametrize(
    "L,hd,itemsize,rows",
    [(128, 64, 2, 64), (16, 64, 2, 16), (256, 64, 2, 32), (512, 64, 4, 8), (512, 128, 2, 8)],
)
def test_row_tile_fits_shared_memory(L, hd, itemsize, rows):
    assert A._rows_per_block(L, hd, itemsize) == rows
    assert A._smem_bytes(L, hd, itemsize, rows) <= A._SMEM_LIMIT


def test_kernel_build_targets_hopper_and_fails_loudly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    cmd = _build.nvcc_command("attention_short", tmp_path / "x.so")
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert cmd[-1].endswith("csrc/attention_short.cu")
    monkeypatch.undo()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if not __import__("os").path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()
