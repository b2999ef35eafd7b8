"""The PyTorch port imports without JAX and without the JAX package, and its
entry points refuse to fall back to the CPU when no device was given."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "pathway_tpu_torch",
    "pathway_tpu_torch._device",
    "pathway_tpu_torch.convert",
    "pathway_tpu_torch.internals.keys",
    "pathway_tpu_torch.native",
    "pathway_tpu_torch.ops.microbatch",
    "pathway_tpu_torch.ops._build",
    "pathway_tpu_torch.ops.attention_kernel",
    "pathway_tpu_torch.ops.encoder",
    "pathway_tpu_torch.ops.knn",
    "pathway_tpu_torch.ops.reranker",
    "pathway_tpu_torch.tools.profile_main_path",
    "pathway_tpu_torch.tools.attention_ablation",
]


def test_port_imports_without_jax_or_reference_package():
    # a fresh interpreter: this test process already holds jax (conftest)
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pathway_tpu' or m.startswith('pathway_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("entry", ["encoder", "reranker", "knn", "rescore", "convert"])
def test_entry_points_without_device_raise_when_cuda_is_absent(entry, monkeypatch):
    import numpy as np

    from pathway_tpu_torch import convert
    from pathway_tpu_torch.ops import encoder, knn, reranker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = encoder.EncoderConfig(vocab_size=64, d_model=64, n_heads=1, n_layers=1, d_ff=64, max_len=16)
    build = {
        "encoder": lambda: encoder.TorchSentenceEncoder(cfg),
        "reranker": lambda: reranker.TorchCrossEncoder(cfg),
        "knn": lambda: knn.BruteForceKnnIndex(8),
        "rescore": lambda: knn.exact_rescore(np.ones((1, 8), np.float32), [1], np.ones(8), 1),
        "convert": lambda: convert.params_from_numpy({"w": np.ones((2, 2), np.float32)}),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


def test_explicit_cpu_device_is_accepted_without_cuda(monkeypatch):
    from pathway_tpu_torch._device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
