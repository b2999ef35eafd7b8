"""The PyTorch port imports without JAX and without the JAX package, and its
entry points refuse to fall back to the CPU when no device was given."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def _run(code: str) -> subprocess.CompletedProcess:
    """``code`` in a fresh interpreter: this test process already holds jax
    (conftest)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_port_imports_without_jax_or_reference_package():
    # every module of the package, found by walking it, so each module a
    # slice carries in is checked without being listed here
    code = (
        "import importlib, pkgutil, sys\n"
        "import pathway_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(pathway_tpu_torch.__path__, 'pathway_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) > 40, mods\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pathway_tpu' or m.startswith('pathway_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_flow_graphs_and_ml_import_without_jax_or_reference_package():
    """The flow plane, ``stdlib.graphs`` and ``stdlib.ml`` (its lazy ``hmm``
    and ``datasets`` too) load neither JAX nor the reference package, and
    ``stdlib.ml`` needs no ``networkx``."""
    proc = _run(
        "import sys\n"
        "sys.modules['networkx'] = None\n"
        "import pathway_tpu_torch as pw\n"
        "import pathway_tpu_torch.flow, pathway_tpu_torch.stdlib.graphs, pathway_tpu_torch.stdlib.ml\n"
        "assert pw.flow.current() is None\n"
        "assert callable(pw.stdlib.ml.hmm.create_hmm_reducer)\n"
        "assert callable(pw.stdlib.ml.datasets.load_lsh_test_data)\n"
        "assert callable(pw.stdlib.graphs.pagerank.pagerank) and callable(pw.iterate)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pathway_tpu' or m.startswith('pathway_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_package_import_loads_no_torch():
    proc = _run(
        "import sys\n"
        "import pathway_tpu_torch as pw\n"
        "pw.debug.table_from_markdown('a\\n1')\n"
        "sys.exit(1 if 'torch' in sys.modules else 0)\n"
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize(
    "entry",
    ["encoder", "reranker", "knn", "rescore", "convert", "embedder_udf", "reranker_udf", "index_backend"],
)
def test_entry_points_without_device_raise_when_cuda_is_absent(entry, monkeypatch):
    import numpy as np

    from pathway_tpu_torch import convert
    from pathway_tpu_torch.ops import encoder, knn, reranker
    from pathway_tpu_torch.stdlib.indexing._engine import VectorBackend
    from pathway_tpu_torch.xpacks.llm import embedders, rerankers

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = encoder.EncoderConfig(vocab_size=64, d_model=64, n_heads=1, n_layers=1, d_ff=64, max_len=16)
    build = {
        "encoder": lambda: encoder.TorchSentenceEncoder(cfg),
        "reranker": lambda: reranker.TorchCrossEncoder(cfg),
        "knn": lambda: knn.BruteForceKnnIndex(8),
        "rescore": lambda: knn.exact_rescore(np.ones((1, 8), np.float32), [1], np.ones(8), 1),
        "convert": lambda: convert.params_from_numpy({"w": np.ones((2, 2), np.float32)}),
        "embedder_udf": lambda: embedders.SentenceTransformerEmbedder(cfg),
        "reranker_udf": lambda: rerankers.CrossEncoderReranker(cfg),
        "index_backend": lambda: VectorBackend(8),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


def test_explicit_cpu_device_is_accepted_without_cuda(monkeypatch):
    from pathway_tpu_torch._device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
