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


def test_persistence_and_table_surface_import_without_jax_or_reference_package():
    """``pw.persistence``, ``pw.delivery``, ``pw.sql`` and the rest of the
    Table API surface load neither JAX nor the reference package, and the
    package imports without PyYAML: only ``pw.load_yaml`` needs it, and
    there it raises an ImportError naming it."""
    proc = _run(
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "import pathway_tpu_torch\n"
        "pathway_tpu_torch.persistence; pathway_tpu_torch.sql\n"
        "import pathway_tpu_torch.persistence.snapshots, pathway_tpu_torch.delivery\n"
        "import pathway_tpu_torch.stdlib.viz, pathway_tpu_torch.internals.row_transformer\n"
        "try:\n"
        "    pathway_tpu_torch.load_yaml('a: 1')\n"
        "    sys.exit('load_yaml ran without PyYAML')\n"
        "except ImportError as e:\n"
        "    assert 'PyYAML' in str(e), e\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pathway_tpu' or m.startswith('pathway_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
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


def test_multiworker_planes_import_without_jax_or_reference_package():
    """The multi-worker planes (``parallel``: the shard grid, the on-device
    exchange and its plane, the sharded and cluster runtimes; the sharded
    KNN search; ``resilience``: heartbeats and the supervisor; ``elastic``'s
    membership; ``observability.aggregate``; the Kafka connector) load
    neither JAX nor the reference package, and a 2-worker run with the
    exchange plane forced on stays clear of both."""
    proc = _run(
        "import os, sys\n"
        "os.environ['PATHWAY_DEVICE_EXCHANGE'] = 'on'\n"
        "import pathway_tpu_torch as pw\n"
        "import pathway_tpu_torch.parallel, pathway_tpu_torch.parallel.cluster\n"
        "import pathway_tpu_torch.parallel.device_exchange, pathway_tpu_torch.parallel.device_plane\n"
        "import pathway_tpu_torch.resilience.heartbeat, pathway_tpu_torch.resilience.supervisor\n"
        "import pathway_tpu_torch.elastic.membership, pathway_tpu_torch.observability.aggregate\n"
        "import pathway_tpu_torch.io.kafka\n"
        "from pathway_tpu_torch.ops.knn import ShardedBruteForceKnnIndex, sharded_search\n"
        "t = pw.debug.table_from_rows(pw.schema_from_types(k=int, v=int), [(i % 5, i) for i in range(100)])\n"
        "g = t.groupby(t.k).reduce(t.k, s=pw.reducers.sum(t.v))\n"
        "pw.io.subscribe(g, on_change=lambda **kw: None)\n"
        "pw.run(n_workers=2, monitoring_level='none')\n"
        "assert pw.internals.run.current_runtime().device_plane.rows_exchanged > 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pathway_tpu' or m.startswith('pathway_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_elastic_cli_demo_and_connectors_import_without_jax_or_reference_package():
    """The elasticity plane (``elastic`` with its reshard and autoscaler),
    the command line (``cli``, ``python -m pathway_tpu_torch``), ``demo``,
    the S3 and Postgres connectors and the delivery plane load neither JAX
    nor the reference package, and the command line answers without
    ``click``."""
    proc = _run(
        "import sys\n"
        "sys.modules['click'] = None\n"
        "import pathway_tpu_torch as pw\n"
        "import pathway_tpu_torch.elastic, pathway_tpu_torch.elastic.reshard, pathway_tpu_torch.elastic.autoscaler\n"
        "import pathway_tpu_torch.cli, pathway_tpu_torch.demo, pathway_tpu_torch.delivery\n"
        "import pathway_tpu_torch.io.s3, pathway_tpu_torch.io.s3_csv, pathway_tpu_torch.io.minio\n"
        "import pathway_tpu_torch.io.postgres, pathway_tpu_torch.io._pg_fake\n"
        "assert pw.demo is pathway_tpu_torch.demo and pw.elastic.RESCALE_EXIT_CODE == 75\n"
        "assert pathway_tpu_torch.cli.build_parser().parse_args(['scale', '--to', '3']).target == 3\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pathway_tpu' or m.startswith('pathway_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
