"""ML stdlib (reference ``python/pathway/stdlib/ml/``): LSH KNN classifiers,
the legacy KNNIndex wrapper, fuzzy joins, HMM decoding. The dense KNN index
on the card lives in ``pathway_tpu_torch.ops.knn`` / ``stdlib.indexing``.

Carried from ``pathway_tpu/stdlib/ml/`` with imports rewritten; ``hmm`` and
``datasets`` load lazily, as the reference's do."""

from pathway_tpu_torch.stdlib.ml import classifiers, smart_table_ops
from pathway_tpu_torch.stdlib.ml.index import KNNIndex

__all__ = ["KNNIndex", "classifiers", "smart_table_ops"]


def __getattr__(name):
    # ``from pathway_tpu_torch.stdlib.ml import hmm`` inside this hook would
    # ask the package for ``hmm`` again and recurse; import the module by name
    if name in ("hmm", "datasets"):
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(name)
