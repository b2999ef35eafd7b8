"""ML classifiers (reference ``python/pathway/stdlib/ml/classifiers/``): the
LSH bucketers, carried from ``pathway_tpu/stdlib/ml/classifiers/_lsh.py``.
The KNN-LSH classifiers themselves are a later slice."""

from pathway_tpu_torch.stdlib.ml.classifiers._lsh import (
    generate_cosine_lsh_bucketer,
    generate_euclidean_lsh_bucketer,
)

__all__ = ["generate_cosine_lsh_bucketer", "generate_euclidean_lsh_bucketer"]
