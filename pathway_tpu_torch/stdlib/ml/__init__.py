"""ML stdlib (reference ``python/pathway/stdlib/ml/``): the LSH bucketers the
LSH index uses. The KNN-LSH classifiers, the legacy ``KNNIndex`` wrapper,
fuzzy joins and HMM decoding are a later slice."""

from pathway_tpu_torch.stdlib.ml import classifiers

__all__ = ["classifiers"]
