"""ML classifiers (reference: ``python/pathway/stdlib/ml/classifiers/``),
carried from ``pathway_tpu/stdlib/ml/classifiers/``."""

from pathway_tpu_torch.stdlib.ml.classifiers._knn_lsh import (
    DataPoint,
    knn_lsh_classifier_train,
    knn_lsh_classify,
    knn_lsh_euclidean_classifier_train,
    knn_lsh_generic_classifier_train,
)
from pathway_tpu_torch.stdlib.ml.classifiers._lsh import (
    generate_cosine_lsh_bucketer,
    generate_euclidean_lsh_bucketer,
)

__all__ = [
    "DataPoint",
    "knn_lsh_classifier_train",
    "knn_lsh_classify",
    "knn_lsh_euclidean_classifier_train",
    "knn_lsh_generic_classifier_train",
    "generate_cosine_lsh_bucketer",
    "generate_euclidean_lsh_bucketer",
]
