"""LSH bucketers (reference: ``stdlib/ml/classifiers/_lsh.py``).

A bucketer maps a vector to ``L`` band ids; vectors sharing a band id are
candidate neighbors. Euclidean uses random-projection quantization (p-stable
LSH), cosine uses random-hyperplane signs. Band hashing is vectorized over the
whole batch of vectors — one matmul + one quantization per call — so the hot
loop is a single BLAS/XLA-friendly contraction rather than per-row hashing.
"""

from __future__ import annotations

import numpy as np


def _band_ids(codes: np.ndarray, L: int, M: int) -> np.ndarray:
    """codes: (n, L*M) int array → (n, L) stable band hashes."""
    n = codes.shape[0]
    bands = codes.reshape(n, L, M)
    # polynomial rolling hash per band, vectorized
    h = np.zeros((n, L), dtype=np.uint64)
    mult = np.uint64(0x100000001B3)
    with np.errstate(over="ignore"):
        for j in range(M):
            h = h * mult ^ (bands[:, :, j].astype(np.uint64) + np.uint64(0x9E3779B9))
        # salt each band position so identical codes in different bands differ
        h = h * mult ^ np.arange(L, dtype=np.uint64)[None, :]
    return h


def generate_euclidean_lsh_bucketer(
    d: int, M: int = 10, L: int = 5, A: float = 1.0, seed: int = 0
):
    """p-stable (Gaussian projection) LSH for euclidean distance: code
    ``floor((x·r + b) / A)`` per projection, ``M`` projections per band."""
    rng = np.random.default_rng(seed)
    R = rng.normal(size=(d, M * L))
    B = rng.uniform(0, A, size=(M * L,))

    def bucketer(vectors: np.ndarray) -> np.ndarray:
        x = np.atleast_2d(np.asarray(vectors, dtype=np.float64))
        codes = np.floor((x @ R + B) / A).astype(np.int64)
        return _band_ids(codes, L, M)

    bucketer.L = L
    bucketer.d = d
    return bucketer


def generate_cosine_lsh_bucketer(d: int, M: int = 10, L: int = 5, seed: int = 0):
    """Random-hyperplane LSH for cosine distance: code = sign(x·r)."""
    rng = np.random.default_rng(seed)
    R = rng.normal(size=(d, M * L))

    def bucketer(vectors: np.ndarray) -> np.ndarray:
        x = np.atleast_2d(np.asarray(vectors, dtype=np.float64))
        codes = (x @ R > 0).astype(np.int64)
        return _band_ids(codes, L, M)

    bucketer.L = L
    bucketer.d = d
    return bucketer
