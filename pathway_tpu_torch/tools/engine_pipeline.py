"""The relational pipeline of ``benchmarks/engine_bench.py::_pipeline``,
written against the port: filter → join → groupby/sum over ``n`` left rows and
``n // 10`` right keys; and a fused expression chain (:func:`build_fused_chain`).

``n_times=1`` loads the left side in one static tick; ``n_times > 1`` splits
the same rows over that many logical times (the incremental path). The join
probe and the groupby are the two functions of ``engine/torch_kernels.py``;
``PATHWAY_ENGINE_JAX`` picks where they run.
"""

from __future__ import annotations

import numpy as np


def build(n: int, n_times: int = 1):
    import pathway_tpu_torch as pw

    pw.G.clear()
    rng = np.random.default_rng(0)
    lk = rng.integers(0, n // 10, n).tolist()
    lv = rng.integers(0, 100, n).tolist()
    schema_l = pw.schema_from_types(k=int, v=int)
    if n_times == 1:
        left = pw.debug.table_from_rows(schema_l, list(zip(lk, lv)))
    else:
        per = (n + n_times - 1) // n_times
        left = pw.debug.table_from_rows(
            schema_l,
            [(k, v, i // per, 1) for i, (k, v) in enumerate(zip(lk, lv))],
            is_stream=True,
        )
    right = pw.debug.table_from_rows(
        pw.schema_from_types(k=int, w=int),
        list(zip(range(n // 10), rng.integers(0, 100, n // 10).tolist())),
    )
    f = left.filter(left.v > 10)
    j = f.join(right, f.k == right.k).select(k=f.k, v=f.v, w=right.w)
    return j.groupby(j.k).reduce(j.k, s=pw.reducers.sum(j.v * j.w))


def build_fused_chain(n: int, n_times: int = 1):
    """The chain of ``tests/test_incremental_hot_path.py``'s fused-chain tests,
    filter → select → select, over ``n`` rows: one composed segment of chain
    fusion (``engine/fusion.py``), which ``PATHWAY_FUSE_JAX`` sends to the
    device tier or keeps on the register program. ``n_times`` as in
    :func:`build`."""
    import pathway_tpu_torch as pw

    pw.G.clear()
    rng = np.random.default_rng(23)
    ks = rng.integers(0, 50, n).tolist()
    vs = rng.integers(0, 100, n).tolist()
    per = (n + n_times - 1) // n_times
    t = pw.debug.table_from_rows(
        pw.schema_from_types(k=int, v=int),
        [(k, v, i // per, 1) for i, (k, v) in enumerate(zip(ks, vs))],
        is_stream=True,
    )
    f = t.filter(t.v > 10)
    s = f.select(k=f.k, d=f.v * 3)
    return s.select(k=s.k, e=s.d + s.k)
