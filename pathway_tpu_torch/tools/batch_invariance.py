"""Does a row get the same bits whatever batch it runs in, on one CUDA card?

    python -m pathway_tpu_torch.tools.batch_invariance

The cross-tick microbatcher changes launch shapes, never values: that holds
only if the ops a batched UDF or the index runs are batch-invariant. This
prints one JSON line comparing, at the pipeline's widths (the ``minilm``
embedder, the 4-layer reranker, 384-d f32 KNN over 4096 docs):

- the embedder on 512 docs in one launch against launches of 8, 64, 128 and
  256 rows;
- the reranker on 640 pairs in one launch against 512 + 128 and 10 x 64;
- the KNN search of 512 queries at once against batches of 1, 16 and 64
  (``ops/knn.py`` runs its score product in fixed 16-query chunks and sums
  norms in one fixed order), an index ingested in 8-row blocks against one
  ingested at once, and the unchunked product ``queries @ vectorsᵀ`` at 64
  against 512 rows (why the chunks).

Each entry is ``[bit-identical, max |difference|]``.
"""

from __future__ import annotations

import json
import sys


def _same(a, b) -> list:
    import numpy as np

    a, b = np.asarray(a, dtype=np.float32), np.asarray(b, dtype=np.float32)
    return [bool(np.array_equal(a.view(np.uint32), b.view(np.uint32))), float(np.abs(a - b).max())]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("batch_invariance: CUDA is not available", file=sys.stderr)
        return 2
    from pathway_tpu_torch.ops.encoder import EncoderConfig, TorchSentenceEncoder
    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex
    from pathway_tpu_torch.ops.reranker import TorchCrossEncoder

    rng = np.random.default_rng(0)
    vocab = [f"word{i}" for i in range(5000)]
    docs = [" ".join(rng.choice(vocab, size=120)) for _ in range(4096)]
    cfg = EncoderConfig(d_model=384, n_heads=6, n_layers=6, d_ff=1536)
    enc = TorchSentenceEncoder(cfg, seed=0)
    out: dict = {"card": torch.cuda.get_device_name(0)}

    e512 = enc.encode_texts(docs[:512])
    for c in (8, 64, 128, 256):
        parts = np.concatenate([enc.encode_texts(docs[i : i + c]) for i in range(0, 512, c)])
        out[f"embed_{c}_rows_vs_512"] = _same(e512, parts)

    ce = TorchCrossEncoder(cfg._replace(n_layers=4, max_len=256), seed=1)
    pairs = [(docs[i], docs[(7 * i + 1) % 4096]) for i in range(640)]
    s640 = ce.score_pairs(pairs)
    out["rerank_512_128_vs_640"] = _same(s640, np.concatenate([ce.score_pairs(pairs[:512]), ce.score_pairs(pairs[512:])]))
    out["rerank_10x64_vs_640"] = _same(s640, np.concatenate([ce.score_pairs(pairs[i : i + 64]) for i in range(0, 640, 64)]))

    index = BruteForceKnnIndex(dimension=384, capacity=4096)
    index.add_batch(list(range(4096)), np.concatenate([enc.encode_texts(docs[i : i + 512]) for i in range(0, 4096, 512)]))
    queries = e512
    full = index.search(queries, 10)
    for q in (1, 16, 64):
        parts = [h for i in range(0, 512, q) for h in index.search(queries[i : i + q], 10)]
        out[f"knn_search_{q}_queries_vs_512"] = [parts == full, max(
            abs(s - t) for hp, hf in zip(parts, full) for (_, s), (_, t) in zip(hp, hf)
        )]
    rows = index._vectors.cpu().numpy()
    blocks = BruteForceKnnIndex(dimension=384, capacity=4096)
    for lo in range(0, 4096, 8):
        blocks.add_batch(list(range(lo, lo + 8)), rows[lo : lo + 8])
        blocks._flush()
    out["knn_ingest_8_row_blocks_vs_4096"] = [blocks.search(queries, 10) == full, float(
        (blocks._norms_sq - index._norms_sq).abs().max()
    )]
    qt = torch.from_numpy(queries).cuda()
    v = index._vectors.float().T
    whole = (qt @ v).cpu().numpy()
    out["unchunked_score_product_64_vs_512_rows"] = _same(
        whole, np.concatenate([(qt[i : i + 64] @ v).cpu().numpy() for i in range(0, 512, 64)])
    )
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
