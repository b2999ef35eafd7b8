"""Does a row get the same bits whatever batch it runs in, on one CUDA card?

    python -m pathway_tpu_torch.tools.batch_invariance

The cross-tick microbatcher changes launch shapes, never values: that holds
only if the ops a batched UDF or the index runs are batch-invariant. This
prints one JSON line comparing, at the pipeline's widths (the ``minilm``
embedder, the 4-layer reranker, 384-d f32 KNN over 4096 docs):

- the embedder on 512 docs in one launch against launches of 8, 16, 32, 64,
  128 and 256 rows (every bucket the flow plane's AIMD controller may pick
  below 512), and beside it each intermediate of the pooling tail: the last
  LN's output, the masked sum over tokens and the L2 norm, each both as
  ``ops/encoder.py::pool`` takes it (``fixed_order_sum``) and as a torch
  reduction (``sum(dim=1)``, ``norm(dim=-1)``), so a difference is traced to
  its op;
- the reranker on 640 pairs in one launch against 512 + 128, 10 x 64 and
  launches of 8, 16, 32, 128 and 256 pairs;
- the KNN search of 512 queries at once against batches of 1, 16 and 64
  (``ops/knn.py`` runs its score product in fixed 16-query chunks and sums
  norms in one fixed order), an index ingested in 8-row blocks against one
  ingested at once, and the unchunked product ``queries @ vectorsᵀ`` at 64
  against 512 rows (why the chunks);
- the KNN scores of 64 queries against the same 4,096 rows in brute-force
  indexes of capacity 4,096, 65,536 and 1,048,576 (the extra slots invalid)
  and through ``exact_rescore`` over exactly those rows, every (query, row)
  pair (:func:`index_rows_check`; ``ops/knn.py`` also runs its score product
  in fixed 65,536-row tiles), and the untiled product against 4,096 and
  65,536 rows (why the tiles);
- the bert block in f32 (:func:`bert_check`): ``from_pretrained`` on a
  random checkpoint at all-MiniLM-L6-v2's widths (``tools/bert_checkpoint``),
  the first 8 of 1,024 WordPiece docs in an 8-row launch against the
  1,024-row launch, and beside it every intermediate of the forward in call
  order (each f32 product, LN and attention), so a difference is traced to
  the first op that shows it;
- the pre-LN encoder in f32 (:func:`preln_f32_check`), the encoder of
  ``chip_smoke.py``'s ``f32_path`` (f32 weights and activations, seed 0):
  the first 8 of 1,024 of the bench's docs in an 8-row launch against the
  1,024-row launch, with each LN and attention output in call order;
- the ``minilm`` embedder (max_len 512) on docs in launches padded to
  other lengths (:func:`length_check`): 64 or 128 tokens alone against 256
  (the attention kernel keeps the keys of L <= 128 resident and streams
  longer ones; both fold a row's softmax sum in the same tile order), 256
  against 512, and 8 against 64 rows at 256.

Each entry is ``[bit-identical, max |difference|]``. The run fails (exit 1)
when an embedder (the length entries included), reranker, search, bert or
pre-LN f32 entry is not bit-identical; the torch reductions of the pooling
tail and the unchunked product are diagnostics.
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
    tails = _pooling_tail(enc, docs[:512], 512)
    for c in (8, 16, 32, 64, 128, 256):
        parts = np.concatenate([enc.encode_texts(docs[i : i + c]) for i in range(0, 512, c)])
        out[f"embed_{c}_rows_vs_512"] = _same(e512, parts)
        part_tails = _pooling_tail(enc, docs[:512], c)
        out[f"pooling_tail_{c}_rows_vs_512"] = {
            name: _same(tails[name], part_tails[name]) for name in tails
        }

    ce = TorchCrossEncoder(cfg._replace(n_layers=4, max_len=256), seed=1)
    pairs = [(docs[i], docs[(7 * i + 1) % 4096]) for i in range(640)]
    s640 = ce.score_pairs(pairs)
    out["rerank_512_128_vs_640"] = _same(s640, np.concatenate([ce.score_pairs(pairs[:512]), ce.score_pairs(pairs[512:])]))
    out["rerank_10x64_vs_640"] = _same(s640, np.concatenate([ce.score_pairs(pairs[i : i + 64]) for i in range(0, 640, 64)]))
    for c in (8, 16, 32, 128, 256):
        out[f"rerank_{c}_rows_vs_640"] = _same(
            s640, np.concatenate([ce.score_pairs(pairs[i : i + c]) for i in range(0, 640, c)])
        )

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
    wide = torch.cat([index._vectors.float(), torch.randn(65536 - 4096, 384, device="cuda")])
    out["untiled_score_product_4096_vs_65536_rows"] = _same(
        (qt[:64] @ v).cpu().numpy(), (qt[:64] @ wide.T)[:, :4096].cpu().numpy()
    )
    del wide
    out.update(index_rows_check("cuda"))
    from pathway_tpu_torch.tools.bert_checkpoint import synthetic_docs

    bert, bert_vocab = bert_encoder("cuda")
    out.update(bert_check(bert, synthetic_docs(bert_vocab, 1024)))
    del bert
    out.update(preln_f32_check(preln_f32_encoder("cuda"), docs[:1024]))
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    out.update(length_check(SentenceTransformerEmbedder("minilm", seed=0)._encoder))
    failed = sorted(
        name for name, entry in out.items()
        if name.startswith(("embed_", "rerank_", "knn_", "bert_embed_", "preln_f32_embed_"))
        and isinstance(entry, list) and isinstance(entry[0], bool) and not entry[0]
    )
    out["failed"] = failed
    print(json.dumps(out), flush=True)
    return 1 if failed else 0


def index_rows_check(
    device, dim: int = 384, rows: int = 4096, n_queries: int = 64,
    capacities: tuple = (4096, 65536, 1 << 20),
) -> dict:
    """The same ``n_queries`` queries against the same ``rows`` rows, scored
    by a ``BruteForceKnnIndex`` at each of ``capacities`` (the extra slots
    invalid) and by ``exact_rescore`` over exactly those rows (the tiered
    index's two tiers), each searched for every row. One entry per scorer
    against the first capacity: ``[every (query, row) score bit-identical,
    max |difference|]``."""
    import numpy as np

    from pathway_tpu_torch.ops.knn import BruteForceKnnIndex, exact_rescore

    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(rows, dim)).astype(np.float32)
    queries = rng.normal(size=(n_queries, dim)).astype(np.float32)
    keys = list(range(rows))

    def table(hits) -> np.ndarray:
        scores = np.full((n_queries, rows), np.nan, dtype=np.float32)
        for qi, h in enumerate(hits):
            scores[qi, [k for k, _ in h]] = [s for _, s in h]
        return scores

    scored = {}
    for cap in capacities:
        index = BruteForceKnnIndex(dim, capacity=cap, device=device)
        index.add_batch(keys, vecs)
        scored[f"brute_force_capacity_{cap}"] = table(index.search(queries, rows))
        del index
    scored["exact_rescore"] = table(exact_rescore(vecs, keys, queries, rows, device=device))
    base = f"brute_force_capacity_{capacities[0]}"
    return {
        f"knn_scores_{name}_vs_{base}": _same(scored[base], got)
        for name, got in scored.items() if name != base
    }


def bert_encoder(device, config: dict | None = None) -> tuple:
    """(``from_pretrained`` on ``device`` of a random checkpoint at
    ``config``'s widths, default all-MiniLM-L6-v2's, in f32 with max_len 128;
    its synthetic vocabulary)."""
    import tempfile

    from pathway_tpu_torch.ops import encoder as E
    from pathway_tpu_torch.tools import bert_checkpoint as C

    config = config or C.MINILM_L6
    vocab = C.synthetic_vocab(config["vocab_size"])
    with tempfile.TemporaryDirectory() as tmp:
        C.write_checkpoint(tmp, config, C.random_state_dict(config, seed=0), vocab)
        return E.TorchSentenceEncoder.from_pretrained(tmp, max_len=128, device=device), vocab


def bert_check(enc, docs: list[str], rows: int = 8) -> dict:
    """The bert encoder ``enc``: the first ``rows`` of ``docs`` embedded in a
    ``rows``-row launch and in one launch of all of ``docs``.
    ``bert_embed_<rows>_rows_vs_<len(docs)>`` is ``[bit-identical, max
    |difference|]``; ``bert_first_differing_op`` names the first intermediate
    of the forward (in call order, over the docs' shared token positions)
    whose bits differ between the launches, or None."""
    return _launch_check(enc, docs, docs[:rows], rows, "bert", ("_dot_f32", "_layer_norm_eps", "attention_short_flat"))


def preln_f32_encoder(device):
    """The pre-LN encoder of ``chip_smoke.py``'s ``f32_path``: the bench's
    MiniLM-class widths, f32 weights and activations, seed 0."""
    import torch

    from pathway_tpu_torch.ops.encoder import EncoderConfig, TorchSentenceEncoder

    cfg = EncoderConfig(vocab_size=32768, d_model=384, n_heads=6, n_layers=6, d_ff=1536, max_len=128,
                        dtype=torch.float32)
    return TorchSentenceEncoder(cfg, seed=0, device=device)


def preln_f32_check(enc, docs: list[str], rows: int = 8) -> dict:
    """:func:`bert_check` for the pre-LN encoder ``enc`` in f32, under the
    ``preln_f32_`` prefix; the traced intermediates are each LN's output,
    each f32 product and each attention output."""
    return _launch_check(enc, docs, docs[:rows], rows, "preln_f32", ("_layer_norm", "_dot_f32", "attention_short_flat"))


#: the ops of the pre-LN block that :func:`length_check` traces
PRELN_OPS = ("_layer_norm", "_dot_f32", "_attention", "attention_short_flat")


def length_check(enc, rows: int = 8) -> dict:
    """Does a doc get the same bits whatever length its launch is padded
    to? ``rows`` docs of 40 words (the tokenizer's 64-token bucket) and
    ``rows`` of 100 words (128: more than one 64-key tile, inside the
    attention kernel's resident length) embedded by ``enc`` alone and beside
    a 200-word doc (a launch padded to 256); the 100-word docs also beside a
    400-word doc (512) and at 256 beside 55 more docs (the batch changes,
    the length does not). Each entry ``embed_len_<a>_vs_<b>`` compares the
    ``rows`` docs' embeddings in the two launches, with the first traced
    intermediate (inputs and outputs of :data:`PRELN_OPS`, over the shared
    token positions) that differs."""
    import numpy as np

    rng = np.random.default_rng(1)
    vocab = [f"word{i}" for i in range(5000)]

    def docs(n, words):
        return [" ".join(rng.choice(vocab, size=words)) for _ in range(n)]

    short, mid = docs(rows, 40), docs(rows, 100)
    long_, longer, more = docs(1, 200), docs(1, 400), docs(55, 100)
    cases = {
        "64_vs_256": (short + long_, short),
        "128_vs_256": (mid + long_, mid),
        "256_vs_512": (mid + longer, mid + long_),
        "256_vs_256x64": (mid + long_ + more, mid + long_),
    }
    out = {}
    for name, (docs_b, docs_a) in cases.items():
        got = _launch_check(enc, docs_b, docs_a, rows, "len", PRELN_OPS)
        out[f"embed_len_{name}"] = got[f"len_embed_{rows}_rows_vs_{len(docs_b)}"]
        out[f"embed_len_{name}_first_differing_op"] = got["len_first_differing_op"]
        out[f"embed_len_{name}_seq_len"] = got["len_seq_len"]
    return out


def _launch_check(enc, docs: list[str], few: list[str], rows: int, prefix: str, ops: tuple) -> dict:
    """The first ``rows`` docs embedded by ``enc`` in one launch of ``docs``
    and in one launch of ``few`` (which begins with the same ``rows`` docs),
    each of ``ops`` (functions of ``ops/encoder.py``) traced in call order:
    its output, and its first argument where that is not (a view of) the
    previous traced op's output."""
    from pathway_tpu_torch.ops import encoder as E

    def traced(texts) -> tuple:
        """(embeddings, [(op, array)] in call order, sequence length)."""
        ids, _ = enc.tokenizer(texts)
        calls: list = []
        last: list = [None]  # the previous traced output (held, so no other tensor takes its memory)
        saved = {n: getattr(E, n) for n in ops}

        def wrap(name, fn):
            def run(*args, **kwargs):
                if last[0] is None or args[0].untyped_storage().data_ptr() != last[0].untyped_storage().data_ptr():
                    calls.append((f"{len(calls)}:{name}.in", args[0][:rows].float().cpu().numpy()))
                res = fn(*args, **kwargs)
                calls.append((f"{len(calls)}:{name}", res[:rows].float().cpu().numpy()))
                last[0] = res
                return res
            return run

        try:
            for name, fn in saved.items():
                setattr(E, name, wrap(name, fn))
            emb = enc.encode_ids_device(ids)[:rows].cpu().numpy()
        finally:
            for name, fn in saved.items():
                setattr(E, name, fn)
        return emb, calls, ids.shape[1]

    e_all, c_all, l_all = traced(docs)
    e_few, c_few, l_few = traced(few)
    first = None
    L = min(l_all, l_few)
    for (name, a), (_n, b) in zip(c_all, c_few):
        if not _same(a[:, :L], b[:, :L])[0]:
            first = name
            break
    return {
        f"{prefix}_embed_{rows}_rows_vs_{len(docs)}": _same(e_all, e_few),
        f"{prefix}_first_differing_op": first,
        f"{prefix}_seq_len": [l_all, l_few],
    }


def _pooling_tail(enc, docs: list[str], rows: int) -> dict:
    """The encoder's pooling intermediates for ``docs`` in launches of
    ``rows`` docs, as numpy f32 arrays."""
    import numpy as np
    import torch

    from pathway_tpu_torch.ops import encoder as E
    from pathway_tpu_torch.ops._fixed_order import fixed_order_sum

    got: dict[str, list] = {}
    with torch.inference_mode():
        for lo in range(0, len(docs), rows):
            ids, _ = enc.tokenizer(docs[lo : lo + rows])
            ids = torch.from_numpy(ids).to(enc.device).long()
            mask = ids != 0
            x = E.hidden_states(enc.params, enc.cfg, ids, mask)
            xm = x.float() * mask.float()[:, :, None]
            pooled = fixed_order_sum(xm, dim=1) / mask.float().sum(dim=1, keepdim=True).clamp_min(1.0)
            parts = {
                "last_ln": x.float(),
                "pooled_sum_fixed_order": fixed_order_sum(xm, dim=1),
                "pooled_sum_torch_reduction": xm.sum(dim=1),
                "norm_fixed_order": fixed_order_sum(pooled * pooled, dim=-1).sqrt(),
                "norm_torch_reduction": pooled.norm(dim=-1),
            }
            for name, t in parts.items():
                got.setdefault(name, []).append(t.cpu().numpy())
    return {name: np.concatenate(ts) for name, ts in got.items()}


if __name__ == "__main__":
    sys.exit(main())
