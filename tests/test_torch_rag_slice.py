"""The live-RAG loop of slice 1 on both packages: tokenize → embed → index →
search → rerank, the port on converted copies of the JAX package's weights.

f32: the same keys in the same order, search and rerank scores within 1e-5.
bf16 (the main path's type): each doc queried with its own text finds itself
first, and the rerank scores agree within 1e-2 (the encoder's bf16
tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import encoder as E
from pathway_tpu.ops import knn as J
from pathway_tpu.ops import reranker as R
from pathway_tpu_torch import convert
from pathway_tpu_torch.ops import encoder as TE
from pathway_tpu_torch.ops import knn as TK
from pathway_tpu_torch.ops import reranker as TR

SMALL = dict(vocab_size=1024, d_model=128, n_heads=2, n_layers=2, d_ff=256, max_len=64)


def synth_docs(n, words=40, seed=0):
    rng = np.random.default_rng(seed)
    vocab = [f"word{i}" for i in range(300)]
    return [" ".join(rng.choice(vocab, size=words)) for _ in range(n)]


def run_jax(dtype, docs, queries, batch):
    enc = E.JaxSentenceEncoder(E.EncoderConfig(**SMALL, dtype=dtype), seed=0)
    ce = R.JaxCrossEncoder(E.EncoderConfig(**SMALL, dtype=dtype), seed=1)
    index = J.BruteForceKnnIndex(dimension=SMALL["d_model"])
    ids, _ = enc.tokenizer(docs)
    for i in range(0, len(docs), batch):
        embs = enc.encode_ids_device(jnp.asarray(ids[i : i + batch]))
        index.add_batch_device(range(i, i + embs.shape[0]), embs)
        index._flush()
    out = []
    for q in queries:
        qids, _ = enc.tokenizer([q])
        hits = index.search(enc.encode_ids_device(jnp.asarray(qids)), k=5)[0]
        scores = ce.score_pairs([(q, docs[int(k)][:200]) for k, _ in hits])
        out.append((hits, scores))
    return enc, ce, out


def run_torch(tdtype, enc_params, ce_params, docs, queries, batch):
    enc = TE.TorchSentenceEncoder(TE.EncoderConfig(**SMALL, dtype=tdtype), params=enc_params, device="cpu")
    ce = TR.TorchCrossEncoder(TE.EncoderConfig(**SMALL, dtype=tdtype), params=ce_params, device="cpu")
    index = TK.BruteForceKnnIndex(dimension=SMALL["d_model"], device="cpu")
    ids, _ = enc.tokenizer(docs)
    for i in range(0, len(docs), batch):
        embs = enc.encode_ids_device(ids[i : i + batch])
        index.add_batch_device(range(i, i + embs.shape[0]), embs)
        index._flush()
    out = []
    for q in queries:
        qids, _ = enc.tokenizer([q])
        hits = index.search(enc.encode_ids_device(qids), k=5)[0]
        scores = ce.score_pairs([(q, docs[int(k)][:200]) for k, _ in hits])
        out.append((hits, scores))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rag_loop_matches_jax(dtype):
    docs = synth_docs(200)
    queries = ["what is word42 about", docs[3], docs[150], "word7 word8 word9"]
    jenc, jce, ref = run_jax(getattr(jnp, dtype), docs, queries, batch=64)
    to_t = lambda p: convert.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    out = run_torch(getattr(torch, dtype), to_t(jenc.params), to_t(jce.params), docs, queries, batch=64)
    for q, (hits, scores), (rhits, rscores) in zip(queries, out, ref):
        if dtype == "float32":
            assert [k for k, _ in hits] == [k for k, _ in rhits]
            np.testing.assert_allclose([s for _, s in hits], [s for _, s in rhits], rtol=0, atol=1e-5)
            np.testing.assert_allclose(scores, rscores, rtol=0, atol=1e-5)
        else:
            if q in docs:
                assert hits[0][0] == rhits[0][0] == docs.index(q)
            # rerank the same (query, doc) pairs: the JAX hits
            tce_scores = TR.TorchCrossEncoder(
                TE.EncoderConfig(**SMALL, dtype=torch.bfloat16),
                params=to_t(jce.params), device="cpu",
            ).score_pairs([(q, docs[int(k)][:200]) for k, _ in rhits])
            np.testing.assert_allclose(tce_scores, rscores, rtol=0, atol=1e-2)
        assert np.isfinite(scores).all()
