"""Do two checkouts embed alike, bit for bit, on one CUDA card?

    python -m pathway_tpu_torch.tools.embedding_bits [--any] parent=DIR change=.

Each ``NAME=DIR`` runs in its own process with DIR's package, from DIR, and
embeds ``chip_smoke.py``'s first 1,024 bench docs with the pre-LN encoder of
its ``f32_path`` (f32, seed 0) and of its ``main_path`` (bf16 weights, seed
0), and 1,024 WordPiece docs with a random BERT checkpoint at
all-MiniLM-L6-v2's widths (``tools/bert_checkpoint``, seed 0, f32); the
first 8 of each f32 set also in an 8-row launch. With ``--any`` it also
embeds 256 docs with the encoders of ``chip_smoke.py``'s
``encoder_widths`` at 3 heads of 256 and 32 of 12 (both dtypes, seed 0),
and runs the attention forward at every ``ANY_SHAPES`` case of this
checkout's ``chip_smoke.py`` in both dtypes (q, k, v the column views of
one [B, L, 3D] projection, seeded per case), keeping a SHA-256 of each
output. It prints one JSON line: for each set, whether every checkout's
embeddings (or output digests) equal the first's bit for bit, and for each
checkout whether its 8-row launch equals its 1,024-row launch. The arrays
go to ``build/embedding_bits/<name>.npz`` of this checkout. TF32 is off.
Needs one CUDA card.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import numpy as np

N_DOCS = 1024
#: docs embedded by each ``--any`` encoder
ANY_DOCS = 256
#: ``--any``'s encoders: encoder_widths' configs with attention_any.cu heads
ANY_ENCODERS = ("hd256", "hd12")


def _any_sets(shapes: dict) -> dict:
    """The ``--any`` sets of the package importable from the working
    directory: the encoders' embeddings, then one digest per (dtype,
    ANY_SHAPES case) of the attention forward's output, as uint8 arrays."""
    import torch

    import chip_smoke as cs
    from pathway_tpu_torch.ops import attention_kernel as A
    from pathway_tpu_torch.ops.encoder import EncoderConfig, TorchSentenceEncoder

    out = {}
    for name in ANY_ENCODERS:
        d, heads, d_ff, max_len, words = cs.ENC_WIDTHS[name]
        docs = cs.synth_docs(ANY_DOCS, words)
        for dtype in (torch.bfloat16, torch.float32):
            cfg = EncoderConfig(vocab_size=32768, d_model=d, n_heads=heads, n_layers=6, d_ff=d_ff,
                                max_len=max_len, dtype=dtype)
            kw = {"param_dtype": torch.bfloat16} if dtype == torch.bfloat16 else {}
            enc = TorchSentenceEncoder(cfg, seed=0, device="cuda", **kw)
            out[f"enc_{name}_{str(dtype)[6:]}"] = enc.encode_texts(docs)
            del enc
    for dtype in (torch.bfloat16, torch.float32):
        for i, (case, (B, L, H, hd)) in enumerate(shapes.items()):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(i)
            q, k, v, mask = cs._attention_inputs(B, L, dtype, gen, H, hd)
            o = A.attention_short_flat(q, k, v, mask, H, hd ** -0.5)
            torch.cuda.synchronize()
            digest = hashlib.sha256(o.view(torch.uint8).cpu().numpy().tobytes()).digest()
            out[f"any_{str(dtype)[6:]}_{case}"] = np.frombuffer(digest, dtype=np.uint8)
            del q, k, v, mask, o
    return out


def write(path: str, shapes: dict | None = None) -> None:
    """The embeddings of the package importable from the working directory
    (and, given ``shapes``, the ``--any`` sets at those ANY_SHAPES cases),
    saved to ``path``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from pathway_tpu_torch.ops.encoder import EncoderConfig, TorchSentenceEncoder
    from pathway_tpu_torch.tools import bert_checkpoint as C

    docs = cs.synth_docs(N_DOCS)
    out = {}
    f32 = TorchSentenceEncoder(EncoderConfig(dtype=torch.float32), seed=0, device="cuda")
    out["f32"], out["f32_8"] = f32.encode_texts(docs), f32.encode_texts(docs[:8])
    bf16 = TorchSentenceEncoder(EncoderConfig(), seed=0, param_dtype=torch.bfloat16, device="cuda")
    out["bf16"] = bf16.encode_texts(docs)
    ckpt = os.path.join(os.getcwd(), "build", "embedding_bits_ckpt")
    vocab = C.synthetic_vocab(C.MINILM_L6["vocab_size"])
    C.write_checkpoint(ckpt, C.MINILM_L6, C.random_state_dict(C.MINILM_L6, seed=0), vocab)
    bert = TorchSentenceEncoder.from_pretrained(ckpt, max_len=128, device="cuda")
    bdocs = C.synthetic_docs(vocab, N_DOCS)
    out["bert"], out["bert_8"] = bert.encode_texts(bdocs), bert.encode_texts(bdocs[:8])
    if shapes is not None:
        out.update(_any_sets(shapes))
    np.savez(path, **out)


def _any_shapes(root: str) -> dict:
    """``ANY_SHAPES`` of the ``chip_smoke.py`` at ``root`` (read without
    importing the package beside it)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_bits_chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ANY_SHAPES


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--write"]:
        write(argv[1], json.loads(argv[2]) if len(argv) > 2 else None)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    extra = []
    if argv[:1] == ["--any"]:
        argv = argv[1:]
        extra = [json.dumps(_any_shapes(here))]
    out_dir = os.path.join(here, "build", "embedding_bits")
    os.makedirs(out_dir, exist_ok=True)
    arrays = {}
    for spec in argv:
        name, d = spec.split("=", 1)
        d = os.path.abspath(d)
        path = os.path.join(out_dir, f"{name}.npz")
        # this file, run with DIR's package (a parent checkout may not have it)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--write", path, *extra],
            cwd=d, env=dict(os.environ, PYTHONPATH=d), capture_output=True, text=True,
        )
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        arrays[name] = np.load(path)
    names = list(arrays)
    first = arrays[names[0]]
    res = {
        "sets_equal_to_" + names[0]: {
            k: all(np.array_equal(first[k], arrays[n][k]) for n in names[1:]) for k in first.files
        },
        "8_rows_equal_to_1024": {
            n: {s: bool(np.array_equal(a[f"{s}_8"], a[s][:8])) for s in ("f32", "bert")} for n, a in arrays.items()
        },
    }
    print(json.dumps(res))
    ok = all(res["sets_equal_to_" + names[0]].values()) and all(
        v for d in res["8_rows_equal_to_1024"].values() for v in d.values()
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
