"""Do two checkouts embed alike, bit for bit, on one CUDA card?

    python -m pathway_tpu_torch.tools.embedding_bits parent=DIR change=.

Each ``NAME=DIR`` runs in its own process with DIR's package, from DIR, and
embeds ``chip_smoke.py``'s first 1,024 bench docs with the pre-LN encoder of
its ``f32_path`` (f32, seed 0) and of its ``main_path`` (bf16 weights, seed
0), and 1,024 WordPiece docs with a random BERT checkpoint at
all-MiniLM-L6-v2's widths (``tools/bert_checkpoint``, seed 0, f32); the
first 8 of each f32 set also in an 8-row launch. It prints one JSON line:
for each set, whether every checkout's embeddings equal the first's bit for
bit, and for each checkout whether its 8-row launch equals its 1,024-row
launch. The arrays go to ``build/embedding_bits/<name>.npz`` of this
checkout. TF32 is off. Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

N_DOCS = 1024


def write(path: str) -> None:
    """The embeddings of the package importable from the working directory,
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
    np.savez(path, **out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--write"]:
        write(argv[1])
        return 0
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out_dir = os.path.join(here, "build", "embedding_bits")
    os.makedirs(out_dir, exist_ok=True)
    arrays = {}
    for spec in argv:
        name, d = spec.split("=", 1)
        d = os.path.abspath(d)
        path = os.path.join(out_dir, f"{name}.npz")
        # this file, run with DIR's package (a parent checkout may not have it)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--write", path],
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
