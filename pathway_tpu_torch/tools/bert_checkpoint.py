"""A BERT checkpoint directory with random weights, a synthetic WordPiece
vocabulary and a seeded corpus for it, at the published widths of
``sentence-transformers/all-MiniLM-L6-v2`` (or any smaller ones).

No real checkpoint ships with the repository, and the card's machine has
neither ``transformers`` nor ``safetensors``: this writes what
``TorchSentenceEncoder.from_pretrained`` reads (``config.json``,
``vocab.txt``, ``pytorch_model.bin``) with HuggingFace's tensor names, so the
loader, the WordPiece tokenizer and the bert block run as they would on the
real files. The weights follow HuggingFace's BERT init scale (normal, std
0.02), with random biases and LN parameters so that every term of the block
is exercised.
"""

from __future__ import annotations

import json
import os

import numpy as np

#: ``sentence-transformers/all-MiniLM-L6-v2``'s ``config.json`` widths
MINILM_L6 = dict(
    vocab_size=30522,
    hidden_size=384,
    num_hidden_layers=6,
    num_attention_heads=12,
    intermediate_size=1536,
    max_position_embeddings=512,
    type_vocab_size=2,
    layer_norm_eps=1e-12,
)

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
PUNCT = list(".,;:!?()-'\"/")
#: the letters of vocabulary words; words made only of the others
#: (``UNKNOWN_LETTERS``) have no piece and tokenize to [UNK]
LETTERS = "abcdefghiklmnoprstuvw"
UNKNOWN_LETTERS = "jqxyz"


def _syllables(rng: np.random.Generator, n: int, lo: int, hi: int) -> list[str]:
    cons, vows = "bcdfghklmnprstvw", "aeiou"
    out: list[str] = []
    seen: set[str] = set()
    while len(out) < n:
        k = int(rng.integers(lo, hi + 1))
        w = "".join(cons[rng.integers(len(cons))] + vows[rng.integers(len(vows))] for _ in range(k))
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out


def synthetic_vocab(size: int, seed: int = 0) -> list[str]:
    """``size`` tokens, ``[PAD]`` at 0: the specials, punctuation, single
    letters and their ``##`` forms (so any word of ``LETTERS`` tokenizes),
    then whole words and ``##`` continuation pieces, three to one."""
    rng = np.random.default_rng(seed)
    head = SPECIALS + PUNCT + list(LETTERS) + ["##" + c for c in LETTERS]
    rest = size - len(head)
    if rest < 4:
        raise ValueError(f"vocab size {size} leaves no room for words")
    n_pieces = rest // 4
    words = _syllables(rng, rest - n_pieces, 2, 4)
    pieces = ["##" + p for p in _syllables(rng, n_pieces, 1, 3)]
    return head + words + pieces


def synthetic_docs(vocab: list[str], n: int, seed: int = 0, words: tuple[int, int] = (36, 72)) -> list[str]:
    """``n`` docs of ``words`` words: vocabulary words (whole-word hits),
    words that split into a stem and ``##`` continuations, words of letters
    no piece covers (one [UNK] each), capitalised and accented forms (the
    tokenizer lowercases and strips accents) and punctuation. At the
    default lengths a doc tokenizes to fewer than 128 ids."""
    rng = np.random.default_rng(seed)
    whole = [t for t in vocab[len(SPECIALS) + len(PUNCT) + 2 * len(LETTERS):] if not t.startswith("##")]
    pieces = [t[2:] for t in vocab if t.startswith("##") and len(t) > 3]
    accents = {"a": "á", "e": "é", "i": "í", "o": "ö", "u": "ü"}
    docs = []
    for _ in range(n):
        out = []
        for _w in range(int(rng.integers(words[0], words[1] + 1))):
            r = rng.random()
            if r < 0.6:
                w = whole[rng.integers(len(whole))]
            elif r < 0.8:
                w = whole[rng.integers(len(whole))] + pieces[rng.integers(len(pieces))]
            elif r < 0.87:
                w = "".join(UNKNOWN_LETTERS[rng.integers(len(UNKNOWN_LETTERS))] for _ in range(4))
            elif r < 0.93:
                w = whole[rng.integers(len(whole))].capitalize()
            else:
                w = "".join(accents.get(c, c) for c in whole[rng.integers(len(whole))])
            if rng.random() < 0.12:
                w += PUNCT[rng.integers(len(PUNCT))]
            out.append(w)
        docs.append(" ".join(out))
    return docs


def random_state_dict(config: dict, seed: int = 0) -> dict:
    """HuggingFace ``BertModel`` tensor names → random f32 torch tensors."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    d, f = config["hidden_size"], config["intermediate_size"]

    def normal(*shape, std=0.02):
        return torch.randn(*shape, generator=gen) * std

    sd = {
        "embeddings.word_embeddings.weight": normal(config["vocab_size"], d),
        "embeddings.position_embeddings.weight": normal(config["max_position_embeddings"], d),
        "embeddings.token_type_embeddings.weight": normal(config.get("type_vocab_size", 2), d),
    }

    def ln(pre):
        sd[pre + "LayerNorm.weight"] = 1.0 + normal(d)
        sd[pre + "LayerNorm.bias"] = normal(d)

    def dense(name, n_in, n_out):
        sd[name + ".weight"] = normal(n_out, n_in)
        sd[name + ".bias"] = normal(n_out)

    ln("embeddings.")
    for i in range(config["num_hidden_layers"]):
        pre = f"encoder.layer.{i}."
        for n in ("query", "key", "value"):
            dense(pre + "attention.self." + n, d, d)
        dense(pre + "attention.output.dense", d, d)
        ln(pre + "attention.output.")
        dense(pre + "intermediate.dense", d, f)
        dense(pre + "output.dense", f, d)
        ln(pre + "output.")
    return sd


def write_checkpoint(path: str, config: dict, state_dict: dict, vocab: list[str]) -> None:
    """``config.json``, ``vocab.txt`` and ``pytorch_model.bin`` under
    ``path``, as ``BertModel.save_pretrained`` and its tokenizer lay them
    out."""
    import torch

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
        json.dump({"model_type": "bert", "architectures": ["BertModel"], **config}, f, indent=1)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    torch.save(state_dict, os.path.join(path, "pytorch_model.bin"))
