"""pathway_tpu_torch — the live-RAG loop of ``pathway_tpu`` ported to PyTorch
and CUDA for one NVIDIA H100.

Slice 1 holds the loop's ops: the hash tokenizer, microbatch padding, the
pre-LN sentence encoder with its hand-written Hopper attention kernel, the
brute-force KNN index and the cross-encoder reranker (``pathway_tpu_torch.ops``),
plus the weight bridge from the JAX package's parameter trees
(``pathway_tpu_torch.convert``). Entry points run on the card unless the caller
passes ``device="cpu"``; nothing heavy is imported here.
"""

__version__ = "0.1.0"
