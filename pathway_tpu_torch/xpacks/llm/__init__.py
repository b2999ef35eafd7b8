"""LLM xpack (reference ``python/pathway/xpacks/llm/``): the local embedder and
the rerankers of the live-RAG loop, running on the port's encoder and
cross-encoder. Chats, parsers, splitters, the DocumentStore and the servers
are a later slice.
"""

from pathway_tpu_torch.xpacks.llm import embedders, rerankers

__all__ = ["embedders", "rerankers"]
