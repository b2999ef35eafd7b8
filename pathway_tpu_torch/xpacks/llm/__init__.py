"""LLM xpack (reference ``python/pathway/xpacks/llm/``): embedders, rerankers,
chats, parsers, splitters, DocumentStore, vector store, Adaptive RAG.

The local embedder and cross-encoder run as batched PyTorch models
(``pathway_tpu_torch/ops/``, with the hand-written Hopper attention kernel),
not per-row calls. ``servers`` serves a DocumentStore or a QA answerer over
REST (``pw.io.http.rest_connector``).
"""

from pathway_tpu_torch.xpacks.llm import (
    embedders,
    llms,
    mocks,
    parsers,
    prompts,
    question_answering,
    rerankers,
    servers,
    splitters,
    vector_store,
)
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore, SlidesDocumentStore

__all__ = [
    "DocumentStore",
    "SlidesDocumentStore",
    "embedders",
    "llms",
    "mocks",
    "parsers",
    "prompts",
    "question_answering",
    "rerankers",
    "servers",
    "splitters",
    "vector_store",
]
