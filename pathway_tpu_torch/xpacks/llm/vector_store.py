"""VectorStoreServer / VectorStoreClient (reference ``xpacks/llm/vector_store.py``).

The older embedder-explicit API: docs + an embedder build a KNN DataIndex served
over REST. New code should prefer DocumentStore + DocumentStoreServer; this stays
for drop-in compatibility (LangChain/LlamaIndex-style adapters talk to the same
endpoints).
"""

from __future__ import annotations

import json
import urllib.request
from typing import Any, Callable, Iterable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.retrievers import BruteForceKnnFactory
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore


class VectorStoreServer:
    def __init__(
        self,
        *docs: Table,
        embedder: Callable,
        parser: Callable | None = None,
        splitter: Callable | None = None,
        doc_post_processors: list[Callable] | None = None,
        index_params: dict | None = None,
    ):
        factory = BruteForceKnnFactory(embedder=embedder, **(index_params or {}))
        self.document_store = DocumentStore(
            list(docs),
            retriever_factory=factory,
            parser=parser,
            splitter=splitter,
            doc_post_processors=doc_post_processors,
        )

    def run_server(
        self,
        host: str,
        port: int,
        *,
        threaded: bool = False,
        with_cache: bool = False,
        **kwargs,
    ):
        """Serve the store over REST (``/v1/retrieve``, ``/v1/statistics``,
        ``/v1/inputs``) on a ``DocumentStoreServer``."""
        from pathway_tpu_torch.xpacks.llm.servers import DocumentStoreServer

        server = DocumentStoreServer(host, port, self.document_store)
        return server.run(threaded=threaded, with_cache=with_cache, **kwargs)


def post_json(url: str, route: str, payload: dict, timeout: float, headers: dict | None = None) -> Any:
    """Shared POST-JSON helper for the xpack HTTP clients."""
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    req = urllib.request.Request(
        url.rstrip("/") + route, data=json.dumps(payload).encode(), headers=hdrs
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode())


class VectorStoreClient:
    """HTTP client for the vector-store endpoints (reference API)."""

    def __init__(self, host: str, port: int, url: str | None = None, timeout: float = 15.0):
        self.url = url or f"http://{host}:{port}"
        self.timeout = timeout

    def _post(self, route: str, payload: dict) -> Any:
        return post_json(self.url, route, payload, self.timeout)

    def query(self, query: str, k: int = 3, metadata_filter: str | None = None, filepath_globpattern: str | None = None):
        return self._post(
            "/v1/retrieve",
            {
                "query": query,
                "k": k,
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
        )

    __call__ = query

    def get_vectorstore_statistics(self):
        return self._post("/v1/statistics", {})

    def get_input_files(self, metadata_filter: str | None = None, filepath_globpattern: str | None = None):
        return self._post(
            "/v1/inputs",
            {"metadata_filter": metadata_filter, "filepath_globpattern": filepath_globpattern},
        )
