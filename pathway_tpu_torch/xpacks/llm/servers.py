"""REST servers for RAG apps (reference ``xpacks/llm/servers.py:16-193``).

``BaseRestServer`` wraps ``pw.io.http.rest_connector`` routes; subclasses
register the DocumentStore / QA endpoints the reference exposes
(``/v1/retrieve``, ``/v1/statistics``, ``/v1/inputs``, ``/v2/answer``,
``/v2/summarize``, ``/v2/list_documents``).

Carried from ``pathway_tpu/xpacks/llm/servers.py``. Replica-served retrieval
(``fabric/index_replica.py``) arms only on a fabric cluster run, which the
port does not run yet: ``/v1/retrieve`` is answered by the one process's own
index, as the reference answers it on a single process.
"""

from __future__ import annotations

import threading
from typing import Callable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.later_slice import later_slice
from pathway_tpu_torch.io.http._server import (
    EndpointDocumentation,
    PathwayWebserver,
    rest_connector,
)


class BaseRestServer:
    def __init__(self, host: str, port: int, **kwargs):
        self.host = host
        self.port = port
        self.webserver = PathwayWebserver(host=host, port=port)

    def serve(
        self,
        route: str,
        schema,
        handler: Callable,
        documentation=None,
        replica_route=None,
        **kwargs,
    ) -> None:
        if replica_route is not None:
            raise later_slice("fabric.index_replica")
        queries, writer = rest_connector(
            webserver=self.webserver,
            route=route,
            schema=schema,
            methods=("GET", "POST"),
            documentation=documentation
            or EndpointDocumentation(summary=f"{type(self).__name__} {route}"),
            **kwargs,
        )
        writer(handler(queries))

    def run(self, threaded: bool = False, with_cache: bool = False, **kwargs):
        """Build & run the dataflow (blocks; threaded=True runs in a thread)."""
        if threaded:
            t = threading.Thread(target=pw.run, kwargs=dict(**kwargs), daemon=True)
            t.start()
            return t
        return pw.run(**kwargs)


class DocumentStoreServer(BaseRestServer):
    """Reference ``servers.py:92``: retrieve/statistics/inputs endpoints."""

    def __init__(self, host: str, port: int, document_store, **kwargs):
        super().__init__(host, port, **kwargs)
        self.document_store = document_store
        # the reference arms a changelog-fed replica index here on fabric
        # cluster runs (``index_replica.maybe_arm``); on one process it is None
        self.replica_route = None
        self.serve(
            "/v1/retrieve",
            document_store.RetrieveQuerySchema,
            document_store.retrieve_query,
            replica_route=self.replica_route,
        )
        self.serve(
            "/v1/statistics",
            document_store.StatisticsQuerySchema,
            document_store.statistics_query,
        )
        self.serve(
            "/v1/inputs",
            document_store.InputsQuerySchema,
            document_store.inputs_query,
        )


class QARestServer(DocumentStoreServer):
    """Reference ``servers.py:140``: adds /v2/answer + /v2/list_documents."""

    def __init__(self, host: str, port: int, rag_question_answerer, **kwargs):
        super().__init__(host, port, rag_question_answerer.indexer, **kwargs)
        self.rag = rag_question_answerer
        self.serve(
            "/v2/answer",
            rag_question_answerer.AnswerQuerySchema,
            rag_question_answerer.answer_query,
        )
        self.serve(
            "/v2/list_documents",
            self.document_store.InputsQuerySchema,
            self.document_store.inputs_query,
        )


class QASummaryRestServer(QARestServer):
    """Reference ``servers.py:193``: adds /v2/summarize."""

    def __init__(self, host: str, port: int, rag_question_answerer, **kwargs):
        super().__init__(host, port, rag_question_answerer, **kwargs)
        self.serve(
            "/v2/summarize",
            rag_question_answerer.SummarizeQuerySchema,
            rag_question_answerer.summarize_query,
        )
