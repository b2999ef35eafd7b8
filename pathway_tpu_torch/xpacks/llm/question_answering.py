"""Question answering: Adaptive RAG (reference ``xpacks/llm/question_answering.py``).

``answer_with_geometric_rag_strategy`` (reference ``:97-160``) asks with
``n_starting_documents`` docs and geometrically grows the context on "No
information found", spending tokens on more context only when needed.
``BaseRAGQuestionAnswerer``/``AdaptiveRAGQuestionAnswerer`` wire a DocumentStore,
a chat model, and REST endpoints (``/v2/answer`` etc.) together.
"""

from __future__ import annotations

from typing import Any, Callable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import ColumnReference
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
from pathway_tpu_torch.xpacks.llm.prompts import NO_INFO_RESPONSE, prompt_qa_geometric_rag


def _query_chat_with_k_documents(chat, k: int, rows: Table, strict_prompt: bool) -> Table:
    prompts = rows.select(
        __prompt=pw.apply_with_type(
            lambda q, docs: prompt_qa_geometric_rag(q, list(docs or ())[:k], strict_prompt),
            dt.STR,
            pw.this.query,
            pw.this.documents,
        )
    )
    answered = prompts.select(answer=chat(pw.this["__prompt"]))
    return answered.select(
        answer=pw.apply_with_type(
            lambda a: None if a is None or NO_INFO_RESPONSE.lower() in str(a).lower() else a,
            dt.Optional(dt.STR),
            pw.this.answer,
        )
    )


def answer_with_geometric_rag_strategy(
    questions: ColumnReference,
    documents: ColumnReference,
    llm_chat_model,
    n_starting_documents: int,
    factor: int,
    max_iterations: int,
    strict_prompt: bool = False,
) -> ColumnReference:
    """Ask with n docs; on 'No information found' retry with n*factor docs
    (reference ``:97``, the loop at ``:149-160``)."""
    n_documents = n_starting_documents
    t = Table.from_columns(query=questions, documents=documents)
    t = t.with_columns(answer=pw.declare_type(dt.Optional(dt.STR), None))
    for _ in range(max_iterations):
        rows_without_answer = t.filter(pw.this.answer.is_none())
        results = _query_chat_with_k_documents(
            llm_chat_model, n_documents, rows_without_answer, strict_prompt
        )
        new_answers = rows_without_answer.with_columns(answer=results.answer)
        t = t.update_rows(new_answers)
        n_documents *= factor
    return t.answer


def answer_with_geometric_rag_strategy_from_index(
    questions: ColumnReference,
    index: DataIndex,
    documents_column: str | ColumnReference,
    llm_chat_model,
    n_starting_documents: int,
    factor: int,
    max_iterations: int,
    metadata_filter=None,
    strict_prompt: bool = False,
) -> ColumnReference:
    """Same loop, retrieving max-needed docs from the index first (reference)."""
    col_name = (
        documents_column.name
        if isinstance(documents_column, ColumnReference)
        else documents_column
    )
    max_docs = n_starting_documents * factor ** (max_iterations - 1)
    qtable = questions.table
    docs = index.query_as_of_now(
        questions, number_of_matches=max_docs, metadata_filter=metadata_filter
    ).select(__docs=pw.coalesce(pw.right[col_name], ()))
    merged = qtable.with_columns(__docs=docs.with_universe_of(qtable)["__docs"])
    return answer_with_geometric_rag_strategy(
        merged[questions.name],
        merged["__docs"],
        llm_chat_model,
        n_starting_documents,
        factor,
        max_iterations,
        strict_prompt=strict_prompt,
    )


class BaseRAGQuestionAnswerer:
    """DocumentStore + chat + REST endpoints (reference ``:314``)."""

    class AnswerQuerySchema(pw.Schema):
        prompt: str
        filters: str | None = pw.column_definition(default_value=None)
        model: str | None = pw.column_definition(default_value=None)

    class SummarizeQuerySchema(pw.Schema):
        text_list: Any

    def __init__(
        self,
        llm,
        indexer: DocumentStore,
        *,
        default_llm_name: str | None = None,
        prompt_template: Callable[[str, list[str]], str] | None = None,
        search_topk: int = 6,
    ):
        self.llm = llm
        self.indexer = indexer
        self.search_topk = search_topk
        self.prompt_template = prompt_template or (
            lambda q, docs: prompt_qa_geometric_rag(q, docs)
        )
        self.server = None

    # -- dataflow pieces ----------------------------------------------------
    def answer_query(self, queries: Table) -> Table:
        """queries(prompt, filters) → result(str)."""
        retrieve = queries.select(
            query=pw.this.prompt,
            k=self.search_topk,
            metadata_filter=pw.this.filters,
            filepath_globpattern=pw.declare_type(dt.Optional(dt.STR), None),
        )
        hits = self.indexer.retrieve_query(retrieve)
        prompt_template = self.prompt_template
        combined = queries.with_columns(
            __docs=pw.apply_with_type(
                lambda res: [d["text"] for d in (res.value if hasattr(res, "value") else res or [])],
                dt.ANY,
                hits.with_universe_of(queries).result,
            )
        )
        prompts = combined.select(
            __prompt=pw.apply_with_type(
                lambda q, docs: prompt_template(q, list(docs)),
                dt.STR,
                pw.this.prompt,
                pw.this["__docs"],
            )
        )
        return prompts.select(result=self.llm(pw.this["__prompt"]))

    answer = answer_query

    def summarize_query(self, queries: Table) -> Table:
        from pathway_tpu_torch.xpacks.llm.prompts import prompt_summarize

        prompts = queries.select(
            __prompt=pw.apply_with_type(
                lambda texts: prompt_summarize(list(texts.value if hasattr(texts, "value") else texts or ())),
                dt.STR,
                pw.this.text_list,
            )
        )
        return prompts.select(result=self.llm(pw.this["__prompt"]))

    # -- REST serving -------------------------------------------------------
    def build_server(self, host: str, port: int, **kwargs) -> None:
        """Register /v2/answer, /v2/list_documents, /v1/retrieve,
        /v1/statistics and /v1/inputs endpoints (reference ``:314`` region)
        on a :class:`~pathway_tpu_torch.xpacks.llm.servers.QARestServer`."""
        from pathway_tpu_torch.xpacks.llm.servers import QARestServer

        self.server = QARestServer(host, port, self, **kwargs)

    def run_server(self, *args, **kwargs):
        if self.server is None:
            raise RuntimeError("call build_server(host, port) first")
        return self.server.run(*args, **kwargs)


class AdaptiveRAGQuestionAnswerer(BaseRAGQuestionAnswerer):
    """Adaptive RAG loop as the answer path (reference ``:638``)."""

    def __init__(
        self,
        llm,
        indexer: DocumentStore,
        *,
        n_starting_documents: int = 2,
        factor: int = 2,
        max_iterations: int = 4,
        strict_prompt: bool = False,
        **kwargs,
    ):
        super().__init__(llm, indexer, **kwargs)
        self.n_starting_documents = n_starting_documents
        self.factor = factor
        self.max_iterations = max_iterations
        self.strict_prompt = strict_prompt

    def answer_query(self, queries: Table) -> Table:
        max_docs = self.n_starting_documents * self.factor ** (self.max_iterations - 1)
        retrieve = queries.select(
            query=pw.this.prompt,
            k=max_docs,
            metadata_filter=pw.this.filters,
            filepath_globpattern=pw.declare_type(dt.Optional(dt.STR), None),
        )
        hits = self.indexer.retrieve_query(retrieve)
        combined = queries.with_columns(
            __docs=pw.apply_with_type(
                lambda res: [d["text"] for d in (res.value if hasattr(res, "value") else res or [])],
                dt.ANY,
                hits.with_universe_of(queries).result,
            )
        )
        answers = answer_with_geometric_rag_strategy(
            combined.prompt,
            combined["__docs"],
            self.llm,
            self.n_starting_documents,
            self.factor,
            self.max_iterations,
            strict_prompt=self.strict_prompt,
        )
        return combined.select(result=answers)

    answer = answer_query


class RAGClient:
    """HTTP client for the RAG question-answering servers (reference
    ``question_answering.py:879``). Either (host, port) or url."""

    def __init__(
        self,
        host: str | None = None,
        port: int | None = None,
        url: str | None = None,
        timeout: int | None = 90,
        additional_headers: dict | None = None,
    ):
        err = "Either (`host` and `port`) or `url` must be provided, but not both."
        if url is not None:
            if host is not None or port is not None:
                raise ValueError(err)
            self.url = url
        else:
            if host is None or port is None:
                raise ValueError(err)
            self.url = f"http://{host}:{port}"
        self.timeout = timeout
        self.headers = additional_headers or {}

    def _post(self, route: str, payload: dict):
        from pathway_tpu_torch.xpacks.llm.vector_store import post_json

        return post_json(self.url, route, payload, self.timeout or 90, self.headers)

    def answer(self, prompt: str, filters: str | None = None, **kwargs):
        payload = {"prompt": prompt, **kwargs}
        if filters is not None:
            payload["filters"] = filters
        return self._post("/v2/answer", payload)

    def retrieve(
        self,
        query: str,
        k: int = 3,
        metadata_filter: str | None = None,
        filepath_globpattern: str | None = None,
    ):
        payload = {"query": query, "k": k}
        if metadata_filter is not None:
            payload["metadata_filter"] = metadata_filter
        if filepath_globpattern is not None:
            payload["filepath_globpattern"] = filepath_globpattern
        return self._post("/v1/retrieve", payload)

    def statistics(self):
        return self._post("/v1/statistics", {})

    def list_documents(self, filters: str | None = None):
        payload = {}
        if filters is not None:
            payload["metadata_filter"] = filters
        return self._post("/v2/list_documents", payload)
