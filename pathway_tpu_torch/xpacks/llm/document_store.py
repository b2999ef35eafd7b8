"""DocumentStore — the canonical RAG ingest pipeline
(reference ``xpacks/llm/document_store.py:33-472``).

docs tables → parse (flatten) → post-process → split (flatten) → index via
``retriever_factory``; query methods ``retrieve_query`` / ``statistics_query`` /
``inputs_query`` answer **as-of-now** against the live index.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.data_index import _SCORE, DataIndex
from pathway_tpu_torch.stdlib.indexing.retrievers import AbstractRetrieverFactory


class DocumentStore:
    class RetrieveQuerySchema(pw.Schema):
        query: str
        k: int
        metadata_filter: str | None = pw.column_definition(default_value=None)
        filepath_globpattern: str | None = pw.column_definition(default_value=None)

    class StatisticsQuerySchema(pw.Schema):
        pass

    class InputsQuerySchema(pw.Schema):
        metadata_filter: str | None = pw.column_definition(default_value=None)
        filepath_globpattern: str | None = pw.column_definition(default_value=None)

    class QueryResultSchema(pw.Schema):
        result: Any

    def __init__(
        self,
        docs: Table | Iterable[Table],
        retriever_factory: AbstractRetrieverFactory | None = None,
        parser: Callable | None = None,
        splitter: Callable | None = None,
        doc_post_processors: list[Callable] | None = None,
        embedder: Any = None,
    ):
        from pathway_tpu_torch.xpacks.llm.parsers import Utf8Parser
        from pathway_tpu_torch.xpacks.llm.splitters import NullSplitter

        if isinstance(docs, Table):
            self.docs = docs
        else:
            tables = list(docs)
            self.docs = (
                tables[0] if len(tables) == 1 else tables[0].concat_reindex(*tables[1:])
            )
        if retriever_factory is None:
            # default big-corpus retriever: the tiered
            # hot-card/cold-host index serves any corpus size at a fixed device
            # footprint (PATHWAY_INDEX_HOT_ROWS) and answers byte-identically
            # to brute force while the cold tier is exact — small corpora
            # never spill past the hot shard, so nothing is lost by default
            if embedder is None:
                raise ValueError(
                    "DocumentStore: provide retriever_factory= or embedder= "
                    "(the default TieredKnnFactory embeds with it)"
                )
            from pathway_tpu_torch.stdlib.indexing.retrievers import TieredKnnFactory

            retriever_factory = TieredKnnFactory(embedder=embedder)
        self.retriever_factory = retriever_factory
        self.parser = parser or Utf8Parser()
        self.splitter = splitter or NullSplitter()
        self.doc_post_processors = doc_post_processors or []
        self.build_pipeline()

    # ---------------------------------------------------------------- pipeline
    def build_pipeline(self) -> None:
        docs = self.docs
        if "_metadata" not in docs.column_names():
            docs = docs.with_columns(_metadata=pw.declare_type(dt.ANY, {}))

        parsed = docs.select(
            __chunks=self.parser(pw.this.data), _metadata=pw.this._metadata
        )
        parsed = parsed.flatten(parsed["__chunks"])
        parsed = parsed.select(
            text=pw.apply_with_type(lambda c: c[0], dt.STR, pw.this["__chunks"]),
            _metadata=pw.apply_with_type(
                lambda c, md: {**_as_dict(md), **_as_dict(c[1] if len(c) > 1 else {})},
                dt.ANY,
                pw.this["__chunks"],
                pw.this._metadata,
            ),
        )
        for post in self.doc_post_processors:
            parsed = parsed.select(
                text=pw.apply_with_type(post, dt.STR, pw.this.text),
                _metadata=pw.this._metadata,
            )
        self.parsed_docs = parsed

        chunked = parsed.select(
            __chunks=self.splitter(pw.this.text), _metadata=pw.this._metadata
        )
        chunked = chunked.flatten(chunked["__chunks"])
        chunked = chunked.select(
            text=pw.apply_with_type(lambda c: c[0], dt.STR, pw.this["__chunks"]),
            metadata=pw.apply_with_type(
                lambda c, md: {**_as_dict(md), **_as_dict(c[1] if len(c) > 1 else {})},
                dt.ANY,
                pw.this["__chunks"],
                pw.this._metadata,
            ),
        )
        self.chunked_docs = chunked
        self._retriever = self.retriever_factory.build_index(
            chunked.text, chunked, metadata_column=chunked.metadata
        )

    @property
    def index(self) -> DataIndex:
        return self._retriever

    # ---------------------------------------------------------------- helpers
    @staticmethod
    def merge_filters(queries: Table) -> Table:
        """Combine metadata_filter and filepath_globpattern into one filter
        string (reference ``document_store.py`` merge_filters)."""
        return queries.with_columns(
            metadata_filter=pw.apply_with_type(
                combine_filters,
                dt.Optional(dt.STR),
                pw.this.metadata_filter,
                pw.this.filepath_globpattern,
            )
        ).without(pw.this.filepath_globpattern)

    # ---------------------------------------------------------------- queries
    def retrieve_query(self, retrieval_queries: Table) -> Table:
        """Closest chunks for each query (reference ``:427``)."""
        queries = self.merge_filters(retrieval_queries)
        reply = self._retriever.query_as_of_now(
            queries.query,
            number_of_matches=queries.k,
            metadata_filter=queries.metadata_filter,
        ).select(
            __texts=pw.coalesce(pw.right.text, ()),
            __metas=pw.coalesce(pw.right.metadata, ()),
            __scores=pw.coalesce(pw.right[_SCORE], ()),
        )

        def pack(texts, metas, scores):
            return pw.Json(
                sorted(
                    [
                        {"text": t, "metadata": _as_dict(m), "dist": -s}
                        for t, m, s in zip(texts, metas, scores)
                    ],
                    key=lambda d: d["dist"],
                )
            )

        return reply.select(
            result=pw.apply_with_type(
                pack, dt.ANY, pw.this["__texts"], pw.this["__metas"], pw.this["__scores"]
            )
        )

    def statistics_query(self, info_queries: Table) -> Table:
        """Document count + last/oldest modification time (reference ``:324``)."""
        docs = self.parsed_docs
        stats = docs.reduce(
            count=pw.reducers.count(),
            last_modified=pw.reducers.max(
                pw.apply_with_type(_modified_at, dt.Optional(dt.INT), pw.this._metadata)
            ),
            last_indexed=pw.reducers.max(
                pw.apply_with_type(_seen_at, dt.Optional(dt.INT), pw.this._metadata)
            ),
        )

        def pack(count, last_modified, last_indexed):
            return pw.Json(
                {
                    "file_count": count,
                    "last_modified": last_modified,
                    "last_indexed": last_indexed,
                }
            )

        captured = info_queries.join_left(stats, id=info_queries.id).select(
            result=pw.apply_with_type(
                pack, dt.ANY, stats.count, stats.last_modified, stats.last_indexed
            )
        )
        return captured

    def inputs_query(self, input_queries: Table) -> Table:
        """List indexed input documents' metadata (reference ``:386``)."""
        from pathway_tpu_torch.stdlib.indexing._filters import compile_filter

        queries = self.merge_filters(input_queries)
        metas = self.parsed_docs.reduce(
            metadatas=pw.reducers.tuple(pw.this._metadata)
        )

        def pack(metadatas, metadata_filter):
            flt = compile_filter(metadata_filter)
            return pw.Json([_as_dict(m) for m in (metadatas or ()) if flt(m)])

        return queries.join_left(metas, id=queries.id).select(
            result=pw.apply_with_type(
                pack, dt.ANY, metas.metadatas, queries.metadata_filter
            )
        )


class SlidesDocumentStore(DocumentStore):
    """Reference ``document_store.py:472`` variant exposing parsed slides; the
    SlideParser is gated on ``openparse``, so this is DocumentStore with
    the same extended query surface."""


def combine_filters(metadata_filter: Any, globpattern: Any) -> str | None:
    """One query's merged filter string — module-level (not a closure) so a
    retrieval path served outside the engine merges filters with
    definitionally the same bytes as the engine path."""
    parts = []
    if metadata_filter:
        parts.append(f"({metadata_filter})")
    if globpattern:
        escaped = str(globpattern).replace("\\", "\\\\").replace("'", "\\'")
        parts.append(f"globmatch('{escaped}', path)")
    return " && ".join(parts) if parts else None


def _as_dict(md: Any) -> dict:
    if md is None:
        return {}
    if hasattr(md, "value"):
        md = md.value
    return dict(md) if isinstance(md, dict) else {"value": md}


def _modified_at(md: Any) -> int | None:
    d = _as_dict(md)
    v = d.get("modified_at")
    return int(v) if v is not None else None


def _seen_at(md: Any) -> int | None:
    d = _as_dict(md)
    v = d.get("seen_at")
    return int(v) if v is not None else None
