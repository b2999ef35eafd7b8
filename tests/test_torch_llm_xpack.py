"""The port's LLM xpack (``pathway_tpu_torch/xpacks/llm``: DocumentStore,
splitters, mocks, question answering, chats, remote embedders, rerankers)
against the JAX package's, on the same inputs.

Mirrors ``tests/test_indexing_xpack.py`` and ``tests/test_llm_wrappers.py``.
Each pipeline is written once as ``build(pw)`` and run through both
packages; the captured update streams ``(time, key, diff, values)`` must be
identical, keys included. Json values compare by their content, the error
value by name. One exception, stated where it applies: a KNN retriever's
``dist`` is a float32 cosine computed by two frameworks, compared within
1e-6; every other field of those rows (texts, metadata, order) is exact.
The port's device is the CPU.
"""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys
import threading
import types

import numpy as np
import pytest

import pathway_tpu
import pathway_tpu.internals.udfs
import pathway_tpu.stdlib.indexing
import pathway_tpu.xpacks.llm  # the builds reach both packages as pw.xpacks.llm
import pathway_tpu_torch
from pathway_tpu.debug import _capture as _capture_ref
from pathway_tpu_torch.debug import _capture as _capture_port
from torch_http_helpers import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIST_TOL = 1e-6


def _norm(v):
    if hasattr(v, "value") and type(v).__name__ == "Json":
        return ("Json", _norm(v.value))
    if type(v).__name__ == "_Error":
        return "ERROR"
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.shape, tuple(v.ravel().tolist()))
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_norm(x) for x in v)
    return v


def update_stream(pw, build) -> dict[str, list]:
    """Every output table of ``build(pw)`` → its update stream, values
    normalised across the two packages."""
    pw.G.clear()
    capture = _capture_port if pw is pathway_tpu_torch else _capture_ref
    out = build(pw)
    tables = out if isinstance(out, dict) else {"out": out}
    streams = {
        name: [(t, k, d, tuple(_norm(v) for v in row)) for (t, k, d, row) in capture(tab).deltas]
        for name, tab in tables.items()
    }
    pw.G.clear()
    return streams


def _strip(streams, keys):
    """(streams with every dict entry under ``keys`` removed, the removed
    values in order)."""
    removed = []

    def strip(v):
        if isinstance(v, dict):
            removed.extend(v[k] for k in keys if k in v)
            return {k: strip(x) for k, x in v.items() if k not in keys}
        if isinstance(v, (list, tuple)):
            return type(v)(strip(x) for x in v)
        return v

    return strip(streams), removed


def assert_same_streams(build, dist_tol: float = 0.0, drop: tuple = (), live: bool = False):
    """The two packages' update streams of ``build`` are identical; with
    ``dist_tol``, each hit's ``dist`` within it; entries under ``drop`` (a
    wall-clock stamp) are left out of the comparison. ``live``: a live
    connector thread's rows land in ticks by wall-clock timing, so the
    streams are compared as multisets of (key, diff, values), without the
    tick."""
    ref, _ = _strip(update_stream(pathway_tpu, build), drop)
    port, _ = _strip(update_stream(pathway_tpu_torch, build), drop)
    if live:
        ref, port = ({n: sorted(map(repr, (u[1:] for u in st))) for n, st in x.items()} for x in (ref, port))
    if dist_tol:
        (ref, ref_d), (port, port_d) = _strip(ref, ("dist",)), _strip(port, ("dist",))
        assert len(ref_d) == len(port_d)
        np.testing.assert_allclose(port_d, ref_d, rtol=0, atol=dist_tol)
    assert port == ref
    return port


def final_rows(stream) -> list:
    """The rows an update stream leaves, by key."""
    state: dict = {}
    for _t, k, d, row in stream:
        if d > 0:
            state[k] = row
        elif state.get(k) == row:
            del state[k]
    return list(state.values())


def cpu(pw) -> dict:
    """The port's factories take ``device``; the CPU here."""
    return {"device": "cpu"} if pw is pathway_tpu_torch else {}


DOCS_MD = """
    | data
1   | Kafka connector reads topics into tables.
2   | The TPU engine runs matmuls on the MXU systolic array.
3   | Bananas are yellow fruit rich in potassium.
"""


def make_docs(pw):
    return pw.debug.table_from_markdown(DOCS_MD, schema=pw.schema_from_types(data=str))


def queries(pw, rows):
    return pw.debug.table_from_rows(pw.xpacks.llm.DocumentStore.RetrieveQuerySchema, rows)


def bm25(pw):
    return pw.stdlib.indexing.TantivyBM25Factory()


def knn(pw, dim=12):
    emb = pw.xpacks.llm.mocks.FakeEmbedder(dimension=dim)
    return pw.stdlib.indexing.BruteForceKnnFactory(embedder=emb, **cpu(pw))


def tiered(pw):
    emb = pw.xpacks.llm.mocks.FakeEmbedder(dimension=16)
    if pw is pathway_tpu_torch:
        return pw.stdlib.indexing.TieredKnnFactory(embedder=emb, device="cpu")
    return pw.stdlib.indexing.TieredKnnFactory(embedder=emb)


def hybrid(pw):
    return pw.stdlib.indexing.HybridIndexFactory([bm25(pw), knn(pw, 16)])


FACTORIES = {"bm25": (bm25, 0.0), "knn": (knn, DIST_TOL), "hybrid": (hybrid, 0.0), "tiered": (tiered, DIST_TOL)}


# ---------------------------------------------------------------- DocumentStore
@pytest.mark.parametrize("factory", sorted(FACTORIES))
def test_document_store_retrieval_matches_reference(factory):
    make, tol = FACTORIES[factory]

    def build(pw):
        store = pw.xpacks.llm.DocumentStore(make_docs(pw), retriever_factory=make(pw))
        return store.retrieve_query(
            queries(
                pw,
                [
                    ("kafka topics", 2, None, None),
                    ("Bananas are yellow fruit rich in potassium.", 1, None, None),
                    ("matmuls", 3, None, None),
                ],
            )
        )

    out = assert_same_streams(build, tol)
    hits = [row[0][1] for (_t, _k, _d, row) in out["out"]]
    assert len(hits) == 3 and all(hits)


def test_document_store_default_factory_is_tiered_on_the_card():
    from pathway_tpu_torch.stdlib.indexing.retrievers import TieredKnnFactory
    from pathway_tpu_torch.xpacks.llm import DocumentStore
    from pathway_tpu_torch.xpacks.llm.mocks import FakeEmbedder

    store = DocumentStore(make_docs(pathway_tpu_torch), embedder=FakeEmbedder())
    assert isinstance(store.retriever_factory, TieredKnnFactory)
    assert store.retriever_factory.device is None  # the card, as every entry point
    with pytest.raises(ValueError, match="retriever_factory= or embedder="):
        DocumentStore(make_docs(pathway_tpu_torch))


def test_metadata_filter_and_glob_match_reference():
    def build(pw):
        docs = pw.debug.table_from_rows(
            pw.schema_from_types(data=str, _metadata=dict),
            [
                ("kafka doc one", {"path": "a/one.md", "owner": "x"}),
                ("kafka doc two", {"path": "b/two.txt", "owner": "y"}),
                ("kafka doc three", {"path": "a/three.txt", "owner": "y"}),
            ],
        )
        store = pw.xpacks.llm.DocumentStore(docs, retriever_factory=bm25(pw))
        return store.retrieve_query(
            queries(
                pw,
                [
                    ("kafka", 5, None, "a/*.md"),
                    ("kafka", 5, "owner == 'y'", None),
                    ("kafka", 5, "owner == 'y'", "a/*"),
                ],
            )
        )

    out = assert_same_streams(build)
    paths = sorted(sorted(h["metadata"]["path"] for h in row[0][1]) for (*_x, row) in out["out"])
    assert paths == [["a/one.md"], ["a/three.txt"], ["a/three.txt", "b/two.txt"]]


def test_statistics_and_inputs_match_reference():
    def build(pw):
        docs = pw.debug.table_from_rows(
            pw.schema_from_types(data=str, _metadata=dict),
            [
                ("alpha", {"path": "x.md", "modified_at": 100, "seen_at": 200}),
                ("beta", {"path": "y.txt", "modified_at": 50, "seen_at": 300}),
            ],
        )
        Store = pw.xpacks.llm.DocumentStore
        store = Store(docs, retriever_factory=bm25(pw))
        sq = pw.debug.table_from_rows(pw.schema_from_types(), [()])
        iq = pw.debug.table_from_rows(Store.InputsQuerySchema, [(None, None), ("path == 'y.txt'", None), (None, "*.md")])
        return {"stats": store.statistics_query(sq), "inputs": store.inputs_query(iq)}

    out = assert_same_streams(build)
    stats = out["stats"][-1][3][0][1]
    assert stats == {"file_count": 2, "last_modified": 100, "last_indexed": 300}
    assert sorted(len(row[0][1]) for (*_x, row) in out["inputs"]) == [1, 1, 2]


def test_index_updates_incrementally_matches_reference():
    """As-of-now: doc additions after a query do not revise old answers, and
    new queries see the new docs."""

    def build(pw):
        docs = pw.debug.table_from_markdown(
            """
                | data                  | __time__
            1   | alpha doc about kafka | 2
            2   | beta doc about tpu    | 6
            """
        )
        store = pw.xpacks.llm.DocumentStore(docs, retriever_factory=bm25(pw))
        qs = pw.debug.table_from_markdown(
            """
                | query | k | metadata_filter | filepath_globpattern | __time__
            1   | tpu   | 1 | None            | None                 | 4
            2   | tpu   | 1 | None            | None                 | 8
            """
        )
        return store.retrieve_query(qs)

    out = assert_same_streams(build)
    assert sorted(len(row[0][1]) for (*_x, row) in out["out"]) == [0, 1]


@pytest.mark.parametrize(
    "flt,expect", [("owner == 'unclosed", 0), ("contains(path, 5)", 0), (None, 1)]
)
def test_filter_errors_poison_only_their_query(flt, expect):
    def build(pw):
        store = pw.xpacks.llm.DocumentStore(make_docs(pw), retriever_factory=bm25(pw))
        return store.retrieve_query(queries(pw, [("kafka", 1, flt, None)]))

    out = assert_same_streams(build)
    assert len(out["out"][-1][3][0][1]) == expect


def test_data_index_flat_mode_matches_reference():
    def build(pw):
        store = pw.xpacks.llm.DocumentStore(make_docs(pw), retriever_factory=bm25(pw))
        q = pw.debug.table_from_rows(pw.schema_from_types(query=str), [("kafka",), ("bananas",)])
        return store.index.query_as_of_now(q.query, number_of_matches=2, collapse_rows=False).select(
            q=pw.left.query, doc=pw.right.text
        )

    assert_same_streams(build)


def test_parser_post_processor_splitter_chain_matches_reference():
    def build(pw):
        docs = pw.debug.table_from_rows(
            pw.schema_from_types(data=bytes, _metadata=dict),
            [(("word%d " % i * 40).encode() * 3, {"path": f"d{i}.txt"}) for i in range(4)],
        )
        L = pw.xpacks.llm
        store = L.DocumentStore(
            docs,
            retriever_factory=bm25(pw),
            parser=L.parsers.Utf8Parser(),
            splitter=L.splitters.TokenCountSplitter(min_tokens=10, max_tokens=30),
            doc_post_processors=[str.upper],
        )
        return {"chunks": store.chunked_docs, "parsed": store.parsed_docs}

    out = assert_same_streams(build)
    assert len(out["chunks"]) > len(out["parsed"]) == 4


# ------------------------------------------------------------------ splitters
SPLIT_TEXTS = [
    "one two three four five six seven eight nine ten",
    "Para one.\n\nPara two is a bit longer here.\n\nPara three.",
    "a " * 300 + "\n\n" + "longwordlongwordlongword " * 40,
    "",
]


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("NullSplitter", {}),
        ("TokenCountSplitter", dict(min_tokens=2, max_tokens=5)),
        ("TokenCountSplitter", dict(min_tokens=50, max_tokens=200)),
        ("RecursiveSplitter", dict(chunk_size=5)),
        ("RecursiveSplitter", dict(chunk_size=20, chunk_overlap=2)),
    ],
)
def test_splitters_match_reference(name, kwargs):
    ref = getattr(pathway_tpu.xpacks.llm.splitters, name)(**kwargs)
    port = getattr(pathway_tpu_torch.xpacks.llm.splitters, name)(**kwargs)
    for text in SPLIT_TEXTS:
        assert port.func(text) == ref.func(text)
    if name == "TokenCountSplitter" and kwargs["max_tokens"] == 5:
        assert len(port.func(SPLIT_TEXTS[0])) >= 2


def test_rerank_topk_filter_matches_reference():
    from pathway_tpu.xpacks.llm.rerankers import rerank_topk_filter as ref
    from pathway_tpu_torch.xpacks.llm.rerankers import rerank_topk_filter as port

    for docs, scores, k in ((["a", "b", "c"], [1.0, 3.0, 2.0], 2), (["x", "y"], [0.5, 0.5], 5), ([], [], 3)):
        assert port(docs, scores, k) == ref(docs, scores, k)
    assert port(["a", "b", "c"], [1.0, 3.0, 2.0], k=2) == (("b", "c"), (3.0, 2.0))


def test_fake_embedder_matches_reference():
    ref = pathway_tpu.xpacks.llm.mocks.FakeEmbedder(dimension=16)
    port = pathway_tpu_torch.xpacks.llm.mocks.FakeEmbedder(dimension=16)
    texts = ["a", "hello world", "", "naïve"]
    for a, b in zip(port.func(texts), ref.func(texts)):
        assert np.array_equal(a, b)
    assert port.dimension == 16 and port.get_embedding_dimension() == 16


# -------------------------------------------------------- question answering
def test_geometric_rag_strategy_matches_reference():
    calls = {"ref": [], "port": []}

    def build(pw):
        log = calls["port" if pw is pathway_tpu_torch else "ref"]

        def answer_fn(prompt):
            log.append(prompt)
            return "found it" if "MAGIC" in prompt else "No information found."

        chat = pw.xpacks.llm.mocks.FakeChatModel(answer_fn)
        t = pw.debug.table_from_rows(
            pw.schema_from_types(q=str, docs=list),
            [("find magic", ("doc one", "doc two", "MAGIC doc three", "doc four")), ("nothing", ("a", "b"))],
        )
        qa = pw.xpacks.llm.question_answering
        return t.select(a=qa.answer_with_geometric_rag_strategy(t.q, t.docs, chat, 1, 2, 3))

    out = assert_same_streams(build)
    assert sorted(map(repr, final_rows(out["out"]))) == sorted([repr(("found it",)), repr((None,))])
    assert sorted(calls["port"]) == sorted(calls["ref"]) and len(calls["port"]) == 6


def test_geometric_rag_strategy_from_index_matches_reference():
    def build(pw):
        store = pw.xpacks.llm.DocumentStore(make_docs(pw), retriever_factory=bm25(pw))
        chat = pw.xpacks.llm.mocks.FakeChatModel(
            lambda p: "potassium" if "Bananas" in p else "No information found."
        )
        q = pw.debug.table_from_rows(pw.schema_from_types(query=str), [("yellow bananas",), ("kafka",)])
        qa = pw.xpacks.llm.question_answering
        return q.select(
            a=qa.answer_with_geometric_rag_strategy_from_index(q.query, store.index, "text", chat, 1, 2, 2)
        )

    assert_same_streams(build)


@pytest.mark.parametrize("answerer", ["base", "adaptive"])
def test_rag_question_answerers_match_reference(answerer):
    def build(pw):
        store = pw.xpacks.llm.DocumentStore(make_docs(pw), retriever_factory=bm25(pw))
        qa = pw.xpacks.llm.question_answering
        chat = pw.xpacks.llm.mocks.FakeChatModel(
            lambda p: "Kafka answer" if "Kafka" in p else "No information found."
        )
        if answerer == "base":
            rag = qa.BaseRAGQuestionAnswerer(chat, store, search_topk=2)
        else:
            rag = qa.AdaptiveRAGQuestionAnswerer(chat, store, n_starting_documents=1, factor=2, max_iterations=2)
        qs = pw.debug.table_from_rows(
            rag.AnswerQuerySchema, [("how to read kafka", None, None), ("bananas", None, None)]
        )
        summ = pw.debug.table_from_rows(rag.SummarizeQuerySchema, [(("first text", "second text"),)])
        return {"answer": rag.answer_query(qs), "summary": rag.summarize_query(summ)}

    out = assert_same_streams(build)
    answers = sorted(str(row[0]) for (*_x, row) in out["answer"])
    assert "Kafka answer" in answers
    if answerer == "adaptive":
        assert answers == ["Kafka answer", "None"]


def test_base_answerer_prompt_holds_the_retrieved_texts_in_order():
    from pathway_tpu_torch.xpacks.llm import DocumentStore
    from pathway_tpu_torch.xpacks.llm.mocks import FakeChatModel
    from pathway_tpu_torch.xpacks.llm.question_answering import BaseRAGQuestionAnswerer

    pw = pathway_tpu_torch
    store = DocumentStore(make_docs(pw), retriever_factory=bm25(pw))
    rag = BaseRAGQuestionAnswerer(FakeChatModel(lambda p: p), store, search_topk=3)
    qs = pw.debug.table_from_rows(rag.AnswerQuerySchema, [("kafka topics tables", None, None)])
    hits = store.retrieve_query(queries(pw, [("kafka topics tables", 3, None, None)]))
    (prompt,) = [row[0] for row in _capture_port(rag.answer_query(qs)).rows.values()]
    ((res,),) = [row for row in _capture_port(hits).rows.values()]
    texts = [h["text"] for h in res.value]
    assert texts and all(t in prompt for t in texts)
    assert [prompt.index(t) for t in texts] == sorted(prompt.index(t) for t in texts)


def _serve_until(run_thread, ask, port: int, timeout: float = 30.0):
    """Once the server on ``port`` is ready, ``ask()`` until it returns a
    non-empty answer (the store indexes its docs in the run's first ticks),
    then stop the run and join it."""
    import time

    from torch_http_helpers import wait_ready

    pw = pathway_tpu_torch
    deadline = time.monotonic() + timeout
    try:
        wait_ready(port)
        while True:
            try:
                got = ask()
            except OSError:  # the server is not listening yet
                got = None
            if got or time.monotonic() > deadline:
                return got
            time.sleep(0.05)
    finally:
        while pw.internals.run.current_runtime() is None and time.monotonic() < deadline:
            time.sleep(0.01)
        pw.internals.run.current_runtime().request_stop()
        run_thread.join(timeout=60)
        assert not run_thread.is_alive(), "the server's pw.run did not stop"


def test_servers_are_a_later_slice_and_clients_keep_the_reference_api():
    """The REST servers are ported now (the name is kept from the slice that
    cut them): ``rag.build_server`` + ``run_server(threaded=True)`` and
    ``VectorStoreServer.run_server(threaded=True)`` serve ``/v1/retrieve``
    and ``/v2/answer``, read back by ``RAGClient`` and ``VectorStoreClient``;
    the clients keep the reference's API."""
    from pathway_tpu_torch.xpacks.llm import question_answering as qa
    from pathway_tpu_torch.xpacks.llm import vector_store as vs
    from pathway_tpu_torch.xpacks.llm.mocks import FakeChatModel, FakeEmbedder

    pw = pathway_tpu_torch
    pw.G.clear()
    store = pw.xpacks.llm.DocumentStore(make_docs(pw), retriever_factory=bm25(pw))
    rag = qa.BaseRAGQuestionAnswerer(FakeChatModel(), store, search_topk=1)
    with pytest.raises(RuntimeError, match="build_server"):
        rag.run_server()
    port = free_port()
    rag.build_server("127.0.0.1", port)
    assert isinstance(rag.server, pw.xpacks.llm.servers.QARestServer)
    client = qa.RAGClient(host="127.0.0.1", port=port, timeout=30)
    hits = _serve_until(rag.run_server(threaded=True), lambda: client.retrieve("kafka topics tables", k=1), port)
    assert [h["text"] for h in hits] == ["Kafka connector reads topics into tables."]
    pw.G.clear()
    store = pw.xpacks.llm.DocumentStore(make_docs(pw), retriever_factory=bm25(pw))
    rag = qa.BaseRAGQuestionAnswerer(FakeChatModel(), store, search_topk=1)
    port = free_port()
    rag.build_server("127.0.0.1", port)
    client = qa.RAGClient(host="127.0.0.1", port=port, timeout=30)

    def answer():
        got = client.answer("kafka topics tables")
        return got if "Kafka connector" in str(got) else None

    assert "Kafka connector reads topics into tables." in _serve_until(rag.run_server(threaded=True), answer, port)

    pw.G.clear()
    server = vs.VectorStoreServer(make_docs(pw), embedder=FakeEmbedder(), index_params={"device": "cpu"})
    assert isinstance(server.document_store, pw.xpacks.llm.DocumentStore)
    port = free_port()
    vclient = vs.VectorStoreClient("127.0.0.1", port, timeout=30)
    run = server.run_server("127.0.0.1", port, threaded=True)
    hits = _serve_until(run, lambda: vclient.query("Bananas are yellow fruit rich in potassium.", k=1), port)
    assert [h["text"] for h in hits] == ["Bananas are yellow fruit rich in potassium."]
    pw.G.clear()

    assert qa.RAGClient(host="h", port=1).url == "http://h:1"
    assert qa.RAGClient(url="http://x").url == "http://x"
    with pytest.raises(ValueError, match="not both"):
        qa.RAGClient(host="h", port=1, url="http://x")
    assert vs.VectorStoreClient("h", 2).url == "http://h:2"
    assert pw.xpacks.llm.__all__ == pathway_tpu.xpacks.llm.__all__


def test_prompts_match_reference():
    P, R = pathway_tpu_torch.xpacks.llm.prompts, pathway_tpu.xpacks.llm.prompts
    docs = ["doc a", "doc b"]
    assert P.prompt_qa("q?", docs, " Be brief.") == R.prompt_qa("q?", docs, " Be brief.")
    for strict in (False, True):
        assert P.prompt_qa_geometric_rag("q?", docs, strict) == R.prompt_qa_geometric_rag("q?", docs, strict)
    assert P.prompt_summarize(docs) == R.prompt_summarize(docs)
    assert P.NO_INFO_RESPONSE == R.NO_INFO_RESPONSE


# ------------------------------------------------------------ fake transports
def _completion(text: str):
    return types.SimpleNamespace(choices=[types.SimpleNamespace(message=types.SimpleNamespace(content=text))])


class FakeOpenAI:
    """``openai.AsyncOpenAI``'s shape (``.chat.completions.create``,
    ``.embeddings.create``): records requests, fails the first
    ``fail_first`` calls, tracks concurrency."""

    def __init__(self, fail_first: int = 0, dim: int = 4):
        self.requests: list = []
        self.fail_remaining = fail_first
        self.lock = threading.Lock()
        self.concurrent = 0
        self.max_concurrent = 0
        outer = self

        class _Completions:
            async def create(self, *, model, messages, **kw):
                with outer.lock:
                    outer.concurrent += 1
                    outer.max_concurrent = max(outer.max_concurrent, outer.concurrent)
                try:
                    await asyncio.sleep(0.01)
                    outer.requests.append(("chat", model, messages))
                    if outer.fail_remaining > 0:
                        outer.fail_remaining -= 1
                        raise RuntimeError("rate limited (canned)")
                    return _completion(f"echo:{messages[-1]['content']}")
                finally:
                    with outer.lock:
                        outer.concurrent -= 1

        class _Embeddings:
            async def create(self, *, input, model, **kw):  # noqa: A002
                outer.requests.append(("embed", model, list(input)))
                if outer.fail_remaining > 0:
                    outer.fail_remaining -= 1
                    raise RuntimeError("rate limited (canned)")
                return types.SimpleNamespace(data=[types.SimpleNamespace(embedding=[float(len(input[0]))] * dim)])

        self.chat = types.SimpleNamespace(completions=_Completions())
        self.embeddings = _Embeddings()


def _chat_build(make_chat, questions, fakes):
    def build(pw):
        fake = FakeOpenAI(**fakes.get("kwargs", {}))
        fakes[pw.__name__] = fake
        chat = make_chat(pw, fake)
        t = pw.debug.table_from_rows(pw.schema_from_types(q=str), [(q,) for q in questions])
        return t.select(q=t.q, a=chat(t.q))

    return build


@pytest.mark.parametrize(
    "case,fail_first,questions",
    [
        ("plain", 0, ["hello", "world"]),
        ("retry", 2, ["retry me"]),
        ("exhausted", 10, ["boom"]),
        ("capacity", 0, [f"q{i}" for i in range(12)]),
    ],
)
def test_openai_chat_matches_reference(case, fail_first, questions):
    def make_chat(pw, fake):
        llms = pw.xpacks.llm.llms
        kw = {}
        if case in ("retry", "exhausted"):
            kw["retry_strategy"] = pw.internals.udfs.FixedDelayRetryStrategy(
                max_retries=3 if case == "retry" else 2, delay_ms=5
            )
        if case == "capacity":
            kw["capacity"] = 2
        return llms.OpenAIChat(model="gpt-test", client=fake, **kw)

    fakes = {"kwargs": {"fail_first": fail_first}}
    out = assert_same_streams(_chat_build(make_chat, questions, fakes))
    port, ref = fakes["pathway_tpu_torch"], fakes["pathway_tpu"]
    assert sorted(map(repr, port.requests)) == sorted(map(repr, ref.requests))
    answers = {row[0]: row[1] for (*_x, row) in out["out"]}
    if case == "exhausted":
        assert answers == {"boom": "ERROR"} and len(port.requests) == 3
    else:
        assert answers == {q: f"echo:{q}" for q in questions}
    if case == "retry":
        assert len(port.requests) == 3
    if case == "capacity":
        assert port.max_concurrent <= 2


def test_openai_chat_cache_hits_skip_requests():
    from pathway_tpu_torch.internals.udfs import InMemoryCache
    from pathway_tpu_torch.xpacks.llm.llms import OpenAIChat

    pw = pathway_tpu_torch
    fake = FakeOpenAI()
    chat = OpenAIChat(model="gpt-test", client=fake, cache_strategy=InMemoryCache())

    def ask_once():
        pw.G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(q=str), [("same question",)])
        return [row for row in _capture_port(t.select(q=t.q, a=chat(t.q))).rows.values()]

    assert ask_once() == [("same question", "echo:same question")]
    assert ask_once() == [("same question", "echo:same question")]
    assert len(fake.requests) == 1  # the second run is a pure cache hit


@pytest.mark.parametrize("which", ["litellm", "cohere"])
def test_other_chats_match_reference(which):
    calls = {}

    def build(pw):
        log = calls.setdefault(pw.__name__, [])
        llms = pw.xpacks.llm.llms
        if which == "litellm":

            async def acompletion(*, model, messages, **kw):
                log.append((model, messages[-1]["content"]))
                return _completion(f"lite:{messages[-1]['content']}")

            chat = llms.LiteLLMChat(model="ollama/m", acompletion=acompletion)
        else:

            class FakeCohere:
                async def chat(self, *, model, message, **kw):
                    log.append((model, message))
                    return types.SimpleNamespace(text=f"co:{message}")

            chat = llms.CohereChat(model="command-x", client=FakeCohere())
        t = pw.debug.table_from_rows(pw.schema_from_types(q=str), [("ping",), ("hi",)])
        return t.select(q=t.q, a=chat(t.q))

    assert_same_streams(build)
    assert sorted(calls["pathway_tpu_torch"]) == sorted(calls["pathway_tpu"]) and len(calls["pathway_tpu"]) == 2


@pytest.mark.parametrize("module", ["litellm", "cohere", "openai", "transformers"])
def test_wrappers_gate_on_their_packages(module, monkeypatch):
    from pathway_tpu_torch.xpacks.llm import embedders, llms

    monkeypatch.setitem(sys.modules, module, None)  # the package is absent
    make = {
        "litellm": [lambda: llms.LiteLLMChat(model="m"), lambda: embedders.LiteLLMEmbedder(model="m")],
        "cohere": [lambda: llms.CohereChat()],
        "openai": [lambda: llms.OpenAIChat(), lambda: embedders.OpenAIEmbedder()],
        "transformers": [lambda: llms.HFPipelineChat(model="m")],
    }[module]
    for fn in make:
        with pytest.raises(ImportError, match=f"requires the `{module}` package"):
            fn()


def test_prompt_chat_single_qa():
    p = pathway_tpu_torch.xpacks.llm.llms.prompt_chat_single_qa("q")
    assert p.value == pathway_tpu.xpacks.llm.llms.prompt_chat_single_qa("q").value == [{"role": "user", "content": "q"}]


@pytest.mark.parametrize("which", ["openai", "litellm", "gemini"])
def test_remote_embedders_match_reference(which):
    fakes = {}

    def build(pw):
        E = pw.xpacks.llm.embedders
        if which == "openai":
            fake = fakes[pw.__name__] = FakeOpenAI(fail_first=1, dim=4)
            emb = E.OpenAIEmbedder(
                model="text-embedding-3-small",
                client=fake,
                retry_strategy=pw.internals.udfs.FixedDelayRetryStrategy(max_retries=2, delay_ms=5),
            )
            assert emb.dimension == 1536
        elif which == "litellm":

            async def aembedding(*, model, input, **kw):  # noqa: A002
                return types.SimpleNamespace(data=[{"embedding": [1.0, float(len(input[0]))]}])

            emb = E.LiteLLMEmbedder(model="m", aembedding=aembedding)
        else:

            class FakeGenai:
                @staticmethod
                def embed_content(*, model, content, **kw):
                    return {"embedding": [0.5, float(len(content))]}

            emb = E.GeminiEmbedder(client=FakeGenai())
        t = pw.debug.table_from_rows(pw.schema_from_types(txt=str), [("abc",), ("",)])
        return t.select(v=emb(t.txt))

    out = assert_same_streams(build)
    vals = sorted(row[0][3] for (*_x, row) in out["out"])
    assert all(row[0][1] == "<f4" for (*_x, row) in out["out"]) and len(vals) == 2
    if which == "openai":
        assert len(fakes["pathway_tpu_torch"].requests) == len(fakes["pathway_tpu"].requests) == 3


def test_llm_reranker_matches_reference():
    def build(pw):
        chat = pw.xpacks.llm.mocks.FakeChatModel(lambda p: "4" if "kafka" in p.lower() else "rating: 2")
        rr = pw.xpacks.llm.rerankers.LLMReranker(chat)
        t = pw.debug.table_from_rows(
            pw.schema_from_types(doc=str, query=str),
            [("Kafka reads topics", "what is kafka"), ("banana bread", "what is tpu")],
        )
        return t.select(s=rr(t.doc, t.query))

    out = assert_same_streams(build)
    assert sorted(row[0] for (*_x, row) in out["out"]) == [2.0, 4.0]


def test_new_modules_import_without_jax():
    code = (
        "import sys\n"
        "import pathway_tpu_torch, pathway_tpu_torch.xpacks.llm, pathway_tpu_torch.io.fs\n"
        "import pathway_tpu_torch.io.csv, pathway_tpu_torch.io.jsonlines, pathway_tpu_torch.io.plaintext\n"
        "import pathway_tpu_torch.io.null, pathway_tpu_torch.io._format\n"
        "from pathway_tpu_torch.xpacks.llm import _docs, _pdf, _utils, document_store, embedders, llms\n"
        "from pathway_tpu_torch.xpacks.llm import mocks, parsers, prompts, question_answering, rerankers\n"
        "from pathway_tpu_torch.xpacks.llm import splitters, vector_store\n"
        "from pathway_tpu_torch.tools import bert_checkpoint\n"
        "assert 'torch' not in sys.modules\n"
        "from pathway_tpu_torch.ops.encoder import TorchSentenceEncoder, WordPieceTokenizer, read_safetensors\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'pathway_tpu.'))"
        " or m == 'pathway_tpu']\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
