"""The S3 connector, its MinIO and CSV forms and the S3 persistence backend on
the port: a mirror of the reference's ``tests/test_gated_connectors.py`` S3
and MinIO cases with ``pathway_tpu_torch_torch`` in place of ``pathway_tpu_torch``, over
the same dict-backed boto3-shaped client (injected with
``AwsS3Settings(client=...)``: neither machine has ``boto3`` or a network).
Static jsonlines and csv reads, streaming reads that pick up new objects
and retract overwritten ones, block writes and their resumed counter, the
MinIO delegation, and the persistence backend's round trip and restart,
each held to the reference's expectations on the same inputs; a static read
is also compared with the reference's rows and keys.
"""

from __future__ import annotations

import json
import threading
import time
from collections import Counter

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.debug import _capture


def rows_of(table) -> Counter:
    """Final rows as a multiset of value tuples (ids ignored), as the
    reference's ``tests/utils.rows_of``."""
    from utils import _norm

    cap = _capture(table)
    return Counter(tuple(_norm(v) for v in row) for row in cap.rows.values())


class _Body:
    def __init__(self, data: bytes):
        self._data = data

    def read(self) -> bytes:
        return self._data


class NoSuchKey(Exception):
    pass


class FakeS3Client:
    """Dict-backed boto3-surface: get/put/delete_object + paginated
    list_objects_v2 (page size 2 to force ContinuationToken handling)."""

    PAGE = 2

    def __init__(self):
        self.objects: dict[tuple[str, str], bytes] = {}
        self.lock = threading.Lock()

    def put_object(self, *, Bucket, Key, Body):
        with self.lock:
            self.objects[(Bucket, Key)] = Body if isinstance(Body, bytes) else Body.encode()

    def get_object(self, *, Bucket, Key):
        with self.lock:
            if (Bucket, Key) not in self.objects:
                raise NoSuchKey(Key)
            return {"Body": _Body(self.objects[(Bucket, Key)])}

    def delete_object(self, *, Bucket, Key):
        with self.lock:
            self.objects.pop((Bucket, Key), None)

    def list_objects_v2(self, *, Bucket, Prefix="", ContinuationToken=None):
        with self.lock:
            keys = sorted(
                k for (b, k) in self.objects if b == Bucket and k.startswith(Prefix)
            )
        start = int(ContinuationToken) if ContinuationToken else 0
        page = keys[start : start + self.PAGE]
        truncated = start + self.PAGE < len(keys)
        resp = {
            "Contents": [{"Key": k, "ETag": f"etag-{hash(self.objects[(Bucket, k)])}"} for k in page],
            "IsTruncated": truncated,
        }
        if truncated:
            resp["NextContinuationToken"] = str(start + self.PAGE)
        return resp


def test_s3_static_read_jsonlines_and_csv():
    cli = FakeS3Client()
    for i in range(5):  # 5 objects -> 3 paginated listing pages
        cli.put_object(
            Bucket="b",
            Key=f"data/part{i}.jsonl",
            Body=f'{{"w": "doc{i}", "n": {i}}}\n'.encode(),
        )
    G.clear()
    t = pw.io.s3.read(
        "s3://b/data/",
        format="json",
        schema=pw.schema_from_types(w=str, n=int),
        mode="static",
        client=cli,
    )
    assert sorted(rows_of(t)) == [(f"doc{i}", i) for i in range(5)]

    cli.put_object(Bucket="b", Key="csv/a.csv", Body=b"w,n\nx,1\ny,2\n")
    G.clear()
    t = pw.io.s3_csv.read(
        "s3://b/csv/",
        schema=pw.schema_from_types(w=str, n=int),
        mode="static",
        client=cli,
    )
    assert sorted(rows_of(t)) == [("x", 1), ("y", 2)]


def test_s3_streaming_picks_up_new_objects():
    cli = FakeS3Client()
    cli.put_object(Bucket="b", Key="in/0.txt", Body=b"alpha\nbeta\n")
    G.clear()
    t = pw.io.s3.read("s3://b/in/", format="plaintext", mode="streaming", client=cli)
    got = []
    pw.io.subscribe(
        t, on_change=lambda key, row, time, is_addition: got.append(row["data"])
    )

    def later():
        time.sleep(0.3)
        cli.put_object(Bucket="b", Key="in/1.txt", Body=b"gamma\n")
        time.sleep(0.4)
        rt = pw.internals.run.current_runtime()
        if rt is not None:
            rt.request_stop()

    threading.Thread(target=later, daemon=True).start()
    pw.run(monitoring_level="none")
    assert sorted(got) == ["alpha", "beta", "gamma"]


def test_s3_write_blocks():
    cli = FakeS3Client()
    G.clear()
    t = pw.debug.table_from_rows(
        pw.schema_from_types(w=str, n=int), [("a", 1), ("b", 2)]
    )
    pw.io.s3.write(t, "s3://b/out", client=cli)
    pw.run(monitoring_level="none")
    blocks = [v for (bk, k), v in cli.objects.items() if k.startswith("out/")]
    assert blocks
    recs = [json.loads(line) for blk in blocks for line in blk.decode().splitlines()]
    assert sorted((r["w"], r["n"], r["diff"]) for r in recs) == [
        ("a", 1, 1),
        ("b", 2, 1),
    ]


def test_minio_delegates_to_s3():
    cli = FakeS3Client()
    cli.put_object(Bucket="mb", Key="d/x.jsonl", Body=b'{"v": 7}\n')
    from pathway_tpu_torch.io.minio import MinIOSettings

    G.clear()
    t = pw.io.minio.read(
        "d/",
        MinIOSettings(endpoint="http://localhost:9000", bucket_name="mb", client=cli),
        format="json",
        schema=pw.schema_from_types(v=int),
        mode="static",
    )
    assert list(rows_of(t)) == [(7,)]


def test_s3_persistence_backend_roundtrip():
    from pathway_tpu_torch.persistence.backends import S3Backend

    cli = FakeS3Client()
    b = S3Backend(cli, "bucket", "pstate")
    b.put("inputs/src/chunk_0", b"data")
    b.put("inputs/src/metadata", b"meta")
    assert b.get("inputs/src/metadata") == b"meta"
    assert b.get("missing") is None
    assert b.list_keys("inputs/src/") == [
        "inputs/src/chunk_0",
        "inputs/src/metadata",
    ]
    b.delete("inputs/src/chunk_0")
    assert b.get("inputs/src/chunk_0") is None


def test_s3_persistence_end_to_end_restart():
    """Full restart recovery over the object store: the same contract the
    filesystem backend passes in test_persistence.py."""
    from tests.test_persistence import ListSubject, S

    cli = FakeS3Client()
    from pathway_tpu_torch.io.s3 import AwsS3Settings

    backend = pw.persistence.Backend.s3(
        "s3://bucket/pstate", AwsS3Settings(client=cli)
    )

    def session(rows, collect):
        G.clear()
        subj = ListSubject(rows)
        t = pw.io.python.read(subj, schema=S, name="wordsource")
        agg = t.groupby(pw.this.word).reduce(
            pw.this.word, total=pw.reducers.sum(pw.this.count)
        )
        pw.io.subscribe(
            agg,
            on_change=lambda key, row, time, is_addition: collect.__setitem__(
                row["word"], row["total"]
            )
            if is_addition
            else None,
        )
        pw.run(persistence_config=pw.persistence.Config(backend=backend))

    out1: dict = {}
    session([("a", 1), ("b", 2), ("a", 3)], out1)
    assert out1 == {"a": 4, "b": 2}
    # restart with a longer deterministic source: replay + seek past 3 events
    out2: dict = {}
    session([("a", 1), ("b", 2), ("a", 3), ("b", 10), ("c", 5)], out2)
    assert out2 == {"a": 4, "b": 12, "c": 5}
    assert any(k for (_b, k) in cli.objects if "pstate" in k)


def test_s3_streaming_overwrite_retracts_old_rows():
    """Etag change = full object replacement: the old version's rows retract
    (reference metadata-tracker semantics), so aggregates don't double-count."""
    cli = FakeS3Client()
    cli.put_object(Bucket="b", Key="d/x.jsonl", Body=b'{"w": "a", "n": 1}\n')
    G.clear()
    t = pw.io.s3.read(
        "s3://b/d/",
        format="json",
        schema=pw.schema_from_types(w=str, n=int),
        mode="streaming",
        client=cli,
    )
    g = t.groupby(t.w).reduce(t.w, s=pw.reducers.sum(t.n))
    state = {}
    pw.io.subscribe(
        g,
        on_change=lambda key, row, time, is_addition: state.__setitem__(
            row["w"], row["s"]
        )
        if is_addition
        else state.pop(row["w"], None),
    )

    def later():
        time.sleep(0.3)
        cli.put_object(Bucket="b", Key="d/x.jsonl", Body=b'{"w": "a", "n": 10}\n')
        time.sleep(0.35)
        cli.delete_object(Bucket="b", Key="d/x.jsonl")
        time.sleep(0.35)
        rt = pw.internals.run.current_runtime()
        if rt is not None:
            rt.request_stop()

    threading.Thread(target=later, daemon=True).start()
    pw.run(monitoring_level="none")
    # overwrite replaced (not added to) the aggregate; deletion cleared it
    assert state == {}, state


def test_s3_write_resumes_block_counter():
    cli = FakeS3Client()
    for run_i in range(2):
        G.clear()
        t = pw.debug.table_from_rows(
            pw.schema_from_types(n=int), [(run_i,)]
        )
        pw.io.s3.write(t, "s3://b/out2", client=cli)
        pw.run(monitoring_level="none")
    keys = sorted(k for (_b, k) in cli.objects if k.startswith("out2/"))
    assert len(keys) == 2 and len(set(keys)) == 2, keys  # no clobbering


def test_s3_static_read_matches_the_reference():
    """The same objects read by both packages: the same rows under the same
    keys."""
    import pathway_tpu as ref_pw
    from pathway_tpu.debug import _capture as ref_capture

    got = {}
    for name, p, cap in (("ref", ref_pw, ref_capture), ("port", pw, _capture)):
        cli = FakeS3Client()
        for i in range(6):
            cli.put_object(Bucket="bkt", Key=f"docs/{i}.jsonl",
                           Body=json.dumps({"text": f"doc{i}", "n": i}).encode())
        cli.put_object(Bucket="bkt", Key="csv/a.csv", Body=b"word,n\nx,1\ny,2\n")
        p.G.clear()
        s = p.io.s3.AwsS3Settings(client=cli)
        t = p.io.s3.read("s3://bkt/docs/", format="json", schema=p.schema_from_types(text=str, n=int),
                         mode="static", aws_s3_settings=s)
        c = p.io.s3_csv.read("s3://bkt/csv/", schema=p.schema_from_types(word=str, n=int), mode="static",
                             aws_s3_settings=s)
        got[name] = [sorted((int(k), tuple(r)) for k, r in cap(x).rows.items()) for x in (t, c)]
        p.G.clear()
    assert got["port"] == got["ref"]
    assert len(got["ref"][0]) == 6 and len(got["ref"][1]) == 2
