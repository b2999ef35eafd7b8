"""The port's Google Drive connector (``pathway_tpu_torch/io/gdrive.py``)
against the JAX package's over an injected fake transport, mirroring
``tests/test_gdrive.py`` case by case: a static read, a live add, modify and
delete, the object cache (one download of an unchanged file across polls),
metadata with the name pattern and size limit, and the transport gates.

Rows are keyed by file id on both packages, so the final state compares by
key; the fake counts downloads so the cache compares too.
"""

from __future__ import annotations

import threading
import time
import warnings

import pytest

from torch_connector_helpers import collect, run_live, same


class FakeDrive:
    """files().list/get + download semantics over a dict; mutate between
    polls to simulate live Drive edits. Counts downloads so the object
    cache is observable."""

    def __init__(self):
        self.files: dict[str, dict] = {}
        self.payloads: dict[str, bytes] = {}
        self.downloads = 0
        self.lock = threading.Lock()

    def put(self, fid, name, data, mtime, size=None, mime="text/plain"):
        with self.lock:
            self.files[fid] = {"id": fid, "name": name, "mimeType": mime, "modifiedTime": mtime,
                               "size": str(size if size is not None else len(data))}
            self.payloads[fid] = data

    def delete(self, fid):
        with self.lock:
            self.files.pop(fid, None)
            self.payloads.pop(fid, None)

    def tree(self, object_id):
        with self.lock:
            return {fid: dict(m) for fid, m in self.files.items()}

    def download(self, meta):
        with self.lock:
            self.downloads += 1
            return self.payloads.get(meta["id"])


def test_gdrive_static_read():
    def scenario(pw):
        drive = FakeDrive()
        drive.put("f1", "a.txt", b"alpha", "2024-01-01T00:00:00Z")
        drive.put("f2", "b.txt", b"beta", "2024-01-01T00:00:01Z")
        state = collect(pw, pw.io.gdrive.read("root", mode="static", client=drive))
        pw.run(monitoring_level="none")
        return state

    state = same(scenario)
    assert sorted(state.values()) == [b"alpha", b"beta"]


def test_gdrive_streaming_add_modify_delete():
    def scenario(pw):
        drive = FakeDrive()
        drive.put("f1", "a.txt", b"v1", "2024-01-01T00:00:00Z")
        state = collect(pw, pw.io.gdrive.read("root", client=drive, _poll_interval=0.05))
        steps = [
            lambda: drive.put("f2", "b.txt", b"new", "2024-01-01T00:01:00Z"),  # add
            lambda: drive.put("f1", "a.txt", b"v2", "2024-01-01T00:02:00Z"),  # modify
            lambda: drive.delete("f2"),  # delete
        ]
        seen = []

        def cond():
            want = [{"f1": b"v1"}, {"f1": b"v1", "f2": b"new"}, {"f1": b"v2", "f2": b"new"}, {"f1": b"v2"}]
            if len(seen) < len(want) and sorted(state.values()) == sorted(want[len(seen)].values()):
                seen.append(dict(state))
                if len(seen) <= len(steps):
                    steps[len(seen) - 1]()
            return len(seen) == len(want)

        run_live(pw, cond, settle=0.2)
        return seen

    seen = same(scenario)
    assert sorted(seen[-1].values()) == [b"v2"]  # f1 modified in place, f2 removed


def test_gdrive_object_cache_skips_unchanged():
    def scenario(pw):
        drive = FakeDrive()
        drive.put("f1", "a.txt", b"v1", "2024-01-01T00:00:00Z")
        state = collect(pw, pw.io.gdrive.read("root", client=drive, _poll_interval=0.02))
        t0 = time.time()
        run_live(pw, lambda: state and time.time() - t0 > 0.6)  # ~30 polls of an unchanged tree
        return drive.downloads, state

    downloads, _state = same(scenario)
    assert downloads == 1  # a cache hit on every re-poll


def test_gdrive_with_metadata_and_filters():
    def scenario(pw):
        drive = FakeDrive()
        drive.put("f1", "a.txt", b"alpha", "2024-01-01T00:00:00Z")
        drive.put("f2", "b.bin", b"x" * 100, "2024-01-01T00:00:00Z")
        drive.put("f3", "big.txt", b"y" * 10_000, "2024-01-01T00:00:00Z")
        t = pw.io.gdrive.read("root", mode="static", client=drive, with_metadata=True,
                              object_size_limit=1000, file_name_pattern="*.txt")
        state = collect(pw, t, column="")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pw.run(monitoring_level="none")
        return state, sorted(str(w.message) for w in caught if "exceeds limit" in str(w.message))

    state, warned = same(scenario)
    assert warned
    ((row),) = state.values()
    assert row["data"] == b"alpha"  # .bin filtered by pattern, big.txt by size
    meta = row["_metadata"]
    meta = meta[1] if isinstance(meta, tuple) else meta  # a Json value, by content
    assert meta["path"] == "a.txt" and meta["status"] == "downloaded"
    assert meta["url"].startswith("https://drive.google.com/file/d/f1")


def test_gdrive_requires_transport():
    def scenario(pw):
        errors = []
        with pytest.raises(ValueError, match="client=") as e:
            pw.io.gdrive.read("root")
        errors.append(str(e.value))
        with pytest.raises(NotImplementedError, match="google-api-python-client") as e:
            pw.io.gdrive.read("root", service_user_credentials_file="/nonexistent.json")
        errors.append(str(e.value))
        return errors

    same(scenario)
