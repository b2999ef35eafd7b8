"""Persistence KV backends (reference ``src/persistence/backends/``: file, s3,
memory, mock — a flat key→bytes store).

``MemoryBackend`` keeps a process-global store keyed by root (so a "restart" in
tests — a fresh Runtime in the same process — sees the previous run's state, the
in-process analogue of the reference's kill-the-subprocess recovery tests).

Carried from ``pathway_tpu/persistence/backends.py``. ``S3Backend`` runs over
any boto3-shaped client; a ``Backend.s3`` config builds it with the S3
connector's client (``io.s3``).
"""

from __future__ import annotations

import os
import threading


class KVBackend:
    def put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes | None:
        raise NotImplementedError

    def list_keys(self, prefix: str = "") -> list[str]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError


class FileBackend(KVBackend):
    """One file per key under a root directory ('/' in keys maps to subdirs)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, key: str) -> str:
        path = os.path.join(self.root, key)
        if os.path.commonpath([os.path.abspath(path), os.path.abspath(self.root)]) != os.path.abspath(self.root):
            raise ValueError(f"key escapes backend root: {key!r}")
        return path

    def put(self, key: str, value: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with self._lock:
            with open(tmp, "wb") as f:
                f.write(value)
                # the epoch/manifest commit protocol treats a completed put as
                # DURABLE (a barrier ack may immediately follow); fsync before
                # the atomic publish so a host crash can't leave a committed
                # manifest pointing at torn state
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)  # atomic publish

    def get(self, key: str) -> bytes | None:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def list_keys(self, prefix: str = "") -> list[str]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                if fn.endswith(".tmp"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass


_MEMORY_STORES: dict[str, dict[str, bytes]] = {}
_MEMORY_LOCK = threading.Lock()


class MemoryBackend(KVBackend):
    def __init__(self, root: str = "default"):
        with _MEMORY_LOCK:
            self._store = _MEMORY_STORES.setdefault(root, {})

    def put(self, key: str, value: bytes) -> None:
        with _MEMORY_LOCK:
            self._store[key] = value

    def get(self, key: str) -> bytes | None:
        with _MEMORY_LOCK:
            return self._store.get(key)

    def list_keys(self, prefix: str = "") -> list[str]:
        with _MEMORY_LOCK:
            return sorted(k for k in self._store if k.startswith(prefix))

    def delete(self, key: str) -> None:
        with _MEMORY_LOCK:
            self._store.pop(key, None)

    @staticmethod
    def clear(root: str = "default") -> None:
        with _MEMORY_LOCK:
            _MEMORY_STORES.pop(root, None)


class MockBackend(MemoryBackend):
    """Records the operation log for assertions (reference mock backend)."""

    def __init__(self, root: str = "mock"):
        super().__init__(root)
        self.operations: list[tuple[str, str]] = []

    def put(self, key: str, value: bytes) -> None:
        self.operations.append(("put", key))
        super().put(key, value)

    def get(self, key: str) -> bytes | None:
        self.operations.append(("get", key))
        return super().get(key)


class S3Backend(KVBackend):
    """Object-store KV (reference ``src/persistence/backends/s3.rs``): one
    object per key under a root prefix, over a boto3-style client (injectable
    — this image has neither boto3 nor egress, so CI drives this against a
    dict-backed fake; see ``tests/test_gated_connectors.py``)."""

    def __init__(self, client, bucket: str, root: str):
        self.client = client
        self.bucket = bucket
        self.root = root.strip("/")

    def _key(self, key: str) -> str:
        return f"{self.root}/{key}" if self.root else key

    def put(self, key: str, value: bytes) -> None:
        self.client.put_object(Bucket=self.bucket, Key=self._key(key), Body=value)

    def get(self, key: str) -> bytes | None:
        try:
            resp = self.client.get_object(Bucket=self.bucket, Key=self._key(key))
        except Exception as e:
            # ONLY a genuinely-missing key maps to None — an AccessDenied /
            # throttle / 500 must surface, not silently restart the pipeline
            # from empty state
            if type(e).__name__ == "NoSuchKey":
                return None
            code = (
                getattr(e, "response", None) or {}
            ).get("Error", {}).get("Code")
            if code in ("NoSuchKey", "404"):
                return None
            raise
        return resp["Body"].read()

    def list_keys(self, prefix: str = "") -> list[str]:
        out = []
        token = None
        full = self._key(prefix)
        while True:
            kw = {"Bucket": self.bucket, "Prefix": full}
            if token:
                kw["ContinuationToken"] = token
            resp = self.client.list_objects_v2(**kw)
            strip = len(self.root) + 1 if self.root else 0
            out.extend(obj["Key"][strip:] for obj in resp.get("Contents", []))
            if not resp.get("IsTruncated"):
                break
            token = resp.get("NextContinuationToken")
        return sorted(out)

    def delete(self, key: str) -> None:
        self.client.delete_object(Bucket=self.bucket, Key=self._key(key))


def backend_from_config(backend) -> KVBackend:
    if backend.kind == "filesystem":
        return FileBackend(backend.path)
    if backend.kind == "memory":
        return MemoryBackend(backend.path or "default")
    if backend.kind == "mock":
        return MockBackend(backend.path or "mock")
    if backend.kind == "s3":
        from pathway_tpu_torch.io.s3 import _make_client, _split_path

        settings = backend.extra.get("bucket_settings")
        client = _make_client(settings)
        bucket, prefix = _split_path(backend.path or "", settings)
        return S3Backend(client, bucket, prefix)
    raise ValueError(f"unknown persistence backend kind {backend.kind!r}")
