"""Persistence config & backends (reference: ``python/pathway/persistence/__init__.py``
+ ``src/persistence/``): ``pw.persistence.Config`` for ``pw.run``, the
filesystem, memory and mock backends, and the committed-epoch reader.

Carried from ``pathway_tpu/persistence/__init__.py`` with imports rewritten,
the S3 backend included."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


class Backend:
    kind: str = "memory"
    path: str | None = None

    def __init__(self, kind: str, path: str | None = None, **kwargs: Any):
        self.kind = kind
        self.path = path
        self.extra = kwargs

    @classmethod
    def filesystem(cls, path: str) -> "Backend":
        return cls("filesystem", path)

    @classmethod
    def s3(cls, root_path: str, bucket_settings: Any = None) -> "Backend":
        """Object-store persistence (reference ``backends/s3.rs``).
        ``bucket_settings`` is ``pw.io.s3.AwsS3Settings``; its ``client=``
        hook injects any boto3-shaped object where boto3 itself is absent."""
        return cls("s3", root_path, bucket_settings=bucket_settings)

    @classmethod
    def mock(cls, events: Any = None) -> "Backend":
        return cls("mock")

    @classmethod
    def memory(cls) -> "Backend":
        return cls("memory")


@dataclass
class Config:
    backend: Backend
    #: operator-snapshot cadence; <=0 = snapshot only at shutdown (default),
    #: so steady-state ticks never pay O(state) serialization
    snapshot_interval_ms: int = 0
    persistence_mode: str = "persisting"
    snapshot_access: str = "full"
    continue_after_replay: bool = True

    @classmethod
    def simple_config(cls, backend: Backend, **kwargs: Any) -> "Config":
        return cls(backend=backend, **kwargs)


def attach_persistence(runtime: Any, config: Config) -> None:
    from pathway_tpu_torch.persistence.snapshots import attach

    attach(runtime, config)


def last_committed_epoch(backend_or_config: Any) -> Any:
    """Newest fully-committed checkpoint epoch (``resilience`` subsystem):
    ``{"epoch", "tick", "input_offsets", "opsnap_gen", "acks", …}`` or None.
    Accepts a ``Backend``, ``Config``, or raw ``KVBackend``."""
    from pathway_tpu_torch.persistence.snapshots import read_epoch_manifest

    return read_epoch_manifest(backend_or_config)
