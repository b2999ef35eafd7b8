"""Airbyte connector — the serverless execution path (reference
``python/pathway/io/airbyte`` + vendored ``third_party/airbyte_serverless``).

The reference runs an Airbyte source connector program (docker image or
installed venv) and parses its stdout: JSON-lines Airbyte-protocol messages
(``CATALOG``/``RECORD``/``STATE``/``LOG``). Docker execution is an
optional dependency, so that execution type gates — but the SERVERLESS path is
real: ``ExecutableRunner`` spawns any local command implementing the
protocol (``<argv> discover --config …`` / ``<argv> read --config
--catalog [--state]``, the same contract ``airbyte_serverless``'s
``executable_runner.py`` drives inside its containers) and the connector's
records stream into the table. A custom ``runner=`` injects the transport
for tests; ``tests/test_torch_connectors_airbyte.py`` also exercises the real subprocess
path with a protocol-speaking Python connector.

Result schema matches the reference: one ``data`` JSON column per record
(``_AirbyteRecordSchema``). ``STATE`` messages checkpoint the source: the
latest state persists with the input offsets and hands back to the
connector on restart (incremental sync resume).
"""

from __future__ import annotations

import json as _json
import os
import subprocess
import sys
import tempfile
import time as _time
from typing import Any, Sequence

from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table

FULL_REFRESH_SYNC_MODE = "full_refresh"
INCREMENTAL_SYNC_MODE = "incremental"


def _load_connection(config: Any) -> dict:
    """Accept a dict, a YAML/JSON file path, or YAML text (the
    ``abs create``-style connection document: ``{source: {…}}``)."""
    if isinstance(config, dict):
        doc = config
    else:
        if isinstance(config, os.PathLike) or (
            isinstance(config, str) and "\n" not in config
        ):
            # a path-shaped argument must BE a file — feeding a typo'd path
            # through the YAML parser would yield a baffling 'str has no
            # attribute get' instead of file-not-found
            if not os.path.exists(config):
                raise FileNotFoundError(
                    f"airbyte connection config file not found: {config!r}"
                )
            with open(config, encoding="utf-8") as fh:
                text = fh.read()
        elif isinstance(config, str):
            text = config  # inline YAML/JSON document
        else:
            raise ValueError(f"unsupported airbyte config: {config!r}")
        try:
            import yaml

            doc = yaml.safe_load(text)
        except ImportError:
            doc = _json.loads(text)
        if not isinstance(doc, dict):
            raise ValueError(f"airbyte connection config is not a mapping: {config!r}")
    return doc.get("source", doc)


class ExecutableRunner:
    """Run a local Airbyte connector command (the serverless venv mode):
    ``argv spec|discover|read`` with ``--config``/``--catalog``/``--state``
    temp files, stdout parsed as protocol JSON lines."""

    def __init__(self, argv: Sequence[str], env: dict | None = None, timeout: float = 300.0):
        self.argv = list(argv)
        self.env = env
        self.timeout = timeout

    def _run(self, args: list[str]) -> list[dict]:
        env = dict(os.environ, **(self.env or {}))
        proc = subprocess.run(
            self.argv + args,
            capture_output=True,
            text=True,
            timeout=self.timeout,
            env=env,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"airbyte connector {self.argv} failed "
                f"({proc.returncode}): {(proc.stderr or proc.stdout)[-500:]}"
            )
        messages = []
        for line in proc.stdout.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                messages.append(_json.loads(line))
            except ValueError:
                continue  # connectors may print non-protocol noise
        return messages

    def discover(self, config: dict) -> list[dict]:
        with tempfile.TemporaryDirectory() as td:
            cfg = os.path.join(td, "config.json")
            with open(cfg, "w") as fh:
                _json.dump(config, fh)
            for m in self._run(["discover", "--config", cfg]):
                if m.get("type") == "CATALOG":
                    return m["catalog"]["streams"]
        raise RuntimeError("airbyte connector produced no CATALOG message")

    def read(self, config: dict, catalog: dict, state: Any = None) -> list[dict]:
        with tempfile.TemporaryDirectory() as td:
            cfg = os.path.join(td, "config.json")
            cat = os.path.join(td, "catalog.json")
            with open(cfg, "w") as fh:
                _json.dump(config, fh)
            with open(cat, "w") as fh:
                _json.dump(catalog, fh)
            args = ["read", "--config", cfg, "--catalog", cat]
            if state is not None:
                st = os.path.join(td, "state.json")
                with open(st, "w") as fh:
                    _json.dump(state, fh)
                args += ["--state", st]
            return self._run(args)


def _configured_catalog(streams_meta: list[dict], streams: Sequence[str]) -> dict:
    available = {s["name"]: s for s in streams_meta}
    missing = [s for s in streams if s not in available]
    if missing:
        raise ValueError(
            f"airbyte streams not found: {missing}; available: {sorted(available)}"
        )
    configured = []
    for name in streams:
        meta = available[name]
        modes = meta.get("supported_sync_modes", [FULL_REFRESH_SYNC_MODE])
        sync_mode = (
            INCREMENTAL_SYNC_MODE
            if INCREMENTAL_SYNC_MODE in modes
            else FULL_REFRESH_SYNC_MODE
        )
        configured.append(
            {
                "stream": meta,
                "sync_mode": sync_mode,
                "destination_sync_mode": "append",
            }
        )
    return {"streams": configured}


def read(
    config: Any,
    streams: Sequence[str],
    *,
    mode: str = "streaming",
    execution_type: str = "local",
    refresh_interval_ms: int = 60000,
    runner: Any = None,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    """Read Airbyte streams into a table of ``data`` JSON records."""
    if mode not in ("streaming", "static"):
        raise ValueError(f"unknown airbyte mode {mode!r}")
    if execution_type not in ("local", "remote"):
        raise ValueError(f"unknown airbyte execution_type {execution_type!r}")
    unknown = [k for k in kwargs if not k.startswith("_")]
    if unknown:
        raise TypeError(f"pw.io.airbyte.read: unknown options {unknown}")
    source = _load_connection(config)
    source_config = source.get("config", {})
    if runner is None:
        if execution_type == "remote":
            raise NotImplementedError(
                "pw.io.airbyte execution_type='remote' needs a cloud runner "
                "not available in this environment"
            )
        executable = source.get("executable")
        if executable:
            argv = executable if isinstance(executable, list) else [executable]
            # connectors shipped as python scripts run under this interpreter
            if len(argv) == 1 and str(argv[0]).endswith(".py"):
                argv = [sys.executable, argv[0]]
            runner = ExecutableRunner(argv, env=source.get("env"))
        elif source.get("docker_image"):
            raise NotImplementedError(
                "pw.io.airbyte docker execution requires docker, which is not "
                "available in this environment; ship the connector as a local "
                "executable (source.executable) or inject runner="
            )
        else:
            raise ValueError(
                "airbyte source config needs 'executable' (serverless local "
                "run) or 'docker_image'"
            )

    from pathway_tpu_torch.internals.json import Json
    from pathway_tpu_torch.internals.keys import stable_hash_obj
    from pathway_tpu_torch.io.python import ConnectorSubject, read as py_read

    schema = schema_mod.schema_from_types(data=dict)
    selected = list(streams)
    poll_s = kwargs.get("_poll_interval", refresh_interval_ms / 1000.0)

    class _AirbyteSubject(ConnectorSubject):
        def __init__(self) -> None:
            super().__init__()
            self._stop = False
            # per-stream STATE registry: Airbyte emits one STATE
            # message per stream descriptor (type STREAM), or a single GLOBAL /
            # LEGACY document. Keeping only the LAST message dropped every
            # other stream's cursor, so a multi-stream incremental sync
            # re-synced all but one stream from scratch on the next read.
            # Keyed by descriptor; the merged document hands back on read.
            self._states: dict[tuple, Any] = {}
            # live keys of full-refresh streams from the previous poll — a
            # re-read that no longer contains a key retracts it (upstream
            # deletion); incremental streams are append-only
            self._fr_live: set[int] = set()

        def _on_state(self, state: Any) -> None:
            stype = state.get("type") if isinstance(state, dict) else None
            if stype == "STREAM":
                desc = (state.get("stream") or {}).get("stream_descriptor") or {}
                key = ("STREAM", desc.get("name"), desc.get("namespace"))
            elif stype == "GLOBAL":
                key = ("GLOBAL", None, None)
            else:  # legacy state blob ({"data": …} or a bare cursor document)
                key = ("LEGACY", None, None)
            self._states[key] = state

        def _merged_state(self) -> Any:
            """The state document for the next ``read``: a list of
            AirbyteStateMessages (per-stream / global), or — for legacy-only
            connectors — the bare legacy blob, matching what they emitted."""
            if not self._states:
                return None
            if set(self._states) == {("LEGACY", None, None)}:
                legacy = self._states[("LEGACY", None, None)]
                if isinstance(legacy, dict) and "data" in legacy:
                    return legacy["data"]
                return legacy
            return [self._states[k] for k in sorted(self._states, key=str)]

        def run(self) -> None:
            import warnings

            catalog = _configured_catalog(runner.discover(source_config), selected)
            full_refresh = {
                s["stream"]["name"]
                for s in catalog["streams"]
                if s["sync_mode"] == FULL_REFRESH_SYNC_MODE
            }
            while not self._stop:
                try:
                    messages = runner.read(source_config, catalog, self._merged_state())
                except Exception as e:  # noqa: BLE001 — transient connector errors retry
                    if mode == "static":
                        raise
                    warnings.warn(
                        f"airbyte read failed ({e!r}); retrying in {poll_s}s",
                        stacklevel=2,
                    )
                    _time.sleep(poll_s)
                    continue
                assert self._node is not None
                events = []
                # duplicate payloads are distinct rows: the key carries an
                # occurrence ordinal per (stream, content) within one read,
                # stable across full-refresh re-reads
                occurrence: dict[tuple, int] = {}
                fr_seen: set[int] = set()
                for m in messages:
                    t = m.get("type")
                    if t == "RECORD":
                        rec = m["record"]
                        stream = rec.get("stream")
                        if stream not in selected:
                            continue
                        payload = rec.get("data", {})
                        ck = (stream, _json.dumps(payload, sort_keys=True))
                        ordinal = occurrence.get(ck, 0)
                        occurrence[ck] = ordinal + 1
                        key = int(stable_hash_obj(("airbyte", *ck, ordinal)))
                        events.append((key, (Json(payload),), 1))
                        if stream in full_refresh:
                            fr_seen.add(key)
                    elif t == "STATE":
                        self._on_state(m.get("state") or {})
                # upstream deletions in full-refresh streams: keys present
                # last poll but absent now retract (upsert session delete)
                if mode == "streaming":
                    for gone in self._fr_live - fr_seen:
                        events.append((gone, None, -1))
                self._fr_live = fr_seen
                self._node.push_many(events)
                if mode == "static":
                    return
                # incremental sources resume from self._state next poll;
                # full-refresh re-reads replace content in place (upsert keys)
                _time.sleep(poll_s)

        @property
        def _session_type(self) -> str:
            # full-refresh polls re-emit the whole stream; upsert semantics
            # (key = stream+content) dedup replays in place
            return "upsert" if mode == "streaming" else "native"

        # persistence contract: the connector's own STATE is the offset;
        # the full-refresh live-key set travels with it so deletions that
        # happen across a restart still retract
        def offset_state(self) -> dict:
            return {
                # the merged doc under the legacy key keeps old snapshots
                # readable; the per-stream registry restores losslessly
                "airbyte_state": self._merged_state(),
                "airbyte_states": dict(self._states),
                "fr_live": sorted(self._fr_live),
                "seq": self._seq,
            }

        def seek(self, state: dict) -> None:
            if "airbyte_states" in state:
                self._states = dict(state["airbyte_states"])
            else:
                # snapshot from before per-stream states: a single opaque doc
                legacy = state.get("airbyte_state")
                self._states = (
                    {("LEGACY", None, None): legacy} if legacy is not None else {}
                )
            self._fr_live = set(state.get("fr_live", []))
            self._seq = int(state.get("seq", 0))

        def on_stop(self) -> None:
            self._stop = True

    return py_read(
        _AirbyteSubject(), schema=schema, name=name or f"airbyte:{','.join(selected)}"
    )
