"""Google Drive connector: polling reader with object cache and deletions
detection (reference ``python/pathway/io/gdrive/__init__.py``, 417 LoC).

The Google API client libraries are optional, so the transport is
INJECTABLE (the S3/Kafka fake-client pattern):
pass ``client=`` any object exposing the two calls the reference makes —

- ``tree(object_id) -> dict[file_id, meta]`` where meta carries at least
  ``id``, ``name``, ``mimeType``, ``modifiedTime`` and optionally ``size``
  (the reference's ``files().list``/``get`` + folder recursion), and
- ``download(meta) -> bytes | None`` (``get_media`` / ``export_media``).

Without an injected client the module tries the real google libraries and
raises the dependency gate otherwise. Poll-loop semantics mirror the
reference exactly: every ``refresh_interval`` the listing is re-fetched;
new and modified files (by ``modifiedTime``) upsert keyed by file id,
removed files retract (streaming runs use an upsert session; static runs
read one listing and finish). ``object_size_limit`` skips oversized files,
``file_name_pattern`` (glob or list of globs) filters by name.
"""

from __future__ import annotations

import fnmatch
import time as _time
import warnings
from typing import Any

from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.keys import stable_hash_obj
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io.python import ConnectorSubject, read as py_read

#: Google-native docs export to Office formats (reference DEFAULT_MIME_TYPE_MAPPING)
DEFAULT_MIME_TYPE_MAPPING: dict[str, str] = {
    "application/vnd.google-apps.document": "application/vnd.openxmlformats-officedocument.wordprocessingml.document",
    "application/vnd.google-apps.spreadsheet": "application/vnd.openxmlformats-officedocument.spreadsheetml.sheet",
    "application/vnd.google-apps.presentation": "application/vnd.openxmlformats-officedocument.presentationml.presentation",  # noqa: E501
}

MIME_TYPE_FOLDER = "application/vnd.google-apps.folder"


def _filter_files(
    files: list[dict],
    object_size_limit: int | None,
    file_name_pattern: list | str | None,
) -> list[dict]:
    out = []
    for f in files:
        if object_size_limit is not None:
            if "size" not in f:
                warnings.warn(
                    f"skipping gdrive object {f.get('name')}: no size (symlink?)",
                    stacklevel=2,
                )
                continue
            if int(f["size"]) > object_size_limit:
                warnings.warn(
                    f"skipping gdrive object {f.get('name')}: size {f['size']} "
                    f"exceeds limit {object_size_limit}",
                    stacklevel=2,
                )
                continue
        if file_name_pattern is not None:
            patterns = (
                [file_name_pattern]
                if isinstance(file_name_pattern, str)
                else list(file_name_pattern)
            )
            if not any(fnmatch.fnmatch(f.get("name", ""), p) for p in patterns):
                continue
        out.append(f)
    return out


def _real_client(credentials_file: str, export_mapping: dict):
    """The actual googleapiclient transport — a dependency gate here."""
    try:
        from google.oauth2.service_account import Credentials as ServiceCredentials
        from googleapiclient.discovery import build
        from googleapiclient.http import MediaIoBaseDownload  # noqa: F401
    except ImportError:
        raise NotImplementedError(
            "pw.io.gdrive requires the google-api-python-client libraries (or "
            "an injected client= transport), which are not available in this "
            "environment"
        ) from None

    import io as _io

    creds = ServiceCredentials.from_service_account_file(credentials_file)
    drive = build("drive", "v3", credentials=creds, num_retries=3)

    # explicit fields: Drive v3 partial responses default to id/name/mimeType
    # only — modifiedTime/size are required for change detection + size limits
    file_fields = "id, name, mimeType, modifiedTime, trashed, size"

    class _Client:
        def tree(self, object_id: str) -> dict:
            files: dict[str, dict] = {}

            def ls(fid: str) -> None:
                meta = (
                    drive.files()
                    .get(fileId=fid, fields=file_fields, supportsAllDrives=True)
                    .execute()
                )
                if meta.get("trashed"):
                    return
                if meta.get("mimeType") != MIME_TYPE_FOLDER:
                    files[meta["id"]] = meta
                    return
                page = None
                while True:
                    resp = (
                        drive.files()
                        .list(
                            q=f"'{fid}' in parents and trashed=false",
                            fields=f"nextPageToken, files({file_fields})",
                            supportsAllDrives=True,
                            includeItemsFromAllDrives=True,
                            pageToken=page,
                        )
                        .execute()
                    )
                    for item in resp.get("files", []):
                        if item.get("mimeType") == MIME_TYPE_FOLDER:
                            ls(item["id"])
                        else:
                            files[item["id"]] = item
                    page = resp.get("nextPageToken")
                    if page is None:
                        return

            ls(object_id)
            return files

        def download(self, meta: dict) -> bytes | None:
            from googleapiclient.http import MediaIoBaseDownload

            export_type = export_mapping.get(meta.get("mimeType"))
            if export_type is not None:
                req = drive.files().export_media(
                    fileId=meta["id"], mimeType=export_type
                )
            else:
                req = drive.files().get_media(fileId=meta["id"])
            buf = _io.BytesIO()
            dl = MediaIoBaseDownload(buf, req)
            done = False
            while not done:
                _status, done = dl.next_chunk()
            return buf.getvalue()

    return _Client()


def read(
    object_id: str,
    *,
    mode: str = "streaming",
    object_size_limit: int | None = None,
    refresh_interval: int = 30,
    service_user_credentials_file: str | None = None,
    with_metadata: bool = False,
    file_name_pattern: list | str | None = None,
    client: Any = None,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    """Read a Drive file or folder subtree as a table of ``data: bytes``
    rows (plus ``_metadata`` when requested), keyed by file id — new and
    modified files upsert in place, removals retract (streaming mode)."""
    if mode not in ("streaming", "static"):
        raise ValueError(f"unknown gdrive mode {mode!r}")
    if client is None:
        if service_user_credentials_file is None:
            raise ValueError(
                "pw.io.gdrive.read needs service_user_credentials_file= (real "
                "transport) or client= (injected transport)"
            )
        client = _real_client(service_user_credentials_file, DEFAULT_MIME_TYPE_MAPPING)

    schema = schema_mod.schema_from_types(data=bytes)
    if with_metadata:
        schema = schema | schema_mod.schema_from_types(_metadata=dict)
    poll_interval = kwargs.get("_poll_interval", refresh_interval)

    class _GDriveSubject(ConnectorSubject):
        def __init__(self) -> None:
            super().__init__()
            self._stop = False
            # object cache: file id -> modifiedTime of the emitted version
            # (mtime only — caching payloads would pin the whole corpus in RAM)
            self._cache: dict[str, str] = {}

        @property
        def _session_type(self) -> str:
            return "upsert" if mode == "streaming" else "native"

        def _key(self, fid: str) -> int:
            return int(stable_hash_obj(("gdrive", fid)))

        def _meta_of(self, meta: dict) -> dict:
            fid = meta.get("id")
            return {
                **{k: v for k, v in meta.items() if k != "parents"},
                "url": f"https://drive.google.com/file/d/{fid}/",
                "path": meta.get("name"),
                "seen_at": int(_time.time()),
                "status": "downloaded",
            }

        def run(self) -> None:
            while not self._stop:
                try:
                    tree = client.tree(object_id)
                except Exception as e:  # noqa: BLE001 — transient listing errors retry
                    warnings.warn(
                        f"gdrive listing failed ({e!r}); retrying in "
                        f"{poll_interval}s",
                        stacklevel=2,
                    )
                    _time.sleep(poll_interval)
                    continue
                files = _filter_files(
                    list(tree.values()), object_size_limit, file_name_pattern
                )
                live = {f["id"]: f for f in files}
                assert self._node is not None
                if mode == "streaming":
                    for fid in list(self._cache):
                        if fid not in live:  # deletion detection
                            del self._cache[fid]
                            self._node.push(self._key(fid), None, -1)
                for fid, meta in live.items():
                    prev_mtime = self._cache.get(fid)
                    mtime = meta.get("modifiedTime", "")
                    if prev_mtime is not None and prev_mtime >= mtime:
                        continue  # object cache hit: not re-downloaded
                    payload = client.download(meta)
                    if payload is None:
                        continue
                    values = (
                        (payload, self._meta_of(meta))
                        if with_metadata
                        else (payload,)
                    )
                    self._cache[fid] = mtime
                    self._node.push(self._key(fid), values, 1)
                if mode == "static":
                    return
                _time.sleep(poll_interval)

        def on_stop(self) -> None:
            self._stop = True

    return py_read(
        _GDriveSubject(), schema=schema, name=name or f"gdrive:{object_id}"
    )
