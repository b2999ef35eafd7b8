"""The elasticity plane (reference ``pathway_tpu/elastic``): versioned
cluster membership, scale decisions, resharded restores.

Carried so far: :mod:`.membership` (the membership record in the persistence
backend, its version check — the heartbeat plane rejects summaries stamped
with an older version — and the scale-request key), and the constants a
supervisor reads. The plane itself — the autoscaler, the coordinated rescale
and the resharded or migrated restore — is a later slice: a run with
``PATHWAY_ELASTIC`` other than ``off`` raises ``later_slice("elastic")`` where
the reference installs the plane.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.elastic.membership import (
    Membership,
    check_version,
    clear_scale_request,
    commit_membership,
    membership_history,
    read_membership,
    read_scale_request,
    reset_stale_warnings,
    write_scale_request,
)
from pathway_tpu_torch.internals.config import get_pathway_config
from pathway_tpu_torch.internals.later_slice import later_slice

#: exit status of a process leaving for a coordinated rescale (EX_TEMPFAIL),
#: as in the reference; a supervisor relaunches at the new shape on it
RESCALE_EXIT_CODE = 75


def install_from_env(runtime: Any) -> None:
    """The reference installs the plane here when ``PATHWAY_ELASTIC`` is on;
    the port refuses that run (the plane is a later slice)."""
    if get_pathway_config().elastic != "off":
        raise later_slice("elastic")


def current():
    """The installed plane: always None in the port (the plane is a later
    slice), so callers take the reference's plane-off path — the serving
    fabric's replica casts carry no membership version."""
    return None


def reshard_enabled() -> bool:
    """True when restores may reshard (the reference's elastic mode)."""
    return get_pathway_config().elastic != "off"


__all__ = [
    "Membership",
    "RESCALE_EXIT_CODE",
    "check_version",
    "clear_scale_request",
    "commit_membership",
    "current",
    "install_from_env",
    "membership_history",
    "read_membership",
    "read_scale_request",
    "reset_stale_warnings",
    "reshard_enabled",
    "write_scale_request",
]
