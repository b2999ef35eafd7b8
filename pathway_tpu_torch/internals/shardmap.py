"""Versioned shard map: ONE authority for "who owns key range R at version V".

Carried from ``pathway_tpu/internals/shardmap.py``. Without it, key ownership
has three derivations: the engine's ``(key & SHARD_MASK) % n_workers``
(``internals/keys``, re-derived in ``parallel/mesh`` and
``parallel/device_exchange``), the fabric's worker-0 route ownership
(``fabric/routing.py``), and elastic reshard-by-replay. The shard map unifies
them: a versioned table of contiguous residue *segments* over the
``SHARD_BITS`` shard space, each owned by exactly one global worker. Version
numbers are tied to the membership version (``elastic/membership.py``).

Two properties make the map the right pivot for both hot paths:

- **Zero-hop routing** — any process can answer ``owner_of_keys`` locally (a
  ``searchsorted`` over at most ``n_workers`` segment starts), so every fabric
  door routes a request directly to the owning process instead of bouncing
  through worker 0 (``fabric/routing.py``).
- **O(moved-state) rescale** — :meth:`ShardMap.rebalance` produces the minimal-
  movement map for a new worker count: survivors keep their ranges up to the
  new quota and only the released residues move. :func:`diff` enumerates
  exactly the moved segments, so live migration loads/moves only the re-mapped
  ranges' operator shards (``persistence/snapshots.py``) instead of wiping
  positional shards and replaying full input logs.

The map is deterministic from (previous map, new worker count): every process
derives the same object locally; only the coordinator (pid 0) commits it to the
backend (``elastic/shardmap`` latest + immutable ``elastic/shardmap_v<N>``
history), same single-writer discipline as the membership record.

Gated by ``PATHWAY_SHARDMAP`` (default off): when off, placement stays the
``(key & SHARD_MASK) % n`` modulo rule byte-for-byte.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from pathway_tpu_torch.internals.keys import SHARD_BITS, SHARD_MASK

#: size of the residue space the map partitions (low SHARD_BITS of row keys)
SHARD_SPACE = 1 << SHARD_BITS

#: backend key of the LATEST committed shard map
_SHARDMAP = "elastic/shardmap"


@dataclass
class ShardMap:
    """Contiguous-segment ownership table over residues ``[0, SHARD_SPACE)``.

    ``starts``/``owners`` are parallel arrays: segment i covers residues
    ``[starts[i], starts[i+1])`` (the last runs to ``SHARD_SPACE``) and is
    owned by global worker ``owners[i]``. Invariants (checked by
    :meth:`validate`): starts sorted and unique, ``starts[0] == 0``, every
    owner in ``[0, n_workers)``, and every worker owns >= 1 residue.
    """

    version: int
    n_workers: int
    starts: np.ndarray = field(repr=False)
    owners: np.ndarray = field(repr=False)
    committed_unix: float = 0.0

    # ------------------------------------------------------------ construction
    @classmethod
    def initial(cls, n_workers: int, version: int = 1) -> "ShardMap":
        """Equal contiguous split: worker w owns
        ``[w*SPACE//n, (w+1)*SPACE//n)``."""
        if not (1 <= n_workers <= SHARD_SPACE):
            raise ValueError(f"n_workers must be in [1, {SHARD_SPACE}], got {n_workers}")
        starts = np.array(
            [(w * SHARD_SPACE) // n_workers for w in range(n_workers)], dtype=np.int64
        )
        owners = np.arange(n_workers, dtype=np.int32)
        return cls(version=version, n_workers=n_workers, starts=starts, owners=owners)

    def _segments(self) -> list[tuple[int, int, int]]:
        """(start, end_exclusive, owner) triples, in residue order."""
        ends = np.append(self.starts[1:], SHARD_SPACE)
        return [
            (int(s), int(e), int(o))
            for s, e, o in zip(self.starts, ends, self.owners)
        ]

    def rebalance(self, new_n_workers: int, version: int | None = None) -> "ShardMap":
        """Minimal-movement map for ``new_n_workers``: survivors keep their
        residues up to the new quota (excess trimmed from their trailing
        segments), removed workers release everything, and under-quota workers
        (including the new ones) fill from the released pool in worker order.
        Deterministic — every process derives the identical map locally.
        """
        if not (1 <= new_n_workers <= SHARD_SPACE):
            raise ValueError(
                f"n_workers must be in [1, {SHARD_SPACE}], got {new_n_workers}"
            )
        new_v = self.version + 1 if version is None else version
        if new_n_workers == self.n_workers:
            # same shape: a true no-op — re-deriving quotas could shuffle
            # ±1-residue remainders on a drifted map and move state for nothing
            return ShardMap(
                starts=self.starts.copy(),
                owners=self.owners.copy(),
                n_workers=self.n_workers,
                version=new_v,
            )
        quota = [
            SHARD_SPACE // new_n_workers + (1 if w < SHARD_SPACE % new_n_workers else 0)
            for w in range(new_n_workers)
        ]
        # survivors keep a prefix (in residue order) of their current segments
        # up to quota; everything else goes to the free pool
        owned: dict[int, list[list[int]]] = {w: [] for w in range(new_n_workers)}
        free: list[list[int]] = []  # [start, end) ranges, residue order
        kept = [0] * new_n_workers
        for s, e, o in self._segments():
            if o >= new_n_workers:
                free.append([s, e])
                continue
            room = quota[o] - kept[o]
            if room <= 0:
                free.append([s, e])
            elif e - s <= room:
                owned[o].append([s, e])
                kept[o] += e - s
            else:
                owned[o].append([s, s + room])
                free.append([s + room, e])
                kept[o] += room
        # under-quota workers adopt from the pool, lowest worker first,
        # lowest residue first — deterministic fill
        fi = 0
        for w in range(new_n_workers):
            need = quota[w] - kept[w]
            while need > 0:
                s, e = free[fi]
                take = min(need, e - s)
                owned[w].append([s, s + take])
                free[fi][0] = s + take
                if free[fi][0] >= e:
                    fi += 1
                kept[w] += take
                need -= take
        # flatten back to a sorted segment table, coalescing adjacent
        # segments with the same owner
        triples = sorted(
            (s, e, w) for w, ranges in owned.items() for s, e in ranges
        )
        cs: list[int] = []
        co: list[int] = []
        for s, _e, w in triples:
            if co and co[-1] == w:
                continue
            cs.append(s)
            co.append(w)
        m = ShardMap(
            version=new_v,
            n_workers=new_n_workers,
            starts=np.asarray(cs, dtype=np.int64),
            owners=np.asarray(co, dtype=np.int32),
        )
        m.validate()
        return m

    # ------------------------------------------------------------------ lookup
    def owner_of_keys(self, keys: np.ndarray) -> np.ndarray:
        """Owning global worker for each row key (vectorized)."""
        res = (np.asarray(keys).astype(np.uint64, copy=False) & SHARD_MASK).astype(
            np.int64
        )
        idx = np.searchsorted(self.starts, res, side="right") - 1
        return self.owners[idx].astype(np.int32, copy=False)

    def owner_of_residues(self, residues: np.ndarray) -> np.ndarray:
        """Owning worker for raw residues (already ``& SHARD_MASK``)."""
        idx = np.searchsorted(
            self.starts, np.asarray(residues, dtype=np.int64), side="right"
        ) - 1
        return self.owners[idx].astype(np.int32, copy=False)

    def ranges_of(self, worker: int) -> list[tuple[int, int]]:
        """``[start, end)`` residue ranges owned by ``worker``."""
        return [(s, e) for s, e, o in self._segments() if o == worker]

    def key_ranges(self) -> dict[int, str]:
        """worker → human-readable owned ranges (/status and docs)."""
        out: dict[int, str] = {}
        for w in range(self.n_workers):
            out[w] = " ∪ ".join(
                f"[{s}, {e})" for s, e in self.ranges_of(w)
            ) or "∅"
        return out

    # --------------------------------------------------------------- integrity
    def validate(self) -> None:
        if len(self.starts) != len(self.owners) or len(self.starts) == 0:
            raise ValueError("shardmap: malformed segment table")
        if int(self.starts[0]) != 0:
            raise ValueError("shardmap: first segment must start at residue 0")
        if np.any(np.diff(self.starts) <= 0):
            raise ValueError("shardmap: segment starts must be strictly increasing")
        if int(self.starts[-1]) >= SHARD_SPACE:
            raise ValueError("shardmap: segment start beyond shard space")
        if np.any(self.owners < 0) or np.any(self.owners >= self.n_workers):
            raise ValueError("shardmap: owner outside [0, n_workers)")
        present = set(int(o) for o in self.owners)
        if present != set(range(self.n_workers)):
            missing = sorted(set(range(self.n_workers)) - present)
            raise ValueError(f"shardmap: workers own no residues: {missing}")

    # ------------------------------------------------------------ serialization
    def to_dict(self) -> dict[str, Any]:
        return {
            "version": self.version,
            "n_workers": self.n_workers,
            "starts": [int(s) for s in self.starts],
            "owners": [int(o) for o in self.owners],
            "committed_unix": self.committed_unix,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ShardMap":
        return cls(
            version=int(d["version"]),
            n_workers=int(d["n_workers"]),
            starts=np.asarray(d["starts"], dtype=np.int64),
            owners=np.asarray(d["owners"], dtype=np.int32),
            committed_unix=float(d.get("committed_unix", 0.0)),
        )


# -------------------------------------------------------------------- diffing


def diff(old: ShardMap, new: ShardMap) -> list[tuple[int, int, int, int]]:
    """Moved residue segments between two maps:
    ``(start, end_exclusive, old_owner, new_owner)`` with old != new owner.
    Linear merge over both segment tables."""
    bounds = np.union1d(old.starts, new.starts)
    ends = np.append(bounds[1:], SHARD_SPACE)
    o_own = old.owner_of_residues(bounds)
    n_own = new.owner_of_residues(bounds)
    out: list[tuple[int, int, int, int]] = []
    for s, e, a, b in zip(bounds, ends, o_own, n_own):
        if int(a) != int(b):
            if out and out[-1][1] == int(s) and out[-1][2] == int(a) and out[-1][3] == int(b):
                out[-1] = (out[-1][0], int(e), int(a), int(b))
            else:
                out.append((int(s), int(e), int(a), int(b)))
    return out


def overlap_sources(old: ShardMap, new: ShardMap, worker: int) -> list[int]:
    """OLD workers whose owned residues intersect ``worker``'s NEW ranges —
    i.e. exactly the old operator shards a migrating restore must read to
    rebuild ``worker``'s state. For an unmoved worker this is ``[worker]``
    plus the donors of whatever ranges it gained, so reads stay
    O(moved + local), never O(n_workers * state)."""
    srcs: set[int] = set()
    for s, e in new.ranges_of(worker):
        bounds = old.starts
        lo = int(np.searchsorted(bounds, s, side="right")) - 1
        hi = int(np.searchsorted(bounds, e - 1, side="right"))
        for o in old.owners[lo:hi]:
            srcs.add(int(o))
    return sorted(srcs)


def moved_fraction(old: ShardMap, new: ShardMap) -> float:
    """Fraction of the residue space that changes owner old → new."""
    moved = sum(e - s for s, e, _, _ in diff(old, new))
    return moved / float(SHARD_SPACE)


# ------------------------------------------------------------------ backend IO


def read_shardmap(backend: Any) -> ShardMap | None:
    """Latest committed shard map, or None (pre-shardmap storage)."""
    raw = backend.get(_SHARDMAP)
    if raw is None:
        return None
    m = ShardMap.from_dict(pickle.loads(raw))
    m.validate()
    return m


def read_shardmap_version(backend: Any, version: int) -> ShardMap | None:
    raw = backend.get(f"elastic/shardmap_v{version:06d}")
    if raw is None:
        return None
    return ShardMap.from_dict(pickle.loads(raw))


def commit_shardmap(backend: Any, m: ShardMap) -> ShardMap:
    """Publish ``m`` as latest + immutable history entry (single writer: the
    coordinator, pid 0 — same discipline as ``commit_membership``)."""
    import time as _time

    m.validate()
    m.committed_unix = _time.time()
    payload = pickle.dumps(m.to_dict())
    backend.put(f"elastic/shardmap_v{m.version:06d}", payload)
    backend.put(_SHARDMAP, payload)
    try:
        from pathway_tpu_torch.internals.telemetry import record_event

        record_event(
            "elastic.shardmap_committed",
            version=m.version,
            n_workers=m.n_workers,
            segments=len(m.starts),
        )
    except Exception:  # pragma: no cover - telemetry must never block commits
        pass
    return m


def ensure_shardmap(
    backend: Any | None, n_workers: int, version: int, commit: bool = False
) -> tuple[ShardMap, ShardMap | None]:
    """Resolve the current map for an ``n_workers`` pod at membership
    ``version``: reuse the stored map when the shape matches, otherwise derive
    the minimal-movement rebalance from it. Returns ``(current, previous)``
    where ``previous`` is the stored map a reshape migrated away from (None
    when no reshape happened). Deterministic on every process; only the
    coordinator passes ``commit=True``."""
    stored = read_shardmap(backend) if backend is not None else None
    if stored is None:
        cur = ShardMap.initial(n_workers, version=version)
        if commit and backend is not None:
            commit_shardmap(backend, cur)
        return cur, None
    if stored.n_workers == n_workers:
        return stored, None
    # a cold relaunch at a new shape may not have advanced the membership
    # version — the map version must STILL be fresh, or the rebalanced map
    # would overwrite the stored map's immutable history entry (which the
    # persistence manifest pins for O(moved-state) migration diffs)
    cur = stored.rebalance(n_workers, version=max(version, stored.version + 1))
    if commit and backend is not None:
        commit_shardmap(backend, cur)
    return cur, stored
