"""File-based snapshot store: transient → persisted snapshot lifecycle.

Reference: snapshot/src/main/java/io/camunda/zeebe/snapshots/impl/
FileBasedSnapshotStore.java:51, FileBasedSnapshotId.java, SfvChecksumImpl.java,
FileBasedSnapshotChunkReader.java.

A snapshot is a directory of files identified by
``<index>-<term>-<processedPosition>-<exportedPosition>``; it is written into a
pending dir, checksummed (one CRC per file recorded in an SFV-style manifest),
then atomically renamed into place. Only the latest valid snapshot *chain* is
kept (older ones are purged on persist), except snapshots pinned by a
reservation (backup in progress). A chunk reader serves replication to
followers.

Incremental snapshots: a snapshot may be a **base** (full
``state.bin``) or a **delta** (``delta.bin`` holding the changed keys since
its parent, plus a ``chain.bin`` naming the parent snapshot id). Recovery
resolves the newest snapshot whose whole chain — base through tip — exists
and verifies; a torn or corrupt member invalidates every descendant, and
recovery falls back to the newest fully-valid ancestor chain (or an older
independent chain) instead of crashing. ``_purge_older_than`` keeps the kept
snapshot's ancestors alive, so a chain can never lose its base to the purge.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import zlib
from pathlib import Path
from typing import Callable, Iterator

from zeebe_tpu_torch.utils import storage_io

_ID_RE = re.compile(r"^(\d+)-(\d+)-(\d+)-(\d+)$")
_MANIFEST = "CHECKSUM.sfv"
_CHAIN_FILE = "chain.bin"
STATE_FILE = "state.bin"
DELTA_FILE = "delta.bin"


class InvalidSnapshotError(Exception):
    pass


@dataclasses.dataclass(frozen=True, order=True, slots=True)
class SnapshotId:
    """Ordering is by (index, term, processed_position, exported_position) —
    field order matters for comparisons (reference: FileBasedSnapshotId)."""

    index: int
    term: int
    processed_position: int
    exported_position: int

    def __str__(self) -> str:
        return f"{self.index}-{self.term}-{self.processed_position}-{self.exported_position}"

    @classmethod
    def parse(cls, name: str) -> "SnapshotId | None":
        m = _ID_RE.match(name)
        if not m:
            return None
        return cls(*(int(g) for g in m.groups()))


def _file_crc(path: Path) -> int:
    crc = 0
    with storage_io.open_file(path, "rb") as f:
        while chunk := f.read(1 << 20):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def file_crc(path: Path) -> int:
    """Public alias of the store's one file-CRC rule (the at-rest scrubber
    must compute exactly what the manifest verifier compares)."""
    return _file_crc(path)


def manifest_entries(directory: Path) -> dict[str, int] | None:
    """Parse a snapshot directory's manifest into {file name: crc}, or
    None when the manifest is missing/unreadable/malformed — the scrubber's
    per-file walk (verify ONE file per slice, not the whole chain) reads
    expectations through this so its CRC rule can never drift from
    ``_verify_manifest``."""
    manifest = directory / _MANIFEST
    try:
        expected: dict[str, int] = {}
        for line in manifest.read_text().splitlines():
            name, sep, crc = line.partition("\t")
            if not sep or not name:
                return None
            expected[name] = int(crc, 16)
        return expected
    except (OSError, ValueError):
        return None


def manifest_bytes(files: dict[str, bytes]) -> bytes:
    """The SFV-style manifest for a set of in-memory snapshot files — the
    ONE owner of the line format `_verify_manifest` checks (backup's
    materialized-chain path builds snapshots outside `persist()` and must
    stay restorable)."""
    return "".join(
        f"{name}\t{zlib.crc32(data) & 0xFFFFFFFF:08x}\n"
        for name, data in sorted(files.items())
        if name != _MANIFEST
    ).encode()


def _write_manifest(directory: Path) -> None:
    lines = []
    for p in sorted(directory.iterdir()):
        if p.name != _MANIFEST and p.is_file():
            lines.append(f"{p.name}\t{_file_crc(p):08x}\n")
    storage_io.write_text(directory / _MANIFEST, "".join(lines))


def _verify_manifest(directory: Path) -> bool:
    """True iff the directory's manifest exists, parses, and matches every
    file. Never raises: a torn/partially-written snapshot (power loss during
    commit) must be *skipped* by recovery, not crash it — a malformed
    manifest line, an unreadable file, or a vanished directory all read as
    "invalid"."""
    manifest = directory / _MANIFEST
    try:
        if not manifest.exists():
            return False
        expected = {}
        for line in manifest.read_text().splitlines():
            name, sep, crc = line.partition("\t")
            if not sep or not name:
                return False
            expected[name] = int(crc, 16)
        actual = {
            p.name: _file_crc(p)
            for p in directory.iterdir()
            if p.is_file() and p.name != _MANIFEST
        }
        return expected == actual
    except (OSError, ValueError):
        return False


@dataclasses.dataclass(frozen=True, slots=True)
class PersistedSnapshot:
    id: SnapshotId
    path: Path

    def files(self) -> list[Path]:
        return sorted(p for p in self.path.iterdir() if p.is_file())

    def read_file(self, name: str) -> bytes:
        return (self.path / name).read_bytes()

    def has_file(self, name: str) -> bool:
        return (self.path / name).is_file()

    @property
    def is_delta(self) -> bool:
        return self.has_file(DELTA_FILE)

    def parent_id(self) -> "SnapshotId | None":
        """Parent snapshot id for a delta snapshot (from chain.bin), None for
        a base snapshot or on any read/parse failure (the chain validator
        treats an unreadable link as a broken chain)."""
        try:
            raw = (self.path / _CHAIN_FILE).read_bytes()
        except OSError:
            return None
        try:
            from zeebe_tpu_torch.protocol.msgpack import unpackb

            return SnapshotId.parse(unpackb(raw).get("parent", ""))
        except Exception:  # noqa: BLE001 — corrupt chain meta = no parent
            return None


@dataclasses.dataclass(frozen=True, slots=True)
class SnapshotChunk:
    """One replication unit (reference: SnapshotChunk SBE message)."""

    snapshot_id: str
    chunk_name: str
    offset: int
    total_size: int
    data: bytes
    checksum: int


class TransientSnapshot:
    """A snapshot being taken; becomes persisted (and visible) only on persist()."""

    def __init__(self, store: "FileBasedSnapshotStore", snap_id: SnapshotId) -> None:
        self._store = store
        self.id = snap_id
        self.path = store.pending_dir / str(snap_id)
        if self.path.exists():
            shutil.rmtree(self.path)
        self.path.mkdir(parents=True)
        self._taken = False

    def take(self, writer: Callable[[Path], None]) -> None:
        """Run ``writer(dir)`` to populate the snapshot directory."""
        writer(self.path)
        self._taken = True

    def write_file(self, name: str, data: bytes) -> None:
        storage_io.write_bytes(self.path / name, data)
        self._taken = True

    def link_parent(self, parent: PersistedSnapshot, depth: int) -> None:
        """Mark this transient as a delta on ``parent`` (chain.bin carries
        the parent id and the 1-based chain depth of this snapshot)."""
        from zeebe_tpu_torch.protocol.msgpack import packb

        self.write_file(_CHAIN_FILE, packb(
            {"parent": str(parent.id), "depth": depth}))

    def persist(self) -> PersistedSnapshot:
        if not self._taken:
            raise InvalidSnapshotError("transient snapshot has no content")
        _write_manifest(self.path)
        return self._store._persist(self)

    def abort(self) -> None:
        shutil.rmtree(self.path, ignore_errors=True)


class FileBasedSnapshotStore:
    """Snapshot lifecycle manager for one partition's state directory."""

    def __init__(self, directory: str | Path) -> None:
        self.root = Path(directory)
        self.snapshots_dir = self.root / "snapshots"
        self.pending_dir = self.root / "pending"
        self.snapshots_dir.mkdir(parents=True, exist_ok=True)
        self.pending_dir.mkdir(parents=True, exist_ok=True)
        self._reservations: set[SnapshotId] = set()
        # clean pending leftovers from a crash
        for p in self.pending_dir.iterdir():
            shutil.rmtree(p, ignore_errors=True)
        # drop corrupt persisted snapshots (crash mid-rename etc.)
        for p in list(self.snapshots_dir.iterdir()):
            snap_id = SnapshotId.parse(p.name)
            if snap_id is None or not _verify_manifest(p):
                shutil.rmtree(p, ignore_errors=True)

    # -- queries -------------------------------------------------------------

    def latest_snapshot(self) -> PersistedSnapshot | None:
        best: SnapshotId | None = None
        for p in self.snapshots_dir.iterdir():
            snap_id = SnapshotId.parse(p.name)
            if snap_id is not None and (best is None or snap_id > best):
                best = snap_id
        if best is None:
            return None
        return PersistedSnapshot(best, self.snapshots_dir / str(best))

    def list_snapshots(self) -> list[PersistedSnapshot]:
        out = []
        for p in sorted(self.snapshots_dir.iterdir()):
            snap_id = SnapshotId.parse(p.name)
            if snap_id is not None:
                out.append(PersistedSnapshot(snap_id, p))
        return sorted(out, key=lambda s: s.id)

    # -- chains (incremental snapshots) --------------------------------------

    def snapshot_at(self, snap_id: SnapshotId) -> PersistedSnapshot | None:
        path = self.snapshots_dir / str(snap_id)
        return PersistedSnapshot(snap_id, path) if path.is_dir() else None

    def chain_of(self, snapshot: PersistedSnapshot
                 ) -> list[PersistedSnapshot] | None:
        """Resolve and validate ``snapshot``'s full chain, base → tip.

        Returns None when ANY member is torn (manifest mismatch), missing,
        structurally wrong (a delta without a parent file, a base without
        state), or the parent links cycle — the caller falls back to an
        older snapshot instead of recovering from a broken chain."""
        chain = [snapshot]
        seen = {snapshot.id}
        cur = snapshot
        while True:
            if not _verify_manifest(cur.path):
                return None
            parent_id = cur.parent_id()
            if parent_id is None:
                if cur.is_delta:
                    return None  # delta whose parent link is unreadable
                break  # a base: full state.bin or a durable marker
            if not cur.is_delta or parent_id in seen:
                return None
            parent = self.snapshot_at(parent_id)
            if parent is None:
                return None
            seen.add(parent_id)
            chain.append(parent)
            cur = parent
        chain.reverse()
        return chain

    def iter_valid_chains(self) -> Iterator[list[PersistedSnapshot]]:
        """Valid chains, newest tip first — recovery takes the first one it
        can actually load, so a corrupt tip falls back to the last fully-
        valid ancestor (which is itself a persisted snapshot)."""
        for snapshot in reversed(self.list_snapshots()):
            chain = self.chain_of(snapshot)
            if chain is not None:
                yield chain

    def latest_valid_chain(self) -> list[PersistedSnapshot] | None:
        return next(self.iter_valid_chains(), None)

    def _ancestor_ids(self, snap_id: SnapshotId) -> set[SnapshotId]:
        """``snap_id`` plus every ancestor reachable through parent links
        (validity not required here: the purge must err on keeping)."""
        out = {snap_id}
        cur = self.snapshot_at(snap_id)
        while cur is not None:
            parent_id = cur.parent_id()
            if parent_id is None or parent_id in out:
                break
            out.add(parent_id)
            cur = self.snapshot_at(parent_id)
        return out

    # -- take ----------------------------------------------------------------

    def new_transient_snapshot(
        self, index: int, term: int, processed_position: int, exported_position: int
    ) -> TransientSnapshot:
        snap_id = SnapshotId(index, term, processed_position, exported_position)
        latest = self.latest_snapshot()
        if latest is not None and snap_id <= latest.id:
            raise InvalidSnapshotError(
                f"snapshot {snap_id} is not newer than latest {latest.id}"
            )
        return TransientSnapshot(self, snap_id)

    def _persist(self, transient: TransientSnapshot) -> PersistedSnapshot:
        target = self.snapshots_dir / str(transient.id)
        if target.exists():
            shutil.rmtree(target)
        # make file *contents* durable before the rename publishes the
        # snapshot — else a crash yields a "persisted" snapshot with torn
        # data after the log prefix was compacted away
        for p in transient.path.iterdir():
            if p.is_file():
                storage_io.fsync_path(p)
        self._fsync_dir(transient.path)
        storage_io.replace(transient.path, target)
        self._fsync_dir(self.snapshots_dir)
        self._purge_older_than(transient.id)
        return PersistedSnapshot(transient.id, target)

    @staticmethod
    def _fsync_dir(path: Path) -> None:
        storage_io.fsync_path(path)

    def _purge_older_than(self, keep: SnapshotId) -> None:
        # chain-aware: the kept snapshot's ancestors (its delta chain's base
        # and intermediates) and every reserved snapshot's ancestors survive
        # — purging a base out from under a live delta chain would turn the
        # latest snapshot unrecoverable
        protected = self._ancestor_ids(keep)
        for reserved in self._reservations:
            protected |= self._ancestor_ids(reserved)
        for snap in self.list_snapshots():
            if snap.id < keep and snap.id not in protected:
                shutil.rmtree(snap.path, ignore_errors=True)

    # -- at-rest integrity ----------------------------------------

    def quarantine(self, snapshot: PersistedSnapshot) -> Path | None:
        """Move a corrupt snapshot OUT of the recovery path: the directory
        is renamed to ``<id>.corrupt`` (bits preserved for postmortems, but
        ``SnapshotId.parse`` no longer matches, so queries, chains, and a
        later recovery all skip it and a replacement snapshot at the same
        positions is permitted again). Returns the quarantine path, or None
        when the rename failed (the snapshot stays visibly corrupt and the
        scrubber stays DEGRADED)."""
        target = snapshot.path.with_name(snapshot.path.name + ".corrupt")
        try:
            if target.exists():
                shutil.rmtree(target, ignore_errors=True)
            storage_io.replace(snapshot.path, target)
            return target
        except OSError:
            return None

    # -- reservations (pin during backup) ------------------------------------

    def reserve(self, snap_id: SnapshotId) -> None:
        self._reservations.add(snap_id)

    def release(self, snap_id: SnapshotId) -> None:
        self._reservations.discard(snap_id)
        latest = self.latest_snapshot()
        if latest is not None:
            self._purge_older_than(latest.id)

    # -- replication ---------------------------------------------------------

    def chunk_reader(
        self, snapshot: PersistedSnapshot, chunk_size: int = 1 << 20
    ) -> Iterator[SnapshotChunk]:
        """Stream a snapshot as checksummed chunks (leader → follower install)."""
        for f in snapshot.files():
            data = f.read_bytes()
            total = len(data)
            for off in range(0, max(total, 1), chunk_size):
                piece = data[off : off + chunk_size]
                yield SnapshotChunk(
                    snapshot_id=str(snapshot.id),
                    chunk_name=f.name,
                    offset=off,
                    total_size=total,
                    data=piece,
                    checksum=zlib.crc32(piece) & 0xFFFFFFFF,
                )

    def receive_snapshot(self, chunks: Iterator[SnapshotChunk]) -> PersistedSnapshot:
        """Follower side: rebuild a snapshot from replicated chunks."""
        transient: TransientSnapshot | None = None
        files: dict[str, bytearray] = {}
        snap_id: SnapshotId | None = None
        for chunk in chunks:
            if zlib.crc32(chunk.data) & 0xFFFFFFFF != chunk.checksum:
                raise InvalidSnapshotError(f"chunk checksum mismatch: {chunk.chunk_name}")
            if snap_id is None:
                snap_id = SnapshotId.parse(chunk.snapshot_id)
                if snap_id is None:
                    raise InvalidSnapshotError(f"bad snapshot id {chunk.snapshot_id}")
            buf = files.setdefault(chunk.chunk_name, bytearray())
            if len(buf) != chunk.offset:
                raise InvalidSnapshotError(f"out-of-order chunk for {chunk.chunk_name}")
            buf += chunk.data
        if snap_id is None:
            raise InvalidSnapshotError("no chunks received")
        transient = TransientSnapshot(self, snap_id)
        for name, buf in files.items():
            transient.write_file(name, bytes(buf))
        return transient.persist()


# -- chain loading (shared by partition recovery, chaos oracle, backup) -------


def load_chain_db(chain: list[PersistedSnapshot], consistency_checks: bool = False,
                  db=None):
    """Materialize a validated snapshot chain into a ZbDb: install the base's
    full ``state.bin`` (one bulk pass — O(n log n), not per-key insorts),
    then apply each delta in order. Raises ValueError on a base without
    state (durable-marker chains are the caller's special case) or on
    checksum mismatches the manifest somehow missed.

    ``db``: install into this (empty) instance instead of a fresh ``ZbDb`` —
    the tiered backend recovers through here (state/tiering.py)."""
    from zeebe_tpu_torch.state.db import ZbDb

    base = chain[0]
    if not base.has_file(STATE_FILE):
        raise ValueError(f"chain base {base.id} has no {STATE_FILE}")
    if db is None:
        db = ZbDb(consistency_checks=consistency_checks)
    db.load_snapshot_bytes(base.read_file(STATE_FILE))
    for delta in chain[1:]:
        db.apply_delta_bytes(delta.read_file(DELTA_FILE))
    return db


# -- read-only inspection (cli snapshots) -------------------------------------


def inspect_store(directory: str | Path) -> list[dict]:
    """Describe every snapshot under a store root WITHOUT mutating anything —
    unlike constructing a FileBasedSnapshotStore (which deletes pending
    leftovers and corrupt snapshots on open), this is safe to point at a
    live or postmortem data directory. Returns one dict per snapshot, oldest
    first: id, positions, kind (full/delta/durable-marker), per-file sizes,
    manifest validity, parent link, and whether the full chain validates."""
    root = Path(directory)
    snapshots_dir = root / "snapshots"
    if not snapshots_dir.is_dir():
        return []
    snapshots: list[PersistedSnapshot] = []
    for p in sorted(snapshots_dir.iterdir()):
        snap_id = SnapshotId.parse(p.name)
        if snap_id is not None and p.is_dir():
            snapshots.append(PersistedSnapshot(snap_id, p))
    snapshots.sort(key=lambda s: s.id)
    by_id = {s.id: s for s in snapshots}
    valid = {s.id: _verify_manifest(s.path) for s in snapshots}

    def chain_valid(snap: PersistedSnapshot) -> tuple[bool, int]:
        depth, cur, seen = 1, snap, {snap.id}
        while True:
            if not valid.get(cur.id, False):
                return False, depth
            parent_id = cur.parent_id()
            if parent_id is None:
                return (not cur.is_delta), depth
            if not cur.is_delta or parent_id in seen or parent_id not in by_id:
                return False, depth
            seen.add(parent_id)
            cur = by_id[parent_id]
            depth += 1

    out = []
    for snap in snapshots:
        if snap.has_file(STATE_FILE):
            kind = "full"
        elif snap.is_delta:
            kind = "delta"
        elif snap.has_file("durable.bin"):
            kind = "durable-marker"
        else:
            kind = "unknown"
        files = {}
        try:
            for f in snap.files():
                files[f.name] = f.stat().st_size
        except OSError:
            pass
        ok, depth = chain_valid(snap)
        parent = snap.parent_id()
        out.append({
            "id": str(snap.id),
            "kind": kind,
            "processedPosition": snap.id.processed_position,
            "exportedPosition": snap.id.exported_position,
            "files": files,
            "sizeBytes": sum(files.values()),
            "valid": valid.get(snap.id, False),
            "parent": str(parent) if parent is not None else None,
            "chainLength": depth,
            "chainValid": ok,
        })
    return out
