"""The storage torture gate: disk + TCP + kill chaos, live simultaneously.

The consistency gate proved exactly-once delivery when the *network*
and *processes* lie; this gate adds the third liar — the disk — and keeps
all three running at once. Real supervised worker processes serve the
Jepsen-shaped workload while ``ZEEBE_CHAOS_DISK`` injects write EIO/ENOSPC,
torn short-writes, fsync stalls, fsync failures, and at-rest bit-rot flips
into their journals, snapshot stores, and cold tiers, and ``ZEEBE_CHAOS_TCP``
plus a ``kill_worker`` storm keep the fault classes live.

Gates:

- **delivery invariants hold** — the checker (no acked loss in log AND
  export stream, no duplicate application, rejections terminal, positions
  monotone) over the same offline evidence, now collected from disks that
  were actively lying;
- **every configured disk-fault class was observed** (aggregated per-life
  counts snapshots) — configured-but-never-applied chaos is a violation;
- **every at-rest bit-rot flip is accounted for**: each ledger entry must be
  detected by the scrubber/read path (scrub-state evidence), superseded
  (file wiped/quarantined/truncated before it could be read), or verifiably
  repaired (the file's frames re-validate offline); a flip that sat
  readable-and-undetected through the run fails the gate;
- **the repair probe converges**: a follower's raft journal is deliberately
  bit-flipped mid-drive-history, the follower's scrubber must detect and
  truncate-repair it, and the offline comparison proves the follower
  re-converged CRC-identical to the leader's log PAST the corrupted index —
  local corruption degraded into a bounded re-replication event.

``bench.py --torture [--quick]`` runs this and writes TORTURE[_quick].json;
the CI ``torture-smoke`` job gates on it.

The port's gate is a partial copy of the reference's: its config takes the
workers' kernel backend ``device`` and ``run_torture`` gives it to every
``worker_cmd`` (``--device``; None runs the workers on the card,
``"cpu"`` on the plain version) in place of the reference's
``JAX_PLATFORMS=cpu``. The rest is the reference's, copied.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import struct
import sys
import threading
import time
import zlib
from pathlib import Path
from typing import Any

from zeebe_tpu_torch.testing.chaos_disk import DiskFaultPlan
from zeebe_tpu_torch.testing.chaos_disk import format_spec as format_disk_spec
from zeebe_tpu_torch.testing.consistency import (
    ClientOp,
    _await_exports,
    check_consistency,
    collect_exports,
    submit_client_op,
)

# copied from the reference: logger .. BITROT_GRACE_MS
logger = logging.getLogger("zeebe_tpu_torch.testing.torture")

#: flips younger than this at run end are excused from the detection
#: requirement (the scrubber never got a full pass over them)
BITROT_GRACE_MS = 12_000
# end of the copy


@dataclasses.dataclass
class TortureConfig:
    seed: int = 0
    workers: int = 3
    partitions: int = 2
    replication: int = 3
    drive_seconds: float = 20.0
    think_ms: float = 15.0
    request_timeout_s: float = 20.0
    kills: int = 1
    # TCP chaos rides along, milder than the consistency gate (the disk is
    # tonight's liar; the network must still be untrustworthy)
    drop_p: float = 0.005
    duplicate_p: float = 0.01
    delay_p: float = 0.02
    reorder_p: float = 0.01
    # disk chaos
    # rates sized so every class fires with margin in a ~20s quick drive
    # (the gate REQUIRES a nonzero observed count per configured class):
    # ~3k writes and ~700 fsyncs per quick run put the rarest class's
    # expected count near 5
    disk_eio_p: float = 0.004
    disk_enospc_p: float = 0.003
    disk_torn_p: float = 0.004
    disk_fsync_fail_p: float = 0.006
    disk_fsync_stall_p: float = 0.01
    disk_stall_ms: int = 80
    disk_bitrot_interval_ms: int = 1_200
    # rot starts after boot + deploy warmup: see DiskFaultPlan
    disk_bitrot_delay_ms: int = 12_000
    scrub_interval_ms: int = 200
    reject_every: int = 25
    kernel_backend: bool = False
    # tiering ON so the cold tier is a live bit-rot target
    tiering: bool = True
    tiering_park_after_ms: int = 500
    #: the workers' kernel backend device (``--device``): None runs them on
    #: the card, ``"cpu"`` on the plain version
    device: str | None = None


# ---------------------------------------------------------------------------
# offline verification helpers (pure — unit-testable without a cluster)


# copied from the reference: _SEG_HEADER .. check_follower_convergence
_SEG_HEADER = struct.Struct("<IIQQ")
_JOURNAL_FRAME = struct.Struct("<IIQq")
_COLD_FRAME = struct.Struct("<IIH")


#: how far past a damaged frame the tolerant walkers search for the next
#: CRC-verified frame header before giving up on the file
_RESYNC_SCAN_BYTES = 4 << 20


def _walk_frames_tolerant(raw: bytes, first_index: int):
    """Yield ``(index, asqn, data, valid)`` per journal frame, resyncing
    past damaged frames: record indexes are contiguous and known in
    advance, so after a frame whose LENGTH field was rotted (the walk can
    no longer step over it) the next frame is findable by scanning for a
    header whose index matches the expectation AND whose CRC validates —
    a false positive would need a 32-bit CRC collision on top of a
    matching index. Yields ``valid=False`` for skippable bad-CRC frames
    (their extent survived)."""
    offset = _SEG_HEADER.size
    expected = first_index
    n = len(raw)
    while offset + _JOURNAL_FRAME.size <= n:
        length, crc, index, asqn = _JOURNAL_FRAME.unpack_from(raw, offset)
        end = offset + _JOURNAL_FRAME.size + length
        if 0 < length and end <= n and index == expected:
            data = raw[offset + _JOURNAL_FRAME.size:end]
            head = struct.pack("<Qq", index, asqn)
            ok = zlib.crc32(data, zlib.crc32(head)) & 0xFFFFFFFF == crc
            yield index, asqn, data, ok
            expected += 1
            offset = end
            continue
        # structurally damaged (rotted length/index field, or torn tail):
        # try to resync on a later, CRC-proven frame
        found = None
        limit = min(n - _JOURNAL_FRAME.size, offset + _RESYNC_SCAN_BYTES)
        for pos in range(offset + 1, limit):
            c_len, c_crc, c_index, c_asqn = _JOURNAL_FRAME.unpack_from(
                raw, pos)
            if not (0 < c_len and expected <= c_index <= expected + 64
                    and pos + _JOURNAL_FRAME.size + c_len <= n):
                continue
            c_data = raw[pos + _JOURNAL_FRAME.size:
                         pos + _JOURNAL_FRAME.size + c_len]
            c_head = struct.pack("<Qq", c_index, c_asqn)
            if zlib.crc32(c_data, zlib.crc32(c_head)) & 0xFFFFFFFF == c_crc:
                found = (pos, c_index)
                break
        if found is None:
            return  # torn tail / nothing provable beyond this point
        offset, expected = found


def journal_records_crc(path: Path) -> tuple[dict[int, int], bool]:
    """(index → crc32 of record data) for one journal segment file, plus
    whether every byte-reachable frame CRC-validated. A partial trailing
    frame reads as valid (torn tails are crash-normal; recovery truncates
    them) — a CRC mismatch mid-walk does not."""
    try:
        raw = path.read_bytes()
    except OSError:
        return {}, False
    if len(raw) < _SEG_HEADER.size:
        return {}, False
    magic, version, _seg, first = _SEG_HEADER.unpack_from(raw)
    if magic != 0x5A4A4E4C or version != 1:
        return {}, False
    out: dict[int, int] = {}
    offset = _SEG_HEADER.size
    expected = first
    n = len(raw)
    while offset + _JOURNAL_FRAME.size <= n:
        length, crc, index, asqn = _JOURNAL_FRAME.unpack_from(raw, offset)
        end = offset + _JOURNAL_FRAME.size + length
        if length == 0 or end > n or index != expected:
            return out, True  # torn/garbage tail: truncatable, not rot
        data = raw[offset + _JOURNAL_FRAME.size:end]
        head = struct.pack("<Qq", index, asqn)
        if zlib.crc32(data, zlib.crc32(head)) & 0xFFFFFFFF != crc:
            return out, False
        out[index] = zlib.crc32(data) & 0xFFFFFFFF
        expected += 1
        offset = end
    return out, True


def journal_dir_records(directory: Path) -> tuple[dict[int, int], bool]:
    """Merge every segment in a journal directory (oldest→newest) into one
    index→crc map; ``ok`` is False if any mid-file frame failed CRC."""
    out: dict[int, int] = {}
    ok = True
    for path in sorted(directory.glob("journal-*.log"),
                       key=lambda p: int(p.stem.rsplit("-", 1)[1])):
        crcs, seg_ok = journal_records_crc(path)
        out.update(crcs)
        ok = ok and seg_ok
    return out, ok


def journal_dir_records_tolerant(directory: Path) -> dict[int, int]:
    """index→crc over VALID frames only, SKIPPING bad-CRC frames via their
    surviving length fields (same resync trick as the union log reader).
    The probe's convergence comparison needs this: with at-rest bit rot
    running through teardown, EITHER replica may hold late rot the
    scrubber never reached — the repair verdict must compare the frames
    both sides can still read, not stop at the first one they can't."""
    out: dict[int, int] = {}
    for path in sorted(directory.glob("journal-*.log"),
                       key=lambda p: int(p.stem.rsplit("-", 1)[1])):
        try:
            raw = path.read_bytes()
        except OSError:
            continue
        if len(raw) < _SEG_HEADER.size:
            continue
        magic, version, _seg, first = _SEG_HEADER.unpack_from(raw)
        if magic != 0x5A4A4E4C or version != 1:
            continue
        for index, _asqn, data, valid in _walk_frames_tolerant(raw, first):
            if valid:
                out[index] = zlib.crc32(data) & 0xFFFFFFFF
    return out


def cold_file_fully_valid(path: Path) -> bool:
    try:
        raw = path.read_bytes()
    except OSError:
        return False
    pos = 0
    n = len(raw)
    while pos + _COLD_FRAME.size <= n:
        frame_len, crc, _key_len = _COLD_FRAME.unpack_from(raw, pos)
        end = pos + frame_len
        if frame_len < _COLD_FRAME.size or end > n:
            return True  # torn tail (flush boundary), not mid-file rot
        if zlib.crc32(raw[pos + _COLD_FRAME.size:end]) & 0xFFFFFFFF != crc:
            return False
        pos = end
    return True


def flipped_file_repaired(flip: dict) -> bool:
    """Offline proof a flipped file no longer serves the flipped bytes:
    the file's reachable frames all CRC-validate again (journal/cold), or
    the snapshot directory's manifest validates."""
    path = Path(flip["path"])
    cls = flip.get("class")
    if cls == "journal":
        _crcs, ok = journal_records_crc(path)
        return ok
    if cls == "cold":
        return cold_file_fully_valid(path)
    if cls == "snapshot":
        from zeebe_tpu_torch.state.snapshot import _verify_manifest

        return _verify_manifest(path.parent)
    return False


def _detection_matches_flip(event: dict, flip: dict, worker_dir: str) -> bool:
    """Does one scrub-evidence event (detection or repair) plausibly cover
    one ledger flip? Matching is per class: journal flips match raft/stream
    events whose directory prefixes the flipped file; snapshot flips match
    by path or snapshot id; cold flips match any cold event in the same
    worker tree."""
    if event.get("atMs", 0) < flip.get("atMs", 0) - 3_000:
        return False  # evidence predates the flip (clock slack 3s)
    cls = flip.get("class")
    target = event.get("target")
    path = flip.get("path", "")
    if cls == "journal":
        if target not in ("raft", "stream"):
            return False
        directory = event.get("directory", "")
        return bool(directory) and path.startswith(directory)
    if cls == "snapshot":
        if target != "snapshot":
            return False
        if event.get("path") == path:
            return True
        snap_id = event.get("snapshotId")
        return snap_id is not None and f"/{snap_id}/" in path
    if cls == "cold":
        return target == "cold" and path.startswith(worker_dir)
    return False


def collect_scrub_evidence(directory: Path) -> dict[str, list[dict]]:
    """worker-partition dir → detection+repair events, merged from the live
    scrub-state files AND any flight dumps (a killed worker's scrub state
    survives as its last atomic snapshot)."""
    out: dict[str, list[dict]] = {}
    for path in directory.glob("*/partition-*/scrub-state.json"):
        try:
            state = json.loads(path.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            continue
        events = list(state.get("detections", []))
        events += list(state.get("repairs", []))
        out[str(path.parent)] = events
    # flight dumps each carry the FULL ring — successive dumps repeat the
    # same events, so dedupe by identity before merging (the matcher's
    # cost and the evidence count must reflect distinct events)
    seen: set[tuple] = set()
    for dump in sorted(directory.glob("*/flight-*.json")):
        try:
            payload = json.loads(dump.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            continue
        key = str(dump.parent)
        for ring in payload.get("partitions", {}).values():
            for ev in ring:
                if ev.get("kind") not in ("storage_corruption",
                                          "storage_repair"):
                    continue
                ident = (key, ev.get("t"), ev.get("kind"), ev.get("target"),
                         ev.get("atMs"), ev.get("corruptIndex"),
                         ev.get("action"))
                if ident in seen:
                    continue
                seen.add(ident)
                out.setdefault(key, []).append(
                    {**ev, "atMs": ev.get("atMs", ev.get("t", 0))})
    return out


def check_bitrot_flips(flips: list[dict], evidence: dict[str, list[dict]],
                       run_end_ms: float) -> tuple[list[str], dict]:
    """The detected-or-repaired accounting over the bit-rot ledger."""
    violations: list[str] = []
    stats = {"flips": len(flips), "detected": 0, "superseded": 0,
             "repairedVerified": 0, "tooRecent": 0}
    for flip in flips:
        path = flip.get("path", "")
        worker_dir = None
        for candidate in evidence:
            if path.startswith(candidate.rsplit("/partition-", 1)[0]):
                worker_dir = candidate.rsplit("/partition-", 1)[0]
                break
        matched = any(
            _detection_matches_flip(ev, flip,
                                    key.rsplit("/partition-", 1)[0])
            for key, events in evidence.items()
            for ev in events
            if worker_dir is None or key.startswith(worker_dir))
        if matched:
            stats["detected"] += 1
            continue
        if not os.path.exists(path):
            # wiped (cold dir on restart), quarantined (snapshot rename),
            # or unlinked (segment delete): the bytes can never be served
            stats["superseded"] += 1
            continue
        if os.path.getsize(path) <= flip.get("offset", 0):
            stats["superseded"] += 1  # truncated below the flip
            continue
        if flipped_file_repaired(flip):
            stats["repairedVerified"] += 1
            continue
        if run_end_ms - flip.get("atMs", 0) < BITROT_GRACE_MS:
            stats["tooRecent"] += 1
            continue
        violations.append(
            f"bit-rot flip at {path}@{flip.get('offset')} "
            f"({flip.get('class')}) was never detected, superseded, or "
            f"repaired — corrupt bytes sat servable through the run")
    return violations, stats


def read_replica_log_tolerant(stream_dir: Path, partition_id: int
                              ) -> tuple[list[dict], int]:
    """One replica's materialized stream journal as checker rows, SKIPPING
    rotten frames instead of truncating at them (the consistency reader's
    posture). At teardown a replica may hold bit-rot the scrubber's last
    pass never reached — on a live system the next boot + scrub + raft
    re-convergence repairs it, but offline the oracle must not let one
    replica's rotten frame hide every later record: record indexes are
    contiguous and the frame length field usually survives a one-byte
    flip, so a bad-CRC frame with a plausible extent is skipped and the
    walk resumes at the next frame. Returns (rows, skipped_frames)."""
    from zeebe_tpu_torch.logstreams.log_stream import _deserialize_batch

    rows: list[dict] = []
    skipped = 0
    for path in sorted(stream_dir.glob("journal-*.log"),
                       key=lambda p: int(p.stem.rsplit("-", 1)[1])):
        try:
            raw = path.read_bytes()
        except OSError:
            continue
        if len(raw) < _SEG_HEADER.size:
            continue
        magic, version, _seg, first = _SEG_HEADER.unpack_from(raw)
        if magic != 0x5A4A4E4C or version != 1:
            continue
        for _index, _asqn, data, valid in _walk_frames_tolerant(raw, first):
            if not valid:
                skipped += 1
                continue
            try:
                batch = _deserialize_batch(data, partition_id)
            except Exception:  # noqa: BLE001 — undetected payload damage
                skipped += 1
                continue
            for logged in batch:
                rec = logged.record
                rows.append({
                    "p": logged.position,
                    "src": logged.source_position,
                    "rt": int(rec.record_type),
                    "vt": int(rec.value_type),
                    "it": int(rec.intent),
                    "rid": rec.request_id,
                    "sid": rec.request_stream_id,
                    "rej": rec.is_rejection,
                    "crc": zlib.crc32(rec.encode()[0]) & 0xFFFFFFFF,
                })
    return rows, skipped


def read_raft_log_tolerant(raft_dir: Path, partition_id: int
                           ) -> tuple[list[dict], int]:
    """Decode a replica's RAFT journal into the same checker rows — the
    raft log is the durable source of truth the ack chain actually rests
    on (fsynced before any ack), while the stream journal is derived and
    may legitimately lag on a wedged-then-killed worker (its un-drained
    tail dies with the process and rebuilds from raft on the next boot).
    Rot-tolerant like the stream reader. Entries beyond the replica's
    commit index can appear; for ACKED requests that is still valid
    evidence — an ack implies the command committed."""
    from zeebe_tpu_torch.logstreams.log_stream import _deserialize_batch
    from zeebe_tpu_torch.protocol.msgpack import unpackb

    rows: list[dict] = []
    skipped = 0
    for path in sorted(raft_dir.glob("journal-*.log"),
                       key=lambda p: int(p.stem.rsplit("-", 1)[1])):
        try:
            raw = path.read_bytes()
        except OSError:
            continue
        if len(raw) < _SEG_HEADER.size:
            continue
        magic, version, _seg, first = _SEG_HEADER.unpack_from(raw)
        if magic != 0x5A4A4E4C or version != 1:
            continue
        for _index, _asqn, data, valid in _walk_frames_tolerant(raw, first):
            if not valid:
                skipped += 1
                continue
            try:
                entry = unpackb(data)
                if entry.get("init") or not entry.get("data"):
                    continue
                batch = _deserialize_batch(entry["data"], partition_id)
            except Exception:  # noqa: BLE001 — undetected payload damage
                skipped += 1
                continue
            for logged in batch:
                rec = logged.record
                rows.append({
                    "p": logged.position,
                    "src": logged.source_position,
                    "rt": int(rec.record_type),
                    "vt": int(rec.value_type),
                    "it": int(rec.intent),
                    "rid": rec.request_id,
                    "sid": rec.request_stream_id,
                    "rej": rec.is_rejection,
                    "crc": zlib.crc32(rec.encode()[0]) & 0xFFFFFFFF,
                })
    return rows, skipped


def collect_logs_union(data_dir: Path, workers: list[str], partitions: int
                       ) -> tuple[dict[int, list[dict]], list[str], int]:
    """Per partition: the UNION of every replica's committed evidence,
    rot-tolerant — the materialized stream journals AND the raft journals
    they derive from (the raft log is what the ack chain fsyncs; a wedged
    worker SIGKILLed at teardown loses its stream journal's un-drained
    tail but never the raft frames backing it). With RF >= 2 a record
    rotten on one disk survives on the others — exactly the repair thesis
    the gate proves — so an acked command counts as lost only when NO
    replica holds a valid frame for it anywhere. Cross-source split-brain
    (same position, different bytes) is still a violation. Returns
    (logs, violations, skipped_frames)."""
    logs: dict[int, list[dict]] = {}
    violations: list[str] = []
    skipped_total = 0
    for pid in range(1, partitions + 1):
        by_position: dict[int, tuple[str, dict]] = {}
        raft_fill: dict[int, dict] = {}
        for worker in workers:
            part_dir = data_dir / worker / f"partition-{pid}"
            stream_dir = part_dir / "stream"
            if stream_dir.exists():
                rows, skipped = read_replica_log_tolerant(stream_dir, pid)
                skipped_total += skipped
                for rec in rows:
                    seen = by_position.get(rec["p"])
                    if seen is None:
                        by_position[rec["p"]] = (f"{worker}/stream", rec)
                    elif seen[1]["crc"] != rec["crc"]:
                        # stream journals hold ONLY committed entries, so
                        # same-position divergence here is real split-brain
                        violations.append(
                            f"partition {pid}: position {rec['p']} "
                            f"diverges between {seen[0]} and "
                            f"{worker}/stream (committed-log split-brain)")
            raft_dir = part_dir / "raft" / "raft-log"
            if raft_dir.exists():
                rows, skipped = read_raft_log_tolerant(raft_dir, pid)
                skipped_total += skipped
                for rec in rows:
                    raft_fill.setdefault(rec["p"], rec)
        # raft rows GAP-FILL only — an uncommitted raft suffix on a dead
        # replica may legitimately conflict with the committed history
        # (positions reused after a leader death), so raft evidence never
        # participates in the split-brain equality check and never
        # overrides a stream row
        for position, rec in raft_fill.items():
            if position not in by_position:
                by_position[position] = ("raft-fill", rec)
        logs[pid] = [rec for _pos, (_w, rec)
                     in sorted(by_position.items())]
    return logs, violations, skipped_total


def check_follower_reconvergence(data_dir: Path, workers: list[str],
                                 follower: str,
                                 corrupt_index: int | None) -> dict:
    """The probe's offline verdict, replica-agnostic: the corrupted
    follower must hold VALID raft entries past the corrupted index whose
    bytes agree with AT LEAST ONE other replica on every common valid
    index. (Comparing against the probe-time leader alone is fragile —
    by teardown that node may itself hold a stale uncommitted suffix or a
    boot-rot-rewound log; any honest replica's agreement proves the
    re-fetched region is the cluster's history, and rot-invalid frames on
    either side are excluded as proving nothing.)"""
    follower_map = journal_dir_records_tolerant(
        data_dir / follower / "partition-1" / "raft" / "raft-log")
    follower_last = max(follower_map, default=0)
    comparisons = []
    agreed = False
    for worker in workers:
        if worker == follower:
            continue
        other = journal_dir_records_tolerant(
            data_dir / worker / "partition-1" / "raft" / "raft-log")
        common = sorted(set(follower_map) & set(other))
        mismatches = [i for i in common
                      if follower_map[i] != other[i]]
        comparisons.append({"worker": worker, "commonRecords": len(common),
                            "crcMismatches": mismatches[:5]})
        if common and not mismatches:
            agreed = True
    verified = (agreed
                and (corrupt_index is None
                     or follower_last >= corrupt_index))
    return {
        "verified": verified,
        "followerValidRecords": len(follower_map),
        "followerLastValidIndex": follower_last,
        "corruptRegionIndex": corrupt_index,
        "comparisons": comparisons,
    }


def snapshot_horizons(data_dir: Path, workers: list[str],
                      partitions: int) -> dict[int, int]:
    """Per partition: the highest processed position covered by any
    replica's VALID snapshot chain (read-only inspection). Positions at or
    below the horizon may legally be COMPACTED out of every journal — the
    durability contract is log+chain, so the acked-loss oracle must not
    demand log evidence for them (export evidence still applies)."""
    from zeebe_tpu_torch.state.snapshot import inspect_store

    horizons: dict[int, int] = {}
    for pid in range(1, partitions + 1):
        for worker in workers:
            store_dir = data_dir / worker / f"partition-{pid}" / "snapshots"
            if not store_dir.exists():
                continue
            for info in inspect_store(store_dir):
                if info.get("chainValid"):
                    horizons[pid] = max(horizons.get(pid, -1),
                                        info["processedPosition"])
    return horizons


def waive_compacted_losses(violations: list[str], history: list,
                           exports: dict[int, dict[int, dict]],
                           horizons: dict[int, int]) -> tuple[list[str], int]:
    """Drop 'no command in the log' violations for acked ops whose
    position sits under a valid snapshot horizon AND was exported — the
    snapshot owns the state, the export stream proves delivery; the log
    prefix was legally compacted. Everything else passes through."""
    by_rid = {(op.partition, op.request_id): op for op in history
              if op.outcome == "ack"}
    kept: list[str] = []
    waived = 0
    for violation in violations:
        if "has no command in the log" not in violation:
            kept.append(violation)
            continue
        op = None
        for (pid, rid), candidate in by_rid.items():
            if f"partition {pid}: acked request {rid} " in violation:
                op = candidate
                break
        if (op is not None and op.position >= 0
                and op.position <= horizons.get(op.partition, -1)
                and op.position in exports.get(op.partition, {})):
            waived += 1
            continue
        kept.append(violation)
    return kept, waived


def check_follower_convergence(leader_raft_dir: Path,
                               follower_raft_dir: Path,
                               corrupt_region_index: int | None) -> dict:
    """Offline CRC comparison of two replicas' raft logs: every common
    VALID index byte-identical, and the follower holds valid entries PAST
    the deliberately-corrupted region — the truncate-and-re-fetch repair
    converged. Rot-tolerant on both sides: at-rest bit rot keeps flipping
    bytes through teardown, so either replica may carry late rot the
    scrubber never reached — frames that no longer CRC are excluded from
    the comparison (a record only one side can read proves nothing either
    way), never allowed to hide the convergence verdict."""
    leader = journal_dir_records_tolerant(leader_raft_dir)
    follower = journal_dir_records_tolerant(follower_raft_dir)
    common = sorted(set(leader) & set(follower))
    mismatches = [i for i in common if leader[i] != follower[i]]
    follower_last = max(follower, default=0)
    verified = (
        not mismatches
        and bool(common)
        and (corrupt_region_index is None
             or follower_last >= corrupt_region_index)
    )
    return {
        "verified": verified,
        "leaderValidRecords": len(leader),
        "followerValidRecords": len(follower),
        "commonRecords": len(common),
        "crcMismatches": mismatches[:10],
        "followerLastValidIndex": follower_last,
        "corruptRegionIndex": corrupt_region_index,
    }
# end of the copy


# ---------------------------------------------------------------------------
# the harness


def run_torture(cfg: TortureConfig, directory: str | Path) -> dict:
    """Run the full storage torture gate; returns the report dict."""
    from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
    from zeebe_tpu_torch.multiproc.runtime import MultiProcClusterRuntime
    from zeebe_tpu_torch.multiproc.supervisor import (
        WorkerSpec,
        WorkerSupervisor,
        worker_cmd,
    )
    from zeebe_tpu_torch.protocol import ValueType
    from zeebe_tpu_torch.protocol.intent import (
        DeploymentIntent,
        ProcessInstanceCreationIntent,
    )
    from zeebe_tpu_torch.protocol.record import command
    from zeebe_tpu_torch.standalone import _free_ports
    from zeebe_tpu_torch.testing.chaos import FaultPlan
    from zeebe_tpu_torch.testing.chaos_tcp import format_spec as format_tcp_spec

    directory = Path(directory)
    export_dir = directory / "exports"
    export_dir.mkdir(parents=True, exist_ok=True)
    rng = random.Random(cfg.seed)
    started = time.monotonic()
    epoch_ms = time.time() * 1000.0

    worker_names = [f"worker-{i}" for i in range(cfg.workers)]
    ports = _free_ports(cfg.workers + 1)
    contacts = {n: ("127.0.0.1", p) for n, p in zip(worker_names, ports)}
    contacts["gateway-0"] = ("127.0.0.1", ports[-1])
    contact_str = ",".join(
        f"{m}={h}:{p}" for m, (h, p) in sorted(contacts.items()))

    tcp_plan = FaultPlan(seed=cfg.seed, drop_p=cfg.drop_p,
                         duplicate_p=cfg.duplicate_p, delay_p=cfg.delay_p,
                         reorder_p=cfg.reorder_p, max_delay_ticks=3)
    disk_plan = DiskFaultPlan(
        seed=cfg.seed, eio_p=cfg.disk_eio_p, enospc_p=cfg.disk_enospc_p,
        torn_p=cfg.disk_torn_p, fsync_fail_p=cfg.disk_fsync_fail_p,
        fsync_stall_p=cfg.disk_fsync_stall_p, stall_ms=cfg.disk_stall_ms,
        bitrot_interval_ms=cfg.disk_bitrot_interval_ms,
        bitrot_delay_ms=cfg.disk_bitrot_delay_ms)

    repo = str(Path(__file__).resolve().parent.parent.parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH")) if p)
    if not cfg.kernel_backend:
        env["ZEEBE_BROKER_EXPERIMENTAL_KERNELBACKEND"] = "false"
    env["ZEEBE_CHAOS_TCP"] = format_tcp_spec(tcp_plan, [], tick_ms=50)
    env["ZEEBE_CHAOS_EPOCH_MS"] = str(epoch_ms)
    env["ZEEBE_CHAOS_DISK"] = format_disk_spec(disk_plan)
    # the disarm seam: the drive phase is where the disk lies; probe +
    # quiesce + evidence-drain run with the disk honest again (creating
    # the file flips every worker's controller off on its next tick —
    # same runtime-control pattern as the TCP plane's windows file)
    disarm_file = directory / "disk-chaos-disarm"
    env["ZEEBE_CHAOS_DISK_DISARMFILE"] = str(disarm_file)
    env["ZEEBE_BROKER_DATA_SCRUB_INTERVALMS"] = str(cfg.scrub_interval_ms)
    if cfg.tiering:
        env["ZEEBE_BROKER_DATA_TIERING_ENABLED"] = "true"
        env["ZEEBE_BROKER_DATA_TIERING_PARKAFTERMS"] = str(
            cfg.tiering_park_after_ms)
    env["ZEEBE_BROKER_EXPORTERS_TORTURE_CLASSNAME"] = \
        "zeebe_tpu_torch.testing.consistency.JsonlExporter"
    env["ZEEBE_BROKER_EXPORTERS_TORTURE_ARGS_DIR"] = str(export_dir)

    specs = [WorkerSpec(
        node_id=name,
        cmd=worker_cmd(name, f"127.0.0.1:{contacts[name][1]}", contact_str,
                       "gateway-0", cfg.partitions, cfg.replication,
                       data_dir=str(directory / name),
                       device=cfg.device),
        data_dir=str(directory / name)) for name in worker_names]
    supervisor = WorkerSupervisor(specs, env=env, restart_backoff_s=0.2)
    runtime = MultiProcClusterRuntime(
        "gateway-0",
        {m: a for m, a in contacts.items() if m != "gateway-0"},
        partition_count=cfg.partitions, replication_factor=cfg.replication,
        bind=contacts["gateway-0"], supervisor=supervisor)

    history: list[ClientOp] = []
    history_lock = threading.Lock()
    op_seq = [0]
    events: list[dict] = []
    report: dict[str, Any] = {"seed": cfg.seed}

    def clock_ms() -> float:
        return time.time() * 1000.0 - epoch_ms

    def submit_op(partition: int, kind: str, record) -> ClientOp:
        return submit_client_op(
            runtime, partition, kind, record, history=history,
            history_lock=history_lock, op_seq=op_seq, clock_ms=clock_ms,
            timeout_s=cfg.request_timeout_s)

    # workload: plain creates plus message-wait instances that PARK (the
    # tiering path spills them → the cold tier becomes a live bit-rot
    # target), with the Nth request targeting a missing process id so the
    # rejections-terminal invariant stays exercised
    model = (Bpmn.create_executable_process("torture")
             .start_event("s").end_event("e").done())
    wait_model = (Bpmn.create_executable_process("torture_wait")
                  .start_event("s")
                  .intermediate_catch_message(
                      "wait", message_name="torture-msg",
                      correlation_key="=ck")
                  .end_event("e").done())
    deploy = command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {
        "resources": [
            {"resourceName": "torture.bpmn",
             "resource": to_bpmn_xml(model)},
            {"resourceName": "torture_wait.bpmn",
             "resource": to_bpmn_xml(wait_model)},
        ]})

    def create_cmd(process_id: str = "torture", variables: dict | None = None):
        return command(ValueType.PROCESS_INSTANCE_CREATION,
                       ProcessInstanceCreationIntent.CREATE,
                       {"bpmnProcessId": process_id, "version": -1,
                        "variables": variables or {}})

    stop_driving = threading.Event()

    def drive(partition: int) -> None:
        n = 0
        while not stop_driving.is_set():
            n += 1
            if cfg.reject_every and n % cfg.reject_every == 0:
                submit_op(partition, "create-missing",
                          create_cmd("no-such-process"))
            elif n % 4 == 0:
                submit_op(partition, "create-wait",
                          create_cmd("torture_wait",
                                     {"ck": f"k-{partition}-{n}"}))
            else:
                submit_op(partition, "create", create_cmd())
            time.sleep(cfg.think_ms / 1000.0)

    probe: dict = {"verified": False, "reason": "not run"}
    corrupted_follower: str | None = None
    leader_at_probe: str | None = None
    try:
        runtime.start()
        boot_deadline = time.monotonic() + 180.0
        while True:
            try:
                runtime.await_leaders(timeout_s=5.0)
                break
            except RuntimeError:
                if time.monotonic() >= boot_deadline:
                    raise
        deploy_op = submit_op(1, "deploy", deploy)
        if deploy_op.outcome != "ack":
            raise RuntimeError(f"deploy failed: {deploy_op.row()}")
        for pid in range(1, cfg.partitions + 1):
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                if submit_op(pid, "create", create_cmd()).outcome == "ack":
                    break
                time.sleep(0.25)
            else:
                raise RuntimeError(f"partition {pid} never served a create")

        drive_started = time.monotonic()
        drivers = [threading.Thread(target=drive, args=(pid,), daemon=True,
                                    name=f"driver-{pid}")
                   for pid in range(1, cfg.partitions + 1)]
        for t in drivers:
            t.start()
        for i in range(cfg.kills):
            at = rng.uniform(0.25, 0.7) * cfg.drive_seconds
            delay = drive_started + at - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            target = worker_names[rng.randrange(len(worker_names))]
            logger.warning("torture chaos: kill %s at t=%.1fs", target, at)
            events.append({"atMs": clock_ms(), "action": "kill",
                           "target": target})
            supervisor.kill_worker(target)
        remaining = drive_started + cfg.drive_seconds - time.monotonic()
        if remaining > 0:
            time.sleep(remaining)
        stop_driving.set()
        for t in drivers:
            t.join(timeout=cfg.request_timeout_s + 10)
        # disarm disk chaos: the survival window is over; the probe and
        # the repair-drain phases measure recovery, not fresh damage
        disarm_file.write_text("disarm\n", encoding="utf-8")
        time.sleep(1.0)  # one tick for every worker to notice

        # ---- the repair probe: corrupt a live follower's raft journal ----
        probe, corrupted_follower, leader_at_probe = _corruption_repair_probe(
            runtime, directory, worker_names, events, clock_ms)

        quiesce_deadline = time.monotonic() + 90.0
        while time.monotonic() < quiesce_deadline:
            try:
                runtime.await_leaders(timeout_s=5.0)
                break
            except RuntimeError:
                continue
        _await_exports(export_dir, history, deadline_s=60.0)
        report["gatewayFlight"] = runtime.flight.snapshot()
        report["workerRestarts"] = dict(supervisor.restarts)
    finally:
        try:
            runtime.stop()
        except Exception:  # noqa: BLE001 — teardown must reach evidence
            logger.exception("runtime stop failed")

    run_end_ms = clock_ms()

    # finalize the repair probe offline: the workers are down and their
    # journals flushed — compare the corrupted follower's raft log against
    # the leader's byte-for-byte
    if probe.get("detected") and corrupted_follower:
        convergence = check_follower_reconvergence(
            directory, worker_names, corrupted_follower,
            probe.get("corruptIndex"))
        probe.update(convergence)
        verified = bool(convergence["verified"])
        if not verified:
            # a SECOND repair (an older pre-disarm flip the scrub reached
            # later) may have re-truncated the journal after the probe's
            # reconvergence completed — the repair history proves the
            # refill happened: a later truncate-reconverge whose
            # beforeLastIndex sits PAST the probe's corrupt index
            ci = probe.get("corruptIndex") or 0
            try:
                state = json.loads(
                    (directory / corrupted_follower / "partition-1"
                     / "scrub-state.json").read_text(encoding="utf-8"))
                max_before = max(
                    (r.get("beforeLastIndex", 0)
                     for r in state.get("repairs", [])
                     if r.get("target") == "raft"), default=0)
            except (OSError, ValueError):
                max_before = 0
            probe["reconvergedBeforeLastIndex"] = max_before
            no_mismatch = all(not c["crcMismatches"]
                              for c in convergence["comparisons"])
            verified = bool(no_mismatch and max_before >= ci > 0)
        probe["verified"] = verified

    # ---- offline evidence + checks ----------------------------------------
    logs, violations, skipped_frames = collect_logs_union(
        directory, worker_names, cfg.partitions)
    exports, export_violations, re_exports = collect_exports(export_dir)
    violations += export_violations
    violations += check_consistency(history, logs, exports)
    # chaos-slowed replay triggers adaptive snapshots, whose compaction
    # legally deletes journal prefixes: an acked position under a VALID
    # snapshot horizon that the export stream carries is covered, not lost
    horizons = snapshot_horizons(directory, worker_names, cfg.partitions)
    violations, compaction_waived = waive_compacted_losses(
        violations, history, exports, horizons)

    # observed disk-fault evidence: every CONFIGURED class must have fired
    disk_counts: dict[str, int] = {}
    for counts_path in directory.glob("*/disk-chaos-counts-*.json"):
        try:
            counts = json.loads(counts_path.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            continue
        for key, value in counts.items():
            if isinstance(value, int):
                disk_counts[key] = disk_counts.get(key, 0) + value
    flips: list[dict] = []
    for ledger_path in directory.glob("*/disk-bitrot-*.jsonl"):
        try:
            for line in ledger_path.read_text(encoding="utf-8").splitlines():
                if line.strip():
                    flips.append(json.loads(line))
        except (OSError, ValueError):
            continue
    # the ledger is flushed per flip; the counts snapshot is throttled
    # (2s) and a SIGKILL can lose its tail — the ledger is authoritative
    disk_counts["bitrot"] = max(disk_counts.get("bitrot", 0), len(flips))
    for fault_class in disk_plan.configured_classes():
        if not disk_counts.get(fault_class):
            violations.append(
                f"disk-fault class `{fault_class}` configured but never "
                f"observed (0 applied across every worker life) — the "
                f"chaos plane is not reaching the IO seam")

    # TCP chaos sanity (it rides along; it must actually ride)
    tcp_counts: dict[str, int] = {}
    for counts_path in directory.glob("*/chaos-counts-*.json"):
        try:
            counts = json.loads(counts_path.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            continue
        for key, value in counts.items():
            if isinstance(value, int):
                tcp_counts[key] = tcp_counts.get(key, 0) + value

    # bit-rot detected-or-repaired accounting (flips collected above)
    scrub_evidence = collect_scrub_evidence(directory)
    bitrot_violations, bitrot_stats = check_bitrot_flips(
        flips, scrub_evidence, run_end_ms)
    violations += bitrot_violations
    scrub_event_total = sum(len(v) for v in scrub_evidence.values())
    if flips and not (bitrot_stats["detected"]
                      or bitrot_stats["repairedVerified"]):
        violations.append(
            "bit-rot flips landed but not one was scrub-detected or "
            "verifiably repaired — the scrubber is not doing its job")

    # repair-probe verdict
    if not probe.get("verified"):
        violations.append(f"follower-corruption repair probe failed: {probe}")

    outcomes: dict[str, int] = {}
    for op in history:
        outcomes[op.outcome] = outcomes.get(op.outcome, 0) + 1
    report.update({
        "workers": cfg.workers,
        "partitions": cfg.partitions,
        "replication": cfg.replication,
        "requests": len(history),
        "outcomes": outcomes,
        "ackedCommands": outcomes.get("ack", 0),
        "kills": len([e for e in events if e["action"] == "kill"]),
        "events": events,
        "diskChaosSpec": format_disk_spec(disk_plan),
        "diskFaultsObserved": disk_counts,
        "tcpChaosObserved": tcp_counts,
        "bitrotFlips": bitrot_stats,
        "bitrotLedger": flips[:50],
        "scrubEvidenceEvents": scrub_event_total,
        "repairProbe": probe,
        "corruptedFollower": corrupted_follower,
        "leaderAtProbe": leader_at_probe,
        "reExportedRecords": re_exports,
        "rottenFramesSkippedOffline": skipped_frames,
        "snapshotHorizons": {str(k): v for k, v in horizons.items()},
        "compactionWaivedLogChecks": compaction_waived,
        "logRecords": {str(p): len(r) for p, r in logs.items()},
        "exportedPositions": {str(p): len(v) for p, v in exports.items()},
        "violations": violations,
        "wallSeconds": round(time.monotonic() - started, 2),
    })
    return report


# copied from the reference: _corruption_repair_probe .. main
def _corruption_repair_probe(runtime, directory: Path,
                             worker_names: list[str], events: list[dict],
                             clock_ms) -> tuple[dict, str | None, str | None]:
    """Deliberately flip a byte mid-history in a FOLLOWER's raft journal,
    wait for its scrubber to detect + truncate-repair, drive raft traffic
    so the leader re-converges the suffix, then (post-teardown, by the
    caller) prove the follower's log is CRC-identical to the leader's past
    the corrupted index."""
    # the drive just ended under live chaos (rot-triggered leader
    # step-downs included): wait for leadership to settle before probing
    leader = None
    deadline = time.monotonic() + 45.0
    while time.monotonic() < deadline:
        leader = runtime._leader_of(1)
        if leader is not None:
            break
        time.sleep(0.5)
    if leader is None:
        return {"verified": False, "reason": "no leader for partition 1"}, \
            None, None
    followers = [w for w in worker_names if w != leader]
    if not followers:
        return {"verified": False, "reason": "no follower to corrupt"}, \
            None, leader
    follower = followers[0]
    raft_dir = directory / follower / "partition-1" / "raft" / "raft-log"
    segments = sorted(raft_dir.glob("journal-*.log"))
    if not segments:
        return {"verified": False,
                "reason": f"no raft segments under {raft_dir}"}, \
            follower, leader
    target = segments[-1]
    size = target.stat().st_size
    if size < 64:
        return {"verified": False, "reason": "raft journal too small"}, \
            follower, leader
    # flip mid-history: past the 24-byte segment header, inside the first
    # half of the file so plenty of committed suffix must re-converge
    offset = 24 + (size - 24) // 3
    with open(target, "r+b") as f:
        f.seek(offset)
        old = f.read(1)
        f.seek(offset)
        f.write(bytes((old[0] ^ 0xFF,)))
    events.append({"atMs": clock_ms(), "action": "corrupt-follower-journal",
                   "target": follower, "file": str(target),
                   "offset": offset})
    # wait for the follower's scrubber to detect + repair
    scrub_state = directory / follower / "partition-1" / "scrub-state.json"
    corrupt_index = None
    deadline = time.monotonic() + 45.0
    detected = False
    while time.monotonic() < deadline:
        try:
            state = json.loads(scrub_state.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            time.sleep(0.25)
            continue
        for ev in state.get("detections", []):
            if ev.get("target") == "raft" and \
                    str(raft_dir) == ev.get("directory"):
                corrupt_index = ev.get("corruptIndex")
                detected = True
        repaired = [ev for ev in state.get("repairs", [])
                    if ev.get("target") == "raft"]
        if repaired and not detected:
            # a live raft read tripped on the flip before the scrubber's
            # slice reached it: the repair evidence alone proves detection
            # (same truncate-reconverge seam, different detector)
            detected = True
            corrupt_index = repaired[-1].get("afterLastIndex", 0) + 1
        if detected and repaired:
            break
        time.sleep(0.25)
    if not detected:
        return {"verified": False,
                "reason": "follower scrubber never detected the flip",
                "file": str(target), "offset": offset}, follower, leader
    # wait for replication to re-converge the truncated suffix (heartbeats
    # back the leader up to the follower's surviving prefix and resend);
    # poll the on-disk valid extent — append-only frames make a live
    # tolerant walk safe — because an OLDER pre-disarm flip elsewhere in
    # the journal can trigger a SECOND repair at any moment
    reconverge_deadline = time.monotonic() + 30.0
    while time.monotonic() < reconverge_deadline:
        valid = journal_dir_records_tolerant(raft_dir)
        if corrupt_index is not None and valid \
                and max(valid) >= corrupt_index:
            break
        time.sleep(0.5)
    return {"verified": None,  # finalized offline by the caller
            "detected": True, "corruptIndex": corrupt_index,
            "file": str(target), "offset": offset}, follower, leader


def main(argv: list[str] | None = None) -> int:  # pragma: no cover — manual
    from zeebe_tpu_torch.testing.serving import gate_cli_main

    return gate_cli_main(
        "zeebe-tpu-torture", TortureConfig(),
        TortureConfig(drive_seconds=90.0, kills=3), run_torture, argv)
# end of the copy


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
