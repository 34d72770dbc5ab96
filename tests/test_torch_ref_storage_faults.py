# tests/test_storage_faults.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Storage fault survival: the disk-chaos plane, the storage_io
seam, the fsyncgate contract, the at-rest scrubber, and the repair seams —
journal truncate-and-reconverge, snapshot quarantine + re-anchor, cold
DEGRADED + transition — plus the torture gate's pure offline checkers and
the mid-chain snapshot-corruption recovery satellite."""

from __future__ import annotations

import json
import os
from pathlib import Path

import pytest

from zeebe_tpu_torch.broker import InProcessCluster
from zeebe_tpu_torch.journal.journal import (
    CorruptedJournalError,
    FlushFailedError,
    SegmentedJournal,
)
from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
from zeebe_tpu_torch.protocol import ValueType, command
from zeebe_tpu_torch.protocol.intent import (
    DeploymentIntent,
    MessageIntent,
    ProcessInstanceCreationIntent,
)
from zeebe_tpu_torch.testing.chaos_disk import (
    DiskChaosController,
    DiskFaultPlan,
    classify_path,
    format_spec,
    maybe_install_from_env,
    parse_spec,
)
from zeebe_tpu_torch.utils import storage_io
from zeebe_tpu_torch.utils.metrics import REGISTRY


def _metric_total(name: str, **labels) -> float:
    total = 0.0
    for fam, kind, label_str, value in REGISTRY.snapshot():
        if fam != f"zeebe_{name}" or kind == "histogram":
            continue
        if all(f'{k}="{v}"' in label_str for k, v in labels.items()):
            total += value
    return total


@pytest.fixture(autouse=True)
def _no_leaked_controller():
    yield
    storage_io.install_controller(None)


def _flip_byte(path: Path, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes((b[0] ^ 0xFF,)))


# ---------------------------------------------------------------------------
# the chaos plan + the seam


class TestDiskFaultPlan:
    def test_spec_round_trip(self):
        plan = DiskFaultPlan(seed=7, eio_p=0.01, enospc_p=0.002,
                             torn_p=0.02, fsync_fail_p=0.004,
                             fsync_stall_p=0.03, stall_ms=150,
                             bitrot_interval_ms=1500,
                             classes=("journal", "cold"))
        assert parse_spec(format_spec(plan)) == plan

    def test_configured_classes(self):
        assert DiskFaultPlan().configured_classes() == []
        plan = DiskFaultPlan(eio_p=0.1, bitrot_interval_ms=100)
        assert plan.configured_classes() == ["eio", "bitrot"]

    def test_classify_path(self):
        assert classify_path("/d/w/partition-1/raft/raft-log/journal-1.log") \
            == "journal"
        assert classify_path("/d/w/partition-1/stream/journal.meta") \
            == "journal"
        assert classify_path(
            "/d/w/partition-1/snapshots/snapshots/1-1-1-1/state.bin") \
            == "snapshot"
        assert classify_path(
            "/d/w/partition-1/snapshots/pending/2-1-9-9/delta.bin") \
            == "snapshot"
        assert classify_path("/d/w/partition-1/cold/cold-00000001.seg") \
            == "cold"
        assert classify_path("/d/backups/1/7/manifest.json") == "backup"
        assert classify_path("/d/w/partition-1/scrub-state.json") is None
        assert classify_path("/d/w/partition-1/flight-123.json") is None

    def test_member_streams_differ_but_are_seeded(self):
        a1 = DiskChaosController(DiskFaultPlan(seed=3, eio_p=0.5), "w-a")
        a2 = DiskChaosController(DiskFaultPlan(seed=3, eio_p=0.5), "w-a")
        b = DiskChaosController(DiskFaultPlan(seed=3, eio_p=0.5), "w-b")
        path = "x/raft-log/journal-1.log"
        seq_a1 = [a1.write_fault(path, 100)[0] for _ in range(64)]
        seq_a2 = [a2.write_fault(path, 100)[0] for _ in range(64)]
        seq_b = [b.write_fault(path, 100)[0] for _ in range(64)]
        assert seq_a1 == seq_a2  # reproducible for a member+seed
        assert seq_a1 != seq_b   # members don't mirror each other

    def test_env_install(self, monkeypatch, tmp_path):
        monkeypatch.setenv(
            "ZEEBE_CHAOS_DISK",
            "seed=9,eio=0.5,bitrot_interval_ms=0;classes=journal")
        controller = maybe_install_from_env("w-0", str(tmp_path))
        assert controller is not None
        assert storage_io.controller() is controller
        assert controller.counts_file and controller.ledger_file
        storage_io.install_controller(None)
        monkeypatch.delenv("ZEEBE_CHAOS_DISK")
        assert maybe_install_from_env("w-0", str(tmp_path)) is None


class TestStorageIoSeam:
    def test_passthrough_without_controller(self, tmp_path):
        f = storage_io.open_file(tmp_path / "x.log", "wb")
        assert not type(f).__name__.startswith("_Chaos")
        f.write(b"abc")
        f.close()
        assert (tmp_path / "x.log").read_bytes() == b"abc"

    def test_write_faults_raise_typed_errnos(self, tmp_path):
        import errno

        class Script:
            armed = True
            verdicts = iter([("eio", 0), ("enospc", 0), ("torn", 2),
                             ("ok", 0)])

            def write_fault(self, path, n):
                return next(self.verdicts)

            def fsync_fault(self, path):
                pass

        storage_io.install_controller(Script())
        path = tmp_path / "raft-log" / "journal-1.log"
        path.parent.mkdir()
        f = storage_io.open_file(path, "wb")
        with pytest.raises(OSError) as e:
            f.write(b"payload")
        assert e.value.errno == errno.EIO
        with pytest.raises(OSError) as e:
            f.write(b"payload")
        assert e.value.errno == errno.ENOSPC
        # torn: a PREFIX lands in the file before the error surfaces
        with pytest.raises(OSError):
            f.write(b"payload")
        f.flush()
        assert path.read_bytes() == b"pa"
        f.write(b"whole")
        f.close()

    def test_bitrot_tick_flips_and_ledgers(self, tmp_path):
        plan = DiskFaultPlan(seed=1, bitrot_interval_ms=1)
        root = tmp_path / "w"
        raft = root / "partition-1" / "raft" / "raft-log"
        raft.mkdir(parents=True)
        target = raft / "journal-1.log"
        target.write_bytes(bytes(200))
        controller = DiskChaosController(plan, "w", root=root)
        controller.ledger_file = str(tmp_path / "ledger.jsonl")
        controller._last_bitrot = 0.0
        controller.tick()
        assert controller.counts["bitrot"] == 1
        flips = [json.loads(line) for line in
                 Path(controller.ledger_file).read_text().splitlines()]
        assert len(flips) == 1
        flip = flips[0]
        assert flip["class"] == "journal"
        assert flip["offset"] >= 24  # journal header never flipped
        data = target.read_bytes()
        assert data[flip["offset"]] == 0xFF  # 0x00 ^ 0xFF

    def test_counts_snapshot_file(self, tmp_path):
        controller = DiskChaosController(DiskFaultPlan(seed=2, eio_p=1.0),
                                         "w")
        controller.counts_file = str(tmp_path / "counts.json")
        with pytest.raises(OSError):
            storage_io.install_controller(controller)
            f = storage_io.open_file(tmp_path / "journal-9.log", "wb")
            f.write(b"x" * 8)
        controller._last_counts_dump = 0.0
        controller.tick()
        counts = json.loads(Path(controller.counts_file).read_text())
        assert counts["eio"] == 1 and counts["writes"] == 1


# ---------------------------------------------------------------------------
# journal: scrub, repair, fsyncgate


def _filled_journal(tmp_path, n=80):
    j = SegmentedJournal(tmp_path / "j")
    for i in range(n):
        j.append(f"record-{i:05d}".encode() * 4, asqn=i + 1)
    j.flush()
    return j


class TestJournalScrubAndRepair:
    def test_scrub_clean_journal_wraps(self, tmp_path):
        j = _filled_journal(tmp_path)
        next_index, scanned, corrupt = j.scrub(0, 10 << 20)
        assert corrupt is None and scanned > 0
        assert next_index == j.last_index + 1  # wrapped
        j.close()

    def test_scrub_is_resumable_under_budget(self, tmp_path):
        j = _filled_journal(tmp_path)
        cursor, total, passes = 0, 0, 0
        while passes < 100:
            cursor, scanned, corrupt = j.scrub(cursor, 256)
            assert corrupt is None
            total += scanned
            passes += 1
            if cursor > j.last_index:
                break
        assert cursor > j.last_index, "never completed under a tiny budget"
        assert passes > 3  # genuinely incremental
        j.close()

    def test_scrub_detects_flip_and_repair_truncates(self, tmp_path):
        j = _filled_journal(tmp_path)
        _flip_byte(j.segments[-1].path, 700)
        _next, _scanned, corrupt = j.scrub(0, 10 << 20)
        assert corrupt is not None
        evidence = j.repair_corruption()
        assert j.last_index == corrupt - 1
        assert evidence["truncatedRecords"] > 0
        assert evidence["afterLastIndex"] == corrupt - 1
        # post-repair the journal is fully valid and appendable
        _next, _scanned, corrupt2 = j.scrub(0, 10 << 20)
        assert corrupt2 is None
        rec = j.append(b"after-repair", asqn=10_000)
        j.flush()
        assert rec.index == j.last_index
        j.close()
        # a reopen agrees with the repaired view
        j2 = SegmentedJournal(tmp_path / "j")
        assert j2.last_index == rec.index
        j2.close()

    def test_read_raises_typed_error_with_index_and_path(self, tmp_path):
        j = _filled_journal(tmp_path)
        _flip_byte(j.segments[-1].path, 700)
        with pytest.raises(CorruptedJournalError) as e:
            list(j.read_from(1))
        assert e.value.index is not None
        assert e.value.path == j.segments[-1].path
        j.close()


class ForcedFsyncFail:
    """Deterministic fsyncgate trigger: every fsync on a journal path
    fails; writes pass untouched."""

    armed = True
    fired = 0

    def write_fault(self, path, n):
        return ("ok", 0)

    def fsync_fault(self, path):
        if classify_path(path) == "journal":
            ForcedFsyncFail.fired += 1
            raise OSError(5, f"chaos fsync failure on {path}")


class TestFsyncgate:
    def test_failed_fsync_fails_segment_hard_and_holds_acked_prefix(
            self, tmp_path):
        j = _filled_journal(tmp_path, n=40)
        durable = j.last_index
        flushed_marker = j.last_flushed_index
        j.append(b"covered-by-the-failed-fsync", asqn=999)
        old_file = j.segments[-1].file
        storage_io.install_controller(ForcedFsyncFail())
        with pytest.raises(FlushFailedError):
            j.flush()
        storage_io.install_controller(None)
        # the suffix the failed fsync covered is GONE — it must never count
        # toward an acked prefix — and the flush marker did not advance
        assert j.last_index == durable
        assert j.last_flushed_index == flushed_marker
        # never retry on the same fd: the segment reopened a fresh handle
        assert j.segments[-1].file is not old_file
        # the fresh handle serves reads and appends; the next flush covers
        rec = j.append(b"after-the-gate", asqn=1000)
        assert j.flush() == rec.index
        assert j.last_flushed_index == rec.index
        assert [r.index for r in j.read_from(durable)][:2] == [
            durable, rec.index]
        j.close()

    def test_raft_leader_steps_down_on_fsync_failure(self, tmp_path):
        """A leader whose own journal cannot fsync must stop leading (its
        rewound log would hand out conflicting same-term entries); the
        caller sees not-leader, nothing is acked, nothing is lost."""
        cluster = InProcessCluster(
            broker_count=1, partition_count=1, replication_factor=1,
            directory=tmp_path / "c", device="cpu")
        try:
            cluster.await_leaders()
            leader = cluster.leader(1)
            cluster.write_command(1, command(
                ValueType.DEPLOYMENT, DeploymentIntent.CREATE,
                {"resources": [{"resourceName": "p.bpmn",
                                "resource": to_bpmn_xml(
                                    Bpmn.create_executable_process("p")
                                    .start_event("s").end_event("e")
                                    .done())}]}))
            cluster.run(500)
            commit_before = leader.raft.commit_index
            storage_io.install_controller(ForcedFsyncFail())
            create = command(
                ValueType.PROCESS_INSTANCE_CREATION,
                ProcessInstanceCreationIntent.CREATE,
                {"bpmnProcessId": "p", "version": -1, "variables": {}})
            position = leader.client_write(create)
            # the fsync failure stepped the leader down mid-append: the
            # write reports not-leader (None), nothing acked beyond the
            # durable prefix
            assert position is None
            assert not leader.is_leader
            assert leader.raft.commit_index == commit_before
            storage_io.install_controller(None)
            # the single-node cluster re-elects and serves again
            cluster.await_leaders()
            cluster.write_command(1, create)
            cluster.run(500)
            assert cluster.leader(1).raft.commit_index > commit_before
        finally:
            storage_io.install_controller(None)
            cluster.close()


# ---------------------------------------------------------------------------
# scrubber + repair seams, end to end on the in-process cluster


def _deploy_and_load(cluster, n=40, process_id="sf"):
    cluster.write_command(1, command(
        ValueType.DEPLOYMENT, DeploymentIntent.CREATE,
        {"resources": [{"resourceName": "sf.bpmn", "resource": to_bpmn_xml(
            Bpmn.create_executable_process(process_id)
            .start_event("s").end_event("e").done())}]}))
    cluster.run(300)
    create = command(
        ValueType.PROCESS_INSTANCE_CREATION,
        ProcessInstanceCreationIntent.CREATE,
        {"bpmnProcessId": process_id, "version": -1, "variables": {}})
    leader = cluster.leader(1)
    for _ in range(n // 5):
        leader.write_commands([create] * 5)
        cluster.run(100)
    return create


class TestScrubberDetectionAndRepair:
    def test_clean_tree_scrubs_healthy_with_full_passes(self, tmp_path):
        cluster = InProcessCluster(
            broker_count=1, partition_count=1, replication_factor=1,
            directory=tmp_path / "c", device="cpu")
        try:
            cluster.await_leaders()
            _deploy_and_load(cluster, 20)
            leader = cluster.leader(1)
            cluster.run(10_000)
            status = leader.scrubber.status()
            assert status["status"] == "HEALTHY"
            assert status["fullPasses"] >= 1
            assert status["scannedBytes"] > 0
            assert status["corruptionsDetected"] == 0
            # /health carries the block; the evidence file exists
            assert leader.health()["storageIntegrity"]["status"] == "HEALTHY"
            assert (leader.directory / "scrub-state.json").exists()
        finally:
            cluster.close()

    def test_stream_rot_detected_and_rematerialized(self, tmp_path):
        cluster = InProcessCluster(
            broker_count=1, partition_count=1, replication_factor=1,
            directory=tmp_path / "c", device="cpu")
        try:
            cluster.await_leaders()
            create = _deploy_and_load(cluster, 40)
            leader = cluster.leader(1)
            last_position = leader.stream.last_position
            seg_path = leader.stream_journal.segments[0].path
            _flip_byte(seg_path, 200)  # early committed history
            cluster.run(12_000)  # several scrub cycles + the repair
            leader = cluster.leader(1)
            repairs = [r for r in leader.scrubber.repairs
                       if r["target"] == "stream"]
            assert repairs, leader.scrubber.status()
            assert repairs[-1]["action"] == "truncate-rematerialize"
            # the repaired journal re-materialized the whole committed
            # prefix from the raft log: nothing lost, scrub clean again
            assert leader.stream.last_position >= last_position
            assert leader.scrubber.status()["status"] == "HEALTHY"
            next_i, _scanned, corrupt = leader.stream_journal.scrub(
                0, 10 << 20)
            assert corrupt is None
            # and the partition still serves
            leader.write_commands([create] * 3)
            cluster.run(500)
            assert cluster.leader(1).stream.last_position \
                > last_position
            assert _metric_total("storage_scrub_repairs_total",
                                 target="stream") >= 1
        finally:
            cluster.close()

    def test_follower_raft_rot_reconverges_crc_identical(self, tmp_path):
        """The repair-probe property, in process: flip a byte in a
        follower's raft journal; its scrubber truncates at the corrupt
        frame and the leader re-replicates the suffix — the follower ends
        CRC-identical to the leader past the corrupted index."""
        from zeebe_tpu_torch.testing.torture import journal_dir_records

        cluster = InProcessCluster(
            broker_count=3, partition_count=1, replication_factor=3,
            directory=tmp_path / "c", device="cpu")
        try:
            cluster.await_leaders()
            _deploy_and_load(cluster, 30)
            leader_node = cluster.leader_broker(1).cfg.node_id
            follower_node = next(n for n in cluster.brokers
                                 if n != leader_node)
            follower = cluster.brokers[follower_node].partitions[1]
            cluster.run(1000)
            raft_dir = tmp_path / "c" / follower_node / "partition-1" \
                / "raft" / "raft-log"
            seg = sorted(raft_dir.glob("journal-*.log"))[-1]
            size = seg.stat().st_size
            _flip_byte(seg, 24 + (size - 24) // 3)
            cluster.run(15_000)  # scrub detects; heartbeats re-converge
            detections = [d for d in follower.scrubber.detections
                          if d["target"] == "raft"]
            repairs = [r for r in follower.scrubber.repairs
                       if r["target"] == "raft"]
            assert detections and repairs, follower.scrubber.status()
            corrupt_index = detections[-1]["corruptIndex"]
            # offline: byte-identical logs, follower extends past the rot
            cluster.close()
            leader_map, _ = journal_dir_records(
                tmp_path / "c" / leader_node / "partition-1" / "raft"
                / "raft-log")
            follower_map, follower_ok = journal_dir_records(raft_dir)
            assert follower_ok
            common = set(leader_map) & set(follower_map)
            assert common and max(follower_map) >= corrupt_index
            assert all(leader_map[i] == follower_map[i] for i in common)
        finally:
            cluster.close()

    def test_repaired_log_below_commit_abstains_from_elections(self,
                                                               tmp_path):
        """Raft safety under lying disks: a replica whose log was truncate-
        repaired below its own commit index must neither start elections
        nor grant votes until the leader re-converges it — its shortened
        log would otherwise let a quorum elect a leader missing committed
        entries (the torture gate caught exactly this as committed-log
        split-brain before the abstention rule)."""
        cluster = InProcessCluster(
            broker_count=3, partition_count=1, replication_factor=3,
            directory=tmp_path / "c", device="cpu")
        try:
            cluster.await_leaders()
            _deploy_and_load(cluster, 20)
            leader_node = cluster.leader_broker(1).cfg.node_id
            follower_node = next(n for n in cluster.brokers
                                 if n != leader_node)
            raft = cluster.brokers[follower_node].partitions[1].raft
            cluster.run(500)
            assert raft._election_safe()
            commit = raft.commit_index
            assert commit > 8
            # simulate the corruption repair's truncation below commit
            raft.journal.truncate_after(commit - 5)
            raft._flushed_index = min(raft._flushed_index,
                                      raft.journal.last_index)
            assert not raft._election_safe()
            # no self-election...
            raft._start_prevote()
            assert raft.role.value == "follower"
            # ...and no vote for a candidate whose log does not cover our
            # REMEMBERED commit index — the shortened log must not judge,
            # and the commit bar is what prevents electing history-losers
            third = next(n for n in cluster.brokers
                         if n not in (leader_node, follower_node))
            raft._on_vote_request(third, {
                "term": raft.current_term + 1, "candidate": third,
                "lastLogIndex": commit - 5, "lastLogTerm": 10**9,
                "prevote": False})
            assert raft.voted_for is None
            # a candidate COVERING the commit index is grantable (liveness
            # when rot hits several replicas at once)
            raft._on_vote_request(third, {
                "term": raft.current_term, "candidate": third,
                "lastLogIndex": commit + 10, "lastLogTerm": 10**9,
                "prevote": False})
            assert raft.voted_for == third
            # the live leader refills the truncated suffix; abstention ends
            cluster.run(4000)
            assert raft._election_safe()
            assert raft.journal.last_index >= commit
        finally:
            cluster.close()

    def test_boot_below_flush_marker_boots_suspect(self, tmp_path):
        """Boot-time rot: a raft journal whose open() scan truncated BELOW
        its own persisted flush marker lost flushed (possibly committed)
        history — the restarted replica must boot SUSPECT and abstain from
        elections until a leader refills it past the marker. Without this,
        a silently-shortened log can win an election and re-mint different
        bytes at committed positions (the export split-brain the torture
        gate caught)."""
        cluster = InProcessCluster(
            broker_count=3, partition_count=1, replication_factor=3,
            directory=tmp_path / "c", device="cpu")
        try:
            cluster.await_leaders()
            _deploy_and_load(cluster, 30)
            leader_node = cluster.leader_broker(1).cfg.node_id
            follower_node = next(n for n in cluster.brokers
                                 if n != leader_node)
            marker_before = cluster.brokers[follower_node].partitions[1] \
                .raft.journal.last_flushed_index
            assert marker_before > 8
            cluster.hard_crash_broker(follower_node)
            # rot an EARLY flushed frame on the crashed replica's disk: the
            # reopen scan truncates way below the flush marker
            raft_dir = tmp_path / "c" / follower_node / "partition-1" \
                / "raft" / "raft-log"
            seg = sorted(raft_dir.glob("journal-*.log"))[0]
            _flip_byte(seg, 100)
            cluster.restart_broker(follower_node)
            raft = cluster.brokers[follower_node].partitions[1].raft
            assert raft._suspect_index >= marker_before
            assert raft.journal.last_index < marker_before
            assert not raft._election_safe()
            # the leader refills; suspicion clears at the marker
            cluster.run(6000)
            assert raft._election_safe()
            assert raft.journal.last_index >= marker_before
        finally:
            cluster.close()

    def test_unrepairable_rot_contains_like_poison_not_crash(self, tmp_path):
        """A repair looping inside the throttle window must NOT raise (its
        callers are rpc handlers and tick(), whose escape path is the whole
        worker poll loop) — it reports gaveUp through the storage listener
        and the partition fails its processor like a poison record."""
        cluster = InProcessCluster(
            broker_count=1, partition_count=1, replication_factor=1,
            directory=tmp_path / "c", device="cpu")
        try:
            cluster.await_leaders()
            _deploy_and_load(cluster, 10)
            leader = cluster.leader(1)
            first = leader.raft.repair_journal_corruption()
            assert not first.get("gaveUp")
            second = leader.raft.repair_journal_corruption()  # within 5s
            assert second.get("gaveUp")
            assert leader.processor.phase.value == "failed"
            # the pump keeps running (unhealthy, but alive)
            cluster.run(500)
            flight = leader.flight.snapshot()["partitions"]["1"]
            assert any(e.get("action") == "gave-up" for e in flight
                       if e["kind"] == "storage_repair")
        finally:
            cluster.close()

    def test_snapshot_rot_quarantined_and_reanchored(self, tmp_path):
        cluster = InProcessCluster(
            broker_count=1, partition_count=1, replication_factor=1,
            directory=tmp_path / "c", snapshot_period_ms=10**9, device="cpu")
        try:
            cluster.await_leaders()
            _deploy_and_load(cluster, 30)
            leader = cluster.leader(1)
            assert leader.take_snapshot(force_full=True)
            snap = leader.snapshot_store.latest_snapshot()
            state_bin = snap.path / "state.bin"
            _flip_byte(state_bin, state_bin.stat().st_size // 2)
            cluster.run(12_000)
            leader = cluster.leader(1)
            repairs = [r for r in leader.scrubber.repairs
                       if r["target"] == "snapshot"]
            assert repairs, leader.scrubber.status()
            # quarantined out of the recovery path, bits preserved (until
            # the next store open cleans corrupt leftovers)
            quarantined = snap.path.with_name(snap.path.name + ".corrupt")
            assert quarantined.exists()
            # a fresh FULL snapshot re-anchored recovery (an idle partition
            # legitimately reuses the freed id — the corrupt dir no longer
            # blocks the "not newer" check)
            assert repairs[-1]["action"] == "fresh-full-snapshot"
            chain = leader.snapshot_store.latest_valid_chain()
            assert chain is not None and chain[0].has_file("state.bin")
            assert chain[-1].id >= snap.id
            from zeebe_tpu_torch.state.snapshot import _verify_manifest

            assert _verify_manifest(chain[-1].path)
            assert leader.scrubber.status()["status"] == "HEALTHY"
        finally:
            cluster.close()


class TestColdReadSideDegradation:
    def test_cold_rot_on_fault_in_degrades_not_poisons(self, tmp_path):
        """Satellite (read-side parity with's write-side): a CRC
        mismatch on cold fault-in surfaces the typed DEGRADED latch +
        metric + repair transition — the pump survives and the woken
        instance completes from rebuilt state."""
        from zeebe_tpu_torch.testing.chaos import ChaosHarness, FaultPlan

        h = ChaosHarness(
            FaultPlan(seed=5), broker_count=1, partition_count=1,
            replication_factor=1, directory=tmp_path,
            snapshot_period_ms=10**9, tiering=True,
            tiering_park_after_ms=400, tiering_spill_batch=4096, device="cpu")
        try:
            c = h.cluster
            c.await_leaders()
            msg = (Bpmn.create_executable_process("cold_msg")
                   .start_event("s")
                   .intermediate_catch_message(
                       "wait", message_name="cm", correlation_key="=ck")
                   .end_event("e").done())
            c.write_command(1, command(
                ValueType.DEPLOYMENT, DeploymentIntent.CREATE,
                {"resources": [{"resourceName": "m.bpmn",
                                "resource": to_bpmn_xml(msg)}]}))
            h.run_ticks(5)
            leader = c.leader(1)
            # pin the READ path: no scrubber racing to detect the rot first
            leader.scrubber = None
            leader.write_commands([command(
                ValueType.PROCESS_INSTANCE_CREATION,
                ProcessInstanceCreationIntent.CREATE,
                {"bpmnProcessId": "cold_msg", "version": -1,
                 "variables": {"ck": f"c-{i}"}}) for i in range(40)])
            h.run_ticks(45)  # park + pass park_after_ms + a manager pass
            leader = c.leader(1)
            assert leader.tiering.spilled_instances > 0
            read_errs_before = _metric_total("state_tier_read_errors_total")
            # rot EVERY cold frame so whichever instance wakes first hits it
            cold_dir = leader.directory / "cold"
            for seg in cold_dir.glob("cold-*.seg"):
                raw = bytearray(seg.read_bytes())
                for off in range(16, len(raw), 48):
                    raw[off] ^= 0xFF
                seg.write_bytes(bytes(raw))
            # wake a spilled instance: the fault-in must trip the typed
            # error, the pump must survive, the repair must transition
            leader.write_commands([command(
                ValueType.MESSAGE, MessageIntent.PUBLISH,
                {"name": "cm", "correlationKey": "c-3",
                 "timeToLive": 30_000, "messageId": "", "variables": {}})])
            h.run_ticks(20)  # pump survives = these ticks don't raise
            leader = c.leader(1)
            assert _metric_total("state_tier_read_errors_total") \
                > read_errs_before
            assert leader.processor.phase.value != "failed"
            # the repair transition rebuilt state from chain+log: the
            # correlate completed against the recovered value
            subs = leader.db.key_counts_by_cf().get(
                "MESSAGE_SUBSCRIPTION_BY_KEY", 0)
            assert subs == 39, subs
            # the repair left flight evidence
            flight = leader.flight.snapshot()["partitions"]["1"]
            kinds = [e["kind"] for e in flight]
            assert "storage_repair" in kinds
            # replay parity: the rebuilt state equals a from-log replay
            h.check_replay_equivalence(1)
            assert not h.violations, h.violations
        finally:
            h.close()


# ---------------------------------------------------------------------------
# satellite: mid-chain snapshot corruption falls back within budget


class TestMidChainSnapshotCorruption:
    def test_mid_chain_delta_tamper_falls_back_within_budget(self, tmp_path):
        from zeebe_tpu_torch.testing.chaos import ChaosHarness, FaultPlan
        from zeebe_tpu_torch.testing.soak import tamper_snapshot

        h = ChaosHarness(FaultPlan(seed=8), broker_count=1,
                         partition_count=1, replication_factor=1,
                         directory=tmp_path, snapshot_period_ms=10**9, device="cpu")
        try:
            c = h.cluster
            c.await_leaders()
            # accumulate STICKY state (waiting instances) so snapshots after
            # the base are genuine deltas — a create/complete workload's
            # dirty set rivals its resident set and forces full rebases
            msg = (Bpmn.create_executable_process("mc_msg")
                   .start_event("s")
                   .intermediate_catch_message(
                       "wait", message_name="mc", correlation_key="=ck")
                   .end_event("e").done())
            c.write_command(1, command(
                ValueType.DEPLOYMENT, DeploymentIntent.CREATE,
                {"resources": [{"resourceName": "m.bpmn",
                                "resource": to_bpmn_xml(msg)}]}))
            h.run_ticks(5)
            leader = c.leader(1)

            def waiters(tag, n=20):
                return [command(
                    ValueType.PROCESS_INSTANCE_CREATION,
                    ProcessInstanceCreationIntent.CREATE,
                    {"bpmnProcessId": "mc_msg", "version": -1,
                     "variables": {"ck": f"{tag}-{i}"}}) for i in range(n)]

            leader.write_commands(waiters("base", 40))
            h.run_ticks(8)
            assert leader.take_snapshot()  # the chain base
            for round_i in range(3):  # three deltas on top
                leader.write_commands(waiters(f"d{round_i}", 8))
                h.run_ticks(6)
                assert leader.take_snapshot()
            assert leader._chain_len >= 3, "no chain built"
            node = c.leader_broker(1).cfg.node_id
            c.hard_crash_broker(node)
            h.clear_exporter_watermarks(node)
            torn = tamper_snapshot(tmp_path, node, 1, pick="mid-chain")
            assert torn is not None, "no mid-chain delta to tamper"
            c.restart_broker(node)
            h.clear_exporter_watermarks(node)
            for _ in range(100):
                h.run_ticks(1)
                if c.leader(1) is not None:
                    break
            leader = c.leader(1)
            assert leader is not None
            rec = leader.last_recovery
            # fell back to an OLDER valid chain (the torn member's chain is
            # invalid), within the recovery budget contract)
            assert rec["withinBudget"] is True
            assert rec["snapshotId"] != torn
            assert torn not in (rec["snapshotId"] or "")
            # replay byte-parity over the fallback recovery
            h.run_ticks(10)
            h.check_exactly_once_materialization(1)
            h.check_replay_equivalence(1)
            assert not h.violations, h.violations
        finally:
            h.close()

    def test_tamper_mid_chain_requires_a_mid_chain_delta(self, tmp_path):
        from zeebe_tpu_torch.testing.soak import tamper_snapshot

        cluster = InProcessCluster(
            broker_count=1, partition_count=1, replication_factor=1,
            directory=tmp_path / "c", snapshot_period_ms=10**9, device="cpu")
        try:
            cluster.await_leaders()
            _deploy_and_load(cluster, 10)
            leader = cluster.leader(1)
            assert leader.take_snapshot(force_full=True)
            # only a base exists: no mid-chain victim
            assert tamper_snapshot(tmp_path / "c", "broker-0", 1,
                                   pick="mid-chain") is None
        finally:
            cluster.close()


# ---------------------------------------------------------------------------
# torture gate: pure offline checkers


class TestTortureCheckers:
    def _journal(self, tmp_path, name, n=30, tag="entry"):
        j = SegmentedJournal(tmp_path / name)
        for i in range(n):
            j.append(f"{tag}-{i}".encode() * 3, asqn=i + 1)
        j.flush()
        j.close()
        return tmp_path / name

    def test_journal_dir_records_and_convergence(self, tmp_path):
        from zeebe_tpu_torch.testing.torture import (
            check_follower_convergence,
            journal_dir_records,
            journal_dir_records_tolerant,
        )

        a = self._journal(tmp_path, "a")
        b = self._journal(tmp_path, "b")
        crcs, ok = journal_dir_records(a)
        assert ok and len(crcs) == 30
        verdict = check_follower_convergence(a, b, corrupt_region_index=10)
        assert verdict["verified"] is True
        # a shortened follower that never re-converged past the corruption
        short = self._journal(tmp_path, "short", n=5)
        verdict = check_follower_convergence(a, short,
                                             corrupt_region_index=10)
        assert verdict["verified"] is False
        # a GENUINELY diverged follower — validly-framed different bytes at
        # the same indexes — fails on CRC mismatch
        diverged = self._journal(tmp_path, "diverged", n=30, tag="other")
        verdict = check_follower_convergence(a, diverged, None)
        assert verdict["verified"] is False
        assert verdict["crcMismatches"]
        # late rot on the follower is EXCLUDED, not counted as divergence
        # (a frame only one side can read proves nothing either way), and
        # does not block a verdict anchored before the rot
        rotted = self._journal(tmp_path, "rotted", n=30)
        seg = next(rotted.glob("journal-*.log"))
        _flip_byte(seg, seg.stat().st_size - 40)  # rot near the tail
        assert len(journal_dir_records_tolerant(rotted)) >= 28
        verdict = check_follower_convergence(a, rotted,
                                             corrupt_region_index=10)
        assert verdict["verified"] is True

    def test_tolerant_reader_skips_rotten_frames(self, tmp_path):
        from zeebe_tpu_torch.testing.torture import journal_records_crc

        d = self._journal(tmp_path, "rot", n=40)
        seg = next(d.glob("journal-*.log"))
        _flip_byte(seg, 400)  # inside some record's DATA (not its header)
        crcs, ok = journal_records_crc(seg)
        assert not ok  # the flip is real rot, not a torn tail

    def test_check_bitrot_flips_rules(self, tmp_path):
        from zeebe_tpu_torch.testing.torture import check_bitrot_flips

        missing = str(tmp_path / "w0" / "partition-1" / "cold" / "gone.seg")
        live = tmp_path / "w0" / "partition-1" / "stream" / "journal-1.log"
        live.parent.mkdir(parents=True)
        live.write_bytes(b"\x00" * 64)  # no valid header: reads as damaged
        flips = [
            {"path": missing, "class": "cold", "offset": 3, "atMs": 1000},
            {"path": str(live), "class": "journal", "offset": 30,
             "atMs": 1000},
            {"path": str(live), "class": "journal", "offset": 30,
             "atMs": 99_000},
        ]
        evidence = {
            str(tmp_path / "w0" / "partition-1"): [
                {"target": "stream", "atMs": 2000,
                 "directory": str(live.parent)},
            ],
        }
        violations, stats = check_bitrot_flips(flips, evidence,
                                               run_end_ms=100_000)
        # cold flip: file gone → superseded; journal flip 1: detection
        # matches by directory; journal flip 2: inside the grace window
        assert violations == []
        assert stats == {"flips": 3, "detected": 1, "superseded": 1,
                         "repairedVerified": 0, "tooRecent": 1}
        # with no evidence and an old flip on a living file: violation
        violations, stats = check_bitrot_flips(
            [{"path": str(live), "class": "journal", "offset": 30,
              "atMs": 1000}], {}, run_end_ms=100_000)
        assert len(violations) == 1
        assert "never detected" in violations[0]


# ---------------------------------------------------------------------------
# storageIntegrity surfaces


class TestStorageIntegritySurfaces:
    def test_cluster_status_row_carries_compact_block(self, tmp_path):
        from zeebe_tpu_torch.broker.management import broker_status

        cluster = InProcessCluster(
            broker_count=1, partition_count=1, replication_factor=1,
            directory=tmp_path / "c", device="cpu")
        try:
            cluster.await_leaders()
            _deploy_and_load(cluster, 10)
            cluster.run(6_000)
            row = broker_status(cluster.brokers["broker-0"])
            block = row["partitions"]["1"]["storageIntegrity"]
            assert block["status"] == "HEALTHY"
            assert block["fullPasses"] >= 1
            assert block["corruptions"] == 0
        finally:
            cluster.close()
