# tests/test_state_tiering.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""State tiering: range-bounded scans + bulk load, the
hierarchical timer wheel, the cold parked-instance store, and the tiered
broker integration (spill → wake → crash-recovery parity)."""

import random
import time

import pytest

from zeebe_tpu_torch.state import ColumnFamilyCode as CF
from zeebe_tpu_torch.state import ColdRef, ColdStore, TieredZbDb, ZbDb
from zeebe_tpu_torch.state.db import encode_key


# ---------------------------------------------------------------------------
# range-bounded scans + first_item (satellite: O(due) sweeps)


class TestRangeScans:
    def _db(self):
        db = ZbDb()
        with db.transaction() as txn:
            cf = db.column_family(CF.TIMER_DUE_DATES)
            for due in (10, 20, 30, 40, 50):
                cf.put((due, due * 7), None)
        return db

    def test_items_below_bounds_the_scan(self):
        db = self._db()
        with db.transaction():
            cf = db.column_family(CF.TIMER_DUE_DATES)
            below = [k for k, _ in cf.items_below((31,))]
            assert len(below) == 3
            assert [k for k, _ in cf.items_below((10,))] == []
            assert len([k for k, _ in cf.items_below((1000,))]) == 5

    def test_items_below_sees_overlay_and_hides_deletes(self):
        db = self._db()
        with db.transaction() as txn:
            cf = db.column_family(CF.TIMER_DUE_DATES)
            cf.put((15, 1), None)          # pending write inside range
            cf.delete((20, 140))           # pending delete inside range
            dues = [k for k, _ in cf.items_below((31,))]
            assert len(dues) == 3          # 10, 15, 30

    def test_first_item_skips_pending_delete_of_smallest(self):
        db = self._db()
        with db.transaction() as txn:
            cf = db.column_family(CF.TIMER_DUE_DATES)
            assert cf.first_item()[0] == encode_key(
                CF.TIMER_DUE_DATES, (10, 70))
            cf.delete((10, 70))
            assert cf.first_item()[0] == encode_key(
                CF.TIMER_DUE_DATES, (20, 140))
            cf.put((5, 1), "x")
            assert cf.first_item() == (encode_key(
                CF.TIMER_DUE_DATES, (5, 1)), "x")

    def test_first_item_empty_cf(self):
        db = self._db()
        with db.transaction():
            assert db.column_family(CF.MESSAGES).first_item() is None


class TestBulkLoad:
    """Satellite: snapshot/chain install sorts once instead of insorting
    per key — parity against the incremental path."""

    def _random_ops(self, rng, n=3000):
        ops = []
        for _ in range(n):
            key = encode_key(CF.VARIABLES, (rng.randrange(500), "v"))
            if rng.random() < 0.25:
                ops.append(("del", key, None))
            else:
                ops.append(("put", key, {"x": rng.randrange(10_000)}))
        return ops

    def test_bulk_apply_parity_with_incremental(self):
        rng = random.Random(42)
        ops = self._random_ops(rng)
        incr, bulk = ZbDb(), ZbDb()
        # incremental: committed-store mutators in op order
        for op, key, val in ops:
            if op == "put":
                incr._put_committed(key, val)
            else:
                incr._delete_committed(key)
        # bulk: one pass (last write per key wins, like a delta)
        puts, deletes = {}, []
        for op, key, val in ops:
            if op == "put":
                puts[key] = val
            else:
                puts.pop(key, None)
                deletes.append(key)
        # replay deletes-then-puts exactly like apply_delta_bytes' bulk path
        bulk.bulk_apply(puts, [k for k in deletes if k not in puts])
        # the final state differs only where a delete preceded a later put;
        # compare through a delta-shaped op stream instead: unique keys
        final: dict = {}
        for op, key, val in ops:
            if op == "put":
                final[key] = val
            else:
                final.pop(key, None)
        assert dict(incr._data) == final
        assert incr._sorted_keys == sorted(incr._data)
        assert bulk._sorted_keys == sorted(bulk._data)

    def test_delta_bulk_path_parity(self):
        """apply_delta_bytes takes the bulk path on large deltas and the
        per-key path on small ones — identical results either way."""
        base = ZbDb()
        base.begin_delta_tracking()
        with base.transaction():
            cf = base.column_family(CF.VARIABLES)
            for i in range(2000):
                cf.put((i, "v"), {"i": i})
        delta = base.to_delta_bytes()
        big, small = ZbDb(), ZbDb()
        n_big = big.apply_delta_bytes(delta)      # 2000 ≥ 1024 → bulk
        assert n_big == 2000
        # force the incremental path by pre-populating far more keys
        with small.transaction():
            cf = small.column_family(CF.TEMPORARY_VARIABLE_STORE)
            for i in range(2000 * 9):
                cf.put((i,), i)
        small.apply_delta_bytes(delta)
        for i in (0, 999, 1999):
            key = encode_key(CF.VARIABLES, (i, "v"))
            assert big._data[key] == {"i": i} == small._data[key]
        assert list(big._sorted_keys) == sorted(big._data)

    def test_load_snapshot_bytes_roundtrip(self):
        db = ZbDb()
        with db.transaction():
            cf = db.column_family(CF.MESSAGES)
            for i in range(500):
                cf.put((i,), {"name": f"m{i}"})
        fresh = ZbDb()
        assert fresh.load_snapshot_bytes(db.to_snapshot_bytes()) == 500
        assert fresh.content_equals(db)
        assert list(fresh._sorted_keys) == sorted(fresh._data)


# ---------------------------------------------------------------------------
# hierarchical timer wheel


class TestHierarchicalTimerWheel:
    def _wheel(self, now=1_000_000):
        from zeebe_tpu_torch.engine.timer_wheel import HierarchicalTimerWheel

        return HierarchicalTimerWheel(now, tick_ms=64, slots=8, levels=3)

    def test_schedule_and_next_due(self):
        w = self._wheel()
        w.schedule(1_000_500)
        w.schedule(1_000_100)
        assert w.next_due() == 1_000_100

    def test_past_due_visible_immediately(self):
        w = self._wheel()
        w.schedule(999_000)
        assert w.next_due() <= 1_000_000
        assert w.advance(1_000_001) == 1

    def test_advance_drops_and_counts(self):
        w = self._wheel()
        for due in (1_000_100, 1_000_200, 1_005_000):
            w.schedule(due)
        assert w.advance(1_000_300) == 2
        assert len(w) == 1
        assert w.next_due() == 1_005_000

    def test_cascade_from_coarse_levels(self):
        w = self._wheel()
        # beyond level 0 span (64*8=512ms) but inside level 1 (4096ms)
        w.schedule(1_003_000)
        assert w.next_due() == 1_003_000
        # advance into the coarse bucket: the entry must cascade, not drop
        assert w.advance(1_002_900) == 0
        assert w.next_due() == 1_003_000
        assert w.advance(1_003_100) == 1

    def test_overflow_heap_promotes(self):
        w = self._wheel()
        far = 1_000_000 + 64 * 8 * 8 * 8 * 4  # beyond the top span
        w.schedule(far)
        assert w.next_due() == far
        w.advance(far - 100)
        assert w.next_due() == far
        assert w.advance(far + 1) == 1

    def test_never_late_fuzz_vs_oracle(self):
        """The wheel may fire early (over-approximate) but NEVER late: at
        every step its next_due is ≤ the true earliest pending deadline."""
        rng = random.Random(7)
        w = self._wheel(now=0)
        pending: list[int] = []
        now = 0
        for _ in range(2000):
            if rng.random() < 0.6:
                due = now + rng.randrange(0, 40_000)
                w.schedule(due)
                pending.append(due)
            else:
                now += rng.randrange(1, 3_000)
                w.advance(now)
                pending = [d for d in pending if d > now]
            if pending:
                nd = w.next_due()
                assert nd is not None and nd <= min(pending), (
                    f"wheel would fire late: next_due {nd} vs true "
                    f"{min(pending)} at now {now}")

    def test_burst_template_replays_due_and_park_seams(self):
        """The burst-template fast path applies raw encoded keys below the
        state facades: its state plan must replay note_due (wheel) AND
        note_parked (tiering candidates) from the op list — a template-hit
        park workload must not bypass either seam."""
        from zeebe_tpu_torch.engine.burst_templates import BurstTemplate, StateOp
        from zeebe_tpu_torch.protocol import msgpack

        job_op = StateOp(
            "put", encode_key(CF.JOBS, (77,)), [],
            value_bytes=msgpack.packb({"processInstanceKey": 123}))
        due_op = StateOp(
            "put", encode_key(CF.TIMER_DUE_DATES, (555_000, 77)), [],
            value_bytes=msgpack.packb(None))
        tpl = BurstTemplate(
            payload=b"", count=0, pos_offsets=[], ts_offsets=[],
            role_patches=[], mint_count=0, state_ops=[job_op, due_op])
        db = ZbDb()
        parked, dues = [], []
        db.park_listener = parked.append
        db.due_listener = dues.append
        with db.transaction() as txn:
            tpl.apply_state(txn, lambda r: 0)
        assert parked == [123]
        assert dues == [555_000]

    def test_due_date_wheel_rebuild_from_state(self):
        from zeebe_tpu_torch.engine.engine_state import EngineState
        from zeebe_tpu_torch.engine.timer_wheel import DueDateWheel

        db = ZbDb()
        state = EngineState(db, 1)
        with db.transaction():
            state.timers.create(7, {"dueDate": 123_456, "targetElementId": "t"})
            state.messages.put(8, {"name": "m", "correlationKey": "k"},
                               deadline=99_000)
        wheel = DueDateWheel(lambda: 50_000, partition_id=1)
        assert wheel.rebuild(state) == 2
        assert wheel.next_due() == 99_000


# ---------------------------------------------------------------------------
# cold store


class TestColdStore:
    def test_roundtrip_and_crc(self, tmp_path):
        store = ColdStore(tmp_path)
        ref = store.append(b"key-1", b"payload-bytes", tag=42)
        store.flush()
        assert store.read_value(ref) == b"payload-bytes"
        assert ref.tag == 42
        store.close()

    def test_corruption_detected(self, tmp_path):
        store = ColdStore(tmp_path)
        ref = store.append(b"key-1", b"payload-bytes" * 10)
        store.flush()
        seg = store._segments[ref.seg]
        with open(seg.path, "r+b") as f:
            f.seek(ref.off + 12)
            f.write(b"\xff")
        with pytest.raises(ValueError, match="corrupt cold frame"):
            store.read_value(ref)
        store.close()

    def test_release_unlinks_dead_sealed_segment(self, tmp_path):
        store = ColdStore(tmp_path, segment_max_bytes=64)
        a = store.append(b"a", b"x" * 100)   # fills segment 1 past the max
        b = store.append(b"b", b"y" * 100)   # rolls to segment 2
        store.flush()
        seg1_path = store._segments[a.seg].path
        assert seg1_path.exists()
        store.release(a)
        assert not seg1_path.exists()        # sealed + dead → unlinked
        assert store.read_value(b) == b"y" * 100
        store.close()

    def test_open_wipes_stale_segments(self, tmp_path):
        (tmp_path / "cold-00000001.seg").write_bytes(b"stale")
        store = ColdStore(tmp_path)
        assert not (tmp_path / "cold-00000001.seg").exists()
        store.close()


# ---------------------------------------------------------------------------
# tiered db


def _fill(db, n=600, seed=3):
    rng = random.Random(seed)
    keys = []
    with db.transaction():
        cf = db.column_family(CF.ELEMENT_INSTANCE_KEY)
        for i in range(n):
            cf.put((i,), {"key": i, "state": 1,
                          "pad": "x" * rng.randrange(5, 80)})
            keys.append(encode_key(CF.ELEMENT_INSTANCE_KEY, (i,)))
    return keys


class TestTieredZbDb:
    def test_spill_fault_parity(self, tmp_path):
        db = TieredZbDb(tmp_path)
        plain = ZbDb()
        _fill(db)
        _fill(plain)
        n, _ = db.spill_keys(db.committed_keys_of(CF.ELEMENT_INSTANCE_KEY))
        assert n == 600
        assert db.tier_stats()["coldKeys"] == 600
        # logical equality despite the cold representation
        assert db.content_equals(plain)
        # transactional read faults in and promotes
        with db.transaction():
            v = db.column_family(CF.ELEMENT_INSTANCE_KEY).get((5,))
            assert v["key"] == 5
        assert db.faults_total == 1
        assert db.tier_stats()["coldKeys"] == 599
        db.close()

    def test_snapshot_and_delta_bytes_identical_to_untiered(self, tmp_path):
        db = TieredZbDb(tmp_path)
        plain = ZbDb()
        keys = _fill(db)
        _fill(plain)
        db.begin_delta_tracking()
        plain.begin_delta_tracking()
        db.spill_keys(keys[:400])
        assert db.to_snapshot_bytes() == plain.to_snapshot_bytes()
        for d in (db, plain):
            with d.transaction():
                d.column_family(CF.ELEMENT_INSTANCE_KEY).put(
                    (3,), {"key": 3, "state": 2})
        db.spill_keys([keys[3]])  # dirty AND cold: the delta must resolve it
        assert db.to_delta_bytes() == plain.to_delta_bytes()
        db.close()

    def test_committed_get_resolves_without_promoting(self, tmp_path):
        db = TieredZbDb(tmp_path)
        keys = _fill(db)
        db.spill_keys(keys)
        v = db.committed_get(CF.ELEMENT_INSTANCE_KEY, (9,))
        assert v["key"] == 9
        assert db.tier_stats()["coldKeys"] == 600  # no promotion
        db.close()

    def test_iterate_resolves_cold_values(self, tmp_path):
        db = TieredZbDb(tmp_path)
        keys = _fill(db, n=50)
        db.spill_keys(keys)
        with db.transaction():
            vals = list(db.column_family(CF.ELEMENT_INSTANCE_KEY).values())
        assert [v["key"] for v in vals] == list(range(50))
        db.close()

    def test_overwrite_and_delete_release_cold_refs(self, tmp_path):
        db = TieredZbDb(tmp_path)
        keys = _fill(db, n=100)
        db.spill_keys(keys)
        with db.transaction():
            cf = db.column_family(CF.ELEMENT_INSTANCE_KEY)
            cf.put((0,), {"key": 0, "state": 9})
            cf.delete((1,))
        stats = db.tier_stats()
        # the put faulted (read for FK copy not needed — direct put): both
        # entries must be released from the cold store either way
        assert stats["coldKeys"] == 98
        db.close()

    def test_compact_cold_moves_survivors(self, tmp_path):
        db = TieredZbDb(tmp_path, segment_max_bytes=4096)
        keys = _fill(db, n=300)
        db.spill_keys(keys)
        assert db.cold.segment_count > 1
        # kill most entries of the early segments
        with db.transaction():
            cf = db.column_family(CF.ELEMENT_INSTANCE_KEY)
            for i in range(0, 200):
                cf.delete((i,))
        moved = db.compact_cold(min_dead_bytes=1, min_dead_fraction=0.1)
        # whatever survived the worst segment is still readable
        with db.transaction():
            vals = list(db.column_family(CF.ELEMENT_INSTANCE_KEY).values())
        assert [v["key"] for v in vals] == list(range(200, 300))
        assert moved >= 0
        db.close()

    def test_chain_recovery_into_tiered_db(self, tmp_path):
        from zeebe_tpu_torch.state.snapshot import load_chain_db

        src = ZbDb()
        _fill(src, n=200)
        raw = src.to_snapshot_bytes()
        dst = TieredZbDb(tmp_path)
        dst.load_snapshot_bytes(raw)
        assert dst.content_equals(src)
        assert list(dst._sorted_keys) == sorted(dst._data)
        dst.close()

    def test_key_counts_by_cf(self, tmp_path):
        db = TieredZbDb(tmp_path)
        _fill(db, n=40)
        with db.transaction():
            db.column_family(CF.MESSAGES).put((1,), {"name": "m"})
        counts = db.key_counts_by_cf()
        assert counts["ELEMENT_INSTANCE_KEY"] == 40
        assert counts["MESSAGES"] == 1
        db.close()


# ---------------------------------------------------------------------------
# tiered broker integration: park → spill → wake → crash-recovery parity


@pytest.mark.slow
class TestTieredBroker:
    def test_park_spill_wake_and_recovery_parity(self, tmp_path):
        from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
        from zeebe_tpu_torch.protocol import ValueType, command
        from zeebe_tpu_torch.protocol.intent import (
            DeploymentIntent,
            MessageIntent,
            ProcessInstanceCreationIntent,
        )
        from zeebe_tpu_torch.testing.chaos import ChaosHarness, FaultPlan

        h = ChaosHarness(
            FaultPlan(seed=11), broker_count=1, partition_count=1,
            replication_factor=1, directory=tmp_path,
            snapshot_period_ms=2_000, tiering=True,
            tiering_park_after_ms=500, tiering_spill_batch=4096, device="cpu")
        try:
            c = h.cluster
            c.await_leaders()
            msg = (Bpmn.create_executable_process("park_msg")
                   .start_event("s")
                   .intermediate_catch_message(
                       "wait", message_name="pk", correlation_key="=ck")
                   .end_event("e").done())
            tmr = (Bpmn.create_executable_process("park_tmr")
                   .start_event("s")
                   .intermediate_catch_timer("wait", duration="PT8S")
                   .end_event("e").done())
            c.write_command(1, command(
                ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {"resources": [
                    {"resourceName": "m.bpmn", "resource": to_bpmn_xml(msg)},
                    {"resourceName": "t.bpmn", "resource": to_bpmn_xml(tmr)},
                ]}))
            h.run_ticks(5)
            leader = c.leader(1)
            leader.write_commands([command(
                ValueType.PROCESS_INSTANCE_CREATION,
                ProcessInstanceCreationIntent.CREATE,
                {"bpmnProcessId": "park_msg", "version": -1,
                 "variables": {"ck": f"ck-{i}"}}) for i in range(120)])
            leader.write_commands([command(
                ValueType.PROCESS_INSTANCE_CREATION,
                ProcessInstanceCreationIntent.CREATE,
                {"bpmnProcessId": "park_tmr", "version": -1,
                 "variables": {}}) for i in range(120)])
            h.run_ticks(25)  # park + pass park_after_ms + spill
            leader = c.leader(1)
            assert leader.tiering.spilled_instances > 0, "nothing spilled"
            assert leader.db.tier_stats()["coldKeys"] > 0
            # health surfaces the tier accounting
            assert "stateTiering" in leader.health()

            # wake 40 spilled instances by correlation: they fault in cold
            leader.write_commands([command(
                ValueType.MESSAGE, MessageIntent.PUBLISH,
                {"name": "pk", "correlationKey": f"ck-{i}",
                 "timeToLive": 30_000, "messageId": "", "variables": {}})
                for i in range(40)])
            h.run_ticks(10)
            leader = c.leader(1)
            assert leader.db.faults_total > 0
            subs = leader.db.key_counts_by_cf().get(
                "MESSAGE_SUBSCRIPTION_BY_KEY", 0)
            assert subs <= 80  # 120 msg-parked - 40 woken

            # parked timers fire FROM THE COLD TIER once due
            h.run_ticks(160)  # clock passes PT8S
            leader = c.leader(1)
            assert leader.db.key_counts_by_cf().get("TIMERS", 0) == 0

            # crash mid-life, restart: recovered state byte-equals a replay,
            # spilled instances included (the crash-safety argument)
            node = c.leader_broker(1).cfg.node_id
            c.hard_crash_broker(node)
            h.clear_exporter_watermarks(node)
            c.restart_broker(node)
            h.clear_exporter_watermarks(node)
            for _ in range(100):
                h.run_ticks(1)
                if c.leader(1) is not None:
                    break
            leader = c.leader(1)
            assert leader is not None
            assert leader.last_recovery["withinBudget"]
            h.run_ticks(40)  # let the manager re-spill recovered parked state
            h.check_exactly_once_materialization(1)
            h.check_replay_equivalence(1)
            assert not h.violations, h.violations
            # post-recovery wake: correlate an instance parked pre-crash
            leader = c.leader(1)
            before = leader.db.key_counts_by_cf().get(
                "MESSAGE_SUBSCRIPTION_BY_KEY", 0)
            leader.write_commands([command(
                ValueType.MESSAGE, MessageIntent.PUBLISH,
                {"name": "pk", "correlationKey": "ck-100",
                 "timeToLive": 30_000, "messageId": "", "variables": {}})])
            h.run_ticks(10)
            leader = c.leader(1)
            after = leader.db.key_counts_by_cf().get(
                "MESSAGE_SUBSCRIPTION_BY_KEY", 0)
            assert after == before - 1
        finally:
            h.close()


# ---------------------------------------------------------------------------
# satellite: sweeps stay O(due) at 100k+ parked entries, with recovery parity


@pytest.mark.slow
class TestSweepFlatAtScale:
    PARKED_SMALL = 1_000
    PARKED_LARGE = 100_000
    DUE = 500

    def _message_state(self, parked: int):
        from zeebe_tpu_torch.engine.engine_state import EngineState

        db = ZbDb()
        state = EngineState(db, 1)
        far = 10_000_000_000
        with db.transaction():
            for i in range(parked):
                state.messages.put(
                    1_000_000 + i,
                    {"name": "m", "correlationKey": f"k{i}"},
                    deadline=far + i)
            for i in range(self.DUE):
                state.messages.put(
                    i, {"name": "m", "correlationKey": f"due{i}"},
                    deadline=100 + i)
        return db, state

    def _timer_state(self, parked: int):
        from zeebe_tpu_torch.engine.engine_state import EngineState

        db = ZbDb()
        state = EngineState(db, 1)
        far = 10_000_000_000
        with db.transaction():
            for i in range(parked):
                state.timers.create(
                    1_000_000 + i,
                    {"dueDate": far + i, "targetElementId": "t"})
            for i in range(self.DUE):
                state.timers.create(
                    i, {"dueDate": 100 + i, "targetElementId": "t"})
        return db, state

    @staticmethod
    def _time_sweep(db, fn, repeats=5) -> float:
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            with db.transaction():
                out = fn()
            best = min(best, time.perf_counter() - t0)
            assert len(out) == TestSweepFlatAtScale.DUE
        return best

    def test_message_expiry_sweep_flat_vs_parked(self):
        db_s, st_s = self._message_state(self.PARKED_SMALL)
        db_l, st_l = self._message_state(self.PARKED_LARGE)
        t_small = self._time_sweep(db_s, lambda: st_s.messages.expired(5_000))
        t_large = self._time_sweep(db_l, lambda: st_l.messages.expired(5_000))
        # acceptance: within 2× per-sweep wall time despite 100× the backlog
        assert t_large <= max(t_small * 2, 0.002), (
            f"sweep grew with parked count: {t_small * 1e3:.3f}ms @ "
            f"{self.PARKED_SMALL} vs {t_large * 1e3:.3f}ms @ "
            f"{self.PARKED_LARGE}")

    def test_due_timer_sweep_flat_vs_parked(self):
        db_s, st_s = self._timer_state(self.PARKED_SMALL)
        db_l, st_l = self._timer_state(self.PARKED_LARGE)
        t_small = self._time_sweep(db_s, lambda: st_s.timers.due_timers(5_000))
        t_large = self._time_sweep(db_l, lambda: st_l.timers.due_timers(5_000))
        assert t_large <= max(t_small * 2, 0.002), (
            f"sweep grew with parked count: {t_small * 1e3:.3f}ms vs "
            f"{t_large * 1e3:.3f}ms")

    def test_next_due_probe_flat_vs_parked(self):
        db_l, st_l = self._timer_state(self.PARKED_LARGE)
        t0 = time.perf_counter()
        with db_l.transaction():
            nd = st_l.timers.next_due()
        assert nd == 100
        assert time.perf_counter() - t0 < 0.01  # O(log n), not O(n)

    def test_recovery_parity_at_100k_parked(self):
        """Snapshot → bulk restore of a 100k-parked store: byte parity and
        identical sweep results."""
        db_l, st_l = self._message_state(self.PARKED_LARGE)
        raw = db_l.to_snapshot_bytes()
        t0 = time.perf_counter()
        restored = ZbDb.from_snapshot_bytes(raw)
        restore_s = time.perf_counter() - t0
        assert restored.content_equals(db_l)
        assert restored.to_snapshot_bytes() == raw
        from zeebe_tpu_torch.engine.engine_state import EngineState

        st_r = EngineState(restored, 1)
        with restored.transaction():
            expired_r = st_r.messages.expired(5_000)
        with db_l.transaction():
            expired_l = st_l.messages.expired(5_000)
        assert expired_r == expired_l and len(expired_r) == self.DUE
        # the bulk-load path keeps restore O(n log n): generous wall bound
        assert restore_s < 30.0

    def test_expire_batch_with_100k_parked_backlog(self, tmp_path):
        """Engine-level MESSAGE_BATCH EXPIRE over a big parked backlog:
        one batch record expires the due messages, the parked TTLs stay."""
        from zeebe_tpu_torch.models.bpmn import Bpmn
        from zeebe_tpu_torch.protocol import ValueType
        from zeebe_tpu_torch.protocol.intent import MessageBatchIntent
        from zeebe_tpu_torch.testing import EngineHarness

        h = EngineHarness(tmp_path, device="cpu")
        try:
            h.deploy(
                Bpmn.create_executable_process("order")
                .start_event("s")
                .intermediate_catch_message(
                    "wait", message_name="payment",
                    correlation_key="=orderId")
                .end_event("e").done())
            # parked backlog: long TTLs that must NOT expire
            for i in range(2_000):
                h.publish_message("payment", f"parked-{i}",
                                  ttl=3_600_000)
            # due set: short TTLs
            for i in range(300):
                h.publish_message("payment", f"due-{i}", ttl=1_000)
            h.advance_time(1_001)
            batches = (h.exporter.all()
                       .with_value_type(ValueType.MESSAGE_BATCH)
                       .with_intent(MessageBatchIntent.EXPIRED).to_list())
            assert len(batches) == 1
            assert len(batches[0].record.value["messageKeys"]) == 300
            # parked messages still correlate (they did not expire)
            h.create_instance("order",
                              variables={"orderId": "parked-1500"})
            from zeebe_tpu_torch.protocol.intent import (
                ProcessMessageSubscriptionIntent as PMS,
            )

            assert (h.exporter.all()
                    .with_intent(PMS.CORRELATED).exists())
        finally:
            h.close()
