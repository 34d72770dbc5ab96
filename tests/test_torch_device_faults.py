"""The port's device-fault seam: seeded device chaos, the dispatch watchdog,
containment, sampled shadow verification and the health ladder.

The chaos plane, the ladder and their shared machinery are copies (their
text is held to the reference's); the engine-free classes of
``tests/test_device_faults.py`` run here against the copies, and its
``TestCorruptionAccountingWaiver`` on the port's device-chaos gate. The seam itself
is exercised on the port's ``run_group`` on the CPU (the plain version):
whatever the chaos plane does — raise, stall, corrupt — a group comes back
either with the clean run's steps or declined with a typed reason.
"""

from __future__ import annotations

import ast
import json
import random
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_tables import as_copied
from torch_cluster_flows import case_id, reference_tests, run_on_the_port
from zeebe_tpu_torch.engine import kernel_backend as kb
from zeebe_tpu_torch.engine.device_health import (
    HEALTHY,
    QUARANTINED,
    SUSPECT,
    DeviceDefenseCfg,
    DeviceHealth,
    defense_cfg_from_env,
    reset_shared_device_health,
    shared_device_health,
)
from zeebe_tpu_torch.ops import automaton as A
from zeebe_tpu_torch.ops.tables import f64_key_planes
from zeebe_tpu_torch.testing import workloads as W
from zeebe_tpu_torch.testing.chaos_device import (
    FAULT_CLASSES,
    DeviceChaosController,
    DeviceChaosError,
    DeviceFaultPlan,
    format_spec,
    maybe_install_from_env,
    parse_spec,
)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_device_plane():
    """Every test starts HEALTHY with no chaos installed, and cannot leak
    its posture into later tests (the ladder is process-wide)."""
    kb.install_device_chaos(None)
    reset_shared_device_health()
    yield
    kb.install_device_chaos(None)
    reset_shared_device_health()


@pytest.mark.parametrize("path", ["control/audit.py", "testing/chaos_common.py",
                                  "engine/device_health.py", "testing/chaos_device.py"])
def test_module_is_a_copy(path):
    ref = (REPO / "zeebe_tpu" / path).read_text()
    assert (REPO / "zeebe_tpu_torch" / path).read_text() == as_copied(ref)


#: the corruption ledger's accounting of the device-chaos gate
#: (``testing/device_chaos.check_corruption_accounting``), the reference's
#: tests run on the port
WAIVER_CASES = [c for c in reference_tests("test_device_faults")
                if c[1] == "TestCorruptionAccountingWaiver"]


@pytest.mark.parametrize("case", WAIVER_CASES, ids=case_id)
def test_corruption_accounting_waiver_passes_on_the_port(case, tmp_path):
    run_on_the_port(case, tmp_path)


def test_waiver_cases_cover_the_class():
    assert [c[2] for c in WAIVER_CASES] == ["test_surviving_life_gets_no_waiver",
                                            "test_waiver_is_tail_only_even_for_dead_lives"]


WATCHDOG_DEFS = ("DeviceWedgedError", "install_device_chaos", "device_chaos",
                 "_WatchdogWorker", "_WatchdogPool", "_watchdog_call")


def _segments(path: Path) -> dict[str, str]:
    text = path.read_text()
    return {node.name: ast.get_source_segment(text, node, padded=True)
            for node in ast.parse(text).body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.name in WATCHDOG_DEFS}


@pytest.mark.parametrize("name", WATCHDOG_DEFS)
def test_watchdog_is_a_copy(name):
    ref = _segments(REPO / "zeebe_tpu" / "engine" / "kernel_backend.py")[name]
    port = _segments(REPO / "zeebe_tpu_torch" / "engine" / "kernel_backend.py")[name]
    assert port == as_copied(ref)


def test_defaults_and_metric_names_equal_the_reference():
    from zeebe_tpu.engine import device_health as ref_health

    assert DeviceDefenseCfg() == DeviceDefenseCfg(**vars(ref_health.DeviceDefenseCfg()))
    assert DeviceDefenseCfg().dispatch_timeout_ms == 45_000
    assert DeviceDefenseCfg().shadow_sample_rate == 0.02
    from zeebe_tpu_torch.engine import device_health as port_health

    for name in ("_M_STATE", "_M_FAULTS", "_M_TRANSITIONS", "_M_CANARY",
                 "_M_SHADOW_CHECKS", "_M_SHADOW_MISMATCH", "_M_HOST_REROUTES"):
        assert getattr(port_health, name).name == getattr(ref_health, name).name


# ---------------------------------------------------------------------------
# the chaos plane (ported from tests/test_device_faults.py)


class TestChaosDeviceSpec:
    def test_round_trip(self):
        plan = DeviceFaultPlan(seed=7, compile_fail_p=0.01,
                               dispatch_fail_p=0.02, stall_p=0.03,
                               stall_ms=450, chunk_fail_p=0.04,
                               corrupt_p=0.05, flips=2)
        assert parse_spec(format_spec(plan)) == plan

    def test_defaults_round_trip(self):
        assert parse_spec(format_spec(DeviceFaultPlan())) == DeviceFaultPlan()

    def test_configured_classes(self):
        assert DeviceFaultPlan().configured_classes() == []
        plan = DeviceFaultPlan(compile_fail_p=0.1, corrupt_p=0.1)
        assert plan.configured_classes() == ["compile_fail", "corrupt"]
        assert set(DeviceFaultPlan(
            compile_fail_p=1, dispatch_fail_p=1, stall_p=1, chunk_fail_p=1,
            corrupt_p=1).configured_classes()) == set(FAULT_CLASSES)

    def test_seeded_member_streams(self):
        a1 = DeviceChaosController(DeviceFaultPlan(seed=3), "worker-0")
        a2 = DeviceChaosController(DeviceFaultPlan(seed=3), "worker-0")
        b = DeviceChaosController(DeviceFaultPlan(seed=3), "worker-1")
        s1 = [a1.rng.random() for _ in range(32)]
        s2 = [a2.rng.random() for _ in range(32)]
        s3 = [b.rng.random() for _ in range(32)]
        assert s1 == s2
        assert s1 != s3

    def test_env_install_and_disarm(self, tmp_path):
        plan = DeviceFaultPlan(seed=1, dispatch_fail_p=1.0)
        disarm = tmp_path / "disarm"
        env = {"ZEEBE_CHAOS_DEVICE": format_spec(plan),
               "ZEEBE_CHAOS_DEVICE_DISARMFILE": str(disarm)}
        controller = maybe_install_from_env("worker-0", str(tmp_path), env)
        assert controller is not None
        assert kb.device_chaos() is controller
        assert controller.counts_file and controller.ledger_file
        assert shared_device_health().evidence_file is not None
        with pytest.raises(DeviceChaosError):
            controller.dispatch_fault()
        disarm.write_text("x")
        controller.tick()
        assert not controller.armed
        controller.dispatch_fault()  # disarmed: no raise
        assert maybe_install_from_env("worker-0", None, {}) is None

    def test_corrupt_rows_ledger_and_caught(self, tmp_path):
        controller = DeviceChaosController(
            DeviceFaultPlan(seed=5, corrupt_p=1.0, flips=3), "worker-0")
        controller.ledger_file = str(tmp_path / "ledger.jsonl")
        rows = np.zeros((4, 10), np.int32)
        token = controller.corrupt_rows(rows, chunk_index=0)
        assert token == 1
        assert np.count_nonzero(rows) > 0  # bits actually flipped
        controller.note_caught(token, "shadow")
        lines = [json.loads(line) for line in Path(
            controller.ledger_file).read_text().splitlines()]
        assert [e["kind"] for e in lines] == ["inject", "caught"]
        assert lines[0]["seq"] == lines[1]["seq"] == 1
        assert lines[1]["how"] == "shadow"
        assert controller.counts["corrupt"] == 1
        assert controller.counts["corrupt_caught"] == 1


# ---------------------------------------------------------------------------
# the health ladder (fake clock — deterministic; ported)


def ladder(cfg=None, start_ms=1_000_000.0):
    clock = {"now": start_ms / 1000.0}
    cfg = cfg or DeviceDefenseCfg(quarantine_faults=3, fault_window_ms=10_000,
                                  suspect_clear_ms=5_000,
                                  canary_interval_ms=1_000,
                                  canary_successes=2)
    health = DeviceHealth(cfg, clock=lambda: clock["now"])
    return health, clock


class TestDeviceHealthLadder:
    def test_first_fault_latches_suspect(self):
        health, _ = ladder()
        assert health.state == HEALTHY
        health.note_fault("device-dispatch-error")
        assert health.state == SUSPECT
        assert health.faults["device-dispatch-error"] == 1

    def test_faults_in_window_quarantine(self):
        health, clock = ladder()
        for _ in range(3):
            health.note_fault("device-wedged")
            clock["now"] += 0.1
        assert health.state == QUARANTINED
        targets = [t["to"] for t in health.transitions]
        assert targets == [SUSPECT, QUARANTINED]

    def test_spread_out_faults_stay_suspect(self):
        health, clock = ladder()
        for _ in range(4):
            health.note_fault("device-wedged")
            clock["now"] += 11.0  # past the 10s window each time
        assert health.state == SUSPECT

    def test_quiet_window_clears_suspect(self):
        health, clock = ladder()
        health.note_fault("shadow-mismatch")
        health.note_group_ok()
        assert health.state == SUSPECT  # too soon
        clock["now"] += 6.0
        health.note_group_ok()
        assert health.state == HEALTHY

    def test_canary_cycle_recovers_quarantine(self):
        health, clock = ladder()
        for _ in range(3):
            health.note_fault("device-dispatch-error")
        assert health.state == QUARANTINED
        assert health.canary_due()
        assert not health.canary_due()  # interval not elapsed
        health.note_canary(False)       # failed canary resets the streak
        clock["now"] += 1.1
        assert health.canary_due()
        health.note_canary(True)
        assert health.state == QUARANTINED  # needs 2 consecutive
        clock["now"] += 1.1
        assert health.canary_due()
        health.note_canary(True)
        assert health.state == HEALTHY
        targets = [t["to"] for t in health.transitions]
        assert targets == [SUSPECT, QUARANTINED, HEALTHY]
        assert "canary" in health.transitions[-1]["reason"]

    def test_transitions_reach_flight_sink_and_evidence(self, tmp_path):
        health, _ = ladder()
        events = []

        class Flight:
            # mirrors FlightRecorder.record(partition_id, kind, **detail)
            def record(self, partition_id, kind, **fields):
                events.append((partition_id, kind, fields))

        health.flight_sink = (Flight(), 1)
        health.evidence_file = str(tmp_path / "health.jsonl")
        health.note_fault("device-wedged", detail="probe")
        kinds = [k for _pid, k, _f in events]
        assert "device_fault" in kinds
        fault = next(f for _p, k, f in events if k == "device_fault")
        assert fault["faultKind"] == "device-wedged"
        assert "control_adjust" in kinds
        assert "device_health" in kinds
        adjust = next(f for _p, k, f in events if k == "control_adjust")
        assert adjust["controller"] == "device-health"
        assert adjust["before"] == HEALTHY and adjust["after"] == SUSPECT
        lines = [json.loads(line) for line in Path(
            health.evidence_file).read_text().splitlines()]
        assert lines[0]["to"] == SUSPECT

    def test_cfg_binds_from_env(self):
        cfg = defense_cfg_from_env({
            "ZEEBE_BROKER_DEVICE_DISPATCHTIMEOUTMS": "1500",
            "ZEEBE_BROKER_DEVICE_SHADOWSAMPLERATE": "0.5",
            "ZEEBE_BROKER_DEVICE_QUARANTINEFAULTS": "9",
            "ZEEBE_BROKER_DEVICE_CANARYINTERVALMS": "250",
        })
        assert cfg.dispatch_timeout_ms == 1500
        assert cfg.shadow_sample_rate == 0.5
        assert cfg.quarantine_faults == 9
        assert cfg.canary_interval_ms == 250
        # malformed values fall back to defaults, never raise
        cfg = defense_cfg_from_env(
            {"ZEEBE_BROKER_DEVICE_SHADOWSAMPLERATE": "lots"})
        assert cfg.shadow_sample_rate == DeviceDefenseCfg().shadow_sample_rate

    def test_status_block(self):
        health, _ = ladder()
        health.note_shadow_check()
        health.note_shadow_mismatch()
        status = health.status()
        assert status["state"] == SUSPECT
        assert status["shadowChecks"] == 1
        assert status["shadowMismatches"] == 1
        assert status["lastTransition"]["to"] == SUSPECT


class TestChaosCommon:
    def test_member_rng_matches_legacy_derivation(self):
        from zeebe_tpu_torch.testing.chaos_common import member_rng

        legacy = random.Random(9 ^ zlib.crc32(b"worker-2"))
        shared = member_rng(9, "worker-2")
        assert [legacy.random() for _ in range(16)] == \
               [shared.random() for _ in range(16)]

    def test_sum_counts_files_and_ledger_reader(self, tmp_path):
        from zeebe_tpu_torch.testing.chaos_common import (
            read_jsonl_ledgers,
            sum_counts_files,
        )

        (tmp_path / "a.json").write_text(
            json.dumps({"member": "w0", "eio": 2, "torn": 1}))
        (tmp_path / "b.json").write_text(
            json.dumps({"member": "w1", "eio": 3}))
        (tmp_path / "broken.json").write_text("{torn")
        totals = sum_counts_files(sorted(tmp_path.glob("*.json")))
        assert totals == {"eio": 5, "torn": 1}
        ledger = tmp_path / "l.jsonl"
        ledger.write_text('{"kind":"inject","seq":1}\n{"kind":"ca')
        rows = read_jsonl_ledgers([ledger])
        assert rows == [{"kind": "inject", "seq": 1}]  # torn tail skipped

    def test_counts_snapshot_throttles_and_is_atomic(self, tmp_path):
        from zeebe_tpu_torch.testing.chaos_common import CountsSnapshot

        snap = CountsSnapshot("w0")
        snap.counts_file = str(tmp_path / "counts.json")
        snap.maybe_dump({"eio": 1})
        first = json.loads(Path(snap.counts_file).read_text())
        assert first == {"member": "w0", "eio": 1}
        snap.maybe_dump({"eio": 2})  # throttled: unchanged on disk
        assert json.loads(Path(snap.counts_file).read_text()) == first
        snap._last_dump = 0.0
        snap.maybe_dump({"eio": 2})
        assert json.loads(Path(snap.counts_file).read_text())["eio"] == 2


# ---------------------------------------------------------------------------
# the seam on run_group (CPU, plain version)


_TABLES = kb.deploy([W.to_xml(W.mixed_definitions())])
_DT = A.DeviceTables.from_numpy(_TABLES, "cpu")


def group(n: int = 48, seed: int = 0):
    """A fresh mixed-set group of n instances on the CPU (state, I, T)."""
    rng = np.random.default_rng(seed)
    insts = [kb.GroupInstance(idx=i, definition=int(rng.integers(0, _TABLES.num_definitions)),
                              slots={"x": f64_key_planes(float(rng.integers(0, 60)))})
             for i in range(n)]
    arrays, I, T = kb.build_group_arrays(_TABLES, insts, max_group=64)
    return kb.group_state(arrays, "cpu"), I, T


def run(state, I, T, defense=None, chunk_steps=4):
    return kb.run_group(_DT, _TABLES.kernel_config, state, I, T, chunk_steps=chunk_steps,
                        defense=defense)


def same_steps(a: list[dict], b: list[dict]) -> bool:
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b))


def same_state(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


class TestContainment:
    def test_dispatch_exception_is_a_typed_decline(self):
        health = shared_device_health()
        kb.install_device_chaos(DeviceChaosController(
            DeviceFaultPlan(seed=1, dispatch_fail_p=1.0), "t"))
        defense = kb.DeviceDefense()
        state, I, T = group()
        out = run(state, I, T, defense)
        assert out.steps is None and out.fail_reason == "device-dispatch-error"
        assert out.state is state  # the device result is discarded
        assert defense.fallbacks == 1
        assert health.state == SUSPECT
        assert health.faults == {"device-dispatch-error": 1}

    def test_chunk_failure_mid_group_is_a_typed_decline(self):
        kb.install_device_chaos(DeviceChaosController(
            DeviceFaultPlan(seed=1, chunk_fail_p=1.0), "t"))
        defense = kb.DeviceDefense()
        state, I, T = group()
        out = run(state, I, T, defense)
        assert out.fail_reason == "device-dispatch-error" and out.steps is None
        assert shared_device_health().state == SUSPECT

    def test_watchdog_converts_stall_to_typed_wedge(self):
        health = shared_device_health()
        health.cfg.dispatch_timeout_ms = 120
        kb.install_device_chaos(DeviceChaosController(
            DeviceFaultPlan(seed=1, stall_p=1.0, stall_ms=600), "t"))
        defense = kb.DeviceDefense()
        state, I, T = group()
        t0 = time.perf_counter()
        out = run(state, I, T, defense)
        elapsed = time.perf_counter() - t0
        assert out.fail_reason == "device-wedged" and out.steps is None
        assert elapsed < 0.6  # the caller waits the deadline, not the stall
        assert health.state == SUSPECT and health.faults == {"device-wedged": 1}
        # the next group, with the plane gone, runs clean
        kb.install_device_chaos(None)
        clean = run(state, I, T, defense)
        assert clean.fail_reason is None
        assert same_steps(clean.steps, run(state, I, T).steps)

    def test_watchdog_thread_count_flat_across_50_wedges(self):
        """The watchdog reuses a bounded worker pool: 50 seeded wedges leave
        the thread count flat once each wedge resolves, and the pool still
        serves the happy path."""
        rng = random.Random(20)
        baseline = threading.active_count()
        cap = kb._WatchdogPool.MAX_IDLE
        for _ in range(50):
            gate = threading.Event()
            with pytest.raises(kb.DeviceWedgedError):
                kb._watchdog_call(gate.wait, 0.002 + rng.random() * 0.004)
            gate.set()  # un-wedge: the pooled worker must re-idle itself
            deadline = time.time() + 5.0
            while time.time() < deadline:
                with kb._WATCHDOG_POOL._lock:
                    if kb._WATCHDOG_POOL._idle:
                        break
                time.sleep(0.001)
            assert threading.active_count() <= baseline + cap
        assert threading.active_count() <= baseline + cap
        assert kb._watchdog_call(lambda: 42, 1.0) == 42

    def test_wedges_through_run_group_leave_threads_flat(self):
        health = shared_device_health()
        health.cfg.dispatch_timeout_ms = 5
        kb.install_device_chaos(DeviceChaosController(
            DeviceFaultPlan(seed=3, stall_p=1.0, stall_ms=20), "t"))
        defense = kb.DeviceDefense()
        state, I, T = group(8)
        baseline = threading.active_count()
        for _ in range(10):
            assert run(state, I, T, defense).fail_reason == "device-wedged"
            time.sleep(0.03)  # the stall ends; its worker re-idles
        assert threading.active_count() <= baseline + kb._WatchdogPool.MAX_IDLE
        assert defense.fallbacks == 10

    def test_fetch_under_chaos_copies_the_rows(self):
        """On the CPU a chunk's rows are the packed output itself: the seam
        corrupts and keeps a copy, never the original."""
        controller = DeviceChaosController(DeviceFaultPlan(seed=2, corrupt_p=1.0), "t")
        kb.install_device_chaos(controller)
        defense = kb.DeviceDefense()
        state, I, T = group(8)
        chunk = kb._dispatch(_DT, state, 4, _TABLES.kernel_config, A.run_collect)
        before = chunk.rows.clone()
        pg = kb._DeviceRun(_DT, _TABLES.kernel_config, I, T, 4, 64, False, shadow=True)
        flat = defense._fetch_rows(pg, chunk, 0)
        assert controller.counts["corrupt"] == 1
        assert torch.equal(chunk.rows, before)
        assert not np.shares_memory(flat, chunk.rows.numpy())
        assert pg.raw_rows[0] is flat and not np.array_equal(flat, before.numpy())


class TestShadowVerification:
    def test_corruption_caught_before_return(self, tmp_path):
        """Every group corrupt and every group shadowed: every ledger
        injection has a caught line; a shadow catch quarantines the device
        result and returns the host oracle's (the clean run's steps and
        final state), a containment catch declines as no-quiesce or
        overflow."""
        health = shared_device_health()
        health.cfg.shadow_sample_rate = 1.0
        controller = DeviceChaosController(
            DeviceFaultPlan(seed=2, corrupt_p=1.0, flips=4), "t")
        controller.ledger_file = str(tmp_path / "ledger.jsonl")
        defense = kb.DeviceDefense()
        outcomes = []
        for seed in range(6):
            state, I, T = group(24, seed)
            kb.install_device_chaos(None)
            clean = run(state, I, T)
            kb.install_device_chaos(controller)
            assert clean.fail_reason is None
            out = run(state, I, T, defense)
            if out.fail_reason is None:
                assert same_steps(out.steps, clean.steps)
                assert same_state(out.state, clean.state)
                outcomes.append("shadow")
            else:
                assert out.steps is None
                assert out.fail_reason in ("no-quiesce", "token-overflow")
                outcomes.append("contained")
        lines = [json.loads(line) for line in Path(
            controller.ledger_file).read_text().splitlines()]
        injected = {e["seq"] for e in lines if e["kind"] == "inject"}
        caught = {e["seq"] for e in lines if e["kind"] == "caught"}
        assert injected and injected == caught
        assert {e["how"] for e in lines if e["kind"] == "caught"} <= {"shadow", "contained"}
        assert "shadow" in outcomes
        assert defense.shadow_quarantined == outcomes.count("shadow")
        assert defense.fallbacks == outcomes.count("contained")
        assert health.shadow_mismatches >= outcomes.count("shadow")
        assert health.state in (SUSPECT, QUARANTINED)

    def test_clean_groups_verify_without_mismatch(self):
        """Multi-chunk groups at rate 1.0: the oracle, started from host
        copies of the initial arrays, matches every fetched chunk."""
        health = shared_device_health()
        health.cfg.shadow_sample_rate = 1.0
        defense = kb.DeviceDefense()
        for seed in range(3):
            state, I, T = group(48, seed)
            out = run(state, I, T, defense, chunk_steps=2)
            want = run(state, I, T, chunk_steps=2)
            assert out.chunks_run > 1
            assert same_steps(out.steps, want.steps)
            assert same_state(out.state, want.state)
        assert health.shadow_checks == 3
        assert health.shadow_mismatches == 0 and defense.shadow_quarantined == 0
        assert health.state == HEALTHY
        assert defense.shadow_seconds > 0

    def test_drive_group_waves_shadowed(self):
        health = shared_device_health()
        health.cfg.shadow_sample_rate = 1.0
        defense = kb.DeviceDefense()
        rng = np.random.default_rng(1)
        insts = [kb.GroupInstance(idx=i, definition=i % _TABLES.num_definitions,
                                  slots={"x": f64_key_planes(float(rng.integers(0, 60)))})
                 for i in range(32)]
        copy = [kb.GroupInstance(idx=i.idx, definition=i.definition, slots=dict(i.slots))
                for i in insts]
        got = kb.drive_group(_TABLES, _DT, insts, device="cpu", max_group=64,
                             defense=defense)
        want = kb.drive_group(_TABLES, _DT, copy, device="cpu", max_group=64)
        assert got.waves == want.waves and same_state(got.state, want.state)
        assert health.shadow_checks == len(got.waves) > 1
        assert defense.shadow_quarantined == 0

    def test_sampling_rate_zero_never_shadows(self):
        health = shared_device_health()
        health.cfg.shadow_sample_rate = 0.0
        defense = kb.DeviceDefense()
        state, I, T = group(16)
        for _ in range(3):
            assert run(state, I, T, defense).fail_reason is None
        assert health.shadow_checks == 0

    @pytest.mark.parametrize("rate, boost", [(0.4, 8.0), (0.05, 4.0)])
    def test_sampled_stream_is_the_reference_formula(self, rate, boost):
        """One decision per group, deterministic and mixed: the same stream
        as the reference's KernelBackend._shadow_sampled (run on a stub that
        holds what it reads), HEALTHY and then boosted while SUSPECT."""
        from types import SimpleNamespace

        from zeebe_tpu.engine.kernel_backend import KernelBackend

        health = shared_device_health()
        health.cfg.shadow_sample_rate = rate
        health.cfg.shadow_seed = 11
        health.cfg.suspect_shadow_boost = boost
        a, b = kb.DeviceDefense(partition_id=3), kb.DeviceDefense(partition_id=3)
        ref = SimpleNamespace(health=health, shadow_sample_rate=rate, _shadow_seq=0,
                              accounting=SimpleNamespace(partition=3))

        def streams(n):
            return ([a._shadow_sampled() for _ in range(n)],
                    [b._shadow_sampled() for _ in range(n)],
                    [KernelBackend._shadow_sampled(ref) for _ in range(n)])

        healthy, again, want = streams(400)
        assert healthy == again == want
        assert any(healthy) and not all(healthy)
        assert healthy[:64] == [zlib.crc32(f"11:3:{seq}".encode("ascii")) % 1_000_000
                                < rate * 1_000_000 for seq in range(1, 65)]
        health.note_fault("device-wedged")
        assert health.state == SUSPECT
        suspect, again, want = streams(400)
        assert suspect == again == want
        assert sum(suspect) > sum(healthy)
        assert all(suspect) == (rate * boost >= 1.0)

    def test_oracle_failure_declines_the_group(self, monkeypatch):
        health = shared_device_health()
        health.cfg.shadow_sample_rate = 1.0
        defense = kb.DeviceDefense()

        def broken(pg):
            raise RuntimeError("oracle blew up")

        monkeypatch.setattr(defense, "_shadow_execute", broken)
        state, I, T = group(16)
        out = run(state, I, T, defense)
        assert out.fail_reason == "device-dispatch-error" and out.steps is None
        assert defense.fallbacks == 1 and health.state == SUSPECT
