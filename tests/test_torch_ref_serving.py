# tests/test_serving.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Open-loop serving gate: schedule, checker, and gate math
units; the zombie-client messaging seam; the TCP self-delivery fix the
harness surfaced (a worker leading both sides of an inter-partition send
addressed itself, which TCP silently dropped). The full multi-process
harness runs as a slow test and as the CI ``serving-smoke`` gate."""

from __future__ import annotations

import random
import time

import pytest

from zeebe_tpu_torch.testing.evidence import percentile
from zeebe_tpu_torch.testing.serving import (
    ServingConfig,
    ServingOp,
    TenantSpec,
    build_schedule,
    check_serving_history,
    evaluate_gates,
    poisson_schedule,
    tenant_rate_fn,
)


class TestPercentile:
    def test_nearest_rank(self):
        values = list(range(1, 101))
        assert percentile(values, 0.50) == 50
        assert percentile(values, 0.99) == 99
        assert percentile(values, 1.0) == 100
        assert percentile([42.0], 0.99) == 42.0
        assert percentile([], 0.99) == 0.0


class TestSchedule:
    def test_deterministic_for_seed(self):
        cfg = ServingConfig(seed=3, device="cpu")
        assert build_schedule(cfg) == build_schedule(ServingConfig(seed=3, device="cpu"))
        assert build_schedule(cfg) != build_schedule(ServingConfig(seed=4, device="cpu"))

    def test_rates_approximate_the_spec(self):
        rng = random.Random(1)
        arrivals = poisson_schedule(rng, 200.0, lambda t: 10.0, 10.0)
        assert 8.0 < len(arrivals) / 200.0 < 12.0
        assert arrivals == sorted(arrivals)
        assert all(0 <= t < 200.0 for t in arrivals)

    def test_diurnal_ramp_shape(self):
        spec = TenantSpec("t", "hot", rate_a=5.0, rate_bc=50.0, quota_rate=8.0)
        rate = tenant_rate_fn(spec, phase_a_s=10.0, ramp_s=4.0)
        assert rate(0.0) == 5.0
        assert rate(9.9) == 5.0
        assert 5.0 < rate(11.0) < 50.0      # mid-ramp
        assert rate(14.0) == 50.0
        assert rate(100.0) == 50.0

    def test_open_loop_offered_load_is_fixed_per_phase(self):
        cfg = ServingConfig(seed=0, device="cpu")
        sched = build_schedule(cfg)
        hot = [t for t, name in sched if name == "t-hot"]
        a_rate = sum(1 for t in hot if t < cfg.phase_a_seconds) \
            / cfg.phase_a_seconds
        c_start = cfg.phase_a_seconds + cfg.phase_b_seconds
        c_rate = sum(1 for t in hot if t >= c_start) / cfg.phase_c_seconds
        assert a_rate < 12.0            # calm: ~6/s
        assert c_rate > 25.0            # overload: ~40/s — 5x the 8/s quota


def _op(index, tenant, outcome, scheduled_ms, latency_ms, partition=1,
        rid=-1, position=-1, kind="create", shed_reason=None):
    return ServingOp(index=index, tenant=tenant, kind=kind,
                     partition=partition, scheduled_ms=scheduled_ms,
                     started_ms=scheduled_ms,
                     done_ms=scheduled_ms + latency_ms, outcome=outcome,
                     request_id=rid, position=position,
                     shed_reason=shed_reason)


class TestCheckServingHistory:
    def _log(self, rid, position, rt=1):
        return {"p": position, "rt": rt, "rid": rid}

    def test_clean_history_passes(self):
        from zeebe_tpu_torch.protocol import RecordType

        history = [_op(1, "t", "ack", 0, 5, rid=10, position=3)]
        logs = {1: [{"p": 3, "rt": int(RecordType.COMMAND), "rid": 10}]}
        assert check_serving_history(history, logs) == []

    def test_acked_loss_detected(self):
        history = [_op(1, "t", "ack", 0, 5, rid=10, position=3)]
        violations = check_serving_history(history, {1: []})
        assert violations and "acked loss" in violations[0]

    def test_duplicate_application_detected(self):
        from zeebe_tpu_torch.protocol import RecordType

        rt = int(RecordType.COMMAND)
        logs = {1: [{"p": 3, "rt": rt, "rid": 10},
                    {"p": 9, "rt": rt, "rid": 10}]}
        violations = check_serving_history([], logs)
        assert violations and "duplicate application" in violations[0]

    def test_unacked_ops_claim_nothing(self):
        history = [_op(1, "t", "shed", 0, 1, rid=11),
                   _op(2, "t", "deadline", 0, 1, rid=12)]
        assert check_serving_history(history, {1: []}) == []


class _GateCfg(ServingConfig):
    pass


def _gate_cfg() -> ServingConfig:
    return ServingConfig(
        phase_a_seconds=10.0, phase_b_seconds=10.0, phase_c_seconds=10.0,
        slo_p50_ms=500.0, slo_p99_ms=2000.0, fairness_mult=4.0,
        fairness_floor_ms=400.0, goodput_floor=0.7, shed_fast_ms=300.0,
        tenants=[
            TenantSpec("t-well-0", "well", 10.0, 10.0, quota_rate=20.0),
            TenantSpec("t-hot", "hot", 5.0, 40.0, quota_rate=8.0,
                       quota_burst=16.0),
        ], device="cpu")


def _baseline_history(well_lat=50.0, overload_lat=None, chaos_lat=None,
                      hot_sheds=True, shed_lat=5.0,
                      chaos_count=100) -> list[ServingOp]:
    """100 well acks per phase + hot tenant at quota with sheds in B/C."""
    overload_lat = well_lat if overload_lat is None else overload_lat
    chaos_lat = overload_lat if chaos_lat is None else chaos_lat
    ops = []
    i = 0
    for phase_start, lat, count in ((0.0, well_lat, 100),
                                    (10_000.0, overload_lat, 100),
                                    (20_000.0, chaos_lat, chaos_count)):
        for k in range(count):
            i += 1
            ops.append(_op(i, "t-well-0", "ack",
                           phase_start + k * 9000.0 / max(count, 1), lat))
    for phase_start in (10_000.0, 20_000.0):
        for k in range(80):
            i += 1
            ops.append(_op(i, "t-hot", "ack", phase_start + k * 110.0, 20.0))
        if hot_sheds:
            for k in range(240):
                i += 1
                ops.append(_op(i, "t-hot", "shed", phase_start + k * 40.0,
                               shed_lat, shed_reason="tenant-quota"))
    return ops


class TestEvaluateGates:
    def test_clean_run_passes_every_gate(self):
        report, violations = evaluate_gates(_baseline_history(), _gate_cfg())
        assert violations == []
        assert report["fairness"]["overloadP99Ms"] <= \
            report["fairness"]["boundMs"]
        assert report["goodput"]["chaosAckedPerSec"] > 0

    def test_slo_violation(self):
        report, violations = evaluate_gates(
            _baseline_history(overload_lat=3000.0, chaos_lat=3000.0),
            _gate_cfg())
        assert any("SLO" in v for v in violations)

    def test_fairness_violation_isolates_overload_phase(self):
        # overload phase p99 blows the 4x bound; calm phase is fast
        report, violations = evaluate_gates(
            _baseline_history(well_lat=50.0, overload_lat=800.0,
                              chaos_lat=100.0), _gate_cfg())
        assert any("fairness" in v for v in violations)
        # chaos-phase latency alone must NOT trip the fairness gate (the
        # kill is the SLO/goodput gates' business)
        report, violations = evaluate_gates(
            _baseline_history(well_lat=50.0, overload_lat=100.0,
                              chaos_lat=1500.0), _gate_cfg())
        assert not any("fairness" in v for v in violations)

    def test_hot_tenant_must_be_shed(self):
        report, violations = evaluate_gates(
            _baseline_history(hot_sheds=False), _gate_cfg())
        assert any("never shed" in v for v in violations)

    def test_slow_sheds_flagged(self):
        report, violations = evaluate_gates(
            _baseline_history(shed_lat=2500.0), _gate_cfg())
        assert any("sheds are slow" in v for v in violations)

    def test_goodput_collapse_flagged(self):
        report, violations = evaluate_gates(
            _baseline_history(chaos_count=20), _gate_cfg())
        assert any("goodput" in v for v in violations)

    def test_pending_ops_are_silent_drops(self):
        history = _baseline_history()
        history.append(_op(9999, "t-well-0", "pending", 15_000.0, 0.0))
        report, violations = evaluate_gates(history, _gate_cfg())
        assert any("silent drop" in v for v in violations)


# ---------------------------------------------------------------------------
# zombie-client protection (satellite: slow-client chaos seam)


class TestZombieClient:
    def test_overflow_disconnects_and_never_blocks_the_sender(self):
        from zeebe_tpu_torch.cluster.messaging import TcpMessagingService
        from zeebe_tpu_torch.testing.chaos_tcp import ZombiePeer
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        zombie = ZombiePeer(recv_buffer=4096)
        svc = TcpMessagingService("a", ("127.0.0.1", 0),
                                  {"zombie": zombie.address})
        svc.max_outbound_buffer_bytes = 256 * 1024
        svc.start()
        try:
            payload = {"blob": "x" * 65536}
            svc.send("zombie", "t", payload)
            time.sleep(0.3)                  # let the first connection cache
            t0 = time.perf_counter()
            for _ in range(200):
                svc.send("zombie", "t", payload)
            elapsed = time.perf_counter() - t0
            # the pump-side send path must never block on a dead reader
            assert elapsed < 2.0
            deadline = time.time() + 5.0
            while time.time() < deadline \
                    and svc.stream_overflow_disconnects == 0:
                time.sleep(0.05)
            assert svc.stream_overflow_disconnects >= 1
            assert zombie.accepted >= 1
            exposed = REGISTRY.expose()
            assert "messaging_stream_overflow_disconnects_total" in exposed
        finally:
            svc.stop()
            zombie.close()

    def test_healthy_peer_uncapped(self):
        from zeebe_tpu_torch.cluster.messaging import TcpMessagingService
        from zeebe_tpu_torch.standalone import _free_ports

        (port,) = _free_ports(1)
        received = []
        b = TcpMessagingService("b", ("127.0.0.1", port), {})
        b.subscribe("t", lambda sender, payload: received.append(payload))
        b.start()
        a = TcpMessagingService("a", ("127.0.0.1", 0),
                                {"b": ("127.0.0.1", port)})
        a.start()
        try:
            for i in range(50):
                a.send("b", "t", {"i": i})
            deadline = time.time() + 5.0
            while time.time() < deadline and len(received) < 50:
                b.poll()
                time.sleep(0.01)
            assert len(received) == 50
            assert a.stream_overflow_disconnects == 0
        finally:
            a.stop()
            b.stop()


class TestTcpSelfDelivery:
    def test_send_to_self_lands_in_own_inbox(self):
        """A worker leading both sides of an inter-partition send addresses
        itself; TCP must deliver locally (the loopback semantics), not drop
        — cross-partition deployment distribution stalled on exactly this
        whenever two leaderships landed on one worker."""
        from zeebe_tpu_torch.cluster.messaging import TcpMessagingService

        svc = TcpMessagingService("a", ("127.0.0.1", 0), {})
        got = []
        svc.subscribe("inter-partition-2", lambda s, p: got.append((s, p)))
        # no start(): self-delivery must not depend on the IO loop at all
        svc.send("a", "inter-partition-2", {"k": 1})
        assert svc.poll() == 1
        assert got == [("a", {"k": 1})]


# ---------------------------------------------------------------------------
# the full harness (slow; CI runs it via `bench.py --serving --quick`)


@pytest.mark.slow
class TestServingHarness:
    def test_quick_profile_end_to_end(self, tmp_path):
        from zeebe_tpu_torch.testing.serving import run_serving

        cfg = ServingConfig(
            workers=2, partitions=1, replication=2, client_streams=32,
            phase_a_seconds=4.0, phase_b_seconds=4.0, phase_c_seconds=5.0,
            ramp_seconds=1.0, parked_instances=40, storm_publishes=15,
            park_wait_s=20.0, kill_workers=1,
            tenants=[
                TenantSpec("t-well-0", "well", 6.0, 6.0, quota_rate=20.0),
                TenantSpec("t-hot", "hot", 4.0, 25.0, quota_rate=5.0,
                           quota_burst=10.0),
            ], device="cpu")
        report = run_serving(cfg, tmp_path)
        assert report["requests"] > 50
        assert report["shedCommands"] > 0          # the hot tenant was shed
        assert report["admission"]["tenants"]["t-hot"]["shed"] > 0
        # exactly-once evidence must hold even when latency gates flake on
        # a loaded box: no acked loss, no duplicate application
        hard = [v for v in report["violations"]
                if "acked loss" in v or "duplicate application" in v
                or "silent drop" in v]
        assert hard == [], hard
