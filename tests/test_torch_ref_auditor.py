# tests/test_auditor.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Fleet auditor tests: trend leak detection, multi-window SLO
burn rates, the alerts.py layering, the cluster-side CRC/monotonicity
joins, and the fleet-day gate's pure helpers — all seeded + fake-clock,
no wall time anywhere."""

from __future__ import annotations

import random

import pytest

from zeebe_tpu_torch.observability.auditor import (
    AuditorCfg,
    BrokerAuditor,
    BurnRateTracker,
    ClusterAuditor,
    TrendDetector,
    burn_rate_rules,
    least_squares_slope,
)


class TestLeastSquaresSlope:
    def test_perfect_line_huge_confidence(self):
        slope, tstat = least_squares_slope([(t, 3.0 * t + 7.0)
                                            for t in range(10)])
        assert slope == pytest.approx(3.0)
        assert tstat >= 1e9 - 1

    def test_constant_series_zero_slope_zero_confidence(self):
        slope, tstat = least_squares_slope([(t, 42.0) for t in range(10)])
        assert slope == 0.0 and tstat == 0.0

    def test_too_few_points(self):
        assert least_squares_slope([(0, 1.0), (1, 2.0)]) == (0.0, 0.0)

    def test_noisy_flat_low_tstat(self):
        rng = random.Random(20)
        pts = [(float(t), 100.0 + rng.gauss(0.0, 5.0)) for t in range(60)]
        _, tstat = least_squares_slope(pts)
        assert abs(tstat) < 4.0


def drive(det: TrendDetector, value_fn, seconds: int, tick_ms: int = 500,
          t0_ms: int = 0) -> list[str]:
    """Feed a fake-clock series; returns the sequence of verdict states."""
    states = []
    for i in range(seconds * 1000 // tick_ms):
        t = t0_ms + i * tick_ms
        det.observe(t, value_fn(t))
        states.append(det.verdict()["state"])
    return states


class TestTrendDetector:
    WINDOW_MS = 20_000

    def make(self, **kw) -> TrendDetector:
        args = {"min_samples": 10, "tstat": 8.0, "min_growth": 0.05}
        args.update(kw)
        return TrendDetector(self.WINDOW_MS, **args)

    def test_linear_leak_fires(self):
        rng = random.Random(1)
        det = self.make()
        states = drive(det, lambda t: 100.0 + 2.0 * (t / 1000.0)
                       + rng.gauss(0.0, 0.5), seconds=30)
        assert states[-1] == "leak"
        assert det.last["slopePerSec"] == pytest.approx(2.0, abs=0.2)

    def test_flat_noise_stays_quiet(self):
        rng = random.Random(2)
        det = self.make()
        states = drive(det, lambda t: 100.0 + rng.gauss(0.0, 3.0),
                       seconds=30)
        assert "leak" not in states
        assert states[-1] == "quiet"

    def test_step_is_not_a_leak(self):
        # a one-off step (cache warm, new tenant onboarded): the later
        # half-window is flat, which vetoes the leak verdict
        rng = random.Random(3)
        det = self.make()
        states = drive(det, lambda t: (200.0 if t >= 8_000 else 100.0)
                       + rng.gauss(0.0, 0.5), seconds=40)
        assert "leak" not in states

    def test_sawtooth_stays_quiet(self):
        # periodic reclaim (GC, compaction): climbs then drops, never leaks
        det = self.make()
        states = drive(det, lambda t: 100.0 + (t % 5_000) / 100.0,
                       seconds=40)
        assert "leak" not in states

    def test_insufficient_until_samples_and_span(self):
        det = self.make(min_samples=10)
        for i in range(9):
            det.observe(i * 100, 100.0 + i)
            assert det.verdict()["state"] == "insufficient"  # < min samples
        det.observe(900, 110.0)
        # 10 samples but only 0.9s of span (< half the 20s window)
        assert det.verdict()["state"] == "insufficient"

    def test_window_prunes_old_samples(self):
        det = self.make()
        drive(det, lambda t: 100.0, seconds=60)
        assert det.verdict()["spanMs"] <= self.WINDOW_MS

    def test_deterministic_per_seed(self):
        def run():
            rng = random.Random(7)
            det = self.make()
            return drive(det, lambda t: 100.0 + rng.gauss(0.0, 2.0),
                         seconds=20)
        assert run() == run()

    def test_min_growth_keeps_microscopic_drift_quiet(self):
        # statistically perfect but tiny: +0.01/s on a base of 10_000 is
        # 0.002% growth per window — not a leak worth paging for
        det = self.make()
        states = drive(det, lambda t: 10_000.0 + 0.01 * (t / 1000.0),
                       seconds=30)
        assert "leak" not in states


class TestBurnRateTracker:
    def make(self) -> BurnRateTracker:
        return BurnRateTracker(fast_window_ms=10_000, slow_window_ms=40_000,
                               slo_target=0.999, page_burn=14.4,
                               ticket_burn=6.0)

    def test_all_good_is_ok(self):
        tr = self.make()
        for s in range(60):
            tr.observe(s * 1000, good=10.0, bad=0.0)
        out = tr.evaluate(59_000)
        assert out == {"fast": 0.0, "slow": 0.0, "state": "ok"}

    def test_sustained_burn_pages_both_windows(self):
        tr = self.make()
        # 5% bad = 50x the 0.1% budget, sustained past the slow window
        for s in range(60):
            tr.observe(s * 1000, good=95.0, bad=5.0)
        out = tr.evaluate(59_000)
        assert out["state"] == "page"
        assert out["fast"] == pytest.approx(50.0, rel=0.01)
        assert out["slow"] == pytest.approx(50.0, rel=0.01)

    def test_transient_burst_does_not_page(self):
        # 2s of 100% errors inside an otherwise clean 60s: the fast window
        # breaches the page threshold but the slow window stays under it —
        # the both-windows condition vetoes the page (a 1% budget keeps the
        # arithmetic in range; a 0.1% budget pages on almost any real blip)
        tr = BurnRateTracker(fast_window_ms=10_000, slow_window_ms=40_000,
                             slo_target=0.99, page_burn=14.4,
                             ticket_burn=6.0)
        for s in range(60):
            bad = 10.0 if 50 <= s < 52 else 0.0
            tr.observe(s * 1000, good=10.0 - bad, bad=bad)
        out = tr.evaluate(59_000)
        assert out["fast"] > 14.4         # the fast window is screaming
        assert out["slow"] < 6.0          # the slow window shrugs
        assert out["state"] == "ok"       # both-windows vetoes the page

    def test_fast_window_clears_quickly_after_recovery(self):
        tr = self.make()
        for s in range(40):
            tr.observe(s * 1000, good=0.0, bad=10.0)   # total outage
        assert tr.evaluate(39_000)["state"] == "page"
        for s in range(40, 55):
            tr.observe(s * 1000, good=10.0, bad=0.0)   # recovered
        out = tr.evaluate(54_000)
        # fast window is clean -> page condition (BOTH windows) released
        assert out["fast"] == 0.0
        assert out["state"] == "ok"

    def test_empty_windows_rate_zero(self):
        assert self.make().evaluate(1_000) == {
            "fast": 0.0, "slow": 0.0, "state": "ok"}


class TestBurnRateAlertRules:
    def test_rules_layer_onto_alert_evaluator(self):
        from zeebe_tpu_torch.observability.alerts import AlertEvaluator
        from zeebe_tpu_torch.observability.timeseries import TimeSeriesStore

        cfg = AuditorCfg()
        store = TimeSeriesStore()
        ev = AlertEvaluator(store, [], node_id="n0")
        ev.add_rules(burn_rate_rules("n0", cfg))
        labels = '{node="n0",slo="admission",window="both"}'
        # sustained page-level burn: fires after the 2s for-duration
        store.append("zeebe_audit_burn_rate", labels, "gauge", 1_000, 50.0)
        ev.evaluate(1_000)
        assert not ev.firing()
        store.append("zeebe_audit_burn_rate", labels, "gauge", 4_000, 50.0)
        ev.evaluate(4_000)
        rules = {a["rule"] for a in ev.firing()}
        assert "slo_burn_page" in rules
        # recovery clears
        store.append("zeebe_audit_burn_rate", labels, "gauge", 5_000, 0.0)
        ev.evaluate(5_000)
        assert not ev.firing()

    def test_ticket_burn_does_not_page(self):
        from zeebe_tpu_torch.observability.alerts import AlertEvaluator
        from zeebe_tpu_torch.observability.timeseries import TimeSeriesStore

        store = TimeSeriesStore()
        ev = AlertEvaluator(store, [], node_id="n0")
        ev.add_rules(burn_rate_rules("n0", AuditorCfg()))
        labels = '{node="n0",slo="admission",window="both"}'
        for t in range(0, 12_000, 1_000):
            store.append("zeebe_audit_burn_rate", labels, "gauge", t, 8.0)
            ev.evaluate(t)
        rules = {a["rule"] for a in ev.firing()}
        assert rules == {"slo_burn_ticket"}

    def test_severity_rides_the_rule(self):
        page, ticket = burn_rate_rules("n0", AuditorCfg())
        assert page.severity == "page" and ticket.severity == "ticket"


class TestClusterAuditor:
    def row(self, crc=None, partitions=None, worker_pid=1, audit_extra=None):
        audit = {"crc": crc or {}, "alerts": [], "leakVerdict": "clean",
                 "violations": 0, "burn": {"state": "ok"}}
        audit.update(audit_extra or {})
        return {"workerPid": worker_pid, "audit": audit,
                "partitions": partitions or {}}

    def test_crc_agreement_is_quiet(self):
        ca = ClusterAuditor()
        rows = {w: self.row(crc={"1": [[3, 0xAB], [4, 0xCD]]})
                for w in ("w0", "w1", "w2")}
        assert ca.ingest(rows) == []
        assert ca.snapshot()["crcWindowsCompared"] == 2

    def test_crc_disagreement_flags_once(self):
        ca = ClusterAuditor()
        fresh = ca.ingest({"w0": self.row(crc={"1": [[3, 0xAB]]}),
                           "w1": self.row(crc={"1": [[3, 0xEE]]})})
        assert [v["monitor"] for v in fresh] == ["replica_crc"]
        assert "window 3" in fresh[0]["message"]
        # same rows again: latched, not re-flagged
        assert ca.ingest({"w0": self.row(crc={"1": [[3, 0xAB]]}),
                          "w1": self.row(crc={"1": [[3, 0xEE]]})}) == []

    def test_push_position_regression_flags(self):
        ca = ClusterAuditor()
        ca.ingest({"w0": self.row(partitions={"1": {"lastPosition": 100}})})
        fresh = ca.ingest(
            {"w0": self.row(partitions={"1": {"lastPosition": 60}})})
        assert [v["monitor"] for v in fresh] == ["acked_position"]

    def test_restarted_worker_life_resets_position_baseline(self):
        # a restarted worker (new pid) legitimately re-pushes from replay
        ca = ClusterAuditor()
        ca.ingest({"w0": self.row(worker_pid=10,
                                  partitions={"1": {"lastPosition": 100}})})
        assert ca.ingest(
            {"w0": self.row(worker_pid=11,
                            partitions={"1": {"lastPosition": 5}})}) == []

    def test_flagged_monitors_merge_worker_alerts_and_leaks(self):
        ca = ClusterAuditor()
        ca.ingest({"w0": self.row(audit_extra={
            "alerts": [{"monitor": "exporter_sequence", "message": "gap"}],
            "leakVerdict": "leak"})})
        assert {"exporter_sequence",
                "resource_leak"} <= ca.flagged_monitors()


class TestFleetDayHelpers:
    def test_incident_windows_and_membership(self):
        from zeebe_tpu_torch.testing.fleetday import (
            incident_windows,
            outside_incidents,
        )

        w = incident_windows([{"atMs": 1_000.0, "action": "restart"},
                              {"atMs": 9_000.0, "action": "churn"}],
                             grace_ms=5_000.0)
        assert w == [(1_000.0, 6_000.0)]
        assert not outside_incidents(3_000.0, w)
        assert outside_incidents(6_500.0, w)

    def test_slo_excludes_incident_scheduled_requests(self):
        from zeebe_tpu_torch.testing.fleetday import (
            FleetDayConfig,
            evaluate_fleet_slo,
        )
        from zeebe_tpu_torch.testing.serving import ServingOp

        cfg = FleetDayConfig(device="cpu")
        ops = []
        for i in range(100):
            op = ServingOp(index=i, tenant="t", kind="create", partition=1,
                           scheduled_ms=float(i * 100))
            op.outcome = "ack"
            # requests scheduled inside [2s, 4s] were slow (the incident)
            slow = 2_000 <= op.scheduled_ms <= 4_000
            op.done_ms = op.scheduled_ms + (9_999.0 if slow else 50.0)
            ops.append(op)
        # without a declared window the slow tail breaches p99
        _, violations = evaluate_fleet_slo(ops, [], cfg)
        assert any("p99" in v for v in violations)
        # with the incident declared, the survivors meet the SLO
        report, violations = evaluate_fleet_slo(
            ops, [(2_000.0, 4_000.0)], cfg)
        assert violations == []
        assert report["requestsOutsideIncidents"] == 79

    def test_pending_requests_are_silent_drops(self):
        from zeebe_tpu_torch.testing.fleetday import (
            FleetDayConfig,
            evaluate_fleet_slo,
        )
        from zeebe_tpu_torch.testing.serving import ServingOp

        ops = []
        for i in range(50):
            op = ServingOp(index=i, tenant="t", kind="create", partition=1,
                           scheduled_ms=float(i * 100))
            op.outcome = "ack" if i else "pending"
            op.done_ms = op.scheduled_ms + 50.0
            ops.append(op)
        _, violations = evaluate_fleet_slo(ops, [], FleetDayConfig(device="cpu"))
        assert any("terminal" in v for v in violations)

    def test_auditor_recall_miss_and_hit(self):
        from zeebe_tpu_torch.testing.fleetday import check_auditor_recall

        offline = ["partition 1: acked loss of request 17",
                   "export stream gap at position 40"]
        misses, stats = check_auditor_recall(offline, {"acked_position"})
        assert len(misses) == 1 and "exporter_sequence" in misses[0]
        assert stats["recallPct"] == 50.0
        misses, stats = check_auditor_recall(
            offline, {"acked_position", "exporter_sequence"})
        assert misses == [] and stats["recallPct"] == 100.0

    def test_recall_vacuous_at_zero_and_ignores_unmapped(self):
        from zeebe_tpu_torch.testing.fleetday import check_auditor_recall

        _, stats = check_auditor_recall([], set())
        assert stats["recallPct"] == 100.0
        misses, stats = check_auditor_recall(
            ["harness never booted"], set())
        assert misses == [] and stats["unmapped"] == 1


class TestBrokerAuditorInCluster:
    """The auditor riding a real (in-process) broker's sampler tick."""

    def _cluster(self, **kw):
        from zeebe_tpu_torch.broker import InProcessCluster

        broker_count = kw.pop("broker_count", 1)
        return InProcessCluster(broker_count=broker_count,
                                partition_count=1,
                                replication_factor=broker_count, **kw, device="cpu")

    def test_audit_block_rides_broker_status(self):
        import torch_kernel_flows; torch_kernel_flows.port_module("test_broker_cluster"); from _kflows_zeebe_tpu_torch_test_broker_cluster import (
            create_cmd,
            deploy_cmd,
            one_task,
        )
        from zeebe_tpu_torch.broker.management import broker_status

        c = self._cluster()
        try:
            c.await_leaders()
            c.write_command(1, deploy_cmd(one_task()))
            for _ in range(5):
                c.write_command(1, create_cmd())
            c.run(3_000)
            broker = c.brokers["broker-0"]
            assert broker.auditor is not None
            audit = broker_status(broker)["audit"]
            assert audit["enabled"] is True
            assert audit["violations"] == 0
            assert audit["leakVerdict"] == "clean"
            assert audit["burn"]["state"] == "ok"
            # burn-rate rules were layered onto the broker's evaluator
            rules = {r.name for r in broker.alerts.rules}
            assert {"slo_burn_page", "slo_burn_ticket"} <= rules
        finally:
            c.close()

    def test_replica_crc_checkpoints_agree_across_brokers(self):
        import torch_kernel_flows; torch_kernel_flows.port_module("test_broker_cluster"); from _kflows_zeebe_tpu_torch_test_broker_cluster import (
            create_cmd,
            deploy_cmd,
            one_task,
        )

        c = self._cluster(broker_count=3)
        try:
            for b in c.brokers.values():
                b.auditor.cfg.crc_window = 8
            c.await_leaders()
            c.write_command(1, deploy_cmd(one_task()))
            for _ in range(30):
                c.write_command(1, create_cmd())
            c.run(5_000)
            rings = {name: list(b.auditor.crc_checkpoints.get(1, ()))
                     for name, b in c.brokers.items()}
            # every broker finalized checkpoints, and the shared windows
            # agree byte-for-byte (the cross-replica CRC invariant)
            assert all(rings.values()), rings
            by_window: dict[int, set[int]] = {}
            for ring in rings.values():
                for window, crc in ring:
                    by_window.setdefault(window, set()).add(crc)
            shared = {w: crcs for w, crcs in by_window.items()
                      if sum(1 for r in rings.values()
                             if any(x[0] == w for x in r)) > 1}
            assert shared, by_window
            assert all(len(crcs) == 1 for crcs in shared.values()), shared
            # and the ClusterAuditor join over the same evidence is quiet
            ca = ClusterAuditor()
            rows = {name: {"workerPid": 1, "partitions": {},
                           "audit": b.auditor.snapshot()}
                    for name, b in c.brokers.items()}
            assert ca.ingest(rows) == []
            assert ca.snapshot()["crcWindowsCompared"] > 0
        finally:
            c.close()

    def test_seeded_leak_fires_via_broker_trends(self):
        # drive the broker's own fd trend with a synthetic monotone series
        # (fake clock, no real fds): the verdict must latch the violation
        c = self._cluster()
        try:
            c.await_leaders()
            auditor = c.brokers["broker-0"].auditor
            auditor.cfg.leak_min_growth = 0.05
            det = auditor._trend("fd_count")
            det.min_samples = 10
            det.window_ms = 10_000
            for i in range(40):
                det.observe(i * 500, 100.0 + 5.0 * i)
            assert det.verdict()["state"] == "leak"
        finally:
            c.close()


class TestTopAuditSection:
    def test_render_top_shows_audit_rows(self):
        from zeebe_tpu_torch.cli import _render_top

        status = {
            "clusterSize": 1,
            "partitionsCount": 1,
            "health": "healthy",
            "brokers": [{
                "nodeId": "broker-0",
                "health": "healthy",
                "partitions": {},
                "audit": {
                    "enabled": True,
                    "violations": 2,
                    "burn": {"fast": 3.25, "slow": 0.5, "state": "ok"},
                    "leaks": {
                        "rss_bytes": {"state": "leak", "slopePerSec": 9.0},
                        "fd_count": {"state": "quiet", "slopePerSec": 0.0},
                    },
                    "leakVerdict": "leak",
                },
            }],
        }
        frame = _render_top(status)
        assert "AUDIT" in frame
        audit_line = next(
            line for line in frame.splitlines()
            if line.startswith("broker-0") and "leak" in line)
        assert "3.25" in audit_line
        assert "rss_bytes:leak" in audit_line
        # quiet series stay out of the TRENDING column
        assert "fd_count" not in audit_line

    def test_render_top_no_audit_block_no_section(self):
        from zeebe_tpu_torch.cli import _render_top

        frame = _render_top({"brokers": [{"nodeId": "b0", "partitions": {}}]})
        assert "AUDIT" not in frame
