# tests/test_admission.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Tenant-aware admission + cooperative load shedding.

Unit coverage for the DAGOR-shaped controller (priority ladder, token
buckets, weighted-fair in-flight share, shed-ladder hysteresis, /ready
drain), loopback integration through the multi-process gateway protocol
(gateway-side AND worker-side sheds surface as typed RESOURCE_EXHAUSTED),
and the backpressure satellite: whitelisted intents still count against
in-flight accounting, and the AIMD/Vegas limiters hold their [min, max]
invariant under fuzzed RTT traces and recover after a timeout storm.
"""

from __future__ import annotations

import random
import threading
import time

import pytest

from zeebe_tpu_torch.broker.backpressure import AimdLimit, CommandRateLimiter, VegasLimit
from zeebe_tpu_torch.gateway.admission import (
    MAX_SHED_LEVEL,
    PRIORITY_COMPLETION,
    PRIORITY_CONTINUATION,
    PRIORITY_CREATE,
    PRIORITY_QUERY,
    AdmissionCfg,
    AdmissionController,
    TokenBucket,
    priority_of,
    tenant_of,
)
from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
from zeebe_tpu_torch.protocol import ValueType
from zeebe_tpu_torch.protocol.intent import (
    DeploymentIntent,
    IncidentIntent,
    JobBatchIntent,
    JobIntent,
    MessageIntent,
    ProcessInstanceCreationIntent,
    TimerIntent,
)
from zeebe_tpu_torch.protocol.record import command


def create_cmd(tenant: str | None = None, stream_id: int = 0):
    value = {"bpmnProcessId": "p", "version": -1, "variables": {}}
    if tenant is not None:
        value["tenantId"] = tenant
    return command(ValueType.PROCESS_INSTANCE_CREATION,
                   ProcessInstanceCreationIntent.CREATE,
                   value).replace(request_stream_id=stream_id)


def complete_cmd(tenant: str | None = None):
    value = {"jobKey": 1, "variables": {}}
    if tenant is not None:
        value["tenantId"] = tenant
    return command(ValueType.JOB, JobIntent.COMPLETE, value)


# ---------------------------------------------------------------------------
# priority ladder + tenant extraction


class TestPriorityLadder:
    def test_completions_are_rung_zero(self):
        assert priority_of(complete_cmd()) == PRIORITY_COMPLETION
        assert priority_of(command(ValueType.JOB, JobIntent.FAIL,
                                   {})) == PRIORITY_COMPLETION

    def test_continuations(self):
        assert priority_of(command(ValueType.MESSAGE, MessageIntent.PUBLISH,
                                   {})) == PRIORITY_CONTINUATION
        assert priority_of(command(ValueType.JOB_BATCH, JobBatchIntent.ACTIVATE,
                                   {})) == PRIORITY_CONTINUATION
        assert priority_of(command(ValueType.INCIDENT, IncidentIntent.RESOLVE,
                                   {})) == PRIORITY_CONTINUATION
        # a non-whitelist JOB command (retries update) is a continuation,
        # not a completion
        assert priority_of(command(ValueType.JOB, JobIntent.UPDATE_RETRIES,
                                   {})) == PRIORITY_CONTINUATION

    def test_new_work(self):
        assert priority_of(create_cmd()) == PRIORITY_CREATE
        assert priority_of(command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE,
                                   {})) == PRIORITY_CREATE

    def test_unclassified_is_query_rung(self):
        assert priority_of(command(ValueType.TIMER, TimerIntent.TRIGGER,
                                   {})) == PRIORITY_QUERY

    def test_tenant_from_metadata_with_stream_fallback(self):
        assert tenant_of(create_cmd("t-a")) == "t-a"
        assert tenant_of(create_cmd(stream_id=7)) == "stream-7"
        # empty tenantId falls back too (no tenant collapses into "")
        rec = create_cmd().replace(request_stream_id=3)
        assert tenant_of(rec) == "stream-3"


class TestTokenBucket:
    def test_refill_and_burst(self):
        bucket = TokenBucket(rate=10.0, burst=5.0, now_ms=0.0)
        assert all(bucket.try_take(0.0) for _ in range(5))
        assert not bucket.try_take(0.0)          # burst exhausted
        assert bucket.try_take(100.0)            # 0.1s x 10/s = 1 token
        assert not bucket.try_take(100.0)
        # a long idle period refills only to the burst cap
        for _ in range(5):
            assert bucket.try_take(60_000.0)
        assert not bucket.try_take(60_000.0)

    def test_zero_rate_is_unmetered(self):
        bucket = TokenBucket(rate=0.0, burst=1.0, now_ms=0.0)
        assert all(bucket.try_take(0.0) for _ in range(1000))


# ---------------------------------------------------------------------------
# the controller


def controller(clock, **cfg_kw) -> AdmissionController:
    return AdmissionController(AdmissionCfg(**cfg_kw), node_id="test-gw",
                               clock_millis=lambda: clock[0])


class TestAdmissionController:
    def test_hot_tenant_saturates_its_own_bucket_only(self):
        clock = [0.0]
        ctl = controller(clock, quotas={"t-hot": (2.0, 2.0)})
        hot, well = create_cmd("t-hot"), create_cmd("t-well")
        assert ctl.try_admit(hot)[0] is None
        assert ctl.try_admit(hot)[0] is None
        reason, tenant, priority = ctl.try_admit(hot)
        assert (reason, tenant, priority) == ("tenant-quota", "t-hot",
                                              PRIORITY_CREATE)
        # the well-behaved tenant is untouched by the hot tenant's bucket
        for _ in range(50):
            assert ctl.try_admit(well)[0] is None
        snap = ctl.snapshot()
        assert snap["tenants"]["t-hot"]["shed"] == 1
        assert snap["tenants"]["t-well"]["shed"] == 0

    def test_completions_ride_free_over_quota(self):
        clock = [0.0]
        ctl = controller(clock, quotas={"t": (1.0, 1.0)})
        assert ctl.try_admit(create_cmd("t"))[0] is None
        assert ctl.try_admit(create_cmd("t"))[0] == "tenant-quota"
        # the over-quota tenant must still finish the work it holds
        assert ctl.try_admit(complete_cmd("t"))[0] is None

    def test_weighted_fair_share_under_contention(self):
        clock = [0.0]
        ctl = controller(clock, max_inflight=10,
                         weights={"t-big": 4.0, "t-small": 1.0})
        # t-big fills the whole window while uncontended (work-conserving)
        for _ in range(10):
            assert ctl.try_admit(create_cmd("t-big"))[0] is None
        # window contended: t-big is past its share, t-small is not
        assert ctl.try_admit(create_cmd("t-big"))[0] == "fair-share"
        assert ctl.try_admit(create_cmd("t-small"))[0] is None
        # releases reopen the window
        for _ in range(6):
            ctl.release("t-big")
        assert ctl.try_admit(create_cmd("t-big"))[0] is None

    def _breach(self, ctl, clock, ticks=3, latency_ms=5000.0):
        for _ in range(ticks):
            clock[0] += 1000.0
            for _ in range(20):
                ctl.observe_ack(latency_ms)
            ctl.tick()

    def _clear(self, ctl, clock, ticks=5, latency_ms=5.0):
        for _ in range(ticks):
            clock[0] += 1000.0
            for _ in range(20):
                ctl.observe_ack(latency_ms)
            ctl.tick()

    def test_shed_ladder_rises_with_hysteresis_and_recovers(self):
        clock = [0.0]
        ctl = controller(clock, shed_p99_ms=1000.0)
        query = command(ValueType.TIMER, TimerIntent.TRIGGER, {})
        # two breach ticks are NOT enough (breach_ticks=3)
        self._breach(ctl, clock, ticks=2)
        assert ctl.shed_level == 0
        self._breach(ctl, clock, ticks=1)
        assert ctl.shed_level == 1
        # level 1 sheds the query rung only
        assert ctl.try_admit(query)[0] == "priority"
        assert ctl.try_admit(create_cmd("t"))[0] is None
        # three more breaches: level 2 sheds new work, continuations pass
        self._breach(ctl, clock, ticks=3)
        assert ctl.shed_level == 2
        assert ctl.try_admit(create_cmd("t"))[0] == "priority"
        assert ctl.try_admit(command(ValueType.MESSAGE, MessageIntent.PUBLISH,
                                     {}))[0] is None
        # level 3: only completions survive
        self._breach(ctl, clock, ticks=3)
        assert ctl.shed_level == MAX_SHED_LEVEL
        assert ctl.try_admit(command(ValueType.MESSAGE, MessageIntent.PUBLISH,
                                     {}))[0] == "priority"
        assert ctl.try_admit(complete_cmd("t"))[0] is None
        # recovery needs clear_ticks consecutive clears below the floor
        self._clear(ctl, clock, ticks=4)
        assert ctl.shed_level == MAX_SHED_LEVEL
        self._clear(ctl, clock, ticks=1)
        assert ctl.shed_level == MAX_SHED_LEVEL - 1

    def test_mid_band_latency_holds_the_level(self):
        clock = [0.0]
        ctl = controller(clock, shed_p99_ms=1000.0)
        self._breach(ctl, clock, ticks=3)
        assert ctl.shed_level == 1
        # between the recover floor (500) and the target (1000): hold
        for _ in range(20):
            clock[0] += 1000.0
            for _ in range(20):
                ctl.observe_ack(750.0)
            ctl.tick()
        assert ctl.shed_level == 1

    def test_draining_after_sustained_new_work_shedding(self):
        from zeebe_tpu_torch.observability.flight_recorder import FlightRecorder

        clock = [0.0]
        flight = FlightRecorder("test-gw", data_dir=None,
                                clock_millis=lambda: int(clock[0]))
        ctl = AdmissionController(
            AdmissionCfg(shed_p99_ms=1000.0, drain_after_ms=3000),
            node_id="test-gw", clock_millis=lambda: clock[0], flight=flight)
        self._breach(ctl, clock, ticks=6)     # level 2: shedding creates
        assert ctl.shed_level >= 2 and not ctl.draining
        self._breach(ctl, clock, ticks=4)     # sustained past drain_after_ms
        assert ctl.draining
        kinds = [e["kind"] for ring in flight.snapshot()["partitions"].values()
                 for e in ring]
        # shed-level decisions are re-homed under the shared control_adjust
        # vocabulary: one audit schema for every feedback loop
        assert "control_adjust" in kinds
        adjusts = [e for ring in flight.snapshot()["partitions"].values()
                   for e in ring if e["kind"] == "control_adjust"]
        assert all(e["controller"] == "admission-shed-ladder"
                   and e["knob"] == "admission.shedLevel" for e in adjusts)
        assert any(e["after"] > e["before"] for e in adjusts)
        assert "admission_draining" in kinds
        # recovery clears the drain
        self._clear(ctl, clock, ticks=30)
        assert not ctl.draining

    def test_external_p99_source_preferred(self):
        clock = [0.0]
        source = [5000.0]
        ctl = AdmissionController(AdmissionCfg(shed_p99_ms=1000.0),
                                  node_id="test-gw",
                                  clock_millis=lambda: clock[0],
                                  p99_source=lambda: source[0])
        for _ in range(3):
            clock[0] += 1000.0
            ctl.tick()
        assert ctl.shed_level == 1     # breached on store evidence alone
        assert ctl.last_p99_ms == 5000.0

    def test_disabled_controller_admits_everything(self):
        clock = [0.0]
        ctl = controller(clock, enabled=False, quotas={"t": (0.001, 1.0)})
        for _ in range(100):
            assert ctl.try_admit(create_cmd("t"))[0] is None

    def test_shed_events_land_in_flight_recorder(self):
        from zeebe_tpu_torch.observability.flight_recorder import FlightRecorder

        clock = [0.0]
        flight = FlightRecorder("test-gw", data_dir=None,
                                clock_millis=lambda: int(clock[0]))
        ctl = AdmissionController(AdmissionCfg(quotas={"t": (1.0, 1.0)}),
                                  node_id="test-gw",
                                  clock_millis=lambda: clock[0],
                                  flight=flight)
        assert ctl.try_admit(create_cmd("t"))[0] is None
        assert ctl.try_admit(create_cmd("t"))[0] == "tenant-quota"
        events = [e for ring in flight.snapshot()["partitions"].values()
                  for e in ring if e["kind"] == "admission_shed"]
        assert events and events[0]["tenant"] == "t"
        assert events[0]["reason"] == "tenant-quota"


# ---------------------------------------------------------------------------
# loopback integration: gateway + worker over the multi-process protocol


# ---------------------------------------------------------------------------
# satellite: backpressure whitelist accounting + limiter fuzz


class TestWhitelistAccounting:
    def _saturate(self, limiter, start_pos=0):
        n = 0
        while limiter.try_acquire(create_cmd()):
            limiter.on_appended(start_pos + n)
            n += 1
        return n

    def test_whitelisted_intents_count_against_in_flight(self):
        now = [0]
        limiter = CommandRateLimiter("fixed", limit=3,
                                     clock_millis=lambda: now[0])
        admitted = self._saturate(limiter)
        assert admitted == 3
        # whitelisted completion passes the saturated gate...
        assert limiter.try_acquire(complete_cmd())
        limiter.on_appended(100)
        # ...but it IS accounted in flight (the limiter's view stays honest)
        assert len(limiter.in_flight) == 4
        assert not limiter.try_acquire(create_cmd())

    def test_whitelist_flood_cannot_starve_the_limiter(self):
        now = [0]
        limiter = CommandRateLimiter("aimd", initial=4, min_limit=1,
                                     max_limit=100, timeout_ms=200,
                                     clock_millis=lambda: now[0])
        # flood with whitelisted completions far past the limit
        for pos in range(50):
            assert limiter.try_acquire(complete_cmd())
            limiter.on_appended(pos)
        assert not limiter.try_acquire(create_cmd())
        # the flood drains with fast RTTs: the limiter RECOVERS — admits
        # normal traffic again and the limit never collapsed below min
        now[0] += 10
        for pos in range(50):
            limiter.on_processed(pos)
        assert limiter.limit >= 1
        assert limiter.try_acquire(create_cmd())
        assert len(limiter.in_flight) == 0


class TestLimiterFuzz:
    def test_aimd_invariant_and_recovery_after_timeout_storm(self):
        rng = random.Random(11)
        limit = AimdLimit(initial=50, min_limit=2, max_limit=200,
                          timeout_ms=200.0)
        for _ in range(5000):
            rtt = rng.uniform(1.0, 400.0)
            limit.on_sample(rtt, rng.randrange(0, limit.limit + 1),
                            dropped=rng.random() < 0.05)
            assert 2 <= limit.limit <= 200
        # timeout storm: every sample over the threshold
        for _ in range(200):
            limit.on_sample(1000.0, limit.limit, dropped=True)
            assert limit.limit >= 2
        assert limit.limit <= 5          # collapsed toward min
        # sustained healthy traffic recovers the limit
        for _ in range(2000):
            limit.on_sample(5.0, limit.limit, dropped=False)
            assert limit.limit <= 200
        assert limit.limit >= 100

    def test_vegas_invariant_and_recovery_after_timeout_storm(self):
        rng = random.Random(7)
        limit = VegasLimit(initial=20, min_limit=2, max_limit=500)
        for _ in range(5000):
            rtt = rng.uniform(0.5, 300.0)
            limit.on_sample(rtt, rng.randrange(0, limit.limit + 1),
                            dropped=rng.random() < 0.05)
            assert 2 <= limit.limit <= 500
        # drop storm collapses multiplicatively but never below min
        for _ in range(100):
            limit.on_sample(0.0, limit.limit, dropped=True)
            assert limit.limit >= 2
        collapsed = limit.limit
        assert collapsed <= 10
        # rtt back at the observed minimum: the gradient grows the limit
        for _ in range(2000):
            limit.on_sample(0.5, limit.limit, dropped=False)
            assert limit.limit <= 500
        assert limit.limit > collapsed * 4

    def test_synthetic_trace_is_deterministic(self):
        def run() -> list[int]:
            rng = random.Random(3)
            limit = VegasLimit(initial=10, min_limit=1, max_limit=100)
            out = []
            for _ in range(1000):
                limit.on_sample(rng.uniform(1, 50), rng.randrange(0, 20),
                                dropped=rng.random() < 0.02)
                out.append(limit.limit)
            return out

        assert run() == run()
