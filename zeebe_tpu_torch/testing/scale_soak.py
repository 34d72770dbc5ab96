"""Million-instance scale soak: long-lived parked state as a gate.

ROADMAP item 4's acceptance harness: park a production-scale backlog of
process instances (waiting on messages, timers, and jobs) on a tiered-state
broker, keep traffic flowing (correlation storms that wake cold instances,
snapshots + log compaction under load), crash it mid-spill and mid-snapshot,
and assert after every restart:

- **bounded RSS** — peak resident memory stays under ``rss_bound_bytes``
  while the cold tier (state/tiering.py) holds the parked majority (the
  ``rss_watermark`` alert rule is armed at the same bound as a live
  monitor);
- **zero acked-record loss** — every client-acknowledged command reaches
  the export stream exactly once; the export ledger is CONTIGUITY-based
  (O(1) memory at a million instances: the stream assigns dense positions,
  so "no gap ever appeared" + "covered past every acked position" is
  completeness) with a bounded CRC window proving re-exports after restarts
  byte-identical;
- **recovery within budget** — every rebuild (including the one that finds
  a torn snapshot tip, and the one interrupted mid-spill) lands inside
  ``recovery_budget_ms`` with the flight recorder carrying the artifact;
- **wake-after-recovery** — messages published *after* a crash correlate
  into instances parked (and spilled) *before* it;
- **flat sweeps** — a due-date sweep over the fully-parked backlog is timed
  and reported (the slow test asserts 1k vs 100k within the 2× bound).

Bulk-park phases run with the raft journal's ``delayed`` flush policy (the
reference DelayedFlusher — a legitimate bulk-import posture); before any
crash the journal is fsynced and the policy returns to ``immediate``, so
the acked-loss invariant is never asserted against bytes that were
legitimately allowed to be volatile.

Built on the chaos harness (seeded, deterministic),/5
observability (flight recorder, alert evaluator, RSS self-metrics), and
 recovery budgets (incremental snapshot chains, compaction guards).

The port's harness is a partial copy of the reference's: ``ScaleSoakHarness`` and
``run_scale_soak`` take the kernel backend's ``device`` (None = the card,
``"cpu"`` = the plain version) and give it to the chaos harness's
cluster. The rest is the reference's, copied.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
import zlib
from collections import deque
from pathlib import Path
from typing import Any

from zeebe_tpu_torch.exporters import Exporter
from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
from zeebe_tpu_torch.protocol import ValueType, command
from zeebe_tpu_torch.protocol.intent import (
    DeploymentIntent,
    MessageIntent,
    ProcessInstanceCreationIntent,
)
from zeebe_tpu_torch.testing.chaos import ChaosHarness, FaultPlan
from zeebe_tpu_torch.utils.metrics import _read_rss_bytes


# copied from the reference: ScaleSoakConfig .. _models
@dataclasses.dataclass
class ScaleSoakConfig:
    """Quick mode (CI smoke): ≥100k parked. Full mode: 1M+."""

    seed: int = 20260804
    target_parked: int = 100_000
    #: park mix: message-wait / long-timer / job-wait fractions
    msg_fraction: float = 0.55
    timer_fraction: float = 0.30
    batch_size: int = 1_000
    #: correlation storm: bursts × publishes per burst (wakes cold instances)
    storm_bursts: int = 3
    storm_size: int = 1_500
    #: post-crash wake probe: publishes against pre-crash parked keys
    wake_probe: int = 400
    snapshot_period_ms: int = 2_500
    recovery_budget_ms: int = 90_000
    snapshot_chain_length: int = 6
    park_after_ms: int = 1_500
    spill_batch: int = 8_192
    #: peak-RSS gate (and the rss_watermark alert threshold). The peak
    #: includes one full-hot recovery residency: a crash-restart loads the
    #: snapshot chain entirely hot before the manager re-spills.
    rss_bound_bytes: int = 3584 << 20
    #: the sharper bounded-RSS claim: while bulk-parking (phase B), resident
    #: growth per newly-parked instance must stay under this — cold-tier
    #: spilling is what keeps it far below the decoded-object footprint
    max_hot_growth_per_parked: int = 4096
    #: at the parked peak, at least this fraction of instances must be cold
    min_spilled_fraction: float = 0.5
    step_ms: int = 50
    #: park timers far beyond the soak's clock horizon
    timer_duration: str = "PT8H"
    partition_id: int = 1
    drain_ticks: int = 600
    #: replay≡live byte-parity oracle at the end (the "spilled instance
    #: survives crash-recovery byte-identically" receipt); O(state) — the
    #: 1M full config turns it off
    replay_parity_check: bool = True


FULL_CONFIG = ScaleSoakConfig(
    target_parked=1_000_000,
    storm_bursts=5, storm_size=10_000, wake_probe=2_000,
    snapshot_period_ms=10_000,
    rss_bound_bytes=8 << 30,
    recovery_budget_ms=300_000,
    replay_parity_check=False,
)


class ExportLedger:
    """Cross-lifetime export ledger in O(1) memory.

    The stream assigns dense positions, and within one exporter-container
    lifetime exports arrive in strictly increasing position order starting
    at or below the acked watermark — so completeness is contiguity:
    ``covered_upto`` advances record by record, any jump past
    ``covered_upto + 1`` is a lost-record violation, and every re-export
    (position ≤ ``covered_upto``) must match the CRC remembered for that
    position. The CRC window is bounded (restart catch-up replays only the
    un-acked-snapshot suffix, which is recent by the snapshot-cadence
    invariant); a re-export older than the window counts as unverified
    rather than guessed at."""

    def __init__(self, crc_window: int = 400_000) -> None:
        self.covered_upto = 0
        self.total = 0
        self.reexports = 0
        self.reexports_unverified = 0
        self.violations: list[str] = []
        self._crc: dict[int, int] = {}
        self._crc_order: deque[int] = deque()
        self._crc_window = crc_window

    def observe(self, position: int, data: bytes, lifetime: str) -> None:
        self.total += 1
        crc = zlib.crc32(data) & 0xFFFFFFFF
        if position <= self.covered_upto:
            self.reexports += 1
            seen = self._crc.get(position)
            if seen is None:
                self.reexports_unverified += 1
            elif seen != crc:
                self.violations.append(
                    f"divergent re-export at position {position} "
                    f"({lifetime}): content changed across restarts")
            return
        if position != self.covered_upto + 1:
            self.violations.append(
                f"export gap: position {position} after covered "
                f"{self.covered_upto} ({lifetime}) — records lost")
        self.covered_upto = max(self.covered_upto, position)
        self._crc[position] = crc
        self._crc_order.append(position)
        if len(self._crc_order) > self._crc_window:
            self._crc.pop(self._crc_order.popleft(), None)


class ScaleSoakExporter(Exporter):
    """Strict-ordering exporter over the shared ledger (one instance per
    container lifetime; the ledger survives the whole soak)."""

    _lifetimes = 0

    def __init__(self, ledger: ExportLedger) -> None:
        self.ledger = ledger
        ScaleSoakExporter._lifetimes += 1
        self._lifetime = f"life-{ScaleSoakExporter._lifetimes}"
        self._last = -1

    def export(self, record) -> None:
        pos = record.position
        if pos <= self._last:
            self.ledger.violations.append(
                f"duplicate export within container lifetime "
                f"{self._lifetime}: {pos} after {self._last}")
        self._last = pos
        self.ledger.observe(pos, record.record.to_bytes(), self._lifetime)
        self.controller.update_last_exported_position(pos)


def _models(timer_duration: str):
    msg = (Bpmn.create_executable_process("scale_msg")
           .start_event("s")
           .intermediate_catch_message("wait", message_name="scale-msg",
                                       correlation_key="=ck")
           .end_event("e").done())
    tmr = (Bpmn.create_executable_process("scale_tmr")
           .start_event("s")
           .intermediate_catch_timer("wait", duration=timer_duration)
           .end_event("e").done())
    job = (Bpmn.create_executable_process("scale_job")
           .start_event("s").service_task("t", job_type="scale-work")
           .end_event("e").done())
    return msg, tmr, job
# end of the copy


class ScaleSoakHarness:
    def __init__(self, cfg: ScaleSoakConfig | None = None,
                 directory: str | Path | None = None, device=None) -> None:
        self.cfg = cfg or ScaleSoakConfig()
        # arm the RSS alert monitor at the soak's own bound (default_rules
        # reads the env at broker construction)
        os.environ["ZEEBE_ALERT_RSSWATERMARKBYTES"] = str(
            self.cfg.rss_bound_bytes)
        self.ledger = ExportLedger()
        self.rng = random.Random(self.cfg.seed)
        self.chaos = ChaosHarness(
            FaultPlan(seed=self.cfg.seed),
            broker_count=1, partition_count=1, replication_factor=1,
            directory=directory,
            exporters_factory=lambda: {"scale": ScaleSoakExporter(self.ledger)},
            step_ms=self.cfg.step_ms,
            snapshot_period_ms=self.cfg.snapshot_period_ms,
            recovery_budget_ms=self.cfg.recovery_budget_ms,
            snapshot_chain_length=self.cfg.snapshot_chain_length,
            tiering=True,
            tiering_park_after_ms=self.cfg.park_after_ms,
            tiering_spill_batch=self.cfg.spill_batch,
            device=device,
        )
        self.cluster = self.chaos.cluster
        self.violations: list[str] = []
        self.recoveries: list[dict] = []
        self.flight_dumps: list[str] = []
        self.acked_ranges: list[tuple[int, int]] = []
        self.created = 0
        self.parked_keys: list[str] = []     # live message correlation keys
        self.peak_spilled = 0
        self.peak_rss = 0
        self.sweep_probes: list[dict] = []
        self.timeline: list[dict] = []
        self._t0 = time.perf_counter()

    # -- plumbing --------------------------------------------------------------

    # copied from the reference: _leader .. report
    def _leader(self):
        return self.cluster.leader(self.cfg.partition_id)

    def _note(self, phase: str, **extra) -> None:
        self.timeline.append({
            "phase": phase,
            "wallS": round(time.perf_counter() - self._t0, 1),
            "rssBytes": self._sample_rss(),
            **extra})

    def _sample_rss(self) -> int:
        rss = int(_read_rss_bytes())
        self.peak_rss = max(self.peak_rss, rss)
        return rss

    def _write_batch(self, records: list) -> None:
        leader = self._leader()
        if leader is None:
            self.violations.append("lost the leader during traffic")
            return
        last = leader.write_commands(records)
        if last is None:
            return
        first = last - len(records) + 1
        self.chaos.run_ticks(1)
        leader = self._leader()
        if leader is not None and leader.stream.last_position >= last:
            # committed ⇒ acknowledged ⇒ covered by the durability pillar
            self.acked_ranges.append((first, last))

    def _observe_tiering(self) -> None:
        leader = self._leader()
        if leader is not None and leader.tiering is not None:
            self.peak_spilled = max(self.peak_spilled,
                                    leader.tiering.spilled_instances)
        self._sample_rss()

    # -- workload phases -------------------------------------------------------

    def _deploy(self) -> None:
        models = _models(self.cfg.timer_duration)
        self._write_batch([command(
            ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {
                "resources": [
                    {"resourceName": f"scale-{m.process_id}.bpmn",
                     "resource": to_bpmn_xml(m)} for m in models]})])
        self.chaos.run_ticks(5)

    def _creation_batch(self, n: int) -> list:
        cfg = self.cfg
        out = []
        for _ in range(n):
            roll = self.rng.random()
            i = self.created
            self.created += 1
            if roll < cfg.msg_fraction:
                key = f"ck-{i}"
                self.parked_keys.append(key)
                out.append(command(
                    ValueType.PROCESS_INSTANCE_CREATION,
                    ProcessInstanceCreationIntent.CREATE,
                    {"bpmnProcessId": "scale_msg", "version": -1,
                     "variables": {"ck": key, "tag": i}}))
            elif roll < cfg.msg_fraction + cfg.timer_fraction:
                out.append(command(
                    ValueType.PROCESS_INSTANCE_CREATION,
                    ProcessInstanceCreationIntent.CREATE,
                    {"bpmnProcessId": "scale_tmr", "version": -1,
                     "variables": {"tag": i}}))
            else:
                out.append(command(
                    ValueType.PROCESS_INSTANCE_CREATION,
                    ProcessInstanceCreationIntent.CREATE,
                    {"bpmnProcessId": "scale_job", "version": -1,
                     "variables": {"tag": i}}))
        return out

    def _park_until(self, target: int, label: str) -> None:
        """Bulk-park up to ``target`` created instances. Runs under the
        delayed raft flush policy; ends with an fsync barrier back to
        ``immediate`` so every later crash only ever eats bytes the
        invariants never covered."""
        leader = self._leader()
        if leader is None:
            return
        leader.raft.flush_policy = "delayed"
        while self.created < target:
            n = min(self.cfg.batch_size, target - self.created)
            self._write_batch(self._creation_batch(n))
            self._observe_tiering()
        self._flush_barrier()
        self._note(label, created=self.created)

    def _flush_barrier(self) -> None:
        leader = self._leader()
        if leader is None:
            return
        leader.raft._flush_journal()
        leader.raft.flush_policy = "immediate"

    def _run_spill(self, ticks: int, until_spilled: int | None = None) -> None:
        for _ in range(ticks):
            self.chaos.run_ticks(1)
            self._observe_tiering()
            leader = self._leader()
            if (until_spilled is not None and leader is not None
                    and leader.tiering is not None
                    and leader.tiering.spilled_instances >= until_spilled):
                return

    def _correlation_storm(self) -> int:
        """Bursts of publishes against parked keys: each wakes a (usually
        cold) instance, completes it, and re-exercises spill afterwards."""
        woken = 0
        for _ in range(self.cfg.storm_bursts):
            burst = min(self.cfg.storm_size, len(self.parked_keys))
            picks = [self.parked_keys.pop(
                self.rng.randrange(len(self.parked_keys)))
                for _ in range(burst)]
            for i in range(0, len(picks), self.cfg.batch_size):
                self._write_batch([command(
                    ValueType.MESSAGE, MessageIntent.PUBLISH,
                    {"name": "scale-msg", "correlationKey": key,
                     "timeToLive": 60_000, "messageId": "", "variables": {}})
                    for key in picks[i:i + self.cfg.batch_size]])
            woken += burst
            self.chaos.run_ticks(5)
            self._observe_tiering()
        self._note("storm", woken=woken)
        return woken

    # -- crash / recovery ------------------------------------------------------

    def _crash_restart(self, label: str, tamper: bool = False) -> None:
        leader = self._leader()
        node_id = self.cluster.leader_broker(self.cfg.partition_id).cfg.node_id
        stats = (leader.db.tier_stats()
                 if hasattr(leader.db, "tier_stats") else {})
        self.cluster.hard_crash_broker(node_id)
        self.chaos.clear_exporter_watermarks(node_id)
        # drop our references to the dead broker's state and collect NOW:
        # without this the old life's hot dict and the restarted life's
        # recovered state are resident simultaneously, and the measured peak
        # reports the harness's GC laziness instead of the engine's footprint
        leader = None
        import gc

        gc.collect()
        tampered = None
        if tamper:
            from zeebe_tpu_torch.testing.soak import tamper_newest_snapshot

            tampered = tamper_newest_snapshot(
                self.cluster.directory, node_id, self.cfg.partition_id)
        restart_ms = self.cluster.clock()
        restart_wall = time.perf_counter()
        self.cluster.restart_broker(node_id)
        self.chaos.clear_exporter_watermarks(node_id)
        leader = None
        for _ in range(self.cfg.drain_ticks):
            self.chaos.run_ticks(1)
            leader = self._leader()
            if leader is not None and leader.last_recovery is not None:
                break
        if leader is None:
            self.violations.append(
                f"{label}: no leader within {self.cfg.drain_ticks} ticks "
                f"(seed {self.cfg.seed})")
            return
        rec = dict(leader.last_recovery or {}, label=label,
                   tamperedSnapshot=tampered,
                   coldAtCrash=stats.get("coldKeys"),
                   restartWallS=round(time.perf_counter() - restart_wall, 2))
        self.recoveries.append(rec)
        if not rec.get("withinBudget", False):
            self.violations.append(
                f"{label}: recovery blew the budget "
                f"({rec.get('durationMs')}ms > {rec.get('budgetMs')}ms)")
        self._collect_flight_dumps(label, node_id, restart_ms)
        self._note(label, recoveryMs=rec.get("durationMs"))

    def _collect_flight_dumps(self, label: str, node_id: str,
                              since_ms: int) -> None:
        from zeebe_tpu_torch.testing.evidence import collect_flight_dumps

        collect_flight_dumps(self.cluster.directory / node_id,
                             self.flight_dumps, since_ms, label,
                             self.violations)

    # -- probes ----------------------------------------------------------------

    def _sweep_probe(self, label: str) -> None:
        """Time one due-date sweep against the current parked backlog —
        the O(due)-not-O(parked) receipt (nothing is due: parked timers sit
        hours out, so the sweep should be microseconds regardless of
        backlog size)."""
        leader = self._leader()
        if leader is None or leader.checkers is None:
            return
        parked_timers = leader.db.key_counts_by_cf().get("TIMER_DUE_DATES", 0)
        t0 = time.perf_counter()
        leader.checkers._sweep()
        sweep_ms = (time.perf_counter() - t0) * 1000.0
        t0 = time.perf_counter()
        leader.checkers.reschedule()
        resched_ms = (time.perf_counter() - t0) * 1000.0
        self.sweep_probes.append({
            "label": label, "parkedTimers": parked_timers,
            "sweepMs": round(sweep_ms, 3),
            "rescheduleMs": round(resched_ms, 3)})

    def _wake_probe_after_recovery(self) -> None:
        """Messages published AFTER the crash must correlate into instances
        parked (and spilled) BEFORE it."""
        leader = self._leader()
        if leader is None:
            return
        n = min(self.cfg.wake_probe, len(self.parked_keys))
        if n == 0:
            return
        subs_before = leader.db.key_counts_by_cf().get(
            "MESSAGE_SUBSCRIPTION_BY_KEY", 0)
        picks = [self.parked_keys.pop() for _ in range(n)]
        for i in range(0, n, self.cfg.batch_size):
            self._write_batch([command(
                ValueType.MESSAGE, MessageIntent.PUBLISH,
                {"name": "scale-msg", "correlationKey": key,
                 "timeToLive": 60_000, "messageId": "", "variables": {}})
                for key in picks[i:i + self.cfg.batch_size]])
        self.chaos.run_ticks(10)
        leader = self._leader()
        subs_after = leader.db.key_counts_by_cf().get(
            "MESSAGE_SUBSCRIPTION_BY_KEY", 0)
        if subs_after > subs_before - n:
            self.violations.append(
                f"wake-after-recovery: only {subs_before - subs_after} of "
                f"{n} pre-crash parked instances completed on post-crash "
                f"correlation")
        self._note("wake-probe", woken=subs_before - subs_after)

    # -- final invariants ------------------------------------------------------

    def _final_checks(self) -> None:
        cfg = self.cfg
        # acked completeness: contiguity covered past every acked position
        acked_max = max((last for _, last in self.acked_ranges), default=0)
        if self.ledger.covered_upto < acked_max:
            self.violations.append(
                f"acked records lost: export coverage stops at "
                f"{self.ledger.covered_upto}, acked up to {acked_max}")
        self.violations.extend(self.ledger.violations)
        self.chaos.check_exactly_once_materialization(cfg.partition_id)
        if cfg.replay_parity_check:
            # replay the journal over the recovered chain and require the
            # result byte-equals the LIVE (partially cold) state — the
            # spilled-instances-survive-crash-recovery-byte-identically gate
            self.chaos.check_replay_equivalence(cfg.partition_id)
        self.violations.extend(self.chaos.violations)
        if self.created < cfg.target_parked:
            self.violations.append(
                f"only created {self.created} of {cfg.target_parked}")
        spill_fraction = self.peak_spilled / max(self.created, 1)
        if spill_fraction < cfg.min_spilled_fraction:
            self.violations.append(
                f"cold tier held only {self.peak_spilled} instances at peak "
                f"({spill_fraction:.0%} of {self.created}; gate "
                f"{cfg.min_spilled_fraction:.0%}) — tiering is not bounding "
                f"the hot set")
        if self.peak_rss > cfg.rss_bound_bytes:
            self.violations.append(
                f"peak RSS {self.peak_rss / (1 << 20):.0f} MiB exceeds the "
                f"bound {cfg.rss_bound_bytes / (1 << 20):.0f} MiB")
        broker = self.cluster.leader_broker(cfg.partition_id)
        if broker is not None and broker.alerts is not None:
            firing = broker.alerts.firing()
            self.firing_alerts = firing
            if any(a.get("rule") == "rss_watermark" for a in firing):
                self.violations.append("rss_watermark alert is firing")
        else:
            self.firing_alerts = []

    # -- the run ---------------------------------------------------------------

    def run(self) -> dict:
        cfg = self.cfg
        try:
            self.cluster.await_leaders()
            self._deploy()
            self._sweep_probe("empty")
            # phase A: park ~40%, crash MID-SPILL, recover
            self._park_until(int(cfg.target_parked * 0.4), "park-A")
            self._run_spill(
                ticks=cfg.drain_ticks,
                until_spilled=max(int(self.created * 0.2), 1))
            leader = self._leader()
            if leader is None or leader.tiering is None \
                    or leader.tiering.spilled_instances == 0:
                self.violations.append(
                    "phase A never spilled — cannot crash mid-spill")
            self._crash_restart("crash-mid-spill")
            # phase B: park the rest; snapshots keep landing under load.
            # RSS growth across this phase is the headline bounded-memory
            # gate: parked instances spill, so residency must grow by a
            # small stub per instance, not a decoded object tree.
            self._run_spill(ticks=cfg.drain_ticks // 2,
                            until_spilled=max(
                                int(self.created * 0.5), 1))
            rss_before_b = self._sample_rss()
            created_before_b = self.created
            self._park_until(cfg.target_parked, "park-B")
            self._run_spill(
                ticks=cfg.drain_ticks,
                until_spilled=int(self.created * cfg.min_spilled_fraction))
            self._observe_tiering()
            parked_in_b = self.created - created_before_b
            growth = self._sample_rss() - rss_before_b
            per_instance = growth / max(parked_in_b, 1)
            self._note("park-B-growth", rssGrowthBytes=growth,
                       perParkedInstanceBytes=round(per_instance, 1))
            if per_instance > cfg.max_hot_growth_per_parked:
                self.violations.append(
                    f"hot residency grew {per_instance:.0f} bytes per "
                    f"newly-parked instance over phase B (gate "
                    f"{cfg.max_hot_growth_per_parked}) — spilling is not "
                    f"bounding the hot set")
            self._sweep_probe("parked")
            # correlation storm wakes cold instances under sustained load
            self._correlation_storm()
            # settle spill again, then crash with a TORN newest snapshot
            self._run_spill(ticks=60)
            leader = self._leader()
            if leader is not None:
                leader.take_snapshot()  # one more snapshot under load
            self._crash_restart("crash-torn-snapshot", tamper=True)
            self._wake_probe_after_recovery()
            self._run_spill(ticks=40)
            self._sweep_probe("after-recovery")
            self.chaos.quiesce(40)
            self._final_checks()
            return self.report()
        finally:
            self.chaos.close()

    def report(self) -> dict:
        cfg = self.cfg
        durations = [r.get("durationMs", 0.0) for r in self.recoveries]
        return {
            "seed": cfg.seed,
            "targetParked": cfg.target_parked,
            "created": self.created,
            "peakSpilledInstances": self.peak_spilled,
            "peakSpilledFraction": round(
                self.peak_spilled / max(self.created, 1), 3),
            "rss": {
                "peakBytes": self.peak_rss,
                "peakMiB": round(self.peak_rss / (1 << 20), 1),
                "boundBytes": cfg.rss_bound_bytes,
                "withinBound": self.peak_rss <= cfg.rss_bound_bytes,
            },
            "exports": {
                "total": self.ledger.total,
                "coveredUpto": self.ledger.covered_upto,
                "reexports": self.ledger.reexports,
                "reexportsUnverified": self.ledger.reexports_unverified,
            },
            "ackedBatches": len(self.acked_ranges),
            "recoveries": self.recoveries,
            "recoveryMs": {
                "max": max(durations, default=0.0),
                "budget": cfg.recovery_budget_ms,
            },
            "withinBudget": all(
                r.get("withinBudget", False) for r in self.recoveries),
            "sweepProbes": self.sweep_probes,
            "firingAlerts": getattr(self, "firing_alerts", []),
            "flightDumps": self.flight_dumps,
            "timeline": self.timeline,
            "violations": self.violations,
        }
    # end of the copy


def run_scale_soak(cfg: ScaleSoakConfig | None = None,
                   directory: str | Path | None = None, device=None) -> dict:
    """One-call entry point (bench.py --scale-soak, tests)."""
    return ScaleSoakHarness(cfg, directory=directory, device=device).run()


if __name__ == "__main__":  # pragma: no cover — manual
    # python -m zeebe_tpu_torch.testing.scale_soak [--quick] [--seed N]
    # [--device cpu]: 100,000 parked with --quick, else FULL_CONFIG's 1M+
    import sys

    from zeebe_tpu_torch.testing.serving import gate_cli_main

    sys.exit(gate_cli_main("zeebe-tpu-scale-soak", ScaleSoakConfig(), FULL_CONFIG,
                           run_scale_soak))
