"""Crash-recovery soak harness: recovery-under-a-budget as a gate.

ROADMAP item 4 ("snapshot + log-compaction *under load*, crash-recovery
replay time measured against a recovery-time budget") as an executable
endurance workload: sustained mixed traffic — immediate service-task work
plus *parked* instances (timer waits, message-correlation waits) that keep
long-lived state across restarts — over an aggressive snapshot cadence, with
seeded power-loss crash-restarts fired **mid-flush** (buffered journal bytes
not yet covered by an fsync are lost) and **mid-snapshot** (the newest
persisted snapshot is torn the way a crash during the pending→committed
commit would leave it). After every restart the harness asserts the
durability pillar the paper promises:

- **no acked record lost** — every client-acknowledged command is in the
  final export stream exactly once (after position dedup);
- **no duplicate exports** — within an exporter container's lifetime
  positions are strictly increasing, and a re-export after a restart
  (at-least-once catch-up) must carry byte-identical record content;
- **replay bounded by snapshot cadence** — the records replayed on recovery
  never exceed the debt actually accumulated past the snapshot the recovery
  anchored on (plus the measured per-period append bound on untampered
  rounds);
- **recovery within budget** — every rebuild completes inside
  ``recovery_budget_ms`` (the `recovery_budget_exceeded` alert stays quiet);

and captures every recovery in a flight-recorder dump, so each restart
leaves a reviewable artifact (``bench.py --soak`` uploads them from CI).

Built on the chaos harness (seeded, deterministic: a failing run
replays from its seed) and the observability plane (metrics store +
flight recorder).

The port's harness is a partial copy of the reference's: ``SoakHarness`` and
``run_soak`` take the kernel backend's ``device`` (None = the card,
``"cpu"`` = the plain version) and give it to the chaos harness's
cluster. The rest is the reference's, copied.
"""

from __future__ import annotations

import dataclasses
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


# copied from the reference: SoakConfig .. tamper_newest_snapshot
@dataclasses.dataclass
class SoakConfig:
    """Knobs for one soak run. Defaults are the CI short mode — a few
    minutes on CPU; nightly/full runs scale ``rounds`` and
    ``traffic_per_round`` up."""

    seed: int = 20260803
    rounds: int = 5                  # crash-restart rounds (≥ 5 per
    traffic_per_round: int = 18      # instance creations between crashes
    snapshot_period_ms: int = 1500   # aggressive: several snapshots per round
    recovery_budget_ms: int = 30_000
    snapshot_chain_length: int = 4   # force delta chains AND rebases
    broker_count: int = 1            # recovery = time-to-leader after a kill
    replication_factor: int = 1
    partition_id: int = 1
    # every Nth round the crash also tears the newest persisted snapshot
    # (power loss during the pending→committed commit): recovery must fall
    # back to the previous fully-valid chain, never crash
    tamper_every: int = 2
    step_ms: int = 50
    drain_ticks: int = 400           # post-restart convergence bound


class _ExportSink:
    """Cross-lifetime export ledger. Exporter *instances* die with their
    broker; the sink survives the whole soak and holds the deduplicated
    export stream plus every duplicate-semantics violation."""

    def __init__(self) -> None:
        self.by_position: dict[int, bytes] = {}
        self.total_exports = 0
        self.reexports = 0
        self.violations: list[str] = []


class SoakExporter(Exporter):
    """Strict-ordering exporter over a shared sink: within one container
    lifetime positions must be strictly increasing (a duplicate inside a
    lifetime is a bug, not at-least-once); across lifetimes a re-export is
    legal catch-up but must be byte-identical to the first export of that
    position (the sink dedups by position — divergent content would mean
    the log itself changed under an acked record)."""

    def __init__(self, sink: _ExportSink) -> None:
        self.sink = sink
        self._last_position = -1

    def export(self, record) -> None:
        sink = self.sink
        sink.total_exports += 1
        pos = record.position
        if pos <= self._last_position:
            sink.violations.append(
                f"duplicate export within container lifetime: position {pos} "
                f"after {self._last_position}")
        self._last_position = pos
        data = record.record.to_bytes()
        seen = sink.by_position.get(pos)
        if seen is None:
            sink.by_position[pos] = data
        else:
            sink.reexports += 1
            if seen != data:
                sink.violations.append(
                    f"divergent re-export at position {pos}: content changed "
                    f"across restarts")
        self.controller.update_last_exported_position(pos)


def _deploy_cmd(*models) -> Any:
    return command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {
        "resources": [
            {"resourceName": f"soak-{i}.bpmn", "resource": to_bpmn_xml(m)}
            for i, m in enumerate(models)
        ],
    })


def _create_cmd(process_id: str, variables: dict) -> Any:
    return command(
        ValueType.PROCESS_INSTANCE_CREATION,
        ProcessInstanceCreationIntent.CREATE,
        {"bpmnProcessId": process_id, "version": -1, "variables": variables},
    )


def _soak_models():
    work = (
        Bpmn.create_executable_process("soak_work")
        .start_event("s").service_task("t", job_type="soak").end_event("e")
        .done()
    )
    timer = (
        Bpmn.create_executable_process("soak_timer")
        .start_event("s")
        .intermediate_catch_timer("wait", duration="PT2S")
        .end_event("e")
        .done()
    )
    msg = (
        Bpmn.create_executable_process("soak_msg")
        .start_event("s")
        .intermediate_catch_message("wait", message_name="soak-msg",
                                    correlation_key="=ck")
        .end_event("e")
        .done()
    )
    return work, timer, msg


def tamper_snapshot(cluster_directory, node_id: str, partition_id: int,
                    pick: str = "newest") -> str | None:
    """Corrupt a persisted snapshot on a (crashed) broker's disk.

    ``pick="newest"`` simulates power loss during the store's
    pending→committed commit: the newest snapshot dir loses the tail of
    one file (torn write) and a half-written pending dir is left behind —
    recovery must skip both and fall back / crash soaks).

    ``pick="mid-chain"`` tears a DELTA in the *middle* of the incremental
    chain (neither tip nor base) instead — bit rot / latent media error on
    an old chain member. The chain validator must declare every descendant
    invalid and recovery must fall back to the newest fully-valid ancestor
    chain. Returns the torn snapshot's dir name, or None when
    no eligible victim exists (e.g. no mid-chain delta yet)."""
    from zeebe_tpu_torch.state.snapshot import SnapshotId

    part_dir = (Path(cluster_directory) / node_id
                / f"partition-{partition_id}" / "snapshots")
    # numeric snapshot-id order, NOT name order: lexicographic sort ranks
    # "98-…" after "103-…" and would tear an older chain member (the
    # base!) instead of the tip
    snaps = sorted(
        ((snap_id, p)
         for p in (part_dir / "snapshots").iterdir() if p.is_dir()
         and (snap_id := SnapshotId.parse(p.name)) is not None),
        key=lambda pair: pair[0])
    if not snaps:
        return None
    if pick == "mid-chain":
        # a delta that is neither the newest dir (the tip) nor the chain
        # base: snaps[1:-1] with a delta.bin
        candidates = [p for _sid, p in snaps[1:-1]
                      if (p / "delta.bin").is_file()]
        if not candidates:
            return None
        victim = candidates[len(candidates) // 2]
        names = ("delta.bin",)
        leave_pending = False
    else:
        victim = snaps[-1][1]
        names = ("delta.bin", "state.bin", "durable.bin")
        leave_pending = True
    torn = False
    for name in names:
        f = victim / name
        if f.is_file():
            data = f.read_bytes()
            f.write_bytes(data[: max(len(data) // 2, 1)])
            torn = True
            break
    if not torn:
        return None
    if leave_pending:
        pending = part_dir / "pending" / "999999-1-999999-999999"
        pending.mkdir(parents=True, exist_ok=True)
        (pending / "state.bin").write_bytes(b"partial")
    return victim.name


def tamper_newest_snapshot(cluster_directory, node_id: str,
                           partition_id: int) -> str | None:
    """Back-compat alias: tear the newest snapshot (see
    :func:`tamper_snapshot`)."""
    return tamper_snapshot(cluster_directory, node_id, partition_id,
                           pick="newest")
# end of the copy


class SoakHarness:
    """Drives the endurance workload over a seeded chaos cluster and turns
    each crash-restart into a budget-checked, flight-recorded recovery."""

    def __init__(self, cfg: SoakConfig | None = None,
                 directory: str | Path | None = None, device=None) -> None:
        import random

        self.cfg = cfg or SoakConfig()
        self.sink = _ExportSink()
        self.rng = random.Random(self.cfg.seed)
        self.chaos = ChaosHarness(
            # message-level faults stay off: crash-restarts are the fault
            # under test and the plan seed still names the whole run
            FaultPlan(seed=self.cfg.seed),
            broker_count=self.cfg.broker_count,
            partition_count=1,
            replication_factor=self.cfg.replication_factor,
            directory=directory,
            exporters_factory=lambda: {"soak": SoakExporter(self.sink)},
            step_ms=self.cfg.step_ms,
            snapshot_period_ms=self.cfg.snapshot_period_ms,
            recovery_budget_ms=self.cfg.recovery_budget_ms,
            snapshot_chain_length=self.cfg.snapshot_chain_length,
            device=device,
        )
        self.cluster = self.chaos.cluster
        self.acked: dict[str, int] = {}     # tag -> committed position
        self.violations: list[str] = []
        self.recoveries: list[dict] = []
        self.flight_dumps: list[str] = []
        self.snapshot_kinds: dict[str, int] = {}
        self.max_chain_len = 0
        self._msg_keys_parked: list[str] = []
        self._seq = 0

    # -- workload --------------------------------------------------------------

    # copied from the reference: _leader .. report
    def _leader(self):
        return self.cluster.leader(self.cfg.partition_id)

    def _write(self, record) -> int | None:
        return self.cluster.write_command(self.cfg.partition_id, record)

    def _create(self, process_id: str, variables: dict, tag: str) -> None:
        pos = self._write(_create_cmd(process_id, dict(variables, soakTag=tag)))
        if pos is None:
            return
        leader = self._leader()
        if leader is not None and leader.stream.last_position >= pos:
            self.acked[tag] = pos   # committed ⇒ acknowledged ⇒ durable

    def _traffic_round(self, round_no: int) -> None:
        """Mixed sustained traffic: immediate work, parked timers, parked
        message waits, and correlations that wake earlier parked waits."""
        for _ in range(self.cfg.traffic_per_round):
            self._seq += 1
            tag = f"r{round_no}-{self._seq}"
            roll = self.rng.random()
            if roll < 0.4:
                self._create("soak_work", {}, tag)
            elif roll < 0.6:
                self._create("soak_timer", {}, tag)
            elif roll < 0.8 or not self._msg_keys_parked:
                key = f"ck-{self._seq}"
                self._create("soak_msg", {"ck": key}, tag)
                self._msg_keys_parked.append(key)
            else:
                key = self._msg_keys_parked.pop(
                    self.rng.randrange(len(self._msg_keys_parked)))
                self._write(command(ValueType.MESSAGE, MessageIntent.PUBLISH, {
                    "name": "soak-msg", "correlationKey": key,
                    "timeToLive": 60_000, "messageId": "",
                    "variables": {"soakTag": tag},
                }))
            self.chaos.run_ticks(1)

    # -- crash / tamper / restart ----------------------------------------------

    def _tamper_newest_snapshot(self, node_id: str) -> str | None:
        return tamper_newest_snapshot(
            self.cluster.directory, node_id, self.cfg.partition_id)

    def _await_recovery(self, round_no: int) -> None:
        """Run until a leader re-emerges and exporters drain; cap bounded."""
        leader = None
        for _ in range(self.cfg.drain_ticks):
            self.chaos.run_ticks(1)
            leader = self._leader()
            if leader is None:
                continue
            director = leader.exporter_director
            if director is None:
                continue
            lag = leader.stream.last_position - min(
                (c.position for c in director.containers), default=0)
            if lag <= 0:
                break
        if leader is None:
            self.violations.append(
                f"round {round_no}: no leader within {self.cfg.drain_ticks} "
                f"ticks of restart (seed {self.cfg.seed})")

    def _check_recovery(self, round_no: int, tampered: str | None,
                        debt_at_crash: int, appends_per_period: int) -> None:
        leader = self._leader()
        if leader is None:
            return
        rec = leader.last_recovery
        if rec is None:
            self.violations.append(
                f"round {round_no}: restarted leader has no recovery record")
            return
        info = dict(rec, round=round_no, tamperedSnapshot=tampered,
                    debtAtCrash=debt_at_crash)
        self.recoveries.append(info)
        if not rec["withinBudget"]:
            self.violations.append(
                f"round {round_no}: recovery blew the budget "
                f"({rec['durationMs']:.1f}ms > {rec['budgetMs']}ms)")
        # replay bounded by the debt past the snapshot the recovery actually
        # anchored on; on untampered rounds that anchor is the pre-crash tip,
        # so the bound collapses to the snapshot-cadence debt itself
        anchor_bound = rec["snapshotAgeRecords"] + 8
        if rec["replayRecords"] > anchor_bound:
            self.violations.append(
                f"round {round_no}: replayed {rec['replayRecords']} records, "
                f"more than the anchored snapshot debt {anchor_bound}")
        if tampered is None and debt_at_crash > max(
                3 * appends_per_period, 64):
            self.violations.append(
                f"round {round_no}: snapshot debt at crash {debt_at_crash} "
                f"exceeds 3x the per-period append bound "
                f"({appends_per_period}/period) — the cadence/adaptive "
                f"scheduler is not keeping up")
        self.max_chain_len = max(self.max_chain_len,
                                 rec.get("chainLength") or 0)

    def _collect_flight_dumps(self, round_no: int, node_id: str,
                              since_ms: int) -> None:
        from zeebe_tpu_torch.testing.evidence import collect_flight_dumps

        collect_flight_dumps(self.cluster.directory / node_id,
                             self.flight_dumps, since_ms,
                             f"round {round_no}", self.violations)

    # -- final invariants ------------------------------------------------------

    def _check_acked_completeness(self) -> None:
        """Every acknowledged command survived every crash: present in the
        deduplicated export stream exactly once (the sink would have flagged
        divergent duplicates already)."""
        for tag, pos in self.acked.items():
            if pos not in self.sink.by_position:
                self.violations.append(
                    f"acked record lost: tag {tag} at position {pos} never "
                    f"reached the export stream")

    def _snapshot_kind_counts(self) -> dict[str, int]:
        import re

        from zeebe_tpu_torch.utils.metrics import REGISTRY

        out: dict[str, int] = {}
        for name, _kind, labels, value in REGISTRY.snapshot():
            if name.endswith("_snapshot_kind_total"):
                m = re.search(r'kind="([^"]+)"', labels)
                if m:
                    out[m.group(1)] = out.get(m.group(1), 0) + int(value)
        return out

    # -- the run ---------------------------------------------------------------

    def run(self) -> dict:
        cfg = self.cfg
        c = self.cluster
        try:
            c.await_leaders()
            self._write(_deploy_cmd(*_soak_models()))
            self.chaos.run_ticks(5)
            appends_per_period = 1
            for round_no in range(1, cfg.rounds + 1):
                before = (self._leader().stream.last_position
                          if self._leader() else 0)
                self._traffic_round(round_no)
                leader = self._leader()
                if leader is None:
                    self.violations.append(
                        f"round {round_no}: lost the leader during traffic")
                    break
                # per-period append bound for the cadence check: traffic this
                # round, normalized to one snapshot period
                round_ms = max(cfg.traffic_per_round * 7 * cfg.step_ms, 1)
                appended = leader.stream.last_position - before
                appends_per_period = max(
                    1 + appended * cfg.snapshot_period_ms // round_ms,
                    appends_per_period)
                chain = leader.snapshot_store.latest_valid_chain()
                tip_processed = (chain[-1].id.processed_position
                                 if chain else 0)
                debt_at_crash = leader.stream.last_position - tip_processed
                node_id = c.leader_broker(cfg.partition_id).cfg.node_id
                # mid-flush fuel: appends raced into the group-commit buffer
                # with no covering fsync — the power loss eats them (they are
                # unacked, so no invariant covers them)
                for _ in range(3):
                    try:
                        leader.client_write(_create_cmd(
                            "soak_work", {"soakTag": f"unacked-r{round_no}"}))
                    except Exception:  # noqa: BLE001 — backpressure may
                        break          # reject the fuel; the crash is next
                c.hard_crash_broker(node_id)
                self.chaos.clear_exporter_watermarks(node_id)
                tampered = None
                if cfg.tamper_every and round_no % cfg.tamper_every == 0:
                    tampered = self._tamper_newest_snapshot(node_id)
                restart_ms = self.cluster.clock()
                c.restart_broker(node_id)
                self.chaos.clear_exporter_watermarks(node_id)
                self._await_recovery(round_no)
                self._check_recovery(round_no, tampered, debt_at_crash,
                                     appends_per_period)
                self._collect_flight_dumps(round_no, node_id, restart_ms)
            # drain: fire remaining timers, wake remaining message waits
            self.chaos.quiesce(60)
            self._check_acked_completeness()
            self.chaos.check_exactly_once_materialization(cfg.partition_id)
            self.violations.extend(self.chaos.violations)
            self.violations.extend(self.sink.violations)
            self.snapshot_kinds = self._snapshot_kind_counts()
            return self.report()
        finally:
            self.chaos.close()

    def report(self) -> dict:
        recoveries = self.recoveries
        durations = [r["durationMs"] for r in recoveries]
        return {
            "seed": self.cfg.seed,
            "rounds": self.cfg.rounds,
            "restarts": len(recoveries),
            "ackedCommands": len(self.acked),
            "exports": {
                "total": self.sink.total_exports,
                "unique": len(self.sink.by_position),
                "reexports": self.sink.reexports,
            },
            "recoveries": recoveries,
            "recoveryMs": {
                "max": max(durations, default=0.0),
                "mean": (sum(durations) / len(durations)) if durations else 0.0,
            },
            "budgetMs": self.cfg.recovery_budget_ms,
            "withinBudget": all(r["withinBudget"] for r in recoveries),
            "maxChainLength": self.max_chain_len,
            "snapshotKinds": self.snapshot_kinds,
            "flightDumps": self.flight_dumps,
            "violations": self.violations,
        }
    # end of the copy


def run_soak(cfg: SoakConfig | None = None,
             directory: str | Path | None = None, device=None) -> dict:
    """One-call entry point (bench.py --soak, tests)."""
    return SoakHarness(cfg, directory=directory, device=device).run()


if __name__ == "__main__":  # pragma: no cover — manual
    # python -m zeebe_tpu_torch.testing.soak [--quick] [--seed N] [--device cpu]:
    # the CI short mode with --quick, else bench.py's full soak
    import sys

    from zeebe_tpu_torch.testing.serving import gate_cli_main

    sys.exit(gate_cli_main(
        "zeebe-tpu-soak", SoakConfig(),
        SoakConfig(rounds=10, traffic_per_round=40, snapshot_chain_length=6), run_soak))
