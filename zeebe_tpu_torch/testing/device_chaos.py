"""The device-chaos gate: accelerator + kill chaos over the kernel path.

The torture gate proved delivery invariants when the disk lies;
this gate makes the thing the paper's kernel exists for — the device —
the liar, with the kernel backend LIVE in every worker. Real supervised
worker processes serve the Jepsen-shaped workload while
``ZEEBE_CHAOS_DEVICE`` injects compile failures, dispatch exceptions,
stalls (converted to typed wedges by the dispatch watchdog), partial-chunk
failures, and seeded bit-flips into fetched kernel results, and a
``kill_worker`` rides along. Shadow verification runs at rate 1.0 — the
exhaustive posture for the gate (production samples; the honest caveat in
docs/device-faults.md).

Two phases: a **survival window** (chaos armed — containment + detection +
the ladder's descent to QUARANTINED) and a **recovery window** (the disarm
file ends the chaos; canary dispatches must re-prove the device back to
HEALTHY while traffic keeps flowing).

Gates:

- **delivery invariants hold** — the checker (no acked loss in log
  AND export stream, no duplicate application, rejections terminal,
  positions monotone) plus replica CRC equality: a corrupted device
  result that reached the log would diverge replicas exactly here;
- **every configured device-fault class observed** (per-life counts
  snapshots) — configured-but-never-applied chaos is a violation;
- **every injected result corruption accounted**: each ledger ``inject``
  line needs a ``caught`` line (shadow mismatch or containment) from the
  same process life — wrong bytes provably never reached the commit path.
  An inject in the final moments of a life that verifiably DIED (pid
  absent at teardown) is waived — the carrying group died uncommitted
  with the process; lives that survived to disarm get no waiver;
- **≥ 1 full health-ladder cycle** — one worker life must walk
  HEALTHY→SUSPECT→QUARANTINED and return QUARANTINED→HEALTHY through
  verified canaries (evidence: the per-life device-health JSONL).

``bench.py --device-chaos [--quick]`` runs this and writes
DEVICE_CHAOS[_quick].json; the CI ``device-chaos-smoke`` job gates on it.

The port's gate is a partial copy of the reference's: its config takes the
workers' kernel backend ``device`` and ``run_device_chaos`` gives it to every
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
import sys
import threading
import time
from pathlib import Path
from typing import Any

from zeebe_tpu_torch.testing.chaos_common import read_jsonl_ledgers, sum_counts_files
from zeebe_tpu_torch.testing.chaos_device import DeviceFaultPlan, format_spec
from zeebe_tpu_torch.testing.consistency import (
    ClientOp,
    _await_exports,
    check_consistency,
    collect_exports,
    collect_logs,
    submit_client_op,
)

# copied from the reference: logger .. logger
logger = logging.getLogger("zeebe_tpu_torch.testing.device_chaos")
# end of the copy


@dataclasses.dataclass
class DeviceChaosConfig:
    seed: int = 0
    workers: int = 3
    partitions: int = 2
    replication: int = 3
    drive_seconds: float = 30.0
    #: fraction of the drive with chaos armed; the rest is the recovery
    #: window (canary ladder re-proving under live traffic)
    chaos_fraction: float = 0.6
    think_ms: float = 10.0
    request_timeout_s: float = 20.0
    kills: int = 1
    # device chaos rates — sized so every class fires with margin across
    # the pre-quarantine dispatches PLUS the ~4/s canary stream that keeps
    # rolling the dice while QUARANTINED (the gate REQUIRES a nonzero
    # observed count per configured class)
    compile_fail_p: float = 0.10
    dispatch_fail_p: float = 0.10
    stall_p: float = 0.10
    stall_ms: int = 900
    chunk_fail_p: float = 0.12
    corrupt_p: float = 0.18
    flips: int = 3
    #: watchdog well under stall_ms: every stall becomes a typed wedge and
    #: the pump pays the deadline, not the stall
    dispatch_timeout_ms: int = 450
    #: high enough that the pre-quarantine window carries every fault class
    #: at full dispatch rate with margin (after quarantine only the canary
    #: stream keeps rolling the dice)
    quarantine_faults: int = 8
    canary_interval_ms: int = 150
    canary_successes: int = 2
    reject_every: int = 25
    #: the workers' kernel backend device (``--device``): None runs them on
    #: the card, ``"cpu"`` on the plain version
    device: str | None = None


#: a kill that lands mid-group can orphan at most this trailing slice of a
#: life's corruption-ledger activity without failing the accounting
# copied from the reference: _DEATH_WAIVER_MS .. check_health_cycle
_DEATH_WAIVER_MS = 2_000.0


# ---------------------------------------------------------------------------
# offline verification (pure — unit-testable without a cluster)


def check_fault_classes(plan: DeviceFaultPlan,
                        counts: dict[str, int]) -> list[str]:
    """Every CONFIGURED device-fault class must have a nonzero observed
    count aggregated across every worker life."""
    violations = []
    for fault_class in plan.configured_classes():
        if not counts.get(fault_class):
            violations.append(
                f"device-fault class `{fault_class}` configured but never "
                f"observed (0 applied across every worker life) — the "
                f"chaos plane is not reaching the dispatch seam")
    return violations


def check_corruption_accounting(
        entries: list[dict],
        dead_pids: set | None = None) -> tuple[list[str], dict]:
    """Join ``inject`` lines against ``caught`` lines per process life.
    An inject with no catch means corrupt bytes were decoded and allowed
    toward the commit path — a violation, unless the life actually DIED
    (``dead_pids``: pids not alive at teardown — chaos-killed or crashed)
    and the inject sits in the final moments of its ledger (SIGKILL
    mid-group: the carrying group's transaction died with the process and
    replay excludes it). A life that survived to disarm gets no waiver —
    it had every chance to report the catch, and waiving its tail would
    green-light a detection bug in the last seconds of the armed window."""
    violations: list[str] = []
    stats = {"injected": 0, "caughtShadow": 0, "caughtContained": 0,
             "waivedByDeath": 0}
    dead_pids = dead_pids or set()
    by_life: dict[tuple, list[dict]] = {}
    for entry in entries:
        by_life.setdefault((entry.get("member"), entry.get("pid")),
                           []).append(entry)
    for (member, pid), rows in by_life.items():
        caught_by_seq: dict[int, str] = {}
        last_ms = max((r.get("atMs", 0.0) for r in rows), default=0.0)
        for row in rows:
            if row.get("kind") == "caught":
                caught_by_seq[row["seq"]] = row.get("how", "?")
        for row in rows:
            if row.get("kind") != "inject":
                continue
            stats["injected"] += 1
            how = caught_by_seq.get(row["seq"])
            if how == "shadow":
                stats["caughtShadow"] += 1
            elif how is not None:
                stats["caughtContained"] += 1
            elif (pid in dead_pids
                  and last_ms - row.get("atMs", 0.0) <= _DEATH_WAIVER_MS):
                # the life died and its ledger ends right here: killed
                # mid-group, the carrying transaction died with it
                stats["waivedByDeath"] += 1
            else:
                violations.append(
                    f"injected result corruption seq {row['seq']} on "
                    f"{member} (pid {pid}) was never caught — corrupt "
                    f"device output reached the commit path unverified")
    return violations, stats


def check_health_cycle(transitions: list[dict]) -> tuple[list[str], dict]:
    """≥1 process life must complete the full ladder cycle:
    HEALTHY→SUSPECT, →QUARANTINED, and QUARANTINED→HEALTHY via canaries."""
    by_pid: dict[Any, list[dict]] = {}
    for t in transitions:
        by_pid.setdefault(t.get("pid"), []).append(t)
    cycles = 0
    suspects = quarantines = recoveries = 0
    for pid, rows in by_pid.items():
        rows.sort(key=lambda r: r.get("atMs", 0.0))
        saw_suspect = saw_quarantine = False
        completed = False
        for row in rows:
            if row.get("to") == "SUSPECT":
                saw_suspect = True
                suspects += 1
            elif row.get("to") == "QUARANTINED":
                quarantines += 1
                if saw_suspect:
                    saw_quarantine = True
            elif (row.get("to") == "HEALTHY"
                  and row.get("from") == "QUARANTINED"):
                recoveries += 1
                if saw_quarantine and "canary" in row.get("reason", ""):
                    completed = True
        if completed:
            cycles += 1
    stats = {"lives": len(by_pid), "suspectTransitions": suspects,
             "quarantineTransitions": quarantines,
             "quarantineRecoveries": recoveries, "fullCycles": cycles}
    violations = []
    if cycles < 1:
        violations.append(
            "no worker life completed the full device health cycle "
            "SUSPECT→QUARANTINED→canary→HEALTHY — the recovery ladder is "
            f"unproven ({stats})")
    return violations, stats
# end of the copy


# ---------------------------------------------------------------------------
# the harness


def run_device_chaos(cfg: DeviceChaosConfig, directory: str | Path) -> dict:
    """Run the full device-chaos gate; returns the report dict."""
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

    plan = DeviceFaultPlan(
        seed=cfg.seed, compile_fail_p=cfg.compile_fail_p,
        dispatch_fail_p=cfg.dispatch_fail_p, stall_p=cfg.stall_p,
        stall_ms=cfg.stall_ms, chunk_fail_p=cfg.chunk_fail_p,
        corrupt_p=cfg.corrupt_p, flips=cfg.flips)
    disarm_file = directory / "device-chaos-disarm"

    repo = str(Path(__file__).resolve().parent.parent.parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH")) if p)
    # the whole point: the kernel backend is LIVE in every worker — on the
    # DIRECT dispatch path (the seam under test); mesh dispatch has its own
    # killable probe and would otherwise auto-activate under
    # bench.py's inherited 8-virtual-device XLA_FLAGS
    env["ZEEBE_BROKER_EXPERIMENTAL_KERNELBACKEND"] = "true"
    env["ZEEBE_BROKER_EXPERIMENTAL_KERNELMESHSHARDS"] = "0"
    env["ZEEBE_CHAOS_DEVICE"] = format_spec(plan)
    env["ZEEBE_CHAOS_DEVICE_DISARMFILE"] = str(disarm_file)
    # exhaustive detection for the gate: EVERY group shadow-verified, so
    # every injected corruption must be caught before commit
    env["ZEEBE_BROKER_DEVICE_SHADOWSAMPLERATE"] = "1.0"
    env["ZEEBE_BROKER_DEVICE_DISPATCHTIMEOUTMS"] = str(
        cfg.dispatch_timeout_ms)
    env["ZEEBE_BROKER_DEVICE_QUARANTINEFAULTS"] = str(cfg.quarantine_faults)
    env["ZEEBE_BROKER_DEVICE_FAULTWINDOWMS"] = "600000"
    # SUSPECT must escalate (not quietly clear) during the survival window
    env["ZEEBE_BROKER_DEVICE_SUSPECTCLEARMS"] = "600000"
    env["ZEEBE_BROKER_DEVICE_CANARYINTERVALMS"] = str(cfg.canary_interval_ms)
    env["ZEEBE_BROKER_DEVICE_CANARYSUCCESSES"] = str(cfg.canary_successes)
    env["ZEEBE_BROKER_EXPORTERS_DEVCHAOS_CLASSNAME"] = \
        "zeebe_tpu_torch.testing.consistency.JsonlExporter"
    env["ZEEBE_BROKER_EXPORTERS_DEVCHAOS_ARGS_DIR"] = str(export_dir)

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
    surviving_pids: set = set()

    def clock_ms() -> float:
        return time.time() * 1000.0 - epoch_ms

    def submit_op(partition: int, kind: str, record) -> ClientOp:
        return submit_client_op(
            runtime, partition, kind, record, history=history,
            history_lock=history_lock, op_seq=op_seq, clock_ms=clock_ms,
            timeout_s=cfg.request_timeout_s)

    model = (Bpmn.create_executable_process("devchaos")
             .start_event("s").end_event("e").done())
    deploy = command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {
        "resources": [{"resourceName": "devchaos.bpmn",
                       "resource": to_bpmn_xml(model)}]})

    def create_cmd(process_id: str = "devchaos"):
        return command(ValueType.PROCESS_INSTANCE_CREATION,
                       ProcessInstanceCreationIntent.CREATE,
                       {"bpmnProcessId": process_id, "version": -1,
                        "variables": {}})

    stop_driving = threading.Event()

    def drive(partition: int) -> None:
        n = 0
        while not stop_driving.is_set():
            n += 1
            if cfg.reject_every and n % cfg.reject_every == 0:
                submit_op(partition, "create-missing",
                          create_cmd("no-such-process"))
            else:
                submit_op(partition, "create", create_cmd())
            time.sleep(cfg.think_ms / 1000.0)

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
        chaos_window = cfg.chaos_fraction * cfg.drive_seconds
        drivers = [threading.Thread(target=drive, args=(pid,), daemon=True,
                                    name=f"driver-{pid}")
                   for pid in range(1, cfg.partitions + 1)]
        for t in drivers:
            t.start()
        # kills land EARLY in the survival window so post-kill leader lives
        # span quarantine AND recovery (the full-cycle evidence)
        for _ in range(cfg.kills):
            at = rng.uniform(0.1, 0.35) * chaos_window
            delay = drive_started + at - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            target = worker_names[rng.randrange(len(worker_names))]
            logger.warning("device chaos: kill %s at t=%.1fs", target, at)
            events.append({"atMs": clock_ms(), "action": "kill",
                           "target": target})
            supervisor.kill_worker(target)
        remaining = drive_started + chaos_window - time.monotonic()
        if remaining > 0:
            time.sleep(remaining)
        # recovery window: device honest again; canaries re-prove it while
        # the drivers keep the kernel path under load
        disarm_file.write_text("disarm\n", encoding="utf-8")
        events.append({"atMs": clock_ms(), "action": "disarm"})
        remaining = drive_started + cfg.drive_seconds - time.monotonic()
        if remaining > 0:
            time.sleep(remaining)
        stop_driving.set()
        for t in drivers:
            t.join(timeout=cfg.request_timeout_s + 10)

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
        # lives alive at teardown: the death waiver in the corruption
        # accounting applies ONLY to pids absent from this set
        surviving_pids.update(
            p for n in worker_names
            if (p := supervisor.pid_of(n)) is not None)
    finally:
        try:
            runtime.stop()
        except Exception:  # noqa: BLE001 — teardown must reach evidence
            logger.exception("runtime stop failed")

    # ---- offline evidence + checks ----------------------------------------
    logs, violations = collect_logs(directory, worker_names, cfg.partitions)
    exports, export_violations, re_exports = collect_exports(export_dir)
    violations += export_violations
    violations += check_consistency(history, logs, exports)

    device_counts = sum_counts_files(
        sorted(directory.glob("*/device-chaos-counts-*.json")))
    corrupt_entries = read_jsonl_ledgers(
        sorted(directory.glob("*/device-corrupt-*.jsonl")))
    # the ledger is flushed per line; the counts snapshot is throttled and
    # a SIGKILL can lose its tail — the ledger is authoritative for corrupt
    injected = sum(1 for e in corrupt_entries if e.get("kind") == "inject")
    device_counts["corrupt"] = max(device_counts.get("corrupt", 0), injected)
    violations += check_fault_classes(plan, device_counts)
    dead_pids = {e.get("pid") for e in corrupt_entries} - surviving_pids
    corruption_violations, corruption_stats = check_corruption_accounting(
        corrupt_entries, dead_pids=dead_pids)
    violations += corruption_violations
    if injected and not corruption_stats["caughtShadow"]:
        violations.append(
            "result corruptions were injected but not one was caught by "
            "shadow verification — the detection layer is not engaging")

    health_transitions = read_jsonl_ledgers(
        sorted(directory.glob("*/device-health-*.jsonl")))
    cycle_violations, cycle_stats = check_health_cycle(health_transitions)
    violations += cycle_violations

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
        "deviceChaosSpec": format_spec(plan),
        "deviceFaultsObserved": device_counts,
        "corruptionAccounting": corruption_stats,
        "healthCycle": cycle_stats,
        "healthTransitions": health_transitions[:64],
        "reExportedRecords": re_exports,
        "logRecords": {str(p): len(r) for p, r in logs.items()},
        "exportedPositions": {str(p): len(v) for p, v in exports.items()},
        "violations": violations,
        "wallSeconds": round(time.monotonic() - started, 2),
    })
    return report


# copied from the reference: main .. main
def main(argv: list[str] | None = None) -> int:  # pragma: no cover — manual
    from zeebe_tpu_torch.testing.serving import gate_cli_main

    return gate_cli_main(
        "zeebe-tpu-device-chaos", DeviceChaosConfig(),
        DeviceChaosConfig(drive_seconds=90.0, kills=3), run_device_chaos,
        argv)
# end of the copy


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
