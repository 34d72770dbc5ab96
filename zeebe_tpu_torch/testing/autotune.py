"""Autotune A/B gate: adaptive broker vs a fixed-knob panel.

The acceptance harness for the closed-loop control plane, built on the
serving gate's open-loop machinery: the SAME seeded bursty Poisson arrival schedule
(calm → burst → calm, dispatched by concurrent client streams against the
real supervised multi-process TCP cluster, latency measured from the
SCHEDULED arrival) is offered to every arm at equal load:

- ``adaptive``           — ``ZEEBE_CONTROL_ENABLED=1``: the controllers
  steer the ingress coalescing window and the raft group-commit pacing
  live (plus tiering/routing, idle in this workload);
- ``default``            — the plane off, every knob at its shipped
  default (per-append fsync, no coalescing);
- ``journal-aggressive`` — per-append fsync AND a tiny unflushed-byte
  bound (drain per append);
- ``journal-conservative`` — a fixed 50ms group-commit delay (every ack
  waits for a wide barrier, calm traffic included);
- ``coalesce-small`` / ``coalesce-large`` — fixed 1ms / 75ms ingress
  coalescing windows (the brackets around the plausible range; the
  adaptive cap sits at 25ms between them).

Gates (AUTOTUNE[_quick].json):

1. **p99**: the adaptive arm beats EVERY fixed arm on acked p99 latency;
2. **goodput**: adaptive acked/s within ``goodput_band`` of the best
   fixed arm;
3. **zero acked loss** in every arm, via the offline journal readers
   (every acked request appears exactly once in the committed log);
4. **audit**: every adjustment is a ``control_adjust`` flight event (read
   back from the workers' dumps) and every actuated knob stayed provably
   inside its declared bounds (``minSeen``/``maxSeen`` vs ``min``/``max``
   from the single-write-path actuator snapshots).

The port's gate is a partial copy of the reference's: its config takes the
workers' kernel backend ``device`` and ``run_arm`` gives it to every
``worker_cmd`` (``--device``; None runs the workers on the card,
``"cpu"`` on the plain version) in place of the reference's
``JAX_PLATFORMS=cpu``. The rest is the reference's, copied.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue
import random
import sys
import threading
import time
from pathlib import Path
from typing import Any

from zeebe_tpu_torch.testing.serving import (
    ServingOp,
    check_serving_history,
    execute_op,
    gate_cli_main,
    poisson_schedule,
)

# copied from the reference: logger .. logger
logger = logging.getLogger("zeebe_tpu_torch.testing.autotune")
# end of the copy


@dataclasses.dataclass
class AutotuneConfig:
    seed: int = 0
    workers: int = 2
    partitions: int = 2
    replication: int = 2
    client_streams: int = 48
    #: offered arrival rates (total across partitions), requests/s
    calm_rate: float = 40.0
    burst_rate: float = 160.0
    phase_calm_s: float = 3.0
    phase_burst_s: float = 8.0
    phase_tail_s: float = 3.0
    #: rounds per arm, round-robin (the interleave discipline): each
    #: arm's gated p99 is its BEST round — a background-load spike on the
    #: shared box pollutes one round, not the verdict
    rounds: int = 2
    request_timeout_s: float = 12.0
    #: adaptive goodput must stay within this band of the best fixed arm
    goodput_band: float = 0.05
    #: faster sensing + control convergence for the short quick drive
    #: (identical for every arm — the A/B compares knob POSTURES, not
    #: sampling cadences)
    metrics_sampling_ms: int = 100
    control_interval_ms: int = 100
    boot_timeout_s: float = 180.0
    kernel_backend: bool = False
    #: the workers' kernel backend device (``--device``): None runs them on
    #: the card, ``"cpu"`` on the plain version
    device: str | None = None


# copied from the reference: FULL_CONFIG .. evaluate_arms
FULL_CONFIG = AutotuneConfig(
    workers=3, partitions=3, replication=3, client_streams=128,
    calm_rate=80.0, burst_rate=320.0,
    phase_calm_s=10.0, phase_burst_s=30.0, phase_tail_s=10.0, rounds=3)


def fixed_panel() -> dict[str, dict[str, str]]:
    """The fixed-knob arms (every one runs with the control plane OFF)."""
    return {
        "default": {},
        "journal-aggressive": {
            "ZEEBE_BROKER_DATA_LOGFLUSHDELAYMS": "0",
            "ZEEBE_BROKER_DATA_LOGMAXUNFLUSHEDBYTES": str(64 * 1024),
        },
        "journal-conservative": {
            "ZEEBE_BROKER_DATA_LOGFLUSHDELAYMS": "50",
        },
        "coalesce-small": {
            "ZEEBE_BROKER_PROCESSING_COALESCEWINDOWMS": "1",
        },
        "coalesce-large": {
            "ZEEBE_BROKER_PROCESSING_COALESCEWINDOWMS": "75",
        },
    }


def build_schedule(cfg: AutotuneConfig) -> list[float]:
    """The bursty open-loop arrival schedule (seconds), IDENTICAL for
    every arm: calm -> burst -> calm, seeded non-homogeneous Poisson."""
    drive_s = cfg.phase_calm_s + cfg.phase_burst_s + cfg.phase_tail_s

    def rate(t: float) -> float:
        if t < cfg.phase_calm_s:
            return cfg.calm_rate
        if t < cfg.phase_calm_s + cfg.phase_burst_s:
            return cfg.burst_rate
        return cfg.calm_rate

    rng = random.Random(cfg.seed << 4 | 0xA)
    return poisson_schedule(rng, drive_s, rate,
                            max(cfg.calm_rate, cfg.burst_rate))


# ---------------------------------------------------------------------------
# offline control-audit evidence (pure over dump payloads — unit-testable)


#: the PLANE's own loops — the A/B evidence counts only these. The
#: admission shed ladder and snapshot scheduler also emit control_adjust,
#: but they run with the plane disabled too: counting them would flunk a
#: fixed arm whose ladder fired (false positive) and could satisfy the
#: adaptive arm's audit gate without the plane adjusting anything (false
#: negative).
PLANE_CONTROLLERS = frozenset({
    "ingress-coalescing", "journal-flush", "state-tiering",
    "kernel-routing",
})


def control_evidence(dumps: list[dict]) -> dict:
    """Aggregate the control audit trail from one arm's flight dumps:
    the PLANE controllers' control_adjust events (deduplicated across
    overlapping ring snapshots) and, from the NEWEST dump's ``control``
    context block, the per-actuator bounds verdict."""
    events: dict[tuple, dict] = {}
    newest_control: tuple[int, dict] | None = None
    for dump in dumps:
        for ring in dump.get("partitions", {}).values():
            for event in ring:
                if event.get("kind") != "control_adjust":
                    continue
                if event.get("controller") not in PLANE_CONTROLLERS:
                    continue
                key = (event.get("t"), event.get("controller"),
                       event.get("knob"), event.get("before"),
                       event.get("after"))
                events[key] = event
        control = dump.get("control")
        if control is not None:
            at = dump.get("dumpedAtMs", 0)
            if newest_control is None or at >= newest_control[0]:
                newest_control = (at, control)
    adjusts = sorted(events.values(), key=lambda e: e.get("t", 0))
    out: dict[str, Any] = {
        "controlAdjustEvents": len(adjusts),
        "byController": {},
        "knobsWithinBounds": None,
        "boundsViolations": [],
    }
    for event in adjusts:
        out["byController"].setdefault(event.get("controller", "?"), 0)
        out["byController"][event.get("controller", "?")] += 1
    if newest_control is not None:
        violations = []
        actuators = []
        for name, ctl in newest_control[1].get("controllers", {}).items():
            for act in ctl.get("actuators", []):
                actuators.append({**act, "controller": name})
                if not (act["min"] <= act["minSeen"]
                        and act["maxSeen"] <= act["max"]):
                    violations.append(
                        f"{name}/{act['knob']}: seen "
                        f"[{act['minSeen']}, {act['maxSeen']}] outside "
                        f"declared [{act['min']}, {act['max']}]")
        out["knobsWithinBounds"] = not violations
        out["boundsViolations"] = violations
        out["actuators"] = actuators
    return out


def evaluate_arms(arms: dict[str, dict], cfg: AutotuneConfig) -> list[str]:
    """The autotune gates over finished arm reports (pure)."""
    violations: list[str] = []
    for name, arm in arms.items():
        for v in arm.get("violations", []):
            violations.append(f"arm {name}: {v}")
    adaptive = arms.get("adaptive")
    fixed = {k: v for k, v in arms.items() if k != "adaptive"}
    if adaptive is None or not fixed:
        return violations + ["autotune needs an adaptive arm and a panel"]
    a_p99 = adaptive["ackedLatency"].get("p99Ms")
    if a_p99 is None:
        return violations + ["adaptive arm acked nothing"]
    for name, arm in fixed.items():
        f_p99 = arm["ackedLatency"].get("p99Ms")
        if f_p99 is None:
            violations.append(f"fixed arm {name} acked nothing")
        elif a_p99 >= f_p99:
            violations.append(
                f"adaptive p99 {a_p99}ms does not beat fixed arm "
                f"{name} ({f_p99}ms)")
    best_goodput = max(arm["goodputPerSec"] for arm in fixed.values())
    if adaptive["goodputPerSec"] < (1.0 - cfg.goodput_band) * best_goodput:
        violations.append(
            f"adaptive goodput {adaptive['goodputPerSec']}/s under "
            f"{1.0 - cfg.goodput_band:.0%} of the best fixed arm "
            f"({best_goodput}/s)")
    control = adaptive.get("control", {})
    if not control.get("controlAdjustEvents"):
        violations.append(
            "adaptive arm recorded no control_adjust flight events — "
            "either the plane never adjusted or the audit trail is broken")
    if control.get("knobsWithinBounds") is not True:
        violations.append(
            "adaptive arm lacks the knob-bounds proof: "
            + ("; ".join(control.get("boundsViolations", []))
               or "no control snapshot in any flight dump"))
    for name, arm in fixed.items():
        if arm.get("control", {}).get("controlAdjustEvents", 0):
            violations.append(
                f"fixed arm {name} recorded control_adjust events with the "
                f"plane disabled (the A/B is not an A/B)")
    return violations
# end of the copy


# ---------------------------------------------------------------------------
# one arm = one supervised multi-process cluster + the shared schedule


def run_arm(name: str, env_overlay: dict[str, str], cfg: AutotuneConfig,
            directory: Path, schedule: list[float]) -> dict:
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
    from zeebe_tpu_torch.testing.consistency import collect_logs
    from zeebe_tpu_torch.testing.evidence import percentile

    directory = Path(directory)
    started = time.monotonic()
    violations: list[str] = []
    worker_names = [f"worker-{i}" for i in range(cfg.workers)]
    ports = _free_ports(cfg.workers + 1)
    contacts = {n: ("127.0.0.1", p) for n, p in zip(worker_names, ports)}
    contacts["gateway-0"] = ("127.0.0.1", ports[-1])
    contact_str = ",".join(
        f"{m}={h}:{p}" for m, (h, p) in sorted(contacts.items()))

    repo = str(Path(__file__).resolve().parent.parent.parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH")) if p)
    if not cfg.kernel_backend:
        env["ZEEBE_BROKER_EXPERIMENTAL_KERNELBACKEND"] = "false"
    # equal footing: the plane is explicitly OFF unless the arm turns it on
    env["ZEEBE_CONTROL_ENABLED"] = "0"
    env["ZEEBE_CONTROL_INTERVALMS"] = str(cfg.control_interval_ms)
    env["ZEEBE_BROKER_METRICS_SAMPLINGINTERVALMS"] = str(
        cfg.metrics_sampling_ms)
    env.update(env_overlay)

    specs = [WorkerSpec(
        node_id=wname,
        cmd=worker_cmd(wname, f"127.0.0.1:{contacts[wname][1]}", contact_str,
                       "gateway-0", cfg.partitions, cfg.replication,
                       data_dir=str(directory / wname),
                       device=cfg.device),
        data_dir=str(directory / wname)) for wname in worker_names]
    supervisor = WorkerSupervisor(specs, env=env, restart_backoff_s=0.2)
    runtime = MultiProcClusterRuntime(
        "gateway-0",
        {m: a for m, a in contacts.items() if m != "gateway-0"},
        partition_count=cfg.partitions, replication_factor=cfg.replication,
        bind=contacts["gateway-0"], supervisor=supervisor)

    history: list[ServingOp] = []
    history_lock = threading.Lock()
    op_seq = [0]
    drive_t0 = [0.0]

    def drive_ms() -> float:
        return (time.monotonic() - drive_t0[0]) * 1000.0

    def new_op(kind: str, partition: int, scheduled_ms: float) -> ServingOp:
        with history_lock:
            op_seq[0] += 1
            op = ServingOp(index=op_seq[0], tenant="t-auto", kind=kind,
                           partition=partition, scheduled_ms=scheduled_ms)
            history.append(op)
        return op

    def execute(op: ServingOp, record) -> ServingOp:
        return execute_op(runtime, op, record, cfg.request_timeout_s,
                          drive_ms)

    def create_cmd():
        return command(ValueType.PROCESS_INSTANCE_CREATION,
                       ProcessInstanceCreationIntent.CREATE,
                       {"bpmnProcessId": "auto", "version": -1,
                        "variables": {}, "tenantId": "t-auto"})

    arrivals: "queue.Queue[float | None]" = queue.Queue()
    stop_streams = threading.Event()

    def client_stream() -> None:
        while not stop_streams.is_set():
            try:
                item = arrivals.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is None:
                return
            op = new_op("create", runtime.partition_for_new_instance(),
                        item * 1000.0)
            execute(op, create_cmd())

    def scheduler() -> None:
        for at_s in schedule:
            delay = drive_t0[0] + at_s - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            if stop_streams.is_set():
                return
            arrivals.put(at_s)

    final_status: dict = {}
    try:
        runtime.start()
        boot_deadline = time.monotonic() + cfg.boot_timeout_s
        while True:
            try:
                runtime.await_leaders(timeout_s=5.0)
                break
            except RuntimeError:
                if time.monotonic() >= boot_deadline:
                    raise
        # warm: deploy + per-partition create probes (deployment
        # distribution must settle BEFORE the clock starts — warm cost is
        # identical across arms and not part of the A/B)
        drive_t0[0] = time.monotonic()
        model = (Bpmn.create_executable_process("auto")
                 .start_event("s").end_event("e").done())
        deploy = execute(
            new_op("deploy", 1, -1.0),
            command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {
                "resources": [{"resourceName": "auto.bpmn",
                               "resource": to_bpmn_xml(model)}],
                "tenantId": "t-auto"}))
        if deploy.outcome != "ack":
            raise RuntimeError(f"arm {name}: deploy failed: {deploy.row()}")
        for pid in range(1, cfg.partitions + 1):
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                probe = execute(new_op("create", pid, -1.0), create_cmd())
                if probe.outcome == "ack":
                    break
                time.sleep(0.25)
            else:
                raise RuntimeError(
                    f"arm {name}: partition {pid} never served a create; "
                    f"last probe: {probe.row()}")

        drive_t0[0] = time.monotonic()
        streams = [threading.Thread(target=client_stream, daemon=True,
                                    name=f"auto-stream-{i}")
                   for i in range(cfg.client_streams)]
        for t in streams:
            t.start()
        sched = threading.Thread(target=scheduler, daemon=True,
                                 name="autotune-scheduler")
        sched.start()
        drive_end = cfg.phase_calm_s + cfg.phase_burst_s + cfg.phase_tail_s
        remaining = drive_t0[0] + drive_end - time.monotonic()
        if remaining > 0:
            time.sleep(remaining)
        sched.join(timeout=10)
        drain_deadline = time.monotonic() + cfg.request_timeout_s + 10
        while time.monotonic() < drain_deadline and not arrivals.empty():
            time.sleep(0.2)
        for _ in streams:
            arrivals.put(None)
        join_by = time.monotonic() + cfg.request_timeout_s + 10
        for t in streams:
            t.join(timeout=max(join_by - time.monotonic(), 0.1))
        stop_streams.set()
        final_status = {w: dict(s)
                        for w, s in runtime._worker_status.items()}
    finally:
        stop_streams.set()
        try:
            runtime.stop()
        except Exception:  # noqa: BLE001 — teardown must reach evidence
            logger.exception("arm %s: runtime stop failed", name)

    # ---- offline evidence ---------------------------------------------------
    logs, log_violations = collect_logs(directory, worker_names,
                                        cfg.partitions)
    violations += log_violations
    violations += check_serving_history(history, logs)

    drive_ops = [op for op in history if op.scheduled_ms >= 0]
    acked = sorted(op.latency_ms for op in drive_ops
                   if op.outcome == "ack")
    outcomes: dict[str, int] = {}
    for op in drive_ops:
        outcomes[op.outcome] = outcomes.get(op.outcome, 0) + 1
    pending = outcomes.get("pending", 0)
    if pending:
        violations.append(f"{pending} op(s) never completed (silent drop)")
    drive_s = cfg.phase_calm_s + cfg.phase_burst_s + cfg.phase_tail_s

    dumps = []
    for path in sorted(directory.glob("*/flight-*.json")):
        try:
            dumps.append(json.loads(path.read_text()))
        except (OSError, ValueError):
            violations.append(f"unreadable flight dump {path}")
    report = {
        "arm": name,
        "envOverlay": env_overlay,
        "offered": len(drive_ops),
        "outcomes": outcomes,
        "ackedLatency": ({
            "count": len(acked),
            "p50Ms": round(percentile(acked, 0.50), 1),
            "p95Ms": round(percentile(acked, 0.95), 1),
            "p99Ms": round(percentile(acked, 0.99), 1),
            "maxMs": round(acked[-1], 1),
        } if acked else {"count": 0}),
        "goodputPerSec": round(len(acked) / drive_s, 2),
        "control": control_evidence(dumps),
        "flightDumps": [str(p) for p in
                        sorted(directory.glob("*/flight-*.json"))],
        "workerStatus": {
            w: {"control": s.get("control"), "admission": bool(s.get(
                "admission", {}).get("shedLevel", 0))}
            for w, s in final_status.items()},
        "violations": violations,
        "wallSeconds": round(time.monotonic() - started, 2),
    }
    return report


# copied from the reference: merge_rounds .. main
def merge_rounds(rounds: list[dict]) -> dict:
    """One arm's gated report from its rounds: the BEST round's latency
    (paired same-box discipline — a box-noise spike pollutes one round,
    not the verdict), the best round's goodput, every round's violations
    and audit evidence. Pure — unit-tested."""
    best = min(rounds,
               key=lambda r: r["ackedLatency"].get("p99Ms", float("inf")))
    control = {
        "controlAdjustEvents": sum(
            r["control"].get("controlAdjustEvents", 0) for r in rounds),
        "byController": {},
        # the bounds proof must hold in EVERY round, not just the best one
        "knobsWithinBounds": all(
            r["control"].get("knobsWithinBounds") in (True, None)
            for r in rounds) and any(
            r["control"].get("knobsWithinBounds") is True for r in rounds),
        "boundsViolations": [v for r in rounds
                             for v in r["control"].get(
                                 "boundsViolations", [])],
    }
    for r in rounds:
        for ctl, count in r["control"].get("byController", {}).items():
            control["byController"][ctl] = (
                control["byController"].get(ctl, 0) + count)
    outcomes: dict[str, int] = {}
    for r in rounds:
        for outcome, count in r["outcomes"].items():
            outcomes[outcome] = outcomes.get(outcome, 0) + count
    return {
        "arm": best["arm"],
        "envOverlay": best["envOverlay"],
        "rounds": len(rounds),
        "offered": sum(r["offered"] for r in rounds),
        "outcomes": outcomes,
        "ackedLatency": best["ackedLatency"],
        "p99MsByRound": [r["ackedLatency"].get("p99Ms") for r in rounds],
        "goodputPerSec": max(r["goodputPerSec"] for r in rounds),
        "control": control,
        "violations": [v for r in rounds for v in r["violations"]],
        "wallSeconds": round(sum(r["wallSeconds"] for r in rounds), 2),
        "roundReports": rounds,
    }


def run_autotune(cfg: AutotuneConfig, directory: str | Path) -> dict:
    """Every arm, round-robin over ``cfg.rounds`` rounds, always the SAME
    seeded schedule at equal offered load; then the gates."""
    directory = Path(directory)
    started = time.monotonic()
    schedule = build_schedule(cfg)
    panel = {"adaptive": {"ZEEBE_CONTROL_ENABLED": "1"}, **fixed_panel()}
    rounds: dict[str, list[dict]] = {name: [] for name in panel}
    for round_idx in range(max(cfg.rounds, 1)):
        for name, overlay in panel.items():
            arm_dir = directory / f"{name}-r{round_idx}"
            arm_dir.mkdir(parents=True, exist_ok=True)
            logger.warning(
                "autotune arm %s round %d starting (%d offered arrivals)",
                name, round_idx, len(schedule))
            rounds[name].append(
                run_arm(name, overlay, cfg, arm_dir, schedule))
    arms = {name: merge_rounds(reports)
            for name, reports in rounds.items()}
    violations = evaluate_arms(arms, cfg)
    return {
        "seed": cfg.seed,
        "workers": cfg.workers,
        "partitions": cfg.partitions,
        "replication": cfg.replication,
        "clientStreams": cfg.client_streams,
        "offeredArrivals": len(schedule),
        "phases": {"calmSeconds": cfg.phase_calm_s,
                   "burstSeconds": cfg.phase_burst_s,
                   "tailSeconds": cfg.phase_tail_s,
                   "calmRatePerSec": cfg.calm_rate,
                   "burstRatePerSec": cfg.burst_rate},
        "arms": arms,
        "summary": {
            name: {"p99Ms": arm["ackedLatency"].get("p99Ms"),
                   "goodputPerSec": arm["goodputPerSec"],
                   "controlAdjusts": arm["control"].get(
                       "controlAdjustEvents", 0)}
            for name, arm in arms.items()},
        "violations": violations,
        "wallSeconds": round(time.monotonic() - started, 2),
    }


def main(argv: list[str] | None = None) -> int:  # pragma: no cover — manual
    return gate_cli_main("zeebe-tpu-autotune", AutotuneConfig(), FULL_CONFIG,
                         run_autotune, argv)
# end of the copy


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
