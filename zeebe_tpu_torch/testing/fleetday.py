"""The fleet-day gate: everything at once, with the auditor watching
(ROADMAP item 4).

Every earlier gate proves one adversary at a time in ≤2 minutes.
Production is all of them at once for hours: the open-loop multi-tenant
serving workload with diurnal ramps, tiered state under
park/spill pressure, ALL THREE chaos planes armed at background
rates (TCP / disk / device, via ``chaos_common``), live definition churn
(new process versions deployed mid-traffic), and rolling worker restarts
— while the per-worker **fleet auditor** (``observability/auditor.py``)
watches invariants, burn rates, and resource trends ONLINE.

Gates:

- **the offline checker holds**: every acked request appears exactly
  once in its partition's committed log (no acked loss, no duplicate
  application), plus the export-stream gap checks;
- **SLOs hold outside declared incident windows**: each rolling restart
  declares ``[kill, kill + grace]``; acked latency p50/p99 over requests
  scheduled OUTSIDE those windows must meet the SLO, and the terminal-ack
  fraction must clear the goodput floor;
- **≥1 chaos event per plane observed** (summed per-life counts files) —
  an armed-but-silent plane is a violation;
- **every injected device corruption accounted** (ledger join, reusing
  the checker with the death waiver for restart-killed lives);
- **zero leak verdicts on the clean fleet** — and a separate
  **leak-injection arm** (a worker deliberately leaking fds via
  ``ZEEBE_AUDIT_TESTLEAK``) where the auditor MUST return a leak verdict:
  detector recall proven in both directions, with identical knobs;
- **auditor recall 100%**: any violation class the offline checker finds
  that the online auditor did not flag fails the gate — the auditor's
  recall is measured, not assumed (on a clean run this is vacuously 100%,
  which the leak arm keeps honest).

``bench.py --fleetday [--quick]`` runs this and writes
``FLEETDAY[_quick].json``; the CI ``fleetday-smoke`` job gates on it.
Honest caveat (docs/fleetday.md): the quick gate is minutes, not hours —
it proves the composition and the auditor's recall, not day-scale drift.

The port's gate is a partial copy of the reference's: its config takes the
workers' kernel backend ``device`` and each of ``run_fleetday`` and ``run_leak_arm`` gives it to every
``worker_cmd`` (``--device``; None runs the workers on the card,
``"cpu"`` on the plain version) in place of the reference's
``JAX_PLATFORMS=cpu``. The rest is the reference's, copied.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import random
import sys
import threading
import time
from pathlib import Path
from typing import Any

from zeebe_tpu_torch.observability.auditor import ClusterAuditor
from zeebe_tpu_torch.testing.chaos import FaultPlan
from zeebe_tpu_torch.testing.chaos_common import read_jsonl_ledgers, sum_counts_files
from zeebe_tpu_torch.testing.chaos_device import DeviceFaultPlan
from zeebe_tpu_torch.testing.chaos_device import format_spec as device_spec
from zeebe_tpu_torch.testing.chaos_disk import DiskFaultPlan
from zeebe_tpu_torch.testing.chaos_disk import format_spec as disk_spec
from zeebe_tpu_torch.testing.chaos_tcp import format_spec as tcp_spec
from zeebe_tpu_torch.testing.device_chaos import check_corruption_accounting
from zeebe_tpu_torch.testing.evidence import percentile
from zeebe_tpu_torch.testing.serving import (
    ServingOp,
    TenantSpec,
    check_serving_history,
    drain_arrival_queue,
    execute_op,
    poisson_schedule,
    tenant_rate_fn,
)

# copied from the reference: logger .. _default_tenants
logger = logging.getLogger("zeebe_tpu_torch.testing.fleetday")


def _default_tenants() -> list[TenantSpec]:
    return [
        # the default tenant is the kernel's traffic: non-default tenants
        # ride the sequential host path by design (kernel_backend lowers
        # default-tenant record shapes only), so without this slice the
        # device chaos plane would never see a dispatch
        TenantSpec("<default>", "well", 10.0, 10.0, quota_rate=40.0),
        TenantSpec("t-well-0", "well", 5.0, 5.0, quota_rate=20.0),
        # the diurnal tenant: calm through the first shoulder, ~3x after
        TenantSpec("t-diurnal", "well", 4.0, 12.0, quota_rate=30.0),
    ]
# end of the copy


@dataclasses.dataclass
class FleetDayConfig:
    seed: int = 0
    workers: int = 3
    partitions: int = 2
    replication: int = 3
    client_streams: int = 96
    drive_seconds: float = 32.0
    #: diurnal shoulder: first fraction of the drive is calm, then a ramp
    calm_fraction: float = 0.35
    ramp_seconds: float = 4.0
    request_timeout_s: float = 15.0
    tenants: list[TenantSpec] = dataclasses.field(
        default_factory=_default_tenants)
    # tiered million-instance stand-in: a parked pool spilled cold,
    # woken mid-drive by a correlation burst
    parked_instances: int = 60
    storm_publishes: int = 25
    park_after_ms: int = 500
    spill_batch: int = 64
    park_wait_s: float = 20.0
    park_fraction: float = 0.25
    #: live definition churn: serve-model redeployments spread mid-drive
    churn_deploys: int = 2
    #: rolling restarts: sequential worker kills, each declaring an
    #: incident window of ``incident_grace_s``
    rolling_restarts: int = 1
    incident_grace_s: float = 10.0
    # -- SLO gates (outside incident windows) --------------------------------
    slo_p50_ms: float = 1500.0
    slo_p99_ms: float = 6000.0
    goodput_floor: float = 0.7
    # -- chaos background rates (all three planes, low) ----------------------
    tcp_drop_p: float = 0.01
    tcp_dup_p: float = 0.01
    tcp_delay_p: float = 0.10
    tcp_reorder_p: float = 0.02
    tcp_max_delay_ticks: int = 2
    disk_fsync_stall_p: float = 0.06
    disk_stall_ms: int = 40
    device_compile_fail_p: float = 0.02
    device_dispatch_fail_p: float = 0.06
    device_chunk_fail_p: float = 0.04
    device_corrupt_p: float = 0.04
    device_flips: int = 2
    # -- auditor knobs for the gate (shrunk to fit minutes) ------------------
    audit_fast_ms: int = 10_000
    audit_slow_ms: int = 40_000
    audit_leak_ms: int = 15_000
    audit_warmup_ms: int = 8_000
    audit_min_growth: float = 0.3
    # -- the leak-injection arm ----------------------------------------------
    leak_arm_seconds: float = 30.0
    leak_spec: str = "fd:25"
    #: the workers' kernel backend device (``--device``): None runs them on
    #: the card, ``"cpu"`` on the plain version
    device: str | None = None


# copied from the reference: FULL_FLEETDAY .. _audit_env
FULL_FLEETDAY = FleetDayConfig(
    workers=4, partitions=3, client_streams=256,
    drive_seconds=900.0, ramp_seconds=60.0,
    parked_instances=400, storm_publishes=150,
    churn_deploys=6, rolling_restarts=4, incident_grace_s=20.0,
    audit_fast_ms=60_000, audit_slow_ms=600_000, audit_leak_ms=120_000,
    audit_warmup_ms=60_000, leak_arm_seconds=90.0,
    tenants=[
        TenantSpec("<default>", "well", 20.0, 20.0, quota_rate=60.0),
        TenantSpec("t-well-0", "well", 10.0, 10.0, quota_rate=40.0),
        TenantSpec("t-well-1", "well", 10.0, 10.0, quota_rate=40.0),
        TenantSpec("t-diurnal", "well", 8.0, 30.0, quota_rate=60.0),
    ])


# ---------------------------------------------------------------------------
# pure helpers (unit-testable without a cluster)


def incident_windows(events: list[dict], grace_ms: float
                     ) -> list[tuple[float, float]]:
    """Declared incident windows from the harness event log: each rolling
    restart opens ``[atMs, atMs + grace]`` on the drive clock."""
    return [(e["atMs"], e["atMs"] + grace_ms)
            for e in events if e.get("action") in ("kill", "restart")]


def outside_incidents(at_ms: float,
                      windows: list[tuple[float, float]]) -> bool:
    return all(not (lo <= at_ms <= hi) for lo, hi in windows)


def evaluate_fleet_slo(history: list[ServingOp],
                       windows: list[tuple[float, float]],
                       cfg: FleetDayConfig) -> tuple[dict, list[str]]:
    """SLO + goodput over the drive, EXCLUDING requests scheduled inside a
    declared incident window (a rolling restart is allowed its re-election
    tail; steady state is not). Pure — tests drive it synthetically."""
    violations: list[str] = []
    clear = [op for op in history
             if op.scheduled_ms >= 0 and outside_incidents(
                 op.scheduled_ms, windows)]
    acked = [op for op in clear if op.outcome == "ack"]
    latencies = sorted(op.latency_ms for op in acked)
    report: dict[str, Any] = {
        "requestsOutsideIncidents": len(clear),
        "ackedOutsideIncidents": len(acked),
        "incidentWindows": [[round(a, 1), round(b, 1)] for a, b in windows],
    }
    if not latencies:
        violations.append("no acked requests outside incident windows — "
                          "no SLO evidence")
        return report, violations
    p50 = percentile(latencies, 0.50)
    p99 = percentile(latencies, 0.99)
    report["p50Ms"] = round(p50, 1)
    report["p99Ms"] = round(p99, 1)
    if p50 > cfg.slo_p50_ms:
        violations.append(
            f"fleet p50 outside incidents {p50:.0f}ms > SLO "
            f"{cfg.slo_p50_ms:.0f}ms")
    if p99 > cfg.slo_p99_ms:
        violations.append(
            f"fleet p99 outside incidents {p99:.0f}ms > SLO "
            f"{cfg.slo_p99_ms:.0f}ms")
    terminal = [op for op in clear if op.outcome != "pending"]
    good = len(acked) / len(terminal) if terminal else 0.0
    report["ackFraction"] = round(good, 4)
    if good < cfg.goodput_floor:
        violations.append(
            f"goodput outside incidents {good:.0%} < floor "
            f"{cfg.goodput_floor:.0%}")
    pending = [op for op in history if op.outcome == "pending"]
    if pending:
        violations.append(
            f"{len(pending)} request(s) never reached a terminal outcome "
            f"(silent drop)")
    return report, violations


#: offline violation text -> the online monitor class that should have
#: flagged it while the cluster ran (the recall join). Specific classes
#: first: the acked-position keywords include the generic "position",
#: which must not swallow exporter/CRC findings.
_RECALL_MAP = (
    (("export", "exporter"), "exporter_sequence"),
    (("crc", "diverge", "replica"), "replica_crc"),
    (("leak",), "resource_leak"),
    (("quarantin",), "quarantine_latch"),
    (("acked loss", "duplicate application", "moved backward",
      "appended", "position"), "acked_position"),
)


#: monitors whose online flags the offline checker can corroborate — a
#: flag on a run the offline evidence calls clean is a precision failure
INVARIANT_MONITORS = frozenset(
    {"acked_position", "exporter_sequence", "replica_crc",
     "quarantine_latch"})


def _monitor_of(violation_text: str) -> str | None:
    lowered = violation_text.lower()
    for keywords, name in _RECALL_MAP:
        if any(k in lowered for k in keywords):
            return name
    return None


def offline_monitors(offline_violations: list[str]) -> set:
    """Monitor classes the offline findings map onto."""
    return {m for m in map(_monitor_of, offline_violations)
            if m is not None}


def check_auditor_recall(offline_violations: list[str],
                         flagged_monitors: set
                         ) -> tuple[list[str], dict]:
    """The recall cross-check: every offline-found violation must map to
    an online monitor class that actually flagged during the run. Offline
    findings with no monitor mapping (e.g. a pure harness failure) are
    reported but do not count against recall."""
    misses: list[str] = []
    mapped = 0
    unmapped = 0
    for text in offline_violations:
        monitor = _monitor_of(text)
        if monitor is None:
            unmapped += 1
            continue
        mapped += 1
        if monitor not in flagged_monitors:
            misses.append(
                f"auditor recall miss: offline violation maps to monitor "
                f"`{monitor}` which never flagged online — {text[:160]}")
    stats = {
        "offlineViolations": len(offline_violations),
        "mappedToMonitors": mapped,
        "unmapped": unmapped,
        "onlineFlagged": sorted(flagged_monitors),
        "misses": len(misses),
        "recallPct": (100.0 if mapped == 0
                      else round(100.0 * (mapped - len(misses)) / mapped, 1)),
    }
    return misses, stats


def _audit_env(cfg: FleetDayConfig) -> dict[str, str]:
    return {
        "ZEEBE_AUDIT_ENABLED": "1",
        "ZEEBE_AUDIT_FASTWINDOWMS": str(cfg.audit_fast_ms),
        "ZEEBE_AUDIT_SLOWWINDOWMS": str(cfg.audit_slow_ms),
        "ZEEBE_AUDIT_LEAKWINDOWMS": str(cfg.audit_leak_ms),
        "ZEEBE_AUDIT_LEAKWARMUPMS": str(cfg.audit_warmup_ms),
        "ZEEBE_AUDIT_LEAKMINGROWTH": str(cfg.audit_min_growth),
        "ZEEBE_AUDIT_SLOP99MS": str(cfg.slo_p99_ms),
    }
# end of the copy


# ---------------------------------------------------------------------------
# the leak-injection arm (recall in the firing direction)


def run_leak_arm(cfg: FleetDayConfig, directory: Path) -> dict:
    """Boot ONE worker with ``ZEEBE_AUDIT_TESTLEAK`` armed and the SAME
    auditor knobs as the clean fleet; poll its status push until the
    online auditor returns a leak verdict. No traffic needed — the leak
    and the sampler both ride the worker's pump loop."""
    from zeebe_tpu_torch.multiproc.runtime import MultiProcClusterRuntime
    from zeebe_tpu_torch.multiproc.supervisor import (
        WorkerSpec,
        WorkerSupervisor,
        worker_cmd,
    )
    from zeebe_tpu_torch.standalone import _free_ports

    directory.mkdir(parents=True, exist_ok=True)
    ports = _free_ports(2)
    contacts = {"leaker-0": ("127.0.0.1", ports[0]),
                "gateway-0": ("127.0.0.1", ports[1])}
    contact_str = ",".join(
        f"{m}={h}:{p}" for m, (h, p) in sorted(contacts.items()))
    repo = str(Path(__file__).resolve().parent.parent.parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH")) if p)
    env["ZEEBE_BROKER_EXPERIMENTAL_KERNELBACKEND"] = "false"
    env.update(_audit_env(cfg))
    env["ZEEBE_AUDIT_TESTLEAK"] = cfg.leak_spec
    spec = WorkerSpec(
        node_id="leaker-0",
        cmd=worker_cmd("leaker-0", f"127.0.0.1:{contacts['leaker-0'][1]}",
                       contact_str, "gateway-0", 1, 1,
                       data_dir=str(directory / "leaker-0"),
                       device=cfg.device),
        data_dir=str(directory / "leaker-0"))
    supervisor = WorkerSupervisor([spec], env=env, restart_backoff_s=0.5)
    runtime = MultiProcClusterRuntime(
        "gateway-0", {"leaker-0": contacts["leaker-0"]},
        partition_count=1, replication_factor=1,
        bind=contacts["gateway-0"], supervisor=supervisor)
    result: dict[str, Any] = {"leakSpec": cfg.leak_spec, "fired": False}
    try:
        runtime.start()
        boot_deadline = time.monotonic() + 120.0
        while True:
            try:
                runtime.await_leaders(timeout_s=5.0)
                break
            except RuntimeError:
                if time.monotonic() >= boot_deadline:
                    raise
        deadline = time.monotonic() + cfg.leak_arm_seconds + 60.0
        while time.monotonic() < deadline:
            audit = runtime._worker_status.get("leaker-0", {}).get("audit")
            if isinstance(audit, dict):
                result["lastAudit"] = {
                    "leaks": audit.get("leaks", {}),
                    "leakVerdict": audit.get("leakVerdict"),
                    "violations": audit.get("violations", 0)}
                if audit.get("leakVerdict") == "leak":
                    result["fired"] = True
                    result["firedResources"] = [
                        name for name, v in audit.get("leaks", {}).items()
                        if v.get("state") == "leak"]
                    break
            time.sleep(0.5)
    finally:
        try:
            runtime.stop()
        except Exception:  # noqa: BLE001 — the arm must reach its verdict
            logger.exception("leak arm teardown failed")
    return result


# ---------------------------------------------------------------------------
# the harness


def run_fleetday(cfg: FleetDayConfig, directory: str | Path) -> dict:
    """Run the fleet-day gate; returns the report dict."""
    from zeebe_tpu_torch.gateway.admission import AdmissionCfg, AdmissionController
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
        MessageIntent,
        ProcessInstanceCreationIntent,
    )
    from zeebe_tpu_torch.protocol.record import command
    from zeebe_tpu_torch.standalone import _free_ports
    from zeebe_tpu_torch.testing.consistency import collect_exports, collect_logs

    directory = Path(directory)
    export_dir = directory / "exports"
    export_dir.mkdir(parents=True, exist_ok=True)
    started = time.monotonic()
    report: dict[str, Any] = {"seed": cfg.seed}
    violations: list[str] = []

    worker_names = [f"worker-{i}" for i in range(cfg.workers)]
    ports = _free_ports(cfg.workers + 1)
    contacts = {n: ("127.0.0.1", p) for n, p in zip(worker_names, ports)}
    contacts["gateway-0"] = ("127.0.0.1", ports[-1])
    contact_str = ",".join(
        f"{m}={h}:{p}" for m, (h, p) in sorted(contacts.items()))

    tcp_plan = FaultPlan(
        seed=cfg.seed, drop_p=cfg.tcp_drop_p, duplicate_p=cfg.tcp_dup_p,
        delay_p=cfg.tcp_delay_p, reorder_p=cfg.tcp_reorder_p,
        max_delay_ticks=cfg.tcp_max_delay_ticks)
    disk_plan = DiskFaultPlan(
        seed=cfg.seed, fsync_stall_p=cfg.disk_fsync_stall_p,
        stall_ms=cfg.disk_stall_ms)
    device_plan = DeviceFaultPlan(
        seed=cfg.seed, compile_fail_p=cfg.device_compile_fail_p,
        dispatch_fail_p=cfg.device_dispatch_fail_p,
        chunk_fail_p=cfg.device_chunk_fail_p,
        corrupt_p=cfg.device_corrupt_p, flips=cfg.device_flips)
    disk_disarm = directory / "disk-chaos-disarm"
    device_disarm = directory / "device-chaos-disarm"

    quota_spec = ",".join(
        f"{s.name}={s.quota_rate:g}"
        + (f":{s.quota_burst:g}" if s.quota_burst else "")
        for s in cfg.tenants if s.quota_rate > 0)
    repo = str(Path(__file__).resolve().parent.parent.parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH")) if p)
    # the device plane needs the kernel backend LIVE (the direct dispatch
    # path is the seam); mesh dispatch pinned off as in the device gate
    env["ZEEBE_BROKER_EXPERIMENTAL_KERNELBACKEND"] = "true"
    env["ZEEBE_BROKER_EXPERIMENTAL_KERNELMESHSHARDS"] = "0"
    env["ZEEBE_GATEWAY_TENANT_QUOTAS"] = quota_spec
    env["ZEEBE_BROKER_DATA_TIERING_ENABLED"] = "true"
    env["ZEEBE_BROKER_DATA_TIERING_PARKAFTERMS"] = str(cfg.park_after_ms)
    env["ZEEBE_BROKER_DATA_TIERING_SPILLBATCH"] = str(cfg.spill_batch)
    # all three chaos planes at background rates
    env["ZEEBE_CHAOS_TCP"] = tcp_spec(tcp_plan)
    env["ZEEBE_CHAOS_EPOCH_MS"] = str(time.time() * 1000.0)
    env["ZEEBE_CHAOS_DISK"] = disk_spec(disk_plan)
    env["ZEEBE_CHAOS_DISK_DISARMFILE"] = str(disk_disarm)
    env["ZEEBE_CHAOS_DEVICE"] = device_spec(device_plan)
    env["ZEEBE_CHAOS_DEVICE_DISARMFILE"] = str(device_disarm)
    # exhaustive shadow verification: every injected corruption must be
    # caught before commit (the accounting gate below joins the ledger)
    env["ZEEBE_BROKER_DEVICE_SHADOWSAMPLERATE"] = "1.0"
    # background-rate posture: the ladder should tolerate the background
    # fault trickle without quarantining mid-gate (quarantine is the device
    # gate's business; here it would just sink goodput)
    env["ZEEBE_BROKER_DEVICE_QUARANTINEFAULTS"] = "200"
    env.update(_audit_env(cfg))
    env["ZEEBE_BROKER_EXPORTERS_FLEETDAY_CLASSNAME"] = \
        "zeebe_tpu_torch.testing.consistency.JsonlExporter"
    env["ZEEBE_BROKER_EXPORTERS_FLEETDAY_ARGS_DIR"] = str(export_dir)

    specs = [WorkerSpec(
        node_id=name,
        cmd=worker_cmd(name, f"127.0.0.1:{contacts[name][1]}", contact_str,
                       "gateway-0", cfg.partitions, cfg.replication,
                       data_dir=str(directory / name),
                       device=cfg.device),
        data_dir=str(directory / name)) for name in worker_names]
    supervisor = WorkerSupervisor(specs, env=env, restart_backoff_s=0.2)
    admission = AdmissionController(
        AdmissionCfg(
            quotas={s.name: (s.quota_rate, s.quota_burst)
                    for s in cfg.tenants if s.quota_rate > 0},
            weights={s.name: s.weight for s in cfg.tenants}),
        node_id="gateway-0")
    runtime = MultiProcClusterRuntime(
        "gateway-0",
        {m: a for m, a in contacts.items() if m != "gateway-0"},
        partition_count=cfg.partitions, replication_factor=cfg.replication,
        bind=contacts["gateway-0"], supervisor=supervisor,
        admission=admission)
    admission.flight = runtime.flight

    history: list[ServingOp] = []
    history_lock = threading.Lock()
    op_seq = [0]
    events: list[dict] = []
    drive_t0 = [0.0]
    cluster_audit = ClusterAuditor()
    audit_lock = threading.Lock()

    def drive_ms() -> float:
        return (time.monotonic() - drive_t0[0]) * 1000.0

    def new_op(tenant: str, kind: str, partition: int,
               scheduled_ms: float) -> ServingOp:
        with history_lock:
            op_seq[0] += 1
            op = ServingOp(index=op_seq[0], tenant=tenant, kind=kind,
                           partition=partition, scheduled_ms=scheduled_ms)
            history.append(op)
        return op

    def execute(op: ServingOp, record) -> ServingOp:
        return execute_op(runtime, op, record, cfg.request_timeout_s,
                          drive_ms)

    def create_cmd(tenant: str):
        return command(ValueType.PROCESS_INSTANCE_CREATION,
                       ProcessInstanceCreationIntent.CREATE,
                       {"bpmnProcessId": "fleet", "version": -1,
                        "variables": {}, "tenantId": tenant})

    def serve_model(version_tag: int):
        # each churn deploys a structurally DIFFERENT model under the same
        # process id — a real new version, not a dedup'd redeploy
        return (Bpmn.create_executable_process("fleet")
                .start_event("s").end_event(f"e{version_tag}").done())

    storm_model = (Bpmn.create_executable_process("fleet_wait")
                   .start_event("s")
                   .intermediate_catch_message("wait",
                                               message_name="fleet-msg",
                                               correlation_key="=ck")
                   .end_event("e").done())

    def parked_cold_total() -> int:
        return sum(
            info.get("parkedCold", 0)
            for status in runtime._worker_status.values()
            for info in status.get("partitions", {}).values()
            if info.get("role") == "leader")

    # open-loop schedule: calm shoulder then diurnal ramp, per tenant
    calm_s = cfg.calm_fraction * cfg.drive_seconds
    merged: list[tuple[float, str]] = []
    for idx, spec in enumerate(cfg.tenants):
        rng = random.Random((cfg.seed << 8) ^ (idx + 1))
        rate = tenant_rate_fn(spec, calm_s, cfg.ramp_seconds)
        peak = max(spec.rate_a, spec.rate_bc)
        merged.extend(
            (t, spec.name)
            for t in poisson_schedule(rng, cfg.drive_seconds, rate, peak))
    merged.sort()
    report["offeredArrivals"] = len(merged)

    arrivals: "queue.Queue[tuple[float, str] | None]" = queue.Queue()
    stop_streams = threading.Event()

    def submit_create(at_ms: float, tenant: str) -> None:
        op = new_op(tenant, "create",
                    runtime.partition_for_new_instance(), at_ms)
        execute(op, create_cmd(tenant))

    def client_stream() -> None:
        drain_arrival_queue(arrivals, stop_streams, submit_create)

    def scheduler() -> None:
        for at_s, tenant in merged:
            delay = drive_t0[0] + at_s - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            if stop_streams.is_set():
                return
            arrivals.put((at_s * 1000.0, tenant))

    def audit_poller() -> None:
        """Feed the gateway-side auditor from the worker status pushes the
        runtime already aggregates — replica-CRC joins + cross-push
        monotonicity accumulate while the fleet runs."""
        while not stop_streams.is_set():
            rows = dict(runtime._worker_status)
            with audit_lock:
                cluster_audit.ingest(rows)
            time.sleep(0.5)

    try:
        runtime.start()
        boot_deadline = time.monotonic() + 240.0
        while True:
            try:
                runtime.await_leaders(timeout_s=5.0)
                break
            except RuntimeError:
                if time.monotonic() >= boot_deadline:
                    raise

        # ---- warm: deploy v1 + the storm pool -----------------------------
        drive_t0[0] = time.monotonic()
        tenant_names = [s.name for s in cfg.tenants]
        for tenant in tenant_names:
            op = execute(
                new_op(tenant, "deploy", 1, -1.0),
                command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {
                    "resources": [{"resourceName": "fleet.bpmn",
                                   "resource": to_bpmn_xml(serve_model(0))}],
                    "tenantId": tenant}))
            if op.outcome != "ack":
                raise RuntimeError(f"deploy for {tenant} failed: {op.row()}")
        op = execute(
            new_op("t-storm", "deploy", 1, -1.0),
            command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {
                "resources": [{"resourceName": "fleet_wait.bpmn",
                               "resource": to_bpmn_xml(storm_model)}],
                "tenantId": "t-storm"}))
        if op.outcome != "ack":
            raise RuntimeError(f"storm deploy failed: {op.row()}")
        for pid in range(1, cfg.partitions + 1):
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                probe = execute(new_op(tenant_names[0], "create", pid, -1.0),
                                create_cmd(tenant_names[0]))
                if probe.outcome == "ack":
                    break
                time.sleep(0.25)
            else:
                raise RuntimeError(
                    f"partition {pid} never served a create: {probe.row()}")

        storm_keys = [f"fleet-ck-{i}" for i in range(cfg.parked_instances)]
        for ck in storm_keys:
            op = execute(
                new_op("t-storm", "create",
                       runtime.partition_for_new_instance(), -1.0),
                command(ValueType.PROCESS_INSTANCE_CREATION,
                        ProcessInstanceCreationIntent.CREATE,
                        {"bpmnProcessId": "fleet_wait", "version": -1,
                         "variables": {"ck": ck}, "tenantId": "t-storm"}))
            if op.outcome != "ack":
                violations.append(
                    f"storm pool create failed: {op.outcome} "
                    f"({op.rejection})")
        want_cold = int(cfg.parked_instances * cfg.park_fraction)
        park_deadline = time.monotonic() + cfg.park_wait_s
        while time.monotonic() < park_deadline:
            if parked_cold_total() >= want_cold:
                break
            time.sleep(0.5)
        parked_before = parked_cold_total()
        report["tieredState"] = {"instances": cfg.parked_instances,
                                 "parkedColdBeforeStorm": parked_before}
        if parked_before < want_cold:
            violations.append(
                f"storm pool never tiered cold: {parked_before} spilled "
                f"< {want_cold} wanted (tiering evidence missing)")

        # ---- the drive: everything at once --------------------------------
        drive_t0[0] = time.monotonic()
        threads = [threading.Thread(target=client_stream, daemon=True,
                                    name=f"stream-{i}")
                   for i in range(cfg.client_streams)]
        for t in threads:
            t.start()
        sched = threading.Thread(target=scheduler, daemon=True,
                                 name="fleetday-scheduler")
        sched.start()
        poller = threading.Thread(target=audit_poller, daemon=True,
                                  name="fleetday-audit-poller")
        poller.start()

        side_rng = random.Random(cfg.seed ^ 0xF1EE7)

        def churn() -> None:
            """Live definition churn: new serve-model versions deployed
            mid-traffic; version -1 creates pick each one up."""
            for i in range(cfg.churn_deploys):
                at = (0.2 + 0.6 * (i + 0.5) / cfg.churn_deploys) \
                    * cfg.drive_seconds
                delay = drive_t0[0] + at - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                if stop_streams.is_set():
                    return
                tenant = tenant_names[i % len(tenant_names)]
                op = execute(
                    new_op(tenant, "deploy", 1, at * 1000.0),
                    command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {
                        "resources": [{
                            "resourceName": "fleet.bpmn",
                            "resource": to_bpmn_xml(serve_model(i + 1))}],
                        "tenantId": tenant}))
                events.append({"atMs": at * 1000.0, "action": "churn",
                               "tenant": tenant, "outcome": op.outcome})

        def storm() -> None:
            storm_at = sorted(
                (0.4 + side_rng.uniform(0.0, 0.4)) * cfg.drive_seconds
                for _ in range(min(cfg.storm_publishes, len(storm_keys))))
            targets = side_rng.sample(
                storm_keys, min(cfg.storm_publishes, len(storm_keys)))
            for at_s, ck in zip(storm_at, targets):
                delay = drive_t0[0] + at_s - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                if stop_streams.is_set():
                    return
                op = new_op("t-storm", "publish",
                            runtime.partition_for_correlation_key(ck),
                            at_s * 1000.0)
                execute(op, command(
                    ValueType.MESSAGE, MessageIntent.PUBLISH,
                    {"name": "fleet-msg", "correlationKey": ck,
                     "timeToLive": 120_000, "messageId": "",
                     "variables": {}, "tenantId": "t-storm"}))

        churn_thread = threading.Thread(target=churn, daemon=True,
                                        name="fleetday-churn")
        churn_thread.start()
        storm_thread = threading.Thread(target=storm, daemon=True,
                                        name="fleetday-storm")
        storm_thread.start()

        # rolling restarts: sequential kills through the middle of the
        # drive, each declaring an incident window on the drive clock
        for k in range(cfg.rolling_restarts):
            at = (0.35 + 0.4 * (k + 0.5) / cfg.rolling_restarts) \
                * cfg.drive_seconds
            delay = drive_t0[0] + at - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            target = worker_names[k % len(worker_names)]
            logger.warning("fleetday: rolling restart of %s at t=%.1fs",
                           target, at)
            events.append({"atMs": drive_ms(), "action": "restart",
                           "target": target})
            supervisor.kill_worker(target)

        remaining = drive_t0[0] + cfg.drive_seconds - time.monotonic()
        if remaining > 0:
            time.sleep(remaining)
        sched.join(timeout=10)
        churn_thread.join(timeout=10)
        storm_thread.join(timeout=10)
        drain_deadline = time.monotonic() + cfg.request_timeout_s + 10
        while time.monotonic() < drain_deadline and not arrivals.empty():
            time.sleep(0.2)
        for _ in threads:
            arrivals.put(None)
        stop_done = time.monotonic() + cfg.request_timeout_s + 10
        for t in threads:
            t.join(timeout=max(stop_done - time.monotonic(), 0.1))

        # disarm disk+device for a clean quiesce (tcp stays at its low
        # background rate — the consistency evidence must hold regardless)
        disk_disarm.write_text("disarm\n", encoding="utf-8")
        device_disarm.write_text("disarm\n", encoding="utf-8")
        quiesce_deadline = time.monotonic() + 90.0
        while time.monotonic() < quiesce_deadline:
            try:
                runtime.await_leaders(timeout_s=5.0)
                break
            except RuntimeError:
                continue
        time.sleep(2.0)
        stop_streams.set()
        poller.join(timeout=5)

        # final audit ingest + snapshots (post-drive pushes included)
        with audit_lock:
            cluster_audit.ingest(dict(runtime._worker_status))
            report["onlineAudit"] = cluster_audit.snapshot()
        report["tieredState"]["parkedColdAfterStorm"] = parked_cold_total()
        report["workerRestarts"] = dict(supervisor.restarts)
        report["gatewayFlight"] = runtime.flight.snapshot()
    finally:
        stop_streams.set()
        try:
            runtime.stop()
        except Exception:  # noqa: BLE001 — teardown must reach evidence
            logger.exception("runtime stop failed")

    # ---- offline evidence + gates -----------------------------------------
    logs, log_violations = collect_logs(directory, worker_names,
                                        cfg.partitions)
    violations += log_violations
    violations += check_serving_history(history, logs)
    _, export_violations, re_exports = collect_exports(export_dir)
    violations += export_violations

    windows = incident_windows(events, cfg.incident_grace_s * 1000.0)
    slo_report, slo_violations = evaluate_fleet_slo(history, windows, cfg)
    violations += slo_violations
    report["slo"] = slo_report

    # chaos evidence: every plane must have LANDED at least one event
    plane_counts = {
        "tcp": sum_counts_files(
            sorted(directory.glob("*/chaos-counts-*.json"))),
        "disk": sum_counts_files(
            sorted(directory.glob("*/disk-chaos-counts-*.json"))),
        "device": sum_counts_files(
            sorted(directory.glob("*/device-chaos-counts-*.json"))),
    }
    report["chaosPlanes"] = plane_counts
    for plane, counts in plane_counts.items():
        if not sum(counts.values()):
            violations.append(
                f"chaos plane `{plane}` was armed but observed ZERO events "
                f"— the plane is not reaching its seam")

    # device corruption accounting (the checker, death-waived for
    # restart-killed lives)
    corrupt_entries = read_jsonl_ledgers(
        sorted(directory.glob("*/device-corrupt-*.jsonl")))
    if corrupt_entries:
        surviving = {p for n in worker_names
                     if (p := supervisor.pid_of(n)) is not None}
        dead_pids = {e.get("pid") for e in corrupt_entries} - surviving
        corr_violations, corr_stats = check_corruption_accounting(
            corrupt_entries, dead_pids=dead_pids)
        violations += corr_violations
        report["corruptionAccounting"] = corr_stats

    # zero leak verdicts on the clean fleet
    worker_audits = report.get("onlineAudit", {}).get("workers", {})
    leak_verdicts = {w: a.get("leakVerdict") for w, a in
                     worker_audits.items()}
    report["leakVerdicts"] = leak_verdicts
    for worker, verdict in leak_verdicts.items():
        if verdict == "leak":
            violations.append(
                f"clean-fleet leak verdict on {worker}: the tree leaks, or "
                f"the detector's confidence gate is broken")

    # auditor recall: offline findings vs online flags — and precision the
    # other way: an online INVARIANT flag the offline evidence does not
    # corroborate is a false alarm (monitor bug), also a gate failure
    with audit_lock:
        flagged = cluster_audit.flagged_monitors()
    offline_snapshot = list(violations)
    recall_misses, recall_stats = check_auditor_recall(
        offline_snapshot, flagged)
    violations += recall_misses
    report["auditorRecall"] = recall_stats
    false_alarms = sorted((flagged & INVARIANT_MONITORS)
                          - offline_monitors(offline_snapshot))
    for monitor in false_alarms:
        violations.append(
            f"online invariant monitor `{monitor}` flagged during a run "
            f"the offline checker found clean — precision failure (false "
            f"alarm)")
    report["onlinePrecision"] = {"falseAlarms": false_alarms}

    # the leak-injection arm: the detector MUST fire with the same knobs
    leak_arm = run_leak_arm(cfg, directory / "leak-arm")
    report["leakArm"] = leak_arm
    if not leak_arm.get("fired"):
        violations.append(
            "leak-injection arm: the auditor never returned a leak verdict "
            "against a deliberately leaking worker — detector recall "
            "unproven")

    outcomes: dict[str, int] = {}
    for op in history:
        outcomes[op.outcome] = outcomes.get(op.outcome, 0) + 1
    churn_acked = sum(1 for e in events
                      if e["action"] == "churn" and e["outcome"] == "ack")
    restarts = sum(1 for e in events if e["action"] == "restart")
    if churn_acked < 1:
        violations.append("definition churn never landed (0 acked churn "
                          "deploys)")
    if restarts < 1:
        violations.append("no rolling restart was exercised")
    report.update({
        "workers": cfg.workers,
        "partitions": cfg.partitions,
        "replication": cfg.replication,
        "driveSeconds": cfg.drive_seconds,
        "requests": len(history),
        "outcomes": outcomes,
        "ackedCommands": outcomes.get("ack", 0),
        "definitionChurn": {"deploys": cfg.churn_deploys,
                            "acked": churn_acked},
        "rollingRestarts": restarts,
        "events": events,
        "reExportedRecords": re_exports,
        "logRecords": {str(p): len(r) for p, r in logs.items()},
        "violations": violations,
        "wallSeconds": round(time.monotonic() - started, 2),
    })
    return report


# copied from the reference: main .. main
def main(argv: list[str] | None = None) -> int:  # pragma: no cover — manual
    from zeebe_tpu_torch.testing.serving import gate_cli_main

    return gate_cli_main("zeebe-tpu-fleetday", FleetDayConfig(),
                         FULL_FLEETDAY, run_fleetday, argv)
# end of the copy


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
