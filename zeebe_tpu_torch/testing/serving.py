"""Open-loop SLO'd serving gate (ROADMAP item 4).

Every earlier gate drives closed-loop bursts from one cooperative client —
exactly how overload failures hide, because a closed-loop driver slows down
when the server does and the p99 lies. This harness drives the REAL
multi-process cluster (supervised worker processes over TCP, with
**open-loop Poisson arrivals**: the offered load is a seeded arrival
schedule fixed before the run, dispatched by hundreds of concurrent client
streams, and a request's latency is measured from its SCHEDULED arrival —
dispatch queueing is part of the number, never hidden.

The workload is shaped like a tenant fleet:

- several **well-behaved tenants** at a fixed offered rate inside their
  quotas (their p50/p99 ack latency is the SLO under test);
- one **hot tenant** whose rate ramps (a diurnal ramp) to ~5x its
  token-bucket quota — it must saturate its OWN share and collect typed,
  fast ``RESOURCE_EXHAUSTED`` sheds while the others keep their SLO;
- a **storm tenant** holding a pool of message-wait instances that park and
  spill to the cold store, then a correlation storm mid-drive that
  wakes them from cold;
- a live **worker kill** chaos) in the final phase, with goodput
  gated against the no-chaos window.

Phases: ``warm`` (deploy per tenant, build + park the storm pool) →
``A`` calm (everyone in quota: the fairness/goodput reference) → ``B``
overload (hot ramp + correlation storm) → ``C`` overload + chaos (worker
kill). Offline, the workers' journals are read back and every acked
request must appear exactly once (the consistency evidence reused).

``bench.py --serving [--quick]`` runs this and writes
``SERVING[_quick].json``; the CI ``serving-smoke`` job gates on it.

The port's gate is a partial copy of the reference's: its config takes the
workers' kernel backend ``device`` and ``run_serving`` gives it to every
``worker_cmd`` (``--device``; None runs the workers on the card,
``"cpu"`` on the plain version) in place of the reference's
``JAX_PLATFORMS=cpu``. The rest is the reference's, copied.
``gate_cli_main`` takes ``--device`` for every gate that uses it.
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
from typing import Any, Callable

from zeebe_tpu_torch.testing.evidence import percentile

# copied from the reference: logger .. _default_tenants
logger = logging.getLogger("zeebe_tpu_torch.testing.serving")


# ---------------------------------------------------------------------------
# configuration


@dataclasses.dataclass
class TenantSpec:
    name: str
    kind: str                 # "well" | "hot" | "storm"
    rate_a: float             # offered arrivals/s in phase A (calm)
    rate_bc: float            # offered arrivals/s in phases B/C
    quota_rate: float         # token-bucket quota (0 = unmetered)
    quota_burst: float = 0.0
    weight: float = 1.0


def _default_tenants() -> list[TenantSpec]:
    return [
        TenantSpec("t-well-0", "well", 8.0, 8.0, quota_rate=20.0),
        TenantSpec("t-well-1", "well", 8.0, 8.0, quota_rate=20.0),
        TenantSpec("t-well-2", "well", 8.0, 8.0, quota_rate=20.0),
        # the hot tenant ramps to 5x its quota at the A->B boundary
        TenantSpec("t-hot", "hot", 6.0, 40.0, quota_rate=8.0,
                   quota_burst=16.0),
    ]
# end of the copy


@dataclasses.dataclass
class ServingConfig:
    seed: int = 0
    workers: int = 3
    partitions: int = 2
    replication: int = 3
    #: concurrent client streams dispatching the arrival schedule
    client_streams: int = 128
    phase_a_seconds: float = 8.0
    phase_b_seconds: float = 8.0
    phase_c_seconds: float = 10.0
    #: diurnal ramp length at the A->B boundary (rate_a -> rate_bc)
    ramp_seconds: float = 3.0
    request_timeout_s: float = 15.0
    tenants: list[TenantSpec] = dataclasses.field(
        default_factory=_default_tenants)
    #: storm pool: message-wait instances parked + spilled cold before the
    #: storm (state tiering,
    parked_instances: int = 150
    storm_publishes: int = 60
    park_after_ms: int = 500
    spill_batch: int = 256
    park_wait_s: float = 25.0          # wait-for-spill ceiling in warm phase
    park_fraction: float = 0.3         # spilled fraction required pre-storm
    #: live chaos: worker kills in phase C
    kill_workers: int = 1
    # -- gates ----------------------------------------------------------------
    slo_p50_ms: float = 1000.0
    slo_p99_ms: float = 5000.0
    #: fairness: well-behaved p99 under overload+chaos may not exceed
    #: max(mult x calm p99, floor)
    fairness_mult: float = 4.0
    fairness_floor_ms: float = 2000.0
    #: goodput: well-behaved acked/s in the chaos phase vs the calm phase
    goodput_floor: float = 0.7
    #: sheds must be FAST (typed rejections, not queued timeouts): p95 bound
    shed_fast_ms: float = 1000.0
    kernel_backend: bool = False       # quick/CI: skip per-worker XLA warmup
    #: the workers' kernel backend device (``--device``): None runs them on
    #: the card, ``"cpu"`` on the plain version
    device: str | None = None


# copied from the reference: FULL_CONFIG .. execute_op
FULL_CONFIG = ServingConfig(
    workers=4, partitions=4, client_streams=384,
    phase_a_seconds=30.0, phase_b_seconds=30.0, phase_c_seconds=40.0,
    parked_instances=1000, storm_publishes=400, kill_workers=2,
    tenants=[
        TenantSpec("t-well-0", "well", 20.0, 20.0, quota_rate=50.0),
        TenantSpec("t-well-1", "well", 20.0, 20.0, quota_rate=50.0),
        TenantSpec("t-well-2", "well", 20.0, 20.0, quota_rate=50.0),
        TenantSpec("t-well-3", "well", 20.0, 20.0, quota_rate=50.0),
        TenantSpec("t-hot", "hot", 10.0, 100.0, quota_rate=20.0,
                   quota_burst=40.0),
    ])


# ---------------------------------------------------------------------------
# open-loop arrival schedule (pure, seeded — unit-testable)


def poisson_schedule(rng: random.Random, duration_s: float,
                     rate_fn: Callable[[float], float],
                     max_rate: float) -> list[float]:
    """Non-homogeneous Poisson arrivals on [0, duration) by thinning: draw
    exponential gaps at ``max_rate``, keep each point with probability
    ``rate(t)/max_rate``. Deterministic for a given rng state."""
    if max_rate <= 0:
        return []
    out: list[float] = []
    t = 0.0
    while True:
        t += rng.expovariate(max_rate)
        if t >= duration_s:
            return out
        if rng.random() * max_rate <= rate_fn(t):
            out.append(t)


def tenant_rate_fn(spec: TenantSpec, phase_a_s: float,
                   ramp_s: float) -> Callable[[float], float]:
    """Offered rate over the whole drive: flat ``rate_a`` through phase A,
    then a linear (diurnal-shoulder) ramp to ``rate_bc``."""

    def rate(t: float) -> float:
        if t < phase_a_s:
            return spec.rate_a
        if ramp_s > 0 and t < phase_a_s + ramp_s:
            frac = (t - phase_a_s) / ramp_s
            return spec.rate_a + (spec.rate_bc - spec.rate_a) * frac
        return spec.rate_bc

    return rate


def drain_arrival_queue(arrivals: "queue.Queue",
                        stop: threading.Event,
                        submit: Callable[[float, str], None]) -> None:
    """The client-stream body shared by the serving and fleet-day
    harnesses: drain due ``(at_ms, tenant)`` arrivals and submit each,
    never waiting on another stream's request. ``None`` drains the
    stream; ``stop`` abandons whatever is still queued."""
    while not stop.is_set():
        try:
            item = arrivals.get(timeout=0.2)
        except queue.Empty:
            continue
        if item is None:
            return
        at_ms, tenant = item
        submit(at_ms, tenant)


def build_schedule(cfg: ServingConfig) -> list[tuple[float, str]]:
    """The merged ``(at_s, tenant)`` arrival schedule for the whole drive,
    sorted by time; one independent seeded stream per tenant."""
    drive_s = cfg.phase_a_seconds + cfg.phase_b_seconds + cfg.phase_c_seconds
    merged: list[tuple[float, str]] = []
    for idx, spec in enumerate(cfg.tenants):
        rng = random.Random((cfg.seed << 8) ^ (idx + 1))
        rate = tenant_rate_fn(spec, cfg.phase_a_seconds, cfg.ramp_seconds)
        peak = max(spec.rate_a, spec.rate_bc)
        merged.extend((t, spec.name)
                      for t in poisson_schedule(rng, drive_s, rate, peak))
    merged.sort()
    return merged


# ---------------------------------------------------------------------------
# history + offline checks (pure — unit-testable without a cluster)


@dataclasses.dataclass
class ServingOp:
    """One open-loop request as the client fleet observed it."""

    index: int
    tenant: str
    kind: str                      # "create" | "publish" | "deploy"
    partition: int
    scheduled_ms: float            # offered arrival time (drive clock)
    started_ms: float = 0.0        # when a client stream picked it up
    done_ms: float = 0.0
    outcome: str = "pending"       # ack | rejected | shed | deadline
                                   # | no-leader | error
    request_id: int = -1
    position: int = -1
    shed_reason: str | None = None
    rejection: str | None = None
    resends: int = 0
    reroutes: int = 0

    @property
    def latency_ms(self) -> float:
        """Open-loop latency: scheduled arrival -> completion (dispatch
        queueing included — that is the point of open loop)."""
        return self.done_ms - self.scheduled_ms

    def row(self) -> dict:
        return dataclasses.asdict(self)


def check_serving_history(history: list["ServingOp"],
                          logs: dict[int, list[dict]]) -> list[str]:
    """Offline exactly-once evidence over the authoritative logs (the
    reader reused): every acked request appears as a command in its
    partition's committed log (no acked loss), and no request id owns more
    than one command position (no duplicate application). The per-partition
    monotone-ack check from the consistency gate does NOT apply — serving
    drivers are concurrent by design."""
    from zeebe_tpu_torch.protocol import RecordType

    violations: list[str] = []
    command_rt = int(RecordType.COMMAND)
    cmd_positions: dict[int, dict[int, list[int]]] = {}
    for partition, records in logs.items():
        per = cmd_positions.setdefault(partition, {})
        for rec in records:
            rid = rec.get("rid", -1)
            if rid >= 0 and rec["rt"] == command_rt:
                per.setdefault(rid, []).append(rec["p"])
        for rid, positions in per.items():
            if len(positions) > 1:
                violations.append(
                    f"partition {partition}: request {rid} appended "
                    f"{len(positions)} times at {positions} (duplicate "
                    f"application)")
    for op in history:
        if op.outcome != "ack":
            continue
        positions = cmd_positions.get(op.partition, {}).get(op.request_id, [])
        if not positions:
            violations.append(
                f"partition {op.partition}: acked request {op.request_id} "
                f"(op #{op.index}, tenant {op.tenant}) has no command in "
                f"the log (acked loss)")
        elif op.position >= 0 and op.position not in positions:
            violations.append(
                f"partition {op.partition}: acked request {op.request_id} "
                f"acked position {op.position} but the log has it at "
                f"{positions}")
    return violations


def _phase_of(op: ServingOp, cfg: ServingConfig) -> str:
    if op.scheduled_ms < 0:
        return "warm"   # deploys/pool builds before the drive clock starts
    a_ms = cfg.phase_a_seconds * 1000.0
    b_ms = a_ms + cfg.phase_b_seconds * 1000.0
    if op.scheduled_ms < a_ms:
        return "A"
    return "B" if op.scheduled_ms < b_ms else "C"


def _latency_stats(latencies: list[float]) -> dict:
    if not latencies:
        return {"count": 0}
    ordered = sorted(latencies)
    return {
        "count": len(ordered),
        "p50Ms": round(percentile(ordered, 0.50), 1),
        "p95Ms": round(percentile(ordered, 0.95), 1),
        "p99Ms": round(percentile(ordered, 0.99), 1),
        "maxMs": round(ordered[-1], 1),
    }


def evaluate_gates(history: list[ServingOp], cfg: ServingConfig) -> tuple[
        dict, list[str]]:
    """The serving SLO/fairness/goodput/shed gates over a finished history.
    Pure — the unit tests drive it with synthetic histories."""
    violations: list[str] = []
    by_tenant: dict[str, list[ServingOp]] = {}
    for op in history:
        by_tenant.setdefault(op.tenant, []).append(op)
    kinds = {spec.name: spec.kind for spec in cfg.tenants}
    kinds.setdefault("t-storm", "storm")

    report: dict[str, Any] = {"tenants": {}}
    well_calm: list[float] = []
    well_overload: list[float] = []   # phase B: hot tenant at 5x, no chaos
    well_load: list[float] = []       # phases B+C: overload AND chaos
    calm_acked = 0
    chaos_acked = 0
    for tenant, ops in sorted(by_tenant.items()):
        acked = [op for op in ops if op.outcome == "ack"]
        sheds = [op for op in ops if op.outcome == "shed"]
        phases: dict[str, dict] = {}
        for phase in ("A", "B", "C"):
            phase_acked = [op.latency_ms for op in acked
                           if _phase_of(op, cfg) == phase]
            phases[phase] = _latency_stats(phase_acked)
        outcomes: dict[str, int] = {}
        for op in ops:
            outcomes[op.outcome] = outcomes.get(op.outcome, 0) + 1
        report["tenants"][tenant] = {
            "kind": kinds.get(tenant, "?"),
            "offered": len(ops),
            "outcomes": outcomes,
            "ackedByPhase": phases,
            "shedLatency": _latency_stats(
                [op.latency_ms for op in sheds]),
            "shedReasons": _count(op.shed_reason for op in sheds),
        }
        if kinds.get(tenant) == "well":
            for op in acked:
                phase = _phase_of(op, cfg)
                if phase == "A":
                    well_calm.append(op.latency_ms)
                elif phase == "B":
                    well_overload.append(op.latency_ms)
                    well_load.append(op.latency_ms)
                elif phase == "C":
                    well_load.append(op.latency_ms)
            calm_acked += sum(1 for op in acked if _phase_of(op, cfg) == "A")
            chaos_acked += sum(1 for op in acked if _phase_of(op, cfg) == "C")
        # no silent drops for ANY tenant — a hot-tenant op that never
        # reached a terminal outcome is as much a drop as a well-behaved one
        pending = outcomes.get("pending", 0)
        if pending:
            violations.append(
                f"tenant {tenant}: {pending} op(s) never completed "
                f"(silent drop)")

    # gate 1: absolute SLO for the well-behaved population under load
    load_stats = _latency_stats(well_load)
    calm_stats = _latency_stats(well_calm)
    report["wellBehaved"] = {"calm": calm_stats, "underLoad": load_stats}
    if load_stats.get("count"):
        if load_stats["p99Ms"] > cfg.slo_p99_ms:
            violations.append(
                f"well-behaved p99 under overload+chaos "
                f"{load_stats['p99Ms']}ms > SLO {cfg.slo_p99_ms}ms")
        if load_stats["p50Ms"] > cfg.slo_p50_ms:
            violations.append(
                f"well-behaved p50 under overload+chaos "
                f"{load_stats['p50Ms']}ms > SLO {cfg.slo_p50_ms}ms")
    else:
        violations.append("no well-behaved acks under load (no SLO evidence)")

    # gate 2: fairness — the hot tenant's overload (phase B: 5x quota, no
    # chaos yet) must not move the well-behaved p99 beyond the bound
    # relative to the calm reference. Phase C's kill is deliberately NOT in
    # this comparison — the chaos tail is the absolute-SLO and goodput
    # gates' business; folding it in here would blame re-election latency
    # on the hot tenant.
    overload_stats = _latency_stats(well_overload)
    if calm_stats.get("count") and overload_stats.get("count"):
        bound = max(cfg.fairness_mult * calm_stats["p99Ms"],
                    cfg.fairness_floor_ms)
        report["fairness"] = {"calmP99Ms": calm_stats["p99Ms"],
                              "overloadP99Ms": overload_stats["p99Ms"],
                              "boundMs": round(bound, 1)}
        if overload_stats["p99Ms"] > bound:
            violations.append(
                f"fairness: well-behaved p99 moved {calm_stats['p99Ms']}ms "
                f"-> {overload_stats['p99Ms']}ms under the hot tenant "
                f"(bound {bound:.0f}ms)")

    # gate 3: the hot tenant is shed — typed and fast — and cannot push its
    # acked volume materially past its quota
    hot = [spec for spec in cfg.tenants if spec.kind == "hot"]
    for spec in hot:
        ops = by_tenant.get(spec.name, [])
        sheds = [op for op in ops if op.outcome == "shed"]
        load_s = cfg.phase_b_seconds + cfg.phase_c_seconds
        hot_acked = [op for op in ops if op.outcome == "ack"
                     and _phase_of(op, cfg) != "A"]
        if not sheds:
            violations.append(
                f"hot tenant {spec.name} was never shed at "
                f"{max(spec.rate_bc, 0):.0f}/s against a "
                f"{spec.quota_rate:.0f}/s quota")
            continue
        shed_lat = sorted(op.latency_ms for op in sheds)
        p95 = percentile(shed_lat, 0.95)
        if p95 > cfg.shed_fast_ms:
            violations.append(
                f"hot tenant sheds are slow: p95 {p95:.0f}ms > "
                f"{cfg.shed_fast_ms:.0f}ms (sheds must be typed rejections, "
                f"not queued timeouts)")
        allowed = spec.quota_rate * load_s * 2.0 + spec.quota_burst
        if len(hot_acked) > allowed:
            violations.append(
                f"hot tenant acked {len(hot_acked)} commands under "
                f"overload — quota {spec.quota_rate}/s x {load_s:.0f}s not "
                f"enforced (allowed ~{allowed:.0f})")

    # gate 4: goodput — shed-instead-of-collapse: the well-behaved fleet's
    # acked/s with chaos live stays within a floor of the calm baseline
    if cfg.phase_a_seconds > 0 and cfg.phase_c_seconds > 0 and calm_acked:
        calm_rate = calm_acked / cfg.phase_a_seconds
        chaos_rate = chaos_acked / cfg.phase_c_seconds
        report["goodput"] = {
            "calmAckedPerSec": round(calm_rate, 2),
            "chaosAckedPerSec": round(chaos_rate, 2),
            "floor": cfg.goodput_floor,
        }
        if chaos_rate < cfg.goodput_floor * calm_rate:
            violations.append(
                f"goodput collapsed under chaos: {chaos_rate:.1f} acked/s "
                f"vs calm {calm_rate:.1f} (floor "
                f"{cfg.goodput_floor:.0%})")

    # no silent drops anywhere: every op reached a terminal outcome and
    # errors are typed
    untyped = [op for op in history if op.outcome == "error"]
    for op in untyped[:10]:
        violations.append(
            f"op #{op.index} (tenant {op.tenant}) failed untyped: "
            f"{op.rejection}")
    return report, violations


def _count(items) -> dict:
    out: dict[str, int] = {}
    for item in items:
        key = str(item)
        out[key] = out.get(key, 0) + 1
    return out


def execute_op(runtime, op: ServingOp, record, timeout_s: float,
               drive_ms: Callable[[], float]) -> ServingOp:
    """Submit one open-loop op and record its terminal outcome + routing
    meta — ONE submission protocol for every open-loop harness (the
    serving gate and the autotune A/B), so their latency/outcome taxonomy
    cannot drift."""
    from zeebe_tpu_torch.gateway.broker_client import (
        DeadlineExceededError,
        NoLeaderError,
        ResourceExhaustedError,
    )

    op.started_ms = drive_ms()
    meta: dict = {}
    try:
        result = runtime.submit(op.partition, record, timeout_s=timeout_s,
                                meta=meta)
        op.outcome = "rejected" if result.is_rejection else "ack"
        if result.is_rejection:
            op.rejection = result.rejection_type.name
    except ResourceExhaustedError as exc:
        op.outcome = "shed"
        # gateway-side sheds carry the admission reason; worker-side
        # sheds arrive as typed resource-exhausted/backpressure frames
        op.shed_reason = meta.get("shed") or meta.get("error") or "typed"
        op.rejection = str(exc)[:160]
    except DeadlineExceededError:
        op.outcome = "deadline"
    except NoLeaderError:
        op.outcome = "no-leader"
    except Exception as exc:  # noqa: BLE001 — untyped = gate evidence
        op.outcome = "error"
        op.rejection = repr(exc)[:200]
    op.done_ms = drive_ms()
    op.request_id = meta.get("requestId", -1)
    op.position = meta.get("commandPosition", -1)
    op.resends = meta.get("resends", 0)
    op.reroutes = meta.get("reroutes", 0)
    return op
# end of the copy


def gate_cli_main(prog: str, quick_cfg, full_cfg, run_fn,
                  argv: list[str] | None = None) -> int:
    """Shared manual entry point for the open-loop gates and the soaks:
    parse --seed/--quick/--device, run in a temp dir, dump the report, exit
    on violations. The device goes into the config where it has one, else
    to ``run_fn`` (the soaks' ``run_soak``/``run_scale_soak``)."""
    import argparse
    import tempfile

    parser = argparse.ArgumentParser(prog=prog)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--device", default=None,
                        help="the workers' kernel backend device (default: "
                             "the card; cpu runs the plain version)")
    args = parser.parse_args(argv)
    cfg = dataclasses.replace(quick_cfg if args.quick else full_cfg,
                              seed=args.seed)
    with tempfile.TemporaryDirectory(prefix=f"{prog}-") as tmp:
        if any(f.name == "device" for f in dataclasses.fields(cfg)):
            report = run_fn(dataclasses.replace(cfg, device=args.device), tmp)
        else:
            report = run_fn(cfg, tmp, device=args.device)
    json.dump(report, sys.stdout, indent=2)
    return 1 if report["violations"] else 0


# ---------------------------------------------------------------------------
# the harness


def run_serving(cfg: ServingConfig, directory: str | Path) -> dict:
    """Run the full serving gate; returns the report (violations inside)."""
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
    from zeebe_tpu_torch.testing.consistency import collect_logs

    directory = Path(directory)
    started = time.monotonic()
    report: dict[str, Any] = {"seed": cfg.seed}
    violations: list[str] = []

    worker_names = [f"worker-{i}" for i in range(cfg.workers)]
    ports = _free_ports(cfg.workers + 1)
    contacts = {n: ("127.0.0.1", p) for n, p in zip(worker_names, ports)}
    contacts["gateway-0"] = ("127.0.0.1", ports[-1])
    contact_str = ",".join(
        f"{m}={h}:{p}" for m, (h, p) in sorted(contacts.items()))

    quota_spec = ",".join(
        f"{s.name}={s.quota_rate:g}"
        + (f":{s.quota_burst:g}" if s.quota_burst else "")
        for s in cfg.tenants if s.quota_rate > 0)
    repo = str(Path(__file__).resolve().parent.parent.parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH")) if p)
    if not cfg.kernel_backend:
        env["ZEEBE_BROKER_EXPERIMENTAL_KERNELBACKEND"] = "false"
    # workers run the SAME admission knobs as the gateway (a multi-gateway
    # fleet cannot rely on one gateway's buckets) + tiering for the storm
    env["ZEEBE_GATEWAY_TENANT_QUOTAS"] = quota_spec
    env["ZEEBE_BROKER_DATA_TIERING_ENABLED"] = "true"
    env["ZEEBE_BROKER_DATA_TIERING_PARKAFTERMS"] = str(cfg.park_after_ms)
    env["ZEEBE_BROKER_DATA_TIERING_SPILLBATCH"] = str(cfg.spill_batch)

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
    drive_t0 = [0.0]   # monotonic anchor of the drive clock, set at phase A

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
                       {"bpmnProcessId": "serve", "version": -1,
                        "variables": {}, "tenantId": tenant})

    def publish_cmd(ck: str):
        return command(ValueType.MESSAGE, MessageIntent.PUBLISH,
                       {"name": "serve-msg", "correlationKey": ck,
                        "timeToLive": 120_000, "messageId": "",
                        "variables": {}, "tenantId": "t-storm"})

    def parked_cold_total() -> int:
        return sum(
            info.get("parkedCold", 0)
            for status in runtime._worker_status.values()
            for info in status.get("partitions", {}).values()
            if info.get("role") == "leader")

    serve_model = (Bpmn.create_executable_process("serve")
                   .start_event("s").end_event("e").done())
    storm_model = (Bpmn.create_executable_process("serve_wait")
                   .start_event("s")
                   .intermediate_catch_message("wait",
                                               message_name="serve-msg",
                                               correlation_key="=ck")
                   .end_event("e").done())

    schedule = build_schedule(cfg)
    report["offeredArrivals"] = len(schedule)
    arrivals: "queue.Queue[tuple[float, str] | None]" = queue.Queue()
    stop_streams = threading.Event()

    def submit_create(at_ms: float, tenant: str) -> None:
        op = new_op(tenant, "create",
                    runtime.partition_for_new_instance(), at_ms)
        execute(op, create_cmd(tenant))

    def client_stream() -> None:
        """One of the hundreds of concurrent client streams."""
        drain_arrival_queue(arrivals, stop_streams, submit_create)

    def scheduler() -> None:
        """The open-loop clock: release each arrival AT its scheduled time
        regardless of how the cluster is doing."""
        for at_s, tenant in schedule:
            delay = drive_t0[0] + at_s - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            if stop_streams.is_set():
                return
            arrivals.put((at_s * 1000.0, tenant))

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

        # ---- warm phase: per-tenant deployments + the storm pool ----------
        drive_t0[0] = time.monotonic()   # provisional clock for warm-up ops
        tenant_names = [s.name for s in cfg.tenants]
        for tenant in tenant_names + ["t-storm"]:
            model = storm_model if tenant == "t-storm" else serve_model
            name = "serve_wait" if tenant == "t-storm" else "serve"
            op = execute(
                new_op(tenant, "deploy", 1, -1.0),
                command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {
                    "resources": [{"resourceName": f"{name}.bpmn",
                                   "resource": to_bpmn_xml(model)}],
                    "tenantId": tenant}))
            if op.outcome != "ack":
                raise RuntimeError(f"deploy for {tenant} failed: {op.row()}")
        # deployment distribution: every partition must serve every tenant
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
                    f"partition {pid} never served a create; last probe: "
                    f"{probe.row()}")

        storm_keys = [f"serve-ck-{i}" for i in range(cfg.parked_instances)]
        for ck in storm_keys:
            op = execute(
                new_op("t-storm", "create",
                       runtime.partition_for_new_instance(), -1.0),
                command(ValueType.PROCESS_INSTANCE_CREATION,
                        ProcessInstanceCreationIntent.CREATE,
                        {"bpmnProcessId": "serve_wait", "version": -1,
                         "variables": {"ck": ck}, "tenantId": "t-storm"}))
            if op.outcome != "ack":
                violations.append(
                    f"storm pool create failed: {op.outcome} ({op.rejection})")
        # wait for the pool to park AND spill to the cold store (tiering):
        # the storm must wake instances from COLD, not from hot state
        want_cold = int(cfg.parked_instances * cfg.park_fraction)
        park_deadline = time.monotonic() + cfg.park_wait_s
        while time.monotonic() < park_deadline:
            if parked_cold_total() >= want_cold:
                break
            time.sleep(0.5)
        parked_before = parked_cold_total()
        report["stormPool"] = {"instances": cfg.parked_instances,
                               "parkedColdBeforeStorm": parked_before}
        if parked_before < want_cold:
            violations.append(
                f"storm pool never tiered cold: {parked_before} spilled "
                f"< {want_cold} wanted (tiering evidence missing)")

        # ---- the open-loop drive -----------------------------------------
        drive_t0[0] = time.monotonic()   # the REAL drive clock
        streams = [threading.Thread(target=client_stream, daemon=True,
                                    name=f"stream-{i}")
                   for i in range(cfg.client_streams)]
        for t in streams:
            t.start()
        sched = threading.Thread(target=scheduler, daemon=True,
                                 name="serving-scheduler")
        sched.start()

        a_end = cfg.phase_a_seconds
        b_end = a_end + cfg.phase_b_seconds
        drive_end = b_end + cfg.phase_c_seconds

        # correlation storm: spread across phase B, each publish is an
        # open-loop op of the storm tenant riding its own client stream
        storm_rng = random.Random(cfg.seed ^ 0x5702)
        storm_at = sorted(
            a_end + storm_rng.uniform(0.05, 0.95) * cfg.phase_b_seconds
            for _ in range(min(cfg.storm_publishes, len(storm_keys))))
        storm_targets = storm_rng.sample(
            storm_keys, min(cfg.storm_publishes, len(storm_keys)))

        def storm() -> None:
            for at_s, ck in zip(storm_at, storm_targets):
                delay = drive_t0[0] + at_s - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                if stop_streams.is_set():
                    return
                op = new_op("t-storm", "publish",
                            runtime.partition_for_correlation_key(ck),
                            at_s * 1000.0)
                execute(op, publish_cmd(ck))

        storm_thread = threading.Thread(target=storm, daemon=True,
                                        name="serving-storm")
        storm_thread.start()

        # live chaos: kill leaders in phase C while the drive keeps offering
        kill_rng = random.Random(cfg.seed ^ 0xC4A0)
        for k in range(cfg.kill_workers):
            at = b_end + (k + 1) * cfg.phase_c_seconds / (cfg.kill_workers + 1)
            delay = drive_t0[0] + at - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            target = runtime._leader_of(1 + k % cfg.partitions) or \
                worker_names[kill_rng.randrange(len(worker_names))]
            logger.warning("serving chaos: killing %s at t=%.1fs", target, at)
            events.append({"atMs": drive_ms(), "action": "kill",
                           "target": target})
            supervisor.kill_worker(target)

        remaining = drive_t0[0] + drive_end - time.monotonic()
        if remaining > 0:
            time.sleep(remaining)
        sched.join(timeout=10)
        storm_thread.join(timeout=10)
        # let in-flight requests finish, then release the streams
        drain_deadline = time.monotonic() + cfg.request_timeout_s + 10
        while time.monotonic() < drain_deadline and not arrivals.empty():
            time.sleep(0.2)
        for _ in streams:
            arrivals.put(None)
        stop_done = time.monotonic() + cfg.request_timeout_s + 10
        for t in streams:
            t.join(timeout=max(stop_done - time.monotonic(), 0.1))
        stop_streams.set()

        # quiesce: leaders back after the kill, storm wake evidence settled
        quiesce_deadline = time.monotonic() + 90.0
        while time.monotonic() < quiesce_deadline:
            try:
                runtime.await_leaders(timeout_s=5.0)
                break
            except RuntimeError:
                continue
        time.sleep(2.0)
        parked_after = parked_cold_total()
        report["stormPool"]["parkedColdAfterStorm"] = parked_after
        storm_acked = sum(1 for op in history
                          if op.kind == "publish" and op.outcome == "ack")
        report["stormPool"]["publishesAcked"] = storm_acked
        if parked_before > 0 and storm_acked > 0 \
                and parked_after >= parked_before:
            violations.append(
                f"correlation storm acked {storm_acked} publishes but the "
                f"cold tier never shrank ({parked_before} -> {parked_after}"
                f") — no wake-from-cold evidence")
        report["admission"] = runtime.admission.snapshot()
        report["clusterStatus"] = {
            "routingEpochs": runtime.routing_epoch,
            "workerRestarts": dict(supervisor.restarts),
        }
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
    gates, gate_violations = evaluate_gates(history, cfg)
    violations += gate_violations
    report.update(gates)

    outcomes: dict[str, int] = {}
    for op in history:
        outcomes[op.outcome] = outcomes.get(op.outcome, 0) + 1
    report.update({
        "workers": cfg.workers,
        "partitions": cfg.partitions,
        "replication": cfg.replication,
        "clientStreams": cfg.client_streams,
        "phases": {"aSeconds": cfg.phase_a_seconds,
                   "bSeconds": cfg.phase_b_seconds,
                   "cSeconds": cfg.phase_c_seconds,
                   "rampSeconds": cfg.ramp_seconds},
        "requests": len(history),
        "outcomes": outcomes,
        "ackedCommands": outcomes.get("ack", 0),
        "shedCommands": outcomes.get("shed", 0),
        "kills": len(events),
        "events": events,
        "logRecords": {str(p): len(r) for p, r in logs.items()},
        "violations": violations,
        "wallSeconds": round(time.monotonic() - started, 2),
    })
    return report


# copied from the reference: main .. main
def main(argv: list[str] | None = None) -> int:  # pragma: no cover — manual
    return gate_cli_main("zeebe-tpu-serving", ServingConfig(), FULL_CONFIG,
                         run_serving, argv)
# end of the copy


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
