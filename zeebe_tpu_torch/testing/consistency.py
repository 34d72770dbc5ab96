"""Jepsen-shaped consistency checker for the multi-process TCP cluster.

The gate: under injected TCP faults (testing/chaos_tcp.py), worker
kill storms, and a deterministic crash-between-append-and-reply, the
gateway's acked-command semantics must be **exactly-once**:

- **no acked command lost** — every request the gateway acked appears in
  the partition's committed log AND in the export stream;
- **no duplicate application** — a request id appears on at most ONE
  command position per partition (export-stream evidence, positions
  CRC-deduped so at-least-once re-exports must be byte-identical);
- **rejections are terminal** — one request's logged replies never mix
  rejections with results;
- **gateway-observed positions are monotone per partition** — the driver
  submits sequentially per partition, so first-ack command positions must
  strictly increase in completion order.

The harness (:func:`run_consistency`) boots a REAL supervised worker
cluster over TCP (the stack end to end: typed error frames,
same-worker resends, re-routes, reconnect retry, leader fencing), records
every client submit/ack/reject with its routing evidence
(``MultiProcClusterRuntime.submit(meta=...)``), every exported record
(:class:`JsonlExporter` running inside the worker processes), executes a
seeded schedule of ``kill_worker`` storms and link-partition windows, then
reads the workers' journals offline and checks the history. One worker is
armed with ``ZEEBE_CHAOS_CRASH_AFTER_APPENDS`` so the
crash-between-append-and-reply → resend → dedupe sequence happens by
construction, and a post-drive probe (:func:`_dedupe_replay_probe`) kills a
leader and resends an already-answered envelope to prove the replicated
dedupe table replays the stored reply across a process death.

``bench.py --consistency [--quick]`` runs this and writes
``CONSISTENCY[_quick].json``; the CI ``consistency-smoke`` job gates on it.

The port's gate is a partial copy of the reference's: its config takes the
workers' kernel backend ``device`` and ``run_consistency`` gives it to every
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
import zlib
from pathlib import Path
from typing import Any

# copied from the reference: logger .. collect_exports
logger = logging.getLogger("zeebe_tpu_torch.testing.consistency")


# ---------------------------------------------------------------------------
# export-stream evidence (runs INSIDE the worker processes)


from zeebe_tpu_torch.exporters.api import Exporter as _ExporterBase  # noqa: E402


class JsonlExporter(_ExporterBase):
    """Append-only JSONL export stream: one line per exported record with
    position, request identity, and a CRC over the re-encoded frame. Each
    container lifetime writes its own file (a supervisor-restarted worker's
    exporter re-exports from its recovered cursor — at-least-once), so the
    checker can prove re-exported positions byte-identical via the CRC.
    Loaded into workers through ``ZEEBE_BROKER_EXPORTERS_*``."""

    def configure(self, context) -> None:
        super().configure(context)
        self._dir = Path(context.configuration["dir"])

    def open(self, controller) -> None:
        self._controller = controller
        self._dir.mkdir(parents=True, exist_ok=True)
        name = f"export-{os.getpid()}-{time.monotonic_ns()}.jsonl"
        self._f = open(self._dir / name, "a", encoding="utf-8")

    def export(self, record) -> None:
        rec = record.record
        frame = rec.encode()[0]
        self._f.write(json.dumps({
            "pt": rec.partition_id,
            "p": record.position,
            "src": record.source_position,
            "rt": int(rec.record_type),
            "vt": int(rec.value_type),
            "it": int(rec.intent),
            "sid": rec.request_stream_id,
            "rid": rec.request_id,
            "crc": zlib.crc32(frame) & 0xFFFFFFFF,
        }, separators=(",", ":")) + "\n")
        # flush per record: a SIGKILLed worker must not lose acked export
        # evidence from its userspace buffer (rates here are checker-scale)
        self._f.flush()
        self._controller.update_last_exported_position(record.position)

    def close(self) -> None:
        try:
            self._f.close()
        except (OSError, AttributeError):
            pass


# ---------------------------------------------------------------------------
# history + checker (pure functions — unit-testable without a cluster)


@dataclasses.dataclass
class ClientOp:
    """One client request as the gateway observed it."""

    index: int
    partition: int
    kind: str                      # "deploy" | "create" | "create-missing"
    outcome: str = "pending"       # ack | rejected | backpressure | deadline
                                   # | no-leader | error
    request_id: int = -1
    position: int = -1
    worker: str | None = None
    resends: int = 0
    reroutes: int = 0
    dedupe: str | None = None      # "replayed" when answered from the table
    rejection: str | None = None
    submit_ms: float = 0.0
    done_ms: float = 0.0

    def row(self) -> dict:
        return dataclasses.asdict(self)


def submit_client_op(runtime, partition: int, kind: str, record, *,
                     history: list, history_lock, op_seq: list, clock_ms,
                     timeout_s: float) -> ClientOp:
    """One sequential-driver client request against the multi-process
    runtime, recorded with its routing evidence — the shared submit half
    of the consistency / torture / device-chaos harness drivers."""
    with history_lock:
        op_seq[0] += 1
        op = ClientOp(index=op_seq[0], partition=partition, kind=kind,
                      submit_ms=clock_ms())
    meta: dict = {}
    try:
        result = runtime.submit(partition, record, timeout_s=timeout_s,
                                meta=meta)
        op.outcome = "rejected" if result.is_rejection else "ack"
        if result.is_rejection:
            op.rejection = result.rejection_type.name
    except Exception as exc:  # noqa: BLE001 — typed below
        from zeebe_tpu_torch.gateway.broker_client import (
            DeadlineExceededError,
            NoLeaderError,
            ResourceExhaustedError,
        )

        op.outcome = (
            "backpressure" if isinstance(exc, ResourceExhaustedError)
            else "deadline" if isinstance(exc, DeadlineExceededError)
            else "no-leader" if isinstance(exc, NoLeaderError)
            else "error")
        if op.outcome == "error":
            op.rejection = repr(exc)[:200]
    op.done_ms = clock_ms()
    op.request_id = meta.get("requestId", -1)
    op.position = meta.get("commandPosition", -1)
    op.worker = meta.get("worker")
    op.resends = meta.get("resends", 0)
    op.reroutes = meta.get("reroutes", 0)
    op.dedupe = meta.get("dedupe")
    with history_lock:
        history.append(op)
    return op


def check_consistency(history: list[ClientOp],
                      logs: dict[int, list[dict]],
                      exports: dict[int, dict[int, dict]] | None = None,
                      ) -> list[str]:
    """The invariant suite over a finished run.

    ``logs``: per partition, the authoritative committed log as dicts with
    keys ``p`` (position), ``rt`` (record type int), ``rid``, ``sid``,
    ``rej`` (is_rejection). ``exports``: per partition, position → export
    line (already CRC-verified across duplicates by the caller).
    """
    from zeebe_tpu_torch.protocol import RecordType

    violations: list[str] = []
    command_rt = int(RecordType.COMMAND)
    rejection_rt = int(RecordType.COMMAND_REJECTION)

    by_partition_cmds: dict[int, dict[int, list[int]]] = {}
    for partition, records in logs.items():
        cmd_positions: dict[int, list[int]] = {}
        reply_kinds: dict[int, set[str]] = {}
        for rec in records:
            rid = rec.get("rid", -1)
            if rid < 0:
                continue
            if rec["rt"] == command_rt:
                cmd_positions.setdefault(rid, []).append(rec["p"])
            else:
                kind = "rejection" if rec["rt"] == rejection_rt else "result"
                reply_kinds.setdefault(rid, set()).add(kind)
        by_partition_cmds[partition] = cmd_positions
        # no duplicate application: a request id owns at most one command
        for rid, positions in cmd_positions.items():
            if len(positions) > 1:
                violations.append(
                    f"partition {partition}: request {rid} appended "
                    f"{len(positions)} times at positions {positions} "
                    f"(duplicate application)")
        # rejections are terminal: one request's replies never mix kinds
        for rid, kinds in reply_kinds.items():
            if len(kinds) > 1:
                violations.append(
                    f"partition {partition}: request {rid} has both a "
                    f"rejection and a result reply (rejection not terminal)")

    last_ack_position: dict[int, int] = {}
    acked = [op for op in sorted(history, key=lambda o: o.done_ms)
             if op.outcome == "ack"]
    for op in acked:
        cmds = by_partition_cmds.get(op.partition, {})
        positions = cmds.get(op.request_id, [])
        # no acked command lost (log evidence)
        if not positions:
            violations.append(
                f"partition {op.partition}: acked request {op.request_id} "
                f"(op #{op.index}) has no command in the log (acked loss)")
            continue
        if op.position >= 0 and positions != [op.position]:
            violations.append(
                f"partition {op.partition}: acked request {op.request_id} "
                f"acked position {op.position} but the log has it at "
                f"{positions}")
        # no acked command lost (export-stream evidence)
        if exports is not None:
            exported = exports.get(op.partition, {})
            if positions[0] not in exported:
                violations.append(
                    f"partition {op.partition}: acked request "
                    f"{op.request_id} at {positions[0]} never exported "
                    f"(acked loss on the export stream)")
        # monotone per partition: sequential driver ⇒ strictly increasing
        # first-ack positions in completion order
        prev = last_ack_position.get(op.partition)
        if prev is not None and positions[0] <= prev:
            violations.append(
                f"partition {op.partition}: acked position {positions[0]} "
                f"(op #{op.index}) not after previous ack {prev} "
                f"(gateway-observed positions regressed)")
        last_ack_position[op.partition] = positions[0]

    return violations


# ---------------------------------------------------------------------------
# offline evidence collection


def read_partition_log(stream_dir: Path, partition_id: int) -> list[dict]:
    """Decode one replica's materialized stream journal (the committed
    prefix) into checker rows. Opens read-write AFTER teardown — the
    journal's own open() truncates any crash-torn suffix exactly like a
    real recovery would."""
    from zeebe_tpu_torch.journal import SegmentedJournal
    from zeebe_tpu_torch.logstreams import LogStream

    journal = SegmentedJournal(stream_dir)
    try:
        stream = LogStream(journal, partition_id)
        out = []
        for logged in stream.new_reader(1):
            rec = logged.record
            out.append({
                "p": logged.position,
                "src": logged.source_position,
                "rt": int(rec.record_type),
                "vt": int(rec.value_type),
                "it": int(rec.intent),
                "rid": rec.request_id,
                "sid": rec.request_stream_id,
                "rej": rec.is_rejection,
                "crc": zlib.crc32(rec.encode()[0]) & 0xFFFFFFFF,
            })
        return out
    finally:
        journal.close()


def collect_logs(data_dir: Path, workers: list[str],
                 partitions: int) -> tuple[dict[int, list[dict]], list[str]]:
    """Per partition: every replica's committed log, cross-checked — the
    overlapping prefixes of two replicas must agree record-for-record
    (same frame CRC at the same position) — and the longest replica's log
    as the authoritative one."""
    logs: dict[int, list[dict]] = {}
    violations: list[str] = []
    for pid in range(1, partitions + 1):
        replicas: list[tuple[str, list[dict]]] = []
        for worker in workers:
            stream_dir = data_dir / worker / f"partition-{pid}" / "stream"
            if stream_dir.exists():
                try:
                    replicas.append((worker, read_partition_log(stream_dir, pid)))
                except Exception as exc:  # noqa: BLE001 — a torn replica is
                    violations.append(    # evidence, not a crash
                        f"partition {pid}: replica {worker} unreadable: {exc}")
        if not replicas:
            logs[pid] = []
            continue
        by_position: dict[int, tuple[str, dict]] = {}
        for worker, records in replicas:
            for rec in records:
                seen = by_position.get(rec["p"])
                if seen is None:
                    by_position[rec["p"]] = (worker, rec)
                elif seen[1]["crc"] != rec["crc"]:
                    violations.append(
                        f"partition {pid}: position {rec['p']} diverges "
                        f"between replicas {seen[0]} and {worker} "
                        f"(committed-log split-brain)")
        replicas.sort(key=lambda wr: len(wr[1]), reverse=True)
        logs[pid] = replicas[0][1]
    return logs, violations


def collect_exports(export_dir: Path) -> tuple[dict[int, dict[int, dict]],
                                               list[str], int]:
    """Merge every container lifetime's JSONL stream. Re-exported positions
    (at-least-once across restarts) must be byte-identical — divergent CRCs
    are violations. Returns (per-partition position→line, violations,
    re-exported line count)."""
    exports: dict[int, dict[int, dict]] = {}
    violations: list[str] = []
    re_exports = 0
    for path in sorted(export_dir.glob("export-*.jsonl")):
        try:
            lines = path.read_text(encoding="utf-8").splitlines()
        except OSError:
            continue
        for raw in lines:
            if not raw.strip():
                continue
            try:
                line = json.loads(raw)
            except ValueError:
                continue  # torn tail line of a killed worker
            part = exports.setdefault(line["pt"], {})
            seen = part.get(line["p"])
            if seen is None:
                part[line["p"]] = line
            else:
                re_exports += 1
                if seen["crc"] != line["crc"]:
                    violations.append(
                        f"partition {line['pt']}: position {line['p']} "
                        f"re-exported with different bytes "
                        f"(crc {seen['crc']} vs {line['crc']})")
    return exports, violations, re_exports
# end of the copy


# ---------------------------------------------------------------------------
# the harness


@dataclasses.dataclass
class ConsistencyConfig:
    seed: int = 0
    workers: int = 3
    partitions: int = 2
    # RF = worker count: killing one leader leaves a quorum, so kills cause
    # real leader TRANSFERS (RF=2 would just stall the partition until the
    # supervisor restart — no transfer to check dedupe inheritance against)
    replication: int = 3
    drive_seconds: float = 25.0
    think_ms: float = 15.0          # driver pause between submits
    request_timeout_s: float = 20.0
    kills: int = 3                  # seeded kill_worker storm size
    link_windows: int = 2           # scheduled TCP link partitions
    link_window_ms: int = 1500
    drop_p: float = 0.01
    duplicate_p: float = 0.02
    delay_p: float = 0.03
    reorder_p: float = 0.02
    crash_after_appends: int = 3    # arms ONE worker (one-shot)
    reject_every: int = 25          # every Nth request targets a missing
                                    # process id → terminal NOT_FOUND
    kernel_backend: bool = False    # quick/CI: skip per-worker XLA warmup
    #: the workers' kernel backend device (``--device``): None runs them on
    #: the card, ``"cpu"`` on the plain version
    device: str | None = None


def run_consistency(cfg: ConsistencyConfig, directory: str | Path) -> dict:
    """Run the full gate; returns the report dict (violations inside)."""
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
    from zeebe_tpu_torch.testing.chaos import FaultPlan
    from zeebe_tpu_torch.testing.chaos_tcp import LinkWindow, format_spec

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

    # seeded fault scenario: probabilistic TCP faults ride the boot spec;
    # link-partition WINDOWS are scheduled only once the fleet is actually
    # up — the controller writes the dynamically-reloaded windows file at
    # drive start, so the windows land mid-drive regardless of boot time
    # (a hard-coded boot estimate either expired before the first request
    # on a slow runner or overshot the drive on a fast one)
    plan = FaultPlan(seed=cfg.seed, drop_p=cfg.drop_p,
                     duplicate_p=cfg.duplicate_p, delay_p=cfg.delay_p,
                     reorder_p=cfg.reorder_p, max_delay_ticks=3)
    chaos_spec = format_spec(plan, [], tick_ms=50)
    windows_file = directory / "chaos-windows.txt"
    windows: list[LinkWindow] = []

    def schedule_link_windows() -> None:
        """Called at drive start: windows between seeded worker pairs,
        spread over the first ~70% of the drive, relative to the shared
        epoch NOW (boot already paid)."""
        now_rel = time.time() * 1000.0 - epoch_ms
        for i in range(cfg.link_windows):
            a, b = rng.sample(worker_names, 2)
            start = now_rel + rng.uniform(0.1, 0.7) * cfg.drive_seconds * 1000.0
            windows.append(LinkWindow(a, b, int(start),
                                      int(start + cfg.link_window_ms)))
        windows_file.write_text("".join(
            f"{w.a}|{w.b}@{w.start_ms}-{w.end_ms}\n" for w in windows),
            encoding="utf-8")

    repo = str(Path(__file__).resolve().parent.parent.parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH")) if p)
    if not cfg.kernel_backend:
        env["ZEEBE_BROKER_EXPERIMENTAL_KERNELBACKEND"] = "false"
    env["ZEEBE_CHAOS_TCP"] = chaos_spec
    env["ZEEBE_CHAOS_EPOCH_MS"] = str(epoch_ms)
    env["ZEEBE_CHAOS_TCP_WINDOWSFILE"] = str(windows_file)
    env["ZEEBE_BROKER_EXPORTERS_CONSIST_CLASSNAME"] = \
        "zeebe_tpu_torch.testing.consistency.JsonlExporter"
    env["ZEEBE_BROKER_EXPORTERS_CONSIST_ARGS_DIR"] = str(export_dir)

    # arm EVERY worker (each one-shot per data dir): whichever member wins
    # the elections serves ingress, so the crash-between-append-and-reply
    # fires by construction regardless of where leadership lands
    armed = cfg.crash_after_appends > 0
    specs = []
    for name in worker_names:
        data_dir = str(directory / name)
        extra = None
        if armed:
            extra = {"ZEEBE_CHAOS_CRASH_AFTER_APPENDS":
                     str(cfg.crash_after_appends)}
        specs.append(WorkerSpec(
            node_id=name,
            cmd=worker_cmd(name, f"127.0.0.1:{contacts[name][1]}",
                           contact_str, "gateway-0", cfg.partitions,
                           cfg.replication, data_dir=data_dir,
                           device=cfg.device),
            data_dir=data_dir, extra_env=extra))
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

    def clock_ms() -> float:
        return time.time() * 1000.0 - epoch_ms

    def submit_op(partition: int, kind: str, record) -> ClientOp:
        return submit_client_op(
            runtime, partition, kind, record, history=history,
            history_lock=history_lock, op_seq=op_seq, clock_ms=clock_ms,
            timeout_s=cfg.request_timeout_s)

    model = (Bpmn.create_executable_process("consist")
             .start_event("s").end_event("e").done())
    deploy = command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {
        "resources": [{"resourceName": "consist.bpmn",
                       "resource": to_bpmn_xml(model)}]})

    def create_cmd(process_id: str = "consist"):
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
                # a command that terminally rejects (NOT_FOUND): the checker
                # proves the rejection stays terminal under resends
                submit_op(partition, "create-missing",
                          create_cmd("no-such-process"))
            else:
                submit_op(partition, "create", create_cmd())
            time.sleep(cfg.think_ms / 1000.0)

    def chaos_schedule() -> list[tuple[float, str, str]]:
        """(at_s since drive start, action, target) — the kill storm."""
        out = []
        for i in range(cfg.kills):
            at = rng.uniform(0.15, 0.8) * cfg.drive_seconds
            target = worker_names[rng.randrange(len(worker_names))]
            out.append((at, "kill", target))
        return sorted(out)

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
        # deploy on partition 1; the deployment distributes to the rest —
        # wait until every partition serves creates before chaos starts
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
        schedule_link_windows()
        drivers = [threading.Thread(target=drive, args=(pid,), daemon=True,
                                    name=f"driver-{pid}")
                   for pid in range(1, cfg.partitions + 1)]
        for t in drivers:
            t.start()
        for at, action, target in chaos_schedule():
            delay = drive_started + at - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            logger.warning("chaos: %s %s at t=%.1fs", action, target, at)
            events.append({"atMs": clock_ms(), "action": action,
                           "target": target})
            supervisor.kill_worker(target)
        remaining = drive_started + cfg.drive_seconds - time.monotonic()
        if remaining > 0:
            time.sleep(remaining)
        stop_driving.set()
        for t in drivers:
            t.join(timeout=cfg.request_timeout_s + 10)

        # post-drive probe: kill a leader and resend an ANSWERED request's
        # envelope — the replicated dedupe table must replay the stored
        # reply across the process death (the acceptance sequence, pinned)
        probe = _dedupe_replay_probe(runtime, supervisor, history, events,
                                     clock_ms)
        report["dedupeProbe"] = probe

        # quiesce: leaders back, exporters caught up to the acked frontier
        quiesce_deadline = time.monotonic() + 90.0
        while time.monotonic() < quiesce_deadline:
            try:
                runtime.await_leaders(timeout_s=5.0)
                break
            except RuntimeError:
                continue
        _await_exports(export_dir, history, deadline_s=60.0)
        report["routingEpochs"] = runtime.routing_epoch
        report["gatewayFlight"] = runtime.flight.snapshot()
        report["workerRestarts"] = dict(supervisor.restarts)
    finally:
        try:
            runtime.stop()
        except Exception:  # noqa: BLE001 — teardown must reach evidence
            logger.exception("runtime stop failed")

    # ---- offline evidence + checks ----------------------------------------
    logs, log_violations = collect_logs(directory, worker_names,
                                        cfg.partitions)
    exports, export_violations, re_exports = collect_exports(export_dir)
    violations = log_violations + export_violations
    violations += check_consistency(history, logs, exports)

    # observed TCP-fault evidence (periodic per-process-life snapshots from
    # the workers' chaos wrappers): configured-but-never-applied chaos must
    # fail the gate, not silently report coverage
    tcp_chaos: dict[str, int] = {}
    for counts_path in directory.glob("*/chaos-counts-*.json"):
        try:
            counts = json.loads(counts_path.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            continue
        for key, value in counts.items():
            if isinstance(value, int):
                tcp_chaos[key] = tcp_chaos.get(key, 0) + value
    if cfg.link_windows > 0 and not tcp_chaos.get("link_blocked"):
        violations.append(
            f"{cfg.link_windows} link-partition window(s) configured but no "
            f"worker observed a blocked frame (windows missed the run)")

    crash_markers = [name for name in worker_names
                     if (directory / name
                         / "chaos-crash-after-append.done").exists()]
    crash_fired = armed and bool(crash_markers)
    # the armed crash + every kill that interrupted an in-flight request:
    # acked despite ≥1 resend, exactly one command in the log (checked
    # above) — the crash/kill → resend → dedupe evidence
    recovered = [op.row() for op in history
                 if op.outcome == "ack" and (op.resends or op.reroutes)]
    crash_sequences = len(recovered) + (1 if report.get(
        "dedupeProbe", {}).get("verified") else 0)
    if crash_fired and not crash_sequences:
        violations.append(
            "armed crash-between-append-and-reply fired but no request "
            "survived it through a resend (dedupe sequence unverified)")
    if report.get("dedupeProbe", {}).get("verified") is False:
        violations.append(
            f"dedupe replay probe failed: {report['dedupeProbe']}")

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
        "linkPartitionWindows": len(windows),
        "linkWindows": [dataclasses.asdict(w) for w in windows],
        "tcpChaosObserved": tcp_chaos,
        "chaosSpec": chaos_spec,
        "events": events,
        "crashBetweenAppendAndReplyFired": crash_fired,
        "crashArmedWorkersFired": crash_markers,
        "crashSequencesVerified": crash_sequences,
        "resentAckedRequests": recovered[:50],
        "dedupeRepliesObserved": sum(1 for op in history
                                     if op.dedupe == "replayed"),
        "reExportedRecords": re_exports,
        "logRecords": {str(p): len(r) for p, r in logs.items()},
        "exportedPositions": {str(p): len(v) for p, v in exports.items()},
        "violations": violations,
        "wallSeconds": round(time.monotonic() - started, 2),
    })
    return report


# copied from the reference: _await_exports .. _dedupe_replay_probe
def _await_exports(export_dir: Path, history: list[ClientOp],
                   deadline_s: float) -> None:
    """Block until the export stream covers every acked position (or the
    deadline passes — the checker then reports the loss as a violation)."""
    want: dict[int, int] = {}
    for op in history:
        if op.outcome == "ack" and op.position >= 0:
            want[op.partition] = max(want.get(op.partition, 0), op.position)
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        exports, _, _ = collect_exports(export_dir)
        if all(want_pos in exports.get(pid, {})
               for pid, want_pos in want.items()):
            return
        time.sleep(0.5)


def _dedupe_replay_probe(runtime, supervisor, history: list[ClientOp],
                         events: list[dict], clock_ms) -> dict:
    """Deterministic acceptance sequence: take an ACKED create, SIGKILL the
    partition's current leader (wiping its in-memory ingress maps), wait
    for service to return, then resend the original envelope. The reply
    must come back flagged ``dedupe: replayed`` with the ORIGINAL command
    position — proof the stored reply survived the process death in the
    replicated table."""
    from zeebe_tpu_torch.multiproc.worker import CLIENT_COMMAND_TOPIC
    from zeebe_tpu_torch.protocol import ValueType
    from zeebe_tpu_torch.protocol.intent import ProcessInstanceCreationIntent
    from zeebe_tpu_torch.protocol.record import command

    candidates = [op for op in history
                  if op.kind == "create" and op.outcome == "ack"
                  and op.request_id >= 0 and op.position >= 0]
    if not candidates:
        return {"verified": False, "reason": "no acked create to probe"}
    op = candidates[-1]
    leader = runtime._leader_of(op.partition)
    if leader is None:
        return {"verified": False, "reason": "no leader to kill"}
    events.append({"atMs": clock_ms(), "action": "kill-probe",
                   "target": leader})
    supervisor.kill_worker(leader)
    time.sleep(1.0)

    rec = command(ValueType.PROCESS_INSTANCE_CREATION,
                  ProcessInstanceCreationIntent.CREATE,
                  {"bpmnProcessId": "consist", "version": -1,
                   "variables": {}}).replace(
        request_id=op.request_id, request_stream_id=runtime._stream_id)
    payload = {"record": rec.to_bytes(), "requestId": op.request_id}
    # re-arm the gateway's correlation table for the finished request id and
    # resend until a (possibly different) leader answers
    event = threading.Event()
    runtime._pending[op.request_id] = event
    try:
        deadline = time.monotonic() + 90.0
        while time.monotonic() < deadline:
            target = runtime._leader_of(op.partition)
            if target is None:
                time.sleep(0.2)
                continue
            runtime.messaging.send(
                target, f"{CLIENT_COMMAND_TOPIC}-{op.partition}", payload)
            if event.wait(1.0):
                response = runtime._responses.pop(op.request_id, None)
                if response is None:
                    event.clear()
                    continue
                if "record" not in response:
                    # not-leader/unavailable while the cluster re-elects:
                    # keep probing
                    event.clear()
                    time.sleep(0.2)
                    continue
                return {
                    "verified":
                        response.get("dedupe") == "replayed"
                        and response.get("commandPosition") == op.position,
                    "requestId": op.request_id,
                    "originalPosition": op.position,
                    "replayedPosition": response.get("commandPosition"),
                    "dedupe": response.get("dedupe"),
                    "killedLeader": leader,
                    "answeredBy": target,
                }
        return {"verified": False, "reason": "probe timed out",
                "requestId": op.request_id, "killedLeader": leader}
    finally:
        runtime._pending.pop(op.request_id, None)
        runtime._responses.pop(op.request_id, None)
# end of the copy


def main(argv: list[str] | None = None) -> int:  # pragma: no cover — manual
    import argparse
    import tempfile

    parser = argparse.ArgumentParser(prog="zeebe-tpu-consistency")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--device", default=None,
                        help="the workers' kernel backend device (default: "
                             "the card; cpu runs the plain version)")
    parser.add_argument("--drive-seconds", type=float, default=None,
                        help="the drive's length in place of the preset's "
                             "(a worker restarts in ~20 s on the card, ~1 s "
                             "on the CPU)")
    args = parser.parse_args(argv)
    cfg = ConsistencyConfig(seed=args.seed, device=args.device)
    if not args.quick:
        cfg.drive_seconds = 120.0
        cfg.kills = 8
        cfg.link_windows = 5
    if args.drive_seconds is not None:
        cfg.drive_seconds = args.drive_seconds
    with tempfile.TemporaryDirectory(prefix="zeebe-consistency-") as tmp:
        report = run_consistency(cfg, tmp)
    json.dump(report, sys.stdout, indent=2)
    return 1 if report["violations"] else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
