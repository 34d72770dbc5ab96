"""Worker process: one Broker behind the multi-process gateway.

Reference: a deployed StandaloneBroker instance minus the embedded gateway —
the broker, its partitions, Raft/SWIM over TCP messaging, and a management
port. The gateway-facing protocol on top:

- ``mp-client-command-<partition>``: client command ingress. The envelope
  carries the serialized record plus the gateway request id (trace
  satellite: the id that annotates lineage roots), and — unlike the
  raw ``command-api`` topic — replies with a typed ERROR frame on
  backpressure / not-leader / paused, so the gateway can surface
  RESOURCE_EXHAUSTED vs retry instead of timing out blind.
- ``gateway-response``: processing results routed back to the ORIGIN gateway
  by the record's ``request_stream_id`` (index into the sorted member list,
  gateways included — the reference does the same with gateway stream ids
  over atomix messaging). The reply carries the command's position so the
  gateway can mint its root span with the SAME trace id
  (``partition:position``) the worker-side spans use.
- ``worker-status``: periodic (and on-role-change) status push to every
  gateway: the same per-broker row ``/cluster/status`` aggregates in-process
  (health, roles, rates, firing alerts) plus worker pid and the partitions'
  last-recovery records — a supervisor-restarted worker's recovery
  accounting is visible on the gateway's ``/cluster/status`` without an
  extra HTTP hop.
- ``jobs-available``: long-poll/stream wakeups forwarded to the gateways.

``WorkerRuntime`` is messaging-injectable (tests drive a gateway runtime and
a worker over the deterministic loopback network in one process); ``main()``
is the real process entry (``python -m zeebe_tpu_torch.multiproc.worker``).

The port's ``main`` takes ``--device`` (none = the card) and gives it to the
broker's config; on the card its start-up guard stops the worker where no
card answers (the reference pins the CPU there) and brings the card up
before the broker binds. ``WorkerRuntime`` is the reference's, copied.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from zeebe_tpu_torch.protocol import Record

# copied from the reference: CLIENT_COMMAND_TOPIC .. _TestLeak
CLIENT_COMMAND_TOPIC = "mp-client-command"  # + "-<partition id>"
GATEWAY_RESPONSE_TOPIC = "mp-gateway-response"
WORKER_STATUS_TOPIC = "mp-worker-status"
JOBS_AVAILABLE_TOPIC = "mp-jobs-available"

#: bound on the request-id → command-position map (responses normally pop
#: their entry; a request whose gateway timed out never will — the oldest
#: entries are evicted past this, keeping dedupe live for recent traffic)
_MAX_INFLIGHT = 65536


class WorkerRuntime:
    """One broker + the gateway-facing protocol, pump-driven."""

    def __init__(self, node_id: str, messaging, gateway_members: list[str],
                 cfg, directory=None, status_interval_ms: int = 1000,
                 coalesce_window_ms: float = 0.0,
                 **broker_kwargs) -> None:
        from zeebe_tpu_torch.broker import Broker

        self.node_id = node_id
        self.messaging = messaging
        self.gateway_members = list(gateway_members)
        # response routing table: request_stream_id indexes this list — the
        # gateway computes the SAME sorted union, so indices agree without a
        # handshake
        self._route_members = sorted(
            set(cfg.cluster_members) | set(gateway_members))
        self.broker = Broker(
            cfg, messaging, directory=directory,
            response_sink=self._on_processing_response, **broker_kwargs)
        self.broker.jobs_listener = self._on_jobs_available
        # idempotent ingress for a LIVE worker: the gateway RESENDS an
        # unanswered envelope (e.g. its first send raced this worker's
        # restart); appending it twice would duplicate the command, so
        # remember what was appended (in flight) and replay the reply for
        # what was already answered. Keys are (gateway, request id) — two
        # gateways booted in the same millisecond derive the same request-id
        # nonce, and a bare-id collision would drop one's command or replay
        # the other's reply to it. Both maps are bounded LRU (a request
        # whose gateway timed out never gets a response and would leak its
        # in-flight entry forever — evicting the OLDEST keeps dedupe live
        # for everything recent instead of silently turning off at a cap).
        # These in-memory maps are only the FAST path now: a crash between
        # append and reply loses them, but ingress falls back to the
        # partition's replicated dedupe (pending-request window rebuilt from
        # the log at leader transitions + the REQUEST_DEDUPE column family
        # materialized on processing and replay — state/request_dedupe.py),
        # so a gateway resend to the restarted worker or the new leader
        # yields exactly one appended command.
        from collections import OrderedDict

        self._inflight_positions: OrderedDict[tuple, int] = OrderedDict()
        self._recent_replies: OrderedDict[tuple, dict] = OrderedDict()
        # tenant-aware admission in front of the per-partition backpressure
        # limiters: the worker's own gate — a multi-gateway
        # deployment cannot rely on any single gateway's buckets. Sheds are
        # typed `resource-exhausted` frames (the gateway maps them to
        # RESOURCE_EXHAUSTED) and the shed ladder's feedback signal is the
        # observed append→reply latency, read back through the broker's
        # time-series store when the metrics plane is on (signal latency =
        # one sampler tick) or the controller's own window otherwise.
        from zeebe_tpu_torch.gateway.admission import AdmissionCfg, AdmissionController

        self.admission = AdmissionController(
            AdmissionCfg.from_env(), node_id=node_id,
            clock_millis=lambda: float(self.broker.clock_millis()),
            flight=self.broker.flight_recorder,
            max_inflight_fn=self._admission_window,
            p99_source=self._store_p99)
        self._inflight_tenants: OrderedDict[tuple, tuple[str, int]] = \
            OrderedDict()
        # ingress batch-coalescing window: with window > 0,
        # admitted client commands queue per partition and append as ONE
        # raft batch when the window elapses (or the batch cap fills) —
        # one fsync + one replication round instead of N. 0 keeps the
        # legacy append-per-frame byte path exactly. The static value
        # comes from ZEEBE_BROKER_PROCESSING_COALESCEWINDOWMS; at runtime
        # the ingress-coalescing controller's actuator owns this knob.
        self.coalesce_window_ms = float(coalesce_window_ms)
        self.coalesce_max_batch = 128
        self._ingress_pending: dict[int, list[dict]] = {}
        self._ingress_first_ms: dict[int, float] = {}
        self._queued_ingress_keys: set[tuple] = set()
        if self.broker.control is not None:
            # the coalescing knob lives at THIS ingress seam, so the worker
            # (not the bare broker) wires its loop; the admission shed
            # ladder registers as a read-only aggregated loop so `cli top`
            # CONTROL shows every closed loop in one place
            self.broker.control.add_coalescing_controller(
                lambda: self.coalesce_window_ms,
                self._set_coalesce_window,
                static_ms=self.coalesce_window_ms)
            self.broker.control.register_loop(
                "admission-shed-ladder", self._admission_loop_snapshot)
        # chaos seam: crash THIS process between a successful
        # append and its reply after N ingress appends — one-shot per data
        # dir (a marker file disarms it after the restart), letting the
        # consistency harness pin the crash-between-append-and-reply →
        # resend → dedupe sequence deterministically
        self._crash_after_appends: int | None = None
        self._crash_marker = None
        crash_spec = os.environ.get("ZEEBE_CHAOS_CRASH_AFTER_APPENDS")
        if crash_spec and directory is not None:
            from pathlib import Path

            try:
                count = int(crash_spec)
            except ValueError:
                count = 0
            marker = Path(directory) / "chaos-crash-after-append.done"
            if count > 0 and not marker.exists():
                self._crash_after_appends = count
                self._crash_marker = marker
        self._status_interval_ms = status_interval_ms
        self._last_status_ms = 0
        self._last_roles: dict[str, str] = {}
        for pid in range(1, cfg.partition_count + 1):
            messaging.subscribe(
                f"{CLIENT_COMMAND_TOPIC}-{pid}",
                lambda s, p, pid=pid: self._on_client_command(pid, s, p))

    # -- admission plumbing ----------------------------------------------------

    def _admission_window(self) -> int:
        """The weighted-fair share's window: the sum of the LEADER
        partitions' current adaptive backpressure limits — admission sits
        exactly in front of the limiters, so its window is theirs."""
        total = 0
        for partition in self.broker.partitions.values():
            if partition.is_leader and partition.limiter is not None:
                total += partition.limiter.limit
        return total

    def _store_p99(self) -> float | None:
        """Shed signal from the Gorilla plane: the sampler distills the
        controller's own ack-latency histogram into a retained ``:p99``
        series; a stale sample (idle broker, sampler off) yields None so
        the controller falls back to its in-process window."""
        store = getattr(self.broker, "timeseries", None)
        if store is None:
            return None
        now_ms = self.broker.clock_millis()
        values = [entry["value"]
                  for entry in store.latest("zeebe_admission_ack_latency_ms:p99")
                  if self.node_id in entry["labels"]
                  and now_ms - entry["t"] <= 15_000]
        return max(values) if values else None

    def _release_admission(self, dedupe_key: tuple,
                           observe: bool = True) -> None:
        entry = self._inflight_tenants.pop(dedupe_key, None)
        if entry is not None:
            tenant, t0 = entry
            latency = float(self.broker.clock_millis() - t0) if observe \
                else None
            self.admission.release(tenant, latency_ms=latency)

    # -- command ingress -------------------------------------------------------

    def _reply_error(self, gateway: str, request_id: int, kind: str,
                     message: str) -> None:
        self.messaging.send(gateway, GATEWAY_RESPONSE_TOPIC, {
            "requestId": request_id,
            "error": {"type": kind, "message": message},
        })

    def _on_client_command(self, partition_id: int, sender: str,
                           payload: dict) -> None:
        from zeebe_tpu_torch.broker.partition import BackpressureExceeded

        record = Record.from_bytes(payload["record"])
        request_id = payload.get("requestId", record.request_id)
        dedupe_key = (sender, request_id)
        if dedupe_key in self._inflight_positions:
            return  # duplicate resend: already appended, reply is coming
        if dedupe_key in self._queued_ingress_keys:
            return  # duplicate resend: queued in the coalescing window
        replay = self._recent_replies.get(dedupe_key)
        if replay is not None:
            self.messaging.send(sender, GATEWAY_RESPONSE_TOPIC, replay)
            return  # duplicate resend of an already-answered request
        partition = self.broker.partitions.get(partition_id)
        if partition is None or not partition.is_leader:
            # the worker did NOT append: the gateway may safely re-route
            self._reply_error(sender, request_id, "not-leader",
                              f"{self.node_id} does not lead partition "
                              f"{partition_id}")
            return
        if not partition.ready_for_ingress:
            # leader mid-recovery (replay barrier / startup replay): its
            # replicated dedupe window is not complete yet, so appending now
            # could duplicate a command this very log already carries. We
            # did NOT append — the gateway retries until recovery finishes.
            self._reply_error(sender, request_id, "unavailable",
                              f"partition {partition_id} leader is "
                              f"recovering")
            return
        # replicated dedupe: the in-memory maps above die with the
        # process; this consult survives crashes because the table is
        # materialized from the replicated log on processing AND replay —
        # the resend after a crash-between-append-and-reply lands here
        hit = partition.lookup_request(record.request_stream_id, request_id)
        if hit is not None:
            kind, entry = hit
            if kind == "replied":
                reply = {
                    "requestId": request_id,
                    "record": entry["f"],
                    "commandPosition": entry["c"],
                    "dedupe": "replayed",
                }
                self._recent_replies[dedupe_key] = reply
                while len(self._recent_replies) > 4096:
                    self._recent_replies.popitem(last=False)
                self.messaging.send(sender, GATEWAY_RESPONSE_TOPIC, reply)
                return
            # appended (or processed-awaiting, e.g. await-result): do NOT
            # append again; processing answers it through the normal reply
            # path. Backfill the in-flight map so that reply carries the
            # original command position.
            self._inflight_positions[dedupe_key] = entry["c"]
            while len(self._inflight_positions) > _MAX_INFLIGHT:
                self._inflight_positions.popitem(last=False)
            return
        # tenant admission — AFTER the dedupe consults (a resend
        # of an already-appended request must reach its stored answer, not
        # a shed) and BEFORE the partition limiter, so one hot tenant
        # exhausts its own share instead of the whole in-flight window
        shed_reason, tenant, _priority = self.admission.try_admit(record)
        if shed_reason is not None:
            self._reply_error(
                sender, request_id, "resource-exhausted",
                f"admission shed ({shed_reason}): tenant {tenant!r} on "
                f"partition {partition_id} (shed level "
                f"{self.admission.shed_level})")
            return
        entry = {"sender": sender, "requestId": request_id,
                 "key": dedupe_key, "record": record, "tenant": tenant,
                 "enqMs": self.broker.clock_millis()}
        if self.coalesce_window_ms > 0:
            # batch-coalescing window: queue the ADMITTED
            # command; the pump flushes the partition's queue as one raft
            # batch when the window elapses or the batch cap fills
            queue = self._ingress_pending.setdefault(partition_id, [])
            if not queue:
                self._ingress_first_ms[partition_id] = float(entry["enqMs"])
            queue.append(entry)
            self._queued_ingress_keys.add(dedupe_key)
            if len(queue) >= self.coalesce_max_batch:
                self._flush_ingress_partition(partition_id)
            return
        try:
            position = partition.client_write(record)
        except BackpressureExceeded as exc:
            self.admission.release(tenant)
            self._reply_error(sender, request_id, "backpressure", str(exc))
            return
        except OSError as exc:
            # storage fault under the append: nothing was acked
            # — we did NOT durably append, so the gateway may retry; the
            # journal/raft layers own the repair
            self.admission.release(tenant)
            self._reply_error(sender, request_id, "unavailable",
                              f"storage fault on partition {partition_id}: "
                              f"{type(exc).__name__}")
            return
        if position is None:
            self.admission.release(tenant)
            self._reply_error(sender, request_id, "unavailable",
                              f"partition {partition_id} paused or disk-paused")
            return
        self._note_appended(entry, partition_id, position, partition)

    def _note_appended(self, entry: dict, partition_id: int, position: int,
                       partition) -> None:
        """Post-append bookkeeping shared by the direct and coalesced
        ingress paths: chaos seam, dedupe/in-flight maps, admission t0,
        and the cross-process ingress span."""
        from zeebe_tpu_torch.observability.tracer import get_tracer

        self._maybe_chaos_crash(partition)
        dedupe_key = entry["key"]
        self._inflight_positions[dedupe_key] = position
        while len(self._inflight_positions) > _MAX_INFLIGHT:
            self._inflight_positions.popitem(last=False)
        # latency t0 is the ENQUEUE time: the coalescing window's own
        # delay must count against the shed ladder's ack-latency signal
        self._inflight_tenants[dedupe_key] = (entry["tenant"],
                                              entry["enqMs"])
        while len(self._inflight_tenants) > _MAX_INFLIGHT:
            # evicted entries (gateway gave up; no reply will come) still
            # release their in-flight slot — a leak here would slowly
            # starve the tenant's fair share
            stale_key = next(iter(self._inflight_tenants))
            self._release_admission(stale_key, observe=False)
        tracer = get_tracer()
        if tracer.enabled:
            # cross-process Dapper discipline: the trace id is DERIVED
            # (partition:position), identical on both sides of the process
            # boundary; this span records where the command crossed it
            trace_id = f"{partition_id}:{position}"
            if tracer.sampled(trace_id):
                tracer.emit(trace_id, "gateway.ingress", 0.0, partition_id,
                            attrs={"requestId": entry["requestId"],
                                   "gateway": entry["sender"],
                                   "worker": self.node_id,
                                   "workerPid": os.getpid()})
                # coalesce-window wait: enqueue→append, ms-clock resolution
                # (the window itself is ms-scale). The direct path appends
                # within the same millisecond and emits nothing — the span
                # set records the wait only where a wait existed.
                wait_ms = self.broker.clock_millis() - entry["enqMs"]
                if wait_ms > 0:
                    tracer.emit(trace_id, "gateway.coalesce_wait",
                                wait_ms / 1000.0, partition_id,
                                parent="gateway.ingress",
                                attrs={"windowMs": self.coalesce_window_ms})

    def _flush_due_ingress(self) -> int:
        """Flush every partition queue whose coalescing window elapsed (a
        shrunken window — the controller narrowing it — flushes on the
        next pump round)."""
        now = float(self.broker.clock_millis())
        flushed = 0
        for pid in list(self._ingress_pending):
            if (now - self._ingress_first_ms.get(pid, now)
                    >= self.coalesce_window_ms):
                flushed += self._flush_ingress_partition(pid)
        return flushed

    def _flush_ingress_partition(self, partition_id: int) -> int:
        """Append one partition's queued commands as ONE raft batch, then
        run the per-record bookkeeping / typed error replies."""
        entries = self._ingress_pending.pop(partition_id, [])
        self._ingress_first_ms.pop(partition_id, None)
        if not entries:
            return 0
        for entry in entries:
            self._queued_ingress_keys.discard(entry["key"])
        partition = self.broker.partitions.get(partition_id)
        if partition is None or not partition.is_leader:
            # leadership moved inside the window: nothing was appended, so
            # the gateway may safely re-route the same request ids
            for entry in entries:
                self.admission.release(entry["tenant"])
                self._reply_error(entry["sender"], entry["requestId"],
                                  "not-leader",
                                  f"{self.node_id} no longer leads "
                                  f"partition {partition_id}")
            return 0
        if not partition.ready_for_ingress:
            for entry in entries:
                self.admission.release(entry["tenant"])
                self._reply_error(entry["sender"], entry["requestId"],
                                  "unavailable",
                                  f"partition {partition_id} leader is "
                                  f"recovering")
            return 0
        try:
            results = partition.client_write_batch(
                [entry["record"] for entry in entries])
        except OSError as exc:
            # storage fault under the batched append: nothing
            # was acked; typed unavailable, gateway retries
            for entry in entries:
                self.admission.release(entry["tenant"])
                self._reply_error(entry["sender"], entry["requestId"],
                                  "unavailable",
                                  f"storage fault on partition "
                                  f"{partition_id}: {type(exc).__name__}")
            return 0
        for entry, (status, position) in zip(entries, results):
            if status == "ok":
                self._note_appended(entry, partition_id, position, partition)
            elif status == "backpressure":
                self.admission.release(entry["tenant"])
                self._reply_error(
                    entry["sender"], entry["requestId"], "backpressure",
                    f"partition {partition_id} has reached its in-flight "
                    f"command limit")
            else:
                self.admission.release(entry["tenant"])
                self._reply_error(
                    entry["sender"], entry["requestId"], "unavailable",
                    f"partition {partition_id} paused or disk-paused")
        return len(entries)

    def _maybe_chaos_crash(self, partition) -> None:
        """Armed by ``ZEEBE_CHAOS_CRASH_AFTER_APPENDS=N``: hard-exit between
        the Nth successful append and its reply. The raft journal is flushed
        first so the appended command SURVIVES the crash (the scenario under
        test is dedupe-on-resend, not a legitimately-lost volatile append),
        and the marker file keeps the restarted process from re-arming."""
        if self._crash_after_appends is None:
            return
        self._crash_after_appends -= 1
        if self._crash_after_appends > 0:
            return
        self._crash_after_appends = None
        try:
            self._crash_marker.parent.mkdir(parents=True, exist_ok=True)
            self._crash_marker.touch()
            partition.raft.journal.flush()
        finally:
            print(f"[{self.node_id}] chaos: crashing between append and reply",
                  file=sys.stderr, flush=True)
            os._exit(86)

    def _on_processing_response(self, response) -> None:
        origin = response.request_stream_id
        if not 0 <= origin < len(self._route_members):
            return
        target = self._route_members[origin]
        if target == self.node_id:
            return  # workers never originate client requests
        dedupe_key = (target, response.request_id)
        # the append→reply latency IS the shed ladder's feedback signal
        self._release_admission(dedupe_key)
        from zeebe_tpu_torch.observability.tracer import get_tracer

        tracer = get_tracer()
        t_reply = time.perf_counter() if tracer.enabled else 0.0
        payload = {
            "requestId": response.request_id,
            "record": response.record.to_bytes(),
            "commandPosition": self._inflight_positions.pop(dedupe_key, -1),
        }
        self._recent_replies[dedupe_key] = payload
        while len(self._recent_replies) > 4096:
            self._recent_replies.popitem(last=False)
        self.messaging.send(target, GATEWAY_RESPONSE_TOPIC, payload)
        if tracer.enabled:
            # reply-release seam: serialize + enqueue to the gateway, on the
            # ROOT trace so the critical-path sweep can close the tail edge
            pid = response.record.partition_id
            position = payload["commandPosition"]
            if position >= 0:
                root = tracer.resolve_root(pid, position, position)
                trace_id = f"{pid}:{root}"
                if tracer.sampled(trace_id):
                    tracer.emit(trace_id, "processor.reply_release",
                                time.perf_counter() - t_reply, pid,
                                parent="processor.ack",
                                attrs={"position": position,
                                       "gateway": target})

    # -- jobs available --------------------------------------------------------

    def _on_jobs_available(self, partition_id: int, job_types: set) -> None:
        payload = {"partitionId": partition_id, "types": sorted(job_types)}
        for gateway in self.gateway_members:
            self.messaging.send(gateway, JOBS_AVAILABLE_TOPIC, payload)

    # -- status push -----------------------------------------------------------

    def _roles(self) -> dict[str, str]:
        return {str(pid): ("leader" if p.is_leader else "follower")
                for pid, p in self.broker.partitions.items()}

    def send_status(self) -> None:
        from zeebe_tpu_torch.broker.management import broker_status

        # broker_status already attaches the control block (knob/bounds
        # evidence) when the plane is on — it rides the push as-is
        status = broker_status(self.broker)
        status["workerPid"] = os.getpid()
        if self.admission.cfg.enabled:
            # per-worker admission evidence rides the status row the same
            # way recovery accounting does — /cluster/status and `cli top`
            # see every worker's tenant rates/sheds without an extra hop
            status["admission"] = self.admission.snapshot()
        recoveries = {
            str(pid): p.last_recovery
            for pid, p in self.broker.partitions.items()
            if getattr(p, "last_recovery", None) is not None
        }
        if recoveries:
            # recovery accounting crosses the process boundary with the
            # status row: /cluster/status answers "what did the restart cost"
            status["recoveries"] = recoveries
        for gateway in self.gateway_members:
            self.messaging.send(gateway, WORKER_STATUS_TOPIC,
                                {"status": status})

    def maybe_send_status(self) -> None:
        now = self.broker.clock_millis()
        roles = self._roles()
        if (roles != self._last_roles
                or now - self._last_status_ms >= self._status_interval_ms):
            self._last_roles = roles
            self._last_status_ms = now
            self.send_status()

    # -- pump ------------------------------------------------------------------

    def pump(self) -> int:
        moved = 0
        poll = getattr(self.messaging, "poll", None)
        if poll is not None:
            moved += poll()
        if self._ingress_pending:
            # coalesced ingress: due windows append as one batch per
            # partition BEFORE the broker pump so the batch processes in
            # this very round
            moved += self._flush_due_ingress()
        moved += self.broker.pump()
        # shed-ladder feedback loop (throttled internally to its tick)
        self.admission.tick(float(self.broker.clock_millis()))
        self.maybe_send_status()
        return moved

    def _set_coalesce_window(self, value: float) -> None:
        """The ingress-coalescing actuator's registered write seam — the
        knob lives on this runtime, so the assignment does too; nothing
        else may write it after construction."""
        # (suppressed: this method IS the write callback handed to the
        # registered Actuator — the one sanctioned mutation site)
        self.coalesce_window_ms = float(value)  # zlint: disable=control-actuation-discipline

    def _admission_loop_snapshot(self) -> dict:
        return {
            "knob": "admission.shedLevel",
            "description": "DAGOR shed ladder driven by observed ack p99 "
                           "",
            "value": self.admission.shed_level,
            "adjustments": self.admission.level_changes,
            "observedP99Ms": round(self.admission.last_p99_ms, 1),
            "draining": self.admission.draining,
        }

    def close(self) -> None:
        if self.broker.control is not None:
            # the control audit trail must survive an orderly shutdown:
            # the arm's flight dump (with the control context block) is
            # the evidence the autotune gate collects offline
            self.broker.flight_recorder.dump("control-shutdown", force=True)
        self._dump_spans()
        self.broker.close()

    def _dump_spans(self) -> None:
        """Persist this process's span ring as ``spans-<node>-<pid>.jsonl``
        under the data dir: the offline critical-path assembler merges these
        per-process dumps by derived trace id (no in-band propagation)."""
        from zeebe_tpu_torch.observability.tracer import get_tracer

        tracer = get_tracer()
        if not tracer.enabled or not len(tracer.collector):
            return
        path = (self.broker.directory
                / f"spans-{self.node_id}-{os.getpid()}.jsonl")
        try:
            tracer.collector.to_jsonl(path)
        except OSError:
            pass  # a full disk must not turn shutdown fatal


class _TestLeak:
    """Deliberate resource leak for the fleet-day recall arm:
    ``ZEEBE_AUDIT_TESTLEAK=fd:20`` leaks ~20 file descriptors per second,
    ``ring:50`` pushes ~50 junk events/s into the flight recorder's node
    ring. The online auditor MUST return a leak verdict against a worker
    running with this armed — proving the detector's recall, not just its
    quietness on a clean tree. Never enable outside a test harness."""

    def __init__(self, kind: str, per_sec: float) -> None:
        self.kind = kind
        self.per_sec = per_sec
        self._held: list = []   # leaked fds stay referenced until exit
        self._last = time.monotonic()

    @staticmethod
    def from_env() -> "_TestLeak | None":
        spec = os.environ.get("ZEEBE_AUDIT_TESTLEAK", "")
        if not spec:
            return None
        kind, _, rate = spec.partition(":")
        try:
            per_sec = float(rate) if rate else 10.0
        except ValueError:
            per_sec = 10.0
        if kind not in ("fd", "ring"):
            return None
        return _TestLeak(kind, per_sec)

    def tick(self, runtime) -> None:
        now = time.monotonic()
        count = int((now - self._last) * self.per_sec)
        if count <= 0:
            return
        self._last = now
        if self.kind == "fd":
            for _ in range(min(count, 64)):
                try:
                    self._held.append(open(os.devnull, "rb"))  # noqa: SIM115
                except OSError:
                    return  # fd table exhausted: stop leaking, stay alive
        else:
            flight = getattr(runtime.broker, "flight_recorder", None)
            if flight is not None:
                for i in range(min(count, 256)):
                    flight.record(0, "test_leak", seq=len(self._held) + i)
                self._held.extend(range(min(count, 256)))
# end of the copy


def main(argv: list[str] | None = None) -> int:
    """Process entry: ``python -m zeebe_tpu_torch.multiproc.worker ...`` (normally
    spawned by :class:`zeebe_tpu_torch.multiproc.supervisor.WorkerSupervisor`).
    ``--device`` is the kernel backend's (none = the card; ``cpu`` runs the
    plain version). On the card the start-up guard runs first: where no card
    answers, the worker exits 2 with the probe's verdict on stderr and never
    binds its port."""
    import argparse
    import signal

    from zeebe_tpu_torch.utils.zlogging import configure_logging

    started = time.monotonic()
    configure_logging()
    parser = argparse.ArgumentParser(prog="zeebe-tpu-worker")
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--bind", required=True, help="host:port for TCP "
                        "cluster messaging")
    parser.add_argument("--contact", required=True,
                        help="comma-separated member=host:port for EVERY "
                             "member (workers AND gateways)")
    parser.add_argument("--gateway", required=True,
                        help="comma-separated gateway member ids (subset of "
                             "--contact)")
    parser.add_argument("--partitions", type=int, default=1)
    parser.add_argument("--replication", type=int, default=1)
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--management-port", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="the kernel backend's device (default: the "
                             "card; cpu runs the plain version)")
    args = parser.parse_args(argv)

    # start-up guard (killable probe, SIGKILL on wedge): no card, no serving
    # — the worker never falls to the CPU unasked; then the card comes up
    # (CUDA context, kernel library, link) before the broker binds messaging
    from zeebe_tpu_torch.utils.backend_probe import boot_card

    rc = boot_card(args.device, f"[{args.node_id}]")
    if rc:
        return rc

    from zeebe_tpu_torch.backup import backup_store_from_env
    from zeebe_tpu_torch.broker.config import load_broker_cfg
    from zeebe_tpu_torch.cluster.messaging import TcpMessagingService
    from zeebe_tpu_torch.standalone import _parse_contacts
    from zeebe_tpu_torch.utils.external_code import exporters_factory_from_env

    contacts = _parse_contacts(args.contact)
    gateways = [g.strip() for g in args.gateway.split(",") if g.strip()]
    broker_members = sorted(m for m in contacts if m not in gateways)
    host, port = args.bind.rsplit(":", 1)
    peers = {m: a for m, a in contacts.items() if m != args.node_id}
    messaging = TcpMessagingService(args.node_id, (host, int(port)), peers)
    messaging.start()
    # TCP-layer chaos: ZEEBE_CHAOS_TCP wraps this worker's whole
    # messaging plane — gateway↔worker AND worker↔worker (raft/SWIM) frames
    # ride through the seeded fault injector
    from zeebe_tpu_torch.testing.chaos_tcp import ChaosTcpMessagingService, maybe_wrap_chaos

    messaging = maybe_wrap_chaos(messaging)
    if isinstance(messaging, ChaosTcpMessagingService) and args.data_dir:
        # observed-fault evidence for the consistency report, one snapshot
        # file per process life (a SIGKILL loses ≤1 dump interval)
        messaging.counts_file = os.path.join(
            args.data_dir, f"chaos-counts-{os.getpid()}.json")
    # disk-layer chaos: ZEEBE_CHAOS_DISK installs the seeded
    # fault controller into the storage_io seam BEFORE any journal opens;
    # its tick (at-rest bit-rot + counts evidence) rides the pump loop
    from zeebe_tpu_torch.testing.chaos_disk import maybe_install_from_env as \
        _maybe_disk_chaos

    disk_chaos = _maybe_disk_chaos(member_id=args.node_id,
                                   data_dir=args.data_dir)
    # device-layer chaos: ZEEBE_CHAOS_DEVICE installs the seeded
    # fault controller into the kernel backend's dispatch seam; its tick
    # (disarm check + counts evidence) rides the pump loop
    from zeebe_tpu_torch.testing.chaos_device import maybe_install_from_env as \
        _maybe_device_chaos

    device_chaos = _maybe_device_chaos(member_id=args.node_id,
                                       data_dir=args.data_dir)

    ext = load_broker_cfg(overrides={
        "base.node_id": args.node_id,
        "base.partition_count": args.partitions,
        "base.replication_factor": args.replication,
        "base.cluster_members": broker_members,
        "base.device": args.device,
    })
    runtime = WorkerRuntime(
        args.node_id, messaging, gateways, ext.base,
        directory=args.data_dir,
        coalesce_window_ms=ext.processing.coalesce_window_ms,
        exporters_factory=exporters_factory_from_env(),
        backup_store=backup_store_from_env(),
        backpressure_algorithm=ext.backpressure.algorithm,
        backpressure_enabled=ext.backpressure.enabled,
        disk_min_free_bytes=(ext.disk.min_free_bytes
                             if ext.disk.enable_monitoring and args.data_dir
                             else 0),
    )
    management = None
    if args.management_port:
        from zeebe_tpu_torch.broker.management import ManagementServer

        management = ManagementServer(
            runtime.broker, bind=("0.0.0.0", args.management_port))
        management.start()

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    test_leak = _TestLeak.from_env()
    print(f"[{args.node_id}] worker up: partitions<={args.partitions} "
          f"bind {args.bind} pid {os.getpid()} device "
          f"{args.device or 'cuda'}, {time.monotonic() - started:.3f} s after "
          f"main", file=sys.stderr, flush=True)
    while not stop.is_set():
        if disk_chaos is not None:
            disk_chaos.tick()
        if device_chaos is not None:
            device_chaos.tick()
        if test_leak is not None:
            test_leak.tick(runtime)
        if runtime.pump() == 0:
            time.sleep(0.001)
    if management is not None:
        management.stop()
    runtime.close()
    messaging.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
