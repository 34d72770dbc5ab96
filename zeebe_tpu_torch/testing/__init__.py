"""EngineHarness — the EngineRule equivalent: a real engine on a real log with
no gateway, no Raft, no network.

Reference: engine/src/test/java/io/camunda/zeebe/engine/util/EngineRule.java:73,
TestStreams (writes commands directly to the log), ProcessingExporterTransistor
(feeds every written record into the RecordingExporter), ControlledActorClock
(deterministic time).

Also the module the bench and the gateway-less demo drive — the reference uses
EngineRule for its CI perf gate (EngineLargeStatePerformanceTest) the same way.

The port's harness is the reference's with one addition: ``device``, the
device of the batched kernel backend (``use_kernel_backend=True``), passed
to ``KernelBackend``. ``None`` is CUDA, and raises where CUDA is missing;
``"cpu"`` runs the plain PyTorch version. The workloads the smoke run and
the tests share are in ``testing.workloads``.
"""

from __future__ import annotations

import tempfile
from pathlib import Path
from typing import Any

from zeebe_tpu_torch.engine.engine import Engine
from zeebe_tpu_torch.exporters.recording import RecordingExporter
from zeebe_tpu_torch.journal import SegmentedJournal
from zeebe_tpu_torch.logstreams import LogAppendEntry, LogStream
from zeebe_tpu_torch.models.bpmn import ProcessModel, to_bpmn_xml
from zeebe_tpu_torch.protocol import Record, ValueType, command
from zeebe_tpu_torch.protocol.intent import (
    DeploymentIntent,
    IncidentIntent,
    JobBatchIntent,
    JobIntent,
    ProcessInstanceCreationIntent,
    ProcessInstanceIntent,
    VariableDocumentIntent,
)
from zeebe_tpu_torch.state import ZbDb
from zeebe_tpu_torch.stream import StreamProcessor, StreamProcessorMode


class ControlledClock:
    """Deterministic test clock (reference: ControlledActorClock)."""

    def __init__(self, start_millis: int = 1_000_000) -> None:
        self.millis = start_millis

    def __call__(self) -> int:
        return self.millis

    def advance(self, millis: int) -> None:
        self.millis += millis


class EngineHarness:
    def __init__(
        self,
        directory: str | Path | None = None,
        partition_id: int = 1,
        max_commands_in_batch: int = 100,
        consistency_checks: bool = True,
        partition_count: int = 1,
        sender=None,
        clock: ControlledClock | None = None,
        use_kernel_backend: bool = False,
        mesh_runner=None,
        device=None,
    ) -> None:
        if use_kernel_backend:
            # the backend's device, resolved before anything is opened:
            # None is CUDA, and raises where CUDA is missing
            from zeebe_tpu_torch.ops.automaton import resolve_device

            device = resolve_device(device)
        self._tmp = None
        if directory is None:
            self._tmp = tempfile.TemporaryDirectory()
            directory = self._tmp.name
        self.clock = clock or ControlledClock()
        self.journal = SegmentedJournal(Path(directory) / "log")
        self.stream = LogStream(self.journal, partition_id, clock=self.clock)
        self.db = ZbDb(consistency_checks=consistency_checks)
        self.engine = Engine(self.db, partition_id, clock_millis=self.clock,
                             partition_count=partition_count)
        self.exporter = RecordingExporter()
        self.responses: list = []
        kernel_backend = None
        if use_kernel_backend:
            from zeebe_tpu_torch.engine.kernel_backend import KernelBackend

            # audit mode: every burst-template hit ALSO runs the slow path
            # and asserts byte/state/response equality — the whole test suite
            # continuously cross-checks the template codegen
            # small group bucket: tests drive few instances at a time, and
            # the kernel pads every group to the max-group geometry
            kernel_backend = KernelBackend(self.engine, max_group=64,
                                           audit_templates=True,
                                           mesh_runner=mesh_runner,
                                           device=device)
        self.kernel_backend = kernel_backend
        self.processor = StreamProcessor(
            self.stream,
            self.db,
            self.engine,
            max_commands_in_batch=max_commands_in_batch,
            response_sink=self.responses.append,
            clock_millis=self.clock,
            kernel_backend=kernel_backend,
        )
        from zeebe_tpu_torch.engine.distribution import CommandRedistributor
        from zeebe_tpu_torch.engine.message_timer import DueDateCheckers
        from zeebe_tpu_torch.parallel.partitioning import LoopbackCommandSender

        if sender is None:
            sender = LoopbackCommandSender(
                lambda rec: self.stream.writer.try_write([LogAppendEntry(rec)])
            )
        self.engine.wire_sender(sender)
        self.checkers = DueDateCheckers(self.engine.state, self.processor.schedule_service, self.clock)
        self.redistributor = CommandRedistributor(
            self.engine.state, self.engine.sender, self.processor.schedule_service, self.clock
        )
        self.processor.start()
        self._exported_until = 0

    def close(self) -> None:
        self.journal.close()
        if self._tmp is not None:
            self._tmp.cleanup()

    # -- pump ----------------------------------------------------------------

    # set by MultiPartitionHarness: partition pumps then drive the whole cluster
    cluster = None

    def pump(self) -> None:
        """Process everything pending (including due scheduled work), then
        transfer new records to the exporter (ProcessingExporterTransistor)."""
        if self.cluster is not None:
            self.cluster.pump_all()
            return
        self._pump_local()

    def _pump_local(self) -> None:
        for _ in range(1000):
            self.processor.run_until_idle()
            self.checkers.reschedule()
            self.redistributor.reschedule()
            due = self.processor.schedule_service.next_due_millis
            if due is None or due > self.clock():
                break
        else:
            raise RuntimeError(
                "pump did not quiesce after 1000 rounds — a due-date sweep is "
                "producing commands that fail to clear their due state"
            )
        for logged in self.stream.new_reader(self._exported_until + 1):
            self.exporter.export(logged)
            self._exported_until = logged.position

    def advance_time(self, millis: int) -> None:
        """Advance the controlled clock and process whatever becomes due."""
        self.clock.advance(millis)
        self.pump()
    # -- command ingress (the TestStreams role) ------------------------------

    def write_command(self, record: Record, request_id: int = -1) -> None:
        rec = record.replace(request_id=request_id, request_stream_id=0) if request_id >= 0 else record
        self.stream.writer.try_write([LogAppendEntry(rec)])
        self.pump()

    # -- fluent client-ish API ----------------------------------------------

    def deploy(self, *models: ProcessModel | str | tuple, request_id: int = 1) -> None:
        resources = []
        for i, model in enumerate(models):
            if isinstance(model, tuple):  # (resourceName, raw xml) e.g. .dmn
                name, xml = model
            else:
                xml = model if isinstance(model, str) else to_bpmn_xml(model)
                name = f"resource_{i}.bpmn"
                if isinstance(model, ProcessModel):
                    name = f"{model.process_id}.bpmn"
            resources.append({"resourceName": name, "resource": xml})
        self.write_command(
            command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {"resources": resources}),
            request_id=request_id,
        )

    def create_instance(
        self, bpmn_process_id: str, variables: dict[str, Any] | None = None,
        version: int = -1, request_id: int = 2,
    ) -> int:
        self.write_command(
            command(
                ValueType.PROCESS_INSTANCE_CREATION,
                ProcessInstanceCreationIntent.CREATE,
                {
                    "bpmnProcessId": bpmn_process_id,
                    "version": version,
                    "variables": variables or {},
                },
            ),
            request_id=request_id,
        )
        created = (
            self.exporter.all()
            .with_value_type(ValueType.PROCESS_INSTANCE_CREATION)
            .with_intent(ProcessInstanceCreationIntent.CREATED)
            .with_value(bpmnProcessId=bpmn_process_id)
            .to_list()
        )
        return created[-1].record.value["processInstanceKey"]

    def cancel_instance(self, process_instance_key: int, request_id: int = 3) -> None:
        self.write_command(
            command(ValueType.PROCESS_INSTANCE, ProcessInstanceIntent.CANCEL, {},
                    key=process_instance_key),
            request_id=request_id,
        )

    def activate_jobs(
        self, job_type: str, worker: str = "test-worker", max_jobs: int = 32,
        timeout: int = 300_000, request_id: int = 4,
    ) -> list[dict]:
        before = self.exporter.job_batch_records().with_intent(JobBatchIntent.ACTIVATED).count()
        self.write_command(
            command(
                ValueType.JOB_BATCH, JobBatchIntent.ACTIVATE,
                {"type": job_type, "worker": worker, "timeout": timeout,
                 "maxJobsToActivate": max_jobs},
            ),
            request_id=request_id,
        )
        batches = self.exporter.job_batch_records().with_intent(JobBatchIntent.ACTIVATED).to_list()
        new = batches[before:]
        jobs = []
        for batch in new:
            for key, job in zip(batch.record.value["jobKeys"], batch.record.value["jobs"]):
                jobs.append({"key": key, **job})
        return jobs

    def complete_job(self, job_key: int, variables: dict | None = None, request_id: int = 5) -> None:
        self.write_command(
            command(ValueType.JOB, JobIntent.COMPLETE, {"variables": variables or {}}, key=job_key),
            request_id=request_id,
        )

    def fail_job(self, job_key: int, retries: int, error_message: str = "", request_id: int = 6) -> None:
        self.write_command(
            command(ValueType.JOB, JobIntent.FAIL,
                    {"retries": retries, "errorMessage": error_message}, key=job_key),
            request_id=request_id,
        )

    def resolve_incident(self, incident_key: int, request_id: int = 7) -> None:
        self.write_command(
            command(ValueType.INCIDENT, IncidentIntent.RESOLVE, {}, key=incident_key),
            request_id=request_id,
        )

    def update_job_retries(self, job_key: int, retries: int, request_id: int = 8) -> None:
        self.write_command(
            command(ValueType.JOB, JobIntent.UPDATE_RETRIES, {"retries": retries}, key=job_key),
            request_id=request_id,
        )

    def publish_message(
        self, name: str, correlation_key: str, variables: dict | None = None,
        ttl: int = 3_600_000, message_id: str = "", request_id: int = 11,
    ) -> None:
        from zeebe_tpu_torch.protocol.intent import MessageIntent

        self.write_command(
            command(
                ValueType.MESSAGE, MessageIntent.PUBLISH,
                {
                    "name": name,
                    "correlationKey": correlation_key,
                    "timeToLive": ttl,
                    "messageId": message_id,
                    "variables": variables or {},
                },
            ),
            request_id=request_id,
        )

    def broadcast_signal(self, name: str, variables: dict | None = None, request_id: int = 12) -> None:
        from zeebe_tpu_torch.protocol.intent import SignalIntent

        self.write_command(
            command(ValueType.SIGNAL, SignalIntent.BROADCAST,
                    {"signalName": name, "variables": variables or {}}),
            request_id=request_id,
        )

    def throw_job_error(self, job_key: int, error_code: str, error_message: str = "",
                        request_id: int = 13) -> None:
        self.write_command(
            command(ValueType.JOB, JobIntent.THROW_ERROR,
                    {"errorCode": error_code, "errorMessage": error_message}, key=job_key),
            request_id=request_id,
        )

    def set_variables(self, scope_key: int, variables: dict, local: bool = False, request_id: int = 9) -> None:
        self.write_command(
            command(ValueType.VARIABLE_DOCUMENT, VariableDocumentIntent.UPDATE,
                    {"scopeKey": scope_key, "variables": variables, "local": local}),
            request_id=request_id,
        )

    # -- state helpers -------------------------------------------------------

    def is_instance_done(self, process_instance_key: int) -> bool:
        with self.db.transaction():
            return self.engine.state.element_instances.get(process_instance_key) is None

    def variables_of(self, scope_key: int) -> dict:
        with self.db.transaction():
            return self.engine.state.variables.collect(scope_key)


class MultiPartitionHarness:
    """N in-process partitions wired through a loopback inter-partition sender —
    the reference's primary multi-node harness (EngineRule with partitionCount>1
    + TestInterPartitionCommandSender, engine/src/test/…/util/
    TestInterPartitionCommandSender.java): full multi-partition engine logic in
    one process, no Raft, no network."""

    def __init__(self, partition_count: int = 3, directory: str | Path | None = None,
                 consistency_checks: bool = True,
                 use_kernel_backend: bool = False, mesh_runner=None,
                 device=None) -> None:
        from zeebe_tpu_torch.parallel.partitioning import InProcessClusterSender

        self._tmp = None
        if directory is None:
            self._tmp = tempfile.TemporaryDirectory()
            directory = self._tmp.name
        self.partition_count = partition_count
        self.clock = ControlledClock()
        self.sender = InProcessClusterSender()
        self.partitions: dict[int, EngineHarness] = {}
        self.mesh_runner = mesh_runner
        self._pumping = False
        for pid in range(1, partition_count + 1):
            h = EngineHarness(
                directory=Path(directory) / f"partition-{pid}",
                partition_id=pid,
                partition_count=partition_count,
                sender=self.sender,
                clock=self.clock,
                consistency_checks=consistency_checks,
                use_kernel_backend=use_kernel_backend,
                mesh_runner=mesh_runner,
                device=device,
            )
            h.cluster = self
            self.partitions[pid] = h
            self.sender.register(
                pid, lambda rec, h=h: h.stream.writer.try_write([LogAppendEntry(rec)])
            )
        self._round_robin = 0

    def close(self) -> None:
        for h in self.partitions.values():
            h.close()
        if self._tmp is not None:
            self._tmp.cleanup()

    def partition(self, partition_id: int) -> EngineHarness:
        return self.partitions[partition_id]

    # -- cluster pump ---------------------------------------------------------

    def pump_all(self) -> None:
        """Pump every partition until the whole cluster quiesces (inter-partition
        sends land on sibling logs and must be drained in turn)."""
        if self._pumping:
            return
        self._pumping = True
        try:
            for _ in range(1000):
                # quiesce on log END positions, not exporter positions: a round
                # whose only effect is a cross-partition send into an
                # already-pumped sibling log must trigger another round
                before = tuple(h.stream._next_position for h in self.partitions.values())
                for h in self.partitions.values():
                    h._pump_local()
                after = tuple(h.stream._next_position for h in self.partitions.values())
                if after == before:
                    return
            raise RuntimeError("cluster pump did not quiesce after 1000 rounds")
        finally:
            self._pumping = False

    def advance_time(self, millis: int) -> None:
        self.clock.advance(millis)
        self.pump_all()

    # -- cluster-level client API --------------------------------------------

    def deploy(self, *models: ProcessModel | str, request_id: int = 1) -> None:
        """Deployments always enter on the deployment partition (1)."""
        self.partitions[1].deploy(*models, request_id=request_id)

    def create_instance(self, bpmn_process_id: str, variables: dict[str, Any] | None = None,
                        partition_id: int | None = None, version: int = -1) -> int:
        """Round-robin instance creation across partitions (the gateway's
        RequestDispatchStrategy) unless a partition is pinned."""
        if partition_id is None:
            partition_id = (self._round_robin % self.partition_count) + 1
            self._round_robin += 1
        return self.partitions[partition_id].create_instance(
            bpmn_process_id, variables, version=version
        )

    def publish_message(self, name: str, correlation_key: str, **kw: Any) -> None:
        """Messages route by correlation-key hash (SubscriptionUtil)."""
        from zeebe_tpu_torch.parallel.partitioning import subscription_partition_id

        pid = subscription_partition_id(correlation_key, self.partition_count)
        self.partitions[pid].publish_message(name, correlation_key, **kw)

    def records(self):
        """All partitions' records merged (position-interleaved per partition)."""
        out = []
        for h in self.partitions.values():
            out.extend(h.exporter.all().to_list())
        return out


def _await_partition_resources(runtime, process_ids, want_present: bool,
                               what: str, timeout_s: float) -> None:
    import time as _time

    deadline = _time.time() + timeout_s
    mismatched: list = [("*", "*")]
    while _time.time() < deadline:
        mismatched = []
        for pid in range(1, runtime.partition_count + 1):
            with runtime._plocks[pid]:
                leader = runtime._leader_partition(pid)
                if leader is None or leader.engine is None:
                    mismatched.append((pid, "*"))
                    continue
                with leader.db.transaction():
                    for process_id in process_ids:
                        found = leader.engine.state.processes.get_latest_by_id(
                            process_id) is not None
                        if found != want_present:
                            mismatched.append((pid, process_id))
        if not mismatched:
            return
        _time.sleep(0.01)
    raise TimeoutError(f"{what}: {mismatched}")


def await_resource_absent(runtime, process_ids, timeout_s: float = 10.0) -> None:
    """Inverse of await_deployment_distributed: block until NO partition
    leader resolves the given process ids (resource DELETION distributes
    asynchronously exactly like deployment)."""
    _await_partition_resources(runtime, process_ids, want_present=False,
                               what="resource deletion not distributed",
                               timeout_s=timeout_s)


def await_deployment_distributed(runtime, process_ids, timeout_s: float = 10.0) -> None:
    """Block until every partition leader of an in-process ClusterRuntime can
    resolve the given process ids. Deployment distribution is asynchronous by
    design (the reference's DeploymentCreateProcessor responds on partition-1
    commit and distributes afterwards — DeploymentCreateProcessor.java:166),
    so a create-by-id racing the distribution to another partition is
    legitimate NOT_FOUND behavior; tests that deploy-then-create on a
    multi-partition cluster should wait this race out the same way the
    reference's own tests await the RecordingExporter."""
    _await_partition_resources(runtime, process_ids, want_present=True,
                               what="deployment not distributed",
                               timeout_s=timeout_s)


def distributing_client(client, runtime):
    """Wrap a ZeebeTpuClient so deploy_resource also awaits distribution to
    every partition (see await_deployment_distributed)."""
    original = client.deploy_resource

    def deploy_and_await(*resources, **kw):
        result = original(*resources, **kw)
        ids = [p["bpmnProcessId"] for p in result.get("processes", [])]
        if ids:
            await_deployment_distributed(runtime, ids)
        return result

    client.deploy_resource = deploy_and_await
    return client
