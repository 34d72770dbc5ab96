"""Engine: the RecordProcessor implementation for one partition.

Reference: engine/src/main/java/io/camunda/zeebe/engine/Engine.java:40
(implements RecordProcessor; process :100 looks up a TypedRecordProcessor in
RecordProcessorMap by (RecordType, ValueType, Intent); replay :94 delegates to
EventApplier; banned-instance guard :126) and
processing/EngineProcessors.createEngineProcessors (EngineProcessors.java:61).
"""

from __future__ import annotations

from typing import Callable

from zeebe_tpu_torch.engine.appliers import EventAppliers
from zeebe_tpu_torch.engine.bpmn import BpmnProcessor
from zeebe_tpu_torch.engine.engine_state import EngineState
from zeebe_tpu_torch.engine.processors import (
    DeploymentProcessor,
    IncidentResolveProcessor,
    JobBatchProcessor,
    JobProcessors,
    ProcessInstanceCancelProcessor,
    ProcessInstanceCreationProcessor,
    VariableDocumentProcessor,
)
from zeebe_tpu_torch.engine.writers import Writers
from zeebe_tpu_torch.logstreams import LoggedRecord
from zeebe_tpu_torch.protocol import RejectionType, ValueType
from zeebe_tpu_torch.protocol.intent import (
    CheckpointIntent,
    CommandDistributionIntent,
    ProcessInstanceMigrationIntent,
    ProcessInstanceModificationIntent,
    ResourceDeletionIntent,
    DecisionEvaluationIntent,
    DeploymentIntent,
    IncidentIntent,
    JobBatchIntent,
    JobIntent,
    MessageBatchIntent,
    MessageIntent,
    MessageSubscriptionIntent,
    ProcessInstanceBatchIntent,
    ProcessInstanceCreationIntent,
    ProcessInstanceIntent,
    ProcessMessageSubscriptionIntent,
    SignalIntent,
    TimerIntent,
    UserTaskIntent,
    VariableDocumentIntent,
)
from zeebe_tpu_torch.state import ZbDb
from zeebe_tpu_torch.stream import ProcessingResultBuilder, RecordProcessor


class _SenderProxy:
    """Late-bound InterPartitionCommandSender (wired once the log exists)."""

    def __init__(self) -> None:
        self.delegate = None

    def send_command(self, receiver_partition_id: int, record) -> None:
        if self.delegate is None:
            raise RuntimeError("inter-partition sender not wired")
        self.delegate.send_command(receiver_partition_id, record)


class Engine(RecordProcessor):
    def __init__(self, db: ZbDb, partition_id: int = 1,
                 clock_millis: Callable[[], int] | None = None,
                 partition_count: int = 1) -> None:
        self.state = EngineState(db, partition_id)
        self.appliers = EventAppliers(self.state)
        clock = clock_millis or (lambda: 0)
        self.clock_millis = clock
        self.partition_count = partition_count
        self.sender = _SenderProxy()

        from zeebe_tpu_torch.engine.message_timer import (
            MessageProcessors,
            MessageSubscriptionProcessors,
            ProcessMessageSubscriptionProcessors,
            TimerProcessors,
        )

        from zeebe_tpu_torch.engine.signal import SignalProcessors
        from zeebe_tpu_torch.engine.distribution import (
            CommandDistributionAcknowledgeProcessor,
            CommandDistributionBehavior,
        )

        bpmn = BpmnProcessor(self.state, clock, sender=self.sender,
                             partition_count=partition_count)
        self.distribution_behavior = CommandDistributionBehavior(
            self.state, partition_count, self.sender, clock_millis=clock
        )
        distribution = self.distribution_behavior if partition_count > 1 else None
        deployment = DeploymentProcessor(self.state, clock, distribution=distribution)
        # transient await-result requests (CreateProcessInstanceWithResult):
        # in-memory by design — they die with the node, the client retries
        self.await_results: dict[int, tuple[int, int, list]] = {}
        creation = ProcessInstanceCreationProcessor(self.state, bpmn,
                                                    await_results=self.await_results)
        bpmn.on_root_completed = self._on_root_completed
        bpmn.on_root_terminated = self._on_root_terminated
        cancel = ProcessInstanceCancelProcessor(self.state)
        jobs = JobProcessors(self.state, clock, bpmn)
        job_batch = JobBatchProcessor(self.state, clock)
        incidents = IncidentResolveProcessor(self.state, bpmn)
        variables = VariableDocumentProcessor(self.state)
        timers = TimerProcessors(self.state, clock, bpmn)
        messages = MessageProcessors(self.state, clock, partition_count, self.sender)
        msg_subs = MessageSubscriptionProcessors(self.state, self.sender)
        pms = ProcessMessageSubscriptionProcessors(self.state, self.sender, partition_count,
                                                   bpmn=bpmn)
        signals = SignalProcessors(self.state, bpmn, distribution=distribution)
        dist_ack = CommandDistributionAcknowledgeProcessor(self.state)
        self.distribution_ack = dist_ack
        from zeebe_tpu_torch.engine.decision import DecisionEvaluationProcessor

        decision_eval = DecisionEvaluationProcessor(self.state)
        from zeebe_tpu_torch.engine.modification import (
            ProcessInstanceMigrationProcessor,
            ProcessInstanceModificationProcessor,
            ResourceDeletionProcessor,
        )

        from zeebe_tpu_torch.engine.processors import ProcessInstanceBatchProcessor
        from zeebe_tpu_torch.engine.user_task import UserTaskProcessors

        pi_batch = ProcessInstanceBatchProcessor(self.state, bpmn)
        user_tasks = UserTaskProcessors(self.state)
        modification = ProcessInstanceModificationProcessor(self.state, bpmn)
        migration = ProcessInstanceMigrationProcessor(self.state)
        resource_deletion = ResourceDeletionProcessor(self.state, distribution)
        from zeebe_tpu_torch.backup.checkpoint import CheckpointProcessor

        self.checkpoint_state = self.state.checkpoints
        self.checkpoint = CheckpointProcessor(self.checkpoint_state)

        def _deployment_fully_distributed(wr, distribution_key, stored):
            wr.append_event(
                distribution_key, ValueType.DEPLOYMENT, DeploymentIntent.FULLY_DISTRIBUTED,
                stored.get("commandValue", {}),
            )

        dist_ack.on_finished(ValueType.DEPLOYMENT, _deployment_fully_distributed)
        self.bpmn = bpmn

        # the RecordProcessorMap: (ValueType, command intent) → handler
        self._processors: dict[tuple[ValueType, int], Callable[[LoggedRecord, Writers], None]] = {
            (ValueType.DEPLOYMENT, int(DeploymentIntent.CREATE)): deployment.process,
            (ValueType.PROCESS_INSTANCE_CREATION, int(ProcessInstanceCreationIntent.CREATE)): creation.process,
            (ValueType.PROCESS_INSTANCE, int(ProcessInstanceIntent.ACTIVATE_ELEMENT)): bpmn.process,
            (ValueType.PROCESS_INSTANCE, int(ProcessInstanceIntent.COMPLETE_ELEMENT)): bpmn.process,
            (ValueType.PROCESS_INSTANCE, int(ProcessInstanceIntent.TERMINATE_ELEMENT)): bpmn.process,
            (ValueType.PROCESS_INSTANCE, int(ProcessInstanceIntent.CANCEL)): cancel.process,
            (ValueType.JOB, int(JobIntent.COMPLETE)): jobs.complete,
            (ValueType.JOB, int(JobIntent.FAIL)): jobs.fail,
            (ValueType.JOB, int(JobIntent.UPDATE_RETRIES)): jobs.update_retries,
            (ValueType.JOB, int(JobIntent.TIME_OUT)): jobs.time_out,
            (ValueType.JOB, int(JobIntent.THROW_ERROR)): jobs.throw_error,
            (ValueType.JOB_BATCH, int(JobBatchIntent.ACTIVATE)): job_batch.process,
            (ValueType.INCIDENT, int(IncidentIntent.RESOLVE)): incidents.process,
            (ValueType.VARIABLE_DOCUMENT, int(VariableDocumentIntent.UPDATE)): variables.process,
            (ValueType.JOB, int(JobIntent.RECUR_AFTER_BACKOFF)): jobs.recur_after_backoff,
            (ValueType.JOB, int(JobIntent.YIELD)): jobs.yield_job,
            (ValueType.JOB, int(JobIntent.UPDATE_TIMEOUT)): jobs.update_timeout,
            (ValueType.TIMER, int(TimerIntent.TRIGGER)): timers.trigger,
            (ValueType.MESSAGE, int(MessageIntent.PUBLISH)): messages.publish,
            (ValueType.MESSAGE, int(MessageIntent.EXPIRE)): messages.expire,
            (ValueType.MESSAGE_BATCH, int(MessageBatchIntent.EXPIRE)): messages.expire_batch,
            (ValueType.MESSAGE_SUBSCRIPTION, int(MessageSubscriptionIntent.CREATE)): msg_subs.create,
            (ValueType.MESSAGE_SUBSCRIPTION, int(MessageSubscriptionIntent.CORRELATE)): msg_subs.correlate_ack,
            (ValueType.MESSAGE_SUBSCRIPTION, int(MessageSubscriptionIntent.DELETE)): msg_subs.delete,
            (ValueType.PROCESS_MESSAGE_SUBSCRIPTION, int(ProcessMessageSubscriptionIntent.CORRELATE)): pms.correlate,
            (ValueType.SIGNAL, int(SignalIntent.BROADCAST)): signals.broadcast,
            (ValueType.COMMAND_DISTRIBUTION, int(CommandDistributionIntent.ACKNOWLEDGE)): dist_ack.process,
            (ValueType.DECISION_EVALUATION, int(DecisionEvaluationIntent.EVALUATE)): decision_eval.process,
            (ValueType.CHECKPOINT, int(CheckpointIntent.CREATE)): self.checkpoint.process,
            (ValueType.PROCESS_INSTANCE_MODIFICATION, int(ProcessInstanceModificationIntent.MODIFY)): modification.process,
            (ValueType.PROCESS_INSTANCE_MIGRATION, int(ProcessInstanceMigrationIntent.MIGRATE)): migration.process,
            (ValueType.RESOURCE_DELETION, int(ResourceDeletionIntent.DELETE)): resource_deletion.process,
            (ValueType.PROCESS_INSTANCE_BATCH, int(ProcessInstanceBatchIntent.ACTIVATE)): pi_batch.activate,
            (ValueType.PROCESS_INSTANCE_BATCH, int(ProcessInstanceBatchIntent.TERMINATE)): pi_batch.terminate,
            (ValueType.USER_TASK, int(UserTaskIntent.COMPLETE)): user_tasks.complete,
            (ValueType.USER_TASK, int(UserTaskIntent.ASSIGN)): user_tasks.assign,
            (ValueType.USER_TASK, int(UserTaskIntent.CLAIM)): user_tasks.claim,
            (ValueType.USER_TASK, int(UserTaskIntent.UPDATE)): user_tasks.update,
        }
        self.state.load_key_generator()

    def _on_root_completed(self, key: int, value: dict, child_locals: dict,
                           writers) -> None:
        """Answer a parked CreateProcessInstanceWithResult request with the
        root scope's final variables (reference: ProcessProcessor →
        BpmnProcessResultSenderBehavior, ProcessInstanceResultIntent)."""
        parked = self.await_results.pop(key, None)
        if parked is None:
            return
        request_id, stream_id, fetch = parked
        variables = dict(child_locals)
        if fetch:
            variables = {k: v for k, v in variables.items() if k in fetch}
        from zeebe_tpu_torch.protocol.intent import ProcessInstanceResultIntent

        result = writers.append_event(
            key, ValueType.PROCESS_INSTANCE_RESULT,
            ProcessInstanceResultIntent.COMPLETED,
            {**{k: value.get(k) for k in (
                "bpmnProcessId", "version", "processDefinitionKey",
                "processInstanceKey")},
             "variables": variables},
        )
        writers.respond_to(result, stream_id, request_id)

    def _on_root_terminated(self, key: int, value: dict, writers) -> None:
        """A canceled instance fails its parked await-result request fast
        instead of leaking it until the request times out."""
        parked = self.await_results.pop(key, None)
        if parked is None:
            return
        request_id, stream_id, _ = parked
        from zeebe_tpu_torch.protocol import rejection
        from zeebe_tpu_torch.protocol import command as _command
        from zeebe_tpu_torch.protocol.intent import ProcessInstanceCreationIntent as _PIC

        rej = rejection(
            _command(ValueType.PROCESS_INSTANCE_CREATION, _PIC.CREATE,
                     {"processInstanceKey": key}),
            RejectionType.NOT_FOUND,
            f"process instance {key} was terminated before completing",
        )
        writers.respond_to(rej, stream_id, request_id)

    def wire_sender(self, sender) -> None:
        """Install the inter-partition command sender (loopback or cluster)."""
        self.sender.delegate = sender

    # -- RecordProcessor SPI -------------------------------------------------

    def accepts(self, value_type: ValueType) -> bool:
        return any(vt == value_type for vt, _ in self._processors)

    def process(self, record: LoggedRecord, result: ProcessingResultBuilder) -> None:
        writers = Writers(result, self.appliers)
        pi_key = record.record.value.get("processInstanceKey", -1) if record.record.value else -1
        if self.state.banned.is_banned(pi_key):
            return  # quarantined instance: drop silently (reference Engine:126)
        handler = self._processors.get((record.record.value_type, int(record.record.intent)))
        if handler is None:
            writers.respond_rejection(
                record, RejectionType.INVALID_ARGUMENT,
                f"no processor for {record.record.value_type.name} {record.record.intent.name}",
            )
            return
        handler(record, writers)

    def replay(self, record: LoggedRecord) -> None:
        self.appliers.apply(record.record)
