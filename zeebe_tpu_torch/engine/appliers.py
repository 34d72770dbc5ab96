"""Event appliers: the only code allowed to mutate engine state.

Reference: engine/src/main/java/io/camunda/zeebe/engine/state/appliers/ (65
files; EventAppliers.java:48 registers one TypedEventApplier per intent).
``apply`` is called both during processing (via the StateWriter, immediately
after the event is appended to the result) and during replay — by construction
the same code path, which is what makes replay ≡ processing.

Every applier also feeds the key generator (``observe_key``) so replay
restores the highest assigned key (reference: ReplayStateMachine key restore).
"""

from __future__ import annotations

from typing import Callable

from zeebe_tpu_torch.engine.engine_state import (
    EI_ACTIVATED,
    EI_ACTIVATING,
    EI_COMPLETED,
    EI_COMPLETING,
    EI_TERMINATED,
    EI_TERMINATING,
    EngineState,
)
from zeebe_tpu_torch.protocol import DEFAULT_TENANT, Record, ValueType
from zeebe_tpu_torch.protocol.enums import BpmnElementType
from zeebe_tpu_torch.protocol.intent import (
    DeploymentIntent,
    IncidentIntent,
    JobBatchIntent,
    JobIntent,
    ProcessInstanceCreationIntent,
    ProcessInstanceIntent,
    ProcessIntent,
    SignalIntent,
    TimerIntent,
    VariableIntent,
)


class EventAppliers:
    on_checkpoint_applied = None  # set by the owning partition (cache hook)

    def __init__(self, state: EngineState) -> None:
        self.state = state
        self._appliers: dict[tuple[ValueType, int], Callable[[Record], None]] = {}
        self._register()
    def _register(self) -> None:
        reg = self._appliers
        reg[(ValueType.PROCESS, int(ProcessIntent.CREATED))] = self._process_created
        from zeebe_tpu_torch.protocol.intent import FormIntent

        reg[(ValueType.FORM, int(FormIntent.CREATED))] = self._form_created
        reg[(ValueType.FORM, int(FormIntent.DELETED))] = self._form_deleted
        from zeebe_tpu_torch.protocol.intent import ProcessInstanceBatchIntent

        reg[(ValueType.PROCESS_INSTANCE_BATCH,
             int(ProcessInstanceBatchIntent.ACTIVATED))] = self._pi_batch_activated
        reg[(ValueType.PROCESS_INSTANCE_BATCH,
             int(ProcessInstanceBatchIntent.TERMINATED))] = self._noop
        reg[(ValueType.DEPLOYMENT, int(DeploymentIntent.CREATED))] = self._noop
        reg[(ValueType.DEPLOYMENT, int(DeploymentIntent.FULLY_DISTRIBUTED))] = self._noop
        reg[(ValueType.PROCESS_INSTANCE_CREATION, int(ProcessInstanceCreationIntent.CREATED))] = self._noop
        reg[(ValueType.PROCESS_INSTANCE, int(ProcessInstanceIntent.ELEMENT_ACTIVATING))] = self._element_activating
        reg[(ValueType.PROCESS_INSTANCE, int(ProcessInstanceIntent.ELEMENT_ACTIVATED))] = self._element_activated
        reg[(ValueType.PROCESS_INSTANCE, int(ProcessInstanceIntent.ELEMENT_COMPLETING))] = self._element_completing
        reg[(ValueType.PROCESS_INSTANCE, int(ProcessInstanceIntent.ELEMENT_COMPLETED))] = self._element_completed
        reg[(ValueType.PROCESS_INSTANCE, int(ProcessInstanceIntent.ELEMENT_TERMINATING))] = self._element_terminating
        reg[(ValueType.PROCESS_INSTANCE, int(ProcessInstanceIntent.ELEMENT_TERMINATED))] = self._element_terminated
        reg[(ValueType.PROCESS_INSTANCE, int(ProcessInstanceIntent.SEQUENCE_FLOW_TAKEN))] = self._sequence_flow_taken
        reg[(ValueType.JOB, int(JobIntent.CREATED))] = self._job_created
        reg[(ValueType.JOB, int(JobIntent.COMPLETED))] = self._job_completed
        reg[(ValueType.JOB, int(JobIntent.FAILED))] = self._job_failed
        reg[(ValueType.JOB, int(JobIntent.TIMED_OUT))] = self._job_timed_out
        reg[(ValueType.JOB, int(JobIntent.RETRIES_UPDATED))] = self._job_retries_updated
        reg[(ValueType.JOB, int(JobIntent.CANCELED))] = self._job_canceled
        reg[(ValueType.JOB, int(JobIntent.RECURRED_AFTER_BACKOFF))] = self._job_recurred
        reg[(ValueType.JOB, int(JobIntent.YIELDED))] = self._job_yielded
        reg[(ValueType.JOB, int(JobIntent.TIMEOUT_UPDATED))] = self._job_timeout_updated
        reg[(ValueType.JOB, int(JobIntent.ERROR_THROWN))] = self._job_error_thrown
        reg[(ValueType.JOB_BATCH, int(JobBatchIntent.ACTIVATED))] = self._job_batch_activated
        reg[(ValueType.VARIABLE, int(VariableIntent.CREATED))] = self._variable_set
        reg[(ValueType.VARIABLE, int(VariableIntent.UPDATED))] = self._variable_set
        reg[(ValueType.INCIDENT, int(IncidentIntent.CREATED))] = self._incident_created
        reg[(ValueType.INCIDENT, int(IncidentIntent.RESOLVED))] = self._incident_resolved
        from zeebe_tpu_torch.protocol.intent import (
            MessageBatchIntent,
            MessageIntent,
            MessageStartEventSubscriptionIntent,
            MessageSubscriptionIntent,
            ProcessMessageSubscriptionIntent,
            VariableDocumentIntent,
        )

        reg[(ValueType.VARIABLE_DOCUMENT, int(VariableDocumentIntent.UPDATED))] = self._noop
        reg[(ValueType.TIMER, int(TimerIntent.CREATED))] = self._timer_created
        reg[(ValueType.TIMER, int(TimerIntent.TRIGGERED))] = self._timer_removed
        reg[(ValueType.TIMER, int(TimerIntent.CANCELED))] = self._timer_removed
        reg[(ValueType.MESSAGE, int(MessageIntent.PUBLISHED))] = self._message_published
        reg[(ValueType.MESSAGE, int(MessageIntent.EXPIRED))] = self._message_removed
        reg[(ValueType.MESSAGE_BATCH, int(MessageBatchIntent.EXPIRED))] = self._message_batch_expired
        reg[(ValueType.MESSAGE_SUBSCRIPTION, int(MessageSubscriptionIntent.CREATED))] = self._msg_sub_created
        reg[(ValueType.MESSAGE_SUBSCRIPTION, int(MessageSubscriptionIntent.CORRELATING))] = self._msg_sub_correlating
        reg[(ValueType.MESSAGE_SUBSCRIPTION, int(MessageSubscriptionIntent.CORRELATED))] = self._msg_sub_correlated
        reg[(ValueType.MESSAGE_SUBSCRIPTION, int(MessageSubscriptionIntent.DELETED))] = self._msg_sub_deleted
        reg[(ValueType.PROCESS_MESSAGE_SUBSCRIPTION, int(ProcessMessageSubscriptionIntent.CREATING))] = self._pms_creating
        reg[(ValueType.PROCESS_MESSAGE_SUBSCRIPTION, int(ProcessMessageSubscriptionIntent.CREATED))] = self._pms_created
        reg[(ValueType.PROCESS_MESSAGE_SUBSCRIPTION, int(ProcessMessageSubscriptionIntent.CORRELATED))] = self._pms_correlated
        reg[(ValueType.PROCESS_MESSAGE_SUBSCRIPTION, int(ProcessMessageSubscriptionIntent.DELETED))] = self._pms_deleted
        reg[(ValueType.MESSAGE_START_EVENT_SUBSCRIPTION, int(MessageStartEventSubscriptionIntent.CREATED))] = self._msg_start_created
        reg[(ValueType.MESSAGE_START_EVENT_SUBSCRIPTION, int(MessageStartEventSubscriptionIntent.CORRELATED))] = self._noop
        reg[(ValueType.MESSAGE_START_EVENT_SUBSCRIPTION, int(MessageStartEventSubscriptionIntent.DELETED))] = self._msg_start_deleted
        from zeebe_tpu_torch.protocol.intent import (
            EscalationIntent,
            SignalIntent,
            SignalSubscriptionIntent,
        )

        reg[(ValueType.SIGNAL, int(SignalIntent.BROADCASTED))] = self._noop
        reg[(ValueType.SIGNAL_SUBSCRIPTION, int(SignalSubscriptionIntent.CREATED))] = self._signal_sub_created
        reg[(ValueType.SIGNAL_SUBSCRIPTION, int(SignalSubscriptionIntent.DELETED))] = self._signal_sub_deleted
        reg[(ValueType.ESCALATION, int(EscalationIntent.ESCALATED))] = self._noop
        reg[(ValueType.ESCALATION, int(EscalationIntent.NOT_ESCALATED))] = self._noop
        from zeebe_tpu_torch.protocol.intent import CommandDistributionIntent

        reg[(ValueType.COMMAND_DISTRIBUTION, int(CommandDistributionIntent.STARTED))] = self._distribution_started
        reg[(ValueType.COMMAND_DISTRIBUTION, int(CommandDistributionIntent.DISTRIBUTING))] = self._distribution_distributing
        reg[(ValueType.COMMAND_DISTRIBUTION, int(CommandDistributionIntent.ACKNOWLEDGED))] = self._distribution_acknowledged
        reg[(ValueType.COMMAND_DISTRIBUTION, int(CommandDistributionIntent.FINISHED))] = self._distribution_finished
        reg[(ValueType.DEPLOYMENT, int(DeploymentIntent.DISTRIBUTED))] = self._noop
        from zeebe_tpu_torch.protocol.intent import ProcessInstanceResultIntent

        reg[(ValueType.PROCESS_INSTANCE_RESULT, int(ProcessInstanceResultIntent.COMPLETED))] = self._noop
        from zeebe_tpu_torch.protocol.intent import (
            DecisionEvaluationIntent,
            DecisionIntent,
            DecisionRequirementsIntent,
        )

        reg[(ValueType.DECISION_REQUIREMENTS, int(DecisionRequirementsIntent.CREATED))] = self._drg_created
        reg[(ValueType.DECISION, int(DecisionIntent.CREATED))] = self._decision_created
        reg[(ValueType.DECISION_EVALUATION, int(DecisionEvaluationIntent.EVALUATED))] = self._noop
        reg[(ValueType.DECISION_EVALUATION, int(DecisionEvaluationIntent.FAILED))] = self._noop
        from zeebe_tpu_torch.protocol.intent import CheckpointIntent

        reg[(ValueType.CHECKPOINT, int(CheckpointIntent.CREATED))] = self._checkpoint_created
        reg[(ValueType.CHECKPOINT, int(CheckpointIntent.IGNORED))] = self._noop
        from zeebe_tpu_torch.protocol.intent import (
            ProcessInstanceMigrationIntent,
            ProcessInstanceModificationIntent,
            ResourceDeletionIntent,
        )

        reg[(ValueType.PROCESS_INSTANCE_MODIFICATION, int(ProcessInstanceModificationIntent.MODIFIED))] = self._noop
        reg[(ValueType.PROCESS_INSTANCE_MIGRATION, int(ProcessInstanceMigrationIntent.MIGRATED))] = self._migrated
        reg[(ValueType.RESOURCE_DELETION, int(ResourceDeletionIntent.DELETING))] = self._noop
        reg[(ValueType.RESOURCE_DELETION, int(ResourceDeletionIntent.DELETED))] = self._resource_deleted
        from zeebe_tpu_torch.protocol.intent import UserTaskIntent

        reg[(ValueType.USER_TASK, int(UserTaskIntent.CREATING))] = self._noop
        reg[(ValueType.USER_TASK, int(UserTaskIntent.CREATED))] = self._user_task_created
        reg[(ValueType.USER_TASK, int(UserTaskIntent.COMPLETING))] = self._noop
        reg[(ValueType.USER_TASK, int(UserTaskIntent.COMPLETED))] = self._user_task_removed
        reg[(ValueType.USER_TASK, int(UserTaskIntent.CANCELING))] = self._noop
        reg[(ValueType.USER_TASK, int(UserTaskIntent.CANCELED))] = self._user_task_removed
        reg[(ValueType.USER_TASK, int(UserTaskIntent.ASSIGNING))] = self._noop
        reg[(ValueType.USER_TASK, int(UserTaskIntent.ASSIGNED))] = self._user_task_updated
        reg[(ValueType.USER_TASK, int(UserTaskIntent.UPDATED))] = self._user_task_updated

    def can_apply(self, record: Record) -> bool:
        return (record.value_type, int(record.intent)) in self._appliers

    def apply(self, record: Record) -> None:
        applier = self._appliers.get((record.value_type, int(record.intent)))
        if applier is None:
            raise KeyError(
                f"no event applier for {record.value_type.name} {record.intent.name}"
            )
        if record.key >= 0:
            self.state.observe_key(record.key)
        applier(record)

    # -- appliers ------------------------------------------------------------

    def _noop(self, record: Record) -> None:
        pass

    def _user_task_created(self, record: Record) -> None:
        self.state.user_tasks.create(record.key, record.value)

    def _user_task_updated(self, record: Record) -> None:
        self.state.user_tasks.update(record.key, record.value)

    def _user_task_removed(self, record: Record) -> None:
        self.state.user_tasks.remove(record.key)

    def _migrated(self, record: Record) -> None:
        from zeebe_tpu_torch.engine.modification import apply_migrated

        apply_migrated(self.state, record)

    def _resource_deleted(self, record: Record) -> None:
        resource_key = record.value["resourceKey"]
        self.state.processes.delete(resource_key)
        self.state.decisions.delete_drg(resource_key)

    def _checkpoint_created(self, record: Record) -> None:
        self.state.checkpoints.put(
            record.value["checkpointId"], record.value["checkpointPosition"]
        )
        # cache hook: partitions keep a lock-free latest-checkpoint-id for
        # the cross-thread inter-partition send path; the applier is the one
        # place both leader processing AND follower replay pass through
        if self.on_checkpoint_applied is not None:
            self.on_checkpoint_applied(record.value["checkpointId"])

    def _drg_created(self, record: Record) -> None:
        self.state.decisions.put_drg(record.key, record.value)

    def _decision_created(self, record: Record) -> None:
        self.state.decisions.put_decision(record.key, record.value)

    # command distribution (reference: state/appliers/CommandDistribution*Applier)

    def _distribution_started(self, record: Record) -> None:
        self.state.distribution.start(record.key, record.value)

    def _distribution_distributing(self, record: Record) -> None:
        self.state.distribution.add_pending(record.key, record.value["partitionId"])

    def _distribution_acknowledged(self, record: Record) -> None:
        if record.value.get("received"):
            # receiver-side marker: dedups retried distribution sends
            self.state.distribution.mark_received(
                record.key, record.value.get("receivedAt", 0)
            )
        else:
            self.state.distribution.remove_pending(record.key, record.value["partitionId"])

    def _distribution_finished(self, record: Record) -> None:
        self.state.distribution.finish(record.key)

    def _pi_batch_activated(self, record: Record) -> None:
        """Track chunked multi-instance activation progress on the body
        instance: completion of the body must wait for the final chunk.
        Monotonic: the index never rewinds and the total is pinned by the
        first chunk (guards against collection mutation between chunks)."""
        v = record.value
        body_key = v.get("batchElementInstanceKey", -1)
        body = self.state.element_instances.get(body_key)
        if body is None:
            return
        index = max(v.get("index", 0), body.get("miActivationIndex", 0))
        # the total only ever DECREASES after the pin (the processor lowers it
        # exactly once, when a shrunken collection terminates the chain) — a
        # later chunk can never re-raise it and re-block completion
        stored = body.get("miTotal")
        total = min(stored, v.get("count", 0)) if stored else v.get("count", 0)
        self.state.element_instances.update(
            body_key, miActivationIndex=index, miTotal=total,
        )

    def _form_created(self, record: Record) -> None:
        self.state.forms.put(record.value)

    def _form_deleted(self, record: Record) -> None:
        self.state.forms.delete(record.key)

    def _process_created(self, record: Record) -> None:
        v = record.value
        self.state.processes.put_process(
            key=v["processDefinitionKey"],
            bpmn_process_id=v["bpmnProcessId"],
            version=v["version"],
            resource_name=v["resourceName"],
            resource_xml=v["resource"],
            digest=v["checksum"],
            tenant=v.get("tenantId", DEFAULT_TENANT),
        )

    # element lifecycle

    def _element_activating(self, record: Record) -> None:
        v = record.value
        ei = self.state.element_instances
        ei.create(record.key, v, EI_ACTIVATING)
        # a child process of a call activity back-links itself so terminate can
        # reach it (reference: ElementInstance.calledChildInstanceKey)
        parent_ei = v.get("parentElementInstanceKey", -1)
        if parent_ei >= 0 and ei.get(parent_ei) is not None:
            ei.update(parent_ei, calledChildInstanceKey=record.key)
        scope_key = v.get("flowScopeKey", -1)
        if scope_key >= 0:
            ei.add_child(scope_key)
            # token accounting is derived from the process model, like the
            # reference's appliers (they consult ProcessState): a parallel
            # gateway join consumes one token per incoming flow; elements
            # activated via a flow consume one; elements activated directly
            # (start events, boundary events, scopes, multi-instance inner
            # instances) consume none.
            exe = self.state.processes.executable(v["processDefinitionKey"])
            element = exe.element(v["elementId"])
            is_mi_inner = (
                element.multi_instance is not None
                and v.get("bpmnElementType") != BpmnElementType.MULTI_INSTANCE_BODY.name
            )
            if is_mi_inner or v.get("directActivation"):
                # modification-activated: no token was in transit
                pass
            elif element.element_type == BpmnElementType.PARALLEL_GATEWAY:
                ei.consume_active_flows(scope_key, element.incoming_count)
                ei.decrement_taken_flows_for_join(scope_key, element.idx)
            elif element.element_type in (
                BpmnElementType.START_EVENT,
                BpmnElementType.BOUNDARY_EVENT,
                BpmnElementType.EVENT_SUB_PROCESS,
            ):
                pass
            elif element.element_type == BpmnElementType.INTERMEDIATE_CATCH_EVENT and all(
                exe.elements[f.source_idx].element_type == BpmnElementType.EVENT_BASED_GATEWAY
                for f in exe.flows
                if f.target_idx == element.idx
            ):
                # a catch event after an event-based gateway activates directly —
                # the flow gateway→event is never taken (BPMN spec), so there is
                # no in-transit token to consume
                pass
            else:
                ei.consume_active_flows(scope_key, min(1, element.incoming_count))

    def _element_activated(self, record: Record) -> None:
        self.state.element_instances.set_state(record.key, EI_ACTIVATED)

    def _element_completing(self, record: Record) -> None:
        self.state.element_instances.set_state(record.key, EI_COMPLETING)

    def _element_finished(self, record: Record, state: int) -> None:
        """Shared completed/terminated epilogue: stamp the terminal state,
        release the parent scope's child slot, drop the variable scope,
        remove the instance. One body on purpose — the two intents differed
        only in the terminal state constant and had started to drift."""
        v = record.value
        ei = self.state.element_instances
        ei.set_state(record.key, state)
        scope_key = v.get("flowScopeKey", -1)
        if scope_key >= 0:
            ei.remove_child(scope_key)
        self.state.variables.remove_scope(record.key)
        ei.remove(record.key)

    def _element_completed(self, record: Record) -> None:
        self._element_finished(record, EI_COMPLETED)

    def _element_terminating(self, record: Record) -> None:
        self.state.element_instances.set_state(record.key, EI_TERMINATING)

    def _element_terminated(self, record: Record) -> None:
        self._element_finished(record, EI_TERMINATED)

    def _sequence_flow_taken(self, record: Record) -> None:
        v = record.value
        ei = self.state.element_instances
        scope_key = v["flowScopeKey"]
        # a token is now in transit on this flow
        ei.add_active_flow(scope_key)
        # parallel-gateway joins count taken incoming flows
        exe = self.state.processes.executable(v["processDefinitionKey"])
        flow = exe.flow(v["elementId"])
        target = exe.elements[flow.target_idx]
        if target.element_type == BpmnElementType.PARALLEL_GATEWAY:
            ei.increment_taken_flow(scope_key, target.idx, flow.idx)

    # jobs

    def _job_created(self, record: Record) -> None:
        self.state.jobs.create(record.key, record.value)
        element_key = record.value.get("elementInstanceKey", -1)
        if element_key >= 0 and self.state.element_instances.get(element_key) is not None:
            self.state.element_instances.update(element_key, jobKey=record.key)

    def _job_completed(self, record: Record) -> None:
        self.state.jobs.complete(record.key)
        element_key = record.value.get("elementInstanceKey", -1)
        if element_key >= 0 and self.state.element_instances.get(element_key) is not None:
            self.state.element_instances.update(element_key, jobKey=-1)

    def _job_failed(self, record: Record) -> None:
        self.state.jobs.fail(
            record.key, record.value["retries"], record.value.get("retryBackoff", -1)
        )

    def _job_timed_out(self, record: Record) -> None:
        self.state.jobs.timeout(record.key)

    def _job_retries_updated(self, record: Record) -> None:
        self.state.jobs.update_retries(record.key, record.value["retries"])

    def _job_canceled(self, record: Record) -> None:
        self.state.jobs.cancel(record.key)

    def _job_recurred(self, record: Record) -> None:
        self.state.jobs.recur_after_backoff(record.key, record.value.get("recurAt", -1))

    def _job_yielded(self, record: Record) -> None:
        # pushed to a dead client stream: activated → activatable again
        # (reference: JobYieldedApplier)
        self.state.jobs.timeout(record.key)

    def _job_timeout_updated(self, record: Record) -> None:
        self.state.jobs.update_deadline(record.key, record.value["deadline"])

    def _job_batch_activated(self, record: Record) -> None:
        v = record.value
        deadline = v["deadline"]
        for job_key in v["jobKeys"]:
            self.state.jobs.activate(job_key, v.get("worker", ""), deadline)

    # variables

    def _variable_set(self, record: Record) -> None:
        v = record.value
        self.state.variables.set_variable(v["scopeKey"], v["name"], v["value"])

    # incidents

    def _incident_created(self, record: Record) -> None:
        self.state.incidents.create(record.key, record.value)

    def _incident_resolved(self, record: Record) -> None:
        self.state.incidents.resolve(record.key)

    # timers

    def _timer_created(self, record: Record) -> None:
        self.state.timers.create(record.key, record.value)

    def _timer_removed(self, record: Record) -> None:
        self.state.timers.remove(record.key)

    # messages

    def _message_published(self, record: Record) -> None:
        self.state.messages.put(record.key, record.value, record.value.get("deadline", -1))

    def _message_removed(self, record: Record) -> None:
        self.state.messages.remove(record.key, record.value.get("deadline", -1))

    def _message_batch_expired(self, record: Record) -> None:
        """One MESSAGE_BATCH EXPIRED record removes every named message —
        the O(batches) expiry path (reference: MessageBatchExpireProcessor)."""
        for key in record.value.get("messageKeys", []):
            msg = self.state.messages.get(key)
            if msg is not None:
                self.state.messages.remove(key, msg.get("deadline", -1))

    def _msg_sub_created(self, record: Record) -> None:
        self.state.message_subscriptions.put(record.key, record.value)

    def _msg_sub_correlating(self, record: Record) -> None:
        v = record.value
        self.state.messages.mark_correlated(v["messageKey"], v.get("processInstanceKey", -1))

    def _msg_sub_correlated(self, record: Record) -> None:
        # catch-event subscriptions close on correlation
        if record.value.get("interrupting", True):
            self.state.message_subscriptions.remove(record.key)

    def _msg_sub_deleted(self, record: Record) -> None:
        self.state.message_subscriptions.remove(record.key)

    def _pms_creating(self, record: Record) -> None:
        v = record.value
        self.state.process_message_subscriptions.put(
            v["elementInstanceKey"], v["messageName"], v
        )

    def _pms_created(self, record: Record) -> None:
        v = record.value
        self.state.process_message_subscriptions.put(
            v["elementInstanceKey"], v["messageName"], v
        )

    def _pms_correlated(self, record: Record) -> None:
        v = record.value
        if v.get("interrupting", True):
            self.state.process_message_subscriptions.remove(
                v["elementInstanceKey"], v["messageName"]
            )

    def _pms_deleted(self, record: Record) -> None:
        v = record.value
        self.state.process_message_subscriptions.remove(
            v["elementInstanceKey"], v["messageName"]
        )

    def _msg_start_created(self, record: Record) -> None:
        v = record.value
        self.state.message_start_subscriptions.put(
            v["messageName"], v["processDefinitionKey"], v
        )

    def _msg_start_deleted(self, record: Record) -> None:
        self.state.message_start_subscriptions.remove_for_process(
            record.value["processDefinitionKey"]
        )

    # signals

    def _signal_sub_key(self, v: dict) -> int:
        element_key = v.get("catchEventInstanceKey", -1)
        return element_key if element_key >= 0 else v.get("processDefinitionKey", -1)

    def _signal_sub_created(self, record: Record) -> None:
        v = record.value
        self.state.signal_subscriptions.put(v["signalName"], self._signal_sub_key(v), v)

    def _signal_sub_deleted(self, record: Record) -> None:
        v = record.value
        self.state.signal_subscriptions.remove(v["signalName"], self._signal_sub_key(v))

    def _job_error_thrown(self, record: Record) -> None:
        self.state.jobs.error_thrown(record.key)
