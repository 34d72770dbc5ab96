"""BPMN element lifecycle processing — the core state machine.

Reference: engine/src/main/java/io/camunda/zeebe/engine/processing/bpmn/
BpmnStreamProcessor.java:36 (processRecord :75 → guard → processEvent :133
switching on ACTIVATE/COMPLETE/TERMINATE_ELEMENT), ProcessInstanceLifecycle
(legal transitions), behavior/BpmnStateTransitionBehavior (lifecycle event
chains + sequence-flow taking), and the per-type element processors under
bpmn/{container,task,event,gateway}/.

Lifecycle chains produced by one command (identical in shape to the
reference's event streams):

  ACTIVATE_ELEMENT →  ELEMENT_ACTIVATING, ELEMENT_ACTIVATED
                      [wait states stop here: tasks with jobs, catch events]
                      [pass-through elements continue:]
                      ELEMENT_COMPLETING, ELEMENT_COMPLETED,
                      SEQUENCE_FLOW_TAKEN*, follow-up ACTIVATE_ELEMENT cmds
  COMPLETE_ELEMENT →  ELEMENT_COMPLETING, ELEMENT_COMPLETED, flows, …
  TERMINATE_ELEMENT → ELEMENT_TERMINATING, [terminate children/cancel job],
                      ELEMENT_TERMINATED, scope follow-ups

Scope completion: when the last token in a scope disappears (no active
children, no tokens in transit), the scope's COMPLETE_ELEMENT command is
written — process completion bubbles up from end events exactly as in the
reference's afterExecutionPathCompleted.
"""

from __future__ import annotations

from typing import Any

from zeebe_tpu_torch.engine.engine_state import (
    EI_ACTIVATED,
    EI_ACTIVATING,
    EI_COMPLETING,
    EI_TERMINATING,
    EngineState,
)
from zeebe_tpu_torch.engine.writers import Writers
from zeebe_tpu_torch.feel import FeelEvalError
from zeebe_tpu_torch.logstreams import LoggedRecord
from zeebe_tpu_torch.models.bpmn import ExecutableElement, ExecutableProcess
from zeebe_tpu_torch.protocol import DEFAULT_TENANT, RejectionType, ValueType
from zeebe_tpu_torch.protocol.enums import BpmnElementType, BpmnEventType, ErrorType
from zeebe_tpu_torch.protocol.intent import (
    EscalationIntent,
    IncidentIntent,
    JobIntent,
    UserTaskIntent,
    ProcessInstanceIntent,
    ProcessInstanceResultIntent,
    SignalIntent,
    SignalSubscriptionIntent,
    TimerIntent,
    VariableIntent,
)

PI = ProcessInstanceIntent

# fan-outs/fan-ins larger than this ride PROCESS_INSTANCE_BATCH chunk
# commands instead of one unbounded record batch (reference:
# ProcessInstanceBatch ACTIVATE/TERMINATE, EngineConfiguration batch limits)
PI_BATCH_CHUNK = 100


class BpmnProcessor:
    """Handles PROCESS_INSTANCE ACTIVATE/COMPLETE/TERMINATE_ELEMENT commands."""

    def __init__(self, state: EngineState, clock_millis, sender=None, partition_count: int = 1) -> None:
        self.state = state
        self.clock_millis = clock_millis
        self.sender = sender  # InterPartitionCommandSender (set via Engine.wire)
        self.partition_count = partition_count
        from zeebe_tpu_torch.engine.decision import BpmnDecisionBehavior

        self.decision_behavior = BpmnDecisionBehavior(
            state, self._raise_incident, self._write_variable
        )

    # ------------------------------------------------------------------ entry

    def process(self, cmd: LoggedRecord, writers: Writers) -> None:
        intent = cmd.record.intent
        value = dict(cmd.record.value)
        key = cmd.record.key

        if intent == PI.ACTIVATE_ELEMENT:
            exe = self._executable(value)
            element = exe.element(value["elementId"])
            self._activate(key, value, exe, element, writers)
        elif intent == PI.COMPLETE_ELEMENT:
            instance = self.state.element_instances.get(key)
            # COMPLETING is legal here: incident resolution retries a stalled
            # completing transition (condition/output-mapping failures)
            if instance is None or instance["state"] not in (EI_ACTIVATED, EI_ACTIVATING, EI_COMPLETING):
                writers.respond_rejection(
                    cmd, RejectionType.INVALID_STATE,
                    f"expected element instance {key} to be activated, but it is "
                    + ("not present" if instance is None else "not in an activatable state"),
                )
                return
            value = instance["value"]
            # an event-based gateway's COMPLETE command names the catch event
            # that fired (reference: EventBasedGatewayProcessor.onComplete reads
            # the event trigger); pass it through to completion
            if "triggeredElementId" in cmd.record.value:
                value = {**value, "triggeredElementId": cmd.record.value["triggeredElementId"]}
            exe = self._executable(value)
            element = exe.element(value["elementId"])
            self._complete(key, value, exe, element, writers)
        elif intent == PI.TERMINATE_ELEMENT:
            instance = self.state.element_instances.get(key)
            if instance is None:
                writers.respond_rejection(
                    cmd, RejectionType.NOT_FOUND, f"no element instance {key}"
                )
                return
            value = instance["value"]
            exe = self._executable(value)
            element = exe.element(value["elementId"])
            self._terminate(key, value, exe, element, writers)
        else:
            writers.respond_rejection(
                cmd, RejectionType.INVALID_ARGUMENT, f"unsupported intent {intent.name}"
            )

    def _executable(self, value: dict) -> ExecutableProcess:
        exe = self.state.processes.executable(value["processDefinitionKey"])
        if exe is None:
            raise KeyError(f"unknown process definition {value['processDefinitionKey']}")
        return exe

    # -------------------------------------------------------------- activation

    def _activate(
        self, key: int, value: dict, exe: ExecutableProcess,
        element: ExecutableElement, writers: Writers,
    ) -> None:
        start_override = value.get("startElementId")
        mi_item = value.get("miItem")
        has_mi_item = "miItem" in value
        # set when an event-based gateway's triggered catch event is activated
        # directly (no subscription to open; complete immediately)
        event_triggered = bool(value.get("eventTriggered"))
        is_mi_body = (
            element.multi_instance is not None
            and value.get("bpmnElementType") == BpmnElementType.MULTI_INSTANCE_BODY.name
        )
        is_mi_inner = element.multi_instance is not None and not is_mi_body
        value = _pi_value(value, element)
        # an instance already in ACTIVATING is an incident-resolution retry —
        # don't re-append the lifecycle event (the applier would double-count
        # tokens/children) and don't re-open boundary subscriptions
        instance = self.state.element_instances.get(key)
        retrying = instance is not None and instance["state"] == EI_ACTIVATING
        if not retrying:
            writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_ACTIVATING, value)

        if is_mi_body:
            # boundary events attach to the multi-instance body, not the inner
            # instances (reference: MultiInstanceBodyProcessor)
            if element.boundary_idxs and not retrying:
                self._open_boundary_subscriptions(key, value, exe, element, writers)
            self._activate_mi_body(key, value, exe, element, writers)
            return

        if is_mi_inner and not retrying:
            # inputElement local variable precedes input mappings so they can
            # reference it (reference: MultiInstanceBodyProcessor child setup);
            # a null item still creates the variable with value null
            mi = element.multi_instance
            if mi.input_element and has_mi_item:
                self._write_variable(writers, key, value, mi.input_element, mi_item)

        # input mappings create a local variable scope on the element instance
        if element.inputs and not self._apply_input_mappings(
                key, value, element, writers,
                context_key=key if is_mi_inner else value.get("flowScopeKey", -1)):
            return

        # boundary-event subscriptions attach when the host activity activates
        if element.boundary_idxs and not is_mi_inner and not retrying:
            self._open_boundary_subscriptions(key, value, exe, element, writers)

        et = element.element_type
        if et in (BpmnElementType.PROCESS, BpmnElementType.SUB_PROCESS,
                  BpmnElementType.EVENT_SUB_PROCESS):
            # event sub-process start subscriptions open on the scope instance;
            # pre-validated so a failure leaves the scope ACTIVATING (retryable).
            # No `retrying` guard: any earlier failure happened before a single
            # subscription event was written (pre-validation is all-or-nothing
            # and ACTIVATED follows immediately), so a retry must re-open
            if not self._open_scope_event_subscriptions(key, value, exe, element, writers):
                return
            writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_ACTIVATED, value)
            if et == BpmnElementType.PROCESS:
                # message/timer/signal start events carry an explicit start element
                start_idx = exe.by_id[start_override] if start_override else exe.none_start_of(0)
            else:
                start_idx = element.child_start_idx
            start = exe.elements[start_idx]
            self._write_activate(writers, exe, start, scope_key=key, value=value)
        elif et == BpmnElementType.START_EVENT:
            writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_ACTIVATED, value)
            self._complete(key, value, exe, element, writers)
        elif et == BpmnElementType.USER_TASK and element.native_user_task:
            # native user task: lifecycle records instead of a job
            # (reference: zeebe:userTask → UserTaskProcessors)
            form_key = -1
            if element.form_id is not None:
                form_key = self._resolve_form(key, value, element, writers)
                if form_key is None:
                    return  # FORM_NOT_FOUND incident raised; stays ACTIVATING
            writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_ACTIVATED, value)
            task_key = self.state.next_key()
            task_value = {
                "userTaskKey": task_key,
                "assignee": element.user_task_assignee or "",
                "candidateGroups": element.user_task_candidate_groups or "",
                "candidateUsers": "",
                "dueDate": "",
                "followUpDate": "",
                "elementId": element.id,
                "elementInstanceKey": key,
                "processInstanceKey": value["processInstanceKey"],
                "processDefinitionKey": value["processDefinitionKey"],
                "bpmnProcessId": value["bpmnProcessId"],
                **({"formKey": form_key} if form_key >= 0 else {}),
            }
            writers.append_event(task_key, ValueType.USER_TASK,
                                 UserTaskIntent.CREATING, task_value)
            writers.append_event(task_key, ValueType.USER_TASK,
                                 UserTaskIntent.CREATED, task_value)
            # wait state: completion comes from the USER_TASK COMPLETE command
        elif (et == BpmnElementType.BUSINESS_RULE_TASK
              and element.called_decision_id is not None):
            # zeebe:calledDecision: evaluate BEFORE transitioning to ACTIVATED —
            # an evaluation incident must leave the element ACTIVATING so
            # incident resolution can retry the activation (reference:
            # BusinessRuleTaskProcessor evaluates in onActivate)
            if self.decision_behavior.evaluate_called_decision(key, value, element, writers):
                writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_ACTIVATED, value)
                self._complete(key, value, exe, element, writers)
        elif et in (BpmnElementType.SERVICE_TASK, BpmnElementType.SEND_TASK,
                    BpmnElementType.BUSINESS_RULE_TASK, BpmnElementType.SCRIPT_TASK,
                    BpmnElementType.USER_TASK) and element.job_type is not None:
            context = self.state.variables.collect(key)
            try:
                job_type = element.job_type.evaluate(context, self.clock_millis)
                retries = int(element.job_retries.evaluate(context, self.clock_millis))
            except (FeelEvalError, TypeError, ValueError) as exc:
                self._raise_incident(writers, key, value, ErrorType.EXTRACT_VALUE_ERROR, str(exc))
                return
            headers = element.task_headers
            if element.form_id is not None:
                # linked form rides the job as the reference's formKey header
                # (Protocol.USER_TASK_FORM_KEY_HEADER_NAME)
                form_key = self._resolve_form(key, value, element, writers)
                if form_key is None:
                    return  # FORM_NOT_FOUND incident raised; stays ACTIVATING
                headers = {**headers, "io.camunda.zeebe:formKey": str(form_key)}
            writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_ACTIVATED, value)
            job_key = self.state.next_key()
            writers.append_event(
                job_key, ValueType.JOB, JobIntent.CREATED,
                {
                    "type": job_type,
                    "retries": retries,
                    "worker": "",
                    "deadline": -1,
                    "variables": {},
                    "customHeaders": headers,
                    "elementId": element.id,
                    "elementInstanceKey": key,
                    "processInstanceKey": value["processInstanceKey"],
                    "processDefinitionKey": value["processDefinitionKey"],
                    "processDefinitionVersion": value["version"],
                    "bpmnProcessId": value["bpmnProcessId"],
                    "errorMessage": "",
                    **({"tenantId": value["tenantId"]} if "tenantId" in value else {}),
                },
            )
            # wait state: completion comes from the job COMPLETE command
        elif et == BpmnElementType.SCRIPT_TASK and element.script_expression is not None:
            writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_ACTIVATED, value)
            context = self.state.variables.collect(key)
            try:
                result = element.script_expression.evaluate(context, self.clock_millis)
            except FeelEvalError as exc:
                self._raise_incident(writers, key, value, ErrorType.EXTRACT_VALUE_ERROR, str(exc))
                return
            if element.script_result_variable:
                self._write_variable(
                    writers, value.get("flowScopeKey", -1), value,
                    element.script_result_variable, result,
                )
            self._complete(key, value, exe, element, writers)
        elif et in (BpmnElementType.INTERMEDIATE_CATCH_EVENT, BpmnElementType.RECEIVE_TASK):
            writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_ACTIVATED, value)
            if event_triggered:
                # the event already fired at the event-based gateway; pass through
                self._complete(key, value, exe, element, writers)
            elif element.event_type == BpmnEventType.LINK:
                # a catch link is a pass-through: entered by the matching
                # throw, it completes immediately and takes its outgoing
                # flows (reference: IntermediateCatchEventProcessor link)
                self._complete(key, value, exe, element, writers)
            elif element.event_type == BpmnEventType.TIMER or element.timer_duration is not None:
                self._create_timer(key, value, element, element, writers)
            elif element.message_name is not None:
                if not self._open_message_subscription(key, value, element, element, writers):
                    return
            elif element.signal_name is not None:
                self._open_signal_subscription(key, value, element, writers)
            # wait state: timer trigger / message correlation / signal completes it
        elif et == BpmnElementType.EVENT_BASED_GATEWAY:
            # subscribe to every succeeding catch event on the gateway's own
            # element instance; first trigger wins (reference:
            # EventBasedGatewayProcessor.onActivate subscribes BEFORE
            # transitioning to activated). Pre-validate every subscription
            # expression first so a failure writes no subscription events and
            # leaves the gateway ACTIVATING — incident resolution then retries
            # the whole activation without duplicating timers.
            targets = [exe.elements[exe.flows[fidx].target_idx] for fidx in element.outgoing]
            context = self.state.variables.collect(key)
            for target in targets:
                try:
                    if target.event_type == BpmnEventType.TIMER or target.timer_duration is not None:
                        self._eval_duration_millis(target.timer_duration, context)
                    elif target.message_name is not None:
                        ck = target.correlation_key.evaluate(context, self.clock_millis)
                        if ck is None:
                            raise FeelEvalError(
                                f"correlation key of '{target.id}' evaluated to null"
                            )
                except (FeelEvalError, TypeError, ValueError) as exc:
                    self._raise_incident(
                        writers, key, value, ErrorType.EXTRACT_VALUE_ERROR, str(exc)
                    )
                    return
            for target in targets:
                if target.event_type == BpmnEventType.TIMER or target.timer_duration is not None:
                    self._create_timer(key, value, target, element, writers)
                elif target.message_name is not None:
                    self._open_message_subscription(key, value, target, element, writers)
                elif target.signal_name is not None:
                    self._open_signal_subscription(key, value, target, writers)
            writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_ACTIVATED, value)
            # wait state: the first triggered event completes the gateway
        elif et == BpmnElementType.CALL_ACTIVITY:
            self._activate_call_activity(key, value, exe, element, writers)
        elif et == BpmnElementType.END_EVENT and element.event_type == BpmnEventType.ERROR:
            # find the catcher BEFORE activating: an unhandled error leaves the
            # end event ACTIVATING with a retryable incident (reference:
            # EndEventProcessor ErrorEndEventBehavior)
            catcher = self._find_catcher(key, BpmnEventType.ERROR, element.error_code)
            if catcher is None:
                self._raise_incident(
                    writers, key, value, ErrorType.UNHANDLED_ERROR_EVENT,
                    f"Expected to throw an error event with the code "
                    f"'{element.error_code}', but it was not caught. No error events "
                    "are available in the scope.",
                )
                return
            writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_ACTIVATED, value)
            self._execute_catch(catcher, writers)
            # the end event never completes: the interruption terminates it
        elif et in (BpmnElementType.END_EVENT, BpmnElementType.INTERMEDIATE_THROW_EVENT) \
                and element.event_type == BpmnEventType.ESCALATION:
            writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_ACTIVATED, value)
            if self._throw_escalation(key, value, element, writers):
                self._complete(key, value, exe, element, writers)
            # else: an interrupting catcher will terminate this throw event
        elif et in (BpmnElementType.END_EVENT, BpmnElementType.INTERMEDIATE_THROW_EVENT) \
                and element.event_type == BpmnEventType.SIGNAL:
            writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_ACTIVATED, value)
            writers.append_command(
                self.state.next_key(), ValueType.SIGNAL, SignalIntent.BROADCAST,
                {"signalName": element.signal_name, "variables": {}},
            )
            self._complete(key, value, exe, element, writers)
        elif et in (BpmnElementType.MANUAL_TASK, BpmnElementType.TASK,
                    BpmnElementType.EXCLUSIVE_GATEWAY, BpmnElementType.PARALLEL_GATEWAY,
                    BpmnElementType.END_EVENT, BpmnElementType.INTERMEDIATE_THROW_EVENT):
            writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_ACTIVATED, value)
            self._complete(key, value, exe, element, writers)
        else:
            # elements not yet implemented behave as pass-through tasks
            writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_ACTIVATED, value)
            self._complete(key, value, exe, element, writers)

    # ---------------------------------------------------------- multi-instance

    def _eval_input_collection(self, body_key: int, value: dict, element: ExecutableElement,
                               writers: Writers) -> list | None:
        """Evaluate the input collection; incident (and None) if not a list."""
        context = self.state.variables.collect(body_key)
        mi = element.multi_instance
        try:
            items = mi.input_collection.evaluate(context, self.clock_millis)
        except FeelEvalError as exc:
            self._raise_incident(writers, body_key, value, ErrorType.EXTRACT_VALUE_ERROR, str(exc))
            return None
        if not isinstance(items, list):
            self._raise_incident(
                writers, body_key, value, ErrorType.EXTRACT_VALUE_ERROR,
                f"Expected the input collection of '{element.id}' to be an array, "
                f"but it evaluated to {items!r}",
            )
            return None
        return items

    def _activate_mi_body(self, key: int, value: dict, exe: ExecutableProcess,
                          element: ExecutableElement, writers: Writers) -> None:
        """Reference: processing/bpmn/container/MultiInstanceBodyProcessor —
        evaluate inputCollection, spawn inner instances (all for parallel, the
        first for sequential), seed the output collection."""
        mi = element.multi_instance
        items = self._eval_input_collection(key, value, element, writers)
        if items is None:
            return  # incident raised; body stays ACTIVATING
        writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_ACTIVATED, value)

        if mi.output_collection:
            self._write_variable(
                writers, key, value, mi.output_collection, [None] * len(items)
            )

        if not items:
            self._complete(key, value, exe, element, writers)
            return
        if mi.is_sequential:
            self._write_mi_inner_activate(writers, key, value, element, items[0], 1)
        elif len(items) > PI_BATCH_CHUNK:
            # large fan-out rides PROCESS_INSTANCE_BATCH chunking so no single
            # step writes an unbounded record batch (reference:
            # ActivateProcessInstanceBatchProcessor, SURVEY §5.7)
            from zeebe_tpu_torch.protocol.intent import ProcessInstanceBatchIntent

            writers.append_command(
                self.state.next_key(), ValueType.PROCESS_INSTANCE_BATCH,
                ProcessInstanceBatchIntent.ACTIVATE,
                {
                    "processInstanceKey": value["processInstanceKey"],
                    "batchElementInstanceKey": key,
                    "index": 0,
                },
            )
        else:
            for i, item in enumerate(items):
                self._write_mi_inner_activate(writers, key, value, element, item, i + 1)

    def _write_mi_inner_activate(self, writers: Writers, body_key: int, body_value: dict,
                                 element: ExecutableElement, item, loop_counter: int) -> None:
        # the extra's bpmnElementType overrides _write_activate's
        # MULTI_INSTANCE_BODY wrapping: the inner instance IS the element
        exe = self.state.processes.executable(body_value["processDefinitionKey"])
        self._write_activate(
            writers, exe, element, body_key, body_value,
            extra={
                "bpmnElementType": element.element_type.name,
                "loopCounter": loop_counter,
                "miItem": item,
            },
        )

    def _on_mi_inner_completed(self, inner_key: int, inner_value: dict,
                               exe: ExecutableProcess, element: ExecutableElement,
                               writers: Writers) -> None:
        """Collect the output element, advance a sequential loop, and complete
        the body when the last inner instance finishes. Called after the inner
        ELEMENT_COMPLETED event was applied (instance and scope are gone)."""
        mi = element.multi_instance
        body_key = inner_value.get("flowScopeKey", -1)
        body = self.state.element_instances.get(body_key)
        if body is None or body["state"] not in (EI_ACTIVATED, EI_ACTIVATING):
            return  # body interrupted/terminated meanwhile
        body_value = body["value"]
        loop_counter = inner_value.get("loopCounter", 0)

        if mi.is_sequential:
            # re-read the collection per iteration, matching the reference
            # implementation (MultiInstanceBodyProcessor.onChildCompleted
            # re-reads the input collection; mutating it mid-loop is documented
            # as unsupported in both engines)
            items = self._eval_input_collection(body_key, body_value, element, writers)
            if items is None:
                return
            if loop_counter < len(items):
                self._write_mi_inner_activate(
                    writers, body_key, body_value, element, items[loop_counter],
                    loop_counter + 1,
                )
                return
        if body["activeChildren"] == 0:
            # chunked fan-out: more ACTIVATE batches pending → not done yet
            # (miActivationIndex/miTotal maintained by the PI-batch applier)
            mi_index = body.get("miActivationIndex")
            if mi_index is not None and mi_index < body.get("miTotal", 0):
                return
            writers.append_command(
                body_key, ValueType.PROCESS_INSTANCE, PI.COMPLETE_ELEMENT, {}
            )

    def _collect_mi_output(self, inner_key: int, inner_value: dict,
                           element: ExecutableElement, writers: Writers) -> bool:
        """Store the evaluated outputElement into the body's output collection
        at position loopCounter-1. Runs before the inner COMPLETED event so the
        inner variable scope is still live. Returns False (after raising an
        incident) when the output element cannot be evaluated — the inner
        instance stays COMPLETING and incident resolution retries."""
        mi = element.multi_instance
        if not mi.output_collection or mi.output_element is None:
            return True
        body_key = inner_value.get("flowScopeKey", -1)
        context = self.state.variables.collect(inner_key)
        try:
            item = mi.output_element.evaluate(context, self.clock_millis)
        except FeelEvalError as exc:
            self._raise_incident(
                writers, inner_key, inner_value, ErrorType.EXTRACT_VALUE_ERROR, str(exc)
            )
            return False
        collection = self.state.variables.get_local(body_key, mi.output_collection)
        if not isinstance(collection, list):
            return True
        idx = inner_value.get("loopCounter", 0) - 1
        if 0 <= idx < len(collection):
            updated = list(collection)
            updated[idx] = item
            body = self.state.element_instances.get(body_key)
            body_value = body["value"] if body else inner_value
            self._write_variable(writers, body_key, body_value, mi.output_collection, updated)
        return True

    # ----------------------------------------------------------- call activity

    def _activate_call_activity(self, key: int, value: dict, exe: ExecutableProcess,
                                element: ExecutableElement, writers: Writers) -> None:
        """Reference: processing/bpmn/container/CallActivityProcessor — resolve
        the called process, create a child instance with the parent back-links,
        and copy the call-activity scope variables into the child root."""
        # the called process resolves within the caller's tenant (reference:
        # CallActivityProcessor + TenantAuthorizationChecker)
        meta = self.state.processes.get_latest_by_id(
            element.called_process_id, value.get("tenantId", DEFAULT_TENANT))
        if meta is None:
            self._raise_incident(
                writers, key, value, ErrorType.CALLED_ELEMENT_ERROR,
                f"Expected process with BPMN process id '{element.called_process_id}' "
                "to be deployed, but not found",
            )
            return  # stays ACTIVATING; resolve retries
        called = self.state.processes.executable(meta["processDefinitionKey"])
        if called.root.child_start_idx < 0:
            self._raise_incident(
                writers, key, value, ErrorType.CALLED_ELEMENT_ERROR,
                f"Expected process '{element.called_process_id}' to have a none start "
                "event, but not found",
            )
            return
        writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_ACTIVATED, value)

        child_key = self.state.next_key()
        child_value = {
            "bpmnProcessId": meta["bpmnProcessId"],
            "version": meta["version"],
            "processDefinitionKey": meta["processDefinitionKey"],
            "processInstanceKey": child_key,
            "elementId": meta["bpmnProcessId"],
            "flowScopeKey": -1,
            "bpmnElementType": BpmnElementType.PROCESS.name,
            "bpmnEventType": BpmnEventType.UNSPECIFIED.name,
            "parentProcessInstanceKey": value.get("processInstanceKey", -1),
            "parentElementInstanceKey": key,
        }
        writers.append_command(
            child_key, ValueType.PROCESS_INSTANCE, PI.ACTIVATE_ELEMENT, child_value
        )
        # propagate all visible variables into the child root scope
        # (reference default: propagateAllParentVariables=true)
        for name, val in self.state.variables.collect(key).items():
            var_key = self.state.next_key()
            writers.append_event(
                var_key, ValueType.VARIABLE, VariableIntent.CREATED,
                {
                    "name": name, "value": val, "scopeKey": child_key,
                    "processInstanceKey": child_key,
                    "processDefinitionKey": meta["processDefinitionKey"],
                    "bpmnProcessId": meta["bpmnProcessId"],
                },
            )

    # ------------------------------------------------- event subscriptions

    def _eval_duration_millis(self, expr, context) -> int:
        millis, _ = self._eval_duration_millis_ex(expr, context)
        return millis

    def _eval_duration_millis_ex(self, expr, context) -> tuple[int, bool]:
        """→ (millis, calendar_dependent). A years-and-months span's
        millisecond delta depends on the current clock DATE (P1M from Jan 31
        is 28d, from Mar 31 is 30d), so it is NOT a pure function of the
        variable context even without now() — burst templates must decline."""
        from zeebe_tpu_torch.feel.temporal import Duration, YearMonthDuration, temporal_add
        from zeebe_tpu_torch.feel.temporal import FeelDateTime
        from zeebe_tpu_torch.utils import parse_duration_millis

        raw = expr.evaluate(context, self.clock_millis)
        if isinstance(raw, Duration):
            return raw.millis, False
        if isinstance(raw, YearMonthDuration):
            now = FeelDateTime.from_epoch_millis(self.clock_millis())
            return temporal_add(now, raw).epoch_millis - now.epoch_millis, True
        if isinstance(raw, (int, float)):
            return int(raw), False
        return parse_duration_millis(str(raw)), False

    def _create_timer(self, host_key: int, value: dict, catching: ExecutableElement,
                      host: ExecutableElement, writers: Writers,
                      repetitions: int = 1, interval: int = -1) -> None:
        from zeebe_tpu_torch.engine.burst_templates import (
            note_clock_poison,
            note_clock_value,
        )

        clock_free = True
        absolute_due: int | None = None
        try:
            if catching.timer_duration is not None:
                context = self.state.variables.collect(host_key)
                duration, calendar_dep = self._eval_duration_millis_ex(
                    catching.timer_duration, context
                )
                # a now()-referencing or calendar-anchored duration makes the
                # due date NOT clock + constant — template captures must decline
                clock_free = (not catching.timer_duration.references_clock()
                              and not calendar_dep)
            elif catching.timer_date is not None:
                # absolute due date (FEEL temporal or ISO string); the due
                # date is a pure function of the variable context, so it is
                # a sound template CONSTANT — unless the expression reads
                # the clock, which poisons the burst
                context = self.state.variables.collect(host_key)
                absolute_due = _eval_date_millis(
                    catching.timer_date, context, self.clock_millis
                )
                duration = 0
                clock_free = not catching.timer_date.references_clock()
            elif catching.timer_cycle is not None:
                # R<n>/<duration> cycle (non-interrupting repeating events);
                # the cycle itself is a FEEL expression (reference: timer
                # definitions are expressions, Timer.java transform)
                from zeebe_tpu_torch.utils import parse_cycle

                context = self.state.variables.collect(host_key)
                cycle_text = catching.timer_cycle.evaluate(context, self.clock_millis)
                repetitions, duration = parse_cycle(str(cycle_text))
                interval = duration
                clock_free = not catching.timer_cycle.references_clock()
            else:
                raise ValueError(f"timer '{catching.id}' has no duration or cycle")
        except Exception as exc:  # noqa: BLE001 — bad timer → incident
            self._raise_incident(writers, host_key, value, ErrorType.EXTRACT_VALUE_ERROR, str(exc))
            return
        timer_key = self.state.next_key()
        if absolute_due is not None:
            due_date = absolute_due
            if not clock_free:
                note_clock_poison()
        else:
            due_date = self.clock_millis() + duration
            if clock_free:
                note_clock_value(due_date, duration)
            else:
                note_clock_poison()
        writers.append_event(
            timer_key, ValueType.TIMER, TimerIntent.CREATED,
            {
                "elementId": host.id,
                "targetElementId": catching.id,
                "elementInstanceKey": host_key,
                "processInstanceKey": value.get("processInstanceKey", -1),
                "processDefinitionKey": value.get("processDefinitionKey", -1),
                "dueDate": due_date,
                "repetitions": repetitions,
                "interval": interval if interval > 0 else duration,
            },
        )

    def _open_message_subscription(self, host_key: int, value: dict,
                                   catching: ExecutableElement, host: ExecutableElement,
                                   writers: Writers) -> bool:
        from zeebe_tpu_torch.parallel.partitioning import subscription_partition_id
        from zeebe_tpu_torch.protocol import command as make_command
        from zeebe_tpu_torch.protocol.intent import (
            MessageSubscriptionIntent,
            ProcessMessageSubscriptionIntent,
        )

        context = self.state.variables.collect(host_key)
        try:
            correlation_key = catching.correlation_key.evaluate(context, self.clock_millis)
        except FeelEvalError as exc:
            self._raise_incident(writers, host_key, value, ErrorType.EXTRACT_VALUE_ERROR, str(exc))
            return False
        if correlation_key is None:
            self._raise_incident(
                writers, host_key, value, ErrorType.EXTRACT_VALUE_ERROR,
                f"correlation key of '{catching.id}' evaluated to null",
            )
            return False
        correlation_key = str(correlation_key)
        # the process partition allocates the message-side subscription key so
        # both sides can address it (open, correlate-ack, delete)
        msg_sub_key = self.state.next_key()
        sub_value = {
            "processInstanceKey": value.get("processInstanceKey", -1),
            "elementInstanceKey": host_key,
            "messageName": catching.message_name,
            "correlationKey": correlation_key,
            "targetElementId": catching.id,
            "interrupting": catching.interrupting,
            "bpmnProcessId": value.get("bpmnProcessId", ""),
            "subscriptionPartitionId": self.state.partition_id,
            "messageSubscriptionKey": msg_sub_key,
            **({"tenantId": value["tenantId"]} if "tenantId" in value else {}),
        }
        writers.append_event(
            host_key, ValueType.PROCESS_MESSAGE_SUBSCRIPTION,
            ProcessMessageSubscriptionIntent.CREATING, sub_value,
        )
        message_partition = subscription_partition_id(correlation_key, self.partition_count)
        open_cmd = make_command(
            ValueType.MESSAGE_SUBSCRIPTION, MessageSubscriptionIntent.CREATE, sub_value,
            key=msg_sub_key,
        )
        sender = self.sender
        writers.after_commit(lambda: sender.send_command(message_partition, open_cmd))
        return True

    def _open_boundary_subscriptions(self, host_key: int, value: dict,
                                     exe: ExecutableProcess, host: ExecutableElement,
                                     writers: Writers) -> None:
        for bidx in host.boundary_idxs:
            boundary = exe.elements[bidx]
            if boundary.event_type == BpmnEventType.TIMER and (
                boundary.timer_duration is not None
                or boundary.timer_cycle is not None
                or boundary.timer_date is not None
            ):
                reps = 1 if boundary.interrupting else -1
                self._create_timer(host_key, value, boundary, host, writers, repetitions=reps)
            elif boundary.event_type == BpmnEventType.MESSAGE and boundary.message_name:
                self._open_message_subscription(host_key, value, boundary, host, writers)
            elif boundary.event_type == BpmnEventType.SIGNAL and boundary.signal_name:
                self._open_signal_subscription(host_key, value, boundary, writers)
            # error/escalation boundaries need no subscription: the throw walk
            # finds them via the model (reference: CatchEventAnalyzer)

    def _open_scope_event_subscriptions(self, key: int, value: dict,
                                        exe: ExecutableProcess, element: ExecutableElement,
                                        writers: Writers) -> bool:
        """Open timer/message/signal subscriptions for the scope's event
        sub-processes (reference: BpmnEventSubscriptionBehavior
        subscribeToEvents for ExecutableFlowElementContainer). Expressions are
        pre-validated; on failure an incident is raised and the scope stays
        ACTIVATING."""
        esps = exe.event_sub_processes_of(element.idx)
        if not esps:
            return True
        # the scope instance's own context — the same one the subscription
        # open evaluates in (input mappings have already written to `key`)
        context = self.state.variables.collect(key)
        problem = self.prevalidate_scope_event_subscriptions(
            (esp.child_start_idx for esp in esps), exe, context)
        if problem is not None:
            self._raise_incident(writers, key, value,
                                 ErrorType.EXTRACT_VALUE_ERROR, problem)
            return False
        for esp in esps:
            start = exe.elements[esp.child_start_idx]
            if start.event_type == BpmnEventType.TIMER and (
                start.timer_duration is not None
                or start.timer_cycle is not None
                or start.timer_date is not None
            ):
                reps = 1 if start.interrupting else -1
                self._create_timer(key, value, start, element, writers, repetitions=reps)
            elif start.event_type == BpmnEventType.MESSAGE and start.message_name:
                if not self._open_message_subscription(key, value, start, element, writers):
                    return False  # defensive: pre-validation should have caught it
            elif start.event_type == BpmnEventType.SIGNAL and start.signal_name:
                self._open_signal_subscription(key, value, start, writers)
        return True

    def prevalidate_scope_event_subscriptions(
        self, start_idxs, exe: ExecutableProcess, context: dict,
    ) -> str | None:
        """Evaluate the event-sub-process start expressions that opening the
        subscriptions will evaluate; the error message or None. ONE
        implementation shared by the sequential open (incident on failure)
        and kernel admission (decline on failure) so the two can never
        diverge on what counts as valid."""
        for sidx in start_idxs:
            start = exe.elements[sidx]
            try:
                if start.event_type == BpmnEventType.TIMER and start.timer_duration is not None:
                    self._eval_duration_millis(start.timer_duration, context)
                elif start.event_type == BpmnEventType.MESSAGE:
                    ck = start.correlation_key.evaluate(context, self.clock_millis)
                    if ck is None:
                        raise FeelEvalError(
                            f"correlation key of '{start.id}' evaluated to null"
                        )
            except (FeelEvalError, TypeError, ValueError) as exc:
                return str(exc)
        return None

    def _open_signal_subscription(self, host_key: int, value: dict,
                                  catching: ExecutableElement, writers: Writers) -> None:
        writers.append_event(
            self.state.next_key(), ValueType.SIGNAL_SUBSCRIPTION,
            SignalSubscriptionIntent.CREATED,
            {
                "signalName": catching.signal_name,
                "catchEventId": catching.id,
                "catchEventInstanceKey": host_key,
                "processDefinitionKey": value.get("processDefinitionKey", -1),
                "bpmnProcessId": value.get("bpmnProcessId", ""),
                "processInstanceKey": value.get("processInstanceKey", -1),
                "interrupting": catching.interrupting,
                **({"tenantId": value["tenantId"]} if "tenantId" in value else {}),
            },
        )

    def _close_subscriptions(self, key: int, value: dict, writers: Writers) -> None:
        """Cancel timers + message subscriptions attached to an element
        instance when it completes or terminates."""
        from zeebe_tpu_torch.parallel.partitioning import subscription_partition_id
        from zeebe_tpu_torch.protocol import command as make_command
        from zeebe_tpu_torch.protocol.intent import (
            MessageSubscriptionIntent,
            ProcessMessageSubscriptionIntent,
            TimerIntent,
        )

        for timer_key, timer in self.state.timers.timers_for_element_instance(key):
            writers.append_event(timer_key, ValueType.TIMER, TimerIntent.CANCELED, timer)
        for sub in self.state.signal_subscriptions.subscriptions_of(key):
            writers.append_event(
                key, ValueType.SIGNAL_SUBSCRIPTION, SignalSubscriptionIntent.DELETED, sub
            )
        for sub in self.state.process_message_subscriptions.subscriptions_of(key):
            writers.append_event(
                key, ValueType.PROCESS_MESSAGE_SUBSCRIPTION,
                ProcessMessageSubscriptionIntent.DELETED, sub,
            )
            message_partition = subscription_partition_id(
                sub["correlationKey"], self.partition_count
            )
            sub_key = sub.get("messageSubscriptionKey", -1)
            if sub_key >= 0:
                delete_cmd = make_command(
                    ValueType.MESSAGE_SUBSCRIPTION, MessageSubscriptionIntent.DELETE,
                    dict(sub), key=sub_key,
                )
                sender = self.sender
                writers.after_commit(
                    lambda mp=message_partition, dc=delete_cmd: sender.send_command(mp, dc)
                )

    # ------------------------------------------------- event throwing/catching

    def _find_catcher(self, from_key: int, event_type: BpmnEventType, code: str | None):
        """Walk the scope hierarchy outward from the throwing element, crossing
        call-activity boundaries, to the closest matching catcher (reference:
        processing/common/CatchEventAnalyzer). Within one level an exact code
        match beats a catch-all (no code). Returns
        (kind, exe, catch_element, host_instance_key, host_value) or None —
        kind is "boundary" or "esp"."""
        ei = self.state.element_instances
        instance_key = from_key
        while instance_key >= 0:
            instance = ei.get(instance_key)
            if instance is None:
                return None
            ivalue = instance["value"]
            exe = self.state.processes.executable(ivalue["processDefinitionKey"])
            element = exe.element(ivalue["elementId"])

            def code_of(el):
                return el.error_code if event_type == BpmnEventType.ERROR else el.escalation_code

            def pick(candidates):
                exact = [c for c in candidates if code_of(c[-1]) == code]
                return exact[0] if exact else (candidates[0] if candidates else None)

            if element.element_type in (
                BpmnElementType.PROCESS, BpmnElementType.SUB_PROCESS,
                BpmnElementType.EVENT_SUB_PROCESS,
            ):
                esp_candidates = []
                for esp in exe.event_sub_processes_of(element.idx):
                    start = exe.elements[esp.child_start_idx]
                    if start.event_type == event_type and (
                        code_of(start) is None or code_of(start) == code
                    ):
                        esp_candidates.append((esp, start))
                chosen = pick([(e, s) for e, s in esp_candidates])
                if chosen:
                    return ("esp", exe, chosen[0], instance_key, ivalue)
            # boundary events on this element — but not for a multi-instance
            # inner instance (boundaries attach to the body, which is the next
            # level out)
            is_mi_inner = (
                element.multi_instance is not None
                and ivalue.get("bpmnElementType") != BpmnElementType.MULTI_INSTANCE_BODY.name
            )
            if not is_mi_inner:
                boundary_candidates = [
                    (exe.elements[bidx],)
                    for bidx in element.boundary_idxs
                    if exe.elements[bidx].event_type == event_type
                    and (
                        code_of(exe.elements[bidx]) is None
                        or code_of(exe.elements[bidx]) == code
                    )
                ]
                chosen = pick(boundary_candidates)
                if chosen:
                    return ("boundary", exe, chosen[0], instance_key, ivalue)
            fsk = ivalue.get("flowScopeKey", -1)
            instance_key = fsk if fsk >= 0 else ivalue.get("parentElementInstanceKey", -1)
        return None

    def _execute_catch(self, catcher, writers: Writers) -> None:
        """Activate the catcher and apply its interruption semantics."""
        kind, exe, catch_element, host_key, host_value = catcher
        if kind == "boundary":
            boundary_value = {
                "bpmnProcessId": host_value["bpmnProcessId"],
                "version": host_value["version"],
                "processDefinitionKey": host_value["processDefinitionKey"],
                "processInstanceKey": host_value["processInstanceKey"],
                "elementId": catch_element.id,
                "flowScopeKey": host_value.get("flowScopeKey", -1),
                "bpmnElementType": BpmnElementType.BOUNDARY_EVENT.name,
                "bpmnEventType": catch_element.event_type.name,
            }
            writers.append_command(
                self.state.next_key(), ValueType.PROCESS_INSTANCE,
                PI.ACTIVATE_ELEMENT, boundary_value,
            )
            if catch_element.interrupting:
                writers.append_command(
                    host_key, ValueType.PROCESS_INSTANCE, PI.TERMINATE_ELEMENT, {}
                )
        else:  # event sub-process inside scope host_key
            start = exe.elements[catch_element.child_start_idx]
            esp_value = {
                "bpmnProcessId": host_value["bpmnProcessId"],
                "version": host_value["version"],
                "processDefinitionKey": host_value["processDefinitionKey"],
                "processInstanceKey": host_value["processInstanceKey"],
                "elementId": catch_element.id,
                "flowScopeKey": host_key,
                "bpmnElementType": BpmnElementType.EVENT_SUB_PROCESS.name,
                "bpmnEventType": start.event_type.name,
            }
            writers.append_command(
                self.state.next_key(), ValueType.PROCESS_INSTANCE,
                PI.ACTIVATE_ELEMENT, esp_value,
            )
            if catch_element.interrupting:
                # the interrupted scope accepts no further event triggers and
                # every sibling of the event sub-process terminates
                self._close_subscriptions(host_key, host_value, writers)
                for child_key in self.state.element_instances.children_keys(host_key):
                    writers.append_command(
                        child_key, ValueType.PROCESS_INSTANCE, PI.TERMINATE_ELEMENT, {}
                    )

    def throw_error_from(self, element_key: int, error_code: str, writers: Writers) -> bool:
        """Route a thrown BPMN error (job THROW_ERROR or error end event) to
        the closest catcher. Returns False when unhandled."""
        catcher = self._find_catcher(element_key, BpmnEventType.ERROR, error_code)
        if catcher is None:
            return False
        self._execute_catch(catcher, writers)
        return True

    def _throw_escalation(self, key: int, value: dict, element: ExecutableElement,
                          writers: Writers) -> bool:
        """Throw an escalation; returns True when the throwing element can
        complete (uncaught, or caught non-interrupting — reference:
        BpmnEventPublicationBehavior.throwEscalationEvent)."""
        code = element.escalation_code
        catcher = self._find_catcher(key, BpmnEventType.ESCALATION, code)
        esc_value = {
            "escalationCode": code or "",
            "throwElementId": element.id,
            "catchElementId": catcher[2].id if catcher else "",
            "processInstanceKey": value.get("processInstanceKey", -1),
            "processDefinitionKey": value.get("processDefinitionKey", -1),
            "bpmnProcessId": value.get("bpmnProcessId", ""),
        }
        writers.append_event(
            self.state.next_key(), ValueType.ESCALATION,
            EscalationIntent.ESCALATED if catcher else EscalationIntent.NOT_ESCALATED,
            esc_value,
        )
        if catcher is None:
            return True  # uncaught escalations are not errors; continue
        self._execute_catch(catcher, writers)
        return not catcher[2].interrupting

    def route_trigger(self, host_key: int, target_element_id: str, writers: Writers) -> bool:
        """Route a fired event subscription (timer, message, signal) hosted on
        ``host_key`` toward its target: the waiting catch element itself, an
        event-based gateway, a boundary event, or an event sub-process start.
        Returns False when the host instance is gone."""
        instance = self.state.element_instances.get(host_key)
        if instance is None:
            return False
        pi_value = instance["value"]
        exe = self.state.processes.executable(pi_value["processDefinitionKey"])
        host_element = exe.element(pi_value["elementId"])
        if target_element_id == pi_value["elementId"]:
            writers.append_command(
                host_key, ValueType.PROCESS_INSTANCE, PI.COMPLETE_ELEMENT, {}
            )
            return True
        if host_element.element_type == BpmnElementType.EVENT_BASED_GATEWAY:
            writers.append_command(
                host_key, ValueType.PROCESS_INSTANCE, PI.COMPLETE_ELEMENT,
                {"triggeredElementId": target_element_id},
            )
            return True
        target = exe.element(target_element_id)
        if (
            target.element_type == BpmnElementType.START_EVENT
            and target.parent_idx >= 0
            and exe.elements[target.parent_idx].element_type == BpmnElementType.EVENT_SUB_PROCESS
        ):
            esp = exe.elements[target.parent_idx]
            self._execute_catch(("esp", exe, esp, host_key, pi_value), writers)
            return True
        # boundary event on the host activity
        self._execute_catch(("boundary", exe, target, host_key, pi_value), writers)
        return True

    def _apply_input_mappings(self, key: int, value: dict,
                              element, writers: Writers,
                              context_key: int) -> bool:
        """Evaluate zeebe:input mappings against the given scope context and
        write them as locals on the element instance. False = IO_MAPPING_ERROR
        incident raised (element stays in its current state). Shared by the
        sequential activate path and the kernel materializer (byte parity by
        construction)."""
        context = self.state.variables.collect(context_key)
        try:
            for expr, target in element.inputs:
                result = expr.evaluate(context, self.clock_millis)
                self._write_variable(writers, key, value, target, result)
        except FeelEvalError as exc:
            self._raise_incident(writers, key, value, ErrorType.IO_MAPPING_ERROR, str(exc))
            return False
        return True

    def _apply_output_mappings(self, key: int, value: dict,
                               element, writers: Writers) -> bool:
        """Evaluate zeebe:output mappings against the element scope and write
        the targets to the flow scope. False = IO_MAPPING_ERROR incident
        raised (element stays COMPLETING). Shared with the kernel
        materializer."""
        context = self.state.variables.collect(key)
        try:
            for expr, target in element.outputs:
                result = expr.evaluate(context, self.clock_millis)
                self._write_variable(
                    writers, value.get("flowScopeKey", -1), value, target, result
                )
        except FeelEvalError as exc:
            self._raise_incident(writers, key, value, ErrorType.IO_MAPPING_ERROR, str(exc))
            return False
        return True

    # -------------------------------------------------------------- completion

    def _complete(
        self, key: int, value: dict, exe: ExecutableProcess,
        element: ExecutableElement, writers: Writers,
    ) -> None:
        is_mi_body = (
            element.multi_instance is not None
            and value.get("bpmnElementType") == BpmnElementType.MULTI_INSTANCE_BODY.name
        )
        is_mi_inner = element.multi_instance is not None and not is_mi_body
        triggered_element_id = value.get("triggeredElementId")
        value = _pi_value(value, element)
        instance = self.state.element_instances.get(key)
        if instance is None or instance["state"] != EI_COMPLETING:
            writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_COMPLETING, value)
        # else: retrying a stalled completing transition after incident resolution

        # output mappings evaluate against the element scope, write to parent.
        # With multi-instance they apply on the body (which sees the output
        # collection), not on each inner instance (reference docs).
        if element.outputs and not is_mi_inner:
            if not self._apply_output_mappings(key, value, element, writers):
                return

        # boundary/catch subscriptions close when the element leaves ACTIVATED
        self._close_subscriptions(key, value, writers)

        if is_mi_inner:
            if not self._collect_mi_output(key, value, element, writers):
                return  # incident raised; stays COMPLETING, resolve retries
            # a sequential loop re-reads the input collection to find the next
            # item; validate it NOW, while this inner is still COMPLETING, so a
            # bad collection raises a retryable incident instead of stalling
            # the ACTIVATED body after COMPLETED is written
            mi = element.multi_instance
            if mi.is_sequential:
                body_key = value.get("flowScopeKey", -1)
                body = self.state.element_instances.get(body_key)
                if body is not None and body["state"] in (EI_ACTIVATED, EI_ACTIVATING):
                    context = self.state.variables.collect(body_key)
                    try:
                        items = mi.input_collection.evaluate(context, self.clock_millis)
                    except FeelEvalError as exc:
                        self._raise_incident(
                            writers, key, value, ErrorType.EXTRACT_VALUE_ERROR, str(exc)
                        )
                        return
                    if not isinstance(items, list):
                        self._raise_incident(
                            writers, key, value, ErrorType.EXTRACT_VALUE_ERROR,
                            f"Expected the input collection of '{element.id}' to be an "
                            f"array, but it evaluated to {items!r}",
                        )
                        return
            writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_COMPLETED, value)
            self._on_mi_inner_completed(key, value, exe, element, writers)
            return

        if is_mi_body and element.multi_instance.output_collection:
            # propagate the collected output to the body's outer scope before
            # the body scope disappears with ELEMENT_COMPLETED
            collection = self.state.variables.get_local(
                key, element.multi_instance.output_collection
            )
            if collection is not None:
                self._write_variable(
                    writers, value.get("flowScopeKey", -1), value,
                    element.multi_instance.output_collection, collection,
                )

        # child process locals must be captured before COMPLETED removes the
        # scope — a call activity's output mappings read them (reference:
        # CallActivityProcessor.onChildCompleted)
        child_locals: dict | None = None
        if element.element_type == BpmnElementType.PROCESS:
            child_locals = self.state.variables.locals_of(key)

        if element.element_type == BpmnElementType.EXCLUSIVE_GATEWAY and (
            len(element.outgoing) > 1
            or any(exe.flows[f].condition is not None for f in element.outgoing)
        ):
            taken = self._choose_exclusive_flow(key, value, exe, element, writers)
            if taken is None:
                return  # incident raised; stays in COMPLETING
            writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_COMPLETED, value)
            self._take_flow(writers, exe, taken, value)
        elif element.element_type == BpmnElementType.INCLUSIVE_GATEWAY and (
            len(element.outgoing) > 1
            or any(exe.flows[f].condition is not None for f in element.outgoing)
        ):
            # fork: take EVERY flow whose condition holds; default only when
            # none hold (reference: InclusiveGatewayProcessor.findSequenceFlowsToTake)
            taken_flows = self._choose_inclusive_flows(key, value, exe, element, writers)
            if taken_flows is None:
                return  # incident raised; stays in COMPLETING
            writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_COMPLETED, value)
            for flow in taken_flows:
                self._take_flow(writers, exe, flow, value)
        elif (
            element.element_type == BpmnElementType.INTERMEDIATE_THROW_EVENT
            and element.event_type == BpmnEventType.LINK
            and element.link_target_idx >= 0
        ):
            # link throw: the token jumps to the same-scope catch link — no
            # sequence flow is taken and the scope stays alive through the
            # pending catch activation (reference:
            # IntermediateThrowEventProcessor.java:201-208 link routing)
            writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_COMPLETED, value)
            target = exe.elements[element.link_target_idx]
            self._write_activate(writers, exe, target,
                                 value.get("flowScopeKey", -1), value)
            return
        elif element.element_type == BpmnElementType.EVENT_BASED_GATEWAY and triggered_element_id:
            # per the BPMN spec the sequence flow to the triggered event is NOT
            # taken — the event activates directly (reference:
            # EventBasedGatewayProcessor.onComplete :65-76)
            writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_COMPLETED, value)
            target = exe.elements[exe.by_id[triggered_element_id]]
            self._write_activate(
                writers, exe, target, value.get("flowScopeKey", -1), value,
                extra={"eventTriggered": True},
            )
        else:
            writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_COMPLETED, value)
            for fidx in element.outgoing:
                self._take_flow(writers, exe, exe.flows[fidx], value)
            if (
                element.element_type == BpmnElementType.END_EVENT
                and element.event_type == BpmnEventType.TERMINATE
            ):
                # terminate every other active element instance in the flow
                # scope; the scope completes when the last one is gone
                # (reference: EndEventProcessor TerminateEndEventBehavior)
                scope_key = value.get("flowScopeKey", -1)
                for child_key in self.state.element_instances.children_keys(scope_key):
                    if child_key != key:
                        writers.append_command(
                            child_key, ValueType.PROCESS_INSTANCE, PI.TERMINATE_ELEMENT, {}
                        )

        if element.element_type == BpmnElementType.PROCESS:
            self._on_process_completed(key, value, child_locals or {}, writers)
            return
        if not element.outgoing:
            self._check_scope_completion(value.get("flowScopeKey", -1), writers)

    def _choose_exclusive_flow(self, key, value, exe, element, writers):
        context = self.state.variables.collect(key)
        for fidx in element.outgoing:
            if fidx == element.default_flow_idx:
                continue
            flow = exe.flows[fidx]
            if flow.condition is None:
                continue
            try:
                result = flow.condition.evaluate(context, self.clock_millis)
            except FeelEvalError as exc:
                self._raise_incident(writers, key, value, ErrorType.EXTRACT_VALUE_ERROR, str(exc))
                return None
            if result is True:
                return flow
        if element.default_flow_idx >= 0:
            return exe.flows[element.default_flow_idx]
        self._raise_incident(
            writers, key, value, ErrorType.CONDITION_ERROR,
            f"Expected at least one condition to evaluate to true, or to have a default flow "
            f"at gateway '{element.id}'",
        )
        return None

    def _choose_inclusive_flows(self, key, value, exe, element, writers):
        """All outgoing flows with true conditions; the default flow only when
        no condition holds (reference: InclusiveGatewayProcessor)."""
        context = self.state.variables.collect(key)
        taken = []
        for fidx in element.outgoing:
            if fidx == element.default_flow_idx:
                continue
            flow = exe.flows[fidx]
            if flow.condition is None:
                # unconditional non-default flow on a single-outgoing gateway
                taken.append(flow)
                continue
            try:
                result = flow.condition.evaluate(context, self.clock_millis)
            except FeelEvalError as exc:
                self._raise_incident(writers, key, value, ErrorType.EXTRACT_VALUE_ERROR, str(exc))
                return None
            if result is True:
                taken.append(flow)
        if taken:
            return taken
        if element.default_flow_idx >= 0:
            return [exe.flows[element.default_flow_idx]]
        self._raise_incident(
            writers, key, value, ErrorType.CONDITION_ERROR,
            f"Expected at least one condition to evaluate to true, or to have a default flow "
            f"at gateway '{element.id}'",
        )
        return None

    def _take_flow(self, writers: Writers, exe: ExecutableProcess, flow, scope_value: dict) -> None:
        # the scope containing the flow is the completing element's flow scope
        scope_key = scope_value.get("flowScopeKey", -1)
        flow_value = {
            "bpmnProcessId": scope_value["bpmnProcessId"],
            "version": scope_value["version"],
            "processDefinitionKey": scope_value["processDefinitionKey"],
            "processInstanceKey": scope_value["processInstanceKey"],
            "elementId": flow.id,
            "flowScopeKey": scope_key,
            "bpmnElementType": BpmnElementType.SEQUENCE_FLOW.name,
            "bpmnEventType": BpmnEventType.UNSPECIFIED.name,
        }
        flow_key = self.state.next_key()
        writers.append_event(flow_key, ValueType.PROCESS_INSTANCE, PI.SEQUENCE_FLOW_TAKEN, flow_value)

        target = exe.elements[flow.target_idx]
        if target.element_type == BpmnElementType.PARALLEL_GATEWAY:
            incoming = [f.idx for f in exe.flows if f.target_idx == target.idx]
            if self.state.element_instances.taken_flows_satisfy_join(scope_key, target.idx, incoming):
                self._write_activate(writers, exe, target, scope_key, scope_value)
        else:
            self._write_activate(writers, exe, target, scope_key, scope_value)

    def _write_activate(
        self, writers: Writers, exe: ExecutableProcess, element: ExecutableElement,
        scope_key: int, value: dict, extra: dict | None = None,
    ) -> None:
        new_key = self.state.next_key()
        # an element with loop characteristics is entered through its
        # multi-instance body wrapper (reference: MULTI_INSTANCE_BODY element)
        element_type_name = (
            BpmnElementType.MULTI_INSTANCE_BODY.name
            if element.multi_instance is not None
            else element.element_type.name
        )
        child_value = {
            "bpmnProcessId": value["bpmnProcessId"],
            "version": value["version"],
            "processDefinitionKey": value["processDefinitionKey"],
            "processInstanceKey": value["processInstanceKey"],
            "elementId": element.id,
            "flowScopeKey": scope_key,
            "bpmnElementType": element_type_name,
            "bpmnEventType": element.event_type.name,
        }
        if "tenantId" in value:
            child_value["tenantId"] = value["tenantId"]
        if extra:
            child_value.update(extra)
        writers.append_command(new_key, ValueType.PROCESS_INSTANCE, PI.ACTIVATE_ELEMENT, child_value)

    # -------------------------------------------------------- scope completion

    def _check_scope_completion(self, scope_key: int, writers: Writers) -> None:
        if scope_key < 0:
            return
        scope = self.state.element_instances.get(scope_key)
        if scope is None:
            return
        if scope["state"] not in (EI_ACTIVATED, EI_ACTIVATING):
            return
        if scope["activeChildren"] == 0 and scope["activeFlows"] == 0:
            writers.append_command(
                scope_key, ValueType.PROCESS_INSTANCE, PI.COMPLETE_ELEMENT, {}
            )

    def _on_process_completed(self, key: int, value: dict, child_locals: dict,
                              writers: Writers) -> None:
        """A completed child of a call activity propagates its root variables
        and completes the call activity (reference: CallActivityProcessor).

        With output mappings, child variables land in the call activity's
        local scope so the mappings can read them; without, the reference
        default (propagateAllChildVariables=true) merges them upward like job
        completion variables."""
        parent_ei_key = value.get("parentElementInstanceKey", -1)
        if parent_ei_key < 0:
            if self.on_root_completed is not None:
                self.on_root_completed(key, value, child_locals, writers)
            return
        parent = self.state.element_instances.get(parent_ei_key)
        if parent is None or parent["state"] not in (EI_ACTIVATED, EI_ACTIVATING):
            return  # parent terminated/interrupted meanwhile
        parent_value = parent["value"]
        call_element = self._executable(parent_value).element(parent_value["elementId"])
        parent_pi_key = parent_value.get("processInstanceKey", -1)
        for name, val in child_locals.items():
            if call_element.outputs or call_element.multi_instance is not None:
                # with output mappings the mappings read the call activity's
                # local scope; under multi-instance, parallel siblings must not
                # overwrite each other via the shared parent scope — results
                # land locally and flow out through outputElement collection
                # (same invariant as job-completion merge_local)
                target_scope = parent_ei_key
            else:
                target_scope = (
                    self.state.variables.find_scope_with(parent_ei_key, name)
                    or parent_pi_key
                )
            self._write_variable(writers, target_scope, parent_value, name, val)
        writers.append_command(
            parent_ei_key, ValueType.PROCESS_INSTANCE, PI.COMPLETE_ELEMENT, {}
        )

    # set by the Engine: root-instance completion/termination hooks
    # (await-result responses + parked-request cleanup)
    on_root_completed = None
    on_root_terminated = None

    # -------------------------------------------------------------- terminate

    def _terminate(
        self, key: int, value: dict, exe: ExecutableProcess,
        element: ExecutableElement, writers: Writers,
    ) -> None:
        value = _pi_value(value, element)
        instance = self.state.element_instances.get(key)
        writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_TERMINATING, value)

        user_task_key = self.state.user_tasks.key_for_element(key)
        if user_task_key is not None:
            task = self.state.user_tasks.get(user_task_key)
            writers.append_event(user_task_key, ValueType.USER_TASK,
                                 UserTaskIntent.CANCELING, task)
            writers.append_event(user_task_key, ValueType.USER_TASK,
                                 UserTaskIntent.CANCELED, task)
        job_key = instance.get("jobKey", -1)
        if job_key >= 0:
            job = self.state.jobs.get(job_key)
            if job is not None:
                writers.append_event(job_key, ValueType.JOB, JobIntent.CANCELED, job)
        self._close_subscriptions(key, value, writers)

        # a call activity first terminates its called child instance; the child
        # root's termination resumes this element (see _finish_terminate)
        child_pi_key = instance.get("calledChildInstanceKey", -1)
        if child_pi_key >= 0 and self.state.element_instances.get(child_pi_key) is not None:
            writers.append_command(
                child_pi_key, ValueType.PROCESS_INSTANCE, PI.TERMINATE_ELEMENT, {}
            )
            return

        children = self.state.element_instances.children_keys(key)
        if children:
            if len(children) > PI_BATCH_CHUNK:
                # chunked termination of huge scopes (reference:
                # TerminateProcessInstanceBatchProcessor)
                from zeebe_tpu_torch.protocol.intent import ProcessInstanceBatchIntent

                writers.append_command(
                    self.state.next_key(), ValueType.PROCESS_INSTANCE_BATCH,
                    ProcessInstanceBatchIntent.TERMINATE,
                    {
                        "processInstanceKey": value.get("processInstanceKey", -1),
                        "batchElementInstanceKey": key,
                    },
                )
                return
            for child_key in children:
                writers.append_command(
                    child_key, ValueType.PROCESS_INSTANCE, PI.TERMINATE_ELEMENT, {}
                )
            # stay TERMINATING; the last terminated child finishes this scope
            return

        self._finish_terminate(key, value, writers)

    def _finish_terminate(self, key: int, value: dict, writers: Writers) -> None:
        scope_key = value.get("flowScopeKey", -1)
        writers.append_event(key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_TERMINATED, value)
        if scope_key >= 0:
            scope = self.state.element_instances.get(scope_key)
            if scope is not None and scope["state"] == EI_TERMINATING:
                if self.state.element_instances.get(scope_key)["activeChildren"] == 0:
                    scope_value = scope["value"]
                    exe = self._executable(scope_value)
                    self._finish_terminate(scope_key, _pi_value(scope_value, exe.element(scope_value["elementId"])), writers)
            elif scope is not None:
                # a terminate end event removed its siblings while the scope
                # stays active — the last terminated child completes the scope
                self._check_scope_completion(scope_key, writers)
            return
        # a terminated root answers/cleans parked await-result requests
        if (value.get("bpmnElementType") == BpmnElementType.PROCESS.name
                and value.get("parentElementInstanceKey", -1) < 0
                and self.on_root_terminated is not None):
            self.on_root_terminated(key, value, writers)
        # a terminated child-process root resumes its call activity's terminate
        parent_ei_key = value.get("parentElementInstanceKey", -1)
        if parent_ei_key >= 0:
            parent = self.state.element_instances.get(parent_ei_key)
            if parent is not None and parent["state"] == EI_TERMINATING:
                parent_value = parent["value"]
                exe = self._executable(parent_value)
                self._finish_terminate(
                    parent_ei_key,
                    _pi_value(parent_value, exe.element(parent_value["elementId"])),
                    writers,
                )

    # -------------------------------------------------------------- incidents

    def _resolve_form(self, key: int, value: dict, element, writers) -> int | None:
        """Latest deployed form for the element's formId in the instance's
        tenant; missing → FORM_NOT_FOUND incident and the element stays
        ACTIVATING so incident resolution retries (reference:
        BpmnUserTaskBehavior form resolution)."""
        tenant = value.get("tenantId", DEFAULT_TENANT)
        form = self.state.forms.get_latest_by_id(element.form_id, tenant)
        if form is None:
            self._raise_incident(
                writers, key, value, ErrorType.FORM_NOT_FOUND,
                f"Expected to find a form with id '{element.form_id}', "
                "but no form with this id is found",
            )
            return None
        return form["formKey"]

    def _raise_incident(
        self, writers: Writers, element_key: int, value: dict,
        error_type: ErrorType, message: str,
    ) -> None:
        incident_key = self.state.next_key()
        writers.append_event(
            incident_key, ValueType.INCIDENT, IncidentIntent.CREATED,
            {
                "errorType": error_type.name,
                "errorMessage": message,
                "bpmnProcessId": value.get("bpmnProcessId", ""),
                "processDefinitionKey": value.get("processDefinitionKey", -1),
                "processInstanceKey": value.get("processInstanceKey", -1),
                "elementId": value.get("elementId", ""),
                "elementInstanceKey": element_key,
                "jobKey": -1,
                "variableScopeKey": element_key,
            },
        )

    # -------------------------------------------------------------- variables

    def _write_variable(
        self, writers: Writers, scope_key: int, pi_value: dict, name: str, result: Any
    ) -> None:
        from zeebe_tpu_torch.feel.temporal import normalize_value

        result = normalize_value(result)
        exists = self.state.variables.has_local(scope_key, name)
        var_key = self.state.next_key()
        writers.append_event(
            var_key, ValueType.VARIABLE,
            VariableIntent.UPDATED if exists else VariableIntent.CREATED,
            {
                "name": name,
                "value": result,
                "scopeKey": scope_key,
                "processInstanceKey": pi_value.get("processInstanceKey", -1),
                "processDefinitionKey": pi_value.get("processDefinitionKey", -1),
                "bpmnProcessId": pi_value.get("bpmnProcessId", ""),
            },
        )


def _eval_date_millis(expr, context, clock_millis) -> int:
    """Evaluate a timer timeDate expression → absolute epoch millis.
    Accepts FEEL date-and-time / date values, ISO-8601 strings, or raw
    epoch millis (reference: timer timeDate is evaluated via FEEL to a
    zoned date-time)."""
    from zeebe_tpu_torch.feel.temporal import (
        FeelDate,
        FeelDateTime,
        parse_date_time,
    )

    raw = expr.evaluate(context, clock_millis)
    if isinstance(raw, FeelDateTime):
        return raw.epoch_millis
    if isinstance(raw, FeelDate):
        return parse_date_time(str(raw)).epoch_millis
    if isinstance(raw, (int, float)) and not isinstance(raw, bool):
        return int(raw)
    if isinstance(raw, str):
        return parse_date_time(raw).epoch_millis
    raise ValueError(f"timer date evaluated to {type(raw).__name__}")


def _pi_value(value: dict, element: ExecutableElement) -> dict:
    """Canonical PROCESS_INSTANCE record value (camelCase, reference shape)."""
    # the body wrapper of a multi-instance element keeps its own element type
    mi_body = value.get("bpmnElementType") == BpmnElementType.MULTI_INSTANCE_BODY.name
    out = {
        "bpmnProcessId": value["bpmnProcessId"],
        "version": value["version"],
        "processDefinitionKey": value["processDefinitionKey"],
        "processInstanceKey": value["processInstanceKey"],
        "elementId": element.id,
        "flowScopeKey": value.get("flowScopeKey", -1),
        "bpmnElementType": (
            BpmnElementType.MULTI_INSTANCE_BODY.name if mi_body else element.element_type.name
        ),
        "bpmnEventType": element.event_type.name,
        "parentProcessInstanceKey": value.get("parentProcessInstanceKey", -1),
        "parentElementInstanceKey": value.get("parentElementInstanceKey", -1),
    }
    if "tenantId" in value:
        out["tenantId"] = value["tenantId"]
    if "loopCounter" in value:
        out["loopCounter"] = value["loopCounter"]
    if value.get("directActivation"):
        # modification-activated: the applier must not consume a flow token
        out["directActivation"] = True
    return out
