"""BPMN process model + fluent builder.

Reference: bpmn-model/src/main/java/io/camunda/zeebe/model/bpmn/Bpmn.java and
builder/* — the fluent builder API used by every engine test
(``Bpmn.createExecutableProcess("p").startEvent().serviceTask(...)…``), plus the
zeebe extension attributes (taskDefinition, ioMapping, taskHeaders).

This is the *model* layer: an id-addressed graph of elements and sequence
flows with raw (unparsed) expression strings. Deploy-time transformation and
validation into an ExecutableProcess live in executable.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from zeebe_tpu_torch.protocol.enums import BpmnElementType, BpmnEventType


@dataclasses.dataclass(slots=True)
class Mapping:
    """One zeebe:input/zeebe:output mapping: source expression → target path."""

    source: str
    target: str


@dataclasses.dataclass(slots=True)
class TimerDefinition:
    """Raw timer definition; exactly one of the fields is set."""

    duration: str | None = None  # ISO-8601 duration or =expr
    cycle: str | None = None  # R<n>/<duration>
    date: str | None = None  # ISO-8601 datetime or =expr


@dataclasses.dataclass(slots=True)
class MessageDefinition:
    name: str
    correlation_key: str | None = None  # FEEL expr (=...) required for catch


@dataclasses.dataclass(slots=True)
class MultiInstanceDefinition:
    input_collection: str = ""
    input_element: str | None = None
    output_collection: str | None = None
    output_element: str | None = None
    is_sequential: bool = False


@dataclasses.dataclass(slots=True)
class ProcessElement:
    id: str
    element_type: BpmnElementType
    name: str = ""
    event_type: BpmnEventType = BpmnEventType.NONE
    # job-worker tasks (zeebe:taskDefinition)
    job_type: str | None = None
    job_retries: str = "3"
    task_headers: dict[str, str] = dataclasses.field(default_factory=dict)
    # gateways
    default_flow_id: str | None = None
    # events
    timer: TimerDefinition | None = None
    message: MessageDefinition | None = None
    error_code: str | None = None
    signal_name: str | None = None
    escalation_code: str | None = None
    interrupting: bool = True
    attached_to_id: str | None = None  # boundary events
    # io mappings (zeebe:ioMapping)
    inputs: list[Mapping] = dataclasses.field(default_factory=list)
    outputs: list[Mapping] = dataclasses.field(default_factory=list)
    # containers
    parent_id: str | None = None  # enclosing sub-process / process
    # multi-instance
    multi_instance: MultiInstanceDefinition | None = None
    # call activity
    called_process_id: str | None = None
    # script task with expression (non-job-worker flavor)
    script_expression: str | None = None
    script_result_variable: str | None = None
    # business rule task with called decision
    called_decision_id: str | None = None
    native_user_task: bool = False
    user_task_assignee: str | None = None
    user_task_candidate_groups: str | None = None
    decision_result_variable: str | None = None
    # linked Camunda form (zeebe:formDefinition formId)
    form_id: str | None = None
    # link events (linkEventDefinition name; throw routes to same-scope catch)
    link_name: str | None = None


@dataclasses.dataclass(slots=True)
class SequenceFlow:
    id: str
    source_id: str
    target_id: str
    condition: str | None = None  # FEEL expression body (no '=' marker)


@dataclasses.dataclass(slots=True)
class ProcessModel:
    """One <bpmn:process> — the unit of deployment (with siblings in a file)."""

    process_id: str
    name: str = ""
    elements: dict[str, ProcessElement] = dataclasses.field(default_factory=dict)
    flows: dict[str, SequenceFlow] = dataclasses.field(default_factory=dict)

    def outgoing(self, element_id: str) -> list[SequenceFlow]:
        return [f for f in self.flows.values() if f.source_id == element_id]

    def incoming(self, element_id: str) -> list[SequenceFlow]:
        return [f for f in self.flows.values() if f.target_id == element_id]


class BpmnModelError(Exception):
    pass


class ProcessBuilder:
    """Fluent builder. Each element-adding call connects the cursor element to
    the new one with an auto-named sequence flow; ``condition_expression``
    annotates the most recently created flow; ``move_to_element`` repositions
    the cursor for branching (reference: AbstractFlowNodeBuilder.moveToNode)."""

    def __init__(self, process_id: str, name: str = "") -> None:
        self.model = ProcessModel(process_id=process_id, name=name or process_id)
        self._cursor: str | None = None
        self._flow_count = 0
        self._next_flow_id: str | None = None
        self._next_condition: str | None = None
        self._next_default: bool = False
        self._scope_stack: list[str] = []  # enclosing sub-process ids

    # -- plumbing ------------------------------------------------------------

    def _add_element(self, element: ProcessElement, connect: bool = True) -> "ProcessBuilder":
        if element.id in self.model.elements:
            raise BpmnModelError(f"duplicate element id {element.id!r}")
        if self._scope_stack:
            element.parent_id = self._scope_stack[-1]
        self.model.elements[element.id] = element
        if connect and self._cursor is not None:
            self._connect(self._cursor, element.id)
        self._cursor = element.id
        return self

    def _connect(self, source: str, target: str) -> None:
        flow_id = self._next_flow_id
        self._next_flow_id = None
        if flow_id is None:
            self._flow_count += 1
            flow_id = f"flow_{self._flow_count}"
        if flow_id in self.model.flows:
            raise BpmnModelError(f"duplicate flow id {flow_id!r}")
        flow = SequenceFlow(flow_id, source, target, condition=self._next_condition)
        self._next_condition = None
        self.model.flows[flow_id] = flow
        if self._next_default:
            self.model.elements[source].default_flow_id = flow_id
            self._next_default = False

    def _auto_id(self, prefix: str) -> str:
        n = 1
        while f"{prefix}_{n}" in self.model.elements:
            n += 1
        return f"{prefix}_{n}"

    # -- events --------------------------------------------------------------

    def start_event(self, element_id: str | None = None, name: str = "") -> "ProcessBuilder":
        return self._add_element(
            ProcessElement(element_id or self._auto_id("start"), BpmnElementType.START_EVENT, name)
        )

    def timer_start_event(
        self, element_id: str, cycle: str | None = None, date: str | None = None,
        duration: str | None = None, interrupting: bool = True,
    ) -> "ProcessBuilder":
        el = ProcessElement(
            element_id, BpmnElementType.START_EVENT, event_type=BpmnEventType.TIMER,
            interrupting=interrupting,
        )
        el.timer = TimerDefinition(cycle=cycle, date=date, duration=duration)
        return self._add_element(el)

    def message_start_event(
        self, element_id: str, message_name: str, correlation_key: str | None = None,
        interrupting: bool = True,
    ) -> "ProcessBuilder":
        """Process-level message start events have no correlation key; event
        sub-process message starts require one (reference validators)."""
        el = ProcessElement(
            element_id, BpmnElementType.START_EVENT, event_type=BpmnEventType.MESSAGE,
            interrupting=interrupting,
        )
        el.message = MessageDefinition(name=message_name, correlation_key=correlation_key)
        return self._add_element(el)

    def end_event(self, element_id: str | None = None, name: str = "") -> "ProcessBuilder":
        return self._add_element(
            ProcessElement(element_id or self._auto_id("end"), BpmnElementType.END_EVENT, name)
        )

    def signal_start_event(self, element_id: str, signal_name: str) -> "ProcessBuilder":
        el = ProcessElement(
            element_id, BpmnElementType.START_EVENT, event_type=BpmnEventType.SIGNAL,
            signal_name=signal_name,
        )
        return self._add_element(el)

    def error_start_event(self, element_id: str, error_code: str | None = None) -> "ProcessBuilder":
        """Typed start event for an error event sub-process (always interrupting)."""
        el = ProcessElement(
            element_id, BpmnElementType.START_EVENT, event_type=BpmnEventType.ERROR,
            error_code=error_code,
        )
        return self._add_element(el)

    def escalation_start_event(
        self, element_id: str, escalation_code: str | None = None, interrupting: bool = True
    ) -> "ProcessBuilder":
        el = ProcessElement(
            element_id, BpmnElementType.START_EVENT, event_type=BpmnEventType.ESCALATION,
            escalation_code=escalation_code, interrupting=interrupting,
        )
        return self._add_element(el)

    def interrupting(self, flag: bool) -> "ProcessBuilder":
        """Set the interrupting flag of the element at the cursor (event
        sub-process start events, boundary events)."""
        el_id = self._require_cursor()
        self.model.elements[el_id].interrupting = flag
        return self

    def end_event_terminate(self, element_id: str | None = None) -> "ProcessBuilder":
        """Terminate end event: completes, then terminates every other active
        element instance in its flow scope (reference: EndEventProcessor
        TerminateEndEventBehavior)."""
        return self._add_element(
            ProcessElement(
                element_id or self._auto_id("end"),
                BpmnElementType.END_EVENT,
                event_type=BpmnEventType.TERMINATE,
            )
        )

    def intermediate_catch_timer(
        self, element_id: str, duration: str | None = None, date: str | None = None,
        cycle: str | None = None,
    ) -> "ProcessBuilder":
        el = ProcessElement(
            element_id, BpmnElementType.INTERMEDIATE_CATCH_EVENT, event_type=BpmnEventType.TIMER
        )
        el.timer = TimerDefinition(duration=duration, date=date, cycle=cycle)
        return self._add_element(el)

    def intermediate_catch_message(
        self, element_id: str, message_name: str, correlation_key: str
    ) -> "ProcessBuilder":
        el = ProcessElement(
            element_id, BpmnElementType.INTERMEDIATE_CATCH_EVENT, event_type=BpmnEventType.MESSAGE
        )
        el.message = MessageDefinition(name=message_name, correlation_key=correlation_key)
        return self._add_element(el)

    def boundary_timer(
        self, element_id: str, attached_to: str, duration: str | None = None,
        interrupting: bool = True, date: str | None = None, cycle: str | None = None,
    ) -> "ProcessBuilder":
        el = ProcessElement(
            element_id,
            BpmnElementType.BOUNDARY_EVENT,
            event_type=BpmnEventType.TIMER,
            interrupting=interrupting,
            attached_to_id=attached_to,
        )
        el.timer = TimerDefinition(duration=duration, date=date, cycle=cycle)
        return self._add_element(el, connect=False)

    def boundary_message(
        self, element_id: str, attached_to: str, message_name: str, correlation_key: str,
        interrupting: bool = True,
    ) -> "ProcessBuilder":
        el = ProcessElement(
            element_id,
            BpmnElementType.BOUNDARY_EVENT,
            event_type=BpmnEventType.MESSAGE,
            interrupting=interrupting,
            attached_to_id=attached_to,
        )
        el.message = MessageDefinition(name=message_name, correlation_key=correlation_key)
        return self._add_element(el, connect=False)

    def boundary_error(
        self, element_id: str, attached_to: str, error_code: str
    ) -> "ProcessBuilder":
        el = ProcessElement(
            element_id,
            BpmnElementType.BOUNDARY_EVENT,
            event_type=BpmnEventType.ERROR,
            attached_to_id=attached_to,
            error_code=error_code,
        )
        return self._add_element(el, connect=False)

    def intermediate_throw_event(self, element_id: str | None = None) -> "ProcessBuilder":
        return self._add_element(
            ProcessElement(element_id or self._auto_id("throw"), BpmnElementType.INTERMEDIATE_THROW_EVENT)
        )

    def intermediate_throw_link(self, element_id: str, link_name: str) -> "ProcessBuilder":
        """Link throw: the token jumps to the same-scope catch link with this
        name (reference: builder IntermediateThrowEventBuilder.link)."""
        el = ProcessElement(
            element_id, BpmnElementType.INTERMEDIATE_THROW_EVENT,
            event_type=BpmnEventType.LINK, link_name=link_name,
        )
        return self._add_element(el)

    def intermediate_catch_link(self, element_id: str, link_name: str) -> "ProcessBuilder":
        """Link catch: entered only via a matching link throw — no incoming
        sequence flow; the cursor moves here so the continuation chains on."""
        el = ProcessElement(
            element_id, BpmnElementType.INTERMEDIATE_CATCH_EVENT,
            event_type=BpmnEventType.LINK, link_name=link_name,
        )
        return self._add_element(el, connect=False)

    def boundary_signal(
        self, element_id: str, attached_to: str, signal_name: str, interrupting: bool = True
    ) -> "ProcessBuilder":
        el = ProcessElement(
            element_id,
            BpmnElementType.BOUNDARY_EVENT,
            event_type=BpmnEventType.SIGNAL,
            interrupting=interrupting,
            attached_to_id=attached_to,
            signal_name=signal_name,
        )
        return self._add_element(el, connect=False)

    def boundary_escalation(
        self, element_id: str, attached_to: str, escalation_code: str | None = None,
        interrupting: bool = True,
    ) -> "ProcessBuilder":
        el = ProcessElement(
            element_id,
            BpmnElementType.BOUNDARY_EVENT,
            event_type=BpmnEventType.ESCALATION,
            interrupting=interrupting,
            attached_to_id=attached_to,
            escalation_code=escalation_code,
        )
        return self._add_element(el, connect=False)

    def intermediate_catch_signal(self, element_id: str, signal_name: str) -> "ProcessBuilder":
        el = ProcessElement(
            element_id, BpmnElementType.INTERMEDIATE_CATCH_EVENT,
            event_type=BpmnEventType.SIGNAL, signal_name=signal_name,
        )
        return self._add_element(el)

    def intermediate_throw_escalation(self, element_id: str, escalation_code: str) -> "ProcessBuilder":
        el = ProcessElement(
            element_id, BpmnElementType.INTERMEDIATE_THROW_EVENT,
            event_type=BpmnEventType.ESCALATION, escalation_code=escalation_code,
        )
        return self._add_element(el)

    def intermediate_throw_signal(self, element_id: str, signal_name: str) -> "ProcessBuilder":
        el = ProcessElement(
            element_id, BpmnElementType.INTERMEDIATE_THROW_EVENT,
            event_type=BpmnEventType.SIGNAL, signal_name=signal_name,
        )
        return self._add_element(el)

    def end_event_escalation(self, element_id: str, escalation_code: str) -> "ProcessBuilder":
        el = ProcessElement(
            element_id, BpmnElementType.END_EVENT,
            event_type=BpmnEventType.ESCALATION, escalation_code=escalation_code,
        )
        return self._add_element(el)

    def end_event_signal(self, element_id: str, signal_name: str) -> "ProcessBuilder":
        el = ProcessElement(
            element_id, BpmnElementType.END_EVENT,
            event_type=BpmnEventType.SIGNAL, signal_name=signal_name,
        )
        return self._add_element(el)

    def end_event_error(self, element_id: str, error_code: str) -> "ProcessBuilder":
        el = ProcessElement(
            element_id, BpmnElementType.END_EVENT, event_type=BpmnEventType.ERROR, error_code=error_code
        )
        return self._add_element(el)

    # -- tasks ---------------------------------------------------------------

    def _job_task(
        self, element_id: str | None, etype: BpmnElementType, prefix: str,
        job_type: str, retries: str | int = "3", headers: dict[str, str] | None = None,
    ) -> "ProcessBuilder":
        el = ProcessElement(element_id or self._auto_id(prefix), etype)
        el.job_type = job_type
        el.job_retries = str(retries)
        el.task_headers = dict(headers or {})
        return self._add_element(el)

    def service_task(self, element_id: str | None = None, job_type: str = "", **kw: Any) -> "ProcessBuilder":
        if not job_type:
            raise BpmnModelError("service task requires job_type")
        return self._job_task(element_id, BpmnElementType.SERVICE_TASK, "task", job_type, **kw)

    def send_task(self, element_id: str | None = None, job_type: str = "", **kw: Any) -> "ProcessBuilder":
        if not job_type:
            raise BpmnModelError("send task requires job_type")
        return self._job_task(element_id, BpmnElementType.SEND_TASK, "send", job_type, **kw)

    def user_task(self, element_id: str | None = None, *,
                  native: bool = False, assignee: str | None = None,
                  candidate_groups: str | None = None,
                  form_id: str | None = None) -> "ProcessBuilder":
        """Job-based by default (reference 8.4 default worker contract);
        ``native=True`` uses the zeebe:userTask native lifecycle records;
        ``form_id`` links a deployed Camunda form (zeebe:formDefinition)."""
        el = ProcessElement(element_id or self._auto_id("user"), BpmnElementType.USER_TASK)
        el.form_id = form_id
        if native:
            el.native_user_task = True
            el.user_task_assignee = assignee
            el.user_task_candidate_groups = candidate_groups
        else:
            el.job_type = "io.camunda.zeebe:userTask"
        return self._add_element(el)

    def manual_task(self, element_id: str | None = None) -> "ProcessBuilder":
        return self._add_element(
            ProcessElement(element_id or self._auto_id("manual"), BpmnElementType.MANUAL_TASK)
        )

    def undefined_task(self, element_id: str | None = None) -> "ProcessBuilder":
        return self._add_element(
            ProcessElement(element_id or self._auto_id("task"), BpmnElementType.TASK)
        )

    def script_task(
        self, element_id: str | None = None, *, job_type: str | None = None,
        expression: str | None = None, result_variable: str | None = None, **kw: Any,
    ) -> "ProcessBuilder":
        if job_type:
            return self._job_task(element_id, BpmnElementType.SCRIPT_TASK, "script", job_type, **kw)
        el = ProcessElement(element_id or self._auto_id("script"), BpmnElementType.SCRIPT_TASK)
        el.script_expression = expression
        el.script_result_variable = result_variable
        return self._add_element(el)

    def business_rule_task(
        self, element_id: str | None = None, *, job_type: str | None = None,
        called_decision_id: str | None = None, result_variable: str | None = None, **kw: Any,
    ) -> "ProcessBuilder":
        if job_type:
            return self._job_task(element_id, BpmnElementType.BUSINESS_RULE_TASK, "rule", job_type, **kw)
        el = ProcessElement(element_id or self._auto_id("rule"), BpmnElementType.BUSINESS_RULE_TASK)
        el.called_decision_id = called_decision_id
        el.decision_result_variable = result_variable
        return self._add_element(el)

    def receive_task(self, element_id: str, message_name: str, correlation_key: str) -> "ProcessBuilder":
        el = ProcessElement(element_id, BpmnElementType.RECEIVE_TASK,
                            event_type=BpmnEventType.MESSAGE)
        el.message = MessageDefinition(name=message_name, correlation_key=correlation_key)
        return self._add_element(el)

    def call_activity(self, element_id: str, process_id: str) -> "ProcessBuilder":
        el = ProcessElement(element_id, BpmnElementType.CALL_ACTIVITY)
        el.called_process_id = process_id
        return self._add_element(el)

    # -- containers ----------------------------------------------------------

    def sub_process(self, element_id: str) -> "ProcessBuilder":
        self._add_element(ProcessElement(element_id, BpmnElementType.SUB_PROCESS))
        self._scope_stack.append(element_id)
        self._cursor = None  # next element starts the embedded flow
        return self

    def event_sub_process(self, element_id: str) -> "ProcessBuilder":
        """Event sub-process: no incoming/outgoing flows; starts from its own
        typed start event when that event triggers in the enclosing scope
        (reference: bpmn/container/EventSubProcessProcessor). Close the scope
        with sub_process_done()."""
        self._add_element(
            ProcessElement(element_id, BpmnElementType.EVENT_SUB_PROCESS), connect=False
        )
        self._scope_stack.append(element_id)
        self._cursor = None
        return self

    def sub_process_done(self) -> "ProcessBuilder":
        if not self._scope_stack:
            raise BpmnModelError("sub_process_done without open sub_process")
        scope = self._scope_stack.pop()
        self._cursor = scope
        return self

    # -- gateways ------------------------------------------------------------

    def exclusive_gateway(self, element_id: str | None = None) -> "ProcessBuilder":
        return self._add_element(
            ProcessElement(element_id or self._auto_id("gw"), BpmnElementType.EXCLUSIVE_GATEWAY)
        )

    def parallel_gateway(self, element_id: str | None = None) -> "ProcessBuilder":
        return self._add_element(
            ProcessElement(element_id or self._auto_id("fork"), BpmnElementType.PARALLEL_GATEWAY)
        )

    def inclusive_gateway(self, element_id: str | None = None) -> "ProcessBuilder":
        return self._add_element(
            ProcessElement(element_id or self._auto_id("inc"), BpmnElementType.INCLUSIVE_GATEWAY)
        )

    def event_based_gateway(self, element_id: str | None = None) -> "ProcessBuilder":
        return self._add_element(
            ProcessElement(element_id or self._auto_id("evgw"), BpmnElementType.EVENT_BASED_GATEWAY)
        )

    # -- flow annotations ----------------------------------------------------

    def sequence_flow_id(self, flow_id: str) -> "ProcessBuilder":
        """Name the *next* created flow."""
        self._next_flow_id = flow_id
        return self

    def condition_expression(self, condition: str) -> "ProcessBuilder":
        """Attach a FEEL condition to the *next* created flow (reference
        builder semantics: annotations precede the flow's target element)."""
        self._next_condition = condition
        return self

    def default_flow(self) -> "ProcessBuilder":
        """Mark the *next* created flow as its gateway's default."""
        self._next_default = True
        return self

    # -- io mappings / multi-instance ----------------------------------------

    def zeebe_input(self, source: str, target: str) -> "ProcessBuilder":
        self.model.elements[self._require_cursor()].inputs.append(Mapping(source, target))
        return self

    def zeebe_output(self, source: str, target: str) -> "ProcessBuilder":
        self.model.elements[self._require_cursor()].outputs.append(Mapping(source, target))
        return self

    def multi_instance(
        self, input_collection: str, input_element: str | None = None,
        output_collection: str | None = None, output_element: str | None = None,
        sequential: bool = False,
    ) -> "ProcessBuilder":
        self.model.elements[self._require_cursor()].multi_instance = MultiInstanceDefinition(
            input_collection, input_element, output_collection, output_element, sequential
        )
        return self

    # -- navigation ----------------------------------------------------------

    def move_to_element(self, element_id: str) -> "ProcessBuilder":
        if element_id not in self.model.elements:
            raise BpmnModelError(f"unknown element {element_id!r}")
        self._cursor = element_id
        return self

    def connect_to(self, element_id: str) -> "ProcessBuilder":
        """Add a flow from the cursor to an existing element (joins)."""
        if element_id not in self.model.elements:
            raise BpmnModelError(f"unknown element {element_id!r}")
        self._connect(self._require_cursor(), element_id)
        self._cursor = element_id
        return self

    def _require_cursor(self) -> str:
        if self._cursor is None:
            raise BpmnModelError("no current element")
        return self._cursor

    def done(self) -> ProcessModel:
        if self._scope_stack:
            raise BpmnModelError(f"unclosed sub_process {self._scope_stack[-1]!r}")
        return self.model


class Bpmn:
    """Entry point mirroring the reference's Bpmn facade."""

    @staticmethod
    def create_executable_process(process_id: str, name: str = "") -> ProcessBuilder:
        return ProcessBuilder(process_id, name)
