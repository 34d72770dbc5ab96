"""Deploy-time transformation: ProcessModel → ExecutableProcess.

Reference: engine/src/main/java/io/camunda/zeebe/engine/processing/deployment/
model/transformer/ (27 transformers) and model/element/Executable* (33 classes),
plus the Zeebe-specific validators that reject bad deployments.

An ExecutableProcess is the dense, index-addressed form the engine (and the
device table compiler in zeebe_tpu_torch.ops.tables) executes:
- elements are numbered 0..n-1 (0 is the process itself); all references are
  indices, not ids;
- every expression string is parsed once here (FEEL parse errors reject the
  deployment, reference behavior);
- per-element adjacency (outgoing flow indices, incoming counts) is
  precomputed — the parallel-gateway join count is ``incoming_count``.
"""

from __future__ import annotations

import dataclasses
import hashlib

from zeebe_tpu_torch.feel import Expression, FeelParseError, parse_expression, parse_feel
from zeebe_tpu_torch.models.bpmn.model import (
    BpmnModelError,
    ProcessElement,
    ProcessModel,
)
from zeebe_tpu_torch.protocol.enums import BpmnElementType, BpmnEventType


class ProcessValidationError(BpmnModelError):
    """Deployment-rejecting validation failure; message lists all problems."""


@dataclasses.dataclass(slots=True)
class ExecutableFlow:
    idx: int
    id: str
    source_idx: int
    target_idx: int
    condition: Expression | None = None


@dataclasses.dataclass(slots=True)
class ExecutableElement:
    idx: int
    id: str
    element_type: BpmnElementType
    event_type: BpmnEventType = BpmnEventType.NONE
    parent_idx: int = -1  # flow scope (process or sub-process element index)
    outgoing: list[int] = dataclasses.field(default_factory=list)  # flow idxs
    incoming_count: int = 0
    default_flow_idx: int = -1
    # job-worker task attributes (parsed)
    job_type: Expression | None = None
    job_retries: Expression | None = None
    task_headers: dict[str, str] = dataclasses.field(default_factory=dict)
    # events
    timer_duration: Expression | None = None
    timer_cycle: Expression | None = None
    timer_date: Expression | None = None
    message_name: str | None = None
    correlation_key: Expression | None = None
    error_code: str | None = None
    signal_name: str | None = None
    escalation_code: str | None = None
    interrupting: bool = True
    attached_to_idx: int = -1
    boundary_idxs: list[int] = dataclasses.field(default_factory=list)
    # containers
    child_start_idx: int = -1  # none start event of a sub-process/process scope
    # io mappings: (source expression, target path)
    inputs: list[tuple[Expression, str]] = dataclasses.field(default_factory=list)
    outputs: list[tuple[Expression, str]] = dataclasses.field(default_factory=list)
    # misc
    called_process_id: str | None = None
    called_decision_id: str | None = None
    native_user_task: bool = False
    user_task_assignee: str | None = None
    user_task_candidate_groups: str | None = None
    decision_result_variable: str | None = None
    form_id: str | None = None
    script_expression: Expression | None = None
    script_result_variable: str | None = None
    multi_instance: "ExecutableMultiInstance | None" = None
    # link events: the throw's matching same-scope catch (element idx)
    link_name: str | None = None
    link_target_idx: int = -1


@dataclasses.dataclass(slots=True)
class ExecutableMultiInstance:
    input_collection: Expression
    input_element: str | None
    output_collection: str | None
    output_element: Expression | None
    is_sequential: bool


@dataclasses.dataclass(slots=True)
class ExecutableProcess:
    process_id: str
    elements: list[ExecutableElement]
    flows: list[ExecutableFlow]
    by_id: dict[str, int]
    digest: str  # content hash for deployment dedup (reference: DigestGenerator)

    @property
    def root(self) -> ExecutableElement:
        return self.elements[0]

    def element(self, element_id: str) -> ExecutableElement:
        return self.elements[self.by_id[element_id]]

    def flow(self, flow_id: str) -> ExecutableFlow:
        for f in self.flows:
            if f.id == flow_id:
                return f
        raise KeyError(flow_id)

    def none_start_of(self, scope_idx: int) -> int:
        return self.elements[scope_idx].child_start_idx

    def event_sub_processes_of(self, scope_idx: int) -> list[ExecutableElement]:
        return [
            e
            for e in self.elements
            if e.element_type == BpmnElementType.EVENT_SUB_PROCESS and e.parent_idx == scope_idx
        ]


def _parse(source: str | None, errors: list[str], where: str) -> Expression | None:
    if source is None:
        return None
    try:
        return parse_expression(source)
    except FeelParseError as exc:
        errors.append(f"{where}: {exc}")
        return None


def _parse_condition(source: str, errors: list[str], where: str) -> Expression | None:
    try:
        return parse_feel(source)
    except FeelParseError as exc:
        errors.append(f"{where}: {exc}")
        return None


def transform(model: ProcessModel) -> ExecutableProcess:
    """Validate and lower a ProcessModel. Raises ProcessValidationError with
    every problem found (not just the first — reference validator behavior)."""
    errors: list[str] = []
    if not model.process_id:
        errors.append("process has no id")

    # index assignment: process root = 0, then elements in model order
    elements: list[ExecutableElement] = [
        ExecutableElement(0, model.process_id, BpmnElementType.PROCESS)
    ]
    by_id: dict[str, int] = {model.process_id: 0}
    for el in model.elements.values():
        if el.id in by_id:
            errors.append(f"duplicate element id {el.id!r}")
            continue
        idx = len(elements)
        by_id[el.id] = idx
        elements.append(ExecutableElement(idx, el.id, el.element_type))

    flows: list[ExecutableFlow] = []
    for flow in model.flows.values():
        src = by_id.get(flow.source_id)
        tgt = by_id.get(flow.target_id)
        if src is None or tgt is None:
            errors.append(f"flow {flow.id!r} references unknown element")
            continue
        fidx = len(flows)
        cond = _parse_condition(flow.condition, errors, f"flow {flow.id!r}") if flow.condition else None
        flows.append(ExecutableFlow(fidx, flow.id, src, tgt, cond))
        elements[src].outgoing.append(fidx)
        elements[tgt].incoming_count += 1

    for el in model.elements.values():
        exe = elements[by_id[el.id]]
        _lower_element(el, exe, model, by_id, elements, flows, errors)

    _validate(model, elements, flows, by_id, errors)

    if errors:
        raise ProcessValidationError("; ".join(errors))

    digest = hashlib.sha256(
        repr([(e.id, e.element_type, e.outgoing) for e in elements]).encode()
        + repr([(f.id, f.source_idx, f.target_idx, f.condition and f.condition.source) for f in flows]).encode()
    ).hexdigest()
    return ExecutableProcess(model.process_id, elements, flows, by_id, digest)


def _lower_element(
    el: ProcessElement,
    exe: ExecutableElement,
    model: ProcessModel,
    by_id: dict[str, int],
    elements: list[ExecutableElement],
    flows: list[ExecutableFlow],
    errors: list[str],
) -> None:
    where = f"element {el.id!r}"
    exe.event_type = el.event_type
    exe.interrupting = el.interrupting
    exe.error_code = el.error_code
    exe.signal_name = el.signal_name
    exe.escalation_code = el.escalation_code
    exe.task_headers = dict(el.task_headers)
    exe.called_process_id = el.called_process_id
    exe.called_decision_id = el.called_decision_id
    exe.link_name = el.link_name
    exe.native_user_task = el.native_user_task
    exe.form_id = el.form_id
    exe.user_task_assignee = el.user_task_assignee
    exe.user_task_candidate_groups = el.user_task_candidate_groups
    exe.decision_result_variable = el.decision_result_variable
    exe.script_result_variable = el.script_result_variable
    if el.parent_id is not None:
        parent_idx = by_id.get(el.parent_id)
        if parent_idx is None:
            errors.append(f"{where}: unknown parent scope {el.parent_id!r}")
        else:
            exe.parent_idx = parent_idx
    else:
        exe.parent_idx = 0
    if el.job_type is not None:
        exe.job_type = _parse(el.job_type, errors, where)
        exe.job_retries = _parse(el.job_retries, errors, where)
    if el.script_expression is not None:
        exe.script_expression = _parse(
            el.script_expression if el.script_expression.startswith("=") else "=" + el.script_expression,
            errors, where,
        )
    if el.timer is not None:
        exe.timer_duration = _parse(el.timer.duration, errors, where)
        exe.timer_cycle = _parse(el.timer.cycle, errors, where)
        exe.timer_date = _parse(el.timer.date, errors, where)
    if el.message is not None:
        exe.message_name = el.message.name
        if el.message.correlation_key is not None:
            key = el.message.correlation_key
            exe.correlation_key = _parse(
                key if key.startswith("=") else "=" + key, errors, where
            )
    if el.default_flow_id is not None:
        for f in flows:
            if f.id == el.default_flow_id and f.source_idx == exe.idx:
                exe.default_flow_idx = f.idx
                break
        else:
            errors.append(f"{where}: default flow {el.default_flow_id!r} not an outgoing flow")
    if el.attached_to_id is not None:
        host_idx = by_id.get(el.attached_to_id)
        if host_idx is None:
            errors.append(f"{where}: boundary attached to unknown element {el.attached_to_id!r}")
        else:
            exe.attached_to_idx = host_idx
            elements[host_idx].boundary_idxs.append(exe.idx)
    for m in el.inputs:
        src = _parse(m.source if m.source.startswith("=") else "=" + m.source, errors, where)
        if src is not None:
            exe.inputs.append((src, m.target))
    for m in el.outputs:
        src = _parse(m.source if m.source.startswith("=") else "=" + m.source, errors, where)
        if src is not None:
            exe.outputs.append((src, m.target))
    if el.multi_instance is not None:
        mi = el.multi_instance
        col = mi.input_collection
        col_expr = _parse(col if col.startswith("=") else "=" + col, errors, where)
        out_el_expr = None
        if mi.output_element is not None:
            oe = mi.output_element
            out_el_expr = _parse(oe if oe.startswith("=") else "=" + oe, errors, where)
        if col_expr is not None:
            exe.multi_instance = ExecutableMultiInstance(
                col_expr, mi.input_element, mi.output_collection, out_el_expr, mi.is_sequential
            )


def _validate(
    model: ProcessModel,
    elements: list[ExecutableElement],
    flows: list[ExecutableFlow],
    by_id: dict[str, int],
    errors: list[str],
) -> None:
    # none start events per scope
    scope_starts: dict[int, list[int]] = {}
    for exe in elements[1:]:
        if exe.element_type == BpmnElementType.START_EVENT and exe.event_type == BpmnEventType.NONE:
            scope_starts.setdefault(exe.parent_idx, []).append(exe.idx)
    root_starts = scope_starts.get(0, [])
    has_msg_or_timer_start = any(
        e.element_type == BpmnElementType.START_EVENT
        and e.parent_idx == 0
        and e.event_type in (BpmnEventType.TIMER, BpmnEventType.MESSAGE, BpmnEventType.SIGNAL)
        for e in elements[1:]
    )
    if len(root_starts) == 0 and not has_msg_or_timer_start:
        errors.append("process has no start event")
    if len(root_starts) > 1:
        errors.append("process has multiple none start events")
    if root_starts:
        elements[0].child_start_idx = root_starts[0]
    for exe in elements[1:]:
        if exe.element_type == BpmnElementType.SUB_PROCESS:
            starts = scope_starts.get(exe.idx, [])
            if len(starts) != 1:
                errors.append(f"sub-process {exe.id!r} needs exactly one none start event")
            else:
                exe.child_start_idx = starts[0]
        elif exe.element_type == BpmnElementType.EVENT_SUB_PROCESS:
            # exactly one TYPED start event (reference: EventSubProcess
            # validators — timer/message/error/signal/escalation starts)
            starts = [
                e.idx
                for e in elements[1:]
                if e.element_type == BpmnElementType.START_EVENT and e.parent_idx == exe.idx
            ]
            if len(starts) != 1:
                errors.append(
                    f"event sub-process {exe.id!r} needs exactly one start event"
                )
                continue
            start = elements[starts[0]]
            if start.event_type not in (
                BpmnEventType.TIMER,
                BpmnEventType.MESSAGE,
                BpmnEventType.ERROR,
                BpmnEventType.SIGNAL,
                BpmnEventType.ESCALATION,
            ):
                errors.append(
                    f"event sub-process {exe.id!r} start event must be typed "
                    "(timer/message/error/signal/escalation)"
                )
            if start.event_type == BpmnEventType.ERROR and not start.interrupting:
                errors.append(
                    f"error event sub-process {exe.id!r} must be interrupting"
                )
            if start.event_type == BpmnEventType.MESSAGE and start.correlation_key is None:
                errors.append(
                    f"event sub-process {exe.id!r} message start needs a correlation key"
                )
            if exe.incoming_count > 0 or exe.outgoing:
                errors.append(
                    f"event sub-process {exe.id!r} must not have sequence flows"
                )
            exe.child_start_idx = starts[0]
            exe.event_type = start.event_type
            exe.interrupting = start.interrupting

    # link events: every throw routes to THE same-scope catch with its name
    # (reference: bpmn-model/…/validation/zeebe/LinkEventValidator — catch
    # names unique per scope, each throw has exactly one matching catch;
    # engine/…/bpmn/event/IntermediateThrowEventProcessor.java:201-208)
    catch_links: dict[tuple[int, str], list[int]] = {}
    for exe in elements[1:]:
        if (
            exe.element_type == BpmnElementType.INTERMEDIATE_CATCH_EVENT
            and exe.event_type == BpmnEventType.LINK
        ):
            if not exe.link_name:
                errors.append(f"element {exe.id!r}: link event needs a name")
                continue
            catch_links.setdefault((exe.parent_idx, exe.link_name), []).append(exe.idx)
    for (scope_idx, name), idxs in catch_links.items():
        if len(idxs) > 1:
            errors.append(
                f"multiple catch link events named {name!r} in scope "
                f"{elements[scope_idx].id!r}"
            )
    for exe in elements[1:]:
        if (
            exe.element_type == BpmnElementType.INTERMEDIATE_THROW_EVENT
            and exe.event_type == BpmnEventType.LINK
        ):
            where = f"element {exe.id!r}"
            if not exe.link_name:
                errors.append(f"{where}: link event needs a name")
                continue
            if exe.outgoing:
                errors.append(f"{where}: link throw event cannot have outgoing flows")
            targets = catch_links.get((exe.parent_idx, exe.link_name), [])
            if not targets:
                errors.append(
                    f"{where}: no catch link event named {exe.link_name!r} in its scope"
                )
            else:
                exe.link_target_idx = targets[0]

    for exe in elements[1:]:
        where = f"element {exe.id!r}"
        et = exe.element_type
        if et == BpmnElementType.START_EVENT and exe.incoming_count > 0:
            errors.append(f"{where}: start event cannot have incoming flows")
        if et == BpmnElementType.END_EVENT and exe.outgoing:
            errors.append(f"{where}: end event cannot have outgoing flows")
        if et in (BpmnElementType.SERVICE_TASK, BpmnElementType.SEND_TASK) and exe.job_type is None:
            errors.append(f"{where}: missing zeebe:taskDefinition job type")
        if (
            et in (BpmnElementType.EXCLUSIVE_GATEWAY, BpmnElementType.INCLUSIVE_GATEWAY)
            and len(exe.outgoing) > 1
        ):
            for fidx in exe.outgoing:
                f = flows[fidx]
                if f.condition is None and fidx != exe.default_flow_idx:
                    errors.append(
                        f"{where}: outgoing flow {f.id!r} needs a condition (or default)"
                    )
        if et == BpmnElementType.INCLUSIVE_GATEWAY and exe.incoming_count > 1:
            # fork-only in the reference version (bpmn-model/…/validation/zeebe/
            # InclusiveGatewayValidator.java:41-45)
            errors.append(
                f"{where}: currently the inclusive gateway can only have one incoming sequence flow"
            )
        if et == BpmnElementType.EVENT_BASED_GATEWAY:
            # reference: bpmn-model/…/validation/zeebe/EventBasedGatewayValidator.java:55-65
            if len(exe.outgoing) < 2:
                errors.append(
                    f"{where}: event-based gateway must have at least 2 outgoing sequence flows"
                )
            for fidx in exe.outgoing:
                target = elements[flows[fidx].target_idx]
                if target.element_type != BpmnElementType.INTERMEDIATE_CATCH_EVENT or (
                    target.event_type
                    not in (BpmnEventType.TIMER, BpmnEventType.MESSAGE, BpmnEventType.SIGNAL)
                ):
                    errors.append(
                        f"{where}: event-based gateway must not have an outgoing sequence flow "
                        "to other elements than message/timer/signal intermediate catch events"
                    )
                elif any(
                    elements[f.source_idx].element_type != BpmnElementType.EVENT_BASED_GATEWAY
                    for f in flows
                    if f.target_idx == target.idx
                ):
                    # a triggered catch event activates without its sequence
                    # flow being taken; mixing in normal incoming flows would
                    # make token accounting ambiguous (the engine's applier
                    # derives the no-token-consumed rule from this shape)
                    errors.append(
                        f"{where}: catch event {target.id!r} after an event-based gateway "
                        "must not have other incoming sequence flows"
                    )
        if (
            exe.message_name is not None
            and exe.correlation_key is None
            and et in (
                BpmnElementType.INTERMEDIATE_CATCH_EVENT,
                BpmnElementType.RECEIVE_TASK,
                BpmnElementType.BOUNDARY_EVENT,
            )
        ):
            errors.append(f"{where}: message catch needs a correlation key")
        if et == BpmnElementType.BOUNDARY_EVENT and exe.attached_to_idx < 0:
            errors.append(f"{where}: boundary event not attached")
        if et == BpmnElementType.CALL_ACTIVITY and not exe.called_process_id:
            errors.append(f"{where}: call activity needs a called process id")
        # reachability-lite: non-start, non-boundary elements need an incoming flow
        if (
            exe.incoming_count == 0
            and et not in (
                BpmnElementType.START_EVENT,
                BpmnElementType.BOUNDARY_EVENT,
                BpmnElementType.EVENT_SUB_PROCESS,
            )
            # catch link events are entered via the matching throw, not a flow
            and not (
                et == BpmnElementType.INTERMEDIATE_CATCH_EVENT
                and exe.event_type == BpmnEventType.LINK
            )
        ):
            errors.append(f"{where}: unreachable (no incoming sequence flow)")
