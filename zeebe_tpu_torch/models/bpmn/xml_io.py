"""BPMN 2.0 XML read/write with zeebe extension elements.

Reference: bpmn-model's XML object model (instance/ + impl/, camunda-xml-model
based) and the zeebe extension namespace (zeebe:taskDefinition, zeebe:ioMapping,
zeebe:taskHeaders, zeebe:calledElement, zeebe:subscription, …). This module maps
the XML to/from the ProcessModel dataclasses in model.py — deliberately schema-
lite: unknown elements are ignored on read (diagram interchange etc.), and the
writer emits only what the engine executes.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Iterable

from zeebe_tpu_torch.models.bpmn.model import (
    BpmnModelError,
    MessageDefinition,
    Mapping,
    MultiInstanceDefinition,
    ProcessElement,
    ProcessModel,
    SequenceFlow,
    TimerDefinition,
)
from zeebe_tpu_torch.protocol.enums import BpmnElementType, BpmnEventType

BPMN_NS = "http://www.omg.org/spec/BPMN/20100524/MODEL"
ZEEBE_NS = "http://camunda.org/schema/zeebe/1.0"

_B = f"{{{BPMN_NS}}}"
_Z = f"{{{ZEEBE_NS}}}"

_TAG_TO_TYPE = {
    "startEvent": BpmnElementType.START_EVENT,
    "endEvent": BpmnElementType.END_EVENT,
    "serviceTask": BpmnElementType.SERVICE_TASK,
    "sendTask": BpmnElementType.SEND_TASK,
    "userTask": BpmnElementType.USER_TASK,
    "manualTask": BpmnElementType.MANUAL_TASK,
    "task": BpmnElementType.TASK,
    "scriptTask": BpmnElementType.SCRIPT_TASK,
    "businessRuleTask": BpmnElementType.BUSINESS_RULE_TASK,
    "receiveTask": BpmnElementType.RECEIVE_TASK,
    "exclusiveGateway": BpmnElementType.EXCLUSIVE_GATEWAY,
    "parallelGateway": BpmnElementType.PARALLEL_GATEWAY,
    "inclusiveGateway": BpmnElementType.INCLUSIVE_GATEWAY,
    "eventBasedGateway": BpmnElementType.EVENT_BASED_GATEWAY,
    "intermediateCatchEvent": BpmnElementType.INTERMEDIATE_CATCH_EVENT,
    "intermediateThrowEvent": BpmnElementType.INTERMEDIATE_THROW_EVENT,
    "boundaryEvent": BpmnElementType.BOUNDARY_EVENT,
    "subProcess": BpmnElementType.SUB_PROCESS,
    "callActivity": BpmnElementType.CALL_ACTIVITY,
}
_TYPE_TO_TAG = {v: k for k, v in _TAG_TO_TYPE.items()}
# an event sub-process is a subProcess with triggeredByEvent="true"
_TYPE_TO_TAG[BpmnElementType.EVENT_SUB_PROCESS] = "subProcess"


def parse_bpmn_xml(xml_text: str | bytes) -> list[ProcessModel]:
    """Parse a BPMN definitions document into its executable processes."""
    try:
        root = ET.fromstring(xml_text)
    except ET.ParseError as exc:
        raise BpmnModelError(f"invalid BPMN XML: {exc}") from exc
    if root.tag != f"{_B}definitions":
        raise BpmnModelError(f"expected bpmn:definitions root, got {root.tag}")
    # messages declared at definitions level: id -> name
    messages: dict[str, str] = {}
    for msg in root.findall(f"{_B}message"):
        messages[msg.get("id", "")] = msg.get("name", "")
    errors: dict[str, str] = {}
    for err in root.findall(f"{_B}error"):
        errors[err.get("id", "")] = err.get("errorCode", "")
    signals: dict[str, str] = {}
    for sig in root.findall(f"{_B}signal"):
        signals[sig.get("id", "")] = sig.get("name", "")
    escalations: dict[str, str] = {}
    for esc in root.findall(f"{_B}escalation"):
        escalations[esc.get("id", "")] = esc.get("escalationCode", "")

    out = []
    for proc in root.findall(f"{_B}process"):
        if proc.get("isExecutable", "true") not in ("true", "1"):
            continue
        model = ProcessModel(process_id=proc.get("id", ""), name=proc.get("name", ""))
        _parse_scope(proc, model, parent_id=None, messages=messages, errors=errors, signals=signals, escalations=escalations)
        out.append(model)
    if not out:
        raise BpmnModelError("no executable process in document")
    return out


def _parse_scope(scope_el, model: ProcessModel, parent_id, messages, errors, signals, escalations) -> None:
    for child in scope_el:
        tag = child.tag.removeprefix(_B)
        if tag == "sequenceFlow":
            flow = SequenceFlow(
                id=child.get("id", ""),
                source_id=child.get("sourceRef", ""),
                target_id=child.get("targetRef", ""),
            )
            cond = child.find(f"{_B}conditionExpression")
            if cond is not None and cond.text:
                text = cond.text.strip()
                flow.condition = text[1:].strip() if text.startswith("=") else text
            model.flows[flow.id] = flow
            continue
        etype = _TAG_TO_TYPE.get(tag)
        if etype is None:
            continue
        if etype == BpmnElementType.SUB_PROCESS and child.get("triggeredByEvent") in ("true", "1"):
            etype = BpmnElementType.EVENT_SUB_PROCESS
        el = ProcessElement(id=child.get("id", ""), element_type=etype, name=child.get("name", ""))
        el.parent_id = parent_id
        if etype == BpmnElementType.BOUNDARY_EVENT:
            el.attached_to_id = child.get("attachedToRef")
            el.interrupting = child.get("cancelActivity", "true") in ("true", "1")
        if etype == BpmnElementType.START_EVENT:
            el.interrupting = child.get("isInterrupting", "true") in ("true", "1")
        if etype == BpmnElementType.EXCLUSIVE_GATEWAY or etype == BpmnElementType.INCLUSIVE_GATEWAY:
            el.default_flow_id = child.get("default")
        _parse_event_definitions(child, el, messages, errors, signals, escalations)
        _parse_extensions(child, el)
        if (el.element_type == BpmnElementType.USER_TASK and not el.native_user_task
                and el.job_type is None):
            # job-based user tasks use the implicit worker contract (reference:
            # UserTaskTransformer's default zeebe:userTask job type); element
            # level, not extensions level — a plain <userTask/> has no
            # extensionElements at all
            el.job_type = "io.camunda.zeebe:userTask"
        model.elements[el.id] = el
        if etype in (BpmnElementType.SUB_PROCESS, BpmnElementType.EVENT_SUB_PROCESS):
            _parse_scope(child, model, parent_id=el.id, messages=messages, errors=errors, signals=signals, escalations=escalations)


def _parse_event_definitions(el_xml, el: ProcessElement, messages, errors, signals, escalations) -> None:
    timer = el_xml.find(f"{_B}timerEventDefinition")
    if timer is not None:
        el.event_type = BpmnEventType.TIMER
        t = TimerDefinition()
        for field, tag in (("duration", "timeDuration"), ("cycle", "timeCycle"), ("date", "timeDate")):
            node = timer.find(f"{_B}{tag}")
            if node is not None and node.text:
                setattr(t, field, node.text.strip())
        el.timer = t
    msg = el_xml.find(f"{_B}messageEventDefinition")
    # receive tasks reference their message by ATTRIBUTE (BPMN), events by a
    # nested messageEventDefinition — same resolution either way
    msg_ref = (msg.get("messageRef", "") if msg is not None
               else el_xml.get("messageRef")
               if el.element_type == BpmnElementType.RECEIVE_TASK else None)
    if msg_ref is not None:
        el.event_type = BpmnEventType.MESSAGE
        el.message = MessageDefinition(name=messages.get(msg_ref, msg_ref))
    err = el_xml.find(f"{_B}errorEventDefinition")
    if err is not None:
        el.event_type = BpmnEventType.ERROR
        el.error_code = errors.get(err.get("errorRef", ""), err.get("errorRef", ""))
    sig = el_xml.find(f"{_B}signalEventDefinition")
    if sig is not None:
        el.event_type = BpmnEventType.SIGNAL
        el.signal_name = signals.get(sig.get("signalRef", ""), sig.get("signalRef", ""))
    esc = el_xml.find(f"{_B}escalationEventDefinition")
    if esc is not None:
        el.event_type = BpmnEventType.ESCALATION
        ref = esc.get("escalationRef")
        el.escalation_code = escalations.get(ref, ref) if ref else None
    link = el_xml.find(f"{_B}linkEventDefinition")
    if link is not None:
        el.event_type = BpmnEventType.LINK
        el.link_name = link.get("name", "")
    if el_xml.find(f"{_B}terminateEventDefinition") is not None:
        el.event_type = BpmnEventType.TERMINATE


def _parse_extensions(el_xml, el: ProcessElement) -> None:
    ext = el_xml.find(f"{_B}extensionElements")
    if ext is None:
        # receive tasks / message events may still carry subscriptions
        return
    task_def = ext.find(f"{_Z}taskDefinition")
    if task_def is not None:
        el.job_type = task_def.get("type")
        el.job_retries = task_def.get("retries", "3")
    headers = ext.find(f"{_Z}taskHeaders")
    if headers is not None:
        for h in headers.findall(f"{_Z}header"):
            el.task_headers[h.get("key", "")] = h.get("value", "")
    io = ext.find(f"{_Z}ioMapping")
    if io is not None:
        for node in io.findall(f"{_Z}input"):
            el.inputs.append(Mapping(node.get("source", ""), node.get("target", "")))
        for node in io.findall(f"{_Z}output"):
            el.outputs.append(Mapping(node.get("source", ""), node.get("target", "")))
    sub = ext.find(f"{_Z}subscription")
    if sub is not None and el.message is not None:
        el.message.correlation_key = sub.get("correlationKey")
    called = ext.find(f"{_Z}calledElement")
    if called is not None:
        el.called_process_id = called.get("processId")
    decision = ext.find(f"{_Z}calledDecision")
    if decision is not None:
        el.called_decision_id = decision.get("decisionId")
        el.decision_result_variable = decision.get("resultVariable")
    script = ext.find(f"{_Z}script")
    if script is not None:
        el.script_expression = script.get("expression")
        el.script_result_variable = script.get("resultVariable")
    form_def = ext.find(f"{_Z}formDefinition")
    if form_def is not None:
        el.form_id = form_def.get("formId")
    native_ut = ext.find(f"{_Z}userTask")
    if native_ut is not None:
        el.native_user_task = True
        assignment = ext.find(f"{_Z}assignmentDefinition")
        if assignment is not None:
            el.user_task_assignee = assignment.get("assignee")
            el.user_task_candidate_groups = assignment.get("candidateGroups")
    loop = el_xml.find(f"{_B}multiInstanceLoopCharacteristics")
    if loop is not None:
        mi = MultiInstanceDefinition(is_sequential=loop.get("isSequential", "false") in ("true", "1"))
        z_loop = None
        lext = loop.find(f"{_B}extensionElements")
        if lext is not None:
            z_loop = lext.find(f"{_Z}loopCharacteristics")
        if z_loop is not None:
            mi.input_collection = z_loop.get("inputCollection", "")
            mi.input_element = z_loop.get("inputElement")
            mi.output_collection = z_loop.get("outputCollection")
            mi.output_element = z_loop.get("outputElement")
        el.multi_instance = mi


# ---------------------------------------------------------------------------
# Writer


def to_bpmn_xml(models: Iterable[ProcessModel] | ProcessModel) -> str:
    if isinstance(models, ProcessModel):
        models = [models]
    ET.register_namespace("bpmn", BPMN_NS)
    ET.register_namespace("zeebe", ZEEBE_NS)
    root = ET.Element(f"{_B}definitions", {"targetNamespace": "http://zeebe-tpu/bpmn"})
    message_names: dict[str, str] = {}
    error_codes: dict[str, str] = {}
    signal_names: dict[str, str] = {}
    escalation_codes: dict[str, str] = {}
    for model in models:
        for el in model.elements.values():
            if el.message is not None:
                message_names.setdefault(el.message.name, f"msg_{len(message_names)}")
            if el.error_code:
                error_codes.setdefault(el.error_code, f"err_{len(error_codes)}")
            if el.signal_name:
                signal_names.setdefault(el.signal_name, f"sig_{len(signal_names)}")
            if el.escalation_code:
                escalation_codes.setdefault(el.escalation_code, f"esc_{len(escalation_codes)}")
    for name, mid in message_names.items():
        ET.SubElement(root, f"{_B}message", {"id": mid, "name": name})
    for code, eid in error_codes.items():
        ET.SubElement(root, f"{_B}error", {"id": eid, "errorCode": code})
    for name, sid in signal_names.items():
        ET.SubElement(root, f"{_B}signal", {"id": sid, "name": name})
    for code, eid in escalation_codes.items():
        ET.SubElement(root, f"{_B}escalation", {"id": eid, "escalationCode": code})
    for model in models:
        proc = ET.SubElement(
            root, f"{_B}process",
            {"id": model.process_id, "name": model.name, "isExecutable": "true"},
        )
        scopes: dict[str | None, ET.Element] = {None: proc}
        # parents first so children have a scope element to attach to
        ordered = sorted(model.elements.values(), key=lambda e: _depth(model, e))
        for el in ordered:
            parent = scopes[el.parent_id]
            node = _element_to_xml(parent, el, message_names, error_codes,
                                   signal_names, escalation_codes)
            if el.element_type in (BpmnElementType.SUB_PROCESS, BpmnElementType.EVENT_SUB_PROCESS):
                scopes[el.id] = node
        for flow in model.flows.values():
            scope_id = model.elements[flow.source_id].parent_id
            node = ET.SubElement(
                scopes[scope_id], f"{_B}sequenceFlow",
                {"id": flow.id, "sourceRef": flow.source_id, "targetRef": flow.target_id},
            )
            if flow.condition:
                cond = ET.SubElement(node, f"{_B}conditionExpression")
                cond.text = f"= {flow.condition}"
    ET.indent(root)
    return ET.tostring(root, encoding="unicode", xml_declaration=True)


def _depth(model: ProcessModel, el: ProcessElement) -> int:
    d = 0
    cur = el
    while cur.parent_id is not None:
        d += 1
        cur = model.elements[cur.parent_id]
    return d


def _element_to_xml(parent, el: ProcessElement, message_names, error_codes,
                    signal_names, escalation_codes) -> ET.Element:
    attrs = {"id": el.id}
    if el.name:
        attrs["name"] = el.name
    if el.element_type == BpmnElementType.BOUNDARY_EVENT:
        attrs["attachedToRef"] = el.attached_to_id or ""
        attrs["cancelActivity"] = "true" if el.interrupting else "false"
    if el.element_type == BpmnElementType.START_EVENT and not el.interrupting:
        attrs["isInterrupting"] = "false"
    if el.element_type == BpmnElementType.EVENT_SUB_PROCESS:
        attrs["triggeredByEvent"] = "true"
    if el.default_flow_id:
        attrs["default"] = el.default_flow_id
    if el.element_type == BpmnElementType.RECEIVE_TASK and el.message is not None:
        # receive tasks reference their message by ATTRIBUTE in BPMN (unlike
        # events, which nest a messageEventDefinition)
        attrs["messageRef"] = message_names[el.message.name]
    node = ET.SubElement(parent, f"{_B}{_TYPE_TO_TAG[el.element_type]}", attrs)

    ext = None

    def ext_el() -> ET.Element:
        nonlocal ext
        if ext is None:
            ext = ET.SubElement(node, f"{_B}extensionElements")
        return ext

    if el.job_type and el.element_type != BpmnElementType.USER_TASK:
        ET.SubElement(
            ext_el(), f"{_Z}taskDefinition", {"type": el.job_type, "retries": el.job_retries}
        )
    if el.task_headers:
        headers = ET.SubElement(ext_el(), f"{_Z}taskHeaders")
        for k, v in el.task_headers.items():
            ET.SubElement(headers, f"{_Z}header", {"key": k, "value": v})
    if el.inputs or el.outputs:
        io = ET.SubElement(ext_el(), f"{_Z}ioMapping")
        for m in el.inputs:
            ET.SubElement(io, f"{_Z}input", {"source": m.source, "target": m.target})
        for m in el.outputs:
            ET.SubElement(io, f"{_Z}output", {"source": m.source, "target": m.target})
    if el.message is not None and el.message.correlation_key:
        ET.SubElement(ext_el(), f"{_Z}subscription", {"correlationKey": el.message.correlation_key})
    if el.called_process_id:
        ET.SubElement(ext_el(), f"{_Z}calledElement", {"processId": el.called_process_id})
    if el.called_decision_id:
        attrs = {"decisionId": el.called_decision_id}
        if el.decision_result_variable:
            attrs["resultVariable"] = el.decision_result_variable
        ET.SubElement(ext_el(), f"{_Z}calledDecision", attrs)
    if el.script_expression:
        attrs = {"expression": el.script_expression}
        if el.script_result_variable:
            attrs["resultVariable"] = el.script_result_variable
        ET.SubElement(ext_el(), f"{_Z}script", attrs)
    if el.form_id:
        ET.SubElement(ext_el(), f"{_Z}formDefinition", {"formId": el.form_id})
    if el.native_user_task:
        ET.SubElement(ext_el(), f"{_Z}userTask", {})
        assignment = {}
        if el.user_task_assignee:
            assignment["assignee"] = el.user_task_assignee
        if el.user_task_candidate_groups:
            assignment["candidateGroups"] = el.user_task_candidate_groups
        if assignment:
            ET.SubElement(ext_el(), f"{_Z}assignmentDefinition", assignment)

    if el.event_type == BpmnEventType.TIMER and el.timer is not None:
        timer = ET.SubElement(node, f"{_B}timerEventDefinition")
        if el.timer.duration:
            ET.SubElement(timer, f"{_B}timeDuration").text = el.timer.duration
        if el.timer.cycle:
            ET.SubElement(timer, f"{_B}timeCycle").text = el.timer.cycle
        if el.timer.date:
            ET.SubElement(timer, f"{_B}timeDate").text = el.timer.date
    elif (el.event_type == BpmnEventType.MESSAGE and el.message is not None
          and el.element_type != BpmnElementType.RECEIVE_TASK):
        ET.SubElement(
            node, f"{_B}messageEventDefinition", {"messageRef": message_names[el.message.name]}
        )
    elif el.event_type == BpmnEventType.ERROR:
        err_attrs = {"errorRef": error_codes[el.error_code]} if el.error_code else {}
        ET.SubElement(node, f"{_B}errorEventDefinition", err_attrs)
    elif el.event_type == BpmnEventType.SIGNAL and el.signal_name:
        ET.SubElement(
            node, f"{_B}signalEventDefinition", {"signalRef": signal_names[el.signal_name]}
        )
    elif el.event_type == BpmnEventType.ESCALATION:
        esc_attrs = (
            {"escalationRef": escalation_codes[el.escalation_code]} if el.escalation_code else {}
        )
        ET.SubElement(node, f"{_B}escalationEventDefinition", esc_attrs)
    elif el.event_type == BpmnEventType.TERMINATE:
        ET.SubElement(node, f"{_B}terminateEventDefinition")
    elif el.event_type == BpmnEventType.LINK and el.link_name is not None:
        ET.SubElement(node, f"{_B}linkEventDefinition",
                      {"name": el.link_name})

    if el.multi_instance is not None:
        mi = el.multi_instance
        loop = ET.SubElement(
            node, f"{_B}multiInstanceLoopCharacteristics",
            {"isSequential": "true" if mi.is_sequential else "false"},
        )
        lext = ET.SubElement(loop, f"{_B}extensionElements")
        attrs = {"inputCollection": mi.input_collection}
        if mi.input_element:
            attrs["inputElement"] = mi.input_element
        if mi.output_collection:
            attrs["outputCollection"] = mi.output_collection
        if mi.output_element:
            attrs["outputElement"] = mi.output_element
        ET.SubElement(lext, f"{_Z}loopCharacteristics", attrs)
    return node
