"""Read a benchmark process model from its BPMN file, with nothing but the
standard library: the process id and its elements in the order the
sequence flows visit them.

The reference knows one shape, the one the benchmark's models have: a none
start event, service tasks one after another, and a none end event, joined
by one sequence flow each. Any other shape is refused, so a model that the
reference cannot judge never reaches a run."""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass
from pathlib import Path

BPMN_NS = "http://www.omg.org/spec/BPMN/20100524/MODEL"
ZEEBE_NS = "http://camunda.org/schema/zeebe/1.0"

#: BPMN tag -> the element type the engine writes in a record
ELEMENT_TYPES = {"startEvent": "START_EVENT", "serviceTask": "SERVICE_TASK",
                 "endEvent": "END_EVENT"}


@dataclass(frozen=True)
class Element:
    id: str
    type: str  # START_EVENT, SERVICE_TASK, END_EVENT
    job_type: str | None = None
    retries: int = 3


@dataclass(frozen=True)
class LinearProcess:
    """A process of one path: ``elements[0]`` the start event, the service
    tasks, ``elements[-1]`` the end event; ``flows[i]`` leads from
    ``elements[i]`` to ``elements[i + 1]``."""

    process_id: str
    elements: tuple[Element, ...]
    flows: tuple[str, ...]

    @property
    def tasks(self) -> tuple[Element, ...]:
        return tuple(e for e in self.elements if e.type == "SERVICE_TASK")

    @property
    def job_types(self) -> tuple[str, ...]:
        return tuple(sorted({t.job_type for t in self.tasks}))


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def parse(xml: str) -> LinearProcess:
    root = ET.fromstring(xml)
    processes = root.findall(f"{{{BPMN_NS}}}process")
    if len(processes) != 1:
        raise ValueError(f"expected one process, found {len(processes)}")
    process = processes[0]
    nodes: dict[str, Element] = {}
    flows: dict[str, tuple[str, str]] = {}
    for child in process:
        tag = _local(child.tag)
        if tag == "sequenceFlow":
            if child.find(f"{{{BPMN_NS}}}conditionExpression") is not None:
                raise ValueError(f"flow {child.get('id')} has a condition")
            flows[child.get("id")] = (child.get("sourceRef"), child.get("targetRef"))
        elif tag in ELEMENT_TYPES:
            if any(_local(c.tag).endswith("EventDefinition") for c in child):
                raise ValueError(f"{child.get('id')} is not a none event")
            job_type, retries = None, 3
            if tag == "serviceTask":
                definition = child.find(f".//{{{ZEEBE_NS}}}taskDefinition")
                if definition is None:
                    raise ValueError(f"service task {child.get('id')} has no job type")
                job_type = definition.get("type")
                retries = int(definition.get("retries", "3"))
            nodes[child.get("id")] = Element(child.get("id"), ELEMENT_TYPES[tag],
                                             job_type, retries)
        elif tag not in ("extensionElements", "documentation"):
            raise ValueError(f"element <{tag}> is not one the reference knows")
    starts = [n for n in nodes.values() if n.type == "START_EVENT"]
    if len(starts) != 1:
        raise ValueError("expected one start event")
    outgoing: dict[str, list[str]] = {}
    for flow_id, (source, _) in flows.items():
        outgoing.setdefault(source, []).append(flow_id)
    order, path = [starts[0]], []
    while order[-1].type != "END_EVENT":
        out = outgoing.get(order[-1].id, [])
        if len(out) != 1:
            raise ValueError(f"{order[-1].id} has {len(out)} outgoing flows, not 1")
        path.append(out[0])
        order.append(nodes[flows[out[0]][1]])
        if len(order) > len(nodes):
            raise ValueError("the flows form a loop")
    if len(order) != len(nodes) or len(path) != len(flows):
        raise ValueError("not every element lies on the one path")
    return LinearProcess(process.get("id"), tuple(order), tuple(path))


def load(path: str | Path) -> LinearProcess:
    return parse(Path(path).read_text())
