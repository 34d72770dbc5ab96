"""Read a benchmark process model from its BPMN file, with nothing but the
standard library: the process id, its elements and its sequence flows.

The reference knows the shapes that it can judge: one none start event,
service tasks, exclusive gateways, parallel gateways and one or more none
end events, joined by sequence flows into a graph without loops in which
every element is reachable from the start.

- A start event has one outgoing flow, a service task one incoming and one
  outgoing, an end event one incoming.
- An exclusive gateway that decides (more than one outgoing flow, or a
  condition on one) gives each outgoing flow a condition in the subset of
  FEEL that :mod:`feel` reads, except its ``default`` flow, which it must
  have: with no default, an instance whose conditions all fail raises an
  incident, which the reference does not judge. One with a single
  outgoing flow and no condition merges the flows that come in.
- A parallel gateway is a fork (one flow in, several out) or a join
  (several in, one out).

Any other shape is refused, with the id of the element or flow at fault,
so a model that the reference cannot judge never reaches a run."""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, replace
from pathlib import Path

from zbench.reference import feel

BPMN_NS = "http://www.omg.org/spec/BPMN/20100524/MODEL"
ZEEBE_NS = "http://camunda.org/schema/zeebe/1.0"

#: BPMN tag -> the element type the engine writes in a record
ELEMENT_TYPES = {"startEvent": "START_EVENT", "serviceTask": "SERVICE_TASK",
                 "endEvent": "END_EVENT", "exclusiveGateway": "EXCLUSIVE_GATEWAY",
                 "parallelGateway": "PARALLEL_GATEWAY"}


@dataclass(frozen=True)
class Element:
    id: str
    type: str  # a value of ELEMENT_TYPES
    job_type: str | None = None
    retries: int = 3
    #: an exclusive gateway's default flow
    default: str | None = None


@dataclass(frozen=True)
class Flow:
    id: str
    source: str
    target: str
    #: the condition (``holds(variables)``), on an exclusive gateway's flow
    condition: object = None


@dataclass(frozen=True)
class Process:
    """A process graph. ``elements`` are in the order a walk from the start
    event meets them (for a process of one path, the path); ``flows`` and
    each element's outgoing flows are in document order, the order in which
    an exclusive gateway tries its conditions and a fork takes its flows."""

    process_id: str
    elements: tuple[Element, ...]
    flows: tuple[Flow, ...]

    def element(self, element_id: str) -> Element:
        return next(e for e in self.elements if e.id == element_id)

    def outgoing(self, element_id: str) -> tuple[Flow, ...]:
        return tuple(f for f in self.flows if f.source == element_id)

    def incoming(self, element_id: str) -> tuple[Flow, ...]:
        return tuple(f for f in self.flows if f.target == element_id)

    @property
    def start(self) -> Element:
        return self.elements[0]

    @property
    def tasks(self) -> tuple[Element, ...]:
        return tuple(e for e in self.elements if e.type == "SERVICE_TASK")

    @property
    def job_types(self) -> tuple[str, ...]:
        return tuple(sorted({t.job_type for t in self.tasks}))

    def is_join(self, element_id: str) -> bool:
        return (self.element(element_id).type == "PARALLEL_GATEWAY"
                and len(self.incoming(element_id)) > 1)

    def decides(self, element_id: str) -> bool:
        """An exclusive gateway that chooses among its outgoing flows."""
        out = self.outgoing(element_id)
        return (self.element(element_id).type == "EXCLUSIVE_GATEWAY"
                and (len(out) > 1 or any(f.condition is not None for f in out)))


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _read(process) -> tuple[dict[str, Element], list[Flow]]:
    """The elements and flows in document order, each of a kind the
    reference knows."""
    nodes: dict[str, Element] = {}
    flows: list[Flow] = []
    for child in process:
        tag, cid = _local(child.tag), child.get("id")
        if tag == "sequenceFlow":
            expression = child.find(f"{{{BPMN_NS}}}conditionExpression")
            condition = None
            if expression is not None:
                text = (expression.text or "").strip()
                try:
                    condition = feel.parse(text)
                except ValueError as e:
                    raise ValueError(f"flow {cid}: the condition {text!r} is outside the "
                                     f"FEEL the reference knows: {e}") from None
            flows.append(Flow(cid, child.get("sourceRef"), child.get("targetRef"), condition))
        elif tag in ELEMENT_TYPES:
            if any(_local(c.tag).endswith("EventDefinition") for c in child):
                raise ValueError(f"{cid} is not a none event")
            if cid in nodes:
                raise ValueError(f"{cid} is declared twice")
            job_type, retries = None, 3
            if tag == "serviceTask":
                definition = child.find(f".//{{{ZEEBE_NS}}}taskDefinition")
                if definition is None:
                    raise ValueError(f"service task {cid} has no job type")
                job_type = definition.get("type")
                retries = int(definition.get("retries", "3"))
            nodes[cid] = Element(cid, ELEMENT_TYPES[tag], job_type, retries,
                                 child.get("default") if tag == "exclusiveGateway" else None)
        elif tag not in ("extensionElements", "documentation"):
            raise ValueError(f"element <{tag}> {cid} is not one the reference knows")
    for f in flows:
        for end in (f.source, f.target):
            if end not in nodes:
                raise ValueError(f"flow {f.id} joins {end}, which the process does not have")
    return nodes, flows


def _check_shape(element: Element, out: tuple[Flow, ...], into: tuple[Flow, ...]) -> None:
    """Refuse an element whose flows the reference does not judge."""
    eid, kind = element.id, element.type
    conditioned = [f for f in out if f.condition is not None]
    if conditioned and kind != "EXCLUSIVE_GATEWAY":
        raise ValueError(f"flow {conditioned[0].id} has a condition, and leaves {eid}, "
                         f"which is not an exclusive gateway")
    wanted = {"START_EVENT": (0, 1), "SERVICE_TASK": (1, 1), "END_EVENT": (1, 0)}.get(kind)
    if wanted is not None and (len(into), len(out)) != wanted:
        raise ValueError(f"{eid} has {len(into)} incoming and {len(out)} outgoing flows, "
                         f"where a {kind.lower().replace('_', ' ')} has {wanted[0]} and "
                         f"{wanted[1]}")
    if kind == "PARALLEL_GATEWAY" and not (
            (len(into) == 1 and len(out) > 1) or (len(into) > 1 and len(out) == 1)):
        raise ValueError(f"parallel gateway {eid} has {len(into)} incoming and {len(out)} "
                         f"outgoing flows: neither a fork (1 in, several out) nor a join "
                         f"(several in, 1 out)")
    if kind == "EXCLUSIVE_GATEWAY":
        if not into or not out:
            raise ValueError(f"exclusive gateway {eid} has {len(into)} incoming and "
                             f"{len(out)} outgoing flows")
        if len(out) == 1 and not conditioned:
            return  # a merge
        ids = [f.id for f in out]
        if element.default not in ids:
            raise ValueError(f"exclusive gateway {eid} has no default flow among its "
                             f"outgoing flows {ids}")
        for f in out:
            if f.id == element.default and f.condition is not None:
                raise ValueError(f"flow {f.id}, the default of {eid}, has a condition")
            if f.id != element.default and f.condition is None:
                raise ValueError(f"flow {f.id} leaves exclusive gateway {eid} with no "
                                 f"condition and is not its default")


def parse(xml: str) -> Process:
    root = ET.fromstring(xml)
    processes = root.findall(f"{{{BPMN_NS}}}process")
    if len(processes) != 1:
        raise ValueError(f"expected one process, found {len(processes)}")
    nodes, flows = _read(processes[0])
    graph = Process(processes[0].get("id"), tuple(nodes.values()), tuple(flows))
    starts = [n for n in graph.elements if n.type == "START_EVENT"]
    if len(starts) != 1:
        raise ValueError(f"expected one start event, found {[s.id for s in starts]}")
    for node in graph.elements:
        _check_shape(node, graph.outgoing(node.id), graph.incoming(node.id))
    # a walk from the start: every element reachable, no loop
    order, on_path = [], set()

    def visit(node: Element) -> None:
        on_path.add(node.id)
        order.append(node)
        for f in graph.outgoing(node.id):
            if f.target in on_path:
                raise ValueError(f"flow {f.id} from {node.id} back to {f.target} closes a loop")
            if nodes[f.target] not in order:
                visit(nodes[f.target])
        on_path.remove(node.id)

    visit(starts[0])
    unreached = [n for n in nodes if nodes[n] not in order]
    if unreached:
        raise ValueError(f"{unreached[0]} is not reachable from the start event "
                         f"{starts[0].id}")
    return replace(graph, elements=tuple(order))


def load(path: str | Path) -> Process:
    return parse(Path(path).read_text())
