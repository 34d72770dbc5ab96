"""What the engine must write for one instance of a linear process, worked
out from the BPMN file and the instance's variables alone.

Zeebe's record semantics for a none start event, service tasks and a none
end event: the create command's step writes the creation, the process's
activation, the variable, the start event's life cycle and the first
task's activation with its job; each job completion's step completes that
task, takes the next flow and activates the next element, and the last one
completes the end event and the process. Records written while one client
command is processed carry that command's position as their source.

Keys are symbolic: ``"pi"`` the instance (and the process's element
instance), ``"def"`` the process definition, ``"var:x"`` a variable,
``"ei:<id>"`` an element instance, ``"flow:<id>"`` a taken sequence flow,
``"job:<id>"`` a task's job, ``"cmd:create"`` and ``"cmd:complete:<id>"``
the positions of the client commands. :mod:`judge` binds each symbol to one
number of the log, the same number everywhere."""

from __future__ import annotations

from zbench.reference.bpmn import Element, LinearProcess

#: fields of record values that hold keys, compared by symbol
KEY_FIELDS = ("processInstanceKey", "flowScopeKey", "elementInstanceKey", "scopeKey",
              "processDefinitionKey")


class _AnyDeadline:
    """A job's deadline after activation: the broker's clock plus the
    activation's timeout, a positive number the reference cannot know."""

    def matches(self, value) -> bool:
        return isinstance(value, int) and value > 0

    def __repr__(self) -> str:
        return "<deadline>"


ANY_DEADLINE = _AnyDeadline()


class Sym(str):
    """A symbolic key, bound to one number of the log by the judge."""


def _rec(record_type, value_type, intent, key, source, processed, value) -> dict:
    return {"recordType": record_type, "valueType": value_type, "intent": intent,
            "key": key, "source": source, "processed": processed, "value": value}


def _element_value(process: LinearProcess, element_id: str, element_type: str,
                   event_type: str, scope, event: bool) -> dict:
    value = {"bpmnProcessId": process.process_id, "version": 1,
             "processDefinitionKey": Sym("def"), "processInstanceKey": Sym("pi"),
             "elementId": element_id, "flowScopeKey": scope,
             "bpmnElementType": element_type, "bpmnEventType": event_type}
    if event:
        value.update(parentProcessInstanceKey=-1, parentElementInstanceKey=-1)
    return value


class _Steps:
    def __init__(self, process: LinearProcess, x: int, worker: str) -> None:
        self.p, self.x, self.worker = process, x, worker
        self.out: list[dict] = []

    def element(self, element: Element, key: str, source: str, intents) -> None:
        value = _element_value(self.p, element.id, element.type, "NONE", Sym("pi"), True)
        for intent in intents:
            self.out.append(_rec("EVENT", "PROCESS_INSTANCE", intent, Sym(key), source, False,
                                 dict(value)))

    def command(self, element: Element, intent: str, source: str) -> None:
        key = Sym(f"ei:{element.id}")
        value = (_element_value(self.p, element.id, element.type, "NONE", Sym("pi"), False)
                 if intent == "ACTIVATE_ELEMENT" else {})
        self.out.append(_rec("COMMAND", "PROCESS_INSTANCE", intent, key, source, True, value))

    def job_value(self, task: Element, worker: str, deadline) -> dict:
        return {"type": task.job_type, "retries": task.retries, "worker": worker,
                "deadline": deadline, "variables": {}, "customHeaders": {},
                "elementId": task.id, "elementInstanceKey": Sym(f"ei:{task.id}"),
                "processInstanceKey": Sym("pi"), "processDefinitionKey": Sym("def"),
                "processDefinitionVersion": 1, "bpmnProcessId": self.p.process_id,
                "errorMessage": ""}

    def flow(self, index: int, source: str) -> None:
        flow_id = self.p.flows[index]
        value = _element_value(self.p, flow_id, "SEQUENCE_FLOW", "UNSPECIFIED", Sym("pi"),
                               False)
        self.out.append(_rec("EVENT", "PROCESS_INSTANCE", "SEQUENCE_FLOW_TAKEN",
                             Sym(f"flow:{flow_id}"), source, False, value))

    def enter(self, index: int, source: str) -> None:
        """Activate ``elements[index]``: a task waits for its job; the end
        event completes, and with it the process."""
        element = self.p.elements[index]
        key = f"ei:{element.id}"
        self.command(element, "ACTIVATE_ELEMENT", source)
        if element.type == "SERVICE_TASK":
            self.element(element, key, source, ("ELEMENT_ACTIVATING", "ELEMENT_ACTIVATED"))
            self.out.append(_rec("EVENT", "JOB", "CREATED", Sym(f"job:{element.id}"), source,
                                 False, self.job_value(element, "", -1)))
            return
        self.element(element, key, source, ("ELEMENT_ACTIVATING", "ELEMENT_ACTIVATED",
                                            "ELEMENT_COMPLETING", "ELEMENT_COMPLETED"))
        self.out.append(_rec("COMMAND", "PROCESS_INSTANCE", "COMPLETE_ELEMENT", Sym("pi"),
                             source, True, {}))
        value = _element_value(self.p, self.p.process_id, "PROCESS", "NONE", -1, True)
        for intent in ("ELEMENT_COMPLETING", "ELEMENT_COMPLETED"):
            self.out.append(_rec("EVENT", "PROCESS_INSTANCE", intent, Sym("pi"), source, False,
                                 dict(value)))

    def create(self) -> None:
        p, src = self.p, Sym("cmd:create")
        variables = {"x": self.x}
        self.out.append(_rec("COMMAND", "PROCESS_INSTANCE_CREATION", "CREATE", -1, -1, False,
                             {"bpmnProcessId": p.process_id, "version": -1,
                              "variables": variables}))
        self.out.append(_rec("EVENT", "PROCESS_INSTANCE_CREATION", "CREATED", Sym("pi"), src,
                             False, {"bpmnProcessId": p.process_id, "version": 1,
                                     "processDefinitionKey": Sym("def"),
                                     "processInstanceKey": Sym("pi"),
                                     "variables": dict(variables), "startInstructions": []}))
        self.out.append(_rec("COMMAND", "PROCESS_INSTANCE", "ACTIVATE_ELEMENT", Sym("pi"), src,
                             True, _element_value(p, p.process_id, "PROCESS", "UNSPECIFIED",
                                                  -1, False)))
        self.out.append(_rec("EVENT", "VARIABLE", "CREATED", Sym("var:x"), src, False,
                             {"name": "x", "value": self.x, "scopeKey": Sym("pi"),
                              "processInstanceKey": Sym("pi"),
                              "processDefinitionKey": Sym("def"),
                              "bpmnProcessId": p.process_id}))
        value = _element_value(p, p.process_id, "PROCESS", "NONE", -1, True)
        for intent in ("ELEMENT_ACTIVATING", "ELEMENT_ACTIVATED"):
            self.out.append(_rec("EVENT", "PROCESS_INSTANCE", intent, Sym("pi"), src, False,
                                 dict(value)))
        start = p.elements[0]
        self.command(start, "ACTIVATE_ELEMENT", src)
        self.element(start, f"ei:{start.id}", src,
                     ("ELEMENT_ACTIVATING", "ELEMENT_ACTIVATED", "ELEMENT_COMPLETING",
                      "ELEMENT_COMPLETED"))
        self.flow(0, src)
        self.enter(1, src)

    def complete(self, index: int) -> None:
        task = self.p.elements[index]
        src = Sym(f"cmd:complete:{task.id}")
        self.out.append(_rec("COMMAND", "JOB", "COMPLETE", Sym(f"job:{task.id}"), -1, False,
                             {"variables": {}}))
        self.out.append(_rec("EVENT", "JOB", "COMPLETED", Sym(f"job:{task.id}"), src, False,
                             self.job_value(task, self.worker, ANY_DEADLINE)))
        self.command(task, "COMPLETE_ELEMENT", src)
        self.element(task, f"ei:{task.id}", src, ("ELEMENT_COMPLETING", "ELEMENT_COMPLETED"))
        self.flow(index, src)
        self.enter(index + 1, src)


def instance_records(process: LinearProcess, x: int, worker: str) -> list[dict]:
    """Every record of one instance, in log order: its create step, then one
    step per job completion."""
    steps = _Steps(process, x, worker)
    steps.create()
    for index, element in enumerate(process.elements):
        if element.type == "SERVICE_TASK":
            steps.complete(index)
    return steps.out


def command_positions(expected: list[dict]) -> list[tuple[int, str]]:
    """(index in ``expected``, symbol) of each client command: the records
    whose source is -1. A step's records take that command's position as
    their source."""
    out = []
    for i, rec in enumerate(expected):
        if rec["source"] == -1:
            task = rec["key"][len("job:"):] if rec["valueType"] == "JOB" else None
            out.append((i, "cmd:create" if task is None else f"cmd:complete:{task}"))
    return out
