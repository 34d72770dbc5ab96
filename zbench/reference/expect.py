"""What the engine must write for one instance of a process graph, worked
out from the BPMN file, the instance's variables and the order in which the
client completed its jobs, and nothing else.

Zeebe's record semantics for a none start event, service tasks, exclusive
and parallel gateways and none end events: the create command's step
writes the creation, the process's activation, the variable and the start
event's life cycle, and follows the flows from there until each path waits
at a task's job or a join. Each job completion's step completes that task
and follows its flow on. An element other than a task completes as soon as
it is activated; an exclusive gateway takes the first outgoing flow in
document order whose condition holds, else its default; a fork takes every
outgoing flow in document order; a join is activated once its last
incoming flow is taken; the end event that leaves no token behind
completes the process. Records written while one client command is
processed carry that command's position as their source.

The completion order is an input, as ``x`` is: the client chose it, not the
engine. :mod:`judge` reads it from the instance's ``JOB COMPLETE`` commands
in the log.

Keys are symbolic: ``"pi"`` the instance (and the process's element
instance), ``"def"`` the process definition, ``"var:x"`` a variable,
``"ei:<id>"`` an element instance, ``"flow:<id>"`` a taken sequence flow,
``"job:<id>"`` a task's job, ``"cmd:create"`` and ``"cmd:complete:<id>"``
the positions of the client commands. :mod:`judge` binds each symbol to one
number of the log, the same number everywhere. With no loops, each element
and flow is met at most once an instance, so one symbol each suffices."""

from __future__ import annotations

from collections import deque

from zbench.reference.bpmn import Element, Flow, Process

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


def _element_value(process: Process, element_id: str, element_type: str,
                   event_type: str, scope, event: bool) -> dict:
    value = {"bpmnProcessId": process.process_id, "version": 1,
             "processDefinitionKey": Sym("def"), "processInstanceKey": Sym("pi"),
             "elementId": element_id, "flowScopeKey": scope,
             "bpmnElementType": element_type, "bpmnEventType": event_type}
    if event:
        value.update(parentProcessInstanceKey=-1, parentElementInstanceKey=-1)
    return value


class _Steps:
    """One instance's records as the engine writes them: each client
    command's step writes its own records, and the follow-up commands it
    writes (an element's activation or completion) are processed in the
    order written, within the same step. A token is an active element
    instance or a sequence flow taken and not yet consumed by its target (a
    join consumes one per incoming flow once the last has been taken); the
    process completes when an end event leaves no token behind."""

    def __init__(self, process: Process, x: int, worker: str) -> None:
        self.p, self.x, self.worker = process, x, worker
        self.variables = {"x": x}
        self.out: list[dict] = []
        self.queue: deque = deque()
        self.tokens = 0
        self.seen: set[str] = set()
        #: task id -> whether its job is open, in the order the jobs opened
        self.open: dict[str, bool] = {}
        #: join id -> its incoming flows taken so far
        self.arrived: dict[str, set[str]] = {}
        self.completed = False

    def element(self, element: Element, key: str, source: str, intents) -> None:
        value = _element_value(self.p, element.id, element.type, "NONE", Sym("pi"), True)
        for intent in intents:
            self.out.append(_rec("EVENT", "PROCESS_INSTANCE", intent, Sym(key), source, False,
                                 dict(value)))

    def command(self, element: Element, intent: str, source: str, then) -> None:
        """Write a follow-up command and queue its processing."""
        key = Sym(f"ei:{element.id}")
        value = (_element_value(self.p, element.id, element.type, "NONE", Sym("pi"), False)
                 if intent == "ACTIVATE_ELEMENT" else {})
        self.out.append(_rec("COMMAND", "PROCESS_INSTANCE", intent, key, source, True, value))
        self.queue.append(then)

    def drain(self) -> None:
        while self.queue:
            self.queue.popleft()()

    def job_value(self, task: Element, worker: str, deadline) -> dict:
        return {"type": task.job_type, "retries": task.retries, "worker": worker,
                "deadline": deadline, "variables": {}, "customHeaders": {},
                "elementId": task.id, "elementInstanceKey": Sym(f"ei:{task.id}"),
                "processInstanceKey": Sym("pi"), "processDefinitionKey": Sym("def"),
                "processDefinitionVersion": 1, "bpmnProcessId": self.p.process_id,
                "errorMessage": ""}

    def take(self, flow: Flow, source: str) -> None:
        """Take ``flow``; its target is activated unless it is a join that
        still waits for another incoming flow."""
        value = _element_value(self.p, flow.id, "SEQUENCE_FLOW", "UNSPECIFIED", Sym("pi"),
                               False)
        self.out.append(_rec("EVENT", "PROCESS_INSTANCE", "SEQUENCE_FLOW_TAKEN",
                             Sym(f"flow:{flow.id}"), source, False, value))
        self.tokens += 1
        target = self.p.element(flow.target)
        if self.p.is_join(target.id):
            arrived = self.arrived.setdefault(target.id, set())
            arrived.add(flow.id)
            if len(arrived) < len(self.p.incoming(target.id)):
                return
        self.command(target, "ACTIVATE_ELEMENT", source,
                     lambda: self.enter(target, source))

    def leave(self, element: Element, source: str) -> None:
        """``element`` has completed: take its outgoing flows (an exclusive
        gateway's first whose condition holds, else its default); an end
        event that leaves no token completes the process."""
        self.tokens -= 1
        flows = self.p.outgoing(element.id)
        if self.p.decides(element.id):
            flows = [next((f for f in flows if f.condition is not None
                           and f.condition.holds(self.variables)),
                          next(f for f in flows if f.id == element.default))]
        for flow in flows:
            self.take(flow, source)
        if not flows and self.tokens == 0:
            self.out.append(_rec("COMMAND", "PROCESS_INSTANCE", "COMPLETE_ELEMENT", Sym("pi"),
                                 source, True, {}))
            self.queue.append(lambda: self.finish(source))

    def finish(self, source: str) -> None:
        value = _element_value(self.p, self.p.process_id, "PROCESS", "NONE", -1, True)
        for intent in ("ELEMENT_COMPLETING", "ELEMENT_COMPLETED"):
            self.out.append(_rec("EVENT", "PROCESS_INSTANCE", intent, Sym("pi"), source, False,
                                 dict(value)))
        self.completed = True

    def enter(self, element: Element, source: str) -> None:
        """Process ``element``'s activation: a task waits for its job; any
        other element completes at once and leaves."""
        if element.id in self.seen:
            raise ValueError(f"{element.id} would be activated twice in one instance, "
                             f"which the reference does not judge")
        self.seen.add(element.id)
        if element.type != "START_EVENT":
            # the flows that led here are consumed: one, or a join's all
            self.tokens -= len(self.p.incoming(element.id)) if self.p.is_join(element.id) else 1
        self.tokens += 1
        key = f"ei:{element.id}"
        if element.type == "SERVICE_TASK":
            self.element(element, key, source, ("ELEMENT_ACTIVATING", "ELEMENT_ACTIVATED"))
            self.out.append(_rec("EVENT", "JOB", "CREATED", Sym(f"job:{element.id}"), source,
                                 False, self.job_value(element, "", -1)))
            self.open[element.id] = True
            return
        self.element(element, key, source, ("ELEMENT_ACTIVATING", "ELEMENT_ACTIVATED",
                                            "ELEMENT_COMPLETING", "ELEMENT_COMPLETED"))
        self.leave(element, source)

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
        self.command(p.start, "ACTIVATE_ELEMENT", src, lambda: self.enter(p.start, src))
        self.drain()

    def complete(self, task_id: str) -> None:
        """The step of the client's completion of ``task_id``'s job."""
        if not self.open.get(task_id):
            raise ValueError(f"the completion order completes the job of {task_id}, "
                             f"which is not open at that point")
        self.open[task_id] = False
        task = self.p.element(task_id)
        src = Sym(f"cmd:complete:{task.id}")
        self.out.append(_rec("COMMAND", "JOB", "COMPLETE", Sym(f"job:{task.id}"), -1, False,
                             {"variables": {}}))
        self.out.append(_rec("EVENT", "JOB", "COMPLETED", Sym(f"job:{task.id}"), src, False,
                             self.job_value(task, self.worker, ANY_DEADLINE)))

        def completed() -> None:
            self.element(task, f"ei:{task.id}", src,
                         ("ELEMENT_COMPLETING", "ELEMENT_COMPLETED"))
            self.leave(task, src)

        self.command(task, "COMPLETE_ELEMENT", src, completed)
        self.drain()


def _follow(process: Process, x: int, worker: str, order) -> _Steps:
    steps = _Steps(process, x, worker)
    steps.create()
    if order is None:
        while (task := next((t for t, is_open in steps.open.items() if is_open), None)) \
                is not None:
            steps.complete(task)
    else:
        for task in order:
            steps.complete(task)
    if not steps.completed:
        raise ValueError(f"the instance of x={x} does not complete after the jobs of "
                         f"{list(order) if order is not None else 'every open task'}: "
                         f"{sorted(t for t, o in steps.open.items() if o)} still open, "
                         f"{steps.tokens} token(s) left")
    return steps


def instance_records(process: Process, x: int, worker: str,
                     order: list[str] | tuple[str, ...] | None = None) -> list[dict]:
    """Every record of one instance of ``x``, in log order: its create step,
    then one step per job completion, in ``order`` (the ids of the tasks
    whose jobs the client completed, in the order it completed them; by
    default each time the job that opened first). ValueError where the
    order completes a job that is not open at that point, or leaves the
    instance unfinished."""
    return _follow(process, x, worker, order).out


def jobs_completed(process: Process, x: int) -> int:
    """How many jobs an instance of ``x`` completes: the tasks its
    exclusive gateways lead it to, whatever the order of completions.
    ValueError where the instance would never complete (a join that waits
    for a flow its branches do not take)."""
    return len(_follow(process, x, "", None).open)


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
