"""Judge what a run produced against the reference: each instance's records
in its partition's log, every replica's log, the replies the clients got
and the state the instances left behind.

Everything here reads plain data (dicts, lists, bytes) that the harness
gathered from the run; nothing of the program is imported. A record is a
dict with ``position``, ``source`` (the source position), ``processed``,
``recordType``, ``valueType``, ``intent`` (names), ``key`` and ``value``."""

from __future__ import annotations

import random

from zbench.reference.bpmn import Process
from zbench.reference.expect import ANY_DEADLINE, Sym, command_positions, instance_records

#: the numbers a run compares, each with its limit (an exact comparison:
#: any count above 0 fails the run)
LIMITS = {"instance_mismatches": 0, "acked_lost": 0, "reply_mismatches": 0,
          "replica_mismatches": 0, "state_leftovers": 0}


def group_by_instance(log: list[dict]) -> dict[int, list[dict]]:
    """A partition's records by process instance, in log order: those whose
    value names the instance, the commands keyed by one of its keys (an
    element's completion, a job's completion), and the create command that
    the instance's creation answers. Job batches belong to no instance."""
    at = {r["position"]: r for r in log}
    owner: dict[int, int] = {}
    out: dict[int, list[dict]] = {}
    for r in log:
        if r["valueType"] == "JOB_BATCH":
            continue
        value = r["value"] if isinstance(r["value"], dict) else {}
        pik = value.get("processInstanceKey")
        if pik is None or pik < 0:
            pik = owner.get(r["key"])
            if pik is None:
                continue
        if r["key"] >= 0:
            owner.setdefault(r["key"], pik)
        records = out.setdefault(pik, [])
        if r["valueType"] == "PROCESS_INSTANCE_CREATION" and r["intent"] == "CREATED":
            create = at.get(r["source"])
            if create is not None:
                records.append(create)
        records.append(r)
    return out


class _Binding:
    """Symbols bound to numbers one to one: a symbol means one number, and
    no two symbols share one."""

    def __init__(self) -> None:
        self.value: dict[str, int] = {}
        self.symbol: dict[tuple[str, int], str] = {}

    def bind(self, sym: str, number) -> bool:
        space = "position" if sym.startswith("cmd:") else "key"
        if not isinstance(number, int) or isinstance(number, bool) or number < 0:
            return False
        if sym in self.value:
            return self.value[sym] == number
        if (space, number) in self.symbol:
            return False
        self.value[sym] = number
        self.symbol[(space, number)] = sym
        return True


def _matches(expected, actual, binding: _Binding) -> bool:
    if isinstance(expected, Sym):
        return binding.bind(expected, actual)
    if expected is ANY_DEADLINE:
        return ANY_DEADLINE.matches(actual)
    if isinstance(expected, dict):
        return (isinstance(actual, dict) and expected.keys() == actual.keys()
                and all(_matches(v, actual[k], binding) for k, v in expected.items()))
    if isinstance(expected, list):
        return (isinstance(actual, list) and len(expected) == len(actual)
                and all(_matches(e, a, binding) for e, a in zip(expected, actual)))
    return type(expected) is type(actual) and expected == actual


def compare_instance(expected: list[dict], actual: list[dict]) -> str | None:
    """None when ``actual`` is ``expected`` under one binding of its
    symbols, else the first difference."""
    if len(actual) != len(expected):
        return f"{len(actual)} records where the reference has {len(expected)}"
    binding = _Binding()
    for i, sym in command_positions(expected):
        if not binding.bind(sym, actual[i]["position"]):
            return f"record {i}: the command's position {actual[i]['position']} is taken"
    for i, (e, a) in enumerate(zip(expected, actual)):
        for field in ("recordType", "valueType", "intent", "processed", "key", "source",
                      "value"):
            if not _matches(e[field], a[field], binding):
                return (f"record {i} ({e['valueType']} {e['intent']}): {field} is "
                        f"{a[field]!r}, the reference has {e[field]!r}")
    return None


def in_step_order(records: list[dict]) -> tuple[list[dict] | None, str | None]:
    """An instance's records with each client command (source -1) put just
    before the first record of its step, and None; or None and what is out
    of order. A client's command lands in the log when it arrives, so where
    a client completes several of an instance's jobs at once, another
    command may come between a command and its step. The steps themselves
    are the engine's: each follows its command, and they come in the order
    of their commands, or the instance is out of order. For an instance
    whose commands each wait for the step before (a process of one path),
    this is the log's own order."""
    commands = {r["position"]: r for r in records if r["source"] == -1}
    out, placed = [], []
    for r in records:
        if r["source"] == -1:
            continue
        if r["source"] in commands and r["source"] not in placed:
            placed.append(r["source"])
            out.append(commands[r["source"]])
        out.append(r)
    if placed != sorted(placed):
        return None, (f"the steps of the commands at positions {placed} do not follow "
                      f"the order of their commands")
    out += [r for position, r in commands.items() if position not in placed]
    return out, None


def completion_order(records: list[dict]) -> list[str] | None:
    """The ids of the tasks whose jobs the instance's ``JOB COMPLETE``
    commands completed, in log order: the order the client chose, which the
    reference takes as an input. None where a command names a job that the
    instance did not create."""
    task_of = {r["key"]: r["value"].get("elementId") for r in records
               if r["valueType"] == "JOB" and r["intent"] == "CREATED"
               and r["recordType"] == "EVENT" and isinstance(r["value"], dict)}
    order = []
    for r in records:
        if r["valueType"] == "JOB" and r["intent"] == "COMPLETE" \
                and r["recordType"] == "COMMAND":
            if r["key"] not in task_of:
                return None
            order.append(task_of[r["key"]])
    return order


def instance_diff(process: Process, x: int, worker: str, records: list[dict],
                  cache: dict) -> str | None:
    """None where an instance of ``x`` whose log holds ``records`` wrote
    what the reference gives for its completion order, else the first
    difference. ``cache`` keeps the reference's records by (x, order)."""
    records, why = in_step_order(records)
    if records is None:
        return why
    order = completion_order(records)
    if order is None:
        return "a job completion names a job the instance did not create"
    at = (x, tuple(order))
    if at not in cache:
        try:
            cache[at] = instance_records(process, x, worker, order)
        except ValueError as e:
            cache[at] = str(e)
    expected = cache[at]
    return expected if isinstance(expected, str) else compare_instance(expected, records)


def _reply_matches(reply: dict | None, value_type: str, intent: str, key: int,
                   logged: dict | None) -> bool:
    """A reply names the event the log holds for its command."""
    return (reply is not None and logged is not None
            and reply["recordType"] == "EVENT" and reply["valueType"] == value_type
            and reply["intent"] == intent and reply["key"] == key
            and logged["key"] == key and reply["value"] == logged["value"])


def sample(keys: list[int], n: int, seed: int, always: list[int]) -> list[int]:
    """Up to ``n`` of ``keys`` drawn from ``seed``, ``always`` among them."""
    if len(keys) <= n:
        return list(keys)
    rest = sorted(set(keys) - set(always))
    return sorted(set(always) | set(random.Random(seed).sample(rest, n - len(set(always)))))


def judge(process: Process, worker: str, run: dict) -> dict:
    """The run's compared numbers (see :data:`LIMITS`), with
    ``instances_checked`` and the first differences found.

    ``run`` holds:
      - ``logs``: partition -> the leader's log (records as above);
      - ``replicas``: partition -> replica -> [(position, bytes)] of each
        committed batch, the leader's among them, and ``leaders``:
        partition -> the leader's replica;
      - ``creates``: [{partition, x, reply, key}] for every acknowledged
        create (``reply`` the answer, a record dict without position);
      - ``completes``: [{partition, job, reply}] for every acknowledged job
        completion;
      - ``activations``: [{partition, reply}] for every activation;
      - ``checked``: the instance keys judged record by record (those the
        window saw complete, or a sample of them), each in step order
        (:func:`in_step_order`) against the reference's records for its
        ``x`` and the order of its job completions;
      - ``leftovers``: instance key -> what its state still holds (element
        instances, jobs, variables) after it completed.
    """
    counts = dict.fromkeys(LIMITS, 0)
    first: dict[str, str] = {}

    def fault(name: str, what: str) -> None:
        counts[name] += 1
        first.setdefault(name, what)

    by_partition = {pid: group_by_instance(log) for pid, log in run["logs"].items()}
    created = {}  # instance key -> (partition, x)
    for c in run["creates"]:
        pid, key = c["partition"], c["key"]
        records = by_partition[pid].get(key, [])
        logged = next((r for r in records if r["intent"] == "CREATED"
                       and r["valueType"] == "PROCESS_INSTANCE_CREATION"), None)
        if not _reply_matches(c["reply"], "PROCESS_INSTANCE_CREATION", "CREATED", key, logged) \
                or c["reply"]["value"].get("variables") != {"x": c["x"]}:
            fault("reply_mismatches", f"create on partition {pid} (x={c['x']}): reply "
                  f"{c['reply']!r}, logged {logged!r}")
        completed = sum(1 for r in records if r["intent"] == "ELEMENT_COMPLETED"
                        and r["value"].get("bpmnElementType") == "PROCESS")
        creations = sum(1 for r in records if r["intent"] == "CREATED"
                        and r["valueType"] == "PROCESS_INSTANCE_CREATION")
        if creations != 1 or completed != 1:
            fault("acked_lost", f"instance {key} on partition {pid}: created {creations}, "
                  f"completed {completed} times in the log")
        created[key] = (pid, c["x"])
    jobs_logged = {}
    for pid, log in run["logs"].items():
        for r in log:
            if r["valueType"] == "JOB" and r["recordType"] == "EVENT":
                jobs_logged[(pid, r["key"], r["intent"])] = r
    for c in run["completes"]:
        logged = jobs_logged.get((c["partition"], c["job"], "COMPLETED"))
        if not _reply_matches(c["reply"], "JOB", "COMPLETED", c["job"], logged):
            fault("reply_mismatches", f"job {c['job']} completion: reply {c['reply']!r}, "
                  f"logged {logged!r}")
    tasks = {t.id: t for t in process.tasks}
    for a in run["activations"]:
        reply = a["reply"]
        value = reply["value"] if reply is not None else {}
        jobs = value.get("jobs", [])
        ok = (reply is not None and reply["recordType"] == "EVENT"
              and reply["valueType"] == "JOB_BATCH" and reply["intent"] == "ACTIVATED"
              and len(value.get("jobKeys", [])) == len(jobs))
        for job in jobs if ok else ():
            owner = created.get(job.get("processInstanceKey"))
            task = tasks.get(job.get("elementId"))
            ok = ok and owner is not None and task is not None and (
                job.get("variables") == {"x": owner[1]} and job.get("type") == task.job_type
                and job.get("worker") == worker and job.get("retries") == task.retries
                and owner[0] == a["partition"])
        if not ok:
            fault("reply_mismatches", f"activation on partition {a['partition']}: {reply!r}")
    expected: dict = {}
    for key in run["checked"]:
        pid, x = created[key]
        diff = instance_diff(process, x, worker, by_partition[pid].get(key, []), expected)
        if diff is not None:
            fault("instance_mismatches", f"instance {key} on partition {pid}: {diff}")
        held = run["leftovers"].get(key)
        if held:
            fault("state_leftovers", f"instance {key} on partition {pid} left {held}")
    for pid, replicas in run["replicas"].items():
        leader = replicas[run["leaders"][pid]]
        for node, batches in replicas.items():
            if batches != leader:
                at = next((i for i, (a, b) in enumerate(zip(batches, leader)) if a != b),
                          min(len(batches), len(leader)))
                fault("replica_mismatches", f"partition {pid} replica {node}: "
                      f"{len(batches)} batches against the leader's {len(leader)}, first "
                      f"difference at batch {at}")
    return {"counts": counts, "instances_checked": len(run["checked"]), "first": first}
