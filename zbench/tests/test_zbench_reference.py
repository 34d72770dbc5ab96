"""The reference against the port's sequential engine on the CPU, and the
judge failing a perturbed log, a lost acknowledged create, a wrong reply
and a replica that differs. The branching models under
``zbench/tests/models/`` (kept out of ``zbench/models/`` so that no cell
names them) run for every x in 0..29 and every order of their fork's job
completions; the linear models' records are held to the parent's, kept in
``fixtures/linear_records.json``."""

import copy
import hashlib
import itertools
import json
from pathlib import Path

import pytest

from zbench import cells
from zbench.reference import bpmn, feel
from zbench.reference.expect import ANY_DEADLINE, Sym, instance_records, jobs_completed
from zbench.reference.judge import (
    compare_instance,
    completion_order,
    group_by_instance,
    judge,
)

WORKER = "zbench-worker"
HERE = Path(__file__).resolve().parent
XS = list(range(30))
#: every order of a fork's three jobs, as a rank of the task ids
FORK_ORDERS = {"fork_join": list(itertools.permutations("abc")),
               "fork_exclusive": list(itertools.permutations("abc")),
               "exclusive_three": [()]}


def model_xml(model: str) -> str:
    """A benchmark model, or a test fixture of that name."""
    path = cells.ROOT / "zbench" / "models" / f"{model}.bpmn"
    return (path if path.exists() else HERE / "models" / f"{model}.bpmn").read_text()


def _engine_run(model: str, xs: list[int], ranks: list[tuple] | None = None,
                xml: str | None = None):
    """The sequential engine (no kernel backend) on the CPU: deploy, create
    one instance per x, complete every open job wave by wave, each
    instance's in the order of its rank (task ids; the job that opened
    first where the rank has none). Returns the process, the log as the
    judge reads it, the create replies, the instance keys and each
    instance's completion order (task ids)."""
    from zeebe_tpu_torch.testing import EngineHarness

    xml = xml or model_xml(model)
    process = bpmn.parse(xml)
    ranks = ranks or [()] * len(xs)
    h = EngineHarness()
    try:
        h.deploy((f"{model}.bpmn", xml))
        keys = [h.create_instance(process.process_id, {"x": x}, request_id=10 + i)
                for i, x in enumerate(xs)]
        rank_of = dict(zip(keys, ranks))
        orders = {k: [] for k in keys}
        while True:
            jobs = [job for job_type in process.job_types
                    for job in h.activate_jobs(job_type, worker=WORKER, max_jobs=1000)]
            if not jobs:
                break
            for job in sorted(jobs, key=lambda j: (
                    j["processInstanceKey"],
                    rank_of[j["processInstanceKey"]].index(j["elementId"])
                    if j["elementId"] in rank_of[j["processInstanceKey"]] else -1,
                    j["key"])):
                h.complete_job(job["key"])
                orders[job["processInstanceKey"]].append(job["elementId"])
        log = []
        for logged in h.stream.new_reader(1):
            rec = logged.record
            log.append({"position": logged.position, "source": logged.source_position,
                        "processed": logged.processed, "recordType": rec.record_type.name,
                        "valueType": rec.value_type.name, "intent": rec.intent.name,
                        "key": rec.key, "value": rec.value})
    finally:
        h.close()
    return process, log, keys, [orders[k] for k in keys]


@pytest.fixture(scope="module", params=["one_task", "ten_tasks"])
def engine_run(request):
    return _engine_run(request.param, [3, 17, 29, 0])[:3]


def _run(process, log, keys, xs):
    created = {r["key"]: r for r in log
               if r["valueType"] == "PROCESS_INSTANCE_CREATION" and r["intent"] == "CREATED"}
    creates = [{"partition": 1, "x": x, "key": k,
                "reply": {f: created[k][f] for f in ("recordType", "valueType", "intent", "key",
                                                     "value")}}
               for k, x in zip(keys, xs)]
    return {"logs": {1: log}, "replicas": {1: {"broker-0": [(1, b"a"), (5, b"b")]}},
            "leaders": {1: "broker-0"}, "creates": creates, "completes": [],
            "activations": [], "checked": keys, "leftovers": {}}


def test_each_instance_is_what_the_reference_works_out(engine_run):
    process, log, keys = engine_run
    by_instance = group_by_instance(log)
    assert sorted(by_instance) == sorted(keys)
    for key, x in zip(keys, [3, 17, 29, 0]):
        expected = instance_records(process, x, WORKER)
        assert len(expected) == 20 + 10 * len(process.tasks)
        assert compare_instance(expected, by_instance[key]) is None


def test_the_judge_passes_the_engine_run(engine_run):
    process, log, keys = engine_run
    verdict = judge(process, WORKER, _run(process, log, keys, [3, 17, 29, 0]))
    assert verdict["counts"] == dict.fromkeys(verdict["counts"], 0)
    assert verdict["instances_checked"] == 4


@pytest.mark.parametrize("perturb", ["element", "variable", "dropped", "duplicated",
                                     "swapped", "key"])
def test_a_perturbed_log_fails(engine_run, perturb):
    process, log, keys = engine_run
    log = copy.deepcopy(log)
    mine = [i for i, r in enumerate(log)
            if isinstance(r["value"], dict) and r["value"].get("processInstanceKey") == keys[1]]
    i = mine[len(mine) // 2]
    if perturb == "element":
        log[i]["value"]["elementId"] = "elsewhere"
    elif perturb == "variable":
        v = next(j for j in mine if log[j]["valueType"] == "VARIABLE")
        log[v]["value"]["value"] = 18
    elif perturb == "dropped":
        del log[i]
    elif perturb == "duplicated":
        log.insert(i, dict(log[i], position=log[i]["position"]))
    elif perturb == "swapped":
        log[i], log[i + 1] = log[i + 1], log[i]
    else:
        log[i]["key"] = log[i]["key"] + 1_000_000
    verdict = judge(process, WORKER, _run(process, log, keys, [3, 17, 29, 0]))
    assert verdict["counts"]["instance_mismatches"] >= 1


def test_a_lost_acknowledged_create_fails(engine_run):
    process, log, keys = engine_run
    run = _run(process, log, keys, [3, 17, 29, 0])
    gone = keys[2]
    run["logs"] = {1: [r for r in log if not (
        isinstance(r["value"], dict) and r["value"].get("processInstanceKey") == gone)]}
    run["checked"] = [k for k in keys if k != gone]
    assert judge(process, WORKER, run)["counts"]["acked_lost"] == 1


def test_a_wrong_reply_and_a_differing_replica_fail(engine_run):
    process, log, keys = engine_run
    run = _run(process, log, keys, [3, 17, 29, 0])
    run["creates"][0]["reply"] = copy.deepcopy(run["creates"][0]["reply"])
    run["creates"][0]["reply"]["value"]["variables"] = {"x": 4}
    run["replicas"][1]["broker-1"] = [(1, b"a")]
    run["replicas"][1]["broker-2"] = [(1, b"a"), (5, b"c")]
    counts = judge(process, WORKER, run)["counts"]
    assert counts["reply_mismatches"] == 1
    assert counts["replica_mismatches"] == 2


def test_leftover_state_fails(engine_run):
    process, log, keys = engine_run
    run = _run(process, log, keys, [3, 17, 29, 0])
    run["leftovers"] = {keys[0]: ["job 1"]}
    assert judge(process, WORKER, run)["counts"]["state_leftovers"] == 1


def test_the_reference_refuses_a_shape_it_cannot_judge():
    xml = (cells.ROOT / "zbench" / "models" / "one_task.bpmn").read_text()
    with pytest.raises(ValueError):
        bpmn.parse(xml.replace('<bpmn:endEvent id="end">',
                               '<bpmn:exclusiveGateway id="gw"/><bpmn:endEvent id="end">'))
    assert bpmn.parse(xml).job_types == ("benchmark-task",)


# -- the linear models, as the parent's reference wrote them ----------------


def _encoded(records: list[dict]):
    def enc(v):
        if isinstance(v, Sym):
            return {"sym": str(v)}
        if v is ANY_DEADLINE:
            return {"any": "deadline"}
        if isinstance(v, dict):
            return {k: enc(w) for k, w in v.items()}
        if isinstance(v, list):
            return [enc(w) for w in v]
        return v

    return enc(records)


@pytest.mark.parametrize("model", ["one_task", "ten_tasks"])
def test_the_linear_models_records_are_the_parents(model):
    fixture = json.loads((HERE / "fixtures" / "linear_records.json").read_text())
    process = bpmn.parse(model_xml(model))
    assert [t.id for t in process.tasks] == [e.id for e in process.elements
                                             if e.type == "SERVICE_TASK"]
    assert process.job_types == ("benchmark-task",) and process.process_id == model
    assert _encoded(instance_records(process, 0, fixture["worker"])) == \
        fixture["records_at_x0"][model]
    for x in XS:
        text = json.dumps(_encoded(instance_records(process, x, fixture["worker"])),
                          sort_keys=True)
        assert hashlib.sha256(text.encode()).hexdigest() == fixture["digests"][model][str(x)]
        assert jobs_completed(process, x) == len(process.tasks)


# -- branching models against the sequential engine -------------------------


@pytest.fixture(scope="module", params=sorted(FORK_ORDERS))
def branching_run(request):
    model = request.param
    cases = [(x, rank) for x in XS for rank in FORK_ORDERS[model]]
    process, log, keys, orders = _engine_run(model, [x for x, _ in cases],
                                             [rank for _, rank in cases])
    return model, process, log, keys, [x for x, _ in cases], orders


def test_the_reference_is_the_engine_on_branching_models(branching_run):
    model, process, log, keys, xs, orders = branching_run
    by_instance = group_by_instance(log)
    assert sorted(by_instance) == sorted(keys)
    seen_orders = set()
    for key, x, order in zip(keys, xs, orders):
        records = by_instance[key]
        assert completion_order(records) == order
        assert len(order) == jobs_completed(process, x)
        diff = compare_instance(instance_records(process, x, WORKER, order), records)
        assert diff is None, (model, x, order, diff)
        seen_orders.add(tuple(order))
    if model != "exclusive_three":
        # every order of the fork's three jobs came about
        assert {o[:3] for o in seen_orders if len(o) >= 3} >= set(FORK_ORDERS["fork_join"])
    verdict = judge(process, WORKER, _run(process, log, keys, xs))
    assert verdict["counts"] == dict.fromkeys(verdict["counts"], 0), verdict["first"]
    assert verdict["instances_checked"] == len(keys)


def test_the_exclusive_gateways_choose_by_x():
    """The first flow in document order whose condition holds: x = 18 and
    19 meet both the mid and the high condition and take mid."""
    process = bpmn.parse(model_xml("exclusive_three"))
    taken = {}
    for x in XS:
        flows = {r["value"]["elementId"] for r in instance_records(process, x, WORKER)
                 if r["intent"] == "SEQUENCE_FLOW_TAKEN"}
        taken[x] = next(f for f in ("flow_route_low", "flow_route_mid", "flow_route_high",
                                    "flow_route_rest") if f in flows)
    assert {x for x, f in taken.items() if f == "flow_route_low"} == set(range(10)) - {3}
    assert {x for x, f in taken.items() if f == "flow_route_mid"} == set(range(10, 20)) | {3}
    assert {x for x, f in taken.items() if f == "flow_route_high"} == set(range(20, 25)) | {29}
    assert {x for x, f in taken.items() if f == "flow_route_rest"} == {25, 26, 27, 28}
    assert [jobs_completed(process, x) for x in (0, 3, 15, 22, 27, 29)] == [3, 3, 3, 2, 1, 2]


def test_the_reference_refuses_an_order_it_cannot_follow():
    process = bpmn.parse(model_xml("fork_exclusive"))
    with pytest.raises(ValueError, match="d"):
        instance_records(process, 3, WORKER, ["a", "d", "b", "c"])  # d not open yet
    with pytest.raises(ValueError, match="not open"):
        instance_records(process, 20, WORKER, ["a", "b", "c", "d"])  # x=20 skips b
    with pytest.raises(ValueError, match="does not complete"):
        instance_records(process, 3, WORKER, ["a", "b", "c"])


def _instance_at(log: list[dict], key: int) -> list[int]:
    """The indices in ``log`` of the instance's records."""
    mine = {id(r) for r in group_by_instance(log)[key]}
    return [i for i, r in enumerate(log) if id(r) in mine]


@pytest.mark.parametrize("perturb", ["wrong_branch", "early_join", "flow_dropped",
                                     "completions_swapped"])
def test_a_broken_branching_log_fails(perturb):
    if perturb == "wrong_branch":
        # the engine runs a model whose low and mid conditions are swapped;
        # the judge holds it to the true one
        xml = model_xml("exclusive_three")
        low = "= x &lt; 10 and x != 3"
        mid = "=x &gt;= 10 and x &lt;= 19 or x = 3"
        swapped = xml.replace(low, "@").replace(mid, low).replace("@", mid)
        assert swapped != xml
        _, log, keys, orders = _engine_run("exclusive_three", [5, 12], xml=swapped)
        process, xs = bpmn.parse(xml), [5, 12]
    else:
        model = "fork_join" if perturb != "flow_dropped" else "fork_exclusive"
        process, log, keys, orders = _engine_run(model, [7], [("b", "c", "a")])
        xs = [7]
        log = copy.deepcopy(log)
        mine = _instance_at(log, keys[0])
        if perturb == "early_join":
            # the join's activation and all that follows it moved to just
            # after the first flow taken into the join, in that step
            start = next(i for i in mine if log[i]["intent"] == "ACTIVATE_ELEMENT"
                         and log[i]["value"].get("elementId") == "join")
            block = log[start:mine[-1] + 1]
            first_in = next(i for i in mine if log[i]["intent"] == "SEQUENCE_FLOW_TAKEN"
                            and log[i]["value"]["elementId"].endswith("_join"))
            for r in block:
                r["source"] = log[first_in]["source"]
            del log[start:mine[-1] + 1]
            log[first_in + 1:first_in + 1] = block
        elif perturb == "flow_dropped":
            drop = next(i for i in mine if log[i]["intent"] == "SEQUENCE_FLOW_TAKEN"
                        and log[i]["value"]["elementId"] == "flow_fork_decide")
            del log[drop]
        else:
            # the first two completion commands name each other's job: the
            # log's order of completions is swapped, the steps are not
            first, second = [i for i in mine if log[i]["intent"] == "COMPLETE"
                             and log[i]["valueType"] == "JOB"][:2]
            log[first]["key"], log[second]["key"] = log[second]["key"], log[first]["key"]
    verdict = judge(process, WORKER, _run(process, log, keys, xs))
    assert verdict["counts"]["instance_mismatches"] > 0, verdict


def _renumber(log: list[dict]) -> list[dict]:
    """The log with positions 1, 2, ... in list order, sources following."""
    new = {r["position"]: i + 1 for i, r in enumerate(log)}
    return [dict(r, position=new[r["position"]],
                 source=new.get(r["source"], r["source"])) for r in log]


@pytest.mark.parametrize("arrival", ["commands_before_earlier_steps", "steps_reordered"])
def test_commands_may_arrive_early_and_steps_may_not_move(arrival):
    """Jobs completed at once: a completion command may land in the log
    before an earlier command's step (judged correct), but the steps keep
    the order of their commands (judged a mismatch)."""
    process, log, keys, orders = _engine_run("fork_join", [9], [("a", "b", "c")])
    mine = _instance_at(log, keys[0])
    commands = [i for i in mine if log[i]["intent"] == "COMPLETE"]
    if arrival == "commands_before_earlier_steps":
        moved = [log[i] for i in commands[1:]]
        log = [r for i, r in enumerate(log) if i not in commands[1:]]
        at = log.index(next(r for r in log if r["position"] == log[commands[0]]["position"]))
        log[at + 1:at + 1] = moved
    else:
        first, second = (log[i]["position"] for i in commands[:2])
        step = {p: [r for r in log if r["source"] == p] for p in (first, second)}
        rest = [r for r in log if r["source"] not in (first, second)]
        after = rest.index(next(r for r in rest if r["position"] == second))
        log = rest[:after + 1] + step[second] + step[first] + rest[after + 1:]
    verdict = judge(process, WORKER, _run(process, _renumber(log), keys, [9]))
    mismatches = verdict["counts"]["instance_mismatches"]
    assert mismatches == (0 if arrival == "commands_before_earlier_steps" else 1), verdict


def test_the_judge_takes_each_instances_own_order():
    """Two instances of one x, completed in different orders, each pass."""
    process, log, keys, orders = _engine_run("fork_join", [4, 4], [("a", "b", "c"),
                                                                   ("c", "b", "a")])
    assert orders == [["a", "b", "c"], ["c", "b", "a"]]
    verdict = judge(process, WORKER, _run(process, log, keys, [4, 4]))
    assert verdict["counts"]["instance_mismatches"] == 0, verdict["first"]


FORK = "fork_exclusive"


@pytest.mark.parametrize("shape,at", [
    ("other_element", "approve"), ("loop", "flow_d_back"), ("unreachable", "island_a"),
    ("no_default", "decide"), ("condition_outside", "flow_decide_b"),
    ("condition_not_on_gateway", "flow_a_join"), ("fork_and_join_at_once", "join"),
    ("task_with_two_outgoing", "c")])
def test_the_reference_refuses_a_shape_it_cannot_judge_by_its_id(shape, at):
    xml = model_xml(FORK)
    bpmn.parse(xml)
    cond = '<bpmn:conditionExpression>{}</bpmn:conditionExpression>'
    tail = "  </bpmn:process>"
    if shape == "other_element":
        xml = xml.replace('<bpmn:endEvent id="end">',
                          '<bpmn:userTask id="approve"/><bpmn:endEvent id="end">')
    elif shape == "loop":
        # d forks to the end and back into the join before it
        xml = xml.replace('<bpmn:sequenceFlow id="flow_d_end" sourceRef="d" targetRef="end" />',
                          '<bpmn:parallelGateway id="again"/>'
                          '<bpmn:sequenceFlow id="flow_d_again" sourceRef="d" targetRef="again"/>'
                          '<bpmn:sequenceFlow id="flow_again_end" sourceRef="again" '
                          'targetRef="end"/>'
                          '<bpmn:sequenceFlow id="flow_d_back" sourceRef="again" '
                          'targetRef="join"/>')
    elif shape == "unreachable":
        xml = xml.replace(tail, '''<bpmn:serviceTask id="island_a"><bpmn:extensionElements>
            <zeebe:taskDefinition type="t"/></bpmn:extensionElements></bpmn:serviceTask>
            <bpmn:serviceTask id="island_b"><bpmn:extensionElements>
            <zeebe:taskDefinition type="t"/></bpmn:extensionElements></bpmn:serviceTask>
            <bpmn:sequenceFlow id="f1" sourceRef="island_a" targetRef="island_b"/>
            <bpmn:sequenceFlow id="f2" sourceRef="island_b" targetRef="island_a"/>''' + tail)
    elif shape == "no_default":
        xml = xml.replace(' default="flow_decide_skip"', "")
        xml = xml.replace('targetRef="end_skip" />', 'targetRef="end_skip">'
                          + cond.format("= x &gt;= 15") + "</bpmn:sequenceFlow>")
    elif shape == "condition_outside":
        xml = xml.replace("= x &lt; 15", "= x &lt; 15.5")
    elif shape == "condition_not_on_gateway":
        xml = xml.replace('<bpmn:sequenceFlow id="flow_a_join" sourceRef="a" targetRef="join" />',
                          '<bpmn:sequenceFlow id="flow_a_join" sourceRef="a" targetRef="join">'
                          + cond.format("= x &gt; 1") + "</bpmn:sequenceFlow>")
    elif shape == "fork_and_join_at_once":
        xml = xml.replace(tail, '<bpmn:endEvent id="end_join"/><bpmn:sequenceFlow '
                          'id="flow_join_more" sourceRef="join" targetRef="end_join"/>' + tail)
    else:
        xml = xml.replace(tail, '<bpmn:endEvent id="end_c"/><bpmn:sequenceFlow '
                          'id="flow_c_more" sourceRef="c" targetRef="end_c"/>' + tail)
    with pytest.raises(ValueError, match=at):
        bpmn.parse(xml)


@pytest.mark.parametrize("text,holds", [
    ("= x < 10", [x < 10 for x in XS]),
    ("=x >= 10 and x <= 19 or x = 3", [10 <= x <= 19 or x == 3 for x in XS]),
    ("= (x > 17 and x < 25) or (x >= 15 and x = 29)", [17 < x < 25 or x == 29 for x in XS]),
    ("x != 4 and (x = 3 or x = 4 or x > 27)", [x in (3, 28, 29) for x in XS]),
    ("= x > -1 and not_x < 3", None)])
def test_the_feel_subset(text, holds):
    condition = feel.parse(text)
    if holds is None:
        with pytest.raises(ValueError, match="not_x"):
            [condition.holds({"x": x}) for x in XS]
    else:
        assert [condition.holds({"x": x}) for x in XS] == holds


@pytest.mark.parametrize("text", ["", "=", "x", "x <", "x < y", "10 > x", "x < 1.5",
                                  "x < 1 and", "(x < 1", "x < 1)", "not(x < 1)",
                                  'x = "a"', "x in [1, 2]", "x + 1 > 3", "x < 1 && x > 0",
                                  "and < 3"])
def test_feel_outside_the_subset_is_refused(text):
    with pytest.raises(ValueError):
        feel.parse(text)
