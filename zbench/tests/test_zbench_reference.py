"""The reference against the port's sequential engine on the CPU, and the
judge failing a perturbed log, a lost acknowledged create, a wrong reply
and a replica that differs."""

import copy

import pytest

from zbench import cells
from zbench.reference import bpmn
from zbench.reference.judge import compare_instance, group_by_instance, judge
from zbench.reference.expect import instance_records

WORKER = "zbench-worker"


def _engine_run(model: str, xs: list[int]):
    """The sequential engine (no kernel backend) on the CPU: deploy, create
    one instance per x, complete every job wave by wave. Returns the
    process, the log as the judge reads it, the create replies and the
    instance keys."""
    from zeebe_tpu_torch.testing import EngineHarness

    xml = (cells.ROOT / "zbench" / "models" / f"{model}.bpmn").read_text()
    process = bpmn.parse(xml)
    h = EngineHarness()
    try:
        h.deploy((f"{model}.bpmn", xml))
        keys = [h.create_instance(process.process_id, {"x": x}, request_id=10 + i)
                for i, x in enumerate(xs)]
        for _ in process.tasks:
            for job in h.activate_jobs(process.job_types[0], worker=WORKER, max_jobs=100):
                h.complete_job(job["key"])
        log = []
        for logged in h.stream.new_reader(1):
            rec = logged.record
            log.append({"position": logged.position, "source": logged.source_position,
                        "processed": logged.processed, "recordType": rec.record_type.name,
                        "valueType": rec.value_type.name, "intent": rec.intent.name,
                        "key": rec.key, "value": rec.value})
    finally:
        h.close()
    return process, log, keys


@pytest.fixture(scope="module", params=["one_task", "ten_tasks"])
def engine_run(request):
    return _engine_run(request.param, [3, 17, 29, 0])


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
