# tests/test_engine_mi_callactivity.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Multi-instance body + call activity tests.

Mirrors the reference suites engine/src/test/java/io/camunda/zeebe/engine/
processing/bpmn/activity/{MultiInstanceActivityTest,CallActivityTest}.java:
assertions are on the exported event stream, reference-style.
"""

import pytest

from zeebe_tpu_torch.models.bpmn import Bpmn
from zeebe_tpu_torch.protocol import ValueType
from zeebe_tpu_torch.protocol.enums import BpmnElementType, ErrorType
from zeebe_tpu_torch.protocol.intent import (
    IncidentIntent,
    JobIntent,
    ProcessInstanceIntent as PI,
    VariableIntent,
)
from zeebe_tpu_torch.testing import EngineHarness


@pytest.fixture
def harness(tmp_path):
    h = EngineHarness(tmp_path, device="cpu")
    yield h
    h.close()


def mi_process(sequential: bool = False):
    return (
        Bpmn.create_executable_process("mi_proc")
        .start_event("start")
        .service_task("task", job_type="work")
        .multi_instance(
            input_collection="=items",
            input_element="item",
            output_collection="results",
            output_element="=result",
            sequential=sequential,
        )
        .end_event("end")
        .done()
    )


def body_records(harness):
    return [
        r for r in harness.exporter.process_instance_records().events().to_list()
        if r.record.value.get("bpmnElementType") == BpmnElementType.MULTI_INSTANCE_BODY.name
    ]


class TestParallelMultiInstance:
    def test_creates_one_job_per_item(self, harness):
        harness.deploy(mi_process())
        harness.create_instance("mi_proc", variables={"items": [10, 20, 30]})
        jobs = harness.activate_jobs("work")
        assert len(jobs) == 3

    def test_body_lifecycle_events(self, harness):
        harness.deploy(mi_process())
        pi = harness.create_instance("mi_proc", variables={"items": [1, 2]})
        for job in harness.activate_jobs("work"):
            harness.complete_job(job["key"], variables={"result": job["key"]})
        intents = [r.record.intent for r in body_records(harness)]
        assert intents == [
            PI.ELEMENT_ACTIVATING, PI.ELEMENT_ACTIVATED,
            PI.ELEMENT_COMPLETING, PI.ELEMENT_COMPLETED,
        ]
        assert harness.is_instance_done(pi)

    def test_input_element_variable_per_instance(self, harness):
        harness.deploy(mi_process())
        harness.create_instance("mi_proc", variables={"items": ["a", "b"]})
        item_vars = (
            harness.exporter.variable_records()
            .with_intent(VariableIntent.CREATED)
            .to_list()
        )
        values = sorted(
            r.record.value["value"] for r in item_vars if r.record.value["name"] == "item"
        )
        assert values == ["a", "b"]

    def test_output_collection_collects_results(self, harness):
        harness.deploy(mi_process())
        pi = harness.create_instance("mi_proc", variables={"items": [1, 2, 3]})
        for i, job in enumerate(harness.activate_jobs("work")):
            harness.complete_job(job["key"], variables={"result": (i + 1) * 100})
        results = [
            r.record.value["value"]
            for r in harness.exporter.variable_records().to_list()
            if r.record.value["name"] == "results"
        ]
        # last write is the fully-collected list, propagated to the root scope
        assert results[-1] == [100, 200, 300]
        assert harness.is_instance_done(pi)

    def test_empty_collection_completes_immediately(self, harness):
        harness.deploy(mi_process())
        pi = harness.create_instance("mi_proc", variables={"items": []})
        assert harness.is_instance_done(pi)
        assert [r.record.intent for r in body_records(harness)] == [
            PI.ELEMENT_ACTIVATING, PI.ELEMENT_ACTIVATED,
            PI.ELEMENT_COMPLETING, PI.ELEMENT_COMPLETED,
        ]

    def test_non_array_collection_raises_incident(self, harness):
        harness.deploy(mi_process())
        harness.create_instance("mi_proc", variables={"items": "nope"})
        incident = (
            harness.exporter.incident_records().with_intent(IncidentIntent.CREATED).first()
        )
        assert incident.record.value["errorType"] == ErrorType.EXTRACT_VALUE_ERROR.name
        assert "array" in incident.record.value["errorMessage"]

    def test_incident_resolution_retries_body_activation(self, harness):
        harness.deploy(mi_process())
        pi = harness.create_instance("mi_proc", variables={"items": "nope"})
        incident = (
            harness.exporter.incident_records().with_intent(IncidentIntent.CREATED).first()
        )
        harness.set_variables(pi, {"items": [5]})
        harness.resolve_incident(incident.record.key)
        jobs = harness.activate_jobs("work")
        assert len(jobs) == 1
        harness.complete_job(jobs[0]["key"], variables={"result": 1})
        assert harness.is_instance_done(pi)

    def test_null_item_creates_null_input_element(self, harness):
        harness.deploy(mi_process())
        harness.create_instance("mi_proc", variables={"items": [None]})
        item_vars = [
            r.record.value
            for r in harness.exporter.variable_records()
            .with_intent(VariableIntent.CREATED)
            .to_list()
            if r.record.value["name"] == "item"
        ]
        assert len(item_vars) == 1 and item_vars[0]["value"] is None

    def test_output_element_eval_failure_raises_incident(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("mi_bad_out")
            .start_event("s")
            .service_task("task", job_type="work")
            .multi_instance(
                input_collection="=items", input_element="item",
                output_collection="results", output_element="=-missing",
            )
            .end_event("e")
            .done()
        )
        harness.create_instance("mi_bad_out", variables={"items": [1]})
        jobs = harness.activate_jobs("work")
        harness.complete_job(jobs[0]["key"])
        assert (
            harness.exporter.incident_records().with_intent(IncidentIntent.CREATED).exists()
        )

    def test_cancel_terminates_inner_instances(self, harness):
        harness.deploy(mi_process())
        pi = harness.create_instance("mi_proc", variables={"items": [1, 2]})
        harness.activate_jobs("work")
        harness.cancel_instance(pi)
        assert harness.is_instance_done(pi)
        terminated = (
            harness.exporter.process_instance_records()
            .with_intent(PI.ELEMENT_TERMINATED)
            .to_list()
        )
        # 2 inner instances + body + process root
        assert len(terminated) == 4


class TestSequentialMultiInstance:
    def test_one_job_at_a_time(self, harness):
        harness.deploy(mi_process(sequential=True))
        pi = harness.create_instance("mi_proc", variables={"items": [1, 2, 3]})
        seen = 0
        for _ in range(3):
            jobs = harness.activate_jobs("work")
            assert len(jobs) == 1
            seen += 1
            harness.complete_job(jobs[0]["key"], variables={"result": seen})
        assert seen == 3
        assert harness.is_instance_done(pi)
        results = [
            r.record.value["value"]
            for r in harness.exporter.variable_records().to_list()
            if r.record.value["name"] == "results"
        ]
        assert results[-1] == [1, 2, 3]

    def test_loop_counters_in_order(self, harness):
        harness.deploy(mi_process(sequential=True))
        harness.create_instance("mi_proc", variables={"items": ["x", "y"]})
        for _ in range(2):
            jobs = harness.activate_jobs("work")
            harness.complete_job(jobs[0]["key"])
        inner_activated = [
            r.record.value.get("loopCounter")
            for r in harness.exporter.process_instance_records()
            .with_intent(PI.ELEMENT_ACTIVATED)
            .with_element_id("task")
            .to_list()
            if r.record.value.get("bpmnElementType") == BpmnElementType.SERVICE_TASK.name
        ]
        assert inner_activated == [1, 2]


class TestCallActivity:
    def child(self):
        return (
            Bpmn.create_executable_process("child_proc")
            .start_event("cs")
            .service_task("child_task", job_type="child_work")
            .end_event("ce")
            .done()
        )

    def parent(self, **call_kw):
        b = (
            Bpmn.create_executable_process("parent_proc")
            .start_event("ps")
            .call_activity("call", process_id="child_proc")
        )
        for source, target in call_kw.get("outputs", []):
            b = b.zeebe_output(source, target)
        return b.end_event("pe").done()

    def test_child_instance_created_and_completes_parent(self, harness):
        harness.deploy(self.child(), self.parent())
        pi = harness.create_instance("parent_proc")
        jobs = harness.activate_jobs("child_work")
        assert len(jobs) == 1
        assert jobs[0]["bpmnProcessId"] == "child_proc"
        harness.complete_job(jobs[0]["key"])
        assert harness.is_instance_done(pi)
        # the child root carries the parent back-links
        child_root = (
            harness.exporter.process_instance_records()
            .with_intent(PI.ELEMENT_ACTIVATED)
            .with_element_id("child_proc")
            .first()
        )
        assert child_root.record.value["parentProcessInstanceKey"] == pi

    def test_parent_variables_copied_to_child(self, harness):
        harness.deploy(self.child(), self.parent())
        harness.create_instance("parent_proc", variables={"order_id": 42})
        jobs = harness.activate_jobs("child_work")
        assert jobs[0]["variables"].get("order_id") == 42

    def test_output_mapping_reads_child_variables(self, harness):
        harness.deploy(self.child(), self.parent(outputs=[("=answer", "parent_answer")]))
        pi = harness.create_instance("parent_proc")
        jobs = harness.activate_jobs("child_work")
        harness.complete_job(jobs[0]["key"], variables={"answer": 7})
        assert harness.is_instance_done(pi)
        mapped = [
            r.record.value
            for r in harness.exporter.variable_records().to_list()
            if r.record.value["name"] == "parent_answer"
        ]
        assert mapped and mapped[-1]["value"] == 7

    def test_child_variables_propagate_by_default(self, harness):
        # reference default: propagateAllChildVariables=true — without output
        # mappings a downstream task still sees the child's result
        harness.deploy(
            self.child(),
            Bpmn.create_executable_process("parent_proc")
            .start_event("ps")
            .call_activity("call", process_id="child_proc")
            .service_task("after", job_type="after_work")
            .end_event("pe")
            .done(),
        )
        harness.create_instance("parent_proc")
        jobs = harness.activate_jobs("child_work")
        harness.complete_job(jobs[0]["key"], variables={"answer": 7})
        after = harness.activate_jobs("after_work")
        assert after and after[0]["variables"].get("answer") == 7

    def test_unknown_called_process_resolved_after_deploy(self, harness):
        harness.deploy(self.parent())
        pi = harness.create_instance("parent_proc")
        incident = (
            harness.exporter.incident_records().with_intent(IncidentIntent.CREATED).first()
        )
        harness.deploy(self.child())
        harness.resolve_incident(incident.record.key)
        jobs = harness.activate_jobs("child_work")
        assert len(jobs) == 1
        harness.complete_job(jobs[0]["key"])
        assert harness.is_instance_done(pi)

    def test_unknown_called_process_raises_incident(self, harness):
        harness.deploy(self.parent())
        harness.create_instance("parent_proc")
        incident = (
            harness.exporter.incident_records().with_intent(IncidentIntent.CREATED).first()
        )
        assert incident.record.value["errorType"] == ErrorType.CALLED_ELEMENT_ERROR.name

    def test_cancel_parent_terminates_child(self, harness):
        harness.deploy(self.child(), self.parent())
        pi = harness.create_instance("parent_proc")
        harness.activate_jobs("child_work")
        harness.cancel_instance(pi)
        assert harness.is_instance_done(pi)
        # child root must be terminated too
        assert (
            harness.exporter.process_instance_records()
            .with_intent(PI.ELEMENT_TERMINATED)
            .with_element_id("child_proc")
            .exists()
        )
        # the child's job is canceled
        assert harness.exporter.job_records().with_intent(JobIntent.CANCELED).exists()
