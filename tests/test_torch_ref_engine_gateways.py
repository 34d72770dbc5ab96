# tests/test_engine_gateways.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Gateway semantics: event-based gateway (first event wins), inclusive
gateway fork, terminate end events.

Reference suites: engine/src/test/java/io/camunda/zeebe/engine/processing/bpmn/
gateway/ (EventbasedGatewayTest, InclusiveGatewayTest) and
processinstance/TerminateEndEventTest; validators from
bpmn-model/…/validation/zeebe/{EventBasedGatewayValidator,InclusiveGatewayValidator}.
"""

import pytest

from zeebe_tpu_torch.models.bpmn import Bpmn
from zeebe_tpu_torch.models.bpmn.executable import ProcessValidationError, transform
from zeebe_tpu_torch.protocol.intent import (
    IncidentIntent,
    JobIntent,
    ProcessInstanceIntent as PI,
    TimerIntent,
)
from zeebe_tpu_torch.testing import EngineHarness
import torch_kernel_flows; torch_kernel_flows.port_module("test_engine_replay"); from _kflows_zeebe_tpu_torch_test_engine_replay import assert_replay_equals_processing


@pytest.fixture
def harness(tmp_path):
    h = EngineHarness(tmp_path, device="cpu")
    yield h
    h.close()


def event_gateway_process():
    return (
        Bpmn.create_executable_process("evgw")
        .start_event("s")
        .event_based_gateway("gw")
        .intermediate_catch_timer("t1", duration="PT10S")
        .service_task("after-timer", job_type="timer-path")
        .end_event("e1")
        .move_to_element("gw")
        .intermediate_catch_message("m1", message_name="go", correlation_key="=key")
        .service_task("after-msg", job_type="msg-path")
        .end_event("e2")
        .done()
    )


class TestEventBasedGateway:
    def test_timer_path_wins(self, harness):
        harness.deploy(event_gateway_process())
        pi = harness.create_instance("evgw", variables={"key": "k-1"})
        # gateway is waiting on both events
        assert (
            harness.exporter.process_instance_records()
            .with_element_id("gw")
            .with_intent(PI.ELEMENT_ACTIVATED)
            .exists()
        )
        harness.advance_time(10_000)
        # gateway completed toward the timer event; catch event passed through
        assert (
            harness.exporter.process_instance_records()
            .with_element_id("gw")
            .with_intent(PI.ELEMENT_COMPLETED)
            .exists()
        )
        assert (
            harness.exporter.process_instance_records()
            .with_element_id("t1")
            .with_intent(PI.ELEMENT_COMPLETED)
            .exists()
        )
        jobs = harness.activate_jobs("timer-path")
        assert len(jobs) == 1
        # the message path was not taken and its subscription is closed:
        # publishing afterwards must not activate the message branch
        harness.publish_message("go", "k-1")
        assert harness.activate_jobs("msg-path") == []
        harness.complete_job(jobs[0]["key"])
        assert harness.is_instance_done(pi)

    def test_message_path_wins(self, harness):
        harness.deploy(event_gateway_process())
        pi = harness.create_instance("evgw", variables={"key": "k-2"})
        harness.publish_message("go", "k-2", variables={"fromMsg": 41})
        assert (
            harness.exporter.process_instance_records()
            .with_element_id("m1")
            .with_intent(PI.ELEMENT_COMPLETED)
            .exists()
        )
        jobs = harness.activate_jobs("msg-path")
        assert len(jobs) == 1
        # timer canceled with the losing branch
        assert harness.exporter.timer_records().with_intent(TimerIntent.CANCELED).exists()
        harness.advance_time(20_000)
        assert harness.activate_jobs("timer-path") == []
        harness.complete_job(jobs[0]["key"])
        assert harness.is_instance_done(pi)

    def test_no_sequence_flow_taken_for_triggered_event(self, harness):
        # per BPMN spec the flow gateway→event is not taken (reference:
        # EventBasedGatewayProcessor.onComplete comment)
        harness.deploy(event_gateway_process())
        harness.create_instance("evgw", variables={"key": "k-3"})
        flows_before = len(
            harness.exporter.process_instance_records()
            .with_intent(PI.SEQUENCE_FLOW_TAKEN)
            .to_list()
        )
        harness.advance_time(10_000)
        taken = (
            harness.exporter.process_instance_records()
            .with_intent(PI.SEQUENCE_FLOW_TAKEN)
            .to_list()
        )
        # only the flow t1 → after-timer is taken, not gw → t1
        new_flows = taken[flows_before:]
        assert all(
            r.record.value["elementId"] != "gw-to-t1" for r in new_flows
        )
        assert len(new_flows) == 1

    def test_replay_parity(self, harness):
        harness.deploy(event_gateway_process())
        harness.create_instance("evgw", variables={"key": "k-4"})
        harness.publish_message("go", "k-4")
        assert_replay_equals_processing(harness)

    def test_validation_needs_two_flows(self):
        with pytest.raises(ProcessValidationError, match="at least 2 outgoing"):
            transform(
                Bpmn.create_executable_process("bad")
                .start_event()
                .event_based_gateway("gw")
                .intermediate_catch_timer("t", duration="PT1S")
                .end_event()
                .done()
            )

    def test_validation_rejects_task_target(self):
        with pytest.raises(ProcessValidationError, match="intermediate catch events"):
            transform(
                Bpmn.create_executable_process("bad")
                .start_event()
                .event_based_gateway("gw")
                .intermediate_catch_timer("t", duration="PT1S")
                .end_event()
                .move_to_element("gw")
                .service_task("svc", job_type="x")
                .end_event()
                .done()
            )


class TestInclusiveGateway:
    def deploy_fork(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("incl")
            .start_event("s")
            .inclusive_gateway("split")
            .sequence_flow_id("to-a")
            .condition_expression("x > 1")
            .service_task("a", job_type="work-a")
            .end_event("ea")
            .move_to_element("split")
            .sequence_flow_id("to-b")
            .condition_expression("x > 2")
            .service_task("b", job_type="work-b")
            .end_event("eb")
            .move_to_element("split")
            .sequence_flow_id("to-c")
            .default_flow()
            .service_task("c", job_type="work-c")
            .end_event("ec")
            .done()
        )

    def test_all_true_conditions_taken(self, harness):
        self.deploy_fork(harness)
        pi = harness.create_instance("incl", variables={"x": 5})
        jobs_a = harness.activate_jobs("work-a")
        jobs_b = harness.activate_jobs("work-b")
        assert len(jobs_a) == 1 and len(jobs_b) == 1
        # default not taken when any condition holds
        assert harness.activate_jobs("work-c") == []
        harness.complete_job(jobs_a[0]["key"])
        assert not harness.is_instance_done(pi)
        harness.complete_job(jobs_b[0]["key"])
        assert harness.is_instance_done(pi)

    def test_single_true_condition(self, harness):
        self.deploy_fork(harness)
        harness.create_instance("incl", variables={"x": 2})
        assert len(harness.activate_jobs("work-a")) == 1
        assert harness.activate_jobs("work-b") == []
        assert harness.activate_jobs("work-c") == []

    def test_default_when_none_true(self, harness):
        self.deploy_fork(harness)
        pi = harness.create_instance("incl", variables={"x": 0})
        assert harness.activate_jobs("work-a") == []
        jobs = harness.activate_jobs("work-c")
        assert len(jobs) == 1
        harness.complete_job(jobs[0]["key"])
        assert harness.is_instance_done(pi)

    def test_join_rejected_at_deployment(self):
        # the reference version is fork-only (InclusiveGatewayValidator.java:41-45)
        with pytest.raises(ProcessValidationError, match="one incoming"):
            transform(
                Bpmn.create_executable_process("bad")
                .start_event()
                .parallel_gateway("fork")
                .inclusive_gateway("join")
                .end_event()
                .move_to_element("fork")
                .connect_to("join")
                .done()
            )

    def test_replay_parity(self, harness):
        self.deploy_fork(harness)
        harness.create_instance("incl", variables={"x": 5})
        for jt in ("work-a", "work-b"):
            for job in harness.activate_jobs(jt):
                harness.complete_job(job["key"])
        assert_replay_equals_processing(harness)


class TestTerminateEndEvent:
    def deploy(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("term")
            .start_event("s")
            .parallel_gateway("fork")
            .service_task("long-work", job_type="long-work")
            .end_event("e1")
            .move_to_element("fork")
            .service_task("quick", job_type="quick")
            .end_event_terminate("kill")
            .done()
        )

    def test_terminates_siblings_and_completes_process(self, harness):
        self.deploy(harness)
        pi = harness.create_instance("term")
        [quick] = harness.activate_jobs("quick")
        assert len(harness.activate_jobs("long-work")) == 1
        harness.complete_job(quick["key"])
        # the terminate end event completed, the pending task was terminated,
        # and the process completed without the long-work job finishing
        assert (
            harness.exporter.process_instance_records()
            .with_element_id("kill")
            .with_intent(PI.ELEMENT_COMPLETED)
            .exists()
        )
        assert (
            harness.exporter.process_instance_records()
            .with_element_id("long-work")
            .with_intent(PI.ELEMENT_TERMINATED)
            .exists()
        )
        assert harness.is_instance_done(pi)
        assert harness.exporter.job_records().with_intent(JobIntent.CANCELED).exists()

    def test_terminate_without_siblings(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("solo")
            .start_event("s")
            .end_event_terminate("kill")
            .done()
        )
        pi = harness.create_instance("solo")
        assert harness.is_instance_done(pi)

    def test_replay_parity(self, harness):
        self.deploy(harness)
        harness.create_instance("term")
        [quick] = harness.activate_jobs("quick")
        harness.complete_job(quick["key"])
        assert_replay_equals_processing(harness)


class TestEventBasedGatewayIncidents:
    def test_bad_correlation_key_is_retryable(self, harness):
        # a null correlation key must leave the gateway ACTIVATING with a
        # resolvable incident and NO half-created subscriptions (reference:
        # EventBasedGatewayProcessor subscribes before transitioning)
        harness.deploy(event_gateway_process())
        pi = harness.create_instance("evgw", variables={})  # 'key' undefined
        incident = (
            harness.exporter.incident_records()
            .with_intent(IncidentIntent.CREATED)
            .first()
        )
        assert incident.record.value["errorType"] == "EXTRACT_VALUE_ERROR"
        # no timer may exist from the failed activation attempt
        assert not harness.exporter.timer_records().with_intent(TimerIntent.CREATED).exists()
        harness.set_variables(pi, {"key": "now-set"})
        harness.resolve_incident(incident.record.key)
        # retried activation subscribed exactly once
        assert harness.exporter.timer_records().with_intent(TimerIntent.CREATED).count() == 1
        harness.publish_message("go", "now-set")
        jobs = harness.activate_jobs("msg-path")
        assert len(jobs) == 1
        harness.complete_job(jobs[0]["key"])
        assert harness.is_instance_done(pi)
