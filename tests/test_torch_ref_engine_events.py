# tests/test_engine_events.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Error, escalation, and signal events + event sub-processes.

Reference suites: engine/src/test/java/io/camunda/zeebe/engine/processing/bpmn/
event/{error,escalation,signal}/ and processing/bpmn/subprocess/
EventSubprocessTest; CatchEventAnalyzer semantics from processing/common/.
"""

import pytest

from zeebe_tpu_torch.models.bpmn import Bpmn
from zeebe_tpu_torch.models.bpmn.executable import ProcessValidationError, transform
from zeebe_tpu_torch.protocol.intent import (
    EscalationIntent,
    IncidentIntent,
    JobIntent,
    ProcessInstanceIntent as PI,
    SignalIntent,
    SignalSubscriptionIntent,
)
from zeebe_tpu_torch.testing import EngineHarness
import torch_kernel_flows; torch_kernel_flows.port_module("test_engine_replay"); from _kflows_zeebe_tpu_torch_test_engine_replay import assert_replay_equals_processing


@pytest.fixture
def harness(tmp_path):
    h = EngineHarness(tmp_path, device="cpu")
    yield h
    h.close()


def _completed(harness, element_id):
    return (
        harness.exporter.process_instance_records()
        .with_element_id(element_id)
        .with_intent(PI.ELEMENT_COMPLETED)
        .exists()
    )


def _terminated(harness, element_id):
    return (
        harness.exporter.process_instance_records()
        .with_element_id(element_id)
        .with_intent(PI.ELEMENT_TERMINATED)
        .exists()
    )


class TestErrorEvents:
    def test_job_error_caught_by_boundary(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("err")
            .start_event()
            .service_task("work", job_type="w")
            .end_event("e-ok")
            .boundary_error("catch", attached_to="work", error_code="E-42")
            .service_task("handle", job_type="handler")
            .end_event("e-err")
            .done()
        )
        pi = harness.create_instance("err")
        [job] = harness.activate_jobs("w")
        harness.throw_job_error(job["key"], "E-42", "boom")
        assert harness.exporter.job_records().with_intent(JobIntent.ERROR_THROWN).exists()
        assert _terminated(harness, "work")
        assert _completed(harness, "catch")
        [handler] = harness.activate_jobs("handler")
        harness.complete_job(handler["key"])
        assert harness.is_instance_done(pi)

    def test_error_end_event_caught_by_subprocess_boundary(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("err2")
            .start_event()
            .sub_process("sp")
            .start_event("sp-start")
            .end_event_error("sp-err", error_code="E-1")
            .sub_process_done()
            .end_event("e-ok")
            .boundary_error("catch", attached_to="sp", error_code="E-1")
            .end_event("e-handled")
            .done()
        )
        pi = harness.create_instance("err2")
        assert _terminated(harness, "sp")
        assert _completed(harness, "catch")
        assert _completed(harness, "e-handled")
        assert harness.is_instance_done(pi)

    def test_catch_all_boundary_and_specific_priority(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("err3")
            .start_event()
            .service_task("work", job_type="w")
            .end_event()
            .boundary_error("specific", attached_to="work", error_code="E-1")
            .service_task("h1", job_type="h1")
            .end_event()
            .boundary_error("catchall", attached_to="work", error_code=None)
            .service_task("h2", job_type="h2")
            .end_event()
            .done()
        )
        harness.create_instance("err3")
        [job] = harness.activate_jobs("w")
        harness.throw_job_error(job["key"], "E-1")
        # the specific code match wins over the catch-all
        assert len(harness.activate_jobs("h1")) == 1
        assert harness.activate_jobs("h2") == []

    def test_error_caught_by_event_sub_process(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("err4")
            .start_event()
            .service_task("work", job_type="w")
            .end_event("e-ok")
            .event_sub_process("esp")
            .error_start_event("esp-start", error_code="E-9")
            .service_task("compensate", job_type="comp")
            .end_event("esp-end")
            .sub_process_done()
            .done()
        )
        pi = harness.create_instance("err4")
        [job] = harness.activate_jobs("w")
        harness.throw_job_error(job["key"], "E-9")
        assert _terminated(harness, "work")
        [comp] = harness.activate_jobs("comp")
        harness.complete_job(comp["key"])
        assert _completed(harness, "esp")
        assert harness.is_instance_done(pi)

    def test_error_propagates_across_call_activity(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("child")
            .start_event()
            .end_event_error("child-err", error_code="E-X")
            .done()
        )
        harness.deploy(
            Bpmn.create_executable_process("parent")
            .start_event()
            .call_activity("call", process_id="child")
            .end_event("e-ok")
            .boundary_error("catch", attached_to="call", error_code="E-X")
            .end_event("e-caught")
            .done()
        )
        pi = harness.create_instance("parent")
        assert _completed(harness, "catch")
        assert _completed(harness, "e-caught")
        assert _terminated(harness, "call")
        assert harness.is_instance_done(pi)

    def test_unhandled_job_error_raises_incident(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("err5")
            .start_event()
            .service_task("work", job_type="w")
            .end_event()
            .done()
        )
        harness.create_instance("err5")
        [job] = harness.activate_jobs("w")
        harness.throw_job_error(job["key"], "E-UNCAUGHT")
        incident = (
            harness.exporter.incident_records().with_intent(IncidentIntent.CREATED).first()
        )
        assert incident.record.value["errorType"] == "UNHANDLED_ERROR_EVENT"
        # the job is consumed: not activatable again
        assert harness.activate_jobs("w") == []

    def test_unhandled_error_end_event_incident_is_retryable(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("err6")
            .start_event()
            .sub_process("sp")
            .start_event("sps")
            .end_event_error("oops", error_code="E-MISSING")
            .sub_process_done()
            .end_event()
            .done()
        )
        harness.create_instance("err6")
        incident = (
            harness.exporter.incident_records().with_intent(IncidentIntent.CREATED).first()
        )
        assert incident.record.value["errorType"] == "UNHANDLED_ERROR_EVENT"
        # the end event stays ACTIVATING — no COMPLETED/ACTIVATED record
        assert not (
            harness.exporter.process_instance_records()
            .with_element_id("oops")
            .with_intent(PI.ELEMENT_ACTIVATED)
            .exists()
        )

    def test_replay_parity(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("err7")
            .start_event()
            .service_task("work", job_type="w")
            .end_event()
            .boundary_error("catch", attached_to="work", error_code="E-1")
            .end_event("e2")
            .done()
        )
        harness.create_instance("err7")
        [job] = harness.activate_jobs("w")
        harness.throw_job_error(job["key"], "E-1")
        assert_replay_equals_processing(harness)


class TestEscalationEvents:
    def test_escalation_end_event_caught_by_boundary(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("esc1")
            .start_event()
            .sub_process("sp")
            .start_event("sps")
            .end_event_escalation("esc-end", escalation_code="ESC-1")
            .sub_process_done()
            .end_event("after-sp")
            .boundary_escalation("catch", attached_to="sp", escalation_code="ESC-1",
                                 interrupting=True)
            .end_event("e-caught")
            .done()
        )
        pi = harness.create_instance("esc1")
        esc = harness.exporter.escalation_records().with_intent(EscalationIntent.ESCALATED)
        assert esc.exists()
        rec = esc.first().record.value
        assert rec["escalationCode"] == "ESC-1"
        assert rec["catchElementId"] == "catch"
        assert _terminated(harness, "sp")
        assert _completed(harness, "e-caught")
        assert not _completed(harness, "after-sp")
        assert harness.is_instance_done(pi)

    def test_non_interrupting_escalation_boundary(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("esc2")
            .start_event()
            .sub_process("sp")
            .start_event("sps")
            .intermediate_throw_escalation("esc-throw", escalation_code="ESC-2")
            .service_task("inside", job_type="inside")
            .end_event("sp-end")
            .sub_process_done()
            .end_event("main-end")
            .boundary_escalation("catch", attached_to="sp", escalation_code="ESC-2",
                                 interrupting=False)
            .service_task("extra", job_type="extra")
            .end_event("extra-end")
            .done()
        )
        pi = harness.create_instance("esc2")
        # throw event completed (non-interrupting catcher), sub-process continues
        assert _completed(harness, "esc-throw")
        [inside] = harness.activate_jobs("inside")
        [extra] = harness.activate_jobs("extra")
        harness.complete_job(inside["key"])
        harness.complete_job(extra["key"])
        assert harness.is_instance_done(pi)

    def test_uncaught_escalation_continues(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("esc3")
            .start_event()
            .intermediate_throw_escalation("t", escalation_code="NOBODY")
            .end_event("done")
            .done()
        )
        pi = harness.create_instance("esc3")
        assert (
            harness.exporter.escalation_records()
            .with_intent(EscalationIntent.NOT_ESCALATED)
            .exists()
        )
        # no incident; process completed normally
        assert not harness.exporter.incident_records().with_intent(IncidentIntent.CREATED).exists()
        assert harness.is_instance_done(pi)

    def test_escalation_caught_by_event_sub_process(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("esc4")
            .start_event()
            .end_event_escalation("esc-end", escalation_code="UP")
            .event_sub_process("esp")
            .escalation_start_event("esp-start", escalation_code="UP", interrupting=False)
            .service_task("note", job_type="note")
            .end_event()
            .sub_process_done()
            .done()
        )
        harness.create_instance("esc4")
        assert len(harness.activate_jobs("note")) == 1

    def test_replay_parity(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("esc5")
            .start_event()
            .intermediate_throw_escalation("t", escalation_code="X")
            .end_event()
            .done()
        )
        harness.create_instance("esc5")
        assert_replay_equals_processing(harness)


class TestSignalEvents:
    def test_signal_start_event_creates_instance(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("sig-start")
            .signal_start_event("s", "alarm")
            .service_task("react", job_type="react")
            .end_event()
            .done()
        )
        assert (
            harness.exporter.signal_subscription_records()
            .with_intent(SignalSubscriptionIntent.CREATED)
            .exists()
        )
        harness.broadcast_signal("alarm", variables={"level": 3})
        assert harness.exporter.signal_records().with_intent(SignalIntent.BROADCASTED).exists()
        jobs = harness.activate_jobs("react")
        assert len(jobs) == 1
        assert jobs[0]["variables"]["level"] == 3

    def test_intermediate_signal_catch(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("sig-catch")
            .start_event()
            .intermediate_catch_signal("wait", "go")
            .service_task("after", job_type="after")
            .end_event()
            .done()
        )
        pi = harness.create_instance("sig-catch")
        assert harness.activate_jobs("after") == []
        harness.broadcast_signal("go")
        [job] = harness.activate_jobs("after")
        harness.complete_job(job["key"])
        assert harness.is_instance_done(pi)

    def test_interrupting_signal_boundary(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("sig-b")
            .start_event()
            .service_task("work", job_type="w")
            .end_event()
            .boundary_signal("catch", attached_to="work", signal_name="abort")
            .end_event("aborted")
            .done()
        )
        pi = harness.create_instance("sig-b")
        harness.broadcast_signal("abort")
        assert _terminated(harness, "work")
        assert _completed(harness, "catch")
        assert harness.is_instance_done(pi)

    def test_signal_subscription_closed_on_completion(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("sig-c")
            .start_event()
            .service_task("work", job_type="w")
            .end_event()
            .boundary_signal("catch", attached_to="work", signal_name="late")
            .end_event()
            .done()
        )
        pi = harness.create_instance("sig-c")
        [job] = harness.activate_jobs("w")
        harness.complete_job(job["key"])
        assert harness.is_instance_done(pi)
        assert (
            harness.exporter.signal_subscription_records()
            .with_intent(SignalSubscriptionIntent.DELETED)
            .exists()
        )
        # broadcasting after completion triggers nothing
        harness.broadcast_signal("late")
        assert not _completed(harness, "catch")

    def test_signal_throw_event_broadcasts(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("sig-listen")
            .signal_start_event("s", "ping")
            .service_task("pong", job_type="pong")
            .end_event()
            .done()
        )
        harness.deploy(
            Bpmn.create_executable_process("sig-throw")
            .start_event()
            .intermediate_throw_signal("t", "ping")
            .end_event()
            .done()
        )
        pi = harness.create_instance("sig-throw")
        assert harness.is_instance_done(pi)
        # the broadcast started the listening process
        assert len(harness.activate_jobs("pong")) == 1

    def test_replay_parity(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("sig-r")
            .start_event()
            .intermediate_catch_signal("wait", "go")
            .end_event()
            .done()
        )
        harness.create_instance("sig-r")
        harness.broadcast_signal("go", variables={"a": 1})
        assert_replay_equals_processing(harness)


class TestEventSubProcess:
    def test_interrupting_timer_esp(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("esp-t")
            .start_event()
            .service_task("slow", job_type="slow")
            .end_event("main-end")
            .event_sub_process("esp")
            .timer_start_event("esp-start", duration="PT30S")
            .service_task("timeout-handler", job_type="th")
            .end_event()
            .sub_process_done()
            .done()
        )
        pi = harness.create_instance("esp-t")
        assert len(harness.activate_jobs("slow")) == 1
        harness.advance_time(30_000)
        assert _terminated(harness, "slow")
        [th] = harness.activate_jobs("th")
        harness.complete_job(th["key"])
        assert harness.is_instance_done(pi)

    def test_non_interrupting_timer_esp_repeats(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("esp-n")
            .start_event()
            .service_task("slow", job_type="slow")
            .end_event()
            .event_sub_process("esp")
            .timer_start_event("esp-start", cycle="R2/PT10S", interrupting=False)
            .service_task("tick", job_type="tick")
            .end_event()
            .sub_process_done()
            .done()
        )
        pi = harness.create_instance("esp-n")
        harness.advance_time(10_000)
        [tick1] = harness.activate_jobs("tick")
        # host task is NOT terminated
        assert not _terminated(harness, "slow")
        harness.advance_time(10_000)
        [tick2] = harness.activate_jobs("tick")
        # finish everything
        harness.complete_job(tick1["key"])
        harness.complete_job(tick2["key"])
        [slow] = harness.activate_jobs("slow")
        harness.complete_job(slow["key"])
        assert harness.is_instance_done(pi)

    def test_message_esp_interrupting(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("esp-m")
            .start_event()
            .service_task("slow", job_type="slow")
            .end_event()
            .event_sub_process("esp")
            .message_start_event("esp-start", "cancel-order", correlation_key="=orderId")
            .service_task("cancel", job_type="cancel")
            .end_event()
            .sub_process_done()
            .done()
        )
        pi = harness.create_instance("esp-m", variables={"orderId": "o-77"})
        harness.publish_message("cancel-order", "o-77")
        assert _terminated(harness, "slow")
        [c] = harness.activate_jobs("cancel")
        harness.complete_job(c["key"])
        assert harness.is_instance_done(pi)

    def test_signal_esp(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("esp-s")
            .start_event()
            .service_task("slow", job_type="slow")
            .end_event()
            .event_sub_process("esp")
            .signal_start_event("esp-start", "red-alert")
            .service_task("drill", job_type="drill")
            .end_event()
            .sub_process_done()
            .done()
        )
        harness.create_instance("esp-s")
        harness.broadcast_signal("red-alert")
        assert _terminated(harness, "slow")
        assert len(harness.activate_jobs("drill")) == 1

    def test_esp_in_sub_process_scope(self, harness):
        # an ESP inside an embedded sub-process only interrupts that scope
        harness.deploy(
            Bpmn.create_executable_process("esp-sp")
            .start_event()
            .parallel_gateway("fork")
            .service_task("outside", job_type="outside")
            .end_event()
            .move_to_element("fork")
            .sub_process("sp")
            .start_event("sps")
            .service_task("inside", job_type="inside")
            .end_event()
            .event_sub_process("esp")
            .timer_start_event("esp-start", duration="PT5S")
            .end_event("esp-end")
            .sub_process_done()
            .sub_process_done()
            .end_event()
            .done()
        )
        pi = harness.create_instance("esp-sp")
        harness.advance_time(5_000)
        assert _terminated(harness, "inside")
        assert not _terminated(harness, "outside")
        [j] = harness.activate_jobs("outside")
        harness.complete_job(j["key"])
        assert harness.is_instance_done(pi)

    def test_validation_esp_needs_typed_start(self):
        with pytest.raises(ProcessValidationError, match="typed"):
            transform(
                Bpmn.create_executable_process("bad")
                .start_event()
                .end_event()
                .event_sub_process("esp")
                .start_event("esp-start")  # none start — invalid for ESP
                .end_event()
                .sub_process_done()
                .done()
            )

    def test_replay_parity(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("esp-r")
            .start_event()
            .service_task("slow", job_type="slow")
            .end_event()
            .event_sub_process("esp")
            .timer_start_event("esp-start", duration="PT30S")
            .end_event()
            .sub_process_done()
            .done()
        )
        harness.create_instance("esp-r")
        harness.advance_time(30_000)
        assert_replay_equals_processing(harness)
