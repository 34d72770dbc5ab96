# tests/test_engine_timers_messages.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Timer and message engine tests (reference suites: processing/timer,
processing/message), driven by the controlled clock. Includes replay parity
for the new record types."""

import pytest

from zeebe_tpu_torch.models.bpmn import Bpmn
from zeebe_tpu_torch.protocol import ValueType
from zeebe_tpu_torch.protocol.intent import (
    JobIntent,
    MessageIntent,
    MessageSubscriptionIntent,
    ProcessInstanceIntent as PI,
    ProcessMessageSubscriptionIntent,
    TimerIntent,
)
from zeebe_tpu_torch.testing import EngineHarness
import torch_kernel_flows; torch_kernel_flows.port_module("test_engine_replay"); from _kflows_zeebe_tpu_torch_test_engine_replay import assert_replay_equals_processing


@pytest.fixture
def harness(tmp_path):
    h = EngineHarness(tmp_path, device="cpu")
    yield h
    h.close()


class TestTimerCatchEvent:
    def deploy(self, harness, duration="PT10S"):
        harness.deploy(
            Bpmn.create_executable_process("waiting")
            .start_event("s")
            .intermediate_catch_timer("wait", duration=duration)
            .service_task("after", job_type="after-work")
            .end_event("e")
            .done()
        )

    def test_timer_created_on_activation(self, harness):
        self.deploy(harness)
        harness.create_instance("waiting")
        timer = harness.exporter.timer_records().with_intent(TimerIntent.CREATED).first()
        assert timer.record.value["targetElementId"] == "wait"
        assert timer.record.value["dueDate"] == harness.clock() + 10_000
        # waiting: no job yet
        assert harness.activate_jobs("after-work") == []

    def test_timer_fires_after_due(self, harness):
        self.deploy(harness)
        pi = harness.create_instance("waiting")
        harness.advance_time(9_999)
        assert not harness.exporter.timer_records().with_intent(TimerIntent.TRIGGERED).exists()
        harness.advance_time(1)
        assert harness.exporter.timer_records().with_intent(TimerIntent.TRIGGERED).exists()
        # catch event completed, flow continued to the task
        assert (
            harness.exporter.process_instance_records()
            .with_element_id("wait")
            .with_intent(PI.ELEMENT_COMPLETED)
            .exists()
        )
        jobs = harness.activate_jobs("after-work")
        assert len(jobs) == 1
        harness.complete_job(jobs[0]["key"])
        assert harness.is_instance_done(pi)

    def test_cancel_instance_cancels_timer(self, harness):
        self.deploy(harness)
        pi = harness.create_instance("waiting")
        harness.cancel_instance(pi)
        assert harness.exporter.timer_records().with_intent(TimerIntent.CANCELED).exists()
        # advancing time afterwards must not trigger anything
        harness.advance_time(20_000)
        assert not harness.exporter.timer_records().with_intent(TimerIntent.TRIGGERED).exists()

    def test_replay_parity_with_timers(self, harness):
        self.deploy(harness)
        harness.create_instance("waiting")
        harness.advance_time(10_000)
        assert_replay_equals_processing(harness)


class TestBoundaryTimer:
    def deploy(self, harness, interrupting=True):
        harness.deploy(
            Bpmn.create_executable_process("bnd")
            .start_event("s")
            .service_task("slow", job_type="slow-work")
            .boundary_timer("timeout", attached_to="slow", duration="PT30S",
                            interrupting=interrupting)
            .service_task("escalate", job_type="escalation")
            .end_event("timeout_end")
            .move_to_element("slow")
            .end_event("done_end")
            .done()
        )

    def test_interrupting_boundary_fires(self, harness):
        self.deploy(harness)
        pi = harness.create_instance("bnd")
        harness.advance_time(30_000)
        # host task terminated, boundary path taken
        assert (
            harness.exporter.process_instance_records()
            .with_element_id("slow")
            .with_intent(PI.ELEMENT_TERMINATED)
            .exists()
        )
        assert harness.exporter.job_records().with_intent(JobIntent.CANCELED).exists()
        jobs = harness.activate_jobs("escalation")
        assert len(jobs) == 1
        harness.complete_job(jobs[0]["key"])
        assert harness.is_instance_done(pi)
        assert_replay_equals_processing(harness)

    def test_completing_task_cancels_boundary_timer(self, harness):
        self.deploy(harness)
        pi = harness.create_instance("bnd")
        jobs = harness.activate_jobs("slow-work")
        harness.complete_job(jobs[0]["key"])
        assert harness.exporter.timer_records().with_intent(TimerIntent.CANCELED).exists()
        assert harness.is_instance_done(pi)
        harness.advance_time(60_000)
        assert not harness.exporter.timer_records().with_intent(TimerIntent.TRIGGERED).exists()


class TestTimerStartEvent:
    def test_cycle_starts_instances(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("cron")
            .timer_start_event("tick", cycle="R3/PT60S")
            .service_task("work", job_type="cron-work")
            .end_event("e")
            .done()
        )
        assert harness.exporter.timer_records().with_intent(TimerIntent.CREATED).count() == 1
        harness.advance_time(60_000)
        assert len(harness.activate_jobs("cron-work")) == 1
        harness.advance_time(60_000)
        assert len(harness.activate_jobs("cron-work")) == 1
        # third and final repetition
        harness.advance_time(60_000)
        assert len(harness.activate_jobs("cron-work")) == 1
        harness.advance_time(60_000)
        assert harness.activate_jobs("cron-work") == []


class TestMessageCorrelation:
    def deploy_catch(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("order")
            .start_event("s")
            .intermediate_catch_message("wait_payment", message_name="payment",
                                        correlation_key="=orderId")
            .service_task("ship", job_type="ship")
            .end_event("e")
            .done()
        )

    def test_subscription_opened(self, harness):
        self.deploy_catch(harness)
        harness.create_instance("order", variables={"orderId": "o-1"})
        assert (
            harness.exporter.all()
            .with_value_type(ValueType.PROCESS_MESSAGE_SUBSCRIPTION)
            .with_intent(ProcessMessageSubscriptionIntent.CREATING)
            .exists()
        )
        sub = (
            harness.exporter.all()
            .with_value_type(ValueType.MESSAGE_SUBSCRIPTION)
            .with_intent(MessageSubscriptionIntent.CREATED)
            .first()
        )
        assert sub.record.value["correlationKey"] == "o-1"

    def test_publish_correlates(self, harness):
        self.deploy_catch(harness)
        pi = harness.create_instance("order", variables={"orderId": "o-1"})
        harness.publish_message("payment", "o-1", variables={"amount": 33})
        assert (
            harness.exporter.all()
            .with_value_type(ValueType.PROCESS_MESSAGE_SUBSCRIPTION)
            .with_intent(ProcessMessageSubscriptionIntent.CORRELATED)
            .exists()
        )
        jobs = harness.activate_jobs("ship")
        assert len(jobs) == 1
        assert jobs[0]["variables"]["amount"] == 33
        harness.complete_job(jobs[0]["key"])
        assert harness.is_instance_done(pi)
        assert_replay_equals_processing(harness)

    def test_wrong_correlation_key_does_not_correlate(self, harness):
        self.deploy_catch(harness)
        harness.create_instance("order", variables={"orderId": "o-1"})
        harness.publish_message("payment", "other-order")
        assert harness.activate_jobs("ship") == []

    def test_buffered_message_correlates_on_subscribe(self, harness):
        self.deploy_catch(harness)
        # message first, process second
        harness.publish_message("payment", "o-2", variables={"x": 1})
        pi = harness.create_instance("order", variables={"orderId": "o-2"})
        jobs = harness.activate_jobs("ship")
        assert len(jobs) == 1
        harness.complete_job(jobs[0]["key"])
        assert harness.is_instance_done(pi)

    def test_message_ttl_expiry(self, harness):
        from zeebe_tpu_torch.protocol import ValueType
        from zeebe_tpu_torch.protocol.intent import MessageBatchIntent

        self.deploy_catch(harness)
        harness.publish_message("payment", "o-3", ttl=5_000)
        harness.advance_time(5_001)
        # expiry rides the batched path: ONE MESSAGE_BATCH EXPIRED record
        # (reference: protocol.xml MESSAGE_BATCH, MessageBatchExpireProcessor)
        batches = (
            harness.exporter.all()
            .with_value_type(ValueType.MESSAGE_BATCH)
            .with_intent(MessageBatchIntent.EXPIRED)
            .to_list()
        )
        assert len(batches) == 1
        assert len(batches[0].record.value["messageKeys"]) == 1
        # subscribing after expiry finds nothing
        harness.create_instance("order", variables={"orderId": "o-3"})
        assert harness.activate_jobs("ship") == []

    def test_message_batch_expiry_one_record_for_backlog(self, harness):
        """A due backlog of N messages expires with O(batches) records, not
        O(N) (VERDICT r4 item 7)."""
        from zeebe_tpu_torch.protocol import ValueType
        from zeebe_tpu_torch.protocol.intent import MessageBatchIntent

        self.deploy_catch(harness)
        for i in range(50):
            harness.publish_message("payment", f"bulk-{i}", ttl=1_000)
        harness.advance_time(1_001)
        batches = (
            harness.exporter.all()
            .with_value_type(ValueType.MESSAGE_BATCH)
            .with_intent(MessageBatchIntent.EXPIRED)
            .to_list()
        )
        assert len(batches) == 1
        assert len(batches[0].record.value["messageKeys"]) == 50
        # no per-message EXPIRED records on the batched path
        assert not harness.exporter.message_records().with_intent(
            MessageIntent.EXPIRED).exists()
        # the messages are really gone: late subscribers find nothing
        harness.create_instance("order", variables={"orderId": "bulk-7"})
        assert harness.activate_jobs("ship") == []

    def test_message_id_dedup(self, harness):
        self.deploy_catch(harness)
        harness.publish_message("payment", "o-4", message_id="m-1")
        harness.publish_message("payment", "o-4", message_id="m-1")
        rejections = harness.exporter.message_records().rejections().to_list()
        assert len(rejections) == 1
        assert "already published" in rejections[0].record.rejection_reason

    def test_one_message_per_instance(self, harness):
        """A message correlates at most once to the same process instance."""
        harness.deploy(
            Bpmn.create_executable_process("two_waits")
            .start_event("s")
            .intermediate_catch_message("w1", message_name="m", correlation_key="=k")
            .intermediate_catch_message("w2", message_name="m", correlation_key="=k")
            .end_event("e")
            .done()
        )
        pi = harness.create_instance("two_waits", variables={"k": "kk"})
        harness.publish_message("m", "kk")
        # first wait correlated; second needs a new message
        assert (
            harness.exporter.process_instance_records()
            .with_element_id("w1").with_intent(PI.ELEMENT_COMPLETED).exists()
        )
        assert not harness.is_instance_done(pi)
        harness.publish_message("m", "kk")
        assert harness.is_instance_done(pi)


class TestMessageStartEvent:
    def test_publish_starts_instance(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("on_msg")
            .message_start_event("msg_start", message_name="go")
            .service_task("work", job_type="msg-work")
            .end_event("e")
            .done()
        )
        harness.publish_message("go", "any", variables={"seed": 7})
        jobs = harness.activate_jobs("msg-work")
        assert len(jobs) == 1
        assert jobs[0]["variables"]["seed"] == 7
        # start element is the message start event, not a none start
        assert (
            harness.exporter.process_instance_records()
            .with_element_id("msg_start").with_intent(PI.ELEMENT_COMPLETED).exists()
        )


class TestJobTimeout:
    def test_activated_job_times_out_and_reactivates(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("p")
            .start_event("s")
            .service_task("t", job_type="work")
            .end_event("e")
            .done()
        )
        harness.create_instance("p")
        jobs = harness.activate_jobs("work", timeout=10_000)
        assert len(jobs) == 1
        # nothing else can grab it while locked
        assert harness.activate_jobs("work") == []
        harness.advance_time(10_001)
        assert harness.exporter.job_records().with_intent(JobIntent.TIMED_OUT).exists()
        jobs2 = harness.activate_jobs("work")
        assert len(jobs2) == 1

    def test_fail_with_backoff_recurs(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("p")
            .start_event("s")
            .service_task("t", job_type="work")
            .end_event("e")
            .done()
        )
        harness.create_instance("p")
        jobs = harness.activate_jobs("work")
        harness.write_command(
            __import__("zeebe_tpu_torch.protocol", fromlist=["command"]).command(
                ValueType.JOB, JobIntent.FAIL,
                {"retries": 2, "retryBackOff": 5_000, "errorMessage": "later"},
                key=jobs[0]["key"],
            ),
            request_id=30,
        )
        # not yet activatable during backoff
        assert harness.activate_jobs("work") == []
        harness.advance_time(5_001)
        assert harness.exporter.job_records().with_intent(JobIntent.RECURRED_AFTER_BACKOFF).exists()
        assert len(harness.activate_jobs("work")) == 1


class TestReviewRegressions:
    def test_cancel_instance_during_backoff_stops_sweep(self, harness):
        """Regression: canceling a job mid-backoff must clear the backoff
        index, else the due-date sweep re-fires forever."""
        harness.deploy(
            Bpmn.create_executable_process("p")
            .start_event("s").service_task("t", job_type="work").end_event("e")
            .done()
        )
        pi = harness.create_instance("p")
        jobs = harness.activate_jobs("work")
        harness.write_command(
            __import__("zeebe_tpu_torch.protocol", fromlist=["command"]).command(
                ValueType.JOB, JobIntent.FAIL,
                {"retries": 2, "retryBackOff": 5_000}, key=jobs[0]["key"],
            ),
            request_id=31,
        )
        harness.cancel_instance(pi)
        harness.advance_time(10_000)  # would raise pump-did-not-quiesce before

    def test_redeploy_removing_message_start_closes_subscription(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("p")
            .message_start_event("ms", message_name="go")
            .end_event("e")
            .done()
        )
        harness.deploy(
            Bpmn.create_executable_process("p")
            .start_event("s")
            .end_event("e")
            .done()
        )
        before = harness.exporter.process_instance_records().events().count()
        harness.publish_message("go", "x")
        # no new instance of v1
        assert harness.exporter.process_instance_records().events().count() == before

    def test_redeploy_cancels_old_start_timer(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("p")
            .timer_start_event("tick", cycle="R/PT60S")
            .end_event("e")
            .done()
        )
        harness.deploy(
            Bpmn.create_executable_process("p")
            .start_event("s")
            .end_event("e")
            .done()
        )
        assert harness.exporter.timer_records().with_intent(TimerIntent.CANCELED).exists()
        before = harness.exporter.process_instance_records().events().count()
        harness.advance_time(120_000)
        assert harness.exporter.process_instance_records().events().count() == before

    def test_terminated_receive_sends_subscription_delete(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("p")
            .start_event("s")
            .intermediate_catch_message("w", message_name="m", correlation_key="=k")
            .end_event("e")
            .done()
        )
        pi = harness.create_instance("p", variables={"k": "K"})
        harness.cancel_instance(pi)
        assert (
            harness.exporter.all()
            .with_value_type(ValueType.MESSAGE_SUBSCRIPTION)
            .with_intent(MessageSubscriptionIntent.DELETED)
            .exists()
        )
        # message published later correlates nowhere and state stays clean
        harness.publish_message("m", "K")
        with harness.db.transaction():
            assert harness.engine.state.message_subscriptions.find("m", "K") == []

    def test_boundary_message_without_correlation_rejected_at_deploy(self, harness):
        model = (
            Bpmn.create_executable_process("p")
            .start_event("s")
            .service_task("t", job_type="w")
            .end_event("e")
            .done()
        )
        from zeebe_tpu_torch.models.bpmn.model import MessageDefinition, ProcessElement
        from zeebe_tpu_torch.protocol.enums import BpmnElementType, BpmnEventType

        bad = ProcessElement(
            id="bmsg", element_type=BpmnElementType.BOUNDARY_EVENT,
            event_type=BpmnEventType.MESSAGE, attached_to_id="t",
        )
        bad.message = MessageDefinition(name="m")  # no correlation key
        model.elements["bmsg"] = bad
        harness.deploy(model)
        rejections = harness.exporter.deployment_records().rejections().to_list()
        assert len(rejections) == 1
        assert "correlation key" in rejections[0].record.rejection_reason
