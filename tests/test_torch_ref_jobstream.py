# tests/test_jobstream.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Job push + jobs-available notification tests.

Reference: transport/stream/impl/ (AddStream/PushStream), broker
jobstream/RemoteJobStreamer.java:19, gateway impl/stream/StreamJobsHandler
and impl/job/LongPollingActivateJobsHandler.java:36, engine
JobYieldProcessor / JobUpdateTimeoutProcessor."""

from __future__ import annotations

import threading
import time

import pytest

from zeebe_tpu_torch.gateway import ClusterRuntime, Gateway
from zeebe_tpu_torch.gateway.jobstream import JobNotificationHub
from zeebe_tpu_torch.client import JobWorker, ZeebeTpuClient
from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
from zeebe_tpu_torch.protocol import ValueType, command
from zeebe_tpu_torch.protocol.intent import JobIntent
from zeebe_tpu_torch.testing import EngineHarness


def one_task(pid="p", job_type="w"):
    return to_bpmn_xml(
        Bpmn.create_executable_process(pid)
        .start_event("s").service_task("t", job_type=job_type).end_event("e").done()
    )


# ---------------------------------------------------------------------------
# engine: YIELD + UPDATE_TIMEOUT


class TestJobYieldAndTimeout:
    def test_yield_returns_job_to_activatable(self):
        h = EngineHarness()
        try:
            h.deploy(one_task("y", "ywork"))
            h.create_instance("y")
            jobs = h.activate_jobs("ywork")
            assert len(jobs) == 1
            key = jobs[0]["key"]
            # activated → nothing more to activate
            assert h.activate_jobs("ywork") == []
            h.write_command(command(ValueType.JOB, JobIntent.YIELD, {}, key=key))
            yielded = [r for r in h.exporter.records
                       if r.record.value_type == ValueType.JOB
                       and r.record.intent == JobIntent.YIELDED]
            assert len(yielded) == 1
            # activatable again
            assert len(h.activate_jobs("ywork")) == 1
        finally:
            h.close()

    def test_yield_rejected_when_not_activated(self):
        h = EngineHarness()
        try:
            h.deploy(one_task("y2", "y2work"))
            h.create_instance("y2")
            with h.db.transaction():
                keys = h.engine.state.jobs.activatable_keys("y2work", 10)
            assert len(keys) == 1
            h.write_command(
                command(ValueType.JOB, JobIntent.YIELD, {}, key=keys[0]),
                request_id=41,
            )
            rejections = [r for r in h.responses if r.record.is_rejection]
            assert rejections and "not activated" in rejections[-1].record.rejection_reason
        finally:
            h.close()

    def test_update_timeout_moves_deadline(self):
        h = EngineHarness()
        try:
            h.deploy(one_task("ut", "utwork"))
            h.create_instance("ut")
            jobs = h.activate_jobs("utwork", timeout=1_000)
            key = jobs[0]["key"]
            h.write_command(
                command(ValueType.JOB, JobIntent.UPDATE_TIMEOUT,
                        {"timeout": 3_600_000}, key=key),
                request_id=42,
            )
            updated = [r for r in h.exporter.records
                       if r.record.value_type == ValueType.JOB
                       and r.record.intent == JobIntent.TIMEOUT_UPDATED]
            assert len(updated) == 1
            assert updated[0].record.value["deadline"] == h.clock() + 3_600_000
            # the old 1s deadline no longer times the job out
            h.advance_time(5_000)
            timed_out = [r for r in h.exporter.records
                         if r.record.value_type == ValueType.JOB
                         and r.record.intent == JobIntent.TIMED_OUT]
            assert timed_out == []
        finally:
            h.close()


# ---------------------------------------------------------------------------
# hub


class TestNotificationHub:
    def test_wait_wakes_on_notify(self):
        hub = JobNotificationHub()
        seen = hub.version("t")
        woke = []

        def waiter():
            woke.append(hub.wait("t", seen, timeout_s=5.0))

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.05)
        hub.notify({"t"})
        t.join(timeout=2)
        assert woke == [True]

    def test_wait_times_out_for_other_type(self):
        hub = JobNotificationHub()
        seen = hub.version("t")
        hub.notify({"other"})
        assert hub.wait("t", seen, timeout_s=0.05) is False

    def test_no_missed_wakeup_between_check_and_wait(self):
        # version read before the state check: a notify that lands between
        # check and wait must not be lost
        hub = JobNotificationHub()
        seen = hub.version("t")
        hub.notify({"t"})  # lands "during the state check"
        assert hub.wait("t", seen, timeout_s=5.0) is True


# ---------------------------------------------------------------------------
# gateway e2e: push + long-poll wakeup


@pytest.fixture(scope="module")
def stack():
    runtime = ClusterRuntime(broker_count=1, partition_count=2,
                             replication_factor=1, device="cpu")
    runtime.start()
    gateway = Gateway(runtime)
    gateway.start()
    from zeebe_tpu_torch.testing import distributing_client

    client = distributing_client(ZeebeTpuClient(gateway.address), runtime)
    yield client, runtime
    client.close()
    gateway.stop()
    runtime.stop()


class TestJobPush:
    def test_stream_receives_pushed_jobs(self, stack):
        client, _ = stack
        client.deploy_resource(("push.bpmn", one_task("push", "push_work")))
        received = []
        call, jobs = client.open_job_stream("push_work", timeout_ms=10_000)

        def consume():
            for job in jobs:
                received.append(job)

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        for _ in range(3):
            client.create_instance("push")
        deadline = time.time() + 10
        while len(received) < 3 and time.time() < deadline:
            time.sleep(0.02)
        call.cancel()
        t.join(timeout=2)
        assert len(received) == 3
        assert {j.type for j in received} == {"push_work"}
        for job in received:
            client.complete_job(job.key, {})

    def test_push_picks_up_jobs_created_before_stream(self, stack):
        client, _ = stack
        client.deploy_resource(("pre.bpmn", one_task("pre", "pre_work")))
        client.create_instance("pre")
        time.sleep(0.2)  # job exists before any stream is registered
        call, jobs = client.open_job_stream("pre_work", timeout_ms=10_000)
        got = []

        def consume():
            for job in jobs:
                got.append(job)
                return

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        t.join(timeout=10)
        call.cancel()
        assert len(got) == 1
        client.complete_job(got[0].key, {})

    def test_streaming_worker_completes_instances(self, stack):
        client, _ = stack
        client.deploy_resource(("sw.bpmn", one_task("sw", "sw_work")))
        worker = JobWorker(client, "sw_work",
                           lambda job: {"ok": True}, stream_enabled=True).start()
        try:
            result = client.create_instance_with_result("sw", timeout_s=10)
            assert result.variables.get("ok") is True
        finally:
            worker.stop()

    def test_long_poll_woken_by_notification(self, stack):
        client, _ = stack
        client.deploy_resource(("lp.bpmn", one_task("lp", "lp_work")))
        results = {}

        def poll():
            start = time.time()
            results["jobs"] = client.activate_jobs(
                "lp_work", request_timeout_ms=10_000)
            results["elapsed"] = time.time() - start

        t = threading.Thread(target=poll, daemon=True)
        t.start()
        time.sleep(0.3)  # the long-poll is parked now
        client.create_instance("lp")
        t.join(timeout=10)
        assert len(results["jobs"]) == 1
        # woken well before the 10s request timeout
        assert results["elapsed"] < 8.0
        client.complete_job(results["jobs"][0].key, {})
