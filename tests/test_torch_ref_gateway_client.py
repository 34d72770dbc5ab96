# tests/test_gateway_client.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Gateway gRPC + Python client integration tests (reference:
gateway/src/test EndpointManagerTest, clients/java client ITs). Real gRPC over
localhost against an in-process broker cluster runtime."""

from __future__ import annotations

import time

import grpc
import pytest

from zeebe_tpu_torch.client import JobWorker, ZeebeTpuClient
from zeebe_tpu_torch.gateway import ClusterRuntime, Gateway
from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml


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


def one_task(pid="p", job_type="w"):
    return to_bpmn_xml(
        Bpmn.create_executable_process(pid)
        .start_event("s").service_task("t", job_type=job_type).end_event("e").done()
    )


class TestGatewayRpcs:
    def test_topology(self, stack):
        client, _ = stack
        topo = client.topology()
        assert topo.cluster_size == 1
        assert topo.partitions_count == 2
        assert topo.gateway_version.startswith("8.4")

    def test_deploy_and_create(self, stack):
        client, _ = stack
        deployed = client.deploy_resource(("p.bpmn", one_task()))
        assert deployed["processes"][0]["bpmnProcessId"] == "p"
        assert deployed["processes"][0]["version"] == 1
        instance = client.create_instance("p", variables={"x": 1})
        assert instance.process_instance_key > 0
        assert instance.bpmn_process_id == "p"

    def test_activate_complete_roundtrip(self, stack):
        client, _ = stack
        client.deploy_resource(("rt.bpmn", one_task("rt", "rt_work")))
        client.create_instance("rt")
        jobs = client.activate_jobs("rt_work", request_timeout_ms=5_000)
        assert len(jobs) == 1
        job = jobs[0]
        assert job.type == "rt_work"
        assert job.bpmn_process_id == "rt"
        client.complete_job(job.key, {"done": True})
        # job is gone afterwards
        assert client.activate_jobs("rt_work") == []

    def test_create_with_result(self, stack):
        client, _ = stack
        client.deploy_resource(("wr.bpmn", one_task("wr", "wr_work")))
        worker = JobWorker(client, "wr_work",
                           lambda job: {"answer": job.variables.get("n", 0) * 2},
                           poll_interval_s=0.02).start()
        try:
            result = client.create_instance_with_result(
                "wr", variables={"n": 21}, timeout_s=10,
            )
            assert result.variables.get("answer") == 42
            assert result.variables.get("n") == 21
        finally:
            worker.stop()

    def test_rejection_maps_to_grpc_status(self, stack):
        client, _ = stack
        with pytest.raises(grpc.RpcError) as err:
            client.create_instance("does-not-exist")
        assert err.value.code() == grpc.StatusCode.NOT_FOUND

    def test_invalid_variables_rejected(self, stack):
        client, _ = stack
        with pytest.raises(grpc.RpcError) as err:
            client._create(
                __import__("zeebe_tpu_torch.gateway.proto.gateway_pb2",
                           fromlist=["x"]).CreateProcessInstanceRequest(
                    bpmnProcessId="p", variables="[1,2]")
            )
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT

    def test_publish_message_and_signal(self, stack):
        client, _ = stack
        msg_model = to_bpmn_xml(
            Bpmn.create_executable_process("msgp")
            .start_event("s")
            .intermediate_catch_message("c", message_name="go", correlation_key="=key")
            .end_event("e").done()
        )
        client.deploy_resource(("m.bpmn", msg_model))
        instance = client.create_instance("msgp", variables={"key": "k-1"})
        assert client.publish_message("go", "k-1") > 0
        result_deadline = time.time() + 5
        # instance completes shortly after correlation
        sig_key = client.broadcast_signal("noop-signal")
        assert sig_key > 0

    def test_cancel_instance(self, stack):
        client, _ = stack
        client.deploy_resource(("cx.bpmn", one_task("cx", "cx_work")))
        instance = client.create_instance("cx")
        client.cancel_instance(instance.process_instance_key)
        assert client.activate_jobs("cx_work") == []

    def test_fail_and_retry_flow(self, stack):
        client, _ = stack
        client.deploy_resource(("fr.bpmn", one_task("fr", "fr_work")))
        client.create_instance("fr")
        [job] = client.activate_jobs("fr_work")
        client.fail_job(job.key, retries=1, error_message="transient")
        [job2] = client.activate_jobs("fr_work")
        assert job2.key == job.key
        assert job2.retries == 1
        client.complete_job(job2.key)

    def test_set_variables(self, stack):
        client, _ = stack
        client.deploy_resource(("sv.bpmn", one_task("sv", "sv_work")))
        instance = client.create_instance("sv", variables={"a": 1})
        client.set_variables(instance.process_instance_key, {"b": 2})
        [job] = client.activate_jobs("sv_work")
        assert job.variables == {"a": 1, "b": 2}
        client.complete_job(job.key)


class TestJobWorker:
    def test_worker_processes_many_jobs(self, stack):
        client, _ = stack
        client.deploy_resource(("wk.bpmn", one_task("wk", "wk_work")))
        for i in range(10):
            client.create_instance("wk", variables={"i": i})
        worker = JobWorker(client, "wk_work", lambda job: {},
                           poll_interval_s=0.02).start()
        try:
            deadline = time.time() + 15
            while worker.handled_count < 10 and time.time() < deadline:
                time.sleep(0.05)
            assert worker.handled_count == 10
        finally:
            worker.stop()

    def test_failing_handler_fails_job(self, stack):
        client, _ = stack
        client.deploy_resource(("wf.bpmn", one_task("wf", "wf_work")))
        client.create_instance("wf")

        def boom(job):
            raise RuntimeError("handler exploded")

        worker = JobWorker(client, "wf_work", boom, poll_interval_s=0.02).start()
        try:
            deadline = time.time() + 10
            while worker.failed_count < 1 and time.time() < deadline:
                time.sleep(0.05)
            assert worker.failed_count >= 1
        finally:
            worker.stop()


class TestEvaluateDecision:
    def test_evaluate_decision_rpc(self, stack):
        import json as _json

        from zeebe_tpu_torch.gateway.proto import gateway_pb2 as pb
        from tests.test_dmn import DISH_DMN

        client, _ = stack
        client.deploy_resource(("dish.dmn", DISH_DMN))
        stub = client.channel.unary_unary(
            "/gateway_protocol.Gateway/EvaluateDecision",
            request_serializer=pb.EvaluateDecisionRequest.SerializeToString,
            response_deserializer=pb.EvaluateDecisionResponse.FromString,
        )
        resp = stub(pb.EvaluateDecisionRequest(
            decisionId="dish",
            variables=_json.dumps({"season": "Winter", "guestCount": 12}),
        ))
        assert _json.loads(resp.decisionOutput) == "Pasta"
        assert resp.decisionId == "dish"
        [d] = resp.evaluatedDecisions
        assert d.matchedRules[0].ruleIndex == 2


class TestModificationRpcs:
    def test_modify_and_delete_resource(self, stack):
        import json as _json

        from zeebe_tpu_torch.gateway.proto import gateway_pb2 as pb

        client, _ = stack
        deployed = client.deploy_resource(("mod.bpmn", one_task("modp", "mod_work")))
        instance = client.create_instance("modp")
        jobs = client.activate_jobs("mod_work")
        [job] = [j for j in jobs if j.process_instance_key == instance.process_instance_key]
        modify = client.channel.unary_unary(
            "/gateway_protocol.Gateway/ModifyProcessInstance",
            request_serializer=pb.ModifyProcessInstanceRequest.SerializeToString,
            response_deserializer=pb.ModifyProcessInstanceResponse.FromString,
        )
        modify(pb.ModifyProcessInstanceRequest(
            processInstanceKey=instance.process_instance_key,
            activateInstructions=[
                pb.ModifyProcessInstanceRequest.ActivateInstruction(elementId="e")],
            terminateInstructions=[
                pb.ModifyProcessInstanceRequest.TerminateInstruction(
                    elementInstanceKey=job.element_instance_key)],
        ))
        # the instance jumped to the end event and completed
        remaining = [j for j in client.activate_jobs("mod_work")
                     if j.process_instance_key == instance.process_instance_key]
        assert remaining == []
        # delete the definition: new instances are rejected
        delete = client.channel.unary_unary(
            "/gateway_protocol.Gateway/DeleteResource",
            request_serializer=pb.DeleteResourceRequest.SerializeToString,
            response_deserializer=pb.DeleteResourceResponse.FromString,
        )
        delete(pb.DeleteResourceRequest(
            resourceKey=deployed["processes"][0]["processDefinitionKey"]))
        # deletion distributes asynchronously, like deployment: wait until no
        # partition resolves the id before asserting the NOT_FOUND rejection
        from zeebe_tpu_torch.testing import await_resource_absent

        _client, runtime = stack
        await_resource_absent(runtime, ["modp"])
        with pytest.raises(grpc.RpcError) as err:
            client.create_instance("modp")
        assert err.value.code() == grpc.StatusCode.NOT_FOUND
