"""One scripted gRPC session against a package's ``Gateway`` over its
``ClusterRuntime``.

A helper of ``tests/test_torch_gateway.py`` and of the card's test in
``tests/test_torch_cuda.py`` (not collected itself). It imports neither
package at module level: ``drive_grpc`` loads the side it is given, so the
card's machine, which has no JAX, runs the port's side alone. Both sides
run in one process when compared: Raft seeds its election jitter with
string hashes, which differ between processes.

The session waits on the leaders' state wherever the gateway would race
the engine (deployment distribution, jobs becoming activatable, an
incident being raised, instances finishing), so that each request finds the
same state on both packages and the responses are comparable one by one.
"""

from __future__ import annotations

import importlib
import json
import time

import torch
from google.protobuf.json_format import MessageToDict

REF, PORT = "zeebe_tpu", "zeebe_tpu_torch"
PARTITIONS = 3
SHAPE = {"broker_count": 3, "partition_count": PARTITIONS, "replication_factor": 3,
         "kernel_mesh_shards": 3}

# the plain version's tensors here are small: torch's intra-op thread pool
# only adds contention with the other test workers
torch.set_num_threads(1)

#: response fields the real clock decides: an activated job's deadline,
#: and which broker each partition's election made its leader (equal
#: between the packages on a quiet host, not under load)
CLOCKED = ("deadline", "role")


def masked(value):
    """A response as a dict without the fields the real clock decides."""
    if isinstance(value, dict):
        return {k: masked(v) for k, v in value.items() if k not in CLOCKED}
    if isinstance(value, list):
        return [masked(v) for v in value]
    return value


def _leader_read(runtime, pid: int, read):
    """``read(leader)`` under partition ``pid``'s ownership lock and a
    transaction of its leader's state, or None without a leader."""
    with runtime._plocks[pid]:
        leader = runtime._leader_partition(pid)
        if leader is None or leader.db is None or leader.engine is None:
            return None
        with leader.db.transaction():
            return read(leader)


def await_state(runtime, what: str, done, timeout_s: float = 60.0) -> None:
    """Block until ``done(runtime)`` holds."""
    deadline = time.monotonic() + timeout_s
    while not done(runtime):
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def activatable(runtime, job_type: str) -> int:
    """Activatable jobs of ``job_type`` on every partition leader."""
    return sum(_leader_read(runtime, pid, lambda leader: len(
        leader.engine.state.jobs.activatable_keys(job_type, 1 << 20))) or 0
        for pid in range(1, PARTITIONS + 1))


def live_instances(runtime) -> int:
    """Element instances on every partition leader."""
    return sum(_leader_read(runtime, pid, lambda leader: len(list(
        leader.engine.state.element_instances._instances.items(())))) or 0
        for pid in range(1, PARTITIONS + 1))


def leader_state(runtime) -> dict:
    """Per partition leader: the key count of each column family."""
    return {pid: _leader_read(runtime, pid, lambda leader: leader.db.key_counts_by_cf())
            for pid in range(1, PARTITIONS + 1)}


def drive_grpc(side: str, n_instances: int = 6, **runtime_kwargs) -> dict:
    """The session, through ``side``'s client channel against its gateway
    over a 3 x 3 x 3 ``ClusterRuntime`` with a 3-shard mesh runner: topology;
    one_task, a message catch and a DMN deployed; ``n_instances`` one_task
    creations and one message catch; activations and a completion; a fail
    with a retry; a fail to zero retries, its incident resolved after new
    retries; a message published; variables set; an instance cancelled;
    the decision evaluated; every remaining job completed; topology again.
    Returns each response message (``CLOCKED`` fields masked), each leader's
    column-family key counts once no instance is left, and the mesh
    runner's dispatches."""
    gateway = importlib.import_module(f"{side}.gateway")
    service = importlib.import_module(f"{side}.gateway.gateway")
    client_mod = importlib.import_module(f"{side}.client")
    testing = importlib.import_module(f"{side}.testing")
    bpmn = importlib.import_module(f"{side}.models.bpmn")
    workloads = importlib.import_module(f"{PORT}.testing.workloads")
    pb = importlib.import_module(f"{side}.gateway.proto.gateway_pb2")
    runtime = gateway.ClusterRuntime(**SHAPE, **runtime_kwargs)
    server = None
    client = None
    responses: list = []

    def call(name: str, request):
        _, resp_cls = service._UNARY[name]
        stub = client.channel.unary_unary(
            f"/gateway_protocol.Gateway/{name}",
            request_serializer=type(request).SerializeToString,
            response_deserializer=resp_cls.FromString)
        response = stub(request, timeout=60)
        responses.append((name, masked(MessageToDict(response))))
        return response

    def topology() -> None:
        """Topology, with one leader for each partition among the brokers
        (the roles themselves are masked)."""
        leaders = sorted(p.partitionId for b in call("Topology", pb.TopologyRequest()).brokers
                         for p in b.partitions if p.role == pb.Partition.LEADER)
        assert leaders == list(range(1, PARTITIONS + 1)), leaders

    def activate(job_type: str, n: int) -> list:
        stub = client.channel.unary_stream(
            "/gateway_protocol.Gateway/ActivateJobs",
            request_serializer=pb.ActivateJobsRequest.SerializeToString,
            response_deserializer=pb.ActivateJobsResponse.FromString)
        jobs = []
        for response in stub(pb.ActivateJobsRequest(
                type=job_type, worker="parity", timeout=300_000, maxJobsToActivate=n,
                requestTimeout=0), timeout=60):
            responses.append(("ActivateJobs", masked(MessageToDict(response))))
            jobs += list(response.jobs)
        return jobs

    def complete(job) -> None:
        call("CompleteJob", pb.CompleteJobRequest(jobKey=job.key,
                                                  variables=json.dumps({"done": job.key})))

    def incident_of(job_key: int):
        return _leader_read(runtime, runtime.partition_for_key(job_key),
                            lambda leader: leader.engine.state.incidents
                            .incident_key_for_job(job_key))

    try:
        runtime.start()
        server = gateway.Gateway(runtime, max_workers=4)
        server.start()
        client = client_mod.ZeebeTpuClient(server.address, credentials_provider=False)
        await_state(runtime, "a leader for every partition", lambda r: all(
            r._leader_partition(pid) is not None for pid in range(1, PARTITIONS + 1)))
        topology()
        one_task = (bpmn.Bpmn.create_executable_process("p").start_event("s")
                    .service_task("t", job_type="w").end_event("e").done())
        catch = (bpmn.Bpmn.create_executable_process("msgp").start_event("s")
                 .intermediate_catch_message("c", message_name="go", correlation_key="=key")
                 .end_event("e").done())
        call("DeployResource", pb.DeployResourceRequest(resources=[
            pb.Resource(name="p.bpmn", content=bpmn.to_bpmn_xml(one_task).encode()),
            pb.Resource(name="msgp.bpmn", content=bpmn.to_bpmn_xml(catch).encode()),
            pb.Resource(name="band.dmn", content=workloads.dmn_band_xml().encode())]))
        testing.await_deployment_distributed(runtime, ["p", "msgp"], timeout_s=60.0)
        instances = [call("CreateProcessInstance", pb.CreateProcessInstanceRequest(
            bpmnProcessId="p", version=-1, variables=json.dumps({"x": i})))
            for i in range(n_instances)]
        call("CreateProcessInstance", pb.CreateProcessInstanceRequest(
            bpmnProcessId="msgp", version=-1, variables=json.dumps({"key": "k-1"})))
        await_state(runtime, "the jobs", lambda r: activatable(r, "w") == n_instances)
        first = activate("w", 3)
        complete(first[0])
        # fail with a retry left: the job comes back
        call("FailJob", pb.FailJobRequest(jobKey=first[1].key, retries=1,
                                          errorMessage="transient"))
        # fail to zero retries: an incident; new retries, then resolve it
        call("FailJob", pb.FailJobRequest(jobKey=first[2].key, retries=0,
                                          errorMessage="permanent"))
        await_state(runtime, "the incident", lambda r: incident_of(first[2].key) is not None)
        call("UpdateJobRetries", pb.UpdateJobRetriesRequest(jobKey=first[2].key, retries=2))
        call("ResolveIncident", pb.ResolveIncidentRequest(
            incidentKey=incident_of(first[2].key)))
        call("PublishMessage", pb.PublishMessageRequest(
            name="go", correlationKey="k-1", timeToLive=60_000,
            variables=json.dumps({"published": True})))
        call("SetVariables", pb.SetVariablesRequest(
            elementInstanceKey=instances[3].processInstanceKey,
            variables=json.dumps({"b": 2}), local=False))
        call("CancelProcessInstance", pb.CancelProcessInstanceRequest(
            processInstanceKey=instances[4].processInstanceKey))
        call("EvaluateDecision", pb.EvaluateDecisionRequest(
            decisionId="band", variables=json.dumps({"amount": 35, "tier": "gold"})))
        left = n_instances - 2  # one completed, one cancelled
        await_state(runtime, "the jobs back", lambda r: activatable(r, "w") == left)
        while left:
            jobs = activate("w", 2)
            for job in jobs:
                complete(job)
            left -= len(jobs)
            await_state(runtime, "the jobs left", lambda r: activatable(r, "w") == left)
        await_state(runtime, "every instance finished", lambda r: live_instances(r) == 0)
        topology()
        # the last follow-ups (a subscription's close, a job's deletion) land
        # after the instances finish: read the leaders once they stop moving
        state, deadline = None, time.monotonic() + 60.0
        while state != (state := leader_state(runtime)):
            if time.monotonic() > deadline:
                raise AssertionError("the leaders' state did not settle")
            time.sleep(0.2)
        mesh = runtime.mesh_runner
        return {"responses": responses, "state": state,
                "mesh": (mesh.dispatches, mesh.groups_dispatched)}
    finally:
        if client is not None:
            client.close()
        if server is not None:
            server.stop()
        runtime.stop()
