"""Fluent client over the gateway gRPC API.

Reference: clients/java/src/main/java/io/camunda/zeebe/client/ZeebeClient.java
— one fluent command builder per rpc (api/command/*), variables as JSON,
worker subscription builder. The builder step chain mirrors the Java client's
(newCreateInstanceCommand().bpmnProcessId(x).latestVersion().variables(v)
.send().join()) in pythonic form with keyword arguments + a .send() terminal.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Iterator

import grpc

from zeebe_tpu_torch.gateway.proto import gateway_pb2 as pb

_SERVICE = "gateway_protocol.Gateway"


def _method(channel, name, req_cls, resp_cls, streaming=False):
    path = f"/{_SERVICE}/{name}"
    if streaming:
        return channel.unary_stream(
            path, request_serializer=req_cls.SerializeToString,
            response_deserializer=resp_cls.FromString,
        )
    return channel.unary_unary(
        path, request_serializer=req_cls.SerializeToString,
        response_deserializer=resp_cls.FromString,
    )


@dataclass
class Topology:
    cluster_size: int
    partitions_count: int
    replication_factor: int
    gateway_version: str
    brokers: list[dict] = field(default_factory=list)


@dataclass
class ProcessInstance:
    process_definition_key: int
    bpmn_process_id: str
    version: int
    process_instance_key: int
    variables: dict | None = None


@dataclass
class ActivatedJob:
    key: int
    type: str
    process_instance_key: int
    bpmn_process_id: str
    element_id: str
    element_instance_key: int
    custom_headers: dict
    worker: str
    retries: int
    deadline: int
    variables: dict


def _job_of(j) -> ActivatedJob:
    return ActivatedJob(
        key=j.key, type=j.type, process_instance_key=j.processInstanceKey,
        bpmn_process_id=j.bpmnProcessId, element_id=j.elementId,
        element_instance_key=j.elementInstanceKey,
        custom_headers=json.loads(j.customHeaders or "{}"),
        worker=j.worker, retries=j.retries, deadline=j.deadline,
        variables=json.loads(j.variables or "{}"),
    )


class ZeebeTpuClient:
    """Synchronous client; one instance per gateway address."""

    def __init__(self, address: str, channel: grpc.Channel | None = None,
                 access_token: str | None = None,
                 default_tenant: str = "",
                 credentials_provider=None) -> None:
        """Credential precedence (mirrors the reference client):
        an explicit ``credentials_provider`` wins; else an explicit
        ``access_token`` (static bearer); else the ZEEBE_CLIENT_ID /
        ZEEBE_CLIENT_SECRET / ZEEBE_AUTHORIZATION_SERVER_URL environment.
        Pass ``credentials_provider=False`` to force anonymous calls."""
        from zeebe_tpu_torch.client.credentials import (
            OAuthCredentialsProvider,
            StaticCredentialsProvider,
            authenticated_channel,
        )

        self.address = address
        self.channel = channel or grpc.insecure_channel(address)
        if credentials_provider is None:
            if access_token:
                credentials_provider = StaticCredentialsProvider(access_token)
            else:
                credentials_provider = OAuthCredentialsProvider.from_env()
        if credentials_provider:
            self.channel = authenticated_channel(self.channel,
                                                 credentials_provider)
        # tenant stamped on tenant-scoped commands unless overridden per call
        self.default_tenant = default_tenant
        c = self.channel
        self._topology = _method(c, "Topology", pb.TopologyRequest, pb.TopologyResponse)
        self._deploy = _method(c, "DeployResource", pb.DeployResourceRequest, pb.DeployResourceResponse)
        self._create = _method(c, "CreateProcessInstance", pb.CreateProcessInstanceRequest, pb.CreateProcessInstanceResponse)
        self._create_with_result = _method(c, "CreateProcessInstanceWithResult", pb.CreateProcessInstanceWithResultRequest, pb.CreateProcessInstanceWithResultResponse)
        self._cancel = _method(c, "CancelProcessInstance", pb.CancelProcessInstanceRequest, pb.CancelProcessInstanceResponse)
        self._publish = _method(c, "PublishMessage", pb.PublishMessageRequest, pb.PublishMessageResponse)
        self._activate = _method(c, "ActivateJobs", pb.ActivateJobsRequest, pb.ActivateJobsResponse, streaming=True)
        self._stream_jobs = _method(c, "StreamActivatedJobs", pb.StreamActivatedJobsRequest, pb.ActivatedJob, streaming=True)
        self._complete = _method(c, "CompleteJob", pb.CompleteJobRequest, pb.CompleteJobResponse)
        self._fail = _method(c, "FailJob", pb.FailJobRequest, pb.FailJobResponse)
        self._throw = _method(c, "ThrowError", pb.ThrowErrorRequest, pb.ThrowErrorResponse)
        self._retries = _method(c, "UpdateJobRetries", pb.UpdateJobRetriesRequest, pb.UpdateJobRetriesResponse)
        self._update_timeout = _method(c, "UpdateJobTimeout", pb.UpdateJobTimeoutRequest, pb.UpdateJobTimeoutResponse)
        self._set_vars = _method(c, "SetVariables", pb.SetVariablesRequest, pb.SetVariablesResponse)
        self._resolve = _method(c, "ResolveIncident", pb.ResolveIncidentRequest, pb.ResolveIncidentResponse)
        self._signal = _method(c, "BroadcastSignal", pb.BroadcastSignalRequest, pb.BroadcastSignalResponse)

    def close(self) -> None:
        self.channel.close()

    def __enter__(self) -> "ZeebeTpuClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- cluster ---------------------------------------------------------------

    def topology(self) -> Topology:
        r = self._topology(pb.TopologyRequest())
        return Topology(
            cluster_size=r.clusterSize, partitions_count=r.partitionsCount,
            replication_factor=r.replicationFactor, gateway_version=r.gatewayVersion,
            brokers=[
                {"nodeId": b.nodeId,
                 "partitions": {p.partitionId: pb.Partition.PartitionBrokerRole.Name(p.role)
                                for p in b.partitions}}
                for b in r.brokers
            ],
        )

    # -- deployment ------------------------------------------------------------

    def deploy_resource(self, *resources: tuple[str, str | bytes] | str,
                        tenant_id: str = "") -> dict:
        """deploy_resource(("proc.bpmn", xml), …) or a path string."""
        reqs = []
        for res in resources:
            if isinstance(res, str):
                with open(res, "rb") as f:
                    reqs.append(pb.Resource(name=res.rsplit("/", 1)[-1], content=f.read()))
            else:
                name, content = res
                if isinstance(content, str):
                    content = content.encode("utf-8")
                reqs.append(pb.Resource(name=name, content=content))
        r = self._deploy(pb.DeployResourceRequest(
            resources=reqs, tenantId=tenant_id or self.default_tenant))
        return {
            "key": r.key,
            "processes": [
                {"bpmnProcessId": d.process.bpmnProcessId,
                 "version": d.process.version,
                 "processDefinitionKey": d.process.processDefinitionKey}
                for d in r.deployments if d.WhichOneof("Metadata") == "process"
            ],
            "decisions": [
                {"decisionId": d.decision.dmnDecisionId,
                 "decisionName": d.decision.dmnDecisionName,
                 "version": d.decision.version,
                 "decisionKey": d.decision.decisionKey,
                 "decisionRequirementsKey": d.decision.decisionRequirementsKey}
                for d in r.deployments if d.WhichOneof("Metadata") == "decision"
            ],
            "forms": [
                {"formId": d.form.formId, "version": d.form.version,
                 "formKey": d.form.formKey}
                for d in r.deployments if d.WhichOneof("Metadata") == "form"
            ],
        }

    # -- process instances -----------------------------------------------------

    def create_instance(self, bpmn_process_id: str = "",
                        process_definition_key: int = 0, version: int = 0,
                        variables: dict | None = None,
                        tenant_id: str = "") -> ProcessInstance:
        r = self._create(pb.CreateProcessInstanceRequest(
            bpmnProcessId=bpmn_process_id,
            processDefinitionKey=process_definition_key, version=version,
            variables=json.dumps(variables or {}),
            tenantId=tenant_id or self.default_tenant,
        ))
        return ProcessInstance(r.processDefinitionKey, r.bpmnProcessId,
                               r.version, r.processInstanceKey)

    def create_instance_with_result(self, bpmn_process_id: str = "",
                                    process_definition_key: int = 0,
                                    version: int = 0,
                                    variables: dict | None = None,
                                    fetch_variables: list[str] | None = None,
                                    timeout_s: float = 20.0,
                                    tenant_id: str = "") -> ProcessInstance:
        r = self._create_with_result(pb.CreateProcessInstanceWithResultRequest(
            request=pb.CreateProcessInstanceRequest(
                bpmnProcessId=bpmn_process_id,
                processDefinitionKey=process_definition_key,
                version=version,
                variables=json.dumps(variables or {}),
                tenantId=tenant_id or self.default_tenant,
            ),
            requestTimeout=int(timeout_s * 1000),
            fetchVariables=fetch_variables or [],
        ))
        return ProcessInstance(r.processDefinitionKey, r.bpmnProcessId, r.version,
                               r.processInstanceKey,
                               variables=json.loads(r.variables or "{}"))

    def cancel_instance(self, process_instance_key: int) -> None:
        self._cancel(pb.CancelProcessInstanceRequest(
            processInstanceKey=process_instance_key))

    # -- messages / signals ----------------------------------------------------

    def publish_message(self, name: str, correlation_key: str,
                        variables: dict | None = None, ttl_ms: int = 3_600_000,
                        message_id: str = "", tenant_id: str = "") -> int:
        r = self._publish(pb.PublishMessageRequest(
            name=name, correlationKey=correlation_key, timeToLive=ttl_ms,
            messageId=message_id, variables=json.dumps(variables or {}),
            tenantId=tenant_id or self.default_tenant,
        ))
        return r.key

    def broadcast_signal(self, signal_name: str,
                         variables: dict | None = None,
                         tenant_id: str = "") -> int:
        r = self._signal(pb.BroadcastSignalRequest(
            signalName=signal_name, variables=json.dumps(variables or {}),
            tenantId=tenant_id or self.default_tenant))
        return r.key

    # -- jobs ------------------------------------------------------------------

    def activate_jobs(self, job_type: str, max_jobs: int = 32,
                      worker: str = "python-client", timeout_ms: int = 300_000,
                      request_timeout_ms: int = 0,
                      tenant_ids: list[str] | None = None) -> list[ActivatedJob]:
        if tenant_ids is None and self.default_tenant:
            tenant_ids = [self.default_tenant]
        jobs: list[ActivatedJob] = []
        for resp in self._activate(pb.ActivateJobsRequest(
            type=job_type, worker=worker, timeout=timeout_ms,
            maxJobsToActivate=max_jobs, requestTimeout=request_timeout_ms,
            tenantIds=tenant_ids or [],
        )):
            jobs.extend(_job_of(j) for j in resp.jobs)
        return jobs

    def stream_jobs(self, job_type: str, worker: str = "python-client",
                    timeout_ms: int = 300_000,
                    tenant_ids: list[str] | None = None) -> Iterator[ActivatedJob]:
        if tenant_ids is None and self.default_tenant:
            tenant_ids = [self.default_tenant]
        for j in self._stream_jobs(pb.StreamActivatedJobsRequest(
            type=job_type, worker=worker, timeout=timeout_ms,
            tenantIds=tenant_ids or [],
        )):
            yield _job_of(j)

    def open_job_stream(self, job_type: str, worker: str = "python-client",
                        timeout_ms: int = 300_000,
                        tenant_ids: list[str] | None = None):
        """StreamActivatedJobs with a cancellation handle: returns
        ``(call, jobs)`` where ``call.cancel()`` ends the stream and ``jobs``
        iterates ActivatedJob (the streaming JobWorker's ingress). The
        iterator ends cleanly on cancellation."""
        if tenant_ids is None and self.default_tenant:
            tenant_ids = [self.default_tenant]
        call = self._stream_jobs(pb.StreamActivatedJobsRequest(
            type=job_type, worker=worker, timeout=timeout_ms,
            tenantIds=tenant_ids or [],
        ))

        def _jobs():
            try:
                for j in call:
                    yield _job_of(j)
            except grpc.RpcError as exc:
                if exc.code() != grpc.StatusCode.CANCELLED:
                    raise

        return call, _jobs()

    def complete_job(self, job_key: int, variables: dict | None = None) -> None:
        self._complete(pb.CompleteJobRequest(
            jobKey=job_key, variables=json.dumps(variables or {})))

    def fail_job(self, job_key: int, retries: int, error_message: str = "",
                 retry_back_off_ms: int = 0) -> None:
        self._fail(pb.FailJobRequest(
            jobKey=job_key, retries=retries, errorMessage=error_message,
            retryBackOff=retry_back_off_ms))

    def throw_error(self, job_key: int, error_code: str,
                    error_message: str = "") -> None:
        self._throw(pb.ThrowErrorRequest(
            jobKey=job_key, errorCode=error_code, errorMessage=error_message))

    def update_job_retries(self, job_key: int, retries: int) -> None:
        self._retries(pb.UpdateJobRetriesRequest(jobKey=job_key, retries=retries))

    def update_job_timeout(self, job_key: int, timeout_ms: int) -> None:
        self._update_timeout(pb.UpdateJobTimeoutRequest(
            jobKey=job_key, timeout=timeout_ms))

    # -- variables / incidents -------------------------------------------------

    def set_variables(self, element_instance_key: int, variables: dict,
                      local: bool = False) -> int:
        r = self._set_vars(pb.SetVariablesRequest(
            elementInstanceKey=element_instance_key,
            variables=json.dumps(variables), local=local))
        return r.key

    def resolve_incident(self, incident_key: int) -> None:
        self._resolve(pb.ResolveIncidentRequest(incidentKey=incident_key))
