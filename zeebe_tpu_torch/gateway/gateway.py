"""gRPC gateway: the client API front-end.

Reference: gateway/src/main/java/io/camunda/zeebe/gateway/ — Gateway boots the
gRPC server, EndpointManager.java:78 bridges rpcs to broker requests through
RequestMapper.java:66 / ResponseMapper.java:58; ActivateJobs long-polls via
LongPollingActivateJobsHandler.java:36 fanning out round-robin across
partitions (RoundRobinActivateJobsHandler).

The service is registered with ``grpc.method_handlers_generic_handler`` over
protoc-generated messages (no grpcio-tools in the image — message codegen via
``protoc --python_out``, service wiring by hand)."""

from __future__ import annotations

import json
import time
from concurrent import futures
from typing import Any, Callable

import grpc

from zeebe_tpu_torch.gateway.proto import gateway_pb2 as pb  # noqa: E402

from zeebe_tpu_torch.gateway.broker_client import (  # noqa: E402
    DEPLOYMENT_PARTITION,
    ClusterRuntime,
    NoLeaderError,
    RequestTimeoutError,
    ResourceExhaustedError,
)
from zeebe_tpu_torch.gateway.auth import TenantAuthorizer  # noqa: E402
from zeebe_tpu_torch.protocol import DEFAULT_TENANT, ValueType, command  # noqa: E402
from zeebe_tpu_torch.protocol.intent import (  # noqa: E402
    DeploymentIntent,
    IncidentIntent,
    JobBatchIntent,
    JobIntent,
    MessageIntent,
    ProcessInstanceCreationIntent,
    ProcessInstanceIntent,
    SignalIntent,
    VariableDocumentIntent,
)

VERSION = "8.4.0-tpu"


from zeebe_tpu_torch.utils.metrics import REGISTRY as _REG  # noqa: E402

_M_LONG_POLL_QUEUED = _REG.gauge(
    "long_polling_queued_current",
    "ActivateJobs requests parked waiting for jobs").labels()
_M_TOPOLOGY_ROLES = _REG.gauge(
    "gateway_topology_partition_roles",
    "known partition roles (3=leader 1=follower)", ("node", "partition"))


def _vars(json_str: str) -> dict:
    if not json_str:
        return {}
    parsed = json.loads(json_str)
    if not isinstance(parsed, dict):
        raise ValueError("variables must be a JSON object")
    return parsed


class GatewayService:
    """One method per rpc; raises grpc errors via context.abort."""

    def __init__(self, runtime: ClusterRuntime,
                 auth: TenantAuthorizer | None = None) -> None:
        self.runtime = runtime
        self.auth = auth or TenantAuthorizer()

    # -- tenant authorization (IdentityInterceptor equivalent) -----------------

    def _check_tenant(self, context, requested: str) -> str:
        error, detail = self.auth.check(context.invocation_metadata(), requested)
        if error == "disabled":
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, detail)
        elif error == "denied":
            context.abort(grpc.StatusCode.PERMISSION_DENIED, detail)
        return detail  # the validated tenant id

    def _tenant_fields(self, context, requested: str) -> dict:
        """Validated tenant + authorized-tenants claim for a command value.
        With multi-tenancy off and the default tenant addressed, commands stay
        in their pre-tenancy shape (no extra fields)."""
        tenant = self._check_tenant(context, requested)
        if not self.auth.enabled and tenant == DEFAULT_TENANT:
            return {}
        return {
            "tenantId": tenant,
            "authorizedTenants": self.auth.authorized_tenants(
                context.invocation_metadata()),
        }

    def _tenant_ids_field(self, context, requested_ids) -> dict:
        """ActivateJobs/StreamActivatedJobs tenantIds filter."""
        ids = [t for t in (requested_ids or []) if t] or [DEFAULT_TENANT]
        for tenant in ids:
            self._check_tenant(context, tenant)
        if not self.auth.enabled and ids == [DEFAULT_TENANT]:
            return {}
        return {"tenantIds": ids}

    # -- topology --------------------------------------------------------------

    def Topology(self, request, context):
        topo = self.runtime.topology()
        brokers = []
        for i, b in enumerate(topo["brokers"]):
            partitions = [
                pb.Partition(
                    partitionId=p["partitionId"],
                    role=pb.Partition.LEADER if p["role"] == "leader"
                    else pb.Partition.FOLLOWER,
                    health=pb.Partition.HEALTHY,
                )
                for p in b["partitions"]
            ]
            for p in b["partitions"]:
                _M_TOPOLOGY_ROLES.labels(str(i), str(p["partitionId"])).set(
                    3 if p["role"] == "leader" else 1)
            brokers.append(pb.BrokerInfo(
                nodeId=i, host="127.0.0.1", port=0, partitions=partitions,
                version=VERSION,
            ))
        return pb.TopologyResponse(
            brokers=brokers, clusterSize=topo["clusterSize"],
            partitionsCount=topo["partitionsCount"],
            replicationFactor=topo["replicationFactor"], gatewayVersion=VERSION,
        )

    # -- deployment ------------------------------------------------------------

    def DeployResource(self, request, context):
        resources = [
            {"resourceName": r.name, "resource": r.content.decode("utf-8")}
            for r in request.resources
        ]
        record = self._submit(
            context, DEPLOYMENT_PARTITION,
            command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE,
                    {"resources": resources,
                     **self._tenant_fields(context, request.tenantId)}),
        )
        deployments = [
            pb.Deployment(process=pb.ProcessMetadata(
                bpmnProcessId=m["bpmnProcessId"], version=m["version"],
                processDefinitionKey=m["processDefinitionKey"],
                resourceName=m["resourceName"],
                tenantId=m.get("tenantId") or DEFAULT_TENANT,
            ))
            for m in record.value.get("processesMetadata", [])
        ]
        for m in record.value.get("formMetadata", []):
            deployments.append(pb.Deployment(form=pb.FormMetadata(
                formId=m.get("formId", ""), version=m.get("version", 1),
                formKey=m.get("formKey", -1),
                resourceName=m.get("resourceName", ""),
                tenantId=m.get("tenantId") or DEFAULT_TENANT,
            )))
        for m in record.value.get("decisionsMetadata", []):
            deployments.append(pb.Deployment(decision=pb.DecisionMetadata(
                dmnDecisionId=m.get("decisionId", ""),
                dmnDecisionName=m.get("decisionName", ""),
                version=m.get("version", 1), decisionKey=m.get("decisionKey", -1),
                dmnDecisionRequirementsId=m.get("decisionRequirementsId", ""),
                decisionRequirementsKey=m.get("decisionRequirementsKey", -1),
                tenantId=m.get("tenantId") or DEFAULT_TENANT,
            )))
        return pb.DeployResourceResponse(
            key=record.key, deployments=deployments,
            tenantId=record.value.get("tenantId") or DEFAULT_TENANT,
        )

    # -- process instances -----------------------------------------------------

    def CreateProcessInstance(self, request, context):
        partition = self.runtime.partition_for_new_instance()
        value = {
            "bpmnProcessId": request.bpmnProcessId,
            "processDefinitionKey": request.processDefinitionKey or -1,
            "version": request.version or -1,
            "variables": self._parse_vars(context, request.variables),
            **self._tenant_fields(context, request.tenantId),
        }
        if request.startInstructions:
            value["startInstructions"] = [
                {"elementId": si.elementId} for si in request.startInstructions
            ]
        record = self._submit(
            context, partition,
            command(ValueType.PROCESS_INSTANCE_CREATION,
                    ProcessInstanceCreationIntent.CREATE, value),
        )
        return pb.CreateProcessInstanceResponse(
            processDefinitionKey=record.value.get("processDefinitionKey", -1),
            bpmnProcessId=record.value.get("bpmnProcessId", ""),
            version=record.value.get("version", -1),
            processInstanceKey=record.value.get("processInstanceKey", -1),
            tenantId=record.value.get("tenantId") or DEFAULT_TENANT,
        )

    def CreateProcessInstanceWithResult(self, request, context):
        """The engine parks the request and answers it from the root-completion
        step with the final variables (ProcessInstanceResultIntent.COMPLETED)."""
        inner = request.request
        partition = self.runtime.partition_for_new_instance()
        value = {
            "bpmnProcessId": inner.bpmnProcessId,
            "processDefinitionKey": inner.processDefinitionKey or -1,
            "version": inner.version or -1,
            "variables": self._parse_vars(context, inner.variables),
            "awaitResult": True,
            "fetchVariables": list(request.fetchVariables),
            **self._tenant_fields(context, inner.tenantId),
        }
        timeout_s = (request.requestTimeout or 10_000) / 1000
        record = self._submit(
            context, partition,
            command(ValueType.PROCESS_INSTANCE_CREATION,
                    ProcessInstanceCreationIntent.CREATE, value),
            timeout_s=timeout_s,
        )
        return pb.CreateProcessInstanceWithResultResponse(
            processDefinitionKey=record.value.get("processDefinitionKey", -1),
            bpmnProcessId=record.value.get("bpmnProcessId", ""),
            version=record.value.get("version", -1),
            processInstanceKey=record.value.get("processInstanceKey", -1),
            variables=json.dumps(record.value.get("variables", {})),
            tenantId=record.value.get("tenantId") or DEFAULT_TENANT,
        )

    def CancelProcessInstance(self, request, context):
        partition = self.runtime.partition_for_key(request.processInstanceKey)
        self._submit(
            context, partition,
            command(ValueType.PROCESS_INSTANCE, ProcessInstanceIntent.CANCEL,
                    {}, key=request.processInstanceKey),
        )
        return pb.CancelProcessInstanceResponse()

    # -- messages / signals ----------------------------------------------------

    def PublishMessage(self, request, context):
        partition = self.runtime.partition_for_correlation_key(request.correlationKey)
        record = self._submit(
            context, partition,
            command(ValueType.MESSAGE, MessageIntent.PUBLISH, {
                "name": request.name,
                "correlationKey": request.correlationKey,
                "timeToLive": request.timeToLive,
                "messageId": request.messageId,
                "variables": self._parse_vars(context, request.variables),
                **self._tenant_fields(context, request.tenantId),
            }),
        )
        return pb.PublishMessageResponse(
            key=record.key,
            tenantId=record.value.get("tenantId") or DEFAULT_TENANT)

    def BroadcastSignal(self, request, context):
        record = self._submit(
            context, DEPLOYMENT_PARTITION,
            command(ValueType.SIGNAL, SignalIntent.BROADCAST, {
                "signalName": request.signalName,
                "variables": self._parse_vars(context, request.variables),
                **self._tenant_fields(context, request.tenantId),
            }),
        )
        return pb.BroadcastSignalResponse(
            key=record.key,
            tenantId=record.value.get("tenantId") or DEFAULT_TENANT)

    # -- jobs ------------------------------------------------------------------

    def ActivateJobs(self, request, context):
        """Fan out across partitions round-robin until maxJobs or all empty;
        park until requestTimeout if nothing was activated, woken by the
        jobs-available notification (reference:
        LongPollingActivateJobsHandler.java:36 — no poll loop)."""
        deadline = time.time() + max((request.requestTimeout or 0), 0) / 1000
        remaining = request.maxJobsToActivate or 32
        tenant_filter = self._tenant_ids_field(context, request.tenantIds)
        hub = getattr(self.runtime, "jobs_hub", None)
        while context.is_active():
            seen_version = hub.version(request.type) if hub is not None else 0
            jobs = []
            for partition_id in range(1, self.runtime.partition_count + 1):
                if remaining <= 0 or not context.is_active():
                    break
                # peek before writing: an idle long-poller must not flood the
                # replicated log with empty JOB_BATCH ACTIVATE commands —
                # including when only OTHER tenants' jobs woke the hub. The
                # peek must mirror the engine's filter default ([default
                # tenant] when the field is omitted), or residual tenant jobs
                # would make every wakeup write an empty activation.
                if not self.runtime.has_activatable_jobs(
                        partition_id, request.type,
                        tenant_filter.get("tenantIds", [DEFAULT_TENANT])):
                    continue
                record = self._submit(
                    context, partition_id,
                    command(ValueType.JOB_BATCH, JobBatchIntent.ACTIVATE, {
                        "type": request.type,
                        "worker": request.worker or "default",
                        "timeout": request.timeout or 300_000,
                        "maxJobsToActivate": remaining,
                        **tenant_filter,
                    }),
                )
                for key, job in zip(record.value.get("jobKeys", []),
                                    record.value.get("jobs", [])):
                    jobs.append(self._activated_job(request, key, job))
                    remaining -= 1
            if jobs:
                yield pb.ActivateJobsResponse(jobs=jobs)
                return
            now = time.time()
            if now >= deadline:
                return
            _M_LONG_POLL_QUEUED.inc()
            try:
                if hub is not None:
                    # bounded wait so client cancellation is noticed promptly
                    hub.wait(request.type, seen_version, min(deadline - now, 1.0))
                else:
                    time.sleep(0.02)
            finally:
                _M_LONG_POLL_QUEUED.dec()

    def StreamActivatedJobs(self, request, context):
        """Job push: register a client stream with the dispatcher; the broker
        side's jobs-available side effect activates jobs and feeds them here
        with no polling (reference: StreamJobsHandler.java:36 →
        ClientStreamManager → broker RemoteStreamRegistry push)."""
        import queue as _queue

        tenant_filter = self._tenant_ids_field(context, request.tenantIds)
        streams = self.runtime.job_streams
        handle = streams.add_stream(
            request.type, request.worker or "default", request.timeout or 300_000,
            tenant_ids=tenant_filter.get("tenantIds"),
        )
        in_flight = None
        try:
            while context.is_active():
                try:
                    in_flight = handle.jobs.get(timeout=0.25)
                except _queue.Empty:
                    continue
                key, job = in_flight
                yield self._activated_job(request, key, job)
                in_flight = None
        finally:
            # in_flight: dequeued but the client died before/while receiving
            # it — hand it to another stream or yield it back
            streams.remove_stream(handle, in_flight=in_flight)

    def _activated_job(self, request, key: int, job: dict) -> "pb.ActivatedJob":
        return pb.ActivatedJob(
            key=key,
            type=job.get("type", request.type),
            processInstanceKey=job.get("processInstanceKey", -1),
            bpmnProcessId=job.get("bpmnProcessId", ""),
            processDefinitionVersion=job.get("processDefinitionVersion", -1),
            processDefinitionKey=job.get("processDefinitionKey", -1),
            elementId=job.get("elementId", ""),
            elementInstanceKey=job.get("elementInstanceKey", -1),
            customHeaders=json.dumps(job.get("customHeaders", {})),
            worker=job.get("worker", ""),
            retries=job.get("retries", 3),
            deadline=job.get("deadline", -1),
            variables=json.dumps(job.get("variables", {})),
            tenantId=job.get("tenantId") or DEFAULT_TENANT,
        )

    def CompleteJob(self, request, context):
        self._job_command(context, request.jobKey, JobIntent.COMPLETE, {
            "variables": self._parse_vars(context, request.variables),
        })
        return pb.CompleteJobResponse()

    def FailJob(self, request, context):
        self._job_command(context, request.jobKey, JobIntent.FAIL, {
            "retries": request.retries,
            "errorMessage": request.errorMessage,
            "retryBackOff": request.retryBackOff,
            "variables": self._parse_vars(context, request.variables),
        })
        return pb.FailJobResponse()

    def ThrowError(self, request, context):
        self._job_command(context, request.jobKey, JobIntent.THROW_ERROR, {
            "errorCode": request.errorCode,
            "errorMessage": request.errorMessage,
            "variables": self._parse_vars(context, request.variables),
        })
        return pb.ThrowErrorResponse()

    def UpdateJobRetries(self, request, context):
        self._job_command(context, request.jobKey, JobIntent.UPDATE_RETRIES, {
            "retries": request.retries,
        })
        return pb.UpdateJobRetriesResponse()

    def UpdateJobTimeout(self, request, context):
        self._job_command(context, request.jobKey, JobIntent.UPDATE_TIMEOUT, {
            "timeout": request.timeout,
        })
        return pb.UpdateJobTimeoutResponse()

    def _job_command(self, context, job_key: int, intent, value: dict):
        partition = self.runtime.partition_for_key(job_key)
        return self._submit(
            context, partition,
            command(ValueType.JOB, intent, value, key=job_key),
        )

    # -- variables / incidents -------------------------------------------------

    def SetVariables(self, request, context):
        partition = self.runtime.partition_for_key(request.elementInstanceKey)
        record = self._submit(
            context, partition,
            command(ValueType.VARIABLE_DOCUMENT, VariableDocumentIntent.UPDATE, {
                "scopeKey": request.elementInstanceKey,
                "variables": self._parse_vars(context, request.variables),
                "local": request.local,
            }),
        )
        return pb.SetVariablesResponse(key=record.key)

    def ResolveIncident(self, request, context):
        partition = self.runtime.partition_for_key(request.incidentKey)
        self._submit(
            context, partition,
            command(ValueType.INCIDENT, IncidentIntent.RESOLVE, {},
                    key=request.incidentKey),
        )
        return pb.ResolveIncidentResponse()

    # -- pending engine features ----------------------------------------------

    def ModifyProcessInstance(self, request, context):
        from zeebe_tpu_torch.protocol.intent import ProcessInstanceModificationIntent

        partition = self.runtime.partition_for_key(request.processInstanceKey)
        value = {
            "activateInstructions": [
                {
                    "elementId": ai.elementId,
                    "ancestorElementInstanceKey": ai.ancestorElementInstanceKey or -1,
                    "variableInstructions": [
                        {"variables": self._parse_vars(context, vi.variables),
                         "scopeId": vi.scopeId}
                        for vi in ai.variableInstructions
                    ],
                }
                for ai in request.activateInstructions
            ],
            "terminateInstructions": [
                {"elementInstanceKey": ti.elementInstanceKey}
                for ti in request.terminateInstructions
            ],
        }
        self._submit(
            context, partition,
            command(ValueType.PROCESS_INSTANCE_MODIFICATION,
                    ProcessInstanceModificationIntent.MODIFY, value,
                    key=request.processInstanceKey),
        )
        return pb.ModifyProcessInstanceResponse()

    def MigrateProcessInstance(self, request, context):
        from zeebe_tpu_torch.protocol.intent import ProcessInstanceMigrationIntent

        partition = self.runtime.partition_for_key(request.processInstanceKey)
        plan = request.migrationPlan
        value = {
            "migrationPlan": {
                "targetProcessDefinitionKey": plan.targetProcessDefinitionKey,
                "mappingInstructions": [
                    {"sourceElementId": m.sourceElementId,
                     "targetElementId": m.targetElementId}
                    for m in plan.mappingInstructions
                ],
            },
        }
        self._submit(
            context, partition,
            command(ValueType.PROCESS_INSTANCE_MIGRATION,
                    ProcessInstanceMigrationIntent.MIGRATE, value,
                    key=request.processInstanceKey),
        )
        return pb.MigrateProcessInstanceResponse()

    def EvaluateDecision(self, request, context):
        from zeebe_tpu_torch.protocol.intent import DecisionEvaluationIntent

        record = self._submit(
            context, DEPLOYMENT_PARTITION,
            command(ValueType.DECISION_EVALUATION, DecisionEvaluationIntent.EVALUATE, {
                "decisionId": request.decisionId,
                "decisionKey": request.decisionKey or -1,
                "variables": self._parse_vars(context, request.variables),
                **self._tenant_fields(context, request.tenantId),
            }),
        )
        v = record.value
        return pb.EvaluateDecisionResponse(
            decisionKey=v.get("decisionKey", -1),
            decisionId=v.get("decisionId", ""),
            decisionName=v.get("decisionName", ""),
            decisionVersion=v.get("decisionVersion", -1),
            decisionRequirementsId=v.get("decisionRequirementsId", ""),
            decisionRequirementsKey=v.get("decisionRequirementsKey", -1),
            decisionOutput=json.dumps(v.get("decisionOutput")),
            failedDecisionId=v.get("failedDecisionId", ""),
            failureMessage=v.get("evaluationFailureMessage", ""),
            tenantId=v.get("tenantId") or DEFAULT_TENANT,
            decisionInstanceKey=record.key,
            evaluatedDecisions=[
                pb.EvaluatedDecision(
                    decisionId=d.get("decisionId", ""),
                    decisionName=d.get("decisionName", ""),
                    decisionType=d.get("decisionType", ""),
                    decisionOutput=json.dumps(d.get("decisionOutput")),
                    tenantId="<default>",
                    evaluatedInputs=[
                        pb.EvaluatedDecisionInput(
                            inputId=i.get("inputId", ""),
                            inputName=i.get("inputName", ""),
                            inputValue=json.dumps(i.get("inputValue")),
                        ) for i in d.get("evaluatedInputs", [])
                    ],
                    matchedRules=[
                        pb.MatchedDecisionRule(
                            ruleId=r.get("ruleId", ""),
                            ruleIndex=r.get("ruleIndex", 0),
                            evaluatedOutputs=[
                                pb.EvaluatedDecisionOutput(
                                    outputId=o.get("outputId", ""),
                                    outputName=o.get("outputName", ""),
                                    outputValue=json.dumps(o.get("outputValue")),
                                ) for o in r.get("evaluatedOutputs", [])
                            ],
                        ) for r in d.get("matchedRules", [])
                    ],
                ) for d in v.get("evaluatedDecisions", [])
            ],
        )

    def DeleteResource(self, request, context):
        from zeebe_tpu_torch.protocol.intent import ResourceDeletionIntent

        # resources live on the partition that minted their key
        partition = self.runtime.partition_for_key(request.resourceKey)
        self._submit(
            context, partition,
            command(ValueType.RESOURCE_DELETION, ResourceDeletionIntent.DELETE,
                    {"resourceKey": request.resourceKey}),
        )
        return pb.DeleteResourceResponse()

    # -- plumbing --------------------------------------------------------------

    def _parse_vars(self, context, json_str: str) -> dict:
        try:
            return _vars(json_str)
        except (json.JSONDecodeError, ValueError) as exc:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))

    def _submit(self, context, partition_id: int, record, timeout_s: float = 10.0):
        try:
            response = self.runtime.submit(partition_id, record, timeout_s=timeout_s)
        except NoLeaderError as exc:
            context.abort(grpc.StatusCode.UNAVAILABLE, str(exc))
        except ResourceExhaustedError as exc:
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(exc))
        except RequestTimeoutError as exc:
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(exc))
        if response.is_rejection:
            context.abort(
                _rejection_status(response.rejection_type.name),
                response.rejection_reason,
            )
        return response


def _rejection_status(rejection_type: str) -> grpc.StatusCode:
    return {
        "INVALID_ARGUMENT": grpc.StatusCode.INVALID_ARGUMENT,
        "NOT_FOUND": grpc.StatusCode.NOT_FOUND,
        "ALREADY_EXISTS": grpc.StatusCode.ALREADY_EXISTS,
        "INVALID_STATE": grpc.StatusCode.FAILED_PRECONDITION,
        "PROCESSING_ERROR": grpc.StatusCode.INTERNAL,
        "EXCEEDED_BATCH_RECORD_SIZE": grpc.StatusCode.RESOURCE_EXHAUSTED,
    }.get(rejection_type, grpc.StatusCode.UNKNOWN)


_SERVICE = "gateway_protocol.Gateway"

_UNARY = {
    "Topology": (pb.TopologyRequest, pb.TopologyResponse),
    "DeployResource": (pb.DeployResourceRequest, pb.DeployResourceResponse),
    "CreateProcessInstance": (pb.CreateProcessInstanceRequest, pb.CreateProcessInstanceResponse),
    "CreateProcessInstanceWithResult": (pb.CreateProcessInstanceWithResultRequest, pb.CreateProcessInstanceWithResultResponse),
    "CancelProcessInstance": (pb.CancelProcessInstanceRequest, pb.CancelProcessInstanceResponse),
    "PublishMessage": (pb.PublishMessageRequest, pb.PublishMessageResponse),
    "CompleteJob": (pb.CompleteJobRequest, pb.CompleteJobResponse),
    "FailJob": (pb.FailJobRequest, pb.FailJobResponse),
    "ThrowError": (pb.ThrowErrorRequest, pb.ThrowErrorResponse),
    "UpdateJobRetries": (pb.UpdateJobRetriesRequest, pb.UpdateJobRetriesResponse),
    "UpdateJobTimeout": (pb.UpdateJobTimeoutRequest, pb.UpdateJobTimeoutResponse),
    "SetVariables": (pb.SetVariablesRequest, pb.SetVariablesResponse),
    "ResolveIncident": (pb.ResolveIncidentRequest, pb.ResolveIncidentResponse),
    "BroadcastSignal": (pb.BroadcastSignalRequest, pb.BroadcastSignalResponse),
    "ModifyProcessInstance": (pb.ModifyProcessInstanceRequest, pb.ModifyProcessInstanceResponse),
    "MigrateProcessInstance": (pb.MigrateProcessInstanceRequest, pb.MigrateProcessInstanceResponse),
    "EvaluateDecision": (pb.EvaluateDecisionRequest, pb.EvaluateDecisionResponse),
    "DeleteResource": (pb.DeleteResourceRequest, pb.DeleteResourceResponse),
}

_SERVER_STREAMING = {
    "ActivateJobs": (pb.ActivateJobsRequest, pb.ActivateJobsResponse),
    "StreamActivatedJobs": (pb.StreamActivatedJobsRequest, pb.ActivatedJob),
}


class Gateway:
    """Boots the gRPC server over a ClusterRuntime (StandaloneGateway +
    embedded-broker mode in one; reference: dist StandaloneGateway.java)."""

    def __init__(self, runtime: ClusterRuntime, bind: str = "127.0.0.1:0",
                 max_workers: int = 16,
                 auth: TenantAuthorizer | None = None,
                 oauth: "OAuthValidator | None" = None,
                 extra_interceptors: tuple = ()) -> None:
        self.runtime = runtime
        if auth is None:
            auth = TenantAuthorizer(oauth=oauth)
        elif oauth is not None and auth.oauth is None:
            # the JWT's authorized_tenants claim feeds tenant authorization
            auth.oauth = oauth
        self.service = GatewayService(runtime, auth=auth)
        handlers = {}
        for name, (req_cls, resp_cls) in _UNARY.items():
            handlers[name] = grpc.unary_unary_rpc_method_handler(
                _wrap(getattr(self.service, name)),
                request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString,
            )
        for name, (req_cls, resp_cls) in _SERVER_STREAMING.items():
            handlers[name] = grpc.unary_stream_rpc_method_handler(
                _wrap(getattr(self.service, name)),
                request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString,
            )
        interceptors = ()
        if oauth is not None and oauth.enabled:
            # authenticate before any handler runs (IdentityInterceptor seam)
            from zeebe_tpu_torch.gateway.oauth import auth_server_interceptor

            interceptors = (auth_server_interceptor(oauth),)
        # externally-loaded interceptors run AFTER auth, like the
        # reference's InterceptorRepository chain (utils/external_code)
        interceptors = interceptors + tuple(extra_interceptors or ())
        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            interceptors=interceptors,
        )
        self.server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_SERVICE, handlers),)
        )
        self.port = self.server.add_insecure_port(bind)

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def start(self) -> None:
        self.server.start()

    def stop(self, grace: float = 1.0) -> None:
        self.server.stop(grace)


def _wrap(method: Callable) -> Callable:
    """Per-rpc request metrics (reference: the gateway's gRPC Prometheus
    interceptor — request totals + latency by method)."""
    import time as _time

    from zeebe_tpu_torch.utils.metrics import REGISTRY

    rpc = method.__name__
    total = REGISTRY.counter(
        "gateway_total_requests", "gateway rpc invocations", ("rpc",)
    ).labels(rpc)
    failed = REGISTRY.counter(
        "gateway_failed_requests", "gateway rpc failures", ("rpc",)
    ).labels(rpc)
    latency = REGISTRY.histogram(
        "gateway_request_latency", "seconds per gateway rpc", ("rpc",)
    ).labels(rpc)

    def handler(request, context):
        total.inc()
        start = _time.perf_counter()
        try:
            return method(request, context)
        except Exception:
            failed.inc()
            raise
        finally:
            latency.observe(_time.perf_counter() - start)

    return handler
