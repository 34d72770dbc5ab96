# tests/test_multitenancy.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Multi-tenancy tests: tenant-scoped definitions, jobs, messages, and the
gateway's tenant authorization.

Reference: engine multitenancy (TenantAuthorizationChecker, DbTenantAwareKey
state scoping), gateway interceptors/impl/IdentityInterceptor.java,
auth/impl/Authorization.java."""

from __future__ import annotations

import grpc
import pytest

from zeebe_tpu_torch.client import ZeebeTpuClient
from zeebe_tpu_torch.gateway import ClusterRuntime, Gateway
from zeebe_tpu_torch.gateway.auth import GatewayAuthConfig, TenantAuthorizer
from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
from zeebe_tpu_torch.protocol import DEFAULT_TENANT, ValueType, command
from zeebe_tpu_torch.protocol.intent import (
    DeploymentIntent,
    JobIntent,
    MessageIntent,
    ProcessInstanceCreationIntent,
    ProcessInstanceIntent,
)
from zeebe_tpu_torch.testing import EngineHarness


def one_task(pid="p", job_type="w"):
    return to_bpmn_xml(
        Bpmn.create_executable_process(pid)
        .start_event("s").service_task("t", job_type=job_type).end_event("e").done()
    )


def msg_catch(pid="m", name="msg"):
    return to_bpmn_xml(
        Bpmn.create_executable_process(pid)
        .start_event("s")
        .intermediate_catch_message("c", message_name=name, correlation_key="=key")
        .end_event("e").done()
    )


def deploy_tenant(h: EngineHarness, xml: str, tenant: str, request_id: int = 1):
    h.write_command(
        command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {
            "resources": [{"resourceName": "p.bpmn", "resource": xml}],
            **({"tenantId": tenant} if tenant else {}),
        }),
        request_id=request_id,
    )


def create_tenant(h: EngineHarness, pid: str, tenant: str, variables=None,
                  request_id: int = 2):
    h.write_command(
        command(ValueType.PROCESS_INSTANCE_CREATION,
                ProcessInstanceCreationIntent.CREATE, {
                    "bpmnProcessId": pid,
                    "processDefinitionKey": -1,
                    "version": -1,
                    "variables": variables or {},
                    **({"tenantId": tenant} if tenant else {}),
                }),
        request_id=request_id,
    )


class TestTenantScopedDefinitions:
    def test_same_process_id_versions_independently_per_tenant(self):
        h = EngineHarness(device="cpu")
        try:
            deploy_tenant(h, one_task("shared", "wa"), "tenant-a")
            deploy_tenant(h, one_task("shared", "wb"), "tenant-b")
            with h.db.transaction():
                meta_a = h.engine.state.processes.get_latest_by_id("shared", "tenant-a")
                meta_b = h.engine.state.processes.get_latest_by_id("shared", "tenant-b")
                assert meta_a is not None and meta_b is not None
                # each tenant starts at version 1 — no shared version counter
                assert meta_a["version"] == 1
                assert meta_b["version"] == 1
                assert meta_a["processDefinitionKey"] != meta_b["processDefinitionKey"]
                assert meta_a["tenantId"] == "tenant-a"
                # default tenant has no such definition
                assert h.engine.state.processes.get_latest_by_id("shared") is None
        finally:
            h.close()

    def test_instance_runs_in_its_tenant_and_jobs_carry_it(self):
        h = EngineHarness(device="cpu")
        try:
            deploy_tenant(h, one_task("tp", "twork"), "tenant-a")
            create_tenant(h, "tp", "tenant-a")
            jobs = [r for r in h.exporter.records
                    if r.record.value_type == ValueType.JOB
                    and r.record.intent == JobIntent.CREATED]
            assert len(jobs) == 1
            assert jobs[0].record.value["tenantId"] == "tenant-a"
            # element events carry the tenant too
            activated = [r for r in h.exporter.records
                         if r.record.value_type == ValueType.PROCESS_INSTANCE
                         and r.record.intent == ProcessInstanceIntent.ELEMENT_ACTIVATED]
            assert activated and all(
                r.record.value.get("tenantId") == "tenant-a" for r in activated)
        finally:
            h.close()

    def test_creation_cannot_cross_tenants(self):
        h = EngineHarness(device="cpu")
        try:
            deploy_tenant(h, one_task("only-a", "w"), "tenant-a")
            create_tenant(h, "only-a", "tenant-b", request_id=9)
            rejections = [r for r in h.responses if r.record.is_rejection]
            assert rejections
            assert "none found" in rejections[-1].record.rejection_reason
        finally:
            h.close()

    def test_authorized_tenants_claim_enforced(self):
        h = EngineHarness(device="cpu")
        try:
            h.write_command(
                command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {
                    "resources": [{"resourceName": "p.bpmn",
                                   "resource": one_task("auth-p", "w")}],
                    "tenantId": "tenant-a",
                    "authorizedTenants": ["tenant-b"],
                }),
                request_id=11,
            )
            rejections = [r for r in h.responses if r.record.is_rejection]
            assert rejections and "not authorized" in rejections[-1].record.rejection_reason
        finally:
            h.close()

    def test_default_tenant_records_stay_unchanged(self):
        # parity guard: a default-tenant instance's records must not grow a
        # tenantId field (kernel/burst output equality depends on it)
        h = EngineHarness(device="cpu")
        try:
            h.deploy(one_task("plain", "pw"))
            h.create_instance("plain")
            for r in h.exporter.records:
                assert "tenantId" not in (r.record.value or {})
        finally:
            h.close()


class TestTenantScopedJobs:
    def test_activation_filters_by_tenant(self):
        h = EngineHarness(device="cpu")
        try:
            deploy_tenant(h, one_task("jp", "jwork"), "tenant-a")
            create_tenant(h, "jp", "tenant-a")
            with h.db.transaction():
                # wrong tenant sees nothing
                assert h.engine.state.jobs.activatable_keys(
                    "jwork", 10, ["tenant-b"]) == []
                assert h.engine.state.jobs.activatable_keys(
                    "jwork", 10, [DEFAULT_TENANT]) == []
                # right tenant sees the job
                keys = h.engine.state.jobs.activatable_keys(
                    "jwork", 10, ["tenant-a"])
                assert len(keys) == 1
        finally:
            h.close()


class TestTenantScopedMessages:
    def test_correlation_does_not_cross_tenants(self):
        h = EngineHarness(device="cpu")
        try:
            deploy_tenant(h, msg_catch("mc", "greet"), "tenant-a")
            create_tenant(h, "mc", "tenant-a", variables={"key": "k1"})
            # same name+key published in ANOTHER tenant: no correlation
            h.write_command(
                command(ValueType.MESSAGE, MessageIntent.PUBLISH, {
                    "name": "greet", "correlationKey": "k1",
                    "timeToLive": 10_000, "messageId": "",
                    "variables": {}, "tenantId": "tenant-b",
                }),
                request_id=21,
            )
            catch_completed = [r for r in h.exporter.records
                               if r.record.value_type == ValueType.PROCESS_INSTANCE
                               and r.record.intent == ProcessInstanceIntent.ELEMENT_COMPLETED
                               and r.record.value.get("elementId") == "c"]
            assert catch_completed == []
            # same tenant: correlates and the instance finishes
            h.write_command(
                command(ValueType.MESSAGE, MessageIntent.PUBLISH, {
                    "name": "greet", "correlationKey": "k1",
                    "timeToLive": 10_000, "messageId": "",
                    "variables": {}, "tenantId": "tenant-a",
                }),
                request_id=22,
            )
            done = [r for r in h.exporter.records
                    if r.record.value_type == ValueType.PROCESS_INSTANCE
                    and r.record.intent == ProcessInstanceIntent.ELEMENT_COMPLETED
                    and r.record.value.get("bpmnElementType") == "PROCESS"]
            assert len(done) == 1
        finally:
            h.close()


class TestTenantTimerStart:
    def test_timer_start_event_fires_in_its_tenant(self):
        h = EngineHarness(device="cpu")
        try:
            xml = to_bpmn_xml(
                Bpmn.create_executable_process("tstart")
                .timer_start_event("s", cycle="R3/PT10S")
                .service_task("t", job_type="tw").end_event("e").done()
            )
            deploy_tenant(h, xml, "tenant-a")
            h.advance_time(11_000)
            created = [r for r in h.exporter.records
                       if r.record.value_type == ValueType.PROCESS_INSTANCE
                       and r.record.intent == ProcessInstanceIntent.ELEMENT_ACTIVATED
                       and r.record.value.get("bpmnElementType") == "PROCESS"]
            assert len(created) == 1
            assert created[0].record.value["tenantId"] == "tenant-a"
        finally:
            h.close()


class TestTenantScopedDecisions:
    DMN = """<?xml version="1.0" encoding="UTF-8"?>
<definitions xmlns="https://www.omg.org/spec/DMN/20191111/MODEL/" id="drg-{x}"
             name="drg" namespace="test">
  <decision id="decide" name="Decide">
    <decisionTable hitPolicy="UNIQUE">
      <input id="i1"><inputExpression id="ie1" typeRef="string"><text>status</text></inputExpression></input>
      <output id="o1" name="result" typeRef="string"/>
      <rule id="r1"><inputEntry id="e1"><text>"ok"</text></inputEntry>
        <outputEntry id="oe1"><text>"{x}"</text></outputEntry></rule>
    </decisionTable>
  </decision>
</definitions>"""

    def test_same_decision_id_isolated_per_tenant(self):
        h = EngineHarness(device="cpu")
        try:
            h.write_command(
                command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {
                    "resources": [{"resourceName": "a.dmn",
                                   "resource": self.DMN.format(x="from-a")}],
                    "tenantId": "tenant-a",
                }), request_id=51)
            h.write_command(
                command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {
                    "resources": [{"resourceName": "b.dmn",
                                   "resource": self.DMN.format(x="from-b")}],
                    "tenantId": "tenant-b",
                }), request_id=52)
            with h.db.transaction():
                a = h.engine.state.decisions.latest_decision_by_id("decide", "tenant-a")
                b = h.engine.state.decisions.latest_decision_by_id("decide", "tenant-b")
                assert a is not None and b is not None
                assert a["decisionKey"] != b["decisionKey"]
                assert a["version"] == 1 and b["version"] == 1
                # no cross-tenant visibility through the default tenant
                assert h.engine.state.decisions.latest_decision_by_id("decide") is None
        finally:
            h.close()


class TestTenantMessageIdDedup:
    def test_message_id_dedup_is_tenant_scoped(self):
        h = EngineHarness(device="cpu")
        try:
            def publish(tenant, req_id):
                h.write_command(
                    command(ValueType.MESSAGE, MessageIntent.PUBLISH, {
                        "name": "n", "correlationKey": "k",
                        "timeToLive": 60_000, "messageId": "m1",
                        "variables": {},
                        **({"tenantId": tenant} if tenant else {}),
                    }),
                    request_id=req_id,
                )

            publish("tenant-a", 31)
            # same id in another tenant: allowed (no clobber of tenant-a)
            publish("tenant-b", 32)
            # tenant-a repeat: still deduplicated
            publish("tenant-a", 33)
            rejections = [r for r in h.responses if r.record.is_rejection]
            assert len(rejections) == 1
            assert "already published" in rejections[0].record.rejection_reason
        finally:
            h.close()


class TestGatewayTenantAuth:
    @pytest.fixture(scope="class")
    def stack(self):
        runtime = ClusterRuntime(broker_count=1, partition_count=1, device="cpu")
        runtime.start()
        auth = TenantAuthorizer(GatewayAuthConfig(
            multi_tenancy_enabled=True,
            token_tenants={"token-a": ["tenant-a", DEFAULT_TENANT]},
            anonymous_tenants=[DEFAULT_TENANT],
        ))
        gateway = Gateway(runtime, auth=auth)
        gateway.start()
        yield gateway
        gateway.stop()
        runtime.stop()

    def test_token_grants_tenant_access(self, stack):
        client = ZeebeTpuClient(stack.address, access_token="token-a",
                                default_tenant="tenant-a")
        try:
            deployed = client.deploy_resource(("t.bpmn", one_task("gt", "gw")))
            assert deployed["processes"][0]["bpmnProcessId"] == "gt"
            instance = client.create_instance("gt")
            assert instance.process_instance_key > 0
            jobs = client.activate_jobs("gw", request_timeout_ms=5_000,
                                        tenant_ids=["tenant-a"])
            assert len(jobs) == 1
            client.complete_job(jobs[0].key, {})
        finally:
            client.close()

    def test_anonymous_caller_denied_foreign_tenant(self, stack):
        client = ZeebeTpuClient(stack.address)  # no token
        try:
            with pytest.raises(grpc.RpcError) as err:
                client.deploy_resource(("t.bpmn", one_task("gx", "gx")),
                                       tenant_id="tenant-a")
            assert err.value.code() == grpc.StatusCode.PERMISSION_DENIED
        finally:
            client.close()

    def test_multitenancy_disabled_rejects_tenant_addressing(self):
        runtime = ClusterRuntime(broker_count=1, partition_count=1, device="cpu")
        runtime.start()
        gateway = Gateway(runtime)  # default: multi-tenancy off
        gateway.start()
        client = ZeebeTpuClient(gateway.address)
        try:
            with pytest.raises(grpc.RpcError) as err:
                client.deploy_resource(("t.bpmn", one_task("gz", "gz")),
                                       tenant_id="tenant-a")
            assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        finally:
            client.close()
            gateway.stop()
            runtime.stop()
