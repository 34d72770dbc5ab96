# tests/test_forms.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Form deployment + user-task form linkage tests.

Reference: engine state/deployment/DbFormState.java + PersistedForm,
deployment/transform FormResourceTransformer, UserTaskTransformer
(USER_TASK_FORM_KEY_HEADER_NAME header), BpmnUserTaskBehavior form
resolution → FORM_NOT_FOUND incident."""

from __future__ import annotations

import json

from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
from zeebe_tpu_torch.protocol import ValueType, command
from zeebe_tpu_torch.protocol.enums import ErrorType
from zeebe_tpu_torch.protocol.intent import (
    DeploymentIntent,
    FormIntent,
    IncidentIntent,
    JobIntent,
    ResourceDeletionIntent,
    UserTaskIntent,
)
from zeebe_tpu_torch.testing import EngineHarness

FORM_V1 = json.dumps({"id": "order-form", "components": [{"type": "textfield", "key": "name"}]})
FORM_V2 = json.dumps({"id": "order-form", "components": []})


def form_process(pid="fp", native=False):
    return to_bpmn_xml(
        Bpmn.create_executable_process(pid)
        .start_event("s")
        .user_task("u", native=native, form_id="order-form")
        .end_event("e").done()
    )


class TestFormDeployment:
    def test_deploy_versions_and_dedups(self):
        h = EngineHarness(device="cpu")
        try:
            h.deploy(("f.form", FORM_V1))
            h.deploy(("f.form", FORM_V1))  # duplicate: no new version
            h.deploy(("f.form", FORM_V2))  # changed: version 2
            created = [r for r in h.exporter.records
                       if r.record.value_type == ValueType.FORM
                       and r.record.intent == FormIntent.CREATED]
            assert [c.record.value["version"] for c in created] == [1, 2]
            with h.db.transaction():
                latest = h.engine.state.forms.get_latest_by_id("order-form")
            assert latest["version"] == 2
            assert json.loads(latest["resource"]) == json.loads(FORM_V2)
        finally:
            h.close()

    def test_deployment_metadata_includes_forms(self):
        h = EngineHarness(device="cpu")
        try:
            h.deploy(("meta.form", FORM_V1))
            deployed = [r for r in h.exporter.records
                        if r.record.value_type == ValueType.DEPLOYMENT
                        and r.record.intent == DeploymentIntent.CREATED]
            meta = deployed[-1].record.value["formMetadata"]
            assert len(meta) == 1
            assert meta[0]["formId"] == "order-form"
            assert meta[0]["formKey"] > 0
        finally:
            h.close()

    def test_invalid_form_rejected(self):
        h = EngineHarness(device="cpu")
        try:
            h.write_command(
                command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {
                    "resources": [{"resourceName": "bad.form",
                                   "resource": "{\"no\": \"id\"}"}],
                }),
                request_id=5,
            )
            rejections = [r for r in h.responses if r.record.is_rejection]
            assert rejections and "id" in rejections[-1].record.rejection_reason
        finally:
            h.close()


class TestUserTaskFormLinkage:
    def test_job_based_user_task_gets_form_key_header(self):
        h = EngineHarness(device="cpu")
        try:
            h.deploy(("f.form", FORM_V1), form_process("jp"))
            h.create_instance("jp")
            jobs = [r for r in h.exporter.records
                    if r.record.value_type == ValueType.JOB
                    and r.record.intent == JobIntent.CREATED]
            assert len(jobs) == 1
            headers = jobs[0].record.value["customHeaders"]
            with h.db.transaction():
                form = h.engine.state.forms.get_latest_by_id("order-form")
            assert headers["io.camunda.zeebe:formKey"] == str(form["formKey"])
        finally:
            h.close()

    def test_native_user_task_carries_form_key(self):
        h = EngineHarness(device="cpu")
        try:
            h.deploy(("f.form", FORM_V1), form_process("np", native=True))
            h.create_instance("np")
            tasks = [r for r in h.exporter.records
                     if r.record.value_type == ValueType.USER_TASK
                     and r.record.intent == UserTaskIntent.CREATED]
            assert len(tasks) == 1
            with h.db.transaction():
                form = h.engine.state.forms.get_latest_by_id("order-form")
            assert tasks[0].record.value["formKey"] == form["formKey"]
        finally:
            h.close()

    def test_missing_form_raises_incident(self):
        h = EngineHarness(device="cpu")
        try:
            h.deploy(form_process("mp"))  # no form deployed
            h.create_instance("mp")
            incidents = [r for r in h.exporter.records
                         if r.record.value_type == ValueType.INCIDENT
                         and r.record.intent == IncidentIntent.CREATED]
            assert len(incidents) == 1
            assert incidents[0].record.value["errorType"] == ErrorType.FORM_NOT_FOUND.name
            # resolution after deploying the form retries the activation
            h.deploy(("f.form", FORM_V1))
            h.resolve_incident(incidents[0].record.key)
            jobs = [r for r in h.exporter.records
                    if r.record.value_type == ValueType.JOB
                    and r.record.intent == JobIntent.CREATED]
            assert len(jobs) == 1
        finally:
            h.close()


class TestFormDeletion:
    def test_resource_deletion_removes_form(self):
        h = EngineHarness(device="cpu")
        try:
            h.deploy(("f.form", FORM_V1))
            with h.db.transaction():
                form_key = h.engine.state.forms.get_latest_by_id("order-form")["formKey"]
            h.write_command(
                command(ValueType.RESOURCE_DELETION, ResourceDeletionIntent.DELETE,
                        {"resourceKey": form_key}),
                request_id=7,
            )
            with h.db.transaction():
                assert h.engine.state.forms.get_latest_by_id("order-form") is None
                assert h.engine.state.forms.get_by_key(form_key) is None
        finally:
            h.close()
