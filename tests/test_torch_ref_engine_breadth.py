# tests/test_engine_breadth.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Engine breadth tests: modification, migration, resource deletion, native
user tasks (reference: engine/src/test/…/processing/processinstance/
modification + migration suites, resource/, usertask/)."""

from __future__ import annotations

import pytest

from zeebe_tpu_torch.models.bpmn import Bpmn
from zeebe_tpu_torch.protocol import ValueType, command
from zeebe_tpu_torch.protocol.intent import (
    ProcessInstanceIntent,
    ProcessInstanceMigrationIntent,
    ProcessInstanceModificationIntent,
    ResourceDeletionIntent,
    UserTaskIntent,
)
from zeebe_tpu_torch.testing import EngineHarness


@pytest.fixture()
def harness():
    h = EngineHarness(device="cpu")
    yield h
    h.close()


def two_task_model(pid="two"):
    return (
        Bpmn.create_executable_process(pid)
        .start_event("s")
        .service_task("a", job_type="work_a")
        .service_task("b", job_type="work_b")
        .end_event("e")
        .done()
    )


class TestModification:
    def test_activate_skips_ahead(self, harness):
        harness.deploy(two_task_model())
        pi = harness.create_instance("two")
        [job_a] = harness.activate_jobs("work_a")
        # jump the token from 'a' to 'b': terminate a's instance, activate b
        a_key = job_a["elementInstanceKey"]
        harness.write_command(command(
            ValueType.PROCESS_INSTANCE_MODIFICATION,
            ProcessInstanceModificationIntent.MODIFY,
            {"activateInstructions": [{"elementId": "b"}],
             "terminateInstructions": [{"elementInstanceKey": a_key}]},
            key=pi,
        ), request_id=21)
        assert harness.exporter.all().with_value_type(
            ValueType.PROCESS_INSTANCE_MODIFICATION
        ).with_intent(ProcessInstanceModificationIntent.MODIFIED).to_list()
        assert harness.activate_jobs("work_a") == []
        [job_b] = harness.activate_jobs("work_b")
        harness.complete_job(job_b["key"])
        assert harness.is_instance_done(pi)

    def test_variable_instructions_seed_scope(self, harness):
        harness.deploy(two_task_model("vmod"))
        pi = harness.create_instance("vmod")
        [job_a] = harness.activate_jobs("work_a")
        harness.write_command(command(
            ValueType.PROCESS_INSTANCE_MODIFICATION,
            ProcessInstanceModificationIntent.MODIFY,
            {"activateInstructions": [
                {"elementId": "b",
                 "variableInstructions": [{"variables": {"seeded": 99}}]}],
             "terminateInstructions": [
                {"elementInstanceKey": job_a["elementInstanceKey"]}]},
            key=pi,
        ), request_id=22)
        [job_b] = harness.activate_jobs("work_b")
        assert job_b["variables"]["seeded"] == 99

    def test_unknown_element_rejected(self, harness):
        harness.deploy(two_task_model("rej"))
        pi = harness.create_instance("rej")
        harness.write_command(command(
            ValueType.PROCESS_INSTANCE_MODIFICATION,
            ProcessInstanceModificationIntent.MODIFY,
            {"activateInstructions": [{"elementId": "ghost"}]},
            key=pi,
        ), request_id=23)
        rejections = harness.exporter.all().rejections().to_list()
        assert any(r.record.value_type == ValueType.PROCESS_INSTANCE_MODIFICATION
                   for r in rejections)


class TestMigration:
    def test_migrate_to_new_version(self, harness):
        harness.deploy(two_task_model("mig"))
        pi = harness.create_instance("mig")
        [job_a] = harness.activate_jobs("work_a")
        # v2 renames task 'a' to 'a2' (same job type)
        v2 = (
            Bpmn.create_executable_process("mig")
            .start_event("s")
            .service_task("a2", job_type="work_a")
            .service_task("b", job_type="work_b")
            .end_event("e")
            .done()
        )
        harness.deploy(v2)
        with harness.db.transaction():
            target_key = harness.engine.state.processes.get_key_by_id_version("mig", 2)
        harness.write_command(command(
            ValueType.PROCESS_INSTANCE_MIGRATION,
            ProcessInstanceMigrationIntent.MIGRATE,
            {"migrationPlan": {
                "targetProcessDefinitionKey": target_key,
                "mappingInstructions": [
                    {"sourceElementId": "a", "targetElementId": "a2"}],
            }},
            key=pi,
        ), request_id=31)
        assert harness.exporter.all().with_value_type(
            ValueType.PROCESS_INSTANCE_MIGRATION
        ).with_intent(ProcessInstanceMigrationIntent.MIGRATED).to_list()
        # instance + job retargeted onto v2
        with harness.db.transaction():
            inst = harness.engine.state.element_instances.get(pi)
            job = harness.engine.state.jobs.get(job_a["key"])
        assert inst["value"]["processDefinitionKey"] == target_key
        assert inst["value"]["version"] == 2
        assert job["elementId"] == "a2"
        assert job["processDefinitionKey"] == target_key
        # completing the migrated job continues in the NEW definition
        harness.complete_job(job_a["key"])
        [job_b] = harness.activate_jobs("work_b")
        harness.complete_job(job_b["key"])
        assert harness.is_instance_done(pi)

    def test_unmapped_element_rejected(self, harness):
        harness.deploy(two_task_model("mig2"))
        pi = harness.create_instance("mig2")
        v2 = (
            Bpmn.create_executable_process("mig2")
            .start_event("s")
            .service_task("renamed", job_type="work_a")
            .end_event("e")
            .done()
        )
        harness.deploy(v2)
        with harness.db.transaction():
            target_key = harness.engine.state.processes.get_key_by_id_version("mig2", 2)
        harness.write_command(command(
            ValueType.PROCESS_INSTANCE_MIGRATION,
            ProcessInstanceMigrationIntent.MIGRATE,
            {"migrationPlan": {"targetProcessDefinitionKey": target_key,
                               "mappingInstructions": []}},
            key=pi,
        ), request_id=32)
        rejections = harness.exporter.all().rejections().to_list()
        assert any(r.record.value_type == ValueType.PROCESS_INSTANCE_MIGRATION
                   for r in rejections)


class TestResourceDeletion:
    def test_delete_process_definition(self, harness):
        harness.deploy(two_task_model("del"))
        with harness.db.transaction():
            key = harness.engine.state.processes.get_key_by_id_version("del", 1)
        harness.write_command(command(
            ValueType.RESOURCE_DELETION, ResourceDeletionIntent.DELETE,
            {"resourceKey": key},
        ), request_id=41)
        deleted = harness.exporter.all().with_value_type(
            ValueType.RESOURCE_DELETION
        ).with_intent(ResourceDeletionIntent.DELETED).to_list()
        assert len(deleted) == 1
        # no new instances can start
        harness.write_command(command(
            ValueType.PROCESS_INSTANCE_CREATION,
            __import__("zeebe_tpu_torch.protocol.intent", fromlist=["x"]
                       ).ProcessInstanceCreationIntent.CREATE,
            {"bpmnProcessId": "del", "version": -1, "variables": {}},
        ), request_id=42)
        rejections = harness.exporter.all().rejections().to_list()
        assert any(r.record.value_type == ValueType.PROCESS_INSTANCE_CREATION
                   for r in rejections)

    def test_delete_falls_back_to_previous_version(self, harness):
        harness.deploy(two_task_model("fb"))
        v2 = (
            Bpmn.create_executable_process("fb")
            .start_event("s").service_task("x", job_type="fb_v2").end_event("e")
            .done()
        )
        harness.deploy(v2)
        with harness.db.transaction():
            v2_key = harness.engine.state.processes.get_key_by_id_version("fb", 2)
        harness.write_command(command(
            ValueType.RESOURCE_DELETION, ResourceDeletionIntent.DELETE,
            {"resourceKey": v2_key},
        ), request_id=43)
        # latest is v1 again: new instances use work_a
        harness.create_instance("fb")
        assert len(harness.activate_jobs("work_a")) == 1

    def test_delete_unknown_rejected(self, harness):
        harness.write_command(command(
            ValueType.RESOURCE_DELETION, ResourceDeletionIntent.DELETE,
            {"resourceKey": 999999},
        ), request_id=44)
        rejections = harness.exporter.all().rejections().to_list()
        assert any(r.record.value_type == ValueType.RESOURCE_DELETION
                   for r in rejections)


class TestNativeUserTasks:
    def user_task_model(self, pid="ut"):
        return (
            Bpmn.create_executable_process(pid)
            .start_event("s")
            .user_task("review", native=True, assignee="alice")
            .end_event("e")
            .done()
        )

    def _task_key(self, harness):
        created = harness.exporter.all().with_value_type(
            ValueType.USER_TASK
        ).with_intent(UserTaskIntent.CREATED).to_list()
        return created[-1].record.key

    def test_lifecycle_complete(self, harness):
        harness.deploy(self.user_task_model())
        pi = harness.create_instance("ut")
        task_key = self._task_key(harness)
        with harness.db.transaction():
            task = harness.engine.state.user_tasks.get(task_key)
        assert task["assignee"] == "alice"
        harness.write_command(command(
            ValueType.USER_TASK, UserTaskIntent.COMPLETE,
            {"variables": {"approved": True}}, key=task_key,
        ), request_id=51)
        assert harness.is_instance_done(pi)
        completed = harness.exporter.all().with_value_type(
            ValueType.USER_TASK
        ).with_intent(UserTaskIntent.COMPLETED).to_list()
        assert len(completed) == 1

    def test_claim_conflict(self, harness):
        harness.deploy(self.user_task_model("ut2"))
        harness.create_instance("ut2")
        task_key = self._task_key(harness)
        harness.write_command(command(
            ValueType.USER_TASK, UserTaskIntent.CLAIM, {"assignee": "bob"},
            key=task_key,
        ), request_id=52)
        rejections = harness.exporter.all().rejections().to_list()
        assert any(r.record.value_type == ValueType.USER_TASK for r in rejections)
        # assign overrides regardless
        harness.write_command(command(
            ValueType.USER_TASK, UserTaskIntent.ASSIGN, {"assignee": "bob"},
            key=task_key,
        ), request_id=53)
        with harness.db.transaction():
            assert harness.engine.state.user_tasks.get(task_key)["assignee"] == "bob"

    def test_cancel_on_instance_cancel(self, harness):
        harness.deploy(self.user_task_model("ut3"))
        pi = harness.create_instance("ut3")
        task_key = self._task_key(harness)
        harness.cancel_instance(pi)
        canceled = harness.exporter.all().with_value_type(
            ValueType.USER_TASK
        ).with_intent(UserTaskIntent.CANCELED).to_list()
        assert len(canceled) == 1
        with harness.db.transaction():
            assert harness.engine.state.user_tasks.get(task_key) is None
