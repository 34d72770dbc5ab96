"""Native user task lifecycle (zeebe:userTask, no job worker).

Reference: engine/…/processing/usertask/ UserTask*Processors (8.4 native user
tasks): CREATING/CREATED on activation; COMPLETE → COMPLETING/COMPLETED
completes the element; ASSIGN/CLAIM set the assignee (CLAIM rejects when
already assigned to someone else); UPDATE changes candidate groups/users/due
date; element termination cancels the task (CANCELING/CANCELED).
"""

from __future__ import annotations

from zeebe_tpu_torch.engine.engine_state import EngineState
from zeebe_tpu_torch.engine.writers import Writers
from zeebe_tpu_torch.logstreams import LoggedRecord
from zeebe_tpu_torch.protocol import RejectionType, ValueType
from zeebe_tpu_torch.protocol.intent import ProcessInstanceIntent, UserTaskIntent, VariableIntent


class UserTaskProcessors:
    def __init__(self, state: EngineState) -> None:
        self.state = state

    def _lookup(self, cmd: LoggedRecord, writers: Writers) -> dict | None:
        task = self.state.user_tasks.get(cmd.record.key)
        if task is None:
            writers.respond_rejection(
                cmd, RejectionType.NOT_FOUND,
                f"Expected to handle user task {cmd.record.key}, but none found",
            )
        return task

    def complete(self, cmd: LoggedRecord, writers: Writers) -> None:
        task = self._lookup(cmd, writers)
        if task is None:
            return
        variables = cmd.record.value.get("variables") or {}
        element_key = task["elementInstanceKey"]
        writers.append_event(
            cmd.record.key, ValueType.USER_TASK, UserTaskIntent.COMPLETING, task
        )
        # completion variables merge into the process scope like job variables
        for name, val in variables.items():
            scope = (
                self.state.variables.find_scope_with(element_key, name)
                or task.get("processInstanceKey", element_key)
            )
            exists = self.state.variables.has_local(scope, name)
            writers.append_event(
                self.state.next_key(), ValueType.VARIABLE,
                VariableIntent.UPDATED if exists else VariableIntent.CREATED,
                {"name": name, "value": val, "scopeKey": scope,
                 "processInstanceKey": task.get("processInstanceKey", -1),
                 "processDefinitionKey": task.get("processDefinitionKey", -1),
                 "bpmnProcessId": task.get("bpmnProcessId", "")},
            )
        completed = writers.append_event(
            cmd.record.key, ValueType.USER_TASK, UserTaskIntent.COMPLETED, task
        )
        writers.respond(cmd, completed)
        writers.append_command(
            element_key, ValueType.PROCESS_INSTANCE,
            ProcessInstanceIntent.COMPLETE_ELEMENT, {},
        )

    def assign(self, cmd: LoggedRecord, writers: Writers) -> None:
        task = self._lookup(cmd, writers)
        if task is None:
            return
        assignee = cmd.record.value.get("assignee", "")
        updated = {**task, "assignee": assignee}
        writers.append_event(
            cmd.record.key, ValueType.USER_TASK, UserTaskIntent.ASSIGNING, updated
        )
        assigned = writers.append_event(
            cmd.record.key, ValueType.USER_TASK, UserTaskIntent.ASSIGNED, updated
        )
        writers.respond(cmd, assigned)

    def claim(self, cmd: LoggedRecord, writers: Writers) -> None:
        task = self._lookup(cmd, writers)
        if task is None:
            return
        assignee = cmd.record.value.get("assignee", "")
        current = task.get("assignee", "")
        if current and current != assignee:
            writers.respond_rejection(
                cmd, RejectionType.INVALID_STATE,
                f"Expected to claim user task {cmd.record.key}, but it is "
                f"already assigned to '{current}'",
            )
            return
        updated = {**task, "assignee": assignee}
        assigned = writers.append_event(
            cmd.record.key, ValueType.USER_TASK, UserTaskIntent.ASSIGNED, updated
        )
        writers.respond(cmd, assigned)

    def update(self, cmd: LoggedRecord, writers: Writers) -> None:
        task = self._lookup(cmd, writers)
        if task is None:
            return
        changes = {
            k: v for k, v in cmd.record.value.items()
            if k in ("candidateGroups", "candidateUsers", "dueDate",
                     "followUpDate", "priority")
        }
        updated_value = {**task, **changes}
        updated = writers.append_event(
            cmd.record.key, ValueType.USER_TASK, UserTaskIntent.UPDATED,
            updated_value,
        )
        writers.respond(cmd, updated)
