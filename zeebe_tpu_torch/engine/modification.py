"""Process-instance modification, migration, and resource deletion.

Reference: engine/…/processing/processinstance/
ProcessInstanceModificationProcessor.java (activate/terminate arbitrary
elements with variable instructions), ProcessInstanceMigration processors
(8.4: map active element instances onto a target definition via mapping
instructions), and resource/ResourceDeletionDeleteProcessor (delete a
deployed process definition or DRG, closing its start subscriptions).
"""

from __future__ import annotations

from zeebe_tpu_torch.engine.engine_state import (
    EI_ACTIVATED,
    EI_ACTIVATING,
    EngineState,
)
from zeebe_tpu_torch.engine.writers import Writers
from zeebe_tpu_torch.logstreams import LoggedRecord
from zeebe_tpu_torch.protocol import RejectionType, ValueType
from zeebe_tpu_torch.protocol.enums import BpmnElementType
from zeebe_tpu_torch.protocol.intent import (
    ProcessInstanceIntent,
    ProcessInstanceMigrationIntent,
    ProcessInstanceModificationIntent,
    ResourceDeletionIntent,
    VariableIntent,
)


def _descendants(state: EngineState, scope_key: int) -> list[int]:
    """All transitive element-instance children of a scope."""
    out = []
    stack = [scope_key]
    while stack:
        key = stack.pop()
        children = state.element_instances.children_keys(key)
        out.extend(children)
        stack.extend(children)
    return out


class ProcessInstanceModificationProcessor:
    """PROCESS_INSTANCE_MODIFICATION MODIFY (key = process instance key)."""

    def __init__(self, state: EngineState, bpmn) -> None:
        self.state = state
        self.bpmn = bpmn

    def process(self, cmd: LoggedRecord, writers: Writers) -> None:
        pi_key = cmd.record.key
        value = cmd.record.value
        instance = self.state.element_instances.get(pi_key)
        if instance is None:
            writers.respond_rejection(
                cmd, RejectionType.NOT_FOUND,
                f"Expected to modify process instance {pi_key}, but none found",
            )
            return
        pi_value = instance["value"]
        exe = self.state.processes.executable(pi_value["processDefinitionKey"])
        activate = value.get("activateInstructions", [])
        terminate = value.get("terminateInstructions", [])

        # validate everything before writing anything (all-or-nothing command)
        plans = []
        for instruction in activate:
            element_id = instruction.get("elementId", "")
            if element_id not in exe.by_id:
                writers.respond_rejection(
                    cmd, RejectionType.INVALID_ARGUMENT,
                    f"Expected to activate element '{element_id}', but no such "
                    "element in the process definition",
                )
                return
            element = exe.elements[exe.by_id[element_id]]
            scope_key = self._resolve_scope(
                pi_key, exe, element,
                instruction.get("ancestorElementInstanceKey", -1),
            )
            if scope_key is None:
                writers.respond_rejection(
                    cmd, RejectionType.INVALID_STATE,
                    f"Expected to activate element '{element_id}', but its flow "
                    "scope is not active exactly once; pass "
                    "ancestorElementInstanceKey to disambiguate",
                )
                return
            plans.append((element, scope_key, instruction))
        for instruction in terminate:
            target = instruction.get("elementInstanceKey", -1)
            target_instance = self.state.element_instances.get(target)
            if target_instance is None or \
                    target_instance["value"].get("processInstanceKey") != pi_key:
                writers.respond_rejection(
                    cmd, RejectionType.NOT_FOUND,
                    f"Expected to terminate element instance {target}, but it "
                    "is not an active element of this process instance",
                )
                return

        modified = writers.append_event(
            pi_key, ValueType.PROCESS_INSTANCE_MODIFICATION,
            ProcessInstanceModificationIntent.MODIFIED, dict(value),
        )
        writers.respond(cmd, modified)
        # activations BEFORE terminations: terminating the last active child
        # first would complete the whole scope before the new tokens exist
        # (reference: ProcessInstanceModificationProcessor ordering)
        for element, scope_key, instruction in plans:
            # variable instructions seed the target scope (or the scope named
            # by scopeId) before activation
            for var_inst in instruction.get("variableInstructions", []):
                target_scope = self._variable_scope(
                    pi_key, scope_key, var_inst.get("scopeId", "")
                )
                for name, val in (var_inst.get("variables") or {}).items():
                    writers.append_event(
                        self.state.next_key(), ValueType.VARIABLE,
                        VariableIntent.CREATED,
                        {"name": name, "value": val, "scopeKey": target_scope,
                         "processInstanceKey": pi_key,
                         "processDefinitionKey": pi_value["processDefinitionKey"],
                         "bpmnProcessId": pi_value["bpmnProcessId"]},
                    )
            # no sequence-flow token is in transit for a modification-activated
            # element; the marker keeps the applier's token accounting honest
            self.bpmn._write_activate(writers, exe, element, scope_key, pi_value,
                                      extra={"directActivation": True})
        for instruction in terminate:
            writers.append_command(
                instruction["elementInstanceKey"], ValueType.PROCESS_INSTANCE,
                ProcessInstanceIntent.TERMINATE_ELEMENT, {},
            )

    def _variable_scope(self, pi_key: int, default_scope: int,
                        scope_id: str) -> int:
        """scopeId names an element whose unique active instance receives the
        variables; default is the activated element's flow scope."""
        if not scope_id:
            return default_scope
        root = self.state.element_instances.get(pi_key)
        if root is not None and root["value"].get("bpmnProcessId") == scope_id:
            return pi_key
        candidates = [
            key for key in _descendants(self.state, pi_key)
            if (inst := self.state.element_instances.get(key)) is not None
            and inst["value"].get("elementId") == scope_id
        ]
        return candidates[0] if len(candidates) == 1 else default_scope

    def _resolve_scope(self, pi_key: int, exe, element,
                       ancestor_key: int) -> int | None:
        """The element's flow scope instance: the process root, an explicit
        ancestor, or the unique active instance of the parent scope element."""
        if ancestor_key > 0:
            ancestor = self.state.element_instances.get(ancestor_key)
            if ancestor is None or ancestor["value"].get(
                    "processInstanceKey", ancestor_key) != pi_key:
                return None  # foreign or dead ancestor: reject
            return ancestor_key
        parent_idx = element.parent_idx
        if parent_idx == 0:
            return pi_key
        parent_id = exe.elements[parent_idx].id
        candidates = [
            key for key in _descendants(self.state, pi_key)
            if (inst := self.state.element_instances.get(key)) is not None
            and inst["value"].get("elementId") == parent_id
            and inst["state"] in (EI_ACTIVATED, EI_ACTIVATING)
        ]
        return candidates[0] if len(candidates) == 1 else None



class ProcessInstanceMigrationProcessor:
    """PROCESS_INSTANCE_MIGRATION MIGRATE (key = process instance key)."""

    def __init__(self, state: EngineState) -> None:
        self.state = state

    def process(self, cmd: LoggedRecord, writers: Writers) -> None:
        pi_key = cmd.record.key
        value = cmd.record.value
        plan = value.get("migrationPlan", {})
        target_key = plan.get("targetProcessDefinitionKey", -1)
        mappings = {
            m["sourceElementId"]: m["targetElementId"]
            for m in plan.get("mappingInstructions", [])
        }
        instance = self.state.element_instances.get(pi_key)
        if instance is None:
            writers.respond_rejection(
                cmd, RejectionType.NOT_FOUND,
                f"Expected to migrate process instance {pi_key}, but none found",
            )
            return
        target_meta = self.state.processes.get_by_key(target_key)
        target_exe = (self.state.processes.executable(target_key)
                      if target_meta else None)
        if target_exe is None:
            writers.respond_rejection(
                cmd, RejectionType.NOT_FOUND,
                f"Expected to migrate to process definition {target_key}, "
                "but no such definition deployed",
            )
            return
        # every active element must map onto an element of the target
        # definition (same id by default, or via a mapping instruction)
        tree = [pi_key] + _descendants(self.state, pi_key)
        element_updates: list[tuple[int, str]] = []
        for key in tree:
            inst = self.state.element_instances.get(key)
            if inst is None:
                continue
            source_id = inst["value"].get("elementId", "")
            if key == pi_key:
                element_updates.append((key, target_exe.elements[0].id))
                continue
            target_id = mappings.get(source_id, source_id)
            if target_id not in target_exe.by_id:
                writers.respond_rejection(
                    cmd, RejectionType.INVALID_STATE,
                    f"Expected to migrate element '{source_id}', but the target "
                    f"process has no element '{target_id}' and no mapping",
                )
                return
            if self.state.incidents.incident_key_for_job(
                    inst.get("jobKey", -1)) is not None:
                writers.respond_rejection(
                    cmd, RejectionType.INVALID_STATE,
                    f"Expected to migrate element '{source_id}', but it has an "
                    "unresolved incident",
                )
                return
            element_updates.append((key, target_id))

        migrated = writers.append_event(
            pi_key, ValueType.PROCESS_INSTANCE_MIGRATION,
            ProcessInstanceMigrationIntent.MIGRATED,
            {**value,
             "bpmnProcessId": target_meta["bpmnProcessId"],
             "version": target_meta["version"],
             "elementUpdates": [
                 {"elementInstanceKey": k, "targetElementId": tid}
                 for k, tid in element_updates
             ]},
        )
        writers.respond(cmd, migrated)



def apply_migrated(state: EngineState, record) -> None:
    """Event applier: retarget the instance tree (and its jobs) onto the new
    definition — the only state mutation of a migration."""
    value = record.value
    plan = value.get("migrationPlan", {})
    target_key = plan.get("targetProcessDefinitionKey", -1)
    bpmn_process_id = value.get("bpmnProcessId", "")
    version = value.get("version", -1)
    for update in value.get("elementUpdates", []):
        key = update["elementInstanceKey"]
        inst = state.element_instances.get(key)
        if inst is None:
            continue
        iv = dict(inst["value"])
        iv["processDefinitionKey"] = target_key
        iv["bpmnProcessId"] = bpmn_process_id
        iv["version"] = version
        iv["elementId"] = update["targetElementId"]
        state.element_instances.update(key, value=iv)
        job_key = inst.get("jobKey", -1)
        if job_key >= 0:
            job = state.jobs.get(job_key)
            if job is not None:
                job = dict(job)
                job["processDefinitionKey"] = target_key
                job["bpmnProcessId"] = bpmn_process_id
                job["processDefinitionVersion"] = version
                job["elementId"] = update["targetElementId"]
                state.jobs.update_value(job_key, job)


class ResourceDeletionProcessor:
    """RESOURCE_DELETION DELETE: remove a process definition or DRG by key
    (running instances keep their cached executable; new instances cannot
    start — reference: ResourceDeletionDeleteProcessor)."""

    def __init__(self, state: EngineState, distribution=None) -> None:
        self.state = state
        self.distribution = distribution

    def process(self, cmd: LoggedRecord, writers: Writers) -> None:
        if self.distribution is not None and \
                self.distribution.is_distributed_command(cmd):
            self.distribution.handle_distributed(
                cmd, writers, lambda: self._delete(cmd.record.value, writers)
            )
            return
        resource_key = cmd.record.value.get("resourceKey", -1)
        process_meta = self.state.processes.get_by_key(resource_key)
        drg_meta = self.state.decisions.drg_by_key(resource_key)
        form_meta = self.state.forms.get_by_key(resource_key)
        if process_meta is None and drg_meta is None and form_meta is None:
            writers.respond_rejection(
                cmd, RejectionType.NOT_FOUND,
                f"Expected to delete resource {resource_key}, but no deployed "
                "process definition, decision requirements, or form found",
            )
            return
        value = {"resourceKey": resource_key}
        deleting = writers.append_event(
            self.state.next_key(), ValueType.RESOURCE_DELETION,
            ResourceDeletionIntent.DELETING, value,
        )
        self._delete(value, writers)
        writers.respond(cmd, deleting)
        if self.distribution is not None:
            self.distribution.distribute(
                writers, deleting.key, ValueType.RESOURCE_DELETION,
                ResourceDeletionIntent.DELETE, value,
            )

    def _delete(self, value: dict, writers: Writers) -> None:
        from zeebe_tpu_torch.protocol.intent import FormIntent

        resource_key = value["resourceKey"]
        process_meta = self.state.processes.get_by_key(resource_key)
        if process_meta is not None:
            self._close_start_subscriptions(resource_key, process_meta, writers)
        form_meta = self.state.forms.get_by_key(resource_key)
        if form_meta is not None:
            writers.append_event(resource_key, ValueType.FORM, FormIntent.DELETED,
                                 form_meta)
        writers.append_event(
            self.state.next_key(), ValueType.RESOURCE_DELETION,
            ResourceDeletionIntent.DELETED, {"resourceKey": resource_key},
        )

    def _close_start_subscriptions(self, resource_key: int, meta: dict,
                                   writers: Writers) -> None:
        from zeebe_tpu_torch.protocol.intent import (
            MessageStartEventSubscriptionIntent,
            SignalSubscriptionIntent,
            TimerIntent,
        )

        writers.append_event(
            self.state.next_key(), ValueType.MESSAGE_START_EVENT_SUBSCRIPTION,
            MessageStartEventSubscriptionIntent.DELETED,
            {"processDefinitionKey": resource_key,
             "bpmnProcessId": meta["bpmnProcessId"]},
        )
        for timer_key, timer in self.state.timers.start_timers_for_process(resource_key):
            writers.append_event(timer_key, ValueType.TIMER, TimerIntent.CANCELED, timer)
        for sub in self.state.signal_subscriptions.subscriptions_of(resource_key):
            if sub.get("catchEventInstanceKey", -1) < 0:
                writers.append_event(
                    self.state.next_key(), ValueType.SIGNAL_SUBSCRIPTION,
                    SignalSubscriptionIntent.DELETED, sub,
                )
