"""Signal broadcast processing.

Reference: engine/src/main/java/io/camunda/zeebe/engine/processing/signal/
SignalBroadcastProcessor.java — a broadcast triggers every matching signal
start event (new process instances) and every open signal subscription
(catch events, boundary events, event sub-process starts) on this partition.
Cross-partition distribution of broadcasts rides the command distribution
behavior (multi-partition wiring in zeebe_tpu_torch.parallel).
"""

from __future__ import annotations

from zeebe_tpu_torch.engine.engine_state import EngineState
from zeebe_tpu_torch.engine.writers import Writers
from zeebe_tpu_torch.logstreams import LoggedRecord
from zeebe_tpu_torch.protocol import ValueType
from zeebe_tpu_torch.protocol.intent import (
    ProcessInstanceCreationIntent,
    SignalIntent,
    SignalSubscriptionIntent,
    VariableIntent,
)


class SignalProcessors:
    def __init__(self, state: EngineState, bpmn, distribution=None) -> None:
        self.state = state
        self.bpmn = bpmn
        self.distribution = distribution  # CommandDistributionBehavior | None

    def broadcast(self, cmd: LoggedRecord, writers: Writers) -> None:
        from zeebe_tpu_torch.engine.processors import check_tenant_authorized
        from zeebe_tpu_torch.protocol import DEFAULT_TENANT

        value = dict(cmd.record.value)
        value.pop("authorizedTenants", None)  # claim, not broadcast payload
        if not check_tenant_authorized(
                cmd, cmd.record.value.get("tenantId") or DEFAULT_TENANT, writers):
            return
        if self.distribution is not None and self.distribution.is_distributed_command(cmd):
            # receiver: the whole local broadcast (event + subscription
            # triggering) runs once per distribution key, then acks
            self.distribution.handle_distributed(
                cmd, writers,
                lambda: self._broadcast_locally(cmd.record.key, value, writers),
            )
            return
        key = cmd.record.key if cmd.record.key >= 0 else self.state.next_key()
        broadcasted = self._broadcast_locally(key, value, writers)
        writers.respond(cmd, broadcasted)
        if self.distribution is not None:
            self.distribution.distribute(
                writers, key, ValueType.SIGNAL, SignalIntent.BROADCAST, value
            )

    def _broadcast_locally(self, key: int, value: dict, writers: Writers):
        from zeebe_tpu_torch.protocol import DEFAULT_TENANT

        name = value.get("signalName", "")
        variables = value.get("variables") or {}
        tenant = value.get("tenantId") or DEFAULT_TENANT
        broadcasted = writers.append_event(
            key, ValueType.SIGNAL, SignalIntent.BROADCASTED, value
        )
        for sub in list(self.state.signal_subscriptions.find(name)):
            if sub.get("tenantId", DEFAULT_TENANT) != tenant:
                continue
            host_key = sub.get("catchEventInstanceKey", -1)
            if host_key >= 0:
                instance = self.state.element_instances.get(host_key)
                if instance is None:
                    continue
                if sub.get("interrupting", True):
                    # single-use: close before routing so a second broadcast in
                    # the same batch cannot double-trigger
                    writers.append_event(
                        host_key, ValueType.SIGNAL_SUBSCRIPTION,
                        SignalSubscriptionIntent.DELETED, sub,
                    )
                self._merge_variables(instance, host_key, variables, writers)
                self.bpmn.route_trigger(host_key, sub["catchEventId"], writers)
            else:
                # start-event subscription: create a new instance at that start
                writers.append_command(
                    -1, ValueType.PROCESS_INSTANCE_CREATION,
                    ProcessInstanceCreationIntent.CREATE,
                    {
                        "bpmnProcessId": sub.get("bpmnProcessId", ""),
                        "processDefinitionKey": sub.get("processDefinitionKey", -1),
                        "variables": variables,
                        "startElementId": sub.get("catchEventId", ""),
                        **({"tenantId": sub["tenantId"]} if "tenantId" in sub else {}),
                    },
                )
        return broadcasted

    def _merge_variables(self, instance: dict, host_key: int, variables: dict,
                         writers: Writers) -> None:
        """Broadcast variables merge into the process instance like message
        correlation variables."""
        pi_value = instance["value"]
        for var_name, var_value in variables.items():
            target_scope = (
                self.state.variables.find_scope_with(host_key, var_name)
                or pi_value.get("processInstanceKey", host_key)
            )
            exists = self.state.variables.has_local(target_scope, var_name)
            writers.append_event(
                self.state.next_key(), ValueType.VARIABLE,
                VariableIntent.UPDATED if exists else VariableIntent.CREATED,
                {
                    "name": var_name,
                    "value": var_value,
                    "scopeKey": target_scope,
                    "processInstanceKey": pi_value.get("processInstanceKey", -1),
                    "processDefinitionKey": pi_value.get("processDefinitionKey", -1),
                    "bpmnProcessId": pi_value.get("bpmnProcessId", ""),
                },
            )
