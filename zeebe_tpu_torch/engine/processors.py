"""Command processors outside the BPMN lifecycle core.

Reference: engine/…/processing/deployment/DeploymentCreateProcessor.java,
processinstance/CreateProcessInstanceProcessor.java:46 and
CancelProcessInstanceHandler, job/{JobBatchActivateProcessor.java:33,
JobCompleteProcessor, JobFailProcessor, JobThrowErrorProcessor,
JobTimeOutProcessor, JobUpdateRetriesProcessor, JobYieldProcessor,
DefaultJobCommandPreconditionGuard}, incident/ResolveIncidentProcessor,
variable/VariableBehavior (document updates).
"""

from __future__ import annotations

import hashlib

from zeebe_tpu_torch.engine.bpmn import BpmnProcessor
from zeebe_tpu_torch.engine.engine_state import (
    EI_ACTIVATED,
    EngineState,
    JOB_ACTIVATABLE,
    JOB_ACTIVATED,
    JOB_FAILED,
)
from zeebe_tpu_torch.engine.writers import Writers
from zeebe_tpu_torch.logstreams import LoggedRecord
from zeebe_tpu_torch.dmn import DmnParseError, parse_dmn_xml
from zeebe_tpu_torch.models.bpmn import BpmnModelError, parse_bpmn_xml, transform
from zeebe_tpu_torch.protocol import DEFAULT_TENANT, RejectionType, ValueType
from zeebe_tpu_torch.protocol.enums import BpmnElementType, ErrorType
from zeebe_tpu_torch.protocol.intent import (
    DeploymentIntent,
    IncidentIntent,
    JobBatchIntent,
    JobIntent,
    ProcessInstanceCreationIntent,
    ProcessInstanceIntent,
    ProcessIntent,
    VariableDocumentIntent,
    VariableIntent,
)


class FormParseError(ValueError):
    pass


def _parse_form(source: str) -> dict:
    """Parse a Camunda form resource (JSON document with an ``id``).
    Reference: deployment/transform/FormResourceTransformer — the engine
    stores the raw resource; only the id is structurally required."""
    import json

    try:
        doc = json.loads(source)
    except ValueError as exc:
        raise FormParseError(f"form resource is not valid JSON: {exc}") from exc
    if not isinstance(doc, dict) or not doc.get("id"):
        raise FormParseError("form resource must be a JSON object with an 'id'")
    return doc


def check_tenant_authorized(cmd: LoggedRecord, tenant: str, writers: Writers) -> bool:
    """TenantAuthorizationChecker: the gateway stamps the caller's authorized
    tenants into the command (reference: RecordMetadata authorization claims +
    engine multitenancy/TenantAuthorizationChecker); a command addressing a
    tenant outside that list is rejected as NOT_FOUND — unauthorized tenants'
    resources are invisible, not forbidden (8.4 semantics)."""
    authorized = cmd.record.value.get("authorizedTenants")
    if authorized and tenant not in authorized:
        writers.respond_rejection(
            cmd, RejectionType.NOT_FOUND,
            f"Expected to handle command for tenant '{tenant}', but the request "
            "is not authorized for that tenant",
        )
        return False
    return True


class DeploymentProcessor:
    """DEPLOYMENT CREATE: parse + validate resources, version processes, emit
    PROCESS CREATED per definition and DEPLOYMENT CREATED/FULLY_DISTRIBUTED,
    and (re)register message/timer start-event subscriptions."""

    def __init__(self, state: EngineState, clock_millis=None, distribution=None) -> None:
        self.state = state
        self.clock_millis = clock_millis or (lambda: 0)
        self.distribution = distribution  # CommandDistributionBehavior | None

    def process(self, cmd: LoggedRecord, writers: Writers) -> None:
        if self.distribution is not None and self.distribution.is_distributed_command(cmd):
            self._process_distributed(cmd, writers)
            return
        value = cmd.record.value
        resources = value.get("resources", [])
        if not resources:
            writers.respond_rejection(cmd, RejectionType.INVALID_ARGUMENT, "no resources")
            return
        tenant = value.get("tenantId") or DEFAULT_TENANT
        if not check_tenant_authorized(cmd, tenant, writers):
            return

        processes_metadata = []
        try:
            parsed = []
            dmn_parsed = []
            form_parsed = []
            for res in resources:
                xml = res["resource"]
                # checksum over the resource bytes (reference: DigestGenerator
                # hashes the deployed resource, not the compiled form)
                checksum = hashlib.sha256(xml.encode("utf-8")).hexdigest()
                if res["resourceName"].endswith(".dmn"):
                    dmn_parsed.append(
                        (res["resourceName"], xml, parse_dmn_xml(xml), checksum)
                    )
                    continue
                if res["resourceName"].endswith(".form"):
                    form_parsed.append(
                        (res["resourceName"], xml, _parse_form(xml), checksum)
                    )
                    continue
                for model in parse_bpmn_xml(xml):
                    exe = transform(model)  # also rejects bad deployments
                    parsed.append((res["resourceName"], xml, model, checksum, exe))
        except (BpmnModelError, DmnParseError, FormParseError) as exc:
            writers.respond_rejection(cmd, RejectionType.INVALID_ARGUMENT, str(exc))
            return

        deployment_key = self.state.next_key()
        for resource_name, xml, model, checksum, exe in parsed:
            previous_digest = self.state.processes.latest_digest(model.process_id, tenant)
            previous_version = self.state.processes.latest_version(model.process_id, tenant)
            previous_key = (
                self.state.processes.get_key_by_id_version(
                    model.process_id, previous_version, tenant)
                if previous_version is not None else None
            )
            duplicate = previous_digest == checksum
            if duplicate:
                version = previous_version
                process_key = previous_key
            else:
                version = self.state.processes.next_version(model.process_id, tenant)
                process_key = self.state.next_key()
            meta = {
                "bpmnProcessId": model.process_id,
                "version": version,
                "processDefinitionKey": process_key,
                "resourceName": resource_name,
                "checksum": checksum,
                "duplicate": duplicate,
                # the default tenant's records stay byte-identical to the
                # pre-tenancy shape (and to the kernel backend's output):
                # tenantId appears only when it carries information
                **({"tenantId": tenant} if tenant != DEFAULT_TENANT else {}),
            }
            processes_metadata.append(meta)
            if not duplicate:
                writers.append_event(
                    process_key, ValueType.PROCESS, ProcessIntent.CREATED,
                    {**meta, "resource": xml},
                )
                self._register_start_subscriptions(
                    writers, exe, meta, previous_key
                )

        decisions_metadata, drg_metadata = self._deploy_dmn(dmn_parsed, writers, tenant)
        form_metadata = self._deploy_forms(form_parsed, tenant, writers)

        deployment_value = {
            "resources": [
                {"resourceName": r["resourceName"], "resource": r["resource"]} for r in resources
            ],
            "processesMetadata": processes_metadata,
            "decisionsMetadata": decisions_metadata,
            "decisionRequirementsMetadata": drg_metadata,
            "formMetadata": form_metadata,
            **({"tenantId": tenant} if tenant != DEFAULT_TENANT else {}),
        }
        created = writers.append_event(
            deployment_key, ValueType.DEPLOYMENT, DeploymentIntent.CREATED, deployment_value
        )
        writers.respond(cmd, created)
        distributing = (
            self.distribution is not None
            and self.distribution.distribute(
                writers, deployment_key, ValueType.DEPLOYMENT, DeploymentIntent.CREATE,
                deployment_value,
            )
        )
        if not distributing:
            # single-partition deployments are immediately fully distributed;
            # otherwise FULLY_DISTRIBUTED is written by the completion hook once
            # every partition ACKNOWLEDGEd (docs/generalized_distribution.md)
            writers.append_event(
                deployment_key, ValueType.DEPLOYMENT, DeploymentIntent.FULLY_DISTRIBUTED,
                deployment_value,
            )

    def _deploy_dmn(self, dmn_parsed, writers: Writers, tenant: str = DEFAULT_TENANT):
        """Version DRGs + decisions per tenant and write their CREATED events
        (reference: deployment/transform DmnResourceTransformer)."""
        from zeebe_tpu_torch.protocol.intent import (
            DecisionIntent,
            DecisionRequirementsIntent,
        )

        tenant_field = {"tenantId": tenant} if tenant != DEFAULT_TENANT else {}
        decisions_metadata: list[dict] = []
        drg_metadata: list[dict] = []
        for resource_name, xml, drg, checksum in dmn_parsed:
            duplicate = self.state.decisions.latest_drg_digest(
                drg.drg_id, tenant) == checksum
            if duplicate:
                # idempotent redeploy still reports the existing keys/versions
                # (mirrors the BPMN duplicate path's metadata contract)
                existing = dict(self.state.decisions.latest_drg_meta(drg.drg_id, tenant))
                existing.pop("resource", None)
                drg_metadata.append({**existing, "duplicate": True})
                for meta in self.state.decisions.decisions_of_drg(
                        existing["decisionRequirementsKey"]):
                    decisions_metadata.append({**meta, "duplicate": True})
                continue
            version = self.state.decisions.latest_drg_version(drg.drg_id, tenant) + 1
            drg_key = self.state.next_key()
            drg_meta = {
                "decisionRequirementsId": drg.drg_id,
                "decisionRequirementsName": drg.name,
                "version": version,
                "decisionRequirementsKey": drg_key,
                "namespace": drg.namespace,
                "resourceName": resource_name,
                "checksum": checksum,
                **tenant_field,
            }
            drg_metadata.append(drg_meta)
            writers.append_event(
                drg_key, ValueType.DECISION_REQUIREMENTS,
                DecisionRequirementsIntent.CREATED,
                {**drg_meta, "resource": xml},
            )
            for decision in drg.decisions.values():
                decision_key = self.state.next_key()
                meta = {
                    "decisionId": decision.decision_id,
                    "decisionName": decision.name,
                    "version": version,
                    "decisionKey": decision_key,
                    "decisionRequirementsKey": drg_key,
                    "decisionRequirementsId": drg.drg_id,
                    **tenant_field,
                }
                decisions_metadata.append(meta)
                writers.append_event(
                    decision_key, ValueType.DECISION, DecisionIntent.CREATED, meta
                )
        return decisions_metadata, drg_metadata

    def _deploy_forms(self, form_parsed, tenant: str, writers: Writers) -> list[dict]:
        """Version forms per (tenant, formId) with digest dedup and write FORM
        CREATED events (reference: FormResourceTransformer + FormCreatedApplier)."""
        from zeebe_tpu_torch.protocol.intent import FormIntent

        form_metadata: list[dict] = []
        for resource_name, source, doc, checksum in form_parsed:
            form_id = doc["id"]
            duplicate = self.state.forms.latest_digest(form_id, tenant) == checksum
            if duplicate:
                existing = self.state.forms.get_latest_by_id(form_id, tenant)
                meta = {k: existing[k] for k in
                        ("formId", "version", "formKey", "resourceName", "checksum")}
                form_metadata.append({**meta, "duplicate": True,
                                      **({"tenantId": tenant}
                                         if tenant != DEFAULT_TENANT else {})})
                continue
            version = self.state.forms.next_version(form_id, tenant)
            form_key = self.state.next_key()
            meta = {
                "formId": form_id,
                "version": version,
                "formKey": form_key,
                "resourceName": resource_name,
                "checksum": checksum,
                "duplicate": False,
                **({"tenantId": tenant} if tenant != DEFAULT_TENANT else {}),
            }
            form_metadata.append(meta)
            writers.append_event(
                form_key, ValueType.FORM, FormIntent.CREATED,
                {**meta, "resource": source},
            )
        return form_metadata

    def _process_distributed(self, cmd: LoggedRecord, writers: Writers) -> None:
        """Receiver side of deployment distribution: store the definitions under
        the origin-minted keys, open message/signal start subscriptions locally
        (timer start events run only on the deployment partition), then ack."""
        self.distribution.handle_distributed(
            cmd, writers, lambda: self._apply_distributed_deployment(cmd, writers)
        )

    def _apply_distributed_deployment(self, cmd: LoggedRecord, writers: Writers) -> None:
        value = cmd.record.value
        executables: dict[str, tuple[str, "object"]] = {}

        def parsed(process_id: str) -> tuple[str, "object"] | None:
            # parse lazily, each resource at most once: a no-op redeploy
            # (all metas duplicate/digest-matched) must not pay any parse cost
            if not executables:
                for res in value.get("resources", []):
                    # mirror the origin-side filter: only .bpmn resources are
                    # process models; .dmn XML would make parse_bpmn_xml raise
                    # and wedge redistribution in a retry loop
                    if res.get("resourceName", "").endswith(".dmn"):
                        continue
                    for model in parse_bpmn_xml(res["resource"]):
                        executables[model.process_id] = (res["resource"], transform(model))
            return executables.get(process_id)

        for meta in value.get("processesMetadata", []):
            if meta.get("duplicate"):
                continue
            tenant = meta.get("tenantId", DEFAULT_TENANT)
            # domain-level idempotence: a retry whose dedup marker was already
            # purged must not re-deploy (digest check, same as the origin path)
            if self.state.processes.latest_digest(
                    meta["bpmnProcessId"], tenant) == meta["checksum"]:
                continue
            entry = parsed(meta["bpmnProcessId"])
            if entry is None:
                continue
            xml, exe = entry
            previous_version = self.state.processes.latest_version(
                meta["bpmnProcessId"], tenant)
            previous_key = (
                self.state.processes.get_key_by_id_version(
                    meta["bpmnProcessId"], previous_version, tenant
                )
                if previous_version is not None else None
            )
            writers.append_event(
                meta["processDefinitionKey"], ValueType.PROCESS, ProcessIntent.CREATED,
                {**meta, "resource": xml},
            )
            self._register_start_subscriptions(
                writers, exe, meta, previous_key, include_timers=False
            )
        # DMN resources replicate under the origin-minted keys/versions
        from zeebe_tpu_torch.protocol.intent import (
            DecisionIntent,
            DecisionRequirementsIntent,
        )

        resource_by_name = {
            r["resourceName"]: r["resource"] for r in value.get("resources", [])
        }
        for drg_meta in value.get("decisionRequirementsMetadata", []):
            if (self.state.decisions.latest_drg_digest(
                    drg_meta["decisionRequirementsId"],
                    drg_meta.get("tenantId", DEFAULT_TENANT))
                    == drg_meta["checksum"]):
                continue
            writers.append_event(
                drg_meta["decisionRequirementsKey"], ValueType.DECISION_REQUIREMENTS,
                DecisionRequirementsIntent.CREATED,
                {**drg_meta, "resource": resource_by_name.get(drg_meta["resourceName"], "")},
            )
        for meta in value.get("decisionsMetadata", []):
            if self.state.decisions.decision_by_key(meta["decisionKey"]) is not None:
                continue
            writers.append_event(
                meta["decisionKey"], ValueType.DECISION, DecisionIntent.CREATED, meta
            )
        # forms replicate under the origin-minted keys/versions
        from zeebe_tpu_torch.protocol.intent import FormIntent

        for meta in value.get("formMetadata", []):
            if meta.get("duplicate"):
                continue
            if self.state.forms.get_by_key(meta["formKey"]) is not None:
                continue
            writers.append_event(
                meta["formKey"], ValueType.FORM, FormIntent.CREATED,
                {**meta, "resource": resource_by_name.get(meta["resourceName"], "")},
            )
        writers.append_event(
            cmd.record.key, ValueType.DEPLOYMENT, DeploymentIntent.DISTRIBUTED, value
        )


    def _register_start_subscriptions(self, writers, exe, meta, previous_key,
                                      include_timers=True):
        register_start_subscriptions(self.state, self.clock_millis, writers,
                                     exe, meta, previous_key, include_timers)


def register_start_subscriptions(state, clock_millis, writers, exe, meta,
                                 previous_key, include_timers=True):
        """Message/timer start events of the new latest version; the previous
        version's subscriptions are closed (reference: deployment transformer
        subscription lifecycle)."""
        from zeebe_tpu_torch.protocol.enums import BpmnEventType
        from zeebe_tpu_torch.protocol.intent import (
            MessageStartEventSubscriptionIntent,
            TimerIntent,
        )
        from zeebe_tpu_torch.utils import parse_cycle, parse_duration_millis

        if previous_key is not None:
            # close the *previous* version's start subscriptions: whether they
            # must go depends on what the old version had, not the new one
            old_exe = state.processes.executable(previous_key)
            old_has_msg_start = old_exe is not None and any(
                el.element_type == BpmnElementType.START_EVENT
                and el.event_type == BpmnEventType.MESSAGE
                for el in old_exe.elements[1:]
            )
            if old_has_msg_start:
                writers.append_event(
                    state.next_key(), ValueType.MESSAGE_START_EVENT_SUBSCRIPTION,
                    MessageStartEventSubscriptionIntent.DELETED,
                    {"processDefinitionKey": previous_key, "bpmnProcessId": meta["bpmnProcessId"]},
                )
            for timer_key, timer in state.timers.start_timers_for_process(previous_key):
                writers.append_event(timer_key, ValueType.TIMER, TimerIntent.CANCELED, timer)
        from zeebe_tpu_torch.protocol.intent import SignalSubscriptionIntent

        if previous_key is not None:
            _close_signal_start_subscriptions(state, writers, previous_key, meta)
        for el in exe.elements[1:]:
            # only ROOT-scope start events start new instances; event
            # sub-process starts subscribe at scope activation instead
            if el.element_type != BpmnElementType.START_EVENT or el.parent_idx != 0:
                continue
            if el.event_type == BpmnEventType.SIGNAL and el.signal_name:
                writers.append_event(
                    state.next_key(), ValueType.SIGNAL_SUBSCRIPTION,
                    SignalSubscriptionIntent.CREATED,
                    {
                        "signalName": el.signal_name,
                        "catchEventId": el.id,
                        "catchEventInstanceKey": -1,
                        "processDefinitionKey": meta["processDefinitionKey"],
                        "bpmnProcessId": meta["bpmnProcessId"],
                        "interrupting": True,
                        **({"tenantId": meta["tenantId"]}
                           if meta.get("tenantId", DEFAULT_TENANT) != DEFAULT_TENANT else {}),
                    },
                )
            elif el.event_type == BpmnEventType.MESSAGE and el.message_name:
                writers.append_event(
                    state.next_key(), ValueType.MESSAGE_START_EVENT_SUBSCRIPTION,
                    MessageStartEventSubscriptionIntent.CREATED,
                    {
                        "processDefinitionKey": meta["processDefinitionKey"],
                        "bpmnProcessId": meta["bpmnProcessId"],
                        "startEventId": el.id,
                        "messageName": el.message_name,
                        **({"tenantId": meta["tenantId"]}
                           if meta.get("tenantId", DEFAULT_TENANT) != DEFAULT_TENANT else {}),
                    },
                )
            elif el.event_type == BpmnEventType.TIMER and include_timers and (
                el.timer_cycle is not None or el.timer_date is not None
            ):
                from zeebe_tpu_torch.engine.burst_templates import (
                    note_clock_poison,
                    note_clock_value,
                )

                if el.timer_cycle is not None:
                    # cycle expressions evaluate against an empty context at
                    # deploy time (no instance exists yet)
                    cycle_text = el.timer_cycle.evaluate({}, clock_millis)
                    reps, interval = parse_cycle(str(cycle_text))
                    due_date = clock_millis() + interval
                    if el.timer_cycle.references_clock():
                        note_clock_poison()
                    else:
                        note_clock_value(due_date, interval)
                else:
                    from zeebe_tpu_torch.engine.bpmn import _eval_date_millis

                    reps, interval = 1, 0
                    due_date = _eval_date_millis(el.timer_date, {}, clock_millis)
                    if el.timer_date.references_clock():
                        note_clock_poison()
                writers.append_event(
                    state.next_key(), ValueType.TIMER, TimerIntent.CREATED,
                    {
                        "elementId": el.id,
                        "targetElementId": el.id,
                        "elementInstanceKey": -1,
                        "processInstanceKey": -1,
                        "processDefinitionKey": meta["processDefinitionKey"],
                        "dueDate": due_date,
                        "repetitions": reps,
                        "interval": interval,
                    },
                )


def _close_signal_start_subscriptions(state, writers, previous_key, meta):
    from zeebe_tpu_torch.protocol.intent import SignalSubscriptionIntent

    for sub in state.signal_subscriptions.subscriptions_of(previous_key):
        if sub.get("catchEventInstanceKey", -1) < 0:
            writers.append_event(
                state.next_key(), ValueType.SIGNAL_SUBSCRIPTION,
                SignalSubscriptionIntent.DELETED, sub,
            )


class ProcessInstanceCreationProcessor:
    """PROCESS_INSTANCE_CREATION CREATE: resolve the definition, write CREATED,
    seed variables, and kick off activation of the process element."""

    def __init__(self, state: EngineState, bpmn: BpmnProcessor,
                 await_results: dict | None = None) -> None:
        self.state = state
        self.bpmn = bpmn
        # transient request state, NOT in the replicated db: an await-result
        # request dies with the broker, exactly like the reference's
        # AwaitProcessInstanceResultMetadata (the client retries)
        self.await_results = await_results if await_results is not None else {}

    def process(self, cmd: LoggedRecord, writers: Writers) -> None:
        value = cmd.record.value
        bpmn_process_id = value.get("bpmnProcessId", "")
        definition_key = value.get("processDefinitionKey", -1)
        version = value.get("version", -1)
        tenant = value.get("tenantId") or DEFAULT_TENANT
        if not check_tenant_authorized(cmd, tenant, writers):
            return

        if definition_key > 0:
            meta = self.state.processes.get_by_key(definition_key)
            # a key look-up must not cross tenants (reference:
            # TenantAuthorizationChecker on CreateProcessInstance)
            if meta is not None and meta.get("tenantId", DEFAULT_TENANT) != tenant:
                meta = None
        elif version > 0:
            key = self.state.processes.get_key_by_id_version(bpmn_process_id, version, tenant)
            meta = None if key is None else self.state.processes.get_by_key(key)
        else:
            meta = self.state.processes.get_latest_by_id(bpmn_process_id, tenant)
        if meta is None or meta.get("deleted"):
            writers.respond_rejection(
                cmd, RejectionType.NOT_FOUND,
                f"Expected to find process definition with process ID '{bpmn_process_id}', "
                "but none found",
            )
            return

        process_instance_key = self.state.next_key()
        created_value = {
            "bpmnProcessId": meta["bpmnProcessId"],
            "version": meta["version"],
            "processDefinitionKey": meta["processDefinitionKey"],
            "processInstanceKey": process_instance_key,
            "variables": value.get("variables", {}),
            "startInstructions": value.get("startInstructions", []),
            **({"tenantId": tenant} if tenant != DEFAULT_TENANT else {}),
        }
        created = writers.append_event(
            process_instance_key, ValueType.PROCESS_INSTANCE_CREATION,
            ProcessInstanceCreationIntent.CREATED, created_value,
        )
        if value.get("awaitResult") and cmd.record.request_id >= 0:
            # response deferred until the instance completes (CreateWithResult)
            self.await_results[process_instance_key] = (
                cmd.record.request_id, cmd.record.request_stream_id,
                list(value.get("fetchVariables", [])),
            )
        else:
            writers.respond(cmd, created)

        pi_value = {
            "bpmnProcessId": meta["bpmnProcessId"],
            "version": meta["version"],
            "processDefinitionKey": meta["processDefinitionKey"],
            "processInstanceKey": process_instance_key,
            "elementId": meta["bpmnProcessId"],
            "flowScopeKey": -1,
            "bpmnElementType": BpmnElementType.PROCESS.name,
            "bpmnEventType": "UNSPECIFIED",
            **({"tenantId": tenant} if tenant != DEFAULT_TENANT else {}),
        }
        if value.get("startElementId"):
            pi_value["startElementId"] = value["startElementId"]
        writers.append_command(
            process_instance_key, ValueType.PROCESS_INSTANCE,
            ProcessInstanceIntent.ACTIVATE_ELEMENT, pi_value,
        )
        # seed variables as events *after* CREATED — they apply to the root
        # scope which exists once ELEMENT_ACTIVATING runs; Zeebe orders the
        # variable events before activation, with the scope key pre-assigned.
        for name, val in (value.get("variables") or {}).items():
            var_key = self.state.next_key()
            writers.append_event(
                var_key, ValueType.VARIABLE, VariableIntent.CREATED,
                {
                    "name": name,
                    "value": val,
                    "scopeKey": process_instance_key,
                    "processInstanceKey": process_instance_key,
                    "processDefinitionKey": meta["processDefinitionKey"],
                    "bpmnProcessId": meta["bpmnProcessId"],
                },
            )


class ProcessInstanceCancelProcessor:
    """PROCESS_INSTANCE CANCEL (key = process instance key)."""

    def __init__(self, state: EngineState) -> None:
        self.state = state

    def process(self, cmd: LoggedRecord, writers: Writers) -> None:
        key = cmd.record.key
        instance = self.state.element_instances.get(key)
        if instance is None or instance["value"].get("flowScopeKey", -1) >= 0:
            writers.respond_rejection(
                cmd, RejectionType.NOT_FOUND,
                f"Expected to cancel existing process instance with key {key}, but none found",
            )
            return
        writers.append_command(key, ValueType.PROCESS_INSTANCE,
                               ProcessInstanceIntent.TERMINATE_ELEMENT, {})
        writers.respond(cmd, cmd.record.replace())


class JobProcessors:
    """COMPLETE / FAIL / THROW_ERROR / TIME_OUT / UPDATE_RETRIES / CANCEL."""

    def __init__(self, state: EngineState, clock_millis, bpmn=None) -> None:
        self.state = state
        self.clock_millis = clock_millis
        self.bpmn = bpmn

    def _precondition(self, cmd: LoggedRecord, writers: Writers, expect_activated: bool = True):
        """DefaultJobCommandPreconditionGuard: job exists and is in a valid state."""
        key = cmd.record.key
        job = self.state.jobs.get(key)
        if job is None:
            writers.respond_rejection(
                cmd, RejectionType.NOT_FOUND,
                f"Expected to find job with key {key}, but no such job was found",
            )
            return None
        return job

    def complete(self, cmd: LoggedRecord, writers: Writers) -> None:
        job = self._precondition(cmd, writers)
        if job is None:
            return
        key = cmd.record.key
        variables = cmd.record.value.get("variables", {}) or {}
        completed_value = {**job, "variables": variables}
        completed = writers.append_event(key, ValueType.JOB, JobIntent.COMPLETED, completed_value)
        writers.respond(cmd, completed)

        element_key = job.get("elementInstanceKey", -1)
        instance = self.state.element_instances.get(element_key)
        if instance is not None:
            # completion variables merge into the process instance scope
            # (reference default propagation), EXCEPT when the element has
            # output mappings or is a multi-instance inner instance — then the
            # variables merge into the element's local scope so the mappings /
            # outputElement can read them and parallel siblings don't collide
            # (reference: VariableBehavior.mergeDocument + MI docs)
            pi_key = job.get("processInstanceKey", -1)
            merge_local = False
            exe = self.state.processes.executable(job.get("processDefinitionKey", -1))
            if exe is not None and job.get("elementId", "") in exe.by_id:
                element = exe.element(job["elementId"])
                merge_local = bool(element.outputs) or element.multi_instance is not None
            for name, val in variables.items():
                if merge_local:
                    target_scope = element_key
                else:
                    target_scope = self.state.variables.find_scope_with(element_key, name) or pi_key
                var_key = self.state.next_key()
                exists = self.state.variables.has_local(target_scope, name)
                writers.append_event(
                    var_key, ValueType.VARIABLE,
                    VariableIntent.UPDATED if exists else VariableIntent.CREATED,
                    {
                        "name": name, "value": val, "scopeKey": target_scope,
                        "processInstanceKey": pi_key,
                        "processDefinitionKey": job.get("processDefinitionKey", -1),
                        "bpmnProcessId": job.get("bpmnProcessId", ""),
                    },
                )
            writers.append_command(
                element_key, ValueType.PROCESS_INSTANCE,
                ProcessInstanceIntent.COMPLETE_ELEMENT, {},
            )

    def fail(self, cmd: LoggedRecord, writers: Writers) -> None:
        job = self._precondition(cmd, writers)
        if job is None:
            return
        key = cmd.record.key
        retries = cmd.record.value.get("retries", 0)
        backoff = cmd.record.value.get("retryBackOff", 0)
        error_message = cmd.record.value.get("errorMessage", "")
        failed_value = {**job, "retries": retries, "errorMessage": error_message}
        if backoff > 0 and retries > 0:
            failed_value["retryBackoff"] = self.clock_millis() + backoff
        failed = writers.append_event(key, ValueType.JOB, JobIntent.FAILED, failed_value)
        writers.respond(cmd, failed)
        if retries <= 0:
            incident_key = self.state.next_key()
            writers.append_event(
                incident_key, ValueType.INCIDENT, IncidentIntent.CREATED,
                {
                    "errorType": ErrorType.JOB_NO_RETRIES.name,
                    "errorMessage": error_message or "No more retries left.",
                    "bpmnProcessId": job.get("bpmnProcessId", ""),
                    "processDefinitionKey": job.get("processDefinitionKey", -1),
                    "processInstanceKey": job.get("processInstanceKey", -1),
                    "elementId": job.get("elementId", ""),
                    "elementInstanceKey": job.get("elementInstanceKey", -1),
                    "jobKey": key,
                    "variableScopeKey": job.get("elementInstanceKey", -1),
                },
            )

    def update_retries(self, cmd: LoggedRecord, writers: Writers) -> None:
        job = self._precondition(cmd, writers)
        if job is None:
            return
        retries = cmd.record.value.get("retries", 0)
        if retries < 1:
            writers.respond_rejection(
                cmd, RejectionType.INVALID_ARGUMENT, f"retries must be >0, got {retries}"
            )
            return
        updated = writers.append_event(
            cmd.record.key, ValueType.JOB, JobIntent.RETRIES_UPDATED, {**job, "retries": retries}
        )
        writers.respond(cmd, updated)

    def recur_after_backoff(self, cmd: LoggedRecord, writers: Writers) -> None:
        job = self._precondition(cmd, writers)
        if job is None:
            return
        writers.append_event(
            cmd.record.key, ValueType.JOB, JobIntent.RECURRED_AFTER_BACKOFF,
            {**job, "recurAt": cmd.record.value.get("recurAt", -1)},
        )

    def yield_job(self, cmd: LoggedRecord, writers: Writers) -> None:
        """Job YIELD: a pushed job's client stream died before delivery; hand
        the job back to the activatable queue (reference: JobYieldProcessor,
        YieldingJobStreamErrorHandler)."""
        job = self._precondition(cmd, writers)
        if job is None:
            return
        if self.state.jobs.state_of(cmd.record.key) != JOB_ACTIVATED:
            writers.respond_rejection(cmd, RejectionType.INVALID_STATE, "job is not activated")
            return
        yielded = writers.append_event(cmd.record.key, ValueType.JOB, JobIntent.YIELDED, job)
        writers.respond(cmd, yielded)

    def update_timeout(self, cmd: LoggedRecord, writers: Writers) -> None:
        """UpdateJobTimeout: move an activated job's deadline (reference:
        JobUpdateTimeoutProcessor)."""
        job = self._precondition(cmd, writers)
        if job is None:
            return
        if self.state.jobs.state_of(cmd.record.key) != JOB_ACTIVATED:
            writers.respond_rejection(cmd, RejectionType.INVALID_STATE, "job is not activated")
            return
        timeout = cmd.record.value.get("timeout", 0)
        if timeout <= 0:
            writers.respond_rejection(
                cmd, RejectionType.INVALID_ARGUMENT, f"timeout must be >0, got {timeout}"
            )
            return
        deadline = self.clock_millis() + timeout
        updated = writers.append_event(
            cmd.record.key, ValueType.JOB, JobIntent.TIMEOUT_UPDATED,
            {**job, "deadline": deadline},
        )
        writers.respond(cmd, updated)

    def time_out(self, cmd: LoggedRecord, writers: Writers) -> None:
        job = self._precondition(cmd, writers)
        if job is None:
            return
        if self.state.jobs.state_of(cmd.record.key) != JOB_ACTIVATED:
            writers.respond_rejection(cmd, RejectionType.INVALID_STATE, "job is not activated")
            return
        writers.append_event(cmd.record.key, ValueType.JOB, JobIntent.TIMED_OUT, job)

    def throw_error(self, cmd: LoggedRecord, writers: Writers) -> None:
        """Reference: processing/job/JobThrowErrorProcessor — the job is
        consumed (ERROR_THROWN), then the error routes to the closest error
        boundary/event sub-process; unhandled → UNHANDLED_ERROR_EVENT incident
        whose resolution re-attempts the throw."""
        job = self._precondition(cmd, writers)
        if job is None:
            return
        error_code = cmd.record.value.get("errorCode", "")
        thrown = writers.append_event(
            cmd.record.key, ValueType.JOB, JobIntent.ERROR_THROWN,
            {**job, "errorCode": error_code,
             "errorMessage": cmd.record.value.get("errorMessage", "")},
        )
        writers.respond(cmd, thrown)
        element_key = job.get("elementInstanceKey", -1)
        if self.bpmn is not None and self.bpmn.throw_error_from(element_key, error_code, writers):
            return
        incident_key = self.state.next_key()
        writers.append_event(
            incident_key, ValueType.INCIDENT, IncidentIntent.CREATED,
            {
                "errorType": ErrorType.UNHANDLED_ERROR_EVENT.name,
                "errorMessage": f"An error was thrown with the code '{error_code}' "
                                "but not caught.",
                "bpmnProcessId": job.get("bpmnProcessId", ""),
                "processDefinitionKey": job.get("processDefinitionKey", -1),
                "processInstanceKey": job.get("processInstanceKey", -1),
                "elementId": job.get("elementId", ""),
                "elementInstanceKey": element_key,
                "jobKey": cmd.record.key,
                "variableScopeKey": element_key,
                "errorCode": error_code,
            },
        )


class JobBatchProcessor:
    """JOB_BATCH ACTIVATE: collect activatable jobs of a type with variables
    (reference: JobBatchActivateProcessor.java:33 + JobBatchCollector)."""

    def __init__(self, state: EngineState, clock_millis) -> None:
        self.state = state
        self.clock_millis = clock_millis

    def process(self, cmd: LoggedRecord, writers: Writers) -> None:
        value = cmd.record.value
        job_type = value.get("type", "")
        worker = value.get("worker", "")
        timeout = value.get("timeout", 300_000)
        max_jobs = value.get("maxJobsToActivate", 32)
        if not job_type or timeout <= 0 or max_jobs <= 0:
            writers.respond_rejection(
                cmd, RejectionType.INVALID_ARGUMENT,
                f"Expected type, positive timeout and maxJobsToActivate "
                f"(got type={job_type!r} timeout={timeout} max={max_jobs})",
            )
            return
        deadline = self.clock_millis() + timeout
        # authorized-tenant restriction: absent/empty means default tenant
        # only (reference: JobBatchActivateProcessor authorized tenants)
        tenant_ids = value.get("tenantIds") or [DEFAULT_TENANT]
        keys = self.state.jobs.activatable_keys(job_type, max_jobs, tenant_ids)
        jobs = []
        for key in keys:
            job = dict(self.state.jobs.get(key))
            element_key = job.get("elementInstanceKey", -1)
            job["variables"] = self.state.variables.collect(element_key)
            job["worker"] = worker
            job["deadline"] = deadline
            jobs.append(job)
        batch_key = self.state.next_key()
        activated_value = {
            "type": job_type,
            "worker": worker,
            "timeout": timeout,
            "maxJobsToActivate": max_jobs,
            "jobKeys": keys,
            "jobs": jobs,
            "deadline": deadline,
            "truncated": False,
        }
        activated = writers.append_event(
            batch_key, ValueType.JOB_BATCH, JobBatchIntent.ACTIVATED, activated_value
        )
        writers.respond(cmd, activated)


class ProcessInstanceBatchProcessor:
    """PROCESS_INSTANCE_BATCH ACTIVATE / TERMINATE: chunk huge fan-outs and
    fan-ins so no single processing step writes an unbounded record batch
    (reference: processinstance/ActivateProcessInstanceBatchProcessor.java,
    TerminateProcessInstanceBatchProcessor.java; SURVEY §5.7)."""

    def __init__(self, state: EngineState, bpmn: BpmnProcessor) -> None:
        self.state = state
        self.bpmn = bpmn

    def activate(self, cmd: LoggedRecord, writers: Writers) -> None:
        from zeebe_tpu_torch.engine.bpmn import PI_BATCH_CHUNK
        from zeebe_tpu_torch.engine.engine_state import EI_ACTIVATED, EI_ACTIVATING
        from zeebe_tpu_torch.protocol.intent import ProcessInstanceBatchIntent

        value = cmd.record.value
        body_key = value.get("batchElementInstanceKey", -1)
        index = value.get("index", 0)
        body = self.state.element_instances.get(body_key)
        if body is None or body["state"] not in (EI_ACTIVATING, EI_ACTIVATED):
            return  # body gone (terminated meanwhile): drop the chain
        body_value = body["value"]
        exe = self.state.processes.executable(body_value["processDefinitionKey"])
        element = exe.element(body_value["elementId"])
        # the collection is re-evaluated per chunk; mutating it mid-loop is
        # documented-unsupported (same stance as sequential multi-instance).
        # The total is pinned from the FIRST chunk and the index only ever
        # advances, so a mutated collection can mis-pick items but can never
        # rewind progress or complete the body while chunks are outstanding.
        items = self.bpmn._eval_input_collection(body_key, body_value, element, writers)
        if items is None:
            return  # incident raised on the body
        total = body.get("miTotal") or len(items)
        end = max(index, min(index + PI_BATCH_CHUNK, len(items), total))
        for i in range(index, end):
            self.bpmn._write_mi_inner_activate(
                writers, body_key, body_value, element, items[i], i + 1
            )
        # a shrunken collection ends the chain here: report the REACHED count
        # as the final total so body completion is not gated on chunks that
        # will never be written (liveness over the pinned target)
        final_count = total if len(items) >= total else end
        writers.append_event(
            cmd.record.key, ValueType.PROCESS_INSTANCE_BATCH,
            ProcessInstanceBatchIntent.ACTIVATED,
            {"processInstanceKey": value.get("processInstanceKey", -1),
             "batchElementInstanceKey": body_key,
             "index": end, "count": final_count},
        )
        if end < min(total, len(items)):
            writers.append_command(
                self.state.next_key(), ValueType.PROCESS_INSTANCE_BATCH,
                ProcessInstanceBatchIntent.ACTIVATE,
                {"processInstanceKey": value.get("processInstanceKey", -1),
                 "batchElementInstanceKey": body_key, "index": end},
            )

    def terminate(self, cmd: LoggedRecord, writers: Writers) -> None:
        from zeebe_tpu_torch.engine.bpmn import PI_BATCH_CHUNK
        from zeebe_tpu_torch.engine.engine_state import EI_TERMINATED, EI_TERMINATING
        from zeebe_tpu_torch.protocol.intent import ProcessInstanceBatchIntent

        value = cmd.record.value
        scope_key = value.get("batchElementInstanceKey", -1)
        scope = self.state.element_instances.get(scope_key)
        if scope is None:
            return  # scope finished terminating meanwhile
        pending = [
            k for k in self.state.element_instances.children_keys(scope_key)
            if self.state.element_instances.get(k)["state"]
            not in (EI_TERMINATING, EI_TERMINATED)
        ]
        for child_key in pending[:PI_BATCH_CHUNK]:
            writers.append_command(
                child_key, ValueType.PROCESS_INSTANCE,
                ProcessInstanceIntent.TERMINATE_ELEMENT, {},
            )
        writers.append_event(
            cmd.record.key, ValueType.PROCESS_INSTANCE_BATCH,
            ProcessInstanceBatchIntent.TERMINATED,
            {"processInstanceKey": value.get("processInstanceKey", -1),
             "batchElementInstanceKey": scope_key,
             "count": min(len(pending), PI_BATCH_CHUNK)},
        )
        if len(pending) > PI_BATCH_CHUNK:
            writers.append_command(
                self.state.next_key(), ValueType.PROCESS_INSTANCE_BATCH,
                ProcessInstanceBatchIntent.TERMINATE,
                {"processInstanceKey": value.get("processInstanceKey", -1),
                 "batchElementInstanceKey": scope_key},
            )


class IncidentResolveProcessor:
    """INCIDENT RESOLVE: drop the incident and retry the stalled work."""

    def __init__(self, state: EngineState, bpmn=None) -> None:
        self.state = state
        self.bpmn = bpmn

    def process(self, cmd: LoggedRecord, writers: Writers) -> None:
        key = cmd.record.key
        incident = self.state.incidents.get(key)
        if incident is None:
            writers.respond_rejection(
                cmd, RejectionType.NOT_FOUND,
                f"Expected to resolve incident with key {key}, but no such incident was found",
            )
            return
        resolved = writers.append_event(key, ValueType.INCIDENT, IncidentIntent.RESOLVED, incident)
        writers.respond(cmd, resolved)

        if (
            incident.get("errorType") == ErrorType.UNHANDLED_ERROR_EVENT.name
            and incident.get("jobKey", -1) >= 0
            and self.bpmn is not None
        ):
            # re-attempt the job's error throw (a catcher may exist now, e.g.
            # after process modification); still uncaught → fresh incident
            element_key = incident.get("elementInstanceKey", -1)
            error_code = incident.get("errorCode", "")
            if not self.bpmn.throw_error_from(element_key, error_code, writers):
                writers.append_event(
                    self.state.next_key(), ValueType.INCIDENT, IncidentIntent.CREATED,
                    {**incident,
                     "errorMessage": f"An error was thrown with the code '{error_code}' "
                                     "but not caught."},
                )
            return
        job_key = incident.get("jobKey", -1)
        if job_key >= 0:
            job = self.state.jobs.get(job_key)
            if job is not None and job.get("retries", 0) > 0:
                # worker updated retries; job becomes activatable again
                writers.append_event(
                    job_key, ValueType.JOB, JobIntent.RECURRED_AFTER_BACKOFF,
                    {**job, "recurAt": -1},
                )
            return
        element_key = incident.get("elementInstanceKey", -1)
        instance = self.state.element_instances.get(element_key)
        if instance is not None:
            # re-run the stalled transition: COMPLETING retries completion,
            # ACTIVATING retries activation
            from zeebe_tpu_torch.engine.engine_state import EI_COMPLETING, EI_ACTIVATING

            if instance["state"] == EI_COMPLETING:
                writers.append_command(
                    element_key, ValueType.PROCESS_INSTANCE,
                    ProcessInstanceIntent.COMPLETE_ELEMENT, {},
                )
            elif instance["state"] == EI_ACTIVATING:
                writers.append_command(
                    element_key, ValueType.PROCESS_INSTANCE,
                    ProcessInstanceIntent.ACTIVATE_ELEMENT, instance["value"],
                )


class VariableDocumentProcessor:
    """VARIABLE_DOCUMENT UPDATE: merge a document into a scope (SetVariables)."""

    def __init__(self, state: EngineState) -> None:
        self.state = state

    def process(self, cmd: LoggedRecord, writers: Writers) -> None:
        value = cmd.record.value
        scope_key = value.get("scopeKey", -1)
        instance = self.state.element_instances.get(scope_key)
        if instance is None:
            writers.respond_rejection(
                cmd, RejectionType.NOT_FOUND,
                f"Expected to update variables for element with key {scope_key}, "
                "but no such element was found",
            )
            return
        local = value.get("local", False)
        pi_value = instance["value"]
        for name, val in (value.get("variables") or {}).items():
            if local:
                target_scope = scope_key
            else:
                target_scope = self.state.variables.find_scope_with(scope_key, name)
                if target_scope is None:
                    target_scope = pi_value.get("processInstanceKey", scope_key)
            exists = self.state.variables.has_local(target_scope, name)
            var_key = self.state.next_key()
            writers.append_event(
                var_key, ValueType.VARIABLE,
                VariableIntent.UPDATED if exists else VariableIntent.CREATED,
                {
                    "name": name, "value": val, "scopeKey": target_scope,
                    "processInstanceKey": pi_value.get("processInstanceKey", -1),
                    "processDefinitionKey": pi_value.get("processDefinitionKey", -1),
                    "bpmnProcessId": pi_value.get("bpmnProcessId", ""),
                },
            )
        doc_key = self.state.next_key()
        updated = writers.append_event(
            doc_key, ValueType.VARIABLE_DOCUMENT, VariableDocumentIntent.UPDATED, value
        )
        writers.respond(cmd, updated)
