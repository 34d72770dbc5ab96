"""Engine state facades over the column-family store.

Reference: engine/src/main/java/io/camunda/zeebe/engine/state/ — ProcessingDbState
aggregating ProcessState, ElementInstanceState (parent/child trees +
NUMBER_OF_TAKEN_SEQUENCE_FLOWS), JobState (activatable queues, deadlines,
backoff), VariableState (scope hierarchy), TimerInstanceState, IncidentState,
MessageState, DistributionState, BannedInstanceState.

Only event appliers (appliers.py) may call the mutating methods — the
reference enforces this with ArchUnit; here the convention is enforced by the
replay≡processing property tests.

Element-instance token accounting: each scope instance tracks
``active_children`` (element instances whose flow scope is this instance) and
``active_flows`` (tokens in transit on sequence flows of this scope). A scope
can complete when both are zero. Parallel-gateway joins count taken incoming
flows per (scope, gateway) in NUMBER_OF_TAKEN_SEQUENCE_FLOWS, exactly the
reference's join bookkeeping (docs/engine_questions.md:16-46).
"""

from __future__ import annotations

from typing import Any, Iterator

from zeebe_tpu_torch.models.bpmn import ExecutableProcess, parse_bpmn_xml, transform
from zeebe_tpu_torch.protocol import DEFAULT_TENANT, KeyGenerator
from zeebe_tpu_torch.state import ColumnFamilyCode as CF
from zeebe_tpu_torch.state import ZbDb

# element-instance lifecycle states (stored as ints)
EI_ACTIVATING = 0
EI_ACTIVATED = 1
EI_COMPLETING = 2
EI_COMPLETED = 3
EI_TERMINATING = 4
EI_TERMINATED = 5

# job states
JOB_ACTIVATABLE = 0
JOB_ACTIVATED = 1
JOB_FAILED = 2
JOB_ERROR_THROWN = 3


def _rollback_latest_version(by_id_version, version_cf, digest_cf,
                             tenant: str, resource_id: str, version: int,
                             digest_of) -> None:
    """Shared delete bookkeeping for tenant-scoped versioned resources
    (processes, forms): drop the (tenant, id, version) index entry and, if it
    was the latest, repoint latest/digest to the highest remaining version."""
    if by_id_version.exists((tenant, resource_id, version)):
        by_id_version.delete((tenant, resource_id, version))
    if version_cf.get((tenant, resource_id)) == version:
        for v in range(version - 1, 0, -1):
            prev_key = by_id_version.get((tenant, resource_id, v))
            if prev_key is not None:
                version_cf.put((tenant, resource_id), v)
                digest_cf.put((tenant, resource_id), digest_of(prev_key))
                return
        version_cf.delete((tenant, resource_id))
        if digest_cf.exists((tenant, resource_id)):
            digest_cf.delete((tenant, resource_id))


class ProcessState:
    """Deployed process definitions: by key, by (tenant, id, version), latest,
    digest. The tenant is the leading component of every id-scoped index
    (reference: DbTenantAwareKey wrapping in ProcessState /
    ZbColumnFamilies PROCESS_CACHE_BY_ID_AND_VERSION), so the same BPMN
    process id deploys and versions independently per tenant.

    Caches compiled ExecutableProcess objects outside the db (they are
    deterministic functions of the stored XML)."""

    def __init__(self, db: ZbDb) -> None:
        self._by_key = db.column_family(CF.PROCESS_CACHE)
        self._by_id_version = db.column_family(CF.PROCESS_CACHE_BY_ID_AND_VERSION)
        self._digest = db.column_family(CF.PROCESS_CACHE_DIGEST_BY_ID)
        self._version = db.column_family(CF.PROCESS_VERSION)
        self._compiled: dict[int, ExecutableProcess] = {}

    # mutators (appliers only)

    def put_process(self, key: int, bpmn_process_id: str, version: int, resource_name: str,
                    resource_xml: str, digest: str,
                    tenant: str = DEFAULT_TENANT) -> None:
        meta = {
            "bpmnProcessId": bpmn_process_id,
            "version": version,
            "processDefinitionKey": key,
            "resourceName": resource_name,
            "resource": resource_xml,
            "checksum": digest,
            "tenantId": tenant,
        }
        self._by_key.put((key,), meta)
        self._by_id_version.put((tenant, bpmn_process_id, version), key)
        self._digest.put((tenant, bpmn_process_id), digest)
        self._version.put((tenant, bpmn_process_id), version)

    # queries

    def next_version(self, bpmn_process_id: str, tenant: str = DEFAULT_TENANT) -> int:
        return (self._version.get((tenant, bpmn_process_id)) or 0) + 1

    def latest_version(self, bpmn_process_id: str,
                       tenant: str = DEFAULT_TENANT) -> int | None:
        return self._version.get((tenant, bpmn_process_id))

    def latest_digest(self, bpmn_process_id: str,
                      tenant: str = DEFAULT_TENANT) -> str | None:
        return self._digest.get((tenant, bpmn_process_id))

    def get_by_key(self, key: int) -> dict | None:
        return self._by_key.get((key,))

    def get_key_by_id_version(self, bpmn_process_id: str, version: int,
                              tenant: str = DEFAULT_TENANT) -> int | None:
        return self._by_id_version.get((tenant, bpmn_process_id, version))

    def get_latest_by_id(self, bpmn_process_id: str,
                         tenant: str = DEFAULT_TENANT) -> dict | None:
        version = self.latest_version(bpmn_process_id, tenant)
        if version is None:
            return None
        key = self.get_key_by_id_version(bpmn_process_id, version, tenant)
        return None if key is None else self.get_by_key(key)

    def delete(self, key: int) -> None:
        """Resource deletion: the definition stops being startable (removed
        from the id/version indexes; previous version repointed as latest) but
        the stored resource stays so RUNNING instances keep executing
        (reference: deleted definitions serve in-flight instances)."""
        meta = self._by_key.get((key,))
        if meta is None:
            return
        process_id = meta["bpmnProcessId"]
        version = meta["version"]
        tenant = meta.get("tenantId", DEFAULT_TENANT)
        self._by_key.put((key,), {**meta, "deleted": True})
        _rollback_latest_version(
            self._by_id_version, self._version, self._digest,
            tenant, process_id, version,
            digest_of=lambda k: self._by_key.get((k,))["checksum"],
        )

    def executable(self, key: int) -> ExecutableProcess | None:
        exe = self._compiled.get(key)
        if exe is not None:
            return exe
        meta = self.get_by_key(key)
        if meta is None:
            return None
        model = next(
            m for m in parse_bpmn_xml(meta["resource"]) if m.process_id == meta["bpmnProcessId"]
        )
        exe = transform(model)
        self._compiled[key] = exe
        return exe


class ElementInstanceState:
    """Element-instance tree + token accounting + parallel-gateway counters."""

    def __init__(self, db: ZbDb) -> None:
        self._instances = db.column_family(CF.ELEMENT_INSTANCE_KEY)
        self._parent_child = db.column_family(CF.ELEMENT_INSTANCE_PARENT_CHILD)
        self._taken_flows = db.column_family(CF.NUMBER_OF_TAKEN_SEQUENCE_FLOWS)

    # mutators

    def create(self, key: int, record_value: dict, state: int) -> None:
        instance = {
            "key": key,
            "state": state,
            "value": dict(record_value),
            "activeChildren": 0,
            "activeFlows": 0,
            "jobKey": -1,
            "interruptedByKey": -1,
        }
        self._instances.put((key,), instance)
        parent = record_value.get("flowScopeKey", -1)
        if parent >= 0:
            self._parent_child.put((parent, key), None)

    def update(self, key: int, **fields: Any) -> None:
        instance = self._instances.get((key,))
        instance.update(fields)
        self._instances.put((key,), instance)

    def set_state(self, key: int, state: int) -> None:
        self.update(key, state=state)

    def remove(self, key: int) -> None:
        instance = self._instances.get((key,))
        if instance is None:
            return
        parent = instance["value"].get("flowScopeKey", -1)
        if parent >= 0:
            self._parent_child.delete((parent, key))
        self._instances.delete((key,))

    def add_child(self, scope_key: int) -> None:
        instance = self._instances.get((scope_key,))
        instance["activeChildren"] += 1
        self._instances.put((scope_key,), instance)

    def remove_child(self, scope_key: int) -> None:
        instance = self._instances.get((scope_key,))
        if instance is None:
            return  # scope already gone (terminated concurrently)
        instance["activeChildren"] -= 1
        self._instances.put((scope_key,), instance)

    def add_active_flow(self, scope_key: int) -> None:
        instance = self._instances.get((scope_key,))
        instance["activeFlows"] += 1
        self._instances.put((scope_key,), instance)

    def consume_active_flows(self, scope_key: int, count: int) -> None:
        if count <= 0:
            return
        instance = self._instances.get((scope_key,))
        if instance is None:
            return
        instance["activeFlows"] -= count
        self._instances.put((scope_key,), instance)

    def increment_taken_flow(self, scope_key: int, gateway_idx: int, flow_idx: int) -> None:
        count = self._taken_flows.get((scope_key, gateway_idx, flow_idx)) or 0
        self._taken_flows.put((scope_key, gateway_idx, flow_idx), count + 1)

    def decrement_taken_flows_for_join(self, scope_key: int, gateway_idx: int) -> None:
        """Consume one token from every incoming flow of the gateway."""
        for enc_key, count in list(self._taken_flows.items((scope_key, gateway_idx))):
            if count > 1:
                self._taken_flows._ctx().put(enc_key, count - 1)
            else:
                self._taken_flows._ctx().delete(enc_key)

    # queries

    def get(self, key: int) -> dict | None:
        return self._instances.get((key,))

    def children_keys(self, scope_key: int) -> list[int]:
        # parent_child CF key layout: u16 cf | 0x01 i64(scope) | 0x01 i64(child)
        return [_decode_trailing_i64(enc_key) for enc_key, _ in self._parent_child.items((scope_key,))]

    def taken_flow_count(self, scope_key: int, gateway_idx: int, flow_idx: int) -> int:
        return self._taken_flows.get((scope_key, gateway_idx, flow_idx)) or 0

    def taken_flows_satisfy_join(self, scope_key: int, gateway_idx: int, incoming_flow_idxs: list[int]) -> bool:
        return all(
            self.taken_flow_count(scope_key, gateway_idx, fidx) > 0 for fidx in incoming_flow_idxs
        )


class FormState:
    """Deployed Camunda forms: by key + tenant-scoped (id, version) indexes
    (reference: engine/state/deployment/DbFormState.java, PersistedForm;
    ZbColumnFamilies FORMS / FORM_BY_ID_AND_VERSION / FORM_VERSION)."""

    def __init__(self, db: ZbDb) -> None:
        self._by_key = db.column_family(CF.FORMS)
        self._by_id_version = db.column_family(CF.FORM_BY_ID_AND_VERSION)
        self._version = db.column_family(CF.FORM_VERSION)
        self._digest = db.column_family(CF.FORM_DIGEST)

    # mutators (appliers only)

    def put(self, record_value: dict) -> None:
        tenant = record_value.get("tenantId", DEFAULT_TENANT)
        form_id = record_value["formId"]
        version = record_value["version"]
        self._by_key.put((record_value["formKey"],), dict(record_value))
        self._by_id_version.put((tenant, form_id, version), record_value["formKey"])
        self._version.put((tenant, form_id), version)
        self._digest.put((tenant, form_id), record_value.get("checksum", ""))

    def delete(self, form_key: int) -> None:
        meta = self._by_key.get((form_key,))
        if meta is None:
            return
        tenant = meta.get("tenantId", DEFAULT_TENANT)
        form_id, version = meta["formId"], meta["version"]
        self._by_key.delete((form_key,))
        _rollback_latest_version(
            self._by_id_version, self._version, self._digest,
            tenant, form_id, version,
            digest_of=lambda k: self._by_key.get((k,)).get("checksum", ""),
        )

    # queries

    def next_version(self, form_id: str, tenant: str = DEFAULT_TENANT) -> int:
        return (self._version.get((tenant, form_id)) or 0) + 1

    def latest_digest(self, form_id: str, tenant: str = DEFAULT_TENANT) -> str | None:
        return self._digest.get((tenant, form_id))

    def get_by_key(self, form_key: int) -> dict | None:
        return self._by_key.get((form_key,))

    def get_latest_by_id(self, form_id: str,
                         tenant: str = DEFAULT_TENANT) -> dict | None:
        version = self._version.get((tenant, form_id))
        if version is None:
            return None
        key = self._by_id_version.get((tenant, form_id, version))
        return None if key is None else self._by_key.get((key,))


class JobState:
    """Jobs + activatable queue by type + deadlines + retry backoff."""

    def __init__(self, db: ZbDb) -> None:
        self._db = db
        self._jobs = db.column_family(CF.JOBS)
        self._states = db.column_family(CF.JOB_STATES)
        self._activatable = db.column_family(CF.JOB_ACTIVATABLE)
        self._deadlines = db.column_family(CF.JOB_DEADLINES)
        self._backoff = db.column_family(CF.JOB_BACKOFF)

    # mutators

    @staticmethod
    def _act_key(job: dict, key: int) -> tuple:
        # tenant inside the index key: tenant-filtered activation peeks are
        # prefix lookups, not scans (reference: tenant-aware JobState CFs)
        return (job["type"], job.get("tenantId", DEFAULT_TENANT), key)

    def create(self, key: int, record_value: dict) -> None:
        self._jobs.put((key,), dict(record_value))
        self._states.put((key,), JOB_ACTIVATABLE)
        self._activatable.put(self._act_key(record_value, key), None)
        # physical park seam: an instance waiting on a job is a tiering
        # candidate (state/tiering.py); no-op when tiering is off
        self._db.note_parked(record_value.get("processInstanceKey", -1))

    def activate(self, key: int, worker: str, deadline: int) -> None:
        job = self._jobs.get((key,))
        job["worker"] = worker
        job["deadline"] = deadline
        self._jobs.put((key,), job)
        self._states.put((key,), JOB_ACTIVATED)
        self._activatable.delete(self._act_key(job, key))
        self._deadlines.put((deadline, key), None)
        self._db.note_due(deadline)

    def complete(self, key: int) -> None:
        self._remove(key)

    def update_value(self, key: int, record_value: dict) -> None:
        """Retarget job metadata without touching lifecycle indexes
        (migration applier)."""
        if self._jobs.exists((key,)):
            self._jobs.put((key,), dict(record_value))

    def cancel(self, key: int) -> None:
        self._remove(key)

    def _remove(self, key: int) -> None:
        job = self._jobs.get((key,))
        if job is None:
            return
        state = self._states.get((key,))
        if state == JOB_ACTIVATABLE:
            self._activatable.delete(self._act_key(job, key))
        if state == JOB_ACTIVATED and job.get("deadline", -1) >= 0:
            self._deadlines.delete((job["deadline"], key))
        backoff_until = job.get("backoffUntil", -1)
        if backoff_until > 0 and self._backoff.exists((backoff_until, key)):
            self._backoff.delete((backoff_until, key))
        self._jobs.delete((key,))
        self._states.delete((key,))

    def fail(self, key: int, retries: int, backoff_until: int = -1) -> None:
        job = self._jobs.get((key,))
        state = self._states.get((key,))
        if state == JOB_ACTIVATED and job.get("deadline", -1) >= 0:
            self._deadlines.delete((job["deadline"], key))
        job["retries"] = retries
        job["deadline"] = -1
        if backoff_until > 0:
            job["backoffUntil"] = backoff_until
        self._jobs.put((key,), job)
        if retries > 0:
            if backoff_until > 0:
                self._states.put((key,), JOB_FAILED)
                self._backoff.put((backoff_until, key), None)
                self._db.note_due(backoff_until)
            else:
                self._states.put((key,), JOB_ACTIVATABLE)
                self._activatable.put(self._act_key(job, key), None)
        else:
            self._states.put((key,), JOB_FAILED)

    def recur_after_backoff(self, key: int, backoff_until: int) -> None:
        job = self._jobs.get((key,))
        stored_until = job.pop("backoffUntil", -1)
        for until in (backoff_until, stored_until):
            if until > 0 and self._backoff.exists((until, key)):
                self._backoff.delete((until, key))
        self._jobs.put((key,), job)
        self._states.put((key,), JOB_ACTIVATABLE)
        self._activatable.put(self._act_key(job, key), None)

    def timeout(self, key: int) -> None:
        """Deadline passed: activated → activatable again."""
        job = self._jobs.get((key,))
        if job.get("deadline", -1) >= 0:
            self._deadlines.delete((job["deadline"], key))
        job["deadline"] = -1
        job["worker"] = ""
        self._jobs.put((key,), job)
        self._states.put((key,), JOB_ACTIVATABLE)
        self._activatable.put(self._act_key(job, key), None)

    def update_retries(self, key: int, retries: int) -> None:
        job = self._jobs.get((key,))
        job["retries"] = retries
        self._jobs.put((key,), job)

    def update_deadline(self, key: int, deadline: int) -> None:
        """UpdateJobTimeout: move the activated job's deadline (reference:
        JobUpdateTimeoutProcessor / JobTimeoutUpdatedApplier)."""
        job = self._jobs.get((key,))
        old = job.get("deadline", -1)
        if old >= 0 and self._deadlines.exists((old, key)):
            self._deadlines.delete((old, key))
        job["deadline"] = deadline
        self._jobs.put((key,), job)
        if self._states.get((key,)) == JOB_ACTIVATED:
            self._deadlines.put((deadline, key), None)
            self._db.note_due(deadline)

    def error_thrown(self, key: int) -> None:
        """The job is consumed by a thrown BPMN error (reference:
        JobErrorThrownApplier removes it from activatable/deadline sets)."""
        self._remove(key)

    def make_activatable(self, key: int) -> None:
        """After retries updated on a no-retries-failed job + incident resolve."""
        job = self._jobs.get((key,))
        self._states.put((key,), JOB_ACTIVATABLE)
        self._activatable.put(self._act_key(job, key), None)

    # queries

    def get(self, key: int) -> dict | None:
        return self._jobs.get((key,))

    def state_of(self, key: int) -> int | None:
        return self._states.get((key,))

    @staticmethod
    def any_activatable_committed(db: ZbDb, job_type: str,
                                  tenant_ids: list[str] | None = None) -> bool:
        """Lock-free long-poll peek at the COMMITTED activatable index —
        the cross-thread twin of :meth:`activatable_keys`. Gateway threads
        must never open the processing-owned transaction slot
        (committed-read discipline, enforced by zlint's
        committed-read-discipline rule); the key-index read costs one
        bisect and no value materialization."""
        if tenant_ids is None:
            return bool(db.committed_keys_of(CF.JOB_ACTIVATABLE, (job_type,)))
        return any(
            db.committed_keys_of(CF.JOB_ACTIVATABLE, (job_type, tenant))
            for tenant in tenant_ids)

    def activatable_keys(self, job_type: str, limit: int,
                         tenant_ids: list[str] | None = None) -> list[int]:
        """Activatable job keys of a type, optionally restricted to the
        caller's authorized tenants; each tenant is a prefix range
        (reference: JobBatchCollector + tenant-aware JobState CFs)."""
        out: list[int] = []
        if tenant_ids is None:
            for enc_key, _ in self._activatable.items((job_type,)):
                out.append(_decode_trailing_i64(enc_key))
                if len(out) >= limit:
                    break
            return out
        for tenant in tenant_ids:
            for enc_key, _ in self._activatable.items((job_type, tenant)):
                out.append(_decode_trailing_i64(enc_key))
                if len(out) >= limit:
                    return out
        return out

    # due-date-prefixed sorted keys + range-bounded scans: each sweep touches
    # exactly the due entries — O(due), never O(parked) — where the previous
    # break-on-first-future loop still MATERIALIZED the whole index first

    def expired_deadlines(self, now_millis: int) -> list[int]:
        return [
            _decode_two_i64(enc_key)[1]
            for enc_key, _ in self._deadlines.items_below((now_millis + 1,))
        ]

    def backoff_due(self, now_millis: int) -> list[tuple[int, int]]:
        return [
            _decode_two_i64(enc_key)
            for enc_key, _ in self._backoff.items_below((now_millis + 1,))
        ]

    def next_deadline(self) -> int | None:
        item = self._deadlines.first_item()
        return None if item is None else _decode_two_i64(item[0])[0]

    def next_backoff(self) -> int | None:
        item = self._backoff.first_item()
        return None if item is None else _decode_two_i64(item[0])[0]


def _decode_trailing_i64(enc_key: bytes) -> int:
    import struct as _struct

    (flipped,) = _struct.unpack(">Q", enc_key[-8:])
    value = flipped ^ 0x8000000000000000
    return value - (1 << 64) if value >= (1 << 63) else value


def _decode_two_i64(enc_key: bytes) -> tuple[int, int]:
    import struct as _struct

    (f1,) = _struct.unpack(">Q", enc_key[3:11])
    (f2,) = _struct.unpack(">Q", enc_key[12:20])
    v1 = f1 ^ 0x8000000000000000
    v2 = f2 ^ 0x8000000000000000
    v1 = v1 - (1 << 64) if v1 >= (1 << 63) else v1
    v2 = v2 - (1 << 64) if v2 >= (1 << 63) else v2
    return v1, v2


class VariableState:
    """Scoped variables: (scopeKey, name) → value; lookup walks the scope chain."""

    def __init__(self, db: ZbDb, element_instances: ElementInstanceState) -> None:
        self._vars = db.column_family(CF.VARIABLES)
        self._instances = element_instances

    # mutators

    def set_variable(self, scope_key: int, name: str, value: Any) -> None:
        self._vars.put((scope_key, name), value)

    def remove_scope(self, scope_key: int) -> None:
        for enc_key, _ in list(self._vars.items((scope_key,))):
            self._vars._ctx().delete(enc_key)

    # queries

    def get_local(self, scope_key: int, name: str) -> Any:
        return self._vars.get((scope_key, name))

    def has_local(self, scope_key: int, name: str) -> bool:
        return self._vars.exists((scope_key, name))

    def locals_of(self, scope_key: int) -> dict[str, Any]:
        out = {}
        for enc_key, value in self._vars.items((scope_key,)):
            name = enc_key[2 + 9 + 1 : -1].decode("utf-8")
            out[name] = value
        return out

    def find_scope_with(self, scope_key: int, name: str) -> int | None:
        """Nearest enclosing scope defining ``name`` (for variable updates)."""
        cur = scope_key
        while cur >= 0:
            if self.has_local(cur, name):
                return cur
            instance = self._instances.get(cur)
            if instance is None:
                return None
            cur = instance["value"].get("flowScopeKey", -1)
        return None

    def collect(self, scope_key: int) -> dict[str, Any]:
        """Effective variables visible from a scope (inner shadows outer) —
        the evaluation context for conditions and mappings."""
        chain = []
        cur = scope_key
        while cur >= 0:
            chain.append(cur)
            instance = self._instances.get(cur)
            if instance is None:
                break
            cur = instance["value"].get("flowScopeKey", -1)
        out: dict[str, Any] = {}
        for scope in reversed(chain):
            out.update(self.locals_of(scope))
        return out


class TimerState:
    """Timer instances + due-date index + per-element index (reference:
    TimerInstanceState keys timers by (elementInstanceKey, timerKey))."""

    def __init__(self, db: ZbDb) -> None:
        self._db = db
        self._timers = db.column_family(CF.TIMERS)
        self._due = db.column_family(CF.TIMER_DUE_DATES)
        self._by_element = db.column_family(CF.TIMER_BY_ELEMENT)

    def create(self, key: int, record_value: dict) -> None:
        self._timers.put((key,), dict(record_value))
        self._due.put((record_value["dueDate"], key), None)
        element_key = record_value.get("elementInstanceKey", -1)
        if element_key >= 0:
            self._by_element.put((element_key, key), None)
        self._db.note_due(record_value["dueDate"])
        self._db.note_parked(record_value.get("processInstanceKey", -1))

    def remove(self, key: int) -> None:
        timer = self._timers.get((key,))
        if timer is None:
            return
        self._due.delete((timer["dueDate"], key))
        element_key = timer.get("elementInstanceKey", -1)
        if element_key >= 0 and self._by_element.exists((element_key, key)):
            self._by_element.delete((element_key, key))
        self._timers.delete((key,))

    def get(self, key: int) -> dict | None:
        return self._timers.get((key,))

    def due_timers(self, now_millis: int) -> list[tuple[int, dict]]:
        # range-bounded: O(due) even with a million parked timers behind now
        out = []
        for enc_key, _ in self._due.items_below((now_millis + 1,)):
            key = _decode_two_i64(enc_key)[1]
            out.append((key, self._timers.get((key,))))
        return out

    def next_due(self) -> int | None:
        item = self._due.first_item()
        return None if item is None else _decode_two_i64(item[0])[0]

    def timers_for_element_instance(self, element_instance_key: int) -> list[tuple[int, dict]]:
        out = []
        for enc_key, _ in self._by_element.items((element_instance_key,)):
            key = _decode_trailing_i64(enc_key)
            out.append((key, self._timers.get((key,))))
        return out

    def start_timers_for_process(self, process_definition_key: int) -> list[tuple[int, dict]]:
        """Timer-start-event timers of a definition (deploy-time scan is fine)."""
        out = []
        for enc_key, timer in self._timers.items():
            if (
                timer.get("elementInstanceKey", -1) < 0
                and timer.get("processDefinitionKey") == process_definition_key
            ):
                out.append((_decode_trailing_i64(enc_key), timer))
        return out


class MessageState:
    """Published message buffer + TTL deadlines + id dedup (reference:
    MessageState: MESSAGES, MESSAGE_DEADLINES, MESSAGE_IDS CFs)."""

    def __init__(self, db: ZbDb) -> None:
        self._db = db
        self._messages = db.column_family(CF.MESSAGES)
        self._by_name_key = db.column_family(CF.MESSAGE_PROCESSES)  # (name, corrKey, msgKey)
        self._deadlines = db.column_family(CF.MESSAGE_DEADLINES)
        self._ids = db.column_family(CF.MESSAGE_IDS)
        self._correlated = db.column_family(CF.MESSAGE_CORRELATED)

    def put(self, key: int, record_value: dict, deadline: int) -> None:
        self._messages.put((key,), dict(record_value))
        self._by_name_key.put((record_value["name"], record_value["correlationKey"], key), None)
        if deadline > 0:
            self._deadlines.put((deadline, key), None)
            self._db.note_due(deadline)
        message_id = record_value.get("messageId") or ""
        if message_id:
            # tenant is part of the dedup key: id reuse across tenants must
            # not clobber another tenant's entry (reference: tenant-aware
            # MESSAGE_IDS column family)
            tenant = record_value.get("tenantId", DEFAULT_TENANT)
            self._ids.put(
                (record_value["name"], record_value["correlationKey"],
                 message_id, tenant), key)

    def remove(self, key: int, deadline: int) -> None:
        msg = self._messages.get((key,))
        if msg is None:
            return
        self._by_name_key.delete((msg["name"], msg["correlationKey"], key))
        if deadline > 0 and self._deadlines.exists((deadline, key)):
            self._deadlines.delete((deadline, key))
        message_id = msg.get("messageId") or ""
        if message_id:
            id_key = (msg["name"], msg["correlationKey"], message_id,
                      msg.get("tenantId", DEFAULT_TENANT))
            if self._ids.exists(id_key):
                self._ids.delete(id_key)
        for enc_key, _ in list(self._correlated.items((key,))):
            self._correlated._ctx().delete(enc_key)
        self._messages.delete((key,))

    def get(self, key: int) -> dict | None:
        return self._messages.get((key,))

    def is_id_taken(self, name: str, correlation_key: str, message_id: str,
                    tenant: str = DEFAULT_TENANT) -> bool:
        return self._ids.exists((name, correlation_key, message_id, tenant))

    def buffered_for(self, name: str, correlation_key: str) -> list[int]:
        out = []
        for enc_key, _ in self._by_name_key.items((name, correlation_key)):
            out.append(_decode_trailing_i64(enc_key))
        return out

    def mark_correlated(self, message_key: int, process_instance_key: int) -> None:
        self._correlated.put((message_key, process_instance_key), None)

    def was_correlated_to(self, message_key: int, process_instance_key: int) -> bool:
        return self._correlated.exists((message_key, process_instance_key))

    def expired(self, now_millis: int) -> list[tuple[int, int]]:
        # range-bounded: O(due) regardless of the parked TTL backlog
        return [
            _decode_two_i64(enc_key)
            for enc_key, _ in self._deadlines.items_below((now_millis + 1,))
        ]

    def next_deadline(self) -> int | None:
        item = self._deadlines.first_item()
        return None if item is None else _decode_two_i64(item[0])[0]


class MessageSubscriptionState:
    """Message-partition side of correlation: subscriptions by (name, corrKey)
    (reference: MessageSubscriptionState)."""

    def __init__(self, db: ZbDb) -> None:
        self._by_key = db.column_family(CF.MESSAGE_SUBSCRIPTION_BY_KEY)
        self._by_name = db.column_family(CF.MESSAGE_SUBSCRIPTION_BY_NAME_AND_CORRELATION_KEY)

    def put(self, key: int, record_value: dict) -> None:
        v = dict(record_value)
        self._by_key.put((key,), v)
        self._by_name.put((v["messageName"], v["correlationKey"], key), None)

    def remove(self, key: int) -> None:
        sub = self._by_key.get((key,))
        if sub is None:
            return
        self._by_name.delete((sub["messageName"], sub["correlationKey"], key))
        self._by_key.delete((key,))

    def get(self, key: int) -> dict | None:
        return self._by_key.get((key,))

    def find(self, name: str, correlation_key: str) -> list[tuple[int, dict]]:
        out = []
        for enc_key, _ in self._by_name.items((name, correlation_key)):
            key = _decode_trailing_i64(enc_key)
            out.append((key, self._by_key.get((key,))))
        return out


class ProcessMessageSubscriptionState:
    """Process-partition side: subscriptions by element instance (reference:
    ProcessMessageSubscriptionState)."""

    def __init__(self, db: ZbDb) -> None:
        self._db = db
        self._by_key = db.column_family(CF.PROCESS_SUBSCRIPTION_BY_KEY)

    def put(self, element_instance_key: int, message_name: str, record_value: dict) -> None:
        self._by_key.put((element_instance_key, message_name), dict(record_value))
        # an instance waiting on a message is a tiering candidate
        self._db.note_parked(record_value.get("processInstanceKey", -1))

    def update(self, element_instance_key: int, message_name: str, **fields) -> None:
        sub = self._by_key.get((element_instance_key, message_name))
        sub.update(fields)
        self._by_key.put((element_instance_key, message_name), sub)

    def remove(self, element_instance_key: int, message_name: str) -> None:
        if self._by_key.exists((element_instance_key, message_name)):
            self._by_key.delete((element_instance_key, message_name))

    def get(self, element_instance_key: int, message_name: str) -> dict | None:
        return self._by_key.get((element_instance_key, message_name))

    def subscriptions_of(self, element_instance_key: int) -> list[dict]:
        return list(self._by_key.values((element_instance_key,)))


class MessageStartEventSubscriptionState:
    def __init__(self, db: ZbDb) -> None:
        self._by_name = db.column_family(CF.MESSAGE_START_EVENT_SUBSCRIPTION_BY_NAME_AND_KEY)

    def put(self, message_name: str, process_definition_key: int, record_value: dict) -> None:
        self._by_name.put((message_name, process_definition_key), dict(record_value))

    def remove_for_process(self, process_definition_key: int) -> None:
        for enc_key, v in list(self._by_name.items()):
            if v.get("processDefinitionKey") == process_definition_key:
                self._by_name._ctx().delete(enc_key)

    def find(self, message_name: str) -> list[dict]:
        return list(self._by_name.values((message_name,)))


class SignalSubscriptionState:
    """Signal subscriptions (reference: state/signal/DbSignalSubscriptionState):
    keyed (signalName, subscriptionKey) where the subscription key is the
    process definition key for start-event subscriptions and the element
    instance key for catch-event/boundary/event-sub-process subscriptions."""

    def __init__(self, db: ZbDb) -> None:
        self._by_name = db.column_family(CF.SIGNAL_SUBSCRIPTION_BY_NAME_AND_KEY)
        self._by_key = db.column_family(CF.SIGNAL_SUBSCRIPTION_BY_KEY_AND_NAME)

    def put(self, signal_name: str, subscription_key: int, record_value: dict) -> None:
        self._by_name.put((signal_name, subscription_key), dict(record_value))
        self._by_key.put((subscription_key, signal_name), None)

    def remove(self, signal_name: str, subscription_key: int) -> None:
        if self._by_name.exists((signal_name, subscription_key)):
            self._by_name.delete((signal_name, subscription_key))
        if self._by_key.exists((subscription_key, signal_name)):
            self._by_key.delete((subscription_key, signal_name))

    def find(self, signal_name: str) -> list[dict]:
        return list(self._by_name.values((signal_name,)))

    def names_of(self, subscription_key: int) -> list[str]:
        out = []
        for enc_key, _ in self._by_key.items((subscription_key,)):
            # key layout: u16 cf | 0x01 i64(key) | 0x01 utf8(name) | 0x00
            out.append(enc_key[2 + 9 + 1 : -1].decode("utf-8"))
        return out

    def subscriptions_of(self, subscription_key: int) -> list[dict]:
        return [
            sub
            for name in self.names_of(subscription_key)
            if (sub := self._by_name.get((name, subscription_key))) is not None
        ]


class IncidentState:
    def __init__(self, db: ZbDb) -> None:
        self._incidents = db.column_family(CF.INCIDENTS)
        self._by_element = db.column_family(CF.INCIDENT_PROCESS_INSTANCES)
        self._by_job = db.column_family(CF.INCIDENT_JOBS)

    def create(self, key: int, record_value: dict) -> None:
        self._incidents.put((key,), dict(record_value))
        element_key = record_value.get("elementInstanceKey", -1)
        if element_key >= 0:
            self._by_element.put((element_key, key), None)
        job_key = record_value.get("jobKey", -1)
        if job_key >= 0:
            self._by_job.put((job_key,), key)

    def resolve(self, key: int) -> None:
        incident = self._incidents.get((key,))
        if incident is None:
            return
        element_key = incident.get("elementInstanceKey", -1)
        if element_key >= 0:
            self._by_element.delete((element_key, key))
        job_key = incident.get("jobKey", -1)
        if job_key >= 0:
            self._by_job.delete((job_key,))
        self._incidents.delete((key,))

    def get(self, key: int) -> dict | None:
        return self._incidents.get((key,))

    def incident_key_for_job(self, job_key: int) -> int | None:
        return self._by_job.get((job_key,))


class BannedInstanceState:
    """Poison process instances quarantined instead of wedging the partition
    (reference: state/instance/BannedInstanceState, Engine.java:126)."""

    def __init__(self, db: ZbDb) -> None:
        self._banned = db.column_family(CF.BANNED_INSTANCE)
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        # registered at state construction, not first ban (reference:
        # BannedInstanceMetrics is a static collector)
        self._banned_counter = REGISTRY.counter(
            "banned_instances_total",
            "process instances quarantined after processing errors",
            ("partition",))

    def ban(self, process_instance_key: int) -> None:
        self._banned.put((process_instance_key,), True)
        from zeebe_tpu_torch.protocol.keys import decode_partition_id

        self._banned_counter.labels(
            str(decode_partition_id(process_instance_key))).inc()

    def is_banned(self, process_instance_key: int) -> bool:
        return process_instance_key >= 0 and self._banned.exists((process_instance_key,))


class DistributionState:
    """Pending command distributions (reference: state/distribution/
    DbDistributionState — COMMAND_DISTRIBUTION_RECORD stores the distributed
    command, PENDING_DISTRIBUTION marks (distributionKey, partition) pairs still
    awaiting an ACKNOWLEDGE; receiver side dedups retried sends)."""

    # receiver dedup markers are retained long enough to absorb origin retries,
    # then purged (deterministically, from the applier) so state and snapshots
    # don't grow without bound
    RECEIVED_RETENTION_MS = 24 * 3_600_000

    def __init__(self, db: ZbDb) -> None:
        self._records = db.column_family(CF.COMMAND_DISTRIBUTION_RECORD)
        self._pending = db.column_family(CF.PENDING_DISTRIBUTION)
        self._received = db.column_family(CF.DISTRIBUTION)
        self._received_by_time = db.column_family(CF.RECEIVED_DISTRIBUTION_BY_TIME)

    def start(self, distribution_key: int, stored: dict) -> None:
        self._records.put((distribution_key,), dict(stored))

    def get(self, distribution_key: int) -> dict | None:
        return self._records.get((distribution_key,))

    def add_pending(self, distribution_key: int, partition: int) -> None:
        self._pending.put((distribution_key, partition), None)

    def remove_pending(self, distribution_key: int, partition: int) -> None:
        if self._pending.exists((distribution_key, partition)):
            self._pending.delete((distribution_key, partition))

    def pending_partitions(self, distribution_key: int) -> list[int]:
        return [
            _decode_trailing_i64(enc) for enc, _ in self._pending.items((distribution_key,))
        ]

    def is_pending(self, distribution_key: int, partition: int) -> bool:
        return self._pending.exists((distribution_key, partition))

    def none_pending(self, distribution_key: int) -> bool:
        return self._pending.is_empty((distribution_key,))

    def has_any_pending(self) -> bool:
        return not self._pending.is_empty()

    def all_pending(self) -> list[tuple[int, int]]:
        return [_decode_two_i64(enc) for enc, _ in self._pending.items()]

    def finish(self, distribution_key: int) -> None:
        if self._records.exists((distribution_key,)):
            self._records.delete((distribution_key,))

    def mark_received(self, distribution_key: int, received_at: int) -> None:
        if self._received.exists((distribution_key,)):
            return
        self._received.put((distribution_key,), received_at)
        self._received_by_time.put((received_at, distribution_key), None)
        # Purge markers older than the retention window, keyed by the event's
        # own clock value so replay purges identically. A retry arriving after
        # its marker was purged re-executes the command (at-least-once);
        # receiver processors stay idempotent at the domain level (e.g. the
        # deployment digest check) to keep that harmless.
        cutoff = received_at - self.RECEIVED_RETENTION_MS
        expired: list[tuple[int, int]] = []
        for enc, _ in self._received_by_time.items():
            at, key = _decode_two_i64(enc)
            if at >= cutoff:
                break
            expired.append((at, key))
        for at, key in expired:
            self._received_by_time.delete((at, key))
            if self._received.exists((key,)):
                self._received.delete((key,))

    def was_received(self, distribution_key: int) -> bool:
        return self._received.exists((distribution_key,))


class DecisionState:
    """Deployed DMN decision requirement graphs + decisions (reference:
    state/deployment/DbDecisionState — decisions by key, latest by id, DRGs by
    key with the raw resource for re-parse on recovery)."""

    def __init__(self, db: ZbDb) -> None:
        self._decisions = db.column_family(CF.DMN_DECISIONS)
        self._drgs = db.column_family(CF.DMN_DECISION_REQUIREMENTS)
        self._latest_decision = db.column_family(CF.DMN_LATEST_DECISION_BY_ID)
        self._latest_drg = db.column_family(CF.DMN_LATEST_DRG_BY_ID)
        self._by_drg = db.column_family(CF.DMN_DECISIONS_BY_DRG)
        self._parsed: dict[int, object] = {}  # drg_key → ParsedDrg (cache)

    @staticmethod
    def _tenant_of(meta: dict) -> str:
        return meta.get("tenantId", DEFAULT_TENANT)

    def put_drg(self, drg_key: int, meta: dict) -> None:
        self._drgs.put((drg_key,), dict(meta))
        id_key = (self._tenant_of(meta), meta["decisionRequirementsId"])
        latest = self._latest_drg.get(id_key)
        if latest is None or meta["version"] >= latest.get("version", 0):
            self._latest_drg.put(id_key,
                                 {"version": meta["version"], "key": drg_key})

    def put_decision(self, decision_key: int, meta: dict) -> None:
        self._decisions.put((decision_key,), dict(meta))
        self._by_drg.put((meta["decisionRequirementsKey"], decision_key), None)
        id_key = (self._tenant_of(meta), meta["decisionId"])
        latest_key = self._latest_decision.get(id_key)
        latest = self._decisions.get((latest_key,)) if latest_key else None
        if latest is None or meta["version"] >= latest.get("version", 0):
            self._latest_decision.put(id_key, decision_key)

    def decision_by_key(self, decision_key: int) -> dict | None:
        return self._decisions.get((decision_key,))

    def latest_decision_by_id(self, decision_id: str,
                              tenant: str = DEFAULT_TENANT) -> dict | None:
        key = self._latest_decision.get((tenant, decision_id))
        return None if key is None else self._decisions.get((key,))

    def drg_by_key(self, drg_key: int) -> dict | None:
        return self._drgs.get((drg_key,))

    def latest_drg_meta(self, drg_id: str,
                        tenant: str = DEFAULT_TENANT) -> dict | None:
        latest = self._latest_drg.get((tenant, drg_id))
        return None if latest is None else self._drgs.get((latest["key"],))

    def decisions_of_drg(self, drg_key: int) -> list[dict]:
        return [
            self._decisions.get((_decode_trailing_i64(enc),))
            for enc, _ in self._by_drg.items((drg_key,))
        ]

    def latest_drg_digest(self, drg_id: str,
                          tenant: str = DEFAULT_TENANT) -> str | None:
        latest = self._latest_drg.get((tenant, drg_id))
        if latest is None:
            return None
        drg = self._drgs.get((latest["key"],))
        return None if drg is None else drg.get("checksum")

    def latest_drg_version(self, drg_id: str,
                           tenant: str = DEFAULT_TENANT) -> int:
        latest = self._latest_drg.get((tenant, drg_id))
        return 0 if latest is None else latest["version"]

    def delete_drg(self, drg_key: int) -> None:
        """Resource deletion: drop the DRG and all its decisions."""
        drg = self._drgs.get((drg_key,))
        if drg is None:
            return
        tenant = self._tenant_of(drg)
        for meta in self.decisions_of_drg(drg_key):
            if meta is None:
                continue
            decision_key = meta["decisionKey"]
            self._decisions.delete((decision_key,))
            self._by_drg.delete((drg_key, decision_key))
            dec_key = (tenant, meta["decisionId"])
            if self._latest_decision.get(dec_key) == decision_key:
                self._latest_decision.delete(dec_key)
        self._drgs.delete((drg_key,))
        self._parsed.pop(drg_key, None)
        drg_id = drg["decisionRequirementsId"]
        latest = self._latest_drg.get((tenant, drg_id))
        if latest is not None and latest.get("key") == drg_key:
            self._latest_drg.delete((tenant, drg_id))
            # repoint latest to the highest remaining version of the same DRG
            best = None
            for remaining in self._drgs.values():
                if remaining.get("decisionRequirementsId") != drg_id:
                    continue
                if self._tenant_of(remaining) != tenant:
                    continue
                if best is None or remaining["version"] > best["version"]:
                    best = remaining
            if best is not None:
                best_key = best["decisionRequirementsKey"]
                self._latest_drg.put((tenant, drg_id),
                                     {"version": best["version"], "key": best_key})
                for meta in self.decisions_of_drg(best_key):
                    if meta is not None:
                        self._latest_decision.put((tenant, meta["decisionId"]),
                                                  meta["decisionKey"])

    def parsed_drg(self, drg_key: int):
        """Parse-once cache over the stored DMN resource."""
        cached = self._parsed.get(drg_key)
        if cached is not None:
            return cached
        drg_meta = self._drgs.get((drg_key,))
        if drg_meta is None:
            return None
        from zeebe_tpu_torch.dmn import parse_dmn_xml

        parsed = parse_dmn_xml(drg_meta["resource"])
        self._parsed[drg_key] = parsed
        return parsed


class UserTaskState:
    """Native user tasks (reference: state/usertask/DbUserTaskState)."""

    def __init__(self, db: ZbDb) -> None:
        self._tasks = db.column_family(CF.USER_TASKS)
        self._by_element = db.column_family(CF.USER_TASK_STATES)

    def create(self, key: int, record_value: dict) -> None:
        self._tasks.put((key,), dict(record_value))
        self._by_element.put((record_value["elementInstanceKey"],), key)

    def update(self, key: int, record_value: dict) -> None:
        if self._tasks.exists((key,)):
            self._tasks.put((key,), dict(record_value))

    def remove(self, key: int) -> None:
        task = self._tasks.get((key,))
        if task is None:
            return
        element_key = task.get("elementInstanceKey", -1)
        if self._by_element.exists((element_key,)):
            self._by_element.delete((element_key,))
        self._tasks.delete((key,))

    def get(self, key: int) -> dict | None:
        return self._tasks.get((key,))

    def key_for_element(self, element_instance_key: int) -> int | None:
        return self._by_element.get((element_instance_key,))


class EngineState:
    """Aggregates all engine sub-states over one partition's db + key generator
    (reference: ProcessingDbState)."""

    def __init__(self, db: ZbDb, partition_id: int) -> None:
        self.db = db
        self.partition_id = partition_id
        self.processes = ProcessState(db)
        self.forms = FormState(db)
        self.element_instances = ElementInstanceState(db)
        self.jobs = JobState(db)
        self.variables = VariableState(db, self.element_instances)
        self.incidents = IncidentState(db)
        self.banned = BannedInstanceState(db)
        self.timers = TimerState(db)
        self.messages = MessageState(db)
        self.message_subscriptions = MessageSubscriptionState(db)
        self.process_message_subscriptions = ProcessMessageSubscriptionState(db)
        self.message_start_subscriptions = MessageStartEventSubscriptionState(db)
        self.signal_subscriptions = SignalSubscriptionState(db)
        self.distribution = DistributionState(db)
        self.decisions = DecisionState(db)
        from zeebe_tpu_torch.backup.checkpoint import CheckpointState

        self.checkpoints = CheckpointState(db)
        self.user_tasks = UserTaskState(db)
        self._key_cf = db.column_family(CF.KEY)
        self.key_generator = KeyGenerator(partition_id)
        self._key_loaded = False

    def load_key_generator(self) -> None:
        with self.db.transaction():
            current = self._key_cf.get(("next",))
        if current is not None:
            self.key_generator = KeyGenerator(self.partition_id, start=current)
        self._key_loaded = True

    def next_key(self) -> int:
        key = self.key_generator.next_key()
        self._key_cf.put(("next",), self.key_generator.current)
        return key

    def bulk_mint(self, count: int) -> list[int]:
        """Mint ``count`` keys with a single generator-state write (the burst
        template fast path: same final generator state as ``count`` next_key
        calls, one CF put instead of ``count``). Keys are computed as one
        range over the partition-encoded base — identical to ``count``
        next_key calls (encode_partition_id is base + local counter)."""
        if not count:
            return []
        gen = self.key_generator
        first = gen.next_key()
        mints = list(range(first, first + count))
        gen.set_current(gen.current + count - 1)
        self._key_cf.put(("next",), gen.current)
        return mints

    def observe_key(self, key: int) -> None:
        """Replay path: fast-forward the generator past keys seen in events."""
        self.key_generator.set_key_if_higher(key)
        self._key_cf.put(("next",), self.key_generator.current)
