"""Query service: point lookups against a partition's engine state.

Reference: engine/src/main/java/io/camunda/zeebe/engine/state/query/
StateQueryService.java — the QueryService handed to gateway interceptors
(QueryApiCfg): resolve the bpmnProcessId owning a process definition key, a
process instance key, or a job key, without going through the record stream.

Thread-safety: lookups use ``ZbDb.committed_get`` (committed-store point
reads that never touch the processing transaction slot), so any thread —
gateway interceptor, management endpoint — may query concurrently with the
partition's processing, like the reference's reads against a storage
snapshot."""

from __future__ import annotations

from zeebe_tpu_torch.state import ZbDb
from zeebe_tpu_torch.state.db import ColumnFamilyCode as CF


class QueryService:
    def __init__(self, db: ZbDb, state=None) -> None:
        # ``state`` accepted for interface symmetry with other partition
        # services; lookups go straight to the db's committed store
        self._db = db
        self._closed = False

    def close(self) -> None:
        self._closed = True

    def _ensure_open(self) -> None:
        if self._closed:
            raise RuntimeError("query service is closed (partition transitioned)")

    def get_bpmn_process_id_for_process(self, process_definition_key: int) -> str | None:
        self._ensure_open()
        meta = self._db.committed_get(CF.PROCESS_CACHE, (process_definition_key,))
        return None if meta is None else meta["bpmnProcessId"]

    def get_bpmn_process_id_for_process_instance(self, process_instance_key: int) -> str | None:
        self._ensure_open()
        instance = self._db.committed_get(
            CF.ELEMENT_INSTANCE_KEY, (process_instance_key,))
        if instance is None:
            return None
        return instance["value"].get("bpmnProcessId")

    def get_bpmn_process_id_for_job(self, job_key: int) -> str | None:
        self._ensure_open()
        job = self._db.committed_get(CF.JOBS, (job_key,))
        return None if job is None else job.get("bpmnProcessId")
