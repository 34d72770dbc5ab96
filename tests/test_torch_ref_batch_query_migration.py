# tests/test_batch_query_migration.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""ProcessInstanceBatch chunking, QueryService, and DbMigrator tests.

Reference: processinstance/ActivateProcessInstanceBatchProcessor.java +
TerminateProcessInstanceBatchProcessor.java, state/query/StateQueryService.java,
state/migration/DbMigratorImpl.java:29."""

from __future__ import annotations

from zeebe_tpu_torch.engine.migration import DbMigrator
from zeebe_tpu_torch.engine.query import QueryService
from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
from zeebe_tpu_torch.protocol import DEFAULT_TENANT, ValueType, command
from zeebe_tpu_torch.protocol.intent import (
    ProcessInstanceBatchIntent,
    ProcessInstanceIntent,
)
from zeebe_tpu_torch.state import ZbDb
from zeebe_tpu_torch.state.db import ColumnFamilyCode as CF
from zeebe_tpu_torch.state.db import encode_key
from zeebe_tpu_torch.testing import EngineHarness


def mi_process(pid="mi", job_type="miw"):
    return to_bpmn_xml(
        Bpmn.create_executable_process(pid)
        .start_event("s")
        .service_task("t", job_type=job_type)
        .multi_instance("=items", input_element="item")
        .end_event("e").done()
    )


class TestProcessInstanceBatchChunking:
    def test_large_parallel_fanout_rides_batch_commands(self):
        h = EngineHarness(device="cpu")
        try:
            h.deploy(mi_process("big"))
            h.create_instance("big", variables={"items": list(range(250))})
            batches = [r for r in h.exporter.records
                       if r.record.value_type == ValueType.PROCESS_INSTANCE_BATCH
                       and r.record.intent == ProcessInstanceBatchIntent.ACTIVATED]
            # 250 items at chunk 100 → 3 ACTIVATED chunks
            assert [b.record.value["index"] for b in batches] == [100, 200, 250]
            assert all(b.record.value["count"] == 250 for b in batches)
            jobs = h.activate_jobs("miw", max_jobs=1000)
            assert len(jobs) == 250
            for job in jobs:
                h.complete_job(job["key"])
            done = [r for r in h.exporter.records
                    if r.record.value_type == ValueType.PROCESS_INSTANCE
                    and r.record.intent == ProcessInstanceIntent.ELEMENT_COMPLETED
                    and r.record.value.get("bpmnElementType") == "PROCESS"]
            assert len(done) == 1
        finally:
            h.close()

    def test_small_fanout_stays_inline(self):
        h = EngineHarness(device="cpu")
        try:
            h.deploy(mi_process("small"))
            h.create_instance("small", variables={"items": [1, 2, 3]})
            batches = [r for r in h.exporter.records
                       if r.record.value_type == ValueType.PROCESS_INSTANCE_BATCH]
            assert batches == []
            assert len(h.activate_jobs("miw", max_jobs=10)) == 3
        finally:
            h.close()

    def test_large_scope_termination_rides_batch_commands(self):
        h = EngineHarness(device="cpu")
        try:
            h.deploy(mi_process("term"))
            h.create_instance("term", variables={"items": list(range(150))})
            # cancel while all 150 inner instances are active
            instances = [r for r in h.exporter.records
                         if r.record.value_type == ValueType.PROCESS_INSTANCE
                         and r.record.intent == ProcessInstanceIntent.ELEMENT_ACTIVATED
                         and r.record.value.get("bpmnElementType") == "PROCESS"]
            pi_key = instances[0].record.value["processInstanceKey"]
            h.cancel_instance(pi_key)
            terminated_batches = [
                r for r in h.exporter.records
                if r.record.value_type == ValueType.PROCESS_INSTANCE_BATCH
                and r.record.intent == ProcessInstanceBatchIntent.TERMINATED
            ]
            assert terminated_batches  # chunked termination ran
            root_done = [r for r in h.exporter.records
                         if r.record.value_type == ValueType.PROCESS_INSTANCE
                         and r.record.intent == ProcessInstanceIntent.ELEMENT_TERMINATED
                         and r.record.value.get("bpmnElementType") == "PROCESS"]
            assert len(root_done) == 1
        finally:
            h.close()


class TestQueryService:
    def test_lookups(self):
        h = EngineHarness(device="cpu")
        try:
            h.deploy(to_bpmn_xml(
                Bpmn.create_executable_process("qp")
                .start_event("s").service_task("t", job_type="qw").end_event("e").done()
            ))
            h.create_instance("qp")
            query = QueryService(h.db, h.engine.state)
            with h.db.transaction():
                meta = h.engine.state.processes.get_latest_by_id("qp")
            assert query.get_bpmn_process_id_for_process(
                meta["processDefinitionKey"]) == "qp"
            jobs = h.activate_jobs("qw")
            assert query.get_bpmn_process_id_for_job(jobs[0]["key"]) == "qp"
            assert query.get_bpmn_process_id_for_process_instance(
                jobs[0]["processInstanceKey"]) == "qp"
            assert query.get_bpmn_process_id_for_process(12345) is None
            query.close()
            try:
                query.get_bpmn_process_id_for_process(1)
                raise AssertionError("closed query service must raise")
            except RuntimeError:
                pass
        finally:
            h.close()


class TestDbMigrator:
    def test_pre_tenancy_keys_are_backfilled(self):
        db = ZbDb()
        # simulate a pre-tenancy snapshot: 2-part id/version keys
        with db.transaction():
            txn = db.require_transaction()
            txn.put(encode_key(CF.PROCESS_CACHE_BY_ID_AND_VERSION, ("p", 1)), 42)
            txn.put(encode_key(CF.PROCESS_VERSION, ("p",)), 1)
            txn.put(encode_key(CF.PROCESS_CACHE_DIGEST_BY_ID, ("p",)), "digest")
            txn.put(encode_key(CF.MESSAGE_IDS, ("n", "k", "m1")), 7)
        executed = DbMigrator(db).run_migrations()
        assert "process-version-tenancy" in executed
        assert "message-id-tenancy" in executed
        with db.transaction():
            cf = db.column_family(CF.PROCESS_CACHE_BY_ID_AND_VERSION)
            assert cf.get((DEFAULT_TENANT, "p", 1)) == 42
            assert cf.get(("p", 1)) is None
            ver = db.column_family(CF.PROCESS_VERSION)
            assert ver.get((DEFAULT_TENANT, "p")) == 1
            ids = db.column_family(CF.MESSAGE_IDS)
            assert ids.get(("n", "k", "m1", DEFAULT_TENANT)) == 7

    def test_runs_once(self):
        db = ZbDb()
        assert DbMigrator(db).run_migrations() != []
        assert DbMigrator(db).run_migrations() == []

    def test_partition_runs_migrations_on_recovery(self):
        # an EngineHarness-deployed process then a raw "old snapshot" restore
        # is covered by the unit test above; here assert the marker CF is
        # populated by a broker partition transition
        from zeebe_tpu_torch.broker.broker import Broker, BrokerCfg
        from zeebe_tpu_torch.cluster.messaging import LoopbackNetwork

        net = LoopbackNetwork()
        broker = Broker(BrokerCfg(device="cpu"), net.join("broker-0"))
        try:
            for _ in range(200):
                broker.pump()
                net.deliver_all()
                partition = broker.partitions[1]
                if partition.is_leader:
                    break
            with partition.db.transaction():
                markers = partition.db.column_family(CF.MIGRATIONS_STATE)
                assert markers.get(("process-version-tenancy",)) is not None
        finally:
            broker.close()
