# tests/test_exporters.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Exporter director + elasticsearch exporter tests (reference:
broker/…/exporter/stream/ExporterDirectorTest, exporter-test/ harness,
exporters/elasticsearch-exporter tests)."""

from __future__ import annotations

import json

import pytest

from zeebe_tpu_torch.exporters import (
    ElasticsearchExporter,
    Exporter,
    ExporterDirector,
    ExportersState,
)
from zeebe_tpu_torch.models.bpmn import Bpmn
from zeebe_tpu_torch.testing import EngineHarness


@pytest.fixture()
def harness():
    h = EngineHarness(device="cpu")
    yield h
    h.close()


def one_task():
    return (
        Bpmn.create_executable_process("p")
        .start_event("s").service_task("t", job_type="w").end_event("e").done()
    )


class CollectingExporter(Exporter):
    def __init__(self):
        self.records = []

    def export(self, record):
        self.records.append(record)
        self.controller.update_last_exported_position(record.position)


class TestExporterDirector:
    def test_exports_all_committed_records(self, harness):
        collector = CollectingExporter()
        director = ExporterDirector(harness.stream, harness.db, {"col": collector})
        harness.deploy(one_task())
        harness.create_instance("p")
        director.export_available()
        assert collector.records
        positions = [r.position for r in collector.records]
        assert positions == sorted(positions)
        # position persisted for snapshot/compaction bound
        assert ExportersState(harness.db).position("col") == positions[-1]

    def test_restart_resumes_from_acknowledged_position(self, harness):
        collector = CollectingExporter()
        director = ExporterDirector(harness.stream, harness.db, {"col": collector})
        harness.deploy(one_task())
        director.export_available()
        seen_first = len(collector.records)
        assert seen_first > 0
        # "restart": a new director + exporter instance over the same db
        collector2 = CollectingExporter()
        director2 = ExporterDirector(harness.stream, harness.db, {"col": collector2})
        harness.create_instance("p")
        director2.export_available()
        # only new records, no re-export before the acked position
        assert collector2.records[0].position > collector.records[-1].position

    def test_two_exporters_track_independent_positions(self, harness):
        fast, slow = CollectingExporter(), SlowAckExporter()
        director = ExporterDirector(harness.stream, harness.db,
                                    {"fast": fast, "slow": slow})
        harness.deploy(one_task())
        harness.create_instance("p")
        director.export_available()
        state = ExportersState(harness.db)
        # fast acks every record; slow acks every other — fast is at the log
        # end, slow is at (or just behind) it, and compaction is bounded by slow
        assert state.position("fast") == fast.records[-1].position
        assert state.position("slow") <= state.position("fast")
        assert director.lowest_exporter_position() == min(
            state.position("fast"), state.position("slow")
        )

    def test_record_filter_skips_but_advances(self, harness):
        filtered = CollectingExporter()
        director = ExporterDirector(harness.stream, harness.db, {"f": filtered})
        filtered.context.record_filter = lambda r: r.record.is_event
        harness.deploy(one_task())
        director.export_available()
        assert filtered.records
        assert all(r.record.is_event for r in filtered.records)


class TestExporterCrashRestartResume:
    """Crash + ExporterDirector rebuild: each exporter resumes from its own
    persisted position — no duplicate deliveries below the ack, no gap above
    it (reference: ExporterDirectorTest restart cases)."""

    def test_each_exporter_resumes_from_its_own_ack(self, harness):
        eager, lazy = CollectingExporter(), SlowAckExporter()
        director = ExporterDirector(harness.stream, harness.db,
                                    {"eager": eager, "lazy": lazy})
        harness.deploy(one_task())
        harness.create_instance("p")
        director.export_available()
        state = ExportersState(harness.db)
        eager_ack = state.position("eager")
        lazy_ack = state.position("lazy")
        assert lazy_ack < eager_ack  # lazy acks every other record

        # "crash": directors and exporter instances dropped without close;
        # rebuild over the same db and keep the log moving
        eager2, lazy2 = CollectingExporter(), SlowAckExporter()
        director2 = ExporterDirector(harness.stream, harness.db,
                                     {"eager": eager2, "lazy": lazy2})
        harness.create_instance("p")
        director2.export_available()

        # no duplicates below the ack: the new instances never see a record
        # at or below their persisted position
        assert all(r.position > eager_ack for r in eager2.records)
        assert lazy2.seen and all(p > lazy_ack for p in lazy2.seen)
        # no gap above it: every committed position above the ack reaches the
        # restarted exporter exactly once (at-least-once resume, and within
        # one director lifetime exactly-once)
        log_positions = [lr.position for lr in harness.stream.new_reader(1)]
        expected_eager = [p for p in log_positions if p > eager_ack]
        assert [r.position for r in eager2.records] == expected_eager
        expected_lazy = [p for p in log_positions if p > lazy_ack]
        assert lazy2.seen == expected_lazy

    def test_failed_export_does_not_advance_pending_watermark(self, harness):
        """A failed export must leave last_delivered untouched: otherwise a
        later skip() believes the record was handed over and acks past it
        (the satellite bug: deliver() advanced the watermark BEFORE export)."""

        class FailingExporter(Exporter):
            def __init__(self):
                self.fail = True

            def export(self, record):
                if self.fail:
                    raise RuntimeError("sink down")
                self.controller.update_last_exported_position(record.position)

        failing = FailingExporter()
        clock = harness.clock
        director = ExporterDirector(harness.stream, harness.db,
                                    {"x": failing}, clock_millis=clock)
        harness.deploy(one_task())
        director.export_available()
        container = director.containers[0]
        # the watermark did NOT advance for the failed record: nothing was
        # handed over, so skip()'s pending-ack accounting stays truthful and
        # the read cursor is pinned on the failed record for retry
        assert container.last_delivered == container.position == 0
        assert container.next_position == 1
        assert container.paused
        # recover: the same record is retried and the stream drains
        failing.fail = False
        clock.advance(60_000)
        director.export_available()
        last = harness.stream.last_position
        assert container.position == last
        assert not container.paused


class SlowAckExporter(Exporter):
    """Acks only every other record — leaves its position behind."""

    def __init__(self):
        self.count = 0
        self.seen = []

    def export(self, record):
        self.count += 1
        self.seen.append(record.position)
        if self.count % 2 == 0:
            self.controller.update_last_exported_position(record.position)


class TestElasticsearchExporter:
    def test_bulk_ndjson_format(self, harness, tmp_path):
        es = ElasticsearchExporter(directory=tmp_path / "bulk", bulk_size=5)
        director = ExporterDirector(harness.stream, harness.db, {"es": es})
        harness.deploy(one_task())
        harness.create_instance("p")
        director.export_available()
        es.flush()
        files = sorted((tmp_path / "bulk").glob("*.ndjson"))
        assert files
        lines = files[0].read_text().strip().split("\n")
        assert len(lines) % 2 == 0
        action = json.loads(lines[0])
        doc = json.loads(lines[1])
        assert action["index"]["_index"].startswith("zeebe-record_")
        assert "valueType" in doc and "intent" in doc and "value" in doc
        # acked up to the last flushed record
        assert ExportersState(harness.db).position("es") > 0

    def test_sink_callable_receives_payload(self, harness):
        payloads = []
        es = ElasticsearchExporter(sink=payloads.append, bulk_size=10_000)
        director = ExporterDirector(harness.stream, harness.db, {"es": es})
        harness.deploy(one_task())
        director.export_available()
        es.flush()
        assert len(payloads) == 1
        assert payloads[0].endswith("\n")

    def test_index_per_value_type_and_day(self, harness):
        es = ElasticsearchExporter(sink=lambda p: None)
        director = ExporterDirector(harness.stream, harness.db, {"es": es})
        harness.deploy(one_task())
        director.export_available()
        # bulk accumulates action lines with per-value-type indices
        indices = {json.loads(line)["index"]["_index"]
                   for line in es._bulk[::2]}
        assert any("deployment" in i for i in indices)
        assert any(i.startswith("zeebe-record_process_") for i in indices)
        assert all(i.split("_")[-1].count("-") == 2 for i in indices)  # date suffix


class TestExporterDepth:
    """Auth, templating, retention/ILM, and the OpenSearch variant
    (reference: ElasticsearchExporterConfiguration.java:26-33,305-333,
    TemplateReader.java, ElasticsearchClient.java:210,
    exporters/opensearch-exporter/)."""

    def _drive(self, harness, es):
        director = ExporterDirector(harness.stream, harness.db, {"es": es})
        harness.deploy(one_task())
        harness.create_instance("p")
        director.export_available()
        es.flush()
        return es

    def test_templates_put_before_first_export(self, harness):
        from zeebe_tpu_torch.exporters import RetentionConfiguration

        es = self._drive(harness, ElasticsearchExporter(
            sink=lambda p: None,
            retention=RetentionConfiguration(enabled=True, minimum_age="7d"),
        ))
        paths = [p for (m, p, b) in es.requests if m == "PUT"]
        # ILM policy first, then component template, then per-value-type
        assert paths[0] == "/_ilm/policy/zeebe-record-retention-policy"
        assert paths[1] == "/_component_template/zeebe-record"
        assert any(p.startswith("/_index_template/zeebe-record_process-instance")
                   for p in paths)
        policy_body = json.loads(
            next(b for (m, p, b) in es.requests if "/_ilm/" in p))
        assert policy_body["policy"]["phases"]["delete"]["min_age"] == "7d"
        assert policy_body["policy"]["phases"]["delete"]["actions"] == {"delete": {}}

    def test_index_templates_reference_policy_and_alias(self, harness):
        from zeebe_tpu_torch.exporters import IndexConfiguration, RetentionConfiguration

        es = self._drive(harness, ElasticsearchExporter(
            sink=lambda p: None,
            index=IndexConfiguration(number_of_shards=3, number_of_replicas=1),
            retention=RetentionConfiguration(enabled=True),
        ))
        tpl = json.loads(next(
            b for (m, p, b) in es.requests
            if p == "/_index_template/zeebe-record_process-instance"))
        assert tpl["index_patterns"] == ["zeebe-record_process-instance_*"]
        assert tpl["composed_of"] == ["zeebe-record"]
        assert tpl["template"]["aliases"] == {"zeebe-record-process-instance": {}}
        settings = tpl["template"]["settings"]
        assert settings["number_of_shards"] == 3
        assert settings["number_of_replicas"] == 1
        assert settings["index.lifecycle.name"] == "zeebe-record-retention-policy"

    def test_create_template_off_skips_setup(self, harness):
        from zeebe_tpu_torch.exporters import IndexConfiguration

        es = self._drive(harness, ElasticsearchExporter(
            sink=lambda p: None, index=IndexConfiguration(create_template=False)))
        assert not [p for (m, p, b) in es.requests if m == "PUT"]

    def test_basic_auth_header_on_bulk(self, harness):
        from zeebe_tpu_torch.exporters import AuthenticationConfiguration

        sent = []
        es = ElasticsearchExporter(
            transport=lambda m, p, h, b: sent.append((m, p, h)),
            authentication=AuthenticationConfiguration(
                username="zeebe", password="secret"),
        )
        self._drive(harness, es)
        bulks = [(m, p, h) for (m, p, h) in sent if p == "/_bulk"]
        assert bulks
        import base64

        expected = "Basic " + base64.b64encode(b"zeebe:secret").decode()
        assert bulks[0][2]["Authorization"] == expected

    def test_api_key_auth_header(self, harness):
        from zeebe_tpu_torch.exporters import AuthenticationConfiguration

        sent = []
        es = ElasticsearchExporter(
            transport=lambda m, p, h, b: sent.append(h),
            authentication=AuthenticationConfiguration(api_key="abc123"),
        )
        self._drive(harness, es)
        assert any(h.get("Authorization") == "ApiKey abc123" for h in sent)

    def test_config_map_binds_auth_and_retention(self):
        from zeebe_tpu_torch.exporters import ExporterContext

        es = ElasticsearchExporter(sink=lambda p: None)
        es.configure(ExporterContext("es", {
            "authentication": {"username": "u", "password": "p"},
            "retention": {"enabled": True, "minimumAge": "14d",
                          "policyName": "keep-two-weeks"},
            "bulkMemoryLimit": 1024,
        }))
        assert es.authentication.is_present()
        assert es.retention.enabled and es.retention.minimum_age == "14d"
        assert es.retention.policy_name == "keep-two-weeks"
        assert es.bulk.memory_limit == 1024

    def test_record_type_filter_default_events_only(self, harness):
        payloads = []
        self._drive(harness, ElasticsearchExporter(sink=payloads.append))
        assert payloads
        # _bulk payload: every source line is an EVENT (commands off by
        # default; the director-side filter still ACKS skipped positions)
        for payload in payloads:
            for line in payload.strip().split("\n")[1::2]:
                assert json.loads(line)["recordType"] == "EVENT"

    def test_filtered_records_still_advance_position(self, harness):
        from zeebe_tpu_torch.exporters import IndexConfiguration

        # filter EVERYTHING: the exporter position must still advance via
        # director-side skips (no stalled compaction on filtered runs)
        es = ElasticsearchExporter(
            sink=lambda p: None,
            index=IndexConfiguration(command=False, event=False, rejection=False),
        )
        director = ExporterDirector(harness.stream, harness.db, {"es": es})
        harness.deploy(one_task())
        harness.create_instance("p")
        director.export_available()
        es.flush()
        assert ExportersState(harness.db).position("es") > 0

    def test_sequence_field_partition_shifted(self, harness):
        payloads = []
        self._drive(harness, ElasticsearchExporter(sink=payloads.append))
        lines = payloads[0].strip().split("\n")
        doc = json.loads(lines[1])
        assert doc["sequence"] == (doc["partitionId"] << 51) + 1
        doc2 = json.loads(lines[3])
        # second record of the same value type increments; of a new type restarts
        assert doc2["sequence"] >> 51 == doc2["partitionId"]

    def test_sequence_counters_survive_restart(self, harness):
        payloads = []
        es = ElasticsearchExporter(sink=payloads.append)
        director = ExporterDirector(harness.stream, harness.db, {"es": es})
        harness.deploy(one_task())
        harness.create_instance("p")
        director.export_available()
        es.flush()
        def by_type(payload_list):
            out = {}
            for payload in payload_list:
                for line in payload.strip().split("\n")[1::2]:
                    doc = json.loads(line)
                    out.setdefault(doc["valueType"], []).append(doc["sequence"])
            return out

        first = by_type(payloads)
        # new exporter + director over the same db = restart; counters
        # restore from persisted metadata, so per-type sequences continue
        payloads2 = []
        es2 = ElasticsearchExporter(sink=payloads2.append)
        director2 = ExporterDirector(harness.stream, harness.db, {"es": es2})
        harness.create_instance("p")
        director2.export_available()
        es2.flush()
        second = by_type(payloads2)
        assert second
        for vt, seqs in second.items():
            if vt in first:
                assert min(seqs) > max(first[vt]), vt

    def test_opensearch_rejects_retention_config(self):
        from zeebe_tpu_torch.exporters import ExporterContext, OpensearchExporter

        os_exp = OpensearchExporter(sink=lambda p: None)
        with pytest.raises(ValueError):
            os_exp.configure(ExporterContext("os", {"retention": {"enabled": True}}))
        from zeebe_tpu_torch.exporters import RetentionConfiguration

        with pytest.raises(ValueError):
            OpensearchExporter(
                sink=lambda p: None,
                retention=RetentionConfiguration(enabled=True))

    def test_memory_limit_triggers_flush(self, harness):
        payloads = []
        es = ElasticsearchExporter(sink=payloads.append, bulk_size=10_000)
        es.bulk.memory_limit = 512
        self._drive(harness, es)
        assert len(payloads) > 1  # flushed mid-stream by bytes, not by count

    def test_opensearch_variant(self, harness):
        from zeebe_tpu_torch.exporters import OpensearchExporter

        os_exp = self._drive(harness, OpensearchExporter(sink=lambda p: None))
        paths = [p for (m, p, b) in os_exp.requests if m == "PUT"]
        assert not any("/_ilm/" in p for p in paths)  # ISM, not ILM, in OpenSearch
        assert any(p.startswith("/_index_template/") for p in paths)

    def test_opensearch_aws_signing(self, harness):
        from zeebe_tpu_torch.exporters import AwsConfiguration, OpensearchExporter

        sent = []
        os_exp = OpensearchExporter(
            transport=lambda m, p, h, b: sent.append((p, h)),
            aws=AwsConfiguration(enabled=True, region="us-east-1",
                                 access_key="AK", secret_key="SK"),
        )
        self._drive(harness, os_exp)
        bulk_headers = next(h for (p, h) in sent if p == "/_bulk")
        assert bulk_headers["Authorization"].startswith("AWS4-HMAC-SHA256 Credential=AK/")
        assert "x-amz-date" in bulk_headers and "x-amz-content-sha256" in bulk_headers


class TestAtomicPositionMetadata:
    def test_position_and_metadata_persist_in_one_transaction(self, harness):
        """A crash between the metadata write and the position write would
        leave sequence counters ahead of the acked position — the controller
        must hand both to the host in ONE call, persisted in one txn."""
        state = ExportersState(harness.db)
        txn_spans = []
        real_txn = harness.db.transaction

        def spying_txn(*a, **kw):
            txn_spans.append(0)
            return real_txn(*a, **kw)

        harness.db.transaction = spying_txn
        try:
            state.set_position_and_metadata("x", 7, b"meta")
        finally:
            harness.db.transaction = real_txn
        assert len(txn_spans) == 1
        assert state.position("x") == 7
        assert state.metadata("x") == b"meta"

    def test_exporter_ack_with_metadata_lands_atomically(self, harness):
        class MetaExporter(Exporter):
            def export(self, record):
                self.controller.update_last_exported_position(
                    record.position, metadata=b"seq-state")

        state = ExportersState(harness.db)
        calls = []
        orig = state.set_position_and_metadata
        state.set_position_and_metadata = lambda *a: (calls.append(a), orig(*a))
        director = ExporterDirector(harness.stream, harness.db, {"m": MetaExporter()})
        # the director builds its own ExportersState; patch the container's
        for c in director.containers:
            c.state.set_position_and_metadata = state.set_position_and_metadata
        harness.deploy(one_task())
        harness.create_instance("p")
        director.export_available()
        assert calls  # the combined path was used, not split writes
        assert all(a[2] == b"seq-state" for a in calls)
