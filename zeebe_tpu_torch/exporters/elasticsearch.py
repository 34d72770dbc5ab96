"""Elasticsearch exporter with authentication, index templating, and
ILM-based retention, plus the OpenSearch variant.

Reference: exporters/elasticsearch-exporter/src/main/java/io/camunda/zeebe/
exporter/ — ElasticsearchExporter.java (bulk NDJSON flush on size/memory/
delay, record counters for the ``sequence`` field), RecordIndexRouter.java
(index ``<prefix>_<valueType>_<version>_<date>``, id ``<partition>-<position>``,
alias ``<prefix>-<valueType>``), TemplateReader.java (component + per-value-
type index templates, shard/replica/ILM substitution),
ElasticsearchExporterConfiguration.java:26-33,305-333 (IndexConfiguration
record/value-type toggles, BulkConfiguration, AuthenticationConfiguration
basic auth, RetentionConfiguration ILM policy), ElasticsearchClient.java:210
(PUT /_ilm/policy with a delete phase at minimum_age);
exporters/opensearch-exporter/ (same surface minus ILM, plus AWS request
signing).

No network egress in this environment, so transport is pluggable: every HTTP
request the exporter would issue (templates, policy, bulks) goes through a
``transport(method, path, headers, body)`` callable. The default directory
transport writes bulk NDJSON files plus ``setup-*.json`` request captures; a
real deployment supplies an HTTP transport. The legacy ``sink(payload)``
callable still receives raw bulk payloads.
"""

from __future__ import annotations

import base64
import dataclasses
import json
from pathlib import Path
from typing import Any, Callable

from zeebe_tpu_torch.exporters.api import Exporter, ExporterContext
from zeebe_tpu_torch.logstreams import LoggedRecord
from zeebe_tpu_torch.protocol.enums import RecordType, ValueType

INDEX_PREFIX = "zeebe-record"
VERSION = "8.4.0"

# value types exported by default (reference IndexConfiguration defaults:
# ElasticsearchExporterConfiguration.java:154-185 — jobBatch, messageBatch,
# processInstanceBatch, checkpoint, and processEvent default to false)
_DEFAULT_OFF = {
    ValueType.JOB_BATCH,
    ValueType.PROCESS_INSTANCE_BATCH,
    ValueType.CHECKPOINT,
    ValueType.PROCESS_EVENT,
}


@dataclasses.dataclass
class IndexConfiguration:
    """Which record/value types to export, and template/index settings
    (reference: IndexConfiguration)."""

    prefix: str = INDEX_PREFIX
    create_template: bool = True
    # record types
    command: bool = False
    event: bool = True
    rejection: bool = False
    # value-type toggles: absent → reference default
    value_types: dict[ValueType, bool] = dataclasses.field(default_factory=dict)
    number_of_shards: int | None = None
    number_of_replicas: int | None = None

    def should_index_value_type(self, value_type: ValueType) -> bool:
        override = self.value_types.get(value_type)
        if override is not None:
            return override
        return value_type not in _DEFAULT_OFF

    def should_index_record_type(self, record_type: RecordType) -> bool:
        if record_type == RecordType.EVENT:
            return self.event
        if record_type == RecordType.COMMAND:
            return self.command
        if record_type == RecordType.COMMAND_REJECTION:
            return self.rejection
        return False


@dataclasses.dataclass
class BulkConfiguration:
    """Flush thresholds (reference: BulkConfiguration — delay seconds,
    record count, memory bytes)."""

    delay_seconds: int = 5
    size: int = 1_000
    memory_limit: int = 10 * 1024 * 1024


@dataclasses.dataclass
class AuthenticationConfiguration:
    """Basic (username/password) or API-key auth; becomes an Authorization
    header on every request (reference: AuthenticationConfiguration +
    RestClientFactory basic-auth wiring)."""

    username: str | None = None
    password: str | None = None
    api_key: str | None = None

    def is_present(self) -> bool:
        return bool(self.username and self.password) or bool(self.api_key)

    def header(self) -> dict[str, str]:
        if self.api_key:
            return {"Authorization": f"ApiKey {self.api_key}"}
        if self.username and self.password:
            token = base64.b64encode(
                f"{self.username}:{self.password}".encode()
            ).decode()
            return {"Authorization": f"Basic {token}"}
        return {}


@dataclasses.dataclass
class RetentionConfiguration:
    """Index lifecycle: delete indices older than minimum_age via an ILM
    policy referenced from every index template (reference:
    RetentionConfiguration + ElasticsearchClient.putIndexLifecycleManagementPolicy)."""

    enabled: bool = False
    minimum_age: str = "30d"
    policy_name: str = "zeebe-record-retention-policy"


@dataclasses.dataclass
class AwsConfiguration:
    """OpenSearch-only: SigV4-sign requests for Amazon OpenSearch Service
    (reference: OpensearchExporterConfiguration.AwsConfiguration)."""

    enabled: bool = False
    region: str = "eu-west-1"
    service_name: str = "es"
    access_key: str = ""
    secret_key: str = ""


class ElasticsearchExporter(Exporter):
    def __init__(self, sink: Callable[[str], None] | None = None,
                 directory: str | Path | None = None,
                 bulk_size: int | None = None,
                 transport: Callable[[str, str, dict, str], Any] | None = None,
                 index: IndexConfiguration | None = None,
                 bulk: BulkConfiguration | None = None,
                 authentication: AuthenticationConfiguration | None = None,
                 retention: RetentionConfiguration | None = None) -> None:
        if sink is None and directory is None and transport is None:
            raise ValueError("need a sink callable, transport, or a bulk-file directory")
        self._directory = Path(directory) if directory else None
        if self._directory is not None:
            self._directory.mkdir(parents=True, exist_ok=True)
        self._sink = sink
        self._transport = transport
        self.index = index or IndexConfiguration()
        self.bulk = bulk or BulkConfiguration()
        if bulk_size is not None:
            self.bulk.size = bulk_size
        self.authentication = authentication or AuthenticationConfiguration()
        self.retention = retention or RetentionConfiguration()
        self._bulk: list[str] = []
        self._bulk_bytes = 0
        self._bulk_last_position = -1
        self._flush_count = 0
        self._setup_count = 0
        self._setup_done = False
        # per-value-type record counters feeding the `sequence` field
        # (reference: ElasticsearchRecordCounters + RecordSequence —
        # sequence = (partitionId << 51) + counter)
        self._counters: dict[str, int] = {}
        # bounded request capture for tests/diagnostics: bulk BODIES are
        # elided (they already reach the sink/directory/transport) so a
        # long-running broker does not accumulate payload strings
        from collections import deque

        self.requests: deque[tuple[str, str, str]] = deque(maxlen=256)
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        # registered at construction (reference: ElasticsearchMetrics is
        # created with the exporter, not on first flush)
        self._bulk_size_metric = REGISTRY.histogram(
            "bulk_size", "records per exporter bulk flush",
            buckets=(1, 10, 100, 500, 1000, 5000))
        self._bulk_memory_metric = REGISTRY.histogram(
            "bulk_memory_size", "bytes per exporter bulk flush",
            buckets=(1024, 16384, 262144, 1 << 20, 16 << 20))

    # convenience alias kept for existing callers/tests
    @property
    def bulk_size(self) -> int:
        return self.bulk.size

    @bulk_size.setter
    def bulk_size(self, v: int) -> None:
        self.bulk.size = v

    # -- lifecycle -------------------------------------------------------------

    def configure(self, context: ExporterContext) -> None:
        super().configure(context)
        # filtering happens DIRECTOR-side via the context filter (reference:
        # ElasticsearchExporter.configure → context.setFilter): skipped
        # records still advance the exporter position, so compaction and
        # re-delivery never stall on a run of filtered records
        context.record_filter = self._should_index
        cfg = context.configuration
        self.bulk.size = cfg.get("bulkSize", self.bulk.size)
        self.bulk.delay_seconds = cfg.get("bulkDelay", self.bulk.delay_seconds)
        self.bulk.memory_limit = cfg.get("bulkMemoryLimit", self.bulk.memory_limit)
        auth = cfg.get("authentication", {})
        if auth:
            self.authentication = AuthenticationConfiguration(
                username=auth.get("username"), password=auth.get("password"),
                api_key=auth.get("apiKey"),
            )
        ret = cfg.get("retention", {})
        if ret:
            self.retention = RetentionConfiguration(
                enabled=ret.get("enabled", False),
                minimum_age=ret.get("minimumAge", self.retention.minimum_age),
                policy_name=ret.get("policyName", self.retention.policy_name),
            )

    def open(self, controller) -> None:
        super().open(controller)
        # restore the per-value-type sequence counters persisted alongside
        # position acks, so a restart continues sequences instead of
        # restarting at 1 (reference: ElasticsearchExporterMetadata)
        meta = controller.read_metadata()
        if meta:
            try:
                self._counters = {
                    str(k): int(v) for k, v in json.loads(meta.decode()).items()
                }
            except (ValueError, AttributeError):
                pass  # unreadable metadata: keep fresh counters
        self._schedule_delayed_flush()

    def _schedule_delayed_flush(self) -> None:
        """Periodic flush (reference: ElasticsearchExporter.scheduleDelayedFlush);
        a no-op when the hosting context offers no scheduler (tests driving
        flush() directly)."""
        try:
            self.controller.schedule_task(
                self.bulk.delay_seconds * 1000, self._flush_and_reschedule
            )
        except (RuntimeError, AttributeError):
            pass

    def _flush_and_reschedule(self) -> None:
        try:
            self.flush()
        finally:
            self._schedule_delayed_flush()

    def _should_index(self, record: LoggedRecord) -> bool:
        rec = record.record
        return (self.index.should_index_record_type(rec.record_type)
                and self.index.should_index_value_type(rec.value_type))

    def export(self, record: LoggedRecord) -> None:
        if not self._setup_done:
            self._setup()
        rec = record.record
        if not self._should_index(record):
            # direct callers without a director-side filter: drop but ack
            self._bulk_last_position = record.position
            if not self._bulk:
                self.controller.update_last_exported_position(record.position)
            return
        doc = rec.to_json_dict()
        doc["position"] = record.position
        vt = rec.value_type.name
        counter = self._counters.get(vt, 0) + 1
        self._counters[vt] = counter
        doc["sequence"] = (doc.get("partitionId", 1) << 51) + counter
        index = self._index_for(record)
        doc_id = f"{doc.get('partitionId', 1)}-{record.position}"
        action = json.dumps(
            {"index": {"_index": index, "_id": doc_id,
                       "routing": str(doc.get("partitionId", 1))}},
            separators=(",", ":"),
        )
        source = json.dumps(doc, separators=(",", ":"), default=_json_default)
        self._bulk.append(action)
        self._bulk.append(source)
        self._bulk_bytes += len(action) + len(source) + 2
        self._bulk_last_position = record.position
        if (len(self._bulk) // 2 >= self.bulk.size
                or self._bulk_bytes >= self.bulk.memory_limit):
            self.flush()

    def flush(self) -> None:
        if not self._bulk:
            return
        payload = "\n".join(self._bulk) + "\n"
        self._bulk_size_metric.observe(len(self._bulk) // 2)
        self._bulk_memory_metric.observe(len(payload))
        if self._sink is not None:
            self._sink(payload)
        if self._directory is not None:
            path = self._directory / f"bulk-{self._flush_count:08d}.ndjson"
            path.write_text(payload)
        self._request("POST", "/_bulk", payload)
        self._flush_count += 1
        self._bulk.clear()
        self._bulk_bytes = 0
        self.controller.update_last_exported_position(
            self._bulk_last_position,
            metadata=json.dumps(self._counters, separators=(",", ":")).encode(),
        )

    def close(self) -> None:
        self.flush()

    # -- index/template management --------------------------------------------

    def _setup(self) -> None:
        """One-time index plumbing before the first export (reference:
        ElasticsearchExporter.export → createIndexTemplates once):
        retention policy, shared component template, one index template per
        exported value type. `_setup_done` flips only after every request
        went through — a transport failure leaves setup pending so the
        director's retry re-attempts it."""
        if self.index.create_template:
            if self.retention.enabled:
                self._put_retention_policy()
            self._put_request(
                f"/_component_template/{self.index.prefix}",
                {"template": {"settings": self._index_settings()}},
            )
            for vt in ValueType:
                if self.index.should_index_value_type(vt):
                    self._put_index_template(vt)
        self._setup_done = True

    def _index_settings(self) -> dict:
        settings: dict[str, Any] = {}
        if self.index.number_of_shards is not None:
            settings["number_of_shards"] = self.index.number_of_shards
        if self.index.number_of_replicas is not None:
            settings["number_of_replicas"] = self.index.number_of_replicas
        if self.retention.enabled:
            settings["index.lifecycle.name"] = self.retention.policy_name
        return settings

    def _put_index_template(self, value_type: ValueType) -> None:
        vt = value_type.name.lower().replace("_", "-")
        search_pattern = f"{self.index.prefix}_{vt}_*"
        alias = f"{self.index.prefix}-{vt}"
        template = {
            "index_patterns": [search_pattern],
            "composed_of": [self.index.prefix],
            "priority": 20,
            "template": {
                "aliases": {alias: {}},
                "settings": self._index_settings(),
            },
        }
        self._put_request(f"/_index_template/{self.index.prefix}_{vt}", template)

    def _put_retention_policy(self) -> None:
        policy = {
            "policy": {
                "phases": {
                    "delete": {
                        "min_age": self.retention.minimum_age,
                        "actions": {"delete": {}},
                    }
                }
            }
        }
        self._put_request(f"/_ilm/policy/{self.retention.policy_name}", policy)

    def _put_request(self, path: str, body: dict) -> None:
        payload = json.dumps(body, separators=(",", ":"))
        if self._directory is not None:
            name = f"setup-{self._setup_count:04d}{path.replace('/', '_')}.json"
            (self._directory / name).write_text(payload)
            self._setup_count += 1
        self._request("PUT", path, payload)

    def _request(self, method: str, path: str, body: str) -> None:
        self.requests.append((method, path, "" if path == "/_bulk" else body))
        if self._transport is not None:
            self._transport(method, path, self._headers(method, path, body), body)

    def _headers(self, method: str, path: str, body: str) -> dict[str, str]:
        headers = {"Content-Type": "application/x-ndjson" if path == "/_bulk"
                   else "application/json"}
        headers.update(self.authentication.header())
        return headers

    # -- helpers ---------------------------------------------------------------

    def _index_for(self, record: LoggedRecord) -> str:
        value_type = record.record.value_type.name.lower().replace("_", "-")
        day = _day_of(record.record.timestamp)
        return f"{self.index.prefix}_{value_type}_{VERSION}_{day}"


class OpensearchExporter(ElasticsearchExporter):
    """OpenSearch variant (reference: exporters/opensearch-exporter/) —
    identical bulk/index/template surface, no ILM (OpenSearch uses ISM
    plugins; the reference variant ships no retention either), optional AWS
    SigV4 request signing for Amazon OpenSearch Service."""

    def __init__(self, *args, aws: AwsConfiguration | None = None, **kw) -> None:
        if kw.get("retention") is not None and kw["retention"].enabled:
            raise ValueError(
                "OpenSearch retention is managed by ISM plugins, not ILM; "
                "the opensearch exporter accepts no retention configuration"
            )
        kw["retention"] = RetentionConfiguration(enabled=False)
        super().__init__(*args, **kw)
        self.aws = aws or AwsConfiguration()

    def configure(self, context: ExporterContext) -> None:
        if context.configuration.get("retention", {}).get("enabled"):
            raise ValueError(
                "OpenSearch retention is managed by ISM plugins, not ILM; "
                "remove the retention block from the exporter configuration"
            )
        super().configure(context)

    def _headers(self, method: str, path: str, body: str) -> dict[str, str]:
        headers = super()._headers(method, path, body)
        if self.aws.enabled:
            import datetime
            import hashlib

            from zeebe_tpu_torch.backup.s3 import sign_v4

            amz_date = datetime.datetime.now(datetime.timezone.utc).strftime(
                "%Y%m%dT%H%M%SZ"
            )
            payload_hash = hashlib.sha256(body.encode()).hexdigest()
            host = f"{self.aws.service_name}.{self.aws.region}.amazonaws.com"
            headers["x-amz-date"] = amz_date
            headers["x-amz-content-sha256"] = payload_hash
            headers["Authorization"] = sign_v4(
                method, host, path, {},
                {"x-amz-date": amz_date, "x-amz-content-sha256": payload_hash},
                payload_hash, self.aws.region, self.aws.service_name,
                self.aws.access_key, self.aws.secret_key, amz_date,
            )
        return headers


def _day_of(timestamp_millis: int) -> str:
    import datetime

    dt = datetime.datetime.fromtimestamp(timestamp_millis / 1000, datetime.timezone.utc)
    return dt.strftime("%Y-%m-%d")


def _json_default(obj):
    if isinstance(obj, bytes):
        return obj.hex()
    raise TypeError(f"not JSON serializable: {type(obj).__name__}")
