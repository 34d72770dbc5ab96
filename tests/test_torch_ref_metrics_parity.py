# tests/test_metrics_parity.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Metric-name parity with the reference (SURVEY §5.5: 111 distinct names).

The reference names were extracted verbatim from its *Metrics.java classes
(tests/data/reference_metric_names.txt). A full in-process cluster scenario —
gRPC gateway, multi-partition broker, jobs (pull + push), timers, incidents,
messages, DMN, snapshot, backup — must leave >= 80 of those names registered,
and the management server's /metrics endpoint must expose them in Prometheus
text format."""

from __future__ import annotations

from pathlib import Path

REFERENCE_NAMES = set(
    (Path(__file__).parent / "data" / "reference_metric_names.txt")
    .read_text().split()
)


def registered_names() -> set[str]:
    from zeebe_tpu_torch.utils.metrics import REGISTRY

    prefix = f"{REGISTRY.namespace}_"
    return {n[len(prefix):] for n in REGISTRY._metrics}  # noqa: SLF001


def test_reference_name_coverage_after_full_scenario(tmp_path):
    import threading

    from zeebe_tpu_torch.backup.checkpoint import CheckpointState
    from zeebe_tpu_torch.backup.service import BackupService
    from zeebe_tpu_torch.backup.store import FileSystemBackupStore
    from zeebe_tpu_torch.client import JobWorker, ZeebeTpuClient
    from zeebe_tpu_torch.gateway import ClusterRuntime, Gateway
    from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml

    procs = [
        Bpmn.create_executable_process("mp_one")
        .start_event("s").service_task("t", job_type="mp_w")
        .end_event("e").done(),
        Bpmn.create_executable_process("mp_incident")
        .start_event("s").exclusive_gateway("gw")
        .condition_expression("x > 100").end_event("e").done(),
    ]
    runtime = ClusterRuntime(broker_count=1, partition_count=2, device="cpu")
    runtime.start()
    gw = Gateway(runtime)
    gw.start()
    client = ZeebeTpuClient(gw.address)
    try:
        client.deploy_resource(
            *[(f"{p.process_id}.bpmn", to_bpmn_xml(p)) for p in procs])
        for i in range(4):
            client.create_instance("mp_one", variables={"i": i})
        client.create_instance("mp_incident", variables={"x": 1})
        client.publish_message("mp_msg", "k1", variables={})
        for j in client.activate_jobs("mp_w", max_jobs=2,
                                      request_timeout_ms=5000):
            client.complete_job(j.key, {})
        # push path registers/unregisters a stream
        done = threading.Event()

        def _work(job):
            done.set()
            return {}

        worker = JobWorker(client, "mp_w", _work, stream_enabled=True).start()
        client.create_instance("mp_one", variables={"i": 99})
        done.wait(timeout=15)
        worker.stop()
        client.topology()
        broker = runtime.brokers["broker-0"]
        partition = broker.partitions[1]
        # snapshot + backup exercise their metric families
        partition.take_snapshot()
        store = FileSystemBackupStore(tmp_path / "backups")
        BackupService(store, "broker-0").take_backup(partition, 1, 1)
        with partition.db.transaction():
            CheckpointState(partition.db).put(1, 1)
    finally:
        client.close()
        gw.stop()
        runtime.stop()

    # the exporter and DMN metrics register at component construction
    # (reference: static collectors), so touching the components is enough
    from zeebe_tpu_torch.exporters import ElasticsearchExporter

    ElasticsearchExporter(sink=lambda p: None)
    import zeebe_tpu_torch.engine.decision  # noqa: F401 — registers the DMN counter

    ours = registered_names()
    matched = ours & REFERENCE_NAMES
    missing = sorted(REFERENCE_NAMES - ours)
    assert len(matched) == len(REFERENCE_NAMES), (
        f"only {len(matched)}/{len(REFERENCE_NAMES)} reference metric names "
        f"registered; missing: {missing}")


def test_metrics_endpoint_exposes_reference_names():
    import urllib.request

    from zeebe_tpu_torch.broker.management import ManagementServer

    server = ManagementServer(broker=None)
    server.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/metrics", timeout=5) as resp:
            body = resp.read().decode()
        exposed = {
            line.split("{")[0].split(" ")[0][len("zeebe_"):]
            for line in body.splitlines()
            if line and not line.startswith("#")
        }
        # histograms expose _bucket/_sum/_count series — strip the suffixes
        def base(n: str) -> str:
            for suffix in ("_bucket", "_sum", "_count"):
                if n.endswith(suffix):
                    return n[: -len(suffix)]
            return n

        exposed = {base(n) for n in exposed}
        matched = exposed & REFERENCE_NAMES
        assert len(matched) >= 60, sorted(matched)
    finally:
        server.stop()
