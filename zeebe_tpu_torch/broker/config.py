"""Broker configuration tree with relaxed environment binding.

Reference: broker/src/main/java/io/camunda/zeebe/broker/system/configuration/
BrokerCfg.java tree (ClusterCfg, DataCfg/DiskCfg, BackpressureCfg,
ProcessingCfg, FeatureFlagsCfg) bound by Spring Boot relaxed binding from
``zeebe.broker.*`` properties / ``ZEEBE_BROKER_*`` env vars
(docs/backpressure.md:23-37 shows the env naming scheme).

``load_broker_cfg`` binds, in precedence order: explicit overrides > env vars >
defaults — e.g. ``ZEEBE_BROKER_CLUSTER_PARTITIONSCOUNT=3`` sets
``cluster.partitions_count``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

from zeebe_tpu_torch.broker.broker import BrokerCfg


@dataclasses.dataclass
class DiskCfg:
    # pause ingestion below the free-space watermark (reference: DiskCfg
    # freeSpace.processing / replication)
    min_free_bytes: int = 128 * 1024 * 1024
    monitoring_interval_ms: int = 10_000
    enable_monitoring: bool = True


@dataclasses.dataclass
class BackpressureCfg:
    enabled: bool = True
    algorithm: str = "vegas"  # vegas | aimd | fixed


@dataclasses.dataclass
class ProcessingCfg:
    max_commands_in_batch: int = 100
    # ingress batch-coalescing window (ms, multiproc worker): commands
    # arriving within the window append as ONE raft batch (one fsync, one
    # replication round). 0 = append per command (the legacy byte path);
    # at runtime the ingress-coalescing controller owns this knob.
    coalesce_window_ms: float = 0.0


@dataclasses.dataclass
class ExtendedBrokerCfg:
    """BrokerCfg + the operational sub-configs."""

    base: BrokerCfg = dataclasses.field(default_factory=BrokerCfg)
    disk: DiskCfg = dataclasses.field(default_factory=DiskCfg)
    backpressure: BackpressureCfg = dataclasses.field(default_factory=BackpressureCfg)
    processing: ProcessingCfg = dataclasses.field(default_factory=ProcessingCfg)

    def validate(self) -> None:
        if self.base.partition_count < 1:
            raise ValueError("partitionsCount must be >= 1")
        if self.base.replication_factor < 1:
            raise ValueError("replicationFactor must be >= 1")
        if self.base.node_id not in self.base.cluster_members:
            raise ValueError(
                f"nodeId {self.base.node_id!r} not in clusterMembers "
                f"{self.base.cluster_members!r}"
            )
        if self.backpressure.algorithm not in ("vegas", "aimd", "fixed"):
            raise ValueError(f"unknown backpressure algorithm "
                             f"{self.backpressure.algorithm!r}")
        if self.processing.max_commands_in_batch < 1:
            raise ValueError("maxCommandsInBatch must be >= 1")
        if self.processing.coalesce_window_ms < 0:
            raise ValueError("coalesceWindowMs must be >= 0")
        if self.base.log_flush_delay_ms < 0:
            raise ValueError("logFlushDelayMs must be >= 0")
        if self.base.log_max_unflushed_bytes < 1:
            raise ValueError("logMaxUnflushedBytes must be >= 1")
        if self.base.snapshot_chain_length < 1:
            raise ValueError("snapshotChainLength must be >= 1")
        if self.base.tiering_park_after_ms < 0:
            raise ValueError("tiering parkAfterMs must be >= 0")
        if self.base.tiering_spill_batch < 1:
            raise ValueError("tiering spillBatch must be >= 1")
        if self.base.scrub_interval_ms < 0:
            raise ValueError("scrub intervalMs must be >= 0")
        if self.base.scrub_bytes_per_pass < 1:
            raise ValueError("scrub bytesPerPass must be >= 1")


# env var → (section, field, type); relaxed-binding names follow the
# reference's ZEEBE_BROKER_<SECTION>_<FIELD> scheme
_ENV_BINDINGS: dict[str, tuple[str, str, Any]] = {
    "ZEEBE_BROKER_CLUSTER_NODEID": ("base", "node_id", str),
    "ZEEBE_BROKER_CLUSTER_PARTITIONSCOUNT": ("base", "partition_count", int),
    "ZEEBE_BROKER_CLUSTER_REPLICATIONFACTOR": ("base", "replication_factor", int),
    "ZEEBE_BROKER_CLUSTER_INITIALCONTACTPOINTS": (
        "base", "cluster_members", lambda v: [m.strip() for m in v.split(",")]),
    "ZEEBE_BROKER_DATA_SNAPSHOTPERIOD": ("base", "snapshot_period_ms", int),
    "ZEEBE_BROKER_DATA_DISK_MINFREEBYTES": ("disk", "min_free_bytes", int),
    "ZEEBE_BROKER_DATA_DISK_ENABLEMONITORING": (
        "disk", "enable_monitoring", lambda v: v.lower() in ("1", "true", "yes")),
    "ZEEBE_BROKER_BACKPRESSURE_ENABLED": (
        "backpressure", "enabled", lambda v: v.lower() in ("1", "true", "yes")),
    "ZEEBE_BROKER_BACKPRESSURE_ALGORITHM": ("backpressure", "algorithm", str),
    "ZEEBE_BROKER_PROCESSING_MAXCOMMANDSINBATCH": (
        "processing", "max_commands_in_batch", int),
    "ZEEBE_BROKER_EXPERIMENTAL_CONSISTENCYCHECKS": (
        "base", "consistency_checks", lambda v: v.lower() in ("1", "true", "yes")),
    "ZEEBE_BROKER_EXPERIMENTAL_KERNELBACKEND": (
        "base", "kernel_backend", lambda v: v.lower() in ("1", "true", "yes")),
    "ZEEBE_BROKER_EXPERIMENTAL_KERNELMESHSHARDS": (
        "base", "kernel_mesh_shards", int),
    "ZEEBE_BROKER_EXPERIMENTAL_DURABLESTATE": (
        "base", "durable_state", lambda v: v.lower() in ("1", "true", "yes")),
    # metrics plane: registry→time-series sampling cadence (0 disables the
    # store, the sampler, and alert evaluation)
    "ZEEBE_BROKER_METRICS_SAMPLINGINTERVALMS": (
        "base", "metrics_sampling_ms", int),
    # continuous profiler: stack sampling rate (0 disables the plane)
    "ZEEBE_BROKER_PROFILING_HZ": ("base", "profiling_hz", float),
    # recovery-time budget: recoveries slower than this fire the
    # recovery_budget_exceeded alert; the snapshot scheduler adapts its
    # cadence to keep projected replay debt under it (<= 0 disables)
    "ZEEBE_BROKER_DATA_RECOVERYBUDGETMS": ("base", "recovery_budget_ms", int),
    # incremental snapshots: base+delta chain length before a full rebase
    # (1 = every snapshot is a full snapshot)
    "ZEEBE_BROKER_DATA_SNAPSHOTCHAINLENGTH": (
        "base", "snapshot_chain_length", int),
    # state tiering: cold parked-instance store — spill instances
    # parked past PARKAFTERMS to disk, SPILLBATCH instances per pump pass
    "ZEEBE_BROKER_DATA_TIERING_ENABLED": (
        "base", "tiering", lambda v: v.lower() in ("1", "true", "yes")),
    "ZEEBE_BROKER_DATA_TIERING_PARKAFTERMS": (
        "base", "tiering_park_after_ms", int),
    "ZEEBE_BROKER_DATA_TIERING_SPILLBATCH": (
        "base", "tiering_spill_batch", int),
    # raft journal group-commit pacing: 0 = fsync before every
    # ack; > 0 = defer the fsync up to this many ms (acks wait for it)
    "ZEEBE_BROKER_DATA_LOGFLUSHDELAYMS": ("base", "log_flush_delay_ms", int),
    "ZEEBE_BROKER_DATA_LOGMAXUNFLUSHEDBYTES": (
        "base", "log_max_unflushed_bytes", int),
    # ingress batch-coalescing window (multiproc worker ingress)
    "ZEEBE_BROKER_PROCESSING_COALESCEWINDOWMS": (
        "processing", "coalesce_window_ms", float),
    # at-rest storage scrubber: pump-throttled background CRC
    # walk over journals, snapshot chains, and cold segments
    "ZEEBE_BROKER_DATA_SCRUB_ENABLED": (
        "base", "scrub", lambda v: v.lower() in ("1", "true", "yes")),
    "ZEEBE_BROKER_DATA_SCRUB_INTERVALMS": (
        "base", "scrub_interval_ms", int),
    "ZEEBE_BROKER_DATA_SCRUB_BYTESPERPASS": (
        "base", "scrub_bytes_per_pass", int),
}


def load_broker_cfg(env: dict[str, str] | None = None,
                    overrides: dict[str, Any] | None = None) -> ExtendedBrokerCfg:
    env = os.environ if env is None else env
    cfg = ExtendedBrokerCfg()
    for var, (section, field, convert) in _ENV_BINDINGS.items():
        if var in env:
            setattr(getattr(cfg, section), field, convert(env[var]))
    for dotted, value in (overrides or {}).items():
        section, field = dotted.split(".", 1)
        setattr(getattr(cfg, section), field, value)
    if cfg.base.node_id not in cfg.base.cluster_members and \
            cfg.base.cluster_members == ["broker-0"]:
        # single-node default: the node is its own cluster
        cfg.base.cluster_members = [cfg.base.node_id]
    cfg.validate()
    return cfg
