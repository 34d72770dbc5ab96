"""Broker composition: partitions over Raft, snapshotting, command ingress.

Reference: broker/ (SURVEY §2.10) — Broker.java:34, BrokerStartupProcess,
ZeebePartition + PartitionTransitionImpl (role-driven transition steps),
AsyncSnapshotDirector, CommandApiRequestHandler, InterPartitionCommandSender.
"""

from zeebe_tpu_torch.broker.partition import ZeebePartition
from zeebe_tpu_torch.broker.broker import (
    Broker,
    BrokerCfg,
    InProcessCluster,
    partition_distribution,
)

__all__ = ["ZeebePartition", "Broker", "BrokerCfg", "InProcessCluster",
           "partition_distribution"]
