"""Cluster substrate: membership, messaging, Raft consensus.

Reference: atomix/ (SURVEY §2.2) — SwimMembershipProtocol, NettyMessagingService,
RaftContext/roles. TPU-native re-design: the control plane is host-side Python
(asyncio TCP for real deployments, a deterministic loopback network for tests);
device-side data never rides this path — partitions replicate *logs*, and device
state is recomputed from the log (SURVEY §2.13 replication row).
"""

from zeebe_tpu_torch.cluster.messaging import LoopbackNetwork, MessagingService, TcpMessagingService
from zeebe_tpu_torch.cluster.membership import Member, MembershipService, MemberState
from zeebe_tpu_torch.cluster.raft import RaftNode, RaftRole

__all__ = [
    "LoopbackNetwork",
    "MessagingService",
    "TcpMessagingService",
    "Member",
    "MemberState",
    "MembershipService",
    "RaftNode",
    "RaftRole",
]
