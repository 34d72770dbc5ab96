"""Dynamic cluster topology: gossiped versioned state + change coordination.

Reference: topology/src/main/java/io/camunda/zeebe/topology/
ClusterTopologyManager.java, state/ClusterTopology (versioned MemberState/
PartitionState), gossip/ClusterTopologyGossiper.java:34, changes/ (MemberJoin/
MemberLeave/PartitionJoin/PartitionLeave appliers) and
TopologyChangeCoordinatorImpl.

Redesigned for the tick-driven runtime: the topology is a plain versioned
document gossiped through the SWIM membership's property map (higher version
wins — the coordinator serializes changes, so versions are totally ordered in
practice); a change is an ordered list of operations, each applied BY ITS
TARGET MEMBER when it observes that the operation is next. Completing an
operation bumps the version and gossips the advanced plan, which is what
hands the baton to the next operation's target. Raft-level membership moves
use single-step reconfiguration (cluster/raft.py reconfigure): PARTITION_JOIN
starts a replica on the target, asks the leader to add it, and completes once
the new replica has caught up to the leader's commit; PARTITION_LEAVE removes
the member from the raft group, then stops the local replica.
"""

from __future__ import annotations

import copy
from typing import Any, Callable

# operation kinds (reference: topology/changes/ appliers)
MEMBER_JOIN = "MEMBER_JOIN"
MEMBER_LEAVE = "MEMBER_LEAVE"
PARTITION_JOIN = "PARTITION_JOIN"
PARTITION_LEAVE = "PARTITION_LEAVE"

# member / partition-replica states (reference: state/MemberState, PartitionState)
ACTIVE = "active"
JOINING = "joining"
LEAVING = "leaving"
LEFT = "left"


class ClusterTopology:
    """The gossiped document. Plain-dict representation so it serializes
    through the membership gossip unchanged:

    {"version": N,
     "members": {member_id: {"state": ..., "partitions": {pid: {"state": ...,
                                                          "priority": P}}}},
     "change": {"id": N, "index": i, "operations": [op, ...]} | None}

    where op = {"op": KIND, "member": id, "partition": pid?, "priority": P?,
                "members": [...]?}.
    """

    def __init__(self, doc: dict | None = None) -> None:
        self.doc = doc or {"version": 0, "members": {}, "change": None}

    # -- views ---------------------------------------------------------------

    @property
    def version(self) -> int:
        return self.doc["version"]

    @property
    def members(self) -> dict:
        return self.doc["members"]

    @property
    def change(self) -> dict | None:
        return self.doc.get("change")

    def partition_members(self, partition_id: int) -> list[str]:
        """Members hosting a replica of the partition (any replica state)."""
        out = []
        for member_id, member in self.members.items():
            if str(partition_id) in member.get("partitions", {}):
                out.append(member_id)
        return sorted(out)

    def active_partition_members(self, partition_id: int) -> list[str]:
        out = []
        for member_id, member in self.members.items():
            p = member.get("partitions", {}).get(str(partition_id))
            if p is not None and p.get("state") == ACTIVE:
                out.append(member_id)
        return sorted(out)

    def next_operation(self) -> dict | None:
        change = self.change
        if not change:
            return None
        ops = change["operations"]
        idx = change["index"]
        return ops[idx] if idx < len(ops) else None

    def summary(self) -> dict:
        """Compact read-only view for ``GET /cluster/status``: version,
        member/replica states and priorities, and whether a change plan is
        mid-flight (operators care that a move is in progress, not about the
        operation list's internals)."""
        members = {}
        for member_id, member in sorted(self.members.items()):
            members[member_id] = {
                "state": member.get("state", ACTIVE),
                "partitions": {
                    pid: {"state": p.get("state", ACTIVE),
                          "priority": p.get("priority", 1)}
                    for pid, p in sorted(member.get("partitions", {}).items())
                },
            }
        return {
            "version": self.version,
            "members": members,
            "changeInProgress": self.change is not None,
        }

    # -- construction ---------------------------------------------------------

    @classmethod
    def initial(cls, distribution: dict[int, list[str]], members: list[str],
                priorities: dict[tuple[str, int], int] | None = None) -> "ClusterTopology":
        topo = cls()
        for m in members:
            topo.members[m] = {"state": ACTIVE, "partitions": {}}
        for pid, hosts in distribution.items():
            for i, m in enumerate(hosts):
                topo.members.setdefault(m, {"state": ACTIVE, "partitions": {}})
                prio = (priorities or {}).get((m, pid), len(hosts) - i)
                topo.members[m]["partitions"][str(pid)] = {
                    "state": ACTIVE, "priority": prio,
                }
        return topo

    def copy(self) -> "ClusterTopology":
        return ClusterTopology(copy.deepcopy(self.doc))


class TopologyManager:
    """Per-broker topology participant (and coordinator for locally-proposed
    changes). Hooks decouple it from the broker:

    - start_replica(partition_id, members, priority): bootstrap a local
      replica whose raft group is ``members``
    - stop_replica(partition_id): tear down the local replica
    - raft_of(partition_id) -> RaftNode | None
    - request_reconfigure(partition_id, change): deliver a reconfigure
      intent ({"add": member} or {"remove": member}) to the partition's
      current leader, which computes the new member list from its OWN
      configuration (a requester with a stale view must not be able to
      drop other replicas)
    """

    GOSSIP_PROPERTY = "topology"

    def __init__(self, member_id: str, membership,
                 start_replica: Callable[[int, list[str], int], None],
                 stop_replica: Callable[[int], None],
                 raft_of: Callable[[int], Any],
                 request_reconfigure: Callable[[int, dict], None],
                 persist: Callable[[dict], None] | None = None) -> None:
        self.member_id = member_id
        self.membership = membership
        self.start_replica = start_replica
        self.stop_replica = stop_replica
        # optional per-partition ownership guard (context-manager factory),
        # wired by the broker when ownership threads exist
        self.partition_guard = None
        self.raft_of = raft_of
        self.request_reconfigure = request_reconfigure
        self.persist = persist or (lambda doc: None)
        self.topology = ClusterTopology()
        self._dirty = True
        # local progress markers for the in-flight operation (avoid repeating
        # side effects every tick while waiting for completion)
        self._op_started: tuple[int, int] | None = None  # (change id, index)
        # partition id → membership confirmed by the leader's reconfigure reply
        self._reconfigure_confirmations: dict[int, list[str]] = {}

    # -- lifecycle -------------------------------------------------------------

    def bootstrap(self, distribution: dict[int, list[str]], members: list[str]) -> None:
        self.topology = ClusterTopology.initial(distribution, members)
        self._dirty = True

    def restore(self, doc: dict) -> None:
        """Boot from a persisted topology document (a restart must not forget
        partitions that were moved onto this member at runtime)."""
        self.topology = ClusterTopology(copy.deepcopy(doc))
        self._dirty = True

    def own_partitions(self) -> dict[int, tuple[list[str], int]]:
        """partition id → (replica member list, priority) for every partition
        this member hosts per the topology document."""
        me = self.topology.members.get(self.member_id, {})
        out = {}
        for pid_str, p in me.get("partitions", {}).items():
            pid = int(pid_str)
            out[pid] = (self.topology.partition_members(pid), p.get("priority", 1))
        return out

    def coordinator(self) -> str | None:
        """The change coordinator: the lowest active member id (reference
        designates a single coordinator; enforcing it here is what keeps
        versions totally ordered under concurrent proposals)."""
        active = [m for m, s in self.topology.members.items()
                  if s.get("state") == ACTIVE]
        return min(active) if active else None

    # -- change proposal (coordinator API) ------------------------------------

    def propose(self, operations: list[dict]) -> bool:
        """Install a change plan (reference: TopologyChangeCoordinator). One
        at a time, and only on the coordinator member — both rejections keep
        topology versions totally ordered."""
        if self.topology.change is not None:
            return False
        if self.coordinator() != self.member_id:
            return False
        topo = self.topology
        topo.doc["change"] = {
            "id": topo.version + 1,
            "index": 0,
            "operations": operations,
        }
        self._bump()
        return True

    def join_member(self, member_id: str) -> dict:
        return {"op": MEMBER_JOIN, "member": member_id}

    def leave_member(self, member_id: str) -> dict:
        return {"op": MEMBER_LEAVE, "member": member_id}

    def join_partition(self, member_id: str, partition_id: int, priority: int = 1) -> dict:
        return {"op": PARTITION_JOIN, "member": member_id,
                "partition": partition_id, "priority": priority}

    def leave_partition(self, member_id: str, partition_id: int) -> dict:
        return {"op": PARTITION_LEAVE, "member": member_id,
                "partition": partition_id}

    # -- gossip ----------------------------------------------------------------

    def _bump(self) -> None:
        self.topology.doc["version"] += 1
        self._dirty = True

    def _merge_remote(self) -> None:
        best = self.topology
        for member in self.membership.members.values():
            doc = member.properties.get(self.GOSSIP_PROPERTY)
            if doc and doc.get("version", 0) > best.version:
                best = ClusterTopology(copy.deepcopy(doc))
        if best is not self.topology:
            self.topology = best
            self._dirty = True
            self._op_started = None

    def _publish(self) -> None:
        if self._dirty:
            self.membership.set_property(self.GOSSIP_PROPERTY,
                                         copy.deepcopy(self.topology.doc))
            self.persist(self.topology.doc)
            self._dirty = False

    # -- tick ------------------------------------------------------------------

    def tick(self) -> None:
        self._merge_remote()
        self._apply_next_operation()
        self._publish()

    def _apply_next_operation(self) -> None:
        topo = self.topology
        op = topo.next_operation()
        change = topo.change
        if op is None:
            if change is not None:
                # all operations applied: the LAST op's target retires the plan
                topo.doc["change"] = None
                self._bump()
            return
        if op["member"] != self.member_id:
            return  # someone else's move
        marker = (change["id"], change["index"])
        guard = (self.partition_guard(op["partition"])
                 if self.partition_guard is not None and "partition" in op
                 else None)
        if guard is None:
            done = self._execute(op, first=self._op_started != marker)
        else:
            # partition-scoped operations mutate that partition's raft state
            # (reconfigure, replica bootstrap/teardown) — they must hold the
            # partition's ownership lock so they never race its pump thread
            with guard:
                done = self._execute(op, first=self._op_started != marker)
        self._op_started = marker
        if done:
            change["index"] += 1
            if change["index"] >= len(change["operations"]):
                topo.doc["change"] = None
            self._op_started = None
            self._bump()

    # -- operation appliers ----------------------------------------------------

    def _execute(self, op: dict, first: bool) -> bool:
        kind = op["op"]
        topo = self.topology
        me = topo.members.setdefault(self.member_id,
                                     {"state": JOINING, "partitions": {}})
        if kind == MEMBER_JOIN:
            me["state"] = ACTIVE
            return True
        if kind == MEMBER_LEAVE:
            if me.get("partitions"):
                return False  # partitions must be moved away first
            me["state"] = LEFT
            return True
        if kind == PARTITION_JOIN:
            return self._partition_join(op, me, first)
        if kind == PARTITION_LEAVE:
            return self._partition_leave(op, me, first)
        return True  # unknown op: skip rather than wedge the plan

    def _partition_join(self, op: dict, me: dict, first: bool) -> bool:
        pid = op["partition"]
        raft = self.raft_of(pid)
        if raft is None:
            # start the local replica against the current replica set + self
            members = sorted(set(self.topology.partition_members(pid))
                             | {self.member_id})
            me["partitions"][str(pid)] = {
                "state": JOINING, "priority": op.get("priority", 1),
            }
            self.start_replica(pid, members, op.get("priority", 1))
            self._dirty = True
            return False
        if raft.leader_commit_hint == 0 and raft.commit_index == 0:
            # the group's leader has not contacted us yet — our own member
            # list already contains us (we bootstrapped with it), so the only
            # reliable join signal is an append from the leader. Keep asking
            # for the reconfiguration until then (idempotent on the leader:
            # adding an existing member is a no-op).
            self.request_reconfigure(pid, {"add": self.member_id})
            return False
        # in contact: complete once caught up with the leader's commit
        if raft.commit_index < raft.leader_commit_hint:
            return False
        me["partitions"][str(pid)] = {
            "state": ACTIVE, "priority": op.get("priority", 1),
        }
        return True

    def _partition_leave(self, op: dict, me: dict, first: bool) -> bool:
        pid = op["partition"]
        raft = self.raft_of(pid)
        if raft is None:
            me.get("partitions", {}).pop(str(pid), None)
            return True
        confirmed = self._reconfigure_confirmations.get(pid)
        removed = (
            self.member_id not in raft.members
            or (confirmed is not None and self.member_id not in confirmed)
        )
        if not removed:
            if len(raft.members) == 1:
                return False  # refuse to orphan the partition
            if raft.role.name == "LEADER":
                raft.reconfigure(sorted(
                    m for m in raft.members if m != self.member_id
                ))
            else:
                # retry every tick (idempotent on the leader): the request is
                # dropped when no leader is known, and the config entry that
                # tells us we left can be lost — the leader's confirmation
                # reply (on_reconfigure_confirmed) is the durable signal
                self.request_reconfigure(pid, {"remove": self.member_id})
            if str(pid) in me.get("partitions", {}):
                me["partitions"][str(pid)]["state"] = LEAVING
                self._dirty = True
            return False
        # out of the group: stop the replica and drop the entry
        self.stop_replica(pid)
        self._reconfigure_confirmations.pop(pid, None)
        me.get("partitions", {}).pop(str(pid), None)
        return True

    def on_reconfigure_confirmed(self, partition_id: int, members: list[str]) -> None:
        """The partition leader's reply to a reconfigure request: the
        authoritative membership after the change (lets a removed replica
        complete PARTITION_LEAVE even if it never received the config entry)."""
        self._reconfigure_confirmations[partition_id] = list(members)
