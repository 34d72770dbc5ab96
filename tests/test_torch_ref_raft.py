# tests/test_raft.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Raft + membership tests over the deterministic loopback network, mirroring
the reference's local-transport raft tests (atomix/cluster/src/test — election,
replication, failover, log conflict resolution, snapshot install)."""

from __future__ import annotations

import pytest

from zeebe_tpu_torch.cluster import LoopbackNetwork, MembershipService, MemberState, RaftNode, RaftRole
from zeebe_tpu_torch.cluster.raft import ELECTION_TIMEOUT_MS, HEARTBEAT_INTERVAL_MS
from zeebe_tpu_torch.testing import ControlledClock


class Cluster:
    """Three RaftNodes on a loopback network with one controlled clock."""

    def __init__(self, tmp_path, n=3, priorities=None):
        self.clock = ControlledClock()
        self.net = LoopbackNetwork()
        members = [f"node-{i}" for i in range(n)]
        self.nodes: dict[str, RaftNode] = {}
        for i, m in enumerate(members):
            node = RaftNode(
                self.net.join(m), partition_id=1, members=members,
                directory=tmp_path / m, clock_millis=self.clock,
                priority=(priorities or {}).get(m, 1), seed=i,
            )
            self.nodes[m] = node

    def run(self, millis: int, step: int = 50) -> None:
        """Advance time, ticking every node and delivering messages."""
        for _ in range(millis // step):
            self.clock.advance(step)
            for node in self.nodes.values():
                node.tick()
            self.net.deliver_all()

    def leader(self) -> RaftNode | None:
        leaders = [n for n in self.nodes.values() if n.role == RaftRole.LEADER]
        return leaders[0] if len(leaders) == 1 else None

    def elect(self) -> RaftNode:
        self.run(4 * ELECTION_TIMEOUT_MS)
        leader = self.leader()
        assert leader is not None, "no leader elected"
        return leader

    def close(self):
        for n in self.nodes.values():
            n.close()


@pytest.fixture()
def cluster(tmp_path):
    c = Cluster(tmp_path)
    yield c
    c.close()


class TestElection:
    def test_single_leader_elected(self, cluster):
        leader = cluster.elect()
        followers = [n for n in cluster.nodes.values() if n is not leader]
        assert all(f.role == RaftRole.FOLLOWER for f in followers)
        assert all(f.leader_id == leader.member_id for f in followers)
        assert all(f.current_term == leader.current_term for f in followers)

    def test_priority_member_wins(self, tmp_path):
        c = Cluster(tmp_path / "prio", priorities={"node-2": 10})
        try:
            leader = c.elect()
            assert leader.member_id == "node-2"
        finally:
            c.close()

    def test_reelection_after_leader_isolated(self, cluster):
        leader = cluster.elect()
        old_term = leader.current_term
        cluster.net.isolate(leader.member_id)
        cluster.run(6 * ELECTION_TIMEOUT_MS)
        others = [n for n in cluster.nodes.values() if n is not leader]
        new_leaders = [n for n in others if n.role == RaftRole.LEADER]
        assert len(new_leaders) == 1
        assert new_leaders[0].current_term > old_term
        # healed old leader steps down to follower on higher term
        cluster.net.heal()
        cluster.run(4 * HEARTBEAT_INTERVAL_MS)
        assert leader.role == RaftRole.FOLLOWER

    def test_no_election_without_quorum(self, tmp_path):
        c = Cluster(tmp_path / "noq")
        try:
            leader = c.elect()
            for m in c.nodes:
                c.net.isolate(m)
            term_before = max(n.current_term for n in c.nodes.values())
            c.run(6 * ELECTION_TIMEOUT_MS)
            assert c.leader() is None or c.leader().current_term == term_before
            assert all(n.role != RaftRole.LEADER or n is leader
                       for n in c.nodes.values()) or True
            # nobody can win: no quorum reachable
            assert not any(
                n.role == RaftRole.LEADER and n.current_term > term_before
                for n in c.nodes.values()
            )
        finally:
            c.close()


class TestReplication:
    def test_append_replicates_and_commits(self, cluster):
        leader = cluster.elect()
        committed = []
        index = leader.append(b"batch-1", asqn=1, on_commit=committed.append)
        assert index is not None
        cluster.run(2 * HEARTBEAT_INTERVAL_MS)
        assert committed == [index]
        for node in cluster.nodes.values():
            assert node.commit_index >= index
            entry = [e for e in node.committed_entries(1) if not e.get("init")]
            assert entry[-1]["data"] == b"batch-1"
            assert entry[-1]["asqn"] == 1

    def test_follower_catches_up_after_partition(self, cluster):
        leader = cluster.elect()
        follower = next(n for n in cluster.nodes.values() if n is not leader)
        cluster.net.isolate(follower.member_id)
        for i in range(5):
            leader.append(f"entry-{i}".encode(), asqn=i + 1)
        cluster.run(4 * HEARTBEAT_INTERVAL_MS)
        assert follower.commit_index < leader.commit_index
        cluster.net.heal()
        cluster.run(6 * HEARTBEAT_INTERVAL_MS)
        assert follower.commit_index == leader.commit_index
        data = [e["data"] for e in follower.committed_entries(1) if not e.get("init")]
        assert data == [f"entry-{i}".encode() for i in range(5)]

    def test_uncommitted_entries_of_deposed_leader_are_discarded(self, cluster):
        leader = cluster.elect()
        cluster.net.isolate(leader.member_id)
        # these can never commit (no quorum)
        leader.append(b"lost-1", asqn=100)
        leader.append(b"lost-2", asqn=101)
        cluster.run(6 * ELECTION_TIMEOUT_MS)
        new_leader = next(
            n for n in cluster.nodes.values()
            if n is not leader and n.role == RaftRole.LEADER
        )
        new_leader.append(b"won", asqn=1)
        cluster.run(4 * HEARTBEAT_INTERVAL_MS)
        cluster.net.heal()
        cluster.run(8 * HEARTBEAT_INTERVAL_MS)
        data = [e["data"] for e in leader.committed_entries(1) if not e.get("init")]
        assert b"lost-1" not in data and b"lost-2" not in data
        assert b"won" in data

    def test_leader_failover_preserves_committed_entries(self, cluster):
        leader = cluster.elect()
        done = []
        leader.append(b"durable", asqn=1, on_commit=lambda i: done.append(i))
        cluster.run(2 * HEARTBEAT_INTERVAL_MS)
        assert done
        cluster.net.isolate(leader.member_id)
        cluster.run(6 * ELECTION_TIMEOUT_MS)
        new_leader = next(
            n for n in cluster.nodes.values()
            if n is not leader and n.role == RaftRole.LEADER
        )
        data = [e["data"] for e in new_leader.committed_entries(1) if not e.get("init")]
        assert b"durable" in data


class TestSnapshotInstall:
    def test_lagging_follower_receives_snapshot(self, cluster):
        leader = cluster.elect()
        follower = next(n for n in cluster.nodes.values() if n is not leader)
        cluster.net.isolate(follower.member_id)
        for i in range(10):
            leader.append(f"e{i}".encode(), asqn=i + 1)
        cluster.run(4 * HEARTBEAT_INTERVAL_MS)
        # leader snapshots and compacts past the follower's position
        leader.set_snapshot(leader.commit_index, leader.current_term, b"state-at-10")
        received = []
        follower.snapshot_receiver = received.append
        cluster.net.heal()
        cluster.run(10 * HEARTBEAT_INTERVAL_MS)
        assert received == [b"state-at-10"]
        assert follower.snapshot_index == leader.snapshot_index
        # follower keeps replicating after the snapshot
        leader.append(b"after-snap", asqn=11)
        cluster.run(4 * HEARTBEAT_INTERVAL_MS)
        data = [e["data"] for e in follower.committed_entries(follower.snapshot_index + 1)
                if not e.get("init")]
        assert b"after-snap" in data


class TestRestartPersistence:
    def test_term_and_log_survive_restart(self, tmp_path, cluster):
        leader = cluster.elect()
        leader.append(b"persisted", asqn=1)
        cluster.run(2 * HEARTBEAT_INTERVAL_MS)
        term = leader.current_term
        member = leader.member_id
        directory = leader.directory
        leader.close()
        # reopen from disk on a fresh network handle
        net2 = LoopbackNetwork()
        node2 = RaftNode(net2.join(member), partition_id=1,
                         members=list(cluster.nodes), directory=directory,
                         clock_millis=cluster.clock)
        try:
            assert node2.current_term == term
            data = [e["data"] for e in node2._read_entries(1, 100) if not e.get("init")]
            assert b"persisted" in data
        finally:
            node2.close()
        cluster.nodes.pop(member)


class TestMembership:
    def test_members_see_each_other_alive(self):
        clock = ControlledClock()
        net = LoopbackNetwork()
        members = [f"m{i}" for i in range(3)]
        services = [MembershipService(net.join(m), members, clock) for m in members]
        for _ in range(10):
            clock.advance(1_000)
            for s in services:
                s.tick()
            net.deliver_all()
        for s in services:
            assert all(m.state == MemberState.ALIVE for m in s.members.values()), s.member_id

    def test_silent_member_becomes_suspect_then_dead(self):
        clock = ControlledClock()
        net = LoopbackNetwork()
        members = ["m0", "m1", "m2"]
        services = {m: MembershipService(net.join(m), members, clock) for m in members}
        net.isolate("m2")
        for _ in range(15):
            clock.advance(1_000)
            for s in services.values():
                s.tick()
            net.deliver_all()
        assert services["m0"].get("m2").state == MemberState.DEAD
        # healed member is marked alive again on first contact
        net.heal()
        for _ in range(5):
            clock.advance(1_000)
            for s in services.values():
                s.tick()
            net.deliver_all()
        assert services["m0"].get("m2").state == MemberState.ALIVE

    def test_properties_gossip(self):
        clock = ControlledClock()
        net = LoopbackNetwork()
        members = ["m0", "m1"]
        services = {m: MembershipService(net.join(m), members, clock) for m in members}
        services["m0"].set_property("partitions", {"1": "leader"})
        for _ in range(5):
            clock.advance(1_000)
            for s in services.values():
                s.tick()
            net.deliver_all()
        assert services["m1"].get("m0").properties == {"partitions": {"1": "leader"}}


class TestTcpMessaging:
    def test_roundtrip_over_tcp(self):
        import socket
        import time

        from zeebe_tpu_torch.cluster import TcpMessagingService

        def free_port():
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            s.close()
            return port

        pa, pb = free_port(), free_port()
        a = TcpMessagingService("a", ("127.0.0.1", pa), {"b": ("127.0.0.1", pb)})
        b = TcpMessagingService("b", ("127.0.0.1", pb), {"a": ("127.0.0.1", pa)})
        got = []
        b.subscribe("echo", lambda sender, payload: got.append((sender, payload)))
        a.start()
        b.start()
        try:
            a.send("b", "echo", {"x": 1, "blob": b"\x00\xff"})
            deadline = time.time() + 5
            while not got and time.time() < deadline:
                b.poll()  # handlers run on the application thread
                time.sleep(0.01)
            assert got == [("a", {"x": 1, "blob": b"\x00\xff"})]
        finally:
            a.stop()
            b.stop()


class TestFlushPolicy:
    def test_appends_flushed_before_ack(self, cluster):
        """Immediate flush policy (default): every node fsyncs its journal
        before acknowledging appended entries, so a post-ack crash never rolls
        back acked entries (reference: journal flush-before-ack, SURVEY §2.2)."""
        leader = cluster.elect()
        flushes: dict[str, int] = {m: 0 for m in cluster.nodes}
        for m, node in cluster.nodes.items():
            orig = node.journal.flush

            def counted(orig=orig, m=m):
                flushes[m] += 1
                orig()
            node.journal.flush = counted
        for i in range(5):
            leader.append(b"entry-%d" % i, asqn=i + 1)
        cluster.run(2 * HEARTBEAT_INTERVAL_MS)
        for m, node in cluster.nodes.items():
            assert node.flush_policy == "immediate"
            assert node._flushed_index == node.journal.last_index, m
            assert flushes[m] > 0, m

    def test_meta_write_is_atomic(self, tmp_path, cluster):
        leader = cluster.elect()
        # no temp files left behind, and meta parses
        for m, node in cluster.nodes.items():
            assert not node._meta_path.with_suffix(".json.tmp").exists()
            import json
            meta = json.loads(node._meta_path.read_text())
            assert meta["term"] == node.current_term

    def test_delayed_policy_flushes_on_tick(self, tmp_path):
        from zeebe_tpu_torch.cluster import LoopbackNetwork, RaftNode
        from zeebe_tpu_torch.testing import ControlledClock

        clock = ControlledClock()
        net = LoopbackNetwork()
        node = RaftNode(net.join("solo"), partition_id=1, members=["solo"],
                        directory=tmp_path / "solo", clock_millis=clock,
                        seed=0, flush_policy="delayed")
        clock.advance(3 * ELECTION_TIMEOUT_MS)
        node.tick(); net.deliver_all(); node.tick()
        assert node.role == RaftRole.LEADER
        node.append(b"x", asqn=1)
        assert node._flush_dirty
        node.tick()
        assert not node._flush_dirty
        assert node._flushed_index == node.journal.last_index
        node.close()


class TestLeadershipTransfer:
    """Raft leadership-transfer extension (reference: RaftContext
    transferLeadership behind the actuator RebalancingEndpoint)."""

    def test_transfer_moves_leadership(self, cluster):
        leader = cluster.elect()
        target = next(m for m in cluster.nodes if m != leader.member_id)
        assert leader.transfer_leadership(target)
        cluster.run(4 * ELECTION_TIMEOUT_MS)
        new_leader = cluster.leader()
        assert new_leader is not None
        assert new_leader.member_id == target
        assert leader.role == RaftRole.FOLLOWER

    def test_transfer_rejected_off_leader(self, cluster):
        leader = cluster.elect()
        follower = next(n for n in cluster.nodes.values() if n is not leader)
        assert not follower.transfer_leadership(leader.member_id)
        # self-transfer and unknown members are rejected too
        assert not leader.transfer_leadership(leader.member_id)
        assert not leader.transfer_leadership("node-99")

    def test_transfer_preserves_committed_log(self, cluster):
        leader = cluster.elect()
        for i in range(5):
            leader.append(f"entry-{i}".encode(), asqn=i + 1)
        cluster.run(10 * HEARTBEAT_INTERVAL_MS)
        committed_before = leader.commit_index
        target = next(m for m in cluster.nodes if m != leader.member_id)
        assert leader.transfer_leadership(target)
        cluster.run(4 * ELECTION_TIMEOUT_MS)
        new_leader = cluster.leader()
        assert new_leader.member_id == target
        assert new_leader.commit_index >= committed_before
        data = [e["data"] for e in new_leader.committed_entries(1)
                if e.get("data") and not e.get("init")]
        assert [f"entry-{i}".encode() for i in range(5)] == data[:5]
