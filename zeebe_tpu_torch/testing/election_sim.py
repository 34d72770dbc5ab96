"""How long a 3-member Raft group goes without a leader after its leader is
cut off, on a controlled clock (10 ms ticks) over the loopback network.

    python -m zeebe_tpu_torch.testing.election_sim

Prints one JSON line per scenario: over ``SEEDS`` seeds, the milliseconds
from cutting the leader off to a new leader among the other two members
(median, 90th percentile, the most, and how many seeds took over 3,000
ms). The scenarios are the ones a loaded cluster meets: equal logs, one
follower an entry behind (the leader's last append reached only the
other), and each of those with every message delivered 200 ms late. Run
it on a copy of the tree with another ``cluster/raft.py`` to compare
election rules.
"""

from __future__ import annotations

import json
import random
import tempfile
from pathlib import Path

SEEDS = 200
#: (one follower an entry behind, ms between deliveries)
SCENARIOS = ((False, 10), (True, 10), (False, 200), (True, 200))


def failover_ms(directory: Path, seed: int, behind: bool = False,
                delivery_ms: int = 10) -> int:
    """Milliseconds from isolating an elected leader to a new leader among
    the other two. With ``behind`` one follower misses the leader's last
    entry; messages are delivered every ``delivery_ms``."""
    from zeebe_tpu_torch.cluster import LoopbackNetwork, RaftNode, RaftRole
    from zeebe_tpu_torch.cluster.raft import ELECTION_TIMEOUT_MS
    from zeebe_tpu_torch.testing import ControlledClock

    clock, net = ControlledClock(), LoopbackNetwork()
    members = ["node-0", "node-1", "node-2"]
    nodes = [RaftNode(net.join(m), partition_id=1, members=members,
                      directory=directory / f"{seed}-{behind}-{delivery_ms}" / m,
                      clock_millis=clock, seed=i) for i, m in enumerate(members)]
    try:
        for i, node in enumerate(nodes):
            node._rng = random.Random(1000 * seed + i)

        def run(millis: int) -> None:
            for _ in range(millis // 50):
                clock.advance(50)
                for node in nodes:
                    node.tick()
                net.deliver_all()

        run(4 * ELECTION_TIMEOUT_MS)
        leaders = [n for n in nodes if n.role == RaftRole.LEADER]
        assert len(leaders) == 1, "no leader elected"
        leader = leaders[0]
        run(1000)
        others = [n for n in nodes if n is not leader]
        if behind:
            net.partition(leader.member_id, others[seed % 2].member_id)
            leader.append(b"entry")
            leader.tick()
            net.deliver_all()
            net.heal()
        net.isolate(leader.member_id)
        for waited in range(10, 20_000, 10):
            clock.advance(10)
            for node in others:
                node.tick()
            if waited % delivery_ms == 0:
                net.deliver_all()
            if any(n.role == RaftRole.LEADER for n in others):
                return waited
        raise AssertionError("no new leader in 20 s")
    finally:
        for node in nodes:
            node.close()


def main() -> int:
    with tempfile.TemporaryDirectory(prefix="election-sim-") as tmp:
        for behind, delivery_ms in SCENARIOS:
            waits = sorted(failover_ms(Path(tmp), seed, behind, delivery_ms)
                           for seed in range(SEEDS))
            print(json.dumps({
                "followerBehind": behind, "deliveryMs": delivery_ms, "seeds": SEEDS,
                "medianMs": waits[len(waits) // 2], "p90Ms": waits[len(waits) * 9 // 10],
                "maxMs": waits[-1], "over3000": sum(w > 3000 for w in waits)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
