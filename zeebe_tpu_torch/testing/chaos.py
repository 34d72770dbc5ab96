"""Deterministic chaos harness: seeded fault plans over the loopback cluster.

In the spirit of FoundationDB-style deterministic simulation testing and
Jepsen-style invariant checking: every fault decision (drop, duplicate,
reorder, delay, partition, crash-restart) is drawn from a single seeded RNG
over a deterministic cluster (ControlledClock + per-member deterministic raft
jitter), so a failing run is replayable bit-for-bit from its seed alone.

Pieces:

- ``FaultPlan``     — the seed + per-link fault probabilities + a scheduled
                      event list (partitions, isolations, heals, crashes,
                      restarts at fixed ticks).
- ``ChaosNetwork``  — a ``LoopbackNetwork`` whose enqueue path applies the
                      plan's faults and records every decision in ``trace``
                      (two runs with the same plan produce identical traces).
- ``ChaosHarness``  — drives an ``InProcessCluster`` over a ChaosNetwork tick
                      by tick, executes the plan's scheduled events, samples
                      exporter/commit positions each tick, and checks the
                      chaos invariants at the end.
- ``replay_state_of`` — rebuilds engine state from a partition's journal in a
                      fresh db (replay ≡ processing oracle).

The active seed is published module-globally so the test conftest can print it
on failure (reproduce with ``FaultPlan(seed=<printed seed>)``).

The port's harness takes the kernel backend's ``device`` (None = CUDA,
raising without it; ``"cpu"`` runs the plain version) and gives it to its
cluster; the rest is the reference's, copied.
"""

from __future__ import annotations

import dataclasses
import random
from pathlib import Path
from typing import Any, Callable

from zeebe_tpu_torch.cluster.messaging import LoopbackNetwork

# copied from the reference: _ACTIVE_SEED .. engine_state_equals
_ACTIVE_SEED: int | None = None


def active_fault_seed() -> int | None:
    """Seed of the most recently constructed ChaosNetwork (conftest prints it
    when a chaos test fails, for reproduction)."""
    return _ACTIVE_SEED


@dataclasses.dataclass
class FaultPlan:
    """Seeded fault schedule. Probabilities apply per enqueued message; the
    event list maps a harness tick to a cluster-level fault action:
    ``("partition", a, b)``, ``("isolate", m)``, ``("heal",)``,
    ``("heal", m)``, ``("crash", m)``, ``("restart", m)``."""

    seed: int = 0
    drop_p: float = 0.0
    duplicate_p: float = 0.0
    reorder_p: float = 0.0
    delay_p: float = 0.0
    max_delay_ticks: int = 3
    # event kinds: ("partition", a, b), ("isolate", m), ("heal",) /
    # ("heal", m), ("crash", m) (clean close), ("hard-crash", m) (power
    # loss at the flush boundary: unflushed journal bytes are lost),
    # ("restart", m)
    events: dict[int, list[tuple]] = dataclasses.field(default_factory=dict)

    def at(self, tick: int, *event: Any) -> "FaultPlan":
        """Fluent event registration: ``plan.at(40, "crash", "broker-1")``."""
        self.events.setdefault(tick, []).append(tuple(event))
        return self


class ChaosNetwork(LoopbackNetwork):
    """LoopbackNetwork with seeded per-message fault injection.

    Fault decisions happen at *enqueue* time — message send order is
    deterministic under the controlled clock, so one RNG stream reproduces
    the exact same drop/duplicate/reorder/delay schedule for a given seed.
    Delayed messages are re-injected by ``advance_tick`` (driven once per
    harness tick)."""

    def __init__(self, plan: FaultPlan, lanes: int = 0) -> None:
        super().__init__(lanes=lanes)
        global _ACTIVE_SEED
        _ACTIVE_SEED = plan.seed
        self.plan = plan
        self.rng = random.Random(plan.seed)
        self.trace: list[str] = []
        self.delivered_log: list[tuple[str, str, str]] = []
        self.chaos_dropped = 0
        self.chaos_duplicated = 0
        self.chaos_reordered = 0
        self.chaos_delayed = 0
        self._tick = 0
        self._msg_seq = 0
        self._held: list[tuple[int, tuple[str, str, str, Any]]] = []

    # -- fault application -----------------------------------------------------

    def enqueue(self, sender: str, target: str, topic: str, payload: Any) -> None:
        plan = self.plan
        i = self._msg_seq
        self._msg_seq += 1
        r = self.rng.random()
        if r < plan.drop_p:
            self.chaos_dropped += 1
            self.trace.append(f"drop#{i} {sender}->{target} {topic}")
            return
        r -= plan.drop_p
        if r < plan.duplicate_p:
            self.chaos_duplicated += 1
            self.trace.append(f"dup#{i} {sender}->{target} {topic}")
            super().enqueue(sender, target, topic, payload)
            super().enqueue(sender, target, topic, payload)
            return
        r -= plan.duplicate_p
        if r < plan.delay_p:
            ticks = 1 + self.rng.randrange(max(plan.max_delay_ticks, 1))
            self.chaos_delayed += 1
            self.trace.append(f"delay#{i}+{ticks} {sender}->{target} {topic}")
            self._held.append((self._tick + ticks, (sender, target, topic, payload)))
            return
        r -= plan.delay_p
        if r < plan.reorder_p:
            q = self._queues[self.lane_of(topic)]
            pos = self.rng.randrange(len(q) + 1)
            self.chaos_reordered += 1
            self.trace.append(f"reorder#{i}@{pos} {sender}->{target} {topic}")
            q.insert(pos, (sender, target, topic, payload))
            return
        super().enqueue(sender, target, topic, payload)

    def advance_tick(self) -> None:
        """Release held (delayed) messages whose tick arrived. Re-injection
        goes through the base enqueue — a delayed message is not re-faulted,
        matching one decision per message."""
        self._tick += 1
        due = [m for t, m in self._held if t <= self._tick]
        self._held = [(t, m) for t, m in self._held if t > self._tick]
        for sender, target, topic, payload in due:
            super().enqueue(sender, target, topic, payload)

    def deliver_one(self, lane: int = 0) -> bool:
        q = self._queues[lane]
        if q:
            sender, target, topic, _ = q[0]
            self.delivered_log.append((sender, target, topic))
        return super().deliver_one(lane)


def replay_state_of(partition, partition_count: int | None = None):
    """Rebuild engine state by replaying a partition's committed journal into
    a fresh db (the replay ≡ processing oracle: the result must equal the
    partition's live db, reference: ReplayStateMachine / ClusteringRule's
    follower-state assertions).

    Recovery starts from the partition's latest snapshot when one exists —
    a replica that ever received a raft install-snapshot has a truncated
    stream journal, so position 1 is not necessarily on disk (exactly the
    recovery path a real restart takes)."""
    from zeebe_tpu_torch.engine.engine import Engine
    from zeebe_tpu_torch.state import ZbDb
    from zeebe_tpu_torch.stream import StreamProcessor, StreamProcessorMode

    from zeebe_tpu_torch.state.snapshot import STATE_FILE, load_chain_db

    chain = partition.snapshot_store.latest_valid_chain()
    if chain is not None and chain[0].has_file(STATE_FILE):
        db = load_chain_db(chain)
    else:
        db = ZbDb(consistency_checks=False)
    # migrations run between recovery and replay, exactly like _transition
    from zeebe_tpu_torch.engine.migration import DbMigrator

    DbMigrator(db).run_migrations()
    engine = Engine(db, partition.partition_id,
                    clock_millis=partition.clock_millis,
                    partition_count=partition_count or partition.partition_count)
    processor = StreamProcessor(
        partition.stream, db, engine, mode=StreamProcessorMode.REPLAY,
        clock_millis=partition.clock_millis,
    )
    processor.start()
    processor.replay_available()
    return db


def engine_state_equals(a, b) -> bool:
    """Replay ≡ processing oracle comparison: all engine state EXCEPT the
    EXPORTER column family — exporter acks are runtime-local side effects of
    the export loop (each replica/restart re-acks at its own pace), not
    event-sourced state, so replay legitimately cannot reproduce them."""
    import struct

    from zeebe_tpu_torch.state.db import ColumnFamilyCode

    prefix = struct.pack(">H", int(ColumnFamilyCode.EXPORTER))
    # tiered stores hold ColdRef stubs in _data: resolve to the logical
    # value so a partially-spilled partition compares byte-identically
    ra = getattr(a, "_resolve", lambda v: v)
    rb = getattr(b, "_resolve", lambda v: v)
    fa = {k: ra(v) for k, v in a._data.items() if not k.startswith(prefix)}
    fb = {k: rb(v) for k, v in b._data.items() if not k.startswith(prefix)}
    return fa == fb
# end of the copy


class ChaosHarness:
    """Drives an InProcessCluster tick-by-tick under a FaultPlan, executing
    scheduled faults and sampling the per-tick invariant observables
    (exporter positions vs commit positions)."""

    def __init__(self, plan: FaultPlan, broker_count: int = 3,
                 partition_count: int = 1, replication_factor: int = 3,
                 directory: str | Path | None = None,
                 exporters_factory: Callable[[], dict[str, Any]] | None = None,
                 step_ms: int = 50,
                 snapshot_period_ms: int = 5 * 60 * 1000,
                 recovery_budget_ms: int = 60_000,
                 snapshot_chain_length: int = 8,
                 tiering: bool = False,
                 tiering_park_after_ms: int = 30_000,
                 tiering_spill_batch: int = 256, device=None) -> None:
        from zeebe_tpu_torch.broker import InProcessCluster

        self.plan = plan
        self.net = ChaosNetwork(plan)
        self.cluster = InProcessCluster(
            broker_count=broker_count, partition_count=partition_count,
            replication_factor=replication_factor, directory=directory,
            exporters_factory=exporters_factory, network=self.net,
            snapshot_period_ms=snapshot_period_ms,
            recovery_budget_ms=recovery_budget_ms,
            snapshot_chain_length=snapshot_chain_length,
            tiering=tiering,
            tiering_park_after_ms=tiering_park_after_ms,
            tiering_spill_batch=tiering_spill_batch,
            device=device,
        )
        self.step_ms = step_ms
        self.tick = 0
        self.violations: list[str] = []
        # (node, partition, exporter_id) -> (container identity, last sampled
        # acked position) — identity scopes monotonicity to one director life
        self._exporter_watermarks: dict[tuple[str, int, str], tuple] = {}

    # copied from the reference: close .. assert_no_violations
    def close(self) -> None:
        # the active seed intentionally survives close(): the conftest
        # failure hook reads it AFTER the test's finally-block teardown, and
        # only chaos-marked tests report it
        self.cluster.close()

    # -- scheduled fault execution --------------------------------------------

    def _execute(self, event: tuple) -> None:
        kind, *args = event
        if kind == "partition":
            self.net.partition(args[0], args[1])
        elif kind == "isolate":
            self.net.isolate(args[0])
        elif kind == "heal":
            self.net.heal(*args)
        elif kind == "crash":
            self.cluster.stop_broker(args[0])
            self.clear_exporter_watermarks(args[0])
        elif kind == "hard-crash":
            # power loss at the flush boundary: journals keep only the
            # fsync-covered prefix (buffered group-commit appends are lost)
            self.cluster.hard_crash_broker(args[0])
            self.clear_exporter_watermarks(args[0])
        elif kind == "restart":
            self.cluster.restart_broker(args[0])
            self.clear_exporter_watermarks(args[0])
        else:
            raise ValueError(f"unknown chaos event {event!r}")

    def clear_exporter_watermarks(self, node_id: str) -> None:
        """A crash-restart recovers exporter positions from the last snapshot
        (at-least-once re-export) — the monotonicity invariant holds within a
        broker lifetime, so the node's watermarks reset across restarts."""
        for key in [k for k in self._exporter_watermarks if k[0] == node_id]:
            del self._exporter_watermarks[key]

    # -- tick loop -------------------------------------------------------------

    def run_ticks(self, ticks: int) -> None:
        """Advance the cluster ``ticks`` steps of ``step_ms`` each, executing
        scheduled events, releasing delayed traffic, and sampling exporter
        invariants after every step."""
        for _ in range(ticks):
            self.tick += 1
            for event in self.plan.events.get(self.tick, ()):  # faults first
                self._execute(event)
            self.net.advance_tick()
            self.cluster.run(self.step_ms)
            self._sample_exporters()

    def run_plan(self, extra_ticks: int = 0) -> None:
        """Run through every scheduled event, then ``extra_ticks`` more."""
        horizon = max(self.plan.events, default=0) + extra_ticks
        self.run_ticks(horizon)

    def quiesce(self, ticks: int = 40) -> None:
        """Heal-all then run until the cluster settles (single leader per
        partition, queues drained)."""
        self.net.heal()
        self.run_ticks(ticks)

    # -- invariants ------------------------------------------------------------

    def _sample_exporters(self) -> None:
        for node, broker in list(self.cluster.brokers.items()):
            for pid, part in broker.partitions.items():
                director = part.exporter_director
                if director is None:
                    continue
                # the materialized stream journal IS the committed prefix
                # (entries land there only on raft commit — see
                # broker/partition.py), so last_position is the commit
                # position the exporters must never pass
                commit = part.stream.last_position
                for container in director.containers:
                    key = (node, pid, container.exporter_id)
                    # monotonicity holds per container lifetime: a role
                    # transition rebuilds the director over a re-recovered db
                    # (positions fall back to the snapshot — at-least-once),
                    # so a new container starts a new watermark. The container
                    # OBJECT is the identity (an id() could be recycled by a
                    # successor at the same address)
                    prev_cont, prev = self._exporter_watermarks.get(key, (None, 0))
                    pos = container.position
                    if prev_cont is container and pos < prev:
                        self.violations.append(
                            f"tick {self.tick}: exporter {key} position "
                            f"regressed {prev} -> {pos}")
                    # only an ADVANCE past commit is a violation: right
                    # after a crash-restart the cursor RECOVERED from state
                    # legitimately sits ahead of a stream journal that has
                    # not re-materialized yet (exports can only come from
                    # stream reads, so a recovered cursor can never advance
                    # until the stream passes it again). The advance baseline
                    # is the previous sample for an observed container, or
                    # the position recovered at open for a FIRST observation
                    # — without the latter, an export past commit inside the
                    # container's first tick would go unflagged
                    baseline = (prev if prev_cont is container
                                else container.recovered_position)
                    if pos > baseline and pos > commit:
                        self.violations.append(
                            f"tick {self.tick}: exporter {key} position {pos} "
                            f"advanced ahead of commit {commit}")
                    self._exporter_watermarks[key] = (container, pos)

    def check_exactly_once_materialization(self, partition_id: int = 1) -> None:
        """Committed records materialize exactly once: strictly increasing
        positions, no duplicates, no gaps inside a batch run."""
        leader = self.cluster.leader(partition_id)
        assert leader is not None, "no leader to check"
        last = 0
        for logged in leader.stream.new_reader(1):
            if logged.position <= last:
                self.violations.append(
                    f"position {logged.position} not increasing after {last}")
            last = logged.position

    def check_replay_equivalence(self, partition_id: int = 1) -> None:
        leader = self.cluster.leader(partition_id)
        assert leader is not None, "no leader to check"
        replayed = replay_state_of(leader)
        if not engine_state_equals(replayed, leader.db):
            self.violations.append(
                f"replayed state of partition {partition_id} diverges from "
                f"the leader's live state")

    def assert_no_violations(self) -> None:
        assert not self.violations, (
            f"chaos invariants violated (seed {self.plan.seed}):\n  "
            + "\n  ".join(self.violations[:20]))
    # end of the copy
