"""Raft consensus, one instance per partition, over the segmented journal.

Reference: atomix/cluster/src/main/java/io/atomix/raft/ — RaftContext.java:105,
roles/{LeaderRole.java:593-707, FollowerRole, CandidateRole, PassiveRole},
LeaderAppender.java (replication loop), pre-vote + priority election
(RaftElectionConfig), snapshot replication to lagging followers (PassiveRole +
FileBasedReceivedSnapshot), and the Zeebe write ingress
LeaderRole.appendEntry(lowestPos, highestPos, data, listener) (:655-685).

TPU-native re-design: no actor threads — a RaftNode is a deterministic state
machine advanced by ``tick(now)`` and delivered messages, identical under the
loopback test network and the TCP backend. Entries carry opaque ``bytes`` (the
log-stream batch payloads) plus an ``asqn`` (application sequence number =
stream position of the batch's first record), so the log stream can seek after
recovery exactly like the reference (journal asqn-seek, SURVEY §2.3).

Persistent per-node state: the journal itself plus a small meta file
(currentTerm, votedFor) — the reference's MetaStore.
"""

from __future__ import annotations

import enum
import json
import os
import random
from pathlib import Path
from time import perf_counter as _perf_counter
from typing import Any, Callable

from zeebe_tpu_torch.cluster.messaging import MessagingService
from zeebe_tpu_torch.journal import SegmentedJournal
from zeebe_tpu_torch.journal.journal import CorruptedJournalError
from zeebe_tpu_torch.protocol.msgpack import packb, unpackb

# copied from the reference: HEARTBEAT_INTERVAL_MS .. RaftRole
HEARTBEAT_INTERVAL_MS = 250
ELECTION_TIMEOUT_MS = 2_500
MAX_ENTRIES_PER_APPEND = 64
SNAPSHOT_CHUNK_BYTES = 512 * 1024
# last-resort window for corruption-repaired nodes: a node whose
# log was truncated below its own commit index abstains from elections —
# but if NO leader has been heard for this long, every replica may be in
# that state (rot hit a quorum) and abstention would wedge the cluster
# forever. Past the window the node re-enters elections under the standard
# longest-log-wins rule; what rot destroyed on every replica is gone either
# way (the documented caveat), and a healthy leader's heartbeats make the
# window unreachable in normal operation.
LAST_RESORT_ELECTION_MS = 10 * ELECTION_TIMEOUT_MS


class RaftRole(enum.Enum):
    INACTIVE = "inactive"
    FOLLOWER = "follower"
    CANDIDATE = "candidate"
    LEADER = "leader"
# end of the copy


class RaftNode:
    """One member of one partition's replication group."""

    def __init__(
        self,
        messaging: MessagingService,
        partition_id: int,
        members: list[str],
        directory: str | Path,
        clock_millis: Callable[[], int],
        priority: int = 1,
        seed: int | None = None,
        flush_policy: str = "immediate",
        flush_interval_s: float = 0.0,
        max_unflushed_bytes: int = 1 << 20,
    ) -> None:
        self.messaging = messaging
        self.member_id = messaging.member_id
        self.partition_id = partition_id
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        pid = str(partition_id)
        self._m_elections = REGISTRY.counter(
            "raft_elections_total", "elections started", ("partition",)
        ).labels(pid)
        self._m_election_latency = REGISTRY.histogram(
            "election_latency_in_ms", "candidate -> leader in ms",
            ("partition",), buckets=(1, 5, 10, 50, 100, 500, 1000, 5000),
        ).labels(pid)
        self._m_leader_transition = REGISTRY.histogram(
            "leader_transition_latency",
            "leader election to first commit, seconds", ("partition",)
        ).labels(pid)
        self._m_role = REGISTRY.gauge(
            "role", "raft role (3=leader 2=candidate 1=follower)", ("partition",)
        ).labels(pid)
        self._m_heartbeat_miss = REGISTRY.counter(
            "heartbeat_miss_count", "election timeouts from missed heartbeats",
            ("partition",)).labels(pid)
        self._m_heartbeat_time = REGISTRY.gauge(
            "heartbeat_time_in_s", "last heartbeat seen, epoch seconds",
            ("partition",)).labels(pid)
        self._m_msg_send = REGISTRY.counter(
            "raft_messages_send", "raft rpcs sent", ("partition", "type"))
        self._m_msg_recv = REGISTRY.counter(
            "raft_messages_received", "raft rpcs received", ("partition", "type"))
        self._m_append_index = REGISTRY.gauge(
            "partition_raft_append_index", "last raft log index", ("partition",)
        ).labels(pid)
        self._m_commit_index = REGISTRY.gauge(
            "partition_raft_commit_index", "raft commit index", ("partition",)
        ).labels(pid)
        self._m_non_committed = REGISTRY.gauge(
            "non_committed_entries", "entries appended but not committed",
            ("partition",)).labels(pid)
        self._m_non_replicated = REGISTRY.gauge(
            "non_replicated_entries",
            "entries not yet replicated to the slowest follower",
            ("partition",)).labels(pid)
        self._m_append_rate = REGISTRY.counter(
            "append_entries_rate", "AppendEntries rpcs sent", ("partition",)
        ).labels(pid)
        self._m_append_data = REGISTRY.counter(
            "append_entries_data_rate", "entry bytes shipped in AppendEntries",
            ("partition",)).labels(pid)
        self._m_append_latency = REGISTRY.histogram(
            "append_entries_latency", "local leader append seconds",
            ("partition",)).labels(pid)
        self._m_commit_rate = REGISTRY.counter(
            "commit_entries_rate", "entries committed", ("partition",)
        ).labels(pid)
        self._m_snapshot_repl = REGISTRY.counter(
            "snapshot_replication_count",
            "snapshot installs sent to lagging followers", ("partition",)
        ).labels(pid)
        self._m_snapshot_repl_ms = REGISTRY.histogram(
            "snapshot_replication_duration_milliseconds",
            "ms to build+send one snapshot install", ("partition",),
            buckets=(1, 5, 10, 50, 100, 500, 1000, 5000),
        ).labels(pid)
        self._m_flush_duration = REGISTRY.histogram(
            "flush_duration_seconds",
            "seconds per raft journal fsync", ("partition",)).labels(pid)
        self._m_deferred_appends = REGISTRY.counter(
            "deferred_append_count_total",
            "appends acked before fsync (delayed flush policy)",
            ("partition",)).labels(pid)
        self._election_started_ms: int | None = None
        self._leader_since_ms: int | None = None
        self.members = sorted(members)
        self._bootstrap_members = sorted(members)
        # configuration in effect at the journal's base (snapshot boundary):
        # the truncation-rollback fallback when no config entry survives in
        # the log suffix
        self._config_base = sorted(members)
        self._last_config_index = 0
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.clock_millis = clock_millis
        self.priority = priority
        # deterministic jitter per member (tests are reproducible)
        self._rng = random.Random(
            seed if seed is not None else hash((self.member_id, partition_id)) & 0xFFFF
        )

        self.journal = SegmentedJournal(self.directory / "raft-log",
                                        max_unflushed_bytes=max_unflushed_bytes,
                                        owner=(partition_id, self.member_id))
        # "immediate": fsync before acking appends / advancing own match —
        # the reference's default (journal flush-before-ack, SURVEY §2.2);
        # "delayed": fsync on the next tick (reference DelayedFlusher);
        # "none": never fsync (tests).
        if flush_policy not in ("immediate", "delayed", "none"):
            raise ValueError(f"unknown flush_policy {flush_policy!r}")
        self.flush_policy = flush_policy
        # group-commit pacing over the "immediate" policy: with
        # flush_interval_s > 0 the fsync is DEFERRED up to the interval (or
        # the journal's max_unflushed_bytes), and the *acknowledgement*
        # waits for it — _ack_index() holds at the flushed prefix, so
        # unlike "delayed" nothing is ever acked/committed before its
        # covering fsync; a power loss costs only unacked entries. Several
        # appends inside the window share one fsync: the classic
        # group-commit latency/throughput trade, and the journal-flush
        # controller's knob (zeebe_tpu/control — the single runtime write
        # path for it).
        self.flush_interval_s = max(float(flush_interval_s), 0.0)
        self._last_flush_perf = _perf_counter()
        # trust only the journal's flush marker on open: entries beyond it may
        # sit in the OS page cache (a process crash reopens them readable, but
        # a later power loss would drop them), so they get re-fsynced before
        # this node acks anything
        self._flushed_index = min(self.journal.last_flushed_index,
                                  self.journal.last_index)
        self._flush_dirty = False
        # boot-time rot suspicion: the open() scan truncates the
        # journal at the first corrupt frame — safe for a torn UNFSYNCED
        # tail (those bytes were never acked), but at-rest bit rot can land
        # BELOW the persisted flush marker, i.e. below bytes this node
        # promised were durable (and possibly voted into a commit). The
        # marker is written only after a successful fsync, so marker >
        # last_index on open means flushed history was LOST: the node boots
        # SUSPECT and abstains from elections (see _election_safe) until a
        # leader re-converges it past the marker — without this, a
        # restarted replica with a silently-shortened log can win an
        # election and re-mint different bytes at committed positions
        # (caught as export split-brain by the torture gate). RF=1 has no
        # one to re-converge from: the loss is accepted (documented caveat).
        marker = self.journal.last_flushed_index
        self._suspect_index = (
            marker if (marker > self.journal.last_index
                       and len(self.members) > 1) else 0)
        self._meta_path = self.directory / "raft-meta.json"
        self.current_term = 0
        self.voted_for: str | None = None
        self._load_meta()

        self.role = RaftRole.FOLLOWER
        self.leader_id: str | None = None
        self.commit_index = 0
        # snapshot bookkeeping (log prefix replaced by a snapshot)
        self.snapshot_index = 0
        self.snapshot_term = 0
        self._snapshot_bytes: bytes | None = None
        self._pending_snapshot: dict[str, Any] | None = None
        self._snapshot_sent_ms: dict[str, int] = {}

        # leader volatile state
        self.next_index: dict[str, int] = {}
        self.match_index: dict[str, int] = {}
        self._pending_appends: dict[int, Callable[[int], None]] = {}

        # election timers
        self._last_heartbeat_ms = clock_millis()
        self._election_deadline_ms = self._next_election_deadline()
        self._last_heartbeat_sent_ms = 0
        self._votes: set[str] = set()
        self._prevotes: set[str] = set()

        self.leader_commit_hint = 0
        self.role_listeners: list[Callable[[RaftRole, int], None]] = []
        self.commit_listeners: list[Callable[[int], None]] = []
        # snapshot provider: () -> (index, term, bytes) | None — installed by
        # the partition owner so lagging followers receive state snapshots
        self.snapshot_provider: Callable[[], tuple[int, int, bytes] | None] | None = None
        self.snapshot_receiver: Callable[[bytes], None] | None = None
        # storage-fault plane: called with (event, detail) on
        # journal corruption repairs and fsync failures so the partition can
        # flight-record them; repairs are throttled against hot loops
        self.storage_listener: Callable[[str, dict], None] | None = None
        self._last_repair_perf = -60.0

        t = f"raft-{partition_id}"

        def _counted(suffix, handler):
            child = self._m_msg_recv.labels(str(partition_id), suffix)

            def wrapped(sender, payload):
                child.inc()
                try:
                    handler(sender, payload)
                except CorruptedJournalError as exc:
                    # at-rest rot surfaced on a read inside an rpc handler:
                    # repair (truncate at the corrupt frame) instead of
                    # letting the error poison the messaging poll loop —
                    # the raft append path re-converges the lost suffix
                    self.repair_journal_corruption(exc)
                except OSError as exc:
                    # storage trouble inside an rpc handler (failed fsync,
                    # write fault): nothing was acked beyond the flushed
                    # prefix — note it and let the protocol retry
                    self._note_storage_error(exc)

            return wrapped

        messaging.subscribe(f"{t}-vote", _counted("vote", self._on_vote_request))
        messaging.subscribe(f"{t}-vote-resp", _counted("vote-resp", self._on_vote_response))
        messaging.subscribe(f"{t}-append", _counted("append", self._on_append_request))
        messaging.subscribe(f"{t}-append-resp", _counted("append-resp", self._on_append_response))
        messaging.subscribe(f"{t}-snapshot", _counted("snapshot", self._on_install_snapshot))
        messaging.subscribe(f"{t}-timeout-now", _counted("timeout-now", self._on_timeout_now))
        messaging.subscribe(f"{t}-snapshot-req",
                            _counted("snapshot-req", self._on_snapshot_request))

    # -- persistence ----------------------------------------------------------

    # copied from the reference: _load_meta .. _last_resort_due
    def _load_meta(self) -> None:
        if self._meta_path.exists():
            meta = json.loads(self._meta_path.read_text())
            self.current_term = meta["term"]
            self.voted_for = meta["votedFor"]
            # a reconfigured membership survives restart (the bootstrap list
            # is only the initial configuration)
            if meta.get("members"):
                self.members = sorted(meta["members"])

    def _store_meta(self) -> None:
        # temp-file + fsync + atomic rename: a crash mid-write must never
        # leave a torn meta file, and a persisted vote must survive the crash
        # (double-vote safety) — reference MetaStore semantics
        tmp = self._meta_path.with_suffix(".json.tmp")
        with open(tmp, "w") as f:
            f.write(json.dumps({"term": self.current_term, "votedFor": self.voted_for,
                                "members": self.members}))
            f.flush()
            if self.flush_policy != "none":
                os.fsync(f.fileno())
        os.replace(tmp, self._meta_path)
        if self.flush_policy != "none":
            # the rename itself must be durable before a vote response leaves
            dir_fd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(dir_fd)
            finally:
                os.close(dir_fd)

    def _after_local_append(self) -> None:
        """Durability barrier after appending entries, before acknowledging
        them (follower ack, or leader counting itself toward the quorum)."""
        if self.flush_policy == "immediate":
            if self.flush_interval_s <= 0:
                self._flush_journal()
                return
            # group-commit posture: defer the fsync up to flush_interval_s
            # or the byte bound; _ack_index() holds at the flushed prefix,
            # so deferral delays the ack — it never precedes the fsync
            self._flush_dirty = True
            if self._group_flush_due():
                self._flush_journal()
        elif self.flush_policy == "delayed":
            self._flush_dirty = True
            self._m_deferred_appends.inc()

    def _group_flush_due(self) -> bool:
        return (self.journal.unflushed_bytes
                >= self.journal.max_unflushed_bytes
                or _perf_counter() - self._last_flush_perf
                >= self.flush_interval_s)

    def _ack_index(self) -> int:
        """Highest index this node may acknowledge (follower ack, or the
        leader's own quorum vote). Under the group-commit posture that is
        the durably flushed prefix — never an unfsynced entry; every other
        posture keeps its existing semantics (notably "delayed", which
        deliberately acks before fsync). The ``_flush_dirty`` clause keeps
        the hold when the journal-flush actuator narrows the interval back
        to 0 WHILE a deferral is pending — the suffix stays unackable
        until the next tick drains it (dropping the hold on the knob
        change alone would ack entries whose fsync never happened)."""
        if self.flush_policy == "immediate" and (self.flush_interval_s > 0
                                                 or self._flush_dirty):
            return min(self._last_log_index(),
                       max(self._flushed_index, self.snapshot_index))
        return self._last_log_index()

    def _flush_journal(self) -> None:
        if self.journal.last_index != self._flushed_index:
            start = _perf_counter()
            try:
                self.journal.flush()
            except OSError as exc:
                # fsyncgate: the journal already failed the
                # segment hard — fresh fd, file re-verified from the last
                # known-flushed offset, suffix discarded. Our job is the
                # consensus side of the contract: nothing the failed fsync
                # covered may be acked, and a LEADER whose own log just
                # rewound must stop leading (re-appending at reused indexes
                # in the same term would hand followers conflicting entries
                # the protocol cannot detect). The surviving cluster
                # re-elects; this node re-converges as a follower.
                self._flushed_index = min(self._flushed_index,
                                          self.journal.last_index)
                self._flush_dirty = False
                self._last_flush_perf = _perf_counter()
                self._note_storage_error(exc)
                if self.role == RaftRole.LEADER:
                    self._become(RaftRole.FOLLOWER)
                return
            self._m_flush_duration.observe(_perf_counter() - start)
            self._flushed_index = self.journal.last_index
        self._flush_dirty = False
        self._last_flush_perf = _perf_counter()

    def _truncate_after(self, index: int) -> None:
        had_config_after = any(
            e.get("config") for e in self._entries_from(index + 1)
        )
        self.journal.truncate_after(index)
        # conflicting entries re-appended on top of a truncation must be
        # fsynced again even when the log lands back on the old flushed index
        self._flushed_index = min(self._flushed_index, index)
        if had_config_after:
            # configs apply on APPEND; truncating one away must revert to the
            # last surviving configuration (Raft single-step change rule)
            members, config_index = self._latest_logged_config()
            self._last_config_index = config_index
            self._apply_config(members)

    def _entries_from(self, from_index: int) -> list[dict]:
        out = []
        for rec in self.journal.read_from(from_index):
            entry = unpackb(rec.data)
            entry["index"] = rec.index
            out.append(entry)
        return out

    def _latest_logged_config(self) -> tuple[list[str], int]:
        latest, index = self._config_base, 0
        for entry in self._entries_from(self.snapshot_index + 1):
            if entry.get("config"):
                latest, index = entry["config"], entry["index"]
        return latest, index

    def _reset_journal(self, next_index: int) -> None:
        self.journal.reset(next_index)
        self._flushed_index = min(self._flushed_index, next_index - 1)
        # the log prefix (and any config entries in it) is gone: the current
        # membership becomes the configuration base for rollbacks
        self._config_base = list(self.members)

    # -- storage-fault repair --------------------------------------

    def repair_journal_corruption(self, exc: Exception | None = None) -> dict:
        """At-rest corruption in the raft journal (bit rot caught by the
        scrubber, or a checksum mismatch hit on a live read): truncate at
        the corrupt frame and let the protocol re-converge — the leader
        backs up to the survivors' end and resends, exactly the divergent-
        follower repair Raft already owns. A LEADER repairing its own log
        steps down first (leader completeness: the committed suffix lives
        on a quorum; a single-replica cluster can only truncate — that
        caveat is documented, not hidden). Throttled: a second repair
        within 5s reports ``journal_unrepairable`` through the storage
        listener (the partition fails its processor) instead of looping a
        hot unrepairable fault — and never raises: the callers are rpc
        handlers and tick(), whose escape path is the worker's whole poll
        loop."""
        now = _perf_counter()
        if now - self._last_repair_perf < 5.0:
            # unrepairable by this seam: surface it through the listener —
            # NEVER raise from here, the callers are rpc handlers and
            # tick() whose escape path is the worker's whole poll loop;
            # the partition listener contains it like a poison record
            evidence = {"journal": "raft", "member": self.member_id,
                        "gaveUp": True,
                        "reason": f"repair looping on {self.directory}"
                                  f" ({exc})"}
            if self.storage_listener is not None:
                self.storage_listener("journal_unrepairable", evidence)
            return evidence
        self._last_repair_perf = now
        evidence = self.journal.repair_corruption()
        self._flushed_index = min(self._flushed_index, self.journal.last_index)
        if (len(self.members) <= 1
                and self.journal.last_index < self.commit_index):
            # single-replica cluster: there is no leader to re-fetch the
            # truncated committed suffix from — the disk ate it (the
            # documented RF=1 caveat). Rewind the commit index so the node
            # keeps serving what survives instead of abstaining forever
            # (_election_safe would otherwise never clear).
            evidence["rewoundCommitIndex"] = self.commit_index
            self.commit_index = self.journal.last_index
        evidence["journal"] = "raft"
        evidence["member"] = self.member_id
        evidence["wasLeader"] = self.role == RaftRole.LEADER
        if exc is not None:
            evidence["trigger"] = str(exc)
        if self.role == RaftRole.LEADER:
            self._become(RaftRole.FOLLOWER)
        if self.storage_listener is not None:
            self.storage_listener("journal_repair", evidence)
        return evidence

    def _note_storage_error(self, exc: OSError) -> None:
        if self.storage_listener is not None:
            self.storage_listener("storage_error", {
                "journal": "raft", "member": self.member_id,
                "error": f"{type(exc).__name__}: {exc}"})

    def request_snapshot(self) -> bool:
        """Follower-side snapshot re-fetch: ask the current
        leader to stream its snapshot install — the repair path for a
        follower whose at-rest snapshot chain is corrupt. The existing
        install machinery does the rest (reset journal past the snapshot,
        persist, rebuild the vertical). Returns False when there is no
        known leader to ask (retry on a later scrub pass)."""
        if self.role == RaftRole.LEADER or self.leader_id is None:
            return False
        self._send(self.leader_id, "snapshot-req",
                   {"term": self.current_term, "follower": self.member_id})
        return True

    def _on_snapshot_request(self, sender: str, req: dict) -> None:
        if req.get("term", 0) > self.current_term:
            # like every raft rpc: a higher term deposes a stale leader
            self._set_term(req["term"])
            self._become(RaftRole.FOLLOWER)
            return
        if self.role != RaftRole.LEADER:
            return
        self._send_snapshot(sender)

    def close(self) -> None:
        if self.flush_policy != "none":
            self._flush_journal()  # drain a pending delayed flush on shutdown
        self.journal.close()

    # -- log accessors --------------------------------------------------------

    def _last_log_index(self) -> int:
        return max(self.journal.last_index, self.snapshot_index)

    def _entry_term(self, index: int) -> int:
        if index == 0:
            return 0
        if index == self.snapshot_index:
            return self.snapshot_term
        rec = self.journal.read_entry(index)
        if rec is None:
            return -1
        return unpackb(rec.data)["term"]

    def _last_log_term(self) -> int:
        return self._entry_term(self._last_log_index())

    def _read_entries(self, from_index: int, limit: int) -> list[dict]:
        out = []
        for rec in self.journal.read_from(from_index):
            entry = unpackb(rec.data)
            entry["index"] = rec.index
            out.append(entry)
            if len(out) >= limit:
                break
        return out

    # -- timers ---------------------------------------------------------------

    def _next_election_deadline(self) -> int:
        # priority shortens the timeout so preferred members win elections
        # (reference: RaftElectionConfig priority election)
        jitter = self._rng.randrange(ELECTION_TIMEOUT_MS // 2)
        bias = ELECTION_TIMEOUT_MS // (2 * max(self.priority, 1))
        return self.clock_millis() + bias + jitter

    def tick(self, now_millis: int | None = None) -> None:
        try:
            self._tick_inner(now_millis)
        except CorruptedJournalError as exc:
            # journal reads ride the tick (heartbeat entry reads, election
            # up-to-date terms): rot there repairs exactly like rot inside
            # an rpc handler
            self.repair_journal_corruption(exc)
        except OSError as exc:
            # deliberately broad: storage faults AND transport errors that
            # escape a tick are both contained here — the caller is the
            # worker's whole poll loop, and the next tick (~one pump round
            # away) redoes any work this one dropped
            self._note_storage_error(exc)

    def _tick_inner(self, now_millis: int | None = None) -> None:
        now = self.clock_millis() if now_millis is None else now_millis
        if self._flush_dirty:
            if self.flush_policy == "immediate":
                # group-commit posture: drain when due — or immediately
                # when the actuator narrowed the interval to 0 mid-deferral
                # — then release the acks the deferral was holding: the
                # leader re-counts its own durable vote, a follower
                # proactively acks the leader (waiting for the next
                # heartbeat would add up to HEARTBEAT_INTERVAL_MS to every
                # deferred commit)
                if self.flush_interval_s <= 0 or self._group_flush_due():
                    self._flush_journal()
                    if self.role == RaftRole.LEADER:
                        self._advance_commit()
                    elif (self.role == RaftRole.FOLLOWER
                          and self.leader_id is not None
                          and self.leader_id != self.member_id):
                        self._send(self.leader_id, "append-resp", {
                            "term": self.current_term, "success": True,
                            "lastIndex": self._ack_index(),
                            "follower": self.member_id,
                        })
            else:
                self._flush_journal()  # delayed flush policy drains here
        if self.role == RaftRole.LEADER:
            if now - self._last_heartbeat_sent_ms >= HEARTBEAT_INTERVAL_MS:
                self._broadcast_appends()
        elif now >= self._election_deadline_ms:
            self._start_prevote()

    # -- elections ------------------------------------------------------------

    def _election_safe(self) -> bool:
        """Raft's quorum-intersection safety argument assumes stable
        storage. A node whose journal was truncate-REPAIRED below its own
        known commit index (at-rest corruption, holds a log that
        LIES about history: letting it start elections — or grant votes
        against its shortened log — can elect a leader missing committed
        entries (commit majority {A,B}, election majority {A,C}, A is the
        corrupted intersection). Until the leader re-converges this node
        past its commit index, it ABSTAINS from elections entirely. Healthy
        operation always satisfies the check (commit ≤ last log index), so
        this costs nothing outside a repair window. The same rule covers
        BOOT-time rot: a journal that opened below its own flush marker
        (``_suspect_index``) lost flushed — possibly committed — history
        and must not lead or judge until refilled past the marker."""
        return self._last_log_index() >= max(self.commit_index,
                                             self._suspect_index)

    def _last_resort_due(self) -> bool:
        """True when no leader has been heard for LAST_RESORT_ELECTION_MS:
        the abstention rule yields to liveness (rot on a quorum would
        otherwise wedge the cluster with every replica waiting for a
        leader that can never be elected)."""
        return (self.clock_millis() - self._last_heartbeat_ms
                >= LAST_RESORT_ELECTION_MS)
    # end of the copy

    def _start_prevote(self) -> None:
        """Pre-vote phase: probe electability without disturbing the term
        (reference: raft pre-vote, PreVoteRequest). A candidate whose election
        timed out retries the election directly — prevote responses are only
        collected while still a follower."""
        if not self._election_safe() and not self._last_resort_due():
            # corruption-repaired log below our own commit: wait for the
            # leader to refill it (see _election_safe) instead of electing
            self._election_deadline_ms = self._next_election_deadline()
            return
        if self.role == RaftRole.CANDIDATE:
            self._start_election()
            return
        self._election_deadline_ms = self._next_election_deadline()
        self._prevotes = {self.member_id}
        # this member's timer fired: it has stopped hearing its leader, so
        # it drops it, as raft's pre-candidate does. It then grants the
        # pre-vote of another follower that timed out too, where keeping the
        # leader denied it for the leader's stickiness window (2,500 ms
        # after the last heartbeat, longer than any timer's 1,250-2,500):
        # every first pre-vote after a leader's death was denied
        self.leader_id = None
        if self._quorum(len(self._prevotes)):
            self._start_election()
            return
        for m in self._other_members():
            self._send(m, "vote", {
                "term": self.current_term + 1,
                "candidate": self.member_id,
                "lastLogIndex": self._last_log_index(),
                "lastLogTerm": self._last_log_term(),
                "prevote": True,
            })

    # copied from the reference: _start_election .. _start_election
    def _start_election(self) -> None:
        self._prevotes = set()  # stale grants must not re-trigger elections
        self._m_elections.inc()
        self._m_heartbeat_miss.inc()
        self._election_started_ms = self.clock_millis()
        self._set_term(self.current_term + 1, vote_for=self.member_id)
        self._become(RaftRole.CANDIDATE)
        self._votes = {self.member_id}
        self._election_deadline_ms = self._next_election_deadline()
        if self._quorum(len(self._votes)):
            self._become_leader()
            return
        for m in self._other_members():
            self._send(m, "vote", {
                "term": self.current_term,
                "candidate": self.member_id,
                "lastLogIndex": self._last_log_index(),
                "lastLogTerm": self._last_log_term(),
                "prevote": False,
            })
    # end of the copy

    def _on_vote_request(self, sender: str, req: dict) -> None:
        """The reference's answer to a vote or a pre-vote; then, where the
        requester cannot win the election and this member can, this member's
        election timer is set to fire at its next tick."""
        if sender not in self.members:
            # an ex-member removed by reconfiguration (possibly before it
            # learned of the removal) must not be able to bump our terms
            return
        term = req["term"]
        standard_up_to_date = (
            req["lastLogTerm"] > self._last_log_term()
            or (req["lastLogTerm"] == self._last_log_term()
                and req["lastLogIndex"] >= self._last_log_index())
        )
        if self._election_safe():
            up_to_date = standard_up_to_date
        else:
            # corruption-repaired log below our own commit index: our
            # shortened history cannot judge candidates — it would grant
            # votes to candidates missing committed entries (see
            # _election_safe). But the REMEMBERED commit index still can:
            # a candidate whose log covers it cannot be missing anything
            # we know committed. Past the last-resort window (no leader
            # for 10x the election timeout — rot hit a quorum and nobody
            # can satisfy the commit-index bar) fall back to the standard
            # longest-log-wins rule: the best surviving log leads, and
            # what rot destroyed everywhere is gone either way.
            bar = max(self.commit_index, self._suspect_index)
            up_to_date = (req["lastLogIndex"] >= bar
                          or (self._last_resort_due()
                              and standard_up_to_date))
        if req.get("prevote"):
            # leader stickiness: deny pre-votes while we hear from a live
            # leader, so a rejoining partitioned node cannot depose a healthy
            # one (raft pre-vote + check-quorum semantics)
            heard_recently = (
                self.leader_id is not None
                and self.clock_millis() - self._last_heartbeat_ms < ELECTION_TIMEOUT_MS
            )
            granted = term > self.current_term and up_to_date and not heard_recently
            self._send(sender, "vote-resp", {
                "term": self.current_term, "granted": granted, "prevote": True,
                "voter": self.member_id,
            })
            if (self.role == RaftRole.FOLLOWER and self.leader_id is None
                    and self._election_safe() and not standard_up_to_date):
                # this member lost its leader too, and the requester's log
                # is behind its own: the requester cannot win, and a member
                # that waited for its next timer left the partition without
                # a leader for up to another election timeout
                self._election_deadline_ms = self.clock_millis()
            return
        if term > self.current_term:
            self._set_term(term)
            self._become(RaftRole.FOLLOWER)
        granted = (
            term == self.current_term
            and self.voted_for in (None, req["candidate"])
            and up_to_date
        )
        if granted:
            self.voted_for = req["candidate"]
            self._store_meta()
            self._election_deadline_ms = self._next_election_deadline()
        self._send(sender, "vote-resp", {
            "term": self.current_term, "granted": granted, "prevote": False,
            "voter": self.member_id,
        })
        if (self.role == RaftRole.CANDIDATE and term == self.current_term
                and self.voted_for == self.member_id and self._election_safe()):
            # a split vote: two candidates of one term, each voted for
            # itself. The one with the longer log (on a tie the smaller
            # member id) runs its next election at once, and its request
            # reaches the other before that one's timer fires, where both
            # waiting for new timers could split the next term too
            ours = (self._last_log_term(), self._last_log_index())
            theirs = (req["lastLogTerm"], req["lastLogIndex"])
            if ours > theirs or (ours == theirs and self.member_id < req["candidate"]):
                self._election_deadline_ms = self.clock_millis()

    # copied from the reference: _on_vote_response .. committed_entries
    def _on_vote_response(self, sender: str, resp: dict) -> None:
        if resp.get("prevote"):
            # only followers collect pre-votes; once the election started the
            # round is over (stale grants otherwise burn terms + reset votes)
            if resp["granted"] and self.role == RaftRole.FOLLOWER:
                self._prevotes.add(resp["voter"])
                if self._quorum(len(self._prevotes)):
                    self._start_election()
            return
        if resp["term"] > self.current_term:
            self._set_term(resp["term"])
            self._become(RaftRole.FOLLOWER)
            return
        if self.role != RaftRole.CANDIDATE or resp["term"] != self.current_term:
            return
        if resp["granted"]:
            self._votes.add(resp["voter"])
            if self._quorum(len(self._votes)):
                self._become_leader()

    def transfer_leadership(self, target: str) -> bool:
        """Best-effort leadership transfer (raft leadership-transfer
        extension; reference: RaftContext#transferLeadership backing the
        actuator's RebalancingEndpoint): replicate to the target, then tell
        it to start an election IMMEDIATELY (timeout-now). If the target's
        log is behind it simply loses and we stay leader; if it wins, its
        higher term deposes us on the next message."""
        if (self.role != RaftRole.LEADER or target == self.member_id
                or target not in self.members):
            return False
        self._send_append(target)  # close any replication gap first
        self._send(target, "timeout-now", {"term": self.current_term})
        return True

    def _on_timeout_now(self, sender: str, req: dict) -> None:
        """The current leader asked us to depose it: skip the pre-vote phase
        (the leader itself initiated this, so stickiness must not block it)
        and start an election at once."""
        if sender not in self.members or req["term"] < self.current_term:
            return
        if self.role == RaftRole.LEADER:
            return
        self._start_election()

    def _become_leader(self) -> None:
        now = self.clock_millis()
        if self._election_started_ms is not None:
            self._m_election_latency.observe(now - self._election_started_ms)
            self._election_started_ms = None
        self._leader_since_ms = now
        self._become(RaftRole.LEADER)
        self.leader_id = self.member_id
        last = self._last_log_index()
        self.next_index = {m: last + 1 for m in self._other_members()}
        self.match_index = {m: 0 for m in self._other_members()}
        # commit an initial entry to finalize entries from previous terms
        # (reference: InitialEntry appended on leader transition)
        self._append_local({"term": self.current_term, "init": True, "asqn": -1,
                            "data": b""})
        self._after_local_append()
        self._broadcast_appends()

    # -- write ingress (ZeebeLogAppender.appendEntry equivalent) ---------------

    def reconfigure(self, new_members: list[str]) -> bool:
        """Leader-only single-step membership change (reference: Raft §4.1
        single-server changes; the atomix ConfigurationEntry): appends a
        config entry and applies it IMMEDIATELY on append — both leader and
        followers switch to the new configuration as soon as the entry is in
        their log, not at commit (the Raft paper's rule). One change at a
        time is the coordinator's job (topology change plans are serialized),
        which is what makes single-step changes safe."""
        if self.role != RaftRole.LEADER:
            return False
        new_members = sorted(new_members)
        if new_members == self.members:
            return True
        if self._last_config_index > self.commit_index:
            # single-step changes are only safe one at a time: the previous
            # configuration must commit before the next is appended (callers
            # retry on their next tick)
            return False
        self._last_config_index = self._last_log_index() + 1
        self._append_local({
            "term": self.current_term, "init": False, "asqn": -1, "data": b"",
            "config": new_members,
        })
        self._after_local_append()
        # broadcast BEFORE applying: members being removed must still receive
        # the config entry (it is how they learn they left); only then shrink
        # the replication targets
        self._broadcast_appends()
        self._apply_config(new_members)
        return True

    def _apply_config(self, members: list[str]) -> None:
        self.members = sorted(members)
        self._store_meta()
        if self.role == RaftRole.LEADER:
            last = self._last_log_index()
            for m in self._other_members():
                self.next_index.setdefault(m, last + 1)
                self.match_index.setdefault(m, 0)
            for m in list(self.next_index):
                if m not in self.members:
                    del self.next_index[m]
                    self.match_index.pop(m, None)
            if self.member_id not in self.members:
                # removed myself: hand off by reverting to follower; the rest
                # of the group elects among themselves
                self._become(RaftRole.FOLLOWER)
            else:
                self._advance_commit()  # quorum size may have shrunk

    def append(self, data: bytes, asqn: int = -1,
               on_commit: Callable[[int], None] | None = None) -> int | None:
        """Leader-only append; returns the raft index (None if not leader).
        ``on_commit`` fires with the index once the entry is replicated to a
        quorum (reference: AppendListener.onCommit)."""
        if self.role != RaftRole.LEADER:
            return None
        index = self._append_local({
            "term": self.current_term, "init": False, "asqn": asqn, "data": data,
        })
        self._after_local_append()
        if self.role != RaftRole.LEADER:
            # a failed fsync inside the append stepped this leader down and
            # rewound the suffix — the caller must treat this as not-leader
            return None
        if on_commit is not None:
            self._pending_appends[index] = on_commit
        self._broadcast_appends()
        return index

    def _append_local(self, entry: dict) -> int:
        import time as _time

        start = _time.perf_counter()
        asqn = entry.get("asqn", -1)
        rec = self.journal.append(
            packb({k: v for k, v in entry.items() if k != "index"}),
            asqn=asqn if asqn is not None and asqn >= 0 else -1,  # ASQN_IGNORE
        )
        self._m_append_latency.observe(_time.perf_counter() - start)
        self._m_append_index.set(rec.index)
        return rec.index

    # -- replication ----------------------------------------------------------

    def _broadcast_appends(self) -> None:
        self._last_heartbeat_sent_ms = self.clock_millis()
        for m in self._other_members():
            self._send_append(m)
        self._advance_commit()  # single-node cluster commits immediately

    def _send_append(self, member: str) -> None:
        next_idx = self.next_index.get(member, self._last_log_index() + 1)
        if next_idx <= self.snapshot_index:
            self._send_snapshot(member)
            return
        prev_index = next_idx - 1
        prev_term = self._entry_term(prev_index)
        entries = self._read_entries(next_idx, MAX_ENTRIES_PER_APPEND)
        self._m_append_rate.inc()
        self._m_append_data.inc(sum(len(e.get("data", b"") or b"") for e in entries))
        others = self._other_members()
        if others:
            slowest = min(self.match_index.get(m, 0) for m in others)
            self._m_non_replicated.set(
                max(0, self._last_log_index() - slowest))
        self._send(member, "append", {
            "term": self.current_term,
            "leader": self.member_id,
            "prevIndex": prev_index,
            "prevTerm": prev_term,
            "entries": entries,
            "commit": self.commit_index,
        })

    def _on_append_request(self, sender: str, req: dict) -> None:
        if req["term"] < self.current_term:
            self._send(sender, "append-resp", {
                "term": self.current_term, "success": False,
                "lastIndex": self._last_log_index(), "follower": self.member_id,
            })
            return
        if req["term"] > self.current_term:
            self._set_term(req["term"])
        if self.role != RaftRole.FOLLOWER:
            self._become(RaftRole.FOLLOWER)
        self.leader_id = req["leader"]
        self._last_heartbeat_ms = self.clock_millis()
        self._m_heartbeat_time.set(self._last_heartbeat_ms / 1000.0)
        self._election_deadline_ms = self._next_election_deadline()

        prev_index, prev_term = req["prevIndex"], req["prevTerm"]
        local_prev_term = self._entry_term(prev_index)
        if prev_index > 0 and local_prev_term != prev_term:
            # consistency check failed: ask leader to back up
            self._send(sender, "append-resp", {
                "term": self.current_term, "success": False,
                "lastIndex": min(self._last_log_index(), prev_index - 1),
                "follower": self.member_id,
            })
            return
        for entry in req["entries"]:
            index = entry["index"]
            local_term = self._entry_term(index)
            if local_term == -1 or index > self._last_log_index():
                self._append_at(index, entry)
            elif local_term != entry["term"]:
                self._truncate_after(index - 1)
                self._append_at(index, entry)
        self._after_local_append()  # flush BEFORE acking (Raft durability)
        # the leader's commit index as last advertised — lets a joining
        # replica detect when it has fully caught up (topology PARTITION_JOIN)
        self.leader_commit_hint = max(self.leader_commit_hint, req["commit"])
        if req["commit"] > self.commit_index:
            self._set_commit(min(req["commit"], self._last_log_index()))
        self._send(sender, "append-resp", {
            "term": self.current_term, "success": True,
            # group-commit posture acks only the flushed prefix; the leader
            # resends the (already stored, idempotently skipped) suffix and
            # the deferred-flush tick proactively acks when it drains
            "lastIndex": self._ack_index(), "follower": self.member_id,
        })

    def _append_at(self, index: int, entry: dict) -> None:
        expected = self.journal.last_index + 1
        if index != expected:
            if index <= self.journal.last_index:
                self._truncate_after(index - 1)
            else:
                # gap after snapshot install: reset the journal base
                self._reset_journal(index)
        self._append_local(entry)
        if entry.get("config"):
            self._last_config_index = index
            self._apply_config(entry["config"])

    def _on_append_response(self, sender: str, resp: dict) -> None:
        if resp["term"] > self.current_term:
            self._set_term(resp["term"])
            self._become(RaftRole.FOLLOWER)
            return
        if self.role != RaftRole.LEADER:
            return
        follower = resp["follower"]
        if resp["success"]:
            self.match_index[follower] = resp["lastIndex"]
            self.next_index[follower] = resp["lastIndex"] + 1
            self._advance_commit()
        else:
            # back up (follower hints with its last index)
            self.next_index[follower] = max(1, min(
                self.next_index.get(follower, 1) - 1, resp["lastIndex"] + 1
            ))
            self._send_append(follower)

    def _advance_commit(self) -> None:
        """Advance commit index to the highest index replicated on a quorum
        whose entry is from the current term (Raft §5.4.2)."""
        last = self._last_log_index()
        # under the group-commit posture the leader's own vote counts only
        # up to its flushed prefix (every other posture: the whole log)
        own = self._ack_index()
        for candidate in range(last, self.commit_index, -1):
            count = (1 if own >= candidate else 0) + sum(
                1 for m in self._other_members()
                if self.match_index.get(m, 0) >= candidate)
            if self._quorum(count) and self._entry_term(candidate) == self.current_term:
                self._set_commit(candidate)
                break

    def _set_commit(self, index: int) -> None:
        if index <= self.commit_index:
            return
        self._m_commit_rate.inc(index - self.commit_index)
        self.commit_index = index
        self._m_commit_index.set(index)
        self._m_non_committed.set(max(0, self._last_log_index() - index))
        if self._leader_since_ms is not None:
            self._m_leader_transition.observe(
                (self.clock_millis() - self._leader_since_ms) / 1000.0)
            self._leader_since_ms = None
        for pending_index in sorted(self._pending_appends):
            if pending_index <= index:
                self._pending_appends.pop(pending_index)(pending_index)
        for listener in self.commit_listeners:
            listener(index)

    # -- snapshot install ------------------------------------------------------

    def set_snapshot(self, index: int, term: int,
                     data: bytes | None) -> None:
        """Owner took a state snapshot: the log up to ``index`` can compact
        (reference: snapshot → Raft compacts log up to snapshot index).
        ``data=None``: no stored fallback payload — installs are served only
        by the live ``snapshot_provider`` (durable-state mode), and when it
        declines, nothing is sent."""
        self.snapshot_index = index
        self.snapshot_term = term
        self._snapshot_bytes = data
        self.journal.compact(index + 1)

    def entry_term(self, index: int) -> int:
        """Term of the entry at ``index`` (snapshot boundary aware)."""
        return self._entry_term(index)

    def _send_snapshot(self, member: str) -> None:
        # throttle: a full snapshot per heartbeat per lagging follower is
        # O(snapshot bytes) of redundant work; resend only after a quiet period
        now = self.clock_millis()
        last_sent = self._snapshot_sent_ms.get(member, -ELECTION_TIMEOUT_MS)
        if now - last_sent < ELECTION_TIMEOUT_MS:
            return
        self._snapshot_sent_ms[member] = now
        import time as _time

        _repl_start = _time.perf_counter()
        self._m_snapshot_repl.inc()
        snap = None
        if self.snapshot_provider is not None:
            snap = self.snapshot_provider()
        if snap is None and self._snapshot_bytes is not None:
            snap = (self.snapshot_index, self.snapshot_term, self._snapshot_bytes)
        if snap is None:
            return
        index, term, data = snap
        for offset in range(0, max(len(data), 1), SNAPSHOT_CHUNK_BYTES):
            chunk = data[offset:offset + SNAPSHOT_CHUNK_BYTES]
            self._send(member, "snapshot", {
                "term": self.current_term, "leader": self.member_id,
                "index": index, "snapTerm": term,
                "offset": offset, "chunk": chunk,
                "done": offset + SNAPSHOT_CHUNK_BYTES >= len(data),
            })
        self._m_snapshot_repl_ms.observe((_time.perf_counter() - _repl_start) * 1000.0)

    def _on_install_snapshot(self, sender: str, req: dict) -> None:
        if req["term"] < self.current_term:
            return
        if req["term"] > self.current_term:
            self._set_term(req["term"])
        self._become(RaftRole.FOLLOWER)
        self.leader_id = req["leader"]
        self._last_heartbeat_ms = self.clock_millis()
        self._election_deadline_ms = self._next_election_deadline()
        if req["offset"] == 0:
            self._pending_snapshot = {"index": req["index"], "term": req["snapTerm"],
                                      "data": bytearray()}
        if self._pending_snapshot is None:
            return
        # continuity check: a dropped middle chunk must abort reassembly and
        # wait for a fresh offset-0 retransmit, never install torn bytes
        if (req["offset"] != len(self._pending_snapshot["data"])
                or req["index"] != self._pending_snapshot["index"]):
            self._pending_snapshot = None
            return
        self._pending_snapshot["data"] += req["chunk"]
        if req["done"]:
            snap = self._pending_snapshot
            self._pending_snapshot = None
            self.snapshot_index = snap["index"]
            self.snapshot_term = snap["term"]
            self._snapshot_bytes = bytes(snap["data"])
            self._reset_journal(snap["index"] + 1)
            self.commit_index = max(self.commit_index, snap["index"])
            if self.snapshot_receiver is not None:
                self.snapshot_receiver(bytes(snap["data"]))
            self._send(sender, "append-resp", {
                "term": self.current_term, "success": True,
                "lastIndex": snap["index"], "follower": self.member_id,
            })

    # -- helpers ---------------------------------------------------------------

    def _other_members(self) -> list[str]:
        return [m for m in self.members if m != self.member_id]

    def _quorum(self, count: int) -> bool:
        return count >= len(self.members) // 2 + 1

    def _set_term(self, term: int, vote_for: str | None = None) -> None:
        if term > self.current_term or vote_for is not None:
            self.current_term = term
            self.voted_for = vote_for
            self._store_meta()

    def _become(self, role: RaftRole) -> None:
        if self.role is role:
            return
        self.role = role
        self._m_role.set({RaftRole.LEADER: 3, RaftRole.CANDIDATE: 2}.get(role, 1))
        if role != RaftRole.LEADER:
            # a stepped-down leader must not emit leader_transition_latency
            # samples from follower-side commit advances
            self._leader_since_ms = None
        if role != RaftRole.LEADER:
            self._pending_appends.clear()
        for listener in self.role_listeners:
            listener(role, self.current_term)

    def _send(self, member: str, suffix: str, payload: dict) -> None:
        self._m_msg_send.labels(str(self.partition_id), suffix).inc()
        self.messaging.send(member, f"raft-{self.partition_id}-{suffix}", payload)

    # -- committed-entry reader (log storage integration) ----------------------

    def committed_entries(self, from_index: int) -> list[dict]:
        """Entries up to the commit index (application entries only carry data)."""
        out = []
        for rec in self.journal.read_from(from_index):
            if rec.index > self.commit_index:
                break
            entry = unpackb(rec.data)
            entry["index"] = rec.index
            out.append(entry)
        return out
    # end of the copy
