"""TCP-layer chaos: seeded fault injection for the multi-process cluster.

's ``ChaosNetwork`` made the in-process loopback cluster chaos-testable;
the TCP stack (gateway↔worker envelopes, worker↔worker Raft/SWIM) had
never been pointed at a fault injector at all. ``ChaosTcpMessagingService``
wraps any :class:`~zeebe_tpu_torch.cluster.messaging.MessagingService` — in
practice each process's ``TcpMessagingService`` — and applies a seeded
:class:`~zeebe_tpu_torch.testing.chaos.FaultPlan` to every outbound frame:

- **drop / duplicate / delay / reorder** with the plan's per-message
  probabilities (delay = ``1..max_delay_ticks`` × ``tick_ms``; reorder =
  held past the frames sent after it, released on the next pump poll);
- **scheduled link partitions**: ``LinkWindow`` entries block both
  directions of a member pair for a wall-clock window relative to a shared
  epoch — every process gets the same spec + epoch through the environment,
  so both ends of a link agree on when it is down.

Each process derives its RNG from ``seed ^ crc32(member id)``: a given
member's fault stream is reproducible for a fixed send sequence, and
distinct members don't mirror each other's decisions. (Unlike the loopback
harness this is *seeded*, not bit-reproducible — real TCP scheduling varies
between runs; the consistency checker's invariants are what must hold under
every interleaving.)

Environment wiring (the worker process entry and the consistency harness):

- ``ZEEBE_CHAOS_TCP``   — the spec, e.g.
  ``seed=7,drop=0.02,dup=0.02,delay=0.05,reorder=0.02,max_delay_ticks=3,
  tick_ms=50;partition=worker-0|worker-1@3000-6000;partition=worker-2|*@9000-10500``
- ``ZEEBE_CHAOS_EPOCH_MS`` — shared wall-clock epoch (unix millis) the
  partition windows are relative to.
- ``ZEEBE_CHAOS_TCP_WINDOWSFILE`` — path to a dynamically (re)loaded
  windows file (one ``a|b@start-end`` line per window, epoch-relative ms):
  the chaos controller (the consistency harness) writes it AFTER boot
  completes, so windows land mid-drive regardless of how long the worker
  fleet took to come up. Reloaded on mtime change, throttled.

The supervisor ``kill_worker`` storm rides next to this at the harness
level (testing/consistency.py): process kills are scheduled against the
same epoch, so one seed describes the whole fault scenario.
"""

from __future__ import annotations

import dataclasses
import heapq
import logging
import os
import threading
import time
from typing import Any

from zeebe_tpu_torch.testing.chaos import FaultPlan
from zeebe_tpu_torch.testing.chaos_common import (
    CountsSnapshot,
    member_rng,
    parse_spec_fields,
)

logger = logging.getLogger("zeebe_tpu_torch.testing.chaos_tcp")


@dataclasses.dataclass(frozen=True)
class LinkWindow:
    """Both directions of the (a, b) link are down during
    [start_ms, end_ms) relative to the shared epoch; ``b == "*"`` isolates
    member ``a`` from everyone."""

    a: str
    b: str
    start_ms: int
    end_ms: int

    def matches(self, x: str, y: str) -> bool:
        if self.b == "*":
            return self.a in (x, y)
        return {self.a, self.b} == {x, y}


def format_spec(plan: FaultPlan, windows: list[LinkWindow] = (),
                tick_ms: int = 50) -> str:
    parts = [
        f"seed={plan.seed},drop={plan.drop_p},dup={plan.duplicate_p},"
        f"delay={plan.delay_p},reorder={plan.reorder_p},"
        f"max_delay_ticks={plan.max_delay_ticks},tick_ms={tick_ms}"
    ]
    for w in windows:
        parts.append(f"partition={w.a}|{w.b}@{w.start_ms}-{w.end_ms}")
    return ";".join(parts)


def parse_spec(spec: str) -> tuple[FaultPlan, list[LinkWindow], int]:
    """Inverse of :func:`format_spec`; returns (plan, windows, tick_ms)."""
    plan = FaultPlan()
    windows: list[LinkWindow] = []
    tick_ms = 50
    for section in spec.split(";"):
        section = section.strip()
        if not section:
            continue
        if section.startswith("partition="):
            link, _, span = section[len("partition="):].partition("@")
            a, _, b = link.partition("|")
            start, _, end = span.partition("-")
            windows.append(LinkWindow(a.strip(), b.strip() or "*",
                                      int(start), int(end)))
            continue
        tick_box: list[int] = []
        parse_spec_fields(section, {
            "seed": lambda v: setattr(plan, "seed", int(v)),
            "drop": lambda v: setattr(plan, "drop_p", float(v)),
            "dup": lambda v: setattr(plan, "duplicate_p", float(v)),
            "delay": lambda v: setattr(plan, "delay_p", float(v)),
            "reorder": lambda v: setattr(plan, "reorder_p", float(v)),
            "max_delay_ticks": lambda v: setattr(plan, "max_delay_ticks",
                                                 int(v)),
            "tick_ms": lambda v: tick_box.append(int(v)),
        })
        if tick_box:
            tick_ms = tick_box[-1]
    return plan, windows, tick_ms


class ChaosTcpMessagingService:
    """Fault-injecting wrapper around a started messaging service."""

    def __init__(self, inner, plan: FaultPlan,
                 windows: list[LinkWindow] = (),
                 epoch_ms: float | None = None,
                 tick_ms: int = 50) -> None:
        self.inner = inner
        self.plan = plan
        self.windows = list(windows)
        self.epoch_ms = time.time() * 1000.0 if epoch_ms is None else epoch_ms
        self.tick_ms = max(tick_ms, 1)
        # per-member stream: same seed ⇒ same decisions for the same send
        # sequence, but member A and member B never mirror each other
        self.rng = member_rng(plan.seed, inner.member_id)
        self.counts = {
            "sent": 0, "dropped": 0, "duplicated": 0, "delayed": 0,
            "reordered": 0, "link_blocked": 0,
        }
        self._lock = threading.Lock()
        self._held: list[tuple[float, int, tuple[str, str, Any]]] = []
        self._held_seq = 0
        # reordering holds a frame PER PEER until a later frame to that peer
        # actually overtakes it (released right after that send); poll()
        # flushes stragglers past this age so a quiet link never parks one
        self._reorder_held: dict[str, list[tuple[float, str, Any]]] = {}
        self._reorder_max_hold_s = 0.25
        # periodic counts evidence for the consistency report: a SIGKILLed
        # worker loses at most one dump interval of observations
        self._counts_snap = CountsSnapshot(inner.member_id)
        # dynamically-reloaded windows (the chaos controller writes the
        # file once the fleet is actually up): mtime-checked, throttled
        self.windows_file = None
        self._windows_mtime = -1.0
        self._last_windows_check = 0.0

    # -- delegation ------------------------------------------------------------

    @property
    def member_id(self) -> str:
        return self.inner.member_id

    def subscribe(self, topic: str, handler) -> None:
        self.inner.subscribe(topic, handler)

    def unsubscribe(self, topic: str) -> None:
        self.inner.unsubscribe(topic)

    def start(self) -> None:
        start = getattr(self.inner, "start", None)
        if start is not None:
            start()

    def stop(self) -> None:
        stop = getattr(self.inner, "stop", None)
        if stop is not None:
            stop()

    def poll(self, max_messages: int = 10_000) -> int:
        self._release_due()
        self._flush_stale_reorders()
        self._maybe_reload_windows()
        self._maybe_dump_counts()
        poll = getattr(self.inner, "poll", None)
        return poll(max_messages) if poll is not None else 0

    def _maybe_reload_windows(self) -> None:
        if self.windows_file is None:
            return
        now = time.time()
        if now - self._last_windows_check < 0.25:
            return
        self._last_windows_check = now
        try:
            mtime = os.stat(self.windows_file).st_mtime
        except OSError:
            return  # controller has not written it yet
        if mtime == self._windows_mtime:
            return
        self._windows_mtime = mtime
        try:
            lines = open(self.windows_file, encoding="utf-8").read()
        except OSError:
            return
        windows = []
        for line in lines.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                link, _, span = line.partition("@")
                a, _, b = link.partition("|")
                start, _, end = span.partition("-")
                windows.append(LinkWindow(a.strip(), b.strip() or "*",
                                          int(start), int(end)))
            except ValueError:
                logger.error("ignoring malformed chaos window line %r", line)
        self.windows = windows
        logger.warning("chaos windows reloaded for %s: %s",
                       self.inner.member_id, windows)

    # -- fault application -----------------------------------------------------

    def _link_blocked(self, member_id: str) -> bool:
        if not self.windows:
            return False
        rel = time.time() * 1000.0 - self.epoch_ms
        me = self.inner.member_id
        return any(w.start_ms <= rel < w.end_ms and w.matches(me, member_id)
                   for w in self.windows)

    def send(self, member_id: str, topic: str, payload: Any) -> None:
        self._release_due()
        if self._link_blocked(member_id):
            self.counts["link_blocked"] += 1
            return
        plan = self.plan
        r = self.rng.random()
        if r < plan.drop_p:
            self.counts["dropped"] += 1
            return
        r -= plan.drop_p
        if r < plan.duplicate_p:
            self.counts["duplicated"] += 1
            self.counts["sent"] += 2
            self.inner.send(member_id, topic, payload)
            self.inner.send(member_id, topic, payload)
            return
        r -= plan.duplicate_p
        if r < plan.delay_p:
            ticks = 1 + self.rng.randrange(max(plan.max_delay_ticks, 1))
            self.counts["delayed"] += 1
            self._hold(time.time() + ticks * self.tick_ms / 1000.0,
                       member_id, topic, payload)
            return
        r -= plan.delay_p
        if r < plan.reorder_p:
            # held until the NEXT frame to this peer goes out first — a real
            # overtake on the peer's otherwise-ordered TCP stream (released
            # below, right after that later send)
            self.counts["reordered"] += 1
            self._reorder_held.setdefault(member_id, []).append(
                (time.time(), topic, payload))
            return
        self.counts["sent"] += 1
        self.inner.send(member_id, topic, payload)
        held = self._reorder_held.pop(member_id, None)
        if held:
            for _t, held_topic, held_payload in held:
                self.counts["sent"] += 1
                self.inner.send(member_id, held_topic, held_payload)

    def _hold(self, due_s: float, member_id: str, topic: str,
              payload: Any) -> None:
        with self._lock:
            self._held_seq += 1
            heapq.heappush(self._held,
                           (due_s, self._held_seq, (member_id, topic, payload)))

    def _release_due(self) -> None:
        now = time.time()
        released = []
        with self._lock:
            while self._held and self._held[0][0] <= now:
                released.append(heapq.heappop(self._held)[2])
        for member_id, topic, payload in released:
            if self._link_blocked(member_id):
                self.counts["link_blocked"] += 1
                continue
            self.counts["sent"] += 1
            self.inner.send(member_id, topic, payload)

    def _flush_stale_reorders(self) -> None:
        """A held-for-reorder frame on a link with no later traffic must
        still go out eventually — flush past the max hold age."""
        if not self._reorder_held:
            return
        horizon = time.time() - self._reorder_max_hold_s
        for member_id in list(self._reorder_held):
            held = self._reorder_held[member_id]
            while held and held[0][0] <= horizon:
                _t, topic, payload = held.pop(0)
                self.counts["sent"] += 1
                self.inner.send(member_id, topic, payload)
            if not held:
                del self._reorder_held[member_id]

    @property
    def counts_file(self):
        return self._counts_snap.counts_file

    @counts_file.setter
    def counts_file(self, value) -> None:
        self._counts_snap.counts_file = value

    def _maybe_dump_counts(self) -> None:
        """Throttled counts snapshot to ``counts_file`` (set by the worker
        entry): the consistency report aggregates these as OBSERVED fault
        evidence — configured-but-never-applied chaos must be visible."""
        self._counts_snap.maybe_dump(self.counts)


class ZombiePeer:
    """Slow-client / zombie-client chaos seam: a listening TCP
    endpoint that ACCEPTS connections and never reads a byte — the shape of
    a client stream that wedged mid-download or a gateway whose process is
    SIGSTOPped. Register its address as a peer of a
    :class:`~zeebe_tpu_torch.cluster.messaging.TcpMessagingService` and keep
    sending: the kernel receive window (shrunk via ``recv_buffer``) fills,
    the sender's transport buffer grows, and the sender's per-stream
    outbound bound must disconnect-on-overflow instead of blocking its pump
    or buffering without limit."""

    def __init__(self, host: str = "127.0.0.1", recv_buffer: int = 4096):
        import socket

        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # tiny receive buffer BEFORE listen so accepted sockets inherit it:
        # the kernel-side window fills after a few frames instead of 100s
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, recv_buffer)
        self._sock.bind((host, 0))
        self._sock.listen(16)
        self.address: tuple[str, int] = self._sock.getsockname()
        self.accepted = 0
        self._conns: list = []
        self._closing = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True,
                                        name="zombie-peer")
        self._thread.start()

    def _accept_loop(self) -> None:
        self._sock.settimeout(0.2)
        while not self._closing.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                continue
            # never read: the connection stays open, the window stays shut
            self.accepted += 1
            self._conns.append(conn)

    def close(self) -> None:
        self._closing.set()
        self._thread.join(timeout=2)
        for conn in self._conns:
            try:
                conn.close()
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass


def maybe_wrap_chaos(messaging, env: dict | None = None):
    """Wrap ``messaging`` in a :class:`ChaosTcpMessagingService` when
    ``ZEEBE_CHAOS_TCP`` is set; pass it through untouched otherwise."""
    env = os.environ if env is None else env
    spec = env.get("ZEEBE_CHAOS_TCP")
    if not spec:
        return messaging
    try:
        plan, windows, tick_ms = parse_spec(spec)
        epoch = float(env["ZEEBE_CHAOS_EPOCH_MS"]) \
            if env.get("ZEEBE_CHAOS_EPOCH_MS") else None
    except (ValueError, KeyError) as exc:
        logger.error("ignoring malformed ZEEBE_CHAOS_TCP %r: %s", spec, exc)
        return messaging
    wrapped = ChaosTcpMessagingService(messaging, plan, windows,
                                       epoch_ms=epoch, tick_ms=tick_ms)
    wrapped.windows_file = env.get("ZEEBE_CHAOS_TCP_WINDOWSFILE") or None
    logger.warning("TCP chaos ACTIVE for %s: %s", messaging.member_id, spec)
    return wrapped
