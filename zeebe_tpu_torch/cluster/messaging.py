"""Cluster messaging: topic-addressed request/reply between members.

Reference: atomix/cluster/src/main/java/io/atomix/cluster/messaging/impl/
NettyMessagingService.java — topic-addressed (`consume`/`send`) request/reply
over TCP. Two implementations:

- ``LoopbackNetwork``: in-process, deterministic, with drop/partition fault
  injection — the unit-test substrate (the reference tests Raft the same way,
  atomix/cluster/src/test with local transports).
- ``TcpMessagingService``: asyncio TCP with length-prefixed msgpack frames —
  the real multi-host backend (DCN path; ICI carries only in-kernel jax
  collectives, never these control messages).
"""

from __future__ import annotations

import asyncio
import dataclasses as _dataclasses
import logging
import re
import struct
import threading
from collections import deque
from typing import Any, Callable

from zeebe_tpu_torch.protocol.msgpack import packb, unpackb

logger = logging.getLogger("zeebe_tpu_torch.messaging")

# slow-client / zombie-client protection: a connected peer that
# stops reading must not wedge this process's send path or buffer frames
# without bound — once a connection's outbound transport buffer exceeds
# this, the connection is dropped (the peer reconnects when it recovers;
# Raft retries, the gateway resend loop re-sends) and a metric counts it
DEFAULT_MAX_OUTBOUND_BUFFER_BYTES = 8 * 1024 * 1024


def _max_outbound_buffer_bytes() -> int:
    import os

    try:
        return int(os.environ.get(
            "ZEEBE_BROKER_NETWORK_MAXOUTBOUNDBUFFERBYTES", ""))
    except ValueError:
        return DEFAULT_MAX_OUTBOUND_BUFFER_BYTES


from zeebe_tpu_torch.utils.metrics import REGISTRY as _REG  # noqa: E402

_M_STREAM_OVERFLOW = _REG.counter(
    "messaging_stream_overflow_disconnects_total",
    "outbound connections dropped because the peer stopped reading and the "
    "buffered frames exceeded the per-stream bound (zombie-client "
    "protection)", ("peer",))

# a topic's first embedded integer is its partition id (raft-3-append,
# inter-partition-3, command-api-3, raft-reconfigure-3); control topics
# (swim-probe, gateway-response, …) carry none
_TOPIC_PARTITION = re.compile(r"(\d+)")

# handler(sender_id, payload) -> reply payload | None
Handler = Callable[[str, Any], Any]


class MessagingService:
    """Interface: subscribe to topics, send one-way messages."""

    member_id: str

    def subscribe(self, topic: str, handler: Handler) -> None:
        raise NotImplementedError

    def unsubscribe(self, topic: str) -> None:
        """Drop a topic's handler (stopping a partition replica must not
        leave handlers that dispatch into closed journals)."""
        raise NotImplementedError

    def send(self, member_id: str, topic: str, payload: Any) -> None:
        """Fire-and-forget (Raft piggybacks replies as separate messages)."""
        raise NotImplementedError


class LoopbackMessaging(MessagingService):
    def __init__(self, network: "LoopbackNetwork", member_id: str) -> None:
        self.network = network
        self.member_id = member_id
        self.handlers: dict[str, Handler] = {}

    def subscribe(self, topic: str, handler: Handler) -> None:
        self.handlers[topic] = handler

    def unsubscribe(self, topic: str) -> None:
        self.handlers.pop(topic, None)

    def send(self, member_id: str, topic: str, payload: Any) -> None:
        self.network.enqueue(self.member_id, member_id, topic, payload)


class LoopbackNetwork:
    """Deterministic in-process network with fault injection.

    Messages are queued and delivered only on ``deliver_all`` / ``deliver_one``
    so tests control interleaving exactly. ``partition(a, b)`` drops traffic
    between two members (both directions) until ``heal()``.

    With ``lanes=N`` the queue splits by partition: a topic's first embedded
    integer selects its lane (raft-3-append, command-api-3 → lane 3; topics
    with no partition id → the control lane 0), and ``deliver_lane`` drains
    one lane — the per-partition ownership threads' delivery path (each lane's
    handlers touch only that partition's state, so lanes never need a shared
    lock). ``lanes=0`` (default) keeps the single deterministic queue.
    """

    def __init__(self, lanes: int = 0) -> None:
        self.members: dict[str, LoopbackMessaging] = {}
        self.lanes = lanes
        self._queues: list[deque[tuple[str, str, str, Any]]] = [
            deque() for _ in range(lanes + 1)
        ]
        self._partitions: set[frozenset[str]] = set()
        self.dropped: int = 0
        self._handler_fail_logged: set[str] = set()

    @property
    def queue(self):
        """All pending messages (compat view; prefer per-lane delivery)."""
        if self.lanes == 0:
            return self._queues[0]
        return [m for q in self._queues for m in q]

    def lane_of(self, topic: str) -> int:
        if self.lanes == 0:
            return 0
        if topic.startswith("raft-reconfigure-done-"):
            # topology-plane confirmation: its handler mutates the topology
            # manager's state, which the control thread owns
            return 0
        m = _TOPIC_PARTITION.search(topic)
        if m is None:
            return 0
        lane = int(m.group(1))
        return lane if 1 <= lane <= self.lanes else 0

    def join(self, member_id: str) -> LoopbackMessaging:
        svc = LoopbackMessaging(self, member_id)
        self.members[member_id] = svc
        return svc

    def leave(self, member_id: str) -> None:
        """Remove a member (crashed broker): in-flight traffic to it drops
        like to a dead host, and its stale handlers can never dispatch into
        closed journals. A later ``join`` re-registers fresh handlers."""
        self.members.pop(member_id, None)

    # -- fault injection ------------------------------------------------------

    def partition(self, a: str, b: str) -> None:
        self._partitions.add(frozenset((a, b)))

    def isolate(self, member_id: str) -> None:
        for other in self.members:
            if other != member_id:
                self.partition(member_id, other)

    def heal(self, a: str | None = None, b: str | None = None) -> None:
        if a is None:
            self._partitions.clear()
        elif b is None:
            self._partitions = {p for p in self._partitions if a not in p}
        else:
            self._partitions.discard(frozenset((a, b)))

    def _blocked(self, a: str, b: str) -> bool:
        return frozenset((a, b)) in self._partitions

    # -- delivery -------------------------------------------------------------

    def enqueue(self, sender: str, target: str, topic: str, payload: Any) -> None:
        self._queues[self.lane_of(topic)].append((sender, target, topic, payload))

    def deliver_one(self, lane: int = 0) -> bool:
        q = self._queues[lane]
        if not q:
            return False
        try:
            sender, target, topic, payload = q.popleft()
        except IndexError:  # raced with another consumer of this lane
            return False
        if self._blocked(sender, target) or target not in self.members:
            self.dropped += 1
            return True
        handler = self.members[target].handlers.get(topic)
        if handler is not None:
            try:
                handler(sender, payload)
            except Exception:  # noqa: BLE001 — a crashed member whose handler
                # still dispatches into closed state loses the message (same
                # observable behavior as a real dead host); delivery to every
                # healthy member continues
                self.dropped += 1
                if target not in self._handler_fail_logged:
                    self._handler_fail_logged.add(target)
                    logger.exception(
                        "dropping message %s -> %s on topic %r: handler failed "
                        "(further drops for this member logged at debug)",
                        sender, target, topic,
                    )
                else:
                    logger.debug("dropping message %s -> %s on topic %r",
                                 sender, target, topic)
        return True

    def deliver_lane(self, lane: int, max_messages: int = 100_000) -> int:
        count = 0
        while self._queues[lane] and count < max_messages:
            if not self.deliver_one(lane):
                break
            count += 1
        return count

    def deliver_all(self, max_messages: int = 100_000) -> int:
        count = 0
        for lane in range(len(self._queues)):
            count += self.deliver_lane(lane, max_messages - count)
            if count >= max_messages:
                break
        return count


_FRAME = struct.Struct("<I")


@_dataclasses.dataclass
class TlsConfig:
    """Cluster-messaging TLS (reference: atomix Netty TLS — zeebe.broker.
    network.security.*): every member presents cert_file/key_file; with
    ca_file set, peers are verified against it in BOTH directions (mutual
    TLS). Hostname checks are off — cluster certs are per-node identities
    verified by the shared CA, not by DNS names."""

    cert_file: str
    key_file: str
    ca_file: str | None = None

    def server_context(self):
        if getattr(self, "_server_ctx", None) is None:
            self._server_ctx = self._build_server_context()
        return self._server_ctx

    def client_context(self):
        if getattr(self, "_client_ctx", None) is None:
            self._client_ctx = self._build_client_context()
        return self._client_ctx

    def _build_server_context(self):
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.cert_file, self.key_file)
        if self.ca_file:
            ctx.load_verify_locations(self.ca_file)
            ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx

    def _build_client_context(self):
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.load_cert_chain(self.cert_file, self.key_file)
        if self.ca_file:
            ctx.load_verify_locations(self.ca_file)
            ctx.verify_mode = ssl.CERT_REQUIRED
        else:
            ctx.verify_mode = ssl.CERT_NONE
        return ctx


class TcpMessagingService(MessagingService):
    """asyncio TCP messaging: one connection per peer, frames are
    ``len | msgpack{topic, sender, payload}`` (the NettyMessagingService
    protocol-v2 shape without the compression/TLS options).

    Thread model: the IO loop only *enqueues* received frames; the application
    thread dispatches them to handlers via ``poll()`` — so RaftNode /
    MembershipService state machines are mutated from exactly one thread,
    identical to the loopback network's ``deliver_all`` (single-writer per
    partition, the same discipline the reference enforces with actors)."""

    def __init__(self, member_id: str, bind: tuple[str, int],
                 peers: dict[str, tuple[str, int]],
                 tls: "TlsConfig | None" = None) -> None:
        self.member_id = member_id
        self.bind = bind
        self.peers = dict(peers)
        self.tls = tls
        self.handlers: dict[str, Handler] = {}
        self._server: asyncio.AbstractServer | None = None
        self._writers: dict[str, asyncio.StreamWriter] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._started = threading.Event()
        self._inbox: deque[tuple[str, str, Any]] = deque()
        self._inbox_lock = threading.Lock()
        # per-stream outbound bound: read once (env) so the send hot path
        # never touches os.environ
        self.max_outbound_buffer_bytes = _max_outbound_buffer_bytes()
        self.stream_overflow_disconnects = 0

    def subscribe(self, topic: str, handler: Handler) -> None:
        self.handlers[topic] = handler

    def unsubscribe(self, topic: str) -> None:
        self.handlers.pop(topic, None)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        """Run the event loop on a daemon thread (the host control plane;
        reference brokers likewise run messaging on dedicated Netty threads)."""
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"messaging-{self.member_id}")
        self._thread.start()
        self._started.wait(timeout=10)

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        self._loop.run_until_complete(self._serve())
        self._loop.run_forever()

    async def _serve(self) -> None:
        self._server = await asyncio.start_server(
            self._on_connection, self.bind[0], self.bind[1],
            ssl=self.tls.server_context() if self.tls else None,
        )
        self._started.set()

    def stop(self) -> None:
        if self._loop is not None:
            # close cached outbound writers on the loop before stopping it:
            # a long-lived gateway process that cycles runtimes (tests, the
            # consistency harness) must not leak one fd per former peer
            def _close_writers() -> None:
                for writer in list(self._writers.values()):
                    try:
                        writer.close()
                    except Exception:  # noqa: BLE001 — already broken
                        pass
                self._writers.clear()
                self._loop.stop()

            self._loop.call_soon_threadsafe(_close_writers)
        if self._thread is not None:
            self._thread.join(timeout=5)

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                header = await reader.readexactly(_FRAME.size)
                (length,) = _FRAME.unpack(header)
                frame = unpackb(await reader.readexactly(length))
                with self._inbox_lock:
                    self._inbox.append(
                        (frame["topic"], frame["sender"], frame["payload"])
                    )
        except (asyncio.IncompleteReadError, ConnectionError):
            writer.close()

    def poll(self, max_messages: int = 10_000) -> int:
        """Dispatch queued frames to handlers on the calling thread. Drive this
        from the same loop that calls tick() on the protocol state machines."""
        count = 0
        while count < max_messages:
            with self._inbox_lock:
                if not self._inbox:
                    break
                topic, sender, payload = self._inbox.popleft()
            handler = self.handlers.get(topic)
            if handler is not None:
                try:
                    handler(sender, payload)
                except Exception:  # noqa: BLE001 — a bad frame or a handler
                    # racing a closed component must not kill the pump thread
                    logger.exception("handler for %s failed", topic)
            count += 1
        return count

    async def _watch_peer(self, member_id: str, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        """Drain the outbound connection's read side until EOF/error (peers
        never send on it), then close and evict the writer so stale
        connections to a restarted peer are detected eagerly."""
        try:
            while await reader.read(65536):
                pass
        except Exception:  # noqa: BLE001 — any transport error = dead peer
            pass
        if self._writers.get(member_id) is writer:
            self._writers.pop(member_id, None)
        try:
            writer.close()
        except Exception:  # noqa: BLE001 — already broken
            pass

    def send(self, member_id: str, topic: str, payload: Any) -> None:
        if member_id == self.member_id:
            # self-delivery via the inbox, not TCP: a worker leading BOTH
            # sides of an inter-partition send (deployment distribution,
            # message correlation) addresses itself — it is never in its own
            # peers table, and the loopback network's self-delivery is the
            # semantics every caller was written against. Dropping these
            # silently stalled cross-partition distribution whenever two
            # partitions' leaderships landed on one worker.
            with self._inbox_lock:
                self._inbox.append((topic, member_id, payload))
            return
        if self._loop is None:
            raise RuntimeError("messaging not started")
        self._loop.call_soon_threadsafe(
            lambda: self._loop.create_task(self._send(member_id, topic, payload))
        )

    async def _send(self, member_id: str, topic: str, payload: Any) -> None:
        data = packb({"topic": topic, "sender": self.member_id, "payload": payload})
        # one reconnect retry: a cached writer to a RESTARTED peer (e.g. a
        # supervisor-respawned worker) only reveals its death on the first
        # write — without the retry that first message after every restart
        # was silently dropped, which a one-shot request path (gateway
        # submit) cannot absorb the way Raft's retries can
        for attempt in (0, 1):
            try:
                writer = self._writers.get(member_id)
                if writer is None or writer.is_closing():
                    if member_id not in self.peers:
                        return
                    host, port = self.peers[member_id]
                    reader, writer = await asyncio.open_connection(
                        host, port,
                        ssl=self.tls.client_context() if self.tls else None,
                    )
                    self._writers[member_id] = writer
                    # watch for peer EOF: a cleanly-died peer half-closes the
                    # socket, which does NOT make write()/drain() raise — the
                    # frame would vanish into the half-open connection and
                    # the reconnect retry below would never fire. Evicting
                    # the writer at EOF makes the NEXT send reconnect.
                    self._loop.create_task(
                        self._watch_peer(member_id, reader, writer))
                writer.write(_FRAME.pack(len(data)) + data)
                # NO drain(): a peer that stops reading (zombie client)
                # would park this task — and every later send's task —
                # forever while the transport buffer grows without bound.
                # Instead the buffer is checked against a hard per-stream
                # cap: past it the connection is aborted (frames dropped,
                # counted) and the peer gets a fresh connection when it
                # reads again. Write errors surface via the peer watcher's
                # EOF eviction + the reconnect retry above.
                if (writer.transport.get_write_buffer_size()
                        > self.max_outbound_buffer_bytes):
                    self.stream_overflow_disconnects += 1
                    _M_STREAM_OVERFLOW.labels(member_id).inc()
                    logger.warning(
                        "dropping outbound connection to %s: peer stopped "
                        "reading (%d bytes buffered > %d bound)",
                        member_id,
                        writer.transport.get_write_buffer_size(),
                        self.max_outbound_buffer_bytes)
                    if self._writers.get(member_id) is writer:
                        self._writers.pop(member_id, None)
                    writer.transport.abort()
                return
            except (ConnectionError, OSError):
                stale = self._writers.pop(member_id, None)
                if stale is not None:
                    try:  # release the dead transport's fd now, not at GC
                        stale.close()
                    except Exception:  # noqa: BLE001 — already broken
                        pass
                if attempt:  # peer really down: drop (Raft retries)
                    return
