"""SWIM-lite cluster membership with property gossip.

Reference: atomix/cluster/src/main/java/io/atomix/cluster/protocol/
SwimMembershipProtocol.java:67 — probe/suspect/alive states with incarnation
numbers, bootstrap member discovery (BootstrapDiscoveryProvider), and broadcast
of member properties (BrokerInfo rides these properties to the gateway,
gateway/impl/broker/BrokerTopologyManager).

Deterministic design: the protocol advances on explicit ``tick(now_millis)``
calls and reacts to delivered messages — no internal threads — so it runs
identically under the loopback test network and the TCP backend (driven by a
periodic timer there).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable

from zeebe_tpu_torch.cluster.messaging import MessagingService

PROBE_TOPIC = "swim-probe"
ACK_TOPIC = "swim-ack"
GOSSIP_TOPIC = "swim-gossip"

PROBE_INTERVAL_MS = 1_000
SUSPECT_TIMEOUT_MS = 3_000
DEAD_TIMEOUT_MS = 10_000


class MemberState(enum.Enum):
    ALIVE = "alive"
    SUSPECT = "suspect"
    DEAD = "dead"


@dataclass
class Member:
    member_id: str
    state: MemberState = MemberState.ALIVE
    incarnation: int = 0
    properties: dict[str, Any] = field(default_factory=dict)
    last_heard_ms: int = 0


class MembershipService:
    """One instance per node; all nodes bootstrap from the same seed list."""

    def __init__(self, messaging: MessagingService, seed_members: list[str],
                 clock_millis: Callable[[], int]) -> None:
        self.messaging = messaging
        self.member_id = messaging.member_id
        self.clock_millis = clock_millis
        self.incarnation = 0
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        self._m_incarnation = REGISTRY.gauge(
            "smp_members_incarnation_number",
            "this member's SWIM incarnation number", ("member",)
        ).labels(self.member_id)
        self.properties: dict[str, Any] = {}
        self.members: dict[str, Member] = {
            m: Member(m, last_heard_ms=clock_millis()) for m in seed_members
        }
        self.members.setdefault(self.member_id, Member(self.member_id))
        self._listeners: list[Callable[[Member], None]] = []
        self._probe_rr = 0
        self._last_probe_ms = clock_millis()
        messaging.subscribe(PROBE_TOPIC, self._on_probe)
        messaging.subscribe(ACK_TOPIC, self._on_ack)
        messaging.subscribe(GOSSIP_TOPIC, self._on_gossip)

    # -- public API -----------------------------------------------------------

    def add_listener(self, listener: Callable[[Member], None]) -> None:
        self._listeners.append(listener)

    def set_property(self, key: str, value: Any) -> None:
        """Property changes bump the incarnation and gossip immediately
        (BrokerInfo updates propagate this way)."""
        self.properties[key] = value
        self.incarnation += 1
        self._m_incarnation.set(self.incarnation)
        self._broadcast_gossip()

    def alive_members(self) -> list[Member]:
        return [m for m in self.members.values() if m.state == MemberState.ALIVE]

    def get(self, member_id: str) -> Member | None:
        return self.members.get(member_id)

    # -- protocol -------------------------------------------------------------

    def tick(self, now_millis: int | None = None) -> None:
        now = self.clock_millis() if now_millis is None else now_millis
        if now - self._last_probe_ms >= PROBE_INTERVAL_MS:
            self._last_probe_ms = now
            self._probe_next(now)
        for member in self.members.values():
            if member.member_id == self.member_id:
                continue
            silent = now - member.last_heard_ms
            if member.state == MemberState.ALIVE and silent > SUSPECT_TIMEOUT_MS:
                self._transition(member, MemberState.SUSPECT)
            elif member.state == MemberState.SUSPECT and silent > DEAD_TIMEOUT_MS:
                self._transition(member, MemberState.DEAD)

    def _probe_next(self, now: int) -> None:
        others = sorted(m for m in self.members if m != self.member_id)
        if not others:
            return
        target = others[self._probe_rr % len(others)]
        self._probe_rr += 1
        self.messaging.send(target, PROBE_TOPIC, self._digest())

    def _digest(self) -> dict:
        return {
            "incarnation": self.incarnation,
            "properties": self.properties,
            "members": {
                m.member_id: {"state": m.state.value, "incarnation": m.incarnation}
                for m in self.members.values()
            },
        }

    def _on_probe(self, sender: str, payload: dict) -> None:
        self._heard_from(sender, payload)
        self.messaging.send(sender, ACK_TOPIC, self._digest())

    def _on_ack(self, sender: str, payload: dict) -> None:
        self._heard_from(sender, payload)

    def _on_gossip(self, sender: str, payload: dict) -> None:
        self._heard_from(sender, payload)

    def _heard_from(self, sender: str, digest: dict) -> None:
        now = self.clock_millis()
        member = self.members.setdefault(sender, Member(sender))
        member.last_heard_ms = now
        inc = digest.get("incarnation", 0)
        if inc >= member.incarnation:
            member.incarnation = inc
            member.properties = dict(digest.get("properties", {}))
        if member.state != MemberState.ALIVE:
            self._transition(member, MemberState.ALIVE)
        # refute rumors about ourselves with a higher incarnation (SWIM)
        rumored = digest.get("members", {}).get(self.member_id)
        if rumored and rumored.get("state") != MemberState.ALIVE.value:
            self.incarnation = max(self.incarnation, rumored.get("incarnation", 0)) + 1
            self._m_incarnation.set(self.incarnation)
            self._broadcast_gossip()

    def _broadcast_gossip(self) -> None:
        for m in self.members:
            if m != self.member_id:
                self.messaging.send(m, GOSSIP_TOPIC, self._digest())

    def _transition(self, member: Member, state: MemberState) -> None:
        if member.state is state:
            return
        member.state = state
        for listener in self._listeners:
            listener(member)
