"""Generalized command distribution across partitions.

Reference: engine/src/main/java/io/camunda/zeebe/engine/processing/distribution/
CommandDistributionBehavior.java and docs/generalized_distribution.md:1-80 —
lifecycle STARTED → DISTRIBUTING (per target partition) → receiver processes
the same command → ACKNOWLEDGE back to origin → ACKNOWLEDGED → FINISHED when
every target acked. CommandRedistributor (distribution/CommandRedistributor.java)
retries pending sends forever; receiver dedup keeps the retries idempotent.

The distribution key carries the origin partition in its high bits
(protocol keys), so the receiver knows where to send the ACKNOWLEDGE.
"""

from __future__ import annotations

from typing import Callable, Iterable

from zeebe_tpu_torch.engine.engine_state import EngineState
from zeebe_tpu_torch.engine.writers import Writers
from zeebe_tpu_torch.logstreams import LoggedRecord
from zeebe_tpu_torch.protocol import ValueType, command
from zeebe_tpu_torch.protocol.intent import CommandDistributionIntent, Intent
from zeebe_tpu_torch.protocol.keys import decode_partition_id

# retry cadence for pending distributions (reference: COMMAND_REDISTRIBUTION_INTERVAL,
# CommandRedistributor.java — 10s fixed interval with backoff multiplier)
REDISTRIBUTION_INTERVAL_MS = 10_000


class CommandDistributionBehavior:
    """Origin-side fan-out of a command to every other partition."""

    def __init__(self, state: EngineState, partition_count: int, sender,
                 clock_millis=None) -> None:
        self.state = state
        self.partition_count = partition_count
        self.sender = sender
        self.clock_millis = clock_millis or (lambda: 0)

    def other_partitions(self) -> list[int]:
        return [
            p for p in range(1, self.partition_count + 1)
            if p != self.state.partition_id
        ]

    def distribute(
        self,
        writers: Writers,
        distribution_key: int,
        value_type: ValueType,
        intent: Intent,
        value: dict,
        targets: Iterable[int] | None = None,
    ) -> bool:
        """Start distributing ``(value_type, intent, value)``; returns False when
        there is nobody to distribute to (single-partition deployments complete
        immediately — the caller writes its own terminal event)."""
        target_list = list(targets) if targets is not None else self.other_partitions()
        if not target_list:
            return False
        dist_value = {
            "partitionId": self.state.partition_id,
            "valueType": int(value_type),
            "intent": int(intent),
            "commandValue": dict(value),
        }
        writers.append_event(
            distribution_key, ValueType.COMMAND_DISTRIBUTION,
            CommandDistributionIntent.STARTED, dist_value,
        )
        for partition in target_list:
            writers.append_event(
                distribution_key, ValueType.COMMAND_DISTRIBUTION,
                CommandDistributionIntent.DISTRIBUTING,
                {**dist_value, "partitionId": partition},
            )
            self._send(writers, distribution_key, partition, value_type, intent, value)
        return True

    def _send(self, writers: Writers, distribution_key: int, partition: int,
              value_type: ValueType, intent: Intent, value: dict) -> None:
        rec = command(value_type, intent, dict(value), key=distribution_key)
        sender = self.sender

        def push() -> None:
            sender.send_command(partition, rec)

        writers.after_commit(push)

    # -- receiver side --------------------------------------------------------

    def is_distributed_command(self, cmd: LoggedRecord) -> bool:
        """A command whose key was minted on another partition arrived via
        distribution (reference: receiver dedups via the key's partition bits)."""
        key = cmd.record.key
        return key > 0 and decode_partition_id(key) != self.state.partition_id

    def was_received(self, distribution_key: int) -> bool:
        return self.state.distribution.was_received(distribution_key)

    def handle_distributed(self, cmd: LoggedRecord, writers: Writers,
                           on_first_receive: Callable[[], None]) -> None:
        """The whole receiver-side contract in one place: run the work exactly
        once per distribution key (dedup on retried sends), always ACKNOWLEDGE.
        Every distributed value type routes through this helper so none can
        forget the was_received check."""
        if not self.was_received(cmd.record.key):
            on_first_receive()
        self.acknowledge_after_commit(writers, cmd)

    def acknowledge_after_commit(self, writers: Writers, cmd: LoggedRecord) -> None:
        """Receiver: mark the distribution processed and ACKNOWLEDGE to origin."""
        distribution_key = cmd.record.key
        origin = decode_partition_id(distribution_key)
        writers.append_event(
            distribution_key, ValueType.COMMAND_DISTRIBUTION,
            CommandDistributionIntent.ACKNOWLEDGED,
            {"partitionId": self.state.partition_id, "valueType": int(cmd.record.value_type),
             "intent": int(cmd.record.intent), "commandValue": {}, "received": True,
             # processor-side clock baked into the event so replay purges the
             # dedup marker index identically (same pattern as timer dueDate)
             "receivedAt": self.clock_millis()},
        )
        ack = command(
            ValueType.COMMAND_DISTRIBUTION, CommandDistributionIntent.ACKNOWLEDGE,
            {"partitionId": self.state.partition_id},
            key=distribution_key,
        )
        sender = self.sender

        def push() -> None:
            sender.send_command(origin, ack)

        writers.after_commit(push)


class CommandDistributionAcknowledgeProcessor:
    """Origin: COMMAND_DISTRIBUTION ACKNOWLEDGE → ACKNOWLEDGED; FINISHED once
    every target partition acked; runs the per-value-type completion hook
    (e.g. Deployment FULLY_DISTRIBUTED)."""

    def __init__(self, state: EngineState) -> None:
        self.state = state
        # value_type(int) → hook(writers, distribution_key, stored_distribution)
        self.completion_hooks: dict[int, Callable[[Writers, int, dict], None]] = {}

    def on_finished(self, value_type: ValueType, hook: Callable[[Writers, int, dict], None]) -> None:
        self.completion_hooks[int(value_type)] = hook

    def process(self, cmd: LoggedRecord, writers: Writers) -> None:
        distribution_key = cmd.record.key
        partition = cmd.record.value.get("partitionId", -1)
        stored = self.state.distribution.get(distribution_key)
        if stored is None or not self.state.distribution.is_pending(distribution_key, partition):
            return  # duplicate ack after retry: already acknowledged
        writers.append_event(
            distribution_key, ValueType.COMMAND_DISTRIBUTION,
            CommandDistributionIntent.ACKNOWLEDGED,
            {"partitionId": partition, "valueType": stored["valueType"],
             "intent": stored["intent"], "commandValue": {}},
        )
        if self.state.distribution.none_pending(distribution_key):
            writers.append_event(
                distribution_key, ValueType.COMMAND_DISTRIBUTION,
                CommandDistributionIntent.FINISHED,
                {"partitionId": self.state.partition_id, "valueType": stored["valueType"],
                 "intent": stored["intent"], "commandValue": {}},
            )
            hook = self.completion_hooks.get(stored["valueType"])
            if hook is not None:
                hook(writers, distribution_key, stored)


class CommandRedistributor:
    """Periodic resend of every still-pending distribution (at-least-once;
    reference: distribution/CommandRedistributor.java — retries forever)."""

    def __init__(self, state: EngineState, sender, schedule_service, clock_millis) -> None:
        self.state = state
        self.sender = sender
        self.schedule = schedule_service
        self.clock_millis = clock_millis
        self._handle = None

    def reschedule(self) -> None:
        """Idempotent: an already-armed retry deadline is left in place so
        frequent pumps cannot starve the fixed retry interval."""
        if self._handle is not None:
            return
        with self.state.db.transaction():
            pending = self.state.distribution.has_any_pending()
        if pending:
            self._handle = self.schedule.run_at(
                self.clock_millis() + REDISTRIBUTION_INTERVAL_MS, self._resend_all
            )

    def _resend_all(self) -> list:
        self._handle = None
        with self.state.db.transaction():
            pending = [
                (key, partition, self.state.distribution.get(key))
                for key, partition in self.state.distribution.all_pending()
            ]
        for distribution_key, partition, stored in pending:
            if stored is None:
                continue
            value_type = ValueType(stored["valueType"])
            intent_cls = Intent.for_value_type(value_type)
            rec = command(
                value_type, intent_cls(stored["intent"]),
                dict(stored["commandValue"]), key=distribution_key,
            )
            self.sender.send_command(partition, rec)
        self.reschedule()
        return []
