"""Timers, message publish/correlation, and due-date checking.

Reference: engine/…/processing/timer/ (TriggerTimerProcessor, DueDateChecker
:19), processing/message/ (MessagePublishProcessor, MessageCorrelator,
MessageExpireProcessor, Message(Start)EventSubscription processors,
MessageObserver), message/command/SubscriptionCommandSender.java:43, and
job/JobTimeoutTrigger.java:21 + JobBackoffChecker.

Correlation is the reference's two-partition protocol even on one partition
(commands loop back): the process partition opens a PROCESS_MESSAGE_
SUBSCRIPTION and sends MESSAGE_SUBSCRIPTION CREATE to hash(correlationKey)'s
partition; publishing correlates there and sends PROCESS_MESSAGE_SUBSCRIPTION
CORRELATE back; completion acks with MESSAGE_SUBSCRIPTION CORRELATE.
"""

from __future__ import annotations

from typing import Callable

from zeebe_tpu_torch.engine.engine_state import EI_ACTIVATED, EngineState
from zeebe_tpu_torch.engine.writers import Writers
from zeebe_tpu_torch.logstreams import LoggedRecord
from zeebe_tpu_torch.parallel.partitioning import (
    InterPartitionCommandSender,
    subscription_partition_id,
)
from zeebe_tpu_torch.protocol import DEFAULT_TENANT, Record, RejectionType, ValueType, command
from zeebe_tpu_torch.protocol.enums import BpmnElementType
from zeebe_tpu_torch.protocol.intent import (
    JobIntent,
    MessageBatchIntent,
    MessageIntent,
    MessageStartEventSubscriptionIntent,
    MessageSubscriptionIntent,
    ProcessInstanceCreationIntent,
    ProcessInstanceIntent,
    ProcessMessageSubscriptionIntent,
    TimerIntent,
)

#: max message keys per MESSAGE_BATCH EXPIRE command — bounds the record size
#: like the reference's batch-size cap (MessageBatchExpireProcessor)
MESSAGE_EXPIRE_BATCH_MAX = 3000


class TimerProcessors:
    """TIMER TRIGGER / CANCEL commands."""

    def __init__(self, state: EngineState, clock_millis, bpmn) -> None:
        self.state = state
        self.clock_millis = clock_millis
        self.bpmn = bpmn

    def trigger(self, cmd: LoggedRecord, writers: Writers) -> None:
        key = cmd.record.key
        timer = self.state.timers.get(key)
        if timer is None:
            writers.respond_rejection(
                cmd, RejectionType.NOT_FOUND, f"timer {key} not found or already triggered"
            )
            return
        writers.append_event(key, ValueType.TIMER, TimerIntent.TRIGGERED, timer)

        element_instance_key = timer.get("elementInstanceKey", -1)
        target_element_id = timer["targetElementId"]
        if element_instance_key < 0:
            # timer start event: create a new process instance at that start
            self._trigger_start_event(timer, writers)
            return
        instance = self.state.element_instances.get(element_instance_key)
        if instance is None:
            return  # element already gone; TRIGGERED still recorded
        pi_value = instance["value"]
        exe = self.state.processes.executable(pi_value["processDefinitionKey"])
        target = exe.element(target_element_id)
        # routes to: the waiting catch event itself, an event-based gateway,
        # a boundary event, or an event sub-process start
        self.bpmn.route_trigger(element_instance_key, target_element_id, writers)
        # repeating timers (non-interrupting boundary / event sub-process
        # start with an R-cycle) reschedule themselves
        if target_element_id != pi_value["elementId"] and not target.interrupting:
            reps = timer.get("repetitions", 1)
            interval = timer.get("interval", -1)
            if (reps == -1 or reps > 1) and interval > 0:
                from zeebe_tpu_torch.engine.burst_templates import note_clock_value

                timer_key = self.state.next_key()
                due_date = self.clock_millis() + interval
                note_clock_value(due_date, interval)
                writers.append_event(
                    timer_key, ValueType.TIMER, TimerIntent.CREATED,
                    {
                        **timer,
                        "dueDate": due_date,
                        "repetitions": reps - 1 if reps > 0 else -1,
                    },
                )

    def _trigger_start_event(self, timer: dict, writers: Writers) -> None:
        meta = self.state.processes.get_by_key(timer["processDefinitionKey"])
        if meta is None:
            return
        writers.append_command(
            -1, ValueType.PROCESS_INSTANCE_CREATION, ProcessInstanceCreationIntent.CREATE,
            {
                "bpmnProcessId": meta["bpmnProcessId"],
                "processDefinitionKey": meta["processDefinitionKey"],
                "version": meta["version"],
                "variables": {},
                "startElementId": timer["targetElementId"],
                # the creation must address the definition's own tenant or the
                # cross-tenant key-lookup guard rejects it
                **({"tenantId": meta["tenantId"]}
                   if meta.get("tenantId", DEFAULT_TENANT) != DEFAULT_TENANT else {}),
            },
        )
        reps = timer.get("repetitions", 1)
        interval = timer.get("interval", -1)
        if (reps == -1 or reps > 1) and interval > 0:
            from zeebe_tpu_torch.engine.burst_templates import note_clock_value

            timer_key = self.state.next_key()
            due_date = self.clock_millis() + interval
            note_clock_value(due_date, interval)
            writers.append_event(
                timer_key, ValueType.TIMER, TimerIntent.CREATED,
                {
                    **timer,
                    "dueDate": due_date,
                    "repetitions": reps - 1 if reps > 0 else -1,
                },
            )

    def cancel(self, cmd: LoggedRecord, writers: Writers) -> None:
        timer = self.state.timers.get(cmd.record.key)
        if timer is None:
            return
        writers.append_event(cmd.record.key, ValueType.TIMER, TimerIntent.CANCELED, timer)


class MessageProcessors:
    """MESSAGE PUBLISH / EXPIRE on the message partition."""

    def __init__(
        self, state: EngineState, clock_millis, partition_count: int,
        sender: InterPartitionCommandSender,
    ) -> None:
        self.state = state
        self.clock_millis = clock_millis
        self.partition_count = partition_count
        self.sender = sender

    def publish(self, cmd: LoggedRecord, writers: Writers) -> None:
        value = cmd.record.value
        name = value.get("name", "")
        correlation_key = value.get("correlationKey", "")
        message_id = value.get("messageId", "") or ""
        ttl = value.get("timeToLive", 0)
        tenant = value.get("tenantId") or DEFAULT_TENANT
        from zeebe_tpu_torch.engine.processors import check_tenant_authorized

        if not check_tenant_authorized(cmd, tenant, writers):
            return
        if message_id and self.state.messages.is_id_taken(
                name, correlation_key, message_id, tenant):
            writers.respond_rejection(
                cmd, RejectionType.ALREADY_EXISTS,
                f"a message with id '{message_id}' is already published",
            )
            return
        key = self.state.next_key()
        deadline = self.clock_millis() + max(ttl, 0)
        published_value = {
            "name": name,
            "correlationKey": correlation_key,
            "messageId": message_id,
            "timeToLive": ttl,
            "variables": value.get("variables", {}),
            "deadline": deadline,
            **({"tenantId": tenant} if tenant != DEFAULT_TENANT else {}),
        }
        published = writers.append_event(
            key, ValueType.MESSAGE, MessageIntent.PUBLISHED, published_value
        )
        writers.respond(cmd, published)

        # correlate to open subscriptions of the SAME tenant (once per
        # process instance; reference: tenant-aware MessageSubscriptionState)
        for sub_key, sub in self.state.message_subscriptions.find(name, correlation_key):
            if sub.get("tenantId", DEFAULT_TENANT) != tenant:
                continue
            pi_key = sub.get("processInstanceKey", -1)
            if self.state.messages.was_correlated_to(key, pi_key):
                continue
            self._correlate(key, published_value, sub_key, sub, writers)

        # message start events (tenant-matched)
        for start_sub in self.state.message_start_subscriptions.find(name):
            if start_sub.get("tenantId", DEFAULT_TENANT) != tenant:
                continue
            writers.append_event(
                self.state.next_key(), ValueType.MESSAGE_START_EVENT_SUBSCRIPTION,
                MessageStartEventSubscriptionIntent.CORRELATED,
                {**start_sub, "messageKey": key, "correlationKey": correlation_key},
            )
            writers.append_command(
                -1, ValueType.PROCESS_INSTANCE_CREATION, ProcessInstanceCreationIntent.CREATE,
                {
                    "bpmnProcessId": start_sub["bpmnProcessId"],
                    "processDefinitionKey": start_sub["processDefinitionKey"],
                    "version": -1,
                    "variables": published_value["variables"],
                    "startElementId": start_sub["startEventId"],
                    **({"tenantId": tenant} if tenant != DEFAULT_TENANT else {}),
                },
            )

    def _correlate(self, message_key: int, message: dict, sub_key: int, sub: dict,
                   writers: Writers) -> None:
        _correlate_to_subscription(
            self.state, self.sender, message_key, message, sub_key, sub, writers
        )

    def expire(self, cmd: LoggedRecord, writers: Writers) -> None:
        key = cmd.record.key
        msg = self.state.messages.get(key)
        if msg is None:
            return
        writers.append_event(key, ValueType.MESSAGE, MessageIntent.EXPIRED, msg)

    def expire_batch(self, cmd: LoggedRecord, writers: Writers) -> None:
        """MESSAGE_BATCH EXPIRE: one EXPIRED event removes every named
        message still present — O(batches) records for an N-message backlog
        (reference: MessageBatchExpireProcessor.java; VERDICT r4 item 7)."""
        keys = cmd.record.value.get("messageKeys") or []
        still = [k for k in keys if self.state.messages.get(k) is not None]
        if not still:
            return
        writers.append_event(
            self.state.next_key(), ValueType.MESSAGE_BATCH,
            MessageBatchIntent.EXPIRED, {"messageKeys": still},
        )


def _correlate_to_subscription(
    state: EngineState, sender, message_key: int, message: dict,
    sub_key: int, sub: dict, writers: Writers,
) -> None:
    """Message-partition correlation: CORRELATING event + ship the CORRELATE
    command to the subscription's process partition."""
    writers.append_event(
        sub_key, ValueType.MESSAGE_SUBSCRIPTION, MessageSubscriptionIntent.CORRELATING,
        {**sub, "messageKey": message_key, "variables": message.get("variables", {})},
    )
    receiver = sub.get("subscriptionPartitionId", state.partition_id)
    correlate_cmd = command(
        ValueType.PROCESS_MESSAGE_SUBSCRIPTION,
        ProcessMessageSubscriptionIntent.CORRELATE,
        {
            "processInstanceKey": sub["processInstanceKey"],
            "elementInstanceKey": sub["elementInstanceKey"],
            "messageName": sub["messageName"],
            "correlationKey": sub["correlationKey"],
            "messageKey": message_key,
            "messageSubscriptionKey": sub_key,
            "variables": message.get("variables", {}),
            "subscriptionPartitionId": state.partition_id,
        },
        key=sub["elementInstanceKey"],
    )
    writers.after_commit(lambda: sender.send_command(receiver, correlate_cmd))


class MessageSubscriptionProcessors:
    """Message-partition side: CREATE (open) / CORRELATE (ack) / DELETE."""

    def __init__(self, state: EngineState, sender: InterPartitionCommandSender) -> None:
        self.state = state
        self.sender = sender

    def create(self, cmd: LoggedRecord, writers: Writers) -> None:
        value = dict(cmd.record.value)
        # the process partition pre-allocates the subscription key (it travels
        # in the command key) so it can later address deletes/acks
        sub_key = cmd.record.key if cmd.record.key >= 0 else self.state.next_key()
        writers.append_event(
            sub_key, ValueType.MESSAGE_SUBSCRIPTION, MessageSubscriptionIntent.CREATED, value
        )
        # an already-buffered message of the same tenant may correlate
        # immediately
        name, corr = value["messageName"], value["correlationKey"]
        tenant = value.get("tenantId", DEFAULT_TENANT)
        pi_key = value.get("processInstanceKey", -1)
        for message_key in self.state.messages.buffered_for(name, corr):
            if self.state.messages.was_correlated_to(message_key, pi_key):
                continue
            message = self.state.messages.get(message_key)
            if message.get("tenantId", DEFAULT_TENANT) != tenant:
                continue
            _correlate_to_subscription(
                self.state, self.sender, message_key, message, sub_key, value, writers
            )
            break

    def correlate_ack(self, cmd: LoggedRecord, writers: Writers) -> None:
        key = cmd.record.key
        sub = self.state.message_subscriptions.get(key)
        if sub is None:
            return
        writers.append_event(
            key, ValueType.MESSAGE_SUBSCRIPTION, MessageSubscriptionIntent.CORRELATED,
            {**sub, "messageKey": cmd.record.value.get("messageKey", -1)},
        )

    def delete(self, cmd: LoggedRecord, writers: Writers) -> None:
        key = cmd.record.key
        sub = self.state.message_subscriptions.get(key)
        if sub is None:
            return
        writers.append_event(key, ValueType.MESSAGE_SUBSCRIPTION, MessageSubscriptionIntent.DELETED, sub)


class ProcessMessageSubscriptionProcessors:
    """Process-partition side: CORRELATE completes the waiting element."""

    def __init__(self, state: EngineState, sender: InterPartitionCommandSender,
                 partition_count: int, bpmn) -> None:
        self.state = state
        self.sender = sender
        self.partition_count = partition_count
        self.bpmn = bpmn

    def correlate(self, cmd: LoggedRecord, writers: Writers) -> None:
        value = cmd.record.value
        element_key = value.get("elementInstanceKey", -1)
        name = value.get("messageName", "")
        sub = self.state.process_message_subscriptions.get(element_key, name)
        instance = self.state.element_instances.get(element_key)
        if sub is None or instance is None:
            # element gone (terminated/completed); the subscription-close path
            # already sent the delete — at-least-once semantics
            return
        writers.append_event(
            element_key, ValueType.PROCESS_MESSAGE_SUBSCRIPTION,
            ProcessMessageSubscriptionIntent.CORRELATED,
            {**sub, "messageKey": value.get("messageKey", -1)},
        )
        # message variables merge into the process instance scope
        pi_value = instance["value"]
        from zeebe_tpu_torch.protocol.intent import VariableIntent

        for var_name, var_value in (value.get("variables") or {}).items():
            var_key = self.state.next_key()
            target_scope = (
                self.state.variables.find_scope_with(element_key, var_name)
                or pi_value["processInstanceKey"]
            )
            exists = self.state.variables.has_local(target_scope, var_name)
            writers.append_event(
                var_key, ValueType.VARIABLE,
                VariableIntent.UPDATED if exists else VariableIntent.CREATED,
                {
                    "name": var_name, "value": var_value, "scopeKey": target_scope,
                    "processInstanceKey": pi_value["processInstanceKey"],
                    "processDefinitionKey": pi_value["processDefinitionKey"],
                    "bpmnProcessId": pi_value["bpmnProcessId"],
                },
            )

        target_element_id = sub.get("targetElementId", pi_value["elementId"])
        # routes to: the waiting catch element, an event-based gateway, a
        # boundary event, or an event sub-process start
        self.bpmn.route_trigger(element_key, target_element_id, writers)

        # ack to the message partition so the (single-use) subscription closes
        message_sub_key = value.get("messageSubscriptionKey", -1)
        if message_sub_key >= 0:
            message_partition = subscription_partition_id(
                sub["correlationKey"], self.partition_count
            )
            ack = command(
                ValueType.MESSAGE_SUBSCRIPTION, MessageSubscriptionIntent.CORRELATE,
                {"messageKey": value.get("messageKey", -1)},
                key=message_sub_key,
            )
            writers.after_commit(
                lambda: self.sender.send_command(message_partition, ack)
            )


class DueDateCheckers:
    """Schedules and runs the due-date sweeps: timers, message TTL, job
    deadlines, job retry backoff (reference: DueDateChecker, MessageObserver,
    JobTimeoutTrigger, JobBackoffChecker). Wired by the harness/broker pump:
    call ``reschedule()`` after every processing batch.

    Scheduling rides the hierarchical timer wheel (engine/timer_wheel.py,
   : the wheel is rebuilt from the due-date indexes at construction
    (every partition transition builds fresh checkers) and fed afterwards by
    the ``ZbDb.note_due`` seam, so ``reschedule()`` is a constant-time wheel
    probe instead of four index scans per processing batch. The wheel only
    over-approximates (lazy cancellation, rolled-back inserts); the sweep
    itself re-verifies against the sorted state indexes with range-bounded
    O(due) scans — state stays the single source of truth."""

    def __init__(self, engine_state: EngineState, schedule_service,
                 clock_millis) -> None:
        from zeebe_tpu_torch.engine.timer_wheel import DueDateWheel

        self.state = engine_state
        self.schedule = schedule_service
        self.clock_millis = clock_millis
        self._handle = None
        self._scheduled_due: int | None = None
        self.wheel = DueDateWheel(clock_millis,
                                  partition_id=engine_state.partition_id)
        self.wheel.rebuild(engine_state)
        engine_state.db.due_listener = self.wheel.note_due

    def _next_due(self) -> int | None:
        """The state-index next-due probe (kept as the test oracle for the
        wheel's never-late property; O(log n) per index since."""
        with self.state.db.transaction():
            candidates = [
                self.state.timers.next_due(),
                self.state.messages.next_deadline(),
                self.state.jobs.next_deadline(),
                self.state.jobs.next_backoff(),
            ]
        due = [c for c in candidates if c is not None]
        return min(due) if due else None

    def maybe_advance_wheel(self, now_ms: int) -> None:
        """Follower-side wheel hygiene: drop deadlines the leader has long
        since swept (replay feeds the wheel on followers too). Throttled —
        one advance per second of stream clock."""
        if now_ms - self._last_follower_advance_ms >= 1000:
            self._last_follower_advance_ms = now_ms
            self.wheel.advance(now_ms)

    _last_follower_advance_ms = 0

    def reschedule(self) -> None:
        due = self.wheel.next_due()
        if due == self._scheduled_due and self._handle is not None \
                and not self._handle.cancelled:
            return  # already armed for exactly this instant
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
        self._scheduled_due = due
        if due is not None:
            self._handle = self.schedule.run_at(due, self._sweep)

    def _sweep(self) -> list[Record]:
        now = self.clock_millis()
        # the wheel entries this sweep covers are spent: drop them and
        # cascade entered coarse buckets (stale/canceled entries die here
        # too — their only cost was this sweep looking)
        self.wheel.advance(now)
        self._scheduled_due = None
        commands: list[Record] = []
        with self.state.db.transaction():
            for timer_key, _timer in self.state.timers.due_timers(now):
                commands.append(
                    command(ValueType.TIMER, TimerIntent.TRIGGER, {}, key=timer_key)
                )
            # batched expiry: ONE MESSAGE_BATCH command expires the whole due
            # backlog (chunked to bound record size) — per-message EXPIRE is
            # exactly the per-record overhead this framework exists to kill
            # (reference: protocol.xml MESSAGE_BATCH,
            # MessageBatchExpireProcessor.java)
            expired_keys = [mk for _d, mk in self.state.messages.expired(now)]
            for i in range(0, len(expired_keys), MESSAGE_EXPIRE_BATCH_MAX):
                commands.append(
                    command(ValueType.MESSAGE_BATCH, MessageBatchIntent.EXPIRE,
                            {"messageKeys":
                             expired_keys[i:i + MESSAGE_EXPIRE_BATCH_MAX]})
                )
            for job_key in self.state.jobs.expired_deadlines(now):
                commands.append(
                    command(ValueType.JOB, JobIntent.TIME_OUT, {}, key=job_key)
                )
            for until, job_key in self.state.jobs.backoff_due(now):
                commands.append(
                    command(ValueType.JOB, JobIntent.RECUR_AFTER_BACKOFF,
                            {"recurAt": until}, key=job_key)
                )
        return commands
