"""Intent enums — the verb of every record (reference: protocol/src/main/java/io/
camunda/zeebe/protocol/record/intent/*.java, 32 enums).

Each ValueType has an Intent enum; commands use imperative intents (CREATE,
COMPLETE), events use past/progressive intents (CREATED, ELEMENT_ACTIVATING).
Integer codes are wire format and device opcodes — append-only.

``Intent.for_value_type`` maps a ValueType to its intent enum so records can be
decoded generically.
"""

from __future__ import annotations

import enum

from zeebe_tpu_torch.protocol.enums import ValueType

try:
    _nonmember = enum.nonmember
except AttributeError:  # Python < 3.11
    class _NonMember:
        """Descriptor stand-in for enum.nonmember, local to this module (the
        stdlib is not patched): the EnumDict skips descriptors when
        collecting members, and attribute access unwraps to the original
        value — the same observable behavior the declarations below rely on."""

        __slots__ = ("_value",)

        def __init__(self, value):
            self._value = value

        def __get__(self, obj, objtype=None):
            return self._value

    _nonmember = _NonMember


class Intent(enum.IntEnum):
    """Base class marker; all concrete intents subclass this via IntEnum idiom."""

    @classmethod
    def for_value_type(cls, value_type: ValueType) -> type["Intent"]:
        try:
            return _INTENTS_BY_VALUE_TYPE[value_type]
        except KeyError:
            raise ValueError(f"no intent enum for value type {value_type!r}") from None

    @property
    def is_event(self) -> bool:
        """True if this intent names a state change (event), not a request (command)."""
        return self.name in type(self)._EVENT_NAMES  # type: ignore[attr-defined]


class ProcessInstanceIntent(Intent):
    """Element lifecycle (reference: intent/ProcessInstanceIntent.java).

    Commands ACTIVATE/COMPLETE/TERMINATE_ELEMENT drive the BPMN state machine;
    ELEMENT_* events record lifecycle transitions; SEQUENCE_FLOW_TAKEN records
    token movement.
    """

    CANCEL = 0
    SEQUENCE_FLOW_TAKEN = 1
    ELEMENT_ACTIVATING = 2
    ELEMENT_ACTIVATED = 3
    ELEMENT_COMPLETING = 4
    ELEMENT_COMPLETED = 5
    ELEMENT_TERMINATING = 6
    ELEMENT_TERMINATED = 7
    ACTIVATE_ELEMENT = 8
    COMPLETE_ELEMENT = 9
    TERMINATE_ELEMENT = 10

    _EVENT_NAMES = _nonmember(frozenset(
        {
            "SEQUENCE_FLOW_TAKEN",
            "ELEMENT_ACTIVATING",
            "ELEMENT_ACTIVATED",
            "ELEMENT_COMPLETING",
            "ELEMENT_COMPLETED",
            "ELEMENT_TERMINATING",
            "ELEMENT_TERMINATED",
        }
    ))


class ProcessInstanceCreationIntent(Intent):
    CREATE = 0
    CREATED = 1
    CREATE_WITH_AWAITING_RESULT = 2

    _EVENT_NAMES = _nonmember(frozenset({"CREATED"}))


class ProcessInstanceResultIntent(Intent):
    COMPLETED = 0

    _EVENT_NAMES = _nonmember(frozenset({"COMPLETED"}))


class ProcessInstanceModificationIntent(Intent):
    MODIFY = 0
    MODIFIED = 1

    _EVENT_NAMES = _nonmember(frozenset({"MODIFIED"}))


class ProcessInstanceMigrationIntent(Intent):
    MIGRATE = 0
    MIGRATED = 1

    _EVENT_NAMES = _nonmember(frozenset({"MIGRATED"}))


class ProcessInstanceBatchIntent(Intent):
    ACTIVATE = 0
    ACTIVATED = 1
    TERMINATE = 2
    TERMINATED = 3

    _EVENT_NAMES = _nonmember(frozenset({"ACTIVATED", "TERMINATED"}))


class JobIntent(Intent):
    """Job lifecycle (reference: intent/JobIntent.java)."""

    CREATED = 0
    COMPLETE = 1
    COMPLETED = 2
    TIME_OUT = 3
    TIMED_OUT = 4
    FAIL = 5
    FAILED = 6
    UPDATE_RETRIES = 7
    RETRIES_UPDATED = 8
    CANCEL = 9
    CANCELED = 10
    THROW_ERROR = 11
    ERROR_THROWN = 12
    RECUR_AFTER_BACKOFF = 13
    RECURRED_AFTER_BACKOFF = 14
    YIELD = 15
    YIELDED = 16
    UPDATE_TIMEOUT = 17
    TIMEOUT_UPDATED = 18

    _EVENT_NAMES = _nonmember(frozenset(
        {
            "CREATED",
            "COMPLETED",
            "TIMED_OUT",
            "FAILED",
            "RETRIES_UPDATED",
            "CANCELED",
            "ERROR_THROWN",
            "RECURRED_AFTER_BACKOFF",
            "YIELDED",
            "TIMEOUT_UPDATED",
        }
    ))


class JobBatchIntent(Intent):
    ACTIVATE = 0
    ACTIVATED = 1

    _EVENT_NAMES = _nonmember(frozenset({"ACTIVATED"}))


class DeploymentIntent(Intent):
    CREATE = 0
    CREATED = 1
    DISTRIBUTE = 2
    DISTRIBUTED = 3
    FULLY_DISTRIBUTED = 4

    _EVENT_NAMES = _nonmember(frozenset({"CREATED", "DISTRIBUTED", "FULLY_DISTRIBUTED"}))


class DeploymentDistributionIntent(Intent):
    DISTRIBUTING = 0
    COMPLETE = 1
    COMPLETED = 2

    _EVENT_NAMES = _nonmember(frozenset({"DISTRIBUTING", "COMPLETED"}))


class ProcessIntent(Intent):
    CREATED = 0
    DELETING = 1
    DELETED = 2

    _EVENT_NAMES = _nonmember(frozenset({"CREATED", "DELETING", "DELETED"}))


class MessageIntent(Intent):
    PUBLISH = 0
    PUBLISHED = 1
    EXPIRE = 2
    EXPIRED = 3

    _EVENT_NAMES = _nonmember(frozenset({"PUBLISHED", "EXPIRED"}))


class MessageBatchIntent(Intent):
    """One record expiring N messages (reference: protocol.xml:52
    MESSAGE_BATCH, engine/…/message/MessageBatchExpireProcessor.java) — the
    TTL sweep plans one batch command instead of per-message EXPIREs."""

    EXPIRE = 0
    EXPIRED = 1

    _EVENT_NAMES = _nonmember(frozenset({"EXPIRED"}))


class MessageSubscriptionIntent(Intent):
    CREATE = 0
    CREATED = 1
    CORRELATING = 2
    CORRELATE = 3
    CORRELATED = 4
    REJECT = 5
    REJECTED = 6
    DELETE = 7
    DELETED = 8

    _EVENT_NAMES = _nonmember(frozenset({"CREATED", "CORRELATING", "CORRELATED", "REJECTED", "DELETED"}))


class ProcessMessageSubscriptionIntent(Intent):
    CREATING = 0
    CREATE = 1
    CREATED = 2
    CORRELATE = 3
    CORRELATED = 4
    DELETING = 5
    DELETE = 6
    DELETED = 7

    _EVENT_NAMES = _nonmember(frozenset({"CREATING", "CREATED", "CORRELATED", "DELETING", "DELETED"}))


class MessageStartEventSubscriptionIntent(Intent):
    CREATED = 0
    CORRELATED = 1
    DELETED = 2

    _EVENT_NAMES = _nonmember(frozenset({"CREATED", "CORRELATED", "DELETED"}))


class TimerIntent(Intent):
    CREATED = 0
    TRIGGER = 1
    TRIGGERED = 2
    CANCELED = 3

    _EVENT_NAMES = _nonmember(frozenset({"CREATED", "TRIGGERED", "CANCELED"}))


class IncidentIntent(Intent):
    CREATED = 0
    RESOLVE = 1
    RESOLVED = 2

    _EVENT_NAMES = _nonmember(frozenset({"CREATED", "RESOLVED"}))


class VariableIntent(Intent):
    CREATED = 0
    UPDATED = 1
    MIGRATED = 2

    _EVENT_NAMES = _nonmember(frozenset({"CREATED", "UPDATED", "MIGRATED"}))


class VariableDocumentIntent(Intent):
    UPDATE = 0
    UPDATED = 1

    _EVENT_NAMES = _nonmember(frozenset({"UPDATED"}))


class ErrorIntent(Intent):
    CREATED = 0

    _EVENT_NAMES = _nonmember(frozenset({"CREATED"}))


class ProcessEventIntent(Intent):
    TRIGGERING = 0
    TRIGGERED = 1

    _EVENT_NAMES = _nonmember(frozenset({"TRIGGERING", "TRIGGERED"}))


class DecisionIntent(Intent):
    CREATED = 0
    DELETED = 1

    _EVENT_NAMES = _nonmember(frozenset({"CREATED", "DELETED"}))


class DecisionRequirementsIntent(Intent):
    CREATED = 0
    DELETED = 1

    _EVENT_NAMES = _nonmember(frozenset({"CREATED", "DELETED"}))


class DecisionEvaluationIntent(Intent):
    EVALUATED = 0
    FAILED = 1
    EVALUATE = 2  # standalone evaluation command (gateway EvaluateDecision rpc)

    _EVENT_NAMES = _nonmember(frozenset({"EVALUATED", "FAILED"}))


class EscalationIntent(Intent):
    ESCALATED = 0
    NOT_ESCALATED = 1

    _EVENT_NAMES = _nonmember(frozenset({"ESCALATED", "NOT_ESCALATED"}))


class SignalIntent(Intent):
    BROADCAST = 0
    BROADCASTED = 1

    _EVENT_NAMES = _nonmember(frozenset({"BROADCASTED"}))


class SignalSubscriptionIntent(Intent):
    CREATED = 0
    DELETED = 1

    _EVENT_NAMES = _nonmember(frozenset({"CREATED", "DELETED"}))


class ResourceDeletionIntent(Intent):
    DELETE = 0
    DELETING = 1
    DELETED = 2

    _EVENT_NAMES = _nonmember(frozenset({"DELETING", "DELETED"}))


class CommandDistributionIntent(Intent):
    """Generalized command distribution lifecycle (reference:
    docs/generalized_distribution.md, intent/CommandDistributionIntent.java)."""

    STARTED = 0
    DISTRIBUTING = 1
    ACKNOWLEDGE = 2
    ACKNOWLEDGED = 3
    FINISHED = 4

    _EVENT_NAMES = _nonmember(frozenset({"STARTED", "DISTRIBUTING", "ACKNOWLEDGED", "FINISHED"}))


class CheckpointIntent(Intent):
    CREATE = 0
    CREATED = 1
    IGNORED = 2

    _EVENT_NAMES = _nonmember(frozenset({"CREATED", "IGNORED"}))


class FormIntent(Intent):
    CREATED = 0
    DELETED = 1

    _EVENT_NAMES = _nonmember(frozenset({"CREATED", "DELETED"}))


class UserTaskIntent(Intent):
    CREATING = 0
    CREATED = 1
    COMPLETE = 2
    COMPLETING = 3
    COMPLETED = 4
    CANCELING = 5
    CANCELED = 6
    ASSIGN = 7
    ASSIGNING = 8
    ASSIGNED = 9
    CLAIM = 10
    UPDATE = 11
    UPDATING = 12
    UPDATED = 13

    _EVENT_NAMES = _nonmember(frozenset(
        {
            "CREATING",
            "CREATED",
            "COMPLETING",
            "COMPLETED",
            "CANCELING",
            "CANCELED",
            "ASSIGNING",
            "ASSIGNED",
            "UPDATING",
            "UPDATED",
        }
    ))


_INTENTS_BY_VALUE_TYPE: dict[ValueType, type[Intent]] = {
    ValueType.PROCESS_INSTANCE_MIGRATION: ProcessInstanceMigrationIntent,
    ValueType.JOB: JobIntent,
    ValueType.DEPLOYMENT: DeploymentIntent,
    ValueType.PROCESS_INSTANCE: ProcessInstanceIntent,
    ValueType.INCIDENT: IncidentIntent,
    ValueType.MESSAGE: MessageIntent,
    ValueType.MESSAGE_BATCH: MessageBatchIntent,
    ValueType.MESSAGE_SUBSCRIPTION: MessageSubscriptionIntent,
    ValueType.PROCESS_MESSAGE_SUBSCRIPTION: ProcessMessageSubscriptionIntent,
    ValueType.JOB_BATCH: JobBatchIntent,
    ValueType.TIMER: TimerIntent,
    ValueType.MESSAGE_START_EVENT_SUBSCRIPTION: MessageStartEventSubscriptionIntent,
    ValueType.VARIABLE: VariableIntent,
    ValueType.VARIABLE_DOCUMENT: VariableDocumentIntent,
    ValueType.PROCESS_INSTANCE_CREATION: ProcessInstanceCreationIntent,
    ValueType.ERROR: ErrorIntent,
    ValueType.PROCESS: ProcessIntent,
    ValueType.DEPLOYMENT_DISTRIBUTION: DeploymentDistributionIntent,
    ValueType.PROCESS_EVENT: ProcessEventIntent,
    ValueType.DECISION: DecisionIntent,
    ValueType.DECISION_REQUIREMENTS: DecisionRequirementsIntent,
    ValueType.DECISION_EVALUATION: DecisionEvaluationIntent,
    ValueType.PROCESS_INSTANCE_MODIFICATION: ProcessInstanceModificationIntent,
    ValueType.ESCALATION: EscalationIntent,
    ValueType.SIGNAL: SignalIntent,
    ValueType.SIGNAL_SUBSCRIPTION: SignalSubscriptionIntent,
    ValueType.RESOURCE_DELETION: ResourceDeletionIntent,
    ValueType.COMMAND_DISTRIBUTION: CommandDistributionIntent,
    ValueType.PROCESS_INSTANCE_BATCH: ProcessInstanceBatchIntent,
    ValueType.CHECKPOINT: CheckpointIntent,
    ValueType.FORM: FormIntent,
    ValueType.USER_TASK: UserTaskIntent,
    ValueType.PROCESS_INSTANCE_RESULT: ProcessInstanceResultIntent,
}
