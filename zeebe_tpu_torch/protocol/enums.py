"""Protocol enums: record types, value types, rejection types, element types.

Mirrors the reference protocol module (reference: protocol/src/main/java/io/camunda/
zeebe/protocol/record/{RecordType,ValueType,RejectionType}.java and
value/BpmnElementType.java). Enum integer codes are part of this framework's wire
format (they also index device-side opcode tables in zeebe_tpu_torch.ops), so they are
append-only: never renumber.
"""

from __future__ import annotations

import enum


class RecordType(enum.IntEnum):
    """Kind of a record on the stream (reference: record/RecordType.java)."""

    NULL_VAL = 0
    COMMAND = 1
    EVENT = 2
    COMMAND_REJECTION = 3


class ValueType(enum.IntEnum):
    """Discriminator for the record value payload (reference: record/ValueType.java).

    One entry per record value schema; the (RecordType, ValueType, Intent) triple
    selects the processor in the engine's RecordProcessorMap.
    """

    NULL_VAL = 0
    JOB = 1
    DEPLOYMENT = 2
    PROCESS_INSTANCE = 3
    INCIDENT = 4
    MESSAGE = 5
    MESSAGE_SUBSCRIPTION = 6
    PROCESS_MESSAGE_SUBSCRIPTION = 7
    JOB_BATCH = 8
    TIMER = 9
    MESSAGE_START_EVENT_SUBSCRIPTION = 10
    VARIABLE = 11
    VARIABLE_DOCUMENT = 12
    PROCESS_INSTANCE_CREATION = 13
    ERROR = 14
    PROCESS = 15
    DEPLOYMENT_DISTRIBUTION = 16
    PROCESS_EVENT = 17
    DECISION = 18
    DECISION_REQUIREMENTS = 19
    DECISION_EVALUATION = 20
    PROCESS_INSTANCE_MODIFICATION = 21
    ESCALATION = 22
    SIGNAL = 23
    SIGNAL_SUBSCRIPTION = 24
    RESOURCE_DELETION = 25
    COMMAND_DISTRIBUTION = 26
    PROCESS_INSTANCE_BATCH = 27
    CHECKPOINT = 28
    FORM = 29
    USER_TASK = 30
    PROCESS_INSTANCE_RESULT = 31
    PROCESS_INSTANCE_MIGRATION = 32
    MESSAGE_BATCH = 33
    SBE_UNKNOWN = 255


# the tenant every record belongs to unless stated otherwise (reference:
# TenantOwned.DEFAULT_TENANT_IDENTIFIER)
DEFAULT_TENANT = "<default>"


class RejectionType(enum.IntEnum):
    """Why a command was rejected (reference: record/RejectionType.java)."""

    NULL_VAL = 0
    INVALID_ARGUMENT = 1
    NOT_FOUND = 2
    ALREADY_EXISTS = 3
    INVALID_STATE = 4
    PROCESSING_ERROR = 5
    EXCEEDED_BATCH_RECORD_SIZE = 6


class BpmnElementType(enum.IntEnum):
    """BPMN element taxonomy (reference: record/value/BpmnElementType.java).

    The integer code doubles as the device-side element opcode: the automaton
    kernel's ``lax.switch`` over element behavior is indexed by this value
    (see zeebe_tpu_torch.ops.automaton).
    """

    UNSPECIFIED = 0
    PROCESS = 1
    SUB_PROCESS = 2
    EVENT_SUB_PROCESS = 3
    START_EVENT = 4
    INTERMEDIATE_CATCH_EVENT = 5
    INTERMEDIATE_THROW_EVENT = 6
    BOUNDARY_EVENT = 7
    END_EVENT = 8
    SERVICE_TASK = 9
    RECEIVE_TASK = 10
    USER_TASK = 11
    MANUAL_TASK = 12
    TASK = 13
    EXCLUSIVE_GATEWAY = 14
    INCLUSIVE_GATEWAY = 15
    PARALLEL_GATEWAY = 16
    EVENT_BASED_GATEWAY = 17
    SEQUENCE_FLOW = 18
    MULTI_INSTANCE_BODY = 19
    CALL_ACTIVITY = 20
    BUSINESS_RULE_TASK = 21
    SCRIPT_TASK = 22
    SEND_TASK = 23

    @property
    def is_gateway(self) -> bool:
        return self in (
            BpmnElementType.EXCLUSIVE_GATEWAY,
            BpmnElementType.INCLUSIVE_GATEWAY,
            BpmnElementType.PARALLEL_GATEWAY,
            BpmnElementType.EVENT_BASED_GATEWAY,
        )

    @property
    def is_task(self) -> bool:
        return self in (
            BpmnElementType.SERVICE_TASK,
            BpmnElementType.RECEIVE_TASK,
            BpmnElementType.USER_TASK,
            BpmnElementType.MANUAL_TASK,
            BpmnElementType.TASK,
            BpmnElementType.BUSINESS_RULE_TASK,
            BpmnElementType.SCRIPT_TASK,
            BpmnElementType.SEND_TASK,
        )

    @property
    def is_container(self) -> bool:
        return self in (
            BpmnElementType.PROCESS,
            BpmnElementType.SUB_PROCESS,
            BpmnElementType.EVENT_SUB_PROCESS,
            BpmnElementType.MULTI_INSTANCE_BODY,
        )

    @property
    def is_job_worker_task(self) -> bool:
        """Element types implemented through jobs (reference: bpmn/task/JobWorkerTaskProcessor)."""
        return self in (
            BpmnElementType.SERVICE_TASK,
            BpmnElementType.SEND_TASK,
            BpmnElementType.BUSINESS_RULE_TASK,
            BpmnElementType.SCRIPT_TASK,
            BpmnElementType.USER_TASK,
        )


class BpmnEventType(enum.IntEnum):
    """Event trigger taxonomy (reference: record/value/BpmnEventType.java)."""

    UNSPECIFIED = 0
    NONE = 1
    MESSAGE = 2
    TIMER = 3
    ERROR = 4
    SIGNAL = 5
    ESCALATION = 6
    TERMINATE = 7
    LINK = 8
    COMPENSATION = 9


class ErrorType(enum.IntEnum):
    """Incident error types (reference: record/value/ErrorType.java)."""

    UNKNOWN = 0
    IO_MAPPING_ERROR = 1
    JOB_NO_RETRIES = 2
    CONDITION_ERROR = 3
    EXTRACT_VALUE_ERROR = 4
    UNHANDLED_ERROR_EVENT = 5
    MESSAGE_SIZE_EXCEEDED = 6
    CALLED_ELEMENT_ERROR = 7
    CALLED_DECISION_ERROR = 8
    DECISION_EVALUATION_ERROR = 9
    FORM_NOT_FOUND = 10
    EXECUTION_LISTENER_NO_RETRIES = 11


class PartitionRole(enum.IntEnum):
    """Role of a node for a partition (reference: atomix raft Role)."""

    FOLLOWER = 0
    CANDIDATE = 1
    LEADER = 2
    INACTIVE = 3
