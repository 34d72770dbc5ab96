"""Protocol enums the deploy-time compiler needs: BPMN element and event types.

A copy of the two enums of ``zeebe_tpu.protocol.enums`` (reference: protocol/
src/main/java/io/camunda/zeebe/protocol/record/value/BpmnElementType.java and
BpmnEventType.java). The integer codes are wire format and index the device
opcode tables in ``zeebe_tpu_torch.ops``, so they are append-only: never
renumber, and keep them equal to the reference package's.
"""

from __future__ import annotations

import enum


class BpmnElementType(enum.IntEnum):
    """BPMN element taxonomy (reference: record/value/BpmnElementType.java).

    The integer code keys the deploy-time opcode table
    (see zeebe_tpu_torch.ops.tables).
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

