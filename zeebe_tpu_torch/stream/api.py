"""Stream platform SPI: RecordProcessor, ProcessingResultBuilder, schedule service.

Reference: stream-platform/src/main/java/io/camunda/zeebe/stream/api/
RecordProcessor.java (the seam the engine plugs into), ProcessingResultBuilder.java,
scheduling/ProcessingScheduleService.java, records/TypedRecord.java.

The TPU batch backend registers behind this same SPI (BASELINE.json): a
RecordProcessor whose ``process`` collects device-batchable commands and whose
follow-up records come back from the automaton kernel.
"""

from __future__ import annotations

import abc
import dataclasses
import heapq
from typing import Any, Callable

from zeebe_tpu_torch.logstreams import LoggedRecord
from zeebe_tpu_torch.protocol import Record, RejectionType, ValueType


@dataclasses.dataclass(slots=True)
class FollowUpRecord:
    """A record the processor wants appended after the current step."""

    record: Record
    # processed-in-batch: the record is a command that was already processed in
    # the same transaction; replay and later processing must skip it.
    processed: bool = False


@dataclasses.dataclass(slots=True)
class ClientResponse:
    """Response to the client request that carried the command."""

    record: Record
    request_stream_id: int
    request_id: int


def activatable_job_types(follow_ups) -> set[str]:
    """Job types made activatable by a step's follow-up events — the
    jobs-available notification source (reference: the engine's
    JobsAvailableCallback wired through BpmnJobActivationBehavior /
    JobBackoffChecker so gateways can wake parked long-polls and push
    streams instead of polling)."""
    from zeebe_tpu_torch.protocol.intent import JobIntent

    available = set()
    for f in follow_ups:
        rec = f.record
        if rec.value_type != ValueType.JOB or not rec.is_event:
            continue
        intent = int(rec.intent)
        if intent in (int(JobIntent.CREATED), int(JobIntent.TIMED_OUT),
                      int(JobIntent.RECURRED_AFTER_BACKOFF), int(JobIntent.YIELDED)) or (
            intent == int(JobIntent.FAILED)
            and rec.value.get("retries", 0) > 0
            and rec.value.get("retryBackoff", -1) <= 0
        ):
            job_type = rec.value.get("type", "")
            if job_type:
                available.add(job_type)
    return available


class ProcessingResultBuilder:
    """Collects everything one processing step produces: follow-up records, an
    optional client response, and post-commit tasks (side effects).

    ``max_batch_size_bytes`` mirrors the reference's RecordBatch size predicate
    (maxMessageSize): a step whose follow-ups exceed it fails with
    EXCEEDED_BATCH_RECORD_SIZE and is retried unbatched where applicable.
    """

    def __init__(self, max_batch_size_bytes: int = 4 * 1024 * 1024) -> None:
        self.follow_ups: list[FollowUpRecord] = []
        self.response: ClientResponse | None = None
        self.extra_responses: list[ClientResponse] = []
        self.post_commit_tasks: list[Callable[[], None]] = []
        self._size = 0
        self._max_size = max_batch_size_bytes

    def append_record(self, record: Record, processed: bool = False) -> None:
        size = len(record.to_bytes())
        if self._size + size > self._max_size:
            raise ExceededBatchRecordSizeError(
                f"batch would exceed {self._max_size} bytes"
            )
        self._size += size
        self.follow_ups.append(FollowUpRecord(record, processed))

    def with_response(self, record: Record, request_stream_id: int, request_id: int) -> None:
        self.response = ClientResponse(record, request_stream_id, request_id)

    def add_response(self, record: Record, request_stream_id: int, request_id: int) -> None:
        """An extra response to a *different* parked request (await-result:
        the process-completion step answers the original create request)."""
        self.extra_responses.append(ClientResponse(record, request_stream_id, request_id))

    def append_post_commit_task(self, task: Callable[[], None]) -> None:
        self.post_commit_tasks.append(task)


class ExceededBatchRecordSizeError(Exception):
    pass


class RecordProcessor(abc.ABC):
    """The processing SPI (reference: api/RecordProcessor.java)."""

    @abc.abstractmethod
    def accepts(self, value_type: ValueType) -> bool:
        """Whether this processor handles records of ``value_type``."""

    @abc.abstractmethod
    def process(self, record: LoggedRecord, result: ProcessingResultBuilder) -> None:
        """Process a committed command; events appended to ``result`` must
        already be applied to state (StateWriter contract)."""

    @abc.abstractmethod
    def replay(self, record: LoggedRecord) -> None:
        """Apply an event to state during replay — must produce state identical
        to what ``process`` produced when it originally wrote the event."""

    def on_processing_error(
        self, error: Exception, record: LoggedRecord, result: ProcessingResultBuilder
    ) -> "ProcessingErrorHandling":
        """Called in a fresh transaction after the failed one rolled back."""
        return ProcessingErrorHandling.REJECT


class ProcessingErrorHandling:
    REJECT = "reject"  # write rejection, continue with next command
    SKIP = "skip"  # skip the record entirely


class ScheduledTaskHandle:
    __slots__ = ("cancelled", "due_millis", "task")

    def __init__(self, due_millis: int, task: Callable[[], list[Record]]) -> None:
        self.due_millis = due_millis
        self.task = task
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class ProcessingScheduleService:
    """Deterministic deferred-task scheduler (reference:
    api/scheduling/ProcessingScheduleService.java).

    The engine schedules due-date checks (timers, message TTL, job timeouts)
    that *write commands back to the log* — never mutate state directly. Driven
    by the stream processor's pump with the stream clock, so tests control time.
    """

    def __init__(self, clock_millis: Callable[[], int], write_commands: Callable[[list[Record]], None]) -> None:
        self._clock = clock_millis
        self._write = write_commands
        self._heap: list[tuple[int, int, ScheduledTaskHandle]] = []
        self._seq = 0
        # actor-analogue metrics (reference: scheduler/ ActorMetrics —
        # actor_job_scheduling_latency etc.): the schedule service is the
        # runtime's deferred-task executor, the closest analogue of the
        # reference's actor task queues
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        self._m_sched_latency = REGISTRY.histogram(
            "actor_job_scheduling_latency",
            "ms a due task waited past its due time",
            buckets=(1, 5, 10, 50, 100, 500, 1000, 5000)).labels()
        self._m_exec_count = REGISTRY.counter(
            "actor_task_execution_count", "scheduled tasks executed").labels()
        self._m_exec_latency = REGISTRY.histogram(
            "actor_task_execution_latency",
            "seconds per scheduled task execution").labels()
        self._m_queue_len = REGISTRY.gauge(
            "actor_task_queue_length", "scheduled tasks pending").labels()

    def run_delayed(self, delay_millis: int, task: Callable[[], list[Record]]) -> ScheduledTaskHandle:
        return self.run_at(self._clock() + delay_millis, task)

    def run_at(self, due_millis: int, task: Callable[[], list[Record]]) -> ScheduledTaskHandle:
        handle = ScheduledTaskHandle(due_millis, task)
        self._seq += 1
        heapq.heappush(self._heap, (due_millis, self._seq, handle))
        return handle

    def run_due_tasks(self) -> int:
        """Run tasks whose due time has passed; their returned commands are
        written to the log. Returns number of tasks run."""
        import time as _time

        now = self._clock()
        ran = 0
        while self._heap and self._heap[0][0] <= now:
            due, _, handle = heapq.heappop(self._heap)
            if handle.cancelled:
                continue
            self._m_sched_latency.observe(max(0, now - due))
            start = _time.perf_counter()
            commands = handle.task() or []
            if commands:
                self._write(commands)
            self._m_exec_count.inc()
            self._m_exec_latency.observe(_time.perf_counter() - start)
            ran += 1
        self._m_queue_len.set(len(self._heap))
        return ran

    @property
    def next_due_millis(self) -> int | None:
        while self._heap and self._heap[0][2].cancelled:
            heapq.heappop(self._heap)
        return self._heap[0][0] if self._heap else None
