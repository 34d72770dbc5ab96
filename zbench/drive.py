"""The closed loop that drives a cell: client threads that each create one
instance and wait for it to complete before creating the next, and worker
threads that activate jobs by long polling and complete every job they get.

Every command goes through ``ClusterRuntime.submit``, the gateway runtime's
request API. The loop stamps each create's send, its reply and the reply
that ended its instance on the host's monotonic clock, and keeps every
reply for the judge as a tuple of plain numbers and strings (its value as
canonical JSON), which the interpreter's cycle collector does not walk,
so what the loop keeps does not lengthen the collector's pauses. A command that backpressure refuses counts as failed
and is sent again after a pause; its latency runs from the first send.

The long-poll pattern (peek at the partition, then activate; wait on the
jobs-available notification when no partition had a job) is copied from
the port's ``gateway.GatewayService.ActivateJobs``; the create, activate
and complete commands are those of ``chip_smoke.py`` phase 13."""

from __future__ import annotations

import json
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from zbench.capture import canonical
from zeebe_tpu_torch.gateway.broker_client import (
    RequestTimeoutError,
    ResourceExhaustedError,
)
from zeebe_tpu_torch.protocol import ValueType, command
from zeebe_tpu_torch.protocol.intent import (
    JobBatchIntent,
    JobIntent,
    ProcessInstanceCreationIntent,
)

#: the pause before a refused command is sent again
RETRY_PAUSE_S = 0.05
#: how long one request may wait for its reply
REQUEST_TIMEOUT_S = 30.0
#: a worker's long poll: the longest wait for a jobs-available notification
LONG_POLL_S = 0.5


def compact(record) -> tuple:
    """A reply as the loop keeps it."""
    return (record.record_type.name, record.value_type.name, record.intent.name, record.key,
            canonical(record.value))


def plain(reply: tuple) -> dict:
    """A kept reply as the judge reads it."""
    record_type, value_type, intent, key, value = reply
    return {"recordType": record_type, "valueType": value_type, "intent": intent, "key": key,
            "value": json.loads(value)}


class Completions:
    """Instances by key: how many of their jobs were completed and when the
    reply that ended each instance came. An instance ends when its
    completed jobs reach the count that the reference gives for its ``x``
    (``jobs_for(x)``). The client learns the key from the create's reply,
    and a worker may complete the instance's last job before the client
    has read that reply, so either side may come first: :meth:`created`
    and :meth:`job_completed` each end the instance where the other has
    already done its part."""

    def __init__(self, jobs_for) -> None:
        self.jobs_for = jobs_for
        self._lock = threading.Lock()
        self._done: dict[int, threading.Event] = {}
        self._count: dict[int, int] = {}
        #: the reference's count of jobs, per instance whose create was read
        self._expected: dict[int, int] = {}
        #: the time of each instance's latest job completion
        self._last: dict[int, float] = {}
        self.ended_at: dict[int, float] = {}
        self._released = False

    def _event(self, key: int) -> threading.Event:
        with self._lock:
            event = self._done.setdefault(key, threading.Event())
            if self._released:
                event.set()
            return event

    def created(self, key: int, x: int, at: float) -> None:
        """The client read the create's reply for an instance of ``x`` at
        ``at``; an instance with no job ends there."""
        jobs = self.jobs_for(x)
        with self._lock:
            self._expected[key] = jobs
            done = self._count.get(key, 0) >= jobs
            if done and jobs:
                at = self._last[key]
        if done:
            self.end(key, at)

    def job_completed(self, key: int, at: float) -> None:
        with self._lock:
            n = self._count[key] = self._count.get(key, 0) + 1
            self._last[key] = at
            done = n == self._expected.get(key)
        if done:
            self.end(key, at)

    def end(self, key: int, at: float) -> None:
        self.ended_at[key] = at
        self._event(key).set()

    def wait(self, key: int) -> float | None:
        """The time the instance ended, or None when :meth:`release` came
        first. Blocks without polling: a waiting client takes no turn on the
        interpreter from the system under test."""
        self._event(key).wait()
        return self.ended_at.get(key)

    def release(self) -> None:
        """Wake every client that still waits."""
        with self._lock:
            self._released = True
            events = list(self._done.values())
        for event in events:
            event.set()


class ClosedLoop:
    """C clients and W workers over one runtime. ``start`` starts them;
    ``stop_creating`` lets every client finish the instance it waits for
    and create no other; ``stop`` ends the workers."""

    def __init__(self, runtime, process_id: str, job_types: tuple[str, ...], jobs_for,
                 traffic: dict, seed: int, worker: str) -> None:
        self.runtime = runtime
        self.process_id = process_id
        self.job_types = job_types
        self.clients = int(traffic["clients"])
        self.workers = int(traffic["workers"])
        self.max_jobs = int(traffic["max_jobs"])
        self.x_range = tuple(traffic["x_range"])
        self.start_spread_s = float(traffic["start_spread_s"])
        self.seed = seed
        self.worker = worker
        self.completions = Completions(jobs_for)
        self.creating = threading.Event()
        self.stopping = threading.Event()
        self._lock = threading.Lock()
        #: (key, partition, send, reply, end) per instance, on the monotonic
        #: clock; ``end`` None for one that did not end
        self.instances: list[tuple[int, int, float, float, float | None]] = []
        #: (send, reply) per create
        self.creates: list[tuple[float, float]] = []
        #: every command's attempts: (time, refused or timed out)
        self.attempts: list[tuple[float, bool]] = []
        #: refusals by backpressure: (time, the command's value type)
        self.refusals: list[tuple[float, str]] = []
        #: commands whose reply never came (timed out)
        self.unanswered = 0
        #: activations: (time, jobs it returned)
        self.activations: list[tuple[float, int]] = []
        #: acknowledged commands, for the judge (:meth:`acknowledged`):
        #: (partition, x, key, reply) per create, (partition, job key, reply)
        #: per job completion, (partition, reply) per activation
        self.acked_creates: list[tuple] = []
        self.acked_completes: list[tuple] = []
        self.acked_activations: list[tuple] = []
        self.errors: list[str] = []
        self._threads: list[threading.Thread] = []
        #: the threads that complete the workers' jobs, shared: J at most,
        #: so every job a worker holds is completed at once
        self._completers: ThreadPoolExecutor | None = None

    # -- requests -------------------------------------------------------------

    def _submit(self, partition: int, record):
        """Send until the command is taken; None when it timed out."""
        while True:
            at = time.monotonic()
            try:
                reply = self.runtime.submit(partition, record, timeout_s=REQUEST_TIMEOUT_S)
            except ResourceExhaustedError:
                self._attempt(at, True)
                with self._lock:
                    self.refusals.append((at, record.value_type.name))
                time.sleep(RETRY_PAUSE_S)
                continue
            except RequestTimeoutError:
                self._attempt(at, True)
                with self._lock:
                    self.unanswered += 1
                return None
            self._attempt(at, False)
            return reply

    def _attempt(self, at: float, failed: bool) -> None:
        with self._lock:
            self.attempts.append((at, failed))

    # -- clients --------------------------------------------------------------

    def _client(self, index: int) -> None:
        rng = random.Random(f"{self.seed}:client:{index}")
        time.sleep(rng.uniform(0.0, self.start_spread_s))
        lo, hi = self.x_range
        while self.creating.is_set():
            x = rng.randint(lo, hi)
            partition = self.runtime.partition_for_new_instance()
            record = command(ValueType.PROCESS_INSTANCE_CREATION,
                             ProcessInstanceCreationIntent.CREATE,
                             {"bpmnProcessId": self.process_id, "version": -1,
                              "variables": {"x": x}})
            sent = time.monotonic()
            reply = self._submit(partition, record)
            replied = time.monotonic()
            if reply is None:
                continue
            key = reply.key
            with self._lock:
                self.creates.append((sent, replied))
                self.acked_creates.append((partition, x, key, compact(reply)))
            if reply.is_rejection:
                self.errors.append(f"create rejected: {plain(compact(reply))}")
                return
            self.completions.created(key, x, replied)
            ended = self.completions.wait(key)
            with self._lock:
                self.instances.append((key, partition, sent, replied, ended))
            if ended is None:
                return

    # -- workers --------------------------------------------------------------

    def _complete(self, partition: int, job: dict, key: int) -> None:
        reply = self._submit(partition, command(ValueType.JOB, JobIntent.COMPLETE,
                                                {"variables": {}}, key=key))
        at = time.monotonic()
        if reply is None:
            return
        with self._lock:
            self.acked_completes.append((partition, key, compact(reply)))
        if not reply.is_rejection:
            self.completions.job_completed(job["processInstanceKey"], at)

    def _worker(self, index: int) -> None:
        runtime = self.runtime
        hub = runtime.jobs_hub
        partitions = runtime.partition_count
        pool = self._completers
        turn = index
        while not self.stopping.is_set():
            for job_type in self.job_types:
                seen = hub.version(job_type)
                got = []
                for step in range(partitions):
                    partition = (turn + step) % partitions + 1
                    remaining = self.max_jobs - len(got)
                    if remaining <= 0:
                        break
                    if not runtime.has_activatable_jobs(partition, job_type):
                        continue
                    at = time.monotonic()
                    reply = self._submit(partition, command(
                        ValueType.JOB_BATCH, JobBatchIntent.ACTIVATE,
                        {"type": job_type, "worker": self.worker, "timeout": 300_000,
                         "maxJobsToActivate": remaining}))
                    if reply is None:
                        continue
                    jobs = list(zip(reply.value.get("jobKeys", []),
                                    reply.value.get("jobs", [])))
                    with self._lock:
                        self.activations.append((at, len(jobs)))
                        self.acked_activations.append((partition, compact(reply)))
                    got += [(partition, key, job) for key, job in jobs]
                turn += 1
                if got:
                    for f in [pool.submit(self._complete, p, job, key)
                              for p, key, job in got]:
                        f.result()
                else:
                    hub.wait(job_type, seen, LONG_POLL_S)

    # -- what the judge reads -------------------------------------------------

    def acknowledged(self) -> dict:
        """The acknowledged commands as the judge reads them."""
        return {"creates": [{"partition": p, "x": x, "key": k, "reply": plain(r)}
                            for p, x, k, r in self.acked_creates],
                "completes": [{"partition": p, "job": k, "reply": plain(r)}
                              for p, k, r in self.acked_completes],
                "activations": [{"partition": p, "reply": plain(r)}
                                for p, r in self.acked_activations]}

    # -- life cycle -----------------------------------------------------------

    def start(self) -> None:
        self.creating.set()
        self._completers = ThreadPoolExecutor(self.max_jobs,
                                              thread_name_prefix="zbench-complete")
        self._threads = (
            [threading.Thread(target=self._worker, args=(i,), name=f"zbench-worker-{i}",
                              daemon=True) for i in range(self.workers)]
            + [threading.Thread(target=self._client, args=(i,), name=f"zbench-client-{i}",
                                daemon=True) for i in range(self.clients)])
        for t in self._threads:
            t.start()

    def stop_creating(self, drain_s: float) -> int:
        """Create no more instances; wait up to ``drain_s`` for those in
        flight to end. Returns how many did not."""
        self.creating.clear()
        deadline = time.monotonic() + drain_s
        clients = self._threads[self.workers:]
        for t in clients:
            t.join(max(deadline - time.monotonic(), 0.0))
        return sum(t.is_alive() for t in clients)

    def stop(self) -> None:
        self.stopping.set()
        self.completions.release()
        for t in self._threads:
            t.join(REQUEST_TIMEOUT_S + 5.0)
        if self._completers is not None:
            self._completers.shutdown(wait=True)
