"""JobWorker: poll/stream jobs, dispatch to a handler, complete or fail.

Reference: clients/java/…/worker/JobWorker + JobWorkerBuilderStep1 (poller +
streamer, exponential poll backoff, maxJobsActive flow control), and the Go
worker (clients/go/pkg/worker/jobPoller.go, jobDispatcher.go).
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Callable

from zeebe_tpu_torch.client.client import ActivatedJob, ZeebeTpuClient

Handler = Callable[["JobClient", ActivatedJob], None]


class JobClient:
    """Handed to handlers: complete/fail/throw for the current job."""

    def __init__(self, client: ZeebeTpuClient) -> None:
        self._client = client

    def complete(self, job: ActivatedJob, variables: dict | None = None) -> None:
        self._client.complete_job(job.key, variables)

    def fail(self, job: ActivatedJob, retries: int | None = None,
             error_message: str = "", retry_back_off_ms: int = 0) -> None:
        self._client.fail_job(
            job.key, job.retries - 1 if retries is None else retries,
            error_message, retry_back_off_ms,
        )

    def throw_error(self, job: ActivatedJob, error_code: str,
                    error_message: str = "") -> None:
        self._client.throw_error(job.key, error_code, error_message)


class JobWorker:
    """Background polling worker with exponential empty-poll backoff.

    ``auto_complete``: a handler return (no exception) completes the job with
    the handler's returned dict (or {}); an exception fails it with
    retries-1 (the Java client's default error behavior).

    ``stream_enabled``: use the StreamActivatedJobs push path instead of the
    ActivateJobs poll loop (reference: JobWorkerBuilderStep1.streamEnabled —
    jobs arrive as the broker creates them, no polling)."""

    def __init__(
        self,
        client: ZeebeTpuClient,
        job_type: str,
        handler: Handler | Callable[[ActivatedJob], dict | None],
        worker_name: str = "python-worker",
        max_jobs_active: int = 32,
        timeout_ms: int = 300_000,
        poll_interval_s: float = 0.05,
        max_backoff_s: float = 1.0,
        auto_complete: bool = True,
        stream_enabled: bool = False,
    ) -> None:
        self.client = client
        self.job_type = job_type
        self.handler = handler
        self.worker_name = worker_name
        self.max_jobs_active = max_jobs_active
        self.timeout_ms = timeout_ms
        self.poll_interval_s = poll_interval_s
        self.max_backoff_s = max_backoff_s
        self.auto_complete = auto_complete
        self.stream_enabled = stream_enabled
        self._running = False
        self._thread: threading.Thread | None = None
        self.handled_count = 0
        self.failed_count = 0

    def start(self) -> "JobWorker":
        self._running = True
        target = self._stream_loop if self.stream_enabled else self._poll_loop
        self._thread = threading.Thread(target=target, daemon=True,
                                        name=f"worker-{self.job_type}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        call = getattr(self, "_call", None)
        if call is not None:
            call.cancel()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _poll_loop(self) -> None:
        backoff = self.poll_interval_s
        job_client = JobClient(self.client)
        while self._running:
            try:
                jobs = self.client.activate_jobs(
                    self.job_type, max_jobs=self.max_jobs_active,
                    worker=self.worker_name, timeout_ms=self.timeout_ms,
                )
            except Exception:
                time.sleep(backoff)
                backoff = min(backoff * 2, self.max_backoff_s)
                continue
            if not jobs:
                time.sleep(backoff)
                backoff = min(backoff * 2, self.max_backoff_s)
                continue
            backoff = self.poll_interval_s
            for job in jobs:
                if not self._running:
                    return
                self._dispatch(job_client, job)

    def _stream_loop(self) -> None:
        job_client = JobClient(self.client)
        while self._running:
            try:
                self._call, jobs = self.client.open_job_stream(
                    self.job_type, worker=self.worker_name,
                    timeout_ms=self.timeout_ms,
                )
                if not self._running:
                    # stop() raced the reconnect: its cancel hit the old call
                    self._call.cancel()
                    return
                for job in jobs:
                    if not self._running:
                        return
                    self._dispatch(job_client, job)
            except Exception:
                if not self._running:
                    return
                time.sleep(self.poll_interval_s)

    def _dispatch(self, job_client: JobClient, job: ActivatedJob) -> None:
        try:
            if self.auto_complete:
                result = self.handler(job)
                job_client.complete(job, result if isinstance(result, dict) else {})
            else:
                self.handler(job_client, job)
            self.handled_count += 1
        except Exception as exc:  # handler error → fail with retries-1
            self.failed_count += 1
            try:
                job_client.fail(job, error_message=(
                    f"{type(exc).__name__}: {exc}\n{traceback.format_exc(limit=5)}"
                ))
            except Exception:
                pass
