"""Request backpressure: adaptive in-flight command limiting.

Reference: broker/src/main/java/io/camunda/zeebe/broker/transport/backpressure/
— PartitionAwareRequestLimiter → CommandRateLimiter.java:26 over Netflix
concurrency-limits (vegas, aimd, fixed, gradient; docs/backpressure.md:1-80).
White-listed intents (job COMPLETE/FAIL) always pass so workers can finish
in-flight work and drain load.

Implemented limiters: fixed, AIMD (additive increase on success below the
limit, multiplicative decrease on timeout), and vegas (latency-gradient:
queue estimate = limit * (1 - minRTT/sampleRTT), grow when small, shrink when
large) — the reference's default.
"""

from __future__ import annotations

import math
from typing import Callable

from zeebe_tpu_torch.protocol import Record, ValueType
from zeebe_tpu_torch.protocol.intent import JobIntent

# intents that bypass backpressure (docs/backpressure.md white list)
WHITELIST: set[tuple[ValueType, int]] = {
    (ValueType.JOB, int(JobIntent.COMPLETE)),
    (ValueType.JOB, int(JobIntent.FAIL)),
}


class FixedLimit:
    def __init__(self, limit: int = 100) -> None:
        self.limit = limit

    def on_sample(self, rtt_ms: float, in_flight: int, dropped: bool) -> None:
        pass


class AimdLimit:
    """Additive-increase / multiplicative-decrease on request timeouts."""

    def __init__(self, initial: int = 100, min_limit: int = 1,
                 max_limit: int = 1000, backoff_ratio: float = 0.9,
                 timeout_ms: float = 200.0) -> None:
        self.limit = initial
        self.min_limit = min_limit
        self.max_limit = max_limit
        self.backoff_ratio = backoff_ratio
        self.timeout_ms = timeout_ms

    def on_sample(self, rtt_ms: float, in_flight: int, dropped: bool) -> None:
        if dropped or rtt_ms > self.timeout_ms:
            self.limit = max(self.min_limit, int(self.limit * self.backoff_ratio))
        elif in_flight * 2 >= self.limit:
            self.limit = min(self.max_limit, self.limit + 1)


class VegasLimit:
    """Latency-gradient limit (the reference default, vegas windowed)."""

    def __init__(self, initial: int = 20, min_limit: int = 1,
                 max_limit: int = 1000) -> None:
        self.limit = initial
        self.min_limit = min_limit
        self.max_limit = max_limit
        self._min_rtt = math.inf

    def on_sample(self, rtt_ms: float, in_flight: int, dropped: bool) -> None:
        if dropped:
            self.limit = max(self.min_limit, int(self.limit * 0.9))
            return
        if rtt_ms <= 0:
            return
        self._min_rtt = min(self._min_rtt, rtt_ms)
        queue = self.limit * (1 - self._min_rtt / rtt_ms)
        alpha = 3 * math.log10(self.limit) + 1
        beta = 6 * math.log10(self.limit) + 1
        if queue < alpha:
            self.limit = min(self.max_limit, self.limit + int(math.log10(self.limit)) + 1)
        elif queue > beta:
            self.limit = max(self.min_limit, self.limit - 1)


LIMITS = {"fixed": FixedLimit, "aimd": AimdLimit, "vegas": VegasLimit}


class CommandRateLimiter:
    """Per-partition in-flight limiter; acquire at ingress, release when the
    command's response/processing completes (reference: CommandRateLimiter
    registered on the command api request path)."""

    def __init__(self, algorithm: str = "vegas", enabled: bool = True,
                 clock_millis: Callable[[], int] | None = None,
                 timeout_ms: int | None = None, **kw) -> None:
        import time

        if algorithm == "aimd" and timeout_ms is not None:
            # one timeout threshold for both the drop-sample gate here and
            # AIMD's internal rtt backoff — not two inconsistent ones
            kw.setdefault("timeout_ms", timeout_ms)
        self.algorithm = LIMITS[algorithm](**kw)
        self.enabled = enabled
        self.clock_millis = clock_millis or (lambda: int(time.time() * 1000))
        # default: inherit the algorithm's own threshold (AIMD: 200ms) so an
        # unconfigured limiter keeps its pre-existing sensitivity
        self.timeout_ms = (timeout_ms if timeout_ms is not None
                           else getattr(self.algorithm, "timeout_ms", 10_000))
        self.in_flight: dict[int, int] = {}  # position → acquire time ms
        self.dropped_total = 0
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        self._m_limit = REGISTRY.gauge(
            "backpressure_requests_limit",
            "current adaptive in-flight request limit").labels()
        self._m_received = REGISTRY.counter(
            "received_request_count_total",
            "commands received at the ingress limiter").labels()
        self._m_dropped = REGISTRY.counter(
            "dropped_request_count_total",
            "commands rejected by backpressure").labels()
        # the appender-side limits exist in the reference as a separate flow
        # control; here the sequencer/appender path is synchronous, so the
        # append limit equals the request limit and in-flight appends equal
        # in-flight requests
        self._m_append_limit = REGISTRY.gauge(
            "backpressure_append_limit",
            "current in-flight append limit (synchronous appender: equals "
            "the request limit)").labels()
        self._m_inflight_appends = REGISTRY.gauge(
            "backpressure_inflight_append_count",
            "appends in flight (synchronous appender: equals in-flight "
            "requests)").labels()
        self._m_limit.set(self.algorithm.limit)
        self._m_append_limit.set(self.algorithm.limit)

    @property
    def limit(self) -> int:
        return self.algorithm.limit

    def try_acquire(self, record: Record, provisional: int = 0) -> bool:
        """``provisional``: admissions already granted in the caller's
        current batch but not yet appended (``on_appended`` is what grows
        ``in_flight``) — the coalesced ingress passes its running count so
        one batch cannot overshoot the limit by its own size."""
        if not self.enabled:
            return True
        self._m_received.inc()
        if (record.value_type, int(record.intent)) in WHITELIST:
            return True
        if len(self.in_flight) + provisional >= self.algorithm.limit:
            # gate rejections are NOT fed to the limit algorithm: the Netflix
            # concurrency-limits reference only records drop samples for timed-
            # out in-flight requests, and multiplicative-decrease per rejected
            # request collapses the limit to min under a burst (death spiral)
            self.dropped_total += 1
            self._m_dropped.inc()
            return False
        return True

    def on_appended(self, position: int) -> None:
        self.in_flight[position] = self.clock_millis()
        self._m_inflight_appends.set(len(self.in_flight))

    def on_processed(self, position: int) -> None:
        started = self.in_flight.pop(position, None)
        if started is not None:
            rtt = self.clock_millis() - started
            # drop samples come only from in-flight RTTs exceeding the timeout
            self.algorithm.on_sample(rtt, len(self.in_flight),
                                     dropped=rtt > self.timeout_ms)
            # the adaptive limit only moves on samples — update gauges here,
            # off the per-command ingress path
            self._m_limit.set(self.algorithm.limit)
            self._m_append_limit.set(self.algorithm.limit)
