"""In-memory bounded-retention time-series store + registry sampler.

What the reference outsources to Prometheus, a self-contained TPU-native
broker must carry itself: *history*. A point-in-time ``/metrics`` scrape
cannot answer "what was the exporter lag over the last minute", cannot feed a
for-duration alert rule, and retains nothing for a postmortem. Gorilla
(Pelkonen et al., VLDB'15) and Monarch (Adams et al., VLDB'20) both argue for
an in-memory, bounded-retention time-series layer close to the target as the
substrate for alerting and debugging — this module is that layer:

- :class:`TimeSeriesStore` — per-series append-only blocks of delta-encoded
  timestamps (``array('i')`` millisecond gaps) + packed float values
  (``array('d')``), Gorilla's timestamp-compression idea without the
  bit-level XOR stage (block overhead already amortizes to ~12 bytes/sample;
  the win that matters here is bounded memory, not wire size). Old blocks
  fall off by retention; the open block seals at ``block_samples``.
- :class:`MetricsSampler` — snapshots the :class:`MetricsRegistry` every
  ``interval_ms``: **counters become rates** (d(value)/dt between consecutive
  samples), **histograms become p50/p99 estimates** plus an observation rate
  (``<name>:p50``/``:p99``/``:rate`` series), gauges record raw. Tick-driven
  (``maybe_sample`` from the broker's control pump — deterministic under the
  test clock) with an optional background thread for hosts without a pump
  (``bench.py --sample-metrics``).

Cost contract: nothing measurable when disabled — the sampler
simply isn't constructed, leaving one ``is not None`` check per control pump
— and <1% on ``bench.py --quick`` when enabled (a few hundred child series
snapshot in ~1ms, every 250ms, off the hot path).
"""

from __future__ import annotations

import threading
from array import array
from typing import Callable, Iterable, Iterator

DEFAULT_RETENTION_MS = 5 * 60 * 1000
DEFAULT_BLOCK_SAMPLES = 120
DEFAULT_INTERVAL_MS = 250

# one delta is an i32 of milliseconds: a gap beyond ~24 days would overflow;
# seal the block instead and start a fresh epoch
_MAX_DELTA_MS = 2**31 - 1


class _Block:
    """One sealed-or-open run of samples: epoch timestamp + ms deltas."""

    __slots__ = ("t0", "deltas", "values", "last_t")

    def __init__(self, t0: int, value: float) -> None:
        self.t0 = t0
        self.last_t = t0
        self.deltas = array("i")       # gap to the PREVIOUS sample, ms
        self.values = array("d", (value,))

    def append(self, t_ms: int, value: float) -> None:
        self.deltas.append(t_ms - self.last_t)
        self.values.append(value)
        self.last_t = t_ms

    def __len__(self) -> int:
        return len(self.values)

    def samples(self) -> Iterator[tuple[int, float]]:
        t = self.t0
        yield t, self.values[0]
        for delta, value in zip(self.deltas, self.values[1:]):
            t += delta
            yield t, value


class Series:
    __slots__ = ("name", "labels", "kind", "blocks", "_block_samples")

    def __init__(self, name: str, labels: str, kind: str,
                 block_samples: int = DEFAULT_BLOCK_SAMPLES) -> None:
        self.name = name
        self.labels = labels  # rendered label string, e.g. '{node="broker-0"}'
        self.kind = kind      # "gauge" | "rate" | "quantile"
        self.blocks: list[_Block] = []
        self._block_samples = block_samples

    def append(self, t_ms: int, value: float) -> None:
        if self.blocks:
            tail = self.blocks[-1]
            if (len(tail) < self._block_samples
                    and 0 <= t_ms - tail.last_t <= _MAX_DELTA_MS):
                tail.append(t_ms, value)
                return
        self.blocks.append(_Block(t_ms, value))

    def evict_before(self, cutoff_ms: int) -> None:
        # whole sealed blocks only: per-sample eviction would force re-basing
        # the delta chain; a block is at most block_samples stale
        while len(self.blocks) > 1 and self.blocks[0].last_t < cutoff_ms:
            self.blocks.pop(0)

    def samples(self, since_ms: int = 0) -> list[tuple[int, float]]:
        out = []
        for block in self.blocks:
            if block.last_t < since_ms:
                continue
            out.extend((t, v) for t, v in block.samples() if t >= since_ms)
        return out

    def latest(self) -> tuple[int, float] | None:
        if not self.blocks:
            return None
        tail = self.blocks[-1]
        return tail.last_t, tail.values[-1]

    def __len__(self) -> int:
        return sum(len(b) for b in self.blocks)


class TimeSeriesStore:
    """Bounded in-memory store keyed by ``(name, label_str)``. Thread-safe:
    the sampler appends from the control pump while management HTTP threads
    query."""

    def __init__(self, retention_ms: int = DEFAULT_RETENTION_MS,
                 block_samples: int = DEFAULT_BLOCK_SAMPLES,
                 max_series: int = 8192) -> None:
        self.retention_ms = retention_ms
        self.block_samples = block_samples
        self.max_series = max_series
        self._series: dict[tuple[str, str], Series] = {}
        self._lock = threading.Lock()
        self.dropped_series = 0  # over max_series: new series are refused

    def append(self, name: str, labels: str, kind: str, t_ms: int,
               value: float) -> None:
        key = (name, labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                if len(self._series) >= self.max_series:
                    self.dropped_series += 1
                    return
                series = Series(name, labels, kind, self.block_samples)
                self._series[key] = series
            series.append(t_ms, value)

    def evict(self, now_ms: int) -> None:
        cutoff = now_ms - self.retention_ms
        with self._lock:
            for series in self._series.values():
                series.evict_before(cutoff)

    # -- queries ---------------------------------------------------------------

    def _matching(self, name: str) -> list[Series]:
        """Exact name match, plus derived children (``name:p50`` …) so
        querying a histogram's base name returns its whole family."""
        prefix = name + ":"
        return [s for (n, _), s in self._series.items()
                if n == name or n.startswith(prefix)]

    def series_names(self) -> list[str]:
        with self._lock:
            return sorted({n for n, _ in self._series})

    def query(self, name: str, since_ms: int = 0,
              step_ms: int = 0) -> list[dict]:
        """Samples per matching series; ``step_ms`` downsamples by keeping
        the last sample of each step bucket (rate/gauge semantics: the value
        that was current at the bucket's end)."""
        with self._lock:
            matching = self._matching(name)
            out = []
            for series in matching:
                samples = series.samples(since_ms)
                if step_ms > 0 and samples:
                    by_bucket: dict[int, tuple[int, float]] = {}
                    for t, v in samples:
                        by_bucket[t // step_ms] = (t, v)
                    samples = [by_bucket[b] for b in sorted(by_bucket)]
                out.append({
                    "name": series.name,
                    "labels": series.labels,
                    "kind": series.kind,
                    "samples": [[t, v] for t, v in samples],
                })
        return out

    def latest(self, name: str) -> list[dict]:
        with self._lock:
            out = []
            for series in self._matching(name):
                latest = series.latest()
                if latest is not None:
                    out.append({"name": series.name, "labels": series.labels,
                                "kind": series.kind,
                                "t": latest[0], "value": latest[1]})
        return out

    def rate(self, name: str, window_ms: int, now_ms: int,
             labels_contains: str = "") -> float:
        """Per-second increase of a monotonic gauge over the trailing window,
        summed across matching children — the headline-rate helper for
        ``/cluster/status`` (counters already store rates; this serves the
        position-style gauges like ``stream_processor_last_processed_position``)."""
        total = 0.0
        with self._lock:
            matching = [s for s in self._matching(name)
                        if labels_contains in s.labels]
            for series in matching:
                samples = series.samples(now_ms - window_ms)
                if len(samples) >= 2:
                    (t0, v0), (t1, v1) = samples[0], samples[-1]
                    if t1 > t0 and v1 >= v0:
                        total += (v1 - v0) / ((t1 - t0) / 1000.0)
        return total

    def stats(self) -> dict:
        with self._lock:
            return {
                "series": len(self._series),
                "samples": sum(len(s) for s in self._series.values()),
                "droppedSeries": self.dropped_series,
                "retentionMs": self.retention_ms,
            }


class MetricsSampler:
    """Snapshots a :class:`MetricsRegistry` into a :class:`TimeSeriesStore`.

    Counters are stored as per-second **rates** between consecutive samples
    (the raw monotonic total is recoverable from ``/metrics``; the question
    history answers is "how fast", not "how many"). Histograms are distilled
    to ``:p50``/``:p99`` bucket-interpolated estimates over the deltas since
    the previous sample (so the percentiles describe *recent* observations,
    not the lifetime distribution) plus a ``:rate`` of observations/s.
    Gauges record raw values.
    """

    def __init__(self, registry, store: TimeSeriesStore,
                 interval_ms: int = DEFAULT_INTERVAL_MS,
                 clock_millis: Callable[[], int] | None = None) -> None:
        import time

        self.registry = registry
        self.store = store
        self.interval_ms = interval_ms
        self.clock_millis = clock_millis or (lambda: int(time.time() * 1000))
        self._last_sample_ms = 0
        # per-series previous snapshot for rate/delta derivation
        self._prev_counter: dict[tuple[str, str], tuple[int, float]] = {}
        self._prev_hist: dict[tuple[str, str], tuple[int, int, float, list]] = {}
        self.samples_taken = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- tick-driven (broker control pump) -------------------------------------

    def maybe_sample(self, now_ms: int | None = None) -> bool:
        now = self.clock_millis() if now_ms is None else now_ms
        if now - self._last_sample_ms < self.interval_ms:
            return False
        self.sample_once(now)
        return True

    def sample_once(self, now_ms: int | None = None) -> None:
        now = self.clock_millis() if now_ms is None else now_ms
        # a series first observed BETWEEN two ticks gets a synthesized zero
        # baseline at the previous tick (counters start at 0) — without it
        # every new series would lose its first interval of rate history
        prev_tick = self._last_sample_ms if self.samples_taken else None
        self._last_sample_ms = now
        store = self.store
        for name, kind, labels, value in self.registry.snapshot():
            key = (name, labels)
            if kind == "counter":
                prev = self._prev_counter.get(key)
                if prev is None and prev_tick is not None and prev_tick < now:
                    prev = (prev_tick, 0.0)
                self._prev_counter[key] = (now, value)
                if prev is not None and now > prev[0]:
                    dt = (now - prev[0]) / 1000.0
                    # a counter reset (restart/clear) would read as a huge
                    # negative rate; clamp to "unknown this interval"
                    if value >= prev[1]:
                        store.append(name, labels, "rate", now,
                                     (value - prev[1]) / dt)
            elif kind == "gauge":
                store.append(name, labels, "gauge", now, value)
            else:  # histogram
                count, total, bucket_counts, buckets = value
                prev = self._prev_hist.get(key)
                if prev is None and prev_tick is not None and prev_tick < now:
                    prev = (prev_tick, 0, 0.0, [0] * len(bucket_counts))
                self._prev_hist[key] = (now, count, total, bucket_counts)
                if prev is None or now <= prev[0]:
                    continue
                prev_t, prev_count, _prev_sum, prev_buckets = prev
                delta_count = count - prev_count
                dt = (now - prev_t) / 1000.0
                store.append(name, labels, "rate", now,
                             max(delta_count, 0) / dt)
                if delta_count <= 0 or len(prev_buckets) != len(bucket_counts):
                    continue
                from zeebe_tpu_torch.utils.metrics import estimate_quantile

                delta_buckets = [c - p for c, p
                                 in zip(bucket_counts, prev_buckets)]
                store.append(name + ":p50", labels, "quantile", now,
                             estimate_quantile(buckets, delta_buckets, 0.50))
                store.append(name + ":p99", labels, "quantile", now,
                             estimate_quantile(buckets, delta_buckets, 0.99))
        store.evict(now)
        self.samples_taken += 1

    # -- thread-driven (no pump available: bench, ad-hoc tooling) --------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def run() -> None:
            while not self._stop.wait(self.interval_ms / 1000.0):
                try:
                    self.sample_once()
                except Exception:  # noqa: BLE001 — a torn registry read must
                    pass           # not kill the sampling loop
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="metrics-sampler")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5)
        self._thread = None


def summarize_store(store: TimeSeriesStore,
                    headline: Iterable[str] = ()) -> dict:
    """Compact store summary for the BENCH extra: volume stats plus, per
    requested headline series, the latest retained value and the retained
    peak (the last sample of a bench run lands after the workload went idle,
    so "last" alone would read 0 for every rate series)."""
    out = store.stats()
    series = {}
    for name in headline:
        for entry in store.query(name):
            if entry["name"] != name:
                continue  # query() prefix-matches histogram children
            samples = entry["samples"]
            if not samples:
                continue
            series[f"{name}{entry['labels']}"] = {
                "last": round(samples[-1][1], 4),
                "max": round(max(v for _, v in samples), 4),
            }
    if series:
        out["headline"] = series
    return out
