"""Distributed tracing, record lineage & the cluster metrics plane.

What the reference broker never had (SURVEY §5.1): a Dapper-style span layer
over the engine's own causal substrate — and what it outsourced to
Prometheus: retained metric history. Seven pieces:

- ``span``: the span model, the seeded deterministic sampler, and the
  bounded per-process collector with JSONL / Chrome-trace (Perfetto) export.
- ``tracer``: the process-global tracer every instrumentation point guards
  on; also owns the ``command_ack_latency`` end-to-end histogram and the
  export-span dedupe that keeps crash-restart replay duplicate-free.
- ``lineage``: the offline causal-tree walker — reconstructs a process
  instance's full record lineage from a journal alone, via the
  ``source_record_position`` backlinks every sequenced batch already carries.
- ``timeseries``: Gorilla-style in-memory bounded-retention time-series
  store + the registry sampler (counters→rates, histograms→p50/p99) behind
  ``GET /timeseries`` and the alert evaluator.
- ``flight_recorder``: per-partition bounded event rings (role changes,
  errors, backpressure, flush stalls, exporter transitions, batch
  summaries), dumped to ``<data-dir>/flight-<ts>.json`` on crash/unhealthy.
- ``auditor``: the fleet auditor — online invariant monitors
  (position monotonicity, exporter gaplessness, quarantine-latch bounds,
  replica-CRC spot checkpoints), multi-window SLO burn-rate alerting
  layered on ``alerts``, and windowed least-squares leak-trend detection
  over process resources; per-broker off the sampler tick, cross-worker
  via the status push (``ClusterAuditor``).
- ``alerts``: threshold + for-duration rules over the time-series store
  (default set: lag / backpressure / flush latency / role flapping /
  XLA recompile storms), surfaced in ``/health`` and the
  ``zeebe_alerts_firing`` gauge.
- ``critical_path``: the offline latency observatory — merges
  per-process span dumps by derived trace id and attributes every
  microsecond of each request's gateway-observed latency to exactly one
  edge (queue / coalesce / replicate / fsync / device / host-execute /
  reply), Canopy-style, with a conservation check; plus the in-broker
  ``LatencyObservatory`` that dumps the window's worst traces via the
  flight recorder.
- ``profiler``: the continuous profiling plane — an always-on low-rate
  folded-stack sampler (``GET /profile/continuous``), the kernel backend's
  XLA compile telemetry sink, device-memory gauges, alert-triggered profile
  capture into the flight recorder, and single-flight on-demand
  ``jax.profiler.trace()`` captures (``POST /profile/device``).

Spans are emitted ONLY on live processing (gateway request, command append,
backpressure acquire, journal group-flush, PROCESSING-phase steps and their
pipeline stages, exporter delivery). Replay emits nothing, by construction.
"""

from zeebe_tpu_torch.observability.alerts import (
    AlertEvaluator,
    AlertRule,
    default_rules,
)
from zeebe_tpu_torch.observability.auditor import (
    AuditorCfg,
    BrokerAuditor,
    BurnRateTracker,
    ClusterAuditor,
    TrendDetector,
)
from zeebe_tpu_torch.observability.critical_path import (
    EDGES,
    LatencyObservatory,
    aggregate_breakdowns,
    assemble,
    breakdowns_from_spans,
    check_conservation,
    extract_trace,
    load_spans,
    top_stages,
)
from zeebe_tpu_torch.observability.flight_recorder import FlightRecorder
from zeebe_tpu_torch.observability.lineage import collect_lineage, format_lineage
from zeebe_tpu_torch.observability.profiler import (
    AlertProfileCapture,
    CaptureInFlight,
    ContinuousProfiler,
    DeviceTraceCapture,
    acquire_profiler,
    observe_compile,
    release_profiler,
    sample_device_memory,
)
from zeebe_tpu_torch.observability.span import (
    DeterministicSampler,
    Span,
    SpanCollector,
    chrome_trace,
)
from zeebe_tpu_torch.observability.timeseries import (
    MetricsSampler,
    TimeSeriesStore,
    summarize_store,
)
from zeebe_tpu_torch.observability.tracer import (
    Tracer,
    configure_tracing,
    get_tracer,
)

__all__ = [
    "EDGES",
    "AlertEvaluator",
    "AlertProfileCapture",
    "AlertRule",
    "AuditorCfg",
    "BrokerAuditor",
    "BurnRateTracker",
    "CaptureInFlight",
    "ClusterAuditor",
    "ContinuousProfiler",
    "DeterministicSampler",
    "DeviceTraceCapture",
    "FlightRecorder",
    "LatencyObservatory",
    "MetricsSampler",
    "Span",
    "SpanCollector",
    "TimeSeriesStore",
    "Tracer",
    "TrendDetector",
    "acquire_profiler",
    "aggregate_breakdowns",
    "assemble",
    "breakdowns_from_spans",
    "check_conservation",
    "chrome_trace",
    "collect_lineage",
    "configure_tracing",
    "default_rules",
    "extract_trace",
    "format_lineage",
    "get_tracer",
    "load_spans",
    "observe_compile",
    "release_profiler",
    "sample_device_memory",
    "summarize_store",
    "top_stages",
]
