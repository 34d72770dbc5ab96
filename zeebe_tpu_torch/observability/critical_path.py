"""Canopy-style critical-path attribution over merged span dumps.

 pipelined the pump — speculative cross-wave dispatch, flush-callback
acks, coalesced ingress — and the aggregate pipeline histograms stopped being
able to say what one acked request actually *waited on*: once stages overlap,
"p99 flush is high" no longer implies "requests waited on flush". Canopy
(Kaldor et al., SOSP '17) answers this with per-request latency attribution:
walk each trace's span DAG and charge every microsecond of the observed
end-to-end latency to exactly one edge. This module is that walk, offline and
pure — it consumes span dicts (``Span.to_dict()`` shape / span-JSONL lines)
and never touches the live tracer.

The edge vocabulary (every microsecond of a root's latency lands in exactly
one of these, or in ``unattributed``):

- ``queue``      — admission/backpressure acquire, processor backlog wait
- ``coalesce``   — ingress coalesce-window wait (enqueue → batch flush)
- ``replicate``  — raft append → quorum commit
- ``fsync``      — group commit → covering journal-flush callback
- ``device``     — kernel device compute (incl. mesh-runner submit)
- ``host-execute`` — host-side decode/materialize/append/sequencing
- ``reply``      — response build + dispatch back to the gateway

Attribution is an interval sweep: the root span (``gateway.request``, or a
``processor.ack`` append→ack envelope on gateway-less harnesses) defines the
window; child spans become edge-labeled intervals clipped to it; every
elementary segment of the window is charged to the covering interval with the
LATEST start (ties: the shorter span — the most specific cause wins, exactly
Canopy's "blame the deepest blocked-on edge" rule); uncovered segments are
``unattributed``. Conservation therefore holds by construction —
``sum(edges) + unattributed == total`` — and :func:`check_conservation`
re-verifies it on any (possibly hand-built or skew-damaged) breakdown.

Clock honesty: spans from different processes carry that process's wall
clock. Merging bounds skew (same host, NTP-disciplined) but does not
eliminate it — clipping to the root window keeps a skewed child from
inflating an edge past the measured total; skew instead surfaces as
``unattributed`` residual, which the bench gates below 10% of p99.

Group-batched commands (``processor.kernel_command`` with a ``group`` attr)
are substituted with their group's real interval (``processor.kernel_group``
on the ``"<partition>:g<pos>"`` trace) and the charged time is split across
``device`` / ``fsync`` / ``host-execute`` by the group's measured stage
fractions — a request that rode a wave waited the wave's wall, not its
1/N accounting share.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

# the closed edge vocabulary — aggregation reports every edge (zero-filled)
# so scenario breakdowns are comparable across runs
# copied from the reference: EDGES .. _EDGE_BY_NAME
EDGES = ("queue", "coalesce", "replicate", "fsync", "device", "host-execute",
         "reply")

# span name → edge. Names mapped to None are markers/roots handled specially.
_EDGE_BY_NAME = {
    "gateway.admission": "queue",
    "broker.backpressure_acquire": "queue",
    "processor.backlog_wait": "queue",
    "gateway.coalesce_wait": "coalesce",
    "raft.replicate": "replicate",
    "processor.fsync_wait": "fsync",
    "processor.stage.device": "device",
    "kernel.mesh_submit": "device",
    "processor.speculative": "device",
    "broker.command_append": "host-execute",
    "processor.command": "host-execute",
    "processor.reply_release": "reply",
    "gateway.reply": "reply",
}
# end of the copy

# group stage → edge, for splitting a group interval's charged time; the
# device stage is two spans, the first chunk's dispatch and the wait for the
# device, both device time (the overlap is the group's attribute, no stage)
_STAGE_EDGE = {
    "processor.stage.decode": "host-execute",
    "processor.stage.dispatch": "device",
    "processor.stage.device": "device",
    "processor.stage.materialize": "host-execute",
    "processor.stage.append": "host-execute",
    "processor.stage.flush": "fsync",
}

# copied from the reference: _ROOT_NAMES .. LatencyObservatory
_ROOT_NAMES = ("gateway.request", "processor.ack")


# -- assembly -----------------------------------------------------------------


def load_spans(paths) -> list[dict]:
    """Read span dicts from JSONL dump files (one span object per line);
    unreadable lines are skipped — a torn final line from a killed worker
    must not void the rest of the dump."""
    spans: list[dict] = []
    for path in paths:
        try:
            text = Path(path).read_text()
        except OSError:
            continue
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                span = json.loads(line)
            except ValueError:
                continue
            if isinstance(span, dict) and "traceId" in span:
                spans.append(span)
    return spans


def assemble(span_dicts) -> dict[str, list[dict]]:
    """Merge spans (from any number of processes) into one map
    ``trace id → spans``, ordered by start time within each trace. The trace
    id is DERIVED (``"<partition>:<root position>"``) identically on both
    sides of every process boundary, so merging is a plain group-by — no
    wire-level context propagation exists to get wrong."""
    traces: dict[str, list[dict]] = {}
    for span in span_dicts:
        traces.setdefault(span["traceId"], []).append(span)
    for spans in traces.values():
        spans.sort(key=lambda s: (s.get("startUs", 0), s.get("durUs", 0)))
    return traces


# -- per-trace extraction -----------------------------------------------------


def _attr(span: dict, key: str):
    attrs = span.get("attrs")
    return attrs.get(key) if isinstance(attrs, dict) else None


def _group_fractions(group_spans: list[dict]) -> dict[str, float]:
    """Edge fractions of a kernel group's wall, from its measured stage
    spans; empty when the group dump carries no stages (charge everything
    to host-execute then — honest about what was measured)."""
    by_edge: dict[str, float] = {}
    for span in group_spans:
        edge = _STAGE_EDGE.get(span.get("name", ""))
        if edge is not None:
            by_edge[edge] = by_edge.get(edge, 0.0) + max(span.get("durUs", 0), 0)
    total = sum(by_edge.values())
    if total <= 0:
        return {}
    return {edge: dur / total for edge, dur in by_edge.items()}


def extract_trace(spans: list[dict], traces: dict | None = None) -> list[dict]:
    """All breakdowns of one trace: one per root span (a trace spanning a
    whole instance lifetime holds several ack envelopes — each is its own
    attribution window). Traces with no root (infra/group traces, or
    processor-only spans whose ack fell off the ring) yield nothing."""
    roots = [s for s in spans if s.get("name") in _ROOT_NAMES]
    # prefer the gateway view when both exist: processor.ack envelopes nest
    # inside it and double-reporting the same wait would skew aggregation
    if any(s.get("name") == "gateway.request" for s in roots):
        roots = [s for s in roots if s.get("name") == "gateway.request"]
    return [_extract_one(root, spans, traces) for root in roots]


def _extract_one(root: dict, spans: list[dict],
                 traces: dict | None) -> dict:
    r0 = root.get("startUs", 0)
    r1 = r0 + max(root.get("durUs", 0), 0)
    root_pos = _attr(root, "position")
    # (start, end, latest-start priority key, edge-or-fractions)
    intervals: list[tuple[int, int, str | dict]] = []
    for span in spans:
        if span is root or span.get("name") in _ROOT_NAMES:
            continue
        if _attr(span, "outcome") == "discarded":
            continue  # discarded speculative work is off the request's path
        pos = _attr(span, "position")
        if root_pos is not None and pos is not None and pos != root_pos:
            continue  # a processor.ack window only owns its own command
        name = span.get("name", "")
        s0 = span.get("startUs", 0)
        s1 = s0 + max(span.get("durUs", 0), 0)
        edge: str | dict | None
        if name == "processor.kernel_command":
            edge = "host-execute"
            group_id = _attr(span, "group")
            group_spans = traces.get(group_id) if traces and group_id else None
            if group_spans:
                for gspan in group_spans:
                    if gspan.get("name") == "processor.kernel_group":
                        s0 = gspan.get("startUs", s0)
                        s1 = s0 + max(gspan.get("durUs", 0), 0)
                        break
                fractions = _group_fractions(group_spans)
                if fractions:
                    edge = fractions
        else:
            edge = _EDGE_BY_NAME.get(name)
        if edge is None:
            continue
        s0, s1 = max(s0, r0), min(s1, r1)  # clip: skew can't exceed the root
        if s1 > s0:
            intervals.append((s0, s1, edge))

    edges = {edge: 0.0 for edge in EDGES}
    covered = 0.0
    bounds = sorted({r0, r1, *(i[0] for i in intervals),
                     *(i[1] for i in intervals)})
    for seg0, seg1 in zip(bounds, bounds[1:]):
        best = None
        for s0, s1, edge in intervals:
            if s0 <= seg0 and s1 >= seg1:
                # latest start wins; tie → shorter span (most specific cause)
                key = (s0, -(s1 - s0))
                if best is None or key > best[0]:
                    best = (key, edge)
        if best is None:
            continue
        length = seg1 - seg0
        covered += length
        edge = best[1]
        if isinstance(edge, dict):
            for sub_edge, frac in edge.items():
                edges[sub_edge] += length * frac
        else:
            edges[edge] += length
    total = r1 - r0
    out = {
        "traceId": root.get("traceId", ""),
        "rootName": root.get("name", ""),
        "totalUs": float(total),
        "edges": {edge: round(value, 3) for edge, value in edges.items()},
        "unattributedUs": round(max(total - covered, 0.0), 3),
    }
    if root_pos is not None:
        out["position"] = root_pos
    return out


def breakdowns_from_spans(span_dicts) -> list[dict]:
    """Assemble + extract in one shot: every rooted attribution window in a
    span dump (cluster-merged or single-process)."""
    traces = assemble(span_dicts)
    out: list[dict] = []
    for spans in traces.values():
        out.extend(extract_trace(spans, traces))
    return out


# -- conservation -------------------------------------------------------------


def check_conservation(breakdown: dict, tolerance_frac: float = 0.005,
                       floor_us: float = 2.0) -> list[str]:
    """Violations of the attribution invariant on ONE breakdown: every edge
    non-negative, and ``sum(edges) + unattributed == total`` within
    ``tolerance_frac`` of the total (``floor_us`` absorbs rounding on
    microsecond-scale roots). The extractor satisfies this by construction —
    the check exists so hand-built or post-processed breakdowns (and any
    future extractor bug) fail loudly instead of mis-reporting."""
    violations: list[str] = []
    total = breakdown.get("totalUs", 0.0)
    unatt = breakdown.get("unattributedUs", 0.0)
    if total < 0:
        violations.append(f"negative total: {total}")
    if unatt < 0:
        violations.append(f"negative unattributed: {unatt}")
    edge_sum = 0.0
    for edge, value in breakdown.get("edges", {}).items():
        if value < 0:
            violations.append(f"negative edge {edge}: {value}")
        else:
            edge_sum += value
    drift = abs(edge_sum + unatt - total)
    if drift > max(tolerance_frac * abs(total), floor_us):
        violations.append(
            f"edge sum {edge_sum:.1f} + unattributed {unatt:.1f} != "
            f"total {total:.1f} (drift {drift:.1f}us)")
    return violations


# -- aggregation --------------------------------------------------------------


def _percentile(ordered: list, q: float) -> float:
    from zeebe_tpu_torch.testing.evidence import percentile

    return percentile(ordered, q)


def aggregate_breakdowns(breakdowns: list[dict]) -> dict:
    """Per-edge critical-path contribution p50/p99 over a set of
    breakdowns (one bench scenario, one serving window). Absent edges count
    as 0 for a trace — the percentiles answer "how much of a request's
    latency is this stage", not "how slow is this stage when it appears"."""
    if not breakdowns:
        return {"traces": 0}
    totals = sorted(b["totalUs"] for b in breakdowns)
    residuals = sorted(b["unattributedUs"] for b in breakdowns)
    out_edges = {}
    for edge in EDGES:
        values = sorted(b["edges"].get(edge, 0.0) for b in breakdowns)
        out_edges[edge] = {
            "p50Us": round(_percentile(values, 0.50), 1),
            "p99Us": round(_percentile(values, 0.99), 1),
        }
    total_p99 = _percentile(totals, 0.99)
    residual_p99 = _percentile(residuals, 0.99)
    return {
        "traces": len(breakdowns),
        "totalUs": {"p50": round(_percentile(totals, 0.50), 1),
                    "p99": round(total_p99, 1)},
        "edges": out_edges,
        "unattributed": {
            "p50Us": round(_percentile(residuals, 0.50), 1),
            "p99Us": round(residual_p99, 1),
            # the conservation headline: residual p99 as a fraction of
            # measured p99 — the bench gates this below 0.10
            "fracOfP99": round(residual_p99 / total_p99, 4) if total_p99 else 0.0,
        },
    }


def top_stages(aggregate: dict, n: int = 3) -> list[dict]:
    """The ``n`` largest critical-path contributors by p99 — the GWP loop's
    "fix the top contributor" list. Zero-contribution edges are dropped;
    ``unattributed`` is reported by the caller separately, not ranked."""
    edges = aggregate.get("edges", {})
    ranked = sorted(edges.items(), key=lambda kv: -kv[1]["p99Us"])
    return [{"stage": edge, "p99Us": stats["p99Us"], "p50Us": stats["p50Us"]}
            for edge, stats in ranked[:n] if stats["p99Us"] > 0]


# -- live observatory (slow exemplars + flight events) ------------------------


class LatencyObservatory:
    """Per-partition windowed latency watcher: tracks the N worst acked
    traces per window, and on window roll (a) records ONE bounded
    ``critical_path`` flight event with the window's top critical-path
    stages, and (b) dumps the worst traces' full span trees through the
    flight recorder (``ZEEBE_FLIGHT_MAXDUMPBYTES`` applies) — so a p99
    breach always ships its own explanation.

    ``observe`` is called at ack release under the tracer's ``enabled``
    guard; off-path cost is zero. Extraction work happens once per window
    (N≤``worst_n`` traces), never per ack.
    """

    def __init__(self, tracer, flight, partition_id: int,
                 window_s: float = 5.0, worst_n: int = 3,
                 clock=time.monotonic) -> None:
        self.tracer = tracer
        self.flight = flight
        self.partition_id = partition_id
        self.window_s = window_s
        self.worst_n = max(worst_n, 1)
        self._clock = clock
        self._window_start = clock()
        self._worst: list[tuple[float, str]] = []  # (latency_s, trace_id)
        self._acks = 0
        self.last_top_stages: list[dict] = []
        self.last_window_acks = 0
        self.last_worst_ms = 0.0

    def observe(self, trace_id: str, latency_s: float) -> None:
        now = self._clock()
        if now - self._window_start >= self.window_s:
            self.roll(now)
        self._acks += 1
        worst = self._worst
        if len(worst) < self.worst_n:
            worst.append((latency_s, trace_id))
            worst.sort(reverse=True)
        elif latency_s > worst[-1][0]:
            worst[-1] = (latency_s, trace_id)
            worst.sort(reverse=True)

    def roll(self, now: float | None = None) -> None:
        """Close the current window: flight event + exemplar dump."""
        self._window_start = self._clock() if now is None else now
        worst, acks = self._worst, self._acks
        self._worst, self._acks = [], 0
        if not worst:
            return
        exemplar_ids = {trace_id for _, trace_id in worst}
        # one snapshot per window (ring-bounded), never per ack; the full
        # assembly is needed anyway so exemplars can resolve group traces
        traces = assemble(s.to_dict()
                          for s in self.tracer.collector.snapshot())
        breakdowns: list[dict] = []
        for trace_id in exemplar_ids:
            spans = traces.get(trace_id)
            if spans:
                breakdowns.extend(extract_trace(spans, traces))
        aggregate = aggregate_breakdowns(breakdowns)
        self.last_top_stages = top_stages(aggregate)
        self.last_window_acks = acks
        self.last_worst_ms = round(worst[0][0] * 1000.0, 3)
        if self.flight is None:
            return
        self.flight.record(
            self.partition_id, "critical_path",
            windowAcks=acks,
            worstMs=[round(latency * 1000.0, 3) for latency, _ in worst],
            topStages=self.last_top_stages,
            unattributedP99Us=aggregate.get("unattributed", {}).get("p99Us"),
        )
        exemplars = {
            trace_id: [span for span in traces.get(trace_id, ())]
            for _, trace_id in worst if trace_id in traces
        }
        if exemplars:
            self.flight.dump_payload("slow-exemplars", {
                "partitionId": self.partition_id,
                "worstMs": self.last_worst_ms,
                "topStages": self.last_top_stages,
                "traces": exemplars,
            })

    def status(self) -> dict | None:
        """The ``criticalPath`` block for ``/cluster/status`` — None until a
        window has rolled with data."""
        if not self.last_top_stages:
            return None
        return {
            "topStages": self.last_top_stages,
            "windowAcks": self.last_window_acks,
            "worstMs": self.last_worst_ms,
        }
# end of the copy
