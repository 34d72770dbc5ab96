"""Charging each idle microsecond of the card to the host layer that held
it, and the other numbers the program's spans give a traced window.

A run with the program's tracer on holds two records on one clock, the
wall clock in microseconds (``zeebe_tpu_torch.observability.host_spans``):
the device trace, whose events' ``ts`` count from its
``baseTimeNanoseconds``, and the program's spans. Over the window the card
is idle wherever no device operation runs. Each idle microsecond is charged
to exactly one layer: that of the span, among those ``LAYERS`` maps, that
covers it and started last (Canopy's latest-start rule, as the program's
``critical_path`` charges a request's time; a tie goes to the shorter). A
microsecond no such span covers is ``unattributed``. So the parts sum to
the idle time.

Spans ``LAYERS`` leaves out: envelopes that cover what deeper spans say
better (``processor.ack``, from a command's append to its reply), waits in
a queue (``processor.backlog_wait``), shares rather than intervals
(``processor.kernel_command``), the speculation's marker and the reply's
release, and the exporters, which no metric here reads.

The table from span name to layer is the benchmark's, not the program's.
``READERS`` are the per-layer metrics read from a :class:`SpanWindow`
beside ``window.Window``; each returns None where its window lost spans
(the collector's ring evicted some) or holds nothing to read, never a
partial number."""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from types import SimpleNamespace

from zbench import roofline
from zbench.trace import DEVICE_CATEGORIES

#: span name -> layer; a key ending in "." names every span it begins
LAYERS = {
    "journal.flush": "journal", "raft.replicate": "journal",
    "processor.stage.flush": "journal", "processor.fsync_wait": "journal",
    "processor.kernel_group": "processor", "processor.stage.decode": "processor",
    "processor.stage.materialize": "processor", "processor.stage.append": "processor",
    "processor.command": "processor",
    "processor.stage.dispatch": "device_loop", "processor.stage.device": "device_loop",
    "kernel.mesh_submit": "device_loop",
    "gateway.": "gateway", "broker.": "gateway",
    "runtime.gc": "gc",
}
UNATTRIBUTED = "unattributed"
#: the parts of the idle time, each an ``idle_<part>_ms_per_instance`` metric
PARTS = ("journal", "processor", "device_loop", "gateway", "gc", UNATTRIBUTED)
#: the longest gaps labelled, as ``trace.reduce`` keeps them
GAPS_KEPT = 10


def layer_of(name: str) -> str | None:
    layer = LAYERS.get(name)
    if layer is None:
        layer = next((v for k, v in LAYERS.items() if k.endswith(".") and name.startswith(k)),
                     None)
    return layer


@dataclass
class SpanWindow:
    """What the program's tracer gave over a traced window: its spans
    (``Span`` objects), how many the collector evicted, the window on the
    span clock, the device trace's base (us) and events (``None`` off the
    card), and the automaton calls' geometry counted in the window."""

    spans: list
    evicted: int
    opened_us: float
    closed_us: float
    base_us: float | None = None
    device_events: list | None = None
    geometry: list = field(default_factory=list)

    def named(self, name: str) -> list:
        """The spans called ``name`` that started in the window."""
        return [s for s in self.spans
                if s.name == name and self.opened_us <= s.start_us < self.closed_us]


def device_intervals(events: list[dict]) -> list[tuple[float, float, str]]:
    """Each device operation's (start, end, name), as ``trace.reduce`` reads
    them: microseconds from the trace's base."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                  for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)


def span_marks(spans, base_us: float) -> list[tuple[float, float, str]]:
    """The spans ``LAYERS`` maps as (start, end, name), shifted onto the
    device trace's time (microseconds from its base)."""
    return [(s.start_us - base_us, s.start_us + s.dur_us - base_us, s.name)
            for s in spans if s.dur_us > 0 and layer_of(s.name) is not None]


def idle_intervals(device: list[tuple[float, float, str]],
                   window: tuple[float, float]) -> list[tuple[float, float]]:
    """The stretches of ``window`` in which no device operation runs."""
    w0, w1 = window
    out, at = [], w0
    for start, end, _ in device:
        if start > at:
            out.append((at, min(start, w1)))
        at = max(at, end)
        if at >= w1:
            break
    if at < w1:
        out.append((at, w1))
    return [(a, b) for a, b in out if b > a]


def gaps(device: list[tuple[float, float, str]]) -> list[tuple[float, str, float, float]]:
    """``trace.reduce``'s gaps between device operations, longest first, each
    as (microseconds, label, start, end)."""
    out = []
    end, last_name = None, None
    for start, stop, name in device:
        if end is None or start >= end:
            if end is not None:
                out.append((start - end, f"after {last_name} before {name}", end, start))
            end, last_name = stop, name
        elif stop > end:
            end, last_name = stop, name
    out.sort(key=lambda g: (g[0], g[1]), reverse=True)
    return out


def charge(idle: list[tuple[float, float]],
           spans: list[tuple[float, float, str]]) -> list[list[tuple[float, str, str]]]:
    """For each idle stretch, its pieces as (microseconds, layer, span name):
    each piece's microseconds charged to the covering span (start, end,
    name, on the same time as ``idle``) that started last (a tie to the
    shorter), or to ``unattributed``."""
    marks = sorted((s0, s1, name, layer_of(name)) for s0, s1, name in spans)
    out = []
    active: list = []  # heap of (-start, length, end, name, layer)
    k = 0
    for a, b in idle:
        pieces: list[tuple[float, str, str]] = []
        at = a
        while at < b:
            while k < len(marks) and marks[k][0] <= at:
                s0, s1, name, layer = marks[k]
                heapq.heappush(active, (-s0, s1 - s0, s1, name, layer))
                k += 1
            while active and active[0][2] <= at:
                heapq.heappop(active)
            # the piece ends where a span starts or the covering one ends:
            # the spans under it started before it, so none of their ends
            # changes which one started last
            nxt = b if k >= len(marks) else min(b, marks[k][0])
            if active:
                top = active[0]
                nxt = min(nxt, top[2])
                pieces.append((nxt - at, top[4], top[3]))
            else:
                pieces.append((nxt - at, UNATTRIBUTED, UNATTRIBUTED))
            at = nxt
        out.append(pieces)
    return out


def attribute(sw: SpanWindow) -> dict | None:
    """The window's idle time charged to layers: ``idle_us``, ``by_layer``
    and ``by_span`` (microseconds), and ``gaps``, the ten longest gaps
    between device operations as ``trace.reduce`` labels them, each label
    led by the layer and span charged most of it. None off the card."""
    if sw.device_events is None or sw.base_us is None:
        return None
    device = device_intervals(sw.device_events)
    w0, w1 = sw.opened_us - sw.base_us, sw.closed_us - sw.base_us
    marks = span_marks(sw.spans, sw.base_us)
    idle = idle_intervals(device, (w0, w1))
    pieces = charge(idle, marks)
    by_layer = {part: 0.0 for part in PARTS}
    by_span: dict[str, float] = {}
    for stretch in pieces:
        for us, layer, name in stretch:
            by_layer[layer] += us
            by_span[name] = by_span.get(name, 0.0) + us
    longest = gaps(device)[:GAPS_KEPT]
    labelled = []
    for us, label, g0, g1 in longest:
        (part,) = charge([(max(g0, w0), min(g1, w1))], marks)
        most: dict[tuple[str, str], float] = {}
        for piece_us, layer, name in part:
            most[(layer, name)] = most.get((layer, name), 0.0) + piece_us
        layer, name = max(most, key=most.get) if most else (UNATTRIBUTED, UNATTRIBUTED)
        labelled.append([gap_label(layer, name, label), us / 1e6])
    return {"idle_us": sum(b - a for a, b in idle), "by_layer": by_layer,
            "by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
            "gaps": labelled}


def gap_label(layer: str, name: str, label: str) -> str:
    """A gap's label led by the layer and span charged most of it
    (``journal:journal.flush | after ... before ...``)."""
    if layer == UNATTRIBUTED:
        return f"{UNATTRIBUTED} | {label}"
    return f"{layer}:{name} | {label}"


# -- the readers -----------------------------------------------------------------


def _whole(sw: SpanWindow | None) -> bool:
    """Whether the window kept every span it emitted."""
    return sw is not None and sw.evicted == 0


def idle_ms_per_instance(window, sw: SpanWindow | None, part: str) -> float | None:
    """Idle milliseconds charged to ``part`` per instance ended in the window."""
    if not _whole(sw) or not window.e2e.get("instances"):
        return None
    charged = attribute(sw)
    if charged is None:
        return None
    return charged["by_layer"][part] / 1e3 / window.e2e["instances"]


def _mean_ms(sw: SpanWindow | None, name: str) -> float | None:
    if not _whole(sw):
        return None
    spans = sw.named(name)
    return sum(s.dur_us for s in spans) / len(spans) / 1e3 if spans else None


def _kernel(name: str) -> str:
    """``(anonymous namespace)::k_chunk(ZtTables, ...)`` -> ``k_chunk``."""
    if name.endswith(")"):
        name = name[:name.rfind("(")]
    return name.rsplit("::", 1)[-1]


class _Sized:
    """A stand-in for a tensor of ``nbytes`` bytes: what ``roofline`` asks."""

    def __init__(self, nbytes: int) -> None:
        self.nbytes = nbytes

    def numel(self) -> int:
        return self.nbytes

    def element_size(self) -> int:
        return 1


def bound_ms(geometry: dict) -> float:
    """``roofline.bound_ms`` of one call of a counted geometry."""
    dt = SimpleNamespace(**{n: _Sized(b) for n, b in geometry["tables"].items()})
    state = {n: _Sized(b) for n, b in geometry["state"].items()}
    config = SimpleNamespace(**geometry["flags"])
    return roofline.bound_ms(dt, state, config, geometry["out_bytes"])


def kernel_roofline_pct(window, sw: SpanWindow | None) -> float | None:
    """The automaton calls' least time at the HBM rate over their kernels'
    (``k_*``, the decision kernels left out) time in the trace."""
    if not _whole(sw) or not sw.geometry or window.trace is None:
        return None
    seconds = sum(s for name, (s, _) in window.trace["ops"].items()
                  if _kernel(name).startswith("k_") and not _kernel(name).startswith("k_decision"))
    if not seconds:
        return None
    bound = sum(g["calls"] * bound_ms(g) for g in sw.geometry)
    return 100.0 * bound / (seconds * 1e3)


READERS = {
    **{f"idle_{part}_ms_per_instance":
       (lambda part: lambda w, sw: idle_ms_per_instance(w, sw, part))(part) for part in PARTS},
    "commit_wait_ms": lambda w, sw: _mean_ms(sw, "raft.replicate"),
    "submit_lock_wait_ms": lambda w, sw: _mean_ms(sw, "gateway.partition_lock"),
    "kernel_roofline_pct": kernel_roofline_pct,
}
#: each reader's unit
UNITS = {**{f"idle_{part}_ms_per_instance": "ms" for part in PARTS},
         "commit_wait_ms": "ms", "submit_lock_wait_ms": "ms", "kernel_roofline_pct": "%"}


def geometry_moved(before: list[dict], after: list[dict]) -> list[dict]:
    """The calls counted between two ``automaton.geometry_counts()``."""
    def key(g):
        return (g["path"], tuple(sorted(g["flags"].items())), tuple(g["tables"].items()),
                tuple(g["state"].items()), g["out_bytes"])

    old = {key(g): g["calls"] for g in before}
    out = []
    for g in after:
        calls = g["calls"] - old.get(key(g), 0)
        if calls > 0:
            out.append({**g, "calls": calls})
    return out
