"""Run one cell once as ``run.py --trace 1`` does, with the program's own
tracer on over the window, and charge the card's idle time to the host
layers that held it.

    python3 zbench/spans_run.py --workload <cell> --seed <n> --seconds <s>

It is ``run.py``'s traced run (the same set-up, window, judge and result
line) with four additions: the program's tracer (``configure_tracing``,
seeded by the run's seed) is enabled as the window opens and its spans
taken as it closes; the device trace keeps its events and its
``baseTimeNanoseconds``; the result's ``metrics`` gain the readers of
``attribution.READERS``; and ``breakdown.idle_gaps`` lead each label with
the layer charged most of the gap, beside ``attribution`` (the idle
microseconds by layer and by span name, the spans taken, the spans lost).
Comparing its per-layer metrics with ``run.py --trace 1`` on the same seeds
gives the tracer's cost."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from zbench import attribution, run, trace, window  # noqa: E402

#: the span ring's size over a window: well above what a cell emits in it
CAPACITY = 1 << 18


class _Session:
    """One run's tracer window, opened and closed at the two readings of the
    program's registry that bound ``run.run_cell``'s window."""

    def __init__(self, seed: int) -> None:
        self.seed = seed
        self.readings = 0
        self.geometry: list[dict] = []
        self.spans: attribution.SpanWindow | None = None
        self.opened_us = 0.0
        self.trace_opened_us: float | None = None
        self.window = None
        self.raw: dict | None = None

    def reading(self) -> None:
        from zeebe_tpu_torch.observability import configure_tracing, get_tracer, host_spans
        from zeebe_tpu_torch.observability.span import now_us
        from zeebe_tpu_torch.ops import automaton as A

        self.readings += 1
        if self.readings == 1:
            self.geometry = A.geometry_counts()
            configure_tracing(enabled=True, seed=self.seed, capacity=CAPACITY)
            self.opened_us = now_us()
        elif self.readings == 2:
            tracer = get_tracer()
            closed = now_us()
            host_spans.drain_gc(tracer)
            spans = tracer.collector.snapshot()
            evicted = tracer.collector.emitted - len(spans)
            configure_tracing(enabled=False)
            self.spans = attribution.SpanWindow(
                spans, evicted, self.opened_us, closed,
                geometry=attribution.geometry_moved(self.geometry, A.geometry_counts()))


def _patched(session: _Session):
    """``run.run_cell``'s collaborators with the session's hooks."""
    registry_state = window.registry_state

    def reading(registry):
        session.reading()
        return registry_state(registry)

    class SpannedTrace(trace.DeviceTrace):
        def __init__(self) -> None:
            from zeebe_tpu_torch.observability.span import now_us

            super().__init__()
            session.trace_opened_us = now_us()

        def stop(self) -> dict:
            import os
            import tempfile
            import time

            self._prof.__exit__(None, None, None)
            self.window_s = time.monotonic() - self.started
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    session.raw = json.load(f)
            finally:
                os.unlink(path)
            return trace.reduce(session.raw.get("traceEvents", []), self.window_s)

    class KeptWindow(window.Window):
        def __init__(self, *args, **kwargs) -> None:
            super().__init__(*args, **kwargs)
            session.window = self

    return reading, SpannedTrace, KeptWindow


def run_cell(cell, seed: int, seconds: float, trace_on: bool, device, fault=None) -> dict:
    """``run.run_cell`` with the program's spans over the window (see the
    module's docstring)."""
    session = _Session(seed)
    reading, spanned, kept = _patched(session)
    saved = (window.registry_state, trace.DeviceTrace, window.Window)
    window.registry_state, trace.DeviceTrace, window.Window = reading, spanned, kept
    try:
        result = _RUN_CELL(cell, seed, seconds, True, device, fault)
    finally:
        window.registry_state, trace.DeviceTrace, window.Window = saved
    sw = session.spans
    if sw is not None and session.raw is not None:
        # the span window inside the device trace's
        sw.opened_us = max(sw.opened_us, session.trace_opened_us or sw.opened_us)
        sw.base_us = session.raw["baseTimeNanoseconds"] / 1000  # int / int: rounded once
        sw.device_events = session.raw.get("traceEvents", [])
    checks = result.pop("checks")
    for name, read in attribution.READERS.items():
        value = read(session.window, sw)
        if value is not None:
            result["metrics"][name] = {"value": value, "unit": attribution.UNITS[name]}
    charged = attribution.attribute(sw) if sw is not None and sw.evicted == 0 else None
    if charged is not None:
        result["breakdown"]["idle_gaps"] = charged["gaps"]
        instances = session.window.e2e.get("instances") or 0
        result["attribution"] = {
            "idle_ms_per_instance": charged["idle_us"] / 1e3 / instances if instances else None,
            "idle_us": charged["idle_us"], "by_layer_us": charged["by_layer"],
            "by_span_us": charged["by_span"]}
    if sw is not None:
        result.setdefault("attribution", {}).update(
            spans=len(sw.spans), evicted=sw.evicted,
            window_us=sw.closed_us - sw.opened_us,
            geometry=[{k: g[k] for k in ("path", "flags", "out_bytes", "calls")}
                      for g in sw.geometry])
    result["checks"] = checks
    return result


_RUN_CELL = run.run_cell


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="zbench/spans_run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    run.run_cell = run_cell
    try:
        return run.main(["--workload", args.workload, "--seed", str(args.seed),
                         "--seconds", str(args.seconds), "--trace", "1"])
    finally:
        run.run_cell = _RUN_CELL


if __name__ == "__main__":
    sys.exit(main())
