"""Where each arm of the autotune gate spends its acked latency.

    python -m zeebe_tpu_torch.testing.autotune_split [--quick] [--device cpu]
        [--seed N] [--out FILE]

Runs the autotune gate (``testing/autotune.py``, unchanged; its quick or
full preset, the workers on the card unless ``--device cpu``) with the
tracer on in every process, through the tracer's own environment
(``ZEEBE_TRACING=1``, a ring of ``ZEEBE_TRACE_CAPACITY`` spans): each
worker dumps its spans under its data directory at its orderly stop, and
the gateway's ring, cleared before each arm, under the arm's directory
(``ZEEBE_TRACE_DUMP_DIR``). After each arm the merged span dumps go
through ``observability.critical_path``, which charges every microsecond
of an acked request's latency to one edge: ``coalesce`` (the ingress
coalescing wait), ``replicate`` and ``fsync`` (the Raft commit wait),
``device`` (the kernel dispatch), ``queue``, ``host-execute``, ``reply``,
or ``unattributed``. Per arm and round it reports the gate's acked p50 and
p99, each edge's p50 and p99 contribution and its mean over the slowest 1%
of traces, and the plane's knobs as its audit trail left them. Prints one
JSON object (also written to ``--out``): the gate's report, its verdict
unchanged, with ``criticalPath`` beside every round and a per-arm
``split`` summary. Exit 1 where the gate found a violation, as the gate's
own command line does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from pathlib import Path

#: spans each process's ring holds: a quick arm's ~1,500 requests leave
#: several spans each in every process they touch
TRACE_CAPACITY = 1 << 18


def tail_means(breakdowns: list[dict], frac: float = 0.01) -> dict:
    """Each edge's mean microseconds over the slowest ``frac`` of traces."""
    from zeebe_tpu_torch.observability.critical_path import EDGES

    if not breakdowns:
        return {}
    slow = sorted(breakdowns, key=lambda b: -b["totalUs"])[:max(1, round(frac * len(breakdowns)))]
    out = {edge: round(sum(b["edges"].get(edge, 0.0) for b in slow) / len(slow), 1)
           for edge in EDGES}
    out["unattributed"] = round(sum(b["unattributedUs"] for b in slow) / len(slow), 1)
    out["total"] = round(sum(b["totalUs"] for b in slow) / len(slow), 1)
    out["traces"] = len(slow)
    return out


def critical_path(directory: Path) -> dict:
    """The critical-path split of one arm's acked requests from the span
    dumps under its directory."""
    from zeebe_tpu_torch.observability.critical_path import (
        aggregate_breakdowns,
        breakdowns_from_spans,
        load_spans,
    )
    from zeebe_tpu_torch.testing.evidence import collect_span_dumps

    dumps = collect_span_dumps(directory)
    breakdowns = breakdowns_from_spans(load_spans(dumps))
    return {"spanDumps": len(dumps), **aggregate_breakdowns(breakdowns),
            "slowest1pct": tail_means(breakdowns)}


def knobs(report: dict) -> dict:
    """The plane's knobs as an arm's audit trail left them: each actuator's
    final value and the range it was seen in."""
    return {a["knob"]: {"value": a["value"], "seen": [a["minSeen"], a["maxSeen"]],
                        "adjustments": a["adjustments"]}
            for a in report.get("control", {}).get("actuators", [])}


_TRACE_ENV = ("ZEEBE_TRACING", "ZEEBE_TRACE_CAPACITY", "ZEEBE_TRACE_DUMP_DIR")


def run_split(cfg, directory) -> dict:
    """``run_autotune`` with every arm traced and split; the tracer's
    environment and this process's tracer are as they were after it."""
    from zeebe_tpu_torch.observability.tracer import get_tracer
    from zeebe_tpu_torch.testing import autotune

    saved_env = {key: os.environ.get(key) for key in _TRACE_ENV}
    tracer = get_tracer()
    was_enabled = tracer.enabled
    os.environ["ZEEBE_TRACING"] = "1"
    os.environ["ZEEBE_TRACE_CAPACITY"] = str(TRACE_CAPACITY)
    run_arm = autotune.run_arm

    def traced_arm(name, overlay, arm_cfg, arm_dir, schedule):
        os.environ["ZEEBE_TRACE_DUMP_DIR"] = str(Path(arm_dir) / "gateway")
        tracer.enable(capacity=TRACE_CAPACITY)  # the gateway's ring, cleared
        report = run_arm(name, overlay, arm_cfg, arm_dir, schedule)
        report["criticalPath"] = critical_path(Path(arm_dir))
        report["knobs"] = knobs(report)
        return report

    autotune.run_arm = traced_arm
    try:
        report = autotune.run_autotune(cfg, directory)
    finally:
        autotune.run_arm = run_arm
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        if not was_enabled:
            tracer.disable()
            tracer.clear()
    report["split"] = {
        name: [{"ackedLatency": r["ackedLatency"], "criticalPath": {
            k: r["criticalPath"].get(k) for k in ("traces", "totalUs", "edges",
                                                   "unattributed", "slowest1pct")},
            "knobs": r["knobs"]} for r in arm["roundReports"]]
        for name, arm in report["arms"].items()}
    return report


def main(argv: list[str] | None = None) -> int:
    from zeebe_tpu_torch.testing.autotune import FULL_CONFIG, AutotuneConfig

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--device", default=None,
                        help="the workers' kernel backend device (default: the card; "
                             "cpu runs the plain version)")
    parser.add_argument("--out", default=None, help="also write the report here")
    args = parser.parse_args(argv)
    cfg = dataclasses.replace(AutotuneConfig() if args.quick else FULL_CONFIG,
                              seed=args.seed, device=args.device)
    with tempfile.TemporaryDirectory(prefix="zeebe-autotune-split-") as tmp:
        report = run_split(cfg, tmp)
    text = json.dumps(report, indent=1)
    if args.out:
        Path(args.out).write_text(text)
    print(text)
    return 1 if report["violations"] else 0


if __name__ == "__main__":
    sys.exit(main())
