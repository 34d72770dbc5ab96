"""``testing/autotune_split.py``: the autotune gate's arms with every
process traced and each acked request's latency split by critical-path
edge. The gate itself is not run here (its quick preset boots six
multi-process clusters, twice); its arm runner is replaced by one that
writes span dumps as a traced arm would, so the wrapper's plumbing and
the split's arithmetic are checked on the CPU in well under a second.
"""

from __future__ import annotations

import json
import os

from zeebe_tpu_torch.observability.critical_path import EDGES
from zeebe_tpu_torch.observability.tracer import get_tracer
from zeebe_tpu_torch.testing import autotune
from zeebe_tpu_torch.testing import autotune_split as S


def _breakdown(total: float, **edges) -> dict:
    return {"totalUs": total, "edges": edges,
            "unattributedUs": total - sum(edges.values())}


def test_tail_means_average_the_slowest_traces():
    fast = [_breakdown(10.0, queue=4.0, coalesce=6.0) for _ in range(198)]
    slow = [_breakdown(1000.0, queue=700.0, fsync=200.0),
            _breakdown(500.0, queue=300.0, coalesce=100.0, replicate=50.0)]
    out = S.tail_means(fast + slow)
    assert out["traces"] == 2 and out["total"] == 750.0
    assert (out["queue"], out["fsync"], out["coalesce"], out["replicate"]) == (
        500.0, 100.0, 50.0, 25.0)
    assert out["unattributed"] == 75.0 and out["device"] == 0.0
    assert set(EDGES) <= set(out)
    assert S.tail_means([]) == {}


def _span(trace: str, name: str, start: int, dur: int, **attrs) -> dict:
    return {"traceId": trace, "name": name, "startUs": start, "durUs": dur,
            "partitionId": 1, "parent": "", "attrs": attrs}


def test_run_split_traces_every_arm_and_restores_the_gate(tmp_path, monkeypatch):
    seen = []

    def fake_arm(name, overlay, cfg, directory, schedule):
        seen.append((name, os.environ.get("ZEEBE_TRACING"),
                     os.environ.get("ZEEBE_TRACE_DUMP_DIR")))
        spans = [_span("t1", "gateway.request", 0, 1000),
                 _span("t1", "gateway.coalesce_wait", 100, 400)]
        (directory / "worker-0").mkdir(parents=True, exist_ok=True)
        (directory / "worker-0" / "spans-worker-0-1.jsonl").write_text(
            "\n".join(json.dumps(s) for s in spans) + "\n")
        return {"arm": name, "envOverlay": overlay, "offered": 1, "outcomes": {"ack": 1},
                "ackedLatency": {"count": 1, "p99Ms": 1.0}, "goodputPerSec": 1.0,
                "control": {"actuators": [{"knob": "ingress.coalesceWindowMs", "value": 5.0,
                                           "minSeen": 0.0, "maxSeen": 25.0,
                                           "adjustments": 3}]},
                "violations": [], "wallSeconds": 0.0}

    monkeypatch.setattr(autotune, "run_arm", fake_arm)
    monkeypatch.setattr(autotune, "fixed_panel", lambda: {"default": {}})
    for key in ("ZEEBE_TRACING", "ZEEBE_TRACE_CAPACITY", "ZEEBE_TRACE_DUMP_DIR"):
        monkeypatch.delenv(key, raising=False)
    report = S.run_split(autotune.AutotuneConfig(rounds=1), tmp_path)
    assert autotune.run_arm is fake_arm
    assert [(n, t) for n, t, _ in seen] == [("adaptive", "1"), ("default", "1")]
    assert seen[0][2] == str(tmp_path / "adaptive-r0" / "gateway")
    assert seen[1][2] == str(tmp_path / "default-r0" / "gateway")
    # the tracer's environment and this process's tracer as they were
    assert not any(key in os.environ for key in S._TRACE_ENV)
    assert not get_tracer().enabled
    (adaptive,) = report["split"]["adaptive"]
    assert adaptive["knobs"] == {"ingress.coalesceWindowMs": {
        "value": 5.0, "seen": [0.0, 25.0], "adjustments": 3}}
    path = adaptive["criticalPath"]
    assert path["traces"] == 1 and path["totalUs"]["p50"] == 1000.0
    assert path["edges"]["coalesce"]["p50Us"] == 400.0
    assert path["unattributed"]["p50Us"] == 600.0
    assert report["arms"]["default"]["roundReports"][0]["criticalPath"]["spanDumps"] == 1
