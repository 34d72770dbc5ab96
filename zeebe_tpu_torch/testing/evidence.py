"""Shared gate-evidence plumbing: flight-dump collection and CI artifact
preservation — ONE home (the ``_collect_gate_dumps`` consolidation started
in, finished here after zlint's drift-copy rule caught the
``_collect_flight_dumps`` twins in the soak and scale-soak harnesses).

Protocols, each used by every chaos gate:

- :func:`collect_flight_dumps` — after a crash-restart, verify the broker
  left a readable flight dump newer than the restart whose rings carry the
  recovery event, and track which dumps have been claimed.
- :func:`collect_gate_dumps` — copy a gate's flight dumps out of its
  about-to-be-deleted work dir into ``<repo>/<NAME>_dumps/`` for CI
  artifact upload.
- :func:`percentile` — the one shared latency-percentile rule for gate
  reports (the serving gate's SLO math must not drift from any other
  gate's).
- :func:`collect_span_dumps` — gather the per-process span JSONL files
  (``spans-<node>-<pid>.jsonl``) a traced cluster run left behind, for the
  offline critical-path assembler.
"""

from __future__ import annotations

import json
import os
from pathlib import Path


def percentile(ordered: list, q: float) -> float:
    """Nearest-rank percentile (rank = ceil(q*n)) over an ASCENDING list,
    0 < q <= 1. Empty input yields 0.0 — a gate with no samples must gate
    on the count, not on a synthetic latency."""
    import math

    if not ordered:
        return 0.0
    rank = max(math.ceil(q * len(ordered)) - 1, 0)
    return float(ordered[min(rank, len(ordered) - 1)])


def collect_flight_dumps(data_dir: str | Path, seen: list[str],
                         since_ms: int, label: str,
                         violations: list[str]) -> None:
    """Claim the new flight dumps under ``data_dir`` for one recovery.

    The partition dumps its flight rings itself when a recovery completes;
    every gate verifies each restart left such an artifact — a readable
    dump, newer than the restart (``since_ms``, broker clock), whose rings
    carry the recovery event. Claimed paths append to ``seen`` (so the next
    restart only considers newer dumps); failures append to ``violations``
    prefixed with ``label``.
    """
    found = False
    for path in sorted(Path(data_dir).glob("flight-*.json")):
        if str(path) in seen:
            continue
        try:
            dump = json.loads(path.read_text())
        except (OSError, ValueError):
            violations.append(f"{label}: flight dump {path} is unreadable")
            continue
        if dump.get("dumpedAtMs", 0) < since_ms:
            continue
        seen.append(str(path))
        if any(ev.get("kind") == "recovery"
               for ring in dump.get("partitions", {}).values()
               for ev in ring):
            found = True
    if not found:
        violations.append(
            f"{label}: no flight dump carries the recovery event for this "
            f"restart")


def collect_span_dumps(root: str | Path) -> list[Path]:
    """Every per-process span dump under ``root`` (recursive): each traced
    process — gateway (``ZEEBE_TRACE_DUMP_DIR``) and workers (their broker
    data dirs) — writes ``spans-<node>-<pid>.jsonl`` at orderly shutdown.
    Point every process at dirs under one root and this finds them all;
    feed the result to ``critical_path.load_spans`` / ``assemble`` to merge
    the cluster's view of each trace."""
    return sorted(Path(root).rglob("spans-*.jsonl"))


def collect_gate_dumps(dump_paths, dumps_name: str, work_dir: str,
                       repo_dir: str | None = None) -> list:
    """Copy a chaos gate's flight dumps out of its (about-to-be-deleted)
    work dir into ``<repo_dir>/<dumps_name>/`` for CI artifact upload;
    returns the repo-relative copied paths. Shared by the soak, scale-soak,
    and consistency gates — one dump-preservation protocol, not three."""
    import shutil

    if repo_dir is None:
        # zeebe_tpu/testing/evidence.py -> repo root
        repo_dir = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    dumps_dir = os.path.join(repo_dir, dumps_name)
    shutil.rmtree(dumps_dir, ignore_errors=True)
    os.makedirs(dumps_dir, exist_ok=True)
    copied = []
    for dump in dump_paths:
        rel = os.path.relpath(str(dump), work_dir).replace(os.sep, "__")
        target = os.path.join(dumps_dir, rel)
        try:
            shutil.copyfile(dump, target)
            copied.append(os.path.relpath(target, repo_dir))
        except OSError:
            pass
    return copied
