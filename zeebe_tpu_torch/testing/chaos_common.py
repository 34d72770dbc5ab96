"""Shared machinery for the seeded chaos planes.

``chaos_tcp``, ``chaos_disk``, and ``chaos_device``
each wrap one liar — the network, the disk, the accelerator — behind the
same evidence discipline, and the mechanical halves of that
discipline had drift-copied twice:

- **per-member RNG derivation** — every plane seeds
  ``random.Random(seed ^ crc32(member_id))`` so one seed describes the
  whole fleet while distinct members never mirror each other's decisions;
- **spec field parsing** — ``key=value`` comma fields inside ``;`` sections
  (the ``format_spec``/``parse_spec`` round-trip each plane pins in tests);
- **per-life counts snapshots** — throttled atomic dumps of the applied-
  fault counters, one file per process life, so a SIGKILLed worker loses at
  most one dump interval of observations and a configured-but-never-applied
  fault class is a *gate violation*, never silent coverage;
- **JSONL evidence ledgers** — line-flushed append-only records of
  individual injections (bit-rot flips, result corruptions) the offline
  checkers join against detection/repair evidence.

This module is their one home; the zlint drift-copy rule no longer has to
look away from the chaos planes. Spec *fields* stay owned by each plane
(the fault classes genuinely differ); only the mechanics live here.
"""

from __future__ import annotations

import json
import logging
import os
import random
import time
import zlib

logger = logging.getLogger("zeebe_tpu_torch.testing.chaos_common")

#: throttle for the per-life counts snapshots: a SIGKILL loses at most this
#: many seconds of observed-fault evidence
COUNTS_DUMP_INTERVAL_S = 2.0


def member_rng(seed: int, member_id: str) -> random.Random:
    """The per-member fault stream every chaos plane derives: one seed
    describes the fleet, ``crc32(member)`` keeps members from mirroring
    each other's decisions."""
    return random.Random(seed ^ zlib.crc32(member_id.encode("utf-8")))


def parse_spec_fields(section: str, setters: dict) -> None:
    """Apply one ``key=value,key=value`` spec section through ``setters``
    (key → one-arg callable). Unknown keys are ignored (forward compat:
    an older worker must boot under a newer harness's spec)."""
    for fld in section.split(","):
        key, _, value = fld.partition("=")
        setter = setters.get(key.strip())
        if setter is not None:
            setter(value)


class CountsSnapshot:
    """Throttled atomic per-life counts dump (``<file>.tmp`` + rename).
    The consistency/torture/device-chaos reports aggregate these as the
    OBSERVED fault evidence; ``counts_file`` is None until a harness-run
    worker entry assigns it, so production processes never write."""

    def __init__(self, member_id: str) -> None:
        self.member_id = member_id
        self.counts_file: str | None = None
        self._last_dump = 0.0

    def maybe_dump(self, counts: dict) -> None:
        if self.counts_file is None:
            return
        now = time.time()
        if now - self._last_dump < COUNTS_DUMP_INTERVAL_S:
            return
        self._last_dump = now
        try:
            payload = json.dumps({"member": self.member_id, **counts})
            tmp = f"{self.counts_file}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(payload)
            os.replace(tmp, self.counts_file)
        except OSError:  # pragma: no cover — evidence is best-effort
            pass


class JsonlLedger:
    """Line-flushed JSONL evidence ledger (bit-rot flips, injected result
    corruptions). Unlike the throttled counts snapshot this is flushed per
    entry — the ledger is the authoritative applied count for fault
    classes whose individual occurrences the offline checkers must join
    against detection evidence."""

    def __init__(self) -> None:
        self.path: str | None = None

    def append(self, entry: dict) -> None:
        if self.path is None:
            return
        try:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(json.dumps(entry, separators=(",", ":")) + "\n")
                f.flush()
        except OSError:  # pragma: no cover — evidence is best-effort
            pass


def read_jsonl_ledgers(paths) -> list[dict]:
    """Merge JSONL ledger files (harness-side), skipping torn tail lines
    of SIGKILLed workers."""
    out: list[dict] = []
    for path in paths:
        try:
            lines = path.read_text(encoding="utf-8").splitlines()
        except OSError:
            continue
        for line in lines:
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue  # torn tail line of a killed worker
    return out


def sum_counts_files(paths) -> dict[str, int]:
    """Aggregate per-life counts snapshots (harness-side): integer fields
    sum across every process life and every member."""
    totals: dict[str, int] = {}
    for path in paths:
        try:
            counts = json.loads(path.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            continue
        for key, value in counts.items():
            if isinstance(value, int):
                totals[key] = totals.get(key, 0) + value
    return totals
