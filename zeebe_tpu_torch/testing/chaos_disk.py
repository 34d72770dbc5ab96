"""Disk-layer chaos: seeded storage fault injection.

``chaos_tcp.py`` made the network lie; this module makes the *disk* lie.
A seeded :class:`DiskFaultPlan` is applied by a :class:`DiskChaosController`
installed into the ``zeebe_tpu_torch.utils.storage_io`` seam — the one indirection
every storage writer (journal segments, snapshot stores, the cold tier,
backup stores) routes its ``open``/``write``/``fsync``/``replace`` calls
through — so every fault class lands exactly where real hardware would
produce it:

- **eio / enospc** — a write raises ``OSError(EIO)`` / ``OSError(ENOSPC)``
  with nothing reaching the file;
- **torn** — a write persists only a seeded-length *prefix* before raising
  (the classic crash-torn/short-write shape);
- **fsync_fail** — ``fsync`` raises ``OSError(EIO)`` (the fsyncgate shape:
  after a failed fsync the page cache state is undefined — the journal must
  fail the segment hard, not retry on the same fd);
- **fsync_stall** — ``fsync`` blocks ``stall_ms`` before succeeding (a dying
  disk's latency tail; trips the journal's slow-flush flight events);
- **bitrot** — every ``bitrot_interval_ms`` one byte of an *at-rest* file
  (journal segment, snapshot file, cold segment) is flipped in place, and
  the flip is recorded in a JSONL **ledger** so the torture checker can
  prove each one was detected-or-repaired before wrong bytes were served.

Faults apply per **path class** (``journal`` | ``snapshot`` | ``cold`` |
``backup``, see :func:`classify_path`) so a scenario can rot snapshots while
leaving journals honest. Per-member RNG streams derive from
``seed ^ crc32(member id)`` exactly like the TCP plane. Evidence discipline
matches ``chaos_tcp`` too: per-life applied-fault **counts snapshots**
(throttled file dumps, a SIGKILL loses ≤ one interval) — a
configured-but-never-applied fault class is a torture-gate violation, never
silent coverage.

Environment wiring (the worker process entry):

- ``ZEEBE_CHAOS_DISK`` — the spec, e.g.
  ``seed=7,eio=0.01,enospc=0.005,torn=0.01,fsync_fail=0.004,
  fsync_stall=0.01,stall_ms=120,bitrot_interval_ms=1500;
  classes=journal|snapshot|cold``
- the worker entry installs the parsed controller into ``storage_io`` and
  drives :meth:`DiskChaosController.tick` from its pump loop (bit-rot +
  counts dumps ride the tick, not the IO path).
"""

from __future__ import annotations

import dataclasses
import errno
import logging
import os
import time
from pathlib import Path

from zeebe_tpu_torch.testing.chaos_common import (
    CountsSnapshot,
    JsonlLedger,
    member_rng,
    parse_spec_fields,
)

logger = logging.getLogger("zeebe_tpu_torch.testing.chaos_disk")

#: every fault class a plan can configure (the torture gate asserts a
#: nonzero observed count for each CONFIGURED one)
FAULT_CLASSES = ("eio", "enospc", "torn", "fsync_fail", "fsync_stall",
                 "bitrot")

#: default path classes faults apply to (backup stores are opt-in: the
#: torture harness does not run one)
DEFAULT_PATH_CLASSES = ("journal", "snapshot", "cold")


@dataclasses.dataclass
class DiskFaultPlan:
    """Seeded per-operation fault probabilities + the at-rest bit-rot
    cadence. Probabilities apply per write / per fsync on files whose
    :func:`classify_path` class is enabled in ``classes``."""

    seed: int = 0
    eio_p: float = 0.0
    enospc_p: float = 0.0
    torn_p: float = 0.0
    fsync_fail_p: float = 0.0
    fsync_stall_p: float = 0.0
    stall_ms: int = 200
    #: 0 disables at-rest bit rot; otherwise one flip per interval
    bitrot_interval_ms: int = 0
    #: first flip no earlier than this long after install: boot-era
    #: journal files are tiny, so undelayed rot concentrates enough
    #: per-file damage to destroy the same region on EVERY replica
    #: faster than repair can re-replicate — a pressure no RF can
    #: survive and far beyond any real disk's rot rate
    bitrot_delay_ms: int = 0
    classes: tuple = DEFAULT_PATH_CLASSES

    def configured_classes(self) -> list[str]:
        """The fault classes this plan can actually produce."""
        out = []
        if self.eio_p > 0:
            out.append("eio")
        if self.enospc_p > 0:
            out.append("enospc")
        if self.torn_p > 0:
            out.append("torn")
        if self.fsync_fail_p > 0:
            out.append("fsync_fail")
        if self.fsync_stall_p > 0:
            out.append("fsync_stall")
        if self.bitrot_interval_ms > 0:
            out.append("bitrot")
        return out


def format_spec(plan: DiskFaultPlan) -> str:
    parts = [
        f"seed={plan.seed},eio={plan.eio_p},enospc={plan.enospc_p},"
        f"torn={plan.torn_p},fsync_fail={plan.fsync_fail_p},"
        f"fsync_stall={plan.fsync_stall_p},stall_ms={plan.stall_ms},"
        f"bitrot_interval_ms={plan.bitrot_interval_ms},"
        f"bitrot_delay_ms={plan.bitrot_delay_ms}"
    ]
    parts.append("classes=" + "|".join(plan.classes))
    return ";".join(parts)


def parse_spec(spec: str) -> DiskFaultPlan:
    """Inverse of :func:`format_spec`."""
    plan = DiskFaultPlan()
    for section in spec.split(";"):
        section = section.strip()
        if not section:
            continue
        if section.startswith("classes="):
            plan.classes = tuple(
                c.strip() for c in section[len("classes="):].split("|")
                if c.strip())
            continue
        parse_spec_fields(section, {
            "seed": lambda v: setattr(plan, "seed", int(v)),
            "eio": lambda v: setattr(plan, "eio_p", float(v)),
            "enospc": lambda v: setattr(plan, "enospc_p", float(v)),
            "torn": lambda v: setattr(plan, "torn_p", float(v)),
            "fsync_fail": lambda v: setattr(plan, "fsync_fail_p", float(v)),
            "fsync_stall": lambda v: setattr(plan, "fsync_stall_p", float(v)),
            "stall_ms": lambda v: setattr(plan, "stall_ms", int(v)),
            "bitrot_interval_ms": lambda v: setattr(
                plan, "bitrot_interval_ms", int(v)),
            "bitrot_delay_ms": lambda v: setattr(
                plan, "bitrot_delay_ms", int(v)),
        })
    return plan


def classify_path(path) -> str | None:
    """Storage path class of ``path``: ``journal`` (segmented-journal
    ``*.log`` / ``*.meta`` files), ``snapshot`` (anything under a
    ``snapshots``/``pending`` store dir), ``cold`` (``cold-*.seg``),
    ``backup`` (under a ``backups`` dir), or None (not a storage file —
    never faulted)."""
    s = str(path)
    name = os.path.basename(s)
    if name.endswith(".log") or name.endswith(".meta"):
        return "journal"
    if name.startswith("cold-") and name.endswith(".seg"):
        return "cold"
    parts = s.replace(os.sep, "/").split("/")
    if "snapshots" in parts or "pending" in parts:
        return "snapshot"
    if "backups" in parts:
        return "backup"
    return None


class DiskChaosController:
    """The object ``storage_io`` consults on every storage write/fsync.

    Thread-wise: write/fsync decisions run on whatever thread performs the
    IO (pump threads, snapshot persists); ``tick`` (bit-rot + counts dumps)
    runs on the worker's main pump loop. The RNG is shared — chaos needs no
    bit-level reproducibility across threads, only seeded coverage (same
    posture as the TCP plane's real-scheduling caveat)."""

    def __init__(self, plan: DiskFaultPlan, member_id: str = "",
                 root: str | Path | None = None) -> None:
        self.plan = plan
        self.member_id = member_id
        #: directory tree scanned for at-rest bit-rot candidates
        self.root = Path(root) if root is not None else None
        self.rng = member_rng(plan.seed, member_id)
        self.counts = {"writes": 0, "fsyncs": 0}
        for cls in FAULT_CLASSES:
            self.counts[cls] = 0
        self._counts_snap = CountsSnapshot(member_id)
        self._ledger_sink = JsonlLedger()
        self._last_bitrot = time.time() * 1000.0 + plan.bitrot_delay_ms
        # armed=False freezes probabilistic faults (harness quiesce phases
        # need the disk honest while evidence drains); the harness flips
        # it remotely by creating ``disarm_file`` (checked on tick —
        # same runtime-control pattern as chaos_tcp's windows file)
        self.armed = True
        self.disarm_file: str | None = None

    # -- write/fsync faults (called from storage_io) ---------------------------

    def _enabled(self, path) -> bool:
        if not self.armed:
            return False
        cls = classify_path(path)
        return cls is not None and cls in self.plan.classes

    def write_fault(self, path, data_len: int) -> tuple[str, int]:
        """Fault decision for one write: ``("ok", 0)``, ``("eio", 0)``,
        ``("enospc", 0)``, or ``("torn", prefix_len)`` — the caller persists
        ``prefix_len`` bytes then raises."""
        self.counts["writes"] += 1
        if not self._enabled(path):
            return "ok", 0
        plan = self.plan
        r = self.rng.random()
        if r < plan.eio_p:
            self.counts["eio"] += 1
            return "eio", 0
        r -= plan.eio_p
        if r < plan.enospc_p:
            self.counts["enospc"] += 1
            return "enospc", 0
        r -= plan.enospc_p
        if r < plan.torn_p and data_len > 1:
            self.counts["torn"] += 1
            return "torn", 1 + self.rng.randrange(data_len - 1)
        return "ok", 0

    def fsync_fault(self, path) -> None:
        """Apply the fsync fault decision: may sleep (stall) or raise
        ``OSError(EIO)`` (fsyncgate) before the real fsync runs."""
        self.counts["fsyncs"] += 1
        if not self._enabled(path):
            return
        plan = self.plan
        r = self.rng.random()
        if r < plan.fsync_fail_p:
            self.counts["fsync_fail"] += 1
            raise OSError(errno.EIO, f"chaos fsync failure on {path}")
        r -= plan.fsync_fail_p
        if r < plan.fsync_stall_p:
            self.counts["fsync_stall"] += 1
            time.sleep(plan.stall_ms / 1000.0)

    # -- the tick (bit-rot + evidence dumps) -----------------------------------

    def tick(self, now_ms: float | None = None) -> None:
        now = time.time() * 1000.0 if now_ms is None else now_ms
        if (self.armed and self.disarm_file is not None
                and os.path.exists(self.disarm_file)):
            self.armed = False
            logger.warning("disk chaos DISARMED for %s", self.member_id)
        if (self.armed and self.plan.bitrot_interval_ms > 0
                and self.root is not None
                and now - self._last_bitrot >= self.plan.bitrot_interval_ms):
            self._last_bitrot = now
            self._apply_bitrot(now)
        self._maybe_dump_counts()

    def _bitrot_candidates(self) -> list[tuple[str, Path]]:
        out: list[tuple[str, Path]] = []
        root = self.root
        if "journal" in self.plan.classes:
            # raft segments live one level deeper than stream segments
            # (<partition>/raft/raft-log/*.log vs <partition>/stream/*.log)
            for pattern in ("**/raft/raft-log/*.log", "**/stream/*.log"):
                for p in root.glob(pattern):
                    out.append(("journal", p))
        if "snapshot" in self.plan.classes:
            for p in root.glob("**/snapshots/snapshots/*/*"):
                if p.is_file():
                    out.append(("snapshot", p))
        if "cold" in self.plan.classes:
            for p in root.glob("**/cold/cold-*.seg"):
                out.append(("cold", p))
        return out

    #: segment header bytes never flipped in journal files — a rotten header
    #: is an unopenable segment, a different (coarser) failure mode than the
    #: frame-level rot the scrubber hunts
    _JOURNAL_HEADER = 24

    def _apply_bitrot(self, now_ms: float) -> None:
        candidates = self._bitrot_candidates()
        self.rng.shuffle(candidates)
        for cls, path in candidates:
            floor = self._JOURNAL_HEADER if cls == "journal" else 0
            try:
                size = path.stat().st_size
                if size <= floor + 1:
                    continue
                offset = floor + self.rng.randrange(size - floor)
                fd = os.open(path, os.O_RDWR)
                try:
                    old = os.pread(fd, 1, offset)
                    if len(old) != 1:
                        continue
                    os.pwrite(fd, bytes((old[0] ^ 0xFF,)), offset)
                finally:
                    os.close(fd)
            except OSError:
                continue
            self.counts["bitrot"] += 1
            self._ledger({"path": str(path), "class": cls, "offset": offset,
                          "atMs": now_ms, "member": self.member_id,
                          "pid": os.getpid()})
            logger.warning("disk chaos: bit-rot %s @%d (%s)", path, offset,
                           cls)
            return

    @property
    def counts_file(self):
        return self._counts_snap.counts_file

    @counts_file.setter
    def counts_file(self, value) -> None:
        self._counts_snap.counts_file = value

    @property
    def ledger_file(self):
        return self._ledger_sink.path

    @ledger_file.setter
    def ledger_file(self, value) -> None:
        self._ledger_sink.path = value

    def _ledger(self, entry: dict) -> None:
        self._ledger_sink.append(entry)

    def _maybe_dump_counts(self) -> None:
        self._counts_snap.maybe_dump(self.counts)


def maybe_install_from_env(member_id: str = "",
                           data_dir: str | None = None,
                           env: dict | None = None):
    """Install a :class:`DiskChaosController` into the ``storage_io`` seam
    when ``ZEEBE_CHAOS_DISK`` is set; returns it (or None). ``data_dir``
    roots the bit-rot scan and the evidence files."""
    from zeebe_tpu_torch.utils import storage_io

    env = os.environ if env is None else env
    spec = env.get("ZEEBE_CHAOS_DISK")
    if not spec:
        return None
    try:
        plan = parse_spec(spec)
    except ValueError as exc:
        logger.error("ignoring malformed ZEEBE_CHAOS_DISK %r: %s", spec, exc)
        return None
    controller = DiskChaosController(plan, member_id=member_id, root=data_dir)
    if data_dir:
        controller.counts_file = os.path.join(
            data_dir, f"disk-chaos-counts-{os.getpid()}.json")
        controller.ledger_file = os.path.join(
            data_dir, f"disk-bitrot-{os.getpid()}.jsonl")
    controller.disarm_file = env.get("ZEEBE_CHAOS_DISK_DISARMFILE") or None
    storage_io.install_controller(controller)
    logger.warning("disk chaos ACTIVE for %s: %s", member_id, spec)
    return controller
