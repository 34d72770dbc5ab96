"""Device-layer chaos: seeded accelerator fault injection.

``chaos_tcp`` made the network lie, ``chaos_disk`` the disk; this module
makes the *accelerator* lie. A seeded :class:`DeviceFaultPlan` is applied
by a :class:`DeviceChaosController` installed into the kernel backend's
ONE dispatch seam (``KernelBackend.begin_group``/``finish_group`` —
concretely the first-chunk dispatch and every device fetch), so every
fault class lands exactly where real hardware would produce it:

- **compile_fail** — the first dispatch of a group raises (XLA
  compile/lowering failure, driver OOM at program build);
- **dispatch_fail** — a dispatch raises after compile (runtime launch
  failure, a dying device rejecting work);
- **stall** — a device fetch blocks ``stall_ms`` before returning (the
  wedged-tunnel / dying-HBM latency tail — "Gray Failure"'s
  degraded-not-dead shape; trips the backend's dispatch watchdog);
- **chunk_fail** — a fetch raises mid-group after earlier chunks already
  landed (partial-group device failure);
- **corrupt** — seeded bit-flips in the fetched int32 result rows BEFORE
  decode (the "Cores that don't count" silent-data-corruption shape; the
  packed event tensor is integer, so flips — not float NaNs — are the
  faithful corruption model). Every corruption is recorded in a JSONL
  LEDGER, and the backend reports back each one it caught (shadow
  mismatch or containment) — an injected corruption with no ``caught``
  line is a device-chaos-gate violation: wrong bytes reached the commit
  path.

Per-member RNG streams derive from ``seed ^ crc32(member id)`` and the
evidence discipline matches the other planes (shared home:
``testing/chaos_common.py``): per-life applied-fault counts snapshots, a
disarm file the harness flips to end the survival window, and
configured-but-never-applied classes failing the gate.

Environment wiring (the worker process entry):

- ``ZEEBE_CHAOS_DEVICE`` — the spec, e.g.
  ``seed=7,compile_fail=0.02,dispatch_fail=0.02,stall=0.02,stall_ms=900,
  chunk_fail=0.02,corrupt=0.08,flips=3``
- ``ZEEBE_CHAOS_DEVICE_DISARMFILE`` — when this file appears the
  controller freezes (checked on tick): the harness's recovery phase
  needs the device honest so the canary ladder can re-prove it.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

from zeebe_tpu_torch.testing.chaos_common import (
    CountsSnapshot,
    JsonlLedger,
    member_rng,
    parse_spec_fields,
)

logger = logging.getLogger("zeebe_tpu_torch.testing.chaos_device")

#: every fault class a plan can configure (the device-chaos gate asserts a
#: nonzero observed count for each CONFIGURED one)
FAULT_CLASSES = ("compile_fail", "dispatch_fail", "stall", "chunk_fail",
                 "corrupt")


class DeviceChaosError(RuntimeError):
    """A chaos-injected device failure; ``kind`` is the fault class. The
    kernel backend's containment layer must absorb it exactly like a real
    dispatch exception — typed fallback, never a poisoned pump."""

    def __init__(self, kind: str, message: str) -> None:
        super().__init__(message)
        self.kind = kind


@dataclasses.dataclass
class DeviceFaultPlan:
    """Seeded per-dispatch/per-fetch fault probabilities."""

    seed: int = 0
    compile_fail_p: float = 0.0
    dispatch_fail_p: float = 0.0
    stall_p: float = 0.0
    stall_ms: int = 900
    chunk_fail_p: float = 0.0
    corrupt_p: float = 0.0
    #: bit flips per corrupted fetch (spread over seeded row positions)
    flips: int = 3

    def configured_classes(self) -> list[str]:
        out = []
        if self.compile_fail_p > 0:
            out.append("compile_fail")
        if self.dispatch_fail_p > 0:
            out.append("dispatch_fail")
        if self.stall_p > 0:
            out.append("stall")
        if self.chunk_fail_p > 0:
            out.append("chunk_fail")
        if self.corrupt_p > 0:
            out.append("corrupt")
        return out


def format_spec(plan: DeviceFaultPlan) -> str:
    return (f"seed={plan.seed},compile_fail={plan.compile_fail_p},"
            f"dispatch_fail={plan.dispatch_fail_p},stall={plan.stall_p},"
            f"stall_ms={plan.stall_ms},chunk_fail={plan.chunk_fail_p},"
            f"corrupt={plan.corrupt_p},flips={plan.flips}")


def parse_spec(spec: str) -> DeviceFaultPlan:
    """Inverse of :func:`format_spec`."""
    plan = DeviceFaultPlan()
    for section in spec.split(";"):
        section = section.strip()
        if not section:
            continue
        parse_spec_fields(section, {
            "seed": lambda v: setattr(plan, "seed", int(v)),
            "compile_fail": lambda v: setattr(plan, "compile_fail_p",
                                              float(v)),
            "dispatch_fail": lambda v: setattr(plan, "dispatch_fail_p",
                                               float(v)),
            "stall": lambda v: setattr(plan, "stall_p", float(v)),
            "stall_ms": lambda v: setattr(plan, "stall_ms", int(v)),
            "chunk_fail": lambda v: setattr(plan, "chunk_fail_p", float(v)),
            "corrupt": lambda v: setattr(plan, "corrupt_p", float(v)),
            "flips": lambda v: setattr(plan, "flips", int(v)),
        })
    return plan


class DeviceChaosController:
    """The object the kernel backend consults at its dispatch seam.

    Thread-wise: ``dispatch_fault``/``fetch_fault``/``corrupt_rows`` run
    on whichever thread performs the device call (the pump thread, or the
    backend's watchdog fetch thread); ``tick`` (disarm + counts dumps)
    rides the worker's pump loop. The RNG is shared across partitions —
    chaos needs seeded coverage, not bit-level cross-thread
    reproducibility (the TCP plane's documented posture)."""

    def __init__(self, plan: DeviceFaultPlan, member_id: str = "") -> None:
        self.plan = plan
        self.member_id = member_id
        self.rng = member_rng(plan.seed, member_id)
        self.counts = {"dispatches": 0, "fetches": 0, "corrupt_caught": 0}
        for cls in FAULT_CLASSES:
            self.counts[cls] = 0
        self._counts_snap = CountsSnapshot(member_id)
        self._ledger = JsonlLedger()
        self._corrupt_seq = 0
        self.armed = True
        self.disarm_file: str | None = None

    @property
    def counts_file(self):
        return self._counts_snap.counts_file

    @counts_file.setter
    def counts_file(self, value) -> None:
        self._counts_snap.counts_file = value

    @property
    def ledger_file(self):
        return self._ledger.path

    @ledger_file.setter
    def ledger_file(self, value) -> None:
        self._ledger.path = value

    # -- dispatch-seam faults -----------------------------------------------

    def dispatch_fault(self) -> None:
        """Called once per group dispatch, BEFORE the first chunk runs: may
        raise a compile failure or a dispatch exception."""
        self.counts["dispatches"] += 1
        if not self.armed:
            return
        plan = self.plan
        r = self.rng.random()
        if r < plan.compile_fail_p:
            self.counts["compile_fail"] += 1
            raise DeviceChaosError(
                "compile_fail", "chaos: XLA compile failure at group dispatch")
        r -= plan.compile_fail_p
        if r < plan.dispatch_fail_p:
            self.counts["dispatch_fail"] += 1
            raise DeviceChaosError(
                "dispatch_fail", "chaos: device dispatch exception")

    def fetch_fault(self, chunk_index: int) -> None:
        """Called per device fetch (inside the backend's watchdog thread
        when one is armed): may stall (the watchdog's deadline converts the
        stall into a typed wedge) or raise a partial-chunk failure."""
        self.counts["fetches"] += 1
        if not self.armed:
            return
        plan = self.plan
        r = self.rng.random()
        if r < plan.stall_p:
            self.counts["stall"] += 1
            time.sleep(plan.stall_ms / 1000.0)
            return
        r -= plan.stall_p
        if r < plan.chunk_fail_p:
            self.counts["chunk_fail"] += 1
            raise DeviceChaosError(
                "chunk_fail",
                f"chaos: device failure fetching chunk {chunk_index}")

    def corrupt_rows(self, rows, chunk_index: int) -> int | None:
        """Maybe flip seeded bits in the fetched int32 result rows IN PLACE
        (silent data corruption between device and decode). Returns the
        ledger sequence of the injection (the backend reports the catch
        back through :meth:`note_caught`), or None."""
        if not self.armed or rows.size == 0:
            return None
        if self.rng.random() >= self.plan.corrupt_p:
            return None
        flat = rows.reshape(-1)
        flips = []
        for _ in range(max(1, self.plan.flips)):
            idx = self.rng.randrange(flat.size)
            bit = self.rng.randrange(31)  # stay off the sign bit: plausible
            flat[idx] ^= (1 << bit)       # garbage, not guaranteed-invalid
            flips.append([int(idx), int(bit)])
        self.counts["corrupt"] += 1
        self._corrupt_seq += 1
        seq = self._corrupt_seq
        self._ledger.append({
            "kind": "inject", "seq": seq, "member": self.member_id,
            "pid": os.getpid(), "chunk": chunk_index, "flips": flips,
            "atMs": time.time() * 1000.0})
        logger.warning("device chaos: corrupted result rows (seq %d, "
                       "%d flips)", seq, len(flips))
        return seq

    def note_caught(self, seq: int, how: str) -> None:
        """The backend proves one injected corruption never reached the
        commit path: ``how`` is ``shadow`` (mismatch vs the host oracle,
        host result committed) or ``contained`` (the carrying group was
        abandoned and host re-executed)."""
        self.counts["corrupt_caught"] += 1
        self._ledger.append({
            "kind": "caught", "seq": seq, "member": self.member_id,
            "pid": os.getpid(), "how": how, "atMs": time.time() * 1000.0})

    # -- the tick (disarm + evidence) ---------------------------------------

    def tick(self) -> None:
        if (self.armed and self.disarm_file is not None
                and os.path.exists(self.disarm_file)):
            self.armed = False
            logger.warning("device chaos DISARMED for %s", self.member_id)
        self._counts_snap.maybe_dump(self.counts)


def maybe_install_from_env(member_id: str = "",
                           data_dir: str | None = None,
                           env: dict | None = None):
    """Install a :class:`DeviceChaosController` into the kernel backend's
    dispatch seam when ``ZEEBE_CHAOS_DEVICE`` is set; returns it (or None).
    Also points the process's device-health ladder at a JSONL evidence
    file so the offline gate can prove the full quarantine→canary cycle."""
    env = os.environ if env is None else env
    spec = env.get("ZEEBE_CHAOS_DEVICE")
    if not spec:
        return None
    try:
        plan = parse_spec(spec)
    except ValueError as exc:
        logger.error("ignoring malformed ZEEBE_CHAOS_DEVICE %r: %s", spec, exc)
        return None
    controller = DeviceChaosController(plan, member_id=member_id)
    if data_dir:
        controller.counts_file = os.path.join(
            data_dir, f"device-chaos-counts-{os.getpid()}.json")
        controller.ledger_file = os.path.join(
            data_dir, f"device-corrupt-{os.getpid()}.jsonl")
    controller.disarm_file = env.get("ZEEBE_CHAOS_DEVICE_DISARMFILE") or None

    from zeebe_tpu_torch.engine import kernel_backend
    from zeebe_tpu_torch.engine.device_health import shared_device_health

    kernel_backend.install_device_chaos(controller)
    if data_dir:
        shared_device_health().evidence_file = os.path.join(
            data_dir, f"device-health-{os.getpid()}.jsonl")
    logger.warning("device chaos ACTIVE for %s: %s", member_id, spec)
    return controller
