"""Runtime single-writer / determinism sanitizer (``ZEEBE_SANITIZE=1``).

The static half of (zeebe_tpu/analysis) proves properties an AST
can see; this is the dynamic half for the ones it can't: *which thread*
actually touched what at runtime. The architecture's threading contract is
narrow and load-bearing:

- **single-writer:** exactly one thread — the pump thread — mutates a
  partition's state (``ZbDb`` transactions, bulk loads) and appends to its
  journal. Every other thread (management HTTP, gateway long-polls, metric
  samplers) reads through the lock-free committed accessors only.
- **lock-held / no-reentry:** the flight recorder's ring mutations happen
  under its internal lock, and never re-enter ``record`` from the same
  thread (its plain ``threading.Lock`` would deadlock).

With ``ZEEBE_SANITIZE=1`` (tests/conftest.py calls :func:`maybe_install`),
the sanitizer wraps ``ZbDb``, ``Transaction.commit``, the journal's
``append``, and the flight recorder with affinity assertions: the first
mutating thread claims an object's writer affinity, and any later mutation
from a different thread raises :class:`SanitizerViolation` — turning a
latent cross-thread race into a deterministic test failure with both
thread names in the message. Read paths (``committed_get`` /
``committed_keys_of`` / ``lookup_request``) are deliberately unwrapped:
they are the sanctioned cross-thread surface.

Handoffs that are *architecturally* legitimate (a harness builds state on
one thread and hands the whole partition to another before any concurrent
access) declare themselves with :func:`adopt_writer`.

Scope note: installation patches classes process-wide but only for THIS
process — multi-process harnesses (multiproc supervisor workers) spawn
children without the sanitizer unless their entry point also calls
:func:`maybe_install`.
"""

from __future__ import annotations

import os
import threading

_AFFINITY_ATTR = "_zs_writer"
_ENV_FLAG = "ZEEBE_SANITIZE"

_installed = False
_originals: dict[tuple[type, str], object] = {}
_tls = threading.local()


class SanitizerViolation(AssertionError):
    """A thread broke the single-writer / no-reentry contract. Raised (not
    logged): under the sanitizer a latent race IS a test failure."""


def enabled() -> bool:
    return os.environ.get(_ENV_FLAG, "").strip() not in ("", "0", "false")


def _thread_label() -> str:
    t = threading.current_thread()
    return f"{t.name}(ident={t.ident})"


def adopt_writer(obj) -> None:
    """Explicitly (re)claim ``obj``'s writer affinity for the current
    thread — the declared-handoff escape hatch for architecturally
    legitimate ownership transfers (e.g. a harness thread handing a fully
    built partition to a worker loop). A silent cross-thread write without
    this call is exactly what the sanitizer exists to catch."""
    try:
        obj.__dict__[_AFFINITY_ATTR] = (threading.get_ident(),
                                        threading.current_thread().name)
    except AttributeError:  # __slots__ object: affinity not trackable
        pass


def _assert_writer(obj, operation: str) -> None:
    """First mutating thread claims ``obj``; later mutators must match."""
    try:
        claimed = obj.__dict__.get(_AFFINITY_ATTR)
    except AttributeError:
        return
    if claimed is None:
        adopt_writer(obj)
        return
    ident, name = claimed
    if ident != threading.get_ident():
        raise SanitizerViolation(
            f"single-writer violation: {operation} on "
            f"{type(obj).__name__}@{id(obj):#x} from thread "
            f"{_thread_label()}, but writer affinity belongs to "
            f"{name}(ident={ident}) — partition state may only be mutated "
            f"by its pump thread; cross-thread readers must use the "
            f"committed_* accessors (or declare a legitimate handoff with "
            f"testing.sanitizer.adopt_writer)")


def _wrap_mutator(cls: type, method_name: str, obj_of=None) -> None:
    """Patch ``cls.method_name`` to assert writer affinity first.
    ``obj_of`` maps the call's ``self`` to the affinity-carrying object
    (e.g. ``Transaction.commit`` claims on the transaction's db)."""
    original = getattr(cls, method_name)
    _originals[(cls, method_name)] = original

    def checked(self, *args, **kwargs):
        _assert_writer(obj_of(self) if obj_of is not None else self,
                       f"{cls.__name__}.{method_name}")
        return original(self, *args, **kwargs)

    checked.__name__ = method_name
    checked.__qualname__ = f"{cls.__name__}.{method_name}"
    checked.__doc__ = original.__doc__
    setattr(cls, method_name, checked)


def _wrap_reentrancy_guard(cls: type, method_name: str) -> None:
    """Patch ``cls.method_name`` to fail on same-thread reentry: the flight
    recorder's plain Lock would deadlock if a context provider or clock
    hook called back into it."""
    original = getattr(cls, method_name)
    _originals[(cls, method_name)] = original

    def checked(self, *args, **kwargs):
        active = getattr(_tls, "active", None)
        if active is None:
            active = _tls.active = set()
        key = (id(self), method_name)
        if key in active:
            raise SanitizerViolation(
                f"reentrant {cls.__name__}.{method_name} on thread "
                f"{_thread_label()}: a hook invoked from inside "
                f"{method_name} called back into it — this deadlocks the "
                f"recorder's non-reentrant lock")
        active.add(key)
        try:
            return original(self, *args, **kwargs)
        finally:
            active.discard(key)

    checked.__name__ = method_name
    checked.__qualname__ = f"{cls.__name__}.{method_name}"
    checked.__doc__ = original.__doc__
    setattr(cls, method_name, checked)


def install() -> None:
    """Idempotently wrap the mutation surfaces. Import-light: pulls only
    the state/journal/observability modules (no jax)."""
    global _installed
    if _installed:
        return
    from zeebe_tpu_torch.control.actuators import Actuator
    from zeebe_tpu_torch.journal.journal import SegmentedJournal
    from zeebe_tpu_torch.observability.flight_recorder import FlightRecorder
    from zeebe_tpu_torch.state.db import Transaction, ZbDb

    # ZbDb: transaction opens + bulk mutation paths claim/assert affinity.
    # Subclasses (durable/tiered stores) inherit the patched methods.
    _wrap_mutator(ZbDb, "transaction")
    _wrap_mutator(ZbDb, "bulk_apply")
    _wrap_mutator(ZbDb, "load_snapshot_bytes")
    # commit checks again at commit time: a transaction handed to another
    # thread mid-flight is the subtlest cross-thread write there is
    _wrap_mutator(Transaction, "commit", obj_of=lambda txn: txn._db)
    # require_transaction is the chokepoint for EVERY transactional
    # ColumnFamily read/write: a non-writer thread reaching it is reading
    # the mutable overlay mid-processing (committed-read discipline,
    # enforced at runtime)
    _wrap_mutator(ZbDb, "require_transaction")
    _wrap_mutator(SegmentedJournal, "append")
    # control-plane actuators: apply is the single runtime
    # write path to a controller-owned knob, and it runs on the pump
    # thread that ticks the plane — same first-writer-claims discipline as
    # ZbDb (a management thread or test harness mutating a knob through an
    # actuator from the side is exactly the race the audit trail can't see)
    _wrap_mutator(Actuator, "apply")
    _wrap_reentrancy_guard(FlightRecorder, "record")
    _wrap_reentrancy_guard(FlightRecorder, "dump")
    _installed = True


def uninstall() -> None:
    """Restore every patched method (tests that provoke violations clean
    up after themselves)."""
    global _installed
    for (cls, name), original in _originals.items():
        setattr(cls, name, original)
    _originals.clear()
    _installed = False


def installed() -> bool:
    return _installed


def maybe_install() -> None:
    if enabled():
        install()
