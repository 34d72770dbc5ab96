"""Typed actuators: the ONLY write path from controllers to runtime knobs.

An :class:`Actuator` owns one live runtime parameter. It declares, up
front, everything an operator needs to trust it (the Autopilot posture —
bounded actuation plus a full audit trail):

- **hard bounds** (``min_value``/``max_value``): the knob provably never
  leaves them — ``apply`` clamps *before* anything touches the runtime,
  and ``min_seen``/``max_seen`` record the lifetime envelope as evidence;
- **max step per tick** (``max_step``): one bad signal sample can move the
  knob at most one bounded step, never slam it across its range;
- **hysteresis band** (``hold_band``): proposals within the band of the
  current value hold — controllers oscillating around a set point do not
  thrash the runtime;
- **stale-signal fallback** (``static``): when the loop's telemetry goes
  quiet the actuator walks the knob back toward the statically configured
  value, one bounded step per tick — a dead sensor degrades to exactly
  the hand-tuned deployment, never to the last adapted extreme.

Every value change is a ``control_adjust`` flight event and a
``zeebe_control_*`` metric (zeebe_tpu/control/audit.py). The zlint
``control-actuation-discipline`` rule statically pins this as the single
write path; the runtime sanitizer (``ZEEBE_SANITIZE=1``) additionally
asserts ``apply`` stays on the pump thread that first used it.
"""

from __future__ import annotations

from typing import Callable

from zeebe_tpu_torch.control import audit


class Actuator:
    """One knob: read/write seams plus declared bounds and pacing."""

    def __init__(self, controller: str, knob: str,
                 read: Callable[[], float],
                 write: Callable[[float], None], *,
                 min_value: float, max_value: float, max_step: float,
                 static: float, hold_band: float = 0.0,
                 integer: bool = False) -> None:
        if not min_value <= static <= max_value:
            raise ValueError(
                f"{controller}/{knob}: static {static} outside "
                f"[{min_value}, {max_value}]")
        self.controller = controller
        self.knob = knob
        self._read = read
        self._write = write
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        self.max_step = float(max_step)
        self.static = float(static)
        self.hold_band = float(hold_band)
        self.integer = integer
        self.adjustments = 0
        self.holds = 0
        self.last_reason: str | None = None
        self.last_adjust_ms: int | None = None
        # the plane OWNS this knob from here on: a configured value outside
        # the declared bounds is clamped into them at construction and
        # written through — otherwise the runtime would sit out of bounds
        # forever (the hold band would swallow every proposal toward it)
        # while the snapshot reported the coerced value as evidence
        raw = float(read())
        current = self._coerce(raw)
        if current != raw:
            self._write(current)
        # lifetime envelope: with apply() the single write path and the
        # clamp above it, these two numbers ARE the bounds proof the
        # autotune gate asserts ("provably inside [min,max] every tick")
        self.min_seen = current
        self.max_seen = current

    # -- value plumbing --------------------------------------------------------

    def _coerce(self, value: float) -> float:
        value = min(max(value, self.min_value), self.max_value)
        if self.integer:
            value = float(int(round(value)))
        return value

    def read(self) -> float:
        return float(self._read())

    # -- the single write path -------------------------------------------------

    def apply(self, desired: float, reason: str,
              signals: dict | None = None, *, flight=None,
              partition_id: int = 0, now_ms: int | None = None) -> float:
        """Move the knob toward ``desired``: clamp to the declared bounds,
        rate-limit to ``max_step`` per call, hold inside the hysteresis
        band. Returns the (possibly unchanged) applied value; a change is
        a ``control_adjust`` audit record."""
        current = self._coerce(self.read())
        if desired != desired:  # NaN sentinel: drift toward the static value
            desired = self.static
        target = self._coerce(desired)
        if abs(target - current) <= self.hold_band:
            self.holds += 1
            return current
        step = max(min(target - current, self.max_step), -self.max_step)
        value = self._coerce(current + step)
        if value == current:
            self.holds += 1
            return current
        self._write(value)
        self.adjustments += 1
        self.last_reason = reason
        self.last_adjust_ms = now_ms
        self.min_seen = min(self.min_seen, value)
        self.max_seen = max(self.max_seen, value)
        audit.record_adjust(flight, partition_id, self.controller, self.knob,
                            before=current, after=value, reason=reason,
                            signals=signals)
        return value

    def fall_back(self, reason: str, *, flight=None,
                  now_ms: int | None = None) -> float:
        """Stale-signal posture: one bounded step back toward the static
        configured value."""
        current = self._coerce(self.read())
        if current == self._coerce(self.static):
            return current
        audit.note_stale(self.controller)
        return self.apply(self.static, f"stale-signal: {reason}",
                          {"fallbackTo": self.static}, flight=flight,
                          now_ms=now_ms)

    def sync(self) -> None:
        """Re-assert the current value through the write seam (no audit):
        lets a broker-wide actuator propagate its value onto partitions
        created after the last adjustment."""
        self._write(self._coerce(self.read()))

    def snapshot(self) -> dict:
        value = self._coerce(self.read())
        return {
            "knob": self.knob,
            "value": value,
            "static": self.static,
            "min": self.min_value,
            "max": self.max_value,
            "maxStepPerTick": self.max_step,
            "holdBand": self.hold_band,
            "minSeen": min(self.min_seen, value),
            "maxSeen": max(self.max_seen, value),
            "adjustments": self.adjustments,
            "holds": self.holds,
            "lastReason": self.last_reason,
            "lastAdjustMs": self.last_adjust_ms,
        }
