"""The ``control_adjust`` audit vocabulary: ONE record shape for every
closed feedback loop in the runtime.

Autopilot's operators-trust-the-machine argument (Rzadca et al., EuroSys
2020) is mostly an *audit* argument: an autonomic system is adoptable only
when every decision it takes is attributable — what moved, from what to
what, on which signal, and why. This module is that contract for every
loop in this tree: the ``zeebe_tpu/control`` actuators, the adaptive
snapshot scheduler, and the admission shed ladder all record their
decisions through :func:`record_adjust`, so ``/flight`` dumps,
``/control``, and ``cli top``'s CONTROL section render every closed loop
in one place with one schema.

Event shape (flight-recorder kind ``control_adjust``)::

    {"kind": "control_adjust", "controller": "journal-flush",
     "knob": "raft.flushDelayMs", "before": 0.0, "after": 2.0,
     "reason": "flush utilization 0.52 over high watermark",
     "signals": {"flushPerSec": 410.2, "flushP50Ms": 1.3}}

Metric families (registered at import so the metrics-doc scenario and the
sampler see them without waiting for the first adjustment):

- ``zeebe_control_adjustments_total{controller,knob}``
- ``zeebe_control_knob_value{controller,knob}`` (the knob's live value)
- ``zeebe_control_signal_stale_total{controller}`` (fallback-to-static
  episodes: the loop's sensor went quiet and the actuator walked the knob
  back to its configured value)
"""

from __future__ import annotations

from zeebe_tpu_torch.utils.metrics import REGISTRY as _REG

_M_ADJUSTMENTS = _REG.counter(
    "control_adjustments_total",
    "feedback-loop decisions recorded under the control_adjust vocabulary "
    "(control-plane actuators, the adaptive snapshot scheduler, the "
    "admission shed ladder)", ("controller", "knob"))
_M_KNOB_VALUE = _REG.gauge(
    "control_knob_value",
    "live value of a controller-owned runtime knob (units are the knob's "
    "own: ms, bytes, instances)", ("controller", "knob"))
_M_SIGNAL_STALE = _REG.counter(
    "control_signal_stale_total",
    "control ticks that fell back toward the static configured value "
    "because the loop's telemetry signal was stale or absent",
    ("controller",))


def record_adjust(flight, partition_id: int, controller: str, knob: str,
                  before, after, reason: str,
                  signals: dict | None = None) -> None:
    """One feedback-loop decision: a ``control_adjust`` flight event plus
    the ``zeebe_control_*`` metrics. ``flight`` may be None (loops built
    without a recorder still count in metrics)."""
    _M_ADJUSTMENTS.labels(controller, knob).inc()
    if isinstance(after, (int, float)):
        _M_KNOB_VALUE.labels(controller, knob).set(float(after))
    if flight is not None:
        flight.record(partition_id, "control_adjust", controller=controller,
                      knob=knob, before=before, after=after, reason=reason,
                      signals=dict(signals or {}))


def note_stale(controller: str) -> None:
    _M_SIGNAL_STALE.labels(controller).inc()
