"""Closed-loop control plane, ROADMAP item 5): a self-tuning
runtime driven by the observability plane.

PRs 3–5 built the *measurement* half (Dapper tracing, the Gorilla
time-series store, GWP profiling); this package is the half that *acts*:
per-broker controllers tick off the pump, read distilled series from the
time-series store, and adjust live runtime knobs through a typed,
bounded, fully audited :class:`Actuator` framework — Google Autopilot's
posture (Rzadca et al., EuroSys 2020): conservative feedback over
windowed telemetry, bounded actuation, and an audit trail operators can
replay. See docs/control.md.
"""

from zeebe_tpu_torch.control.actuators import Actuator
from zeebe_tpu_torch.control.audit import note_stale, record_adjust
from zeebe_tpu_torch.control.controllers import (
    CoalescingController,
    Controller,
    JournalFlushController,
    RoutingController,
    SignalReader,
    TieringController,
)
from zeebe_tpu_torch.control.plane import ControlCfg, ControlPlane, maybe_build_plane

__all__ = [
    "Actuator",
    "CoalescingController",
    "ControlCfg",
    "ControlPlane",
    "Controller",
    "JournalFlushController",
    "RoutingController",
    "SignalReader",
    "TieringController",
    "maybe_build_plane",
    "note_stale",
    "record_adjust",
]
