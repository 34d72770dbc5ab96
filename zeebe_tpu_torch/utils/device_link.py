"""Link-aware kernel dispatch routing.

The counterpart of ``zeebe_tpu/utils/device_link.py``. The automaton's
chunk is one program with two forms: the kernel on the card and its plain
PyTorch version on the host CPU. *Where* a group of commands runs is a
deployment decision dominated by the host↔card link, not by the program.
On a card attached over PCIe a transfer costs microseconds and any
serving-sized group amortizes it; behind a slow attach every transfer pays
a latency floor regardless of size, and the same group finishes sooner on
the host.

Rather than hard-coding either assumption, the router MEASURES the link once
(a tiny put+get round trip against the card, in a child process) and
predicts each side's per-group cost: card = transfers × measured link floor
(+ the observed compute residue), host = EMA of observed group wall times
per shape bucket. Each group routes to the cheaper side, and the routing
controller of the control plane can bias groups host-ward through
``route_threshold_s``. Routing is off where no card answers: groups then
run on the backend's own device.

The port's kernel backend on the card runs every group there: it feeds the
router counts (:meth:`BackendRouter.count`), never times, and declines a
group the router sends to the host to the sequential engine. With no host
time seated, its choice is the card unless the measured link, or the
controller's bias, tops ``LOCAL_LINK_S``.
"""

from __future__ import annotations

import threading
from typing import Any

__all__ = ["BackendRouter", "shared_router"]


class BackendRouter:
    """Chooses the execution device for one kernel group.

    ``choose(bucket)`` returns the device to run on (or None = the backend's
    own device, when routing is disabled because no card answers).
    ``record(bucket, device, seconds)`` feeds observed group wall times back
    so the host-cost model tracks reality.
    """

    #: transfers per group on the card's path: the group arrays upload
    #: (elem/phase/inst/def_of/var_slots/join_counts/done) plus the typical
    #: two chunk fetches of the packed event rows
    UPLOADS_PER_GROUP = 7
    FETCHES_PER_GROUP = 2
    #: below this predicted link cost the card is effectively local and
    #: wins by default (host EMA not yet seated)
    LOCAL_LINK_S = 2e-3
    _EMA_ALPHA = 0.3

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._measured = False
        self._accel = None
        self._host = None
        self.enabled = False
        self.link_put_s: float | None = None
        self.link_get_s: float | None = None
        # host-vs-card routing threshold: the card must beat the host
        # prediction by at least this margin to win a group — raising it
        # biases groups host-ward (the kernel-routing controller raises it
        # while the device health ladder is SUSPECT/QUARANTINED or compiles
        # storm, and decays it back to 0). Runtime mutation belongs to that
        # controller's actuator.
        self.route_threshold_s = 0.0
        self._host_ema: dict[Any, float] = {}
        self._accel_ema: dict[Any, float] = {}
        self.host_groups = 0
        self.accel_groups = 0

    # -- link measurement ---------------------------------------------------

    def _measure(self) -> None:
        """Measure the card's link in a KILLABLE SUBPROCESS: an in-process
        transfer against a wedged card would block every partition sharing
        this router. The card is the current CUDA device (every caller
        reaches the router from a backend whose launches run on it). No
        card, or a timed-out or failed probe, leaves routing disabled
        (groups run on the backend's own device)."""
        import torch

        self._measured = True
        if not torch.cuda.is_available():
            return  # no card: nothing to route
        accel = torch.device("cuda", torch.cuda.current_device())
        self._accel = accel
        self._host = torch.device("cpu")
        measured = _measure_link_subprocess(accel.index)
        if measured is None:
            return
        self.link_put_s, self.link_get_s = measured
        self.enabled = True

    def link_cost_s(self) -> float | None:
        """Predicted card link cost for one group (None = unmeasured)."""
        if self.link_put_s is None or self.link_get_s is None:
            return None
        return (self.UPLOADS_PER_GROUP * self.link_put_s
                + self.FETCHES_PER_GROUP * self.link_get_s)

    # -- routing --------------------------------------------------------------

    def accel_device(self):
        """The measured card (None when routing is disabled). Quarantine
        canaries pin their dispatch here instead of asking :meth:`choose`:
        while QUARANTINED the kernel-routing controller holds
        ``route_threshold_s`` host-ward, and a canary the router quietly
        re-routes to the host would byte-match the host oracle by
        construction — re-proving the host, not the suspect card."""
        with self._lock:
            if not self._measured:
                self._measure()
            return self._accel if self.enabled else None

    def choose(self, bucket: Any):
        """Device for this group (None = the backend's own device)."""
        with self._lock:
            if not self._measured:
                self._measure()
            if not self.enabled:
                return None
            link = self.link_cost_s()
            host_ema = self._host_ema.get(bucket)
            accel_total = (link + self._accel_ema.get(bucket, 0.0)
                           + self.route_threshold_s)
            if host_ema is None:
                # un-seated host model: only an effectively-local card
                # skips the host trial run
                return self._accel if accel_total < self.LOCAL_LINK_S else self._host
            return self._accel if accel_total < host_ema else self._host

    def count(self, device) -> None:
        """Count one group routed to ``device`` (the card, else the host)."""
        with self._lock:
            self._count_locked(device)

    def _count_locked(self, device) -> None:
        if device is self._accel:
            self.accel_groups += 1
        else:
            self.host_groups += 1

    def record(self, bucket: Any, device, seconds: float,
               first_run: bool = False) -> None:
        """``first_run``: first execution of this (program, shape) on this
        device — the observation includes one-time set-up, which is paid
        once and must not poison the steady-state cost model."""
        with self._lock:
            self._count_locked(device)
            if device is self._accel:
                ema = self._accel_ema
                # observed card time includes the link; keep the compute
                # residue so repeat predictions track real runs
                link = self.link_cost_s() or 0.0
                seconds = max(0.0, seconds - link)
            else:
                ema = self._host_ema
            if first_run:
                return
            prev = ema.get(bucket)
            ema[bucket] = (seconds if prev is None
                           else prev + self._EMA_ALPHA * (seconds - prev))

    def stats(self) -> dict:
        return {
            "enabled": self.enabled,
            "link_put_ms": None if self.link_put_s is None else round(1e3 * self.link_put_s, 2),
            "link_get_ms": None if self.link_get_s is None else round(1e3 * self.link_get_s, 2),
            "route_threshold_ms": round(1e3 * self.route_threshold_s, 2),
            "host_groups": self.host_groups,
            "accel_groups": self.accel_groups,
        }


#: the child's measurement: an 8 KB int32 tensor put on the card (the copy
#: and a synchronize) and got back, min of 2 trials each way
_LINK_CODE = (
    "import sys, time, torch\n"
    "d = torch.device('cuda', int(sys.argv[1]))\n"
    "probe = torch.zeros(2048, dtype=torch.int32)\n"
    "puts, gets = [], []\n"
    "for _ in range(4):\n"
    "    time.sleep(0.05)\n"
    "    for _ in range(8):\n"
    "        t0 = time.perf_counter(); x = probe.to(d); torch.cuda.synchronize(d); "
    "puts.append(time.perf_counter() - t0)\n"
    "        t0 = time.perf_counter(); x.cpu(); gets.append(time.perf_counter() - t0)\n"
    "print(min(puts), min(gets))\n"
)


def _measure_link_subprocess(index: int = 0,
                             timeout: int = 120) -> tuple[float, float] | None:
    """(put_s, get_s) link floor of card ``index`` measured in a killable
    subprocess, or None (wedged/failed probe). The min over 4 bursts of 8
    back-to-back trials each way, 50 ms apart, tiny (8 KB) payload — the
    floor, not the bandwidth, is what dominates serving-sized groups. The
    reference takes the min of 2 back to back; a worker measures while its
    siblings start on the same host, and one slow pair there would put the
    card above ``LOCAL_LINK_S`` for the process's whole life, every group
    declined to the sequential engine. A burst keeps the path warm (single
    transfers spaced apart each pay a cold start); the spacing lets one
    burst land in a quiet moment."""
    import os
    import subprocess
    import sys

    try:
        proc = subprocess.run(
            [sys.executable, "-c", _LINK_CODE, str(index)], timeout=timeout,
            capture_output=True, text=True, env=dict(os.environ),
        )
        if proc.returncode != 0:
            return None
        put_s, get_s = (float(v) for v in proc.stdout.split()[-2:])
        return put_s, get_s
    except (OSError, ValueError, subprocess.SubprocessError):
        return None  # timeout/parse: routing stays off


_shared: BackendRouter | None = None
_shared_lock = threading.Lock()


def shared_router() -> BackendRouter:
    """Process-wide router: the link measurement is paid once, shared by
    every partition's kernel backend."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = BackendRouter()
        return _shared
