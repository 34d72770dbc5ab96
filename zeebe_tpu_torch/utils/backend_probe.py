"""Killable probe of the CUDA cards, shared by every entry point.

The counterpart of ``zeebe_tpu/utils/backend_probe.py``, whose child asks
``jax.devices()``: here the child asks ``torch.cuda.is_available()`` and
``torch.cuda.device_count()``. A program that has not touched the card yet
must not find out in-process whether it answers: a wedged CUDA driver or
card can hang the first CUDA call. The probe runs the query in a
subprocess with a hard deadline — SIGKILL on wedge, never a blocking
``wait()`` on an unanswering child — so the one place the hazard is
handled cannot itself hang. Broker startup (the auto mesh's card count)
and the broker processes' start-up guard delegate here.

A wedged probe is a *verdict*, not a hang: the diagnostics record
``outcome: "probe-killed"`` with the deadline and the kill evidence, and the
``zeebe_device_probe_total{outcome}`` counter makes it visible on the
metrics plane. The reference's startup guard pins the CPU when no device
answers; the port's (:func:`require_card`, run by :func:`boot_card` in the
worker and the standalone) stops the process instead, with the probe's
verdict: a process serves on the CPU only when it is asked to
(``--device cpu``), never because the card did not answer.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

#: one shared timeout so all entry points agree on whether the card is up.
#: Override per host with ZEEBE_PROBE_TIMEOUT_S.
PROBE_TIMEOUT_SECS = 90


def probe_timeout_secs() -> int:
    """The effective probe deadline: ``ZEEBE_PROBE_TIMEOUT_S`` when set and
    parseable, else :data:`PROBE_TIMEOUT_SECS`."""
    raw = os.environ.get("ZEEBE_PROBE_TIMEOUT_S")
    if raw:
        try:
            value = int(float(raw))
            if value > 0:
                return value
        except ValueError:
            pass
    return PROBE_TIMEOUT_SECS


#: prints "<platform> <count>": "cuda N" with N cards, else "cpu 1" (the
#: host, one device)
_PROBE_CODE = ("import torch; ok = torch.cuda.is_available(); "
               "print('cuda' if ok else 'cpu', torch.cuda.device_count() if ok else 1)")

#: per-process probe memo keyed by the child command: each subprocess pays a
#: torch import and a CUDA driver handshake (up to the full deadline on a wedged
#: card), so one verdict per process is the intended granularity.
#: ``probe_with_retries`` bypasses cache READS so retries really re-probe.
_PROBE_CACHE: dict[tuple, tuple] = {}


def _probe_metric():
    """``zeebe_device_probe_total{outcome}`` — lazily resolved so importing
    this module never pulls the metrics registry in for nothing."""
    from zeebe_tpu_torch.utils.metrics import REGISTRY

    return REGISTRY.counter(
        "device_probe_total",
        "killable default-backend probes by outcome (ok / probe-killed / "
        "nonzero-exit / unparseable-stdout)",
        ("outcome",))


def _run_killable(cmd: list[str], timeout: int, cwd: str | None) -> tuple:
    """Run ``cmd`` with a HARD deadline: SIGKILL the child's session the
    moment the deadline passes (``subprocess.run``'s TimeoutExpired path
    first closes pipes and *waits*, which a truly wedged CUDA driver can
    outlive). Returns (rc | None, stdout, stderr, killed)."""
    proc = subprocess.Popen(
        cmd, cwd=cwd, env=dict(os.environ), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True,  # kill the child's whole session
    )
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
        return proc.returncode, stdout, stderr, False
    except subprocess.TimeoutExpired:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError, OSError):
            proc.kill()
        try:
            stdout, stderr = proc.communicate(timeout=5)
        except subprocess.TimeoutExpired:  # pragma: no cover — kernel-stuck
            stdout, stderr = "", ""
        return None, stdout, stderr, True


def probe_with_diagnostics(
    cwd: str | None = None, timeout: int | None = None,
    probe_cmd: list[str] | None = None, use_cache: bool = True,
) -> tuple[tuple[str, int] | None, dict]:
    """((platform, device_count) | None, diagnostics) of the cards.

    THE probe implementation — every other entry point delegates here.
    ``("cuda", n)`` when the child found n cards, ``("cpu", 1)`` when it
    found none; None means the child did not answer inside the deadline (a
    wedged CUDA driver — the child is SIGKILLed, outcome ``probe-killed``) or
    failed. The diagnostics dict carries the failure evidence (rc, stderr
    tail, elapsed, killed).

    ``probe_cmd`` injects the child command (tests simulate a wedged card
    with a subprocess that never answers and assert it is killed at the
    deadline); ``ZEEBE_PROBE_CMD`` does the same from outside the process.
    """
    if timeout is None:
        timeout = probe_timeout_secs()
    if probe_cmd is None and os.environ.get("ZEEBE_PROBE_CMD"):
        import shlex

        probe_cmd = shlex.split(os.environ["ZEEBE_PROBE_CMD"])
    cmd = probe_cmd or [sys.executable, "-c", _PROBE_CODE]
    cache_key = tuple(cmd)
    if use_cache and cache_key in _PROBE_CACHE:
        cached_res, cached_diag = _PROBE_CACHE[cache_key]
        return cached_res, dict(cached_diag, cached=True)
    t0 = time.monotonic()
    rc, stdout, stderr, killed = _run_killable(cmd, timeout, cwd)
    elapsed = round(time.monotonic() - t0, 1)
    if killed:
        _probe_metric().labels("probe-killed").inc()
        diag = {
            "outcome": "probe-killed",
            "timeout_s": timeout,
            "elapsed_s": elapsed,
            "killed": True,
            "stderr_tail": (stderr or "")[-800:],
        }
        _PROBE_CACHE[cache_key] = (None, dict(diag))
        return None, diag
    diag = {
        "outcome": "ok" if rc == 0 else "nonzero-exit",
        "rc": rc,
        "elapsed_s": elapsed,
        "stderr_tail": (stderr or "")[-800:],
    }
    if rc != 0:
        _probe_metric().labels("nonzero-exit").inc()
        _PROBE_CACHE[cache_key] = (None, dict(diag))
        return None, diag
    try:
        platform, count = (stdout or "").split()[-2:]
        result = (platform, int(count))
    except (ValueError, IndexError):
        diag["outcome"] = "unparseable-stdout"
        diag["stdout_tail"] = (stdout or "")[-200:]
        _probe_metric().labels("unparseable-stdout").inc()
        _PROBE_CACHE[cache_key] = (None, dict(diag))
        return None, diag
    _probe_metric().labels("ok").inc()
    _PROBE_CACHE[cache_key] = (result, dict(diag))
    return result, diag


def probe_default_backend(
    cwd: str | None = None, timeout: int | None = None
) -> tuple[str, int] | None:
    """(platform, device_count) of the cards, or None."""
    return probe_with_diagnostics(cwd, timeout)[0]


def probe_with_retries(
    attempts: int = 3,
    backoff_s: float = 20.0,
    timeout: int | None = None,
    log: list | None = None,
    cwd: str | None = None,
) -> tuple[str, int] | None:
    """Bounded-retry probe with backoff. Each attempt's diagnostics are
    appended to ``log``. Returns the first successful (platform,
    device_count), else None after ``attempts``."""
    for i in range(attempts):
        # bypass cache READS: a retry that returned the memoized failure
        # would never actually re-probe
        res, diag = probe_with_diagnostics(cwd, timeout, use_cache=False)
        diag["attempt"] = i + 1
        if log is not None:
            log.append(diag)
        if res is not None:
            return res
        if i + 1 < attempts:
            time.sleep(backoff_s)
    return None


def real_device_count(cwd: str | None = None,
                      timeout: int | None = None) -> int:
    """Number of CUDA cards, or 0 if none or unreachable."""
    res = probe_default_backend(cwd, timeout)
    if res is None or res[0] == "cpu":
        return 0
    return res[1]


class NoCardError(RuntimeError):
    """No CUDA card answered the start-up probe; ``diagnostics`` holds the
    probe's verdict (outcome, rc, elapsed seconds, the child's stderr tail
    and what it answered)."""

    def __init__(self, diagnostics: dict) -> None:
        super().__init__(f"no CUDA card answers the device probe: {diagnostics}")
        self.diagnostics = diagnostics


def require_card() -> dict:
    """Start-up guard for broker processes, the counterpart of the
    reference's ``pin_cpu_if_unreachable``: probe the cards in a killable
    subprocess and raise :class:`NoCardError` unless one answers. It never
    pins the CPU. Returns the probe's diagnostics (callers log them)."""
    res, diag = probe_with_diagnostics()
    if res is None or res[0] != "cuda":
        raise NoCardError(dict(diag, answer=res))
    return diag


def start_card(device=None) -> dict:
    """Bring ``device`` (None = the current card) up before a broker process
    serves, and time each step: ``cuda_s`` (the CUDA context, made by the
    first allocation on the card), ``library_s`` (the kernel library: built
    if these sources have none, then loaded) and ``link_s`` (the router's
    measurement of the card's link, in a child); with whether routing is on
    and the link cost it predicts for a group (``link_cost_ms``; above
    ``BackendRouter.LOCAL_LINK_S`` the process declines its groups). Each is paid once per
    process; left to the first kernel group a leader dispatches, it would
    stall the thread that also drives the partitions' Raft for seconds,
    and the followers would elect another leader."""
    import torch

    from zeebe_tpu_torch.ops import kernels
    from zeebe_tpu_torch.ops.automaton import resolve_device
    from zeebe_tpu_torch.utils.device_link import shared_router

    dev = resolve_device(device)
    t0 = time.monotonic()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    t1 = time.monotonic()
    kernels.load()
    t2 = time.monotonic()
    router = shared_router()
    with torch.cuda.device(dev):
        router.accel_device()
    t3 = time.monotonic()
    return {"cuda_s": round(t1 - t0, 3), "library_s": round(t2 - t1, 3),
            "link_s": round(t3 - t2, 3), "routing": router.enabled,
            "link_cost_ms": None if router.link_cost_s() is None
            else round(1e3 * router.link_cost_s(), 4)}


def boot_card(device, name: str, warm: bool = True) -> int:
    """A broker process's start-up on its device: nothing when ``device``
    asks for the CPU; else :func:`require_card`, then (``warm``)
    :func:`start_card`. Prints the probe's verdict and the card's start-up
    seconds on stderr after ``name``. Returns 0, or 2 when no card answers
    (the process exits with it, the verdict on stderr). None, the default
    device, is the card."""
    import torch

    if device is not None and torch.device(device).type == "cpu":
        return 0
    try:
        diag = require_card()
    except NoCardError as exc:
        print(f"{name} {exc}; pass --device cpu to serve on the CPU",
              file=sys.stderr, flush=True)
        return 2
    print(f"{name} device probe: {diag}", file=sys.stderr, flush=True)
    if warm:
        print(f"{name} card up: {start_card(device)}", file=sys.stderr, flush=True)
    return 0
