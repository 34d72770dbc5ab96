"""Continuous profiling plane: always-on sampling, compile & device telemetry.

Datacenter practice (Google-Wide Profiling, Ren et al., IEEE Micro 2010)
settled on two complementary capture shapes: an **always-on, low-rate
sampler** whose cost disappears into noise but whose aggregate answers
"where do the cycles go" for any past window, and **on-demand deep captures**
for the moments that deserve a microscope. This module carries both for the
broker, plus the two telemetry sources the host profiler cannot see:

- :class:`ContinuousProfiler` — a daemon thread sampling every runtime
  thread's Python stack at a low configurable rate (default ~19 Hz — a prime
  rate, so the sampler cannot alias against millisecond-periodic work),
  aggregating **folded stacks** (semicolon-joined frames, the
  flamegraph.pl / speedscope input format) into bounded time-bucketed
  windows with whole-window eviction. Served at ``GET /profile/continuous``
  and snapshotted into flight dumps.
- **XLA compile telemetry** — :func:`observe_compile` is the sink for the
  kernel backend's compile seam (engine/kernel_backend.py times the first
  dispatch of every group geometry): ``zeebe_xla_compile_seconds`` histogram
  labeled by geometry bucket, ``zeebe_xla_compiles_total{cache=hit|miss}``
  where *miss* means the wall time exceeded the persistent-cache threshold
  (utils/xla_cache.py sets ``jax_persistent_cache_min_compile_time_secs`` to
  the same constant) — i.e. XLA really compiled instead of loading from disk.
- **Device memory telemetry** — :func:`sample_device_memory` reads
  ``torch.cuda``'s memory statistics into
  ``zeebe_device_memory_bytes{device,kind}`` gauges (``kind=in_use|limit``,
  ``device=gpu:<index>``), sampled on the broker control pump at the
  metrics cadence. The device list holds the CUDA cards only once this
  process has initialized CUDA: telemetry never initializes the card.
- :class:`AlertProfileCapture` — when the alert evaluator transitions a rule
  to firing, records a short folded-stack profile into the flight recorder
  (throttled per rule), so a dump explains not just *what* fired but *what
  the threads were doing* at that moment.
- :class:`DeviceTraceCapture` — single-flight on-demand ``torch.profiler``
  capture (CPU and CUDA activity) into
  ``<data-dir>/torch-trace-<ts>/trace.json`` (a Chrome trace) behind
  ``POST /profile/device``, so the kernel launches and their device time
  become visible in Perfetto.

Cost contract (same shape as the metrics plane): ``profiling_hz=0``
constructs nothing — one is-None check; at the default 19 Hz one sampling
tick walks every thread's stack once (tens of microseconds at typical broker
thread counts), which stays within bench noise.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Iterable

from zeebe_tpu_torch.utils.metrics import REGISTRY as _REG

DEFAULT_HZ = 19.0
DEFAULT_WINDOW_MS = 10_000
DEFAULT_MAX_WINDOWS = 30
DEFAULT_MAX_DEPTH = 48

# every sampler daemon carries this name so samplers can exclude each other:
# an in-process multi-broker cluster runs one per broker, and N wait-loops
# sampling each other is pure noise in every broker's profile
PROFILER_THREAD_NAME = "continuous-profiler"

# wall-time boundary between "the persistent XLA cache (or a trivial
# program) served this" and "XLA really compiled": the same 1.0s that
# utils/xla_cache.py sets as jax_persistent_cache_min_compile_time_secs —
# an executable that took longer than this to produce would have been
# written to the disk cache, so seeing the time again means a cache miss
COMPILE_MISS_THRESHOLD_S = 1.0

_M_COMPILE_SECONDS = _REG.histogram(
    "xla_compile_seconds",
    "wall seconds of the first kernel dispatch per group geometry "
    "(jit trace + lowering + XLA compile or persistent-cache load)",
    ("bucket",),
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 30.0, 60.0, 120.0))
_M_COMPILES = _REG.counter(
    "xla_compiles_total",
    "first kernel dispatches per group geometry, split by persistent-cache "
    "outcome (miss = wall time above the persistent-cache threshold, i.e. "
    "XLA really compiled)",
    ("cache",))
_M_DEVICE_MEMORY = _REG.gauge(
    "device_memory_bytes",
    "accelerator memory from device.memory_stats(), kind=in_use|limit "
    "(absent on backends without memory introspection, e.g. CPU)",
    ("device", "kind"))


# -- stack sampling -----------------------------------------------------------


def sample_threads(exclude_idents: Iterable[int] = (),
                   max_depth: int = DEFAULT_MAX_DEPTH,
                   ) -> list[tuple[str, list[str]]]:
    """One snapshot of every live thread's Python stack:
    ``[(thread_name, frames root→leaf)]``. The name map is taken fresh on
    every call, so threads spawned after a profiling window began still
    report by name instead of raw ident (the one-shot ``/profile``'s
    original bug). Frames are ``file.py:function`` — stable across samples
    (no line numbers), so folded stacks aggregate instead of exploding one
    entry per bytecode offset."""
    exclude = set(exclude_idents)
    names = {t.ident: t.name for t in threading.enumerate()}
    out: list[tuple[str, list[str]]] = []
    for ident, frame in sys._current_frames().items():
        if ident in exclude:
            continue
        frames: list[str] = []
        depth = 0
        while frame is not None and depth < max_depth:
            code = frame.f_code
            frames.append(
                f"{code.co_filename.rsplit('/', 1)[-1]}:{code.co_name}")
            frame = frame.f_back
            depth += 1
        frames.reverse()  # folded stacks read root-first
        out.append((names.get(ident, f"thread-{ident}"), frames))
    return out


def fold_stacks(stacks: list[tuple[str, list[str]]]) -> dict[str, int]:
    """Fold one snapshot into ``{"thread;root;...;leaf": 1}`` counts — the
    flamegraph.pl / speedscope collapsed-stack key, thread name as the root
    frame so per-thread flames separate in the graph."""
    out: dict[str, int] = {}
    for name, frames in stacks:
        key = ";".join([name, *frames]) if frames else name
        out[key] = out.get(key, 0) + 1
    return out


def folded_text(stacks: dict[str, int]) -> str:
    """``"stack count"`` lines, heaviest first — pipe straight into
    flamegraph.pl, or load as "collapsed stacks" in speedscope."""
    return "\n".join(
        f"{stack} {count}"
        for stack, count in sorted(stacks.items(), key=lambda kv: (-kv[1], kv[0]))
    )


class _Window:
    __slots__ = ("start_ms", "samples", "stacks")

    def __init__(self, start_ms: int) -> None:
        self.start_ms = start_ms
        self.samples = 0
        self.stacks: dict[str, int] = {}


class ContinuousProfiler:
    """Always-on low-rate sampling profiler over every runtime thread.

    Aggregates folded stacks into ``window_ms`` buckets; at most
    ``max_windows`` windows are retained and eviction is whole-window (the
    same bounded-memory discipline as the time-series store's blocks).
    Sampling is driven by a daemon thread with deadline pacing (sleep-only
    pacing undershoots the requested rate by the per-tick work); windows are
    bucketed by ``clock_millis`` so a controlled-clock test is deterministic
    via :meth:`sample_now`."""

    def __init__(self, hz: float = DEFAULT_HZ,
                 window_ms: int = DEFAULT_WINDOW_MS,
                 max_windows: int = DEFAULT_MAX_WINDOWS,
                 clock_millis: Callable[[], int] | None = None,
                 max_depth: int = DEFAULT_MAX_DEPTH) -> None:
        self.hz = float(hz)
        self.window_ms = int(window_ms)
        self.max_windows = int(max_windows)
        self.max_depth = max_depth
        self.clock_millis = clock_millis or (lambda: int(time.time() * 1000))
        self._windows: OrderedDict[int, _Window] = OrderedDict()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.samples_taken = 0
        self.achieved_hz = 0.0

    # -- sampling --------------------------------------------------------------

    def sample_now(self, now_ms: int | None = None) -> None:
        """One sampling tick (the thread loop calls this; tests and
        pump-driven callers call it directly with a controlled clock). Every
        profiler daemon thread is excluded — ours AND any sibling broker's
        in the same process (an in-process cluster runs one sampler per
        broker; their wait-loops are pure mutual noise) — but a direct
        caller's stack is real work and counts."""
        now = self.clock_millis() if now_ms is None else now_ms
        bucket = now - now % self.window_ms
        skip = {t.ident for t in threading.enumerate()
                if t.name == PROFILER_THREAD_NAME}
        stacks = fold_stacks(sample_threads(
            exclude_idents=skip, max_depth=self.max_depth))
        with self._lock:
            win = self._windows.get(bucket)
            if win is None:
                win = self._windows[bucket] = _Window(bucket)
                while len(self._windows) > self.max_windows:
                    self._windows.popitem(last=False)  # whole-window eviction
            for key, count in stacks.items():
                win.stacks[key] = win.stacks.get(key, 0) + count
            win.samples += 1
            self.samples_taken += 1

    def _run(self) -> None:
        interval = 1.0 / self.hz
        started = time.monotonic()
        next_tick = started + interval
        ticks = 0
        while not self._stop.is_set():
            try:
                self.sample_now()
            except Exception:  # noqa: BLE001 — a torn frame walk must never
                pass           # kill the sampler
            ticks += 1
            elapsed = time.monotonic() - started
            if elapsed > 0:
                self.achieved_hz = round(ticks / elapsed, 2)
            # deadline pacing: schedule against the ideal timeline so the
            # per-tick work does not silently lower the achieved rate
            delay = next_tick - time.monotonic()
            if delay <= 0:
                next_tick = time.monotonic() + interval  # overran: no burst
                continue
            if self._stop.wait(delay):
                break
            next_tick += interval

    def start(self) -> None:
        if self._thread is not None or self.hz <= 0:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=PROFILER_THREAD_NAME)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5)
        self._thread = None

    # -- views -----------------------------------------------------------------

    def windows(self, since_ms: int = 0) -> list[dict]:
        with self._lock:
            return [
                {"startMs": w.start_ms, "windowMs": self.window_ms,
                 "samples": w.samples, "stacks": dict(w.stacks)}
                for w in self._windows.values()
                if w.start_ms + self.window_ms > since_ms
            ]

    def aggregate(self, since_ms: int = 0) -> dict[str, int]:
        """Folded-stack counts summed over every retained window that
        overlaps ``[since_ms, now]``."""
        out: dict[str, int] = {}
        with self._lock:
            for w in self._windows.values():
                if w.start_ms + self.window_ms <= since_ms:
                    continue
                for key, count in w.stacks.items():
                    out[key] = out.get(key, 0) + count
        return out

    def folded(self, since_ms: int = 0) -> str:
        return folded_text(self.aggregate(since_ms))

    def top_stacks(self, top: int = 10, since_ms: int = 0) -> list[dict]:
        ranked = sorted(self.aggregate(since_ms).items(),
                        key=lambda kv: (-kv[1], kv[0]))[:top]
        return [{"stack": s, "samples": c} for s, c in ranked]

    def hot_frames(self, top: int = 10, since_ms: int = 0) -> list[dict]:
        """Per-frame inclusive sample counts (a frame counts once per stack
        it appears in), heaviest first — the "top functions" view."""
        by_frame: dict[str, int] = {}
        total = 0
        for stack, count in self.aggregate(since_ms).items():
            total += count
            for frame in set(stack.split(";")[1:]):  # [0] is the thread name
                by_frame[frame] = by_frame.get(frame, 0) + count
        ranked = sorted(by_frame.items(), key=lambda kv: (-kv[1], kv[0]))[:top]
        return [
            {"frame": f, "samples": c,
             "pct": round(100.0 * c / max(total, 1), 1)}
            for f, c in ranked
        ]

    def snapshot_summary(self, top: int = 15) -> dict:
        """Compact view folded into flight dumps: totals + heaviest stacks.
        Bounded (``top`` stacks), so a dump stays readable."""
        with self._lock:
            windows = len(self._windows)
        return {
            "hz": self.hz,
            "achievedHz": self.achieved_hz,
            "samples": self.samples_taken,
            "windows": windows,
            "topStacks": self.top_stacks(top=top),
        }


# -- process-global sharing ---------------------------------------------------
#
# One sampler per PROCESS, not per broker: stack sampling is inherently
# process-wide (sys._current_frames sees every thread), so an in-process
# multi-broker cluster running N samplers would pay N full-process walks
# per tick to retain N copies of the same data — the same shape
# install_process_metrics already dedupes for the self-metrics collect
# hook. Brokers lease the shared instance; the last release stops it, so
# balanced acquire/release cannot leak state across test boundaries.

_SHARED_LOCK = threading.Lock()
_SHARED: ContinuousProfiler | None = None
_SHARED_LEASES: set[object] = set()


def acquire_profiler(hz: float,
                     clock_millis: Callable[[], int] | None = None,
                     window_ms: int = DEFAULT_WINDOW_MS,
                     max_windows: int = DEFAULT_MAX_WINDOWS,
                     ) -> tuple[ContinuousProfiler, object]:
    """Lease the process-global :class:`ContinuousProfiler`, starting it on
    first acquire. The first acquirer's parameters win for the sampler's
    lifetime (per-broker attribution is by thread name, not by instance).
    Returns ``(profiler, lease)``; pass the lease to
    :func:`release_profiler` exactly once."""
    global _SHARED
    with _SHARED_LOCK:
        if _SHARED is None:
            _SHARED = ContinuousProfiler(hz=hz, clock_millis=clock_millis,
                                         window_ms=window_ms,
                                         max_windows=max_windows)
            _SHARED.start()
        lease: object = object()
        _SHARED_LEASES.add(lease)
        return _SHARED, lease


def release_profiler(lease: object | None) -> None:
    """Return a lease from :func:`acquire_profiler`; stops and discards the
    shared sampler when the last lease goes. ``None`` / double release are
    no-ops (close-after-hard-crash must be safe)."""
    global _SHARED
    if lease is None:
        return
    with _SHARED_LOCK:
        _SHARED_LEASES.discard(lease)
        if not _SHARED_LEASES and _SHARED is not None:
            _SHARED.stop()
            _SHARED = None


# -- XLA compile telemetry ----------------------------------------------------


def observe_compile(bucket: str, seconds: float) -> str:
    """Record one compile-seam observation (the kernel backend's first
    dispatch of a group geometry). Returns the cache classification."""
    cache = "miss" if seconds >= COMPILE_MISS_THRESHOLD_S else "hit"
    _M_COMPILE_SECONDS.labels(bucket).observe(seconds)
    _M_COMPILES.labels(cache).inc()
    return cache


# -- device memory telemetry --------------------------------------------------

# the CUDA devices, cached once CUDA is up: from then on the set is static
_DEVICES: list | None = None


def _resolve_devices() -> list:
    """The device list for memory sampling: the CUDA cards, and only once
    this process has initialized CUDA. Telemetry never initializes the card
    (the first kernel dispatch does), just as the reference never touches
    an accelerator backend that has not initialized; a process that has not
    imported torch has no card up. A card brought up later joins on a later
    tick; the broker pump must never block on telemetry."""
    global _DEVICES
    if _DEVICES is not None:
        return _DEVICES
    torch = sys.modules.get("torch")
    try:
        if torch is None or not torch.cuda.is_initialized():
            return []
        _DEVICES = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return _DEVICES
    except Exception:  # noqa: BLE001 — telemetry must never take a pump down
        return []


def _memory_stats(dev) -> dict:
    """One card's ``in_use`` bytes (the caching allocator's allocated bytes)
    and ``limit`` (the card's total memory); empty for a device that is not
    a CUDA card."""
    import torch

    if dev.type != "cuda":
        return {}
    return {"in_use": torch.cuda.memory_stats(dev).get("allocated_bytes.all.current"),
            "limit": torch.cuda.mem_get_info(dev)[1]}


def sample_device_memory(devices: list | None = None) -> int:
    """Update ``zeebe_device_memory_bytes`` from ``torch.cuda``'s memory
    statistics for each ``torch.device``. Returns the number of gauge
    children updated (0 for devices without stats: a CPU device, or a card
    whose query raises)."""
    updated = 0
    for dev in (_resolve_devices() if devices is None else devices):
        try:
            stats = _memory_stats(dev)
        except Exception:  # noqa: BLE001 — telemetry must never take a pump down
            continue
        label = f"gpu:{dev.index if dev.index is not None else 0}"
        for kind, value in stats.items():
            if value is not None:
                _M_DEVICE_MEMORY.labels(label, kind).set(float(value))
                updated += 1
    return updated


# -- alert-triggered capture --------------------------------------------------

ALERT_CAPTURE_MIN_INTERVAL_MS = 30_000


class AlertProfileCapture:
    """Records a short folded-stack profile into the flight recorder when an
    alert rule transitions to firing — throttled per rule, so a flapping
    alert cannot flood the rings. With a continuous profiler attached the
    capture is its recent aggregate (zero extra sampling work); without one
    it takes a single instantaneous stack snapshot (one
    ``sys._current_frames()`` pass — safe on the pump thread)."""

    def __init__(self, recorder, profiler: ContinuousProfiler | None = None,
                 min_interval_ms: int = ALERT_CAPTURE_MIN_INTERVAL_MS,
                 clock_millis: Callable[[], int] | None = None,
                 top: int = 10) -> None:
        self.recorder = recorder
        self.profiler = profiler
        self.min_interval_ms = min_interval_ms
        self.clock_millis = clock_millis or (lambda: int(time.time() * 1000))
        self.top = top
        self._last_ms: dict[str, int] = {}

    def on_firing(self, rule_name: str, labels: str = "") -> bool:
        now = self.clock_millis()
        last = self._last_ms.get(rule_name)
        if last is not None and now - last < self.min_interval_ms:
            return False
        self._last_ms[rule_name] = now
        if self.profiler is not None and self.profiler.samples_taken:
            source = "continuous"
            stacks = self.profiler.top_stacks(
                top=self.top, since_ms=now - 2 * self.profiler.window_ms)
        else:
            # one instantaneous snapshot, caller included: the firing pump
            # thread's stack is precisely the "what was it doing" evidence
            source = "instant"
            folded = fold_stacks(sample_threads())
            stacks = [{"stack": s, "samples": c}
                      for s, c in sorted(folded.items(),
                                         key=lambda kv: (-kv[1], kv[0]))
                      [:self.top]]
        self.recorder.record(0, "profile", rule=rule_name, labels=labels,
                             source=source, stacks=stacks)
        return True


# -- on-demand device capture -------------------------------------------------


class CaptureInFlight(RuntimeError):
    """A device trace capture is already running (single-flight guard)."""


class _TorchTrace:
    """The default start and stop of a device capture: a ``torch.profiler``
    session of CPU and CUDA activity (CPU alone without CUDA), written as a
    Chrome trace to ``<trace dir>/trace.json`` when it stops. A profiler
    session belongs to the thread that started it, and a capture stops on
    its own timer thread, so the session runs on a thread of its own that
    ``start`` and ``stop`` signal; the card's activity is traced whichever
    thread launched it."""

    def __init__(self) -> None:
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._error: BaseException | None = None

    def start(self, trace_dir: str) -> None:
        started = threading.Event()
        self._stop.clear()
        self._error = None

        def session() -> None:
            try:
                import torch
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(ProfilerActivity.CUDA)
                prof = profile(activities=activities)
                prof.start()
            except BaseException as exc:  # noqa: BLE001 — re-raised by start()
                self._error = exc
                started.set()
                return
            started.set()
            self._stop.wait()
            try:
                prof.stop()
                prof.export_chrome_trace(str(Path(trace_dir) / "trace.json"))
            except BaseException as exc:  # noqa: BLE001 — re-raised by stop()
                self._error = exc

        self._thread = threading.Thread(target=session, daemon=True,
                                        name="device-trace-session")
        self._thread.start()
        started.wait()
        if self._error is not None:
            self._thread.join()
            self._thread = None
            raise self._error

    def stop(self) -> None:
        thread, self._thread = self._thread, None
        if thread is None:
            raise RuntimeError("no device trace in progress")
        self._stop.set()
        thread.join()
        if self._error is not None:
            raise self._error


class DeviceTraceCapture:
    """Single-flight ``torch.profiler`` capture into
    ``<base-dir>/torch-trace-<ts>/trace.json`` — the deep-capture half of the
    GWP shape. ``start()`` begins the trace and returns (a daemon thread
    stops it after ``seconds``); the first-ever call pays the profiler's
    one-time initialization, which can take seconds. A second start while
    one is in flight raises :class:`CaptureInFlight` (the management
    endpoint maps it to 409) — instantly, even during that init.
    ``start_fn``/``stop_fn`` are injectable for tests; the defaults bind a
    ``torch.profiler`` session (:class:`_TorchTrace`)."""

    def __init__(self, base_dir: str | Path,
                 start_fn: Callable[[str], None] | None = None,
                 stop_fn: Callable[[], None] | None = None) -> None:
        self.base_dir = Path(base_dir)
        self._start_fn = start_fn
        self._stop_fn = stop_fn
        self._default = _TorchTrace()
        self._lock = threading.Lock()
        self._active_dir: Path | None = None
        self._cancel = threading.Event()
        self._thread: threading.Thread | None = None
        self.captures_taken = 0

    @property
    def active_dir(self) -> Path | None:
        return self._active_dir

    def start(self, seconds: float) -> Path:
        with self._lock:
            if self._active_dir is not None:
                raise CaptureInFlight(
                    f"device capture already in flight: {self._active_dir}")
            # monotonic nanos: unique even for back-to-back captures and
            # under a frozen test wall clock
            trace_dir = self.base_dir / f"torch-trace-{time.monotonic_ns()}"
            trace_dir.mkdir(parents=True, exist_ok=True)
            # reserve the slot before the (potentially slow) profiler start:
            # the profiler's first start initializes its backend, which
            # can take seconds — a concurrent start() must 409 instantly
            # rather than queue behind that init on this lock
            self._active_dir = trace_dir
            self._cancel.clear()
        try:
            start = self._start_fn or self._default.start
            start(str(trace_dir))
        except Exception:
            with self._lock:
                self._active_dir = None
            try:
                trace_dir.rmdir()  # empty — don't leave a capture-shaped husk
            except OSError:
                pass
            raise

        def finish() -> None:
            self._cancel.wait(seconds)
            stop = self._stop_fn or self._default.stop
            try:
                stop()
            except Exception:  # noqa: BLE001 — a failed stop must still
                pass           # release the single-flight slot
            finally:
                with self._lock:
                    self._active_dir = None
                    self.captures_taken += 1

        self._thread = threading.Thread(target=finish, daemon=True,
                                        name="device-trace-capture")
        self._thread.start()
        return trace_dir

    def wait(self, timeout: float = 10.0) -> None:
        """Block until the in-flight capture (if any) completes — tests and
        orderly shutdown."""
        thread = self._thread
        if thread is not None:
            thread.join(timeout=timeout)

    def cancel(self) -> None:
        """End an in-flight capture early (shutdown path)."""
        self._cancel.set()
        self.wait()
