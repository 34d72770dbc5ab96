"""Worker supervisor: spawn, monitor, restart per-core broker processes.

Reference shape: a process manager in front of N StandaloneBroker instances
(systemd / the k8s statefulset the reference deploys as), reduced to what
the single-host scale-out needs:

- spawn each worker as a child process (stderr teed to ``<data-dir>/worker.log``
  when the spec has a data dir, so a crashed worker leaves evidence);
- monitor liveness; a worker that EXITS while the supervisor is running is
  restarted with exponential backoff (crash loops are bounded, a healthy
  restart resets the backoff) — the restarted worker recovers its partitions
  through the snapshot+replay path over its data dir;
- stop with SIGTERM, escalate to SIGKILL after a grace period (a wedged
  device runtime must not be able to hold shutdown hostage — the same
  discipline as the killable device probe).

``zeebe_worker_restarts_total{worker}`` counts restarts on the metrics
plane; :meth:`WorkerSupervisor.status` feeds the gateway's
``/cluster/status`` ``workers`` section.

The port's spawn line carries the workers' ``--device`` (none = the card);
the rest is the reference's, copied.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

# copied from the reference: logger .. WorkerSpec
logger = logging.getLogger("zeebe_tpu_torch.multiproc.supervisor")


@dataclasses.dataclass
class WorkerSpec:
    """One worker process: its identity and the exact command to run it.

    ``cmd`` is explicit (not derived) so tests can supervise stub processes
    and operators can see the full spawn line in ``status()``."""

    node_id: str
    cmd: list[str]
    data_dir: str | None = None
    management_port: int = 0
    # per-worker environment overlay on the supervisor env (chaos knobs:
    # e.g. one worker armed with ZEEBE_CHAOS_CRASH_AFTER_APPENDS)
    extra_env: dict | None = None
# end of the copy


def worker_cmd(node_id: str, bind: str, contact: str, gateways: str,
               partitions: int, replication: int,
               data_dir: str | None = None,
               management_port: int = 0, device=None) -> list[str]:
    """The canonical ``python -m zeebe_tpu_torch.multiproc.worker`` spawn line;
    ``device`` (the kernel backend's: ``"cpu"`` for the plain version) goes
    on it as ``--device`` when given, else the worker runs on the card."""
    cmd = [sys.executable, "-m", "zeebe_tpu_torch.multiproc.worker",
           "--node-id", node_id, "--bind", bind, "--contact", contact,
           "--gateway", gateways,
           "--partitions", str(partitions),
           "--replication", str(replication)]
    if data_dir:
        cmd += ["--data-dir", str(data_dir)]
    if management_port:
        cmd += ["--management-port", str(management_port)]
    if device is not None:
        cmd += ["--device", str(device)]
    return cmd


class WorkerSupervisor:
    """Spawn/monitor/restart a set of :class:`WorkerSpec` processes."""

    # copied from the reference: __init__ .. status
    def __init__(self, specs: list[WorkerSpec], env: dict | None = None,
                 restart_backoff_s: float = 0.5, max_backoff_s: float = 10.0,
                 stable_after_s: float = 30.0,
                 grace_period_s: float = 5.0) -> None:
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        self.specs = {spec.node_id: spec for spec in specs}
        if env is None:
            env = dict(os.environ)
            # workers must import zeebe_tpu exactly as this process does
            pkg_parent = str(Path(__file__).resolve().parent.parent.parent)
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (pkg_parent, env.get("PYTHONPATH")) if p)
        self._env = env
        self._restart_backoff_s = restart_backoff_s
        self._max_backoff_s = max_backoff_s
        self._stable_after_s = stable_after_s
        self._grace_period_s = grace_period_s
        self._procs: dict[str, subprocess.Popen] = {}
        self._logs: dict[str, object] = {}
        self._backoff: dict[str, float] = {}
        self._restart_at: dict[str, float] = {}
        self._spawned_at: dict[str, float] = {}
        self.restarts: dict[str, int] = {s: 0 for s in self.specs}
        # observer seam: called (node_id, restart count) AFTER a successful
        # respawn — the gateway runtime records it in its flight recorder
        self.on_restart = None
        self._running = False
        self._monitor_thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._m_restarts = REGISTRY.counter(
            "worker_restarts_total",
            "worker processes restarted by the supervisor after an "
            "unexpected exit", ("worker",))

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        self._running = True
        for node_id in self.specs:
            self._spawn(node_id)
        self._monitor_thread = threading.Thread(
            target=self._monitor, daemon=True, name="worker-supervisor")
        self._monitor_thread.start()

    def _spawn(self, node_id: str) -> None:
        spec = self.specs[node_id]
        stderr = subprocess.DEVNULL
        if spec.data_dir:
            Path(spec.data_dir).mkdir(parents=True, exist_ok=True)
            old_log = self._logs.pop(node_id, None)
            if old_log is not None:
                try:  # a restart must not leak the previous spawn's fd
                    old_log.close()
                except OSError:  # pragma: no cover
                    pass
            log = open(Path(spec.data_dir) / "worker.log", "ab")
            self._logs[node_id] = log
            stderr = log
        env = self._env
        if spec.extra_env:
            env = {**env, **spec.extra_env}
        proc = subprocess.Popen(
            spec.cmd, env=env,
            stdout=stderr, stderr=stderr,
            start_new_session=True,  # SIGKILL escalation targets the whole
            # session: a worker's own children must not survive it
        )
        with self._lock:
            self._procs[node_id] = proc
            self._spawned_at[node_id] = time.monotonic()
        logger.info("spawned worker %s pid=%s", node_id, proc.pid)

    def _monitor(self) -> None:
        while self._running:
            now = time.monotonic()
            for node_id in list(self.specs):
                try:
                    self._monitor_one(node_id, now)
                except Exception:  # noqa: BLE001 — a failed respawn (fork
                    # EAGAIN under memory pressure, log-file open error) must
                    # not kill the monitor thread and silently end
                    # supervision for EVERY worker; retry next tick
                    logger.exception("supervising %s failed; retrying",
                                     node_id)
            time.sleep(0.05)

    def _monitor_one(self, node_id: str, now: float) -> None:
        proc = self._procs.get(node_id)
        if proc is None or proc.poll() is None:
            # alive long enough → the crash loop (if any) is over
            if (proc is not None and node_id in self._backoff
                    and now - self._spawned_at.get(node_id, now)
                    >= self._stable_after_s):
                self._backoff.pop(node_id, None)
            return
        if not self._running:
            return
        due = self._restart_at.get(node_id)
        if due is None:
            backoff = self._backoff.get(node_id, self._restart_backoff_s)
            self._backoff[node_id] = min(backoff * 2, self._max_backoff_s)
            self._restart_at[node_id] = now + backoff
            logger.warning("worker %s exited rc=%s; restarting in %.1fs",
                           node_id, proc.returncode, backoff)
            return
        if now >= due:
            self._restart_at.pop(node_id, None)
            # count AFTER the spawn succeeds: a failed respawn (fork EAGAIN,
            # log-open error) is retried by the monitor and must not count
            # the same crash twice on the restarts dashboard
            self._spawn(node_id)
            self.restarts[node_id] += 1
            self._m_restarts.labels(node_id).inc()
            if self.on_restart is not None:
                try:
                    self.on_restart(node_id, self.restarts[node_id])
                except Exception:  # noqa: BLE001 — observation must never
                    logger.exception("on_restart observer failed")  # stop supervision

    def stop(self) -> None:
        self._running = False
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=5)
        procs = list(self._procs.items())
        for _node_id, proc in procs:
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGTERM)
                except (ProcessLookupError, PermissionError, OSError):
                    proc.terminate()
        deadline = time.monotonic() + self._grace_period_s
        for node_id, proc in procs:
            remaining = deadline - time.monotonic()
            try:
                proc.wait(timeout=max(remaining, 0.05))
            except subprocess.TimeoutExpired:
                logger.warning("worker %s ignored SIGTERM; killing", node_id)
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError, OSError):
                    proc.kill()
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:  # pragma: no cover
                    logger.error("worker %s unkillable", node_id)
        for log in self._logs.values():
            try:
                log.close()
            except OSError:  # pragma: no cover
                pass
        self._logs.clear()

    # -- introspection ---------------------------------------------------------

    def kill_worker(self, node_id: str) -> None:
        """SIGKILL one worker (chaos/tests): the monitor restarts it."""
        proc = self._procs.get(node_id)
        if proc is not None and proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError, OSError):
                proc.kill()

    def alive(self) -> dict[str, bool]:
        return {n: (p is not None and p.poll() is None)
                for n, p in self._procs.items()}

    def pid_of(self, node_id: str) -> int | None:
        proc = self._procs.get(node_id)
        if proc is None or proc.poll() is not None:
            return None
        return proc.pid

    def status(self) -> dict:
        """Per-worker supervision row for ``/cluster/status``."""
        out = {}
        for node_id, spec in self.specs.items():
            proc = self._procs.get(node_id)
            out[node_id] = {
                "pid": proc.pid if proc is not None else None,
                "alive": proc is not None and proc.poll() is None,
                "returncode": proc.returncode if proc is not None else None,
                "restarts": self.restarts.get(node_id, 0),
                "managementPort": spec.management_port,
            }
        return out
    # end of the copy
