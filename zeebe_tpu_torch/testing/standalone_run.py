"""Run ``python -m zeebe_tpu_torch.standalone`` as a user runs it, and read
what it wrote.

``StandaloneProcess`` starts the entry point in a session of its own with a
data directory, reads its management port's JSON, stops it with SIGTERM (its
exit code is the result) and, whatever happened, leaves no process behind:
the teardown sends SIGKILL to the session and to every process whose command
line names the data directory (the supervisor starts each worker in a
session of its own). ``CompletionExporter`` is an external exporter the
brokers load from ``ZEEBE_BROKER_EXPORTERS_*`` (``completion_env``): it
writes the key of every process instance that completes, so a client
script knows when its traffic is done without a query API.
``replica_logs`` reads every replica's stream log offline, after a clean
stop, with the port's ``journal`` and ``logstreams``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

from zeebe_tpu_torch.exporters.api import Exporter
from zeebe_tpu_torch.protocol import ValueType
from zeebe_tpu_torch.protocol.intent import ProcessInstanceIntent

REPO = Path(__file__).resolve().parents[2]
MODULE = "zeebe_tpu_torch.standalone"
EXPORTER_ID = "COMPLETIONS"


def is_process_completion(record) -> bool:
    """Whether ``record`` is a process instance's ``ELEMENT_COMPLETED``."""
    return (record.value_type == ValueType.PROCESS_INSTANCE
            and record.value.get("bpmnElementType") == "PROCESS"
            and record.intent == ProcessInstanceIntent.ELEMENT_COMPLETED)


class CompletionExporter(Exporter):
    """Appends the key of each completed process instance, one a line, to a
    file of its own under the ``directory`` of its configuration. A new
    leader exports again from the last acknowledged position, so a key may
    be written twice; readers take the set."""

    def configure(self, context) -> None:
        self.context = context
        directory = Path(context.configuration["directory"])
        directory.mkdir(parents=True, exist_ok=True)
        self.path = directory / f"completed-{os.getpid()}-{id(self)}.txt"
        self._file = None

    def open(self, controller) -> None:
        self.controller = controller
        self._file = open(self.path, "a", buffering=1)  # noqa: SIM115 — closed in close()

    def export(self, record) -> None:
        if is_process_completion(record.record):
            self._file.write(f"{record.record.key}\n")
        self.controller.update_last_exported_position(record.position)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


def completion_env(directory: Path) -> dict[str, str]:
    """The environment that loads ``CompletionExporter`` into every broker
    the standalone starts, its files under ``directory``."""
    prefix = f"ZEEBE_BROKER_EXPORTERS_{EXPORTER_ID}"
    return {f"{prefix}_CLASSNAME": f"{__name__}.CompletionExporter",
            f"{prefix}_ARGS_DIRECTORY": str(directory)}


def completed_keys(directory: Path) -> set[int]:
    """Every key the completion exporters under ``directory`` wrote."""
    keys: set[int] = set()
    for path in Path(directory).glob("completed-*.txt"):
        keys.update(int(line) for line in path.read_text().split())
    return keys


def cmdline(pid: int) -> list[str]:
    """A live process's command line, or [] where it is gone."""
    try:
        raw = Path(f"/proc/{pid}/cmdline").read_bytes()
    except OSError:
        return []
    return [part.decode(errors="replace") for part in raw.split(b"\0") if part]


def processes_naming(text: str) -> list[int]:
    """The pids of the live processes whose command line names ``text``."""
    out = []
    for entry in Path("/proc").iterdir():
        if entry.name.isdigit() and any(text in part for part in cmdline(int(entry.name))):
            out.append(int(entry.name))
    return sorted(out)


class StandaloneProcess:
    """``python -m zeebe_tpu_torch.standalone <args> --data-dir <data_dir>``
    in a session of its own, its output in ``<data_dir>.log``."""

    def __init__(self, args: list[str], data_dir: Path, env: dict | None = None) -> None:
        self.data_dir = Path(data_dir)
        self.cmd = [sys.executable, "-m", MODULE, *args, "--data-dir", str(self.data_dir)]
        self.env = dict(os.environ if env is None else env)
        self.env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(REPO), self.env.get("PYTHONPATH")) if p)
        self.log_path = self.data_dir.with_name(self.data_dir.name + ".log")
        self.proc: subprocess.Popen | None = None
        self.started = 0.0

    def start(self) -> "StandaloneProcess":
        self.data_dir.mkdir(parents=True, exist_ok=True)
        with open(self.log_path, "ab") as log:
            self.proc = subprocess.Popen(self.cmd, cwd=REPO, env=self.env, stdout=log,
                                         stderr=subprocess.STDOUT, start_new_session=True)
        self.started = time.monotonic()
        return self

    def log(self) -> str:
        return self.log_path.read_text(errors="replace") if self.log_path.exists() else ""

    def exited(self) -> int | None:
        return None if self.proc is None else self.proc.poll()

    @staticmethod
    def get(port: int, path: str, timeout_s: float = 10.0) -> dict:
        """The JSON a management port answers on ``path``."""
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout_s) as r:
            return json.loads(r.read())

    def stop(self, timeout_s: float = 60.0) -> int | None:
        """SIGTERM, then the exit code; None where it did not exit in time
        (the caller's ``kill`` then ends it)."""
        if self.proc is None:
            return None
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            return None

    def processes(self) -> list[int]:
        """The standalone's live processes: itself and its workers."""
        return processes_naming(str(self.data_dir))

    def kill(self) -> list[int]:
        """SIGKILL the session and every process naming the data directory;
        returns the pids that were still alive before it."""
        alive = self.processes()
        if self.proc is not None and self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except OSError:
                pass
        for pid in alive:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        if self.proc is not None:
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        deadline = time.monotonic() + 10.0
        while self.processes() and time.monotonic() < deadline:
            time.sleep(0.05)
        return alive


def replica_logs(root: Path) -> dict[int, dict[str, dict[int, tuple[bytes, object]]]]:
    """Offline, after a clean stop: every replica's stream log under
    ``root`` (each ``<replica>/partition-<p>/stream`` directory), as
    partition → replica → position → (record bytes, record)."""
    from zeebe_tpu_torch.journal import SegmentedJournal
    from zeebe_tpu_torch.logstreams import LogStream

    out: dict[int, dict[str, dict[int, tuple[bytes, object]]]] = {}
    for stream_dir in sorted(Path(root).glob("**/partition-*/stream")):
        partition = int(stream_dir.parent.name.split("-", 1)[1])
        replica = stream_dir.parent.parent.relative_to(root).as_posix()
        journal = SegmentedJournal(stream_dir)
        try:
            out.setdefault(partition, {})[replica] = {
                v.position: (v.record.to_bytes(), v.record)
                for v in LogStream(journal, partition).scan()}
        finally:
            journal.close()
    return out


def merged_log(replicas: dict[str, dict[int, tuple[bytes, object]]]) -> dict[int, object]:
    """One partition's records from all its replicas, by position; raises
    where two replicas hold different bytes at one position."""
    merged: dict[int, tuple[bytes, object]] = {}
    for replica, log in sorted(replicas.items()):
        for position, entry in log.items():
            seen = merged.setdefault(position, entry)
            if seen[0] != entry[0]:
                raise AssertionError(f"replica {replica} disagrees at position {position}")
    return {position: record for position, (_, record) in merged.items()}
