"""The port's standalone entry point and the modules under it.

- Copies: ``testing/copies.py``'s ``STANDALONE_STACK`` equals the
  reference modulo the package name, and each partial copy of this slice
  (the TCP runtime, the chaos harness, the supervisor, the worker, the
  gateway's multi-process runtime, the standalone) differs from the
  reference only in the members named here (the checks of
  ``tests/test_torch_cluster_copies.py``).
- Routing: the multi-process gateway routes a partition to the leader of
  the highest term among the fresh status rows, so a killed worker's last
  row does not hold its partitions once another worker is elected.
- Imports: the new modules load neither JAX nor the reference.
- Loopback parity: one worker runtime behind the multi-process gateway
  runtime over the loopback network, with the kernel backend, gives the
  same responses on the reference (JAX on the CPU) and on the port (its
  plain version), the real clock's fields masked.
- No fallback: without a card and without ``--device cpu`` the worker and
  every shape of the standalone exit non-zero with the probe's verdict; a
  wedged probe stops the worker at its deadline before it binds its port.
- One real worker process with ``--device cpu`` behind the gateway runtime
  serves instances on its kernel backend; the in-process standalone serves
  a gRPC client with ``--device cpu``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from test_torch_cluster_copies import (
    check_copied_runs,
    check_imports,
    check_member_plus_names,
    check_members_copied_or_named,
)
from test_torch_tables import as_copied
from torch_gateway_flows import masked
from zeebe_tpu_torch.testing import copies
from zeebe_tpu_torch.testing import standalone_run as S

REPO = Path(__file__).resolve().parents[1]
REF = REPO / "zeebe_tpu"
PORT = REPO / "zeebe_tpu_torch"

#: the port's members of this slice's partial copies outside their copied
#: runs: the names the port adds to the reference's member, or the reason
#: it is rewritten whole
PORT_MEMBERS = {
    "gateway/tcp_runtime.py": {("TcpClusterRuntime", "__init__"): {"device"}},
    "testing/chaos.py": {("ChaosHarness", "__init__"): {"device"}},
    "multiproc/supervisor.py": {
        (None, "worker_cmd"): "adds --device to the spawn line when a device is given",
    },
    "multiproc/runtime.py": {
        ("MultiProcClusterRuntime", "_leader_of"): "the fresh row of the highest term of a "
                                                   "live worker, not the first leader row in "
                                                   "member order",
        ("MultiProcClusterRuntime", "_on_worker_status"): "drops a row of a life that has "
                                                          "ended",
        ("MultiProcClusterRuntime", "_on_worker_restart"): "drops the dead life's last row",
        ("MultiProcClusterRuntime", "submit"): "with no live leader known, waits for one "
                                               "instead of resending to a dead worker",
    },
    "multiproc/worker.py": {
        (None, "main"): "--device to the broker's config; the card guard and start-up "
                        "in place of the CPU pin and the JAX compile cache",
    },
    "standalone.py": {
        (None, "_run_workers_mode"): {"device"},
        (None, "main"): "--device to every shape's brokers; the card guard in place of "
                        "the JAX compile cache",
    },
}
PARTIAL = sorted(PORT_MEMBERS)
NEW_MODULES = ("standalone", "multiproc", "multiproc.runtime", "multiproc.supervisor",
               "multiproc.worker", "gateway.tcp_runtime", "testing.chaos",
               "testing.chaos_tcp", "testing.standalone_run", "utils.external_code")


# ---------------------------------------------------------------------------
# copies


@pytest.mark.parametrize("path", copies.STANDALONE_STACK)
def test_standalone_module_is_a_copy(path):
    assert (PORT / path).read_text() == as_copied((REF / path).read_text())


@pytest.mark.parametrize("path", PARTIAL)
def test_copied_runs_are_the_scripts(path):
    check_copied_runs(path)


@pytest.mark.parametrize("path", PARTIAL)
def test_every_member_is_copied_or_named(path):
    check_members_copied_or_named(path, PORT_MEMBERS[path])


EXTENDED = [(path, scope, name) for path in PARTIAL
            for (scope, name), names in PORT_MEMBERS[path].items() if isinstance(names, set)]


@pytest.mark.parametrize("path,scope,name", EXTENDED,
                         ids=[f"{p}:{s or 'module'}.{n}" for p, s, n in EXTENDED])
def test_member_is_the_references_plus_the_device(path, scope, name):
    check_member_plus_names(path, scope, name, PORT_MEMBERS[path][(scope, name)])


@pytest.mark.parametrize("path", PARTIAL)
def test_imports_are_the_references(path):
    check_imports(path, set())


def test_worker_cmd_is_the_references_spawn_line_plus_the_device():
    from zeebe_tpu.multiproc.supervisor import worker_cmd as ref_cmd
    from zeebe_tpu_torch.multiproc.supervisor import worker_cmd

    args = ("worker-0", "127.0.0.1:1", "worker-0=127.0.0.1:1", "gateway-0", 3, 3)
    ref = ref_cmd(*args, data_dir="/d", management_port=9)
    port = worker_cmd(*args, data_dir="/d", management_port=9)
    assert port == [a.replace("zeebe_tpu.", "zeebe_tpu_torch.") for a in ref]
    assert worker_cmd(*args, device="cpu") == [
        a.replace("zeebe_tpu.", "zeebe_tpu_torch.") for a in ref_cmd(*args)] + ["--device", "cpu"]


def test_copy_script_gives_the_cpu_to_the_tests_processes():
    text = ('def f(tmp):\n'
            '    c = InProcessCluster(broker_count=1)\n'
            '    k = kb.KernelBackend(engine, max_group=64)\n'
            '    h = ChaosHarness(plan, device="cuda")\n'
            '    env = dict(PYTHONPATH="/x/repo")\n'
            '    cmd = [sys.executable, "-m", "zeebe_tpu.standalone", "--port", "1"]\n')
    out = copies.as_test_copy(text, "test_x.py")
    assert 'InProcessCluster(broker_count=1, device="cpu")' in out
    assert 'kb.KernelBackend(engine, max_group=64, device="cpu")' in out
    assert 'ChaosHarness(plan, device="cuda")' in out  # a named device stays
    assert "PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))" in out
    assert '"zeebe_tpu_torch.standalone", "--port", "1", "--device", "cpu"]' in out


_IMPORT_SCRIPT = """
import importlib, json, sys
for name in {modules!r}:
    importlib.import_module("zeebe_tpu_torch." + name)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "zeebe_tpu"))))
"""


def test_new_modules_load_no_jax_or_reference():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_SCRIPT.format(modules=NEW_MODULES)],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


# ---------------------------------------------------------------------------
# the gateway <-> worker protocol on both packages


def _one_task(bpmn):
    return (bpmn.Bpmn.create_executable_process("p").start_event("s")
            .service_task("t", job_type="w").end_event("e").done())


def _loopback_session(side: str, directory: Path) -> list:
    """The reference's ``_LoopbackCluster`` shape (tests/test_multiproc.py)
    with the kernel backend: one worker runtime (2 partitions) and the
    gateway runtime over the loopback network, pumped by a thread. Deploy,
    create one instance on each partition, activate and complete each job;
    every response as (value type, intent, key, masked value)."""
    import importlib

    pkg = lambda name: importlib.import_module(f"{side}.{name}")  # noqa: E731
    bpmn, protocol, intent = pkg("models.bpmn"), pkg("protocol"), pkg("protocol.intent")
    command = pkg("protocol.record").command
    extra = {"device": "cpu"} if side == "zeebe_tpu_torch" else {}
    net = pkg("cluster.messaging").LoopbackNetwork()
    cfg = pkg("broker.broker").BrokerCfg(
        node_id="worker-0", partition_count=2, replication_factor=1,
        cluster_members=["worker-0"], kernel_backend=True, **extra)
    worker = pkg("multiproc.worker").WorkerRuntime(
        "worker-0", net.join("worker-0"), ["gateway-0"], cfg,
        directory=directory, status_interval_ms=50)
    gateway = pkg("multiproc.runtime").MultiProcClusterRuntime(
        "gateway-0", {"worker-0": ("loopback", 0)}, partition_count=2,
        messaging=net.join("gateway-0"))
    running = [True]

    def pump() -> None:
        while running[0]:
            if not worker.pump() + net.deliver_all():
                time.sleep(0.001)

    thread = threading.Thread(target=pump, daemon=True)
    gateway.start()
    thread.start()
    out = []

    def submit(pid: int, record):
        resp = gateway.submit(pid, record, timeout_s=30)
        out.append((resp.value_type.name, int(resp.intent), resp.key, masked(resp.value)))
        return resp

    try:
        gateway.await_leaders(timeout_s=30)
        model = _one_task(bpmn)
        submit(1, command(protocol.ValueType.DEPLOYMENT, intent.DeploymentIntent.CREATE,
                          {"resources": [{"resourceName": "p.bpmn",
                                          "resource": bpmn.to_bpmn_xml(model)}]}))
        for pid in (1, 2):
            deadline = time.monotonic() + 30
            while True:  # the deployment reaches partition 2 by distribution
                created = gateway.submit(pid, command(
                    protocol.ValueType.PROCESS_INSTANCE_CREATION,
                    intent.ProcessInstanceCreationIntent.CREATE,
                    {"bpmnProcessId": "p", "version": -1, "variables": {"x": pid}}),
                    timeout_s=30)
                if created.value.get("processInstanceKey", 0) > 0 or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            out.append((created.value_type.name, int(created.intent), created.key,
                        masked(created.value)))
            deadline = time.monotonic() + 30
            while True:
                jobs = gateway.submit(pid, command(
                    protocol.ValueType.JOB_BATCH, intent.JobBatchIntent.ACTIVATE,
                    {"type": "w", "maxJobsToActivate": 5, "timeout": 60_000,
                     "worker": "t"}), timeout_s=30)
                if jobs.value.get("jobKeys") or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            out.append((jobs.value_type.name, int(jobs.intent), jobs.key, masked(jobs.value)))
            for key in jobs.value["jobKeys"]:
                submit(pid, command(protocol.ValueType.JOB, intent.JobIntent.COMPLETE,
                                    {"variables": {"y": pid}}, key=key))
        # the worker pushes its row every 50 ms from the thread that
        # processes: read one that arrived two intervals after the last reply
        answered_ms = time.time() * 1000.0
        deadline = time.monotonic() + 30
        while gateway._status_seen_ms.get("worker-0", 0.0) < answered_ms + 100.0:
            assert time.monotonic() < deadline, "no status push after the last reply"
            time.sleep(0.01)
        status = gateway.cluster_status()
    finally:
        running[0] = False
        thread.join(timeout=5)
        gateway.stop()
        worker.close()
    coverage = [status["brokers"][0]["partitions"][str(pid)]["kernelCoverage"]["kernelRecords"]
                for pid in (1, 2)]
    return out, coverage


def test_loopback_responses_equal_the_references(tmp_path):
    ref, ref_coverage = _loopback_session("zeebe_tpu", tmp_path / "ref")
    port, port_coverage = _loopback_session("zeebe_tpu_torch", tmp_path / "port")
    assert len(port) == 7  # deploy, and per partition create, activate, complete
    assert all(key > 0 for _, _, key, _ in port[1:])
    assert port == ref
    # the kernel backend took records on both sides, in equal numbers on
    # each partition
    assert port_coverage == ref_coverage and sum(port_coverage) > 0


# ---------------------------------------------------------------------------
# leader routing


def _rows(*rows):
    """A gateway runtime's status table without its network: one (member,
    role of partition 1, its term, seconds since the row arrived) a row."""
    from zeebe_tpu.multiproc.runtime import MultiProcClusterRuntime as Ref
    from zeebe_tpu_torch.multiproc.runtime import MultiProcClusterRuntime as Port

    now_ms = time.time() * 1000.0
    out = []
    for cls in (Ref, Port):
        runtime = object.__new__(cls)
        runtime.worker_members = sorted(member for member, *_ in rows)
        runtime._worker_status = {member: {"partitions": {"1": {"role": role, "term": term}}}
                                  for member, role, term, _ in rows}
        runtime._status_seen_ms = {member: now_ms - 1000.0 * age for member, _, _, age in rows}
        runtime.supervisor = None
        out.append(runtime)
    return out


ROUTING = {
    # a dead leader's last row, then the worker elected after it
    "elected-after-a-dead-first-member": (
        [("worker-0", "leader", 1, 4.0), ("worker-1", "leader", 2, 0.1),
         ("worker-2", "follower", 2, 0.1)], "worker-1", "worker-0"),
    "one-leader": ([("worker-0", "follower", 3, 0.1), ("worker-1", "follower", 3, 0.1),
                    ("worker-2", "leader", 3, 0.1)], "worker-2", "worker-2"),
    "stale-row-of-a-higher-term": (
        [("worker-0", "leader", 5, 16.0), ("worker-1", "leader", 4, 0.1)],
        "worker-1", "worker-1"),
    "a-tie-goes-to-member-order": (
        [("worker-0", "leader", 2, 0.1), ("worker-1", "leader", 2, 0.1)],
        "worker-0", "worker-0"),
    "no-leader": ([("worker-0", "follower", 1, 0.1), ("worker-1", "candidate", 2, 0.1)],
                  None, None),
}


@pytest.mark.parametrize("case", sorted(ROUTING))
def test_leader_of_is_the_fresh_leader_of_the_highest_term(case):
    rows, port_leader, ref_leader = ROUTING[case]
    ref, port = _rows(*rows)
    assert port._leader_of(1) == port_leader
    # the reference takes the first leader row in member order; where one
    # fresh row at most names a leader the two agree
    assert ref._leader_of(1) == ref_leader
    assert port._leader_of(2) is None and ref._leader_of(2) is None


class _Supervisor:
    """The supervisor's view of its workers' processes: worker-i runs as
    pid 100 + i, but the ``dead`` ones."""

    def __init__(self, *dead) -> None:
        self.pids = {f"worker-{i}": (None if f"worker-{i}" in dead else 100 + i)
                     for i in range(3)}

    def pid_of(self, member: str):
        return self.pids.get(member)


def _supervised(port, supervisor):
    """Each row as pushed by the live process of its worker."""
    port.supervisor = supervisor
    for member, status in port._worker_status.items():
        status["workerPid"] = 100 + int(member.split("-")[1])
    return port


def test_a_dead_supervised_worker_leads_nothing():
    """Its fresh row still names it the leader; until the member elected
    after it pushes its row, no member leads (a request waits for the new
    leader instead of going to the dead process)."""
    rows = [("worker-0", "leader", 1, 0.1), ("worker-1", "follower", 1, 0.1),
            ("worker-2", "follower", 1, 0.1)]
    _, port = _rows(*rows)
    _supervised(port, _Supervisor("worker-0"))
    assert port._leader_of(1) is None
    port._worker_status["worker-1"]["partitions"]["1"] = {"role": "leader", "term": 2}
    assert port._leader_of(1) == "worker-1"
    port.supervisor = _Supervisor()
    port._worker_status["worker-1"]["partitions"]["1"] = {"role": "follower", "term": 1}
    assert port._leader_of(1) == "worker-0"
    # a row pushed by an earlier life of the worker: not its live process
    port._worker_status["worker-0"]["workerPid"] = 99
    assert port._leader_of(1) is None


def test_a_restart_drops_the_dead_lifes_row():
    """The restarted worker is alive again, starting; its last life's row
    (leader of partition 1) no longer routes to it."""
    from zeebe_tpu_torch.observability.flight_recorder import FlightRecorder

    _, port = _rows(("worker-0", "leader", 1, 0.1), ("worker-1", "follower", 1, 0.1))
    _supervised(port, _Supervisor())
    port.flight = FlightRecorder("gateway-0", data_dir=None)
    port.partition_count, port.routing_epoch, port._last_leaders = 1, 0, {}
    port._on_worker_restart("worker-0", 1)
    assert "worker-0" not in port._worker_status
    assert port._leader_of(1) is None
    assert port.flight.snapshot()["eventsRecorded"] == 1
    # the dead life's last push, still in flight, does not bring it back;
    # the new life's does
    last = {"partitions": {"1": {"role": "leader", "term": 1}}, "workerPid": 99}
    port._on_worker_status("worker-0", {"status": last})
    assert "worker-0" not in port._worker_status
    port._on_worker_status("worker-0", {"status": {**last, "workerPid": 100}})
    assert port._worker_status["worker-0"]["workerPid"] == 100


class _Net:
    """Messaging that records every send and delivers nothing."""

    def __init__(self) -> None:
        self.sent = []

    def subscribe(self, topic, handler) -> None:
        pass

    def send(self, member, topic, payload) -> None:
        self.sent.append((member, topic, payload))


def test_a_request_to_a_worker_that_died_waits_for_the_next_leader(monkeypatch):
    """The leader dies after the request reached it; the next leader's row
    arrives 1.5 s later. The request goes there as soon as its first
    resend slice (1 s) finds no live leader, without resending to the dead
    worker or waiting out the backoff to its next check (3 s)."""
    from zeebe_tpu_torch.multiproc.runtime import MultiProcClusterRuntime
    from zeebe_tpu_torch.protocol import ValueType, command
    from zeebe_tpu_torch.protocol.intent import ProcessInstanceCreationIntent

    monkeypatch.delenv("ZEEBE_GATEWAY_REQUEST_TIMEOUT_MS", raising=False)
    net, supervisor = _Net(), _Supervisor()
    runtime = MultiProcClusterRuntime(
        "gateway-0", {f"worker-{i}": ("127.0.0.1", 1 + i) for i in range(2)},
        partition_count=1, replication_factor=2, messaging=net, supervisor=supervisor)

    def push(member, role, term):
        runtime._on_worker_status(member, {"status": {
            "partitions": {"1": {"role": role, "term": term}},
            "workerPid": supervisor.pid_of(member)}})

    push("worker-0", "leader", 1)
    push("worker-1", "follower", 1)
    record = command(ValueType.PROCESS_INSTANCE_CREATION, ProcessInstanceCreationIntent.CREATE,
                     {"bpmnProcessId": "p", "version": -1, "variables": {}})
    out = {}

    def submit():
        t0 = time.monotonic()
        out["reply"] = runtime.submit(1, record, timeout_s=10.0, meta=out.setdefault("meta", {}))
        out["seconds"] = time.monotonic() - t0

    thread = threading.Thread(target=submit)
    thread.start()
    while not net.sent:
        time.sleep(0.005)
    supervisor.pids["worker-0"] = None  # SIGKILLed with the request inside
    time.sleep(1.5)
    push("worker-1", "leader", 2)
    deadline = time.monotonic() + 5.0
    while not any(member == "worker-1" for member, _, _ in net.sent):
        assert time.monotonic() < deadline, net.sent
        time.sleep(0.005)
    request_id = net.sent[-1][2]["requestId"]
    runtime._on_worker_response("worker-1", {"requestId": request_id,
                                             "record": record.to_bytes(),
                                             "commandPosition": 7})
    thread.join(timeout=10)
    assert [member for member, _, _ in net.sent] == ["worker-0", "worker-1"]
    assert out["meta"]["worker"] == "worker-1" and out["meta"]["commandPosition"] == 7
    assert 1.4 < out["seconds"] < 2.5


# ---------------------------------------------------------------------------
# no fallback to the CPU


def _free_port() -> int:
    from zeebe_tpu_torch.standalone import _free_ports

    return _free_ports(1)[0]


def _entry_point(kind: str, port: int) -> list[str]:
    if kind == "worker":
        return ["-m", "zeebe_tpu_torch.multiproc.worker", "--node-id", "worker-0",
                "--bind", f"127.0.0.1:{port}", "--gateway", "gateway-0",
                "--contact", f"worker-0=127.0.0.1:{port},gateway-0=127.0.0.1:{_free_port()}"]
    # the standalone's guard runs in main before it picks its shape
    return ["-m", "zeebe_tpu_torch.standalone", "--port", str(port), "--brokers", "1"]


def _run_until_exit(args: list[str], env: dict, port: int, timeout_s: float):
    """Run an entry point; poll ``port`` while it runs. (rc, stderr,
    seconds, whether anything ever accepted a connection on the port)."""
    env = dict(env, PYTHONPATH=str(REPO))
    t0 = time.monotonic()
    proc = subprocess.Popen([sys.executable, *args], cwd=REPO, env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    bound = False
    try:
        while proc.poll() is None and time.monotonic() - t0 < timeout_s:
            with socket.socket() as s:
                s.settimeout(0.05)
                bound |= s.connect_ex(("127.0.0.1", port)) == 0
            time.sleep(0.05)
    finally:
        if proc.poll() is None:
            proc.kill()
        stderr = proc.communicate(timeout=30)[1]
    return proc.returncode, stderr, time.monotonic() - t0, bound


@pytest.mark.parametrize("kind", ["worker", "standalone"])
def test_no_card_no_serving(kind):
    """Here no card answers: the probe's child says ``cpu 1``. Without
    ``--device cpu`` the worker and the standalone exit 2 with that
    verdict, and never bind their port."""
    port = _free_port()
    rc, stderr, _, bound = _run_until_exit(_entry_point(kind, port), dict(os.environ),
                                           port, timeout_s=120)
    assert rc == 2, stderr[-2000:]
    assert "no CUDA card answers the device probe" in stderr
    assert "'answer': ('cpu', 1)" in stderr and "--device cpu" in stderr
    assert not bound


def test_wedged_probe_stops_the_worker_at_its_deadline():
    port = _free_port()
    env = dict(os.environ, ZEEBE_PROBE_TIMEOUT_S="2",
               ZEEBE_PROBE_CMD=f"{sys.executable} -c 'import time; time.sleep(600)'")
    rc, stderr, seconds, bound = _run_until_exit(_entry_point("worker", port), env, port,
                                                 timeout_s=120)
    assert rc == 2, stderr[-2000:]
    assert "'outcome': 'probe-killed'" in stderr and "'killed': True" in stderr
    assert seconds < 2 + 30  # the deadline plus the interpreter's start
    assert not bound


# ---------------------------------------------------------------------------
# serving on the CPU when asked


def _deploy_cmd(bpmn, protocol, intent, model):
    return protocol.command(protocol.ValueType.DEPLOYMENT, intent.DeploymentIntent.CREATE, {
        "resources": [{"resourceName": "p.bpmn", "resource": bpmn.to_bpmn_xml(model)}]})


def test_worker_process_serves_on_the_cpu_when_asked(tmp_path):
    """One real worker process (``--device cpu``, one torch thread) behind
    ``MultiProcClusterRuntime``: 5 instances created and completed (the
    completion exporter wrote their keys), and the partition's row on
    ``/cluster/status`` counts kernel records. Stops the supervisor and
    fails after 90 s."""
    from zeebe_tpu_torch import protocol
    from zeebe_tpu_torch.models import bpmn
    from zeebe_tpu_torch.multiproc import MultiProcClusterRuntime, WorkerSpec, WorkerSupervisor
    from zeebe_tpu_torch.multiproc.supervisor import worker_cmd
    from zeebe_tpu_torch.protocol import intent
    from zeebe_tpu_torch.standalone import _free_ports

    deadline = time.monotonic() + 90.0
    worker_port, gateway_port = _free_ports(2)
    contacts = {"worker-0": ("127.0.0.1", worker_port), "gateway-0": ("127.0.0.1", gateway_port)}
    contact = ",".join(f"{m}={h}:{p}" for m, (h, p) in sorted(contacts.items()))
    data_dir = tmp_path / "worker-0"
    spec = WorkerSpec(
        node_id="worker-0",
        cmd=worker_cmd("worker-0", f"127.0.0.1:{worker_port}", contact, "gateway-0", 1, 1,
                       data_dir=str(data_dir), device="cpu"),
        data_dir=str(data_dir),
        extra_env={"OMP_NUM_THREADS": "1", **S.completion_env(tmp_path / "completed")})
    runtime = MultiProcClusterRuntime(
        "gateway-0", {"worker-0": contacts["worker-0"]}, partition_count=1,
        bind=contacts["gateway-0"], supervisor=WorkerSupervisor([spec], restart_backoff_s=0.2))
    watchdog = threading.Timer(90.0, runtime.stop)
    left = lambda: max(deadline - time.monotonic(), 0.1)  # noqa: E731
    try:
        watchdog.start()
        runtime.start()
        runtime.await_leaders(timeout_s=left())
        runtime.submit(1, _deploy_cmd(bpmn, protocol, intent, _one_task(bpmn)), timeout_s=left())
        created = [runtime.submit(1, protocol.command(
            protocol.ValueType.PROCESS_INSTANCE_CREATION,
            intent.ProcessInstanceCreationIntent.CREATE,
            {"bpmnProcessId": "p", "version": -1, "variables": {"x": i}}),
            timeout_s=left()).value["processInstanceKey"] for i in range(5)]
        completed_jobs = 0
        while completed_jobs < 5 and time.monotonic() < deadline:
            jobs = runtime.submit(1, protocol.command(
                protocol.ValueType.JOB_BATCH, intent.JobBatchIntent.ACTIVATE,
                {"type": "w", "maxJobsToActivate": 5, "timeout": 60_000, "worker": "t"}),
                timeout_s=left())
            for key in jobs.value.get("jobKeys", []):
                runtime.submit(1, protocol.command(protocol.ValueType.JOB,
                                                   intent.JobIntent.COMPLETE,
                                                   {"variables": {}}, key=key), timeout_s=left())
                completed_jobs += 1
        while not set(created) <= S.completed_keys(tmp_path / "completed"):
            assert time.monotonic() < deadline, "the instances did not complete in 90 s"
            time.sleep(0.1)
        while True:  # the status push after the last completion
            row = runtime.cluster_status()["brokers"][0]["partitions"]["1"]
            if row.get("kernelCoverage", {}).get("kernelRecords", 0) >= 5:
                break
            assert time.monotonic() < deadline, f"no kernel records on /cluster/status: {row}"
            time.sleep(0.1)
        pid = runtime.supervisor.pid_of("worker-0")
    finally:
        watchdog.cancel()
        runtime.stop()
    assert pid != os.getpid() and S.cmdline(pid) == []  # stopped with the runtime
    assert "device cpu" in (data_dir / "worker.log").read_text()


def test_in_process_standalone_serves_a_client_on_the_cpu_when_asked(tmp_path):
    from zeebe_tpu_torch.client import ZeebeTpuClient
    from zeebe_tpu_torch.models import bpmn
    from zeebe_tpu_torch.standalone import _free_ports

    grpc_port, management = _free_ports(2)
    proc = S.StandaloneProcess(
        ["--brokers", "1", "--port", str(grpc_port), "--management-port", str(management),
         "--device", "cpu"], tmp_path / "standalone",
        env=dict(os.environ, OMP_NUM_THREADS="1", **S.completion_env(tmp_path / "completed")))
    client = None
    try:
        proc.start()
        deadline = time.monotonic() + 60.0
        while "gateway listening" not in proc.log():
            assert proc.exited() is None and time.monotonic() < deadline, proc.log()
            time.sleep(0.1)
        client = ZeebeTpuClient(f"127.0.0.1:{grpc_port}", credentials_provider=False)
        client.deploy_resource(("p.bpmn", bpmn.to_bpmn_xml(_one_task(bpmn))))
        key = client.create_instance("p").process_instance_key
        jobs = client.activate_jobs("w", max_jobs=1, timeout_ms=60_000)
        client.complete_job(jobs[0].key, {})
        while key not in S.completed_keys(tmp_path / "completed"):
            assert time.monotonic() < deadline, "the instance did not complete"
            time.sleep(0.1)
        row = proc.get(management, "/cluster/status")["brokers"][0]["partitions"]["1"]
        assert row["kernelCoverage"]["kernelRecords"] > 0, row
        client.close()
        client = None
        assert proc.stop() == 0, proc.log()
    finally:
        if client is not None:
            client.close()
        survivors = proc.kill()
    assert survivors == []
    logs = S.replica_logs(tmp_path / "standalone")
    records = S.merged_log(logs[1]).values()
    assert any(S.is_process_completion(r) and r.key == key for r in records)
