"""Runs replicated broker clusters on both packages and holds every replica
log of the port's cluster to the reference's.

Helpers for the ``tests/test_torch_cluster*.py`` files (not collected
itself). Both packages run in this one process: Raft seeds its election
jitter with ``hash((member_id, partition_id))``, and string hashes differ
between processes, so the two clusters elect the same leaders only here.

A broker built while a run is recorded (``recording``) keeps, at its first
close, every partition replica's log: the materialized record stream
(position, source position, processed flag, record bytes), the stream
journal's entries and the Raft journal's entries, and the counters of the
partition's kernel backend when it leads. The port's brokers get
``device="cpu"`` (the plain PyTorch version), which the flows never pass.

- ``check_flow``: a test method of ``tests/test_broker_cluster.py`` run on
  the reference, on the port, and on the port with ``kernel_backend=False``
  (the sequential engine; the file's asserts reduced to expressions); every
  broker's record equal to the reference's, backend counters included, and
  the sequential logs equal too.
- ``check_seed``: one graph of ``tests/test_randomized_parity.py``'s
  generator on a 3-broker, 3-partition, replication-factor-3 cluster
  (``drive_seed``): the port's logs and counters against the reference's,
  each partition's three replicas byte-identical, and on every third seed
  the port's sequential logs against its kernel's.
"""

from __future__ import annotations

import ast
import contextlib
import importlib
import random
import time
from pathlib import Path

import pytest
import torch

from torch_kernel_flows import counters, flow_module, flows

REF, PORT = "zeebe_tpu", "zeebe_tpu_torch"
TESTS = Path(__file__).resolve().parent

# the plain version's tensors here are small: torch's intra-op thread pool
# only adds contention with the other test workers
torch.set_num_threads(1)


def replica_log(partition) -> dict:
    """One partition replica's logs and, on a leader, its backend's counters."""
    records = [(v.position, v.source_position, v.processed, v.record.to_bytes())
               for v in partition.stream.new_reader(1)]
    stream = [(e.index, e.asqn, bytes(e.data)) for e in partition.stream_journal.read_from(1)]
    raft = [(e.index, e.asqn, bytes(e.data)) for e in partition.raft.journal.read_from(1)]
    processor = partition.processor
    backend = processor.kernel_backend if processor is not None else None
    return {"records": records, "stream": stream, "raft": raft,
            "leader": partition.is_leader, "counters": counters(backend)}


@contextlib.contextmanager
def recording(side: str, kernel_backend: bool = True, capture: bool = True,
              planes: bool = True):
    """Within: every ``Broker`` the package builds records its replicas'
    logs at its first close into the yielded list ((node id, {partition id:
    log}) in build order; without ``capture`` only the brokers); on the port
    every broker is on the CPU, and with ``kernel_backend=False`` runs its
    partitions on the sequential engine. Without ``planes`` every broker,
    on either side, runs without its metrics sampler (and so without the
    control plane, which reads it) and its stack profiler: both sample the
    process-wide registry and threads, the bulk of a long run's CPU here.
    On the reference, Raft takes the port's differences for the run: a
    member whose election timer fires drops its leader before its pre-vote,
    and a member that denies a vote it could win itself brings its timer
    forward (``zeebe_tpu_torch/cluster/raft.py``), so both sides elect alike
    after a leader's death."""
    broker_mod = importlib.import_module(f"{side}.broker.broker")
    raft_mod = importlib.import_module(f"{side}.cluster.raft")
    made: list = []
    start_prevote = raft_mod.RaftNode._start_prevote
    on_vote_request = raft_mod.RaftNode._on_vote_request

    def prevote_dropping_the_leader(self) -> None:
        # the port's _start_prevote: the leader is dropped where the
        # reference goes on to its pre-vote
        if ((self._election_safe() or self._last_resort_due())
                and self.role != raft_mod.RaftRole.CANDIDATE):
            self.leader_id = None
        start_prevote(self)

    def vote_request_bringing_the_timer_forward(self, sender: str, req: dict) -> None:
        # the port's _on_vote_request: the reference's answer, then the
        # timer of a member that can win where the requester cannot
        on_vote_request(self, sender, req)
        if sender not in self.members or not self._election_safe():
            return
        ours = (self._last_log_term(), self._last_log_index())
        theirs = (req["lastLogTerm"], req["lastLogIndex"])
        if req.get("prevote"):
            if (self.role == raft_mod.RaftRole.FOLLOWER and self.leader_id is None
                    and theirs < ours):
                self._election_deadline_ms = self.clock_millis()
        elif (self.role == raft_mod.RaftRole.CANDIDATE and req["term"] == self.current_term
                and self.voted_for == self.member_id
                and (ours > theirs or (ours == theirs and self.member_id < req["candidate"]))):
            self._election_deadline_ms = self.clock_millis()

    class Recording(broker_mod.Broker):
        def __init__(self, cfg, *args, **kwargs) -> None:
            if not planes:
                cfg.metrics_sampling_ms = 0
                cfg.profiling_hz = 0.0
            if side == PORT:
                cfg.kernel_backend = kernel_backend and cfg.kernel_backend
                if cfg.device is None:
                    cfg.device = "cpu"
            self.record = None
            super().__init__(cfg, *args, **kwargs)
            made.append(self)

        def close(self) -> None:
            if capture and self.record is None:
                self.record = (self.cfg.node_id, {pid: replica_log(p) for pid, p
                                                  in sorted(self.partitions.items())})
            super().close()

    saved = broker_mod.Broker
    broker_mod.Broker = Recording
    if side == REF:
        raft_mod.RaftNode._start_prevote = prevote_dropping_the_leader
        raft_mod.RaftNode._on_vote_request = vote_request_bringing_the_timer_forward
    try:
        yield made
    finally:
        broker_mod.Broker = saved
        raft_mod.RaftNode._start_prevote = start_prevote
        raft_mod.RaftNode._on_vote_request = on_vote_request


def _records(made: list) -> list:
    missing = [b.cfg.node_id for b in made if b.record is None]
    assert not missing, f"brokers never closed: {missing}"
    return [b.record for b in made]


def assert_records_equal(a: list, b: list, what: str, counters_too: bool = True) -> int:
    """Broker by broker, replica by replica: every log equal (and the
    leaders' backend counters). Returns the records compared."""
    assert [n for n, _ in a] == [n for n, _ in b], f"{what}: brokers differ"
    compared = 0
    for (node, x), (_, y) in zip(a, b):
        assert sorted(x) == sorted(y), f"{what}: {node} hosts other partitions"
        for pid in x:
            for key in ("records", "stream", "raft"):
                for j, (rx, ry) in enumerate(zip(x[pid][key], y[pid][key])):
                    assert rx == ry, f"{what}: {node} partition {pid} {key} differs at {j}"
                assert len(x[pid][key]) == len(y[pid][key]), \
                    f"{what}: {node} partition {pid} {key} lengths differ"
            assert x[pid]["leader"] == y[pid]["leader"], f"{what}: {node} partition {pid} role"
            if counters_too:
                assert x[pid]["counters"] == y[pid]["counters"], \
                    f"{what}: {node} partition {pid} backend counters"
            compared += len(x[pid]["records"])
    return compared


def assert_replicas_identical(records: list, what: str) -> None:
    """Each partition's record stream and journals equal on every replica."""
    by_partition: dict[int, list] = {}
    for node, logs in records:
        for pid, log in logs.items():
            by_partition.setdefault(pid, []).append((node, log))
    for pid, replicas in by_partition.items():
        node0, first = replicas[0]
        for node, log in replicas[1:]:
            for key in ("records", "stream", "raft"):
                assert log[key] == first[key], \
                    f"{what}: partition {pid} {key} differs between {node0} and {node}"


# ---------------------------------------------------------------------------
# the flows of tests/test_broker_cluster.py

#: every test method that builds a cluster (the partition distribution's
#: two are pure functions)
FLOWS = flows("test_broker_cluster", only=lambda src: "cluster" in src.split("\n")[0]
              or "InProcessCluster(" in src)


def _fixture(cls, name: str):
    """The undecorated generator function of a class-scoped fixture."""
    fixture = cls.__dict__[name]
    return getattr(fixture, "__wrapped__", fixture)


def call_test(module, cls_name: str | None, method: str, fixtures: tuple, root: Path,
              params: dict | None = None) -> None:
    """Run one test function (``cls_name`` None) or method of ``module`` with
    its fixtures: ``tmp_path`` (``root``), ``monkeypatch``, a fixture of the
    test's class, or a parametrized argument from ``params``."""
    owner = module if cls_name is None else getattr(module, cls_name)()
    monkeypatch = pytest.MonkeyPatch()
    teardowns = []
    try:
        args = []
        for fixture in fixtures:
            if params and fixture in params:
                args.append(params[fixture])
            elif fixture == "tmp_path":
                root.mkdir(parents=True, exist_ok=True)
                args.append(root)
            elif fixture == "monkeypatch":
                args.append(monkeypatch)
            else:
                gen = _fixture(type(owner), fixture)(owner)
                args.append(next(gen))
                teardowns.append(gen)
        getattr(owner, method)(*args)
    finally:
        for gen in reversed(teardowns):
            next(gen, None)
        monkeypatch.undo()


def run_flow(side: str, flow: tuple, root: Path, kernel_backend: bool = True) -> list:
    """One flow on one side: every broker's record, in build order."""
    name, cls_name, method, fixtures = flow
    module = flow_module(name, side if kernel_backend else "sequential")
    with recording(side, kernel_backend) as made:
        call_test(module, cls_name, method, fixtures, root)
    return _records(made)


def check_flow(flow: tuple, root: Path) -> int:
    ref = run_flow(REF, flow, root / "reference")
    port = run_flow(PORT, flow, root / "port")
    seq = run_flow(PORT, flow, root / "sequential", kernel_backend=False)
    what = f"{flow[1]}::{flow[2]}"
    compared = assert_records_equal(ref, port, f"{what} (port against reference)")
    assert_records_equal(port, seq, f"{what} (kernel against sequential)", counters_too=False)
    return compared


# ---------------------------------------------------------------------------
# the random process generator on a replicated cluster

PARTITIONS = 3
#: the clock step of a seed run's pumps: one Raft heartbeat interval, so a
#: wait of n ms pumps the cluster n / 250 times (and drains each step)
STEP = 500


def _write_all(side: str, cluster, commands: list) -> None:
    """Write (partition id, record) pairs in order through each leader's
    client ingress, running the cluster while the limiter refuses or a
    partition has no leader."""
    BackpressureExceeded = importlib.import_module(
        f"{side}.broker.partition").BackpressureExceeded
    for pid, record in commands:
        for _ in range(200):
            broker = cluster.leader_broker(pid)
            try:
                if broker is not None and broker.write_command(pid, record) is not None:
                    break
            except BackpressureExceeded:
                pass
            cluster.run(STEP, STEP)
        else:
            raise AssertionError(f"partition {pid} refused a command for 10 s")


def _activate(side: str, cluster, job_type: str, max_jobs: int, cursors: dict) -> list:
    """One JOB_BATCH ACTIVATE on every partition leader: the (partition id,
    job key) of every job activated, read from the leaders' logs."""
    proto = importlib.import_module(f"{side}.protocol")
    intent = importlib.import_module(f"{side}.protocol.intent")
    _write_all(side, cluster, [(pid, proto.command(
        proto.ValueType.JOB_BATCH, intent.JobBatchIntent.ACTIVATE,
        {"type": job_type, "worker": "w", "timeout": 300_000, "maxJobsToActivate": max_jobs}))
        for pid in range(1, PARTITIONS + 1)])
    cluster.run(300, STEP)
    jobs = []
    for pid in range(1, PARTITIONS + 1):
        leader = cluster.leader(pid)
        for logged in leader.stream.new_reader(cursors.get(pid, 0) + 1):
            cursors[pid] = logged.position
            rec = logged.record
            if (rec.value_type == proto.ValueType.JOB_BATCH
                    and rec.intent == intent.JobBatchIntent.ACTIVATED
                    and rec.value["type"] == job_type):
                jobs += [(pid, key) for key in rec.value["jobKeys"]]
    return jobs


def drive_seed(side: str, seed: int, root: Path, kernel_backend: bool = True) -> list:
    """Seed ``seed`` of the generator on a 3-broker, 3-partition,
    replication-factor-3 cluster: the graph deployed on partition 1 (and
    distributed), 1–3 instances on each partition, then rounds of job
    activation and completion on every partition, signal broadcasts,
    message publications and timer advances until two rounds find no job.
    The brokers run without their metrics and profiling planes (the flows
    and the runtime keep them). Every broker's record, in build order."""
    module = flow_module("test_randomized_parity", side)
    broker_mod = importlib.import_module(f"{side}.broker.broker")
    partitioning = importlib.import_module(f"{side}.parallel.partitioning")
    proto = importlib.import_module(f"{side}.protocol")
    intent = importlib.import_module(f"{side}.protocol.intent")
    bpmn = importlib.import_module(f"{side}.models.bpmn")
    command, VT = proto.command, proto.ValueType
    gen_rng = random.Random(seed)
    gen = module._Gen(gen_rng, f"rand_{seed}")
    model = gen.build()
    instances = gen_rng.randint(1, 3) * PARTITIONS
    constant_vars = seed % 4 == 0
    rng = random.Random(seed + 1)
    with recording(side, kernel_backend, planes=False) as made:
        cluster = broker_mod.InProcessCluster(broker_count=3, partition_count=PARTITIONS,
                                              replication_factor=3, directory=root)
        try:
            cluster.await_leaders()
            _write_all(side, cluster, [(1, command(VT.DEPLOYMENT, intent.DeploymentIntent.CREATE, {
                "resources": [{"resourceName": f"{gen.pid}.bpmn",
                               "resource": bpmn.to_bpmn_xml(model)}]}))])
            cluster.run(2_000, STEP)
            creates = []
            for i in range(instances):
                variables = module._random_vars(rng, constant_vars)
                if gen.messages:
                    variables["mkey"] = f"ck{i}"
                creates.append((i % PARTITIONS + 1, command(
                    VT.PROCESS_INSTANCE_CREATION, intent.ProcessInstanceCreationIntent.CREATE,
                    {"bpmnProcessId": gen.pid, "version": -1, "variables": variables})))
            _write_all(side, cluster, creates)
            cluster.run(1_000, STEP)
            cursors: dict = {}
            idle_rounds = 0
            for _ in range(64):
                worked = 0
                for job_type in sorted(gen.job_types_used):
                    completions = []
                    for pid, key in _activate(side, cluster, job_type, 50, cursors):
                        variables = {}
                        if key % 3 == 0:
                            variables[module.VAR_NAMES[key % len(module.VAR_NAMES)]] = key % 23
                        completions.append((pid, command(
                            VT.JOB, intent.JobIntent.COMPLETE, {"variables": variables}, key=key)))
                    _write_all(side, cluster, completions)
                    cluster.run(500, STEP)
                    worked += len(completions)
                for _ in range(3):
                    for name in sorted(gen.signals):
                        _write_all(side, cluster, [(1, command(
                            VT.SIGNAL, intent.SignalIntent.BROADCAST,
                            {"signalName": name, "variables": {}}))])
                        cluster.run(300, STEP)
                for name in sorted(gen.messages):
                    _write_all(side, cluster, [(partitioning.subscription_partition_id(
                        f"ck{i}", PARTITIONS), command(VT.MESSAGE, intent.MessageIntent.PUBLISH, {
                            "name": name, "correlationKey": f"ck{i}", "timeToLive": 3_600_000,
                            "messageId": f"{name}-ck{i}", "variables": {}}))
                        for i in range(instances)])
                    cluster.run(500, STEP)
                if gen.has_timers:
                    cluster.run(6_000, STEP)
                idle_rounds = idle_rounds + 1 if worked == 0 else 0
                if idle_rounds >= 2:
                    break
            else:
                raise AssertionError(f"seed {seed}: the job rounds did not quiesce")
            cluster.run(1_000, STEP)
        finally:
            cluster.close()
    return _records(made)


def check_seed(seed: int, root: Path) -> int:
    """The seed on the reference and the port: logs and counters equal,
    replicas identical; every third seed also on the port's sequential
    engine, whose logs must equal the kernel's. Returns the commands the
    port's kernel backends admitted."""
    ref = drive_seed(REF, seed, root / "reference")
    port = drive_seed(PORT, seed, root / "port")
    assert_records_equal(ref, port, f"seed {seed} (port against reference)")
    assert_replicas_identical(port, f"seed {seed}")
    if seed % 3 == 0:
        seq = drive_seed(PORT, seed, root / "sequential", kernel_backend=False)
        assert_records_equal(port, seq, f"seed {seed} (kernel against sequential)",
                             counters_too=False)
    return sum(log["counters"]["commands"] for _, logs in port for log in logs.values()
               if log["counters"] is not None)


# ---------------------------------------------------------------------------
# the gateway's in-process runtime


def _timeless(value):
    """A response value without its wall-clock fields (a job's deadline):
    the runtime's brokers run on the host clock."""
    if isinstance(value, dict):
        return {k: _timeless(v) for k, v in value.items() if k != "deadline"}
    if isinstance(value, list):
        return [_timeless(v) for v in value]
    return value


def _deployed(runtime, pid: int, process_id: str) -> bool:
    """Whether partition ``pid``'s leader has ``process_id`` deployed (read
    under the partition's ownership lock)."""
    with runtime._plocks[pid]:
        leader = runtime._leader_partition(pid)
        if leader is None or leader.db is None:
            return False
        with leader.db.transaction():
            return leader.engine.state.processes.latest_version(process_id) is not None


def drive_runtime(side: str, n_instances: int = 12, kernel_mesh_shards: int = 3) -> dict:
    """``ClusterRuntime`` (3 brokers, 3 partitions, replication factor 3, one
    mesh runner of ``kernel_mesh_shards`` shards) with its partition threads
    started: one_task deployed on partition 1 and awaited on every
    partition, ``n_instances`` creations round robin, then activations and
    completions on every partition until no job is left, each request
    awaited before the next. Returns every response (record type, value
    type, intent, rejection, key and value) and, per partition leader, the
    key count of each column family and whether any instance is live."""
    runtime_mod = importlib.import_module(f"{side}.gateway.broker_client")
    proto = importlib.import_module(f"{side}.protocol")
    intent = importlib.import_module(f"{side}.protocol.intent")
    bpmn = importlib.import_module(f"{side}.models.bpmn")
    command, VT = proto.command, proto.ValueType
    kwargs = {"device": "cpu"} if side == PORT else {}
    runtime = runtime_mod.ClusterRuntime(broker_count=3, partition_count=PARTITIONS,
                                         replication_factor=3,
                                         kernel_mesh_shards=kernel_mesh_shards, **kwargs)
    responses = []

    def submit(pid: int, record):
        response = runtime.submit(pid, record, timeout_s=30.0)
        responses.append((response.record_type.name, response.value_type.name,
                          int(response.intent), response.rejection_type.name, response.key,
                          _timeless(dict(response.value))))
        return response

    try:
        runtime.start()
        model = (bpmn.Bpmn.create_executable_process("p").start_event("s")
                 .service_task("t", job_type="w").end_event("e").done())
        submit(1, command(VT.DEPLOYMENT, intent.DeploymentIntent.CREATE, {
            "resources": [{"resourceName": "p.bpmn", "resource": bpmn.to_bpmn_xml(model)}]}))
        deadline = time.monotonic() + 30.0
        while not all(_deployed(runtime, pid, "p") for pid in range(1, PARTITIONS + 1)):
            if time.monotonic() > deadline:
                raise AssertionError("the deployment did not reach every partition")
            time.sleep(0.01)
        for i in range(n_instances):
            submit(i % PARTITIONS + 1, command(
                VT.PROCESS_INSTANCE_CREATION, intent.ProcessInstanceCreationIntent.CREATE,
                {"bpmnProcessId": "p", "version": -1, "variables": {"x": i}}))
        while True:
            jobs = []
            for pid in range(1, PARTITIONS + 1):
                batch = submit(pid, command(VT.JOB_BATCH, intent.JobBatchIntent.ACTIVATE, {
                    "type": "w", "worker": "w", "timeout": 300_000,
                    "maxJobsToActivate": 1000}))
                jobs += [(pid, key) for key in batch.value["jobKeys"]]
            if not jobs:
                break
            for pid, key in jobs:
                submit(pid, command(VT.JOB, intent.JobIntent.COMPLETE, {"variables": {}},
                                    key=key))
        state = {}
        for pid in range(1, PARTITIONS + 1):
            leader = runtime._leader_partition(pid)
            with runtime._plocks[pid]:
                with leader.db.transaction():
                    live = bool(list(leader.engine.state.element_instances._instances.items(())))
                state[pid] = {"cf": leader.db.key_counts_by_cf(), "live": live}
        mesh = runtime.mesh_runner
        return {"responses": responses, "state": state,
                "mesh": None if mesh is None else (mesh.dispatches, mesh.groups_dispatched)}
    finally:
        runtime.stop()


# ---------------------------------------------------------------------------
# a reference test file's tests, run on the port


def reference_tests(name: str, only=None, skip=()) -> list[tuple]:
    """(file, class or None, test, fixtures, parameters) of every test of
    ``tests/<name>.py``, one entry per parametrized case; ``only`` keeps the
    tests whose name it passes, ``skip`` drops tests or whole classes by
    name."""
    module = flow_module(name, PORT)
    text = (TESTS / f"{name}.py").read_text()
    out = []

    def add(cls_name, fn_node, fn):
        if fn_node.name in skip or (only is not None and not only(fn_node.name)):
            return
        argnames = [a.arg for a in fn_node.args.args if a.arg != "self"]
        cases = [{}]
        for mark in getattr(fn, "pytestmark", []):
            if mark.name != "parametrize":
                continue
            keys = [k.strip() for k in mark.args[0].split(",")]
            cases = [{**case, **dict(zip(keys, v if len(keys) > 1 else (v,)))}
                     for case in cases for v in mark.args[1]]
        for case in cases:
            out.append((name, cls_name, fn_node.name, tuple(argnames), case))

    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith("test_"):
            add(None, node, getattr(module, node.name))
        elif (isinstance(node, ast.ClassDef) and node.name.startswith("Test")
              and node.name not in skip):
            for fn in node.body:
                if isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_"):
                    add(node.name, fn, getattr(getattr(module, node.name), fn.name))
    return out


def case_id(case: tuple) -> str:
    name, cls_name, method, _, params = case
    label = "::".join(p for p in (name, cls_name, method) if p)
    return label + (f"[{','.join(str(v) for v in params.values())}]" if params else "")


def run_on_the_port(case: tuple, root: Path) -> None:
    """One reference test, its imports renamed to the port, every broker it
    builds on the CPU."""
    name, cls_name, method, fixtures, params = case
    with recording(PORT, capture=False):
        call_test(flow_module(name, PORT), cls_name, method, fixtures, root, params)
