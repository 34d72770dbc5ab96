"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (the kernels have no CPU mode) and skips
without one. On a machine with a card, run them with

    pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest pins JAX, which the card's machine
does not have; these tests import neither JAX nor the JAX package.) Packed
rows, states and events must be byte-equal: the tolerance is zero.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from zeebe_tpu_torch.dmn import parse_dmn_xml
from zeebe_tpu_torch.engine import kernel_backend as kb
from zeebe_tpu_torch.engine.device_health import (
    HEALTHY,
    SUSPECT,
    reset_shared_device_health,
    shared_device_health,
)
from zeebe_tpu_torch.ops import decision as D
from zeebe_tpu_torch.models.bpmn import Bpmn, transform
from zeebe_tpu_torch.ops import automaton as A
from zeebe_tpu_torch.ops import kernels
from zeebe_tpu_torch.ops.tables import K_TASK, KernelConfig, compile_tables
from zeebe_tpu_torch.parallel import mesh as M
from zeebe_tpu_torch.parallel import mesh_runner as MR
from zeebe_tpu_torch.testing import random_graphs as RG
from zeebe_tpu_torch.testing import workloads as W
from zeebe_tpu_torch.testing.catalog import ProcessCatalog
from zeebe_tpu_torch.testing.chaos_device import DeviceChaosController, DeviceFaultPlan

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _nomatch():
    return (Bpmn.create_executable_process("nomatch").start_event("s")
            .exclusive_gateway("gw").condition_expression("x > 10")
            .end_event("e").done())


def _inclusive():
    return (Bpmn.create_executable_process("incl").start_event("s")
            .inclusive_gateway("gw").condition_expression("x > 5")
            .service_task("a", job_type="a").end_event("ea")
            .move_to_element("gw").condition_expression("x > 20")
            .service_task("b", job_type="b").end_event("eb")
            .move_to_element("gw").default_flow()
            .end_event("ec").done())


WORKLOADS = {
    "one_task": lambda: [W.one_task()],
    "exclusive_chain": lambda: [W.exclusive_chain()],
    "fork_join": lambda: [W.fork_join()],
    "subprocess_boundary": lambda: [W.subprocess_boundary()],
    "mixed": W.mixed_definitions,
    "nomatch": lambda: [_nomatch()],
    "inclusive": lambda: [_inclusive()],
}

# (workload, instances, token capacity or None for the group rule)
CASES = [
    ("one_task", 64, None),
    ("exclusive_chain", 64, None),
    ("fork_join", 64, None),
    ("subprocess_boundary", 64, None),
    ("mixed", 64, None),
    ("mixed", 2048, None),
    ("nomatch", 64, None),
    ("inclusive", 64, None),
    ("fork_join", 64, 64),  # token pool too small: overflow
]


def _mi_tables(sequential: bool) -> dict:
    """A multi-instance body table set in the layout the reference's MI
    inlining produces: process, start, K_MI body (inner row 4), end, and the
    inner job-worker task inside the body's scope."""
    D, E, FO = 1, 5, 1
    t = {
        "kernel_op": np.array([[0, 1, 10, 6, 2]], np.int32),
        "in_count": np.array([[0, 0, 1, 1, 1]], np.int32),
        "job_type": np.array([[-1, -1, -1, -1, 0]], np.int32),
        "out_count": np.array([[0, 1, 1, 0, 0]], np.int32),
        "out_target": np.array([[[-1], [2], [3], [-1], [-1]]], np.int32),
        "out_cond": np.full((D, E, FO), -1, np.int32),
        "out_flow_idx": np.array([[[-1], [0], [1], [-1], [-1]]], np.int32),
        "default_slot": np.full((D, E), -1, np.int32),
        "start_elem": np.array([1], np.int32),
        "scope_start": np.array([[-1, -1, 4, -1, -1]], np.int32),
        "in_scope": np.zeros((D, E, E), np.int8),
        "cond_ops": np.zeros((1, 24), np.int32),
        "cond_args": np.zeros((1, 24, 2), np.int32),
        "mi_sequential": np.array([[0, 0, 1 if sequential else 0, 0, 0]], np.int8),
    }
    t["in_scope"][0, 4, 2] = 1
    return t


def _setup(name: str, I: int, T: int | None, seed: int, device):
    tables = compile_tables([transform(m) for m in WORKLOADS[name]()])
    rng = np.random.default_rng(seed)
    def_of = rng.integers(0, tables.num_definitions, I).astype(np.int32)
    slots = rng.integers(-5, 40, (I, tables.num_slots)).astype(np.float64)
    if T is None:
        width = tables.token_width
        T = kb._pow2(width * I if width > 0 else 4 * I)
    state = A.make_state(tables, I, def_of, initial_slots=slots, token_capacity=T,
                         device=device)
    return tables, A.DeviceTables.from_numpy(tables, device), state


def _assert_state_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x, y), f"state[{k!r}] differs at {(x != y).nonzero()[:5].tolist()}"


def _waiting(kernel_op: np.ndarray, state: dict) -> np.ndarray:
    """Slots of tokens parked at a job-worker task (what a worker completes)."""
    phase = state["phase"].cpu().numpy()
    elem = state["elem"].cpu().numpy()
    op = kernel_op[state["def_of"].cpu().numpy()[state["inst"].cpu().numpy()],
                             np.maximum(elem, 0)]
    return np.flatnonzero((phase == A.PHASE_WAIT) & (elem >= 0) & (op == K_TASK))


def test_kernels_build(cuda):
    path = kernels.build(verbose=True)
    assert path.exists()
    kernels.load()


def _collect(path):
    """run_collect by the shape rule (None: the public wrapper) or forced
    onto one path."""
    if path is None:
        return A.run_collect
    return lambda dt, state, n_steps, config: kernels.run_steps(
        dt, state, n_steps, config, auto_jobs=False, emit_events=True, mode="collect",
        path=path)


@pytest.mark.parametrize("path", [None, "chain"])
@pytest.mark.parametrize("name,I,T", CASES)
def test_run_collect_waves_match_plain(cuda, name, I, T, path):
    """Chunk by chunk with job waves against the plain version; every case
    takes the fused chunk by the shape rule (None) or is forced onto the
    chain."""
    tables, dt, state = _setup(name, I, T, seed=7, device=cuda)
    config = tables.kernel_config
    collect = _collect(path)
    ks, ps = state, state
    for _ in range(12):
        ks, krows = collect(dt, ks, n_steps=8, config=config)
        ps, prows = A.run_collect_plain(dt, ps, n_steps=8, config=config)
        assert torch.equal(krows.cpu(), prows.cpu())
        _assert_state_equal(ks, ps)
        jobs = _waiting(tables.kernel_op, ks)
        if jobs.size:
            ks, ps = A.complete_jobs(ks, jobs), A.complete_jobs(ps, jobs)
    if T == I and name == "fork_join":
        assert bool(ks["overflow"])


@pytest.mark.parametrize("name,I,T", CASES)
def test_run_to_completion_matches_plain(cuda, name, I, T):
    """The public wrapper: one launch of the grid kernel per call."""
    tables, dt, state = _setup(name, I, T, seed=11, device=cuda)
    A.reset_launch_counts()
    ks, ksteps = A.run_to_completion(dt, state, max_steps=100, config=tables.kernel_config)
    assert A.grid_launch_counts() == {"fused": 0, "chain": 0, "combine": 0, "grid": 1}
    ps, psteps = A.run_to_completion_plain(dt, state, max_steps=100,
                                           config=tables.kernel_config)
    _assert_state_equal(ks, ps)
    assert int(ksteps) == int(psteps)


@pytest.mark.parametrize("auto_jobs", [True, False])
@pytest.mark.parametrize("name", ["fork_join", "mixed", "subprocess_boundary", "nomatch"])
def test_step_events_match_plain(cuda, name, auto_jobs):
    tables, dt, state = _setup(name, 64, None, seed=3, device=cuda)
    ks = ps = state
    for _ in range(10):
        ks, kev = A.step(dt, ks, auto_jobs=auto_jobs, emit_events=True,
                         config=tables.kernel_config)
        ps, pev = A.step_plain(dt, ps, auto_jobs=auto_jobs, emit_events=True,
                               config=tables.kernel_config)
        _assert_state_equal(ks, ps)
        _assert_state_equal(kev, pev)
        if not auto_jobs:
            jobs = _waiting(tables.kernel_op, ks)
            ks, ps = A.complete_jobs(ks, jobs), A.complete_jobs(ps, jobs)


@pytest.mark.parametrize("path", [None, "chain"])
@pytest.mark.parametrize("sequential", [False, True])
def test_mi_bodies_match_plain(cuda, sequential, path):
    mi = _mi_tables(sequential)
    dt = A.DeviceTables.from_numpy(mi, cuda)
    config = KernelConfig(has_joins=False, has_conditions=False, has_scopes=False,
                          has_mi=True)
    I, T = 64, 512
    rng = np.random.default_rng(5)
    arrays = {
        "elem": np.full(T, -1, np.int32), "phase": np.zeros(T, np.int32),
        "inst": np.zeros(T, np.int32), "def_of": np.zeros(I, np.int32),
        "var_slots": np.zeros((I, 1, 2), np.int32),
        "join_counts": np.zeros((I, 5), np.int32),
        "mi_left": np.zeros((I, 5), np.int32), "done": np.zeros(I, np.bool_),
    }
    arrays["elem"][:I] = 1
    arrays["inst"][:I] = np.arange(I)
    arrays["mi_left"][:, 2] = rng.integers(1, 5, I)  # admission-predicted cardinality
    state = kb.group_state(arrays, cuda)
    before = {k: v.clone() for k, v in state.items()}
    ks = ps = state
    for _ in range(10):
        ks, krows = _collect(path)(dt, ks, n_steps=8, config=config)
        ps, prows = A.run_collect_plain(dt, ps, n_steps=8, config=config)
        assert torch.equal(krows.cpu(), prows.cpu())
        _assert_state_equal(ks, ps)
        jobs = _waiting(mi["kernel_op"], ks)
        if jobs.size:
            ks, ps = A.complete_jobs(ks, jobs), A.complete_jobs(ps, jobs)
    assert bool(ks["done"].all())
    _assert_state_equal(state, before)


def test_drive_group_matches_cpu(cuda):
    tables = kb.deploy([W.to_xml(W.mixed_definitions())])
    rng = np.random.default_rng(1)

    def group():
        out = []
        for idx in range(300):
            d = int(rng.integers(0, tables.num_definitions))
            x = float(rng.integers(0, 60))
            out.append(kb.GroupInstance(idx=idx, definition=d,
                                        slots={"x": A.pack_slot_values(np.float64(x)).tolist()}))
        return out

    g = group()
    gpu = kb.drive_group(tables, A.DeviceTables.from_numpy(tables, cuda),
                         [kb.GroupInstance(**vars(i)) for i in g], device=cuda)
    cpu = kb.drive_group(tables, A.DeviceTables.from_numpy(tables, "cpu"),
                         [kb.GroupInstance(**vars(i)) for i in g], device="cpu")
    assert gpu.waves == cpu.waves
    _assert_state_equal(gpu.state, cpu.state)
    assert bool(gpu.state["done"][:300].all())


def test_launch_counts(cuda):
    tables, dt, state = _setup("one_task", 64, None, seed=0, device=cuda)
    A.reset_launch_counts()
    A.run_collect(dt, state, n_steps=8, config=tables.kernel_config)
    assert A.launch_counts() == {"step": 8, "run_collect": 1, "run_to_completion": 0,
                                 "sharded_step": 0, "sharded_collect": 0, "decision": 0}
    # the grid kernel decides its steps on the device: it counts one call
    # and no host-enqueued step
    A.run_to_completion(dt, state, max_steps=64, config=tables.kernel_config)
    A.run_collect_plain(dt, state, n_steps=8, config=tables.kernel_config)
    A.step_plain(dt, state, config=tables.kernel_config)
    assert A.launch_counts() == {"step": 8, "run_collect": 1, "run_to_completion": 1,
                                 "sharded_step": 0, "sharded_collect": 0, "decision": 0}
    # on the forced chain, one_task quiesces within the first block of
    # steps: the host stops there
    kernels.run_until_quiet(dt, state, 64, tables.kernel_config, True, path="chain")
    assert A.launch_counts() == {"step": 8 + kernels.COMPLETION_BLOCK_STEPS,
                                 "run_collect": 1, "run_to_completion": 2,
                                 "sharded_step": 0, "sharded_collect": 0, "decision": 0}


@pytest.mark.parametrize("name", ["one_task", "fork_join", "mixed"])
def test_kernels_leave_input_state_unchanged(cuda, name):
    """The kernels copy the arrays the config may write and share the rest
    with the caller's state; the caller's tensors never change."""
    tables, dt, state = _setup(name, 64, None, seed=2, device=cuda)
    config = tables.kernel_config
    before = {k: v.clone() for k, v in state.items()}
    new, _ = A.run_collect(dt, state, n_steps=8, config=config)
    A.run_to_completion(dt, state, max_steps=64, config=config)
    torch.cuda.synchronize()
    _assert_state_equal(state, before)
    written = {"join_counts": config.has_joins, "mi_left": config.has_mi,
               "def_of": False, "var_slots": False, "elem": True}
    for k, w in written.items():
        assert (new[k].data_ptr() != state[k].data_ptr()) == w, k


# ---------------------------------------------------------------------------
# the sharded kernels: all shards in one launch per phase


def _shard_requests(registry, dt, n_shards: int) -> list:
    """Up to n_shards partition groups (at most 5) over [one_task,
    fork_join, exclusive_chain, mixed]: one quiesces in its first chunk
    (and is padded from the small bucket), one runs on, one overflows, the
    rest are mixed groups; padding shards fill the mesh."""
    kinds = [(0, 40, False), (2, 100, False), (1, 128, True), (3, 100, False),
             (3, 60, False)]
    out = []
    rng = np.random.default_rng(4)
    for d, n, overflow in kinds[:min(n_shards, len(kinds))]:
        insts = []
        for idx in range(n):
            definition = d if d < 3 else int(rng.integers(3, registry.tables.num_definitions))
            x = A.pack_slot_values(np.float64(rng.integers(0, 60))).tolist()
            insts.append(kb.GroupInstance(idx=idx, definition=definition, slots={"x": x}))
        arrays, I, T = kb.build_group_arrays(registry.tables, insts, 128)
        if overflow:
            # the free slots hold stalled tokens (the bucket is the largest,
            # so the dispatch adds none): the forks find no room
            arrays["elem"][n:] = int(registry.tables.start_elem[d])
            arrays["phase"][n:] = A.PHASE_STALLED
        out.append(MR.GroupRequest(dt, registry.tables.kernel_config,
                                   registry.tables_fingerprint, arrays, I, T, 64, 8))
    return out


def _shard_registry():
    registry = kb.KernelRegistry()
    ProcessCatalog.from_xml([W.to_xml([W.one_task(), W.fork_join(), W.exclusive_chain()]
                                      + W.mixed_definitions())]).register(registry)
    return registry


@pytest.mark.parametrize("path", [None, "chain"])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_sharded_collect_matches_plain(cuda, n_shards, path):
    """Sharded chunks (the fused chunk by the shape rule, or the forced
    chain): shard 0 quiesces in its first chunk, shard 2 overflows alone."""
    registry = _shard_registry()
    dt = registry.device_tables_for(cuda)
    config = registry.tables.kernel_config
    requests = _shard_requests(registry, dt, n_shards)
    host, I, T = MR.stack_requests(requests, n_shards)
    state = M.shard_state(host, M.make_mesh(n_shards, cuda))
    row_len = T * (2 + dt.out_target.shape[2]) + 2
    ks = ps = state
    for chunk in range(10):
        ks, krows = kernels.run_steps(dt, ks, 8, config, auto_jobs=False, emit_events=True,
                                      mode="collect", num_shards=n_shards, sharded=True,
                                      path=path)
        ps, prows = MR.sharded_collect_plain(dt, ps, 8, n_shards, config)
        assert torch.equal(krows.cpu(), prows.cpu())
        _assert_state_equal(ks, ps)
        if chunk == 0:
            # shard 0 quiesces in its first chunk, shard 1 runs on
            quiet = [bool((krows[:, s * row_len + row_len - 2] == 0).any())
                     for s in range(n_shards)]
            assert quiet[0] and (n_shards == 1 or not quiet[1])
        waiting = []
        for s in range(n_shards):
            local = {k: ks[k].chunk(n_shards)[s] for k in ("phase", "elem", "inst", "def_of")}
            waiting += (s * T + _waiting(registry.tables.kernel_op, local)).tolist()
        if waiting:
            ks, ps = A.complete_jobs(ks, waiting), A.complete_jobs(ps, waiting)
    overflow = ks["overflow"].cpu().tolist()
    if n_shards >= 3:
        assert overflow[:3] == [False, False, True]  # only the stalled pool overflowed


def test_sharded_collect_with_one_shard_is_run_collect(cuda):
    """NS = 1: the sharded kernels compute slice 1's run_collect exactly."""
    tables, dt, state = _setup("mixed", 2048, None, seed=9, device=cuda)
    config = tables.kernel_config
    one = dict(state)
    for k in ("transitions", "jobs_created", "completed", "overflow"):
        one[k] = state[k].reshape(1)
    ks, krows = A.run_collect(dt, state, n_steps=8, config=config)
    ss, srows = kernels.run_steps(dt, one, 8, config, auto_jobs=False, emit_events=True,
                                  mode="collect", num_shards=1, sharded=True)
    assert torch.equal(krows.cpu(), srows.cpu())
    _assert_state_equal(ks, {k: (v.reshape(()) if v.shape == (1,) else v)
                             for k, v in ss.items()})


def _sharded_state(n_shards: int, device, overflow_shard: bool):
    tables = compile_tables([transform(m) for m in [W.one_task(), W.fork_join()]
                             + W.mixed_definitions()])
    I_l = 64
    rng = np.random.default_rng(n_shards)
    def_of = rng.integers(0, tables.num_definitions, I_l * n_shards).astype(np.int32)
    T_l = kb._pow2(tables.token_width * I_l)
    if overflow_shard:
        def_of[:I_l] = 1  # shard 0: fork_join only
    slots = rng.integers(-5, 60, (I_l * n_shards, tables.num_slots)).astype(np.float64)
    state = A.make_state(tables, I_l * n_shards, def_of, initial_slots=slots,
                         token_capacity=T_l * n_shards, num_shards=n_shards, device=device)
    if overflow_shard:
        # shard 0's free slots hold stalled tokens: its forks find no room for
        # their second branch, while the other shards' pools stay free
        state["elem"][I_l:T_l] = int(tables.start_elem[1])
        state["phase"][I_l:T_l] = A.PHASE_STALLED
    return tables, A.DeviceTables.from_numpy(tables, device), state


@pytest.mark.parametrize("path", [None, "chain"])
@pytest.mark.parametrize("overflow_shard", [False, True])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_sharded_step_matches_plain(cuda, n_shards, overflow_shard, path):
    tables, dt, state = _sharded_state(n_shards, cuda, overflow_shard)
    mesh = M.make_mesh(n_shards, cuda)
    step = M.make_sharded_step(mesh, auto_jobs=True, config=tables.kernel_config)
    if path is not None:
        step = lambda dt, st: kernels.run_sharded_step(  # noqa: E731
            dt, st, n_shards, tables.kernel_config, True, path=path)
    ks = ps = state
    for _ in range(10):
        ks = step(dt, ks)
        ps = M.sharded_step_plain(dt, ps, n_shards, True, tables.kernel_config)
        _assert_state_equal(ks, ps)
    assert bool(ks["overflow"]) == overflow_shard
    if n_shards == 1:
        single, _ = A.run_to_completion(dt, state, max_steps=10, config=tables.kernel_config)
        assert int(single["transitions"]) == int(ks["transitions"])


def _assert_results_equal(got: list, want: list) -> None:
    for g, c in zip(got, want, strict=True):
        assert (g.overflow, g.quiesced, len(g.steps)) == (c.overflow, c.quiesced, len(c.steps))
        for a, b in zip(g.steps, c.steps):
            assert all(np.array_equal(a[k], b[k]) for k in a)
        assert all(np.array_equal(g.state[k], c.state[k]) for k in g.state)


def _grouped_mesh_matches(devices, overflow_shard: bool) -> None:
    """The grouped sharded step (10 steps) and the grouped runner over a mesh
    of 8 shards on ``devices``, byte-equal to the one-group launch and to the
    plain version; one cross-group counter sum per step."""
    first = torch.device(devices[0])
    tables, dt, state = _sharded_state(8, first, overflow_shard)
    config = tables.kernel_config
    mesh = M.make_mesh(8, devices=devices)
    grouped = M.make_sharded_step(mesh, auto_jobs=True, config=config)
    one = M.make_sharded_step(M.make_mesh(8, first), auto_jobs=True, config=config)
    gs, ks, ps = M.shard_state(state, mesh), state, state
    A.reset_launch_counts()
    for _ in range(10):
        gs = grouped(dt, gs)
        ks = one(dt, ks)
        ps = M.sharded_step_plain(dt, ps, 8, True, config)
        _assert_state_equal(M.gather_state(gs), ps)
        _assert_state_equal(M.gather_state(gs), ks)
    assert A.group_launch_counts()["combine_groups"] == 10
    assert bool(M.gather_state(gs)["overflow"]) == overflow_shard
    for group, (dev, _) in zip(gs, mesh.groups):
        assert all(v.device == dev for v in group.values())

    registry = _shard_registry()
    results = {}
    for name, runner_mesh in (("grouped", mesh), ("one", M.make_mesh(8, first)),
                              ("plain", M.make_mesh(8, "cpu"))):
        runner = MR.MeshKernelRunner(mesh=runner_mesh)
        results[name] = runner.run_groups(_shard_requests(
            registry, registry.device_tables_for(runner_mesh.device), 8))
    _assert_results_equal(results["grouped"], results["plain"])
    _assert_results_equal(results["grouped"], results["one"])


@pytest.mark.parametrize("overflow_shard", [False, True])
@pytest.mark.parametrize("groups", [2, 8])
def test_grouped_mesh_on_one_card_matches_one_group_and_plain(cuda, groups, overflow_shard):
    """Launch groups on one card (``[cuda:0] * groups``): each group's
    blocks take their own launches, the counters are summed by
    ``k_combine_groups``."""
    _grouped_mesh_matches([torch.device("cuda", 0)] * groups, overflow_shard)


def test_sharded_launch_counts(cuda):
    registry = _shard_registry()
    dt = registry.device_tables_for(cuda)
    runner = MR.MeshKernelRunner(mesh=M.make_mesh(3, cuda))
    A.reset_launch_counts()
    runner.run_groups(_shard_requests(registry, dt, 3))
    counts = A.launch_counts()
    assert counts["sharded_collect"] >= 1 and counts["sharded_step"] == 8 * counts["sharded_collect"]
    assert counts["step"] == counts["run_collect"] == 0


def test_mesh_runner_on_card_matches_cpu(cuda):
    registry = _shard_registry()
    results = {}
    for dev in (cuda, torch.device("cpu")):
        runner = MR.MeshKernelRunner(mesh=M.make_mesh(8, dev))
        results[dev.type] = runner.run_groups(
            _shard_requests(registry, registry.device_tables_for(dev), 8))
    for g, c in zip(results["cuda"], results["cpu"]):
        assert (g.overflow, g.quiesced, len(g.steps)) == (c.overflow, c.quiesced, len(c.steps))
        for a, b in zip(g.steps, c.steps):
            assert all(np.array_equal(a[k], b[k]) for k in a)
        assert all(np.array_equal(g.state[k], c.state[k]) for k in g.state)


def test_drive_groups_on_mesh_matches_drive_group(cuda):
    xml = W.to_xml(W.mixed_definitions())
    rng = np.random.default_rng(6)
    partitions = []
    for _ in range(3):
        registry = kb.KernelRegistry()
        ProcessCatalog.from_xml([xml]).register(registry)
        insts = [kb.GroupInstance(
            idx=i, definition=int(rng.integers(0, 8)),
            slots={"x": A.pack_slot_values(np.float64(rng.integers(0, 60))).tolist()})
            for i in range(200)]
        partitions.append((registry, insts))
    runner = MR.MeshKernelRunner(mesh=M.make_mesh(4, cuda), batch_window_s=0.05)
    results = kb.drive_groups_on_mesh(
        runner, [(r, [kb.GroupInstance(**vars(i)) for i in g]) for r, g in partitions])
    assert runner.coalesced_dispatches > 0
    for (registry, insts), result in zip(partitions, results):
        solo = kb.drive_group(registry.tables, registry.device_tables_for(cuda),
                              [kb.GroupInstance(**vars(i)) for i in insts], device=cuda)
        assert result.waves == solo.waves
        _assert_state_equal({k: v.cpu() for k, v in solo.state.items()}, result.state)


# ---------------------------------------------------------------------------
# the fused chunk (one cluster per shard, one launch per chunk) and the chain


def _chain_launches(config, n_steps: int, collect: bool) -> int:
    """Grid launches of one chain call: zt_prepare (k_prepare, and
    k_occupancy with scopes or MI), then per lock-step classify, the join
    rank (joins), three scan passes, place, finish, occupancy (scopes or
    MI), active (collect) and end step."""
    scoped = config.has_scopes or config.has_mi
    per_step = 7 + config.has_joins + scoped + collect
    return 1 + scoped + n_steps * per_step


@pytest.mark.parametrize("T,path", [(kernels.FUSED_MAX_TOKENS, "fused"),
                                    (kernels.FUSED_MAX_TOKENS + 64, "chain")])
def test_shape_rule_at_the_threshold(cuda, T, path):
    """T at the threshold takes the fused chunk, just above it the chain;
    both byte-equal to the plain version (steps without events: the packed
    dest column holds T <= 0xFFFF only)."""
    tables, dt, state = _setup("fork_join", 2048, T, seed=21, device=cuda)
    config = tables.kernel_config
    ks = ps = state
    A.reset_launch_counts()
    for _ in range(6):
        ks, _ = kernels.run_steps(dt, ks, 1, config, auto_jobs=True, emit_events=False,
                                  mode="step")
        ps, _ = A.step_plain(dt, ps, auto_jobs=True, config=config)
        _assert_state_equal(ks, ps)
    grid = A.grid_launch_counts()
    if path == "fused":
        assert grid == {"fused": 6, "chain": 0, "combine": 0, "grid": 0}
    else:
        assert grid == {"fused": 0, "chain": 6 * _chain_launches(config, 1, False),
                        "combine": 0, "grid": 0}


@pytest.mark.parametrize("name", ["mixed", "fork_join", "nomatch"])
def test_fused_equals_forced_chain(cuda, name):
    tables, dt, state = _setup(name, 2048, None, seed=17, device=cuda)
    config = tables.kernel_config
    fs = cs = state
    for _ in range(6):
        fs, frows = kernels.run_steps(dt, fs, 8, config, auto_jobs=False, emit_events=True,
                                      mode="collect", path="fused")
        cs, crows = kernels.run_steps(dt, cs, 8, config, auto_jobs=False, emit_events=True,
                                      mode="collect", path="chain")
        assert torch.equal(frows, crows)
        _assert_state_equal(fs, cs)
        jobs = _waiting(tables.kernel_op, fs)
        if jobs.size:
            fs, cs = A.complete_jobs(fs, jobs), A.complete_jobs(cs, jobs)


@pytest.mark.parametrize("n_shards", [1, 8])
def test_fused_chunk_is_deterministic(cuda, n_shards):
    """The same fused chunk 20 times: every output byte-equal to the plain
    version (a visibility race between the blocks of a cluster would show
    as a run that differs)."""
    if n_shards == 1:
        tables, dt, state = _setup("mixed", 2048, None, seed=19, device=cuda)
    else:
        tables, dt, state = _sharded_state(n_shards, cuda, True)
        for k in ("transitions", "jobs_created", "completed", "overflow"):
            state[k] = state[k].reshape(1).repeat(n_shards)
    config = tables.kernel_config
    if n_shards == 1:
        want_state, want_rows = A.run_collect_plain(dt, state, n_steps=8, config=config)
    else:
        want_state, want_rows = MR.sharded_collect_plain(dt, state, 8, n_shards, config)
    for _ in range(20):
        got_state, got_rows = kernels.run_steps(dt, state, 8, config, auto_jobs=False,
                                                emit_events=True, mode="collect",
                                                num_shards=n_shards, sharded=n_shards > 1,
                                                path="fused")
        assert torch.equal(got_rows, want_rows)
        _assert_state_equal(got_state, want_state)


def test_grid_launch_counts(cuda):
    """A serving chunk is one grid launch on the fused path; the forced
    chain enqueues its per-phase launches; the sharded step adds one
    combine launch."""
    tables, dt, state = _setup("mixed", 2048, None, seed=23, device=cuda)
    config = tables.kernel_config
    A.reset_launch_counts()
    A.run_collect(dt, state, n_steps=8, config=config)
    assert A.grid_launch_counts() == {"fused": 1, "chain": 0, "combine": 0, "grid": 0}
    A.reset_launch_counts()
    kernels.run_steps(dt, state, 8, config, auto_jobs=False, emit_events=True,
                      mode="collect", path="chain")
    assert A.grid_launch_counts() == {"fused": 0, "chain": _chain_launches(config, 8, True),
                                      "combine": 0, "grid": 0}
    # the same lock-step counts on both paths
    assert A.launch_counts()["step"] == 8
    stables, sdt, sstate = _sharded_state(3, cuda, False)
    A.reset_launch_counts()
    M.make_sharded_step(M.make_mesh(3, cuda), config=stables.kernel_config)(sdt, sstate)
    assert A.grid_launch_counts() == {"fused": 1, "chain": 0, "combine": 1, "grid": 0}
    A.reset_launch_counts()
    A.run_to_completion(dt, state, max_steps=8, config=config)
    assert A.grid_launch_counts() == {"fused": 0, "chain": 0, "combine": 0, "grid": 1}
    A.reset_launch_counts()
    kernels.run_until_quiet(dt, state, 8, config, True, path="chain")
    grid = A.grid_launch_counts()
    assert grid["fused"] == grid["grid"] == 0 and grid["chain"] > 0


def test_fused_resources(cuda):
    """The fused kernel launches 8-block clusters, and a mesh of 8 shards
    fits on the card at once."""
    res = kernels.fused_resources()
    assert res["registers"] > 0 and res["max_active_clusters"] >= 8
    lines = kernels.ptxas_report("k_chunk")
    assert any("registers" in line for line in lines)


# ---------------------------------------------------------------------------
# the grid kernel (run_to_completion in one cooperative launch)


def _mi_setup(sequential: bool, device):
    """The MI body tables at I = 64, T = 512, with admission-predicted
    cardinalities (as in test_mi_bodies_match_plain)."""
    dt = A.DeviceTables.from_numpy(_mi_tables(sequential), device)
    config = KernelConfig(has_joins=False, has_conditions=False, has_scopes=False,
                          has_mi=True)
    I, T = 64, 512
    arrays = {
        "elem": np.full(T, -1, np.int32), "phase": np.zeros(T, np.int32),
        "inst": np.zeros(T, np.int32), "def_of": np.zeros(I, np.int32),
        "var_slots": np.zeros((I, 1, 2), np.int32),
        "join_counts": np.zeros((I, 5), np.int32),
        "mi_left": np.zeros((I, 5), np.int32), "done": np.zeros(I, np.bool_),
    }
    arrays["elem"][:I] = 1
    arrays["inst"][:I] = np.arange(I)
    arrays["mi_left"][:, 2] = np.random.default_rng(5).integers(1, 5, I)
    return dt, config, kb.group_state(arrays, device)


@pytest.mark.parametrize("auto_jobs", [True, False])
@pytest.mark.parametrize("max_steps", [0, 1, 3, 100])
@pytest.mark.parametrize("name", sorted(WORKLOADS) + ["mi_parallel", "mi_sequential"])
def test_completion_paths_match_plain(cuda, name, max_steps, auto_jobs):
    """The grid kernel against the forced chain and the plain version: the
    loop cut at 0, 1 and 3 steps and run to its end, both job modes."""
    if name.startswith("mi_"):
        dt, config, state = _mi_setup(name == "mi_sequential", cuda)
    else:
        tables, dt, state = _setup(name, 64, None, seed=29, device=cuda)
        config = tables.kernel_config
    gs, gsteps = kernels.run_until_quiet(dt, state, max_steps, config, auto_jobs)
    cs, csteps = kernels.run_until_quiet(dt, state, max_steps, config, auto_jobs,
                                         path="chain")
    ps, psteps = A.run_to_completion_plain(dt, state, max_steps, auto_jobs, config)
    _assert_state_equal(gs, ps)
    _assert_state_equal(cs, ps)
    assert gsteps.dtype == torch.int32 and int(gsteps) == int(csteps) == int(psteps)


def _ceiling(n: int, device):
    tables = compile_tables([transform(W.one_task())])
    state = A.make_state(tables, n, np.zeros(n, np.int32), token_capacity=n, device=device)
    return A.DeviceTables.from_numpy(tables, device), tables.kernel_config, state


def test_grid_completion_at_1_16(cuda):
    dt, config, state = _ceiling(1 << 16, cuda)
    gs, gsteps = A.run_to_completion(dt, state, max_steps=64, config=config)
    ps, psteps = A.run_to_completion_plain(dt, state, max_steps=64, config=config)
    _assert_state_equal(gs, ps)
    assert int(gsteps) == int(psteps) > 0 and bool(gs["done"].all())


def test_grid_completion_is_deterministic(cuda):
    """20 calls at I = T = 1 << 20: every output byte-equal to the plain
    version (a race at a grid barrier or in the block-total scan would show
    as a run that differs)."""
    dt, config, state = _ceiling(1 << 20, cuda)
    want, wsteps = A.run_to_completion_plain(dt, state, max_steps=64, config=config)
    for _ in range(20):
        got, gsteps = A.run_to_completion(dt, state, max_steps=64, config=config)
        _assert_state_equal(got, want)
        assert int(gsteps) == int(wsteps)


def test_grid_completion_is_one_launch(cuda):
    """One grid launch per run_to_completion call, whatever the steps, and
    a grid that fills the card at once."""
    dt, config, state = _ceiling(1 << 16, cuda)
    for max_steps in (0, 1, 64):
        A.reset_launch_counts()
        A.run_to_completion(dt, state, max_steps=max_steps, config=config)
        assert A.grid_launch_counts() == {"fused": 0, "chain": 0, "combine": 0, "grid": 1}
        assert A.launch_counts()["run_to_completion"] == 1
    res = kernels.complete_resources()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert res["registers"] > 0 and res["blocks_per_sm"] >= 1
    assert res["grid_blocks"] == min(res["blocks_per_sm"] * sms, kernels.GRID_MAX_BLOCKS)
    assert any("registers" in line for line in kernels.ptxas_report("k_complete"))


# ---------------------------------------------------------------------------
# the decision kernel (csrc/decision.cu) against its plain version

_PLANES = np.array([-(2**31), -(2**31) + 1, -2, -1, 0, 1, 2, 2**31 - 2, 2**31 - 1], np.int32)


def _atoms(seed: int, N: int, I: int, R: int, K: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, (I, R, K)).astype(np.int32),
            rng.choice(_PLANES, (I, R, K, 2)), rng.choice(_PLANES, (I, R, K, 2)),
            rng.integers(0, 4, (I, R, K)).astype(np.int32),
            rng.choice(_PLANES, (N, I, 2)), rng.random((N, I)) < 0.8)


# the shapes of tests/test_torch_decision.py's SHAPES beside these, and a
# table too wide for shared memory at N = 16,384 (R = 2048)
@pytest.mark.parametrize("kernel", kernels.DECISION_KERNELS)
@pytest.mark.parametrize("N,I,R,K", [(1000, 2, 8, 4), (777, 3, 40, 2), (0, 2, 5, 3),
                                     (300, 1, 1, 1), (2048, 4, 512, 4), (513, 2, 33, 7),
                                     (256, 0, 9, 2), (256, 2, 9, 0), (64, 2, 8, 4),
                                     (97, 3, 40, 2), (48, 4, 70, 4), (20, 2, 33, 1),
                                     (45, 2, 31, 3), (45, 2, 32, 4), (45, 3, 33, 2),
                                     (45, 2, 64, 3), (9, 2, 1025, 2), (13, 2, 20, 64),
                                     (1, 3, 40, 4), (37, 2, 300, 3), (600, 64, 8, 2),
                                     (16384, 4, 2048, 4), (513, 2, 8, 4), (257, 2, 33, 2),
                                     (129, 3, 100, 2), (33, 2, 512, 4), (17, 4, 1024, 2),
                                     (70, 4, 512, 4), (5, 4, 2048, 4), (7, 2, 1025, 64),
                                     (21, 64, 8, 4), (11, 0, 9, 2), (19, 2, 65, 2),
                                     (23, 2, 513, 2), (2, 2, 96, 3), (40, 2, 257, 3),
                                     (60, 5, 160, 5), (1, 1, 2048, 1)])
def test_decision_kernel_matches_plain(cuda, N, I, R, K, kernel):
    arrays = [torch.from_numpy(np.array(a)).to(cuda) for a in _atoms(N + R, N, I, R, K)]
    if kernel == "lanes":
        got = D.evaluate_batch(*arrays)
    else:
        got = kernels.run_decision(*arrays, kernel=kernel)
    want = D._evaluate_batch(*arrays)
    for name, a, b in zip(("m", "selected", "counts"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), f"{name} differs at {(a != b).nonzero()[:5].tolist()}"


@pytest.mark.parametrize("I,R,K,keys,atoms", [
    (2, 8, 4, True, True),       # the benchmark table
    (4, 512, 4, True, True),     # the wide table: 131 KB of intervals
    (4, 2048, 4, True, False),   # 512 KB of intervals: read from device memory
    (2, 1025, 64, True, False),
    (64, 8, 4, False, True),     # 512 contexts x 64 inputs of keys: 288 KB
    (0, 9, 2, True, True),
    (2, 31, 3, True, True), (2, 33, 2, True, True), (2, 64, 3, True, True),
    (2, 65, 2, True, True), (2, 300, 3, True, True), (2, 513, 2, True, True),
])
def test_decision_lanes_plan(cuda, I, R, K, keys, atoms):
    """The lanes layout's shape is fixed from the table alone: ceil(R / 32)
    rule words rounded up to a power of two (at most 32) lanes per context,
    and what is staged fits the 200 KB budget (the H100 gives a block at most
    227 KB) with at least one block per SM."""
    plan = kernels.decision_lanes_plan(I, R, K)
    words = -(-R // 32)
    lanes = min(32, 1 << (words - 1).bit_length())
    assert plan["lanes"] == lanes
    assert (plan["stage_keys"], plan["stage_atoms"]) == (keys, atoms)
    want = ((plan["threads"] // lanes) * I * 9 if keys else 0) + \
        (I * K * 32 * words * 16 + I * words * 4 if atoms else 0)
    assert plan["smem_bytes"] == want <= 200 * 1024 < 227 * 1024
    assert plan["blocks_per_sm"] >= 1
    assert kernels.decision_lanes_plan(I, R, K) == plan


def test_decision_launch_counts(cuda):
    arrays = [torch.from_numpy(np.array(a)).to(cuda) for a in _atoms(1, 64, 2, 8, 4)]
    A.reset_launch_counts()
    D.evaluate_batch(*arrays)
    D._evaluate_batch(*arrays)
    D.evaluate_batch(*arrays[:4], arrays[4][:0], arrays[5][:0])  # N = 0: no launch
    assert A.launch_counts()["decision"] == 1


@pytest.mark.parametrize("hit,agg", [("FIRST", ""), ("UNIQUE", ""), ("ANY", ""),
                                     ("RULE ORDER", ""), ("COLLECT", ""), ("COLLECT", "SUM"),
                                     ("COLLECT", "MIN"), ("COLLECT", "MAX"),
                                     ("COLLECT", "COUNT")])
def test_batch_evaluate_on_card_equals_cpu(cuda, hit, agg):
    table = D.compile_decision_table(parse_dmn_xml(W.dmn_band_xml(hit, agg)).decisions["band"])
    contexts = W.dmn_band_contexts(5000) + [{}, {"amount": None, "tier": "gold"},
                                            {"amount": True, "tier": "bronze"}]
    assert D.batch_evaluate(table, contexts, device=cuda) == \
        D.batch_evaluate(table, contexts, device="cpu")


# ---------------------------------------------------------------------------
# the fault seam on the card


@pytest.fixture
def clean_plane():
    kb.install_device_chaos(None)
    reset_shared_device_health()
    yield
    kb.install_device_chaos(None)
    reset_shared_device_health()


def _serving_group(cuda, n: int, seed: int):
    tables = kb.deploy([W.to_xml(W.mixed_definitions())])
    rng = np.random.default_rng(seed)
    insts = [kb.GroupInstance(idx=i, definition=int(rng.integers(0, 8)),
                              slots={"x": A.pack_slot_values(
                                  np.float64(rng.integers(0, 60))).tolist()})
             for i in range(n)]
    arrays, I, T = kb.build_group_arrays(tables, insts)
    return tables, A.DeviceTables.from_numpy(tables, cuda), kb.group_state(arrays, cuda), I, T


def test_shadow_on_card_matches_the_oracle(cuda, clean_plane):
    tables, dt, state, I, T = _serving_group(cuda, 300, 1)
    defense = kb.DeviceDefense()
    defense.health.cfg.shadow_sample_rate = 1.0
    out = kb.run_group(dt, tables.kernel_config, state, I, T, defense=defense)
    want = kb.run_group(dt, tables.kernel_config, state, I, T)
    assert out.fail_reason is None and defense.shadow_quarantined == 0
    assert defense.health.shadow_checks == 1 and defense.health.state == HEALTHY
    assert len(out.steps) == len(want.steps)
    _assert_state_equal(out.state, want.state)


def test_wedge_on_card_is_typed_and_the_next_group_runs(cuda, clean_plane):
    tables, dt, state, I, T = _serving_group(cuda, 300, 2)
    defense = kb.DeviceDefense()
    defense.health.cfg.dispatch_timeout_ms = 50
    kb.install_device_chaos(DeviceChaosController(
        DeviceFaultPlan(seed=1, stall_p=1.0, stall_ms=300), "t"))
    out = kb.run_group(dt, tables.kernel_config, state, I, T, defense=defense)
    assert out.fail_reason == "device-wedged" and defense.health.state == SUSPECT
    kb.install_device_chaos(None)
    again = kb.run_group(dt, tables.kernel_config, state, I, T, defense=defense)
    assert again.fail_reason is None


# ---------------------------------------------------------------------------
# the serving write path: the kernel-backed harness on the card


def _harness_log(h) -> list:
    return [(v.position, v.source_position, v.processed, v.record.to_bytes())
            for v in h.stream.new_reader(1)]


def _backend_counters(backend) -> dict:
    return {"groups": backend.groups_processed, "commands": backend.commands_processed,
            "fallbacks": backend.fallbacks, "reasons": dict(backend.fallback_reasons),
            "hits": backend.template_hits, "misses": backend.template_misses,
            "audits": backend.template_audits, "quarantined": backend.shadow_quarantined,
            "accounting": backend.accounting.mark()}


def _drive_waves(h, models, n: int) -> None:
    """Deploy, create ``n`` instances round robin (x = i mod 30), complete
    every job in waves."""
    from zeebe_tpu_torch.logstreams import LogAppendEntry
    from zeebe_tpu_torch.protocol import ValueType, command
    from zeebe_tpu_torch.protocol.intent import JobIntent, ProcessInstanceCreationIntent

    h.deploy(*models)
    pids = [m.process_id for m in models]
    for i in range(n):
        h.stream.writer.try_write([LogAppendEntry(command(
            ValueType.PROCESS_INSTANCE_CREATION, ProcessInstanceCreationIntent.CREATE,
            {"bpmnProcessId": pids[i % len(pids)], "version": -1, "variables": {"x": i % 30}}))])
    h.pump()
    types = sorted({r.record.value["type"] for r in
                    h.exporter.job_records().with_intent(JobIntent.CREATED)})
    for _ in range(64):
        jobs = [j for jt in types for j in h.activate_jobs(jt, max_jobs=1000)]
        if not jobs:
            return
        for job in jobs:
            h.complete_job(job["key"])
    raise AssertionError("the job waves did not drain")


def _three_runs(drive, device) -> tuple:
    """(sequential log, kernel log on ``device``, counters, kernel log on the
    CPU, counters) of one drive."""
    from zeebe_tpu_torch.testing import EngineHarness

    out = []
    for kernel, dev in ((False, None), (True, device), (True, "cpu")):
        reset_shared_device_health()
        h = EngineHarness(use_kernel_backend=kernel, device=dev)
        try:
            drive(h)
            out.append(_harness_log(h))
            if kernel:
                out.append(_backend_counters(h.kernel_backend))
        finally:
            h.close()
    return tuple(out)


@pytest.mark.parametrize("workload", ["one_task", "mixed", "random_seed_4"])
def test_kernel_harness_on_card_writes_the_sequential_log(cuda, clean_plane, workload):
    import random

    if workload == "random_seed_4":
        threads = torch.get_num_threads()
        from torch_kernel_flows import flow_module

        # the helper pins torch to one thread for the CPU suite's workers
        torch.set_num_threads(threads)
        gen_module = flow_module("test_randomized_parity", "zeebe_tpu_torch")
        gen_rng = random.Random(4)
        gen = gen_module._Gen(gen_rng, "rand_4")
        model = gen.build()
        instances = gen_rng.randint(1, 3)

        def drive(h):
            gen_module._drive(h, gen, model, random.Random(5), instances, True)
    else:
        models = [W.one_task()] if workload == "one_task" else W.mixed_definitions()

        def drive(h):
            _drive_waves(h, models, 300)

    A.reset_launch_counts()
    seq, card_log, card_counts, cpu_log, cpu_counts = _three_runs(drive, cuda)
    assert card_log == seq and cpu_log == seq
    assert card_counts == cpu_counts
    assert card_counts["commands"] > 0
    assert A.launch_counts()["run_collect"] > 0


def test_kernel_harness_corruption_caught_before_commit_on_card(cuda, clean_plane, tmp_path):
    import json as _json

    from zeebe_tpu_torch.testing import EngineHarness

    models = W.mixed_definitions()
    reset_shared_device_health()
    h = EngineHarness()
    try:
        _drive_waves(h, models, 200)
        seq = _harness_log(h)
    finally:
        h.close()
    reset_shared_device_health()
    health = shared_device_health()
    health.cfg.shadow_sample_rate = 1.0
    controller = DeviceChaosController(DeviceFaultPlan(seed=3, corrupt_p=1.0, flips=3), "t")
    controller.ledger_file = str(tmp_path / "ledger.jsonl")
    kb.install_device_chaos(controller)
    h = EngineHarness(use_kernel_backend=True, device=cuda)
    try:
        _drive_waves(h, models, 200)
        got = _harness_log(h)
        backend = h.kernel_backend
    finally:
        h.close()
    assert got == seq
    assert backend.shadow_quarantined > 0 and backend.groups_processed > 0
    lines = [_json.loads(line) for line in open(controller.ledger_file)]
    injected = {e["seq"] for e in lines if e["kind"] == "inject"}
    assert injected and injected == {e["seq"] for e in lines if e["kind"] == "caught"}


def test_kernel_harness_wedge_reruns_sequentially_on_card(cuda, clean_plane):
    from zeebe_tpu_torch.testing import EngineHarness

    models = [W.one_task()]
    h = EngineHarness()
    try:
        _drive_waves(h, models, 50)
        seq = _harness_log(h)
    finally:
        h.close()
    health = shared_device_health()
    health.cfg.dispatch_timeout_ms = 200
    kb.install_device_chaos(DeviceChaosController(
        DeviceFaultPlan(seed=1, stall_p=1.0, stall_ms=600), "t"))
    h = EngineHarness(use_kernel_backend=True, device=cuda)
    try:
        _drive_waves(h, models, 50)
        got = _harness_log(h)
        backend = h.kernel_backend
    finally:
        h.close()
    assert got == seq
    assert backend.accounting.reasons["device-wedged"] > 0
    assert backend.groups_processed == 0


# ---------------------------------------------------------------------------
# the profiler's device half on the card


def test_sample_device_memory_after_run_group(cuda):
    from zeebe_tpu_torch.observability import profiler as P

    tables, dt, state, I, T = _serving_group(cuda, 300, 3)
    assert kb.run_group(dt, tables.kernel_config, state, I, T).fail_reason is None
    torch.cuda.synchronize()
    index = torch.cuda.current_device()
    assert P.sample_device_memory([torch.device("cuda", index)]) == 2
    values = {c.label_values: c.value for c in P._M_DEVICE_MEMORY._children_snapshot()}
    in_use, limit = values[(f"gpu:{index}", "in_use")], values[(f"gpu:{index}", "limit")]
    assert 0 < in_use < limit == torch.cuda.mem_get_info(index)[1]
    # CUDA is up: the default device list finds the card by itself
    assert P.sample_device_memory() >= 2


def test_trace_capture_names_the_fused_chunk(cuda, tmp_path):
    from zeebe_tpu_torch.observability import profiler as P

    tables, dt, state, I, T = _serving_group(cuda, 300, 4)
    kb.run_group(dt, tables.kernel_config, state, I, T)  # warm-up
    torch.cuda.synchronize()
    capture = P.DeviceTraceCapture(tmp_path)
    trace_dir = capture.start(seconds=60.0)
    try:
        run = kb.run_group(dt, tables.kernel_config, state, I, T)
        torch.cuda.synchronize()
    finally:
        capture.cancel()
    assert run.fail_reason is None and capture.captures_taken == 1
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "kernel" and "k_chunk" in e.get("name", "") for e in events)


# ---------------------------------------------------------------------------
# launches go to the tensors' card, whichever card is current


@pytest.fixture
def second_card(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: the state on cuda:1 while cuda:0 is current")
    torch.cuda.set_device(0)
    yield torch.device("cuda", 1)
    torch.cuda.set_device(0)


def test_launches_follow_the_tensors_card(second_card):
    """State and tables on cuda:1 while cuda:0 is current: run_collect (the
    fused chunk), run_group (its row-ready events), run_to_completion (the
    grid kernel and its occupancy query), the decision kernel (the lanes
    occupancy) and a 2-shard mesh (the sharded chunk and the runner's row
    fetch) all run on cuda:1, byte-equal to the plain version; a mesh of
    launch groups on cuda:0 and cuda:1 runs each group on its card."""
    card = second_card
    assert torch.cuda.current_device() == 0
    tables, dt, state = _setup("mixed", 2048, None, seed=5, device=card)
    config = tables.kernel_config
    ks, krows = A.run_collect(dt, state, n_steps=8, config=config)
    ps, prows = A.run_collect_plain(dt, state, n_steps=8, config=config)
    assert krows.device == card and torch.equal(krows.cpu(), prows.cpu())
    _assert_state_equal(ks, ps)
    ks, ksteps = A.run_to_completion(dt, state, max_steps=100, config=config)
    ps, psteps = A.run_to_completion_plain(dt, state, max_steps=100, config=config)
    _assert_state_equal(ks, ps)
    assert int(ksteps) == int(psteps)

    stables, sdt, sstate, I, T = _serving_group(card, 300, 6)
    out = kb.run_group(sdt, stables.kernel_config, sstate, I, T)
    want = kb.run_group(sdt, stables.kernel_config, sstate, I, T, collect=A.run_collect_plain)
    assert out.fail_reason is None and len(out.steps) == len(want.steps)
    for a, b in zip(out.steps, want.steps):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    _assert_state_equal(out.state, want.state)

    arrays = [torch.from_numpy(np.array(a)).to(card) for a in _atoms(9, 4096, 4, 512, 4)]
    for got, exp in zip(D.evaluate_batch(*arrays), D._evaluate_batch(*arrays)):
        assert got.device == card and torch.equal(got, exp)

    registry = _shard_registry()
    results = {}
    for dev in (card, torch.device("cpu")):
        runner = MR.MeshKernelRunner(mesh=M.make_mesh(2, dev))
        results[dev.type] = runner.run_groups(
            _shard_requests(registry, registry.device_tables_for(dev), 2))
    for g, c in zip(results["cuda"], results["cpu"]):
        assert (g.overflow, g.quiesced, len(g.steps)) == (c.overflow, c.quiesced, len(c.steps))
        for a, b in zip(g.steps, c.steps):
            assert all(np.array_equal(a[k], b[k]) for k in a)
        assert all(np.array_equal(g.state[k], c.state[k]) for k in g.state)
    # a mesh of launch groups on both cards: each group's launches on its
    # card, the counters summed on cuda:0 and copied back to cuda:1
    _grouped_mesh_matches([torch.device("cuda", 0), card], overflow_shard=True)
    assert torch.cuda.current_device() == 0


def test_router_measures_the_card_and_keeps_serving_groups_there(cuda, clean_plane):
    """The link-aware router measures the card in its child (an 8 KB put and
    get, well under ``LOCAL_LINK_S``), names the current card as its
    accelerator, and a kernel-backed harness on that card takes the shared
    router by default: every group it runs is counted on the card, none on
    the host."""
    from zeebe_tpu_torch.testing import EngineHarness
    from zeebe_tpu_torch.utils.device_link import BackendRouter, shared_router

    router = BackendRouter()
    accel = router.accel_device()
    assert router.enabled and accel == torch.device("cuda", torch.cuda.current_device())
    assert 0 < router.link_put_s and 0 < router.link_get_s
    assert router.link_cost_s() < BackendRouter.LOCAL_LINK_S
    assert router.choose(("t", 64, 64)) is accel
    shared = shared_router()
    before = (shared.host_groups, shared.accel_groups)
    h = EngineHarness(use_kernel_backend=True, device=cuda)
    try:
        backend = h.kernel_backend
        assert backend.router is shared
        _drive_waves(h, [W.one_task()], 300)
        assert shared.accel_device().index == (backend.device.index
                                               if backend.device.index is not None
                                               else torch.cuda.current_device())
        groups = backend.groups_processed
    finally:
        h.close()
    assert groups > 0
    assert shared.host_groups == before[0]
    assert shared.accel_groups - before[1] == groups


def test_grpc_front_on_the_card_answers_like_the_cpu(cuda, clean_plane):
    """The port's ``Gateway`` over a ``ClusterRuntime`` built with no device
    (the card) answers ``torch_gateway_flows``'s gRPC session as the same
    session does on ``device="cpu"``, with ``sharded_collect`` launched on
    the card; then a ``JobWorker`` over ``StreamActivatedJobs`` completes
    the instances a client creates there."""
    import threading

    from torch_gateway_flows import PORT, drive_grpc
    from zeebe_tpu_torch.client import JobWorker, ZeebeTpuClient
    from zeebe_tpu_torch.gateway import ClusterRuntime, Gateway
    from zeebe_tpu_torch.models.bpmn import to_bpmn_xml
    from zeebe_tpu_torch.testing import distributing_client

    A.reset_launch_counts()
    card = drive_grpc(PORT)
    launched = A.launch_counts()["sharded_collect"]
    cpu = drive_grpc(PORT, device="cpu")
    assert launched > 0
    assert card["responses"] == cpu["responses"]
    assert card["state"] == cpu["state"]

    runtime = ClusterRuntime(broker_count=1, partition_count=2)
    runtime.start()
    partitions = runtime.brokers["broker-0"].partitions.values()
    assert partitions and all(p.device.type == "cuda" for p in partitions)
    gateway = Gateway(runtime)
    gateway.start()
    client = distributing_client(ZeebeTpuClient(gateway.address), runtime)
    done = threading.Semaphore(0)

    def handler(job):
        done.release()
        return {"seen": job.variables["i"]}

    worker = None
    try:
        client.deploy_resource(("one_task.bpmn", to_bpmn_xml(W.one_task())))
        worker = JobWorker(client, "work_one_task", handler, stream_enabled=True).start()
        keys = [client.create_instance("one_task", variables={"i": i}).process_instance_key
                for i in range(20)]
        assert all(done.acquire(timeout=60) for _ in keys)
        assert all(k > 0 for k in keys)
    finally:
        if worker is not None:
            worker.stop()
        client.close()
        gateway.stop()
        runtime.stop()


def test_standalone_workers_shape_serves_on_the_card(cuda, tmp_path):
    """``python -m zeebe_tpu_torch.standalone --workers 3 --partitions 3
    --replication 3`` with no device argument: three worker processes, each
    with its own CUDA context on the card, serve 20 instances through a
    ``JobWorker``; every partition's leader counts kernel records on
    ``/cluster/status``; SIGTERM stops every process with exit code 0."""
    import os
    import time

    import grpc

    from zeebe_tpu_torch.client import JobWorker, ZeebeTpuClient
    from zeebe_tpu_torch.models.bpmn import to_bpmn_xml
    from zeebe_tpu_torch.standalone import _free_ports
    from zeebe_tpu_torch.testing import standalone_run as S

    kernels.load()  # built once here, not by three workers at once
    grpc_port, management = _free_ports(2)
    proc = S.StandaloneProcess(
        ["--workers", "3", "--partitions", "3", "--replication", "3",
         "--port", str(grpc_port), "--management-port", str(management)],
        tmp_path / "standalone", env=dict(os.environ, **S.completion_env(tmp_path / "done")))
    client = worker = None
    keys: list[int] = []
    try:
        proc.start()
        client = ZeebeTpuClient(f"127.0.0.1:{grpc_port}", credentials_provider=False)
        deadline = time.monotonic() + 240.0
        while True:
            assert proc.exited() is None, proc.log()[-3000:]
            try:
                if len(client.topology().brokers) == 3:
                    break
            except grpc.RpcError:
                pass
            assert time.monotonic() < deadline, proc.log()[-3000:]
            time.sleep(0.2)
        client.deploy_resource(("one_task.bpmn", to_bpmn_xml(W.one_task())))
        worker = JobWorker(client, "work_one_task", lambda job: {}, stream_enabled=True).start()
        while len(keys) < 20:
            try:
                keys.append(client.create_instance("one_task").process_instance_key)
            except grpc.RpcError as exc:  # the deployment reaching partitions 2 and 3
                assert exc.code() == grpc.StatusCode.NOT_FOUND and time.monotonic() < deadline
                time.sleep(0.05)
        while not set(keys) <= S.completed_keys(tmp_path / "done"):
            assert time.monotonic() < deadline, "the instances did not complete"
            time.sleep(0.1)
        while True:  # the workers push their rows once a second
            rows = S.StandaloneProcess.get(management, "/cluster/status")["brokers"]
            leaders = {int(pid): part.get("kernelCoverage", {}).get("kernelRecords", 0)
                       for row in rows for pid, part in row["partitions"].items()
                       if part["role"] == "leader"}
            if sorted(leaders) == [1, 2, 3] and min(leaders.values()) > 0:
                break
            assert time.monotonic() < deadline, rows
            time.sleep(0.5)
        worker.stop()
        worker = None
        client.close()
        client = None
        assert proc.stop() == 0, proc.log()[-3000:]
    finally:
        if worker is not None:
            worker.stop()
        if client is not None:
            client.close()
        survivors = proc.kill()
    assert survivors == []
    assert {k >> 51 for k in keys} == {1, 2, 3}


def test_soak_on_the_card_has_no_violations_and_kernel_records(cuda, tmp_path):
    """``run_soak(SoakConfig(rounds=2, traffic_per_round=8))`` with no
    device: the in-process cluster's leader on the card; both power-loss
    restarts recover within budget with no violation, every round's leader
    counts kernel records, and ``k_chunk`` was launched."""
    from zeebe_tpu_torch.testing import soak

    kernels.load()
    records = []

    class Counting(soak.SoakHarness):
        def _traffic_round(self, round_no: int) -> None:
            backend = self._leader().processor.kernel_backend
            before = backend.accounting.kernel_records
            super()._traffic_round(round_no)
            records.append(backend.accounting.kernel_records - before)

    A.reset_launch_counts()
    harness = Counting(soak.SoakConfig(rounds=2, traffic_per_round=8), directory=tmp_path)
    report = harness.run()
    assert report["violations"] == []
    assert report["restarts"] == 2 and report["withinBudget"]
    assert len(records) == 2 and min(records) > 0
    assert A.launch_counts()["run_collect"] > 0


# ---------------------------------------------------------------------------
# random graphs: the reference generator's seeds through every kernel path

RANDOM_SEEDS = RG.spread(8)


@pytest.mark.parametrize("seed", RANDOM_SEEDS)
def test_random_graph_paths_match_plain(cuda, seed):
    """One seed's graph, compiled as the kernel backend compiles it (host
    escapes as K_HOST): run_collect chunk by chunk with job waves on the
    fused chunk and the forced chain, and run_to_completion on the grid
    kernel with auto jobs on and off, byte-equal to the plain version."""
    tables, dt, state = RG.seed_group(seed, 64, cuda)
    got = RG.collect_paths(dt, tables, state, tables.kernel_config, 12, f"seed {seed}")
    assert got["chunks"] > 0 and got["steps"] > 0
    assert RG.completion_paths(dt, state, tables.kernel_config, 40, f"seed {seed}")["runs"] == 2


def test_random_graphs_as_shards_match_plain(cuda):
    """The eight seeds, one definition each, as eight shards: the sharded
    collect and step as one launch group and as 2 groups on cuda:0, byte-equal
    to their plain versions."""
    tables, dt, collect_state, step_state = RG.shard_block(RANDOM_SEEDS, 32, cuda, 8)
    first = torch.device("cuda", 0)
    got = RG.sharded_paths(dt, tables, collect_state, step_state, tables.kernel_config,
                           {"one group": [cuda], "2 groups": [first] * 2}, 12, 6, "block")
    assert got["chunks"] > 0 and got["steps"] == 6


@pytest.mark.parametrize("seed", RANDOM_SEEDS)
def test_random_tables_on_card_match_the_host_engine(cuda, seed):
    """batch_evaluate on the card (the lanes kernel) on a random table of the
    reference suite's generator gives the host DecisionEngine's results, but
    for the reference's own COLLECT COUNT difference."""
    case = RG.random_case(seed, 256)
    table = D.compile_decision_table(case.decision)
    RG.check_against_host(case, D.batch_evaluate(table, case.contexts, device=cuda))
