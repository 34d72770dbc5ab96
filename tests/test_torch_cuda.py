"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (the kernels have no CPU mode) and skips
without one. On a machine with a card, run them with

    pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest pins JAX, which the card's machine
does not have; these tests import neither JAX nor the JAX package.) Packed
rows, states and events must be byte-equal: the tolerance is zero.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from zeebe_tpu_torch.dmn import parse_dmn_xml
from zeebe_tpu_torch.engine import kernel_backend as kb
from zeebe_tpu_torch.engine.device_health import HEALTHY, SUSPECT, reset_shared_device_health
from zeebe_tpu_torch.ops import decision as D
from zeebe_tpu_torch.models.bpmn import Bpmn, transform
from zeebe_tpu_torch.ops import automaton as A
from zeebe_tpu_torch.ops import kernels
from zeebe_tpu_torch.ops.tables import K_TASK, KernelConfig, compile_tables
from zeebe_tpu_torch.parallel import mesh as M
from zeebe_tpu_torch.parallel import mesh_runner as MR
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
    tables, dt, state = _setup(name, I, T, seed=11, device=cuda)
    ks, ksteps = A.run_to_completion(dt, state, max_steps=100, config=tables.kernel_config)
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
    # one_task quiesces within the first block of steps: the host stops there
    A.run_to_completion(dt, state, max_steps=64, config=tables.kernel_config)
    A.run_collect_plain(dt, state, n_steps=8, config=tables.kernel_config)
    A.step_plain(dt, state, config=tables.kernel_config)
    assert A.launch_counts() == {"step": 8 + kernels.COMPLETION_BLOCK_STEPS,
                                 "run_collect": 1, "run_to_completion": 1,
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
        assert grid == {"fused": 6, "chain": 0, "combine": 0}
    else:
        assert grid == {"fused": 0, "chain": 6 * _chain_launches(config, 1, False),
                        "combine": 0}


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
    assert A.grid_launch_counts() == {"fused": 1, "chain": 0, "combine": 0}
    A.reset_launch_counts()
    kernels.run_steps(dt, state, 8, config, auto_jobs=False, emit_events=True,
                      mode="collect", path="chain")
    assert A.grid_launch_counts() == {"fused": 0, "chain": _chain_launches(config, 8, True),
                                      "combine": 0}
    # the same lock-step counts on both paths
    assert A.launch_counts()["step"] == 8
    stables, sdt, sstate = _sharded_state(3, cuda, False)
    A.reset_launch_counts()
    M.make_sharded_step(M.make_mesh(3, cuda), config=stables.kernel_config)(sdt, sstate)
    assert A.grid_launch_counts() == {"fused": 1, "chain": 0, "combine": 1}
    A.reset_launch_counts()
    A.run_to_completion(dt, state, max_steps=8, config=config)
    grid = A.grid_launch_counts()
    assert grid["fused"] == 0 and grid["chain"] > 0


def test_fused_resources(cuda):
    """The fused kernel launches 8-block clusters, and a mesh of 8 shards
    fits on the card at once."""
    res = kernels.fused_resources()
    assert res["registers"] > 0 and res["max_active_clusters"] >= 8
    lines = kernels.ptxas_report("k_chunk")
    assert any("registers" in line for line in lines)


# ---------------------------------------------------------------------------
# the decision kernel (csrc/decision.cu) against its plain version

_PLANES = np.array([-(2**31), -(2**31) + 1, -2, -1, 0, 1, 2, 2**31 - 2, 2**31 - 1], np.int32)


def _atoms(seed: int, N: int, I: int, R: int, K: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, (I, R, K)).astype(np.int32),
            rng.choice(_PLANES, (I, R, K, 2)), rng.choice(_PLANES, (I, R, K, 2)),
            rng.integers(0, 4, (I, R, K)).astype(np.int32),
            rng.choice(_PLANES, (N, I, 2)), rng.random((N, I)) < 0.8)


@pytest.mark.parametrize("N,I,R,K", [(1000, 2, 8, 4), (777, 3, 40, 2), (0, 2, 5, 3),
                                     (300, 1, 1, 1), (2048, 4, 512, 4), (513, 2, 33, 7),
                                     (256, 0, 9, 2), (256, 2, 9, 0)])
def test_decision_kernel_matches_plain(cuda, N, I, R, K):
    arrays = [torch.from_numpy(np.array(a)).to(cuda) for a in _atoms(N + R, N, I, R, K)]
    got = D.evaluate_batch(*arrays)
    want = D._evaluate_batch(*arrays)
    for name, a, b in zip(("m", "selected", "counts"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), f"{name} differs at {(a != b).nonzero()[:5].tolist()}"


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
