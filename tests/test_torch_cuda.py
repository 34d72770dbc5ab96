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

from zeebe_tpu_torch.engine import kernel_backend as kb
from zeebe_tpu_torch.models.bpmn import Bpmn, transform
from zeebe_tpu_torch.ops import automaton as A
from zeebe_tpu_torch.ops import kernels
from zeebe_tpu_torch.ops.tables import K_TASK, KernelConfig, compile_tables
from zeebe_tpu_torch.testing import workloads as W

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


@pytest.mark.parametrize("name,I,T", CASES)
def test_run_collect_waves_match_plain(cuda, name, I, T):
    tables, dt, state = _setup(name, I, T, seed=7, device=cuda)
    config = tables.kernel_config
    ks, ps = state, state
    for _ in range(12):
        ks, krows = A.run_collect(dt, ks, n_steps=8, config=config)
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


@pytest.mark.parametrize("sequential", [False, True])
def test_mi_bodies_match_plain(cuda, sequential):
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
        ks, krows = A.run_collect(dt, ks, n_steps=8, config=config)
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
    assert A.launch_counts() == {"step": 8, "run_collect": 1, "run_to_completion": 0}
    # one_task quiesces within the first block of steps: the host stops there
    A.run_to_completion(dt, state, max_steps=64, config=tables.kernel_config)
    A.run_collect_plain(dt, state, n_steps=8, config=tables.kernel_config)
    A.step_plain(dt, state, config=tables.kernel_config)
    assert A.launch_counts() == {"step": 8 + kernels.COMPLETION_BLOCK_STEPS,
                                 "run_collect": 1, "run_to_completion": 1}


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
