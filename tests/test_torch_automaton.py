"""The port's plain PyTorch automaton against the JAX package's, on the CPU.

The same numpy inputs (tables compiled by the reference, states made from a
seed) go through ``zeebe_tpu.ops.automaton`` and ``zeebe_tpu_torch.ops.
automaton``; packed rows, states and events must be byte-equal int32 (and
bool): the tolerance is zero. The CUDA kernels are held against this plain
version on the card (tests/test_torch_cuda.py).
"""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from zeebe_tpu.engine.kernel_backend import _inline_mi_bodies
from zeebe_tpu.models.bpmn import Bpmn, transform
from zeebe_tpu.ops import automaton as JA
from zeebe_tpu.ops.tables import KernelConfig as RefKernelConfig
from zeebe_tpu.ops.tables import compile_tables, f64_key_planes
from zeebe_tpu_torch.ops import automaton as TA
from zeebe_tpu_torch.ops.tables import K_MI, K_TASK, KernelConfig

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# workloads (reference models)


def _branching():
    return (Bpmn.create_executable_process("branching").start_event("start")
            .exclusive_gateway("gw").condition_expression("x >= 20")
            .service_task("big", job_type="big").end_event("end_big")
            .move_to_element("gw").default_flow()
            .service_task("small", job_type="small").end_event("end_small").done())


def _nomatch():
    return (Bpmn.create_executable_process("nomatch").start_event("s")
            .exclusive_gateway("gw").condition_expression("x > 10")
            .end_event("e").done())


def _negated():
    return (Bpmn.create_executable_process("neg").start_event("s")
            .exclusive_gateway("gw").condition_expression("not(x > 10)")
            .service_task("low", job_type="low").end_event("e1")
            .move_to_element("gw").default_flow()
            .service_task("high", job_type="high").end_event("e2").done())


def _strings():
    return (Bpmn.create_executable_process("strs").start_event("s")
            .exclusive_gateway("gw").condition_expression('status = "active"')
            .end_event("a").move_to_element("gw")
            .condition_expression('status < "done" or -x > -3')
            .end_event("b").move_to_element("gw").default_flow()
            .end_event("c").done())


def _inclusive():
    return (Bpmn.create_executable_process("incl").start_event("s")
            .inclusive_gateway("gw").condition_expression("x > 5")
            .service_task("a", job_type="a").end_event("ea")
            .move_to_element("gw").condition_expression("x > 20")
            .service_task("b", job_type="b").end_event("eb")
            .move_to_element("gw").default_flow()
            .end_event("ec").done())


def _first_true():
    return (Bpmn.create_executable_process("first").start_event("s")
            .exclusive_gateway("gw").condition_expression("x > 1")
            .end_event("a").move_to_element("gw")
            .condition_expression("x > 2").end_event("b")
            .move_to_element("gw").default_flow().end_event("c").done())


def _scoped_join():
    """A fork/join inside an embedded sub-process: join arrivals wait inside
    the scope, so the scope's pending-arrival count (the reference's int32
    einsum) is non-zero while one branch lags."""
    return (Bpmn.create_executable_process("scoped_join").start_event("s")
            .sub_process("sub").start_event("is")
            .parallel_gateway("fork").service_task("a", job_type="a")
            .parallel_gateway("join").end_event("ie").move_to_element("fork")
            .service_task("b", job_type="b").service_task("b2", job_type="b2")
            .connect_to("join").sub_process_done()
            .end_event("e").done())


def _mi(sequential: bool):
    return (Bpmn.create_executable_process("mi_seq" if sequential else "mi_par")
            .start_event("s").service_task("t", job_type="w")
            .multi_instance(input_collection="= items", input_element="item",
                            sequential=sequential)
            .end_event("e").done())


WORKLOADS = {
    "one_task": lambda: [bench.one_task()],
    "exclusive_chain": lambda: [bench.exclusive_chain()],
    "fork_join": lambda: [bench.fork_join()],
    "ten_tasks": lambda: [bench.ten_tasks()],
    "subprocess_boundary": lambda: [bench.subprocess_boundary()],
    "mixed": bench.mixed_definitions,
    "branching": lambda: [_branching()],
    "nomatch": lambda: [_nomatch()],
    "negated": lambda: [_negated()],
    "strings": lambda: [_strings()],
    "inclusive": lambda: [_inclusive()],
    "first": lambda: [_first_true()],
    "scoped_join": lambda: [_scoped_join()],
    "mi_parallel": lambda: [_mi(False)],
    "mi_sequential": lambda: [_mi(True)],
}

_TABLES: dict[str, object] = {}


def _tables(name: str):
    t = _TABLES.get(name)
    if t is None:
        exes = []
        for model in WORKLOADS[name]():
            exe = transform(model)
            if name.startswith("mi_"):
                exe, _ = _inline_mi_bodies(exe)
            exes.append(exe)
        t = _TABLES[name] = compile_tables(exes)
    return t


def _token_capacity(tables, I: int) -> int:
    w = tables.token_width
    n = w * I if w > 0 else 4 * I
    p = 8
    while p < n:
        p *= 2
    return p


def _slot_planes(tables, I: int, rng) -> np.ndarray:
    """Seeded per-instance slot planes: numeric slots hold integer-valued
    floats, string slots a known literal's key or an unknown string's odd
    insertion-rank key."""
    S = tables.num_slots
    planes = np.zeros((I, S, 2), np.int32)
    id_to_name = {v: k for k, v in tables.slot_map.names.items()}
    n_lit = max(1, len(tables.interner.ids))
    for s in range(S):
        if tables.slot_map.kinds.get(id_to_name.get(s)) == "str":
            planes[:, s, 0] = rng.integers(-1, 2 * n_lit + 1, I)
        else:
            vals = rng.integers(-5, 40, I).astype(np.float64)
            planes[:, s] = [f64_key_planes(v) for v in vals]
    return planes


def _arrays(tables, I: int, T: int, seed: int) -> dict:
    """A fresh group state as numpy: one token per instance at its start
    event, seeded definitions and slots, MI cardinalities on K_MI rows."""
    rng = np.random.default_rng(seed)
    D, E = tables.kernel_op.shape
    def_of = rng.integers(0, D, I).astype(np.int32)
    elem = np.full(T, -1, np.int32)
    inst = np.zeros(T, np.int32)
    elem[:I] = tables.start_elem[def_of]
    inst[:I] = np.arange(I)
    mi_left = np.zeros((I, E), np.int32)
    mi_rows = tables.kernel_op[def_of] == K_MI
    mi_left[mi_rows] = rng.integers(1, 4, int(mi_rows.sum()))
    return {
        "elem": elem, "phase": np.zeros(T, np.int32), "inst": inst, "def_of": def_of,
        "var_slots": _slot_planes(tables, I, rng),
        "join_counts": np.zeros((I, E), np.int32), "mi_left": mi_left,
        "done": np.zeros(I, np.bool_), "incident": np.zeros(I, np.bool_),
        "transitions": np.zeros((), np.int32), "jobs_created": np.zeros((), np.int32),
        "completed": np.zeros((), np.int32), "overflow": np.zeros((), np.bool_),
    }


def _both(tables, arrays):
    js = {k: jnp.asarray(v) for k, v in arrays.items()}
    ts = TA.state_from_numpy(arrays, CPU)
    return (JA.DeviceTables.from_tables(tables), js,
            TA.DeviceTables.from_numpy(tables, CPU), ts)


def _assert_equal(ref: dict, port: dict) -> None:
    assert set(ref) == set(port)
    for k in ref:
        a = np.asarray(ref[k])
        b = port[k].numpy()
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        assert np.array_equal(a, b), f"{k} differs at {np.argwhere(a != b)[:5].tolist()}"


def _waiting(tables, state) -> np.ndarray:
    """Slots of tokens parked at a job-worker task (what a worker completes)."""
    phase = np.asarray(state["phase"])
    elem = np.asarray(state["elem"])
    def_of = np.asarray(state["def_of"])
    op = tables.kernel_op[def_of[np.asarray(state["inst"])], np.maximum(elem, 0)]
    return np.flatnonzero((phase == JA.PHASE_WAIT) & (elem >= 0) & (op == K_TASK))


def _collect_waves(tables, arrays, config, port_config, waves: int = 12):
    """Chunks of run_collect with a job-completion wave after each."""
    jdt, js, tdt, ts = _both(tables, arrays)
    for _ in range(waves):
        js, jrows = JA.run_collect(jdt, js, n_steps=8, config=config)
        ts, trows = TA.run_collect(tdt, ts, n_steps=8, config=port_config)
        jrows = np.asarray(jrows)
        assert jrows.dtype == np.int32
        assert np.array_equal(jrows, trows.numpy()), \
            f"rows differ at {np.argwhere(jrows != trows.numpy())[:5].tolist()}"
        _assert_equal(js, ts)
        jobs = _waiting(tables, js)
        if jobs.size:
            js = JA.complete_jobs(js, jobs)
            ts = TA.complete_jobs(ts, jobs)
    return js, ts


def _port_config(config) -> KernelConfig:
    return KernelConfig(**config.__dict__)


# (workload, instances, token capacity or None for the group rule)
CASES = [
    ("one_task", 64, None),
    ("exclusive_chain", 64, None),
    ("fork_join", 64, None),
    ("ten_tasks", 64, None),
    ("subprocess_boundary", 64, None),
    ("mixed", 64, None),
    ("mixed", 2048, None),
    ("branching", 64, None),
    ("nomatch", 64, None),
    ("negated", 64, None),
    ("strings", 64, None),
    ("inclusive", 64, None),
    ("scoped_join", 64, None),
    ("mi_parallel", 64, None),
    ("mi_sequential", 64, None),
    ("fork_join", 64, 64),  # pool too small for the fan-out: overflow
]


@pytest.mark.parametrize("name,I,T", CASES)
def test_run_collect_waves_byte_equal(name, I, T):
    tables = _tables(name)
    T = T or _token_capacity(tables, I)
    config = tables.kernel_config
    js, _ = _collect_waves(tables, _arrays(tables, I, T, seed=I + T), config,
                           _port_config(config))
    if name == "fork_join" and T == I:
        assert bool(js["overflow"])
    if name == "nomatch":
        assert bool(np.asarray(js["incident"]).any())


@pytest.mark.parametrize("name", ["one_task", "fork_join", "subprocess_boundary", "mixed",
                                  "nomatch", "scoped_join", "mi_parallel", "mi_sequential"])
def test_run_to_completion_byte_equal(name):
    tables = _tables(name)
    I = 64
    jdt, js, tdt, ts = _both(tables, _arrays(tables, I, _token_capacity(tables, I), seed=5))
    config = tables.kernel_config
    jf, jsteps = JA.run_to_completion(jdt, js, max_steps=64, config=config)
    tf, tsteps = TA.run_to_completion(tdt, ts, max_steps=64, config=_port_config(config))
    _assert_equal(jf, tf)
    assert tsteps.dtype == torch.int32 and int(jsteps) == int(tsteps)


@pytest.mark.parametrize("emit_events", [False, True])
@pytest.mark.parametrize("auto_jobs", [False, True])
@pytest.mark.parametrize("name", ["mixed", "scoped_join"])
def test_step_byte_equal(name, auto_jobs, emit_events):
    tables = _tables(name)
    jdt, js, tdt, ts = _both(tables, _arrays(tables, 64, _token_capacity(tables, 64), seed=9))
    config = tables.kernel_config
    for _ in range(10):
        js, jev = JA.step(jdt, js, auto_jobs=auto_jobs, emit_events=emit_events,
                          config=config)
        ts, tev = TA.step(tdt, ts, auto_jobs=auto_jobs, emit_events=emit_events,
                          config=_port_config(config))
        _assert_equal(js, ts)
        if emit_events:
            _assert_equal(jev, tev)
        else:
            assert jev is None and tev is None
        if not auto_jobs:
            jobs = _waiting(tables, js)
            js, ts = JA.complete_jobs(js, jobs), TA.complete_jobs(ts, jobs)


_TRAITS = ("has_joins", "has_conditions", "has_scopes", "has_mi")
_TRAIT_WORKLOADS = {"has_joins": "fork_join", "has_conditions": "branching",
                    "has_scopes": "subprocess_boundary", "has_mi": "mi_parallel"}


@pytest.mark.parametrize("flags", list(itertools.product([False, True], repeat=4)),
                         ids=lambda f: "".join("JCSM"[i] if v else "-" for i, v in enumerate(f)))
def test_config_combinations_byte_equal(flags):
    """Every KernelConfig flag combination, each on a table set whose traits
    are exactly those flags (one_task plus one workload per trait)."""
    exes = [transform(bench.one_task())]
    for trait, on in zip(_TRAITS, flags):
        if on:
            name = _TRAIT_WORKLOADS[trait]
            for model in WORKLOADS[name]():
                exe = transform(model)
                exes.append(_inline_mi_bodies(exe)[0] if name.startswith("mi_") else exe)
    tables = compile_tables(exes)
    config = RefKernelConfig(*flags)
    assert tables.kernel_config == config
    I = 64
    _collect_waves(tables, _arrays(tables, I, _token_capacity(tables, I), seed=3), config,
                   KernelConfig(*flags), waves=6)


@pytest.mark.parametrize("name", ["one_task", "mixed"])
def test_unneeded_flags_on_byte_equal(name):
    """Flags the tables do not need may be on: the machinery runs idle."""
    tables = _tables(name)
    I = 64
    _collect_waves(tables, _arrays(tables, I, _token_capacity(tables, I), seed=4),
                   RefKernelConfig(True, True, True, True),
                   KernelConfig(True, True, True, True), waves=4)


def test_complete_jobs_with_results_byte_equal():
    tables = _tables("branching")
    I = 16
    jdt, js, tdt, ts = _both(tables, _arrays(tables, I, _token_capacity(tables, I), seed=2))
    for _ in range(3):
        js, _ = JA.step(jdt, js, auto_jobs=False)
        ts, _ = TA.step(tdt, ts, auto_jobs=False)
    jobs = _waiting(tables, js)
    assert jobs.size
    slots = np.zeros(jobs.size, np.int32)
    floats = np.linspace(-3.5, 70.25, jobs.size)
    _assert_equal(JA.complete_jobs(js, jobs, slots, floats),
                  TA.complete_jobs(ts, jobs, slots, floats))
    planes = np.array([f64_key_planes(v) for v in floats], np.int64)
    _assert_equal(JA.complete_jobs(js, jobs, slots, planes),
                  TA.complete_jobs(ts, jobs, slots, planes))


@pytest.mark.parametrize("num_shards", [1, 2])
def test_make_state_byte_equal(num_shards):
    tables = _tables("mixed")
    rng = np.random.default_rng(0)
    def_of = rng.integers(0, tables.num_definitions, 32).astype(np.int32)
    slots = rng.uniform(-10, 10, (32, tables.num_slots))
    _assert_equal(JA.make_state(tables, 32, def_of, slots, 128, num_shards),
                  TA.make_state(tables, 32, def_of, slots, 128, num_shards, device="cpu"))


def test_state_from_numpy_rejects_wrong_dtypes():
    tables = _tables("one_task")
    arrays = _arrays(tables, 8, 8, seed=0)
    arrays["elem"] = arrays["elem"].astype(np.int64)
    with pytest.raises(ValueError):
        TA.state_from_numpy(arrays, CPU)


# ---------------------------------------------------------------------------
# the condition VM


_VM_OPS = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 15, 16], np.int32)


@pytest.mark.parametrize("seed", range(3))
def test_vm_random_programs_byte_equal(seed):
    """Random programs — including stack underflow and overflow, NOPs and
    retired opcodes, negative and out-of-range slot indices — evaluate the
    same on both VMs."""
    rng = np.random.default_rng(seed)
    C, N, S = 64, 512, 3
    ops = rng.choice(_VM_OPS, (C, 24)).astype(np.int32)
    ops[:, :2] = rng.choice([1, 2], (C, 2))  # most programs start with pushes
    args = rng.integers(-4, 8, (C, 24, 2)).astype(np.int32)
    special = np.array([0, -1, 1, 2**31 - 1, -(2**31)], np.int32)
    args[rng.random((C, 24, 2)) < 0.3] = rng.choice(special)
    slot_rows = rng.integers(-3, 4, (N, S, 2)).astype(np.int32)
    slot_rows[rng.random((N, S, 2)) < 0.2] = rng.choice(special)
    prog_ids = rng.integers(0, C, N).astype(np.int32)
    ref = jax.jit(JA._eval_conditions)(ops, args, prog_ids, slot_rows)
    port = TA._eval_programs(torch.from_numpy(ops), torch.from_numpy(args),
                             torch.from_numpy(prog_ids), torch.from_numpy(slot_rows))
    assert np.array_equal(np.asarray(ref), port.numpy())


# ---------------------------------------------------------------------------
# one regression test per exactness trap


def test_trap_shift_of_dead_token_elem():
    """``elem << 5`` of a dead token (elem = -1) packs as -32."""
    tables = _tables("one_task")
    jdt, js, tdt, ts = _both(tables, _arrays(tables, 8, 32, seed=0))
    _, jrows = JA.run_collect(jdt, js, n_steps=2)
    _, trows = TA.run_collect(tdt, ts, n_steps=2)
    assert np.array_equal(np.asarray(jrows), trows.numpy())
    col0 = trows[0, :-2].view(32, 2 + tables.out_target.shape[2])[:, 0]
    assert int(col0[31]) == -32


def test_trap_sentinel_writes_dropped():
    """Overflowing placements (dest == T) and the VM's NOP write are dropped,
    not raised: PyTorch index assignment would raise on them."""
    tables = _tables("fork_join")
    js, ts = _collect_waves(tables, _arrays(tables, 16, 16, seed=1), tables.kernel_config,
                            _port_config(tables.kernel_config), waves=3)
    assert bool(ts["overflow"])
    nop_first = np.zeros((1, 24), np.int32)
    nop_first[0, 1:3] = 1
    nop_first[0, 3] = 5
    args = np.zeros((1, 24, 2), np.int32)
    args[0, 1] = (7, 0)
    ref = jax.jit(JA._eval_conditions)(nop_first, args, np.zeros(1, np.int32), np.zeros((1, 1, 2), np.int32))
    port = TA._eval_programs(torch.from_numpy(nop_first), torch.from_numpy(args),
                             torch.zeros(1, dtype=torch.int32), torch.zeros((1, 1, 2), dtype=torch.int32))
    assert np.array_equal(np.asarray(ref), port.numpy())


def test_trap_int32_counters_wrap():
    """Sums and prefix sums come back int64 in PyTorch; the counters must
    stay int32 scalars and wrap as JAX's do."""
    tables = _tables("one_task")
    arrays = _arrays(tables, 64, 64, seed=0)
    arrays["transitions"] = np.array(2**31 - 5, np.int32)
    arrays["completed"] = np.array(2**31 - 1, np.int32)
    jdt, js, tdt, ts = _both(tables, arrays)
    jf, _ = JA.run_to_completion(jdt, js, max_steps=8)
    tf, _ = TA.run_to_completion(tdt, ts, max_steps=8)
    _assert_equal(jf, tf)
    assert tf["transitions"].dtype == torch.int32 and tf["transitions"].dim() == 0
    assert int(tf["transitions"]) < 0 and int(tf["completed"]) < 0


def test_trap_first_true_slot():
    """Routing takes the first true flow (argmax rejects bool in PyTorch)."""
    tables = _tables("first")
    arrays = _arrays(tables, 8, 8, seed=0)
    arrays["var_slots"][:, 0] = f64_key_planes(5.0)  # both conditions hold
    jdt, js, tdt, ts = _both(tables, arrays)
    for _ in range(2):
        js, jev = JA.step(jdt, js, emit_events=True)
        ts, tev = TA.step(tdt, ts, emit_events=True)
    _assert_equal(jev, tev)
    assert tev["take_mask"][0].tolist()[:3] == [True, False, False]



def test_trap_pend_without_integer_matmul():
    """The pending-arrival count inside scopes (the reference's int32
    einsum) is a broadcast multiply and sum; it must equal the reference
    while join arrivals wait inside a scope."""
    tables = _tables("scoped_join")
    jdt, js, tdt, ts = _both(tables, _arrays(tables, 8, _token_capacity(tables, 8), seed=0))
    saw_pending = False
    for _ in range(12):
        js, _ = JA.step(jdt, js, auto_jobs=True)
        ts, _ = TA.step(tdt, ts, auto_jobs=True)
        _, jpend = JA._scope_occupancy(jdt, js)
        _, tpend = TA._scope_occupancy(tdt, ts)
        assert np.array_equal(np.asarray(jpend), tpend.numpy())
        saw_pending = saw_pending or bool(tpend.any())
    assert saw_pending


def test_trap_neg_of_zero_stays_zero():
    """NEG of key(+0.0) keeps it; NEG of key(-0.0) and of other keys flips
    both planes, as the reference does."""
    zero = f64_key_planes(0.0)
    neg_zero_raw = (-1, -1)  # the raw order key of -0.0's bits
    rows = np.array([[zero], [neg_zero_raw], [f64_key_planes(2.5)],
                     [(0, 0)], [(2**31 - 1, -(2**31))]], np.int32)
    ops = np.zeros((1, 24), np.int32)
    ops[0, :4] = [2, 16, 1, 7]  # -v == +0.0
    args = np.zeros((1, 24, 2), np.int32)
    args[0, 2] = zero
    pids = np.zeros(len(rows), np.int32)
    ref = jax.jit(JA._eval_conditions)(ops, args, pids, rows)
    port = TA._eval_programs(torch.from_numpy(ops), torch.from_numpy(args),
                             torch.from_numpy(pids), torch.from_numpy(rows))
    assert np.array_equal(np.asarray(ref), port.numpy())
    assert bool(port[0]) and not bool(port[2])


def test_trap_join_tie_ranks():
    """Several arrivals at one (instance, join) in one step, beside
    non-join requests sharing the sentinel key: the ranks give the same
    completions as the reference's stable argsort."""
    tables = _tables("mixed")
    I = 64
    arrays = _arrays(tables, I, _token_capacity(tables, I), seed=6)
    arrays["def_of"][:] = [p.process_id for p in tables.definitions].index("mx_par3")
    arrays["def_of"][::3] = 0  # one_task instances beside them
    arrays["elem"][:I] = tables.start_elem[arrays["def_of"]]
    js, ts = _collect_waves(tables, arrays, tables.kernel_config,
                            _port_config(tables.kernel_config), waves=6)
    assert bool(np.asarray(js["done"]).all())
