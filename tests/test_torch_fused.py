"""The fused chunk's routing, on the CPU (no card needed).

The fused chunk (one thread-block cluster per shard, one launch per chunk)
and the chain (one launch per phase) compute the same function; which one a
call takes is a pure function of the shard's token slots (``choose_path``).
These tests hold the shape rule, the forcing keyword, the counters and the
CPU route; the card's tests (``test_torch_cuda.py``) hold both paths
byte-equal to the plain version.
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

from zeebe_tpu_torch.engine import kernel_backend as kb
from zeebe_tpu_torch.models.bpmn import transform
from zeebe_tpu_torch.ops import automaton as A
from zeebe_tpu_torch.ops import kernels
from zeebe_tpu_torch.ops.tables import compile_tables
from zeebe_tpu_torch.parallel import mesh as M
from zeebe_tpu_torch.parallel import mesh_runner as MR
from zeebe_tpu_torch.testing import workloads as W

CPU = torch.device("cpu")

SETS = {
    "one_task": lambda: [W.one_task()],
    "exclusive_chain": lambda: [W.exclusive_chain()],
    "fork_join": lambda: [W.fork_join()],
    "ten_tasks": lambda: [W.ten_tasks()],
    "subprocess_boundary": lambda: [W.subprocess_boundary()],
    "mixed": W.mixed_definitions,
}


def _forbid_binding(monkeypatch):
    """Every entry into the CUDA binding raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU route reached the CUDA binding")

    for name in ("load", "build", "allocate", "prepare", "launch_fused", "launch_steps",
                 "launch_prepare", "run_steps", "run_sharded_step", "run_until_quiet"):
        monkeypatch.setattr(kernels, name, refuse)


@pytest.mark.parametrize("name", sorted(SETS))
@pytest.mark.parametrize("n", [40, 2048])
def test_serving_buckets_take_the_fused_chunk(name, n):
    """Both shape buckets of every set: T by the group rule fits the fused
    chunk."""
    tables = compile_tables([transform(m) for m in SETS[name]()])
    insts = [kb.GroupInstance(idx=i, definition=i % tables.num_definitions) for i in range(n)]
    built = kb.build_group_arrays(tables, insts)
    assert built is not None
    _, I, T = built
    assert I == (64 if n <= 64 else kb.MAX_GROUP)
    assert kernels.choose_path(T) == "fused"


@pytest.mark.parametrize("T,path", [(8, "fused"), (8192, "fused"),
                                    (kernels.FUSED_MAX_TOKENS, "fused"),
                                    (kernels.FUSED_MAX_TOKENS + 1, "chain"),
                                    (1 << 17, "chain"), (1 << 20, "chain")])
def test_shape_rule(T, path):
    """The serving geometry and everything up to the threshold take the
    fused chunk; the kernel ceiling (I = T = 1<<20) takes the chain."""
    assert kernels.choose_path(T) == path


def test_shape_rule_is_pure(monkeypatch):
    """Decided from the shape alone, before any launch: no library, no
    device, the same answer every time."""
    _forbid_binding(monkeypatch)
    limit = kernels.FUSED_MAX_TOKENS
    answers = [kernels.choose_path(T) for T in (64, 8192, limit, 2 * limit, 1 << 20)] * 2
    assert answers == ["fused", "fused", "fused", "chain", "chain"] * 2
    assert kernels.PATHS == ("fused", "chain")


def test_path_keyword_is_checked():
    assert kernels._pick(None, 8192) == "fused"
    assert kernels._pick(None, 1 << 20) == "chain"
    assert kernels._pick("chain", 8192) == "chain"
    assert kernels._pick("fused", 1 << 20) == "fused"
    with pytest.raises(ValueError, match="path"):
        kernels._pick("graph", 8192)


def test_public_functions_do_not_take_the_path():
    """Only ``kernels.run_steps`` and ``kernels.run_sharded_step`` force a
    path; the public wrappers follow the shape rule."""
    for fn in (A.step, A.run_collect, A.run_to_completion, M.make_sharded_step):
        assert "path" not in inspect.signature(fn).parameters
    for fn in (kernels.run_steps, kernels.run_sharded_step):
        assert inspect.signature(fn).parameters["path"].default is None


def test_cpu_route_never_reaches_the_binding(monkeypatch):
    """CPU tensors take the plain versions of every wrapper, unsharded and
    sharded, and no counter moves."""
    _forbid_binding(monkeypatch)
    tables = compile_tables([transform(m) for m in W.mixed_definitions()])
    dt = A.DeviceTables.from_numpy(tables, CPU)
    config = tables.kernel_config
    rng = np.random.default_rng(3)
    I = 16
    def_of = rng.integers(0, tables.num_definitions, I).astype(np.int32)
    slots = rng.integers(0, 60, (I, tables.num_slots)).astype(np.float64)
    state = A.make_state(tables, I, def_of, initial_slots=slots, token_capacity=64,
                         device=CPU)
    A.reset_launch_counts()
    A.step(dt, state, config=config)
    A.step(dt, state, emit_events=True, config=config)
    A.run_collect(dt, state, n_steps=4, config=config)
    A.run_to_completion(dt, state, max_steps=4, config=config)
    sstate = A.make_state(tables, 2 * I, np.concatenate([def_of, def_of]),
                          initial_slots=np.concatenate([slots, slots]), token_capacity=128,
                          num_shards=2, device=CPU)
    M.make_sharded_step(M.make_mesh(2, CPU), config=config)(dt, sstate)
    cstate = dict(sstate)
    for k in M._REPLICATED_KEYS:
        cstate[k] = sstate[k].reshape(1).repeat(2)
    MR.MeshKernelRunner(mesh=M.make_mesh(2, CPU))._sharded_collect(4, config)(dt, cstate)
    assert all(v == 0 for v in A.launch_counts().values())
    assert all(v == 0 for v in A.grid_launch_counts().values())


def test_launch_counters_keep_their_keys():
    """``LAUNCHES`` keeps its six names (lock-steps and calls per kernel);
    grid launches are a counter of their own, and the reset clears both."""
    assert set(kernels.LAUNCHES) == {"step", "run_collect", "run_to_completion",
                                     "sharded_step", "sharded_collect", "decision"}
    assert set(kernels.GRID_LAUNCHES) == {"fused", "chain", "combine"}
    kernels.LAUNCHES["step"] = 3
    kernels.GRID_LAUNCHES["fused"] = 2
    counts = A.launch_counts()
    counts["step"] = 99
    assert kernels.LAUNCHES["step"] == 3 and A.grid_launch_counts()["fused"] == 2
    A.reset_launch_counts()
    assert set(A.launch_counts().values()) == {0}
    assert A.grid_launch_counts() == {"fused": 0, "chain": 0, "combine": 0}


def test_tables_struct_is_built_once_per_table_set():
    """The tables are validated and their struct built once per
    ``DeviceTables``; a replaced tensor rebuilds it, another device
    raises."""
    tables = compile_tables([transform(m) for m in W.mixed_definitions()])
    dt = A.DeviceTables.from_numpy(tables, CPU)
    first = kernels._tables_struct(dt, CPU)
    assert kernels._tables_struct(dt, CPU) is first
    assert (first.D, first.E, first.FO) == (tables.num_definitions, tables.max_elements,
                                            tables.out_target.shape[2])
    assert first.kernel_op == dt.kernel_op.data_ptr()
    dt.kernel_op = dt.kernel_op.clone()
    second = kernels._tables_struct(dt, CPU)
    assert second is not first and second.kernel_op == dt.kernel_op.data_ptr()
    with pytest.raises(ValueError, match="tables are on"):
        kernels._tables_struct(dt, torch.device("meta"))
    other = A.DeviceTables.from_numpy(tables, CPU)
    other.in_scope = other.in_scope.to(torch.int32)
    with pytest.raises(ValueError, match="in_scope"):
        kernels._tables_struct(other, CPU)


def test_ptxas_report_picks_the_kernel(monkeypatch, tmp_path):
    lib = tmp_path / "libzt_kernels_0.so"
    monkeypatch.setattr(kernels, "library_path", lambda: lib)
    kernels.ptxas_log_path(lib).write_text(
        "ptxas info    : Compiling entry function '_Z8k_placeX' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z8k_placeX\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 0 barriers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_17k_chunkE8ZtTables' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_17k_chunkE8ZtTables\n"
        "    352 bytes stack frame, 292 bytes spill stores, 548 bytes spill loads\n"
        "ptxas info    : Used 64 registers, used 1 barriers\n")
    lines = kernels.ptxas_report("k_chunk")
    assert len(lines) == 4
    assert lines[2].startswith("352 bytes stack frame")
    assert lines[3].startswith("ptxas info    : Used 64 registers")
    assert kernels.ptxas_report("k_missing") == []
