"""The port's device path end to end, against the JAX package's, on the CPU.

BPMN XML → tables → group arrays → chunked ``run_collect`` with job waves →
per-instance traces (``cascade_ops``). The JAX side runs the reference's
``_build_group_arrays``, ``run_collect``, ``unpack_events`` and
``KernelBackend._cascade_ops`` (through stubs exposing what they read) on
the same XML and the same seeded instances. Also: intent parity with the
sequential engine, the port's import boundary, and its device rules.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from zeebe_tpu.engine.kernel_backend import KernelBackend
from zeebe_tpu.models.bpmn import Bpmn
from zeebe_tpu.models.bpmn import parse_bpmn_xml as ref_parse
from zeebe_tpu.models.bpmn import to_bpmn_xml as ref_to_xml
from zeebe_tpu.models.bpmn import transform as ref_transform
from zeebe_tpu.ops import automaton as JA
from zeebe_tpu.ops.tables import compile_tables as ref_compile
from zeebe_tpu.ops.tables import f64_key_planes
from zeebe_tpu.testing import EngineHarness
from zeebe_tpu_torch.engine import kernel_backend as kb
from zeebe_tpu_torch.ops import automaton as TA
from zeebe_tpu_torch.ops import kernels
from zeebe_tpu_torch.ops.parity import engine_intent_sequence, run_with_events
from zeebe_tpu_torch.ops.tables import K_TASK

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _group(tables, n: int, seed: int) -> list[dict]:
    """Seeded instance records: definition index and condition slots."""
    rng = np.random.default_rng(seed)
    out = []
    for idx in range(n):
        d = int(rng.integers(0, tables.num_definitions))
        slots = {name: f64_key_planes(float(rng.integers(0, 40)))
                 for name in tables.slot_map.names}
        out.append({"idx": idx, "definition": d, "slots": slots})
    return out


def _ref_drive(tables, records, max_group: int, chunk: int = 8):
    """The reference path: _build_group_arrays → run_collect chunks →
    unpack_events → _cascade_ops, with a job-completion wave after each
    quiescence."""
    insts = [SimpleNamespace(idx=r["idx"], info=SimpleNamespace(index=r["definition"],
                                                                exe=tables.definitions[r["definition"]]),
                             new=True, tokens=[], slots=dict(r["slots"]), join_counts={},
                             mi_left={}, mi_cards={}) for r in records]
    backend = SimpleNamespace(registry=SimpleNamespace(tables=tables), max_group=max_group,
                              _pow2=KernelBackend._pow2)
    arrays, I, T = KernelBackend._build_group_arrays(
        backend, [SimpleNamespace(inst=i) for i in insts])
    state = {k: jnp.asarray(v) for k, v in arrays.items()}
    state.update(incident=jnp.zeros(I, jnp.bool_), transitions=jnp.zeros((), jnp.int32),
                 jobs_created=jnp.zeros((), jnp.int32), completed=jnp.zeros((), jnp.int32),
                 overflow=jnp.zeros((), jnp.bool_))
    dt = JA.DeviceTables.from_tables(tables)
    FO = tables.out_target.shape[2]
    waves = []
    for _ in range(64):
        steps = []
        while True:
            state, packed = JA.run_collect(dt, state, n_steps=chunk, config=tables.kernel_config)
            flat = np.asarray(packed)
            assert not flat[:, -1].any(), "token overflow"
            quiesced = np.flatnonzero(flat[:, -2] == 0)
            keep = int(quiesced[0]) + 1 if quiesced.size else chunk
            rows = flat[:, :-2].reshape(chunk, T, 2 + FO)
            steps.extend(JA.unpack_events(rows[s], I) for s in range(keep))
            if quiesced.size:
                break
        waves.append({i.idx: KernelBackend._cascade_ops(backend, i, steps) for i in insts})
        elem = np.asarray(state["elem"])
        phase = np.asarray(state["phase"])
        inst = np.asarray(state["inst"])
        op = np.where(elem >= 0, tables.kernel_op[arrays["def_of"][inst], np.maximum(elem, 0)], 0)
        jobs = np.flatnonzero((elem >= 0) & (phase == JA.PHASE_WAIT) & (op == K_TASK))
        if jobs.size == 0:
            break
        state = JA.complete_jobs(state, jobs)
        elem = np.asarray(state["elem"])
        for i in insts:
            i.tokens = [SimpleNamespace(slot=int(s), elem_idx=int(elem[s]))
                        for s in np.flatnonzero((elem >= 0) & (inst == i.idx))]
    return arrays, waves, state


def _port_insts(records) -> list:
    return [kb.GroupInstance(idx=r["idx"], definition=r["definition"], slots=dict(r["slots"]))
            for r in records]


SLICES = {
    "mixed_small_bucket": (bench.mixed_definitions, 60, 64),
    "mixed_partition_bucket": (bench.mixed_definitions, 120, 2048),
    "subprocess_and_ten_tasks": (lambda: [bench.subprocess_boundary(), bench.ten_tasks(),
                                          bench.fork_join()], 50, 64),
}


@pytest.mark.parametrize("name", sorted(SLICES))
def test_slice_traces_equal_reference(name):
    models, n, max_group = SLICES[name]
    xml = ref_to_xml(models())
    ref_tables = ref_compile([ref_transform(m) for m in ref_parse(xml)])
    port_tables = kb.deploy([xml])
    records = _group(port_tables, n, seed=n)
    ref_arrays, ref_waves, ref_state = _ref_drive(ref_tables, records, max_group)

    insts = _port_insts(records)
    arrays, I, T = kb.build_group_arrays(port_tables, insts, max_group)
    for k, v in ref_arrays.items():
        assert v.dtype == arrays[k].dtype and np.array_equal(v, arrays[k]), k
    result = kb.drive_group(port_tables, TA.DeviceTables.from_numpy(port_tables, CPU),
                            _port_insts(records), device="cpu", max_group=max_group)
    assert result.waves == ref_waves
    for k, v in ref_state.items():
        assert np.array_equal(np.asarray(v), result.state[k].numpy()), k
    assert bool(result.state["done"][:n].all())
    assert int(result.state["completed"]) == n


def test_run_group_prefetch_gives_the_same_steps():
    tables = kb.deploy([ref_to_xml(bench.mixed_definitions())])
    insts = _port_insts(_group(tables, 40, seed=2))
    arrays, I, T = kb.build_group_arrays(tables, insts, 64)
    dt = TA.DeviceTables.from_numpy(tables, CPU)
    runs = [kb.run_group(dt, tables.kernel_config, kb.group_state(arrays, CPU), I, T,
                         chunk_steps=2, pipeline_chunks=p) for p in (False, True)]
    assert runs[0].fail_reason is None and runs[0].chunks_run > 2
    assert runs[0].chunks_run == runs[1].chunks_run
    for a, b in zip(runs[0].steps, runs[1].steps):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    for k in runs[0].state:
        assert torch.equal(runs[0].state[k], runs[1].state[k]), k


def test_run_group_reports_overflow():
    tables = kb.deploy([ref_to_xml([bench.fork_join()])])
    dt = TA.DeviceTables.from_numpy(tables, CPU)
    arrays, I, T = kb.build_group_arrays(tables, _port_insts(_group(tables, 64, seed=0)), 64)
    small = {k: (v[:I] if v.shape[:1] == (T,) else v) for k, v in arrays.items()}
    run = kb.run_group(dt, tables.kernel_config, kb.group_state(small, CPU), I, I)
    assert run.fail_reason == "token-overflow" and run.steps is None


# ---------------------------------------------------------------------------
# intent parity with the sequential engine (reference TestEngineParity)


def _one_task():
    return (Bpmn.create_executable_process("one_task").start_event("start")
            .service_task("task", job_type="work").end_event("end").done())


def _branching():
    return (Bpmn.create_executable_process("branching").start_event("start")
            .exclusive_gateway("gw").sequence_flow_id("to_big")
            .condition_expression("amount >= 100")
            .service_task("big", job_type="big-order").end_event("end_big")
            .move_to_element("gw").sequence_flow_id("to_small").default_flow()
            .service_task("small", job_type="small-order").end_event("end_small").done())


def _fork_join():
    return (Bpmn.create_executable_process("fj").start_event("s")
            .parallel_gateway("fork").service_task("a", job_type="a")
            .parallel_gateway("join").end_event("e").move_to_element("fork")
            .service_task("b", job_type="b").connect_to("join").done())


def _device_sequence(model, variables: dict | None = None, token_capacity=None):
    tables = kb.deploy([ref_to_xml([model])])
    slots = None
    if variables:
        slots = np.zeros((1, tables.num_slots))
        for name, v in variables.items():
            slots[0, tables.slot_map.names[name]] = v
    state = TA.make_state(tables, 1, np.zeros(1, np.int32), initial_slots=slots,
                          token_capacity=token_capacity, device="cpu")
    _, sequences = run_with_events(TA.DeviceTables.from_numpy(tables, CPU), tables, state)
    return sequences[0]


def _engine_sequence(tmp_path, model, pid, jobs, variables=None):
    harness = EngineHarness(tmp_path)
    try:
        harness.deploy(model)
        pi = harness.create_instance(pid, variables=variables)
        for jtype in jobs:
            job = harness.activate_jobs(jtype)
            harness.complete_job(job[0]["key"])
        return engine_intent_sequence(harness.exporter, pi)
    finally:
        harness.close()


def test_one_task_intents_match_engine(tmp_path):
    engine = _engine_sequence(tmp_path, _one_task(), "one_task", ["work"])
    device = _device_sequence(_one_task())
    # the process element's activation is host-wrapped instance creation
    assert [e for e in device if e[0] != "one_task"] == [e for e in engine if e[0] != "one_task"]
    assert device[-1] == engine[-1] == ("one_task", "ELEMENT_COMPLETED")


@pytest.mark.parametrize("amount", [150, 10])
def test_branching_intents_match_engine(tmp_path, amount):
    jtype = "big-order" if amount >= 100 else "small-order"
    engine = _engine_sequence(tmp_path, _branching(), "branching", [jtype],
                              variables={"amount": amount})
    device = _device_sequence(_branching(), {"amount": amount})
    assert [e for e in device if e[0] != "branching"] == \
        [e for e in engine if e[0] != "branching"]


def test_fork_join_intents_match_engine_per_element(tmp_path):
    """Parallel branches interleave differently (log order vs lock-step), so
    compare per-element subsequences."""
    engine = _engine_sequence(tmp_path, _fork_join(), "fj", ["a", "b"])
    device = _device_sequence(_fork_join(), token_capacity=8)

    def by_element(seq):
        out: dict[str, list[str]] = {}
        for elem, intent in seq:
            if elem != "fj":
                out.setdefault(elem, []).append(intent)
        return out

    assert by_element(engine) == by_element(device)
    assert device[-1] == engine[-1] == ("fj", "ELEMENT_COMPLETED")


# ---------------------------------------------------------------------------
# the import boundary and the device rules


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "zeebe_tpu")


def _import_offenders(tree: ast.AST) -> list[str]:
    """Every module an ``import`` or ``from ... import`` in the tree names
    that belongs to JAX or to the reference package; ``from zeebe_tpu import
    native`` names ``zeebe_tpu.native``."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                out += [f"{node.module}.{a.name}" for a in node.names]
    return out


@pytest.mark.parametrize("source,caught", [
    ("import jax", ["jax"]),
    ("import jax.numpy as jnp", ["jax.numpy"]),
    ("from jaxlib import xla_client", ["jaxlib.xla_client"]),
    ("def f():\n    from jax import profiler", ["jax.profiler"]),
    ("from zeebe_tpu import native as _native", ["zeebe_tpu.native"]),
    ("from zeebe_tpu import native, protocol", ["zeebe_tpu.native", "zeebe_tpu.protocol"]),
    ("import zeebe_tpu.protocol", ["zeebe_tpu.protocol"]),
    ("from zeebe_tpu.state.db import ZbDb", ["zeebe_tpu.state.db.ZbDb"]),
    ("from zeebe_tpu_torch import native", []),
    ("from . import native", []),
])
def test_import_check_names_what_it_rejects(source, caught):
    assert _import_offenders(ast.parse(source)) == caught


def test_port_imports_no_jax_and_no_reference_package():
    offenders = []
    for path in sorted((REPO / "zeebe_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        offenders += [f"{path.relative_to(REPO)}: {n}" for n in _import_offenders(tree)]
    assert offenders == []


_SLICE_SCRIPT = """
import sys
import numpy as np
from zeebe_tpu_torch.engine import kernel_backend as kb
from zeebe_tpu_torch.ops import automaton as A
from zeebe_tpu_torch.ops.tables import f64_key_planes
from zeebe_tpu_torch.testing import workloads as W

tables = kb.deploy([W.to_xml(W.mixed_definitions())])
insts = [kb.GroupInstance(idx=i, definition=i % tables.num_definitions,
                          slots={"x": f64_key_planes(float(i % 30))}) for i in range(24)]
result = kb.drive_group(tables, A.DeviceTables.from_numpy(tables, "cpu"), insts,
                        device="cpu", max_group=64)
assert bool(result.state["done"][:24].all())
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "zeebe_tpu"))
print("LOADED", loaded)
"""


def test_slice_runs_without_loading_jax():
    proc = subprocess.run([sys.executable, "-c", _SLICE_SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tables = kb.deploy([ref_to_xml([_one_task()])])
    arrays, I, T = kb.build_group_arrays(tables, [kb.GroupInstance(idx=0, definition=0)], 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.make_state(tables, 4, np.zeros(4, np.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.DeviceTables.from_numpy(tables)
    with pytest.raises(RuntimeError, match="CUDA"):
        kb.group_state(arrays)
    with pytest.raises(RuntimeError, match="CUDA"):
        kb.drive_group(tables, TA.DeviceTables.from_numpy(tables, CPU),
                       [kb.GroupInstance(idx=0, definition=0)])
    # the explicit CPU request is the only way onto the plain path
    assert TA.make_state(tables, 4, np.zeros(4, np.int32), device="cpu")["elem"].device == CPU


def test_kernel_build_failure_raises(monkeypatch, tmp_path):
    """No nvcc: the build raises; nothing falls back to the plain version."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(tmp_path / "no-cuda" / "nvcc"))
    with pytest.raises(kernels.KernelBuildError):
        kernels.build()
    assert not any((tmp_path / "build").iterdir())
