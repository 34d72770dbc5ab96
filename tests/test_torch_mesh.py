"""Partitions as shards: the port's mesh and mesh runner, on the CPU.

The sharded step's and the sharded collect's plain versions are held
byte-for-byte against the JAX package's ``make_sharded_step`` and
``MeshKernelRunner`` on the conftest's 8 virtual CPU devices, from the same
numpy inputs. The runner's own behaviour (coalescing, fingerprints, the
leader's exception path) and ``drive_groups_on_mesh`` against
``drive_group`` are held on the port alone.
"""

from __future__ import annotations

import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
from zeebe_tpu.engine.kernel_backend import KernelRegistry as RefRegistry
from zeebe_tpu.models.bpmn import Bpmn
from zeebe_tpu.models.bpmn import parse_bpmn_xml as ref_parse
from zeebe_tpu.models.bpmn import to_bpmn_xml as ref_to_xml
from zeebe_tpu.models.bpmn import transform as ref_transform
from zeebe_tpu.ops import automaton as JA
from zeebe_tpu.ops.tables import f64_key_planes
from zeebe_tpu.parallel import mesh as JM
from zeebe_tpu.parallel import mesh_runner as JR
from zeebe_tpu_torch.engine import kernel_backend as kb
from zeebe_tpu_torch.ops import automaton as TA
from zeebe_tpu_torch.parallel import mesh as TM
from zeebe_tpu_torch.parallel import mesh_runner as TR
from zeebe_tpu_torch.testing.catalog import ProcessCatalog

CPU = torch.device("cpu")


def _registries(resources):
    """The reference's and the port's registry over the same XML."""
    ref_catalog = ProcessCatalog()
    for xml in resources:
        for model in ref_parse(xml):
            ref_catalog.add(ref_transform(model))
    ref = RefRegistry()
    ref_catalog.register(ref)
    port = kb.KernelRegistry()
    ProcessCatalog.from_xml(resources).register(port)
    return ref, port


def _assert_state_equal(ref_state: dict, port_state: dict, where: str) -> None:
    for key, value in port_state.items():
        a, b = np.asarray(ref_state[key]), value.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (where, key)
        assert np.array_equal(a, b), (where, key)


# ---------------------------------------------------------------------------
# the sharded step (B6)


def _fork_join_tables():
    xml = ref_to_xml([bench.fork_join()])
    ref, port = _registries([xml])
    return ref.tables, port.tables


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_step_plain_equals_reference(n):
    ref_tables, tables = _fork_join_tables()
    jstate = JM.shard_state(JA.make_state(ref_tables, 64, np.zeros(64, np.int32),
                                          token_capacity=256, num_shards=n), JM.make_mesh(n))
    state = TA.make_state(tables, 64, np.zeros(64, np.int32), token_capacity=256,
                          num_shards=n, device="cpu")
    jstep = JM.make_sharded_step(JM.make_mesh(n))
    step = TM.make_sharded_step(TM.make_mesh(n, "cpu"))
    jdt = JA.DeviceTables.from_tables(ref_tables)
    dt = TA.DeviceTables.from_numpy(tables, CPU)
    for k in range(12):
        jstate = jstep(jdt, jstate)
        state = step(dt, state)
        _assert_state_equal(jstate, state, f"step {k}")
    assert bool(state["done"].all())


def test_sharded_matches_single_device():
    """The port of the reference's TestSharding: 12 sharded steps complete
    every instance with the single-device run's counters."""
    _, tables = _fork_join_tables()
    dt = TA.DeviceTables.from_numpy(tables, CPU)
    n = 8
    ref, _ = TA.run_to_completion(dt, TA.make_state(tables, 64, np.zeros(64, np.int32),
                                                    token_capacity=256, device="cpu"))
    state = TM.shard_state(TA.make_state(tables, 64, np.zeros(64, np.int32),
                                         token_capacity=256, num_shards=n, device="cpu"),
                           TM.make_mesh(n, "cpu"))
    step = TM.make_sharded_step(TM.make_mesh(n, "cpu"))
    for _ in range(12):
        state = step(dt, state)
    assert bool(state["done"].all())
    assert int(state["transitions"]) == int(ref["transitions"])
    assert int(state["completed"]) == int(ref["completed"])


def test_sharded_step_one_shard_overflows():
    """Shard 0 holds fork_join instances in a pool the size of its instance
    block, the other shards one_task: only shard 0 runs out of slots, and
    the combined flag (the OR over shards) carries it."""
    xml = ref_to_xml([bench.one_task(), bench.fork_join()])
    ref, port = _registries([xml])
    n, I = 4, 64
    def_of = np.zeros(I, np.int32)
    def_of[: I // n] = 1
    jstate = JM.shard_state(JA.make_state(ref.tables, I, def_of, token_capacity=I,
                                          num_shards=n), JM.make_mesh(n))
    state = TA.make_state(port.tables, I, def_of, token_capacity=I, num_shards=n,
                          device="cpu")
    jstep = JM.make_sharded_step(JM.make_mesh(n), auto_jobs=True,
                                 config=ref.tables.kernel_config)
    step = TM.make_sharded_step(TM.make_mesh(n, "cpu"), auto_jobs=True,
                                config=port.tables.kernel_config)
    jdt = JA.DeviceTables.from_tables(ref.tables)
    dt = TA.DeviceTables.from_numpy(port.tables, CPU)
    for k in range(6):
        jstate = jstep(jdt, jstate)
        state = step(dt, state)
        _assert_state_equal(jstate, state, f"step {k}")
    assert bool(state["overflow"])
    # the other shards ran to completion regardless
    assert bool(state["done"][I // n:].all())


# ---------------------------------------------------------------------------
# the runner (B7) against the reference's


XML = ref_to_xml([bench.one_task(), bench.fork_join(), bench.exclusive_chain()])
MAX_GROUP = 128


def _records(definition: int, n: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"idx": i, "definition": definition,
             "slots": {"x": f64_key_planes(float(rng.integers(0, 60)))}} for i in range(n)]


def _insts(records) -> list:
    return [kb.GroupInstance(idx=r["idx"], definition=r["definition"], slots=dict(r["slots"]))
            for r in records]


def _arrays(tables, records, tokens: int | None = None):
    """Group arrays; ``tokens`` cuts the token pool (a forced overflow)."""
    arrays, I, T = kb.build_group_arrays(tables, _insts(records), MAX_GROUP)
    if tokens is not None:
        for k in ("elem", "phase", "inst"):
            arrays[k] = np.ascontiguousarray(arrays[k][:tokens])
        T = tokens
    return arrays, I, T


def _cases(tables):
    """(name, arrays, I, T): one_task quiesces in the first chunk, the
    exclusive chain runs on past it (both in the small bucket, padded to the
    dispatch's), and fork_join overflows its cut pool."""
    return [
        ("quiet", *_arrays(tables, _records(0, 40, 1))),
        ("long", *_arrays(tables, _records(2, 30, 2))),
        ("overflow", *_arrays(tables, _records(1, MAX_GROUP, 3), tokens=MAX_GROUP)),
    ]


def _requests(module, registry, dt, cases, fingerprint=None, max_steps=64):
    return [module.GroupRequest(
        device_tables=dt, config=registry.tables.kernel_config,
        tables_fingerprint=fingerprint or registry.tables_fingerprint,
        arrays={k: v.copy() for k, v in arrays.items()}, num_instances=I, num_tokens=T,
        max_steps=max_steps, chunk_steps=8) for _, arrays, I, T in cases]


def _assert_steps_equal(a: list, b: list, where: str) -> None:
    assert len(a) == len(b), where
    for k, (x, y) in enumerate(zip(a, b)):
        assert x.keys() == y.keys(), (where, k)
        for key in x:
            assert x[key].shape == y[key].shape and np.array_equal(x[key], y[key]), \
                (where, k, key)


@pytest.fixture(scope="module")
def runner_setup():
    ref, port = _registries([XML])
    cases = _cases(port.tables)
    return ref, port, cases


def test_runner_equals_reference(runner_setup):
    ref, port, cases = runner_setup
    jresults = JR.MeshKernelRunner(n_shards=8).run_groups(
        _requests(JR, ref, JA.DeviceTables.from_tables(ref.tables), cases))
    runner = TR.MeshKernelRunner(mesh=TM.make_mesh(8, "cpu"))
    results = runner.run_groups(_requests(TR, port, port.device_tables_for(CPU), cases))
    assert runner.dispatches == 1 and runner.coalesced_dispatches == 1
    for (name, *_), j, p in zip(cases, jresults, results):
        _assert_steps_equal(j.steps, p.steps, name)
        assert (j.overflow, j.quiesced) == (p.overflow, p.quiesced), name
    by_name = {name: r for (name, *_), r in zip(cases, results)}
    # one partition's overflow does not mark the others
    assert by_name["overflow"].overflow
    assert not by_name["quiet"].overflow and not by_name["long"].overflow
    # one quiesces in its first chunk while another runs on
    assert len(by_name["quiet"].steps) <= 8 < len(by_name["long"].steps)
    assert by_name["quiet"].quiesced and by_name["long"].quiesced


def test_solo_coalesced_and_run_group_agree(runner_setup):
    _, port, cases = runner_setup
    dt = port.device_tables_for(CPU)
    same_geometry = cases[:2]  # quiet and long share their bucket
    runner = TR.MeshKernelRunner(mesh=TM.make_mesh(8, "cpu"))
    solo = [runner.run_groups(_requests(TR, port, dt, [c]))[0] for c in same_geometry]
    coalesced = runner.run_groups(_requests(TR, port, dt, same_geometry))
    assert runner.dispatches == 3 and runner.coalesced_dispatches == 1
    for (name, arrays, I, T), s, c in zip(same_geometry, solo, coalesced):
        _assert_steps_equal(s.steps, c.steps, name)
        run = kb.run_group(dt, port.tables.kernel_config, kb.group_state(arrays, CPU), I, T,
                           chunk_steps=8, max_steps=64)
        _assert_steps_equal(run.steps, s.steps, name)
        for key, value in run.state.items():
            assert np.array_equal(value.numpy(), s.state[key]), (name, key)


def test_threads_coalesce_with_batch_window(runner_setup):
    _, port, cases = runner_setup
    dt = port.device_tables_for(CPU)
    expected = TR.MeshKernelRunner(mesh=TM.make_mesh(8, "cpu")).run_groups(
        _requests(TR, port, dt, cases))
    runner = TR.MeshKernelRunner(mesh=TM.make_mesh(8, "cpu"), batch_window_s=0.5)
    requests = _requests(TR, port, dt, cases)
    results = [None] * len(requests)
    barrier = threading.Barrier(len(requests))

    def submit(k):
        barrier.wait(timeout=10)
        results[k] = runner.submit(requests[k])

    threads = [threading.Thread(target=submit, args=(k,)) for k in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert runner.groups_dispatched == 3 and runner.windows_slept >= 1
    assert runner.coalesced_dispatches >= 1 and runner.dispatches < 3
    for (name, *_), e, r in zip(cases, expected, results):
        _assert_steps_equal(e.steps, r.steps, name)
        assert (e.overflow, e.quiesced) == (r.overflow, r.quiesced)


def test_submit_stress_loses_no_group(runner_setup):
    """Many threads submitting at once, with a short switch interval: every
    submission gets its own group's result, and every group is dispatched
    exactly once."""
    _, port, cases = runner_setup
    dt = port.device_tables_for(CPU)
    expected = TR.MeshKernelRunner(mesh=TM.make_mesh(8, "cpu")).run_groups(
        _requests(TR, port, dt, cases[:2]))
    runner = TR.MeshKernelRunner(mesh=TM.make_mesh(8, "cpu"))
    n_threads, per_thread = 12, 3
    results: dict = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def submit(k):
            for j in range(per_thread):
                which = (k + j) % 2
                req = _requests(TR, port, dt, [cases[which]])[0]
                results[(k, j)] = (which, runner.submit(req))

        threads = [threading.Thread(target=submit, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == n_threads * per_thread
    assert runner.groups_dispatched == n_threads * per_thread
    for which, result in results.values():
        _assert_steps_equal(expected[which].steps, result.steps, str(which))


def test_adaptive_window_skips_when_idle(runner_setup):
    _, port, cases = runner_setup
    runner = TR.MeshKernelRunner(mesh=TM.make_mesh(8, "cpu"), batch_window_s=0.5,
                                 adaptive_window=True)
    runner.submit(_requests(TR, port, port.device_tables_for(CPU), cases[:1])[0])
    assert runner.windows_skipped == 1 and runner.windows_slept == 0


def test_separate_dispatches_per_fingerprint(runner_setup):
    _, port, cases = runner_setup
    dt = port.device_tables_for(CPU)
    a = _requests(TR, port, dt, cases[:1], fingerprint="a")
    b = _requests(TR, port, dt, cases[1:2], fingerprint="b")
    runner = TR.MeshKernelRunner(mesh=TM.make_mesh(8, "cpu"))
    results = runner.run_groups(a + b)
    assert runner.dispatches == 2 and runner.coalesced_dispatches == 0
    assert all(r.steps for r in results)


def test_more_groups_than_shards_take_several_dispatches(runner_setup):
    _, port, cases = runner_setup
    runner = TR.MeshKernelRunner(mesh=TM.make_mesh(2, "cpu"))
    results = runner.run_groups(_requests(TR, port, port.device_tables_for(CPU), cases))
    assert runner.dispatches == 2 and runner.groups_dispatched == 3
    assert [r.overflow for r in results] == [False, False, True]


def test_leader_exception_wakes_every_waiter(runner_setup, monkeypatch):
    _, port, cases = runner_setup
    runner = TR.MeshKernelRunner(mesh=TM.make_mesh(8, "cpu"), batch_window_s=0.5)

    def failing(requests):
        raise RuntimeError("device lost")

    monkeypatch.setattr(runner, "run_groups", failing)
    requests = _requests(TR, port, port.device_tables_for(CPU), cases)
    outcomes = [None] * len(requests)
    barrier = threading.Barrier(len(requests))

    def submit(k):
        barrier.wait(timeout=10)
        try:
            outcomes[k] = runner.submit(requests[k])
        except RuntimeError as exc:
            outcomes[k] = exc

    threads = [threading.Thread(target=submit, args=(k,)) for k in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    raised = [o for o in outcomes if isinstance(o, RuntimeError)]
    woken = [o for o in outcomes if isinstance(o, TR.GroupResult)]
    assert len(raised) == 1 and len(woken) == 2  # the leader re-raises
    assert all(o.steps is None for o in woken)
    # the runner is free again: the next submitter leads
    monkeypatch.undo()
    assert runner.submit(requests[0]).steps


def test_make_mesh_refuses_too_many_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="devices are available"):
        TM.make_mesh(8, "cuda:1")
    with pytest.raises(ValueError, match="at least one shard"):
        TM.make_mesh(0, "cpu")
    assert TM.make_mesh(8, "cpu").n_shards == 8


def test_make_mesh_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.make_mesh(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.MeshKernelRunner(n_shards=8)


def test_shard_state_places_and_checks_blocks():
    _, tables = _fork_join_tables()
    state = TA.make_state(tables, 64, np.zeros(64, np.int32), token_capacity=256,
                          num_shards=8, device="cpu")
    placed = TM.shard_state({k: v.numpy() for k, v in state.items()}, TM.make_mesh(8, "cpu"))
    assert all(torch.equal(placed[k], state[k]) for k in state)
    assert TM.state_specs()["elem"] == TM.BATCH_AXIS and TM.state_specs()["overflow"] is None
    with pytest.raises(ValueError, match="multiple"):
        TM.shard_state(state, TM.make_mesh(3, "cpu"))


# ---------------------------------------------------------------------------
# partitions end to end: drive_groups_on_mesh against drive_group


def _mi_and_call():
    mi = (Bpmn.create_executable_process("mesh_mi").start_event("s")
          .service_task("work", job_type="mw")
          .multi_instance(input_collection="= items", input_element="item")
          .end_event("e").done())
    child = (Bpmn.create_executable_process("mesh_child").start_event("cs")
             .service_task("ct", job_type="cw").end_event("ce").done())
    caller = (Bpmn.create_executable_process("mesh_caller").start_event("s")
              .call_activity("call", process_id="mesh_child").end_event("e").done())
    return [child, mi, caller]


def _partition_insts(registry, n: int, seed: int) -> list:
    """n fresh instances over the registry's definitions; a multi-instance
    body gets its predicted cardinality."""
    rng = np.random.default_rng(seed)
    infos = registry._infos
    names = registry.tables.slot_map.names
    out = []
    for idx in range(n):
        info = infos[int(rng.integers(0, len(infos)))]
        cards = {body: int(rng.integers(1, 4)) for body in info.mi_inner}
        x = f64_key_planes(float(rng.integers(0, 60)))
        out.append(kb.GroupInstance(
            idx=idx, definition=info.index, slots={"x": x} if "x" in names else {},
            mi_left=dict(cards), mi_cards=cards))
    return out


def _copy(insts) -> list:
    return [kb.GroupInstance(idx=i.idx, definition=i.definition, slots=dict(i.slots),
                             mi_left=dict(i.mi_left), mi_cards=dict(i.mi_cards))
            for i in insts]


@pytest.mark.parametrize("resources", ["mixed", "mi_and_call"])
def test_drive_groups_on_mesh_equals_drive_group(resources):
    xmls = ([ref_to_xml(bench.mixed_definitions())] if resources == "mixed"
            else [ref_to_xml([m]) for m in _mi_and_call()])
    partitions = []
    for p in range(3):
        registry = kb.KernelRegistry()
        ProcessCatalog.from_xml(xmls).register(registry)
        partitions.append((registry, _partition_insts(registry, 40, seed=p)))
    assert len({r.tables_fingerprint for r, _ in partitions}) == 1
    runner = TR.MeshKernelRunner(mesh=TM.make_mesh(4, "cpu"), batch_window_s=0.2)
    results = kb.drive_groups_on_mesh(runner, [(r, _copy(i)) for r, i in partitions],
                                      max_group=64)
    assert runner.coalesced_dispatches > 0
    for k, ((registry, insts), result) in enumerate(zip(partitions, results)):
        solo = kb.drive_group(registry.tables, registry.device_tables_for(CPU), _copy(insts),
                              device="cpu", max_group=64)
        assert result.waves == solo.waves, f"partition {k}"
        assert (result.steps, result.chunks) == (solo.steps, solo.chunks)
        for key, value in solo.state.items():
            assert torch.equal(value, result.state[key]), (k, key)
        assert bool(result.state["done"][:40].all())
    if resources == "mi_and_call":
        config = partitions[0][0].tables.kernel_config
        assert config.has_scopes and config.has_mi


def test_run_group_on_mesh_fail_reasons(runner_setup, monkeypatch):
    _, port, cases = runner_setup
    runner = TR.MeshKernelRunner(mesh=TM.make_mesh(8, "cpu"))
    by_name = {name: (arrays, I, T) for name, arrays, I, T in cases}
    run = kb.run_group_on_mesh(runner, port, *by_name["quiet"], chunk_steps=8, max_steps=64)
    assert run.fail_reason is None and run.steps and run.chunks_run == 1
    assert kb.run_group_on_mesh(runner, port, *by_name["overflow"], chunk_steps=8,
                                max_steps=64).fail_reason == "mesh-token-overflow"
    assert kb.run_group_on_mesh(runner, port, *by_name["long"], chunk_steps=8,
                                max_steps=8).fail_reason == "mesh-no-quiesce"
    monkeypatch.setattr(runner, "submit", lambda request: TR.GroupResult(steps=None))
    assert kb.run_group_on_mesh(runner, port, *by_name["quiet"]).fail_reason == \
        "mesh-dispatch-error"


def test_drive_groups_on_mesh_raises_a_partition_failure(runner_setup):
    _, port, _ = runner_setup
    runner = TR.MeshKernelRunner(mesh=TM.make_mesh(4, "cpu"))
    insts = [kb.GroupInstance(idx=i, definition=2) for i in range(4)]  # exclusive chain
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="mesh-no-quiesce"):
        kb.drive_groups_on_mesh(runner, [(port, insts)], max_steps=8, max_group=64)
    assert time.perf_counter() - t0 < 60


_MESH_SCRIPT = """
import sys
from zeebe_tpu_torch.engine import kernel_backend as kb
from zeebe_tpu_torch.parallel.mesh import make_mesh
from zeebe_tpu_torch.parallel.mesh_runner import MeshKernelRunner
from zeebe_tpu_torch.testing import workloads as W
from zeebe_tpu_torch.testing.catalog import ProcessCatalog

parts = []
for p in range(2):
    registry = kb.KernelRegistry()
    ProcessCatalog.from_xml([W.to_xml(W.mixed_definitions())]).register(registry)
    parts.append((registry, [kb.GroupInstance(idx=i, definition=i % 8) for i in range(16)]))
results = kb.drive_groups_on_mesh(MeshKernelRunner(mesh=make_mesh(2, "cpu")), parts,
                                  max_group=64)
assert all(bool(r.state["done"][:16].all()) for r in results)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "zeebe_tpu"))
print("LOADED", loaded)
"""


def test_mesh_path_runs_without_loading_jax():
    proc = subprocess.run([sys.executable, "-c", _MESH_SCRIPT],
                          cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout
