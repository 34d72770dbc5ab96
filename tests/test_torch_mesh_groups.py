"""The mesh as launch groups, on the CPU.

A mesh of several launch groups (``parallel/mesh.py``: each group a device
and a contiguous run of shard blocks) runs the sharded step and the
runner's sharded collect group by group, and sums the groups' counters
(``combine_groups``, the reference's psum). On the CPU every group runs the
plain version; the grouped step and the grouped runner are held byte for
byte against the JAX package's ``make_sharded_step`` and
``MeshKernelRunner`` on the conftest's 8 virtual CPU devices, and against
the one-group layout. The layout rules (``make_mesh``'s refusals, the
serving layout over cards, the broker's auto mode) are checked with the
card count faked, launching nothing.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import bench
from tests.test_torch_mesh import (
    XML,
    _assert_state_equal,
    _assert_steps_equal,
    _cases,
    _registries,
    _requests,
)
from zeebe_tpu.models.bpmn import to_bpmn_xml as ref_to_xml
from zeebe_tpu.ops import automaton as JA
from zeebe_tpu.parallel import mesh as JM
from zeebe_tpu.parallel import mesh_runner as JR
from zeebe_tpu_torch.broker import broker as B
from zeebe_tpu_torch.ops import automaton as TA
from zeebe_tpu_torch.parallel import mesh as TM
from zeebe_tpu_torch.parallel import mesh_runner as TR

CPU = torch.device("cpu")
N = 8  # shard blocks: the conftest's virtual devices
STEPS = 10

#: (name, devices): the one-group layout and groups of several sizes
LAYOUTS = [("one", None), ("2x4", [CPU] * 2), ("3-3-2", [CPU] * 3), ("8x1", [CPU] * 8)]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(devices):
    return TM.make_mesh(N, CPU) if devices is None else TM.make_mesh(N, devices=devices)


@pytest.fixture(scope="module")
def step_setup():
    """The JAX package's sharded trajectory over 8 devices: a mixed batch
    (one_task, fork_join, exclusive chain) stepped ``STEPS`` times, each
    step's state as host arrays."""
    ref, port = _registries([XML])
    I = 64
    def_of = (np.arange(I) % 3).astype(np.int32)
    slots = (np.arange(I * ref.tables.num_slots) % 50).astype(np.float64).reshape(
        I, ref.tables.num_slots)
    jstate = JM.shard_state(JA.make_state(ref.tables, I, def_of, initial_slots=slots,
                                          token_capacity=256, num_shards=N), JM.make_mesh(N))
    jstep = JM.make_sharded_step(JM.make_mesh(N), config=ref.tables.kernel_config)
    jdt = JA.DeviceTables.from_tables(ref.tables)
    trajectory = []
    for _ in range(STEPS):
        jstate = jstep(jdt, jstate)
        trajectory.append({k: np.asarray(v) for k, v in jstate.items()})
    start = TA.make_state(port.tables, I, def_of, initial_slots=slots, token_capacity=256,
                          num_shards=N, device="cpu")
    return port, start, trajectory


@pytest.mark.parametrize("name,devices", LAYOUTS, ids=[n for n, _ in LAYOUTS])
def test_grouped_sharded_step_equals_reference(step_setup, name, devices):
    port, start, trajectory = step_setup
    mesh = _mesh(devices)
    state = TM.shard_state({k: v.numpy() for k, v in start.items()}, mesh)
    assert isinstance(state, dict) == (devices is None)
    step = TM.make_sharded_step(mesh, config=port.tables.kernel_config)
    dt = TA.DeviceTables.from_numpy(port.tables, CPU)
    for k, expected in enumerate(trajectory):
        state = step(dt, state)
        _assert_state_equal(expected, TM.gather_state(state), f"{name} step {k}")
    if devices is not None:
        # the counters are replicated on every group, as the psum leaves them
        for group in state:
            for key in TM._REPLICATED_KEYS:
                assert torch.equal(group[key], state[0][key]) and group[key].dim() == 0


def test_grouped_step_carries_one_groups_overflow():
    """Group 0's shards hold fork_join in a pool the size of their instance
    block, the other groups one_task: only group 0 runs out of slots, and
    the combined flag (the OR over groups) carries it, as the JAX package's
    does over devices."""
    xml = ref_to_xml([bench.one_task(), bench.fork_join()])
    ref, port = _registries([xml])
    n, I = 4, 64
    def_of = np.zeros(I, np.int32)
    def_of[: I // n] = 1
    jstate = JM.shard_state(JA.make_state(ref.tables, I, def_of, token_capacity=I,
                                          num_shards=n), JM.make_mesh(n))
    mesh = TM.make_mesh(n, devices=[CPU] * 2)
    state = TM.shard_state({k: v.numpy() for k, v in TA.make_state(
        port.tables, I, def_of, token_capacity=I, num_shards=n, device="cpu").items()}, mesh)
    jstep = JM.make_sharded_step(JM.make_mesh(n), config=ref.tables.kernel_config)
    step = TM.make_sharded_step(mesh, config=port.tables.kernel_config)
    jdt = JA.DeviceTables.from_tables(ref.tables)
    dt = TA.DeviceTables.from_numpy(port.tables, CPU)
    for k in range(6):
        jstate = jstep(jdt, jstate)
        state = step(dt, state)
        _assert_state_equal(jstate, TM.gather_state(state), f"step {k}")
    assert bool(state[1]["overflow"]) and bool(TM.gather_state(state)["overflow"])
    assert bool(state[1]["done"].all())


@pytest.fixture(scope="module")
def runner_setup():
    ref, port = _registries([XML])
    cases = _cases(port.tables)
    jresults = JR.MeshKernelRunner(n_shards=N).run_groups(
        _requests(JR, ref, JA.DeviceTables.from_tables(ref.tables), cases))
    one = TR.MeshKernelRunner(mesh=TM.make_mesh(N, CPU)).run_groups(
        _requests(TR, port, port.device_tables_for(CPU), cases))
    return port, cases, jresults, one


@pytest.mark.parametrize("name,devices", LAYOUTS[1:], ids=[n for n, _ in LAYOUTS[1:]])
def test_grouped_runner_equals_reference_and_one_group(runner_setup, name, devices):
    port, cases, jresults, one = runner_setup
    runner = TR.MeshKernelRunner(mesh=_mesh(devices))
    results = runner.run_groups(_requests(TR, port, port.device_tables_for(CPU), cases))
    assert runner.dispatches == 1 and runner.coalesced_dispatches == 1
    for (case, *_), j, o, r in zip(cases, jresults, one, results):
        where = f"{name} {case}"
        _assert_steps_equal(j.steps, r.steps, where)
        assert (j.overflow, j.quiesced) == (r.overflow, r.quiesced), where
        _assert_steps_equal(o.steps, r.steps, where)
        assert (o.overflow, o.quiesced) == (r.overflow, r.quiesced), where
        assert o.state.keys() == r.state.keys()
        for key in o.state:
            assert np.array_equal(o.state[key], r.state[key]), (where, key)
    # the tables were replicated once per group's device, by fingerprint
    assert set(runner._tables) == {(port.tables_fingerprint, CPU)}


def test_combine_groups_plain_wraps_and_ors():
    """The cross-group sum: the input plus the groups' deltas, wrapping in
    int32 as the reference's psum does, and the OR of the flags."""
    base = {"transitions": torch.tensor(2**31 - 10, dtype=torch.int32),
            "jobs_created": torch.tensor(-5, dtype=torch.int32),
            "completed": torch.tensor(0, dtype=torch.int32)}
    rows = torch.tensor([[2**31 - 1, 7, 3, 0],
                         [-2**31 + 5, -5, -2**31, 0],
                         [2**31 - 10, 2**31 - 1, 9, 1]], dtype=torch.int32)
    out = TM.combine_groups_plain(rows, base)

    def wrapped(col, start):
        total = start + sum(int(r) - start for r in rows[:, col].tolist())
        return (total + 2**31) % 2**32 - 2**31

    assert int(out["transitions"]) == wrapped(0, 2**31 - 10)
    assert int(out["jobs_created"]) == wrapped(1, -5)
    assert int(out["completed"]) == wrapped(2, 0)
    assert all(out[k].dtype == torch.int32 and out[k].dim() == 0 for k in base)
    assert out["overflow"].dtype == torch.bool and bool(out["overflow"])
    rows[2, 3] = 0
    assert not bool(TM.combine_groups_plain(rows, base)["overflow"])
    # through the dispatcher, the groups' counters gathered as rows
    outs = [{"transitions": r[0], "jobs_created": r[1], "completed": r[2],
             "overflow": r[3] != 0} for r in rows]
    summed = TM.combine_groups(outs, base, CPU)
    assert all(torch.equal(summed[k], v) for k, v in
               TM.combine_groups_plain(rows, base).items())


def _fake_cards(monkeypatch, count: int) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


def test_make_mesh_refuses_bad_layouts(monkeypatch):
    _fake_cards(monkeypatch, 2)
    with pytest.raises(ValueError, match="devices are available"):
        TM.make_mesh(4, devices=["cuda:0", "cuda:2"])
    with pytest.raises(ValueError, match="a group needs a block"):
        TM.make_mesh(2, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="mix CPU and CUDA"):
        TM.make_mesh(4, devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="not both"):
        TM.make_mesh(4, "cpu", devices=["cpu"])
    with pytest.raises(ValueError, match="at least one device"):
        TM.make_mesh(4, devices=[])
    with pytest.raises(ValueError, match="at least one shard"):
        TM.make_mesh(0, devices=["cpu"])
    # contiguous, the first groups one block larger; a card may repeat
    mesh = TM.make_mesh(8, devices=["cuda:0", "cuda:1", "cuda", "cuda:1"])
    cards = [torch.device("cuda", i) for i in (0, 1, 0, 1)]
    assert mesh.groups == tuple(zip(cards, (2, 2, 2, 2)))
    assert TM.make_mesh(7, devices=["cpu"] * 3).bounds() == [(0, 3), (3, 5), (5, 7)]
    assert TM.make_mesh(devices=["cpu"] * 3).n_shards == 3
    one = TM.make_mesh(8, "cuda")
    assert one.groups == ((torch.device("cuda", 0), 8),) and one.device == one.devices[0]


@pytest.mark.parametrize("cards,shards,device,expected", [
    (1, 4, None, [("cuda:0", 4)]),
    (2, 3, None, [("cuda:0", 2), ("cuda:1", 1)]),
    (4, 3, "cuda", [("cuda:0", 1), ("cuda:1", 1), ("cuda:2", 1)]),
    (2, 3, "cuda:1", [("cuda:1", 3)]),
    (2, 3, "cpu", [("cpu", 3)]),
])
def test_card_mesh_has_one_group_per_card(monkeypatch, cards, shards, device, expected):
    """The serving layout (``MeshKernelRunner`` without a mesh, as the
    broker and ``ClusterRuntime`` build it from a shard count)."""
    _fake_cards(monkeypatch, cards)
    runner = TR.MeshKernelRunner(n_shards=shards, device=device)
    assert [(str(d), b) for d, b in runner.mesh.groups] == expected
    assert runner.n_shards == shards


@pytest.mark.parametrize("cards,groups", [(1, None), (2, [("cuda:0", 1), ("cuda:1", 1)]),
                                          (4, [("cuda:0", 1), ("cuda:1", 1),
                                               ("cuda:2", 1)])])
def test_broker_auto_mode_builds_one_group_per_card(monkeypatch, cards, groups):
    """The broker's own mesh runner in auto mode on a host of ``cards`` cards
    (the probe's count and torch's faked alike): none on one card, else one
    group of one block per card, up to the broker's partitions; nothing
    launches."""
    _fake_cards(monkeypatch, cards)
    monkeypatch.setattr(B, "_AUTO_DEVICE_COUNT", cards)
    broker = SimpleNamespace(cfg=B.BrokerCfg(partition_count=3, device=None),
                             _injected_mesh_runner=None, _owned_mesh_runner=None)
    runner = B.Broker._mesh_runner(broker)
    if groups is None:
        assert runner is None
    else:
        assert [(str(d), b) for d, b in runner.mesh.groups] == groups
        assert runner.dispatches == 0


def test_shard_state_splits_groups_and_gathers_back():
    _, port = _registries([XML])
    state = TA.make_state(port.tables, 48, np.zeros(48, np.int32), token_capacity=96,
                          num_shards=6, device="cpu")
    host = {k: v.numpy() for k, v in state.items()}
    # per-shard counter rows, as the runner keeps them
    host["transitions"] = np.arange(6, dtype=np.int32)
    mesh = TM.make_mesh(6, devices=[CPU] * 4)
    groups = TM.shard_state(host, mesh)
    assert [g["def_of"].shape[0] for g in groups] == [16, 16, 8, 8]
    assert [g["transitions"].tolist() for g in groups] == [[0, 1], [2, 3], [4], [5]]
    assert all(g["completed"].dim() == 0 for g in groups)
    back = TM.gather_state(groups)
    for key, value in host.items():
        assert np.array_equal(back[key].numpy(), value), key
    with pytest.raises(ValueError, match="multiple"):
        TM.shard_state(host, TM.make_mesh(5, devices=[CPU] * 2))
    with pytest.raises(ValueError, match="per-shard rows"):
        TM.shard_state(host, TM.make_mesh(3, devices=[CPU] * 2))
