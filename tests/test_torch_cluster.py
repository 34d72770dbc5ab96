"""The port's replicated broker cluster writes the reference's logs, byte for
byte, on every replica: the flows of ``tests/test_broker_cluster.py`` and
the gateway's in-process runtime.

Each flow runs on the reference, on the port (its brokers on the CPU) and
on the port with the kernel backend off; every broker's replica logs and
its leaders' backend counters are held equal (``tests/torch_cluster_flows.py``).
``ClusterRuntime`` answers a deploy, create and complete flow through one
mesh runner of three shards as the reference's does. Also here: the
entry points run on CUDA unless given ``device="cpu"`` and raise without
it, and the auto mesh counts cards.
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from torch_cluster_flows import FLOWS, PORT, REF, call_test, check_flow, drive_runtime
from torch_kernel_flows import flow_id, flow_module, flows
from zeebe_tpu_torch.broker import broker as B
from zeebe_tpu_torch.cluster.messaging import LoopbackNetwork
from zeebe_tpu_torch.gateway import ClusterRuntime
from zeebe_tpu_torch.parallel import mesh_runner
from zeebe_tpu_torch.testing.election_sim import failover_ms

#: the file's two tests of the partition distribution (no cluster)
PURE = flows("test_broker_cluster", only=lambda src: "cluster" not in src.split("\n")[0]
             and "InProcessCluster(" not in src)


@pytest.mark.parametrize("flow", FLOWS, ids=flow_id)
def test_flow_matches_the_reference(flow, tmp_path):
    check_flow(flow, tmp_path)


def test_flows_cover_the_reference_file():
    assert len(FLOWS) == 10 and len(PURE) == 2


@pytest.mark.parametrize("flow", PURE, ids=flow_id)
def test_partition_distribution_on_the_port(flow, tmp_path):
    name, cls_name, method, fixtures = flow
    call_test(flow_module(name, PORT), cls_name, method, fixtures, tmp_path)


def test_runtime_answers_like_the_reference():
    """Deploy, 12 creations and every job's activation and completion
    through ``ClusterRuntime.submit``, one request at a time: the same
    responses (keys, intents, values but a job's wall-clock deadline), the
    same column families on every partition leader, no instance live, and
    the groups through the shared three-shard mesh runner on both."""
    ref = drive_runtime(REF)
    port = drive_runtime(PORT)
    assert len(port["responses"]) == len(ref["responses"]) > 12
    for i, (a, b) in enumerate(zip(ref["responses"], port["responses"])):
        assert a == b, f"response {i}"
    assert port["state"] == ref["state"]
    assert not any(s["live"] for s in port["state"].values())
    assert port["mesh"] == ref["mesh"] and port["mesh"][0] > 0


# ---------------------------------------------------------------------------
# the entry points' device


def test_entry_points_need_a_device_without_cuda(tmp_path, monkeypatch):
    """No device means CUDA: where CUDA is missing, the cluster, the runtime
    and a broker with the kernel backend raise; without the kernel backend,
    or on the CPU, they run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        B.InProcessCluster(broker_count=1, partition_count=1, replication_factor=1,
                           directory=tmp_path / "one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClusterRuntime(broker_count=1, partition_count=1, kernel_mesh_shards=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        B.Broker(B.BrokerCfg(), LoopbackNetwork().join("broker-0"),
                 directory=tmp_path / "two")
    for kwargs in ({"kernel_backend": False}, {"device": "cpu"}):
        cluster = B.InProcessCluster(broker_count=1, partition_count=1, replication_factor=1,
                                     **kwargs)
        try:
            cluster.await_leaders()
            backend = cluster.leader(1).processor.kernel_backend
            assert (backend is None) == (kwargs == {"kernel_backend": False})
            assert backend is None or backend.device == torch.device("cpu")
        finally:
            cluster.close()


def test_auto_device_count(monkeypatch):
    """1 on the CPU without a probe; on CUDA the probed card count, once per
    process; 0 when the probe fails or finds no card."""
    from zeebe_tpu_torch.utils import backend_probe

    probes = []

    def probe(result):
        def fake(*args, **kwargs):
            probes.append(result)
            return result
        return fake

    monkeypatch.setattr(B, "_AUTO_DEVICE_COUNT", None)
    monkeypatch.setattr(backend_probe, "probe_default_backend", probe(("cuda", 4)))
    assert B._auto_device_count(device="cpu") == 1 and probes == []
    assert B._auto_device_count() == 4 and B._auto_device_count(device="cuda") == 4
    assert probes == [("cuda", 4)]
    for result in (None, ("cpu", 1)):
        monkeypatch.setattr(B, "_AUTO_DEVICE_COUNT", None)
        monkeypatch.setattr(backend_probe, "probe_default_backend", probe(result))
        assert B._auto_device_count(device="cuda") == 0


@pytest.mark.parametrize("cards,shards", [(1, None), (2, 2), (4, 3)])
def test_auto_mesh_shards_over_two_or_more_cards(cards, shards, monkeypatch):
    """The broker's own mesh runner in auto mode: none on one card, else one
    shard per partition up to the cards, on the broker's device."""
    made = []

    class Runner:
        def __init__(self, n_shards=None, device=None) -> None:
            made.append((n_shards, device))

    monkeypatch.setattr(B, "_AUTO_DEVICE_COUNT", cards)
    monkeypatch.setattr(mesh_runner, "MeshKernelRunner", Runner)
    broker = SimpleNamespace(cfg=B.BrokerCfg(partition_count=3, device="cuda"),
                             _injected_mesh_runner=None, _owned_mesh_runner=None)
    runner = B.Broker._mesh_runner(broker)
    assert (runner is None) == (shards is None)
    assert made == ([] if shards is None else [(shards, "cuda")])
    cpu = SimpleNamespace(cfg=B.BrokerCfg(partition_count=3, device="cpu"),
                          _injected_mesh_runner=None, _owned_mesh_runner=None)
    assert B.Broker._mesh_runner(cpu) is None


def test_a_dead_leaders_followers_elect_within_one_election_timeout(tmp_path):
    """A follower whose timer fired grants the other's pre-vote: the first
    election after a leader's death starts when the second follower's timer
    fires (1,250-2,500 ms after the last heartbeat), not a timer later."""
    from zeebe_tpu_torch.cluster.raft import ELECTION_TIMEOUT_MS

    waits = sorted(failover_ms(tmp_path, seed) for seed in range(20))
    assert waits[len(waits) // 2] < ELECTION_TIMEOUT_MS, waits
    assert sum(w < ELECTION_TIMEOUT_MS + 500 for w in waits) >= 18, waits


@pytest.mark.parametrize("behind, delivery_ms", [(True, 10), (False, 200)],
                         ids=["a-follower-one-entry-behind", "messages-200ms-late"])
def test_a_dead_leaders_followers_elect_without_a_second_timer(tmp_path, behind, delivery_ms):
    """Under load a follower's log is often an entry behind the other's, and
    its pre-vote is denied; the member with the longer log then starts its
    pre-vote at once instead of at its next timer. Where messages are late,
    two followers can both win a pre-vote and split the vote; the one with
    the longer log, or the smaller member id, then runs the next election at
    once. Either way a new leader stands within one election timeout of the
    last heartbeat, not two (the reference's took up to 5 s)."""
    from zeebe_tpu_torch.cluster.raft import ELECTION_TIMEOUT_MS

    waits = [failover_ms(tmp_path, seed, behind, delivery_ms) for seed in range(20)]
    assert max(waits) <= ELECTION_TIMEOUT_MS + 2 * delivery_ms, waits
