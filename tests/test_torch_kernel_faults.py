"""The device-fault seam of the port's kernel backend, as the reference
handles it: a contained group declines and its head command runs on the
sequential engine; a shadow mismatch commits the host oracle's steps and
latches SUSPECT; the ladder hears one clean group per committed group.

The harness flows of ``tests/test_device_faults.py`` run on both packages
(``tests/torch_kernel_flows.py``). Its four flows of the link-aware router
and the control plane build no harness and run in
``tests/test_torch_control.py``:
``test_canary_pins_accelerator_past_quarantine_host_bias``,
``test_accel_device_none_when_routing_disabled``,
``test_routing_controller_biases_on_device_state`` and
``test_routing_signals_stale_without_compile_telemetry``. The tests after
the flows drive the port's harness alone, on the CPU.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from torch_kernel_flows import check_flow, flow_id, flows
from zeebe_tpu_torch.engine import kernel_backend as kb
from zeebe_tpu_torch.engine.device_health import (
    HEALTHY,
    SUSPECT,
    reset_shared_device_health,
    shared_device_health,
)
from zeebe_tpu_torch.models.bpmn import Bpmn
from zeebe_tpu_torch.ops import kernels
from zeebe_tpu_torch.testing import EngineHarness
from zeebe_tpu_torch.testing.chaos_device import (
    DeviceChaosController,
    DeviceChaosError,
    DeviceFaultPlan,
)

ROUTER_FLOWS = ("test_canary_pins_accelerator_past_quarantine_host_bias",
                "test_accel_device_none_when_routing_disabled",
                "test_routing_controller_biases_on_device_state",
                "test_routing_signals_stale_without_compile_telemetry")
FLOWS = flows("test_device_faults", only=lambda src: "EngineHarness(" in src, skip=ROUTER_FLOWS)


@pytest.mark.parametrize("flow", FLOWS, ids=flow_id)
def test_flow_matches_the_reference(flow, tmp_path):
    check_flow(flow, tmp_path)


def test_flows_are_the_harness_flows():
    assert len(FLOWS) == 13
    assert not {f[2] for f in FLOWS} & set(ROUTER_FLOWS)


# ---------------------------------------------------------------------------
# the port's harness alone


@pytest.fixture(autouse=True)
def _clean_device_plane():
    kb.install_device_chaos(None)
    reset_shared_device_health()
    yield
    kb.install_device_chaos(None)
    reset_shared_device_health()


def _models():
    one = (Bpmn.create_executable_process("one_task").start_event("start")
           .service_task("task", job_type="work").end_event("end").done())
    fork = (Bpmn.create_executable_process("fork_join").start_event("s")
            .parallel_gateway("fork").service_task("a", job_type="a")
            .parallel_gateway("join").end_event("e").move_to_element("fork")
            .service_task("b", job_type="b").connect_to("join").done())
    return one, fork


def _drive(h) -> None:
    h.deploy(*_models())
    for i in range(6):
        h.create_instance("one_task", {"n": i}, request_id=100 + i)
    h.create_instance("fork_join", request_id=200)
    for job_type in ("work", "a", "b"):
        for job in h.activate_jobs(job_type, max_jobs=20):
            h.complete_job(job["key"])


def _log(h) -> list:
    return [(v.position, v.source_position, v.processed, v.record.to_bytes())
            for v in h.stream.new_reader(1)]


def _kernel_run():
    h = EngineHarness(use_kernel_backend=True, device="cpu")
    try:
        _drive(h)
        return _log(h), h.kernel_backend
    finally:
        h.close()


@pytest.fixture(scope="module")
def sequential_log():
    h = EngineHarness()
    try:
        _drive(h)
        return _log(h)
    finally:
        h.close()


def test_dispatch_fault_runs_every_head_sequentially(sequential_log):
    kb.install_device_chaos(DeviceChaosController(
        DeviceFaultPlan(seed=1, dispatch_fail_p=1.0), "t"))
    log, backend = _kernel_run()
    assert log == sequential_log
    assert backend.groups_processed == 0 and backend.accounting.kernel_records == 0
    # every declined group is typed: contained, or rerouted once the
    # ladder quarantined the device
    reasons = {r for r in backend.accounting.reasons if not r.startswith("head-")}
    assert reasons == {"device-dispatch-error", "device-quarantined"}
    assert backend.health.state != HEALTHY


def test_wedge_runs_the_head_sequentially(sequential_log):
    health = shared_device_health()
    health.cfg.dispatch_timeout_ms = 50
    kb.install_device_chaos(DeviceChaosController(
        DeviceFaultPlan(seed=1, stall_p=1.0, stall_ms=150), "t"))
    log, backend = _kernel_run()
    assert log == sequential_log
    assert backend.accounting.reasons["device-wedged"] > 0
    assert backend.groups_processed == 0
    assert health.faults.get("device-wedged", 0) > 0


def test_shadow_mismatch_commits_the_oracles_steps(sequential_log, tmp_path):
    health = shared_device_health()
    health.cfg.shadow_sample_rate = 1.0
    controller = DeviceChaosController(DeviceFaultPlan(seed=2, corrupt_p=1.0, flips=4), "t")
    controller.ledger_file = str(tmp_path / "ledger.jsonl")
    kb.install_device_chaos(controller)
    log, backend = _kernel_run()
    assert log == sequential_log
    # quarantined groups still committed: on the oracle's steps
    assert backend.shadow_quarantined > 0
    assert backend.groups_processed > 0 and backend.accounting.kernel_records > 0
    assert health.shadow_mismatches == backend.shadow_quarantined
    assert health.state == SUSPECT or health.faults.get("shadow-mismatch")
    lines = [json.loads(line) for line in Path(controller.ledger_file).read_text().splitlines()]
    injected = {e["seq"] for e in lines if e["kind"] == "inject"}
    caught = {e["seq"]: e["how"] for e in lines if e["kind"] == "caught"}
    assert injected and injected == set(caught)
    assert "shadow" in caught.values()


def test_ladder_hears_one_clean_group_per_commit(monkeypatch, sequential_log):
    health = shared_device_health()
    health.cfg.shadow_sample_rate = 1.0
    notes = []
    real = health.note_group_ok
    monkeypatch.setattr(health, "note_group_ok", lambda: (notes.append(1), real())[1])
    log, backend = _kernel_run()
    assert log == sequential_log
    assert backend.groups_processed > 0 and len(notes) == backend.groups_processed
    assert health.shadow_checks >= backend.groups_processed
    assert health.shadow_mismatches == 0 and health.state == HEALTHY


def _failing_load(calls):
    def load():
        calls.append(1)
        raise kernels.KernelBuildError("nvcc automaton.cu failed (1)")
    return load


def test_backend_on_the_card_builds_its_kernels_at_construction(monkeypatch, tmp_path):
    """On the card the kernel library is built when the backend is made: a
    library that does not build fails the construction (and the harness),
    never a group that would then run on the host. On the CPU nothing is
    built."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(kernels, "load", _failing_load(calls))
    h = EngineHarness(tmp_path / "seq")
    try:
        with pytest.raises(kernels.KernelBuildError, match="automaton.cu"):
            kb.KernelBackend(h.engine, device="cuda")
        assert calls == [1]
        assert kb.KernelBackend(h.engine, device="cpu").device == torch.device("cpu")
        assert calls == [1]
    finally:
        h.close()
    with pytest.raises(kernels.KernelBuildError):
        EngineHarness(tmp_path / "kernel", use_kernel_backend=True, device="cuda")
    assert calls == [1, 1]


def _seam_group():
    return kb._DeviceRun(None, None, 1, 1, 8, 8, pipeline_chunks=False)


@pytest.mark.parametrize("exc", [
    kernels.KernelBuildError("nvcc failed"), ValueError("elem is on cpu"),
    TypeError("bad argument"), NotImplementedError("not ported"),
], ids=lambda e: type(e).__name__)
def test_seam_does_not_contain_program_faults(exc):
    """A library that does not build and an argument error are program
    faults: they leave the seam as raised, nothing is declined or noted."""
    defense = kb.DeviceDefense()
    pg = _seam_group()

    def dispatch():
        raise exc

    with pytest.raises(type(exc)):
        defense._begin_dispatch(pg, dispatch)
    assert not pg.failed and pg.fail_reason is None
    assert defense.health.faults == {}


@pytest.mark.parametrize("exc,reason", [
    (kernels.KernelLaunchError("k_chunk: CUDA error 719"), "device-dispatch-error"),
    (DeviceChaosError("dispatch_fail", "chaos: device dispatch exception"),
     "device-dispatch-error"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "device-dispatch-error"),
    (kb.DeviceWedgedError("fetch exceeded 50 ms"), "device-wedged"),
], ids=["launch", "chaos", "cuda-runtime", "wedge"])
def test_seam_contains_device_faults(exc, reason):
    """Launch and CUDA runtime errors, injected faults and wedges are
    device faults: the group is declined with a typed reason the ladder
    hears."""
    defense = kb.DeviceDefense()
    pg = _seam_group()

    def dispatch():
        raise exc

    assert defense._begin_dispatch(pg, dispatch) is None
    assert pg.failed and pg.fail_reason == reason
    assert defense.health.faults.get(reason) == 1
