"""The port's control plane, link-aware router and card probe.

The reference's own tests run on the port, their imports renamed (every
broker they build on the CPU; ``tests/torch_cluster_flows.py``): all of
``tests/test_control.py``, its CLI top view on the port's command line
(the multi-process worker's ingress coalescing runs since the worker
is ported); all of
``tests/test_device_link.py``; and the four router-bound flows of
``tests/test_device_faults.py``. Then the port's own: a group the router
sends to the host runs the plain version on a CPU backend and writes the
same log, counted in ``host_groups``, while on the card it is declined to
the sequential engine, but for the probes of a SUSPECT card, which cross
the device-fault seam on the card; a backend on the CPU never consults the card; the router measures a card it can see and stays off without one;
the control plane's routing actuator writes the shared router; and the
killable probe of the cards.
"""

from __future__ import annotations

import sys

import pytest
import torch

from torch_cluster_flows import case_id, reference_tests, run_on_the_port
from torch_kernel_flows import counters
from test_torch_engine import _log
from zeebe_tpu_torch.engine import kernel_backend as kb
from zeebe_tpu_torch.engine.device_health import reset_shared_device_health
from zeebe_tpu_torch.models.bpmn import Bpmn
from zeebe_tpu_torch.testing import EngineHarness
from zeebe_tpu_torch.utils import backend_probe as probe
from zeebe_tpu_torch.utils import device_link
from zeebe_tpu_torch.utils.device_link import BackendRouter

ROUTER_FLOWS = ("test_canary_pins_accelerator_past_quarantine_host_bias",
                "test_accel_device_none_when_routing_disabled",
                "test_routing_controller_biases_on_device_state",
                "test_routing_signals_stale_without_compile_telemetry")
CASES = (reference_tests("test_control")
         + reference_tests("test_device_link")
         + reference_tests("test_device_faults", only=lambda n: n in ROUTER_FLOWS))


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_reference_test_passes_on_the_port(case, tmp_path):
    run_on_the_port(case, tmp_path)


def test_cases_cover_the_reference_files():
    by_file = {}
    for case in CASES:
        by_file[case[0]] = by_file.get(case[0], 0) + 1
    assert by_file["test_device_link"] == 6 and by_file["test_device_faults"] == 4
    assert by_file["test_control"] >= 40
    # the CLI's top view runs on the port's command line too
    assert [c for c in CASES if c[2] == "test_top_renders_control_section"]


# ---------------------------------------------------------------------------
# routing on the kernel backend


@pytest.fixture(autouse=True)
def _clean_device_plane():
    kb.install_device_chaos(None)
    reset_shared_device_health()
    yield
    kb.install_device_chaos(None)
    reset_shared_device_health()


def _measured_router(link_s: float, cls=BackendRouter) -> BackendRouter:
    """A router whose link to a card is measured at ``link_s`` a transfer."""
    router = cls()
    router._measured = router.enabled = True
    router._accel, router._host = torch.device("cuda", 0), torch.device("cpu")
    router.link_put_s = router.link_get_s = link_s
    return router


class _CardRouter(BackendRouter):
    """Chooses the card for every group; the cost model still records."""

    def choose(self, bucket):
        return self._accel


def _one_task():
    return (Bpmn.create_executable_process("one_task").start_event("s")
            .service_task("t", job_type="w").end_event("e").done())


def _drive(h: EngineHarness, n: int = 6) -> None:
    h.deploy(_one_task())
    for i in range(n):
        h.create_instance("one_task", {"x": i})
    for job in h.activate_jobs("w", max_jobs=n):
        h.complete_job(job["key"])


def test_host_route_runs_the_plain_version_and_writes_the_same_log(tmp_path):
    """A router forced to the host (a slow link) sends every group to the
    CPU's plain version: the log and the backend's counters equal an
    unrouted backend's, and the router counts every group in
    ``host_groups``."""
    routed = EngineHarness(tmp_path / "routed", use_kernel_backend=True, device="cpu")
    plain = EngineHarness(tmp_path / "plain", use_kernel_backend=True, device="cpu")
    router = _measured_router(1.0)  # a link slower than LOCAL_LINK_S
    try:
        assert routed.kernel_backend.router is None  # the CPU backend's default
        routed.kernel_backend.router = router
        _drive(routed)
        _drive(plain)
        backend = routed.kernel_backend
        assert backend.groups_processed > 0
        assert _log(routed) == _log(plain)
        assert counters(backend) == counters(plain.kernel_backend)
        assert router.host_groups == backend.groups_processed and router.accel_groups == 0
        assert not router._host_ema and not router._accel_ema  # counts, no times
    finally:
        routed.close()
        plain.close()


def test_card_route_keeps_the_backends_device(tmp_path):
    """A group routed to the card runs on the backend's own device (here the
    CPU) and counts in ``accel_groups``; the backend feeds the router no
    times, so its cost model stays empty."""
    h = EngineHarness(tmp_path, use_kernel_backend=True, device="cpu")
    router = _measured_router(1e-5, _CardRouter)
    devices = []
    try:
        backend = h.kernel_backend
        backend.router = router
        start = backend._start_kernel

        def spy(pg):
            start(pg)
            devices.append(pg.dev)

        backend._start_kernel = spy
        _drive(h)
        assert router.accel_groups == backend.groups_processed > 0
        assert router.host_groups == 0
        assert set(devices) == {backend.device}
        assert not router._host_ema and not router._accel_ema
    finally:
        h.close()


def test_canary_pins_the_card_past_the_host_bias(tmp_path):
    """Under the quarantine posture (``route_threshold_s`` = inf) ordinary
    groups go to the host, but a canary group asks ``accel_device()`` and
    runs on the backend's device."""
    h = EngineHarness(tmp_path, use_kernel_backend=True, device="cpu")
    router = _measured_router(1e-5)
    router.route_threshold_s = float("inf")
    try:
        backend = h.kernel_backend
        backend.router = router
        h.deploy(_one_task())
        h.create_instance("one_task", {"x": 1})
        assert router.host_groups == backend.groups_processed == 1
        start = backend._start_kernel

        def spy(pg):
            pg.canary = True
            start(pg)

        backend._start_kernel = spy
        h.create_instance("one_task", {"x": 2})
        assert router.accel_groups == 1 and router.host_groups == 1
        assert backend.groups_processed == 2
    finally:
        h.close()


def _on_the_card(backend) -> None:
    """Make a CPU-built backend a card backend's likeness: a group the
    router sends to the host is declined before anything is dispatched."""
    backend.device = torch.device("cuda", 0)


def test_host_choice_on_the_card_declines_to_the_sequential_engine(tmp_path, monkeypatch):
    """On the card, a group the router sends to the host (a link slower
    than ``LOCAL_LINK_S``) is declined to the sequential engine: typed
    ``routed-host``, counted in ``host_groups`` and as a host reroute, the
    log the sequential engine's, and nothing dispatched (no plain version
    on the CPU)."""
    dispatched = []
    monkeypatch.setattr(kb, "_dispatch", lambda *a, **k: dispatched.append(a))
    routed = EngineHarness(tmp_path / "routed", use_kernel_backend=True, device="cpu")
    sequential = EngineHarness(tmp_path / "sequential")
    router = _measured_router(1.0)
    try:
        backend = routed.kernel_backend
        backend.router = router
        _on_the_card(backend)
        _drive(routed)
        _drive(sequential)
        assert _log(routed) == _log(sequential)
        assert not dispatched and backend.groups_processed == 0
        declined = backend.accounting.reasons.get("routed-host", 0)
        assert router.host_groups == declined == backend.health.host_reroutes > 0
        assert router.accel_groups == 0
    finally:
        routed.close()
        sequential.close()


def test_host_bias_on_the_card_lets_the_suspect_ladder_clear(tmp_path, monkeypatch):
    """Under the SUSPECT posture the routing controller biases every group
    host-ward; on the card those groups are declined, and each ticks the
    ladder's quiet window as the reference's host-routed groups do, so the
    ladder steps back to HEALTHY (and the canary still pins the card)."""
    monkeypatch.setattr(kb, "_dispatch", lambda *a, **k: pytest.fail("dispatched"))
    h = EngineHarness(tmp_path, use_kernel_backend=True, device="cpu")
    router = _measured_router(1e-5)
    router.route_threshold_s = float("inf")
    try:
        backend = h.kernel_backend
        backend.router = router
        _on_the_card(backend)
        health = backend.health
        health.cfg.suspect_clear_ms = 0
        health.note_fault("test-fault")
        assert health.state == "SUSPECT"
        h.deploy(_one_task())
        h.create_instance("one_task", {"x": 1})
        assert backend.accounting.reasons.get("routed-host") == router.host_groups == 1
        assert health.state == "HEALTHY"
        assert router.accel_device() is router._accel
    finally:
        h.close()


def test_a_suspect_card_biased_host_ward_is_probed_through_the_seam(tmp_path):
    """While SUSPECT, the routing controller biases every group host-ward,
    and on the card those groups are declined before the device-fault seam.
    One group per canary interval, the first an interval after SUSPECT
    latched, probes the card all the same: it runs on the card, through the
    seam, under forced shadow. A fault there escalates the ladder to
    QUARANTINED (whose canaries re-prove the card) instead of leaving it
    SUSPECT, and the failed probe's command runs on the sequential engine."""
    from zeebe_tpu_torch.testing.chaos_device import DeviceChaosController, DeviceFaultPlan

    chaos = DeviceChaosController(DeviceFaultPlan(seed=0, dispatch_fail_p=1.0))
    kb.install_device_chaos(chaos)
    probed = EngineHarness(tmp_path / "probed", use_kernel_backend=True, device="cpu")
    sequential = EngineHarness(tmp_path / "sequential")
    router = _measured_router(1e-5)
    router.route_threshold_s = float("inf")
    clock = [1000.0]
    try:
        backend = probed.kernel_backend
        backend.router = router
        _on_the_card(backend)
        dispatched = []
        begin = backend._begin_dispatch

        def spy(pg, dispatch):
            dispatched.append((pg.dev, pg.shadow))
            return begin(pg, dispatch)

        backend._begin_dispatch = spy
        health = backend.health
        health._clock = lambda: clock[0]
        health.cfg.canary_interval_ms = 5_000
        health.cfg.quarantine_faults = 2
        health.cfg.suspect_clear_ms = 10**9
        health.note_fault("test-fault")
        for h in (probed, sequential):
            h.deploy(_one_task())
            h.create_instance("one_task", {"x": 1})
        assert backend.accounting.reasons.get("routed-host") == router.host_groups == 1
        assert not dispatched and health.state == "SUSPECT"
        clock[0] += 5.0
        for h in (probed, sequential):
            h.create_instance("one_task", {"x": 2})
        assert dispatched == [(backend.device, True)] and router.accel_groups == 1
        assert chaos.counts["dispatch_fail"] == 1
        assert backend.accounting.reasons.get("device-dispatch-error") == 1
        assert health.state == "QUARANTINED"
        assert _log(probed) == _log(sequential)
    finally:
        probed.close()
        sequential.close()


def test_cpu_backend_never_consults_the_card(tmp_path, monkeypatch):
    """A backend asked for the CPU takes no router, so the shared router is
    never measured and nothing asks after a card."""
    def touched(*args, **kwargs):
        raise AssertionError("the CPU backend consulted the card")

    monkeypatch.setattr(device_link, "_shared", None)
    monkeypatch.setattr(device_link, "_measure_link_subprocess", touched)
    h = EngineHarness(tmp_path, use_kernel_backend=True, device="cpu")
    try:
        monkeypatch.setattr(torch.cuda, "is_available", touched)
        monkeypatch.setattr(torch.cuda, "current_device", touched)
        _drive(h)
        assert h.kernel_backend.router is None and h.kernel_backend.groups_processed > 0
        assert device_link._shared is None
    finally:
        h.close()


def test_backend_default_router_is_the_shared_one(tmp_path, monkeypatch):
    """Given a CUDA device, the backend takes the process-wide router (its
    default, as the reference's); the kernel library load is skipped here."""
    from zeebe_tpu_torch.ops import kernels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(kernels, "load", lambda: None)
    h = EngineHarness(tmp_path)
    try:
        backend = kb.KernelBackend(h.engine, device="cuda")
        assert backend.router is device_link.shared_router()
        assert kb.KernelBackend(h.engine, device="cuda", router=None).router is None
    finally:
        h.close()


# ---------------------------------------------------------------------------
# the router's measurement


def test_router_stays_off_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    router = BackendRouter()
    assert router.choose(("t", 64, 64)) is None and router.accel_device() is None
    assert router._measured and not router.enabled and router.stats()["link_put_ms"] is None


def test_router_measures_a_card_it_sees(monkeypatch):
    """With a card, the accelerator is the current CUDA device and the host
    the CPU; the link comes from the child's measurement of that card."""
    measured = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    monkeypatch.setattr(device_link, "_measure_link_subprocess",
                        lambda index: measured.append(index) or (2e-5, 3e-5))
    router = BackendRouter()
    assert router.accel_device() == torch.device("cuda", 2) and measured == [2]
    assert router.choose(("t", 64, 64)) is router._accel
    assert router._host == torch.device("cpu")
    stats = router.stats()
    assert stats["enabled"] and stats["link_put_ms"] == 0.02 and stats["link_get_ms"] == 0.03


def test_failed_link_measurement_leaves_routing_off(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(device_link, "_measure_link_subprocess", lambda index: None)
    router = BackendRouter()
    assert router.choose(("t", 64, 64)) is None and router.accel_device() is None


def test_link_child_fails_without_a_card():
    """The measurement's child needs the card; here it exits non-zero and
    the measurement is None."""
    assert device_link._measure_link_subprocess(0, timeout=120) is None


def test_control_plane_drives_the_shared_router(tmp_path, monkeypatch):
    """The broker's control plane wires the routing controller's actuator to
    the process-wide router: a host-ward step lands in
    ``route_threshold_s``."""
    from zeebe_tpu_torch.broker.broker import Broker, BrokerCfg
    from zeebe_tpu_torch.cluster.messaging import LoopbackNetwork
    from zeebe_tpu_torch.control import RoutingController

    monkeypatch.setattr(device_link, "_shared", None)
    broker = Broker(BrokerCfg(device="cpu"), LoopbackNetwork().join("broker-0"),
                    directory=tmp_path)
    try:
        routing = [c for c in broker.control.controllers if isinstance(c, RoutingController)]
        assert len(routing) == 1
        actuator = routing[0].actuators[0]
        assert actuator.apply(float("inf"), "device health SUSPECT") == 25.0  # max_step
        assert device_link.shared_router().route_threshold_s == 0.025
        assert actuator.read() == 25.0
    finally:
        broker.close()


# ---------------------------------------------------------------------------
# the killable probe of the cards


def _child(code: str) -> list[str]:
    return [sys.executable, "-c", code]


def test_probe_parses_the_childs_answer():
    res, diag = probe.probe_with_diagnostics(probe_cmd=_child("print('cuda', 4)"),
                                             use_cache=False)
    assert res == ("cuda", 4) and diag["outcome"] == "ok"


def test_probe_kills_a_wedged_child_at_its_deadline():
    res, diag = probe.probe_with_diagnostics(
        probe_cmd=_child("import time; time.sleep(60)"), timeout=1, use_cache=False)
    assert res is None and diag["outcome"] == "probe-killed" and diag["killed"]
    assert diag["elapsed_s"] < 10


@pytest.mark.parametrize("code,outcome", [("raise SystemExit(3)", "nonzero-exit"),
                                          ("print('no answer')", "unparseable-stdout")])
def test_probe_failures_are_verdicts(code, outcome):
    res, diag = probe.probe_with_diagnostics(probe_cmd=_child(code), use_cache=False)
    assert res is None and diag["outcome"] == outcome


def test_probe_caches_per_command_and_retries_reprobe(monkeypatch):
    cmd = _child("print('cuda', 2)")
    monkeypatch.setattr(probe, "_PROBE_CACHE", {})
    first, _ = probe.probe_with_diagnostics(probe_cmd=cmd)
    again, diag = probe.probe_with_diagnostics(probe_cmd=cmd)
    assert first == again == ("cuda", 2) and diag["cached"]
    log = []
    calls = []

    def flaky(cwd=None, timeout=None, use_cache=True):
        calls.append(use_cache)
        return (None if len(calls) < 2 else ("cuda", 1)), {"outcome": "x"}

    monkeypatch.setattr(probe, "probe_with_diagnostics", flaky)
    assert probe.probe_with_retries(attempts=3, backoff_s=0.0, log=log) == ("cuda", 1)
    assert calls == [False, False] and [d["attempt"] for d in log] == [1, 2]


def test_default_probe_child_answers_without_a_card(monkeypatch):
    """The default child (torch's view of the cards) answers ``cpu 1`` here,
    so no card is counted."""
    monkeypatch.setattr(probe, "_PROBE_CACHE", {})
    monkeypatch.delenv("ZEEBE_PROBE_CMD", raising=False)
    assert probe.probe_default_backend(timeout=120) == ("cpu", 1)
    assert probe.real_device_count(timeout=120) == 0
