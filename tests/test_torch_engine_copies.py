"""The port's engine stack is the reference's, copied; what differs is named.

Every module of the engine stack (``testing/copies.py``'s ``ENGINE_STACK``)
equals ``as_copied`` of its reference. The journal, the tracer, the critical
path and the stream processor are partial copies (the checks of
``tests/test_torch_cluster_copies.py``): every reference member is in a
copied run or named in ``PORT_MEMBERS`` here. Every other file of the port
with a counterpart in the reference either equals it the same way or is
named in ``REWRITTEN`` with the reason; for the profiler's device half and
the harness (whose one addition is the kernel backend's ``device``) an AST
test holds every member they keep to the reference. Also here: the
kernel-backed harness needs a device where CUDA is missing, both harnesses
run without JAX, and the profiler's device half on ``torch.cuda`` (CPU
tests with fake devices and injected capture functions).
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_cluster_copies import (
    check_copied_runs,
    check_imports,
    check_member_plus_names,
    check_members_copied_or_named,
)
from test_torch_tables import as_copied
from zeebe_tpu_torch.observability import profiler as P
from zeebe_tpu_torch.testing import EngineHarness, MultiPartitionHarness, copies
from zeebe_tpu_torch.utils.metrics import REGISTRY

REPO = Path(__file__).resolve().parents[1]
REF = REPO / "zeebe_tpu"
PORT = REPO / "zeebe_tpu_torch"

# every port file with a reference counterpart that is not a copy, and why
REWRITTEN = {
    "__init__.py": "the port's own package docstring and layer map",
    "models/__init__.py": "docstring only (no DMN models in this package)",
    "ops/automaton.py": "the device program: plain PyTorch and the kernels' wrappers",
    "ops/decision.py": "host compiler copied; batch evaluation on torch and the kernel",
    "ops/parity.py": "step-event decoding on the port's packed rows",
    "parallel/mesh.py": "launch groups of shard blocks, each on one card",
    "parallel/mesh_runner.py": "one sharded dispatch of each launch group's blocks on its card",
    "engine/kernel_backend.py": "registry half and the backend's host members copied; "
                                "the device half and the backend's device members on torch",
    "observability/profiler.py": "device list, memory gauges and trace capture on torch.cuda",
    "testing/__init__.py": "the harness with the kernel backend's device",
    "utils/backend_probe.py": "the killable probe's child asks torch.cuda, not jax.devices()",
    "utils/device_link.py": "the router's card and host are torch devices; link timed on torch",
    "journal/journal.py": "partial copy: journal.flush at the flush's start, before its "
                          "listeners, with the journal's owner (PORT_MEMBERS here)",
    "observability/tracer.py": "partial copy: the span sites, the clock, the collections' hook "
                               "(PORT_MEMBERS here)",
    "observability/critical_path.py": "partial copy: a kernel group's device stage is two "
                                      "spans, dispatch and device (PORT_MEMBERS here)",
    "stream/processor.py": "partial copy: a kernel group's stage spans in sequence at their "
                           "real starts (PORT_MEMBERS here)",
    "broker/partition.py": "partial copy: the kernel backend's device, the stream journal's "
                           "owner (test_torch_cluster_copies)",
    "broker/broker.py": "partial copy: BrokerCfg.device, the card count (test_torch_cluster_copies)",
    "cluster/raft.py": "partial copy: a pre-vote drops the leader, the Raft log's owner "
                       "(test_torch_cluster_copies)",
    "gateway/broker_client.py": "partial copy: ClusterRuntime's device and peek, the submit's "
                                "lock wait (test_torch_cluster_copies)",
    "gateway/tcp_runtime.py": "partial copy: TcpClusterRuntime's device (test_torch_standalone)",
    "testing/chaos.py": "partial copy: ChaosHarness's device (test_torch_standalone)",
    "multiproc/supervisor.py": "partial copy: the workers' --device (test_torch_standalone)",
    "multiproc/worker.py": "partial copy: --device and the card guard (test_torch_standalone)",
    "multiproc/runtime.py": "partial copy: leader routing by term (test_torch_standalone)",
    "standalone.py": "partial copy: --device and the card guard (test_torch_standalone)",
    "testing/soak.py": "partial copy: the chaos harness's device (test_torch_gates)",
    "testing/scale_soak.py": "partial copy: the chaos harness's device (test_torch_gates)",
    "testing/consistency.py": "partial copy: the workers' --device (test_torch_gates)",
    "testing/torture.py": "partial copy: the workers' --device (test_torch_gates)",
    "testing/device_chaos.py": "partial copy: the workers' --device (test_torch_gates)",
    "testing/serving.py": "partial copy: the workers' --device (test_torch_gates)",
    "testing/fleetday.py": "partial copy: the workers' --device (test_torch_gates)",
    "testing/autotune.py": "partial copy: the workers' --device (test_torch_gates)",
    "cli.py": "partial copy: metrics-doc's --device, the port's documents (test_torch_zlint)",
    "analysis/__init__.py": "partial copy: the port's docstring (test_torch_zlint)",
    "analysis/framework.py": "partial copy: the port's tree and baseline (test_torch_zlint)",
    "analysis/knobs.py": "partial copy: the kernel backend's knob note (test_torch_zlint)",
    "analysis/rules.py": "partial copy: rules 2 and 8 on torch (test_torch_zlint)",
    "analysis/eligibility_notes.py": "a copy with the port's paths (test_torch_zlint)",
}


#: the port's members of each partial copy of the engine stack outside its
#: copied runs: the names the port adds to the reference's member, or the
#: reason it is rewritten whole
PORT_MEMBERS = {
    "journal/journal.py": {
        # the (partition, member) named on the journal's flush spans
        ("SegmentedJournal", "__init__"): {"owner"},
        ("SegmentedJournal", "flush"):
            "the reference's, with the journal.flush span starting at the flush's start, "
            "emitted before the flush listeners run and naming the journal's owner",
    },
    "observability/tracer.py": {
        ("Tracer", "enable"): "the reference's, and the collections' hook installed",
        ("Tracer", "disable"): "the reference's, and the collections' hook removed",
    },
    "observability/critical_path.py": {
        (None, "_STAGE_EDGE"): "the reference's, and the first chunk's dispatch (the device "
                               "stage's first span) charged to the device",
    },
    "stream/processor.py": {
        # the stashed speculation's admission start, while tracing is on
        ("StreamProcessor", "__init__"): {"_spec_begun_at"},
        ("StreamProcessor", "process_available_batch"):
            "the reference's, stamping each stage's start while tracing is on",
        ("StreamProcessor", "_trace_group"):
            "the group's and the stages' spans at their real starts, in sequence (the first "
            "chunk's dispatch a stage of its own); overlap an attribute; the collections' "
            "spans drained",
    },
}
#: imports a partial copy of the engine stack adds to the reference's
ADDED_IMPORTS = {
    "journal/journal.py": {
        "from zeebe_tpu_torch.observability.host_spans import clock_offset_us"},
    "observability/tracer.py": {"from zeebe_tpu_torch.observability import host_spans"},
    "observability/critical_path.py": set(),
    "stream/processor.py": {
        "from zeebe_tpu_torch.observability.host_spans import clock_offset_us, drain_gc"},
}
PARTIAL = sorted(PORT_MEMBERS)
EXTENDED = [(path, scope, name) for path in PARTIAL
            for (scope, name), names in PORT_MEMBERS[path].items() if isinstance(names, set)]


@pytest.mark.parametrize("path", copies.ENGINE_STACK)
def test_engine_stack_module_is_a_copy(path):
    ref = (REF / path).read_text()
    port = (PORT / path).read_text()
    assert port == as_copied(ref)


@pytest.mark.parametrize("path", PARTIAL)
def test_engine_copied_runs_are_the_scripts(path):
    check_copied_runs(path)


@pytest.mark.parametrize("path", PARTIAL)
def test_engine_member_is_copied_or_named(path):
    check_members_copied_or_named(path, PORT_MEMBERS[path])


@pytest.mark.parametrize("path", PARTIAL)
def test_engine_imports_are_the_references_plus_the_named(path):
    check_imports(path, ADDED_IMPORTS[path])


@pytest.mark.parametrize("path,scope,name", EXTENDED,
                         ids=[f"{p}:{s or 'module'}.{n}" for p, s, n in EXTENDED])
def test_engine_member_is_the_references_plus_the_names(path, scope, name):
    check_member_plus_names(path, scope, name, PORT_MEMBERS[path][(scope, name)])


def test_only_the_named_files_differ():
    differ = []
    for path in sorted(PORT.rglob("*")):
        rel = path.relative_to(PORT).as_posix()
        if path.is_dir() or "__pycache__" in path.parts or path.suffix == ".so":
            continue
        ref = REF / rel
        if ref.exists() and path.read_text() != as_copied(ref.read_text()):
            differ.append(rel)
    assert differ == sorted(REWRITTEN)


def test_copy_script_has_nothing_to_write(capsys):
    assert copies.main(["--check"]) == 0
    assert capsys.readouterr().out == ""


def test_copy_script_renames_like_the_test():
    text = ('"""See zeebe_tpu/state/db.py."""\n'
            "from zeebe_tpu import native\nfrom zeebe_tpu.state import db\n")
    assert copies.as_copied(text) == as_copied(text)
    assert as_copied(text) == ('"""See zeebe_tpu/state/db.py."""\n'
                               "from zeebe_tpu_torch import native\n"
                               "from zeebe_tpu_torch.state import db\n")


def test_copy_script_drops_tags_broken_over_lines():
    text = ("    # the black box (ISSUE\n    # 13): one event\n"
            '    """Batched ingress (the window, ISSUE\n    12): same gates (PR 4)."""\n')
    assert copies.as_copied(text) == as_copied(text) == (
        "    # the black box: one event\n"
        '    """Batched ingress (the window): same gates."""\n')


# ---------------------------------------------------------------------------
# the rewritten files keep the reference's other members


def _top_level(text: str) -> dict[str, ast.AST]:
    """Name -> node of each top-level definition and assignment; the
    imports as one entry."""
    out: dict[str, ast.AST] = {"<imports>": []}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out["<imports>"].append(node)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = node
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out[node.target.id] = node
    return out


def _dump(node) -> str:
    if isinstance(node, str):
        return node
    if isinstance(node, list):
        return "\n".join(ast.dump(n) for n in node)
    return ast.dump(node)


def _members(cls: ast.ClassDef) -> dict[str, ast.AST]:
    """A class body by member name; its docstring as ``<doc>``."""
    out = {}
    for m in cls.body:
        if isinstance(m, ast.Expr) and isinstance(m.value, ast.Constant):
            out["<doc>"] = m
        elif isinstance(m, ast.Assign):
            out[ast.unparse(m.targets[0])] = m
        else:
            out[getattr(m, "name", None) or ast.dump(m)] = m
    return out


PROFILER_REWRITTEN = {"_DEVICES", "_resolve_devices", "_STAT_KINDS", "sample_device_memory",
                      "DeviceTraceCapture"}
PROFILER_ADDED = {"_memory_stats", "_TorchTrace"}
_PROFILER_REF = _top_level(as_copied((REF / "observability/profiler.py").read_text()))
_PROFILER_PORT = _top_level((PORT / "observability/profiler.py").read_text())
PROFILER_KEPT = sorted(set(_PROFILER_REF) - PROFILER_REWRITTEN)


@pytest.mark.parametrize("name", PROFILER_KEPT)
def test_profiler_keeps_the_reference_member(name):
    assert _dump(_PROFILER_PORT[name]) == _dump(_PROFILER_REF[name])


def test_profiler_rewrites_only_its_device_half():
    assert set(_PROFILER_PORT) == set(PROFILER_KEPT) | (PROFILER_REWRITTEN - {"_STAT_KINDS"}) \
        | PROFILER_ADDED
    ref, port = (_members(t["DeviceTraceCapture"]) for t in (_PROFILER_REF, _PROFILER_PORT))
    assert set(port) == set(ref)
    for name in ("active_dir", "wait", "cancel"):
        assert ast.dump(port[name]) == ast.dump(ref[name])
    assert ast.dump(port["__init__"].args) == ast.dump(ref["__init__"].args)


_HARNESS_REF = _top_level(as_copied((REF / "testing/__init__.py").read_text()))
_HARNESS_PORT = _top_level((PORT / "testing/__init__.py").read_text())


class _WithoutDevice(ast.NodeTransformer):
    """A harness member without the kernel backend's ``device``: the
    keyword argument, the statement resolving it before anything is
    opened, and the keyword passed on. The one place the port's harness
    differs."""

    def visit_arguments(self, node: ast.arguments) -> ast.arguments:
        keep = [(a, d) for a, d in zip(node.args[len(node.args) - len(node.defaults):],
                                       node.defaults) if a.arg != "device"]
        required = node.args[:len(node.args) - len(node.defaults)]
        node.args = required + [a for a, _ in keep]
        node.defaults = [d for _, d in keep]
        return node

    def visit_FunctionDef(self, node: ast.FunctionDef) -> ast.FunctionDef:
        node.body = [s for s in node.body
                     if not (isinstance(s, ast.If) and isinstance(s.test, ast.Name)
                             and s.test.id == "use_kernel_backend"
                             and "resolve_device" in ast.unparse(s))]
        return self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> ast.Call:
        node.keywords = [k for k in node.keywords if k.arg != "device"]
        return self.generic_visit(node)


def _without_device(node: ast.AST) -> str:
    return ast.dump(_WithoutDevice().visit(ast.parse(ast.unparse(node)).body[0]))


@pytest.mark.parametrize("name", ["<imports>", "ControlledClock", "MultiPartitionHarness",
                                  "_await_partition_resources", "await_resource_absent",
                                  "await_deployment_distributed", "distributing_client"])
def test_harness_keeps_the_reference_member(name):
    port, ref = _HARNESS_PORT[name], _HARNESS_REF[name]
    if name == "MultiPartitionHarness":
        port, ref = _without_device(port), _without_device(ref)
    assert _dump(port) == _dump(ref)


def test_harness_keeps_every_engine_harness_member_but_the_kernel_branch():
    """Every member but ``__init__`` as the reference's; ``__init__`` differs
    by the kernel backend's ``device`` alone."""
    ref, port = (_members(t["EngineHarness"]) for t in (_HARNESS_REF, _HARNESS_PORT))
    assert set(port) == set(ref)
    for name in set(ref) - {"__init__"}:
        assert ast.dump(port[name]) == ast.dump(ref[name]), name
    assert _without_device(port["__init__"]) == _without_device(ref["__init__"])
    assert ast.dump(port["__init__"]) != ast.dump(ref["__init__"])


def test_harness_lacks_only_the_broker_helpers():
    """The broker helpers (``await_*``, ``distributing_client``) are back
    with the gateway: the harness has every member of the reference's and
    no other."""
    assert set(_HARNESS_PORT) == set(_HARNESS_REF)


def test_kernel_backend_needs_a_device_without_cuda(tmp_path, monkeypatch):
    """No device means CUDA: where CUDA is missing the kernel-backed harness
    raises, before opening anything, instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EngineHarness(tmp_path / "one", use_kernel_backend=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiPartitionHarness(partition_count=2, directory=tmp_path / "two",
                              use_kernel_backend=True)
    assert not (tmp_path / "one").exists()
    h = EngineHarness(tmp_path / "three", use_kernel_backend=True, device="cpu")
    try:
        assert h.kernel_backend.device == torch.device("cpu")
    finally:
        h.close()


_HARNESS_SCRIPT = """
import sys
from zeebe_tpu_torch.models.bpmn import Bpmn
from zeebe_tpu_torch.protocol.intent import ProcessInstanceIntent
from zeebe_tpu_torch.testing import EngineHarness

kernel = sys.argv[1:] == ["kernel"]
h = EngineHarness(use_kernel_backend=kernel, device="cpu" if kernel else None)
h.deploy(Bpmn.create_executable_process("one_task").start_event("start")
         .service_task("task", job_type="work").end_event("end").done())
keys = [h.create_instance("one_task", {"x": i}) for i in range(3)]
for job in h.activate_jobs("work"):
    h.complete_job(job["key"])
done = (h.exporter.process_instance_records()
        .with_intent(ProcessInstanceIntent.ELEMENT_COMPLETED)
        .with_value(bpmnElementType="PROCESS").count())
assert done == 3 and all(h.is_instance_done(k) for k in keys), done
assert not kernel or h.kernel_backend.commands_processed == 6
h.close()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "zeebe_tpu"))
print("LOADED", loaded)
"""


def test_harness_runs_without_loading_jax():
    proc = subprocess.run([sys.executable, "-c", _HARNESS_SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout


def test_kernel_harness_runs_without_loading_jax():
    """The kernel-backed harness (plain version on the CPU) takes every
    command of one_task through the backend without JAX."""
    proc = subprocess.run([sys.executable, "-c", _HARNESS_SCRIPT, "kernel"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout


# ---------------------------------------------------------------------------
# the profiler's device half


def _gauge() -> dict:
    gauge = REGISTRY._metrics.get("zeebe_device_memory_bytes")
    return {c.label_values: c.value for c in gauge._children_snapshot()}


class TestDeviceMemory:
    def test_stats_map_into_gauges(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "memory_stats",
                            lambda dev: {"allocated_bytes.all.current": 1024})
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (512, 4096))
        assert P.sample_device_memory([torch.device("cuda", 3)]) == 2
        values = _gauge()
        assert values[("gpu:3", "in_use")] == 1024.0
        assert values[("gpu:3", "limit")] == 4096.0

    def test_statless_and_raising_devices_are_skipped(self, monkeypatch):
        def boom(dev):
            raise RuntimeError("no such card")

        monkeypatch.setattr(torch.cuda, "memory_stats", boom)
        monkeypatch.setattr(torch.cuda, "mem_get_info", boom)
        assert P.sample_device_memory([torch.device("cpu"), torch.device("cuda", 1)]) == 0

    def test_no_devices_before_cuda_is_initialized(self, monkeypatch):
        def touched(*args):
            raise AssertionError("telemetry touched CUDA")

        monkeypatch.setattr(P, "_DEVICES", None)
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
        monkeypatch.setattr(torch.cuda, "device_count", touched)
        monkeypatch.setattr(torch.cuda, "memory_stats", touched)
        monkeypatch.setattr(torch.cuda, "mem_get_info", touched)
        assert P._resolve_devices() == []
        assert P.sample_device_memory() == 0
        assert P._DEVICES is None

    def test_devices_once_cuda_is_initialized(self, monkeypatch):
        monkeypatch.setattr(P, "_DEVICES", None)
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        assert P._resolve_devices() == [torch.device("cuda", 0), torch.device("cuda", 1)]
        assert P._DEVICES == [torch.device("cuda", 0), torch.device("cuda", 1)]


class TestDeviceTraceCapture:
    def test_single_flight_then_reusable(self, tmp_path):
        started: list[str] = []
        stopped: list[bool] = []
        capture = P.DeviceTraceCapture(
            tmp_path, start_fn=started.append,
            stop_fn=lambda: stopped.append(True))
        trace_dir = capture.start(seconds=30.0)
        assert trace_dir.exists() and started == [str(trace_dir)]
        assert trace_dir.name.startswith("torch-trace-")
        with pytest.raises(P.CaptureInFlight):
            capture.start(seconds=1.0)
        capture.cancel()  # end early; the slot frees
        assert stopped == [True] and capture.active_dir is None
        second = capture.start(seconds=0.01)
        capture.wait()
        assert second != trace_dir and capture.captures_taken == 2

    def test_failing_stop_still_releases_slot(self, tmp_path):
        def bad_stop():
            raise RuntimeError("no trace in progress")

        capture = P.DeviceTraceCapture(tmp_path, start_fn=lambda d: None,
                                       stop_fn=bad_stop)
        capture.start(seconds=0.01)
        capture.wait()
        assert capture.active_dir is None
        capture.start(seconds=0.01)
        capture.wait()

    def test_failing_start_leaves_no_directory(self, tmp_path):
        def bad_start(trace_dir):
            raise RuntimeError("profiler busy")

        capture = P.DeviceTraceCapture(tmp_path, start_fn=bad_start, stop_fn=lambda: None)
        with pytest.raises(RuntimeError, match="profiler busy"):
            capture.start(seconds=1.0)
        assert capture.active_dir is None and list(tmp_path.iterdir()) == []

    def test_default_capture_writes_a_chrome_trace(self, tmp_path):
        """The default session (CPU activity here: no card) stops from the
        capture's own thread and writes ``trace.json``."""
        capture = P.DeviceTraceCapture(tmp_path)
        trace_dir = capture.start(seconds=30.0)
        with pytest.raises(P.CaptureInFlight):
            capture.start(seconds=1.0)
        torch.arange(64).cumsum(0)
        capture.cancel()
        trace = json.loads((trace_dir / "trace.json").read_text())
        assert "traceEvents" in trace and capture.captures_taken == 1
        # the slot and the profiler are free for the next capture
        second = capture.start(seconds=0.01)
        capture.wait()
        assert (second / "trace.json").exists() and capture.captures_taken == 2
