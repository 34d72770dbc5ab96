"""The port's gates: the soak, the sanitizer and the multi-process
consistency, torture, device-chaos, serving, fleet-day, autotune and
scale-soak gates.

- Copies: the sanitizer equals the reference modulo the package name
  (``testing/copies.py``'s ``GATES_STACK``). Each gate is a partial copy
  (the checks of ``tests/test_torch_cluster_copies.py``): every reference
  member is in a copied run or named in ``PORT_MEMBERS`` here. A config
  and the in-process harnesses are the reference's plus the kernel
  backend's ``device``; a gate's run function is the reference's with the
  ``JAX_PLATFORMS=cpu`` pin taken out and ``device=cfg.device`` given to
  every ``worker_cmd``.
- No fallback: a gate's worker command carries ``--device`` exactly when
  its config names a device, its workers' environment gets no
  ``JAX_PLATFORMS``, and no gate module names a device of its own.
- ``ops/parity.engine_intent_sequence`` reads the same sequence as the
  reference's from one harness exporter.
- Imports: the new modules load neither JAX nor the reference.
- The copy script has nothing to write, and every ``NOT_PORTED`` entry
  names a reason and a test of the reference.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_cluster_copies import (
    _members,
    _texts,
    _without,
    check_copied_runs,
    check_imports,
    check_member_plus_names,
    check_members_copied_or_named,
)
from test_torch_tables import as_copied
from zeebe_tpu_torch.testing import copies

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
REF = REPO / "zeebe_tpu"
PORT = REPO / "zeebe_tpu_torch"
TESTS = REPO / "tests"

#: a run function that drops the reference's CPU pin of its workers and
#: gives them ``cfg.device`` instead
UNPINNED = "the workers' --device (cfg.device) in place of JAX_PLATFORMS=cpu"

#: the port's members of each gate outside its copied runs: the names the
#: port adds to the reference's member, ``UNPINNED``, or the reason it is
#: rewritten whole
PORT_MEMBERS = {
    "testing/soak.py": {
        ("SoakHarness", "__init__"): {"device"},
        (None, "run_soak"): {"device"},
    },
    "testing/scale_soak.py": {
        ("ScaleSoakHarness", "__init__"): {"device"},
        (None, "run_scale_soak"): {"device"},
    },
    "testing/consistency.py": {
        (None, "ConsistencyConfig"): {"device"},
        (None, "run_consistency"): UNPINNED,
        (None, "main"): "takes --device and --drive-seconds for the config",
    },
    "testing/torture.py": {
        (None, "TortureConfig"): {"device"},
        (None, "run_torture"): UNPINNED,
    },
    "testing/device_chaos.py": {
        (None, "DeviceChaosConfig"): {"device"},
        (None, "run_device_chaos"): UNPINNED,
    },
    "testing/serving.py": {
        (None, "ServingConfig"): {"device"},
        (None, "run_serving"): UNPINNED,
        (None, "gate_cli_main"): "takes --device for the config of every gate that uses "
                                  "it, or for the soaks' run function",
    },
    "testing/fleetday.py": {
        (None, "FleetDayConfig"): {"device"},
        (None, "run_leak_arm"): UNPINNED,
        (None, "run_fleetday"): UNPINNED,
    },
    "testing/autotune.py": {
        (None, "AutotuneConfig"): {"device"},
        (None, "run_arm"): UNPINNED,
    },
}
PARTIAL = sorted(PORT_MEMBERS)
NEW_MODULES = ("ops.parity", "testing.sanitizer", "testing.soak", "testing.scale_soak",
               "testing.consistency", "testing.torture", "testing.device_chaos",
               "testing.serving", "testing.fleetday", "testing.autotune",
               "testing.rss_split")


# ---------------------------------------------------------------------------
# copies


@pytest.mark.parametrize("path", copies.GATES_STACK)
def test_gate_module_is_a_copy(path):
    assert (PORT / path).read_text() == as_copied((REF / path).read_text())


@pytest.mark.parametrize("path", PARTIAL)
def test_copied_runs_are_the_scripts(path):
    check_copied_runs(path)


@pytest.mark.parametrize("path", PARTIAL)
def test_every_member_is_copied_or_named(path):
    check_members_copied_or_named(path, PORT_MEMBERS[path])


@pytest.mark.parametrize("path", PARTIAL)
def test_imports_are_the_references(path):
    check_imports(path, set())


EXTENDED = [(path, scope, name) for path in PARTIAL
            for (scope, name), names in PORT_MEMBERS[path].items() if isinstance(names, set)]


@pytest.mark.parametrize("path,scope,name", EXTENDED,
                         ids=[f"{p}:{s or 'module'}.{n}" for p, s, n in EXTENDED])
def test_member_is_the_references_plus_the_device(path, scope, name):
    check_member_plus_names(path, scope, name, PORT_MEMBERS[path][(scope, name)])


class _WithoutEnv(ast.NodeTransformer):
    """A member without the statements that set ``env[key] = value``."""

    def __init__(self, settings: dict) -> None:
        self.lines = {f"env[{k!r}] = {v!r}" for k, v in settings.items()}

    def visit_Assign(self, node: ast.Assign):
        if ast.unparse(node) in self.lines:
            return None
        return self.generic_visit(node)


UNPINNED_MEMBERS = [(path, name) for path in PARTIAL
                    for (_, name), why in PORT_MEMBERS[path].items() if why == UNPINNED]


@pytest.mark.parametrize("path,name", UNPINNED_MEMBERS,
                         ids=[f"{p}:{n}" for p, n in UNPINNED_MEMBERS])
def test_run_function_is_the_references_unpinned(path, name):
    """The reference's run function less its ``JAX_PLATFORMS=cpu`` line is
    the port's less the ``device`` it passes to every ``worker_cmd``."""
    ref, port = _texts(path)
    ref_node = _members(ref, set())[(None, name)]
    port_node = _members(port, set())[(None, name)]
    assert "JAX_PLATFORMS" in ast.unparse(ref_node)
    assert "JAX_PLATFORMS" not in ast.unparse(port_node)
    unpinned = _WithoutEnv({"JAX_PLATFORMS": "cpu"}).visit(ast.parse(ast.unparse(ref_node)))
    assert ast.dump(unpinned.body[0]) == _without(port_node, {"device"})
    calls = [c for c in ast.walk(port_node) if isinstance(c, ast.Call)
             and isinstance(c.func, ast.Name) and c.func.id == "worker_cmd"]
    assert calls and all(
        [ast.unparse(k.value) for k in c.keywords if k.arg == "device"] == ["cfg.device"]
        for c in calls)


def _constants(text: str) -> list:
    """The constants of a module, less its docstrings."""
    tree = ast.parse(text)
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and id(n) not in docs]


@pytest.mark.parametrize("path", PARTIAL + list(copies.GATES_STACK))
def test_no_gate_names_a_device_of_its_own(path):
    """No gate pins JAX's platform or asks for the CPU: a device is only
    ever the caller's."""
    text = (PORT / path).read_text()
    assert not [c for c in _constants(text) if isinstance(c, str) and "JAX_PLATFORMS" in c]
    assert "cpu" not in _constants(text)
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.keyword) and node.arg == "device":
            assert not isinstance(node.value, ast.Constant), ast.unparse(node)


# ---------------------------------------------------------------------------
# the workers' device


class _Spawned(Exception):
    """Raised by the fake supervisor once a gate has built its workers."""


def _capture_spawn(monkeypatch) -> list:
    """Patch the supervisor so a gate stops where it would start its
    workers; what it would have started (specs, env) lands in the list."""
    from zeebe_tpu_torch.multiproc import supervisor

    seen = []

    class Supervisor:
        def __init__(self, specs, env=None, **_kwargs) -> None:
            seen.append((specs, env))
            raise _Spawned

    monkeypatch.setattr(supervisor, "WorkerSupervisor", Supervisor)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    return seen


def _multiproc_runs():
    from zeebe_tpu_torch.testing import autotune, consistency, device_chaos, fleetday, serving
    from zeebe_tpu_torch.testing import torture

    return {
        "consistency": (consistency.ConsistencyConfig, consistency.run_consistency),
        "torture": (torture.TortureConfig, torture.run_torture),
        "device_chaos": (device_chaos.DeviceChaosConfig, device_chaos.run_device_chaos),
        "serving": (serving.ServingConfig, serving.run_serving),
        "fleetday": (fleetday.FleetDayConfig, fleetday.run_fleetday),
        "fleetday_leak_arm": (fleetday.FleetDayConfig, fleetday.run_leak_arm),
        "autotune": (autotune.AutotuneConfig,
                     lambda cfg, d: autotune.run_arm("adaptive", {}, cfg, Path(d), [0.0])),
    }


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("gate", sorted(_multiproc_runs()))
def test_workers_get_the_configs_device(gate, device, monkeypatch, tmp_path):
    """Each gate's worker command carries ``--device`` exactly when its
    config names one, and its workers' environment pins no platform."""
    cfg_cls, run = _multiproc_runs()[gate]
    seen = _capture_spawn(monkeypatch)
    with pytest.raises(_Spawned):
        run(cfg_cls(device=device), tmp_path)
    (specs, env), = seen
    assert specs and "JAX_PLATFORMS" not in env
    for spec in specs:
        assert spec.cmd[:3] == [sys.executable, "-m", "zeebe_tpu_torch.multiproc.worker"]
        if device is None:
            assert "--device" not in spec.cmd
        else:
            assert spec.cmd[-2:] == ["--device", device]


def test_device_chaos_leaves_the_router_on(monkeypatch, tmp_path):
    """The device-chaos gate gives its workers no routing knob: on the card
    their router is on, as in every deployment, and a SUSPECT card's probes
    carry its groups through the device-fault seam."""
    from zeebe_tpu_torch.testing.device_chaos import DeviceChaosConfig, run_device_chaos

    seen = _capture_spawn(monkeypatch)
    with pytest.raises(_Spawned):
        run_device_chaos(DeviceChaosConfig(), tmp_path)
    (_, env), = seen
    assert not [k for k in env if "ROUTING" in k and k not in os.environ]
    assert env["ZEEBE_BROKER_EXPERIMENTAL_KERNELBACKEND"] == "true"


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("gate", ["soak", "scale_soak"])
def test_in_process_harness_gets_the_device(gate, device, monkeypatch):
    """The soaks give their ``device`` to the chaos harness's cluster."""
    import importlib

    module = importlib.import_module(f"zeebe_tpu_torch.testing.{gate}")
    seen = []

    class Harness:
        def __init__(self, *_args, **kwargs) -> None:
            seen.append(kwargs.get("device", "missing"))
            raise _Spawned

    monkeypatch.setattr(module, "ChaosHarness", Harness)
    run = module.run_soak if gate == "soak" else module.run_scale_soak
    with pytest.raises(_Spawned):
        run(None, None, device=device)
    assert seen == [device]


@pytest.mark.parametrize("argv,device", [(["--quick"], None),
                                         (["--quick", "--device", "cpu"], "cpu"),
                                         (["--device", "cpu", "--seed", "3"], "cpu")])
def test_gate_cli_passes_the_device(argv, device, capsys):
    from zeebe_tpu_torch.testing.serving import ServingConfig, gate_cli_main

    seen = []

    def run(cfg, directory):
        seen.append(cfg)
        return {"violations": []}

    quick, full = ServingConfig(), ServingConfig(phase_a_seconds=99.0)
    assert gate_cli_main("gate", quick, full, run, argv) == 0
    assert json.loads(capsys.readouterr().out) == {"violations": []}
    (cfg,) = seen
    want = dataclasses.replace(quick if "--quick" in argv else full,
                               seed=3 if "--seed" in argv else 0, device=device)
    assert cfg == want


def test_consistency_cli_passes_the_device(monkeypatch, capsys):
    from zeebe_tpu_torch.testing import consistency

    seen = []
    monkeypatch.setattr(consistency, "run_consistency",
                        lambda cfg, directory: seen.append(cfg) or {"violations": ["x"]})
    assert consistency.main(["--quick", "--device", "cpu"]) == 1
    assert consistency.main(["--quick"]) == 1
    assert consistency.main(["--quick", "--drive-seconds", "120"]) == 1
    assert [c.device for c in seen] == ["cpu", None, None]
    quick = consistency.ConsistencyConfig()
    assert seen[0].drive_seconds == quick.drive_seconds
    assert dataclasses.replace(seen[2], drive_seconds=quick.drive_seconds) == quick
    assert seen[2].drive_seconds == 120.0
    capsys.readouterr()


@pytest.mark.parametrize("argv,device", [(["--quick"], None),
                                         (["--quick", "--device", "cpu"], "cpu")])
def test_gate_cli_gives_a_soak_its_device(argv, device, capsys):
    """A config with no ``device`` (the soaks') keeps the preset; the device
    goes to the run function."""
    from zeebe_tpu_torch.testing.serving import gate_cli_main
    from zeebe_tpu_torch.testing.soak import SoakConfig

    seen = []

    def run(cfg, directory, device=None):
        seen.append((cfg, device))
        return {"violations": ["x"]}

    assert gate_cli_main("soak", SoakConfig(), SoakConfig(rounds=10), run, argv) == 1
    assert seen == [(SoakConfig(seed=0), device)]
    capsys.readouterr()


def test_soak_runs_from_its_command_line(tmp_path):
    """``python -m zeebe_tpu_torch.testing.soak --quick --device cpu``: the
    CI short mode on the plain version, its report on stdout, exit 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "zeebe_tpu_torch.testing.soak", "--quick", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout)
    assert report["violations"] == [] and report["withinBudget"]
    assert len(report["recoveries"]) == 5


def test_scale_soak_has_a_command_line():
    proc = subprocess.run(
        [sys.executable, "-m", "zeebe_tpu_torch.testing.scale_soak", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert all(flag in proc.stdout for flag in ("--quick", "--seed", "--device"))


def test_rss_split_on_the_cpu():
    """The split leaves the card's steps out on the CPU and counts the
    engine's step after ``import torch``, with the resident memory by kind
    at each step; the engine ran its groups through the kernel backend."""
    from zeebe_tpu_torch.testing.rss_split import rss_split

    split = rss_split("cpu", instances=4)
    assert list(split["rssMiB"]) == ["interpreter", "import torch", "engine, 4 instances"]
    assert list(split["growthMiB"]) == ["import torch", "engine, 4 instances"]
    assert all(mib > 0 for mib in split["rssMiB"].values())
    assert split["device"] == "cpu" and split["kernelRecords"] > 0
    # by kind at each step (smaps' mappings), the three kinds summing to the
    # step's resident MiB (VmRSS)
    assert list(split["kindMiB"]) == list(split["rssMiB"])
    for step, kinds in split["kindMiB"].items():
        assert set(kinds) == {"RssAnon", "RssFile", "RssShmem"}
        assert all(mib >= 0 for mib in kinds.values())
        assert abs(sum(kinds.values()) - split["rssMiB"][step]) < 1.0


# ---------------------------------------------------------------------------
# the sequential engine's intent sequence


def _drive(package: str, tmp_path: Path, models, creations) -> dict:
    """One harness of ``package``: deploy, create, complete every job;
    instance key -> the exporter's intent sequence by both packages'
    ``engine_intent_sequence``."""
    import importlib

    from zeebe_tpu.ops.parity import engine_intent_sequence as ref_sequence
    from zeebe_tpu_torch.models.bpmn import to_bpmn_xml
    from zeebe_tpu_torch.ops.parity import engine_intent_sequence

    h = importlib.import_module(f"{package}.testing").EngineHarness(tmp_path / package)
    try:
        h.deploy(to_bpmn_xml(models))
        keys = [h.create_instance(pid, variables=variables) for pid, variables in creations]
        types = sorted({e.job_type for m in models for e in m.elements.values()
                        if getattr(e, "job_type", None)})
        for _ in range(12):
            jobs = [j for t in types for j in h.activate_jobs(t, max_jobs=100)]
            if not jobs:
                break
            for job in jobs:
                h.complete_job(job["key"])
        return {k: (engine_intent_sequence(h.exporter, k), ref_sequence(h.exporter, k))
                for k in keys}
    finally:
        h.close()


def _one_task():
    from zeebe_tpu_torch.testing import workloads as W

    return [W.one_task()], [("one_task", {})] * 3


def _mixed():
    from zeebe_tpu_torch.testing import workloads as W

    models = W.mixed_definitions()
    creations = [(m.process_id, {"x": x}) for m in models for x in (3, 30)]
    return models, creations


@pytest.mark.parametrize("workload", [_one_task, _mixed], ids=["one_task", "mixed"])
@pytest.mark.parametrize("package", ["zeebe_tpu", "zeebe_tpu_torch"])
def test_engine_intent_sequence_is_the_references(workload, package, tmp_path):
    """On one harness's exporter (the reference's or the port's) both
    functions read the same sequence, and each instance's sequence runs
    from its start to its completion."""
    models, creations = workload()
    sequences = _drive(package, tmp_path, models, creations)
    assert len(sequences) == len(creations)
    for port, ref in sequences.values():
        assert port == ref
        assert port[0][1] == "ELEMENT_ACTIVATING" and port[-1][1] == "ELEMENT_COMPLETED"


# ---------------------------------------------------------------------------
# imports, the copy script and the tests left out


_IMPORT_SCRIPT = """
import importlib, json, sys
for name in {modules!r}:
    importlib.import_module("zeebe_tpu_torch." + name)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "zeebe_tpu"))))
"""


def test_new_modules_load_neither_jax_nor_the_reference():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_SCRIPT.format(modules=NEW_MODULES)],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_copy_script_check_lists_nothing():
    proc = subprocess.run([sys.executable, str(PORT / "testing" / "copies.py"), "--check"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert (proc.returncode, proc.stdout) == (0, "")


def _defined(text: str) -> set:
    """Names of the classes and functions of a module and of its classes."""
    out = set()
    for node in ast.parse(text).body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef)):
            out.add(node.name)
        if isinstance(node, ast.ClassDef):
            out |= {m.name for m in node.body if isinstance(m, ast.FunctionDef)}
    return out


@pytest.mark.parametrize("name", copies.REFERENCE_TESTS)
def test_every_test_left_out_names_its_reason(name):
    """Each entry of a copied reference file is a test or a class of it,
    left out of the copy with a reason; none waits for a module of the
    port any more (the CLI and the analysis package are ported)."""
    assert set(copies.NOT_PORTED) <= set(copies.REFERENCE_TESTS)
    defined = _defined((TESTS / name).read_text())
    copy = _defined(copies.reference_test_copy(name).read_text())
    for left_out, reason in copies.NOT_PORTED.get(name, {}).items():
        assert left_out in defined and left_out not in copy
        assert isinstance(reason, str) and len(reason) > 20
        assert "`cli`" not in reason and "`analysis`" not in reason
