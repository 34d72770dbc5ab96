"""Runs the reference's kernel-backend flows on both packages and holds the
port's record logs and backend counters to the reference's.

Helpers for the ``tests/test_torch_kernel_*.py`` files (not collected
itself). A flow is a test method of a reference test file
(``tests/test_kernel_backend.py`` and the others). It runs three times:

- ``reference``: the file as written, on ``zeebe_tpu``;
- ``port``: the file with its imports renamed to ``zeebe_tpu_torch``; every
  harness built with ``use_kernel_backend=True`` is given ``device="cpu"``
  (the plain PyTorch version), which the flow itself never passes;
- ``sequential``: the port's file again, every command on the sequential
  engine: a harness the flow built for the kernel keeps its backend, but
  the backend declines every group it admits before anything reaches the
  device, so the stream processor runs each head command sequentially (the
  flow's reads of the backend's registry and counters still work); the
  file's ``assert`` statements are turned into bare expressions (still
  evaluated, so their side effects happen; never raising).

The first two must pass the flow's own assertions, its "kernel actually
used" checks included. The third drives the same commands without the
kernel, where those checks cannot hold; only its logs are compared. Then, with tolerance 0, for every
harness the flow built, in the order it built them: the port's log
(every record's fields and bytes, every journal entry) equals the
reference's and the port's sequential log, and the port's backend
counters equal the reference's (groups, commands, fallbacks and their
reasons, template hits, misses and audits, shadow quarantines and the
per-definition path accounting).
"""

from __future__ import annotations

import ast
import importlib
import random
import re
import sys
import types
from pathlib import Path

import pytest
import torch

from test_torch_engine import _as_port, _log

REPO = Path(__file__).resolve().parents[1]
TESTS = REPO / "tests"
REF, PORT = "zeebe_tpu", "zeebe_tpu_torch"

# the plain version's tensors here are small: torch's intra-op thread pool
# only adds contention with the other test workers
torch.set_num_threads(1)


def flows(name: str, only=None, skip=()) -> list[tuple]:
    """(file, class, method, fixture names) of each test method of a
    reference file; ``only`` keeps the methods whose source passes it."""
    text = (TESTS / f"{name}.py").read_text()
    out = []
    for node in ast.parse(text).body:
        if isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            for fn in node.body:
                if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")):
                    continue
                if fn.name in skip:
                    continue
                if only is not None and not only(ast.get_source_segment(text, fn)):
                    continue
                out.append((name, node.name, fn.name, tuple(a.arg for a in fn.args.args[1:])))
    return out


class _AssertsEvaluated(ast.NodeTransformer):
    def visit_Assert(self, node: ast.Assert) -> ast.Expr:
        return ast.copy_location(ast.Expr(node.test), node)


#: variant → {file name → module}; variants: REF, PORT, "sequential"
_MODULES: dict[str, dict[str, types.ModuleType]] = {REF: {}, PORT: {}, "sequential": {}}
_HELPER_IMPORT = re.compile(r"^from tests\.(test_\w+) import", re.M)
# a flow that runs its own file's scenario in a child process imports the
# file there by name (``import test_x as t`` inside the child's code)
_CHILD_IMPORT = re.compile(r"import (test_\w+) as (\w+)\\n")


def marked_slow(flow: tuple) -> bool:
    """Whether the reference marks the flow ``slow``: its module, its class
    or its method."""
    name, cls_name, method, _ = flow
    tree = ast.parse((TESTS / f"{name}.py").read_text())

    def slow(decorators) -> bool:
        return any("mark.slow" in ast.unparse(d) for d in decorators)

    for node in tree.body:
        if isinstance(node, ast.Assign) and ast.unparse(node.targets[0]) == "pytestmark":
            if "mark.slow" in ast.unparse(node.value):
                return True
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            fn = next(m for m in node.body if getattr(m, "name", None) == method)
            return slow(node.decorator_list) or slow(fn.decorator_list)
    return False


def port_module(name: str) -> types.ModuleType:
    """The port's variant of ``tests/<name>.py`` for a child process of a
    flow: its harnesses' kernel backends and its mesh runners on the CPU,
    as ``run_flow`` puts them in the flow's own process."""
    module = flow_module(name, PORT)
    if hasattr(module, "EngineHarness") and not hasattr(module.EngineHarness, "on_the_cpu"):

        class CpuHarness(module.EngineHarness):
            on_the_cpu = True

            def __init__(self, *args, **kwargs) -> None:
                if kwargs.get("use_kernel_backend") and kwargs.get("device") is None:
                    kwargs["device"] = "cpu"
                super().__init__(*args, **kwargs)

        module.EngineHarness = CpuHarness
    if hasattr(module, "MeshKernelRunner"):
        module.MeshKernelRunner = _cpu_mesh_runner(module.MeshKernelRunner)
    return module


def flow_module(name: str, variant: str) -> types.ModuleType:
    """``tests/<name>.py`` executed as a private module: as written (REF),
    with its imports renamed (PORT), or renamed with each ``assert``
    statement reduced to its tested expression ("sequential"). A helper
    it imports from another test file comes from that file's module of
    the same variant."""
    modules = _MODULES[variant]
    if name not in modules:
        text = (TESTS / f"{name}.py").read_text()
        for dep in _HELPER_IMPORT.findall(text):
            flow_module(dep, variant)
        text = _HELPER_IMPORT.sub(lambda m: f"from _kflows_{variant}_{m.group(1)} import", text)
        if variant != REF:
            text = _as_port(text)
            # the child runs the port's variant of the file, not the file
            text = _CHILD_IMPORT.sub(
                lambda m: f"import torch_kernel_flows; "
                          f"{m.group(2)} = torch_kernel_flows.port_module('{m.group(1)}')\\n",
                text)
        tree = ast.parse(text)
        if variant == "sequential":
            tree = ast.fix_missing_locations(_AssertsEvaluated().visit(tree))
        module = types.ModuleType(f"_kflows_{variant}_{name}")
        module.__file__ = str(TESTS / f"{name}.py")
        sys.modules[module.__name__] = module
        exec(compile(tree, module.__file__, "exec"), module.__dict__)
        modules[name] = module
    return modules[name]


def flow_id(flow: tuple) -> str:
    return f"{flow[1]}::{flow[2]}"


def counters(backend) -> dict | None:
    """What a backend counted: equal counters show equal admission."""
    if backend is None:
        return None
    return {
        "groups": backend.groups_processed,
        "commands": backend.commands_processed,
        "fallbacks": backend.fallbacks,
        "reasons": dict(backend.fallback_reasons),
        "template_hits": backend.template_hits,
        "template_misses": backend.template_misses,
        "template_audits": backend.template_audits,
        "template_audit_skips": backend.template_audit_skips,
        "shadow_quarantined": backend.shadow_quarantined,
        "accounting": backend.accounting.mark(),
    }


def _recording(cls, made: list, side: str, mode: str):
    class Recording(cls):
        """The harness that records its log and counters when it, or its
        journal, is first closed (flows close their own harnesses, and may
        close a journal to reopen its directory)."""

        def __init__(self, *args, **kwargs) -> None:
            if (side == PORT and kwargs.get("use_kernel_backend")
                    and kwargs.get("device") is None):
                kwargs["device"] = "cpu"
            self.record = None
            super().__init__(*args, **kwargs)
            if mode == "sequential" and self.kernel_backend is not None:
                self.kernel_backend._start_kernel = _declined
            made.append(self)
            close_journal = self.journal.close

            def close() -> None:
                self._capture()
                close_journal()

            self.journal.close = close

        def _capture(self) -> None:
            if self.record is None:
                self.record = {"log": _log(self), "counters": counters(self.kernel_backend)}

        def close(self) -> None:
            if self.record is None:
                self._capture()
                super().close()
    return Recording


def _cpu_mesh_runner(runner_cls):
    """The port's ``MeshKernelRunner`` with its mesh on the CPU (the flows
    build ``MeshKernelRunner(n_shards=...)``, which is on the card)."""
    from zeebe_tpu_torch.parallel.mesh import make_mesh

    class CpuMeshRunner(runner_cls):
        def __init__(self, n_shards=None, mesh=None, **kwargs) -> None:
            super().__init__(mesh=mesh or make_mesh(n_shards, "cpu"), **kwargs)
    return CpuMeshRunner


def _declined(pg) -> None:
    """A device run refused before dispatch: the group declines."""
    pg.failed = True
    pg.fail_reason = "group-error"


def _reset_device_plane(side: str) -> None:
    importlib.import_module(f"{side}.engine.kernel_backend").install_device_chaos(None)
    importlib.import_module(f"{side}.engine.device_health").reset_shared_device_health()


def run_flow(side: str, mode: str, flow: tuple, root: Path) -> tuple[list[dict], BaseException | None]:
    """One flow on one side: the records of every harness it built, and
    what it raised (None)."""
    name, cls_name, method, fixtures = flow
    variant = "sequential" if mode == "sequential" else side
    module = flow_module(name, variant)
    testing = importlib.import_module(f"{side}.testing")
    made: list = []
    recording = _recording(testing.EngineHarness, made, side, mode)
    loaded = list(_MODULES[variant].values())
    patches = [(obj, "EngineHarness", recording) for obj in [*loaded, testing]
               if hasattr(obj, "EngineHarness")]
    if side == PORT:
        patches += [(obj, "MeshKernelRunner", _cpu_mesh_runner(obj.MeshKernelRunner))
                    for obj in loaded if hasattr(obj, "MeshKernelRunner")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, value in patches:
        setattr(obj, attr, value)
    monkeypatch = pytest.MonkeyPatch()
    raised = None
    _reset_device_plane(side)
    try:
        args = []
        for fixture in fixtures:
            if fixture == "tmp_path":
                (root / "tmp").mkdir(parents=True, exist_ok=True)
                args.append(root / "tmp")
            elif fixture == "monkeypatch":
                args.append(monkeypatch)
            else:
                raise AssertionError(f"{flow_id(flow)} needs {fixture}")
        try:
            getattr(getattr(module, cls_name)(), method)(*args)
        except Exception as exc:  # noqa: BLE001 — kept for the caller
            raised = exc
    finally:
        monkeypatch.undo()
        for obj, attr, value in saved:
            setattr(obj, attr, value)
        for h in made:
            h.close()
        _reset_device_plane(side)
    return [h.record for h in made], raised


def assert_logs_equal(a: list[dict], b: list[dict], what: str) -> int:
    assert len(a) == len(b), f"{what}: {len(a)} harnesses against {len(b)}"
    records = 0
    for i, (x, y) in enumerate(zip(a, b)):
        for j, (rx, ry) in enumerate(zip(x["log"]["records"], y["log"]["records"])):
            assert rx == ry, f"{what}: harness {i}, first divergence at record {j}"
        assert len(x["log"]["records"]) == len(y["log"]["records"]), f"{what}: harness {i}"
        assert x["log"]["journal"] == y["log"]["journal"], f"{what}: harness {i} journal"
        records += len(x["log"]["records"])
    return records


def check_flow(flow: tuple, root: Path) -> None:
    """The flow on the reference, on the port and on the port's sequential
    engine; every log and every counter held equal."""
    ref, raised = run_flow(REF, "kernel", flow, root / "reference")
    if raised is not None:
        raise raised
    port, raised = run_flow(PORT, "kernel", flow, root / "port")
    if raised is not None:
        raise raised
    seq, _ = run_flow(PORT, "sequential", flow, root / "sequential")
    what = flow_id(flow)
    assert_logs_equal(ref, port, f"{what} (port against reference)")
    assert [r["counters"] for r in port] == [r["counters"] for r in ref], what
    assert_logs_equal(port, seq, f"{what} (kernel against sequential)")


# ---------------------------------------------------------------------------
# the random process generator


MODES = ("seq", "audit", "fast")


def run_seed(side: str, seed: int, modes=MODES) -> dict[str, dict]:
    """One seed of ``tests/test_randomized_parity.py``'s generator in each
    of ``modes``: the sequential engine, the kernel backend with every
    template hit audited, and the kernel backend's fast path (templates
    served). Mode → record."""
    module = flow_module("test_randomized_parity", side)
    testing = importlib.import_module(f"{side}.testing")
    gen_rng = random.Random(seed)
    gen = module._Gen(gen_rng, f"rand_{seed}")
    model = gen.build()
    instances = gen_rng.randint(1, 3)
    constant_vars = seed % 4 == 0
    out = {}
    for mode in modes:
        made: list = []
        recording = _recording(testing.EngineHarness, made, side, "kernel")
        h = recording(use_kernel_backend=mode != "seq")
        if mode == "fast":
            h.kernel_backend.audit_templates = False
        try:
            module._drive(h, gen, model, random.Random(seed + 1), instances, constant_vars)
        finally:
            h.close()
        out[mode] = h.record
    return out


def check_seeds(seeds) -> None:
    """Per seed: the port's kernel and fast-path logs and counters equal the
    reference's, and the port's sequential log (the two sequential engines'
    logs are held equal by ``tests/test_torch_engine.py``)."""
    kernel_commands = 0
    for seed in seeds:
        ref = run_seed(REF, seed, MODES[1:])
        port = run_seed(PORT, seed)
        for mode in MODES[1:]:
            assert_logs_equal([ref[mode]], [port[mode]],
                          f"seed {seed} {mode} (port against reference)")
            assert ref[mode]["counters"] == port[mode]["counters"], f"seed {seed} {mode}"
            assert_logs_equal([port["seq"]], [port[mode]], f"seed {seed} {mode} (against sequential)")
        kernel_commands += port["audit"]["counters"]["commands"]
    assert kernel_commands > 0, "the kernel backend never admitted a command in this block"
