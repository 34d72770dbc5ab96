"""The port's engine stack writes the reference's record log, byte for byte.

The reference's harness and the port's each run the same flows: the flows
of ``tests/test_engine_e2e.py``, the replay scenarios of
``tests/test_engine_replay.py``, the three-partition flows of
``tests/test_multipartition.py`` and the 120 seeds of the random process
generator in ``tests/test_randomized_parity.py`` (sequential engine). Each
flow runs twice from the same test file: as written (the reference), and
with its imports renamed to ``zeebe_tpu_torch`` (the port), so each side
builds its BPMN with its own package, drives its own harness from the same
``ControlledClock`` start, and must pass the flow's own assertions. Then,
with tolerance 0, for every harness of the flow (every partition of a
cluster):

- every logged record's position, source position, processed flag, key,
  record type, value type, intent, rejection and value (the fingerprint of
  ``tests/test_randomized_parity.py``) and its serialized bytes;
- every journal entry's index, asqn and bytes;
- every file the flow left on disk (journal segments, durable state).

Each flow runs in three state legs: the in-memory ``ZbDb``, and the durable
store (``DurableZbDb``) with ``sortedcontainers``' ``SortedList`` and with
the store's own fallback ``SortedList`` (forced by replacing the module
attribute in both packages; the card's machine may lack the package). All
legs run here with both packages' native codec loaded, and again in a
subprocess with ``ZEEBE_TPU_NO_NATIVE=1`` (the pure-Python codec), where the
fallback leg blocks ``sortedcontainers`` from import, as on a machine
without it.
"""

from __future__ import annotations

import ast
import importlib
import json
import os
import random
import subprocess
import sys
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
TESTS = REPO / "tests"
SIDES = ("zeebe_tpu", "zeebe_tpu_torch")
LEGS = ("memory", "durable-sortedcontainers", "durable-fallback")
FLOW_FILES = ("test_engine_e2e", "test_engine_replay", "test_multipartition")
SEEDS = range(120)
SEED_BLOCK = 20


# ---------------------------------------------------------------------------
# the flows, as each side runs them


def _as_port(text: str) -> str:
    return (text.replace("zeebe_tpu.", "zeebe_tpu_torch.")
            .replace("from zeebe_tpu import ", "from zeebe_tpu_torch import "))


_MODULES: dict[tuple[str, str], types.ModuleType] = {}


def _flow_module(name: str, side: str) -> types.ModuleType:
    """``tests/<name>.py`` executed as a private module: as written for the
    reference, with its imports renamed for the port."""
    key = (name, side)
    if key not in _MODULES:
        text = (TESTS / f"{name}.py").read_text()
        if side == "zeebe_tpu_torch":
            text = _as_port(text)
        module = types.ModuleType(f"_flows_{side}_{name}")
        module.__file__ = str(TESTS / f"{name}.py")
        sys.modules[module.__name__] = module
        exec(compile(text, module.__file__, "exec"), module.__dict__)
        _MODULES[key] = module
    return _MODULES[key]


def _flows(name: str) -> list[tuple[str, str, tuple[str, ...]]]:
    """(class, method, fixture names) of each test of a flow file."""
    out = []
    for node in ast.parse((TESTS / f"{name}.py").read_text()).body:
        if isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            for fn in node.body:
                if isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_"):
                    out.append((node.name, fn.name, tuple(a.arg for a in fn.args.args[1:])))
    return out


FLOWS = [(name, *flow) for name in FLOW_FILES for flow in _flows(name)]


# ---------------------------------------------------------------------------
# the state legs


def _fallback_sorted_list(durable: types.ModuleType) -> type:
    """The durable store's own ``SortedList`` (the ``except ImportError``
    branch of its import), built from its module's source."""
    tree = ast.parse(Path(durable.__file__).read_text())
    for node in tree.body:
        if (isinstance(node, ast.Try) and isinstance(node.body[0], ast.ImportFrom)
                and node.body[0].module == "sortedcontainers"):
            scope = dict(vars(durable))
            exec(compile(ast.Module(node.handlers[0].body, []), durable.__file__, "exec"),
                 scope)
            return scope["SortedList"]
    raise AssertionError("no fallback SortedList in " + durable.__file__)


class _Leg:
    """Installs a state leg on both packages' harness modules and closes
    the durable stores it opened."""

    def __init__(self, leg: str, root: Path) -> None:
        self.leg, self.root = leg, root
        self._undo: list = []
        self._stores: list = []

    def _set(self, obj, attr, value) -> None:
        self._undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    def __enter__(self) -> "_Leg":
        if self.leg == "memory":
            return self
        for side in SIDES:
            testing = importlib.import_module(f"{side}.testing")
            durable = importlib.import_module(f"{side}.state.durable")
            if self.leg == "durable-fallback":
                if durable.SortedList.__module__.startswith("sortedcontainers"):
                    self._set(durable, "SortedList", _fallback_sorted_list(durable))
            else:
                assert durable.SortedList.__module__.startswith("sortedcontainers")
            self._set(testing, "ZbDb", self._factory(durable.DurableZbDb))
        return self

    def _factory(self, cls):
        def make(consistency_checks: bool = True):
            directory = self.root / f"state-{len(self._stores)}"
            store = cls(directory, consistency_checks=consistency_checks)
            self._stores.append(store)
            return store
        return make

    def __exit__(self, *exc) -> None:
        for obj, attr, value in reversed(self._undo):
            setattr(obj, attr, value)
        for store in self._stores:
            store.close()


# ---------------------------------------------------------------------------
# what a log is


def _log(h) -> dict:
    records = []
    for logged in h.stream.new_reader(1):
        rec = logged.record
        records.append((
            logged.position,
            logged.source_position,
            logged.processed,
            rec.key,
            rec.record_type.name,
            rec.value_type.name,
            int(rec.intent),
            rec.rejection_type.name if rec.is_rejection else "",
            dict(rec.value) if rec.value else {},
            rec.to_bytes(),
        ))
    entries = [(e.index, e.asqn, bytes(e.data)) for e in h.journal.read_from(1)]
    return {"records": records, "journal": entries}


def _files(root: Path) -> dict[str, bytes]:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _recording(cls, made: list):
    """``cls`` that keeps each instance in ``made`` and, on its first
    ``close``, its logs (a cluster's partitions in partition order): some
    flows close their own harness."""
    class Recording(cls):
        def __init__(self, *args, **kwargs) -> None:
            self.logs = None
            super().__init__(*args, **kwargs)
            made.append(self)

        def close(self) -> None:
            if self.logs is None:
                parts = self.partitions.values() if hasattr(self, "partitions") else [self]
                self.logs = [_log(p) for p in parts]
                super().close()
    return Recording


def _run_flow(side: str, name: str, cls_name: str, method: str, fixtures: tuple,
              root: Path) -> list[dict]:
    module = _flow_module(name, side)
    made: list = []
    saved = {n: getattr(module, n) for n in ("EngineHarness", "MultiPartitionHarness")
             if hasattr(module, n)}
    for n, cls in saved.items():
        setattr(module, n, _recording(cls, made))
    args = []
    try:
        for fixture in fixtures:
            if fixture == "harness":
                args.append(module.EngineHarness(root / "harness"))
            elif fixture == "cluster":
                args.append(module.MultiPartitionHarness(partition_count=3,
                                                         directory=root / "cluster"))
            elif fixture == "tmp_path":
                args.append(root / "tmp")
            else:
                raise AssertionError(f"{name}::{cls_name}::{method} needs {fixture}")
        getattr(getattr(module, cls_name)(), method)(*args)
    finally:
        for n, cls in saved.items():
            setattr(module, n, cls)
        for h in made:
            h.close()
    return [log for h in made for log in h.logs]


def _run_seed(side: str, seed: int, root: Path) -> list[dict]:
    """One seed of the random process generator, sequential engine: the
    reference's own ``_Gen`` and ``_drive``, built on each side's package."""
    module = _flow_module("test_randomized_parity", side)
    gen_rng = random.Random(seed)
    gen = module._Gen(gen_rng, f"rand_{seed}")
    model = gen.build()
    instances = gen_rng.randint(1, 3)
    h = module.EngineHarness(root / "harness")
    try:
        module._drive(h, gen, model, random.Random(seed + 1), instances, seed % 4 == 0)
        logs = [_log(h)]
    finally:
        h.close()
    return logs


def _both(run, leg: str, root: Path, *args) -> tuple:
    """The same run on both sides in one state leg; returns (reference,
    port) logs, each with the files its run left under its own root once
    its stores closed."""
    out = []
    for side in SIDES:
        side_root = root / side
        side_root.mkdir(parents=True)
        with _Leg(leg, side_root):
            logs = run(side, *args, side_root)
        out.append((logs, _files(side_root)))
    return out


def _assert_identical(ref, port, what: str) -> int:
    (ref_logs, ref_files), (port_logs, port_files) = ref, port
    assert len(ref_logs) == len(port_logs), what
    for i, (a, b) in enumerate(zip(ref_logs, port_logs)):
        for j, (ra, rb) in enumerate(zip(a["records"], b["records"])):
            assert ra == rb, f"{what}: harness {i}, first divergence at record {j}"
        assert len(a["records"]) == len(b["records"]), f"{what}: harness {i} log length"
        assert a["journal"] == b["journal"], f"{what}: harness {i} journal bytes"
    assert sorted(ref_files) == sorted(port_files), what
    for path, data in ref_files.items():
        assert port_files[path] == data, f"{what}: {path} differs"
    return sum(len(log["records"]) for log in ref_logs)


def _native_loaded() -> bool:
    return all(importlib.import_module(f"{side}.native").load_codec() is not None
               for side in SIDES)


# ---------------------------------------------------------------------------
# native codec, in this process


@pytest.fixture(scope="module", autouse=True)
def _native_codec():
    if os.environ.get("ZEEBE_TPU_NO_NATIVE"):
        pytest.fail("these legs hold the native codec; the subprocess legs run without it")
    assert _native_loaded(), "both packages' native codec must load here"


@pytest.mark.parametrize("leg", LEGS)
@pytest.mark.parametrize("name,cls_name,method,fixtures", FLOWS,
                         ids=[f"{n}::{c}::{m}" for n, c, m, _ in FLOWS])
def test_flow_log_is_byte_identical(name, cls_name, method, fixtures, leg, tmp_path):
    ref, port = _both(_run_flow, leg, tmp_path, name, cls_name, method, fixtures)
    assert _assert_identical(ref, port, f"{name}::{cls_name}::{method} ({leg})") > 0


@pytest.mark.parametrize("leg", LEGS)
@pytest.mark.parametrize("first", range(0, len(SEEDS), SEED_BLOCK))
def test_random_seed_logs_are_byte_identical(first, leg, tmp_path):
    records = 0
    for seed in SEEDS[first:first + SEED_BLOCK]:
        ref, port = _both(_run_seed, leg, tmp_path / str(seed), seed)
        records += _assert_identical(ref, port, f"seed {seed} ({leg})")
    assert records > 0


def test_flows_cover_the_reference_files():
    """Every test of the three flow files is a flow here, and each needs only
    the fixtures the runner makes."""
    counts = {name: sum(1 for f in FLOWS if f[0] == name) for name in FLOW_FILES}
    assert counts == {"test_engine_e2e": 20, "test_engine_replay": 7,
                      "test_multipartition": 9}
    assert {f for *_, fixtures in FLOWS for f in fixtures} <= {"harness", "cluster",
                                                                 "tmp_path"}


@pytest.mark.parametrize("name", FLOW_FILES + ("test_randomized_parity",))
def test_each_side_runs_its_own_package(name):
    """The port's copy of a flow file holds nothing of the reference: every
    class and function it imported comes from the port."""
    for side in SIDES:
        module = _flow_module(name, side)
        packages = {getattr(v, "__module__", "").split(".")[0] for k, v in vars(module).items()
                    if not k.startswith("__") and isinstance(v, (type, types.FunctionType))
                    and getattr(v, "__module__", "").startswith("zeebe_tpu")}
        assert packages == {side}, (name, side, packages)


def test_fallback_sorted_list_is_the_stores_own():
    for side in SIDES:
        durable = importlib.import_module(f"{side}.state.durable")
        fallback = _fallback_sorted_list(durable)
        keys = fallback([b"b", b"a", b"c"])
        keys.add(b"ab")
        keys.discard(b"c")
        assert list(keys) == [b"a", b"ab", b"b"]
        assert list(keys.irange(b"a", b"b", (False, True))) == [b"ab", b"b"]
        assert fallback.__module__ == durable.__name__


# ---------------------------------------------------------------------------
# pure-Python codec and fallback SortedList, in a subprocess


def run_group(group: str, leg: str, root: str) -> dict:
    """Run one group of flows (``e2e``, ``replay``, ``multipartition`` or
    ``seeds``) in one leg, holding each side's log identical; the
    subprocess entry."""
    root_path = Path(root)
    if group == "seeds":
        runs = [(_run_seed, (seed,), f"seed {seed}") for seed in SEEDS]
    else:
        name = {"e2e": "test_engine_e2e", "replay": "test_engine_replay",
                "multipartition": "test_multipartition"}[group]
        runs = [(_run_flow, (n, c, m, f), f"{n}::{c}::{m}") for n, c, m, f in FLOWS
                if n == name]
    records = 0
    for i, (run, args, what) in enumerate(runs):
        ref, port = _both(run, leg, root_path / str(i), *args)
        records += _assert_identical(ref, port, f"{what} ({leg})")
    durable = [importlib.import_module(f"{side}.state.durable") for side in SIDES]
    return {"runs": len(runs), "records": records, "native": _native_loaded(),
            "sorted_list": sorted({d.SortedList.__module__ for d in durable})}


_SUBPROCESS = """
import json, sys
if {block!r}:
    sys.modules["sortedcontainers"] = None  # its import fails: the store's fallback
sys.path.insert(0, {tests!r})
import test_torch_engine as T
print("RESULT", json.dumps(T.run_group({group!r}, {leg!r}, {root!r})))
"""


@pytest.mark.parametrize("leg", LEGS)
@pytest.mark.parametrize("group", ("e2e", "replay", "multipartition", "seeds"))
def test_logs_identical_without_native_codec(group, leg, tmp_path):
    block = leg == "durable-fallback"
    script = _SUBPROCESS.format(block=block, tests=str(TESTS), group=group, leg=leg,
                                root=str(tmp_path))
    env = {**os.environ, "ZEEBE_TPU_NO_NATIVE": "1"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT "))
    result = json.loads(line[len("RESULT "):])
    assert result["runs"] > 0 and result["records"] > 0
    assert result["native"] is False
    # the fallback leg blocks sortedcontainers' import: the stores' own class
    assert result["sorted_list"] == (sorted(f"{side}.state.durable" for side in SIDES)
                                     if block else ["sortedcontainers.sortedlist"])
