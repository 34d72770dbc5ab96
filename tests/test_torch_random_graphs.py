"""Random graphs through the port's plain automaton and the JAX package's, on
the CPU.

Twelve seeds of the reference's process generator
(``tests/test_randomized_parity.py``'s ``_Gen``; the port's copy is
``zeebe_tpu_torch/testing/random_graphs.py``), every tenth from 5,
compiled as the kernel backend compiles them: one ``KernelRegistry``
holding the twelve definitions, whose shared table set escapes elements
outside the device subset to the host (``K_HOST``); each seed's group runs
its own definition. From the same numpy tables and state (made from a seed),
``run_collect`` chunk by chunk with job waves, ``run_to_completion`` with
and without auto jobs, and the sharded step (eight seeds as eight shards,
one definition each, on the conftest's 8 virtual CPU devices) give packed
rows and states byte-equal to the JAX package's: the tolerance is zero.
The card holds its kernels to this plain version on all 120 seeds
(``chip_smoke.py`` phase 18, ``tests/test_torch_cuda.py``).

Also here: the module's copies held to their sources' text, and the
batched DMN against the host engine on the random tables and the device
suite's own.
"""

from __future__ import annotations

import ast
import functools
import random
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_randomized_parity import _Gen as RefGen
from test_torch_automaton import _assert_equal
from test_torch_tables import as_copied
from zeebe_tpu.models.bpmn import to_bpmn_xml as ref_to_xml
from zeebe_tpu.ops import automaton as JA
from zeebe_tpu.ops.tables import KernelConfig as RefKernelConfig
from zeebe_tpu.parallel import mesh as JM
from zeebe_tpu_torch.engine import kernel_backend as kb
from zeebe_tpu_torch.ops import automaton as TA
from zeebe_tpu_torch.ops import decision as D
from zeebe_tpu_torch.parallel import mesh as TM
from zeebe_tpu_torch.testing import copies
from zeebe_tpu_torch.testing import random_graphs as RG

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
#: every tenth seed from 5: two with host escapes, two with multi-instance bodies
SEEDS = list(range(5, 120, 10))
SHARD_SEEDS = list(range(5, 120, 15))
I = 64
CHUNKS = 16
MAX_STEPS = 48


# ---------------------------------------------------------------------------
# the module's copies


def _source(path: Path, first: str, last: str | None = None) -> str:
    """The text of a module's definitions ``first`` through ``last``."""
    text = path.read_text()
    body = ast.parse(text).body
    names = [copies.definition_name(n) for n in body]
    i, j = names.index(first), names.index(last or first)
    lines = text.splitlines(keepends=True)
    return "".join(lines[copies.source_lines(text, body[i])[0] - 1:body[j].end_lineno])


def _run(first: str, last: str) -> str:
    """The port module's lines between a copied run's markers."""
    lines = (REPO / "zeebe_tpu_torch" / "testing" / "random_graphs.py").read_text() \
        .splitlines(keepends=True)
    start = lines.index(f"# copied from the reference: {first} .. {last}\n")
    end = lines.index("# end of the copy\n", start)
    return "".join(lines[start + 1:end])


@pytest.mark.parametrize("name,first,last",
                         copies.TEST_CODE_COPIES["testing/random_graphs.py"])
def test_copied_run_is_the_references_text(name, first, last):
    """The copied runs are the reference tests' text modulo the package name
    and the history tags (``as_copied``), the drive loop's ``pytest.fail``
    raised as an ``AssertionError``."""
    want = as_copied(_source(REPO / "tests" / name, first, last))
    assert _run(first, last) == want.replace("pytest.fail(", "raise AssertionError(")


def test_table_generator_and_interval_table_are_the_suites():
    module = REPO / "zeebe_tpu_torch" / "testing" / "random_graphs.py"
    assert _source(module, "_random_table_xml") == _source(
        REPO / "tests" / "test_torch_decision.py", "_random_table_xml")
    test = ast.parse((REPO / "tests" / "test_device_decision.py").read_text())
    xml = next(node.value.value for node in ast.walk(test)
               if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant)
               and 'id="iv"' in str(node.value.value))
    assert RG.INTERVALS_DMN == xml


@pytest.mark.parametrize("seed", SEEDS)
def test_generator_builds_the_references_graph(seed):
    rng = random.Random(seed)
    ref = RefGen(rng, f"rand_{seed}")
    xml = ref_to_xml(ref.build())
    port = RG.build_seed(seed)
    assert port.xml == xml and port.instances == rng.randint(1, 3)
    assert (port.gen.job_types_used, port.gen.messages, port.gen.signals,
            port.gen.has_timers) == (ref.job_types_used, ref.messages, ref.signals,
                                     ref.has_timers)


def test_every_seed_registers_with_its_host_escapes():
    """Every one of the 120 seeds yields tables through the registry; host
    escapes (multi-instance bodies the device cannot run, and the like)
    reach the tables of some, as they reach the kernels on the card."""
    escaped = [s for s in RG.SEEDS if RG.host_escapes(RG.seed_registry([s]).tables)]
    assert escaped and len(escaped) < len(RG.SEEDS)
    assert RG.seed_registry(range(8)).tables.num_definitions == 8
    assert RG.host_escapes(_tables()) > 0 and _tables().kernel_config.has_mi


# ---------------------------------------------------------------------------
# the plain automaton against JAX


def _jax(arrays: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in arrays.items()}


@functools.cache
def _tables():
    """The twelve seeds' definitions in one table set, as a partition's
    registry holds them: every seed's group has the same shapes, so JAX
    compiles each program once."""
    return RG.seed_registry(SEEDS).tables


def _setup(seed: int):
    """The shared tables and a group of I instances of the seed's definition."""
    tables = _tables()
    T = RG.token_capacity(tables, I)
    arrays = RG.group_arrays(tables, I, T, np.random.default_rng(seed), [SEEDS.index(seed)])
    return tables, arrays


@pytest.mark.parametrize("seed", SEEDS)
def test_run_collect_matches_jax(seed):
    tables, arrays = _setup(seed)
    config = tables.kernel_config
    jdt, js = JA.DeviceTables.from_tables(tables), _jax(arrays)
    tdt, ts = TA.DeviceTables.from_numpy(tables, CPU), TA.state_from_numpy(arrays, CPU)
    for chunk in range(CHUNKS):
        js, jrows = JA.run_collect(jdt, js, n_steps=8, config=RefKernelConfig(**config.__dict__))
        ts, trows = TA.run_collect(tdt, ts, n_steps=8, config=config)
        jrows = np.asarray(jrows)
        assert jrows.dtype == np.int32 and np.array_equal(jrows, trows.numpy()), chunk
        _assert_equal(js, ts)
        jobs = kb.parked_jobs(tables, ts)
        if jobs.size == 0 and bool(trows[:, -2].eq(0).any()):
            break
        if jobs.size:
            js, ts = JA.complete_jobs(js, jobs), TA.complete_jobs(ts, jobs)


@pytest.mark.parametrize("seed", SEEDS)
def test_run_to_completion_matches_jax(seed):
    tables, arrays = _setup(seed)
    config = tables.kernel_config
    jdt, tdt = JA.DeviceTables.from_tables(tables), TA.DeviceTables.from_numpy(tables, CPU)
    for auto_jobs in (True, False):
        jf, jsteps = JA.run_to_completion(jdt, _jax(arrays), max_steps=MAX_STEPS,
                                          auto_jobs=auto_jobs,
                                          config=RefKernelConfig(**config.__dict__))
        tf, tsteps = TA.run_to_completion(tdt, TA.state_from_numpy(arrays, CPU),
                                          max_steps=MAX_STEPS, auto_jobs=auto_jobs,
                                          config=config)
        _assert_equal(jf, tf)
        assert int(jsteps) == int(tsteps)


def test_sharded_step_matches_jax():
    """Eight seeds, one definition each, as eight shards: the sharded step's
    plain version against ``make_sharded_step`` on 8 virtual CPU devices."""
    tables = RG.seed_registry(SHARD_SEEDS).tables
    n = len(SHARD_SEEDS)
    T = RG.token_capacity(tables, I // 2)
    arrays = RG.shard_arrays(tables, I // 2, T, np.random.default_rng(8), False)
    config = tables.kernel_config
    jmesh = JM.make_mesh(n)
    jstep = JM.make_sharded_step(jmesh, auto_jobs=True, config=RefKernelConfig(**config.__dict__))
    step = TM.make_sharded_step(TM.make_mesh(n, "cpu"), auto_jobs=True, config=config)
    jdt, tdt = JA.DeviceTables.from_tables(tables), TA.DeviceTables.from_numpy(tables, CPU)
    js = JM.shard_state(_jax(arrays), jmesh)
    ts = TM.shard_state(arrays, TM.make_mesh(n, "cpu"))
    for k in range(12):
        js, ts = jstep(jdt, js), step(tdt, ts)
        _assert_equal(js, ts)
    assert int(ts["transitions"]) > 0


# ---------------------------------------------------------------------------
# the batched DMN against the host engine


def test_batch_evaluate_matches_the_host_engine():
    """The port's plain decision path on 50 random tables (every hit policy
    the host engine answers in turn) and the device suite's own tables
    gives the host ``DecisionEngine``'s results; the one difference is the
    reference's own (COLLECT COUNT with no match: 0 against null; ROADMAP
    C, inherited), and it shows."""
    inherited = 0
    for case in RG.decision_cases():
        table = D.compile_decision_table(case.decision)
        inherited += RG.check_against_host(
            case, D.batch_evaluate(table, case.contexts, device="cpu"))
    assert inherited > 0
