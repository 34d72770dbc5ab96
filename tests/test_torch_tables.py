"""The port's deploy path (BPMN XML → model → executable → tables) against the
JAX package's: the same XML resource must compile to equal table arrays.

Models are built with the reference's fluent builder and serialized with the
reference's ``to_bpmn_xml``; each side then parses that XML itself. Covers
the automaton test fixtures, the benchmark workloads and seeded random
series-parallel processes (the randomized parity suite's generator).
"""

from __future__ import annotations

import random
import re
from pathlib import Path

import numpy as np
import pytest

import bench
from test_automaton import exe_branching, exe_fork_join, exe_one_task
from test_randomized_parity import _Gen
from zeebe_tpu.models.bpmn import Bpmn as RefBpmn
from zeebe_tpu.models.bpmn import parse_bpmn_xml as ref_parse
from zeebe_tpu.models.bpmn import to_bpmn_xml as ref_to_xml
from zeebe_tpu.models.bpmn import transform as ref_transform
from zeebe_tpu.ops.tables import compile_tables as ref_compile
from zeebe_tpu.protocol import enums as ref_enums
from zeebe_tpu_torch.models.bpmn import parse_bpmn_xml, transform
from zeebe_tpu_torch.ops.tables import compile_tables
from zeebe_tpu_torch.protocol import enums
from zeebe_tpu_torch.testing import workloads

REPO = Path(__file__).resolve().parents[1]

ARRAYS = ("kernel_op", "in_count", "job_type", "out_count", "out_target", "out_cond",
          "out_flow_idx", "default_slot", "start_elem", "elem_count", "scope_start",
          "in_scope", "mi_sequential", "cond_ops", "cond_args")


def _assert_tables_equal(ref, port) -> None:
    for name in ARRAYS:
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    assert ref.token_width == port.token_width
    assert ref.slot_map.names == port.slot_map.names
    assert ref.slot_map.kinds == port.slot_map.kinds
    assert ref.interner.ids == port.interner.ids
    assert ref.job_type_names == port.job_type_names
    assert ref.cond_vars_by_def == port.cond_vars_by_def
    assert ref.kernel_config.__dict__ == port.kernel_config.__dict__
    assert [d.process_id for d in ref.definitions] == [d.process_id for d in port.definitions]


def _compile_both(xml: str, host_escape: bool):
    ref_exes = [ref_transform(m) for m in ref_parse(xml)]
    port_exes = [transform(m) for m in parse_bpmn_xml(xml)]
    if host_escape:
        return (ref_compile(ref_exes, host_idxs=[set() for _ in ref_exes]),
                compile_tables(port_exes, host_idxs=[set() for _ in port_exes]))
    return ref_compile(ref_exes), compile_tables(port_exes)


def _nomatch():
    return (RefBpmn.create_executable_process("nomatch").start_event("s")
            .exclusive_gateway("gw").condition_expression("x > 10")
            .end_event("e").done())


def _negated():
    return (RefBpmn.create_executable_process("neg").start_event("s")
            .exclusive_gateway("gw").sequence_flow_id("low")
            .condition_expression("not(x > 10)")
            .service_task("low_task", job_type="low").end_event("e1")
            .move_to_element("gw").default_flow()
            .service_task("high_task", job_type="high").end_event("e2").done())


def _strings():
    return (RefBpmn.create_executable_process("strs").start_event("s")
            .exclusive_gateway("gw").condition_expression('status = "active"')
            .end_event("a").move_to_element("gw")
            .condition_expression('status < "done" and -y < 3')
            .end_event("b").move_to_element("gw").default_flow()
            .end_event("c").done())


def _fixture_models():
    """The automaton test fixtures, rebuilt as models (the fixtures return
    executables; their builders are reproduced by id here)."""
    return {
        "one_task": [RefBpmn.create_executable_process("one_task").start_event("start")
                     .service_task("task", job_type="work").end_event("end").done()],
        "branching": [RefBpmn.create_executable_process("branching").start_event("start")
                      .exclusive_gateway("gw").sequence_flow_id("to_big")
                      .condition_expression("amount >= 100")
                      .service_task("big", job_type="big-order").end_event("end_big")
                      .move_to_element("gw").sequence_flow_id("to_small").default_flow()
                      .service_task("small", job_type="small-order").end_event("end_small")
                      .done()],
        "fork_join": [RefBpmn.create_executable_process("fj").start_event("s")
                      .parallel_gateway("fork").service_task("a", job_type="a")
                      .parallel_gateway("join").end_event("e").move_to_element("fork")
                      .service_task("b", job_type="b").connect_to("join").done()],
        "nomatch": [_nomatch()],
        "negated": [_negated()],
        "strings": [_strings()],
    }


@pytest.mark.parametrize("name", sorted(_fixture_models()))
def test_fixture_tables_equal(name):
    models = _fixture_models()[name]
    ref, port = _compile_both(ref_to_xml(models), host_escape=False)
    _assert_tables_equal(ref, port)


def test_fixture_models_match_test_automaton():
    """The rebuilt fixtures compile to the same tables as test_automaton's."""
    models = _fixture_models()
    for name, exe in (("one_task", exe_one_task()), ("branching", exe_branching()),
                      ("fork_join", exe_fork_join())):
        _assert_tables_equal(ref_compile([exe]),
                             ref_compile([ref_transform(models[name][0])]))


BENCH = {
    "one_task": lambda: [bench.one_task()],
    "exclusive_chain": lambda: [bench.exclusive_chain()],
    "fork_join": lambda: [bench.fork_join()],
    "ten_tasks": lambda: [bench.ten_tasks()],
    "ten_tasks_io": lambda: [bench.ten_tasks_io()],
    "subprocess_boundary": lambda: [bench.subprocess_boundary()],
    "mixed_definitions": bench.mixed_definitions,
}

PORT_BUILDERS = {
    "one_task": lambda: [workloads.one_task()],
    "exclusive_chain": lambda: [workloads.exclusive_chain()],
    "fork_join": lambda: [workloads.fork_join()],
    "ten_tasks": lambda: [workloads.ten_tasks()],
    "ten_tasks_io": lambda: [workloads.ten_tasks_io()],
    "subprocess_boundary": lambda: [workloads.subprocess_boundary()],
    "mixed_definitions": workloads.mixed_definitions,
}


@pytest.mark.parametrize("name", sorted(BENCH))
def test_bench_tables_equal(name):
    xml = ref_to_xml(BENCH[name]())
    ref, port = _compile_both(xml, host_escape=True)
    _assert_tables_equal(ref, port)
    # the port's copy of the builders serializes to the same resource
    assert workloads.to_xml(PORT_BUILDERS[name]()) == xml


@pytest.mark.parametrize("seed", range(20))
def test_random_process_tables_equal(seed):
    gen = _Gen(random.Random(seed), f"rand_{seed}")
    xml = ref_to_xml(gen.build())
    ref, port = _compile_both(xml, host_escape=True)
    _assert_tables_equal(ref, port)


def test_enums_match_reference():
    for name in ("BpmnElementType", "BpmnEventType"):
        ref, port = getattr(ref_enums, name), getattr(enums, name)
        assert [(m.name, m.value) for m in ref] == [(m.name, m.value) for m in port]


COPIED = ("feel/temporal.py", "feel/feel.py", "feel/__init__.py", "models/bpmn/model.py",
          "models/bpmn/executable.py", "models/bpmn/xml_io.py", "models/bpmn/__init__.py",
          "ops/tables.py", "engine/eligibility.py", "utils/metrics.py")


def as_copied(ref: str) -> str:
    """The reference's text as the port copies it: the package name renamed
    (``zeebe_tpu.`` and ``from zeebe_tpu import`` in its imports, and the
    bare name quoted as a string or a literal: the logger hierarchy's root),
    and the reference's history tags (an issue or pull request number) left
    out of comments and docstrings."""
    text = ref.replace("zeebe_tpu.", "zeebe_tpu_torch.")
    text = text.replace("from zeebe_tpu import ", "from zeebe_tpu_torch import ")
    text = text.replace('"zeebe_tpu"', '"zeebe_tpu_torch"')
    text = text.replace("``zeebe_tpu``", "``zeebe_tpu_torch``")
    # a tag broken over two lines of a comment or a docstring
    text = re.sub(r" ?\((?:ISSUE|PR)\n[ \t]*(?:# )?\d+\)", "", text)
    text = re.sub(r",? (?:ISSUE|PR)\n[ \t]*(?:# )?\d+\)", ")", text)
    return re.sub(r" ?(?:by )?\(?\b(?:ISSUE|PR) \d+(?: satellite)?\)?", "", text)


@pytest.mark.parametrize("path", COPIED)
def test_copied_module_unchanged(path):
    """The JAX-free modules are copies: identical to the reference's but for
    the package name in their imports (and the history tags, ``as_copied``)."""
    ref = (REPO / "zeebe_tpu" / path).read_text()
    port = (REPO / "zeebe_tpu_torch" / path).read_text()
    assert port == as_copied(ref)
