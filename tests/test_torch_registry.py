"""The port's KernelRegistry against the JAX package's, on the CPU.

Each registry is fed a catalog of its own package's executables, built from
the same BPMN XML in the same deploy order. The two must agree on every
``_DefInfo`` field, on every decline reason, on every array of the shared
``ProcessTables``, and on ``tables_fingerprint`` as a hex string. The
registry half of the port's ``engine/kernel_backend.py`` is a copy of the
reference's, and a test holds its text to the reference's.
"""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest

import bench
from test_torch_tables import as_copied
from zeebe_tpu.engine.kernel_backend import KernelRegistry as RefRegistry
from zeebe_tpu.models.bpmn import Bpmn
from zeebe_tpu.models.bpmn import parse_bpmn_xml as ref_parse
from zeebe_tpu.models.bpmn import to_bpmn_xml as ref_to_xml
from zeebe_tpu.models.bpmn import transform as ref_transform
from zeebe_tpu_torch.engine import kernel_backend as kb
from zeebe_tpu_torch.testing.catalog import ProcessCatalog

REPO = Path(__file__).resolve().parents[1]


def _call_pair():
    child = (Bpmn.create_executable_process("reg_child").start_event("cs")
             .service_task("ct", job_type="cw").end_event("ce").done())
    caller = (Bpmn.create_executable_process("reg_caller").start_event("s")
              .service_task("before", job_type="bw")
              .call_activity("call", process_id="reg_child")
              .end_event("e").done())
    return [child, caller]


def _parallel_mi():
    return (Bpmn.create_executable_process("reg_mi").start_event("s")
            .service_task("work", job_type="mw")
            .multi_instance(input_collection="= items", input_element="item")
            .end_event("e").done())


def _root_esp():
    return (Bpmn.create_executable_process("reg_esp").start_event("s")
            .service_task("work", job_type="w").end_event("e")
            .event_sub_process("esp")
            .timer_start_event("ts", duration="PT2H")
            .end_event("esp_e").sub_process_done().done())


def _ineligible():
    # a cycle-timer event sub-process start keeps the definition sequential
    return (Bpmn.create_executable_process("reg_cycle").start_event("s")
            .service_task("t", job_type="w").end_event("e")
            .event_sub_process("esp")
            .timer_start_event("ts", cycle="R/PT1H")
            .end_event("ee").sub_process_done().done())


# each set is deployed as one resource per entry, in order
SETS = {
    "one_task": lambda: [[bench.one_task()]],
    "fork_join": lambda: [[bench.fork_join()]],
    "mixed": lambda: [bench.mixed_definitions()],
    "call_activity": lambda: [[m] for m in _call_pair()],
    "parallel_mi": lambda: [[_parallel_mi()]],
    "root_esp": lambda: [[_root_esp()]],
    "ineligible": lambda: [[_ineligible()]],
    "all": lambda: ([[m] for m in _call_pair()] + [[_parallel_mi()], [_root_esp()],
                    [_ineligible()], bench.mixed_definitions()]),
}


def _resources(name: str) -> list[str]:
    return [ref_to_xml(models) for models in SETS[name]()]


def _ref_catalog(resources) -> ProcessCatalog:
    catalog = ProcessCatalog()
    for xml in resources:
        for model in ref_parse(xml):
            catalog.add(ref_transform(model))
    return catalog


def _registries(name: str):
    resources = _resources(name)
    ref_catalog, port_catalog = _ref_catalog(resources), ProcessCatalog.from_xml(resources)
    ref, port = RefRegistry(), kb.KernelRegistry()
    return (ref, ref_catalog, ref_catalog.register(ref),
            port, port_catalog, port_catalog.register(port))


def _segments(info) -> list:
    return [(s.call_row, s.root_row, s.offset, s.flow_offset, s.child_def_key,
             s.child_process_id, s.child_exe.digest) for s in info.segments]


INFO_FIELDS = ("index", "key", "job_types", "job_retries", "join_idxs", "boundary_waits",
               "host_idxs", "mi_inner", "mi_reach", "root_esp_start_idxs",
               "root_esp_waits", "scope_esp_waits")

TABLE_ARRAYS = ("kernel_op", "in_count", "job_type", "out_count", "out_target", "out_cond",
                "out_flow_idx", "default_slot", "start_elem", "elem_count", "scope_start",
                "in_scope", "mi_sequential", "cond_ops", "cond_args")


@pytest.mark.parametrize("name", sorted(SETS))
def test_def_infos_and_declines_equal_reference(name):
    ref, ref_catalog, ref_infos, port, port_catalog, port_infos = _registries(name)
    assert len(ref_infos) == len(port_infos) > 0
    for r, p in zip(ref_infos, port_infos):
        assert (r is None) == (p is None)
        if r is None:
            continue
        for f in INFO_FIELDS:
            assert getattr(r, f) == getattr(p, f), f
        assert _segments(r) == _segments(p)
        assert r.exe.digest == p.exe.digest
        assert [el.id for el in r.exe.elements] == [el.id for el in p.exe.elements]
    for key in ref_catalog.keys:
        assert ref.decline_reason(key) == port.decline_reason(key)
    if name == "call_activity":
        assert port_infos[1].segments, "the call activity was not inlined"
    if name == "parallel_mi":
        assert port_infos[0].mi_inner and port_infos[0].mi_reach
    if name == "root_esp":
        assert port_infos[0].root_esp_start_idxs
    if name == "ineligible":
        assert port_infos == [None]
        assert port.decline_reason(port_catalog.keys[0]) is not None


# (the ineligible set alone has no table set: nothing rides the kernel)
@pytest.mark.parametrize("name", sorted(set(SETS) - {"ineligible"}))
def test_shared_tables_and_fingerprint_equal_reference(name):
    ref, _, ref_infos, port, _, port_infos = _registries(name)
    for field in TABLE_ARRAYS:
        a, b = getattr(ref.tables, field), getattr(port.tables, field)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), field
    assert repr(ref.tables.kernel_config) == repr(port.tables.kernel_config)
    assert ref.tables.token_width == port.tables.token_width
    assert isinstance(port.tables_fingerprint, str)
    assert port.tables_fingerprint == ref.tables_fingerprint


def test_independent_partitions_fingerprint_equal():
    """Two partitions that deployed the same resources in the same order get
    equal digests (the coalescing gate), and a different job type gives a
    different one."""
    resources = _resources("mixed")
    digests = []
    for _ in range(2):
        registry = kb.KernelRegistry()
        ProcessCatalog.from_xml(resources).register(registry)
        digests.append(registry.tables_fingerprint)
    assert digests[0] == digests[1]
    other = kb.KernelRegistry()
    renamed = (Bpmn.create_executable_process("one_task").start_event("start")
               .service_task("task", job_type="other_work").end_event("end").done())
    ProcessCatalog.from_xml([ref_to_xml([renamed])]).register(other)
    one = kb.KernelRegistry()
    ProcessCatalog.from_xml(_resources("one_task")).register(one)
    assert other.tables_fingerprint != one.tables_fingerprint


def test_fingerprint_follows_growth():
    """A lookup that adds a definition recompiles the shared set, and the
    digest follows it."""
    resources = _resources("all")
    catalog = ProcessCatalog.from_xml(resources)
    registry = kb.KernelRegistry()
    seen = []
    for key in catalog.keys:
        if registry.lookup(key, catalog.executable(key), processes=catalog) is not None:
            seen.append(registry.tables_fingerprint)
    assert len(set(seen)) == len(seen) > 1


def test_device_tables_on_the_cpu():
    registry = kb.KernelRegistry()
    ProcessCatalog.from_xml(_resources("mixed")).register(registry)
    dt = registry.device_tables_for("cpu")
    assert registry.device_tables_for("cpu") is dt
    assert dt.device.type == "cpu"
    assert np.array_equal(dt.kernel_op.numpy(), registry.tables.kernel_op)


# ---------------------------------------------------------------------------
# the registry half is a copy

COPIED_DEFS = ("_is_numeric", "_safe_mapping_expr", "_condition_var_names",
               "check_element_eligibility", "_CallSegment", "_shifted_child_elements",
               "_inline_call_activities", "_mi_body_device_eligible", "_inline_mi_bodies",
               "_mi_burst_reach", "_esp_wait_counts", "_DefInfo", "KernelRegistry")
REWRITTEN_MEMBERS = ("device_tables", "device_tables_for")


def _defs(path: Path) -> dict[str, str]:
    """Top-level definitions' source; KernelRegistry without the members
    the port rewrites."""
    text = path.read_text()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.name in COPIED_DEFS:
            if node.name == "KernelRegistry":
                node.body = [m for m in node.body if getattr(m, "name", None)
                             not in REWRITTEN_MEMBERS]
                out[node.name] = ast.dump(node)
            else:
                out[node.name] = ast.get_source_segment(text, node, padded=True)
    return out


@pytest.mark.parametrize("name", COPIED_DEFS)
def test_registry_half_is_a_copy(name):
    ref = _defs(REPO / "zeebe_tpu" / "engine" / "kernel_backend.py")[name]
    port = _defs(REPO / "zeebe_tpu_torch" / "engine" / "kernel_backend.py")[name]
    assert port == as_copied(ref)
