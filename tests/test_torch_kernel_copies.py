"""The port's kernel backend is the reference's, copied, but for its device
members; what differs is named here.

``testing/copies.py`` writes the copied runs of
``zeebe_tpu_torch/engine/kernel_backend.py`` (``KERNEL_BACKEND_RUNS``); each
definition in them equals ``as_copied`` of the reference's. Every other
member the reference's ``KernelBackend`` has is one of ``REWRITTEN``: the
device members, defined on the port's ``KernelBackend`` or on its base, the
device-fault seam ``DeviceDefense``; or one of ``INHERITED``: a copy that
the seam holds and the backend inherits. The device half's own group record,
the reference's device-run ``_PendingGroup``, is ``_DeviceRun`` in the
port, so the copied ``_PendingGroup`` keeps its name; the device half's
``Token`` stays beside the copied ``_Token``, which is what the group build
hands out.
"""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest

from test_torch_tables import as_copied
from zeebe_tpu_torch.engine import kernel_backend as kb
from zeebe_tpu_torch.testing import copies

REPO = Path(__file__).resolve().parents[1]
REF_TEXT = (REPO / "zeebe_tpu" / copies.KERNEL_BACKEND).read_text()
PORT_TEXT = (REPO / "zeebe_tpu_torch" / copies.KERNEL_BACKEND).read_text()

#: reference members of KernelBackend the port rewrites, and where
REWRITTEN = {
    "__init__": "KernelBackend", "_start_kernel": "KernelBackend",
    "_await_kernel": "KernelBackend", "_group_state": "KernelBackend",
    "_dispatch_first_chunk": "KernelBackend", "_complete_device_run": "KernelBackend",
    "_fetch_rows": "DeviceDefense", "_contain_device_failure": "DeviceDefense",
    "_shadow_sampled": "DeviceDefense", "_shadow_execute": "DeviceDefense",
    "_verify_steps": "DeviceDefense",
}
#: reference members of KernelBackend that the port's inherits from the
#: seam, whose definitions are copies of the reference's
INHERITED = ("shadow_sample_rate", "dispatch_timeout_ms")
#: the port's own members of KernelBackend: where its shadow oracle starts
PORT_ONLY = {"_oracle_start", "_oracle_chunking"}


def _copied_names(scope):
    """(scope, name) of every definition inside a copied run, by the
    reference's order."""
    out = []
    for run_scope, first, last in copies.KERNEL_BACKEND_RUNS:
        if run_scope != scope:
            continue
        names = [copies.definition_name(n) for n in copies.definitions(REF_TEXT, scope)]
        out += [(scope, n) for n in names[names.index(first):names.index(last) + 1]
                if n is not None]
    return out


COPIED = _copied_names(None) + _copied_names("KernelBackend")


def _segment(text: str, scope, name: str) -> str:
    for node in copies.definitions(text, scope):
        if copies.definition_name(node) == name:
            first, last = copies.source_lines(text, node)
            return "".join(text.splitlines(keepends=True)[first - 1:last])
    raise KeyError(name)


@pytest.mark.parametrize("scope,name", COPIED, ids=[f"{s or 'module'}.{n}" for s, n in COPIED])
def test_member_is_a_copy(scope, name):
    assert _segment(PORT_TEXT, scope, name) == as_copied(_segment(REF_TEXT, scope, name))


@pytest.mark.parametrize("name", INHERITED)
def test_inherited_member_is_a_copy(name):
    assert _segment(PORT_TEXT, "DeviceDefense", name) == as_copied(
        _segment(REF_TEXT, "KernelBackend", name))
    assert name not in vars(kb.KernelBackend)
    assert getattr(kb.KernelBackend, name) is getattr(kb.DeviceDefense, name)


def _members(text: str, cls: str) -> set[str]:
    return {copies.definition_name(n) for n in copies.definitions(text, cls)} - {None}


def test_only_the_named_members_differ():
    ref = _members(REF_TEXT, "KernelBackend")
    port = _members(PORT_TEXT, "KernelBackend")
    copied = {name for scope, name in COPIED if scope == "KernelBackend"}
    assert ref - copied == set(REWRITTEN) | set(INHERITED)
    assert port - copied == {n for n, where in REWRITTEN.items()
                             if where == "KernelBackend"} | PORT_ONLY
    base = _members(PORT_TEXT, "DeviceDefense")
    assert {n for n, where in REWRITTEN.items() if where == "DeviceDefense"} <= base
    assert issubclass(kb.KernelBackend, kb.DeviceDefense)
    # the port's overrides of the seam are its own members only
    assert not (set(vars(kb.KernelBackend)) & {n for n, w in REWRITTEN.items()
                                                if w == "DeviceDefense"})


def test_device_run_is_renamed_and_the_copies_keep_their_names():
    """The device half's run record is ``_DeviceRun``; the one
    ``_PendingGroup`` is the copied one."""
    port = {copies.definition_name(n) for n in ast.parse(PORT_TEXT).body}
    assert "_DeviceRun" in port
    assert sum(copies.definition_name(n) == "_PendingGroup"
               for n in ast.parse(PORT_TEXT).body) == 1
    assert {"Token", "_Token", "GroupInstance", "_Inst", "_Admitted"} <= port
    assert [f.name for f in kb._PendingGroup.__dataclass_fields__.values()][0] == "admitted"


def test_group_build_and_trace_are_the_backends(monkeypatch):
    """``build_group_arrays`` and ``cascade_ops`` (``drive_group``'s) run the
    copied members: a new instance's token is the copied ``_Token``."""
    tables = kb.deploy([_ONE_TASK])
    insts = [kb.GroupInstance(idx=0, definition=0)]
    arrays, I, T = kb.build_group_arrays(tables, insts, 64)
    tok = insts[0].tokens[0]
    assert type(tok) is kb._Token and (tok.key, tok.value, tok.act_idx) == (-1, {}, -1)
    assert arrays["elem"][0] == tables.start_elem[0] and (I, T) == (64, 64)
    seen = []
    monkeypatch.setattr(kb.KernelBackend, "_cascade_ops",
                        lambda backend, inst, steps: seen.append(
                            (backend.registry.tables, inst.info.index)) or ["traced"])
    assert kb.cascade_ops(tables, insts[0], []) == ["traced"]
    assert seen == [(tables, 0)]
    assert kb._pow2 is kb.KernelBackend._pow2 and kb._pow2(65) == 128
    assert np.array_equal(arrays["done"][1:], np.ones(I - 1, np.bool_))


_ONE_TASK = """<?xml version="1.0" encoding="UTF-8"?>
<bpmn:definitions xmlns:bpmn="http://www.omg.org/spec/BPMN/20100524/MODEL"
  xmlns:zeebe="http://camunda.org/schema/zeebe/1.0" id="d" targetNamespace="t">
  <bpmn:process id="one_task" isExecutable="true">
    <bpmn:startEvent id="start"/>
    <bpmn:sequenceFlow id="f1" sourceRef="start" targetRef="task"/>
    <bpmn:serviceTask id="task">
      <bpmn:extensionElements><zeebe:taskDefinition type="work"/></bpmn:extensionElements>
    </bpmn:serviceTask>
    <bpmn:sequenceFlow id="f2" sourceRef="task" targetRef="end"/>
    <bpmn:endEvent id="end"/>
  </bpmn:process>
</bpmn:definitions>
"""


def test_copy_runs_are_the_scripts():
    """The marked runs of the port's file are what the copy script writes."""
    assert copies.splice_runs(PORT_TEXT, REF_TEXT) == PORT_TEXT
    for scope, first, last in copies.KERNEL_BACKEND_RUNS:
        assert copies.BEGIN.format(first, last) in PORT_TEXT
