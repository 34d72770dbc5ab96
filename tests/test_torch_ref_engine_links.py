# tests/test_engine_links.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""BPMN link events: throw routes to the matching same-scope catch.

Reference: engine/…/processing/bpmn/event/IntermediateThrowEventProcessor
.java:201-208 (link routing) and bpmn-model link validators. The kernel path
lowers the throw to a K_PASS with a synthetic edge (no SEQUENCE_FLOW_TAKEN),
so the log must stay byte-equal to the sequential engine's.
"""

from __future__ import annotations

import pytest

from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml, parse_bpmn_xml, transform
from zeebe_tpu_torch.models.bpmn.executable import ProcessValidationError
from zeebe_tpu_torch.protocol.enums import BpmnElementType, BpmnEventType
from zeebe_tpu_torch.protocol.intent import ProcessInstanceIntent as PI
from zeebe_tpu_torch.testing import EngineHarness

import torch_kernel_flows; torch_kernel_flows.port_module("test_kernel_backend"); from _kflows_zeebe_tpu_torch_test_kernel_backend import assert_equivalent, drive_jobs


def link_process(pid="link_proc"):
    """start → task_a → throwLink(L) …  catchLink(L) → task_b → end."""
    return (
        Bpmn.create_executable_process(pid)
        .start_event("s")
        .service_task("task_a", job_type="a")
        .intermediate_throw_link("throw_l", "L")
        .intermediate_catch_link("catch_l", "L")
        .service_task("task_b", job_type="b")
        .end_event("e")
        .done()
    )


def link_only_process(pid="link_pure"):
    """Pure routing: start → throw → catch → end (no jobs)."""
    return (
        Bpmn.create_executable_process(pid)
        .start_event("s")
        .intermediate_throw_link("t1", "hop")
        .intermediate_catch_link("c1", "hop")
        .end_event("e")
        .done()
    )


def link_in_subprocess(pid="link_sub"):
    """Link pair inside an embedded sub-process scope."""
    return (
        Bpmn.create_executable_process(pid)
        .start_event("s")
        .sub_process("sub")
        .start_event("is_")
        .intermediate_throw_link("ithrow", "inner")
        .intermediate_catch_link("icatch", "inner")
        .end_event("ie")
        .sub_process_done()
        .end_event("e")
        .done()
    )


class TestLinkSequential:
    def test_process_completes_through_link(self):
        h = EngineHarness(device="cpu")
        try:
            h.deploy(link_process())
            h.create_instance("link_proc", request_id=1)
            assert drive_jobs(h, "a") == 1
            assert drive_jobs(h, "b") == 1
            assert (
                h.exporter.process_instance_records()
                .with_element_id("link_proc")
                .with_intent(PI.ELEMENT_COMPLETED)
                .exists()
            )
        finally:
            h.close()

    def test_no_sequence_flow_between_throw_and_catch(self):
        h = EngineHarness(device="cpu")
        try:
            h.deploy(link_only_process())
            h.create_instance("link_pure", request_id=1)
            taken = (
                h.exporter.process_instance_records()
                .with_intent(PI.SEQUENCE_FLOW_TAKEN)
                .to_list()
            )
            # s→throw and catch→e only; the link jump takes no flow
            assert len(taken) == 2
            lifecycle = [PI.ELEMENT_ACTIVATING, PI.ELEMENT_ACTIVATED,
                         PI.ELEMENT_COMPLETING, PI.ELEMENT_COMPLETED]
            for el_id in ("t1", "c1"):
                intents = [
                    r.record.intent
                    for r in h.exporter.process_instance_records()
                    .events().with_element_id(el_id).to_list()
                ]
                assert intents == lifecycle
        finally:
            h.close()

    def test_link_within_subprocess_scope(self):
        h = EngineHarness(device="cpu")
        try:
            h.deploy(link_in_subprocess())
            h.create_instance("link_sub", request_id=1)
            assert (
                h.exporter.process_instance_records()
                .with_element_id("link_sub")
                .with_intent(PI.ELEMENT_COMPLETED)
                .exists()
            )
        finally:
            h.close()


class TestLinkValidation:
    def test_throw_without_catch_rejected(self):
        model = (
            Bpmn.create_executable_process("p")
            .start_event("s")
            .intermediate_throw_link("t", "nowhere")
            .done()
        )
        with pytest.raises(ProcessValidationError, match="no catch link"):
            transform(model)

    def test_duplicate_catch_names_rejected(self):
        b = (
            Bpmn.create_executable_process("p")
            .start_event("s")
            .intermediate_throw_link("t", "L")
            .intermediate_catch_link("c1", "L")
            .end_event("e1")
        )
        b = b.intermediate_catch_link("c2", "L").end_event("e2")
        with pytest.raises(ProcessValidationError, match="multiple catch link"):
            transform(b.done())

    def test_catch_in_other_scope_does_not_match(self):
        model = (
            Bpmn.create_executable_process("p")
            .start_event("s")
            .sub_process("sub")
            .start_event("is_")
            .intermediate_throw_link("t", "L")
            .sub_process_done()
            .end_event("e")
            .intermediate_catch_link("c", "L")
            .end_event("e2")
            .done()
        )
        with pytest.raises(ProcessValidationError, match="no catch link"):
            transform(model)

    def test_link_target_resolved(self):
        exe = transform(link_process())
        throw = exe.element("throw_l")
        assert throw.link_target_idx == exe.by_id["catch_l"]


class TestLinkXmlRoundTrip:
    def test_round_trip(self):
        xml = to_bpmn_xml(link_process())
        models = parse_bpmn_xml(xml)
        model = models[0] if isinstance(models, list) else models
        throw = model.elements["throw_l"]
        catch = model.elements["catch_l"]
        assert throw.event_type == BpmnEventType.LINK
        assert throw.link_name == "L"
        assert catch.event_type == BpmnEventType.LINK
        assert catch.link_name == "L"
        # the re-parsed model transforms and resolves identically
        exe = transform(model)
        assert exe.element("throw_l").link_target_idx == exe.by_id["catch_l"]


class TestLinkKernelParity:
    def test_byte_parity_with_jobs(self):
        def scenario(h):
            h.deploy(link_process())
            for i in range(8):
                h.create_instance("link_proc", {"n": i}, request_id=50 + i)
            drive_jobs(h, "a")
            drive_jobs(h, "b")

        assert_equivalent(scenario)

    def test_byte_parity_pure_routing(self):
        def scenario(h):
            h.deploy(link_only_process())
            for i in range(16):
                h.create_instance("link_pure", {"n": i}, request_id=100 + i)

        assert_equivalent(scenario)

    def test_byte_parity_in_subprocess(self):
        def scenario(h):
            h.deploy(link_in_subprocess())
            for i in range(6):
                h.create_instance("link_sub", {"n": i}, request_id=200 + i)

        assert_equivalent(scenario)

    def test_kernel_eligibility(self):
        from zeebe_tpu_torch.engine.kernel_backend import check_element_eligibility

        exe = transform(link_process())
        assert check_element_eligibility(exe, exe.element("throw_l"))
        assert check_element_eligibility(exe, exe.element("catch_l"))
