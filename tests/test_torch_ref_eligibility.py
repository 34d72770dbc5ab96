# tests/test_eligibility.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""The kernel observatory: reason catalog, static eligibility
classifier, consolidated path accounting, parity gate, wave events, and
bounded flight dumps.

The fixture definitions under tests/fixtures/eligibility/ carry one
host-forcing shape each (plus one fully-eligible definition); every test
asserts EXACT reason codes so a classifier change that silently re-labels
a shape fails here, not in a dashboard."""

from __future__ import annotations

import ast
import json
from pathlib import Path

import pytest

from zeebe_tpu_torch.engine.eligibility import (
    ALL_REASONS,
    DEFINITION_REASONS,
    HEAD_FAMILIES,
    RUNTIME_REASONS,
    STATIC_ELEMENT_REASONS,
    PathAccounting,
    canonical_reason,
    classify_definition,
    parity_violations,
)
from zeebe_tpu_torch.models.bpmn import Bpmn, parse_bpmn_xml
from zeebe_tpu_torch.models.bpmn.executable import transform
from zeebe_tpu_torch.testing import EngineHarness

FIXTURES = Path(__file__).parent / "fixtures" / "eligibility"
REPO = Path(__file__).resolve().parent.parent


def classify_fixture(name: str) -> dict:
    (model,) = parse_bpmn_xml((FIXTURES / name).read_text())
    return classify_definition(transform(model))


def host_reasons_of(report: dict) -> dict[str, str]:
    return {el["id"]: el.get("reason") for el in report["elements"]
            if el["path"] == "host"}


# ---------------------------------------------------------------------------
# the catalog


class TestReasonCatalog:
    def test_catalog_groups_are_disjoint_families_aside(self):
        assert not (STATIC_ELEMENT_REASONS & RUNTIME_REASONS)
        assert not (RUNTIME_REASONS & HEAD_FAMILIES)
        # definition-level shares only condition-not-compilable with the
        # element level (the same compile declines both granularities)
        assert (DEFINITION_REASONS & STATIC_ELEMENT_REASONS
                == {"condition-not-compilable"})

    def test_canonical_reason(self):
        assert canonical_reason("no-quiesce") == "no-quiesce"
        assert canonical_reason("multi-instance") == "multi-instance"
        assert (canonical_reason("head-sequential:DEPLOYMENT.CREATE")
                == "head-sequential")
        assert (canonical_reason("head-not-admittable:JOB.COMPLETE")
                == "head-not-admittable")
        assert canonical_reason("made-up-reason") is None

    def test_every_reason_has_a_note_and_no_stale_notes(self):
        from zeebe_tpu_torch.analysis.eligibility_notes import (
            stale_reason_notes,
            undocumented_reasons,
        )

        assert undocumented_reasons() == []
        assert stale_reason_notes() == []

    def test_committed_doc_matches_generated(self):
        """Tree gate mirroring CI's `cli eligibility-doc --check`."""
        from zeebe_tpu_torch.analysis.eligibility_notes import render_eligibility_doc

        committed = (REPO / "zeebe_tpu_torch" / "docs" / "eligibility.md").read_text()
        assert committed == render_eligibility_doc(), (
            "docs/eligibility.md drifted — regenerate with "
            "`python -m zeebe_tpu_torch.cli eligibility-doc`")

    def test_no_unregistered_reason_literals_in_source(self):
        """Satellite: every reason string the two accounting seams note
        must resolve against the catalog — a stale or unregistered literal
        fails HERE, not by silently minting a new metric label."""
        sources = [
            REPO / "zeebe_tpu_torch" / "engine" / "kernel_backend.py",
            REPO / "zeebe_tpu_torch" / "stream" / "processor.py",
        ]
        checked = 0
        for path in sources:
            tree = ast.parse(path.read_text())
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "note_host" and node.args):
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    assert canonical_reason(arg.value) is not None, (
                        f"{path.name}: unregistered reason {arg.value!r}")
                    checked += 1
                elif isinstance(arg, ast.JoinedStr):
                    head = arg.values[0]
                    assert isinstance(head, ast.Constant), ast.dump(arg)
                    family = str(head.value).split(":", 1)[0]
                    assert family in HEAD_FAMILIES, (
                        f"{path.name}: unregistered reason family "
                        f"{head.value!r}")
                    checked += 1
                else:
                    # dynamic argument (pg.fail_reason or ...): both operands
                    # must be catalog members — covered by the runtime tests
                    checked += 1
        assert checked >= 4  # the seams this satellite consolidated


# ---------------------------------------------------------------------------
# per-reason fixtures — exact codes


class TestClassifierFixtures:
    def test_fully_eligible(self):
        report = classify_fixture("eligible.bpmn")
        assert report["eligible"] is True
        assert report["definitionReasons"] == []
        assert report["counts"]["host"] == 0
        assert host_reasons_of(report) == {}

    def test_multi_instance(self):
        report = classify_fixture("multi_instance.bpmn")
        assert report["eligible"] is True  # element escapes, definition rides
        assert host_reasons_of(report) == {"each": "multi-instance"}

    def test_timer_cycle(self):
        report = classify_fixture("timer_cycle.bpmn")
        assert host_reasons_of(report) == {"every": "timer-cycle-date"}

    def test_escalation_boundary(self):
        report = classify_fixture("escalation_boundary.bpmn")
        reasons = host_reasons_of(report)
        assert reasons["esc"] == "escalation-boundary"
        assert reasons["scope"] == "boundary-on-nontask"

    def test_unsafe_expression(self):
        report = classify_fixture("unsafe_expression.bpmn")
        assert host_reasons_of(report) == {"t": "unsafe-expression"}

    def test_event_subprocess_body(self):
        report = classify_fixture("esp_message_start.bpmn")
        assert report["eligible"] is True
        reasons = host_reasons_of(report)
        assert reasons["handle"] == "event-subprocess-body"
        assert reasons["esp_e"] == "event-subprocess-body"

    def test_no_none_start_is_definition_level(self):
        report = classify_fixture("no_none_start.bpmn")
        assert report["eligible"] is False
        assert report["definitionReasons"] == ["no-none-start"]
        assert report["counts"]["kernel"] == 0

    def test_native_user_task(self):
        report = classify_fixture("user_task.bpmn")
        assert host_reasons_of(report) == {"review": "user-task"}

    def test_esp_cycle_start_declines_definition(self):
        model = (
            Bpmn.create_executable_process("esp_cyc").start_event("s")
            .service_task("t", job_type="w").end_event("e")
            .event_sub_process("esp")
            .timer_start_event("ts", cycle="R/PT1M")
            .end_event("esp_e")
            .sub_process_done().done())
        report = classify_definition(transform(model))
        assert report["eligible"] is False
        assert report["definitionReasons"] == ["esp-start-unsupported"]

    def test_joint_classification_sees_registry_capacity(self):
        """A shared registry makes the prediction deployment-SET-aware:
        the definition past max_definitions is typed table-set-full (a
        solo classifier cannot see this — the bench parity gate classifies
        jointly for exactly this reason)."""
        from zeebe_tpu_torch.engine.kernel_backend import KernelRegistry

        reg = KernelRegistry(max_definitions=2)
        reports = [
            classify_definition(transform(eligible_def(f"joint_{i}")),
                                definition_key=i + 1, registry=reg)
            for i in range(3)
        ]
        assert [r["eligible"] for r in reports] == [True, True, False]
        assert reports[2]["definitionReasons"] == ["table-set-full"]

    def test_every_fixture_reason_is_in_catalog(self):
        for path in sorted(FIXTURES.glob("*.bpmn")):
            (model,) = parse_bpmn_xml(path.read_text())
            report = classify_definition(transform(model))
            for el in report["elements"]:
                reason = el.get("reason")
                if reason is not None:
                    assert reason in ALL_REASONS, (path.name, el)
            for reason in report["definitionReasons"]:
                assert reason in DEFINITION_REASONS, (path.name, reason)


# ---------------------------------------------------------------------------
# PathAccounting — the one counter home


class TestPathAccounting:
    def test_counts_and_coverage(self):
        acct = PathAccounting("t-unit-1")
        acct.note_kernel("defA", 3)
        acct.note_host("head-sequential:DEPLOYMENT.CREATE")
        acct.note_host("no-quiesce", "defA")
        assert acct.kernel_records == 3
        assert acct.host_records == 2
        assert acct.coverage_ratio() == pytest.approx(0.6)
        snap = acct.snapshot()
        assert snap["perDefinition"]["defA"] == {
            "kernel": 3, "host": 1, "coverageRatio": 0.75,
            "hostReasons": {"no-quiesce": 1},
        }
        assert snap["perDefinition"]["-"]["host"] == 1
        assert {r["reason"] for r in snap["topFallbackReasons"]} == {
            "head-sequential:DEPLOYMENT.CREATE", "no-quiesce"}

    def test_unregistered_reason_is_quarantined(self):
        acct = PathAccounting("t-unit-2")
        acct.note_host("never-registered")
        assert acct.unregistered == {"never-registered": 1}
        # the full string still lands in the Counter (nothing is lost)
        assert acct.reasons["never-registered"] == 1

    def test_registry_metric_children(self):
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        acct = PathAccounting("t-unit-3")
        acct.note_kernel("defZ", 5)
        acct.note_host("token-overflow", "defZ")
        rows = {
            (labels, value)
            for name, _kind, labels, value in REGISTRY.snapshot()
            if name == "zeebe_kernel_records_total"
            and 't-unit-3' in str(labels)
        }
        by_label = {labels: value for labels, value in rows}
        assert any("kernel" in str(k) and v == 5 for k, v in by_label.items())
        assert any("token-overflow" in str(k) and v == 1
                   for k, v in by_label.items())
        gauge = [
            value for name, _kind, labels, value in REGISTRY.snapshot()
            if name == "zeebe_kernel_coverage_ratio"
            and "t-unit-3" in str(labels) and "defZ" in str(labels)
        ]
        assert gauge == [pytest.approx(5 / 6)]

    def test_definition_overflow_folds_into_other(self):
        acct = PathAccounting("t-unit-4")
        for i in range(PathAccounting.MAX_DEFINITIONS):
            acct.note_kernel(f"def{i}")
        acct.note_kernel("one-too-many")
        acct.note_host("no-quiesce", "and-another")
        assert "one-too-many" not in acct.per_definition
        assert acct.per_definition["other"][0] == 1
        assert acct.per_definition["other"][1] == 1

    def test_mark_delta(self):
        acct = PathAccounting("t-unit-5")
        acct.note_kernel("d", 2)
        mark = acct.mark()
        acct.note_kernel("d", 3)
        acct.note_host("geometry-bounds", "d")
        delta = acct.delta_since(mark)
        assert delta["kernel"] == 3 and delta["host"] == 1
        assert delta["perDefinition"]["d"] == {
            "kernel": 3, "host": 1,
            "hostReasons": {"geometry-bounds": 1}}
        assert delta["reasons"] == {"geometry-bounds": 1}


# ---------------------------------------------------------------------------
# the parity gate


class TestParityGate:
    def test_green_on_matching_prediction(self):
        observed = {
            "a": {"kernel": 10, "host": 2,
                  "hostReasons": {"no-quiesce": 1,
                                  "head-sequential:DEPLOYMENT.CREATE": 1}},
            "b": {"kernel": 0, "host": 5,
                  "hostReasons": {
                      "head-not-admittable:PROCESS_INSTANCE_CREATION.CREATE": 5}},
        }
        assert parity_violations({"a": True, "b": False}, observed) == []

    def test_eligible_but_host_routed_is_violation(self):
        observed = {"a": {"kernel": 0, "host": 4, "hostReasons": {
            "head-not-admittable:JOB.COMPLETE": 4}}}
        (violation,) = parity_violations({"a": True}, observed)
        assert "non-runtime" in violation and "a" in violation

    def test_ineligible_but_kernel_routed_is_violation(self):
        observed = {"b": {"kernel": 3, "host": 0, "hostReasons": {}}}
        (violation,) = parity_violations({"b": False}, observed)
        assert "rode the kernel" in violation

    def test_runtime_reasons_never_count_against_prediction(self):
        observed = {"a": {"kernel": 0, "host": 3,
                          "hostReasons": {"no-quiesce": 2,
                                          "geometry-bounds": 1}}}
        assert parity_violations({"a": True}, observed) == []

    def test_undeclared_definitions_are_skipped(self):
        observed = {"-": {"kernel": 0, "host": 9, "hostReasons": {
            "head-sequential:MESSAGE.PUBLISH": 9}}}
        assert parity_violations({"a": True}, observed) == []


# ---------------------------------------------------------------------------
# runtime: accounting + waves through a real kernel partition


def eligible_def(pid="acct_ok"):
    return (
        Bpmn.create_executable_process(pid).start_event("s")
        .service_task("t", job_type="acct_work").end_event("e").done())


def host_forced_def(pid="acct_msgstart"):
    # message-start-only: definition-level no-none-start (kernel declines
    # registration; creations take the sequential path)
    return (
        Bpmn.create_executable_process(pid)
        .message_start_event("ms", "acct_kick")
        .service_task("t", job_type="acct_host_work").end_event("e").done())


class TestRuntimeAccounting:
    def test_mixed_definition_parity_prediction_equals_observation(self):
        """The seeded mixed run: one kernel-eligible and one host-forced
        definition drive both paths; the classifier's prediction must match
        the observed routing (the bench gate's logic, in-tree)."""
        h = EngineHarness(use_kernel_backend=True, device="cpu")
        try:
            h.deploy(eligible_def(), host_forced_def())
            acct = h.kernel_backend.accounting
            mark = acct.mark()
            predictions = {
                m.process_id: classify_definition(transform(m))["eligible"]
                for m in (eligible_def(), host_forced_def())
            }
            assert predictions == {"acct_ok": True, "acct_msgstart": False}
            for _ in range(6):
                h.create_instance("acct_ok", {})
            for _ in range(3):
                h.create_instance("acct_msgstart", {})
            h.pump()
            delta = acct.delta_since(mark)
            obs = delta["perDefinition"]
            assert obs["acct_ok"]["kernel"] >= 6
            assert obs["acct_ok"].get("host", 0) == 0
            assert obs["acct_msgstart"]["kernel"] == 0
            assert obs["acct_msgstart"]["host"] >= 3
            assert all(
                r.startswith("head-not-admittable:PROCESS_INSTANCE_CREATION")
                for r in obs["acct_msgstart"]["hostReasons"])
            assert parity_violations(predictions, obs) == []
            # and the gate actually bites: flip the prediction
            assert parity_violations({"acct_msgstart": True}, obs)

        finally:
            h.close()
    def test_no_unregistered_reasons_after_driving(self):
        h = EngineHarness(use_kernel_backend=True, device="cpu")
        try:
            h.deploy(eligible_def("acct_clean"), host_forced_def("acct_h2"))
            for _ in range(4):
                h.create_instance("acct_clean", {})
            h.create_instance("acct_h2", {})
            h.pump()
            assert h.kernel_backend.accounting.unregistered == {}

        finally:
            h.close()
    def test_fallback_reasons_alias_preserved(self):
        """BENCH back-compat: kernel.fallback_reasons IS the accounting
        Counter (clear() clears both — the bench reset protocol)."""
        h = EngineHarness(use_kernel_backend=True, device="cpu")
        try:
            h.deploy(eligible_def("acct_alias"))
            h.create_instance("acct_alias", {})
            h.pump()
            k = h.kernel_backend
            assert k.fallback_reasons is k.accounting.reasons
            k.fallback_reasons.clear()
            assert sum(k.accounting.reasons.values()) == 0

        finally:
            h.close()
    def test_kernel_wave_events_emitted(self):
        h = EngineHarness(use_kernel_backend=True, device="cpu")
        try:
            events: list[dict] = []
            h.processor.wave_listener = events.append
            h.deploy(eligible_def("acct_wave"))
            for _ in range(8):
                h.create_instance("acct_wave", {})
            h.pump()
            assert events, "no kernel_wave event emitted"
            ev = events[0]
            assert ev["waves"] >= 1
            assert ev["commands"] >= 1
            assert ev["kernelRecords"] >= 1
            assert 0.0 <= ev["coverageRatio"] <= 1.0
            assert "avgWave" in ev and "chunks" in ev

        finally:
            h.close()
    def test_dispatch_overlap_gauge_set(self):
        from zeebe_tpu_torch.utils.metrics import REGISTRY

        h = EngineHarness(use_kernel_backend=True, device="cpu")
        try:
            h.deploy(eligible_def("acct_overlap"))
            for _ in range(4):
                h.create_instance("acct_overlap", {})
            h.pump()
            values = [
                value for name, _k, labels, value in REGISTRY.snapshot()
                if name == "zeebe_kernel_dispatch_overlap_ratio"
            ]
            assert values, "overlap gauge never set"
            assert all(0.0 <= v <= 1.0 for v in values)

        finally:
            h.close()
    def test_registry_decline_reason_typed(self):
        h = EngineHarness(use_kernel_backend=True, device="cpu")
        try:
            h.deploy(host_forced_def("acct_decline"))
            h.create_instance("acct_decline", {})
            h.pump()
            reg = h.kernel_backend.registry
            keys = list(reg._ineligible)
            assert keys, "definition never consulted the registry"
            assert reg.decline_reason(keys[0]) == "no-none-start"


        finally:
            h.close()
# ---------------------------------------------------------------------------
# bounded flight dumps


class TestBoundedFlightDumps:
    def test_dump_truncates_oldest_first(self, tmp_path):
        from zeebe_tpu_torch.observability.flight_recorder import FlightRecorder

        rec = FlightRecorder("n1", tmp_path, capacity=4096,
                             max_dump_bytes=8_192)
        for i in range(2_000):
            # non-ASCII padding: the cap must hold in BYTES on disk
            # whatever the serializer's escaping does with it
            rec.record(1, "noise", seq=i, pad="ü" * 20)
        rec.record(1, "the_crash", seq=999_999)
        path = rec.dump("test", force=True)
        assert path is not None
        assert path.stat().st_size <= 8_192
        body = path.read_text()
        payload = json.loads(body)
        assert payload["truncatedEntries"] > 0
        events = payload["partitions"]["1"]
        # newest evidence survives; the oldest entries were dropped
        assert events[-1]["kind"] == "the_crash"
        assert events[0]["seq"] > 0

    def test_small_dump_untouched(self, tmp_path):
        from zeebe_tpu_torch.observability.flight_recorder import FlightRecorder

        rec = FlightRecorder("n1", tmp_path, max_dump_bytes=262_144)
        rec.record(1, "only_event")
        path = rec.dump("test", force=True)
        payload = json.loads(path.read_text())
        assert "truncatedEntries" not in payload
        assert len(payload["partitions"]["1"]) == 1

    def test_env_knob_controls_cap(self, tmp_path, monkeypatch):
        from zeebe_tpu_torch.observability import flight_recorder as fr

        monkeypatch.setenv("ZEEBE_FLIGHT_MAXDUMPBYTES", "4096")
        rec = fr.FlightRecorder("n1", tmp_path)
        assert rec.max_dump_bytes == 4096


# ---------------------------------------------------------------------------
# CLI surfaces


class TestEligibilityCli:
    def test_file_mode_json(self, tmp_path, capsys):
        from zeebe_tpu_torch import cli

        rc = cli.main(["eligibility",
                       str(FIXTURES / "multi_instance.bpmn")])
        assert rc == 0
        payload = json.loads(capsys.readouterr().out)
        (report,) = payload["definitions"]
        assert report["bpmnProcessId"] == "elig_mi"
        assert host_reasons_of(report) == {"each": "multi-instance"}

    def test_file_mode_output_artifact(self, tmp_path, capsys):
        from zeebe_tpu_torch import cli

        out = tmp_path / "report.json"
        rc = cli.main(["eligibility", str(FIXTURES / "eligible.bpmn"),
                       "-o", str(out)])
        assert rc == 0
        payload = json.loads(out.read_text())
        assert payload["definitions"][0]["eligible"] is True

    def test_deployed_mode_over_harness_journal(self, tmp_path, capsys):
        from zeebe_tpu_torch import cli

        h = EngineHarness(directory=tmp_path, use_kernel_backend=True, device="cpu")
        try:
            h.deploy(eligible_def("cli_dep_ok"),
                     host_forced_def("cli_dep_host"))
            h.pump()
        finally:
            h.close()
        rc = cli.main(["eligibility", "--deployed",
                       "--data-dir", str(tmp_path)])
        assert rc == 0
        payload = json.loads(capsys.readouterr().out)
        by_id = {r["bpmnProcessId"]: r for r in payload["definitions"]}
        assert by_id["cli_dep_ok"]["eligible"] is True
        assert by_id["cli_dep_host"]["eligible"] is False
        assert by_id["cli_dep_host"]["definitionReasons"] == ["no-none-start"]

    def test_eligibility_doc_check_green(self, capsys):
        from zeebe_tpu_torch import cli

        assert cli.main(["eligibility-doc", "--check"]) == 0

    def test_top_renders_kernel_coverage_section(self):
        from zeebe_tpu_torch.cli import _render_top

        frame = _render_top({
            "clusterSize": 1, "partitionsCount": 1, "health": "HEALTHY",
            "topology": {"version": 1},
            "brokers": [{
                "nodeId": "broker-0", "health": "HEALTHY",
                "partitions": {"1": {
                    "role": "leader", "term": 1,
                    "kernelCoverage": {
                        "kernelRecords": 900, "hostRecords": 100,
                        "coverageRatio": 0.9,
                        "dominantHostReason":
                            "head-sequential:DEPLOYMENT.CREATE"},
                }},
            }],
        })
        assert "KERNEL" in frame
        assert "90.0%" in frame
        assert "head-sequential:DEPLOYMENT.CREATE" in frame

    def test_health_carries_kernel_coverage(self):
        """registry → accounting → partition /health block end-to-end
        (cluster-status rows share the same accounting object)."""
        h = EngineHarness(use_kernel_backend=True, device="cpu")
        try:
            h.deploy(eligible_def("health_cov"))
            for _ in range(3):
                h.create_instance("health_cov", {})
            h.pump()
            snap = h.kernel_backend.accounting.snapshot()
            assert snap["kernelRecords"] >= 3
            assert 0.0 <= snap["coverageRatio"] <= 1.0
            assert "health_cov" in snap["perDefinition"]

        finally:
            h.close()