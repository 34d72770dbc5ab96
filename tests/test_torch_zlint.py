"""zlint on the port (zeebe_tpu_torch/analysis): rule-by-rule fixture
proofs, the tree gate over the port's own tree, and the copies.

The reference's ``tests/test_zlint.py``, test for test, on the port's
linter. Six rules keep the reference's logic and run on the reference's
fixtures (``tests/fixtures/lint/``, read only). Rule 2 (the ``torch.cuda``
queries) and rule 8 (the port's device-result primitives and fault seam)
run on fixtures of their own (``tests/torch_lint_fixtures/``), bad and
good twins, and rule 7's clean twin there calls the port's seam. The tree
gate lints ``zeebe_tpu_torch/`` and ``chip_smoke.py`` against
``zeebe_tpu_torch/.zlint-baseline``; the knob gate reads
``zeebe_tpu_torch/docs/knobs.md``.

The command line and the analysis package are partial copies
(``testing/copies.py``'s ``PARTIAL_COPIES``, their copies renaming the
reference's path ``zeebe_tpu/`` too): every reference member is in a
copied run or named in ``PORT_MEMBERS`` here. ``lint --check`` in a fresh
interpreter exits 0 and loads no torch.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
from pathlib import Path

import pytest

import zeebe_tpu_torch
from test_torch_cluster_copies import (
    check_copied_runs,
    check_imports,
    check_member_plus_names,
    check_members_copied_or_named,
)
from test_torch_tables import as_copied
from zeebe_tpu_torch.analysis import (
    BASELINE_FILENAME,
    format_baseline,
    load_baseline,
    run_lint,
    split_findings,
)
from zeebe_tpu_torch.analysis.framework import ParsedModule, parse_tree
from zeebe_tpu_torch.analysis.knobs import (
    KNOB_NOTES,
    render_knobs_doc,
    scan_knobs,
    undocumented,
)
from zeebe_tpu_torch.analysis.rules import (
    RULES,
    CommittedReadDisciplineRule,
    ControlActuationDisciplineRule,
    DeviceCallDisciplineRule,
    DriftCopyRule,
    KernelResultCommitDisciplineRule,
    PumpBlockingIoRule,
    ReplayDeterminismRule,
    StorageIoDisciplineRule,
)
from zeebe_tpu_torch.testing import copies

FIXTURES = Path(__file__).parent / "fixtures" / "lint"
TORCH_FIXTURES = Path(__file__).parent / "torch_lint_fixtures"
REPO_ROOT = Path(zeebe_tpu_torch.__file__).resolve().parent.parent
REF = REPO_ROOT / "zeebe_tpu"

#: the port's members of the command line and of the analysis package
#: outside their copied runs: the names the port adds to the reference's
#: member, or the reason it is rewritten whole
PORT_MEMBERS = {
    "cli.py": {
        (None, "main"): "metrics-doc takes --device; the three doc generators write the "
                        "port's documents under zeebe_tpu_torch/docs/; lint loads no torch",
        (None, "_METRICS_DOC_HEADER"): "names the committed doc's command (--device cpu) and "
                                       "its check on either device",
        (None, "_register_metrics_scenario"): {"device"},
        (None, "_metrics_doc"): "runs the scenario on --device, with no JAX_PLATFORMS pin, "
                                "and names --device cpu in its drift message",
    },
    "analysis/__init__.py": {},
    "analysis/framework.py": {
        (None, "BASELINE_FILENAME"): "the port's own baseline, zeebe_tpu_torch/.zlint-baseline",
        (None, "LINT_GLOBS"): "the port's tree and chip_smoke.py, in place of the reference's "
                              "tree, bench.py and __graft_entry__.py",
    },
    "analysis/knobs.py": {
        (None, "KNOB_NOTES"): "the reference's notes, the kernel backend's naming CUDA",
    },
    "analysis/rules.py": {
        (None, "_DEVICE_CALLS"): "the in-process torch.cuda queries in place of JAX's",
        (None, "DeviceCallDisciplineRule"): "allowed where the port's design queries the card: "
                                            "the probe, resolve_device and chip_smoke.py",
        (None, "_KERNEL_RESULT_CALLS"): "the port's collect, fetch and decode primitives",
        (None, "KernelResultCommitDisciplineRule"): "the port's seam in kernel_backend.py, and "
                                                    "a module's own functions resolved",
    },
}
PARTIAL = sorted(PORT_MEMBERS)
#: the knob notes the port words otherwise than the reference
PORT_KNOB_NOTES = {"ZEEBE_BROKER_EXPERIMENTAL_KERNELBACKEND"}


def fixture_module(name: str) -> ParsedModule:
    return ParsedModule(FIXTURES, FIXTURES / name)


def torch_fixture(name: str) -> ParsedModule:
    return ParsedModule(TORCH_FIXTURES, TORCH_FIXTURES / name)


@functools.lru_cache(maxsize=1)
def port_tree() -> tuple[ParsedModule, ...]:
    """The port's linted tree, parsed once for the tests that read it."""
    return tuple(parse_tree(REPO_ROOT))


def lines_by_rule(findings):
    return sorted((f.path, f.line, f.rule) for f in findings)


# -- rule 1: replay determinism -----------------------------------------------


def determinism_rule():
    # point the rule's scope at the fixture files
    return ReplayDeterminismRule(scope=(
        ("determinism_bad.py", None),
        ("determinism_good.py", None),
    ))


def test_determinism_flags_every_banned_construct():
    findings = determinism_rule().check(fixture_module("determinism_bad.py"))
    assert lines_by_rule(findings) == [
        ("determinism_bad.py", 10, "replay-determinism"),   # time.time()
        ("determinism_bad.py", 14, "replay-determinism"),   # time_ns alias
        ("determinism_bad.py", 18, "replay-determinism"),   # random
        ("determinism_bad.py", 22, "replay-determinism"),   # uuid
        ("determinism_bad.py", 26, "replay-determinism"),   # os.environ.get
        ("determinism_bad.py", 31, "replay-determinism"),   # for over set()
        ("determinism_bad.py", 33, "replay-determinism"),   # list({…})
        ("determinism_bad.py", 37, "replay-determinism"),   # comp over set
    ]
    # messages carry the resolved dotted name for the call findings
    assert any("time.time" in f.message for f in findings)


def test_determinism_clean_twin_and_inline_suppression():
    findings = determinism_rule().check(fixture_module("determinism_good.py"))
    # sorted(set(…)), membership, len() — and the suppressed time.time()
    assert findings == []


def test_determinism_out_of_scope_module_untouched():
    rule = ReplayDeterminismRule(scope=(("somewhere_else.py", None),))
    assert rule.check(fixture_module("determinism_bad.py")) == []


# -- rule 2: device-call discipline (the torch.cuda queries) ------------------


def test_device_rule_flags_unguarded_queries():
    rule = DeviceCallDisciplineRule(allowed=())
    findings = rule.check(torch_fixture("device_bad.py"))
    assert lines_by_rule(findings) == [
        ("device_bad.py", 8, "device-call-discipline"),
        ("device_bad.py", 12, "device-call-discipline"),   # aliased import
        ("device_bad.py", 16, "device-call-discipline"),   # imported name
    ]
    # the message names the resolved query; a launch fence is no query
    assert any("torch.cuda.mem_get_info" in f.message for f in findings)
    assert not any(f.line == 20 for f in findings)


def test_device_rule_honors_allowed_locations():
    rule = DeviceCallDisciplineRule(
        allowed=(("device_allowed.py", "probe_child"),))
    module = torch_fixture("device_allowed.py")
    assert rule.check(module) == []
    # the same file WITHOUT the allowance is flagged — the allowance is
    # doing the work, not the rule going blind
    strict = DeviceCallDisciplineRule(allowed=())
    assert len(strict.check(module)) == 2
    # and the reference's JAX queries are not the port's
    assert DeviceCallDisciplineRule(allowed=()).check(fixture_module("device_bad.py")) == []


# -- rule 3: pump-thread hygiene ----------------------------------------------


def test_pump_rule_flags_direct_and_one_hop_blocking_calls():
    findings = PumpBlockingIoRule(extra_roots=()).check(
        fixture_module("pump_bad.py"))
    assert lines_by_rule(findings) == [
        ("pump_bad.py", 9, "pump-blocking-io"),    # time.sleep in pump
        ("pump_bad.py", 15, "pump-blocking-io"),   # os.fsync via self call
        ("pump_bad.py", 16, "pump-blocking-io"),   # subprocess.run via self
    ]
    # the blocking call in the UNREACHABLE method is not flagged
    assert not any(f.line == 20 for f in findings)
    assert all("Partition.pump" in f.message
               or "Partition._maybe_snapshot" in f.message for f in findings)


def test_pump_rule_clean_twin():
    assert PumpBlockingIoRule(extra_roots=()).check(
        fixture_module("pump_good.py")) == []


# -- rule 4: committed-read discipline ----------------------------------------


def test_committed_read_rule_flags_transactional_access():
    rule = CommittedReadDisciplineRule(scope=("committed_bad.py",))
    findings = rule.check(fixture_module("committed_bad.py"))
    assert lines_by_rule(findings) == [
        ("committed_bad.py", 5, "committed-read-discipline"),
        ("committed_bad.py", 10, "committed-read-discipline"),
        ("committed_bad.py", 11, "committed-read-discipline"),
    ]


def test_committed_read_rule_clean_twin():
    rule = CommittedReadDisciplineRule(scope=("committed_good.py",))
    assert rule.check(fixture_module("committed_good.py")) == []


# -- rule 5: control actuation discipline --------------------------------------


def test_control_rule_flags_out_of_actuator_mutations():
    rule = ControlActuationDisciplineRule()
    findings = rule.check_tree([fixture_module("control_bad.py"),
                                fixture_module("control_good.py")])
    assert lines_by_rule(findings) == [
        ("control_bad.py", 12, "control-actuation-discipline"),
        ("control_bad.py", 13, "control-actuation-discipline"),   # AugAssign
        ("control_bad.py", 14, "control-actuation-discipline"),
        ("control_bad.py", 17, "control-actuation-discipline"),   # tuple x2
        ("control_bad.py", 17, "control-actuation-discipline"),
    ]
    # each finding names the owning loop, and the port's actuator home
    assert any("state-tiering controller" in f.message for f in findings)
    assert any("journal-flush controller" in f.message for f in findings)
    assert all("zeebe_tpu_torch/control" in f.message for f in findings)


def test_control_rule_allows_construction_and_reads():
    rule = ControlActuationDisciplineRule()
    assert [f for f in rule.check_tree([fixture_module("control_good.py")])
            if f.scope != "<registration>"] == []


def test_control_rule_allowed_package_and_suppression():
    # the same bad module under the allowed prefix is clean (the actuator
    # framework is the sanctioned write path)...
    rule = ControlActuationDisciplineRule(allowed_prefixes=("",))
    assert [f for f in rule.check_tree([fixture_module("control_bad.py")])
            if f.scope != "<registration>"] == []
    # ...and the inline suppression on line 20 held in the default run
    findings = ControlActuationDisciplineRule().check_tree(
        [fixture_module("control_bad.py")])
    assert not any(f.scope == "suppressed_with_reason" for f in findings)


def test_control_rule_stale_registration_is_a_finding():
    rule = ControlActuationDisciplineRule(
        owned={"park_after_ms": "state-tiering controller",
               "renamed_knob_attr": "ghost controller"})
    findings = rule.check_tree([fixture_module("control_bad.py")])
    stale = [f for f in findings if f.scope == "<registration>"]
    assert len(stale) == 1 and "renamed_knob_attr" in stale[0].message
    # a stale registration is anchored on the port's rule table
    assert stale[0].path == "zeebe_tpu_torch/analysis/rules.py"


def test_control_rule_single_write_path_in_tree():
    """The port's only unsuppressed/unbaselined owned-knob mutations live
    inside zeebe_tpu_torch/control/ — the audit trail's load-bearing
    property, checked against the live code, not a fixture."""
    findings = ControlActuationDisciplineRule().check_tree(list(port_tree()))
    baseline = load_baseline(REPO_ROOT / BASELINE_FILENAME)
    new = [f for f in findings if f.baseline_key not in baseline]
    assert new == [], "\n".join(f.render() for f in new)


# -- rule 7: storage-io discipline ---------------------------------------------


def test_storage_io_rule_flags_every_bypass():
    rule = StorageIoDisciplineRule(scope=("storage_io_bad.py",))
    findings = rule.check(fixture_module("storage_io_bad.py"))
    assert lines_by_rule(findings) == [
        ("storage_io_bad.py", 10, "storage-io-discipline"),  # bare open
        ("storage_io_bad.py", 12, "storage-io-discipline"),  # os.open
        ("storage_io_bad.py", 13, "storage-io-discipline"),  # os.fsync
        ("storage_io_bad.py", 15, "storage-io-discipline"),  # os.replace
        ("storage_io_bad.py", 19, "storage-io-discipline"),  # write_text
        ("storage_io_bad.py", 20, "storage-io-discipline"),  # write_bytes
    ]
    assert all("storage_io" in f.message for f in findings)


def test_storage_io_rule_allows_the_seam_and_reads():
    # the reference's clean twin calling the port's seam
    rule = StorageIoDisciplineRule(scope=("storage_io_good.py",))
    assert rule.check(torch_fixture("storage_io_good.py")) == []
    # the reference's seam is not the port's
    assert rule.check(fixture_module("storage_io_good.py")) != []


def test_storage_io_rule_ignores_out_of_scope_modules():
    rule = StorageIoDisciplineRule(scope=("storage_io_good.py",))
    assert rule.check(fixture_module("storage_io_bad.py")) == []


def test_storage_io_rule_stale_scope_registration_fails():
    rule = StorageIoDisciplineRule(scope=("gone/moved_away.py",))
    findings = rule.validate([fixture_module("storage_io_bad.py")])
    assert len(findings) == 1
    assert "stale storage-module registration" in findings[0].message


def test_storage_io_rule_live_tree_single_seam():
    """The port's storage modules perform no direct file IO — every write
    and durability barrier routes through utils/storage_io, so the disk-
    fault plane's coverage claim holds tree-wide (0 new findings)."""
    modules = list(port_tree())
    findings = []
    rule = StorageIoDisciplineRule()
    findings += rule.validate(modules)
    for module in modules:
        findings += rule.check(module)
    baseline = load_baseline(REPO_ROOT / BASELINE_FILENAME)
    new = [f for f in findings if f.baseline_key not in baseline]
    assert new == [], "\n".join(f.render() for f in new)


# -- rule 8: kernel-result commit discipline (the port's seam) -----------------

#: the port's primitives, and the fixture seam module's own fetch
FIXTURE_CALLS = ("zeebe_tpu_torch.ops.automaton.run_collect",
                 "zeebe_tpu_torch.ops.automaton.unpack_events",
                 "zeebe_tpu_torch.engine.kernel_backend.fetch_rows",
                 "kernel_result_good.fetch_rows")


def kernel_result_rule(seam_scopes=("_complete_device_run", "DeviceDefense._fetch_rows")):
    return KernelResultCommitDisciplineRule(
        scope_prefixes=("kernel_result_",),
        seam_module="kernel_result_good.py",
        seam_scopes=seam_scopes, calls=FIXTURE_CALLS)


def test_kernel_result_rule_flags_out_of_seam_primitives():
    findings = kernel_result_rule().check(
        torch_fixture("kernel_result_bad.py"))
    assert lines_by_rule(findings) == [
        ("kernel_result_bad.py", 9, "kernel-result-commit-discipline"),   # collect
        ("kernel_result_bad.py", 10, "kernel-result-commit-discipline"),  # fetch
        ("kernel_result_bad.py", 11, "kernel-result-commit-discipline"),  # decode
    ]
    assert all("validation gate" in f.message for f in findings)
    # the production primitives flag the same lines
    production = KernelResultCommitDisciplineRule(
        scope_prefixes=("kernel_result_",), seam_module="kernel_result_good.py",
        seam_scopes=("_complete_device_run",))
    assert lines_by_rule(production.check(torch_fixture("kernel_result_bad.py"))) == \
        lines_by_rule(findings)


def test_kernel_result_rule_allows_the_seam():
    assert kernel_result_rule().check(
        torch_fixture("kernel_result_good.py")) == []
    # the module's own fetch outside a registered scope is seen: a call of a
    # module's own function counts under the module's dotted name
    findings = kernel_result_rule(seam_scopes=("_complete_device_run",)).check(
        torch_fixture("kernel_result_good.py"))
    assert [(f.line, f.scope) for f in findings] == [(22, "DeviceDefense._fetch_rows")]
    assert "kernel_result_good.fetch_rows" in findings[0].message


def test_kernel_result_rule_ignores_out_of_scope_modules():
    rule = KernelResultCommitDisciplineRule(
        scope_prefixes=("somewhere_else_",),
        seam_module="kernel_result_good.py",
        seam_scopes=("DeviceDefense._fetch_rows",))
    assert rule.check(torch_fixture("kernel_result_bad.py")) == []


def test_kernel_result_rule_stale_seam_registration_fails():
    rule = KernelResultCommitDisciplineRule(
        scope_prefixes=("kernel_result_",),
        seam_module="kernel_result_good.py",
        seam_scopes=("DeviceDefense._renamed_away",))
    findings = rule.validate([torch_fixture("kernel_result_good.py")])
    assert len(findings) == 1
    assert "stale kernel-result seam registration" in findings[0].message


def test_kernel_result_rule_live_tree_single_seam():
    """The port's engine//stream/ trees touch device results only inside
    the kernel_backend chunk loop and fault seam, and every registered seam
    function exists — a rename fails the lint."""
    modules = list(port_tree())
    rule = KernelResultCommitDisciplineRule()
    assert rule.validate(modules) == []
    findings = []
    for module in modules:
        findings += rule.check(module)
    baseline = load_baseline(REPO_ROOT / BASELINE_FILENAME)
    new = [f for f in findings if f.baseline_key not in baseline]
    assert new == [], "\n".join(f.render() for f in new)
    # the seam really holds primitives: without it, the fetch and the decode
    # of the chunk loop and of the fault seam are findings
    bare = KernelResultCommitDisciplineRule(seam_scopes=())
    seam = next(m for m in modules if m.relpath == rule.seam_module)
    scopes = {f.scope for f in bare.check(seam)}
    assert {"run_group", "_complete_device_run", "DeviceDefense._fetch_rows.fetch",
            "DeviceDefense._shadow_execute.fetch"} <= scopes


# -- rule 6: drift-copy -------------------------------------------------------


def test_drift_copy_rule_catches_renamed_reworded_copy():
    modules = [fixture_module("drift_a.py"), fixture_module("drift_b.py")]
    findings = DriftCopyRule().check_tree(modules)
    flagged = {(f.path, f.scope) for f in findings}
    assert flagged == {("drift_a.py", "collect_dumps"),
                       ("drift_b.py", "gather_flight_evidence")}
    # each finding names its twin
    assert any("drift_b.py:gather_flight_evidence" in f.message
               for f in findings)
    # the structurally different function is NOT flagged
    assert not any(f.scope == "unrelated_function" for f in findings)


def test_drift_copy_requires_minimum_size():
    # with an absurd threshold nothing qualifies
    modules = [fixture_module("drift_a.py"), fixture_module("drift_b.py")]
    assert DriftCopyRule(min_body_statements=500).check_tree(modules) == []


# -- baseline + suppression machinery -----------------------------------------


def test_baseline_round_trip(tmp_path):
    rule = CommittedReadDisciplineRule(scope=("committed_bad.py",))
    findings = rule.check(fixture_module("committed_bad.py"))
    path = tmp_path / "baseline"
    path.write_text(format_baseline(findings))
    baseline = load_baseline(path)
    assert len(baseline) == len({f.baseline_key for f in findings})
    new, stale = split_findings(findings, baseline)
    assert new == [] and stale == []
    # a fresh finding in another scope is NOT covered
    other = fixture_module("committed_bad.py")
    extra = other.finding("committed-read-discipline",
                          other.tree.body[-1], "synthetic")
    new, _ = split_findings(findings + [extra], baseline)
    assert len(new) == 1
    # justifications survive a rewrite
    key = findings[0].baseline_key
    edited = {**baseline, key: "because reasons"}
    path.write_text(format_baseline(findings, edited))
    assert load_baseline(path)[key] == "because reasons"


def test_baseline_keys_are_line_number_free():
    rule = CommittedReadDisciplineRule(scope=("committed_bad.py",))
    f = min(rule.check(fixture_module("committed_bad.py")),
            key=lambda f: f.line)
    assert f.baseline_key == (
        "committed-read-discipline", "committed_bad.py",
        "has_activatable_jobs",
        "with partition.db.transaction():           # line 5: transaction open")


def test_stale_scope_registrations_become_findings():
    """A rename that orphans a scope/root registration must FAIL the lint,
    not silently disable the invariant (every scoped rule shares the
    validator)."""
    modules = [fixture_module("pump_bad.py")]
    stale_path = ReplayDeterminismRule(
        scope=(("renamed_away.py", None),)).validate(modules)
    assert len(stale_path) == 1 and "stale" in stale_path[0].message
    assert stale_path[0].rule == "replay-determinism"
    stale_qual = PumpBlockingIoRule(
        extra_roots=(("pump_bad.py", "Partition.renamed_hook"),)
    ).validate(modules)
    assert len(stale_qual) == 1
    assert "Partition.renamed_hook" in stale_qual[0].code
    stale_ingress = CommittedReadDisciplineRule(
        scope=("gone/",)).validate(modules)
    assert len(stale_ingress) == 1
    # live registrations validate clean
    assert PumpBlockingIoRule(
        extra_roots=(("pump_bad.py", "Partition._maybe_snapshot"),)
    ).validate(modules) == []


# -- the tree gate (mirror of `cli lint --check`) -----------------------------


def test_tree_is_clean_with_committed_baseline():
    findings = run_lint(REPO_ROOT)
    baseline = load_baseline(REPO_ROOT / BASELINE_FILENAME)
    new, stale = split_findings(findings, baseline)
    assert new == [], "unbaselined zlint findings:\n" + "\n".join(
        f.render() for f in new)
    assert stale == [], f"stale baseline entries: {stale}"
    # every baselined exception carries a real justification
    assert all(j.strip() and j.strip() != "TODO: justify"
               for j in baseline.values())
    # the port's tree only, all eight rules, and no JAX query left to flag
    assert {m.relpath.split("/")[0] for m in port_tree()} == {"zeebe_tpu_torch",
                                                               "chip_smoke.py"}
    assert len(RULES) == 8 and len({r.name for r in RULES}) == 8
    assert not any("jax" in f.code for f in findings)


def test_cli_lint_check_exit_codes(tmp_path, capsys):
    from zeebe_tpu_torch.cli import main

    assert main(["lint", "--check", "--root", str(REPO_ROOT)]) == 0
    capsys.readouterr()
    # a tree with a violation and no baseline fails the check
    bad = tmp_path / "zeebe_tpu_torch" / "gateway"
    bad.mkdir(parents=True)
    (bad / "leak.py").write_text(
        "def peek(partition):\n"
        "    with partition.db.transaction():\n"
        "        return 1\n")
    assert main(["lint", "--check", "--root", str(tmp_path)]) == 1
    out = capsys.readouterr()
    assert "committed-read-discipline" in out.out
    # a stale baseline entry alone also fails the gate: fixing a violation
    # must shrink the baseline in the same change
    (bad / "leak.py").write_text("def peek(partition):\n    return 1\n")
    (tmp_path / BASELINE_FILENAME).write_text(
        "committed-read-discipline\tzeebe_tpu_torch/gateway/leak.py\tpeek\t"
        "with partition.db.transaction():\tgone\n")
    assert main(["lint", "--check", "--root", str(tmp_path)]) == 1
    assert "stale" in capsys.readouterr().err


_LINT_IN_A_FRESH_PROCESS = """
import json, runpy, sys
sys.argv = ["zeebe_tpu_torch.cli", "lint", "--check"]
try:
    runpy.run_module("zeebe_tpu_torch.cli", run_name="__main__")
except SystemExit as exc:
    code = exc.code
print(json.dumps({"rc": code, "loaded": sorted(m for m in ("torch", "jax") if m in sys.modules)}))
"""


def test_cli_lint_check_in_a_fresh_process_loads_no_torch():
    """``python -m zeebe_tpu_torch.cli lint --check`` exits 0 on the tree
    and never imports torch (or JAX)."""
    proc = subprocess.run([sys.executable, "-c", _LINT_IN_A_FRESH_PROCESS], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"rc": 0, "loaded": []}


# -- env-knob drift gate -------------------------------------------------------


def test_knob_scan_finds_declarative_and_call_style_reads():
    knobs = {k.name: k for k in scan_knobs(REPO_ROOT)}
    # call-style read (os.environ.get)
    assert "ZEEBE_SANITIZE" in knobs
    # declarative binding table (broker/config.py) — no environ call on
    # the literal's line; the literal-based scan is what catches it
    assert "ZEEBE_BROKER_CLUSTER_PARTITIONSCOUNT" in knobs
    assert any("zeebe_tpu_torch/broker/config.py" in s
               for s in knobs["ZEEBE_BROKER_CLUSTER_PARTITIONSCOUNT"].sites)
    # prefix family with folded members
    fam = knobs["ZEEBE_BROKER_EXPORTERS_"]
    assert fam.is_prefix and fam.examples
    # the port's tree only
    assert all(s.startswith("zeebe_tpu_torch/") for k in knobs.values() for s in k.sites)


def test_every_knob_is_documented_and_doc_is_current():
    knobs = scan_knobs(REPO_ROOT)
    assert undocumented(knobs) == []
    committed = (REPO_ROOT / "zeebe_tpu_torch" / "docs" / "knobs.md").read_text()
    assert committed == render_knobs_doc(knobs), (
        "zeebe_tpu_torch/docs/knobs.md drifted — regenerate with "
        "`python -m zeebe_tpu_torch.cli knobs-doc`")


def test_no_stale_knob_notes():
    names = {k.name for k in scan_knobs(REPO_ROOT)}
    stale = sorted(set(KNOB_NOTES) - names)
    assert stale == [], f"KNOB_NOTES entries without an in-tree read: {stale}"


# -- the copies ----------------------------------------------------------------


@pytest.mark.parametrize("path", copies.ANALYSIS_STACK)
def test_analysis_module_is_a_copy(path):
    want = as_copied((REF / path).read_text()).replace("zeebe_tpu/", "zeebe_tpu_torch/")
    assert (REPO_ROOT / "zeebe_tpu_torch" / path).read_text() == want


@pytest.mark.parametrize("path", PARTIAL)
def test_copied_runs_are_the_scripts(path):
    check_copied_runs(path)


@pytest.mark.parametrize("path", PARTIAL)
def test_every_member_is_copied_or_named(path):
    check_members_copied_or_named(path, PORT_MEMBERS[path])


@pytest.mark.parametrize("path", PARTIAL)
def test_imports_are_the_references(path):
    check_imports(path, set())


def test_metrics_scenario_is_the_references_plus_the_device():
    check_member_plus_names("cli.py", None, "_register_metrics_scenario", {"device"})


def test_knob_notes_are_the_references_but_the_named():
    from zeebe_tpu.analysis.knobs import KNOB_NOTES as REFERENCE_NOTES

    assert set(KNOB_NOTES) == set(REFERENCE_NOTES)
    differ = {k for k in KNOB_NOTES if KNOB_NOTES[k] != REFERENCE_NOTES[k]}
    assert differ == PORT_KNOB_NOTES
    assert "CUDA" in KNOB_NOTES["ZEEBE_BROKER_EXPERIMENTAL_KERNELBACKEND"]
