"""Curated one-liners for the kernel-eligibility reason catalog — the
human half of the generated ``docs/eligibility.md`` (the ``knobs-doc``
drift discipline applied to path-routing reasons,.

Every reason code in ``zeebe_tpu_torch.engine.eligibility``'s catalog MUST have
an entry here: ``cli eligibility-doc --check`` fails on a missing note
(an explained fallback is the whole point of the catalog) or on drift
between the generated doc and the committed file; a note for a retired
code fails the same gate as stale.
"""

from __future__ import annotations

#: reason code → one-line operator-facing explanation. Grouped to match
#: the catalog's split; the renderer sorts within each group.
REASON_NOTES: dict[str, str] = {
    # -- static, element-level (the element forces the host path) ----------
    "multi-instance": (
        "multi-instance activity outside the device K_MI subset (container "
        "body, dynamic collection expression, boundaries/mappings on the "
        "body, or an unstructured/cyclic graph around it)"),
    "io-mapping-nontask": (
        "io mappings on a non-job-worker element — only K_TASK elements "
        "evaluate mappings on the kernel path"),
    "unsafe-expression": (
        "an io-mapping or script expression that can raise mid-burst "
        "(arithmetic, ordered comparison, function call) — the device "
        "routes tokens before the materializer evaluates it"),
    "output-writes-condition-var": (
        "an output mapping / script result writes a variable some flow "
        "condition reads — device condition slots are prefetched at "
        "admission and would not see the write"),
    "user-task": "native user task: lifecycle lives in host-side processors",
    "called-decision": (
        "business-rule task with a called decision: DMN evaluation is "
        "host-side"),
    "script-task-shape": (
        "expression-flavor script task with a disqualifying shape (job "
        "type, io mappings, or boundary events attached)"),
    "timer-cycle-date": (
        "cycle (R/...) or date timer: its wait state is not "
        "kernel-reconstructable — only fixed-duration timers park on "
        "device"),
    "escalation-boundary": (
        "interrupting/non-interrupting escalation boundary: escalations "
        "fire from child scopes through host-side catch resolution"),
    "boundary-unsupported": (
        "boundary event whose subscription kind the parked-task "
        "reconstruction cannot count (or an attached boundary that itself "
        "host-escapes)"),
    "boundary-on-nontask": (
        "boundary events attached to a non-job-worker element: wait-state "
        "reconstruction is implemented for parked K_TASK elements only"),
    "subprocess-no-none-start": (
        "embedded sub-process without a none start event cannot enter as a "
        "device K_SCOPE"),
    "subprocess-event-subprocess": (
        "embedded sub-process hosting event sub-processes: scope "
        "reconstruction does not collect their trigger state"),
    "call-activity-unresolved": (
        "call activity whose called definition could not be statically "
        "inlined (dynamic process id, unresolvable or undeployed target)"),
    "event-gateway-target": (
        "event-based gateway with a succeeding catch the reconstruction "
        "cannot count (or no outgoing flows)"),
    "link-unresolved": "link throw event with no same-scope catch to bind",
    "catch-unsupported": (
        "intermediate catch / receive task without a reconstructable wait "
        "state (no message/signal name, or a mixed timer+message shape)"),
    "unsupported-element": (
        "element type outside the device opcode subset (inclusive "
        "gateway, compensation, transaction, ...)"),
    "event-type-unsupported": (
        "event flavor outside the device subset on an otherwise-lowerable "
        "element (e.g. a message end event)"),
    "job-type-dynamic": (
        "job type or retries is a runtime expression — kernel task rows "
        "need deploy-time constants"),
    "event-subprocess-body": (
        "element inside an event sub-process: individually eligible, but "
        "tokens only enter through the host-routed start event (ROADMAP "
        "item 3's message-start event-sub-process children)"),
    "condition-not-compilable": (
        "the solo/shared lowering downgraded the element (or declined the "
        "definition): a flow condition outside the device VM subset, or a "
        "SlotMap kind clash across co-deployed definitions"),
    # -- static, definition-level ------------------------------------------
    "no-none-start": (
        "definition has only message/timer starts: every creation carries "
        "an explicit start element, so the kernel's none-start entry path "
        "has nothing to run"),
    "esp-start-unsupported": (
        "a root event sub-process start whose subscription the root "
        "wait-state reconstruction cannot count (e.g. cycle/date timer "
        "start)"),
    "table-set-full": (
        "the partition's kernel registry hit max_definitions — "
        "deployment-SET-dependent: visible only when classifying the whole "
        "set against one shared registry"),
    # -- runtime-only (never statically predictable) ------------------------
    "geometry-bounds": (
        "group geometry exceeded the bit-packed event tensor bounds "
        "(T > PACK_MAX_TOKENS or E >= PACK_MAX_ELEMENTS)"),
    "no-quiesce": (
        "the group did not quiesce within max_steps device steps — "
        "sequential path re-runs the head"),
    "token-overflow": (
        "the device token pool overflowed (T undersized for the group's "
        "actual fan-out)"),
    "mesh-dispatch-error": "the shared mesh runner's dispatch errored",
    "mesh-no-quiesce": "a mesh-coalesced group did not quiesce",
    "mesh-token-overflow": "a mesh-coalesced group overflowed its pool",
    "group-error": (
        "the group's processing raised before any append — transaction "
        "rolled back, head re-processed sequentially"),
    "device-dispatch-error": (
        "a device compile/dispatch/fetch exception was contained at the "
        "kernel dispatch seam — the group abandoned, the head host "
        "re-executed, the device health ladder notified"),
    "device-wedged": (
        "a device dispatch exceeded the per-dispatch watchdog deadline "
        "(ZEEBE_BROKER_DEVICE_DISPATCHTIMEOUTMS) — the gray-failure "
        "slow-but-alive shape, contained like a dispatch exception"),
    "device-quarantined": (
        "the broker's device health ladder is QUARANTINED: every group is "
        "host-routed until periodic canary dispatches re-prove the device "
        "against the host oracle"),
    # -- head families (noted as <family>:<VALUE_TYPE>.<INTENT>) ------------
    "head-sequential": (
        "ordinary sequential traffic at the group boundary: the pending "
        "head is a non-candidate command kind (deployment, message "
        "publish, ...)"),
    "head-not-admittable": (
        "a candidate command kind failed admission (unknown/stale "
        "definition, non-default tenant, unpredictable MI cardinality, "
        "un-reconstructable instance state) — a regression signal when "
        "the definition is predicted eligible"),
}


def undocumented_reasons() -> list[str]:
    """Catalog codes without a REASON_NOTES one-liner (CI gate)."""
    from zeebe_tpu_torch.engine.eligibility import ALL_REASONS

    return sorted(ALL_REASONS - set(REASON_NOTES))


def stale_reason_notes() -> list[str]:
    """REASON_NOTES entries whose code left the catalog (CI gate)."""
    from zeebe_tpu_torch.engine.eligibility import ALL_REASONS

    return sorted(set(REASON_NOTES) - ALL_REASONS)


_DOC_HEADER = """\
# Kernel eligibility & path coverage

> Auto-generated by `python -m zeebe_tpu_torch.cli eligibility-doc` from the
> reason catalog in `zeebe_tpu_torch/engine/eligibility.py` and the curated
> notes in `zeebe_tpu_torch/analysis/eligibility_notes.py`. Edit those sources
> and regenerate; CI fails on drift (`cli eligibility-doc --check`).

A record takes the **kernel path** when the stream processor admits it
into a device group (`engine/kernel_backend.py`) and the group's burst
materializes; everything else rides the sequential **host path**. Every
host routing carries a typed reason from the ONE catalog below — the same
codes the static report (`cli eligibility`), the runtime metrics
(`zeebe_kernel_records_total{path,reason}`), the `kernel_wave` flight
events, and the bench parity gate speak.

## How coverage is computed

`coverage = records on the kernel path / total routed records`, where a
"routed record" is a top-level command the processor made a path decision
for: each kernel-group member counts once on the kernel path; each
sequential head counts once on the host path with its reason.
Follow-up commands processed inside a head's batch (or inside a kernel
burst's host-escape drain) ride their head's path and are not separately
counted. The cumulative per-definition ratio is served as
`zeebe_kernel_coverage_ratio{partition,definition}`, on partition
`/health` (`kernelCoverage`), on `/cluster/status` partition rows, and in
`cli top`'s KERNEL section.
"""

_DOC_FOOTER = """\
## Honest caveats

- **Runtime-only reasons are not static-predictable**: a definition the
  report calls fully eligible can still fall back at dispatch time
  (geometry bounds, non-quiescence, pool overflow, mesh errors). The
  parity gate therefore never holds runtime reasons against the
  classifier.
- **Classification is solo**: the report compiles the definition alone.
  Co-deployed definitions can downgrade further through SlotMap kind
  clashes in the shared lowering (`condition-not-compilable` at runtime).
- **Offline classification cannot resolve call activities**: without the
  deployed process state a call activity honestly classifies
  `call-activity-unresolved`; classify `--deployed --data-dir` to inline
  against what is actually deployed.
- **Coverage is per partition, not global**: each partition's accounting
  covers its own log; aggregate across partitions before quoting a
  cluster number.
- **In-batch follow-ups are invisible to the split**: a host-processed
  head's follow-up commands (and a kernel burst's host-escape drain) are
  attributed to the head's path.
"""


def render_eligibility_doc() -> str:
    """docs/eligibility.md content from the catalog + notes."""
    from zeebe_tpu_torch.engine.eligibility import (
        DEFINITION_REASONS,
        HEAD_FAMILIES,
        RUNTIME_REASONS,
        STATIC_ELEMENT_REASONS,
    )

    def cell(text: str) -> str:
        return text.replace("|", "\\|")

    def table(title: str, blurb: str, codes) -> list[str]:
        out = [f"## {title}", "", blurb, "",
               "| reason | meaning |", "| --- | --- |"]
        for code in sorted(codes):
            out.append(f"| `{code}` | {cell(REASON_NOTES.get(code, ''))} |")
        out.append("")
        return out

    lines = [_DOC_HEADER]
    lines += table(
        "Static element-level reasons",
        "Predictable from the definition alone — `cli eligibility` names "
        "the exact element. Retiring one of these (ROADMAP item 3) moves "
        "real records onto the kernel path.",
        STATIC_ELEMENT_REASONS)
    lines += table(
        "Static definition-level reasons",
        "The whole definition declines kernel registration "
        "(`KernelRegistry` records the typed reason the report serves).",
        DEFINITION_REASONS)
    lines += table(
        "Runtime-only reasons",
        "Observable only at dispatch time; excluded from the "
        "static-vs-observed parity gate.",
        RUNTIME_REASONS)
    lines += table(
        "Head families",
        "Noted per sequential head as `<family>:<VALUE_TYPE>.<INTENT>`; "
        "metrics fold them to the family label (bounded cardinality), the "
        "full string stays in `fallback_reasons` / BENCH.",
        HEAD_FAMILIES)
    lines.append(_DOC_FOOTER)
    return "\n".join(lines)
