"""The engine's batched execution backend: the registry and the device half.

The counterpart of ``zeebe_tpu/engine/kernel_backend.py``, in two parts.

The registry half is copied from the reference: ``KernelRegistry`` and the
host code it runs (element eligibility, call-activity and multi-instance
inlining, the per-definition ``_DefInfo``). A partition's registry compiles
its deployed definitions into one shared table set; ``tables_fingerprint``
is a content digest of that set, equal across partitions that deployed the
same resources, and gates which groups may share one mesh dispatch. Only
``device_tables`` and ``device_tables_for`` differ from the reference: they
place the port's ``DeviceTables`` on a torch device.

The device half (``KernelBackend``'s device path): a group of admitted
instances is padded to a shape bucket (``build_group_arrays``), placed on
the device (``group_state``), run in chunks of ``run_collect`` until it
quiesces, with the next chunk dispatched before the current one's rows are
fetched (``run_group``), and each instance's route is traced from the packed
step rows (``cascade_ops``) — the trace the record writer interprets.

Instances come in as plain records (``GroupInstance``), not the reference's
admission objects: admission and materialization into records are not part
of this module.

The device-fault seam (``DeviceDefense``, passed to ``run_group``): the
device-chaos hooks at dispatch and fetch (``install_device_chaos``), the
dispatch watchdog (``_watchdog_call`` on a bounded thread pool), containment
of a failed dispatch or a wedge as a typed decline, and sampled shadow
verification against the plain ``run_collect`` on the CPU, which feeds the
health ladder (``engine.device_health``).

``drive_group`` runs one group through waves — each wave runs the device
until it quiesces with every token parked, traces the wave, then completes
every parked job (``complete_jobs``) as job workers would, until no job is
left. ``drive_groups_on_mesh`` does the same for several partitions at
once, each on its own thread, through a shared ``MeshKernelRunner``
(``run_group_on_mesh``): up to ``n_shards`` partitions' groups ride one
sharded dispatch.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from zeebe_tpu_torch.models.bpmn import parse_bpmn_xml, transform
from zeebe_tpu_torch.ops.automaton import (
    PACK_MAX_ELEMENTS,
    PACK_MAX_TOKENS,
    PHASE_AT,
    PHASE_DONE,
    PHASE_WAIT,
    DeviceTables,
    complete_jobs,
    resolve_device,
    run_collect,
    state_from_numpy,
    unpack_events,
)
from zeebe_tpu_torch.engine.device_health import SUSPECT, shared_device_health
from zeebe_tpu_torch.engine.eligibility import esp_start_host_reason
from zeebe_tpu_torch.feel.feel import Lit as _FeelLit
from zeebe_tpu_torch.feel.feel import Var as _FeelVar
from zeebe_tpu_torch.models.bpmn.executable import ExecutableElement, ExecutableProcess
from zeebe_tpu_torch.ops.tables import (
    _MI_BODY_TYPES,
    ConditionNotCompilable,
    K_CATCH,
    K_HOST,
    K_JOIN,
    K_MI,
    K_SCOPE,
    K_TASK,
    ProcessTables,
    compile_tables,
)
from zeebe_tpu_torch.parallel.mesh_runner import GroupRequest, _pad_axis0
from zeebe_tpu_torch.protocol.enums import BpmnElementType, BpmnEventType

logger = logging.getLogger(__name__)

# the partition's geometry (zeebe_tpu/broker/partition.py builds its backend
# with max_group=2048, chunk_steps=8; max_steps is the backend's default)
MAX_GROUP = 2048
CHUNK_STEPS = 8
MAX_STEPS = 4096


# ---------------------------------------------------------------------------
# the registry half (copied from the reference)


def _is_numeric(v: Any) -> bool:
    return isinstance(v, (bool, int, float)) and not isinstance(v, str)




def _safe_mapping_expr(expr) -> bool:
    """True when evaluating the expression can NEVER raise: the kernel's
    trace decoder routes tokens BEFORE the materializer evaluates mappings,
    so an element may ride the device only when its mappings cannot fail
    mid-burst (an IO_MAPPING_ERROR incident after the device already took
    the outgoing flows would diverge from the sequential engine).

    The never-raises subset: static strings; variables (missing → null);
    literals; list/context literals, if-then-else, equality, and/or, and
    member access over safe operands — all null-tolerant in the evaluator
    (access in particular: the parser guarantees a string literal on the
    right, and dict.get / temporal_property / non-container all yield null
    for unknown names). Arithmetic and ordered comparisons raise on type
    mismatches; function calls raise through the builtin wrapper — both
    stay host-side."""
    from zeebe_tpu_torch.feel.feel import Bin, ContextLit, If, Lit, ListLit, Var

    def safe(node) -> bool:
        if isinstance(node, (Lit, Var)):
            return True
        if isinstance(node, ListLit):
            return all(safe(x) for x in node.items)
        if isinstance(node, ContextLit):
            return all(safe(v) for _k, v in node.entries)
        if isinstance(node, If):
            return safe(node.cond) and safe(node.then) and safe(node.orelse)
        if isinstance(node, Bin) and node.op in ("=", "!=", "and", "or",
                                                 "access"):
            return safe(node.left) and safe(node.right)
        return False

    return expr.is_static or safe(expr.ast)


_COND_VAR_CACHE: dict[str, frozenset[str]] = {}


def _condition_var_names(exe: ExecutableProcess) -> frozenset[str]:
    """Variable names read by ANY flow condition of the definition —
    computed statically from the FEEL ASTs, once per content digest (the
    digest covers every flow's condition source). Output mappings targeting
    these must stay host-side: device condition slots are prefetched at
    admission, so a mid-burst write the device cannot see would
    mis-route."""
    import dataclasses as _dc

    from zeebe_tpu_torch.feel.feel import Var

    cached = _COND_VAR_CACHE.get(exe.digest)
    if cached is not None:
        return cached

    names: set[str] = set()

    def walk(node):
        if isinstance(node, (list, tuple)):
            for x in node:
                walk(x)
        elif isinstance(node, Var):
            names.add(node.path[0])  # the root name owns the slot
        elif _dc.is_dataclass(node) and not isinstance(node, type):
            for f in _dc.fields(node):
                walk(getattr(node, f.name))

    for flow in exe.flows:
        if flow.condition is not None and not flow.condition.is_static:
            walk(flow.condition.ast)
    out = frozenset(names)
    if len(_COND_VAR_CACHE) > 4096:
        _COND_VAR_CACHE.clear()
    _COND_VAR_CACHE[exe.digest] = out
    return out


def check_element_eligibility(exe: ExecutableProcess, el: ExecutableElement) -> bool:
    """True when the sequential engine's behavior for this element is exactly
    the kernel's opcode behavior (engine/…/processing/bpmn element processors
    vs ops/automaton masks). Derived from the reason-returning classifier in
    engine/eligibility.py — ONE eligibility logic feeding both the
    runtime lowering and the static eligibility report."""
    from zeebe_tpu_torch.engine.eligibility import element_host_reason

    return element_host_reason(exe, el) is None


@dataclass(frozen=True)
class _CallSegment:
    """One inlined called process inside a synthetic definition (VERDICT r3
    item 3; reference: engine/…/processing/bpmn/container/CallActivityProcessor
    .java — here the called definition's rows are co-resident in the caller's
    table set, the call activity and a child-root placeholder both lower to
    K_SCOPE, and the whole call executes on the device)."""

    call_row: int  # synthetic row of the call activity element
    root_row: int  # synthetic row of the child-root placeholder (= offset)
    offset: int  # child element idx c → synthetic row offset + c
    flow_offset: int  # child flow idx f → synthetic flow idx flow_offset + f
    child_def_key: int  # definition bound at compile (latest at inline time)
    child_process_id: str
    child_exe: ExecutableProcess  # the REAL child executable (local idxs)


def _shifted_child_elements(child: ExecutableProcess, d_elem: int,
                            d_flow: int, call_row: int):
    """Copies of a child definition's elements/flows with indices shifted
    into the synthetic parent's row space. The child ROOT (idx 0) becomes the
    child-root placeholder at row d_elem: a non-root PROCESS element whose
    parent is the call activity row — it parks as a K_SCOPE token standing
    for the child process instance, so activation/completion decode can
    delegate to the sequential PROCESS element handlers verbatim."""
    import dataclasses as _dc

    elements = []
    for el in child.elements:
        elements.append(_dc.replace(
            el,
            idx=el.idx + d_elem,
            parent_idx=(call_row if el.idx == 0
                        else el.parent_idx + d_elem if el.parent_idx >= 0
                        else -1),
            outgoing=([] if el.idx == 0 else [f + d_flow for f in el.outgoing]),
            default_flow_idx=(el.default_flow_idx + d_flow
                              if el.default_flow_idx >= 0 else -1),
            attached_to_idx=(el.attached_to_idx + d_elem
                             if el.attached_to_idx >= 0 else -1),
            boundary_idxs=[b + d_elem for b in el.boundary_idxs],
            child_start_idx=(el.child_start_idx + d_elem
                             if el.child_start_idx >= 0 else -1),
            link_target_idx=(el.link_target_idx + d_elem
                             if el.link_target_idx >= 0 else -1),
        ))
    flows = [
        _dc.replace(f, idx=f.idx + d_flow, source_idx=f.source_idx + d_elem,
                    target_idx=f.target_idx + d_elem)
        for f in child.flows
    ]
    return elements, flows


_INLINE_MAX_DEPTH = 3


def _inline_call_activities(exe: ExecutableProcess, processes,
                            _depth: int = 0,
                            _chain: frozenset = frozenset(),
                            ) -> tuple[ExecutableProcess, list[_CallSegment]]:
    """Build a synthetic definition with statically-resolvable call
    activities inlined as scope regions. Returns (exe, []) unchanged when
    nothing inlines. ``processes`` is the partition's ProcessState.

    A call inlines only when: the called id resolves to a deployed latest
    version whose executable has a none start and no root-level event
    sub-processes; the call element itself carries no io mappings, boundary
    events, or multi-instance marker (those shapes stay host-escaped); and
    the CALLER has no flow conditions at all — a device-compiled parent
    condition could mis-route after a child completion propagates variables
    the admission-time slot prefetch cannot see. Recursion is depth-capped
    and self-recursive chains stay host-side. Version binding follows the
    reference (activation-time latest): admission re-checks that each
    segment's bound key is still the latest and declines to the sequential
    path otherwise."""
    import dataclasses as _dc
    import hashlib as _hashlib

    has_calls = any(
        el.element_type == BpmnElementType.CALL_ACTIVITY
        and el.called_process_id is not None
        for el in exe.elements[1:]
    )
    if not has_calls or _depth >= _INLINE_MAX_DEPTH:
        return exe, []
    if any(f.condition is not None for f in exe.flows):
        return exe, []  # propagation-taint guard (see docstring)

    elements = list(exe.elements)
    flows = list(exe.flows)
    segments: list[_CallSegment] = []
    for el in exe.elements[1:]:
        if (el.element_type != BpmnElementType.CALL_ACTIVITY
                or el.called_process_id is None
                or el.called_process_id in _chain
                or el.multi_instance is not None
                or el.inputs or el.outputs or el.boundary_idxs):
            continue
        meta = processes.get_latest_by_id(el.called_process_id)
        if meta is None or meta.get("deleted"):
            continue
        child = processes.executable(meta["processDefinitionKey"])
        if child is None or child.none_start_of(0) < 0:
            continue
        if any(
            # child-root ESP starts are openable mid-burst only when their
            # subscriptions need NO runtime expression evaluation: static
            # timer durations and signal/error/escalation starts. Message
            # starts evaluate correlation keys against the CHILD scope at
            # activation time — a mid-burst variable write before the call
            # activates would diverge from any admission-time prediction
            not (
                (esp_start := child.elements[esp.child_start_idx]).event_type
                in (BpmnEventType.ERROR, BpmnEventType.ESCALATION)
                or (esp_start.event_type == BpmnEventType.SIGNAL
                    and esp_start.signal_name)
                or (esp_start.event_type == BpmnEventType.TIMER
                    and esp_start.timer_duration is not None
                    and esp_start.timer_duration.is_static
                    and esp_start.timer_cycle is None
                    and esp_start.timer_date is None)
            )
            for esp in child.event_sub_processes_of(0)
        ):
            continue  # ESP needing runtime eval: sequential activation
        if any(f.condition is not None for f in child.flows):
            # child conditions read CHILD-scope variables the shared slot
            # prefetch cannot represent — a whole-child decline keeps the
            # lowering simple (the call stays host-escaped)
            continue
        child_syn, child_segs = _inline_call_activities(
            child, processes, _depth + 1,
            _chain | {exe.process_id, el.called_process_id},
        )
        d_elem, d_flow = len(elements), len(flows)
        seg_elements, seg_flows = _shifted_child_elements(
            child_syn, d_elem, d_flow, el.idx)
        elements.extend(seg_elements)
        flows.extend(seg_flows)
        # the call element itself becomes a scope whose inner start is the
        # placeholder row (the child root), which in turn scopes the child's
        # none start — the K_SCOPE spawn chain mirrors ACTIVATE(child root)
        # → ACTIVATE(child none start) exactly
        elements[el.idx] = _dc.replace(el, child_start_idx=d_elem)
        segments.append(_CallSegment(
            call_row=el.idx, root_row=d_elem, offset=d_elem,
            flow_offset=d_flow,
            child_def_key=meta["processDefinitionKey"],
            child_process_id=el.called_process_id,
            child_exe=child,
        ))
        # nested segments shift into this synthetic's row space
        for s in child_segs:
            segments.append(_dc.replace(
                s, call_row=s.call_row + d_elem, root_row=s.root_row + d_elem,
                offset=s.offset + d_elem, flow_offset=s.flow_offset + d_flow,
            ))
    if not segments:
        return exe, []
    digest = _hashlib.sha256(
        (exe.digest + "|" + "|".join(
            f"{s.child_def_key}:{s.child_exe.digest}" for s in segments
        )).encode()
    ).hexdigest()
    synthetic = ExecutableProcess(
        process_id=exe.process_id, elements=elements, flows=flows,
        by_id=exe.by_id, digest=digest,
    )
    return synthetic, segments


def _mi_body_device_eligible(exe: ExecutableProcess, el) -> bool:
    """True when a multi-instance activity may become a device K_MI body
    (kernel parity restrictions; anything else host-escapes):

    - the activity is a job-worker task with a static type (the inner
      instance parks at a job; containers stay host-side),
    - no boundary events, no io mappings on the body,
    - the input collection is a bare variable or a literal (admission
      predicts its cardinality; evaluation cannot fail mid-burst),
    - a bare-variable collection is not written mid-burst by ANY other
      writer (output mappings, script/decision result variables, another
      body's outputCollection, or a non-ancestor call activity's completion
      propagation) nor shadowed by any ancestor scope's input mappings —
      the admission prediction must equal the value the sequential engine
      reads at body activation,
    - the output element, when collected, is a safe expression (cannot
      raise mid-burst)."""
    mi = el.multi_instance
    if el.element_type not in _MI_BODY_TYPES:
        return False
    if el.job_type is None or not el.job_type.is_static:
        return False
    if el.job_retries is not None and not el.job_retries.is_static:
        return False
    if el.boundary_idxs or el.inputs or el.outputs:
        return False
    if el.form_id is not None or el.native_user_task or el.called_decision_id:
        return False
    if el.script_expression is not None:
        return False
    if mi.input_collection.is_static:
        # a static string never evaluates to a list: the sequential path
        # owns the guaranteed incident (host-escape keeps the REST of the
        # definition on the kernel instead of declining every command)
        return False
    ast = mi.input_collection.ast
    if isinstance(ast, _FeelLit):
        pass
    elif isinstance(ast, _FeelVar) and len(ast.path) == 1:
        v = ast.path[0]

        def is_ancestor(a_idx: int) -> bool:
            anc = el.parent_idx
            while anc > 0:
                if anc == a_idx:
                    return True
                anc = exe.elements[anc].parent_idx
            return False

        for other in exe.elements[1:]:
            if any(t == v for _e, t in other.outputs):
                return False  # an output mapping could rewrite it mid-burst
            if other.script_result_variable == v or other.decision_result_variable == v:
                # engine-computed results (script / business-rule tasks,
                # host-escaped or not) write mid-burst too
                return False
            if (other.multi_instance is not None
                    and other.multi_instance.output_collection == v):
                return False  # MI completion writes it to the parent scope
            if (other.element_type == BpmnElementType.CALL_ACTIVITY
                    and not is_ancestor(other.idx)):
                # a call's COMPLETION propagates arbitrary child variables
                # upward mid-burst; only an ANCESTOR call is safe (its
                # completion strictly postdates this body). Its ACTIVATION
                # propagation copies the very values admission predicted.
                return False
        # ancestor-scope input mappings could shadow it for collect(body)
        anc = el.parent_idx
        while anc > 0:
            if any(t == v for _e, t in exe.elements[anc].inputs):
                return False
            anc = exe.elements[anc].parent_idx
    else:
        return False  # computed collections re-evaluate; host-side only
    if mi.output_collection and mi.output_element is not None:
        if not _safe_mapping_expr(mi.output_element):
            return False
    return True


def _inline_mi_bodies(exe: ExecutableProcess,
                      ) -> tuple[ExecutableProcess, dict[int, int]]:
    """Append a synthetic INNER row per device-eligible multi-instance task:
    the body element keeps its row (child_start_idx → the inner row, lowered
    to K_MI by compile_tables), the inner copy drops the loop marker and
    lowers as a plain job-worker task whose parent scope is the body.
    Returns (exe', {body_row: inner_row}); unchanged when nothing qualifies.
    Reference: engine/…/processing/bpmn/container/MultiInstanceBodyProcessor
    .java — here spawn/completion counting runs on the device."""
    import dataclasses as _dc
    import hashlib as _hashlib

    bodies = [
        el for el in exe.elements[1:]
        if el.multi_instance is not None and el.child_start_idx < 0
        and _mi_body_device_eligible(exe, el)
    ]
    if bodies:
        # a body that can activate twice concurrently (unstructured merge
        # under a parallel split) or iteratively (cycle through the body)
        # would share its per-(instance, row) mi_left cell — exclude
        has_split = any(
            el.element_type == BpmnElementType.PARALLEL_GATEWAY
            and len(el.outgoing) > 1
            for el in exe.elements[1:]
        )
        unstructured = has_split and any(
            el.incoming_count > 1
            and el.element_type != BpmnElementType.PARALLEL_GATEWAY
            for el in exe.elements[1:]
        )
        if unstructured:
            bodies = []
        else:
            targets_of = {
                el.idx: [exe.flows[f].target_idx for f in el.outgoing]
                for el in exe.elements
            }

            def on_cycle(el) -> bool:
                seen: set[int] = set()
                stack = list(targets_of[el.idx])
                while stack:
                    n = stack.pop()
                    if n == el.idx:
                        return True
                    if n in seen:
                        continue
                    seen.add(n)
                    stack.extend(targets_of.get(n, ()))
                return False

            bodies = [el for el in bodies if not on_cycle(el)]
    if not bodies:
        return exe, {}
    elements = list(exe.elements)
    mi_inner: dict[int, int] = {}
    for el in bodies:
        inner_row = len(elements)
        elements.append(_dc.replace(
            el,
            idx=inner_row,
            parent_idx=el.idx,
            outgoing=[],
            default_flow_idx=-1,
            boundary_idxs=[],
            multi_instance=None,
        ))
        elements[el.idx] = _dc.replace(el, child_start_idx=inner_row)
        mi_inner[el.idx] = inner_row
    digest = _hashlib.sha256(
        (exe.digest + "|mi:" + ",".join(map(str, sorted(mi_inner)))).encode()
    ).hexdigest()
    return ExecutableProcess(
        process_id=exe.process_id, elements=elements, flows=list(exe.flows),
        by_id=exe.by_id, digest=digest,
    ), mi_inner


def _mi_burst_reach(exe: ExecutableProcess, ops_row,
                    mi_inner: dict[int, int]) -> dict[int, tuple]:
    """Per entry row, the K_MI body rows a single burst starting there can
    reach without crossing another wait state — over-approximate (scopes are
    both entered and crossed, since a waitless inside drains in-burst).
    Key -1 is the creation entry (the definition's none start); wait rows
    (tasks/catches) key their resume continuation, which also includes every
    ancestor scope's exit (a resume can drain ancestors) and, for an MI
    inner row, its own body (a sequential respawn re-reads the collection)."""
    targets_of = {
        el.idx: [exe.flows[f].target_idx for f in el.outgoing]
        for el in exe.elements
    }
    parking = {K_TASK, K_CATCH, K_HOST, K_MI}

    def closure(frontier) -> tuple:
        seen: set[int] = set()
        found: set[int] = set()
        stack = [x for x in frontier if x >= 0]
        while stack:
            x = stack.pop()
            if x in seen:
                continue
            seen.add(x)
            op = int(ops_row[x])
            if op == K_MI:
                found.add(x)
                continue  # the body parks; its children park at jobs
            el = exe.elements[x]
            if el.child_start_idx >= 0 and op == K_SCOPE:
                stack.append(el.child_start_idx)
                stack.extend(targets_of[x])  # may drain in-burst: cross it
                continue
            if op in parking:
                continue
            stack.extend(targets_of[x])
        return tuple(sorted(found))

    reach: dict[int, tuple] = {}
    start = exe.none_start_of(0)
    reach[-1] = closure([start] if start >= 0 else [])
    inner_to_body = {v: k for k, v in mi_inner.items()}
    for el in exe.elements[1:]:
        op = int(ops_row[el.idx])
        if op not in (K_TASK, K_CATCH):
            continue
        frontier = list(targets_of[el.idx])
        extra: set[int] = set()
        anc = el.parent_idx
        while anc > 0:
            if int(ops_row[anc]) == K_MI:
                extra.add(anc)
            frontier.extend(targets_of[anc])
            anc = exe.elements[anc].parent_idx
        body = inner_to_body.get(el.idx)
        if body is not None:
            extra.add(body)
            frontier.extend(targets_of[body])
        r = set(closure(frontier)) | extra
        if r:
            reach[el.idx] = tuple(sorted(r))
    return reach


def _esp_wait_counts(exe: ExecutableProcess, scope_row: int) -> tuple:
    """(timers, message subs, signal subs) a scope row's event
    sub-processes hold open on its instance."""
    starts = [exe.elements[esp.child_start_idx]
              for esp in exe.event_sub_processes_of(scope_row)]
    return (
        sum(1 for s in starts if s.timer_duration is not None),
        sum(1 for s in starts if s.message_name is not None),
        sum(1 for s in starts if s.signal_name is not None),
    )


@dataclass
class _DefInfo:
    index: int
    key: int
    exe: ExecutableProcess
    job_types: dict[int, str]  # element idx → static job type
    job_retries: dict[int, int]
    join_idxs: list[int]  # element idxs of K_JOIN gateways
    # task element idx → (# timer boundaries, # message boundaries) expected
    # open while the task is parked (reconstruction integrity check)
    boundary_waits: dict[int, tuple[int, int, int]]
    # element idxs lowered to K_HOST in the solo compile (forced again in
    # shared recompiles so the lowering stays stable across registrations)
    host_idxs: frozenset[int] = frozenset()
    # inlined called processes (exe is then SYNTHETIC: parent rows first,
    # then each segment's child rows); empty for plain definitions
    segments: tuple = ()
    # device multi-instance bodies: body row → synthetic inner row
    mi_inner: dict = field(default_factory=dict)
    # entry row → K_MI body rows a burst from that entry can reach without
    # crossing another wait state (-1 = the creation entry); admission must
    # predict those bodies' cardinalities before the group runs
    mi_reach: dict = field(default_factory=dict)
    # ROOT-level event sub-processes (their bodies host-escape; the ROOT
    # instance carries their start subscriptions): start-event element idxs
    # for admission pre-validation, and the expected open-subscription counts
    # (timers, message subs, signal subs) for reconstruction integrity
    root_esp_start_idxs: tuple = ()
    root_esp_waits: tuple = (0, 0, 0)
    # ditto for inlined child-root placeholder rows whose called definition
    # carries root ESPs: scope row -> (timers, msgs, signals) expected open
    # on that call frame's child process instance
    scope_esp_waits: dict = field(default_factory=dict)

    def segment_of_row(self, row: int):
        """The segment whose inlined region contains ``row`` (call_row and
        root_row included), or None for parent rows. Nested segments lie
        inside their parent's span; the MOST specific (highest offset ≤ row)
        wins, except that a call_row belongs to the OUTER region (the call
        element is part of the caller's graph)."""
        best = None
        for s in self.segments:
            if s.call_row == row:
                # the call element row: governed by the segment that inlined
                # it (an outer segment with offset ≤ row), not by itself
                continue
            if s.offset <= row < s.offset + len(s.child_exe.elements):
                if best is None or s.offset > best.offset:
                    best = s
        return best

    def call_segment(self, row: int):
        """The segment whose call activity element sits at ``row``, if any."""
        for s in self.segments:
            if s.call_row == row:
                return s
        return None


class KernelRegistry:
    """Per-partition registry of kernel-eligible definitions sharing one
    compiled table set (ops/tables.compile_tables). Grows as deployments are
    first touched; recompiles the shared tables on growth (deploys are rare)."""

    def __init__(self, max_definitions: int = 64) -> None:
        self.max_definitions = max_definitions
        self._by_key: dict[int, _DefInfo] = {}
        # definition key → typed catalog reason the registry declined it
        # for (engine/eligibility.py DEFINITION_REASONS) — the eligibility
        # report reads this, so the prediction IS the runtime's own verdict
        self._ineligible: dict[int, str] = {}
        # the most recent _build_info decline reason (set before each
        # ``return None`` so lookup can record it without re-deriving)
        self._last_decline: str | None = None
        self._infos: list[_DefInfo] = []
        self._tables: ProcessTables | None = None
        self._device = None
        self._device_by_dev: dict = {}  # router-chosen backend → DeviceTables
        self._tables_fp: tuple | None = None  # (tables identity, digest)

    def lookup(self, definition_key: int, exe: ExecutableProcess | None,
               processes=None) -> _DefInfo | None:
        info = self._by_key.get(definition_key)
        if info is not None:
            return info
        if definition_key in self._ineligible or exe is None:
            return None
        if len(self._infos) >= self.max_definitions:
            return None
        info = self._build_info(definition_key, exe, processes, len(self._infos))
        if info is None:
            self._ineligible[definition_key] = (
                self._last_decline or "condition-not-compilable")
            return None
        self._infos.append(info)
        self._by_key[definition_key] = info
        # recompile the SHARED set eagerly: definitions that solo-compile can
        # still conflict jointly (e.g. one uses a variable numerically, the
        # other in string comparisons — SlotMap kind clash downgrades the
        # offending gateway to a host escape in the shared lowering).
        try:
            self._tables = self._compile_shared()
        except ConditionNotCompilable:
            self._infos.pop()
            del self._by_key[definition_key]
            self._ineligible[definition_key] = "condition-not-compilable"
            self._tables = None  # previous set recompiles lazily
            return None
        self._device = None
        self._device_by_dev.clear()
        return info

    def decline_reason(self, definition_key: int) -> str | None:
        """The typed catalog reason a definition was declined for (None when
        never declined) — the eligibility report's definition-level truth."""
        return self._ineligible.get(definition_key)

    def refresh_segments(self, definition_key: int, exe, processes):
        """Re-inline a cached definition whose call segments went stale (a
        called id was redeployed). In place — the index, which any in-flight
        group arrays reference, is preserved. On failure the old info stays
        and admission keeps declining via the freshness check."""
        old = self._by_key.get(definition_key)
        if old is None or exe is None:
            return None
        new = self._build_info(definition_key, exe, processes, old.index)
        if new is None:
            return None
        self._infos[old.index] = new
        self._by_key[definition_key] = new
        try:
            self._tables = self._compile_shared()
        except ConditionNotCompilable:
            self._infos[old.index] = old
            self._by_key[definition_key] = old
            self._tables = None
            return None
        self._device = None
        self._device_by_dev.clear()
        return new

    def _build_info(self, definition_key: int, exe: ExecutableProcess,
                    processes, index: int) -> _DefInfo | None:
        """Compile one definition's solo lowering (with call activities
        inlined when resolvable) into a _DefInfo at ``index``. Returns None
        when it cannot ride the kernel; callers decide whether that marks
        the key ineligible (lookup) or keeps the old info (refresh)."""
        self._last_decline = None
        segments: tuple = ()
        if processes is not None:
            # statically-resolvable call activities inline as scope regions
            # (device-side call execution); the synthetic exe replaces the
            # real one for this definition's tables and trace decode
            exe, seg_list = _inline_call_activities(exe, processes)
            segments = tuple(seg_list)
        # device multi-instance bodies (incl. inside inlined call regions)
        exe, mi_inner = _inline_mi_bodies(exe)
        # elements outside the device subset become host escapes (K_HOST):
        # the device parks any token reaching them and the materializer hands
        # the continuation to the sequential engine — so the definition rides
        # the kernel for everything else instead of being rejected outright
        host = {el.idx for el in exe.elements[1:]
                if not check_element_eligibility(exe, el)}
        if exe.none_start_of(0) < 0:
            # only message/timer starts: every creation carries an explicit
            # start element — nothing for the kernel's entry path to run
            self._last_decline = "no-none-start"
            return None
        root_esp_start_idxs: list[int] = []
        for esp in exe.event_sub_processes_of(0):
            # root ESP bodies host-escape (their rows are outside the device
            # subset), but the DEFINITION rides the kernel: the creation
            # materializer opens the start subscriptions via the sequential
            # behavior verbatim, reconstruction counts them as root wait
            # state, and triggers route sequentially (a live ESP instance
            # makes resumes decline until it drains). Only subscription
            # shapes the reconstruction can count are eligible
            # (engine/eligibility.py esp_start_host_reason — shared with the
            # static classifier so prediction cannot drift).
            start = exe.elements[esp.child_start_idx]
            decline = esp_start_host_reason(start)
            if decline is not None:
                self._last_decline = decline
                return None  # e.g. cycle/date timers: sequential end to end
            root_esp_start_idxs.append(esp.child_start_idx)
        try:
            solo = compile_tables([exe], host_idxs=[host])
        except ConditionNotCompilable:
            self._last_decline = "condition-not-compilable"
            return None
        clock = lambda: 0  # noqa: E731 — static expressions ignore the clock
        job_types: dict[int, str] = {}
        job_retries: dict[int, int] = {}
        join_idxs: list[int] = []
        for el in exe.elements[1:]:
            if solo.kernel_op[0, el.idx] == K_TASK:
                job_types[el.idx] = el.job_type.evaluate({}, clock)
                job_retries[el.idx] = (
                    int(el.job_retries.evaluate({}, clock)) if el.job_retries is not None else 3
                )
            if solo.kernel_op[0, el.idx] == K_JOIN:
                join_idxs.append(el.idx)
        effective_host = frozenset(
            el.idx for el in exe.elements[1:]
            if solo.kernel_op[0, el.idx] == K_HOST
        )
        boundary_waits: dict[int, tuple[int, int, int]] = {}
        for el in exe.elements[1:]:
            if solo.kernel_op[0, el.idx] == K_TASK and el.boundary_idxs:
                bs = [exe.elements[b] for b in el.boundary_idxs]
                boundary_waits[el.idx] = (
                    sum(1 for b in bs if b.timer_duration is not None),
                    sum(1 for b in bs if b.message_name is not None),
                    sum(1 for b in bs if b.signal_name is not None),
                )
            elif (el.element_type == BpmnElementType.EVENT_BASED_GATEWAY
                  and el.idx not in effective_host):
                # an event-based gateway's wait states live on its own
                # instance, one per succeeding catch event
                ts = [exe.elements[exe.flows[f].target_idx] for f in el.outgoing]
                boundary_waits[el.idx] = (
                    sum(1 for t in ts if t.timer_duration is not None),
                    sum(1 for t in ts if t.message_name is not None),
                    sum(1 for t in ts if t.signal_name is not None),
                )
        return _DefInfo(
            index=index,
            key=definition_key,
            exe=exe,
            job_types=job_types,
            job_retries=job_retries,
            join_idxs=join_idxs,
            boundary_waits=boundary_waits,
            host_idxs=effective_host,
            segments=segments,
            mi_inner=mi_inner,
            mi_reach=(_mi_burst_reach(exe, solo.kernel_op[0], mi_inner)
                      if mi_inner else {}),
            root_esp_start_idxs=tuple(root_esp_start_idxs),
            root_esp_waits=(_esp_wait_counts(exe, 0)
                            if root_esp_start_idxs else (0, 0, 0)),
            scope_esp_waits={
                seg.root_row: waits
                for seg in segments
                if (waits := _esp_wait_counts(exe, seg.root_row)) != (0, 0, 0)
            },
        )

    def _compile_shared(self) -> ProcessTables:
        return compile_tables(
            [i.exe for i in self._infos],
            host_idxs=[set(i.host_idxs) for i in self._infos],
        )

    @property
    def tables(self) -> ProcessTables:
        if self._tables is None:
            self._tables = self._compile_shared()
        return self._tables

    @property
    def device_tables(self):
        """The table set on the default device (CUDA; raises without it)."""
        if self._device is None:
            from zeebe_tpu_torch.ops.automaton import DeviceTables

            self._device = DeviceTables.from_numpy(self.tables)
        return self._device

    def device_tables_for(self, device):
        """The table set on ``device`` (a torch device or its name), cached
        per device. ``None`` = the default device (the plain property)."""
        if device is None:
            return self.device_tables
        dev = torch.device(device)
        cached = self._device_by_dev.get(dev)
        if cached is None:
            from zeebe_tpu_torch.ops.automaton import DeviceTables

            cached = DeviceTables.from_numpy(self.tables, dev)
            self._device_by_dev[dev] = cached
        return cached

    @property
    def tables_fingerprint(self) -> str:
        """Identity of the compiled table set ACROSS partitions — a CONTENT
        digest of everything that shapes the sharded device program (table
        arrays, slot/interner assignments incl. order, job types): two
        partitions whose groups carry equal digests behave identically under
        the lead shard's replicated DeviceTables, so they may share one mesh
        dispatch. Content-based (not definition-key-based) so independently
        deployed copies of the same definitions coalesce too — the common
        case, since deployment distribution applies the same resources in
        the same order on every partition."""
        tables = self.tables
        fp = self._tables_fp
        if fp is None or fp[0] is not tables:
            import hashlib

            h = hashlib.sha256()
            for tag, arr in (("op", tables.kernel_op), ("ic", tables.in_count),
                             ("jt", tables.job_type), ("oc", tables.out_count),
                             ("ot", tables.out_target), ("oco", tables.out_cond),
                             ("ofi", tables.out_flow_idx),
                             ("ds", tables.default_slot),
                             ("se", tables.start_elem), ("ec", tables.elem_count),
                             ("ss", tables.scope_start), ("is", tables.in_scope),
                             ("mis", tables.mi_sequential),
                             ("cop", tables.cond_ops), ("ca", tables.cond_args)):
                # field tag + shape + dtype delimit each array: without them
                # raw byte streams could alias across array boundaries and two
                # different table sets could digest equal — and this digest
                # alone gates mesh-dispatch coalescing
                h.update(f"{tag}:{arr.shape}:{arr.dtype}".encode())
                h.update(arr.tobytes())
            h.update(repr(tables.job_type_names).encode())
            h.update(repr(list(tables.slot_map.names.items())).encode())
            h.update(repr(sorted(tables.slot_map.kinds.items())).encode())
            h.update(repr(list(tables.interner.ids.items())).encode())
            h.update(repr([sorted(v) for v in tables.cond_vars_by_def]).encode())
            fp = (tables, h.hexdigest())
            self._tables_fp = fp
        return fp[1]


# ---------------------------------------------------------------------------
# the device half


@dataclasses.dataclass
class Token:
    slot: int  # token-pool slot (assigned by build_group_arrays)
    elem_idx: int
    phase: int = PHASE_AT


@dataclasses.dataclass
class GroupInstance:
    """One instance of a group: its definition's row in the table set, its
    live tokens, and its per-instance device state."""

    idx: int  # row in the device batch
    definition: int  # index into the table set's definitions
    new: bool = True  # created by this group: one token at the start event
    tokens: list[Token] = dataclasses.field(default_factory=list)
    join_counts: dict[int, int] = dataclasses.field(default_factory=dict)
    # condition variables: name → (hi, lo) order-key planes
    slots: dict[str, tuple[int, int]] = dataclasses.field(default_factory=dict)
    # K_MI bodies: body row → children left to spawn; predicted cardinality
    mi_left: dict[int, int] = dataclasses.field(default_factory=dict)
    mi_cards: dict[int, int] = dataclasses.field(default_factory=dict)


def deploy(resources: list[str | bytes], max_fanout: int | None = None) -> ProcessTables:
    """BPMN XML resources → one shared table set (every process of every
    resource, in order)."""
    processes = [transform(model) for xml in resources for model in parse_bpmn_xml(xml)]
    return compile_tables(processes, max_fanout=max_fanout)


def _pow2(n: int) -> int:
    p = 8
    while p < n:
        p *= 2
    return p


def build_group_arrays(tables: ProcessTables, insts: list[GroupInstance],
                       max_group: int = MAX_GROUP):
    """Host (numpy) arrays for one group, padded to the shape bucket:
    (arrays, I, T), or None when the geometry exceeds the event-packing
    bounds. Sets each token's ``slot``."""
    n_real = len(insts)
    n_tokens = sum(max(1, len(i.tokens)) for i in insts)
    # two shape buckets: the small one (64) and the max-group one
    small = min(64, _pow2(max_group))
    I = small if n_real <= small else _pow2(max_group)
    # token pool: the set's static live-width bound sizes it exactly; with
    # no sound bound (parallel split on a cycle) keep the 4x factor
    width = tables.token_width
    mi_extra = sum(sum(i.mi_cards.values()) for i in insts if i.mi_cards)
    if width > 0:
        T = _pow2(max(width * I, n_tokens))
    else:
        T = _pow2(max(4 * I, 4 * n_tokens, n_tokens + mi_extra + I))
    E = tables.max_elements
    S = tables.num_slots
    if T > PACK_MAX_TOKENS or E >= PACK_MAX_ELEMENTS:
        logger.warning("kernel geometry T=%d E=%d exceeds event packing bounds", T, E)
        return None

    elem = np.full(T, -1, np.int32)
    phase = np.zeros(T, np.int32)
    inst_arr = np.zeros(T, np.int32)
    def_of = np.zeros(I, np.int32)
    var_slots = np.zeros((I, S, 2), np.int32)
    join_counts = np.zeros((I, E), np.int32)
    mi_left = np.zeros((I, E), np.int32)
    done = np.zeros(I, np.bool_)
    done[n_real:] = True  # padding rows must never report newly_done

    slot = 0
    for i in insts:
        def_of[i.idx] = i.definition
        for name, v in i.slots.items():
            var_slots[i.idx, tables.slot_map.names[name]] = v
        for jidx, count in i.join_counts.items():
            join_counts[i.idx, jidx] = count
        for row, n in i.mi_left.items():
            mi_left[i.idx, row] = n
        if i.new:
            i.tokens = [Token(slot=slot, elem_idx=int(tables.start_elem[i.definition]))]
            elem[slot] = i.tokens[0].elem_idx
            phase[slot] = PHASE_AT
            inst_arr[slot] = i.idx
            slot += 1
        else:
            for tok in i.tokens:
                tok.slot = slot
                elem[slot] = tok.elem_idx
                phase[slot] = tok.phase
                inst_arr[slot] = i.idx
                slot += 1
    arrays = {
        "elem": elem, "phase": phase, "inst": inst_arr, "def_of": def_of,
        "var_slots": var_slots, "join_counts": join_counts,
        "mi_left": mi_left, "done": done,
    }
    return arrays, I, T


def group_state(arrays: dict, device=None) -> dict:
    """The group's initial kernel state on ``device``: the host-filled arrays
    plus zero incident flags and counters."""
    I = arrays["def_of"].shape[0]
    return state_from_numpy({
        **arrays,
        "incident": np.zeros(I, np.bool_),
        "transitions": np.zeros((), np.int32),
        "jobs_created": np.zeros((), np.int32),
        "completed": np.zeros((), np.int32),
        "overflow": np.zeros((), np.bool_),
    }, resolve_device(device))


@dataclasses.dataclass
class _Chunk:
    """A dispatched chunk: its device output state and its rows on their
    way to the host."""

    state: dict
    rows: torch.Tensor  # host tensor (pinned on CUDA)
    ready: torch.cuda.Event | None


def _dispatch(dt: DeviceTables, state: dict, chunk: int, config, collect) -> _Chunk:
    """Enqueue one chunk and, right behind it on the stream, the copy of its
    rows into pinned host memory; a chunk dispatched later queues behind
    the copy, so fetching these rows never waits for it."""
    state, packed = collect(dt, state, n_steps=chunk, config=config)
    if not packed.is_cuda:
        return _Chunk(state, packed, None)
    # the copy and its event on the rows' card, whichever card is current
    with torch.cuda.device(packed.device):
        rows = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        rows.copy_(packed, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(packed.device))
    return _Chunk(state, rows, ready)


def fetch_rows(chunk: _Chunk) -> np.ndarray:
    """The one device→host ingestion point for a chunk's packed rows. It
    only waits on the chunk's recorded event and reads the pinned rows, so
    it may run on a watchdog thread: it enqueues nothing."""
    if chunk.ready is not None:
        chunk.ready.synchronize()
    return chunk.rows.numpy()


@dataclasses.dataclass
class GroupRun:
    steps: list[dict] | None  # unpacked per-step events; None on failure
    state: dict  # device state after the last fetched chunk
    chunks_run: int
    fail_reason: str | None = None


@dataclasses.dataclass
class _PendingGroup:
    """One group's device run as the fault seam sees it: the reference's
    ``_PendingGroup`` without admission and materialization."""

    dt: DeviceTables
    config: Any
    I: int
    T: int
    chunk_steps: int
    max_steps: int
    pipeline_chunks: bool
    failed: bool = False
    fail_reason: str | None = None
    chunks_run: int = 0
    # shadow groups keep host copies of the initial arrays (the oracle's
    # start) and of every fetched chunk's rows; corrupt_tokens are chaos-
    # ledger sequences the seam must report caught (shadow or containment)
    shadow: bool = False
    initial: dict | None = None
    raw_rows: list = field(default_factory=list)
    corrupt_tokens: list = field(default_factory=list)


def run_group(dt: DeviceTables, config, state: dict, I: int, T: int,
              chunk_steps: int = CHUNK_STEPS, max_steps: int = MAX_STEPS,
              pipeline_chunks: bool | None = None, collect=None,
              defense: "DeviceDefense | None" = None) -> GroupRun:
    """Run the group's device loop until it quiesces: one dispatch and one
    host fetch per chunk of ``chunk_steps`` lock-steps. From the second
    chunk on (on CUDA), chunk k+1 is dispatched off chunk k's device state
    before chunk k's rows are fetched, so the device computes while the
    host decodes. The first chunk never prefetches: groups that quiesce at
    once would pay a wasted chunk. ``collect`` replaces ``run_collect``
    (a checker passes the plain version to run it on the card).
    ``defense`` runs the group through the device-fault seam (chaos hooks,
    dispatch watchdog, containment, sampled shadow verification); without
    it nothing of the seam runs."""
    collect = collect or run_collect
    if pipeline_chunks is None:
        pipeline_chunks = state["elem"].is_cuda
    pg = _PendingGroup(dt, config, I, T, chunk_steps, max_steps, pipeline_chunks)
    if defense is not None:
        return defense.run(pg, state, collect)
    first = _dispatch(dt, state, chunk_steps, config, collect)
    return _complete_device_run(pg, first, collect, lambda chunk, k: fetch_rows(chunk))


def _complete_device_run(pg: _PendingGroup, cur: _Chunk, collect, fetch) -> GroupRun:
    """The chunk loop behind the first dispatched chunk ``cur``; ``fetch``
    (chunk, index) brings a chunk's rows to the host."""
    chunk = pg.chunk_steps
    T, I = pg.T, pg.I
    FO = pg.dt.out_target.shape[2]
    steps: list[dict] = []
    overflow = False
    state = cur.state
    nxt = None
    max_chunks = max(1, pg.max_steps // chunk)
    hit_quiescence = False
    for k in range(max_chunks):
        if pg.pipeline_chunks and k >= 1 and k + 1 < max_chunks:
            nxt = _dispatch(pg.dt, state, chunk, pg.config, collect)
        flat = fetch(cur, k)
        pg.chunks_run = k + 1
        # per row: T*(2+FO) packed event ints + (active, overflow) tail
        events_host = flat[:, :-2].reshape(chunk, T, 2 + FO)
        active = flat[:, -2]
        # overflow is cumulative in the state; rows past quiescence are
        # unwritten zeros, so any written row carrying the bit is the signal
        overflow = overflow or bool(flat[:, -1].any())
        quiesced = np.flatnonzero(active == 0)
        keep = int(quiesced[0]) + 1 if quiesced.size else chunk
        for s in range(keep):
            steps.append(unpack_events(events_host[s], I))
        if quiesced.size:
            hit_quiescence = True
            break  # a prefetched over-run chunk is simply never fetched
        if nxt is not None:
            cur, nxt = nxt, None
        elif k + 1 < max_chunks:
            cur = _dispatch(pg.dt, state, chunk, pg.config, collect)
        state = cur.state
    if not hit_quiescence:
        pg.fail_reason = "no-quiesce"
        logger.warning("kernel group did not quiesce in %d steps", pg.max_steps)
        return GroupRun(None, state, pg.chunks_run, pg.fail_reason)
    if overflow:
        pg.fail_reason = "token-overflow"
        logger.warning("kernel token pool overflow (T=%d)", T)
        return GroupRun(None, state, pg.chunks_run, pg.fail_reason)
    return GroupRun(steps, state, pg.chunks_run)


# ---------------------------------------------------------------------------
# the device-fault seam


class DeviceWedgedError(RuntimeError):
    """A device dispatch/fetch exceeded the per-dispatch watchdog deadline
    (``ZEEBE_BROKER_DEVICE_DISPATCHTIMEOUTMS``) — the gray-failure shape a
    slow-but-alive device tunnel produces. Contained exactly like a
    dispatch exception: the group is abandoned and host re-executed."""


#: the device-chaos seam: ``testing/chaos_device.py`` installs a
#: controller here (worker entry, from ``ZEEBE_CHAOS_DEVICE``); the dispatch
#: path consults it with ONE is-None check per group when chaos is off
_DEVICE_CHAOS = None


def install_device_chaos(controller) -> None:
    """Install (or, with None, remove) the process-wide device-fault
    controller consulted at the kernel dispatch seam."""
    global _DEVICE_CHAOS
    _DEVICE_CHAOS = controller


def device_chaos():
    return _DEVICE_CHAOS


class _WatchdogWorker:
    """One reusable daemon thread of the dispatch-watchdog pool. A worker
    abandoned by a deadline miss keeps blocking on the wedged ``fn`` — but
    instead of dying (and leaking, one thread per expired dispatch, the
    old behavior) it re-idles ITSELF when the wedged call finally
    returns, so a bounded pool serves any number of wedges."""

    def __init__(self, pool: "_WatchdogPool") -> None:
        import queue
        import threading

        self._pool = pool
        self._tasks: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="device-dispatch-watchdog")
        self._thread.start()

    def submit(self, fn, box: dict, done) -> None:
        self._tasks.put((fn, box, done))

    def _loop(self) -> None:
        while True:
            fn, box, done = self._tasks.get()
            try:
                box["value"] = fn()
            except BaseException as exc:  # noqa: BLE001 — re-raised on caller
                box["error"] = exc
            done.set()
            # re-idle AFTER the task finishes — a deadline-missed caller
            # already walked away, so this is what un-leaks a wedge; the
            # pool drops us when already at capacity and the thread exits
            if not self._pool.release(self):
                return


class _WatchdogPool:
    """Bounded free-list of :class:`_WatchdogWorker` threads."""

    MAX_IDLE = 8

    def __init__(self) -> None:
        import threading

        self._idle: list[_WatchdogWorker] = []
        self._lock = threading.Lock()

    def acquire(self) -> _WatchdogWorker:
        with self._lock:
            if self._idle:
                return self._idle.pop()
        return _WatchdogWorker(self)

    def release(self, worker: _WatchdogWorker) -> bool:
        with self._lock:
            if len(self._idle) < self.MAX_IDLE:
                self._idle.append(worker)
                return True
        return False


_WATCHDOG_POOL = _WatchdogPool()


def _watchdog_call(fn, deadline_s: float):
    """Run ``fn`` on a pooled daemon thread with a deadline — the dispatch
    watchdog. A deadline miss raises :class:`DeviceWedgedError` while the
    pooled worker keeps blocking on the wedged call; when that call
    eventually returns the worker re-idles itself, so repeated wedges
    reuse a bounded pool instead of leaking one thread per expiry."""
    import threading

    box: dict = {}
    done = threading.Event()
    worker = _WATCHDOG_POOL.acquire()
    worker.submit(fn, box, done)
    if not done.wait(deadline_s):
        raise DeviceWedgedError(
            f"device dispatch exceeded the {deadline_s * 1000:.0f}ms "
            f"watchdog deadline (wedged or badly degraded device)")
    if "error" in box:
        raise box["error"]
    return box["value"]


class DeviceDefense:
    """What the reference's ``KernelBackend`` keeps for the device-fault
    seam, for one partition: the shared health ladder, the shadow sampling
    sequence, the partition id (it seeds the sampling stream), and the
    counts of shadow-quarantined and declined groups. ``run_group(...,
    defense=...)`` runs a group through it.

    Containment returns a failed group as a typed ``fail_reason``
    (``device-dispatch-error``, ``device-wedged``) and never re-runs it: the
    port has no sequential engine to hand it to yet. A shadow mismatch is
    declined the same way (``device-shadow-mismatch``): the device result is
    quarantined and the oracle's is not returned in its place, so a wrong
    kernel surfaces as a decline rather than being patched by the plain
    version.

    A wedge abandons the group's chunks: the one in flight and a prefetched
    one are never fetched, and their references are dropped. The pooled
    watchdog thread finishes its stale wait and re-idles; the device runs
    the abandoned chunks to their end in stream order, ahead of any later
    group's work."""

    def __init__(self, partition_id: int = 0, health=None) -> None:
        self.health = health if health is not None else shared_device_health()
        self._shadow_seq = 0
        self.partition = partition_id
        #: groups whose device result a shadow mismatch quarantined
        #: (declined as ``device-shadow-mismatch``)
        self.shadow_quarantined = 0
        #: groups declined (containment or a typed device-run decline)
        self.fallbacks = 0
        #: wall seconds spent in the shadow oracle
        self.shadow_seconds = 0.0
        self._host_tables_of: tuple | None = None

    @property
    def shadow_sample_rate(self) -> float:
        return self.health.cfg.shadow_sample_rate

    @property
    def dispatch_timeout_ms(self) -> int:
        return self.health.cfg.dispatch_timeout_ms

    def run(self, pg: _PendingGroup, state: dict, collect) -> GroupRun:
        # shadow sampling decided BEFORE dispatch: only sampled groups pay
        # the host copies of the initial arrays and of the fetched rows
        pg.shadow = self._shadow_sampled()
        if pg.shadow:
            # the oracle's start: the group's true initial state, copied
            # before anything is dispatched
            pg.initial = {k: v.to("cpu", copy=True) for k, v in state.items()}
        try:
            chaos = _DEVICE_CHAOS
            if chaos is not None:
                chaos.dispatch_fault()
            first = _dispatch(pg.dt, state, pg.chunk_steps, pg.config, collect)
        except Exception as exc:  # noqa: BLE001 — containment: a device
            # failure (chaos-injected or real) becomes a typed decline
            self._contain_device_failure(pg, exc, where="dispatch")
            return self._decline(pg, state)
        try:
            run = _complete_device_run(pg, first, collect,
                                       lambda chunk, k: self._fetch_rows(pg, chunk, k))
        except Exception as exc:  # noqa: BLE001 — containment: a mid-group
            # fetch failure or watchdog-expired stall abandons the group
            self._contain_device_failure(pg, exc, where="fetch")
            return self._decline(pg, state)
        steps = run.steps
        if steps is not None and pg.shadow:
            steps = self._verify_steps(pg, steps)
        if steps is None:
            return self._decline(pg, state if pg.failed else run.state)
        self.health.note_group_ok()
        return GroupRun(steps, run.state, run.chunks_run)

    def _decline(self, pg: _PendingGroup, state: dict) -> GroupRun:
        """A declined group: counted, and any chaos corruption it carried
        reported caught by containment (its rows are discarded)."""
        self.fallbacks += 1
        chaos = _DEVICE_CHAOS
        if chaos is not None and pg.corrupt_tokens:
            for token in pg.corrupt_tokens:
                chaos.note_caught(token, "contained")
            pg.corrupt_tokens = []
        return GroupRun(None, state, pg.chunks_run, pg.fail_reason)

    def _fetch_rows(self, pg: _PendingGroup, chunk: _Chunk, chunk_index: int) -> np.ndarray:
        """Every fetched chunk passes through here before decode: the chaos
        seam (stalls, partial-chunk failures, result corruption) and the
        dispatch watchdog live here; shadow groups keep a copy of the rows."""
        chaos = _DEVICE_CHAOS

        def fetch():
            if chaos is not None:
                chaos.fetch_fault(chunk_index)
            return fetch_rows(chunk)

        deadline_ms = self.dispatch_timeout_ms
        # the watchdog thread-hop is paid only on the card (pipelined
        # chunks: a device can wedge) or under the chaos plane
        if deadline_ms > 0 and (chaos is not None or pg.pipeline_chunks):
            flat = _watchdog_call(fetch, deadline_ms / 1000.0)
        else:
            flat = fetch()
        if chaos is not None or pg.shadow:
            # a copy: on the CPU the rows are the packed output itself and
            # .numpy() shares its memory; corruption and the shadow
            # comparison must never touch or alias it
            flat = np.array(flat)
        if chaos is not None:
            token = chaos.corrupt_rows(flat, chunk_index)
            if token is not None:
                pg.corrupt_tokens.append(token)
        if pg.shadow:
            pg.raw_rows.append(flat)
        return flat

    def _contain_device_failure(self, pg: _PendingGroup, exc, where: str) -> None:
        """A dispatch exception or a watchdog-expired stall declines the group
        with a TYPED reason and the health ladder hears about it; ``_decline``
        reports any chaos corruption riding the group caught (its rows are
        discarded)."""
        kind = ("device-wedged" if isinstance(exc, DeviceWedgedError)
                else "device-dispatch-error")
        pg.failed = True
        pg.fail_reason = kind
        logger.warning("device failure contained at %s (%s): %r — group declined",
                       where, kind, exc)
        self.health.note_fault(kind, detail=f"{where}: {exc!r}"[:200])

    def _shadow_sampled(self) -> bool:
        """Deterministic seeded sampling stream for shadow verification:
        one decision per dispatched group, boosted while SUSPECT. Counter-
        hash based, as the reference's (the same crc32 formula)."""
        rate = self.shadow_sample_rate
        if rate <= 0:
            return False
        cfg = self.health.cfg
        if self.health.state == SUSPECT:
            rate = min(1.0, rate * cfg.suspect_shadow_boost)
        if rate >= 1.0:
            return True
        self._shadow_seq += 1
        h = zlib.crc32(f"{cfg.shadow_seed}:{self.partition}:"
                       f"{self._shadow_seq}".encode("ascii"))
        return (h % 1_000_000) < rate * 1_000_000

    def _host_tables(self, dt: DeviceTables) -> DeviceTables:
        """The group's tables on the CPU (the last set is kept)."""
        if self._host_tables_of is None or self._host_tables_of[0] is not dt:
            host = DeviceTables(**{f.name: getattr(dt, f.name).cpu()
                                   for f in dataclasses.fields(DeviceTables)})
            self._host_tables_of = (dt, host)
        return self._host_tables_of[1]

    def _shadow_execute(self, pg: _PendingGroup):
        """Re-execute the group on the CPU with the plain ``run_collect``
        from the host copies of its initial arrays, through the same chunk
        loop and chunking but without the chaos and watchdog seam (the
        oracle must not be faultable). Returns the oracle's rows per chunk;
        raises when the oracle itself does not finish the group."""
        dt = self._host_tables(pg.dt)
        oracle = _PendingGroup(dt, pg.config, pg.I, pg.T, pg.chunk_steps, pg.max_steps,
                               pipeline_chunks=False)
        rows: list[np.ndarray] = []

        def fetch(chunk: _Chunk, k: int) -> np.ndarray:
            rows.append(fetch_rows(chunk))
            return rows[-1]

        first = _dispatch(dt, pg.initial, pg.chunk_steps, pg.config, run_collect)
        run = _complete_device_run(oracle, first, run_collect, fetch)
        if run.fail_reason is not None:
            raise RuntimeError(f"shadow oracle failed: {run.fail_reason}")
        return rows

    def _verify_steps(self, pg: _PendingGroup, steps):
        """Sampled shadow verification: the device's fetched rows against the
        oracle's, byte for byte, before the steps are returned. On mismatch
        the device result is quarantined: the group is declined as
        ``device-shadow-mismatch`` and the ladder latches SUSPECT. Returns
        the steps (None: decline)."""
        health = self.health
        health.note_shadow_check()
        t0 = time.perf_counter()
        try:
            shadow_rows = self._shadow_execute(pg)
        except Exception as exc:  # noqa: BLE001 — oracle failure: decline
            # the group rather than return an unverified device result
            self._contain_device_failure(pg, exc, where="shadow")
            return None
        self.shadow_seconds += time.perf_counter() - t0
        rows = pg.raw_rows
        match = (len(rows) == len(shadow_rows)
                 and all(np.array_equal(a, b) for a, b in zip(rows, shadow_rows)))
        if match:
            return steps
        chaos = _DEVICE_CHAOS
        if chaos is not None and pg.corrupt_tokens:
            for token in pg.corrupt_tokens:
                chaos.note_caught(token, "shadow")
            pg.corrupt_tokens = []
        self.shadow_quarantined += 1
        health.note_shadow_mismatch(
            detail=f"I={pg.I} T={pg.T} deviceChunks={len(rows)} "
                   f"oracleChunks={len(shadow_rows)}")
        logger.warning("shadow verification MISMATCH (I=%d T=%d): device result "
                       "quarantined, group declined", pg.I, pg.T)
        pg.failed = True
        pg.fail_reason = "device-shadow-mismatch"
        return None


def cascade_ops(tables: ProcessTables, inst: GroupInstance, steps: list[dict]) -> list:
    """Trace one instance's route through the device steps.

    Ops (logical token ids; initial tokens are 0..len(tokens)-1, flow
    targets get ids in creation order):
      ("arrive", l, elem)      task activated, token parks
      ("done", l, elem)        parked task completes (job completed)
      ("pass", l, elem)        full activate+complete pass
      ("nomatch", l, elem)     exclusive gateway with no matching flow
      ("flow", l, elem, fo, new_l)  flow slot fo taken; new_l == -1 when
                               no token was placed (join arrival merged)
      ("scopearr", l, elem, new_l)  sub-process entered, inner start token
      ("miarr", l, elem)       multi-instance body activated
      ("hostarr", l, elem)     token reached a host-escaped element
      ("complete",)            the process instance completed
    """
    d = inst.definition
    exe = tables.definitions[d]
    ops: list = []
    # live: [logical id, slot, elem_idx]
    live = [[l, t.slot, t.elem_idx] for l, t in enumerate(inst.tokens)]
    next_l = len(live)
    # logical id → step index at which a host-escaped token "arrives"
    host_arrive: dict[int, int] = {}
    done_emitted = False
    for si, ev in enumerate(steps):
        if done_emitted or not live:
            break
        T = ev["elem"].shape[0]
        additions: list = []
        for tok in list(live):
            l, s, e = tok
            if l in host_arrive:
                if host_arrive[l] == si:
                    ops.append(("hostarr", l, e))
                    del host_arrive[l]
                    live.remove(tok)
                continue
            if ev["inst"][s] != inst.idx or ev["elem"][s] != e:
                continue  # slot reused after this token died (stale entry)
            if ev["task_arrive"][s]:
                if tables.kernel_op[d, e] == K_SCOPE:
                    # the inner start token's placement rides flow slot 0
                    dest = int(ev["dest"][s, 0])
                    nl = next_l
                    next_l += 1
                    start_idx = int(tables.scope_start[d, e])
                    additions.append([nl, dest, start_idx])
                    ops.append(("scopearr", l, e, nl))
                    if tables.kernel_op[d, start_idx] == K_HOST:
                        host_arrive[nl] = si + 1
                elif tables.kernel_op[d, e] == K_MI:
                    # spawned MI children are device occupancy only; their
                    # records ride the sequential drain, so only the body
                    # is traced
                    ops.append(("miarr", l, e))
                else:
                    ops.append(("arrive", l, e))
            elif ev["task_done"][s] or ev["full_pass"][s]:
                ops.append(("done" if ev["task_done"][s] else "pass", l, e))
                for fo in range(ev["take_mask"].shape[1]):
                    if not ev["take_mask"][s, fo]:
                        continue
                    dest = int(ev["dest"][s, fo])
                    if dest < T:
                        fid = int(tables.out_flow_idx[d, e, fo])
                        # fid < 0: synthetic link-jump edge
                        target_idx = (int(tables.out_target[d, e, fo])
                                      if fid < 0 else exe.flows[fid].target_idx)
                        nl = next_l
                        next_l += 1
                        additions.append([nl, dest, target_idx])
                        ops.append(("flow", l, e, fo, nl))
                        if tables.kernel_op[d, target_idx] == K_HOST:
                            host_arrive[nl] = si + 1
                    else:
                        ops.append(("flow", l, e, fo, -1))
                live.remove(tok)
            elif ev["no_match"][s]:
                ops.append(("nomatch", l, e))
                live.remove(tok)
        live.extend(additions)
        if ev["newly_done"][inst.idx] and not done_emitted:
            ops.append(("complete",))
            done_emitted = True
    return ops


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def parked_jobs(tables: ProcessTables, state: dict) -> np.ndarray:
    """Slots of tokens parked at a job-worker task (the jobs a worker can
    complete), in slot order. ``state`` holds tensors or host arrays."""
    elem = _host(state["elem"])
    phase = _host(state["phase"])
    inst = _host(state["inst"])
    def_of = _host(state["def_of"])
    live = elem >= 0
    op = np.where(live, tables.kernel_op[def_of[inst], np.maximum(elem, 0)], 0)
    return np.flatnonzero(live & (phase == PHASE_WAIT) & (op == K_TASK))


def live_tokens(state: dict, insts: list[GroupInstance]) -> None:
    """Reset each instance's token list to its live tokens in ``state``
    (tensors or host arrays), in slot order (the start of the next wave's
    trace)."""
    elem = _host(state["elem"])
    phase = _host(state["phase"])
    inst = _host(state["inst"])
    by_inst: dict[int, list[Token]] = {i.idx: [] for i in insts}
    for s in np.flatnonzero(elem >= 0):
        toks = by_inst.get(int(inst[s]))
        if toks is not None:
            toks.append(Token(slot=int(s), elem_idx=int(elem[s]), phase=int(phase[s])))
    for i in insts:
        i.tokens = by_inst[i.idx]
        i.new = False


@dataclasses.dataclass
class GroupResult:
    waves: list[dict[int, list]]  # per wave: instance idx → trace
    state: dict  # final device state
    steps: int  # lock-steps decoded over all waves
    chunks: int  # chunks fetched over all waves
    run_seconds: float  # wall time in run_group: device loop, fetch, unpack


def drive_group(tables: ProcessTables, dt: DeviceTables, insts: list[GroupInstance],
                device=None, chunk_steps: int = CHUNK_STEPS, max_steps: int = MAX_STEPS,
                max_group: int = MAX_GROUP, max_waves: int = 64,
                collect=None, defense: DeviceDefense | None = None) -> GroupResult:
    """Run one group through job-completion waves and trace every wave.
    Raises when the group does not fit the packing bounds, does not
    quiesce, overflows its token pool, or (with ``defense``) is declined by
    the fault seam. ``collect`` and ``defense`` as for run_group."""
    built = build_group_arrays(tables, insts, max_group)
    if built is None:
        raise ValueError("group geometry exceeds the event packing bounds")
    arrays, I, T = built
    state = group_state(arrays, device)
    config = tables.kernel_config
    waves: list[dict[int, list]] = []
    n_steps = n_chunks = 0
    run_seconds = 0.0
    for _ in range(max_waves):
        t0 = time.perf_counter()
        run = run_group(dt, config, state, I, T, chunk_steps, max_steps, collect=collect,
                        defense=defense)
        run_seconds += time.perf_counter() - t0
        if run.fail_reason is not None:
            raise RuntimeError(f"group run failed: {run.fail_reason}")
        waves.append({i.idx: cascade_ops(tables, i, run.steps) for i in insts})
        n_steps += len(run.steps)
        n_chunks += run.chunks_run
        state = run.state
        jobs = parked_jobs(tables, state)
        if jobs.size == 0:
            break
        state = complete_jobs(state, jobs)
        live_tokens(state, insts)
    return GroupResult(waves, state, n_steps, n_chunks, run_seconds)


# ---------------------------------------------------------------------------
# partitions on a shared mesh runner


def run_group_on_mesh(runner, registry: KernelRegistry, arrays: dict, I: int, T: int,
                      chunk_steps: int = CHUNK_STEPS, max_steps: int = MAX_STEPS) -> GroupRun:
    """One group through the shared ``MeshKernelRunner``: the request as the
    reference's ``KernelBackend._await_kernel`` builds it for the mesh, and
    its result mapped to the reference's fail reasons (``mesh-dispatch-error``,
    ``mesh-no-quiesce``, ``mesh-token-overflow``). The run's ``state`` is the
    group's host arrays after the run, at the dispatch's geometry."""
    result = runner.submit(GroupRequest(
        device_tables=registry.device_tables_for(runner.mesh.device),
        config=registry.tables.kernel_config,
        tables_fingerprint=registry.tables_fingerprint,
        arrays=arrays,
        num_instances=I,
        num_tokens=T,
        max_steps=max_steps,
        chunk_steps=chunk_steps,
    ))
    if result.steps is None:
        reason = "mesh-dispatch-error"
    elif not result.quiesced:
        reason = "mesh-no-quiesce"
    elif result.overflow:
        reason = "mesh-token-overflow"
    else:
        reason = None
    if reason is not None:
        logger.warning("mesh kernel group failed: %s", reason)
        return GroupRun(None, result.state, 0, reason)
    chunks = -(-len(result.steps) // chunk_steps)
    return GroupRun(result.steps, result.state, chunks)


_GROUP_KEYS = ("elem", "phase", "inst", "def_of", "var_slots", "join_counts",
               "mi_left", "done")
_COUNTER_KEYS = ("transitions", "jobs_created", "completed")


def _drive_partition(runner, registry: KernelRegistry, insts: list[GroupInstance],
                     chunk_steps: int, max_steps: int, max_group: int,
                     max_waves: int) -> GroupResult:
    """One partition's waves through the runner: each wave's request is the
    previous run's state with its parked jobs completed."""
    tables = registry.tables
    built = build_group_arrays(tables, insts, max_group)
    if built is None:
        raise ValueError("group geometry exceeds the event packing bounds")
    arrays, I, T = built
    waves: list[dict[int, list]] = []
    n_steps = n_chunks = 0
    run_seconds = 0.0
    totals = {k: np.zeros(1, np.int32) for k in _COUNTER_KEYS}
    incident = np.zeros(I, np.bool_)
    final = None
    for _ in range(max_waves):
        t0 = time.perf_counter()
        run = run_group_on_mesh(runner, registry, arrays, I, T, chunk_steps, max_steps)
        run_seconds += time.perf_counter() - t0
        if run.fail_reason is not None:
            raise RuntimeError(f"group run failed: {run.fail_reason}")
        waves.append({i.idx: cascade_ops(tables, i, run.steps) for i in insts})
        n_steps += len(run.steps)
        n_chunks += run.chunks_run
        final = run.state
        # the dispatch may have padded the group to a larger bucket
        I, T = final["def_of"].shape[0], final["elem"].shape[0]
        for k in _COUNTER_KEYS:
            totals[k] += final[k]  # wraps as int32
        incident = _pad_axis0(incident, I, False) | final["incident"]
        jobs = parked_jobs(tables, final)
        if jobs.size == 0:
            break
        arrays = {k: final[k] for k in _GROUP_KEYS}
        arrays["phase"] = arrays["phase"].copy()
        arrays["phase"][jobs] = PHASE_DONE
        live_tokens(arrays, insts)
    counters = {k: v.reshape(()) for k, v in totals.items()}
    state = state_from_numpy({**final, **counters, "incident": incident}, "cpu")
    return GroupResult(waves, state, n_steps, n_chunks, run_seconds)


def drive_groups_on_mesh(runner, partitions: list, chunk_steps: int = CHUNK_STEPS,
                         max_steps: int = MAX_STEPS, max_group: int = MAX_GROUP,
                         max_waves: int = 64) -> list[GroupResult]:
    """Drive N partitions' groups through job-completion waves on a shared
    ``MeshKernelRunner``. ``partitions`` holds one ``(registry, instances)``
    pair per partition, the instances' ``definition`` indexing the registry's
    table set. Each partition runs on its own thread and submits each wave to
    the runner, which coalesces the partitions whose table fingerprints are
    equal into one sharded dispatch. Returns one ``GroupResult`` per
    partition, in order: per-wave traces, the final state (host tensors,
    counters summed over the waves), decoded steps and chunks. Raises the
    first partition's error after every thread has ended."""
    results: list[GroupResult | None] = [None] * len(partitions)
    errors: list[BaseException | None] = [None] * len(partitions)

    def work(k: int, registry, insts) -> None:
        try:
            results[k] = _drive_partition(runner, registry, insts, chunk_steps,
                                          max_steps, max_group, max_waves)
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            errors[k] = exc

    threads = [threading.Thread(target=work, args=(k, reg, insts), name=f"partition-{k}")
               for k, (reg, insts) in enumerate(partitions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for exc in errors:
        if exc is not None:
            raise exc
    return results  # type: ignore[return-value]
