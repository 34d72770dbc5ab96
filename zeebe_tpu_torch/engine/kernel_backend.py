"""The engine's batched execution backend on torch: ``KernelBackend``.

The counterpart of ``zeebe_tpu/engine/kernel_backend.py``. The stream
processor hands the backend a run of committed commands (creations, job
completions, timer triggers, message correlations); the backend admits them
into a group, runs every touched instance lock-step on the device in chunks
of ``run_collect``, traces each instance's route from the packed step rows,
and materializes the record stream the sequential engine would have written,
byte for byte, through the normal writers.

What is copied from the reference (``testing/copies.py`` writes and checks
it): the registry half (``KernelRegistry``, element eligibility, call-
activity and multi-instance inlining, ``_DefInfo``), the fingerprint walk of
the burst templates, the admission and materialization dataclasses, and
every member of ``KernelBackend`` that is host code: candidate tests,
admission, the group build, ``begin_group``/``finish_group``, the route
trace and materialization. The registry's ``device_tables`` and
``device_tables_for`` place the port's ``DeviceTables`` on a torch device.

What is the port's own, the device half: a group padded to its shape bucket
is placed on the device (``group_state``) and run in chunks until it
quiesces, the next chunk dispatched before the current one's rows are
fetched (``run_group``, ``_complete_device_run``); the device-fault seam
(``DeviceDefense``: chaos hooks at dispatch and fetch, the dispatch
watchdog, containment of a failed dispatch or a wedge, sampled shadow
verification against the plain ``run_collect`` on the CPU, the health
ladder). ``KernelBackend`` is a ``DeviceDefense``, and its device members
(``_start_kernel``, ``_await_kernel``, ``_group_state``,
``_dispatch_first_chunk``, ``_complete_device_run``) run on that half.
The backend runs on CUDA unless built with ``device="cpu"``. A contained
group declines and its head command runs on the sequential engine; a
shadow mismatch commits the host oracle's steps and latches SUSPECT, as in
the reference.

The device half also runs without the engine: ``drive_group`` runs one group
of plain ``GroupInstance`` records through job-completion waves — the
device until it quiesces with every token parked, a trace of the wave, then
every parked job completed (``complete_jobs``) as job workers would — and
``drive_groups_on_mesh`` does the same for several partitions at once, each
on its own thread, through a shared ``MeshKernelRunner``
(``run_group_on_mesh``): up to ``n_shards`` partitions' groups ride one
sharded dispatch. Both build and trace their groups with the backend's own
``_build_group_arrays`` and ``_cascade_ops``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
import zlib
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Callable

import numpy as np
import torch

from zeebe_tpu_torch.engine.device_health import SUSPECT, shared_device_health
from zeebe_tpu_torch.engine.eligibility import PathAccounting, esp_start_host_reason
from zeebe_tpu_torch.feel.feel import FeelEvalError
from zeebe_tpu_torch.feel.feel import Lit as _FeelLit
from zeebe_tpu_torch.feel.feel import Var as _FeelVar
from zeebe_tpu_torch.models.bpmn import parse_bpmn_xml, transform
from zeebe_tpu_torch.models.bpmn.executable import ExecutableElement, ExecutableProcess
from zeebe_tpu_torch.ops import kernels
from zeebe_tpu_torch.ops.automaton import (
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
from zeebe_tpu_torch.ops.tables import f64_exact as _f64_exact
from zeebe_tpu_torch.parallel.mesh_runner import GroupRequest, _pad_axis0
from zeebe_tpu_torch.protocol import ValueType
from zeebe_tpu_torch.protocol.enums import BpmnElementType, BpmnEventType, ErrorType
from zeebe_tpu_torch.protocol.intent import (
    IncidentIntent,
    JobIntent,
    ProcessInstanceCreationIntent,
    ProcessMessageSubscriptionIntent,
    TimerIntent,
)
from zeebe_tpu_torch.protocol.intent import ProcessInstanceIntent as PI
from zeebe_tpu_torch.utils.device_link import shared_router

logger = logging.getLogger(__name__)

# the partition's geometry (zeebe_tpu/broker/partition.py builds its backend
# with max_group=2048, chunk_steps=8; max_steps is the backend's default)
MAX_GROUP = 2048
CHUNK_STEPS = 8
MAX_STEPS = 4096


# ---------------------------------------------------------------------------
# module helpers of the burst templates and admission (copied)

# copied from the reference: _py_pack_fingerprint .. _CANDIDATE_COMMANDS
def _py_pack_fingerprint(docs, roles: dict[int, str],
                         fp_fields: frozenset[str]
                         ) -> tuple[bytes, list[int], set[int]]:
    """Pure-Python fingerprint walk — the specification the native
    ``pack_fingerprint`` (native/codec.c) is byte-equality-tested against.

    Pass 1 collects large ints pinned at NON-whitelisted positions — a value
    that also occurs pinned elsewhere must not be extracted (the slow path
    may copy it from the pinned position, and patching every value-equal
    occurrence would corrupt that copy). Pass 2 emits msgpack with role
    markers ["\\x00r", tag], extraction markers ["\\x00f", ordinal], and
    "\\x00s" escaping of NUL-prefixed user strings (so user data can never
    forge a marker — prefix escaping keeps the normalization injective).

    The returned pinned set is EXACTLY the ints the fingerprint pins
    byte-for-byte — the sound ``Roles.allowed`` constant set for template
    capture (an int the fingerprint normalized away varies per command and
    must never be baked into a template as a constant)."""
    from zeebe_tpu_torch.protocol.msgpack import py_packb

    pinned: set[int] = set()

    def scan(obj, field=None):
        t = type(obj)
        if t is int:
            if obj >= _ROLE_VALUE_MIN:
                if obj not in roles and field is None:
                    pinned.add(obj)
            elif obj <= -_ROLE_VALUE_MIN:
                # large negatives are never roles and never extracted —
                # norm() emits them unchanged at every position, so they are
                # fingerprint-pinned and sound template constants
                pinned.add(obj)
        elif t is dict:
            for k, v in obj.items():
                scan(k)
                scan(v, k if type(k) is str and k in fp_fields else None)
        elif t is list or t is tuple:
            for v in obj:
                scan(v)

    scan(docs)

    fp_values: list[int] = []
    fp_ordinal: dict[int, int] = {}

    def norm(obj, field=None):
        # exact-type dispatch; bool/float/None fall through unchanged
        t = type(obj)
        if t is int:
            if obj >= _ROLE_VALUE_MIN:
                r = roles.get(obj)
                if r is not None:
                    # tuple, not list: markers must stay hashable so a
                    # role-valued int used as a dict KEY normalizes instead
                    # of crashing (packs to the same msgpack array bytes)
                    return ("\x00r", r)
                if field is not None and obj not in pinned:
                    i = fp_ordinal.get(obj)
                    if i is None:
                        i = len(fp_values)
                        fp_ordinal[obj] = i
                        fp_values.append(obj)
                    return ("\x00f", i)
            return obj
        if t is str:
            return ("\x00s" + obj) if obj.startswith("\x00") else obj
        if t is dict:
            return {
                norm(k): norm(v, k if type(k) is str and k in fp_fields else None)
                for k, v in obj.items()
            }
        if t is list or t is tuple:
            return [norm(v) for v in obj]
        return obj

    return py_packb(norm(docs)), fp_values, pinned


from zeebe_tpu_torch.native import codec_fn as _codec_fn

_native_pack_fingerprint = _codec_fn("pack_fingerprint")

# admission cap on a device MI body's cardinality: bigger collections take
# the sequential path (also far below the PI-batch chunking threshold, so
# the chunked-activation shape never reaches the device)
_MI_MAX_CARD = 16

# token phases (mirrors zeebe_tpu_torch.ops.automaton)
_PHASE_AT = 0
_PHASE_WAIT = 1
_PHASE_DONE = 2

# below this, ints are never treated as keys by value (burst_templates)
_ROLE_VALUE_MIN = 1 << 32
_MISSING = object()

_CANDIDATE_COMMANDS = {
    (ValueType.PROCESS_INSTANCE_CREATION, int(ProcessInstanceCreationIntent.CREATE)),
    (ValueType.JOB, int(JobIntent.COMPLETE)),
    (ValueType.TIMER, int(TimerIntent.TRIGGER)),
    (ValueType.PROCESS_MESSAGE_SUBSCRIPTION, int(ProcessMessageSubscriptionIntent.CORRELATE)),
}
# end of the copy


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

    @property
    def info(self) -> SimpleNamespace:
        """The definition's row as the backend's group build reads an
        admitted instance's (``info.index``)."""
        return SimpleNamespace(index=self.definition)


def deploy(resources: list[str | bytes], max_fanout: int | None = None) -> ProcessTables:
    """BPMN XML resources → one shared table set (every process of every
    resource, in order)."""
    processes = [transform(model) for xml in resources for model in parse_bpmn_xml(xml)]
    return compile_tables(processes, max_fanout=max_fanout)


def _tables_view(tables: ProcessTables, max_group: int = MAX_GROUP) -> SimpleNamespace:
    """What the backend's group build and route trace read of the backend:
    its table set, its group bound and its bucket rounding."""
    return SimpleNamespace(registry=SimpleNamespace(tables=tables), max_group=max_group,
                           _pow2=KernelBackend._pow2)


def build_group_arrays(tables: ProcessTables, insts: list[GroupInstance],
                       max_group: int = MAX_GROUP):
    """Host (numpy) arrays for one group, padded to the shape bucket:
    (arrays, I, T), or None when the geometry exceeds the event-packing
    bounds. Sets each token's ``slot``; a new instance gets one token at
    its start event. The backend's own ``_build_group_arrays``."""
    return KernelBackend._build_group_arrays(_tables_view(tables, max_group),
                                             [SimpleNamespace(inst=i) for i in insts])


def group_state(arrays: dict, device=None) -> dict:
    """The group's initial kernel state on ``device``: the host-filled arrays
    plus zero incident flags and counters. The arrays are copied, never
    shared, so they still hold the group's start after it ran."""
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
class _DeviceRun:
    """One bare group's device run (``run_group``): what the fault seam
    reads and writes of the backend's ``_PendingGroup``, plus the chunking
    and the oracle's start."""

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
    # shadow groups keep host copies of the initial state (the oracle's
    # start) and of every fetched chunk's rows; corrupt_tokens are chaos-
    # ledger sequences the seam must report caught (shadow or containment)
    shadow: bool = False
    canary: bool = False
    initial: dict | None = None
    raw_rows: list = field(default_factory=list)
    corrupt_tokens: list = field(default_factory=list)
    t_shadow: float = 0.0


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
    pg = _DeviceRun(dt, config, I, T, chunk_steps, max_steps, pipeline_chunks)
    if defense is not None:
        return defense.run(pg, state, collect)
    first = _dispatch(dt, state, chunk_steps, config, collect)
    return _complete_device_run(pg, first, collect, lambda chunk, k: fetch_rows(chunk),
                                chunk_steps, max_steps)


def _complete_device_run(pg, cur: _Chunk, collect, fetch, chunk_steps: int,
                         max_steps: int) -> GroupRun:
    """The chunk loop behind the first dispatched chunk ``cur``; ``fetch``
    (chunk, index) brings a chunk's rows to the host. ``pg`` (a
    ``_DeviceRun`` or the backend's ``_PendingGroup``) gives the tables,
    the geometry and whether to prefetch; the loop sets its ``chunks_run``
    and, when the group does not quiesce or overflows its token pool, its
    ``fail_reason``."""
    chunk = chunk_steps
    T, I = pg.T, pg.I
    FO = pg.dt.out_target.shape[2]
    steps: list[dict] = []
    overflow = False
    state = cur.state
    nxt = None
    max_chunks = max(1, max_steps // chunk)
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
        logger.warning("kernel group did not quiesce in %d steps", max_steps)
        return GroupRun(None, state, pg.chunks_run, pg.fail_reason)
    if overflow:
        pg.fail_reason = "token-overflow"
        logger.warning("kernel token pool overflow (T=%d)", T)
        return GroupRun(None, state, pg.chunks_run, pg.fail_reason)
    return GroupRun(steps, state, pg.chunks_run)


def _profiler_annotation(name: str):
    """``torch.profiler.record_function`` around one kernel-chunk dispatch
    while the tracer is enabled: a ``torch.profiler`` capture then names the
    chunk boundaries. A null context when tracing is off, so the dispatch
    path pays one attribute read."""
    from zeebe_tpu_torch.observability.tracer import get_tracer

    if not get_tracer().enabled:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


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


#: the last probe of a SUSPECT card the router sends host-ward, in the
#: ladder's milliseconds, by ladder (one ladder a process, shared by its
#: partitions)
_SUSPECT_PROBES: dict[int, float] = {}
_SUSPECT_PROBES_LOCK = threading.Lock()


def _suspect_probe_due(health) -> bool:
    """Whether the next group the router sends to the host probes the card
    instead: while the ladder is SUSPECT, one group per canary interval
    across the partitions sharing the ladder, the first an interval after
    the fault that latched SUSPECT.

    The reference's host-routed groups run its program on the host through
    the device-fault seam, so its ladder goes on hearing of faults while the
    routing controller biases a SUSPECT device host-ward. The port declines
    a host-routed group to the sequential engine before the seam; without
    these probes a SUSPECT card would see no group, could neither escalate
    to QUARANTINED (and so never reach the canaries that re-prove it) nor
    show a fault-free group, and would stay SUSPECT for as long as its
    quiet window."""
    if health.state != SUSPECT:
        return False
    now = health.now_ms()
    transitions = health.transitions
    latched = transitions[-1]["atMs"] if transitions else 0.0
    with _SUSPECT_PROBES_LOCK:
        last = max(_SUSPECT_PROBES.get(id(health), 0.0), latched)
        if now - last < health.cfg.canary_interval_ms:
            return False
        _SUSPECT_PROBES[id(health)] = now
        return True


#: runtime errors that are no device fault: the seam lets them propagate
_NOT_DEVICE_FAULTS = (kernels.KernelBuildError, NotImplementedError, RecursionError)


class DeviceDefense:
    """The device-fault seam of one partition: the shared health ladder, the
    shadow sampling sequence (seeded by the partition id), and the counts of
    shadow-quarantined and declined groups and of the oracle's seconds.
    ``KernelBackend`` is one; ``run_group(..., defense=...)`` runs a bare
    group through one.

    Its members take the group as the reference's backend does (``pg``:
    the backend's ``_PendingGroup``, or ``run_group``'s ``_DeviceRun``) and
    keep the reference's semantics. A device failure at dispatch or fetch
    (a runtime error, or a watchdog wedge) is contained as a typed failure
    (``device-dispatch-error``, ``device-wedged``) noted on the ladder, and
    the caller declines the group: the backend's head command then runs on
    the sequential engine. A kernel library that does not build and an
    argument error are program faults and propagate.
    A shadow mismatch quarantines the device's rows: the host oracle's
    steps come back in their place and the ladder latches SUSPECT.

    A wedge abandons the group's chunks: the one in flight and a prefetched
    one are never fetched, and their references are dropped. The pooled
    watchdog thread finishes its stale wait and re-idles; the device runs
    the abandoned chunks to their end in stream order, ahead of any later
    group's work."""

    def __init__(self, partition_id: int = 0, health=None) -> None:
        self.health = health if health is not None else shared_device_health()
        self._shadow_seq = 0
        self.partition = partition_id
        #: groups whose device result a shadow mismatch quarantined (the
        #: host oracle's result returned instead)
        self.shadow_quarantined = 0
        #: groups declined (containment or a typed device-run decline)
        self.fallbacks = 0
        #: wall seconds spent in the shadow oracle
        self.shadow_seconds = 0.0
        self._host_tables_of: tuple | None = None
        #: the last oracle run's final state (CPU tensors)
        self._oracle_state: dict | None = None

    @property
    def shadow_sample_rate(self) -> float:
        return self.health.cfg.shadow_sample_rate

    @property
    def dispatch_timeout_ms(self) -> int:
        return self.health.cfg.dispatch_timeout_ms

    def run(self, pg: _DeviceRun, state: dict, collect) -> GroupRun:
        """``run_group`` through the seam: dispatch, chunk loop and sampled
        shadow check. A failed group is declined (its fetched rows
        discarded); a finished one is noted clean on the ladder, with the
        oracle's steps and final state if the shadow quarantined the
        device's."""
        # shadow sampling decided BEFORE dispatch: only sampled groups pay
        # the host copies of the initial state and of the fetched rows
        pg.shadow = self._shadow_sampled()
        if pg.shadow:
            pg.initial = {k: v.to("cpu", copy=True) for k, v in state.items()}
        first = self._begin_dispatch(
            pg, lambda: _dispatch(pg.dt, state, pg.chunk_steps, pg.config, collect))
        if pg.failed:
            return self._decline(pg, state)
        run = self._contained(pg, "fetch", lambda: _complete_device_run(
            pg, first, collect, lambda chunk, k: self._fetch_rows(pg, chunk, k),
            pg.chunk_steps, pg.max_steps))
        if run is None:
            return self._decline(pg, state)
        if run.steps is None:
            return self._decline(pg, run.state)
        steps, end = run.steps, run.state
        if pg.shadow:
            steps = self._verify_steps(pg, steps)
            if steps is None:
                return self._decline(pg, state)
            if steps is not run.steps:
                end = {k: v.to(state[k].device) for k, v in self._oracle_state.items()}
        self.health.note_group_ok()
        return GroupRun(steps, end, run.chunks_run)

    def _decline(self, pg: _DeviceRun, state: dict) -> GroupRun:
        """A declined group: counted, and any chaos corruption it carried
        reported caught by containment (its rows are discarded)."""
        self.fallbacks += 1
        chaos = _DEVICE_CHAOS
        if chaos is not None and pg.corrupt_tokens:
            for token in pg.corrupt_tokens:
                chaos.note_caught(token, "contained")
            pg.corrupt_tokens = []
        return GroupRun(None, state, pg.chunks_run, pg.fail_reason)

    def _contained(self, pg, where: str, fn):
        """``fn()``, a device failure inside it contained (None). A device
        failure is a runtime error: a CUDA or launch error, a watchdog
        wedge, an injected chaos fault. A kernel library that does not
        build, and an argument error (a program fault), propagate."""
        try:
            return fn()
        except RuntimeError as exc:
            if isinstance(exc, _NOT_DEVICE_FAULTS):
                raise
            self._contain_device_failure(pg, exc, where=where)
            return None

    def _begin_dispatch(self, pg, dispatch):
        """The seam's dispatch half: the chaos plane's dispatch fault, then
        ``dispatch()``, contained (``pg.failed`` tells)."""
        def guarded():
            chaos = _DEVICE_CHAOS
            if chaos is not None:
                chaos.dispatch_fault()
            return dispatch()

        return self._contained(pg, "dispatch", guarded)

    def _fetch_rows(self, pg, chunk: _Chunk, chunk_index: int) -> np.ndarray:
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

    def _contain_device_failure(self, pg, exc, where: str) -> None:
        """Containment: a dispatch exception or a watchdog-expired stall
        abandons the group with a TYPED reason, the health ladder hears
        about it, and any chaos-injected corruption riding the group is
        reported caught (its rows are discarded)."""
        kind = ("device-wedged" if isinstance(exc, DeviceWedgedError)
                else "device-dispatch-error")
        pg.failed = True
        pg.fail_reason = kind
        chaos = _DEVICE_CHAOS
        if chaos is not None and pg.corrupt_tokens:
            for token in pg.corrupt_tokens:
                chaos.note_caught(token, "contained")
            pg.corrupt_tokens = []
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

    def _oracle_start(self, pg: _DeviceRun) -> dict:
        """The group's initial state on the CPU: the oracle's start."""
        return pg.initial

    def _oracle_chunking(self, pg: _DeviceRun) -> tuple[int, int]:
        """(chunk_steps, max_steps) of the group's device run."""
        return pg.chunk_steps, pg.max_steps

    def _shadow_execute(self, pg):
        """Re-execute the group on the CPU with the plain ``run_collect``
        from its initial state, through the same chunk loop and chunking
        but without the chaos and watchdog seam (the oracle must not be
        faultable). Returns (steps, rows per chunk); raises when the oracle
        itself does not finish the group."""
        dt = self._host_tables(pg.dt)
        chunk_steps, max_steps = self._oracle_chunking(pg)
        oracle = _DeviceRun(dt, pg.config, pg.I, pg.T, chunk_steps, max_steps,
                            pipeline_chunks=False)
        rows: list[np.ndarray] = []

        def fetch(chunk: _Chunk, k: int) -> np.ndarray:
            rows.append(fetch_rows(chunk))
            return rows[-1]

        with _profiler_annotation("zeebe.kernel_chunk.shadow"):
            first = _dispatch(dt, self._oracle_start(pg), chunk_steps, pg.config, run_collect)
            run = _complete_device_run(oracle, first, run_collect, fetch, chunk_steps,
                                       max_steps)
        if run.fail_reason is not None:
            raise RuntimeError(f"shadow oracle failed: {run.fail_reason}")
        self._oracle_state = run.state
        return run.steps, rows

    def _verify_steps(self, pg, steps):
        """Sampled shadow verification: the device's fetched rows against the
        oracle's, byte for byte, before anything of the group is used. On
        mismatch the device result is quarantined: the oracle's steps are
        returned instead, and the ladder latches SUSPECT. Returns the steps
        to use (None: the oracle failed, abandon the group)."""
        health = self.health
        health.note_shadow_check()
        t0 = time.perf_counter()
        try:
            shadow_steps, shadow_rows = self._shadow_execute(pg)
        except Exception as exc:  # noqa: BLE001 — oracle failure: abandon
            # the group rather than use an unverified device result
            self._contain_device_failure(pg, exc, where="shadow")
            return None
        pg.t_shadow = time.perf_counter() - t0
        self.shadow_seconds += pg.t_shadow
        rows = pg.raw_rows
        match = (len(rows) == len(shadow_rows)
                 and all(np.array_equal(a, b) for a, b in zip(rows, shadow_rows)))
        if match:
            if pg.canary:
                health.note_canary(True)
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
        if pg.canary:
            health.note_canary(False, detail="shadow mismatch")
        logger.warning("shadow verification MISMATCH (I=%d T=%d): device result "
                       "quarantined, host oracle result used", pg.I, pg.T)
        return shadow_steps


def cascade_ops(tables: ProcessTables, inst: GroupInstance, steps: list[dict]) -> list:
    """Trace one instance's route through the device steps: the backend's
    own ``_cascade_ops`` (its docstring lists the ops), over a group built
    by ``build_group_arrays``."""
    view = SimpleNamespace(idx=inst.idx, tokens=inst.tokens, info=SimpleNamespace(
        index=inst.definition, exe=tables.definitions[inst.definition]))
    return KernelBackend._cascade_ops(_tables_view(tables), view, steps)


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


# ---------------------------------------------------------------------------
# the backend: admission, dispatch and materialization


# copied from the reference: _Token .. _Admitted
@dataclass
class _Token:
    slot: int
    elem_idx: int
    key: int  # element instance key (-1 until minted at materialization)
    value: dict  # the record value the ACTIVATE command carried
    phase: int = _PHASE_AT
    # follow-up index of this token's ACTIVATE command in the burst being
    # materialized (-1 = predates the burst); host-escape cascades appended
    # before it must drain before this token's processing emits (FIFO)
    act_idx: int = -1


@dataclass
class _Inst:
    idx: int  # row in the device batch
    info: _DefInfo
    new: bool  # created by this group (vs reconstructed)
    pi_key: int = -1
    meta: dict | None = None  # creation: resolved definition metadata
    tokens: list[_Token] = field(default_factory=list)
    join_counts: dict[int, int] = field(default_factory=dict)  # elem idx → arrivals
    slots: dict[str, float] = field(default_factory=dict)  # condition variables
    done_emitted: bool = False
    # every process-instance key this device instance spans (self + call-
    # activity child frames + ancestors); the group conflict set must cover
    # them all so one family never resumes twice in one group
    family_pis: list[int] = field(default_factory=list)
    # K_MI bodies: body row → children left to spawn on device (admission-
    # predicted cardinality for unspawned bodies; reconstruction remainder
    # for parked sequential bodies; 0 for fully-spawned parallel bodies)
    mi_left: dict = field(default_factory=dict)
    # predicted cardinality per body row (the decoder's spawn-count oracle
    # is the sequential delegation itself; this sizes the token pool)
    mi_cards: dict = field(default_factory=dict)


@dataclass
class _Admitted:
    cmd: Any  # LoggedRecord
    inst: _Inst
    resume_token: _Token | None = None  # job complete: the PHASE_DONE token
    kind: str = "c"  # "c" creation | "j" job complete
    # instance-scoped documents the head processors will read — the burst
    # template's context fingerprint is computed over these (role-normalized)
    # at ADMISSION time (the docs are guaranteed unmutated there; holding
    # references past admission would race the group's own state writes),
    # then released
    fp_docs: list | None = None
    # False → this command must not ride a burst template (e.g. it touches
    # engine.await_results, which lives outside the captured state store)
    templatable: bool = True
    # clock-derived document fields (dueDate/deadline) extracted by the
    # fingerprint walk, in canonical order — resolved per command for the
    # template's ("fp", i) roles
    fp_values: list | None = None
    # the role-normalized byte image (template cache key component) and the
    # exact set of large ints the fingerprint pinned (the sound
    # Roles.allowed set) — both computed at admission
    fp_bytes: bytes | None = None
    fp_pinned: set | None = None
    # minted keys of parked wait states (timer keys), in reconstruction
    # order — role ("wait", j); they appear in cancel/trigger bursts but not
    # in any admission doc, so they need their own role kind
    wait_keys: list | None = None
# end of the copy


# copied from the reference: _PendingGroup .. _PendingGroup
@dataclass
class _PendingGroup:
    """One admitted command group with its device run in flight — the
    double-buffered unit of the pipelined execution path (stream/processor
    .py process_available_batch): while this group's first chunk computes on
    the device, the processor runs the PREVIOUS group's deferred host work.
    Carries per-stage wall times for the stream_processor_pipeline_* stage
    histograms."""

    admitted: list
    failed: bool = False
    # typed catalog reason when the device run declines (geometry bounds,
    # non-quiescence, pool overflow, mesh errors) — finish_group feeds it
    # into the consolidated PathAccounting exactly once per failed group
    fail_reason: str | None = None
    # device chunks actually fetched (the kernel_wave flight event's
    # chunk-count field); mesh groups report 0 (the runner owns chunking)
    chunks_run: int = 0
    mesh: bool = False
    arrays: dict | None = None
    I: int = 0
    T: int = 0
    tables: Any = None
    config: Any = None
    dt: Any = None
    dev: Any = None
    bucket: Any = None
    run: Any = None  # (carry state, packed events) of the in-flight chunk
    # chunk k+1 prefetch is a win only on a REAL accelerator (device compute
    # overlaps host decode for free); on a host XLA backend the prefetched
    # chunk's threads compete with the decoding host thread for the same
    # cores (measured: ten_tasks regression on a 2-vCPU box)
    pipeline_chunks: bool = False
    # device-fault defense: shadow=True keeps the fetched result
    # rows for byte-for-byte comparison against the host oracle before the
    # group transaction commits; canary marks a quarantine re-proving
    # dispatch (forced shadow); corrupt_tokens are chaos-ledger sequences
    # the backend must report caught (shadow or containment)
    shadow: bool = False
    canary: bool = False
    raw_rows: list = field(default_factory=list)
    corrupt_tokens: list = field(default_factory=list)
    # stage wall times (seconds), observed by the stream processor
    t_admit: float = 0.0
    device_elapsed: float = 0.0
    t_materialize: float = 0.0
    t_shadow: float = 0.0
# end of the copy


class KernelBackend(DeviceDefense):
    """Admits groups of commands, runs the automaton kernel, materializes the
    sequential-equivalent record stream. One instance per partition, its
    groups on one device: CUDA unless ``device`` says otherwise (``"cpu"``
    runs the plain PyTorch version). On the card the link-aware router
    (``router``, the process-wide one by default) pins canaries and counts
    groups; a group it sends to the host is declined to the sequential
    engine, never run on the CPU, but for the probes of a SUSPECT card
    (``_suspect_probe_due``), which run on the card. The device-fault seam is its base
    class; the members below the constructor that the reference has are
    copies but for the device members (``_start_kernel``,
    ``_await_kernel``, ``_group_state``, ``_dispatch_first_chunk``,
    ``_complete_device_run``)."""

    def __init__(self, engine, max_group: int = 256, max_steps: int = 4096,
                 chunk_steps: int = 8, use_templates: bool = True,
                 audit_templates: bool = False,
                 max_commands_in_batch: int = 100,
                 mesh_runner=None, router="shared", device=None) -> None:
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the kernel library is built and loaded here, so a card whose
            # kernels do not build fails the backend's construction rather
            # than declining every group to the host
            kernels.load()
        # the per-broker health ladder is shared across partitions (the
        # device is a process resource); the sampling stream is seeded by
        # the partition
        super().__init__(engine.state.partition_id, shared_device_health())
        self.engine = engine
        self.registry = KernelRegistry()
        self.max_group = max_group
        self.max_steps = max_steps
        self.chunk_steps = chunk_steps
        # link-aware backend routing (utils/device_link.py), "shared" = the
        # process-wide router. Every group runs on the backend's device. On
        # the card, where the router would send a group to the host (a link
        # slower than LOCAL_LINK_S, or the routing controller's host-ward
        # bias), the group is declined to the sequential engine
        # ("routed-host"): the reference runs its program on the host CPU
        # there, the port moves no card work to the plain version. The
        # router is fed counts, never times. A backend on the CPU has nothing
        # to route and never consults the card (the reference's router is
        # off where the host is the default backend).
        if router == "shared":
            router = shared_router() if self.device.type == "cuda" else None
        self.router = router
        # shared MeshKernelRunner (parallel/mesh_runner.py): when set, this
        # partition's groups run as shards of ONE mesh dispatch, coalescing
        # with other partitions' concurrently submitted groups
        self.mesh_runner = mesh_runner
        # must match the stream processor's batch budget: the host-escape
        # drain accounts commands exactly like the sequential batch loop
        self.max_commands_in_batch = max_commands_in_batch
        # burst templates (engine/burst_templates.py): replay a command's
        # whole record burst by patching a captured byte template. audit mode
        # (tests) shadows every template hit with the slow path and asserts
        # byte/state/response equality instead of serving the fast result.
        self.use_templates = use_templates
        self.audit_templates = audit_templates
        self._templates: dict = {}
        self._template_cache_limit = 1024
        # observability (``fallbacks`` and ``shadow_quarantined`` are the
        # seam's)
        self.groups_processed = 0
        self.commands_processed = 0
        # consolidated path accounting: one reason catalog and one counter
        # home for every kernel-vs-host routing decision; fallback_reasons
        # aliases its Counter (reason → count)
        self.accounting = PathAccounting(engine.state.partition_id)
        self.fallback_reasons = self.accounting.reasons
        from zeebe_tpu_torch.observability.tracer import get_tracer

        self._tracer = get_tracer()
        self._partition_id = engine.state.partition_id
        self.template_hits = 0
        self.template_misses = 0
        self.template_audits = 0
        self.template_audit_skips = 0
        # compile seam (observability/profiler.py): (bucket, device) pairs
        # whose first dispatch — the first launch, to its completion — was
        # already timed into the compile telemetry
        self._compiles_seen: set = set()

    # copied from the reference: is_candidate .. _definition_of
    def is_candidate(self, record) -> bool:
        return (record.value_type, int(record.intent)) in _CANDIDATE_COMMANDS

    def note_sequential_head(self, record) -> None:
        """The processor's batch scan found a non-candidate command at the
        HEAD of the pending log (a deployment, a message publish, …):
        ordinary sequential traffic, counted BY KIND so the bench fallback
        accounting separates it from kernel failures and from admission
        regressions: the bare "head-not-admittable" count hid
        what actually fell back — and end-of-log probes inflated it)."""
        self.fallbacks += 1
        self.accounting.note_host(
            f"head-sequential:{record.value_type.name}.{record.intent.name}",
            self._definition_of(record),
        )

    def _definition_of(self, record) -> str:
        """Best-effort bpmnProcessId attribution for a host-routed head
        command (the per-definition coverage split). Creations carry the id
        on the value; job completes resolve it through the job's state entry
        (we are inside the partition's open transaction on every caller
        path); everything else is unattributed ('-'). Attribution must never
        take routing down."""
        try:
            value = record.value
            definition = value.get("bpmnProcessId") if isinstance(value, dict) else None
            if definition:
                return definition
            if (record.value_type, int(record.intent)) == (
                    ValueType.JOB, int(JobIntent.COMPLETE)):
                job = self.engine.state.jobs.get(record.key)
                if job is not None and job.get("bpmnProcessId"):
                    return job["bpmnProcessId"]
        except Exception:  # noqa: BLE001 — attribution is best-effort
            pass
        return "-"
    # end of the copy

    # copied from the reference: _admit .. _build_group_arrays
    def _admit(self, cmd, instances: dict[int, _Inst],
               admitted_pis: set[int], wave: dict) -> _Admitted | None:
        record = cmd.record
        kind = (record.value_type, int(record.intent))
        if kind == (ValueType.PROCESS_INSTANCE_CREATION, int(ProcessInstanceCreationIntent.CREATE)):
            adm = self._admit_creation(cmd, instances, wave)
        elif kind == (ValueType.JOB, int(JobIntent.COMPLETE)):
            adm = self._admit_job_complete(cmd, instances, admitted_pis, wave)
        elif kind == (ValueType.TIMER, int(TimerIntent.TRIGGER)):
            adm = self._admit_timer_trigger(cmd, instances, admitted_pis, wave)
        elif kind == (ValueType.PROCESS_MESSAGE_SUBSCRIPTION,
                      int(ProcessMessageSubscriptionIntent.CORRELATE)):
            adm = self._admit_message_correlate(cmd, instances, admitted_pis,
                                                wave)
        else:
            return None
        if adm is not None and self.use_templates and adm.templatable:
            # fingerprint NOW, over the live documents: nothing has mutated
            # them yet (materialization of earlier group members runs later
            # and only touches other instances), and doing it here lets the
            # admission docs be referenced instead of defensively copied
            adm.fp_bytes, adm.fp_values, adm.fp_pinned = self._fingerprint(adm)
            adm.fp_docs = None
        return adm

    # wave-context sentinel: distinguishes a memoized None from a cache miss
    _WAVE_MISS = object()

    def _wave_def_info(self, wave: dict, def_key: int) -> "_DefInfo | None":
        """Per-wave memo of registry lookup + segment freshness — the
        vectorized admission prevalidation: a wave of commands
        against one definition pays the eligibility lookup and the inlined-
        segment staleness probe once, not once per head. None is memoized
        too (a stale-segment definition declines for the whole wave; the
        refresh `_segments_fresh` triggers readmits it next wave)."""
        hit = wave.get(def_key, self._WAVE_MISS)
        if hit is not self._WAVE_MISS:
            return hit
        state = self.engine.state
        info = self.registry.lookup(def_key, state.processes.executable(def_key),
                                    processes=state.processes)
        if info is not None and not self._segments_fresh(info):
            info = None
        wave[def_key] = info
        return info

    def _condition_slots_cached(self, wave: dict, info: "_DefInfo",
                                merged: dict) -> dict[str, tuple] | None:
        """``_condition_slots`` with a per-wave memo keyed by the condition
        variables' VALUES: instances that agree on every device-read
        variable (the common wave shape — identical creation variables, or
        resumes whose root scopes converged) share one slot-plane
        computation. Unhashable values fall through to the direct path."""
        names = self.registry.tables.cond_vars_by_def[info.index]
        if not names:
            return {}
        try:
            key = ("slots", info.index,
                   tuple(merged.get(n) for n in names))
            hit = wave.get(key, self._WAVE_MISS)
        except TypeError:
            return self._condition_slots(info, merged)
        if hit is not self._WAVE_MISS:
            return hit
        slots = self._condition_slots(info, merged)
        wave[key] = slots
        return slots

    def _admit_creation(self, cmd, instances, wave: dict) -> _Admitted | None:
        state = self.engine.state
        value = cmd.record.value
        if value.get("startInstructions"):
            return None
        if value.get("startElementId"):
            # message/timer-start creations activate an explicit start element
            # — the kernel's creation materializer always enters through the
            # none start, so these stay sequential
            return None
        from zeebe_tpu_torch.protocol import DEFAULT_TENANT

        if value.get("tenantId", DEFAULT_TENANT) != DEFAULT_TENANT:
            # non-default tenants ride the sequential path: the kernel's value
            # builders emit the default tenant's record shape
            return None
        bpmn_process_id = value.get("bpmnProcessId", "")
        definition_key = value.get("processDefinitionKey", -1)
        version = value.get("version", -1)
        if definition_key > 0:
            meta = state.processes.get_by_key(definition_key)
        elif version > 0:
            key = state.processes.get_key_by_id_version(bpmn_process_id, version)
            meta = None if key is None else state.processes.get_by_key(key)
        else:
            meta = wave.get(("latest", bpmn_process_id), self._WAVE_MISS)
            if meta is self._WAVE_MISS:
                meta = state.processes.get_latest_by_id(bpmn_process_id)
                wave[("latest", bpmn_process_id)] = meta
        if meta is None or meta.get("deleted"):
            return None  # sequential path writes the NOT_FOUND rejection
        def_key = meta["processDefinitionKey"]
        info = self._wave_def_info(wave, def_key)
        if info is None:
            return None
        variables = value.get("variables") or {}
        slots = self._condition_slots_cached(wave, info, variables)
        if slots is None:
            # a condition could read a variable whose runtime type the device
            # slot kind cannot represent: host and device would disagree
            return None
        if info.root_esp_start_idxs and not self._esp_exprs_admit(
                info, variables):
            return None  # sequential path raises the proper incident
        mi_cards: dict[int, int] = {}
        if info.mi_inner:
            needed = info.mi_reach.get(-1, ())
            if needed:
                cards = self._predict_mi_cards(info, needed, variables)
                if cards is None:
                    return None
                mi_cards = cards
        inst = _Inst(idx=len(instances), info=info, new=True, meta=meta,
                     slots=slots, mi_left=dict(mi_cards), mi_cards=mi_cards)
        templatable = not (value.get("awaitResult") and cmd.record.request_id >= 0)
        return _Admitted(cmd=cmd, inst=inst, kind="c",
                         fp_docs=[value, meta], templatable=templatable)

    def _predict_mi_cards(self, info: _DefInfo, needed,
                          merged: dict) -> dict[int, int] | None:
        """Cardinality of each needed K_MI body's input collection, evaluated
        over the admission-time variable view. Eligibility guarantees no
        other writer can change the collection before the body activates
        mid-burst, so this equals what the sequential delegation will read.
        None = a needed collection is missing/invalid/empty/too large — the
        command declines to the sequential path (which raises the proper
        incident or runs the large fan-out chunked)."""
        cards: dict[int, int] = {}
        for row in needed:
            mi = info.exe.elements[row].multi_instance
            try:
                items = mi.input_collection.evaluate(merged, lambda: 0)
            except Exception:  # noqa: BLE001 — any eval failure → sequential
                return None
            if not isinstance(items, list):
                return None
            if not items or len(items) > _MI_MAX_CARD:
                # empty bodies complete during activation (a different burst
                # shape than park-and-drain); big fan-outs ride chunking
                return None
            cards[row] = len(items)
        return cards

    def _segments_fresh(self, info: _DefInfo) -> bool:
        """Inlined call segments bind the latest called version at compile
        time; activation resolves latest at ACTIVATION time (reference:
        CallActivityProcessor) — a newer deploy of a called id makes the
        inlining stale, so such commands take the sequential path until the
        registry recompiles."""
        if not info.segments:
            return True
        processes = self.engine.state.processes
        for seg in info.segments:
            meta = processes.get_latest_by_id(seg.child_process_id)
            if meta is None or meta["processDefinitionKey"] != seg.child_def_key:
                # re-inline against the new latest so FUTURE commands ride
                # the kernel again; the current command still declines (its
                # caller already resolved the stale info)
                self.registry.refresh_segments(
                    info.key, self.engine.state.processes.executable(info.key),
                    processes)
                return False
        return True

    def _reconstruct(self, pi_key: int, info: _DefInfo, resume_key: int,
                     root=None):
        """Rebuild a running instance's device tokens from element-instance
        state. Every live element instance must be parked in a kernel wait
        state (task on a job, catch on a timer/subscription, or a sub-process
        scope whose descendants are parked) — anything else (mid-transition,
        incident, scope drain in flight) is not reconstructable. Returns
        (tokens, resume_token, root, wait_docs, scope_keys, join_counts) or
        None; wait_docs are the parked wait-state records (for the template
        fingerprint), scope_keys maps scope element idx → instance key
        (0 → the process instance), join_counts maps join gateway element
        idx → unconsumed arrivals."""
        state = self.engine.state
        if root is None:
            root = state.element_instances.get(pi_key)
        from zeebe_tpu_torch.engine.engine_state import EI_ACTIVATED

        if root is None or root["state"] != EI_ACTIVATED:
            return None
        exe = info.exe
        tokens: list[_Token] = []
        resume: _Token | None = None
        wait_docs: list = []
        wait_keys: list[int] = []
        if not self._esp_waits_ok(info.root_esp_waits, pi_key, wait_docs,
                                  wait_keys):
            return None
        family: list[int] = []  # call-child process instance keys
        mi_parked: dict[int, int | None] = {}  # K_MI body row → live inner lc
        # elem idx of a scope (0 = process root) → its instance key: join
        # counters and sub-process drain checks key off the scope instance
        scope_keys: dict[int, int] = {0: pi_key}
        # depth-first walk of the element-instance tree: K_SCOPE children are
        # parked tokens whose own children are walked recursively. Entries
        # carry the call segment whose inlined region the instance lives in
        # (None = the caller's own rows); ids resolve through the segment's
        # child executable, offset into synthetic rows.
        pending_walk = [
            (k, None) for k in sorted(state.element_instances.children_keys(pi_key))
        ]
        for child_key, seg in pending_walk:
            child = state.element_instances.get(child_key)
            if child is None or child["state"] != EI_ACTIVATED:
                return None
            elem_id = child["value"].get("elementId", "")
            id_map = exe.by_id if seg is None else seg.child_exe.by_id
            if elem_id not in id_map:
                return None
            row = id_map[elem_id] + (0 if seg is None else seg.offset)
            el = exe.elements[row]
            if (el.multi_instance is not None and el.child_start_idx >= 0
                    and child["value"].get("bpmnElementType")
                    != BpmnElementType.MULTI_INSTANCE_BODY.name):
                # an MI element id names BOTH the body and its inner
                # instances; the inner rides the synthetic inner row
                row = info.mi_inner[row]
                el = exe.elements[row]
            op = self.registry.tables.kernel_op[info.index, row]
            if op == K_MI:
                if child.get("miActivationIndex") is not None:
                    return None  # chunked fan-out: sequential path owns it
                lc = None
                for k in state.element_instances.children_keys(child_key):
                    inner = state.element_instances.get(k)
                    if inner is not None:
                        lc = max(lc or 0, inner["value"].get("loopCounter", 0))
                mi_parked[row] = lc  # None = no live inner (drain mid-flight)
                scope_keys[row] = child_key
                pending_walk.extend(
                    (k, seg)
                    for k in sorted(state.element_instances.children_keys(child_key))
                )
            elif op == K_SCOPE:
                call_seg = info.call_segment(row)
                if call_seg is not None:
                    # call activity frame: descend into the called child
                    # instance through the back-link; the child ROOT walks as
                    # the placeholder row (its elementId — the process id —
                    # maps to the segment's row 0)
                    child_pi = child.get("calledChildInstanceKey", -1)
                    child_root = state.element_instances.get(child_pi)
                    if child_root is None:
                        return None
                    if (child_root["value"].get("processDefinitionKey")
                            != call_seg.child_def_key):
                        return None  # instance bound an older called version
                    family.append(child_pi)
                    scope_keys[row] = child_key
                    pending_walk.append((child_pi, call_seg))
                else:
                    esp_expected = info.scope_esp_waits.get(row)
                    if esp_expected is not None and not self._esp_waits_ok(
                            esp_expected, child_key, wait_docs, wait_keys):
                        return None  # an ESP trigger owns this call frame
                    scope_keys[row] = child_key
                    pending_walk.extend(
                        (k, seg)
                        for k in sorted(state.element_instances.children_keys(child_key))
                    )
            elif op == K_TASK:
                if child.get("jobKey", -1) < 0:
                    return None
                # boundary subscriptions must be intact: a missing timer/sub
                # means a trigger is mid-flight (its internal TERMINATE/
                # ACTIVATE commands own this instance now) — decline so the
                # sequential path resolves the race
                if not self._collect_wait_states(info, el.idx, child_key,
                                                 wait_docs, wait_keys):
                    return None
            elif op == K_CATCH:
                if el.element_type == BpmnElementType.EVENT_BASED_GATEWAY:
                    # every succeeding catch must have its wait state open on
                    # the gateway instance; anything less means a trigger is
                    # mid-flight (its COMPLETE_ELEMENT owns this instance)
                    if not self._collect_wait_states(info, el.idx, child_key,
                                                     wait_docs, wait_keys):
                        return None
                elif el.timer_duration is not None:
                    timers = state.timers.timers_for_element_instance(child_key)
                    if not timers:
                        return None  # incident-parked or already fired
                    wait_docs.extend(t for _k, t in timers)
                    wait_keys.extend(k for k, _t in timers)
                elif el.signal_name is not None:
                    subs = state.signal_subscriptions.subscriptions_of(child_key)
                    if not subs:
                        return None  # broadcast mid-flight owns the instance
                    wait_docs.extend(subs)
                else:
                    sub = state.process_message_subscriptions.get(
                        child_key, el.message_name
                    )
                    if sub is None:
                        return None
                    wait_docs.append(sub)
            else:
                return None
            tok = _Token(slot=-1, elem_idx=el.idx, key=child_key,
                         value=dict(child["value"]), phase=_PHASE_WAIT)
            if child_key == resume_key:
                tok.phase = _PHASE_DONE
                resume = tok
            tokens.append(tok)
        if resume is None:
            return None
        join_counts = self._join_counts(info, scope_keys)
        # drain integrity: a scope instance with no parked descendant token
        # and no pending join arrival inside has its COMPLETE_ELEMENT command
        # in flight — the device would re-complete it (duplicate records), so
        # the sequential path must finish that window
        for scope_idx in scope_keys:
            if scope_idx == 0:
                continue
            if any(self._inside(exe, t.elem_idx, scope_idx) for t in tokens):
                continue
            if any(join_counts.get(j) and self._inside(exe, j, scope_idx)
                   for j in info.join_idxs):
                continue
            return None
        return (tokens, resume, root, wait_docs, wait_keys, scope_keys,
                join_counts, family, mi_parked)

    def _esp_exprs_admit(self, info: _DefInfo, variables: dict) -> bool:
        """Pre-validate root event-sub-process start expressions over the
        creation variables (the same values _open_scope_event_subscriptions
        will read from the seeded root scope) — THE SAME shared helper the
        sequential open uses, so admission and emission cannot diverge; an
        eval failure takes the sequential path for the engine's own
        incident shape."""
        return self.engine.bpmn.prevalidate_scope_event_subscriptions(
            info.root_esp_start_idxs, info.exe, variables) is None

    def _esp_waits_ok(self, expected: tuple, instance_key: int,
                      wait_docs: list, wait_keys: list) -> bool:
        """A scope's ESP start subscriptions must ALL be open on its
        instance — anything less means a trigger owns the instance right now
        (mirror of _collect_wait_states for scope instances). Applies to
        the process root (root_esp_waits) and to inlined call frames' child
        roots (scope_esp_waits)."""
        expected_timers, expected_subs, expected_signals = expected
        if not (expected_timers or expected_subs or expected_signals):
            return True
        state = self.engine.state
        timers = state.timers.timers_for_element_instance(instance_key)
        subs = state.process_message_subscriptions.subscriptions_of(instance_key)
        signals = state.signal_subscriptions.subscriptions_of(instance_key)
        if (len(timers) != expected_timers or len(subs) != expected_subs
                or len(signals) != expected_signals):
            return False
        wait_docs.extend(t for _k, t in timers)
        wait_keys.extend(k for k, _t in timers)
        wait_docs.extend(subs)
        wait_docs.extend(signals)
        return True

    def _collect_wait_states(self, info: _DefInfo, el_idx: int, child_key: int,
                             wait_docs: list, wait_keys: list) -> bool:
        """Verify the expected wait states (boundary subscriptions of a task,
        or an event-based gateway's per-target subscriptions) are all open on
        ``child_key``, appending their records to ``wait_docs`` and the
        timers' minted keys to ``wait_keys``. False means a trigger is
        mid-flight and the instance is not reconstructable."""
        expected_timers, expected_subs, expected_signals = (
            info.boundary_waits.get(el_idx, (0, 0, 0)))
        if not (expected_timers or expected_subs or expected_signals):
            return True
        state = self.engine.state
        timers = state.timers.timers_for_element_instance(child_key)
        subs = state.process_message_subscriptions.subscriptions_of(child_key)
        signals = state.signal_subscriptions.subscriptions_of(child_key)
        if (len(timers) != expected_timers or len(subs) != expected_subs
                or len(signals) != expected_signals):
            return False
        wait_docs.extend(t for _k, t in timers)
        wait_keys.extend(k for k, _t in timers)
        wait_docs.extend(subs)
        wait_docs.extend(signals)
        return True

    @staticmethod
    def _inside(exe: ExecutableProcess, elem_idx: int, scope_idx: int) -> bool:
        """True when elem_idx lies strictly inside scope_idx's scope chain."""
        anc = exe.elements[elem_idx].parent_idx
        while anc > 0:
            if anc == scope_idx:
                return True
            anc = exe.elements[anc].parent_idx
        return False

    def _join_counts(self, info: _DefInfo, scope_keys: dict[int, int]) -> dict[int, int]:
        state = self.engine.state
        exe = info.exe
        join_counts: dict[int, int] = {}
        for jidx in info.join_idxs:
            # NUMBER_OF_TAKEN_SEQUENCE_FLOWS counters key off the gateway's
            # flow-scope INSTANCE (process root or sub-process instance)
            scope_key = scope_keys.get(exe.elements[jidx].parent_idx)
            if scope_key is None:
                continue  # scope not instantiated → no arrivals
            # the state's counters were written by the sequential appliers,
            # which resolve elements/flows through the CHILD executable for
            # call-frame records — translate inlined synthetic rows back to
            # the segment-local index space before reading
            seg = info.segment_of_row(jidx)
            d_elem = 0 if seg is None else seg.offset
            d_flow = 0 if seg is None else seg.flow_offset
            total = sum(
                state.element_instances.taken_flow_count(
                    scope_key, jidx - d_elem, f.idx - d_flow)
                for f in exe.flows
                if f.target_idx == jidx
            )
            if total:
                join_counts[jidx] = total
        return join_counts

    def _condition_slots(self, info: _DefInfo, merged: dict) -> dict[str, tuple] | None:
        """Prefetch the condition variables into device-slot key planes:
        numeric slots carry the float64 order key, string slots the interned
        id (the host document store ↔ device slot split, SURVEY §7(c)).
        None = this instance cannot ride the kernel (type mismatch or
        order-unsafe unknown string would diverge from host FEEL)."""
        from zeebe_tpu_torch.ops.tables import f64_key_planes

        tables = self.registry.tables
        slots: dict[str, tuple] = {}
        # variables read by THIS definition's device-compiled conditions in
        # the SHARED lowering (a shared-set SlotMap clash may have downgraded
        # a gateway to K_HOST — its variables then need no prefetch and must
        # not gate admission)
        for name in tables.cond_vars_by_def[info.index]:
            v = merged.get(name)
            if tables.slot_map.kinds.get(name) == "str":
                if not isinstance(v, str):
                    return None
                key_hi, _known = tables.interner.order_key_of(v)
                # unknown strings get odd insertion-rank keys — exact
                # against every literal, and device programs never compare
                # two string slots (compile_condition types "str" only
                # opposite a literal), so collisions between two unknown
                # keys are unreachable
                slots[name] = (key_hi, 0)
                continue
            if not _is_numeric(v):
                return None
            if type(v) is int and not _f64_exact(v):
                # host FEEL compares Python ints exactly; an int beyond 2^53
                # would round into its float64 neighbor's order key and the
                # device could diverge (e.g. EQ against the neighbor)
                return None
            value = float(v)
            if value != value:  # NaN has no order key
                return None
            slots[name] = f64_key_planes(value)
        return slots

    def _admit_resume(self, cmd, instances, admitted_pis: set[int],
                      pi_key: int, resume_key: int,
                      kind: str, head_docs: list, extra_variables: dict | None,
                      require_op: int, wave: dict) -> _Admitted | None:
        """Shared admission for resume commands (job complete, timer trigger,
        message correlate). A command whose instance is a call-activity child
        first tries the TOP ancestor instance — when the caller's definition
        inlines the child, the resume reconstructs the WHOLE family as one
        device instance and the call return executes on the device; otherwise
        it falls back to the child-frame instance (the child's own tables,
        with a sequential continuation into the parent)."""
        state = self.engine.state
        root_meta = state.element_instances.get(pi_key)
        if root_meta is None:
            return None
        top_pi, top_meta, ancestors = pi_key, root_meta, []
        for _ in range(_INLINE_MAX_DEPTH + 1):
            ppi = top_meta["value"].get("parentProcessInstanceKey", -1)
            if ppi < 0:
                break
            m = state.element_instances.get(ppi)
            if m is None:
                break
            top_pi, top_meta = ppi, m
            ancestors.append(ppi)
        if top_pi != pi_key:
            adm = self._admit_resume_at(
                cmd, instances, admitted_pis, top_pi, top_meta, resume_key,
                kind, head_docs, extra_variables, require_op, wave,
                require_segments=True)
            if adm is not None:
                return adm
        return self._admit_resume_at(
            cmd, instances, admitted_pis, pi_key, root_meta, resume_key,
            kind, head_docs, extra_variables, require_op, wave,
            extra_family=ancestors)

    def _admit_resume_at(self, cmd, instances, admitted_pis: set[int],
                         pi_key: int, root_meta, resume_key: int,
                         kind: str, head_docs: list,
                         extra_variables: dict | None, require_op: int,
                         wave: dict,
                         require_segments: bool = False,
                         extra_family: list | None = None,
                         ) -> _Admitted | None:
        state = self.engine.state
        if pi_key in admitted_pis:
            return None  # same-instance conflict: next group
        if "tenantId" in root_meta["value"]:
            # non-default-tenant instances stay on the sequential path end to
            # end (the kernel's value builders emit default-tenant shapes)
            return None
        def_key = root_meta["value"].get("processDefinitionKey", -1)
        info = self._wave_def_info(wave, def_key)
        if info is None:
            return None
        if require_segments and not info.segments:
            # the hop to the top ancestor only pays off when the caller
            # inlines its call activities — otherwise the call element is a
            # host escape and reconstruction would decline at it anyway
            return None
        rebuilt = self._reconstruct(pi_key, info, resume_key, root_meta)
        if rebuilt is None:
            return None
        (tokens, resume, root, wait_docs, wait_keys, scope_keys,
         join_counts, family, mi_parked) = rebuilt
        family = [pi_key, *family, *(extra_family or ())]
        if any(p in admitted_pis for p in family):
            return None  # a family member is already resumed in this group
        resume_el = info.exe.elements[resume.elem_idx]
        has_cond_slots = bool(
            self.registry.tables.cond_vars_by_def[info.index])
        if extra_variables:
            if kind == "j" and resume_el.outputs:
                # the sequential job-complete merges ALL completion variables
                # into the element's LOCAL scope when the element has output
                # mappings (processors.py merge_local) — they die with the
                # element and must never reach the root condition slots
                extra_variables = None
            elif has_cond_slots:
                # default propagation: each variable lands on the nearest
                # scope that already holds it locally, else the root. A
                # mid-chain local (input-mapped element scope, or a
                # sub-process scope written by an inner output mapping)
                # would absorb the variable where the device's root-slot
                # prefetch cannot see it — decline those resumes. With no
                # device-compiled conditions (always the case for inlined
                # call definitions) there are no slots to invalidate.
                for name in extra_variables:
                    scope = state.variables.find_scope_with(resume_key, name)
                    if scope is not None and scope != pi_key:
                        return None
        if self.registry.tables.kernel_op[info.index, resume.elem_idx] != require_op:
            return None
        merged = state.variables.collect(pi_key)
        merged.update(extra_variables or {})
        slots = self._condition_slots_cached(wave, info, merged)
        if slots is None:
            return None
        mi_left: dict[int, int] = {}
        mi_cards: dict[int, int] = {}
        if info.mi_inner:
            tables = self.registry.tables
            seq_rows = {
                row for row in info.mi_inner
                if tables.mi_sequential[info.index, row]
            }
            # cards are needed for burst-reachable unspawned bodies AND for
            # parked sequential bodies (the respawn remainder); parallel
            # parked bodies are fully spawned (mi_left 0, no card needed)
            needed = set(info.mi_reach.get(resume.elem_idx, ()))
            needed |= {r for r in mi_parked if r in seq_rows}
            if needed:
                # a collection variable shadowed by ANY live scope/token
                # local would make the root-merged prediction diverge from
                # the sequential collect(body) — decline those
                local_names: set[str] = set()
                for t in tokens:
                    local_names.update(state.variables.locals_of(t.key))
                for _idx, k in scope_keys.items():
                    if k != pi_key:
                        local_names.update(state.variables.locals_of(k))
                for row in needed:
                    ast = info.exe.elements[row].multi_instance.input_collection.ast
                    if isinstance(ast, _FeelVar) and ast.path[0] in local_names:
                        return None
                cards = self._predict_mi_cards(info, needed, merged)
                if cards is None:
                    return None
                mi_cards = cards
            for row, lc in mi_parked.items():
                if row in seq_rows:
                    card = mi_cards.get(row)
                    if card is None or lc is None or lc > card:
                        return None
                    mi_left[row] = card - lc
                else:
                    mi_left[row] = 0  # parallel: fully spawned at rest
            for row in needed:
                if row not in mi_parked:
                    mi_left[row] = mi_cards[row]
        inst = _Inst(idx=len(instances), info=info, new=False, pi_key=pi_key,
                     tokens=tokens, join_counts=join_counts, slots=slots,
                     family_pis=family, mi_left=mi_left, mi_cards=mi_cards)
        # timer-touching bursts ARE templatable: clock-derived dueDate /
        # deadline fields in the admission docs are extracted as ("fp", i)
        # roles by the fingerprint walk (so instances with different due
        # dates share a template), and freshly computed due dates in the
        # burst itself resolve as ("clock", delta) roles
        # locals of EVERY parked token: input mappings create them, but so
        # can SetVariables(local=true) on any element instance — and output
        # mappings / variable propagation read them, so the template
        # fingerprint must pin them all (root-scope variables are pinned
        # via ``merged`` already)
        mapped_locals = [
            sorted(state.variables.locals_of(t.key).items()) for t in tokens
        ]
        # sub-process scope locals (written e.g. by inner output mappings):
        # mapping/condition evaluation reads them through collect(), so two
        # instances differing only there must fingerprint apart
        scope_locals = [
            (idx, sorted(state.variables.locals_of(k).items()))
            for idx, k in sorted(scope_keys.items()) if idx != 0
        ]
        return _Admitted(
            cmd=cmd, inst=inst, resume_token=resume, kind=kind,
            fp_docs=[
                cmd.record.value,
                *head_docs,
                root["value"],
                [t.value for t in tokens],
                wait_docs,
                sorted(merged.items()),
                sorted(join_counts.items()),
                mapped_locals,
                scope_locals,
            ],
            templatable=pi_key not in self.engine.await_results,
            wait_keys=wait_keys,
        )

    def _admit_job_complete(self, cmd, instances, admitted_pis,
                            wave) -> _Admitted | None:
        state = self.engine.state
        job = state.jobs.get(cmd.record.key)
        if job is None:
            return None  # sequential path writes the NOT_FOUND rejection
        return self._admit_resume(
            cmd, instances, admitted_pis,
            pi_key=job.get("processInstanceKey", -1),
            resume_key=job.get("elementInstanceKey", -1),
            kind="j",
            head_docs=[job],
            extra_variables=cmd.record.value.get("variables"),
            require_op=K_TASK,
            wave=wave,
        )

    def _admit_timer_trigger(self, cmd, instances, admitted_pis,
                             wave) -> _Admitted | None:
        state = self.engine.state
        timer = state.timers.get(cmd.record.key)
        if timer is None:
            return None  # sequential path writes the NOT_FOUND rejection
        eik = timer.get("elementInstanceKey", -1)
        if eik < 0:
            return None  # timer start event → host path
        instance = state.element_instances.get(eik)
        if instance is None:
            return None  # element gone; host records TRIGGERED only
        # only the waiting catch element itself (route_trigger's first
        # branch); boundary / event-based-gateway routing stays on the host
        if timer.get("targetElementId") != instance["value"].get("elementId"):
            return None
        return self._admit_resume(
            cmd, instances, admitted_pis,
            pi_key=instance["value"].get("processInstanceKey", -1),
            resume_key=eik,
            kind="t",
            head_docs=[timer],
            extra_variables=None,
            require_op=K_CATCH,
            wave=wave,
        )

    def _admit_message_correlate(self, cmd, instances, admitted_pis,
                                 wave) -> _Admitted | None:
        state = self.engine.state
        value = cmd.record.value
        eik = value.get("elementInstanceKey", -1)
        sub = state.process_message_subscriptions.get(eik, value.get("messageName", ""))
        instance = state.element_instances.get(eik)
        if sub is None or instance is None:
            return None  # at-least-once redelivery → host no-op path
        if sub.get("targetElementId") != instance["value"].get("elementId"):
            return None  # boundary / event-based gateway → host
        return self._admit_resume(
            cmd, instances, admitted_pis,
            pi_key=instance["value"].get("processInstanceKey", -1),
            resume_key=eik,
            kind="m",
            head_docs=[sub],
            extra_variables=value.get("variables"),
            require_op=K_CATCH,
            wave=wave,
        )

    # -- device run ----------------------------------------------------------

    @staticmethod
    def _pow2(n: int) -> int:
        p = 8
        while p < n:
            p *= 2
        return p

    def _build_group_arrays(self, admitted: list[_Admitted]):
        """Host (numpy) arrays for one admitted group, padded to the shape
        bucket: (arrays dict, I, T), or None when the geometry exceeds the
        event-packing bounds. Shared by the single-device path and the
        mesh-runner path (which treats the group as one shard block)."""
        from zeebe_tpu_torch.ops.automaton import PACK_MAX_ELEMENTS, PACK_MAX_TOKENS

        tables = self.registry.tables
        insts = [a.inst for a in admitted]
        n_real = len(insts)
        n_tokens = sum(max(1, len(i.tokens)) for i in insts)
        # two shape buckets: XLA specializes on shapes, not occupancy, so
        # groups are padded to either the small (64) or the max-group
        # geometry — exactly two compilations per table set, small groups
        # don't pay the big bucket's device time, and a warmup at each bucket
        # keeps compilation out of steady state. Token-heavy groups overflow
        # to the next power of two (rare; costs one extra compile).
        small = min(64, self._pow2(self.max_group))
        I = small if n_real <= small else self._pow2(self.max_group)
        # token pool: the set's static live-width bound (tables.token_width)
        # sizes it exactly — a one-token-per-instance set runs at T == I
        # instead of 4x, which is pure device-time savings; with no sound
        # bound (parallel split on a cycle) keep the legacy 4x factor.
        # Overflow is detected and falls back, so an undersized pool is a
        # perf bug, not a correctness one — but the bound is sound, so it
        # cannot happen for bounded sets.
        width = tables.token_width
        # parallel MI fan-out is dynamic: admission-predicted cardinalities
        # bound the extra live tokens beyond the static analysis
        mi_extra = sum(sum(i.mi_cards.values()) for i in insts if i.mi_cards)
        if width > 0:
            T = self._pow2(max(width * I, n_tokens))
        else:
            T = self._pow2(max(4 * I, 4 * n_tokens, n_tokens + mi_extra + I))
        E = tables.max_elements
        S = tables.num_slots
        if T > PACK_MAX_TOKENS or E >= PACK_MAX_ELEMENTS:
            # the bit-packed event tensor carries dest in 16 bits and elem in
            # 14 — geometries beyond that (absurd for real workloads) take
            # the sequential path instead of corrupting the decode
            logger.warning("kernel geometry T=%d E=%d exceeds event packing "
                           "bounds; falling back", T, E)
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
            def_of[i.idx] = i.info.index
            for name, v in i.slots.items():
                var_slots[i.idx, tables.slot_map.names[name]] = v
            for jidx, count in i.join_counts.items():
                join_counts[i.idx, jidx] = count
            for row, n in i.mi_left.items():
                mi_left[i.idx, row] = n
            if i.new:
                i.tokens = [_Token(slot=slot, elem_idx=int(tables.start_elem[i.info.index]),
                                   key=-1, value={})]
                elem[slot] = i.tokens[0].elem_idx
                phase[slot] = _PHASE_AT
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
    # end of the copy

    def _start_kernel(self, pg: "_PendingGroup") -> None:
        """Stage 1 of the split device run: build the group arrays and
        dispatch the first chunk asynchronously (CUDA's stream order) — the
        caller overlaps host work with the device compute before calling
        ``_await_kernel``. Mesh groups stay synchronous (the runner's submit
        blocks), so they only record the build."""
        built = self._build_group_arrays(pg.admitted)
        if built is None:
            pg.failed = True
            pg.fail_reason = "geometry-bounds"
            return
        pg.arrays, pg.I, pg.T = built
        pg.tables = self.registry.tables
        if self.mesh_runner is not None:
            pg.mesh = True
            return
        # the bucket carries the table-set content digest: different
        # deployed sets are different programs
        pg.bucket = (self.registry.tables_fingerprint, pg.I, pg.T)
        # link-aware choice: the card, or the host; None = routing off
        route, probe = None, False
        if self.router is not None:
            if pg.canary:
                # a canary must probe the SUSPECT card: pin it rather than
                # ask choose(), whose quarantine host-ward bias
                # (route_threshold_s=+inf) would send the canary to the
                # host — where it trivially byte-matches the host oracle
                # and re-proves nothing
                route = self.router.accel_device()
            if route is None:
                route = self.router.choose(pg.bucket)
            if (route is not None and route.type == "cpu" and self.device.type == "cuda"
                    and _suspect_probe_due(self.health)):
                # a SUSPECT card is probed all the same, through the seam
                # under forced shadow: its faults escalate the ladder, a
                # clean probe commits (``_suspect_probe_due``)
                route, probe = self.router.accel_device(), True
        if route is not None:
            self.router.count(route)
            if route.type == "cpu" and self.device.type == "cuda":
                # the host's choice on the card: declined, typed, and a
                # tick of the SUSPECT ladder's quiet window, as the
                # reference's host-routed groups give it (a ladder biased
                # host-ward would never clear otherwise)
                self.health.note_host_reroute()
                self.health.note_group_ok()
                pg.failed = True
                pg.fail_reason = "routed-host"
                return
        # the group runs on the backend's device whichever side was chosen
        pg.dev = self.device
        # chunk k+1 is dispatched before chunk k's rows are fetched only on
        # the card, where the device computes while the host decodes
        pg.pipeline_chunks = pg.dev.type == "cuda"
        # shadow sampling decided BEFORE dispatch: only sampled groups pay
        # the fetched-row retention (canaries are forced-shadow)
        pg.shadow = pg.canary or probe or self._shadow_sampled()
        t0 = time.perf_counter()
        self._begin_dispatch(pg, lambda: self._dispatch_first_chunk(pg))
        if not pg.failed:
            # device_elapsed covers only the dispatch and fetch windows,
            # never the host work the caller overlaps between them
            pg.device_elapsed = time.perf_counter() - t0

    def _await_kernel(self, pg: "_PendingGroup") -> list[dict] | None:
        """Stage 2: block on the in-flight device run (or submit the mesh
        request) and return the decoded per-step events, None on fallback."""
        if pg.failed:
            return None
        if pg.mesh:
            t0 = time.perf_counter()
            result = self.mesh_runner.submit(GroupRequest(
                device_tables=self.registry.device_tables_for(self.mesh_runner.mesh.device),
                config=pg.tables.kernel_config,
                tables_fingerprint=self.registry.tables_fingerprint,
                arrays=pg.arrays,
                num_instances=pg.I,
                num_tokens=pg.T,
                max_steps=self.max_steps,
                chunk_steps=self.chunk_steps,
            ))
            submit_dur = time.perf_counter() - t0
            pg.device_elapsed += submit_dur
            if result.steps is None:
                pg.fail_reason = "mesh-dispatch-error"
                logger.warning("mesh kernel dispatch errored; falling back")
            elif not result.quiesced:
                pg.fail_reason = "mesh-no-quiesce"
                logger.warning("mesh kernel group did not quiesce; falling back")
            elif result.overflow:
                pg.fail_reason = "mesh-token-overflow"
                logger.warning("mesh kernel token pool overflow (T=%d); falling back", pg.T)
            # the mesh submit seam span: one per submit on the wave's group
            # trace, outcome included so declined submits are visible
            tracer = self._tracer
            if tracer.enabled and pg.admitted:
                group_trace = (f"{self._partition_id}:"
                               f"g{pg.admitted[0].cmd.position}")
                # group spans bypass head sampling — they carry the
                # substitution intervals for every sampled command
                tracer.emit(
                    group_trace, "kernel.mesh_submit", submit_dur,
                    self._partition_id, parent="processor.kernel_group",
                    attrs={"instances": pg.I, "tokens": pg.T,
                           "outcome": pg.fail_reason or "ok"})
            if pg.fail_reason:
                return None
            return result.steps

        t0 = time.perf_counter()
        # a mid-group fetch failure or a watchdog-expired stall abandons the
        # group (contained: None)
        steps = self._contained(pg, "fetch", lambda: self._complete_device_run(pg))
        pg.device_elapsed += time.perf_counter() - t0
        return steps

    # copied from the reference: _observe_compile .. _observe_compile
    @staticmethod
    def _observe_compile(I: int, T: int, seconds: float) -> None:
        """Feed one first-dispatch wall time into the XLA compile telemetry
        (observability/profiler.py): the histogram is labeled by geometry
        bucket, the counter classifies hit/miss against the persistent-cache
        threshold. Telemetry must never take a dispatch down."""
        try:
            from zeebe_tpu_torch.observability.profiler import observe_compile

            observe_compile(f"I{I}xT{T}", seconds)
        except Exception:  # noqa: BLE001
            pass
    # end of the copy

    def _group_state(self, pg: "_PendingGroup", dev) -> dict:
        """The group's initial kernel state on ``dev``: the host-filled
        arrays plus zero incident flags and counters, built per group (the
        reference shares its zero planes across groups because JAX arrays
        are immutable; torch tensors are not). The dispatch path and the
        shadow oracle both start from it."""
        return group_state(pg.arrays, dev)

    def _dispatch_first_chunk(self, pg: "_PendingGroup") -> None:
        dev = pg.dev
        pg.config = pg.tables.kernel_config
        pg.dt = self.registry.device_tables_for(dev)
        state = self._group_state(pg, dev)
        # compile seam: the FIRST dispatch per (table set, shape bucket,
        # device) is timed to its end, the first launch's completion
        # included (a one-time wait); later dispatches of the geometry stay
        # untimed and asynchronous
        compile_key = (pg.bucket, dev)
        first_dispatch = compile_key not in self._compiles_seen
        t_compile = time.perf_counter()
        with _profiler_annotation("zeebe.kernel_chunk.first"):
            # enqueued: the chunk and the copy of its rows run on the stream
            # while the caller goes on; fetching the rows waits for them
            pg.run = _dispatch(pg.dt, state, self.chunk_steps, pg.config, run_collect)
        if first_dispatch:
            if pg.run.ready is not None:
                pg.run.ready.synchronize()
            self._compiles_seen.add(compile_key)
            self._observe_compile(pg.I, pg.T, time.perf_counter() - t_compile)

    def _complete_device_run(self, pg: "_PendingGroup"):
        """The chunk loop behind the group's first chunk (``pg.run``), every
        fetch through the seam: the decoded steps, or None with
        ``pg.fail_reason`` set."""
        return _complete_device_run(
            pg, pg.run, run_collect, lambda chunk, k: self._fetch_rows(pg, chunk, k),
            self.chunk_steps, self.max_steps).steps

    def _oracle_start(self, pg: "_PendingGroup") -> dict:
        return self._group_state(pg, "cpu")

    def _oracle_chunking(self, pg: "_PendingGroup") -> tuple[int, int]:
        return self.chunk_steps, self.max_steps

    # copied from the reference: device_status .. note_group_success
    def device_status(self) -> dict:
        """The ``device`` block under ``kernelCoverage`` on /health and
        /cluster/status: ladder state + shadow/canary counters."""
        return {**self.health.status(),
                "shadowQuarantinedGroups": self.shadow_quarantined}

    # -- materialization ------------------------------------------------------

    def process_group(self, cmds, make_builder: Callable[[], Any]) -> tuple[list, list]:
        """Pull commands from the ``cmds`` iterator while they admit (lazy: a
        non-admittable head costs one log read, not a full peek), run the
        kernel, and materialize each admitted command's record burst — either
        through a burst template (fast path: patched bytes + state deltas) or
        through the Writers/appliers slow path (which doubles as template
        capture). Returns (admitted_cmds, results) where each result is a
        ProcessingResultBuilder or a PreparedBurst; empty lists mean the
        caller should process the head command sequentially.

        Must run inside the partition's open db transaction. The synchronous
        begin+finish composition; the pipelined processor calls the halves
        itself and overlaps host work between them."""
        return self.finish_group(self.begin_group(cmds), make_builder)

    def begin_group(self, cmds, speculative: bool = False) -> _PendingGroup | None:
        """Admit a group and dispatch its first device chunk asynchronously.
        Returns None when the head command is not admittable (sequential
        traffic). Must run inside the partition's open db transaction, and
        the same transaction must stay open through ``finish_group``.

        ``speculative``, cross-wave double buffering): the
        processor is beginning wave k+1 inside wave k's still-open
        transaction, right after wave k materialized — admission reads the
        post-wave overlay, which is byte-identical to the committed state
        the next round's transaction will open over. A speculative begin is
        silent on decline (no fallback counters, no typed host notes, no
        quarantine reroute accounting): the group may never be consumed, so
        the NEXT round's authoritative scan owns all accounting. It also
        never claims a canary slot — under quarantine the ladder's one-
        probe-per-interval discipline belongs to the real scan."""
        import time as _time

        if speculative and (self.mesh_runner is not None
                            or self.health.is_quarantined()):
            # mesh has its own submit pipeline; a quarantined device gets
            # exactly the canary probes the health ladder schedules, never
            # an extra speculative dispatch
            return None

        # device health gating: while QUARANTINED every group is
        # host-routed (typed accounting) except the periodic canary — ONE
        # group per interval dispatched under FORCED shadow verification (a
        # known-answer probe: the host oracle is the answer, so a wrong
        # canary cannot commit wrong bytes). Mesh dispatch has its own
        # killable probe and is not gated here.
        canary = False
        if self.mesh_runner is None and self.health.is_quarantined():
            if self.health.canary_due():
                canary = True
            else:
                head = next(iter(cmds), None)
                if head is None:
                    return None  # end-of-log probe, not a reroute
                self.fallbacks += 1
                self.accounting.note_host("device-quarantined",
                                          self._definition_of(head.record))
                self.health.note_host_reroute()
                return None

        t0 = _time.perf_counter()
        instances: dict[int, _Inst] = {}
        # pi_key conflict index: one command per instance per group; a set
        # keeps admission O(1) instead of O(group) per command
        admitted_pis: set[int] = set()
        admitted: list[_Admitted] = []
        # per-wave admission memo (definition lookups, segment freshness,
        # condition slot planes): admission runs inside one open transaction
        # over state nothing mutates until materialization, so everything it
        # derives from state alone is stable for the whole wave
        wave: dict = {}
        head_cmd = None
        for cmd in cmds:
            if head_cmd is None:
                head_cmd = cmd
            adm = self._admit(cmd, instances, admitted_pis, wave)
            if adm is None:
                break
            instances[adm.inst.idx] = adm.inst
            if adm.inst.pi_key is not None and adm.inst.pi_key >= 0:
                admitted_pis.add(adm.inst.pi_key)
            admitted_pis.update(adm.inst.family_pis)
            admitted.append(adm)
            if len(admitted) >= self.max_group:
                break
        if not admitted:
            if canary:
                # the claimed canary slot never dispatched: un-claim it so
                # the next admittable group can probe immediately instead
                # of waiting out an interval the device never saw
                self.health.release_canary()
            if speculative:
                # nothing speculatively admittable — no accounting: the next
                # round's real scan re-encounters this head and notes it once
                return None
            if head_cmd is None:
                # the candidate iterator was EMPTY — an end-of-log probe, not
                # a fallback: these probes were counted as
                # "head-not-admittable" and made mesh_serving p1 report 4
                # phantom fallbacks per run)
                return None
            # the head command is not kernel-admittable (deploys, unknown
            # defs, non-default tenants, …): normal sequential traffic, but
            # counted — WITH the head's kind — so BENCH separates ordinary
            # sequential commands (a deployment, a message publish) from a
            # regression where an admittable kind stopped admitting
            self.fallbacks += 1
            rec = head_cmd.record
            self.accounting.note_host(
                f"head-not-admittable:{rec.value_type.name}.{rec.intent.name}",
                self._definition_of(rec),
            )
            return None
        pg = _PendingGroup(admitted)
        pg.canary = canary
        pg.t_admit = _time.perf_counter() - t0
        self._start_kernel(pg)
        return pg

    def finish_group(self, pg: _PendingGroup | None,
                     make_builder: Callable[[], Any]) -> tuple[list, list]:
        """Block on the in-flight device run and materialize the bursts.
        ([], []) → the caller should process the head command sequentially."""
        import time as _time

        if pg is None:
            return [], []
        steps = self._await_kernel(pg)
        if steps is not None and not pg.mesh and pg.shadow:
            # the validation/shadow seam: the ONLY way a device
            # result may proceed toward the group transaction when sampled
            # — on mismatch the host oracle's steps come back instead
            steps = self._verify_steps(pg, steps)
        if steps is None:
            # the whole group declined at dispatch; the HEAD is what the
            # caller processes sequentially next (the rest re-admit), so
            # exactly one host record is noted, with the typed reason
            self.fallbacks += 1
            chaos = _DEVICE_CHAOS
            if chaos is not None and pg.corrupt_tokens:
                # a typed decline (no-quiesce/overflow a corruption itself
                # provoked) discards the fetched rows: caught by containment
                for token in pg.corrupt_tokens:
                    chaos.note_caught(token, "contained")
                pg.corrupt_tokens = []
            if pg.canary:
                if pg.fail_reason in ("device-dispatch-error",
                                      "device-wedged"):
                    # the probe reached the device and the device failed:
                    # a real failed canary, the recovery streak resets
                    self.health.note_canary(
                        False, detail=pg.fail_reason)
                else:
                    # a host-side decline (geometry-bounds, no-quiesce,
                    # token-overflow) never proved anything about the
                    # device — un-claim the slot so the next admittable
                    # group probes immediately, and leave the verified
                    # streak alone (a pathological GROUP must not hold
                    # the device in quarantine)
                    self.health.release_canary()
            head = pg.admitted[0]
            self.accounting.note_host(
                pg.fail_reason or "group-error",
                head.inst.info.exe.process_id,
            )
            return [], []

        t0 = _time.perf_counter()
        admitted = pg.admitted
        results = []
        for adm in admitted:
            ops = self._cascade_ops(adm.inst, steps)
            results.append(self._materialize(adm, ops, make_builder))
        pg.t_materialize = _time.perf_counter() - t0
        self.groups_processed += 1
        self.commands_processed += len(admitted)
        return [a.cmd for a in admitted], results

    def note_group_success(self, pg: _PendingGroup) -> None:
        """Per-definition kernel-path accounting for one materialized group
        (coverage gauge + parity gate), batched per definition to bound
        gauge writes. Called by the processor AFTER the group's transaction
        commits — noting inside ``finish_group`` would double-count the
        group when a post-materialization commit failure rolls it back and
        the same commands re-admit on the next pump."""
        defs: dict[str, int] = {}
        for adm in pg.admitted:
            pid = adm.inst.info.exe.process_id
            defs[pid] = defs.get(pid, 0) + 1
        for pid, n in defs.items():
            self.accounting.note_kernel(pid, n)
        # clean-group evidence for the health ladder: a committed group
        # with no fault steps SUSPECT back toward HEALTHY after the
        # configured quiet window
        self.health.note_group_ok()
    # end of the copy

    # copied from the reference: _materialize .. _emit_process_completed
    def _materialize(self, adm: _Admitted, ops: list, make_builder):
        from zeebe_tpu_torch.engine import burst_templates as bt
        from zeebe_tpu_torch.engine.writers import Writers

        template = None
        key = None
        if self.use_templates and adm.templatable:
            # request presence is part of the burst SHAPE (Writers.respond
            # only emits a client response when request_id >= 0), so it must
            # be in the key — the ids themselves are patched roles
            fp_bytes = adm.fp_bytes
            if fp_bytes is None:  # admission-time fingerprint unavailable
                fp_bytes, adm.fp_values, adm.fp_pinned = self._fingerprint(adm)
            # segment child-def keys are in the key: a refresh_segments swap
            # reuses the info index, and a stale template would patch the OLD
            # child definition's baked constants into new-binding bursts
            key = (adm.kind, adm.inst.info.index,
                   tuple(s.child_def_key for s in adm.inst.info.segments),
                   adm.cmd.record.request_id >= 0, tuple(ops), fp_bytes)
            template = self._templates.get(key, _MISSING)
            if template is _MISSING:
                template = None
                miss = True
            else:
                miss = False
                # move-to-end so eviction (oldest-half sweep) drops cold
                # entries, not the hottest templates
                del self._templates[key]
                self._templates[key] = template
            if template is not None and not self.audit_templates:
                self.template_hits += 1
                return self._instantiate(template, adm)
        else:
            miss = False

        # slow path (also: template capture on first miss, audit on hit)
        capture = self.use_templates and adm.templatable and miss
        auditing = template is not None and self.audit_templates
        txn = self.engine.state.db.require_transaction()
        state = self.engine.state
        role_map, wrapped = self._roles_for(adm)
        mints: list[int] = []
        orig_next_key = state.next_key
        if capture or auditing:
            def tagged_next_key():
                v = orig_next_key()
                mints.append(v)
                return v
            state.next_key = tagged_next_key
            txn.capture = cap_log = []
            # collect clock-derived values (dueDate = clock + clock-free
            # delta) the engine computes during this run — they become
            # ("clock", delta) roles; a poison note (now()-entangled delta)
            # declines the template
            bt.clock_note_begin()
        builder = make_builder()
        writers = Writers(builder, self.engine.appliers)
        try:
            if adm.inst.new:
                self._materialize_creation(wrapped, adm, ops, writers, builder)
            else:
                self._materialize_resume(wrapped, adm, ops, writers, builder)
            if any(f.record.is_command and not f.processed
                   for f in builder.follow_ups):
                self._drain_host_escapes(wrapped.position, builder)
        finally:
            if capture or auditing:
                state.next_key = orig_next_key
                txn.capture = None
                clock_notes, clock_poison = bt.clock_note_end()
        if capture:
            self.template_misses += 1
            allowed = adm.fp_pinned if adm.fp_pinned is not None else set()
            if adm.inst.info.segments:
                # called-definition keys resolve mid-burst (CallActivity
                # latest-binding) and are sound template constants: the
                # admission freshness check pins the binding, and the keys
                # are part of the template cache key
                allowed = allowed | {
                    s.child_def_key for s in adm.inst.info.segments
                }
            if clock_poison:
                role_map = None
            for i, v in enumerate(mints):
                if role_map is None:
                    break
                if v in role_map:
                    role_map = None  # role collision → not templatable
                    break
                role_map[v] = ("mint", i)
            for i, v in enumerate(adm.fp_values or ()):
                if role_map is None:
                    break
                if v in role_map:
                    # a clock-field value colliding with a key/mint would
                    # patch the wrong quantity — decline instead
                    role_map = None
                    break
                role_map[v] = ("fp", i)
            # delta → value of this run's clock notes: capture validation
            # resolves against the exact values the slow path wrote (immune
            # to a clock tick mid-run)
            clock_values: dict[int, int] = {}
            for v, delta in clock_notes:
                if role_map is None:
                    break
                if v < _ROLE_VALUE_MIN:
                    # a small (test-clock) due date cannot be a patchable
                    # role and would bake stale — decline the template
                    role_map = None
                    break
                existing = role_map.get(v)
                if existing is not None and existing != ("clock", delta):
                    role_map = None  # same value, conflicting meaning
                    break
                if v in allowed or clock_values.get(delta, v) != v:
                    # fingerprint-pinned elsewhere, or two different values
                    # for one delta (clock ticked between two same-duration
                    # timers): ambiguous — decline
                    role_map = None
                    break
                role_map[v] = ("clock", delta)
                clock_values[delta] = v
            if role_map is not None:
                roles_ctx = bt.Roles(role_map, allowed=allowed)
                try:
                    tmpl = bt.build_template(
                        builder, cap_log, roles_ctx, len(mints),
                        state.partition_id,
                    )
                    bt.validate_template(
                        tmpl, builder,
                        self._resolver(adm, mints, clock_values))
                    self._store_template(key, tmpl)
                except bt.NotTemplatable as exc:
                    logger.debug("trace not templatable: %s", exc)
                    self._store_template(key, None)
            else:
                self._store_template(key, None)
        elif auditing:
            audit_clock_values: dict[int, int] = {}
            conflict = clock_poison
            for v, delta in clock_notes:
                if audit_clock_values.setdefault(delta, v) != v:
                    # the wall clock ticked between two same-duration timer
                    # creations in this run: the single delta→value map can't
                    # represent both, so the audit would assert spuriously —
                    # skip it (capture declines this shape, so no template
                    # was ever built from such a run)
                    conflict = True
                    break
            if conflict:
                self.template_audit_skips += 1
            else:
                self.template_audits += 1
                self._audit_template(template, adm, builder, cap_log, mints,
                                     audit_clock_values)
        return builder

    def _drain_host_escapes(self, source_position: int, builder,
                            limit: int | None = None,
                            end_idx: int | None = None,
                            reserved_keys: set | None = None) -> None:
        """Process follow-up commands left unprocessed (flows into K_HOST
        elements, and whatever those spawn) with the sequential engine, FIFO,
        within the batch budget — so the flattened burst matches the
        sequential batch loop (stream/processor.py _batch_process) byte for
        byte: same record order, same positions, same processed flags, same
        source position. ``limit=1`` drains exactly one command (the trace
        interleaves it at the escaped token's arrival position);
        ``end_idx`` drains only commands appended before that follow-up
        index (a device token's processing must first flush escape cascades
        that precede its ACTIVATE in the queue); the final unbounded call
        flushes whatever remains. Commands beyond the budget stay
        unprocessed on the log and the stream processor picks them up as
        the next commands, exactly like a sequential batch that hit its
        limit."""
        from zeebe_tpu_torch.logstreams.log_stream import LoggedRecord

        budget = self.max_commands_in_batch - 1 - sum(
            1 for f in builder.follow_ups if f.record.is_command and f.processed
        )
        if limit is not None:
            budget = min(budget, limit)
        scan = 0
        while budget > 0:
            follow_up = None
            bound = len(builder.follow_ups) if end_idx is None else end_idx
            while scan < bound:
                entry = builder.follow_ups[scan]
                if entry.record.is_command and not entry.processed:
                    if (reserved_keys
                            and entry.record.value_type == ValueType.PROCESS_INSTANCE
                            and int(entry.record.intent) == int(PI.COMPLETE_ELEMENT)
                            and entry.record.key in reserved_keys):
                        # a device MI body's completion command: its "done"
                        # op pairs with it (device-side drain detection) —
                        # draining it here would double-complete the body
                        scan += 1
                        continue
                    follow_up = entry
                    break
                scan += 1
            if follow_up is None:
                return
            follow_up.processed = True
            budget -= 1
            logged = LoggedRecord(
                record=follow_up.record, position=-1,
                source_position=source_position, processed=True,
            )
            self.engine.process(logged, builder)
            scan += 1

    def _store_template(self, key, template) -> None:
        cache = self._templates
        if len(cache) >= self._template_cache_limit:
            for k in list(cache)[: self._template_cache_limit // 2]:
                del cache[k]
        cache[key] = template

    # document fields whose int values are clock-derived and copied verbatim
    # by the slow path (never transformed into non-int outputs): they are
    # extracted as per-command template inputs (("fp", i) roles) instead of
    # pinned in the fingerprint, so e.g. timer-carrying instances with
    # different due dates share one burst template
    _FP_FIELDS = frozenset(("dueDate", "deadline"))

    def _fingerprint(self, adm: _Admitted) -> tuple[bytes, list[int], set[int]]:
        """(byte image, extracted clock-field values, pinned large ints) of
        the instance-scoped documents the slow path reads. Role values (keys
        known at admission) and whitelisted clock-derived fields are
        normalized away so two commands differing only in key identity / due
        dates fingerprint equal; everything else is pinned byte-for-byte —
        the returned pinned set is exactly the template's sound constant
        allowance (Roles.allowed)."""
        roles = {}
        inst = adm.inst
        if inst.pi_key >= _ROLE_VALUE_MIN:
            roles[inst.pi_key] = "p"
        for j, tok in enumerate(inst.tokens):
            if tok.key >= _ROLE_VALUE_MIN:
                roles[tok.key] = f"t{j}"
        if adm.cmd.record.key >= _ROLE_VALUE_MIN:
            roles[adm.cmd.record.key] = "k"
        for j, wk in enumerate(adm.wait_keys or ()):
            if wk >= _ROLE_VALUE_MIN:
                roles.setdefault(wk, f"w{j}")
        if _native_pack_fingerprint is not None:
            return _native_pack_fingerprint(adm.fp_docs, roles, self._FP_FIELDS)
        return _py_pack_fingerprint(adm.fp_docs, roles, self._FP_FIELDS)

    def _roles_for(self, adm: _Admitted):
        """(value→role map, role-tagged command) for capture/audit runs."""
        from zeebe_tpu_torch.engine.burst_templates import RoleInt

        role_map: dict[int, tuple] = {}
        inst = adm.inst
        if inst.pi_key >= _ROLE_VALUE_MIN:
            role_map[inst.pi_key] = ("pi",)
        for j, tok in enumerate(inst.tokens):
            if tok.key >= _ROLE_VALUE_MIN:
                role_map[tok.key] = ("tok", j)
        for j, wk in enumerate(adm.wait_keys or ()):
            if wk >= _ROLE_VALUE_MIN:
                role_map.setdefault(wk, ("wait", j))
        cmd = adm.cmd
        rec = cmd.record
        if rec.key >= _ROLE_VALUE_MIN:
            role_map.setdefault(rec.key, ("cmd_key",))
        wrapped_rec = rec.replace(
            request_stream_id=RoleInt(rec.request_stream_id, ("req_stream",)),
            request_id=RoleInt(rec.request_id, ("req_id",)),
            operation_reference=RoleInt(rec.operation_reference, ("opref",)),
        )
        from zeebe_tpu_torch.logstreams import LoggedRecord

        wrapped = LoggedRecord(
            record=wrapped_rec,
            position=RoleInt(cmd.position, ("source_position",)),
            source_position=cmd.source_position,
            processed=cmd.processed,
        )
        return role_map, wrapped

    def _resolver(self, adm: _Admitted, mints: list[int],
                  clock_values: dict[int, int] | None = None):
        """``clock_values`` (delta → value) is passed on capture-validation
        and audit runs so ("clock", delta) roles resolve to the exact values
        the slow path just wrote; live instantiation recomputes them from
        the engine clock."""
        cmd = adm.cmd
        inst = adm.inst
        toks = inst.tokens
        fp_values = adm.fp_values or ()
        wait_keys = adm.wait_keys or ()
        # one clock snapshot per resolver: a burst's payload, state rows, and
        # responses must all carry the SAME dueDate for one logical timer
        # even if the wall clock ticks mid-instantiation
        clock_base = (self.engine.clock_millis() if clock_values is None
                      else None)

        def resolve(role: tuple) -> int:
            kind = role[0]
            if kind == "mint":
                return mints[role[1]]
            if kind == "fp":
                return fp_values[role[1]]
            if kind == "clock":
                delta = role[1]
                if clock_values is not None:
                    v = clock_values.get(delta)
                    if v is not None:
                        return v
                    return self.engine.clock_millis() + delta
                return clock_base + delta
            if kind == "wait":
                return wait_keys[role[1]]
            if kind == "source_position":
                return cmd.position
            if kind == "req_id":
                return cmd.record.request_id
            if kind == "req_stream":
                return cmd.record.request_stream_id
            if kind == "opref":
                return cmd.record.operation_reference
            if kind == "cmd_key":
                return cmd.record.key
            if kind == "pi":
                return inst.pi_key
            if kind == "tok":
                return toks[role[1]].key
            raise KeyError(role)

        return resolve

    def _instantiate(self, template, adm: _Admitted):
        from zeebe_tpu_torch.engine.burst_templates import PreparedBurst

        state = self.engine.state
        mints = state.bulk_mint(template.mint_count)
        resolve = self._resolver(adm, mints)
        buf = template.instantiate_payload(resolve)
        txn = state.db.require_transaction()
        template.apply_state(txn, resolve)
        responses = template.build_responses(resolve)
        return PreparedBurst(
            buf=buf,
            pos_offsets=template.pos_offsets,
            ts_offsets=template.ts_offsets,
            count=template.count,
            responses=responses,
            has_pending_commands=template.has_pending_commands,
            job_types=template.job_types,
        )

    def _audit_template(self, template, adm: _Admitted, builder, cap_log,
                        mints, clock_values: dict[int, int]) -> None:
        """Shadow-check a template hit against the slow path just executed."""
        from zeebe_tpu_torch.engine import burst_templates as bt
        from zeebe_tpu_torch.state.db import ColumnFamilyCode
        import struct as _struct

        if len(mints) != template.mint_count:
            raise AssertionError(
                f"template audit: mint count {template.mint_count} != slow path {len(mints)}"
            )
        resolve = self._resolver(adm, mints, clock_values)
        bt.validate_template(template, builder, resolve)
        # state ops: template replay vs the slow path's capture log, collapsed
        # to the final op per key exactly as build_template does (minus the
        # KEY column family, which the template replaces with bulk mint)
        final: dict[bytes, tuple] = {}
        for op, key, value in cap_log:
            if _struct.unpack_from(">H", key, 0)[0] == int(ColumnFamilyCode.KEY):
                continue
            if key in final:
                del final[key]
            final[key] = (op, value)
        expected = [(op, key, value) for key, (op, value) in final.items()]

        class _Recorder:
            def __init__(self):
                self.ops = []

            def put(self, key, value):
                self.ops.append(("put", key, value))

            def delete(self, key):
                self.ops.append(("del", key, None))

        rec = _Recorder()
        template.apply_state(rec, resolve)
        if len(rec.ops) != len(expected):
            raise AssertionError(
                f"template audit: {len(rec.ops)} state ops vs slow path {len(expected)}"
            )
        for (op_a, key_a, val_a), (op_b, key_b, val_b) in zip(rec.ops, expected):
            if op_a != op_b or key_a != key_b or (op_a == "put" and val_a != val_b):
                raise AssertionError(
                    f"template audit: state op mismatch {op_a} {key_a!r} vs {op_b} {key_b!r}"
                )
        # responses
        got = template.build_responses(resolve)
        want = ([] if builder.response is None else [(False, builder.response)]) + [
            (True, r) for r in builder.extra_responses
        ]
        if len(got) != len(want):
            raise AssertionError("template audit: response count mismatch")
        for (extra_a, rec_a, stream_a, req_a), (extra_b, resp) in zip(got, want):
            if (extra_a != extra_b or stream_a != resp.request_stream_id
                    or req_a != resp.request_id or rec_a != resp.record):
                raise AssertionError("template audit: response mismatch")

    def _mark_last_command_processed(self, builder) -> None:
        for entry in reversed(builder.follow_ups):
            if entry.record.is_command:
                entry.processed = True
                return

    def _materialize_creation(self, cmd, adm: _Admitted, ops, writers, builder) -> None:
        from zeebe_tpu_torch.engine.bpmn import _pi_value

        engine = self.engine
        state = engine.state
        inst = adm.inst
        exe = inst.info.exe
        # the sequential creation processor writes CREATED + response +
        # ACTIVATE(process) command + seed VARIABLE events — reuse it verbatim
        creation = engine._processors[
            (ValueType.PROCESS_INSTANCE_CREATION, int(ProcessInstanceCreationIntent.CREATE))
        ]
        mark = len(builder.follow_ups)
        creation(cmd, writers)
        # locate the minted instance key + the ACTIVATE(process) command
        activate_cmd = None
        for entry in builder.follow_ups[mark:]:
            if entry.record.is_command and entry.record.value_type == ValueType.PROCESS_INSTANCE:
                activate_cmd = entry
                break
        if activate_cmd is None:  # rejection (definition vanished mid-group)
            return
        activate_cmd.processed = True
        inst.pi_key = activate_cmd.record.key
        process_el = exe.root
        value = _pi_value(dict(activate_cmd.record.value), process_el)
        writers.append_event(inst.pi_key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_ACTIVATING, value)
        if inst.info.root_esp_start_idxs:
            # root event-sub-process start subscriptions open between
            # ACTIVATING and ACTIVATED — the sequential behavior runs
            # verbatim (byte parity by construction). A pre-validation
            # failure (admission raced a variable change — can't happen for
            # creations, defensive) leaves the root ACTIVATING with the
            # incident written, same as the sequential path.
            if not engine.bpmn._open_scope_event_subscriptions(
                    inst.pi_key, value, exe, process_el, writers):
                return
        writers.append_event(inst.pi_key, ValueType.PROCESS_INSTANCE, PI.ELEMENT_ACTIVATED, value)
        # ACTIVATE(start) — mirror BpmnProcessor._write_activate
        start = exe.elements[exe.none_start_of(0)]
        tok = inst.tokens[0]
        tok.key = state.next_key()
        tok.value = self._child_value(value, start, inst.pi_key)
        writers.append_command(tok.key, ValueType.PROCESS_INSTANCE,
                               PI.ACTIVATE_ELEMENT, tok.value)
        if self.registry.tables.kernel_op[inst.info.index, start.idx] == K_HOST:
            # host-escaped none start (e.g. output mappings): the device
            # token parks silently; _materialize's post-trace drain hands the
            # whole instance to the sequential engine
            return
        self._mark_last_command_processed(builder)
        self._emit_ops(inst, ops, writers, builder, cmd.position)

    _RESUME_HEADS = {
        "j": (ValueType.JOB, int(JobIntent.COMPLETE)),
        "t": (ValueType.TIMER, int(TimerIntent.TRIGGER)),
        "m": (ValueType.PROCESS_MESSAGE_SUBSCRIPTION,
              int(ProcessMessageSubscriptionIntent.CORRELATE)),
    }

    def _materialize_resume(self, cmd, adm: _Admitted, ops, writers, builder) -> None:
        """Resume commands (job complete / timer trigger / message correlate)
        share one shape: the sequential head processor writes its own events
        (JOB COMPLETED + variables, TIMER TRIGGERED, …SUBSCRIPTION CORRELATED
        + variables + ack side effect) and ends by routing a COMPLETE_ELEMENT
        command at the parked element; the cascade emits what processing that
        command would have."""
        engine = self.engine
        head = engine._processors[self._RESUME_HEADS[adm.kind]]
        head(cmd, writers)
        self._mark_last_command_processed(builder)  # the COMPLETE_ELEMENT cmd
        self._emit_ops(adm.inst, ops, writers, builder, cmd.position)

    @staticmethod
    def _child_value(scope_value: dict, element: ExecutableElement, scope_key: int) -> dict:
        """Mirror BpmnProcessor._write_activate's record value exactly."""
        return {
            "bpmnProcessId": scope_value["bpmnProcessId"],
            "version": scope_value["version"],
            "processDefinitionKey": scope_value["processDefinitionKey"],
            "processInstanceKey": scope_value["processInstanceKey"],
            "elementId": element.id,
            "flowScopeKey": scope_key,
            # an element with loop characteristics is entered through its
            # multi-instance body wrapper (host-escaped on device)
            "bpmnElementType": (
                BpmnElementType.MULTI_INSTANCE_BODY.name
                if element.multi_instance is not None
                else element.element_type.name
            ),
            "bpmnEventType": element.event_type.name,
        }

    # -- device-step decoding: trace extraction + emission -------------------
    #
    # The old single-pass cascade is split in two: _cascade_ops walks the
    # device steps once and produces a route trace over *logical* token ids
    # (slot- and key-free, so it doubles as the burst-template cache key);
    # _emit_ops interprets a trace through the Writers in exactly the order
    # the one-pass walk used to emit.

    def _cascade_ops(self, inst: _Inst, steps) -> list:
        """Trace one instance's route through the device steps.

        Ops (logical token ids; initial tokens are 0..len(tokens)-1, flow
        targets get ids in creation order):
          ("arrive", l, elem)      task activated, token parks
          ("done", l, elem)        parked task completes (job completed)
          ("pass", l, elem)        full activate+complete pass
          ("nomatch", l, elem)     exclusive gateway with no matching flow
          ("flow", l, elem, fo, new_l)  flow slot fo taken; new_l == -1 when
                                   no token was placed (join arrival merged)
          ("hostarr", l, elem)     token reached a host-escaped element: the
                                   emitter drains its ACTIVATE sequentially
                                   at exactly this FIFO position
          ("complete",)            the process instance completed
        """
        tables = self.registry.tables
        d = inst.info.index
        exe = inst.info.exe
        ops: list = []
        # live: [logical id, slot, elem_idx]
        live = [[l, t.slot, t.elem_idx] for l, t in enumerate(inst.tokens)]
        next_l = len(live)
        # logical id → step index at which a host-escaped token "arrives"
        # (the device parks it silently; the trace needs the position)
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
                        # scope arrival: the inner start token's placement
                        # rides flow slot 0 (see step()'s spawn channel); the
                        # scope token itself stays parked
                        dest = int(ev["dest"][s, 0])
                        nl = next_l
                        next_l += 1
                        start_idx = int(tables.scope_start[d, e])
                        additions.append([nl, dest, start_idx])
                        ops.append(("scopearr", l, e, nl))
                        if tables.kernel_op[d, start_idx] == K_HOST:
                            host_arrive[nl] = si + 1
                    elif tables.kernel_op[d, e] == K_MI:
                        # MI body arrival: the device spawns child tokens (one
                        # per step) purely for occupancy/drain tracking; their
                        # activation records ride the sequential FIFO drain
                        # (the body's _activate delegation queues the inner
                        # ACTIVATE commands unprocessed), so the spawned
                        # device tokens are NOT tracked here — only the body
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
                            # fid < 0: synthetic link-jump edge — the target
                            # lives in out_target, no model flow exists
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

    def _emit_ops(self, inst: _Inst, ops: list, writers, builder,
                  source_position: int) -> None:
        """Interpret a trace, writing the instance's record burst in the
        sequential engine's FIFO follow-up order."""
        from zeebe_tpu_torch.engine.bpmn import _pi_value

        state = self.engine.state
        tables = self.registry.tables
        exe = inst.info.exe
        d = inst.info.index
        toks: dict[int, _Token] = dict(enumerate(inst.tokens))
        mi_inner_rows = {v: k for k, v in inst.info.mi_inner.items()}
        # device MI body keys whose COMPLETE_ELEMENT commands the drain must
        # leave for the body's own "done" op (reconstructed bodies up front;
        # in-burst activations join at their miarr)
        reserved_keys: set[int] = {
            t.key for t in inst.tokens
            if tables.kernel_op[d, t.elem_idx] == K_MI and t.key >= 0
        }
        # pure-device traces (the common case) never need the FIFO drain —
        # skip its O(follow_ups) scans wholesale. MI traces always drain:
        # inner-child activations and respawns ride the sequential FIFO.
        has_escapes = any(
            o[0] in ("hostarr", "miarr")
            or (o[0] == "done" and o[2] in mi_inner_rows)
            for o in ops
        )
        for op in ops:
            kind = op[0]
            if kind == "complete":
                if has_escapes:
                    self._drain_host_escapes(source_position, builder,
                                             reserved_keys=reserved_keys)
                self._emit_process_completed(inst, writers, builder)
                continue
            if kind == "hostarr":
                # the escaped element's ACTIVATE is the first unprocessed
                # command (escapes drain in arrival order): hand it to the
                # sequential engine at exactly this FIFO position
                self._drain_host_escapes(source_position, builder, limit=1,
                                         reserved_keys=reserved_keys)
                continue
            l, e = op[1], op[2]
            tok = toks[l]
            element = exe.elements[e]
            value = _pi_value(tok.value, element)
            if has_escapes and kind in ("arrive", "pass", "scopearr", "miarr",
                                        "nomatch") and tok.act_idx >= 0:
                # FIFO: escape cascades whose commands were appended before
                # this token's ACTIVATE must emit first (the sequential batch
                # loop would have processed them before reaching it)
                self._drain_host_escapes(source_position, builder,
                                         end_idx=tok.act_idx,
                                         reserved_keys=reserved_keys)
            elif has_escapes and kind == "done":
                # a mid-trace completion (scope drain) appends its COMPLETE
                # command at the queue's end — everything pending goes first
                self._drain_host_escapes(source_position, builder,
                                         reserved_keys=reserved_keys)
            if kind == "miarr":
                # MI body activation: delegate to the sequential activation
                # wholesale (MultiInstanceBodyProcessor parity) — ACTIVATING,
                # collection evaluation, ACTIVATED, output-collection seed,
                # and the inner ACTIVATE commands, which stay UNPROCESSED:
                # the FIFO drain activates each child at its exact sequential
                # position while the device's spawned tokens (untracked here)
                # park at the inner row for drain accounting
                reserved_keys.add(tok.key)
                self.engine.bpmn._activate(tok.key, dict(tok.value), exe,
                                           element, writers)
                continue
            if kind == "arrive":
                if element.element_type == BpmnElementType.EVENT_BASED_GATEWAY:
                    # delegate to the sequential activation wholesale: its
                    # pre-validation/incident handling and subscribe-before-
                    # ACTIVATED ordering must match record for record
                    self.engine.bpmn._activate(tok.key, dict(tok.value), exe,
                                               element, writers)
                    continue
                writers.append_event(tok.key, ValueType.PROCESS_INSTANCE,
                                     PI.ELEMENT_ACTIVATING, value)
                if element.inputs:
                    # input mappings create the element's local scope between
                    # ACTIVATING and the boundary subscriptions (mirror
                    # _activate's ordering; eligibility admits only safe
                    # expressions, so failure is unreachable — handled
                    # defensively by parking the element ACTIVATING exactly
                    # like the sequential incident path)
                    if not self.engine.bpmn._apply_input_mappings(
                            tok.key, value, element, writers,
                            context_key=value.get("flowScopeKey", -1)):
                        continue
                if element.boundary_idxs:
                    # boundary subscriptions attach between ACTIVATING and
                    # ACTIVATED (mirror BpmnProcessor._activate's ordering)
                    self.engine.bpmn._open_boundary_subscriptions(
                        tok.key, value, exe, element, writers
                    )
                writers.append_event(tok.key, ValueType.PROCESS_INSTANCE,
                                     PI.ELEMENT_ACTIVATED, value)
                if element.element_type in (BpmnElementType.INTERMEDIATE_CATCH_EVENT,
                                            BpmnElementType.RECEIVE_TASK):
                    # mirror BpmnProcessor._activate's catch branch: open the
                    # wait state (timer / message subscription) on the host —
                    # expressions evaluate against live variable state, and a
                    # failure raises the same incident and parks the element
                    bpmn = self.engine.bpmn
                    if element.timer_duration is not None:
                        bpmn._create_timer(tok.key, value, element, element, writers)
                    elif element.signal_name is not None:
                        bpmn._open_signal_subscription(tok.key, value, element,
                                                       writers)
                    else:
                        bpmn._open_message_subscription(tok.key, value, element,
                                                        element, writers)
                else:
                    self._emit_job_created(inst, tok, element, writers)
            elif kind == "done":
                if e in mi_inner_rows:
                    # MI inner completion (job-complete resume): delegate to
                    # the sequential completion with the BODY element (it
                    # carries the loop characteristics) — COMPLETING, output
                    # collection element, sequential-collection validation,
                    # COMPLETED, and _on_mi_inner_completed's follow-up (the
                    # next inner ACTIVATE, or the body's COMPLETE_ELEMENT —
                    # both unprocessed: the respawn drains FIFO and the body
                    # command is reserved for the body's own "done" op)
                    body_el = exe.elements[mi_inner_rows[e]]
                    ei = state.element_instances.get(tok.key)
                    ivalue = dict(ei["value"]) if ei is not None else dict(tok.value)
                    self.engine.bpmn._complete(tok.key, ivalue, exe, body_el,
                                               writers)
                    continue
                if element.multi_instance is not None:
                    # MI body completion: the COMPLETE_ELEMENT command was
                    # appended by the last inner's completion cascade and
                    # reserved from the drain — pair with it here, then
                    # mirror _complete's is_mi_body tail (COMPLETING, output
                    # collection propagation, COMPLETED); the outgoing flows
                    # ride the device ("flow" ops)
                    for entry in builder.follow_ups:
                        if (entry.record.is_command and not entry.processed
                                and entry.record.value_type == ValueType.PROCESS_INSTANCE
                                and int(entry.record.intent) == int(PI.COMPLETE_ELEMENT)
                                and entry.record.key == tok.key):
                            entry.processed = True
                            break
                    else:
                        logger.error(
                            "MI body %s done on device without a pending "
                            "COMPLETE_ELEMENT — decode divergence", element.id)
                        continue
                    ei = state.element_instances.get(tok.key)
                    bvalue = _pi_value(
                        dict(ei["value"]) if ei is not None else dict(tok.value),
                        element)
                    writers.append_event(tok.key, ValueType.PROCESS_INSTANCE,
                                         PI.ELEMENT_COMPLETING, bvalue)
                    mi = element.multi_instance
                    if mi.output_collection:
                        collection = state.variables.get_local(
                            tok.key, mi.output_collection)
                        if collection is not None:
                            self.engine.bpmn._write_variable(
                                writers, bvalue.get("flowScopeKey", -1),
                                bvalue, mi.output_collection, collection)
                    writers.append_event(tok.key, ValueType.PROCESS_INSTANCE,
                                         PI.ELEMENT_COMPLETED, bvalue)
                    continue
                if element.element_type == BpmnElementType.PROCESS:
                    # child-root placeholder drained: the called process
                    # instance completes. Delegate to the sequential PROCESS
                    # completion wholesale — COMPLETING, subscription close,
                    # child locals, COMPLETED, then _on_process_completed's
                    # variable propagation into the caller plus the call
                    # activity's COMPLETE_ELEMENT command (which the call
                    # row's own "done" op pairs with one step later)
                    writers.append_command(tok.key, ValueType.PROCESS_INSTANCE,
                                           PI.COMPLETE_ELEMENT, {})
                    self._mark_last_command_processed(builder)
                    self.engine.bpmn._complete(tok.key, dict(tok.value), exe,
                                               element, writers)
                    self._mark_last_command_processed(builder)
                    continue
                if element.element_type == BpmnElementType.SUB_PROCESS:
                    # scope drain completes through an internal command, like
                    # the process root (mirror _check_scope_completion →
                    # COMPLETE_ELEMENT → _complete)
                    writers.append_command(tok.key, ValueType.PROCESS_INSTANCE,
                                           PI.COMPLETE_ELEMENT, {})
                    self._mark_last_command_processed(builder)
                writers.append_event(tok.key, ValueType.PROCESS_INSTANCE,
                                     PI.ELEMENT_COMPLETING, value)
                if element.outputs:
                    # output mappings run between COMPLETING and the
                    # subscription close (mirror _complete's ordering).
                    # Eligibility admits only safe expressions, so failure
                    # is unreachable; if it ever happened the element stays
                    # COMPLETING with the incident, and the already-routed
                    # downstream tokens would diverge — log loudly.
                    if not self.engine.bpmn._apply_output_mappings(
                            tok.key, value, element, writers):
                        logger.error(
                            "output mapping failed on kernel path for %s — "
                            "routing already committed; incident raised",
                            element.id)
                        continue
                if element.boundary_idxs:
                    # mirror _complete: subscriptions close between COMPLETING
                    # and COMPLETED (TIMER CANCELED / subscription DELETED)
                    self.engine.bpmn._close_subscriptions(tok.key, value, writers)
                writers.append_event(tok.key, ValueType.PROCESS_INSTANCE,
                                     PI.ELEMENT_COMPLETED, value)
            elif kind == "scopearr":
                seg = inst.info.call_segment(e)
                if seg is not None:
                    # call activity activation: delegate to the sequential
                    # CALL_ACTIVITY handler wholesale (ACTIVATING, ACTIVATED,
                    # the child root's ACTIVATE command, variable propagation
                    # events — CallActivityProcessor parity), then bind the
                    # spawned device token to the child-root command
                    mark = len(builder.follow_ups)
                    self.engine.bpmn._activate(tok.key, dict(tok.value), exe,
                                               element, writers)
                    child_entry = None
                    child_at = -1
                    for i in range(mark, len(builder.follow_ups)):
                        entry = builder.follow_ups[i]
                        if (entry.record.is_command
                                and entry.record.value_type == ValueType.PROCESS_INSTANCE):
                            child_entry, child_at = entry, i
                            break
                    if child_entry is None:
                        # incident (called definition vanished — admission
                        # freshness makes this unreachable): the device token
                        # parks forever and the sequential path owns the call
                        continue
                    child_entry.processed = True
                    toks[op[3]] = _Token(slot=-1, elem_idx=seg.root_row,
                                         key=child_entry.record.key,
                                         value=dict(child_entry.record.value),
                                         act_idx=child_at)
                    continue
                # embedded sub-process activation: ACTIVATING/ACTIVATED, then
                # the inner none-start activates via an internal command with
                # the scope instance as its flow scope (mirror _activate's
                # SUB_PROCESS branch → _write_activate). Child-root
                # placeholder rows (non-root PROCESS elements) share this
                # path: their element copy stamps the child process shape
                writers.append_event(tok.key, ValueType.PROCESS_INSTANCE,
                                     PI.ELEMENT_ACTIVATING, value)
                if element.idx in inst.info.scope_esp_waits:
                    # child-root placeholder with root ESPs: open the start
                    # subscriptions between ACTIVATING and ACTIVATED via the
                    # sequential behavior verbatim (inlining admits only
                    # expression-free/static starts, so failure is
                    # unreachable on state identical to the sequential run)
                    if not self.engine.bpmn._open_scope_event_subscriptions(
                            tok.key, value, exe, element, writers):
                        logger.error(
                            "inlined child ESP subscription open failed for "
                            "%s — instance %s left ACTIVATING",
                            element.id, tok.key)
                        continue
                writers.append_event(tok.key, ValueType.PROCESS_INSTANCE,
                                     PI.ELEMENT_ACTIVATED, value)
                start = exe.elements[element.child_start_idx]
                child_key = state.next_key()
                child_value = self._child_value(value, start, tok.key)
                writers.append_command(child_key, ValueType.PROCESS_INSTANCE,
                                       PI.ACTIVATE_ELEMENT, child_value)
                if tables.kernel_op[d, start.idx] == K_HOST:
                    # escaped inner start: the spawned device token parks
                    # silently; the drain owns the scope's inside from here
                    continue
                self._mark_last_command_processed(builder)
                toks[op[3]] = _Token(slot=-1, elem_idx=start.idx,
                                     key=child_key, value=child_value,
                                     act_idx=len(builder.follow_ups) - 1)
            elif kind == "pass":
                writers.append_event(tok.key, ValueType.PROCESS_INSTANCE,
                                     PI.ELEMENT_ACTIVATING, value)
                writers.append_event(tok.key, ValueType.PROCESS_INSTANCE,
                                     PI.ELEMENT_ACTIVATED, value)
                if element.script_expression is not None:
                    # expression script task: evaluate + write the result
                    # between ACTIVATED and COMPLETING, mirroring
                    # BpmnProcessor._activate's script branch. Eligibility
                    # admits only never-raises expressions, so failure is
                    # unreachable; if it ever happened the sequential path
                    # would raise an incident and the element would stay
                    # ACTIVATED — log loudly, since downstream device ops
                    # would then diverge.
                    context = state.variables.collect(tok.key)
                    try:
                        result = element.script_expression.evaluate(
                            context, self.engine.clock_millis)
                    except FeelEvalError:
                        logger.error(
                            "safe script expression raised for %s — "
                            "instance %s left ACTIVATED", element.id, tok.key)
                        continue
                    if element.script_result_variable:
                        self.engine.bpmn._write_variable(
                            writers, value.get("flowScopeKey", -1), value,
                            element.script_result_variable, result)
                writers.append_event(tok.key, ValueType.PROCESS_INSTANCE,
                                     PI.ELEMENT_COMPLETING, value)
                writers.append_event(tok.key, ValueType.PROCESS_INSTANCE,
                                     PI.ELEMENT_COMPLETED, value)
            elif kind == "flow":
                fo, new_l = op[3], op[4]
                fid = int(tables.out_flow_idx[d, e, fo])
                if fid < 0:
                    # synthetic link-jump edge: no SEQUENCE_FLOW_TAKEN — the
                    # catch activates directly (engine _complete link branch)
                    target_idx = int(tables.out_target[d, e, fo])
                else:
                    flow = exe.flows[fid]
                    target_idx = flow.target_idx
                    flow_value = {
                        "bpmnProcessId": value["bpmnProcessId"],
                        "version": value["version"],
                        "processDefinitionKey": value["processDefinitionKey"],
                        "processInstanceKey": value["processInstanceKey"],
                        "elementId": flow.id,
                        "flowScopeKey": value.get("flowScopeKey", -1),
                        "bpmnElementType": BpmnElementType.SEQUENCE_FLOW.name,
                        "bpmnEventType": BpmnEventType.UNSPECIFIED.name,
                    }
                    flow_key = state.next_key()
                    writers.append_event(flow_key, ValueType.PROCESS_INSTANCE,
                                         PI.SEQUENCE_FLOW_TAKEN, flow_value)
                if new_l >= 0:
                    target = exe.elements[target_idx]
                    child_key = state.next_key()
                    child_value = self._child_value(value, target,
                                                    value.get("flowScopeKey", -1))
                    writers.append_command(child_key, ValueType.PROCESS_INSTANCE,
                                           PI.ACTIVATE_ELEMENT, child_value)
                    if tables.kernel_op[d, target.idx] == K_HOST:
                        # host escape: leave the ACTIVATE unprocessed — the
                        # post-trace drain hands it (and its whole follow-up
                        # chain) to the sequential engine
                        continue
                    self._mark_last_command_processed(builder)
                    toks[new_l] = _Token(slot=-1, elem_idx=target.idx,
                                         key=child_key, value=child_value,
                                         act_idx=len(builder.follow_ups) - 1)
            elif kind == "nomatch":
                writers.append_event(tok.key, ValueType.PROCESS_INSTANCE,
                                     PI.ELEMENT_ACTIVATING, value)
                writers.append_event(tok.key, ValueType.PROCESS_INSTANCE,
                                     PI.ELEMENT_ACTIVATED, value)
                writers.append_event(tok.key, ValueType.PROCESS_INSTANCE,
                                     PI.ELEMENT_COMPLETING, value)
                incident_key = state.next_key()
                writers.append_event(
                    incident_key, ValueType.INCIDENT, IncidentIntent.CREATED,
                    {
                        "errorType": ErrorType.CONDITION_ERROR.name,
                        "errorMessage": (
                            "Expected at least one condition to evaluate to true, "
                            f"or to have a default flow at gateway '{element.id}'"
                        ),
                        "bpmnProcessId": value.get("bpmnProcessId", ""),
                        "processDefinitionKey": value.get("processDefinitionKey", -1),
                        "processInstanceKey": value.get("processInstanceKey", -1),
                        "elementId": value.get("elementId", ""),
                        "elementInstanceKey": tok.key,
                        "jobKey": -1,
                        "variableScopeKey": tok.key,
                    },
                )

    def _emit_job_created(self, inst: _Inst, tok: _Token, element: ExecutableElement,
                          writers) -> None:
        """Mirror BpmnProcessor._activate's job-worker task branch."""
        state = self.engine.state
        value = tok.value
        job_key = state.next_key()
        writers.append_event(
            job_key, ValueType.JOB, JobIntent.CREATED,
            {
                "type": inst.info.job_types[element.idx],
                "retries": inst.info.job_retries[element.idx],
                "worker": "",
                "deadline": -1,
                "variables": {},
                "customHeaders": element.task_headers,
                "elementId": element.id,
                "elementInstanceKey": tok.key,
                "processInstanceKey": value["processInstanceKey"],
                "processDefinitionKey": value["processDefinitionKey"],
                "processDefinitionVersion": value["version"],
                "bpmnProcessId": value["bpmnProcessId"],
                "errorMessage": "",
            },
        )

    def _emit_process_completed(self, inst: _Inst, writers, builder) -> None:
        """Mirror _check_scope_completion → COMPLETE_ELEMENT(process) →
        _complete(process) → _on_process_completed."""
        from zeebe_tpu_torch.engine.bpmn import _pi_value

        state = self.engine.state
        bpmn = self.engine.bpmn
        root = state.element_instances.get(inst.pi_key)
        if root is None:
            return
        writers.append_command(inst.pi_key, ValueType.PROCESS_INSTANCE,
                               PI.COMPLETE_ELEMENT, {})
        self._mark_last_command_processed(builder)
        process_el = inst.info.exe.root
        value = _pi_value(dict(root["value"]), process_el)
        writers.append_event(inst.pi_key, ValueType.PROCESS_INSTANCE,
                             PI.ELEMENT_COMPLETING, value)
        if inst.info.root_esp_start_idxs:
            # mirror _complete: root ESP start subscriptions close when the
            # process leaves ACTIVATED
            bpmn._close_subscriptions(inst.pi_key, value, writers)
        child_locals = state.variables.locals_of(inst.pi_key)
        writers.append_event(inst.pi_key, ValueType.PROCESS_INSTANCE,
                             PI.ELEMENT_COMPLETED, value)
        bpmn._on_process_completed(inst.pi_key, value, child_locals or {}, writers)
        inst.done_emitted = True
    # end of the copy


#: the group bucket rounding (the backend's)
_pow2 = KernelBackend._pow2
