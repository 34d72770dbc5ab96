"""Deploy-time compilation: ExecutableProcess → dense device tables.

This is the TPU-native re-expression of the reference's per-record interpreter
(BASELINE.json north star): at deploy time each process graph is lowered to
static int32 arrays — element opcodes, CSR flow adjacency, join arities — and
every FEEL sequence-flow condition is compiled to a fixed-length stack program
over per-instance variable slots holding 64-bit IEEE-754 total-order keys as
two int32 planes — device comparisons are bit-exact against the host's
float64 FEEL evaluator. The automaton kernel
(zeebe_tpu_torch.ops.automaton) then advances thousands of instances lock-step with
no Python in the loop: a token's behavior is a predicated gather over these
tables, the BpmnElementProcessor switch becomes masked vector ops.

Multiple process definitions share one table set (padded to the max element
count) so a mixed workload (BASELINE config #5) runs in a single kernel:
``definition_of_instance`` selects each instance's row block.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from zeebe_tpu_torch.feel import feel as F
from zeebe_tpu_torch.models.bpmn import ExecutableProcess
from zeebe_tpu_torch.protocol.enums import BpmnElementType, BpmnEventType

# condition VM opcodes
OP_NOP = 0
OP_PUSH_CONST = 1
OP_PUSH_VAR = 2
OP_LT = 3
OP_LE = 4
OP_GT = 5
OP_GE = 6
OP_EQ = 7
OP_NE = 8
OP_AND = 9
OP_OR = 10
OP_NOT = 11
# 12..15 were arithmetic (ADD/SUB/MUL/DIV) before the order-key plane
# encoding; arithmetic cannot run in key space and host-escapes at compile
# time, so the opcodes are retired — the VM treats the gap as invalid
OP_NEG = 16

MAX_PROG_LEN = 24
STACK_DEPTH = 8


class ConditionNotCompilable(Exception):
    """Condition uses features outside the device subset (strings, lists,
    functions) — the element falls back to host evaluation."""


@dataclasses.dataclass
class SlotMap:
    """Variable name → device slot assignment (shared across a table set).
    Each slot has a kind: ``num`` (the float value itself) or ``str`` (an
    interned string id, see StringInterner) — a variable used both ways in
    conditions cannot ride the device path."""

    names: dict[str, int] = dataclasses.field(default_factory=dict)
    kinds: dict[str, str] = dataclasses.field(default_factory=dict)

    def slot(self, name: str, kind: str = "num") -> int:
        existing = self.kinds.get(name)
        if existing is not None and existing != kind:
            raise ConditionNotCompilable(
                f"variable {name!r} used in both numeric and string comparisons"
            )
        self.kinds[name] = kind
        if name not in self.names:
            self.names[name] = len(self.names)
        return self.names[name]

    @property
    def count(self) -> int:
        return max(1, len(self.names))


# ---------------------------------------------------------------------------
# Exact slot encoding: every slot value is a 64-bit ORDER KEY split into two
# int32 planes (hi, lo). Numeric values use the IEEE-754 total-order key of
# their float64 bits, so device comparisons are BIT-EXACT against the host's
# float64 FEEL evaluator — there is no float32 rounding anywhere on the
# device path. String values use their interned id (assigned in sorted
# order, so id order == lexicographic order for strings the tables know).
# Arithmetic inside conditions cannot run in key space and host-escapes the
# gateway instead (ConditionNotCompilable), which is what deletes the old
# "float32 within ~1e-7 of the boundary" divergence.

_U64 = np.uint64
_SIGN64 = _U64(1) << _U64(63)
_BIAS32 = np.uint32(0x80000000)

# String encoding: literal j (sorted order) → key 2j; a runtime string the
# tables never saw → 2·bisect(literals, s) − 1, i.e. an ODD key strictly
# between its lexicographic neighbors. Every comparison of a variable
# against a LITERAL is then exact (EQ: odd keys never equal even literal
# keys; order: insertion rank sits on the correct side of every literal).
# Var-vs-var string comparisons never lower: the compiler only types a slot
# "str" when the comparison's other side is a string literal, so `a = b`
# types both as numeric — admission then declines string values (or the
# gateway host-escapes on a kind conflict). Two unknown strings therefore
# never meet on device, where their colliding odd keys would diverge.


def f64_exact(v) -> bool:
    """True when ``v`` is exactly representable as a float64 (ints beyond
    2^53 collapse into a neighbor; host FEEL compares Python ints exactly,
    so such values must never be lowered to an order key)."""
    if type(v) is not int:
        return True
    try:
        return int(float(v)) == v
    except OverflowError:
        return False


def f64_key_planes(x: float) -> tuple[int, int]:
    """float64 → (hi, lo) int32 planes of its total-order key. Monotone:
    x < y  ⟺  (hi_x, lo_x) < (hi_y, lo_y) lexicographically (signed)."""
    v = np.float64(x)
    if np.isnan(v):
        raise ValueError("NaN has no order key")
    if v == 0.0:
        v = np.float64(0.0)  # canonicalize -0.0
    b = v.view(_U64)
    k = ~b if (b & _SIGN64) else (b | _SIGN64)
    hi = np.int32((np.uint32(k >> _U64(32)) ^ _BIAS32).astype(np.int32))
    lo = np.int32((np.uint32(k & _U64(0xFFFFFFFF)) ^ _BIAS32).astype(np.int32))
    return int(hi), int(lo)


def pack_slot_values(values: np.ndarray) -> np.ndarray:
    """Vectorized ``f64_key_planes``: float array [...] → int32 [..., 2]."""
    v = np.asarray(values, np.float64)
    v = np.where(v == 0.0, 0.0, v)  # canonicalize -0.0
    b = v.view(_U64)
    neg = (b & _SIGN64).astype(bool)
    k = np.where(neg, ~b, b | _SIGN64)
    hi = ((k >> _U64(32)).astype(np.uint32) ^ _BIAS32).astype(np.int32)
    lo = ((k & _U64(0xFFFFFFFF)).astype(np.uint32) ^ _BIAS32).astype(np.int32)
    return np.stack([hi, lo], axis=-1)


def str_key_planes(interned_id: int) -> tuple[int, int]:
    """Interned string id → (hi, lo) planes: literal j maps to key 2j (the
    odd keys in between belong to unknown runtime strings)."""
    return 2 * int(interned_id), 0


@dataclasses.dataclass
class StringInterner:
    """String literal → device id (the host variable-store ↔ device-slot
    split of SURVEY §7 hard part (c): documents stay host-side; conditions
    read prefetched slots holding either the numeric order key or the
    interned id of the string value). Ids are assigned in SORTED order over
    the full literal set (compile_tables pre-pass), so id comparisons agree
    with lexicographic string comparisons for known strings."""

    ids: dict[str, int] = dataclasses.field(default_factory=dict)
    _sorted: list[str] = dataclasses.field(default_factory=list)

    def intern_sorted(self, values: set[str]) -> None:
        """Assign ids for the whole literal set at once, lexicographically."""
        self._sorted = sorted(values | set(self.ids))
        for i, v in enumerate(self._sorted):
            self.ids[v] = i

    def intern(self, value: str) -> int:
        idx = self.ids.get(value)
        if idx is None:
            raise ConditionNotCompilable(
                f"string literal {value!r} missing from the interner pre-pass"
            )
        return idx

    def id_of(self, value: str) -> int | None:
        """Runtime lookup: None = the tables never saw this string."""
        return self.ids.get(value)

    def order_key_of(self, value: str) -> tuple[int, bool]:
        """Runtime string → (order-key hi plane, known). Known literal j →
        2j; unknown → the odd insertion-rank key between its neighbors."""
        import bisect

        idx = self.ids.get(value)
        if idx is not None:
            return 2 * idx, True
        return 2 * bisect.bisect_left(self._sorted, value) - 1, False


def collect_condition_strings(ast) -> set[str]:
    """Pre-pass: every string literal in a condition AST (the interner
    assigns sorted ids over the union before compilation)."""
    out: set[str] = set()

    def walk(node) -> None:
        if isinstance(node, F.Lit) and isinstance(node.value, str):
            out.add(node.value)
        elif isinstance(node, F.Bin):
            walk(node.left)
            walk(node.right)
        elif isinstance(node, F.Unary):
            walk(node.operand)
        elif isinstance(node, F.Call):
            for a in node.args:
                walk(a)

    walk(ast)
    return out


def compile_condition(ast, slots: SlotMap,
                      interner: StringInterner | None = None,
                      ) -> list[tuple[int, int, int]]:
    """Lower a FEEL AST to a postfix stack program over (hi, lo) order-key
    planes. Raises ConditionNotCompilable for constructs outside the device
    subset.

    The compile is TYPED: comparisons take value operands (variable slots,
    numeric/string/bool literals) and produce booleans; and/or/not take
    booleans only (matching host FEEL semantics, where `1.0 and true` is
    null — the old untyped min/max lowering silently diverged there).
    Arithmetic (+ - * /) cannot run in order-key space and host-escapes —
    which is exactly what makes every device comparison bit-exact against
    the host float64 evaluator."""
    prog: list[tuple[int, int, int]] = []

    def is_str_lit(node) -> bool:
        return isinstance(node, F.Lit) and isinstance(node.value, str)

    def emit_value(node) -> str:
        """Emit a value operand; returns its kind: 'num' or 'str'."""
        if isinstance(node, F.Lit):
            v = node.value
            if isinstance(v, bool):
                prog.append((OP_PUSH_CONST, *f64_key_planes(1.0 if v else 0.0)))
                return "num"
            if isinstance(v, (int, float)):
                if not f64_exact(v):
                    # not float64-representable (beyond 2^53): the key would
                    # be the rounded neighbor's and EQ against the true value
                    # would diverge from the host's exact int comparison
                    raise ConditionNotCompilable(f"int literal {v} beyond f64")
                prog.append((OP_PUSH_CONST, *f64_key_planes(float(v))))
                return "num"
            if isinstance(v, str):
                if interner is None:
                    raise ConditionNotCompilable("string literal (no interner)")
                prog.append((OP_PUSH_CONST, *str_key_planes(interner.intern(v))))
                return "str"
            raise ConditionNotCompilable(f"literal {v!r}")
        if isinstance(node, F.Var):
            if len(node.path) != 1:
                raise ConditionNotCompilable(f"path {node.path}")
            # kind is fixed by the comparison partner via _slot_kind below;
            # a bare var defaults to numeric
            prog.append((OP_PUSH_VAR, slots.slot(node.path[0], kind="num"), 0))
            return "num"
        if isinstance(node, F.Unary):
            operand = node.operand
            if isinstance(operand, F.Lit) and isinstance(operand.value, (int, float)) \
                    and not isinstance(operand.value, bool):
                ov = operand.value
                if not f64_exact(ov):
                    raise ConditionNotCompilable(f"int literal {ov} beyond f64")
                # constant-fold: push the key of the negated literal
                prog.append((OP_PUSH_CONST, *f64_key_planes(-float(ov))))
                return "num"
            kind = emit_value(operand)
            if kind != "num":
                raise ConditionNotCompilable("unary minus on non-number")
            prog.append((OP_NEG, 0, 0))
            return "num"
        raise ConditionNotCompilable(type(node).__name__)

    def emit_comparison(node) -> None:
        # a slot is typed "str" ONLY opposite a string literal, so device
        # programs never compare two string slots with each other (see the
        # string-encoding note above — unknown odd keys must not meet)
        str_side = is_str_lit(node.left) or is_str_lit(node.right)
        if str_side:
            if interner is None:
                raise ConditionNotCompilable("string literal (no interner)")
            for operand in (node.left, node.right):
                if is_str_lit(operand):
                    prog.append((OP_PUSH_CONST, *str_key_planes(interner.intern(operand.value))))
                elif isinstance(operand, F.Var) and len(operand.path) == 1:
                    prog.append((OP_PUSH_VAR, slots.slot(operand.path[0], kind="str"), 0))
                else:
                    raise ConditionNotCompilable("string comparison operand")
        else:
            emit_value(node.left)
            emit_value(node.right)
        cmp_ops = {"<": OP_LT, "<=": OP_LE, ">": OP_GT, ">=": OP_GE,
                   "=": OP_EQ, "!=": OP_NE}
        prog.append((cmp_ops[node.op], 0, 0))

    def emit_bool(node) -> None:
        if isinstance(node, F.Lit) and isinstance(node.value, bool):
            prog.append((OP_PUSH_CONST, 1 if node.value else 0, 0))
            return
        if isinstance(node, F.Call) and node.name == "not" and len(node.args) == 1:
            emit_bool(node.args[0])
            prog.append((OP_NOT, 0, 0))
            return
        if isinstance(node, F.Bin):
            if node.op in ("and", "or"):
                emit_bool(node.left)
                emit_bool(node.right)
                prog.append((OP_AND if node.op == "and" else OP_OR, 0, 0))
                return
            if node.op in ("<", "<=", ">", ">=", "=", "!="):
                emit_comparison(node)
                return
            raise ConditionNotCompilable(f"operator {node.op}")
        raise ConditionNotCompilable(f"non-boolean condition {type(node).__name__}")

    emit_bool(ast)
    if len(prog) > MAX_PROG_LEN:
        raise ConditionNotCompilable(f"program too long ({len(prog)})")
    return prog


# device opcodes per element behavior (indexes the kernel's behavior masks)
K_NONE = 0  # unused slot / process root
K_PASS = 1  # pass-through: start/end/manual/undefined/throw events
K_TASK = 2  # job-worker task: wait for job completion
K_EXCLUSIVE = 3  # exclusive gateway: conditional routing
K_FORK = 4  # parallel gateway, fan-out
K_JOIN = 5  # parallel gateway, fan-in (in_count > 1)
K_END = 6  # end event: token dies, instance may complete
K_CATCH = 7  # intermediate catch (timer/message): wait for host trigger/correlation
K_SCOPE = 8  # embedded sub-process: spawn inner token, park until scope drains
K_HOST = 9  # host escape: parks forever; the sequential engine owns the element
#            (script/io-mapping tasks, unresolvable call activities, …)
K_MI = 10  # multi-instance body: parks like a scope, spawns mi_left children
#           at its inner row (scope_start); sequential bodies respawn on drain
K_INCLUSIVE = 11  # inclusive gateway (fork-only, like the reference): takes
#                  EVERY true-condition flow; default only when none hold

# task types a synthetic device MI body may wrap (the inner instance is a
# job-worker task; MI on containers stays host-side)
_MI_BODY_TYPES = frozenset((
    BpmnElementType.SERVICE_TASK,
    BpmnElementType.SEND_TASK,
    BpmnElementType.SCRIPT_TASK,
    BpmnElementType.BUSINESS_RULE_TASK,
    BpmnElementType.USER_TASK,
))

_KERNEL_OP = {
    BpmnElementType.START_EVENT: K_PASS,
    BpmnElementType.MANUAL_TASK: K_PASS,
    BpmnElementType.TASK: K_PASS,
    BpmnElementType.INTERMEDIATE_THROW_EVENT: K_PASS,
    BpmnElementType.END_EVENT: K_END,
    BpmnElementType.SERVICE_TASK: K_TASK,
    BpmnElementType.SEND_TASK: K_TASK,
    BpmnElementType.SCRIPT_TASK: K_TASK,
    BpmnElementType.BUSINESS_RULE_TASK: K_TASK,
    BpmnElementType.USER_TASK: K_TASK,
    BpmnElementType.EXCLUSIVE_GATEWAY: K_EXCLUSIVE,
    BpmnElementType.INCLUSIVE_GATEWAY: K_INCLUSIVE,
    BpmnElementType.PARALLEL_GATEWAY: K_FORK,  # switched to K_JOIN if in_count > 1
}


@dataclasses.dataclass
class ProcessTables:
    """Dense tables for a set of process definitions (numpy; the kernel moves
    them to device). Shapes: D definitions, E max elements, FL max flows,
    C conditions, FO max fan-out."""

    # per definition × element
    kernel_op: np.ndarray  # [D, E] int32
    in_count: np.ndarray  # [D, E] int32 (join arity)
    job_type: np.ndarray  # [D, E] int32, -1 = none
    out_count: np.ndarray  # [D, E] int32
    out_target: np.ndarray  # [D, E, FO] int32 (element idx, -1 pad)
    out_cond: np.ndarray  # [D, E, FO] int32 (condition row, -1 = unconditional)
    out_flow_idx: np.ndarray  # [D, E, FO] int32 (model flow idx, for events)
    default_slot: np.ndarray  # [D, E] int32 (slot in out_* arrays, -1 none)
    start_elem: np.ndarray  # [D] int32
    elem_count: np.ndarray  # [D] int32
    # embedded sub-process scopes
    scope_start: np.ndarray  # [D, E] int32 (inner none-start of a K_SCOPE, -1;
    #                          for K_MI bodies: the synthetic inner row)
    in_scope: np.ndarray  # [D, E, E] int8: [d, e, s] = e strictly inside scope s
    # multi-instance bodies: 1 = sequential (spawn next child only after the
    # previous drains); 0 = parallel (spawn every step until mi_left == 0)
    mi_sequential: np.ndarray  # [D, E] int8
    # condition programs (order-key planes: args carry (hi, lo) per step)
    cond_ops: np.ndarray  # [C, P] int32
    cond_args: np.ndarray  # [C, P, 2] int32
    # per definition: variable names its DEVICE-compiled conditions read
    # (host-escaped gateways excluded — their variables need no prefetch)
    cond_vars_by_def: list = dataclasses.field(default_factory=list)
    # bookkeeping
    slot_map: SlotMap = dataclasses.field(default_factory=SlotMap)
    interner: StringInterner = dataclasses.field(default_factory=StringInterner)
    job_type_names: list[str] = dataclasses.field(default_factory=list)
    definitions: list[ExecutableProcess] = dataclasses.field(default_factory=list)
    # static bound on live tokens per instance, max over the set's
    # definitions; 0 = no sound bound (a parallel split on a cycle can
    # multiply tokens per iteration) — callers then size the token pool
    # with the legacy 4x safety factor
    token_width: int = 0

    @property
    def num_definitions(self) -> int:
        return self.kernel_op.shape[0]

    @property
    def max_elements(self) -> int:
        return self.kernel_op.shape[1]

    @property
    def num_slots(self) -> int:
        return self.slot_map.count

    @property
    def kernel_config(self) -> "KernelConfig":
        return KernelConfig(
            has_joins=bool((self.kernel_op == 5).any()),  # K_JOIN
            has_conditions=bool((self.out_cond >= 0).any()),
            has_scopes=bool((self.kernel_op == 8).any()),  # K_SCOPE
            has_mi=bool((self.kernel_op == 10).any()),  # K_MI
        )


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Static (hashable) workload traits; lets XLA drop unused machinery —
    join ranking sorts, the condition VM, and the scope-occupancy reduction
    cost real time when the deployed process set never exercises them."""

    has_joins: bool = True
    has_conditions: bool = True
    has_scopes: bool = True
    has_mi: bool = False


def _live_token_width(exe: ExecutableProcess) -> int | None:
    """Sound static bound on concurrently live device tokens per instance of
    ``exe``: 1, plus (fanout-1) per parallel split, plus 1 per sub-process
    scope (the parked scope token coexists with its inner token). Additive,
    so nesting is covered.

    The per-element +1 assumes at most one concurrent activation of each
    element, which only holds when concurrency is structured. So the bound
    is claimed (non-None) only when, in the presence of parallel splits,
    every convergent element (incoming > 1) is a parallel join — an XOR
    merge downstream of a split can funnel two live tokens through one
    element (twice-activated sub-process / split), breaking the additive
    count. A parallel split on a cycle can mint tokens every iteration, so
    that also yields None. The kernel falls back to the 4x pool on None; an
    undersized pool would only cost a fallback (overflow is detected), but
    fallbacks re-run the whole group sequentially, so the bound must hold."""
    targets_of: dict[int, list[int]] = {}
    splits: list[ExecutableElement] = []
    for el in exe.elements:
        targets_of[el.idx] = [exe.flows[f].target_idx for f in el.outgoing]
        if el.link_target_idx >= 0:
            # link jumps continue the token like a flow — a backward link
            # closes a cycle the flow graph alone would not show
            targets_of[el.idx].append(el.link_target_idx)
        if (el.element_type in (BpmnElementType.PARALLEL_GATEWAY,
                                BpmnElementType.INCLUSIVE_GATEWAY)
                and len(el.outgoing) > 1):
            # an inclusive fork may take every branch — bound like a
            # parallel split
            splits.append(el)
    if splits:
        for el in exe.elements:
            if (el.incoming_count > 1
                    and el.element_type != BpmnElementType.PARALLEL_GATEWAY):
                return None  # unstructured convergence: element may run twice
    for el in exe.elements[1:]:
        if el.multi_instance is not None and el.child_start_idx >= 0:
            # a parallel MI body spawns cardinality-many children — no
            # static bound; callers size the pool from the predicted cards
            return None
    width = 1
    for el in exe.elements[1:]:
        # every scope container parks one token while its inside runs: embedded
        # sub-processes, and (synthetic inlined definitions) call activities
        # plus their child-root placeholder rows
        if el.element_type == BpmnElementType.SUB_PROCESS or (
            el.element_type in (BpmnElementType.CALL_ACTIVITY,
                                BpmnElementType.PROCESS)
            and el.child_start_idx >= 0
        ):
            width += 1
    for el in splits:
        # cycle check: DFS from the split's targets back to the split
        seen: set[int] = set()
        stack = list(targets_of[el.idx])
        while stack:
            n = stack.pop()
            if n == el.idx:
                return None
            if n in seen:
                continue
            seen.add(n)
            stack.extend(targets_of.get(n, ()))
        width += len(el.outgoing) - 1
    return width


def compile_tables(processes: list[ExecutableProcess], max_fanout: int | None = None,
                   host_idxs: list[set[int]] | None = None) -> ProcessTables:
    """Compile process definitions into one shared table set. ``max_fanout``
    defaults to the actual maximum across the definitions (smaller FO keeps
    the kernel's flattened placement arrays tight).

    ``host_idxs`` (one set of element idxs per definition) turns on the host
    escape: listed elements — and any element that fails to lower — compile
    to K_HOST instead of failing the whole definition. Without it, any
    non-lowerable element raises ConditionNotCompilable (the all-device
    contract the benchmarks and the bare-kernel tests rely on)."""
    if max_fanout is None:
        max_fanout = max(
            (len(el.outgoing) for p in processes for el in p.elements), default=1
        )
        max_fanout = max(max_fanout, 1)
    slots = SlotMap()
    interner = StringInterner()
    # pre-pass: intern ALL condition string literals in sorted order so id
    # comparisons agree with lexicographic string order
    all_strings: set[str] = set()
    for p in processes:
        for el in p.elements[1:]:
            for fidx in el.outgoing:
                cond = p.flows[fidx].condition
                if cond is not None:
                    all_strings |= collect_condition_strings(cond.ast)
    interner.intern_sorted(all_strings)
    job_types: dict[str, int] = {}
    cond_programs: list[list[tuple[int, int, int]]] = []

    D = len(processes)
    E = max(len(p.elements) for p in processes)
    kernel_op = np.zeros((D, E), np.int32)
    in_count = np.zeros((D, E), np.int32)
    job_type = np.full((D, E), -1, np.int32)
    out_count = np.zeros((D, E), np.int32)
    out_target = np.full((D, E, max_fanout), -1, np.int32)
    out_cond = np.full((D, E, max_fanout), -1, np.int32)
    out_flow_idx = np.full((D, E, max_fanout), -1, np.int32)
    default_slot = np.full((D, E), -1, np.int32)
    start_elem = np.zeros(D, np.int32)
    elem_count = np.zeros(D, np.int32)
    scope_start = np.full((D, E), -1, np.int32)
    in_scope = np.zeros((D, E, E), np.int8)
    mi_seq = np.zeros((D, E), np.int8)

    cond_vars_by_def: list[set[str]] = []
    for d, exe in enumerate(processes):
        elem_count[d] = len(exe.elements)
        start_elem[d] = exe.none_start_of(0)
        def_vars: set[str] = set()
        cond_vars_by_def.append(def_vars)
        host = set(host_idxs[d]) if host_idxs is not None else None
        for el in exe.elements[1:]:
            # structural info fills unconditionally: flows INTO a host-escaped
            # element still resolve their target through these arrays, and a
            # parked host token's incoming count is never read
            in_count[d, el.idx] = el.incoming_count
            if len(el.outgoing) > max_fanout:
                raise ConditionNotCompilable(f"fan-out {len(el.outgoing)} > {max_fanout}")
            out_count[d, el.idx] = len(el.outgoing)
            for slot_i, fidx in enumerate(el.outgoing):
                flow = exe.flows[fidx]
                out_target[d, el.idx, slot_i] = flow.target_idx
                out_flow_idx[d, el.idx, slot_i] = flow.idx
            if (
                el.element_type == BpmnElementType.INTERMEDIATE_THROW_EVENT
                and el.event_type == BpmnEventType.LINK
                and el.link_target_idx >= 0
                and not el.outgoing
            ):
                # link throw: synthetic edge to the same-scope catch link.
                # out_flow_idx = -1 marks it as a link jump — no sequence
                # flow exists, so decode emits the catch ACTIVATE without a
                # SEQUENCE_FLOW_TAKEN (engine _complete link branch parity)
                out_count[d, el.idx] = 1
                out_target[d, el.idx, 0] = el.link_target_idx
                out_flow_idx[d, el.idx, 0] = -1
            # scope chains of embedded sub-processes are supported (K_SCOPE),
            # and — in synthetic inlined definitions (kernel_backend
            # _inline_call_activities) — chains through CALL_ACTIVITY rows
            # and their non-root PROCESS placeholder rows; a chain through
            # any other container (event sub-process) means the element is
            # only reachable host-side
            chain: list[int] = []
            anc = el.parent_idx
            chain_ok = True
            while anc > 0:
                parent = exe.elements[anc]
                if parent.element_type not in (BpmnElementType.SUB_PROCESS,
                                               BpmnElementType.CALL_ACTIVITY,
                                               BpmnElementType.PROCESS) \
                        and not (parent.multi_instance is not None
                                 and parent.child_start_idx >= 0):
                    # synthetic K_MI bodies (kernel_backend._inline_mi_bodies)
                    # contain their inner row like a scope
                    chain_ok = False
                    break
                chain.append(anc)
                anc = parent.parent_idx
            if chain_ok:
                # committed even for host-escaped elements: a parked host
                # token inside a device scope must block that scope's drain
                for a in chain:
                    in_scope[d, el.idx, a] = 1
            try:
                if not chain_ok:
                    raise ConditionNotCompilable(
                        f"element inside {exe.elements[anc].element_type.name} scope"
                    )
                if host is not None and el.idx in host:
                    raise ConditionNotCompilable("host-escaped element")
                if getattr(el, "form_id", None) is not None:
                    # form resolution reads FormState at activation time (the
                    # formKey header depends on the latest deployed form)
                    raise ConditionNotCompilable("form-linked user task")
                if (el.element_type == BpmnElementType.SCRIPT_TASK
                        and el.script_expression is not None):
                    # expression-flavor script task: pass-through on device,
                    # evaluation + result write happen at decode (the
                    # job-worker flavor keeps K_TASK via _KERNEL_OP)
                    op = K_PASS
                elif el.event_type == BpmnEventType.LINK and el.element_type in (
                    BpmnElementType.INTERMEDIATE_THROW_EVENT,
                    BpmnElementType.INTERMEDIATE_CATCH_EVENT,
                ):
                    # link events are device pass-throughs: the throw rides
                    # its synthetic edge (filled above), the catch completes
                    # immediately and takes its real outgoing flows
                    op = K_PASS
                elif (el.element_type in (BpmnElementType.INTERMEDIATE_CATCH_EVENT,
                                          BpmnElementType.RECEIVE_TASK)) and (
                    (el.timer_duration is not None and not el.timer_cycle
                     and el.timer_date is None)
                    or el.message_name is not None
                    or el.signal_name is not None
                ):
                    # waits like a task; the host resumes it on TIMER TRIGGER /
                    # message correlation instead of job completion
                    op = K_CATCH
                elif el.element_type == BpmnElementType.BOUNDARY_EVENT:
                    # boundary events never receive device tokens spontaneously —
                    # triggers route through the sequential path (route_trigger),
                    # which terminates/continues via internal commands. The
                    # element only needs a valid opcode so definitions carrying
                    # boundaries still lower to tables.
                    op = K_PASS
                elif el.multi_instance is not None:
                    # synthetic MI body (kernel_backend._inline_mi_bodies):
                    # a TASK-type element whose child_start_idx names the
                    # synthetic inner row; parks like a scope and spawns
                    # mi_left children (ops/automaton K_MI). Real elements
                    # with loop characteristics (incl. MI sub-processes,
                    # whose child_start is their own scope start) are
                    # outside the device subset.
                    if (el.child_start_idx < 0
                            or el.element_type not in _MI_BODY_TYPES):
                        raise ConditionNotCompilable("multi-instance body")
                    op = K_MI
                    mi_seq[d, el.idx] = 1 if el.multi_instance.is_sequential else 0
                elif el.element_type in (BpmnElementType.SUB_PROCESS,
                                         BpmnElementType.CALL_ACTIVITY,
                                         BpmnElementType.PROCESS):
                    # CALL_ACTIVITY / non-root PROCESS rows exist only in
                    # synthetic inlined definitions: the call activity and
                    # its child-root placeholder both park as scopes over the
                    # inlined child rows (kernel_backend._inline_call_activities)
                    if el.child_start_idx < 0:
                        raise ConditionNotCompilable("scope without none start")
                    op = K_SCOPE
                elif el.element_type == BpmnElementType.EVENT_BASED_GATEWAY:
                    # parks like a catch; the first trigger routes through the
                    # sequential path (route_trigger → COMPLETE_ELEMENT with
                    # triggeredElementId), so the device never takes its flows
                    op = K_CATCH
                else:
                    op = _KERNEL_OP.get(el.element_type)
                if op is None:
                    raise ConditionNotCompilable(f"element type {el.element_type.name}")
                if el.element_type == BpmnElementType.PARALLEL_GATEWAY and el.incoming_count > 1:
                    op = K_JOIN
                if (
                    op in (K_EXCLUSIVE, K_INCLUSIVE)
                    and len(el.outgoing) == 1
                    and el.default_flow_idx < 0
                    and all(exe.flows[f].condition is None for f in el.outgoing)
                ):
                    # a single unconditional outgoing flow routes like a
                    # pass-through (the engine's generic completion path takes
                    # it; a conditional gateway with no true condition and no
                    # default would stall instead)
                    op = K_PASS
                for slot_i, fidx in enumerate(el.outgoing):
                    flow = exe.flows[fidx]
                    if fidx == el.default_flow_idx:
                        default_slot[d, el.idx] = slot_i
                    elif flow.condition is not None and op in (K_EXCLUSIVE,
                                                               K_INCLUSIVE):
                        prog = compile_condition(flow.condition.ast, slots, interner)
                        out_cond[d, el.idx, slot_i] = len(cond_programs)
                        cond_programs.append(prog)
                        id_to_name = {v: k for k, v in slots.names.items()}
                        def_vars.update(
                            id_to_name[int(hi)] for opc, hi, lo in prog
                            if opc == OP_PUSH_VAR
                        )
            except ConditionNotCompilable:
                if host is None:
                    raise
                # host escape: the device parks any token that reaches this
                # element and the sequential engine owns it from there —
                # the rest of the definition still rides the kernel
                host.add(el.idx)
                kernel_op[d, el.idx] = K_HOST
                out_cond[d, el.idx, :] = -1
                default_slot[d, el.idx] = -1
                continue
            kernel_op[d, el.idx] = op
            if op == K_SCOPE or op == K_MI:
                scope_start[d, el.idx] = el.child_start_idx
            if op == K_TASK and el.job_type is not None and el.job_type.is_static:
                name = el.job_type.source
                if name not in job_types:
                    job_types[name] = len(job_types)
                job_type[d, el.idx] = job_types[name]

    C = max(1, len(cond_programs))
    cond_ops = np.zeros((C, MAX_PROG_LEN), np.int32)
    cond_args = np.zeros((C, MAX_PROG_LEN, 2), np.int32)
    for ci, prog in enumerate(cond_programs):
        for pi, (op, hi, lo) in enumerate(prog):
            cond_ops[ci, pi] = op
            cond_args[ci, pi, 0] = hi
            cond_args[ci, pi, 1] = lo

    return ProcessTables(
        kernel_op=kernel_op,
        in_count=in_count,
        job_type=job_type,
        out_count=out_count,
        out_target=out_target,
        out_cond=out_cond,
        out_flow_idx=out_flow_idx,
        default_slot=default_slot,
        start_elem=start_elem,
        elem_count=elem_count,
        scope_start=scope_start,
        in_scope=in_scope,
        mi_sequential=mi_seq,
        cond_ops=cond_ops,
        cond_args=cond_args,
        cond_vars_by_def=cond_vars_by_def,
        slot_map=slots,
        interner=interner,
        job_type_names=list(job_types),
        definitions=list(processes),
        token_width=_set_token_width(processes),
    )


def _set_token_width(processes: list[ExecutableProcess]) -> int:
    widths = [_live_token_width(p) for p in processes]
    return 0 if None in widths else max(widths, default=1)
