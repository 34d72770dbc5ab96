"""The data-parallel BPMN automaton, in PyTorch, with its CUDA kernels.

The counterpart of ``zeebe_tpu/ops/automaton.py``: every live token of a
pool of ``T`` slots over ``I`` process instances advances one element pass
per lock-step, driven by the deploy-time tables of ``ops.tables``. The state
is a dict of tensors with the reference's names, dtypes and shapes (int32
arrays, bool flags, int32 scalar counters that wrap like JAX's).

Each of ``step``, ``run_collect`` and ``run_to_completion`` is a wrapper:

- a tensor on the CPU goes to the plain PyTorch version in this module
  (``step_plain`` and friends), which repeats the reference's arithmetic op
  for op and is held byte-for-byte against the JAX functions by the tests;
- a tensor on a CUDA device goes to the hand-written kernels of
  ``csrc/automaton.cu`` (built and bound by ``ops.kernels``). There is no
  fallback: a build or launch failure raises.

``ops.kernels`` counts the launches where it enqueues them (``launch_counts``
reads the counts): ``step`` counts every lock-step the host enqueues,
including those inside ``run_collect``; ``run_to_completion`` counts one per
call (its steps are decided on the device); ``grid_launch_counts`` reads the
CUDA grid launches behind them. ``step`` and ``run_collect`` take the fused
chunk (one launch per call) for groups of up to ``kernels.FUSED_MAX_TOKENS``
token slots and the chain of per-phase launches above that;
``run_to_completion`` takes the grid kernel (one launch per call).

``make_state``, ``complete_jobs``, ``DeviceTables.from_numpy`` and
``state_from_numpy`` are placement and small scatters and stay plain PyTorch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from zeebe_tpu_torch.ops import kernels
from zeebe_tpu_torch.ops.tables import (
    K_CATCH,
    K_EXCLUSIVE,
    K_HOST,
    K_INCLUSIVE,
    K_JOIN,
    K_MI,
    K_NONE,
    K_SCOPE,
    K_TASK,
    MAX_PROG_LEN,
    OP_AND,
    OP_EQ,
    OP_GE,
    OP_GT,
    OP_LE,
    OP_LT,
    OP_NE,
    OP_NOT,
    OP_OR,
    OP_PUSH_CONST,
    OP_PUSH_VAR,
    OP_NEG,
    STACK_DEPTH,
    KernelConfig,
    pack_slot_values,
)

# token phases
PHASE_AT = 0  # at element, executes this step
PHASE_WAIT = 1  # task activated, waiting for job completion
PHASE_DONE = 2  # job completed, finish task this step
PHASE_STALLED = 3  # incident raised; host must resolve

# bit-packed event layout bounds: elem rides col 0 in 14 bits, and dest
# (with its == T "no placement" sentinel) rides 16 bits of a dest|take
# column; callers must fall back beyond these. The active count is not
# bound — it travels as a full int32 tail scalar.
PACK_MAX_ELEMENTS = 1 << 14
PACK_MAX_TOKENS = (1 << 16) - 1

_I32 = torch.int32
_INT32_MIN = -(2**31)

# state keys and their dtypes (the reference's make_state)
STATE_DTYPES = {
    "elem": _I32, "phase": _I32, "inst": _I32, "def_of": _I32,
    "var_slots": _I32, "join_counts": _I32, "mi_left": _I32,
    "done": torch.bool, "incident": torch.bool,
    "transitions": _I32, "jobs_created": _I32, "completed": _I32,
    "overflow": torch.bool,
}


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for and missing: no
    entry point of the port runs on the CPU unless the caller says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _i32(x: torch.Tensor) -> torch.Tensor:
    """Integer sums and prefix sums come back as int64 in PyTorch; the
    reference keeps int32, so cast back (two's-complement wrap, as JAX's
    int32 accumulation gives)."""
    return x.to(_I32)


@dataclasses.dataclass
class DeviceTables:
    """ProcessTables' arrays as tensors on one device."""

    kernel_op: torch.Tensor  # [D, E] int32
    in_count: torch.Tensor  # [D, E] int32
    job_type: torch.Tensor  # [D, E] int32
    out_count: torch.Tensor  # [D, E] int32
    out_target: torch.Tensor  # [D, E, FO] int32
    out_cond: torch.Tensor  # [D, E, FO] int32
    out_flow_idx: torch.Tensor  # [D, E, FO] int32
    default_slot: torch.Tensor  # [D, E] int32
    start_elem: torch.Tensor  # [D] int32
    scope_start: torch.Tensor  # [D, E] int32
    in_scope: torch.Tensor  # [D, E, E] int8
    cond_ops: torch.Tensor  # [C, P] int32
    cond_args: torch.Tensor  # [C, P, 2] int32
    mi_sequential: torch.Tensor  # [D, E] int8

    @classmethod
    def from_numpy(cls, arrays, device=None) -> "DeviceTables":
        """Carry a table set across: ``arrays`` is a ProcessTables (from this
        package's ``compile_tables`` or the JAX package's) or a mapping of
        the same field names to numpy arrays."""
        dev = resolve_device(device)
        get = arrays.__getitem__ if isinstance(arrays, dict) else \
            lambda name: getattr(arrays, name)
        fields = {}
        for f in dataclasses.fields(cls):
            want = np.int8 if f.name in ("in_scope", "mi_sequential") else np.int32
            arr = np.asarray(get(f.name))
            if arr.dtype != want:
                raise ValueError(f"table {f.name} must be {np.dtype(want)}, "
                                 f"got {arr.dtype}")
            fields[f.name] = torch.from_numpy(np.array(arr, order="C")).to(dev)
        return cls(**fields)

    @property
    def device(self) -> torch.device:
        return self.kernel_op.device

    def to(self, device) -> "DeviceTables":
        """The same table set on ``device`` (this one where it already lies
        there): a mesh's groups on other cards take a replica."""
        dev = torch.device(device)
        if dev == self.device:
            return self
        return DeviceTables(**{f.name: getattr(self, f.name).to(dev)
                               for f in dataclasses.fields(self)})


def state_from_numpy(arrays: dict, device=None) -> dict:
    """A reference-side state dict (numpy arrays, e.g. ``np.asarray`` of the
    JAX state) → the port's state dict on ``device``. Dtypes must match the
    reference exactly."""
    dev = resolve_device(device)
    out = {}
    for key, dtype in STATE_DTYPES.items():
        arr = np.asarray(arrays[key])
        want = np.bool_ if dtype == torch.bool else np.int32
        if arr.dtype != want:
            raise ValueError(f"state {key} must be {np.dtype(want)}, got {arr.dtype}")
        # a copy: the source may be read-only (JAX buffers) and 0-d arrays
        # must stay 0-d (np.ascontiguousarray would make them 1-d)
        out[key] = torch.from_numpy(np.array(arr, order="C")).to(dev)
    return out


def _coerce_slot_planes(values) -> np.ndarray:
    """Slot input → int32 (hi, lo) plane array. A 3-D integer array is
    pre-packed planes (int64 inputs coerce with a range check); floats pack
    into order keys."""
    arr = np.asarray(values)
    if arr.ndim == 3:
        if arr.shape[-1] != 2:
            raise ValueError(f"pre-packed slot planes must have trailing dim 2, "
                             f"got {arr.shape}")
        if not np.issubdtype(arr.dtype, np.integer):
            raise ValueError("3-D slot input must be integer (hi, lo) planes; "
                             "pass floats as a 2-D [instances, slots] array")
        if arr.dtype != np.int32:
            out_of_range = (arr < np.iinfo(np.int32).min) | (arr > np.iinfo(np.int32).max)
            if out_of_range.any():
                raise ValueError("slot planes exceed int32 range")
            arr = arr.astype(np.int32)
        return arr
    return pack_slot_values(arr)


def make_state(tables, num_instances: int, definition_of_instance: np.ndarray,
               initial_slots: np.ndarray | None = None,
               token_capacity: int | None = None, num_shards: int = 1,
               device=None) -> dict:
    """Fresh automaton state: one token per instance, parked at the start
    event. With ``num_shards > 1`` the layout is shard-block aligned: shard s
    owns instance rows [s*I/n, (s+1)*I/n) and token block [s*T/n, (s+1)*T/n),
    with ``inst`` values local to the shard block."""
    dev = resolve_device(device)
    I = num_instances
    T = token_capacity or (2 * I)
    if I % num_shards or T % num_shards:
        raise ValueError(f"instances ({I}) and tokens ({T}) must divide num_shards ({num_shards})")
    E = tables.max_elements
    S = tables.num_slots
    def_of = np.asarray(definition_of_instance, np.int32)
    elem = np.full(T, -1, np.int32)
    phase = np.zeros(T, np.int32)
    inst = np.zeros(T, np.int32)
    Il, Tl = I // num_shards, T // num_shards
    if Il > Tl:
        raise ValueError("token capacity per shard smaller than instances per shard")
    for s in range(num_shards):
        block = slice(s * Tl, s * Tl + Il)
        elem[block] = tables.start_elem[def_of[s * Il : (s + 1) * Il]]
        inst[block] = np.arange(Il, dtype=np.int32)
    if initial_slots is None:
        slots = np.zeros((I, S, 2), np.int32)
    else:
        slots = _coerce_slot_planes(initial_slots)
    return state_from_numpy({
        "elem": elem, "phase": phase, "inst": inst, "def_of": def_of,
        "var_slots": slots,
        "join_counts": np.zeros((I, E), np.int32),
        "mi_left": np.zeros((I, E), np.int32),
        "done": np.zeros(I, np.bool_),
        "incident": np.zeros(I, np.bool_),
        "transitions": np.zeros((), np.int32),
        "jobs_created": np.zeros((), np.int32),
        "completed": np.zeros((), np.int32),
        "overflow": np.zeros((), np.bool_),
    }, dev)


# ---------------------------------------------------------------------------
# condition VM (plain version)


def _eval_programs(cond_ops: torch.Tensor, cond_args: torch.Tensor,
                   prog_ids: torch.Tensor, slot_rows: torch.Tensor) -> torch.Tensor:
    """Evaluate condition programs ``prog_ids`` [N] (all >= 0) against
    per-request slot rows [N, S, 2] → bool [N]. Values are (hi, lo) order-key
    planes compared lexicographically, bit-exact against the host float64
    evaluator. Stack reads clamp into [0, DEPTH) as the reference's gathers
    do; the NOP write goes to a sink row past the stack (the reference's
    dropped out-of-range scatter)."""
    N = prog_ids.shape[0]
    dev = prog_ids.device
    S = slot_rows.shape[1]
    pid = prog_ids.long()
    ops = cond_ops[pid]
    args = cond_args[pid]
    rows = torch.arange(N, device=dev)
    stack = torch.zeros((N, STACK_DEPTH + 1, 2), dtype=_I32, device=dev)
    sp = torch.zeros(N, dtype=_I32, device=dev)
    zero = torch.zeros(N, dtype=_I32, device=dev)
    for p in range(MAX_PROG_LEN):
        op = ops[:, p]
        arg = args[:, p]
        var = arg[:, 0]
        var = torch.where(var < 0, var + S, var).clamp(0, S - 1)
        push_val = torch.where((op == OP_PUSH_VAR)[:, None],
                               slot_rows[rows, var.long()], arg)
        a = stack[rows, (sp - 2).clamp(0, STACK_DEPTH - 1).long()]
        b = stack[rows, (sp - 1).clamp(0, STACK_DEPTH - 1).long()]
        lt = (a[:, 0] < b[:, 0]) | ((a[:, 0] == b[:, 0]) & (a[:, 1] < b[:, 1]))
        eq = (a[:, 0] == b[:, 0]) & (a[:, 1] == b[:, 1])
        bool_hi = torch.zeros(N, dtype=torch.bool, device=dev)
        for code, val in (
            (OP_LT, lt), (OP_LE, lt | eq), (OP_GT, ~(lt | eq)), (OP_GE, ~lt),
            (OP_EQ, eq), (OP_NE, ~eq),
            (OP_AND, (a[:, 0] > 0) & (b[:, 0] > 0)),
            (OP_OR, (a[:, 0] > 0) | (b[:, 0] > 0)),
        ):
            bool_hi = torch.where(op == code, val, bool_hi)
        bin_val = torch.stack([bool_hi.to(_I32), zero], 1)
        # NEG is the bitwise NOT of both sign-biased planes; zero stays zero
        # (key(+0.0) is (0, INT32_MIN) and must not become key(-0.0))
        is_zero = (b[:, 0] == 0) & (b[:, 1] == _INT32_MIN)
        neg_val = torch.where(is_zero[:, None], b, ~b)
        not_val = torch.stack([1 - b[:, 0].clamp(max=1), zero], 1)
        un_val = torch.where((op == OP_NOT)[:, None], not_val, neg_val)
        is_push = (op == OP_PUSH_CONST) | (op == OP_PUSH_VAR)
        is_un = (op == OP_NOT) | (op == OP_NEG)
        is_bin = (op >= OP_LT) & (op <= OP_OR)
        new_top = torch.where(is_push[:, None], push_val,
                              torch.where(is_bin[:, None], bin_val, un_val))
        write_pos = torch.where(is_push, sp, torch.where(is_bin, sp - 2, sp - 1))
        write_pos = torch.where(is_push | is_bin | is_un,
                                write_pos.clamp(0, STACK_DEPTH - 1), STACK_DEPTH)
        stack[rows, write_pos.long()] = new_top
        sp = sp + torch.where(is_push, 1, torch.where(is_bin, -1, 0)).to(_I32)
    return stack[rows, (sp - 1).clamp(0, STACK_DEPTH - 1).long(), 0] > 0


# ---------------------------------------------------------------------------
# scope machinery (plain version)


def _token_view(tables: DeviceTables, state: dict):
    elem = state["elem"]
    inst = state["inst"].long()
    live = elem >= 0
    d = state["def_of"][inst].long()
    e0 = elem.clamp(min=0).long()
    op = torch.where(live, tables.kernel_op[d, e0], K_NONE)
    return live, inst, d, e0, op


def _scope_occupancy(tables: DeviceTables, state: dict):
    """(occ, pend): per (instance, scope element) counts of live tokens and
    of unconsumed parallel-join arrivals strictly inside each scope. The
    reference's int32 einsum is a broadcast multiply and sum here: CUDA has
    no integer matmul."""
    I, E = state["join_counts"].shape
    live, inst, d, e0, _ = _token_view(tables, state)
    containing = tables.in_scope[d, e0].to(_I32) * live.to(_I32)[:, None]
    occ = torch.zeros((I, E), dtype=_I32, device=containing.device)
    occ.index_add_(0, inst, containing)
    scope_rows = tables.in_scope[state["def_of"].long()].to(_I32)  # [I, E, S]
    pend = _i32((state["join_counts"][:, :, None] * scope_rows).sum(1))
    return occ, pend


def _scope_drained(tables: DeviceTables, state: dict, include_mi: bool,
                   occ_pend) -> torch.Tensor:
    """Parked K_SCOPE tokens (and, with ``include_mi``, fully spawned K_MI
    bodies) whose scope holds no live token and no unconsumed join arrival."""
    live, inst, _, e0, op = _token_view(tables, state)
    occ, pend = occ_pend
    scope_like = op == K_SCOPE
    if include_mi:
        scope_like = scope_like | ((op == K_MI) & (state["mi_left"][inst, e0] == 0))
    return (live & scope_like & (state["phase"] == PHASE_WAIT)
            & (occ[inst, e0] == 0) & (pend[inst, e0] == 0))


def _mi_spawnable(tables: DeviceTables, state: dict, occ_pend) -> torch.Tensor:
    """Parked K_MI bodies that spawn a child next step."""
    live, inst, d, e0, op = _token_view(tables, state)
    occ, pend = occ_pend
    seq = tables.mi_sequential[d, e0] > 0
    gate = ~seq | ((occ[inst, e0] == 0) & (pend[inst, e0] == 0))
    return (live & (op == K_MI) & (state["phase"] == PHASE_WAIT)
            & (state["mi_left"][inst, e0] > 0) & gate)


# ---------------------------------------------------------------------------
# the step (plain version)


def step_plain(tables: DeviceTables, state: dict, auto_jobs: bool = True,
               emit_events: bool = False, config=None):
    """One lock-step advance of every live token, op for op as the reference
    ``zeebe_tpu.ops.automaton.step``. Returns (state', events | None)."""
    if config is None:
        config = KernelConfig()
    elem = state["elem"]
    phase = state["phase"]
    dev = elem.device
    T = elem.shape[0]
    I = state["def_of"].shape[0]
    E = tables.kernel_op.shape[1]
    FO = tables.out_target.shape[2]

    live, inst, d, e0, op = _token_view(tables, state)
    stalled = phase == PHASE_STALLED

    # --- what does each token do this step? -------------------------------
    is_task = op == K_TASK
    is_wait = is_task | (op == K_CATCH)
    is_scope = op == K_SCOPE
    is_host = op == K_HOST
    is_mi = op == K_MI
    executing = live & (phase == PHASE_AT) & ~stalled
    arriving_task = executing & is_wait
    arriving_scope = executing & is_scope
    arriving_host = executing & is_host
    arriving_mi = executing & is_mi
    pass_attempt = executing & ~is_wait & ~is_scope & ~is_host & ~is_mi
    waiting_done = live & is_wait & (phase == (PHASE_WAIT if auto_jobs else PHASE_DONE))

    # --- scope drain and MI spawn (start-of-step counts) -------------------
    no_tokens = torch.zeros(T, dtype=torch.bool, device=dev)
    occ_pend = None
    scope_resume = no_tokens
    if config.has_scopes or config.has_mi:
        occ_pend = _scope_occupancy(tables, state)
        scope_resume = _scope_drained(tables, state, config.has_mi, occ_pend)
    mi_spawn = _mi_spawnable(tables, state, occ_pend) if config.has_mi else no_tokens

    # --- gateway conditions -------------------------------------------------
    out_count = tables.out_count[d, e0]
    targets = tables.out_target[d, e0]  # [T, FO]
    conds = tables.out_cond[d, e0]  # [T, FO]
    slot_idx = torch.arange(FO, device=dev)[None, :]
    is_excl = op == K_EXCLUSIVE
    is_incl = op == K_INCLUSIVE
    need_eval = ((is_excl | is_incl) & pass_attempt)[:, None] & (conds >= 0)
    cond_true = torch.zeros((T, FO), dtype=torch.bool, device=dev)
    if config.has_conditions and bool(need_eval.any()):
        # only the lanes that need a condition run the VM; the reference
        # evaluates every lane and masks, which gives the same bits
        t_idx, f_idx = need_eval.nonzero(as_tuple=True)
        cond_true[t_idx, f_idx] = _eval_programs(
            tables.cond_ops, tables.cond_args, conds[t_idx, f_idx],
            state["var_slots"][inst[t_idx]])

    # first true slot: argmax rejects bool, so take the least true index
    any_true = cond_true.any(1)
    first_true = torch.where(cond_true, slot_idx, FO).amin(1)
    first_true = torch.where(any_true, first_true, 0)
    default = tables.default_slot[d, e0]
    excl_choice = torch.where(any_true, first_true.to(_I32), default)
    excl_no_match = (is_excl | is_incl) & pass_attempt & ~any_true & (default < 0)

    full_pass = pass_attempt & ~excl_no_match
    completing = full_pass | waiting_done | scope_resume

    incl_take = cond_true | ((slot_idx == default[:, None]) & ~any_true[:, None]
                             & (default >= 0)[:, None])
    take_mask = torch.where(
        is_excl[:, None],
        (slot_idx == excl_choice[:, None]) & (excl_choice >= 0)[:, None],
        torch.where(is_incl[:, None], incl_take, slot_idx < out_count[:, None]),
    )
    take_mask = take_mask & completing[:, None] & (targets >= 0)

    # --- transition counting ----------------------------------------------
    flows_taken = _i32(take_mask.sum())
    per_token = (
        torch.where(full_pass, 4, 0)
        + torch.where(arriving_task | arriving_scope | arriving_mi, 2, 0)
        + torch.where(waiting_done | scope_resume, 2, 0)
    )

    # --- movement: taken flows become placement requests --------------------
    req_target_2d = torch.where(take_mask, targets, -1)
    spawning = arriving_scope | arriving_mi | mi_spawn
    if config.has_scopes or config.has_mi:
        # a spawn rides the spawner's flow slot 0 (take_mask stays false)
        req_target_2d[:, 0] = torch.where(spawning, tables.scope_start[d, e0],
                                          req_target_2d[:, 0])
    req_target = req_target_2d.reshape(-1)  # [T*FO]
    req_inst = inst.repeat_interleave(FO)
    req_def = d.repeat_interleave(FO)
    req_live = req_target >= 0
    req_t0 = req_target.clamp(min=0).long()

    join_counts = state["join_counts"]
    if config.has_joins:
        req_op = torch.where(req_live, tables.kernel_op[req_def, req_t0], K_NONE)
        is_join_req = req_op == K_JOIN
        flat_key = torch.where(is_join_req, req_inst * E + req_t0, 0)
        arrivals_flat = torch.zeros(I * E, dtype=_I32, device=dev)
        arrivals_flat.index_add_(0, flat_key, is_join_req.to(_I32))
        rank = torch.zeros(T * FO, dtype=_I32, device=dev)
        if bool((arrivals_flat > 1).any()):
            # stable rank of each request among the same (instance, join)
            # key; non-join requests share the 2**30 sentinel key
            join_key = torch.where(is_join_req, req_inst * E + req_t0, 2**30)
            sorted_key, order = torch.sort(join_key, stable=True)
            new_run = torch.ones(T * FO, dtype=torch.bool, device=dev)
            new_run[1:] = sorted_key[1:] != sorted_key[:-1]
            idxs = torch.arange(T * FO, dtype=_I32, device=dev)
            run_start = torch.cummax(torch.where(new_run, idxs, 0), 0).values
            rank[order] = idxs - run_start
        prior = join_counts[req_inst, req_t0]
        arity = tables.in_count[req_def, req_t0].clamp(min=1)
        count_after = prior + rank + 1
        join_completes = is_join_req & (torch.remainder(count_after, arity) == 0)
        proceeds = req_live & (~is_join_req | join_completes)
        consumed_flat = torch.zeros(I * E, dtype=_I32, device=dev)
        consumed_flat.index_add_(0, flat_key, torch.where(join_completes, arity, 0))
        join_counts = join_counts + (arrivals_flat - consumed_flat).reshape(I, E)
    else:
        proceeds = req_live

    # --- token slot allocation (prefix sums into freed slots) ---------------
    elem_after_exec = torch.where(completing, -1, elem)
    free = elem_after_exec < 0
    free_rank = _i32(torch.cumsum(free.to(_I32), 0)) - 1
    slot_ids = torch.arange(T, dtype=_I32, device=dev)
    slot_of_rank = torch.zeros(T, dtype=_I32, device=dev)
    # ranks are unique per free slot; the reference drops the others
    slot_of_rank[free_rank[free].long()] = slot_ids[free]
    place_rank = _i32(torch.cumsum(proceeds.to(_I32), 0)) - 1
    free_count = _i32(free.sum())
    valid = proceeds & (place_rank < free_count)
    overflow = state["overflow"] | (proceeds & ~valid).any()
    dest = torch.where(valid, slot_of_rank[place_rank.clamp(0, T - 1).long()], T)

    # scatter placement; the "dest == T" sentinel entries are dropped
    placed = dest < T
    pdest = dest[placed].long()
    new_elem = elem_after_exec.clone()
    new_elem[pdest] = req_target[placed]
    new_inst = state["inst"].clone()
    new_inst[pdest] = _i32(req_inst[placed])
    new_phase = torch.where(
        arriving_task | arriving_scope | arriving_host | arriving_mi, PHASE_WAIT, phase)
    new_phase = torch.where(excl_no_match, PHASE_STALLED, new_phase)
    new_phase[pdest] = PHASE_AT

    mi_left = state["mi_left"]
    if config.has_mi:
        spawned = (arriving_mi | mi_spawn).to(_I32)
        mi_left = mi_left.clone()
        mi_left.view(-1).index_add_(0, inst * E + e0, -spawned)

    # --- instance completion ------------------------------------------------
    live_after = new_elem >= 0
    tokens_per_inst = torch.zeros(I, dtype=_I32, device=dev)
    tokens_per_inst.index_add_(0, new_inst.long(), live_after.to(_I32))
    was_done = state["done"]
    pending_arrivals = _i32(join_counts.sum(1))
    newly_done = ~was_done & (tokens_per_inst == 0) & (pending_arrivals == 0)
    done = was_done | newly_done
    incident = state["incident"].clone()
    incident[inst[excl_no_match]] = True

    newly_count = _i32(newly_done.sum())
    transitions = (state["transitions"] + _i32(per_token.sum()) + flows_taken
                   + 2 * newly_count)
    jobs_created = state["jobs_created"] + _i32((arriving_task & is_task).sum())
    completed = state["completed"] + newly_count

    new_state = {
        "elem": new_elem,
        "phase": new_phase,
        "inst": new_inst,
        "def_of": state["def_of"],
        "var_slots": state["var_slots"],
        "join_counts": join_counts,
        "mi_left": mi_left,
        "done": done,
        "incident": incident,
        "transitions": transitions,
        "jobs_created": jobs_created,
        "completed": completed,
        "overflow": overflow,
    }
    events = None
    if emit_events:
        events = {
            "full_pass": full_pass,
            "task_arrive": arriving_task | arriving_scope | arriving_mi,
            "task_done": waiting_done | scope_resume,
            "elem": elem,
            "inst": state["inst"],
            "take_mask": take_mask,
            "newly_done": newly_done,
            "no_match": excl_no_match,
            "dest": _i32(dest).reshape(T, FO),
        }
    return new_state, events


def _pack_events(ev: dict, I: int, T: int) -> torch.Tensor:
    """One step's events → int32 [T, 2 + FO]:

      col 0: flags(5b) | elem << 5 — bit0 full_pass, bit1 task_arrive,
             bit2 task_done, bit3 no_match, bit4 newly_done (row t < I is
             instance t)
      col 1: inst
      cols 2..2+FO: dest(16b) | take_mask << 16 per flow slot

    ``elem << 5`` is a multiply by 32 here: the same bits for elem == -1
    (-32) without shifting a negative number."""
    flags = (
        ev["full_pass"].to(_I32)
        | (ev["task_arrive"].to(_I32) << 1)
        | (ev["task_done"].to(_I32) << 2)
        | (ev["no_match"].to(_I32) << 3)
    )
    newly = torch.zeros(T, dtype=_I32, device=flags.device)
    newly[:I] = ev["newly_done"].to(_I32)
    flags = flags | (newly << 4) | (ev["elem"] * 32)
    dest_take = ev["dest"] | (ev["take_mask"].to(_I32) << 16)
    return torch.cat([flags[:, None], ev["inst"][:, None], dest_take], 1)


def unpack_events(packed: np.ndarray, I: int) -> dict:
    """Host-side inverse of _pack_events for one step row ([T, 2+FO])."""
    flags = packed[:, 0]
    dest_take = packed[:, 2:]
    return {
        "full_pass": (flags & 1).astype(bool),
        "task_arrive": (flags & 2).astype(bool),
        "task_done": (flags & 4).astype(bool),
        "no_match": (flags & 8).astype(bool),
        "newly_done": (flags[:I] & 16).astype(bool),
        "elem": flags >> 5,
        "inst": packed[:, 1],
        "dest": dest_take & 0xFFFF,
        "take_mask": (dest_take >> 16).astype(bool),
    }


def _unpack_events_tensor(row: torch.Tensor, I: int) -> dict:
    """``unpack_events`` on a device tensor: the kernel's packed step row
    back into the event dict ``step(emit_events=True)`` returns."""
    flags = row[:, 0]
    dest_take = row[:, 2:]
    return {
        "full_pass": (flags & 1).bool(),
        "task_arrive": (flags & 2).bool(),
        "task_done": (flags & 4).bool(),
        "elem": flags >> 5,
        "inst": row[:, 1],
        "take_mask": ((dest_take >> 16) & 1).bool(),
        "newly_done": (flags[:I] & 16).bool(),
        "no_match": (flags & 8).bool(),
        "dest": dest_take & 0xFFFF,
    }


def _active_count(tables: DeviceTables, state: dict, config) -> torch.Tensor:
    """Post-step active tokens: executing or finishing next step, plus
    drained scopes and spawnable MI bodies (they act next step too)."""
    phase = state["phase"]
    active = _i32(((state["elem"] >= 0)
                   & ((phase == PHASE_AT) | (phase == PHASE_DONE))).sum())
    if config.has_scopes or config.has_mi:
        occ_pend = _scope_occupancy(tables, state)
        active = active + _i32(_scope_drained(tables, state, config.has_mi, occ_pend).sum())
        if config.has_mi:
            active = active + _i32(_mi_spawnable(tables, state, occ_pend).sum())
    return active


def run_collect_plain(tables: DeviceTables, state: dict, n_steps: int = 16,
                      config=None):
    """Up to ``n_steps`` lock-steps, stacking each step's packed event row;
    stops after the first step that leaves no active token. Returns (state',
    packed int32 [n_steps, T*(2+FO) + 2]); each row ends with the post-step
    active count and the overflow flag, and unwritten rows stay zero."""
    if config is None:
        config = KernelConfig()
    I = state["def_of"].shape[0]
    T = state["elem"].shape[0]
    FO = tables.out_target.shape[2]
    out = torch.zeros((n_steps, T * (2 + FO) + 2), dtype=_I32, device=state["elem"].device)
    for i in range(n_steps):
        state, ev = step_plain(tables, state, auto_jobs=False, emit_events=True,
                               config=config)
        active = _active_count(tables, state, config)
        out[i, :-2] = _pack_events(ev, I, T).reshape(-1)
        out[i, -2] = active
        out[i, -1] = state["overflow"].to(_I32)
        if int(active) == 0:
            break
    return state, out


def run_to_completion_plain(tables: DeviceTables, state: dict, max_steps: int = 1000,
                            auto_jobs: bool = True, config=None):
    """Steps until no token is live, or ``max_steps``. Returns (state',
    steps as an int32 scalar tensor)."""
    steps = 0
    while steps < max_steps and bool((state["elem"] >= 0).any()):
        state, _ = step_plain(tables, state, auto_jobs=auto_jobs,
                              emit_events=False, config=config)
        steps += 1
    return state, torch.tensor(steps, dtype=_I32, device=state["elem"].device)


# ---------------------------------------------------------------------------
# wrappers: CPU tensors → plain version, CUDA tensors → the kernels


def _route(state: dict) -> bool:
    """True for the kernel path. A CPU tensor takes the plain version; any
    other device type raises."""
    dev = state["elem"].device
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def step(tables: DeviceTables, state: dict, auto_jobs: bool = True,
         emit_events: bool = False, config=None):
    """One lock-step advance. Returns (state', events | None)."""
    if config is None:
        config = KernelConfig()
    if not _route(state):
        return step_plain(tables, state, auto_jobs, emit_events, config)
    T = state["elem"].shape[0]
    if emit_events and T > PACK_MAX_TOKENS:
        raise ValueError(f"step events pack dest in 16 bits; T={T} exceeds "
                         f"{PACK_MAX_TOKENS}")
    new_state, rows = kernels.run_steps(
        tables, state, n_steps=1, config=config, auto_jobs=auto_jobs,
        emit_events=emit_events, mode="step")
    events = None
    if emit_events:
        FO = tables.out_target.shape[2]
        events = _unpack_events_tensor(rows[0, :-2].view(T, 2 + FO),
                                       state["def_of"].shape[0])
    return new_state, events


def run_collect(tables: DeviceTables, state: dict, n_steps: int = 16, config=None):
    """Advance up to ``n_steps`` lock-steps and return (state', packed rows);
    see ``run_collect_plain`` for the layout. On CUDA the early exit is a
    device flag: no host synchronization happens inside the chunk."""
    if config is None:
        config = KernelConfig()
    if not _route(state):
        return run_collect_plain(tables, state, n_steps, config)
    return kernels.run_steps(tables, state, n_steps=n_steps, config=config,
                             auto_jobs=False, emit_events=True, mode="collect")


def run_to_completion(tables: DeviceTables, state: dict, max_steps: int = 1000,
                      auto_jobs: bool = True, config=None):
    """Run steps until no token is live (or ``max_steps``) with no events.
    Returns (state', steps)."""
    if config is None:
        config = KernelConfig()
    if not _route(state):
        return run_to_completion_plain(tables, state, max_steps, auto_jobs, config)
    return kernels.run_until_quiet(tables, state, max_steps=max_steps,
                                   config=config, auto_jobs=auto_jobs)


def reset_launch_counts() -> None:
    """Set every kernel's launch count, every grid-launch count, the fused
    chunk's counts by shape and the cross-group counter sum's count to 0,
    and forget the calls' geometry."""
    for counts in (kernels.LAUNCHES, kernels.GRID_LAUNCHES, kernels.FUSED_SHAPES,
                   kernels.GROUP_LAUNCHES):
        for name in counts:
            counts[name] = 0
    kernels.GEOMETRY.clear()


def launch_counts() -> dict:
    return dict(kernels.LAUNCHES)


def grid_launch_counts() -> dict:
    """CUDA grid launches the automaton wrappers enqueued, by path (see
    ``kernels.GRID_LAUNCHES``)."""
    return dict(kernels.GRID_LAUNCHES)


def fused_shape_counts() -> dict:
    """The fused chunk's launches by shape, ``"block"`` or ``"cluster"``
    (see ``kernels.FUSED_SHAPES``)."""
    return dict(kernels.FUSED_SHAPES)


def geometry_counts() -> list[dict]:
    """The automaton wrappers' calls while tracing was on, by geometry (see
    ``kernels.GEOMETRY``): each geometry's ``path``, KernelConfig ``flags``,
    the bytes of each table (``tables``) and state array (``state``) it was
    given, the packed-row bytes it writes (``out_bytes``) and its ``calls``."""
    return [{"path": path, "flags": dict(zip(kernels.GEOMETRY_FLAGS, flags)),
             "tables": dict(zip(kernels._TABLE_SPEC, tables)),
             "state": dict(zip(kernels._STATE_PTRS, state)),
             "out_bytes": out_bytes, "calls": calls}
            for (path, flags, tables, state, out_bytes), calls
            in list(kernels.GEOMETRY.items())]


def group_launch_counts() -> dict:
    """Launches of a grouped mesh's cross-group counter sum (see
    ``kernels.GROUP_LAUNCHES``)."""
    return dict(kernels.GROUP_LAUNCHES)


def complete_jobs(state: dict, token_slots, result_slots=None,
                  result_values=None) -> dict:
    """Host-driven job completion: move waiting tokens to PHASE_DONE, and
    optionally write job result variables into instance slots."""
    dev = state["phase"].device
    slots = torch.as_tensor(np.asarray(token_slots), device=dev).long()
    new_state = dict(state)
    phase = state["phase"].clone()
    phase[slots] = PHASE_DONE
    new_state["phase"] = phase
    if result_slots is not None and result_values is not None:
        vals = np.asarray(result_values)
        if vals.ndim == 2 and np.issubdtype(vals.dtype, np.integer):
            if vals.dtype != np.int32:
                info = np.iinfo(np.int32)
                if ((vals < info.min) | (vals > info.max)).any():
                    raise ValueError("slot planes exceed int32 range")
                vals = vals.astype(np.int32)
        else:
            vals = pack_slot_values(vals)
        inst = state["inst"][slots]
        var_slots = state["var_slots"].clone()
        var_slots[inst.long(), torch.as_tensor(np.asarray(result_slots), device=dev).long()] = \
            torch.from_numpy(np.array(vals, order="C")).to(dev)
        new_state["var_slots"] = var_slots
    return new_state
