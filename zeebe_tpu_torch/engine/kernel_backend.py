"""The device half of the engine's batched execution backend.

The counterpart of the device path of ``zeebe_tpu/engine/kernel_backend.py``
(``KernelBackend``): a group of admitted instances is padded to a shape
bucket (``build_group_arrays``), placed on the device (``group_state``), run
in chunks of ``run_collect`` until it quiesces, with the next chunk
dispatched before the current one's rows are fetched (``run_group``), and
each instance's route is traced from the packed step rows (``cascade_ops``)
— the trace the record writer interprets.

Instances come in as plain records (``GroupInstance``), not the reference's
admission objects: admission, call/MI inlining, materialization into
records and the shadow oracle are not part of this module.

``drive_group`` is the slice's entry point: it runs a group through waves —
each wave runs the device until it quiesces with every token parked, traces
the wave, then completes every parked job (``complete_jobs``) as job workers
would, until no job is left.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from zeebe_tpu_torch.models.bpmn import parse_bpmn_xml, transform
from zeebe_tpu_torch.ops.automaton import (
    PACK_MAX_ELEMENTS,
    PACK_MAX_TOKENS,
    PHASE_AT,
    PHASE_WAIT,
    DeviceTables,
    complete_jobs,
    resolve_device,
    run_collect,
    state_from_numpy,
    unpack_events,
)
from zeebe_tpu_torch.ops.tables import K_HOST, K_MI, K_SCOPE, K_TASK, ProcessTables, compile_tables

logger = logging.getLogger(__name__)

# the partition's geometry (zeebe_tpu/broker/partition.py builds its backend
# with max_group=2048, chunk_steps=8; max_steps is the backend's default)
MAX_GROUP = 2048
CHUNK_STEPS = 8
MAX_STEPS = 4096


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
    rows = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    rows.copy_(packed, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return _Chunk(state, rows, ready)


def fetch_rows(chunk: _Chunk) -> np.ndarray:
    """The one device→host ingestion point for a chunk's packed rows."""
    if chunk.ready is not None:
        chunk.ready.synchronize()
    return chunk.rows.numpy()


@dataclasses.dataclass
class GroupRun:
    steps: list[dict] | None  # unpacked per-step events; None on failure
    state: dict  # device state after the last fetched chunk
    chunks_run: int
    fail_reason: str | None = None


def run_group(dt: DeviceTables, config, state: dict, I: int, T: int,
              chunk_steps: int = CHUNK_STEPS, max_steps: int = MAX_STEPS,
              pipeline_chunks: bool | None = None, collect=None) -> GroupRun:
    """Run the group's device loop until it quiesces: one dispatch and one
    host fetch per chunk of ``chunk_steps`` lock-steps. From the second
    chunk on (on CUDA), chunk k+1 is dispatched off chunk k's device state
    before chunk k's rows are fetched, so the device computes while the
    host decodes. The first chunk never prefetches: groups that quiesce at
    once would pay a wasted chunk. ``collect`` replaces ``run_collect``
    (a checker passes the plain version to run it on the card)."""
    collect = collect or run_collect
    if pipeline_chunks is None:
        pipeline_chunks = state["elem"].is_cuda
    chunk = chunk_steps
    FO = dt.out_target.shape[2]
    steps: list[dict] = []
    overflow = False
    cur = _dispatch(dt, state, chunk, config, collect)
    state = cur.state
    nxt = None
    max_chunks = max(1, max_steps // chunk)
    hit_quiescence = False
    chunks_run = 0
    for k in range(max_chunks):
        if pipeline_chunks and k >= 1 and k + 1 < max_chunks:
            nxt = _dispatch(dt, state, chunk, config, collect)
        flat = fetch_rows(cur)
        chunks_run = k + 1
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
            cur = _dispatch(dt, state, chunk, config, collect)
        state = cur.state
    if not hit_quiescence:
        logger.warning("kernel group did not quiesce in %d steps", max_steps)
        return GroupRun(None, state, chunks_run, "no-quiesce")
    if overflow:
        logger.warning("kernel token pool overflow (T=%d)", T)
        return GroupRun(None, state, chunks_run, "token-overflow")
    return GroupRun(steps, state, chunks_run)


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


def parked_jobs(tables: ProcessTables, state: dict) -> np.ndarray:
    """Slots of tokens parked at a job-worker task (the jobs a worker can
    complete), in slot order."""
    elem = state["elem"].cpu().numpy()
    phase = state["phase"].cpu().numpy()
    inst = state["inst"].cpu().numpy()
    def_of = state["def_of"].cpu().numpy()
    live = elem >= 0
    op = np.where(live, tables.kernel_op[def_of[inst], np.maximum(elem, 0)], 0)
    return np.flatnonzero(live & (phase == PHASE_WAIT) & (op == K_TASK))


def live_tokens(state: dict, insts: list[GroupInstance]) -> None:
    """Reset each instance's token list to its live tokens in ``state``, in
    slot order (the start of the next wave's trace)."""
    elem = state["elem"].cpu().numpy()
    phase = state["phase"].cpu().numpy()
    inst = state["inst"].cpu().numpy()
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
                collect=None) -> GroupResult:
    """Run one group through job-completion waves and trace every wave.
    Raises when the group does not fit the packing bounds, does not
    quiesce, or overflows its token pool. ``collect`` as for run_group."""
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
        run = run_group(dt, config, state, I, T, chunk_steps, max_steps, collect=collect)
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
