"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, time.

    python3 chip_smoke.py [--seed N]

Drives ``zeebe_tpu_torch``'s device path on the card and fails (non-zero
exit) if any phase fails:

1. the card: name, power limit, torch and CUDA versions; CUDA is required;
2. builds the kernels of ``zeebe_tpu_torch/csrc/automaton.cu`` (nvcc, sm_90a);
3. holds each kernel against its plain PyTorch version on the card at the
   serving geometry (groups of I = 2048 instances, T by the group rule):
   run_collect chunk by chunk with job-completion waves over the benchmark
   definition sets, a forced token-pool overflow and a no-match stall, plus
   single steps with events; packed rows and states must be byte-equal;
4. the slice end to end: BPMN XML → tables → 8 groups x 2048 instances of
   the 8-definition mixed set → run_group with chunk prefetch and job waves
   → per-instance traces; every instance completes, nothing overflows, and
   traces and counters equal a run of the plain version on the card;
5. the kernel ceiling: run_to_completion of one_task at I = T = 1<<20;
6. the sharded kernels against their plain versions on the card: 8 shard
   blocks on the one card, each a serving partition group (I = 2048 by the
   group rule) of a registry holding the mixed set, a call activity and a
   parallel multi-instance body — one shard quiesces in its first chunk, one
   overflows alone, two are padded from the small bucket, one runs the
   inlined call and MI paths. ``make_sharded_step`` (several steps) and the
   runner's sharded collect (chunk by chunk with job waves) are held
   byte-equal to their plain versions, and each shard's result byte-equal
   to step / run_collect run alone on that shard;
7. the mesh slice: 8 partitions, each its own KernelRegistry over the same
   XML (equal fingerprints), 2048 instances each, driven through every job
   wave by ``drive_groups_on_mesh`` on one MeshKernelRunner from 8 threads;
   every partition's traces and final state equal the same group driven
   alone by ``drive_group`` on the card, and dispatches coalesced;
8. prints the kernels line (JSON), then the card line, then the result line.

Imports neither JAX nor the JAX package. Launch counts are zeroed right
before each main path runs (phase 4 for step and run_collect, phase 5 for
run_to_completion, phase 7 for sharded_step and sharded_collect) and read
right after; comparison launches do not count.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from zeebe_tpu_torch.engine import kernel_backend as kb
from zeebe_tpu_torch.models.bpmn import Bpmn, transform
from zeebe_tpu_torch.ops import automaton as A
from zeebe_tpu_torch.ops import kernels
from zeebe_tpu_torch.ops.tables import compile_tables, f64_key_planes
from zeebe_tpu_torch.parallel import mesh as M
from zeebe_tpu_torch.parallel import mesh_runner as MR
from zeebe_tpu_torch.testing import workloads as W
from zeebe_tpu_torch.testing.catalog import ProcessCatalog

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SOURCE = "zeebe_tpu_torch/csrc/automaton.cu"
REPLACES = {
    "step": "zeebe_tpu/ops/automaton.py:366",
    "run_collect": "zeebe_tpu/ops/automaton.py:704",
    "run_to_completion": "zeebe_tpu/ops/automaton.py:773",
    "sharded_step": "zeebe_tpu/parallel/mesh.py:102",
    "sharded_collect": "zeebe_tpu/parallel/mesh_runner.py:233",
}
KERNELS = ("step", "run_collect", "run_to_completion", "sharded_step", "sharded_collect")
N_SHARDS = 8


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# What one call must move, by KernelConfig flag (the reference step reads
# and writes these arrays only under the flag; without it the array is
# neither read nor returned changed).
TABLES_ALWAYS = ("kernel_op", "out_count", "out_target", "default_slot")
TABLES_BY_FLAG = {"has_conditions": ("out_cond", "cond_ops", "cond_args"),
                  "has_joins": ("in_count",),
                  "has_scopes": ("in_scope", "scope_start"),
                  "has_mi": ("in_scope", "scope_start", "mi_sequential")}
STATE_READ = ("elem", "phase", "inst", "def_of", "done", "incident", "join_counts",
              "transitions", "jobs_created", "completed", "overflow")
STATE_WRITTEN = ("elem", "phase", "inst", "done", "incident", "transitions",
                 "jobs_created", "completed", "overflow")


def moved_bytes(dt, state: dict, config, extra_out: int = 0) -> int:
    """Bytes a call must move: the tables and state arrays that ``config``
    lets the step read, each read once, and those it lets the step write
    (plus ``extra_out`` bytes of packed rows), each written once.
    join_counts is read always (pending arrivals) and written only with
    joins; mi_left is read and written only with MI; var_slots is read only
    with conditions."""
    tables = set(TABLES_ALWAYS)
    for flag, names in TABLES_BY_FLAG.items():
        if getattr(config, flag):
            tables.update(names)
    read, written = list(STATE_READ), list(STATE_WRITTEN)
    if config.has_conditions:
        read.append("var_slots")
    if config.has_joins:
        written.append("join_counts")
    if config.has_mi:
        read.append("mi_left")
        written.append("mi_left")
    return (nbytes(getattr(dt, n) for n in sorted(tables))
            + nbytes(state[n] for n in read) + nbytes(state[n] for n in written)
            + extra_out)


def bound_ms(dt, state: dict, config, extra_out: int = 0) -> float:
    """Least time on the card for those bytes at the HBM rate."""
    return moved_bytes(dt, state, config, extra_out) / HBM_BYTES_PER_S * 1e3


def max_abs_err(a: dict, b: dict) -> int:
    """Largest absolute difference over every tensor of two result dicts
    (int64, so int32 extremes cannot overflow); 0 means byte-equal here."""
    worst = 0
    for k in a:
        x, y = a[k].long(), b[k].long()
        if x.shape != y.shape:
            raise AssertionError(f"{k}: shape {tuple(x.shape)} vs {tuple(y.shape)}")
        if x.numel():
            worst = max(worst, int((x - y).abs().max()))
    return worst


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, after warm-up)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def group_setup(tables, I: int, T: int | None, rng, device):
    """A fresh group of I instances over every definition of ``tables``,
    with seeded condition variables; T by the group rule unless given."""
    def_of = rng.integers(0, tables.num_definitions, I).astype(np.int32)
    slots = rng.integers(-5, 60, (I, tables.num_slots)).astype(np.float64)
    if T is None:
        w = tables.token_width
        T = kb._pow2(w * I if w > 0 else 4 * I)
    state = A.make_state(tables, I, def_of, initial_slots=slots, token_capacity=T,
                         device=device)
    return state, T


def phase_kernel_vs_plain(rng, dev) -> dict:
    """Phase 3: each definition set at the serving geometry, run_collect
    chunk by chunk with job waves, kernel vs plain; returns the worst
    difference seen per kernel."""
    def nomatch():
        return (Bpmn.create_executable_process("nomatch").start_event("s")
                .exclusive_gateway("gw").condition_expression("x > 30")
                .end_event("e").done())

    sets = {
        "one_task": [W.one_task()], "exclusive_chain": [W.exclusive_chain()],
        "fork_join": [W.fork_join()], "ten_tasks": [W.ten_tasks()],
        "subprocess_boundary": [W.subprocess_boundary()],
        "mixed_definitions": W.mixed_definitions(), "nomatch": [nomatch()],
    }
    runs = [(name, models, None) for name, models in sets.items()]
    runs.append(("fork_join_overflow", sets["fork_join"], 2048))
    worst = {"step": 0, "run_collect": 0}
    for name, models, T in runs:
        tables = compile_tables([transform(m) for m in models])
        dt = A.DeviceTables.from_numpy(tables, dev)
        config = tables.kernel_config
        state, T = group_setup(tables, 2048, T, rng, dev)
        ks = ps = state
        chunks = 0
        for _ in range(24):
            ks, krows = A.run_collect(dt, ks, n_steps=8, config=config)
            ps, prows = A.run_collect_plain(dt, ps, n_steps=8, config=config)
            chunks += 1
            err = max(max_abs_err({"rows": krows}, {"rows": prows}), max_abs_err(ks, ps))
            worst["run_collect"] = max(worst["run_collect"], err)
            if err:
                raise AssertionError(f"{name}: run_collect differs from plain (chunk {chunks})")
            jobs = kb.parked_jobs(tables, ks)
            if jobs.size == 0 and int(krows[:, -2].eq(0).any()):
                break
            if jobs.size:
                ks, ps = A.complete_jobs(ks, jobs), A.complete_jobs(ps, jobs)
        if name == "fork_join_overflow" and not bool(ks["overflow"]):
            raise AssertionError("forced overflow was not flagged")
        if name == "nomatch" and not bool(ks["incident"].any()):
            raise AssertionError("no-match stall raised no incident")
        if name not in ("fork_join_overflow", "nomatch") and not bool(ks["done"].all()):
            raise AssertionError(f"{name}: not every instance completed")
        log(f"phase3 {name}: I=2048 T={T} chunks={chunks} rows and state byte-equal "
            f"(transitions={int(ks['transitions'])})")
        # single steps with events, both job modes
        for auto_jobs in (False, True):
            ks = ps = state
            for _ in range(6):
                ks, kev = A.step(dt, ks, auto_jobs=auto_jobs, emit_events=True, config=config)
                ps, pev = A.step_plain(dt, ps, auto_jobs=auto_jobs, emit_events=True,
                                       config=config)
                err = max(max_abs_err(ks, ps), max_abs_err(kev, pev))
                worst["step"] = max(worst["step"], err)
                if err:
                    raise AssertionError(f"{name}: step differs from plain")
    return worst


def make_group(tables, n: int, rng) -> list:
    """n fresh instances over the set's definitions, with seeded x."""
    return [kb.GroupInstance(idx=idx, definition=int(rng.integers(0, tables.num_definitions)),
                             slots={"x": f64_key_planes(float(rng.integers(0, 60)))})
            for idx in range(n)]


def phase_slice(rng, dev, card: str) -> dict:
    """Phase 4: the main path end to end, kernel run (counted) then the
    plain version on the card (not counted), compared."""
    xml = W.to_xml(W.mixed_definitions())
    tables = kb.deploy([xml])
    dt = A.DeviceTables.from_numpy(tables, dev)
    groups = [make_group(tables, 2048, rng) for _ in range(8)]

    def copy(group):
        return [kb.GroupInstance(idx=i.idx, definition=i.definition, slots=dict(i.slots))
                for i in group]

    # warm-up group (first launches, pinned buffers), not counted
    kb.drive_group(tables, dt, copy(groups[0]), device=dev)
    torch.cuda.synchronize()
    A.reset_launch_counts()
    results, walls = [], []
    for g in groups:
        t0 = time.perf_counter()
        results.append(kb.drive_group(tables, dt, copy(g), device=dev))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = A.launch_counts()
    plain = [kb.drive_group(tables, dt, copy(g), device=dev, collect=A.run_collect_plain)
             for g in groups]
    transitions = 0
    for k, (r, p) in enumerate(zip(results, plain)):
        if not bool(r.state["done"].all()) or bool(r.state["overflow"]):
            raise AssertionError(f"group {k}: incomplete or overflowed")
        if r.waves != p.waves:
            raise AssertionError(f"group {k}: traces differ from the plain run")
        if max_abs_err(r.state, p.state):
            raise AssertionError(f"group {k}: final state differs from the plain run")
        transitions += int(r.state["transitions"])
    run_s = [r.run_seconds for r in results]
    wall = sum(walls)
    log(f"phase4 slice: 8 groups x 2048 instances of mixed_definitions, "
        f"{sum(len(r.waves) for r in results)} waves, {sum(r.steps for r in results)} steps, "
        f"{sum(r.chunks for r in results)} chunks; traces, transitions "
        f"({transitions}), jobs_created "
        f"({sum(int(r.state['jobs_created']) for r in results)}) and completed "
        f"({sum(int(r.state['completed']) for r in results)}) equal the plain run")
    log(f"phase4 timing [{card}]: wall per group (device loop + traces) "
        f"{[round(w * 1e3, 3) for w in walls]} ms; device loop per group "
        f"{[round(s * 1e3, 3) for s in run_s]} ms; "
        f"{transitions / wall:.1f} transitions/s end to end, "
        f"{transitions / sum(run_s):.1f} transitions/s in the device loop")
    return {"launches": launches, "tables": tables, "dt": dt, "groups": groups,
            "transitions_per_s": transitions / wall, "wall_per_group_ms": wall / 8 * 1e3,
            "decoded_steps": sum(r.steps for r in results),
            "device_loop_ms": sum(run_s) * 1e3}


def phase_ceiling(dev, card: str) -> dict:
    """Phase 5: run_to_completion of one_task at I = T = 1<<20."""
    tables = compile_tables([transform(W.one_task())])
    dt = A.DeviceTables.from_numpy(tables, dev)
    config = tables.kernel_config
    n = 1 << 20
    state = A.make_state(tables, n, np.zeros(n, np.int32), token_capacity=n, device=dev)
    A.run_to_completion(dt, state, max_steps=64, config=config)  # warm-up, not counted
    torch.cuda.synchronize()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    kf, ksteps = A.run_to_completion(dt, state, max_steps=64, config=config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = A.launch_counts()
    pf, psteps = A.run_to_completion_plain(dt, state, max_steps=64, config=config)
    err = max_abs_err(kf, pf)
    if err or int(ksteps) != int(psteps):
        raise AssertionError("run_to_completion differs from plain at the ceiling")
    if not bool(kf["done"].all()) or bool(kf["overflow"]):
        raise AssertionError("ceiling run incomplete or overflowed")
    ms = time_ms(lambda: A.run_to_completion(dt, state, max_steps=64, config=config), 5)
    plain_ms = time_ms(lambda: A.run_to_completion_plain(dt, state, max_steps=64,
                                                         config=config), 2)
    transitions = int(kf["transitions"])
    bound = bound_ms(dt, state, config)
    # one live lock-step over 1<<20 slots: prepare + 4 steps, less prepare
    bits = kernels.MODE_AUTO_JOBS
    prep_ms = time_ms(lambda: kernels.prepare(dt, state, config, bits, None), 5)
    four_ms = time_ms(lambda: kernels.launch_steps(
        kernels.prepare(dt, state, config, bits, None), 4, bits, None, 0), 5)
    step_ms = (four_ms - prep_ms) / 4
    log(f"phase5 step [{card}]: {step_ms:.4f} ms per live lock-step over {n} slots "
        f"(prepare {prep_ms:.4f} ms); bytes per step {moved_bytes(dt, state, config)} "
        f"-> bound {bound * 1e3:.3f} us at 3.35 TB/s")
    log(f"phase5 ceiling [{card}]: one_task I=T={n}, {int(ksteps)} steps, "
        f"{transitions} transitions, byte-equal to plain; first call {wall * 1e3:.3f} ms, "
        f"{ms:.3f} ms per call ({transitions / ms * 1e3:.1f} transitions/s), "
        f"plain {plain_ms:.3f} ms")
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "err": err, "step_ms": step_ms}


def serving_timings(slice_info: dict) -> dict:
    """Per-kernel times at the serving geometry on the first chunk of a
    fresh mixed group (kernel vs plain on the same inputs)."""
    tables, dt = slice_info["tables"], slice_info["dt"]
    config = tables.kernel_config
    insts = [kb.GroupInstance(idx=i.idx, definition=i.definition, slots=dict(i.slots))
             for i in slice_info["groups"][0]]
    arrays, I, T = kb.build_group_arrays(tables, insts)
    state = kb.group_state(arrays, dt.device)
    out = {}
    out["run_collect"] = {
        "ms": time_ms(lambda: A.run_collect(dt, state, n_steps=8, config=config), 50),
        "plain_ms": time_ms(lambda: A.run_collect_plain(dt, state, n_steps=8,
                                                        config=config), 5),
    }
    _, rows = A.run_collect(dt, state, n_steps=8, config=config)
    out["run_collect"]["bound_ms"] = bound_ms(dt, state, config, nbytes([rows]))
    out["step"] = {
        "ms": time_ms(lambda: A.step(dt, state, auto_jobs=False, config=config), 100),
        "plain_ms": time_ms(lambda: A.step_plain(dt, state, auto_jobs=False,
                                                 config=config), 10),
        "bound_ms": bound_ms(dt, state, config),
    }
    # the step kernels alone: back-to-back lock-steps on one prepared working
    # state (auto jobs, no events), without the wrapper's per-call host work
    bits = kernels.MODE_AUTO_JOBS
    run = kernels.prepare(dt, state, config, bits, None)
    out["step"]["device_ms"] = time_ms(
        lambda: kernels.launch_steps(run, 8, bits, None, 0), 20) / 8
    out["geometry"] = f"I={I} T={T} E={tables.max_elements} FO={tables.out_target.shape[2]}"
    out["step_bytes"] = moved_bytes(dt, state, config)
    out["chunk_bytes"] = moved_bytes(dt, state, config, nbytes([rows]))
    return out



# ---------------------------------------------------------------------------
# the sharded kernels (phase 6) and the mesh slice (phase 7)


def mesh_resources() -> list[str]:
    """The mixed set, plus a called child, a parallel multi-instance body and
    its caller (one resource each, deployed in this order)."""
    child = (Bpmn.create_executable_process("smoke_child").start_event("cs")
             .service_task("ct", job_type="cw").end_event("ce").done())
    mi = (Bpmn.create_executable_process("smoke_mi").start_event("s")
          .service_task("work", job_type="mw")
          .multi_instance(input_collection="= items", input_element="item")
          .end_event("e").done())
    caller = (Bpmn.create_executable_process("smoke_caller").start_event("s")
              .call_activity("call", process_id="smoke_child").end_event("e").done())
    return [W.to_xml(W.mixed_definitions())] + [W.to_xml([m]) for m in (child, mi, caller)]


def shard_group(registry, n: int, defs: list[int], rng) -> list:
    """n fresh instances over the registry definitions ``defs``, with seeded
    x and each multi-instance body's predicted cardinality."""
    names = registry.tables.slot_map.names
    out = []
    for idx in range(n):
        info = registry._infos[defs[int(rng.integers(0, len(defs)))]]
        cards = {body: int(rng.integers(1, 4)) for body in info.mi_inner}
        x = {"x": f64_key_planes(float(rng.integers(0, 60)))} if "x" in names else {}
        out.append(kb.GroupInstance(idx=idx, definition=info.index, slots=x,
                                    mi_left=dict(cards), mi_cards=cards))
    return out


def shard_requests(registry, dt, rng) -> list:
    """Eight partition groups for one dispatch: mixed groups of 2048, one of
    mx_one only (quiesces in its first chunk), one of mx_fj whose free slots
    hold stalled tokens (overflows alone), two small groups (padded from the
    64 bucket), and one over the call activity and the MI body."""
    mixed = list(range(8))
    kinds = [(2048, mixed), (2048, [0]), (2048, [2]), (48, mixed), (60, mixed),
             (2048, [9, 10]), (2048, mixed), (2048, mixed + [9, 10])]
    built = [kb.build_group_arrays(registry.tables, shard_group(registry, n, defs, rng))
             for n, defs in kinds]
    T_c = max(T for _, _, T in built)
    out = []
    for k, (arrays, I, T) in enumerate(built):
        if k == 2:
            # the fork_join group's pool, padded to the dispatch's, holds
            # stalled tokens in every free slot: its forks find no room
            n = kinds[k][0]
            for key, fill in (("elem", int(registry.tables.start_elem[2])),
                              ("phase", A.PHASE_STALLED), ("inst", 0)):
                arrays[key] = np.concatenate(
                    [arrays[key][:n], np.full(T_c - n, fill, np.int32)])
            T = T_c
        out.append(MR.GroupRequest(dt, registry.tables.kernel_config,
                                   registry.tables_fingerprint, arrays, I, T,
                                   kb.MAX_STEPS, kb.CHUNK_STEPS))
    return out


def shard_slice(state: dict, s: int, counters: dict | None = None) -> dict:
    """Shard s's block as a state of its own (counters given, or its row)."""
    out = {k: state[k].chunk(N_SHARDS)[s] for k in M._SHARDED_KEYS}
    for k in M._REPLICATED_KEYS:
        out[k] = counters[k] if counters is not None else state[k][s]
    return out


def phase_sharded_vs_plain(rng, dev) -> dict:
    """Phase 6: the sharded kernels against their plain versions and against
    the unsharded kernels run shard by shard, at NS = 8 on one card."""
    registry = kb.KernelRegistry()
    ProcessCatalog.from_xml(mesh_resources()).register(registry)
    tables = registry.tables
    if len(registry._infos) != 11 or not registry._infos[10].segments \
            or not registry._infos[9].mi_inner:
        raise AssertionError("the registry did not inline the call activity and MI body")
    dt = registry.device_tables_for(dev)
    config = tables.kernel_config
    requests = shard_requests(registry, dt, rng)
    host, I, T = MR.stack_requests(requests, N_SHARDS)
    state = M.shard_state(host, M.make_mesh(N_SHARDS, dev))
    FO = tables.out_target.shape[2]
    row_len = T * (2 + FO) + 2
    worst = {"sharded_step": 0, "sharded_collect": 0}
    collect = MR.MeshKernelRunner(mesh=M.make_mesh(N_SHARDS, dev))._sharded_collect(8, config)

    # sharded collect, chunk by chunk with job waves
    ks = ps = state
    quiet_at = {}
    for chunk in range(24):
        kprev = ks
        ks, krows = collect(dt, ks)
        ps, prows = MR.sharded_collect_plain(dt, ps, 8, N_SHARDS, config)
        err = max(max_abs_err({"rows": krows}, {"rows": prows}), max_abs_err(ks, ps))
        for s in range(N_SHARDS):  # each shard against run_collect alone on it
            ss, srows = A.run_collect(dt, shard_slice(kprev, s), n_steps=8, config=config)
            err = max(err, max_abs_err({"rows": srows},
                                       {"rows": krows[:, s * row_len:(s + 1) * row_len]}),
                      max_abs_err(ss, shard_slice(ks, s)))
            active = krows[:, s * row_len + row_len - 2]
            if s not in quiet_at and bool((active == 0).any()):
                quiet_at[s] = chunk
        worst["sharded_collect"] = max(worst["sharded_collect"], err)
        if err:
            raise AssertionError(f"sharded collect differs (chunk {chunk})")
        jobs = []
        for s in range(N_SHARDS):
            jobs += (s * T + kb.parked_jobs(tables, shard_slice(ks, s))).tolist()
        if not jobs and len(quiet_at) == N_SHARDS:
            break
        if jobs:
            ks, ps = A.complete_jobs(ks, jobs), A.complete_jobs(ps, jobs)
            quiet_at = {}  # a wave restarts every shard's loop
    overflow = ks["overflow"].cpu().tolist()
    done = ks["done"].view(N_SHARDS, I).cpu()
    if overflow != [False, False, True] + [False] * 5:
        raise AssertionError(f"overflow should mark shard 2 alone: {overflow}")
    for s in (0, 1, 3, 4, 5, 6, 7):
        if not bool(done[s].all()):
            raise AssertionError(f"shard {s}: not every instance completed")
    log(f"phase6 sharded_collect: {N_SHARDS} shards x I={I} T={T} FO={FO}, {chunk + 1} chunks "
        f"with job waves, rows and state byte-equal to the plain version and to "
        f"run_collect alone on each shard; overflow {overflow}; "
        f"transitions per shard {ks['transitions'].cpu().tolist()}")

    # first chunk of a fresh batch: one shard quiesces at once, the rest run on
    _, krows = collect(dt, state)
    first_quiet = [bool((krows[:, s * row_len + row_len - 2] == 0).any())
                   for s in range(N_SHARDS)]
    if not first_quiet[1] or all(first_quiet):
        raise AssertionError(f"first-chunk quiescence per shard: {first_quiet}")
    log(f"phase6 first chunk: quiesced per shard {first_quiet}")

    # the sharded step (auto jobs), replicated counters
    sstate = dict(state)
    for k in M._REPLICATED_KEYS:
        sstate[k] = torch.zeros((), dtype=state[k].dtype, device=dev)
    step = M.make_sharded_step(M.make_mesh(N_SHARDS, dev), auto_jobs=True, config=config)
    ks = ps = sstate
    for k in range(6):
        kprev = ks
        ks = step(dt, ks)
        ps = M.sharded_step_plain(dt, ps, N_SHARDS, True, config)
        err = max_abs_err(ks, ps)
        counters = {c: kprev[c] for c in M._REPLICATED_KEYS}
        sums = {c: 0 for c in ("transitions", "jobs_created", "completed")}
        for s in range(N_SHARDS):  # each shard against step alone on it
            ss, _ = A.step(dt, shard_slice(kprev, s, counters), auto_jobs=True, config=config)
            err = max(err, max_abs_err({k2: ss[k2] for k2 in M._SHARDED_KEYS},
                                       {k2: ks[k2].chunk(N_SHARDS)[s]
                                        for k2 in M._SHARDED_KEYS}))
            for c in sums:
                sums[c] += int(ss[c]) - int(kprev[c])
        for c, delta in sums.items():
            want = (int(kprev[c]) + delta + 2**31) % 2**32 - 2**31
            err = max(err, abs(int(ks[c]) - want))
        worst["sharded_step"] = max(worst["sharded_step"], err)
        if err:
            raise AssertionError(f"sharded step differs (step {k})")
    log(f"phase6 sharded_step: 6 steps byte-equal to the plain version and to step alone "
        f"on each shard (transitions {int(ks['transitions'])}, overflow "
        f"{bool(ks['overflow'])})")
    return {"worst": worst, "dt": dt, "config": config, "state": state, "sstate": sstate,
            "step": step, "collect": collect, "rows": krows}


def mesh_partitions(rng) -> list:
    """Eight partitions: each its own registry over the mixed set's XML and
    2048 fresh instances."""
    xml = W.to_xml(W.mixed_definitions())
    out = []
    for _ in range(N_SHARDS):
        registry = kb.KernelRegistry()
        ProcessCatalog.from_xml([xml]).register(registry)
        out.append((registry, shard_group(registry, 2048, list(range(8)), rng)))
    return out


def copy_group(group) -> list:
    return [kb.GroupInstance(idx=i.idx, definition=i.definition, slots=dict(i.slots))
            for i in group]


def phase_mesh_slice(rng, dev, card: str) -> dict:
    """Phase 7: eight partitions through drive_groups_on_mesh (counted), then
    the same groups alone through drive_group on the card, compared."""
    partitions = mesh_partitions(rng)
    fingerprints = {r.tables_fingerprint for r, _ in partitions}
    if len(fingerprints) != 1:
        raise AssertionError("partitions of the same XML fingerprint differently")
    for registry, _ in partitions:
        registry.device_tables_for(dev)
    # warm-up (first launches, pinned buffers), not counted
    warm = MR.MeshKernelRunner(mesh=M.make_mesh(N_SHARDS, dev))
    kb.drive_groups_on_mesh(warm, [(r, copy_group(g)) for r, g in partitions[:2]])
    torch.cuda.synchronize()
    runner = MR.MeshKernelRunner(mesh=M.make_mesh(N_SHARDS, dev), batch_window_s=0.002)
    A.reset_launch_counts()
    t0 = time.perf_counter()
    results = kb.drive_groups_on_mesh(runner, [(r, copy_group(g)) for r, g in partitions])
    torch.cuda.synchronize()
    mesh_wall = time.perf_counter() - t0
    launches = A.launch_counts()
    solo, solo_walls = [], []
    for registry, group in partitions:
        t0 = time.perf_counter()
        solo.append(kb.drive_group(registry.tables, registry.device_tables_for(dev),
                                   copy_group(group), device=dev))
        torch.cuda.synchronize()
        solo_walls.append(time.perf_counter() - t0)
    transitions = 0
    for k, (m, s) in enumerate(zip(results, solo)):
        if m.waves != s.waves:
            raise AssertionError(f"partition {k}: mesh traces differ from its solo run")
        if max_abs_err({n: v.cpu() for n, v in s.state.items()}, m.state):
            raise AssertionError(f"partition {k}: mesh final state differs from its solo run")
        if not bool(m.state["done"].all()) or bool(m.state["overflow"]):
            raise AssertionError(f"partition {k}: incomplete or overflowed")
        transitions += int(m.state["transitions"])
    if runner.coalesced_dispatches <= 0 or launches["sharded_collect"] <= 0:
        raise AssertionError(f"no coalesced dispatch ({runner.coalesced_dispatches}) or no "
                             f"sharded_collect launch ({launches['sharded_collect']})")
    steps = sum(m.steps for m in results)
    solo_wall = sum(solo_walls)
    log(f"phase7 mesh slice: {N_SHARDS} partitions x 2048 instances of mixed_definitions, "
        f"{sum(len(m.waves) for m in results)} waves, {steps} decoded steps; every "
        f"partition's traces and final state equal its solo drive_group run; dispatches "
        f"{runner.dispatches}, coalesced {runner.coalesced_dispatches}, groups "
        f"{runner.groups_dispatched}, windows slept {runner.windows_slept}")
    log(f"phase7 timing [{card}]: mesh {mesh_wall * 1e3:.3f} ms wall "
        f"({transitions / mesh_wall:.1f} transitions/s; time in run_group_on_mesh per "
        f"partition {[round(m.run_seconds * 1e3, 3) for m in results]} ms); "
        f"8 solo runs back to back {solo_wall * 1e3:.3f} ms "
        f"({transitions / solo_wall:.1f} transitions/s; device loop per group "
        f"{[round(s.run_seconds * 1e3, 3) for s in solo]} ms); launches {launches}")
    geometry = mesh_geometry_timings(partitions, dev, card)
    return {"launches": launches, "transitions": transitions, "mesh_wall": mesh_wall,
            "solo_wall": solo_wall, "steps": steps, "dispatches": runner.dispatches,
            "coalesced": runner.coalesced_dispatches, **geometry}


def mesh_geometry_timings(partitions, dev, card: str) -> dict:
    """At the mesh slice's geometry (the eight partitions' first-wave groups
    stacked): one sharded chunk against the same eight groups as eight
    run_collect calls, and the sharded lock-step kernels back to back
    against one group's. Not counted."""
    requests = []
    for registry, group in partitions:
        arrays, I, T = kb.build_group_arrays(registry.tables, copy_group(group))
        requests.append(MR.GroupRequest(registry.device_tables_for(dev),
                                        registry.tables.kernel_config,
                                        registry.tables_fingerprint, arrays, I, T,
                                        kb.MAX_STEPS, kb.CHUNK_STEPS))
    host, I, T = MR.stack_requests(requests, N_SHARDS)
    state = M.shard_state(host, M.make_mesh(N_SHARDS, dev))
    dt, config = requests[0].device_tables, requests[0].config
    collect = MR.MeshKernelRunner(mesh=M.make_mesh(N_SHARDS, dev))._sharded_collect(8, config)
    slices = [shard_slice(state, s) for s in range(N_SHARDS)]
    sharded_ms = time_ms(lambda: collect(dt, state), 20)
    loop_ms = time_ms(lambda: [A.run_collect(dt, x, n_steps=8, config=config)
                               for x in slices], 20)
    bits = kernels.MODE_AUTO_JOBS
    sstate = dict(state)
    for k in M._REPLICATED_KEYS:
        sstate[k] = torch.zeros((), dtype=state[k].dtype, device=dev)
    run = kernels.prepare(dt, sstate, config, bits, None, N_SHARDS, sharded=True)
    sharded_step_ms = time_ms(lambda: kernels.launch_steps(run, 8, bits, None, 0), 20) / 8
    one = kernels.prepare(dt, slices[0], config, bits, None)
    one_step_ms = time_ms(lambda: kernels.launch_steps(one, 8, bits, None, 0), 20) / 8
    log(f"phase7 geometry [{card}]: {N_SHARDS} shards x I={I} T={T} (mixed set): one "
        f"sharded chunk of 8 {sharded_ms:.4f} ms against the same {N_SHARDS} groups as "
        f"{N_SHARDS} run_collect calls {loop_ms:.4f} ms; sharded lock-step back to back "
        f"{sharded_step_ms:.4f} ms against one group's {one_step_ms:.4f} ms; bytes per "
        f"sharded lock-step {moved_bytes(dt, sstate, config)}")
    return {"geometry_chunk_ms": sharded_ms, "geometry_loop_ms": loop_ms,
            "geometry_step_ms": sharded_step_ms, "geometry_one_step_ms": one_step_ms}


def sharded_timings(info: dict) -> dict:
    """The sharded kernels' times at phase 6's geometry (NS = 8 shards of
    the serving geometry): one make_sharded_step call and one sharded
    collect chunk of 8 on a fresh batch, against their plain versions."""
    dt, config = info["dt"], info["config"]
    state, sstate, step, collect = info["state"], info["sstate"], info["step"], info["collect"]
    out = {
        "sharded_step": {
            "ms": time_ms(lambda: step(dt, sstate), 50),
            "plain_ms": time_ms(lambda: M.sharded_step_plain(dt, sstate, N_SHARDS, True,
                                                             config), 3),
            "bound_ms": bound_ms(dt, sstate, config),
            "bytes": moved_bytes(dt, sstate, config),
        },
        "sharded_collect": {
            "ms": time_ms(lambda: collect(dt, state), 20),
            "plain_ms": time_ms(lambda: MR.sharded_collect_plain(dt, state, 8, N_SHARDS,
                                                                 config), 2),
            "bound_ms": bound_ms(dt, state, config, nbytes([info["rows"]])),
            "bytes": moved_bytes(dt, state, config, nbytes([info["rows"]])),
        },
    }
    # the sharded lock-step kernels alone, back to back (auto jobs, no events)
    bits = kernels.MODE_AUTO_JOBS
    run = kernels.prepare(dt, sstate, config, bits, None, N_SHARDS, sharded=True)
    out["sharded_step"]["device_ms"] = time_ms(
        lambda: kernels.launch_steps(run, 8, bits, None, 0), 20) / 8
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    t0 = time.perf_counter()
    path = kernels.build(verbose=False)
    kernels.load()
    log(f"phase2 build: {path.name} in {time.perf_counter() - t0:.1f} s")

    worst = phase_kernel_vs_plain(rng, dev)
    slice_info = phase_slice(rng, dev, card)
    ceiling = phase_ceiling(dev, card)
    timing = serving_timings(slice_info)
    sharded = phase_sharded_vs_plain(rng, dev)
    mesh = phase_mesh_slice(rng, dev, card)
    stiming = sharded_timings(sharded)
    timing.update(stiming)
    worst.update(sharded["worst"])
    log(f"sharded timings [{card}] at {N_SHARDS} shards of the serving geometry: "
        f"sharded_step {stiming['sharded_step']['ms']:.4f} ms per call (plain "
        f"{stiming['sharded_step']['plain_ms']:.4f}), "
        f"{stiming['sharded_step']['device_ms']:.4f} ms per sharded lock-step back to back, "
        f"sharded_collect chunk {stiming['sharded_collect']['ms']:.4f} ms (plain "
        f"{stiming['sharded_collect']['plain_ms']:.4f}); bytes per step "
        f"{stiming['sharded_step']['bytes']}, per chunk {stiming['sharded_collect']['bytes']}; "
        f"launches on the mesh slice: sharded_step {mesh['launches']['sharded_step']} enqueued "
        f"({mesh['steps']} decoded partition steps), sharded_collect "
        f"{mesh['launches']['sharded_collect']}")
    log(f"serving timings [{card}] at {timing['geometry']}: "
        f"step {timing['step']['ms']:.4f} ms per wrapper call "
        f"(plain {timing['step']['plain_ms']:.4f}), "
        f"{timing['step']['device_ms']:.4f} ms per lock-step back to back, "
        f"run_collect chunk {timing['run_collect']['ms']:.4f} ms "
        f"(plain {timing['run_collect']['plain_ms']:.4f}); bytes per step "
        f"{timing['step_bytes']}, per chunk {timing['chunk_bytes']}; launches per group: "
        f"step {slice_info['launches']['step'] / 8} enqueued "
        f"({slice_info['decoded_steps'] / 8} decoded live steps), "
        f"run_collect {slice_info['launches']['run_collect'] / 8}")
    busy_ms = slice_info["decoded_steps"] * timing["step"]["device_ms"]
    log(f"phase4 busy estimate [{card}]: decoded live steps x back-to-back lock-step "
        f"= {busy_ms:.4f} ms of kernels in {slice_info['device_loop_ms']:.4f} ms of "
        f"device loop ({100 * busy_ms / slice_info['device_loop_ms']:.2f}%); derived, "
        f"not profiled")

    counts = {"step": slice_info["launches"]["step"],
              "run_collect": slice_info["launches"]["run_collect"],
              "run_to_completion": ceiling["launches"]["run_to_completion"],
              "sharded_step": mesh["launches"]["sharded_step"],
              "sharded_collect": mesh["launches"]["sharded_collect"]}
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on its main path")
    kernels_line = []
    for name in KERNELS:
        t = ceiling if name == "run_to_completion" else timing[name]
        kernels_line.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": counts[name],
            "max_abs_err": ceiling["err"] if name == "run_to_completion" else worst[name],
            "match": True, "tolerance": 0, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes", "library_ms": None,
        })
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
