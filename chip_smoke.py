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
8. DMN batch evaluation: the decision kernel (``csrc/decision.cu``) byte-
   equal to its plain version at the benchmark's geometry (``run_dmn_batch``:
   N = 200,000 contexts, I = 2, R = 8, K = 4) and at a wide one (N = 16,384,
   I = 4, R = 512, K = 4, random atoms of every kind and flag);
   ``batch_evaluate`` lists equal to the plain outputs' under every hit
   policy and COLLECT aggregation at both; a 2,000-context sample equal to
   the host DecisionEngine's unary tests; rows/s through ``batch_evaluate``
   with the share of the wall in ``pack_contexts``;
9. the device-fault seam on the card: a clean serving group (I = 2048, mixed
   set) driven through every wave at shadow rate 1.0 (the CPU oracle matches,
   nothing quarantined); at I = 256, injected corruption (every injection
   caught: by the shadow, which declines the group as device-shadow-
   mismatch, or contained as a typed decline), a stall past a 200 ms watchdog deadline (a typed wedge
   within the deadline plus 1 s, the ladder at SUSPECT), a dispatch
   exception (a typed dispatch error), and a flat thread count over 20
   wedges;
10. prints the kernels line (JSON), then the card line, then the result line.

Two paths run the automaton's steps (``ops/kernels.py``): the fused chunk,
one thread-block cluster per shard and ONE launch per chunk, for shards of
up to ``kernels.FUSED_MAX_TOKENS`` token slots (the serving geometry), and
the chain of per-phase launches above that and for run_to_completion.
Phases 3 and 6 hold both (the chain forced with ``path="chain"``) byte-equal
to the plain version, including chunks that go quiet before their last
step; phases 4 and 7 check that every serving chunk was one fused grid
launch. Beside them:

- phase 2 prints the fused kernel's registers and spills (``-Xptxas -v``)
  and ``cudaOccupancyMaxActiveClusters``; 8 shard clusters must fit;
- a ``torch.profiler`` window over two of phase 4's groups per path gives
  kernel time by name and the kernels' busy share of the device loop;
- the repeat phase runs the same fused chunk 50 times at I = 2048 and 50
  times at 8 shards, each byte-equal to the plain version;
- the A/B phase times the chain against the fused chunk in turns (chain,
  fused, fused, chain): a lock-step back to back, a chunk per call (and its
  host enqueue time), grid launches per chunk, the same at 8 shards, the
  phase 4 groups' device-loop and slice transitions/s, and a lock-step and
  a chunk at T = 8192, 16384, 32768 and 131072 (the shape rule's
  threshold, ``kernels.FUSED_MAX_TOKENS``, lies where the chain starts to
  win).

Imports neither JAX nor the JAX package. Launch counts are zeroed right
before each main path runs (phase 4 for step and run_collect, phase 5 for
run_to_completion, phase 7 for sharded_step and sharded_collect, phase 8's
``batch_evaluate`` at the benchmark's geometry for decision) and read right
after; comparison launches do not count. Each entry of the kernels line
names its path and its grid launches per call.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from zeebe_tpu_torch.dmn import parse_dmn_xml
from zeebe_tpu_torch.engine import kernel_backend as kb
from zeebe_tpu_torch.engine.device_health import SUSPECT, reset_shared_device_health
from zeebe_tpu_torch.models.bpmn import Bpmn, transform
from zeebe_tpu_torch.ops import automaton as A
from zeebe_tpu_torch.ops import decision as D
from zeebe_tpu_torch.ops import kernels
from zeebe_tpu_torch.ops.tables import compile_tables, f64_key_planes
from zeebe_tpu_torch.parallel import mesh as M
from zeebe_tpu_torch.parallel import mesh_runner as MR
from zeebe_tpu_torch.testing import workloads as W
from zeebe_tpu_torch.testing.catalog import ProcessCatalog
from zeebe_tpu_torch.testing.chaos_device import DeviceChaosController, DeviceFaultPlan

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# H100 SXM int32 rate: 64 integer add/compare/logic results per clock per SM
# (CUDA C++ Programming Guide, arithmetic throughput, compute capability
# 9.0) x 132 SMs x 1.98 GHz boost
INT32_OPS_PER_S = 64 * 132 * 1.98e9
SOURCES = {"decision": "zeebe_tpu_torch/csrc/decision.cu"}
REPLACES = {
    "step": "zeebe_tpu/ops/automaton.py:366",
    "run_collect": "zeebe_tpu/ops/automaton.py:704",
    "run_to_completion": "zeebe_tpu/ops/automaton.py:773",
    "sharded_step": "zeebe_tpu/parallel/mesh.py:102",
    "sharded_collect": "zeebe_tpu/parallel/mesh_runner.py:233",
    "decision": "zeebe_tpu/ops/decision.py:343",
}
KERNELS = ("step", "run_collect", "run_to_completion", "sharded_step", "sharded_collect",
           "decision")
# each kernel's path on its main path: the fused chunk (one cluster launch
# per call, plus the counter combine for the sharded step), the chain of
# per-phase launches, or (decision) one kernel of its own
MAIN_PATH = {"step": "fused", "run_collect": "fused", "run_to_completion": "chain",
             "sharded_step": "fused", "sharded_collect": "fused", "decision": None}
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


def chain_collect(dt, state: dict, n_steps: int, config):
    """run_collect forced onto the chain (a ``collect`` for run_group)."""
    return kernels.run_steps(dt, state, n_steps, config, auto_jobs=False, emit_events=True,
                             mode="collect", path="chain")


def fused_collect(dt, state: dict, n_steps: int, config):
    """run_collect forced onto the fused chunk."""
    return kernels.run_steps(dt, state, n_steps, config, auto_jobs=False, emit_events=True,
                             mode="collect", path="fused")


COLLECT = {"chain": chain_collect, "fused": fused_collect}
AB_TURNS = ("chain", "fused", "fused", "chain")


def lockstep_ms(dt, state: dict, config, path: str, num_shards: int = 1) -> float:
    """One lock-step of a path back to back (auto jobs, no events): the
    copy-in plus 16 steps less the copy-in plus 8, over 8, on buffers
    allocated once (no wrapper work)."""
    bits = kernels.MODE_AUTO_JOBS
    run = kernels.allocate(dt, state, config, num_shards, sharded=num_shards > 1)

    def steps(n):
        if path == "fused":
            return lambda: kernels.launch_fused(run, n, bits, None, 0)
        return lambda: (kernels.launch_prepare(run, bits, None),
                        kernels.launch_steps(run, n, bits, None, 0))

    return (time_ms(steps(16), 20) - time_ms(steps(8), 20)) / 8


def host_ms(fn, reps: int) -> float:
    """Host milliseconds per call to enqueue ``fn`` (no synchronization
    inside the loop): the wrapper's Python and the launches' CPU side."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    out = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return out


def pct(share: float | None) -> str:
    return "not measured" if share is None else f"{100 * share:.2f}%"


def grid_per_call(fn) -> int:
    """CUDA grid launches one call enqueues (GRID_LAUNCHES, all paths)."""
    A.reset_launch_counts()
    fn()
    return sum(A.grid_launch_counts().values())


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
    mid_exits = 0  # chunks whose shard went quiet before their last step
    for name, models, T in runs:
        tables = compile_tables([transform(m) for m in models])
        dt = A.DeviceTables.from_numpy(tables, dev)
        config = tables.kernel_config
        state, T = group_setup(tables, 2048, T, rng, dev)
        if kernels.choose_path(T) != "fused":
            raise AssertionError(f"{name}: T={T} does not take the fused chunk")
        ks = cs = ps = state
        chunks = 0
        for _ in range(24):
            A.reset_launch_counts()
            ks, krows = A.run_collect(dt, ks, n_steps=8, config=config)
            if A.grid_launch_counts() != {"fused": 1, "chain": 0, "combine": 0}:
                raise AssertionError(f"{name}: run_collect was not one fused launch")
            cs, crows = chain_collect(dt, cs, n_steps=8, config=config)
            ps, prows = A.run_collect_plain(dt, ps, n_steps=8, config=config)
            chunks += 1
            err = max(max_abs_err({"rows": krows}, {"rows": prows}), max_abs_err(ks, ps),
                      max_abs_err({"rows": crows}, {"rows": prows}), max_abs_err(cs, ps))
            worst["run_collect"] = max(worst["run_collect"], err)
            if err:
                raise AssertionError(f"{name}: run_collect (fused or chain) differs from "
                                     f"plain (chunk {chunks})")
            quiet = torch.nonzero(krows[:, -2] == 0).flatten()
            if quiet.numel() and int(quiet[0]) < krows.shape[0] - 1:
                mid_exits += 1
            jobs = kb.parked_jobs(tables, ks)
            if jobs.size == 0 and int(krows[:, -2].eq(0).any()):
                break
            if jobs.size:
                ks, cs, ps = (A.complete_jobs(x, jobs) for x in (ks, cs, ps))
        if name == "fork_join_overflow" and not bool(ks["overflow"]):
            raise AssertionError("forced overflow was not flagged")
        if name == "nomatch" and not bool(ks["incident"].any()):
            raise AssertionError("no-match stall raised no incident")
        if name not in ("fork_join_overflow", "nomatch") and not bool(ks["done"].all()):
            raise AssertionError(f"{name}: not every instance completed")
        log(f"phase3 {name}: I=2048 T={T} chunks={chunks} rows and state byte-equal "
            f"to plain on the fused path and the forced chain "
            f"(transitions={int(ks['transitions'])})")
        # single steps with events, both job modes, both paths
        for auto_jobs in (False, True):
            ks = cs = ps = state
            for _ in range(6):
                ks, kev = A.step(dt, ks, auto_jobs=auto_jobs, emit_events=True, config=config)
                cs, crows = kernels.run_steps(dt, cs, 1, config, auto_jobs=auto_jobs,
                                              emit_events=True, mode="step", path="chain")
                ps, pev = A.step_plain(dt, ps, auto_jobs=auto_jobs, emit_events=True,
                                       config=config)
                cev = A._unpack_events_tensor(crows[0, :-2].view(T, -1), 2048)
                err = max(max_abs_err(ks, ps), max_abs_err(kev, pev), max_abs_err(cs, ps),
                          max_abs_err(cev, pev))
                worst["step"] = max(worst["step"], err)
                if err:
                    raise AssertionError(f"{name}: step (fused or chain) differs from plain")
    if mid_exits == 0:
        raise AssertionError("no chunk of phase 3 went quiet before its last step")
    log(f"phase3: {mid_exits} chunks left their loop before their last step (rows after "
        f"the exit zero on both paths, as the plain version leaves them)")
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
    grid = A.grid_launch_counts()
    if grid != {"fused": launches["run_collect"], "chain": 0, "combine": 0}:
        raise AssertionError(f"the serving chunks were not one fused launch each: {grid}, "
                             f"{launches['run_collect']} run_collect calls")
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
        f"{transitions / sum(run_s):.1f} transitions/s in the device loop; grid launches "
        f"{grid} for {launches['run_collect']} chunks")
    return {"launches": launches, "tables": tables, "dt": dt, "groups": groups,
            "transitions_per_s": transitions / wall, "wall_per_group_ms": wall / 8 * 1e3,
            "decoded_steps": sum(r.steps for r in results),
            "device_loop_ms": sum(run_s) * 1e3}


def slice_rates(info: dict, collect, dev) -> dict:
    """The phase 4 groups once more through ``collect`` (not counted):
    transitions/s over the wall and over the device loop."""
    tables, dt = info["tables"], info["dt"]
    transitions, wall, loop = 0, 0.0, 0.0
    for g in info["groups"]:
        t0 = time.perf_counter()
        r = kb.drive_group(tables, dt, copy_group(g), device=dev, collect=collect)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        loop += r.run_seconds
        transitions += int(r.state["transitions"])
    return {"slice": transitions / wall, "loop": transitions / loop}


def phase_profile(info: dict, dev, card: str) -> dict:
    """A torch.profiler window over a steady part of phase 4 (two of its
    groups once more, each path, after warm-up): kernel time by name and
    the kernels' share of the device loop (time in run_group)."""
    from torch.profiler import ProfilerActivity, profile

    tables, dt = info["tables"], info["dt"]
    out = {}
    for path in ("fused", "chain"):
        kb.drive_group(tables, dt, copy_group(info["groups"][0]), device=dev,
                       collect=COLLECT[path])  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            runs = [kb.drive_group(tables, dt, copy_group(g), device=dev,
                                   collect=COLLECT[path]) for g in info["groups"][1:3]]
            torch.cuda.synchronize()
        loop_ms = sum(r.run_seconds for r in runs) * 1e3
        by_name = {}
        for e in prof.key_averages():
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
                by_name[e.key] = by_name.get(e.key, 0.0) + e.device_time_total / 1e3
        copies = sum(ms for k, ms in by_name.items() if "memcpy" in k.lower()
                     or "memset" in k.lower())
        kernel_ms = sum(by_name.values()) - copies
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        share = kernel_ms / loop_ms if loop_ms and kernel_ms else None
        out[path] = {"kernel_ms": kernel_ms, "copy_ms": copies, "loop_ms": loop_ms,
                     "share": share}
        log(f"phase4 profile {path} [{card}]: 2 groups, device loop {loop_ms:.4f} ms, "
            f"kernels {kernel_ms:.4f} ms ({pct(share)} busy), "
            f"copies and sets {copies:.4f} ms; by name (ms) "
            f"{[(k[:60], round(v, 4)) for k, v in top]}")
    return out


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
    grid = grid_per_call(lambda: A.run_to_completion(dt, state, max_steps=64, config=config))
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
            "err": err, "step_ms": step_ms, "grid_launches": grid}


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
        "chain_ms": time_ms(lambda: chain_collect(dt, state, 8, config), 50),
        "grid_launches": grid_per_call(lambda: A.run_collect(dt, state, n_steps=8,
                                                             config=config)),
        "chain_grid_launches": grid_per_call(lambda: chain_collect(dt, state, 8, config)),
    }
    _, rows = A.run_collect(dt, state, n_steps=8, config=config)
    out["run_collect"]["bound_ms"] = bound_ms(dt, state, config, nbytes([rows]))
    out["step"] = {
        "ms": time_ms(lambda: A.step(dt, state, auto_jobs=False, config=config), 100),
        "plain_ms": time_ms(lambda: A.step_plain(dt, state, auto_jobs=False,
                                                 config=config), 10),
        "bound_ms": bound_ms(dt, state, config),
        # the lock-step alone, back to back, without the wrapper's host work
        "device_ms": lockstep_ms(dt, state, config, "fused"),
        "chain_ms": time_ms(lambda: kernels.run_steps(
            dt, state, 1, config, auto_jobs=False, emit_events=False, mode="step",
            path="chain"), 100),
        "chain_device_ms": lockstep_ms(dt, state, config, "chain"),
        "grid_launches": grid_per_call(lambda: A.step(dt, state, auto_jobs=False,
                                                      config=config)),
    }
    out["geometry"] = f"I={I} T={T} E={tables.max_elements} FO={tables.out_target.shape[2]}"
    out.update(dt=dt, config=config, state=state)
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

    # sharded collect, chunk by chunk with job waves: the runner's (fused)
    # and the forced chain against the plain version
    ks = cs = ps = state
    quiet_at = {}
    for chunk in range(24):
        kprev = ks
        A.reset_launch_counts()
        ks, krows = collect(dt, ks)
        if A.grid_launch_counts() != {"fused": 1, "chain": 0, "combine": 0}:
            raise AssertionError("the sharded chunk was not one fused launch")
        cs, crows = kernels.run_steps(dt, cs, 8, config, auto_jobs=False, emit_events=True,
                                      mode="collect", num_shards=N_SHARDS, sharded=True,
                                      path="chain")
        ps, prows = MR.sharded_collect_plain(dt, ps, 8, N_SHARDS, config)
        err = max(max_abs_err({"rows": krows}, {"rows": prows}), max_abs_err(ks, ps),
                  max_abs_err({"rows": crows}, {"rows": prows}), max_abs_err(cs, ps))
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
            ks, cs, ps = (A.complete_jobs(x, jobs) for x in (ks, cs, ps))
            quiet_at = {}  # a wave restarts every shard's loop
    overflow = ks["overflow"].cpu().tolist()
    done = ks["done"].view(N_SHARDS, I).cpu()
    if overflow != [False, False, True] + [False] * 5:
        raise AssertionError(f"overflow should mark shard 2 alone: {overflow}")
    for s in (0, 1, 3, 4, 5, 6, 7):
        if not bool(done[s].all()):
            raise AssertionError(f"shard {s}: not every instance completed")
    log(f"phase6 sharded_collect: {N_SHARDS} shards x I={I} T={T} FO={FO}, {chunk + 1} chunks "
        f"with job waves, rows and state of the fused chunk and of the forced chain "
        f"byte-equal to the plain version, and to run_collect alone on each shard; "
        f"overflow {overflow}; "
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
    ks = cs = ps = sstate
    for k in range(6):
        kprev = ks
        ks = step(dt, ks)
        cs = kernels.run_sharded_step(dt, cs, N_SHARDS, config, True, path="chain")
        ps = M.sharded_step_plain(dt, ps, N_SHARDS, True, config)
        err = max(max_abs_err(ks, ps), max_abs_err(cs, ps))
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
    log(f"phase6 sharded_step: 6 steps, fused and forced chain, byte-equal to the plain "
        f"version and (fused) to step alone on each shard (transitions "
        f"{int(ks['transitions'])}, overflow "
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
    grid = A.grid_launch_counts()
    if grid != {"fused": launches["sharded_collect"], "chain": 0, "combine": 0}:
        raise AssertionError(f"the mesh chunks were not one fused launch each: {grid}, "
                             f"{launches['sharded_collect']} sharded chunks")
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
        f"{[round(s.run_seconds * 1e3, 3) for s in solo]} ms); launches {launches}, "
        f"grid launches {grid}")
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
    sstate = dict(state)
    for k in M._REPLICATED_KEYS:
        sstate[k] = torch.zeros((), dtype=state[k].dtype, device=dev)
    sharded_step_ms = lockstep_ms(dt, sstate, config, "fused", N_SHARDS)
    one_step_ms = lockstep_ms(dt, slices[0], config, "fused")
    log(f"phase7 geometry [{card}]: {N_SHARDS} shards x I={I} T={T} (mixed set): one "
        f"sharded chunk of 8 {sharded_ms:.4f} ms against the same {N_SHARDS} groups as "
        f"{N_SHARDS} run_collect calls {loop_ms:.4f} ms; sharded lock-step back to back "
        f"{sharded_step_ms:.4f} ms against one group's {one_step_ms:.4f} ms; bytes per "
        f"sharded lock-step {moved_bytes(dt, sstate, config)}")
    return {"geometry_chunk_ms": sharded_ms, "geometry_loop_ms": loop_ms,
            "geometry_step_ms": sharded_step_ms, "geometry_one_step_ms": one_step_ms,
            "geo": {"dt": dt, "config": config, "state": state, "sstate": sstate}}


def phase_repeat(serving: dict, geo: dict, card: str) -> None:
    """The same fused chunk 50 times at I = 2048 and 50 times at 8 shards,
    each output byte-equal to the plain version's (a visibility race between
    the blocks of a cluster would show as one run that differs)."""
    cases = {
        "I=2048": (serving["dt"], serving["state"], serving["config"], 1),
        f"{N_SHARDS} shards": (geo["dt"], geo["state"], geo["config"], N_SHARDS),
    }
    for label, (dt, state, config, ns) in cases.items():
        if ns == 1:
            want_state, want_rows = A.run_collect_plain(dt, state, n_steps=8, config=config)
        else:
            want_state, want_rows = MR.sharded_collect_plain(dt, state, 8, ns, config)
        for k in range(50):
            got_state, got_rows = kernels.run_steps(
                dt, state, 8, config, auto_jobs=False, emit_events=True, mode="collect",
                num_shards=ns, sharded=ns > 1, path="fused")
            if max(max_abs_err({"rows": got_rows}, {"rows": want_rows}),
                   max_abs_err(got_state, want_state)):
                raise AssertionError(f"repeat {k} of the fused chunk at {label} differs")
        log(f"phase repeat [{card}]: 50 fused chunks at {label}, each byte-equal to plain")


def phase_ab(serving: dict, geo: dict, slice_info: dict, rng, dev, card: str) -> dict:
    """The chain against the fused chunk in one call, in turns (chain,
    fused, fused, chain): at the serving geometry a lock-step back to back,
    a chunk per call (its host enqueue time too) and the grid launches per
    chunk; at the mesh geometry the same for 8 shards; the phase 4 groups'
    device-loop and slice transitions/s; and, for the shape rule, a
    lock-step and a chunk of the mixed set at T = 8192, 16384, 32768, 131072
    (I = T / 4). Fused and chain outputs are held byte-equal at each T."""
    dt, state, config = serving["dt"], serving["state"], serving["config"]
    gdt, gstate, gsstate, gconfig = geo["dt"], geo["state"], geo["sstate"], geo["config"]
    tables = slice_info["tables"]
    sweep = {}
    for T in (8192, 16384, 32768, 131072):
        sweep[T], _ = group_setup(tables, T // 4, T, rng, dev)
        f = fused_collect(dt, sweep[T], 8, config)
        c = chain_collect(dt, sweep[T], 8, config)
        if max(max_abs_err({"rows": f[1]}, {"rows": c[1]}), max_abs_err(f[0], c[0])):
            raise AssertionError(f"fused and chain chunks differ at T={T}")

    def sharded(path):
        return lambda: kernels.run_steps(gdt, gstate, 8, gconfig, auto_jobs=False,
                                         emit_events=True, mode="collect",
                                         num_shards=N_SHARDS, sharded=True, path=path)

    turns = []
    for path in AB_TURNS:
        chunk = lambda: COLLECT[path](dt, state, 8, config)  # noqa: E731
        r = {"lockstep_ms": lockstep_ms(dt, state, config, path),
             "chunk_ms": time_ms(chunk, 50), "chunk_host_ms": host_ms(chunk, 50),
             "grid_per_chunk": grid_per_call(chunk),
             "sharded_lockstep_ms": lockstep_ms(gdt, gsstate, gconfig, path, N_SHARDS),
             "sharded_chunk_ms": time_ms(sharded(path), 20),
             "sharded_grid_per_chunk": grid_per_call(sharded(path))}
        rates = slice_rates(slice_info, COLLECT[path], dev)
        r["loop_tps"], r["slice_tps"] = rates["loop"], rates["slice"]
        for T, st in sweep.items():
            r[f"lockstep_ms_T{T}"] = lockstep_ms(dt, st, config, path)
            r[f"chunk_ms_T{T}"] = time_ms(lambda: COLLECT[path](dt, st, 8, config), 10)
        turns.append(r)
    log(f"phase A/B [{card}] turns {list(AB_TURNS)}:")
    for key in turns[0]:
        log(f"  {key}: {[round(r[key], 6) if isinstance(r[key], float) else r[key] for r in turns]}")
    return {"turns": turns}


def sharded_timings(info: dict) -> dict:
    """The sharded kernels' times at phase 6's geometry (NS = 8 shards of
    the serving geometry): one make_sharded_step call and one sharded
    collect chunk of 8 on a fresh batch, against their plain versions."""
    dt, config = info["dt"], info["config"]
    state, sstate, step, collect = info["state"], info["sstate"], info["step"], info["collect"]
    def chain_chunk():
        return kernels.run_steps(dt, state, 8, config, auto_jobs=False, emit_events=True,
                                 mode="collect", num_shards=N_SHARDS, sharded=True,
                                 path="chain")

    out = {
        "sharded_step": {
            "ms": time_ms(lambda: step(dt, sstate), 50),
            "plain_ms": time_ms(lambda: M.sharded_step_plain(dt, sstate, N_SHARDS, True,
                                                             config), 3),
            "bound_ms": bound_ms(dt, sstate, config),
            "bytes": moved_bytes(dt, sstate, config),
            "chain_ms": time_ms(lambda: kernels.run_sharded_step(
                dt, sstate, N_SHARDS, config, True, path="chain"), 50),
            "chain_device_ms": lockstep_ms(dt, sstate, config, "chain", N_SHARDS),
            "grid_launches": grid_per_call(lambda: step(dt, sstate)),
        },
        "sharded_collect": {
            "ms": time_ms(lambda: collect(dt, state), 20),
            "plain_ms": time_ms(lambda: MR.sharded_collect_plain(dt, state, 8, N_SHARDS,
                                                                 config), 2),
            "bound_ms": bound_ms(dt, state, config, nbytes([info["rows"]])),
            "bytes": moved_bytes(dt, state, config, nbytes([info["rows"]])),
            "chain_ms": time_ms(chain_chunk, 20),
            "grid_launches": grid_per_call(lambda: collect(dt, state)),
            "chain_grid_launches": grid_per_call(chain_chunk),
        },
    }
    # the sharded lock-step alone, back to back (auto jobs, no events)
    out["sharded_step"]["device_ms"] = lockstep_ms(dt, sstate, config, "fused", N_SHARDS)
    return out


# ---------------------------------------------------------------------------
# DMN batch evaluation (phase 8) and the device-fault seam (phase 9)


POLICIES = (("FIRST", ""), ("UNIQUE", ""), ("ANY", ""), ("RULE ORDER", ""), ("COLLECT", ""),
            ("COLLECT", "SUM"), ("COLLECT", "MIN"), ("COLLECT", "MAX"), ("COLLECT", "COUNT"))
# int32 operations of an atom test whose result depends on the context:
# RANGE, both lexicographic ends (3 compares and 2 logic ops each) and
# their AND; EQ, two compares and their AND
RANGE_OPS, EQ_OPS = 11, 3


def decision_bound(atoms, keys, valid) -> dict:
    """Least time for one evaluation on the card: the bytes (every input
    read once, m, selected and counts written once) over the HBM rate, and
    the integer operations the function needs over the int32 rate; the
    larger bounds it. Only work whose result depends on the context counts:
    kinds and flags are table constants, a cell holding an A_TRUE atom
    always matches, and a cell of A_PAD atoms never does, nor its rule. Per
    context: a validity test per input; per cell that depends on the
    context, its RANGE and EQ tests, the ORs joining them, an AND with the
    validity and an AND into its rule; per rule that can match, a count and
    a first-match update."""
    kind = atoms[0].cpu().numpy()
    N = keys.shape[0]
    I, R, _ = kind.shape
    moved = nbytes(list(atoms) + [keys, valid]) + N * R + 8 * N
    tests = (kind == D.A_RANGE).sum(-1) + (kind == D.A_EQ).sum(-1)  # [I, R]
    always = (kind == D.A_TRUE).any(-1)
    never = ~always & (tests == 0)
    can_match = ~never.any(0)  # [R]
    varies = ~always & ~never & can_match[None, :]
    cell_ops = (RANGE_OPS * (kind == D.A_RANGE).sum(-1) + EQ_OPS * (kind == D.A_EQ).sum(-1)
                + (tests - 1) + 2)
    ops = N * (I + int(cell_ops[varies].sum()) + 2 * int(can_match.sum()))
    byte_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"bytes": moved, "ops": ops, "bound_ms": max(byte_ms, ops_ms),
            "bound_by": "bytes" if byte_ms >= ops_ms else "operations"}


def decision_err(got, want) -> int:
    """Byte-equality of (m, selected, counts): dtypes and shapes must match;
    returns the largest absolute difference (0 when byte-equal)."""
    for name, a, b in zip(("m", "selected", "counts"), got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"decision {name}: {a.dtype}{tuple(a.shape)} vs "
                                 f"{b.dtype}{tuple(b.shape)}")
    return max_abs_err(dict(zip("msc", got)), dict(zip("msc", want)))


def decision_device_ms(atoms, keys, valid) -> tuple[float, float | None]:
    """The decision kernel without its wrapper: raw launches back to back on
    preallocated outputs (CUDA events), and the kernel's own time from a
    torch.profiler trace of 20 launches (None when the trace shows none)."""
    lib = kernels.load().lib
    N, I, R, K = keys.shape[0], *atoms[0].shape
    m = torch.empty((N, R), dtype=torch.bool, device=keys.device)
    counts = torch.empty(N, dtype=torch.int32, device=keys.device)
    selected = torch.empty_like(counts)
    args = ([a.data_ptr() for a in atoms] + [keys.data_ptr(), valid.data_ptr(), N, I, R, K,
            m.data_ptr(), counts.data_ptr(), selected.data_ptr(),
            torch.cuda.current_stream().cuda_stream])
    back_to_back = time_ms(lambda: lib.zt_decision(*args), 200)
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                lib.zt_decision(*args)
            torch.cuda.synchronize()
        total_us = sum(getattr(e, "device_time_total", 0) or 0 for e in prof.key_averages()
                       if "k_decision" in e.key)
    except RuntimeError as exc:  # no CUPTI trace on this machine: not measured
        log(f"torch.profiler gave no trace: {exc}")
        total_us = 0
    return back_to_back, (total_us / 20 / 1e3 if total_us > 0 else None)


def wide_table(rng, I: int = 4, R: int = 512, K: int = 4) -> D.DeviceDecisionTable:
    """A table of R random rules over I numeric inputs: every atom kind and
    flag, endpoints the f64 keys of values in [-50, 50] (EQ on integers) or
    the open-ended sentinels the compiler writes, numeric outputs."""
    def planes(values):
        return np.array([f64_key_planes(float(v)) for v in values.reshape(-1)],
                        np.int32).reshape(values.shape + (2,))

    kind = rng.integers(0, 4, (I, R, K)).astype(np.int32)
    flags = rng.integers(0, 4, (I, R, K)).astype(np.int32)
    lo = planes(rng.integers(-50, 40, (I, R, K)).astype(np.float64))
    hi = planes(rng.integers(-40, 51, (I, R, K)).astype(np.float64))
    lo[rng.random((I, R, K)) < 0.15] = D._INT32_MIN
    hi[rng.random((I, R, K)) < 0.15] = D._INT32_MAX
    return D.DeviceDecisionTable(
        decision_id="wide", hit_policy="FIRST", aggregation="",
        input_names=[f"x{i}" for i in range(I)], input_kinds=["num"] * I,
        kind=kind, lo=lo, hi=hi, flags=flags,
        out_values=rng.integers(-20, 100, R).astype(np.float64) / 4, str_ids={},
        num_rules=R)


def wide_contexts(rng, n: int, I: int = 4) -> list[dict]:
    """Integers (EQ can match), floats and nulls over [-50, 50]."""
    ints = rng.integers(-50, 51, (n, I))
    floats = rng.uniform(-50, 50, (n, I))
    roll = rng.random((n, I))
    return [{f"x{i}": (None if roll[c, i] < 0.1 else int(ints[c, i]) if roll[c, i] < 0.55
                      else float(floats[c, i])) for i in range(I)} for c in range(n)]


def host_matches(decision, ctx: dict) -> list[int]:
    """Matched rule indices per the host DecisionEngine's unary tests."""
    values = [inp.expression.evaluate(ctx, lambda: 0) if inp.expression else None
              for inp in decision.inputs]
    return [r for r, rule in enumerate(decision.rules)
            if all(t(v, ctx) for t, v in zip(rule.tests, values))]


def check_lists(table, contexts, plain, label: str, dev) -> None:
    """batch_evaluate (the kernel) under every hit policy against the
    policy's decision over the plain version's outputs."""
    m, sel, cnt = (t.cpu().numpy() for t in plain)
    for hit, agg in POLICIES:
        if isinstance(table, str):
            t = D.compile_decision_table(parse_dmn_xml(W.dmn_band_xml(hit, agg))
                                         .decisions["band"])
        else:
            t = dataclasses.replace(table, hit_policy=hit, aggregation=agg)
        if D.batch_evaluate(t, contexts, device=dev) != D.decide(t, m, sel, cnt):
            raise AssertionError(f"{label}: batch_evaluate lists differ under {hit} {agg}")


def phase_decision(rng, dev, card: str) -> dict:
    """Phase 8: the main path (batch_evaluate at the benchmark's geometry,
    counted), then the kernel against the plain version at both geometries."""
    decision = parse_dmn_xml(W.dmn_band_xml()).decisions["band"]
    table = D.compile_decision_table(decision)
    contexts = W.dmn_band_contexts(200_000)
    D.batch_evaluate(table, contexts[:1000], device=dev)  # warm-up, not counted
    torch.cuda.synchronize()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    out = D.batch_evaluate(table, contexts, device=dev)
    wall = time.perf_counter() - t0
    launches = A.launch_counts()
    # the call's three stages once more, one by one (not counted)
    t0 = time.perf_counter()
    keys, valid = table.pack_contexts(contexts)
    t1 = time.perf_counter()
    outs = D.evaluate_batch(*(torch.from_numpy(a).to(dev) for a in
                              (table.kind, table.lo, table.hi, table.flags, keys, valid)))
    outs = [o.cpu().numpy() for o in outs]
    t2 = time.perf_counter()
    D.decide(table, *outs)
    t3 = time.perf_counter()
    stages = t3 - t0
    log(f"phase8 batch_evaluate [{card}]: {len(contexts)} contexts, FIRST, "
        f"{sum(o is not None for o in out)} matched, {wall * 1e3:.3f} ms "
        f"({len(contexts) / wall:.1f} rows/s, host-bound); stages timed apart: "
        f"pack_contexts {(t1 - t0) * 1e3:.3f} ms ({100 * (t1 - t0) / stages:.1f}%), "
        f"copy in + kernel + copy out {(t2 - t1) * 1e3:.3f} ms "
        f"({100 * (t2 - t1) / stages:.1f}%), hit policy {(t3 - t2) * 1e3:.3f} ms "
        f"({100 * (t3 - t2) / stages:.1f}%)")
    info = {"launches": launches, "rows_per_s": len(contexts) / wall, "err": 0,
            "pack_share": (t1 - t0) / stages}

    sample = rng.choice(len(contexts), 2000, replace=False)
    rule_order = D.compile_decision_table(
        parse_dmn_xml(W.dmn_band_xml("RULE ORDER")).decisions["band"])
    matched = D.batch_evaluate(rule_order, [contexts[i] for i in sample], device=dev)
    for i, got in zip(sample, matched):
        if got != host_matches(decision, contexts[i]):
            raise AssertionError(f"context {contexts[i]}: kernel {got}, host engine "
                                 f"{host_matches(decision, contexts[i])}")

    wtable = wide_table(rng)
    wcontexts = wide_contexts(rng, 16_384)
    geometries = {"bench": (table, contexts, keys, valid)}
    geometries["wide"] = (wtable, wcontexts) + wtable.pack_contexts(wcontexts)
    for name, (t, ctxs, k, v) in geometries.items():
        atoms = [torch.from_numpy(a).to(dev) for a in (t.kind, t.lo, t.hi, t.flags)]
        kk, vv = torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev)
        got = D.evaluate_batch(*atoms, kk, vv)
        plain = D._evaluate_batch(*atoms, kk, vv)
        err = decision_err(got, plain)
        info["err"] = max(info["err"], err)
        if err:
            raise AssertionError(f"{name}: decision kernel differs from plain")
        check_lists("band" if name == "bench" else t, ctxs, plain, name, dev)
        bound = decision_bound(atoms, kk, vv)
        ms = time_ms(lambda: kernels.run_decision(*atoms, kk, vv), 50)
        plain_ms = time_ms(lambda: D._evaluate_batch(*atoms, kk, vv), 3)
        device_ms, profiled_ms = decision_device_ms(atoms, kk, vv)
        A.reset_launch_counts()
        kernels.run_decision(*atoms, kk, vv)
        grid = A.launch_counts()["decision"]
        info[name] = {"ms": ms, "plain_ms": plain_ms, "device_ms": device_ms,
                      "profiled_ms": profiled_ms, "grid_launches": grid, **bound}
        N = k.shape[0]
        I, R, K = t.kind.shape
        log(f"phase8 {name} [{card}]: N={N} I={I} R={R} K={K}, m/selected/counts "
            f"byte-equal to plain, lists equal under {len(POLICIES)} policies, "
            f"{int(got[2].gt(0).sum())} contexts matched; wrapper call {ms:.4f} ms, "
            f"launches back to back {device_ms:.4f} ms, kernel by the profiler "
            f"{'not measured' if profiled_ms is None else f'{profiled_ms:.4f} ms'}, "
            f"plain {plain_ms:.4f} ms; bound {bound['bound_ms'] * 1e3:.3f} us by "
            f"{bound['bound_by']} ({bound['bytes']} B, {bound['ops']} int32 ops)")
    return info


def seam_group(tables, n: int, rng, dev):
    """A fresh mixed-set serving group of n instances on the card."""
    insts = make_group(tables, n, rng)
    arrays, I, T = kb.build_group_arrays(tables, insts)
    return insts, kb.group_state(arrays, dev), I, T


def phase_fault_seam(rng, dev, card: str, tables, dt) -> dict:
    """Phase 9: the device-fault seam on the card. Resets the chaos plane
    and the shared ladder before and after."""
    config = tables.kernel_config
    kb.install_device_chaos(None)
    reset_shared_device_health()
    try:
        # a clean serving group through every wave, every wave shadowed
        defense = kb.DeviceDefense()
        defense.health.cfg.shadow_sample_rate = 1.0
        insts = make_group(tables, 2048, rng)
        copy = [kb.GroupInstance(idx=i.idx, definition=i.definition, slots=dict(i.slots))
                for i in insts]
        got = kb.drive_group(tables, dt, insts, device=dev, defense=defense)
        want = kb.drive_group(tables, dt, copy, device=dev)
        health = defense.health
        if got.waves != want.waves or max_abs_err(got.state, want.state):
            raise AssertionError("shadowed clean group differs from the unshadowed run")
        if defense.shadow_quarantined or health.shadow_mismatches or not health.shadow_checks:
            raise AssertionError(f"clean group: {health.shadow_checks} checks, "
                                 f"{health.shadow_mismatches} mismatches, "
                                 f"{defense.shadow_quarantined} quarantined")
        oracle_ms = defense.shadow_seconds / health.shadow_checks * 1e3
        log(f"phase9 shadow [{card}]: clean group I=2048 mixed set, {len(got.waves)} waves "
            f"all shadowed, 0 mismatches, 0 quarantined; CPU oracle {oracle_ms:.3f} ms per "
            f"shadowed group (wave)")
        info = {"oracle_ms": oracle_ms}

        # corruption at I = 256: every injection caught
        reset_shared_device_health()
        defense = kb.DeviceDefense()
        defense.health.cfg.shadow_sample_rate = 1.0
        with tempfile.TemporaryDirectory() as tmp:
            controller = DeviceChaosController(
                DeviceFaultPlan(seed=5, corrupt_p=1.0, flips=3), "smoke")
            controller.ledger_file = f"{tmp}/ledger.jsonl"
            how = []
            for _ in range(8):
                _, state, I, T = seam_group(tables, 256, rng, dev)
                kb.install_device_chaos(None)
                if kb.run_group(dt, config, state, I, T).fail_reason is not None:
                    raise AssertionError("the clean run of a corruption group failed")
                kb.install_device_chaos(controller)
                out = kb.run_group(dt, config, state, I, T, defense=defense)
                kb.install_device_chaos(None)
                if out.fail_reason == "device-shadow-mismatch" and out.state is state:
                    how.append("shadow")
                elif out.fail_reason in ("no-quiesce", "token-overflow"):
                    how.append("contained")
                else:
                    raise AssertionError(f"corrupt group declined as {out.fail_reason}")
            with open(controller.ledger_file) as f:
                lines = [json.loads(line) for line in f]
        injected = {e["seq"] for e in lines if e["kind"] == "inject"}
        caught = {e["seq"] for e in lines if e["kind"] == "caught"}
        if not injected or injected != caught:
            raise AssertionError(f"injections {sorted(injected)}, caught {sorted(caught)}")
        if defense.shadow_quarantined != how.count("shadow"):
            raise AssertionError(f"{defense.shadow_quarantined} quarantined, "
                                 f"{how.count('shadow')} shadow declines")
        log(f"phase9 corrupt [{card}]: I=256, 8 groups, {len(injected)} injections of 3 "
            f"flips, all caught ({how.count('shadow')} groups by the shadow, declined as "
            f"device-shadow-mismatch, {how.count('contained')} contained as typed "
            f"declines)")

        # a stall past a 200 ms deadline, 20 wedges, a dispatch exception
        reset_shared_device_health()
        defense = kb.DeviceDefense()
        defense.health.cfg.dispatch_timeout_ms = 200
        _, state, I, T = seam_group(tables, 256, rng, dev)
        kb.install_device_chaos(DeviceChaosController(
            DeviceFaultPlan(seed=1, stall_p=1.0, stall_ms=600), "smoke"))
        baseline = threading.active_count()
        walls = []
        for _ in range(20):
            t0 = time.perf_counter()
            out = kb.run_group(dt, config, state, I, T, defense=defense)
            walls.append(time.perf_counter() - t0)
            if out.fail_reason != "device-wedged" or walls[-1] > 1.2:
                raise AssertionError(f"stall: {out.fail_reason} after {walls[-1]:.3f} s")
            if defense.health.state not in (SUSPECT, "QUARANTINED"):
                raise AssertionError(f"ladder at {defense.health.state} after a wedge")
        time.sleep(0.7)  # the last stall ends; its worker re-idles
        threads = threading.active_count()
        if threads > baseline + kb._WatchdogPool.MAX_IDLE:
            raise AssertionError(f"threads {baseline} -> {threads} over 20 wedges")
        kb.install_device_chaos(DeviceChaosController(
            DeviceFaultPlan(seed=1, dispatch_fail_p=1.0), "smoke"))
        out = kb.run_group(dt, config, state, I, T, defense=defense)
        if out.fail_reason != "device-dispatch-error":
            raise AssertionError(f"dispatch exception: {out.fail_reason}")
        kb.install_device_chaos(None)
        if kb.run_group(dt, config, state, I, T, defense=defense).fail_reason is not None:
            raise AssertionError("a clean group after the faults failed")
        log(f"phase9 faults [{card}]: stall 600 ms vs 200 ms deadline -> device-wedged in "
            f"{min(walls) * 1e3:.1f}-{max(walls) * 1e3:.1f} ms over 20 wedges, threads "
            f"{baseline} -> {threads}, ladder {defense.health.state} "
            f"(faults {defense.health.faults}); dispatch exception -> device-dispatch-error; "
            f"the next clean group ran")
        info["wedge_ms"] = (min(walls) * 1e3, max(walls) * 1e3)
        return info
    finally:
        kb.install_device_chaos(None)
        reset_shared_device_health()


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
    res = kernels.fused_resources()
    log(f"phase2 fused chunk: {res}; ptxas: {' | '.join(kernels.ptxas_report('k_chunk'))}")
    if res["max_active_clusters"] < N_SHARDS:
        raise AssertionError(f"{N_SHARDS} shard clusters do not fit on the card at once")

    worst = phase_kernel_vs_plain(rng, dev)
    slice_info = phase_slice(rng, dev, card)
    profiled = phase_profile(slice_info, dev, card)
    ceiling = phase_ceiling(dev, card)
    timing = serving_timings(slice_info)
    sharded = phase_sharded_vs_plain(rng, dev)
    mesh = phase_mesh_slice(rng, dev, card)
    phase_repeat(timing, mesh["geo"], card)
    ab = phase_ab(timing, mesh["geo"], slice_info, rng, dev, card)
    stiming = sharded_timings(sharded)
    timing.update(stiming)
    worst.update(sharded["worst"])
    decision = phase_decision(rng, dev, card)
    seam = phase_fault_seam(rng, dev, card, slice_info["tables"], slice_info["dt"])
    timing["decision"] = {**decision["bench"]}
    worst["decision"] = decision["err"]
    log(f"sharded timings [{card}] at {N_SHARDS} shards of the serving geometry: "
        f"sharded_step {stiming['sharded_step']['ms']:.4f} ms per call (plain "
        f"{stiming['sharded_step']['plain_ms']:.4f}), "
        f"{stiming['sharded_step']['device_ms']:.4f} ms per sharded lock-step back to back, "
        f"sharded_collect chunk {stiming['sharded_collect']['ms']:.4f} ms (plain "
        f"{stiming['sharded_collect']['plain_ms']:.4f}); forced chain: sharded_step "
        f"{stiming['sharded_step']['chain_ms']:.4f} ms per call, "
        f"{stiming['sharded_step']['chain_device_ms']:.4f} ms per lock-step back to back, "
        f"chunk {stiming['sharded_collect']['chain_ms']:.4f} ms; grid launches per call "
        f"sharded_step {stiming['sharded_step']['grid_launches']}, chunk "
        f"{stiming['sharded_collect']['grid_launches']} (chain "
        f"{stiming['sharded_collect']['chain_grid_launches']}); bytes per step "
        f"{stiming['sharded_step']['bytes']}, per chunk {stiming['sharded_collect']['bytes']}; "
        f"launches on the mesh slice: sharded_step {mesh['launches']['sharded_step']} enqueued "
        f"({mesh['steps']} decoded partition steps), sharded_collect "
        f"{mesh['launches']['sharded_collect']}")
    log(f"serving timings [{card}] at {timing['geometry']}: "
        f"step {timing['step']['ms']:.4f} ms per wrapper call "
        f"(plain {timing['step']['plain_ms']:.4f}), "
        f"{timing['step']['device_ms']:.4f} ms per lock-step back to back, "
        f"run_collect chunk {timing['run_collect']['ms']:.4f} ms "
        f"(plain {timing['run_collect']['plain_ms']:.4f}); forced chain: step "
        f"{timing['step']['chain_ms']:.4f} ms per call, "
        f"{timing['step']['chain_device_ms']:.4f} ms per lock-step back to back, chunk "
        f"{timing['run_collect']['chain_ms']:.4f} ms; grid launches per call step "
        f"{timing['step']['grid_launches']}, chunk {timing['run_collect']['grid_launches']} "
        f"(chain {timing['run_collect']['chain_grid_launches']}); bytes per step "
        f"{timing['step_bytes']}, per chunk {timing['chunk_bytes']}; launches per group: "
        f"step {slice_info['launches']['step'] / 8} enqueued "
        f"({slice_info['decoded_steps'] / 8} decoded live steps), "
        f"run_collect {slice_info['launches']['run_collect'] / 8}")
    wide = decision["wide"]
    log(f"decision timings [{card}]: benchmark geometry wrapper call "
        f"{timing['decision']['ms']:.4f} ms, launches back to back "
        f"{timing['decision']['device_ms']:.4f} ms (plain {timing['decision']['plain_ms']:.4f}, "
        f"bound {timing['decision']['bound_ms'] * 1e3:.3f} us by "
        f"{timing['decision']['bound_by']}); wide geometry wrapper call {wide['ms']:.4f} ms, "
        f"back to back {wide['device_ms']:.4f} ms "
        f"(plain {wide['plain_ms']:.4f}, bound {wide['bound_ms'] * 1e3:.3f} us by "
        f"{wide['bound_by']}); batch_evaluate {decision['rows_per_s']:.1f} rows/s; "
        f"launches on its path {decision['launches']['decision']}; fault seam: CPU oracle "
        f"{seam['oracle_ms']:.3f} ms per shadowed I=2048 group, wedge to typed failure "
        f"{seam['wedge_ms'][0]:.1f}-{seam['wedge_ms'][1]:.1f} ms at a 200 ms deadline")
    log(f"phase4 busy share [{card}]: kernels {pct(profiled['fused']['share'])} of the "
        f"device loop on the fused path (torch.profiler, 2 groups), "
        f"{pct(profiled['chain']['share'])} on the forced chain")

    counts = {"step": slice_info["launches"]["step"],
              "run_collect": slice_info["launches"]["run_collect"],
              "run_to_completion": ceiling["launches"]["run_to_completion"],
              "sharded_step": mesh["launches"]["sharded_step"],
              "sharded_collect": mesh["launches"]["sharded_collect"],
              "decision": decision["launches"]["decision"]}
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on its main path")
    kernels_line = []
    for name in KERNELS:
        t = ceiling if name == "run_to_completion" else timing[name]
        kernels_line.append({
            "name": name, "route": "cuda",
            "source": SOURCES.get(name, "zeebe_tpu_torch/csrc/automaton.cu"),
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": ceiling["err"] if name == "run_to_completion" else worst[name],
            "match": True, "tolerance": 0, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t.get("bound_by", "bytes"),
            "library_ms": None, "device_ms": t.get("device_ms"),
            "path": MAIN_PATH[name], "grid_launches": t["grid_launches"],
            "chain_ms": t.get("chain_ms"),
        })
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
