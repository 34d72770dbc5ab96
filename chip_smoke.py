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
6. prints the kernels line (JSON), then the card line, then the result line.

Imports neither JAX nor the JAX package. Launch counts are zeroed right
before each main path runs (phase 4 for step and run_collect, phase 5 for
run_to_completion) and read right after; comparison launches do not count.
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
from zeebe_tpu_torch.testing import workloads as W

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SOURCE = "zeebe_tpu_torch/csrc/automaton.cu"
REPLACES = {
    "step": "zeebe_tpu/ops/automaton.py:366",
    "run_collect": "zeebe_tpu/ops/automaton.py:704",
    "run_to_completion": "zeebe_tpu/ops/automaton.py:773",
}


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
              "run_to_completion": ceiling["launches"]["run_to_completion"]}
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on its main path")
    kernels_line = []
    for name in ("step", "run_collect", "run_to_completion"):
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
