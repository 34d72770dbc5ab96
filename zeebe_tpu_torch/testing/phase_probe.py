"""Per-phase device time of the fused chunk (``k_chunk``) on the card.

    python -m zeebe_tpu_torch.testing.phase_probe [--threads 1024 512]
                                                   [--tokens 8192 16384 32768]

Builds an instrumented copy of ``csrc/automaton.cu`` into
``build/phase_probe/``: block 0, thread 0 of the first cluster reads
``%globaltimer`` before and after every cluster barrier of ``k_chunk`` and
adds the intervals up per barrier. Then runs fused chunks of 8 steps of the
mixed set (I = T / 4) and prints, per chunk, the work before each barrier
(block 0's own phase) and the wait at it (the other blocks' lag plus the
barrier itself). The barriers, in the order of the source: 0 after the
copy-in, 1 after the start-of-run occupancy (scopes/MI), 2 after classify
(joins), 3 after the join ranks and the block scans, 4 after the ranks, 5
after place, 6-7 around the occupancy recount (scopes/MI), 8 after finish
and the active count, 9 at the end. ``--threads`` builds one copy per block
size. Needs one CUDA card and ``nvcc``; the instrumentation costs a few
percent of the step, so compare its numbers only with each other.

    python -m zeebe_tpu_torch.testing.phase_probe --grid [--tokens 65536 1048576]

probes the grid kernel (``k_complete``) the same way: block 0, thread 0 of
the grid, around every ``grid.sync()``, over run_to_completion of one_task
at I = T = each ``--tokens``. Its barriers: 0 after the copy-in, 1 after the
start-of-run occupancy (scopes/MI), 2 after classify (joins), 3 after
classify (or the join ranks) and the block scans, 4 after the ranks, 5
after place, 6 after finish (scopes/MI), 7 at the end of the step (finish,
or the occupancy recount, and the live flag); times are per call.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from zeebe_tpu_torch.models.bpmn import transform
from zeebe_tpu_torch.ops import automaton as A
from zeebe_tpu_torch.ops import kernels
from zeebe_tpu_torch.ops.tables import compile_tables
from zeebe_tpu_torch.testing import workloads as W

OUT = kernels.BUILD_DIR.parent / "phase_probe"
PROBE = '''
__device__ unsigned long long g_probe[32];
__device__ __forceinline__ unsigned long long probe_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PROBE(n) if (blockIdx.x == 0 && threadIdx.x == 0) { \\
  const unsigned long long now_ = probe_now(); atomicAdd(&g_probe[n], now_ - probe_t); \\
  probe_t = now_; }
'''
READ = '''
extern "C" int zt_probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
}
extern "C" int zt_probe_reset() {
  unsigned long long zero[32] = {0};
  return (int)cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
}
'''


def instrumented_source(threads: int) -> tuple[str, int]:
    """The kernel source with a probe around every cluster barrier of
    k_chunk, at ``threads`` per block; returns it and the barrier count."""
    src = (kernels.CSRC / "automaton.cu").read_text()
    src = src.replace("namespace cg = cooperative_groups;",
                      "namespace cg = cooperative_groups;\n" + PROBE, 1)
    src = re.sub(r"constexpr int FUSED_THREADS = \d+;",
                 f"constexpr int FUSED_THREADS = {threads};", src)
    start = src.index("k_chunk(ZtTables tb")
    end = src.index("// The chain: one grid-wide launch")
    body = src[start:end].replace(
        "cg::cluster_group cluster = cg::this_cluster();",
        "cg::cluster_group cluster = cg::this_cluster();\n"
        "  unsigned long long probe_t = probe_now();", 1)
    parts = body.split("cluster.sync();")
    probed = parts[0]
    for k, part in enumerate(parts[1:]):
        probed += f"PROBE({2 * k}); cluster.sync(); PROBE({2 * k + 1});" + part
    return src[:start] + probed + src[end:] + READ, len(parts) - 1


def instrumented_grid_source() -> tuple[str, int]:
    """The kernel source with a probe around every grid barrier of
    k_complete; returns it and the barrier count."""
    src = (kernels.CSRC / "automaton.cu").read_text()
    src = src.replace("namespace cg = cooperative_groups;",
                      "namespace cg = cooperative_groups;\n" + PROBE, 1)
    start = src.index("k_complete(ZtTables tb")
    end = src.index("// The grid kernel's launch size")
    body = src[start:end].replace(
        "cg::grid_group grid = cg::this_grid();",
        "cg::grid_group grid = cg::this_grid();\n"
        "  unsigned long long probe_t = probe_now();", 1)
    parts = body.split("grid.sync();")
    probed = parts[0]
    for k, part in enumerate(parts[1:]):
        probed += f"PROBE({2 * k}); grid.sync(); PROBE({2 * k + 1});" + part
    return src[:start] + probed + src[end:] + READ, len(parts) - 1


def build(threads: int, grid: bool = False) -> tuple[Path, int]:
    OUT.mkdir(parents=True, exist_ok=True)
    src, barriers = instrumented_grid_source() if grid else instrumented_source(threads)
    if grid:
        threads = 0
    cu = OUT / f"automaton_probe_{threads}.cu"
    cu.write_text(src)
    lib = OUT / f"libprobe_{threads}.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(lib), str(cu),
                    str(kernels.CSRC / "decision.cu")], check=True)
    return lib, barriers


def probe_grid(tokens: list[int], reps: int, dev) -> None:
    """Per-barrier time of the grid kernel over run_to_completion of
    one_task at I = T = each of ``tokens``."""
    lib_path, barriers = build(0, grid=True)
    lib = kernels._Lib(lib_path)
    lib.lib.zt_probe_read.argtypes = [ctypes.c_void_p]
    kernels._LOADED = lib
    print(f"grid kernel: {kernels.complete_resources()}")
    tables = compile_tables([transform(W.one_task())])
    dt = A.DeviceTables.from_numpy(tables, dev)
    buf = (ctypes.c_ulonglong * 32)()
    for n in tokens:
        state = A.make_state(tables, n, np.zeros(n, np.int32), token_capacity=n, device=dev)
        _, steps = A.run_to_completion(dt, state, max_steps=64, config=tables.kernel_config)
        torch.cuda.synchronize()
        lib.lib.zt_probe_reset()
        for _ in range(reps):
            A.run_to_completion(dt, state, max_steps=64, config=tables.kernel_config)
        torch.cuda.synchronize()
        lib.lib.zt_probe_read(buf)
        us = [buf[i] / reps / 1e3 for i in range(2 * barriers)]
        marks = ", ".join(f"{k}: {us[2 * k]:.2f}+{us[2 * k + 1]:.2f}"
                          for k in range(barriers) if us[2 * k] or us[2 * k + 1])
        print(f"grid I=T={n}, {int(steps)} steps: us per call at barrier (work+wait) "
              f"{marks}; total {sum(us):.2f}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--threads", type=int, nargs="+", default=[kernels.FUSED_THREADS])
    parser.add_argument("--tokens", type=int, nargs="+", default=None)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--grid", action="store_true", help="probe the grid kernel")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("phase_probe needs a CUDA device")
    dev = torch.device("cuda")
    if args.grid:
        probe_grid(args.tokens or [1 << 16, 1 << 20], args.reps, dev)
        return 0
    args.tokens = args.tokens or [8192, 16384, 32768]
    tables = compile_tables([transform(m) for m in W.mixed_definitions()])
    dt = A.DeviceTables.from_numpy(tables, dev)
    config = tables.kernel_config
    built = {threads: build(threads) for threads in args.threads}
    for threads, (lib_path, barriers) in built.items():
        kernels.FUSED_THREADS = threads
        lib = kernels._Lib(lib_path)
        lib.lib.zt_probe_read.argtypes = [ctypes.c_void_p]
        kernels._LOADED = lib
        print(f"threads {threads}: {kernels.fused_resources()}")
        buf = (ctypes.c_ulonglong * 32)()
        rng = np.random.default_rng(0)
        for T in args.tokens:
            I = T // 4
            def_of = rng.integers(0, tables.num_definitions, I).astype(np.int32)
            slots = rng.integers(-5, 60, (I, tables.num_slots)).astype(np.float64)
            state = A.make_state(tables, I, def_of, initial_slots=slots, token_capacity=T,
                                 device=dev)
            for mode in ("step", "collect"):
                def chunk():
                    kernels.run_steps(dt, state, 8, config, auto_jobs=mode == "step",
                                      emit_events=mode == "collect", mode=mode, path="fused")

                chunk()
                torch.cuda.synchronize()
                lib.lib.zt_probe_reset()
                for _ in range(args.reps):
                    chunk()
                torch.cuda.synchronize()
                lib.lib.zt_probe_read(buf)
                us = [buf[i] / args.reps / 1e3 for i in range(2 * barriers)]
                marks = ", ".join(f"{k}: {us[2 * k]:.2f}+{us[2 * k + 1]:.2f}"
                                  for k in range(barriers) if us[2 * k] or us[2 * k + 1])
                print(f"threads={threads} T={T} I={I} {mode}: us per chunk of 8 at barrier "
                      f"(work+wait) {marks}; total {sum(us):.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
