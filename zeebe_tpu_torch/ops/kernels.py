"""Build and bind the port's CUDA kernels (``csrc/automaton.cu``, the
automaton, and ``csrc/decision.cu``, DMN decision-table matching).

The sources are compiled at first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a``, one ``nvcc`` per source started together,
and linked into one shared library with a plain C interface, loaded with
``ctypes``. The library lands in ``build/zeebe_tpu_torch/`` at the root of
the checkout, named by a digest of every source and the flags, so a change
to any source rebuilds. Nothing is built or imported from CUDA when this
module is imported.

Launch protocol: the wrapper allocates the working state (``torch.empty``)
and one int32 scratch buffer and enqueues the steps on PyTorch's current
stream by one of three paths, chosen before any launch:

- ``"fused"`` (``step`` and ``run_collect`` on shards of at most
  ``FUSED_MAX_TOKENS`` slots, the serving geometry among them, by
  ``choose_path``): ``zt_collect_fused``, ONE launch per chunk that copies
  the state in and loops over the steps, in one of two shapes chosen by
  ``fused_shape`` from the shard's slots: a thread-block cluster per shard,
  or for small shards (up to ``FUSED_BLOCK_MAX_TOKENS`` slots) one plain
  block per shard;
- ``"chain"`` (``step`` and ``run_collect`` on larger shards):
  ``zt_prepare`` copies the state in and initializes the scratch, and
  ``zt_steps`` enqueues ~10 grid-wide launches per lock-step;
- ``"grid"`` (``run_to_completion``): ``zt_complete``, ONE cooperative
  launch per call that spans the card and runs the whole loop on the device.

``run_steps``, ``run_sharded_step`` and ``run_until_quiet`` take ``path=`` to
force another path (``run_until_quiet``: ``"grid"`` or ``"chain"``; the
others: ``"fused"`` or ``"chain"``), and ``run_steps``, ``run_sharded_step``
and ``launch_fused`` take ``shape=`` to force the fused chunk's shape
(``"block"`` or ``"cluster"``), so the card's tests and ``chip_smoke.py``
hold each against the plain version; the public functions of
``ops/automaton.py`` take neither. Nothing falls back from one path to
another: each C entry returns ``cudaGetLastError()`` (or the launch's own
error), and a non-zero code raises ``KernelLaunchError``.

The decision kernel has two layouts (``run_decision``): ``"lanes"``, a
context's 32-rule words spread over the lanes of a warp, and ``"serial"``,
one thread walking a context's words in series; the library fixes the
lanes layout's shape from the table before each launch
(``decision_lanes_plan`` reports it).

Shards: a state may hold ``num_shards`` shard blocks back to back (the
reference's mesh layout, ``make_state(num_shards=n)``: token ``inst`` values
local to their block). Every phase of a step is one launch over all shards.
The counters are one per shard (``[NS]``) or one for all (a 0-d tensor,
replicated, as ``make_sharded_step`` takes them).

Counts: ``LAUNCHES``, ``GRID_LAUNCHES`` and ``FUSED_SHAPES`` always;
``GEOMETRY``, each wrapper call's geometry, only while the tracer is on
(one ``enabled`` read per call when it is off).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from zeebe_tpu_torch.observability.tracer import get_tracer

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (CSRC / "automaton.cu", CSRC / "decision.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "zeebe_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# KernelConfig bits and run modes (csrc/automaton.cu)
CFG_JOINS, CFG_CONDITIONS, CFG_SCOPES, CFG_MI = 1, 2, 4, 8
MODE_AUTO_JOBS, MODE_EMIT, MODE_COLLECT, MODE_COMPLETION = 1, 2, 4, 8
CTL_GO, CTL_STEPS, CTL_N = 0, 3, 8
SCAN_TILE = 4096
# the fused chunk takes shards of at most this many token slots (T =
# pow2(width x I): the serving geometry, I = 2048 and T = 8192, and every
# group of a set whose live-token width is at most 8); larger shards take
# the chain, which is faster there (csrc/automaton.cu, PERF.md)
FUSED_MAX_TOKENS = 1 << 14
FUSED_THREADS = 1024  # threads per block of the fused chunk
CLUSTER_BLOCKS = 8  # blocks per shard cluster
# the fused chunk's block shape: one plain block of pow2(max(T, I, 32))
# threads per shard, at most this many
FUSED_BLOCK_THREADS = 1024
# shards of at most this many token slots (and instances) take the block
# shape, larger ones the cluster: the block shape won at every T measured,
# 64 to 1024 (chip_smoke.py's shapes phase on an H100 80GB HBM3 at 700 W,
# one launch by the profiler, mean over the six serving sets, block |
# cluster: 23.3 | 64.8 us at T = 64, 24.4 | 64.3 at 256, 39.7 | 66.9 at
# 1024; one_task at T = 64: 11.5 | 35.1), and one block holds 1024 threads
FUSED_BLOCK_MAX_TOKENS = 1024
FUSED_SHAPE_NAMES = ("block", "cluster")
GRID_THREADS = 512  # threads per block of the grid kernel
GRID_MAX_BLOCKS = 1024  # the most blocks it launches
PATHS = ("fused", "chain", "grid")
STEP_PATHS = ("fused", "chain")  # run_steps, run_sharded_step
COMPLETION_PATHS = ("grid", "chain")  # run_until_quiet
# the forced chain's run_to_completion enqueues this many steps between
# reads of the loop flag
COMPLETION_BLOCK_STEPS = 8
MAX_FANOUT = 32  # take and condition masks ride 32-bit words
# the serial decision kernel stages 32 rules x K atoms of 24 bytes in shared
# memory; both layouts take at most this many atoms per cell
DECISION_MAX_ATOMS = 64
# "serial" (k_decision) lost to "lanes" at every measured geometry and stays
# only for the A/B in chip_smoke.py and the card's tests (ROADMAP B5)
DECISION_KERNELS = ("lanes", "serial")

# Kernel launches, counted where they are enqueued: "step" counts every
# lock-step of an unsharded run that the host enqueues (those inside
# run_collect, and inside run_to_completion on the forced chain; the grid
# kernel decides its steps on the device and counts under
# "run_to_completion" alone); "run_collect" and "run_to_completion" count
# one per call. "sharded_step" counts every lock-step of a sharded run (one
# launch per phase over all shards; those inside sharded_collect too) and
# "sharded_collect" one per call.
# "decision" counts one per decision-table batch (either layout).
LAUNCHES = {"step": 0, "run_collect": 0, "run_to_completion": 0,
            "sharded_step": 0, "sharded_collect": 0, "decision": 0}

# CUDA grid launches enqueued by the automaton wrappers, by path: "fused"
# one per fused chunk, "chain" every launch of zt_prepare and zt_steps (as
# the library reports them), "combine" the sharded step's counter combine,
# "grid" one per run_to_completion on the grid kernel.
GRID_LAUNCHES = {"fused": 0, "chain": 0, "combine": 0, "grid": 0}

# The fused chunk's launches by shape (``fused_shape``): each one counted
# under "fused" in GRID_LAUNCHES too.
FUSED_SHAPES = {"block": 0, "cluster": 0}

# The automaton wrappers' calls by geometry, counted only while tracing is
# on: (path, the KernelConfig flags of GEOMETRY_FLAGS, the bytes of each
# table of _TABLE_SPEC, of each state array of _STATE_PTRS, the packed-row
# bytes the call writes) -> calls. "fused" and "chain" count each call of
# run_steps (a chunk, a step, a sharded step), "grid" and "chain" each
# run_until_quiet; ``automaton.geometry_counts`` reads it.
GEOMETRY: dict[tuple, int] = {}
GEOMETRY_FLAGS = ("has_joins", "has_conditions", "has_scopes", "has_mi")

# Launches of a grouped mesh's cross-group counter sum (``combine_groups``,
# ``k_combine_groups``): one per sharded step of a mesh of several launch
# groups (``parallel/mesh.py``).
GROUP_LAUNCHES = {"combine_groups": 0}


_TRACER = get_tracer()


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


_P = ctypes.c_void_p
_I = ctypes.c_int32


class _Tables(ctypes.Structure):
    _fields_ = [(n, _P) for n in (
        "kernel_op", "in_count", "out_count", "out_target", "out_cond",
        "default_slot", "scope_start", "in_scope", "mi_sequential",
        "cond_ops", "cond_args")] + [(n, _I) for n in ("D", "E", "FO", "C")]


_STATE_PTRS = ("elem", "phase", "inst", "def_of", "var_slots", "join_counts",
               "mi_left", "done", "incident", "transitions", "jobs_created",
               "completed", "overflow")


_COUNTERS = ("transitions", "jobs_created", "completed", "overflow")


class _State(ctypes.Structure):
    _fields_ = ([(n, _P) for n in _STATE_PTRS]
                + [(n, _I) for n in ("T", "I", "S", "NS", "ctr_stride")])


_SCRATCH = ("ctl", "occ", "pend", "arrivals", "consumed", "head", "tpi", "pending",
            "req_target", "req_flags", "next", "proceeds", "place_rank",
            "free_flag", "tok_flags", "tok_inst", "tok_elem", "slot_of_rank",
            "block_sums")


class _Scratch(ctypes.Structure):
    _fields_ = [(n, _P) for n in _SCRATCH]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME)")
    return found


def library_path() -> Path:
    digest = hashlib.sha256()
    for source in SOURCES:
        digest.update(source.name.encode() + b"\0" + source.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libzt_kernels_{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels if these sources have no library yet; returns its
    path. Each source compiles to an object in its own ``nvcc``, all started
    together, then one ``nvcc -shared`` links them. Safe against concurrent
    builders: each builds in a private directory and renames the library
    into place."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [str(Path(tmp) / f"{source.stem}.o") for source in SOURCES]
        try:
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj,
                                       str(source)], stderr=subprocess.PIPE, text=True)
                     for source, obj in zip(SOURCES, objects)]
        except OSError as exc:  # every source uses the same nvcc: none started
            raise KernelBuildError(f"cannot run nvcc: {exc}") from exc
        errs = [proc.communicate()[1] for proc in procs]
        for source, proc, err in zip(SOURCES, procs, errs):
            if proc.returncode != 0:
                raise KernelBuildError(f"nvcc {source.name} failed ({proc.returncode}):\n"
                                       f"{err[-4000:]}")
        out = str(Path(tmp) / lib.name)
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", out, *objects],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc link failed ({proc.returncode}):\n"
                                   f"{proc.stderr[-4000:]}")
        log = "".join(errs) + proc.stderr
        if verbose:
            print(log, end="")
        ptxas_log_path(lib).write_text(log)
        os.replace(out, lib)
    return lib


def ptxas_log_path(lib: Path) -> Path:
    """Where ``build`` keeps the compiler's ``-Xptxas -v`` report."""
    return lib.with_suffix(".ptxas.txt")


def ptxas_report(kernel: str) -> list[str]:
    """The ``-Xptxas -v`` lines of every compiled kernel whose (mangled)
    name contains ``kernel``: its stack frame, spills and registers."""
    lines = ptxas_log_path(library_path()).read_text().splitlines()
    out, keep = [], False
    for line in lines:
        if "Compiling entry function" in line or "Function properties for" in line:
            keep = kernel in line
        if keep:
            out.append(line.strip())
    return out


class _Lib:
    """The loaded library with its argument types declared."""

    def __init__(self, path: Path) -> None:
        lib = ctypes.CDLL(str(path))
        ptr = ctypes.POINTER
        count = ptr(_I)
        lib.zt_prepare.argtypes = [ptr(_Tables), ptr(_State), ptr(_State), ptr(_Scratch),
                                   _I, _I, _P, ctypes.c_int64, _P, count]
        lib.zt_prepare.restype = ctypes.c_int
        lib.zt_steps.argtypes = [ptr(_Tables), ptr(_State), ptr(_Scratch), _I, _I, _I,
                                 _P, ctypes.c_int64, ctypes.c_int64, _I, _I, _P, count]
        lib.zt_steps.restype = ctypes.c_int
        lib.zt_collect_fused.argtypes = [ptr(_Tables), ptr(_State), ptr(_State),
                                         ptr(_Scratch), _I, _I, _I, _P, ctypes.c_int64, _I,
                                         _P]
        lib.zt_collect_fused.restype = ctypes.c_int
        lib.zt_fused_resources.argtypes = [count, count, count]
        lib.zt_fused_resources.restype = ctypes.c_int
        lib.zt_complete.argtypes = [ptr(_Tables), ptr(_State), ptr(_State), ptr(_Scratch),
                                    _I, _I, _I, _P]
        lib.zt_complete.restype = ctypes.c_int
        lib.zt_complete_resources.argtypes = [count, count, count, count]
        lib.zt_complete_resources.restype = ctypes.c_int
        lib.zt_combine.argtypes = [ptr(_State), ptr(_State), _P, _P, _P, _P, _P]
        lib.zt_combine.restype = ctypes.c_int
        lib.zt_combine_groups.argtypes = [_P, _I] + [_P] * 8
        lib.zt_combine_groups.restype = ctypes.c_int
        lib.zt_decision.argtypes = [_P] * 6 + [_I] * 4 + [_P] * 4
        lib.zt_decision.restype = ctypes.c_int
        lib.zt_decision_lanes.argtypes = [_P] * 6 + [_I] * 4 + [_P] * 4
        lib.zt_decision_lanes.restype = ctypes.c_int
        lib.zt_decision_lanes_plan.argtypes = [_I] * 3 + [count] * 6
        lib.zt_decision_lanes_plan.restype = ctypes.c_int
        for name in ("zt_scan_tile", "zt_ctl_stride", "zt_fused_max_tokens",
                     "zt_fused_threads", "zt_cluster_blocks", "zt_fused_block_threads",
                     "zt_grid_threads", "zt_grid_max_blocks", "zt_decision_max_atoms"):
            getattr(lib, name).restype = ctypes.c_int
        if (lib.zt_scan_tile(), lib.zt_ctl_stride(), lib.zt_fused_max_tokens(),
                lib.zt_fused_threads(), lib.zt_cluster_blocks(), lib.zt_fused_block_threads(),
                lib.zt_grid_threads(), lib.zt_grid_max_blocks()) != (
                SCAN_TILE, CTL_N, FUSED_MAX_TOKENS, FUSED_THREADS, CLUSTER_BLOCKS,
                FUSED_BLOCK_THREADS, GRID_THREADS, GRID_MAX_BLOCKS):
            raise KernelBuildError("a constant of the library (scan tile, control "
                                   "stride, fused chunk or grid kernel shape) differs "
                                   "from the binding")
        if lib.zt_decision_max_atoms() != DECISION_MAX_ATOMS:
            raise KernelBuildError("the decision kernels' atom limit differs from the "
                                   "binding")
        self.lib = lib


_LOADED: _Lib | None = None
_LOAD_LOCK = threading.Lock()


def load() -> _Lib:
    """Build (if needed) and load the library, once per process: the
    sources are read and hashed at the first call only, not per launch.
    The partitions' pump threads may ask at once; one builds, the others
    wait for it."""
    global _LOADED
    if _LOADED is None:
        with _LOAD_LOCK:
            if _LOADED is None:
                _LOADED = _Lib(build())
    return _LOADED


def _check(code: int, what: str) -> None:
    if code != 0:
        raise KernelLaunchError(f"{what}: CUDA error {code}")


def _config_bits(config) -> int:
    return ((CFG_JOINS if config.has_joins else 0)
            | (CFG_CONDITIONS if config.has_conditions else 0)
            | (CFG_SCOPES if config.has_scopes else 0)
            | (CFG_MI if config.has_mi else 0))


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype == dtype and t.shape == shape and t.device == device and t.is_contiguous():
        return  # one test per call on the wrapper's hot path; messages below
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_TABLE_SPEC = ("kernel_op", "in_count", "out_count", "out_target", "out_cond",
               "default_slot", "scope_start", "in_scope", "mi_sequential", "cond_ops",
               "cond_args")


def _tables_struct(tables, device) -> _Tables:
    """The tables' struct, validated and built once per table set: it is
    kept on the ``DeviceTables`` object beside the tensors it points into
    (which it keeps alive) and rebuilt only when one of them was replaced."""
    tensors = tuple(getattr(tables, name) for name in _TABLE_SPEC)
    cached = getattr(tables, "_kernel_struct", None)
    if cached is not None and all(a is b for a, b in zip(cached[0], tensors)):
        if cached[1] != device:
            raise ValueError(f"tables are on {cached[1]}, expected {device}")
        return cached[2]
    D, E = tables.kernel_op.shape
    FO = tables.out_target.shape[2]
    C = tables.cond_ops.shape[0]
    if FO > MAX_FANOUT:
        raise ValueError(f"fan-out {FO} exceeds the kernel's {MAX_FANOUT}")
    i32, i8 = torch.int32, torch.int8
    spec = {
        "kernel_op": (i32, (D, E)), "in_count": (i32, (D, E)),
        "out_count": (i32, (D, E)), "out_target": (i32, (D, E, FO)),
        "out_cond": (i32, (D, E, FO)), "default_slot": (i32, (D, E)),
        "scope_start": (i32, (D, E)), "in_scope": (i8, (D, E, E)),
        "mi_sequential": (i8, (D, E)), "cond_ops": (i32, (C, 24)),
        "cond_args": (i32, (C, 24, 2)),
    }
    for name, t in zip(_TABLE_SPEC, tensors):
        dtype, shape = spec[name]
        _require(t, f"tables.{name}", dtype, shape, device)
    struct = _Tables(**{n: t.data_ptr() for n, t in zip(_TABLE_SPEC, tensors)},
                     D=D, E=E, FO=FO, C=C)
    tables._kernel_struct = (tensors, device, struct)
    return struct


def _state_struct(state: dict, E: int, device, num_shards: int = 1) -> _State:
    """Validate a state of ``num_shards`` shard blocks; T and I in the
    struct are per shard. Counters are 0-d (one for all shards) or [NS]."""
    NS = num_shards
    if NS < 1:
        raise ValueError(f"num_shards must be >= 1, got {NS}")
    T_all = state["elem"].shape[0]
    I_all = state["def_of"].shape[0]
    if T_all % NS or I_all % NS:
        raise ValueError(f"token slots ({T_all}) and instances ({I_all}) must "
                         f"divide into {NS} shards")
    T, I = T_all // NS, I_all // NS
    S = state["var_slots"].shape[1]
    counter_shape = tuple(state["transitions"].shape)
    if counter_shape not in ((), (NS,)):
        raise ValueError(f"counters must be 0-d or [{NS}], got {counter_shape}")
    i32, b = torch.int32, torch.bool
    spec = {
        "elem": (i32, (T_all,)), "phase": (i32, (T_all,)), "inst": (i32, (T_all,)),
        "def_of": (i32, (I_all,)), "var_slots": (i32, (I_all, S, 2)),
        "join_counts": (i32, (I_all, E)), "mi_left": (i32, (I_all, E)),
        "done": (b, (I_all,)), "incident": (b, (I_all,)),
        "transitions": (i32, counter_shape), "jobs_created": (i32, counter_shape),
        "completed": (i32, counter_shape), "overflow": (b, counter_shape),
    }
    for name, (dtype, shape) in spec.items():
        _require(state[name], f"state[{name!r}]", dtype, shape, device)
    if I > T:
        raise ValueError(f"instances ({I}) exceed token slots ({T}) per shard")
    return _State(**{n: state[n].data_ptr() for n in _STATE_PTRS}, T=T, I=I, S=S, NS=NS,
                  ctr_stride=1 if counter_shape else 0)


def choose_path(tokens_per_shard: int) -> str:
    """The shape rule, decided before any launch: ``"fused"`` for shards of
    at most ``FUSED_MAX_TOKENS`` token slots, else ``"chain"``."""
    return "fused" if tokens_per_shard <= FUSED_MAX_TOKENS else "chain"


def fused_shape(tokens_per_shard: int, instances_per_shard: int) -> str:
    """The fused chunk's launch shape, decided before any launch from the
    shard's size alone: ``"block"`` (one block per shard) for shards of at
    most ``FUSED_BLOCK_MAX_TOKENS`` token slots and instances, else
    ``"cluster"``."""
    small = max(tokens_per_shard, instances_per_shard) <= FUSED_BLOCK_MAX_TOKENS
    return "block" if small else "cluster"


@dataclasses.dataclass
class _Run:
    """One working state plus scratch on the device."""

    lib: _Lib
    tables: _Tables
    st: _State
    sc: _Scratch
    state: dict
    scratch: torch.Tensor
    ctl: torch.Tensor
    nb_free: int
    nb_req: int
    cfg: int
    sharded: bool  # counted as a sharded run
    st_in: _State  # the caller's state (copied in; make_sharded_step combines against it)
    keep: tuple  # tensors the structs point into


@functools.lru_cache(maxsize=64)
def _scratch_layout(NS: int, T: int, I: int, E: int, FO: int):
    """The scratch buffer of a geometry: each ``_SCRATCH`` array's offset
    (int32 elements, 256-byte aligned), the total, and the chain's scan tile
    counts (free slots, requests). ``block_sums`` holds the chain's tile sums
    or the grid kernel's three totals per block, whichever is larger."""
    nb_free = -(-T // SCAN_TILE)
    nb_req = -(-(T * FO) // SCAN_TILE)
    sizes = {"ctl": CTL_N, "occ": I * E, "pend": I * E, "arrivals": I * E,
             "consumed": I * E, "head": I * E, "tpi": I, "pending": I,
             "req_target": T * FO, "req_flags": T * FO, "next": T * FO,
             "proceeds": T * FO, "place_rank": T * FO, "free_flag": T, "tok_flags": T,
             "tok_inst": T, "tok_elem": T, "slot_of_rank": T,
             "block_sums": max(nb_free + nb_req, 3 * GRID_MAX_BLOCKS)}
    align = 64
    offsets, total = [], 0
    for name in _SCRATCH:
        offsets.append(total)
        total += -(-(NS * sizes[name]) // align) * align
    return tuple(offsets), total, nb_free, nb_req


def allocate(tables, state: dict, config, num_shards: int = 1,
             sharded: bool = False) -> _Run:
    """Validate the inputs and allocate the working state and scratch; no
    launch. ``sharded`` marks a mesh run (its lock-steps count as sharded
    ones)."""
    device = state["elem"].device
    lib = load()
    tb = _tables_struct(tables, device)
    E, FO = tb.E, tb.FO
    NS = num_shards
    st_in = _state_struct(state, E, device, NS)
    T, I = st_in.T, st_in.I
    # arrays the kernels never write under this config are shared with the
    # caller's state (JAX returns the same arrays); the copy-in skips them
    cfg = _config_bits(config)
    shared = {"def_of", "var_slots"}
    if not cfg & CFG_JOINS:
        shared.add("join_counts")
    if not cfg & CFG_MI:
        shared.add("mi_left")
    work = {k: (v if k in shared else torch.empty_like(v)) for k, v in state.items()}
    if st_in.ctr_stride == 0 and NS > 1:
        # one counter for all shards in, one per shard while the steps run
        for name in _COUNTERS:
            work[name] = torch.empty(NS, dtype=state[name].dtype, device=device)
    st = _State(**{n: work[n].data_ptr() for n in _STATE_PTRS}, T=T, I=I, S=st_in.S,
                NS=NS, ctr_stride=1)
    offsets, total, nb_free, nb_req = _scratch_layout(NS, T, I, E, FO)
    scratch = torch.empty(total, dtype=torch.int32, device=device)
    base = scratch.data_ptr()
    sc = _Scratch(*(base + 4 * offset for offset in offsets))
    ctl = scratch[offsets[0]:offsets[0] + NS * CTL_N].view(NS, CTL_N)
    return _Run(lib, tb, st, sc, work, scratch, ctl, nb_free, nb_req, cfg, sharded,
                st_in, keep=(tables, state))


def _stream(run: _Run) -> int:
    return torch.cuda.current_stream(run.scratch.device).cuda_stream


def _on_card(run: _Run):
    """The run's card as the current device: a C entry launches on the
    current device, and sizes its grid from it, so every entry runs inside
    this context, whichever card is current outside it."""
    return torch.cuda.device(run.scratch.device)


def _chain_call(run: _Run, fn, *args) -> None:
    """One chain entry on the run's card; counts the grid launches it
    enqueued."""
    launched = _I(0)
    with _on_card(run):
        code = fn(*args, _stream(run), ctypes.byref(launched))
    GRID_LAUNCHES["chain"] += launched.value
    _check(code, fn.__name__)


def launch_prepare(run: _Run, mode: int, out: torch.Tensor | None) -> None:
    """Enqueue the chain's ``zt_prepare`` on a run: copy the caller's state
    in, initialize the scratch, zero ``out``, count the start-of-run
    occupancy."""
    out_ptr = out.data_ptr() if out is not None else None
    out_len = out.numel() if out is not None else 0
    _chain_call(run, run.lib.lib.zt_prepare, ctypes.byref(run.tables),
                ctypes.byref(run.st_in), ctypes.byref(run.st), ctypes.byref(run.sc), mode,
                run.cfg, out_ptr, out_len)


def prepare(tables, state: dict, config, mode: int, out: torch.Tensor | None,
            num_shards: int = 1, sharded: bool = False) -> _Run:
    """The chain's start: allocate, then ``launch_prepare``."""
    run = allocate(tables, state, config, num_shards, sharded)
    launch_prepare(run, mode, out)
    return run


def launch_steps(run: _Run, n_steps: int, mode: int, out: torch.Tensor | None,
                 row_len: int) -> None:
    """Enqueue ``n_steps`` lock-steps of the chain on a prepared run (no
    synchronization)."""
    out_ptr = out.data_ptr() if out is not None else None
    _chain_call(run, run.lib.lib.zt_steps, ctypes.byref(run.tables), ctypes.byref(run.st),
                ctypes.byref(run.sc), n_steps, mode, run.cfg, out_ptr, 0, row_len,
                run.nb_free, run.nb_req)
    LAUNCHES["sharded_step" if run.sharded else "step"] += n_steps


def launch_fused(run: _Run, n_steps: int, mode: int, out: torch.Tensor | None,
                 row_len: int, shape: str | None = None) -> None:
    """Enqueue the fused chunk on a run: copy-in and ``n_steps`` lock-steps
    of every shard in one launch of ``fused_shape``'s shape, or of the
    forced ``shape`` (no synchronization). The copy-in makes a run
    reusable: each launch starts from the caller's state."""
    shape = _pick_shape(shape, run.st.T, run.st.I)
    out_ptr = out.data_ptr() if out is not None else None
    with _on_card(run):
        code = run.lib.lib.zt_collect_fused(
            ctypes.byref(run.tables), ctypes.byref(run.st_in), ctypes.byref(run.st),
            ctypes.byref(run.sc), n_steps, mode, run.cfg, out_ptr, row_len,
            int(shape == "block"), _stream(run))
    _check(code, "zt_collect_fused")
    GRID_LAUNCHES["fused"] += 1
    FUSED_SHAPES[shape] += 1
    LAUNCHES["sharded_step" if run.sharded else "step"] += n_steps


def launch_complete(run: _Run, max_steps: int, mode: int) -> None:
    """Enqueue the grid kernel on a run: copy-in and up to ``max_steps``
    lock-steps in one cooperative launch, the loop's exit on the device (no
    synchronization); ``run.ctl[0, CTL_STEPS]`` then holds the steps run."""
    with _on_card(run):
        code = run.lib.lib.zt_complete(
            ctypes.byref(run.tables), ctypes.byref(run.st_in), ctypes.byref(run.st),
            ctypes.byref(run.sc), max(min(max_steps, 2**31 - 1), 0), mode, run.cfg,
            _stream(run))
    _check(code, "zt_complete")
    GRID_LAUNCHES["grid"] += 1


def _pick(path: str | None, tokens_per_shard: int) -> str:
    if path is None:
        return choose_path(tokens_per_shard)
    if path not in STEP_PATHS:
        raise ValueError(f"path must be one of {STEP_PATHS}, got {path!r}")
    return path


def _pick_shape(shape: str | None, tokens_per_shard: int, instances_per_shard: int) -> str:
    if shape is None:
        return fused_shape(tokens_per_shard, instances_per_shard)
    if shape not in FUSED_SHAPE_NAMES:
        raise ValueError(f"shape must be one of {FUSED_SHAPE_NAMES}, got {shape!r}")
    if shape == "block" and max(tokens_per_shard, instances_per_shard) > FUSED_BLOCK_THREADS:
        raise ValueError(f"the block shape takes shards of at most {FUSED_BLOCK_THREADS} "
                         f"token slots, got {tokens_per_shard}")
    return shape


def _pick_completion(path: str | None) -> str:
    """run_until_quiet's path: the grid kernel unless forced onto the chain."""
    if path is None:
        return "grid"
    if path not in COMPLETION_PATHS:
        raise ValueError(f"path must be one of {COMPLETION_PATHS}, got {path!r}")
    return path


def _count_geometry(path: str, tables, state: dict, config,
                    out: torch.Tensor | None) -> None:
    """One wrapper call in ``GEOMETRY`` (the caller checks the tracer)."""
    key = (path, tuple(bool(getattr(config, f)) for f in GEOMETRY_FLAGS),
           tuple(getattr(tables, n).numel() * getattr(tables, n).element_size()
                 for n in _TABLE_SPEC),
           tuple(state[n].numel() * state[n].element_size() for n in _STATE_PTRS),
           out.numel() * out.element_size() if out is not None else 0)
    GEOMETRY[key] = GEOMETRY.get(key, 0) + 1


def _enqueue(tables, state: dict, n_steps: int, config, mode: int,
             out: torch.Tensor | None, row_len: int, num_shards: int, sharded: bool,
             path: str | None, shape: str | None = None) -> _Run:
    """Allocate and enqueue ``n_steps`` lock-steps by the chosen path (and
    the fused chunk's shape)."""
    T = state["elem"].shape[0] // num_shards
    path = _pick(path, T)
    shape = _pick_shape(shape, T, state["def_of"].shape[0] // num_shards)
    if _TRACER.enabled:
        _count_geometry(path, tables, state, config, out)
    if path == "fused":
        run = allocate(tables, state, config, num_shards, sharded)
        launch_fused(run, n_steps, mode, out, row_len, shape)
    else:
        run = prepare(tables, state, config, mode, out, num_shards, sharded)
        launch_steps(run, n_steps, mode, out, row_len)
    return run


def run_steps(tables, state: dict, n_steps: int, config, auto_jobs: bool,
              emit_events: bool, mode: str, num_shards: int = 1, sharded: bool = False,
              path: str | None = None, shape: str | None = None):
    """``mode="collect"``: run_collect (events on, early exit on the device,
    per shard); ``mode="step"``: one step. Returns (state', packed rows |
    None); the rows are [n_steps, num_shards * row_len], shard s at columns
    [s * row_len, (s + 1) * row_len). ``path`` forces ``"fused"`` or
    ``"chain"``; None takes ``choose_path``'s. ``shape`` forces the fused
    chunk's ``"block"`` or ``"cluster"``; None takes ``fused_shape``'s."""
    T = state["elem"].shape[0] // num_shards
    FO = tables.out_target.shape[2]
    row_len = T * (2 + FO) + 2
    bits = (MODE_AUTO_JOBS if auto_jobs else 0) | (MODE_EMIT if emit_events else 0)
    if mode == "collect":
        bits |= MODE_COLLECT
    out = (torch.empty((n_steps, num_shards * row_len), dtype=torch.int32,
                       device=state["elem"].device)
           if emit_events else None)
    run = _enqueue(tables, state, n_steps, config, bits, out, row_len, num_shards, sharded,
                   path, shape)
    if mode == "collect":
        LAUNCHES["sharded_collect" if sharded else "run_collect"] += 1
    return run.state, out


def run_sharded_step(tables, state: dict, num_shards: int, config,
                     auto_jobs: bool, path: str | None = None,
                     shape: str | None = None) -> dict:
    """make_sharded_step's program: one lock-step of every shard (no events),
    then ``zt_combine`` writes the counters: the input's plus the sum of the
    shards' deltas, and the OR of the shards' overflow flags. The state's
    counters are 0-d (replicated) on input and on output. ``path`` and
    ``shape`` as in ``run_steps``."""
    if tuple(state["transitions"].shape) != ():
        raise ValueError("make_sharded_step takes replicated (0-d) counters")
    bits = MODE_AUTO_JOBS if auto_jobs else 0
    run = _enqueue(tables, state, 1, config, bits, None, 0, num_shards, True, path, shape)
    new_state = dict(run.state)
    if num_shards > 1:
        for name in _COUNTERS:
            new_state[name] = torch.empty((), dtype=state[name].dtype,
                                          device=state[name].device)
        with _on_card(run):
            code = run.lib.lib.zt_combine(
                ctypes.byref(run.st_in), ctypes.byref(run.st),
                *(new_state[name].data_ptr() for name in _COUNTERS), _stream(run))
        _check(code, "zt_combine")
        GRID_LAUNCHES["combine"] += 1
    return new_state


def combine_groups(rows: torch.Tensor, base: dict) -> dict:
    """A grouped mesh's cross-group counter sum on the rows' card, the
    reference's psum over devices: ``rows`` [G, 4] int32 holds each group's
    counters after its step (transitions, jobs_created, completed, overflow
    as 0 or 1), ``base`` the step's input counters (0-d, replicated, on the
    same card). Returns the four 0-d counters: the input plus the sum of the
    groups' deltas (wrapping int32) and the OR of the flags."""
    device = rows.device
    G = rows.shape[0] if rows.dim() == 2 else -1
    _require(rows, "rows", torch.int32, (G, 4), device)
    if G < 1:
        raise ValueError("the counter sum needs at least one group")
    for name in _COUNTERS[:3]:
        _require(base[name], f"base[{name!r}]", torch.int32, (), device)
    out = {name: torch.empty((), dtype=torch.int32, device=device) for name in _COUNTERS[:3]}
    out["overflow"] = torch.empty((), dtype=torch.bool, device=device)
    lib = load().lib
    with torch.cuda.device(device):
        code = lib.zt_combine_groups(
            rows.data_ptr(), G, *(base[name].data_ptr() for name in _COUNTERS[:3]),
            *(out[name].data_ptr() for name in _COUNTERS),
            torch.cuda.current_stream(device).cuda_stream)
    _check(code, "zt_combine_groups")
    GROUP_LAUNCHES["combine_groups"] += 1
    return out


def run_until_quiet(tables, state: dict, max_steps: int, config, auto_jobs: bool,
                    path: str | None = None):
    """run_to_completion: steps with no events until no token is live, or
    ``max_steps``. Returns (state', steps as a 0-d int32 tensor on the
    card). By default (``path=None`` or ``"grid"``) ONE launch of the grid
    kernel runs the whole loop and the host reads nothing until it returns;
    ``path="chain"`` forces the chain, where the host reads the device loop
    flag once per ``COMPLETION_BLOCK_STEPS`` steps (the steps in between are
    no-ops once it drops)."""
    path = _pick_completion(path)
    bits = MODE_COMPLETION | (MODE_AUTO_JOBS if auto_jobs else 0)
    if _TRACER.enabled:
        _count_geometry(path, tables, state, config, None)
    if path == "grid":
        run = allocate(tables, state, config)
        launch_complete(run, max_steps, bits)
    else:
        run = prepare(tables, state, config, bits, None)
        done = 0
        while done < max_steps:
            n = min(COMPLETION_BLOCK_STEPS, max_steps - done)
            launch_steps(run, n, bits, None, 0)
            done += n
            if int(run.ctl[0, CTL_GO]) == 0:
                break
    LAUNCHES["run_to_completion"] += 1
    steps = run.ctl[0, CTL_STEPS].clone()
    return run.state, steps


def fused_resources() -> dict:
    """The fused chunk kernel's registers per thread, local memory per
    thread (stack and spills) and the clusters of it the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    regs, local, clusters = _I(0), _I(0), _I(0)
    _check(load().lib.zt_fused_resources(ctypes.byref(regs), ctypes.byref(local),
                                         ctypes.byref(clusters)), "zt_fused_resources")
    return {"registers": regs.value, "local_bytes": local.value,
            "max_active_clusters": clusters.value, "threads": FUSED_THREADS,
            "cluster_blocks": CLUSTER_BLOCKS}


def complete_resources() -> dict:
    """The grid kernel's registers per thread, local memory per thread
    (stack and spills), its blocks per SM and the co-resident grid it
    launches (blocks per SM x SMs, at most ``GRID_MAX_BLOCKS``)."""
    regs, local, per_sm, blocks = _I(0), _I(0), _I(0), _I(0)
    _check(load().lib.zt_complete_resources(ctypes.byref(regs), ctypes.byref(local),
                                            ctypes.byref(per_sm), ctypes.byref(blocks)),
           "zt_complete_resources")
    return {"registers": regs.value, "local_bytes": local.value,
            "blocks_per_sm": per_sm.value, "grid_blocks": blocks.value,
            "threads": GRID_THREADS}


def decision_lanes_plan(I: int, R: int, K: int) -> dict:
    """The lanes layout's plan for an [I, R, K] table on the current card, as
    ``csrc/decision.cu`` fixes it before each launch: lanes per context,
    whether the table's atoms and a tile's keys are staged in shared memory,
    the block's dynamic shared memory, blocks per SM and threads per block."""
    out = [_I(0) for _ in range(6)]
    _check(load().lib.zt_decision_lanes_plan(I, R, K, *map(ctypes.byref, out)),
           "zt_decision_lanes_plan")
    keys = ("lanes", "stage_atoms", "stage_keys", "smem_bytes", "blocks_per_sm", "threads")
    return {k: v.value for k, v in zip(keys, out)}


def run_decision(kind: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 flags: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor,
                 kernel: str = "lanes"):
    """The reference's ``_evaluate_batch`` on the card: atoms ``kind``,
    ``flags`` [I, R, K] and ``lo``, ``hi`` [I, R, K, 2] (int32), context keys
    [N, I, 2] (int32) and validity [N, I] (bool) → (m [N, R] bool, selected
    [N] int32, counts [N] int32). ``kernel`` is ``"lanes"`` (a context's
    rule words spread over threads) or ``"serial"`` (one thread per
    context). N = 0 launches nothing."""
    device = keys.device
    if kernel not in DECISION_KERNELS:
        raise ValueError(f"kernel must be one of {DECISION_KERNELS}, got {kernel!r}")
    if kind.dim() != 3:
        raise ValueError(f"kind must be [I, R, K], got {tuple(kind.shape)}")
    I, R, K = kind.shape
    N = keys.shape[0]
    i32 = torch.int32
    _require(kind, "kind", i32, (I, R, K), device)
    _require(flags, "flags", i32, (I, R, K), device)
    _require(lo, "lo", i32, (I, R, K, 2), device)
    _require(hi, "hi", i32, (I, R, K, 2), device)
    _require(keys, "keys", i32, (N, I, 2), device)
    _require(valid, "valid", torch.bool, (N, I), device)
    if R < 1:
        raise ValueError("a decision table needs at least one rule")
    if K > DECISION_MAX_ATOMS:
        raise ValueError(f"{K} atoms per cell exceed the kernel's {DECISION_MAX_ATOMS}")
    m = torch.empty((N, R), dtype=torch.bool, device=device)
    counts = torch.empty(N, dtype=i32, device=device)
    selected = torch.empty(N, dtype=i32, device=device)
    if N == 0:
        return m, selected, counts
    lib = load().lib
    stream = torch.cuda.current_stream(device).cuda_stream
    ptrs = (kind.data_ptr(), flags.data_ptr(), lo.data_ptr(), hi.data_ptr(), keys.data_ptr(),
            valid.data_ptr())
    outs = (m.data_ptr(), counts.data_ptr(), selected.data_ptr(), stream)
    entry = lib.zt_decision_lanes if kernel == "lanes" else lib.zt_decision
    # a C entry launches on the current device, and the lanes layout sizes
    # its grid from that device's occupancy: make it the keys' card
    with torch.cuda.device(device):
        code = entry(*ptrs, N, I, R, K, *outs)
    _check(code, f"zt_decision ({kernel})")
    LAUNCHES["decision"] += 1
    return m, selected, counts
