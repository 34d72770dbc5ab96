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
and one int32 scratch buffer, then ``zt_prepare`` copies the caller's state
in and initializes the scratch, and ``zt_steps`` enqueues the lock-steps on
PyTorch's current stream. Each C entry returns ``cudaGetLastError()``; a
non-zero code raises ``KernelLaunchError``.

Shards: a state may hold ``num_shards`` shard blocks back to back (the
reference's mesh layout, ``make_state(num_shards=n)``: token ``inst`` values
local to their block). Every phase of a step is one launch over all shards.
The counters are one per shard (``[NS]``) or one for all (a 0-d tensor,
replicated, as ``make_sharded_step`` takes them).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

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
# run_to_completion enqueues this many steps between reads of the loop flag
COMPLETION_BLOCK_STEPS = 8
MAX_FANOUT = 32  # take and condition masks ride 32-bit words
# the decision kernel stages 32 rules x K atoms of 24 bytes in shared memory
DECISION_MAX_ATOMS = 64

# Kernel launches, counted where they are enqueued: "step" counts every
# lock-step of an unsharded run (those inside run_collect and
# run_to_completion too); "run_collect" and "run_to_completion" count one
# per call. "sharded_step" counts every lock-step of a sharded run (one
# launch per phase over all shards; those inside sharded_collect too) and
# "sharded_collect" one per call.
# "decision" counts one per decision-table batch (zt_decision).
LAUNCHES = {"step": 0, "run_collect": 0, "run_to_completion": 0,
            "sharded_step": 0, "sharded_collect": 0, "decision": 0}


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


_SCRATCH = ("ctl", "occ", "pend", "arrivals", "consumed", "head", "tpi",
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
        if verbose:
            print("".join(errs) + proc.stderr, end="")
        os.replace(out, lib)
    return lib


class _Lib:
    """The loaded library with its argument types declared."""

    def __init__(self, path: Path) -> None:
        lib = ctypes.CDLL(str(path))
        ptr = ctypes.POINTER
        lib.zt_prepare.argtypes = [ptr(_Tables), ptr(_State), ptr(_State), ptr(_Scratch),
                                   _I, _I, _P, ctypes.c_int64, _P]
        lib.zt_prepare.restype = ctypes.c_int
        lib.zt_steps.argtypes = [ptr(_Tables), ptr(_State), ptr(_Scratch), _I, _I, _I,
                                 _P, ctypes.c_int64, ctypes.c_int64, _I, _I, _P]
        lib.zt_steps.restype = ctypes.c_int
        lib.zt_combine.argtypes = [ptr(_State), ptr(_State), _P, _P, _P, _P, _P]
        lib.zt_combine.restype = ctypes.c_int
        lib.zt_decision.argtypes = [_P] * 6 + [_I] * 4 + [_P] * 4
        lib.zt_decision.restype = ctypes.c_int
        lib.zt_decision_max_atoms.restype = ctypes.c_int
        lib.zt_scan_tile.restype = ctypes.c_int
        lib.zt_ctl_stride.restype = ctypes.c_int
        if lib.zt_scan_tile() != SCAN_TILE or lib.zt_ctl_stride() != CTL_N:
            raise KernelBuildError("scan tile or control stride of the library "
                                   "differs from the binding")
        if lib.zt_decision_max_atoms() != DECISION_MAX_ATOMS:
            raise KernelBuildError("the decision kernel's atom limit differs from "
                                   "the binding")
        self.lib = lib


_LOADED: _Lib | None = None


def load() -> _Lib:
    """Build (if needed) and load the library, once per process: the
    sources are read and hashed at the first call only, not per launch."""
    global _LOADED
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
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _tables_struct(tables, device) -> _Tables:
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
    ptrs = {}
    for name, (dtype, shape) in spec.items():
        t = getattr(tables, name)
        _require(t, f"tables.{name}", dtype, shape, device)
        ptrs[name] = t.data_ptr()
    return _Tables(**ptrs, D=D, E=E, FO=FO, C=C)


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


@dataclasses.dataclass
class _Run:
    """One working state plus scratch, prepared on the device."""

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
    st_in: _State  # the caller's state (make_sharded_step combines against it)
    keep: tuple  # tensors the structs point into


def prepare(tables, state: dict, config, mode: int, out: torch.Tensor | None,
            num_shards: int = 1, sharded: bool = False) -> _Run:
    """Validate the inputs, allocate the working state and scratch, and
    enqueue ``zt_prepare`` (copy in, scratch init, start-of-run occupancy).
    ``sharded`` marks a mesh run (its launches count as sharded ones)."""
    device = state["elem"].device
    lib = load()
    tb = _tables_struct(tables, device)
    E, FO = tb.E, tb.FO
    NS = num_shards
    st_in = _state_struct(state, E, device, NS)
    T, I = st_in.T, st_in.I
    # arrays the kernels never write under this config are shared with the
    # caller's state (JAX returns the same arrays); zt_prepare skips them
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
    nb_free = -(-T // SCAN_TILE)
    nb_req = -(-(T * FO) // SCAN_TILE)
    sizes = {"ctl": CTL_N, "occ": I * E, "pend": I * E, "arrivals": I * E,
             "consumed": I * E, "head": I * E, "tpi": I, "req_target": T * FO,
             "req_flags": T * FO, "next": T * FO, "proceeds": T * FO,
             "place_rank": T * FO, "free_flag": T, "tok_flags": T, "tok_inst": T,
             "tok_elem": T, "slot_of_rank": T, "block_sums": nb_free + nb_req}
    sizes = {name: NS * n for name, n in sizes.items()}
    align = 64  # 256-byte aligned sub-buffers
    offsets, total = {}, 0
    for name in _SCRATCH:
        offsets[name] = total
        total += -(-sizes[name] // align) * align
    scratch = torch.empty(total, dtype=torch.int32, device=device)
    base = scratch.data_ptr()
    sc = _Scratch(**{n: base + 4 * offsets[n] for n in _SCRATCH})
    stream = torch.cuda.current_stream(device).cuda_stream
    out_ptr = out.data_ptr() if out is not None else None
    out_len = out.numel() if out is not None else 0
    _check(lib.lib.zt_prepare(ctypes.byref(tb), ctypes.byref(st_in), ctypes.byref(st),
                              ctypes.byref(sc), mode, cfg, out_ptr, out_len, stream),
           "zt_prepare")
    ctl = scratch[offsets["ctl"]:offsets["ctl"] + NS * CTL_N].view(NS, CTL_N)
    return _Run(lib, tb, st, sc, work, scratch, ctl, nb_free, nb_req, cfg, sharded,
                st_in, keep=(tables, state, out))


def launch_steps(run: _Run, n_steps: int, mode: int, out: torch.Tensor | None,
                 row_len: int) -> None:
    """Enqueue ``n_steps`` lock-steps on a prepared run (no synchronization)."""
    stream = torch.cuda.current_stream(run.scratch.device).cuda_stream
    out_ptr = out.data_ptr() if out is not None else None
    _check(run.lib.lib.zt_steps(ctypes.byref(run.tables), ctypes.byref(run.st),
                                ctypes.byref(run.sc), n_steps, mode, run.cfg, out_ptr,
                                0, row_len, run.nb_free, run.nb_req, stream),
           "zt_steps")
    LAUNCHES["sharded_step" if run.sharded else "step"] += n_steps


def run_steps(tables, state: dict, n_steps: int, config, auto_jobs: bool,
              emit_events: bool, mode: str, num_shards: int = 1, sharded: bool = False):
    """``mode="collect"``: run_collect (events on, early exit on the device,
    per shard); ``mode="step"``: one step. Returns (state', packed rows |
    None); the rows are [n_steps, num_shards * row_len], shard s at columns
    [s * row_len, (s + 1) * row_len)."""
    T = state["elem"].shape[0] // num_shards
    FO = tables.out_target.shape[2]
    row_len = T * (2 + FO) + 2
    bits = (MODE_AUTO_JOBS if auto_jobs else 0) | (MODE_EMIT if emit_events else 0)
    if mode == "collect":
        bits |= MODE_COLLECT
    out = (torch.empty((n_steps, num_shards * row_len), dtype=torch.int32,
                       device=state["elem"].device)
           if emit_events else None)
    run = prepare(tables, state, config, bits, out, num_shards, sharded)
    launch_steps(run, n_steps, bits, out, row_len)
    if mode == "collect":
        LAUNCHES["sharded_collect" if sharded else "run_collect"] += 1
    return run.state, out


def run_sharded_step(tables, state: dict, num_shards: int, config,
                     auto_jobs: bool) -> dict:
    """make_sharded_step's program: one lock-step of every shard (no events),
    then ``zt_combine`` writes the counters: the input's plus the sum of the
    shards' deltas, and the OR of the shards' overflow flags. The state's
    counters are 0-d (replicated) on input and on output."""
    if tuple(state["transitions"].shape) != ():
        raise ValueError("make_sharded_step takes replicated (0-d) counters")
    bits = MODE_AUTO_JOBS if auto_jobs else 0
    run = prepare(tables, state, config, bits, None, num_shards, sharded=True)
    launch_steps(run, 1, bits, None, 0)
    new_state = dict(run.state)
    if num_shards > 1:
        for name in _COUNTERS:
            new_state[name] = torch.empty((), dtype=state[name].dtype,
                                          device=state[name].device)
        stream = torch.cuda.current_stream(run.scratch.device).cuda_stream
        _check(run.lib.lib.zt_combine(
            ctypes.byref(run.st_in), ctypes.byref(run.st),
            *(new_state[name].data_ptr() for name in _COUNTERS), stream), "zt_combine")
    return new_state


def run_until_quiet(tables, state: dict, max_steps: int, config, auto_jobs: bool):
    """run_to_completion: steps with no events until no token is live. The
    host reads the device loop flag once per ``COMPLETION_BLOCK_STEPS``
    steps; the steps in between are no-ops once it drops."""
    bits = MODE_COMPLETION | (MODE_AUTO_JOBS if auto_jobs else 0)
    run = prepare(tables, state, config, bits, None)
    LAUNCHES["run_to_completion"] += 1
    done = 0
    while done < max_steps:
        n = min(COMPLETION_BLOCK_STEPS, max_steps - done)
        launch_steps(run, n, bits, None, 0)
        done += n
        if int(run.ctl[0, CTL_GO]) == 0:
            break
    steps = run.ctl[0, CTL_STEPS].clone()
    return run.state, steps


def run_decision(kind: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 flags: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor):
    """The reference's ``_evaluate_batch`` on the card: atoms ``kind``,
    ``flags`` [I, R, K] and ``lo``, ``hi`` [I, R, K, 2] (int32), context keys
    [N, I, 2] (int32) and validity [N, I] (bool) → (m [N, R] bool, selected
    [N] int32, counts [N] int32). N = 0 launches nothing."""
    device = keys.device
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
    lib = load()
    stream = torch.cuda.current_stream(device).cuda_stream
    _check(lib.lib.zt_decision(kind.data_ptr(), flags.data_ptr(), lo.data_ptr(),
                               hi.data_ptr(), keys.data_ptr(), valid.data_ptr(), N, I, R, K,
                               m.data_ptr(), counts.data_ptr(), selected.data_ptr(), stream),
           "zt_decision")
    LAUNCHES["decision"] += 1
    return m, selected, counts
