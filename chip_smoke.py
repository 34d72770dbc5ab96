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
5. the kernel ceiling: run_to_completion of one_task at I = T = 1<<20 on
   the grid kernel (one cooperative launch per call), byte-equal to the
   plain version (state and steps) and to the forced chain, 20 repeats each
   byte-equal; ms per call and per live lock-step beside the bound of the
   same work; an A/B in turns (chain, grid, grid, chain) at 1<<20 and 1<<16;
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
8. DMN batch evaluation: both layouts of the decision kernel
   (``csrc/decision.cu``: lanes, the default, and serial) byte-equal to
   their plain version at the benchmark's geometry (``run_dmn_batch``:
   N = 200,000 contexts, I = 2, R = 8, K = 4) and at a wide one (N = 16,384,
   I = 4, R = 512, K = 4, random atoms of every kind and flag), timed in
   turns (serial, lanes, lanes, serial: wrapper call, raw launches, profiler);
   ``batch_evaluate`` lists equal to the plain outputs' under every hit
   policy and COLLECT aggregation at both; a 2,000-context sample equal to
   the host DecisionEngine's unary tests; rows/s through ``batch_evaluate``
   with the share of the wall in ``pack_contexts``;
9. the device-fault seam on the card: a clean serving group (I = 2048, mixed
   set) driven through every wave at shadow rate 1.0 (the CPU oracle matches,
   nothing quarantined); at I = 256, injected corruption (every injection
   caught: by the shadow, which quarantines the device's rows and returns
   the host oracle's steps and state, equal to a clean run's, or contained
   as a typed decline), a stall past a 200 ms watchdog deadline (a typed
   wedge within the deadline plus 1 s, the ladder at SUSPECT), a dispatch
   exception (a typed dispatch error), and a flat thread count over 20
   wedges;
10. the engine stack and the profiler's device half: ``sample_device_memory``
    sets both children of ``zeebe_device_memory_bytes`` for the card, one
    ``DeviceTraceCapture`` around a ``run_group`` writes a Chrome trace that
    must hold ``k_chunk`` kernel events, and the sequential
    ``EngineHarness`` (no kernel) deploys one_task and the mixed set and
    completes 2,000 instances through their job waves (every instance's
    process ``ELEMENT_COMPLETED`` record counted), printing records/s and
    instances/s with whether the native codec loaded and which
    ``SortedList`` the durable store has;
11. the serving write path: phase 10's commands, from the same clock start,
    through the port's StreamProcessor with the partition's
    ``KernelBackend(engine, max_group=2048, chunk_steps=8)`` on the card
    (admission, each group on ``k_chunk`` at I = 2048, T = 8192,
    materialization); the record log byte-identical to phase 10's, every
    instance complete, each of the nine definitions 100% on the kernel
    path, no group declined, nothing shadow-quarantined, ``k_chunk``
    launched; records/s and instances/s beside phase 10's, groups, commands
    on the kernel, template hits and misses, chunk launches and the compile
    seam's first-dispatch seconds;
12. the replicated cluster, deterministic: ``InProcessCluster`` of 3
    brokers, 3 partitions and replication factor 3 (the reference's default
    cluster; Zeebe's published benchmark layout) on a controlled clock over
    the loopback network, without the brokers' control plane (its
    journal-flush loop paces Raft's commits by the wall clock), each
    leader's ``KernelBackend(max_group=2048, chunk_steps=8)`` on the
    card; phase 10's definitions deployed on
    partition 1 and distributed, 600 instances through the leaders'
    client ingress (200 a partition, round robin, x = i mod 30), every
    job activated and completed in waves of up to 1,000 per type. Every
    instance completes, each partition's log is byte-identical on its three
    replicas and to the same cluster run with ``kernel_backend=False`` on
    the same schedule, every definition is 100% on the kernel with no group
    declined, and the link-aware router sent no group to the host and
    counted every group on the card; then the same schedule once more with
    one mesh runner of 3 shards injected into every broker (B7 through the
    broker, as ``ClusterRuntime`` injects it): its logs byte-identical to
    the sequential cluster's too, ``sharded_collect`` launched; records/s
    and instances/s for the cluster and per partition beside the
    sequential cluster's, groups, commands per group, ``k_chunk`` launches,
    the router's stats (the measured link) and the shadow checks;
13. the gateway's runtime answers requests: ``ClusterRuntime`` of the same
    shape with one mesh runner of 3 shards on the card and a 2 ms batch
    window (B7 through the broker, the partitions' groups coalescing), its
    partition threads started; through ``submit``: the deployment, 300
    creations (27 one at a time, one a partition and process, so that the
    partitions' kernel registries hold equal table sets; the rest from 8
    client threads; each awaited), then activations and completions until
    every instance completes. Fails on a rejected or
    timed-out request, an instance not completed, or no
    ``sharded_collect`` launch; prints request latency p50/p99, the mesh
    runner's dispatches and coalesced share, the router's counts and the
    card's busy share of the phase (``torch.profiler``);
14. the gRPC front: the port's ``Gateway`` over a ``ClusterRuntime`` of
    phase 13's shape built with no device argument (the card), the port's
    ``ZeebeTpuClient`` against it: phase 10's nine definitions and one DMN
    through ``DeployResource``, 300 ``CreateProcessInstance`` calls (27 one
    at a time, each process once on each partition, the rest from 8 client
    threads), one instance created and cancelled, one ``JobWorker`` per job
    type over ``StreamActivatedJobs`` until every instance completes, then
    ``Topology``, ``CreateProcessInstanceWithResult``, ``EvaluateDecision``
    and ``PublishMessage``. Fails on a non-OK status, a failed job, an
    instance not completed, instances or jobs the client saw that differ
    from the leaders' logs, a group the router sent to the host, or no
    ``sharded_collect`` launch; prints gRPC create latency beside phase
    13's ``submit`` latency, the gateway's ``gateway_request_latency`` per
    RPC, the mesh runner's dispatches and coalesced share, the router's
    counts and the card's busy share;
15. the standalone entry point: ``python -m zeebe_tpu_torch.standalone``
    as a subprocess with no device argument (the card), in its three
    shapes of 3 partitions x replication 3, each with a data directory, a
    management port and the completion exporter
    (``testing/standalone_run.py``), driven by the port's client with phase
    14's definitions (the creations one at a time first, then 8 client
    threads, one ``JobWorker`` a job type): supervised workers
    (``--workers 3``, 600 creations, the first worker that leads a
    partition killed with SIGKILL after the 300th; the supervisor restarts it and it
    recovers), three broker processes over TCP (300 through broker-0's
    gateway) and in-process brokers (150). Fails on a non-OK status (but
    the brokers' backpressure, and a typed retryable one after the kill,
    retried and counted), an instance
    not completed, a partition leader without kernel records on
    ``/cluster/status``, a host record routed to the host or contained by
    the fault seam, a device ladder not HEALTHY, replicas whose stream
    logs (read offline after the stop) disagree or miss a completion the
    client saw, an exit code other than 0 after SIGTERM, or a process left
    alive. Prints each shape's seconds to serving and boot timeline, each
    process's start-up split (probe, CUDA context, kernel library, link),
    create latency p50/p99 beside phase 14's, each leader's kernel and
    host records and the supervisor's restarts. The workers' launches are
    counted in their own processes: the kernels line does not add them.
    Against the in-process shape, before its stop, the command line
    (``python -m zeebe_tpu_torch.cli`` subprocesses, no device argument):
    ``status``, ``deploy`` of a one_task file, 20 ``create instance``,
    ``activate jobs`` and ``complete job`` for each of their jobs, ``top
    --once`` and ``profile --seconds 1 --folded``; after the stop, on its
    data directory, ``trace`` of each of the 20 instances, ``snapshots``
    and ``eligibility --deployed``; then ``lint``, ``knobs-doc``,
    ``eligibility-doc`` and ``metrics-doc --check`` (its broker on the
    card), and the client-side modules imported in fresh processes. Fails
    on an exit code other than 0, an instance not completed or whose trace
    lacks its completion, a leader whose kernel records did not grow over
    the command line's traffic, or a command's process that loaded torch
    (``-X importtime``; all but ``metrics-doc`` and ``eligibility
    --deployed``). Prints each command's wall seconds;
16. the engine's gates (``zeebe_tpu_torch/testing/``), each called as a
    function with no device argument (the card), each failing the smoke on
    any entry of its own ``violations``: (a) the soak, ``run_soak``'s
    harness in its CI short mode (5 power-loss crash-restart rounds of 18
    creations, mid-flush and mid-snapshot) in this process with the port's
    sanitizer installed; every restart within its recovery budget, a
    command acked, and every round's leader counting kernel records and
    launching ``k_chunk`` (counted from 0); (b) device chaos,
    ``run_device_chaos`` in its quick preset (3 worker processes, 2
    partitions x replication 3, 30 s drive, 1 kill, compile, dispatch,
    stall, chunk and corruption faults injected at the seam, every group
    shadowed; the router on, as in every deployment on the card: a SUSPECT
    card it biases host-ward is probed through the seam one group a canary
    interval), every partition's leader counting kernel records on its
    last status row; (c)
    serving, ``run_serving`` in its quick preset with the kernel backend on
    (open-loop arrivals from 128 client streams, calm, overload, a worker
    kill; SLO, fairness, goodput and fast sheds), every partition's leader
    showing its backend live on the card and its host records declined at
    admission (every command of the gate names a tenant; the kernel takes
    the default tenant's only, as in the reference). Every worker of (b)
    and (c) must have served on the card (its log's probe and CUDA
    start-up lines before its serving line). Prints the recovery ms
    per restart, the faults observed, the corruption accounting, the
    health cycle, the kills, each worker's start-up, per-tenant latency,
    goodput, the shed p95 and each gate's wall time;
17. the mesh as launch groups (``parallel/mesh.py``): phase 6's 8 shard
    blocks in 2 and in 8 launch groups on cuda:0 (and one group per card
    where there are two or more cards); the grouped sharded step (6 steps,
    the grouped state carried from step to step) and the runner's grouped
    sharded collect (chunk by chunk with job waves) byte-equal to the
    one-group launch and to the plain version, the cross-group counter sum
    (``k_combine_groups``) byte-equal to its plain version and launched;
    each layout's time per call beside the one-group time; then the graft
    entry (``zeebe_tpu_torch/graft_entry.py``): ``entry()``'s step
    byte-equal to its plain version and ``dryrun_multichip(8)`` (8 one-block
    groups on the one card: the sharded step twice, then the serving path
    through a ``MeshKernelRunner`` over that mesh);
18. random graphs (``zeebe_tpu_torch/testing/random_graphs.py``, the port's
    copy of the reference suite's generator): each of its 120 seeds
    compiled as the kernel backend compiles it (a ``KernelRegistry``,
    elements outside the device subset escaped to the host as ``K_HOST``),
    a group of I = 64 run chunk by chunk with job waves on the fused chunk,
    the forced chain and the plain version (rows and state byte-equal at
    every chunk), and ``run_to_completion`` on the grid kernel and the
    plain version with auto jobs on and off; 8 seeds also at the serving
    geometry (I = 2048); the seeds in blocks of 8 as 8 shards (one
    definition each, I = 32 a shard), the sharded collect and step as one
    launch group and as 2 groups on cuda:0 against their plain versions;
    8 seeds through the kernel-backed harness on the card, the record log
    equal to the sequential engine's; 50 random decision tables and the
    device suite's own (dish, its one-ulp boundary at 8.5, collect under
    every aggregation and in rule order, intervals): ``batch_evaluate`` on
    the card equal to the host ``DecisionEngine`` (but the reference's own
    COLLECT COUNT difference, counted), both decision layouts byte-equal
    to the plain version. Prints the counts and the phase's seconds;
19. prints the kernels line (JSON), then the card line, then the result line.

Three paths run the automaton's steps (``ops/kernels.py``): the fused
chunk, one thread-block cluster per shard and ONE launch per chunk, for
shards of up to ``kernels.FUSED_MAX_TOKENS`` token slots (the serving
geometry); the chain of per-phase launches above that; and the grid kernel,
ONE cooperative launch over the whole card per run_to_completion. Phases 3
and 6 hold the first two (the chain forced with ``path="chain"``) byte-equal
to the plain version, including chunks that go quiet before their last
step; phases 4 and 7 check that every serving chunk was one fused grid
launch, phase 5 that run_to_completion was one grid launch. Beside them:

- phase 2 prints the fused kernel's registers and spills (``-Xptxas -v``)
  and ``cudaOccupancyMaxActiveClusters`` (8 shard clusters must fit), the
  grid kernel's registers, spills, blocks per SM and co-resident grid, and
  the lanes decision layout's registers;
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
  win);
- the shapes phase holds the fused chunk's block shape (one block per
  shard) and its cluster shape byte-equal to the plain version at T = 64,
  128, 256, 512 and 1024 with every serving set, and times one launch of
  each in turns (cluster, block, block, cluster) by the profiler: the
  largest T up to which the block shape wins is the threshold
  ``kernels.FUSED_BLOCK_MAX_TOKENS`` is set from.

Imports neither JAX nor the JAX package. Launch counts are zeroed right
before each main path runs (phase 4 for step and run_collect, phase 5 for
run_to_completion, phase 7 for sharded_step and sharded_collect, phase 8's
``batch_evaluate`` at the benchmark's geometry for decision, phase 11 for
run_collect on the serving write path, phases 12, 13 and 14 for
run_collect and sharded_collect on the cluster, phase 17 for the cross-group
counter sum) and read right after; comparison
launches, phase 10's traced ``run_group`` and phase 18's random graphs do
not count. Each entry of
the kernels line names its path and its grid launches per call;
run_collect's also its launches on the serving write path
(``engine_launches``), run_collect's and sharded_collect's their launches
on the cluster (``cluster_launches``) and of those phase 14's
(``grpc_launches``), run_to_completion's its live steps
and its time per live lock-step beside that step's bound, and decision's
the serial layout's time.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from zeebe_tpu_torch.broker.broker import Broker, InProcessCluster
from zeebe_tpu_torch.broker.partition import BackpressureExceeded
from zeebe_tpu_torch.dmn import parse_dmn_xml
from zeebe_tpu_torch.engine import kernel_backend as kb
from zeebe_tpu_torch.engine.device_health import SUSPECT, reset_shared_device_health
from zeebe_tpu_torch.gateway import ClusterRuntime
from zeebe_tpu_torch.logstreams import LogAppendEntry
from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml, transform
from zeebe_tpu_torch.observability import profiler as P
from zeebe_tpu_torch.ops import automaton as A
from zeebe_tpu_torch.ops import decision as D
from zeebe_tpu_torch.ops import kernels
from zeebe_tpu_torch.ops.tables import compile_tables, f64_key_planes
from zeebe_tpu_torch.parallel import mesh as M
from zeebe_tpu_torch.parallel import mesh_runner as MR
from zeebe_tpu_torch.protocol import Record, ValueType, command
from zeebe_tpu_torch.protocol.intent import (
    DeploymentIntent,
    JobBatchIntent,
    JobIntent,
    ProcessInstanceCreationIntent,
    ProcessInstanceIntent,
)
from zeebe_tpu_torch.testing import EngineHarness
from zeebe_tpu_torch.testing import random_graphs as RG
from zeebe_tpu_torch.testing.random_graphs import max_abs_err
from zeebe_tpu_torch.testing import workloads as W
from zeebe_tpu_torch.testing.catalog import ProcessCatalog
from zeebe_tpu_torch.testing.chaos_device import DeviceChaosController, DeviceFaultPlan
from zeebe_tpu_torch.testing.import_cost import CLIENT_MODULES, import_once
from zeebe_tpu_torch.utils.device_link import shared_router

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
# per call, plus the counter combine for the sharded step), the grid kernel
# (one cooperative launch per call), or (decision) the lanes layout
MAIN_PATH = {"step": "fused", "run_collect": "fused", "run_to_completion": "grid",
             "sharded_step": "fused", "sharded_collect": "fused", "decision": "lanes"}
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
COMPLETION_TURNS = ("chain", "grid", "grid", "chain")
DECISION_TURNS = ("serial", "lanes", "lanes", "serial")


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
        T = RG.token_capacity(tables, I)
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
            if A.grid_launch_counts() != {"fused": 1, "chain": 0, "combine": 0, "grid": 0}:
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
    if grid != {"fused": launches["run_collect"], "chain": 0, "combine": 0, "grid": 0}:
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


def ceiling_setup(n: int, dev):
    """one_task at I = T = n, every instance at its start event."""
    tables = compile_tables([transform(W.one_task())])
    dt = A.DeviceTables.from_numpy(tables, dev)
    state = A.make_state(tables, n, np.zeros(n, np.int32), token_capacity=n, device=dev)
    return dt, tables.kernel_config, state


def completion_ms(dt, state: dict, config, path: str, steps: int) -> dict:
    """One run_to_completion of a path: the wrapper call (CUDA events), its
    grid launches, and one live lock-step on buffers allocated once (no
    wrapper work): the copy-in plus ``steps`` lock-steps less the copy-in
    alone, over ``steps``."""
    call = lambda: kernels.run_until_quiet(dt, state, 64, config, True, path=path)  # noqa: E731
    bits = kernels.MODE_COMPLETION | kernels.MODE_AUTO_JOBS
    if path == "grid":
        run = kernels.allocate(dt, state, config)

        def upto(k):
            return lambda: kernels.launch_complete(run, k, bits)
    else:
        step_bits = kernels.MODE_AUTO_JOBS

        def upto(k):
            def f():
                run = kernels.prepare(dt, state, config, step_bits, None)
                if k:
                    kernels.launch_steps(run, k, step_bits, None, 0)
            return f
    copy_ms = time_ms(upto(0), 10)
    return {"call_ms": time_ms(call, 10), "step_ms": (time_ms(upto(steps), 10) - copy_ms) / steps,
            "copy_ms": copy_ms, "grid_per_call": grid_per_call(call)}


def phase_ceiling(dev, card: str) -> dict:
    """Phase 5: run_to_completion of one_task at I = T = 1<<20 on the grid
    kernel (the main path, counted: one grid launch per call), held
    byte-equal to the plain version (state and steps); 20 repeats each
    byte-equal; the forced chain in turns with it (chain, grid, grid,
    chain) at 1<<20 and at 1<<16."""
    n = 1 << 20
    dt, config, state = ceiling_setup(n, dev)
    A.run_to_completion(dt, state, max_steps=64, config=config)  # warm-up, not counted
    torch.cuda.synchronize()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    kf, ksteps = A.run_to_completion(dt, state, max_steps=64, config=config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = A.launch_counts()
    grid = A.grid_launch_counts()
    if grid != {"fused": 0, "chain": 0, "combine": 0, "grid": 1}:
        raise AssertionError(f"run_to_completion was not one grid launch: {grid}")
    pf, psteps = A.run_to_completion_plain(dt, state, max_steps=64, config=config)
    err = max_abs_err(kf, pf)
    steps = int(psteps)
    if err or int(ksteps) != steps:
        raise AssertionError("run_to_completion differs from plain at the ceiling")
    if not bool(kf["done"].all()) or bool(kf["overflow"]):
        raise AssertionError("ceiling run incomplete or overflowed")
    cf, csteps = kernels.run_until_quiet(dt, state, 64, config, True, path="chain")
    if max_abs_err(cf, pf) or int(csteps) != steps:
        raise AssertionError("the forced chain differs from plain at the ceiling")
    for k in range(20):
        rf, rsteps = A.run_to_completion(dt, state, max_steps=64, config=config)
        if max_abs_err(rf, pf) or int(rsteps) != steps:
            raise AssertionError(f"repeat {k} of the grid kernel at the ceiling differs")
    plain_ms = time_ms(lambda: A.run_to_completion_plain(dt, state, max_steps=64,
                                                         config=config), 2)
    transitions = int(kf["transitions"])
    step_bytes = moved_bytes(dt, state, config)
    # the call's least work is its live steps, the first reading the caller's
    # state: a copy-in of its own is the kernel's choice, not the function's
    bound = steps * step_bytes / HBM_BYTES_PER_S * 1e3
    step_bound = step_bytes / HBM_BYTES_PER_S * 1e3
    log(f"phase5 ceiling [{card}]: one_task I=T={n}, {steps} live steps, {transitions} "
        f"transitions; grid kernel byte-equal to plain (state and steps), the forced chain "
        f"too, 20 repeats each byte-equal; first call {wall * 1e3:.3f} ms; plain "
        f"{plain_ms:.3f} ms; bound {bound * 1e3:.3f} us for the call ({steps} x {step_bytes} "
        f"B), {step_bound * 1e3:.3f} us per live step, at 3.35 TB/s")

    # the A/B in turns at the ceiling and at 1<<16 (each held byte-equal)
    sdt, sconfig, sstate = ceiling_setup(1 << 16, dev)
    sf, ssteps = A.run_to_completion_plain(sdt, sstate, max_steps=64, config=sconfig)
    for path in ("grid", "chain"):
        gf, gsteps = kernels.run_until_quiet(sdt, sstate, 64, sconfig, True, path=path)
        if max_abs_err(gf, sf) or int(gsteps) != int(ssteps):
            raise AssertionError(f"{path} differs from plain at I=T=1<<16")
    turns = []
    for path in COMPLETION_TURNS:
        r = completion_ms(dt, state, config, path, steps)
        r16 = completion_ms(sdt, sstate, sconfig, path, int(ssteps))
        turns.append({**r, **{f"{k}_T65536": v for k, v in r16.items()}})
    log(f"phase5 A/B [{card}] turns {list(COMPLETION_TURNS)} (I=T=1<<20 unless marked):")
    for key in turns[0]:
        log(f"  {key}: {[round(r[key], 6) if isinstance(r[key], float) else r[key] for r in turns]}")
    grid_ms = (turns[1]["call_ms"] + turns[2]["call_ms"]) / 2
    chain_ms = (turns[0]["call_ms"] + turns[3]["call_ms"]) / 2
    step_ms = (turns[1]["step_ms"] + turns[2]["step_ms"]) / 2
    chain_step_ms = (turns[0]["step_ms"] + turns[3]["step_ms"]) / 2
    log(f"phase5 timing [{card}]: grid kernel {grid_ms:.4f} ms per call "
        f"({transitions / grid_ms * 1e3:.1f} transitions/s), {step_ms:.4f} ms per live "
        f"lock-step, {turns[1]['grid_per_call']} grid launch(es) per call; forced chain "
        f"{chain_ms:.4f} ms per call, {chain_step_ms:.4f} ms per live lock-step, "
        f"{turns[0]['grid_per_call']} grid launches per call")
    return {"launches": launches, "ms": grid_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "err": err, "step_ms": step_ms, "step_bound_ms": step_bound,
            "grid_launches": grid["grid"], "chain_ms": chain_ms, "chain_step_ms": chain_step_ms,
            "chain_grid_launches": turns[0]["grid_per_call"], "steps": steps}


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
        if A.grid_launch_counts() != {"fused": 1, "chain": 0, "combine": 0, "grid": 0}:
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
            "step": step, "collect": collect, "rows": krows, "tables": tables}


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
    if grid != {"fused": launches["sharded_collect"], "chain": 0, "combine": 0, "grid": 0}:
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


# the serving sets, and the fused chunk's shape sweep: T per shard, where
# the block shape (one block per shard) is held against the cluster
SHAPE_SETS = {"one_task": lambda: [W.one_task()],
              "exclusive_chain": lambda: [W.exclusive_chain()],
              "fork_join": lambda: [W.fork_join()], "ten_tasks": lambda: [W.ten_tasks()],
              "subprocess_boundary": lambda: [W.subprocess_boundary()],
              "mixed": W.mixed_definitions}
SHAPE_SWEEP = (64, 128, 256, 512, 1024)
SHAPE_TURNS = ("cluster", "block", "block", "cluster")


def shape_groups(T: int, rng, dev) -> dict:
    """Each serving set's group at T token slots (I by the group rule: T
    over the power of two of the set's width) as the start states of two
    chunks: the fresh group (its creations), and the group after its first
    chunk and job wave (its completions)."""
    out = {}
    for name, models in SHAPE_SETS.items():
        tables = compile_tables([transform(m) for m in models()])
        I = max(1, T // kb._pow2(max(tables.token_width, 1)))
        state, _ = group_setup(tables, I, T, rng, dev)
        dt = A.DeviceTables.from_numpy(tables, dev)
        config = tables.kernel_config
        after, _ = A.run_collect_plain(dt, state, n_steps=8, config=config)
        jobs = kb.parked_jobs(tables, after)
        if jobs.size:
            after = A.complete_jobs(after, jobs)
        out[name] = (dt, config, (state, after))
    return out


def shape_chunk(dt, state: dict, config, shape: str):
    """run_collect forced onto one shape of the fused chunk."""
    return kernels.run_steps(dt, state, 8, config, auto_jobs=False, emit_events=True,
                             mode="collect", path="fused", shape=shape)


def fused_launch_us(groups: dict, shape: str, reps: int) -> float | None:
    """Device microseconds of one fused chunk launch of ``shape`` from
    ``torch.profiler``: the mean over the traced launches of ``reps`` from
    each start state of every group of ``shape_groups`` (a session's trace
    may miss launches; None when it shows none)."""
    from torch.profiler import ProfilerActivity, profile

    calls = [(dt, config, st) for dt, config, states in groups.values() for st in states]
    for dt, config, st in calls:
        shape_chunk(dt, st, config, shape)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for dt, config, st in calls:
                shape_chunk(dt, st, config, shape)
        torch.cuda.synchronize()
    ours = [e for e in prof.key_averages() if "k_chunk" in e.key
            and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.device_time_total for e in ours)
    launches = sum(e.count for e in ours)
    return total_us / launches if launches and total_us > 0 else None


def phase_fused_shapes(rng, dev, card: str, reps: int = 25) -> dict:
    """The fused chunk's two shapes at T = 64 ... 1024 token slots a shard
    (``SHAPE_SWEEP``), with each serving set's group at the group rule's I:
    both shapes byte-equal to the plain version on a creation and a
    completion chunk, then in turns (cluster, block, block, cluster) the
    device time of one launch from the profiler, over every set. The
    threshold is the largest T up to which the block shape wins at every T
    (each shape's mean over its turns); ``kernels.FUSED_BLOCK_MAX_TOKENS``
    is set from it. A trace that shows no launch leaves the times not
    measured."""
    t0 = time.perf_counter()
    A.reset_launch_counts()
    table = {}
    for T in SHAPE_SWEEP:
        groups = shape_groups(T, rng, dev)
        for name, (dt, config, states) in groups.items():
            for st in states:
                want_state, want_rows = A.run_collect_plain(dt, st, n_steps=8, config=config)
                for shape in kernels.FUSED_SHAPE_NAMES:
                    got_state, got_rows = shape_chunk(dt, st, config, shape)
                    if max(max_abs_err({"rows": got_rows}, {"rows": want_rows}),
                           max_abs_err(got_state, want_state)):
                        raise AssertionError(f"the {shape} shape differs from plain at T={T} "
                                             f"({name})")
        table[T] = [fused_launch_us(groups, shape, reps) for shape in SHAPE_TURNS]
    counts = A.fused_shape_counts()
    if not counts["block"] or not counts["cluster"]:
        raise AssertionError(f"phase shapes: a shape never launched: {counts}")
    log(f"phase shapes [{card}] turns {list(SHAPE_TURNS)}, us per fused launch "
        f"(torch.profiler, {reps} launches from a creation and a completion chunk of each "
        f"of {len(SHAPE_SETS)} sets): "
        + "; ".join(f"T={T} {[None if us is None else round(us, 3) for us in turns]}"
                    for T, turns in table.items()))
    if any(us is None for turns in table.values() for us in turns):
        log(f"phase shapes [{card}]: a trace showed no launch: the threshold is not measured; "
            f"launches by shape {counts}; {time.perf_counter() - t0:.1f} s")
        return {"table": table, "threshold": None}
    means = {T: {shape: sum(us for turn, us in zip(SHAPE_TURNS, turns) if turn == shape)
                 / SHAPE_TURNS.count(shape) for shape in kernels.FUSED_SHAPE_NAMES}
             for T, turns in table.items()}
    threshold = None
    for T in SHAPE_SWEEP:
        if means[T]["block"] >= means[T]["cluster"]:
            break
        threshold = T
    log(f"phase shapes [{card}]: the block shape wins up to T={threshold} "
        f"(kernels.FUSED_BLOCK_MAX_TOKENS = {kernels.FUSED_BLOCK_MAX_TOKENS}); means "
        + "; ".join(f"T={T} block {m['block']:.3f} cluster {m['cluster']:.3f}"
                    for T, m in means.items())
        + f"; launches by shape {counts}; {time.perf_counter() - t0:.1f} s")
    return {"table": table, "means": means, "threshold": threshold}


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


def decision_launcher(kernel: str, atoms, keys, valid):
    """A raw launch of one decision kernel on preallocated outputs (no
    wrapper work). ``atoms`` is (kind, lo, hi, flags), the order of
    ``run_decision``; the C entries take (kind, flags, lo, hi)."""
    lib = kernels.load().lib
    kind, lo, hi, flags = atoms
    N, I, R, K = keys.shape[0], *kind.shape
    m = torch.empty((N, R), dtype=torch.bool, device=keys.device)
    counts = torch.empty(N, dtype=torch.int32, device=keys.device)
    selected = torch.empty_like(counts)
    ptrs = [t.data_ptr() for t in (kind, flags, lo, hi, keys, valid)]
    outs = [m.data_ptr(), counts.data_ptr(), selected.data_ptr(),
            torch.cuda.current_stream().cuda_stream]
    args = ptrs + [N, I, R, K] + outs
    fn = lib.zt_decision_lanes if kernel == "lanes" else lib.zt_decision
    keep = (m, counts, selected)

    def launch():
        fn(*args)
        return keep  # the outputs live as long as the launcher
    return launch


def decision_device_ms(kernel: str, atoms, keys, valid) -> tuple[float, float | None]:
    """One decision kernel without its wrapper: raw launches back to back
    on preallocated outputs (CUDA events), and the kernel's own time from a
    torch.profiler trace of 20 launches (None when the trace shows none)."""
    launch = decision_launcher(kernel, atoms, keys, valid)
    back_to_back = time_ms(launch, 200)
    from torch.profiler import ProfilerActivity, profile

    def ours(key: str) -> bool:
        return "k_decision_lanes" in key if kernel == "lanes" else (
            "k_decision" in key and "lanes" not in key)

    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                launch()
            torch.cuda.synchronize()
        total_us = sum(getattr(e, "device_time_total", 0) or 0 for e in prof.key_averages()
                       if ours(e.key))
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
        if got != RG.host_matches(decision, contexts[i]):
            raise AssertionError(f"context {contexts[i]}: kernel {got}, host engine "
                                 f"{RG.host_matches(decision, contexts[i])}")

    wtable = wide_table(rng)
    wcontexts = wide_contexts(rng, 16_384)
    geometries = {"bench": (table, contexts, keys, valid)}
    geometries["wide"] = (wtable, wcontexts) + wtable.pack_contexts(wcontexts)
    for name, (t, ctxs, k, v) in geometries.items():
        atoms = [torch.from_numpy(a).to(dev) for a in (t.kind, t.lo, t.hi, t.flags)]
        kk, vv = torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev)
        plain = D._evaluate_batch(*atoms, kk, vv)
        got = D.evaluate_batch(*atoms, kk, vv)
        err = max(decision_err(got, plain),
                  decision_err(kernels.run_decision(*atoms, kk, vv, kernel="serial"), plain))
        info["err"] = max(info["err"], err)
        if err:
            raise AssertionError(f"{name}: a decision kernel differs from plain")
        check_lists("band" if name == "bench" else t, ctxs, plain, name, dev)
        bound = decision_bound(atoms, kk, vv)
        plain_ms = time_ms(lambda: D._evaluate_batch(*atoms, kk, vv), 3)
        # the two layouts in turns: wrapper call, raw launches, profiler time
        turns = []
        for kernel in DECISION_TURNS:
            device_ms, profiled_ms = decision_device_ms(kernel, atoms, kk, vv)
            turns.append({"ms": time_ms(lambda: kernels.run_decision(*atoms, kk, vv,
                                                                     kernel=kernel), 50),
                          "device_ms": device_ms, "profiled_ms": profiled_ms})
        A.reset_launch_counts()
        kernels.run_decision(*atoms, kk, vv)
        grid = A.launch_counts()["decision"]

        def mean(key, kernel):
            """The mean over a layout's turns that measured it (None: none did)."""
            vals = [r[key] for r, k in zip(turns, DECISION_TURNS)
                    if k == kernel and r[key] is not None]
            return sum(vals) / len(vals) if vals else None

        info[name] = {"ms": mean("ms", "lanes"), "plain_ms": plain_ms,
                      "device_ms": mean("device_ms", "lanes"),
                      "profiled_ms": mean("profiled_ms", "lanes"),
                      "serial_ms": mean("ms", "serial"),
                      "serial_profiled_ms": mean("profiled_ms", "serial"),
                      "grid_launches": grid, **bound}
        N = k.shape[0]
        I, R, K = t.kind.shape
        log(f"phase8 {name} [{card}]: N={N} I={I} R={R} K={K} "
            f"({kernels.decision_lanes_plan(I, R, K)}), m/selected/counts of both layouts "
            f"byte-equal to plain, lists equal under {len(POLICIES)} policies, "
            f"{int(got[2].gt(0).sum())} contexts matched; plain {plain_ms:.4f} ms; bound "
            f"{bound['bound_ms'] * 1e3:.3f} us by {bound['bound_by']} ({bound['bytes']} B, "
            f"{bound['ops']} int32 ops)")
        log(f"phase8 {name} A/B [{card}] turns {list(DECISION_TURNS)}:")
        for key in turns[0]:
            log(f"  {key}: {[None if r[key] is None else round(r[key], 6) for r in turns]}")
    return info


def same_steps(a: list[dict], b: list[dict]) -> bool:
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b))


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
                clean = kb.run_group(dt, config, state, I, T)
                if clean.fail_reason is not None:
                    raise AssertionError("the clean run of a corruption group failed")
                kb.install_device_chaos(controller)
                out = kb.run_group(dt, config, state, I, T, defense=defense)
                kb.install_device_chaos(None)
                if out.fail_reason is None:
                    # quarantined: the host oracle's steps and state, which
                    # must be the clean run's
                    if not same_steps(out.steps, clean.steps) or max_abs_err(
                            out.state, clean.state):
                        raise AssertionError("a quarantined group's oracle result differs "
                                             "from the clean run")
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
            f"flips, all caught ({how.count('shadow')} groups by the shadow, the host oracle's "
            f"result returned in their place, {how.count('contained')} contained as typed "
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


def phase_telemetry(info: dict, dev, card: str) -> dict:
    """Phase 10a: the profiler's device half on the card. After the earlier
    phases CUDA is up, so ``sample_device_memory()`` finds the card by
    itself and sets both children of ``zeebe_device_memory_bytes`` for
    ``gpu:<index>``; one ``DeviceTraceCapture`` (its default
    ``torch.profiler`` session) around a ``run_group`` of a phase 4 group
    writes a Chrome trace that must name the fused chunk kernel."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    label = f"gpu:{index}"
    updated = P.sample_device_memory()
    gauge = P._M_DEVICE_MEMORY
    values = {c.label_values: c.value for c in gauge._children_snapshot()}
    in_use, limit = values.get((label, "in_use")), values.get((label, "limit"))
    if updated < 2 or not in_use or not limit:
        raise AssertionError(f"device memory gauge not set for {label}: {updated} children, "
                             f"{values}")
    with tempfile.TemporaryDirectory() as tmp:
        capture = P.DeviceTraceCapture(tmp)
        arrays, I, T = kb.build_group_arrays(info["tables"], copy_group(info["groups"][0]),
                                             kb.MAX_GROUP)
        trace_dir = capture.start(seconds=120.0)
        try:
            run = kb.run_group(info["dt"], info["tables"].kernel_config,
                               kb.group_state(arrays, dev), I, T)
            torch.cuda.synchronize()
        finally:
            capture.cancel()
        trace_file = trace_dir / "trace.json"
        text = trace_file.read_text() if trace_file.exists() else ""
    if run.steps is None:
        raise AssertionError(f"the traced run_group failed: {run.fail_reason}")
    events = json.loads(text)["traceEvents"] if text else []
    chunks = [e for e in events if e.get("cat") == "kernel" and "k_chunk" in e.get("name", "")]
    if not chunks:
        raise AssertionError(f"the device trace ({len(text)} bytes, {len(events)} events) "
                             "holds no k_chunk kernel")
    log(f"phase10 telemetry [{card}]: zeebe_device_memory_bytes{{device={label}}} in_use "
        f"{in_use:.0f} B, limit {limit:.0f} B ({updated} children); device trace "
        f"{len(text)} bytes around one run_group ({len(run.steps)} steps): {len(events)} "
        f"events, {len(chunks)} kernel events of {chunks[0]['name'][:60]!r}, "
        f"{sum(e.get('dur', 0) for e in chunks):.1f} us on the card")
    return {"in_use": in_use, "limit": limit, "trace_bytes": len(text)}


def harness_log(h) -> list:
    """Every record of a harness's log: position, source position,
    processed flag and bytes."""
    return [(v.position, v.source_position, v.processed, v.record.to_bytes())
            for v in h.stream.new_reader(1)]


def serving_harness(directory) -> EngineHarness:
    """The harness with the partition's kernel backend on the card:
    ``KernelBackend(engine, max_group=2048, chunk_steps=8)``, as
    ``zeebe_tpu/broker/partition.py:406-410`` builds it, in place of the
    harness's test geometry (``max_group=64``, templates audited)."""
    h = EngineHarness(directory)
    backend = kb.KernelBackend(h.engine, max_group=2048, chunk_steps=8)
    backend.max_commands_in_batch = h.processor.max_commands_in_batch
    h.processor.kernel_backend = backend
    h.kernel_backend = backend
    return h


def phase_engine(card: str, n_instances: int = 2000, kernel: bool = False) -> dict:
    """Phase 10b (``kernel=False``): the port's engine stack, sequential, on
    the card's host; phase 11 (``kernel=True``): the same commands through
    the serving write path, the partition's kernel backend on the card.
    ``EngineHarness`` deploys one_task and the 8-definition mixed set,
    ``n_instances`` creations go through its log round robin over the 9
    processes, then every job is activated and completed in waves until
    none is left. Every instance must complete: the ``ELEMENT_COMPLETED``
    records of the process element equal the instances created, and the
    harness finds every instance done. Prints records/s and instances/s
    over the wall from deployment to the last completion, with whether the
    native codec loaded and which ``SortedList`` the durable store has.
    Returns the rates and the log: every record's position, source
    position, processed flag and bytes."""
    from zeebe_tpu_torch import native
    from zeebe_tpu_torch.state import durable

    models = [W.one_task()] + W.mixed_definitions()
    pids = [m.process_id for m in models]
    with tempfile.TemporaryDirectory() as tmp:
        h = serving_harness(tmp) if kernel else EngineHarness(tmp)
        try:
            t0 = time.perf_counter()
            h.deploy(*models)
            for i in range(n_instances):
                h.stream.writer.try_write([LogAppendEntry(command(
                    ValueType.PROCESS_INSTANCE_CREATION, ProcessInstanceCreationIntent.CREATE,
                    {"bpmnProcessId": pids[i % len(pids)], "version": -1,
                     "variables": {"x": i % 30}}))])
            h.pump()
            job_types = sorted({r.record.value["type"] for r in
                                h.exporter.job_records().with_intent(JobIntent.CREATED)})
            waves = completed_jobs = 0
            while True:
                jobs = [j for jt in job_types for j in h.activate_jobs(jt, max_jobs=1000)]
                if not jobs:
                    break
                waves += 1
                for job in jobs:
                    h.stream.writer.try_write([LogAppendEntry(command(
                        ValueType.JOB, JobIntent.COMPLETE, {"variables": {}}, key=job["key"]))])
                h.pump()
                completed_jobs += len(jobs)
                if waves > 64:
                    raise AssertionError("the job waves did not drain")
            if kernel:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            created = [r.record.value["processInstanceKey"] for r in
                       h.exporter.all().with_value_type(ValueType.PROCESS_INSTANCE_CREATION)
                       .with_intent(ProcessInstanceCreationIntent.CREATED)]
            done = (h.exporter.process_instance_records()
                    .with_intent(ProcessInstanceIntent.ELEMENT_COMPLETED)
                    .with_value(bpmnElementType="PROCESS").count())
            records = h.stream.last_position
            if len(created) != n_instances or done != n_instances:
                raise AssertionError(f"engine: {len(created)} created, {done} completed of "
                                     f"{n_instances}")
            if not all(h.is_instance_done(k) for k in created):
                raise AssertionError("engine: an instance is still live after the waves")
            log_records = harness_log(h)
        finally:
            h.close()
    codec = native.load_codec() is not None
    label = ("phase11 serving write path" if kernel
             else "phase10 engine stack")
    log(f"{label} [{card}]: {'partition KernelBackend on the card' if kernel else 'sequential EngineHarness'}, "
        f"one_task + mixed set, "
        f"{n_instances} instances ({done} completed), {completed_jobs} jobs in {waves} waves, "
        f"{records} records in {wall:.3f} s: {records / wall:.1f} records/s, "
        f"{n_instances / wall:.1f} instances/s; native codec "
        f"{'loaded' if codec else 'not loaded'}, SortedList from {durable.SortedList.__module__}")
    return {"records_per_s": records / wall, "instances_per_s": n_instances / wall,
            "records": records, "native": codec, "log": log_records,
            "backend": h.kernel_backend}


#: the fallback reasons of a clean serving run: the sequential heads (the
#: deployment, each wave's job activation); anything else is a declined group
SEQUENTIAL_HEADS = "head-sequential:"


def compile_seconds() -> dict:
    """The compile seam's observations: bucket → (first dispatches, seconds)."""
    hist = P._M_COMPILE_SECONDS
    return {c.label_values[0]: (c.count, c.sum) for c in hist._children_snapshot()}


def phase_serving(card: str, sequential: dict, n_instances: int = 2000) -> dict:
    """Phase 11: the serving write path on the card. Phase 10's commands go
    through the port's StreamProcessor with the partition's KernelBackend
    on the card (admission, the group on ``k_chunk``, materialization),
    from the same clock start. The record log must be byte-identical to
    phase 10's sequential log, every instance complete, every one of the
    nine definitions 100% on the kernel path, no group declined for any
    reason, nothing shadow-quarantined, and ``k_chunk`` launched (counts
    zeroed right before the run, read right after). The backend takes the
    process-wide router, whose link is measured once per process (a child
    process) before the timed run, as phase 2 loads the kernel library."""
    reset_shared_device_health()
    kb.install_device_chaos(None)
    router = shared_router()
    router.accel_device()
    routed = (router.host_groups, router.accel_groups)
    before = compile_seconds()
    A.reset_launch_counts()
    got = phase_engine(card, n_instances, kernel=True)
    launches = A.launch_counts()
    grid = A.grid_launch_counts()
    backend = got["backend"]
    if got["log"] != sequential["log"]:
        diverged = next((i for i, (a, b) in enumerate(zip(got["log"], sequential["log"]))
                         if a != b), min(len(got["log"]), len(sequential["log"])))
        raise AssertionError(f"phase11: the log differs from phase 10's at record {diverged} "
                             f"({len(got['log'])} against {len(sequential['log'])} records)")
    acct = backend.accounting
    pids = [m.process_id for m in [W.one_task()] + W.mixed_definitions()]
    coverage = {pid: acct.per_definition.get(pid, [0, 0])[:2] for pid in pids}
    if any(kernel == 0 or host for kernel, host in coverage.values()):
        raise AssertionError(f"phase11: kernel coverage not 100%: {coverage}")
    declined = {r: n for r, n in acct.reasons.items() if not r.startswith(SEQUENTIAL_HEADS)}
    if declined or backend.shadow_quarantined:
        raise AssertionError(f"phase11: groups declined {declined}, "
                             f"{backend.shadow_quarantined} shadow-quarantined")
    if launches["run_collect"] <= 0 or grid["fused"] != launches["run_collect"]:
        raise AssertionError(f"phase11: k_chunk launches {launches['run_collect']}, grid {grid}")
    host, accel = router.host_groups - routed[0], router.accel_groups - routed[1]
    if host != 0 or accel != backend.groups_processed:
        raise AssertionError(f"phase11: router host_groups {host}, accel_groups {accel} "
                             f"against {backend.groups_processed} groups; {router.stats()}")
    compiles = {b: (n - before.get(b, (0, 0.0))[0], s - before.get(b, (0, 0.0))[1])
                for b, (n, s) in compile_seconds().items() if n > before.get(b, (0, 0.0))[0]}
    health = backend.health
    log(f"phase11 serving write path [{card}]: log byte-identical to phase 10's "
        f"({got['records']} records); {got['records_per_s']:.1f} records/s, "
        f"{got['instances_per_s']:.1f} instances/s against the sequential "
        f"{sequential['records_per_s']:.1f} and {sequential['instances_per_s']:.1f}; "
        f"{backend.groups_processed} groups, {backend.commands_processed} commands on the "
        f"kernel, coverage {acct.coverage_ratio() * 100:.1f}% of routed commands (every one "
        f"of the 9 definitions 100%), template hits {backend.template_hits}, misses "
        f"{backend.template_misses}; k_chunk launches {launches['run_collect']} "
        f"({launches['step']} lock-steps); shadow checks {health.shadow_checks}, "
        f"0 mismatches; first dispatch per bucket (compile seam) "
        f"{ {b: s for b, (n, s) in compiles.items()} } s; sequential heads "
        f"{dict(acct.reasons)}; router groups this phase: host {host}, card {accel}")
    return {"records_per_s": got["records_per_s"], "instances_per_s": got["instances_per_s"],
            "launches": launches["run_collect"], "groups": backend.groups_processed,
            "commands": backend.commands_processed, "compiles": compiles}


# ---------------------------------------------------------------------------
# phases 12-13: the replicated broker cluster

#: the reference's default cluster (``zeebe_tpu/broker/broker.py:996-997``)
#: and the layout of Zeebe's published benchmark setup (camunda/zeebe
#: ``benchmarks/setup/default/zeebe-values.yaml``): 3 brokers, 3 partitions,
#: replication factor 3
CLUSTER_SHAPE = {"broker_count": 3, "partition_count": 3, "replication_factor": 3}
PARTITIONS = CLUSTER_SHAPE["partition_count"]


def serving_models() -> list:
    """Phase 10's definitions: one_task and the 8-definition mixed set."""
    return [W.one_task()] + W.mixed_definitions()


def deploy_command(models):
    return command(ValueType.DEPLOYMENT, DeploymentIntent.CREATE, {"resources": [
        {"resourceName": f"{m.process_id}.bpmn", "resource": to_bpmn_xml(m)} for m in models]})


def create_command(process_id: str, x: int):
    return command(ValueType.PROCESS_INSTANCE_CREATION, ProcessInstanceCreationIntent.CREATE,
                   {"bpmnProcessId": process_id, "version": -1, "variables": {"x": x}})


def activate_command(job_type: str, max_jobs: int = 1000):
    return command(ValueType.JOB_BATCH, JobBatchIntent.ACTIVATE,
                   {"type": job_type, "worker": "smoke", "timeout": 300_000,
                    "maxJobsToActivate": max_jobs})


def job_types(models) -> list[str]:
    return sorted({el.job_type.evaluate({}, lambda: 0)
                   for m in models for el in transform(m).elements[1:]
                   if el.job_type is not None})


def cluster_write(cluster, commands) -> int:
    """Write (partition id, record) pairs in order through each leader's
    client ingress (the gateway's path: backpressure-gated); while the
    limiter refuses or a partition has no leader, run the cluster 50 ms.
    Returns the refusals."""
    refused = 0
    for pid, record in commands:
        for _ in range(2000):
            broker = cluster.leader_broker(pid)
            try:
                if broker is not None and broker.write_command(pid, record) is not None:
                    break
            except BackpressureExceeded:
                refused += 1
            cluster.run(50)
        else:
            raise AssertionError(f"partition {pid} refused a command for 100 s")
    return refused


def settle(cluster, step: int = 50, quiet: int = 2) -> None:
    """Run the cluster until every partition leader has committed and
    materialized all it appended, and no leader's log grows and no
    processor advances for ``quiet`` steps of ``step`` ms in a row."""
    last, still = None, 0
    for _ in range(100_000):
        cluster.run(step)
        leaders = [cluster.leader(pid) for pid in range(1, PARTITIONS + 1)]
        now = tuple(None if p is None else (p.stream.last_position,
                                            p.processor.last_processed_position,
                                            p._next_position)
                    for p in leaders)
        caught_up = None not in now and all(s + 1 == n for s, _, n in now)
        still = still + 1 if now == last and caught_up else 0
        if still >= quiet:
            return
        last = now
    raise AssertionError("the cluster did not settle")


def process_records(partition, cursor: int = 0):
    """(position, record) of a replica's stream after ``cursor``."""
    for logged in partition.stream.new_reader(cursor + 1):
        yield logged.position, logged.record


def drive_cluster(cluster, models, n_instances: int) -> dict:
    """Phase 10's traffic on a cluster: the definitions deployed on partition
    1 (distributed to the others), ``n_instances`` creations round robin
    over the partitions and the processes (x = i mod 30), then job waves:
    on every partition one activation of up to 1,000 jobs per type, every
    activated job completed, until a wave activates none."""
    pids = [m.process_id for m in models]
    refused = cluster_write(cluster, [(1, deploy_command(models))])
    settle(cluster)
    refused += cluster_write(cluster, [(i % PARTITIONS + 1, create_command(pids[i % len(pids)],
                                                                           i % 30))
                                       for i in range(n_instances)])
    settle(cluster)
    types = job_types(models)
    cursors = {pid: 0 for pid in range(1, PARTITIONS + 1)}
    waves = jobs_done = 0
    while True:
        refused += cluster_write(cluster, [(pid, activate_command(t))
                                           for pid in range(1, PARTITIONS + 1) for t in types])
        settle(cluster)
        completions = []
        for pid in range(1, PARTITIONS + 1):
            for position, rec in process_records(cluster.leader(pid), cursors[pid]):
                cursors[pid] = position
                if (rec.value_type == ValueType.JOB_BATCH
                        and rec.intent == JobBatchIntent.ACTIVATED):
                    completions += [(pid, command(ValueType.JOB, JobIntent.COMPLETE,
                                                  {"variables": {}}, key=key))
                                    for key in rec.value["jobKeys"]]
        if not completions:
            break
        waves += 1
        refused += cluster_write(cluster, completions)
        settle(cluster)
        jobs_done += len(completions)
        if waves > 64:
            raise AssertionError("the cluster's job waves did not drain")
    return {"waves": waves, "jobs": jobs_done, "refused": refused}


def partition_outcome(partition) -> dict:
    """A replica's log (position, source position, processed flag, record
    bytes) and its instances created and completed."""
    log_records, created, completed = [], 0, 0
    for logged in partition.stream.new_reader(1):
        rec = logged.record
        log_records.append((logged.position, logged.source_position, logged.processed,
                            rec.to_bytes()))
        if (rec.value_type == ValueType.PROCESS_INSTANCE_CREATION
                and rec.intent == ProcessInstanceCreationIntent.CREATED):
            created += 1
        elif (rec.value_type == ValueType.PROCESS_INSTANCE
              and rec.intent == ProcessInstanceIntent.ELEMENT_COMPLETED
              and rec.value.get("bpmnElementType") == "PROCESS"):
            completed += 1
    return {"log": log_records, "created": created, "completed": completed}


def run_cluster(n_instances: int, kernel: bool, device, mesh_shards: int = 0) -> dict:
    """One run of phase 12's traffic on ``InProcessCluster`` (3 brokers, 3
    partitions, replication factor 3, controlled clock, loopback network):
    the wall from deployment to the last completion, every replica's
    outcome and the leaders' kernel backends. ``mesh_shards`` > 0 injects
    one mesh runner of that many shards into every broker (the broker's
    ``mesh_runner``, as ``ClusterRuntime`` injects its own). The brokers
    run without their control plane: its journal-flush loop follows the
    wall clock's fsync latency and then defers Raft's commits by
    wall-clock milliseconds, so with it the same traffic commits at other
    ticks of the controlled clock from run to run, and the client's later
    commands carry other timestamps."""
    from contextlib import nullcontext
    from unittest import mock

    models = serving_models()
    runner = MR.MeshKernelRunner(n_shards=mesh_shards, device=device) if mesh_shards else None
    injected = (mock.patch.object(Broker, "_mesh_runner", lambda broker: runner)
                if runner is not None else nullcontext())
    with tempfile.TemporaryDirectory() as tmp:
        with injected, mock.patch.dict(os.environ, {"ZEEBE_CONTROL_ENABLED": "false"}):
            cluster = InProcessCluster(**CLUSTER_SHAPE, directory=tmp, kernel_backend=kernel,
                                       device=device)
        try:
            cluster.await_leaders()
            t0 = time.perf_counter()
            traffic = drive_cluster(cluster, models, n_instances)
            if kernel and torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            cluster.run(1_000)  # the followers learn the last commit
            replicas = {pid: {node: partition_outcome(b.partitions[pid])
                              for node, b in sorted(cluster.brokers.items())}
                        for pid in range(1, PARTITIONS + 1)}
            leaders = {pid: cluster.leader_broker(pid).cfg.node_id
                       for pid in range(1, PARTITIONS + 1)}
            backends = {pid: cluster.leader(pid).processor.kernel_backend
                        for pid in range(1, PARTITIONS + 1)}
        finally:
            cluster.close()
    return {"wall": wall, "traffic": traffic, "replicas": replicas, "leaders": leaders,
            "backends": backends, "mesh": runner}


def log_entry(log: list, i: int) -> str:
    """Entry ``i`` of a replica's log (``partition_outcome``) as text: its
    position, source position, processed flag and record."""
    if i >= len(log):
        return "none"
    position, source, processed, raw = log[i]
    return (f"position {position} source {source} processed {processed} "
            f"{json.dumps(Record.from_bytes(raw).to_json_dict(), default=str)[:1500]}")


def backend_summary(run: dict) -> dict:
    """Per partition of one cluster run: its leader's backend's groups,
    declines by reason, shadow checks and quarantines."""
    return {pid: {"groups": b.groups_processed, "reasons": dict(b.accounting.reasons),
                  "shadow": b.health.shadow_checks,
                  "quarantined": b.shadow_quarantined}
            for pid, b in run["backends"].items() if b is not None}


def kernel_outcome(run: dict, label: str) -> dict:
    """The leaders' backends of one kernel run: every definition 100% on
    the kernel path, no group declined and nothing shadow-quarantined
    (raises otherwise); their groups and commands."""
    backends = list(run["backends"].values())
    coverage: dict[str, list] = {}
    declined: dict[str, int] = {}
    for backend in backends:
        for definition, slot in backend.accounting.per_definition.items():
            agg = coverage.setdefault(definition, [0, 0])
            agg[0] += slot[0]
            agg[1] += slot[1]
        for reason, n in backend.accounting.reasons.items():
            if not reason.startswith(SEQUENTIAL_HEADS):
                declined[reason] = declined.get(reason, 0) + n
    pids = [m.process_id for m in serving_models()]
    if any(coverage.get(p, [0, 1])[0] == 0 or coverage.get(p, [0, 1])[1] for p in pids):
        raise AssertionError(f"phase12: kernel coverage not 100% ({label}): {coverage}")
    quarantined = sum(b.shadow_quarantined for b in backends)
    if declined or quarantined:
        raise AssertionError(f"phase12: groups declined {declined}, {quarantined} quarantined "
                             f"({label})")
    return {"groups": sum(b.groups_processed for b in backends),
            "commands": sum(b.commands_processed for b in backends),
            "health": backends[0].health}


def phase_cluster(card: str, n_instances: int = 3000, device="cuda") -> dict:
    """Phase 12: the replicated cluster on the card, deterministic. The same
    traffic runs on a sequential cluster (``kernel_backend=False``), on
    the kernel cluster, whose leaders' ``KernelBackend(max_group=2048,
    chunk_steps=8)`` run on ``device``, and on the kernel cluster with one
    3-shard mesh runner injected into every broker. Fails unless every
    instance completes, each partition's log is byte-identical on its three
    replicas and, in both kernel clusters, to the sequential cluster's,
    every definition is 100% on the kernel path with no group declined or
    quarantined, the router sent no group to the host and counted every
    group of the kernel cluster on the card, and the mesh cluster's groups
    ran on ``sharded_collect``."""
    router = shared_router()
    runs = {}
    for label, kernel, shards in (("sequential", False, 0), ("kernel", True, 0),
                                  ("mesh", True, PARTITIONS)):
        reset_shared_device_health()
        kb.install_device_chaos(None)
        before = (router.host_groups, router.accel_groups)
        A.reset_launch_counts()
        runs[label] = run_cluster(n_instances, kernel, device, shards)
        runs[label]["launches"] = A.launch_counts()
        runs[label]["router"] = (router.host_groups - before[0],
                                 router.accel_groups - before[1])
    seq, got, mesh = runs["sequential"], runs["kernel"], runs["mesh"]
    for pid in range(1, PARTITIONS + 1):
        for label, run in runs.items():
            replicas = list(run["replicas"][pid].values())
            if any(r["log"] != replicas[0]["log"] for r in replicas[1:]):
                raise AssertionError(f"phase12: partition {pid}'s replicas differ ({label})")
        la = next(iter(seq["replicas"][pid].values()))["log"]
        for label in ("kernel", "mesh"):
            lb = next(iter(runs[label]["replicas"][pid].values()))["log"]
            if la != lb:
                diverged = next((i for i, (x, y) in enumerate(zip(la, lb)) if x != y),
                                min(len(la), len(lb)))
                raise AssertionError(f"phase12: partition {pid}'s log differs from the "
                                     f"sequential cluster's at record {diverged} ({label}: "
                                     f"{len(lb)} against {len(la)}); {label}: "
                                     f"{log_entry(lb, diverged)}; sequential: "
                                     f"{log_entry(la, diverged)}; {label} backends: "
                                     f"{backend_summary(runs[label])}")
    created = sum(next(iter(got["replicas"][p].values()))["created"]
                  for p in range(1, PARTITIONS + 1))
    completed = sum(next(iter(got["replicas"][p].values()))["completed"]
                    for p in range(1, PARTITIONS + 1))
    if created != n_instances or completed != n_instances:
        raise AssertionError(f"phase12: {created} created, {completed} completed of "
                             f"{n_instances}")
    single = kernel_outcome(got, "kernel")
    sharded = kernel_outcome(mesh, "mesh")
    groups, commands, health = single["groups"], single["commands"], single["health"]
    host, accel = got["router"]
    if host != 0 or accel != groups:
        raise AssertionError(f"phase12: router host_groups {host}, accel_groups {accel} "
                             f"against {groups} groups; {router.stats()}")
    runner = mesh["mesh"]
    mesh_launches = mesh["launches"]["sharded_collect"]
    if mesh_launches <= 0 or mesh["launches"]["run_collect"] or mesh["router"] != (0, 0):
        raise AssertionError(f"phase12: mesh cluster launches {mesh['launches']}, router "
                             f"{mesh['router']}")

    def rates(run) -> str:
        per = {}
        for pid in range(1, PARTITIONS + 1):
            records = len(next(iter(run["replicas"][pid].values()))["log"])
            per[pid] = records / run["wall"]
        total = sum(len(next(iter(run["replicas"][p].values()))["log"])
                    for p in range(1, PARTITIONS + 1))
        return (f"{total / run['wall']:.1f} records/s, {n_instances / run['wall']:.1f} "
                f"instances/s (per partition records/s "
                f"{ {p: round(r, 1) for p, r in per.items()} })")

    records = sum(len(next(iter(got["replicas"][p].values()))["log"])
                  for p in range(1, PARTITIONS + 1))
    log(f"phase12 replicated cluster [{card}]: InProcessCluster 3 brokers x 3 partitions x "
        f"replication 3 on {device}, one_task + mixed set, {n_instances} instances "
        f"({completed} completed), {got['traffic']['jobs']} jobs in "
        f"{got['traffic']['waves']} waves, {records} records per replica set; logs identical "
        f"on the 3 replicas and to the sequential cluster's; kernel cluster {rates(got)} in "
        f"{got['wall']:.3f} s against the sequential cluster's {rates(seq)} in "
        f"{seq['wall']:.3f} s ({seq['wall'] / got['wall']:.2f}x); leaders {got['leaders']}; "
        f"{groups} groups, {commands} commands on the kernel "
        f"({commands / max(groups, 1):.1f} a group), every definition 100% on the kernel; "
        f"k_chunk launches {got['launches']['run_collect']} "
        f"({got['launches']['step']} lock-steps); client refusals by backpressure "
        f"{got['traffic']['refused']} (sequential {seq['traffic']['refused']}); router "
        f"{router.stats()} (link put {router.link_put_s} s, get {router.link_get_s} s; this "
        f"phase host {host}, card {accel}); shadow checks {health.shadow_checks}, "
        f"mismatches {health.shadow_mismatches}")
    log(f"phase12 mesh cluster [{card}]: the same schedule with one 3-shard mesh runner in "
        f"every broker: logs identical on the 3 replicas and to the sequential cluster's; "
        f"{rates(mesh)} in {mesh['wall']:.3f} s ({seq['wall'] / mesh['wall']:.2f}x the "
        f"sequential cluster); {sharded['groups']} groups, {sharded['commands']} commands on "
        f"the kernel, every definition 100% on the kernel; mesh runner {runner.dispatches} "
        f"dispatches of {runner.groups_dispatched} groups, {runner.coalesced_dispatches} "
        f"coalesced; sharded_collect launches {mesh_launches}, run_collect 0; router this "
        f"run host 0, card 0 (mesh groups bypass it)")
    return {"records_per_s": records / got["wall"], "instances_per_s": n_instances / got["wall"],
            "seq_records_per_s": records / seq["wall"], "launches": got["launches"]["run_collect"],
            "mesh_launches": mesh_launches, "groups": groups, "commands": commands}


def runtime_deployed(runtime, models) -> bool:
    """Whether every partition leader has every process deployed (read
    under each partition's ownership lock)."""
    for pid in range(1, PARTITIONS + 1):
        with runtime._plocks[pid]:
            leader = runtime._leader_partition(pid)
            if leader is None or leader.db is None:
                return False
            with leader.db.transaction():
                if any(leader.engine.state.processes.latest_version(m.process_id) is None
                       for m in models):
                    return False
    return True


def runtime_outcome(runtime) -> dict:
    """Per partition leader: instances created and completed in its log."""
    out = {}
    for pid in range(1, PARTITIONS + 1):
        with runtime._plocks[pid]:
            leader = runtime._leader_partition(pid)
            got = partition_outcome(leader)
        out[pid] = (got["created"], got["completed"])
    return out


def percentile(values: list[float], q: float) -> float:
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


#: phase 13's mesh batch window, phase 7's
MESH_WINDOW_S = 0.002


def phase_runtime(card: str, n_requests: int = 600, device="cuda", clients: int = 8) -> dict:
    """Phase 13: the gateway's runtime answers requests. ``ClusterRuntime``
    (3 brokers, 3 partitions, replication factor 3) with one mesh runner of
    3 shards on ``device`` and a 2 ms batch window, its partition threads
    started; through ``submit``: the deployment, ``n_requests`` creations
    (one a partition and process one at a time, which gives the partitions'
    kernel registries equal table sets, then the rest from ``clients``
    client threads; each request awaited), then per wave one activation per
    partition and job type and every job's completion, until every instance
    completes. Fails on a timed-out or rejected request, an instance not
    completed, or no ``sharded_collect`` launch. Reports request latency,
    the mesh runner's dispatches and the card's busy share of the phase
    (``torch.profiler``, CUDA activity)."""
    from concurrent.futures import ThreadPoolExecutor

    from torch.profiler import ProfilerActivity, profile

    models = serving_models()
    pids = [m.process_id for m in models]
    on_card = torch.device(device).type == "cuda"
    router = shared_router()
    before = (router.host_groups, router.accel_groups)
    reset_shared_device_health()
    kb.install_device_chaos(None)
    A.reset_launch_counts()
    runtime = ClusterRuntime(**CLUSTER_SHAPE, kernel_mesh_shards=PARTITIONS, device=device)
    # the dispatch leader waits 2 ms for the other partitions' groups, as
    # phase 7's runner does, so that they coalesce into one dispatch
    runtime.mesh_runner.batch_window_s = MESH_WINDOW_S
    latencies: dict[str, list[float]] = {"warm": [], "create": [], "activate": [],
                                         "complete": []}

    def submit(kind: str, pid: int, record):
        t0 = time.perf_counter()
        response = runtime.submit(pid, record, timeout_s=30.0)
        latencies[kind].append(time.perf_counter() - t0)
        if response.is_rejection:
            raise AssertionError(f"phase13: {kind} rejected: {response.rejection_type.name} "
                                 f"{response.value}")
        return response

    try:
        runtime.start()
        submit("create", 1, deploy_command(models))
        latencies["create"].clear()
        deadline = time.monotonic() + 60.0
        while not runtime_deployed(runtime, models):
            if time.monotonic() > deadline:
                raise AssertionError("phase13: the deployment did not reach every partition")
            time.sleep(0.01)
        activity = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
        with profile(activities=activity) as prof, ThreadPoolExecutor(clients) as pool:
            t0 = time.perf_counter()
            # first one creation a partition and process, one at a time:
            # each partition's kernel registry grows as its definitions are
            # first touched, so touching all nine in one order gives the
            # partitions equal table sets, whose groups may share a dispatch
            warm = [(pid, process) for pid in range(1, PARTITIONS + 1) for process in pids]
            for i, (pid, process) in enumerate(warm):
                submit("warm", pid, create_command(process, i % 30))
            for f in [pool.submit(submit, "create", i % PARTITIONS + 1,
                                  create_command(pids[i % len(pids)], i % 30))
                      for i in range(len(warm), n_requests)]:
                f.result()
            waves = 0
            while True:
                jobs = []
                for pid in range(1, PARTITIONS + 1):
                    for t in job_types(models):
                        batch = submit("activate", pid, activate_command(t))
                        jobs += [(pid, key) for key in batch.value["jobKeys"]]
                if not jobs:
                    break
                waves += 1
                for f in [pool.submit(submit, "complete", pid, command(
                        ValueType.JOB, JobIntent.COMPLETE, {"variables": {}}, key=key))
                          for pid, key in jobs]:
                    f.result()
                if waves > 64:
                    raise AssertionError("phase13: the job waves did not drain")
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        outcome = runtime_outcome(runtime)
        mesh = runtime.mesh_runner
        stats = (mesh.dispatches, mesh.groups_dispatched, mesh.coalesced_dispatches)
    finally:
        runtime.stop()
    launches = A.launch_counts()
    created = sum(c for c, _ in outcome.values())
    completed = sum(d for _, d in outcome.values())
    if created != n_requests or completed != n_requests:
        raise AssertionError(f"phase13: {created} created, {completed} completed of "
                             f"{n_requests} ({outcome})")
    busy_ms = None
    if on_card:
        busy_ms = sum(e.device_time_total for e in prof.key_averages()
                      if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                      ) / 1e3
    busy = None if not busy_ms else busy_ms / (wall * 1e3)
    lat = {k: (1e3 * percentile(v, 0.5), 1e3 * percentile(v, 0.99)) for k, v in latencies.items()
           if v}
    log(f"phase13 gateway runtime [{card}]: ClusterRuntime 3 brokers x 3 partitions x "
        f"replication 3, one 3-shard mesh runner on {device}; {n_requests} creations, "
        f"{len(latencies['warm'])} of them one at a time (one a partition and process), the "
        f"rest from {clients} client threads, every one answered ({completed} instances completed, "
        f"{sum(len(v) for k, v in latencies.items() if k == 'complete')} jobs in {waves} "
        f"waves) in {wall:.3f} s; request latency ms p50/p99 "
        f"{ {k: (round(a, 3), round(b, 3)) for k, (a, b) in lat.items()} }; mesh runner "
        f"({MESH_WINDOW_S * 1e3} ms window) {stats[0]} dispatches of {stats[1]} groups, "
        f"{stats[2]} coalesced ({pct(stats[2] / max(stats[0], 1))} of dispatches, "
        f"{stats[1] / max(stats[0], 1):.3f} groups a dispatch); sharded_collect "
        f"launches {launches['sharded_collect']}, run_collect {launches['run_collect']}; "
        f"router this phase host {router.host_groups - before[0]}, card "
        f"{router.accel_groups - before[1]} (mesh groups bypass it); card busy "
        f"{pct(busy)} of the phase ({busy_ms} ms of kernels and copies, torch.profiler)")
    return {"launches": launches["sharded_collect"], "latency": lat, "mesh": stats,
            "busy": busy, "wall": wall}


def grpc_outcome(runtime) -> dict:
    """Per the leaders' logs: the keys of the instances created, of those
    completed and of those terminated, and of the jobs completed."""
    out = {"created": set(), "completed": set(), "terminated": set(), "jobs": set()}
    for pid in range(1, PARTITIONS + 1):
        with runtime._plocks[pid]:
            leader = runtime._leader_partition(pid)
            for _, rec in process_records(leader):
                if (rec.value_type == ValueType.PROCESS_INSTANCE_CREATION
                        and rec.intent == ProcessInstanceCreationIntent.CREATED):
                    out["created"].add(rec.value["processInstanceKey"])
                elif (rec.value_type == ValueType.PROCESS_INSTANCE
                      and rec.value.get("bpmnElementType") == "PROCESS"
                      and rec.intent in (ProcessInstanceIntent.ELEMENT_COMPLETED,
                                         ProcessInstanceIntent.ELEMENT_TERMINATED)):
                    done = rec.intent == ProcessInstanceIntent.ELEMENT_COMPLETED
                    out["completed" if done else "terminated"].add(rec.key)
                elif rec.value_type == ValueType.JOB and rec.intent == JobIntent.COMPLETED:
                    out["jobs"].add(rec.key)
    return out


def gateway_latency() -> tuple[tuple, dict]:
    """The gateway's own ``gateway_request_latency``: its bucket edges and
    per RPC (count, sum in seconds, bucket counts)."""
    from zeebe_tpu_torch.utils.metrics import REGISTRY

    histogram = REGISTRY._metrics.get("zeebe_gateway_request_latency")
    if histogram is None:
        return (), {}
    return histogram.buckets, {c.label_values[0]: (c.count, c.sum, list(c.bucket_counts))
                               for c in histogram._children_snapshot()}


def phase_grpc(card: str, runtime_phase: dict, n_requests: int = 600, clients: int = 8,
               device=None) -> dict:
    """Phase 14: the gRPC front on the card. The port's ``Gateway`` on
    127.0.0.1:0 over phase 13's ``ClusterRuntime`` shape built with no
    device (the card) and the same 2 ms batch window, driven by the port's
    ``ZeebeTpuClient``: phase 10's nine definitions and the DMN "band"
    through ``DeployResource``; ``n_requests`` creations through
    ``CreateProcessInstance`` (27 one at a time, each process once on each
    partition, then the rest from ``clients`` client threads); one more
    instance created and cancelled; then one ``JobWorker`` a job type over
    ``StreamActivatedJobs`` completes jobs until every instance completes;
    then one call each of ``Topology``, ``CreateProcessInstanceWithResult``,
    ``EvaluateDecision`` and ``PublishMessage``. Fails on a non-OK status
    (the client raises), a worker's failed job, an instance not completed,
    instances or jobs the client saw that differ from the leaders' logs, a
    group the router sent to the host, or no ``sharded_collect`` launch.
    Prints create latency beside phase 13's ``submit`` latency, the
    gateway's ``gateway_request_latency`` per RPC, the mesh runner's
    dispatches and coalesced share, the job push's peeks that waited a
    second for a busy partition, the router's counts and the card's busy
    share of the phase (``torch.profiler``). ``device`` is given to
    the runtime only where it is not None (a rehearsal on the CPU)."""
    from concurrent.futures import ThreadPoolExecutor

    import google.protobuf
    import grpc
    from torch.profiler import ProfilerActivity, profile

    from zeebe_tpu_torch.client import JobWorker, ZeebeTpuClient
    from zeebe_tpu_torch.gateway import Gateway
    from zeebe_tpu_torch.gateway.proto import gateway_pb2 as pb
    from zeebe_tpu_torch.utils.metrics import estimate_quantile

    models = serving_models()
    pids = [m.process_id for m in models]
    router = shared_router()
    before = (router.host_groups, router.accel_groups)
    _, latency_before = gateway_latency()
    reset_shared_device_health()
    kb.install_device_chaos(None)
    A.reset_launch_counts()
    on_card = device is None
    runtime = ClusterRuntime(**CLUSTER_SHAPE, kernel_mesh_shards=PARTITIONS,
                             **({} if on_card else {"device": device}))
    runtime.mesh_runner.batch_window_s = MESH_WINDOW_S
    # the job push's peeks that waited out the partition lock's second (a
    # busy partition; the peek then answers that there may be jobs)
    busy_peeks = [0]
    peek = runtime.has_activatable_jobs

    def timed_peek(*args, **kwargs):
        t = time.perf_counter()
        try:
            return peek(*args, **kwargs)
        finally:
            busy_peeks[0] += time.perf_counter() - t >= 1.0

    runtime.has_activatable_jobs = timed_peek
    gateway = Gateway(runtime)
    client = None
    workers: list = []
    seen_jobs: set = set()
    seen_lock = threading.Lock()
    latencies: dict[str, list[float]] = {"warm": [], "create": []}

    def create(kind: str, process: str, x: int) -> int:
        t0 = time.perf_counter()
        key = client.create_instance(process, variables={"x": x}).process_instance_key
        latencies[kind].append(time.perf_counter() - t0)
        return key

    def handle(job) -> dict:
        with seen_lock:
            seen_jobs.add(job.key)
        return {}

    try:
        runtime.start()
        gateway.start()
        client = ZeebeTpuClient(gateway.address, credentials_provider=False)
        deployed = client.deploy_resource(
            *[(f"{m.process_id}.bpmn", to_bpmn_xml(m)) for m in models],
            ("band.dmn", W.dmn_band_xml()))
        if (sorted(p["bpmnProcessId"] for p in deployed["processes"]) != sorted(pids)
                or [d["decisionId"] for d in deployed["decisions"]] != ["band"]):
            raise AssertionError(f"phase14: the deployment answered {deployed}")
        deadline = time.monotonic() + 60.0
        while not runtime_deployed(runtime, models):
            if time.monotonic() > deadline:
                raise AssertionError("phase14: the deployment did not reach every partition")
            time.sleep(0.01)
        activity = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
        with profile(activities=activity) as prof, ThreadPoolExecutor(clients) as pool:
            t0 = time.perf_counter()
            # CreateProcessInstance picks partitions round robin: each
            # process three times in a row lands once on each partition, so
            # every partition first touches the nine in one order (equal
            # table sets, which may share a dispatch; phase 13)
            warm = [process for process in pids for _ in range(PARTITIONS)]
            keys = [create("warm", process, i % 30) for i, process in enumerate(warm)]
            keys += [f.result() for f in [
                pool.submit(create, "create", pids[i % len(pids)], i % 30)
                for i in range(len(warm), n_requests)]]
            cancelled = client.create_instance(pids[0]).process_instance_key
            client.cancel_instance(cancelled)
            created_s = time.perf_counter() - t0
            workers = [JobWorker(client, t, handle, worker_name="smoke",
                                 stream_enabled=True).start() for t in job_types(models)]
            deadline = time.monotonic() + 120.0
            while len(done := grpc_outcome(runtime)["completed"]) < n_requests:
                if time.monotonic() > deadline:
                    waiting = {(pid, t) for pid in range(1, PARTITIONS + 1)
                               for t in job_types(models)
                               if runtime.has_activatable_jobs(pid, t)}
                    raise AssertionError(
                        f"phase14: the workers completed {len(done)} of {n_requests} "
                        f"instances in 120 s ({sum(w.handled_count for w in workers)} jobs "
                        f"handled); (partition, job type) with activatable jobs {waiting}")
                time.sleep(0.05)
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        topology = client.topology()
        if (topology.cluster_size, topology.partitions_count) != (3, PARTITIONS) or sorted(
                pid for b in topology.brokers for pid, role in b["partitions"].items()
                if role == "LEADER") != list(range(1, PARTITIONS + 1)):
            raise AssertionError(f"phase14: topology {topology}")
        result = client.create_instance_with_result(pids[0], variables={"x": 7}, timeout_s=30)
        keys.append(result.process_instance_key)
        evaluate = client.channel.unary_unary(
            "/gateway_protocol.Gateway/EvaluateDecision",
            request_serializer=pb.EvaluateDecisionRequest.SerializeToString,
            response_deserializer=pb.EvaluateDecisionResponse.FromString)
        decision = evaluate(pb.EvaluateDecisionRequest(
            decisionId="band", variables=json.dumps({"amount": 35, "tier": "gold"})))
        if json.loads(decision.decisionOutput) != 3:
            raise AssertionError(f"phase14: band(35, gold) = {decision.decisionOutput}")
        if client.publish_message("smoke", "k-1", variables={"x": 1}) <= 0:
            raise AssertionError("phase14: PublishMessage returned no key")
        for w in workers:
            w.stop()
        failed = sum(w.failed_count for w in workers)
        handled = sum(w.handled_count for w in workers)
        outcome = grpc_outcome(runtime)
        mesh = runtime.mesh_runner
        stats = (mesh.dispatches, mesh.groups_dispatched, mesh.coalesced_dispatches)
    finally:
        for w in workers:
            w.stop()
        if client is not None:
            client.close()
        gateway.stop()
        runtime.stop()
    launches = A.launch_counts()
    if failed:
        raise AssertionError(f"phase14: the workers failed {failed} jobs")
    if outcome["created"] != set(keys) | {cancelled} or outcome["terminated"] != {cancelled}:
        raise AssertionError(f"phase14: {len(outcome['created'])} instances in the leaders' "
                             f"logs, the client saw {len(keys) + 1}")
    if outcome["completed"] != set(keys):
        raise AssertionError(f"phase14: {len(outcome['completed'])} of {len(keys)} instances "
                             f"completed")
    if outcome["jobs"] != seen_jobs or handled != len(seen_jobs):
        raise AssertionError(f"phase14: {len(outcome['jobs'])} jobs completed in the leaders' "
                             f"logs, the workers handled {handled} ({len(seen_jobs)} keys)")
    host = router.host_groups - before[0]
    if host:
        raise AssertionError(f"phase14: the router sent {host} groups to the host")
    if launches["sharded_collect"] <= 0:
        raise AssertionError("phase14: sharded_collect was not launched")
    busy_ms = None
    if on_card:
        busy_ms = sum(e.device_time_total for e in prof.key_averages()
                      if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                      ) / 1e3
    busy = busy_ms / (wall * 1e3) if busy_ms else None
    lat = {k: (1e3 * percentile(v, 0.5), 1e3 * percentile(v, 0.99))
           for k, v in latencies.items()}
    rpcs = {}
    edges, latency_after = gateway_latency()
    for rpc, (count, total, buckets) in latency_after.items():
        c0, s0, b0 = latency_before.get(rpc, (0, 0.0, [0] * len(buckets)))
        counts = [b - a for a, b in zip(b0, buckets)]
        if count > c0:
            rpcs[rpc] = (count - c0, round(1e3 * (total - s0) / (count - c0), 3),
                         round(1e3 * estimate_quantile(edges, counts, 0.5), 3),
                         round(1e3 * estimate_quantile(edges, counts, 0.99), 3))
    in_process = runtime_phase["latency"]["create"]
    log(f"phase14 gRPC front [{card}]: Gateway over ClusterRuntime 3 brokers x 3 partitions "
        f"x replication 3 on {'the card (no device argument)' if on_card else device}, one "
        f"3-shard mesh runner; grpc {grpc.__version__}, protobuf "
        f"{google.protobuf.__version__} (gateway_pb2's builder gencode loaded); "
        f"{n_requests} CreateProcessInstance ({len(warm)} one at a time, the rest from "
        f"{clients} client threads) in {created_s:.3f} s, one more created and cancelled, "
        f"{len(workers)} JobWorkers over StreamActivatedJobs completed {handled} jobs, "
        f"every instance complete, {wall:.3f} s in all; then Topology, "
        f"CreateProcessInstanceWithResult, EvaluateDecision, PublishMessage answered OK; "
        f"gRPC create latency ms p50/p99 {round(lat['create'][0], 3)}/"
        f"{round(lat['create'][1], 3)} (one at a time {round(lat['warm'][0], 3)}/"
        f"{round(lat['warm'][1], 3)}) beside phase 13's in-process submit "
        f"{round(in_process[0], 3)}/{round(in_process[1], 3)}; gateway_request_latency "
        f"per RPC (calls, mean ms, p50 ms, p99 ms by its buckets) {rpcs}; mesh runner "
        f"({MESH_WINDOW_S * 1e3} ms window) {stats[0]} dispatches of {stats[1]} groups, "
        f"{stats[2]} coalesced ({pct(stats[2] / max(stats[0], 1))} of dispatches); "
        f"sharded_collect launches {launches['sharded_collect']}, run_collect "
        f"{launches['run_collect']}; job-push peeks that waited a second for a busy "
        f"partition {busy_peeks[0]}; router this phase host {host}, card "
        f"{router.accel_groups - before[1]}; card busy {pct(busy)} of the phase "
        f"({busy_ms} ms of kernels and copies, torch.profiler)")
    return {"launches": launches["sharded_collect"],
            "run_collect_launches": launches["run_collect"], "latency": lat, "rpcs": rpcs,
            "mesh": stats, "busy": busy, "wall": wall, "busy_peeks": busy_peeks[0]}


# ---------------------------------------------------------------------------
# phase 15: the standalone entry point in its three shapes

#: the typed statuses a client may meet while a killed worker's partitions
#: elect new leaders; retried and counted in the workers shape's failover
#: window (from the kill through its last creation), fatal anywhere else
RETRYABLE = ("UNAVAILABLE", "RESOURCE_EXHAUSTED")
#: host records a leader must not have: a group the router sent to the host
#: (``routed-host``, counted under ``unregistered`` on the metrics plane) or
#: one the device-fault seam contained
FORBIDDEN_HOST = re.compile(r'zeebe_kernel_records_total\{[^}]*path="host"[^}]*'
                            r'reason="(device-[^"]*|unregistered)"[^}]*\} (\S+)')
SHAPE_ARGS = ["--partitions", "3", "--replication", "3"]
#: what the kernel backend logs when the fault seam contains a device
#: failure or the shadow oracle quarantines a device result
DEVICE_FAULT_LINES = ("device failure contained", "shadow verification MISMATCH")


def partition_of(key: int) -> int:
    """The partition a Zeebe key was minted on (its top bits)."""
    return key >> 51


def standalone_boot_lines(text: str) -> list[dict]:
    """Each start-up a log holds: the probe's seconds, the card's start-up
    split (CUDA context, kernel library, link) and, for a worker, the
    seconds from its main to serving."""
    out = []
    for line in text.splitlines():
        if "device probe:" in line and "'elapsed_s'" in line:
            found = re.search(r"'elapsed_s': ([0-9.]+)", line)
            out.append({"probe_s": float(found.group(1))})
        elif " card up: " in line and out:
            out[-1].update(ast.literal_eval(line.split(" card up: ", 1)[1]))
        elif " worker up: " in line and out:
            found = re.search(r"([0-9.]+) s after main", line)
            out[-1]["main_s"] = float(found.group(1))
    return out


class ShapeRun:
    """One shape's processes and what its client saw."""

    def __init__(self, name: str, root) -> None:
        self.name = name
        self.root = root
        self.procs: list = []
        self.management: list[int] = []
        self.keys: list[int] = []
        self.latency: dict[str, list[float]] = {"warm": [], "create": []}
        self.retried: dict[str, int] = {}
        self.failover = False
        self.lock = threading.Lock()

    def create(self, client, kind: str, process: str, x: int) -> int:
        """One creation; the broker's backpressure (RESOURCE_EXHAUSTED, a
        rejection the client retries by the protocol) and, in the failover
        window, a typed retryable status are retried (and counted), anything
        else fails the phase."""
        import grpc

        t0 = time.perf_counter()
        while True:
            try:
                key = client.create_instance(process, variables={"x": x}).process_instance_key
                break
            except grpc.RpcError as exc:
                code = exc.code().name
                if not (code == "RESOURCE_EXHAUSTED" or (self.failover and code in RETRYABLE)):
                    raise AssertionError(f"phase15 {self.name}: CreateProcessInstance "
                                         f"answered {code}: {exc.details()}") from exc
                with self.lock:
                    self.retried[code] = self.retried.get(code, 0) + 1
                time.sleep(0.05)
        with self.lock:
            self.latency[kind].append(time.perf_counter() - t0)
            self.keys.append(key)
        return key

    def status(self) -> dict:
        """The cluster's partition rows: /cluster/status of every management
        port (one for the in-process and workers shapes, one a broker over
        TCP), leaders by partition."""
        from zeebe_tpu_torch.testing.standalone_run import StandaloneProcess

        rows, workers = [], {}
        for port in self.management:
            status = StandaloneProcess.get(port, "/cluster/status")
            rows += status["brokers"]
            workers.update(status.get("workers", {}))
        leaders = {int(pid): (row["nodeId"], part) for row in rows
                   for pid, part in row.get("partitions", {}).items()
                   if part.get("role") == "leader" and not row.get("stale")}
        return {"leaders": leaders, "workers": workers, "rows": rows}


#: the lines a process writes on its way to serving, in order: its guard's
#: verdict, the card up, a worker serving its port, the gateway bound (in
#: process and for the workers, over TCP)
BOOT_MARKS = ("device probe", "card up", "worker up", "gateway listening", "gateway on")


def await_serving(run: ShapeRun, gateway: int, deadline: float) -> tuple:
    """A client of the gateway on port ``gateway``, made once the first
    process's log says the gateway is bound (a channel opened before would
    back off from its failed connects); the seconds from the first
    process's start until its topology shows three brokers and a leader for
    every partition; the boot's timeline: the seconds at which each
    process's log first showed each of ``BOOT_MARKS`` (read every 0.2 s)."""
    from zeebe_tpu_torch.client import ZeebeTpuClient

    timeline: dict[str, float] = {}
    client = None
    while True:
        now = time.monotonic() - run.procs[0].started
        logs = {proc.log_path.stem: proc.log() for proc in run.procs}
        logs.update({p.parent.name: p.read_text(errors="replace")
                     for p in run.root.glob("*/worker.log")})
        for source, text in logs.items():
            for mark in BOOT_MARKS:
                if mark in text:
                    timeline.setdefault(f"{source}: {mark}", round(now, 1))
        for proc in run.procs:
            if proc.exited() is not None:
                raise AssertionError(f"phase15 {run.name}: a process exited "
                                     f"{proc.exited()} while booting:\n{proc.log()[-3000:]}")
        if client is None and any(f"{run.procs[0].log_path.stem}: {mark}" in timeline
                                  for mark in BOOT_MARKS[3:]):
            client = ZeebeTpuClient(f"127.0.0.1:{gateway}", credentials_provider=False)
        if client is not None:
            topology = client.topology()
            leaders = {pid for b in topology.brokers for pid, role in b["partitions"].items()
                       if role == "LEADER"}
            if len(topology.brokers) == 3 and leaders == {1, 2, 3}:
                return client, time.monotonic() - run.procs[0].started, timeline
        if time.monotonic() > deadline:
            if client is not None:
                client.close()
            raise AssertionError(f"phase15 {run.name}: not serving in time:\n"
                                 f"{run.procs[0].log()[-3000:]}")
        time.sleep(0.2)


def await_failover(run: ShapeRun, killed: dict) -> None:
    """Sets ``killed["failover_s"]``: the seconds from the kill until the
    gateway's /cluster/status shows another worker leading every partition
    the killed one led (read every 0.1 s, for at most 60 s)."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < 60.0:
        rows = run.status()["rows"]
        moved = {int(pid) for row in rows if row["nodeId"] != killed["worker"]
                 and not row.get("stale")
                 for pid, part in row.get("partitions", {}).items()
                 if part.get("role") == "leader"}
        if set(killed["partitions"]) <= moved:
            killed["failover_s"] = round(time.monotonic() - t0, 3)
            return
        time.sleep(0.1)


def drive_shape(run: ShapeRun, client, models, n_requests: int, clients: int,
                kill_after: int | None = None) -> dict:
    """Phase 14's traffic against one shape: the nine definitions and the
    DMN deployed; a creation of the first process until every partition has
    answered one (the deployment's distribution; NOT_FOUND until then);
    creations of each process once on each partition one at a time; the
    rest from ``clients`` threads; with ``kill_after``, SIGKILL of the first
    worker that leads a partition once that many creations are acknowledged; then one
    ``JobWorker`` a job type until the completion exporter has every
    acknowledged instance."""
    from concurrent.futures import ThreadPoolExecutor

    import grpc

    from zeebe_tpu_torch.client import JobWorker
    from zeebe_tpu_torch.testing.standalone_run import completed_keys

    pids = [m.process_id for m in models]
    t0 = time.monotonic()
    client.deploy_resource(*[(f"{m.process_id}.bpmn", to_bpmn_xml(m)) for m in models],
                           ("band.dmn", W.dmn_band_xml()))
    answered: set = set()
    deadline = time.monotonic() + 60.0
    while answered != {1, 2, 3}:
        try:
            answered.add(partition_of(run.create(client, "warm", pids[0], 0)))
        except AssertionError as exc:
            cause = exc.__cause__
            if not (isinstance(cause, grpc.RpcError) and cause.code() == grpc.StatusCode.NOT_FOUND
                    and time.monotonic() < deadline):
                raise
            time.sleep(0.05)
    for i, process in enumerate(process for process in pids for _ in range(3)):
        run.create(client, "warm", process, i % 30)
    killed = None
    with ThreadPoolExecutor(clients) as pool:
        first = n_requests if kill_after is None else kill_after
        todo = list(range(len(run.keys), first))
        for f in [pool.submit(run.create, client, "create", pids[i % len(pids)], i % 30)
                  for i in todo]:
            f.result()
        if kill_after is not None:
            status = run.status()
            # the first worker in the gateway's member order that leads a
            # partition: every partition it led fails over to a worker
            # listed after it, whose leadership must displace the dead
            # worker's last status row
            name = min(node for node, _ in status["leaders"].values())
            led = sorted(pid for pid, (node, _) in status["leaders"].items() if node == name)
            pid = status["workers"][name]["pid"]
            os.kill(pid, signal.SIGKILL)
            killed = {"worker": name, "pid": pid, "partitions": led}
            run.failover = True
            watch = threading.Thread(target=await_failover, args=(run, killed), daemon=True)
            watch.start()
            for f in [pool.submit(run.create, client, "create", pids[i % len(pids)], i % 30)
                      for i in range(len(run.keys), n_requests)]:
                f.result()
            watch.join(timeout=60.0)
    created_s = time.monotonic() - t0
    seen_jobs: set = set()

    def handle(job) -> dict:
        with run.lock:
            seen_jobs.add(job.key)
        return {}

    workers = [JobWorker(client, t, handle, worker_name="smoke", stream_enabled=True,
                         timeout_ms=30_000).start() for t in job_types(models)]
    try:
        deadline = time.monotonic() + 300.0
        while not set(run.keys) <= completed_keys(run.root / "completed"):
            if time.monotonic() > deadline:
                missing = len(set(run.keys) - completed_keys(run.root / "completed"))
                raise AssertionError(f"phase15 {run.name}: {missing} of {len(run.keys)} "
                                     f"instances did not complete")
            time.sleep(0.2)
    finally:
        for w in workers:
            w.stop()
    return {"killed": killed, "created_s": created_s, "seen_jobs": seen_jobs,
            "handled": sum(w.handled_count for w in workers),
            "failed": sum(w.failed_count for w in workers)}


def check_leaders(run: ShapeRun) -> dict:
    """Every partition's leader: kernel records, a healthy device ladder, no
    shadow mismatch and no forbidden host reason (over TCP and in process
    every host record is on the metrics plane; a worker's status row names
    its dominant reason); per partition (kernel records, host records,
    dominant host reason, leader)."""
    deadline = time.monotonic() + 30.0
    while True:  # a worker's status push lags its last group by up to 1 s
        status = run.status()
        leaders = status["leaders"]
        done = sorted(leaders) == [1, 2, 3] and all(
            part.get("kernelCoverage", {}).get("kernelRecords", 0) > 0
            for _, part in leaders.values())
        if done or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    out = {}
    for pid in (1, 2, 3):
        if pid not in leaders:
            raise AssertionError(f"phase15 {run.name}: partition {pid} has no leader: "
                                 f"{status['rows']}")
        node, part = leaders[pid]
        cov = part.get("kernelCoverage", {})
        if cov.get("kernelRecords", 0) <= 0:
            raise AssertionError(f"phase15 {run.name}: partition {pid}'s leader {node} has "
                                 f"no kernel records: {cov}")
        reason = cov.get("dominantHostReason", "")
        if reason == "routed-host" or reason.startswith("device-"):
            raise AssertionError(f"phase15 {run.name}: partition {pid} host records {reason}")
        device = cov.get("device", {})
        if device.get("state") != "HEALTHY" or device.get("shadowMismatches", 0):
            raise AssertionError(f"phase15 {run.name}: partition {pid}'s ladder {device}")
        out[pid] = (cov["kernelRecords"], cov.get("hostRecords", 0), reason or None, node)
    if run.name != "workers":  # each process's own metrics plane
        for port in run.management:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
                text = r.read().decode()
            bad = [(r, v) for r, v in FORBIDDEN_HOST.findall(text) if float(v) > 0]
            if bad:
                raise AssertionError(f"phase15 {run.name}: forbidden host records {bad}")
    return out


def check_replicas(run: ShapeRun, seen_jobs: set) -> dict:
    """Offline, after the clean stop: per partition, three replicas that
    agree wherever two hold a position, and a log holding every
    acknowledged instance's completion and every job the workers
    completed. Records per partition."""
    from zeebe_tpu_torch.testing.standalone_run import (
        is_process_completion,
        merged_log,
        replica_logs,
    )

    logs = replica_logs(run.root)
    out, completed, jobs = {}, set(), set()
    for pid in (1, 2, 3):
        replicas = logs.get(pid, {})
        if len(replicas) != 3:
            raise AssertionError(f"phase15 {run.name}: partition {pid} has replicas "
                                 f"{sorted(replicas)}")
        try:
            merged = merged_log(replicas)
        except AssertionError as exc:
            raise AssertionError(f"phase15 {run.name}: partition {pid}: {exc}") from None
        for rec in merged.values():
            if is_process_completion(rec):
                completed.add(rec.key)
            elif rec.value_type == ValueType.JOB and rec.intent == JobIntent.COMPLETED:
                jobs.add(rec.key)
        out[pid] = len(merged)
    if not set(run.keys) <= completed:
        raise AssertionError(f"phase15 {run.name}: {len(set(run.keys) - completed)} "
                             f"acknowledged instances lack a completion in the logs")
    if not seen_jobs <= jobs:
        raise AssertionError(f"phase15 {run.name}: {len(seen_jobs - jobs)} jobs the workers "
                             f"completed lack a completion in the logs")
    return out



# ---------------------------------------------------------------------------
# phase 15's command line: python -m zeebe_tpu_torch.cli against the
# in-process shape, then offline on its data directory and the doc gates

#: every command runs as ``python -m zeebe_tpu_torch.cli``; ``-X importtime``
#: lists on stderr each module the process imported
CLI = [sys.executable, "-X", "importtime", "-m", "zeebe_tpu_torch.cli"]
#: the commands that build a kernel backend (``metrics-doc``) or import the
#: kernel registry's module (``eligibility --deployed``) and so load torch;
#: every other command's process must load neither torch nor JAX
CLI_TORCH_COMMANDS = ("metrics-doc", "eligibility")
CLI_PROCESS, CLI_JOB_TYPE, CLI_INSTANCES = "cli_task", "cli_work", 20


@dataclasses.dataclass
class CliRuns:
    """Each command's wall seconds, a run each, and what its processes
    loaded of torch and JAX, by command."""

    seconds: dict = dataclasses.field(default_factory=dict)
    loaded: dict = dataclasses.field(default_factory=dict)


def run_cli(args: list[str], runs: CliRuns, timeout: float = 300.0) -> str:
    """One command line run to its end: its stdout. Fails on an exit code
    other than 0, and on a process that loaded torch or JAX where its
    command is not one of ``CLI_TORCH_COMMANDS``."""
    words = [a for a in args if not a.startswith("-") and ":" not in a]
    command = words[0]
    label = " ".join(words[:2]) if command in ("create", "activate", "complete") else command
    t0 = time.perf_counter()
    proc = subprocess.run([*CLI, *args], capture_output=True, text=True, timeout=timeout,
                          cwd=Path(__file__).resolve().parent)
    runs.seconds.setdefault(label, []).append(time.perf_counter() - t0)
    if proc.returncode != 0:
        raise AssertionError(f"phase15 cli: {' '.join(args)} exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{cli_errors(proc.stderr)[-3000:]}")
    loaded = {line.rsplit("|", 1)[-1].strip() for line in proc.stderr.splitlines()
              if line.startswith("import time:")} & {"torch", "jax"}
    runs.loaded.setdefault(label, set()).update(loaded)
    if loaded and command not in CLI_TORCH_COMMANDS:
        raise AssertionError(f"phase15 cli: {' '.join(args)} loaded {sorted(loaded)}")
    return proc.stdout


def cli_errors(stderr: str) -> str:
    """A command's stderr less ``-X importtime``'s lines."""
    return "\n".join(line for line in stderr.splitlines() if not line.startswith("import time:"))


def leader_kernel_records(run: ShapeRun) -> dict:
    """Each partition's leader and its kernel records on /cluster/status."""
    return {pid: (node, part.get("kernelCoverage", {}).get("kernelRecords", 0))
            for pid, (node, part) in run.status()["leaders"].items()}


def cli_live(run: ShapeRun, gateway: int, client) -> dict:
    """The command line against the running shape: ``status``; ``deploy`` of
    a one_task file; ``create instance`` ``CLI_INSTANCES`` times (4 at a
    time); ``activate jobs`` until every one of their jobs is active and
    ``complete job`` for each (4 at a time); ``top --once`` and ``profile
    --seconds 1 --folded`` over the management port. Between the deployment
    and the creations the smoke's own client creates instances of the new
    process until every partition has answered (the deployment's
    distribution; their jobs are the command line's too). Fails on an exit
    code other than 0, an instance that does not complete, or a partition
    whose leader's kernel records did not grow over the command line's
    traffic."""
    from concurrent.futures import ThreadPoolExecutor

    import grpc

    from zeebe_tpu_torch.testing.standalone_run import completed_keys

    address = ["--address", f"127.0.0.1:{gateway}"]
    management = ["--management", f"http://127.0.0.1:{run.management[0]}"]
    runs = CliRuns()
    t0 = time.perf_counter()
    status = json.loads(run_cli([*address, "status"], runs))
    if (status["partitionsCount"], status["clusterSize"]) != (3, 3):
        raise AssertionError(f"phase15 cli: status {status}")
    before = leader_kernel_records(run)
    bpmn = run.root / f"{CLI_PROCESS}.bpmn"
    bpmn.write_text(to_bpmn_xml(Bpmn.create_executable_process(CLI_PROCESS).start_event("s")
                                .service_task("t", job_type=CLI_JOB_TYPE).end_event("e")
                                .done()))
    deployed = json.loads(run_cli([*address, "deploy", str(bpmn)], runs))
    if deployed["processes"][0]["bpmnProcessId"] != CLI_PROCESS:
        raise AssertionError(f"phase15 cli: deploy answered {deployed}")
    probes, answered, deadline = [], set(), time.monotonic() + 60.0
    while answered != {1, 2, 3}:
        try:
            probes.append(client.create_instance(CLI_PROCESS).process_instance_key)
            answered.add(partition_of(probes[-1]))
        except grpc.RpcError as exc:
            if exc.code() != grpc.StatusCode.NOT_FOUND or time.monotonic() > deadline:
                raise
            time.sleep(0.05)

    def create(i: int) -> int:
        out = run_cli([*address, "create", "instance", CLI_PROCESS, "--variables",
                       json.dumps({"x": i})], runs)
        return json.loads(out)["processInstanceKey"]

    with ThreadPoolExecutor(4) as pool:
        keys = list(pool.map(create, range(CLI_INSTANCES)))
    jobs: dict = {}
    deadline = time.monotonic() + 120.0
    while len(jobs) < len(keys) + len(probes):
        if time.monotonic() > deadline:
            raise AssertionError(f"phase15 cli: {len(jobs)} of {len(keys) + len(probes)} "
                                 f"jobs activated")
        out = json.loads(run_cli([*address, "activate", "jobs", CLI_JOB_TYPE, "--max-jobs",
                                  "64"], runs))
        jobs.update((job["key"], job) for job in out["jobs"])
    if {job["process_instance_key"] for job in jobs.values()} != set(keys) | set(probes):
        raise AssertionError("phase15 cli: the activated jobs are not the instances' jobs")
    with ThreadPoolExecutor(4) as pool:
        done = list(pool.map(lambda key: json.loads(run_cli(
            [*address, "complete", "job", str(key)], runs))["completed"],
            sorted(jobs)))
    if done != sorted(jobs):
        raise AssertionError("phase15 cli: complete job answered other keys")
    deadline = time.monotonic() + 60.0
    while not set(keys) | set(probes) <= completed_keys(run.root / "completed"):
        if time.monotonic() > deadline:
            missing = (set(keys) | set(probes)) - completed_keys(run.root / "completed")
            raise AssertionError(f"phase15 cli: instances {sorted(missing)} did not complete")
        time.sleep(0.2)
    deadline = time.monotonic() + 30.0
    while True:  # the leaders' coverage after their last group
        after = leader_kernel_records(run)
        grew = sorted(pid for pid in (1, 2, 3) if pid in before and pid in after
                      and after[pid][0] == before[pid][0] and after[pid][1] > before[pid][1])
        if grew == [1, 2, 3] or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    if grew != [1, 2, 3]:
        raise AssertionError(f"phase15 cli: leaders' kernel records before {before}, after "
                             f"{after}: not every partition's grew over the command line's "
                             f"traffic")
    top = run_cli(["top", "--once", *management], runs)
    if "KERNEL" not in top:
        raise AssertionError(f"phase15 cli: top --once shows no kernel coverage:\n{top}")
    profile = run_cli(["profile", "--seconds", "1", "--folded", *management], runs)
    if not profile.strip():
        raise AssertionError("phase15 cli: profile --folded printed nothing")
    return {"keys": keys, "probes": probes, "jobs": len(jobs), "runs": runs,
            "kernel_records": {pid: (before[pid][1], after[pid][1]) for pid in (1, 2, 3)},
            "top_lines": len(top.splitlines()), "profile_stacks": len(profile.splitlines()),
            "live_s": time.perf_counter() - t0}


def trace_completes(lineage: dict, key: int) -> bool:
    """Whether a ``trace`` of instance ``key`` holds its process's
    ELEMENT_COMPLETED record."""
    nodes = list(lineage["roots"])
    while nodes:
        node = nodes.pop()
        if (node["valueType"], node["intent"], node["key"]) == (
                "PROCESS_INSTANCE", "ELEMENT_COMPLETED", key):
            return True
        nodes.extend(node.get("children", ()))
    return False


def cli_offline(run: ShapeRun, live: dict, device=None) -> dict:
    """After the shape's clean stop, on its data directory: ``trace`` of
    every instance the command line created (each must hold its
    completion), ``snapshots`` and ``eligibility --deployed``; then the doc
    gates ``lint --check``, ``knobs-doc --check``, ``eligibility-doc
    --check`` and ``metrics-doc --check`` (with no ``--device``: its broker
    on the card), and the import probe of the client-side modules."""
    from concurrent.futures import ThreadPoolExecutor

    runs = live["runs"]
    t0 = time.perf_counter()
    broker = run.root / "broker-0"  # every broker holds a replica of all three

    def trace(key: int) -> bool:
        out = run_cli(["trace", str(key), "--data-dir", str(broker)], runs)
        return trace_completes(json.loads(out), key)

    with ThreadPoolExecutor(4) as pool:
        traced = dict(zip(live["keys"], pool.map(trace, live["keys"])))
    if not all(traced.values()):
        raise AssertionError(f"phase15 cli: traces without their completion: "
                             f"{[k for k, ok in traced.items() if not ok]}")
    snaps = json.loads(run_cli(["snapshots", str(broker)], runs))
    if len(snaps["partitions"]) != 3:
        raise AssertionError(f"phase15 cli: snapshots found {snaps['partitions']}")
    eligibility = json.loads(run_cli(["eligibility", "--deployed", "--data-dir",
                                      str(run.root)], runs))
    verdicts = {d["bpmnProcessId"]: d["eligible"] for d in eligibility["definitions"]}
    if verdicts.get(CLI_PROCESS) is not True:
        raise AssertionError(f"phase15 cli: eligibility --deployed {verdicts}")
    for gate in ("lint", "knobs-doc", "eligibility-doc"):
        run_cli([gate, "--check"], runs)
    run_cli(["metrics-doc", "--check", *([] if device is None else ["--device", device])], runs)
    probes = {m: import_once(m, Path(__file__).resolve().parent) for m in CLIENT_MODULES}
    if any(p.get("loaded") != [] for p in probes.values()):
        raise AssertionError(f"phase15 cli: modules that load torch or JAX: {probes}")
    return {"traced": len(traced), "snapshots": {p["partition"]: len(p["snapshots"])
                                                 for p in snaps["partitions"]},
            "eligible": verdicts, "offline_s": time.perf_counter() - t0,
            "metrics_doc_on": "the card" if device is None else device}


def run_shape(name: str, root, n_requests: int, clients: int, device,
              kill_after: int | None = None, cli: bool = False) -> dict:
    """Start one shape, drive it, check it, stop it; the processes are
    torn down (SIGTERM, then SIGKILL to every one) whatever happens. With
    ``cli``, the command line runs against it before the stop
    (``cli_live``) and on its data directory after (``cli_offline``)."""
    from zeebe_tpu_torch.standalone import _free_ports
    from zeebe_tpu_torch.testing.standalone_run import StandaloneProcess, completion_env

    run = ShapeRun(name, root / name)
    env = dict(os.environ, **completion_env(run.root / "completed"))
    extra = [] if device is None else ["--device", device]
    if name == "tcp":
        ports = _free_ports(9)
        contact = ",".join(f"broker-{i}=127.0.0.1:{ports[i]}" for i in range(3))
        for i in range(3):
            run.management.append(ports[6 + i])
            run.procs.append(StandaloneProcess(
                ["--node-id", f"broker-{i}", "--bind", f"127.0.0.1:{ports[i]}",
                 "--contact", contact, "--port", str(ports[3 + i]),
                 "--management-port", str(ports[6 + i]), *SHAPE_ARGS, *extra],
                run.root / f"broker-{i}", env=env))
        gateway = ports[3]
    else:
        gateway, management = _free_ports(2)
        run.management.append(management)
        shape = ["--workers", "3"] if name == "workers" else ["--brokers", "3"]
        run.procs.append(StandaloneProcess(
            [*shape, "--port", str(gateway), "--management-port", str(management),
             *SHAPE_ARGS, *extra], run.root, env=env))
    client = None
    rcs, survivors = [], []
    try:
        for proc in run.procs:
            proc.start()
        client, boot_s, timeline = await_serving(run, gateway, time.monotonic() + 300.0)
        drove = drive_shape(run, client, serving_models(), n_requests, clients, kill_after)
        leaders = check_leaders(run)
        live = cli_live(run, gateway, client) if cli else None
        restarts = {w: s.get("restarts", 0) for w, s in run.status()["workers"].items()}
        client.close()
        client = None
        rcs = [proc.stop() for proc in run.procs]
    finally:
        if client is not None:
            client.close()
        for proc in run.procs:
            survivors += proc.kill()
    if rcs != [0] * len(run.procs):
        raise AssertionError(f"phase15 {name}: exit codes after SIGTERM {rcs}")
    if survivors:
        raise AssertionError(f"phase15 {name}: processes survived the stop: {survivors}")
    records = check_replicas(run, drove["seen_jobs"])
    logs = [p.read_text() for p in sorted(run.root.glob("*/worker.log"))]
    logs += [proc.log() for proc in run.procs]
    faults = [line for text in logs for line in text.splitlines()
              if any(mark in line for mark in DEVICE_FAULT_LINES)]
    if faults:
        raise AssertionError(f"phase15 {name}: device faults in the logs: {faults[:5]}")
    if name != "workers" and drove["failed"]:
        raise AssertionError(f"phase15 {name}: the workers failed {drove['failed']} jobs")
    boots = [b for text in logs for b in standalone_boot_lines(text)]
    lat = {k: (1e3 * percentile(v, 0.5), 1e3 * percentile(v, 0.99)) for k, v in
           run.latency.items() if v}
    if live is not None:
        live.update(cli_offline(run, live, device))
    return {"cli": live, "boot_s": boot_s, "timeline": timeline, "latency": lat,
            "leaders": leaders, "records": records,
            "restarts": restarts, "retried": run.retried, "boots": boots,
            "created": len(run.keys), "one_at_a_time": len(run.latency["warm"]), **drove}


def phase_standalone(card: str, grpc_phase: dict, device=None, requests=(600, 300, 150),
                     clients: int = 8) -> dict:
    """Phase 15: ``python -m zeebe_tpu_torch.standalone`` in its three
    shapes, each a subprocess with no device argument (the card; ``device``
    only in a rehearsal on the CPU), a data directory and a management
    port, driven by the port's ``ZeebeTpuClient`` with phase 14's
    definitions: supervised workers (``--workers 3``, ``requests[0]``
    creations, the first worker that leads a partition killed with SIGKILL after
    half of them), the TCP cluster (three processes, ``requests[1]``
    through broker-0's gateway) and in-process brokers (``requests[2]``),
    each 3 partitions x replication 3. Fails on a non-OK status (but
    backpressure, and a typed retryable one in the workers shape's failover
    window, each retried and counted), an instance not
    completed, a leader without kernel records, a forbidden host record, a
    device ladder not HEALTHY, replicas that disagree or miss a completion
    the client saw, an exit code other than 0 after SIGTERM or a surviving
    process. The in-process shape also runs the command line
    (``cli_live``, ``cli_offline``)."""
    root = Path(tempfile.mkdtemp(prefix="zeebe-standalone-"))
    out = {}
    for name, n, kill_after in (("workers", requests[0], requests[0] // 2),
                                ("tcp", requests[1], None), ("in-process", requests[2], None)):
        t0 = time.perf_counter()
        res = out[name] = run_shape(name, root, n, clients, device, kill_after,
                                    cli=name == "in-process")
        killed = res["killed"]
        failover = ""
        if killed is not None:
            failover = (f"; killed {killed['worker']} (pid {killed['pid']}, leading partitions "
                        f"{killed['partitions']}) after {n // 2} creations, new leaders "
                        f"{killed.get('failover_s', 'not seen within 60')} s after the kill, "
                        f"restarts {res['restarts']}, retried "
                        f"{res['retried'] or 'nothing'}, job completions failed and retried "
                        f"{res['failed']}")
        lat = res["latency"]
        log(f"phase15 standalone {name} [{card}]: 3 x 3 partitions x replication 3 on "
            f"{'the card (no device argument)' if device is None else device}; serving "
            f"{res['boot_s']:.3f} s after the start; {res['created']} CreateProcessInstance "
            f"in {res['created_s']:.3f} s after the deployment "
            f"({res['one_at_a_time']} one at a time incl. the "
            f"distribution probes, the rest from {clients} threads) and {res['handled']} jobs "
            f"by 9 JobWorkers, every instance complete; create ms p50/p99 "
            f"{round(lat['create'][0], 3)}/{round(lat['create'][1], 3)} (one at a time "
            f"{round(lat['warm'][0], 3)}/{round(lat['warm'][1], 3)}) beside phase 14's "
            f"{round(grpc_phase['latency']['create'][0], 3)}/"
            f"{round(grpc_phase['latency']['create'][1], 3)}; leaders' (kernel, host records, "
            f"dominant host reason, node) {res['leaders']}; records per partition "
            f"{res['records']}, replicas agree{failover}; exit 0 after SIGTERM, no process "
            f"left; {time.perf_counter() - t0:.1f} s")
        log(f"phase15 boot {name} [{card}]: per process start-up (probe s, CUDA context s, "
            f"kernel library s, link s, worker main to serving s) {res['boots']}; timeline "
            f"(s after the start, by log line) {res['timeline']}")
        if res["cli"] is not None:
            log_cli(card, res["cli"])
    return out


def log_cli(card: str, cli: dict) -> None:
    """Phase 15's command line lines: what it did, and each command's wall
    seconds (median and max of its runs) and whether its process loaded
    torch."""
    runs = cli["runs"]
    per = {k: (len(v), round(float(np.median(v)), 3), round(max(v), 3),
               sorted(runs.loaded.get(k, ())) or "no torch")
           for k, v in runs.seconds.items()}
    log(f"phase15 cli [{card}]: python -m zeebe_tpu_torch.cli against the in-process shape "
        f"(no device argument): status, deploy, {len(cli['keys'])} create instance, "
        f"{cli['jobs']} jobs activated and completed (with the {len(cli['probes'])} "
        f"distribution probes' instances), every instance complete; leaders' kernel records "
        f"(before, after) {cli['kernel_records']}; top --once {cli['top_lines']} lines, "
        f"profile --folded {cli['profile_stacks']} stacks; {cli['live_s']:.1f} s live; after "
        f"the stop: {cli['traced']} traces each holding its completion, snapshots per "
        f"partition {cli['snapshots']}, eligibility --deployed {cli['eligible']}, lint, "
        f"knobs-doc, eligibility-doc and metrics-doc --check (its broker on "
        f"{cli['metrics_doc_on']}), the client-side "
        f"modules load no torch; {cli['offline_s']:.1f} s offline")
    log(f"phase15 cli seconds [{card}] (runs, median s, max s, torch loaded): {per}")

# ---------------------------------------------------------------------------
# phase 16: the engine's gates


def worker_boots(directory: Path) -> dict:
    """Each worker's start-ups from its ``worker.log`` (the supervisor tees
    a worker's stderr there): worker -> [{probe_s, cuda_s, library_s,
    link_s, main_s}, ...], one entry a life."""
    return {log_path.parent.name: standalone_boot_lines(log_path.read_text(errors="replace"))
            for log_path in sorted(directory.glob("*/worker.log"))}


def check_workers_on_the_card(gate: str, boots: dict, device) -> None:
    """Every worker served after bringing the card up (its probe and the
    CUDA context), and no life served without the card, unless a rehearsal
    asked for the CPU (a life on the CPU logs no probe). A life stopped
    while it started (a restart at the gate's end) may lack its last
    lines."""
    if not boots:
        raise AssertionError(f"phase16 {gate}: no worker logs")
    if device is not None:
        return
    for worker, lives in boots.items():
        served = [life for life in lives if "main_s" in life]
        if not served or not all("cuda_s" in life for life in served):
            raise AssertionError(f"phase16 {gate}: {worker} did not serve on the card: {lives}")


def kernel_soak(cfg, directory, device):
    """The soak harness with its leader's kernel records read around each
    round's traffic (one broker: a round's leader is one partition of one
    life; a restart starts a new backend, counting from 0) and the
    ``k_chunk`` launches so far."""
    from zeebe_tpu_torch.testing.soak import SoakHarness

    class KernelSoak(SoakHarness):
        def _records(self) -> int:
            return self._leader().processor.kernel_backend.accounting.kernel_records

        def _traffic_round(self, round_no: int) -> None:
            before = self._records()
            super()._traffic_round(round_no)
            self.rounds_seen.append(
                {"round": round_no, "kernelRecords": self._records() - before,
                 "launches": A.launch_counts()["run_collect"]})

    harness = KernelSoak(cfg, directory=directory, device=device)
    harness.rounds_seen = []
    return harness


def gate_soak(card: str, device=None, cfg=None) -> dict:
    """16a: ``run_soak``'s harness in its CI short mode (5 power-loss
    crash-restart rounds of 18 creations, mid-flush and mid-snapshot) in
    this process, the port's sanitizer installed; its violations must be
    empty (a sanitizer violation raises, in any thread), every restart
    recovered within budget, a command acked, and every round's leader
    counts kernel records and launches ``k_chunk`` (counted from 0)."""
    from zeebe_tpu_torch.testing import sanitizer
    from zeebe_tpu_torch.testing.soak import SoakConfig

    cfg = cfg or SoakConfig()
    raised = []
    hook = threading.excepthook
    threading.excepthook = lambda args: (raised.append(args), hook(args))
    sanitizer.install()
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="zeebe-soak-") as tmp:
            A.reset_launch_counts()
            harness = kernel_soak(cfg, tmp, device)
            report = harness.run()
            launches = A.launch_counts()["run_collect"]
    finally:
        sanitizer.uninstall()
        threading.excepthook = hook
    wall = time.perf_counter() - t0
    rounds = harness.rounds_seen
    problems = list(report["violations"])
    problems += [f"thread {a.thread.name}: {a.exc_value!r}" for a in raised]
    if report["restarts"] != cfg.rounds or not report["withinBudget"]:
        problems.append(f"restarts {report['restarts']} of {cfg.rounds}, within budget "
                        f"{report['withinBudget']}")
    if report["ackedCommands"] < 1:
        problems.append("no command acked")
    if len(rounds) != cfg.rounds or any(r["kernelRecords"] <= 0 for r in rounds):
        problems.append(f"a round without kernel records: {rounds}")
    if problems:
        raise AssertionError(f"phase16 soak: {problems[:10]}")
    launched = [r["launches"] for r in rounds]
    if any(b <= a for a, b in zip([0] + launched, launched)):
        raise AssertionError(f"phase16 soak: a round without k_chunk launches: {rounds}")
    log(f"phase16 soak [{card}]: {cfg.rounds} crash-restart rounds x {cfg.traffic_per_round} "
        f"creations in process on {'the card' if device is None else device}, sanitizer "
        f"installed; restarts {report['restarts']}, recovery ms per restart "
        f"{[r['durationMs'] for r in report['recoveries']]} (budget {report['budgetMs']}), "
        f"acked {report['ackedCommands']}, exports {report['exports']}, snapshot kinds "
        f"{report['snapshotKinds']}, max chain {report['maxChainLength']}; per round (kernel "
        f"records on its leader, k_chunk launches so far) "
        f"{[(r['kernelRecords'], r['launches']) for r in rounds]}, k_chunk launches "
        f"{launches}; no violation; {wall:.1f} s")
    return {"report": report, "rounds": rounds, "launches": launches, "wall_s": wall}


class LastStatusRows:
    """Keeps the workers' last status rows when a gate stops its
    multi-process runtime (the rows ``/cluster/status`` serves)."""

    def __enter__(self) -> dict:
        from zeebe_tpu_torch.multiproc import runtime as R

        self.cls, self.stop, self.rows = R.MultiProcClusterRuntime, \
            R.MultiProcClusterRuntime.stop, {}
        stop, rows = self.stop, self.rows

        def keeping(runtime) -> None:
            rows.update(json.loads(json.dumps(runtime._worker_status, default=str)))
            stop(runtime)

        self.cls.stop = keeping
        return self.rows

    def __exit__(self, *exc) -> None:
        self.cls.stop = self.stop


def leader_rows(rows: dict, partitions: int) -> dict:
    """Partition -> (worker, kernelCoverage) of the row naming its leader
    in the highest term, from the workers' last status rows."""
    out = {}
    for worker, status in rows.items():
        for pid, part in status.get("partitions", {}).items():
            if part.get("role") == "leader" and (
                    int(pid) not in out or part.get("term", -1) > out[int(pid)][2]):
                out[int(pid)] = (worker, part.get("kernelCoverage", {}), part.get("term", -1))
    if sorted(out) != list(range(1, partitions + 1)):
        raise AssertionError(f"phase16: a partition without a leader row: {rows}")
    return {pid: (worker, cov) for pid, (worker, cov, _) in out.items()}


def gate_device_chaos(card: str, device=None, cfg=None) -> dict:
    """16b: ``run_device_chaos`` in its quick preset (3 worker processes, 2
    partitions x replication 3, a 30 s drive, 1 kill, every group shadowed,
    the watchdog at 450 ms), its workers on the card (no device argument):
    the gate's own checks (delivery, replica CRCs, every configured fault
    class observed, every corruption caught before commit, a full
    SUSPECT -> QUARANTINED -> canary -> HEALTHY cycle) must find nothing,
    every worker must have served on the card, and every partition's leader
    must count kernel records on its last status row."""
    from zeebe_tpu_torch.testing.device_chaos import DeviceChaosConfig, run_device_chaos

    cfg = cfg or DeviceChaosConfig(device=device)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="zeebe-device-chaos-") as tmp, \
            LastStatusRows() as rows:
        report = run_device_chaos(cfg, tmp)
        boots = worker_boots(Path(tmp))
    wall = time.perf_counter() - t0
    kills = [e for e in report["events"] if e["action"] == "kill"]
    summary = (f"requests {report['requests']}, outcomes {report['outcomes']}; faults observed "
               f"{report['deviceFaultsObserved']}; corruption accounting "
               f"{report['corruptionAccounting']}; health cycle {report['healthCycle']}; "
               f"kills {kills}, restarts {report.get('workerRestarts')}; log records "
               f"{report['logRecords']}; gate wall {report['wallSeconds']} s")
    if report["violations"]:
        raise AssertionError(f"phase16 device chaos: {report['violations'][:10]} ({summary})")
    check_workers_on_the_card("device chaos", boots, cfg.device)
    leaders = {pid: (worker, cov.get("kernelRecords", 0), cov.get("hostRecords", 0),
                     cov.get("dominantHostReason"))
               for pid, (worker, cov) in leader_rows(rows, cfg.partitions).items()}
    if any(records <= 0 for _, records, _, _ in leaders.values()):
        raise AssertionError(f"phase16 device chaos: a leader without kernel records: {leaders}")
    log(f"phase16 device chaos [{card}]: {cfg.workers} workers x {cfg.partitions} partitions x "
        f"replication {cfg.replication} on {'the card' if cfg.device is None else cfg.device}, "
        f"{cfg.drive_seconds} s drive, the router on; {summary}; "
        f"leaders' (worker, kernel records, host records, dominant host reason) {leaders}; "
        f"no violation; {wall:.1f} s")
    log(f"phase16 device chaos boots [{card}]: per worker, per life (probe s, CUDA context s, "
        f"kernel library s, link s, worker main to serving s) {boots}")
    return {"report": report, "boots": boots, "leaders": leaders, "wall_s": wall}


def failover_timeline(report: dict) -> list:
    """The gateway's routing after a gate's first worker restart: (ms since
    the restart, leader by partition) for each change of its leader map,
    from the gate's gateway flight recorder."""
    events = sorted((e for ring in report.get("gatewayFlight", {}).get("partitions", {}).values()
                     for e in ring if e.get("kind") in ("worker_restart", "routing_epoch")),
                    key=lambda e: e["t"])
    restart = next((e["t"] for e in events if e["kind"] == "worker_restart"), None)
    if restart is None:
        return []
    return [(e["t"] - restart, e["leaders"]) for e in events
            if e["kind"] == "routing_epoch" and e["t"] >= restart - 1000]


def gate_serving(card: str, device=None, cfg=None) -> dict:
    """16c: ``run_serving`` in its quick preset with the kernel backend on
    (3 worker processes, 2 partitions x replication 3, open-loop Poisson
    arrivals from 128 client streams, calm, overload and a worker kill),
    the workers on the card: the gate's own checks (SLO p50 <= 1,000 ms
    and p99 <= 5,000 ms, fairness, goodput >= 0.7, fast sheds, no untyped
    error) must find nothing, and every worker must have served on the
    card. Every command of the gate names a tenant, and the kernel
    backend admits only the default tenant's (the reference's rule,
    ``zeebe_tpu/engine/kernel_backend.py:1476``): each partition's leader
    must show its backend live on the card (its coverage block, the
    ladder HEALTHY, no shadow mismatch) and its host records declined at
    admission (``head-not-admittable``), not routed or contained."""
    from zeebe_tpu_torch.testing.serving import ServingConfig, run_serving

    cfg = cfg or dataclasses.replace(ServingConfig(device=device), kernel_backend=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="zeebe-serving-") as tmp, LastStatusRows() as rows:
        report = run_serving(cfg, tmp)
        boots = worker_boots(Path(tmp))
    wall = time.perf_counter() - t0
    failover = failover_timeline(report)
    if report["violations"]:
        raise AssertionError(f"phase16 serving: {report['violations'][:10]} (well-behaved "
                             f"{report.get('wellBehaved')}; kills {report['events']}; routing "
                             f"after the restart, ms: {failover})")
    check_workers_on_the_card("serving", boots, cfg.device)
    leaders = {}
    for pid, (worker, cov) in leader_rows(rows, cfg.partitions).items():
        device_state = cov.get("device", {})
        leaders[pid] = (worker, cov.get("kernelRecords", 0), cov.get("hostRecords", 0),
                        cov.get("dominantHostReason"), device_state.get("state"))
        if (cov.get("kernelRecords", 0) + cov.get("hostRecords", 0) <= 0
                or not str(cov.get("dominantHostReason", "head-not-admittable:")).startswith(
                    "head-not-admittable:")
                or device_state.get("state") != "HEALTHY"
                or device_state.get("shadowMismatches", 0)):
            raise AssertionError(f"phase16 serving: partition {pid}'s leader {worker}: {cov}")
    tenants = {name: {"kind": t["kind"], "offered": t["offered"],
                      "p50/p99 ms by phase": {ph: (s.get("p50Ms"), s.get("p99Ms"))
                                              for ph, s in t["ackedByPhase"].items()},
                      "shed p95 ms": t["shedLatency"].get("p95Ms")}
               for name, t in report["tenants"].items()}
    well = report["wellBehaved"]
    log(f"phase16 serving [{card}]: {cfg.workers} workers x {cfg.partitions} partitions x "
        f"replication {cfg.replication} on {'the card' if cfg.device is None else cfg.device}, "
        f"kernel backend on; requests {report['requests']}, outcomes {report['outcomes']}; "
        f"well-behaved calm p50/p99 {well['calm'].get('p50Ms')}/{well['calm'].get('p99Ms')} ms, "
        f"under load {well['underLoad'].get('p50Ms')}/{well['underLoad'].get('p99Ms')} ms; "
        f"fairness {report.get('fairness')}; goodput {report.get('goodput')}; kills "
        f"{report['kills']}, the gateway's leaders after the restart (ms, leaders) {failover}; "
        f"leaders' (worker, kernel records, host records, dominant host "
        f"reason, ladder) {leaders}; "
        f"gate wall {report['wallSeconds']} s; no violation; {wall:.1f} s")
    log(f"phase16 serving tenants [{card}]: {tenants}")
    log(f"phase16 serving boots [{card}]: {boots}")
    return {"report": report, "leaders": leaders, "boots": boots, "wall_s": wall}


def phase_gates(card: str, device=None) -> dict:
    """Phase 16: the soak, device-chaos and serving gates, each called as a
    function with no device argument (the card; ``device`` only in a
    rehearsal on the CPU)."""
    return {"soak": gate_soak(card, device), "device_chaos": gate_device_chaos(card, device),
            "serving": gate_serving(card, device)}


# ---------------------------------------------------------------------------
# phase 17: the mesh as launch groups, and the graft entry


def group_layouts() -> dict:
    """Phase 17's layouts of the 8 shard blocks: 2 and 8 groups on cuda:0,
    and one group per card where there are two or more cards."""
    first = torch.device("cuda", 0)
    out = {f"{k} groups on cuda:0": [first] * k for k in (2, 8)}
    cards = torch.cuda.device_count()
    if cards >= 2:
        out[f"one group per card ({min(cards, N_SHARDS)})"] = [
            torch.device("cuda", i) for i in range(min(cards, N_SHARDS))]
    return out


def check_combine_groups(state: dict, groups: int) -> int:
    """``kernels.combine_groups`` against its plain version on the card at a
    grouped step's shape ([groups, 4] rows), the rows near the int32 edge
    so the sum wraps; returns the largest absolute difference."""
    base = {k: state[k] for k in ("transitions", "jobs_created", "completed")}
    rows = torch.randint(-2**31, 2**31 - 1, (groups, 4), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(groups)).to(base["completed"].device)
    rows[:, 3] = (rows[:, 3] > 0).to(torch.int32)
    return max_abs_err(kernels.combine_groups(rows, base), M.combine_groups_plain(rows, base))


def phase_mesh_groups(sharded: dict, dev, card: str) -> dict:
    """Phase 17: the sharded step (6 steps, the grouped state carried) and
    the runner's sharded collect (chunk by chunk with job waves, each chunk
    from the one-group run's state) at phase 6's geometry over every layout
    of ``group_layouts``, byte-equal to the one-group launch and to the plain
    version; the cross-group counter sum against its plain version; each
    layout's time per call beside the one-group time; then the graft entry:
    ``entry()`` byte-equal to its plain version and ``dryrun_multichip(8)``."""
    from zeebe_tpu_torch import graft_entry

    t_phase = time.perf_counter()
    dt, config = sharded["dt"], sharded["config"]
    one_step, one_collect = sharded["step"], sharded["collect"]
    state, sstate = sharded["state"], sharded["sstate"]
    tables = sharded["tables"]
    one_ms = {"step": time_ms(lambda: one_step(dt, sstate), 20),
              "collect": time_ms(lambda: one_collect(dt, state), 10)}
    out = {"layouts": {}, "one_ms": one_ms, "combine_err": 0}
    launches = {"combine_groups": 0, "sharded_step": 0, "sharded_collect": 0}

    def grouped(fn, *args):
        """``fn(*args)`` with the grouped path's launches counted from 0 and
        added to ``launches`` (comparison runs count nothing)."""
        A.reset_launch_counts()
        result = fn(*args)
        counts = {**A.launch_counts(), **A.group_launch_counts()}
        for key in launches:
            launches[key] += counts[key]
        return result

    for name, devices in group_layouts().items():
        mesh = M.make_mesh(N_SHARDS, devices=devices)
        out["combine_err"] = max(out["combine_err"], check_combine_groups(sstate, len(devices)))
        step = M.make_sharded_step(mesh, auto_jobs=True, config=config)
        gs, ks, ps = M.shard_state(sstate, mesh), sstate, sstate
        err = 0
        for _ in range(6):
            gs = grouped(step, dt, gs)
            ks = one_step(dt, ks)
            ps = M.sharded_step_plain(dt, ps, N_SHARDS, True, config)
            full = M.gather_state(gs)
            err = max(err, max_abs_err(full, M.gather_state(ks)),
                      max_abs_err(full, M.gather_state(ps)))
        collect = MR.MeshKernelRunner(mesh=mesh)._sharded_collect(8, config)
        dts = tuple(dt.to(d) for d in mesh.devices)
        cur = state
        for chunk in range(24):
            gstate, grows = grouped(collect, dts, M.shard_state(cur, mesh))
            ks, krows = one_collect(dt, cur)
            ps, prows = MR.sharded_collect_plain(dt, cur, 8, N_SHARDS, config)
            rows = torch.cat([r.to(dev) for r in grows], 1)
            full = M.gather_state(gstate)
            err = max(err, max_abs_err({"rows": rows}, {"rows": krows}),
                      max_abs_err({"rows": rows}, {"rows": prows}),
                      max_abs_err(full, M.gather_state(ks)), max_abs_err(full, M.gather_state(ps)))
            jobs = []
            T = state["elem"].shape[0] // N_SHARDS
            for s in range(N_SHARDS):
                jobs += (s * T + kb.parked_jobs(tables, shard_slice(ks, s))).tolist()
            # every shard's loop went quiet in this chunk (rows past a
            # shard's quiescence stay zero)
            quiet = bool((krows.view(8, N_SHARDS, -1)[:, :, -2] == 0).any(0).all())
            cur = A.complete_jobs(ks, jobs) if jobs else ks
            if not jobs and quiet:
                break
        if err:
            raise AssertionError(f"phase17 {name}: the grouped mesh differs from the one-group "
                                 f"launch or the plain version (max abs err {err})")
        gs0 = M.shard_state(sstate, mesh)
        gc0 = M.shard_state(state, mesh)
        out["layouts"][name] = {
            "groups": [(str(d), b) for d, b in mesh.groups], "chunks": chunk + 1,
            "step_ms": time_ms(lambda: step(dt, gs0), 20),
            "collect_ms": time_ms(lambda: collect(dts, gc0), 10)}
    if launches["combine_groups"] <= 0 or launches["sharded_collect"] <= 0 \
            or out["combine_err"]:
        raise AssertionError(f"phase17: the cross-group counter sum launched "
                             f"{launches['combine_groups']} times, max abs err "
                             f"{out['combine_err']}")
    out["launches"] = launches
    for name, lay in out["layouts"].items():
        log(f"phase17 mesh groups [{card}] {name} {lay['groups']}: 6 sharded steps and "
            f"{lay['chunks']} collect chunks with job waves byte-equal to the one-group launch "
            f"and the plain version; per call step {lay['step_ms']:.4f} ms (one group "
            f"{one_ms['step']:.4f}), collect chunk {lay['collect_ms']:.4f} ms (one group "
            f"{one_ms['collect']:.4f})")
    log(f"phase17 launches [{card}] of the grouped runs over the layouts (counted from 0 "
        f"around each grouped call; comparisons and timings not counted): combine_groups {launches['combine_groups']} (k_combine_groups, max abs "
        f"err against its plain version {out['combine_err']}), sharded_step "
        f"{launches['sharded_step']}, sharded_collect {launches['sharded_collect']}")

    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    got = fn(*args)
    cpu_fn, cpu_args = graft_entry.entry(device="cpu")
    err = max_abs_err(M.gather_state(got), cpu_fn(*cpu_args))
    if err or int(got["transitions"]) <= 0:
        raise AssertionError(f"phase17 entry(): max abs err {err} against the plain version, "
                             f"transitions {int(got['transitions'])}")
    ran = graft_entry.dryrun_multichip(N_SHARDS)
    out["graft"] = {"transitions": int(got["transitions"]), "layout": ran,
                    "seconds": time.perf_counter() - t0}
    log(f"phase17 graft entry [{card}]: entry() one step byte-equal to its plain version "
        f"(transitions {int(got['transitions'])}); dryrun_multichip({N_SHARDS}) OK on "
        f"{ran['groups']} groups on {', '.join(ran['cards'])}, blocks per group "
        f"{ran['blocks']}; {out['graft']['seconds']:.1f} s; phase {time.perf_counter() - t_phase:.1f} s")
    return out


#: phase 18's sizes: the small width every seed runs at, the chunks and
#: lock-steps each path runs at most, the seeds at the serving geometry and
#: through the kernel-backed harness, the instances per shard of a block of
#: 8 seeds, and the decision tables' random seeds and contexts
RANDOM_WIDTH = 64
RANDOM_CHUNKS = 12
RANDOM_STEPS = 32
RANDOM_SERVING = 8
RANDOM_HARNESS = 8
RANDOM_SHARD_WIDTH = 32
RANDOM_SHARD_STEPS = 4
RANDOM_TABLES = 50
RANDOM_CONTEXTS = 256


def random_layouts(dev) -> dict:
    """Phase 18's meshes of a block of 8 shards: one launch group on the
    card, and 2 groups on cuda:0."""
    return {"one group": [dev], "2 groups on cuda:0": [torch.device("cuda", 0)] * 2}


def random_harness(seeds: list[int]) -> dict:
    """Phase 18's kernel-backed harness: each seed's graph driven as the
    reference suite drives it, through the sequential engine and through the
    kernel backend on the card; the record logs must be equal."""
    out = {"seeds": 0, "records": 0, "commands": 0, "groups": 0}
    A.reset_launch_counts()
    for seed in seeds:
        graph = RG.build_seed(seed)
        logs = []
        for kernel in (False, True):
            reset_shared_device_health()
            h = EngineHarness(use_kernel_backend=kernel)
            try:
                graph.drive(h)
                logs.append(harness_log(h))
                if kernel:
                    out["commands"] += h.kernel_backend.commands_processed
                    out["groups"] += h.kernel_backend.groups_processed
            finally:
                h.close()
        if logs[0] != logs[1]:
            first = next((i for i, (a, b) in enumerate(zip(*logs)) if a != b),
                         min(map(len, logs)))
            raise AssertionError(f"phase18 harness seed {seed}: the kernel backend's log "
                                 f"differs from the sequential engine's at record {first} "
                                 f"({len(logs[0])} vs {len(logs[1])} records)")
        out["seeds"] += 1
        out["records"] += len(logs[0])
    out["launches"] = A.launch_counts()["run_collect"]
    if out["commands"] <= 0 or out["launches"] <= 0:
        raise AssertionError(f"phase18 harness: the kernel backend admitted {out['commands']} "
                             f"commands, k_chunk launched {out['launches']} times")
    return out


def random_decisions(dev) -> dict:
    """Phase 18's DMN: ``batch_evaluate`` on the card (the lanes kernel)
    against the host DecisionEngine, and on the same atoms both decision
    layouts against the plain version."""
    out = {"tables": 0, "contexts": 0, "inherited": 0}
    for case in RG.decision_cases(RANDOM_TABLES, RANDOM_CONTEXTS):
        table = D.compile_decision_table(case.decision)
        out["inherited"] += RG.check_against_host(
            case, D.batch_evaluate(table, case.contexts, device=dev))
        keys, valid = table.pack_contexts(case.contexts)
        atoms = [torch.from_numpy(a).to(dev) for a in (table.kind, table.lo, table.hi,
                                                        table.flags)]
        kk, vv = torch.from_numpy(keys).to(dev), torch.from_numpy(valid).to(dev)
        plain = D._evaluate_batch(*atoms, kk, vv)
        err = max(decision_err(kernels.run_decision(*atoms, kk, vv, kernel=k), plain)
                  for k in kernels.DECISION_KERNELS)
        if err:
            raise AssertionError(f"phase18 {case.label}: a decision kernel differs from "
                                 f"plain (max abs err {err})")
        out["tables"] += 1
        out["contexts"] += len(case.contexts)
    return out


def phase_random_graphs(dev, card: str) -> dict:
    """Phase 18: the generator's 120 random graphs through every kernel path
    against the plain version, at the small width (I = ``RANDOM_WIDTH``), and
    ``RANDOM_SERVING`` of them at the serving geometry (I = 2048); blocks of
    8 seeds as 8 shards (one launch group and 2 groups on cuda:0); the
    kernel-backed harness against the sequential engine; the DMN kernels.
    Launches here are comparisons: none is counted on the kernels line."""
    t_phase = time.perf_counter()
    seconds = {}
    counts = {"collect": {"chunks": 0, "steps": 0, "quiet_early": 0, "jobs": 0},
              "serving": {"chunks": 0, "steps": 0, "quiet_early": 0, "jobs": 0},
              "completion": {"runs": 0, "steps": 0}, "host_seeds": 0}

    def add(into: dict, got: dict) -> None:
        for k, v in got.items():
            into[k] += v

    t0 = time.perf_counter()
    for seed in RG.SEEDS:
        tables, dt, state = RG.seed_group(seed, RANDOM_WIDTH, dev)
        counts["host_seeds"] += RG.host_escapes(tables) > 0
        add(counts["collect"], RG.collect_paths(dt, tables, state, tables.kernel_config,
                                                RANDOM_CHUNKS, f"phase18 seed {seed} collect"))
        add(counts["completion"], RG.completion_paths(dt, state, tables.kernel_config,
                                                      RANDOM_STEPS,
                                                      f"phase18 seed {seed} completion"))
    seconds["small"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    serving_seeds = RG.spread(RANDOM_SERVING)
    for seed in serving_seeds:
        tables, dt, state = RG.seed_group(seed, 2048, dev)
        if kernels.choose_path(state["elem"].shape[0]) != "fused":
            raise AssertionError(f"phase18 seed {seed}: I=2048 does not take the fused chunk")
        add(counts["serving"], RG.collect_paths(dt, tables, state, tables.kernel_config,
                                                RANDOM_CHUNKS, f"phase18 seed {seed} at I=2048"))
    seconds["serving"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    layouts = random_layouts(dev)
    sharded = {"blocks": 0, "chunks": 0, "steps": 0}
    for start in range(0, len(RG.SEEDS), N_SHARDS):
        block = list(RG.SEEDS)[start:start + N_SHARDS]
        tables, dt, collect_state, step_state = RG.shard_block(block, RANDOM_SHARD_WIDTH, dev,
                                                               start)
        add(sharded, {"blocks": 1, **RG.sharded_paths(
            dt, tables, collect_state, step_state, tables.kernel_config, layouts,
            RANDOM_CHUNKS, RANDOM_SHARD_STEPS, f"phase18 seeds {block[0]}-{block[-1]}")})
    seconds["sharded"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    harness = random_harness(RG.spread(RANDOM_HARNESS))
    seconds["harness"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dmn = random_decisions(dev)
    seconds["dmn"] = time.perf_counter() - t0
    seconds["phase"] = time.perf_counter() - t_phase
    c, sv, cp = counts["collect"], counts["serving"], counts["completion"]
    log(f"phase18 random graphs [{card}]: {len(RG.SEEDS)} seeds of the reference generator, "
        f"{counts['host_seeds']} with a K_HOST element; run_collect at I={RANDOM_WIDTH}: "
        f"{c['chunks']} chunks, {c['steps']} lock-steps ({c['quiet_early']} chunks quiet "
        f"before their last step, {c['jobs']} jobs completed) on the fused chunk, the chain "
        f"and the plain version; at I=2048 (seeds {serving_seeds}): {sv['chunks']} chunks, "
        f"{sv['steps']} lock-steps ({sv['quiet_early']} quiet early); run_to_completion: "
        f"{cp['runs']} runs, {cp['steps']} steps on the grid kernel and the plain version "
        f"(max_steps {RANDOM_STEPS}, auto jobs on and off); sharded: {sharded['blocks']} "
        f"blocks of {N_SHARDS} seeds x I={RANDOM_SHARD_WIDTH} per shard, "
        f"{sharded['chunks']} collect chunks and {sharded['steps']} steps, each on "
        f"{len(layouts)} layouts ({', '.join(layouts)}); worst difference 0")
    log(f"phase18 harness [{card}]: seeds {RG.spread(RANDOM_HARNESS)}: {harness['records']} "
        f"records, the kernel backend's log equal to the sequential engine's "
        f"({harness['groups']} groups, {harness['commands']} commands on the kernel, "
        f"k_chunk {harness['launches']} launches); DMN: {dmn['tables']} tables, "
        f"{dmn['contexts']} contexts, batch_evaluate on the card equal to the host "
        f"engine but {dmn['inherited']} contexts of the reference's own difference "
        f"({RG.INHERITED_COUNT}), lanes and serial byte-equal to the plain version; "
        f"worst difference 0")
    log(f"phase18 seconds [{card}]: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return {"counts": counts, "sharded": sharded, "harness": harness, "dmn": dmn,
            "seconds": seconds}


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
    res = kernels.complete_resources()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"phase2 grid kernel: {res} on {sms} SMs (co-resident grid "
        f"{res['grid_blocks']} blocks); ptxas: {' | '.join(kernels.ptxas_report('k_complete'))}")
    if res["grid_blocks"] != min(res["blocks_per_sm"] * sms, kernels.GRID_MAX_BLOCKS):
        raise AssertionError("the grid kernel's grid is not the card's co-resident grid")
    log(f"phase2 decision lanes layout: ptxas: "
        f"{' | '.join(kernels.ptxas_report('k_decision_lanes'))}")

    worst = phase_kernel_vs_plain(rng, dev)
    slice_info = phase_slice(rng, dev, card)
    profiled = phase_profile(slice_info, dev, card)
    ceiling = phase_ceiling(dev, card)
    timing = serving_timings(slice_info)
    sharded = phase_sharded_vs_plain(rng, dev)
    mesh = phase_mesh_slice(rng, dev, card)
    phase_repeat(timing, mesh["geo"], card)
    ab = phase_ab(timing, mesh["geo"], slice_info, rng, dev, card)
    phase_fused_shapes(rng, dev, card)
    stiming = sharded_timings(sharded)
    timing.update(stiming)
    worst.update(sharded["worst"])
    decision = phase_decision(rng, dev, card)
    seam = phase_fault_seam(rng, dev, card, slice_info["tables"], slice_info["dt"])
    phase_telemetry(slice_info, dev, card)
    sequential = phase_engine(card)
    serving = phase_serving(card, sequential)
    cluster = phase_cluster(card, 600)
    runtime = phase_runtime(card, n_requests=300)
    front = phase_grpc(card, runtime, n_requests=300)
    phase_standalone(card, front)
    phase_gates(card)
    phase_mesh_groups(sharded, dev, card)
    phase_random_graphs(dev, card)
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
    log(f"decision timings [{card}] (lanes layout; serial in brackets): benchmark geometry "
        f"wrapper call {timing['decision']['ms']:.4f} [{timing['decision']['serial_ms']:.4f}] "
        f"ms, launches back to back {timing['decision']['device_ms']:.4f} ms, kernel by the "
        f"profiler {timing['decision']['profiled_ms']} [{timing['decision']['serial_profiled_ms']}] "
        f"ms (plain {timing['decision']['plain_ms']:.4f}, "
        f"bound {timing['decision']['bound_ms'] * 1e3:.3f} us by "
        f"{timing['decision']['bound_by']}); wide geometry wrapper call {wide['ms']:.4f} "
        f"[{wide['serial_ms']:.4f}] ms, back to back {wide['device_ms']:.4f} ms, profiler "
        f"{wide['profiled_ms']} [{wide['serial_profiled_ms']}] ms "
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
    # the cluster's path: the leaders' groups (phase 12, and any phase 14
    # group the mesh runner did not take), the partitions' groups through
    # the brokers' mesh runner (phase 12's mesh cluster, phase 13's runtime
    # and phase 14's gRPC front, each counted from 0)
    cluster_counts = {"run_collect": cluster["launches"] + front["run_collect_launches"],
                      "sharded_collect": cluster["mesh_launches"] + runtime["launches"]
                      + front["launches"]}
    for name, n in cluster_counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the cluster's path")
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
        if name == "run_to_completion":
            kernels_line[-1].update(step_ms=t["step_ms"], step_bound_ms=t["step_bound_ms"],
                                    chain_step_ms=t["chain_step_ms"], live_steps=t["steps"])
        if name == "run_collect":
            # k_chunk's launches on the serving write path (phase 11)
            kernels_line[-1].update(engine_launches=serving["launches"])
        if name in cluster_counts:
            # its launches on the replicated cluster (phase 12: the leaders'
            # groups; phases 13 and 14: the runtime's mesh runner), and of
            # those the gRPC front's (phase 14)
            kernels_line[-1].update(cluster_launches=cluster_counts[name],
                                    grpc_launches=front["launches"] if name == "sharded_collect"
                                    else front["run_collect_launches"])
        if name == "decision":
            kernels_line[-1].update(serial_ms=t["serial_ms"], profiled_ms=t["profiled_ms"],
                                    serial_profiled_ms=t["serial_profiled_ms"])
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
