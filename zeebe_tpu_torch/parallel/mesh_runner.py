"""MeshKernelRunner: N partitions' admitted groups in one sharded dispatch.

The counterpart of ``zeebe_tpu/parallel/mesh_runner.py``. The reference
scales horizontally by adding partitions; here a partition is a shard of the
device batch. Each partition builds its group arrays exactly as for the
single-device path; the runner packs up to ``n_shards`` groups into one
shard-block-aligned batch, runs ONE sharded chunked run_collect program (all
shard blocks on one card, one kernel launch per phase, per-shard event rows
side by side on axis 1), and hands each partition back its own per-step
events.

Determinism: shards never interact — a group's step events are a pure
function of its own arrays, so a partition's events are byte-identical
whether its group dispatched alone or coalesced with others. Quiescence and
overflow tails stay per shard for the same reason: one partition
overflowing does not mark the partitions dispatched with it.

Thread model: partition threads call ``submit()``; the first submitter
becomes the dispatch leader, drains the queue (coalescing whatever other
partitions enqueued while the device was busy), and wakes the waiters. The
leader blocks on each chunk's packed rows arriving in pinned host memory.
``run_groups()`` underneath is the deterministic, synchronous seam.

Beyond the reference, a ``GroupResult`` carries its group's state after the
run (host arrays of the dispatch's geometry): the port has no engine state
yet to rebuild the next wave's arrays from (ROADMAP A3).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from zeebe_tpu_torch.ops import kernels
from zeebe_tpu_torch.ops.automaton import run_collect_plain, unpack_events
from zeebe_tpu_torch.parallel.mesh import (
    _REPLICATED_KEYS,
    _SHARDED_KEYS,
    _shard_slices,
    make_mesh,
    shard_state,
)


@dataclass
class GroupRequest:
    """One partition's admitted group, in host (numpy) form.

    Arrays use the group's natural geometry (I, T); the runner pads to the
    dispatch's common geometry. ``tables_fingerprint`` gates coalescing:
    only groups compiled from identical table sets may share a dispatch
    (the sharded program takes ONE replicated DeviceTables argument)."""

    device_tables: Any  # DeviceTables on the mesh's device (replicated input)
    config: Any  # KernelConfig
    tables_fingerprint: Any
    arrays: dict[str, np.ndarray]  # elem/phase/inst/def_of/var_slots/join_counts/mi_left/done
    num_instances: int  # I (padded bucket size)
    num_tokens: int  # T
    max_steps: int
    chunk_steps: int


@dataclass
class GroupResult:
    steps: list | None  # per-step unpacked event dicts; None → the dispatch failed
    overflow: bool = False
    quiesced: bool = True
    # the group's state after its last chunk: host arrays of the dispatch's
    # geometry, counters as 0-d arrays (None when the dispatch failed)
    state: dict | None = None


@dataclass
class _Waiter:
    request: GroupRequest
    event: threading.Event = field(default_factory=threading.Event)
    result: GroupResult | None = None


def _pad_axis0(a: np.ndarray, n: int, fill) -> np.ndarray:
    if a.shape[0] == n:
        return a
    out = np.full((n, *a.shape[1:]), fill, a.dtype)
    out[: a.shape[0]] = a
    return out


def sharded_collect_plain(tables, state: dict, n_steps: int, n_shards: int, config=None):
    """The plain version of the sharded collect: ``run_collect_plain`` on each
    shard's slice, with that shard's counters (``state[name][s]``). Returns
    (state', packed): counters as length-``n_shards`` rows and packed rows
    [n_steps, n_shards * row_len], shard s at columns [s*row_len,
    (s+1)*row_len)."""
    outs, rows = [], []
    for s in range(n_shards):
        local = _shard_slices(state, n_shards, s)
        local.update({k: state[k][s] for k in _REPLICATED_KEYS})
        new_local, packed = run_collect_plain(tables, local, n_steps=n_steps, config=config)
        outs.append(new_local)
        rows.append(packed)
    new_state = {k: torch.cat([o[k] for o in outs]) for k in _SHARDED_KEYS}
    new_state.update({k: torch.stack([o[k] for o in outs]) for k in _REPLICATED_KEYS})
    return new_state, torch.cat(rows, 1)


def stack_requests(requests: list[GroupRequest], n_shards: int):
    """One dispatch's shard-block-aligned host state: each request's arrays
    padded to the common geometry (the largest bucket of the batch), then
    all-done padding shards up to ``n_shards``; counters as per-shard rows
    of zeros. Returns (arrays, I_c, T_c), I_c and T_c per shard."""
    I_c = max(r.num_instances for r in requests)
    T_c = max(r.num_tokens for r in requests)

    def shard_arrays(name, fill):
        n = T_c if name in ("elem", "phase", "inst") else I_c
        blocks = [_pad_axis0(r.arrays[name], n, fill) for r in requests]
        while len(blocks) < n_shards:
            blocks.append(np.full_like(blocks[0], fill))
        return np.concatenate(blocks, axis=0)

    S = n_shards
    host = {
        "elem": shard_arrays("elem", -1),
        "phase": shard_arrays("phase", 0),
        "inst": shard_arrays("inst", 0),
        "def_of": shard_arrays("def_of", 0),
        "var_slots": shard_arrays("var_slots", 0),
        "join_counts": shard_arrays("join_counts", 0),
        "mi_left": shard_arrays("mi_left", 0),
        # padding instances are done upfront so they never report newly_done
        "done": shard_arrays("done", True),
        "incident": np.zeros(S * I_c, np.bool_),
        # counters and overflow are per-shard rows (not summed: a
        # partition's overflow must fall back alone)
        "transitions": np.zeros(S, np.int32),
        "jobs_created": np.zeros(S, np.int32),
        "completed": np.zeros(S, np.int32),
        "overflow": np.zeros(S, np.bool_),
    }
    return host, I_c, T_c


class MeshKernelRunner:
    """Shared device-dispatch point for up to ``n_shards`` partitions."""

    def __init__(self, n_shards: int | None = None, mesh=None,
                 batch_window_s: float = 0.0, adaptive_window: bool = False) -> None:
        self.mesh = mesh if mesh is not None else make_mesh(n_shards)
        self.n_shards = self.mesh.n_shards
        # > 0: the dispatch leader waits this long before draining the queue,
        # trading a little latency for more coalescing (tests use it to make
        # multi-thread coalescing deterministic)
        self.batch_window_s = batch_window_s
        # adaptive gate: sleep the window only while recent drains observed a
        # backlog (the dispatch queue non-empty when one finished), so an
        # idle runner's window disables itself. Off by default: a window
        # alone keeps its always-sleep contract.
        self.adaptive_window = adaptive_window
        self._recent_backlog = False
        self._lock = threading.Lock()
        self._queue: list[_Waiter] = []
        self._leader_active = False
        # observability (tests assert coalescing happened)
        self.dispatches = 0
        self.groups_dispatched = 0
        self.coalesced_dispatches = 0
        self.windows_slept = 0
        self.windows_skipped = 0

    # -- the deterministic core: one sharded dispatch per compatible batch --

    def run_groups(self, requests: list[GroupRequest]) -> list[GroupResult]:
        """Execute every request; requests sharing a tables fingerprint ride
        one sharded dispatch (up to n_shards per dispatch)."""
        results: list[GroupResult | None] = [None] * len(requests)
        by_tables: dict[Any, list[int]] = {}
        for i, req in enumerate(requests):
            by_tables.setdefault(req.tables_fingerprint, []).append(i)
        for indices in by_tables.values():
            for start in range(0, len(indices), self.n_shards):
                batch = indices[start : start + self.n_shards]
                outs = self._dispatch([requests[i] for i in batch])
                for i, out in zip(batch, outs):
                    results[i] = out
        return results  # type: ignore[return-value]

    def _dispatch(self, requests: list[GroupRequest]) -> list[GroupResult]:
        self.dispatches += 1
        self.groups_dispatched += len(requests)
        if len(requests) > 1:
            self.coalesced_dispatches += 1
        S = self.n_shards
        host, I_c, T_c = stack_requests(requests, S)
        chunk = max(r.chunk_steps for r in requests)
        max_steps = max(r.max_steps for r in requests)
        lead = requests[0]
        state = shard_state(host, self.mesh)

        collect = self._sharded_collect(chunk, lead.config)
        FO = lead.device_tables.out_target.shape[2]
        row_len = T_c * (2 + FO) + 2
        n_req = len(requests)
        steps_per: list[list] = [[] for _ in range(n_req)]
        quiesced = [False] * n_req
        overflow = [False] * n_req
        for _ in range(max(1, max_steps // chunk)):
            state, packed = collect(lead.device_tables, state)
            flat = _fetch(packed)  # [chunk, S*row_len]
            for ri in range(n_req):
                if quiesced[ri]:
                    continue
                block = flat[:, ri * row_len : (ri + 1) * row_len]
                events = block[:, :-2].reshape(chunk, T_c, 2 + FO)
                active = block[:, -2]
                # overflow is cumulative in device state; the early-exit loop
                # leaves rows past quiescence as zeros, so any written row
                # carrying the bit is the signal
                overflow[ri] = overflow[ri] or bool(block[:, -1].any())
                qs = np.flatnonzero(active == 0)
                keep = int(qs[0]) + 1 if qs.size else chunk
                for s in range(keep):
                    steps_per[ri].append(unpack_events(events[s], I_c))
                if qs.size:
                    quiesced[ri] = True
            if all(quiesced):
                break
        final = {k: v.cpu().numpy() for k, v in state.items()}
        return [
            GroupResult(steps=steps_per[ri], overflow=overflow[ri],
                        quiesced=quiesced[ri], state=_block(final, ri, S))
            for ri in range(n_req)
        ]

    def _sharded_collect(self, n_steps: int, config):
        """The sharded chunk program ``(tables, state) → (state', packed)``:
        CPU tensors take ``sharded_collect_plain``; CUDA tensors take the
        kernels, one launch per phase over all shards."""
        S = self.n_shards

        def collect(dt, state):
            dev = state["elem"].device
            if dev.type == "cpu":
                return sharded_collect_plain(dt, state, n_steps, S, config)
            if dev.type != "cuda":
                raise ValueError(f"unsupported device {dev}")
            return kernels.run_steps(dt, state, n_steps=n_steps, config=config,
                                     auto_jobs=False, emit_events=True,
                                     mode="collect", num_shards=S, sharded=True)

        return collect

    # -- thread-safe opportunistic batching ---------------------------------

    def submit(self, request: GroupRequest) -> GroupResult:
        """Execute one group, coalescing with other threads' concurrently
        pending groups. The first submitter leads: it drains the queue (one
        sharded dispatch per compatible batch) until empty, then hands off."""
        waiter = _Waiter(request)
        with self._lock:
            self._queue.append(waiter)
            if self._leader_active:
                lead = False
            else:
                self._leader_active = True
                lead = True
        if not lead:
            waiter.event.wait()
            assert waiter.result is not None
            return waiter.result
        batch: list[_Waiter] = []
        try:
            if self.batch_window_s > 0:
                if not self.adaptive_window or self._recent_backlog:
                    self.windows_slept += 1
                    time.sleep(self.batch_window_s)
                else:
                    self.windows_skipped += 1
            while True:
                with self._lock:
                    batch = self._queue
                    self._queue = []
                    if not batch:
                        self._leader_active = False
                        break
                results = self.run_groups([w.request for w in batch])
                with self._lock:
                    # device occupancy signal: others queued while we ran
                    self._recent_backlog = bool(self._queue)
                for w, res in zip(batch, results):
                    w.result = res
                    w.event.set()
        except BaseException:
            # wake EVERY waiter this leader was responsible for — the popped
            # batch and anything still queued — with a failed result so no
            # partition thread hangs, then re-raise
            with self._lock:
                stranded = batch + self._queue
                self._queue = []
                self._leader_active = False
            for w in stranded:
                if w.result is None:
                    w.result = GroupResult(steps=None)
                    w.event.set()
            if waiter.result is None:
                waiter.result = GroupResult(steps=None)
                waiter.event.set()
            raise
        assert waiter.result is not None
        return waiter.result


def _fetch(packed: torch.Tensor) -> np.ndarray:
    """A chunk's packed rows on the host. On CUDA the rows are copied into
    pinned host memory behind the chunk on the stream, and the leader blocks
    on that copy alone."""
    if not packed.is_cuda:
        return packed.numpy()
    rows = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    rows.copy_(packed, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    ready.synchronize()
    return rows.numpy()


def _block(final: dict, s: int, n_shards: int) -> dict:
    """Shard s's part of a dispatch's final host state."""
    out = {k: np.array_split(final[k], n_shards)[s].copy() for k in _SHARDED_KEYS}
    out.update({k: final[k][s] for k in _REPLICATED_KEYS})
    return out
