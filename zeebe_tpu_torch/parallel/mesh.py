"""Mesh sharding: partitions = shards of the instance/token axis.

The counterpart of ``zeebe_tpu/parallel/mesh.py``. The reference scales by
hash-sharding process instances across partitions; a partition maps to a
shard of the device batch. Each shard owns a disjoint instance range and
its token pool, so the automaton step is embarrassingly parallel — the only
cross-shard traffic is the sum of the global counters.

The reference puts one shard on each device of a ``jax.sharding.Mesh``. The
port puts all ``n_shards`` shard blocks on one card: a ``Mesh`` here is a
shard count and the card that holds them, and every phase of the sharded
step is one kernel launch over all shard blocks (``csrc/automaton.cu``).
Each shard computes exactly what the reference's shard computes. Spreading
shards over several cards is later work.

State arrays shard on axis 0 (``state_specs``): shard s owns instance rows
[s*I/n, (s+1)*I/n) and the token block [s*T/n, (s+1)*T/n), with token
``inst`` values local to the block — ``make_state(num_shards=n)``'s layout.
Tables are replicated.
"""

from __future__ import annotations

import dataclasses

import torch

from zeebe_tpu_torch.ops import kernels
from zeebe_tpu_torch.ops.automaton import resolve_device, step_plain
from zeebe_tpu_torch.ops.tables import KernelConfig

#: the mesh's single axis: partitions = shards of the batch axis
BATCH_AXIS = "batch"

_SHARDED_KEYS = ("elem", "phase", "inst", "def_of", "var_slots", "join_counts",
                 "mi_left", "done", "incident")
_REPLICATED_KEYS = ("transitions", "jobs_created", "completed", "overflow")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_shards`` shard blocks on one device."""

    n_shards: int
    device: torch.device


def make_mesh(n_shards: int | None = None, device=None) -> Mesh:
    """A mesh of ``n_shards`` shards (default 1) on ``device`` (default the
    current CUDA card). Raises without CUDA unless the CPU is asked for, and
    for a card index beyond the cards that exist."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        available = torch.cuda.device_count()
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        if index >= available:
            # a mesh on a card that does not exist would place shard blocks
            # nowhere; the reference refuses a mesh larger than its devices
            raise ValueError(f"requested a mesh on cuda:{index} but only {available} "
                             "devices are available")
        dev = torch.device("cuda", index)
    n = 1 if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return Mesh(n, dev)


def state_specs() -> dict:
    """Which state keys shard on axis 0 (``BATCH_AXIS``) and which are
    replicated (``None``)."""
    specs = {k: BATCH_AXIS for k in _SHARDED_KEYS}
    specs.update({k: None for k in _REPLICATED_KEYS})
    return specs


def shard_state(state: dict, mesh: Mesh) -> dict:
    """Place a host-built state (numpy arrays or tensors, shard-block
    aligned: each shard's tokens reference only its own instances) on the
    mesh's device. Sharded keys must divide into ``mesh.n_shards`` blocks."""
    out = {}
    for key, spec in state_specs().items():
        value = torch.as_tensor(state[key])
        if spec is not None and value.shape[0] % mesh.n_shards:
            raise ValueError(f"{key} has {value.shape[0]} rows, not a multiple of "
                             f"{mesh.n_shards} shards")
        out[key] = value.to(mesh.device).contiguous()
    return out


def _shard_slices(state: dict, n_shards: int, s: int) -> dict:
    return {k: state[k].chunk(n_shards)[s] for k in _SHARDED_KEYS}


def sharded_step_plain(tables, state: dict, n_shards: int, auto_jobs: bool = True,
                       config=None) -> dict:
    """The plain version of the sharded step: ``step_plain`` on each shard's
    slice with the replicated counters, then each counter as the input plus
    the sum of the shards' deltas (int32, wrapping) and overflow as the OR
    of the shards' flags — the reference's psum."""
    outs = []
    for s in range(n_shards):
        local = _shard_slices(state, n_shards, s)
        local.update({k: state[k] for k in _REPLICATED_KEYS})
        new_local, _ = step_plain(tables, local, auto_jobs=auto_jobs, emit_events=False,
                                  config=config)
        outs.append(new_local)
    new_state = {k: torch.cat([o[k] for o in outs]) for k in _SHARDED_KEYS}
    for key in ("transitions", "jobs_created", "completed"):
        delta = torch.stack([o[key] - state[key] for o in outs]).sum().to(torch.int32)
        new_state[key] = state[key] + delta
    new_state["overflow"] = torch.stack([o["overflow"] for o in outs]).any()
    return new_state


def make_sharded_step(mesh: Mesh, auto_jobs: bool = True, config=None):
    """The sharded step: a callable ``(tables, state) → state`` advancing every
    shard one lock-step (no events), counters summed over shards. CPU tensors
    take ``sharded_step_plain``; CUDA tensors take the kernels (one launch per
    phase over all shards, then the counter combine)."""
    if config is None:
        config = KernelConfig()
    n = mesh.n_shards

    def sharded_step(tables, state: dict) -> dict:
        dev = state["elem"].device
        if dev.type == "cpu":
            return sharded_step_plain(tables, state, n, auto_jobs, config)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        return kernels.run_sharded_step(tables, state, n, config, auto_jobs)

    return sharded_step
