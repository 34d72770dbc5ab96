"""Mesh sharding: partitions = shards of the instance/token axis.

The counterpart of ``zeebe_tpu/parallel/mesh.py``. The reference scales by
hash-sharding process instances across partitions; a partition maps to a
shard of the device batch. Each shard owns a disjoint instance range and
its token pool, so the automaton step is embarrassingly parallel — the only
cross-shard traffic is the sum of the global counters.

The reference puts one shard on each device of a ``jax.sharding.Mesh``. The
port's ``Mesh`` is an ordered tuple of launch groups, each a device and a
contiguous run of shard blocks: every phase of the sharded step is one
kernel launch over a group's blocks (``csrc/automaton.cu``). Without
``devices`` a mesh is one group, every block on one card; with them the
blocks split contiguously over the listed devices, one group each, so a
host of several cards runs its groups at once. A device may appear in more
than one group: on one card the groups run one after another on its
stream. Each shard computes exactly what the reference's shard computes,
and the groups' counters are summed on the first group's card
(``combine_groups``, the reference's ``psum``).

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
    """Launch groups, each ``(device, blocks)``: a device and a contiguous
    run of shard blocks, in shard order."""

    groups: tuple[tuple[torch.device, int], ...]

    @property
    def n_shards(self) -> int:
        return sum(blocks for _, blocks in self.groups)

    @property
    def device(self) -> torch.device:
        """The first group's device: where the counters are summed, and the
        device a caller's replicated tables are placed on."""
        return self.groups[0][0]

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(dev for dev, _ in self.groups)

    def bounds(self) -> list[tuple[int, int]]:
        """Each group's shard range [start, stop)."""
        out, start = [], 0
        for _, blocks in self.groups:
            out.append((start, start + blocks))
            start += blocks
        return out


def _resolve(device) -> torch.device:
    """``device`` as the mesh holds it: a card with its index (the current
    card where none is named), or the CPU. Raises for a card index beyond
    the cards that exist."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    available = torch.cuda.device_count()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index >= available:
        # a mesh on a card that does not exist would place shard blocks
        # nowhere; the reference refuses a mesh larger than its devices
        raise ValueError(f"requested a mesh on cuda:{index} but only {available} "
                         "devices are available")
    return torch.device("cuda", index)


def make_mesh(n_shards: int | None = None, device=None, devices=None) -> Mesh:
    """A mesh of ``n_shards`` shards. Without ``devices``: one group, every
    block on ``device`` (default the current CUDA card). With ``devices``
    (default ``n_shards`` = one block each): the blocks split contiguously
    over them, one group per listed device, the first groups one block
    larger where the split is uneven; a device may repeat. Raises without
    CUDA unless the CPU is asked for, for a card index beyond the cards
    that exist, for more devices than shards and for a mix of CPU and
    CUDA."""
    if devices is None:
        devs = [_resolve(device)]
    else:
        if device is not None:
            raise ValueError("pass device or devices, not both")
        devs = [_resolve(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) > 1:
            raise ValueError("a mesh cannot mix CPU and CUDA devices")
    if n_shards is None:
        n = 1 if devices is None else len(devs)
    else:
        n = int(n_shards)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    if len(devs) > n:
        raise ValueError(f"{len(devs)} devices for {n} shards: a group needs a block")
    base, extra = divmod(n, len(devs))
    return Mesh(tuple((dev, base + (g < extra)) for g, dev in enumerate(devs)))


def card_mesh(n_shards: int | None = None, device=None) -> Mesh:
    """The serving layout of ``n_shards`` blocks: on a host of two or more
    cards, with ``device`` the bare CUDA device (None or ``"cuda"``), one
    group per card over the first ``min(cards, n_shards)`` cards; else one
    group on ``device`` (a named card, or the CPU)."""
    dev = resolve_device(device)
    n = 1 if n_shards is None else int(n_shards)
    if dev.type == "cuda" and dev.index is None:
        cards = min(torch.cuda.device_count(), n)
        if cards >= 2:
            return make_mesh(n, devices=[torch.device("cuda", i) for i in range(cards)])
    return make_mesh(n, dev)


def state_specs() -> dict:
    """Which state keys shard on axis 0 (``BATCH_AXIS``) and which are
    replicated (``None``)."""
    specs = {k: BATCH_AXIS for k in _SHARDED_KEYS}
    specs.update({k: None for k in _REPLICATED_KEYS})
    return specs


def shard_state(state: dict, mesh: Mesh):
    """Place a host-built state (numpy arrays or tensors, shard-block
    aligned: each shard's tokens reference only its own instances) on the
    mesh. Sharded keys must divide into ``mesh.n_shards`` blocks. A mesh of
    one group gives one state dict on its device; a mesh of several gives a
    tuple of state dicts, one per group on the group's device: its blocks'
    rows, and the counters replicated (0-d) or, where they are per-shard
    rows ``[n_shards]``, the group's own rows."""
    n = mesh.n_shards
    full = {}
    for key, spec in state_specs().items():
        value = torch.as_tensor(state[key])
        if spec is not None and value.shape[0] % n:
            raise ValueError(f"{key} has {value.shape[0]} rows, not a multiple of "
                             f"{n} shards")
        if spec is None and value.dim() == 1 and value.shape[0] != n:
            raise ValueError(f"{key} has {value.shape[0]} per-shard rows for {n} shards")
        full[key] = value
    if len(mesh.groups) == 1:
        return {k: v.to(mesh.device).contiguous() for k, v in full.items()}
    out = []
    for (dev, _), (start, stop) in zip(mesh.groups, mesh.bounds()):
        group = {}
        for key, value in full.items():
            if state_specs()[key] is not None or value.dim() == 1:
                rows = value.shape[0] // n
                value = value[start * rows:stop * rows]
            group[key] = value.to(dev).contiguous()
        out.append(group)
    return tuple(out)


def gather_state(state) -> dict:
    """A mesh's state on the CPU in shard order: a one-group state's
    tensors, or a grouped state's groups joined (counters replicated over
    the groups taken from the first, per-shard counter rows joined)."""
    if isinstance(state, dict):
        return {k: v.cpu() for k, v in state.items()}
    out = {k: torch.cat([g[k].cpu() for g in state]) for k in _SHARDED_KEYS}
    for key in _REPLICATED_KEYS:
        first = state[0][key]
        out[key] = (first.cpu() if first.dim() == 0
                    else torch.cat([g[key].cpu() for g in state]))
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


def combine_groups_plain(rows: torch.Tensor, base: dict) -> dict:
    """The plain version of the cross-group counter sum (``kernels.
    combine_groups``): rows [G, 4] int32 of each group's counters after its
    step, ``base`` the input counters; the input plus the sum of the
    groups' deltas (wrapping int32) and the OR of the flags."""
    out = {}
    for col, key in enumerate(("transitions", "jobs_created", "completed")):
        delta = (rows[:, col] - base[key]).sum().to(torch.int32)
        out[key] = base[key] + delta
    out["overflow"] = (rows[:, 3] != 0).any()
    return out


def combine_groups(outs: list[dict], base: dict, device: torch.device) -> dict:
    """The groups' counters summed on ``device`` (the first group's): each
    group's four counters as a row, gathered there by peer copies into
    [G, 4] int32, then the kernel (the plain version on the CPU)."""
    rows = torch.stack([
        torch.stack([o["transitions"], o["jobs_created"], o["completed"],
                     o["overflow"].to(torch.int32)]).to(device, non_blocking=True)
        for o in outs])
    if device.type == "cpu":
        return combine_groups_plain(rows, base)
    return kernels.combine_groups(rows, base)


def make_sharded_step(mesh: Mesh, auto_jobs: bool = True, config=None):
    """The sharded step: a callable ``(tables, state) → state`` advancing every
    shard one lock-step (no events), counters summed over shards. CPU tensors
    take ``sharded_step_plain``; CUDA tensors take the kernels (one launch per
    phase over a group's blocks, then the counter combine). On a mesh of
    several groups the state is ``shard_state``'s tuple: every group is
    enqueued, each on its card's current stream, before the groups'
    counters are summed on the first group's card and copied back to every
    group's card, replicated as the reference's psum leaves them."""
    if config is None:
        config = KernelConfig()

    def group_step(tables, state: dict, blocks: int) -> dict:
        dev = state["elem"].device
        if dev.type == "cpu":
            return sharded_step_plain(tables, state, blocks, auto_jobs, config)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        return kernels.run_sharded_step(tables, state, blocks, config, auto_jobs)

    if len(mesh.groups) == 1:
        n = mesh.n_shards
        return lambda tables, state: group_step(tables, state, n)

    replicas: dict = {}

    def tables_on(tables, dev):
        key = (id(tables), dev)
        held = replicas.get(key)
        if held is None or held[0] is not tables:
            held = replicas[key] = (tables, tables.to(dev))
        return held[1]

    def grouped_step(tables, state) -> tuple:
        if len(state) != len(mesh.groups):
            raise ValueError(f"a state of {len(state)} groups on a mesh of "
                             f"{len(mesh.groups)}")
        outs = [group_step(tables_on(tables, dev), st, blocks)
                for (dev, blocks), st in zip(mesh.groups, state)]
        first = mesh.device
        summed = combine_groups(outs, state[0], first)
        for out, (dev, _) in zip(outs, mesh.groups):
            out.update({k: v.to(dev, non_blocking=True) for k, v in summed.items()})
        return tuple(outs)

    return grouped_step
