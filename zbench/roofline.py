"""The bytes an automaton kernel call must move and the least time the card
needs for them: a frozen copy of ``chip_smoke.py``'s ``moved_bytes`` and
``bound_ms`` (with ``nbytes`` and the tables they read), kept with the
benchmark so that a kernel's roofline share reads the same bytes whatever
implements the kernel. No metric reads it yet: a share needs each launch's
group geometry from the program, which no counter gives today."""

from __future__ import annotations

#: published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12

# What one call must move, by KernelConfig flag (the step reads and writes
# these arrays only under the flag; without it the array is neither read
# nor returned changed).
TABLES_ALWAYS = ("kernel_op", "out_count", "out_target", "default_slot")
TABLES_BY_FLAG = {"has_conditions": ("out_cond", "cond_ops", "cond_args"),
                  "has_joins": ("in_count",),
                  "has_scopes": ("in_scope", "scope_start"),
                  "has_mi": ("in_scope", "scope_start", "mi_sequential")}
STATE_READ = ("elem", "phase", "inst", "def_of", "done", "incident", "join_counts",
              "transitions", "jobs_created", "completed", "overflow")
STATE_WRITTEN = ("elem", "phase", "inst", "done", "incident", "transitions",
                 "jobs_created", "completed", "overflow")


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
