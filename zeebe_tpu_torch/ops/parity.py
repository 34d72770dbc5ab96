"""Host-side decoding of device step events → per-instance intent sequences.

The parity oracle between the automaton and the sequential engine: within
an instance the order of lifecycle events is identical to one-at-a-time
processing; across instances the device's slot order replaces the log's
arrival order. (The reference module's ``engine_intent_sequence`` reads the
sequential engine's exporter, which this package does not carry; the tests
take it from the reference.)
"""

from __future__ import annotations

import numpy as np
import torch

from zeebe_tpu_torch.ops.tables import ProcessTables


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def decode_step_events(tables: ProcessTables, state_before: dict,
                       events: dict) -> dict[int, list[tuple[str, str]]]:
    """Decode one step's event masks into {instance: [(element_id, intent)]}:
    element lifecycle events first, then the instance's taken flows."""
    out: dict[int, list[tuple[str, str]]] = {}
    elem = _np(events["elem"])
    inst = _np(events["inst"])
    def_of = _np(state_before["def_of"])
    full_pass = _np(events["full_pass"])
    task_arrive = _np(events["task_arrive"])
    task_done = _np(events["task_done"])
    take_mask = _np(events["take_mask"])
    newly_done = _np(events["newly_done"])

    def emit(i: int, element_id: str, *intents: str) -> None:
        out.setdefault(i, []).extend((element_id, intent) for intent in intents)

    for t in range(elem.shape[0]):
        e = elem[t]
        if e < 0:
            continue
        i = int(inst[t])
        d = int(def_of[i])
        exe = tables.definitions[d]
        element = exe.elements[int(e)]
        if task_arrive[t]:
            emit(i, element.id, "ELEMENT_ACTIVATING", "ELEMENT_ACTIVATED", "JOB_CREATED")
        elif task_done[t]:
            emit(i, element.id, "JOB_COMPLETED", "ELEMENT_COMPLETING", "ELEMENT_COMPLETED")
        elif full_pass[t]:
            emit(
                i, element.id,
                "ELEMENT_ACTIVATING", "ELEMENT_ACTIVATED",
                "ELEMENT_COMPLETING", "ELEMENT_COMPLETED",
            )
        for s in range(take_mask.shape[1]):
            if take_mask[t, s]:
                fidx = int(tables.out_flow_idx[d, int(e), s])
                if fidx < 0:
                    continue  # synthetic link-jump edge: no sequence flow
                emit(i, exe.flows[fidx].id, "SEQUENCE_FLOW_TAKEN")
    for i in np.nonzero(newly_done)[0]:
        d = int(def_of[i])
        exe = tables.definitions[d]
        emit(int(i), exe.process_id, "ELEMENT_COMPLETING", "ELEMENT_COMPLETED")
    return out


def run_with_events(dt, tables: ProcessTables, state: dict, max_steps: int = 200,
                    auto_jobs: bool = True):
    """Step until quiescent, collecting decoded events per instance."""
    from zeebe_tpu_torch.ops.automaton import step

    sequences: dict[int, list[tuple[str, str]]] = {}
    for _ in range(max_steps):
        if not bool((state["elem"] >= 0).any()):
            break
        before = state
        state, events = step(dt, state, auto_jobs=auto_jobs, emit_events=True)
        decoded = decode_step_events(tables, before, events)
        for i, evs in decoded.items():
            sequences.setdefault(i, []).extend(evs)
    return state, sequences
