"""Charging the card's idle time to the host layers (``zbench/attribution.py``)
and the span readers: the parts sum to the idle time, the latest start
wins, an uncovered stretch is unattributed, a gap's label keeps its layer
under the ledger's 64-character cut, a window that lost spans reads
nothing, ``kernel_roofline_pct`` is ``roofline.bound_ms`` over the kernels'
time, and a traced run with the program's tracer on (``spans_run.py``) on
the CPU."""

import ast
import dataclasses
import inspect
import random
import textwrap

import pytest
import torch

from zbench import attribution as AT
from zbench import cells, drive, roofline
from zbench import run as zrun
from zbench import spans_run
from zbench.trace import reduce
from zbench.window import Window
from zeebe_tpu_torch.observability.span import Span

BASE_US = 1_790_000_000_000_000


def span(name: str, start: float, dur: float) -> Span:
    """A span ``start`` us after the trace's base."""
    return Span("t", name, BASE_US + int(start), int(dur))


def kernel(start: float, dur: float, name: str = "k_chunk") -> dict:
    return {"ph": "X", "cat": "kernel", "name": name, "ts": start, "dur": dur}


def window(spans, events, opened=0.0, closed=10_000.0, evicted=0, geometry=()):
    return AT.SpanWindow(list(spans), evicted, BASE_US + opened, BASE_US + closed,
                         base_us=BASE_US, device_events=list(events), geometry=list(geometry))


def test_the_parts_sum_to_the_idle_time():
    rng = random.Random(5)
    names = ["journal.flush", "raft.replicate", "processor.stage.decode",
             "processor.stage.device", "gateway.request", "gateway.partition_lock",
             "runtime.gc", "processor.kernel_group", "exporter.export", "processor.ack"]
    spans = [span(rng.choice(names), rng.uniform(-500, 10_000), rng.uniform(1, 2_000))
             for _ in range(400)]
    events = [kernel(rng.uniform(0, 10_000), rng.uniform(1, 300)) for _ in range(60)]
    charged = AT.attribute(window(spans, events))
    busy = reduce(events, 0.01)["busy_s"] * 1e6
    assert charged["idle_us"] == pytest.approx(10_000 - busy, rel=1e-9)
    assert sum(charged["by_layer"].values()) == pytest.approx(charged["idle_us"], rel=1e-3)
    assert sum(charged["by_span"].values()) == pytest.approx(charged["idle_us"], rel=1e-3)
    assert set(charged["by_layer"]) == set(AT.PARTS)


def test_the_latest_start_wins():
    spans = [span("gateway.request", 0, 1_000), span("raft.replicate", 100, 800),
             span("journal.flush", 300, 100), span("processor.stage.decode", 600, 50),
             span("processor.stage.device", 600, 20)]
    charged = AT.attribute(window(spans, [kernel(1_000, 9_000)], closed=10_000))
    assert charged["by_span"] == pytest.approx({
        "gateway.request": 100 + 100, "raft.replicate": 200 + 200 + 250,
        "journal.flush": 100, "processor.stage.device": 20, "processor.stage.decode": 30,
    })
    assert charged["by_layer"]["journal"] == pytest.approx(750)
    assert charged["by_layer"]["device_loop"] == pytest.approx(20)


def test_a_stretch_no_span_covers_is_unattributed():
    spans = [span("journal.flush", 100, 100), span("processor.ack", 0, 5_000)]
    charged = AT.attribute(window(spans, [kernel(1_000, 100)], closed=2_000))
    assert charged["by_layer"][AT.UNATTRIBUTED] == pytest.approx(1_900 - 100)
    assert charged["by_layer"]["journal"] == pytest.approx(100)
    assert charged["gaps"] == []  # one device operation: no gap between two


def test_the_gaps_are_the_traces_with_the_layer_in_front():
    events = [kernel(0, 10), kernel(500, 10, "k_steps"), kernel(2_000, 10),
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)",
               "ts": 2_010, "dur": 5}, kernel(2_600, 10)]
    spans = [span("journal.flush", 600, 1_000), span("runtime.gc", 2_100, 100)]
    charged = AT.attribute(window(spans, events, closed=3_000))
    traced = reduce(events, 0.003)["gaps"]
    assert [seconds for _, seconds in charged["gaps"]] == [seconds for _, seconds in traced]
    for (label, _), (plain, _) in zip(charged["gaps"], traced):
        assert label.endswith(f" | {plain}")
    assert charged["gaps"][0][0].startswith("journal:journal.flush | after k_steps")
    assert charged["gaps"][1][0].startswith("unattributed | after Memcpy")  # 485 of 585 us
    assert charged["gaps"][2][0].startswith("unattributed | after k_chunk")


@pytest.mark.parametrize("layer,name", [("journal", "journal.flush"),
                                        ("processor", "processor.stage.materialize"),
                                        ("gateway", "gateway.partition_lock"),
                                        (AT.UNATTRIBUTED, AT.UNATTRIBUTED)])
def test_a_labels_layer_survives_the_ledgers_cut(layer, name):
    label = AT.gap_label(layer, name, "after Memcpy DtoH (Device -> Pageable) before "
                                      "Memcpy HtoD (Pageable -> Device)")
    assert label[:64].startswith(f"{layer}:{name} | " if layer != AT.UNATTRIBUTED
                                 else f"{AT.UNATTRIBUTED} | ")
    assert label[:64].split(":")[0].split(" ")[0] in AT.PARTS


def _window(instances=4, trace=None):
    return Window(10.0, {}, {}, trace=trace, e2e={"instances": instances})


def test_every_reader_reads_nothing_when_spans_were_evicted():
    spans = [span("raft.replicate", 100, 50), span("gateway.partition_lock", 10, 5)]
    events = [kernel(0, 10)]
    trace = {"ops": {"k_chunk": [1e-5, 1]}, "busy_s": 1e-5, "window_s": 0.01, "gaps": []}
    geometry = [_geometry()[0]]
    whole = window(spans, events, geometry=geometry)
    lost = dataclasses.replace(whole, evicted=3)
    read = {name: reader(_window(trace=trace), whole) for name, reader in AT.READERS.items()}
    assert all(value is not None for value in read.values()), read
    assert read["commit_wait_ms"] == pytest.approx(0.05)
    assert read["submit_lock_wait_ms"] == pytest.approx(0.005)
    for name, reader in AT.READERS.items():
        assert reader(_window(trace=trace), lost) is None, name
        assert reader(_window(trace=trace), None) is None, name


def _geometry():
    """A hand-made call geometry: tensors, and their record as
    ``automaton.geometry_counts`` gives it."""
    from zeebe_tpu_torch.ops import kernels
    from zeebe_tpu_torch.ops.tables import KernelConfig

    D, E, FO, C, T, I = 2, 9, 3, 4, 512, 128
    i32, i8 = torch.int32, torch.int8
    shapes = {"kernel_op": (i32, (D, E)), "in_count": (i32, (D, E)),
              "out_count": (i32, (D, E)), "out_target": (i32, (D, E, FO)),
              "out_cond": (i32, (D, E, FO)), "default_slot": (i32, (D, E)),
              "scope_start": (i32, (D, E)), "in_scope": (i8, (D, E, E)),
              "mi_sequential": (i8, (D, E)), "cond_ops": (i32, (C, 24)),
              "cond_args": (i32, (C, 24, 2))}
    dt = type("DT", (), {n: torch.zeros(s, dtype=d) for n, (d, s) in shapes.items()})()
    state = {"elem": torch.zeros(T, dtype=i32), "phase": torch.zeros(T, dtype=i32),
             "inst": torch.zeros(T, dtype=i32), "def_of": torch.zeros(I, dtype=i32),
             "var_slots": torch.zeros((I, 5, 2), dtype=i32),
             "join_counts": torch.zeros((I, E), dtype=i32),
             "mi_left": torch.zeros((I, E), dtype=i32), "done": torch.zeros(I, dtype=torch.bool),
             "incident": torch.zeros(I, dtype=torch.bool),
             "transitions": torch.zeros((), dtype=i32), "jobs_created": torch.zeros((), dtype=i32),
             "completed": torch.zeros((), dtype=i32), "overflow": torch.zeros((), dtype=torch.bool)}
    config = KernelConfig(has_conditions=True, has_joins=True)
    out_bytes = 8 * (T * (2 + FO) + 2) * 4
    record = {"path": "fused",
              "flags": {f: getattr(config, f) for f in kernels.GEOMETRY_FLAGS},
              "tables": {n: getattr(dt, n).numel() * getattr(dt, n).element_size()
                         for n in kernels._TABLE_SPEC},
              "state": {n: state[n].numel() * state[n].element_size()
                        for n in kernels._STATE_PTRS},
              "out_bytes": out_bytes, "calls": 3}
    return record, dt, state, config, out_bytes


def test_the_roofline_share_is_the_bound_over_the_kernels_time():
    record, dt, state, config, out_bytes = _geometry()
    assert AT.bound_ms(record) == roofline.bound_ms(dt, state, config, out_bytes)
    seconds = 2e-5
    trace = {"ops": {"(anonymous namespace)::k_chunk(ZtTables, ZtState)": [seconds, 3],
                     "k_decision_lanes(int)": [1.0, 1], "Memcpy HtoD": [1.0, 1]}}
    share = AT.kernel_roofline_pct(_window(trace=trace), window([], [], geometry=[record]))
    assert share == pytest.approx(100 * 3 * roofline.bound_ms(dt, state, config, out_bytes)
                                  / (seconds * 1e3))
    assert AT.kernel_roofline_pct(_window(trace=None), window([], [], geometry=[record])) is None


def test_the_geometry_moved_over_the_window():
    record = _geometry()[0]
    other = {**record, "path": "chain", "calls": 2}
    before = [dict(record, calls=1)]
    after = [record, other]
    assert AT.geometry_moved(before, after) == [dict(record, calls=2), other]


@pytest.fixture
def short_waits(monkeypatch):
    monkeypatch.setattr(zrun, "DRAIN_S", 5.0)
    monkeypatch.setattr(drive, "REQUEST_TIMEOUT_S", 5.0)


def test_run_cell_reads_the_registry_at_the_windows_two_ends():
    """``spans_run`` opens the program's tracer at ``run.run_cell``'s first
    reading of the registry and closes it at the second: one more reading
    would shift the span window without a word."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(zrun.run_cell)))
    readings = [node for node in ast.walk(tree) if isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name) and node.func.id == "registry_state"]
    assert len(readings) == 2


def test_a_run_with_the_programs_spans_on_the_cpu(short_waits, monkeypatch):
    from zeebe_tpu_torch.observability import get_tracer

    sessions = []

    class Session(spans_run._Session):
        def __init__(self, seed: int) -> None:
            super().__init__(seed)
            sessions.append(self)

    monkeypatch.setattr(spans_run, "_Session", Session)
    cell = cells.load("zeebe-3x3.one_task.c1")
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, warmup_s=1.5))
    result = spans_run.run_cell(cell, 2**31 + 13, 3.0, True, "cpu")
    # the window's two readings of the registry, and no other
    assert [s.readings for s in sessions] == [2]
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    # no device trace on the CPU: the span readers alone
    assert result["metrics"]["commit_wait_ms"]["value"] > 0
    assert result["metrics"]["submit_lock_wait_ms"]["value"] >= 0
    assert not any(name.startswith("idle_") for name in result["metrics"])
    assert result["attribution"]["evicted"] == 0 and result["attribution"]["spans"] > 0
    assert not get_tracer().enabled
