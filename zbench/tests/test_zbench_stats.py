"""The end-to-end arithmetic on synthetic stamps, and the per-layer
readers on synthetic windows."""

import gc

import pytest

from zbench import cells, stats
from zbench.trace import reduce
from zbench.window import Window


def steady(rate: float, latency: float, t0: float, t1: float):
    """Instances that end every 1/rate seconds after ``latency`` seconds,
    each create answered 10 ms after its send."""
    ends = [t0 + i / rate + 0.5 / rate for i in range(int((t1 - t0) * rate))]
    return [(t - latency, t - latency + 0.01, t) for t in ends]


def test_rate_and_tails_count_the_whole_window():
    instances = steady(100.0, 0.5, 0.0, 30.0)
    got = stats.end_to_end(instances, [(s, r) for s, r, _ in instances], 10.0, 20.0)
    assert got["instances"] == 1000
    assert got["instances_per_s"] == pytest.approx(100.0)
    assert got["instance_p95_ms"] == pytest.approx(500.0)
    assert got["create_p95_ms"] == pytest.approx(10.0)


def test_a_stall_inside_the_window_moves_the_rate_and_the_tail():
    calm = steady(100.0, 0.5, 0.0, 30.0)
    # two seconds in the window with no ending; what waited ends after it,
    # each instance as late as the stall held it
    stalled = [(s, r, e if not 14.0 <= e < 16.0 else 16.0 + (e - 14.0) * 0.01)
               for s, r, e in calm if not 15.5 <= e < 16.0]
    a = stats.end_to_end(calm, [], 10.0, 20.0)
    b = stats.end_to_end(stalled, [], 10.0, 20.0)
    assert b["instances_per_s"] < a["instances_per_s"]
    assert b["instance_p95_ms"] > 1.5 * a["instance_p95_ms"]


def test_percentile_is_nearest_rank():
    assert stats.percentile([], 0.95) == 0.0
    assert stats.percentile(list(range(1, 101)), 0.95) == 95
    assert stats.percentile([7.0], 0.95) == 7.0


def test_the_rate_per_slice_counts_each_end_in_its_slice():
    ends = [10.0, 10.1, 14.9, 15.0, 19.99, 20.0, 9.9, 27.0]
    assert stats.rate_per_slice(ends, 10.0, 21.0) == [3 / 5, 2 / 5]


def test_the_collector_pauses_count_full_collections_only():
    pauses = stats.CollectorPauses()
    gc.collect(0)
    gc.collect(2)
    gc.collect(2)
    pauses.stop()
    gc.collect(2)
    assert pauses.count == 2
    assert 0.0 < pauses.longest <= pauses.seconds


def _window(**kw):
    before = {("zeebe_stream_processor_pipeline_decode", '{partition="1"}'): (10, 1.0),
              ("zeebe_stream_processor_pipeline_materialize", '{partition="1"}'): (10, 2.0),
              ("zeebe_kernel_records_total", '{partition="1",path="kernel",reason="-"}'): 100.0,
              ("zeebe_kernel_records_total",
               '{partition="1",path="host",reason="head-sequential"}'): 10.0}
    after = {("zeebe_stream_processor_pipeline_decode", '{partition="1"}'): (30, 1.4),
             ("zeebe_stream_processor_pipeline_materialize", '{partition="1"}'): (30, 3.0),
             ("zeebe_kernel_records_total", '{partition="1",path="kernel",reason="-"}'): 190.0,
             ("zeebe_kernel_records_total",
              '{partition="1",path="host",reason="head-sequential"}'): 20.0,
             ("zeebe_stream_processor_pipeline_decode", '{partition="2"}'): (20, 0.2)}
    return Window(10.0, before, after, **kw)


def test_readers_take_the_change_over_the_window():
    w = _window(activations=[0, 3, 0, 5])
    assert cells.reader("admit_ms_per_group")(w) == pytest.approx(1e3 * 0.6 / 40)
    assert cells.reader("materialize_ms_per_group")(w) == pytest.approx(1e3 * 1.0 / 20)
    assert cells.reader("kernel_command_pct")(w) == pytest.approx(90.0)
    assert cells.reader("empty_activation_pct")(w) == pytest.approx(50.0)
    assert cells.reader("journal_flush_ms")(w) is None
    assert cells.reader("device_idle_pct")(w) is None
    assert cells.reader("kernel_us_per_launch")(w) is None
    assert cells.reader("instance_p95_ms.3x3")(w) is None
    w.e2e = {"instances": 10, "instance_p95_ms": 812.5, "creates": 0, "create_p95_ms": 0.0}
    assert cells.reader("instance_p95_ms.1x1")(w) == 812.5
    assert cells.reader("create_p95_ms.1x1")(w) is None


def test_the_trace_reduces_to_busy_time_ops_and_gaps():
    chunk = "(anonymous namespace)::k_chunk(ZtTables, ZtState, ZtState, ZtScratch, int, int)"
    events = [{"ph": "X", "cat": "kernel", "name": chunk, "ts": 0.0, "dur": 100.0},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 50.0, "dur": 100.0},
              {"ph": "X", "cat": "kernel", "name": chunk, "ts": 1150.0, "dur": 50.0},
              {"ph": "X", "cat": "kernel", "name": "k_decision_lanes(int)", "ts": 5000.0,
               "dur": 10.0},
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0.0,
               "dur": 5000.0}]
    got = reduce(events, 0.01)
    assert got["busy_s"] == pytest.approx(210e-6)
    assert got["ops"][chunk] == [pytest.approx(150e-6), 2]
    assert got["gaps"][0] == [f"after {chunk} before k_decision_lanes(int)",
                              pytest.approx(3800e-6)]
    assert got["gaps"][1] == [f"after Memcpy HtoD before {chunk}", pytest.approx(1000e-6)]
    w = Window(0.01, {}, {}, grid_launches={"fused": 2}, trace=got)
    assert cells.reader("device_idle_pct")(w) == pytest.approx(97.9)
    assert cells.reader("kernel_us_per_launch")(w) == pytest.approx(75.0)
