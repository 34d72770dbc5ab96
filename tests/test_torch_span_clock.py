"""The port's spans and ``torch.profiler``'s trace are on one clock: a span
stamped around a profiled range (on the CPU) or around a launched and
synchronised automaton chunk (on the card) holds that range's interval once
the trace's ``baseTimeNanoseconds`` is added to its timestamps.

On a machine with a card, run the card's test with

    pytest --noconftest -m cuda -s tests/test_torch_span_clock.py

(``-s`` prints the offsets measured; the file imports neither JAX nor the
JAX package.)"""

from __future__ import annotations

import json
import time

import pytest
import torch

from zeebe_tpu_torch.observability.host_spans import clock_offset_us

#: tries on the card, each one chunk between two stamps
TRIES = 20
#: how far the chunk's device interval may lie outside its span (us)
CARD_SLACK_US = 50.0
#: device work closer than this to the work before it is the same try's (us)
GAP_US = 2000.0
#: how far a profiled CPU range may lie from its span (us)
CPU_SLACK_US = 1000.0


def _trace(prof, path) -> tuple[float, list[dict]]:
    """The trace's base (us) and its complete events."""
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    return (trace["baseTimeNanoseconds"] / 1e3,
            [e for e in trace["traceEvents"] if e.get("ph") == "X"])


def _span(t0: float, t1: float) -> tuple[float, float]:
    """Two perf_counter stamps on the span clock (us), as the port's sites
    place them."""
    offset = clock_offset_us()
    return int(t0 * 1e6 + offset), int(t1 * 1e6 + offset)


def test_a_profiled_range_lies_inside_its_span_on_the_cpu(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    spans = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(4):
            t0 = time.perf_counter()
            with record_function(f"zeebe.clock.{i}"):
                time.sleep(0.002)
            spans.append(_span(t0, time.perf_counter()))
    base, events = _trace(prof, tmp_path / "cpu.json")
    ranges = {e["name"]: (base + e["ts"], base + e["ts"] + e["dur"]) for e in events
              if e["name"].startswith("zeebe.clock.")}
    # the first range pays the profiler's first record
    for i in range(1, 4):
        start, end = ranges[f"zeebe.clock.{i}"]
        s0, s1 = spans[i]
        assert s0 - CPU_SLACK_US <= start and end <= s1 + CPU_SLACK_US, (i, start - s0, s1 - end)


@pytest.mark.cuda
def test_a_chunk_on_the_card_lies_inside_its_span(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from torch.profiler import ProfilerActivity, profile

    from zeebe_tpu_torch.models.bpmn import Bpmn, transform
    from zeebe_tpu_torch.ops import automaton as A
    from zeebe_tpu_torch.ops.tables import compile_tables

    model = (Bpmn.create_executable_process("p").start_event("s")
             .service_task("t", job_type="w").end_event("e").done())
    tables = compile_tables([transform(model)])
    device = torch.device("cuda")
    dt = A.DeviceTables.from_numpy(tables, device)
    state = A.make_state(tables, 64, torch.zeros(64, dtype=torch.int32).numpy(),
                         token_capacity=256, device=device)
    A.run_collect(dt, state, n_steps=8, config=tables.kernel_config)  # builds, warms up
    torch.cuda.synchronize()
    spans = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TRIES):
            t0 = time.perf_counter()
            A.run_collect(dt, state, n_steps=8, config=tables.kernel_config)
            torch.cuda.synchronize()
            spans.append(_span(t0, time.perf_counter()))
            time.sleep(0.005)
    base, events = _trace(prof, tmp_path / "card.json")
    device = sorted((base + e["ts"], base + e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    # a try's device work: what runs between two tries' sleeps
    chunks: list[list] = []
    for start, end, name in device:
        if chunks and start - chunks[-1][1] < GAP_US:
            chunks[-1][1] = max(chunks[-1][1], end)
            chunks[-1][2].append(name)
        else:
            chunks.append([start, end, [name]])
    print(f"each try's device work: {sorted({tuple(c[2]) for c in chunks})}")
    assert len(chunks) == TRIES, [c[2] for c in chunks]
    assert all(any("k_" in n for n in c[2]) for c in chunks)
    before = [start - s0 for (start, _, _), (s0, _) in zip(chunks, spans)]
    after = [s1 - end for (_, end, _), (_, s1) in zip(chunks, spans)]
    print(f"{torch.cuda.get_device_name(0)}: chunk start after span start {min(before):.1f}"
          f"..{max(before):.1f} us, span end after chunk end {min(after):.1f}"
          f"..{max(after):.1f} us, over {TRIES} tries")
    inside = [b >= -CARD_SLACK_US and a >= -CARD_SLACK_US for b, a in zip(before, after)]
    assert all(inside), list(zip(before, after))
