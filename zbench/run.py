"""Run one cell of the benchmark once and print its result.

    python3 zbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration, whose
cluster this process builds as the port's in-process standalone does, and a
traffic mix, whose closed loop drives it through the gateway runtime's
``ClusterRuntime.submit``. Set-up (imports, the card, the kernel library,
the router's link measurement, the cluster's start and elections, the
deployment and the loop's warm-up) ends when the window opens; the window
lasts ``--seconds``; then the loop drains, and the judge holds what the run
produced to the plain reference under ``zbench/reference/``. A
``torch.profiler`` session traces the card over the window in every run,
since an end-to-end metric (the device's busy time per instance) reads it.
The last line of standard output is one JSON object: the end-to-end
metrics with ``--trace 0``, the per-layer metrics (read from the program's
counters and the trace) with ``--trace 1``.

Exits 2 without a result where no CUDA card (or fewer than the cell asks
for) answers, and 3 where the process holds JAX or the JAX package once
the window has closed."""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: fixed cache directories inside the checkout, so that only a checkout's
#: first run builds (the port's kernel library builds under build/ by itself)
CACHE_DIRS = {"TRITON_CACHE_DIR": ROOT / "build" / "zbench" / "triton",
              "TORCH_EXTENSIONS_DIR": ROOT / "build" / "zbench" / "torch_extensions"}
#: how long the loop may take to end the instances in flight at the close
DRAIN_S = 60.0
#: instances judged record by record, at most (drawn from the seed; the
#: longest-lived always among them)
CHECKED_MAX = 4000


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, fault=None) -> dict:
    """Run ``cell`` once on ``device`` and return the result object (with
    ``checks`` last); ``fault`` plants one of ``zbench.faults.FAULTS``."""
    import torch

    from zbench import drive, faults, stats, system
    from zbench.cells import reader
    from zbench.reference import bpmn
    from zbench.reference.expect import jobs_completed
    from zbench.reference.judge import LIMITS, judge, sample
    from zbench.trace import DeviceTrace
    from zbench.window import Window, registry_state
    from zeebe_tpu_torch.ops import automaton as A
    from zeebe_tpu_torch.utils.metrics import REGISTRY

    #: from the process's start: the interpreter, torch and the program
    split = {"start_and_imports_s": time.monotonic() - T_START}
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from zeebe_tpu_torch.utils.backend_probe import start_card

        card = start_card(device)
        split.update(cuda_context_s=card["cuda_s"], kernel_library_s=card["library_s"],
                     router_link_s=card["link_s"])
    process = bpmn.parse(cell.model_xml)
    traffic = cell.traffic
    # the jobs an instance of each x completes, by the reference; raises
    # here, before any run, for a model that some x would leave unfinished
    lo, hi = traffic["x_range"]
    jobs_by_x = {x: jobs_completed(process, x) for x in range(lo, hi + 1)}
    directory = Path(tempfile.mkdtemp(prefix="zbench-"))
    worker = "zbench-worker"
    runtime = loop = None
    try:
        with faults.plant(fault) as after_start:
            t = time.monotonic()
            runtime = system.build(cell.config, directory, device)
            runtime.start()
            split["cluster_start_s"] = time.monotonic() - t
            if after_start is not None and not after_start(runtime):
                raise ValueError(f"the fault {fault} does not apply to {cell.name}")
            t = time.monotonic()
            system.deploy(runtime, cell.model_name, cell.model_xml, process.process_id)
            split["deploy_s"] = time.monotonic() - t
            loop = drive.ClosedLoop(runtime, process.process_id, process.job_types,
                                    jobs_by_x.__getitem__, traffic, seed, worker)
            t = time.monotonic()
            loop.start()
            time.sleep(float(traffic["warmup_s"]))
            split["warmup_s"] = time.monotonic() - t
            before = registry_state(REGISTRY)
            pauses = stats.CollectorPauses()
            launches, grid = A.launch_counts(), A.grid_launch_counts()
            t = time.monotonic()
            device_trace = DeviceTrace() if on_card else None
            split["trace_start_s"] = time.monotonic() - t
            t_open = time.monotonic()
            setup_s = t_open - T_START
            log(f"zbench {cell.name} seed {seed}: set-up {setup_s:.3f} s "
                + " ".join(f"{k} {v:.3f}" for k, v in split.items()))
            time.sleep(seconds)
            t_close = time.monotonic()
            pauses.stop()
            after = registry_state(REGISTRY)
            launches = {k: v - launches.get(k, 0) for k, v in A.launch_counts().items()}
            grid = {k: v - grid.get(k, 0) for k, v in A.grid_launch_counts().items()}
            reduced = device_trace.stop() if device_trace is not None else None
            after_split = {"trace_s": time.monotonic() - t_close}
            t = time.monotonic()
            stuck = loop.stop_creating(DRAIN_S)
            loop.stop()
            settled = system.settle(runtime)
            after_split["drain_s"] = time.monotonic() - t
            memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
            t = time.monotonic()
            gathered = system.gather(runtime)
            ended = {key: (pid, end - send) for key, pid, send, _, end in loop.instances
                     if end is not None and t_open <= end < t_close}
            longest = max(ended, key=lambda k: ended[k][1], default=None)
            checked = sample(sorted(ended), CHECKED_MAX, seed,
                             [longest] if longest is not None else [])
            held = system.leftovers(runtime, gathered["logs"],
                                    {k: ended[k][0] for k in checked})
            after_split["gather_s"] = time.monotonic() - t
            t = time.monotonic()
    finally:
        if loop is not None:
            loop.creating.clear()
            loop.stop()
        if runtime is not None:
            runtime.stop()
        shutil.rmtree(directory, ignore_errors=True)
    del runtime
    if on_card:
        torch.cuda.empty_cache()
    after_split["stop_s"] = time.monotonic() - t
    t = time.monotonic()
    verdict = judge(process, worker, {**gathered, **loop.acknowledged(), "checked": checked,
                                      "leftovers": held})
    after_split["judge_s"] = time.monotonic() - t
    e2e = stats.end_to_end([(s, r, e) for _, _, s, r, e in loop.instances], loop.creates,
                           t_open, t_close)
    e2e["setup_s"] = setup_s
    if reduced is not None and e2e["instances"]:
        # the card's busy time (the union of its operations over the traced
        # window) for each instance that ended in the window
        e2e["device_ms_per_instance"] = 1e3 * reduced["busy_s"] / e2e["instances"]
    window = Window(t_close - t_open, before, after, grid,
                    [jobs for at, jobs in loop.activations if t_open <= at < t_close],
                    reduced, e2e)
    attempts = [failed for at, failed in loop.attempts if t_open <= at < t_close]
    checks = {name: {"value": verdict["counts"][name], "max": limit}
              for name, limit in LIMITS.items()}
    checks["unanswered"] = {"value": loop.unanswered, "max": 0}
    checks["stuck_instances"] = {"value": stuck, "max": 0}
    checks["unsettled_partitions"] = {"value": 0 if settled else 1, "max": 0}
    checks["loop_errors"] = {"value": len(loop.errors), "max": 0}
    checks["instances_ended"] = {"value": e2e["instances"], "min": 1}
    checks["kernel_command_pct"] = {"value": reader("kernel_command_pct", cell.root)(window)
                                    or 0.0, "min": 1e-9}
    if on_card:
        checks["automaton_launches"] = {"value": sum(launches.values()), "min": 1}
    correct = all(c["value"] <= c["max"] if "max" in c else c["value"] >= c["min"]
                  for c in checks.values())
    for name, what in verdict["first"].items():
        log(f"zbench check {name}: first difference: {what[:1500]}")
    for error in loop.errors[:5]:
        log(f"zbench loop error: {error[:1500]}")
    log(f"zbench judged {verdict['instances_checked']} instances record by record, "
        f"{len(loop.acked_creates)} creates, {len(loop.acked_completes)} job completions, "
        f"{len(loop.acked_activations)} activations, "
        f"{sum(len(b) for r in gathered['replicas'].values() for b in r.values())} replica "
        f"batches; after the window " + " ".join(f"{k} {v:.3f}" for k, v in after_split.items()))
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"], cell.root)(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in e2e}
    result = {"correct": correct, "attempted": len(attempts), "failed": sum(attempts),
              "metrics": metrics,
              "device": _device(torch, on_card, memory_peak, reduced if trace else None)}
    if trace and reduced is not None:
        ops = sorted(reduced["ops"].items(), key=lambda kv: -kv[1][0])[:10]
        result["breakdown"] = {"device_ops": [[n, s] for n, (s, _) in ops],
                               "idle_gaps": reduced["gaps"]}
    refused: dict[str, int] = {}
    for at, kind in loop.refusals:
        if t_open <= at < t_close:
            refused[kind] = refused.get(kind, 0) + 1
    log(f"zbench {cell.name} seed {seed}: {e2e['instances']} instances ended and "
        f"{e2e['creates']} creates sent in {t_close - t_open:.3f} s; refused in the window "
        f"{refused}; split "
        + json.dumps({k: round(v, 4) for k, v in split.items()}))
    ends = [e for _, _, _, _, e in loop.instances if e is not None]
    log(f"zbench {cell.name} seed {seed}: instances/s per {stats.SLICE_S:g} s of the window "
        f"{[round(r, 2) for r in stats.rate_per_slice(ends, t_open, t_close)]}; "
        f"gen-2 collections in the window {pauses.count}, {pauses.seconds:.3f} s, "
        f"the longest {pauses.longest:.3f} s")
    log(f"zbench {cell.name} seed {seed}: adaptive settings at the close and their moves "
        f"in the window {json.dumps(_levers(before, after))}")
    result["checks"] = checks
    return result


#: the program's series that say where its own feedback loops (the control
#: plane's knobs, the command limiter) stood in a run
LEVERS = ("control_knob_value", "control_adjustments_total", "backpressure")


def _levers(before: dict, after: dict) -> dict:
    """Each such series' value at the close, with its change over the
    window."""
    out = {}
    for (name, labels), value in sorted(after.items()):
        if not any(lever in name for lever in LEVERS) or isinstance(value, tuple):
            continue
        moved = value - before.get((name, labels), 0.0)
        if value or moved:
            out[f"{name.removeprefix('zeebe_')}{labels}"] = [round(value, 3), round(moved, 3)]
    return out


def _device(torch, on_card: bool, memory_peak: int, reduced) -> dict:
    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
           "memory_peak_bytes": memory_peak}
    if reduced is not None:
        out.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
    return out


def print_checks(checks: dict) -> None:
    for name, c in checks.items():
        limit = f"<= {c['max']}" if "max" in c else f">= {c['min']}"
        log(f"check {name} {c['value']} (limit {limit})")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="zbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for name, path in CACHE_DIRS.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[name] = str(path)
    from zbench import cells, guard

    cell = cells.load(args.workload)
    violations = guard.reference_violations(ROOT / "zbench" / "reference")
    if violations:
        log(f"zbench: the reference imports what it may not: {violations}")
        return 3
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"zbench: {cell.name} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} answer")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    loaded = guard.forbidden_loaded(list(sys.modules))
    if loaded:
        log(f"zbench: the run's process holds {loaded}")
        return 3
    print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
