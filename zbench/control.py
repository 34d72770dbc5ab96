"""The readings the limits of ``correct`` are set from: a cell run over
several seeds with no fault (the sound runs), with the control, and with
each fault a cell can have (``zbench.faults``), all in one process so the
card's set-up is paid once. Not part of a benchmark run.

    python3 zbench/control.py --workload <cell> --seeds 11,12,13 --seconds 10 \\
        --faults none,control_ack_unwritten,state_unchanged

Prints one JSON line per run: the fault, the seed, ``correct`` and every
number compared with its limit."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="zbench/control.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--faults", default="none")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--clients", default="",
                        help="a sweep: run the cell at each of these client counts")
    parser.add_argument("--drain", type=float, default=None,
                        help="seconds the loop waits at the close for the instances in flight")
    args = parser.parse_args(argv)
    from zbench import cells
    from zbench import run as zrun
    from zbench.run import CACHE_DIRS, run_cell

    if args.drain is not None:
        zrun.DRAIN_S = args.drain

    for name, path in CACHE_DIRS.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[name] = str(path)
    base = cells.load(args.workload)
    sweep = [int(c) for c in args.clients.split(",") if c] or [base.traffic["clients"]]
    for clients in sweep:
        cell = dataclasses.replace(base, traffic=dict(base.traffic, clients=clients))
        for fault in args.faults.split(","):
            for seed in (int(s) for s in args.seeds.split(",")):
                result = run_cell(cell, seed, args.seconds, False, args.device,
                                  fault=None if fault == "none" else fault)
                print(json.dumps({"clients": clients, "fault": fault, "seed": seed,
                                  "correct": result["correct"],
                                  "attempted": result["attempted"],
                                  "failed": result["failed"],
                                  "metrics": {k: v["value"]
                                              for k, v in result["metrics"].items()},
                                  "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
