"""What importing the port's client-side modules costs a fresh process.

    python -m zeebe_tpu_torch.testing.import_cost [--root DIR]

Each module of ``CLIENT_MODULES`` (the client, the gateway and its
protocol, the multi-process gateway runtime, the standalone's launcher,
the command line, the linter) is imported ``REPEAT`` times, each time in
a fresh interpreter run from the tree at ``DIR`` (default this
checkout). Prints one JSON object: per module the wall seconds of each
run, the largest peak resident MiB of a run's process, and which of torch
and JAX it loaded — or the import's error where the tree lacks the
module. Run it on the root of another checkout (an earlier commit, unpacked
beside this one) and on this one, in one call, to compare the two.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

CLIENT_MODULES = ("zeebe_tpu_torch.client", "zeebe_tpu_torch.gateway",
                  "zeebe_tpu_torch.gateway.proto.gateway_pb2",
                  "zeebe_tpu_torch.multiproc.runtime", "zeebe_tpu_torch.standalone",
                  "zeebe_tpu_torch.cli", "zeebe_tpu_torch.analysis")

#: fresh interpreters a module is imported in
REPEAT = 3

#: prints which of torch and JAX importing ``sys.argv[1]`` loaded, and the
#: process's own peak resident KiB
_PROBE = ("import importlib, json, resource, sys; importlib.import_module(sys.argv[1]); "
          "print(json.dumps({'loaded': sorted(m for m in ('torch', 'jax') "
          "if m in sys.modules), 'peakKiB': resource.getrusage("
          "resource.RUSAGE_SELF).ru_maxrss}))")


def import_once(module: str, root: Path) -> dict:
    """One fresh interpreter importing ``module`` from ``root``: its wall
    seconds, its peak resident MiB and what it loaded (or its error)."""
    env = {**os.environ, "PYTHONPATH": str(root)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _PROBE, module], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        return {"seconds": seconds, "error": proc.stderr.strip().splitlines()[-1:]}
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    return {"seconds": seconds, "peakMiB": round(report["peakKiB"] / 1024, 1),
            "loaded": report["loaded"]}


def import_cost(root: Path) -> dict:
    """Every module of ``CLIENT_MODULES``, ``REPEAT`` runs each, from the
    tree at ``root``."""
    out = {}
    for module in CLIENT_MODULES:
        runs = [import_once(module, root) for _ in range(REPEAT)]
        if "error" in runs[0]:
            out[module] = {"error": runs[0]["error"]}
            continue
        out[module] = {"seconds": [round(r["seconds"], 3) for r in runs],
                       "peakMiB": max(r["peakMiB"] for r in runs),
                       "loaded": runs[0]["loaded"]}
    return {"root": str(root), "modules": out}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                        help="the checkout whose modules are imported (default: this one)")
    args = parser.parse_args(argv)
    print(json.dumps(import_cost(Path(args.root).resolve())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
