"""Resident memory of one process, step by step, as it brings the card up
and serves a kernel-backed engine.

    python -m zeebe_tpu_torch.testing.rss_split [--device cpu] [--instances N]

Prints one JSON object: the resident MiB after each step (the interpreter,
``import torch``, the CUDA context, the kernel library, then an engine
with the kernel backend that deployed one_task and created ``N``
instances, every job completed) and each step's share. With ``--device
cpu`` the two card steps are left out, so the two runs side by side split
a gate's resident memory into what the card costs a process and what the
harness holds itself (the scale-soak gate's ``rss`` bound counts both).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile


def _mib() -> float:
    from zeebe_tpu_torch.utils.metrics import _read_rss_bytes

    return round(_read_rss_bytes() / (1 << 20), 1)


def rss_split(device=None, instances: int = 200) -> dict:
    """The resident MiB after each step, and each step's growth."""
    steps = [("interpreter", _mib())]
    import torch

    steps.append(("import torch", _mib()))
    if device is None:
        from zeebe_tpu_torch.ops import kernels

        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        steps.append(("CUDA context", _mib()))
        kernels.load()
        steps.append(("kernel library", _mib()))
    from zeebe_tpu_torch.testing import EngineHarness
    from zeebe_tpu_torch.testing import workloads as W

    with tempfile.TemporaryDirectory(prefix="zeebe-rss-") as tmp:
        h = EngineHarness(tmp, use_kernel_backend=True, device=device)
        try:
            h.deploy(W.to_xml([W.one_task()]))
            for i in range(instances):
                h.create_instance("one_task", {"x": i})
            for job in h.activate_jobs("work_one_task", max_jobs=instances):
                h.complete_job(job["key"])
            records = h.kernel_backend.accounting.kernel_records
        finally:
            h.close()
        steps.append((f"engine, {instances} instances", _mib()))
    growth = [(name, round(mib - prev, 1))
              for (name, mib), (_, prev) in zip(steps[1:], steps)]
    return {"device": "cuda" if device is None else device, "rssMiB": dict(steps),
            "growthMiB": dict(growth), "kernelRecords": records}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="the kernel backend's device (default: the card; cpu runs "
                             "the plain version)")
    parser.add_argument("--instances", type=int, default=200)
    args = parser.parse_args(argv)
    print(json.dumps(rss_split(args.device, args.instances)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
