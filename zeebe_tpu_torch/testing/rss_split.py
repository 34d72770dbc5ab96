"""Resident memory of one process, step by step, as it brings the card up
and serves a kernel-backed engine.

    python -m zeebe_tpu_torch.testing.rss_split [--device cpu] [--instances N]

Prints one JSON object: the resident MiB after each step (the interpreter,
``import torch``, the CUDA context, the kernel library, then an engine
with the kernel backend that deployed one_task and created ``N``
instances, every job completed) and each step's share, and at each step
the resident memory by kind, summed over ``/proc/self/smaps``'s mappings
as ``/proc/self/status`` defines the kinds (``RssAnon``: anonymous pages,
the heap and stacks and a library's pages copied on write among them;
``RssFile``: pages of mapped files the kernel can drop and read again;
``RssShmem``: shared memory). With ``--device cpu`` the two card steps are left out, so the two
runs side by side split a gate's resident memory into what the card costs
a process and what the harness holds itself (the scale-soak gate's ``rss``
bound counts both).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile


def _mib() -> float:
    from zeebe_tpu_torch.utils.metrics import _read_rss_bytes

    return round(_read_rss_bytes() / (1 << 20), 1)


#: the kinds of resident memory ``/proc/self/status`` splits VmRSS into
KINDS = ("RssAnon", "RssFile", "RssShmem")

#: mappings whose pages are shared memory
_SHMEM = ("/dev/shm", "/SYSV", "/memfd:", "/dev/zero", "[anon_shmem")


def _kinds_mib() -> dict:
    """This process's resident MiB by kind (``KINDS``), summed over its
    ``/proc/self/smaps`` (a sandboxed kernel may leave the kinds out of
    ``/proc/self/status``): each mapping's ``Anonymous:`` pages are
    ``RssAnon``, the rest of its ``Rss:`` is ``RssShmem`` for shared memory
    and ``RssFile`` otherwise; empty where smaps cannot be read."""
    kinds = dict.fromkeys(KINDS, 0)
    rest = "RssFile"
    try:
        with open("/proc/self/smaps", encoding="utf-8", errors="replace") as smaps:
            for line in smaps:
                fields = line.split()
                if len(fields) >= 5 and "-" in fields[0] and len(fields[1]) == 4:
                    path = " ".join(fields[5:])
                    rest = "RssShmem" if path.startswith(_SHMEM) else "RssFile"
                elif fields and fields[0] == "Rss:":
                    kinds[rest] += int(fields[1])  # kB
                elif fields and fields[0] == "Anonymous:":
                    kinds[rest] -= int(fields[1])
                    kinds["RssAnon"] += int(fields[1])
    except OSError:
        return {}
    return {k: round(v / 1024, 1) for k, v in kinds.items()} if any(kinds.values()) else {}


def rss_split(device=None, instances: int = 200) -> dict:
    """The resident MiB after each step, each step's growth, and the
    resident MiB by kind after each step."""
    steps = [("interpreter", _mib())]
    kinds = {"interpreter": _kinds_mib()}
    import torch

    steps.append(("import torch", _mib()))
    kinds["import torch"] = _kinds_mib()
    if device is None:
        from zeebe_tpu_torch.ops import kernels

        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        steps.append(("CUDA context", _mib()))
        kinds["CUDA context"] = _kinds_mib()
        kernels.load()
        steps.append(("kernel library", _mib()))
        kinds["kernel library"] = _kinds_mib()
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
        kinds[steps[-1][0]] = _kinds_mib()
    growth = [(name, round(mib - prev, 1))
              for (name, mib), (_, prev) in zip(steps[1:], steps)]
    return {"device": "cuda" if device is None else device, "rssMiB": dict(steps),
            "growthMiB": dict(growth), "kindMiB": kinds, "kernelRecords": records}


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
