"""The port's client-side entry points load neither torch nor JAX.

A process that serves no kernel — the client, the gateway and its
protocol, the multi-process gateway runtime, the standalone's launcher,
the command line and the linter — imports no torch: ``import torch``
alone holds gigabytes resident and takes seconds, which every ``zbctl``
call and the workers shape's gateway process would pay before its first
request. Each module is imported in a fresh interpreter; the reference's
counterpart, where it exists, loads no JAX either, so the port is held to
no more than the reference gives. ``testing/import_cost.py`` times the
same imports on the card's machine.
"""

from __future__ import annotations

from pathlib import Path

import pytest

from zeebe_tpu_torch.testing import import_cost

REPO = Path(__file__).resolve().parents[1]

MODULES = (
    "zeebe_tpu_torch.client",
    "zeebe_tpu_torch.gateway",
    "zeebe_tpu_torch.gateway.proto.gateway_pb2",
    "zeebe_tpu_torch.multiproc.runtime",
    "zeebe_tpu_torch.standalone",
    "zeebe_tpu_torch.cli",
    "zeebe_tpu_torch.analysis",
)


def loaded(module: str) -> list[str]:
    """Which of torch and JAX importing ``module`` loads, in a fresh
    interpreter (``import_cost``'s probe)."""
    run = import_cost.import_once(module, REPO)
    assert "error" not in run, run
    return run["loaded"]


def test_import_cost_measures_the_same_modules(tmp_path):
    """``testing/import_cost`` (the card's measurement of these imports)
    probes these modules; a tree without one reports the import's error."""
    assert import_cost.CLIENT_MODULES == MODULES
    run = import_cost.import_once("zeebe_tpu_torch.cli", REPO)
    assert run["loaded"] == [] and run["peakMiB"] > 0 and run["seconds"] > 0
    missing = import_cost.import_once("zeebe_tpu_torch.cli", tmp_path)
    assert "No module named" in missing["error"][0]


@pytest.mark.parametrize("module", MODULES)
def test_module_loads_no_torch_or_jax(module):
    assert loaded(module) == []
    reference = module.replace("zeebe_tpu_torch", "zeebe_tpu", 1)
    assert loaded(reference) == []


#: runs the command line's ``eligibility --deployed`` over ``sys.argv[2]``
#: and prints its exit code and which of torch and JAX the run loaded
_DEPLOYED = ("import contextlib, io, json, sys; cli = __import__(sys.argv[1], "
             "fromlist=['main']); out = io.StringIO()\n"
             "with contextlib.redirect_stdout(out):\n"
             "    rc = cli.main(['eligibility', '--deployed', '--data-dir', sys.argv[2]])\n"
             "print(json.dumps({'rc': rc, 'report': json.loads(out.getvalue()), "
             "'loaded': sorted(m for m in ('torch', 'jax') if m in sys.modules)}))")


def test_eligibility_deployed_loads_no_torch(tmp_path):
    """``eligibility --deployed`` builds the port's ``KernelRegistry`` over a
    data directory's deployed definitions: host-only work, so it loads no
    torch (the kernel backend imports torch inside its device half), as the
    reference's loads no JAX."""
    import json
    import subprocess
    import sys

    from zeebe_tpu_torch.models.bpmn import Bpmn
    from zeebe_tpu_torch.testing import EngineHarness

    h = EngineHarness(directory=tmp_path)
    try:
        h.deploy(Bpmn.create_executable_process("imports_dep").start_event("s")
                 .service_task("t", job_type="w").end_event("e").done())
        h.pump()
    finally:
        h.close()
    for cli in ("zeebe_tpu_torch.cli", "zeebe_tpu.cli"):
        proc = subprocess.run([sys.executable, "-c", _DEPLOYED, cli, str(tmp_path)],
                              cwd=REPO, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        assert run["rc"] == 0, (cli, run)
        assert [r["bpmnProcessId"] for r in run["report"]["definitions"]] == ["imports_dep"]
        assert run["loaded"] == [], (cli, run["loaded"])
