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
