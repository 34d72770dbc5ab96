"""The port's graft entry points (``zeebe_tpu_torch/graft_entry.py``).

``entry()`` builds the reference's flagship batch and one lock-step of it;
on the CPU its state after the step is held byte for byte against
``__graft_entry__.entry()`` stepped under JAX. ``dryrun_multichip`` runs
the sharded step and the serving path over a mesh of one-block launch
groups (the plain version on the CPU). The command line never falls back
to the CPU: with no card it exits with the start-up probe's verdict.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as reference
from zeebe_tpu_torch import graft_entry

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_entry_step_equals_reference():
    jfn, (jdt, jstate) = reference.entry()
    fn, (dt, state) = graft_entry.entry(device="cpu")
    assert dt.device == torch.device("cpu")
    for key, value in state.items():
        assert np.array_equal(np.asarray(jstate[key]), value.numpy()), key
    expected = jax.jit(jfn)(jdt, jstate)
    out = fn(dt, state)
    assert int(out["transitions"]) > 0
    for key, value in out.items():
        ref = np.asarray(expected[key])
        assert ref.dtype == value.numpy().dtype and ref.shape == tuple(value.shape), key
        assert np.array_equal(ref, value.numpy()), key


def test_dryrun_multichip_on_cpu_groups():
    assert graft_entry.dryrun_multichip(4, device="cpu") == {
        "groups": 4, "cards": ["cpu"], "blocks": [1, 1, 1, 1]}


@pytest.mark.parametrize("cards,n,expected", [
    (1, 8, [0] * 8),
    (3, 8, [0, 1, 2, 0, 1, 2, 0, 1]),
    (8, 4, [0, 1, 2, 3]),
])
def test_mesh_devices_spread_round_robin(monkeypatch, cards, n, expected):
    """One block per card where there are enough cards, else round-robin;
    on one card every group is ``cuda:0``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert graft_entry.mesh_devices(n) == [torch.device("cuda", i) for i in expected]
    assert graft_entry.mesh_devices(3, "cpu") == [torch.device("cpu")] * 3


def test_command_without_a_card_exits_with_the_probe_verdict():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    proc = subprocess.run([sys.executable, "-m", "zeebe_tpu_torch.graft_entry"], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2, (proc.stdout, proc.stderr[-2000:])
    assert "no CUDA card answers the device probe" in proc.stderr
    assert "entry()" not in proc.stdout and "dryrun" not in proc.stdout


def test_entry_and_dryrun_raise_without_cuda(monkeypatch):
    """No CPU fallback: without a card the entry points raise unless the
    caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.dryrun_multichip(2)
