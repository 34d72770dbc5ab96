"""The port-side counterparts of the reference's device-memory profiler tests.

``tests/test_profiler.py`` runs on the port as
``tests/test_torch_ref_profiler.py`` but for its two device-memory cases
(``testing/copies.py``'s ``NOT_PORTED``): the reference hands
``sample_device_memory`` JAX devices with ``memory_stats()``, while the port
samples ``torch.device``s through ``torch.cuda``'s memory statistics. The
same contracts on the port's devices, with ``torch.cuda``'s queries faked
(no card here): a card's two gauges are set, a device without statistics
or whose query raises is skipped, and telemetry never brings up the card.
"""

from __future__ import annotations

import pytest
import torch

from zeebe_tpu_torch.observability import profiler as P
from zeebe_tpu_torch.utils.metrics import REGISTRY


def _gauge() -> dict:
    gauge = REGISTRY._metrics.get("zeebe_device_memory_bytes")
    return {c.label_values: c.value for c in gauge._children_snapshot()}


def test_stats_map_into_gauges(monkeypatch):
    """The reference's ``tpu:3`` device with 1024 of 4096 bytes in use: the
    port's ``cuda:3`` sets ``gpu:3``'s ``in_use`` (the caching allocator's
    allocated bytes) and ``limit`` (the card's total memory)."""
    asked = []

    def memory_stats(dev):
        asked.append(dev)
        return {"allocated_bytes.all.current": 1024, "reserved_bytes.all.current": 2048}

    monkeypatch.setattr(torch.cuda, "memory_stats", memory_stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (3072, 4096))
    assert P.sample_device_memory([torch.device("cuda", 3)]) == 2
    assert asked == [torch.device("cuda", 3)]
    values = _gauge()
    assert values[("gpu:3", "in_use")] == 1024.0
    assert values[("gpu:3", "limit")] == 4096.0


@pytest.mark.parametrize("error", [NotImplementedError, RuntimeError])
def test_statless_and_raising_devices_are_skipped(monkeypatch, error):
    """A CPU device has no statistics and a card whose query raises is
    skipped: neither sets a gauge, and the pump's tick goes on."""
    def boom(dev):
        raise error("no statistics for this card")

    before = _gauge() if REGISTRY._metrics.get("zeebe_device_memory_bytes") else {}
    monkeypatch.setattr(torch.cuda, "memory_stats", boom)
    monkeypatch.setattr(torch.cuda, "mem_get_info", boom)
    assert P.sample_device_memory([torch.device("cpu"), torch.device("cuda", 1)]) == 0
    assert P.sample_device_memory([torch.device("cpu")]) == 0
    after = _gauge() if REGISTRY._metrics.get("zeebe_device_memory_bytes") else {}
    assert {k: v for k, v in after.items() if k[0] == "gpu:1"} == \
        {k: v for k, v in before.items() if k[0] == "gpu:1"}


def test_no_devices_while_cuda_is_not_initialized(monkeypatch):
    """``_resolve_devices()`` is empty while this process has not brought
    CUDA up, and asks nothing of the card: telemetry never initializes it
    (the first kernel dispatch does)."""
    def touched(*args):
        raise AssertionError("telemetry touched the card")

    monkeypatch.setattr(P, "_DEVICES", None)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    for name in ("device_count", "memory_stats", "mem_get_info", "init"):
        monkeypatch.setattr(torch.cuda, name, touched)
    assert P._resolve_devices() == []
    assert P.sample_device_memory() == 0
    assert P._DEVICES is None
