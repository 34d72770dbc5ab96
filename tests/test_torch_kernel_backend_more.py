"""The port's kernel backend writes the reference's record log, byte for
byte: the flows of ``tests/test_kernel_backend.py`` (second half).

Each flow runs on the reference, on the port (its harness on the CPU) and
on the port's sequential engine; see ``tests/torch_kernel_flows.py``.
"""

from __future__ import annotations

import pytest

from test_torch_kernel_backend import FLOWS, HALF
from torch_kernel_flows import check_flow, flow_id


@pytest.mark.parametrize("flow", FLOWS[HALF:], ids=flow_id)
def test_flow_matches_the_reference(flow, tmp_path):
    check_flow(flow, tmp_path)


def test_both_halves_cover_the_reference_file():
    assert len(FLOWS) == 90
