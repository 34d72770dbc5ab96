"""The port's kernel backend writes the reference's record log, byte for
byte, on the inlined shapes: the flows of ``tests/test_kernel_call_inline.py``
(call activities inlined into the caller's tables), ``test_kernel_mi.py``
(multi-instance bodies on the device) and ``test_kernel_root_esp.py``
(root event sub-processes admitted).

Each flow runs on the reference, on the port (its harness on the CPU) and
on the port's sequential engine; see ``tests/torch_kernel_flows.py``.
"""

from __future__ import annotations

import pytest

from torch_kernel_flows import check_flow, flow_id, flows

FILES = ("test_kernel_call_inline", "test_kernel_mi", "test_kernel_root_esp")
FLOWS = [flow for name in FILES for flow in flows(name)]


@pytest.mark.parametrize("flow", FLOWS, ids=lambda f: f"{f[0]}::{flow_id(f)}")
def test_flow_matches_the_reference(flow, tmp_path):
    check_flow(flow, tmp_path)


def test_flows_cover_the_reference_files():
    assert {name: sum(f[0] == name for f in FLOWS) for name in FILES} == {
        "test_kernel_call_inline": 19, "test_kernel_mi": 19, "test_kernel_root_esp": 11}
