"""The port's kernel backend writes the reference's record log, byte for
byte, through the pump's fast paths: the flows of
``tests/test_burst_templates.py`` (burst templates served and audited),
``test_pipelined_pump.py`` (the first chunk dispatched before the previous
group's side effects run; the next wave speculated) and the in-process flows
of ``test_mesh_serving.py`` (partitions as shards of one mesh dispatch, on
the CPU here).

``test_mesh_serving.py``'s worker-process flow runs its scenario in a child
process too: on the port the child runs the port's variant of the file (its
harness and mesh runner on the CPU). The reference marks that flow
``slow``, and so does the port. Each flow runs on the reference, on the
port (its harness on the CPU) and on the port's sequential engine; see
``tests/torch_kernel_flows.py``.
"""

from __future__ import annotations

import pytest

from torch_kernel_flows import check_flow, flow_id, flows, marked_slow

FLOWS = (flows("test_burst_templates") + flows("test_pipelined_pump")
         + flows("test_mesh_serving", only=lambda src: "EngineHarness(" in src
                 or "MultiPartitionHarness(" in src or "_mesh_scenario" in src
                 or "scenario_to_dir(" in src))


@pytest.mark.parametrize("flow", [pytest.param(f, marks=pytest.mark.slow) if marked_slow(f)
                                  else f for f in FLOWS],
                         ids=lambda f: f"{f[0]}::{flow_id(f)}")
def test_flow_matches_the_reference(flow, tmp_path):
    check_flow(flow, tmp_path)


def test_flows_cover_the_reference_files():
    counts = {}
    for flow in FLOWS:
        counts[flow[0]] = counts.get(flow[0], 0) + 1
    assert counts == {"test_burst_templates": 9, "test_pipelined_pump": 9,
                      "test_mesh_serving": 7}
    assert [flow_id(f) for f in FLOWS if marked_slow(f)] == [
        "TestWorkerProcessByteParity::test_solo_vs_coalesced_vs_separate_worker_process"]
