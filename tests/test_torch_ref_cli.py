# tests/test_cli.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""CLI tests (reference: clients/go/cmd/zbctl tests) — drive the zbctl-parity
commands against a live gateway."""

from __future__ import annotations

import json

import pytest

from zeebe_tpu_torch.cli import main
from zeebe_tpu_torch.gateway import ClusterRuntime, Gateway
from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml


@pytest.fixture(scope="module")
def gateway_address(tmp_path_factory):
    runtime = ClusterRuntime(broker_count=1, partition_count=1,
                             replication_factor=1, device="cpu")
    runtime.start()
    gateway = Gateway(runtime)
    gateway.start()
    yield gateway.address
    gateway.stop()
    runtime.stop()


def run_cli(capsys, address, *argv):
    rc = main(["--address", address, *argv])
    assert rc == 0
    return json.loads(capsys.readouterr().out)


def test_cli_end_to_end(tmp_path, capsys, gateway_address):
    model = (Bpmn.create_executable_process("cli_proc")
             .start_event("s").service_task("t", job_type="cli_work")
             .end_event("e").done())
    bpmn_file = tmp_path / "cli_proc.bpmn"
    bpmn_file.write_text(to_bpmn_xml(model))

    status = run_cli(capsys, gateway_address, "status")
    assert status["partitionsCount"] == 1

    deployed = run_cli(capsys, gateway_address, "deploy", str(bpmn_file))
    assert deployed["processes"][0]["bpmnProcessId"] == "cli_proc"

    created = run_cli(capsys, gateway_address, "create", "instance", "cli_proc",
                      "--variables", '{"x": 7}')
    assert created["processInstanceKey"] > 0

    activated = run_cli(capsys, gateway_address, "activate", "jobs", "cli_work")
    assert len(activated["jobs"]) == 1
    job = activated["jobs"][0]
    assert job["variables"] == {"x": 7}

    completed = run_cli(capsys, gateway_address, "complete", "job",
                        str(job["key"]))
    assert completed["completed"] == job["key"]

    published = run_cli(capsys, gateway_address, "publish", "message", "m1",
                        "--correlation-key", "k1")
    assert published["messageKey"] > 0

    signaled = run_cli(capsys, gateway_address, "broadcast", "signal", "sig1")
    assert signaled["signalKey"] > 0
