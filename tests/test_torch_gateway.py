"""The port's gRPC front answers like the reference's.

One scripted gRPC session (``torch_gateway_flows.drive_grpc``) runs against
the reference's ``Gateway`` over its ``ClusterRuntime`` and against the
port's over the port's (``device="cpu"``: the kernel backend on, its plain
version), both 3 brokers x 3 partitions x replication factor 3 with one
3-shard mesh runner: every response message equal with the fields the
real clock decides masked (a job's deadline; which broker leads each
partition, while each partition still has one leader), and every
partition leader's column families holding the same key counts. Also here: the gateway's copies are the reference's (the
protocol byte for byte), the reference's gateway test files are copied to
the port as the copy script writes them, the port's logger hierarchy
takes the configured appender, and the gateway and client load neither JAX
nor the reference.
"""

from __future__ import annotations

import ast
import io
import json
import logging
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_engine_copies import REWRITTEN
from test_torch_tables import as_copied
from torch_gateway_flows import PORT, REF, drive_grpc
from zeebe_tpu_torch.testing import copies
from zeebe_tpu_torch.utils.zlogging import Loggers, configure_logging

REPO = Path(__file__).resolve().parents[1]
TESTS = REPO / "tests"


def test_grpc_session_answers_like_the_reference():
    ref = drive_grpc(REF)
    port = drive_grpc(PORT, device="cpu")
    names = [name for name, _ in ref["responses"]]
    assert [name for name, _ in port["responses"]] == names
    for rpc in ("Topology", "DeployResource", "CreateProcessInstance", "ActivateJobs",
                "CompleteJob", "FailJob", "UpdateJobRetries", "ResolveIncident",
                "PublishMessage", "SetVariables", "CancelProcessInstance",
                "EvaluateDecision"):
        assert rpc in names, rpc
    for i, (a, b) in enumerate(zip(ref["responses"], port["responses"])):
        assert a == b, f"response {i}: {a[0]}"
    assert port["state"] == ref["state"]
    assert all(port["state"].values())
    assert port["mesh"] == ref["mesh"] and port["mesh"][0] > 0


# ---------------------------------------------------------------------------
# copies


@pytest.mark.parametrize("path", copies.GATEWAY_STACK)
def test_gateway_module_is_a_copy(path):
    assert (REPO / PORT / path).read_text() == as_copied((REPO / REF / path).read_text())


@pytest.mark.parametrize("path", ["gateway/proto/gateway.proto", "gateway/proto/gateway_pb2.py"])
def test_protocol_is_byte_identical(path):
    """Both packages register ``gateway.proto`` in protobuf's one default
    pool: only identical bytes load side by side."""
    assert (REPO / PORT / path).read_bytes() == (REPO / REF / path).read_bytes()


def test_no_gateway_or_client_file_is_rewritten():
    assert not [p for p in REWRITTEN if p.startswith(("gateway/", "client/"))
                and p != "gateway/broker_client.py"]
    port = {p.relative_to(REPO / PORT).as_posix()
            for sub in ("gateway", "client") for p in (REPO / PORT / sub).rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}
    assert port == set(copies.GATEWAY_STACK) | {"gateway/broker_client.py",
                                                "gateway/jobstream.py"}


@pytest.mark.parametrize("name", copies.REFERENCE_TESTS)
def test_reference_test_file_is_copied(name):
    copy = copies.reference_test_copy(name)
    assert copy.read_text() == copies.as_test_copy((TESTS / name).read_text(), name)
    assert f"from {REF}." not in copy.read_text() and f"import {REF}." not in copy.read_text()


def _tests(text: str) -> set[str]:
    """Class-qualified names of the test functions of a module."""
    out = set()
    for node in ast.parse(text).body:
        if isinstance(node, ast.ClassDef):
            out |= {f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, ast.FunctionDef) and m.name.startswith("test_")}
        elif isinstance(node, ast.FunctionDef) and node.name.startswith("test_"):
            out.add(node.name)
    return out


@pytest.mark.parametrize("name", copies.REFERENCE_TESTS)
def test_reference_test_copy_keeps_every_test_but_the_named(name):
    ref = _tests((TESTS / name).read_text())
    port = _tests(copies.reference_test_copy(name).read_text())
    dropped = {t for t in ref if t.split(".")[0] in copies.NOT_PORTED.get(name, {})}
    assert port == ref - dropped
    assert len(dropped) == (3 if name == "test_admission.py" else 0)


def test_runtimes_of_the_test_copies_run_on_the_cpu():
    """Every ``ClusterRuntime`` a copied test builds is given the CPU: none
    falls back to it by a default."""
    for name in copies.REFERENCE_TESTS:
        tree = ast.parse(copies.reference_test_copy(name).read_text())
        for call in ast.walk(tree):
            if isinstance(call, ast.Call) and getattr(call.func, "id", None) == "ClusterRuntime":
                kw = {k.arg: ast.literal_eval(k.value) for k in call.keywords if k.arg == "device"}
                assert kw == {"device": "cpu"}, (name, ast.unparse(call))


# ---------------------------------------------------------------------------
# the port's loggers take the appender


@pytest.fixture
def port_logger():
    root = logging.getLogger(PORT)
    saved = (list(root.handlers), root.level, root.propagate)
    yield root
    for h in list(root.handlers):
        root.removeHandler(h)
    for h in saved[0]:
        root.addHandler(h)
    root.setLevel(saved[1])
    root.propagate = saved[2]


def test_stackdriver_appender_takes_the_ports_lines(port_logger):
    buf = io.StringIO()
    handler = configure_logging(appender="stackdriver", level="debug", stream=buf)
    assert port_logger.handlers == [handler]
    Loggers.RAFT.warning("term %d", 3)
    Loggers.KERNEL.debug("group dispatched")
    lines = buf.getvalue().strip().split("\n")
    assert len(lines) == 2
    entry = json.loads(lines[0])
    assert entry["severity"] == "WARNING" and entry["message"] == "term 3"
    assert entry["context"]["loggerName"] == f"{PORT}.raft"
    assert json.loads(lines[1])["context"]["loggerName"] == f"{PORT}.kernel_backend"


def test_every_port_logger_is_under_the_configured_root():
    for name, logger in vars(Loggers).items():
        if isinstance(logger, logging.Logger):
            assert logger.name.startswith(f"{PORT}."), name
    assert Loggers.exporter_logger("es").name.startswith(f"{PORT}.")


# ---------------------------------------------------------------------------
# no JAX, no reference


_IMPORT_SCRIPT = """
import sys
import zeebe_tpu_torch.client
import zeebe_tpu_torch.gateway
from zeebe_tpu_torch.gateway import ClusterRuntime, Gateway, GatewayService
from zeebe_tpu_torch.client import JobWorker, ZeebeTpuClient
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "zeebe_tpu"))
print("LOADED", loaded, "grpc" in sys.modules)
"""


def test_gateway_and_client_load_no_jax_or_reference():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED [] True" in proc.stdout
