"""Copy the engine stack's host modules from the reference package.

    python zeebe_tpu_torch/testing/copies.py [--check]

The port keeps its own copies of the reference's JAX-free host modules
instead of importing them. A copy is the reference's text with the package
name renamed (``zeebe_tpu.`` and ``from zeebe_tpu import`` in its imports,
and the bare name quoted as a string or a literal: the logger hierarchy's
root) and the reference's history tags (an issue or pull request number)
left out of comments and docstrings. This script reads the reference files
as text (it imports nothing of the reference) and writes each copy under
``zeebe_tpu_torch/``; ``--check`` only lists the copies that differ and
exits 1 if any does.
``tests/test_torch_engine_copies.py`` holds every copy to the same rule.
Run it as a file, not with ``-m``: it then imports nothing of the port
either, so it can repair a copy that no longer imports.

``ENGINE_STACK`` is bottom-up: protocol, the native codec, utilities,
state, journal and log stream, observability, exporters, backup,
partitioning, the engine, the stream processor. The harness
(``testing/__init__.py``) and the profiler's device half
(``observability/profiler.py``) are rewritten for the port, not copied.

``CLUSTER_STACK`` is the replicated broker cluster: the engine's
migration and query services, the control plane, Raft, membership and
topology, the broker's services, and the gateway's job streams.

``GATEWAY_STACK`` is the gRPC front over the cluster runtime: the gateway's
protocol (``gateway.proto`` and its generated ``gateway_pb2.py``, which the
rule leaves byte for byte as they are), tenant authorization, the OAuth
validator, admission control, the gateway service and server, and the
client with its credentials and job worker.

``REFERENCE_TESTS`` are test files of the reference run on the port: each is
written to ``tests/test_torch_ref_<name>`` as the same rule copies it, less
the definitions ``NOT_PORTED`` names, with ``device="cpu"`` given to every
``ClusterRuntime`` it builds (the plain version; no device is CUDA) and the
copy's file name where the file names itself.

The files of ``PARTIAL_COPIES`` are part copy, part rewrite:
``engine/kernel_backend.py`` (its device members), the partition, the
broker and the gateway's cluster runtime (the kernel backend's ``device``
they pass on). Their copied parts are runs of consecutive reference
definitions (module level, or members of one class), each written between
a ``# copied from the reference: <first> .. <last>`` line and an
``# end of the copy`` line of the port's file, with the same rule. The
port's own code around them is left as it is.
"""

from __future__ import annotations

import argparse
import ast
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
REFERENCE = REPO / "zeebe_tpu"
PORT = REPO / "zeebe_tpu_torch"
TESTS = REPO / "tests"

ENGINE_STACK = (
    "protocol/enums.py", "protocol/intent.py", "protocol/keys.py", "protocol/msgpack.py",
    "protocol/record.py", "protocol/__init__.py",
    "native/__init__.py", "native/codec.c",
    "utils/time_util.py", "utils/storage_io.py", "utils/health.py", "utils/zlogging.py",
    "utils/__init__.py",
    "state/db.py", "state/durable.py", "state/request_dedupe.py", "state/snapshot.py",
    "state/tiering.py", "state/__init__.py",
    "journal/journal.py", "journal/__init__.py",
    "logstreams/log_stream.py", "logstreams/__init__.py",
    "observability/span.py", "observability/tracer.py", "observability/timeseries.py",
    "observability/flight_recorder.py", "observability/lineage.py",
    "observability/critical_path.py", "testing/evidence.py", "observability/alerts.py",
    "testing/chaos_disk.py",
    "observability/auditor.py", "observability/__init__.py",
    "exporters/api.py", "exporters/recording.py", "exporters/director.py",
    "exporters/elasticsearch.py", "exporters/__init__.py",
    "backup/checkpoint.py", "backup/store.py", "backup/service.py", "backup/s3.py",
    "backup/gcs.py", "backup/__init__.py",
    "parallel/partitioning.py",
    "engine/writers.py", "engine/appliers.py", "engine/engine_state.py",
    "engine/timer_wheel.py", "engine/message_timer.py", "engine/signal.py",
    "engine/user_task.py", "engine/decision.py", "engine/distribution.py",
    "engine/modification.py", "engine/burst_templates.py", "engine/bpmn.py",
    "engine/processors.py", "engine/engine.py", "engine/__init__.py",
    "stream/api.py", "stream/processor.py", "stream/__init__.py",
)

CLUSTER_STACK = (
    "engine/migration.py", "engine/query.py",
    "control/actuators.py", "control/controllers.py", "control/plane.py",
    "control/__init__.py",
    "cluster/messaging.py", "cluster/membership.py", "cluster/raft.py", "cluster/topology.py",
    "cluster/__init__.py",
    "broker/backpressure.py", "broker/disk.py", "broker/scrubber.py", "broker/management.py",
    "broker/config.py", "broker/__init__.py",
    "gateway/jobstream.py",
)

GATEWAY_STACK = (
    "gateway/proto/__init__.py", "gateway/proto/gateway.proto", "gateway/proto/gateway_pb2.py",
    "gateway/auth.py", "gateway/oauth.py", "gateway/admission.py", "gateway/gateway.py",
    "gateway/__init__.py",
    "client/credentials.py", "client/client.py", "client/worker.py", "client/__init__.py",
)

REFERENCE_TESTS = (
    "test_gateway_client.py", "test_jobstream.py", "test_oauth.py", "test_multitenancy.py",
    "test_admission.py", "test_metrics_parity.py", "test_logging.py",
)

#: per reference test file, the definitions its copy leaves out, and why
NOT_PORTED = {
    "test_admission.py": {
        "_LoopbackAdmission": "runs the multi-process runtime (multiproc/), not ported yet",
        "TestLoopbackAdmission": "runs the multi-process runtime (multiproc/), not ported yet",
    },
}

TEST_HEADER = ("# tests/{name} run on the port, written by\n"
               "# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.\n")

KERNEL_BACKEND = "engine/kernel_backend.py"

#: (class, or None for the module; first definition; last definition)
KERNEL_BACKEND_RUNS = (
    (None, "_py_pack_fingerprint", "_CANDIDATE_COMMANDS"),
    (None, "_Token", "_Admitted"),
    (None, "_PendingGroup", "_PendingGroup"),
    ("KernelBackend", "is_candidate", "_definition_of"),
    ("KernelBackend", "_admit", "_build_group_arrays"),
    ("KernelBackend", "_observe_compile", "_observe_compile"),
    ("KernelBackend", "device_status", "note_group_success"),
    ("KernelBackend", "_materialize", "_emit_process_completed"),
)

#: (class, or None for the module; first definition; last definition) of
#: the copied runs of the other partial copies; the members between runs
#: are the port's, each the reference's with the kernel backend's device
PARTIAL_COPIES = {
    KERNEL_BACKEND: KERNEL_BACKEND_RUNS,
    "broker/partition.py": (
        (None, "DEFAULT_SNAPSHOT_PERIOD_MS", "_RaftWriter"),
        ("ZeebePartition", "_on_raft_commit", "_on_role_change"),
        ("ZeebePartition", "_finish_leader_recovery", "health"),
    ),
    "broker/broker.py": (
        (None, "INTER_PARTITION_TOPIC", "COMMAND_API_TOPIC"),
        (None, "_AUTO_DEVICE_COUNT", "_AUTO_DEVICE_COUNT"),
        (None, "partition_distribution", "resolve_leader_partition"),
        ("Broker", "__init__", "partition_guard"),
        ("Broker", "_tiering_cfg", "_scrub_cfg"),
        ("Broker", "_create_partition_for_join", "trigger_checkpoint"),
        ("InProcessCluster", "run", "restart_broker"),
        ("InProcessCluster", "close", "close"),
    ),
    "gateway/broker_client.py": (
        (None, "logger", "GatewayRuntimeBase"),
        ("ClusterRuntime", "_partition_guard", "_resolve"),
    ),
}

BEGIN = "# copied from the reference: {} .. {}"
END = "# end of the copy"

_TAG = re.compile(r" ?(?:by )?\(?\b(?:ISSUE|PR) \d+(?: satellite)?\)?")
# a tag broken over two lines of a comment or a docstring: in parentheses of
# its own, or closing a parenthesis
_SPLIT_TAG = re.compile(r" ?\((?:ISSUE|PR)\n[ \t]*(?:# )?\d+\)")
_SPLIT_TAG_CLOSING = re.compile(r",? (?:ISSUE|PR)\n[ \t]*(?:# )?\d+\)")


def as_copied(text: str) -> str:
    """The reference's text as the port copies it."""
    text = text.replace("zeebe_tpu.", "zeebe_tpu_torch.")
    text = text.replace("from zeebe_tpu import ", "from zeebe_tpu_torch import ")
    text = text.replace('"zeebe_tpu"', '"zeebe_tpu_torch"')
    text = text.replace("``zeebe_tpu``", "``zeebe_tpu_torch``")
    text = _SPLIT_TAG.sub("", text)
    text = _SPLIT_TAG_CLOSING.sub(")", text)
    return _TAG.sub("", text)


def reference_test_copy(name: str) -> Path:
    """Where the copy of the reference's ``tests/<name>`` lives."""
    return TESTS / name.replace("test_", "test_torch_ref_", 1)


def as_test_copy(text: str, name: str) -> str:
    """A reference test file as the port runs it: ``as_copied``, less the
    definitions ``NOT_PORTED`` names, each ``ClusterRuntime(...)`` given
    ``device="cpu"``, the file's own name (as a string) the copy's, under a
    header naming its source."""
    text = as_copied(text).replace(f'"{name}"', f'"{reference_test_copy(name).name}"')
    lines = text.splitlines(keepends=True)
    drop = NOT_PORTED.get(name, {})
    for node in reversed(ast.parse(text).body):
        if definition_name(node) in drop:
            first, last = source_lines(text, node)
            while last < len(lines) and not lines[last].strip():
                last += 1  # the blank lines after it go too
            del lines[first - 1:last]
    text = "".join(lines)
    lines = text.splitlines(keepends=True)
    calls = [n for n in ast.walk(ast.parse(text)) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "ClusterRuntime"]
    # before each call's closing parenthesis, the last first so that the
    # earlier ones keep their offsets
    for call in sorted(calls, key=lambda c: (c.end_lineno, c.end_col_offset), reverse=True):
        row, col = call.end_lineno - 1, call.end_col_offset - 1
        sep = ", " if call.args or call.keywords else ""
        lines[row] = lines[row][:col] + f'{sep}device="cpu"' + lines[row][col:]
    return TEST_HEADER.format(name=name) + "".join(lines)


def definition_name(node: ast.AST) -> str | None:
    """The name a top-level or class-level statement defines, if one."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return node.name
    if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
        return node.targets[0].id
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return node.target.id
    return None


def definitions(text: str, scope: str | None) -> list[ast.AST]:
    """The statements of the module, or of its class ``scope``."""
    body = ast.parse(text).body
    if scope is None:
        return body
    return next(n for n in body if isinstance(n, ast.ClassDef) and n.name == scope).body


def source_lines(text: str, node: ast.AST) -> tuple[int, int]:
    """A definition's first line (decorators included) and last line."""
    first = min([node.lineno] + [d.lineno for d in getattr(node, "decorator_list", [])])
    return first, node.end_lineno


def run_span(body: list[ast.AST], first: str, last: str) -> tuple[int, int]:
    """Indices in ``body`` of the first definition named ``first`` and the
    last named ``last`` (a property and its setter share a name)."""
    names = [definition_name(n) for n in body]
    return names.index(first), len(names) - 1 - names[::-1].index(last)


def reference_run(text: str, scope: str | None, first: str, last: str) -> str:
    """The reference's text from definition ``first`` through ``last``."""
    body = definitions(text, scope)
    i, j = run_span(body, first, last)
    start = source_lines(text, body[i])[0]
    end = source_lines(text, body[j])[1]
    return "".join(text.splitlines(keepends=True)[start - 1:end])


def splice_runs(port: str, reference: str, runs=KERNEL_BACKEND_RUNS) -> str:
    """A partial copy (by default the kernel backend) with each copied run
    rewritten from the reference text."""
    lines = port.splitlines(keepends=True)
    for scope, first, last in runs:
        begin = BEGIN.format(first, last)
        i = next(k for k, line in enumerate(lines) if line.strip() == begin)
        j = next(k for k in range(i + 1, len(lines)) if lines[k].strip() == END)
        run = as_copied(reference_run(reference, scope, first, last))
        lines[i + 1:j] = run.splitlines(keepends=True)
    return "".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--check", action="store_true",
                        help="list the copies that differ; write nothing")
    args = parser.parse_args(argv)
    stale = []
    copies = [(PORT / rel, as_copied((REFERENCE / rel).read_text()))
              for rel in ENGINE_STACK + CLUSTER_STACK + GATEWAY_STACK]
    copies += [(reference_test_copy(name), as_test_copy((TESTS / name).read_text(), name))
               for name in REFERENCE_TESTS]
    for dst, want in copies:
        if dst.exists() and dst.read_text() == want:
            continue
        stale.append(dst.relative_to(REPO).as_posix())
        if not args.check:
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_text(want)
    for rel, runs in PARTIAL_COPIES.items():
        dst = PORT / rel
        text = dst.read_text()
        want = splice_runs(text, (REFERENCE / rel).read_text(), runs)
        if want != text:
            stale.append(dst.relative_to(REPO).as_posix())
            if not args.check:
                dst.write_text(want)
    for rel in stale:
        print(("differs: " if args.check else "wrote: ") + rel)
    return 1 if args.check and stale else 0


if __name__ == "__main__":
    sys.exit(main())
