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

``SLICE_STACK`` holds the first slices' copies (the FEEL and BPMN model
packages, the table compiler and the like); ``WHOLE_COPIES`` is every
whole copy.

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

``STANDALONE_STACK`` is what the standalone entry point needs besides its
partial copies: the external-code loaders, the TCP messaging fault
injector and the multi-process package's ``__init__``.

``ANALYSIS_STACK`` is what zlint, the AST invariant linter, copies whole:
the eligibility reason notes. It and the files of ``PORT_PATHS`` (the
command line and the rest of ``analysis/``, partial copies) name the
reference's files by path (``zeebe_tpu/...``), which the lint, the knob
scan and the generated documents read: their copies also rename that
path, so that they read the port's tree (``as_copied_with_paths``).

``REFERENCE_TESTS`` are test files of the reference run on the port: each is
written to ``tests/test_torch_ref_<name>`` as the same rule copies it, less
the definitions ``NOT_PORTED`` names, with the calls ``RENAMED_CALLS`` names
calling the port's names, ``device="cpu"`` given to every
call of ``CPU_CALLS`` it makes (the plain version; no device is CUDA),
``--device cpu`` added to every command line that starts the port's
standalone, the repository's own directory on the ``PYTHONPATH`` it gives
a child, the names of ``PORT_TEXT`` the port's, and the copy's file name
where the file names itself. Every other reference test file is named in
``COVERED_BY`` (the port's test files that run its flows on both
packages) or ``JAX_OWN`` (the JAX package's own benchmark), or tests
only modules of ``WHOLE_COPIES`` (``tests/test_torch_ref_coverage.py``).

``TEST_CODE_COPIES`` are the port's modules that copy definitions of the
reference's tests (``testing/random_graphs.py``: the random process
generator and the DMN fixtures), written as the partial copies below are,
with ``TEST_CODE_CALLS`` (``pytest.fail`` raised as an ``AssertionError``).

The files of ``PARTIAL_COPIES`` are part copy, part rewrite:
``engine/kernel_backend.py`` (its device members), the journal, the
tracer and the stream processor (spans at the real start of their work on
the device trace's clock, the journal's owner on its flush spans, the
collections' hook), the critical path (a kernel group's device stage as
its two spans), the partition, the
broker, Raft (a pre-vote's dropped leader, the election timer of a
member that can win where a vote's requester cannot, and its journal's
owner), the gateway's
cluster runtimes (the partition lock's wait as a span), the chaos harness and the worker supervisor (the
kernel backend's ``device`` they pass on), the worker's
and the standalone's entry points (``--device`` and the card guard),
the multi-process gateway runtime (its leader routing by term), the
command line (``metrics-doc``'s ``--device``, the port's documents) and
zlint (the port's files and baseline, and the port's device queries and
kernel-result primitives in rules 2 and 8). Their
copied parts are runs of consecutive reference definitions (module level,
or members of one class), each written between
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

#: the first slices' copies: the FEEL and BPMN model packages, the table
#: compiler, the eligibility rules, the metrics registry, the host DMN
#: engine, the device health ladder, the audit log and the device chaos
#: plane (also held by tests/test_torch_tables.py and
#: tests/test_torch_decision.py)
SLICE_STACK = (
    "feel/temporal.py", "feel/feel.py", "feel/__init__.py", "models/bpmn/model.py",
    "models/bpmn/executable.py", "models/bpmn/xml_io.py", "models/bpmn/__init__.py",
    "ops/tables.py", "engine/eligibility.py", "utils/metrics.py", "dmn/dmn.py",
    "dmn/__init__.py", "engine/device_health.py", "control/audit.py",
    "testing/chaos_common.py", "testing/chaos_device.py",
)

ENGINE_STACK = (
    "protocol/enums.py", "protocol/intent.py", "protocol/keys.py", "protocol/msgpack.py",
    "protocol/record.py", "protocol/__init__.py",
    "native/__init__.py", "native/codec.c",
    "utils/time_util.py", "utils/storage_io.py", "utils/health.py", "utils/zlogging.py",
    "utils/__init__.py",
    "state/db.py", "state/durable.py", "state/request_dedupe.py", "state/snapshot.py",
    "state/tiering.py", "state/__init__.py",
    "journal/__init__.py",
    "logstreams/log_stream.py", "logstreams/__init__.py",
    "observability/span.py", "observability/timeseries.py",
    "observability/flight_recorder.py", "observability/lineage.py",
    "testing/evidence.py", "observability/alerts.py",
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
    "stream/api.py", "stream/__init__.py",
)

CLUSTER_STACK = (
    "engine/migration.py", "engine/query.py",
    "control/actuators.py", "control/controllers.py", "control/plane.py",
    "control/__init__.py",
    "cluster/messaging.py", "cluster/membership.py", "cluster/topology.py",
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

STANDALONE_STACK = (
    "utils/external_code.py", "testing/chaos_tcp.py", "multiproc/__init__.py",
)

GATES_STACK = ("testing/sanitizer.py",)

ANALYSIS_STACK = ("analysis/eligibility_notes.py",)

#: every reference module the port keeps as a whole copy
WHOLE_COPIES = (SLICE_STACK + ENGINE_STACK + CLUSTER_STACK + GATEWAY_STACK + STANDALONE_STACK
                + GATES_STACK + ANALYSIS_STACK)

#: copies that also rename the reference's path ``zeebe_tpu/``
PORT_PATHS = ANALYSIS_STACK + ("cli.py", "analysis/__init__.py", "analysis/framework.py",
                               "analysis/knobs.py", "analysis/rules.py")

REFERENCE_TESTS = (
    "test_gateway_client.py", "test_jobstream.py", "test_oauth.py", "test_multitenancy.py",
    "test_admission.py", "test_metrics_parity.py", "test_logging.py",
    "test_multiproc.py", "test_external_code.py", "test_chaos.py", "test_tcp_cluster.py",
    "test_recovery.py", "test_storage_faults.py", "test_durable_state.py", "test_backup.py",
    "test_topology.py", "test_raft.py", "test_auditor.py", "test_critical_path.py",
    "test_timeseries.py", "test_eligibility.py", "test_observability.py",
    "test_engine_links.py", "test_update.py", "test_sanitizer.py", "test_serving.py",
    "test_consistency.py", "test_automaton.py", "test_cli.py", "test_profiler.py",
    "test_device_decision.py", "test_engine_breadth.py", "test_engine_events.py",
    "test_engine_gateways.py", "test_engine_mi_callactivity.py",
    "test_engine_timers_messages.py", "test_exporters.py", "test_feel_temporal.py",
    "test_forms.py", "test_native_codec.py", "test_ops.py", "test_remote_backup_stores.py",
    "test_state_tiering.py", "test_batch_query_migration.py", "test_dmn.py",
)

#: reference test files that run on the port through other means: each with
#: the tests/test_torch_*.py files that run its flows (or its seeds) on both
#: packages and compare what they write
COVERED_BY = {
    "test_kernel_backend.py": ("test_torch_kernel_backend.py",
                               "test_torch_kernel_backend_more.py"),
    "test_kernel_call_inline.py": ("test_torch_kernel_shapes.py",),
    "test_kernel_mi.py": ("test_torch_kernel_shapes.py",),
    "test_kernel_root_esp.py": ("test_torch_kernel_shapes.py",),
    "test_burst_templates.py": ("test_torch_kernel_pump.py",),
    "test_pipelined_pump.py": ("test_torch_kernel_pump.py",),
    "test_mesh_serving.py": ("test_torch_kernel_pump.py",),
    "test_engine_e2e.py": ("test_torch_engine.py",),
    "test_engine_replay.py": ("test_torch_engine.py",),
    "test_multipartition.py": ("test_torch_engine.py",),
    "test_randomized_parity.py": ("test_torch_engine.py", "test_torch_kernel_seeds.py",
                                  "test_torch_kernel_seeds_more.py",
                                  "test_torch_kernel_seeds_last.py",
                                  "test_torch_random_graphs.py"),
    "test_control.py": ("test_torch_control.py",),
    "test_device_link.py": ("test_torch_control.py",),
    "test_device_faults.py": ("test_torch_device_faults.py", "test_torch_kernel_faults.py",
                              "test_torch_control.py"),
    "test_zlint.py": ("test_torch_zlint.py",),
}

#: reference test files of the JAX package's own wall clock or benchmark,
#: which the port does not run, and why
JAX_OWN = {
    "test_bench_floor.py": "wall-clock floors of bench.py, the JAX package's benchmark, on "
                           "the CPU; the port's benchmark is its own",
    "test_bench_smoke.py": "runs bench.py, the JAX package's benchmark, end to end; the "
                           "port's benchmark is its own",
}

#: per reference test file, the definitions its copy leaves out, and why
NOT_PORTED = {
    "test_multiproc.py": {
        "test_env_pinned_cpu_short_circuits":
            "the port's probe has no JAX_PLATFORMS fast path: the CPU is asked for by device",
        "test_wedged_probe_degrades_mesh_to_host_devices":
            "the port never falls to the CPU unasked: a wedged probe stops the entry point "
            "(tests/test_torch_standalone.py)",
    },
    "test_profiler.py": {
        "test_stats_map_into_gauges":
            "the port samples torch.devices through torch.cuda's memory statistics, not a "
            "JAX device's memory_stats(); its gauges are tests/test_torch_profiler_device.py's",
        "test_statless_and_raising_devices_are_skipped":
            "the port skips a CPU torch.device and a card whose torch.cuda query raises, not "
            "a JAX device without stats; tests/test_torch_profiler_device.py holds both",
    },
    "test_automaton.py": {
        "test_mesh_rejects_oversubscription":
            "the port's make_mesh(n) without devices is one launch group, every block on one "
            "device, so a shard count is not a device count; the refusals of a layout over "
            "devices (a card that does not exist, more devices than shards, CPU and CUDA "
            "mixed) are tests/test_torch_mesh_groups.py's",
    },
}

#: the calls a copied test makes that build a kernel backend (or start a
#: process that does): each is given ``device="cpu"``
CPU_CALLS = ("ClusterRuntime", "InProcessCluster", "ChaosHarness", "BrokerCfg",
             "KernelBackend", "worker_cmd", "SoakHarness", "run_soak", "ScaleSoakHarness",
             "run_scale_soak", "ConsistencyConfig", "TortureConfig", "DeviceChaosConfig",
             "ServingConfig", "FleetDayConfig", "AutotuneConfig", "EngineHarness",
             "MeshKernelRunner", "make_state", "from_numpy", "make_mesh", "batch_evaluate")
#: a call of the reference's API that the port names otherwise: the copy
#: calls the port's name
RENAMED_CALLS = {".from_tables(": ".from_numpy("}
#: the module a copied test's command line starts, which is given ``--device cpu``
STANDALONE_MODULE = "zeebe_tpu_torch.standalone"
#: the command line's one command that builds a kernel backend: a copied
#: test's command line running it is given ``--device cpu`` too
CLI_MODULE, CLI_DEVICE_COMMAND = "zeebe_tpu_torch.cli", "metrics-doc"
#: a path of the reference's own documents in a copied test; the copy
#: reads the port's
PORT_DOCS = {'REPO / "docs" / ': 'REPO / "zeebe_tpu_torch" / "docs" / '}
#: a name the reference's code writes that the port's writes otherwise: the
#: device capture's trace directory (``observability/profiler.py``)
PORT_TEXT = {'"jax-trace-"': '"torch-trace-"'}
# a child's PYTHONPATH written as an absolute directory of the reference's
# checkout; the copy gives the child its own checkout's
_ABSOLUTE_PYTHONPATH = re.compile(r'PYTHONPATH="/[\w/.-]+"')
_OWN_CHECKOUT = "PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))"
# a helper imported from another file of the reference's tests; the copy
# imports that file's port variant (``tests/torch_kernel_flows.port_module``:
# its imports renamed, its kernel-backed harnesses on the CPU)
_TESTS_HELPER = re.compile(r"\bfrom tests\.(\w+) import ")

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
    "journal/journal.py": (
        (None, "_TRACER", "_Segment"),
        ("SegmentedJournal", "_update_segment_gauge", "_roll_segment"),
        ("SegmentedJournal", "maybe_flush", "reset"),
        (None, "read_only_records", "read_only_records"),
    ),
    "observability/tracer.py": (
        (None, "_M_ACK_LATENCY", "_ACK_RESERVOIR_LIMIT"),
        ("Tracer", "__slots__", "__init__"),
        ("Tracer", "clear", "mark_exported"),
        (None, "_TRACER", "_configure_from_env"),
    ),
    "observability/critical_path.py": (
        (None, "EDGES", "_EDGE_BY_NAME"),
        (None, "_ROOT_NAMES", "LatencyObservatory"),
    ),
    "stream/processor.py": (
        (None, "_STORAGE_CORRUPTION", "StreamProcessorMode"),
        ("StreamProcessor", "_load_last_processed", "_iter_candidate_commands"),
        ("StreamProcessor", "_trace_speculative", "_release_acks"),
        ("StreamProcessor", "_emit_group_effects", "run_until_idle"),
    ),
    "broker/partition.py": (
        (None, "DEFAULT_SNAPSHOT_PERIOD_MS", "_RaftWriter"),
        ("ZeebePartition", "_on_raft_commit", "_on_role_change"),
        ("ZeebePartition", "_finish_leader_recovery", "_provide_install_snapshot"),
        ("ZeebePartition", "tick", "health"),
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
    "cluster/raft.py": (
        (None, "HEARTBEAT_INTERVAL_MS", "RaftRole"),
        ("RaftNode", "_load_meta", "_last_resort_due"),
        ("RaftNode", "_start_election", "_start_election"),
        ("RaftNode", "_on_vote_response", "committed_entries"),
    ),
    "gateway/broker_client.py": (
        (None, "logger", "GatewayRuntimeBase"),
        ("ClusterRuntime", "_partition_guard", "cluster_status"),
        ("ClusterRuntime", "_resolve", "_resolve"),
    ),
    "gateway/tcp_runtime.py": (
        (None, "GATEWAY_RESPONSE_TOPIC", "JOBS_AVAILABLE_TOPIC"),
        ("TcpClusterRuntime", "start", "submit"),
    ),
    "testing/chaos.py": (
        (None, "_ACTIVE_SEED", "engine_state_equals"),
        ("ChaosHarness", "close", "assert_no_violations"),
    ),
    "multiproc/supervisor.py": (
        (None, "logger", "WorkerSpec"),
        ("WorkerSupervisor", "__init__", "status"),
    ),
    "multiproc/worker.py": (
        (None, "CLIENT_COMMAND_TOPIC", "_TestLeak"),
    ),
    "multiproc/runtime.py": (
        (None, "STALE_STATUS_MS", "_M_REQUEST_TIMEOUTS"),
        ("MultiProcClusterRuntime", "__init__", "await_leaders"),
        ("MultiProcClusterRuntime", "_observe_routing_table", "_on_remote_jobs_available"),
        ("MultiProcClusterRuntime", "topology", "_on_worker_response"),
        ("MultiProcClusterRuntime", "_emit_root_span", "_emit_root_span"),
    ),
    "standalone.py": (
        (None, "_gateway_oauth", "_free_ports"),
    ),
    "testing/soak.py": (
        (None, "SoakConfig", "tamper_newest_snapshot"),
        ("SoakHarness", "_leader", "report"),
    ),
    "testing/scale_soak.py": (
        (None, "ScaleSoakConfig", "_models"),
        ("ScaleSoakHarness", "_leader", "report"),
    ),
    "testing/consistency.py": (
        (None, "logger", "collect_exports"),
        (None, "_await_exports", "_dedupe_replay_probe"),
    ),
    "testing/torture.py": (
        (None, "logger", "BITROT_GRACE_MS"),
        (None, "_SEG_HEADER", "check_follower_convergence"),
        (None, "_corruption_repair_probe", "main"),
    ),
    "testing/device_chaos.py": (
        (None, "logger", "logger"),
        (None, "_DEATH_WAIVER_MS", "check_health_cycle"),
        (None, "main", "main"),
    ),
    "testing/serving.py": (
        (None, "logger", "_default_tenants"),
        (None, "FULL_CONFIG", "execute_op"),
        (None, "main", "main"),
    ),
    "testing/fleetday.py": (
        (None, "logger", "_default_tenants"),
        (None, "FULL_FLEETDAY", "_audit_env"),
        (None, "main", "main"),
    ),
    "testing/autotune.py": (
        (None, "logger", "logger"),
        (None, "FULL_CONFIG", "evaluate_arms"),
        (None, "merge_rounds", "main"),
    ),
    "cli.py": (
        (None, "_out", "_out"),
        (None, "_trace", "_profile"),
        (None, "_render_metrics_doc", "_render_metrics_doc"),
        (None, "_repo_root", "_dispatch"),
    ),
    "analysis/__init__.py": (
        (None, "__all__", "__all__"),
    ),
    "analysis/framework.py": (
        (None, "_SUPPRESS_RE", "format_baseline"),
    ),
    "analysis/knobs.py": (
        (None, "_KNOB_RE", "_KNOB_RE"),
        (None, "Knob", "undocumented"),
    ),
    "analysis/rules.py": (
        (None, "_import_aliases", "ReplayDeterminismRule"),
        (None, "_BLOCKING_CALLS", "StorageIoDisciplineRule"),
        (None, "RULES", "RULES"),
    ),
}

#: the port's modules that copy definitions of the reference's tests, each
#: with its runs (the reference test file, its first and last definition)
TEST_CODE_COPIES = {
    "testing/random_graphs.py": (("test_randomized_parity.py", "VAR_NAMES", "_fingerprint"),
                                 ("test_dmn.py", "DISH_DMN", "COLLECT_DMN")),
}
#: a call of pytest in copied test code, and what the port's module does
#: instead (it runs without pytest)
TEST_CODE_CALLS = {"pytest.fail(": "raise AssertionError("}

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


def as_copied_with_paths(text: str) -> str:
    """``as_copied``, with the reference's path renamed too."""
    return as_copied(text).replace("zeebe_tpu/", "zeebe_tpu_torch/")


def reference_test_copy(name: str) -> Path:
    """Where the copy of the reference's ``tests/<name>`` lives."""
    return TESTS / name.replace("test_", "test_torch_ref_", 1)


def as_test_copy(text: str, name: str) -> str:
    """A reference test file as the port runs it: ``as_copied``, less the
    definitions ``NOT_PORTED`` names, each call ``RENAMED_CALLS`` names
    calling the port's name, each call of ``CPU_CALLS`` given
    ``device="cpu"`` (where it names no device), each command line that
    starts the standalone or runs ``metrics-doc`` given ``--device cpu``,
    the reference's documents the port's, a child's absolute
    ``PYTHONPATH`` its own checkout, the file's own name (a string that
    starts with it: a stack frame's ``<file>:``) the copy's, a class whose
    every member is left out left out whole, under a header naming its
    source."""
    text = as_copied(text).replace(f'"{name}', f'"{reference_test_copy(name).name}')
    for reference_text, port_text in {**RENAMED_CALLS, **PORT_DOCS, **PORT_TEXT}.items():
        text = text.replace(reference_text, port_text)
    text = _ABSOLUTE_PYTHONPATH.sub(_OWN_CHECKOUT, text)
    text = _TESTS_HELPER.sub(
        lambda m: f'import torch_kernel_flows; torch_kernel_flows.port_module("{m.group(1)}"); '
                  f"from _kflows_zeebe_tpu_torch_{m.group(1)} import ", text)
    lines = text.splitlines(keepends=True)
    drop = set(NOT_PORTED.get(name, {}))
    body = ast.parse(text).body
    emptied = {id(node) for node in body if isinstance(node, ast.ClassDef)
               and all(definition_name(member) in drop for member in node.body)}
    for node, member in _with_class_members(body):
        if id(node) in emptied or (definition_name(node) in drop
                                   and id(_class_of(body, node)) not in emptied):
            first, last = source_lines(text, node)
            if member:  # the blank lines before a class's member go too
                while first > 1 and not lines[first - 2].strip():
                    first -= 1
            else:  # and those after a module's definition
                while last < len(lines) and not lines[last].strip():
                    last += 1
            del lines[first - 1:last]
    text = "".join(lines)
    lines = text.splitlines(keepends=True)
    inserts = []
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Call) and _called_name(node) in CPU_CALLS and not any(
                k.arg == "device" for k in node.keywords):
            before = "".join(lines[:node.end_lineno - 1]) + lines[node.end_lineno - 1][
                :node.end_col_offset - 1]
            sep = ", " if not before.rstrip().endswith((",", "(")) else ""
            inserts.append((node.end_lineno, node.end_col_offset, f'{sep}device="cpu"'))
        elif isinstance(node, ast.List) and _starts_a_device(
                [e.value for e in node.elts if isinstance(e, ast.Constant)]):
            inserts.append((node.end_lineno, node.end_col_offset, ', "--device", "cpu"'))
    # before each closing bracket, the last first so that the earlier ones
    # keep their offsets
    for end_line, end_col, added in sorted(inserts, reverse=True):
        row, col = end_line - 1, end_col - 1
        lines[row] = lines[row][:col] + added + lines[row][col:]
    return TEST_HEADER.format(name=name) + "".join(lines)


def _class_of(body: list[ast.AST], member: ast.AST) -> ast.ClassDef | None:
    """The class of ``body`` that ``member`` belongs to, if one."""
    return next((node for node in body if isinstance(node, ast.ClassDef)
                 and any(m is member for m in node.body)), None)


def _starts_a_device(words: list) -> bool:
    """Whether a command line's constant words start the standalone or run
    the command line's ``metrics-doc``: both build a kernel backend."""
    return STANDALONE_MODULE in words or (CLI_MODULE in words and CLI_DEVICE_COMMAND in words)


def _called_name(call: ast.Call) -> str | None:
    """The name a call calls: ``f(...)`` or ``module.f(...)``."""
    if isinstance(call.func, ast.Name):
        return call.func.id
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return None


def _with_class_members(body: list[ast.AST]) -> list[tuple[ast.AST, bool]]:
    """A module's statements and its classes' members, each with whether it
    is a member, the last first (so that deleting one keeps the earlier
    ones' lines)."""
    out = []
    for node in body:
        out.append((node, False))
        if isinstance(node, ast.ClassDef):
            out.extend((member, True) for member in node.body)
    return sorted(out, key=lambda pair: pair[0].lineno, reverse=True)


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


def splice_runs(port: str, reference: str, runs=KERNEL_BACKEND_RUNS, copy=as_copied) -> str:
    """A partial copy (by default the kernel backend) with each copied run
    rewritten from the reference text by ``copy``."""
    lines = port.splitlines(keepends=True)
    for scope, first, last in runs:
        begin = BEGIN.format(first, last)
        i = next(k for k, line in enumerate(lines) if line.strip() == begin)
        j = next(k for k in range(i + 1, len(lines)) if lines[k].strip() == END)
        run = copy(reference_run(reference, scope, first, last))
        lines[i + 1:j] = run.splitlines(keepends=True)
    return "".join(lines)


def as_test_code(text: str) -> str:
    """Test code as a port module copies it: ``as_copied``, each call of
    ``TEST_CODE_CALLS`` the port's."""
    text = as_copied(text)
    for reference_text, port_text in TEST_CODE_CALLS.items():
        text = text.replace(reference_text, port_text)
    return text


def copy_rule(rel: str):
    """How the port copies the reference's ``rel``."""
    return as_copied_with_paths if rel in PORT_PATHS else as_copied


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--check", action="store_true",
                        help="list the copies that differ; write nothing")
    args = parser.parse_args(argv)
    stale = []
    copies = [(PORT / rel, copy_rule(rel)((REFERENCE / rel).read_text()))
              for rel in WHOLE_COPIES]
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
        want = splice_runs(text, (REFERENCE / rel).read_text(), runs, copy_rule(rel))
        if want != text:
            stale.append(dst.relative_to(REPO).as_posix())
            if not args.check:
                dst.write_text(want)
    for rel, runs in TEST_CODE_COPIES.items():
        dst = PORT / rel
        text = want = dst.read_text()
        for name, first, last in runs:
            want = splice_runs(want, (TESTS / name).read_text(), ((None, first, last),),
                               as_test_code)
        if want != text:
            stale.append(dst.relative_to(REPO).as_posix())
            if not args.check:
                dst.write_text(want)
    for rel in stale:
        print(("differs: " if args.check else "wrote: ") + rel)
    return 1 if args.check and stale else 0


if __name__ == "__main__":
    sys.exit(main())
