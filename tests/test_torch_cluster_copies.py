"""The port's replicated broker cluster is the reference's, copied; what
differs is named here.

Every module of ``testing/copies.py``'s ``CLUSTER_STACK`` equals
``as_copied`` of its reference. The partition, the broker, Raft and the
gateway's cluster runtime are partial copies (``PARTIAL_COPIES``): their
marked runs are what the copy script writes, and every other reference member is in
``PORT_MEMBERS`` below: either the reference's member plus the kernel
backend's ``device`` (and, on ``InProcessCluster``, ``kernel_backend``) —
held to the reference's with those names taken out — or rewritten whole,
with the reason. Also here: no module of the port's broker, cluster,
control or utilities packages loads JAX, the reference or gRPC, and the
gateway and client packages load gRPC but neither JAX nor the reference.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_tables import as_copied
from zeebe_tpu_torch.testing import copies

REPO = Path(__file__).resolve().parents[1]
REF = REPO / "zeebe_tpu"
PORT = REPO / "zeebe_tpu_torch"

#: the port's members of each partial copy outside its copied runs, by
#: (class or None, name): the names the port adds to the reference's member
#: (an argument, a keyword passed on, an attribute or a field), or the
#: reason it is rewritten whole
PORT_MEMBERS = {
    "broker/partition.py": {
        # ``resolve_device`` is imported where the backend's device is
        # resolved, so that a client or a gateway loads no torch
        ("ZeebePartition", "__init__"): {"device", "resolve_device"},
        ("ZeebePartition", "_transition"): {"device"},
    },
    "broker/broker.py": {
        (None, "BrokerCfg"): {"device"},
        (None, "_auto_device_count"): "counts the CUDA cards in the probe's child; 1 on the CPU",
        ("Broker", "_mesh_runner"): {"device"},
        ("Broker", "_create_partition"): {"device"},
        ("InProcessCluster", "__init__"): {"device", "kernel_backend"},
        ("InProcessCluster", "add_broker"): {"device", "kernel_backend"},
    },
    "cluster/raft.py": {
        ("RaftNode", "_start_prevote"):
            "drops the leader when the timer fires, as raft's pre-candidate does: the "
            "reference's kept it and denied every first pre-vote after a leader's death",
        ("RaftNode", "_on_vote_request"):
            "the reference's answer; then a member that can win where the requester cannot "
            "(a pre-vote from a shorter log, a split vote it wins on log and member id) "
            "sets its election timer to fire at once: the reference's waited for a timer "
            "that could leave the partition without a leader for another election timeout",
    },
    "gateway/broker_client.py": {
        ("ClusterRuntime", "__init__"): {"device"},
        ("ClusterRuntime", "has_activatable_jobs"):
            "answers True where the partition's lock is held past the peek's second, as "
            "the other runtimes answer for a leader they cannot peek at: the reference's "
            "False lost the job push's notification",
    },
}
#: imports a partial copy adds to the reference's
ADDED_IMPORTS = {
    "broker/partition.py": set(),
    "broker/broker.py": set(),
    "cluster/raft.py": set(),
    "gateway/broker_client.py": set(),
}
PARTIAL = sorted(PORT_MEMBERS)


@pytest.mark.parametrize("path", copies.CLUSTER_STACK)
def test_cluster_module_is_a_copy(path):
    assert (PORT / path).read_text() == as_copied((REF / path).read_text())


def check_copied_runs(path: str) -> None:
    """A partial copy's marked runs are what the copy script writes."""
    text = (PORT / path).read_text()
    runs = copies.PARTIAL_COPIES[path]
    assert copies.splice_runs(text, (REF / path).read_text(), runs,
                              copies.copy_rule(path)) == text
    for scope, first, last in runs:
        assert copies.BEGIN.format(first, last) in text


@pytest.mark.parametrize("path", PARTIAL)
def test_copied_runs_are_the_scripts(path):
    check_copied_runs(path)


def _copied(text: str, runs) -> set:
    """(scope, name) of every definition inside a copied run."""
    out = set()
    for scope, first, last in runs:
        body = copies.definitions(text, scope)
        i, j = copies.run_span(body, first, last)
        out |= {(scope, copies.definition_name(n)) for n in body[i:j + 1]}
    return out - {(s, None) for s, _, _ in runs}


def _members(text: str, classes) -> dict:
    """(scope, name) → node of every named module-level statement and of
    every member of ``classes``; a class docstring as ``<doc>``."""
    out = {}
    for node in ast.parse(text).body:
        name = copies.definition_name(node)
        if name is None:
            continue
        if isinstance(node, ast.ClassDef) and name in classes:
            for m in node.body:
                if isinstance(m, ast.Expr) and isinstance(m.value, ast.Constant):
                    out[(name, "<doc>")] = m
                elif copies.definition_name(m) is not None:
                    out[(name, copies.definition_name(m))] = m
        else:
            out[(None, name)] = node
    return out


def _texts(path: str) -> tuple[str, str]:
    ref = as_copied((REF / path).read_text())
    if path in copies.PORT_PATHS:  # these copies rename the reference's path too
        ref = ref.replace("zeebe_tpu/", "zeebe_tpu_torch/")
    return ref, (PORT / path).read_text()


def _classes(path: str) -> set:
    return {s for s, _, _ in copies.PARTIAL_COPIES[path] if s}


def check_members_copied_or_named(path: str, port_members: dict) -> None:
    """Every reference member of a partial copy is in a copied run or named
    in ``port_members``; the port has the same members and class
    docstrings."""
    ref, port = _texts(path)
    classes = _classes(path)
    copied = _copied(ref, copies.PARTIAL_COPIES[path])
    named = set(port_members)
    ref_members, port_members = _members(ref, classes), _members(port, classes)
    # a class holding copied runs is compared member by member
    outside = {k for k in ref_members if not (k[0] is None and k[1] in classes)}
    assert outside - copied - {(c, "<doc>") for c in classes} == named
    assert set(port_members) == set(ref_members)
    for key in [k for k in ref_members if k[1] == "<doc>"]:
        assert ast.dump(port_members[key]) == ast.dump(ref_members[key])


@pytest.mark.parametrize("path", PARTIAL)
def test_every_member_is_copied_or_named(path):
    check_members_copied_or_named(path, PORT_MEMBERS[path])


class _Without(ast.NodeTransformer):
    """A member without the names the port adds: the argument and its
    default, the keyword passed on, the attribute set on ``self``, the
    dataclass field and the function-local import."""

    def __init__(self, names: set) -> None:
        self.names = names

    def visit_arguments(self, node: ast.arguments) -> ast.arguments:
        first = len(node.args) - len(node.defaults)
        kept = [(a, d) for a, d in zip(node.args[first:], node.defaults)
                if a.arg not in self.names]
        node.args = node.args[:first] + [a for a, _ in kept]
        node.defaults = [d for _, d in kept]
        return self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> ast.Call:
        node.keywords = [k for k in node.keywords if k.arg not in self.names]
        return self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign):
        target = node.targets[0]
        if (isinstance(target, ast.Attribute) and isinstance(target.value, ast.Name)
                and target.value.id == "self" and target.attr in self.names):
            return None
        return self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if all((a.asname or a.name) in self.names for a in node.names):
            return None
        return node

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if isinstance(node.target, ast.Name) and node.target.id in self.names:
            return None
        return self.generic_visit(node)


def _without(node: ast.AST, names: set) -> str:
    tree = ast.parse(ast.unparse(node))
    return ast.dump(_Without(names).visit(tree).body[0])


EXTENDED = [(path, scope, name) for path in PARTIAL
            for (scope, name), names in PORT_MEMBERS[path].items() if isinstance(names, set)]


@pytest.mark.parametrize("path,scope,name", EXTENDED,
                         ids=[f"{p}:{s or 'module'}.{n}" for p, s, n in EXTENDED])
def test_member_is_the_references_plus_the_device(path, scope, name):
    check_member_plus_names(path, scope, name, PORT_MEMBERS[path][(scope, name)])


def check_member_plus_names(path: str, scope, name: str, names: set) -> None:
    """A partial copy's member is the reference's without ``names``, and
    differs from it."""
    ref, port = _texts(path)
    classes = _classes(path)
    ref_node = _members(ref, classes)[(scope, name)]
    port_node = _members(port, classes)[(scope, name)]
    assert _without(port_node, names) == _without(ref_node, names)
    # and the port's member does take them
    assert ast.dump(port_node) != ast.dump(ref_node)


def check_imports(path: str, added: set) -> None:
    """A partial copy's module imports are the reference's and ``added``."""
    ref, port = _texts(path)

    def imports(text):
        return {ast.unparse(n) for n in ast.parse(text).body
                if isinstance(n, (ast.Import, ast.ImportFrom))}

    assert imports(port) == imports(ref) | added


@pytest.mark.parametrize("path", PARTIAL)
def test_imports_are_the_references_plus_the_named(path):
    check_imports(path, ADDED_IMPORTS[path])


_IMPORT_SCRIPT = """
import importlib, json, pkgutil, sys
import zeebe_tpu_torch


def load(packages):
    names = []
    for package in packages:
        pkg = importlib.import_module(f"zeebe_tpu_torch.{package}")
        for info in pkgutil.iter_modules(pkg.__path__):
            names.append(f"zeebe_tpu_torch.{package}.{info.name}")
            importlib.import_module(names[-1])
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "zeebe_tpu", "grpc"))
    return len(names), loaded


print(json.dumps({"cluster": load(("broker", "cluster", "control", "utils")),
                  "gateway": load(("gateway", "gateway.proto", "client"))}))
"""


def test_cluster_packages_load_no_jax_reference_or_grpc():
    """Every module of the port's broker, cluster, control and utilities
    packages imports in a fresh interpreter, and none of them loads JAX,
    the reference package or gRPC. The gateway and client packages, loaded
    after them, bring in gRPC (the gRPC front, as the reference's do) but
    neither JAX nor the reference."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    (n_cluster, cluster), (n_gateway, gateway) = out["cluster"], out["gateway"]
    assert n_cluster >= 20 and cluster == [], cluster
    assert n_gateway >= 10 and {m.split(".")[0] for m in gateway} == {"grpc"}, gateway
