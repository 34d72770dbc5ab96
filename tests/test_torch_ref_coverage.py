"""Every test file of the reference has its place on the port.

Each ``tests/test_*.py`` of the JAX package (the ``test_torch_*`` files are
the port's) falls in exactly one class of ``zeebe_tpu_torch/testing/
copies.py``'s tables:

- it runs on the port as ``tests/test_torch_ref_<name>``
  (``REFERENCE_TESTS``);
- it tests copies: every module of the reference it imports is one the
  port keeps whole, held to the reference's text (``WHOLE_COPIES``), and it
  imports nothing else of the repository (no benchmark, no JAX, no helper of
  the tests), so it tests the port's code as much as the reference's;
- the port's own test files run its flows or seeds on both packages
  (``COVERED_BY``);
- it tests the JAX package's own wall clock or benchmark (``JAX_OWN``).

A file in none of them, a file in two, or a table naming a file that does
not exist fails here.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from zeebe_tpu_torch.testing import copies

REPO = Path(__file__).resolve().parents[1]
TESTS = REPO / "tests"
REFERENCE = sorted(p.name for p in TESTS.glob("test_*.py")
                   if not p.name.startswith("test_torch_"))
#: top-level modules of the repository that a test of copies may not import
OTHER = ("bench", "__graft_entry__", "jax", "tests")


def imported(text: str) -> tuple[set[str], set[str]]:
    """The reference modules a test file imports (anywhere in it; for ``from
    a import b`` both ``a`` and ``a.b``), and its other imports of the
    repository or of JAX."""
    ours, other = set(), set()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top == "zeebe_tpu":
                ours.add(name)
            elif top in OTHER:
                other.add(name)
    return ours, other


def module_file(name: str) -> str | None:
    """The file of reference module ``name``, relative to the package (None
    where the name is not a module: a class or a function)."""
    parts = name.split(".")[1:]
    base = REPO.joinpath("zeebe_tpu", *parts)
    if base.with_suffix(".py").is_file():
        return "/".join(parts) + ".py"
    if (base / "__init__.py").is_file():
        return "/".join(parts + ["__init__.py"])
    return None


def copies_only(text: str) -> bool:
    """Whether a test file imports reference modules, each a whole copy,
    and nothing else of the repository."""
    ours, other = imported(text)
    files = {f for f in map(module_file, ours) if f is not None}
    return bool(files) and not other and files <= set(copies.WHOLE_COPIES)


def classes(name: str, text: str) -> list[str]:
    """The classes reference test file ``name`` (of text ``text``) is in."""
    out = []
    if name in copies.REFERENCE_TESTS:
        out.append("runs on the port")
    elif copies_only(text):
        out.append("tests copies")
    if name in copies.COVERED_BY:
        out.append("covered by " + ", ".join(copies.COVERED_BY[name]))
    if name in copies.JAX_OWN:
        out.append("the JAX package's own")
    return out


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_test_file_is_in_exactly_one_class(name):
    assert len(classes(name, (TESTS / name).read_text())) == 1, \
        (name, classes(name, (TESTS / name).read_text()))


def test_a_file_in_no_class_fails():
    """A reference test file of a rewritten module (the automaton), named in
    no table, is in no class; one of copies only is in one."""
    automaton = "from zeebe_tpu.ops import automaton\n"
    assert classes("test_unlisted.py", automaton) == []
    assert classes("test_unlisted.py", "from zeebe_tpu.protocol import msgpack\n") == \
        ["tests copies"]
    assert classes("test_unlisted.py", "import bench\nfrom zeebe_tpu.state import db\n") == []
    assert module_file("zeebe_tpu.protocol.msgpack") == "protocol/msgpack.py"
    assert module_file("zeebe_tpu.protocol.ValueType") is None


@pytest.mark.parametrize("name", sorted(copies.COVERED_BY))
def test_covering_files_exist_and_name_their_reference(name):
    """A ``COVERED_BY`` entry names a reference test file and port test files
    that exist, each naming the reference file it runs."""
    assert name in REFERENCE
    stem = name.removesuffix(".py")
    for covering in copies.COVERED_BY[name]:
        assert covering.startswith("test_torch_"), covering
        path = TESTS / covering
        assert path.is_file(), covering
        assert stem in path.read_text(), (covering, stem)


def test_tables_name_reference_files():
    for table in (copies.REFERENCE_TESTS, copies.COVERED_BY, copies.JAX_OWN,
                  copies.NOT_PORTED):
        assert set(table) <= set(REFERENCE), set(table) - set(REFERENCE)
    for name, reason in copies.JAX_OWN.items():
        assert isinstance(reason, str) and len(reason) > 20, name
    assert len(copies.REFERENCE_TESTS) == len(set(copies.REFERENCE_TESTS))


def test_every_reference_test_that_runs_on_the_port_has_its_copy():
    for name in copies.REFERENCE_TESTS:
        assert copies.reference_test_copy(name).is_file(), name
