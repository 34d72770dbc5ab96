"""Import guards. A run may hold nothing of JAX or of the JAX package in
its process, and the reference may import nothing of JAX, the JAX package
or the program. Module names are compared by their top-level name (the
part before the first dot) as a whole: ``zeebe_tpu_torch`` begins with
``zeebe_tpu`` and is a different package."""

from __future__ import annotations

import ast
from pathlib import Path

#: top-level modules no run may load
FORBIDDEN_IN_RUN = frozenset({"jax", "jaxlib", "flax", "zeebe_tpu"})
#: top-level modules the reference may not import
FORBIDDEN_IN_REFERENCE = FORBIDDEN_IN_RUN | {"zeebe_tpu_torch", "torch"}


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules) -> list[str]:
    """The names among ``modules`` (such as ``sys.modules``) whose
    top-level name is forbidden in a run."""
    return sorted(m for m in modules if top_level(m) in FORBIDDEN_IN_RUN)


def imports_of(source: str) -> set[str]:
    """Every module a Python source imports, absolute imports only."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def reference_violations(reference_dir: Path) -> list[str]:
    """``file: module`` for each forbidden import under ``reference_dir``."""
    out = []
    for path in sorted(reference_dir.glob("*.py")):
        for name in sorted(imports_of(path.read_text())):
            if top_level(name) in FORBIDDEN_IN_REFERENCE:
                out.append(f"{path.name}: {name}")
    return out
