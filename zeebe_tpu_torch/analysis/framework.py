"""zlint rule framework: parsed modules, findings, baseline, suppressions.

Design constraints:

- **stdlib only.** ``cli lint`` runs before anything else and must never
  import torch: a hung CUDA driver hanging the *linter* would be the
  punchline to the very defect class rule 2 exists for, and a client's
  command line pays for no torch it does not use.
- **Line-number-free baseline keys.** A finding's identity is
  ``(rule, path, scope, code)`` — enclosing-function qualname plus the
  stripped source line — so a committed baseline survives unrelated edits
  above the flagged line. Two identical flagged lines in the same function
  share one baseline entry on purpose (they are the same decision).
- **Inline suppressions** (``# zlint: disable=<rule>[,<rule>…]`` or
  ``disable=all``) apply to the flagged line or the enclosing ``def``
  line — for exceptions whose justification belongs next to the code.
  The committed baseline is for pre-existing/architectural exceptions whose
  justification belongs in one reviewable place.

The port lints its own tree (``zeebe_tpu_torch/`` and ``chip_smoke.py``)
against its own baseline, ``zeebe_tpu_torch/.zlint-baseline``; the
reference's tree and baseline are the reference's.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable

#: the port's baseline, relative to the repo root
BASELINE_FILENAME = "zeebe_tpu_torch/.zlint-baseline"

#: files the lint walk covers, relative to the repo root. Tests are excluded
#: deliberately: they provoke violations on purpose (fixtures under
#: tests/fixtures/lint/ and tests/torch_lint_fixtures/ are the rule suite's
#: own corpus).
LINT_GLOBS = ("zeebe_tpu_torch/**/*.py", "chip_smoke.py")

# copied from the reference: _SUPPRESS_RE .. format_baseline
_SUPPRESS_RE = re.compile(r"#\s*zlint:\s*disable=([A-Za-z0-9_,\- ]+)")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str      # repo-relative posix path
    line: int      # 1-based
    col: int
    scope: str     # enclosing function qualname, or "<module>"
    code: str      # stripped source of the flagged line
    message: str

    @property
    def baseline_key(self) -> tuple[str, str, str, str]:
        return (self.rule, self.path, self.scope, self.code)

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: [{self.rule}] "
                f"{self.message}\n    {self.code}")


class ParsedModule:
    """One parsed source file plus the derived indexes rules share: the
    qualname of every node's enclosing function and per-line suppression
    sets. Parsed once, visited by every rule."""

    def __init__(self, root: Path, path: Path) -> None:
        self.path = path
        self.relpath = path.relative_to(root).as_posix()
        self.source = path.read_text(encoding="utf-8")
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=str(path))
        self._scope_of: dict[ast.AST, str] = {}
        self._def_line_of_scope: dict[str, int] = {}
        self._index_scopes(self.tree, ())
        self._suppressed: dict[int, set[str]] = {}
        for lineno, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if m:
                names = {n.strip() for n in m.group(1).split(",") if n.strip()}
                self._suppressed[lineno] = names

    def _index_scopes(self, node: ast.AST, stack: tuple[str, ...]) -> None:
        for child in ast.iter_child_nodes(node):
            child_stack = stack
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                child_stack = stack + (child.name,)
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._def_line_of_scope.setdefault(
                        ".".join(child_stack), child.lineno)
            self._scope_of[child] = ".".join(child_stack) or "<module>"
            self._index_scopes(child, child_stack)

    def scope_of(self, node: ast.AST) -> str:
        return self._scope_of.get(node, "<module>")

    def has_function(self, qual: str) -> bool:
        """True when ``qual`` names a function in this module, or a scope
        one of this module's functions lives under."""
        return any(q == qual or q.startswith(qual + ".")
                   for q in self._def_line_of_scope)

    def line_source(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def is_suppressed(self, rule: str, node: ast.AST) -> bool:
        lines = [getattr(node, "lineno", 0)]
        def_line = self._def_line_of_scope.get(self.scope_of(node))
        if def_line is not None:
            lines.append(def_line)
        for lineno in lines:
            names = self._suppressed.get(lineno)
            if names and (rule in names or "all" in names):
                return True
        return False

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        lineno = getattr(node, "lineno", 1)
        return Finding(
            rule=rule, path=self.relpath, line=lineno,
            col=getattr(node, "col_offset", 0) + 1,
            scope=self.scope_of(node),
            code=self.line_source(lineno), message=message)


class Rule:
    """A named invariant. Subclasses set ``name``/``summary`` and implement
    either ``check(module)`` (per-module) or ``check_tree(modules)``
    (cross-module rules like drift-copy)."""

    name: str = ""
    summary: str = ""
    cross_module: bool = False

    def check(self, module: ParsedModule) -> list[Finding]:
        return []

    def check_tree(self, modules: list[ParsedModule]) -> list[Finding]:
        return []

    def validate(self, modules: list[ParsedModule]) -> list[Finding]:
        """Report scope/root registrations that no longer match anything in
        the tree. A rename that orphans a registration must FAIL the lint,
        not silently disable the invariant it anchored (the rule equivalent
        of the baseline's stale-entry report)."""
        return []

    def registration_finding(self, entry: str, message: str) -> Finding:
        """A synthetic finding for a stale registration — anchored on the
        rule table itself, since the registered target no longer exists."""
        return Finding(rule=self.name, path="zeebe_tpu_torch/analysis/rules.py",
                       line=1, col=1, scope="<registration>", code=entry,
                       message=message)


def parse_tree(root: Path) -> list[ParsedModule]:
    root = Path(root)
    modules: list[ParsedModule] = []
    seen: set[Path] = set()
    for pattern in LINT_GLOBS:
        for path in sorted(root.glob(pattern)):
            if "__pycache__" in path.parts or path in seen:
                continue
            seen.add(path)
            try:
                modules.append(ParsedModule(root, path))
            except (SyntaxError, UnicodeDecodeError, OSError) as exc:
                raise RuntimeError(f"zlint cannot parse {path}: {exc}") from exc
    return modules


def run_lint(root: Path | str, rules: Iterable[Rule] | None = None
             ) -> list[Finding]:
    """All unsuppressed findings over the repo at ``root`` (baseline NOT
    applied — see :func:`split_findings`)."""
    from zeebe_tpu_torch.analysis.rules import RULES

    root = Path(root)
    modules = parse_tree(root)
    findings: list[Finding] = []
    for rule in (rules if rules is not None else RULES):
        findings.extend(rule.validate(modules))
        if rule.cross_module:
            findings.extend(rule.check_tree(modules))
        else:
            for module in modules:
                findings.extend(rule.check(module))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# -- baseline ------------------------------------------------------------------
#
# Tab-separated, one intentional exception per line:
#   rule<TAB>path<TAB>scope<TAB>code<TAB>justification
# Keys are line-number-free (see module docstring). `cli lint
# --update-baseline` regenerates the file, preserving justifications of
# surviving entries and stamping new ones with "TODO: justify".

_BASELINE_HEADER = """\
# zlint baseline — intentional exceptions to the invariant rules.
# One per line: rule<TAB>path<TAB>scope<TAB>flagged-code<TAB>justification.
# Regenerate with `python -m zeebe_tpu_torch.cli lint --update-baseline` (it
# preserves the justifications of surviving entries); every new entry MUST
# replace its "TODO: justify" stamp before merging. `cli lint --check`
# fails on findings absent from this file.
"""


def load_baseline(path: Path | str) -> dict[tuple[str, str, str, str], str]:
    """{baseline_key: justification} from a baseline file (missing = {})."""
    path = Path(path)
    if not path.exists():
        return {}
    entries: dict[tuple[str, str, str, str], str] = {}
    for raw in path.read_text(encoding="utf-8").splitlines():
        if not raw.strip() or raw.lstrip().startswith("#"):
            continue
        parts = raw.split("\t")
        if len(parts) < 4:
            raise ValueError(f"malformed baseline line: {raw!r}")
        rule, rel, scope, code = parts[0], parts[1], parts[2], parts[3]
        justification = parts[4] if len(parts) > 4 else ""
        entries[(rule, rel, scope, code)] = justification
    return entries


def split_findings(
    findings: list[Finding],
    baseline: dict[tuple[str, str, str, str], str],
) -> tuple[list[Finding], list[tuple[str, str, str, str]]]:
    """(new findings not covered by the baseline, stale baseline keys that
    matched nothing)."""
    keys = {f.baseline_key for f in findings}
    new = [f for f in findings if f.baseline_key not in baseline]
    stale = [k for k in baseline if k not in keys]
    return new, stale


def format_baseline(
    findings: list[Finding],
    previous: dict[tuple[str, str, str, str], str] | None = None,
) -> str:
    """Render a baseline covering ``findings``, carrying justifications over
    from ``previous`` where the key survives."""
    previous = previous or {}
    lines = [_BASELINE_HEADER]
    seen: set[tuple[str, str, str, str]] = set()
    for f in sorted(findings, key=lambda f: f.baseline_key):
        key = f.baseline_key
        if key in seen:
            continue
        seen.add(key)
        justification = previous.get(key, "").strip() or "TODO: justify"
        lines.append("\t".join([*key, justification]))
    return "\n".join(lines) + "\n"
# end of the copy
