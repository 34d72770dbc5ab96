"""zlint rule catalog: the port's load-bearing invariants as AST visitors.

The reference's eight rules over the port's paths. Six keep the
reference's logic; rule 2 (device-call discipline) names the in-process
``torch.cuda`` queries and the places the port's design queries the card,
and rule 8 (kernel-result commit discipline) names the port's
device-result primitives and its fault seam in ``engine/kernel_backend.py``.
Each rule's *scope* (which files/functions it applies to) is
constructor-injectable so the fixture tests (``tests/fixtures/lint/``,
``tests/torch_lint_fixtures/``) can point a rule at an arbitrary file; the
module-level ``RULES`` list carries the production scopes.

Honest limits: matching is syntactic over resolved import aliases — a
banned call laundered through a variable (``f = time.time; f()``) escapes
the AST; the runtime sanitizer (zeebe_tpu_torch/testing/sanitizer.py) is
the dynamic complement that catches what ASTs can't see.
"""

from __future__ import annotations

import ast
import copy
import hashlib
from typing import Iterable

from zeebe_tpu_torch.analysis.framework import Finding, ParsedModule, Rule

# copied from the reference: _import_aliases .. ReplayDeterminismRule
def _import_aliases(tree: ast.Module) -> dict[str, str]:
    """{local name: canonical dotted name} from every import statement in the
    module (any nesting level) — so ``import time as _t; _t.time()`` and
    ``from time import time`` both resolve to ``time.time``."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".", 1)[0]] = (
                    a.name if a.asname else a.name.split(".", 1)[0])
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _dotted(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Canonical dotted name of a Name/Attribute chain, alias-resolved; None
    for anything more dynamic (subscripts, calls)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(aliases.get(node.id, node.id))
    return ".".join(reversed(parts))


def _matches(dotted: str, banned: Iterable[str]) -> str | None:
    """The banned pattern ``dotted`` hits, if any: exact names or
    ``prefix.*`` wildcard patterns."""
    for pattern in banned:
        if pattern.endswith(".*"):
            if dotted.startswith(pattern[:-1]):
                return pattern
        elif dotted == pattern:
            return pattern
    return None


def _validate_scoped_entries(rule: Rule, entries, modules,
                             what: str) -> list[Finding]:
    """Shared stale-registration check for (path, qualname-prefix | None)
    tables: the path must name a linted module and the prefix (when given)
    must still resolve to a function scope in it."""
    by_path = {m.relpath: m for m in modules}
    out: list[Finding] = []
    for path, prefix in entries:
        module = by_path.get(path)
        if module is None:
            out.append(rule.registration_finding(
                f"{path} :: {prefix or '<whole module>'}",
                f"stale {what} registration: `{path}` matches no linted "
                f"file — the file was moved/renamed and this rule is "
                f"silently scanning nothing; update the registration"))
        elif prefix is not None and not module.has_function(prefix):
            out.append(rule.registration_finding(
                f"{path} :: {prefix}",
                f"stale {what} registration: `{prefix}` no longer names a "
                f"function in {path} — the symbol was renamed and this "
                f"rule is silently scanning nothing; update the "
                f"registration"))
    return out


# ---------------------------------------------------------------------------
# rule 1: replay determinism


_NONDETERMINISTIC_CALLS = (
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today", "datetime.now",
    "datetime.utcnow", "datetime.today", "date.today",
    "random.*", "os.urandom", "uuid.*", "secrets.*",
    "os.environ.get", "os.getenv", "hash",
)

#: construct → called-with wrappers that MAKE the order deterministic
_ORDERING_SANITIZERS = {"sorted", "len", "sum", "min", "max", "any", "all"}

#: wrappers that PRESERVE the unordered iteration order (flagged)
_ORDER_SENSITIVE_WRAPPERS = {"list", "tuple", "enumerate", "iter", "next"}


def _is_unordered_expr(node: ast.AST, aliases: dict[str, str]) -> bool:
    """Syntactically-recognizable unordered collection: a set literal, a set
    comprehension, or a direct set()/frozenset() construction."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        dotted = _dotted(node.func, aliases)
        return dotted in ("set", "frozenset")
    return False


class ReplayDeterminismRule(Rule):
    """No wall clocks / RNGs / env reads / set-iteration-order dependence in
    replay-deterministic code: appliers, state facades, and
    ``BurstTemplate.apply_state``. Replay must rebuild byte-identical state
    (Raft determinism), and each of these constructs can differ between the
    processing run and the replay run."""

    name = "replay-determinism"
    summary = ("appliers/state facades must be clock-, RNG-, env- and "
               "set-order-free: replay rebuilds state from the log alone")

    #: (path, scope-qualname-prefix | None=whole module)
    DEFAULT_SCOPE = (
        ("zeebe_tpu_torch/engine/appliers.py", None),
        ("zeebe_tpu_torch/engine/engine_state.py", None),
        ("zeebe_tpu_torch/engine/burst_templates.py", "BurstTemplate.apply_state"),
        ("zeebe_tpu_torch/state/db.py", None),
        ("zeebe_tpu_torch/state/durable.py", None),
        ("zeebe_tpu_torch/state/tiering.py", None),
        ("zeebe_tpu_torch/state/snapshot.py", None),
        ("zeebe_tpu_torch/state/request_dedupe.py", None),
    )

    def __init__(self, scope=None) -> None:
        self.scope = self.DEFAULT_SCOPE if scope is None else tuple(scope)

    def validate(self, modules):
        return _validate_scoped_entries(self, self.scope, modules,
                                        "determinism-scope")

    def _in_scope(self, module: ParsedModule, node: ast.AST) -> bool:
        for path, prefix in self.scope:
            if module.relpath != path:
                continue
            if prefix is None:
                return True
            qual = module.scope_of(node)
            if qual == prefix or qual.startswith(prefix + "."):
                return True
        return False

    def check(self, module: ParsedModule) -> list[Finding]:
        if not any(module.relpath == path for path, _ in self.scope):
            return []
        aliases = _import_aliases(module.tree)
        out: list[Finding] = []

        def flag(node: ast.AST, message: str) -> None:
            if (self._in_scope(module, node)
                    and not module.is_suppressed(self.name, node)):
                out.append(module.finding(self.name, node, message))

        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                dotted = _dotted(node.func, aliases)
                if dotted is not None:
                    hit = _matches(dotted, _NONDETERMINISTIC_CALLS)
                    if hit is not None:
                        flag(node, f"nondeterministic call `{dotted}` in "
                                   f"replay-deterministic code (banned: {hit})")
                # order-preserving wrapper over an unordered collection
                if (dotted in _ORDER_SENSITIVE_WRAPPERS and node.args
                        and _is_unordered_expr(node.args[0], aliases)):
                    flag(node, f"`{dotted}(...)` over a set preserves "
                               f"arbitrary iteration order — wrap in "
                               f"sorted(...) to make replay deterministic")
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "join" and node.args
                        and _is_unordered_expr(node.args[0], aliases)):
                    flag(node, "`.join(...)` over a set depends on set "
                               "iteration order — sort first")
            elif isinstance(node, ast.For):
                if _is_unordered_expr(node.iter, aliases):
                    flag(node.iter, "iterating a set in replay-deterministic "
                                    "code — iteration order is arbitrary; "
                                    "wrap in sorted(...)")
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                for gen in node.generators:
                    if _is_unordered_expr(gen.iter, aliases):
                        flag(gen.iter, "comprehension over a set in "
                                       "replay-deterministic code — wrap in "
                                       "sorted(...)")
            elif (isinstance(node, ast.Subscript)
                  and _dotted(node.value, aliases) == "os.environ"):
                flag(node, "os.environ read in replay-deterministic code — "
                           "environment can differ between processing and "
                           "replay nodes")
        return out
# end of the copy


# ---------------------------------------------------------------------------
# rule 2: device-call discipline


#: the in-process CUDA queries: each asks the driver about the card, and a
#: wedged driver or card can hang the first one a process makes
_DEVICE_CALLS = (
    "torch.cuda.is_available", "torch.cuda.device_count", "torch.cuda.current_device",
    "torch.cuda.get_device_properties", "torch.cuda.get_device_name",
    "torch.cuda.mem_get_info", "torch.cuda.init", "torch.cuda.set_device",
)


class DeviceCallDisciplineRule(Rule):
    """No in-process CUDA query outside the killable probe and the places
    that run after it: a wedged CUDA driver or card can hang a process's
    first CUDA call forever, so a process that has not touched the card
    learns whether it answers from ``utils/backend_probe`` (the query in a
    subprocess with a SIGKILL deadline; ``boot_card`` is every entry
    point's start-up guard). Allowed besides the probe:
    ``ops/automaton.resolve_device``, the one resolution of the device a
    caller asked for, which the entry points reach only after the probe's
    verdict; and ``chip_smoke.py``, the card's own smoke, which runs only
    where a card is expected and under its own time limit."""

    name = "device-call-discipline"
    summary = ("torch.cuda device queries only inside utils/backend_probe, "
               "ops/automaton.resolve_device and chip_smoke.py")

    #: (path, scope-prefix | None) locations allowed to query the card
    DEFAULT_ALLOWED = (
        ("zeebe_tpu_torch/utils/backend_probe.py", None),
        ("zeebe_tpu_torch/ops/automaton.py", "resolve_device"),
        ("chip_smoke.py", None),
    )

    def __init__(self, allowed=None) -> None:
        self.allowed = (self.DEFAULT_ALLOWED if allowed is None
                        else tuple(allowed))

    def validate(self, modules):
        return _validate_scoped_entries(self, self.allowed, modules,
                                        "allowed-location")

    def _allowed(self, module: ParsedModule, node: ast.AST) -> bool:
        for path, prefix in self.allowed:
            if module.relpath != path:
                continue
            if prefix is None:
                return True
            qual = module.scope_of(node)
            if qual == prefix or qual.startswith(prefix + "."):
                return True
        return False

    def check(self, module: ParsedModule) -> list[Finding]:
        aliases = _import_aliases(module.tree)
        out: list[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func, aliases)
            if dotted is None or _matches(dotted, _DEVICE_CALLS) is None:
                continue
            if self._allowed(module, node):
                continue
            if module.is_suppressed(self.name, node):
                continue
            out.append(module.finding(
                self.name, node,
                f"in-process CUDA query `{dotted}` outside the killable "
                f"probe — a wedged driver or card hangs this forever; "
                f"route through utils/backend_probe or run it only after "
                f"the probe's verdict"))
        return out


# copied from the reference: _BLOCKING_CALLS .. StorageIoDisciplineRule
_BLOCKING_CALLS = (
    "time.sleep", "os.fsync", "os.sync",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
    "socket.socket", "socket.create_connection",
    "urllib.request.urlopen", "requests.get", "requests.post",
    "requests.request",
)


class PumpBlockingIoRule(Rule):
    """No blocking I/O reachable (same-module) from a pump hook: the pump IS
    the partition's scheduler — one fsync or sleep on it stalls processing,
    exporters, snapshots, and ingress acks for every instance the partition
    serves. Roots: every function literally named ``pump`` plus the
    registered pump-stage extras below; reachability follows same-module
    ``self.x()`` / bare-name calls (cross-module blocking sinks are the
    runtime sanitizer's job)."""

    name = "pump-blocking-io"
    summary = ("no time.sleep/os.fsync/subprocess/socket calls reachable "
               "from pump hooks or kernel-dispatch stages")

    #: (path, root-qualname) pump-stage functions beyond the `pump` methods:
    #: ingress handlers and dispatch stages the broker drives from its pump
    #: thread. Registering a new pump hook means adding it here (and the
    #: fixture test pins the mechanism).
    DEFAULT_EXTRA_ROOTS = (
        ("zeebe_tpu_torch/multiproc/worker.py", "WorkerRuntime._on_client_command"),
        ("zeebe_tpu_torch/stream/processor.py", "StreamProcessor.run_until_idle"),
        ("zeebe_tpu_torch/stream/processor.py", "StreamProcessor.replay_available"),
        ("zeebe_tpu_torch/exporters/director.py", "ExporterDirector.export_available"),
        ("zeebe_tpu_torch/engine/kernel_backend.py", "KernelBackend.process_group"),
        ("zeebe_tpu_torch/engine/kernel_backend.py", "KernelBackend.begin_group"),
        ("zeebe_tpu_torch/engine/kernel_backend.py", "KernelBackend.finish_group"),
        # at-rest storage scrubber: its slice runs between
        # transactions on the partition pump — a sleep or fsync slipped
        # into a scrub walk stalls the whole partition
        ("zeebe_tpu_torch/broker/scrubber.py", "StorageScrubber.maybe_run"),
    )

    def __init__(self, extra_roots=None) -> None:
        self.extra_roots = (self.DEFAULT_EXTRA_ROOTS if extra_roots is None
                            else tuple(extra_roots))

    def validate(self, modules):
        return _validate_scoped_entries(self, self.extra_roots, modules,
                                        "pump-root")

    @staticmethod
    def _function_index(module: ParsedModule) -> dict[str, ast.AST]:
        index: dict[str, ast.AST] = {}
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # scope_of(def) is the def's own qualname (it includes the
                # function's name segment)
                index[module.scope_of(node)] = node
        return index

    @staticmethod
    def _callees(qual: str, fn: ast.AST, index: dict[str, ast.AST]
                 ) -> set[str]:
        """Same-module callees of ``fn``: ``self.x()`` resolves within the
        enclosing class, bare ``x()`` at module level."""
        cls = qual.rsplit(".", 2)[0] if qual.count(".") >= 1 else None
        out: set[str] = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                    and f.value.id in ("self", "cls") and cls is not None):
                candidate = f"{cls}.{f.attr}"
                if candidate in index:
                    out.add(candidate)
            elif isinstance(f, ast.Name) and f.id in index:
                out.add(f.id)
        return out

    def _roots(self, module: ParsedModule,
               index: dict[str, ast.AST]) -> list[str]:
        roots = [q for q in index
                 if q == "pump" or q.endswith(".pump")]
        for path, qual in self.extra_roots:
            if module.relpath == path and qual in index:
                roots.append(qual)
        return roots

    def check(self, module: ParsedModule) -> list[Finding]:
        index = self._function_index(module)
        roots = self._roots(module, index)
        if not roots:
            return []
        reachable: set[str] = set()
        frontier = list(roots)
        while frontier:
            qual = frontier.pop()
            if qual in reachable:
                continue
            reachable.add(qual)
            frontier.extend(self._callees(qual, index[qual], index))
        aliases = _import_aliases(module.tree)
        out: list[Finding] = []
        for qual in sorted(reachable):
            for node in ast.walk(index[qual]):
                if not isinstance(node, ast.Call):
                    continue
                dotted = _dotted(node.func, aliases)
                if dotted is None or _matches(dotted, _BLOCKING_CALLS) is None:
                    continue
                if module.is_suppressed(self.name, node):
                    continue
                out.append(module.finding(
                    self.name, node,
                    f"blocking call `{dotted}` reachable from pump hook "
                    f"`{qual}` — the pump is the partition's scheduler; "
                    f"one stall here stalls processing, exporters, and "
                    f"ingress acks"))
        return out


# ---------------------------------------------------------------------------
# rule 4: committed-read discipline


_TRANSACTIONAL_ATTRS = ("transaction", "require_transaction", "column_family")


class CommittedReadDisciplineRule(Rule):
    """Ingress/query modules may only read partition state through the
    committed accessors (``ZbDb.committed_get`` / ``committed_keys_of`` /
    ``Partition.lookup_request``): opening the processing-owned transaction
    slot from a gateway or management thread races the pump thread's own
    transaction (the ColdStore dict-changed-size class, generalized)."""

    name = "committed-read-discipline"
    summary = ("gateway/query threads read via committed_* accessors only — "
               "never the processing-owned transaction slot")

    DEFAULT_SCOPE = (
        "zeebe_tpu_torch/gateway/",
        "zeebe_tpu_torch/engine/query.py",
        "zeebe_tpu_torch/broker/management.py",
        "zeebe_tpu_torch/multiproc/runtime.py",
    )

    def __init__(self, scope=None) -> None:
        self.scope = self.DEFAULT_SCOPE if scope is None else tuple(scope)

    def validate(self, modules):
        out = []
        for entry in self.scope:
            if not any(m.relpath == entry or m.relpath.startswith(entry)
                       for m in modules):
                out.append(self.registration_finding(
                    entry,
                    f"stale ingress/query-scope registration: `{entry}` "
                    f"matches no linted file — the module was "
                    f"moved/renamed and this rule is silently scanning "
                    f"nothing; update the registration"))
        return out

    def _in_scope(self, module: ParsedModule) -> bool:
        return any(module.relpath == p or module.relpath.startswith(p)
                   for p in self.scope)

    def check(self, module: ParsedModule) -> list[Finding]:
        if not self._in_scope(module):
            return []
        out: list[Finding] = []
        for node in ast.walk(module.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _TRANSACTIONAL_ATTRS):
                if module.is_suppressed(self.name, node):
                    continue
                out.append(module.finding(
                    self.name, node,
                    f"`.{node.func.attr}(...)` in an ingress/query module — "
                    f"gateway and management threads must use "
                    f"ZbDb.committed_get / committed_keys_of / "
                    f"Partition.lookup_request; the transaction slot belongs "
                    f"to the pump thread"))
            elif (isinstance(node, ast.Attribute) and node.attr == "_data"
                  and ((isinstance(node.value, ast.Attribute)
                        and node.value.attr.lower().endswith("db"))
                       or (isinstance(node.value, ast.Name)
                           and node.value.id.lower().endswith("db")))):
                if module.is_suppressed(self.name, node):
                    continue
                out.append(module.finding(
                    self.name, node,
                    "raw `._data` access on a state store in an ingress/query "
                    "module — use the committed_* accessors"))
        return out


# ---------------------------------------------------------------------------
# rule 5: control actuation discipline


#: runtime knobs owned by a registered control-plane loop: the attribute
#: name plus the loop that owns its write path. The audit trail
#: (control_adjust flight events + zeebe_control_* metrics) is only
#: trustworthy if the actuator is the SINGLE runtime write path — a direct
#: assignment anywhere else mutates the knob invisibly.
_CONTROLLER_OWNED_ATTRS = {
    "flush_interval_s": "journal-flush controller (raft group-commit pacing)",
    "coalesce_window_ms": "ingress-coalescing controller (worker ingress "
                          "batch window)",
    "park_after_ms": "state-tiering controller (TieringCfg park horizon)",
    "spill_batch": "state-tiering controller (TieringCfg spill batch)",
    "route_threshold_s": "kernel-routing controller (BackendRouter "
                         "host-vs-device threshold)",
    "shed_level": "admission shed ladder (aggregated loop)",
}


class ControlActuationDisciplineRule(Rule):
    """Runtime mutation of a controller-owned knob outside a registered
    Actuator: assignments to the attributes above are legal only inside
    ``zeebe_tpu_torch/control/`` (the actuator framework) or in ``__init__``
    (construction seeds the static default — it is configuration, not a
    runtime decision). Anything else bypasses the bounds clamp, the
    max-step pacing, and the control_adjust audit trail; intentional
    exceptions (a loop that IS its own registered decision engine, like
    the admission shed ladder) are baselined with justifications.

    Honest limit (docs/static-analysis.md): ``setattr(obj, "knob", v)``
    with a dynamic name escapes the AST — the runtime sanitizer's
    actuator-thread assertion is the dynamic complement."""

    name = "control-actuation-discipline"
    summary = ("controller-owned runtime knobs mutate only through "
               "zeebe_tpu_torch/control actuators (construction in __init__ "
               "exempt)")
    cross_module = True

    #: module prefixes allowed to assign owned knobs (the actuator home)
    DEFAULT_ALLOWED_PREFIXES = ("zeebe_tpu_torch/control/",)

    def __init__(self, allowed_prefixes=None, owned=None) -> None:
        self.allowed_prefixes = (self.DEFAULT_ALLOWED_PREFIXES
                                 if allowed_prefixes is None
                                 else tuple(allowed_prefixes))
        self.owned = (_CONTROLLER_OWNED_ATTRS if owned is None
                      else dict(owned))

    @staticmethod
    def _attr_targets(node: ast.AST):
        """Attribute nodes assigned by this statement (tuple targets and
        augmented/annotated assignments included)."""
        targets: list[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        out = []
        stack = list(targets)
        while stack:
            t = stack.pop()
            if isinstance(t, (ast.Tuple, ast.List)):
                stack.extend(t.elts)
            elif isinstance(t, ast.Attribute):
                out.append(t)
        return out

    def check_tree(self, modules: list[ParsedModule]) -> list[Finding]:
        out: list[Finding] = []
        seen_attrs: set[str] = set()
        for module in modules:
            allowed_module = any(module.relpath.startswith(p)
                                 for p in self.allowed_prefixes)
            for node in ast.walk(module.tree):
                for target in self._attr_targets(node):
                    attr = target.attr
                    if attr not in self.owned:
                        continue
                    seen_attrs.add(attr)
                    if allowed_module:
                        continue
                    scope = module.scope_of(node)
                    if scope == "__init__" or scope.endswith(".__init__"):
                        continue  # construction seeds the static default
                    if module.is_suppressed(self.name, node):
                        continue
                    out.append(module.finding(
                        self.name, node,
                        f"runtime mutation of controller-owned knob "
                        f"`.{attr}` outside a registered actuator — owned "
                        f"by the {self.owned[attr]}; route the change "
                        f"through zeebe_tpu_torch/control (bounds, pacing, and "
                        f"the control_adjust audit trail live there)"))
        # stale-registration analogue: an owned attr that no linted module
        # even assigns any more was renamed/removed — the registration is
        # silently guarding nothing
        for attr in sorted(set(self.owned) - seen_attrs):
            out.append(self.registration_finding(
                attr,
                f"stale controller-owned-knob registration: `.{attr}` is "
                f"assigned nowhere in the linted tree — the knob was "
                f"renamed or removed; update _CONTROLLER_OWNED_ATTRS"))
        return out


# ---------------------------------------------------------------------------
# rule 6: drift-copy detection


class _Normalizer(ast.NodeTransformer):
    """Alpha-rename names/args, drop annotations/defaults/decorators, and
    collapse string constants and f-strings — so two functions that differ
    only in identifier choice and message wording hash identically."""

    def __init__(self) -> None:
        self._names: dict[str, str] = {}

    def _map(self, name: str) -> str:
        return self._names.setdefault(name, f"n{len(self._names)}")

    def visit_Name(self, node: ast.Name):
        return ast.copy_location(
            ast.Name(id=self._map(node.id), ctx=node.ctx), node)

    def visit_arg(self, node: ast.arg):
        node.arg = self._map(node.arg)
        node.annotation = None
        return node

    def visit_FunctionDef(self, node: ast.FunctionDef):
        node.name = self._map(node.name)
        node.returns = None
        node.decorator_list = []
        self.generic_visit(node)
        return node

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_JoinedStr(self, node: ast.JoinedStr):
        return ast.copy_location(ast.Constant(value=""), node)

    def visit_Constant(self, node: ast.Constant):
        if isinstance(node.value, str):
            return ast.copy_location(ast.Constant(value=""), node)
        return node


def _body_sans_docstring(fn: ast.AST) -> list[ast.stmt]:
    body = list(fn.body)
    if body and isinstance(body[0], ast.Expr) and isinstance(
            body[0].value, ast.Constant) and isinstance(
            body[0].value.value, str):
        body = body[1:]
    return body


def _body_size(fn: ast.AST) -> int:
    """Recursive statement count of the (docstring-stripped) body: a
    4-statement body wrapping a 20-statement loop is a copy worth catching,
    not idiom. Computed on the ORIGINAL node so the threshold filters
    before the expensive deepcopy/normalize/dump pass."""
    return sum(isinstance(n, ast.stmt)
               for stmt in _body_sans_docstring(fn) for n in ast.walk(stmt))


def _normalized_fingerprint(fn: ast.AST) -> str:
    """sha1 of the alpha-normalized body dump — docstring stripped so
    commenting a copy doesn't hide it."""
    fn = copy.deepcopy(fn)
    fn.body = _body_sans_docstring(fn) or [ast.Pass()]
    normalizer = _Normalizer()
    fn = normalizer.visit(fn)
    dump = ast.dump(ast.Module(body=fn.body, type_ignores=[]))
    return hashlib.sha1(dump.encode()).hexdigest()


class DriftCopyRule(Rule):
    """Silently drifted code copies: two functions whose alpha-normalized
    bodies are identical are one function written twice — the next fix will
    land in one of them found exactly this in the gate harnesses).
    Extract the shared helper instead."""

    name = "drift-copy"
    summary = ("no near-identical function bodies across the tree — "
               "extract the shared helper before the copies drift")
    cross_module = True

    #: bodies with fewer total (recursive) statements are idiom, not copies
    MIN_BODY_STATEMENTS = 8

    def __init__(self, min_body_statements: int | None = None) -> None:
        if min_body_statements is not None:
            self.MIN_BODY_STATEMENTS = min_body_statements

    def check_tree(self, modules: list[ParsedModule]) -> list[Finding]:
        groups: dict[str, list[tuple[ParsedModule, str, ast.AST]]] = {}
        for module in modules:
            for node in ast.walk(module.tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if _body_size(node) < self.MIN_BODY_STATEMENTS:
                    continue
                digest = _normalized_fingerprint(node)
                groups.setdefault(digest, []).append(
                    (module, module.scope_of(node), node))
        out: list[Finding] = []
        for twins in groups.values():
            if len(twins) < 2:
                continue
            labels = [f"{m.relpath}:{q}" for m, q, _ in twins]
            for module, qual, node in twins:
                if module.is_suppressed(self.name, node):
                    continue
                others = ", ".join(l for l in labels
                                   if l != f"{module.relpath}:{qual}")
                out.append(module.finding(
                    self.name, node,
                    f"`{qual}` is a drift-copy of {others} — identical "
                    f"normalized body; extract one shared helper"))
        return out


# ---------------------------------------------------------------------------
# rule 7: storage IO discipline


#: syscall-shaped calls that must route through the seam in storage modules
_STORAGE_IO_CALLS = (
    "os.fsync", "os.replace", "os.pwrite", "os.open", "os.rename",
)
_STORAGE_IO_BARE_CALLS = ("open",)
#: attribute-call names that write a file when invoked on a Path
_STORAGE_IO_WRITE_ATTRS = ("write_bytes", "write_text")


class StorageIoDisciplineRule(Rule):
    """Storage modules (journal, snapshot store, cold tier, backup store)
    perform file IO only through ``zeebe_tpu_torch/utils/storage_io.py`` — the
    one seam the disk-fault injector (``ZEEBE_CHAOS_DISK``) and therefore
    the whole torture gate's coverage claim hang off. A direct ``open`` /
    ``os.fsync`` / ``os.replace`` / ``write_bytes`` in a storage module is
    a write (or a durability barrier) the chaos plane cannot fault and the
    fsyncgate handling cannot protect; deliberate exceptions (read-only
    inspection helpers, advisory evidence files) are baselined with
    justifications."""

    name = "storage-io-discipline"
    summary = ("journal/snapshot/tiering/backup file IO routes through "
               "utils/storage_io (the disk-fault seam) — no direct "
               "open/os.fsync/os.replace/write_bytes")

    #: the storage modules under the seam's contract
    DEFAULT_SCOPE = (
        "zeebe_tpu_torch/journal/journal.py",
        "zeebe_tpu_torch/state/snapshot.py",
        "zeebe_tpu_torch/state/tiering.py",
        "zeebe_tpu_torch/backup/store.py",
    )
    #: the seam itself is the only place the raw calls are legal
    SEAM = "zeebe_tpu_torch/utils/storage_io.py"

    def __init__(self, scope=None) -> None:
        self.scope = self.DEFAULT_SCOPE if scope is None else tuple(scope)

    def validate(self, modules):
        out = []
        for entry in self.scope:
            if not any(m.relpath == entry for m in modules):
                out.append(self.registration_finding(
                    entry,
                    f"stale storage-module registration: `{entry}` matches "
                    f"no linted file — the module was moved/renamed and "
                    f"this rule is silently scanning nothing; update the "
                    f"registration"))
        return out

    def check(self, module: ParsedModule) -> list[Finding]:
        if module.relpath not in self.scope:
            return []
        aliases = _import_aliases(module.tree)
        out: list[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func, aliases)
            if dotted is not None and dotted.startswith(
                    "zeebe_tpu_torch.utils.storage_io."):
                continue  # a call INTO the seam is the whole point
            hit = None
            if dotted is not None:
                if _matches(dotted, _STORAGE_IO_CALLS) is not None:
                    hit = dotted
                elif dotted in _STORAGE_IO_BARE_CALLS:
                    hit = dotted
            if (hit is None and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _STORAGE_IO_WRITE_ATTRS):
                hit = f".{node.func.attr}"
            if hit is None:
                continue
            if module.is_suppressed(self.name, node):
                continue
            out.append(module.finding(
                self.name, node,
                f"direct file IO `{hit}(...)` in a storage module — route "
                f"through zeebe_tpu_torch.utils.storage_io (open_file/fsync/"
                f"pwrite/replace/write_bytes); bypassing the seam makes "
                f"this write invisible to disk-fault injection and the "
                f"at-rest scrub/torture coverage claim"))
        return out
# end of the copy


#: the device-result primitives: the collect that runs a chunk and packs
#: its rows, the one device→host fetch of those rows, and the decode that
#: turns them into steps the engine could commit
_KERNEL_RESULT_CALLS = (
    "zeebe_tpu_torch.ops.automaton.run_collect",
    "zeebe_tpu_torch.ops.automaton.unpack_events",
    "zeebe_tpu_torch.engine.kernel_backend.fetch_rows",
)


class KernelResultCommitDisciplineRule(Rule):
    """Kernel group results may only enter the group transaction through
    the device-fault seam: inside ``engine/`` and ``stream/`` the
    device-result primitives — the ``run_collect`` dispatch, the
    ``fetch_rows`` fetch of a chunk's pinned rows, the ``unpack_events``
    decode — are legal ONLY in the registered seam functions of
    ``engine/kernel_backend.py``: the module's chunk loop
    (``_dispatch``, ``fetch_rows``, ``run_group``, ``_complete_device_run``)
    and ``DeviceDefense``'s dispatch, fetch and shadow
    (``run``, ``_begin_dispatch``, ``_fetch_rows``, ``_shadow_execute``),
    whose results reach materialization only through the backend's
    ``finish_group``. A direct fetch+decode anywhere else is a path for
    silently-corrupted device output to reach the replicated log without
    the watchdog, the chaos seam, or shadow verification ever seeing it. A
    call of a module's own function counts under the module's dotted name,
    so ``fetch_rows`` called inside ``kernel_backend.py`` is seen. (The mesh
    runner lives under ``parallel/`` and is covered at its ``submit`` seam,
    as in the reference.)"""

    name = "kernel-result-commit-discipline"
    summary = ("device-result primitives (run_collect/fetch_rows/"
               "unpack_events) in engine//stream/ only inside the "
               "kernel_backend dispatch/shadow seam")

    DEFAULT_SCOPE_PREFIXES = ("zeebe_tpu_torch/engine/", "zeebe_tpu_torch/stream/")
    SEAM_MODULE = "zeebe_tpu_torch/engine/kernel_backend.py"
    DEFAULT_SEAM_SCOPES = (
        # the chunk loop: a chunk's dispatch, its fetch, the bare run (no
        # defense: the backend always passes itself) and the decode
        "_dispatch",
        "fetch_rows",
        "run_group",
        "_complete_device_run",
        # the fault seam: dispatch under chaos and containment, every fetch
        # through the watchdog, the CPU oracle's own fetch
        "DeviceDefense.run",
        "DeviceDefense._begin_dispatch",
        "DeviceDefense._fetch_rows",
        "DeviceDefense._shadow_execute",
    )

    def __init__(self, scope_prefixes=None, seam_module=None,
                 seam_scopes=None, calls=None) -> None:
        self.scope_prefixes = (self.DEFAULT_SCOPE_PREFIXES
                               if scope_prefixes is None
                               else tuple(scope_prefixes))
        self.seam_module = (self.SEAM_MODULE if seam_module is None
                            else seam_module)
        self.seam_scopes = (self.DEFAULT_SEAM_SCOPES if seam_scopes is None
                            else tuple(seam_scopes))
        self.calls = _KERNEL_RESULT_CALLS if calls is None else tuple(calls)

    def validate(self, modules):
        return _validate_scoped_entries(
            self, [(self.seam_module, prefix) for prefix in self.seam_scopes],
            modules, "kernel-result seam")

    def _in_seam(self, module: ParsedModule, node: ast.AST) -> bool:
        if module.relpath != self.seam_module:
            return False
        scope = module.scope_of(node)
        return any(scope == s or scope.startswith(s + ".")
                   for s in self.seam_scopes)

    @staticmethod
    def _names(module: ParsedModule) -> dict[str, str]:
        """The module's import aliases, and its own top-level functions
        under the module's dotted name."""
        own = module.relpath[:-3].replace("/", ".").removesuffix(".__init__")
        names = {node.name: f"{own}.{node.name}" for node in module.tree.body
                 if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))}
        return {**names, **_import_aliases(module.tree)}

    def check(self, module: ParsedModule) -> list[Finding]:
        if not module.relpath.startswith(self.scope_prefixes):
            return []
        aliases = self._names(module)
        out: list[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func, aliases)
            if dotted is None or _matches(dotted, self.calls) is None:
                continue
            if self._in_seam(module, node):
                continue
            if module.is_suppressed(self.name, node):
                continue
            out.append(module.finding(
                self.name, node,
                f"device-result primitive `{dotted}(...)` outside the "
                f"kernel dispatch/shadow seam — device output may only "
                f"enter the group transaction through the fault seam's "
                f"validation gate ({self.seam_module}); a direct "
                f"fetch/decode here bypasses the watchdog, the chaos seam, "
                f"and shadow verification"))
        return out


# copied from the reference: RULES .. RULES
RULES: list[Rule] = [
    ReplayDeterminismRule(),
    DeviceCallDisciplineRule(),
    PumpBlockingIoRule(),
    CommittedReadDisciplineRule(),
    ControlActuationDisciplineRule(),
    DriftCopyRule(),
    StorageIoDisciplineRule(),
    KernelResultCommitDisciplineRule(),
]
# end of the copy
