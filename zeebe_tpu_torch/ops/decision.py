"""Batched DMN decision-table evaluation on the card.

The counterpart of ``zeebe_tpu/ops/decision.py``. A decision table compiles
once to dense int32 atom arrays over the f64 order-key planes the condition
VM uses (``ops.tables.f64_key_planes``); one launch then matches N contexts
against R rules: unary tests, any over a cell's atoms, all over a rule's
inputs, the count and the first match per context. Hit-policy selection and
COLLECT aggregation (float64) run on the host over the match matrix.

The host compiler (``NotDeviceCompilable`` through ``_parse_cell_atoms``,
with the ``A_*``/``F_*`` constants) is copied from the reference; a test
holds the text. ``_evaluate_batch`` is the plain PyTorch version of the
reference's jitted program (any device); ``evaluate_batch`` routes a CPU
tensor to it and a CUDA tensor to the hand-written kernel
(``csrc/decision.cu`` through ``ops.kernels.run_decision``).

Device subset (everything else raises NotDeviceCompilable and stays on the
host evaluator, ``zeebe_tpu_torch.dmn``): bare-variable numeric/string
inputs; "-", numeric comparisons against literals, intervals with any
open/closed ends, numeric/string equality and top-level disjunctions of
those; hit policies UNIQUE, FIRST, ANY, RULE ORDER/COLLECT, and COLLECT
SUM/MIN/MAX/COUNT over numeric output literals.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from zeebe_tpu_torch.feel.feel import FeelError, Lit, Unary, parse_feel
from zeebe_tpu_torch.ops import kernels
from zeebe_tpu_torch.ops.automaton import resolve_device
from zeebe_tpu_torch.ops.tables import f64_key_planes, pack_slot_values

# atom kinds
A_PAD = 0  # never matches (padding)
A_TRUE = 1  # "-" / empty: matches anything, null included
A_RANGE = 2  # lo <= value <= hi over numeric order keys (open/closed ends)
A_EQ = 3  # exact key equality (numeric or interned string)

# flags bits
F_LO_OPEN = 1
F_HI_OPEN = 2

_INT32_MIN = -(2**31)
_INT32_MAX = 2**31 - 1


class NotDeviceCompilable(Exception):
    """Table uses features outside the device subset — host evaluator owns it."""


@dataclasses.dataclass
class DeviceDecisionTable:
    """One compiled decision table: [I inputs, R rules, K atoms per cell]."""

    decision_id: str
    hit_policy: str
    aggregation: str  # "" | "SUM" | "MIN" | "MAX" | "COUNT"
    input_names: list[str]  # bare variable per input column
    input_kinds: list[str]  # "num" | "str" per column
    # atom arrays [I, R, K]
    kind: np.ndarray  # int32 A_*
    lo: np.ndarray  # [I, R, K, 2] int32 key planes
    hi: np.ndarray  # [I, R, K, 2]
    flags: np.ndarray  # int32
    # per-rule numeric FIRST-output literal key value (COLLECT aggregation);
    # NaN-free float64 — only present when aggregation != ""
    out_values: np.ndarray  # [R] float64
    # string interning for input values: literal → id in SORTED order
    str_ids: dict[str, int]
    num_rules: int

    def pack_contexts(self, contexts: list[dict]) -> tuple[np.ndarray, np.ndarray]:
        """Contexts → ([N, I, 2] key planes, [N, I] validity). A null/missing
        input or a type the column cannot key (document, unknown string in
        an EQ-only column is FINE — it gets an odd rank key) matches only
        A_TRUE atoms; validity=0 marks those."""
        import bisect

        N, I = len(contexts), len(self.input_names)
        vals = np.zeros((N, I), np.float64)
        valid = np.zeros((N, I), np.bool_)
        keys = np.zeros((N, I, 2), np.int32)
        sorted_lits = sorted(self.str_ids)
        for n, ctx in enumerate(contexts):
            for i, name in enumerate(self.input_names):
                v = ctx.get(name)
                if self.input_kinds[i] == "num":
                    if isinstance(v, bool):
                        # Python bool IS an int to the host evaluator
                        # (True == 1, True > 0) — key it as 1.0/0.0
                        vals[n, i] = 1.0 if v else 0.0
                        valid[n, i] = True
                        continue
                    if not isinstance(v, (int, float)):
                        continue
                    if isinstance(v, float) and v != v:
                        continue
                    vals[n, i] = float(v)
                    valid[n, i] = True
                else:
                    if not isinstance(v, str):
                        continue
                    idx = self.str_ids.get(v)
                    if idx is None:
                        # odd insertion-rank key: exact against every literal
                        keys[n, i, 0] = 2 * bisect.bisect_left(sorted_lits, v) - 1
                    else:
                        keys[n, i, 0] = 2 * idx
                    valid[n, i] = True
        num_mask = np.array([k == "num" for k in self.input_kinds], np.bool_)
        if num_mask.any():
            packed = pack_slot_values(vals)
            keys[:, num_mask] = packed[:, num_mask]
        return keys, valid


def _literal_of(expr) -> float | str | bool | None:
    """The python literal of a compiled FEEL endpoint, or raise."""
    ast = expr.ast
    if isinstance(ast, Lit):
        return ast.value
    if isinstance(ast, Unary) and isinstance(ast.operand, Lit) \
            and isinstance(ast.operand.value, (int, float)) \
            and not isinstance(ast.operand.value, bool):
        return -ast.operand.value
    raise NotDeviceCompilable("non-literal unary-test endpoint")


def _num_key(v) -> tuple[int, int]:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise NotDeviceCompilable(f"non-numeric endpoint {v!r}")
    return f64_key_planes(float(v))


def compile_decision_table(decision, max_atoms: int = 4) -> DeviceDecisionTable:
    """Lower a ParsedDecision's table to device atom arrays. Raises
    NotDeviceCompilable outside the subset (callers keep the host path)."""
    from zeebe_tpu_torch.dmn.dmn import _split_top_level

    if decision.kind != "decisionTable":
        raise NotDeviceCompilable("not a decision table")
    inputs = decision.inputs
    rules = decision.rules
    if not inputs or not rules:
        raise NotDeviceCompilable("empty table")
    hit = (decision.hit_policy or "UNIQUE").upper().replace("_", " ")
    agg = (decision.aggregation or "").upper()
    if hit not in ("UNIQUE", "FIRST", "ANY", "RULE ORDER", "COLLECT"):
        raise NotDeviceCompilable(f"hit policy {hit}")
    if agg and hit != "COLLECT":
        # the host applies aggregation only under COLLECT; compiling it here
        # would aggregate where the host selects
        raise NotDeviceCompilable(f"aggregation {agg} under {hit}")
    if agg and agg not in ("SUM", "MIN", "MAX", "COUNT"):
        raise NotDeviceCompilable(f"aggregation {agg}")
    if agg and len(decision.outputs) > 1:
        # the host raises a DmnEvalError for aggregated multi-output tables
        # (a modeling error must surface, not a partial aggregate)
        raise NotDeviceCompilable("aggregation over multiple outputs")

    input_names: list[str] = []
    for inp in inputs:
        src = (inp.expression_text or "").strip()
        if not src.isidentifier():
            raise NotDeviceCompilable(f"input expression {src!r}")
        input_names.append(src)

    # pre-pass: every string literal across all cells, interned sorted.
    # ANY parse failure (cells the host supports but this lexer cannot, e.g.
    # '?'-expressions) must surface as NotDeviceCompilable — the documented
    # keep-the-host-path contract
    strings: set[str] = set()
    parsed_cells: list[list[list]] = []  # [rule][input] -> list of atom specs
    for rule in rules:
        row: list[list] = []
        for text in rule.input_entries:
            try:
                row.append(_parse_cell_atoms(text, strings, _split_top_level))
            except FeelError as exc:
                raise NotDeviceCompilable(f"cell {text!r}: {exc}") from exc
        parsed_cells.append(row)
    str_ids = {s: i for i, s in enumerate(sorted(strings))}

    # column typing: a column is "str" when any atom uses a string literal;
    # mixing string and numeric atoms in one column leaves the subset
    kinds: list[str] = []
    I, R = len(inputs), len(rules)
    for i in range(I):
        col_kinds = set()
        for r in range(R):
            for spec in parsed_cells[r][i]:
                if spec[0] in ("eq_str",):
                    col_kinds.add("str")
                elif spec[0] in ("range", "eq_num"):
                    col_kinds.add("num")
        if len(col_kinds) > 1:
            raise NotDeviceCompilable("mixed string/number column")
        kinds.append(col_kinds.pop() if col_kinds else "num")

    K = max_atoms
    kind = np.zeros((I, R, K), np.int32)
    lo = np.zeros((I, R, K, 2), np.int32)
    hi = np.zeros((I, R, K, 2), np.int32)
    flags = np.zeros((I, R, K), np.int32)
    for r in range(R):
        for i in range(I):
            specs = parsed_cells[r][i]
            if len(specs) > K:
                raise NotDeviceCompilable(f"cell with {len(specs)} terms")
            for k, spec in enumerate(specs):
                if spec[0] == "true":
                    kind[i, r, k] = A_TRUE
                elif spec[0] == "eq_str":
                    kind[i, r, k] = A_EQ
                    lo[i, r, k, 0] = 2 * str_ids[spec[1]]
                elif spec[0] == "eq_num":
                    kind[i, r, k] = A_EQ
                    lo[i, r, k] = _num_key(spec[1])
                else:  # range
                    _tag, lo_v, hi_v, lo_open, hi_open = spec
                    kind[i, r, k] = A_RANGE
                    lo[i, r, k] = (_num_key(lo_v) if lo_v is not None
                                   else (_INT32_MIN, _INT32_MIN))
                    hi[i, r, k] = (_num_key(hi_v) if hi_v is not None
                                   else (_INT32_MAX, _INT32_MAX))
                    flags[i, r, k] = ((F_LO_OPEN if lo_open else 0)
                                      | (F_HI_OPEN if hi_open else 0))

    out_values = np.zeros(R, np.float64)
    if agg:
        for r, rule in enumerate(rules):
            try:
                v = _literal_of(parse_feel(rule.output_entries[0]))
            except NotDeviceCompilable:
                raise
            except Exception as exc:  # noqa: BLE001 — parse errors included
                raise NotDeviceCompilable(f"aggregated output: {exc}") from exc
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise NotDeviceCompilable("non-numeric aggregated output")
            out_values[r] = float(v)

    return DeviceDecisionTable(
        decision_id=decision.decision_id,
        hit_policy=hit,
        aggregation=agg,
        input_names=input_names,
        input_kinds=kinds,
        kind=kind, lo=lo, hi=hi, flags=flags,
        out_values=out_values,
        str_ids=str_ids,
        num_rules=R,
    )


def _parse_cell_atoms(text: str, strings: set[str], split_top_level) -> list:
    """One unary-test cell → atom specs. Raises NotDeviceCompilable."""
    text = (text or "").strip()
    if text in ("", "-"):
        return [("true",)]
    atoms: list = []
    for part in split_top_level(text):
        part = part.strip()
        if part in ("", "-"):
            atoms.append(("true",))
            continue
        if part.startswith("not("):
            raise NotDeviceCompilable("not(...) cell")
        if part[0] in "[(]" and ".." in part and part[-1] in "])[":
            lo_text, hi_text = part[1:-1].split("..", 1)
            lo_v = _literal_of(parse_feel(lo_text.strip()))
            hi_v = _literal_of(parse_feel(hi_text.strip()))
            atoms.append(("range", lo_v, hi_v,
                          part[0] != "[", part[-1] != "]"))
            continue
        matched = False
        for op in ("<=", ">=", "<", ">"):
            if part.startswith(op):
                v = _literal_of(parse_feel(part[len(op):].strip()))
                if op == "<":
                    atoms.append(("range", None, v, False, True))
                elif op == "<=":
                    atoms.append(("range", None, v, False, False))
                elif op == ">":
                    atoms.append(("range", v, None, True, False))
                else:
                    atoms.append(("range", v, None, False, False))
                matched = True
                break
        if matched:
            continue
        v = _literal_of(parse_feel(part))
        if isinstance(v, str):
            strings.add(v)
            atoms.append(("eq_str", v))
        elif isinstance(v, bool):
            atoms.append(("eq_num", 1.0 if v else 0.0))
        elif isinstance(v, (int, float)):
            atoms.append(("eq_num", float(v)))
        else:
            raise NotDeviceCompilable(f"cell literal {v!r}")
    return atoms


# ---------------------------------------------------------------------------
# the device evaluator


def _key_le(a_hi, a_lo, b_hi, b_lo):
    """Lexicographic (hi, lo) <= over sign-biased int32 planes."""
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo <= b_lo))


def _key_lt(a_hi, a_lo, b_hi, b_lo):
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo < b_lo))


def _match_matrix(kind, lo, hi, flags, keys, valid):
    """[N, R] rule-match matrix from [I, R, K] atoms and [N, I, 2] keys."""
    # broadcast to [N, I, R, K]
    v_hi = keys[:, :, None, None, 0]
    v_lo = keys[:, :, None, None, 1]
    k = kind[None, :, :, :]
    atom_true = k == A_TRUE
    ge_lo = _key_le(lo[None, ..., 0], lo[None, ..., 1], v_hi, v_lo)
    gt_lo = _key_lt(lo[None, ..., 0], lo[None, ..., 1], v_hi, v_lo)
    le_hi = _key_le(v_hi, v_lo, hi[None, ..., 0], hi[None, ..., 1])
    lt_hi = _key_lt(v_hi, v_lo, hi[None, ..., 0], hi[None, ..., 1])
    lo_ok = torch.where((flags[None] & F_LO_OPEN) > 0, gt_lo, ge_lo)
    hi_ok = torch.where((flags[None] & F_HI_OPEN) > 0, lt_hi, le_hi)
    in_range = (k == A_RANGE) & lo_ok & hi_ok
    eq = (k == A_EQ) & (v_hi == lo[None, ..., 0]) & (v_lo == lo[None, ..., 1])
    atom = atom_true | ((in_range | eq) & valid[:, :, None, None])
    cell = atom.any(dim=3)  # [N, I, R] disjunction over atoms
    return cell.all(dim=1)  # [N, R] conjunction over inputs


def _evaluate_batch(kind, lo, hi, flags, keys, valid):
    """The plain version: (m [N, R] bool, selected [N] int32, counts [N]
    int32), the dtypes of the reference's program. A bool sum is int64 in
    PyTorch and argmax rejects bool, so both are cast; argmax returns the
    first maximal index."""
    m = _match_matrix(kind, lo, hi, flags, keys, valid)
    counts = m.sum(dim=1, dtype=torch.int32)
    first = m.to(torch.int32).argmax(dim=1).to(torch.int32)
    selected = torch.where(counts > 0, first, -1)
    return m, selected, counts


def evaluate_batch(kind, lo, hi, flags, keys, valid):
    """``_evaluate_batch`` on the device of ``keys``: the plain version for a
    CPU tensor, the CUDA kernel for a CUDA tensor (which launches or
    raises)."""
    if keys.device.type == "cpu":
        return _evaluate_batch(kind, lo, hi, flags, keys, valid)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    return kernels.run_decision(kind, lo, hi, flags, keys, valid)


def batch_evaluate(table: DeviceDecisionTable, contexts: list[dict], device=None):
    """Evaluate N contexts on ``device`` (None: CUDA; raises without it unless
    ``device="cpu"``, the plain version). Returns a list of per-context
    results:

    - FIRST/UNIQUE: the matched rule index (int) or None (UNIQUE with != 1
      matches is a failure → None, like the host's hit-policy error path)
    - ANY: the first matched rule index or None; output-equality validation
      across the matches stays with the caller
    - RULE ORDER / COLLECT without aggregation: list of matched rule indices
    - COLLECT SUM/MIN/MAX/COUNT: the aggregate number (None when no match,
      except COUNT → 0)
    """
    dev = resolve_device(device)
    keys, valid = table.pack_contexts(contexts)
    m, selected, counts = evaluate_batch(*(
        torch.from_numpy(a).to(dev)
        for a in (table.kind, table.lo, table.hi, table.flags, keys, valid)))
    return decide(table, m.cpu().numpy(), selected.cpu().numpy(), counts.cpu().numpy())


def decide(table: DeviceDecisionTable, m: np.ndarray, selected: np.ndarray,
           counts: np.ndarray) -> list:
    """The hit policy and the aggregation over the host copies of
    ``evaluate_batch``'s outputs: ``batch_evaluate``'s result list."""
    # aggregation runs host-side in float64 over the match matrix — the
    # reference aggregates exact decimals, and a float32 device reduction
    # would drift (0.1 -> 0.10000000149...)
    agg = None
    if table.aggregation == "SUM":
        agg = m.astype(np.float64) @ table.out_values
    elif table.aggregation == "MIN":
        agg = np.where(m, table.out_values[None, :], np.inf).min(axis=1)
    elif table.aggregation == "MAX":
        agg = np.where(m, table.out_values[None, :], -np.inf).max(axis=1)

    out = []
    for n in range(m.shape[0]):
        if table.aggregation:
            if table.aggregation == "COUNT":
                out.append(int(counts[n]))
            elif counts[n] == 0:
                out.append(None)
            else:
                v = float(agg[n])
                out.append(int(v) if v.is_integer() else v)
        elif table.hit_policy in ("RULE ORDER", "COLLECT"):
            out.append([int(i) for i in np.flatnonzero(m[n])])
        elif table.hit_policy == "UNIQUE":
            out.append(int(selected[n]) if counts[n] == 1 else None)
        elif table.hit_policy == "ANY":
            out.append(int(selected[n]) if counts[n] > 0 else None)
        else:  # FIRST
            out.append(int(selected[n]) if counts[n] > 0 else None)
    return out
