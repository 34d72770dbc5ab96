"""The port's DMN batch evaluation against the JAX package's.

The host compiler and the DMN evaluator are copies (their text is held to
the reference's, modulo the package name); the compiled atom arrays and the
packed contexts must be equal field by field; the plain PyTorch
``_evaluate_batch`` must be byte-equal to the reference's jitted program
(tolerance 0, dtypes included) on random atom arrays with INT32 extremes,
hi-plane ties broken by lo, every flag, PAD atoms, invalid inputs, N = 0 and
R = 1; and ``batch_evaluate`` must return the reference's lists under every
hit policy and aggregation. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import dataclasses
import math
import random
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_dmn import COLLECT_DMN, DISH_DMN
from test_torch_tables import as_copied
from zeebe_tpu.dmn import DecisionEngine as RefEngine
from zeebe_tpu.dmn import parse_dmn_xml as ref_parse_dmn
from zeebe_tpu.ops import decision as RD
from zeebe_tpu_torch.dmn import DecisionEngine, parse_dmn_xml
from zeebe_tpu_torch.ops import decision as PD
from zeebe_tpu_torch.ops import kernels
from zeebe_tpu_torch.testing import workloads as W

REPO = Path(__file__).resolve().parents[1]
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


@pytest.mark.parametrize("path", ["dmn/__init__.py", "dmn/dmn.py"])
def test_dmn_is_a_copy(path):
    ref = (REPO / "zeebe_tpu" / path).read_text()
    assert (REPO / "zeebe_tpu_torch" / path).read_text() == as_copied(ref)


def _host_compiler(text: str) -> str:
    start = text.index("# atom kinds")
    return text[start:text.index("# the device evaluator", start)]


def test_host_compiler_is_a_copy():
    ref = (REPO / "zeebe_tpu" / "ops" / "decision.py").read_text()
    port = (REPO / "zeebe_tpu_torch" / "ops" / "decision.py").read_text()
    assert _host_compiler(port) == as_copied(_host_compiler(ref))


# ---------------------------------------------------------------------------
# tables: compile on both sides


INTERVALS_DMN = """<?xml version="1.0" encoding="UTF-8"?>
<definitions xmlns="https://www.omg.org/spec/DMN/20191111/MODEL/"
             id="iv" name="iv" namespace="test">
  <decision id="iv" name="iv">
    <decisionTable hitPolicy="FIRST">
      <input id="i1"><inputExpression><text>x</text></inputExpression></input>
      <input id="i2"><inputExpression><text>flag</text></inputExpression></input>
      <output id="o1" name="band"/>
      <rule id="r1"><inputEntry><text>[0..10]</text></inputEntry>
        <inputEntry><text>true</text></inputEntry>
        <outputEntry><text>"low"</text></outputEntry></rule>
      <rule id="r2"><inputEntry><text>(10..20)</text></inputEntry>
        <inputEntry><text>-</text></inputEntry>
        <outputEntry><text>"mid"</text></outputEntry></rule>
      <rule id="r3"><inputEntry><text>20, 30, &gt;= 100</text></inputEntry>
        <inputEntry><text>false, true</text></inputEntry>
        <outputEntry><text>"special"</text></outputEntry></rule>
      <rule id="r4"><inputEntry><text>]-5..-1[, &lt; -100</text></inputEntry>
        <inputEntry><text></text></inputEntry>
        <outputEntry><text>"neg"</text></outputEntry></rule>
    </decisionTable>
  </decision>
</definitions>"""


def _random_table_xml(seed: int, hit: str = "FIRST") -> str:
    """The reference suite's randomized table generator (two numeric inputs,
    2–6 rules of comparisons, intervals, literals and "-")."""
    rng = random.Random(seed)
    rules = []
    for r in range(rng.randint(2, 6)):
        cells = []
        for _ in range(2):
            roll = rng.random()
            if roll < 0.2:
                cells.append("-")
            elif roll < 0.45:
                op = rng.choice(("&lt;", "&lt;=", "&gt;", "&gt;="))
                cells.append(f"{op} {rng.randint(-5, 15)}")
            elif roll < 0.7:
                a, b = sorted((rng.randint(-5, 10), rng.randint(-5, 15)))
                cells.append(f"{rng.choice('[(')}{a}..{b}{rng.choice('])')}")
            else:
                cells.append(str(rng.randint(-5, 15)))
        rules.append(f'<rule id="r{r}">'
                     + "".join(f"<inputEntry><text>{c}</text></inputEntry>" for c in cells)
                     + f"<outputEntry><text>{r}</text></outputEntry></rule>")
    return f"""<?xml version="1.0" encoding="UTF-8"?>
<definitions xmlns="https://www.omg.org/spec/DMN/20191111/MODEL/"
             id="rt" name="rt" namespace="test">
  <decision id="rt" name="rt">
    <decisionTable hitPolicy="{hit}">
      <input id="i1"><inputExpression><text>a</text></inputExpression></input>
      <input id="i2"><inputExpression><text>b</text></inputExpression></input>
      <output id="o1" name="o"/>
      {"".join(rules)}
    </decisionTable>
  </decision>
</definitions>"""


TABLES = [(DISH_DMN, "dish"), (COLLECT_DMN, "fees"), (INTERVALS_DMN, "iv"),
          (W.dmn_band_xml(), "band")] + [(_random_table_xml(s), "rt") for s in range(6)]
FIELDS = ("kind", "lo", "hi", "flags", "out_values")


def _both(xml: str, decision_id: str, **kw):
    return (RD.compile_decision_table(ref_parse_dmn(xml).decisions[decision_id], **kw),
            PD.compile_decision_table(parse_dmn_xml(xml).decisions[decision_id], **kw))


@pytest.mark.parametrize("xml,decision_id", TABLES)
def test_compiled_tables_equal(xml, decision_id):
    for max_atoms in (4, 7):
        ref, port = _both(xml, decision_id, max_atoms=max_atoms)
        for name in FIELDS:
            a, b = getattr(ref, name), getattr(port, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert np.array_equal(a, b), name
        for name in ("decision_id", "hit_policy", "aggregation", "input_names",
                     "input_kinds", "str_ids", "num_rules"):
            assert getattr(ref, name) == getattr(port, name), name


def _declining():
    collect_first = COLLECT_DMN.replace('hitPolicy="COLLECT" aggregation="SUM"',
                                        'hitPolicy="FIRST" aggregation="SUM"')
    return [
        (DISH_DMN.replace("<text>season</text>", "<text>season + x</text>"), "dish"),
        (DISH_DMN.replace("<text>\"Winter\"</text>", "<text>not(\"Winter\")</text>", 1), "dish"),
        (DISH_DMN.replace("<text>&lt;= 8</text>", "<text>&lt;= limit</text>", 1), "dish"),
        (collect_first, "fees"),
        (COLLECT_DMN.replace("<text>-</text>", "<text>? * 2 &gt; 1</text>"), "fees"),
        (COLLECT_DMN.replace('aggregation="SUM"', 'aggregation="AVG"'), "fees"),
        (INTERVALS_DMN.replace("20, 30, &gt;= 100", "1, 2, 3, 4, 5"), "iv"),
        (INTERVALS_DMN.replace("<text>true</text>", "<text>\"on\"</text>", 1), "iv"),
    ]


@pytest.mark.parametrize("case", range(len(_declining())))
def test_same_tables_decline(case):
    xml, decision_id = _declining()[case]
    with pytest.raises(RD.NotDeviceCompilable):
        RD.compile_decision_table(ref_parse_dmn(xml).decisions[decision_id])
    with pytest.raises(PD.NotDeviceCompilable):
        PD.compile_decision_table(parse_dmn_xml(xml).decisions[decision_id])


def _contexts(xml: str, decision_id: str, n: int, seed: int) -> list[dict]:
    """Contexts over the table's inputs: in-range and boundary numbers,
    ulp neighbours, bools, known and unknown strings, NaN, None, missing."""
    rng = random.Random(seed)
    dec = parse_dmn_xml(xml).decisions[decision_id]
    names = [inp.expression_text.strip() for inp in dec.inputs]
    pool = [0, 1, 8, 8.5, math.nextafter(8.5, 9), 9, 10, 10.0000001, 20, 30, 45.5, 100,
            -1, -3, -100.5, True, False, "Winter", "Summer", "gold", "silver", "zzz", "",
            float("nan"), None, 2**40, -0.0]
    out = []
    for _ in range(n):
        ctx = {}
        for name in names:
            roll = rng.random()
            if roll < 0.1:
                continue  # missing
            ctx[name] = (rng.choice(pool) if roll < 0.6
                         else rng.uniform(-10, 100) if roll < 0.85 else rng.randint(-6, 90))
        out.append(ctx)
    return out


@pytest.mark.parametrize("xml,decision_id", TABLES)
def test_pack_contexts_equal(xml, decision_id):
    ref, port = _both(xml, decision_id)
    contexts = _contexts(xml, decision_id, 200, seed=11)
    for a, b in zip(ref.pack_contexts(contexts), port.pack_contexts(contexts)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the plain evaluator against the reference's jitted program


_PLANE_POOL = np.array([INT32_MIN, INT32_MIN + 1, -2, -1, 0, 1, 2, INT32_MAX - 1, INT32_MAX],
                       np.int32)


def random_atoms(rng: np.random.Generator, N: int, I: int, R: int, K: int):
    """Atom arrays and contexts whose planes come from one small pool with
    the int32 extremes, so hi planes tie often and lo breaks the tie; every
    kind (PAD included) and every flag combination; ~20% invalid inputs."""
    kind = rng.integers(0, 4, (I, R, K)).astype(np.int32)
    flags = rng.integers(0, 4, (I, R, K)).astype(np.int32)
    lo = rng.choice(_PLANE_POOL, (I, R, K, 2))
    hi = rng.choice(_PLANE_POOL, (I, R, K, 2))
    keys = rng.choice(_PLANE_POOL, (N, I, 2))
    valid = rng.random((N, I)) < 0.8
    return kind, lo, hi, flags, keys, valid


def evaluate_both(arrays):
    ref = RD._evaluate_batch(*(jnp.asarray(a) for a in arrays))
    port = PD._evaluate_batch(*(torch.from_numpy(np.array(a)) for a in arrays))
    return [np.asarray(a) for a in ref], [t.numpy() for t in port]


# the first six, then the edges of the lanes layout (csrc/decision.cu): a
# ragged, a whole and a one-rule-over word (R = 31, 32, 33), two words, a lane
# that loops over words (R = 1025: 33 words on 32 lanes), the most atoms a
# cell takes (K = 64), one context, and context counts that are not a
# multiple of the contexts per warp (R = 300: 16 lanes, 2 contexts a warp)
SHAPES = [(64, 2, 8, 4), (97, 3, 40, 2), (0, 2, 5, 3), (33, 1, 1, 1), (48, 4, 70, 4),
          (20, 2, 33, 1), (45, 2, 31, 3), (45, 2, 32, 4), (45, 3, 33, 2), (45, 2, 64, 3),
          (9, 2, 1025, 2), (13, 2, 20, 64), (1, 3, 40, 4), (37, 2, 300, 3),
          # the lanes layout's plans: a whole tile and one context past it
          # (512, 256, 128, 32 and 16 contexts a block), ragged last words,
          # tables staged or read from device memory, many or no inputs
          (513, 2, 8, 4), (257, 2, 33, 2), (129, 3, 100, 2), (33, 2, 512, 4),
          (17, 4, 1024, 2), (70, 4, 512, 4), (5, 4, 2048, 4), (7, 2, 1025, 64),
          (21, 64, 8, 4), (11, 0, 9, 2), (19, 2, 65, 2), (23, 2, 513, 2),
          (2, 2, 96, 3), (40, 2, 257, 3), (60, 5, 160, 5), (1, 1, 2048, 1)]


@pytest.mark.parametrize("N,I,R,K", SHAPES)
def test_plain_evaluate_batch_byte_equal(N, I, R, K):
    rng = np.random.default_rng(N * 1000 + R)
    ref, port = evaluate_both(random_atoms(rng, N, I, R, K))
    for name, a, b in zip(("m", "selected", "counts"), ref, port):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def test_plain_evaluate_batch_tie_broken_by_lo():
    """Equal hi planes: the lo plane decides every comparison."""
    kind = np.full((1, 4, 1), PD.A_RANGE, np.int32)
    flags = np.array([0, PD.F_LO_OPEN, PD.F_HI_OPEN, PD.F_LO_OPEN | PD.F_HI_OPEN],
                     np.int32).reshape(1, 4, 1)
    lo = np.tile(np.array([7, -1], np.int32), (1, 4, 1, 1))
    hi = np.tile(np.array([7, 1], np.int32), (1, 4, 1, 1))
    keys = np.array([[[7, v]] for v in (-2, -1, 0, 1, 2)], np.int32)
    valid = np.ones((5, 1), np.bool_)
    ref, port = evaluate_both((kind, lo, hi, flags, keys, valid))
    assert ref[0].tolist() == [[False] * 4, [True, False, True, False], [True] * 4,
                               [True, True, False, False], [False] * 4]
    for a, b in zip(ref, port):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_first_match_is_the_lowest_rule():
    """argmax over a row with several matches returns the first one."""
    kind = np.full((1, 6, 1), PD.A_TRUE, np.int32)
    kind[0, :2, 0] = PD.A_PAD
    zeros = np.zeros((1, 6, 1, 2), np.int32)
    arrays = (kind, zeros, zeros, np.zeros((1, 6, 1), np.int32),
              np.zeros((3, 1, 2), np.int32), np.zeros((3, 1), np.bool_))
    ref, port = evaluate_both(arrays)
    assert port[1].tolist() == [2, 2, 2] and port[2].tolist() == [4, 4, 4]
    assert all(a.tobytes() == b.tobytes() for a, b in zip(ref, port))


def test_evaluate_batch_routes_cpu_to_plain():
    arrays = [torch.from_numpy(np.array(a))
              for a in random_atoms(np.random.default_rng(3), 16, 2, 9, 3)]
    kernels.LAUNCHES["decision"] = 0
    got = PD.evaluate_batch(*arrays)
    want = PD._evaluate_batch(*arrays)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.LAUNCHES["decision"] == 0


def test_run_decision_refuses_bad_inputs():
    """The kernel's wrapper checks dtypes, shapes and the atom limit before
    it builds or launches anything."""
    kind, lo, hi, flags, keys, valid = (
        torch.from_numpy(np.array(a))
        for a in random_atoms(np.random.default_rng(4), 8, 2, 4, 2))
    with pytest.raises(ValueError, match="int32"):
        kernels.run_decision(kind.long(), lo, hi, flags, keys, valid)
    with pytest.raises(ValueError, match="shape"):
        kernels.run_decision(kind, lo, hi, flags, keys[:, :1], valid)
    with pytest.raises(ValueError, match="bool"):
        kernels.run_decision(kind, lo, hi, flags, keys, valid.int())
    wide = kernels.DECISION_MAX_ATOMS + 1
    with pytest.raises(ValueError, match="atoms"):
        kernels.run_decision(*(torch.zeros((2, 4, wide) + tail, dtype=torch.int32)
                               for tail in ((), (2,), (2,), ())), keys, valid)


def test_run_decision_refuses_an_unknown_kernel():
    arrays = [torch.from_numpy(np.array(a))
              for a in random_atoms(np.random.default_rng(6), 8, 2, 4, 2)]
    assert kernels.DECISION_KERNELS == ("lanes", "serial")
    with pytest.raises(ValueError, match="kernel"):
        kernels.run_decision(*arrays, kernel="warps")


# ---------------------------------------------------------------------------
# batch_evaluate: the reference's lists under every hit policy


POLICIES = [("FIRST", ""), ("UNIQUE", ""), ("ANY", ""), ("RULE ORDER", ""),
            ("COLLECT", ""), ("COLLECT", "SUM"), ("COLLECT", "MIN"), ("COLLECT", "MAX"),
            ("COLLECT", "COUNT")]


@pytest.mark.parametrize("hit,agg", POLICIES)
def test_batch_evaluate_lists_equal(hit, agg):
    for xml, decision_id in ((W.dmn_band_xml(hit, agg), "band"),
                             (_random_table_xml(3, hit), "rt"),
                             (_random_table_xml(5, hit), "rt")):
        if agg and decision_id == "rt":
            xml = xml.replace(f'hitPolicy="{hit}"', f'hitPolicy="{hit}" aggregation="{agg}"')
        ref, port = _both(xml, decision_id)
        contexts = (_contexts(xml, decision_id, 150, seed=5)
                    + (W.dmn_band_contexts(150) if decision_id == "band" else []))
        assert PD.batch_evaluate(port, contexts, device="cpu") == \
            RD.batch_evaluate(ref, contexts)


def test_batch_evaluate_float64_aggregation():
    """MIN over 0.1 stays 0.1 (float64), SUM of integral outputs is an int."""
    xml = COLLECT_DMN.replace('aggregation="SUM"', 'aggregation="MIN"').replace(
        "<text>10</text>", "<text>0.1</text>")
    ref, port = _both(xml, "fees")
    contexts = [{"membership": "silver"}, {"membership": "gold"}, {}]
    assert PD.batch_evaluate(port, contexts, device="cpu") == \
        RD.batch_evaluate(ref, contexts) == [0.1, 0.1, 0.1]
    ref, port = _both(COLLECT_DMN, "fees")
    got = PD.batch_evaluate(port, contexts, device="cpu")
    assert got == RD.batch_evaluate(ref, contexts)
    assert all(type(v) is int for v in got)


def test_batch_evaluate_agrees_with_host_engine():
    """The port's host DecisionEngine (the copy) gives the reference's
    outputs, and the device subset's matches equal its unary tests."""
    drg_ref, drg = ref_parse_dmn(COLLECT_DMN), parse_dmn_xml(COLLECT_DMN)
    contexts = [{"membership": "gold"}, {"membership": "silver"}, {}]
    got = PD.batch_evaluate(PD.compile_decision_table(drg.decisions["fees"]), contexts,
                            device="cpu")
    for ctx, agg in zip(contexts, got):
        assert DecisionEngine().evaluate(drg, "fees", ctx).output == agg == \
            RefEngine().evaluate(drg_ref, "fees", ctx).output
    dec = parse_dmn_xml(W.dmn_band_xml("RULE ORDER")).decisions["band"]
    contexts = W.dmn_band_contexts(300)
    got = PD.batch_evaluate(PD.compile_decision_table(dec), contexts, device="cpu")
    for ctx, matched in zip(contexts, got):
        values = [inp.expression.evaluate(ctx, lambda: 0) for inp in dec.inputs]
        host = [r for r, rule in enumerate(dec.rules)
                if all(t(v, ctx) for t, v in zip(rule.tests, values))]
        assert matched == host


def test_batch_evaluate_empty_and_single_rule():
    xml = W.dmn_band_xml()
    ref, port = _both(xml, "band")
    assert PD.batch_evaluate(port, [], device="cpu") == RD.batch_evaluate(ref, []) == []
    one = dataclasses.replace(port, kind=port.kind[:, :1], lo=port.lo[:, :1],
                              hi=port.hi[:, :1], flags=port.flags[:, :1],
                              out_values=port.out_values[:1], num_rules=1)
    ref_one = dataclasses.replace(ref, kind=ref.kind[:, :1], lo=ref.lo[:, :1],
                                  hi=ref.hi[:, :1], flags=ref.flags[:, :1],
                                  out_values=ref.out_values[:1], num_rules=1)
    contexts = W.dmn_band_contexts(64)
    assert PD.batch_evaluate(one, contexts, device="cpu") == \
        RD.batch_evaluate(ref_one, contexts)


def test_batch_evaluate_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port = _both(W.dmn_band_xml(), "band")
    with pytest.raises(RuntimeError, match="CUDA"):
        PD.batch_evaluate(port, W.dmn_band_contexts(4))
    assert len(PD.batch_evaluate(port, W.dmn_band_contexts(4), device="cpu")) == 4
