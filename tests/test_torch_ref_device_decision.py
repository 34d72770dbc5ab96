# tests/test_device_decision.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Device DMN batch evaluation (ops/decision.py): decision tables compiled
to order-key atom arrays and evaluated N-contexts-at-a-time in one jitted
pass, cross-checked against the host evaluator (zeebe_tpu_torch.dmn)."""

from __future__ import annotations

import random

import pytest

from zeebe_tpu_torch.dmn import DecisionEngine, parse_dmn_xml
from zeebe_tpu_torch.ops.decision import (
    NotDeviceCompilable,
    batch_evaluate,
    compile_decision_table,
)

import torch_kernel_flows; torch_kernel_flows.port_module("test_dmn"); from _kflows_zeebe_tpu_torch_test_dmn import COLLECT_DMN, DISH_DMN


def _table(xml: str, decision_id: str):
    return parse_dmn_xml(xml).decisions[decision_id]


def _host_matches(decision, ctx: dict) -> list[int]:
    """Matched rule indices per the HOST unary-test evaluator."""
    out = []
    for r, rule in enumerate(decision.rules):
        values = [inp.expression.evaluate(ctx, lambda: 0) if inp.expression
                  else None for inp in decision.inputs]
        if all(t(v, ctx) for t, v in zip(rule.tests, values)):
            out.append(r)
    return out


class TestDeviceTable:
    def test_unique_matches_host(self):
        dec = _table(DISH_DMN, "dish")
        dt = compile_decision_table(dec)
        contexts = [
            {"season": "Winter", "guestCount": 8},
            {"season": "Winter", "guestCount": 9},
            {"season": "Summer", "guestCount": 2},
            {"season": "Autumn", "guestCount": 2},   # no match
            {"season": "Winter"},                     # null guests
            {"guestCount": 4},                        # null season
        ]
        got = batch_evaluate(dt, contexts, device="cpu")
        for ctx, sel in zip(contexts, got):
            host = _host_matches(dec, ctx)
            assert (sel if sel is not None else None) == (
                host[0] if len(host) == 1 else None), (ctx, sel, host)

    def test_collect_sum_matches_host_engine(self):
        dec = _table(COLLECT_DMN, "fees")
        dt = compile_decision_table(dec)
        engine = DecisionEngine()
        drg = parse_dmn_xml(COLLECT_DMN)
        contexts = [{"membership": "gold"}, {"membership": "silver"}, {}]
        got = batch_evaluate(dt, contexts, device="cpu")
        for ctx, agg in zip(contexts, got):
            host = engine.evaluate(drg, "fees", ctx)
            assert agg == host.output, (ctx, agg, host.output)

    def test_boundary_values_bit_exact(self):
        # the device compares float64 order keys: values one ulp around the
        # endpoints must route exactly like the host float comparison
        xml = DISH_DMN.replace("&lt;= 8", "&lt;= 8.5").replace("&gt; 8", "&gt; 8.5")
        dec = _table(xml, "dish")
        dt = compile_decision_table(dec)
        import math

        vals = [8.5, math.nextafter(8.5, 9), math.nextafter(8.5, 0), 8.499999999999999]
        contexts = [{"season": "Winter", "guestCount": v} for v in vals]
        got = batch_evaluate(dt, contexts, device="cpu")
        for ctx, sel in zip(contexts, got):
            host = _host_matches(dec, ctx)
            assert sel == (host[0] if len(host) == 1 else None), (ctx, sel, host)

    def test_intervals_and_disjunctions(self):
        xml = """<?xml version="1.0" encoding="UTF-8"?>
<definitions xmlns="https://www.omg.org/spec/DMN/20191111/MODEL/"
             id="iv" name="iv" namespace="test">
  <decision id="iv" name="iv">
    <decisionTable hitPolicy="FIRST">
      <input id="i1"><inputExpression><text>x</text></inputExpression></input>
      <output id="o1" name="band"/>
      <rule id="r1"><inputEntry><text>[0..10]</text></inputEntry>
        <outputEntry><text>"low"</text></outputEntry></rule>
      <rule id="r2"><inputEntry><text>(10..20)</text></inputEntry>
        <outputEntry><text>"mid"</text></outputEntry></rule>
      <rule id="r3"><inputEntry><text>20, 30, &gt;= 100</text></inputEntry>
        <outputEntry><text>"special"</text></outputEntry></rule>
    </decisionTable>
  </decision>
</definitions>"""
        dec = _table(xml, "iv")
        dt = compile_decision_table(dec)
        contexts = [{"x": v} for v in
                    (0, 10, 10.0000001, 19.999, 20, 25, 30, 100, 99.999, -1)]
        got = batch_evaluate(dt, contexts, device="cpu")
        for ctx, sel in zip(contexts, got):
            host = _host_matches(dec, ctx)
            assert sel == (host[0] if host else None), (ctx, sel, host)

    def test_rule_order_returns_all_matches(self):
        xml = COLLECT_DMN.replace('hitPolicy="COLLECT" aggregation="SUM"',
                                  'hitPolicy="RULE ORDER"')
        dec = _table(xml, "fees")
        dt = compile_decision_table(dec)
        got = batch_evaluate(dt, [{"membership": "gold"}, {"membership": "x"}], device="cpu")
        assert got == [[0, 1], [0]]

    def test_unsupported_shapes_decline(self):
        # not(...) cells, non-literal endpoints, computed inputs → host path
        base = DISH_DMN
        for bad in (
            base.replace("<text>season</text>", "<text>season + x</text>"),
            base.replace("<text>\"Winter\"</text>", "<text>not(\"Winter\")</text>", 1),
            base.replace("<text>&lt;= 8</text>", "<text>&lt;= limit</text>", 1),
        ):
            with pytest.raises(NotDeviceCompilable):
                compile_decision_table(_table(bad, "dish"))

    def test_randomized_tables_match_host(self):
        rng = random.Random(7)
        for seed in range(20):
            rng.seed(seed)
            R = rng.randint(2, 6)
            rules = []
            for r in range(R):
                cells = []
                for _i in range(2):
                    roll = rng.random()
                    if roll < 0.2:
                        cells.append("-")
                    elif roll < 0.45:
                        op = rng.choice(("&lt;", "&lt;=", "&gt;", "&gt;="))
                        cells.append(f"{op} {rng.randint(-5, 15)}")
                    elif roll < 0.7:
                        a, b = sorted((rng.randint(-5, 10), rng.randint(-5, 15)))
                        lo = rng.choice("[(")
                        hi = rng.choice("])")
                        cells.append(f"{lo}{a}..{b}{hi}")
                    else:
                        cells.append(str(rng.randint(-5, 15)))
                rules.append(
                    f'<rule id="r{r}">'
                    + "".join(f"<inputEntry><text>{c}</text></inputEntry>"
                              for c in cells)
                    + f"<outputEntry><text>{r}</text></outputEntry></rule>"
                )
            xml = f"""<?xml version="1.0" encoding="UTF-8"?>
<definitions xmlns="https://www.omg.org/spec/DMN/20191111/MODEL/"
             id="rt" name="rt" namespace="test">
  <decision id="rt" name="rt">
    <decisionTable hitPolicy="FIRST">
      <input id="i1"><inputExpression><text>a</text></inputExpression></input>
      <input id="i2"><inputExpression><text>b</text></inputExpression></input>
      <output id="o1" name="o"/>
      {"".join(rules)}
    </decisionTable>
  </decision>
</definitions>"""
            dec = _table(xml, "rt")
            dt = compile_decision_table(dec)
            contexts = [
                {"a": rng.randint(-6, 16), "b": rng.choice(
                    (rng.randint(-6, 16), rng.random() * 20 - 5, None))}
                for _ in range(32)
            ]
            got = batch_evaluate(dt, contexts, device="cpu")
            for ctx, sel in zip(contexts, got):
                host = _host_matches(dec, ctx)
                assert sel == (host[0] if host else None), (seed, ctx, sel, host)


class TestReviewRegressions:
    def test_boolean_cells_and_values(self):
        xml = """<?xml version="1.0" encoding="UTF-8"?>
<definitions xmlns="https://www.omg.org/spec/DMN/20191111/MODEL/"
             id="bl" name="bl" namespace="test">
  <decision id="bl" name="bl">
    <decisionTable hitPolicy="FIRST">
      <input id="i1"><inputExpression><text>flag</text></inputExpression></input>
      <output id="o1" name="o"/>
      <rule id="r1"><inputEntry><text>true</text></inputEntry>
        <outputEntry><text>"yes"</text></outputEntry></rule>
      <rule id="r2"><inputEntry><text>-</text></inputEntry>
        <outputEntry><text>"no"</text></outputEntry></rule>
    </decisionTable>
  </decision>
</definitions>"""
        dec = _table(xml, "bl")
        dt = compile_decision_table(dec)
        contexts = [{"flag": True}, {"flag": False}, {"flag": 1}, {}]
        got = batch_evaluate(dt, contexts, device="cpu")
        for ctx, sel in zip(contexts, got):
            host = _host_matches(dec, ctx)
            assert sel == host[0], (ctx, sel, host)

    def test_collect_min_float64_exact(self):
        xml = COLLECT_DMN.replace('aggregation="SUM"', 'aggregation="MIN"'
                                  ).replace("<text>10</text>", "<text>0.1</text>")
        dec = _table(xml, "fees")
        dt = compile_decision_table(dec)
        got = batch_evaluate(dt, [{"membership": "silver"}], device="cpu")
        assert got == [0.1]  # float64 exactly, no f32 drift

    def test_aggregation_contract_declines(self):
        # aggregation outside COLLECT, multi-output aggregation, and cells
        # the batch lexer cannot parse (host-supported '?') all decline
        for bad in (
            COLLECT_DMN.replace('hitPolicy="COLLECT" aggregation="SUM"',
                                'hitPolicy="FIRST" aggregation="SUM"'),
            COLLECT_DMN.replace('<output id="o1" name="fee"/>',
                                '<output id="o1" name="fee"/>'
                                '<output id="o2" name="x"/>'
                                ).replace("<outputEntry><text>10</text></outputEntry>",
                                          "<outputEntry><text>10</text></outputEntry>"
                                          "<outputEntry><text>1</text></outputEntry>"
                                ).replace("<outputEntry><text>5</text></outputEntry>",
                                          "<outputEntry><text>5</text></outputEntry>"
                                          "<outputEntry><text>2</text></outputEntry>"),
            COLLECT_DMN.replace("<text>-</text>", "<text>? * 2 &gt; 1</text>"),
        ):
            with pytest.raises(NotDeviceCompilable):
                compile_decision_table(_table(bad, "fees"))
