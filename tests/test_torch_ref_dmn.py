# tests/test_dmn.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""DMN decision engine tests (reference: dmn/src/test — DecisionEngineTest,
hit policy semantics, DRG evaluation, audit records; engine business-rule-task
suite engine/src/test/…/bpmn/task/BusinessRuleTaskTest)."""

from __future__ import annotations

import pytest

from zeebe_tpu_torch.dmn import DecisionEngine, DmnParseError, parse_dmn_xml
from zeebe_tpu_torch.models.bpmn import Bpmn
from zeebe_tpu_torch.protocol import ValueType, command
from zeebe_tpu_torch.protocol.enums import ErrorType
from zeebe_tpu_torch.protocol.intent import (
    DecisionEvaluationIntent,
    DecisionIntent,
    DecisionRequirementsIntent,
    IncidentIntent,
)
from zeebe_tpu_torch.testing import EngineHarness

DISH_DMN = """<?xml version="1.0" encoding="UTF-8"?>
<definitions xmlns="https://www.omg.org/spec/DMN/20191111/MODEL/"
             id="dish_drg" name="Dish decisions" namespace="test">
  <decision id="dish" name="Dish">
    <decisionTable hitPolicy="UNIQUE">
      <input id="i1" label="season">
        <inputExpression><text>season</text></inputExpression>
      </input>
      <input id="i2" label="guests">
        <inputExpression><text>guestCount</text></inputExpression>
      </input>
      <output id="o1" name="dish" />
      <rule id="r1">
        <inputEntry><text>"Winter"</text></inputEntry>
        <inputEntry><text>&lt;= 8</text></inputEntry>
        <outputEntry><text>"Spareribs"</text></outputEntry>
      </rule>
      <rule id="r2">
        <inputEntry><text>"Winter"</text></inputEntry>
        <inputEntry><text>&gt; 8</text></inputEntry>
        <outputEntry><text>"Pasta"</text></outputEntry>
      </rule>
      <rule id="r3">
        <inputEntry><text>"Summer"</text></inputEntry>
        <inputEntry><text>-</text></inputEntry>
        <outputEntry><text>"Salad"</text></outputEntry>
      </rule>
    </decisionTable>
  </decision>
</definitions>
"""

DRG_DMN = """<?xml version="1.0" encoding="UTF-8"?>
<definitions xmlns="https://www.omg.org/spec/DMN/20191111/MODEL/"
             id="scoring" name="Scoring" namespace="test">
  <decision id="base_score" name="base score">
    <literalExpression><text>points * 2</text></literalExpression>
  </decision>
  <decision id="verdict" name="verdict">
    <informationRequirement>
      <requiredDecision href="#base_score"/>
    </informationRequirement>
    <decisionTable hitPolicy="FIRST">
      <input id="i1" label="score">
        <inputExpression><text>base_score</text></inputExpression>
      </input>
      <output id="o1" name="verdict"/>
      <rule id="r1">
        <inputEntry><text>&gt;= 100</text></inputEntry>
        <outputEntry><text>"accepted"</text></outputEntry>
      </rule>
      <rule id="r2">
        <inputEntry><text>-</text></inputEntry>
        <outputEntry><text>"rejected"</text></outputEntry>
      </rule>
    </decisionTable>
  </decision>
</definitions>
"""

COLLECT_DMN = """<?xml version="1.0" encoding="UTF-8"?>
<definitions xmlns="https://www.omg.org/spec/DMN/20191111/MODEL/"
             id="fees" name="Fees" namespace="test">
  <decision id="fees" name="fees">
    <decisionTable hitPolicy="COLLECT" aggregation="SUM">
      <input id="i1" label="type">
        <inputExpression><text>membership</text></inputExpression>
      </input>
      <output id="o1" name="fee"/>
      <rule id="r1">
        <inputEntry><text>-</text></inputEntry>
        <outputEntry><text>10</text></outputEntry>
      </rule>
      <rule id="r2">
        <inputEntry><text>"gold"</text></inputEntry>
        <outputEntry><text>5</text></outputEntry>
      </rule>
    </decisionTable>
  </decision>
</definitions>
"""


class TestDecisionTable:
    def setup_method(self):
        self.engine = DecisionEngine()
        self.drg = parse_dmn_xml(DISH_DMN)

    def test_unique_match(self):
        r = self.engine.evaluate(self.drg, "dish",
                                 {"season": "Winter", "guestCount": 4})
        assert not r.failed
        assert r.output == "Spareribs"
        [d] = r.evaluated_decisions
        assert [i.input_value for i in d.evaluated_inputs] == ["Winter", 4]
        [rule] = d.matched_rules
        assert rule.rule_id == "r1" and rule.rule_index == 1

    def test_dash_matches_anything(self):
        r = self.engine.evaluate(self.drg, "dish",
                                 {"season": "Summer", "guestCount": 99})
        assert r.output == "Salad"

    def test_no_match_yields_null(self):
        r = self.engine.evaluate(self.drg, "dish",
                                 {"season": "Spring", "guestCount": 1})
        assert not r.failed
        assert r.output is None

    def test_unknown_decision_fails(self):
        r = self.engine.evaluate(self.drg, "nope", {})
        assert r.failed
        assert "nope" in r.failure_message

    def test_unary_test_variants(self):
        drg = parse_dmn_xml("""<?xml version="1.0"?>
<definitions xmlns="https://www.omg.org/spec/DMN/20191111/MODEL/" id="u" name="u">
  <decision id="u" name="u">
    <decisionTable hitPolicy="FIRST">
      <input id="i"><inputExpression><text>x</text></inputExpression></input>
      <output id="o" name="r"/>
      <rule id="a"><inputEntry><text>[10..20]</text></inputEntry>
        <outputEntry><text>"interval"</text></outputEntry></rule>
      <rule id="b"><inputEntry><text>1, 2, 3</text></inputEntry>
        <outputEntry><text>"list"</text></outputEntry></rule>
      <rule id="c"><inputEntry><text>not(0)</text></inputEntry>
        <outputEntry><text>"not-zero"</text></outputEntry></rule>
    </decisionTable>
  </decision>
</definitions>""")
        engine = DecisionEngine()
        assert engine.evaluate(drg, "u", {"x": 15}).output == "interval"
        assert engine.evaluate(drg, "u", {"x": 2}).output == "list"
        assert engine.evaluate(drg, "u", {"x": 7}).output == "not-zero"

    def test_collect_sum(self):
        drg = parse_dmn_xml(COLLECT_DMN)
        r = DecisionEngine().evaluate(drg, "fees", {"membership": "gold"})
        assert r.output == 15

    def test_parse_errors(self):
        with pytest.raises(DmnParseError):
            parse_dmn_xml("<notdmn/>")
        with pytest.raises(DmnParseError):
            parse_dmn_xml("not xml at all <<<")


class TestDrgEvaluation:
    def test_required_decision_feeds_dependent(self):
        drg = parse_dmn_xml(DRG_DMN)
        r = DecisionEngine().evaluate(drg, "verdict", {"points": 60})
        assert r.output == "accepted"  # 60*2 = 120 >= 100
        assert [d.decision_id for d in r.evaluated_decisions] == \
            ["base_score", "verdict"]
        r2 = DecisionEngine().evaluate(drg, "verdict", {"points": 10})
        assert r2.output == "rejected"


@pytest.fixture()
def harness():
    h = EngineHarness(device="cpu")
    yield h
    h.close()


def deploy_with_dmn(harness, model, dmn_xml):
    from zeebe_tpu_torch.models.bpmn import to_bpmn_xml
    from zeebe_tpu_torch.protocol.intent import DeploymentIntent

    harness.write_command(command(
        ValueType.DEPLOYMENT, DeploymentIntent.CREATE,
        {"resources": [
            {"resourceName": "proc.bpmn", "resource": to_bpmn_xml(model)},
            {"resourceName": "table.dmn", "resource": dmn_xml},
        ]},
    ), request_id=1)


class TestBusinessRuleTask:
    def test_called_decision_completes_task(self, harness):
        model = (
            Bpmn.create_executable_process("brt")
            .start_event("s")
            .business_rule_task("decide", called_decision_id="dish",
                                result_variable="meal")
            .end_event("e")
            .done()
        )
        deploy_with_dmn(harness, model, DISH_DMN)
        # decision records were deployed
        assert harness.exporter.all().with_value_type(ValueType.DECISION) \
            .with_intent(DecisionIntent.CREATED).to_list()
        assert harness.exporter.all().with_value_type(ValueType.DECISION_REQUIREMENTS) \
            .with_intent(DecisionRequirementsIntent.CREATED).to_list()
        pi = harness.create_instance("brt", {"season": "Winter", "guestCount": 3})
        assert harness.is_instance_done(pi)
        evaluated = harness.exporter.all().with_value_type(
            ValueType.DECISION_EVALUATION
        ).with_intent(DecisionEvaluationIntent.EVALUATED).to_list()
        assert len(evaluated) == 1
        assert evaluated[0].record.value["decisionOutput"] == "Spareribs"

    def test_missing_decision_raises_incident(self, harness):
        model = (
            Bpmn.create_executable_process("brt2")
            .start_event("s")
            .business_rule_task("decide", called_decision_id="ghost",
                                result_variable="x")
            .end_event("e")
            .done()
        )
        harness.deploy(model)
        pi = harness.create_instance("brt2")
        assert not harness.is_instance_done(pi)
        [incident] = harness.exporter.all().with_value_type(
            ValueType.INCIDENT
        ).with_intent(IncidentIntent.CREATED).to_list()
        assert incident.record.value["errorType"] == ErrorType.CALLED_DECISION_ERROR.name

    def test_evaluation_failure_incident_and_resolve(self, harness):
        model = (
            Bpmn.create_executable_process("brt3")
            .start_event("s")
            .business_rule_task("decide", called_decision_id="dish",
                                result_variable="meal")
            .end_event("e")
            .done()
        )
        # UNIQUE violated: overlapping rules for Winter <= 8 vs another table…
        # here: missing variables make the input expression fail? FEEL-lite
        # null-safe lookups return None, so drive a UNIQUE violation instead
        unique_violation = DISH_DMN.replace(
            '<inputEntry><text>&gt; 8</text></inputEntry>',
            '<inputEntry><text>-</text></inputEntry>',
        )
        deploy_with_dmn(harness, model, unique_violation)
        pi = harness.create_instance("brt3", {"season": "Winter", "guestCount": 3})
        assert not harness.is_instance_done(pi)
        [incident] = harness.exporter.all().with_value_type(
            ValueType.INCIDENT
        ).with_intent(IncidentIntent.CREATED).to_list()
        assert incident.record.value["errorType"] == \
            ErrorType.DECISION_EVALUATION_ERROR.name
        failed = harness.exporter.all().with_value_type(
            ValueType.DECISION_EVALUATION
        ).with_intent(DecisionEvaluationIntent.FAILED).to_list()
        assert len(failed) == 1

    def test_result_variable_propagates(self, harness):
        model = (
            Bpmn.create_executable_process("brt4")
            .start_event("s")
            .business_rule_task("decide", called_decision_id="dish",
                                result_variable="meal")
            # the result variable lives in the task's local scope; an output
            # mapping carries it outward (reference: calledDecision docs)
            .zeebe_output("=meal", "meal")
            .service_task("use", job_type="use_meal")
            .end_event("e")
            .done()
        )
        deploy_with_dmn(harness, model, DISH_DMN)
        harness.create_instance("brt4", {"season": "Summer", "guestCount": 2})
        [job] = harness.activate_jobs("use_meal")
        assert job["variables"]["meal"] == "Salad"


class TestStandaloneEvaluation:
    def test_evaluate_decision_command(self, harness):
        model = (
            Bpmn.create_executable_process("noop_dmn")
            .start_event("s").end_event("e").done()
        )
        deploy_with_dmn(harness, model, DISH_DMN)
        harness.write_command(command(
            ValueType.DECISION_EVALUATION, DecisionEvaluationIntent.EVALUATE,
            {"decisionId": "dish",
             "variables": {"season": "Winter", "guestCount": 10}},
        ), request_id=42)
        evaluated = harness.exporter.all().with_value_type(
            ValueType.DECISION_EVALUATION
        ).with_intent(DecisionEvaluationIntent.EVALUATED).to_list()
        assert evaluated[-1].record.value["decisionOutput"] == "Pasta"
        # response routed back to the request
        assert any(r.request_id == 42 for r in harness.responses)

    def test_unknown_decision_rejected(self, harness):
        harness.write_command(command(
            ValueType.DECISION_EVALUATION, DecisionEvaluationIntent.EVALUATE,
            {"decisionId": "missing", "variables": {}},
        ), request_id=43)
        rejections = harness.exporter.all().rejections().to_list()
        assert any(r.record.value_type == ValueType.DECISION_EVALUATION
                   for r in rejections)


class TestDmnRedeploy:
    def test_duplicate_redeploy_reports_existing_metadata(self, harness):
        from zeebe_tpu_torch.protocol.intent import DeploymentIntent

        model = (Bpmn.create_executable_process("noop2")
                 .start_event("s").end_event("e").done())
        deploy_with_dmn(harness, model, DISH_DMN)
        first = harness.exporter.all().with_value_type(ValueType.DEPLOYMENT) \
            .with_intent(DeploymentIntent.CREATED).to_list()[-1]
        first_decisions = first.record.value["decisionsMetadata"]
        assert first_decisions and not first_decisions[0].get("duplicate")
        deploy_with_dmn(harness, model, DISH_DMN)  # identical redeploy
        second = harness.exporter.all().with_value_type(ValueType.DEPLOYMENT) \
            .with_intent(DeploymentIntent.CREATED).to_list()[-1]
        second_decisions = second.record.value["decisionsMetadata"]
        assert second_decisions, "duplicate redeploy must still report metadata"
        assert all(m["duplicate"] for m in second_decisions)
        assert second_decisions[0]["decisionKey"] == first_decisions[0]["decisionKey"]
        # no second DECISION CREATED event
        created = harness.exporter.all().with_value_type(ValueType.DECISION) \
            .with_intent(DecisionIntent.CREATED).to_list()
        assert len(created) == len(first_decisions)

    def test_incident_resolvable_after_failed_evaluation(self, harness):
        model = (
            Bpmn.create_executable_process("brt5")
            .start_event("s")
            .business_rule_task("decide", called_decision_id="dish",
                                result_variable="meal")
            .end_event("e")
            .done()
        )
        unique_violation = DISH_DMN.replace(
            '<inputEntry><text>&gt; 8</text></inputEntry>',
            '<inputEntry><text>-</text></inputEntry>',
        )
        deploy_with_dmn(harness, model, unique_violation)
        pi = harness.create_instance("brt5", {"season": "Winter", "guestCount": 3})
        [incident] = harness.exporter.all().with_value_type(ValueType.INCIDENT) \
            .with_intent(IncidentIntent.CREATED).to_list()
        # fix the input so only the summer rule could match... the violation is
        # structural for Winter; switch season so a single rule matches
        harness.set_variables(pi, {"season": "Summer"})
        harness.resolve_incident(incident.record.key)
        assert harness.is_instance_done(pi)
