"""BPMN↔DMN integration: called decisions + standalone evaluation.

Reference: engine/…/processing/bpmn/behavior/BpmnDecisionBehavior.java
(business rule task with zeebe:calledDecision — evaluate at activation, write
the audit DECISION_EVALUATION event, set the result variable, raise
CALLED_DECISION_ERROR / DECISION_EVALUATION_ERROR incidents) and
engine/…/processing/dmn/DecisionEvaluationEvaluteProcessor (the gateway's
EvaluateDecision rpc)."""

from __future__ import annotations

from zeebe_tpu_torch.dmn import DecisionEngine, DecisionEvaluationResult
from zeebe_tpu_torch.engine.engine_state import EngineState
from zeebe_tpu_torch.engine.writers import Writers
from zeebe_tpu_torch.logstreams import LoggedRecord
from zeebe_tpu_torch.protocol import RejectionType, ValueType
from zeebe_tpu_torch.protocol.enums import ErrorType
from zeebe_tpu_torch.protocol.intent import DecisionEvaluationIntent

_ENGINE = DecisionEngine()


def evaluation_record_value(decision_meta: dict,
                            result: DecisionEvaluationResult) -> dict:
    """The DECISION_EVALUATION record shape (reference: protocol-impl
    DecisionEvaluationRecord — full audit trail)."""
    return {
        "decisionKey": decision_meta["decisionKey"],
        "decisionId": decision_meta["decisionId"],
        "decisionName": decision_meta["decisionName"],
        "decisionVersion": decision_meta["version"],
        "decisionRequirementsKey": decision_meta["decisionRequirementsKey"],
        "decisionRequirementsId": decision_meta["decisionRequirementsId"],
        "decisionOutput": result.output,
        "failedDecisionId": result.failed_decision_id,
        "evaluationFailureMessage": result.failure_message,
        "evaluatedDecisions": [
            {
                "decisionId": d.decision_id,
                "decisionName": d.decision_name,
                "decisionType": d.decision_type,
                "decisionOutput": d.output,
                "evaluatedInputs": [
                    {"inputId": i.input_id, "inputName": i.input_name,
                     "inputValue": i.input_value}
                    for i in d.evaluated_inputs
                ],
                "matchedRules": [
                    {"ruleId": r.rule_id, "ruleIndex": r.rule_index,
                     "evaluatedOutputs": [
                         {"outputId": o.output_id, "outputName": o.output_name,
                          "outputValue": o.output_value}
                         for o in r.evaluated_outputs
                     ]}
                    for r in d.matched_rules
                ],
            }
            for d in result.evaluated_decisions
        ],
    }


def _dmn_counter():
    """Registered at import (reference: ProcessEngineMetrics registers its
    collectors statically, not on first evaluation)."""
    from zeebe_tpu_torch.utils.metrics import REGISTRY

    return REGISTRY.counter(
        "evaluated_dmn_elements_total", "DMN decisions evaluated by outcome",
        ("action",))


_DMN_COUNTER = _dmn_counter()


def evaluate_decision(state: EngineState, decision_meta: dict,
                      context: dict) -> DecisionEvaluationResult:
    counter = _DMN_COUNTER
    drg = state.decisions.parsed_drg(decision_meta["decisionRequirementsKey"])
    if drg is None:
        counter.labels("failed").inc()
        result = DecisionEvaluationResult()
        result.failed = True
        result.failed_decision_id = decision_meta["decisionId"]
        result.failure_message = (
            f"decision requirements {decision_meta['decisionRequirementsKey']} "
            "not found in state"
        )
        return result
    result = _ENGINE.evaluate(drg, decision_meta["decisionId"], context)
    counter.labels("failed" if result.failed else "evaluated").inc()
    return result


class BpmnDecisionBehavior:
    """Business rule task with zeebe:calledDecision."""

    def __init__(self, state: EngineState, raise_incident, write_variable) -> None:
        self.state = state
        self._raise_incident = raise_incident
        self._write_variable = write_variable

    def evaluate_called_decision(self, key: int, value: dict, element,
                                 writers: Writers) -> bool:
        """Returns True when evaluation succeeded and the result variable was
        written; False when an incident was raised (element stays ACTIVATING)."""
        from zeebe_tpu_torch.protocol import DEFAULT_TENANT

        decision_meta = self.state.decisions.latest_decision_by_id(
            element.called_decision_id, value.get("tenantId", DEFAULT_TENANT)
        )
        if decision_meta is None:
            self._raise_incident(
                writers, key, value, ErrorType.CALLED_DECISION_ERROR,
                f"Expected to evaluate decision '{element.called_decision_id}', "
                "but no decision found for id",
            )
            return False
        context = self.state.variables.collect(key)
        result = evaluate_decision(self.state, decision_meta, context)
        eval_key = self.state.next_key()
        record_value = evaluation_record_value(decision_meta, result)
        record_value.update({
            "processInstanceKey": value.get("processInstanceKey", -1),
            "elementInstanceKey": key,
            "elementId": value.get("elementId", ""),
            "bpmnProcessId": value.get("bpmnProcessId", ""),
            "processDefinitionKey": value.get("processDefinitionKey", -1),
        })
        writers.append_event(
            eval_key, ValueType.DECISION_EVALUATION,
            DecisionEvaluationIntent.FAILED if result.failed
            else DecisionEvaluationIntent.EVALUATED,
            record_value,
        )
        if result.failed:
            self._raise_incident(
                writers, key, value, ErrorType.DECISION_EVALUATION_ERROR,
                result.failure_message,
            )
            return False
        if element.decision_result_variable:
            # result variable is local to the task scope; output mappings (or
            # the default merge) carry it outward (reference behavior)
            self._write_variable(
                writers, key, value, element.decision_result_variable,
                result.output,
            )
        return True


class DecisionEvaluationProcessor:
    """DECISION_EVALUATION EVALUATE command (gateway EvaluateDecision rpc)."""

    def __init__(self, state: EngineState) -> None:
        self.state = state

    def process(self, cmd: LoggedRecord, writers: Writers) -> None:
        from zeebe_tpu_torch.engine.processors import check_tenant_authorized
        from zeebe_tpu_torch.protocol import DEFAULT_TENANT

        value = cmd.record.value
        decision_id = value.get("decisionId", "")
        decision_key = value.get("decisionKey", -1)
        tenant = value.get("tenantId") or DEFAULT_TENANT
        if not check_tenant_authorized(cmd, tenant, writers):
            return
        if decision_key > 0:
            decision_meta = self.state.decisions.decision_by_key(decision_key)
            if decision_meta is not None and \
                    decision_meta.get("tenantId", DEFAULT_TENANT) != tenant:
                decision_meta = None
        else:
            decision_meta = self.state.decisions.latest_decision_by_id(
                decision_id, tenant)
        if decision_meta is None:
            writers.respond_rejection(
                cmd, RejectionType.NOT_FOUND,
                f"Expected to evaluate decision '{decision_id or decision_key}', "
                "but no decision found",
            )
            return
        result = evaluate_decision(
            self.state, decision_meta, dict(value.get("variables", {}))
        )
        eval_key = self.state.next_key()
        record = writers.append_event(
            eval_key, ValueType.DECISION_EVALUATION,
            DecisionEvaluationIntent.FAILED if result.failed
            else DecisionEvaluationIntent.EVALUATED,
            evaluation_record_value(decision_meta, result),
        )
        writers.respond(cmd, record)
