# tests/test_feel_temporal.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""FEEL temporal type tests: literals, constructors, arithmetic, comparisons,
properties, variable-store serialization, timer timeDate/timeCycle end-to-end,
and DMN tables over temporal inputs.

Reference semantics: the camunda FEEL engine wired by
expression-language/src/main/java/io/camunda/zeebe/el/impl/
FeelExpressionLanguage.java:22-36 (DMN FEEL temporal chapter)."""

import pytest

from zeebe_tpu_torch.dmn import DecisionEngine, parse_dmn_xml
from zeebe_tpu_torch.feel import (
    Duration,
    FeelDate,
    FeelDateTime,
    FeelParseError,
    FeelTime,
    YearMonthDuration,
    normalize_value,
    parse_expression,
    parse_feel,
)
from zeebe_tpu_torch.models.bpmn import Bpmn
from zeebe_tpu_torch.protocol.intent import (
    ProcessInstanceIntent as PI,
    TimerIntent,
)
from zeebe_tpu_torch.testing import EngineHarness

CLOCK = 1785456000000  # 2026-07-31T02:40:00Z


def ev(src, **ctx):
    return parse_feel(src).evaluate(ctx, lambda: CLOCK)


@pytest.fixture
def harness(tmp_path):
    h = EngineHarness(tmp_path, device="cpu")
    yield h
    h.close()


class TestLiterals:
    def test_date_literal(self):
        d = ev('@"2026-07-31"')
        assert isinstance(d, FeelDate)
        assert (d.year, d.month, d.day) == (2026, 7, 31)

    def test_time_literal(self):
        t = ev('@"14:30:15"')
        assert isinstance(t, FeelTime)
        assert (t.hour, t.minute, t.second) == (14, 30, 15)

    def test_zoned_time_literal(self):
        t = ev('@"14:30:00+02:00"')
        assert t.time_offset == Duration(2 * 3600 * 1000)

    def test_date_time_literal(self):
        dt = ev('@"2026-07-31T14:30:00Z"')
        assert isinstance(dt, FeelDateTime)
        assert str(dt) == "2026-07-31T14:30:00Z"

    def test_duration_literals(self):
        assert ev('@"PT90S"') == Duration(90_000)
        assert ev('@"P1DT2H"') == Duration(26 * 3600 * 1000)
        assert ev('@"-PT1M"') == Duration(-60_000)
        assert ev('@"P1Y2M"') == YearMonthDuration(14)
        assert ev('@"-P2M"') == YearMonthDuration(-2)

    def test_bad_literal_is_parse_error(self):
        with pytest.raises(FeelParseError):
            parse_feel('@"not a date"')


class TestConstructors:
    def test_date_from_string_and_parts(self):
        assert ev('date("2026-07-31")') == ev("date(2026, 7, 31)")

    def test_date_invalid_is_null(self):
        assert ev('date("2026-13-99")') is None
        assert ev('date("bogus")') is None

    def test_time_from_parts(self):
        assert ev("time(14, 30, 0)") == ev('time("14:30:00")')

    def test_date_and_time_compose(self):
        composed = ev('date and time(date("2026-07-31"), time("14:30:00Z"))')
        assert composed == ev('@"2026-07-31T14:30:00Z"')

    def test_duration_invalid_is_null(self):
        assert ev('duration("XYZ")') is None

    def test_date_from_datetime_truncates(self):
        assert ev('date(@"2026-07-31T14:30:00Z")') == ev('@"2026-07-31"')


class TestArithmetic:
    def test_datetime_plus_duration(self):
        assert ev('@"2026-07-31T10:00:00Z" + @"PT2H30M"') == ev('@"2026-07-31T12:30:00Z"')

    def test_datetime_minus_datetime(self):
        assert ev('@"2026-07-31T12:00:00Z" - @"2026-07-31T10:30:00Z"') == Duration(5400_000)

    def test_date_plus_months_clamps(self):
        # Jan 31 + P1M = Feb 28 (calendar arithmetic, not +30d)
        assert ev('date("2026-01-31") + @"P1M"') == ev('date("2026-02-28")')

    def test_date_minus_date(self):
        assert ev('date("2026-08-02") - date("2026-07-31")') == Duration(2 * 86_400_000)

    def test_time_plus_duration_wraps(self):
        assert ev('@"23:30:00" + @"PT1H"') == ev('@"00:30:00"')

    def test_duration_scaling(self):
        assert ev('@"PT10S" * 6') == Duration(60_000)
        assert ev('@"PT1M" / 2') == Duration(30_000)
        assert ev('@"PT1M" / @"PT15S"') == 4.0

    def test_duration_sum_and_negation(self):
        assert ev('@"PT45S" + @"PT15S"') == Duration(60_000)
        assert ev('-@"PT30S"') == Duration(-30_000)
        assert ev('abs(-@"PT30S")') == Duration(30_000)

    def test_ym_duration_sum(self):
        assert ev('@"P1Y" + @"P3M"') == YearMonthDuration(15)


class TestComparisonAndRanges:
    def test_ordering(self):
        assert ev('@"2026-07-30" < @"2026-07-31"') is True
        assert ev('@"PT1M" > @"PT30S"') is True
        assert ev('@"10:00:00" <= @"10:00:01"') is True

    def test_equality_across_kinds_is_false(self):
        assert ev('@"2026-07-31" = "2026-07-31"') is False

    def test_range_membership(self):
        assert ev('@"2026-07-31" in [@"2026-07-01"..@"2026-08-01"]') is True
        assert ev('@"2026-09-01" in [@"2026-07-01"..@"2026-08-01"]') is False


class TestClockBuiltins:
    def test_now_is_datetime(self):
        now = ev("now()")
        assert isinstance(now, FeelDateTime)
        assert now.epoch_millis == CLOCK

    def test_today_is_date(self):
        assert ev("today()") == ev("date(now())")

    def test_now_references_clock(self):
        assert parse_expression('= now() + duration("PT5M")').references_clock()
        assert parse_expression("= today()").references_clock()
        assert not parse_expression('= duration("PT5M")').references_clock()


class TestPropertiesAndFunctions:
    def test_component_properties(self):
        assert ev('@"2026-07-31T14:30:15Z".year') == 2026
        assert ev('@"2026-07-31T14:30:15Z".hour') == 14
        assert ev('@"P1DT2H30M".days') == 1
        assert ev('@"P1DT2H30M".hours') == 2
        assert ev('@"P1DT2H30M".minutes') == 30
        assert ev('@"P2Y6M".years') == 2
        assert ev('@"P2Y6M".months') == 6

    def test_calendar_functions(self):
        assert ev('day of week(date("2026-07-31"))') == "Friday"
        assert ev('month of year(date("2026-07-31"))') == "July"
        assert ev('day of year(date("2026-02-01"))') == 32
        assert ev('week of year(date("2026-01-05"))') == 2

    def test_ym_duration_between(self):
        assert ev(
            'years and months duration(date("2024-01-15"), date("2026-07-20"))'
        ) == YearMonthDuration(30)

    def test_string_of_temporals(self):
        assert ev('string(@"PT90S")') == "PT1M30S"
        assert ev('string(@"2026-07-31")') == "2026-07-31"


class TestNormalization:
    def test_temporals_become_iso_strings(self):
        assert normalize_value(Duration(90_000)) == "PT1M30S"
        assert normalize_value([Duration(1000)]) == ["PT1S"]
        assert normalize_value({"when": ev('@"2026-07-31T00:00:00Z"')}) == {
            "when": "2026-07-31T00:00:00Z"
        }
        assert normalize_value({"n": 5}) == {"n": 5}


class TestTimerDateEndToEnd:
    def test_static_iso_date_timer(self, harness):
        due_iso = "2026-07-31T02:50:00Z"
        harness.deploy(
            Bpmn.create_executable_process("dated")
            .start_event("s")
            .intermediate_catch_timer("wait", date=due_iso)
            .end_event("e")
            .done()
        )
        harness.create_instance("dated")
        timer = harness.exporter.timer_records().with_intent(TimerIntent.CREATED).first()
        from zeebe_tpu_torch.feel.temporal import parse_date_time

        assert timer.record.value["dueDate"] == parse_date_time(due_iso).epoch_millis

    def test_feel_temporal_date_timer_fires(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("dated2")
            .start_event("s")
            .intermediate_catch_timer(
                "wait", date='= date and time(startAt) + duration("PT10S")'
            )
            .end_event("e")
            .done()
        )
        from zeebe_tpu_torch.feel.temporal import FeelDateTime as FDT

        start_iso = str(FDT.from_epoch_millis(harness.clock()))
        pi = harness.create_instance("dated2", {"startAt": start_iso})
        timer = harness.exporter.timer_records().with_intent(TimerIntent.CREATED).first()
        assert timer.record.value["dueDate"] == harness.clock() + 10_000
        harness.advance_time(9_999)
        assert not harness.exporter.timer_records().with_intent(TimerIntent.TRIGGERED).exists()
        harness.advance_time(1)
        assert harness.exporter.timer_records().with_intent(TimerIntent.TRIGGERED).exists()
        assert harness.is_instance_done(pi)

    def test_past_date_fires_immediately(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("past")
            .start_event("s")
            .intermediate_catch_timer("wait", date='= now() - duration("PT1S")')
            .end_event("e")
            .done()
        )
        pi = harness.create_instance("past")
        harness.advance_time(0)
        assert harness.exporter.timer_records().with_intent(TimerIntent.TRIGGERED).exists()
        assert harness.is_instance_done(pi)

    def test_bad_date_raises_incident(self, harness):
        from zeebe_tpu_torch.protocol.intent import IncidentIntent

        harness.deploy(
            Bpmn.create_executable_process("baddate")
            .start_event("s")
            .intermediate_catch_timer("wait", date="= junkVar")
            .end_event("e")
            .done()
        )
        harness.create_instance("baddate")
        inc = harness.exporter.incident_records().with_intent(IncidentIntent.CREATED).first()
        assert inc.record.value["errorType"] == "EXTRACT_VALUE_ERROR"


class TestTimerCycleExpression:
    def test_feel_cycle_boundary_repeats(self, harness):
        harness.deploy(
            Bpmn.create_executable_process("cyc")
            .start_event("s")
            .service_task("slow", job_type="slow-work")
            .boundary_timer(
                "tick", attached_to="slow", interrupting=False,
                cycle='= "R2/PT" + string(secs) + "S"',
            )
            .end_event("tick_end")
            .move_to_element("slow")
            .end_event("done_end")
            .done()
        )
        harness.create_instance("cyc", {"secs": 5})
        timer = harness.exporter.timer_records().with_intent(TimerIntent.CREATED).first()
        assert timer.record.value["dueDate"] == harness.clock() + 5_000
        assert timer.record.value["repetitions"] == 2
        harness.advance_time(5_000)
        assert (
            harness.exporter.timer_records().with_intent(TimerIntent.TRIGGERED).count() == 1
        )
        # non-interrupting cycle rescheduled once more (R2)
        harness.advance_time(5_000)
        assert (
            harness.exporter.timer_records().with_intent(TimerIntent.TRIGGERED).count() == 2
        )


class TestVariableSerialization:
    def test_output_mapping_writes_iso_string(self, harness):
        from zeebe_tpu_torch.protocol import ValueType
        from zeebe_tpu_torch.protocol.intent import VariableIntent

        harness.deploy(
            Bpmn.create_executable_process("ser")
            .start_event("s")
            .service_task("t", job_type="work")
            .zeebe_output('= now() + duration("PT1H")', "deadline")
            .end_event("e")
            .done()
        )
        harness.create_instance("ser")
        [job] = harness.activate_jobs("work")
        harness.complete_job(job["key"])
        var = (
            harness.exporter.variable_records()
            .with_intent(VariableIntent.CREATED)
            .with_value(name="deadline")
            .first()
        )
        value = var.record.value["value"]
        assert isinstance(value, str) and value.endswith("Z") and "T" in value


class TestDmnTemporal:
    DMN = """<?xml version="1.0"?>
<definitions xmlns="https://www.omg.org/spec/DMN/20191111/MODEL/" id="sla" name="sla">
  <decision id="sla" name="sla">
    <decisionTable hitPolicy="FIRST">
      <input id="i"><inputExpression><text>date and time(receivedAt)</text></inputExpression></input>
      <output id="o" name="band"/>
      <rule id="a"><inputEntry><text>&lt; date and time("2026-01-01T00:00:00Z")</text></inputEntry>
        <outputEntry><text>"legacy"</text></outputEntry></rule>
      <rule id="b"><inputEntry><text>-</text></inputEntry>
        <outputEntry><text>"current"</text></outputEntry></rule>
    </decisionTable>
  </decision>
</definitions>"""

    def test_temporal_decision_input(self):
        engine = DecisionEngine()
        drg = parse_dmn_xml(self.DMN)
        assert engine.evaluate(
            drg, "sla", {"receivedAt": "2025-06-30T12:00:00Z"}
        ).output == "legacy"
        assert engine.evaluate(
            drg, "sla", {"receivedAt": "2026-06-30T12:00:00Z"}
        ).output == "current"


class TestReviewRegressions:
    """Pinned behaviors from review findings."""

    def test_zone_names_containing_T(self):
        t = ev('@"10:00:00@Asia/Tokyo"')
        assert isinstance(t, FeelTime)
        assert t.time_offset == Duration(9 * 3600 * 1000)
        assert str(t) == "10:00:00@Asia/Tokyo"

    def test_zoned_time_compares_by_instant(self):
        assert ev('time("10:00:00@Asia/Tokyo") = time("01:00:00Z")') is True
        assert ev('@"10:00:00@Europe/Paris" < @"10:00:00Z"') is True

    def test_datetime_zone_resolves_dst_at_date(self):
        # Berlin is +02:00 in July (DST), +01:00 in January
        july = ev('@"2026-07-15T12:00:00@Europe/Berlin"')
        jan = ev('@"2026-01-15T12:00:00@Europe/Berlin"')
        assert july.time_offset == Duration(2 * 3600 * 1000)
        assert jan.time_offset == Duration(1 * 3600 * 1000)

    def test_variables_named_date_and_time_conjunction(self):
        assert ev("date and time", date=True, time=True) is True
        assert ev("years and months", years=1, months=2) is None  # non-bool and

    def test_multiword_still_fuses_in_call_and_property_position(self):
        assert ev('date and time("2026-07-31T00:00:00Z")') is not None
        assert ev('@"14:30:00+02:00".time offset') == Duration(2 * 3600 * 1000)

    def test_ym_timer_duration_poisons_template(self, harness):
        from zeebe_tpu_torch.engine import burst_templates as bt

        harness.deploy(
            Bpmn.create_executable_process("ym")
            .start_event("s")
            .intermediate_catch_timer("wait", duration='= duration("P1M")')
            .end_event("e")
            .done()
        )
        captured = []
        orig = bt.note_clock_poison
        bt.note_clock_poison = lambda: captured.append(True) or orig()
        try:
            harness.create_instance("ym")
        finally:
            bt.note_clock_poison = orig
        assert captured, "P1M due date must poison the burst template"
