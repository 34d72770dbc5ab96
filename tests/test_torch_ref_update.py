# tests/test_update.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Rolling-upgrade tests (reference: qa/update-tests/src/test/java/io/camunda/
zeebe/test/RollingUpdateTest.java:51).

Every committed fixture under tests/fixtures/upgrade/<tag>/ was produced by a
PREVIOUS round's code (tests/upgrade_fixture.py). The current code must:
1. replay the old journal into equivalent state (log compatibility),
2. restore the old state snapshot through its migrations and agree with the
   replayed state (snapshot + migration compatibility),
3. pick up the in-flight work — pending jobs, parked timers and message
   subscriptions, standing incidents — and drive every instance to
   completion (behavioral compatibility).
"""

from __future__ import annotations

import json
import shutil

import pytest

import torch_kernel_flows; torch_kernel_flows.port_module("upgrade_fixture"); from _kflows_zeebe_tpu_torch_upgrade_fixture import FIXTURES_DIR, run_scenario
from zeebe_tpu_torch.protocol import ValueType
from zeebe_tpu_torch.testing import ControlledClock, EngineHarness

FIXTURE_TAGS = sorted(p.name for p in FIXTURES_DIR.iterdir()) if FIXTURES_DIR.exists() else []


def _reopen(fixture, tmp_path, use_kernel_backend=False) -> EngineHarness:
    expected = json.loads((fixture / "expected.json").read_text())
    work = tmp_path / "work"
    work.mkdir()
    shutil.copytree(fixture / "log", work / "log")
    h = EngineHarness(directory=work,
                      clock=ControlledClock(expected["tag_clock_millis"]),
                      use_kernel_backend=use_kernel_backend, device="cpu")
    h.pump()
    return h, expected


@pytest.mark.parametrize("tag", FIXTURE_TAGS)
class TestRollingUpgrade:
    def test_replay_matches_migrated_snapshot(self, tag, tmp_path):
        from zeebe_tpu_torch.engine.migration import DbMigrator
        from zeebe_tpu_torch.state import ZbDb

        import struct

        from zeebe_tpu_torch.state.db import ColumnFamilyCode

        fixture = FIXTURES_DIR / tag
        h, expected = _reopen(fixture, tmp_path)
        try:
            assert h.stream.last_position == expected["last_position"]
            restored = ZbDb.from_snapshot_bytes(
                (fixture / "state.snapshot").read_bytes())
            DbMigrator(restored).run_migrations()
            DbMigrator(h.db).run_migrations()
            # The request-dedupe family is log-derived with a
            # horizon: entries materialize from the evidence a reconstruction
            # actually replays. A snapshot frozen BEFORE the family existed
            # cannot contain entries for the pre-snapshot evidence that a
            # from-genesis replay legitimately materializes, so the upgrade
            # comparison treats the family as one-sided — the snapshot side
            # must never hold an entry the replayed side lacks (extra
            # replayed entries are strictly additive dedupe protection) —
            # while every other family must still match exactly. Two
            # same-horizon reconstructions (replica replay, recovery, the
            # chaos/soak parity oracles) keep comparing the family strictly.
            dedupe = tuple(
                struct.pack(">H", int(code))
                for code in (ColumnFamilyCode.REQUEST_DEDUPE,
                             ColumnFamilyCode.REQUEST_DEDUPE_BY_POSITION))
            snap_dedupe = {k: v for k, v in restored._data.items()
                           if k.startswith(dedupe)}
            replay_dedupe = {k: v for k, v in h.db._data.items()
                             if k.startswith(dedupe)}
            for key, value in snap_dedupe.items():
                assert replay_dedupe.get(key) == value
            assert ({k: v for k, v in restored._data.items()
                     if not k.startswith(dedupe)}
                    == {k: v for k, v in h.db._data.items()
                        if not k.startswith(dedupe)})
        finally:
            h.close()

    def test_in_flight_state_visible(self, tag, tmp_path):
        h, expected = _reopen(FIXTURES_DIR / tag, tmp_path)
        try:
            for key_str in expected["running"]:
                assert not h.is_instance_done(int(key_str))
            for key in expected["completed_keys"]:
                assert h.is_instance_done(key)
            for job_type, count in expected["pending_jobs"].items():
                jobs = h.activate_jobs(job_type, max_jobs=50)
                assert len(jobs) == count, (job_type, len(jobs), count)
                for job in jobs:
                    h.fail_job(job["key"], retries=1)  # release for later
        finally:
            h.close()

    @pytest.mark.parametrize("use_kernel", [False, True])
    def test_drive_in_flight_work_to_completion(self, tag, tmp_path, use_kernel):
        h, expected = _reopen(FIXTURES_DIR / tag, tmp_path,
                              use_kernel_backend=use_kernel)
        try:
            for job_type in expected["pending_jobs"]:
                for job in h.activate_jobs(job_type, max_jobs=50):
                    h.complete_job(job["key"], {"upgraded": True})
            # second waves (io_chain's t1, sub_bnd drains after inner)
            for job_type in ("up_io2",):
                for job in h.activate_jobs(job_type, max_jobs=50):
                    h.complete_job(job["key"], {})
            # respawning types (sequential MI): drain until silent
            for job_type in expected.get("drain_loop_types", ()):
                for _ in range(20):
                    jobs = h.activate_jobs(job_type, max_jobs=50)
                    if not jobs:
                        break
                    for job in jobs:
                        h.complete_job(job["key"], {})
            msg = expected["message"]
            h.publish_message(msg["name"], msg["correlation_key"],
                              variables={"resumed": 1})
            h.advance_time(expected["timer_advance_ms"])
            for job in h.activate_jobs("up_after_timer", max_jobs=50):
                h.complete_job(job["key"], {})
            for key_str, pid in expected["running"].items():
                assert h.is_instance_done(int(key_str)), (
                    f"{pid} instance {key_str} did not complete after upgrade")
            # the no-match incident survives the upgrade, standing
            incidents = [
                v for v in h.stream.scan()
                if v.value_type == int(ValueType.INCIDENT) and v.is_event
            ]
            assert incidents
            assert not h.is_instance_done(expected["incident_instance"])
        finally:
            h.close()


def test_current_code_can_generate_fixture(tmp_path):
    """The generator itself stays runnable (so round N+1 can freeze its own
    tag), without touching the committed fixtures."""
    h = EngineHarness(directory=tmp_path, clock=ControlledClock(1_750_000_000_000), device="cpu")
    try:
        expected = run_scenario(h)
        assert expected["pending_jobs"]
        assert h.stream.last_position == expected["last_position"]
    finally:
        h.close()
