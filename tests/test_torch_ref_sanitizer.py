# tests/test_sanitizer.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Runtime sanitizer (zeebe_tpu/testing/sanitizer.py): the dynamic half of
. The headline test provokes a real cross-thread ``ZbDb`` write and
asserts the single-writer affinity assertion fires — proving the sanitizer
actually catches the race class the static linter can't see.
"""

import threading

import pytest

from zeebe_tpu_torch.state.db import ColumnFamilyCode, ZbDb, encode_key
from zeebe_tpu_torch.testing import sanitizer
from zeebe_tpu_torch.testing.sanitizer import SanitizerViolation, adopt_writer


@pytest.fixture
def sanitized():
    """Install for the test, then restore the pre-test state — under a
    ZEEBE_SANITIZE=1 run the suite-wide installation must survive this
    module's teardown."""
    was_installed = sanitizer.installed()
    sanitizer.install()
    yield
    sanitizer.uninstall()
    if was_installed:
        sanitizer.install()


def run_in_thread(fn):
    """Run ``fn`` on a fresh thread; return the exception it raised (or
    None)."""
    box = []

    def target():
        try:
            fn()
        except BaseException as exc:  # noqa: BLE001 — the assertion IS the result
            box.append(exc)

    t = threading.Thread(target=target, name="intruder")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    return box[0] if box else None


def put_one(db, key=7, value="x"):
    with db.transaction():
        db.column_family(ColumnFamilyCode.VARIABLES).put((key,), value)


def test_cross_thread_zbdb_write_fires_the_affinity_assertion(sanitized):
    db = ZbDb()
    put_one(db)  # main thread claims writer affinity
    exc = run_in_thread(lambda: put_one(db, key=8))
    assert isinstance(exc, SanitizerViolation)
    assert "single-writer violation" in str(exc)
    assert "intruder" in str(exc)
    # the race was REJECTED, not applied
    assert db.committed_get(ColumnFamilyCode.VARIABLES, (8,)) is None


def test_cross_thread_commit_of_a_handed_off_transaction_fires(sanitized):
    db = ZbDb()
    put_one(db)
    ctx = db.transaction()
    txn = ctx.__enter__()
    txn.put(encode_key(ColumnFamilyCode.VARIABLES, (9,)), "y")
    exc = run_in_thread(txn.commit)
    assert isinstance(exc, SanitizerViolation)
    txn.rollback()


def test_committed_reads_stay_cross_thread_safe(sanitized):
    """The sanctioned surface: committed_get / committed_keys_of from any
    thread never trips the sanitizer."""
    db = ZbDb()
    put_one(db, key=1, value="v")
    seen = []
    exc = run_in_thread(lambda: seen.append(
        (db.committed_get(ColumnFamilyCode.VARIABLES, (1,)),
         len(db.committed_keys_of(ColumnFamilyCode.VARIABLES)))))
    assert exc is None
    assert seen == [("v", 1)]


def test_adopt_writer_declares_a_legitimate_handoff(sanitized):
    db = ZbDb()
    put_one(db)

    def handed_off():
        adopt_writer(db)
        put_one(db, key=10)

    assert run_in_thread(handed_off) is None
    assert db.committed_get(ColumnFamilyCode.VARIABLES, (10,)) == "x"


def test_journal_append_affinity(sanitized, tmp_path):
    from zeebe_tpu_torch.journal import SegmentedJournal

    journal = SegmentedJournal(tmp_path)
    try:
        journal.append(b"first")  # main thread claims
        exc = run_in_thread(lambda: journal.append(b"second"))
        assert isinstance(exc, SanitizerViolation)
        assert journal.last_index == 1
    finally:
        journal.close()


def test_actuator_apply_pump_thread_affinity(sanitized):
    """Control-plane actuator applications happen on the pump thread that
    ticks the plane: the first applying thread claims the
    actuator; a different thread applying — a management handler or a test
    harness steering knobs from the side — fires the sanitizer, and the
    knob does NOT move."""
    from zeebe_tpu_torch.control.actuators import Actuator

    box = {"value": 0.0}

    def write(v):
        box["value"] = v

    act = Actuator("test-loop", "test.knob", lambda: box["value"], write,
                   min_value=0.0, max_value=10.0, max_step=10.0, static=0.0)
    act.apply(2.0, "claimed by the pump thread")  # main thread claims
    assert box["value"] == 2.0
    exc = run_in_thread(lambda: act.apply(9.0, "cross-thread intruder"))
    assert isinstance(exc, SanitizerViolation)
    assert "intruder" in str(exc)
    assert box["value"] == 2.0  # rejected, not applied
    # a declared handoff re-claims legitimately
    exc = run_in_thread(lambda: (sanitizer.adopt_writer(act),
                                 act.apply(4.0, "after handoff")))
    assert exc is None
    assert box["value"] == 4.0


def test_flight_recorder_reentrancy_guard(sanitized):
    from zeebe_tpu_torch.observability.flight_recorder import FlightRecorder

    recorder = FlightRecorder("n0", data_dir=None)

    def reentrant_clock():
        # a hook calling back into record() would deadlock the recorder's
        # non-reentrant lock in production; under the sanitizer it fails
        recorder.record(1, "from_clock_hook")
        return 0

    recorder.record(1, "plain")  # non-reentrant use is fine
    recorder.clock_millis = reentrant_clock
    with pytest.raises(SanitizerViolation, match="reentrant"):
        recorder.record(1, "outer")


def test_install_is_idempotent_and_uninstall_restores():
    was_installed = sanitizer.installed()
    sanitizer.uninstall()  # normalize: capture the TRUE originals
    originals = (ZbDb.transaction, ZbDb.require_transaction)
    try:
        sanitizer.install()
        sanitizer.install()  # idempotent: second install must not re-wrap
        assert ZbDb.transaction is not originals[0]
        sanitizer.uninstall()
        assert ZbDb.transaction is originals[0]
        assert ZbDb.require_transaction is originals[1]
        # normal cross-thread operation is unchecked again after uninstall
        db = ZbDb()
        put_one(db)
        assert run_in_thread(lambda: put_one(db, key=11)) is None
    finally:
        if was_installed:
            sanitizer.install()


def test_env_gate(monkeypatch):
    was_installed = sanitizer.installed()
    monkeypatch.setenv("ZEEBE_SANITIZE", "0")
    assert not sanitizer.enabled()
    monkeypatch.setenv("ZEEBE_SANITIZE", "1")
    assert sanitizer.enabled()
    sanitizer.maybe_install()
    assert sanitizer.installed()
    sanitizer.uninstall()
    if was_installed:
        sanitizer.install()


def test_engine_end_to_end_under_sanitizer(sanitized, tmp_path):
    """A representative single-broker scenario runs green with the
    sanitizer on: the broker's actual threading respects the single-writer
    contract (this is the shape the CI sanitizer slice scales up)."""
    from zeebe_tpu_torch.broker.broker import InProcessCluster
    from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
    from zeebe_tpu_torch.protocol import ValueType, command
    from zeebe_tpu_torch.protocol.intent import DeploymentIntent

    cluster = InProcessCluster(broker_count=1, partition_count=1,
                               replication_factor=1, directory=str(tmp_path), device="cpu")
    try:
        cluster.await_leaders()
        model = (Bpmn.create_executable_process("san_e2e")
                 .start_event("s").end_event("e").done())
        cluster.write_command(1, command(
            ValueType.DEPLOYMENT, DeploymentIntent.CREATE,
            {"resources": [{"resourceName": "m.bpmn",
                            "resource": to_bpmn_xml(model)}]}))
        cluster.run(500)
        leader = cluster.leader(1)
        assert leader is not None
        assert leader.stream.last_position > 0
    finally:
        cluster.close()
