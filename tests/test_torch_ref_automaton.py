# tests/test_automaton.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Automaton kernel tests: lock-step semantics, gateways, joins, sharding,
and parity with the sequential Python engine (the batched schedule must be a
reordering-equivalent of one-at-a-time processing)."""

import numpy as np
import pytest

from zeebe_tpu_torch.models.bpmn import Bpmn, transform
from zeebe_tpu_torch.ops.automaton import (
    DeviceTables,
    PHASE_WAIT,
    complete_jobs,
    make_state,
    run_to_completion,
    step,
)
from zeebe_tpu_torch.ops.parity import engine_intent_sequence, run_with_events
from zeebe_tpu_torch.ops.tables import ConditionNotCompilable, compile_condition, compile_tables, SlotMap
from zeebe_tpu_torch.feel import parse_feel
from zeebe_tpu_torch.testing import EngineHarness


def exe_one_task():
    return transform(
        Bpmn.create_executable_process("one_task")
        .start_event("start")
        .service_task("task", job_type="work")
        .end_event("end")
        .done()
    )


def exe_branching():
    return transform(
        Bpmn.create_executable_process("branching")
        .start_event("start")
        .exclusive_gateway("gw")
        .sequence_flow_id("to_big")
        .condition_expression("amount >= 100")
        .service_task("big", job_type="big-order")
        .end_event("end_big")
        .move_to_element("gw")
        .sequence_flow_id("to_small")
        .default_flow()
        .service_task("small", job_type="small-order")
        .end_event("end_small")
        .done()
    )


def exe_fork_join():
    return transform(
        Bpmn.create_executable_process("fj")
        .start_event("s")
        .parallel_gateway("fork")
        .service_task("a", job_type="a")
        .parallel_gateway("join")
        .end_event("e")
        .move_to_element("fork")
        .service_task("b", job_type="b")
        .connect_to("join")
        .done()
    )


class TestConditionCompiler:
    def test_numeric_condition_compiles(self):
        prog = compile_condition(parse_feel("x >= 100").ast, SlotMap())
        assert len(prog) == 3

    def test_boolean_ops(self):
        slots = SlotMap()
        prog = compile_condition(parse_feel("a > 1 and not(b < 2 or a = 3)").ast, slots)
        assert len(prog) > 5
        assert slots.count == 2

    def test_string_var_pair_never_lowers(self):
        # `a = b` types both vars numeric; combined with a string-literal
        # comparison on `a` the slot-kind conflict rejects the program —
        # two string slots never meet on device (their unknown insertion-
        # rank keys could collide)
        from zeebe_tpu_torch.ops.tables import StringInterner

        interner = StringInterner()
        interner.intern_sorted({"anchor"})
        with pytest.raises(ConditionNotCompilable):
            compile_condition(
                parse_feel('a != "anchor" and a = b').ast, SlotMap(), interner)

    def test_string_condition_rejected(self):
        with pytest.raises(ConditionNotCompilable):
            compile_condition(parse_feel('name = "alice"').ast, SlotMap())

    def test_arithmetic_rejected(self):
        # arithmetic cannot run in order-key space: the gateway host-escapes
        # instead, keeping device comparisons bit-exact vs host float64
        with pytest.raises(ConditionNotCompilable):
            compile_condition(parse_feel("x + 1 > 2").ast, SlotMap())

    def test_non_boolean_root_rejected(self):
        with pytest.raises(ConditionNotCompilable):
            compile_condition(parse_feel("x").ast, SlotMap())


class TestKernelBasics:
    def test_one_task_completes(self):
        tables = compile_tables([exe_one_task()])
        dt = DeviceTables.from_numpy(tables, device="cpu")
        state = make_state(tables, 16, np.zeros(16, np.int32), device="cpu")
        final, steps = run_to_completion(dt, state)
        assert bool(final["done"].all())
        assert int(final["completed"]) == 16
        assert int(final["jobs_created"]) == 16
        assert int(final["transitions"]) == 16 * 16  # 16 transitions/instance
        assert not bool(final["overflow"])

    def test_branching_routes_by_condition(self):
        tables = compile_tables([exe_branching()])
        dt = DeviceTables.from_numpy(tables, device="cpu")
        slots = np.zeros((6, tables.num_slots), np.float32)
        amounts = [10, 100, 99, 150, 0, 100000]
        slots[:, tables.slot_map.names["amount"]] = amounts
        state = make_state(tables, 6, np.zeros(6, np.int32), initial_slots=slots, device="cpu")
        final, _ = run_to_completion(dt, state)
        assert bool(final["done"].all())

    def test_fork_join_counts(self):
        tables = compile_tables([exe_fork_join()])
        dt = DeviceTables.from_numpy(tables, device="cpu")
        state = make_state(tables, 8, np.zeros(8, np.int32), token_capacity=32, device="cpu")
        final, _ = run_to_completion(dt, state)
        assert bool(final["done"].all())
        assert int(final["jobs_created"]) == 16  # two tasks per instance
        assert not bool(final["overflow"])
        assert int(np.asarray(final["join_counts"]).sum()) == 0  # all consumed

    def test_no_match_no_default_stalls_with_incident(self):
        exe = transform(
            Bpmn.create_executable_process("nomatch")
            .start_event("s")
            .exclusive_gateway("gw")
            .condition_expression("x > 10")
            .end_event("e")
            .done()
        )
        tables = compile_tables([exe])
        dt = DeviceTables.from_numpy(tables, device="cpu")
        slots = np.zeros((2, tables.num_slots), np.float32)
        slots[:, tables.slot_map.names["x"]] = [1, 50]
        state = make_state(tables, 2, np.zeros(2, np.int32), initial_slots=slots, device="cpu")
        final, _ = run_to_completion(dt, state, max_steps=20)
        done = np.asarray(final["done"])
        incident = np.asarray(final["incident"])
        assert not done[0] and incident[0]  # stalled with incident
        assert done[1] and not incident[1]

    def test_token_overflow_flagged(self):
        tables = compile_tables([exe_fork_join()])
        dt = DeviceTables.from_numpy(tables, device="cpu")
        # capacity too small for the fork fan-out
        state = make_state(tables, 8, np.zeros(8, np.int32), token_capacity=8, device="cpu")
        final, _ = run_to_completion(dt, state, max_steps=20)
        assert bool(final["overflow"])

    def test_mixed_definitions_one_batch(self):
        tables = compile_tables([exe_one_task(), exe_fork_join()])
        dt = DeviceTables.from_numpy(tables, device="cpu")
        def_of = np.array([0, 1] * 8, np.int32)
        state = make_state(tables, 16, def_of, token_capacity=64, device="cpu")
        final, _ = run_to_completion(dt, state)
        assert bool(final["done"].all())
        assert int(final["jobs_created"]) == 8 * 1 + 8 * 2


class TestExternalJobs:
    def test_host_driven_job_completion(self):
        tables = compile_tables([exe_one_task()])
        dt = DeviceTables.from_numpy(tables, device="cpu")
        state = make_state(tables, 4, np.zeros(4, np.int32), device="cpu")
        # run without auto jobs: tokens park at the task
        for _ in range(5):
            state, _ = step(dt, state, auto_jobs=False)
        waiting = np.asarray((state["phase"] == PHASE_WAIT) & (state["elem"] >= 0))
        assert waiting.sum() == 4
        assert not bool(np.asarray(state["done"]).any())
        # host completes two jobs
        token_slots = np.nonzero(waiting)[0][:2]
        state = complete_jobs(state, token_slots)
        for _ in range(5):
            state, _ = step(dt, state, auto_jobs=False)
        assert int(np.asarray(state["done"]).sum()) == 2


class TestEngineParity:
    """Per-instance event sequences from the kernel must equal the sequential
    engine's event stream for the same scenario."""

    def _device_sequences(self, exe, n, slots_init=None, token_capacity=None):
        tables = compile_tables([exe])
        dt = DeviceTables.from_numpy(tables, device="cpu")
        state = make_state(
            tables, n, np.zeros(n, np.int32), initial_slots=slots_init,
            token_capacity=token_capacity,
        device="cpu")
        _, sequences = run_with_events(dt, tables, state)
        return sequences

    def test_one_task_parity(self, tmp_path):
        harness = EngineHarness(tmp_path, device="cpu")
        harness.deploy(
            Bpmn.create_executable_process("one_task")
            .start_event("start")
            .service_task("task", job_type="work")
            .end_event("end")
            .done()
        )
        pi = harness.create_instance("one_task")
        jobs = harness.activate_jobs("work")
        harness.complete_job(jobs[0]["key"])
        engine_seq = engine_intent_sequence(harness.exporter, pi)
        device_seq = self._device_sequences(exe_one_task(), 1)[0]
        # engine emits the process element's ACTIVATING/ACTIVATED first;
        # the kernel starts at the start event (host wraps instance creation)
        engine_core = [e for e in engine_seq if e[0] != "one_task"]
        device_core = [e for e in device_seq if e[0] != "one_task"]
        assert device_core == engine_core
        # and both agree the process completes at the end
        assert engine_seq[-1] == ("one_task", "ELEMENT_COMPLETED")
        assert device_seq[-1] == ("one_task", "ELEMENT_COMPLETED")

    def test_branching_parity_both_paths(self, tmp_path):
        for amount in (150, 10):
            harness = EngineHarness(tmp_path / f"a{amount}", device="cpu")
            harness.deploy(
                Bpmn.create_executable_process("branching")
                .start_event("start")
                .exclusive_gateway("gw")
                .sequence_flow_id("to_big")
                .condition_expression("amount >= 100")
                .service_task("big", job_type="big-order")
                .end_event("end_big")
                .move_to_element("gw")
                .sequence_flow_id("to_small")
                .default_flow()
                .service_task("small", job_type="small-order")
                .end_event("end_small")
                .done()
            )
            pi = harness.create_instance("branching", variables={"amount": amount})
            jtype = "big-order" if amount >= 100 else "small-order"
            jobs = harness.activate_jobs(jtype)
            harness.complete_job(jobs[0]["key"])
            engine_seq = [e for e in engine_intent_sequence(harness.exporter, pi) if e[0] != "branching"]

            exe = exe_branching()
            tables = compile_tables([exe])
            slots = np.zeros((1, tables.num_slots), np.float32)
            slots[0, tables.slot_map.names["amount"]] = amount
            device_seq = [
                e for e in self._device_sequences(exe, 1, slots_init=slots)[0]
                if e[0] != "branching"
            ]
            assert device_seq == engine_seq, f"amount={amount}"
            harness.close()

    def test_fork_join_parity_per_element(self, tmp_path):
        """Parallel branches interleave differently (engine: log order;
        kernel: lock-step), so compare per-element subsequences and totals."""
        harness = EngineHarness(tmp_path, device="cpu")
        harness.deploy(
            Bpmn.create_executable_process("fj")
            .start_event("s")
            .parallel_gateway("fork")
            .service_task("a", job_type="a")
            .parallel_gateway("join")
            .end_event("e")
            .move_to_element("fork")
            .service_task("b", job_type="b")
            .connect_to("join")
            .done()
        )
        pi = harness.create_instance("fj")
        for jtype in ("a", "b"):
            jobs = harness.activate_jobs(jtype)
            harness.complete_job(jobs[0]["key"])
        engine_seq = engine_intent_sequence(harness.exporter, pi)
        device_seq = self._device_sequences(exe_fork_join(), 1, token_capacity=8)[0]

        def by_element(seq):
            out = {}
            for elem, intent in seq:
                out.setdefault(elem, []).append(intent)
            return out

        # instance creation (the process element's activation) is host-wrapped
        # in the kernel design; compare everything below the process scope
        engine_by_el = by_element(e for e in engine_seq if e[0] != "fj")
        device_by_el = by_element(e for e in device_seq if e[0] != "fj")
        assert engine_by_el == device_by_el
        assert engine_seq[-1] == ("fj", "ELEMENT_COMPLETED")
        assert device_seq[-1] == ("fj", "ELEMENT_COMPLETED")
        harness.close()


class TestSharding:
    def test_sharded_matches_single_device(self):
        import jax

        from zeebe_tpu_torch.parallel.mesh import make_mesh, make_sharded_step, shard_state

        n = min(8, len(jax.devices()))
        tables = compile_tables([exe_fork_join()])
        dt = DeviceTables.from_numpy(tables, device="cpu")

        ref_state = make_state(tables, 64, np.zeros(64, np.int32), token_capacity=256, device="cpu")
        ref, _ = run_to_completion(dt, ref_state)

        mesh = make_mesh(n, device="cpu")
        state = make_state(
            tables, 64, np.zeros(64, np.int32), token_capacity=256, num_shards=n
        , device="cpu")
        state = shard_state(state, mesh)
        sharded_step = make_sharded_step(mesh)
        for _ in range(12):
            state = sharded_step(dt, state)
        assert bool(np.asarray(state["done"]).all())
        assert int(state["transitions"]) == int(ref["transitions"])
        assert int(state["completed"]) == int(ref["completed"])


class TestConditionVmRegressions:
    def test_not_condition_evaluates_at_runtime(self):
        """Regression: OP_NOT was misclassified as a binary op (opcode range
        overlap) making every not(...) condition evaluate to False."""
        exe = transform(
            Bpmn.create_executable_process("neg")
            .start_event("s")
            .exclusive_gateway("gw")
            .sequence_flow_id("low")
            .condition_expression("not(x > 10)")
            .service_task("low_task", job_type="low")
            .end_event("e1")
            .move_to_element("gw")
            .default_flow()
            .service_task("high_task", job_type="high")
            .end_event("e2")
            .done()
        )
        tables = compile_tables([exe])
        dt = DeviceTables.from_numpy(tables, device="cpu")
        slots = np.zeros((2, tables.num_slots), np.float32)
        slots[:, tables.slot_map.names["x"]] = [5, 50]
        state = make_state(tables, 2, np.zeros(2, np.int32), initial_slots=slots, device="cpu")
        _, sequences = run_with_events(dt, tables, state)
        # x=5 → not(5>10)=True → low path; x=50 → default → high path
        assert ("low_task", "JOB_CREATED") in sequences[0]
        assert ("high_task", "JOB_CREATED") in sequences[1]


class TestSlotPlaneCoercion:
    def test_int64_prepacked_planes_coerce(self):
        """Python-int plane tuples build int64 arrays on Linux; they must
        coerce to int32 planes, not fall into the float packer (which would
        reinterpret plane integers as float values)."""
        from zeebe_tpu_torch.ops import automaton
        from zeebe_tpu_torch.ops.tables import f64_key_planes

        exe = transform(
            Bpmn.create_executable_process("coerce")
            .start_event("s")
            .exclusive_gateway("gw")
            .condition_expression("x > 5")
            .end_event("hi")
            .move_to_element("gw")
            .default_flow()
            .end_event("lo")
            .done()
        )
        tables = compile_tables([exe])
        planes = [[list(f64_key_planes(9.0))]]  # int64 when np.asarray'd
        import numpy as np

        assert np.asarray(planes).dtype != np.int32  # the trap being tested
        state = automaton.make_state(tables, 1, np.zeros(1, np.int32),
                                     initial_slots=planes, device="cpu")
        dt = automaton.DeviceTables.from_numpy(tables, device="cpu")
        state, _ = automaton.run_to_completion(dt, state)
        # x = 9 > 5 routes to "hi": exactly one pass through element "hi"
        assert int(state["completed"]) == 1

    def test_float_planes_rejected(self):
        import numpy as np
        import pytest as _pytest

        from zeebe_tpu_torch.ops.automaton import _coerce_slot_planes

        with _pytest.raises(ValueError):
            _coerce_slot_planes(np.zeros((1, 1, 2), np.float64))
        with _pytest.raises(ValueError):
            _coerce_slot_planes(np.zeros((1, 1, 3), np.int64))
