"""Random process graphs and decision tables for the port's conformance
checks, on the CPU and on the card.

The generator is the reference suite's own: ``_Gen``, ``_random_vars``,
the drive loop ``_drive`` and the log fingerprint ``_fingerprint`` of
``tests/test_randomized_parity.py``, and the decision tables of
``tests/test_dmn.py``. They are copied here (the runs between the
``# copied from the reference`` lines, written by ``python
zeebe_tpu_torch/testing/copies.py``) because neither the port nor
``chip_smoke.py`` imports the reference's tests; the drive loop's one
``pytest.fail`` raises ``AssertionError`` here. ``_random_table_xml`` is
the random decision-table generator of ``tests/test_torch_decision.py``
and ``INTERVALS_DMN`` the interval table of
``tests/test_device_decision.py``; ``tests/test_torch_random_graphs.py``
holds all of them to their sources' text.

Around them, the port's own helpers build what the kernels take:

- ``build_seed`` builds a seed's graph as the reference's ``_run_one``
  does (its process id, instance count and variables);
- ``seed_registry`` registers seeds' definitions, one each, in a
  ``KernelRegistry``: its shared table set is compiled with the host
  escape the kernel backend uses (``compile_tables(..., host_idxs=...)``),
  so every seed yields tables and ``K_HOST`` elements reach the kernels;
- ``group_arrays`` and ``shard_arrays`` make a fresh group's state, and a
  block of shards' state, as numpy from a seed;
- ``decision_cases`` lists decision tables with contexts, and
  ``host_result`` gives the host ``DecisionEngine``'s answer for one
  context in ``batch_evaluate``'s form.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import random

import numpy as np
import torch

from zeebe_tpu_torch.dmn import DecisionEngine, parse_dmn_xml
from zeebe_tpu_torch.engine.kernel_backend import CHUNK_STEPS, KernelBackend, KernelRegistry
from zeebe_tpu_torch.engine.kernel_backend import parked_jobs as kb_parked_jobs
from zeebe_tpu_torch.ops import automaton as A
from zeebe_tpu_torch.ops import kernels
from zeebe_tpu_torch.parallel import mesh as M
from zeebe_tpu_torch.parallel import mesh_runner as MR
from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
from zeebe_tpu_torch.ops.tables import K_HOST, K_MI, f64_key_planes
from zeebe_tpu_torch.testing import EngineHarness
from zeebe_tpu_torch.testing.catalog import ProcessCatalog

# copied from the reference: VAR_NAMES .. _fingerprint
VAR_NAMES = ("x", "y", "z")
JOB_TYPES = ("alpha", "beta", "gamma", "delta")


class _Gen:
    """Random series-parallel process generator over the fluent builder."""

    def __init__(self, rng: random.Random, pid: str) -> None:
        self.rng = rng
        self.n = 0
        self.pid = pid
        self.job_types_used: set[str] = set()
        self.has_no_default_gateway = False
        self.has_timers = False
        self.messages: set[str] = set()
        self.signals: set[str] = set()

    def next_id(self, prefix: str) -> str:
        self.n += 1
        return f"{prefix}{self.n}"

    STR_VALUES = ("new", "active", "done", "weird")

    def condition(self) -> str:
        rng = self.rng
        if rng.random() < 0.3:
            # string routing rides the kernel via interned ids; values the
            # tables never saw and non-string runtime values exercise the
            # unknown-id sentinel and the host fallback respectively
            return f'status {rng.choice(("=", "!="))} "{rng.choice(self.STR_VALUES)}"'
        var = rng.choice(VAR_NAMES)
        op = rng.choice((">", ">=", "<", "<=", "=", "!="))
        const = rng.randint(0, 20)
        expr = f"{var} {op} {const}"
        if rng.random() < 0.2:
            var2 = rng.choice(VAR_NAMES)
            joiner = rng.choice(("and", "or"))
            expr = f"{expr} {joiner} {var2} {rng.choice(('>', '<'))} {rng.randint(0, 20)}"
        return expr

    def block(self, b, depth: int):
        """Append one random block after the cursor; leaves the cursor at the
        block's last element."""
        rng = self.rng
        if depth >= 3:
            return self.task(b)
        roll = rng.random()
        if roll < 0.34:
            return self.task(b)
        if roll < 0.38:
            return self.link_jump(b)
        if roll < 0.46:
            return self.catch_event(b)
        if roll < 0.56:
            b = self.block(b, depth + 1)
            return self.block(b, depth + 1)
        if roll < 0.66:
            return self.subprocess(b, depth)
        if roll < 0.73:
            return self.event_gateway(b, depth)
        if roll < 0.83:
            return self.exclusive(b, depth)
        if roll < 0.91:
            return self.inclusive(b, depth)
        return self.parallel(b, depth)

    def event_gateway(self, b, depth: int):
        """Event-based gateway racing a timer against a message; branches
        merge so the enclosing block can continue."""
        gw = self.next_id("evg")
        merge = self.next_id("evm")
        self.has_timers = True
        name = f"msg_{self.next_id('em')}"
        self.messages.add(name)
        b = b.event_based_gateway(gw)
        b = b.intermediate_catch_timer(self.next_id("et"), duration="PT5S")
        b = self.block(b, depth + 1)
        b = b.exclusive_gateway(merge)
        b = b.move_to_element(gw)
        b = b.intermediate_catch_message(self.next_id("ec"), name,
                                         correlation_key="mkey")
        b = self.block(b, depth + 1)
        b = b.connect_to(merge)
        return b.move_to_element(merge)

    def subprocess(self, b, depth: int):
        sid = self.next_id("sub")
        b = b.sub_process(sid)
        b = b.start_event(self.next_id("ss"))
        b = self.block(b, depth + 1)
        b = b.end_event(self.next_id("se"))
        return b.sub_process_done()

    def link_jump(self, b):
        """A throw link jumping to its same-scope catch (round-5 shape):
        rides the kernel as a synthetic K_PASS edge with no sequence flow."""
        name = self.next_id("lnk")
        b = b.intermediate_throw_link(self.next_id("lt"), name)
        return b.intermediate_catch_link(self.next_id("lc"), name)

    def catch_event(self, b):
        """A timer, message, or signal intermediate catch (all ride the
        kernel's K_CATCH park path; resumes differ per kind)."""
        roll = self.rng.random()
        if roll < 0.4:
            self.has_timers = True
            return b.intermediate_catch_timer(self.next_id("timer"), duration="PT5S")
        if roll < 0.6:
            name = f"sig_{self.next_id('sg')}"
            self.signals.add(name)
            return b.intermediate_catch_signal(self.next_id("scatch"), name)
        name = f"msg_{self.next_id('m')}"
        self.messages.add(name)
        return b.intermediate_catch_message(self.next_id("catch"), name,
                                            correlation_key="mkey")

    def task(self, b):
        job_type = self.rng.choice(JOB_TYPES)
        self.job_types_used.add(job_type)
        tid = self.next_id("task")
        b = b.service_task(tid, job_type=job_type)
        roll = self.rng.random()
        if roll < 0.12:
            # multi-instance tasks host-escape (K_HOST): the device parks at
            # them and the sequential engine fans out over `items`
            b = b.multi_instance(input_collection="= items",
                                 input_element="item",
                                 sequential=self.rng.random() < 0.4)
        elif roll < 0.34:
            b = self.boundary(b, tid)
        return b

    def boundary(self, b, tid: str):
        """Attach a timer or message boundary (interrupting or not) with its
        own continuation branch; triggers route through the sequential path
        while the parked task stays kernel-reconstructable."""
        rng = self.rng
        bid = self.next_id("bnd")
        interrupting = rng.random() < 0.5
        kind = rng.random()
        if kind < 0.4:
            self.has_timers = True
            b = b.boundary_timer(bid, attached_to=tid, duration="PT5S",
                                 interrupting=interrupting)
        elif kind < 0.75:
            name = f"msg_{self.next_id('bm')}"
            self.messages.add(name)
            b = b.boundary_message(bid, attached_to=tid, message_name=name,
                                   correlation_key="mkey",
                                   interrupting=interrupting)
        else:
            # round-5 eligibility: signal boundaries count in the
            # reconstruction integrity check like timers/messages
            name = f"sig_{self.next_id('bs')}"
            self.signals.add(name)
            b = b.boundary_signal(bid, attached_to=tid, signal_name=name,
                                  interrupting=interrupting)
        b = self.task(b)
        b = b.end_event(self.next_id("be"))
        return b.move_to_element(tid)

    def exclusive(self, b, depth: int):
        rng = self.rng
        gw = self.next_id("gw")
        merge = self.next_id("merge")
        b = b.exclusive_gateway(gw)
        branches = rng.randint(2, 3)
        # branch 0 creates the merge gateway inline
        b = b.condition_expression(self.condition())
        b = self.block(b, depth + 1)
        b = b.exclusive_gateway(merge)
        for i in range(1, branches):
            b = b.move_to_element(gw)
            if i == branches - 1:
                if rng.random() < 0.05:
                    # rare: no default → possible CONDITION_ERROR incident;
                    # the instance then never completes, which is fine — the
                    # logs must still match
                    b = b.condition_expression(self.condition())
                    self.has_no_default_gateway = True
                else:
                    b = b.default_flow()
            else:
                b = b.condition_expression(self.condition())
            b = self.block(b, depth + 1)
            b = b.connect_to(merge)
        return b.move_to_element(merge)

    def inclusive(self, b, depth: int):
        """Inclusive fork (fork-only, like the reference): side branches with
        conditions end in their own end events; the default rides a side
        branch and the MAIN continuation is a conditional branch — when its
        condition is false the instance still completes through the sides."""
        rng = self.rng
        gw = self.next_id("igw")
        b = b.inclusive_gateway(gw)
        for i in range(rng.randint(1, 2)):
            if i == 0:
                b = b.default_flow()
            else:
                b = b.condition_expression(self.condition())
            b = self.block(b, depth + 1)
            b = b.end_event(self.next_id("ie"))
            b = b.move_to_element(gw)
        return b.condition_expression(self.condition())

    def parallel(self, b, depth: int):
        rng = self.rng
        fork = self.next_id("fork")
        join = self.next_id("join")
        b = b.parallel_gateway(fork)
        branches = rng.randint(2, 3)
        b = self.block(b, depth + 1)
        b = b.parallel_gateway(join)
        for _ in range(1, branches):
            b = b.move_to_element(fork)
            b = self.block(b, depth + 1)
            b = b.connect_to(join)
        return b.move_to_element(join)

    def build(self):
        b = Bpmn.create_executable_process(self.pid).start_event("start")
        b = self.block(b, 0)
        return b.end_event("end").done()


def _random_vars(rng: random.Random, constant: bool = False) -> dict:
    if constant:
        # identical variables per instance → burst-template fingerprints
        # collide → the production fast path actually serves (see _run_one);
        # a constant string keeps string-condition graphs kernel-admissible
        return {"x": 7, "y": 3, "z": 11, "status": "active", "items": [1, 2]}
    variables = {name: rng.randint(0, 20) for name in VAR_NAMES if rng.random() < 0.8}
    # multi-instance input collection (host-escaped elements); sometimes a
    # non-list to exercise the EXTRACT_VALUE_ERROR incident path
    variables["items"] = (
        list(range(rng.randint(0, 3))) if rng.random() < 0.9 else 7
    )
    roll = rng.random()
    if roll < 0.7:
        variables["status"] = rng.choice(_Gen.STR_VALUES + ("unseen-value",))
    elif roll < 0.8:
        variables["status"] = rng.randint(0, 5)  # type mismatch → host path
    # else: absent → host path (null vs string comparisons)
    return variables


def _drive(h: EngineHarness, gen: "_Gen", model, rng: random.Random,
           instances: int, constant_vars: bool = False) -> None:
    h.deploy(model)
    for i in range(instances):
        variables = _random_vars(rng, constant_vars)
        if gen.messages:
            # per-instance correlation key — only when the graph has message
            # catches (it breaks the fingerprint collision the constant-vars
            # fast-path seeds rely on)
            variables["mkey"] = f"ck{i}"
        h.create_instance(gen.pid, variables=variables)
    # run all jobs/timers/messages to exhaustion; completion payloads are
    # keyed off the job key so all runs (whose logs must be position/key-
    # identical anyway) derive the same values
    idle_rounds = 0
    for _ in range(64):
        worked = 0
        for job_type in sorted(gen.job_types_used):
            for job in h.activate_jobs(job_type, max_jobs=50):
                variables = {}
                if job["key"] % 3 == 0:
                    variables[VAR_NAMES[job["key"] % len(VAR_NAMES)]] = job["key"] % 23
                h.complete_job(job["key"], variables or None)
                worked += 1
        # broadcast each signal repeatedly within the round: chained catches
        # (catch → catch → …) advance one catch per broadcast, and a single
        # sweep would read as an idle round and abandon the tail. All runs
        # issue the identical broadcast sequence, so parity is unaffected.
        for _ in range(3):
            for name in sorted(gen.signals):
                h.broadcast_signal(name)
        # publish before advancing time so message-vs-timer races (event-based
        # gateways) can go either way instead of the timer always winning
        for name in sorted(gen.messages):
            for i in range(instances):
                # message_id dedupes republication across drive rounds
                h.publish_message(name, f"ck{i}", message_id=f"{name}-ck{i}",
                                  request_id=13)
        if gen.has_timers:
            h.advance_time(6_000)
        # timers/messages may unlock work only on the NEXT round — stop after
        # two consecutive rounds with nothing to do
        idle_rounds = idle_rounds + 1 if worked == 0 else 0
        if idle_rounds >= 2:
            break
    else:
        raise AssertionError("job drive loop did not quiesce")


def _fingerprint(h: EngineHarness) -> list:
    out = []
    for logged in h.stream.new_reader(1):
        rec = logged.record
        out.append((
            logged.position,
            logged.source_position,
            logged.processed,
            rec.key,
            rec.record_type.name,
            rec.value_type.name,
            int(rec.intent),
            rec.rejection_type.name if rec.is_rejection else "",
            dict(rec.value) if rec.value else {},
        ))
    return out
# end of the copy

# copied from the reference: DISH_DMN .. COLLECT_DMN
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
# end of the copy

INTERVALS_DMN = """<?xml version="1.0" encoding="UTF-8"?>
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


# ---------------------------------------------------------------------------
# process graphs

#: the generator's seeds, as the reference suite runs them
SEEDS = range(120)


@dataclasses.dataclass
class Seed:
    """One seed's graph as the reference's ``_run_one`` builds it: the
    generator after ``build`` (its job types, messages, signals and timers),
    the model, and the instance count drawn after it."""

    seed: int
    gen: _Gen
    model: object
    instances: int

    @property
    def xml(self) -> str:
        return to_bpmn_xml(self.model)

    @property
    def constant_vars(self) -> bool:
        """Every fourth seed drives with constant variables (burst templates)."""
        return self.seed % 4 == 0

    def drive(self, harness: EngineHarness) -> None:
        """Deploy and drive the seed's instances to quiescence on ``harness``,
        as ``_run_one`` drives each of its runs."""
        _drive(harness, self.gen, self.model, random.Random(self.seed + 1), self.instances,
               self.constant_vars)


def build_seed(seed: int) -> Seed:
    rng = random.Random(seed)
    gen = _Gen(rng, f"rand_{seed}")
    model = gen.build()
    return Seed(seed, gen, model, rng.randint(1, 3))


def spread(n: int) -> list[int]:
    """``n`` (at least 2) of the seeds, spread evenly, the first and last
    included."""
    last = len(SEEDS) - 1
    return [SEEDS[round(k * last / (n - 1))] for k in range(n)]


def seed_registry(seeds) -> KernelRegistry:
    """A registry holding each seed's definition, in order (definition k is
    ``seeds[k]``); raises if the registry declines one."""
    seeds = list(seeds)
    registry = KernelRegistry()
    infos = ProcessCatalog.from_xml([build_seed(s).xml for s in seeds]).register(registry)
    declined = [s for s, info in zip(seeds, infos) if info is None]
    if declined:
        raise ValueError(f"the kernel registry declined seeds {declined}: "
                         f"{registry._ineligible}")
    return registry


def host_escapes(tables) -> int:
    """Elements of the table set that escape to the host (``K_HOST``)."""
    return int((tables.kernel_op == K_HOST).sum())


def token_capacity(tables, I: int) -> int:
    """The serving group rule: a power of two of at least 8 holding
    ``token_width`` tokens per instance (4 per instance when the width is 0)."""
    w = tables.token_width
    return KernelBackend._pow2(w * I if w > 0 else 4 * I)


def slot_planes(tables, I: int, rng: np.random.Generator) -> np.ndarray:
    """Seeded per-instance condition slots as (hi, lo) planes: numeric slots
    hold integers around the generator's constants (0..20), string slots an
    interned literal's key or an unknown string's."""
    planes = np.zeros((I, tables.num_slots, 2), np.int32)
    name_of = {v: k for k, v in tables.slot_map.names.items()}
    n_lit = max(1, len(tables.interner.ids))
    for s in range(tables.num_slots):
        if tables.slot_map.kinds.get(name_of.get(s)) == "str":
            planes[:, s, 0] = rng.integers(-1, 2 * n_lit + 1, I)
        else:
            planes[:, s] = [f64_key_planes(float(v)) for v in rng.integers(-3, 24, I)]
    return planes


def group_arrays(tables, I: int, T: int, rng: np.random.Generator,
                 definitions=None) -> dict:
    """A fresh group of I instances as numpy: one token each at its start
    event, definitions drawn from ``definitions`` (every one by default),
    seeded condition slots, 1–3 iterations left on each multi-instance body
    row, counters 0-d."""
    pool = np.arange(tables.num_definitions) if definitions is None else np.asarray(definitions)
    E = tables.max_elements
    def_of = pool[rng.integers(0, len(pool), I)].astype(np.int32)
    elem = np.full(T, -1, np.int32)
    inst = np.zeros(T, np.int32)
    elem[:I] = tables.start_elem[def_of]
    inst[:I] = np.arange(I)
    mi_left = np.zeros((I, E), np.int32)
    mi_rows = tables.kernel_op[def_of] == K_MI
    mi_left[mi_rows] = rng.integers(1, 4, int(mi_rows.sum()))
    return {
        "elem": elem, "phase": np.zeros(T, np.int32), "inst": inst, "def_of": def_of,
        "var_slots": slot_planes(tables, I, rng), "join_counts": np.zeros((I, E), np.int32),
        "mi_left": mi_left, "done": np.zeros(I, np.bool_), "incident": np.zeros(I, np.bool_),
        "transitions": np.zeros((), np.int32), "jobs_created": np.zeros((), np.int32),
        "completed": np.zeros((), np.int32), "overflow": np.zeros((), np.bool_),
    }


def shard_arrays(tables, I: int, T: int, rng: np.random.Generator,
                 per_shard_counters: bool) -> dict:
    """One block of shards as numpy, shard s a group of I instances of
    definition s (``tables`` holds one definition per shard, as
    ``seed_registry`` builds it), shard-block aligned; counters per-shard
    rows (the sharded collect's) or 0-d (the sharded step's)."""
    n = tables.num_definitions
    blocks = [group_arrays(tables, I, T, rng, [s]) for s in range(n)]
    out = {k: np.concatenate([b[k] for b in blocks]) for k in M._SHARDED_KEYS}
    for k in M._REPLICATED_KEYS:
        dtype = np.bool_ if k == "overflow" else np.int32
        out[k] = np.zeros(n if per_shard_counters else (), dtype)
    return out


def seed_group(seed: int, I: int, device):
    """A seed's tables (``seed_registry``), their device copy and a fresh
    group of I instances on ``device`` (T by the group rule, the state
    drawn from the seed)."""
    tables = seed_registry([seed]).tables
    T = token_capacity(tables, I)
    arrays = group_arrays(tables, I, T, np.random.default_rng(seed))
    return tables, A.DeviceTables.from_numpy(tables, device), A.state_from_numpy(arrays, device)


def shard_block(seeds, I: int, device, seed: int):
    """Seeds as shards, one definition each: the tables, their device copy,
    and a block of I instances a shard on ``device`` twice, with per-shard
    counter rows (the sharded collect's) and with 0-d counters (the sharded
    step's), drawn from ``seed``."""
    tables = seed_registry(seeds).tables
    T = token_capacity(tables, I)
    rng = np.random.default_rng(seed)
    states = [A.state_from_numpy(shard_arrays(tables, I, T, rng, rows), device)
              for rows in (True, False)]
    return tables, A.DeviceTables.from_numpy(tables, device), *states


# ---------------------------------------------------------------------------
# every kernel path against the plain version (on the card)


def max_abs_err(a: dict, b: dict) -> int:
    """Largest absolute difference over every tensor of two result dicts
    (int64, so int32 extremes cannot overflow); 0 means byte-equal here. A
    shape that differs raises."""
    worst = 0
    for k in a:
        x, y = a[k].long(), b[k].long()
        if x.shape != y.shape:
            raise AssertionError(f"{k}: shape {tuple(x.shape)} vs {tuple(y.shape)}")
        if x.numel():
            worst = max(worst, int((x - y).abs().max()))
    return worst


def _check(label: str, *pairs) -> None:
    """Raise unless each pair of result dicts is byte-equal."""
    err = max(max_abs_err(a, b) for a, b in pairs)
    if err:
        raise AssertionError(f"{label}: differs from the plain version (max abs err {err})")


def collect_paths(dt, tables, state: dict, config, chunks: int, label: str) -> dict:
    """``run_collect`` chunk by chunk with job waves on the fused chunk (one
    grid launch a chunk), the forced chain and the plain version, from the
    same state; packed rows and state byte-equal at every chunk, or it
    raises. Returns the chunks and lock-steps compared, the chunks that
    went quiet before their last step and the jobs completed."""
    n_steps = CHUNK_STEPS
    out = {"chunks": 0, "steps": 0, "quiet_early": 0, "jobs": 0}
    ks = cs = ps = state
    for chunk in range(chunks):
        A.reset_launch_counts()
        ks, krows = A.run_collect(dt, ks, n_steps=n_steps, config=config)
        if A.grid_launch_counts() != {"fused": 1, "chain": 0, "combine": 0, "grid": 0}:
            raise AssertionError(f"{label}: run_collect was not one fused launch")
        cs, crows = kernels.run_steps(dt, cs, n_steps, config, auto_jobs=False,
                                      emit_events=True, mode="collect", path="chain")
        ps, prows = A.run_collect_plain(dt, ps, n_steps=n_steps, config=config)
        _check(f"{label} chunk {chunk}", ({"rows": krows}, {"rows": prows}), (ks, ps),
               ({"rows": crows}, {"rows": prows}), (cs, ps))
        quiet = torch.nonzero(prows[:, -2] == 0).flatten()
        ran = int(quiet[0]) + 1 if quiet.numel() else n_steps
        out["chunks"] += 1
        out["steps"] += ran
        out["quiet_early"] += ran < n_steps
        jobs = kb_parked_jobs(tables, ks)
        if jobs.size == 0 and quiet.numel():
            break
        if jobs.size:
            ks, cs, ps = (A.complete_jobs(x, jobs) for x in (ks, cs, ps))
            out["jobs"] += int(jobs.size)
    return out


def completion_paths(dt, state: dict, config, max_steps: int, label: str) -> dict:
    """``run_to_completion`` on the grid kernel (one launch a call) and the
    plain version, with auto jobs on and off; state and steps byte-equal,
    or it raises. Returns the runs and steps compared."""
    out = {"runs": 0, "steps": 0}
    for auto_jobs in (True, False):
        A.reset_launch_counts()
        kf, ksteps = A.run_to_completion(dt, state, max_steps=max_steps, auto_jobs=auto_jobs,
                                         config=config)
        if A.grid_launch_counts()["grid"] != 1:
            raise AssertionError(f"{label}: run_to_completion was not one grid launch")
        pf, psteps = A.run_to_completion_plain(dt, state, max_steps=max_steps,
                                               auto_jobs=auto_jobs, config=config)
        _check(f"{label} auto_jobs={auto_jobs}", (kf, pf),
               ({"steps": ksteps}, {"steps": psteps}))
        out["runs"] += 1
        out["steps"] += int(psteps)
    return out


def sharded_paths(dt, tables, collect_state: dict, step_state: dict, config, layouts: dict,
                  chunks: int, steps: int, label: str) -> dict:
    """The sharded collect (chunk by chunk with job waves) and the sharded
    step (auto jobs, ``steps`` lock-steps) on every mesh of ``layouts``
    (name → its devices: one launch group each), each chunk and step from
    the plain version's state; rows and states byte-equal to
    ``sharded_collect_plain`` and ``sharded_step_plain``, or it raises.
    ``collect_state`` has per-shard counter rows, ``step_state`` 0-d
    counters. Returns the chunks and lock-steps compared per layout."""
    n = tables.num_definitions
    T = collect_state["elem"].shape[0] // n
    meshes = {name: M.make_mesh(n, devices=devices) for name, devices in layouts.items()}
    collects = {name: MR.MeshKernelRunner(mesh=mesh)._sharded_collect(CHUNK_STEPS, config)
                for name, mesh in meshes.items()}
    stepping = {name: M.make_sharded_step(mesh, auto_jobs=True, config=config)
                for name, mesh in meshes.items()}
    dts = {name: (dt if len(mesh.groups) == 1 else tuple(dt.to(d) for d in mesh.devices))
           for name, mesh in meshes.items()}
    out = {"chunks": 0, "steps": 0}
    ps = collect_state
    for chunk in range(chunks):
        nxt, prows = MR.sharded_collect_plain(dt, ps, CHUNK_STEPS, n, config)
        for name, mesh in meshes.items():
            kstate, krows = collects[name](dts[name], M.shard_state(ps, mesh))
            if isinstance(krows, tuple):
                krows = torch.cat([r.to(prows.device) for r in krows], 1)
            _check(f"{label} {name} collect chunk {chunk}", ({"rows": krows}, {"rows": prows}),
                   (M.gather_state(kstate), M.gather_state(nxt)))
        out["chunks"] += 1
        ps = nxt
        jobs = []
        for s in range(n):
            block = {k: ps[k].chunk(n)[s] for k in ("elem", "phase", "inst", "def_of")}
            jobs += (s * T + kb_parked_jobs(tables, block)).tolist()
        quiet = bool((prows.view(CHUNK_STEPS, n, -1)[:, :, -2] == 0).any(0).all())
        if not jobs and quiet:
            break
        if jobs:
            ps = A.complete_jobs(ps, jobs)
    ps = step_state
    for k in range(steps):
        nxt = M.sharded_step_plain(dt, ps, n, True, config)
        for name, mesh in meshes.items():
            kstate = stepping[name](dt, M.shard_state(ps, mesh))
            _check(f"{label} {name} step {k}", (M.gather_state(kstate), M.gather_state(nxt)))
        out["steps"] += 1
        ps = nxt
    return out


# ---------------------------------------------------------------------------
# decision tables


@dataclasses.dataclass
class DecisionCase:
    """A decision table (its DMN XML and decision id) with contexts."""

    label: str
    xml: str
    decision_id: str
    contexts: list

    @functools.cached_property
    def drg(self):
        return parse_dmn_xml(self.xml)

    @property
    def decision(self):
        return self.drg.decisions[self.decision_id]


def _random_contexts(rng: random.Random, n: int) -> list[dict]:
    """The reference suite's random contexts: an integer ``a``; ``b`` an
    integer, a float or null."""
    return [{"a": rng.randint(-6, 16),
             "b": rng.choice((rng.randint(-6, 16), rng.random() * 20 - 5, None))}
            for _ in range(n)]


#: hit policies of the random tables, by seed: every one whose result the
#: host engine gives for any context (ANY fails there on differing outputs)
RANDOM_POLICIES = ("FIRST", "UNIQUE", "RULE ORDER", "COLLECT", 'COLLECT" aggregation="SUM',
                   'COLLECT" aggregation="MIN', 'COLLECT" aggregation="MAX',
                   'COLLECT" aggregation="COUNT')


def random_case(seed: int, n_contexts: int) -> DecisionCase:
    """Random table ``seed`` of the reference suite's generator under the hit
    policy ``RANDOM_POLICIES`` gives it in turn, with ``n_contexts``
    contexts drawn from the same seed."""
    hit = RANDOM_POLICIES[seed % len(RANDOM_POLICIES)]
    return DecisionCase(f"random {seed} {hit}", _random_table_xml(seed, hit), "rt",
                        _random_contexts(random.Random(seed), n_contexts))


def decision_cases(n_random: int = 50, n_contexts: int = 64) -> list:
    """``n_random`` random tables (``random_case`` of seeds 0..) and the
    device-decision suite's own tables (the dish table, its one-ulp boundary
    variant at 8.5, the collect table under every aggregation and in rule
    order, the interval table), each with ``n_contexts`` seeded contexts."""
    rng = random.Random(0)
    cases = [random_case(s, n_contexts) for s in range(n_random)]
    seasons = ("Winter", "Summer", "Autumn", None)
    guests = [8, 9, 2, 8.5, math.nextafter(8.5, 9), math.nextafter(8.5, 0),
              8.499999999999999, None]
    dish = [{"season": rng.choice(seasons), "guestCount": rng.choice(guests + [rng.random() * 20])}
            for _ in range(n_contexts)]
    dish = [{k: v for k, v in ctx.items() if v is not None} for ctx in dish]
    cases.append(DecisionCase("dish", DISH_DMN, "dish", dish))
    ulp = DISH_DMN.replace("&lt;= 8", "&lt;= 8.5").replace("&gt; 8", "&gt; 8.5")
    cases.append(DecisionCase("dish at 8.5", ulp, "dish", dish))
    members = [{"membership": m} if m else {} for m in
               (rng.choice(("gold", "silver", "x", None)) for _ in range(n_contexts))]
    for agg in ("SUM", "MIN", "MAX", "COUNT"):
        xml = COLLECT_DMN.replace('aggregation="SUM"', f'aggregation="{agg}"')
        cases.append(DecisionCase(f"collect {agg}", xml, "fees", members))
    cases.append(DecisionCase("collect in rule order", COLLECT_DMN.replace(
        'hitPolicy="COLLECT" aggregation="SUM"', 'hitPolicy="RULE ORDER"'), "fees", members))
    xs = [0, 10, 10.0000001, 19.999, 20, 25, 30, 100, 99.999, -1]
    intervals = [{"x": v} for v in xs] + [{"x": rng.uniform(-5, 110)}
                                         for _ in range(n_contexts - len(xs))]
    cases.append(DecisionCase("intervals", INTERVALS_DMN, "iv", intervals))
    return cases


def host_matches(decision, ctx: dict) -> list[int]:
    """Matched rule indices per the host engine's unary tests."""
    values = [inp.expression.evaluate(ctx, lambda: 0) if inp.expression else None
              for inp in decision.inputs]
    return [r for r, rule in enumerate(decision.rules)
            if all(t(v, ctx) for t, v in zip(rule.tests, values))]


#: where the reference's batch path and its host engine disagree (ROADMAP C,
#: inherited): COLLECT COUNT with no rule matched is 0 in ``batch_evaluate``
#: (the JAX package's and the port's alike) and null in the host engine
INHERITED_COUNT = "COLLECT COUNT with no rule matched: batch_evaluate 0, host engine null"


def inherited(case: DecisionCase, ctx: dict, got, want) -> bool:
    """Whether ``got`` (batch_evaluate) differs from ``want`` (host_result)
    only as ``INHERITED_COUNT`` records."""
    return (case.decision.aggregation == "COUNT" and got == 0 and want is None
            and not host_matches(case.decision, ctx))


def check_against_host(case: DecisionCase, got: list) -> int:
    """Hold ``batch_evaluate``'s results for ``case.contexts`` against the
    host engine's; raises on any difference but ``INHERITED_COUNT``'s.
    Returns the contexts that differ only so."""
    seen = 0
    for ctx, g in zip(case.contexts, got, strict=True):
        want = host_result(case, ctx)
        if g != want:
            if not inherited(case, ctx, g, want):
                raise AssertionError(f"{case.label}: {ctx}: batch_evaluate {g!r}, "
                                     f"host engine {want!r}")
            seen += 1
    return seen


def host_result(case: DecisionCase, ctx: dict):
    """The host ``DecisionEngine``'s answer for ``ctx`` in ``batch_evaluate``'s
    form: an aggregation is the engine's output (None where it fails);
    otherwise the rule indices its unary tests match, under the table's hit
    policy (FIRST and ANY the first, UNIQUE the only one, RULE ORDER and
    COLLECT all of them)."""
    decision = case.decision
    if decision.aggregation:
        result = DecisionEngine().evaluate(case.drg, case.decision_id, ctx)
        return None if result.failed else result.output
    matches = host_matches(decision, ctx)
    if decision.hit_policy in ("RULE_ORDER", "COLLECT"):
        return matches
    if decision.hit_policy == "UNIQUE":
        return matches[0] if len(matches) == 1 else None
    return matches[0] if matches else None
