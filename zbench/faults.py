"""Faults planted underneath the timed path, for the checks that the judge
fails a broken run: the control (a guarantee of the configuration broken)
and the faults a cell of this system can have. No benchmark run plants
one; ``zbench/control.py`` and the tests do.

- ``control_ack_unwritten``: one create in ``EVERY`` is answered as created
  but never written, as a broker that acknowledges before the command is
  committed and then loses it (the configurations' guarantee: a command is
  answered only once it is committed on a quorum and processed);
- ``state_unchanged``: one job completion in ``EVERY`` is answered as
  completed and leaves the state as it was;
- ``half_left_out``: every kernel group keeps every other command and
  leaves the rest out;
- ``replica_skipped``: one follower replica of partition 1 skips one
  committed batch in ``EVERY`` (the exchange between brokers left out;
  only where a partition has a follower);
- ``answer_altered``: one create's answer in ``EVERY`` says another
  ``x`` than the command sent, altered where the answer is produced.
"""

from __future__ import annotations

import contextlib
import itertools
from unittest import mock

from zeebe_tpu_torch.broker.broker import resolve_leader_partition
from zeebe_tpu_torch.engine.kernel_backend import KernelBackend
from zeebe_tpu_torch.gateway import ClusterRuntime
from zeebe_tpu_torch.protocol import Record, RecordType, ValueType
from zeebe_tpu_torch.protocol.intent import (
    JobIntent,
    ProcessInstanceCreationIntent,
)

EVERY = 20
FAULTS = ("control_ack_unwritten", "state_unchanged", "half_left_out", "replica_skipped",
          "answer_altered")


def _every(n: int):
    counter = itertools.count(1)
    return lambda: next(counter) % n == 0


def _fake_answer(runtime_submit, value_type, intent_in, intent_out, value):
    hit = _every(EVERY)

    def submit(self, partition_id, record, timeout_s=10.0):
        if record.value_type == value_type and record.intent == intent_in and hit():
            return Record(RecordType.EVENT, value_type, intent_out, value(record),
                          key=record.key if record.key >= 0 else 1)
        return runtime_submit(self, partition_id, record, timeout_s)

    return mock.patch.object(ClusterRuntime, "submit", submit)


@contextlib.contextmanager
def plant(name: str | None):
    """Plant the fault ``name`` (None: none) for the runtimes built inside."""
    if name is None:
        yield None
        return
    if name == "control_ack_unwritten":
        with _fake_answer(ClusterRuntime.submit, ValueType.PROCESS_INSTANCE_CREATION,
                          ProcessInstanceCreationIntent.CREATE,
                          ProcessInstanceCreationIntent.CREATED,
                          lambda r: {**r.value, "version": 1}):
            yield None
    elif name == "state_unchanged":
        with _fake_answer(ClusterRuntime.submit, ValueType.JOB, JobIntent.COMPLETE,
                          JobIntent.COMPLETED, lambda r: {}):
            yield None
    elif name == "half_left_out":
        finish = KernelBackend.finish_group

        def finish_half(self, pending, builder_cls):
            cmds, builders = finish(self, pending, builder_cls)
            return cmds[::2], builders[::2]

        with mock.patch.object(KernelBackend, "finish_group", finish_half):
            yield None
    elif name == "replica_skipped":
        yield _skip_on_follower
    elif name == "answer_altered":
        resolve = ClusterRuntime._resolve_request
        hit = _every(EVERY)

        def altered(self, request_id, record):
            if (record.value_type == ValueType.PROCESS_INSTANCE_CREATION
                    and record.intent == ProcessInstanceCreationIntent.CREATED and hit()):
                x = record.value["variables"]["x"]
                record = record.replace(value=dict(record.value, variables={"x": x + 1}))
            resolve(self, request_id, record)

        with mock.patch.object(ClusterRuntime, "_resolve_request", altered):
            yield None
    else:
        raise ValueError(f"no fault {name!r}; one of {FAULTS}")


def _skip_on_follower(runtime) -> bool:
    """Make one follower of partition 1 drop one committed batch in
    ``EVERY``. False where partition 1 has no follower."""
    leader = resolve_leader_partition(runtime.brokers.values(), 1)
    followers = [b.partitions[1] for b in runtime.brokers.values()
                 if 1 in b.partitions and b.partitions[1] is not leader]
    if not followers:
        return False
    stream = followers[0].stream
    append = stream.append_committed_payload
    hit = _every(EVERY)

    def skipping(payload, first_position, has_pending_commands=None):
        if hit():
            stream._next_position = max(stream._next_position, first_position + 1)
            return None
        return append(payload, first_position, has_pending_commands)

    stream.append_committed_payload = skipping
    return True
