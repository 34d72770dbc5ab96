"""zlint fixture: device output reaching a transaction OUTSIDE the port's
kernel fault seam — every primitive use below is a finding."""

from zeebe_tpu_torch.engine.kernel_backend import fetch_rows
from zeebe_tpu_torch.ops.automaton import run_collect, unpack_events


def sneak_device_result_into_txn(db, dt, state, config, chunk, num_instances):
    state, packed = run_collect(dt, state, n_steps=8, config=config)
    rows = fetch_rows(chunk)
    events = unpack_events(rows[0], num_instances)
    with db.transaction():
        db.put(("steps",), events)
