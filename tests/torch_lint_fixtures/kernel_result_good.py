"""zlint fixture: the legal shape — the port's device-result primitives
only inside the registered seam scopes: the module's chunk loop and the
fault seam's fetch. The module's own ``fetch_rows`` counts under the
module's dotted name (``kernel_result_good.fetch_rows``)."""

import numpy as np

from zeebe_tpu_torch.ops.automaton import run_collect, unpack_events


def fetch_rows(chunk):
    return np.asarray(chunk)


def _complete_device_run(dt, state, config, num_instances, fetch):
    state, packed = run_collect(dt, state, n_steps=8, config=config)
    return unpack_events(fetch(packed)[0], num_instances)


class DeviceDefense:
    def _fetch_rows(self, chunk):
        return fetch_rows(chunk)

    def finish_group(self, pg):
        # results reach materialization only through the seam
        return _complete_device_run(*pg, fetch=self._fetch_rows)
