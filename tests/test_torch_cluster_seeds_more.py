"""The random process generator of ``tests/test_randomized_parity.py`` on a
replicated cluster, seeds 10–19 of 30.

Each seed's graph runs on a 3-broker, 3-partition, replication-factor-3
``InProcessCluster`` of the reference and of the port (its brokers on the
CPU; on both, the brokers' metrics and profiling planes off to keep the
run's CPU low): 1–3 instances on every partition, then rounds of job activation and
completion, signals, messages and timers. Every replica log and every
leader's backend counters equal the reference's, and each partition's three
replicas are byte-identical; on every third seed the port with the kernel
backend off writes the kernel's logs too. See ``tests/torch_cluster_flows.py``.
"""

from __future__ import annotations

import pytest

from torch_cluster_flows import check_seed


@pytest.mark.parametrize("seed", range(10, 20))
def test_seed_matches_the_reference_on_every_replica(seed, tmp_path):
    assert check_seed(seed, tmp_path) >= 0
