"""The random process generator of ``tests/test_randomized_parity.py``
through the port's kernel backend, seeds 40–79 of 120.

Each seed runs through the kernel backend with every burst-template hit
audited against the slow path, and through its fast path (templates
served), on both packages. Per mode the port's log (record fields and
bytes, journal entries) and backend counters equal the reference's and the
port's log equals its sequential engine's (whose log
``tests/test_torch_engine.py`` holds to the reference's); see
``tests/torch_kernel_flows.py``.
"""

from __future__ import annotations

import pytest

from torch_kernel_flows import check_seeds

SEEDS = range(40, 80)
BLOCK = 10


@pytest.mark.parametrize("first", range(SEEDS.start, SEEDS.stop, BLOCK))
def test_seed_block_matches_the_reference(first):
    check_seeds(range(first, first + BLOCK))
