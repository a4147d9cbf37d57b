"""The one generator of the benchmark's inputs: seeded streams, and a
traffic mix's calls whose answers are compared, from ``--seed`` alone.

Each use of the seed draws from its own stream (``rng``), so a system's
initial state (``systems/<system>.py`` ``initial_positions``, from stream
``POSE``) and the compared calls do not shift one another.  Every seed
gives the same work: the same bodies, substeps and calls; the seed moves
where the bodies start and which calls are compared.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

POSE, CHECKS = 0, 2


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of ``stream`` for ``seed`` (any whole number)."""
    return np.random.default_rng([seed & (2 ** 64 - 1), stream])


def compared_calls(traffic: Dict, seed: int) -> List[int]:
    """The window's calls (counted from its first) whose answers the
    reference checks: ``check.calls`` of the first
    ``check.drawn_from_first``, drawn from the seed."""
    chk = traffic["check"]
    return sorted(int(i) for i in rng(seed, CHECKS).choice(
        chk["drawn_from_first"], size=chk["calls"], replace=False))
