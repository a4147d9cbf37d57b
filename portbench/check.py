"""What decides ``correct``: the numbers compared between what the timed
path produced and the plain reference, each against the limit in the
cell's file ``limits/<cell>.json``.  (What counts a call as ``failed`` is
the system's own health gate, ``systems/<system>.py`` ``unhealthy``.)"""

from __future__ import annotations

import math
from typing import Dict, List

import torch


def measure(kind: str, prog: torch.Tensor, ref: torch.Tensor) -> float:
    """One compared call's number: ``max_abs`` max |prog - ref|;
    ``max_rel`` that over max |ref|.  Anything not finite reads ``inf``."""
    if kind not in ("max_abs", "max_rel"):
        raise ValueError(f"portbench: no measure {kind!r}")
    p = prog.detach().to("cpu", torch.float64)
    r = ref.detach().to("cpu", torch.float64)
    d = (p - r).abs()
    if d.numel() == 0:
        return 0.0
    if not bool(torch.isfinite(d).all()):
        return math.inf
    v = float(d.max())
    if kind == "max_rel":
        scale = float(r.abs().max())
        v = v / scale if scale > 0 else (0.0 if v == 0 else math.inf)
    return v


def compare(limits: Dict, pairs: List[tuple]) -> Dict[str, Dict]:
    """Every number of ``limits["numbers"]`` over the compared calls
    ``pairs`` (program leaves, reference leaves): the largest reading of
    any call, beside its limit.  No call compared reads ``inf``."""
    out = {}
    for name, spec in limits["numbers"].items():
        vals = [measure(spec["measure"], p[spec["leaf"]], r[spec["leaf"]])
                for p, r in pairs]
        out[name] = {"value": max(vals) if vals else math.inf,
                     "limit": spec["limit"]}
    return out


def passes(numbers: Dict[str, Dict]) -> bool:
    return all(n["value"] <= n["limit"] for n in numbers.values())
