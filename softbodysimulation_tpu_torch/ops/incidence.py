"""Per-particle sums of constraint contributions through padded incidence
tables, in column order.

The plain engines' counterpart of the CUDA kernels' particle passes
(``csrc/mesh_xpbd.cu``): row i of an incidence table lists the indices of
the contributions that reach particle i, in ascending order, padded with
one past the last contribution; ``gather_sum`` adds them column by column
in float32, the order in which a kernel thread walks its CSR row, so the
two sums agree to the bit.  ``ordered_sum`` is the same running sum along
the columns of any stack (a kernel thread's strided sum).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


# a row with more entries than this is a hub (the centre of a tet fan)
HUB_WIDTH = 32


@dataclasses.dataclass(frozen=True)
class Incidence:
    """A padded incidence table split for the column-order row sum: the
    first ``narrow.shape[1]`` columns of every row (enough for every row
    but the hubs), and the hubs' whole rows (``hub_rows``, ``hub``)."""

    narrow: torch.Tensor          # (N, Dn) int64
    hub_rows: torch.Tensor        # (R,) int64
    hub: torch.Tensor             # (R, D) int64

    @staticmethod
    def of(incidence: torch.Tensor, pad: int) -> "Incidence":
        """Split a table whose pad index (one past the contributions) is
        ``pad``."""
        inc = incidence.long()
        counts = (inc < pad).sum(dim=1)
        wide = counts > HUB_WIDTH
        dn = int(counts[~wide].max()) if bool((~wide).any()) else 0
        rows = torch.nonzero(wide).flatten()
        return Incidence(narrow=inc[:, :max(dn, 1)], hub_rows=rows,
                         hub=inc[rows])


class _HubRowSum(torch.autograd.Function):
    """``head`` (R, 3) continued by the columns of ``cols`` (R, W, 3), one
    column at a time in column order: the running float32 sum of the CUDA
    kernel's particle passes, on the tensors' own device.  Backward: the
    exact VJP of a sum, the row cotangent broadcast to every column."""

    @staticmethod
    def forward(ctx, head, cols):
        ctx.width = cols.shape[1]
        stack = torch.cat([head[:, None], cols], dim=1)
        if stack.device.type == "cpu":
            # numpy's running sum is sequential in float32 (torch's CPU
            # cumsum accumulates in float64)
            run = np.add.accumulate(stack.numpy(), axis=1)[:, -1]
            return torch.from_numpy(np.ascontiguousarray(run))
        # a CUDA scan along a dimension that is neither the innermost nor
        # the only one gives each (row, coordinate) one thread that adds
        # the columns in order in float32 (ATen's scan_outer_dim): the
        # kernel's sum, in one launch
        return torch.cumsum(stack, dim=1)[:, -1]

    @staticmethod
    def backward(ctx, g):
        return g, g[:, None, :].expand(-1, ctx.width, -1)


def gather_sum(contrib: torch.Tensor, incidence: Incidence):
    """Row i: the sum of ``contrib[incidence[i, k]]`` over k, in column
    order (the pad index points one past the end, at an appended zero row)
    -- the order of the CUDA kernel's particle passes.  A hub's row goes on
    past the narrow columns through ``_HubRowSum``, so its hundreds of
    columns do not widen every row."""
    full = torch.cat([contrib, contrib.new_zeros((1, 3))])
    cols = incidence.narrow
    delta = full[cols[:, 0]]
    for k in range(1, cols.shape[1]):
        delta = delta + full[cols[:, k]]
    if incidence.hub_rows.numel():
        run = _HubRowSum.apply(delta[incidence.hub_rows],
                               full[incidence.hub[:, cols.shape[1]:]])
        delta = delta.index_put((incidence.hub_rows,), run)
    return delta


def ordered_sum(stack: torch.Tensor) -> torch.Tensor:
    """(R, W, C) -> (R, C): each row's W columns added in column order in
    float32, starting from the first (``_HubRowSum``)."""
    return _HubRowSum.apply(stack[:, 0], stack[:, 1:])
