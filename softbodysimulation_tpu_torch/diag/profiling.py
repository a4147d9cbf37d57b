"""Tracing of the port: host spans on the profiler's clock, the operator's
trace exporter, and the lattice kernel's barrier counters on the card.

Counterpart of ``softbodysimulation_tpu/diag/profiling.py``'s ``trace``
(``torch.profiler`` where JAX uses its tracer); ``StepTimer`` and
``measure_throughput`` are not ported yet.

- ``span(name)``: a range named ``SPAN_PREFIX + name`` on the profiler's
  CPU timeline while a profiler is recording, else one shared no-op
  context (one boolean check, no profiler object built).  The range is a
  CPU-op range (``torch._C._profiler._RecordFunctionFast``), not a user
  annotation (``torch.profiler.record_function``): the profiler mirrors
  user annotations onto the device timeline as ranges from their first
  device operation to their last, which a reader of the device's busy
  time would count as device work; a CPU-op range stays on the host's
  timeline, so the device timeline holds the same operations with spans
  as without.
- ``trace(path)``: profile CPU and CUDA over the block and write a Chrome
  trace of both timelines, spans included, on one clock.
- ``counting()`` / ``counts()``: inside ``counting()`` the lattice runner
  (``kernels/lattice_cuda.run_substeps_cuda``, persistent design) launches
  the kernel's counted twin (``lattice_counted_kernel``), which adds each
  warp's cycles waiting in barriers, cycles resident and barriers crossed
  into three totals on the card; ``counts()`` reads and resets them.
  Outside it the runner launches the kernel it always launches.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

SPAN_PREFIX = "sbs."
_OFF = contextlib.nullcontext()

# the counting scope's state: open scopes, the totals on each device
# (wait cycles, resident cycles, barriers; int64, added to by the kernel
# as unsigned 64-bit words) and the warps launched since the last read
_depth = 0
_totals: Dict[torch.device, torch.Tensor] = {}
_warps = 0


def span(name: str):
    """A profiler range ``SPAN_PREFIX + name`` while the profiler records;
    else a shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name)
    return _OFF


@contextlib.contextmanager
def trace(path):
    """Profile the CPU (and CUDA, where there is a card) over the block,
    synchronise, and write the Chrome trace to ``path``; yields the
    ``torch.profiler.profile``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))


@contextlib.contextmanager
def counting():
    """While open, lattice kernel calls on the card launch the counted
    twin; ``counts()`` reads what they counted."""
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def counting_open() -> bool:
    return _depth > 0


def totals(device: torch.device, warps: int) -> torch.Tensor:
    """The three totals on ``device`` for a counted launch of ``warps``
    warps (added to the count ``counts()`` reports)."""
    global _warps
    t = _totals.get(device)
    if t is None:
        t = _totals[device] = torch.zeros(3, dtype=torch.int64,
                                          device=device)
    _warps += warps
    return t


def counts() -> Optional[Dict[str, int]]:
    """Synchronise, return ``{"wait_cycles", "resident_cycles",
    "barriers", "warps"}`` summed over every counted launch since the
    last read, and reset them; ``None`` where nothing was counted (always
    on a host without a card)."""
    global _warps
    if not _totals:
        return None
    wait = resident = barriers = 0
    for t in _totals.values():
        torch.cuda.synchronize(t.device)
        w, r, b = t.tolist()
        wait, resident, barriers = wait + w, resident + r, barriers + b
        t.zero_()
    out = {"wait_cycles": wait, "resident_cycles": resident,
           "barriers": barriers, "warps": _warps}
    _warps = 0
    return out
