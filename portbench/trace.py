"""Reduction of a profiler trace to what the per-layer readers read: the
traced window, the device's busy time as the union of its operations,
the idle gaps by the host span that was open, the device operations by
name, and the program's own host spans.  Times are seconds on the
profiler's clock."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[float, float]
# the benchmark's own host spans (torch.profiler.record_function names)
SPAN_PREFIX = "portbench."
WINDOW = SPAN_PREFIX + "window"
# the program's own host spans (the port's ``diag.profiling.SPAN_PREFIX``,
# kept here as a literal: the benchmark's modules import nothing of the
# program)
PROGRAM_SPAN_PREFIX = "sbs."


@dataclasses.dataclass
class Trace:
    """One traced slice of the window: ``calls`` whole calls between
    ``window[0]`` and ``window[1]``; ``device_ops`` every operation that
    ran on the device (name, start, end); ``spans`` the benchmark's host
    spans inside the slice (name without the prefix, start, end);
    ``program_spans`` the program's host spans there, the same way
    (``PROGRAM_SPAN_PREFIX`` taken off).  Only ``spans`` name idle gaps."""

    window: Interval
    calls: int
    device_ops: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]
    program_spans: List[Tuple[str, float, float]] = dataclasses.field(
        default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> List[Interval]:
        return union([(s, e) for _, s, e in self.device_ops], self.window)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def device_time(self, name_part: str) -> float:
        """Seconds of the operations whose name holds ``name_part``,
        inside the window."""
        lo, hi = self.window
        return sum(max(0.0, min(e, hi) - max(s, lo))
                   for n, s, e in self.device_ops if name_part in n)

    def top_ops(self, k: int = 10) -> List[list]:
        total: Dict[str, float] = {}
        lo, hi = self.window
        for n, s, e in self.device_ops:
            total[n] = total.get(n, 0.0) + max(0.0, min(e, hi) - max(s, lo))
        return [[n, t] for n, t in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The device's idle time inside the window, by the host span open
        during it (the innermost, where spans nest: the shortest); idle
        time under no span is ``between_calls``."""
        gaps = complement(self.busy(), self.window)
        spans = sorted(self.spans, key=lambda sp: sp[2] - sp[1])
        total: Dict[str, float] = {}
        for g0, g1 in gaps:
            rest = [(g0, g1)]
            for name, s, e in spans:
                nxt = []
                for r0, r1 in rest:
                    a, b = max(r0, s), min(r1, e)
                    if a < b:
                        total[name] = total.get(name, 0.0) + (b - a)
                        nxt += [(r0, a), (b, r1)]
                    else:
                        nxt.append((r0, r1))
                rest = [(a, b) for a, b in nxt if b > a]
            left = sum(b - a for a, b in rest)
            if left > 0:
                total["between_calls"] = total.get("between_calls", 0.0) + left
        return [[n, t] for n, t in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:k]]


def union(intervals: Sequence[Interval], clip: Interval) -> List[Interval]:
    """The union of ``intervals`` inside ``clip``, as sorted disjoint
    intervals."""
    lo, hi = clip
    out: List[Interval] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def complement(busy: Sequence[Interval], clip: Interval) -> List[Interval]:
    """The parts of ``clip`` that the sorted disjoint ``busy`` leaves
    free."""
    out, t = [], clip[0]
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if clip[1] > t:
        out.append((t, clip[1]))
    return out


def from_profiler(prof, calls: int) -> Trace:
    """The ``Trace`` of a ``torch.profiler.profile`` over ``calls`` calls
    inside a ``WINDOW`` span.  The device's operations are every event the
    profiler puts on the device, but the benchmark's own spans (which it
    mirrors there as annotations); the program's spans are host events
    (CPU-op ranges, not mirrored)."""
    from torch.autograd import DeviceType

    ops, spans, program_spans, window = [], [], [], None
    for e in prof.events():
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(SPAN_PREFIX):
                ops.append((e.name, s, t))
        elif e.name == WINDOW:
            window = (s, t)
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((e.name[len(SPAN_PREFIX):], s, t))
        elif e.name.startswith(PROGRAM_SPAN_PREFIX):
            program_spans.append((e.name[len(PROGRAM_SPAN_PREFIX):], s, t))
    if window is None:
        raise RuntimeError("portbench: the trace holds no window span")
    return Trace(window, calls, ops, spans, program_spans)
