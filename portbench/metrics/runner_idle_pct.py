"""runner_idle_pct: the device's idle time inside the program's runner
calls, over the traced slice, in percent.  A runner call is the union of
the port's ``sbs.<runner>.call`` host spans (any runner: the lattice's
``sbs.lattice.call``, a mesh runner's alike), nested or not; idle time
outside them (the benchmark's health gate, its synchronise, the loop
between calls) is not counted.  A slice with no such span reads nothing.
"""

from portbench.trace import complement, union


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    calls = union([(s, e) for n, s, e in tr.program_spans
                   if n.endswith(".call")], tr.window)
    if not calls:
        return None
    busy = tr.busy()
    idle = sum(e - s for c in calls
               for s, e in complement(union(busy, c), c))
    return 100.0 * idle / tr.window_s
