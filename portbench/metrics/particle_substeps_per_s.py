"""particle_substeps_per_s: particles times substeps completed in the
window, over the window's seconds (host clock; the window ends at the end
of a synchronised call)."""


def read(run):
    if not run.call_s or run.window_s <= 0:
        return None
    return (run.particles * run.substeps_per_call * len(run.call_s)
            / run.window_s)
