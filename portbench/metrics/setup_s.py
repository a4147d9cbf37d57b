"""setup_s: from the start of the benchmark's process (before torch is
imported) to the start of the window: the CUDA context, loading or
building the kernel library, the scene and the warm-up calls (host
clock)."""


def read(run):
    return run.setup_s
