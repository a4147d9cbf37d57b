"""scene_build_ms: the host-clock span around building the configuration
in the program: the lattice spec, the solver config, the state
(``make_lattice_state``, ``replicate_state``) and the step, synchronised
at its end."""


def read(run):
    return run.scene_build_s * 1e3
