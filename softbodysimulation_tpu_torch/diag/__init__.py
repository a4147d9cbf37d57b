from . import diagnostics, profiling
