from . import diagnostics
