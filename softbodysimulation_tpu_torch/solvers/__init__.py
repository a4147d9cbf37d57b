from . import lattice
