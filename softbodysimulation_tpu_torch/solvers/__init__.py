from . import general, lattice
