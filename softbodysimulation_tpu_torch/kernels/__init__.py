from . import lattice_cuda
