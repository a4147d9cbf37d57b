from . import lattice_cuda, mesh_cuda
