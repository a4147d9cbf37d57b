from . import contact_cuda, lattice_cuda, mesh_cuda
