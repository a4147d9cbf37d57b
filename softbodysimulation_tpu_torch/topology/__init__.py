from . import (build, coloring, edges, lattice, mesh, native, objloader, tets,
               windows)
