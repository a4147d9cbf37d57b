"""Parallel execution: ensembles of bodies split over devices (``batch``),
and one large lattice split into x-slabs across devices (``spatial``)."""
