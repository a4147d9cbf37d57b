"""Parallel execution: one large lattice split into x-slabs across devices
(``spatial``)."""
