"""The AltGDmin core of the port: the problem, the spectral init, the
solver programs and their lowerings (``repro_torch.core.program``).

The virtual-node mesh entry point of the paper's own solver, derived
from its program as ``src/repro/core/__init__.py`` derives it.
"""
from repro_torch.core.program import get_program, lower_virtual_mesh

dif_altgdmin_virtual_mesh = lower_virtual_mesh(get_program("dif_altgdmin"))
