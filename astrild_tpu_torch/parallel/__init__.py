"""The distributed layer on torch.distributed, part A: the 3D-grid half.

Port of astrild_tpu/parallel/ (`mesh`, `multihost`, `pfft`, `power`,
`bispectrum`, `maps`, `suite`). One process runs a rank; the mesh is a
torch DeviceMesh with the axes ('sim', 'x', 'y'), laid out as the JAX
mesh, and every factory runs on this rank's block (see mesh.py). Launch a
world of several ranks with torchrun; a plain process is a world of one.
"""
from . import bispectrum, maps, mesh, multihost, pfft, power, suite
from .mesh import auto_mesh, make_mesh, sim_axis_mesh

__all__ = ["bispectrum", "maps", "mesh", "multihost", "pfft", "power",
           "suite", "auto_mesh", "make_mesh", "sim_axis_mesh"]
