"""The distributed layer on torch.distributed.

Port of astrild_tpu/parallel/: the mesh and its collectives (`mesh`), the
process group and process-local data (`multihost`), the pencil FFT
(`pfft`), the distributed P(k), bispectrum, map filters and z=0 suite
(`power`, `bispectrum`, `maps`, `suite`), the pair and tpcf rings
(`pairwise`, `tpcf`), sharded lens planes, HEALPix shells and ray tracing
(`lensing`), the ring- and m-sharded SHTs (`sht`, `sht_large`), the
distributed PM and field-level inference (`nbody`, `field_infer`) and the
collective inventory (`inventory`). One process runs a rank; the mesh is
a torch DeviceMesh with the axes ('sim', 'x', 'y'), laid out as the JAX
mesh, and every factory runs on this rank's block (see mesh.py). Launch a
world of several ranks with torchrun; a plain process is a world of one.
"""
from . import (bispectrum, field_infer, inventory, lensing, maps, mesh,
               multihost, nbody, pairwise, pfft, power, sht, sht_large, suite,
               tpcf)
from .mesh import auto_mesh, make_mesh, sim_axis_mesh

__all__ = ["bispectrum", "field_infer", "inventory", "lensing", "maps",
           "mesh", "multihost", "nbody", "pairwise", "pfft", "power", "sht",
           "sht_large", "suite", "tpcf", "auto_mesh", "make_mesh",
           "sim_axis_mesh"]
