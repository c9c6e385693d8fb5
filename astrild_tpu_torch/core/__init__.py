"""Containers of the port (astrild_tpu/core's twins)."""
from .catalog import Catalog
from .dataset import Dataset
from .grid import Grid3D, SkyGrid

__all__ = ["Catalog", "Dataset", "Grid3D", "SkyGrid"]
