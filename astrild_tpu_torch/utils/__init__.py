"""Constants and host-table helpers shared by the port's modules, and the
background `Cosmology`."""
from .cosmology import Cosmology

__all__ = ["Cosmology"]
