"""Constants and host-table helpers shared by the port's modules, and the
background `Cosmology`."""
from . import cosmology
from .cosmology import Cosmology

# PLANCK18 is left out of __all__: a star-import would resolve it through
# __getattr__ and build its tables at import time
__all__ = ["Cosmology", "cosmology"]


def __getattr__(name):
    # PLANCK18 builds its tables on first use (PEP 562)
    if name == "PLANCK18":
        return cosmology.PLANCK18
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
