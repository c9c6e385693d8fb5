"""User-facing handles and pipeline classes of the port (the ported part
of astrild_tpu/models)."""
from .power import Bispectrum3D, PowerSpectrum3D, PowMes
from .simulation import Ecosmog, RayRamses, Simulation
from .skymap import SkyArray, SkyMap

__all__ = ["PowerSpectrum3D", "Bispectrum3D", "PowMes", "Simulation",
           "Ecosmog", "RayRamses", "SkyArray", "SkyMap"]
