"""User-facing handles and pipeline classes of the port (the ported part
of astrild_tpu/models)."""
from .dipoles import Dipoles
from .halos import Halos, Rockstar, SubFind
from .lightcone import halo_lightcone_catalog, merge_lightcone_catalogs
from .peaks import Peaks
from .power import (AngularPowerSpectrum, Bispectrum2D, Bispectrum3D,
                    LinearAngularPowerSpectrum, LinearPowerSpectrum,
                    PowerSpectrum3D, PowMes)
from .simcoll import SimulationCollection
from .siminfo import snapshot_info_table, write_snapshot_info
from .simulation import Ecosmog, RayRamses, Simulation
from .skyhealpix import SkyHealpix
from .skymap import SkyArray, SkyMap
from .skynamaster import SkyNamaster
from .voids import TunnelsFinder, Voids, WatershedFinder

__all__ = ["Dipoles", "Halos", "Rockstar", "SubFind", "Peaks",
           "AngularPowerSpectrum", "PowerSpectrum3D", "Bispectrum3D",
           "Bispectrum2D", "LinearPowerSpectrum",
           "LinearAngularPowerSpectrum", "PowMes", "Simulation",
           "SimulationCollection", "snapshot_info_table",
           "write_snapshot_info",
           "Ecosmog", "RayRamses", "SkyArray", "SkyHealpix", "SkyMap",
           "SkyNamaster",
           "TunnelsFinder",
           "Voids", "WatershedFinder", "halo_lightcone_catalog",
           "merge_lightcone_catalogs"]
