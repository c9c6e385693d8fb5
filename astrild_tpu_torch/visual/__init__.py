"""The visual layer of the port (astrild_tpu/visual's twin): figures and
the `Maps` facade, numpy and matplotlib on the host."""
from . import figures
from .figures import (figure_size, plot_halo_mass_function, plot_map,
                      plot_power_spectra, plot_velocity_field,
                      plot_void_profiles)
from .maps import Maps

__all__ = ["figures", "figure_size", "plot_halo_mass_function", "plot_map",
           "plot_power_spectra", "plot_velocity_field",
           "plot_void_profiles", "Maps"]
