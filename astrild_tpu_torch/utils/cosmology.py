"""Background cosmology on the host: distances, growth, Hubble flow.

Port of astrild_tpu/utils/cosmology.py, restricted to what the forward
model needs. The JAX class builds its tables with jnp in float32 so that
they can live inside traced code; the port keeps them as host numpy
float64 tables (the repo's rule for host precomputes), so its values agree
with the JAX package's to float32 rounding (~1e-6 relative). Methods take
scalars or array-likes and return numpy values.

Flat (w0, wa)CDM. Units: Mpc/h for distances, km/s for velocities.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .constants import C_LIGHT_KMS, H0_HUNITS, H0_OVER_C_HMPC

__all__ = ["Cosmology"]

_A_MIN = 1.0e-3
_N_TABLE = 1024
_Z_MAX_TABLE = 40.0


@dataclasses.dataclass(frozen=True)
class Cosmology:
    """Flat (w0, wa)CDM cosmology with precomputed distance/growth tables.

    Same fields and defaults as the JAX package's `Cosmology`. Only the
    mu0 = 0 growth table is ported: mu0 != 0 (the growth ODE) raises.
    """

    Om0: float = 0.3089
    Ob0: float = 0.0486
    h: float = 0.6774
    ns: float = 0.9667
    sigma8: float = 0.8159
    w0: float = -1.0
    wa: float = 0.0
    Tcmb: float = 2.7255
    mu0: float = 0.0
    mu_model: str = "const"
    fR0: float = 0.0
    fR_n: float = 1.0

    # host tables, built from the fields above
    _z_tab: np.ndarray = dataclasses.field(init=False, repr=False,
                                          compare=False)
    _chi_tab: np.ndarray = dataclasses.field(init=False, repr=False,
                                            compare=False)
    _lna_tab: np.ndarray = dataclasses.field(init=False, repr=False,
                                            compare=False)
    _lnD_tab: np.ndarray = dataclasses.field(init=False, repr=False,
                                            compare=False)
    _f_tab: np.ndarray = dataclasses.field(init=False, repr=False,
                                          compare=False)

    def __post_init__(self):
        if self.mu0 != 0.0:
            raise NotImplementedError(
                "Cosmology(mu0 != 0): the modified-growth ODE table is not "
                "ported yet; only mu0 = 0 is supported")
        ztab, chitab = self._build_distance_table()
        lna, lnD, f = self._build_growth_table()
        object.__setattr__(self, "_z_tab", ztab)
        object.__setattr__(self, "_chi_tab", chitab)
        object.__setattr__(self, "_lna_tab", lna)
        object.__setattr__(self, "_lnD_tab", lnD)
        object.__setattr__(self, "_f_tab", f)

    @classmethod
    def from_jax_fields(cls, fields: dict) -> "Cosmology":
        """Build from a mapping of the JAX `Cosmology`'s fields; its table
        entries (`_z_tab`, ...) are ignored, the tables are rebuilt here."""
        kw = {f.name: fields[f.name] for f in dataclasses.fields(cls)
              if f.init and f.name in fields}
        return cls(**{k: v if k == "mu_model" else float(v)
                      for k, v in kw.items()})

    # ----------------------------------------------------------- background
    @property
    def Ode0(self) -> float:
        return 1.0 - self.Om0

    def _de_density_ratio(self, a):
        """rho_DE(a)/rho_DE(0) for CPL w(a) = w0 + wa(1-a)."""
        w0, wa = self.w0, self.wa
        return a ** (-3.0 * (1.0 + w0 + wa)) * np.exp(-3.0 * wa * (1.0 - a))

    def efunc_a(self, a):
        """E(a) = H(a)/H0."""
        a = np.asarray(a, np.float64)
        return np.sqrt(self.Om0 * a ** -3
                       + self.Ode0 * self._de_density_ratio(a))

    def _dlnE_dlna(self, a):
        """d ln E / d ln a in closed form (the JAX package takes jax.grad):
        0.5 (-3 Om0 a^-3 + Ode0 rho_DE(a) (-3 (1 + w0 + wa) + 3 wa a))
        / E^2."""
        de = self.Ode0 * self._de_density_ratio(a)
        num = (-3.0 * self.Om0 * a ** -3
               + de * (-3.0 * (1.0 + self.w0 + self.wa) + 3.0 * self.wa * a))
        return 0.5 * num / self.efunc_a(a) ** 2

    def efunc(self, z):
        return self.efunc_a(1.0 / (1.0 + np.asarray(z, np.float64)))

    def Om(self, z):
        """Omega_m(z) = Om0 (1+z)^3 / E(z)^2."""
        z = np.asarray(z, np.float64)
        return self.Om0 * (1.0 + z) ** 3 / self.efunc(z) ** 2

    # ------------------------------------------------------------ distances
    def _build_distance_table(self):
        z = np.linspace(0.0, _Z_MAX_TABLE, _N_TABLE)
        integrand = 1.0 / self.efunc(z)
        dz = z[1] - z[0]
        cum = np.concatenate(
            [[0.0], np.cumsum(0.5 * (integrand[1:] + integrand[:-1]) * dz)])
        return z, (C_LIGHT_KMS / H0_HUNITS) * cum

    def comoving_distance(self, z):
        """chi(z) in Mpc/h (flat universe: == transverse comoving)."""
        return np.interp(np.asarray(z, np.float64), self._z_tab,
                         self._chi_tab)

    def redshift_at_comoving_distance(self, chi):
        """Inverse of comoving_distance, by table inversion."""
        return np.interp(np.asarray(chi, np.float64), self._chi_tab,
                         self._z_tab)

    # --------------------------------------------------------------- growth
    def _build_growth_table(self):
        """D(a) = 5/2 Om0 E(a) int_0^a da'/(a'E(a'))^3 on a log-a grid,
        normalized to D(1) = 1, and f = dlnD/dlna = dlnE/dlna + a
        (aE)^-3 / I."""
        lna = np.linspace(np.log(_A_MIN), 0.0, _N_TABLE)
        a = np.exp(lna)
        e = self.efunc_a(a)
        integrand = 1.0 / (a * e) ** 3 * a  # d(lna) measure
        dlna = lna[1] - lna[0]
        cum = np.concatenate(
            [[0.0], np.cumsum(0.5 * (integrand[1:] + integrand[:-1]) * dlna)])
        # the [0, a_min] tail in matter domination: 2/5 a^(5/2)/sqrt(Om0)
        integral = cum + 2.0 / 5.0 * _A_MIN ** 2.5 / np.sqrt(self.Om0)
        d = 2.5 * self.Om0 * e * integral
        lnD = np.log(d) - np.log(d[-1])
        f = self._dlnE_dlna(a) + integrand / integral
        return lna, lnD, f

    def growth_factor(self, z):
        """D(z), normalized to D(z=0)=1."""
        a = 1.0 / (1.0 + np.asarray(z, np.float64))
        return np.exp(np.interp(np.log(a), self._lna_tab, self._lnD_tab))

    def growth_rate(self, z):
        """f(z) = dlnD/dlna."""
        a = 1.0 / (1.0 + np.asarray(z, np.float64))
        return np.interp(np.log(a), self._lna_tab, self._f_tab)

    # ------------------------------------ scale-dependent f(R) growth
    def scalaron_mass2(self, a):
        """Hu-Sawicki scalaron mass^2 M^2(a) in (h/Mpc)^2:
        H0^2 (Om a^-3 + 4 Ode)^(n+2) / ((n+1)|fR0| (Om+4 Ode)^(n+1))."""
        n = self.fR_n
        om, ol = self.Om0, self.Ode0
        base = om * np.asarray(a, np.float64) ** -3.0 + 4.0 * ol
        return (base ** (n + 2.0) / ((om + 4.0 * ol) ** (n + 1.0))
                / ((n + 1.0) * abs(self.fR0)) * H0_OVER_C_HMPC ** 2)
