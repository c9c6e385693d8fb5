"""Background cosmology: distances, growth, Hubble flow.

Port of astrild_tpu/utils/cosmology.py. Flat (w0, wa)CDM with the
modified-gravity growth of the JAX package (mu0 and the Hu-Sawicki f(R)
scale-dependent growth). Units: Mpc/h for distances, km/s for
velocities.

A numeric field is a Python float or a 0-d tensor. With float fields (the
forward model, the lightcone, clustering, mocks and shear paths) the
tables are host numpy float64 (the repo's rule for host precomputes) and
every method takes scalars or array-likes and returns numpy: values agree
with the JAX package's float32 tables to ~1e-6 relative. When any field is
a tensor (a Fisher Jacobian builds `Cosmology(**params)` from traced
parameters, as the JAX package's pytree leaves allow) the same tables are
built with float64 torch ops on that tensor's device, so autograd and
torch.func follow them, and every method returns a float64 tensor.

The growth ODE D'' + (2 + dlnE/dlna) D' = 1.5 Om(a) (1 + mu) D is linear
in (D, D'), so one RK4 step is a 2x2 matrix of the step's coefficients:
`_growth_D_of_lna` builds the 1023 step matrices at once (each column the
RK4 step of a unit vector) and chains them with a prefix product (10
levels), the same RK4 as the JAX package's scan in a few hundred
launches instead of a dozen a right-hand side.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import default_device
from .constants import (C_LIGHT_KMS, G_NEWTON, H0_HUNITS, H0_OVER_C_HMPC,
                        MPC_KM, RHO_CRIT0)
from .tables import interp

__all__ = ["Cosmology", "PLANCK18"]

_A_MIN = 1.0e-3
_N_TABLE = 1024
_Z_MAX_TABLE = 40.0
_NUMERIC = ("Om0", "Ob0", "h", "ns", "sigma8", "w0", "wa", "Tcmb", "mu0",
            "fR0", "fR_n")


def _concrete_zero(x) -> bool:
    """True iff x is a float zero: a tensor always takes the general path,
    as a traced value does in the JAX package, and is never read."""
    return not isinstance(x, torch.Tensor) and x == 0.0


def _cumtrapz0(f, d):
    """[0, cumulative trapezoid of f at spacing d]."""
    return np.concatenate([[0.0], np.cumsum(0.5 * (f[1:] + f[:-1]) * d)])


class _Host:
    """The numpy route of the float-field tables."""
    exp, log, sqrt, interp, where = np.exp, np.log, np.sqrt, np.interp, \
        np.where
    ones_like, stack = np.ones_like, np.stack
    cumtrapz0 = staticmethod(_cumtrapz0)
    grid = staticmethod(np.linspace)
    cat = staticmethod(np.concatenate)

    @staticmethod
    def asarray(x):
        return np.asarray(x, np.float64)

    @staticmethod
    def clamp0(x):
        return np.clip(x, 0.0, None)


class _Traced:
    """The float64 torch route of a cosmology with tensor fields."""
    exp, log, sqrt, where = torch.exp, torch.log, torch.sqrt, torch.where
    ones_like, stack = torch.ones_like, torch.stack
    interp = staticmethod(interp)
    cat = staticmethod(torch.cat)

    @staticmethod
    def clamp0(x):
        return torch.clamp_min(x, 0.0)

    def __init__(self, device):
        self.device = device

    def asarray(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float64)
        return torch.as_tensor(np.asarray(x, np.float64), device=self.device)

    def grid(self, lo, hi, n):
        # the host grid itself: the nodes do not depend on the parameters
        return self.asarray(np.linspace(lo, hi, n))

    @staticmethod
    def cumtrapz0(f, d):
        return torch.cat([f.new_zeros(1),
                          torch.cumsum(0.5 * (f[1:] + f[:-1]) * d, 0)])


@dataclasses.dataclass(frozen=True)
class Cosmology:
    """Flat (w0, wa)CDM cosmology with precomputed distance/growth tables.

    Same fields and defaults as the JAX package's `Cosmology`. A float
    mu0 = 0 takes the integral growth table; a float mu0 != 0 and any
    tensor mu0 (the JAX package's `_concrete_zero`: a traced value counts
    as nonzero) take the growth ODE. A cosmology with tensor fields
    compares and hashes by identity: its fields are never compared, and
    never turned into Python booleans.
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

    # tables, built from the fields above
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
        traced = [getattr(self, n) for n in _NUMERIC
                  if isinstance(getattr(self, n), torch.Tensor)]
        object.__setattr__(self, "_ops", _Traced(traced[0].device)
                           if traced else _Host)
        ztab, chitab = self._build_distance_table()
        lna, lnD, f = self._build_growth_table()
        object.__setattr__(self, "_z_tab", ztab)
        object.__setattr__(self, "_chi_tab", chitab)
        object.__setattr__(self, "_lna_tab", lna)
        object.__setattr__(self, "_lnD_tab", lnD)
        object.__setattr__(self, "_f_tab", f)

    @property
    def traced(self) -> bool:
        """True when a field is a tensor (the tables are then tensors)."""
        return self._ops is not _Host

    @property
    def device(self):
        """The tables' device: the tensor fields', None for float fields."""
        return self._ops.device if self.traced else None

    def _key(self):
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self)
                     if f.compare)

    def __eq__(self, other):
        if other is self:
            return True
        if type(other) is not type(self):
            return NotImplemented
        if self.traced or other.traced:
            return False
        return self._key() == other._key()

    def __hash__(self):
        return id(self) if self.traced else hash(self._key())

    @classmethod
    def from_jax_fields(cls, fields: dict) -> "Cosmology":
        """Build from a mapping of the JAX `Cosmology`'s fields; its table
        entries (`_z_tab`, ...) are ignored, the tables are rebuilt here."""
        kw = {f.name: fields[f.name] for f in dataclasses.fields(cls)
              if f.init and f.name in fields}
        return cls(**{k: v if k == "mu_model" else float(v)
                      for k, v in kw.items()})

    def with_tensor_fields(self, device=None) -> "Cosmology":
        """This cosmology with its numeric fields (mu0 aside) as 0-d
        float64 tensors on `device`: the traced route with constant
        fields, for code that computes in tensors throughout."""
        kw = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
              if f.init}
        for name in _NUMERIC:
            if name != "mu0":
                kw[name] = torch.as_tensor(kw[name], dtype=torch.float64,
                                           device=device)
        return Cosmology(**kw)

    # ----------------------------------------------------------- background
    @property
    def Ode0(self) -> float:
        return 1.0 - self.Om0

    def _de_density_ratio(self, a):
        """rho_DE(a)/rho_DE(0) for CPL w(a) = w0 + wa(1-a)."""
        w0, wa = self.w0, self.wa
        return (a ** (-3.0 * (1.0 + w0 + wa))
                * self._ops.exp(-3.0 * wa * (1.0 - a)))

    def efunc_a(self, a):
        """E(a) = H(a)/H0."""
        a = self._ops.asarray(a)
        return self._ops.sqrt(self.Om0 * a ** -3
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
        return self.efunc_a(1.0 / (1.0 + self._ops.asarray(z)))

    def H(self, z):
        """H(z) in km/s/(Mpc/h)."""
        return H0_HUNITS * self.efunc(z)

    def Om(self, z):
        """Omega_m(z) = Om0 (1+z)^3 / E(z)^2."""
        z = self._ops.asarray(z)
        return self.Om0 * (1.0 + z) ** 3 / self.efunc(z) ** 2

    def rho_crit(self, z):
        """Critical density at z in (Msun/h)/(Mpc/h)^3 (comoving h-units)."""
        return RHO_CRIT0 * self.efunc(z) ** 2

    def rho_mean0(self):
        """Mean comoving matter density, (Msun/h)/(Mpc/h)^3."""
        return RHO_CRIT0 * self.Om0

    # ------------------------------------------------------------ distances
    def _build_distance_table(self):
        z = self._ops.grid(0.0, _Z_MAX_TABLE, _N_TABLE)
        integrand = 1.0 / self.efunc(z)
        dz = z[1] - z[0]
        return z, (C_LIGHT_KMS / H0_HUNITS) * self._ops.cumtrapz0(integrand,
                                                                  dz)

    def comoving_distance(self, z):
        """chi(z) in Mpc/h (flat universe: == transverse comoving)."""
        return self._ops.interp(self._ops.asarray(z), self._z_tab,
                                self._chi_tab)

    def redshift_at_comoving_distance(self, chi):
        """Inverse of comoving_distance, by table inversion."""
        return self._ops.interp(self._ops.asarray(chi), self._chi_tab,
                                self._z_tab)

    def angular_diameter_distance(self, z):
        """D_A(z) = chi(z)/(1+z) in Mpc/h."""
        z = self._ops.asarray(z)
        return self.comoving_distance(z) / (1.0 + z)

    def _hubble_time_gyr(self):
        """1/H0 in Gyr: (Mpc/h / (km/s)) -> s -> Gyr."""
        return MPC_KM / (H0_HUNITS * self.h) / 3.15576e16

    def lookback_time(self, z):
        """Lookback time in Gyr (h-free: uses physical H0 = 100 h), the
        cumulative trapezoid of 1/((1+z) E(z)) on the distance table's z
        grid, interpolated."""
        ops = self._ops
        z = ops.asarray(z)
        zt = self._z_tab
        cum = ops.cumtrapz0(1.0 / ((1.0 + zt) * self.efunc(zt)),
                            zt[1] - zt[0])
        return ops.interp(z, zt, cum) * self._hubble_time_gyr()

    def age(self, z=0.0):
        """Cosmic time (age of the universe) at redshift z, in Gyr: the
        lookback integral over the background table plus the
        matter-dominated closed form beyond the table's z_max = 40
        (t = 2/(3 H sqrt(Om) (1+z)^{3/2})), which also answers for z
        beyond the table."""
        ops = self._ops
        z = ops.asarray(z)
        zmax = self._z_tab[-1]
        t_h = self._hubble_time_gyr()
        root = ops.sqrt(ops.asarray(self.Om0))
        t_md = (2.0 / 3.0) / root * t_h * (1.0 + z) ** -1.5
        t_tail = (2.0 / 3.0) / root * (1.0 + zmax) ** -1.5 * t_h
        t_table = self.lookback_time(zmax) - self.lookback_time(z) + t_tail
        return ops.where(z > zmax, t_md, t_table)

    # -------------------------------------------------------------- lensing
    def lensing_kernel(self, chi, chi_s):
        """Lensing efficiency g(chi) = (chi_s - chi) * chi / chi_s."""
        chi = self._ops.asarray(chi)
        return self._ops.clamp0(chi_s - chi) * chi / chi_s

    def sigma_crit_inv(self, z_l, z_s):
        """1/Sigma_crit in (Mpc/h)^2/(Msun/h) (comoving)."""
        ops = self._ops
        z_l, z_s = ops.asarray(z_l), ops.asarray(z_s)
        chi_l = self.comoving_distance(z_l)
        chi_s = self.comoving_distance(z_s)
        d_ls = ops.clamp0(chi_s - chi_l) / (1.0 + z_s)
        d_l = chi_l / (1.0 + z_l)
        d_s = chi_s / (1.0 + z_s)
        # Sigma_crit = c^2 / (4 pi G) * D_s / (D_l D_ls)
        pref = C_LIGHT_KMS ** 2 / (4.0 * np.pi * G_NEWTON)
        return d_l * d_ls / (ops.where(d_s > 0, d_s, 1.0) * pref)

    # --------------------------------------------------------------- growth
    def _build_growth_table(self):
        """D(a) = 5/2 Om0 E(a) int_0^a da'/(a'E(a'))^3 on a log-a grid,
        normalized to D(1) = 1, and f = dlnD/dlna = dlnE/dlna + a
        (aE)^-3 / I. With mu0 != 0 (or a tensor mu0) the ODE table
        (`_build_growth_table_ode`) is used instead."""
        if not _concrete_zero(self.mu0):
            return self._build_growth_table_ode()
        ops = self._ops
        lna = ops.grid(np.log(_A_MIN), 0.0, _N_TABLE)
        a = ops.exp(lna)
        e = self.efunc_a(a)
        integrand = 1.0 / (a * e) ** 3 * a  # d(lna) measure
        dlna = lna[1] - lna[0]
        cum = ops.cumtrapz0(integrand, dlna)
        # the [0, a_min] tail in matter domination: 2/5 a^(5/2)/sqrt(Om0)
        integral = cum + 2.0 / 5.0 * _A_MIN ** 2.5 / ops.sqrt(
            ops.asarray(self.Om0))
        d = 2.5 * self.Om0 * e * integral
        lnD = ops.log(d) - ops.log(d[-1])
        f = self._dlnE_dlna(a) + integrand / integral
        return lna, lnD, f

    def mu(self, a):
        """MG growth-source enhancement: G_eff/G - 1 at scale factor a
        ('const': mu0; 'lambda': mu0 times the dark-energy fraction over
        Ode0, the Planck mu-Sigma form)."""
        a = self._ops.asarray(a)
        if self.mu_model == "lambda":
            ode_frac = (self.Ode0 * self._de_density_ratio(a)
                        / self.efunc_a(a) ** 2)
            return self.mu0 * ode_frac / self.Ode0
        return self.mu0 * self._ops.ones_like(a)

    def _build_growth_table_ode(self):
        """Growth from the linear ODE with the modified source term,
        D'' + (2 + dlnE/dlna) D' = 1.5 Om(a) (1 + mu(a)) D, integrated by
        RK4 from matter domination (D ~ a); f = D'/D, ln D normalized to
        D(1) = 1."""
        lna, d, dp = self._growth_D_of_lna(self.mu, with_derivative=True)
        d, dp = d[:, 0], dp[:, 0]
        lnD = self._ops.log(d) - self._ops.log(d[-1])
        return lna, lnD, dp / d

    def _growth_D_of_lna(self, mu_fn, with_derivative: bool = False):
        """RK4 growth table D(lna) for a source enhancement mu_fn(a), the
        JAX package's single growth integrator: 1024 nodes in ln a from
        a = 1e-3, y0 = (a_min, a_min), the rows the states at the nodes.

        mu_fn takes a (nsteps, 1) array of scale factors and returns
        something that broadcasts to (nsteps, ncol): a scalar, mu(a), or
        mu_k(a, k) over ncol wavenumbers. Returns (lna, D) or (lna, D, D')
        with D and D' of shape (1024, ncol).

        Each RK4 step of the linear system is the 2x2 matrix whose columns
        are the step of (1, 0) and (0, 1), built for every step at once;
        the states are the prefix products of those matrices applied to
        y0 (a Hillis-Steele scan: 10 levels of elementwise 2x2 products)."""
        ops = self._ops
        lna = ops.grid(np.log(_A_MIN), 0.0, _N_TABLE)
        h = lna[1] - lna[0]
        l0 = lna[:-1].reshape(-1, 1)

        def coefficients(l):
            a = ops.exp(l)
            om = self.Om0 * a ** -3 / self.efunc_a(a) ** 2
            return -(2.0 + self._dlnE_dlna(a)), 1.5 * om * (1.0 + mu_fn(a))

        stages = [coefficients(l) for l in (l0, l0 + 0.5 * h, l0 + h)]

        def rhs(st, d, dp):
            damp, src = stages[st]
            return dp, damp * dp + src * d

        one = ops.ones_like(stages[0][1])       # (nsteps, ncol)
        zero = 0.0 * one
        # the two unit vectors side by side: d, dp of shape (2, nsteps, ncol)
        d0, dp0 = ops.stack([one, zero]), ops.stack([zero, one])
        k1 = rhs(0, d0, dp0)
        k2 = rhs(1, d0 + 0.5 * h * k1[0], dp0 + 0.5 * h * k1[1])
        k3 = rhs(1, d0 + 0.5 * h * k2[0], dp0 + 0.5 * h * k2[1])
        k4 = rhs(2, d0 + h * k3[0], dp0 + h * k3[1])
        d1 = d0 + (h / 6.0) * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
        dp1 = dp0 + (h / 6.0) * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
        # step matrix [[m11, m12], [m21, m22]]: column j the step of e_j
        m = [d1[0], d1[1], dp1[0], dp1[1]]
        nsteps, s = _N_TABLE - 1, 1
        while s < nsteps:
            late = [x[s:] for x in m]
            early = [x[:-s] for x in m]
            prod = [late[0] * early[0] + late[1] * early[2],
                    late[0] * early[1] + late[1] * early[3],
                    late[2] * early[0] + late[3] * early[2],
                    late[2] * early[1] + late[3] * early[3]]
            m = [ops.cat([x[:s], p]) for x, p in zip(m, prod)]
            s *= 2
        y0 = _A_MIN * ops.ones_like(one[:1])
        d = ops.cat([y0, (m[0] + m[1]) * _A_MIN])
        dp = ops.cat([y0, (m[2] + m[3]) * _A_MIN])
        return (lna, d, dp) if with_derivative else (lna, d)

    def growth_factor(self, z):
        """D(z), normalized to D(z=0)=1."""
        ops = self._ops
        a = 1.0 / (1.0 + ops.asarray(z))
        return ops.exp(ops.interp(ops.log(a), self._lna_tab, self._lnD_tab))

    def growth_rate(self, z):
        """f(z) = dlnD/dlna."""
        ops = self._ops
        a = 1.0 / (1.0 + ops.asarray(z))
        return ops.interp(ops.log(a), self._lna_tab, self._f_tab)

    # ------------------------------------ scale-dependent f(R) growth
    def scalaron_mass2(self, a):
        """Hu-Sawicki scalaron mass^2 M^2(a) in (h/Mpc)^2:
        H0^2 (Om a^-3 + 4 Ode)^(n+2) / ((n+1)|fR0| (Om+4 Ode)^(n+1))."""
        n = self.fR_n
        om, ol = self.Om0, self.Ode0
        base = om * self._ops.asarray(a) ** -3.0 + 4.0 * ol
        return (base ** (n + 2.0) / ((om + 4.0 * ol) ** (n + 1.0))
                / ((n + 1.0) * abs(self.fR0)) * H0_OVER_C_HMPC ** 2)

    def mu_k(self, a, k):
        """G_eff/G - 1 at comoving k [h/Mpc]: k^2 / (3 (k^2 + a^2 M^2)):
        unscreened (1/3) for k/a >> M, GR (0) for k/a << M; zeros for a
        float fR0 = 0."""
        ops = self._ops
        a, k = ops.asarray(a), ops.asarray(k)
        if _concrete_zero(self.fR0):
            return 0.0 * (a * k)
        k2 = k ** 2.0
        return k2 / (3.0 * (k2 + a ** 2 * self.scalaron_mass2(a)))

    def _k_and_out(self, k, device):
        """k rounded to float32 (the JAX package's jnp.asarray(k,
        float32)) as a float64 (nk,) array of the route, and a function
        that returns a result where the route returns it: a float32 tensor
        on k's device (numpy k: `device`, by default the CUDA card) on the
        host route, the float64 tensor itself on the traced route."""
        host = (k.detach().cpu().numpy() if isinstance(k, torch.Tensor)
                else np.asarray(k))
        k32 = np.atleast_1d(host.astype(np.float32)).astype(np.float64)
        if self.traced:
            return self._ops.asarray(k32.reshape(-1)), lambda r: r
        dev = k.device if isinstance(k, torch.Tensor) else \
            default_device(device)
        return k32.reshape(-1), lambda r: torch.from_numpy(
            np.asarray(r, np.float32)).to(dev)

    def _growth_at(self, lna, d, a_t):
        """Rows of a growth table D (1024, ncol) on its ln a nodes at a_t,
        by the port's jnp.interp (its edge rule: clamped at the table's
        ends)."""
        if not self.traced:
            lna, d = torch.from_numpy(lna), torch.from_numpy(d)
        x = torch.log(torch.as_tensor(a_t, dtype=torch.float64,
                                      device=lna.device))
        out = interp(x.reshape(1), lna, d)[0]
        return out if self.traced else out.numpy()

    def growth_factor_k(self, k, z=0.0, device=None):
        """Scale-dependent linear growth D(k, z) of Hu-Sawicki f(R): the
        mu_k(a, k)-modified growth ODE per k, normalized to D ~ a in
        matter domination (the GR table's convention, so ratios against
        growth_factor are meaningful). Float fields: the host float64
        route, returned as float32 on k's device (numpy k: `device`, by
        default the CUDA card); tensor fields: float64 on theirs."""
        k, out = self._k_and_out(k, device)
        lna, d = self._growth_D_of_lna(lambda a: self.mu_k(a, k))
        return out(self._growth_at(lna, d, 1.0 / (1.0 + z)))

    def fofr_pk_enhancement(self, k, z=0.0, device=None):
        """Linear fifth-force power enhancement P_f(R)(k)/P_GR(k) =
        (D_f(R)(k, z) / D_GR(z))^2 with a common early-time
        normalization: exactly 1 at fR0 = 0 and at k -> 0, the
        scale-independent mu = 1/3 enhancement as k -> inf. Placed as
        growth_factor_k places its result."""
        k, out = self._k_and_out(k, device)
        a_t = 1.0 / (1.0 + z)
        lna, d_gr = self._growth_D_of_lna(lambda a: 0.0)
        _, d_k = self._growth_D_of_lna(lambda a: self.mu_k(a, k))
        return out((self._growth_at(lna, d_k, a_t)
                    / self._growth_at(lna, d_gr, a_t)) ** 2)


_PLANCK18_CACHE = None


def __getattr__(name):
    """PEP 562 lazy module attribute: `PLANCK18` (the default fields, the
    JAX package's Planck-2018-like set) builds its tables on first use,
    not when the module is imported."""
    if name == "PLANCK18":
        global _PLANCK18_CACHE
        if _PLANCK18_CACHE is None:
            _PLANCK18_CACHE = Cosmology()
        return _PLANCK18_CACHE
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
