"""HOD (halo occupation distribution) galaxy mocks: Zheng+07 occupation,
NFW satellite profiles, virial velocity dispersion.

Port of astrild_tpu/ops/hod.py: populate a halo catalog with galaxies on
the device, with fixed shapes (a max_sat cap and a validity mask) so the
result composes with the TPCF, pairwise and void estimators.

Occupation model (Zheng et al. 2007, arXiv:astro-ph/0408564, Eqs. 2-5):

    <N_cen>(M) = 1/2 [1 + erf((log10 M - log10 Mmin) / sigma_logM)]
    <N_sat>(M) = <N_cen>(M) ((M - M0)/M1)^alpha        for M > M0

Satellites are Poisson around <N_sat>, placed on an NFW profile by exact
inverse-CDF sampling (bisection on mu(x) = ln(1+x) - x/(1+x)), with
isotropic Gaussian velocities of the virial dispersion
sigma_v^2 = G M / (2 R_vir).

Randomness comes from an explicit `torch.Generator` where the JAX package
takes a PRNG key, so the same seed gives another realization than JAX's.
`hod_populate` draws its five random fields and hands them to
`hod_populate_from_draws`, which does the rest: given the JAX package's
own draws it gives the JAX package's catalog.

Units: masses Msun/h, lengths Mpc/h (comoving), velocities km/s.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from .._device import as_tensor, as_theory_tensor
from .voids3d import _f32

__all__ = ["HODParams", "zheng07_mean_occupation", "nfw_radius_sample",
           "hod_populate", "hod_populate_from_draws", "compact_catalog"]

# G in (km/s)^2 Mpc Msun^-1 ; h cancels between M[Msun/h] and R[Mpc/h]
_G_KMS2_MPC_MSUN = 4.30091e-9


class HODParams(NamedTuple):
    """Zheng+07 five-parameter HOD (log10 masses in Msun/h)."""
    log_mmin: float = 12.02
    sigma_logm: float = 0.26
    log_m0: float = 11.38
    log_m1: float = 13.31
    alpha: float = 1.06


def zheng07_mean_occupation(m, params: HODParams, device=None):
    """Mean central / satellite occupation of halos with mass m [Msun/h].

    Returns (n_cen, n_sat), float32 (float64 for a float64 tensor m);
    <N_sat> carries the <N_cen> modulation of Zheng+07 Eq. 5, so n_gal =
    integral dn/dM (<N_cen> + <N_sat>). The fields of `params` may be 0-d
    tensors (HOD parameters of a Fisher Jacobian).
    """
    m = as_theory_tensor(m, device)
    if m.dtype != torch.float64:
        m = m.to(torch.float32)
    dev, dt = m.device, m.dtype
    logm = torch.log10(torch.clamp_min(m, 1.0))
    n_cen = 0.5 * (1.0 + torch.erf(
        (logm - params.log_mmin)
        / torch.as_tensor(params.sigma_logm, dtype=dt, device=dev)))
    base = (torch.clamp_min(m - 10.0 ** params.log_m0, 0.0)
            / torch.as_tensor(10.0 ** params.log_m1, dtype=dt, device=dev))
    n_sat = n_cen * base ** params.alpha
    return n_cen, n_sat


def _nfw_mu(x):
    return torch.log1p(x) - x / (1.0 + x)


def nfw_radius_sample(u, conc, n_iter: int = 50, device=None):
    """Exact inverse-CDF NFW radial sample: r/R_vir for uniform u in [0, 1).

    Solves mu(x) = u mu(c) for x in [0, c] by bisection (n_iter=50 gives
    float32-exact roots), then returns x/c = r/Rvir.
    """
    u = as_tensor(u, device).to(torch.float32)
    conc = as_tensor(conc, u.device).to(torch.float32)
    target = u * _nfw_mu(conc)
    lo = torch.zeros_like(target)
    hi = torch.broadcast_to(conc, target.shape).clone()
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        below = _nfw_mu(mid) < target
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi) / torch.clamp_min(conc, 1e-6)


def hod_populate(generator: torch.Generator, m, x, y, z, vx, vy, vz, rvir,
                 conc, boxsize, params: HODParams = HODParams(),
                 max_sat: int = 16, device=None):
    """Populate a halo catalog with HOD galaxies.

    Args:
      generator: the source of the five random fields (on the device the
        catalog is made on).
      m: (nh,) halo masses [Msun/h].
      x, y, z: (nh,) halo positions [Mpc/h].
      vx, vy, vz: (nh,) halo velocities [km/s].
      rvir: (nh,) virial radii [Mpc/h].
      conc: (nh,) NFW concentrations.
      boxsize: periodic box size [Mpc/h].
      params: HODParams (Zheng+07).
      max_sat: per-halo satellite capacity; draws are clipped here (the
        returned 'overflow' counts clips).
      device: where numpy input goes (by default the CUDA card; it raises
        without one); a tensor m keeps its device.

    Returns the dict of `hod_populate_from_draws`.
    """
    m = as_tensor(m, device).to(torch.float32)
    dev = m.device
    nh = m.shape[0]
    n_cen_mean, n_sat_mean = zheng07_mean_occupation(m, params)
    has_cen = torch.bernoulli(n_cen_mean, generator=generator).to(torch.bool)
    n_sat_raw = torch.poisson(n_sat_mean, generator=generator).to(
        torch.int32)
    u = torch.rand((nh, max_sat), generator=generator, device=dev)
    dirs = torch.randn((3, nh, max_sat), generator=generator, device=dev)
    gv_unit = torch.randn((3, nh, max_sat), generator=generator, device=dev)
    return hod_populate_from_draws(has_cen, n_sat_raw, u, dirs, gv_unit, m,
                                   x, y, z, vx, vy, vz, rvir, conc, boxsize,
                                   max_sat=max_sat, device=dev)


def hod_populate_from_draws(has_cen, n_sat_raw, u, dirs, gv_unit, m, x, y,
                            z, vx, vy, vz, rvir, conc, boxsize,
                            max_sat: int = 16, device=None):
    """`hod_populate` after its random draws.

    Args:
      has_cen: (nh,) bool, a central in the halo.
      n_sat_raw: (nh,) int, satellites drawn (before the max_sat clip).
      u: (nh, max_sat) uniforms in [0, 1) for the NFW radii.
      dirs: (3, nh, max_sat) standard normals, the satellites' directions.
      gv_unit: (3, nh, max_sat) standard normals, the satellites' velocity
        offsets in units of the virial dispersion.
      m ... boxsize: as in `hod_populate` (input that is not a tensor
        follows has_cen's device).
      device: where numpy has_cen goes (by default the CUDA card; it
        raises without one); a tensor has_cen keeps its device.

    Returns dict of flat (nh * (1 + max_sat),) tensors: gx gy gz gvx gvy
    gvz (galaxies), valid (bool), is_central (bool), halo_index (int32),
    plus 0-d n_gal and overflow.
    """
    has_cen = as_tensor(has_cen, device).to(torch.bool)
    dev = has_cen.device

    def t(a):
        return as_tensor(a, dev).to(torch.float32)

    m, rvir, conc = t(m), t(rvir), t(conc)
    u, dirs, gv_unit = t(u), t(dirs), t(gv_unit)
    nh = m.shape[0]
    n_sat_raw = as_tensor(n_sat_raw, dev).to(torch.int32)
    n_sat = torch.clamp_max(n_sat_raw, max_sat)
    overflow = torch.sum(n_sat_raw - n_sat)

    # satellite radial positions: exact NFW inverse CDF
    r = nfw_radius_sample(u, conc[:, None]) * rvir[:, None]
    # isotropic directions from three independent normal fields
    norm = torch.sqrt(torch.sum(dirs ** 2, dim=0) + 1e-12)
    dx, dy, dz = (dirs[i] / norm * r for i in range(3))

    # intra-halo velocities: isotropic Gaussian, virial dispersion
    sigma_v = torch.sqrt(_G_KMS2_MPC_MSUN * m
                         / (2.0 * torch.clamp_min(rvir, 1e-6)))
    gv = gv_unit * sigma_v[None, :, None]

    sat_valid = (torch.arange(max_sat, device=dev)[None, :]
                 < n_sat[:, None])

    def per_comp(h, dh):
        h = t(h)
        return torch.cat([h, (h[:, None] + dh).reshape(-1)])

    L = _f32(boxsize, dev)
    # floor mod, as the JAX package's `%`: satellites below 0 wrap to L - d
    gx = torch.remainder(per_comp(x, dx), L)
    gy = torch.remainder(per_comp(y, dy), L)
    gz = torch.remainder(per_comp(z, dz), L)
    gvx = per_comp(vx, gv[0])
    gvy = per_comp(vy, gv[1])
    gvz = per_comp(vz, gv[2])
    valid = torch.cat([has_cen, sat_valid.reshape(-1)])
    is_central = torch.cat([torch.ones(nh, dtype=torch.bool, device=dev),
                            torch.zeros(nh * max_sat, dtype=torch.bool,
                                        device=dev)])
    hidx = torch.arange(nh, dtype=torch.int32, device=dev)
    halo_index = torch.cat([hidx, hidx.repeat_interleave(max_sat)])
    return {"gx": gx, "gy": gy, "gz": gz,
            "gvx": gvx, "gvy": gvy, "gvz": gvz,
            "valid": valid, "is_central": is_central,
            "halo_index": halo_index,
            "n_gal": valid.sum(dtype=torch.int32),
            "overflow": overflow}


def compact_catalog(cat: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Host-side strip of invalid rows (dynamic shape -> numpy)."""
    keep = cat["valid"].cpu().numpy()
    out = {}
    for k, v in cat.items():
        v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out[k] = v[keep] if v.shape == keep.shape else v
    return out
