"""Multi-plane ray tracing through stacked lens planes (post-Born lensing).

Port of astrild_tpu/ops/raytrace.py. Rays are propagated observer ->
source with deflection impulses at each plane and the 2x2 distortion
matrix is transported along each ray, yielding convergence, shear and the
post-Born rotation omega that no Born-level pipeline can produce. The JAX
package's `lax.scan` over planes is a Python loop here and its `vmap` over
sources a leading batch axis.

Formulation (comoving transverse position x, flat sky, h-units):
  between planes   x' = x + d (chi_k - chi_prev)
  at plane k       d' = d - alpha_k(x),  alpha_k = grad_x psi_k,
                   (1/2) lap_x psi_k = S_k = 1.5 Om (H0/c)^2 dchi_k delta_k/a_k
Angular-grid solve: with psi^theta = psi/chi_k the source term becomes the
"effective plane convergence"  kap_k = chi_k S_k  and alpha_k is the angular
gradient on the plane's own grid, the same spectral inversion as
ops.lensing.kappa_to_alpha.  The distortion transport is
  A' = A + D (chi_k - chi_prev),   D' = D - (U_k/chi_k) A
with U_k = d alpha_k / d theta (2x2, spectral).  At the source,
Ahat = A/chi_s = [[1-kappa-gamma1, -gamma2+omega],
                  [-gamma2-omega, 1-kappa+gamma1]].

Single-plane limit is exact (kappa = (1-chi_l/chi_s) kap_plane, omega = 0);
the weak-field limit reproduces ops.lensing.born_convergence; lens-lens
coupling and ray deflection are the post-Born corrections.

Planes are treated as periodic (they are projections of periodic simulation
boxes), so padding_factor defaults to 1 and ray interpolation wraps.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .._device import as_tensor
from ..utils.constants import C_LIGHT_KMS
from .power import _mode_numbers

__all__ = ["effective_plane_kappa", "plane_deflection_fields",
           "multiplane_raytrace"]


def effective_plane_kappa(delta, chi, dchi, scale_factor, omega_m):
    """kap_k = 1.5 Om (H0/c)^2 chi_k dchi_k delta_k / a_k (dimensionless).

    The Born convergence is sum_k (1 - chi_k/chi_s) kap_k, consistent with
    ops.lensing.born_convergence.
    """
    h0_over_c = 100.0 / C_LIGHT_KMS  # [h/Mpc]
    pref = 1.5 * omega_m * h0_over_c ** 2
    return pref * chi * dchi * delta / scale_factor


def plane_deflection_fields(kap, opening_angle, padding_factor: int = 1,
                            device=None):
    """Spectral deflection alpha = grad psi^theta and its angular Jacobian
    U_ij = d alpha_i / d theta_j from an effective plane convergence.

    Returns (alpha1, alpha2, u11, u12, u22) on the plane's angular grid
    (alpha in the units of opening_angle).  padding_factor=1 keeps the solve
    periodic (exact for box-projection planes); >=2 zero-pads like
    ops.lensing.kappa_to_alpha for isolated patches. Leading batch axes of
    `kap` are kept. A tensor stays on its device; numpy input goes to
    `device`, by default the CUDA card (it raises without one).
    """
    if not isinstance(kap, torch.Tensor):
        kap = as_tensor(kap, device)
    n = kap.shape[-1]
    npad = n
    if padding_factor > 1:
        npad = 1
        while npad < n * padding_factor:
            npad *= 2
    lpad = opening_angle * npad / n
    kf = 2.0 * math.pi / lpad
    # mode numbers from integers: fftfreq(n) * n is an ulp off for odd n
    k1 = (_mode_numbers(npad, kap.device) * kf)[:, None]
    k2 = (_mode_numbers(npad, kap.device, real=True) * kf)[None, :]
    k2mag = k1 ** 2 + k2 ** 2
    zero = k2mag == 0.0
    k2safe = torch.where(zero, torch.ones_like(k2mag), k2mag)
    kap_ft = torch.fft.rfft2(kap, s=(npad, npad))
    # psi_ft = -2 kap_ft / k^2 ; alpha = i k psi ; U = i k (x) alpha
    psi_ft = torch.where(zero, torch.zeros_like(k2mag),
                         -2.0 / k2safe) * kap_ft
    ny = npad // 2
    # odd sizes have no Nyquist plane: zeroing row npad//2 or the last rfft
    # column there would delete a legitimate +k mode
    even = npad % 2 == 0

    def inv(spec, zero_rows: bool, zero_cols: bool):
        # an odd transfer must vanish on its own-negative Nyquist planes
        # (the last two axes, so batched plane stacks stay correct)
        if even and zero_rows:
            spec[..., ny, :] = 0.0
        if even and zero_cols:
            spec[..., :, -1] = 0.0
        return torch.fft.irfft2(spec, s=(npad, npad))[..., :n, :n]

    alpha1 = inv(1j * k1 * psi_ft, True, False)
    alpha2 = inv(1j * k2 * psi_ft, False, True)
    # u11/u22 are even in every axis; u12 is odd in each axis separately
    u11 = inv(-k1 * k1 * psi_ft, False, False)
    u12 = inv(-k1 * k2 * psi_ft, True, True)
    u22 = inv(-k2 * k2 * psi_ft, False, False)
    return alpha1, alpha2, u11, u12, u22


def _interp_periodic(field, c1, c2):
    """Bilinear sample of periodic (..., n, n) fields at fractional pixel
    coordinates (c1 indexes axis -2), wrapping at the edges; leading axes
    of `field` are kept in front of the coordinates' shape."""
    n0, n1 = field.shape[-2], field.shape[-1]
    i0 = torch.floor(c1).to(torch.int32)
    j0 = torch.floor(c2).to(torch.int32)
    f1 = c1 - i0
    f2 = c2 - j0
    i0 = torch.remainder(i0, n0).long()
    j0 = torch.remainder(j0, n1).long()
    i1 = torch.remainder(i0 + 1, n0)
    j1 = torch.remainder(j0 + 1, n1)
    v00 = field[..., i0, j0]
    v01 = field[..., i0, j1]
    v10 = field[..., i1, j0]
    v11 = field[..., i1, j1]
    return ((1 - f1) * (1 - f2) * v00 + (1 - f1) * f2 * v01
            + f1 * (1 - f2) * v10 + f1 * f2 * v11)


def multiplane_raytrace(density_planes, chis, dchis, chi_s, omega_m,
                        opening_angle, scale_factors=None,
                        n_rays: Optional[int] = None,
                        padding_factor: int = 1, device=None):
    """Trace a ray grid through density planes; return post-Born maps.

    Args:
      density_planes: (nplane, npix, npix) density contrast delta per plane,
        ordered by increasing comoving distance. A tensor stays on its
        device and the maps come out there; numpy input goes to `device`,
        by default the CUDA card (it raises without one: pass
        device="cpu").
      chis, dchis: (nplane,) plane comoving distances / thicknesses [Mpc/h].
      chi_s: source comoving distance(s) [Mpc/h]: a scalar, or a (nsrc,)
        array for tomography: each plane's fields are computed once and
        all sources are traced together, with planes beyond each source
        masked out of the deflection (any chi_s <= chis[-1] is therefore
        handled correctly, matching born_convergence's kernel clipping).
      omega_m: matter density parameter.
      opening_angle: angular side of the (periodic) planes and of the ray
        grid [rad].
      scale_factors: (nplane,) a(chi_k); default 1.
      n_rays: rays per side (default npix; rays start at theta = i*dtheta,
        aligned with plane pixels so the single-plane limit is exact).

    Returns dict with (n_rays, n_rays) maps, with a leading (nsrc,) axis
    when chi_s is an array:
      kappa, gamma1, gamma2: post-Born convergence and shear;
      omega: image rotation (identically 0 at Born level);
      beta1, beta2: source-plane angular positions [rad].

    The plane fields are made one plane at a time inside the loop (five
    maps of a plane live at once, not five per plane of the stack).
    """
    density_planes = as_tensor(density_planes, device)
    dev = density_planes.device

    def vec(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    chis, dchis = vec(chis), vec(dchis)
    nplane = density_planes.shape[0]
    npix = density_planes.shape[-1]
    nr = n_rays or npix
    scale_factors = (torch.ones_like(chis) if scale_factors is None
                     else vec(scale_factors))
    chi_src = vec(chi_s)
    scalar = chi_src.dim() == 0
    src = chi_src.reshape(-1, 1, 1)  # (nsrc, 1, 1) against (nsrc, R, R)
    nsrc = src.shape[0]

    dtheta = opening_angle / nr
    t1 = torch.arange(nr, device=dev) * dtheta
    th1, th2 = torch.meshgrid(t1, t1, indexing="ij")
    pix_per_rad = npix / opening_angle

    # x (2,S,R,R) [Mpc/h], d (2,S,R,R) [rad], A (2,2,S,R,R) [Mpc/h /rad],
    # D (2,2,S,R,R) [1]
    x = torch.zeros((2, nsrc, nr, nr), dtype=torch.float32, device=dev)
    d = torch.stack([th1, th2])[:, None].expand(2, nsrc, nr, nr).clone()
    amat = torch.zeros((2, 2, nsrc, nr, nr), dtype=torch.float32, device=dev)
    dmat = (torch.eye(2, device=dev)[:, :, None, None, None]
            * torch.ones((1, 1, nsrc, nr, nr), device=dev))

    dchi_segs = torch.diff(chis, prepend=chis.new_zeros(1))
    for k in range(nplane):
        kap = effective_plane_kappa(density_planes[k], chis[k], dchis[k],
                                    scale_factors[k], omega_m)
        f = torch.stack(plane_deflection_fields(
            kap, opening_angle, padding_factor=padding_factor))
        chi, seg = chis[k], dchi_segs[k]
        x = x + d * seg
        amat = amat + dmat * seg
        # planes beyond the source must not deflect (weight 0), which also
        # makes the final linear drift back to chi_src exact when
        # chi_src < chis[-1]
        w = (chi <= src).to(torch.float32)
        c1 = x[0] / chi * pix_per_rad
        c2 = x[1] / chi * pix_per_rad
        samp = _interp_periodic(f, c1, c2)  # (5, S, R, R)
        alpha = samp[:2] * w
        u = torch.stack([torch.stack([samp[2], samp[3]]),
                         torch.stack([samp[3], samp[4]])]) * w
        d = d - alpha
        # D -= (U/chi) A   (U is d alpha/d theta on the plane's grid;
        # d alpha/d x = U/chi), the 2x2 product written out elementwise:
        # kappa = 1 - (A00 + A11)/2 cancels, and an einsum would lower to
        # a matmul that a caller's TF32 setting reaches
        ua = torch.stack([
            torch.stack([u[i, 0] * amat[0, k] + u[i, 1] * amat[1, k]
                         for k in range(2)]) for i in range(2)])
        dmat = dmat - ua / chi
    x = x + d * (src - chis[-1])
    amat = amat + dmat * (src - chis[-1])
    ahat = amat / src
    out = {"kappa": 1.0 - 0.5 * (ahat[0, 0] + ahat[1, 1]),
           "gamma1": -0.5 * (ahat[0, 0] - ahat[1, 1]),
           "gamma2": -0.5 * (ahat[0, 1] + ahat[1, 0]),
           "omega": 0.5 * (ahat[0, 1] - ahat[1, 0]),
           "beta1": x[0] / src, "beta2": x[1] / src}
    if scalar:
        return {name: v[0] for name, v in out.items()}
    return out
