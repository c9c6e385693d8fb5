"""Angular power spectra on the flat sky and the Limber convergence power.

Port of `_flat_sky_binning`, `cl_flat_sky`, `flat_sky_mode_counts`,
`cl_flat_sky_cross`, `cl_isw_limber`, `cl_kappa_cross_limber`,
`cl_kappa_limber`,
`cl_to_flat_map`, `shear_eb_maps`, `kappa_to_shear_maps`, `cl_shear_eb`
and the n(z) Limber kernels of astrild_tpu/ops/angular_power.py.
`cl_to_flat_map` draws its white noise from a `torch.Generator` where the
JAX package takes a PRNG key;
`cl_to_flat_map_from_white` takes the two white-noise fields themselves,
so both packages make the same map from the same draws.

The flat-sky MASTER estimators (`cl_flat_sky_masked`,
`flat_sky_coupling_matrix`, `cl_flat_sky_master`,
`flat_sky_spin2_coupling_matrices`, `cl_flat_sky_shear_master`) take the
pseudo spectra on the map's device and build the mode-coupling matrices in
float64: for a mask on the CPU (numpy or a CPU tensor) with the JAX
package's own numpy code, for a mask on the card with the same arithmetic
in float64 torch.fft there, one band at a time (the card never holds the
(nbins, N) indicator or convolution rows). The matrices come back as
float64 numpy and the band solve is host float64 `np.linalg.solve`, as in
the JAX package.

The Limber spectra take a cosmology with float fields (host node tables)
or a traced one (tensor fields: every node quantity a float64 tensor in
the graph, so a Fisher Jacobian runs through them); the n(z) kernels
(`smail_nz`, `cl_kappa_limber_nz` with its NLA terms,
`cl_galaxy_limber_nz`) always take the tensor route, on a float-field
cosmology through `Cosmology.with_tensor_fields`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import as_tensor, as_theory_tensor, default_device
from ..utils.constants import DEG2RAD, H0_OVER_C_HMPC
from ..utils.cosmology import Cosmology
from ..utils.tables import interp
from .linear_power import (_halofit_power, _unnormalized_power,
                           halofit_parameters, normalization)
from .power import _mode_numbers

__all__ = ["cl_flat_sky", "cl_flat_sky_cross", "flat_sky_mode_counts",
           "cl_isw_limber", "cl_kappa_cross_limber", "cl_kappa_limber",
           "cl_kappa_limber_nz",
           "cl_galaxy_limber_nz", "smail_nz", "C1_RHO_CR", "cl_to_flat_map",
           "cl_to_flat_map_from_white", "shear_eb_maps",
           "kappa_to_shear_maps", "cl_shear_eb", "cl_flat_sky_masked",
           "flat_sky_coupling_matrix", "cl_flat_sky_master",
           "flat_sky_spin2_coupling_matrices", "cl_flat_sky_shear_master"]


def _segment_sum(values, binidx, nbins: int):
    out = torch.zeros(nbins, dtype=values.dtype, device=values.device)
    return out.index_add_(0, binidx, values)


def _flat_sky_binning(n: int, opening_angle_deg, nbins: int, ell_min,
                      ell_max, device=None):
    """The flat-sky ell binning (its one home). Returns (binidx, inside,
    nm, lsum).

    Mode-to-bin assignment compares EXACT integers: the squared mode
    number m2 = fi^2 + fj^2 (exact in float32 up to n=2048, the mode
    numbers built from integers) against host-precomputed squared edges
    in units of the fundamental (numpy float64, squared, cast float32: the
    JAX package's own edges). No sqrt takes part in the selection; it is
    only used for the reported lsum values.
    """
    f = _mode_numbers(n, device)
    m2 = (f[:, None] ** 2 + f[None, :] ** 2).reshape(-1)  # exact ints
    lf_host = 2.0 * np.pi / (float(opening_angle_deg) * float(DEG2RAD))
    lo = 1.0 if ell_min is None else float(ell_min) / lf_host
    hi = n / 2.0 if ell_max is None else float(ell_max) / lf_host
    edges_sq = torch.as_tensor(
        (np.linspace(lo, hi, nbins + 1) ** 2).astype(np.float32),
        device=device)
    lo2 = float(np.float32(lo * lo))
    hi2 = float(np.float32(hi * hi))
    theta = opening_angle_deg * DEG2RAD
    lf = 2.0 * math.pi / theta  # fundamental multipole (for lsum values)
    binidx = torch.clamp(
        torch.searchsorted(edges_sq, m2, right=True) - 1, 0, nbins - 1)
    inside = ((m2 >= lo2) & (m2 <= hi2)).to(torch.float32)
    lm = lf * torch.sqrt(m2)
    nm = _segment_sum(inside, binidx, nbins)
    lsum = _segment_sum(inside * lm, binidx, nbins)
    return binidx, inside, nm, lsum


def _map(img, device=None):
    """A map as it is if a tensor, else through `_device.as_tensor`."""
    return img if isinstance(img, torch.Tensor) else as_tensor(img, device)


def cl_flat_sky(img, opening_angle_deg, nbins: int = 50,
                ell_min=None, ell_max=None, device=None):
    """Cl of a flat-sky map by azimuthal averaging of |FFT|^2.

    Returns (ell_centers, cl), on the map's device: a tensor's own; numpy
    input goes to `device`, by default the CUDA card (it raises without
    one: pass device="cpu").
    """
    img = _map(img, device)
    n = img.shape[-1]
    theta = opening_angle_deg * DEG2RAD
    # Cl = theta^2 / npix^4 * |FFT|^2
    p2d = (torch.fft.fft2(img).abs() ** 2) * theta ** 2 / float(n) ** 4
    binidx, inside, nm, lsum = _flat_sky_binning(
        n, opening_angle_deg, nbins, ell_min, ell_max, device=img.device)
    psum = _segment_sum(inside * p2d.reshape(-1), binidx, nbins)
    denom = torch.clamp_min(nm, 1.0)
    return lsum / denom, psum / denom


def flat_sky_mode_counts(npix: int, opening_angle_deg, nbins: int = 50,
                         ell_min=None, ell_max=None, device=None):
    """(ell, nmodes) for cl_flat_sky's binning: the discrete grid-point
    count per ell bin, for Gaussian error bars
    Var[C_b] = 2 (C_b + N_b)^2 / nmodes_b. Shares `_flat_sky_binning` with
    cl_flat_sky, so the mode -> bin assignment is identical. The tables
    are made on `device`, by default the CUDA card (it raises without one:
    pass device="cpu")."""
    _, _, nm, lsum = _flat_sky_binning(npix, opening_angle_deg, nbins,
                                       ell_min, ell_max,
                                       device=default_device(device))
    return lsum / torch.clamp_min(nm, 1.0), nm


def cl_flat_sky_cross(img1, img2, opening_angle_deg, nbins: int = 50,
                      ell_min=None, ell_max=None, device=None):
    """Cross-Cl of two flat-sky maps (tomographic kappa_i x kappa_j,
    map x tracer, ...).

    Computed by the polarization identity Re[F1 conj(F2)] =
    (|F1+F2|^2 - |F1-F2|^2)/4 THROUGH cl_flat_sky, so the mode -> bin
    assignment is that of the auto estimator and
    cl_flat_sky_cross(x, x) == cl_flat_sky(x) exactly. Maps are placed as
    in cl_flat_sky.
    """
    img1, img2 = _map(img1, device), _map(img2, device)
    ell, cp = cl_flat_sky(img1 + img2, opening_angle_deg, nbins=nbins,
                          ell_min=ell_min, ell_max=ell_max)
    _, cm = cl_flat_sky(img1 - img2, opening_angle_deg, nbins=nbins,
                        ell_min=ell_min, ell_max=ell_max)
    return ell, 0.25 * (cp - cm)


def cl_isw_limber(ells, cosmo: Cosmology, z_min=0.08, z_max=0.9,
                  nz: int = 256, amplitude=None, device=None):
    """Linear ISW C_ell^TT via the Limber approximation:
      C_ell = (4/c^5) int dz (1+z)^-2 chi^-2 P_dpdp(k = ell/chi, z)
    by the trapezoid rule on nz redshifts, all ells at once.

    ells are placed as in `cl_kappa_cross_limber`. With float fields the
    redshift nodes are the JAX package's float32 jnp.linspace and their
    distances and growth host values cast to float32; a traced cosmology
    takes the tensor route: float64 nodes on its device, in the graph.
    """
    from ..utils.constants import C_LIGHT_KMS
    from .linear_power import p_dpdp
    from .profiles3d import _linspace_f32

    if amplitude is None:
        amplitude = normalization(cosmo)
    ells = _ells_of(ells, cosmo, device, cosmo.traced)
    if cosmo.traced:
        ells = ells.to(cosmo.device)
        z = torch.linspace(float(z_min), float(z_max), nz,
                           dtype=torch.float64, device=cosmo.device)
        chi = cosmo.comoving_distance(z)
    else:
        z = _linspace_f32(z_min, z_max, nz, ells.device)
        chi = torch.as_tensor(np.asarray(cosmo.comoving_distance(
            z.cpu().numpy()), np.float32), device=ells.device)
    k = ells.to(chi.dtype)[:, None] / chi[None, :]       # (nell, nz)
    integ = p_dpdp(k, z, cosmo, amplitude=amplitude) / ((1.0 + z) ** 2
                                                        * chi ** 2)
    cl = torch.trapezoid(integ, z, dim=-1)
    return cl * 4.0 / C_LIGHT_KMS ** 5


def cl_kappa_limber(ells, cosmo: Cosmology, z_source: float = 1.0,
                    nchi: int = 256, amplitude=None,
                    nonlinear: bool = False, device=None):
    """Convergence power C_ell^kappakappa via Limber.

    C_ell = int dchi W(chi)^2 / chi^2 P(k = (ell + 1/2)/chi, z(chi)),
    W(chi) = 1.5 Om0 (H0/c)^2 (1+z) chi (chi_s - chi)/chi_s.

    The theory anchor for the Born-integrated kappa maps
    (ops/lensing.born_convergence). Linear P(k) (EH98) by default;
    nonlinear=True switches to the halofit (Takahashi+12) P(k, z). The
    auto spectrum is the equal-bin case of `cl_kappa_cross_limber`.
    """
    return cl_kappa_cross_limber(ells, cosmo, z_source, z_source,
                                 nchi=nchi, amplitude=amplitude,
                                 nonlinear=nonlinear, device=device)


def cl_kappa_cross_limber(ells, cosmo: Cosmology, z_source_i: float,
                          z_source_j: float, nchi: int = 256,
                          amplitude=None, nonlinear: bool = False,
                          device=None):
    """Tomographic convergence cross-power C_ell^{kappa_i kappa_j}.

    Same Limber integral as cl_kappa_limber with the kernel product
    W_i(chi) W_j(chi), integrated to min(chi_i, chi_j).

    ells: tensor (it keeps its device) or array-like (to `device`, by
    default the CUDA card). With float fields the distances, redshifts,
    growth and the halofit numbers of the nchi quadrature nodes are host
    tables (they depend on chi only, not on ell); P(k) and the integral
    are float32 tensor ops on the ells' device. A traced cosmology takes
    the tensor route: every node quantity is a float64 tensor in the
    graph, on the cosmology's device, and so is C_ell.
    """
    if amplitude is None:
        amplitude = normalization(cosmo)
    if cosmo.traced:
        return _cl_kappa_traced(ells, cosmo, z_source_i, z_source_j, nchi,
                                nonlinear, amplitude, device)
    ells = _ells_of(ells, cosmo, device, False)
    dev = ells.device
    chi_i = float(cosmo.comoving_distance(z_source_i))
    chi_j = float(cosmo.comoving_distance(z_source_j))
    chi_lo = min(chi_i, chi_j)
    chi_h = np.linspace(1e-3 * chi_lo, chi_lo, nchi)
    z_h = np.asarray(cosmo.redshift_at_comoving_distance(chi_h))

    def kern(chi_s):
        return (1.5 * cosmo.Om0 * H0_OVER_C_HMPC ** 2 * (1.0 + z_h) * chi_h
                * np.clip(chi_s - chi_h, 0.0, None) / chi_s)

    def dev32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    chi = dev32(chi_h)
    k = (ells[:, None] + 0.5) / chi                      # (nell, nchi)
    if nonlinear:
        par = {name: dev32(v) for name, v in halofit_parameters(
            cosmo, z_h, amplitude).items()}
        pk = _halofit_power(k, cosmo, amplitude, par)
    else:
        pk = (float(amplitude) * _unnormalized_power(k, cosmo)
              * dev32(cosmo.growth_factor(z_h) ** 2))
    weight = dev32(kern(chi_i) * kern(chi_j) / chi_h ** 2)
    return torch.trapezoid(weight * pk, chi, dim=-1)


def _cl_kappa_traced(ells, cosmo: Cosmology, z_i, z_j, nchi: int,
                     nonlinear: bool, amplitude, device=None):
    """`cl_kappa_cross_limber`'s tensor route: every node quantity a
    float64 tensor in the graph, on the traced cosmology's device. z_i and
    z_j are one source pair's redshifts, or sequences of them, one entry a
    pair: C_ell then gains a leading pair axis, (npair, nell), each row the
    elementwise arithmetic of its own call, so a tomographic stack costs
    one pass of launches instead of one a pair."""
    ells = _ells_of(ells, cosmo, device, True).to(cosmo.device)
    chi_i = cosmo.comoving_distance(cosmo._ops.asarray(z_i))[..., None]
    chi_j = cosmo.comoving_distance(cosmo._ops.asarray(z_j))[..., None]
    chi = _chi_nodes(torch.minimum(chi_i, chi_j), nchi)     # (..., nchi)
    z = cosmo.redshift_at_comoving_distance(chi)
    weight = (_lensing_kernel(cosmo, chi, z, chi_i)
              * _lensing_kernel(cosmo, chi, z, chi_j) / chi ** 2)
    pk = _pk_nodes(ells, chi, z, cosmo, nonlinear, amplitude)
    return torch.trapezoid(weight[..., None, :] * pk, chi[..., None, :],
                           dim=-1)


def _chi_nodes(chi_max, nchi: int):
    """The Limber quadrature nodes jnp.linspace(1e-3 chi_max, chi_max,
    nchi) of a tensor chi_max, in float64 and in the graph."""
    t = torch.linspace(0.0, 1.0, nchi, dtype=torch.float64,
                       device=chi_max.device)
    lo = 1e-3 * chi_max
    return lo + (chi_max - lo) * t


def _lensing_kernel(cosmo, chi, z, chi_s):
    """W(chi) = 1.5 Om0 (H0/c)^2 (1+z) chi (chi_s - chi)_+ / chi_s of a
    source plane at chi_s."""
    return (1.5 * cosmo.Om0 * H0_OVER_C_HMPC ** 2 * (1.0 + z) * chi
            * torch.clamp_min(chi_s - chi, 0.0) / chi_s)


def _pk_nodes(ells, chi, z, cosmo, nonlinear: bool, amplitude):
    """P((ell + 1/2)/chi, z(chi)) of a traced cosmology at every (ell,
    node), (..., nell, nchi) for nodes chi (..., nchi), in float64: linear
    EH98 or halofit with the nodes' own halofit numbers."""
    k = (ells.to(chi.dtype)[:, None] + 0.5) / chi[..., None, :]
    if nonlinear:
        par = {name: v[..., None, :] for name, v in
               halofit_parameters(cosmo, z, amplitude).items()}
        return _halofit_power(k, cosmo, amplitude, par)
    return (amplitude * _unnormalized_power(k, cosmo)
            * cosmo.growth_factor(z)[..., None, :] ** 2)


def _ells_of(ells, cosmo, device, tensor_route: bool):
    """The ells as a flat tensor: a tensor's own; other input on `device`,
    else on a traced cosmology's device, else on the CUDA card
    (`_device.as_tensor`: it raises without one). The tensor route keeps
    float64 ells."""
    if device is None and cosmo.traced and not isinstance(ells,
                                                          torch.Tensor):
        device = cosmo.device
    place = as_theory_tensor if tensor_route else as_tensor
    return place(ells, device).reshape(-1)


def _traced(cosmo: Cosmology, device=None) -> Cosmology:
    """`cosmo` on the tensor route: as it is if traced, else with its
    fields as constant tensors on `device` (default the CUDA card)."""
    return (cosmo if cosmo.traced
            else cosmo.with_tensor_fields(default_device(device)))


# ---------------------------------------------------- n(z) Limber kernels
def smail_nz(z, z0: float = 0.9, alpha: float = 2.0, beta: float = 1.5,
             device=None):
    """Smail et al. source redshift distribution n(z) ~ z^alpha
    exp(-(z/z0)^beta) (unnormalized: the Limber kernels normalize). A
    tensor z keeps its device and dtype; other input goes to `device`, by
    default the CUDA card (it raises without one), as float32, as the
    JAX package's jnp.asarray makes it."""
    z = as_theory_tensor(z, device)
    return z ** alpha * torch.exp(-((z / z0) ** beta))


C1_RHO_CR = 0.0134  # NLA normalization C1 rho_cr (Bridle & King 2007)


def _nz_quad(cosmo, z_tab, nz_tab, nz_quad: int):
    """Normalized n(z) on a uniform quadrature grid + chi(z): the shared
    first step of every n(z)-weighted Limber kernel (float64, on the
    traced cosmology's device)."""
    ops = cosmo._ops
    zt, nt = ops.asarray(z_tab).reshape(-1), ops.asarray(nz_tab).reshape(-1)
    zq = zt[0] + (zt[-1] - zt[0]) * torch.linspace(
        0.0, 1.0, nz_quad, dtype=torch.float64, device=cosmo.device)
    nq = interp(zq, zt, nt)
    nq = nq / torch.trapezoid(nq, zq)
    return zq, nq, cosmo.comoving_distance(zq)


def _lensing_efficiency(chi, zq, nq, chis):
    """g(chi) = Int dz n(z) (chi_s - chi)_+/chi_s. chi_s(z=0) = 0 would
    give 0/0 = NaN even though n(0) = 0 multiplies it away: a table
    starting at z = 0 (the natural Smail grid) must not NaN the integral,
    hence the clamp."""
    safe = torch.clamp_min(chis, 1e-6)
    frac = torch.clamp_min(chis[None, :] - chi[:, None], 0.0) / safe
    return torch.trapezoid(nq[None, :] * frac, zq, dim=1)


def _limber_sum(ells, cosmo, chi, z, ww, nonlinear: bool, amplitude):
    """C_ell = Int dchi WW / chi^2 P((ell+1/2)/chi, z): the shared Limber
    integrator of the kappa / galaxy n(z) kernels."""
    pk = _pk_nodes(ells, chi, z, cosmo, nonlinear, amplitude)
    return torch.trapezoid(ww / chi ** 2 * pk, chi, dim=-1)


def _limber_nodes(cosmo, chi_max, nchi: int):
    """(chi, z(chi), dz/dchi) at the Limber nodes up to chi_max."""
    chi = _chi_nodes(chi_max, nchi)
    z = cosmo.redshift_at_comoving_distance(chi)
    return chi, z, H0_OVER_C_HMPC * cosmo.efunc(z)


def cl_kappa_limber_nz(ells, cosmo: Cosmology, z_tab, nz_tab,
                       z_tab2=None, nz_tab2=None, nchi: int = 256,
                       nz_quad: int = 256, amplitude=None,
                       nonlinear: bool = False, a_ia=0.0,
                       eta_ia=0.0, z0_ia: float = 0.62, device=None):
    """Convergence (cross-)power for EXTENDED source distributions:

        W_i(chi) = 1.5 Om0 (H0/c)^2 (1+z) chi g_i(chi),
        g_i(chi) = Int dz n_i(z) (chi_s(z) - chi)_+ / chi_s(z),

    (a delta n(z) recovers `cl_kappa_limber`'s single source plane). n(z)
    tables are normalized internally, so only the shape matters. Pass a
    second (z_tab2, nz_tab2) for a tomographic cross bin.

    a_ia != 0 adds nonlinear-alignment intrinsic alignments (NLA, Bridle &
    King 2007): the total kernel becomes W_i + W_IA,i with

        W_IA,i = -a_ia C1 rho_cr Om0 / D(z)
                 ((1+z)/(1+z0_ia))^eta_ia n_i(z) dz/dchi,

    so the spectrum is GG + GI + II in one integral. The NLA terms are
    kept unconditional, so a_ia / eta_ia may be tensors (IA nuisance
    parameters of a Fisher Jacobian), as may the cosmology's fields. The
    integral is float64 on a traced cosmology's device, else on the ells'
    (a tensor's own; numpy ells go to `device`, by default the CUDA card,
    raising without one).
    """
    ells = _ells_of(ells, cosmo, device, True)
    cosmo = _traced(cosmo, ells.device)
    ells = ells.to(cosmo.device)
    if amplitude is None:
        amplitude = normalization(cosmo)
    zq1, nq1, chis1 = _nz_quad(cosmo, z_tab, nz_tab, nz_quad)
    if z_tab2 is None:
        zq2, nq2, chis2 = zq1, nq1, chis1
    else:
        zq2, nq2, chis2 = _nz_quad(cosmo, z_tab2, nz_tab2, nz_quad)
    chi, z, dz_dchi = _limber_nodes(
        cosmo, torch.maximum(chis1[-1], chis2[-1]), nchi)
    pref = 1.5 * cosmo.Om0 * H0_OVER_C_HMPC ** 2 * (1.0 + z) * chi
    w1 = pref * _lensing_efficiency(chi, zq1, nq1, chis1)
    w2 = pref * _lensing_efficiency(chi, zq2, nq2, chis2)
    fz = ((1.0 + z) / (1.0 + z0_ia)) ** eta_ia
    amp_ia = (-a_ia * C1_RHO_CR * cosmo.Om0 / cosmo.growth_factor(z) * fz
              * dz_dchi)
    w1 = w1 + amp_ia * interp(z, zq1, nq1, left=0.0, right=0.0)
    w2 = w2 + amp_ia * interp(z, zq2, nq2, left=0.0, right=0.0)
    return _limber_sum(ells, cosmo, chi, z, w1 * w2, nonlinear, amplitude)


def cl_galaxy_limber_nz(ells, cosmo: Cosmology, z_tab, nz_tab,
                        bias=1.0, kappa_nz=None, z_source=None,
                        nchi: int = 256, nz_quad: int = 256, amplitude=None,
                        nonlinear: bool = False, device=None):
    """Angular galaxy-count spectra via Limber: C_gg, or C_g-kappa when a
    source population is given:

        W_g(chi)  = b n(z(chi)) dz/dchi
        C_gg      = Int dchi W_g^2 / chi^2 P(k, z)
        C_gkappa  = Int dchi W_g W_kappa / chi^2 P(k, z)

    with W_kappa the n(z)-weighted lensing kernel of `cl_kappa_limber_nz`
    (kappa_nz=(z_tab, nz_tab)) or a source plane (z_source=zs). `bias` may
    be a tensor (a nuisance parameter). Placed as `cl_kappa_limber_nz`.
    Returns C_ell at `ells`.
    """
    ells = _ells_of(ells, cosmo, device, True)
    cosmo = _traced(cosmo, ells.device)
    ells = ells.to(cosmo.device)
    if amplitude is None:
        amplitude = normalization(cosmo)
    zq, nq, chi_l = _nz_quad(cosmo, z_tab, nz_tab, nz_quad)
    chi_max = chi_l[-1]
    if kappa_nz is not None:
        zsq, nsq, chis_s = _nz_quad(cosmo, kappa_nz[0], kappa_nz[1],
                                    nz_quad)
        chi_max = torch.maximum(chi_max, chis_s[-1])
    elif z_source is not None:
        chi_s1 = cosmo.comoving_distance(z_source)
        chi_max = torch.maximum(chi_max, chi_s1)
    chi, z, dz_dchi = _limber_nodes(cosmo, chi_max, nchi)
    w_g = bias * interp(z, zq, nq, left=0.0, right=0.0) * dz_dchi
    pref = 1.5 * cosmo.Om0 * H0_OVER_C_HMPC ** 2 * (1.0 + z) * chi
    if kappa_nz is not None:
        w_2 = pref * _lensing_efficiency(chi, zsq, nsq, chis_s)
    elif z_source is not None:
        w_2 = pref * torch.clamp_min(chi_s1 - chi, 0.0) / chi_s1
    else:
        w_2 = w_g
    return _limber_sum(ells, cosmo, chi, z, w_g * w_2, nonlinear, amplitude)


def _f32(x, device):
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def cl_to_flat_map_from_white(re, im, cl_tab_ell, cl_tab_val, npix: int,
                              opening_angle_deg, device=None):
    """Gaussian random flat-sky map of a C_ell table from the two (npix,
    npix) N(0, 1) fields `re` and `im` (the JAX package's `normal(k1)` and
    `normal(k2)` after `split(key)`).

    The JAX package's float32 steps: theta = oa * DEG2RAD, l = (2 pi /
    theta) |m| (m integer mode numbers), C(l) by `jnp.interp` of the table
    (clamped at its ends, zero at l = 0), modes sqrt(C) npix^2 / theta
    (re + i im) / sqrt 2, symmetrized with their l -> -l partner, times
    sqrt 2, then the real part of the inverse FFT. A tensor `re` keeps its
    device; numpy input goes to `device`, by default the CUDA card (it
    raises without one).
    """
    re = _map(re, device)
    dev = re.device
    im = as_tensor(im, dev)
    ell_tab = as_tensor(cl_tab_ell, dev).reshape(-1).contiguous()
    val_tab = as_tensor(cl_tab_val, dev).reshape(-1).contiguous()
    theta = _f32(opening_angle_deg, dev) * _f32(DEG2RAD, dev)
    lf = _f32(2.0 * math.pi, dev) / theta
    f = _mode_numbers(npix, dev)
    lmag = lf * torch.sqrt(f[:, None] ** 2 + f[None, :] ** 2)
    cl = interp(lmag, ell_tab, val_tab)
    cl = torch.where(lmag == 0.0, torch.zeros_like(cl), cl)
    # |m_hat|^2 expectation = Cl * npix^4 / theta^2 (inverse of cl_flat_sky)
    amp = torch.sqrt(torch.clamp_min(cl, 0.0)) * _f32(npix ** 2, dev) / theta
    sqrt2 = torch.sqrt(_f32(2.0, dev))
    m_re = amp * re / sqrt2
    m_im = amp * im / sqrt2
    # hermitianize by symmetrizing: (F + conj(F(-l))) / 2 -> real ifft
    f_re = torch.roll(torch.flip(m_re, (0, 1)), (1, 1), (0, 1))
    f_im = torch.roll(torch.flip(m_im, (0, 1)), (1, 1), (0, 1))
    sym = torch.complex(0.5 * (m_re + f_re), 0.5 * (m_im - f_im))
    # restore unit variance per independent mode after averaging
    return torch.fft.ifft2(sym * sqrt2).real


def cl_to_flat_map(generator: torch.Generator, cl_tab_ell, cl_tab_val,
                   npix: int, opening_angle_deg, device=None):
    """Gaussian random flat-sky map realization from a C_ell table
    (flat-sky synfast): `cl_to_flat_map_from_white` of two (npix, npix)
    white-noise fields drawn from `generator` (re first, then im), on
    `device` (default: the generator's device)."""
    dev = generator.device if device is None else torch.device(device)
    re = torch.randn((npix, npix), generator=generator, device=dev,
                     dtype=torch.float32)
    im = torch.randn((npix, npix), generator=generator, device=dev,
                     dtype=torch.float32)
    return cl_to_flat_map_from_white(re, im, cl_tab_ell, cl_tab_val, npix,
                                     opening_angle_deg)


def _spin2_phase(n: int, device):
    """(l1 column, l2 row, cos 2 phi_l, sin 2 phi_l) on the fft grid, in
    float32 from integer mode numbers; the zero mode has cos 1, sin 0."""
    f = _mode_numbers(n, device)
    l1 = f[:, None]
    l2 = f[None, :]
    l2mag = l1 ** 2 + l2 ** 2
    zero = l2mag == 0.0
    safe = torch.where(zero, torch.ones_like(l2mag), l2mag)
    cos2 = torch.where(zero, torch.ones_like(l2mag),
                       (l1 ** 2 - l2 ** 2) / safe)
    sin2 = torch.where(zero, torch.zeros_like(l2mag), 2.0 * l1 * l2 / safe)
    return l1, l2, cos2, sin2


def shear_eb_maps(gamma1, gamma2, opening_angle_deg=None, device=None):
    """E/B decomposition of flat-sky shear maps (Kaiser-Squires rotation):

        kappa_E(l) =  cos(2 phi_l) g1(l) + sin(2 phi_l) g2(l)
        kappa_B(l) = -sin(2 phi_l) g1(l) + cos(2 phi_l) g2(l)

    Born shear from a scalar potential is pure E; B is the post-Born and
    systematics null. opening_angle_deg is accepted for API symmetry (the
    rotation is scale-free). Maps are placed as in cl_flat_sky. Returns
    (kappa_E, kappa_B) real maps.
    """
    gamma1 = _map(gamma1, device)
    gamma2 = as_tensor(gamma2, gamma1.device)
    _, _, cos2, sin2 = _spin2_phase(gamma1.shape[-1], gamma1.device)
    g1 = torch.fft.fft2(gamma1)
    g2 = torch.fft.fft2(gamma2)
    ke = torch.fft.ifft2(cos2 * g1 + sin2 * g2).real
    kb = torch.fft.ifft2(-sin2 * g1 + cos2 * g2).real
    return ke, kb


def kappa_to_shear_maps(kappa, device=None):
    """Periodic (flat-sky, spin-2) shear from convergence, gamma_hat(l) =
    e^{2 i phi_l} kappa_hat(l): the exact inverse of shear_eb_maps for a
    pure-E field, and the way to make mock shear from periodic kappa maps
    (the zero-padded kappa_to_alpha -> alpha_to_gamma chain attenuates the
    shear near the edges). For even n the unpaired Nyquist row and column
    are zeroed: those modes are their own l -> -l partner, where the spin-2
    phase cannot be applied consistently. The map is placed as in
    cl_flat_sky. Returns (gamma1, gamma2)."""
    kappa = _map(kappa, device)
    n = kappa.shape[-1]
    l1, l2, cos2, sin2 = _spin2_phase(n, kappa.device)
    kh = torch.fft.fft2(kappa)
    if n % 2 == 0:
        nyq = -(n // 2)
        keep = (l1 != nyq) & (l2 != nyq)
        kh = torch.where(keep, kh, torch.zeros_like(kh))
    # cos2 / sin2 are even under l -> -l, so each product inverts to a
    # real map
    g1 = torch.fft.ifft2(cos2 * kh).real
    g2 = torch.fft.ifft2(sin2 * kh).real
    return g1, g2


def cl_shear_eb(gamma1, gamma2, opening_angle_deg, nbins: int = 50,
                ell_min=None, ell_max=None, device=None):
    """(ell, Cl_EE, Cl_BB) of a flat-sky shear field: the E/B rotation,
    then cl_flat_sky of each map. Maps are placed as in cl_flat_sky."""
    ke, kb = shear_eb_maps(gamma1, gamma2, device=device)
    ell, cl_ee = cl_flat_sky(ke, opening_angle_deg, nbins=nbins,
                             ell_min=ell_min, ell_max=ell_max)
    _, cl_bb = cl_flat_sky(kb, opening_angle_deg, nbins=nbins,
                           ell_min=ell_min, ell_max=ell_max)
    return ell, cl_ee, cl_bb


# ---------------------------------------------------------------- MASTER
def _masked_weight(mask, device, opening_angle_deg, apodize_arcmin):
    """The mask as float32 on `device`, Gaussian-apodized when asked."""
    from .filters import gaussian as gaussian_filter

    w = as_tensor(mask, device)
    if apodize_arcmin > 0:
        w = gaussian_filter(w, opening_angle_deg,
                            sigma_arcmin=apodize_arcmin)
    return w


def cl_flat_sky_masked(img, mask, opening_angle_deg, nbins: int = 50,
                       apodize_arcmin: float = 0.0, device=None):
    """Pseudo-Cl of a masked flat-sky map with mean-w^2 deconvolution:
    the mask (optionally apodized with a Gaussian taper) multiplies the
    map, and the measured Cl is divided by <w^2> (the diagonal of the
    mode-coupling matrix; exact for masks smooth on the scales of
    interest). The map is placed as in cl_flat_sky, the mask on its
    device."""
    img = _map(img, device)
    w = _masked_weight(mask, img.device, opening_angle_deg, apodize_arcmin)
    ell, cl = cl_flat_sky(img * w, opening_angle_deg, nbins=nbins)
    w2 = torch.mean(w ** 2)
    return ell, cl / torch.clamp_min(w2, 1e-12)


def _mode_numbers_host(n: int) -> np.ndarray:
    """The JAX package's host mode numbers, np.fft.fftfreq(n) * n."""
    return np.fft.fftfreq(n) * n


def _on_card(mask) -> bool:
    return isinstance(mask, torch.Tensor) and mask.device.type != "cpu"


def _flat_coupling_pieces(mask, opening_angle_deg, nbins: int,
                          ell_min, ell_max):
    """The host coupling core shared by the scalar and spin-2 matrices
    (the JAX package's numpy code): the mode-grid binning indicator, the
    in-band l(l+1) shape weights q (`sht.shape_binned_interp`, which
    raises on an empty band), the mask mode power, and a `conv(trig)`
    closure returning the circular convolutions Wn (*) (q * trig) as
    (nbins, N) rows."""
    from .sht import shape_binned_interp

    if isinstance(mask, torch.Tensor):
        mask = mask.detach().cpu().numpy()
    w = np.asarray(mask, np.float64)
    n = w.shape[-1]
    npts = float(n * n)
    binidx, inside, nm, _ = _flat_sky_binning(n, opening_angle_deg, nbins,
                                              ell_min, ell_max,
                                              device="cpu")
    binidx = binidx.numpy()
    inside = inside.numpy()
    nm = np.asarray(nm.numpy(), np.float64)
    ind = ((binidx[None, :] == np.arange(nbins)[:, None])
           & (inside[None, :] > 0)).astype(np.float64)     # (nbins, N)
    lf = 2.0 * np.pi / (opening_angle_deg * DEG2RAD)
    f = _mode_numbers_host(n)
    lmag = lf * np.sqrt(f[:, None] ** 2 + f[None, :] ** 2).reshape(-1)
    q = shape_binned_interp(lmag, ind, nm, what="flat-sky grid modes")
    Wn = (np.abs(np.fft.fft2(w)) ** 2) / npts ** 2   # mode-grid mask power
    WnF = np.fft.fft2(Wn)

    def conv(trig):
        rows = q if trig is None else q * trig[None, :]
        maps = rows.reshape(nbins, n, n)
        out = np.real(np.fft.ifft2(WnF[None] * np.fft.fft2(maps)))
        return out.reshape(nbins, -1)

    return n, ind, nm, conv


def _host_trig4(n: int):
    """cos 4 phi and sin 4 phi of the modes, phi = atan2(l2, l1) (the zero
    mode gets phi = 0; |l| = 0 lies outside every band)."""
    f = _mode_numbers_host(n)
    l1 = f[:, None] * np.ones((1, n))
    l2 = np.ones((n, 1)) * f[None, :]
    phi = np.arctan2(l2, l1)
    return np.cos(4.0 * phi).reshape(-1), np.sin(4.0 * phi).reshape(-1)


def _card_couplings(mask, opening_angle_deg, nbins: int, ell_min, ell_max,
                    spin2: bool):
    """The coupling matrices of a mask on the card: the host pieces'
    arithmetic in float64 torch there, one band b' at a time (its q row,
    its convolutions Wn (*) (q trig), their sums over each band b by an
    index_add over the binning). Returns float64 numpy: M, or (M_pp,
    M_pm) with spin2."""
    from .sht import _band_scale, _check_bands, _shape

    dev = mask.device
    w = mask.detach().to(torch.float64)
    n = w.shape[-1]
    npts = float(n * n)
    binidx, inside, nm, _ = _flat_sky_binning(n, opening_angle_deg, nbins,
                                              ell_min, ell_max, device=dev)
    member = inside > 0
    nm64 = nm.to(torch.float64)
    _check_bands(nm64.cpu().numpy(), "flat-sky grid modes")
    lf = 2.0 * np.pi / (opening_angle_deg * DEG2RAD)
    f = torch.from_numpy(_mode_numbers_host(n)).to(dev)
    lmag = lf * torch.sqrt(f[:, None] ** 2 + f[None, :] ** 2).reshape(-1)
    # sht.shape_binned_interp's rows, q_b = [l in b] s(l) scale_b, a band
    # at a time below
    s = _shape(lmag)
    s_in = torch.where(member, s, torch.zeros_like(s))
    ssum = torch.zeros(nbins, dtype=torch.float64, device=dev).index_add_(
        0, binidx, s_in)
    scale = _band_scale(nm64, ssum)
    wn = torch.fft.fft2(w).abs() ** 2 / npts ** 2     # mode-grid mask power
    wnf = torch.fft.fft2(wn)
    del w, wn
    if spin2:
        c4, s4 = (torch.from_numpy(t).to(dev) for t in _host_trig4(n))

    def conv(row):
        out = torch.fft.ifft2(wnf * torch.fft.fft2(row.reshape(n, n))).real
        return out.reshape(-1)

    def band_sums(x):
        x = torch.where(member, x, torch.zeros_like(x))
        return torch.zeros(nbins, dtype=torch.float64,
                           device=dev).index_add_(0, binidx, x)

    cols = ([], []) if spin2 else ([],)
    for b in range(nbins):
        q = torch.where(member & (binidx == b), s * scale[b],
                        torch.zeros_like(s))
        half0 = conv(q)
        if not spin2:
            cols[0].append(band_sums(half0))
            continue
        cross = c4 * conv(q * c4) + s4 * conv(q * s4)
        cols[0].append(band_sums(0.5 * (half0 + cross)))
        cols[1].append(band_sums(0.5 * (half0 - cross)))
    norm = torch.clamp_min(nm64, 1.0)[:, None]
    mats = tuple((torch.stack(c, dim=1) / norm).cpu().numpy() for c in cols)
    return mats if spin2 else mats[0]


def flat_sky_coupling_matrix(mask, opening_angle_deg, nbins: int,
                             ell_min=None, ell_max=None) -> np.ndarray:
    """The exact discrete mode-coupling matrix M_bb' of the flat-sky
    pseudo-Cl, as float64 numpy:

        M_bb' = (1/(N_b N^2)) sum_{k in b} sum_{k' in b'} |w~(k - k')|^2

    with the in-band l(l+1) shape model: the inner sum is a circular
    convolution of the mask power |w~|^2/N^2 with band b''s q row, one FFT
    pair per band. Built in float64 (float32 FFT noise in M couples the
    large low-ell power into high bins): on the host for a mask on the CPU
    (numpy or a CPU tensor), on the card for a mask there. The mode -> bin
    assignment is cl_flat_sky's."""
    if _on_card(mask):
        return _card_couplings(mask, opening_angle_deg, nbins, ell_min,
                               ell_max, spin2=False)
    n, ind, nm, conv = _flat_coupling_pieces(mask, opening_angle_deg,
                                             nbins, ell_min, ell_max)
    M = ind @ conv(None).T
    return M / np.maximum(nm, 1.0)[:, None]


def flat_sky_spin2_coupling_matrices(mask, opening_angle_deg, nbins: int,
                                     ell_min=None, ell_max=None):
    """(M_pp, M_pm): binned mode-coupling matrices of masked shear E/B,

        <pEE_b> = sum_b' [M_pp C_EE + M_pm C_BB]_b'
        <pBB_b> = sum_b' [M_pm C_EE + M_pp C_BB]_b'
        M_pp/pm[b,b'] = (1/(N_b N^2)) sum_{l in b, l' in b'}
                        |w~(l-l')|^2 {cos^2, sin^2}(2(phi_l' - phi_l))

    three circular convolutions per band (Wn (*) q, Wn (*) (q cos 4phi),
    Wn (*) (q sin 4phi)), float64 numpy, placed as
    flat_sky_coupling_matrix builds."""
    if _on_card(mask):
        return _card_couplings(mask, opening_angle_deg, nbins, ell_min,
                               ell_max, spin2=True)
    n, ind, nm, conv = _flat_coupling_pieces(mask, opening_angle_deg,
                                             nbins, ell_min, ell_max)
    c4, s4 = _host_trig4(n)
    # rows: ind_b(l) . [ (conv0 +- (c4 conv_c + s4 conv_s))/2 ]
    half0 = conv(None)
    cross = c4[None, :] * conv(c4) + s4[None, :] * conv(s4)
    M_pp = ind @ (0.5 * (half0 + cross)).T
    M_pm = ind @ (0.5 * (half0 - cross)).T
    norm = np.maximum(nm, 1.0)[:, None]
    return M_pp / norm, M_pm / norm


def _host64(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float64)


def _apodize_guard(name: str, apodize_arcmin, coupling, what: str):
    if apodize_arcmin > 0 and coupling is not None:
        # the pseudo-Cl is measured under the apodized mask while the
        # caller's matrix was (almost certainly) built from the raw one
        raise ValueError(
            f"{name}: apodize_arcmin > 0 with a precomputed coupling would "
            f"decouple apodized pseudo-spectra with the raw mask's "
            f"{what}; apodize the mask yourself, build the coupling from "
            f"it, and pass apodize_arcmin=0")


def cl_flat_sky_master(img, mask, opening_angle_deg, nbins: int = 16,
                       apodize_arcmin: float = 0.0, ell_min=None,
                       ell_max=None, coupling=None, device=None):
    """Mask-decoupled flat-sky spectrum, the MASTER estimator: the
    pseudo-Cl of the masked map on its device, then the float64 host
    solve against the binned mode-coupling matrix (built from the mask on
    the map's device unless `coupling` is given; for many maps under one
    mask build it once with flat_sky_coupling_matrix). Returns
    (ell_centers, cl_hat), float32 on the map's device."""
    _apodize_guard("cl_flat_sky_master", apodize_arcmin, coupling,
                   "matrix")
    img = _map(img, device)
    w = _masked_weight(mask, img.device, opening_angle_deg, apodize_arcmin)
    ell, pcl = cl_flat_sky(img * w, opening_angle_deg, nbins=nbins,
                           ell_min=ell_min, ell_max=ell_max)
    if coupling is None:
        coupling = flat_sky_coupling_matrix(w, opening_angle_deg, nbins,
                                            ell_min=ell_min,
                                            ell_max=ell_max)
    cl_hat = np.linalg.solve(np.asarray(coupling, np.float64), _host64(pcl))
    return ell, torch.from_numpy(cl_hat.astype(np.float32)).to(img.device)


def cl_flat_sky_shear_master(gamma1, gamma2, mask, opening_angle_deg,
                             nbins: int = 16, apodize_arcmin: float = 0.0,
                             ell_min=None, ell_max=None, coupling=None,
                             device=None):
    """Mask-decoupled shear spectra (ell, Cl_EE, Cl_BB), the spin-2 MASTER
    estimator: pseudo E/B of the masked shear maps (cl_shear_eb), then the
    2x2-block float64 solve with flat_sky_spin2_coupling_matrices, which
    undoes both the power the mask removes and the E -> B leakage it
    makes. Placed as cl_flat_sky_master."""
    _apodize_guard("cl_flat_sky_shear_master", apodize_arcmin, coupling,
                   "matrices")
    gamma1 = _map(gamma1, device)
    dev = gamma1.device
    w = _masked_weight(mask, dev, opening_angle_deg, apodize_arcmin)
    ell, p_ee, p_bb = cl_shear_eb(gamma1 * w, as_tensor(gamma2, dev) * w,
                                  opening_angle_deg, nbins=nbins,
                                  ell_min=ell_min, ell_max=ell_max)
    if coupling is None:
        coupling = flat_sky_spin2_coupling_matrices(
            w, opening_angle_deg, nbins, ell_min=ell_min, ell_max=ell_max)
    M_pp, M_pm = (np.asarray(c, np.float64) for c in coupling)
    big = np.block([[M_pp, M_pm], [M_pm, M_pp]])
    sol = np.linalg.solve(big, np.concatenate([_host64(p_ee),
                                               _host64(p_bb)]))
    return (ell, torch.from_numpy(sol[:nbins].astype(np.float32)).to(dev),
            torch.from_numpy(sol[nbins:].astype(np.float32)).to(dev))
