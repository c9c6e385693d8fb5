"""Full-sky lightcone lensing: HEALPix density shells from particle
snapshots, Born convergence on the sphere, and spherical multi-plane ray
tracing through the spherical harmonic transforms.

Port of astrild_tpu/ops/lightcone_sphere.py: particles -> spherical
density shells (a deposit over (shell, pixel) keys: the kernel K1,
`paint_cuda.deposit_flat`, on a CUDA tensor) -> Born kappa, or the
post-Born multiplane tracer (`multiplane_raytrace_healpix`): per shell one
analysis of its effective convergence, then the band-limited kappa, the
spin-1 deflection and the spin-2 shear of the same alms, sampled at the
deflected rays with the tensor HEALPix stencil (utils/healpix_torch.py);
between shells x' = x + d dchi, at a shell d' = d - alpha and the
distortion D' = D - (U / chi) A with U = [[kap + g1, g2], [g2, kap - g1]]
(ops/raytrace.py's recursion on the sphere, in each ray's tangent frame).

Each periodic image of the box is painted in turn. The particles of an
image that fall into a shell are selected first (a mask and `nonzero`)
and only they get keys; the JAX package, whose shapes are static, gives
every particle a key and parks the others on a junk cell. The images'
keys are gathered into groups that share one deposit; a group
is flushed when the next image's keys would pass the card's room for them
(`lens_planes._entry_budget`).

The tracer keeps no stencils: the JAX package returns them from its scan
only to keep an XLA fusion consistent. Its 2x2 distortion products are
elementwise products and sums (no matrix product, so a caller's TF32
setting cannot reach them). Profiler spans: `multiplane.fields` (the
shells' transforms) and `multiplane.transport` (the ray recursion).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from .._device import as_tensor
from .._options import port_spelling
from ..utils import healpix as hpx
from ..utils import healpix_torch as hpt
from . import paint_cuda
from .lens_planes import _BYTES_PER_ENTRY, _entry_budget
from .raytrace import effective_plane_kappa

__all__ = ["shell_counts_healpix", "shell_overdensity",
           "density_shells_healpix", "born_convergence_healpix",
           "multiplane_raytrace_healpix"]

_span = torch.profiler.record_function


def _components(pos, device=None):
    """(n, 3) array or (x, y, z) flat buffers -> three flat float32
    buffers."""
    if isinstance(pos, (tuple, list)):
        x, y, z = (as_tensor(c, device).to(torch.float32).reshape(-1)
                   for c in pos)
    else:
        pos = as_tensor(pos, device).to(torch.float32)
        x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    return x, y, z


def _replica_range(obs: float, chi_max: float, boxsize: float):
    """Per-axis replica indices k such that the box copy [k L, (k+1) L)
    can intersect the observer-centred sphere of radius chi_max."""
    k_lo = int(np.floor((obs - chi_max) / boxsize))
    k_hi = int(np.ceil((obs + chi_max) / boxsize)) - 1
    return range(k_lo, k_hi + 1)


def _shell_keys(dx, dy, dz, edges, w_in, nside: int, nshell: int):
    """(observer-relative components) -> (key, weight or None) of the
    particles that fall into a shell: key = shell * npix + pixel, int32."""
    npix = hpx.nside2npix(nside)
    chi = torch.sqrt(dx * dx + dy * dy + dz * dz)
    s = torch.searchsorted(edges, chi, right=True) - 1
    rows = torch.nonzero((s >= 0) & (s < nshell) & (chi > 0)).reshape(-1)
    chi, s = chi[rows], s[rows].to(torch.int32)
    theta = torch.acos(torch.clamp(dz[rows] / chi, -1.0, 1.0))
    phi = torch.atan2(dy[rows], dx[rows])
    key = s * npix + hpt.ang2pix_ring(nside, theta, phi)
    return key, None if w_in is None else w_in[rows]


def shell_counts_healpix(pos, chi_edges, nside: int, boxsize: float,
                         observer: Optional[Sequence[float]] = None,
                         weights=None, replicate: bool = True,
                         deposit: Optional[str] = None, device=None):
    """Paint particles onto HEALPix shells of an observer-centred
    lightcone: counts[s, p] = sum of weights in radial bin s, pixel p.

    Args:
      pos: (n, 3) positions or (x, y, z) flat buffers [Mpc/h], in a
        periodic box of side `boxsize`. Tensors stay on their device;
        numpy input goes to `device`, by default the CUDA card (it raises
        without one: pass device="cpu").
      chi_edges: (nshell+1,) increasing radial bin edges [Mpc/h].
      nside: HEALPix resolution of the shells.
      observer: (3,) position [Mpc/h]; default box centre.
      replicate: tile periodic box images so the full sphere out to
        chi_edges[-1] is covered (the standard box-replication
        lightcone). With False only the primary image is painted:
        shells beyond the box boundary will be incomplete.
      deposit: None (auto: the CUDA deposit K1 on a CUDA tensor,
        `index_add_` on the CPU) | "kernel" (the JAX package's "pallas";
        CUDA tensors only) | "scatter".

    Returns (nshell, npix) float32 counts.
    """
    chi_edges = np.asarray(chi_edges, np.float64)
    if chi_edges.ndim != 1 or chi_edges.size < 2 \
            or np.any(np.diff(chi_edges) <= 0):
        raise ValueError("chi_edges must be increasing, length >= 2")
    nshell = chi_edges.size - 1
    npix = hpx.nside2npix(nside)
    n_real = nshell * npix
    if n_real >= paint_cuda._MAX_CELLS:
        raise ValueError(
            f"shells: nshell * 12 nside^2 = {n_real} cells do not fit "
            f"int32 keys (limit 2^31); paint fewer shells per call")
    if observer is None:
        observer = (boxsize / 2.0,) * 3
    chi_max = float(chi_edges[-1])
    if replicate:
        reps = [_replica_range(float(o), chi_max, boxsize)
                for o in observer]
    else:
        reps = [range(0, 1)] * 3

    x, y, z = _components(pos, device)
    dev = x.device
    w_in = None if weights is None else \
        as_tensor(weights, dev).to(torch.float32).reshape(-1)

    deposit = port_spelling(deposit, {"pallas": "kernel"}, "deposit")
    if deposit is None:
        deposit = "kernel" if dev.type == "cuda" else "scatter"
    elif deposit not in ("kernel", "scatter"):
        raise ValueError(f"deposit must be None, 'kernel' ('pallas') or "
                         f"'scatter', got {deposit!r}")
    elif deposit == "kernel" and dev.type != "cuda":
        raise ValueError(f"deposit='kernel' needs a CUDA tensor, got {dev}")
    deposit_fn = (paint_cuda.deposit_flat if deposit == "kernel"
                  else paint_cuda.deposit_sorted_reference)
    edges_dev = torch.as_tensor(chi_edges.astype(np.float32), device=dev)
    budget = _entry_budget(dev, n_real)

    flat = torch.zeros(n_real, dtype=torch.float32, device=dev)
    keys, wts, pending = [], [], 0

    def flush():
        nonlocal keys, wts, pending
        if not keys:
            return
        with _span("shells.flush"):
            k = torch.cat(keys) if len(keys) > 1 else keys[0]
            w = None if w_in is None else (
                torch.cat(wts) if len(wts) > 1 else wts[0])
            keys, wts, pending = [], [], 0
            flat.add_(deposit_fn(k, w, n_real))

    for kx in reps[0]:
        for ky in reps[1]:
            for kz in reps[2]:
                # replica box corners all farther than chi_max: skip on
                # host (cheap conservative cull of the replica cube)
                lo = np.array([kx, ky, kz], np.float64) * boxsize \
                    - np.asarray(observer, np.float64)
                near = np.maximum(np.abs(lo + boxsize / 2) - boxsize / 2,
                                  0.0)
                if np.sqrt(np.sum(near ** 2)) > chi_max:
                    continue
                with _span("shells.keys"):
                    k, w = _shell_keys(x + (kx * boxsize - observer[0]),
                                       y + (ky * boxsize - observer[1]),
                                       z + (kz * boxsize - observer[2]),
                                       edges_dev, w_in, nside, nshell)
                entries = k.shape[0]
                if budget is not None and entries > budget:
                    raise RuntimeError(
                        f"shells: box image ({kx}, {ky}, {kz}) alone holds "
                        f"{entries} keys, "
                        f"{entries * _BYTES_PER_ENTRY / 1e9:.2f} GB through "
                        f"the deposit, and the card has room for {budget} "
                        f"({budget * _BYTES_PER_ENTRY / 1e9:.2f} GB); paint "
                        f"the particles in parts and add the counts")
                if budget is not None and pending + entries > budget:
                    flush()
                keys.append(k)
                wts.append(w)
                pending += entries
    flush()
    return flat.view(nshell, npix)


def shell_overdensity(counts, chi_edges, n_total: float, boxsize: float,
                      total_weight: Optional[float] = None):
    """counts -> density contrast delta per shell pixel.

    Expected count per pixel of shell s is
    nbar * Omega_pix * (chi_{s+1}^3 - chi_s^3) / 3 with
    nbar = n_total / boxsize^3 (use total_weight for weighted paints).
    """
    chi_edges = np.asarray(chi_edges, np.float64)
    npix = counts.shape[-1]
    omega_pix = 4.0 * np.pi / npix
    vol = omega_pix * np.diff(chi_edges ** 3) / 3.0
    total = n_total if total_weight is None else total_weight
    nbar = np.float32(total) / np.float32(float(boxsize) ** 3)
    expected = torch.as_tensor(nbar * vol.astype(np.float32),
                               device=counts.device)[:, None]
    return counts / expected - 1.0


def density_shells_healpix(pos, chi_edges, nside: int, boxsize: float,
                           observer: Optional[Sequence[float]] = None,
                           weights=None, replicate: bool = True,
                           device=None):
    """Particles -> (delta shells, chi mids, dchis): the one-call
    lightcone call (counts + normalization)."""
    comps = _components(pos, device)
    dev = comps[0].device
    if weights is not None:
        weights = as_tensor(weights, dev).to(torch.float32).reshape(-1)
    counts = shell_counts_healpix(comps, chi_edges, nside, boxsize,
                                  observer=observer, weights=weights,
                                  replicate=replicate)
    tw = None if weights is None else float(weights.sum())
    delta = shell_overdensity(counts, chi_edges, comps[0].shape[0], boxsize,
                              total_weight=tw)
    chi_edges = np.asarray(chi_edges, np.float64)
    chis = 0.5 * (chi_edges[1:] + chi_edges[:-1])
    dchis = np.diff(chi_edges)
    return (delta,
            torch.as_tensor(chis.astype(np.float32), device=dev),
            torch.as_tensor(dchis.astype(np.float32), device=dev))


def born_convergence_healpix(delta_shells, chis, dchis, chi_s, omega_m,
                             scale_factors=None, device=None):
    """Born convergence on the sphere: kappa = sum_k w_k kap_k with
    w_k = max(1 - chi_k/chi_s, 0) and kap_k the effective shell
    convergence (ops.raytrace.effective_plane_kappa).

    chi_s may be a scalar or a (nsrc,) array (tomography: leading nsrc
    axis on the output). Tensor shells stay on their device; numpy input
    goes to `device`, by default the CUDA card (it raises without one:
    pass device="cpu").
    """
    delta_shells = as_tensor(delta_shells, device)
    dev = delta_shells.device

    def vec(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    chis, dchis = vec(chis), vec(dchis)
    scale_factors = (torch.ones_like(chis) if scale_factors is None
                     else vec(scale_factors))
    kap = effective_plane_kappa(delta_shells, chis[:, None], dchis[:, None],
                                scale_factors[:, None], omega_m)
    chi_s = vec(chi_s)
    # (nshell,) or (nsrc, nshell) weights against (nshell, npix), summed
    # shell by shell from elementwise products (no matrix product, so a
    # caller's TF32 setting cannot reach it)
    w = torch.clamp_min(1.0 - chis / chi_s[..., None], 0.0)
    out = w[..., 0, None] * kap[0]
    for s in range(1, kap.shape[0]):
        out = out + w[..., s, None] * kap[s]
    return out


def _plane_fields_healpix(kap_maps, tabs, lmax: int):
    """Per-shell (alpha_theta, alpha_phi, kap_bl, g1, g2) maps, (nshell,
    5, npix), from the effective shell convergences on the table path, all
    from one adjoint analysis a shell (niter 0 is unbiased for lmax <= 2
    nside). kap_bl is the band-limited kappa the transforms see: the
    single-shell limit is exact against it."""
    from .sht import _adjoint_impl, _synth_impl
    from .sht_spin import (_synth_spin1_impl, _synth_spin2_impl,
                           deflection_E_factor, kappa_alm_to_shear_alm)

    tab0, tab1, tab2 = tabs
    inv = deflection_E_factor(lmax, kap_maps.device)
    out = []
    for kap in kap_maps:
        kr, ki = _adjoint_impl(kap, tab0)
        z = torch.zeros_like(kr)
        a_t, a_p = _synth_spin1_impl(kr * inv, ki * inv, z, z, tab1)
        er, ei = kappa_alm_to_shear_alm(kr, ki)
        g1, g2 = _synth_spin2_impl(er, ei, z, z, tab2)
        out.append(torch.stack([a_t, a_p, _synth_impl(kr, ki, tab0), g1,
                                g2]))
    return torch.stack(out)


def _plane_fields_healpix_scan(kap_maps, tabs, nside: int, lmax: int):
    """`_plane_fields_healpix` on the table-free scan backends (sht_large,
    sht_spin_large): O(lmax * nring) memory instead of O(lmax^2 * nring)
    tables, the production route at nside 512 and above."""
    from . import sht_large as sl
    from . import sht_spin_large as ssl
    from .sht_spin import deflection_E_factor, kappa_alm_to_shear_alm

    stab, s1tab, s2tab = tabs
    inv = deflection_E_factor(lmax, kap_maps.device)
    out = []
    for kap in kap_maps:
        kr, ki = sl._adjoint_large_impl(kap, stab, nside, lmax)
        z = torch.zeros_like(kr)
        a_t, a_p = ssl._synth_spin1_large_impl(kr * inv, ki * inv, z, z,
                                               s1tab, nside, lmax)
        er, ei = kappa_alm_to_shear_alm(kr, ki)
        g1, g2 = ssl._synth_spin2_large_impl(er, ei, z, z, s2tab, nside,
                                             lmax)
        out.append(torch.stack([
            a_t, a_p, sl._synth_large_impl(kr, ki, stab, nside, lmax), g1,
            g2]))
    return torch.stack(out)


def _trace_one(fields, chis, chi_src, t0, p0, sin_t0, nside: int):
    """The ray recursion for one source distance: (nshell, 5, npix) shell
    fields -> the lensing maps at the (t0, p0) ray grid."""
    # a deterministic 0.02-pixel nudge of the sampling positions: with the
    # ray grid at the shells' nside every undeflected ray sits exactly on
    # a stencil boundary, where the last bit of the position decides the
    # pixel; 2% of a pixel biases a smooth band-limited field by < nudge *
    # its gradient (~1e-3 of the signal)
    nudge = 0.02 * float(np.sqrt(np.pi / 3.0)) / nside
    n = t0.shape[0]
    x = torch.zeros((2, n), device=t0.device)
    d = torch.zeros_like(x)
    # the comoving distortion A starts at 0 and its derivative D at the
    # identity (A = chi I without lensing)
    amat = torch.zeros((2, 2, n), device=t0.device)
    dmat = torch.zeros_like(amat)
    dmat[0, 0] = 1.0
    dmat[1, 1] = 1.0
    chi_prev = torch.zeros((), device=t0.device)
    for f, chi in zip(fields, chis):
        dchi_seg = chi - chi_prev
        chi_prev = chi
        x = x + d * dchi_seg
        amat = amat + dmat * dchi_seg
        w = (chi <= chi_src).to(x.dtype)
        # the ray's angular position: fiducial + comoving offset / chi in
        # its local (theta, phi) tangent basis
        th = torch.clamp(t0 + x[0] / chi + nudge, 0.0, math.pi)
        ph = p0 + x[1] / chi / sin_t0 + nudge
        pix, wgt = hpt.get_interp_weights(nside, th, ph)
        idx = pix.reshape(-1).long()
        samp = torch.stack([(m[idx].reshape(pix.shape) * wgt).sum(0)
                            for m in f])
        alpha = samp[:2] * w
        u = torch.stack([torch.stack([samp[2] + samp[3], samp[4]]),
                         torch.stack([samp[4], samp[2] - samp[3]])]) * w
        d = d - alpha
        # dmat -= (u @ amat) / chi, per ray, as products and sums
        ua = torch.stack([torch.stack([
            u[i, 0] * amat[0, k] + u[i, 1] * amat[1, k] for k in range(2)])
            for i in range(2)])
        dmat = dmat - ua / chi
    x = x + d * (chi_src - chis[-1])
    amat = amat + dmat * (chi_src - chis[-1])
    ahat = amat / chi_src
    return {"kappa": 1.0 - 0.5 * (ahat[0, 0] + ahat[1, 1]),
            "gamma1": -0.5 * (ahat[0, 0] - ahat[1, 1]),
            "gamma2": -0.5 * (ahat[0, 1] + ahat[1, 0]),
            "omega": 0.5 * (ahat[0, 1] - ahat[1, 0]),
            "beta_theta": t0 + x[0] / chi_src,
            "beta_phi": p0 + x[1] / chi_src / sin_t0}


def _trace_multiplane(fields, chis, chi_s, t0, p0, nside: int):
    """Ray-transport tail of the multiplane tracer: per-shell field maps
    -> lensing observables at the (t0, p0) ray grid; an array chi_s puts
    a leading source axis on each output (each source traced on its
    own)."""
    sin_t0 = torch.clamp_min(hpt._sin64(t0), 1e-6)
    if chi_s.ndim == 0:
        return _trace_one(fields, chis, chi_s, t0, p0, sin_t0, nside)
    runs = [_trace_one(fields, chis, c, t0, p0, sin_t0, nside)
            for c in chi_s]
    return {k: torch.stack([r[k] for r in runs]) for k in runs[0]}


def _multiplane_impl(delta_shells, chis, dchis, chi_s, omega_m,
                     scale_factors, t0, p0, tabs, nside: int, lmax: int,
                     scan_path: bool = False):
    kaps = effective_plane_kappa(delta_shells, chis[:, None],
                                 dchis[:, None], scale_factors[:, None],
                                 omega_m)
    with _span("multiplane.fields"):
        if scan_path:
            fields = _plane_fields_healpix_scan(kaps, tabs, nside, lmax)
        else:
            fields = _plane_fields_healpix(kaps, tabs, lmax)
    with _span("multiplane.transport"):
        return _trace_multiplane(fields, chis, chi_s, t0, p0, nside)


def _multiplane_tabs(nside: int, lmax: int, method: str, device):
    """The one home of the tracer's SHT-backend selection: (tabs,
    use_scan). 'auto' takes the table-free scan backends once the scalar,
    spin-1 and two spin-2 tables would pass 256 MB (4 nlm nring floats)."""
    if method not in ("auto", "tables", "scan"):
        raise ValueError(f"method must be auto/tables/scan, got {method!r}")
    if method == "auto":
        nring = 4 * nside - 1
        nlm = (lmax + 1) * (lmax + 2) // 2
        use_scan = 4 * nlm * nring * 4 > (1 << 28)  # scalar+sp1+2*sp2
    else:
        use_scan = method == "scan"
    if use_scan:
        from .sht_large import sht_large_tables
        from .sht_spin_large import spin1_large_tables, spin2_large_tables
        tabs = (sht_large_tables(nside, lmax, device),
                spin1_large_tables(nside, lmax, device),
                spin2_large_tables(nside, lmax, device))
    else:
        from .sht import sht_tables
        from .sht_spin import spin1_tables, spin2_tables
        tabs = (sht_tables(nside, lmax, device),
                spin1_tables(nside, lmax, device),
                spin2_tables(nside, lmax, device))
    return tabs, use_scan


def multiplane_raytrace_healpix(delta_shells, chis, dchis, chi_s, omega_m,
                                lmax: Optional[int] = None,
                                scale_factors=None,
                                nside_out: Optional[int] = None,
                                method: str = "auto", device=None):
    """Full-sky post-Born ray tracing through HEALPix density shells.

    Args:
      delta_shells: (nshell, npix) density contrast, increasing chi. A
        tensor stays on its device and the maps come out there; numpy input
        goes to `device`, by default the CUDA card (it raises without one:
        pass device="cpu").
      chis, dchis: (nshell,) shell comoving distances / widths [Mpc/h].
      chi_s: source distance(s) [Mpc/h]; an array for tomography (a
        leading nsrc axis on the outputs, shells beyond each source
        masked).
      lmax: band limit of the per-shell potentials (default 2*nside, the
        unbiased-adjoint regime).
      nside_out: ray grid resolution (default: the shell nside).
      method: SHT backend of the per-shell fields: 'tables' (O(lmax^2
        nring) tables, practical to nside ~256), 'scan' (the table-free
        backends, production nside 512+), 'auto' ('scan' once the table
        sets would pass 256 MB).

    Returns a dict of (npix_out,) maps: kappa, gamma1, gamma2, omega (the
    post-Born rotation), beta_theta / beta_phi (source-plane positions).
    The single-shell limit reproduces Born (band-limited); omega is a pure
    lens-lens signal.
    """
    delta_shells = as_tensor(delta_shells, device)
    dev = delta_shells.device
    nside = hpx.npix2nside(delta_shells.shape[-1])
    L = 2 * nside if lmax is None else lmax

    def vec(v):
        return as_tensor(v, dev).to(torch.float32)

    chis, dchis = vec(chis), vec(dchis)
    scale_factors = (torch.ones_like(chis) if scale_factors is None
                     else vec(scale_factors))
    n_out = nside_out or nside
    t0, p0 = (torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in
              hpx.pix2ang_ring(n_out, np.arange(hpx.nside2npix(n_out))))
    tabs, use_scan = _multiplane_tabs(nside, L, method, dev)
    return _multiplane_impl(delta_shells, chis, dchis, vec(chi_s), omega_m,
                            scale_factors, t0, p0, tabs, nside, L,
                            scan_path=use_scan)
