"""Full-sky lightcone lensing: HEALPix density shells from particle
snapshots and Born convergence on the sphere.

Port of `shell_counts_healpix`, `shell_overdensity`,
`density_shells_healpix` and `born_convergence_healpix` of
astrild_tpu/ops/lightcone_sphere.py: particles -> spherical density shells
(a deposit over (shell, pixel) keys: the kernel K1,
`paint_cuda.deposit_flat`, on a CUDA tensor) -> Born kappa.

Each periodic image of the box is painted in turn. The particles of an
image that fall into a shell are selected first (a mask and `nonzero`)
and only they get keys; the JAX package, whose shapes are static, gives
every particle a key and parks the others on a junk cell. The images'
keys are gathered into groups that share one deposit; a group
is flushed when the next image's keys would pass the card's room for them
(`lens_planes._entry_budget`).

Not ported yet: `multiplane_raytrace_healpix` (it needs the spin-1
transforms and the torch HEALPix interpolation stencil, ROADMAP.md queue 1
item 6b).
"""
from __future__ import annotations

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


def multiplane_raytrace_healpix(delta_shells, chis, dchis, chi_s, omega_m,
                                lmax: Optional[int] = None,
                                scale_factors=None,
                                nside_out: Optional[int] = None,
                                method: str = "auto"):
    """Full-sky post-Born ray tracing through HEALPix density shells: not
    ported yet."""
    raise NotImplementedError(
        "multiplane_raytrace_healpix needs the spin-1 spherical harmonic "
        "transforms (ops/sht_spin.py, sht_spin_large.py) and the torch "
        "HEALPix interpolation stencil, which are not ported yet "
        "(ROADMAP.md queue 1 item 6b); born_convergence_healpix gives the "
        "Born-level kappa")
