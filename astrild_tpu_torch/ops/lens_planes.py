"""Lens planes from particle snapshots: the snapshot -> lightcone bridge.

Port of astrild_tpu/ops/lens_planes.py. Flat-sky density-contrast planes
are built from periodic-box particle positions, the box replicated along
the line of sight, so any snapshot feeds `ops.raytrace.multiplane_raytrace`
and `ops.lensing.born_convergence`.

Geometry: observer at (cx, cy, 0) of the (replicated) box looking along
the `los` axis; a plane at comoving distance chi_i spans fov x fov
radians; particle angular positions use the minimum transverse image
(theta = min_image(x - cx)/chi). Thin-slab approximation: every particle
in [chi_i - dchi/2, chi_i + dchi/2) is projected with the mid-plane
distance.

Two paths give the per-plane CIC counts:

- `_plane_counts_scan`, the plain version: every plane scatters the full
  particle set with an in-slab weight (`index_add_` on the flattened
  plane). It is what a CPU tensor runs.
- `_plane_counts_deposit`, what a CUDA tensor runs: the particles inside a
  plane's slab and field of view are selected first (a mask and
  `nonzero`), their four corner cells become (plane, row, col) keys, and
  the keys of a group of planes go through one call of the deposit kernel
  K1 (`paint_cuda.deposit_flat`, no sort). The slab test and the corner
  arithmetic are the scan's own, plane by plane, so the two paths agree
  particle for particle and differ only in the order of the float sums.
  The JAX package's deposit finds each particle's plane from
  floor((chi - chi_near)/dchi) over line-of-sight replicas instead, which
  rounds differently from the scan's modulo test at slab edges; its
  static-shape junk-cell parking, its TPU memory gates and its backend
  probe have no counterpart here.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import as_tensor
from . import paint_cuda

__all__ = ["density_planes_from_particles",
           "density_planes_from_particles_nrep", "replica_ranges",
           "plane_entries", "sorted_plane_entries"]

_F32 = np.float32
_span = torch.profiler.record_function


def replica_ranges(boxsize, chi0, dchi, nplanes: int, fov):
    """(n_rep, k_lo, k_hi) from the lightcone geometry.

    n_rep: transverse periodic-image count so the far plane's field of
      view is covered ((2*n_rep+1)^2 images).
    k_lo..k_hi: line-of-sight box replica indices covering
      [chi0 - dchi/2, chi0 + (nplanes - 1/2)*dchi).
    """
    chi_far = float(chi0) + float(dchi) * (nplanes - 1)
    half_need = float(fov) * chi_far / 2.0
    n_rep = max(0, int(-(-(half_need - float(boxsize) / 2.0)
                         // float(boxsize))))
    k_lo = math.floor((float(chi0) - 0.5 * float(dchi)) / float(boxsize))
    k_hi = math.floor((float(chi0) + (nplanes - 0.5) * float(dchi))
                      / float(boxsize))
    return n_rep, k_lo, k_hi


def density_planes_from_particles(pos, boxsize, chi0, dchi, nplanes: int,
                                  fov, npix: int, los: int = 2,
                                  observer_xy=None, device=None):
    """CIC-paint particles into lightcone density-contrast planes.

    Args:
      pos: comoving positions in a periodic box [Mpc/h]: an (n, 3) array
        or a (x, y, z) tuple of flat (n,) component buffers. Tensors stay
        on their device; numpy input goes to `device`, by default the CUDA
        card (it raises without one: pass device="cpu").
      boxsize: box side [Mpc/h].
      chi0: comoving distance of the FIRST plane center [Mpc/h].
      dchi: slab thickness [Mpc/h] (<= boxsize).
      nplanes: number of planes (centers chi_i = chi0 + i*dchi).
      fov: field of view [rad] (square).
      npix: plane resolution.
      los: box axis replicated along the line of sight.
      observer_xy: transverse observer position (2,) [Mpc/h]; defaults to
        the box center.

    Returns:
      (delta (nplanes, npix, npix), chis (nplanes,)): density contrast
      relative to the mean matter density (delta = Sigma/Sigma_bar - 1,
      with Sigma_bar from the box's mean density; empty cone pixels are
      -1, the convention born_convergence expects).

    Wide cones: once fov*chi exceeds the boxsize a single minimum image
    can no longer cover the field of view. The transverse replica count
    is derived from the far-plane geometry and the paint tiles
    (2*n_rep+1)^2 periodic images.
    """
    n_rep, _, _ = replica_ranges(boxsize, chi0, dchi, nplanes, fov)
    if dchi > boxsize:
        raise ValueError(
            f"dchi={dchi} exceeds boxsize={boxsize}: the periodic slab "
            "test `(z - lo) % boxsize < dchi` is then always true, so "
            "every particle paints ONCE per plane while the "
            "normalization expects dchi/boxsize periodic images; delta "
            "would be silently biased low. Use thinner planes "
            "(nplanes >= chi_far / boxsize).")
    return _density_planes_impl(pos, boxsize, chi0, dchi, nplanes, fov,
                                npix, los, observer_xy, n_rep, device)


def density_planes_from_particles_nrep(pos, boxsize, chi0, dchi,
                                       nplanes: int, fov, npix: int,
                                       los: int = 2, observer_xy=None,
                                       n_rep: int = 0, device=None):
    """Variant with an explicit transverse replica count (see
    density_planes_from_particles for the derivation of n_rep)."""
    return _density_planes_impl(pos, boxsize, chi0, dchi, nplanes, fov,
                                npix, los, observer_xy, n_rep, device)


def _split_components(pos, los: int, device=None):
    """(transverse 1, transverse 2, line of sight) flat float32 buffers."""
    if isinstance(pos, (tuple, list)):
        comps = [as_tensor(c, device).reshape(-1) for c in pos]
    else:
        arr = as_tensor(pos, device)
        comps = [arr[:, 0], arr[:, 1], arr[:, 2]]
    t_axes = [a for a in range(3) if a != los]
    return comps[t_axes[0]], comps[t_axes[1]], comps[los]


def _normalize_counts(counts, chis, n_total, boxsize, dchi, fov,
                      npix: int):
    """counts -> density contrast: delta = counts/expect - 1, expect from
    the particle count of the whole box."""
    nbar = n_total / boxsize ** 3
    pix = fov / npix
    expect = (nbar * dchi) * (chis * pix) ** 2
    return counts / expect[:, None, None] - 1.0


class _Geometry:
    """The float32 scalars both paths compute with, rounded on the host as
    the JAX package's traced float32 scalars are. The divisors (`box`,
    `pix`, each plane's `chi_mid`) are 0-d tensors on the particles'
    device: a floor follows each division, and a Python scalar divisor may
    become a multiplication by its reciprocal on the card."""

    def __init__(self, boxsize, chi0, dchi, nplanes, fov, npix,
                 observer_xy, device):
        box = _F32(boxsize)
        self.boxf = float(box)
        self.cx = float(box / _F32(2.0) if observer_xy is None
                        else _F32(observer_xy[0]))
        self.cy = float(box / _F32(2.0) if observer_xy is None
                        else _F32(observer_xy[1]))
        dchi32 = _F32(dchi)
        self.dchi = float(dchi32)
        self.chis = (_F32(chi0)
                     + dchi32 * np.arange(nplanes, dtype=np.float32))
        self.los = [float(c - dchi32 / _F32(2.0)) for c in self.chis]
        self.half = float(_F32(npix / 2.0))

        def dev(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        self.box = dev(box)
        self.pix = dev(_F32(fov) / _F32(npix))
        self.chi_mid = [dev(c) for c in self.chis]
        self.chis_t = dev(self.chis)


def _min_image(d, box):
    return d - box * torch.round(d / box)


def _cic_cells(d1, d2, g: _Geometry, plane: int, r1: int, r2: int,
               npix: int):
    """Transverse image (r1, r2) on one plane: each particle's CIC base
    cell (i0, j0) int32 and its fractions (f1, f2) within it."""
    t1 = (d1 + r1 * g.boxf) / g.chi_mid[plane]
    t2 = (d2 + r2 * g.boxf) / g.chi_mid[plane]
    c1 = t1 / g.pix + g.half - 0.5
    c2 = t2 / g.pix + g.half - 0.5
    i0 = torch.floor(c1).to(torch.int32)
    j0 = torch.floor(c2).to(torch.int32)
    return i0, j0, c1 - i0, c2 - j0


def _cic_corners(f1, f2):
    """The four CIC corners [(di, dj, weight)] from the cell fractions."""
    return [(di, dj, wi * wj)
            for di, wi in ((0, 1.0 - f1), (1, f1))
            for dj, wj in ((0, 1.0 - f2), (1, f2))]


def _in_slab(z, g: _Geometry, plane: int):
    """Periodic replication: a particle is in the slab iff its los
    coordinate modulo the box falls in [lo mod box, lo mod box + dchi)."""
    return torch.remainder(z - g.los[plane], g.boxf) < g.dchi


def _project(pos, los: int, g: _Geometry):
    """(d1, d2, z): the minimum-image transverse offsets from the observer
    and the line-of-sight coordinate wrapped into the box."""
    x_t1, x_t2, x_los = _split_components(pos, los)
    return (_min_image(x_t1 - g.cx, g.box), _min_image(x_t2 - g.cy, g.box),
            torch.remainder(x_los, g.boxf))


def _plane_counts_scan(pos, boxsize, chi0, dchi, nplanes: int, fov,
                       npix: int, los: int, observer_xy, n_rep: int,
                       weights=None):
    """Raw CIC-painted per-plane counts, plane by plane: the plain version.

    weights: optional (n,) per-particle weight (mass, or a 0/1 validity
    mask). Returns (counts (nplanes, npix, npix), chis (nplanes,))."""
    dev = _split_components(pos, los)[0].device
    g = _Geometry(boxsize, chi0, dchi, nplanes, fov, npix, observer_xy, dev)
    d1, d2, z = _project(pos, los, g)
    counts = torch.zeros((nplanes, npix * npix), dtype=torch.float32,
                         device=dev)
    for plane in range(nplanes):
        in_slab = _in_slab(z, g, plane)
        for r1 in range(-n_rep, n_rep + 1):
            for r2 in range(-n_rep, n_rep + 1):
                i0, j0, f1, f2 = _cic_cells(d1, d2, g, plane, r1, r2, npix)
                for di, dj, w in _cic_corners(f1, f2):
                    ii = i0 + di
                    jj = j0 + dj
                    ok = (in_slab & (ii >= 0) & (ii < npix)
                          & (jj >= 0) & (jj < npix))
                    if weights is not None:
                        w = w * weights
                    flat = (ii.clamp(0, npix - 1).long() * npix
                            + jj.clamp(0, npix - 1).long())
                    counts[plane].index_add_(
                        0, flat, torch.where(ok, w, torch.zeros_like(w)))
    return counts.view(nplanes, npix, npix), g.chis_t


# Card memory one (key, weight) entry takes on its way through a flush, in
# bytes: the chunk it is built in and the concatenation of the group's
# chunks (int32 key + float32 weight, twice: 16), and K1's partition of
# them by window: the first of its two levels (int32 key + float32 weight:
# 8; a flush of more than 1024 windows of 8192 cells takes two) and the
# last (uint16 offset in the window + float32 weight: 6).
_BYTES_PER_ENTRY = 30
# share of the card's free memory a group may take; the rest is left for
# the mask and coordinate temporaries (a few float32 buffers of n) and the
# fragmentation of the caching allocator
_MEM_SHARE = 0.6
# a flush stays well inside the 2^32 keys K1 takes in one call
_MAX_FLUSH_ENTRIES = 1 << 30


def _entry_budget(device, n_cells: int):
    """How many (key, weight) entries one flush may hold: the card's free
    memory now (what CUDA reports free plus what torch holds cached
    and unused), less the two n_cells-sized grids (the sum and a flush's
    deposit), times `_MEM_SHARE`, over `_BYTES_PER_ENTRY`. None (no
    limit) on the CPU."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    room = _MEM_SHARE * (free + cached) - 8 * n_cells
    return min(_MAX_FLUSH_ENTRIES, max(0, int(room // _BYTES_PER_ENTRY)))


def _plane_entries(proj, w_in, g: _Geometry, plane: int, n_rep: int,
                   npix: int, n_real: int):
    """The (keys, weights) chunks, one per corner and transverse image, of
    the particles inside one plane's slab and field of view."""
    d1, d2, z = proj
    rows = torch.nonzero(_in_slab(z, g, plane)).reshape(-1)
    s1, s2 = d1[rows], d2[rows]
    sw = None if w_in is None else w_in[rows]
    del rows
    pk, pw = [], []
    for r1 in range(-n_rep, n_rep + 1):
        for r2 in range(-n_rep, n_rep + 1):
            i0, j0, f1, f2 = _cic_cells(s1, s2, g, plane, r1, r2, npix)
            seen = torch.nonzero((i0 >= -1) & (i0 < npix)
                                 & (j0 >= -1) & (j0 < npix)).reshape(-1)
            i0, j0, f1, f2 = i0[seen], j0[seen], f1[seen], f2[seen]
            for di, dj, w in _cic_corners(f1, f2):
                ii = i0 + di
                jj = j0 + dj
                ok = (ii >= 0) & (ii < npix) & (jj >= 0) & (jj < npix)
                if sw is not None:
                    w = w * sw[seen]
                key = (plane * npix + ii.clamp(0, npix - 1)) * npix \
                    + jj.clamp(0, npix - 1)
                pk.append(torch.where(ok, key, n_real))
                pw.append(torch.where(ok, w, torch.zeros_like(w)))
    return pk, pw


def _plane_counts_deposit(pos, boxsize, chi0, dchi, nplanes: int, fov,
                          npix: int, los: int, observer_xy, n_rep: int,
                          weights=None):
    """Raw per-plane counts via deposits over (plane, row, col) keys: K1
    on a CUDA tensor, its plain version on a CPU tensor.

    For each plane the particles inside its slab are selected, then for
    each transverse image those with a corner inside the field of view;
    only they get keys (four each; a corner outside the map goes to the
    junk cell n_real with weight 0). The keys of several planes share one
    deposit: planes are added to a group until the next
    plane's entries would pass `_entry_budget`, then the group is flushed.
    A single plane whose entries alone pass the budget raises.

    Returns (counts (nplanes, npix, npix), chis (nplanes,))."""
    n_real = nplanes * npix * npix
    n_cells = n_real + 1  # + the junk cell
    if n_cells >= paint_cuda._MAX_CELLS:
        raise ValueError(
            f"lens planes: nplanes * npix^2 + 1 = {n_cells} cells do not "
            f"fit int32 keys (limit 2^31); paint fewer planes per call")
    dev = _split_components(pos, los)[0].device
    g = _Geometry(boxsize, chi0, dchi, nplanes, fov, npix, observer_xy, dev)
    with _span("planes.keys"):
        proj = _project(pos, los, g)
    w_in = None if weights is None else weights.to(torch.float32)
    budget = _entry_budget(dev, n_cells)

    flat = torch.zeros(n_cells, dtype=torch.float32, device=dev)
    keys, wts, pending = [], [], 0

    def flush():
        nonlocal keys, wts, pending
        k = torch.cat(keys) if keys else torch.zeros(
            0, dtype=torch.int32, device=dev)
        w = torch.cat(wts) if wts else torch.zeros(
            0, dtype=torch.float32, device=dev)
        keys, wts, pending = [], [], 0
        with _span("planes.flush"):
            flat.add_(paint_cuda.deposit_flat(k, w, n_cells))

    for plane in range(nplanes):
        with _span("planes.keys"):
            pk, pw = _plane_entries(proj, w_in, g, plane, n_rep, npix,
                                    n_real)
        entries = sum(k.shape[0] for k in pk)
        if budget is not None and entries > budget:
            raise RuntimeError(
                f"lens planes: plane {plane} alone holds {entries} (key, "
                f"weight) entries ((2*{n_rep}+1)^2 transverse images x 4 "
                f"corners of its in-cone particles), "
                f"{entries * _BYTES_PER_ENTRY / 1e9:.2f} GB through the "
                f"deposit, and the card has room for {budget} "
                f"({budget * _BYTES_PER_ENTRY / 1e9:.2f} GB); use thinner "
                f"planes, fewer particles or a narrower field of view")
        if keys and budget is not None and pending + entries > budget:
            flush()
        keys += pk
        wts += pw
        pending += entries
    flush()
    return flat[:n_real].view(nplanes, npix, npix), g.chis_t


def plane_entries(pos, boxsize, chi, dchi, fov, npix: int, los: int = 2,
                  observer_xy=None, n_rep: int = 0):
    """What K1 is given for the one plane centred on `chi`: the (keys,
    weights) of `_plane_counts_deposit` in the order the flush hands them
    to `paint_cuda.deposit_flat`, for timing the kernel on a plane's own
    input. Keys lie in [0, npix^2]; npix^2 is the junk cell."""
    dev = _split_components(pos, los)[0].device
    g = _Geometry(boxsize, chi, dchi, 1, fov, npix, observer_xy, dev)
    pk, pw = _plane_entries(_project(pos, los, g), None, g, 0, n_rep, npix,
                            npix * npix)
    return torch.cat(pk), torch.cat(pw)


def sorted_plane_entries(pos, boxsize, chi, dchi, fov, npix: int,
                         los: int = 2, observer_xy=None, n_rep: int = 0):
    """`plane_entries` in ascending key order (the input of
    `paint_cuda.deposit_sorted`)."""
    keys, vals = plane_entries(pos, boxsize, chi, dchi, fov, npix, los,
                               observer_xy, n_rep)
    keys, order = torch.sort(keys, stable=False)
    return keys, vals[order]


def _density_planes_impl(pos, boxsize, chi0, dchi, nplanes: int, fov,
                         npix: int, los: int, observer_xy, n_rep: int,
                         device=None):
    comps = _split_components(pos, los, device)
    n = comps[0].shape[0]
    # the layout both paths read: (x, y, z) with the los axis last
    path = (_plane_counts_deposit if comps[0].device.type == "cuda"
            else _plane_counts_scan)
    counts, chis = path(comps, boxsize, chi0, dchi, nplanes, fov, npix, 2,
                        observer_xy, n_rep)
    return _normalize_counts(counts, chis, n, boxsize, dchi, fov,
                             npix), chis
