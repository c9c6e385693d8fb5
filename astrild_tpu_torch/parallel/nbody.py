"""Distributed PM N-body over the device mesh.

Port of astrild_tpu/parallel/nbody.py. The force solve is the
single-device ops.nbody chain mapped onto the mesh: particles are row
blocks over every mesh axis, each rank paints a full local grid (the
windowed painter K2 on a CUDA block, through ops.paint.paint), the
paints of a 'sim' axis `psum`, `psum_scatter` over 'x' then 'y' reduces
and re-pencils the grid, the pencil FFT of parallel/pfft gives the
Poisson and gradient transfers in TRANSPOSED_OUT layout, the inverse
pencil FFT brings the three force grids back, and one `all_gather` per
axis rebuilds the full grids for each rank's trilinear readout. An axis
of size 1 issues no collective (the JAX guards px > 1, py > 1), so a
world of one runs the single-device chain with a c2c pencil FFT.

Every step is an out-of-place torch operation and every collective an
autograd node, so parallel/field_infer differentiates straight through
`pm_scan_body`: on the card the paints' backward is K2's hand-written
adjoint (deposit=None). The JAX package forces deposit="scatter" there
(its painter has no transpose rule); "scatter" stays accepted.

The readout's all_gather makes a rank's grid memory O(n^3), as in JAX:
the right trade at PM grid sizes, keeping the particles free of any
spatial order (loaders feed blocks in file order).
"""
from __future__ import annotations

import torch

from ..ops.nbody import _a_edges, _am2_edges, _factors_from_edges
from ..ops.paint import paint as paint_single
from ..ops.recon import sample_displacement
from .mesh import all_gather, axis_size, psum, psum_scatter, to_mesh
from .pfft import local_kvecs, pfft3d_local, pifft3d_local
from .power import _local_compensation, local_mode_numbers

__all__ = ["make_distributed_pm_evolve", "pm_scan_body"]


def _reduce_repencil(grid, mesh, ax: str, ay: str):
    """A full local grid summed over the ranks of (ax, ay), this rank's
    pencil (n/PX, n/PY, n) kept."""
    if axis_size(mesh, ax) > 1:
        grid = psum_scatter(grid, mesh, ax, 0)
    if axis_size(mesh, ay) > 1:
        grid = psum_scatter(grid, mesh, ay, 1)
    return grid


def _contrast(grid, mesh, ngrid: int, ax: str, ay: str):
    """delta = grid / mean - 1 with the global mean (a psum of the
    pencils' float32 sums, as JAX)."""
    mean = psum(grid.sum(), mesh, (ax, ay)) / float(ngrid) ** 3
    return grid / torch.where(mean == 0, torch.ones_like(mean), mean) - 1.0


def _local_force_grids(comps, ngrid: int, boxsize, om0, window: str, am2,
                       mesh, ax: str = "x", ay: str = "y", extra_axes=(),
                       deposit=None):
    """Force grids (3, n, n, n), full on every rank.

    Mirrors ops.nbody._force_grids (one window deconvolution of the
    painted density, Nyquist-masked spectral gradients, linearized-f(R)
    Geff) in pencil layout. extra_axes: mesh axes the particles are
    additionally split over ('sim' when one box spans the whole mesh),
    whose paints psum into the shared grid.
    """
    dev = comps[0].device
    grid = paint_single(comps, ngrid, boxsize, window=window,
                        deposit=deposit)
    if extra_axes:
        grid = psum(grid, mesh, extra_axes)
    delta = _contrast(_reduce_repencil(grid, mesh, ax, ay), mesh, ngrid,
                      ax, ay)
    kv = local_kvecs(ngrid, boxsize, mesh, ax, ay, device=dev)
    dk = pfft3d_local(delta, mesh, ax, ay) / float(ngrid) ** 3
    dk = dk * _local_compensation(*kv, ngrid, boxsize, window)
    ki, kj, kk = kv
    k2 = ki ** 2 + kj ** 2 + kk ** 2
    k2safe = torch.where(k2 == 0.0, torch.ones_like(k2), k2)
    geff = 1.0 + k2 / (3.0 * (k2 + am2))
    phik = torch.where(k2 == 0.0, torch.zeros_like(dk),
                       -1.5 * om0 * geff * dk / k2safe)
    half = ngrid // 2
    grids = []
    for k, m in zip(kv, local_mode_numbers(ngrid, mesh, ax, ay,
                                           device=dev)):
        mask = (m.abs() != half).to(torch.float32)
        grids.append(pifft3d_local(-1j * k * mask * phik, mesh, ax, ay).real
                     * float(ngrid) ** 3)
    # stack, then one gather an axis for the three grids
    f = torch.stack(grids)
    if axis_size(mesh, ax) > 1:
        f = all_gather(f, mesh, ax, 1)
    if axis_size(mesh, ay) > 1:
        f = all_gather(f, mesh, ay, 2)
    return f


def pm_scan_body(comps, mom, factors, am2_edges, *, mesh, ngrid: int,
                 boxsize, om0, window: str, ax: str = "x", ay: str = "y",
                 extra_axes=(), deposit=None):
    """The KDK leapfrog on this rank's particle block, shared by the
    distributed PM evolver and the distributed field inference: one force
    evaluation, then per row of `factors` (kick, drift, kick) a kick, a
    periodic drift, a force evaluation and a kick. factors / am2_edges are
    host floats. Out of place, so autograd follows it."""
    def force(c, am2):
        grids = _local_force_grids(c, ngrid, boxsize, om0, window, am2,
                                   mesh, ax=ax, ay=ay,
                                   extra_axes=extra_axes, deposit=deposit)
        return sample_displacement(grids, boxsize, c)

    frc = force(comps, am2_edges[0])
    for (k1, dr, k2), am2 in zip(factors, am2_edges[1:]):
        mom = tuple(torch.add(p, f, alpha=k1) for p, f in zip(mom, frc))
        comps = tuple(torch.add(c, p, alpha=dr).remainder(boxsize)
                      for c, p in zip(comps, mom))
        frc = force(comps, am2)
        mom = tuple(torch.add(p, f, alpha=k2) for p, f in zip(mom, frc))
    return comps, mom


def make_distributed_pm_evolve(mesh, ngrid: int, boxsize: float, cosmo,
                               nsteps: int, window: str = "cic",
                               spacing: str = "loga", deposit=None):
    """A distributed KDK evolver over `mesh`.

    Returns evolve(comps, mom, a_init, a_final) -> (comps, mom): this
    rank's (x, y, z) / (px, py, pz) flat blocks of the particles split
    over all mesh axes (the layout ops.nbody.pm_evolve uses locally and
    the multihost loaders produce). One box spans the whole mesh: a 'sim'
    axis only holds more particle blocks, whose paints psum. The KDK
    integrals are computed on the host per call. Gravity follows
    cosmo.fR0 as in ops.nbody.pm_evolve (am2 = inf is exact GR).
    deposit: the paints' route (None: K2 on a CUDA block; 'scatter').
    """
    om0 = float(cosmo.Om0)

    def evolve(comps, mom, a_init: float, a_final: float):
        comps = tuple(c.reshape(-1).to(torch.float32)
                      for c in to_mesh(tuple(comps), mesh))
        mom = tuple(p.reshape(-1).to(torch.float32)
                    for p in to_mesh(tuple(mom), mesh))
        edges = _a_edges(a_init, a_final, nsteps, spacing)
        factors = _factors_from_edges(cosmo, edges, spacing=spacing)
        with torch.no_grad():
            return pm_scan_body(comps, mom, factors.tolist(),
                                _am2_edges(cosmo, edges).tolist(),
                                mesh=mesh, ngrid=ngrid,
                                boxsize=float(boxsize), om0=om0,
                                window=window, extra_axes=("sim",),
                                deposit=deposit)

    evolve.nsteps = nsteps
    return evolve

