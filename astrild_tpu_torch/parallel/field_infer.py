"""Distributed differentiable field-level inference over the device mesh.

Port of astrild_tpu/parallel/field_infer.py. The forward model (whitened
field -> linear modes -> 2LPT ICs -> KDK PM -> CIC overdensity ->
Gaussian posterior) runs on this rank's pencil block of the pencil axes
(ax, ay): the white field and the data are split (ax, ay, None), every
FFT is the pencil FFT (parallel/pfft), and the PM loop is the same
`parallel.nbody.pm_scan_body` the distributed evolver runs. Autograd
differentiates straight through it: the paints' backward is K2's
hand-written adjoint on a CUDA block (deposit=None; the JAX package
forces "scatter" because its painter has no transpose rule, and
"scatter" stays accepted), and the collectives' backward are the
explicit rules of parallel/mesh.py, so the gradient comes back split like
the white field.

The loss is psum(local posterior terms). Its gradient follows mesh.py's
psum rule: `value_and_grad` differentiates this rank's local term and
psums its value; differentiating the psum'd loss with every rank seeding
1 would multiply the gradient by the number of ranks.

Conventions are the single-device chain's (ops.mocks.modes_from_white
amplitudes, ops.nbody 2LPT / KDK operators, Nyquist-masked spectral
gradients). Ranks that differ only in other mesh axes ('sim') repeat the
same work.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from ..ops.field_infer import _check_window, _gauss_posterior, _host_consts
from ..ops.paint import paint as paint_single
from .mesh import axis_index, axis_size, psum, to_mesh
from .nbody import _contrast, _reduce_repencil, pm_scan_body
from .pfft import local_kvecs, pfft3d_local, pifft3d_local
from .power import local_mode_numbers

__all__ = ["make_distributed_field_infer"]


def _local_modes_from_white(white_block, ngrid: int, boxsize,
                            pk_fn: Callable, mesh, ax: str, ay: str):
    """Pencil twin of mocks.modes_from_white: (n/PX, n/PY, n) white ->
    TRANSPOSED_OUT (n, n/PX, n/PY) linear modes (unnormalized fftn
    convention, the same amplitudes)."""
    wk = pfft3d_local(white_block, mesh, ax, ay)
    mi, mj, mk = local_mode_numbers(ngrid, mesh, ax, ay,
                                    device=white_block.device)
    m2 = mi ** 2 + mj ** 2 + mk ** 2
    kf = 2.0 * math.pi / boxsize
    p = pk_fn(torch.clamp_min(torch.sqrt(m2), 1e-6) * kf)
    p = torch.where(m2 == 0.0, torch.zeros_like(p), p)
    amp = torch.sqrt(p / boxsize ** 3) * float(ngrid) ** 3
    return wk / float(ngrid) ** 1.5 * amp


def _k2_safe(kv):
    ki, kj, kk = kv
    k2 = ki ** 2 + kj ** 2 + kk ** 2
    return k2, torch.where(k2 == 0.0, torch.ones_like(k2), k2)


def _local_grad_invlap(field_k, ngrid: int, boxsize, sign: float, mesh,
                       ax: str, ay: str):
    """Pencil twin of ops.nbody._grad_invlap: TRANSPOSED_OUT field_k -> 3
    real displacement blocks, each (n/PX, n/PY, n)."""
    dev = field_k.device
    kv = local_kvecs(ngrid, boxsize, mesh, ax, ay, device=dev)
    k2, k2safe = _k2_safe(kv)
    phi_k = torch.where(k2 == 0.0, torch.zeros_like(field_k),
                        -field_k / k2safe)
    half = ngrid // 2
    out = []
    for k, m in zip(kv, local_mode_numbers(ngrid, mesh, ax, ay,
                                           device=dev)):
        mask = (m.abs() != half).to(torch.float32)
        out.append(pifft3d_local(sign * 1j * k * mask * phi_k, mesh, ax,
                                 ay).real)
    return out


def _local_second_order_source(dk, ngrid: int, boxsize, mesh, ax: str,
                               ay: str):
    """Pencil twin of ops.nbody._second_order_source (the real S2
    block)."""
    kv = local_kvecs(ngrid, boxsize, mesh, ax, ay, device=dk.device)
    k2, k2safe = _k2_safe(kv)
    t = torch.where(k2 == 0.0, torch.zeros_like(dk), dk / k2safe)

    def d2(a, b):
        return pifft3d_local(a * b * t, mesh, ax, ay).real

    ki, kj, kk = kv
    dxx, dyy, dzz = d2(ki, ki), d2(kj, kj), d2(kk, kk)
    dxy, dxz, dyz = d2(ki, kj), d2(ki, kk), d2(kj, kk)
    return (dxx * dyy + dxx * dzz + dyy * dzz
            - dxy ** 2 - dxz ** 2 - dyz ** 2)


def _local_lattice(ngrid: int, boxsize, mesh, ax: str, ay: str, dev):
    """Lattice site coordinates of this rank's (n/PX, n/PY, n) block
    (axis 0 the i-chunk of its x index, axis 1 the j-chunk of its y
    index), flat."""
    ni, nj = ngrid // axis_size(mesh, ax), ngrid // axis_size(mesh, ay)
    cell = boxsize / ngrid

    def coord(lo, n):
        return (lo + torch.arange(n, dtype=torch.float32, device=dev)
                + 0.5) * cell

    ii = coord(axis_index(mesh, ax) * ni, ni)
    jj = coord(axis_index(mesh, ay) * nj, nj)
    kk = coord(0, ngrid)
    shape = (ni, nj, ngrid)
    return tuple(g.expand(shape).reshape(-1) for g in (
        ii[:, None, None], jj[None, :, None], kk[None, None, :]))


class DistributedFieldInfer:
    """simulate, loss and value_and_grad on this rank's pencil blocks (see
    make_distributed_field_infer)."""

    def __init__(self, simulate, loss, value_and_grad):
        self.simulate = simulate
        self.loss = loss
        self.value_and_grad = value_and_grad


def make_distributed_field_infer(mesh, ngrid: int, boxsize,
                                 pk_fn: Callable, cosmo, *,
                                 z_init: float = 9.0, nsteps: int = 3,
                                 a_final: float = 1.0, window: str = "cic",
                                 order: int = 2, ax: str = "x",
                                 ay: str = "y", deposit=None):
    """The sharded forward model and its differentiable posterior.

    Returns an object with three callables on this rank's blocks:
      simulate(white) -> delta, both (n/PX, n/PY, n) blocks of (ax, ay,
        None);
      loss(white, data, noise_var) -> the posterior, replicated;
      value_and_grad(white, data, noise_var) -> (value, grad): the
        replicated posterior and its gradient, this rank's block.
    Numpy input goes to the mesh's device. The cosmology is evaluated on
    the host once, here. deposit: the paints' route (None: K2 forward and
    its adjoint backward on a CUDA block; 'scatter').
    """
    _check_window(window)
    growth, factors, am2, om0 = _host_consts(cosmo, z_init, a_final,
                                             nsteps, order)
    d1, f1, d2g, f2, e_init = growth
    a0 = 1.0 / (1.0 + z_init)
    factors, am2 = factors.tolist(), am2.tolist()

    def sim_body(white_block):
        dev = white_block.device
        dk = _local_modes_from_white(white_block, ngrid, boxsize, pk_fn,
                                     mesh, ax, ay)
        psi1 = _local_grad_invlap(dk, ngrid, boxsize, -1.0, mesh, ax, ay)
        s2 = _local_second_order_source(dk, ngrid, boxsize, mesh, ax, ay)
        psi2 = _local_grad_invlap(pfft3d_local(s2, mesh, ax, ay), ngrid,
                                  boxsize, +1.0, mesh, ax, ay)
        q = _local_lattice(ngrid, boxsize, mesh, ax, ay, dev)
        comps = tuple(torch.remainder(
            q[i] + (d1 * psi1[i] + d2g * psi2[i]).reshape(-1), boxsize)
            for i in range(3))
        mom = tuple(((a0 * a0 * e_init)
                     * (f1 * d1 * psi1[i] + f2 * d2g * psi2[i])).reshape(-1)
                    for i in range(3))
        comps, _ = pm_scan_body(comps, mom, factors, am2, mesh=mesh,
                                ngrid=ngrid, boxsize=float(boxsize),
                                om0=om0, window=window, ax=ax, ay=ay,
                                deposit=deposit)
        # the final density: a local paint, reduced and re-penciled to the
        # white field's own (ax, ay, None) split
        grid = paint_single(comps, ngrid, boxsize, window=window,
                            deposit=deposit)
        return _contrast(_reduce_repencil(grid, mesh, ax, ay), mesh, ngrid,
                         ax, ay)

    def local_term(white_block, data_block, noise_var):
        return _gauss_posterior(sim_body(white_block), data_block,
                                noise_var, white_block)

    def inputs(white, data=None):
        white = to_mesh(white, mesh).to(torch.float32)
        if data is None:
            return white
        return white, to_mesh(data, mesh).to(torch.float32)

    def simulate(white):
        with torch.no_grad():
            return sim_body(inputs(white))

    def loss(white, data, noise_var):
        with torch.no_grad():
            return psum(local_term(*inputs(white, data), noise_var), mesh,
                        (ax, ay))

    def value_and_grad(white, data, noise_var):
        white, data = inputs(white, data)
        white = white.detach().requires_grad_(True)
        with torch.enable_grad():
            local = local_term(white, data, noise_var)
            (grad,) = torch.autograd.grad(local, white)
        return psum(local.detach(), mesh, (ax, ay)), grad

    return DistributedFieldInfer(simulate, loss, value_and_grad)
