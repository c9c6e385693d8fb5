"""Strong-lensing map utilities on torch tensors: SPH surface-density
painting, bilinear image remapping, stencil shear, the triangle-mapping
image finder, the Fermat potential and time delays.

Port of astrild_tpu/ops/strong_lensing.py, whole. The SPH deposit is a
plain `index_add_` per smoothing-length bucket (an XLA scatter in the JAX
package), each bucket smoothed by one FFT with a Gaussian of the bucket's
mean width. `jnp.gradient` is `minkowski._gradient` (central
differences inside, one-sided at the edges, divided by the spacing as a
float32 tensor); a jitted division by a constant is a product by its
float32 reciprocal, as XLA compiles it; the image finder ranks its hits
with stable sorts, as the JAX package's `argsort(~inside, stable=True)`.
Numpy input goes to `device`, by default the CUDA card (it raises without
one); tensors keep their device.
"""
from __future__ import annotations

import math

import torch

from .._device import as_tensor
from .filters import _f32, _fftfreq
from .minkowski import _gradient

__all__ = ["sph_surface_density", "remap_image", "shear_from_potential",
           "mapping_triangles", "fermat_potential", "time_delay_days"]


def sph_surface_density(pos2d, mass, hsml, npix: int, boxsize,
                        n_buckets: int = 4, device=None):
    """Project particles to a surface-density map with per-particle
    smoothing: particles are NGP-deposited per smoothing-length bucket
    (n_buckets log-spaced hsml classes), each bucket convolved with a
    Gaussian of its mean width (one FFT per bucket). A Gaussian of width h
    stands in for the cubic spline; raise n_buckets when hsml spans a wide
    range.

    Args:
      pos2d: (n, 2) positions in [0, boxsize).
      mass: (n,) masses.
      hsml: (n,) smoothing lengths (same units as boxsize).
    Returns (npix, npix) mass per unit area.
    """
    pos2d = as_tensor(pos2d, device)
    dev = pos2d.device
    mass = as_tensor(mass, dev)
    hsml = as_tensor(hsml, dev)
    ds = _f32(boxsize, dev) * _f32(1.0 / npix, dev)
    i = torch.remainder(torch.floor(pos2d / ds).to(torch.int32), npix)
    flat = i[:, 0].to(torch.int64) * npix + i[:, 1]
    h = torch.clamp(hsml, 1e-3 * ds, _f32(boxsize, dev) / 4.0)
    lh = torch.log(h)
    lo = lh.min()
    hi = lh.max() + 1e-6
    # the bucket is a decision: a division by a tensor (not a product by a
    # reciprocal), then the float -> int32 cast
    bucket = torch.clamp(((lh - lo) / (hi - lo) * n_buckets).to(torch.int32),
                         0, n_buckets - 1)
    k = _fftfreq(npix, dev) * 2.0 * math.pi / ds
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    zero = torch.zeros((), dtype=mass.dtype, device=dev)
    out = torch.zeros((npix, npix), device=dev)
    for b in range(n_buckets):
        sel = bucket == b
        wsum = torch.where(sel, mass, zero).sum()
        dep = torch.zeros(npix * npix, device=dev)
        dep.index_add_(0, flat, torch.where(sel, mass, zero))
        dep = dep.reshape(npix, npix)
        hb = torch.exp(torch.where(sel, lh, zero).sum()
                       / torch.clamp_min(sel.sum(), 1))
        transfer = torch.exp(-0.5 * (hb ** 2) * k2)
        sm = torch.fft.ifft2(torch.fft.fft2(dep) * transfer).real
        out = out + torch.where(wsum > 0, 1.0, 0.0) * sm
    return out / ds ** 2


def remap_image(img, coord1, coord2, device=None):
    """Sample `img` at fractional pixel coordinates (bilinear): coord1 /
    coord2 index axis 0 / axis 1; out-of-range coordinates clamp to the
    border. Also the flat-sky lensed-image operator:
      lensed = remap_image(unlensed, X + alpha1/ds, Y + alpha2/ds).
    """
    img = as_tensor(img, device)
    dev = img.device
    coord1 = as_tensor(coord1, dev)
    coord2 = as_tensor(coord2, dev)
    n0, n1 = img.shape[-2], img.shape[-1]
    c1 = torch.clamp(coord1, 0.0, n0 - 1.0)
    c2 = torch.clamp(coord2, 0.0, n1 - 1.0)
    i0 = torch.clamp(torch.floor(c1).to(torch.int32), 0, n0 - 2).long()
    j0 = torch.clamp(torch.floor(c2).to(torch.int32), 0, n1 - 2).long()
    f1 = c1 - i0
    f2 = c2 - j0
    v00 = img[i0, j0]
    v01 = img[i0, j0 + 1]
    v10 = img[i0 + 1, j0]
    v11 = img[i0 + 1, j0 + 1]
    return ((1 - f1) * (1 - f2) * v00 + (1 - f1) * f2 * v01
            + f1 * (1 - f2) * v10 + f1 * f2 * v11)


def shear_from_potential(phi, opening_angle, device=None):
    """kappa, gamma1, gamma2 from the lensing potential by second
    derivatives (jnp.gradient's differences, pixel size opening_angle / n
    in float32):
      kappa  = (phi_11 + phi_22)/2
      gamma1 = (phi_11 - phi_22)/2 ; gamma2 = phi_12
    """
    phi = as_tensor(phi, device)
    dev = phi.device
    n = phi.shape[-1]
    ds = _f32(opening_angle, dev) * _f32(1.0 / n, dev)
    d1 = _gradient(phi, ds, 0)
    d2 = _gradient(phi, ds, 1)
    p11 = _gradient(d1, ds, 0)
    p22 = _gradient(d2, ds, 1)
    p12 = _gradient(d1, ds, 1)
    return 0.5 * (p11 + p22), 0.5 * (p11 - p22), p12


def _solve_tri(sy1, sy2, p1, p2, q1, q2, r1, r2, X1, X2, Y1, Y2, Z1, Z2):
    """Barycentric solve of the source inside source-plane triangle
    (p, q, r); (X, Y, Z) are the matching image-plane vertices."""
    det = (q2 - r2) * (p1 - r1) + (r1 - q1) * (p2 - r2)
    ok = torch.abs(det) > 1e-30
    safe = torch.where(ok, det, torch.ones_like(det))
    w1 = ((q2 - r2) * (sy1 - r1) + (r1 - q1) * (sy2 - r2)) / safe
    w2 = ((r2 - p2) * (sy1 - r1) + (p1 - r1) * (sy2 - r2)) / safe
    w3 = 1.0 - w1 - w2
    inside = (w1 >= 0) & (w2 >= 0) & (w3 >= 0) & ok
    i1 = w1 * X1 + w2 * Y1 + w3 * Z1
    i2 = w1 * X2 + w2 * Y2 + w3 * Z2
    # signed magnification = image-triangle area / source-triangle area
    det_img = (Y2 - Z2) * (X1 - Z1) + (Z1 - Y1) * (X2 - Z2)
    return inside, i1, i2, det_img / safe


def _stable_first(mask):
    """Indices that put the True entries of `mask` first, each group in
    its own order (argsort of ~mask, stable)."""
    return torch.sort((~mask).to(torch.int32), stable=True).indices


def mapping_triangles(src_pos, x1, x2, y1, y2, max_images: int = 40,
                      device=None):
    """Image-plane root finding by triangle mapping (lensed-image finder).

    Each grid cell of the image plane is split into two triangles whose
    vertices map to the source plane through (y1, y2), the deflected
    coordinates (y = x - alpha). A triangle whose source-plane footprint
    contains `src_pos` holds one lensed image, at the barycentric
    interpolation of its image-plane vertices. Vectorized over all
    2 (n-1)^2 triangles.

    Args:
      src_pos: (2,) source position (y1, y2).
      x1, x2: (n, n) image-plane coordinate grids.
      y1, y2: (n, n) source-plane coordinates of each image-plane node.
      max_images: output slots.

    Returns (img1, img2, mag, n_found): (max_images,) tensors padded with
    -99999.0 beyond n_found (a 0-d int32 tensor); `mag` is the signed
    magnification of each image. Hits closer than 1.5 grid cells to an
    earlier hit are merged into it (a source on a shared edge is claimed
    by both triangles).
    """
    x1 = as_tensor(x1, device)
    dev = x1.device
    x2, y1, y2 = (as_tensor(a, dev) for a in (x2, y1, y2))
    src = as_tensor(src_pos, dev)
    fail = -99999.0
    sy1, sy2 = src[0], src[1]

    def corners(a):
        return (a[:-1, :-1].reshape(-1), a[1:, :-1].reshape(-1),
                a[:-1, 1:].reshape(-1), a[1:, 1:].reshape(-1))

    x1a, x1b, x1c, x1d = corners(x1)
    x2a, x2b, x2c, x2d = corners(x2)
    y1a, y1b, y1c, y1d = corners(y1)
    y2a, y2b, y2c, y2d = corners(y2)
    in_a, i1_a, i2_a, m_a = _solve_tri(sy1, sy2, y1a, y2a, y1b, y2b, y1d,
                                       y2d, x1a, x2a, x1b, x2b, x1d, x2d)
    in_b, i1_b, i2_b, m_b = _solve_tri(sy1, sy2, y1a, y2a, y1c, y2c, y1d,
                                       y2d, x1a, x2a, x1c, x2c, x1d, x2d)
    inside = torch.cat([in_a, in_b])
    i1 = torch.cat([i1_a, i1_b])
    i2 = torch.cat([i2_a, i2_b])
    mag = torch.cat([m_a, m_b])
    # rank hits first (stable), take max_images slots
    order = _stable_first(inside)[:max_images]
    got = inside[order]
    fill = torch.full((order.shape[0],), fail, device=dev)
    img1 = torch.where(got, i1[order], fill)
    img2 = torch.where(got, i2[order], fill)
    mags = torch.where(got, mag[order], fill)
    # merge hits closer than 1.5 grid cells, keeping the first
    cell = (x1.max() - x1.min()) * _f32(1.0 / (x1.shape[0] - 1), dev)
    d2 = ((img1[:, None] - img1[None, :]) ** 2
          + (img2[:, None] - img2[None, :]) ** 2)
    idx = torch.arange(order.shape[0], device=dev)
    earlier = idx[None, :] < idx[:, None]
    both = got[:, None] & got[None, :]
    dup = torch.any((d2 < (1.5 * cell) ** 2) & earlier & both, dim=1)
    keep = got & ~dup
    # compact the survivors to the front
    order2 = _stable_first(keep)
    kept = keep[order2]
    return (torch.where(kept, img1[order2], fill),
            torch.where(kept, img2[order2], fill),
            torch.where(kept, mags[order2], fill),
            keep.to(torch.int32).sum())


def fermat_potential(kappa, opening_angle, beta, device=None):
    """Fermat potential surface tau_hat(theta) = |theta - beta|^2/2 - psi,
    psi solving lap psi = 2 kappa on the patch (ops.lensing.kappa_to_phi);
    lensed images are its stationary points.

    Args:
      kappa: (n, n) convergence.
      opening_angle: patch side [rad].
      beta: (2,) source position [rad], axis-0/axis-1 order.
    Returns (n, n) tau_hat in rad^2.
    """
    from .lensing import kappa_to_phi

    kappa = as_tensor(kappa, device)
    dev = kappa.device
    beta = as_tensor(beta, dev)
    n = kappa.shape[-1]
    psi = kappa_to_phi(kappa, opening_angle)
    t = (torch.arange(n, device=dev).to(torch.float32) + 0.5) * _f32(
        opening_angle / n, dev)
    th1, th2 = torch.meshgrid(t, t, indexing="ij")
    return 0.5 * ((th1 - beta[0]) ** 2 + (th2 - beta[1]) ** 2) - psi


def time_delay_days(tau_hat, z_lens, d_l, d_s, d_ls, device=None):
    """Fermat-potential values [rad^2] to light travel-time delays in days:
    tau = (1+z_l) (D_l D_s / D_ls) tau_hat / c, with ANGULAR-DIAMETER
    distances [Mpc/h] (delays in h^-1 days)."""
    from ..utils.constants import C_LIGHT_KMS, MPC_KM

    dist = (1.0 + z_lens) * d_l * d_s / d_ls  # [Mpc/h]
    seconds = dist * MPC_KM / C_LIGHT_KMS
    return as_tensor(tau_hat, device) * seconds / 86400.0
