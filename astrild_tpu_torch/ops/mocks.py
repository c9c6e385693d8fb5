"""Mock fields and catalogs: Gaussian random linear modes, Gaussian
random fields and Zel'dovich catalogs.

Port of `linear_modes`, `modes_from_white`, `gaussian_field`,
`zeldovich_catalog` and `zeldovich_catalog_with_velocities` of
astrild_tpu/ops/mocks.py. Randomness comes from an explicit
`torch.Generator` where the JAX package takes a PRNG key: the same seed
gives a different realization than JAX's. Each generator entry point is
`linear_modes` followed by a `*_from_modes` function that takes the modes
themselves, so handing both packages the same white-noise field
(`modes_from_white`) gives the same field or catalog. `lognormal_map`
draws its two white fields from a generator; `lognormal_map_from_white`
takes them, as `angular_power.cl_to_flat_map_from_white` does.
"""
from __future__ import annotations

from typing import Callable

import torch

from .._device import as_tensor
from .power import _mode_numbers
from .recon import _nyquist_masks

__all__ = ["gaussian_field", "zeldovich_catalog",
           "zeldovich_catalog_with_velocities", "lognormal_map",
           "lognormal_map_from_white"]


def modes_from_white(white, ngrid: int, boxsize, pk_fn: Callable,
                     device=None):
    """Complex linear modes FFT(delta) (unnormalized fftn convention) from
    an N(0, 1) white-noise field `white` (n, n, n): the JAX package's
    convention, <|FFT(delta)/N^3|^2> V = P(k). `pk_fn` maps a tensor of
    |k| [h/Mpc] to P(k). Numpy white noise goes to `device`, by default
    the CUDA card."""
    white = as_tensor(white, device)
    kf = 2.0 * torch.pi / boxsize
    f = _mode_numbers(ngrid, white.device)
    m2 = (f[:, None, None] ** 2 + f[None, :, None] ** 2
          + f[None, None, :] ** 2)
    p = pk_fn(torch.clamp_min(torch.sqrt(m2), 1e-6) * kf)
    p = torch.where(m2 == 0.0, torch.zeros_like(p), p)
    amp = torch.sqrt(p / boxsize ** 3) * float(ngrid) ** 3
    return torch.fft.fftn(white) / float(ngrid) ** 1.5 * amp


def linear_modes(generator: torch.Generator, ngrid: int, boxsize,
                 pk_fn: Callable, device=None):
    """`modes_from_white` of a white-noise field drawn from `generator`, on
    `device` (default: the generator's device)."""
    device = generator.device if device is None else torch.device(device)
    white = torch.randn((ngrid, ngrid, ngrid), generator=generator,
                        device=device, dtype=torch.float32)
    return modes_from_white(white, ngrid, boxsize, pk_fn)


def gaussian_field_from_modes(modes):
    """Real-space GRF delta(x) of complex linear modes (full fftn layout)."""
    return torch.fft.ifftn(modes, dim=(-3, -2, -1)).real


def gaussian_field(generator: torch.Generator, ngrid: int, boxsize,
                   pk_fn: Callable, device=None):
    """Real-space GRF delta(x) with isotropic target power pk_fn(k).

    Conventions match ops/power.py: <|FFT(delta)/N^3|^2> V = P(k). The
    same generator state gives the same realization as zeldovich_catalog
    and the LPT initial conditions (one `linear_modes` draw).
    """
    return gaussian_field_from_modes(linear_modes(generator, ngrid, boxsize,
                                                  pk_fn, device))


def _lattice(ngrid: int, boxsize, device):
    cell = boxsize / ngrid
    x = (torch.arange(ngrid, dtype=torch.float32, device=device)
         + 0.5) * cell
    return torch.stack(torch.meshgrid(x, x, x, indexing="ij"), dim=-1)


def zeldovich_catalog_from_modes(modes, ngrid: int, boxsize):
    """`zeldovich_catalog` of given complex linear modes (n, n, n)."""
    dev = modes.device
    kf = 2.0 * torch.pi / boxsize
    f = _mode_numbers(ngrid, dev)
    m2 = (f[:, None, None] ** 2 + f[None, :, None] ** 2
          + f[None, None, :] ** 2)
    k2 = m2 * kf ** 2
    k2safe = torch.where(k2 == 0.0, torch.ones_like(k2), k2)
    # lap phi = delta
    phi_k = torch.where(k2 == 0.0, torch.zeros_like(modes), -modes / k2safe)
    # psi = -grad phi; odd transfers vanish on their Nyquist plane
    mask, _ = _nyquist_masks(ngrid, dev)
    kvec = f * kf
    psi = []
    for axis in range(3):
        shape = [1, 1, 1]
        shape[axis] = ngrid
        fac = -1j * kvec.reshape(shape)
        psi.append(torch.fft.ifftn(fac * mask.reshape(shape) * phi_k,
                                   dim=(-3, -2, -1)).real)
    pos = _lattice(ngrid, boxsize, dev) + torch.stack(psi, dim=-1)
    return pos.reshape(-1, 3) % boxsize


def zeldovich_catalog(generator: torch.Generator, ngrid: int, boxsize,
                      pk_fn: Callable, device=None):
    """Particle catalog by Zel'dovich-displacing a uniform lattice.

    psi = grad(invlap(delta)) evaluated at lattice points; positions are
    lattice + psi (periodic). Returns (ngrid^3, 3) positions whose
    large-scale P(k) matches pk_fn to linear order.
    """
    return zeldovich_catalog_from_modes(
        linear_modes(generator, ngrid, boxsize, pk_fn, device), ngrid,
        boxsize)


def zeldovich_catalog_with_velocities_from_modes(modes, ngrid: int,
                                                 boxsize, growth_rate,
                                                 a_hubble: float = 100.0):
    """`zeldovich_catalog_with_velocities` of given complex linear modes."""
    pos = zeldovich_catalog_from_modes(modes, ngrid, boxsize)
    lattice = _lattice(ngrid, boxsize, pos.device).reshape(-1, 3)
    # psi = (pos - lattice) with the periodic wrap undone
    psi = pos - lattice
    box = torch.tensor(float(boxsize), device=pos.device)
    psi = psi - box * torch.round(psi / box)
    # a H f as the JAX package forms it: a float32 product
    ahf = (torch.tensor(float(a_hubble), device=pos.device)
           * torch.tensor(float(growth_rate), device=pos.device))
    return pos, ahf * psi


def zeldovich_catalog_with_velocities(generator: torch.Generator,
                                      ngrid: int, boxsize, pk_fn,
                                      growth_rate, a_hubble: float = 100.0,
                                      device=None):
    """Zel'dovich catalog with dynamically consistent peculiar velocities.

    In the Zel'dovich approximation v = a H(a) f psi; with psi in comoving
    Mpc/h and a_hubble = a H(a) in km/s/(Mpc/h) (100 at z=0, matching
    ops.tpcf.to_redshift_space's s = x + v/100), the redshift-space field
    obeys Kaiser with beta = growth_rate to linear order.

    Returns (pos (n,3) [Mpc/h], vel (n,3) [km/s]).
    """
    return zeldovich_catalog_with_velocities_from_modes(
        linear_modes(generator, ngrid, boxsize, pk_fn, device), ngrid,
        boxsize, growth_rate, a_hubble)


def lognormal_map_from_white(re, im, npix: int, opening_angle_deg,
                             cl_tab_ell, cl_tab_val, device=None):
    """`lognormal_map` of the two (npix, npix) N(0, 1) fields of
    `angular_power.cl_to_flat_map_from_white`: exp(g - var(g) / 2) - 1 of
    the Gaussian map g (population variance, jnp.var's), so delta > -1.
    Placed as cl_to_flat_map_from_white places its map."""
    from .angular_power import cl_to_flat_map_from_white

    g = cl_to_flat_map_from_white(re, im, cl_tab_ell, cl_tab_val, npix,
                                  opening_angle_deg, device=device)
    var = torch.var(g, correction=0)
    return torch.exp(g - var / 2.0) - 1.0


def lognormal_map(generator: torch.Generator, npix: int, opening_angle_deg,
                  cl_tab_ell, cl_tab_val, device=None):
    """Lognormal (positive-definite) flat-sky map from a Cl table: its two
    white fields drawn from `generator` (re first, then im, as
    cl_to_flat_map draws them) on `device` (default: the generator's
    device)."""
    dev = generator.device if device is None else torch.device(device)
    re = torch.randn((npix, npix), generator=generator, device=dev,
                     dtype=torch.float32)
    im = torch.randn((npix, npix), generator=generator, device=dev,
                     dtype=torch.float32)
    return lognormal_map_from_white(re, im, npix, opening_angle_deg,
                                    cl_tab_ell, cl_tab_val)
