"""Particle-mesh N-body: 2LPT initial conditions + KDK leapfrog evolution.

Port of astrild_tpu/ops/nbody.py (the forward model: a linear P(k) becomes
a nonlinear particle snapshot). The JAX package's `lax.scan` time loop is a
plain Python loop here; each step paints the particles (`ops.paint.paint`,
which sends CIC/TSC on the card through the windowed kernel K2), solves
Poisson's equation with FFTs and gathers the forces back trilinearly
(`ops.recon.sample_displacement`). `pm_evolve` updates its own copies of
the particle buffers in place; the caller's tensors are left untouched.

Randomness comes from an explicit `torch.Generator` where the JAX package
takes a PRNG key (`lpt_catalog`, `pm_catalog`): the same seed gives a
different realization than JAX's. The `*_from_modes` entry points take the
linear modes themselves, so both packages can start from the same numpy
field.

Conventions (t in units of 1/H0, comoving lengths in Mpc/h):
  momentum        p = a^2 dx/dt                     [Mpc/h]
  kick            dp = F_hat * da / (a^2 E(a)),     grad^2 phi_hat =
                  F_hat = -grad phi_hat             (3/2) Om0 delta
  drift           dx = p * da / (a^3 E(a))
  peculiar vel    v [km/s] = 100 * p / a
2LPT displacement (Bouchet et al. 1995):
  x = q + D1 psi1 + D2 psi2,  psi1 = -grad invlap(delta),
  psi2 = +grad invlap(S2),    D2 = -(3/7) D1^2 Om(z)^(-1/143),
  S2 = sum_{i<j} [phi,ii phi,jj - phi,ij^2],  f2 = 2 Om(z)^(6/11).

`pm_lightcone_planes` carries the evolution on to a lightcone: the
snapshot is evolved to each lens plane's own redshift and painted there
(`ops.lens_planes.density_planes_from_particles`, whose keys go through
the windowed deposit K1 on the card). `pm_evolve_checkpointed` and the
lightcone's `ckpt_dir` save their state through `core.checkpoint`, in the
JAX package's npz layout, and resume from it.
"""
from __future__ import annotations

import hashlib
import math
from typing import Callable

import numpy as np
import torch

from .._device import as_points, as_tensor
from .lens_planes import density_planes_from_particles
from .mocks import linear_modes
from .paint import paint
from .power import _mode_numbers
from .power import delta_k as _delta_k
from .recon import sample_displacement

__all__ = ["lpt_displacements", "lpt_displacements_from_modes",
           "lpt_catalog_from_modes", "lpt_catalog", "lpt_growth",
           "pm_step_factors", "pm_evolve", "pm_evolve_checkpointed",
           "pm_catalog", "velocities_kms", "pm_lightcone_planes",
           "pm_lightcone_planes_from_modes"]

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _freqs(ngrid: int, boxsize, device=None):
    """Angular wavenumbers of the fftn axis, from exact mode numbers."""
    return _mode_numbers(ngrid, device) * (2.0 * math.pi / boxsize)


def _nyquist_mask(ngrid: int, size: int, device):
    mask = torch.ones(size, dtype=torch.float32, device=device)
    mask[ngrid // 2] = 0.0
    return mask


def _safe_div_k2(field_k, k2):
    """field_k / k2 with the k = 0 mode set to 0."""
    zero = k2 == 0.0
    out = field_k / torch.where(zero, torch.ones_like(k2), k2)
    return out.masked_fill_(zero, 0)


def _grad_invlap(field_k, ngrid: int, boxsize, sign: float):
    """sign * grad(invlap(field)) as (3, n, n, n) real grids.

    field_k: unnormalized fftn coefficients of the field. Odd (gradient)
    transfers vanish on their Nyquist plane.
    """
    field_k = torch.as_tensor(field_k)
    dev = field_k.device
    f = _freqs(ngrid, boxsize, dev)
    k2 = (f[:, None, None] ** 2 + f[None, :, None] ** 2
          + f[None, None, :] ** 2)
    # invlap: lap(phi) = field  =>  phi_k = -field_k / k^2
    phi_k = _safe_div_k2(-field_k, k2)
    del k2
    mask = _nyquist_mask(ngrid, ngrid, dev)
    out = torch.empty((3, ngrid, ngrid, ngrid), dtype=torch.float32,
                      device=dev)
    for axis in range(3):
        shape = [1, 1, 1]
        shape[axis] = ngrid
        kv = (f * mask).reshape(shape)
        out[axis] = torch.fft.ifftn((sign * 1j) * kv * phi_k).real
    return out


def _second_order_source(delta_k_full, ngrid: int, boxsize):
    """2LPT source S2(x) = sum_{i<j} [phi,ii phi,jj - phi,ij^2] on the real
    grid, from the unnormalized fftn coefficients of the linear field; the
    second derivatives of the Zel'dovich potential are spectral:
    phi,ij(k) = k_i k_j delta_k / k^2."""
    delta_k_full = torch.as_tensor(delta_k_full)
    f = _freqs(ngrid, boxsize, delta_k_full.device)
    kv = [f.reshape(-1, 1, 1), f.reshape(1, -1, 1), f.reshape(1, 1, -1)]
    t = _safe_div_k2(delta_k_full, kv[0] ** 2 + kv[1] ** 2 + kv[2] ** 2)

    def d2(i, j):
        return torch.fft.ifftn(kv[i] * kv[j] * t).real

    dxx, dyy, dzz = d2(0, 0), d2(1, 1), d2(2, 2)
    s2 = dxx * dyy + dxx * dzz + dyy * dzz
    del dxx, dyy, dzz
    for i, j in ((0, 1), (0, 2), (1, 2)):
        s2 = s2 - d2(i, j) ** 2
    return s2


def lpt_displacements_from_modes(delta_k_full, ngrid: int, boxsize):
    """(psi1, psi2) displacement grids, each (3, n, n, n), from the
    unnormalized fftn coefficients of the z=0 linear density field.

    psi1 = -grad invlap(delta) (Zel'dovich), psi2 = +grad invlap(S2);
    apply growth as x = q + D1 psi1 + D2 psi2 (D2 < 0).
    """
    psi1 = _grad_invlap(delta_k_full, ngrid, boxsize, sign=-1.0)
    s2 = _second_order_source(delta_k_full, ngrid, boxsize)
    psi2 = _grad_invlap(torch.fft.fftn(s2), ngrid, boxsize, sign=+1.0)
    return psi1, psi2


def lpt_displacements(generator: torch.Generator, ngrid: int, boxsize,
                      pk_fn: Callable):
    """(psi1, psi2) for a Gaussian realization of pk_fn (z=0
    normalization) drawn from `generator`, on its device: the modes of
    `mocks.linear_modes` (the same draw as `lpt_catalog`,
    `mocks.zeldovich_catalog` and `mocks.gaussian_field` from a generator
    in the same state)."""
    dk = linear_modes(generator, ngrid, boxsize, pk_fn)
    return lpt_displacements_from_modes(dk, ngrid, boxsize)


def _lattice_comps(ngrid: int, boxsize, device=None):
    cell = boxsize / ngrid
    x = (torch.arange(ngrid, dtype=torch.float32, device=device) + 0.5) * cell
    gx, gy, gz = torch.meshgrid(x, x, x, indexing="ij")
    return gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)


def lpt_growth(cosmo, z_init: float, order: int = 2):
    """Host scalars (D1, f1, D2, f2) at z_init (D2=f2=0 for order=1)."""
    d1 = float(cosmo.growth_factor(z_init))
    f1 = float(cosmo.growth_rate(z_init))
    om_z = float(cosmo.Om(z_init))
    if order == 1:
        return d1, f1, 0.0, 0.0
    d2 = -(3.0 / 7.0) * d1 ** 2 * om_z ** (-1.0 / 143.0)
    f2 = 2.0 * om_z ** (6.0 / 11.0)
    return d1, f1, d2, f2


def lpt_catalog_from_modes(delta_k_full, ngrid: int, boxsize, cosmo,
                           z_init: float, order: int = 2, growth=None,
                           device=None):
    """2LPT (or Zel'dovich, order=1) particle ICs at z_init from explicit
    linear modes (unnormalized fftn coefficients of the z=0 field, a
    complex tensor, or a numpy array placed on `device`: by default the
    CUDA card).

    growth: optional precomputed (d1, f1, d2, f2, e_init) host scalars.
    Returns (comps, mom): flat position buffers (x, y, z) in [0, boxsize]
    and canonical momenta (px, py, pz) = a^2 dx/dt.
    """
    if order not in (1, 2):
        raise ValueError("order must be 1 (Zel'dovich) or 2 (2LPT)")
    if growth is None:
        d1, f1, d2, f2 = lpt_growth(cosmo, z_init, order)
        e = float(cosmo.efunc(z_init))
    else:
        d1, f1, d2, f2, e = (float(g) for g in growth)
    a = 1.0 / (1.0 + z_init)
    delta_k_full = as_tensor(delta_k_full, device)
    psi1, psi2 = lpt_displacements_from_modes(delta_k_full, ngrid, boxsize)
    lattice = _lattice_comps(ngrid, boxsize, delta_k_full.device)
    comps, mom = [], []
    for i, q in enumerate(lattice):
        disp = d1 * psi1[i] + d2 * psi2[i]
        comps.append(torch.remainder(q + disp.reshape(-1), boxsize))
        # dx/dt = E (f1 D1 psi1 + f2 D2 psi2); p = a^2 dx/dt
        dxdt = (a * a * e) * (f1 * d1 * psi1[i] + f2 * d2 * psi2[i])
        mom.append(dxdt.reshape(-1))
    return tuple(comps), tuple(mom)


def lpt_catalog(generator: torch.Generator, ngrid: int, boxsize,
                pk_fn: Callable, cosmo, z_init: float, order: int = 2):
    """2LPT (or Zel'dovich, order=1) particle ICs at z_init for a Gaussian
    realization of pk_fn drawn from `generator`, on the generator's
    device. Returns (comps, mom) as `lpt_catalog_from_modes` does."""
    if order not in (1, 2):
        raise ValueError("order must be 1 (Zel'dovich) or 2 (2LPT)")
    dk = linear_modes(generator, ngrid, boxsize, pk_fn)
    return lpt_catalog_from_modes(dk, ngrid, boxsize, cosmo, z_init,
                                  order=order)


def velocities_kms(mom, a: float):
    """Peculiar velocities [km/s] from canonical momenta at scale factor
    a: v = 100 p / a."""
    return tuple(100.0 * p / a for p in mom)


def _a_edges(a_init: float, a_final: float, nsteps: int, spacing: str):
    if spacing == "loga":
        return np.exp(np.linspace(np.log(a_init), np.log(a_final),
                                  nsteps + 1))
    if spacing == "a":
        return np.linspace(a_init, a_final, nsteps + 1)
    raise ValueError("spacing must be 'loga' or 'a'")


def _factors_from_edges(cosmo, edges, spacing: str = "loga",
                        quad_points: int = 257):
    """KDK integrals per step for an explicit scale-factor edge grid (host
    float64): (nsteps, 3) rows [kick(a0->ah), drift(a0->a1),
    kick(ah->a1)], kick integrand 1/(a^2 E), drift 1/(a^3 E)."""
    edges = np.asarray(edges, np.float64)
    nsteps = len(edges) - 1

    def integral(lo, hi, power):
        a = np.linspace(lo, hi, quad_points)
        return _trapezoid(1.0 / (a ** power * cosmo.efunc_a(a)), a)

    out = np.empty((nsteps, 3), np.float64)
    for i in range(nsteps):
        a0, a1 = edges[i], edges[i + 1]
        ah = np.sqrt(a0 * a1) if spacing == "loga" else 0.5 * (a0 + a1)
        out[i, 0] = integral(a0, ah, 2)
        out[i, 1] = integral(a0, a1, 3)
        out[i, 2] = integral(ah, a1, 2)
    return out


def pm_step_factors(cosmo, a_init: float, a_final: float, nsteps: int,
                    spacing: str = "loga", quad_points: int = 257):
    """Exact KDK drift/kick integrals per step (host, float64), numpy
    (nsteps, 3) (Quinn et al. 1997), trapezoid-quadratured."""
    return _factors_from_edges(cosmo, _a_edges(a_init, a_final, nsteps,
                                               spacing),
                               spacing=spacing, quad_points=quad_points)


def _poisson_forces(grid, ngrid: int, boxsize, om0, window: str,
                    compensate: bool = True, am2=math.inf):
    """F_hat = -grad phi_hat with lap phi_hat = 1.5 Om0 (1 + mu_k) delta,
    as (3, n, n, n) grids from a painted density: one rfftn and three
    irfftn.

    am2 = a^2 M^2(a), the comoving scalaron mass^2 of linearized
    Hu-Sawicki f(R) [(h/Mpc)^2]; mu_k = k^2 / (3 (k^2 + am2)). am2 = inf
    is exact GR: k^2 / inf == 0, so geff == 1 exactly.
    """
    dk = _delta_k(grid, window=window if compensate else None)
    dev = grid.device
    f = _freqs(ngrid, boxsize, dev)
    fr = f[: ngrid // 2 + 1]
    kv = [f.reshape(-1, 1, 1), f.reshape(1, -1, 1), fr.reshape(1, 1, -1)]
    k2 = kv[0] ** 2 + kv[1] ** 2 + kv[2] ** 2
    geff = 1.0 + k2 / (3.0 * (k2 + am2))
    phik = _safe_div_k2(-1.5 * om0 * geff * dk, k2)
    del dk, geff, k2
    masks = [_nyquist_mask(ngrid, ngrid, dev).reshape(-1, 1, 1),
             _nyquist_mask(ngrid, ngrid, dev).reshape(1, -1, 1),
             _nyquist_mask(ngrid, ngrid // 2 + 1, dev).reshape(1, 1, -1)]
    out = torch.empty((3, ngrid, ngrid, ngrid), dtype=torch.float32,
                      device=dev)
    for a in range(3):
        out[a] = torch.fft.irfftn(-1j * kv[a] * masks[a] * phik,
                                  s=(ngrid,) * 3) * float(ngrid) ** 3
    return out


# named profiler spans: a trace of the time loop groups its device time by
# them (a few microseconds per span when no profiler runs)
_span = torch.profiler.record_function


def _force_grids(comps, ngrid: int, boxsize, om0, window: str,
                 compensate: bool = True, am2=math.inf, deposit=None):
    """Paint the particles and solve for the force grids (3, n, n, n).

    One window deconvolution corrects the paint; the readout smoothing
    remains. Keep ngrid == particles per side with lattice ICs: a finer
    force mesh aliases the lattice's displacement sidebands coherently
    onto the physical modes (the JAX package's `_force_grids` docstring;
    tests pin both regimes).
    """
    with _span("pm.paint"):
        grid = paint(comps, ngrid, boxsize, window=window, deposit=deposit)
    with _span("pm.poisson"):
        return _poisson_forces(grid, ngrid, boxsize, om0, window,
                               compensate=compensate, am2=am2)


def _pm_loop(comps, mom, factors, am2_edges, ngrid: int, boxsize, om0,
             window: str, deposit=None):
    """KDK leapfrog over the rows of `factors`, in place on comps/mom.

    Each part runs in a profiler span: pm.paint and pm.poisson (in
    `_force_grids`), pm.gather, pm.kick (twice per step) and pm.drift.
    """
    def forces(am2):
        grids = _force_grids(comps, ngrid, boxsize, om0, window, am2=am2,
                             deposit=deposit)
        with _span("pm.gather"):
            return sample_displacement(grids, boxsize, comps)

    def kick(frc, k):
        with _span("pm.kick"):
            for p, f in zip(mom, frc):
                p.add_(f, alpha=k)

    frc = forces(am2_edges[0])
    for (k1, dr, k2), am2 in zip(factors, am2_edges[1:]):
        kick(frc, k1)
        with _span("pm.drift"):
            for c, p in zip(comps, mom):
                c.add_(p, alpha=dr).remainder_(boxsize)
        frc = forces(am2)
        kick(frc, k2)
    return comps, mom


def pm_evolve(comps, mom, cosmo, ngrid: int, boxsize, a_init: float,
              a_final: float, nsteps: int, window: str = "cic",
              spacing: str = "loga", device=None):
    """Evolve (comps, mom) from a_init to a_final with nsteps KDK
    leapfrog steps on an ngrid^3 force mesh.

    comps/mom: flat per-component buffers (x, y, z) / (px, py, pz) as
    produced by lpt_catalog (numpy components go to `device`, by default
    the CUDA card; the momenta follow the positions). One paint + 4 FFTs +
    3 gathers per step, plus one force evaluation before the first step.
    Returns new (comps, mom); the inputs are copied, not changed.

    cosmo.fR0 != 0 turns on the linearized Hu-Sawicki fifth force
    (per-step comoving scalaron mass^2 a^2 M^2(a) from the host, spectral
    Geff(k) in the Poisson solve); fR0 = 0 is exact GR.

    The whole simulation runs in the profiler span `pm.evolve`, around
    the loop's spans (`_pm_loop`).
    """
    with _span("pm.evolve"):
        comps, mom = _flat_copies(comps, mom, device)
        return _evolve_on_edges(comps, mom, cosmo, ngrid, boxsize,
                                _a_edges(a_init, a_final, nsteps, spacing),
                                window, spacing)


def _flat_copies(comps, mom, device):
    """Flat copies of the particle buffers that the KDK loop may update in
    place (numpy components go to `device`; the momenta follow the
    positions)."""
    comps = tuple(c.reshape(-1).clone() for c in as_points(tuple(comps),
                                                           device))
    dev = comps[0].device
    return comps, tuple(as_tensor(p, dev).reshape(-1).clone() for p in mom)


def _am2_edges(cosmo, edges):
    """a^2 M^2(a) of the scalaron at each edge (host float64); inf in GR."""
    if float(getattr(cosmo, "fR0", 0.0)) != 0.0:
        return edges ** 2 * np.asarray(cosmo.scalaron_mass2(edges),
                                       np.float64)
    return np.full(len(edges), np.inf)


def _evolve_on_edges(comps, mom, cosmo, ngrid: int, boxsize, edges,
                     window: str, spacing: str):
    """pm_evolve's body for an explicit edge grid, shared with
    pm_evolve_checkpointed: updates the flat buffers comps/mom in place
    and returns them."""
    factors = _factors_from_edges(cosmo, edges, spacing=spacing)
    return _pm_loop(comps, mom, factors.tolist(),
                    _am2_edges(cosmo, edges).tolist(), ngrid, float(boxsize),
                    float(cosmo.Om0), window)


def pm_evolve_checkpointed(comps, mom, cosmo, ngrid: int, boxsize,
                           a_init: float, a_final: float, nsteps: int,
                           ckpt_dir, segment_steps: int = 8,
                           window: str = "cic", spacing: str = "loga",
                           device=None):
    """Resume-safe pm_evolve: evolve in segments of segment_steps KDK
    steps, atomically checkpointing (comps, mom) after each segment
    (core.checkpoint.save_state: the completed-step count travels inside
    the payload, so a crash mid-save keeps the previous complete state).
    Rerunning with the same arguments and ckpt_dir resumes from the last
    completed segment instead of restarting; a checkpoint of another
    schedule raises ("different schedule").

    Segment edge grids are exact contiguous slices of pm_evolve's edge
    grid and the KDK factors are row-local, so the segmented run follows
    the SAME schedule as pm_evolve. Each segment evaluates the force at
    its start again, where pm_evolve reuses the last step's: on the CPU
    the two agree bit for bit, on the card to the rounding of K2's float
    atomics. The schedule record and the npz layout are the JAX
    package's, so either package resumes the other's checkpoint. The
    inputs are copied, not changed; numpy components go to `device`.
    """
    from ..core.checkpoint import (bind_schedule, checkpoint_exists,
                                   restore_state, save_state)
    if segment_steps < 1:
        raise ValueError("segment_steps must be >= 1")
    edges = _a_edges(a_init, a_final, nsteps, spacing)
    comps, mom = _flat_copies(comps, mom, device)
    bind_schedule(ckpt_dir, {
        "kind": "pm_evolve", "a_init": float(a_init),
        "a_final": float(a_final), "nsteps": int(nsteps),
        "spacing": spacing, "ngrid": int(ngrid),
        "boxsize": float(boxsize), "window": window,
        "npart": int(comps[0].numel())})
    done = 0
    if checkpoint_exists(ckpt_dir):
        (comps, mom), step = restore_state(ckpt_dir, (comps, mom),
                                           with_step=True)
        done = 0 if step is None else int(step)
        if done > nsteps:
            raise ValueError(
                f"checkpoint at {ckpt_dir} records {done} completed "
                f"steps but this schedule has only {nsteps} — the "
                "checkpoint belongs to a different run; point ckpt_dir "
                "somewhere fresh")
    while done < nsteps:
        k = min(segment_steps, nsteps - done)
        comps, mom = _evolve_on_edges(comps, mom, cosmo, ngrid, boxsize,
                                      edges[done:done + k + 1], window,
                                      spacing)
        done += k
        save_state(ckpt_dir, (comps, mom), step=done)
    return comps, mom


def pm_catalog(generator: torch.Generator, cosmo, pk_fn: Callable,
               ngrid_part: int, boxsize, z_init: float = 9.0,
               z_final: float = 0.0, nsteps: int = 20,
               ngrid_force: int | None = None, order: int = 2,
               window: str = "cic"):
    """Linear P(k) -> nonlinear snapshot: 2LPT ICs at z_init (drawn from
    `generator`) evolved to z_final. Returns (comps, vel_kms), both flat
    component tuples. ngrid_force defaults to ngrid_part (1:1)."""
    if ngrid_force is None:
        ngrid_force = ngrid_part
    comps, mom = lpt_catalog(generator, ngrid_part, boxsize, pk_fn, cosmo,
                             z_init, order=order)
    a0, a1 = 1.0 / (1.0 + z_init), 1.0 / (1.0 + z_final)
    comps, mom = pm_evolve(comps, mom, cosmo, ngrid_force, boxsize, a0, a1,
                           nsteps, window=window)
    return comps, velocities_kms(mom, a1)


def _lightcone_geometry(cosmo, boxsize, nplanes: int, z_source: float,
                        z_init: float, order: int):
    """(dchi, plane distances, plane redshifts, box repetitions along the
    line of sight) of `pm_lightcone_planes`, after its argument checks."""
    if order not in (1, 2):
        raise ValueError("order must be 1 (Zel'dovich) or 2 (2LPT)")
    chi_s = float(cosmo.comoving_distance(z_source))
    dchi = chi_s / nplanes
    if dchi > boxsize:
        raise ValueError(
            f"dchi = chi_s/nplanes = {dchi:.1f} exceeds the box "
            f"({boxsize}); the slab paint would silently bias delta "
            f"low. Use nplanes >= {int(np.ceil(chi_s / boxsize))}.")
    chis = (np.arange(nplanes) + 0.5) * dchi
    z_planes = np.asarray(cosmo.redshift_at_comoving_distance(
        chis.astype(np.float32)), np.float64)
    if z_init <= z_planes.max():
        raise ValueError(
            f"z_init={z_init} must exceed the farthest plane redshift "
            f"{z_planes.max():.3f} (raise z_init or lower z_source)")
    return dchi, chis, z_planes, int(chis[-1] // boxsize) + 1


def _generator_fingerprint(generator: torch.Generator) -> str:
    """JSON-able identity of a generator's state (the JAX package's
    `_key_fingerprint` of a PRNG key): a hash of `get_state()`."""
    state = generator.get_state().numpy().tobytes()
    return hashlib.sha256(state).hexdigest()


def _lightcone(modes_fn: Callable, dev, source: dict, cosmo,
               ngrid_part: int, boxsize, fov, npix: int, nplanes: int,
               z_source: float, z_init: float, nsteps_init: int,
               steps_per_plane: int, ngrid_force, order: int, window: str,
               los: int, observer_xy, shifts, ckpt_dir, ckpt_every: int):
    """The lightcone's plane loop on device `dev`. modes_fn() gives the
    linear modes; it is not called when a checkpoint is resumed. source:
    the schedule's record of where the modes and shifts come from."""
    dchi, chis, z_planes, n_groups = _lightcone_geometry(
        cosmo, boxsize, nplanes, z_source, z_init, order)
    if ngrid_force is None:
        ngrid_force = ngrid_part
    if observer_xy is None:
        observer_xy = (0.5 * boxsize, 0.5 * boxsize)
    if shifts is None:
        shifts = np.zeros((n_groups, 2))
    shifts = np.asarray(shifts, np.float64)
    if shifts.shape != (n_groups, 2):
        raise ValueError(f"shifts must have shape ({n_groups}, 2), one row "
                         f"per box repetition, got {shifts.shape}")
    # far -> near: scale factors ascending; planes_buf[j] holds plane j of
    # that ordering (reversed to near -> far at return)
    a_targets = 1.0 / (1.0 + z_planes[::-1])
    planes_buf = torch.zeros((nplanes, npix, npix), dtype=torch.float32,
                             device=dev)
    j_start = 0
    resume = False
    if ckpt_dir is not None:
        from ..core.checkpoint import (bind_schedule, checkpoint_exists,
                                       restore_state, save_state)
        bind_schedule(ckpt_dir, {
            "kind": "pm_lightcone", **source,
            "ngrid_part": int(ngrid_part), "boxsize": float(boxsize),
            "fov": float(fov), "npix": int(npix),
            "nplanes": int(nplanes), "z_source": float(z_source),
            "z_init": float(z_init), "nsteps_init": int(nsteps_init),
            "steps_per_plane": int(steps_per_plane),
            "ngrid_force": int(ngrid_force), "order": int(order),
            "window": window, "los": int(los),
            "observer_xy": [float(observer_xy[0]),
                            float(observer_xy[1])]})
        resume = checkpoint_exists(ckpt_dir)
    if resume:
        # the checkpoint carries the full evolved state: no 2LPT ICs (the
        # restore template gives only shapes, dtypes and the device)
        zc = tuple(torch.empty(int(ngrid_part) ** 3, dtype=torch.float32,
                               device=dev) for _ in range(3))
        (comps, mom, planes_buf), step = restore_state(
            ckpt_dir, (zc, zc, planes_buf), with_step=True)
        j_start = 0 if step is None else int(step)
        if j_start > nplanes:
            raise ValueError(
                f"checkpoint at {ckpt_dir} records {j_start} planes "
                f"but this lightcone has {nplanes} — stale "
                "checkpoint; point ckpt_dir somewhere fresh")
    else:
        comps, mom = lpt_catalog_from_modes(modes_fn(), ngrid_part, boxsize,
                                            cosmo, z_init, order=order)
    a_now = (1.0 / (1.0 + z_init) if j_start == 0
             else float(a_targets[j_start - 1]))
    for j in range(j_start, nplanes):
        a_t, chi_c = float(a_targets[j]), float(chis[::-1][j])
        nst = nsteps_init if j == 0 else steps_per_plane
        comps, mom = pm_evolve(comps, mom, cosmo, ngrid_force, boxsize,
                               a_now, a_t, nst, window=window)
        a_now = a_t
        g = int(chi_c // boxsize)
        oxy = ((observer_xy[0] + shifts[g, 0]) % boxsize,
               (observer_xy[1] + shifts[g, 1]) % boxsize)
        with _span("lightcone.plane"):
            d, _ = density_planes_from_particles(
                comps, boxsize, chi_c, dchi, 1, fov, npix, los=los,
                observer_xy=oxy)
            planes_buf[j] = d[0]
        if ckpt_dir is not None and (
                (j + 1 - j_start) % ckpt_every == 0 or j + 1 == nplanes):
            save_state(ckpt_dir, (comps, mom, planes_buf), step=j + 1)
    delta = planes_buf.flip(0)  # reorder near -> far
    return delta, torch.as_tensor(chis, dtype=torch.float32,
                                  device=delta.device), dchi


def pm_lightcone_planes_from_modes(delta_k_full, cosmo, ngrid_part: int,
                                   boxsize, fov, npix: int, nplanes: int,
                                   z_source: float = 1.0,
                                   z_init: float = 9.0,
                                   nsteps_init: int = 8,
                                   steps_per_plane: int = 2,
                                   ngrid_force: int | None = None,
                                   order: int = 2, window: str = "cic",
                                   los: int = 2, observer_xy=None,
                                   shifts=None, ckpt_dir=None,
                                   ckpt_every: int = 1, device=None):
    """`pm_lightcone_planes` from explicit linear modes (unnormalized fftn
    coefficients of the z=0 field) and explicit observer shifts.

    delta_k_full: complex (n, n, n) tensor (it keeps its device) or numpy
      array (it goes to `device`, by default the CUDA card; without one it
      raises: pass device="cpu").
    shifts: optional (n_groups, 2) transverse observer offsets [Mpc/h],
      one row per box repetition along the line of sight
      (n_groups = floor(chi_far / boxsize) + 1); None keeps the observer
      fixed.
    ckpt_dir, ckpt_every: as in `pm_lightcone_planes`; the schedule records
      a hash of the modes and the shifts.
    """
    delta_k_full = as_tensor(delta_k_full, device)
    source = {}
    if ckpt_dir is not None:
        modes = delta_k_full.detach().cpu().contiguous().numpy()
        source = {"modes": hashlib.sha256(modes.tobytes()).hexdigest(),
                  "shifts": None if shifts is None
                  else np.asarray(shifts, np.float64).tolist()}
    return _lightcone(lambda: delta_k_full, delta_k_full.device, source,
                      cosmo, ngrid_part, boxsize, fov, npix, nplanes,
                      z_source, z_init, nsteps_init, steps_per_plane,
                      ngrid_force, order, window, los, observer_xy, shifts,
                      ckpt_dir, ckpt_every)


def pm_lightcone_planes(generator: torch.Generator, cosmo, pk_fn: Callable,
                        ngrid_part: int, boxsize, fov, npix: int,
                        nplanes: int, z_source: float = 1.0,
                        z_init: float = 9.0, nsteps_init: int = 8,
                        steps_per_plane: int = 2,
                        ngrid_force: int | None = None, order: int = 2,
                        window: str = "cic", los: int = 2,
                        observer_xy=None,
                        randomize_generator: torch.Generator | None = None,
                        ckpt_dir=None, ckpt_every: int = 1):
    """Full lensing forward model: linear P(k) -> evolving PM snapshot
    -> lightcone density-contrast planes, each painted from the
    snapshot evolved to that plane's OWN redshift (feed the result to
    ops.lensing.born_convergence or ops.raytrace.multiplane_raytrace).

    The linear modes are drawn from `generator`, on its device.
    Evolution runs far -> near (forward in time): 2LPT ICs at z_init,
    one pre-evolution leg of nsteps_init KDK steps down to the farthest
    plane's redshift, then steps_per_plane steps between consecutive
    plane epochs. The box is replicated periodically along `los` by the
    plane painter; transverse replication for wide cones is handled
    there too (ops.lens_planes.density_planes_from_particles).

    randomize_generator: optional generator (the JAX package's
    `randomize_key`). A single-box lightcone repeats the SAME structure
    every boxsize along the line of sight, so transverse low-k modes of
    different planes add COHERENTLY in the Born/ray sum: a factor ~3.5
    excess over the Limber C_ell in the lowest band. Passing a generator
    draws one random transverse observer offset per box REPETITION
    (planes within one box depth keep their relative geometry), the
    standard single-box decorrelation (e.g. Petri+16).

    ckpt_dir: optional checkpoint directory. The per-plane loop saves
    (comps, mom, planes-so-far) every ckpt_every completed planes
    (atomic, step inside the payload: core.checkpoint.save_state);
    rerunning the SAME call (generators in the same states) resumes at
    the first unfinished plane, and a call of another schedule raises
    ("different schedule"). A resumed call restores the evolved
    particles instead of drawing the ICs: it leaves `generator` in the
    state it had at entry, where a fresh call advances it by the modes'
    draw; `randomize_generator` draws its shifts either way.

    Returns (delta (nplanes, npix, npix), chis (nplanes,), dchi):
    planes ordered near -> far, chi_i = (i + 0.5) * dchi,
    dchi = chi(z_source) / nplanes.
    """
    n_groups = _lightcone_geometry(cosmo, boxsize, nplanes, z_source,
                                   z_init, order)[3]
    source = {}
    if ckpt_dir is not None:
        source = {"key": _generator_fingerprint(generator),
                  "randomize": (None if randomize_generator is None
                                else _generator_fingerprint(
                                    randomize_generator))}
    shifts = None
    if randomize_generator is not None:
        shifts = (torch.rand((n_groups, 2), generator=randomize_generator,
                             device=randomize_generator.device)
                  * boxsize).cpu().numpy()
    return _lightcone(
        lambda: linear_modes(generator, ngrid_part, boxsize, pk_fn),
        generator.device, source, cosmo, ngrid_part, boxsize, fov, npix,
        nplanes, z_source, z_init, nsteps_init, steps_per_plane, ngrid_force,
        order, window, los, observer_xy, shifts, ckpt_dir, ckpt_every)
