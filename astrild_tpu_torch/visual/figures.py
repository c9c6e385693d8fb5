"""Publication figures (the reference astrild's astrildvisual).

numpy / matplotlib copy of astrild_tpu/visual/figures.py: tensors are
taken to the host first. matplotlib is imported inside the functions (with
the Agg backend); each raises a clear ImportError without it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .._device import as_host

__all__ = ["figure_size", "plot_map", "plot_power_spectra",
           "plot_halo_mass_function", "plot_velocity_field",
           "plot_void_profiles", "plot_dipole_maps",
           "plot_dipole_cross_section", "use_publication_style",
           "set_size", "plot_maps_with_vel_field",
           "plot_analytic_dipole_maps", "PUBLICATION_STYLE"]


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError as e:
        raise ImportError("visualization requires matplotlib") from e


def figure_size(width_pt: float = 510.0, fraction: float = 1.0,
                ratio: Optional[float] = None):
    """LaTeX-matched figure dimensions in inches
    (astrildvisual/figure_size.py)."""
    width_in = width_pt * fraction / 72.27
    ratio = ratio if ratio is not None else (5 ** 0.5 - 1) / 2
    return (width_in, width_in * ratio)


def plot_map(img, opening_angle_deg: float = None, title: str = "",
             cmap: str = "RdBu_r", symmetric: bool = True, fname=None):
    """Sky-map imshow (astrildvisual/particles/map.py,
    rays/visuals.py map plots)."""
    plt = _plt()
    img = as_host(img)
    vmax = np.nanmax(np.abs(img)) if symmetric else None
    vmin = -vmax if symmetric else None
    extent = None
    if opening_angle_deg:
        extent = [0, opening_angle_deg, 0, opening_angle_deg]
    fig, ax = plt.subplots(figsize=figure_size())
    im = ax.imshow(img, origin="lower", cmap=cmap, vmin=vmin, vmax=vmax,
                   extent=extent)
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    if opening_angle_deg:
        ax.set_xlabel(r"$\theta_1$ [deg]")
        ax.set_ylabel(r"$\theta_2$ [deg]")
    if fname:
        fig.savefig(fname, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_power_spectra(k, pks: dict, theory=None, fname=None):
    plt = _plt()
    fig, ax = plt.subplots(figsize=figure_size())
    for label, p in pks.items():
        ax.loglog(as_host(k), as_host(p), label=label)
    if theory is not None:
        ax.loglog(as_host(k), as_host(theory), "k--", label="linear")
    ax.set_xlabel(r"$k$ [$h$/Mpc]")
    ax.set_ylabel(r"$P(k)$ [(Mpc/$h$)$^3$]")
    ax.legend()
    if fname:
        fig.savefig(fname, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_halo_mass_function(mass_bins, counts, volume=None, fname=None):
    """(astrildvisual/particles/halo_mass_function.py)"""
    plt = _plt()
    fig, ax = plt.subplots(figsize=figure_size())
    y = as_host(counts, float)
    if volume:
        y = y / volume
    ax.loglog(as_host(mass_bins), y)
    ax.set_xlabel(r"$M_{200c}$ [$M_\odot/h$]")
    ax.set_ylabel(r"$N(>M)$" + (r"$/V$" if volume else ""))
    if fname:
        fig.savefig(fname, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_velocity_field(pos, vel, nbins: int = 32, boxsize: float = None,
                        fname=None):
    """Binned quiver of a 2D velocity field slice
    (astrildvisual/rays/visuals.py:28-60)."""
    plt = _plt()
    pos = as_host(pos)
    vel = as_host(vel)
    boxsize = boxsize or pos.max()
    edges = np.linspace(0, boxsize, nbins + 1)
    cx = 0.5 * (edges[1:] + edges[:-1])
    vx = np.zeros((nbins, nbins))
    vy = np.zeros((nbins, nbins))
    ix = np.clip(np.digitize(pos[:, 0], edges) - 1, 0, nbins - 1)
    iy = np.clip(np.digitize(pos[:, 1], edges) - 1, 0, nbins - 1)
    cnt = np.zeros((nbins, nbins))
    np.add.at(vx, (ix, iy), vel[:, 0])
    np.add.at(vy, (ix, iy), vel[:, 1])
    np.add.at(cnt, (ix, iy), 1)
    cnt = np.maximum(cnt, 1)
    fig, ax = plt.subplots(figsize=figure_size(ratio=1.0))
    ax.quiver(cx[:, None] * np.ones((1, nbins)),
              cx[None, :] * np.ones((nbins, 1)), vx / cnt, vy / cnt)
    ax.set_xlabel("x [Mpc/h]")
    ax.set_ylabel("y [Mpc/h]")
    if fname:
        fig.savefig(fname, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_void_profiles(radii, mean, lowerr=None, higherr=None, fname=None):
    plt = _plt()
    fig, ax = plt.subplots(figsize=figure_size())
    ax.plot(as_host(radii), as_host(mean))
    if lowerr is not None and higherr is not None:
        ax.fill_between(as_host(radii), as_host(lowerr),
                        as_host(higherr), alpha=0.3)
    ax.axhline(0, color="k", lw=0.5)
    ax.set_xlabel(r"$r / R_{\rm void}$")
    ax.set_ylabel(r"$\kappa(r)$")
    if fname:
        fig.savefig(fname, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_dipole_maps(dipoles, skymap, indices, extent_deg: float = 1.0,
                     opening_angle_deg: float = 20.0, fname=None):
    """Cutouts of the dT map around selected dipoles, transverse-velocity
    arrow overlaid (astrildvisual/rays/visuals.py:162-238).

    dipoles: dict of columns with theta1_pix/theta2_pix and
    theta1_mtvel/theta2_mtvel (or *_tv); skymap: 2D array.
    """
    plt = _plt()
    img = as_host(skymap)
    npix = img.shape[0]
    pix_per_deg = npix / opening_angle_deg
    half = max(2, int(extent_deg * pix_per_deg / 2))
    get = lambda k: as_host(dipoles[k], float)
    vk = "theta1_mtvel" if "theta1_mtvel" in dipoles else "theta1_tv"
    vk2 = vk.replace("theta1", "theta2")
    fig, axes = plt.subplots(1, len(indices), figsize=(5 * len(indices), 5),
                             squeeze=False)
    for ax, i in zip(axes[0], indices):
        r = int(get("theta1_pix")[i])
        c = int(get("theta2_pix")[i])
        r0, r1 = max(0, r - half), min(npix, r + half)
        c0, c1 = max(0, c - half), min(npix, c + half)
        cut = img[r0:r1, c0:c1]
        vmax = float(np.abs(cut).max()) or 1.0
        ax.imshow(cut, cmap="RdBu_r", vmin=-vmax, vmax=vmax,
                  origin="lower")
        ax.quiver([c - c0], [r - r0], [get(vk2)[i]], [get(vk)[i]],
                  color="k")
        ax.set_title(f"dipole {i}")
    if fname:
        fig.savefig(fname, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_dipole_cross_section(dipoles, skymap, index: int,
                              extent_deg: float = 1.0,
                              opening_angle_deg: float = 20.0, axis: int = 1,
                              fname=None):
    """1D dT profile through a dipole center along the given array axis
    (astrildvisual/rays/visuals.py:241-300)."""
    plt = _plt()
    img = as_host(skymap)
    npix = img.shape[0]
    pix_per_deg = npix / opening_angle_deg
    half = max(2, int(extent_deg * pix_per_deg / 2))
    r = int(as_host(dipoles["theta1_pix"], float)[index])
    c = int(as_host(dipoles["theta2_pix"], float)[index])
    if axis == 1:
        lo, hi = max(0, c - half), min(npix, c + half)
        prof = img[r, lo:hi]
        x = (np.arange(lo, hi) - c) / pix_per_deg
    else:
        lo, hi = max(0, r - half), min(npix, r + half)
        prof = img[lo:hi, c]
        x = (np.arange(lo, hi) - r) / pix_per_deg
    fig, ax = plt.subplots(figsize=figure_size())
    ax.plot(x, prof)
    ax.axhline(0.0, color="0.6", lw=0.8)
    ax.set_xlabel(r"offset [deg]")
    ax.set_ylabel(r"$\Delta T$")
    if fname:
        fig.savefig(fname, bbox_inches="tight")
        plt.close(fig)
    return fig


# ------------------------------------------------- publication styling
# Our own publication defaults (role of astrildvisual/publication.mplstyle):
# compact serif-ish layout sized for a journal column.
PUBLICATION_STYLE = {
    "figure.facecolor": "white",
    "axes.grid": False,
    "axes.linewidth": 1.2,
    "axes.labelsize": 11,
    "axes.titlesize": 11,
    "font.size": 10,
    "font.family": "STIXGeneral",
    "mathtext.fontset": "stix",
    "xtick.direction": "in",
    "ytick.direction": "in",
    "xtick.top": True,
    "ytick.right": True,
    "xtick.labelsize": 9,
    "ytick.labelsize": 9,
    "legend.frameon": False,
    "legend.fontsize": 9,
    "savefig.dpi": 200,
    "savefig.bbox": "tight",
}


def use_publication_style():
    """Apply journal-figure rcParams (astrildvisual/publication.mplstyle
    equivalent). Returns the previous values for restoring."""
    _plt()  # ensures matplotlib is importable + Agg
    import matplotlib as mpl

    old = {k: mpl.rcParams[k] for k in PUBLICATION_STYLE}
    mpl.rcParams.update(PUBLICATION_STYLE)
    return old


def set_size(width="mnras", subplot=(1, 1), fraction: float = 1.0):
    """Figure dimensions for named journal column widths
    (astrildvisual/figure_size.py:1-35 behavior): 'mnras' (252 pt),
    'mnras_double' (504 pt), or a width in points; the height follows the
    golden ratio scaled by the subplot grid rows/cols."""
    widths = {"mnras": 252.0, "mnras_double": 504.0, "aa": 256.0,
              "aa_double": 523.0}
    width_pt = widths.get(width, None) if isinstance(width, str) else width
    if width_pt is None:
        raise ValueError(f"unknown journal width {width!r}")
    w_in = width_pt * fraction / 72.27
    golden = (5.0 ** 0.5 - 1.0) / 2.0
    return (w_in, w_in * golden * (subplot[0] / subplot[1]))


def plot_maps_with_vel_field(maps, halo_pos, halo_vel,
                             opening_angle_deg: float, npix_vel: int = 40,
                             titles=None, cmap: str = "RdBu_r",
                             fname=None):
    """Panel row of sky maps overlaid with binned halo-velocity quivers.

    Array-first equivalent of astrildvisual/rays/visuals.py:62-160
    (maps_with_vel_field): instead of file paths + DataFrames it takes
    maps: list of (npix, npix) arrays; halo_pos/halo_vel: per-map (N, 2)
    angular positions [deg] and transverse velocities.
    """
    plt = _plt()
    from matplotlib import colors

    n = len(maps)
    fig, axes = plt.subplots(1, n, figsize=(5 * n, 5), sharex=True,
                             sharey=True, squeeze=False)
    fig.subplots_adjust(wspace=0.05)
    ims = []
    for idx, ax in enumerate(axes[0]):
        img = as_host(maps[idx])
        vmax = float(np.abs(img).max()) * 0.9 or 1.0
        norm = colors.TwoSlopeNorm(vmin=-vmax, vcenter=0.0, vmax=vmax)
        im = ax.imshow(img, origin="lower", cmap=cmap, norm=norm,
                       extent=[0, opening_angle_deg, 0, opening_angle_deg])
        ims.append(im)
        p = as_host(halo_pos[idx])
        v = as_host(halo_vel[idx])
        edges = np.linspace(0, opening_angle_deg, npix_vel + 1)
        cx = 0.5 * (edges[1:] + edges[:-1])
        ix = np.clip(np.digitize(p[:, 0], edges) - 1, 0, npix_vel - 1)
        iy = np.clip(np.digitize(p[:, 1], edges) - 1, 0, npix_vel - 1)
        vx = np.zeros((npix_vel, npix_vel))
        vy = np.zeros_like(vx)
        cnt = np.zeros_like(vx)
        np.add.at(vx, (iy, ix), v[:, 0])
        np.add.at(vy, (iy, ix), v[:, 1])
        np.add.at(cnt, (iy, ix), 1)
        cnt = np.maximum(cnt, 1)
        ax.quiver(cx[None, :] * np.ones((npix_vel, 1)),
                  cx[:, None] * np.ones((1, npix_vel)),
                  vx / cnt, vy / cnt, color="k", width=0.003)
        if titles:
            ax.set_title(titles[idx])
        ax.set_xlabel(r"$\theta_x$ [deg]")
    axes[0][0].set_ylabel(r"$\theta_y$ [deg]")
    fig.colorbar(ims[-1], ax=list(axes[0]), shrink=0.8)
    if fname:
        fig.savefig(fname, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_analytic_dipole_maps(m200c, vel_t, extent_deg: float = 0.5,
                              npix: int = 128, z_lens: float = 0.3,
                              cosmo=None, fname=None, device=None):
    """Grid of ANALYTIC NFW moving-lens dipole patches.

    Equivalent of astrildvisual/rays/visuals.py:317-417
    (analytical_dipole_maps): per halo, paint the closed-form NFW
    temperature dipole dT = -alpha . v_t / c on a small patch.
    m200c: (n,) halo masses [Msun/h]; vel_t: (n, 2) transverse velocity
    [km/s]. The patches are painted on `device` (by default the CUDA
    card, see `ops.lensing.nfw_dipole_patch`).
    """
    plt = _plt()
    from matplotlib import colors

    from ..ops import lensing
    from ..utils.cosmology import Cosmology

    cosmo = cosmo or Cosmology()
    n = len(m200c)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4), squeeze=False)
    for idx, ax in enumerate(axes[0]):
        dt = as_host(lensing.nfw_dipole_patch(
            float(m200c[idx]), as_host(vel_t[idx], float), z_lens,
            extent_deg, npix, cosmo, device=device))
        vmax = float(np.abs(dt).max()) or 1.0
        im = ax.imshow(dt * 1e6, origin="lower", cmap="RdBu_r",
                       norm=colors.TwoSlopeNorm(vmin=-vmax * 1e6,
                                                vcenter=0.0,
                                                vmax=vmax * 1e6),
                       extent=[-extent_deg / 2, extent_deg / 2,
                               -extent_deg / 2, extent_deg / 2])
        ax.set_title(rf"$M={m200c[idx]:.1e}\,M_\odot/h$")
        fig.colorbar(im, ax=ax, shrink=0.8, label=r"$\Delta T$ [$\mu$K]")
    if fname:
        fig.savefig(fname, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig
