"""Plain reference of the z=0 analysis suite, in torch on any device.

Imports nothing of the program and takes nothing it made: it works out
its own keys, grids, mode tables, shells, window and lensing kernels from
the particles and the configuration.

  matter      NGP counts on the (ff ngrid)^3 fine grid (float64
              index_add_ of integer counts, so exact in any order), one
              fine rfftn, the coarse-Nyquist block of modes, NGP window
              deconvolution at the fine resolution, shells linear in |m|
              from 0.5 to ngrid/2, shot noise V/N subtracted; the coarse
              grid is the fine grid summed over its ff^3 subcells;
  bispectrum  B = V^2 sum_closed d1 d2 d3 / N_tri / n^9 over shell
              triples, from shell-filtered fields at the full grid (no
              band limit), N_tri counted from the masks alone; open
              triples (N_tri = 0) are NaN;
  lensing     interleaved slabs of the contrast, the Born sum, a bilinear
              resize written out (PyTorch's align_corners=False rule),
              gamma by the padded spin-2 rotation;
  voids       peaks of a kappa map (strict 8-neighbour maxima at or above
              threshold_sigma times its population std, edge pixels
              dropped, the max_peaks highest), the exact squared distance
              to the nearest peak (integers), its strict local maxima as candidates
              (the max_voids largest), greedy acceptance by the two-circle
              overlap fraction in float64.

Ordering rule of the estimators: equal values are ranked by the index of
the 2x2 pixel block that holds them (both maps are of even side >= 512,
and two strict maxima never share a block), the rule of the tunnels
finder as defined in the package it was ported from.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .precision import Precision

__all__ = ["matter", "bispectrum", "lensing", "find_voids", "C_LIGHT_KMS"]

C_LIGHT_KMS = 299792.458
_CHUNK = 1 << 24


def _modes(n: int, device, dtype, real: bool = False):
    k = torch.arange(n // 2 + 1 if real else n, device=device)
    if not real:
        k = (k + n // 2) % n - n // 2
    return k.to(dtype)


def matter(pos, ngrid: int, boxsize: float, nbins: int, fine_factor: int,
           prec: Precision):
    """(P(k) of nbins shells, the coarse ngrid^3 count grid)."""
    dev = pos.device
    nf = ngrid * fine_factor
    n_part = pos.shape[1]
    grid = torch.zeros(nf ** 3, dtype=prec.dtype, device=dev)
    for s in range(0, n_part, _CHUNK):
        u = [torch.floor(prec.q(pos[a, s:s + _CHUNK]) * (nf / boxsize))
             .to(torch.int64) % nf for a in range(3)]
        key = (u[0] * nf + u[1]) * nf + u[2]
        del u
        grid.index_add_(0, key, torch.ones(key.shape[0], dtype=prec.dtype,
                                           device=dev))
        del key
    grid = grid.view(nf, nf, nf)
    coarse = grid.view(ngrid, fine_factor, ngrid, fine_factor, ngrid,
                       fine_factor).sum(dim=(1, 3, 5))
    spec = torch.fft.rfftn(grid)
    del grid
    ix = (_modes(ngrid, dev, torch.int64) % nf)
    sub = prec.q(spec[ix][:, ix][:, :, :ngrid // 2 + 1])
    del spec
    mx = _modes(ngrid, dev, prec.dtype)
    mz = _modes(ngrid, dev, prec.dtype, real=True)
    win = (torch.sinc(mx / nf)[:, None, None] * torch.sinc(mx / nf)[None, :, None]
           * torch.sinc(mz / nf)[None, None, :])
    volume = boxsize ** 3
    p3 = prec.q((sub.abs() ** 2) / (float(n_part) ** 2 * win ** 2) * volume)
    del sub
    m = torch.sqrt(mx[:, None, None] ** 2 + mx[None, :, None] ** 2
                   + mz[None, None, :] ** 2)
    w = torch.full_like(m, 2.0)
    w[:, :, 0] = 1.0
    w[0, 0, 0] = 0.0
    lo, hi = 0.5, ngrid / 2.0
    edges = torch.linspace(lo, hi, nbins + 1, dtype=torch.float64,
                           device=dev).to(prec.dtype)
    b = torch.clamp(torch.searchsorted(edges, m.reshape(-1), right=True) - 1,
                    0, nbins - 1)
    ok = ((m >= lo) & (m <= hi) & (w > 0)).reshape(-1)
    wf = torch.where(ok, w.reshape(-1), torch.zeros_like(w.reshape(-1)))
    num = torch.zeros(nbins, dtype=prec.dtype, device=dev).index_add_(
        0, b, wf * p3.reshape(-1))
    den = torch.zeros(nbins, dtype=prec.dtype, device=dev).index_add_(0, b, wf)
    # an empty shell reads -V/N, as the estimator defines it
    pk = prec.q(num / torch.where(den > 0, den, torch.ones_like(den))
                - volume / n_part)
    return pk, prec.q(coarse)


def bispectrum(grid, boxsize: float, nbins: int, m_min: float, m_max: float,
               prec: Precision):
    """B over the shell triples a <= b <= c in that order; NaN where no
    triangle closes."""
    n = grid.shape[-1]
    dev = grid.device
    g = prec.q(grid)
    delta = prec.q(g / g.mean() - 1.0)
    dk = prec.q(torch.fft.rfftn(delta))
    del delta
    mx = _modes(n, dev, torch.float64)
    mz = _modes(n, dev, torch.float64, real=True)
    m2 = mx[:, None, None] ** 2 + mx[None, :, None] ** 2 + mz[None, None, :] ** 2
    e = np.linspace(m_min, m_max, nbins + 1)
    fields, counts = [], []
    for i in range(nbins):
        mask = ((m2 >= e[i] ** 2) & (m2 < e[i + 1] ** 2)).to(prec.dtype)
        fields.append(prec.q(torch.fft.irfftn(mask * dk, s=(n, n, n))))
        counts.append(torch.fft.irfftn(mask.to(torch.float64), s=(n, n, n)))
    del dk, m2
    out = []
    for a in range(nbins):
        for b in range(a, nbins):
            for c in range(b, nbins):
                num = (fields[a] * fields[b] * fields[c]).sum()
                den = (counts[a] * counts[b] * counts[c]).sum()
                ntri = float(den) * float(n) ** 6
                if ntri < 0.5:
                    out.append(float("nan"))
                else:
                    out.append(float(boxsize ** 6 * float(num) / float(den)
                                     / float(n) ** 9))
    return torch.tensor(out, dtype=torch.float64)


def _bilinear_axis(x, n_out: int, dim: int):
    """Resize axis `dim` of x to n_out by linear interpolation with
    half-pixel centres, source indices clamped at the edges."""
    n_in = x.shape[dim]
    o = torch.arange(n_out, dtype=torch.float64, device=x.device)
    src = torch.clamp((o + 0.5) * (n_in / n_out) - 0.5, min=0.0)
    i0 = torch.clamp(torch.floor(src).to(torch.int64), max=n_in - 1)
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    w1 = (src - i0.to(torch.float64)).to(x.dtype)
    shape = [1] * x.dim()
    shape[dim] = n_out
    w1 = w1.reshape(shape)
    return (x.index_select(dim, i0) * (1.0 - w1)
            + x.index_select(dim, i1) * w1)


def lensing(grid, nplanes: int, npix: int, chi_near: float, chi_far: float,
            chi_source: float, omega_m: float, boxsize: float,
            opening_angle: float, padding_factor: int, prec: Precision):
    """(kappa, gamma1, gamma2), each npix^2."""
    ngrid = grid.shape[-1]
    dev = grid.device
    g = prec.q(grid)
    delta = prec.q(g / g.mean() - 1.0)
    slabs = prec.q(delta.reshape(ngrid // nplanes, nplanes, ngrid,
                                 ngrid).sum(0))
    del delta
    chis = torch.linspace(chi_near, chi_far, nplanes, dtype=torch.float64,
                          device=dev)
    weight = (1.5 * omega_m * (100.0 / C_LIGHT_KMS) ** 2
              * torch.clamp(chi_source - chis, min=0.0) * chis / chi_source
              * (boxsize / nplanes)).to(prec.dtype)
    kappa_c = prec.q((weight[:, None, None] * slabs).sum(0))
    kappa = prec.q(_bilinear_axis(_bilinear_axis(kappa_c, npix, 0), npix, 1))
    npad = 1
    while npad < npix * padding_factor:
        npad *= 2
    kft = prec.q(torch.fft.rfft2(kappa, s=(npad, npad)))
    m1 = _modes(npad, dev, prec.dtype)[:, None]
    m2 = _modes(npad, dev, prec.dtype, real=True)[None, :]
    k2 = m1 ** 2 + m2 ** 2
    k2s = torch.where(k2 == 0, torch.ones_like(k2), k2)
    t1 = torch.where(k2 == 0, torch.zeros_like(k2), (m1 ** 2 - m2 ** 2) / k2s)
    t2 = torch.where(k2 == 0, torch.zeros_like(k2), 2.0 * m1 * m2 / k2s)
    t2[npad // 2, :] = 0.0
    t2[:, -1] = 0.0
    g1 = prec.q(torch.fft.irfft2(t1 * kft, s=(npad, npad))[:npix, :npix])
    g2 = prec.q(torch.fft.irfft2(t2 * kft, s=(npad, npad))[:npix, :npix])
    return kappa, g1, g2


def _strict_maxima(x):
    """Pixels above all 8 neighbours; outside the map counts as -inf."""
    pad = torch.nn.functional.pad(x[None, None], (1, 1, 1, 1),
                                  value=float("-inf"))[0, 0]
    n0, n1 = x.shape
    m = torch.ones_like(x, dtype=torch.bool)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di or dj:
                m &= x > pad[1 + di:1 + di + n0, 1 + dj:1 + dj + n1]
    return m


def _ranked(values, mask, k: int):
    """Flat indices of the k largest masked values, equal values by 2x2
    block index; with the values."""
    n = values.shape[-1]
    idx = torch.nonzero(mask.reshape(-1)).squeeze(1)
    vals = values.reshape(-1)[idx]
    block = (idx // n // 2) * (n // 2) + (idx % n) // 2
    order = torch.argsort(block, stable=True)
    idx, vals = idx[order], vals[order]
    order = torch.argsort(vals, descending=True, stable=True)
    return idx[order][:k], vals[order][:k]


def _overlap(c1, r1, c2, r2):
    """Share of circle 1's area that circle 2 covers (float64 numpy)."""
    d = math.hypot(c1[0] - c2[0], c1[1] - c2[1])
    if d >= r1 + r2:
        return 0.0
    if d <= abs(r1 - r2):
        return min(r1, r2) ** 2 / r1 ** 2
    x1 = (d * d + r1 * r1 - r2 * r2) / (2.0 * d * r1)
    x2 = (d * d + r2 * r2 - r1 * r1) / (2.0 * d * r2)
    t = (-d + r1 + r2) * (d + r1 - r2) * (d - r1 + r2) * (d + r1 + r2)
    lens = (r1 * r1 * math.acos(max(-1.0, min(1.0, x1)))
            + r2 * r2 * math.acos(max(-1.0, min(1.0, x2)))
            - 0.5 * math.sqrt(max(t, 0.0)))
    return min(max(lens / (math.pi * r1 * r1), 0.0), 1.0)


def find_voids(kappa, max_peaks: int, edge_pix: int, threshold_sigma: float,
               max_voids: int, overlap: float, min_radius: float,
               prec: Precision, block: int = 1 << 16):
    """Radii of the accepted voids, largest first (stable), padded with
    zeros to max_voids, as a float64 host tensor."""
    x = prec.q(kappa)
    n = x.shape[-1]
    dev = x.device
    thr = threshold_sigma * x.std(correction=0)
    r = torch.arange(n, device=dev)
    inside = (r >= edge_pix) & (r < n - edge_pix)
    pmask = (_strict_maxima(x) & (x >= thr) & inside[:, None]
             & inside[None, :])
    pidx, _ = _ranked(x, pmask, max_peaks)
    # squared pixel distances: exact in int32 for the reference (to npix
    # 32768); the control rounds the coordinates and each sum instead
    work = prec.dtype if prec.low else torch.int32
    prow = prec.q((pidx // n).to(torch.float64)).to(work)
    pcol = prec.q((pidx % n).to(torch.float64)).to(work)
    d2 = torch.empty(n * n, dtype=work, device=dev)
    pix = torch.arange(n * n, device=dev)
    for s in range(0, n * n, block):
        pr = (pix[s:s + block] // n).to(work)[:, None]
        pc = (pix[s:s + block] % n).to(work)[:, None]
        dd = ((pr - prow[None, :]) ** 2 + (pc - pcol[None, :]) ** 2)
        d2[s:s + block] = (prec.q(dd) if prec.low else dd).amin(dim=1)
        del dd
    d2 = d2.reshape(n, n).to(prec.dtype)
    dist = prec.q(torch.sqrt(d2))
    cmask = _strict_maxima(d2) & (dist >= min_radius)
    cidx, crad = _ranked(dist, cmask, max_voids)
    cidx = cidx.cpu().numpy()
    crad = crad.double().cpu().numpy()
    cen = np.stack([cidx // n, cidx % n], axis=1).astype(np.float64)
    accepted = []
    for i in range(len(crad)):
        if all(_overlap(cen[i], crad[i], cen[j], crad[j]) <= overlap
               for j in accepted):
            accepted.append(i)
    radii = np.zeros(max_voids, np.float64)
    got = sorted((crad[i] for i in accepted), reverse=True)
    radii[:len(got)] = got
    return torch.from_numpy(radii)
