"""Large-lmax spherical harmonic transforms: ring FFTs and an on-device
Legendre recursion, no Legendre table.

Port of astrild_tpu/ops/sht_large.py, the libsharp-style path for nside
512-2048 maps (healpy's production scale):

* the phi sums over the equatorial-belt rings (2*nside+1 rings of
  n = 4*nside equally spaced pixels) are batched real FFTs; for m > n/2
  the belt coefficient folds onto the conjugate rfft bin n - m (it adds
  there: e^{2pi i m p/n} = conj(e^{2pi i (n-m) p/n}) for real maps), so
  lmax <= 4*nside - 1 is supported;
* the polar-cap rings (4i pixels each) are direct trig sums with float32
  angles m * phi, as in the JAX package, ring chunks padded only to their
  own longest ring;
* the Legendre functions are never stored: one upward three-term
  recursion over l runs for all m at once on an (lmax+1, nh) state, the
  rows m <= l active at step l (the JAX package scans each m-block of 128
  from its first m; a Python loop of those blocks would launch ~9 times
  as many kernels). Each element goes through the JAX package's float32
  operations: lambda = frac * 2^(-60 s), frac rescaled by 2^-60 once it
  exceeds 2^30 while s > 0, and a value contributes only once its scale s
  reaches 0 (lambda_mm ~ sin^m theta underflows float32 far below lmax at
  the poles). It runs on the nh = 2 nside northern rings and the equator
  only: a southern ring's cos(theta) is exactly minus its mirror's, so
  its values are (-1)^(l+m) the mirror's, bit for bit, and the sums split
  by the parity of l give both hemispheres;
* on the card each recursion is captured once as a CUDA graph (per tables,
  direction and shape) and replayed: it is ~17 small kernels a step, and
  the host's time a launch would bound it otherwise.

Every contraction is an elementwise product and a sum (no matrix product,
so a caller's TF32 setting cannot reach it). State memory is
O(lmax * nring): ~17 MB a (lmax+1, nh) array at nside 1024, lmax 2048.
The recursions take an optional sorted subset `ms` of the m rows: they
then start at l = ms[0] and carry only those rows (each row's values are
the full recursion's, bit for bit: every operation is elementwise in m).
That is the JAX package's `l_start` and per-block m0, which serve the
m-sharded transforms of parallel/sht_large.py; the unsharded call runs
every row, graphed on the card as before.

Profiler spans: `sht.legendre` (the recursion), `sht.caps` (the cap trig
sums), `sht.belt_fft` (the belt FFTs with their phase rotations).
"""
from __future__ import annotations

from bisect import bisect_right
from collections import OrderedDict
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import healpix as hpx
from .sht import (_CHUNK_ELEMS, _alm_pair, _beam_window, _chunks,
                  _device_key, _gaussian_alms, _m_weights, _map, _pad_gather,
                  _span, _spectrum, _upload, _white_device, _white_pair,
                  alm2cl, ring_geometry)

__all__ = ["LargeSHTTables", "sht_large_tables", "synthesize_large",
           "analyze_large", "analyze_with", "recursion_rows",
           "synfast_large", "synfast_large_from_white", "anafast_large",
           "smoothing_large"]

# Scaled-recursion bookkeeping: true lambda = frac * 2^(-60 s). frac is
# re-scaled by 2^-60 whenever it exceeds 2^30, so any value still carrying
# s >= 1 is at most 2^(30-60) = 2^-30, negligible, while frac itself never
# overflows float32.
_TRIGGER = 2.0 ** 30
_INV_RESCALE = 2.0 ** -60
# cap rings a chunk of the trig sums holds (a chunk pads to its longest
# ring: 64 consecutive cap rings differ by at most 252 pixels)
_CAP_RING_CHUNK = 64


class CapChunk(NamedTuple):
    """Consecutive cap rings padded to the longest of them."""
    rows: torch.Tensor   # (C,) ring index of each row
    phi: torch.Tensor    # (C, Lc) pixel longitudes, float32, 0 in padding
    mask: torch.Tensor   # (C, Lc) 1.0 at real pixels


class LargeSHTTables(NamedTuple):
    """Device arrays of the scan path: O(lmax^2 + lmax * nring + npix)."""
    x: torch.Tensor            # (nring,) cos(theta)
    log2_sin: torch.Tensor     # (nring,) log2(sin(theta))
    phi0: torch.Tensor         # (nring,) first-pixel longitude per ring
    mm_log2: torch.Tensor      # (lmax+1,) log2 |lambda_mm| / sin^m factor
    caps: Tuple[CapChunk, ...]  # the 2 (nside - 1) cap rings, in chunks
    flat_idx: torch.Tensor     # (npix,) RING pixel -> padded-plane index
    pad_idx: torch.Tensor      # (nring*pmax,) inverse gather
    pad_valid: torch.Tensor    # (nring*pmax,)
    rec_a: torch.Tensor        # (lmax+1, lmax+1) a_lm of the recursion
    rec_b: torch.Tensor        # (lmax+1, lmax+1) b_lm
    seed_frac: torch.Tensor    # (lmax+1, nring) scaled lambda_mm
    seed_scale: torch.Tensor   # (lmax+1, nring) its scale s


def _check_lmax(nside: int, lmax: int) -> None:
    # a raise, not an assert: under python -O the alias fold would index
    # m > n into the wrong bin and corrupt the map silently
    if lmax > 4 * nside - 1:
        raise ValueError("belt alias-fold supports lmax <= 4*nside - 1")


def _cap_chunks(geo, nside: int, dev) -> Tuple[CapChunk, ...]:
    nring = geo.theta.size
    ncap_side = nside - 1
    rows = np.concatenate([np.arange(ncap_side),
                           np.arange(nring - ncap_side, nring)])
    sizes = geo.mask.sum(1).astype(np.int64)
    out = []
    for c0, c1 in _chunks(rows.size, _CAP_RING_CHUNK):
        r = rows[c0:c1]
        lc = int(sizes[r].max())
        out.append(CapChunk(_upload(r, dev),
                            _upload(geo.phi_pad[r, :lc], dev),
                            _upload(geo.mask[r, :lc], dev)))
    return tuple(out)


def _recursion_tables(lmax: int, dev):
    """a_lm, b_lm of the normalized upward recursion for every (l, m),
    float32 in the JAX package's operation order, masked for l <= m."""
    lf = torch.arange(lmax + 1, dtype=torch.float32, device=dev)[:, None]
    m = torch.arange(lmax + 1, dtype=torch.float32, device=dev)[None, :]
    one = torch.ones((), device=dev)
    denom = lf * lf - m * m
    a = torch.sqrt((4.0 * lf * lf - 1.0)
                   / torch.where(denom > 0, denom, one))
    bn = (lf - 1.0) ** 2 - m * m
    bd = 4.0 * (lf - 1.0) ** 2 - 1.0
    b = torch.sqrt(torch.clamp_min(bn, 0.0) / torch.where(bd > 0, bd, one))
    return a.contiguous(), b.contiguous()


def _seed_state(mm_log2, log2_sin):
    """Scaled lambda_mm seeds (frac, scale) for every (m, ring)."""
    m = torch.arange(mm_log2.shape[0], dtype=torch.float32,
                     device=mm_log2.device)[:, None]
    log2_mm = mm_log2[:, None] + m * log2_sin[None, :]
    s0 = torch.clamp_min(torch.ceil((-log2_mm - 29.0) / 60.0), 0.0)
    sign = torch.where(torch.remainder(m, 2.0) == 0.0, 1.0, -1.0)
    frac = sign * torch.exp2(log2_mm + 60.0 * s0)
    return frac, s0


@lru_cache(maxsize=4)
def _sht_large_tables(nside: int, lmax: int, dev) -> LargeSHTTables:
    _check_lmax(nside, lmax)
    geo = ring_geometry(nside)
    theta = geo.theta
    x = np.cos(theta)
    sin_t = np.sin(theta)
    # lambda_mm = (-1)^m sqrt((2m+1)/(4pi)) sqrt(prod_k (2k-1)/(2k)) sin^m
    m = np.arange(lmax + 1, dtype=np.float64)
    ratio_log2 = np.zeros(lmax + 1)
    if lmax >= 1:
        ks = np.arange(1, lmax + 1, dtype=np.float64)
        ratio_log2[1:] = 0.5 * np.cumsum(np.log2((2 * ks - 1) / (2 * ks)))
    mm_log2 = 0.5 * np.log2((2 * m + 1) / (4.0 * np.pi)) + ratio_log2
    pad_idx, pad_valid = _pad_gather(geo)
    mm_t = _upload(mm_log2, dev)
    log2_sin = _upload(np.log2(np.maximum(sin_t, 1e-300)), dev)
    rec_a, rec_b = _recursion_tables(lmax, dev)
    frac, s0 = _seed_state(mm_t, log2_sin)
    return LargeSHTTables(
        _upload(x, dev), log2_sin, _upload(geo.phi_pad[:, 0], dev), mm_t,
        _cap_chunks(geo, nside, dev), _upload(geo.flat_idx, dev),
        _upload(pad_idx, dev), _upload(pad_valid, dev), rec_a, rec_b,
        frac, s0)


def sht_large_tables(nside: int, lmax: int, device=None) -> LargeSHTTables:
    """The scan path's device arrays for (nside, lmax), cached per device;
    raises ValueError for lmax > 4*nside - 1."""
    _check_lmax(nside, lmax)
    return _sht_large_tables(nside, lmax, _device_key(device))


# --------------------------------------------------- the scaled recursion
def _rescale_step(nxt, curr, s):
    """The 2^-60 rescale of the rows whose frac left 2^30 while s > 0
    (nxt, curr and s are the step's active rows, changed in place); returns
    lambda, zero where the scale has not reached 0."""
    big = (nxt.abs() > _TRIGGER) & (s > 0)
    scale = torch.where(big, _INV_RESCALE, 1.0)
    nxt.mul_(scale)
    curr.mul_(scale)
    s.sub_(big.to(s.dtype))
    return torch.where(s == 0, nxt, 0.0)


def _accumulate(out, inp, l: int, k: int, lam, synth: bool) -> None:
    """One step's contraction on the north rings.

    synthesis: out (2, C, lmax+1, nh) by the parity of l, inp (C, lmax+1,
      lmax+1) [., l, m]: out[l % 2, :, m, r] += inp[:, l, m] lam[m, r].
    analysis: out (C, lmax+1, lmax+1), inp (2, C, lmax+1, nh) by the parity
      of l: out[:, l, m] = sum_r lam[m, r] inp[l % 2, :, m, r].
    """
    if synth:
        out[l & 1, :, :k].addcmul_(inp[:, l, :k, None], lam)
    else:
        out[:, l, :k] = (lam * inp[l & 1, :, :k]).sum(-1)


def _row_schedule(lmax: int, ms, first: int = 0):
    """The rows a recursion carries: (first l, active rows at each l, the
    row seeded at each l or -1). Rows are every m (ms None) or the sorted
    m rows `ms`; a row is active from its seed on, l >= max(m, first)."""
    L1 = lmax + 1
    if ms is None:
        return first, [l + 1 for l in range(L1)], list(range(L1))
    ms = [int(m) for m in ms]
    where = {m: j for j, m in enumerate(ms)}
    active = [bisect_right(ms, l) for l in range(L1)]
    return (max(first, ms[0]) if ms else L1, active,
            [where.get(l, -1) for l in range(L1)])


def _sub_rows(t: torch.Tensor, ms, dim: int) -> torch.Tensor:
    """The rows `ms` of a per-m table along `dim` (t itself for None)."""
    if ms is None:
        return t
    return t.index_select(dim, torch.as_tensor(ms, device=t.device))


def recursion_rows(tab: LargeSHTTables, ms) -> LargeSHTTables:
    """`tab` with its per-m recursion tables cut to the sorted m rows `ms`
    (the input of the recursions' `ms` argument)."""
    return tab._replace(rec_a=_sub_rows(tab.rec_a, ms, 1),
                        rec_b=_sub_rows(tab.rec_b, ms, 1),
                        seed_frac=_sub_rows(tab.seed_frac, ms, 0),
                        seed_scale=_sub_rows(tab.seed_scale, ms, 0))


def _legendre_steps(tab: LargeSHTTables, lmax: int, inp, synth: bool,
                    ms=None):
    """The recursion over l for all m at once (or for the rows `ms`, with
    `tab` cut to them by `recursion_rows`), on the north rings and the
    equator (`_accumulate` gives the shapes, with the m axis over the
    rows carried)."""
    nh = _north(tab.x.shape[0])
    x = tab.x[:nh]
    L1 = lmax + 1
    nm = tab.seed_frac.shape[0]
    prev, curr, nxt = (torch.zeros((nm, nh), device=x.device)
                       for _ in range(3))
    s = tab.seed_scale[:, :nh].clone()
    nch = inp.shape[0] if synth else inp.shape[1]
    out = torch.zeros((2, nch, nm, nh) if synth else (nch, L1, nm),
                      device=x.device)
    first, active, seed = _row_schedule(lmax, ms)
    for l in range(first, L1):
        k = active[l]
        nk, ck, sk = nxt[:k], curr[:k], s[:k]
        # p_next = a (x p_curr - b p_prev); the row m = l takes its seed
        torch.mul(x, ck, out=nk)
        nk.addcmul_(tab.rec_b[l, :k, None], prev[:k], value=-1.0)
        nk.mul_(tab.rec_a[l, :k, None])
        if seed[l] >= 0:
            nk[seed[l]] = tab.seed_frac[seed[l], :nh]
        _accumulate(out, inp, l, k, _rescale_step(nk, ck, sk), synth)
        prev, curr, nxt = curr, nxt, prev
    return out


def _north(nring: int) -> int:
    """Rings north of the equator and the equator itself. Ring nring-1-r
    mirrors ring r < nring // 2: its cos(theta) is -x and its sin(theta)
    x's (exactly, in float32), so each recursion value there is (-1)^(l+m)
    the mirrored ring's, bit for bit."""
    return (nring + 1) // 2


def _m_signs(lmax: int, device, ms=None) -> torch.Tensor:
    """(lmax+1, 1), or (len(ms), 1) for the rows ms: (-1)^m."""
    m = (torch.arange(lmax + 1, device=device) if ms is None
         else torch.as_tensor(ms, device=device))[:, None]
    return torch.where(m % 2 == 0, 1.0, -1.0)


def _unfold_south(acc, nring: int, ms=None):
    """Synthesis sums of the north recursion by the parity of l, acc (2,
    C, rows, nh) -> (north (C, rows, nh), south (C, rows, nring - nh) in
    ring order): the mirror ring takes (-1)^(l+m), so south = (-1)^m (even
    l - odd l). Rows are every m or the rows `ms`."""
    nh = acc.shape[-1]
    sign = _m_signs(acc.shape[-2] - 1, acc.device, ms)
    south = (sign * (acc[0] - acc[1]))[..., : nring - nh].flip(-1)
    return acc[0] + acc[1], south


def _mirror_signed(q_south, nh: int, ms=None):
    """The mirror rings' analysis input q_south (C, rows, nring - nh), in
    ring order, on their north rings times (-1)^m: (C, rows, nh), zero on
    the equator. With the parity of l it gives the (-1)^(l+m) of the
    mirror (`_parity_inputs`)."""
    mirrored = q_south.new_zeros(q_south.shape[:-1] + (nh,))
    mirrored[..., : q_south.shape[-1]] = q_south.flip(-1)
    return _m_signs(q_south.shape[-2] - 1, q_south.device, ms) * mirrored


def _parity_inputs(own, signed):
    """(2, C, lmax+1, nh) analysis inputs of a north recursion by the
    parity of l: `own` (its north rings' input) beside `signed`
    (`_mirror_signed` of the rings whose values are its own mirrored),
    signed by l's parity: own + (-1)^(l+m) south."""
    return torch.stack([torch.cat([own, signed]), torch.cat([own, -signed])])


# CUDA graphs of the recursions, least recently used dropped first
_GRAPHS: "OrderedDict" = OrderedDict()
_GRAPH_CACHE = 16


def _graphed(key, keep, steps, inp):
    """steps(inp); on the card replayed from a CUDA graph captured at the
    first call for `key` (after one warm-up run), `inp` copied into the
    graph's own input. A recursion launches ~17 small kernels a step,
    ~35k a transform at lmax 2048, and the host's time a launch would
    bound it. `keep` (the tables the graph reads) stays referenced with
    it."""
    if not inp.is_cuda:
        return steps(inp)
    key = key + (tuple(inp.shape), inp.device)
    entry = _GRAPHS.pop(key, None)
    if entry is None:
        static = inp.clone()
        side = torch.cuda.Stream(device=inp.device)
        side.wait_stream(torch.cuda.current_stream(inp.device))
        with torch.cuda.stream(side):
            steps(static)
        torch.cuda.current_stream(inp.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = steps(static)
        entry = (keep, graph, static, out)
    _GRAPHS[key] = entry
    while len(_GRAPHS) > _GRAPH_CACHE:
        _GRAPHS.popitem(last=False)
    _, graph, static, out = entry
    static.copy_(inp)
    graph.replay()
    return out.clone()


def _legendre_loop(tab: LargeSHTTables, lmax: int, alm=None, q=None,
                   ms=None):
    """The scalar recursion on the north rings (`_legendre_steps`), the
    south rings from their mirrors.

    synthesis (alm = (re, im), each (lmax+1, lmax+1) [l, m]): returns
      (2, lmax+1, nring) c[m, r] = sum_l alm[l, m] lambda_lm(theta_r).
    analysis (q = (re, im), each (lmax+1, nring) [m, r]): returns
      (2, lmax+1, lmax+1) a[l, m] = sum_r lambda_lm(theta_r) q[m, r].
    With the sorted m rows `ms` (and `tab` cut to them by
    `recursion_rows`) only those m come out: (2, len(ms), nring) c and
    (2, lmax+1, len(ms)) a, the full call's values bit for bit.
    """
    nring = tab.x.shape[0]
    nh = _north(nring)
    synth = alm is not None
    if synth:
        inp = _sub_rows(torch.stack(alm), ms, 2)
    else:
        q = _sub_rows(torch.stack(q), ms, 1)
        signed = _mirror_signed(q[..., nh:], nh, ms)
        inp = torch.stack([q[..., :nh] + signed, q[..., :nh] - signed])
    rows = None if ms is None else tuple(int(m) for m in ms)
    with _span("sht.legendre"):
        out = _graphed(("scalar", synth, id(tab), rows), tab,
                       lambda z: _legendre_steps(tab, lmax, z, synth, rows),
                       inp)
    if not synth:
        return out
    north, south = _unfold_south(out, nring, ms)
    return torch.cat([north, south], dim=-1)


# ------------------------------------------------------------- cap rings
def _cap_core_apply(coef_cos, coef_sin, caps, lmax: int, plane=None,
                    out=None):
    """Trig sums over the cap rings: the one home of the cap chunking
    (sht_spin_large uses it too).

    synthesis (coef_* (lmax+1, nring), ring-indexed): writes
      plane[rows, :Lc] = mask * sum_m coef_cos cos(m phi) + coef_sin
      sin(m phi) into `out` (nring, pmax).
    analysis (plane (nring, pmax)): returns (dc, ds), each (lmax+1, nring)
      with the cap columns = (sum_p plane cos(m phi), sum_p plane sin(m
      phi)) and zero elsewhere.
    """
    with _span("sht.caps"):
        if plane is None:
            for ch in caps:
                c, lc = ch.phi.shape
                acc = torch.zeros((c, lc), device=ch.phi.device)
                a_c = coef_cos[:, ch.rows]
                b_c = coef_sin[:, ch.rows]
                for m0, m1 in _chunks(lmax + 1, _CHUNK_ELEMS // (c * lc)):
                    ms = torch.arange(m0, m1, dtype=torch.float32,
                                      device=ch.phi.device)
                    ang = ms[:, None, None] * ch.phi[None]
                    acc += ((a_c[m0:m1, :, None] * torch.cos(ang)).sum(0)
                            + (b_c[m0:m1, :, None] * torch.sin(ang)).sum(0))
                out[ch.rows, :lc] = acc * ch.mask
            return out
        nring = plane.shape[0]
        dc = torch.zeros((lmax + 1, nring), device=plane.device)
        ds = torch.zeros_like(dc)
        for ch in caps:
            c, lc = ch.phi.shape
            mp = plane[ch.rows, :lc] * ch.mask
            for m0, m1 in _chunks(lmax + 1, _CHUNK_ELEMS // (c * lc)):
                ms = torch.arange(m0, m1, dtype=torch.float32,
                                  device=plane.device)
                ang = ms[:, None, None] * ch.phi[None]
                dc[m0:m1, ch.rows] = (mp[None] * torch.cos(ang)).sum(-1)
                ds[m0:m1, ch.rows] = (mp[None] * torch.sin(ang)).sum(-1)
        return dc, ds


def _rotate_phase(c_re, c_im, phi0, sign=1.0):
    """c * e^{i sign m phi0}; c_* (lmax+1, R), phi0 (R,)."""
    ms = torch.arange(c_re.shape[0], dtype=torch.float32,
                      device=c_re.device)[:, None]
    ang = sign * ms * phi0[None, :]
    cs, sn = torch.cos(ang), torch.sin(ang)
    return c_re * cs - c_im * sn, c_re * sn + c_im * cs


def _belt(nside: int, nring: int) -> slice:
    return slice(nside - 1, nring - (nside - 1))


def _plane_to_map(plane, tab):
    return plane.reshape(-1)[tab.flat_idx]


def _map_to_plane(hpmap, tab, nring: int, n: int):
    return (hpmap[tab.pad_idx] * tab.pad_valid).reshape(nring, n)


def _synth_from_c(c_re, c_im, tab: LargeSHTTables, nside: int, lmax: int):
    """Ring-coefficient tail of synthesis: (lmax+1, nring) c -> RING map."""
    nring = tab.x.shape[0]
    n = 4 * nside
    belt = _belt(nside, nring)
    plane = torch.zeros((nring, n), device=c_re.device)
    with _span("sht.belt_fft"):
        cb_re, cb_im = _rotate_phase(c_re[:, belt], c_im[:, belt],
                                     tab.phi0[belt])
        mlo = min(lmax, n // 2)
        fac = torch.full((mlo + 1,), float(n), device=c_re.device)
        if mlo == n // 2:
            fac[n // 2] = 2.0 * n
        nbelt = cb_re.shape[1]
        G = torch.zeros((nbelt, n // 2 + 1), dtype=torch.complex64,
                        device=c_re.device)
        G[:, : mlo + 1] = torch.complex(cb_re[: mlo + 1],
                                        cb_im[: mlo + 1]).T * fac[None, :]
        if lmax > n // 2:
            # alias fold: 2 Re(c e^{2pi i m p/n}) = 2 Re(conj(c) e^{2pi i
            # (n-m) p/n}) for m > n/2: the conjugate coefficient adds into
            # rfft bin n-m (which irfft weights by 2/n)
            mh = torch.arange(n // 2 + 1, lmax + 1, device=c_re.device)
            G.index_add_(1, n - mh, torch.complex(
                cb_re[mh], -cb_im[mh]).T * float(n))
        # irfft reads only the real part of bins 0 and n/2
        G[:, 0] = G[:, 0].real.to(G.dtype)
        G[:, n // 2] = G[:, n // 2].real.to(G.dtype)
        plane[belt] = torch.fft.irfft(G, n=n, dim=1)
    # caps: direct trig evaluation with the m >= 1 doubling
    wm = _m_weights(lmax, c_re.device)
    _cap_core_apply(c_re * wm, -(c_im * wm), tab.caps, lmax, out=plane)
    return _plane_to_map(plane, tab)


def _quadrature_sums(hpmap, tab: LargeSHTTables, nside: int, lmax: int):
    """Quadrature-sum head of analysis: RING map -> d[m, r] =
    sum_p map e^{-im phi_rp}, (lmax+1, nring) each of re and im."""
    nring = tab.x.shape[0]
    n = 4 * nside
    belt = _belt(nside, nring)
    plane = _map_to_plane(hpmap, tab, nring, n)
    # caps: direct adjoint trig sums (zero on the belt columns)
    d_re, d_im = _cap_core_apply(None, None, tab.caps, lmax, plane=plane)
    d_im = -d_im
    with _span("sht.belt_fft"):
        F = torch.fft.rfft(plane[belt], dim=1)  # sum_p x e^{-2pi i k p/n}
        mlo = min(lmax, n // 2)
        b_re = F.real.T[: mlo + 1]
        b_im = F.imag.T[: mlo + 1]
        if lmax > n // 2:
            # alias unfold: sum_p x e^{-2pi i m p/n} = conj(F[n-m]) for
            # real x
            mh = torch.arange(n // 2 + 1, lmax + 1, device=hpmap.device)
            b_re = torch.cat([b_re, F.real.T[n - mh]])
            b_im = torch.cat([b_im, -F.imag.T[n - mh]])
        b_re, b_im = _rotate_phase(b_re, b_im, tab.phi0[belt], sign=-1.0)
        d_re[:, belt] = b_re
        d_im[:, belt] = b_im
    return d_re, d_im


def _synth_large_impl(alm_re, alm_im, tab: LargeSHTTables, nside: int,
                      lmax: int):
    c = _legendre_loop(tab, lmax, alm=(alm_re, alm_im))
    return _synth_from_c(c[0], c[1], tab, nside, lmax)


def _adjoint_large_impl(hpmap, tab: LargeSHTTables, nside: int,
                        lmax: int):
    npix = hpmap.shape[0]
    d_re, d_im = _quadrature_sums(hpmap, tab, nside, lmax)
    a = _legendre_loop(tab, lmax, q=(d_re, d_im))
    wq = 4.0 * np.pi / npix
    return wq * a[0], wq * a[1]


def _tables_for(t: torch.Tensor, nside: int, lmax: int, tables):
    return tables if tables is not None else sht_large_tables(
        nside, lmax, t.device)


def synthesize_large(alm_re, alm_im, nside: int, lmax: int,
                     tables: Optional[LargeSHTTables] = None, device=None):
    """Real-field SH synthesis without Legendre tables (lmax <= 4*nside-1)."""
    _check_lmax(nside, lmax)
    a_re, a_im = _alm_pair(alm_re, alm_im, device, tables)
    tab = _tables_for(a_re, nside, lmax, tables)
    return _synth_large_impl(a_re, a_im, tab, nside, lmax)


def _vdot(u, v):
    """Real inner product summed over the leaves of two tuples (a 0-dim
    tensor on their device)."""
    return sum((a * b).sum() for a, b in zip(u, v))


def _cg(matvec, b, x0, maxiter: int, tol: float = 1e-5, atol: float = 0.0):
    """jax.scipy.sparse.linalg.cg on tuples of tensors, unpreconditioned:
    r0 = b - A x0, then up to `maxiter` steps while |r|^2 > max(tol^2
    |b|^2, atol^2). The stopping test stays on the device: a converged
    iteration keeps its x (no host sync per step)."""
    atol2 = torch.clamp_min(tol ** 2 * _vdot(b, b), atol ** 2)
    x = x0
    r = tuple(bi - ai for bi, ai in zip(b, matvec(x0)))
    p = r
    gamma = _vdot(r, r)
    for _ in range(maxiter):
        active = gamma > atol2
        Ap = matvec(p)
        alpha = gamma / _vdot(p, Ap)
        x_new = tuple(xi + alpha * pi for xi, pi in zip(x, p))
        r_new = tuple(ri - alpha * api for ri, api in zip(r, Ap))
        gamma_new = _vdot(r_new, r_new)
        beta = gamma_new / gamma
        p_new = tuple(ri + beta * pi for ri, pi in zip(r_new, p))
        x = tuple(torch.where(active, a, b) for a, b in zip(x_new, x))
        r = tuple(torch.where(active, a, b) for a, b in zip(r_new, r))
        p = tuple(torch.where(active, a, b) for a, b in zip(p_new, p))
        gamma = torch.where(active, gamma_new, gamma)
    return x


def _check_method(method: str) -> None:
    # a typo would otherwise run Jacobi silently, which is badly biased
    # exactly where CG matters (lmax > 2*nside)
    if method not in ("auto", "cg", "jacobi"):
        raise ValueError(f"method must be 'auto', 'cg' or 'jacobi', got "
                         f"{method!r}")


def analyze_with(hpmap, nside: int, lmax: int, niter: int, method: str,
                 synth, adjoint):
    """The jacobi / cg analysis driver on given transforms: synth(a_re,
    a_im) -> map and adjoint(map) -> (a_re, a_im) (the single-device ones
    or the m-sharded ones of parallel/sht_large.py). method as in
    `analyze_large`."""
    _check_method(method)
    if method == "auto":
        method = "cg" if lmax > 2 * nside else "jacobi"
    b = adjoint(hpmap)
    if method == "cg" and niter > 0:
        # the quadrature adjoint A omits the m>0 factor 2 that synthesis
        # carries, so A∘S = D^-1 S^T S is not symmetric: the matvec
        # restores the transpose with the m-weighting, D(A(S(a))) =
        # S^T S a; x0 keeps A(m) as the initial guess
        wm = _m_weights(lmax, hpmap.device)[:, 0][None, :]

        def mul_w(t):
            return t[0] * wm, t[1] * wm

        def matvec(a):
            return mul_w(adjoint(synth(a[0], a[1])))

        return _cg(matvec, mul_w(b), b, niter)
    a_re, a_im = b
    for _ in range(niter):
        resid = hpmap - synth(a_re, a_im)
        d_re, d_im = adjoint(resid)
        a_re, a_im = a_re + d_re, a_im + d_im
    return a_re, a_im


def analyze_large(hpmap, nside: int, lmax: int, niter: int = 3,
                  tables: Optional[LargeSHTTables] = None,
                  method: str = "auto", device=None):
    """Real-field SH analysis without Legendre tables (lmax <= 4*nside-1).

    method: 'jacobi' runs healpy-style residual iterations (a_{k+1} =
    a_k + A(m - S a_k)); 'cg' solves the normal equations S^T S a = S^T m
    by conjugate gradient with `niter` iterations (after one residual
    matvec), which resolves the nearly-degenerate belt-aliased mode pairs
    of the lmax > 2*nside band far faster; 'auto' picks cg there and
    jacobi otherwise.
    """
    _check_method(method)
    _check_lmax(nside, lmax)
    hpmap = _map(hpmap, device, tables)
    tab = _tables_for(hpmap, nside, lmax, tables)
    return analyze_with(
        hpmap, nside, lmax, niter, method,
        lambda a_re, a_im: _synth_large_impl(a_re, a_im, tab, nside, lmax),
        lambda m: _adjoint_large_impl(m, tab, nside, lmax))


def synfast_large_from_white(white_re, white_im, cl, nside: int,
                             lmax: Optional[int] = None,
                             tables: Optional[LargeSHTTables] = None,
                             device=None):
    """`synfast_large` of given N(0, 1) draws (the JAX package's
    normal(k1), normal(k2) of `k1, k2 = split(key)`)."""
    if not isinstance(cl, torch.Tensor):
        device = _white_device(white_re, device, tables)
    cl, L = _spectrum(cl, lmax, device)
    a_re, a_im = _gaussian_alms(white_re, white_im, cl, L)
    return synthesize_large(a_re, a_im, nside, L, tables=tables)


def synfast_large(generator: torch.Generator, cl, nside: int,
                  lmax: Optional[int] = None,
                  tables: Optional[LargeSHTTables] = None):
    """Gaussian random map from Cl at large lmax on the generator's device
    (hp.synfast parity; cl is zero-padded beyond its table)."""
    cl, L = _spectrum(cl, lmax, generator.device)
    white_re, white_im = _white_pair(generator, L)
    return synfast_large_from_white(white_re, white_im, cl, nside, L,
                                    tables=tables)


def anafast_large(hpmap, lmax: int, niter: int = 3,
                  tables: Optional[LargeSHTTables] = None,
                  method: str = "auto", device=None):
    """Cl of a RING map at large lmax (hp.anafast parity)."""
    hpmap = _map(hpmap, device, tables)
    nside = hpx.npix2nside(hpmap.shape[0])
    a_re, a_im = analyze_large(hpmap, nside, lmax, niter=niter,
                               tables=tables, method=method)
    return alm2cl(a_re, a_im)


def smoothing_large(hpmap, fwhm_rad: float, lmax: int, niter: int = 3,
                    tables: Optional[LargeSHTTables] = None,
                    method: str = "auto", device=None):
    """Harmonic Gaussian smoothing at large lmax (hp.smoothing parity)."""
    hpmap = _map(hpmap, device, tables)
    nside = hpx.npix2nside(hpmap.shape[0])
    tab = _tables_for(hpmap, nside, lmax, tables)
    a_re, a_im = analyze_large(hpmap, nside, lmax, niter=niter, tables=tab,
                               method=method)
    bl = _beam_window(fwhm_rad, lmax, hpmap.device)
    return synthesize_large(a_re * bl, a_im * bl, nside, lmax, tables=tab)
