"""Flat-sky filter bank as FFT operations on torch tensors.

Port of astrild_tpu/ops/filters.py: Gaussian low / high-pass, derivative of
Gaussian and the DGD3 dipole filter, the compensated Gaussian, aperture
photometry, Hann apodization, the compensated top-hat, PCA foreground
separation over map tiles, and dictionary-learning denoising (host sklearn,
raising ImportError without it, as the JAX function does).

Filters act on (npix, npix) maps as FFT multiplies. `theta` is the map opening angle in degrees; filter scales are
in arcmin. The frequencies are the JAX package's `fftfreq(n) * 2 pi` in
float32 (not integer mode numbers: the reference's transfer functions are
built from those floats), and every scalar enters as a float32 tensor, as
a weakly typed Python scalar does in JAX. Numpy input goes to `device`, by
default the CUDA card (it raises without one); tensors keep their device.

`gaussian_derivative`, `dgd3`, `dgd3_window` and `aperture_photometry`
also take their filter scale as a tensor, one scale per image of a batch
(the moving-lens estimators of models/dipoles.py, which the JAX package
vmaps): such a scale is a traced float32 value in JAX, so every quantity
derived from it (the scale in pixels, the window's Gaussian widths, the
aperture's ring radius, a decision) follows the float32 arithmetic in
the JAX source's order, where a Python float scale is folded in float64
first. A float scale keeps the scalar path.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .._device import as_tensor, default_device

__all__ = [
    "sigma_to_fwhm", "fwhm_to_sigma", "gaussian", "gaussian_high_pass",
    "gaussian_derivative", "dgd3", "dgd3_window", "gaussian_compensated",
    "aperture_photometry", "apodization", "tophat_compensated",
    "fft_smooth", "pca_foreground_separation",
    "dictionary_learning_denoise",
]

_FWHM_FACTOR = 2.0 * math.sqrt(2.0 * math.log(2.0))


def sigma_to_fwhm(sigma):
    return sigma * _FWHM_FACTOR


def fwhm_to_sigma(fwhm):
    return fwhm / _FWHM_FACTOR


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _fftfreq(n: int, device):
    """jnp.fft.fftfreq(n) in float32: the integers 0..ceil(n/2)-1, -n//2..-1
    divided by float32 n."""
    k = torch.cat([torch.arange(0, (n + 1) // 2, device=device),
                   torch.arange(-(n // 2), 0, device=device)])
    return k.to(torch.float32) / _f32(float(n), device)


def _pix_freqs(npix: int, device):
    """Angular frequencies [1/pixel] * 2 pi for both axes, as the JAX
    package forms them: (fftfreq * 2.0) * pi, in float32."""
    k = _fftfreq(npix, device) * _f32(2.0, device) * _f32(math.pi, device)
    return k[:, None], k[None, :]


def _real(z):
    """The real part of a complex tensor as a contiguous tensor of its own
    (`.real` is a strided view that keeps the complex buffer alive)."""
    return z.real.contiguous()


def fft_smooth(img, transfer):
    """Multiply img's FFT by a transfer function and return the real part."""
    return _real(torch.fft.ifft2(torch.fft.fft2(img) * transfer))


def _sigma_pix(npix, theta_deg, scale_arcmin):
    """Convert an arcmin filter scale to pixels."""
    return scale_arcmin / 60.0 * npix / theta_deg


def _batched_scale_pix(npix: int, theta_deg, scale_arcmin):
    """A tensor filter scale [arcmin], one per image, in pixels as the JAX
    package's traced float32 arithmetic gives it: ((scale / 60) * npix) /
    theta, shaped (nd, 1, 1) for (nd, npix, npix) images."""
    scale = scale_arcmin.to(torch.float32).reshape(-1, 1, 1)
    dev = scale.device
    return ((scale / _f32(60.0, dev)) * _f32(float(npix), dev)
            / _f32(theta_deg, dev))


def _gaussian_transfer(n: int, sigma_pix, device):
    k1, k2 = _pix_freqs(n, device)
    sp = _f32(sigma_pix, device)
    return torch.exp(_f32(-0.5, device) * sp ** 2 * (k1 ** 2 + k2 ** 2))


def gaussian(img, theta_deg, sigma_arcmin=None, fwhm_arcmin=None,
             device=None):
    """Gaussian low-pass filter; the kernel scale as sigma or FWHM
    [arcmin]."""
    if sigma_arcmin is None:
        if fwhm_arcmin is None:
            raise ValueError("need sigma_arcmin or fwhm_arcmin")
        sigma_arcmin = fwhm_to_sigma(fwhm_arcmin)
    img = as_tensor(img, device)
    sp = _sigma_pix(img.shape[-1], theta_deg, sigma_arcmin)
    return fft_smooth(img, _gaussian_transfer(img.shape[-1], sp, img.device))


def gaussian_high_pass(img, theta_deg, sigma_arcmin=None, fwhm_arcmin=None,
                       device=None):
    """img minus its Gaussian low-pass."""
    img = as_tensor(img, device)
    return img - gaussian(img, theta_deg, sigma_arcmin, fwhm_arcmin)


def _integer_pow(z, n: int):
    """z ** n by lax.integer_pow's binary exponentiation (x * (x * x) for
    n = 3), 1 for n = 0."""
    if n == 0:
        return torch.ones_like(z)
    acc = None
    while n > 0:
        if n & 1:
            acc = z if acc is None else acc * z
        n >>= 1
        if n > 0:
            z = z * z
    return acc


def gaussian_derivative(img, theta_deg, sigma_arcmin,
                        orders: Tuple[int, int], device=None):
    """Derivative-of-Gaussian filter: conv with d^o0/dx0 d^o1/dx1 G_sigma.

    Spectral version of scipy.ndimage.gaussian_filter(..., order=orders);
    derivatives are with respect to pixel coordinates. A tensor
    sigma_arcmin (nd,) filters a batch of nd images with one scale each.
    """
    img = as_tensor(img, device)
    dev = img.device
    n = img.shape[-1]
    if isinstance(sigma_arcmin, torch.Tensor):
        sp = _batched_scale_pix(n, theta_deg, sigma_arcmin.to(dev))
    else:
        sp = _f32(_sigma_pix(n, theta_deg, sigma_arcmin), dev)
    k1, k2 = _pix_freqs(n, dev)
    transfer = torch.exp(_f32(-0.5, dev) * sp ** 2 * (k1 ** 2 + k2 ** 2)
                         ).to(torch.complex64)
    ik1 = torch.complex(torch.zeros_like(k1), k1)
    ik2 = torch.complex(torch.zeros_like(k2), k2)
    transfer = (transfer * _integer_pow(ik1, orders[0])
                * _integer_pow(ik2, orders[1]))
    return _real(torch.fft.ifft2(torch.fft.fft2(img) * transfer))


def dgd3(img, theta_deg, theta_i_arcmin, axis: int = 0, device=None):
    """DGD3 dipole filter (Yasini+18, arxiv:1812.04241): third-derivative
    Gaussians at scales (0.5, 1, 2) * theta_i, g(0.5) - g(1) + g(2), the
    derivative along `axis`. A tensor theta_i_arcmin (nd,) filters a batch
    of nd images with one scale each."""
    img = as_tensor(img, device)
    orders = (3, 0) if axis == 0 else (0, 3)
    g1 = gaussian_derivative(img, theta_deg, 0.5 * theta_i_arcmin, orders)
    g2 = gaussian_derivative(img, theta_deg, 1.0 * theta_i_arcmin, orders)
    g3 = gaussian_derivative(img, theta_deg, 2.0 * theta_i_arcmin, orders)
    return g1 - g2 + g3


def dgd3_window(npix: int, theta_deg, theta_i_arcmin, axis: int = 1,
                device=None):
    """Centered analytic DGD3 window W = sum_i s_i d^3/du^3 G(sigma_i), the
    matched filter of the moving-lens estimator (v_x = -c <W_x, dT> /
    <W_x, alpha_x>). axis=1 differentiates along array axis 1, axis=0
    along axis 0. Made on `device`, by default the CUDA card. A tensor
    theta_i_arcmin (nd,) gives (nd, npix, npix) windows, one per scale
    (on the scale's device), in the traced float32 arithmetic."""
    if isinstance(theta_i_arcmin, torch.Tensor):
        return _dgd3_window_batched(npix, theta_deg, theta_i_arcmin, axis)
    dev = default_device(device)
    sp = _sigma_pix(npix, theta_deg, theta_i_arcmin)
    e = (torch.arange(npix, device=dev) - npix // 2).to(torch.float32)
    r2 = e[:, None] ** 2 + e[None, :] ** 2
    ones = torch.ones(npix, device=dev)
    u = e[None, :] * ones[:, None] if axis == 1 else e[:, None] * ones[None]
    w = torch.zeros((npix, npix), device=dev)
    for s, sign in ((0.5, 1.0), (1.0, -1.0), (2.0, 1.0)):
        sig = s * sp
        g = (torch.exp(-r2 / _f32(2.0 * sig ** 2, dev))
             / _f32(2.0 * math.pi * sig ** 2, dev))
        w = w + _f32(sign, dev) * (
            _f32(3.0, dev) * u / _f32(sig ** 4, dev)
            - _integer_pow(u, 3) / _f32(sig ** 6, dev)) * g
    return w


def _dgd3_window_batched(npix: int, theta_deg, theta_i_arcmin, axis: int):
    """`dgd3_window` for (nd,) scales, each Gaussian width and its powers a
    float32 value: g = exp(-r2 / (2 sig^2)) / (f32(2 pi) sig^2), term
    sign * ((3 u) / sig^4 - u^3 / sig^6) * g, as lax.integer_pow forms
    the powers."""
    sp = _batched_scale_pix(npix, theta_deg, theta_i_arcmin)
    dev = sp.device
    e = (torch.arange(npix, device=dev) - npix // 2).to(torch.float32)
    r2 = e[:, None] ** 2 + e[None, :] ** 2
    ones = torch.ones(npix, device=dev)
    u = e[None, :] * ones[:, None] if axis == 1 else e[:, None] * ones[None]
    two_pi = _f32(2.0 * math.pi, dev)
    w = None
    for s, sign in ((0.5, 1.0), (1.0, -1.0), (2.0, 1.0)):
        sig = _f32(s, dev) * sp
        sig2 = _integer_pow(sig, 2)
        g = torch.exp(-r2 / (_f32(2.0, dev) * sig2)) / (two_pi * sig2)
        term = _f32(sign, dev) * (
            _f32(3.0, dev) * u / _integer_pow(sig, 4)
            - _integer_pow(u, 3) / _integer_pow(sig, 6)) * g
        w = term if w is None else w + term
    return w


def gaussian_compensated(img, theta_deg, theta_i_arcmin, theta_o_arcmin,
                         device=None):
    """Compensated-Gaussian filter (arxiv:1907.06657 Eq. 16):
    W(theta) = e^(-x^2)/(pi t_i^2) - (1 - e^(-x_o^2))/(pi t_o^2) for
    theta <= theta_o, else 0; x = theta/t_i (pixel units)."""
    img = as_tensor(img, device)
    dev = img.device
    n = img.shape[-1]
    pw_deg = theta_deg / n
    ti = theta_i_arcmin / 60.0 / pw_deg  # pixels
    to = theta_o_arcmin / 60.0 / pw_deg
    # the centered kernel on the full map grid (wrap-around layout)
    ax = torch.arange(n, device=dev)
    ax = torch.where(ax > n // 2, ax - n, ax).to(torch.float32)
    dist = torch.sqrt(ax[:, None] ** 2 + ax[None, :] ** 2)
    x = dist / _f32(ti, dev)
    xo = to / ti
    floor = ((_f32(1.0, dev) - torch.exp(_f32(-xo ** 2, dev)))
             / _f32(math.pi * to ** 2, dev))
    w = torch.exp(-x ** 2) / _f32(math.pi * ti ** 2, dev) - floor
    w = torch.where(dist <= _f32(to, dev), w, torch.zeros_like(w))
    return _real(torch.fft.ifft2(torch.fft.fft2(img) * torch.fft.fft2(w)))


def _centered_dist(n: int, device):
    """Distance of each pixel centre from the image centre [pixels]."""
    from .profiles3d import _linspace_f32

    e = (_linspace_f32(1.0, float(n), n, device) - _f32(n / 2.0, device)
         - _f32(0.5, device))
    return torch.sqrt(e[:, None] ** 2 + e[None, :] ** 2)


def _masked_mean(img, mask):
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    return (torch.sum(torch.where(mask, img, zero))
            / torch.clamp_min(torch.sum(mask), 1).to(img.dtype))


def aperture_photometry(img, theta_deg, alpha_arcmin, device=None):
    """kSZ-style ring-mean subtraction (arxiv:1607.02139 Sec III.B):
    subtract from the whole image the mean of the ring [alpha,
    alpha*sqrt(2)] around the image centre. A tensor alpha_arcmin (nd,)
    takes a batch of nd images, one ring radius each."""
    img = as_tensor(img, device)
    dev = img.device
    n = img.shape[-1]
    dist = _centered_dist(n, dev)
    if isinstance(alpha_arcmin, torch.Tensor):
        # one ring per image: the radius ceil((alpha / 60) * f32(n /
        # theta)) is a decision on a float32 value
        alpha = alpha_arcmin.to(dev, torch.float32).reshape(-1, 1, 1)
        alpha_pix = torch.ceil(alpha / _f32(60.0, dev)
                               * _f32(n / theta_deg, dev))
        ring = (dist > alpha_pix) & (dist < alpha_pix
                                     * torch.sqrt(_f32(2.0, dev)))
        zero = torch.zeros((), dtype=img.dtype, device=dev)
        ringsum = torch.where(ring, img, zero).sum(dim=(-2, -1),
                                                   keepdim=True)
        cnt = torch.clamp_min(ring.sum(dim=(-2, -1), keepdim=True), 1)
        return img - ringsum / cnt.to(img.dtype)
    alpha_pix = torch.ceil(_f32(alpha_arcmin / 60.0 * (n / theta_deg), dev))
    ring = (dist > alpha_pix) & (dist < alpha_pix
                                 * torch.sqrt(_f32(2.0, dev)))
    return img - _masked_mean(img, ring)


def _hann(n: int, device):
    """Symmetric Hann window, scipy.signal.hann(sym=True)."""
    i = torch.arange(n, device=device).to(torch.float32)
    return _f32(0.5, device) * (_f32(1.0, device) - torch.cos(
        _f32(2.0 * math.pi, device) * i / _f32(float(n - 1), device)))


def apodization(img, device=None):
    """Hann-window apodization."""
    img = as_tensor(img, device)
    w = _hann(img.shape[-1], img.device)
    return img * (w[:, None] * w[None, :])


def tophat_compensated(img, theta_deg, rad_obj_arcmin, alpha: float = 0.65,
                       device=None):
    """Compensated top-hat statistic about the image centre (DOI
    10.1088/0004-637X/786/2/110): mean within alpha*rad minus mean in
    [alpha*rad, sqrt(2)*alpha*rad]. Returns a 0-d tensor."""
    img = as_tensor(img, device)
    dev = img.device
    n = img.shape[-1]
    dist = _centered_dist(n, dev)
    rad_pix = _f32(alpha * rad_obj_arcmin / 60.0 * (n / theta_deg), dev)
    disk = dist <= rad_pix
    ring = (dist > rad_pix) & (dist <= torch.sqrt(_f32(2.0, dev)) * rad_pix)
    return _masked_mean(img, disk) - _masked_mean(img, ring)


def _tile_stack(img, ntiles: int):
    t = img.shape[-1] // ntiles
    return torch.stack([img[i * t:(i + 1) * t, j * t:(j + 1) * t]
                        for i in range(ntiles) for j in range(ntiles)])


def _tile_merge(tiles):
    ntiles = int(np.sqrt(tiles.shape[0]))
    rows = [torch.hstack([tiles[i * ntiles + j] for j in range(ntiles)])
            for i in range(ntiles)]
    return torch.vstack(rows)


def pca_foreground_separation(noisy_img, ntiles: int = 8,
                              n_components: int = 5, device=None):
    """CMB/foreground separation by PCA over map tiles: the map is tiled,
    the `n_components` dominant principal components across tiles and the
    tile mean are removed, and the residual is re-merged (SVD on the
    device). The reconstruction (u * s_cut) @ vt is a sum of outer
    products formed elementwise, so a caller's TF32 setting cannot reach
    it."""
    tiles = _tile_stack(as_tensor(noisy_img, device), ntiles)
    nt, t, _ = tiles.shape
    x = tiles.reshape(nt, t * t)
    xc = x - torch.mean(x, dim=0)
    u, s, vt = torch.linalg.svd(xc, full_matrices=False)
    us = u * torch.cat([torch.zeros_like(s[:n_components]),
                        s[n_components:]])
    cleaned = torch.zeros_like(xc)
    for k in range(n_components, s.shape[0]):
        cleaned = cleaned + us[:, k, None] * vt[None, k]
    return _tile_merge(cleaned.reshape(nt, t, t))


def _host_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def dictionary_learning_denoise(clean_img, noisy_img, ntiles: int = 8,
                                n_components: int = 5):
    """Dictionary-learning denoising: a sparse dictionary learned on tiles
    of the clean map reconstructs the noisy map in that basis (sklearn
    MiniBatchDictionaryLearning, on the host; raises ImportError without
    sklearn). Returns a numpy map."""
    try:
        from sklearn.decomposition import MiniBatchDictionaryLearning
    except ImportError as e:
        raise ImportError("dictionary_learning_denoise needs sklearn") from e

    def stack(img):
        img = _host_f32(img)
        t = img.shape[-1] // ntiles
        return np.stack([img[i * t:(i + 1) * t, j * t:(j + 1) * t]
                         for i in range(ntiles) for j in range(ntiles)])

    clean, noisy = stack(clean_img), stack(noisy_img)
    nt, t, _ = clean.shape
    dico = MiniBatchDictionaryLearning(n_components=n_components,
                                       alpha=1.0, max_iter=50,
                                       transform_algorithm="lasso_lars")
    dico.fit(clean.reshape(nt, -1))
    code = dico.transform(noisy.reshape(nt, -1))
    rec = (code @ dico.components_).reshape(nt, t, t).astype(np.float32)
    rows = [np.hstack([rec[i * ntiles + j] for j in range(ntiles)])
            for i in range(ntiles)]
    return np.vstack(rows)
