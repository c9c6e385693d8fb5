"""PyTorch port vs JAX package on the CPU: bispectrum, lensing maps, the
resize of the lensing stage, peaks and tunnels voids.

Inputs are made with numpy from a seed and handed to both packages; each
tolerance is stated where it is checked.
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from astrild_tpu.ops import bispectrum as JB  # noqa: E402
from astrild_tpu.ops import lensing as JL  # noqa: E402
from astrild_tpu.ops import paint as JP  # noqa: E402
from astrild_tpu.ops import peaks as JK  # noqa: E402
from astrild_tpu.ops import voids as JV  # noqa: E402
from astrild_tpu_torch.ops import bispectrum as TB  # noqa: E402
from astrild_tpu_torch.ops import lensing as TL  # noqa: E402
from astrild_tpu_torch.ops import peaks as TK  # noqa: E402
from astrild_tpu_torch.ops import voids as TV  # noqa: E402
from astrild_tpu_torch.utils.tables import tables_from_numpy  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    # beside JAX in one process, torch's first threaded float32 sqrt now
    # and then comes back 2^-12 low on the second thread's half of the
    # array; a first call below the threading grain settles it
    torch.sqrt(torch.ones(16))
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def T(a):
    return torch.from_numpy(np.array(a))


def _smooth_map(rng, n, scale=3):
    """A smooth random (n, n) float32 map: white noise with a Gaussian
    low-pass, so peaks and voids have realistic sizes."""
    k = np.fft.fftfreq(n)
    filt = np.exp(-0.5 * (k[:, None] ** 2 + k[None, :] ** 2)
                  * (2 * np.pi * scale) ** 2)
    img = np.fft.ifft2(np.fft.fft2(rng.normal(size=(n, n))) * filt).real
    return (img / img.std()).astype(np.float32)


# --------------------------------------------------------- bispectrum
@pytest.mark.parametrize("cfg", [(32, 4, 2.0, 8.0), (16, 3, 1.0, 7.0)])
def test_bispectrum_tables_bit_identical(cfg):
    want = [np.asarray(a) for a in JB.get_bispectrum_tables(*cfg)]
    got = TB.bispectrum_tables_host(*cfg)
    # den and mmean are float64 on the host and float32 on the device
    for g, w in zip(got, want):
        g = g.astype(w.dtype)
        npt.assert_array_equal(g, w)
    for g, w in zip(TB.get_bispectrum_tables(*cfg), tables_from_numpy(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("n,nbins,m_min,m_max", [(32, 4, 1.0, None),
                                                 (64, 3, 2.0, 8.0)])
def test_bispectrum_3d_matches_jax(rng, n, nbins, m_min, m_max):
    """Finite B within rtol 1e-4; the NaN pattern (open triangles) is
    identical. (64, m_max=8) runs the band-limited n_c = 32 path."""
    centers = rng.uniform(0, 100.0, (40, 3))
    pts = centers[:, None, :] + rng.normal(0, 3.0, (40, 300, 3))
    pos = np.mod(pts.reshape(-1, 3), 100.0).astype(np.float32)
    grid = np.asarray(JP.paint(jnp.asarray(pos), n, 100.0, window="cic"))
    want = JB.bispectrum_3d(jnp.asarray(grid), 100.0, nbins=nbins,
                            m_min=m_min, m_max=m_max)
    got = TB.bispectrum_3d(T(grid), 100.0, nbins=nbins, m_min=m_min,
                           m_max=m_max)
    wb, gb = np.asarray(want.b), got.b.numpy()
    npt.assert_array_equal(np.isnan(gb), np.isnan(wb))
    assert np.isfinite(wb).sum() >= 3
    ok = np.isfinite(wb)
    npt.assert_allclose(gb[ok], wb[ok], rtol=1e-4)
    for f in ("k1", "k2", "k3", "ntri"):
        npt.assert_allclose(getattr(got, f).numpy(),
                            np.asarray(getattr(want, f)), rtol=1e-6)


# ------------------------------------------------------------ lensing
def test_constants_match_jax():
    from astrild_tpu.utils import constants as JC
    from astrild_tpu_torch.utils import constants as TC

    assert TC.C_LIGHT_KMS == JC.C_LIGHT_KMS
    assert TC.H0_HUNITS == JC.H0_HUNITS
    assert TC.H0_OVER_C_HMPC == JC.H0_OVER_C_HMPC


def test_born_convergence_matches_jax(rng):
    """Sequential per-plane sum in the same order: rtol 1e-5 (atol
    1e-6 * max for pixels where the planes cancel)."""
    planes = rng.normal(size=(16, 32, 32)).astype(np.float32)
    chis = np.linspace(200.0, 2800.0, 16).astype(np.float32)
    dchis = np.full(16, 31.25, np.float32)
    a = np.linspace(0.5, 1.0, 16).astype(np.float32)
    want = np.asarray(JL.born_convergence(
        jnp.asarray(planes), jnp.asarray(chis), jnp.asarray(dchis), 3000.0,
        0.3089, scale_factors=jnp.asarray(a)))
    got = TL.born_convergence(T(planes), T(chis), T(dchis), 3000.0, 0.3089,
                              scale_factors=T(a)).numpy()
    npt.assert_allclose(got, want, rtol=1e-5,
                        atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("npix,pad", [(64, 2), (50, 2), (32, 4)])
def test_kappa_to_gamma_matches_jax(rng, npix, pad):
    """FFT rounding differs between the packages: atol 1e-5 * max."""
    kappa = _smooth_map(rng, npix, scale=2) * 0.01
    w1, w2 = JL.kappa_to_gamma(jnp.asarray(kappa), 0.35, padding_factor=pad)
    g1, g2 = TL.kappa_to_gamma(T(kappa), 0.35, padding_factor=pad)
    for got, want in ((g1, w1), (g2, w2)):
        want = np.asarray(want)
        npt.assert_allclose(got.numpy(), want,
                            atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("npix,pad", [(64, 4), (50, 2)])
def test_kappa_to_alpha_matches_jax(rng, npix, pad):
    """Same Nyquist-plane rule as kappa_to_gamma: atol 1e-5 * max."""
    kappa = _smooth_map(rng, npix, scale=2) * 0.01
    w1, w2 = JL.kappa_to_alpha(jnp.asarray(kappa), 0.35, padding_factor=pad)
    a1, a2 = TL.kappa_to_alpha(T(kappa), 0.35, padding_factor=pad)
    for got, want in ((a1, w1), (a2, w2)):
        want = np.asarray(want)
        npt.assert_allclose(got.numpy(), want,
                            atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,npix", [(16, 128), (64, 256), (32, 32)])
def test_bilinear_resize_matches_jax_image_resize(rng, n, npix):
    """The lensing stage's jax.image.resize(..., "linear") upsample is
    F.interpolate(mode="bilinear", align_corners=False): atol 1e-6 for an
    O(1) map."""
    img = rng.normal(size=(n, n)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (npix, npix),
                                       method="linear"))
    got = F.interpolate(T(img)[None, None], size=(npix, npix),
                        mode="bilinear", align_corners=False)[0, 0]
    npt.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# -------------------------------------------------------------- peaks
@pytest.mark.parametrize("n", [256, 512])
def test_find_peaks_matches_jax(rng, n):
    """Positions, values and count exact; n=256 takes the plain top-k,
    n=512 the 2x2-pooled candidate path."""
    img = _smooth_map(rng, n, scale=1.5)
    thr = float(np.std(img))
    want = JK.find_peaks(jnp.asarray(img), threshold=thr, max_peaks=2048,
                         edge_pix=8)
    got = TK.find_peaks(T(img), threshold=thr, max_peaks=2048, edge_pix=8)
    assert int(got.n) == int(want.n) > 100
    npt.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    npt.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    fin = np.isfinite(np.asarray(want.snr))
    npt.assert_allclose(got.snr.numpy()[fin], np.asarray(want.snr)[fin],
                        rtol=1e-6)


def test_find_peaks_snr_uses_population_std(rng):
    # jnp.std has ddof=0; torch.std defaults to correction=1
    img = _smooth_map(rng, 64)
    cat = TK.find_peaks(T(img), max_peaks=16)
    npt.assert_allclose(cat.snr.numpy(), cat.values.numpy()
                        / np.std(img.astype(np.float64)), rtol=1e-6)


@pytest.mark.parametrize("n", [16, 512])
def test_candidate_topk_ties_match_jax(rng, n):
    """Exactly tied candidates keep the lower index first, as lax.top_k
    does (torch.topk promises no order among ties)."""
    score = np.full((n, n), -np.inf, np.float32)
    # isolated candidates (no two adjacent) with only three distinct values
    rows, cols = np.meshgrid(np.arange(1, n, 3), np.arange(1, n, 3),
                             indexing="ij")
    score[rows, cols] = rng.integers(0, 3, rows.shape).astype(np.float32)
    k = min(64, rows.size)
    wv, wi = JK.candidate_topk(jnp.asarray(score), k)
    gv, gi = TK.candidate_topk(T(score), k)
    npt.assert_array_equal(gv.numpy(), np.asarray(wv))
    npt.assert_array_equal(gi.numpy(), np.asarray(wi))


# -------------------------------------------------------------- voids
def _peak_catalog(rng, npix, n_valid, n_total):
    pos = rng.integers(0, npix, (n_total, 2)).astype(np.float32)
    valid = np.arange(n_total) < n_valid
    return pos, valid


def test_distance_transform_matches_jax(rng):
    """Integer pixel coordinates: both forms are exact in float32."""
    pos, valid = _peak_catalog(rng, 96, 40, 64)
    want = np.asarray(JV.distance_transform(jnp.asarray(pos),
                                            jnp.asarray(valid), 96))
    got = TV.distance_transform(T(pos), T(valid), 96, block=1000).numpy()
    npt.assert_array_equal(got, want)


def test_circle_overlap_fraction_matches_jax(rng):
    c1 = rng.uniform(0, 20, (500, 2)).astype(np.float32)
    c2 = rng.uniform(0, 20, (500, 2)).astype(np.float32)
    r1 = rng.uniform(0.5, 8, 500).astype(np.float32)
    r2 = rng.uniform(0.5, 8, 500).astype(np.float32)
    c2[:20] = c1[:20]  # concentric: containment branch
    want = np.asarray(JV.circle_overlap_fraction(
        jnp.asarray(c1), jnp.asarray(r1), jnp.asarray(c2), jnp.asarray(r2)))
    got = TV.circle_overlap_fraction(T(c1), T(r1), T(c2), T(r2)).numpy()
    npt.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["random", "lattice"])
def test_find_tunnels_matches_jax(rng, kind):
    """Equal void count, radii within rtol 1e-5, identical centres. The
    lattice has many exactly equal radii, so it pins the stable ordering
    (jnp.argsort is stable, torch.argsort is not by default)."""
    npix = 128
    if kind == "random":
        pos, valid = _peak_catalog(rng, npix, 60, 80)
    else:
        g = np.arange(4, npix, 20, dtype=np.float32)
        pos = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
        valid = np.ones(pos.shape[0], bool)
    want = JV.find_tunnels(jnp.asarray(pos), jnp.asarray(valid), npix,
                           max_voids=64)
    got = TV.find_tunnels(T(pos), T(valid), npix, max_voids=64)
    assert int(got.n) == int(want.n) > 5
    assert int(got.n_candidates) == int(want.n_candidates)
    npt.assert_allclose(got.radius.numpy(), np.asarray(want.radius),
                        rtol=1e-5)
    npt.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
