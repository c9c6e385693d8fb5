"""PyTorch port vs JAX package on the CPU: HEALPix pixelization (the numpy
copy and the tensor `ang2pix_ring`, `pix2ang_ring`, the bilinear stencil
and the deflection remap of utils/healpix_torch.py, mirroring
tests/test_healpix_jax.py) and the full-sky shell lane
(`shell_counts_healpix`, `density_shells_healpix`,
`born_convergence_healpix`, `multiplane_raytrace_healpix`).

Inputs are made with numpy from a seed and handed to both packages; the
JAX shells run with `deposit="scatter"`. The float32 `ang2pix_ring` of
either package puts a point within ~1e-6 of a pixel boundary into either
neighbour, and torch's and XLA's `cos`, `acos` and `atan2` differ by an
ulp, so pixel parity is a share of equal pixels and count parity a bound
on the particles that moved. Each tolerance is stated where it is checked.
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from astrild_tpu.ops import lightcone_sphere as JLS  # noqa: E402
from astrild_tpu.utils import healpix as jhpx  # noqa: E402
from astrild_tpu.utils import healpix_jax as jhpj  # noqa: E402
from astrild_tpu_torch.ops import lightcone_sphere as TLS  # noqa: E402
from astrild_tpu_torch.ops import lens_planes as TLP  # noqa: E402
from astrild_tpu_torch.utils import healpix as thpx  # noqa: E402
from astrild_tpu_torch.utils import healpix_torch as thpt  # noqa: E402

BOX = 400.0


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


def _random_angles(rng, n):
    theta = np.arccos(rng.uniform(-1, 1, n))
    phi = rng.uniform(0, 2 * np.pi, n)
    return theta, phi


# ------------------------------------------------------------ numpy copy
@pytest.mark.parametrize("nside", [1, 2, 4, 64])
def test_numpy_copy_is_bit_identical(rng, nside):
    """The port's numpy HEALPix copy equals the original bit for bit: on
    every pixel (pix2ang, and ang2pix of the centres) and on random
    angles, the poles and phi = 0 and 2 pi among them."""
    npix = thpx.nside2npix(nside)
    assert npix == jhpx.nside2npix(nside)
    assert thpx.npix2nside(npix) == jhpx.npix2nside(npix) == nside
    ipix = np.arange(npix)
    t_t, p_t = thpx.pix2ang_ring(nside, ipix)
    t_j, p_j = jhpx.pix2ang_ring(nside, ipix)
    npt.assert_array_equal(t_t.view(np.int64), t_j.view(np.int64))
    npt.assert_array_equal(p_t.view(np.int64), p_j.view(np.int64))
    npt.assert_array_equal(thpx.ang2pix_ring(nside, t_t, p_t), ipix)
    theta, phi = _random_angles(rng, 50000)
    theta[:4] = [0.0, np.pi, 0.5 * np.pi, 1e-9]
    phi[:4] = [0.0, 2 * np.pi, -1e-12, 7.0]
    npt.assert_array_equal(thpx.ang2pix_ring(nside, theta, phi),
                           jhpx.ang2pix_ring(nside, theta, phi))
    # broadcasting of a scalar against an array, as the original allows
    npt.assert_array_equal(thpx.ang2pix_ring(nside, 1.0, phi[:100]),
                           jhpx.ang2pix_ring(nside, 1.0, phi[:100]))


def test_npix2nside_rejects_bad_counts():
    with pytest.raises(ValueError, match="bad npix"):
        thpx.npix2nside(13)


# ------------------------------------------------------- tensor ang2pix
@pytest.mark.parametrize("nside", [4, 64, 512])
def test_ang2pix_torch_parity(rng, nside):
    """2e5 random points: >= 99.9% of the pixels equal the JAX function's
    and the float64 host routine's; a differing pixel is a neighbour."""
    theta, phi = _random_angles(rng, 200000)
    t32, p32 = theta.astype(np.float32), phi.astype(np.float32)
    got = thpt.ang2pix_ring(nside, torch.from_numpy(t32),
                            torch.from_numpy(p32))
    assert got.dtype == torch.int32
    got = got.numpy()
    jax_pix = np.asarray(jhpj.ang2pix_ring(nside, t32, p32))
    host = thpx.ang2pix_ring(nside, theta, phi)
    assert np.mean(got == jax_pix) >= 0.999
    assert np.mean(got == host) >= 0.999
    assert got.min() >= 0 and got.max() < thpx.nside2npix(nside)
    bad = got != host
    if np.any(bad):
        t1, p1 = thpx.pix2ang_ring(nside, host[bad])
        t2, p2 = thpx.pix2ang_ring(nside, got[bad].astype(np.int64))
        dphi = np.abs(np.mod(p1 - p2 + np.pi, 2 * np.pi) - np.pi)
        dist = np.hypot(t1 - t2, dphi * np.sin(0.5 * (t1 + t2)))
        assert np.max(dist) < 3 * np.sqrt(4 * np.pi / thpx.nside2npix(nside))


@pytest.mark.parametrize("nside", [1, 32])
def test_ang2pix_torch_pixel_centers_exact(nside):
    ipix = np.arange(thpx.nside2npix(nside))
    theta, phi = thpx.pix2ang_ring(nside, ipix)
    got = thpt.ang2pix_ring(nside, torch.from_numpy(theta.astype(np.float32)),
                            torch.from_numpy(phi.astype(np.float32)))
    npt.assert_array_equal(got.numpy(), ipix)


def test_ang2pix_torch_poles_and_phi_wrap():
    """theta = 0 and pi, phi = 0, 2 pi and negative: the JAX function's
    pixels, all in range."""
    nside = 16
    theta = np.array([0.0, 0.0, np.pi, np.pi, 1.0, 1.0, 1.0, 2.5],
                     np.float32)
    phi = np.array([0.0, 2 * np.pi, 0.0, 6.0, 0.0, 2 * np.pi, -0.5, -7.0],
                   np.float32)
    got = thpt.ang2pix_ring(nside, torch.from_numpy(theta),
                            torch.from_numpy(phi)).numpy()
    want = np.asarray(jhpj.ang2pix_ring(nside, theta, phi))
    npt.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < thpx.nside2npix(nside)
    with pytest.raises(ValueError, match="nside"):
        thpt.ang2pix_ring(8192, torch.zeros(1), torch.zeros(1))


# ------------------------------------------------ pix2ang and the stencil
@pytest.mark.parametrize("nside", [4, 16, 64])
def test_pix2ang_torch_parity(nside):
    """Every pixel: phi bit for bit the JAX function's, theta within 4 ulp
    of it (XLA's and torch's atan2 differ by an ulp or so), both within the
    JAX test's tolerance of the float64 host routine."""
    ipix = np.arange(thpx.nside2npix(nside))
    th, ph = thpt.pix2ang_ring(nside, torch.from_numpy(ipix))
    assert th.dtype == ph.dtype == torch.float32
    jt, jp = (np.asarray(a) for a in jhpj.pix2ang_ring(nside, ipix))
    npt.assert_array_equal(ph.numpy(), jp)
    npt.assert_array_max_ulp(th.numpy(), jt, maxulp=4)
    th_h, ph_h = thpx.pix2ang_ring(nside, ipix)
    npt.assert_allclose(th.numpy(), th_h, atol=3e-6)
    npt.assert_allclose(ph.numpy(), ph_h, atol=2e-5)


def test_pix2ang_closed_form_boundaries_large_nside():
    """nside 2048 (pixel indices far beyond float32's 2^24): every cap and
    belt boundary pixel and strided samples land on the host angle to well
    under a pixel, and on the JAX function's phi bit for bit."""
    nside = 2048
    npix = thpx.nside2npix(nside)
    ncap = 2 * nside * (nside - 1)
    idx = np.concatenate([
        np.arange(0, ncap, 997), np.arange(ncap, npix - ncap, 99733),
        np.arange(npix - ncap, npix, 997),
        np.array([0, ncap - 1, ncap, npix - ncap - 1, npix - ncap,
                  npix - 1])])
    th_h, ph_h = thpx.pix2ang_ring(nside, idx)
    th, ph = (a.numpy() for a in thpt.pix2ang_ring(
        nside, torch.from_numpy(idx.astype(np.int32))))
    assert np.abs(th - th_h).max() < 0.3 * np.pi / (4 * nside)
    assert np.abs(ph - ph_h).max() < 1e-5
    jt, jp = (np.asarray(a) for a in jhpj.pix2ang_ring(
        nside, idx.astype(np.int32)))
    npt.assert_array_equal(ph, jp)
    npt.assert_array_max_ulp(th, jt, maxulp=4)


@pytest.mark.parametrize("nside", [4, 64, 1024])
def test_interp_weights_parity(rng, nside):
    """2e4 random points: >= 99.9% of the stencils equal the JAX
    function's (a float32 ring or phi boundary moves weight between
    neighbours), sums one; the weights within 2e-4, or 1.3e-6 nside above
    nside 154 (the theta blend divides an ulp of theta, 2.4e-7, by the
    ring spacing ~pi / (4 nside)); against the float64 host stencil, at
    the JAX test's sizes, its share and tolerance."""
    theta, phi = _random_angles(rng, 20000)
    t32, p32 = theta.astype(np.float32), phi.astype(np.float32)
    pix, wgt = thpt.get_interp_weights(nside, torch.from_numpy(t32),
                                       torch.from_numpy(p32))
    assert pix.dtype == torch.int32 and wgt.dtype == torch.float32
    pix, wgt = pix.numpy(), wgt.numpy()
    npt.assert_allclose(wgt.sum(0), 1.0, atol=1e-5)
    jpix, jwgt = (np.asarray(a) for a in jhpj.get_interp_weights(
        nside, t32, p32))
    same = np.all(pix == jpix, axis=0)
    assert np.mean(same) >= 0.999
    wtol = max(2e-4, 1.3e-6 * nside)
    npt.assert_allclose(wgt[:, same], jwgt[:, same], atol=wtol)
    if nside <= 64:
        hpix, hwgt = thpx.get_interp_weights(nside, theta, phi)
        hsame = np.all(pix == hpix, axis=0)
        assert np.mean(hsame) > 0.99
        npt.assert_allclose(wgt[:, hsame], hwgt[:, hsame], atol=2e-4)


def test_interp_val_smooth_field(rng):
    """A smooth field: the host interpolation, the JAX function's and the
    analytic field itself (bilinear truncation)."""
    nside = 64
    tc, pc = thpx.pix2ang_ring(nside, np.arange(thpx.nside2npix(nside)))
    fmap = (np.cos(tc) ** 2 + 0.3 * np.sin(tc) * np.cos(pc)
            ).astype(np.float32)
    theta, phi = _random_angles(rng, 4000)
    t32, p32 = theta.astype(np.float32), phi.astype(np.float32)
    got = thpt.get_interp_val(torch.from_numpy(fmap), torch.from_numpy(t32),
                              torch.from_numpy(p32)).numpy()
    host = thpx.get_interp_val(fmap.astype(np.float64), theta, phi)
    npt.assert_allclose(got, host, atol=5e-5)
    npt.assert_allclose(got, np.asarray(jhpj.get_interp_val(fmap, t32, p32)),
                        atol=2e-6)
    exact = np.cos(theta) ** 2 + 0.3 * np.sin(theta) * np.cos(phi)
    assert np.max(np.abs(got - exact)) < 2e-3


def test_interp_poles(rng):
    """The polar fallbacks: points above ring 1 and below the last ring,
    against the host routine and the JAX function."""
    nside, n = 16, 200
    theta = np.concatenate([rng.uniform(0, 1e-3, n),
                            np.pi - rng.uniform(0, 1e-3, n)])
    phi = rng.uniform(0, 2 * np.pi, 2 * n)
    fmap = rng.standard_normal(thpx.nside2npix(nside)).astype(np.float32)
    t32, p32 = theta.astype(np.float32), phi.astype(np.float32)
    got = thpt.get_interp_val(torch.from_numpy(fmap), torch.from_numpy(t32),
                              torch.from_numpy(p32)).numpy()
    host = thpx.get_interp_val(fmap.astype(np.float64), theta, phi)
    npt.assert_allclose(got, host, atol=1e-4)
    npt.assert_allclose(got, np.asarray(jhpj.get_interp_val(fmap, t32, p32)),
                        atol=1e-5)


@pytest.mark.parametrize("nside", [16, 64])
def test_remap_by_deflection_matches_jax_and_host_chain(rng, nside):
    """The remap with its 1e-3-pixel tie nudge: >= 99.9% of its samples
    within 2e-3 of the map's max of the JAX function's (an ulp of a
    position moves a weight by up to ~1e-4; a float32 stencil decision
    flips a neighbour, an O(1) change, at the rest); the same nudge on the
    host pixel centres and the tensor interpolation within the JAX test's
    quantile; a zero deflection samples the map at its own centres within
    1e-5 of the JAX function."""
    npix = thpx.nside2npix(nside)
    hpmap = rng.normal(size=npix).astype(np.float32)
    a_t = (rng.normal(size=npix) * 0.01).astype(np.float32)
    a_p = (rng.normal(size=npix) * 0.01).astype(np.float32)
    got = thpt.remap_by_deflection(*(torch.from_numpy(a) for a in
                                     (hpmap, a_t, a_p)), nside).numpy()
    want = np.asarray(jhpj.remap_by_deflection(hpmap, a_t, a_p, nside))
    assert np.mean(np.abs(got - want) < 2e-3 * np.abs(hpmap).max()) >= 0.999
    theta, phi = thpx.pix2ang_ring(nside, np.arange(npix))
    nudge = 1.0e-3 * (2.0 * np.pi / (4.0 * nside))
    ts = np.clip(theta + a_t + 0.5 * nudge, 0.0, np.pi)
    ps = phi + a_p / np.maximum(np.sin(theta), 1e-6) + nudge
    chain = thpt.get_interp_val(torch.from_numpy(hpmap),
                                torch.from_numpy(ts.astype(np.float32)),
                                torch.from_numpy(ps.astype(np.float32)))
    assert np.quantile(np.abs(got - chain.numpy()), 0.999) < 1e-4
    zero = torch.zeros(npix)
    still = thpt.remap_by_deflection(torch.from_numpy(hpmap), zero, zero,
                                     nside).numpy()
    npt.assert_allclose(still, np.asarray(jhpj.remap_by_deflection(
        hpmap, np.zeros(npix, np.float32), np.zeros(npix, np.float32),
        nside)), atol=1e-5)


def test_stencil_raises_and_numpy_input_placement(rng):
    """Numpy input goes to `device` (the CUDA card by default, raising
    without one); tensors keep their device."""
    nside = 8
    npix = thpx.nside2npix(nside)
    theta, phi = (a.astype(np.float32) for a in _random_angles(rng, 50))
    m = rng.standard_normal(npix).astype(np.float32)
    z = np.zeros(npix, np.float32)
    calls = (lambda **k: thpt.ang2pix_ring(nside, theta, phi, **k),
             lambda **k: thpt.pix2ang_ring(nside, np.arange(npix), **k),
             lambda **k: thpt.get_interp_weights(nside, theta, phi, **k),
             lambda **k: thpt.get_interp_val(m, theta, phi, **k),
             lambda **k: thpt.remap_by_deflection(m, z, z, nside, **k))
    for call in calls:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        out = call(device="cpu")
        for t in (out if isinstance(out, tuple) else (out,)):
            assert t.device.type == "cpu"
    for fn in (thpt.pix2ang_ring, thpt.get_interp_weights):
        with pytest.raises(ValueError, match="nside"):
            fn(8192, torch.zeros(1), torch.zeros(1)) \
                if fn is thpt.get_interp_weights else \
                fn(8192, torch.zeros(1, dtype=torch.int32))


# ------------------------------------------------------------ shell counts
def _moved(got, want):
    """Upper bound on the particles painted elsewhere: half the summed
    absolute difference of the counts (a moved particle changes two
    cells by one)."""
    return 0.5 * np.abs(got - want).sum()


@pytest.mark.parametrize("replicate", [False, True])
@pytest.mark.parametrize("layout", ["array", "flat"])
def test_shell_counts_match_jax(rng, replicate, layout):
    """Counts against JAX's scatter path: totals equal to the integer, at
    most 0.1% of the painted particles in another pixel."""
    n = 100_000
    pos = rng.uniform(0, BOX, (n, 3)).astype(np.float32)
    edges = (np.array([150.0, 300.0, 450.0]) if replicate
             else np.array([40.0, 80.0, 120.0, 160.0]))
    nside = 8
    if layout == "array":
        jpos, tpos = pos, torch.from_numpy(pos)
    else:
        cols = [np.ascontiguousarray(pos[:, i]) for i in range(3)]
        jpos, tpos = tuple(cols), tuple(torch.from_numpy(c) for c in cols)
    want = np.asarray(JLS.shell_counts_healpix(
        jpos, edges, nside, BOX, replicate=replicate, deposit="scatter"))
    got = TLS.shell_counts_healpix(tpos, edges, nside, BOX,
                                   replicate=replicate).numpy()
    assert got.shape == want.shape == (len(edges) - 1, 12 * nside ** 2)
    assert got.sum() == want.sum() > 1000
    assert _moved(got, want) <= 1e-3 * want.sum()
    if not replicate:
        chi = np.linalg.norm(pos - BOX / 2, axis=1)
        assert got.sum() == np.sum((chi >= edges[0]) & (chi < edges[-1]))


def test_shell_counts_weighted_match_jax(rng):
    """Weighted paint, off-centre observer: totals to rtol 1e-5 (float32
    sums in another order), moved weight at most 0.1% of the total."""
    n = 50_000
    pos = rng.uniform(0, BOX, (n, 3)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    edges = np.array([50.0, 150.0, 260.0])
    obs = (120.0, 230.0, 310.0)
    want = np.asarray(JLS.shell_counts_healpix(
        pos, edges, 4, BOX, observer=obs, weights=w, deposit="scatter"))
    got = TLS.shell_counts_healpix(torch.from_numpy(pos), edges, 4, BOX,
                                   observer=obs,
                                   weights=torch.from_numpy(w)).numpy()
    npt.assert_allclose(got.sum(), want.sum(), rtol=1e-5)
    assert _moved(got, want) <= 1e-3 * want.sum()
    # numpy positions and weights run where they are told to
    again = TLS.shell_counts_healpix(pos, edges, 4, BOX, observer=obs,
                                     weights=w, device="cpu").numpy()
    npt.assert_array_equal(again, got)


@pytest.mark.parametrize("deposit", ["scatter", None])
def test_shell_counts_deposit_spellings_on_cpu(rng, deposit):
    """On a CPU tensor None means the scatter; the kernel spellings of
    either package raise, and the interpret spelling says why."""
    pos = torch.from_numpy(rng.uniform(0, BOX, (2000, 3)).astype(np.float32))
    edges = np.array([40.0, 160.0])
    ref = TLS.shell_counts_healpix(pos, edges, 4, BOX, replicate=False)
    got = TLS.shell_counts_healpix(pos, edges, 4, BOX, replicate=False,
                                   deposit=deposit)
    npt.assert_array_equal(got.numpy(), ref.numpy())
    for name in ("kernel", "pallas"):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            TLS.shell_counts_healpix(pos, edges, 4, BOX, deposit=name)
    with pytest.raises(ValueError, match="no interpret mode"):
        TLS.shell_counts_healpix(pos, edges, 4, BOX,
                                 deposit="pallas_interpret")
    with pytest.raises(ValueError, match="deposit must be"):
        TLS.shell_counts_healpix(pos, edges, 4, BOX, deposit="sorted")


def test_shell_counts_grouped_flushes_add_up(rng, monkeypatch):
    """A budget that holds one box image's keys but not two flushes image
    by image and gives the same counts; one that holds none raises with
    both sizes."""
    pos = torch.from_numpy(rng.uniform(0, BOX, (20000, 3)).astype(np.float32))
    edges = np.array([150.0, 300.0, 450.0])
    want = TLS.shell_counts_healpix(pos, edges, 4, BOX)
    monkeypatch.setattr(TLS, "_entry_budget", lambda dev, n: 20000)
    got = TLS.shell_counts_healpix(pos, edges, 4, BOX)
    npt.assert_array_equal(got.numpy(), want.numpy())
    monkeypatch.setattr(TLS, "_entry_budget", lambda dev, n: 10)
    with pytest.raises(RuntimeError, match="room for 10"):
        TLS.shell_counts_healpix(pos, edges, 4, BOX)
    assert TLP._entry_budget(torch.device("cpu"), 100) is None


def test_chi_edges_validation():
    pos = torch.zeros((10, 3))
    for bad in ([100.0], [100.0, 50.0], [[1.0, 2.0]], [10.0, 10.0]):
        with pytest.raises(ValueError, match="chi_edges"):
            TLS.shell_counts_healpix(pos, bad, 4, BOX)
    with pytest.raises(ValueError, match="2\\^31"):
        TLS.shell_counts_healpix(pos, np.linspace(1.0, 50.0, 12), 4096, BOX)


@pytest.mark.parametrize("weighted", [False, True])
def test_density_shells_match_jax(rng, weighted):
    """`density_shells_healpix`: distances equal; delta within the moved
    particles' share plus float32 rounding; a uniform box fills the sphere
    (mean delta within 0.05)."""
    n = 100_000
    pos = rng.uniform(0, BOX, (n, 3)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32) if weighted else None
    edges = np.array([250.0, 350.0, 450.0])
    nside = 4
    jd, jchis, jdchis = JLS.density_shells_healpix(pos, edges, nside, BOX,
                                                   weights=w)
    td, tchis, tdchis = TLS.density_shells_healpix(
        torch.from_numpy(pos), edges, nside, BOX,
        weights=None if w is None else torch.from_numpy(w))
    npt.assert_array_equal(tchis.numpy(), np.asarray(jchis))
    npt.assert_array_equal(tdchis.numpy(), np.asarray(jdchis))
    jd, td = np.asarray(jd), td.numpy()
    assert np.all(np.abs(td.mean(axis=1)) < 0.05)
    # delta = counts / expected - 1 and the shells hold ~expected * size
    # counts: 0.1% of them moved (two pixels each, weights up to 2) change
    # sum |delta| by at most 4e-3 * size
    assert np.abs(td - jd).sum() <= 4e-3 * td.size + 1e-5 * np.abs(jd).sum()


def test_shell_overdensity_matches_jax(rng):
    counts = rng.poisson(50.0, (3, 192)).astype(np.float32)
    edges = np.array([100.0, 200.0, 300.0, 400.0])
    for tw in (None, 12345.6):
        want = np.asarray(JLS.shell_overdensity(jnp.asarray(counts), edges,
                                                1e5, BOX, total_weight=tw))
        got = TLS.shell_overdensity(torch.from_numpy(counts), edges, 1e5,
                                    BOX, total_weight=tw)
        npt.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("chi_s", [700.0, [700.0, 320.0, 1500.0]])
@pytest.mark.parametrize("with_a", [False, True])
def test_born_convergence_healpix_matches_jax(rng, chi_s, with_a):
    """Scalar and array sources, one inside the shells: rtol 1e-5 of the
    map's max."""
    nshell, npix = 5, 12 * 8 ** 2
    delta = rng.standard_normal((nshell, npix)).astype(np.float32)
    chis = np.linspace(200.0, 600.0, nshell).astype(np.float32)
    dchis = np.full(nshell, 100.0, np.float32)
    a = ((1.0 / (1.0 + np.linspace(0.05, 0.2, nshell))).astype(np.float32)
         if with_a else None)
    want = np.asarray(JLS.born_convergence_healpix(
        jnp.asarray(delta), chis, dchis, jnp.asarray(chi_s, jnp.float32),
        0.3, scale_factors=None if a is None else jnp.asarray(a)))
    got = TLS.born_convergence_healpix(
        torch.from_numpy(delta), chis, dchis, chi_s, 0.3,
        scale_factors=a).numpy()
    assert got.shape == want.shape
    npt.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_multiplane_raytrace_healpix_is_not_ported():
    """The spherical ray trace is ported: two shells at nside 8 on the
    table path against the JAX function, each map within 1e-3 of its max
    (tests/test_torch_lightcone_sphere.py holds it fully)."""
    nside = 8
    delta = rng_delta = np.random.default_rng(3).normal(
        0.0, 0.3, (2, thpx.nside2npix(nside))).astype(np.float32)
    chis = np.array([300.0, 600.0], np.float32)
    dchis = np.full(2, 150.0, np.float32)
    got = TLS.multiplane_raytrace_healpix(torch.from_numpy(rng_delta), chis,
                                          dchis, 800.0, 0.3, lmax=16)
    want = JLS.multiplane_raytrace_healpix(delta, chis, dchis, 800.0, 0.3,
                                           lmax=16)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        npt.assert_allclose(got[k].numpy(), w, atol=1e-3 * np.abs(w).max())
