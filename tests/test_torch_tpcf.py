"""PyTorch port vs JAX package on the CPU: the catalog estimators and the
theory they are checked against. Geometry, the correlation functions
(xi(s, mu), xi(r), multipoles, wp(rp)), the pairwise-velocity PDF, the kSZ
momentum estimator, `mean_pv_from_tv`, FFTLog, the BAO fits, the mocks and
the no-wiggle / Kaiser spectra.

Inputs are made with numpy from a seed and handed to both packages; each
tolerance is stated where it is checked. Pair counts are whole numbers
and are held equal.
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from astrild_tpu.ops import bao as JBAO  # noqa: E402
from astrild_tpu.ops import fftlog as JF  # noqa: E402
from astrild_tpu.ops import linear_power as JL  # noqa: E402
from astrild_tpu.ops import mocks as JM  # noqa: E402
from astrild_tpu.ops import pairwise as JPW  # noqa: E402
from astrild_tpu.ops import tpcf as JT  # noqa: E402
from astrild_tpu.utils import geometry as JG  # noqa: E402
from astrild_tpu.utils.cosmology import Cosmology as JCosmology  # noqa: E402
from astrild_tpu_torch.ops import bao as TBAO  # noqa: E402
from astrild_tpu_torch.ops import fftlog as TF  # noqa: E402
from astrild_tpu_torch.ops import linear_power as TL  # noqa: E402
from astrild_tpu_torch.ops import mocks as TM  # noqa: E402
from astrild_tpu_torch.ops import pairwise as TPW  # noqa: E402
from astrild_tpu_torch.ops import pairwise_cuda as TPWC  # noqa: E402
from astrild_tpu_torch.ops import tpcf as TT  # noqa: E402
from astrild_tpu_torch.utils import geometry as TG  # noqa: E402
from astrild_tpu_torch.utils.cosmology import Cosmology  # noqa: E402

BOX = 200.0


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


def _clustered(rng, n, box=BOX, clumps=12, frac=0.6):
    """float32 positions: a share in Gaussian clumps, the rest uniform."""
    nc = int(n * frac)
    centers = rng.uniform(0, box, (clumps, 3))
    pos = np.concatenate([
        centers[rng.integers(0, clumps, nc)] + rng.normal(0, 4.0, (nc, 3)),
        rng.uniform(0, box, (n - nc, 3))])
    return (pos % box).astype(np.float32)


# ------------------------------------------------------------- geometry
def test_unit_conversions_match_jax():
    """Plain arithmetic on Python floats: equal."""
    for name, args in [("ell_to_arcmin", (3000.0,)),
                       ("arcmin_to_ell", (2.5,)),
                       ("arcmin_to_deg", (90.0,)),
                       ("deg_to_arcmin", (1.5,)),
                       ("rad_to_arcmin", (0.01,)),
                       ("arcmin_to_rad", (12.5,)),
                       ("Dc_to_Da", (100.0, 1.0))]:
        assert getattr(TG, name)(*args) == float(getattr(JG, name)(*args))
    assert (TG.radius_to_angsize(1.0, 100.0)
            == float(JG.radius_to_angsize(1.0, 100.0)))
    assert (TG.radius_to_angsize(1.0, 100.0, arcmin=False)
            == float(JG.radius_to_angsize(1.0, 100.0, arcmin=False)))


def test_jacobians_and_rotations_match_jax(rng):
    """Jacobians atol 1e-6 (float32 sin/cos of two libraries); the vector
    rotations both ways atol 1e-5 (|v| ~ 300) and a round trip to 1e-4."""
    th = rng.uniform(0.1, 3.0, 64).astype(np.float32)
    ph = rng.uniform(-3.0, 3.0, 64).astype(np.float32)
    v = rng.normal(0, 100, (64, 3)).astype(np.float32)
    for name in ("cart_to_sph_jacobian", "sph_to_cart_jacobian"):
        got = getattr(TG, name)(T(th), T(ph))
        want = np.asarray(getattr(JG, name)(jnp.asarray(th), jnp.asarray(ph)))
        assert got.shape == want.shape == (3, 3, 64)
        npt.assert_allclose(got.numpy(), want, atol=1e-6)
    j1 = TG.cart_to_sph_jacobian(0.7, 1.3, device="cpu").numpy()
    j2 = TG.sph_to_cart_jacobian(0.7, 1.3, device="cpu").numpy()
    npt.assert_allclose(j1 @ j2, np.eye(3), atol=1e-6)
    for name in ("convert_vec_cart_to_sph", "convert_vec_sph_to_cart"):
        got = getattr(TG, name)(T(th), T(ph), T(v))
        want = np.asarray(getattr(JG, name)(jnp.asarray(th), jnp.asarray(ph),
                                            jnp.asarray(v)))
        npt.assert_allclose(got.numpy(), want, atol=1e-5 * 300)
    back = TG.convert_vec_sph_to_cart(T(th), T(ph), TG.convert_vec_cart_to_sph(
        T(th), T(ph), T(v)))
    npt.assert_allclose(back.numpy(), v, atol=1e-4 * 300)


def test_lightcone_transforms_keep_the_namespace(rng):
    """numpy in, numpy out at the input dtype, equal to the JAX package's
    (the same numpy ops); a tensor in, a tensor out on its device, equal to
    the JAX package's float32 path to an ulp (rtol 1e-6)."""
    pos = rng.uniform(-300, 300, (100, 3))
    pos[:, 2] = np.abs(pos[:, 2]) + 50.0
    got = TG.transform_box_to_lc_cart_coords(pos, 500.0, 1000.0)
    want = JG.transform_box_to_lc_cart_coords(pos, 500.0, 1000.0)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    npt.assert_array_equal(got, want)
    npt.assert_array_equal(TG.radial_coordinate_in_lc(pos),
                           JG.radial_coordinate_in_lc(pos))
    for unit in ("deg", "rad"):
        for a, b in zip(TG.angular_coordinate_in_lc(pos, unit),
                        JG.angular_coordinate_in_lc(pos, unit)):
            npt.assert_array_equal(a, b)
        for a, b in zip(TG.ra_dec_dist_coordinates(pos, unit),
                        JG.ra_dec_dist_coordinates(pos, unit)):
            npt.assert_array_equal(a, b)
    p32 = pos.astype(np.float32)
    out = TG.transform_box_to_lc_cart_coords(T(p32), 500.0, 1000.0)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    npt.assert_allclose(out.numpy(), np.asarray(
        JG.transform_box_to_lc_cart_coords(jnp.asarray(p32), 500.0, 1000.0)),
        rtol=1e-6)
    for a, b in zip(TG.angular_coordinate_in_lc(T(p32), "rad"),
                    JG.angular_coordinate_in_lc(jnp.asarray(p32), "rad")):
        npt.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    for a, b in zip(TG.ra_dec_dist_coordinates(T(p32)),
                    JG.ra_dec_dist_coordinates(jnp.asarray(p32))):
        npt.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError):
        TG.ra_dec_dist_coordinates(pos, unit="furlong")


# ------------------------------------------------------------ tpcf
def test_to_redshift_space_matches_jax(rng):
    """s = x + v_z / 100, wrapped: the same float32 ops, equal."""
    pos = rng.uniform(0, BOX, (500, 3)).astype(np.float32)
    vel = rng.normal(0, 600, (500, 3)).astype(np.float32)
    got = TT.to_redshift_space(T(pos), T(vel), BOX)
    want = np.asarray(JT.to_redshift_space(jnp.asarray(pos),
                                           jnp.asarray(vel), BOX))
    npt.assert_array_equal(got.numpy(), want)
    assert float(got.min()) >= 0.0 and float(got.max()) <= BOX


@pytest.mark.parametrize("block,n", [(128, 700), (512, 1500)])
def test_pair_counts_match_jax(rng, block, n):
    """DD(s, mu) and DD(rp, pi): whole numbers, equal to the JAX
    package's with the same block (padding rows and the tile triangle
    included), for (n, 3) and component-tuple input."""
    pos = _clustered(rng, n)
    s_edges = np.linspace(0.0, 60.0, 13).astype(np.float32)
    got = TT.pair_counts_s_mu(T(pos), BOX, T(s_edges), 12, nmu=10,
                              block=block)
    want = np.asarray(JT.pair_counts_s_mu(jnp.asarray(pos), BOX,
                                          jnp.asarray(s_edges), 12, nmu=10,
                                          block=block))
    npt.assert_array_equal(got.numpy(), want)
    comps = tuple(T(pos[:, i].copy()) for i in range(3))
    npt.assert_array_equal(TT.pair_counts_s_mu(comps, BOX, T(s_edges), 12,
                                               nmu=10, block=block).numpy(),
                           want)
    rp_edges = np.linspace(2.0, 40.0, 9).astype(np.float32)
    got = TT.pair_counts_rp_pi(T(pos), BOX, T(rp_edges), 8, 16, 50.0,
                               block=block)
    want = np.asarray(JT.pair_counts_rp_pi(jnp.asarray(pos), BOX,
                                           jnp.asarray(rp_edges), 8, 16,
                                           50.0, block=block))
    npt.assert_array_equal(got.numpy(), want)
    # every pair below 60 Mpc/h once, as a direct count finds them
    d = pos[:, None, :] - pos[None, :, :]
    d -= BOX * np.round(d / BOX)
    r = np.sqrt((d.astype(np.float64) ** 2).sum(-1))[np.triu_indices(n, 1)]
    assert abs(float(TT.pair_counts_s_mu(T(pos), BOX, T(s_edges), 12,
                                         block=block).sum())
               - int((r < 60.0).sum())) <= 2


def test_pair_counts_n_valid_excludes_junk_rows(rng):
    """Rows past n_valid form no pairs: equal to the counts of the valid
    rows alone."""
    pos = _clustered(rng, 600)
    pos[500:] = 100.0  # junk rows, all in one point
    s_edges = T(np.linspace(0.0, 30.0, 7).astype(np.float32))
    got = TT.pair_counts_s_mu(T(pos), BOX, s_edges, 6, nmu=4, n_valid=500,
                              block=128)
    npt.assert_array_equal(got.numpy(), TT.pair_counts_s_mu(
        T(pos[:500]), BOX, s_edges, 6, nmu=4, block=128).numpy())


def test_tpcf_estimators_match_jax(rng):
    """xi(s, mu), xi(r), the even multipoles and wp(rp) with their RR:
    rtol 1e-5 (float32 ratios of equal counts), NaN where RR is 0."""
    pos = _clustered(rng, 1200)
    vel = rng.normal(0, 300, pos.shape).astype(np.float32)
    ps = TT.to_redshift_space(T(pos), T(vel), BOX)
    pj = JT.to_redshift_space(jnp.asarray(pos), jnp.asarray(vel), BOX)
    s_edges = np.linspace(0.0, 60.0, 13).astype(np.float32)
    s, mu, xi = TT.tpcf_s_mu(ps, BOX, T(s_edges), nmu=8, block=256)
    js, jmu, jxi = JT.tpcf_s_mu(pj, BOX, jnp.asarray(s_edges), nmu=8,
                                block=256)
    npt.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    npt.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-6)
    npt.assert_allclose(xi.numpy(), np.asarray(jxi), rtol=1e-5, atol=1e-6)
    for ell in (0, 2, 4):
        npt.assert_allclose(TT.tpcf_multipoles(xi, ell).numpy(),
                            np.asarray(JT.tpcf_multipoles(jxi, ell)),
                            rtol=1e-5, atol=1e-5)
    r, xr = TT.tpcf_real(T(pos), BOX, T(s_edges), block=256)
    jr, jxr = JT.tpcf_real(jnp.asarray(pos), BOX, jnp.asarray(s_edges),
                           block=256)
    npt.assert_allclose(xr.numpy(), np.asarray(jxr), rtol=1e-5, atol=1e-6)
    rp_edges = np.linspace(2.0, 40.0, 9).astype(np.float32)
    rp, wp, xi2 = TT.projected_tpcf(T(pos), BOX, T(rp_edges), 50.0,
                                    n_pi=10, block=256)
    jrp, jwp, jxi2 = JT.projected_tpcf(jnp.asarray(pos), BOX,
                                       jnp.asarray(rp_edges), 50.0, n_pi=10,
                                       block=256)
    npt.assert_allclose(rp.numpy(), np.asarray(jrp), rtol=1e-6)
    npt.assert_allclose(xi2.numpy(), np.asarray(jxi2), rtol=1e-5, atol=1e-6)
    npt.assert_allclose(wp.numpy(), np.asarray(jwp), rtol=1e-5, atol=1e-4)
    # clustered input: xi(r) positive at small r
    assert float(xr[1]) > 0.0


def test_tpcf_half_box_guards():
    """Both guards raise as the JAX package's do."""
    pos = np.zeros((10, 3), np.float32)
    with pytest.raises(ValueError, match="boxsize/2"):
        TT.tpcf_s_mu(T(pos), 100.0, T(np.linspace(0, 60, 4)))
    with pytest.raises(ValueError, match="boxsize/2"):
        JT.tpcf_s_mu(jnp.asarray(pos), 100.0, jnp.linspace(0, 60, 4))
    with pytest.raises(ValueError, match="boxsize/2"):
        TT.projected_tpcf(T(pos), 100.0, np.linspace(1, 40, 4), 40.0)
    with pytest.raises(ValueError, match="boxsize/2"):
        JT.projected_tpcf(jnp.asarray(pos), 100.0, np.linspace(1, 40, 4),
                          40.0)


# ------------------------------------------------------ pair estimators
@pytest.mark.parametrize("mode", ["radial", "z_sign"])
def test_pairwise_velocity_pdf_matches_jax(rng, mode):
    """Whole-number counts, equal to the JAX package's (block 256 over 600
    tracers: padding and the tile triangle)."""
    pos = _clustered(rng, 600, box=60.0)
    vel = rng.normal(0, 150, (600, 3)).astype(np.float32)
    got = TPW.pairwise_velocity_pdf(T(pos), T(vel), 30, 400, mode=mode,
                                    block=256)
    want = np.asarray(JPW.pairwise_velocity_pdf(
        jnp.asarray(pos), jnp.asarray(vel), 30, 400, mode=mode, block=256))
    assert got.shape == (30, 400)
    npt.assert_array_equal(got.numpy(), want)
    assert float(got.sum()) > 1000


def test_pairwise_velocity_pdf_rejects_just_below_the_first_bin():
    """v12 + offset in (-1, 0) is rejected (floor, not truncation), as in
    the JAX package: pairs at v12 = -offset - 0.5 and -offset + 0.5 (r = 1
    Mpc/h apart along x), only the second counts, in bin (1, 0)."""
    pos = np.array([[10, 10, 10], [11, 10, 10],
                    [30, 30, 30], [31, 30, 30]], np.float32)
    vel = np.zeros((4, 3), np.float32)
    vel[1, 0] = -50.5   # v12 = -50.5: offset 50 -> -0.5, rejected
    vel[3, 0] = -49.5   # v12 + 50 = 0.5 -> bin 0
    got = TPW.pairwise_velocity_pdf(T(pos), T(vel), 5, 100)
    want = np.asarray(JPW.pairwise_velocity_pdf(jnp.asarray(pos),
                                                jnp.asarray(vel), 5, 100))
    npt.assert_array_equal(got.numpy(), want)
    assert float(got.sum()) == 1.0 and float(got[1, 0]) == 1.0


def test_pairwise_ksz_momentum_matches_jax(rng):
    """p_hat in a lightcone frame: rtol 1e-4 where a bin holds >= 1000
    pairs (ratios of float32 sums over tiles, reduced in another order),
    NaN in the same empty bins; bin centres rtol 1e-6. Infall gives
    p_hat > 0."""
    pos = TG.transform_box_to_lc_cart_coords(_clustered(rng, 900), BOX,
                                             800.0)
    # dT = -v . rhat with infall toward the clump centres
    vel = rng.normal(0, 50, pos.shape).astype(np.float32)
    rhat = pos / np.linalg.norm(pos, axis=1, keepdims=True)
    dT = -(vel * rhat).sum(1).astype(np.float32)
    bins = np.linspace(0, 40, 21)
    r, p = TPW.pairwise_ksz_momentum(T(pos), T(dT), bins, block=256)
    jr, jp = JPW.pairwise_ksz_momentum(jnp.asarray(pos), jnp.asarray(dT),
                                       jnp.asarray(bins), block=256)
    npt.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6)
    jp = np.asarray(jp)
    npt.assert_array_equal(np.isnan(p.numpy()), np.isnan(jp))
    npt.assert_allclose(p.numpy(), jp, rtol=1e-4, atol=1e-4 * np.nanmax(
        np.abs(jp)))


def test_pairwise_ksz_infall_sign():
    """Two clumps falling toward each other across the line of sight:
    p_hat > 0 at their separation (Hand+12: infall -> positive)."""
    rng = np.random.default_rng(0)
    n = 256
    pos = np.zeros((2 * n, 3), np.float32)
    pos[:n] = rng.normal([0, 0, 980], 1.0, (n, 3))
    pos[n:] = rng.normal([0, 0, 1020], 1.0, (n, 3))
    vel = np.zeros((2 * n, 3), np.float32)
    vel[:n, 2] = 100.0
    vel[n:, 2] = -100.0
    rhat = pos / np.linalg.norm(pos, axis=1, keepdims=True)
    dT = -(vel * rhat).sum(1).astype(np.float32)
    rsep, p = TPW.pairwise_ksz_momentum(T(pos), T(dT), np.linspace(0, 50,
                                                                   25))
    i40 = int(np.argmin(np.abs(rsep.numpy() - 40.0)))
    assert float(p[i40]) > 50.0


@pytest.mark.parametrize("angles", ["derived", "radians", "degrees"])
def test_mean_pv_from_tv_matches_jax(rng, angles):
    """Angular velocities rotated to cartesian, then v12: rtol 1e-4 as
    mean_pairwise_velocity's parity (ratios of float32 sums); the plain
    tiles on the CPU (no K3 launch)."""
    pos = TG.transform_box_to_lc_cart_coords(_clustered(rng, 500), BOX,
                                             900.0).astype(np.float32)
    vel_ang = rng.normal(0, 200, (500, 2)).astype(np.float32)
    bins = np.linspace(0, 50, 25)
    kw = {}
    if angles != "derived":
        t1, t2 = JG.angular_coordinate_in_lc(pos, unit="rad")
        if angles == "degrees":
            t1, t2 = np.rad2deg(t1) + 360.0, np.rad2deg(t2) + 360.0
        kw = {"theta1": t1.astype(np.float32), "theta2": t2.astype(np.float32)}
    before = dict(TPWC.LAUNCHES)
    r, v = TPW.mean_pv_from_tv(T(pos), T(vel_ang), bins,
                               **{k: T(x) for k, x in kw.items()})
    assert dict(TPWC.LAUNCHES) == before
    jr, jv = JPW.mean_pv_from_tv(jnp.asarray(pos), jnp.asarray(vel_ang),
                                 jnp.asarray(bins),
                                 **{k: jnp.asarray(x) for k, x in kw.items()})
    npt.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6)
    npt.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("name", ["pdf", "ksz", "mean_pv_from_tv",
                                  "tpcf_real", "projected_tpcf",
                                  "to_redshift_space", "jacobian"])
def test_numpy_input_placement(rng, name):
    """Input that is not a tensor goes to the CUDA card unless `device` is
    given: with no card the call raises; with device='cpu' it runs on the
    CPU and gives what CPU tensors give (equal: the same ops)."""
    pos = _clustered(rng, 300)
    vel = rng.normal(0, 100, (300, 3)).astype(np.float32)
    bins = np.linspace(0, 50, 25)
    edges = np.linspace(0, 40, 5).astype(np.float32)
    calls = {
        "pdf": lambda p, v, **kw: TPW.pairwise_velocity_pdf(p, v, 10, 200,
                                                            **kw),
        "ksz": lambda p, v, **kw: TPW.pairwise_ksz_momentum(
            p, v[:, 0], bins, **kw)[1],
        "mean_pv_from_tv": lambda p, v, **kw: TPW.mean_pv_from_tv(
            p + np.float32(500.0), v[:, :2], bins, **kw)[1],
        "tpcf_real": lambda p, v, **kw: TT.tpcf_real(p, BOX, edges, **kw)[1],
        "projected_tpcf": lambda p, v, **kw: TT.projected_tpcf(
            p, BOX, edges[1:], 30.0, n_pi=5, **kw)[1],
        "to_redshift_space": lambda p, v, **kw: TT.to_redshift_space(
            p, v, BOX, **kw),
        "jacobian": lambda p, v, **kw: TG.cart_to_sph_jacobian(
            p[:, 0], p[:, 1], **kw),
    }
    call = calls[name]
    if torch.cuda.is_available():
        assert call(pos, vel).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(pos, vel)
    got = call(pos, vel, device="cpu")
    assert got.device.type == "cpu"
    same = call(T(pos), T(vel))
    npt.assert_array_equal(got.numpy(), same.numpy())


# ------------------------------------------------------------- fftlog
def test_fftlog_host_kernels_bit_identical():
    """The numpy Mellin kernels and the taper are the JAX package's copies:
    equal bit for bit."""
    for n, dln, ell, q in [(512, 0.03, 0, 1.5), (256, 0.05, 2, 1.5),
                           (128, 0.1, 4, 1.2)]:
        for a, b in zip(TF._fftlog_kernel(n, dln, ell, q),
                        JF._fftlog_kernel(n, dln, ell, q)):
            npt.assert_array_equal(a, b)
        for a, b in zip(TF._fftlog_kernel_cyl(n, dln, 2, 1.0),
                        JF._fftlog_kernel_cyl(n, dln, 2, 1.0)):
            npt.assert_array_equal(a, b)
        npt.assert_array_equal(TF._taper(n), np.asarray(JF._taper(n)))
    with pytest.raises(ValueError, match="Mellin strip"):
        TF._fftlog_kernel_cyl(64, 0.1, 0, 1.6)


def _fftlog64(k, fk, kern, power, dims, q):
    """The FFTLog series in float64 (numpy FFT) from the same float32
    kernel: the yardstick of both packages' float32 FFT rounding."""
    n = k.size
    dln = np.log(k[-1] / k[0]) / (n - 1)
    k0 = k[0]
    s = np.exp(np.arange(n) * dln) / (k0 * np.exp((n - 1) * dln))
    a = fk * (k / k0) ** power * TF._taper(n).astype(np.float64)
    b = np.fft.fft(a) * (kern[0].astype(np.float64)
                         + 1j * kern[1].astype(np.float64))
    return np.real(np.fft.fft(b)) * k0 ** dims * (k0 * s) ** (-q) / n


def _fftlog_parity(got, want, ref):
    """The port's float32 transform is about as close to the float64
    series as the JAX package's: its max error is at most 4x the JAX
    package's or 5e-5 of the largest |I|, whichever is larger (measured:
    up to 2.4x, on the Kaiser monopole). The biased series runs to 1e4-1e9
    times the output and cancels, so the two packages' float32 FFTs differ
    by up to ~1e-3 of the output where it is small."""
    err_t = np.abs(got - ref).max()
    err_j = np.abs(want - ref).max()
    assert err_t <= max(4.0 * err_j, 5e-5 * np.abs(ref).max()), (err_t,
                                                                 err_j)


@pytest.mark.parametrize("ell", [0, 2, 4])
def test_sph_bessel_transform_matches_jax(ell):
    """See `_fftlog_parity`; the s grid to rtol 1e-6, a batch row equal to
    its single transform."""
    k = np.logspace(-3, 2.5, 512)
    fk = (k ** 2 * np.exp(-0.5 * k ** 2)).astype(np.float32)
    s, out = TF.sph_bessel_transform(k, T(fk), ell)
    js, jout = JF.sph_bessel_transform(k, jnp.asarray(fk), ell)
    npt.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    dln = float(np.log(k[-1] / k[0]) / (k.size - 1))
    ref = _fftlog64(k, fk.astype(np.float64),
                    TF._fftlog_kernel(k.size, dln, ell, 1.5), 1.5, 3, 1.5)
    _fftlog_parity(out.numpy(), np.asarray(jout), ref)
    both = TF.sph_bessel_transform(k, T(np.stack([fk, 2 * fk])), ell)[1]
    npt.assert_array_equal(both[0].numpy(), out.numpy())


@pytest.mark.parametrize("mu", [0, 2, 4])
def test_bessel_transform_matches_jax(mu):
    """The cylindrical transform: see `_fftlog_parity`."""
    k = np.geomspace(1.0, 1e5, 256)
    fk = ((k / 100.0) ** 1.5 * np.exp(-(k / 3000.0) ** 2)).astype(np.float32)
    r, out = TF.bessel_transform(k, T(fk), mu)
    jr, jout = JF.bessel_transform(k, jnp.asarray(fk), mu)
    npt.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6)
    dln = float(np.log(k[-1] / k[0]) / (k.size - 1))
    ref = _fftlog64(k, fk.astype(np.float64),
                    TF._fftlog_kernel_cyl(k.size, dln, mu, 1.0), 1.0, 2, 1.0)
    _fftlog_parity(out.numpy(), np.asarray(jout), ref)


def test_correlation_and_wp_from_pk_match_jax():
    """The analytic Gaussian monopole to rtol 2e-3 (the JAX package's own
    bar); the xi multipoles of the Kaiser spectra (both packages handed
    the same float32 spectra) by `_fftlog_parity`; wp(rp), a trapezoid
    over the interpolated xi, rtol 1e-5."""
    k = np.logspace(-4, 3, 512)
    pk = np.exp(-0.5 * k ** 2)
    s, xi = TF.correlation_from_power(k, T(pk.astype(np.float32)))
    s = s.numpy()
    expected = np.exp(-0.5 * s ** 2) / (2.0 * np.pi) ** 1.5
    sel = (s > 0.05) & (s < 5.0)
    npt.assert_allclose(xi.numpy()[sel], expected[sel], rtol=2e-3,
                        atol=1e-6 * expected.max())
    jc = JCosmology()
    kk = np.logspace(-4, 2, 512)
    p3 = np.stack([np.asarray(p) for p in JL.kaiser_multipoles(
        jnp.asarray(kk, jnp.float32), jc)])
    s1, x1 = TF.xi_multipoles_from_pk(kk, T(p3))
    s2, x2 = JF.xi_multipoles_from_pk(kk, jnp.asarray(p3))
    npt.assert_allclose(s1.numpy(), np.asarray(s2), rtol=1e-6)
    dln = float(np.log(kk[-1] / kk[0]) / (kk.size - 1))
    for i, ell in enumerate((0, 2, 4)):
        ref = ((-1.0) ** (ell // 2) / (2.0 * np.pi ** 2) * _fftlog64(
            kk, p3[i].astype(np.float64),
            TF._fftlog_kernel(kk.size, dln, ell, 1.5), 1.5, 3, 1.5))
        _fftlog_parity(x1[i].numpy(), np.asarray(x2)[i], ref)
    kt = np.geomspace(1e-3, 30.0, 512)
    pkt = (4.0e5 * kt / (1.0 + (kt / 0.04) ** 2) ** 2).astype(np.float32)
    rp = np.linspace(5.0, 55.0, 11).astype(np.float32)
    wt = TF.wp_from_pk(kt, T(pkt), T(rp), 80.0)
    wj = np.asarray(JF.wp_from_pk(jnp.asarray(kt), jnp.asarray(pkt),
                                  jnp.asarray(rp), 80.0))
    npt.assert_allclose(wt.numpy(), wj, rtol=1e-5)
    with pytest.raises(ValueError, match="log-uniform"):
        TF.sph_bessel_transform(np.linspace(0.01, 1.0, 64), T(np.ones(64)),
                                0)


# ------------------------------------------- no-wiggle, Kaiser, BAO fits
def test_nowiggle_and_kaiser_match_jax():
    """The no-wiggle transfer and P(k), and the Kaiser multipoles at the
    JAX package's own amplitude: rtol 2e-5 (the k-independent fit
    coefficients are float64 here, float32 there); with the port's own
    amplitude rtol 2e-4 (a float32 against a float64 sigma8 integral)."""
    jc, tc = JCosmology(), Cosmology()
    k = np.geomspace(1e-4, 20.0, 300).astype(np.float32)
    npt.assert_allclose(
        TL.eh98_transfer_nowiggle(T(k), tc).numpy(),
        np.asarray(JL.eh98_transfer_nowiggle(jnp.asarray(k), jc)),
        rtol=2e-5)
    amp = float(JL.normalization(jc))
    for z in (0.0, 1.0):
        npt.assert_allclose(
            TL.linear_power_nowiggle(T(k), tc, z, amplitude=amp).numpy(),
            np.asarray(JL.linear_power_nowiggle(jnp.asarray(k), jc, z,
                                                amplitude=amp)), rtol=5e-5)
        for a, b in zip(TL.kaiser_multipoles(T(k), tc, z, bias=1.5,
                                             amplitude=amp),
                        JL.kaiser_multipoles(jnp.asarray(k), jc, z,
                                             bias=1.5, amplitude=amp)):
            npt.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-5)
    npt.assert_allclose(TL.linear_power_nowiggle(T(k), tc).numpy(),
                        np.asarray(JL.linear_power_nowiggle(jnp.asarray(k),
                                                            jc)), rtol=2e-4)
    # the wiggle ratio: broadband ~ 1 at low k, acoustic pattern around 1
    o = TBAO.wiggle_ratio(np.geomspace(1e-3, 0.5, 400), tc, device="cpu")
    npt.assert_allclose(o, JBAO.wiggle_ratio(np.geomspace(1e-3, 0.5, 400),
                                             jc), rtol=5e-5)
    npt.assert_allclose(o[:20], 1.0, atol=0.05)


def test_bao_fits_match_jax():
    """The template and both fits on the same noisy data: alpha (and
    alpha_par, alpha_perp) within 1e-4 of the JAX package's and within
    their errors of the truth; the errors to rtol 5e-3 (float32 spectra of
    two sigma8 integrals scale the template a few 1e-5 apart, which B^2
    absorbs)."""
    jc, tc = JCosmology(), Cosmology()
    k = np.linspace(0.02, 0.3, 57)
    rng = np.random.default_rng(3)
    truth = TBAO.bao_template_power(k, tc, alpha=1.03, sigma_nl=5.0,
                                    device="cpu")
    npt.assert_allclose(truth, JBAO.bao_template_power(
        k, jc, alpha=1.03, sigma_nl=5.0), rtol=2e-4)
    sig = 0.01 * truth
    data = 1.3 * truth + rng.normal(0, 1, k.size) * sig
    fit = TBAO.fit_bao_scale(k, data, tc, sigma=sig, sigma_nl=5.0,
                             device="cpu")
    jfit = JBAO.fit_bao_scale(k, data, jc, sigma=sig, sigma_nl=5.0)
    assert abs(fit.alpha - jfit.alpha) < 1e-4
    npt.assert_allclose(fit.alpha_err, jfit.alpha_err, rtol=5e-3)
    npt.assert_allclose(fit.chi2, jfit.chi2, rtol=5e-3, atol=1e-2)
    assert abs(fit.alpha - 1.03) < 4 * fit.alpha_err
    assert fit.dof == jfit.dof and fit.model.shape == jfit.model.shape
    with pytest.raises(ValueError, match="grid edge"):
        TBAO.fit_bao_scale(k, data, tc, sigma=sig, sigma_nl=5.0,
                           alphas=np.linspace(0.9, 1.0, 21), device="cpu")
    with pytest.raises(ValueError, match="sigma or cov"):
        TBAO.fit_bao_scale(k, data, tc, sigma=sig, cov=np.eye(k.size),
                           device="cpu")
    # anisotropic: Kaiser-damped multipoles of the template, a coarse grid
    kw = dict(apars=np.linspace(0.9, 1.1, 21), aperps=np.linspace(0.9, 1.1,
                                                                  21),
              n_mu=8)
    p_ells = np.stack([truth * (1 + 2 * 0.4 / 3 + 0.4 ** 2 / 5),
                       truth * (4 * 0.4 / 3 + 4 * 0.4 ** 2 / 7)])
    sig2 = 0.02 * np.abs(p_ells) + 1.0
    noisy = p_ells + rng.normal(0, 1, p_ells.shape) * sig2
    an = TBAO.fit_bao_scale_aniso(k, noisy, tc, sigma=sig2, device="cpu",
                                  **kw)
    jan = JBAO.fit_bao_scale_aniso(k, noisy, jc, sigma=sig2, **kw)
    assert abs(an.alpha_par - jan.alpha_par) < 1e-4
    assert abs(an.alpha_perp - jan.alpha_perp) < 1e-4
    npt.assert_allclose([an.err_par, an.err_perp],
                        [jan.err_par, jan.err_perp], rtol=5e-3)
    assert an.model.shape == (2, k.size)


# -------------------------------------------------------------- mocks
def _pk(k):
    return 2.0e4 * k / (1.0 + (k / 0.04) ** 2) ** 2


def test_mocks_from_the_same_white_noise_match_jax():
    """The JAX package's key -> white noise -> modes, handed to the port's
    `*_from_modes`: the Gaussian field to atol 1e-5 of its largest value,
    Zel'dovich positions to 1e-4 Mpc/h (periodic distance), velocities
    atol 1e-3 km/s (two FFT libraries on float32 modes)."""
    key = jax.random.PRNGKey(5)
    n, box = 16, 200.0
    white = np.asarray(jax.random.normal(key, (n, n, n)))
    modes = TM.modes_from_white(T(white), n, box, _pk)
    g = TM.gaussian_field_from_modes(modes)
    jg = np.asarray(JM.gaussian_field(key, n, box, _pk))
    npt.assert_allclose(g.numpy(), jg, atol=1e-5 * np.abs(jg).max())
    pos, vel = TM.zeldovich_catalog_with_velocities_from_modes(
        modes, n, box, 0.52)
    jpos, jvel = JM.zeldovich_catalog_with_velocities(key, n, box, _pk, 0.52)
    d = pos.numpy() - np.asarray(jpos)
    d -= box * np.round(d / box)
    assert np.abs(d).max() < 1e-4
    npt.assert_allclose(vel.numpy(), np.asarray(jvel), atol=1e-3)
    p2 = TM.zeldovich_catalog_from_modes(modes, n, box)
    npt.assert_array_equal(p2.numpy(), pos.numpy())
    assert float(pos.min()) >= 0.0 and float(pos.max()) <= box


def test_mocks_from_a_generator():
    """The generator entry points draw one `linear_modes` field: the same
    seed gives the field and catalogs of those modes (equal), and the
    Gaussian field's power matches pk_fn (2LPT-free closure, mean ratio
    within 10% over the first 8 shells)."""
    from astrild_tpu_torch.ops import power as TP

    n, box = 32, 300.0

    def gen():
        return torch.Generator().manual_seed(11)

    modes = TM.linear_modes(gen(), n, box, _pk)
    npt.assert_array_equal(TM.gaussian_field(gen(), n, box, _pk).numpy(),
                           TM.gaussian_field_from_modes(modes).numpy())
    npt.assert_array_equal(TM.zeldovich_catalog(gen(), n, box, _pk).numpy(),
                           TM.zeldovich_catalog_from_modes(modes, n,
                                                           box).numpy())
    pos, vel = TM.zeldovich_catalog_with_velocities(gen(), n, box, _pk, 0.5)
    assert pos.shape == vel.shape == (n ** 3, 3)
    g = TM.gaussian_field(gen(), n, box, _pk)
    res = TP.auto_power(g + 1.0, box, nbins=8)
    ratio = res.power[:8] / _pk(res.k[:8])
    assert abs(float(ratio.mean()) - 1.0) < 0.1
