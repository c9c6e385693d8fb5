"""PyTorch port vs JAX package on the CPU: the Gaussian covariances and
the spatial jackknife (astrild_tpu_torch/ops/covariance.py), mirroring
tests/test_covariance.py.

The analytic covariances take the same numpy inputs as the JAX package's
and agree to rtol 1e-5 (float32 on both sides, the multipole covariance
summed over the same modes, bins and weights); the jackknife's labels are
equal and its covariance agrees to rtol 1e-5. The JAX package's checks
against the scatter of Gaussian realizations are held on the port's own
estimators and generators (a torch.Generator, so other draws than JAX's).
"""
import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from astrild_tpu.ops import covariance as JCV  # noqa: E402
from astrild_tpu_torch.ops import covariance as TCV  # noqa: E402
from astrild_tpu_torch.ops import mocks as TM  # noqa: E402
from astrild_tpu_torch.ops import power as TP  # noqa: E402

NGRID, BOX, NBINS, NREAL = 32, 500.0, 8, 60


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


def _p_iso_j(k):
    return 2e4 * jnp.exp(-((jnp.asarray(k) / 0.25) ** 2))


def _p_iso_t(k):
    return 2e4 * torch.exp(-((k / 0.25) ** 2))


def N(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


def test_pk_covariance_matches_jax_and_realizations():
    """Var[P] against the JAX formula (rtol 1e-6), and against the scatter
    of 60 Gaussian fields measured with the port's auto_power (0.4-2.5,
    the JAX test's band)."""
    gen = torch.Generator().manual_seed(0)
    pks = []
    for _ in range(NREAL):
        d = TM.gaussian_field(gen, NGRID, BOX, _p_iso_t)
        pks.append(N(TP.auto_power(1.0 + d, BOX, nbins=NBINS).power))
    res = TP.auto_power(1.0 + d, BOX, nbins=NBINS)
    var_pred = TCV.gaussian_pk_covariance(_p_iso_t(res.k), res.nmodes)
    npt.assert_allclose(
        N(var_pred), N(JCV.gaussian_pk_covariance(_p_iso_j(N(res.k)),
                                                  N(res.nmodes))),
        rtol=1e-6)
    sel = N(res.nmodes) > 3
    ratio = np.var(pks, axis=0, ddof=1)[sel] / N(var_pred)[sel]
    assert np.all(ratio > 0.4) and np.all(ratio < 2.5), ratio


@pytest.mark.parametrize("beta, bias, shot, los", [(0.5, 1.0, 0.0, 2),
                                                   (0.3, 1.8, 50.0, 0)])
def test_multipole_covariance_matches_jax(beta, bias, shot, los):
    """(k, C_ll'(k_b), N_b) on the same mode grid as the JAX package's:
    k and counts equal, C within 1e-5 of each block's max."""
    k, cov, nm = TCV.gaussian_multipole_covariance(
        NGRID, BOX, NBINS, _p_iso_t, beta=beta, bias=bias, shotnoise=shot,
        los=los, device="cpu")
    kj, covj, nmj = JCV.gaussian_multipole_covariance(
        NGRID, BOX, NBINS, _p_iso_j, beta=beta, bias=bias, shotnoise=shot,
        los=los)
    npt.assert_allclose(N(k), N(kj), rtol=1e-6)
    npt.assert_array_equal(N(nm), N(nmj))
    covj = N(covj)
    for i in range(3):
        for j in range(3):
            npt.assert_allclose(N(cov)[i, j], covj[i, j], rtol=0,
                                atol=1e-5 * np.abs(covj[i, j]).max())


def test_multipole_covariance_structure_and_scale():
    """Symmetric in (l, l'), positive variances; at beta = 0 the monopole
    variance is the isotropic formula within the bin's spread of P (the
    JAX test's 35%)."""
    _, cov, _ = TCV.gaussian_multipole_covariance(NGRID, BOX, NBINS,
                                                  _p_iso_t, beta=0.5,
                                                  device="cpu")
    cov = N(cov)
    assert cov.shape == (3, 3, NBINS)
    npt.assert_array_equal(cov[0, 1], cov[1, 0])
    assert np.all(cov[0, 0] > 0) and np.all(cov[1, 1] > 0)
    k0, cov0, nm0 = TCV.gaussian_multipole_covariance(
        NGRID, BOX, NBINS, _p_iso_t, beta=0.0, device="cpu")
    iso = N(TCV.gaussian_pk_covariance(_p_iso_t(k0), nm0))
    npt.assert_allclose(N(cov0)[0, 0], iso, rtol=0.35)


def test_cl_covariance_matches_jax():
    ells = np.asarray([10.0, 100.0, 1000.0])
    cl = np.asarray([1.0, 0.1, 1e-3])
    v = TCV.gaussian_cl_covariance(cl, ells, fsky=0.5, noise_cl=1e-3,
                                   delta_ell=10.0, device="cpu")
    npt.assert_allclose(N(v), N(JCV.gaussian_cl_covariance(
        cl, ells, fsky=0.5, noise_cl=1e-3, delta_ell=10.0)), rtol=1e-6)
    v0 = TCV.gaussian_cl_covariance(cl[:1], ells[:1], fsky=0.5,
                                    delta_ell=10.0, device="cpu")
    npt.assert_allclose(float(v0[0]), 2.0 / (21 * 0.5 * 10.0), rtol=1e-6)


def test_flat_sky_cl_variance_matches_realizations():
    """Gaussian C_ell error bars with cl_flat_sky's own mode counts against
    the scatter of 80 maps from cl_to_flat_map (0.55-1.7, the JAX test's
    band; nm/2 would put the ratio near 0.5)."""
    from astrild_tpu_torch.ops.angular_power import (cl_flat_sky,
                                                     cl_to_flat_map,
                                                     flat_sky_mode_counts)

    npix, oa, nb = 64, 10.0, 10
    ells_tab = np.geomspace(1.0, 5000.0, 128).astype(np.float32)
    cl_tab = 1e-3 / (ells_tab + 30.0) ** 2
    gen = torch.Generator().manual_seed(1)
    cls = np.stack([N(cl_flat_sky(cl_to_flat_map(gen, ells_tab, cl_tab,
                                                 npix, oa), oa,
                                  nbins=nb)[1]) for _ in range(80)])
    _, nm = flat_sky_mode_counts(npix, oa, nbins=nb, device="cpu")
    var_pred = N(TCV.gaussian_pk_covariance(cls.mean(axis=0), nm,
                                            device="cpu"))
    sel = N(nm) > 40
    ratio = cls.var(axis=0, ddof=1)[sel] / var_pred[sel]
    assert np.all(ratio > 0.55) and np.all(ratio < 1.7), ratio


def test_spatial_jackknife_exact_for_linear_statistic():
    """The delete-one jackknife of a padded-aware weighted sum has the
    closed form of region sums; labels and covariance equal the JAX
    package's (the JAX test, plus the parity)."""
    rng = np.random.default_rng(0)
    n, L, nside = 3000, 100.0, 2
    pos = rng.uniform(0, L, (n, 3))
    w = rng.normal(1.0, 0.3, n)

    def est_t(p, n_valid, wcol):
        mask = torch.arange(p.shape[0]) < n_valid
        return torch.stack([torch.where(mask, wcol, 0.0).sum()])

    def est_j(p, n_valid, wcol):
        mask = jnp.arange(p.shape[0]) < n_valid
        return jnp.array([jnp.sum(jnp.where(mask, wcol, 0.0))])

    full, jk, cov = TCV.spatial_jackknife(est_t, pos, L, n_side=nside,
                                          extra_cols=(w,), device="cpu")
    labels = TCV.spatial_jackknife_regions(pos, L, nside)
    npt.assert_array_equal(labels,
                           JCV.spatial_jackknife_regions(pos, L, nside))
    npt.assert_array_equal(
        TCV.spatial_jackknife_regions(tuple(pos.T), L, nside), labels)
    region_sums = np.array([w[labels == r].sum() for r in range(8)])
    npt.assert_allclose(float(full[0]), w.sum(), rtol=1e-6)
    npt.assert_allclose(jk[:, 0], w.sum() - region_sums, rtol=1e-5)
    d = jk[:, 0] - jk[:, 0].mean()
    npt.assert_allclose(cov[0, 0], 7.0 / 8.0 * np.sum(d * d), rtol=1e-6)
    fj, jkj, covj = JCV.spatial_jackknife(est_j, pos, L, n_side=nside,
                                          extra_cols=(w,))
    npt.assert_allclose(jk, jkj, rtol=1e-5)
    npt.assert_allclose(cov, covj, rtol=1e-4)


def test_spatial_jackknife_wp_smoke():
    """Jackknife over the port's wp estimator: positive variances, and a
    Poisson box's wp within 5 jackknife sigmas of 0 (the JAX test)."""
    from astrild_tpu_torch.ops.tpcf import projected_tpcf

    rng = np.random.default_rng(1)
    n, L = 2000, 120.0
    pos = rng.uniform(0, L, (n, 3)).astype(np.float32)
    rp_edges = np.linspace(4.0, 30.0, 5).astype(np.float32)

    def est(p, n_valid, *unused):
        _, wp, _ = projected_tpcf(p, L, rp_edges, pi_max=40.0, n_pi=8,
                                  n_valid=n_valid, block=256)
        return wp

    full, jk, cov = TCV.spatial_jackknife(est, pos, L, n_side=2,
                                          device="cpu")
    sig = np.sqrt(np.diag(cov))
    assert (sig > 0).all() and jk.shape == (8, 4)
    assert (np.abs(full) < 5 * sig).all()
