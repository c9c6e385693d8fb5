"""PyTorch port vs JAX package on the CPU: the flat-sky lightcone lane
(lens planes from particles, multi-plane ray tracing, the PM lightcone).

Inputs are made with numpy from a seed and handed to both packages. On a
CPU tensor the port's plane painter runs its plain version (the per-plane
scan); its deposit path is forced here by calling `_plane_counts_deposit`,
whose sorted deposit then runs K1's plain version. The JAX deposit path
runs its Pallas kernel in interpret mode, as the JAX package's own test
does. Each tolerance is stated where it is checked.
"""
import math

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from astrild_tpu.ops import lens_planes as JLP  # noqa: E402
from astrild_tpu.ops import mocks as JM  # noqa: E402
from astrild_tpu.ops import nbody as JN  # noqa: E402
from astrild_tpu.ops import raytrace as JRT  # noqa: E402
from astrild_tpu.utils.cosmology import Cosmology as JCosmology  # noqa: E402
from astrild_tpu_torch.ops import lens_planes as TLP  # noqa: E402
from astrild_tpu_torch.ops import lensing as TLens  # noqa: E402
from astrild_tpu_torch.ops import nbody as TN  # noqa: E402
from astrild_tpu_torch.ops import paint_cuda  # noqa: E402
from astrild_tpu_torch.ops import raytrace as TRT  # noqa: E402
from astrild_tpu_torch.utils.cosmology import Cosmology  # noqa: E402

BOX = 500.0
# (chi0, dchi, nplanes, fov, npix, n_rep): a narrow cone and a wide one
# over several box depths, the cases of the JAX package's own test
CONES = {"narrow": (200.0, 31.25, 8, 0.35, 64, 0),
         "wide_nrep1": (950.0, 100.0, 6, 0.6, 32, 1)}


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


def _flat_pos(rng, n):
    return tuple(rng.uniform(0, BOX, n).astype(np.float32) for _ in range(3))


def _t(arrs):
    return tuple(torch.from_numpy(np.array(a)) for a in arrs)


# ------------------------------------------------------------ lens planes
@pytest.mark.parametrize("cone", sorted(CONES))
@pytest.mark.parametrize("weighted", [False, True])
def test_plane_scan_matches_jax_scan(rng, cone, weighted):
    """The plain version against the JAX scan: the same float32 key
    arithmetic, sums in another order: atol 1e-4 on counts of O(1-10)."""
    chi0, dchi, nplanes, fov, npix, n_rep = CONES[cone]
    pos = _flat_pos(rng, 20000)
    w = rng.uniform(0.5, 1.5, 20000).astype(np.float32) if weighted else None
    want, chis_j = JLP._plane_counts_scan(
        tuple(jnp.asarray(c) for c in pos), BOX, chi0, dchi, nplanes, fov,
        npix, 2, None, n_rep, None if w is None else jnp.asarray(w))
    got, chis_t = TLP._plane_counts_scan(
        _t(pos), BOX, chi0, dchi, nplanes, fov, npix, 2, None, n_rep,
        None if w is None else torch.from_numpy(w))
    npt.assert_array_equal(chis_t.numpy(), np.asarray(chis_j))
    assert float(np.asarray(want).sum()) > 100.0
    npt.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _deposit_flushes(monkeypatch, budget, *args):
    """`_plane_counts_deposit(*args)` with room for `budget` entries a
    flush (None: as found, no limit on the CPU); returns (counts, chis,
    the entries of each flush)."""
    sizes = []
    real = paint_cuda.deposit_flat

    def recording(keys, weights, n_cells):
        sizes.append(keys.shape[0])
        return real(keys, weights, n_cells)

    with monkeypatch.context() as patch:
        patch.setattr(paint_cuda, "deposit_flat", recording)
        if budget is not None:
            patch.setattr(TLP, "_entry_budget", lambda dev, n_cells: budget)
        counts, chis = TLP._plane_counts_deposit(*args)
    return counts, chis, sizes


def _greedy_groups(entries, budget):
    """Planes join a group until the next would pass the budget."""
    if budget is None:
        return [sum(entries)]
    groups = [0]
    for e in entries:
        if groups[-1] and groups[-1] + e > budget:
            groups.append(0)
        groups[-1] += e
    return groups


@pytest.mark.parametrize("cone", sorted(CONES))
@pytest.mark.parametrize("group", [None, 1, 2])
def test_plane_deposit_matches_own_scan(rng, cone, group, monkeypatch):
    """The deposit path (selection, keys, K1's plain version) against
    the port's own scan on the same particles, with an off-centre observer
    and weights: atol 1e-4; the totals to rtol 1e-6. With room for `group`
    times the largest plane's entries the planes are flushed in the groups
    that room gives, each one deposit, and add up to the same counts."""
    chi0, dchi, nplanes, fov, npix, n_rep = CONES[cone]
    pos = _t(_flat_pos(rng, 20000))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, 20000).astype(np.float32))
    oxy = (123.0, 377.5)
    want, _ = TLP._plane_counts_scan(pos, BOX, chi0, dchi, nplanes, fov,
                                     npix, 2, oxy, n_rep, w)
    # each plane's entries, from one-plane calls (chi0 and dchi are exact
    # in float32, so these are the stacked call's planes)
    alone = [_deposit_flushes(monkeypatch, None, pos, BOX, chi0 + i * dchi,
                              dchi, 1, fov, npix, 2, oxy, n_rep, w)
             for i in range(nplanes)]
    per_plane = [sizes[0] for _, _, sizes in alone]
    budget = None if group is None else group * max(per_plane)
    got, chis, sizes = _deposit_flushes(monkeypatch, budget, pos, BOX, chi0,
                                        dchi, nplanes, fov, npix, 2, oxy,
                                        n_rep, w)
    assert sizes == _greedy_groups(per_plane, budget)
    assert len(sizes) == 1 if group is None else len(sizes) > 1
    npt.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
    npt.assert_allclose(torch.cat([c for c, _, _ in alone]).numpy(),
                        want.numpy(), atol=1e-4)
    npt.assert_allclose(float(got.double().sum()),
                        float(want.double().sum()), rtol=1e-6)
    assert got.shape == (nplanes, npix, npix) and chis.shape == (nplanes,)


@pytest.mark.parametrize("cone", sorted(CONES))
def test_plane_entries_deposit_to_the_plane(rng, cone):
    """`plane_entries` (K1's input for one plane, as the flush gives it)
    deposited through `deposit_flat`, and `sorted_plane_entries` (the same
    entries in ascending key order) through `deposit_sorted`, give that
    plane of the JAX scan: atol 1e-4; the junk cell npix^2 holds weight
    0."""
    chi0, dchi, nplanes, fov, npix, n_rep = CONES[cone]
    pos = _flat_pos(rng, 20000)
    chi = chi0 + (nplanes - 1) * dchi
    want, _ = JLP._plane_counts_scan(
        tuple(jnp.asarray(c) for c in pos), BOX, chi, dchi, 1, fov, npix, 2,
        None, n_rep)
    keys, vals = TLP.plane_entries(_t(pos), BOX, chi, dchi, fov, npix,
                                   n_rep=n_rep)
    skeys, svals = TLP.sorted_plane_entries(_t(pos), BOX, chi, dchi, fov,
                                            npix, n_rep=n_rep)
    assert keys.dtype == torch.int32 and keys.shape == vals.shape
    assert bool((skeys[1:] >= skeys[:-1]).all())
    assert torch.equal(torch.sort(keys)[0], skeys)
    n_cells = npix * npix + 1
    flat = paint_cuda.deposit_flat(keys, vals, n_cells)
    srt = paint_cuda.deposit_sorted(skeys, svals, n_cells)
    assert float(flat[-1]) == 0.0 and float(srt[-1]) == 0.0
    for got in (flat, srt):
        npt.assert_allclose(got[:-1].view(npix, npix).numpy(),
                            np.asarray(want)[0], atol=1e-4)


@pytest.mark.parametrize("los", [0, 1])
def test_plane_deposit_other_los_axes(rng, los):
    """los = 0 and 1 pick the other two axes as transverse, in order."""
    pos = _t(_flat_pos(rng, 5000))
    want, _ = TLP._plane_counts_scan(pos, BOX, 300.0, 100.0, 3, 0.3, 16,
                                     los, None, 0)
    got, _ = TLP._plane_counts_deposit(pos, BOX, 300.0, 100.0, 3, 0.3, 16,
                                       los, None, 0)
    jwant, _ = JLP._plane_counts_scan(
        tuple(jnp.asarray(c.numpy()) for c in pos), BOX, 300.0, 100.0, 3,
        0.3, 16, los, None, 0)
    npt.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
    npt.assert_allclose(want.numpy(), np.asarray(jwant), atol=1e-4)


@pytest.mark.parametrize("cone", sorted(CONES))
def test_plane_deposit_matches_jax_deposit_interpret(rng, cone):
    """The port's deposit path against the JAX deposit path with its
    Pallas kernel in interpret mode (what the JAX package's own test
    runs; a few seconds at this size): atol 1e-4 on 2e4 uniform
    particles, of which none lies within float32 rounding of a slab edge,
    where the two packages' deposit paths take different decisions."""
    chi0, dchi, nplanes, fov, npix, n_rep = CONES[cone]
    pos = _flat_pos(rng, 20000)
    k_lo = math.floor((chi0 - 0.5 * dchi) / BOX)
    k_hi = math.floor((chi0 + (nplanes - 0.5) * dchi) / BOX)
    want, _ = JLP._plane_counts_deposit(
        tuple(jnp.asarray(c) for c in pos), BOX, chi0, dchi, nplanes, fov,
        npix, 2, None, n_rep, k_lo, k_hi)
    got, _ = TLP._plane_counts_deposit(_t(pos), BOX, chi0, dchi, nplanes,
                                       fov, npix, 2, None, n_rep)
    npt.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_replica_ranges_match_jax():
    for args in ((500.0, 200.0, 31.25, 8, 0.35),
                 (500.0, 950.0, 100.0, 6, 0.6),
                 (250.0, 90.0, 180.0, 12, 0.08),
                 (500.0, 72.0, 145.0, 16, 0.2)):
        assert TLP.replica_ranges(*args) == JLP.replica_ranges(*args)


def test_density_planes_match_jax(rng):
    """`density_planes_from_particles` against JAX's on an (n, 3) array,
    the wide cone's derived n_rep = 1: rtol 1e-4 of the planes' largest
    |delta|."""
    chi0, dchi, nplanes, fov, npix, _ = CONES["wide_nrep1"]
    pos = rng.uniform(0, BOX, (20000, 3)).astype(np.float32)
    want, chis_j = JLP.density_planes_from_particles(
        jnp.asarray(pos), BOX, chi0, dchi, nplanes, fov, npix)
    got, chis_t = TLP.density_planes_from_particles(
        torch.from_numpy(pos), BOX, chi0, dchi, nplanes, fov, npix)
    want = np.asarray(want)
    npt.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())
    npt.assert_allclose(chis_t.numpy(), np.asarray(chis_j), rtol=1e-7)
    nrep, _ = TLP.density_planes_from_particles_nrep(
        torch.from_numpy(pos), BOX, chi0, dchi, nplanes, fov, npix, n_rep=1)
    npt.assert_array_equal(nrep.numpy(), got.numpy())


def test_uniform_box_gives_near_zero_delta(rng):
    n = 1 << 20
    pos = torch.from_numpy(rng.uniform(0, BOX, (n, 3)).astype(np.float32))
    planes, chis = TLP.density_planes_from_particles(
        pos, BOX, 600.0, 200.0, 4, np.radians(2.0), 32)
    planes = planes.numpy()
    assert planes.shape == (4, 32, 32)
    npt.assert_allclose(chis.numpy(), [600.0, 800.0, 1000.0, 1200.0])
    # Poisson noise: expected counts/pixel ~ nbar*dchi*(chi*pix)^2
    for i, chi in enumerate([600.0, 800.0, 1000.0, 1200.0]):
        expect = n / BOX ** 3 * 200.0 * (chi * np.radians(2.0) / 32) ** 2
        sigma = 1.0 / np.sqrt(expect)
        inner = planes[i][4:-4, 4:-4]  # away from FOV edges
        assert abs(inner.mean()) < 5 * sigma / np.sqrt(inner.size) * 10
        assert 0.5 * sigma < inner.std() < 1.5 * sigma


def test_clump_lands_on_expected_plane_and_pixel(rng):
    n_bg = 1 << 18
    pos_bg = rng.uniform(0, BOX, (n_bg, 3)).astype(np.float32)
    # clump at chi = 850 (plane 1 of centers 600/800/1000 with dchi=200
    # covers [700, 900)), offset +0.004 rad in the first transverse axis
    chi_c = 850.0
    z_c = chi_c % BOX  # box replication puts it back in [0, BOX)
    x_c = BOX / 2 + 0.004 * chi_c
    clump = np.tile(np.array([[x_c, BOX / 2, z_c]], np.float32), (4096, 1))
    pos = torch.from_numpy(np.concatenate([pos_bg, clump]))
    planes, _ = TLP.density_planes_from_particles(
        pos, BOX, 600.0, 200.0, 3, np.radians(2.0), 64)
    planes = planes.numpy()
    assert np.argmax(planes.max(axis=(1, 2))) == 1
    i, j = np.unravel_index(planes[1].argmax(), planes[1].shape)
    pix = np.radians(2.0) / 64
    assert abs(i - (0.004 / pix + 64 / 2 - 0.5)) <= 1
    assert abs(j - (64 / 2 - 0.5)) <= 1


def test_flat_component_input_matches_array(rng):
    n = 1 << 16
    pos = rng.uniform(0, BOX, (n, 3)).astype(np.float32)
    a, _ = TLP.density_planes_from_particles(
        torch.from_numpy(pos), BOX, 600.0, 200.0, 2, np.radians(2.0), 16)
    b, _ = TLP.density_planes_from_particles(
        tuple(torch.from_numpy(np.ascontiguousarray(pos[:, i]))
              for i in range(3)), BOX, 600.0, 200.0, 2, np.radians(2.0), 16)
    npt.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
    # numpy input runs where it is told to
    c, _ = TLP.density_planes_from_particles(
        pos, BOX, 600.0, 200.0, 2, np.radians(2.0), 16, device="cpu")
    npt.assert_array_equal(c.numpy(), a.numpy())


def test_numpy_input_without_a_card_raises(rng):
    if torch.cuda.is_available():
        pytest.skip("a card is present: numpy input runs on it")
    pos = rng.uniform(0, BOX, (100, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TLP.density_planes_from_particles(pos, BOX, 300.0, 100.0, 2, 0.05,
                                          16)


def test_dchi_thicker_than_box_raises(rng):
    pos = _t(_flat_pos(rng, 100))
    with pytest.raises(ValueError, match="exceeds boxsize"):
        TLP.density_planes_from_particles(pos, BOX, 300.0, 1.2 * BOX, 2,
                                          0.05, 16)


def test_too_many_cells_raises_before_any_key(rng):
    pos = _t(_flat_pos(rng, 10))
    with pytest.raises(ValueError, match="2\\^31"):
        TLP._plane_counts_deposit(pos, BOX, 300.0, 100.0, 512, 0.05, 2048,
                                  2, None, 0)


def test_plane_over_budget_raises_with_sizes(rng, monkeypatch):
    """A plane whose entries pass the card's room raises and names both
    sizes (the budget is what the card reports; here it is set)."""
    monkeypatch.setattr(TLP, "_entry_budget", lambda dev, n_cells: 1000)
    pos = _t(_flat_pos(rng, 20000))
    with pytest.raises(RuntimeError, match="room for 1000"):
        TLP._plane_counts_deposit(pos, BOX, 950.0, 100.0, 6, 0.6, 32, 2,
                                  None, 1)
    # a budget that holds a plane but not two flushes plane by plane
    monkeypatch.setattr(TLP, "_entry_budget", lambda dev, n_cells: 150000)
    got, _ = TLP._plane_counts_deposit(pos, BOX, 950.0, 100.0, 6, 0.6, 32,
                                       2, None, 1)
    want, _ = TLP._plane_counts_scan(pos, BOX, 950.0, 100.0, 6, 0.6, 32, 2,
                                     None, 1)
    npt.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


# -------------------------------------------------------------- ray tracing
def _planes(rng, nplane, npix, amp=0.5):
    return (amp * rng.standard_normal((nplane, npix, npix))).astype(
        np.float32)


@pytest.mark.parametrize("npix,padding", [(32, 1), (33, 1), (32, 2),
                                          (24, 2)])
def test_plane_deflection_fields_match_jax(rng, npix, padding):
    """Spectral deflection and Jacobian, even and odd sizes, periodic and
    zero-padded: rtol 1e-4 of each map's max."""
    kap = _planes(rng, 1, npix)[0]
    want = JRT.plane_deflection_fields(jnp.asarray(kap), 0.05,
                                       padding_factor=padding)
    got = TRT.plane_deflection_fields(torch.from_numpy(kap), 0.05,
                                      padding_factor=padding)
    for g, w in zip(got, want):
        w = np.asarray(w)
        npt.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max())
    # a batch of planes gives each plane's fields
    stack = _planes(rng, 3, npix)
    batched = TRT.plane_deflection_fields(torch.from_numpy(stack), 0.05,
                                          padding_factor=padding)
    single = TRT.plane_deflection_fields(torch.from_numpy(stack[1]), 0.05,
                                         padding_factor=padding)
    for b, s in zip(batched, single):
        npt.assert_allclose(b[1].numpy(), s.numpy(),
                            atol=1e-5 * float(s.abs().max()))


def test_effective_plane_kappa_matches_jax(rng):
    d = _planes(rng, 1, 8)[0]
    want = JRT.effective_plane_kappa(jnp.asarray(d), 800.0, 120.0, 0.7, 0.3)
    got = TRT.effective_plane_kappa(torch.from_numpy(d), 800.0, 120.0, 0.7,
                                    0.3)
    npt.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("case", ["stack", "odd", "padded", "n_rays"])
def test_multiplane_raytrace_matches_jax(rng, case):
    """Every output map against JAX's: rtol 1e-4 of the map's max (omega,
    a difference of nearly equal terms, against kappa's max)."""
    npix = 33 if case == "odd" else 32
    kw = {"padded": {"padding_factor": 2}, "n_rays": {"n_rays": 20}}.get(
        case, {})
    nplane = 5
    delta = _planes(rng, nplane, npix, amp=2.0)
    chis = np.linspace(300.0, 1500.0, nplane).astype(np.float32)
    dchis = np.full(nplane, 300.0, np.float32)
    a = (1.0 / (1.0 + np.linspace(0.1, 0.6, nplane))).astype(np.float32)
    want = JRT.multiplane_raytrace(jnp.asarray(delta), jnp.asarray(chis),
                                   jnp.asarray(dchis), 2000.0, 0.3, 0.05,
                                   scale_factors=jnp.asarray(a), **kw)
    got = TRT.multiplane_raytrace(torch.from_numpy(delta),
                                  torch.from_numpy(chis),
                                  torch.from_numpy(dchis), 2000.0, 0.3, 0.05,
                                  scale_factors=torch.from_numpy(a), **kw)
    kmax = np.abs(np.asarray(want["kappa"])).max()
    assert kmax > 1e-3
    for name, w in want.items():
        w = np.asarray(w)
        scale = kmax if name == "omega" else np.abs(w).max()
        npt.assert_allclose(got[name].numpy(), w, atol=1e-4 * scale,
                            err_msg=name)


def test_multiplane_raytrace_matches_jax_where_rays_leave_their_pixels(rng):
    """Planes with strong box-scale modes under white pixel noise: the rays
    end more than a pixel (rms) from their Born lines, so the traced kappa
    decorrelates from the Born kappa at the pixel scale (below 0.99; 1 in
    the weak-field limit). Both packages must read that same number
    (within 1e-5) and the same maps (rtol 1e-4 of each map's max)."""
    nplane, npix, fov, chi_s = 5, 128, 0.2, 2000.0
    t = np.arange(npix) / npix
    delta = []
    for _ in range(nplane):
        ph = rng.uniform(0, 2 * np.pi, 3)
        big = (np.cos(2 * np.pi * t[:, None] + ph[0])
               + np.cos(2 * np.pi * t[None, :] + ph[1])
               + np.cos(2 * np.pi * (t[:, None] + 2 * t[None, :]) + ph[2]))
        delta.append(2.5 * big + rng.standard_normal((npix, npix)))
    delta = np.asarray(delta, np.float32)
    chis = np.linspace(300.0, 1500.0, nplane).astype(np.float32)
    dchis = np.full(nplane, 300.0, np.float32)
    want = JRT.multiplane_raytrace(jnp.asarray(delta), jnp.asarray(chis),
                                   jnp.asarray(dchis), chi_s, 0.3, fov)
    args = (torch.from_numpy(delta), torch.from_numpy(chis),
            torch.from_numpy(dchis), chi_s, 0.3)
    got = TRT.multiplane_raytrace(*args, fov)
    born = TLens.born_convergence(*args).numpy()

    def corr(a, b):
        a = np.asarray(a, np.float64) - np.mean(a)
        b = np.asarray(b, np.float64) - np.mean(b)
        return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))

    theta = (np.arange(npix) * (fov / npix)).astype(np.float32)
    left = np.sqrt(np.mean((got["beta1"].numpy() - theta[:, None]) ** 2
                           + (got["beta2"].numpy() - theta[None, :]) ** 2))
    assert left > fov / npix
    c_port = corr(got["kappa"].numpy(), born)
    c_jax = corr(want["kappa"], born)
    assert c_port < 0.99 and abs(c_port - c_jax) < 1e-5
    kmax = np.abs(np.asarray(want["kappa"])).max()
    for name, w in want.items():
        w = np.asarray(w)
        scale = kmax if name == "omega" else np.abs(w).max()
        npt.assert_allclose(got[name].numpy(), w, atol=1e-4 * scale,
                            err_msg=name)


def test_multiplane_single_plane_is_exact(rng):
    """One plane: kappa = (1 - chi_l/chi_s) kap_plane and omega = 0, to
    float32 rounding of the spectral round trip (1e-5 of kappa's max)."""
    npix = 32
    delta = torch.from_numpy(_planes(rng, 1, npix, amp=1.0))
    delta = delta - delta.mean()
    chi, dchi, chi_s = 900.0, 200.0, 2000.0
    out = TRT.multiplane_raytrace(delta, [chi], [dchi], chi_s, 0.3, 0.04)
    kap = TRT.effective_plane_kappa(delta[0], chi, dchi, 1.0, 0.3)
    want = (1.0 - chi / chi_s) * kap
    # the spectral solve drops the Nyquist modes of the odd transfers only;
    # u11 + u22 keeps every mode but the mean
    npt.assert_allclose(out["kappa"].numpy(), want.numpy(),
                        atol=1e-5 * float(want.abs().max()))
    assert float(out["omega"].abs().max()) < 1e-6


def test_multiplane_born_limit(rng):
    """Weak planes: the ray-traced kappa is the Born sum (post-Born terms
    are second order in the 1e-3 amplitudes)."""
    nplane, npix = 4, 32
    delta = _planes(rng, nplane, npix, amp=1e-2)
    delta -= delta.mean(axis=(1, 2), keepdims=True)
    chis = torch.tensor([400.0, 800.0, 1200.0, 1600.0])
    dchis = torch.full((nplane,), 400.0)
    out = TRT.multiplane_raytrace(torch.from_numpy(delta), chis, dchis,
                                  2000.0, 0.3, 0.05)
    born = TLens.born_convergence(torch.from_numpy(delta), chis, dchis,
                                  2000.0, 0.3)
    npt.assert_allclose(out["kappa"].numpy(), born.numpy(),
                        atol=2e-3 * float(born.abs().max()))


def test_multiplane_tomography_matches_jax_and_scalar_calls(rng):
    """An array of sources (one beyond, one inside the stack) against JAX's
    vmapped trace (rtol 1e-4 of each map's max), and each row against the
    scalar call."""
    nplane, npix = 5, 24
    delta = _planes(rng, nplane, npix, amp=2.0)
    chis = np.linspace(300.0, 1500.0, nplane).astype(np.float32)
    dchis = np.full(nplane, 300.0, np.float32)
    srcs = np.array([2000.0, 1000.0, 1500.0], np.float32)
    want = JRT.multiplane_raytrace(jnp.asarray(delta), jnp.asarray(chis),
                                   jnp.asarray(dchis), jnp.asarray(srcs),
                                   0.3, 0.05)
    args = (torch.from_numpy(delta), torch.from_numpy(chis),
            torch.from_numpy(dchis))
    got = TRT.multiplane_raytrace(*args, torch.from_numpy(srcs), 0.3, 0.05)
    kmax = np.abs(np.asarray(want["kappa"])).max()
    for name, w in want.items():
        w = np.asarray(w)
        assert got[name].shape == (3, npix, npix)
        scale = kmax if name == "omega" else np.abs(w).max()
        npt.assert_allclose(got[name].numpy(), w, atol=1e-4 * scale,
                            err_msg=name)
    for s, chi_s in enumerate(srcs):
        one = TRT.multiplane_raytrace(*args, float(chi_s), 0.3, 0.05)
        for name in one:
            npt.assert_allclose(got[name][s].numpy(), one[name].numpy(),
                                atol=1e-6 * max(1.0, float(
                                    one[name].abs().max())), err_msg=name)


# ------------------------------------------------------------ PM lightcone
def _pk_flat(amp):
    def pk(k):
        return amp * (torch.ones_like(k) if isinstance(k, torch.Tensor)
                      else jnp.ones_like(k))
    return pk


def _jax_lightcone_from_modes(dk, cosmo, ngrid, box, fov, npix, nplanes,
                              z_source, z_init, nsteps_init, steps_per_plane,
                              shifts):
    """The loop of the JAX `pm_lightcone_planes`, from explicit modes and
    shifts, out of the JAX package's public pieces."""
    chi_s = float(cosmo.comoving_distance(z_source))
    dchi = chi_s / nplanes
    chis = (np.arange(nplanes) + 0.5) * dchi
    z_planes = np.asarray(cosmo.redshift_at_comoving_distance(
        jnp.asarray(chis, jnp.float32)), np.float64)
    a_targets = 1.0 / (1.0 + z_planes[::-1])
    comps, mom = JN.lpt_catalog_from_modes(jnp.asarray(dk), ngrid, box,
                                           cosmo, z_init)
    a_now = 1.0 / (1.0 + z_init)
    planes = []
    for j in range(nplanes):
        a_t, chi_c = a_targets[j], chis[::-1][j]
        nst = nsteps_init if j == 0 else steps_per_plane
        comps, mom = JN.pm_evolve(comps, mom, cosmo, ngrid, box, a_now,
                                  float(a_t), nst)
        a_now = float(a_t)
        g = int(chi_c // box)
        oxy = ((0.5 * box + shifts[g, 0]) % box,
               (0.5 * box + shifts[g, 1]) % box)
        d, _ = JLP.density_planes_from_particles(
            comps, box, float(chi_c), dchi, 1, fov, npix, observer_xy=oxy)
        planes.append(np.asarray(d[0]))
    return np.stack(planes[::-1]), chis, dchi


@pytest.mark.parametrize("randomize", [False, True])
def test_pm_lightcone_from_modes_matches_jax(rng, randomize):
    """The same modes and observer shifts through both packages: 16^3
    particles, 6 planes of 32^2 pixels over several box depths. Two
    float32 PM runs from the same ICs drift apart by rounding: atol 2e-3
    of each plane's max |delta|."""
    n, box, fov, npix, nplanes = 16, 200.0, 0.05, 32, 6
    kw = {"Om0": 0.3, "h": 0.7}
    jc, tc = JCosmology(**kw), Cosmology(**kw)
    white = rng.standard_normal((n, n, n)).astype(np.float32)
    dk = np.array(JM.modes_from_white(jnp.asarray(white), n, box,
                                      _pk_flat(100.0)))
    n_groups = int(((nplanes - 0.5) / nplanes)
                   * float(tc.comoving_distance(0.4)) // box) + 1
    assert n_groups > 1
    shifts = (rng.uniform(0, box, (n_groups, 2)) if randomize
              else np.zeros((n_groups, 2)))
    want, chis_j, dchi_j = _jax_lightcone_from_modes(
        dk, jc, n, box, fov, npix, nplanes, 0.4, 9.0, 4, 1, shifts)
    got, chis_t, dchi_t = TN.pm_lightcone_planes_from_modes(
        torch.from_numpy(dk), tc, n, box, fov, npix, nplanes, z_source=0.4,
        z_init=9.0, nsteps_init=4, steps_per_plane=1,
        shifts=shifts if randomize else None)
    npt.assert_allclose(dchi_t, dchi_j, rtol=1e-5)
    npt.assert_allclose(chis_t.numpy(), chis_j, rtol=1e-5)
    assert got.shape == (nplanes, npix, npix)
    for i in range(nplanes):
        scale = np.abs(want[i]).max()
        assert scale > 0.5
        npt.assert_allclose(got[i].numpy(), want[i], atol=2e-3 * scale,
                            err_msg=f"plane {i}")


def test_pm_lightcone_planes_structure():
    cosmo = Cosmology(Om0=0.3, h=0.7)
    pk = _pk_flat(100.0)
    gen = torch.Generator().manual_seed(0)
    delta, chis, dchi = TN.pm_lightcone_planes(
        gen, cosmo, pk, 16, 200.0, 0.05, 32, 6, z_source=0.4, z_init=9.0,
        nsteps_init=4, steps_per_plane=1)
    assert delta.shape == (6, 32, 32)
    assert bool(torch.isfinite(delta).all())
    chi_s = float(cosmo.comoving_distance(0.4))
    assert abs(float(chis[-1]) - (5.5 / 6.0) * chi_s) < 1e-2 * chi_s
    assert abs(dchi * 6 - chi_s) < 1e-3 * chi_s
    # delta is a contrast: means small vs its fluctuations
    assert abs(float(delta.mean())) < 0.5 * float(delta.std())
    with pytest.raises(ValueError):
        TN.pm_lightcone_planes(gen, cosmo, pk, 16, 200.0, 0.05, 32, 4,
                               z_source=0.4, z_init=0.2)


def test_pm_lightcone_randomize_generator_moves_the_observer():
    """The randomize generator draws one shift per box repetition: the
    same seed gives the same planes, another seed other planes, and the
    nearest box depth (shift row 0 applies there too) differs from the
    fixed observer's."""
    cosmo = Cosmology(Om0=0.3, h=0.7)
    pk = _pk_flat(100.0)

    def run(seed):
        rgen = None if seed is None else torch.Generator().manual_seed(seed)
        return TN.pm_lightcone_planes(
            torch.Generator().manual_seed(3), cosmo, pk, 16, 200.0, 0.05,
            16, 6, z_source=0.4, z_init=9.0, nsteps_init=2,
            steps_per_plane=1, randomize_generator=rgen)[0]

    fixed, a, a2, b = run(None), run(7), run(7), run(8)
    assert torch.equal(a, a2)
    assert not torch.equal(a, b)
    assert not torch.equal(a, fixed)


def test_pm_lightcone_bad_arguments(tmp_path):
    cosmo = Cosmology(Om0=0.3, h=0.7)
    gen = torch.Generator().manual_seed(0)
    pk = _pk_flat(100.0)
    # ckpt_dir works: the call checkpoints every plane and returns the
    # planes of the same call without it
    args = (cosmo, pk, 8, 200.0, 0.05, 8, 6)
    got = TN.pm_lightcone_planes(torch.Generator().manual_seed(0), *args,
                                 z_source=0.4, nsteps_init=2,
                                 ckpt_dir=tmp_path / "lc")[0]
    want = TN.pm_lightcone_planes(torch.Generator().manual_seed(0), *args,
                                  z_source=0.4, nsteps_init=2)[0]
    assert torch.equal(got, want)
    assert (tmp_path / "lc" / "state.npz").exists()
    with pytest.raises(ValueError, match="order"):
        TN.pm_lightcone_planes(gen, *args, z_source=0.4, order=3)
    with pytest.raises(ValueError, match="exceeds the box"):
        TN.pm_lightcone_planes(gen, cosmo, pk, 8, 200.0, 0.05, 8, 2,
                               z_source=0.4)
    dk = np.zeros((8, 8, 8), np.complex64)
    with pytest.raises(ValueError, match="shifts must have shape"):
        TN.pm_lightcone_planes_from_modes(
            torch.from_numpy(dk), cosmo, 8, 200.0, 0.05, 8, 6, z_source=0.4,
            shifts=np.zeros((1, 2)))


def test_pm_lightcone_planes_checkpoint_resume(tmp_path, monkeypatch):
    """Port of tests/test_nbody.py::test_pm_lightcone_planes_checkpoint_
    resume: a call that crashes after its second save resumes at plane 2
    and returns the uninterrupted call's planes (bit for bit on the CPU:
    the restored state is the saved one, the JAX test's bar is 1e-4); a
    rerun of the finished checkpoint returns the stored stack. A resumed
    call leaves the generator in its entry state (it draws no modes),
    where a fresh call advances it; another schedule raises."""
    from astrild_tpu_torch.core import checkpoint as ckpt

    cosmo = Cosmology(Om0=0.3, h=0.7)
    pk = _pk_flat(100.0)
    rest = (cosmo, pk, 16, 200.0, 0.05, 32, 6)
    kw = dict(z_source=0.4, z_init=9.0, nsteps_init=4, steps_per_plane=1)

    def gen():
        return torch.Generator().manual_seed(0)

    ref, chis_ref, dchi_ref = TN.pm_lightcone_planes(gen(), *rest, **kw)
    d = tmp_path / "lc"
    real_save = ckpt.save_state
    calls = {"n": 0}

    def crashy(path, state, step=None):
        real_save(path, state, step=step)
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated crash")

    monkeypatch.setattr(ckpt, "save_state", crashy)
    with pytest.raises(RuntimeError, match="simulated crash"):
        TN.pm_lightcone_planes(gen(), *rest, ckpt_dir=d, **kw)
    monkeypatch.setattr(ckpt, "save_state", real_save)
    g = gen()
    entry = g.get_state()
    delta, chis, dchi = TN.pm_lightcone_planes(g, *rest, ckpt_dir=d, **kw)
    assert torch.equal(g.get_state(), entry)
    assert torch.equal(delta, ref)
    assert torch.equal(chis, chis_ref) and dchi == dchi_ref
    delta2, _, _ = TN.pm_lightcone_planes(gen(), *rest, ckpt_dir=d, **kw)
    assert torch.equal(delta2, delta)
    fresh = gen()
    TN.pm_lightcone_planes(fresh, *rest, ckpt_dir=tmp_path / "lc2", **kw)
    assert not torch.equal(fresh.get_state(), entry)
    with pytest.raises(ValueError, match="different schedule"):
        TN.pm_lightcone_planes(torch.Generator().manual_seed(1), *rest,
                               ckpt_dir=d, **kw)
    with pytest.raises(ValueError, match="different schedule"):
        TN.pm_lightcone_planes(gen(), *rest, ckpt_dir=d,
                               randomize_generator=gen(), **kw)


@pytest.mark.parametrize("ckpt_every", [1, 4])
def test_pm_lightcone_from_modes_checkpoint_resume(tmp_path, rng,
                                                   monkeypatch, ckpt_every):
    """The from-modes twin resumes too: its schedule records a hash of
    the modes and the shifts, so other modes raise; a crash after the
    first save resumes and returns the uninterrupted planes, with a save
    every plane or every 4 (and at the last)."""
    from astrild_tpu_torch.core import checkpoint as ckpt

    n, box = 16, 200.0
    cosmo = Cosmology(Om0=0.3, h=0.7)
    white = rng.standard_normal((n, n, n)).astype(np.float32)
    dk = np.array(JM.modes_from_white(jnp.asarray(white), n, box,
                                      _pk_flat(100.0)))
    n_groups = TN._lightcone_geometry(cosmo, box, 6, 0.4, 9.0, 2)[3]
    shifts = rng.uniform(0, box, (n_groups, 2))
    rest = (cosmo, n, box, 0.05, 32, 6)
    kw = dict(z_source=0.4, z_init=9.0, nsteps_init=4, steps_per_plane=1,
              shifts=shifts, device="cpu", ckpt_every=ckpt_every)
    ref = TN.pm_lightcone_planes_from_modes(dk, *rest, **kw)[0]
    d = tmp_path / "lc"
    real_save = ckpt.save_state

    def crashy(path, state, step=None):
        real_save(path, state, step=step)
        raise RuntimeError("simulated crash")

    monkeypatch.setattr(ckpt, "save_state", crashy)
    with pytest.raises(RuntimeError, match="simulated crash"):
        TN.pm_lightcone_planes_from_modes(dk, *rest, ckpt_dir=d, **kw)
    monkeypatch.setattr(ckpt, "save_state", real_save)
    assert ckpt.restore_state(
        d, (torch.zeros(n ** 3),) * 6 + (torch.zeros(6, 32, 32),),
        with_step=True)[1] == min(ckpt_every, 6)
    got = TN.pm_lightcone_planes_from_modes(dk, *rest, ckpt_dir=d, **kw)[0]
    assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="different schedule"):
        TN.pm_lightcone_planes_from_modes(dk * 1.01, *rest, ckpt_dir=d, **kw)


def test_pm_lightcone_born_cl_tracks_halofit():
    """The port's full forward model at the size of the JAX package's own
    C_ell test (64^3 particles, a few seconds in torch): Born kappa's
    C_ell over the halofit Limber prediction, bands 1-4 inside (0.55,
    1.45) and band 0 below 2 with the randomize generator."""
    from astrild_tpu_torch.ops import angular_power as TAP
    from astrild_tpu_torch.ops import linear_power as TL

    cosmo = Cosmology(Om0=0.3, h=0.7)
    amp = TL.normalization(cosmo)

    def pk(k):
        return TL.linear_power(k, cosmo, 0.0, amplitude=amp)

    box, npart, npix, fov, nplanes = 250.0, 64, 96, 0.08, 12
    chi_s = float(cosmo.comoving_distance(1.0))
    delta, chis, dchi = TN.pm_lightcone_planes(
        torch.Generator().manual_seed(4), cosmo, pk, npart, box, fov, npix,
        nplanes, z_source=1.0, z_init=9.0, nsteps_init=8, steps_per_plane=2,
        randomize_generator=torch.Generator().manual_seed(104))
    a_pl = torch.as_tensor(1.0 / (1.0 + cosmo.redshift_at_comoving_distance(
        chis.numpy())), dtype=torch.float32)
    kap = TLens.born_convergence(delta, chis, torch.full((nplanes,), dchi),
                                 chi_s, 0.3, scale_factors=a_pl)
    ell, cl = TAP.cl_flat_sky(kap, np.degrees(fov), nbins=10)
    th = TAP.cl_kappa_limber(ell, cosmo, 1.0, nonlinear=True)
    r = (cl / th).numpy()
    assert 0.55 < r[1:5].mean() < 1.45, r
    assert r[0] < 2.0, r
