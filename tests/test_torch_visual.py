"""The port's visual layer (astrild_tpu_torch.visual) against the JAX
package's on the CPU, on the Agg backend: each figure's artists carry the
same data (line xy data, image arrays, quiver vectors, figure sizes) for
the same input, tensors included; and the Maps facade grids the same
slab maps from the same point-set files."""
import os

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")
mpl = pytest.importorskip("matplotlib")
pytest.importorskip("h5py")
mpl.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

from astrild_tpu.io import columnar_h5 as jcol  # noqa: E402
from astrild_tpu.visual import Maps as JMaps  # noqa: E402
from astrild_tpu.visual import figures as JF  # noqa: E402

from astrild_tpu_torch.visual import Maps  # noqa: E402
from astrild_tpu_torch.visual import figures as TF  # noqa: E402


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _artists(fig):
    """Every axes' lines, images, quivers and collections as arrays."""
    out = {"size": tuple(fig.get_size_inches())}
    for i, ax in enumerate(fig.axes):
        out[f"{i}.lines"] = [np.asarray(ln.get_xydata())
                             for ln in ax.get_lines()]
        out[f"{i}.images"] = [np.asarray(im.get_array())
                              for im in ax.get_images()]
        out[f"{i}.clim"] = [im.get_clim() for im in ax.get_images()]
        quivers = [c for c in ax.collections
                   if isinstance(c, mpl.quiver.Quiver)]
        out[f"{i}.quiver"] = [(np.asarray(q.U), np.asarray(q.V),
                               np.asarray(q.get_offsets())) for q in quivers]
        out[f"{i}.paths"] = [p.vertices for c in ax.collections
                             if not isinstance(c, mpl.quiver.Quiver)
                             for p in c.get_paths()]
        out[f"{i}.labels"] = (ax.get_xlabel(), ax.get_ylabel(),
                              ax.get_title())
    plt.close(fig)
    return out


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = got[k], want[k]
        if k == "size" or k.endswith(("labels", "clim")):
            assert a == b, k
            continue
        assert len(a) == len(b), k
        for x, y in zip(a, b):
            if isinstance(x, tuple):
                for xi, yi in zip(x, y):
                    npt.assert_array_equal(np.ma.filled(xi, np.nan),
                                           np.ma.filled(yi, np.nan))
            else:
                npt.assert_array_equal(np.ma.filled(x, np.nan),
                                       np.ma.filled(y, np.nan), err_msg=k)


def test_figure_sizes_and_style_match_jax():
    assert TF.figure_size() == JF.figure_size()
    assert TF.figure_size(246.0, 0.5, 1.0) == JF.figure_size(246.0, 0.5, 1.0)
    for w in ("mnras", "mnras_double", "aa", 300.0):
        assert TF.set_size(w, (2, 1)) == JF.set_size(w, (2, 1))
    with pytest.raises(ValueError):
        TF.set_size("unknown-journal")
    assert TF.PUBLICATION_STYLE == JF.PUBLICATION_STYLE
    old = TF.use_publication_style()
    try:
        assert mpl.rcParams["xtick.direction"] == "in"
    finally:
        mpl.rcParams.update(old)


def test_map_and_spectra_figures_match_jax(tmp_path, rng):
    img = rng.normal(size=(32, 32)).astype(np.float32)
    _assert_same(_artists(TF.plot_map(_t(img), 10.0, title="k")),
                 _artists(JF.plot_map(img, 10.0, title="k")))
    _assert_same(_artists(TF.plot_map(img, symmetric=False, cmap="viridis")),
                 _artists(JF.plot_map(img, symmetric=False, cmap="viridis")))
    k = np.geomspace(0.01, 1.0, 16)
    pks = {"GR": 1e4 * k ** -1.5, "F5": 1.1e4 * k ** -1.5}
    _assert_same(
        _artists(TF.plot_power_spectra(_t(k), {n: _t(p) for n, p in
                                               pks.items()},
                                       theory=_t(9e3 * k ** -1.5))),
        _artists(JF.plot_power_spectra(k, pks, theory=9e3 * k ** -1.5)))
    m, n = np.geomspace(1e12, 1e15, 10), np.geomspace(1e3, 1, 10)
    _assert_same(_artists(TF.plot_halo_mass_function(_t(m), _t(n), 1e6)),
                 _artists(JF.plot_halo_mass_function(m, n, 1e6)))
    r = np.linspace(0.1, 3, 12)
    args = (r, np.linspace(-0.1, 0, 12), np.full(12, -0.12), np.full(12, 0.02))
    _assert_same(_artists(TF.plot_void_profiles(*[_t(a) for a in args])),
                 _artists(JF.plot_void_profiles(*args)))
    f = str(tmp_path / "pk.png")
    TF.plot_power_spectra(k, pks, fname=f)
    assert os.path.getsize(f) > 0


def test_velocity_and_dipole_figures_match_jax(tmp_path, rng):
    pos, vel = rng.uniform(0, 100, (200, 2)), rng.normal(0, 100, (200, 2))
    _assert_same(
        _artists(TF.plot_velocity_field(_t(pos), _t(vel), nbins=8,
                                        boxsize=100.0)),
        _artists(JF.plot_velocity_field(pos, vel, nbins=8, boxsize=100.0)))
    npix = 128
    img = rng.normal(0, 1e-7, (npix, npix))
    img[60:68, 60:68] += 1e-6
    cat = {"theta1_pix": np.array([64.0, 30.0]),
           "theta2_pix": np.array([64.0, 90.0]),
           "theta1_mtvel": np.array([300.0, -100.0]),
           "theta2_mtvel": np.array([0.0, 200.0])}
    tcat = {k: _t(v) for k, v in cat.items()}
    _assert_same(_artists(TF.plot_dipole_maps(tcat, _t(img), [0, 1])),
                 _artists(JF.plot_dipole_maps(cat, img, [0, 1])))
    for axis in (0, 1):
        _assert_same(
            _artists(TF.plot_dipole_cross_section(tcat, _t(img), 0,
                                                  axis=axis)),
            _artists(JF.plot_dipole_cross_section(cat, img, 0, axis=axis)))
    maps = [rng.normal(size=(16, 16)) for _ in range(2)]
    hp = [rng.uniform(0, 10, (50, 2)) for _ in range(2)]
    hv = [rng.normal(0, 300, (50, 2)) for _ in range(2)]
    _assert_same(
        _artists(TF.plot_maps_with_vel_field([_t(m) for m in maps],
                                             [_t(p) for p in hp], hv, 10.0,
                                             npix_vel=8, titles=["a", "b"])),
        _artists(JF.plot_maps_with_vel_field(maps, hp, hv, 10.0, npix_vel=8,
                                             titles=["a", "b"])))
    f = str(tmp_path / "dip.png")
    TF.plot_dipole_maps(cat, img, [0], fname=f)
    assert os.path.getsize(f) > 0


def test_analytic_dipole_maps_match_jax():
    """The patches come from each package's nfw_dipole_patch (the port's
    on the CPU here): the same images to float32 rounding."""
    m, v = [1e14, 5e14], [[300.0, 0.0], [0.0, -300.0]]
    got = _artists(TF.plot_analytic_dipole_maps(m, v, npix=16,
                                                device="cpu"))
    want = _artists(JF.plot_analytic_dipole_maps(m, v, npix=16))
    for i in (0, 1):
        a, b = got[f"{i}.images"][0], want[f"{i}.images"][0]
        npt.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
        assert got[f"{i}.labels"] == want[f"{i}.labels"]
    assert got["size"] == want["size"]


@pytest.fixture
def point_files(tmp_path):
    """tests/test_facade_misc.py::test_visual_maps_facade's two point-set
    files: an npix lattice at two z-slabs, kappa_2 = x."""
    npix = 16
    g = (np.arange(npix) + 0.5) / npix
    xx, yy = np.meshgrid(g, g, indexing="ij")
    for nr, zc in [(12, 0.5), (13, 0.9)]:
        jcol.write_table(str(tmp_path / f"Ray_maps_output{nr:05d}.h5"),
                         {"x": xx.ravel(), "y": yy.ravel(),
                          "z": np.full(npix * npix, zc),
                          "kappa_2": xx.ravel() + 0.1 * yy.ravel()})
    return tmp_path, npix


def test_maps_to_array_matches_jax(point_files):
    tmp_path, npix = point_files
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    m = Maps(boxsize=500.0, domain_level=npix, dir_sim=str(tmp_path),
             dir_out=str(tmp_path / "t"))
    jm = JMaps(boxsize=500.0, domain_level=npix, dir_sim=str(tmp_path),
               dir_out=str(tmp_path / "j"))
    assert list(m.file_nrs) == list(jm.file_nrs) == [12, 13]
    out = m.to_array(centre=0.5, depth=0.1, quantities=["kappa_2", "x"])
    want = jm.to_array(centre=0.5, depth=0.1, quantities=["kappa_2", "x"])
    assert sorted(out) == sorted(want) == [12, 13]
    for nr in out:
        for q in ("kappa_2", "x"):
            npt.assert_array_equal(out[nr][q], want[nr][q])
    g = (np.arange(npix) + 0.5) / npix
    npt.assert_allclose(out[12]["x"][0], g, atol=1e-12)
    npt.assert_allclose(out[13]["kappa_2"], 0.0)
    name = f"kappa_2_map_{m.name}_out00012.npy"
    npt.assert_array_equal(np.load(tmp_path / "t" / name),
                           np.load(tmp_path / "j" / name))
    # snap_nrs selection honored, and an empty selection raises
    assert list(Maps(domain_level=npix, dir_sim=str(tmp_path),
                     snap_nrs=[13]).file_nrs) == [13]
    with pytest.raises(ValueError):
        Maps(domain_level=npix, dir_sim=str(tmp_path), snap_nrs=[99])
