"""Where the port's entry points put numpy input: on `device`, by default
the CUDA card, raising without one (astrild_tpu_torch/_device.py); a
tensor keeps its device. One case for each entry point that once turned
its input into a tensor with a bare `torch.as_tensor` (and so ran numpy
input on the CPU unasked): `nbody.pm_evolve`,
`nbody.lpt_catalog_from_modes`, `mocks.modes_from_white`,
`density_split.density_at_points`, `density_split.counts_in_cells_moments`,
`tpcf.tpcf_multipoles`, `profiles3d.stacked_profile`, `profiles3d.fit_nfw`,
`binred.masked_bin_reduce`, `paint.paint` (a tuple of components) and
`healpix_torch.ang2pix_ring`; and one for each public entry point of the
spin-1 transforms, the tensor HEALPix stencil, the spherical ray trace and
CMB lensing.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from astrild_tpu_torch.ops import binred as TB  # noqa: E402
from astrild_tpu_torch.ops import cmb_lensing as TCL  # noqa: E402
from astrild_tpu_torch.ops import density_split as TDS  # noqa: E402
from astrild_tpu_torch.ops import mocks as TM  # noqa: E402
from astrild_tpu_torch.ops import lightcone_sphere as TLS  # noqa: E402
from astrild_tpu_torch.ops import nbody as TN  # noqa: E402
from astrild_tpu_torch.ops import paint as TPA  # noqa: E402
from astrild_tpu_torch.ops import profiles3d as TPR  # noqa: E402
from astrild_tpu_torch.ops import sht_spin as TSS  # noqa: E402
from astrild_tpu_torch.ops import sht_spin_large as TSL  # noqa: E402
from astrild_tpu_torch.ops import tpcf as TT  # noqa: E402
from astrild_tpu_torch.utils import healpix_torch as THT  # noqa: E402
from astrild_tpu_torch.utils.cosmology import Cosmology  # noqa: E402

N, BOX = 8, 50.0


def _modes():
    rng = np.random.default_rng(0)
    white = rng.standard_normal((N, N, N)).astype(np.float32)
    return TM.modes_from_white(torch.from_numpy(white), N, BOX,
                               lambda k: 50.0 * torch.ones_like(k)).numpy()


def _catalog():
    comps, mom = TN.lpt_catalog_from_modes(torch.from_numpy(_modes()), N,
                                           BOX, Cosmology(), 9.0)
    return [c.numpy() for c in comps], [p.numpy() for p in mom]


def _outputs(res):
    """The tensors of a result (tuples, lists and dicts flattened)."""
    if isinstance(res, torch.Tensor):
        return [res]
    if isinstance(res, dict):
        res = list(res.values())
    out = []
    for r in res:
        out += _outputs(r)
    return out


def _cases():
    rng = np.random.default_rng(1)
    r = np.geomspace(0.1, 2.0, 12).astype(np.float32)
    rho = (100.0 / (r / 0.5 * (1 + r / 0.5) ** 2))[None, :].astype(
        np.float32)
    prof = rng.uniform(0.5, 1.5, (5, 10)).astype(np.float32)
    counts = rng.integers(1, 20, (5, 10)).astype(np.float32)
    chans = rng.standard_normal((2, 1000)).astype(np.float32)
    binidx = rng.integers(0, 9, 1000)
    field = rng.standard_normal((N, N, N)).astype(np.float32)
    pts = rng.uniform(0, BOX, (50, 3)).astype(np.float32)
    return {
        "pm_evolve": (lambda *a, **k: TN.pm_evolve(
            *a, Cosmology(), N, BOX, 0.1, 0.2, 1, **k), lambda: _catalog()),
        "lpt_catalog_from_modes": (lambda dk, **k: TN.lpt_catalog_from_modes(
            dk, N, BOX, Cosmology(), 9.0, **k), lambda: (_modes(),)),
        "modes_from_white": (lambda w, **k: TM.modes_from_white(
            w, N, BOX, lambda q: torch.ones_like(q), **k),
            lambda: (rng.standard_normal((N, N, N)).astype(np.float32),)),
        "density_at_points": (lambda f, p, **k: TDS.density_at_points(
            f, BOX, p, **k), lambda: (field, pts)),
        "counts_in_cells_moments": (TDS.counts_in_cells_moments,
                                    lambda: (counts,)),
        "tpcf_multipoles": (lambda x, **k: TT.tpcf_multipoles(x, 2, **k),
                            lambda: (prof,)),
        "stacked_profile": (TPR.stacked_profile, lambda: (prof, counts)),
        "fit_nfw": (TPR.fit_nfw, lambda: (r, rho)),
        "masked_bin_reduce": (lambda c, b, **k: TB.masked_bin_reduce(
            c, b, 8, **k), lambda: (chans, binidx)),
        "paint": (lambda c, **k: TPA.paint(c, N, BOX, window="cic",
                                           deposit="scatter", **k),
                  lambda: (tuple(pts.T.copy()),)),
        **_sky_cases(rng),
    }


def _sky_cases(rng):
    """The full-sky slice: the spin-1 transforms, the HEALPix stencil, the
    spherical ray trace and CMB lensing, at nside 4 and 8x8 patches."""
    nside, lmax, npix, n = 4, 8, 192, 8
    theta = np.arccos(rng.uniform(-1, 1, 20)).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, 20).astype(np.float32)
    hmap = rng.standard_normal(npix).astype(np.float32)
    alm = np.tril(rng.standard_normal((lmax + 1, lmax + 1))).astype(
        np.float32)
    cl = np.linspace(1e-10, 1e-12, 3001)
    patch = rng.standard_normal((n, n)).astype(np.float32)
    oa = np.deg2rad(2.0)
    return {
        "ang2pix_ring": (lambda t, p, **k: THT.ang2pix_ring(nside, t, p, **k),
                         lambda: (theta, phi)),
        "pix2ang_ring": (lambda i, **k: THT.pix2ang_ring(nside, i, **k),
                         lambda: (np.arange(npix),)),
        "get_interp_weights": (
            lambda t, p, **k: THT.get_interp_weights(nside, t, p, **k),
            lambda: (theta, phi)),
        "get_interp_val": (THT.get_interp_val, lambda: (hmap, theta, phi)),
        "remap_by_deflection": (
            lambda m, a, b, **k: THT.remap_by_deflection(m, a, b, nside,
                                                         **k),
            lambda: (hmap, 1e-3 * hmap, 1e-3 * hmap)),
        "synthesize_spin1": (
            lambda a, b, **k: TSS.synthesize_spin1(a, b, a, b, nside, lmax,
                                                   **k),
            lambda: (alm, alm * 0.5)),
        "analyze_spin1": (lambda a, b, **k: TSS.analyze_spin1(
            a, b, nside, lmax, niter=1, **k), lambda: (hmap, hmap * 0.5)),
        "deflection_from_kappa_alm": (
            lambda a, b, **k: TSS.deflection_from_kappa_alm(a, b, nside,
                                                            lmax, **k),
            lambda: (alm, alm * 0.5)),
        "kappa_omega_alm_from_deflection": (
            lambda a, b, **k: TSS.kappa_omega_alm_from_deflection(
                a, b, nside, lmax, niter=1, **k), lambda: (hmap, hmap)),
        "synthesize_spin1_large": (
            lambda a, b, **k: TSL.synthesize_spin1_large(a, b, a, b, nside,
                                                         lmax, **k),
            lambda: (alm, alm * 0.5)),
        "analyze_spin1_large": (lambda a, b, **k: TSL.analyze_spin1_large(
            a, b, nside, lmax, niter=1, **k), lambda: (hmap, hmap * 0.5)),
        "deflection_from_kappa_alm_large": (
            lambda a, b, **k: TSL.deflection_from_kappa_alm_large(
                a, b, nside, lmax, **k), lambda: (alm, alm * 0.5)),
        "multiplane_raytrace_healpix": (
            lambda d, **k: TLS.multiplane_raytrace_healpix(
                d, [300.0], [100.0], 500.0, 0.3, lmax=lmax, **k),
            lambda: (0.1 * hmap[None, :],)),
        "lens_cmb_map_flat": (lambda t, **k: TCL.lens_cmb_map_flat(
            t, 1e-3 * t, oa, **k), lambda: (patch,)),
        "qe_tt_response": (lambda c, **k: TCL.qe_tt_response(
            n, oa, c, lmax_filter=1500, **k), lambda: (cl,)),
        "qe_tt_n0_kappa": (lambda c, **k: TCL.qe_tt_n0_kappa(
            n, oa, c, lmax_filter=1500, **k), lambda: (cl,)),
        "qe_tt_kappa": (lambda t, **k: TCL.qe_tt_kappa(
            t, oa, cl, lmax_filter=1500, **k), lambda: (patch,)),
        "qe_eb_kappa": (lambda q, u, **k: TCL.qe_eb_kappa(
            q, u, oa, cl, lmax_filter=1500, **k), lambda: (patch, patch.T)),
        "qe_tt_kappa_healpix": (lambda t, **k: TCL.qe_tt_kappa_healpix(
            t, cl[:9], lmax_filter=lmax, **k), lambda: (hmap,)),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_numpy_input_placement(name):
    fn, make = _cases()[name]
    args = make()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(*args)
    for t in _outputs(fn(*args, device="cpu")):
        assert t.device.type == "cpu"
    tensors = [tuple(torch.from_numpy(np.asarray(c)) for c in a)
               if isinstance(a, (list, tuple)) else torch.from_numpy(a)
               for a in args]
    for t in _outputs(fn(*tensors)):
        assert t.device.type == "cpu"
