"""Driver of the z0_suite configuration: the program's four-stage z=0
analysis suite on one particle snapshot, a pass at a time.

Entry: `astrild_tpu_torch.suite.make_stages(...)`, then `run(pos_flat)`,
which returns (P(k), B, kappa, gamma1, gamma2, void radii) on the card.
A pass's outputs are all the check needs: P(k), B and the void radii of
every pass in the window are kept (a few hundred numbers each), the maps
of the last pass.

The check (after the window, the program's state freed):
  pk_gap        max over shells |P - P_ref| / (|P_ref| + V/N);
  bk_gap        max over closed triples |B - B_ref| / max |B_ref|, and
                infinite where one side is NaN and the other is not;
  kappa_gap     max |kappa - kappa_ref| / max |kappa_ref|;
  gamma_gap     the same over gamma1 and gamma2;
  void_mismatch the void radii of a pass that the reference's catalog,
                found on the program's own kappa map, does not hold, plus
                those of the reference that the pass does not hold (radii
                paired one to one within 1e-5 of their size): the peak
                finder and the tunnels finder. The map itself is held by
                kappa_gap. (Against the voids of the reference's own
                float64 map the catalogs differ on some seeds by rounding
                alone: both keep the 2048 highest of several thousand
                peaks, spaced ~1e-5 apart at the cut, while the program's
                float32 keys move kappa by ~1e-4; PERF.md gives the
                readings.)
pk_gap, bk_gap and void_mismatch are taken over every pass (the worst
counts); a pass past any of their limits is a failed one.
"""
from __future__ import annotations

import torch

from benchmark.reference import suite_ref
from benchmark.reference.precision import Precision


def radii_mismatch(rad, ref, rtol: float = 1e-5) -> int:
    """Radii of `rad` with no partner in `ref`, plus those of `ref` with
    none in `rad`: both sorted, zero padding dropped, and paired one to
    one where they agree within rtol of their size."""
    a = sorted(float(r) for r in rad.double().cpu() if r > 0)
    b = sorted(float(r) for r in ref.double().cpu() if r > 0)
    i = j = matched = 0
    while i < len(a) and j < len(b):
        if abs(a[i] - b[j]) <= rtol * max(a[i], b[j]):
            matched += 1
            i += 1
            j += 1
        elif a[i] < b[j]:
            i += 1
        else:
            j += 1
    return len(a) + len(b) - 2 * matched


class Driver:
    def __init__(self, config: dict, traffic: dict, workload: dict, inputs,
                 device, seed: int = 0):
        from astrild_tpu_torch import suite

        self.cfg = config
        self.n_side = int(traffic["n_side"])
        self.box = float(traffic["boxsize"])
        self.ngrid = int(config["ngrid"])
        self.pos = inputs["pos"]
        self.pos_flat = self.pos.reshape(-1)
        self.run = suite.make_stages(self.n_side, self.ngrid,
                                     int(config["map_npix"]), self.box,
                                     int(config["nplanes"]), device)
        self.small = []  # (pk, b, rad) of each pass
        self.maps = None

    def unit(self):
        return self.run(self.pos_flat)

    def staged_unit(self, sync):
        """One pass stage by stage, a device sync after each:
        {stage: seconds}."""
        import time

        st = self.run.stages
        out = {}
        t0 = time.perf_counter()
        grid, _ = st["matter"](self.pos_flat)
        sync()
        t1 = time.perf_counter()
        out["matter"] = t1 - t0
        st["bispectrum"](grid)
        sync()
        t2 = time.perf_counter()
        out["bispectrum"] = t2 - t1
        kappa, _, _ = st["lensing"](grid)
        sync()
        t3 = time.perf_counter()
        out["lensing"] = t3 - t2
        st["voids"](kappa)
        sync()
        out["voids"] = time.perf_counter() - t3
        return out

    def keep(self, outputs):
        pk, b, kappa, g1, g2, rad = outputs
        self.small.append((pk, b, rad))
        self.maps = (kappa, g1, g2)

    def facts(self) -> dict:
        ff = int(self.cfg["fine_factor"])
        return {"n_part": self.n_side ** 3,
                "k1_keys": self.n_side ** 3,
                "k1_cells": (ff * self.ngrid) ** 3}

    def counters(self) -> dict:
        from astrild_tpu_torch.ops import paint_cuda

        return dict(paint_cuda.LAUNCHES)

    def release(self):
        self.run = None

    # ------------------------------------------------------- the check
    def reference(self, prec: Precision):
        c = self.cfg
        pk, grid = suite_ref.matter(self.pos, self.ngrid, self.box,
                                    int(c["pk_bins"]), int(c["fine_factor"]),
                                    prec)
        b = suite_ref.bispectrum(grid, self.box, int(c["bispec_bins"]),
                                 float(c["bispec_m_min"]),
                                 float(c["bispec_m_max"]), prec)
        kappa, g1, g2 = suite_ref.lensing(
            grid, int(c["nplanes"]), int(c["map_npix"]), float(c["chi_near"]),
            float(c["chi_far"]), float(c["chi_source"]),
            float(c["omega_m"]), self.box, float(c["opening_angle_rad"]),
            int(c["shear_padding"]), prec)
        return pk, b, kappa, g1, g2

    def voids_of(self, kappa, prec: Precision):
        c = self.cfg
        return suite_ref.find_voids(
            kappa, int(c["max_peaks"]), int(c["peak_edge_pix"]),
            float(c["peak_threshold_sigma"]), int(c["max_voids"]),
            float(c["void_overlap"]), float(c["void_min_radius"]), prec)

    def control_unit(self):
        """The reference one precision below the configuration's, in the
        program's place: outputs in the program's layout."""
        prec = Precision("bfloat16")
        pk, b, kappa, g1, g2 = self.reference(prec)
        rad = self.voids_of(kappa, prec)
        return pk, b, kappa, g1, g2, rad

    def check(self, limits: dict):
        """([(name, value, limit)], failed passes)."""
        prec = Precision("float64")
        pk_r, b_r, kappa_r, g1_r, g2_r = self.reference(prec)
        shot = self.box ** 3 / self.n_side ** 3
        pk_r = pk_r.double().cpu()
        b_r = b_r.double().cpu()
        closed = ~torch.isnan(b_r)
        b_scale = b_r[closed].abs().max()

        def pk_gap(pk):
            return float(((pk.double().cpu() - pk_r).abs()
                          / (pk_r.abs() + shot)).max())

        def bk_gap(b):
            b = b.double().cpu()
            if not torch.equal(torch.isnan(b), ~closed):
                return float("inf")
            return float((b[closed] - b_r[closed]).abs().max() / b_scale)

        kappa, g1, g2 = self.maps
        rad_r = self.voids_of(kappa, prec)

        def map_gap(m, ref):
            return float((m.double() - ref).abs().max() / ref.abs().max())

        per_pass = [(pk_gap(pk), bk_gap(b), radii_mismatch(rad, rad_r))
                    for pk, b, rad in self.small]
        names = ("pk_gap", "bk_gap", "void_mismatch")
        failed = sum(1 for row in per_pass
                     if any(not v <= limits[n] for n, v in zip(names, row)))
        worst = [max(row[i] for row in per_pass) for i in range(len(names))]
        checks = [(n, w, limits[n]) for n, w in zip(names, worst)]
        checks.append(("kappa_gap", map_gap(kappa, kappa_r),
                       limits["kappa_gap"]))
        checks.append(("gamma_gap", max(map_gap(g1, g1_r), map_gap(g2, g2_r)),
                       limits["gamma_gap"]))
        return checks, failed
