"""Driver of the pm_forward configuration: whole KDK particle-mesh
simulations from one set of initial conditions, back to back.

Entry: `astrild_tpu_torch.ops.nbody.pm_evolve(comps, mom, cosmo, ngrid,
boxsize, a_init, a_final, nsteps)` with CIC and log-a steps in GR, which
copies the particles and returns the evolved (positions, momenta). The
last simulation's outputs are kept whole; of every simulation, the
positions of a sample of particles drawn from the seed.

The check (after the window, the program's state freed), against the
float64 reference run from the same initial conditions:
  pos_rms_gap   rms over particles of the periodic position gap [Mpc/h];
  pos_max_gap   the largest periodic position gap of any particle, and of
                the sampled particles in every simulation [Mpc/h];
  mom_rms_gap   rms momentum gap over the reference's rms momentum.
A simulation whose sampled particles pass the pos_max_gap limit is a
failed one.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference import pm_ref
from benchmark.reference.precision import Precision

_SAMPLE = 4096


class Driver:
    def __init__(self, config: dict, traffic: dict, workload: dict, inputs,
                 device, seed: int = 0):
        from astrild_tpu_torch.utils.cosmology import Cosmology

        if float(traffic["z"]) != float(config["z_init"]):
            raise ValueError("the traffic's snapshot is not at the "
                             "configuration's z_init")
        self.cfg = config
        self.n_side = int(traffic["n_side"])
        self.box = float(traffic["boxsize"])
        self.ngrid = self.n_side // int(config["particles_per_cell_side"])
        self.pos = inputs["pos"]
        self.mom = inputs["mom"]
        c = config["cosmology"]
        self.om0 = float(c["Om0"])
        self.cosmo = Cosmology(**c)
        self.a_init = 1.0 / (1.0 + float(config["z_init"]))
        self.a_final = 1.0 / (1.0 + float(config["z_final"]))
        self.nsteps = int(config["nsteps"])
        gen = torch.Generator(device="cpu")
        gen.manual_seed(int(seed) % (1 << 63))
        self.sample = torch.randint(0, self.n_side ** 3, (_SAMPLE,),
                                    generator=gen).to(self.pos.device)
        self.samples = []
        self.last = None

    def unit(self):
        from astrild_tpu_torch.ops import nbody

        return nbody.pm_evolve(tuple(self.pos), tuple(self.mom), self.cosmo,
                               self.ngrid, self.box, self.a_init,
                               self.a_final, self.nsteps,
                               window=self.cfg["window"],
                               spacing=self.cfg["spacing"])

    def keep(self, outputs):
        comps, mom = outputs
        self.samples.append(torch.stack([c[self.sample] for c in comps]))
        self.last = (comps, mom)

    def facts(self) -> dict:
        return {"n_part": self.n_side ** 3,
                "k2_particles": self.n_side ** 3,
                "k2_cells": self.ngrid ** 3,
                "force_evals_per_unit": self.nsteps + 1}

    def counters(self) -> dict:
        from astrild_tpu_torch.ops import paint_cuda

        return dict(paint_cuda.LAUNCHES)

    def release(self):
        pass

    # ------------------------------------------------------- the check
    def reference(self, prec: Precision):
        return pm_ref.evolve(self.pos, self.mom, self.om0, self.ngrid,
                             self.box, self.a_init, self.a_final,
                             self.nsteps, prec)

    def control_unit(self):
        """The reference one precision below the configuration's, in the
        program's place: outputs in the program's layout."""
        x, p = self.reference(Precision("bfloat16"))
        return tuple(x.float()), tuple(p.float())

    def _gap(self, a, b):
        d = torch.remainder(a.double() - b + 0.5 * self.box,
                            self.box) - 0.5 * self.box
        return (d * d).sum(0)

    def check(self, limits: dict):
        x_r, p_r = self.reference(Precision("float64"))
        comps, mom = self.last
        x = torch.stack(comps)
        gap2 = self._gap(x, x_r)
        del x
        pos_rms = float(torch.sqrt(gap2.mean()))
        pos_max = float(torch.sqrt(gap2.max()))
        del gap2
        dp2 = ((torch.stack(mom).double() - p_r) ** 2).sum(0)
        mom_rms = float(torch.sqrt(dp2.mean() / (p_r ** 2).sum(0).mean()))
        del dp2
        x_s = x_r[:, self.sample]
        per_sim = [math.sqrt(float(self._gap(s, x_s).max()))
                   for s in self.samples]
        failed = sum(1 for g in per_sim if not g <= limits["pos_max_gap"])
        checks = [("pos_rms_gap", pos_rms, limits["pos_rms_gap"]),
                  ("pos_max_gap", max([pos_max] + per_sim),
                   limits["pos_max_gap"]),
                  ("mom_rms_gap", mom_rms, limits["mom_rms_gap"])]
        return checks, failed
