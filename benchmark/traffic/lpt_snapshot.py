"""The traffic generator of every cell so far: one 2LPT particle snapshot
per run, drawn from `--seed`.

A traffic mix is a data file `traffic/<mix>.json` that names this
generator (`"generator": "lpt_snapshot"`) and holds its parameters:

  n_side     particles per side (n_side^3 in all)
  boxsize    comoving box side [Mpc/h]
  z          redshift of the snapshot (0: the analysed snapshot; 9: the
             initial conditions of a simulation)
  order      1 (Zel'dovich) or 2 (2LPT)
  momenta    also return the canonical momenta p = a^2 dx/dt
  cosmology  Om0, Ob0, h, ns, sigma8, Tcmb of the linear power (EH98)

The same arrays go to the program and to the reference.
"""
from __future__ import annotations

from benchmark.reference.lpt import lpt_particles

__all__ = ["generate"]


def generate(params: dict, seed: int, device) -> dict:
    """{"pos": (3, n^3) float32, "mom": (3, n^3) float32 or None} on
    `device`, positions in [0, boxsize]."""
    pos, mom = lpt_particles(seed, int(params["n_side"]),
                             float(params["boxsize"]), params["cosmology"],
                             float(params["z"]), order=int(params["order"]),
                             momenta=bool(params.get("momenta", False)),
                             device=device)
    return {"pos": pos, "mom": mom}
