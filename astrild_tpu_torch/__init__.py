"""astrild_tpu_torch: the PyTorch/CUDA port of astrild_tpu.

Modules mirror the JAX package's layout and names
(`astrild_tpu_torch.ops.power` <-> `astrild_tpu.ops.power`, ...). The port
imports torch and numpy only, never JAX. Its hand-written CUDA kernels live
in `csrc/` and are built at first use (see `_ext.py`).

`Cosmology` is exported here, as the JAX package exports its own.
"""
from .utils.cosmology import Cosmology

__all__ = ["Cosmology"]


def __getattr__(name):
    # lazy PLANCK18 (PEP 562): its tables are built on first use, not when
    # the package is imported
    if name == "PLANCK18":
        from . import utils

        return utils.PLANCK18
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
