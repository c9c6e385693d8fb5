"""Where the port puts input that is not a tensor yet.

The JAX package computes on the default device, so the port's entry points
put numpy input on the CUDA card unless the caller names a `device`; with
no card and no `device` they raise rather than run on the CPU unasked.
Tensors stay on their own device unless `device` is given.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["default_device", "as_tensor", "as_theory_tensor", "as_points",
           "as_x32", "as_host"]


def default_device(device=None) -> torch.device:
    """Where numpy input goes: `device` if given, else the CUDA card;
    raises if neither is there (no silent CPU run)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("astrild_tpu_torch facades run numpy input on the "
                           "CUDA card by default, and no card is available; "
                           "pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def as_tensor(arr, device=None) -> torch.Tensor:
    """A tensor of `arr`: float input as float32 (the JAX package's
    jnp.asarray without x64), on `device` if given, else where a tensor
    already lies (numpy input: the CUDA card, see `default_device`)."""
    if not isinstance(arr, torch.Tensor):
        device = default_device(device)
    if isinstance(arr, np.ndarray) and not arr.flags.writeable:
        arr = arr.copy()
    t = torch.as_tensor(arr)
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t if device is None else t.to(device)


def as_theory_tensor(arr, device=None) -> torch.Tensor:
    """`as_tensor` for the theory chain (FFTLog, the halo model, the n(z)
    and shear transforms, the forecasts): placed the same way, and numpy
    input arrives as float32 the same way, but a float64 tensor keeps its
    dtype, so a caller that hands float64 (a forecast's mean model) gets a
    float64 computation."""
    if isinstance(arr, torch.Tensor) and arr.dtype == torch.float64:
        return arr if device is None else arr.to(device)
    return as_tensor(arr, device)


def as_points(pos, device=None):
    """Positions as tensors: an (n, 3) array, or a tuple of flat (x, y, z)
    components kept as a tuple; placed as `as_tensor` places them (the
    components follow the first one's device)."""
    if isinstance(pos, (tuple, list)):
        first = as_tensor(pos[0], device)
        return tuple([first] + [as_tensor(c, first.device) for c in pos[1:]])
    return as_tensor(pos, device)


# what jnp.asarray makes of 64-bit integer and complex input with x64 off
_X32 = {torch.int64: torch.int32, torch.complex128: torch.complex64}


def as_x32(arr, device=None) -> torch.Tensor:
    """`as_tensor` with the JAX package's jnp.asarray dtypes (x64 off) for
    the rest too: int64 as int32, complex128 as complex64."""
    t = as_tensor(arr, device)
    return t.to(_X32.get(t.dtype, t.dtype))


def as_host(x, dtype=None) -> np.ndarray:
    """A numpy array of `x`: a tensor's values copied to the host (its
    dtype kept unless `dtype` is given), anything else as np.asarray
    gives it."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)
