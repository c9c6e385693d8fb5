"""3D grid vector calculus on torch tensors.

Port of astrild_tpu/ops/map_transform.py (`divergence` so far).
"""
from __future__ import annotations

import torch

__all__ = ["divergence"]


def divergence(vec_field, spacing=1.0):
    """div v of a (3, n, n, n) vector field.

    Each derivative is `jnp.gradient`'s: second-order central differences
    inside, first-order one-sided differences at the two edges
    (`torch.gradient(..., edge_order=1)`).
    """
    return sum(torch.gradient(vec_field[i], spacing=spacing, dim=i,
                              edge_order=1)[0]
               for i in range(3))
