"""Array-first containers: 3D grids and flat-sky 2D maps.

Port of astrild_tpu/core/grid.py: frozen dataclasses over tensors. A
checkpoint (core/checkpoint.py) flattens them in the JAX package's pytree
order: a `Grid3D` as its `values`, a `SkyGrid` as its layers by sorted
name; the rest (box size, field of view, quantity) is static.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

__all__ = ["Grid3D", "SkyGrid"]


@dataclasses.dataclass(frozen=True)
class Grid3D:
    """A periodic cubic grid with physical boxsize [Mpc/h]."""

    values: torch.Tensor  # (n, n, n)
    boxsize: float        # Mpc/h (static)

    @property
    def ngrid(self) -> int:
        return self.values.shape[-1]

    @property
    def cell_size(self) -> float:
        return self.boxsize / self.ngrid

    def density_contrast(self) -> "Grid3D":
        mean = self.values.mean()
        # divide by a tensor: a Python-scalar divisor is a product by its
        # reciprocal on the card
        mean = torch.where(mean == 0, torch.ones_like(mean), mean)
        return Grid3D(self.values / mean - 1.0, self.boxsize)


@dataclasses.dataclass(frozen=True)
class SkyGrid:
    """Flat-sky square map stack: named layers over a field of view.

    `data` maps layer name -> (npix, npix) tensor, like SkyArray's data{}
    dict of images.
    """

    data: Dict[str, torch.Tensor]
    opening_angle: float  # field of view, degrees (static)
    quantity: str = "kappa_2"  # primary layer semantic (static)

    @property
    def npix(self) -> int:
        return next(iter(self.data.values())).shape[-1]

    @property
    def pixel_arcmin(self) -> float:
        return self.opening_angle * 60.0 / self.npix

    def layer(self, name: str = "orig") -> torch.Tensor:
        return self.data[name]

    def with_layer(self, name: str, values: torch.Tensor) -> "SkyGrid":
        new = dict(self.data)
        new[name] = values
        return SkyGrid(new, self.opening_angle, self.quantity)
