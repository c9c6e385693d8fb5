"""Struct-of-arrays catalog container (halos, voids, peaks, dipoles).

Port of astrild_tpu/core/catalog.py: a frozen dict of same-length
tensors. Columns made from arrays take the JAX package's jnp.asarray
dtypes (x64 off: float64 as float32, int64 as int32) and go to the CUDA
card unless `device` says otherwise; tensors keep their device. A
checkpoint flattens a catalog's columns by sorted name, as the JAX
package's pytree does. Host-side conversion to and from pandas lives here
(pandas is imported inside `to_dataframe`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .._device import as_x32

__all__ = ["Catalog"]


@dataclasses.dataclass(frozen=True)
class Catalog:
    """Columnar catalog: name -> (n,) or (n, d) tensor."""

    columns: Dict[str, torch.Tensor]

    def __len__(self) -> int:
        return int(next(iter(self.columns.values())).shape[0])

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.columns[key]

    def __contains__(self, key: str) -> bool:
        return key in self.columns

    @property
    def names(self):
        return tuple(sorted(self.columns))

    def with_column(self, name: str, values, device=None) -> "Catalog":
        """A copy with column `name` set; array input goes to `device`,
        by default the card."""
        new = dict(self.columns)
        new[name] = as_x32(values, device)
        return Catalog(new)

    def select(self, mask_or_idx) -> "Catalog":
        """Row selection by a boolean mask or integer indices (numpy or a
        tensor)."""
        def index(v):
            sel = mask_or_idx
            if isinstance(sel, np.ndarray):
                sel = torch.from_numpy(sel).to(v.device)
            return v[sel]

        return Catalog({k: index(v) for k, v in self.columns.items()})

    def positions(self, keys=("x", "y", "z")) -> torch.Tensor:
        return torch.stack([self.columns[k] for k in keys], dim=-1)

    @classmethod
    def from_dict(cls, d, device=None) -> "Catalog":
        return cls({k: as_x32(v, device) for k, v in d.items()})

    @classmethod
    def from_dataframe(cls, df, device=None) -> "Catalog":
        return cls({str(k): as_x32(np.asarray(df[k]), device)
                    for k in df.columns})

    def to_dataframe(self):
        import pandas as pd

        cols = {}
        for k, v in self.columns.items():
            arr = v.detach().cpu().numpy()
            if arr.ndim == 1:
                cols[k] = arr
            else:
                for i in range(arr.shape[1]):
                    cols[f"{k}_{i}"] = arr[:, i]
        return pd.DataFrame(cols)
