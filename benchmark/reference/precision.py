"""The arithmetic a reference runs in.

"float64" is the reference itself. "bfloat16" is the control: the same
reference computed one precision below the float32 the configurations
state, held in float32 tensors and rounded to bfloat16 after each step
(torch's FFTs take no bfloat16), so it stands where a later change that
dropped the program to bfloat16 would.
"""
from __future__ import annotations

import torch

__all__ = ["Precision", "PRECISIONS"]


class Precision:
    def __init__(self, name: str):
        if name not in ("float64", "bfloat16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.low = name == "bfloat16"
        self.dtype = torch.float32 if self.low else torch.float64
        self.cdtype = torch.complex64 if self.low else torch.complex128

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """x in this precision: cast to the working dtype and, for the
        control, rounded to bfloat16."""
        if x.is_complex():
            x = x.to(self.cdtype)
            if self.low:
                return torch.complex(self._round(x.real), self._round(x.imag))
            return x
        x = x.to(self.dtype)
        return self._round(x) if self.low else x

    @staticmethod
    def _round(x):
        return x.to(torch.bfloat16).to(torch.float32)


PRECISIONS = ("float64", "bfloat16")
