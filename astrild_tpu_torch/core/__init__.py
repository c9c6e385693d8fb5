"""Containers of the port (the ported part of astrild_tpu/core)."""
from .dataset import Dataset

__all__ = ["Dataset"]
