"""Frozen operation and byte counts of the program's kernels, and the
published peaks they are held against. A later change to a kernel may
not change these: the roofline share then moves only with the kernel's
time.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit:
3.35 TB/s of HBM3 and 67 TFLOP/s in float32 outside the tensor cores.
The run prints the card's power limit beside its numbers.

Bytes count each input read once and each output written once, whatever
the kernel reads again:
  K1 (csrc/deposit_sorted.cu, counts)   4 B a key read, 4 B a cell written;
  K2 (csrc/paint_windowed.cu, CIC)      12 B a particle read (x, y, z),
                                        4 B a mesh cell written.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def k1_bytes(n_keys: int, n_cells: int) -> int:
    return 4 * n_keys + 4 * n_cells


def k2_bytes(n_particles: int, n_cells: int) -> int:
    return 12 * n_particles + 4 * n_cells


def bound_seconds(n_bytes: float = 0.0, n_flops: float = 0.0) -> float:
    """The least time the card could take: the larger of the byte and the
    operation bound."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_F32_FLOPS)


def share_pct(bound_s: float, kernel_s: float, calls: int):
    """100 x bound / (device seconds per call); None without a reading."""
    if calls <= 0 or kernel_s <= 0.0:
        return None
    return 100.0 * bound_s / (kernel_s / calls)
