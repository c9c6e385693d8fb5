"""astrild_tpu_torch: the PyTorch/CUDA port of astrild_tpu.

Modules mirror the JAX package's layout and names
(`astrild_tpu_torch.ops.power` <-> `astrild_tpu.ops.power`, ...). The port
imports torch and numpy only, never JAX. Its hand-written CUDA kernels live
in `csrc/` and are built at first use (see `_ext.py`).
"""
