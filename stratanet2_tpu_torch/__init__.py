"""stratanet2_tpu_torch — the PyTorch/CUDA port of stratanet2_tpu for NVIDIA
Hopper (H100).

The JAX package `stratanet2_tpu` stays beside this one as the reference the
port is tested against. This package imports `torch` and numpy — never `jax`
nor anything of `stratanet2_tpu` — and keeps its own copies of what it needs
(config, channel plan, binning arithmetic, the host data layer, metrics and
the run plumbing). pandas, matplotlib and sklearn are imported only inside
the functions that use them (reading a ground-truth CSV, the analytics
frames, figures).

Every Pallas kernel on a ported path is a CUDA C++ kernel under `ops/csrc/`,
compiled for sm_90a at first use (`ops/_build.py`). Each kernel's wrapper in
`ops/cuda_kernels.py` launches it for CUDA tensors and runs its plain PyTorch
version for CPU tensors; there is no fallback from one to the other.

Entry points default to `device="cuda"` and raise when no card is present.
"""

__version__ = "0.1.0"
