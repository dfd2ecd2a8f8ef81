"""hopperrender_tpu_torch — the frame-interpolation engine on PyTorch + CUDA.

The port of `hopperrender_tpu` (JAX on a TPU) to PyTorch with kernels written
by hand for NVIDIA Hopper (sm_90a). It reuses the JAX package's framework-free
modules (config, server control plane, side data, display probe, NV12/P010
packing, logging) and never imports jax. Kernels build on first use
(`_build.py`), never at import.

Importing `hopperrender_tpu.*` runs `hopperrender_tpu/__init__.py`, which
imports jax when the JAX_PLATFORMS environment variable is set: unset it
before importing this package where jax is not installed.
"""

__version__ = "0.1.0"
