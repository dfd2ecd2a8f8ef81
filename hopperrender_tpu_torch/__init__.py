"""hopperrender_tpu_torch — the frame-interpolation engine on PyTorch + CUDA.

The port of `hopperrender_tpu` (JAX on a TPU) to PyTorch with kernels written
by hand for NVIDIA Hopper (sm_90a). It keeps its own copies of the JAX
package's framework-free modules (config, server control plane, side data,
display probe, NV12/P010 packing, logging) and imports nothing of that
package. Kernels build on first use (`_build.py`), never at import.
"""

__version__ = "0.1.0"
