"""K1: the 8x8 flow blur — wrapper of csrc/blur_flow.cu and its plain version.

Replaces hopperrender_tpu/ops/pallas_kernels.py::blur_flow_pallas (the TPU
kernel). `blur_flow` launches the CUDA kernel for a CUDA tensor and takes the
plain PyTorch version `blur_flow_reference` only for a CPU tensor.
"""

from __future__ import annotations

import torch

from hopperrender_tpu_torch import _build

BLUR_RADIUS = 4  # window [-4, 4) (ref: blurFlowKernelSDR.h:4)


def _symmetric_index(n: int, dim: int, device) -> torch.Tensor:
    """Source index of each of the dim + 2*radius - 1 padded positions under
    numpy's "symmetric" mirror (pos < 0 -> -pos-1, pos >= dim -> 2*dim-pos-1,
    repeating with period 2*dim). F.pad(mode="reflect") would drop the edge
    sample, so the indices are computed."""
    pos = torch.arange(-BLUR_RADIUS, n + BLUR_RADIUS - 1, device=device) % (2 * dim)
    return torch.where(pos < dim, pos, 2 * dim - 1 - pos)


def blur_flow_reference(offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: (2, low_h, low_w) int16 -> int16; box sum
    over the mirrored [-4, 4) x [-4, 4) window, truncating division by 64
    (ref: blurFlowKernelSDR.h:3-4,79-91)."""
    _, low_h, low_w = offsets.shape
    iy = _symmetric_index(low_h, low_h, offsets.device)
    ix = _symmetric_index(low_w, low_w, offsets.device)
    padded = offsets.to(torch.int32)[:, iy][:, :, ix]
    k = 2 * BLUR_RADIUS
    rows = sum(padded[:, :, kx:kx + low_w] for kx in range(k))
    acc = sum(rows[:, ky:ky + low_h, :] for ky in range(k))
    return torch.div(acc, 64, rounding_mode="trunc").to(torch.int16)


def blur_flow(offsets: torch.Tensor) -> torch.Tensor:
    """K1 wrapper: (2, low_h, low_w) int16 -> int16, bit-identical to
    blur_flow_reference. Launches the CUDA kernel on a CUDA tensor (on the
    current stream, no synchronisation); a CPU tensor takes the plain
    version."""
    if offsets.dtype != torch.int16 or offsets.dim() != 3 or offsets.shape[0] != 2:
        raise ValueError(f"blur_flow takes (2, low_h, low_w) int16, got "
                         f"{tuple(offsets.shape)} {offsets.dtype}")
    if offsets.device.type == "cpu":
        return blur_flow_reference(offsets)
    if offsets.device.type != "cuda":
        raise ValueError(f"blur_flow: unsupported device {offsets.device}")
    if not offsets.is_contiguous():
        raise ValueError("blur_flow: offsets must be contiguous")
    _, low_h, low_w = offsets.shape
    out = torch.empty_like(offsets)
    _build.launch("hrt_blur_flow", offsets.get_device(), offsets.data_ptr(), out.data_ptr(),
                  low_h, low_w)
    blur_flow.launches += 1
    return out


blur_flow.launches = 0
