"""K6: the levelled passthrough — wrapper of csrc/copy_frame.cu and its plain
version.

No pallas_call stands behind it: the JAX package computes the copy as one
jitted XLA program (hopperrender_tpu/ops/warp.py::copy_frame). `copy_frame`
launches the CUDA kernel for CUDA tensors and takes the plain PyTorch version
`copy_frame_reference` (ops/warp.copy_frame) only for CPU tensors. Its
counter: `copy_frame.launches`. The engine's copy_frame (warmup, scene cuts,
TooSlow) calls it.
"""

from __future__ import annotations

import torch

from hopperrender_tpu_torch import _build
from hopperrender_tpu_torch.ops import warp as warp_ops


def copy_frame_reference(src_y: torch.Tensor, src_uv: torch.Tensor, black_level, white_level,
                         *, is_hdr: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6: ops/warp.copy_frame, both planes through
    the levels (ref: copyFrameKernelSDR.h:12-25)."""
    return warp_ops.copy_frame(src_y, src_uv, black_level, white_level, is_hdr=is_hdr)


def _check(src_y, src_uv, *, is_hdr):
    dtype = torch.uint16 if is_hdr else torch.uint8
    for name, t in (("src_y", src_y), ("src_uv", src_uv)):
        if t.dtype != dtype or t.dim() != 2:
            raise ValueError(f"copy_frame: {name} must be a 2-D {dtype} plane, got "
                             f"{tuple(t.shape)} {t.dtype}")
    dim_y, dim_x = src_y.shape
    if dim_y < 2 or dim_y % 2 or dim_x < 1 or tuple(src_uv.shape) != (dim_y // 2, dim_x):
        raise ValueError(f"copy_frame: planes {tuple(src_y.shape)} and {tuple(src_uv.shape)} "
                         "are not (H, W) and (H/2, W) with H even")
    if src_y.device != src_uv.device:
        raise ValueError("copy_frame: both planes must be on one device")


def copy_frame(src_y: torch.Tensor, src_uv: torch.Tensor, black_level, white_level, *,
               is_hdr: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K6 wrapper: (H, W) Y and (H/2, W) UV, uint8 (SDR) or uint16 (HDR),
    levelled into new planes of the same shapes and type, bit-identical to
    copy_frame_reference. Levels are in sample units (HDR pre-scaled x256).
    Launches the CUDA kernel for CUDA tensors (on the current stream, no
    synchronisation); CPU tensors take the plain version."""
    _check(src_y, src_uv, is_hdr=is_hdr)
    if src_y.device.type == "cpu":
        return copy_frame_reference(src_y, src_uv, black_level, white_level, is_hdr=is_hdr)
    if src_y.device.type != "cuda":
        raise ValueError(f"copy_frame: unsupported device {src_y.device}")
    if not (src_y.is_contiguous() and src_uv.is_contiguous()):
        raise ValueError("copy_frame: both planes must be contiguous")
    out_y, out_uv = torch.empty_like(src_y), torch.empty_like(src_uv)
    dim_y, dim_x = src_y.shape
    _build.launch("hrt_copy_frame", src_y.get_device(), src_y.data_ptr(), src_uv.data_ptr(),
                  out_y.data_ptr(), out_uv.data_ptr(), dim_y, dim_x, int(is_hdr),
                  float(black_level), float(white_level))
    copy_frame.launches += 1
    return out_y, out_uv


copy_frame.launches = 0
