"""K5: mode 3's HSV flow overlay — wrapper of csrc/hsv_overlay.cu and its
plain version.

No pallas_call stands behind it: the JAX package computes the overlay as one
jitted XLA program (hopperrender_tpu/ops/warp_viz.py::hsv_flow_overlay) after
the TPU kernel's raw_blend variant. `hsv_flow_overlay` launches the CUDA
kernel for CUDA tensors and takes the plain PyTorch version
`hsv_flow_overlay_reference` only for CPU tensors. Its counter:
`hsv_flow_overlay.launches`. Served mode 3 does not run it: K2's mode 3
(ops/warp_kernel.py) colours in its own epilogue. It is the kernel behind
ops/warp_viz.hsv_flow_overlay, the counterpart of the JAX function.
"""

from __future__ import annotations

import torch

from hopperrender_tpu_torch import _build
from hopperrender_tpu_torch.ops import warp as warp_ops
from hopperrender_tpu_torch.ops.warp import F32, from_int32, to_int32


def hsv_flow_overlay_reference(raw_y: torch.Tensor, raw_uv: torch.Tensor, flow: torch.Tensor,
                               black_level, white_level, *, res_scalar: int, is_hdr: bool,
                               row_offsets: tuple[int, int] = (0, 0)):
    """Plain PyTorch version of K5. Mode 3: the HSV flow colour over the raw
    (pre-levels) mode-2 blend, then the levels. raw_y (..., H, W) and raw_uv
    (..., H/2, W) are K2's raw_blend outputs; the colour of a pixel comes from
    the negated flow of its cell (ref: warpFrameKernelSDR.h:172-183).
    row_offsets (Y, UV): the plane row of each input's first row, for the row
    bands of the mesh (K2's mesh-sharded raw_blend variant); rows past the
    plane are coloured as if the flow grid went on, and the mesh crops them."""
    dev = flow.device
    black = torch.as_tensor(black_level, dtype=F32, device=dev)
    white = torch.as_tensor(white_level, dtype=F32, device=dev)
    out = []
    for cz, raw, row0 in ((0, raw_y, row_offsets[0]), (1, raw_uv, row_offsets[1])):
        cx, cy = warp_ops.plane_coords(raw.shape[-2], raw.shape[-1], dev, row0)
        coloured = warp_ops.hsv_colour(to_int32(raw), flow, cx, cy, res_scalar=res_scalar,
                                       cz=cz, is_hdr=is_hdr)
        out.append(from_int32(warp_ops._apply_levels(coloured, black, white, cz=cz,
                                                     is_hdr=is_hdr), raw.dtype))
    return tuple(out)


def _check(raw_y, raw_uv, flow, *, is_hdr, row_offsets):
    dtype = torch.uint16 if is_hdr else torch.uint8
    for name, t in (("raw_y", raw_y), ("raw_uv", raw_uv)):
        if t.dtype != dtype or t.dim() < 2:
            raise ValueError(f"{name}: expected (..., rows, W) {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if raw_y.shape[:-2] != raw_uv.shape[:-2] or raw_y.shape[-1] != raw_uv.shape[-1]:
        raise ValueError(f"raw_y {tuple(raw_y.shape)} and raw_uv {tuple(raw_uv.shape)} differ "
                         "in their batch or width")
    if flow.dtype != torch.int16 or flow.dim() != 3 or flow.shape[0] != 2:
        raise ValueError(f"flow: expected (2, low_h, low_w) int16, got "
                         f"{tuple(flow.shape)} {flow.dtype}")
    if min(row_offsets) < 0:
        raise ValueError(f"row_offsets must not be negative, got {row_offsets}")
    if raw_y.device != flow.device or raw_uv.device != flow.device:
        raise ValueError("hsv_flow_overlay: all tensors must be on one device")


def hsv_flow_overlay(raw_y: torch.Tensor, raw_uv: torch.Tensor, flow: torch.Tensor,
                     black_level, white_level, *, res_scalar: int, is_hdr: bool,
                     row_offsets: tuple[int, int] = (0, 0)):
    """K5 wrapper: mode 3's planes, (..., H, W) and (..., H/2, W) of raw_y's
    and raw_uv's type, bit-identical to hsv_flow_overlay_reference. Sources
    are uint8 (SDR) or uint16 (HDR); flow is (2, low_h, low_w) int16; levels
    are in sample units (HDR pre-scaled x256). The colour replaces the raw UV,
    so the kernel reads only raw_uv's shape. Launches the CUDA kernel for CUDA
    tensors (on the current stream, no synchronisation); CPU tensors take the
    plain version."""
    _check(raw_y, raw_uv, flow, is_hdr=is_hdr, row_offsets=row_offsets)
    if flow.device.type == "cpu":
        return hsv_flow_overlay_reference(raw_y, raw_uv, flow, black_level, white_level,
                                          res_scalar=res_scalar, is_hdr=is_hdr,
                                          row_offsets=row_offsets)
    if flow.device.type != "cuda":
        raise ValueError(f"hsv_flow_overlay: unsupported device {flow.device}")
    if not (raw_y.is_contiguous() and flow.is_contiguous()):
        raise ValueError("hsv_flow_overlay: raw_y and flow must be contiguous")
    if raw_y.numel() == 0 or raw_uv.numel() == 0:
        raise ValueError(f"hsv_flow_overlay: empty planes {tuple(raw_y.shape)} "
                         f"{tuple(raw_uv.shape)}")
    out_y, out_uv = raw_y.new_empty(raw_y.shape), raw_uv.new_empty(raw_uv.shape)
    rows_y, dim_x = raw_y.shape[-2:]
    _build.launch("hrt_hsv_overlay", flow.get_device(), raw_y.data_ptr(), flow.data_ptr(),
                  out_y.data_ptr(), out_uv.data_ptr(), raw_y.numel() // (rows_y * dim_x),
                  rows_y, raw_uv.shape[-2], dim_x, row_offsets[0], row_offsets[1],
                  flow.shape[1], flow.shape[2], res_scalar, int(is_hdr), float(black_level),
                  float(white_level))
    hsv_flow_overlay.launches += 1
    return out_y, out_uv


hsv_flow_overlay.launches = 0
