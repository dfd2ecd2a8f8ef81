"""Warp / copy ops: bidirectional warp + blend (modes 0/1/2), levels, and the
passthrough copy.

PyTorch port of hopperrender_tpu/ops/warp.py (ref: warpFrameKernelSDR.h:116-184,
copyFrameKernelSDR.h:12-25). C float semantics: float32 arithmetic,
`(int)round()` half away from zero, float -> int truncates toward zero, and
1 - t formed in float32, as the JAX package forms it.

Fused multiply-adds. The JAX package, compiled by XLA, contracts two of its
multiply-adds into FMAs (one rounding instead of two), and its outputs,
including the golden fixtures, carry that rounding:
  * the blend  v12 * (1 - t) + v21 * t  ->  fma(v12, 1 - t, v21 * t);
  * the UV levels  q * peak + mid       ->  fma(q, peak, mid).
PyTorch has no FMA operation, so `_fma_f32` computes one exactly; every other
operation rounds once per operation as written (PyTorch runs each operation
as its own kernel, so nothing else is contracted).

Samples are widened to int32 (`to_int32`) before any indexing or arithmetic
and narrowed back at the end (`from_int32`).
"""

from __future__ import annotations

import torch

F32 = torch.float32
F64 = torch.float64
WARP_MODES = (0, 1, 2)   # modes 3-6 (flow visualisation, side by side) are not ported yet


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """Samples as int32. uint16 goes through an int16 view: PyTorch's CUDA
    kernels cover uint16 for little more than plain copies."""
    if x.dtype == torch.uint16:
        return x.view(torch.int16).to(torch.int32) & 0xFFFF
    return x.to(torch.int32)


def from_int32(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int32 samples, in range for dtype, as dtype (uint16 through int16)."""
    if dtype == torch.uint16:
        return x.to(torch.int16).view(torch.uint16)
    return x.to(dtype)


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with a single rounding, for float32 inputs.

    The float64 product of two float32 values is exact. The float64 sum is
    taken with rounding to odd (TwoSum gives the sum's error; an inexact sum
    with an even last bit steps one float64 ulp toward the error), and
    rounding to odd in a format with at least two more bits than float32,
    then to nearest in float32, rounds the exact value correctly
    (Boldo & Melquiond, "Emulation of FMA and correctly rounded sums", 2008)."""
    x = a.to(F64) * b.to(F64)
    y = c.to(F64)
    s = x + y
    bb = s - x
    err = (x - (s - bb)) + (y - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(F64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(F32)


def _mirror_warp(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """Remapping mirror clamped to [1, dim-2] (ref: warpFrameKernelSDR.h:12-20)."""
    res = torch.where(pos >= dim - 1, pos - (pos - (dim - 2)) * 2,
                      torch.where(pos < 1, -pos + 1, pos))
    return res.clamp(1, dim - 2)


def _round_c(x: torch.Tensor) -> torch.Tensor:
    """C round(): half away from zero in float32 (ref: warpFrameKernelSDR.h:167)."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5)).to(torch.int32)


def _peak(is_hdr: bool) -> float:
    return 65535.0 if is_hdr else 255.0


def _apply_levels_y(value: torch.Tensor, black: torch.Tensor, white: torch.Tensor,
                    is_hdr: bool) -> torch.Tensor:
    peak = _peak(is_hdr)
    v = (value.to(F32) - black) / (white - black) * peak
    return torch.trunc(v.clamp(0.0, peak)).to(torch.int32)


def _apply_levels_uv(value: torch.Tensor, white: torch.Tensor, is_hdr: bool) -> torch.Tensor:
    peak = _peak(is_hdr)
    mid = 32768.0 if is_hdr else 128.0
    q = (value.to(F32) - mid) / white
    v = _fma_f32(q, q.new_tensor(peak), q.new_tensor(mid))
    return torch.trunc(v.clamp(0.0, peak)).to(torch.int32)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=device)


def warp_frame_plane(
    src12_y: torch.Tensor, src12_uv: torch.Tensor,
    src21_y: torch.Tensor, src21_uv: torch.Tensor,
    flow: torch.Tensor,          # (2, low_h, low_w) int16 blurred offsets
    blending_scalar, black_level, white_level, *,
    res_scalar: int, mode: int, cz: int, is_hdr: bool,
) -> torch.Tensor:
    """One plane (cz=0: Y (H, W); cz=1: interleaved UV (H/2, W)) of the warp
    kernel, modes 0/1/2 (ref: warpFrameKernelSDR.h:116-184)."""
    if mode not in WARP_MODES:
        raise NotImplementedError(f"output mode {mode} is not ported yet")
    dev = flow.device
    dim_y, dim_x = src12_y.shape
    low_h, low_w = flow.shape[1:]
    src12 = to_int32(src12_y if cz == 0 else src12_uv)
    src21 = to_int32(src21_y if cz == 0 else src21_uv)
    out_h = src12.shape[0]

    fs12 = _f32(blending_scalar, dev)
    fs21 = _f32(1.0, dev) - fs12

    cx = torch.arange(dim_x, dtype=torch.int32, device=dev)[None, :].expand(out_h, dim_x)
    cy = torch.arange(out_h, dtype=torch.int32, device=dev)[:, None].expand(out_h, dim_x)

    # Flow lookup (ref: warpFrameKernelSDR.h:153-158).
    if cz:
        scaled_cx = (cx >> res_scalar) & ~1
        scaled_cy = (cy >> res_scalar) << 1
    else:
        scaled_cx = cx >> res_scalar
        scaled_cy = cy >> res_scalar
    scaled_cx = scaled_cx.clamp(0, low_w - 1).long()
    scaled_cy = scaled_cy.clamp(0, low_h - 1).long()

    flow_x = flow[0].to(torch.int32)
    flow_y = flow[1].to(torch.int32)
    off_x12 = flow_x[scaled_cy, scaled_cx]
    off_y12 = flow_y[scaled_cy, scaled_cx]
    back_cy = (scaled_cy - (off_y12 >> res_scalar)).clamp(0, low_h - 1)
    back_cx = (scaled_cx - (off_x12 >> res_scalar)).clamp(0, low_w - 1)
    off_x21 = flow_x[back_cy, back_cx]
    off_y21 = flow_y[back_cy, back_cx]

    # Warped positions (ref: warpFrameKernelSDR.h:166-170); products left to
    # right as the reference writes them: (off * t) * y_scale.
    y_scale = 0.5 if cz else 1.0

    def sample(src, off_x, off_y, fs, sign):
        new_cx = _mirror_warp(cx + sign * _round_c(off_x.to(F32) * fs), dim_x)
        new_cy = _mirror_warp(cy + sign * _round_c(off_y.to(F32) * fs * y_scale), out_h)
        col = (new_cx & ~1) + (cx & 1) if cz else new_cx
        return src[new_cy.long(), col.long()]

    if mode == 0:
        return from_int32(sample(src12, off_x12, off_y12, fs12, 1), src12_y.dtype)
    if mode == 1:
        return from_int32(sample(src21, off_x21, off_y21, fs21, -1), src12_y.dtype)
    v12 = sample(src12, off_x12, off_y12, fs12, 1).to(F32)
    v21 = sample(src21, off_x21, off_y21, fs21, -1).to(F32)
    blended = torch.trunc(_fma_f32(v12, fs21, v21 * fs12)).to(torch.int32)
    black, white = _f32(black_level, dev), _f32(white_level, dev)
    if cz:
        res = _apply_levels_uv(blended, white, is_hdr)
    else:
        res = _apply_levels_y(blended, black, white, is_hdr)
    return from_int32(res, src12_y.dtype)


def warp_frame(src12_y, src12_uv, src21_y, src21_uv, flow, blending_scalar,
               black_level, white_level, *, res_scalar: int, mode: int, is_hdr: bool):
    """Both planes, (y, uv) (ref: opticalFlowCalcSDR.cpp:152-167)."""
    return tuple(
        warp_frame_plane(src12_y, src12_uv, src21_y, src21_uv, flow, blending_scalar,
                         black_level, white_level, res_scalar=res_scalar, mode=mode,
                         cz=cz, is_hdr=is_hdr)
        for cz in (0, 1))


def copy_frame(src_y: torch.Tensor, src_uv: torch.Tensor, black_level, white_level, *,
               is_hdr: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Passthrough with levels (ref: copyFrameKernelSDR.h:12-25)."""
    black, white = _f32(black_level, src_y.device), _f32(white_level, src_y.device)
    y = from_int32(_apply_levels_y(to_int32(src_y), black, white, is_hdr), src_y.dtype)
    uv = from_int32(_apply_levels_uv(to_int32(src_uv), white, is_hdr), src_uv.dtype)
    return y, uv
