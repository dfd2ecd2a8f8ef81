"""The visualisation output modes composed from the warp kernel's outputs:
mode 3 (HSV flow over the raw blend), mode 4 (grey flow), mode 5 (side by
side, full resolution) and mode 6 (side by side, 2x downsampled).

PyTorch port of hopperrender_tpu/ops/warp_viz.py and of
hopperrender_tpu/ops/warp_strip.py::grey_flow_frame. Each function equals
ops/warp.py::warp_frame_plane in its mode (ref: warpFrameKernelSDR.h:116-184):

  * mode 3 colours K2's raw mode-2 blend (warp_frames(raw_blend=True)) with
    the flow of each pixel's cell, then applies the levels;
  * mode 4 needs the flow only;
  * mode 5 is the source's left half beside K2's mode-2 right half;
  * mode 6 puts the 2x-downsampled source and mode-2 output side by side in a
    centred band. Y and the UV plane's U outputs are strided slices; the
    right half's V outputs sample with chroma parity 1 at an even column,
    which no mode-2 output does, so they are warped here (one sample per V
    output: a quarter of the band's UV).

The JAX package's versions repeat the flow over whole cells (they assume
dim_x % (1 << res_scalar) == 0); these look the flow up per pixel as
warp_frame_plane does, so every even geometry works. All are plain PyTorch:
none of them is a TPU kernel in the JAX package. Warp outputs come batched,
(T, H, W) and (T, H/2, W), with their (T,) blending scalars.
"""

from __future__ import annotations

import torch

from hopperrender_tpu_torch.ops import warp as warp_ops
from hopperrender_tpu_torch.ops import warp_kernel
from hopperrender_tpu_torch.ops.warp import F32, from_int32, to_int32


def warp_outputs(src12_y, src12_uv, src21_y, src21_uv, flow, ts, black_level, white_level, *,
                 mode: int, res_scalar: int, is_hdr: bool):
    """The warp in any output mode 0-6, one output per blending scalar of the
    (T,) vector ts: (T, H, W), (T, H/2, W). Modes 0/1/2 are K2; the
    visualisation modes are composed as the JAX engine composes them
    (hopperrender_tpu/engine/flow_engine.py::_run_warp). The K2 wrapper is
    looked up at call time, so a caller may point it at its plain version."""
    kw = dict(res_scalar=res_scalar, is_hdr=is_hdr)
    srcs = (src12_y, src12_uv, src21_y, src21_uv)
    if mode == 4:   # grey flow: no source sample
        y, uv = grey_flow_frame(flow, dim_y=src12_y.shape[0], dim_x=src12_y.shape[1], **kw)
        return y.expand(len(ts), -1, -1), uv.expand(len(ts), -1, -1)
    if mode == 3:   # HSV flow over K2's raw mode-2 blend
        raw_y, raw_uv = warp_kernel.warp_frames(*srcs, flow, ts, black_level, white_level,
                                                mode=2, raw_blend=True, **kw)
        return hsv_flow_overlay(raw_y, raw_uv, flow, black_level, white_level, **kw)
    y, uv = warp_kernel.warp_frames(*srcs, flow, ts, black_level, white_level,
                                    mode=2 if mode in (5, 6) else mode, **kw)
    if mode == 5:
        return side_by_side_1(src12_y, src12_uv, y, uv)
    if mode == 6:
        return side_by_side_2(src12_y, src12_uv, src21_uv, y, uv, flow, ts, white_level, **kw)
    return y, uv


def _plane_coords(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    cx = torch.arange(w, dtype=torch.int32, device=device)[None, :].expand(h, w)
    cy = torch.arange(h, dtype=torch.int32, device=device)[:, None].expand(h, w)
    return cx, cy


def hsv_flow_overlay(raw_y: torch.Tensor, raw_uv: torch.Tensor, flow: torch.Tensor,
                     black_level, white_level, *, res_scalar: int, is_hdr: bool):
    """Mode 3: the HSV flow colour over the raw (pre-levels) mode-2 blend,
    then the levels. raw_y (..., H, W) and raw_uv (..., H/2, W) are K2's
    raw_blend outputs; the colour of a pixel comes from the negated flow of
    its cell (ref: warpFrameKernelSDR.h:172-183)."""
    dev = flow.device
    black = torch.as_tensor(black_level, dtype=F32, device=dev)
    white = torch.as_tensor(white_level, dtype=F32, device=dev)
    out = []
    for cz, raw in ((0, raw_y), (1, raw_uv)):
        cx, cy = _plane_coords(raw.shape[-2], raw.shape[-1], dev)
        coloured = warp_ops.hsv_colour(to_int32(raw), flow, cx, cy, res_scalar=res_scalar,
                                       cz=cz, is_hdr=is_hdr)
        out.append(from_int32(warp_ops._apply_levels(coloured, black, white, cz=cz,
                                                     is_hdr=is_hdr), raw.dtype))
    return tuple(out)


def grey_flow_frame(flow: torch.Tensor, *, res_scalar: int, is_hdr: bool, dim_y: int,
                    dim_x: int):
    """Mode 4: (|ox| + |oy|) of each pixel's cell, shifted and capped, as Y;
    neutral UV (ref: warpFrameKernelSDR.h:161-164). (H, W), (H/2, W)."""
    dtype = torch.uint16 if is_hdr else torch.uint8
    planes = []
    for cz, h in ((0, dim_y), (1, dim_y // 2)):
        cx, cy = _plane_coords(h, dim_x, flow.device)
        planes.append(from_int32(warp_ops.grey_flow_plane(
            flow, cx, cy, res_scalar=res_scalar, cz=cz, is_hdr=is_hdr), dtype))
    return tuple(planes)


def side_by_side_1(src12_y: torch.Tensor, src12_uv: torch.Tensor,
                   warp2_y: torch.Tensor, warp2_uv: torch.Tensor):
    """Mode 5: source 1's left half beside the mode-2 output's right half
    (ref: warpFrameKernelSDR.h:128-133)."""
    half = src12_y.shape[-1] >> 1
    y, uv = warp2_y.clone(), warp2_uv.clone()
    y[..., :half] = src12_y[:, :half]
    uv[..., :half] = src12_uv[:, :half]
    return y, uv


def side_by_side_2(src12_y: torch.Tensor, src12_uv: torch.Tensor, src21_uv: torch.Tensor,
                   warp2_y: torch.Tensor, warp2_uv: torch.Tensor, flow: torch.Tensor,
                   ts: torch.Tensor, white_level, *, res_scalar: int, is_hdr: bool):
    """Mode 6: a centred band of rows [H/4, 3H/4) holds the 2x-downsampled
    source 1 (left) and mode-2 output (right); black and neutral chroma
    elsewhere (ref: warpFrameKernelSDR.h:135-151). warp2_* are K2's mode-2
    outputs for the (T,) blending scalars ts."""
    dim_y, dim_x = src12_y.shape
    half = dim_x >> 1
    n_t = warp2_y.shape[0]
    dev = flow.device
    mid = 32768 if is_hdr else 128

    dtype = warp2_y.dtype
    full = lambda shape, v: from_int32(  # noqa: E731 (built in int32: uint16 on CUDA)
        torch.full(shape, v, dtype=torch.int32, device=dev), dtype)

    # Y: even rows and columns of the source and of the mode-2 output.
    vo = dim_y >> 2
    y = full(warp2_y.shape, 0)
    y[:, vo:vo + dim_y // 2, :half] = src12_y[0::2, 0::2]
    y[:, vo:vo + dim_y // 2, half:] = warp2_y[:, 0::2, 0::2]

    # UV: the band's rows r = 0 .. H/4 - 1 read plane row 2r. Left half:
    # source column (cx << 1) + (cx & 1), i.e. U from every even source pair,
    # V from every odd one.
    band_c = dim_y >> 2
    vo_c = vo >> 1
    cols = torch.arange(half, device=dev)
    uv = full(warp2_uv.shape, mid)
    left = to_int32(src12_uv[0:2 * band_c:2])[:, (cols << 1) + (cols & 1)]
    uv[:, vo_c:vo_c + band_c, :half] = from_int32(left, dtype)

    # Right half, output column half + m: the mode-2 output at (2r, 2m) where
    # half + m is even (a U output: parity 0, as mode 2 samples there); where
    # it is odd (a V output), the blend with parity 1 at (2r, 2m).
    right = warp2_uv[:, 0:2 * band_c:2, 0::2].clone()
    m_off = 1 - (half & 1)
    mm = torch.arange(m_off, half, 2, dtype=torch.int32, device=dev)
    adj_cx = (mm << 1)[None, :].expand(band_c, -1)
    adj_cy = (torch.arange(band_c, dtype=torch.int32, device=dev) << 1)[:, None] \
        .expand(-1, mm.shape[0])
    fs12 = ts.to(F32).reshape(n_t, 1, 1)
    v12, v21 = warp_ops.warp_samples(src12_uv, src21_uv, flow, adj_cx, adj_cy, 1, fs12,
                                     res_scalar=res_scalar, cz=1, dim_x=dim_x)
    white = torch.as_tensor(white_level, dtype=F32, device=dev)
    v = warp_ops._apply_levels_uv(warp_ops.blend(v12, v21, fs12), white, is_hdr)
    right[:, :, m_off::2] = from_int32(v, dtype)
    uv[:, vo_c:vo_c + band_c, half:] = right
    return y, uv
