"""The visualisation output modes: mode 3 (HSV flow over the raw blend),
mode 4 (grey flow), mode 5 (side by side, full resolution) and mode 6 (side
by side, 2x downsampled).

`warp_outputs` serves every output mode with ONE call of K2 (ops/warp_kernel,
csrc/warp_frame.cu), which computes modes 3-6 itself, as the reference's one
warp kernel does (ref: warpFrameKernelSDR.h:116-184) and as
ops/warp.warp_frame computes them.

The rest is the PyTorch port of hopperrender_tpu/ops/warp_viz.py and of
hopperrender_tpu/ops/warp_strip.py::grey_flow_frame, the JAX package's
compositions from its warp kernel's outputs (XLA, no TPU kernel). No served
path calls them: they stay as the counterparts of the JAX functions, and
each equals ops/warp.py::warp_frame_plane in its mode:

  * hsv_flow_overlay colours a raw blend it is given (kernel K5,
    ops/hsv_kernel.py), the counterpart of the JAX function that the TPU
    strip route runs after its raw_blend;
  * grey_flow_frame (mode 4) needs the flow only;
  * side_by_side_1 (mode 5) is the source's left half beside K2's mode-2
    right half;
  * side_by_side_2 (mode 6) puts the 2x-downsampled source and mode-2 output
    side by side in a centred band. Y and the UV plane's U outputs are
    strided slices; the right half's V outputs sample with chroma parity 1
    at an even column, which no mode-2 output does, so they are warped here
    (one sample per V output: a quarter of the band's UV).

The JAX package's versions repeat the flow over whole cells (they assume
dim_x % (1 << res_scalar) == 0); these look the flow up per pixel as
warp_frame_plane does, so every even geometry works. Warp outputs come
batched, (T, H, W) and (T, H/2, W), with their (T,) blending scalars.
grey_flow_frame, side_by_side_1 and the overlay also take row_offsets, for
row bands.
"""

from __future__ import annotations

import torch

from hopperrender_tpu_torch.ops import hsv_kernel, warp_kernel
from hopperrender_tpu_torch.ops import warp as warp_ops
from hopperrender_tpu_torch.ops.warp import F32, from_int32, plane_coords, to_int32


def warp_outputs(src12_y, src12_uv, src21_y, src21_uv, flow, ts, black_level, white_level, *,
                 mode: int, res_scalar: int, is_hdr: bool):
    """The warp in any output mode 0-6, one output per blending scalar of the
    (T,) vector ts: (T, H, W), (T, H/2, W), from one K2 call. Mode 4 reads no
    source and gives every t the same frame: K2 makes it for the first t and
    the T outputs are views of it. The K2 wrapper is looked up at call time,
    so a caller may point it at its plain version."""
    one = mode == 4
    y, uv = warp_kernel.warp_frames(src12_y, src12_uv, src21_y, src21_uv, flow,
                                    ts[:1] if one else ts, black_level, white_level, mode=mode,
                                    res_scalar=res_scalar, is_hdr=is_hdr)
    if one:
        return y.expand(len(ts), -1, -1), uv.expand(len(ts), -1, -1)
    return y, uv


def hsv_flow_overlay(raw_y: torch.Tensor, raw_uv: torch.Tensor, flow: torch.Tensor,
                     black_level, white_level, *, res_scalar: int, is_hdr: bool,
                     row_offsets: tuple[int, int] = (0, 0)):
    """The HSV flow colour over a raw (pre-levels) mode-2 blend, then the
    levels: K5, ops/hsv_kernel.hsv_flow_overlay (looked up at call time, so
    a caller may point it at its plain version). Served mode 3 does not
    call it: K2's mode 3 colours in its own epilogue. raw_y (..., H, W)
    and raw_uv (..., H/2, W) are K2's raw_blend outputs. row_offsets (Y, UV):
    the plane row of each input's first row, for the row bands of the mesh;
    rows past the plane are coloured as if the flow grid went on, and the
    mesh crops them."""
    return hsv_kernel.hsv_flow_overlay(raw_y, raw_uv, flow, black_level, white_level,
                                       res_scalar=res_scalar, is_hdr=is_hdr,
                                       row_offsets=row_offsets)


def grey_flow_frame(flow: torch.Tensor, *, res_scalar: int, is_hdr: bool, dim_y: int,
                    dim_x: int, row_offsets: tuple[int, int] = (0, 0),
                    out_rows: tuple[int, int] | None = None):
    """Mode 4: (|ox| + |oy|) of each pixel's cell, shifted and capped, as Y;
    neutral UV (ref: warpFrameKernelSDR.h:161-164). (H, W), (H/2, W).
    row_offsets (Y, UV) and out_rows (Y, UV): the band of plane rows
    [row0, row0 + rows) of each plane, for the row bands of the mesh; rows
    past the plane are 0, as in K2's mesh-sharded variant."""
    dtype = torch.uint16 if is_hdr else torch.uint8
    planes = []
    for cz, plane_h in ((0, dim_y), (1, dim_y // 2)):
        row0 = row_offsets[cz]
        rows = plane_h - row0 if out_rows is None else out_rows[cz]
        valid = max(0, min(rows, plane_h - row0))
        grey = torch.zeros((rows, dim_x), dtype=torch.int32, device=flow.device)
        if valid:
            cx, cy = plane_coords(valid, dim_x, flow.device, row0)
            grey[:valid] = warp_ops.grey_flow_plane(flow, cx, cy, res_scalar=res_scalar,
                                                    cz=cz, is_hdr=is_hdr)
        planes.append(from_int32(grey, dtype))
    return tuple(planes)


def side_by_side_1(src12_y: torch.Tensor, src12_uv: torch.Tensor,
                   warp2_y: torch.Tensor, warp2_uv: torch.Tensor, *,
                   row_offsets: tuple[int, int] = (0, 0)):
    """Mode 5: source 1's left half beside the mode-2 output's right half
    (ref: warpFrameKernelSDR.h:128-133). row_offsets (Y, UV): the plane row
    of the mode-2 inputs' first row, for the row bands of the mesh (K2's
    mesh-sharded variant); rows past the plane keep the band's 0."""
    half = src12_y.shape[-1] >> 1
    out = []
    for src, warp2, row0 in ((src12_y, warp2_y, row_offsets[0]),
                             (src12_uv, warp2_uv, row_offsets[1])):
        plane = warp2.clone()
        valid = max(0, min(plane.shape[-2], src.shape[0] - row0))
        plane[..., :valid, :half] = src[row0:row0 + valid, :half]
        out.append(plane)
    return tuple(out)


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
