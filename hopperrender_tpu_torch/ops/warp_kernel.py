"""K2: the batched warp (every output mode 0-6, and mode 2's raw_blend
variant) — wrapper of csrc/warp_frame.cu and its plain version.

Replaces hopperrender_tpu/ops/warp_band.py::warp_frame_band (the TPU kernel)
with a (T,) blending-scalar vector: all T outputs of a source interval come
from one call. raw_blend=True is that kernel's raw_blend variant: mode 2's
blend stored without levels, which K5 colours (ops/warp_viz.hsv_flow_overlay).
Mode 3 is the HSV flow overlay in K2's epilogue, as ops/warp.warp_frame
computes it: one launch for both planes that warps, blends, colours and
levels, and reads no UV source (the colour replaces it). Modes 4 (grey
flow), 5 (side by side) and 6 (side by side, 2x down) are one launch each
for both planes too, as ops/warp.warp_frame computes them; the JAX package
composes them in XLA outside its kernel. Every mode is how the engine,
batched_step and the mesh serve it.
`warp_frames` launches the CUDA kernel for CUDA tensors and takes the plain
PyTorch version `warp_frames_reference` only for CPU tensors. Its counters:
`warp_frames.launches` (modes 0/1/2), `warp_frames.mode3_launches` (mode 3),
`warp_frames.viz_launches` (modes 4/5/6) and `warp_frames.raw_launches`
(the raw_blend variant).

`warp_frames_band` is that kernel's mesh-sharded variant (warp_frame_band
with num_shards > 1): one shard's row band of each plane, from the same
kernel body, for the row split of parallel/mesh.py, in every mode and
raw_blend. Plain version `warp_frames_band_reference`; counters
`warp_frames_band.launches` (modes 0/1/2), `.mode3_launches` (mode 3),
`.viz_launches` (modes 4/5/6) and `.raw_launches` (raw_blend).
"""

from __future__ import annotations

import torch

from hopperrender_tpu_torch import _build
from hopperrender_tpu_torch.ops import warp as warp_ops

KERNEL_MODES = (0, 1, 2, 3, 4, 5, 6)


def warp_frames_reference(src12_y, src12_uv, src21_y, src21_uv, flow, ts,
                          black_level: float, white_level: float, *,
                          res_scalar: int, mode: int, is_hdr: bool,
                          raw_blend: bool = False):
    """Plain PyTorch version of K2: ops/warp.warp_frame for each t of the (T,)
    float32 vector ts, stacked to (T, H, W) / (T, H/2, W)."""
    _check_mode(mode, raw_blend)
    dim_y, dim_x = src12_y.shape
    out_y = torch.empty((len(ts), dim_y, dim_x), dtype=src12_y.dtype, device=flow.device)
    out_uv = torch.empty((len(ts), dim_y // 2, dim_x), dtype=src12_y.dtype, device=flow.device)
    for i, t in enumerate(ts):
        # Same-dtype copies: on CUDA, a memcpy for uint16 too.
        out_y[i], out_uv[i] = warp_ops.warp_frame(
            src12_y, src12_uv, src21_y, src21_uv, flow, t, black_level, white_level,
            res_scalar=res_scalar, mode=mode, is_hdr=is_hdr, raw_blend=raw_blend)
    return out_y, out_uv


def _check_mode(mode, raw_blend):
    if mode not in KERNEL_MODES:
        raise ValueError(f"K2 computes output modes {KERNEL_MODES}, not {mode}")
    if raw_blend and mode != 2:
        raise ValueError("raw_blend is a variant of mode 2")


def _check(src12_y, src12_uv, src21_y, src21_uv, flow, ts, *, mode, is_hdr, raw_blend):
    _check_mode(mode, raw_blend)
    dtype = torch.uint16 if is_hdr else torch.uint8
    dim_y, dim_x = src12_y.shape
    if dim_y % 2 or dim_x % 2:
        raise ValueError(f"frame dims must be even, got {dim_y}x{dim_x}")
    for name, t, shape in (("src12_y", src12_y, (dim_y, dim_x)),
                           ("src12_uv", src12_uv, (dim_y // 2, dim_x)),
                           ("src21_y", src21_y, (dim_y, dim_x)),
                           ("src21_uv", src21_uv, (dim_y // 2, dim_x))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if flow.dtype != torch.int16 or flow.dim() != 3 or flow.shape[0] != 2:
        raise ValueError(f"flow: expected (2, low_h, low_w) int16, got "
                         f"{tuple(flow.shape)} {flow.dtype}")
    if ts.dtype != torch.float32 or ts.dim() != 1 or ts.shape[0] < 1:
        raise ValueError(f"ts: expected a (T,) float32 vector, got "
                         f"{tuple(ts.shape)} {ts.dtype}")
    tensors = (src12_y, src12_uv, src21_y, src21_uv, flow, ts)
    if any(t.device != flow.device for t in tensors):
        raise ValueError("warp_frames: all tensors must be on one device")
    return tensors


def warp_frames(src12_y, src12_uv, src21_y, src21_uv, flow, ts,
                black_level: float, white_level: float, *,
                res_scalar: int, mode: int, is_hdr: bool, raw_blend: bool = False):
    """K2 wrapper: (T,) blending scalars -> ((T, H, W), (T, H/2, W)) outputs,
    bit-identical to warp_frames_reference. Sources are uint8 (SDR) or uint16
    (HDR); flow is (2, low_h, low_w) int16; levels are in sample units (HDR
    pre-scaled x256). Mode 3 reads the UV sources' shapes only, mode 4 no
    source (its T outputs are the same; a caller may pass one t). Launches the
    CUDA kernel for CUDA tensors (on the current stream, no synchronisation);
    CPU tensors take the plain version."""
    tensors = _check(src12_y, src12_uv, src21_y, src21_uv, flow, ts,
                     mode=mode, is_hdr=is_hdr, raw_blend=raw_blend)
    if flow.device.type == "cpu":
        return warp_frames_reference(src12_y, src12_uv, src21_y, src21_uv, flow, ts,
                                     black_level, white_level, res_scalar=res_scalar,
                                     mode=mode, is_hdr=is_hdr, raw_blend=raw_blend)
    dim_y = src12_y.shape[0]
    out = _launch(tensors, black_level, white_level, (0, dim_y, 0, dim_y // 2),
                  res_scalar=res_scalar, mode=mode, is_hdr=is_hdr, raw_blend=raw_blend,
                  name="warp_frames")
    _count(warp_frames, mode, raw_blend)
    return out


warp_frames.launches = 0
warp_frames.mode3_launches = 0
warp_frames.viz_launches = 0
warp_frames.raw_launches = 0


def _count(wrapper, mode, raw_blend):
    """One launch on the wrapper's counter of its variant."""
    if raw_blend:
        wrapper.raw_launches += 1
    elif mode == 3:
        wrapper.mode3_launches += 1
    elif mode >= 4:
        wrapper.viz_launches += 1
    else:
        wrapper.launches += 1


def _launch(tensors, black_level, white_level, band, *, res_scalar, mode, is_hdr,
            raw_blend, name):
    """Launch csrc/warp_frame.cu on checked CUDA tensors for the row band
    (row0_y, rows_y, row0_uv, rows_uv): outputs (T, rows_y, W), (T, rows_uv, W)."""
    src12_y, src12_uv, src21_y, src21_uv, flow, ts = tensors
    if flow.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {flow.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: all tensors must be contiguous")
    dim_y, dim_x = src12_y.shape
    n_t = ts.shape[0]
    _, rows_y, _, rows_uv = band
    out_y = src12_y.new_empty((n_t, rows_y, dim_x))
    out_uv = src12_y.new_empty((n_t, rows_uv, dim_x))
    _build.launch("hrt_warp_frames", flow.get_device(),
                  src12_y.data_ptr(), src12_uv.data_ptr(), src21_y.data_ptr(),
                  src21_uv.data_ptr(), flow.data_ptr(), ts.data_ptr(), n_t,
                  out_y.data_ptr(), out_uv.data_ptr(), dim_y, dim_x, *band,
                  flow.shape[1], flow.shape[2], res_scalar, mode, int(raw_blend), int(is_hdr),
                  float(black_level), float(white_level))
    return out_y, out_uv


def warp_frames_band_reference(src12_y, src12_uv, src21_y, src21_uv, flow, ts,
                               black_level: float, white_level: float, *,
                               res_scalar: int, mode: int, is_hdr: bool,
                               num_shards: int, shard_index: int, raw_blend: bool = False):
    """Plain PyTorch version of K2's mesh-sharded variant: ops/warp.warp_frame_plane
    with row_offset/out_rows for each t (ops/warp.warp_frame_rows), padded with
    0 to band_rows(plane_h, num_shards) rows."""
    _check_mode(mode, raw_blend)
    return warp_ops.warp_frame_rows(src12_y, src12_uv, src21_y, src21_uv, flow, ts,
                                    black_level, white_level, res_scalar=res_scalar,
                                    mode=mode, is_hdr=is_hdr, num_shards=num_shards,
                                    shard_index=shard_index, raw_blend=raw_blend)


def warp_frames_band(src12_y, src12_uv, src21_y, src21_uv, flow, ts,
                     black_level: float, white_level: float, *,
                     res_scalar: int, mode: int, is_hdr: bool,
                     num_shards: int, shard_index: int, raw_blend: bool = False):
    """K2's mesh-sharded variant: shard shard_index of num_shards computes plane
    rows [s * r, (s + 1) * r) of Y and of UV, r = ops/warp.band_rows(plane_h,
    num_shards) for each plane apart, into (T, r_y, W) and (T, r_uv, W). Rows
    past the plane are 0. Bit-identical to warp_frames_band_reference, and the
    shards' bands stacked and cropped equal warp_frames (raw_blend too).
    Launches the CUDA kernel for CUDA tensors; CPU tensors take the plain
    version."""
    tensors = _check(src12_y, src12_uv, src21_y, src21_uv, flow, ts,
                     mode=mode, is_hdr=is_hdr, raw_blend=raw_blend)
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"warp_frames_band: shard {shard_index} of {num_shards}")
    if flow.device.type == "cpu":
        return warp_frames_band_reference(src12_y, src12_uv, src21_y, src21_uv, flow, ts,
                                          black_level, white_level, res_scalar=res_scalar,
                                          mode=mode, is_hdr=is_hdr, num_shards=num_shards,
                                          shard_index=shard_index, raw_blend=raw_blend)
    dim_y = src12_y.shape[0]
    r_y = warp_ops.band_rows(dim_y, num_shards)
    r_uv = warp_ops.band_rows(dim_y // 2, num_shards)
    out_y, out_uv = _launch(tensors, black_level, white_level,
                            (shard_index * r_y, r_y, shard_index * r_uv, r_uv),
                            res_scalar=res_scalar, mode=mode, is_hdr=is_hdr, raw_blend=raw_blend,
                            name="warp_frames_band")
    # The kernel writes no row past the plane: zero them, as the plain version.
    for out, plane_h, r in ((out_y, dim_y, r_y), (out_uv, dim_y // 2, r_uv)):
        valid = max(0, plane_h - shard_index * r)
        if valid < r:
            out[:, valid:].view(torch.uint8).zero_()
    _count(warp_frames_band, mode, raw_blend)
    return out_y, out_uv


warp_frames_band.launches = 0
warp_frames_band.mode3_launches = 0
warp_frames_band.viz_launches = 0
warp_frames_band.raw_launches = 0
