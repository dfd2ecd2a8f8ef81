"""K2: the batched warp (modes 0/1/2, and mode 2's raw_blend variant) —
wrapper of csrc/warp_frame.cu and its plain version.

Replaces hopperrender_tpu/ops/warp_band.py::warp_frame_band (the TPU kernel)
with a (T,) blending-scalar vector: all T outputs of a source interval come
from one call. raw_blend=True is that kernel's raw_blend variant: mode 2's
blend stored without levels, which mode 3 colours (ops/warp_viz.py).
`warp_frames` launches the CUDA kernel for CUDA tensors and takes the plain
PyTorch version `warp_frames_reference` only for CPU tensors. Its counters:
`warp_frames.launches` (modes 0/1/2) and `warp_frames.raw_launches` (the
raw_blend variant).
"""

from __future__ import annotations

import torch

from hopperrender_tpu_torch import _build
from hopperrender_tpu_torch.ops import warp as warp_ops

KERNEL_MODES = (0, 1, 2)


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
        raise ValueError(f"K2 computes modes {KERNEL_MODES}, not {mode} (modes 3-6 are "
                         "composed from its outputs: ops/warp_viz.py)")
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
    pre-scaled x256). Launches the CUDA kernel for CUDA tensors (on the
    current stream, no synchronisation); CPU tensors take the plain version."""
    tensors = _check(src12_y, src12_uv, src21_y, src21_uv, flow, ts,
                     mode=mode, is_hdr=is_hdr, raw_blend=raw_blend)
    if flow.device.type == "cpu":
        return warp_frames_reference(src12_y, src12_uv, src21_y, src21_uv, flow, ts,
                                     black_level, white_level, res_scalar=res_scalar,
                                     mode=mode, is_hdr=is_hdr, raw_blend=raw_blend)
    if flow.device.type != "cuda":
        raise ValueError(f"warp_frames: unsupported device {flow.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("warp_frames: all tensors must be contiguous")
    dim_y, dim_x = src12_y.shape
    n_t = ts.shape[0]
    out_y = torch.empty((n_t, dim_y, dim_x), dtype=src12_y.dtype, device=flow.device)
    out_uv = torch.empty((n_t, dim_y // 2, dim_x), dtype=src12_y.dtype, device=flow.device)
    lib = _build.load().lib
    with torch.cuda.device(flow.device):
        stream = torch.cuda.current_stream(flow.device).cuda_stream
        code = lib.hrt_warp_frames(
            src12_y.data_ptr(), src12_uv.data_ptr(), src21_y.data_ptr(),
            src21_uv.data_ptr(), flow.data_ptr(), ts.data_ptr(), n_t,
            out_y.data_ptr(), out_uv.data_ptr(), dim_y, dim_x,
            flow.shape[1], flow.shape[2], res_scalar, mode, int(raw_blend), int(is_hdr),
            float(black_level), float(white_level), stream)
    _build.check(code, "warp_frames")
    if raw_blend:
        warp_frames.raw_launches += 1
    else:
        warp_frames.launches += 1
    return out_y, out_uv


warp_frames.launches = 0
warp_frames.raw_launches = 0
