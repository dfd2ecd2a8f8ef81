"""NV12 / P010 frame packing.

The PyTorch port's own copy of hopperrender_tpu/vio/nv12.py (the port imports
nothing of the JAX package); tests/test_torch_control.py holds the two
to the same behaviour.

The reference consumes NV12 (8-bit) and P010 (10-bit-in-16, MSB-aligned) buffers laid
out as a Y plane of `height` rows of `stride` samples followed by an interleaved UV
plane of `height/2` rows (ref: HopperRender.cpp:38-61; plane indexing in
calcDeltaSumsKernelSDR.h:98-100). The TPU engine works on tight planar (y, uv) arrays;
stride handling happens here at ingest/egress (SURVEY.md §7 "Strides"), never inside
kernels.

Strides are in SAMPLES (1 byte NV12, 2 bytes P010), matching the reference's
biWidth-based stride (ref: HopperRender.cpp:740-758).
"""

from __future__ import annotations

import numpy as np


def unpack(buf, height: int, width: int, stride: int | None = None, *, is_hdr: bool = False):
    """Split a packed NV12/P010 buffer into tight (y, uv) planes.

    buf: bytes/bytearray/ndarray with y-plane (height*stride samples) followed by the
    interleaved uv-plane (height/2 * stride samples).
    """
    if height % 2 or width % 2:
        raise ValueError("NV12/P010 requires even dimensions")
    stride = stride or width
    if stride < width:
        raise ValueError(f"stride {stride} < width {width}")
    dtype = np.dtype(np.uint16) if is_hdr else np.dtype(np.uint8)
    flat = np.frombuffer(buf, dtype=dtype) if not isinstance(buf, np.ndarray) else buf.view(dtype).ravel()
    need = height * stride + (height // 2) * stride
    if flat.size < need:
        raise ValueError(f"buffer too small: {flat.size} < {need} samples")
    y = flat[: height * stride].reshape(height, stride)[:, :width]
    uv = flat[height * stride : need].reshape(height // 2, stride)[:, :width]
    return np.ascontiguousarray(y), np.ascontiguousarray(uv)


def pack(y: np.ndarray, uv: np.ndarray, stride: int | None = None) -> np.ndarray:
    """Pack tight (y, uv) planes into one NV12/P010 buffer with the given output
    stride (ref: output-stride handling HopperRender.cpp:851-865)."""
    height, width = y.shape
    if uv.shape != (height // 2, width):
        raise ValueError(f"uv plane shape {uv.shape} does not match y {y.shape}")
    stride = stride or width
    if stride < width:
        raise ValueError(f"stride {stride} < width {width}")
    out = np.zeros((height + height // 2, stride), dtype=y.dtype)
    out[:height, :width] = y
    out[height:, :width] = uv
    return out.ravel()


def frame_size_samples(height: int, stride: int) -> int:
    """Total samples in a packed frame: 1.5 * height * stride
    (ref: opticalFlowCalcSDR.cpp:20)."""
    return height * stride + (height // 2) * stride


def synthetic_frame(rng: np.random.Generator, height: int, width: int, *,
                    is_hdr: bool = False, motion_x: int = 0,
                    coherent: bool = False):
    """Test/bench helper: textured frame pair generator input (shifted sampling
    window gives coherent global motion).

    coherent=True shifts the NOISE together with the texture (one fixed-seed
    noise canvas windowed like the texture, |motion_x| <= 64) — a true pan, as
    real panning video behaves; the default regenerates noise per call
    (frames share only the texture — adversarial for flow convergence)."""
    dtype = np.uint16 if is_hdr else np.uint8
    peak = 65535 if is_hdr else 255
    if coherent:
        # Canvas sized so the FULL +/-64 range maps to distinct windows (a
        # plain `% 64` would alias motion_x == +/-64 to zero motion).
        assert abs(motion_x) <= 64
        canvas = width + 128
        yy, xx = np.mgrid[0:height, 0:canvas]
        tex = ((np.sin(xx * 0.17) + np.cos(yy * 0.23)
                + np.sin((xx + yy) * 0.05)) + 3) / 6
        noise = np.random.default_rng(0x5EED).random((height, canvas)) * 0.1
        full_y = ((tex + noise) / 1.1 * peak).astype(dtype)
        full_uv = ((tex[::2] + noise[::2]) / 1.1 * peak).astype(dtype)
        x = motion_x + 64
        return full_y[:, x:x + width].copy(), full_uv[:, x:x + width].copy()
    yy, xx = np.mgrid[0:height, 0:width + abs(motion_x)]
    tex = ((np.sin(xx * 0.17) + np.cos(yy * 0.23) + np.sin((xx + yy) * 0.05)) + 3) / 6
    noise = rng.random((height, width + abs(motion_x))) * 0.1
    y_full = ((tex + noise) / 1.1 * peak).astype(dtype)
    uv_full = ((tex[::2] + noise[::2]) / 1.1 * peak).astype(dtype)
    x0 = abs(motion_x) if motion_x < 0 else 0
    x = x0 + motion_x if motion_x < 0 else motion_x
    return y_full[:, x:x + width].copy(), uv_full[:, x:x + width].copy()
