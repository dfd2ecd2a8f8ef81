"""Warp / copy ops: bidirectional warp + blend with all 7 output modes, levels,
the HSV / grey flow visualisation, and the passthrough copy.

PyTorch port of hopperrender_tpu/ops/warp.py (ref: warpFrameKernelSDR.h:23-184,
copyFrameKernelSDR.h:12-25). C float semantics: float32 arithmetic,
`(int)round()` half away from zero, float -> int truncates toward zero, and
1 - t formed in float32, as the JAX package forms it.

Fused multiply-adds. The JAX package, compiled by XLA, contracts two of its
multiply-adds into FMAs (one rounding instead of two), and its outputs,
including the golden fixtures, carry that rounding:
  * the blend  v12 * (1 - t) + v21 * t  ->  fma(v12, 1 - t, v21 * t);
  * the UV levels  q * peak + mid       ->  fma(q, peak, mid);
  * the YUV sums of the HSV colour (see _visualize_flow).
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
WARP_MODES = (0, 1, 2, 3, 4, 5, 6)


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


def _apply_levels(value: torch.Tensor, black: torch.Tensor, white: torch.Tensor, *,
                  cz: int, is_hdr: bool) -> torch.Tensor:
    """The levels of plane cz (0: Y, 1: UV)."""
    if cz:
        return _apply_levels_uv(value, white, is_hdr)
    return _apply_levels_y(value, black, white, is_hdr)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=device)


def _f32_bits(bits: int) -> float:
    """The float32 whose IEEE bit pattern is `bits`."""
    return torch.tensor(bits, dtype=torch.int32).view(F32).item()


# -- HSV flow colour (mode 3) ---------------------------------------------------
#
# The JAX package's colour is _visualize_flow compiled by XLA for the CPU, and
# the golden fixtures carry that compilation's rounding. Each float step is
# pinned to it (read from XLA's optimized HLO and the x86 code it emits):
#   * atan2 is glibc's atan2f, the fdlibm algorithm in float32, which XLA
#     calls for its atan2: _atan2f below repeats it operation by operation;
#   * XLA folds (angle / 360) * 6 into angle * float32(1/60) and r / 255 into
#     r * float32(1/255);
#   * the mod is an exact fmod of a value in [0, 720): one exact subtraction;
#   * the YUV sums contract into FMAs in this order:
#       Y = fma(b, .114, fma(g, .587, r * .299))
#       U = fma(b, .5, fma(g, -.331264, r * -.168736)) + 128
#       V = fma(b, -.081312, fma(r, .5, g * -.418688)) + 128.
# Every other operation rounds once, as written. tests/test_torch_viz.py holds
# the result to jitted JAX over every (ox, oy) in +-512 and 2**20 random int16
# pairs.

_INV60 = _f32_bits(0x3C888889)     # float32(1/60): XLA's fold of (x / 360) * 6
_INV255 = _f32_bits(0x3B808081)    # float32(1/255): XLA's fold of x / 255

# fdlibm s_atanf.c / e_atan2f.c constants (float32).
_ATAN_HI = (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01, 1.5707962513e+00)
_ATAN_LO = (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08, 7.5497894159e-08)
_AT = (3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01, -1.1111110449e-01,
       9.0908870101e-02, -7.6918758452e-02, 6.6610731184e-02, -5.8335702866e-02,
       4.9768779427e-02, -3.6531571299e-02, 1.6285819933e-02)
_PI, _PI_LO, _PI_O_2 = 3.1415927410e+00, -8.7422776573e-08, 1.5707963705e+00


def _atanf(x: torch.Tensor) -> torch.Tensor:
    """fdlibm atanf for finite float32 x, one float32 rounding per operation."""
    k = lambda v: _f32(v, x.device)  # noqa: E731
    hx = x.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    ax = x.abs()
    one = k(1.0)
    # Argument reduction: id -1 (|x| < 7/16), 0 (< 11/16), 1 (< 19/16),
    # 2 (< 39/16), 3 (otherwise).
    idx = torch.where(ix < 0x3EE00000, -1, torch.where(
        ix < 0x3F300000, 0, torch.where(ix < 0x3F980000, 1, torch.where(ix < 0x401C0000, 2, 3))))
    xr = torch.where(idx == 0, (k(2.0) * ax - one) / (k(2.0) + ax),
                     torch.where(idx == 1, (ax - one) / (ax + one),
                                 torch.where(idx == 2, (ax - k(1.5)) / (one + k(1.5) * ax),
                                             -one / ax)))
    xr = torch.where(idx < 0, x, xr)
    z = xr * xr
    w = z * z
    a = [k(v) for v in _AT]
    s1 = z * (a[0] + w * (a[2] + w * (a[4] + w * (a[6] + w * (a[8] + w * a[10])))))
    s2 = w * (a[1] + w * (a[3] + w * (a[5] + w * (a[7] + w * a[9]))))
    hi = torch.tensor(_ATAN_HI, dtype=F32, device=x.device)
    lo = torch.tensor(_ATAN_LO, dtype=F32, device=x.device)
    i = idx.clamp(min=0).long()
    big = hi[i] - ((xr * (s1 + s2) - lo[i]) - xr)
    res = torch.where(idx < 0, xr - xr * (s1 + s2), torch.where(hx < 0, -big, big))
    inf_hi = hi[3] + lo[3]                                  # |x| >= 2**26
    return torch.where(ix >= 0x4C000000, torch.where(hx > 0, inf_hi, -inf_hi), res)


def _atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """fdlibm atan2f (glibc's atan2f) for finite float32 y, x."""
    k = lambda v: _f32(v, x.device)  # noqa: E731
    pi, pi_lo, pi_o_2 = k(_PI), k(_PI_LO), k(_PI_O_2)
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)      # 2 * sign(x) + sign(y)
    z = _atanf((y / x).abs())
    e = (iy - ix) >> 23                          # exponent difference
    z = torch.where(e > 60, pi_o_2 + k(0.5) * pi_lo, torch.where((hx < 0) & (e < -60), k(0.0), z))
    r = torch.where(m == 0, z, torch.where(m == 1, -z, torch.where(
        m == 2, pi - (z - pi_lo), (z - pi_lo) - pi)))
    r = torch.where(iy == 0, torch.where(m <= 1, y, torch.where(m == 2, pi, -pi)), r)
    r = torch.where((ix == 0) & (iy != 0), torch.where(hy < 0, -pi_o_2, pi_o_2), r)
    return torch.where(hx == 0x3F800000, _atanf(y), r)   # x == 1


def _visualize_flow(offset_x: torch.Tensor, offset_y: torch.Tensor, curr_pixel: torch.Tensor,
                    channel: torch.Tensor, res_impact: int, is_hdr: bool) -> torch.Tensor:
    """HSV flow colour over the blended sample curr_pixel, int32 (ref:
    warpFrameKernelSDR.h:23-113). Inputs broadcast against each other."""
    dev = offset_x.device
    k = lambda v: _f32(v, dev)  # noqa: E731
    ox = offset_x.to(torch.int32)
    oy = offset_y.to(torch.int32)
    no_flow = (ox.abs() < 1) & (oy.abs() < 1)

    angle = _atan2f(oy.to(F32), ox.to(F32)) * (k(180.0) / k(3.14159274101257324))
    angle = torch.where(angle < 0, angle + k(360.0), angle)
    angle = torch.where(angle >= 360.0, angle - k(360.0), angle)     # fmod(angle, 360)
    angle = torch.where(angle < 0, angle + k(360.0), angle)
    hue6 = angle * k(_INV60)
    h_i = hue6.to(torch.int32)
    f = hue6 - h_i.to(F32)
    f255 = torch.trunc(f * k(255.0)).to(torch.int32)
    q255 = torch.trunc((k(1.0) - f) * k(255.0)).to(torch.int32)
    h_mod = (h_i % 6).long()

    def pick(*vals):
        stacked = torch.stack([torch.broadcast_to(torch.as_tensor(v, dtype=torch.int32,
                                                                  device=dev), h_mod.shape)
                               for v in vals])
        return torch.gather(stacked, 0, h_mod[None])[0]

    def sat(v):
        return torch.trunc(v.clamp(0.0, 255.0)).to(torch.int32)

    mag = (ox.abs() + oy.abs()).to(F32)
    imp = k(float(res_impact))
    r = sat(pick(255, q255, 0, 0, f255, 255).to(F32) * k(_INV255) * mag * imp)
    g = sat(pick(f255, 255, 255, q255, 0, 0).to(F32) * k(_INV255) * oy.abs().to(F32)
            * k(2.0) * imp)
    b = sat(pick(0, 0, f255, 255, 255, q255).to(F32) * k(_INV255) * mag * imp)
    rf, gf, bf = (torch.where(no_flow, 0, c).to(F32) for c in (r, g, b))

    y_val = sat(_fma_f32(bf, k(0.114), _fma_f32(gf, k(0.587), rf * k(0.299))))
    u_val = sat(_fma_f32(bf, k(0.5), _fma_f32(gf, k(-0.331264), rf * k(-0.168736)))
                + k(128.0))
    v_val = sat(_fma_f32(bf, k(-0.081312), _fma_f32(rf, k(0.5), gf * k(-0.418688)))
                + k(128.0))

    curr = curr_pixel.to(torch.int32)
    if is_hdr:  # (ref: warpFrameKernelHDR.h:107-111)
        y_out, u_out, v_out = (y_val << 7) + (curr >> 1), u_val << 8, v_val << 8
    else:
        y_out, u_out, v_out = (y_val >> 1) + (curr >> 1), u_val, v_val
    return torch.where(channel == 0, y_out, torch.where(channel == 1, u_out, v_out))


# -- warp -----------------------------------------------------------------------

def flow_cells(cx: torch.Tensor, cy: torch.Tensor, *, res_scalar: int, cz: int,
               low_h: int, low_w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The flow cell (scaled_cx, scaled_cy) of plane coordinates (cx, cy),
    clamped to the flow grid (ref: warpFrameKernelSDR.h:153-158)."""
    if cz:
        scaled_cx = (cx >> res_scalar) & ~1
        scaled_cy = (cy >> res_scalar) << 1
    else:
        scaled_cx = cx >> res_scalar
        scaled_cy = cy >> res_scalar
    return scaled_cx.clamp(0, low_w - 1).long(), scaled_cy.clamp(0, low_h - 1).long()


def warp_samples(src12: torch.Tensor, src21: torch.Tensor, flow: torch.Tensor,
                 cx: torch.Tensor, cy: torch.Tensor, parity, fs12: torch.Tensor, *,
                 res_scalar: int, cz: int, dim_x: int, need12: bool = True,
                 need21: bool = True):
    """The 1->2 and 2->1 samples (int32; None where not needed) of plane
    positions (cx, cy) of one plane (ref: warpFrameKernelSDR.h:153-183). UV
    columns keep the chroma parity `parity` (the output pixel's cx & 1).
    Everything broadcasts, fs12 too (a (T, 1, 1) vector gives T outputs)."""
    plane_h = src12.shape[0]
    low_h, low_w = flow.shape[1:]
    fs21 = _f32(1.0, flow.device) - fs12
    scaled_cx, scaled_cy = flow_cells(cx, cy, res_scalar=res_scalar, cz=cz,
                                      low_h=low_h, low_w=low_w)
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
        new_cy = _mirror_warp(cy + sign * _round_c(off_y.to(F32) * fs * y_scale), plane_h)
        col = (new_cx & ~1) + parity if cz else new_cx
        return to_int32(src)[new_cy.long(), col.long()]

    v12 = sample(src12, off_x12, off_y12, fs12, 1) if need12 else None
    v21 = sample(src21, off_x21, off_y21, fs21, -1) if need21 else None
    return v12, v21


def blend(v12: torch.Tensor, v21: torch.Tensor, fs12: torch.Tensor) -> torch.Tensor:
    """Mode 2's blend trunc(v12 * (1 - t) + v21 * t) as int32, with XLA's
    contraction: fma(v12, 1 - t, v21 * t)."""
    fs21 = _f32(1.0, fs12.device) - fs12
    return torch.trunc(_fma_f32(v12.to(F32), fs21, v21.to(F32) * fs12)).to(torch.int32)


def plane_coords(h: int, w: int, device, row0: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plane coordinates (cx, cy) of the (h, w) rows [row0, row0 + h)."""
    cx = torch.arange(w, dtype=torch.int32, device=device)[None, :].expand(h, w)
    cy = torch.arange(row0, row0 + h, dtype=torch.int32, device=device)[:, None].expand(h, w)
    return cx, cy


def res_impact(res_scalar: int) -> int:
    """Mode 3's colour gain (ref: warpFrameKernelSDR.h:177)."""
    return 4 if res_scalar <= 2 else 1


def hsv_colour(value: torch.Tensor, flow: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor, *,
               res_scalar: int, cz: int, is_hdr: bool) -> torch.Tensor:
    """Mode 3's colour over `value` (int32) at plane positions (cx, cy): the
    negated flow of each pixel's cell, Y on plane 0, U/V by column parity on
    plane 1 (ref: warpFrameKernelSDR.h:172-183)."""
    low_h, low_w = flow.shape[1:]
    scaled_cx, scaled_cy = flow_cells(cx, cy, res_scalar=res_scalar, cz=cz,
                                      low_h=low_h, low_w=low_w)
    neg_x = (-flow[0][scaled_cy, scaled_cx].to(torch.int32)).to(torch.int16)
    neg_y = (-flow[1][scaled_cy, scaled_cx].to(torch.int32)).to(torch.int16)
    channel = cz + (cx & 1) if cz else torch.zeros_like(cx)
    return _visualize_flow(neg_x, neg_y, value, channel, res_impact(res_scalar), is_hdr)


def warp_frame_plane(
    src12_y: torch.Tensor, src12_uv: torch.Tensor,
    src21_y: torch.Tensor, src21_uv: torch.Tensor,
    flow: torch.Tensor,          # (2, low_h, low_w) int16 blurred offsets
    blending_scalar, black_level, white_level, *,
    res_scalar: int, mode: int, cz: int, is_hdr: bool, raw_blend: bool = False,
    row_offset: int = 0, out_rows: int | None = None,
) -> torch.Tensor:
    """One plane (cz=0: Y (H, W); cz=1: interleaved UV (H/2, W)) of the warp
    kernel, every output mode 0-6 (ref: warpFrameKernelSDR.h:116-184).

    raw_blend (mode 2 only): the blend before levels, which mode 3 colours
    (the TPU kernel's raw_blend variant, hopperrender_tpu/ops/warp_band.py).

    out_rows/row_offset compute only plane rows [row_offset, row_offset +
    out_rows), as an (out_rows, W) band: the row split of the mesh. The
    sources stay whole, and the mirror and the flow lookup use the whole
    plane."""
    if mode not in WARP_MODES:
        raise ValueError(f"output mode {mode} is not one of {WARP_MODES}")
    if raw_blend and mode != 2:
        raise ValueError("raw_blend is a variant of mode 2")
    dev = flow.device
    dim_y, dim_x = src12_y.shape
    src12 = src12_y if cz == 0 else src12_uv
    src21 = src21_y if cz == 0 else src21_uv
    plane_h = src12.shape[0]
    dtype = src12_y.dtype
    fs12 = _f32(blending_scalar, dev)
    out_h = plane_h if out_rows is None else out_rows

    cx = torch.arange(dim_x, dtype=torch.int32, device=dev)[None, :].expand(out_h, dim_x)
    cy = torch.arange(row_offset, row_offset + out_h, dtype=torch.int32,
                      device=dev)[:, None].expand(out_h, dim_x)
    adj_cx, adj_cy = cx, cy
    done = torch.zeros((out_h, dim_x), dtype=torch.bool, device=dev)
    early = torch.zeros((out_h, dim_x), dtype=torch.int32, device=dev)

    if mode == 5:  # SideBySide1: left half = source12 passthrough
        left = cx < (dim_x >> 1)
        early = torch.where(left, to_int32(src12)[cy.long(), cx.long()], early)
        done = done | left
    elif mode == 6:  # SideBySide2
        vo = (dim_y >> 2) >> cz
        band = (cy >= vo) & (cy < vo + (dim_y >> (1 + cz)))
        in_left = band & (cx < (dim_x >> 1))
        in_right = band & (cx >= (dim_x >> 1))
        src_rows = ((cy - vo) << 1).clamp(0, plane_h - 1)
        src_cols = ((cx << 1) + ((cx & 1) if cz else 0)).clamp(0, dim_x - 1)
        early = torch.where(in_left, to_int32(src12)[src_rows.long(), src_cols.long()], early)
        outside = ~in_left & ~in_right
        early = torch.where(outside, ((32768 if is_hdr else 128) if cz else 0), early)
        done = done | in_left | outside
        adj_cx = torch.where(in_right, (cx - (dim_x >> 1)) << 1, cx)
        adj_cy = torch.where(in_right, (cy - vo) << 1, cy)

    if mode == 4:  # GreyFlow (ref: warpFrameKernelSDR.h:161-164)
        grey = grey_flow_plane(flow, adj_cx, adj_cy, res_scalar=res_scalar, cz=cz,
                               is_hdr=is_hdr)
        return from_int32(torch.where(done, early, grey), dtype)

    v12, v21 = warp_samples(src12, src21, flow, adj_cx, adj_cy, cx & 1, fs12,
                            res_scalar=res_scalar, cz=cz, dim_x=dim_x,
                            need12=mode != 1, need21=mode != 0)
    if mode == 0:
        res = v12
    elif mode == 1:
        res = v21
    else:
        blended = blend(v12, v21, fs12)
        if raw_blend:
            return from_int32(blended, dtype)
        if mode == 3:   # no mode-6 adjustment here: adj_cx, adj_cy are cx, cy
            blended = hsv_colour(blended, flow, cx, cy, res_scalar=res_scalar, cz=cz,
                                 is_hdr=is_hdr)
        res = _apply_levels(blended, _f32(black_level, dev), _f32(white_level, dev), cz=cz,
                            is_hdr=is_hdr)
    return from_int32(torch.where(done, early, res), dtype)


def grey_flow_plane(flow: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor, *,
                    res_scalar: int, cz: int, is_hdr: bool) -> torch.Tensor:
    """Mode 4 at plane positions (cx, cy), int32: Y is (|ox| + |oy|) << 2
    (<< 10 in HDR) capped at the peak, UV the neutral mid value
    (ref: warpFrameKernelSDR.h:161-164)."""
    if cz:
        return torch.full(cx.shape, 32768 if is_hdr else 128, dtype=torch.int32,
                          device=flow.device)
    low_h, low_w = flow.shape[1:]
    scaled_cx, scaled_cy = flow_cells(cx, cy, res_scalar=res_scalar, cz=0,
                                      low_h=low_h, low_w=low_w)
    ox = flow[0].to(torch.int32)[scaled_cy, scaled_cx]
    oy = flow[1].to(torch.int32)[scaled_cy, scaled_cx]
    return ((ox.abs() + oy.abs()) << (10 if is_hdr else 2)).clamp(max=65535 if is_hdr else 255)


def warp_frame(src12_y, src12_uv, src21_y, src21_uv, flow, blending_scalar,
               black_level, white_level, *, res_scalar: int, mode: int, is_hdr: bool,
               raw_blend: bool = False):
    """Both planes, (y, uv) (ref: opticalFlowCalcSDR.cpp:152-167)."""
    return tuple(
        warp_frame_plane(src12_y, src12_uv, src21_y, src21_uv, flow, blending_scalar,
                         black_level, white_level, res_scalar=res_scalar, mode=mode,
                         cz=cz, is_hdr=is_hdr, raw_blend=raw_blend)
        for cz in (0, 1))


def band_rows(plane_h: int, num_shards: int) -> int:
    """Rows of one shard's band of a plane: ceil(plane_h / num_shards). Y and
    UV are split apart, so UV bands are not half the Y bands."""
    return -(-plane_h // num_shards)


def warp_frame_rows(src12_y, src12_uv, src21_y, src21_uv, flow, ts, black_level,
                    white_level, *, res_scalar: int, mode: int, is_hdr: bool,
                    num_shards: int, shard_index: int, raw_blend: bool = False):
    """Shard shard_index's row band of both planes, for each t of the (T,)
    vector ts: (T, r_y, W) and (T, r_uv, W) with r = band_rows(plane_h,
    num_shards), holding plane rows [shard_index * r, (shard_index + 1) * r).
    Rows past the plane (the last shards of an uneven split) are 0. Any mode
    0-6, and mode 2's raw_blend: warp_frame_plane per t with
    row_offset/out_rows."""
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard {shard_index} of {num_shards}")
    dim_y, dim_x = src12_y.shape
    outs = []
    for cz, plane_h in ((0, dim_y), (1, dim_y // 2)):
        rows = band_rows(plane_h, num_shards)
        row0 = shard_index * rows
        valid = max(0, min(rows, plane_h - row0))
        out = from_int32(torch.zeros((len(ts), rows, dim_x), dtype=torch.int32,
                                     device=flow.device), src12_y.dtype)
        for i, t in enumerate(ts):
            if valid:
                out[i, :valid] = warp_frame_plane(
                    src12_y, src12_uv, src21_y, src21_uv, flow, t, black_level, white_level,
                    res_scalar=res_scalar, mode=mode, cz=cz, is_hdr=is_hdr,
                    raw_blend=raw_blend, row_offset=row0, out_rows=valid)
        outs.append(out)
    return tuple(outs)


def copy_frame(src_y: torch.Tensor, src_uv: torch.Tensor, black_level, white_level, *,
               is_hdr: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Passthrough with levels (ref: copyFrameKernelSDR.h:12-25)."""
    black, white = _f32(black_level, src_y.device), _f32(white_level, src_y.device)
    y = from_int32(_apply_levels_y(to_int32(src_y), black, white, is_hdr), src_y.dtype)
    uv = from_int32(_apply_levels_uv(to_int32(src_uv), white, is_hdr), src_uv.dtype)
    return y, uv
