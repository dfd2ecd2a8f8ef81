"""The plain warp, blend, levels, HSV flow colour (output mode 3) and the
levelled passthrough copy, in plain PyTorch on any device.

A frozen copy of the port's plain versions (hopperrender_tpu_torch/ops/
warp.py: warp_frame_plane in modes 0-3, copy_frame, with _fma_f32 and the
fdlibm _atan2f) as the benchmark was written. They follow the reference's
warpFrameKernel and copyFrameKernel (warpFrameKernelSDR.h:23-184,
copyFrameKernelSDR.h:12-25) in C float semantics: float32 arithmetic,
(int)round() half away from zero, float -> int truncating toward zero,
1 - t formed in float32.

The port is held bit for bit to the JAX package compiled by XLA, which
contracts the blend, the UV levels and the colour's YUV sums into fused
multiply-adds; `_fma_f32` computes one exactly. (A copy of the JAX package's
NumPy golden model, which forms 1 - t in float64 and contracts nothing,
would disagree with a correct port by one unit on thousands of samples.)

`blend_precision` exists for the check's control only: "bf16" computes the
blend in bfloat16 and "nofma" rounds its product and sum apart, each a step
below what the configuration states. The benchmark's own comparison always
takes "f32".
"""

from __future__ import annotations

import torch

from hrbench.reference.flow import to_int32

F32 = torch.float32
F64 = torch.float64
BLEND_PRECISIONS = ("f32", "nofma", "bf16")


def from_int32(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.uint16:
        return x.to(torch.int16).view(torch.uint16)
    return x.to(dtype)


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding: the float64 product is exact, the
    float64 sum is rounded to odd (TwoSum's error steps an inexact sum with
    an even last bit one ulp toward it), then to nearest in float32 (Boldo &
    Melquiond, "Emulation of FMA and correctly rounded sums", 2008)."""
    x = a.to(F64) * b.to(F64)
    y = c.to(F64)
    s = x + y
    bb = s - x
    err = (x - (s - bb)) + (y - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(F64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(F32)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=device)


def _f32_bits(bits: int) -> float:
    return torch.tensor(bits, dtype=torch.int32).view(F32).item()


def _mirror_warp(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """Remapping mirror clamped to [1, dim-2] (warpFrameKernelSDR.h:12-20)."""
    res = torch.where(pos >= dim - 1, pos - (pos - (dim - 2)) * 2,
                      torch.where(pos < 1, -pos + 1, pos))
    return res.clamp(1, dim - 2)


def _round_c(x: torch.Tensor) -> torch.Tensor:
    """C round(): half away from zero (warpFrameKernelSDR.h:167)."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5)).to(torch.int32)


def _peak(is_hdr: bool) -> float:
    return 65535.0 if is_hdr else 255.0


def _levels_y(value, black, white, is_hdr: bool) -> torch.Tensor:
    peak = _peak(is_hdr)
    v = (value.to(F32) - black) / (white - black) * peak
    return torch.trunc(v.clamp(0.0, peak)).to(torch.int32)


def _levels_uv(value, white, is_hdr: bool) -> torch.Tensor:
    peak = _peak(is_hdr)
    mid = 32768.0 if is_hdr else 128.0
    q = (value.to(F32) - mid) / white
    v = _fma_f32(q, q.new_tensor(peak), q.new_tensor(mid))
    return torch.trunc(v.clamp(0.0, peak)).to(torch.int32)


# -- the HSV flow colour of mode 3 -----------------------------------------------
# XLA's compilation, step by step: glibc's atan2f (fdlibm in float32); (angle
# / 360) * 6 folded into angle * float32(1/60); r / 255 into r * float32(1/255);
# the YUV sums contracted into FMAs:
#   Y = fma(b, .114, fma(g, .587, r * .299))
#   U = fma(b, .5, fma(g, -.331264, r * -.168736)) + 128
#   V = fma(b, -.081312, fma(r, .5, g * -.418688)) + 128.

_INV60 = _f32_bits(0x3C888889)
_INV255 = _f32_bits(0x3B808081)
_ATAN_HI = (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01, 1.5707962513e+00)
_ATAN_LO = (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08, 7.5497894159e-08)
_AT = (3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01, -1.1111110449e-01,
       9.0908870101e-02, -7.6918758452e-02, 6.6610731184e-02, -5.8335702866e-02,
       4.9768779427e-02, -3.6531571299e-02, 1.6285819933e-02)
_PI, _PI_LO, _PI_O_2 = 3.1415927410e+00, -8.7422776573e-08, 1.5707963705e+00


def _atanf(x: torch.Tensor) -> torch.Tensor:
    """fdlibm atanf for finite float32 x, one rounding per operation."""
    k = lambda v: _f32(v, x.device)  # noqa: E731
    hx = x.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    ax = x.abs()
    one = k(1.0)
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
    inf_hi = hi[3] + lo[3]
    return torch.where(ix >= 0x4C000000, torch.where(hx > 0, inf_hi, -inf_hi), res)


def _atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """fdlibm atan2f (glibc's atan2f) for finite float32 y, x."""
    k = lambda v: _f32(v, x.device)  # noqa: E731
    pi, pi_lo, pi_o_2 = k(_PI), k(_PI_LO), k(_PI_O_2)
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)
    z = _atanf((y / x).abs())
    e = (iy - ix) >> 23
    z = torch.where(e > 60, pi_o_2 + k(0.5) * pi_lo, torch.where((hx < 0) & (e < -60), k(0.0), z))
    r = torch.where(m == 0, z, torch.where(m == 1, -z, torch.where(
        m == 2, pi - (z - pi_lo), (z - pi_lo) - pi)))
    r = torch.where(iy == 0, torch.where(m <= 1, y, torch.where(m == 2, pi, -pi)), r)
    r = torch.where((ix == 0) & (iy != 0), torch.where(hy < 0, -pi_o_2, pi_o_2), r)
    return torch.where(hx == 0x3F800000, _atanf(y), r)


def _visualize_flow(offset_x, offset_y, curr_pixel, channel, res_impact: int,
                    is_hdr: bool) -> torch.Tensor:
    """The HSV colour of a flow over the blended sample (warpFrameKernelSDR.h:23-113)."""
    dev = offset_x.device
    k = lambda v: _f32(v, dev)  # noqa: E731
    ox = offset_x.to(torch.int32)
    oy = offset_y.to(torch.int32)
    no_flow = (ox.abs() < 1) & (oy.abs() < 1)
    angle = _atan2f(oy.to(F32), ox.to(F32)) * (k(180.0) / k(3.14159274101257324))
    angle = torch.where(angle < 0, angle + k(360.0), angle)
    angle = torch.where(angle >= 360.0, angle - k(360.0), angle)
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
    if is_hdr:  # (warpFrameKernelHDR.h:107-111)
        y_out, u_out, v_out = (y_val << 7) + (curr >> 1), u_val << 8, v_val << 8
    else:
        y_out, u_out, v_out = (y_val >> 1) + (curr >> 1), u_val, v_val
    return torch.where(channel == 0, y_out, torch.where(channel == 1, u_out, v_out))


# -- the warp ---------------------------------------------------------------------

def _flow_cells(cx, cy, *, res_scalar: int, cz: int, low_h: int, low_w: int):
    """The flow cell of plane positions (cx, cy) (warpFrameKernelSDR.h:153-158)."""
    if cz:
        scaled_cx = (cx >> res_scalar) & ~1
        scaled_cy = (cy >> res_scalar) << 1
    else:
        scaled_cx = cx >> res_scalar
        scaled_cy = cy >> res_scalar
    return scaled_cx.clamp(0, low_w - 1).long(), scaled_cy.clamp(0, low_h - 1).long()


def _blend(v12, v21, fs12, precision: str) -> torch.Tensor:
    """trunc(v12 * (1 - t) + v21 * t) as int32, as XLA contracts it:
    fma(v12, 1 - t, v21 * t); the control's lower precisions otherwise."""
    fs21 = _f32(1.0, fs12.device) - fs12
    if precision == "f32":
        mixed = _fma_f32(v12.to(F32), fs21, v21.to(F32) * fs12)
    elif precision == "nofma":
        mixed = v12.to(F32) * fs21 + v21.to(F32) * fs12
    elif precision == "bf16":
        bf = torch.bfloat16
        mixed = (v12.to(bf) * fs21.to(bf) + v21.to(bf) * fs12.to(bf)).to(F32)
    else:
        raise ValueError(f"blend precision {precision!r} is not one of {BLEND_PRECISIONS}")
    return torch.trunc(mixed).to(torch.int32)


def warp_frame_plane(src12_y, src12_uv, src21_y, src21_uv, flow, blending_scalar,
                     black_level, white_level, *, res_scalar: int, mode: int, cz: int,
                     is_hdr: bool, blend_precision: str = "f32") -> torch.Tensor:
    """One plane (cz 0: Y (H, W); cz 1: interleaved UV (H/2, W)) of the warp
    in output mode 0, 1, 2 or 3 (warpFrameKernelSDR.h:116-184)."""
    if mode not in (0, 1, 2, 3):
        raise ValueError(f"the reference warps output modes 0-3, not {mode}")
    dev = flow.device
    dim_x = src12_y.shape[1]
    src12 = src12_y if cz == 0 else src12_uv
    src21 = src21_y if cz == 0 else src21_uv
    plane_h = src12.shape[0]
    fs12 = _f32(blending_scalar, dev)
    fs21 = _f32(1.0, dev) - fs12
    cx = torch.arange(dim_x, dtype=torch.int32, device=dev)[None, :].expand(plane_h, dim_x)
    cy = torch.arange(plane_h, dtype=torch.int32, device=dev)[:, None].expand(plane_h, dim_x)
    low_h, low_w = flow.shape[1:]
    scaled_cx, scaled_cy = _flow_cells(cx, cy, res_scalar=res_scalar, cz=cz,
                                       low_h=low_h, low_w=low_w)
    flow_x = flow[0].to(torch.int32)
    flow_y = flow[1].to(torch.int32)
    off_x12 = flow_x[scaled_cy, scaled_cx]
    off_y12 = flow_y[scaled_cy, scaled_cx]
    back_cy = (scaled_cy - (off_y12 >> res_scalar)).clamp(0, low_h - 1)
    back_cx = (scaled_cx - (off_x12 >> res_scalar)).clamp(0, low_w - 1)
    off_x21 = flow_x[back_cy, back_cx]
    off_y21 = flow_y[back_cy, back_cx]
    y_scale = 0.5 if cz else 1.0
    parity = cx & 1

    def sample(src, off_x, off_y, fs, sign):
        new_cx = _mirror_warp(cx + sign * _round_c(off_x.to(F32) * fs), dim_x)
        new_cy = _mirror_warp(cy + sign * _round_c(off_y.to(F32) * fs * y_scale), plane_h)
        col = (new_cx & ~1) + parity if cz else new_cx
        return to_int32(src)[new_cy.long(), col.long()]

    if mode == 0:
        res = sample(src12, off_x12, off_y12, fs12, 1)
    elif mode == 1:
        res = sample(src21, off_x21, off_y21, fs21, -1)
    else:
        blended = _blend(sample(src12, off_x12, off_y12, fs12, 1),
                         sample(src21, off_x21, off_y21, fs21, -1), fs12, blend_precision)
        if mode == 3:
            neg_x = (-off_x12).to(torch.int16)
            neg_y = (-off_y12).to(torch.int16)
            channel = cz + (cx & 1) if cz else torch.zeros_like(cx)
            blended = _visualize_flow(neg_x, neg_y, blended, channel,
                                      4 if res_scalar <= 2 else 1, is_hdr)
        black, white = _f32(black_level, dev), _f32(white_level, dev)
        res = _levels_uv(blended, white, is_hdr) if cz else _levels_y(blended, black, white,
                                                                        is_hdr)
    return from_int32(res, src12_y.dtype)


def warp_frame(src12_y, src12_uv, src21_y, src21_uv, flow, blending_scalar, black_level,
               white_level, *, res_scalar: int, mode: int, is_hdr: bool,
               blend_precision: str = "f32"):
    """Both planes (y, uv) of one output (opticalFlowCalcSDR.cpp:152-167)."""
    return tuple(
        warp_frame_plane(src12_y, src12_uv, src21_y, src21_uv, flow, blending_scalar,
                         black_level, white_level, res_scalar=res_scalar, mode=mode, cz=cz,
                         is_hdr=is_hdr, blend_precision=blend_precision)
        for cz in (0, 1))


def copy_frame(src_y, src_uv, black_level, white_level, *, is_hdr: bool):
    """The passthrough copy through the levels (copyFrameKernelSDR.h:12-25)."""
    black, white = _f32(black_level, src_y.device), _f32(white_level, src_y.device)
    y = from_int32(_levels_y(to_int32(src_y), black, white, is_hdr), src_y.dtype)
    uv = from_int32(_levels_uv(to_int32(src_uv), white, is_hdr), src_uv.dtype)
    return y, uv
