"""The plain flow: cost volume, first-minimum argmin, offset commit, pyramid
loop and the 8x8 flow blur, in plain PyTorch on any device.

A frozen copy of the port's plain versions (hopperrender_tpu_torch/ops/
cost_volume_kernel.py: candidate_reads, delta_sums_reference,
lowest_layer_u32, adjust_reference; ops/blur_kernel.py:
blur_flow_reference; ops/flow.py: window_schedule, pyramid_flow; config.py:
calc_flow_dims and the pyramid's size rules), which follow the reference's
calcDeltaSums, determineLowestLayer, adjustOffsetArray and blurFlow
(opticalFlowCalcSDR.cpp:44-123). It imports nothing of the program, so a
later change to the program's kernels or plain versions is still held to
the arithmetic it had when the benchmark was written.

Integer semantics: int16 offsets wrap (sums in int32 narrowed with
.to(int16)); uint32 window sums wrap (accumulated in int64, low 32 bits
kept); the argmin takes the first minimum; HDR samples compare as
sample >> 8.
"""

from __future__ import annotations

import types

import torch

MAX_SEARCH_RADIUS = 16
FIRST_NEIGHBOR_ITERATION = 4
UINT32_MASK = 0xFFFFFFFF
BLUR_RADIUS = 4


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """Samples as int32 (uint16 through an int16 view: PyTorch's CUDA
    kernels cover uint16 for little more than copies)."""
    if x.dtype == torch.uint16:
        return x.view(torch.int16).to(torch.int32) & 0xFFFF
    return x.to(torch.int32)


def calc_flow_dims(frame_height: int, frame_width: int, max_calc_res: int):
    """(res_scalar, low_h, low_w): the frame halved until its height is at
    most max_calc_res (opticalFlowCalcSDR.cpp:217-222)."""
    res_scalar = 0
    while (frame_height >> res_scalar) > max_calc_res:
        res_scalar += 1
    return (res_scalar, -(-frame_height // (1 << res_scalar)),
            -(-frame_width // (1 << res_scalar)))


def initial_window_size(low_h: int, low_w: int) -> int:
    """next_pow2(max(low_w, low_h)) / 2 (opticalFlowCalcSDR.cpp:48-59)."""
    max_dim = max(low_w, low_h)
    if max_dim and (max_dim & (max_dim - 1)) == 0:
        window = max_dim
    else:
        while max_dim & (max_dim - 1):
            max_dim &= max_dim - 1
        window = max_dim << 1
    return window // 2


def window_schedule(low_h: int, low_w: int, num_iterations: int = 0) -> list[tuple[int, int]]:
    """(iteration, window_size) of each pyramid iteration; 0 iterations means
    log2 of the first window (opticalFlowCalcSDR.cpp:48-65, 110)."""
    window = initial_window_size(low_h, low_w)
    auto = window.bit_length() - 1
    n = auto if num_iterations == 0 or num_iterations > auto else num_iterations
    sched = []
    for it in range(n):
        sched.append((it, window))
        window = max(window >> 1, 1)
    return sched


def _signed_square(rel: torch.Tensor) -> torch.Tensor:
    """rel * |rel| as int16 (calcDeltaSumsKernelSDR.h:73-79)."""
    r = rel.to(torch.int32)
    return (r * r * torch.where(r > 0, 1, -1)).to(torch.int16)


def _mirror_in_frame(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """Single-branch mirror, then clamp (calcDeltaSumsKernelSDR.h:86-95)."""
    m = torch.where(pos >= dim, dim - (pos - dim + 1), torch.where(pos < 0, -pos - 1, pos))
    return m.clamp(0, dim - 1)


def _to_uint32_in_int32(sums: torch.Tensor) -> torch.Tensor:
    return torch.where(sums > 0x7FFFFFFF, sums - (1 << 32), sums).to(torch.int32)


def candidate_reads(f1y, f1uv, offsets, radius: int, *, res_scalar: int, step: int,
                    num_layers: int, layer_offset: int = 0) -> types.SimpleNamespace:
    """The candidates of one pyramid step: their offsets (num_layers, low_h,
    low_w) int16, which cells lie inside the frame, and the flat index of
    every sample read: frame 1's y, u, v per candidate and frame 2's y2, u2,
    v2 per cell (int64)."""
    dim_y, dim_x = f1y.shape
    uv_h, uv_w = f1uv.shape
    low_h, low_w = offsets.shape[1:]
    dev = offsets.device
    cx = torch.arange(low_w, dtype=torch.int32, device=dev)[None, None, :]
    cy = torch.arange(low_h, dtype=torch.int32, device=dev)[None, :, None]
    lz = torch.arange(layer_offset, layer_offset + num_layers, dtype=torch.int32,
                      device=dev)[:, None, None]
    scaled_cx = cx << res_scalar
    scaled_cy = cy << res_scalar
    rel_sq = _signed_square(lz % radius - radius // 2)
    zero = torch.zeros_like(rel_sq)
    rel_x, rel_y = (rel_sq, zero) if step % 2 == 0 else (zero, rel_sq)
    offsets_i = offsets.to(torch.int32)
    offset_x = (offsets_i[0][None] + rel_x).to(torch.int16)
    offset_y = (offsets_i[1][None] + rel_y).to(torch.int16)
    m_cx = _mirror_in_frame(scaled_cx + offset_x.to(torch.int32), dim_x).long()
    m_cy = _mirror_in_frame(scaled_cy + offset_y.to(torch.int32), dim_y).long()
    s_cx = scaled_cx.clamp(0, dim_x - 1)[0].long()
    s_cy = scaled_cy.clamp(0, dim_y - 1)[0].long()

    def uv_reads(yy, xx):
        row = (yy >> 1).clamp(0, uv_h - 1) * uv_w
        return row + (xx & ~1).clamp(0, uv_w - 1), row + ((xx & ~1) + 1).clamp(0, uv_w - 1)

    u, v = uv_reads(m_cy, m_cx)
    u2, v2 = uv_reads(s_cy, s_cx)
    return types.SimpleNamespace(
        offset_x=offset_x, offset_y=offset_y,
        in_frame=(scaled_cx < dim_x) & (scaled_cy < dim_y),
        y=m_cy * dim_x + m_cx, u=u, v=v, y2=s_cy * dim_x + s_cx, u2=u2, v2=v2)


def delta_sums(f1y, f1uv, f2y, f2uv, offsets, radius: int, delta_scalar: int,
               neighbor_scalar: int, *, window_size: int, res_scalar: int, iteration: int,
               step: int, is_hdr: bool, num_layers: int, layer_offset: int = 0) -> torch.Tensor:
    """The window sums of one step (calcDeltaSumsKernelSDR.h:36-191):
    (num_layers, n_win_y, n_win_x) int32 holding uint32, for global layers
    [layer_offset, layer_offset + num_layers); layers >= radius are
    0xFFFFFFFF."""
    low_h, low_w = offsets.shape[1:]
    c = candidate_reads(f1y, f1uv, offsets, radius, res_scalar=res_scalar, step=step,
                        num_layers=num_layers, layer_offset=layer_offset)
    shift = 8 if is_hdr else 0
    f1y_i, f2y_i, f1uv_i, f2uv_i = (to_int32(f).reshape(-1) >> shift
                                    for f in (f1y, f2y, f1uv, f2uv))
    delta = ((f1y_i[c.y] - f2y_i[c.y2][None]).abs()
             + (f1uv_i[c.u] - f2uv_i[c.u2][None]).abs()
             + (f1uv_i[c.v] - f2uv_i[c.v2][None]).abs()).to(torch.int64)
    delta = torch.where(c.in_frame, delta << delta_scalar, 0)
    active = c.offset_x if step == 0 else c.offset_y
    total = delta + active.to(torch.int64).abs()
    if iteration >= FIRST_NEIGHBOR_ITERATION:
        dev = offsets.device
        plane = offsets.to(torch.int32)[0 if step == 0 else 1]
        active_i = active.to(torch.int32)
        nb = torch.zeros((num_layers, low_h, low_w), dtype=torch.int64, device=dev)
        # down, right, left, up at +-2*windowSize, edge-clamped
        # (calcDeltaSumsKernelSDR.h:112-131).
        for dx, dy in ((0, 2 * window_size), (2 * window_size, 0),
                       (-2 * window_size, 0), (0, -2 * window_size)):
            if dy:
                idx = (torch.arange(low_h, device=dev) + dy).clamp(0, low_h - 1)
                n_off = plane[idx, :][None]
            else:
                idx = (torch.arange(low_w, device=dev) + dx).clamp(0, low_w - 1)
                n_off = plane[:, idx][None]
            nb = nb + (n_off - active_i).abs()
        total = total + (nb << neighbor_scalar)
    n_win_y = -(-low_h // window_size)
    n_win_x = -(-low_w // window_size)
    padded = torch.nn.functional.pad(
        total, (0, n_win_x * window_size - low_w, 0, n_win_y * window_size - low_h))
    sums = padded.reshape(num_layers, n_win_y, window_size, n_win_x, window_size).sum(
        dim=(2, 4)) & UINT32_MASK
    lz = torch.arange(layer_offset, layer_offset + num_layers, device=sums.device)
    return _to_uint32_in_int32(torch.where(lz[:, None, None] < radius, sums, UINT32_MASK))


def lowest_layer(sums: torch.Tensor, radius: int) -> torch.Tensor:
    """Per window, the first minimum over layers [0, radius), compared as
    uint32 (determineLowestLayerKernelSDR.h:16-27)."""
    scan = sums[:min(radius, sums.shape[0])].to(torch.int64) & UINT32_MASK
    return torch.argmin(scan, dim=0).to(torch.int32)


def adjust_offsets(offsets: torch.Tensor, winners: torch.Tensor, radius: int, *,
                   window_size: int, step: int) -> torch.Tensor:
    """Commit each window's winning candidate to plane step & 1
    (adjustOffsetArrayKernelSDR.h:11-20)."""
    low_h, low_w = offsets.shape[1:]
    adj = _signed_square(winners % radius - radius // 2)
    adj_full = adj.repeat_interleave(window_size, 0).repeat_interleave(window_size, 1)
    adj_full = adj_full[:low_h, :low_w]
    plane = step & 1
    out = offsets.clone()
    out[plane] = (offsets[plane].to(torch.int32) + adj_full.to(torch.int32)).to(torch.int16)
    return out


def _symmetric_index(n: int, dim: int, device) -> torch.Tensor:
    pos = torch.arange(-BLUR_RADIUS, n + BLUR_RADIUS - 1, device=device) % (2 * dim)
    return torch.where(pos < dim, pos, 2 * dim - 1 - pos)


def blur_flow(offsets: torch.Tensor) -> torch.Tensor:
    """(2, low_h, low_w) int16: the box sum over the mirrored [-4, 4) x
    [-4, 4) window, divided by 64 truncating (blurFlowKernelSDR.h:3-91)."""
    _, low_h, low_w = offsets.shape
    iy = _symmetric_index(low_h, low_h, offsets.device)
    ix = _symmetric_index(low_w, low_w, offsets.device)
    padded = offsets.to(torch.int32)[:, iy][:, :, ix]
    k = 2 * BLUR_RADIUS
    rows = sum(padded[:, :, kx:kx + low_w] for kx in range(k))
    acc = sum(rows[:, ky:ky + low_h, :] for ky in range(k))
    return torch.div(acc, 64, rounding_mode="trunc").to(torch.int16)


def pyramid_flow(f1y, f1uv, f2y, f2uv, radius: int, delta_scalar: int, neighbor_scalar: int,
                 *, low_h: int, low_w: int, res_scalar: int, is_hdr: bool,
                 num_iterations: int = 0) -> torch.Tensor:
    """The blurred flow of one frame pair (opticalFlowCalcSDR.cpp:44-123):
    every iteration's two steps from zero offsets, then the blur."""
    offsets = torch.zeros((2, low_h, low_w), dtype=torch.int16, device=f1y.device)
    for iteration, window in window_schedule(low_h, low_w, num_iterations):
        for step in (0, 1):
            sums = delta_sums(f1y, f1uv, f2y, f2uv, offsets, radius, delta_scalar,
                              neighbor_scalar, window_size=window, res_scalar=res_scalar,
                              iteration=iteration, step=step, is_hdr=is_hdr, num_layers=radius)
            offsets = adjust_offsets(offsets, lowest_layer(sums, radius), radius,
                                     window_size=window, step=step)
    return blur_flow(offsets)


def frame_delta(f1y, f1uv, f2y, f2uv, radius: int, delta_scalar: int, neighbor_scalar: int, *,
                low_h: int, low_w: int, res_scalar: int, is_hdr: bool,
                num_iterations: int = 0) -> int:
    """The scene-change scalar of a pair: window (0, 0) of layer
    radius // 2 - 1 at the first step, from zero offsets, divided (truncating)
    by low_h * low_w * 10 (SDR) or 6 (HDR) (opticalFlowCalcSDR.cpp:91-94,
    opticalFlowCalcHDR.cpp:93)."""
    _, window = window_schedule(low_h, low_w, num_iterations)[0]
    offsets = torch.zeros((2, low_h, low_w), dtype=torch.int16, device=f1y.device)
    sums = delta_sums(f1y, f1uv, f2y, f2uv, offsets, radius, delta_scalar, neighbor_scalar,
                      window_size=window, res_scalar=res_scalar, iteration=0, step=0,
                      is_hdr=is_hdr, num_layers=1, layer_offset=radius // 2 - 1)
    raw = int(sums[0, 0, 0].item()) & UINT32_MASK
    return raw // (low_h * low_w * (6 if is_hdr else 10))
