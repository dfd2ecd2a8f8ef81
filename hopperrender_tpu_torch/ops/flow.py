"""Flow calculation: cost volume, layer argmin, offset adjust, pyramid loop.

PyTorch port of hopperrender_tpu/ops/flow.py (the reference formulation of
calcDeltaSums / determineLowestLayer / adjustOffsetArray / the pyramid loop,
ref: opticalFlowCalcSDR.cpp:44-123). The cost volume is plain PyTorch, as the
JAX package runs it in XLA; the blur is kernel K1 (ops/blur_kernel.py).

Integer semantics follow the reference exactly:
  * int16 offsets wrap: sums are formed in int32 and narrowed with .to(int16);
  * uint32 window sums wrap: the cost volume accumulates in int64 (every step
    is an add or a left shift, so the result mod 2**32 is the same) and is
    masked with & 0xFFFFFFFF before the argmin;
  * torch.argmin returns the first minimum, the reference's strict `<` scan;
  * HDR samples compare as sample >> 8, shifted in int32 (uint16 has no >>).
The search radius, delta and neighbor scalars are plain ints: PyTorch runs
eagerly, so nothing is traced or recompiled when the auto scaler moves them.
"""

from __future__ import annotations

import torch

from hopperrender_tpu_torch import config
from hopperrender_tpu_torch.ops import blur_kernel
from hopperrender_tpu_torch.ops.warp import to_int32

MAX_R = config.MAX_SEARCH_RADIUS
UINT32_MASK = 0xFFFFFFFF


def _signed_square(rel: torch.Tensor) -> torch.Tensor:
    """rel * |rel| as int16 (ref: calcDeltaSumsKernelSDR.h:73-79)."""
    r = rel.to(torch.int32)
    return (r * r * torch.where(r > 0, 1, -1)).to(torch.int16)


def _mirror_in_frame(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """Single-branch mirror + clamp (ref: calcDeltaSumsKernelSDR.h:86-95)."""
    m = torch.where(pos >= dim, dim - (pos - dim + 1), torch.where(pos < 0, -pos - 1, pos))
    return m.clamp(0, dim - 1)


def delta_window_sums(
    f1y: torch.Tensor, f1uv: torch.Tensor, f2y: torch.Tensor, f2uv: torch.Tensor,
    offsets: torch.Tensor,   # (2, low_h, low_w) int16
    radius: int, delta_scalar: int, neighbor_scalar: int, *,
    window_size: int, res_scalar: int, iteration: int, step: int, is_hdr: bool,
    num_layers: int = MAX_R, layer_offset: int = 0,
) -> torch.Tensor:
    """Compact cost-volume window sums, (num_layers, n_win_y, n_win_x) int64
    holding uint32 values; global layers >= radius are 0xFFFFFFFF.

    num_layers/layer_offset shard the search-layer axis: a shard computes
    global layers [layer_offset, layer_offset + num_layers)."""
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
    offset_x = (offsets_i[0][None] + rel_x).to(torch.int16)  # int16, wraps
    offset_y = (offsets_i[1][None] + rel_y).to(torch.int16)

    new_cx = scaled_cx + offset_x.to(torch.int32)
    new_cy = scaled_cy + offset_y.to(torch.int32)
    in_frame = (scaled_cx < dim_x) & (scaled_cy < dim_y)

    m_cx = _mirror_in_frame(new_cx, dim_x)
    m_cy = _mirror_in_frame(new_cy, dim_y)
    s_cx = scaled_cx.clamp(0, dim_x - 1)[0]
    s_cy = scaled_cy.clamp(0, dim_y - 1)[0]

    shift = 8 if is_hdr else 0
    f1y_i, f2y_i, f1uv_i, f2uv_i = (to_int32(f) >> shift for f in (f1y, f2y, f1uv, f2uv))

    def uv_idx(yy, xx):
        return ((yy >> 1).clamp(0, uv_h - 1), (xx & ~1).clamp(0, uv_w - 1),
                ((xx & ~1) + 1).clamp(0, uv_w - 1))

    m_uy, m_ux, m_vx = uv_idx(m_cy, m_cx)
    s_uy, s_ux, s_vx = uv_idx(s_cy, s_cx)
    s_cy, s_cx = s_cy.long(), s_cx.long()
    s_uy, s_ux, s_vx = s_uy.long(), s_ux.long(), s_vx.long()
    m_cy, m_cx = m_cy.long(), m_cx.long()
    m_uy, m_ux, m_vx = m_uy.long(), m_ux.long(), m_vx.long()

    # frame2 samples are layer-independent (the source pixel grid).
    delta = ((f1y_i[m_cy, m_cx] - f2y_i[s_cy, s_cx][None]).abs()
             + (f1uv_i[m_uy, m_ux] - f2uv_i[s_uy, s_ux][None]).abs()
             + (f1uv_i[m_uy, m_vx] - f2uv_i[s_uy, s_vx][None]).abs()).to(torch.int64)
    delta = torch.where(in_frame, delta << delta_scalar, 0)

    active = offset_x if step == 0 else offset_y
    total = delta + active.to(torch.int64).abs()

    if iteration >= config.FIRST_NEIGHBOR_ITERATION:
        plane = offsets_i[0 if step == 0 else 1]
        active_i = active.to(torch.int32)
        nb = torch.zeros((num_layers, low_h, low_w), dtype=torch.int64, device=dev)
        # down, right, left, up at +-2*windowSize, edge-clamped
        # (ref: calcDeltaSumsKernelSDR.h:112-131).
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
    # Layers at index >= radius are padding: masked so argmin never picks them.
    return torch.where(lz < radius, sums, UINT32_MASK)


def lowest_layer(sums: torch.Tensor) -> torch.Tensor:
    """Per-window argmin over layers, first minimum wins
    (ref: determineLowestLayerKernelSDR.h:16-27)."""
    return torch.argmin(sums, dim=0).to(torch.int32)


def adjust_offsets(offsets: torch.Tensor, winners: torch.Tensor, radius: int, *,
                   window_size: int, step: int) -> torch.Tensor:
    """Commit each window's winning candidate; returns new offsets
    (ref: adjustOffsetArrayKernelSDR.h:11-20)."""
    low_h, low_w = offsets.shape[1:]
    adj = _signed_square(winners % radius - radius // 2)
    adj_full = adj.repeat_interleave(window_size, 0).repeat_interleave(window_size, 1)
    adj_full = adj_full[:low_h, :low_w]
    plane = step & 1
    out = offsets.clone()
    out[plane] = (offsets[plane].to(torch.int32) + adj_full.to(torch.int32)).to(torch.int16)
    return out


def blur_flow(offsets: torch.Tensor) -> torch.Tensor:
    """8x8 box blur of both flow planes: kernel K1 (ops/blur_kernel.py)."""
    return blur_kernel.blur_flow(offsets)


def window_schedule(low_h: int, low_w: int, num_iterations: int = 0) -> list[tuple[int, int]]:
    """Static (iteration, window_size) schedule (ref: opticalFlowCalcSDR.cpp:48-65,110)."""
    window = config.initial_window_size(low_h, low_w)
    sched = []
    for it in range(config.num_pyramid_iterations(window, num_iterations)):
        sched.append((it, window))
        window = max(window >> 1, 1)
    return sched


def pyramid_flow(
    f1y: torch.Tensor, f1uv: torch.Tensor, f2y: torch.Tensor, f2uv: torch.Tensor,
    radius: int, delta_scalar: int, neighbor_scalar: int, *,
    low_h: int, low_w: int, res_scalar: int, is_hdr: bool,
    num_iterations: int = 0, num_layers: int = MAX_R,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full pyramid loop (ref: opticalFlowCalcSDR.cpp:44-123).

    Returns (offsets, blurred_offsets, total_delta_raw): total_delta_raw is the
    un-normalised uint32 window-(0,0) sum of layer radius//2-1 at iteration 0
    step 0, a 0-dim int64 tensor left on the device (the host divides by
    low_h*low_w*{10,6}, ref: opticalFlowCalcSDR.cpp:91-94).

    num_layers bounds the cost volume (radius <= num_layers); the outputs do
    not depend on it.
    """
    if not 0 < radius <= num_layers:
        raise ValueError(f"radius {radius} outside (0, num_layers={num_layers}]")
    offsets = torch.zeros((2, low_h, low_w), dtype=torch.int16, device=f1y.device)
    total_delta_raw = None
    for iteration, window in window_schedule(low_h, low_w, num_iterations):
        for step in (0, 1):
            sums = delta_window_sums(
                f1y, f1uv, f2y, f2uv, offsets, radius, delta_scalar, neighbor_scalar,
                window_size=window, res_scalar=res_scalar, iteration=iteration,
                step=step, is_hdr=is_hdr, num_layers=num_layers)
            if iteration == 0 and step == 0:
                total_delta_raw = sums[radius // 2 - 1, 0, 0]
            offsets = adjust_offsets(offsets, lowest_layer(sums), radius,
                                     window_size=window, step=step)
    if total_delta_raw is None:   # no pyramid step ran (1x1 flow grid)
        total_delta_raw = torch.zeros((), dtype=torch.int64, device=f1y.device)
    return offsets, blur_flow(offsets), total_delta_raw
