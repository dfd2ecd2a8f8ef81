"""Flow calculation: cost volume, layer argmin, offset adjust, pyramid loop.

PyTorch port of hopperrender_tpu/ops/flow.py (the reference formulation of
calcDeltaSums / determineLowestLayer / adjustOffsetArray / the pyramid loop,
ref: opticalFlowCalcSDR.cpp:44-123). The cost volume of a step is kernel K3
and the argmin with its commit kernel K4, one flow_step call a step
(ops/cost_volume_kernel.py); the blur is kernel K1 (ops/blur_kernel.py). On
the CPU each takes its plain PyTorch version.

Integer semantics follow the reference exactly:
  * int16 offsets wrap: sums are formed in int32 and narrowed with .to(int16);
  * uint32 window sums wrap: K3 sums in uint32 (its plain version in int64,
    keeping the low 32 bits), held in int32 tensors; delta_window_sums widens
    them to int64 for the argmin here;
  * torch.argmin returns the first minimum, the reference's strict `<` scan;
  * HDR samples compare as sample >> 8.
The search radius, delta and neighbor scalars are plain ints: PyTorch runs
eagerly, so nothing is traced or recompiled when the auto scaler moves them.
"""

from __future__ import annotations

import torch

from hopperrender_tpu_torch import config
from hopperrender_tpu_torch.ops import blur_kernel, cost_volume_kernel

MAX_R = config.MAX_SEARCH_RADIUS
UINT32_MASK = cost_volume_kernel.UINT32_MASK


def delta_window_sums(
    f1y: torch.Tensor, f1uv: torch.Tensor, f2y: torch.Tensor, f2uv: torch.Tensor,
    offsets: torch.Tensor,   # (2, low_h, low_w) int16
    radius: int, delta_scalar: int, neighbor_scalar: int, *,
    window_size: int, res_scalar: int, iteration: int, step: int, is_hdr: bool,
    num_layers: int = MAX_R, layer_offset: int = 0,
) -> torch.Tensor:
    """Compact cost-volume window sums, (num_layers, n_win_y, n_win_x) int64
    holding uint32 values; global layers >= radius are 0xFFFFFFFF: kernel K3
    (cost_volume_kernel.delta_sums), widened.

    num_layers/layer_offset shard the search-layer axis: a shard computes
    global layers [layer_offset, layer_offset + num_layers)."""
    sums = cost_volume_kernel.delta_sums(
        f1y, f1uv, f2y, f2uv, offsets, radius, delta_scalar, neighbor_scalar,
        window_size=window_size, res_scalar=res_scalar, iteration=iteration, step=step,
        is_hdr=is_hdr, num_layers=num_layers, layer_offset=layer_offset)
    return sums.to(torch.int64) & UINT32_MASK


def lowest_layer(sums: torch.Tensor) -> torch.Tensor:
    """Per-window argmin over layers, first minimum wins
    (ref: determineLowestLayerKernelSDR.h:16-27). Compares signed: sums are
    int64 holding uint32 (delta_window_sums), never K3's int32."""
    return torch.argmin(sums, dim=0).to(torch.int32)


def adjust_offsets(offsets: torch.Tensor, winners: torch.Tensor, radius: int, *,
                   window_size: int, step: int) -> torch.Tensor:
    """Commit each window's winning candidate; returns new offsets
    (ref: adjustOffsetArrayKernelSDR.h:11-20)."""
    return cost_volume_kernel.adjust_reference(offsets, winners, radius,
                                               window_size=window_size, step=step)


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
    not depend on it. Each step is one flow_step call (K3 then K4) on this
    call's own PyramidState: its checks run once a flow, and the offsets,
    the sums buffers and the delta belong to this call alone.
    """
    if not 0 < radius <= num_layers:
        raise ValueError(f"radius {radius} outside (0, num_layers={num_layers}]")
    state = cost_volume_kernel.PyramidState(
        f1y, f1uv, f2y, f2uv, radius, delta_scalar, neighbor_scalar, low_h=low_h, low_w=low_w,
        res_scalar=res_scalar, is_hdr=is_hdr, num_layers=num_layers,
        schedule=window_schedule(low_h, low_w, num_iterations))
    for k in range(len(state.steps)):
        cost_volume_kernel.flow_step(state, k)
    return state.offsets, blur_flow(state.offsets), state.delta


def raw_frame_delta(sums: torch.Tensor, radius: int) -> torch.Tensor:
    """The scene-change scalar of K3's first step: window (0, 0) of layer
    radius//2 - 1, a new 0-dim int64 tensor (uint32 value) on the sums'
    device, so the sums buffer may be reused (ref: opticalFlowCalcSDR.cpp:91).
    The mesh's pyramid takes it from the gathered sums; pyramid_flow's K4
    writes it."""
    return sums[radius // 2 - 1, 0, 0].to(torch.int64) & UINT32_MASK
