"""The interpolation step on a dp x sp mesh of ranks (torch.distributed).

PyTorch port of hopperrender_tpu/parallel/mesh.py. The reference is strictly
single-GPU; the scale-out maps its axes onto a 2-D mesh of ranks:

  * "dp": independent video streams. Each dp row of the mesh holds its own
    streams; nothing crosses between rows.
  * "sp": one stream's work, split across the ranks of a dp row:
      - flow splits the search-layer axis of the cost volume: each rank
        computes MAX_R / sp candidate layers, an all-gather of the compact
        window sums (kilobytes) gives every rank the whole volume, and every
        rank runs the same argmin and adjust, so the offsets stay replicated;
      - the warp splits output rows: the sources stay whole on every rank,
        each rank computes its row band of each plane (K2's mesh-sharded
        variant, ops/warp_kernel.warp_frames_band), and an all-gather over
        the dp row's ranks joins the bands.

Rank r of a dp x sp mesh is (dp_index, sp_index) = divmod(r, sp). Collectives
go through the sp group of the rank's dp row, on the rank's device: gloo's
all_gather takes CUDA tensors too (ranks that share one card), so nothing is
copied through the host. They carry bytes, every tensor viewed as uint8 along
its last axis: gloo refuses int16 and uint16 ("Invalid scalar type"), and
both backends take uint8.

Not carried over: the TPU's strip formulations (pyramid_flow_strip_sharded,
warp_frame_strip_sharded), the host tier `plan` and the validity `sig`. They
exist because a TPU has no fast per-lane gather; Hopper gathers natively
(ROADMAP "Not ported").
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from hopperrender_tpu_torch.ops import flow as flow_ops
from hopperrender_tpu_torch.ops import warp as warp_ops
from hopperrender_tpu_torch.ops import warp_kernel

MAX_R = flow_ops.MAX_R
NOT_ON_THE_CARD = ("modes 3-6 on the mesh run only on the CPU (plain row route); on the "
                   "card they are ROADMAP Queue 1, 'modes 3-6 on the mesh'")


class Mesh:
    """This rank's place in a dp x sp mesh over the initialised default
    process group, and the sp group of its dp row. Every rank must construct
    it, in the same order as the other ranks (dist.new_group is collective).
    device: where this rank's tensors live."""

    def __init__(self, dp: int, sp: int, device: str | torch.device):
        world = dist.get_world_size()
        if dp * sp != world:
            raise ValueError(f"mesh {dp}x{sp} needs {dp * sp} ranks, the group has {world}")
        self.dp, self.sp = dp, sp
        self.rank = dist.get_rank()
        self.dp_index, self.sp_index = divmod(self.rank, sp)
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        groups = [dist.new_group([d * sp + s for s in range(sp)]) for d in range(dp)]
        self.sp_group = groups[self.dp_index]

    def all_gather_sp(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The sp ranks' tensors of t's shape, concatenated along dim (not the
        last axis) in sp order."""
        if self.sp == 1:
            return t
        if dim in (-1, t.dim() - 1):
            raise ValueError("all_gather_sp concatenates along an axis other than the last")
        local = t.contiguous().view(torch.uint8)
        parts = [torch.empty_like(local) for _ in range(self.sp)]
        dist.all_gather(parts, local, group=self.sp_group)
        return torch.cat(parts, dim).view(t.dtype)


def pyramid_flow_sharded(f1y, f1uv, f2y, f2uv, radius: int, delta_scalar: int,
                         neighbor_scalar: int, *, low_h: int, low_w: int, res_scalar: int,
                         is_hdr: bool, mesh: Mesh):
    """The pyramid loop with the search layers split over sp
    (ref: opticalFlowCalcSDR.cpp:44-123): each sp rank computes
    MAX_R / sp layers, the window sums are gathered, and every rank commits
    the same winners. Returns (offsets, blurred, total_delta_raw), equal on
    every rank of the dp row and to ops/flow.pyramid_flow."""
    if MAX_R % mesh.sp:
        raise ValueError(f"the {MAX_R} search layers do not split over sp = {mesh.sp}")
    if not 0 < radius <= MAX_R:
        raise ValueError(f"radius {radius} outside (0, {MAX_R}]")
    layers_local = MAX_R // mesh.sp
    layer_offset = mesh.sp_index * layers_local
    offsets = torch.zeros((2, low_h, low_w), dtype=torch.int16, device=f1y.device)
    total_delta_raw = torch.zeros((), dtype=torch.int64, device=f1y.device)
    for iteration, window in flow_ops.window_schedule(low_h, low_w):
        for step in (0, 1):
            sums_local = flow_ops.delta_window_sums(
                f1y, f1uv, f2y, f2uv, offsets, radius, delta_scalar, neighbor_scalar,
                window_size=window, res_scalar=res_scalar, iteration=iteration, step=step,
                is_hdr=is_hdr, num_layers=layers_local, layer_offset=layer_offset)
            sums = mesh.all_gather_sp(sums_local, dim=0)
            if iteration == 0 and step == 0:
                total_delta_raw = sums[radius // 2 - 1, 0, 0]
            offsets = flow_ops.adjust_offsets(offsets, flow_ops.lowest_layer(sums), radius,
                                              window_size=window, step=step)
    return offsets, flow_ops.blur_flow(offsets), total_delta_raw


def warp_frame_band_sharded(src12_y, src12_uv, src21_y, src21_uv, flow, ts, black, white, *,
                            res_scalar: int, mode: int, is_hdr: bool, mesh: Mesh):
    """K2's mesh-sharded variant (modes 0/1/2) for this rank's row band of
    each plane: (T, r_y, W), (T, r_uv, W) for the (T,) blending scalars ts."""
    return warp_kernel.warp_frames_band(
        src12_y, src12_uv, src21_y, src21_uv, flow, ts, black, white, res_scalar=res_scalar,
        mode=mode, is_hdr=is_hdr, num_shards=mesh.sp, shard_index=mesh.sp_index)


def warp_frame_sharded(src12_y, src12_uv, src21_y, src21_uv, flow, ts, black, white, *,
                       res_scalar: int, mode: int, is_hdr: bool, mesh: Mesh):
    """The plain row route, any mode 0-6, for this rank's row band of each
    plane (ops/warp.warp_frame_rows). CPU tensors only: on the card the mesh
    warps through K2's mesh-sharded variant."""
    if flow.device.type != "cpu":
        raise NotImplementedError(NOT_ON_THE_CARD)
    return warp_ops.warp_frame_rows(
        src12_y, src12_uv, src21_y, src21_uv, flow, ts, black, white, res_scalar=res_scalar,
        mode=mode, is_hdr=is_hdr, num_shards=mesh.sp, shard_index=mesh.sp_index)


def make_multichip_step(mesh: Mesh, frame_height: int, frame_width: int, *, low_h: int,
                        low_w: int, res_scalar: int, is_hdr: bool = False, mode: int = 2,
                        t_batch: int = 1):
    """The interpolation step of this rank's dp row.

    The step takes the dp row's streams with a leading stream axis: the
    3-frame ring (f0 = N-2, f1 = N-1, f2 = N), (B, H, W) and (B, H/2, W), the
    previous pair's blurred flow (B, 2, low_h, low_w), the shared radius and
    scalars, the blending scalar t (a float, or a (t_batch,) vector when
    t_batch > 1) and the levels. Every rank of the row passes the same
    streams. It returns (out_y, out_uv, blurred, delta_raw): (B, H, W) and
    (B, H/2, W) outputs, (B, t_batch, H, W) and (B, t_batch, H/2, W) when
    t_batch > 1, with the rows gathered over sp and cropped to the frame on
    every rank; the (B, 2, low_h, low_w) int16 flow and (B,) int64 raw deltas.

    Modes 0/1/2 warp through K2's mesh-sharded variant (the kernel on the
    card, its plain version on the CPU); modes 3-6 take the plain row route,
    which runs on the CPU only."""
    if mode not in warp_ops.WARP_MODES:
        raise ValueError(f"output mode {mode} is not one of {warp_ops.WARP_MODES}")
    if t_batch < 1:
        raise ValueError(f"t_batch {t_batch} < 1")
    use_kernel = mode in warp_kernel.KERNEL_MODES
    if not use_kernel and mesh.device.type != "cpu":
        raise NotImplementedError(NOT_ON_THE_CARD)
    warp = warp_frame_band_sharded if use_kernel else warp_frame_sharded

    def step(f0y, f0uv, f1y, f1uv, f2y, f2uv, flow_prev, radius, delta_scalar,
             neighbor_scalar, t, black, white):
        if tuple(f0y.shape[1:]) != (frame_height, frame_width):
            raise ValueError(f"frames: expected {frame_height}x{frame_width}, got "
                             f"{tuple(f0y.shape[1:])}")
        ts = torch.as_tensor(t, dtype=torch.float32, device=mesh.device).reshape(-1)
        if ts.shape[0] != t_batch:
            raise ValueError(f"t: expected {t_batch} blending scalars, got {ts.shape[0]}")
        outs = []
        for b in range(f0y.shape[0]):
            _, blurred, delta_raw = pyramid_flow_sharded(
                f1y[b], f1uv[b], f2y[b], f2uv[b], int(radius), int(delta_scalar),
                int(neighbor_scalar), low_h=low_h, low_w=low_w, res_scalar=res_scalar,
                is_hdr=is_hdr, mesh=mesh)
            band_y, band_uv = warp(f0y[b], f0uv[b], f1y[b], f1uv[b], flow_prev[b], ts,
                                   float(black), float(white), res_scalar=res_scalar,
                                   mode=mode, is_hdr=is_hdr, mesh=mesh)
            y = mesh.all_gather_sp(band_y, dim=1)[:, :frame_height]
            uv = mesh.all_gather_sp(band_uv, dim=1)[:, :frame_height // 2]
            if t_batch == 1:
                y, uv = y[0], uv[0]
            outs.append((y, uv, blurred, delta_raw))
        return tuple(torch.stack(parts) for parts in zip(*outs))

    return step
