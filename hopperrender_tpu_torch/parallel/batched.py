"""Single-device multi-stream batching.

PyTorch port of hopperrender_tpu/parallel/batched.py. A production frame
server interpolates many streams on one card; `batched_step` runs B streams in
lockstep, each with the 1-pair pipeline of the engine: flow on the newest pair
(f1, f2), warp of the previous pair (f0, f1) with the previous pair's flow. It
is the single-device counterpart of the "dp" axis of parallel/mesh.py.

The blending scalar is per stream (streams sit at different cadence phases);
the search radius, the tunables and the levels are shared (one settings
profile per batch). The streams run one after another through the engine's
functions: on the card the blur is K1 and the warp K2 (modes 0/1/2; modes 3-6
composed from it, ops/warp_viz.py).
"""

from __future__ import annotations

import torch

from hopperrender_tpu_torch.ops import flow as flow_ops
from hopperrender_tpu_torch.ops import warp_viz


def batched_step(
    f0y, f0uv, f1y, f1uv, f2y, f2uv,        # (B, H, W) / (B, H/2, W) stream ring slots
    flow_prev,                              # (B, 2, low_h, low_w) previous pair's flow
    radius: int, delta_scalar: int, neighbor_scalar: int,   # shared scalars
    blend,                                  # (B,) float32 per-stream blending scalar
    black: float, white: float,             # shared levels (HDR pre-scaled x256)
    *, low_h: int, low_w: int, res_scalar: int, mode: int, is_hdr: bool,
):
    """One lockstep step for B streams. Returns (out_y, out_uv, new_flow,
    delta_raw) with a leading stream axis: (B, H, W), (B, H/2, W),
    (B, 2, low_h, low_w) int16 blurred flow, and (B,) int64 raw deltas."""
    n = f0y.shape[0]
    if blend.shape != (n,):
        raise ValueError(f"blend: expected ({n},), got {tuple(blend.shape)}")
    outs = []
    for b in range(n):
        _, blurred, delta_raw = flow_ops.pyramid_flow(
            f1y[b], f1uv[b], f2y[b], f2uv[b], radius, delta_scalar, neighbor_scalar,
            low_h=low_h, low_w=low_w, res_scalar=res_scalar, is_hdr=is_hdr)
        y, uv = warp_viz.warp_outputs(
            f0y[b], f0uv[b], f1y[b], f1uv[b], flow_prev[b], blend[b:b + 1], black, white,
            mode=mode, res_scalar=res_scalar, is_hdr=is_hdr)
        outs.append((y[0], uv[0], blurred, delta_raw))
    return tuple(torch.stack(parts) for parts in zip(*outs))
