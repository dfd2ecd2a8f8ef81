"""The source frames of a stream, made from the seed.

A copy of the port's test pan (hopperrender_tpu_torch/vio/nv12.py
synthetic_frame with coherent=True, and chip_smoke.py panning_frames): one
textured canvas whose noise moves with it, each frame a window of it, so
that every pair of frames is a real pan and none is a scene cut. The
canvas is made once on the run's device, in a few large calls, then
copied to the host: the client hands the server decoded frames in host
memory, as a decoder does. The pool holds `pan_positions` windows, each
`pan_px` further right; the stream walks them back and forth (a
ping-pong), starting at a position the seed draws. Every seed gives the
same sizes and the same motion, in another order and with other noise.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

P010_MASK = 0xFFC0   # 10-bit samples, MSB-aligned in 16 bits


@dataclasses.dataclass
class Pool:
    """frames[i] = (y, uv) host planes, C-contiguous; frame_index(k) names
    the frame pushed k-th (k from 1)."""

    frames: list
    start: int

    def frame_index(self, k: int) -> int:
        n = len(self.frames)
        if n == 1:
            return 0
        p = (self.start + k - 1) % (2 * (n - 1))
        return p if p < n else 2 * (n - 1) - p


def make_pool(cfg: dict, traffic: dict, seed: int, device) -> Pool:
    h, w = cfg["height"], cfg["width"]
    is_hdr = cfg["format"] == "p010"
    step, n = traffic["pan_px"], traffic["pan_positions"]
    canvas = w + step * (n - 1)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    phase = torch.rand(3, generator=gen, device=device) * (2 * math.pi)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(canvas, dtype=torch.float32, device=device)[None, :]
    tex = (torch.sin(xx * 0.17 + phase[0]) + torch.cos(yy * 0.23 + phase[1])
           + torch.sin((xx + yy) * 0.05 + phase[2]) + 3) / 6
    noise = torch.rand((h, canvas), generator=gen, device=device) * 0.1
    peak = 65535 if is_hdr else 255
    full = ((tex + noise) / 1.1 * peak).to(torch.int32)
    if is_hdr:
        full &= P010_MASK
    start = int(torch.randint(0, max(2 * (n - 1), 1), (1,), generator=gen, device=device))
    dtype = np.uint16 if is_hdr else np.uint8
    full_y = full.cpu().numpy().astype(dtype)
    full_uv = full_y[::2]
    frames = [(np.ascontiguousarray(full_y[:, step * i:step * i + w]),
               np.ascontiguousarray(full_uv[:, step * i:step * i + w])) for i in range(n)]
    return Pool(frames=frames, start=start)
