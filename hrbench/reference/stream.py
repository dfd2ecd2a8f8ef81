"""One stream served by the plain reference: the frames a push reads, the
flow it warps with, and its outputs' planes.

It follows OpticalFlowEngine's ring as FrameServer.push_frame drives it
(hopperrender_tpu_torch/engine/flow_engine.py): at push k the ring holds
frames k - 2, k - 1, k (frames before the first are zero planes); the warp
reads k - 2 and k - 1 with the flow of that pair, computed at push k - 1
(zero before the engine has made one, at k = 3); a copy passes the frame
the pipeline's latency matches (k - 2 once warm, else the first frame)
through the levels.
"""

from __future__ import annotations

import numpy as np
import torch

from hrbench.reference import flow as rflow
from hrbench.reference import warp as rwarp
from hrbench.reference.cadence import WARM_FRAMES, Output


class ReferenceStream:
    """frame_index(k) names the pool frame pushed k-th (k from 1); pool[i] is
    that frame's host (y, uv). Frames, flows and deltas are kept by pool
    index, since a pan over a pool repeats its pairs."""

    def __init__(self, pool, frame_index, cfg: dict, *, radius: int, mode: int, device):
        self.pool, self.frame_index, self.cfg = pool, frame_index, cfg
        self.radius, self.mode, self.device = radius, mode, torch.device(device)
        self.is_hdr = cfg["format"] == "p010"
        self.rs, self.low_h, self.low_w = rflow.calc_flow_dims(
            cfg["height"], cfg["width"], cfg["max_calc_res"])
        scale = 256.0 if self.is_hdr else 1.0
        self.black = float(cfg["black_level"]) * scale
        self.white = float(cfg["white_level"]) * scale
        self._frames: dict[int, tuple] = {}
        self._flows: dict[tuple, torch.Tensor] = {}
        self._deltas: dict[tuple, int] = {}

    def _flow_kw(self) -> dict:
        c = self.cfg
        return dict(low_h=self.low_h, low_w=self.low_w, res_scalar=self.rs, is_hdr=self.is_hdr,
                    num_iterations=c["num_iterations"])

    def frame(self, k: int):
        """The device planes of the k-th frame pushed; zeros before the first."""
        key = self.frame_index(k) if k >= 1 else -1
        if key not in self._frames:
            if len(self._frames) > 8:
                self._frames.clear()
            if key == -1:
                dtype = np.uint16 if self.is_hdr else np.uint8
                y = np.zeros((self.cfg["height"], self.cfg["width"]), dtype)
                uv = np.zeros((self.cfg["height"] // 2, self.cfg["width"]), dtype)
            else:
                y, uv = self.pool[key]
            self._frames[key] = (torch.from_numpy(np.ascontiguousarray(y)).to(self.device),
                                 torch.from_numpy(np.ascontiguousarray(uv)).to(self.device))
        return self._frames[key]

    def frame_delta(self, k: int) -> int:
        """The scene gate's delta of the pair (k - 1, k)."""
        key = (self.frame_index(k - 1), self.frame_index(k))
        if key not in self._deltas:
            c = self.cfg
            self._deltas[key] = rflow.frame_delta(
                *self.frame(k - 1), *self.frame(k), self.radius, c["delta_scalar"],
                c["neighbor_scalar"], **self._flow_kw())
        return self._deltas[key]

    def warp_flow(self, k: int) -> torch.Tensor:
        """The blurred flow push k warps with: that of (k - 2, k - 1)."""
        if k - 1 < WARM_FRAMES:
            return torch.zeros((2, self.low_h, self.low_w), dtype=torch.int16,
                               device=self.device)
        key = (self.frame_index(k - 2), self.frame_index(k - 1))
        if key not in self._flows:
            c = self.cfg
            self._flows[key] = rflow.pyramid_flow(
                *self.frame(k - 2), *self.frame(k - 1), self.radius, c["delta_scalar"],
                c["neighbor_scalar"], **self._flow_kw())
        return self._flows[key]

    def outputs(self, k: int, plan: list[Output], *, blend_precision: str = "f32"):
        """The host (y, uv) planes of every output of push k."""
        f0, f1 = self.frame(k - 2), self.frame(k - 1)
        copy_src = f0 if k >= WARM_FRAMES else self.frame(1)
        out = []
        for o in plan:
            if o.interpolated:
                y, uv = rwarp.warp_frame(*f0, *f1, self.warp_flow(k), o.blending_scalar,
                                         self.black, self.white, res_scalar=self.rs,
                                         mode=self.mode, is_hdr=self.is_hdr,
                                         blend_precision=blend_precision)
            else:
                y, uv = rwarp.copy_frame(*copy_src, self.black, self.white, is_hdr=self.is_hdr)
            out.append((y.cpu().numpy(), uv.cpu().numpy()))
        return out
