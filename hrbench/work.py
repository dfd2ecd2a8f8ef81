"""The least time of the work a push needs, from the cell's shapes: the
table of peaks and a frozen copy of the arithmetic behind the port's
kernel bounds (chip_smoke.py: roofline, bound, cost_volume_work, the K4,
mode-3 and copy bounds), for `kernel.roofline`.

A kernel's least time is the larger of its bytes over the memory rate
(each input byte read once, each output byte written once) and its
operations over the rate of their type. The work is that of the algorithm
at the cell's shapes, whichever kernels do it:
  * a flow: each pyramid step's cost volume (K3: the distinct 32-byte
    sectors its candidates read, from zero offsets; its operations) and
    winners' commit (K4), at the configuration's radius, then the blur (K1);
  * an interval's interpolated outputs: one warp of T outputs in modes 0-2
    (K2), one warp per output in mode 3 (K2's mode 3);
  * a copy: both planes through the levels (K6).
The port's own bounds add an L2 term for K3, read from an L2 rate that the
run measures; this copy keeps to published peaks, so its K3 term is at most
the port's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hrbench.reference import flow as rflow

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W
# limit): HBM3 at 3.35 TB/s, float32 on the CUDA cores 67 TFLOP/s (an FMA
# counts two); int32 from its 132 SMs of 64 INT32 lanes (NVIDIA's Hopper
# architecture paper) at the 1,980 MHz boost clock.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# Operations an element, counted from the kernels' arithmetic (chip_smoke.py
# OPS_PER_ELEMENT, K3_*_OPS, K4_CELL_OPS, HSV_*_OPS, COPY_OPS).
K1_OPS = 16                   # the separable 8x8 box sum and its division
K2_OPS = 50                   # mode 2: flow lookup, two warped positions, blend, levels
K2_RAW_BLEND_OPS = 46         # the same without the levels
K3_CANDIDATE_OPS, K3_HDR_OPS, K3_NEIGHBOR_OPS, K3_CELL_OPS = 26, 3, 13, 16
K4_CELL_OPS = 5
HSV_CELL_OPS, HSV_Y_RUN_OPS, HSV_UV_RUN_OPS, HSV_Y_SAMPLE_OPS = 115, 10, 34, 9
HSV_BLOCK = (32, 8)           # K2's mode 3: blocks of 8 rows of 32 runs
COPY_OPS = {"Y": 6, "UV": 7}


def roofline_s(bytes_moved: float, ops: float, ops_per_s: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s)


class Shapes:
    """The sizes one configuration's pushes work on."""

    def __init__(self, cfg: dict, radius: int):
        self.h, self.w = cfg["height"], cfg["width"]
        self.is_hdr = cfg["format"] == "p010"
        self.item = 2 if self.is_hdr else 1
        self.radius = radius
        self.num_iterations = cfg["num_iterations"]
        self.rs, self.low_h, self.low_w = rflow.calc_flow_dims(self.h, self.w,
                                                               cfg["max_calc_res"])
        self.y_elems = self.h * self.w
        self.uv_elems = (self.h // 2) * self.w
        self.frame_bytes = (self.y_elems + self.uv_elems) * self.item
        self.flow_bytes = 2 * self.low_h * self.low_w * 2


def k3_hbm_bytes(s: Shapes, *, window: int, step: int, device="cpu") -> int:
    """K3's bytes at one step, from zero offsets: the distinct 32-byte sectors
    of each plane its candidates read (frame 1 for the layers below the
    radius, at cells inside the frame; frame 2 once a cell), the offsets
    once, and the sums written once."""
    dtype = torch.uint16 if s.is_hdr else torch.uint8
    f1y = torch.empty((s.h, s.w), dtype=dtype, device="meta")
    f1uv = torch.empty((s.h // 2, s.w), dtype=dtype, device="meta")
    offsets = torch.zeros((2, s.low_h, s.low_w), dtype=torch.int16, device=device)
    c = rflow.candidate_reads(f1y, f1uv, offsets, s.radius, res_scalar=s.rs, step=step,
                              num_layers=s.radius)
    in_frame = c.in_frame[0]
    keys = []
    for plane, idx, masked in ((0, c.y, True), (1, c.u, True), (1, c.v, True),
                               (2, c.y2, False), (3, c.u2, False), (3, c.v2, False)):
        idx = idx.expand(-1, s.low_h, s.low_w) if idx.dim() == 3 else idx[None]
        sel = (in_frame if masked else torch.ones_like(in_frame)).expand_as(idx)
        keys.append((plane << 30) + ((idx[sel] * s.item) >> 5))
    sectors = int(torch.cat(keys).unique().numel())
    n_win = -(-s.low_h // window) * -(-s.low_w // window)
    return 32 * sectors + s.flow_bytes + 4 * s.radius * n_win


def _shape_key(cfg: dict) -> tuple:
    return tuple(cfg[k] for k in ("height", "width", "format", "max_calc_res", "num_iterations"))


@functools.lru_cache(maxsize=8)
def flow_parts_s(key: tuple, radius: int, device="cpu") -> tuple[float, float, float]:
    """(K3, K4, K1) least seconds of one flow, summed over its steps, for the
    shapes _shape_key names (K3's sectors counted on `device`)."""
    s = Shapes(dict(zip(("height", "width", "format", "max_calc_res", "num_iterations"), key)),
               radius)
    cells = s.low_h * s.low_w
    k3 = k4 = 0.0
    for iteration, window in rflow.window_schedule(s.low_h, s.low_w, s.num_iterations):
        per_candidate = (K3_CANDIDATE_OPS + K3_HDR_OPS * s.is_hdr
                         + K3_NEIGHBOR_OPS * (iteration >= rflow.FIRST_NEIGHBOR_ITERATION))
        ops3 = s.radius * cells * per_candidate + cells * K3_CELL_OPS
        n_win = -(-s.low_h // window) * -(-s.low_w // window)
        for step in (0, 1):
            k3 += roofline_s(k3_hbm_bytes(s, window=window, step=step, device=device), ops3,
                             INT32_OPS_PER_S)
            # K4 reads and writes one int16 plane of offsets, reads the sums.
            k4 += roofline_s(2 * 2 * cells + 4 * s.radius * n_win,
                             cells * (s.radius + K4_CELL_OPS), INT32_OPS_PER_S)
    k1 = roofline_s(2 * s.flow_bytes, 2 * cells * K1_OPS, INT32_OPS_PER_S)
    return k3, k4, k1


def flow_s(cfg: dict, radius: int, device="cpu") -> float:
    return sum(flow_parts_s(_shape_key(cfg), radius, str(device)))


def warp_s(s: Shapes, n_t: int) -> float:
    """One K2 call of n_t outputs in modes 0-2: both sources, the flow and the
    blending scalars read once, n_t outputs written."""
    moved = 2 * s.frame_bytes + s.flow_bytes + 4 * n_t + n_t * s.frame_bytes
    return roofline_s(moved, n_t * (s.y_elems + s.uv_elems) * K2_OPS, F32_OPS_PER_S)


@functools.lru_cache(maxsize=8)
def mode3_colours(h: int, w: int, is_hdr: bool, rs: int) -> tuple[int, int]:
    """The colours K2's mode 3 makes (Y, UV): one per distinct flow cell of
    each block of HSV_BLOCK runs (runs of up to 16 bytes in one cell)."""
    max_shift = 3 if is_hdr else 4
    out = []
    for plane_h, shift, uv in ((h, min(rs, max_shift), 0), (h // 2, min(rs + 1, max_shift), 1)):
        x0 = np.arange(0, w, 1 << shift)
        cols = len(set(zip((np.arange(len(x0)) // HSV_BLOCK[0]).tolist(),
                           ((x0 >> rs) >> uv).tolist())))
        cy = np.arange(plane_h)
        rows = len(set(zip((cy // HSV_BLOCK[1]).tolist(), (cy >> rs).tolist())))
        out.append(cols * rows)
    return out[0], out[1]


def mode3_s(s: Shapes, n_t: int = 1) -> float:
    """One call of K2's mode 3: both sources' Y planes and the flow read once
    (the colour replaces the UV blend), n_t outputs written; each Y output's
    warp, raw blend and colour sum, and a colour per distinct cell of a block."""
    moved = (2 * s.y_elems * s.item + s.flow_bytes + 4 * n_t + n_t * s.frame_bytes)
    colours_y, colours_uv = mode3_colours(s.h, s.w, s.is_hdr, s.rs)
    ops = (n_t * s.y_elems * (K2_RAW_BLEND_OPS + HSV_Y_SAMPLE_OPS)
           + colours_y * (HSV_CELL_OPS + HSV_Y_RUN_OPS)
           + colours_uv * (HSV_CELL_OPS + HSV_UV_RUN_OPS))
    return roofline_s(moved, ops, F32_OPS_PER_S)


def copy_s(s: Shapes) -> float:
    """One copy: both planes read once and written once; the levels."""
    return roofline_s(2 * s.frame_bytes, COPY_OPS["Y"] * s.y_elems + COPY_OPS["UV"] * s.uv_elems,
                      F32_OPS_PER_S)


def push_s(cfg: dict, radius: int, mode: int, rec, device="cpu") -> float:
    """The least seconds of the work push `rec` needed: its flow where one
    ran, its interpolated outputs' warp, its copies."""
    s = Shapes(cfg, radius)
    total = flow_s(cfg, radius, device) if rec.flow_s is not None else 0.0
    n_interp = sum(1 for m in rec.meta if m[3])
    n_copies = len(rec.meta) - n_interp
    if n_interp:
        if mode == 3:
            total += n_interp * mode3_s(s)
        elif mode in (0, 1, 2) and n_interp > 1:
            total += warp_s(s, n_interp)
        else:
            total += n_interp * warp_s(s, 1)
    return total + n_copies * copy_s(s)
