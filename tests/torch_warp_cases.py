"""The cases on which K2 (hopperrender_tpu_torch/csrc/warp_frame.cu) splits its
paths, shared by the CPU tests (the plain version against jitted JAX,
tests/test_torch_warp.py) and the card's tests (the kernel against the plain
version, tests/test_torch_cuda.py). Imports numpy only: the card's tests run
without jax.

K2 gives each thread a run of up to 16 bytes of one row, never wider than a
flow cell, and every t. A run whose warped column spans lie inside
[1, W - 2] reads each span whole (UV: an odd shift takes U and V from two
spans); a run that crosses a mirror edge, or the ragged tail of a row, goes
element by element. So the cases cover: random, smooth and constant flow,
flow that pushes runs across the left, right, top and bottom mirror edges,
widths that are not multiples of 8 or 16 (86: row starts not 16-byte
aligned) and widths that are (96, 128), T = 1 and 7, every res_scalar 0-3,
SDR and HDR, t outside [0, 1] (K2 converts the blend without conversion
instructions only for t in [0, 1]); and bands of n = 3 on a 50-row frame
(Y 50 and UV 25 rows: bands of 17 and 9 rows, across flow cells).
"""

from __future__ import annotations

import dataclasses

import numpy as np

T1 = (0.4,)
T7 = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0, 0.3)
T_OUT = (-0.25, 0.5, 1.5)     # t outside [0, 1]: blends below 0 and above peak
FLOWS = ("random", "smooth", "constant", "edges")


@dataclasses.dataclass(frozen=True)
class WarpCase:
    h: int
    w: int
    rs: int
    is_hdr: bool
    flow: str          # one of FLOWS
    ts: tuple
    shards: int = 1    # > 1: the band split is tested too

    @property
    def name(self) -> str:
        depth = "hdr" if self.is_hdr else "sdr"
        band = f"-n{self.shards}" if self.shards > 1 else ""
        return f"{self.h}x{self.w}-rs{self.rs}-{depth}-{self.flow}-t{len(self.ts)}{band}"

    @property
    def levels(self) -> tuple[float, float]:
        s = 256.0 if self.is_hdr else 1.0
        return 16.0 * s, 235.0 * s


WARP_CASES = [
    WarpCase(50, 86, 0, False, "random", T7),
    WarpCase(48, 96, 0, True, "edges", T1),
    WarpCase(50, 86, 1, True, "smooth", T1),
    WarpCase(48, 96, 1, False, "edges", T7),
    WarpCase(50, 86, 2, True, "constant", T7),
    WarpCase(64, 128, 2, False, "smooth", T7, shards=3),
    WarpCase(48, 96, 2, True, "random", T7),
    WarpCase(50, 86, 3, True, "edges", T7, shards=3),
    WarpCase(48, 96, 3, False, "constant", T1),
    WarpCase(64, 128, 3, True, "smooth", T7),
    WarpCase(50, 86, 3, False, "edges", T7, shards=3),
    WarpCase(48, 96, 3, True, "random", T_OUT),
    WarpCase(50, 86, 1, False, "smooth", T_OUT),
]
BAND_CASES = [c for c in WARP_CASES if c.shards > 1]


def make_flow(kind: str, low_h: int, low_w: int, rng: np.random.Generator) -> np.ndarray:
    """(2, low_h, low_w) int16 flow of one kind (FLOWS)."""
    yy, xx = np.mgrid[0:low_h, 0:low_w].astype(np.float64)
    if kind == "random":
        return rng.integers(-70, 71, (2, low_h, low_w)).astype(np.int16)
    if kind == "smooth":       # low-frequency waves: neighbouring cells move alike
        phase = rng.uniform(0, 2 * np.pi, 2)
        fx = 23 * np.sin(2 * np.pi * xx / max(low_w, 2) + phase[0]) + 7 * np.cos(yy / 3)
        fy = 17 * np.cos(2 * np.pi * yy / max(low_h, 2) + phase[1]) - 5 * np.sin(xx / 4)
        return np.round(np.stack([fx, fy])).astype(np.int16)
    if kind == "constant":     # one shift everywhere; odd and even by t
        return np.stack([np.full((low_h, low_w), 5), np.full((low_h, low_w), -3)]).astype(np.int16)
    if kind == "edges":        # the left half pushes left and right, so does the top
        noise = rng.integers(-3, 4, (2, low_h, low_w))
        fx = np.where(xx < low_w / 2, 41, -41) + noise[0]
        fy = np.where(yy < low_h / 2, 29, -29) + noise[1]
        return np.stack([fx, fy]).astype(np.int16)
    raise ValueError(f"flow kind {kind!r} is not one of {FLOWS}")


def make_inputs(case: WarpCase, seed: int = 0):
    """numpy (src12_y, src12_uv, src21_y, src21_uv, flow, ts) of a case; the
    flow grid is ceil(h / 2**rs) x ceil(w / 2**rs)."""
    rng = np.random.default_rng(seed)
    hi, dt = (65536, np.uint16) if case.is_hdr else (256, np.uint8)
    planes = [rng.integers(0, hi, shape, dtype=dt)
              for shape in ((case.h, case.w), (case.h // 2, case.w)) * 2]
    low = (-(-case.h >> case.rs), -(-case.w >> case.rs))
    flow = make_flow(case.flow, *low, rng)
    return (*planes, flow, np.asarray(case.ts, np.float32))
