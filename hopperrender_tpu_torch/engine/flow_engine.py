"""OpticalFlowEngine — device-resident interpolation engine on PyTorch.

PyTorch port of hopperrender_tpu/engine/flow_engine.py (ref: opticalFlowCalc.h,
opticalFlowCalcSDR.cpp, opticalFlowCalcHDR.cpp), with the surface FrameServer
calls:

  * 3-deep frame ring on the device; slot 2 = newest frame N, slot 1 = N-1,
    slot 0 = N-2 (ref: opticalFlowCalcSDR.cpp:19-29).
  * Flow is computed between slots 1 and 2 while warping reads slots 0 and 1
    with the PREVIOUS pair's blurred flow: the 1-pair pipeline that gives the
    filter its 2-source-frame latency (ref: opticalFlowCalcSDR.cpp:79-80,121-123).
  * The scene-change scalar stays on the device until fetch_total_frame_delta.
  * Flow and warp times come from CUDA events on a GPU (host clock on the CPU)
    and feed 240-frame avg/peak windows (ref: opticalFlowCalcSDR.cpp:118-138).

Each pyramid step of the flow is kernels K3 (cost volume) and K4 (argmin and
commit), the flow blur is kernel K1 and every warp, in every output mode, is
one launch of kernel K2 (for all T outputs of a source interval;
ops/warp_viz.warp_outputs): mode 3 is the HSV flow overlay in its epilogue,
mode 4 the grey flow (the flow only, one frame for every t), modes 5 and 6
the side-by-side views, where the JAX engine composes modes 4-6 in XLA
around its warp kernel. Every copy (warmup, scene cuts, TooSlow) is one
launch of kernel K6, the levels of both planes. The JAX engine's strip and
band machinery (contexts, tier plans, apron tiers, chain bounds) exists
because a TPU has no fast per-lane gather; Hopper gathers natively, so none of
it is carried over.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hopperrender_tpu_torch import config
from hopperrender_tpu_torch.ops import copy_kernel
from hopperrender_tpu_torch.ops import flow as flow_ops
from hopperrender_tpu_torch.ops import warp as warp_ops
from hopperrender_tpu_torch.ops import warp_viz
from hopperrender_tpu_torch.utils import trace

RADIUS_BUCKETS = (5, 8, 12, flow_ops.MAX_R)


def estimate_device_bytes(frame_height: int, frame_width: int, *, is_hdr: bool,
                          max_calc_res: int = config.MAX_CALC_RES) -> int:
    """Device-memory need of one engine on the card: the 3-frame ring, the
    flow double buffer and the pyramid's offsets, K3's window sums (two live
    (16, n_win_y, n_win_x) uint32 buffers at the smallest window, 2) and one
    interval's warp outputs (T <= 5) with the plain versions' int32
    temporaries. An estimate for the pre-check only; chip_smoke.py reports
    the measured peak (torch.cuda.max_memory_allocated)."""
    e = 2 if is_hdr else 1
    _, low_h, low_w = config.calc_flow_dims(frame_height, frame_width, max_calc_res)
    frame = frame_height * frame_width * 3 // 2
    cost_volume = 2 * flow_ops.MAX_R * -(-low_h // 2) * -(-low_w // 2) * 4
    return 3 * frame * e + 3 * 2 * low_h * low_w * 2 + cost_volume + 5 * frame * e + 8 * frame * 4


class CalcTimeWindow:
    """avg/peak over CALC_TIME_INTERVAL frames (ref: opticalFlowCalcSDR.cpp:128-138)."""

    def __init__(self, interval: int = config.CALC_TIME_INTERVAL):
        self.interval = interval
        self.current = 0.0
        self.avg = 0.0
        self.peak = 0.0
        self._count = 0
        self._sum = 0.0

    def record(self, seconds: float) -> None:
        self.current = seconds
        if self._count >= self.interval:
            self.avg = self._sum / self._count
            self._count = 0
            self._sum = 0.0
            self.peak = seconds
        self._count += 1
        self._sum += seconds
        if seconds > self.peak:
            self.peak = seconds


class OpticalFlowEngine:
    """Single-device interpolation engine (SDR uint8 NV12 planes / HDR uint16 P010).

    device: the torch device that holds every tensor; "cuda" by default, and
    construction raises when it names CUDA and no CUDA device exists (there
    is no silent CPU fallback)."""

    def __init__(
        self,
        frame_height: int,
        frame_width: int,
        *,
        is_hdr: bool = False,
        delta_scalar: int = config.DEFAULT_DELTA_SCALAR,
        neighbor_scalar: int = config.DEFAULT_NEIGHBOR_SCALAR,
        black_level: float = float(config.DEFAULT_BLACK_LEVEL),
        white_level: float = float(config.DEFAULT_WHITE_LEVEL),
        max_calc_res: int = config.MAX_CALC_RES,
        num_iterations: int = config.NUM_ITERATIONS,
        device: str | torch.device = "cuda",
    ):
        if frame_height % 2 or frame_width % 2:
            raise ValueError("NV12/P010 frames require even dimensions")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("OpticalFlowEngine: device 'cuda' requested but no "
                                   "CUDA device is available (pass device='cpu' to run "
                                   "the plain PyTorch versions)")
            need = estimate_device_bytes(frame_height, frame_width, is_hdr=is_hdr,
                                         max_calc_res=max_calc_res)
            free, _ = torch.cuda.mem_get_info(self.device)
            if need > 0.95 * free:
                raise RuntimeError(
                    f"engine needs ~{need / 1e9:.2f} GB but {free / 1e9:.2f} GB of device "
                    f"memory is free for {frame_width}x{frame_height} "
                    f"{'HDR' if is_hdr else 'SDR'}")
        self.h = frame_height
        self.w = frame_width
        self.is_hdr = is_hdr
        self.res_scalar, self.low_h, self.low_w = config.calc_flow_dims(
            frame_height, frame_width, max_calc_res)
        self.search_radius = config.MIN_SEARCH_RADIUS
        self.num_iterations = num_iterations  # 0 = auto (ref: config.h:6)
        self.delta_scalar = delta_scalar
        self.neighbor_scalar = neighbor_scalar
        self.black_level = black_level
        self.white_level = white_level
        self.frame_count = 0
        self.total_frame_delta = 0
        self._pending_delta_raw: torch.Tensor | None = None
        self.ofc_time = CalcTimeWindow()
        self.warp_time = CalcTimeWindow()
        self._ofc_start = None

        self._dtype = torch.uint16 if is_hdr else torch.uint8
        zeros = lambda shape, dtype: warp_ops.from_int32(
            torch.zeros(shape, dtype=torch.int32, device=self.device), dtype)
        self._frames_y = [zeros((self.h, self.w), self._dtype) for _ in range(3)]
        self._frames_uv = [zeros((self.h // 2, self.w), self._dtype) for _ in range(3)]
        # blurred[0] = previous pair's flow (consumed by warp); blurred[1] = newest.
        self._blurred = [zeros((2, self.low_h, self.low_w), torch.int16) for _ in range(2)]

    # -- timing ---------------------------------------------------------------

    def _clock(self):
        """A start mark: a recorded CUDA event on a GPU, the host clock on the CPU."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            return ev
        return time.perf_counter()

    def _elapsed(self, start, wait: str) -> float:
        """Seconds from `start` to the end of the work queued so far; the
        host waits for it in the tracer's span `wait` (one host sync)."""
        end = self._clock()
        with trace.span(wait):
            trace.count(trace.HOST_SYNC)
            if self.device.type == "cuda":
                end.synchronize()
        if self.device.type == "cuda":
            return start.elapsed_time(end) / 1e3
        return end - start

    # -- streaming API (mirrors OpticalFlowCalc) ------------------------------

    def _to_device(self, plane, shape) -> torch.Tensor:
        """A copy of one plane on the engine's device (never a view of the
        caller's buffer, which the caller may reuse)."""
        if isinstance(plane, torch.Tensor):
            if plane.dtype != self._dtype:
                raise ValueError(f"plane dtype {plane.dtype} != expected {self._dtype}")
            t = plane.to(self.device, copy=True).contiguous()
        else:
            dt = np.uint16 if self.is_hdr else np.uint8
            t = torch.tensor(np.asarray(plane, dtype=dt), device=self.device)
        if tuple(t.shape) != shape:
            raise ValueError(f"plane shape {tuple(t.shape)} != expected {shape}")
        return t

    def update_frame(self, y, uv) -> None:
        """Ingest frame N and rotate the ring (ref: opticalFlowCalcSDR.cpp:19-29).
        Accepts host ndarrays or torch tensors."""
        with trace.span("engine.ingest"):
            y_dev = self._to_device(y, (self.h, self.w))
            uv_dev = self._to_device(uv, (self.h // 2, self.w))
        self._frames_y = [self._frames_y[1], self._frames_y[2], y_dev]
        self._frames_uv = [self._frames_uv[1], self._frames_uv[2], uv_dev]
        self.frame_count += 1
        self._ofc_start = self._clock()

    def _radius_bucket(self) -> int:
        """Cost-volume depth for the current search radius: fewer layers at the
        scaler's low end, a handful of distinct shapes overall."""
        return next(b for b in RADIUS_BUCKETS if self.search_radius <= b)

    def _run_pyramid(self, f1y, f1uv, f2y, f2uv, *, num_layers: int):
        """The engine's flow for one pair at the current search radius: the one
        definition that streaming (calculate_optical_flow) and bench_units()
        share. Returns (blurred, delta_raw); records no time."""
        _, blurred, delta_raw = flow_ops.pyramid_flow(
            f1y, f1uv, f2y, f2uv, self.search_radius, self.delta_scalar,
            self.neighbor_scalar, low_h=self.low_h, low_w=self.low_w,
            res_scalar=self.res_scalar, is_hdr=self.is_hdr,
            num_iterations=self.num_iterations, num_layers=num_layers)
        return blurred, delta_raw

    def calculate_optical_flow(self) -> None:
        """Compute flow for the newest pair (slots 1, 2); swap the flow double
        buffer so warping uses the previous pair's flow
        (ref: opticalFlowCalcSDR.cpp:44-139)."""
        with trace.span("engine.flow"):
            blurred, delta_raw = self._run_pyramid(
                self._frames_y[1], self._frames_uv[1], self._frames_y[2], self._frames_uv[2],
                num_layers=self._radius_bucket())
            self._blurred = [self._blurred[1], blurred]
            self._pending_delta_raw = delta_raw
            start = self._ofc_start if self._ofc_start is not None else self._clock()
            self.ofc_time.record(self._elapsed(start, "sync.flow_timer"))

    def fetch_total_frame_delta(self) -> int:
        """Sync point for the scene-change scalar; normalisation is truncating
        integer division (ref: opticalFlowCalcSDR.cpp:92-94 /10,
        opticalFlowCalcHDR.cpp:93 /6)."""
        if self._pending_delta_raw is not None:
            norm = self.low_h * self.low_w * (6 if self.is_hdr else 10)
            with trace.span("sync.scene_delta"):
                trace.count(trace.HOST_SYNC)
                raw = int(self._pending_delta_raw)
            self.total_frame_delta = raw // norm
            self._pending_delta_raw = None
        return self.total_frame_delta

    def _levels(self) -> tuple[float, float]:
        """HDR pre-scales levels x256 (ref: opticalFlowCalcHDR.cpp:151-152)."""
        if self.is_hdr:
            return self.black_level * 256.0, self.white_level * 256.0
        return self.black_level, self.white_level

    def _run_warp(self, f0y, f0uv, f1y, f1uv, flow, ts: torch.Tensor, mode: int):
        """The engine's warp of one source pair with `flow`, one output per
        blending scalar of the (T,) float32 device vector ts: (T, H, W),
        (T, H/2, W), any mode (ops/warp_viz.py). The one definition that
        streaming (warp_frames, warp_frames_batch) and bench_units() share;
        records no time."""
        mode = int(mode)
        if mode not in warp_ops.WARP_MODES:
            raise ValueError(f"output mode {mode} is not one of {warp_ops.WARP_MODES}")
        black, white = self._levels()
        return warp_viz.warp_outputs(f0y, f0uv, f1y, f1uv, flow, ts, black, white, mode=mode,
                                     res_scalar=self.res_scalar, is_hdr=self.is_hdr)

    def _warp(self, scalars: list[float], mode: int):
        """The warp of slots 0, 1 with the previous pair's flow, one output per
        blending scalar."""
        if any(s > 1.0 for s in scalars):
            raise ValueError("Blending scalar is greater than 1.0")
        ts = torch.tensor(scalars, dtype=torch.float32, device=self.device)
        return self._run_warp(self._frames_y[0], self._frames_uv[0], self._frames_y[1],
                              self._frames_uv[1], self._blurred[0], ts, mode)

    def warp_frames(self, blending_scalar: float, frame_output_mode: int):
        """One output: warp slots 0, 1 with the previous pair's flow
        (ref: opticalFlowCalcSDR.cpp:141-168). Returns device (y, uv)."""
        with trace.span("engine.warp"):
            start = self._clock()
            y, uv = self._warp([float(blending_scalar)], frame_output_mode)
            self.warp_time.record(self._elapsed(start, "sync.warp_timer"))
        return y[0], uv[0]

    def warp_frames_batch(self, blending_scalars, frame_output_mode: int):
        """All of one source interval's outputs in ONE K2 launch (a (T,)
        blending-scalar vector), any mode. Outputs equal T warp_frames calls.
        Returns a list of device (y, uv) pairs."""
        scalars = [float(s) for s in blending_scalars]
        if not scalars:
            return []
        with trace.span("engine.warp"):
            start = self._clock()
            y, uv = self._warp(scalars, frame_output_mode)
            # The scaler consumes per-output warp durations: share the batch evenly.
            per = self._elapsed(start, "sync.warp_timer") / len(scalars)
        for _ in scalars:
            self.warp_time.record(per)
        return [(y[i], uv[i]) for i in range(len(scalars))]

    def copy_frame(self):
        """Passthrough of the pipeline-latency-matched slot, through the
        levels: one K6 launch (ops/copy_kernel.py) into new planes
        (ref: opticalFlowCalcSDR.cpp:170-183)."""
        idx = 0 if self.frame_count >= 3 else (1 if self.frame_count >= 2 else 2)
        black, white = self._levels()
        with trace.span("engine.copy"):
            start = self._clock()
            y, uv = copy_kernel.copy_frame(self._frames_y[idx], self._frames_uv[idx],
                                           black, white, is_hdr=self.is_hdr)
            self.warp_time.record(self._elapsed(start, "sync.warp_timer"))
        return y, uv

    def reset_stream(self) -> None:
        """Seek / new segment: restart the warmup (ref: HopperRender.cpp:840)."""
        self.frame_count = 0

    def load_state(self, state: dict) -> None:
        """Continue a stream from another engine's state, given as numpy arrays
        and ints: `_frames_y` and `_frames_uv` (3 planes each, oldest first),
        `_blurred` (2 flow planes, previous pair first), `frame_count`,
        `search_radius`. The JAX engine's fields of the same names export it."""
        frames_y = [self._to_device(p, (self.h, self.w)) for p in state["_frames_y"]]
        frames_uv = [self._to_device(p, (self.h // 2, self.w)) for p in state["_frames_uv"]]
        flow_shape = (2, self.low_h, self.low_w)
        blurred = [torch.tensor(np.asarray(f, dtype=np.int16), device=self.device)
                   for f in state["_blurred"]]
        if len(frames_y) != 3 or len(frames_uv) != 3 or len(blurred) != 2 \
                or any(tuple(b.shape) != flow_shape for b in blurred):
            raise ValueError("load_state: expected 3 frames and 2 flow planes of "
                             f"shape {flow_shape}")
        self._frames_y, self._frames_uv, self._blurred = frames_y, frames_uv, blurred
        self.frame_count = int(state["frame_count"])
        self.search_radius = int(state["search_radius"])
        self._pending_delta_raw = None

    def bench_units(self):
        """Closures over the engine's own flow and warp (_run_pyramid,
        _run_warp) at the current radius bucket, for hopperrender_tpu_torch/
        bench.py: the bench times the served chain, not a second
        implementation of it. Each returns an int64 device scalar in
        [0, 2**32) and none waits for the device; the caller decides when to
        synchronise.

          flow_unit(y1, uv1, y2, uv2): (delta_raw + blurred[0, 0, 0]) mod 2**32
            of the pair's flow (K1 on the card);
          warp_unit(y1, uv1, y2, uv2, flow, t, mode=2): the sum of the first 8
            samples of row 0 of the output's Y and UV planes, mod 2**32 (K2
            in modes 0/1/2);
          warp_batch_unit(y1, uv1, y2, uv2, flow, ts, mode=2): the same sum
            over all T outputs of one call (one K2 launch for a (T,) ts);
          wctx_unit(y, uv): 0. The JAX engine's unit builds the warp context
            a TPU needs; the port builds none.

        Returns (flow_unit, warp_unit, wctx_unit, warp_batch_unit), the order
        of the JAX engine's bench_units."""
        num_layers = self._radius_bucket()
        zero = torch.zeros((), dtype=torch.int64, device=self.device)

        def as_ts(ts, shape) -> torch.Tensor:
            return torch.as_tensor(ts, dtype=torch.float32, device=self.device).reshape(shape)

        def head_sum(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
            return (warp_ops.to_int32(y[:, 0, :8]).sum()
                    + warp_ops.to_int32(uv[:, 0, :8]).sum()) & 0xFFFFFFFF

        def flow_unit(y1, uv1, y2, uv2):
            blurred, delta_raw = self._run_pyramid(y1, uv1, y2, uv2, num_layers=num_layers)
            return (delta_raw + blurred[0, 0, 0].to(torch.int64)) & 0xFFFFFFFF

        def warp_unit(y1, uv1, y2, uv2, flow, t, mode=2):
            return head_sum(*self._run_warp(y1, uv1, y2, uv2, flow, as_ts(t, 1), mode))

        def warp_batch_unit(y1, uv1, y2, uv2, flow, ts, mode=2):
            return head_sum(*self._run_warp(y1, uv1, y2, uv2, flow, as_ts(ts, -1), mode))

        def wctx_unit(y, uv):
            return zero

        return flow_unit, warp_unit, wctx_unit, warp_batch_unit
