"""FrameServer — the frame-interpolation server over the PyTorch engine.

PyTorch port of hopperrender_tpu/server/frame_server.py. The control plane
(cadence and timestamps, scene gating, auto quality scaler, TooSlow policy,
side-data passthrough, display-rate polling, NV12/P010 packing) is the port's
own copy of the JAX package's framework-free code (config.py, server/,
utils/, vio/); this module wires it to the PyTorch engine.

API:
    server = FrameServer(width, height, source_fps=24.0, settings=Settings(target_fps=60))
    outputs = server.push_frame(y, uv, pts=..., side_data={...})   # planar
    outputs = server.push_packed(buf, pts=...)                     # NV12/P010 buffer
    server.new_segment(rate=1.0)                                   # seek / rate change
    server.update_settings(target_fps=120)                         # live (iez.h:39-50)
    m = server.metrics()                                           # iez.h:13-37 fields

Every output mode 0-6 runs. Modes 0/1/2 warp all of a source interval's
outputs in one batched K2 launch; the visualisation modes 3-6 warp each
output on its own, as the JAX server does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hopperrender_tpu_torch import config
from hopperrender_tpu_torch.config import ActiveState, Settings
from hopperrender_tpu_torch.server import sidedata as sd
from hopperrender_tpu_torch.server.control import AutoQualityScaler, CadenceController
from hopperrender_tpu_torch.server.display import DisplayRatePoller
from hopperrender_tpu_torch.utils import trace
from hopperrender_tpu_torch.utils.logging import get_logger
from hopperrender_tpu_torch.vio import nv12
from hopperrender_tpu_torch.engine.flow_engine import OpticalFlowEngine

BATCHED_MODES = (0, 1, 2)   # the modes whose interval shares one warp launch

log = get_logger("server")


@dataclasses.dataclass
class OutputFrame:
    """One delivered output sample (host planes)."""

    y: np.ndarray
    uv: np.ndarray
    start_time: int           # 100 ns ticks (REFERENCE_TIME semantics)
    end_time: int
    blending_scalar: float
    interpolated: bool        # False = passthrough copy
    scene_change: bool
    side_data: dict[str, bytes]

    def packed(self, stride: int | None = None) -> np.ndarray:
        return nv12.pack(self.y, self.uv, stride)


@dataclasses.dataclass
class ServerMetrics:
    """Live metrics snapshot — one field per out-param of the reference's
    GetCurrentSettings (ref: iez.h:13-37, HopperRender.cpp:1243-1352)."""

    activated: bool
    frame_output: int
    target_fps: float
    use_display_fps: bool
    delta_scalar: int
    neighbor_scalar: int
    black_level: int
    white_level: int
    scene_change_threshold: int
    active_state: int
    source_fps: float
    ofc_calc_time: float
    avg_ofc_calc_time: float
    peak_ofc_calc_time: float
    warp_calc_time: float
    dim_x: int
    dim_y: int
    low_dim_x: int
    low_dim_y: int
    peak_scene_change_delta: int
    peak_scene_change_delta2: int
    buffer_frames: int
    search_radius: int
    # Extension (no ref out-param): all of a source interval's interpolated
    # outputs come from one batched warp launch.
    batched_warp: bool = False


def _host(t: torch.Tensor) -> np.ndarray:
    trace.count(trace.HOST_SYNC)
    return t.cpu().numpy()


class FrameServer:
    def __init__(
        self,
        width: int,
        height: int,
        *,
        source_fps: float = 24.0,
        is_hdr: bool = False,
        settings: Settings | None = None,
        display_fps: float | None = None,
        device: str | torch.device = "cuda",
    ):
        """device: where the engine runs ("cuda" by default; raises without a
        CUDA device)."""
        self.settings = (settings or Settings()).validate()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FrameServer: device 'cuda' requested but no CUDA "
                               "device is available")
        self.is_hdr = is_hdr
        self.width = width
        self.height = height
        self._display_fps = display_fps
        self.cadence = CadenceController(
            source_fps, self._resolve_target_fps(),
            activated=self.settings.activated,
            buffer_frames=self.settings.buffer_frames,
        )
        self.scaler = AutoQualityScaler(enabled=self.settings.auto_quality)
        self.engine: OpticalFlowEngine | None = None  # lazy (ref: HopperRender.cpp:906-925)
        self._frame_index = 0
        # 5 s display refresh re-poll when following the display
        # (ref: HopperRender.cpp:793-800).
        self._display_poller = DisplayRatePoller() if (
            self.settings.use_display_fps and display_fps is None) else None

    # -- configuration ------------------------------------------------------

    @property
    def batched_warp(self) -> bool:
        """Settings.batched_warp, None meaning batched."""
        return self.settings.batched_warp is not False

    def _resolve_target_fps(self) -> float:
        """use_display_fps substitutes the display refresh rate for the user target
        (ref: HopperRender.cpp:1376-1380, useDisplayRefreshRate :329-345)."""
        if self.settings.use_display_fps and self._display_fps:
            return float(self._display_fps)
        return float(self.settings.target_fps)

    def _build_engine(self) -> OpticalFlowEngine:
        log.info("Initializing optical-flow engine %dx%d (%s) on %s", self.width,
                 self.height, "HDR/P010" if self.is_hdr else "SDR/NV12", self.device)
        return OpticalFlowEngine(
            self.height, self.width,
            is_hdr=self.is_hdr,
            delta_scalar=self.settings.delta_scalar,
            neighbor_scalar=self.settings.neighbor_scalar,
            black_level=float(self.settings.black_level),
            white_level=float(self.settings.white_level),
            max_calc_res=self.settings.max_calc_res,
            num_iterations=self.settings.num_iterations,
            device=self.device,
        )

    def update_settings(self, **kwargs) -> None:
        """Live settings update (ref: UpdateUserSettings HopperRender.cpp:1355-1435).
        Accepts any Settings field. Per-frame tunables apply without a rebuild;
        max_calc_res rebuilds the engine lazily on the next frame."""
        old = self.settings
        st = dataclasses.replace(old, **kwargs).validate()
        self.settings = st
        if "activated" in kwargs:
            self.cadence.set_activated(st.activated)
        self.cadence.buffer_frames = st.buffer_frames
        # Display-rate following starts/stops live (ref: HopperRender.cpp:1376-1380).
        if st.use_display_fps != old.use_display_fps:
            if st.use_display_fps and self._display_poller is None:
                self._display_poller = DisplayRatePoller()
                rate = self._display_poller.poll(force=True)
                if rate:
                    self._display_fps = rate
            elif not st.use_display_fps:
                self._display_poller = None
        self.cadence.set_target_fps(self._resolve_target_fps())
        self.scaler.enabled = st.auto_quality
        if self.engine is not None:  # (ref: HopperRender.cpp:1385-1390)
            self.engine.delta_scalar = st.delta_scalar
            self.engine.neighbor_scalar = st.neighbor_scalar
            self.engine.black_level = float(st.black_level)
            self.engine.white_level = float(st.white_level)
            self.engine.num_iterations = st.num_iterations
            if st.max_calc_res != old.max_calc_res:
                self.engine = None   # flow-grid geometry changed: rebuild lazily

    def set_display_fps(self, fps: float) -> None:
        """Display refresh-rate re-poll hook (ref: HopperRender.cpp:793-800)."""
        self._display_fps = fps
        self.cadence.set_target_fps(self._resolve_target_fps())

    def new_segment(self, rate: float = 1.0) -> None:
        """Seek / playback-rate change (ref: HopperRender.cpp:834-844)."""
        self.cadence.new_segment(rate)
        if self.engine is not None:
            self.engine.reset_stream()

    # -- streaming ----------------------------------------------------------

    def push_packed(self, buf, *, pts: int | None = None, stride: int | None = None,
                    side_data: dict[str, bytes] | None = None) -> list[OutputFrame]:
        y, uv = nv12.unpack(buf, self.height, self.width, stride, is_hdr=self.is_hdr)
        return self.push_frame(y, uv, pts=pts, side_data=side_data)

    def push_frame(self, y, uv, *, pts: int | None = None,
                   side_data: dict[str, bytes] | None = None) -> list[OutputFrame]:
        """Ingest one decoded source frame; return 0..N output frames
        (ref: CHopperRender::DeliverToRenderer, HopperRender.cpp:847-1211)."""
        with trace.span(trace.FRAME):
            return self._push_frame(y, uv, pts, side_data)

    def _push_frame(self, y, uv, pts, side_data) -> list[OutputFrame]:
        h, w = y.shape
        if (h, w) != (self.height, self.width):   # (ref: HopperRender.cpp:722-791)
            log.info("Resolution change %dx%d -> %dx%d", self.width, self.height, w, h)
            self.height, self.width = h, w
            self.engine = None
        if self.engine is None:
            self.engine = self._build_engine()
        eng = self.engine

        if pts is None:
            pts = self._frame_index * self.cadence.source_frame_time
        self._frame_index += 1

        if self._display_poller is not None:
            rate = self._display_poller.poll()
            if rate:
                self.set_display_fps(rate)

        # Auto quality scaling before this frame's work, including the cadence
        # decision, so a TooSlow flip applies to THIS frame's output count
        # (ref: HopperRender.cpp:951, 1438-1463).
        eng.search_radius = self.scaler.adjust(
            eng.search_radius, eng.ofc_time.current, self.cadence.playback_frame_time)
        if self.cadence.state == ActiveState.ACTIVE and self.scaler.too_slow:
            self.cadence.state = ActiveState.TOO_SLOW
            log.warning("Over budget at MIN_SEARCH_RADIUS for %d frames -> "
                        "TooSlow passthrough", config.TOO_SLOW_TRIP_FRAMES)
        elif self.cadence.state == ActiveState.TOO_SLOW and not self.scaler.too_slow:
            self.cadence.state = ActiveState.ACTIVE
            log.info("Back under budget -> interpolation re-activated")

        num_outputs = self.cadence.begin_source_frame(pts)
        eng.update_frame(y, uv)

        state = self.cadence.state
        warmed = eng.frame_count >= 3
        # Flow keeps running while TOO_SLOW (at the floor radius) so the scaler
        # can observe recovery; only the warps are replaced by copies.
        if state in (ActiveState.ACTIVE, ActiveState.TOO_SLOW) and warmed:
            eng.calculate_optical_flow()
            self.cadence.scene.add_frame_delta(
                eng.frame_count, eng.fetch_total_frame_delta(),
                self.cadence.source_frame_time)

        out_side = sd.passthrough(side_data)
        # Plan every output of this interval first (timing, scene gate,
        # warp-or-copy) so the interpolated ones share one batched warp.
        plans: list[tuple] = []
        for _ in range(num_outputs):
            scene_change = self.cadence.scene.evaluate(   # (ref: HopperRender.cpp:1126-1176)
                eng.frame_count, self.cadence.source_frame_time,
                self.settings.scene_change_threshold)
            timing = self.cadence.next_output_timing()
            interp = state == ActiveState.ACTIVE and warmed and not scene_change
            plans.append((timing, scene_change, interp))
            self.cadence.advance_blending()
        mode = int(self.settings.frame_output)
        warp_idx = [i for i, (_, _, interp) in enumerate(plans) if interp]
        warped: dict[int, tuple] = {}
        batch_per = 0.0
        if self.batched_warp and mode in BATCHED_MODES and len(warp_idx) > 1:
            pairs = eng.warp_frames_batch([plans[i][0].blending_scalar for i in warp_idx],
                                          mode)
            warped = dict(zip(warp_idx, pairs))
            batch_per = eng.warp_time.current   # per-output share of the batch
        outputs: list[OutputFrame] = []
        for i, (timing, scene_change, interp) in enumerate(plans):
            if i in warped:
                oy, ouv = warped[i]
                self.scaler.add_warp_duration(batch_per)
            else:
                if interp:
                    oy, ouv = eng.warp_frames(timing.blending_scalar, mode)
                else:  # (ref: HopperRender.cpp:1179-1183)
                    oy, ouv = eng.copy_frame()
                self.scaler.add_warp_duration(eng.warp_time.current)
            with trace.span("server.egress"):
                y_host, uv_host = _host(oy), _host(ouv)
            outputs.append(OutputFrame(
                y=y_host, uv=uv_host,
                start_time=timing.start_time, end_time=timing.end_time,
                blending_scalar=timing.blending_scalar,
                interpolated=interp, scene_change=scene_change,
                side_data=dict(out_side),
            ))
        return outputs

    # -- observability ------------------------------------------------------

    def metrics(self) -> ServerMetrics:
        eng = self.engine
        c = self.cadence
        return ServerMetrics(
            activated=c.state != ActiveState.DEACTIVATED,
            frame_output=self.settings.frame_output,
            target_fps=1e7 / c.target_frame_time if c.target_frame_time else 0.0,
            use_display_fps=self.settings.use_display_fps,
            delta_scalar=self.settings.delta_scalar,
            neighbor_scalar=self.settings.neighbor_scalar,
            black_level=self.settings.black_level,
            white_level=self.settings.white_level,
            scene_change_threshold=self.settings.scene_change_threshold,
            active_state=int(c.state),
            source_fps=1e7 / c.source_frame_time if c.source_frame_time else 0.0,
            ofc_calc_time=eng.ofc_time.current if eng else 0.0,
            avg_ofc_calc_time=eng.ofc_time.avg if eng else 0.0,
            peak_ofc_calc_time=eng.ofc_time.peak if eng else 0.0,
            warp_calc_time=eng.warp_time.current if eng else 0.0,
            dim_x=self.width,
            dim_y=self.height,
            low_dim_x=eng.low_w if eng else 0,
            low_dim_y=eng.low_h if eng else 0,
            peak_scene_change_delta=c.scene.peak_delta1,
            peak_scene_change_delta2=c.scene.peak_delta2,
            buffer_frames=self.settings.buffer_frames,
            search_radius=eng.search_radius if eng else config.MIN_SEARCH_RADIUS,
            batched_warp=self.batched_warp,
        )
