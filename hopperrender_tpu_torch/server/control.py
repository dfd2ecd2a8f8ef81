"""Host control plane: interpolation state machine, frame cadence, scene-change
detection, auto quality scaler, and live settings updates.

The PyTorch port's own copy of hopperrender_tpu/server/control.py (the port imports
nothing of the JAX package); tests/test_torch_control.py holds the two
to the same behaviour.

Pure-Python ports of the reference's host-side logic (all math, no platform code):

  * ActiveState machine + UpdateInterpolationStatus  (ref: HopperRender.cpp:819-831)
  * Segment / seek / rate handling                   (ref: HopperRender.cpp:834-844)
  * Output cadence: intermediate-frame count, blending scalar accumulation,
    presentation timestamps                          (ref: HopperRender.cpp:938-948,
                                                      1031-1043, 1191-1197)
  * Scene-change detection: 3 s frame-delta sliding window, 10-frame average,
    1 s scene-delta window with peak tracking        (ref: HopperRender.cpp:959-972,
                                                      1126-1176)
  * Auto quality scaler: search radius +-1 based on (flow+warp) time vs the source
    frame interval                                   (ref: HopperRender.cpp:1438-1463,
                                                      config.h:14-15)
  * Source-fps override when the container disagrees with per-sample timing
    (MediaInfo probe analogue)                       (ref: HopperRender.cpp:426-442)
  * Live settings update                             (ref: HopperRender.cpp:1355-1435,
                                                      iez.h:39-50)

Times are REFERENCE_TIME ticks (100 ns units, 1e7 per second) to match the reference's
integer timestamp math exactly.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque

from hopperrender_tpu_torch import config
from hopperrender_tpu_torch.config import ActiveState

TICKS = config.TICKS_PER_SECOND


def fps_to_frame_time(fps: float) -> int:
    """(ref: HopperRender.cpp:1376: (1.0 / fps) * 1e7)."""
    return int((1.0 / float(fps)) * 1e7)


@dataclasses.dataclass
class _DeltaEntry:
    frame_number: int
    total_delta: int


@dataclasses.dataclass
class _SceneEntry:
    frame_number: int
    delta1: int
    delta2: int


class SceneChangeDetector:
    """Frame-delta history (3 s) + scene-change delta history (1 s) with peaks
    (ref: HopperRender.cpp:959-972, 1126-1176)."""

    def __init__(self) -> None:
        self.frame_deltas: deque[_DeltaEntry] = deque()
        self.scene_deltas: deque[_SceneEntry] = deque()
        self.peak_delta1 = 0
        self.peak_delta2 = 0

    def clear(self) -> None:
        """(ref: HopperRender.cpp:827-830)."""
        self.frame_deltas.clear()
        self.scene_deltas.clear()
        self.peak_delta1 = 0
        self.peak_delta2 = 0

    def add_frame_delta(self, frame_count: int, total_delta: int, source_frame_time: int) -> None:
        """Record the current pair's delta; prune entries older than 3 s
        (ref: HopperRender.cpp:959-972)."""
        frames_in_3s = int(3.0 * 1e7 / source_frame_time) if source_frame_time > 0 else 0
        self.frame_deltas.append(_DeltaEntry(frame_count, total_delta))
        while self.frame_deltas and (
            frame_count - self.frame_deltas[0].frame_number
        ) > frames_in_3s:
            self.frame_deltas.popleft()

    def evaluate(self, frame_count: int, source_frame_time: int, threshold: int) -> bool:
        """Scene-change decision for the frame pair being warped
        (ref: HopperRender.cpp:1126-1176). Also updates the 1 s peak window."""
        hist = self.frame_deltas
        if len(hist) < 3:
            return False
        size = len(hist)
        count = min(size - 2, 10)
        total = sum(hist[size - 2 - i].total_delta for i in range(count))
        average = total // count
        next_delta = hist[size - 1].total_delta      # the newest pair (N-1, N)
        current_delta = hist[size - 2].total_delta   # the pair being warped (N-2, N-1)
        delta1 = current_delta - average
        delta2 = current_delta - next_delta

        if delta1 > 0:
            frames_in_1s = int(1.0 * 1e7 / source_frame_time) if source_frame_time > 0 else 0
            self.scene_deltas.append(
                _SceneEntry(frame_count, delta1, delta2 if delta2 > 0 else 0)
            )
            while self.scene_deltas and (
                frame_count - self.scene_deltas[0].frame_number
            ) > frames_in_1s:
                self.scene_deltas.popleft()
            self.peak_delta1 = 0
            self.peak_delta2 = 0
            for e in self.scene_deltas:
                if e.delta1 > self.peak_delta1:
                    self.peak_delta1 = e.delta1
                    self.peak_delta2 = e.delta2

        return delta1 >= threshold and delta1 > 0 and delta2 >= threshold and delta2 > 0


class AutoQualityScaler:
    """Search-radius auto adjustment (ref: HopperRender.cpp:1438-1463)."""

    def __init__(self, enabled: bool = config.AUTO_SEARCH_RADIUS_ADJUST):
        self.enabled = enabled
        self.total_warp_duration = 0.0  # seconds, accumulated per output frame
        # TooSlow policy state (see config.py TOO_SLOW_* for the policy contract;
        # ref: HopperRender.h:21-26, HopperRender.cpp:1438-1463).
        self.too_slow = False
        self._over_count = 0       # consecutive over-budget frames at the floor
        self._under_count = 0      # consecutive under-budget frames while TooSlow
        self._warp_estimate = 0.0  # per-source warp cost (s), frozen at trip time

    def add_warp_duration(self, seconds: float) -> None:
        """(ref: HopperRender.cpp:1189)."""
        self.total_warp_duration += seconds

    def adjust(self, search_radius: int, ofc_calc_time: float, playback_frame_time: int) -> int:
        """Returns the new search radius; resets the warp accumulator.

        Also maintains the TooSlow flag: trips after TOO_SLOW_TRIP_FRAMES
        consecutive over-budget frames at MIN_SEARCH_RADIUS; while tripped, the
        warps are passthrough copies, so the budget test uses the warp cost
        frozen at trip time plus the live flow cost, and recovers after
        TOO_SLOW_RECOVER_FRAMES consecutive frames back under budget.
        """
        if not self.enabled:
            self.total_warp_duration = 0.0
            return search_radius
        frame_time_s = playback_frame_time / 1e7
        if self.too_slow:
            estimate = ofc_calc_time + self._warp_estimate
            if estimate * config.UPPER_PERF_BUFFER <= frame_time_s:
                self._under_count += 1
                if self._under_count >= config.TOO_SLOW_RECOVER_FRAMES:
                    self.too_slow = False
                    self._over_count = 0
                    self._under_count = 0
            else:
                self._under_count = 0
            self.total_warp_duration = 0.0
            return search_radius
        duration = ofc_calc_time + self.total_warp_duration
        if duration * config.UPPER_PERF_BUFFER > frame_time_s:
            if search_radius > config.MIN_SEARCH_RADIUS:
                search_radius -= 1
                self._over_count = 0
            else:
                # At the floor and still over budget: the reference's auto-disable
                # is commented out (ref: HopperRender.cpp:1450-1452); we take it.
                self._over_count += 1
                if self._over_count >= config.TOO_SLOW_TRIP_FRAMES:
                    self.too_slow = True
                    self._warp_estimate = self.total_warp_duration
                    self._under_count = 0
        else:
            self._over_count = 0
            if (duration * config.LOWER_PERF_BUFFER < frame_time_s
                    and search_radius < config.MAX_SEARCH_RADIUS):
                search_radius += 1
        self.total_warp_duration = 0.0
        return search_radius


@dataclasses.dataclass
class OutputTiming:
    start_time: int
    end_time: int
    blending_scalar: float  # the scalar USED for this output frame


class CadenceController:
    """Interpolation state machine + output cadence + timestamps."""

    def __init__(
        self,
        source_fps: float,
        target_fps: float,
        *,
        activated: bool = True,
        buffer_frames: int = 0,
    ):
        self.source_frame_time = fps_to_frame_time(source_fps)
        self.playback_frame_time = self.source_frame_time
        self.target_frame_time = fps_to_frame_time(target_fps)
        self.buffer_frames = buffer_frames
        self.state = ActiveState.ACTIVE if activated else ActiveState.DEACTIVATED
        self.blending_scalar = 0.0
        self.curr_start_time = -1  # -1 = new segment (ref: HopperRender.cpp:841)
        self.scene = SceneChangeDetector()
        self.update_interpolation_status()

    # -- state machine ------------------------------------------------------

    def update_interpolation_status(self) -> None:
        """(ref: HopperRender.cpp:819-831)."""
        if self.state != ActiveState.DEACTIVATED and (
            self.playback_frame_time > self.target_frame_time
        ):
            self.state = ActiveState.ACTIVE
        elif self.state != ActiveState.DEACTIVATED:
            self.state = ActiveState.NOT_NEEDED
        self.scene.clear()

    def new_segment(self, rate: float = 1.0) -> None:
        """Seek / rate change (ref: HopperRender.cpp:834-844)."""
        self.playback_frame_time = int(self.source_frame_time * (1.0 / rate))
        self.update_interpolation_status()
        self.curr_start_time = -1

    def set_source_fps(self, source_fps: float, *, keep_rate: bool = True) -> None:
        speed_ratio = (
            self.playback_frame_time / self.source_frame_time
            if keep_rate and self.source_frame_time
            else 1.0
        )
        self.source_frame_time = fps_to_frame_time(source_fps)
        self.playback_frame_time = int(self.source_frame_time * speed_ratio)
        self.update_interpolation_status()

    def maybe_override_source_fps(self, container_fps: float) -> bool:
        """Container-vs-sample fps disagreement (VFR / bad AvgTimePerFrame); override
        if the ratio leaves [0.8, 1.2] (ref: HopperRender.cpp:426-442)."""
        if container_fps <= 0.0 or self.source_frame_time <= 0:
            return False
        container_frame_time = int(1e7 / container_fps)
        ratio = container_frame_time / self.source_frame_time
        if ratio > 1.2 or ratio < 0.8:
            speed_ratio = self.playback_frame_time / self.source_frame_time
            self.source_frame_time = container_frame_time
            self.playback_frame_time = int(self.source_frame_time * speed_ratio)
            self.update_interpolation_status()
            return True
        return False

    def set_target_fps(self, target_fps: float) -> None:
        self.target_frame_time = fps_to_frame_time(target_fps)
        self.update_interpolation_status()

    def set_activated(self, activated: bool) -> None:
        """(ref: HopperRender.cpp:1370-1374)."""
        if not activated:
            self.state = ActiveState.DEACTIVATED
        elif self.state == ActiveState.DEACTIVATED:
            self.state = ActiveState.ACTIVE
        self.update_interpolation_status()

    # -- cadence ------------------------------------------------------------

    def begin_source_frame(self, input_start_time: int) -> int:
        """Seed timestamps at segment start (2-source-frame pipeline latency plus
        buffer frames, ref: HopperRender.cpp:938-941) and return the number of output
        frames for this source frame (ref: HopperRender.cpp:943-948)."""
        if self.curr_start_time == -1:
            self.curr_start_time = (
                input_start_time
                + 2 * self.source_frame_time
                + self.buffer_frames * self.target_frame_time
            )
        if self.state == ActiveState.ACTIVE:
            num = max(
                math.ceil(
                    (1.0 - self.blending_scalar)
                    / (self.target_frame_time / self.playback_frame_time)
                ),
                1,
            )
        else:
            num = 1
        return int(num)

    def next_output_timing(self) -> OutputTiming:
        """Timestamp one output frame and advance the clock
        (ref: HopperRender.cpp:1031-1043)."""
        # DEACTIVATED and TOO_SLOW both emit one passthrough copy per source
        # frame, so each output occupies a full source-frame interval.
        step = (
            self.playback_frame_time
            if self.state in (ActiveState.DEACTIVATED, ActiveState.TOO_SLOW)
            else self.target_frame_time
        )
        timing = OutputTiming(
            start_time=self.curr_start_time,
            end_time=self.curr_start_time + step,
            blending_scalar=self.blending_scalar,
        )
        self.curr_start_time += step
        return timing

    def advance_blending(self) -> None:
        """After each output frame (ref: HopperRender.cpp:1191-1197)."""
        if self.state == ActiveState.ACTIVE:
            self.blending_scalar += self.target_frame_time / self.playback_frame_time
            if self.blending_scalar >= 1.0:
                self.blending_scalar -= 1.0
