"""Engine constants and user settings.

The PyTorch port's own copy of hopperrender_tpu/config.py (the port imports
nothing of the JAX package); tests/test_torch_control.py holds the two
to the same behaviour.

TPU-native re-expression of the reference's three config tiers:
  * compile-time constants   (ref: HopperRender/config.h:1-29)
  * persisted user settings  (ref: HopperRender.cpp:1466-1607 registry load,
                              HopperRenderSettings.cpp:527-579 registry save)
  * live setters             (ref: iez.h:39-50 UpdateUserSettings)

Persistence here is a JSON file instead of the Windows registry; the key set is
identical so a reference user finds every knob.
"""

from __future__ import annotations

import dataclasses
import json
import os
from enum import IntEnum

# --- Quality adjustments (ref: config.h:3-9) ---
MAX_CALC_RES = 270        # max flow-calc resolution (input halved until height <= this)
NUM_ITERATIONS = 0        # 0 = as many pyramid iterations as possible
MIN_SEARCH_RADIUS = 5
MAX_SEARCH_RADIUS = 16    # also the padded/static layer count for the TPU cost volume

# --- Performance adjustments (ref: config.h:11-17) ---
AUTO_SEARCH_RADIUS_ADJUST = True
UPPER_PERF_BUFFER = 1.4   # calc_time * this > frame_time  -> reduce quality
LOWER_PERF_BUFFER = 1.6   # calc_time * this < frame_time  -> raise quality
CALC_TIME_INTERVAL = 240  # frames between avg/peak metric window resets

# --- TooSlow / over-budget policy ---
# The reference defines ActiveState::TooSlow and checks the budget but leaves the
# auto-disable commented out (ref: HopperRender.h:21-26, HopperRender.cpp:1438-1463,
# disable at :1450-1452) — it keeps interpolating and stutters. We implement the
# policy honestly: when the scaler sits at MIN_SEARCH_RADIUS and
# (flow + warps) * UPPER_PERF_BUFFER still exceeds the frame time for
# TOO_SLOW_TRIP_FRAMES consecutive source frames, the server switches to
# passthrough copyFrame outputs at source cadence and reports state 3. Flow keeps
# running (at the floor radius) so recovery stays measurable; after
# TOO_SLOW_RECOVER_FRAMES consecutive under-budget frames it re-activates.
TOO_SLOW_TRIP_FRAMES = 10
TOO_SLOW_RECOVER_FRAMES = 30

# --- Defaults (ref: config.h:23-29) ---
DEFAULT_DELTA_SCALAR = 8
DEFAULT_NEIGHBOR_SCALAR = 6
DEFAULT_BLACK_LEVEL = 0
DEFAULT_WHITE_LEVEL = 255
DEFAULT_SCENE_CHANGE_THRESHOLD = 200
DEFAULT_BUFFER_FRAMES = 0

# Engine-internal: kernel first uses the neighbor bias from this pyramid iteration
# (ref: calcDeltaSumsKernelSDR.h:3).
FIRST_NEIGHBOR_ITERATION = 4

# Reference time base: DirectShow REFERENCE_TIME = 100 ns units
# (ref: HopperRender.cpp:940-948 uses 10_000_000 per second).
TICKS_PER_SECOND = 10_000_000


class ActiveState(IntEnum):
    """Interpolation state machine (ref: HopperRender.h:21-26, iez.h:22)."""

    DEACTIVATED = 0
    NOT_NEEDED = 1
    ACTIVE = 2
    TOO_SLOW = 3


class FrameOutput(IntEnum):
    """Output modes (ref: iez.h:16, warpFrameKernelSDR.h:128-183)."""

    WARPED_FRAME_12 = 0
    WARPED_FRAME_21 = 1
    BLENDED_FRAME = 2
    HSV_FLOW = 3
    GREY_FLOW = 4
    SIDE_BY_SIDE_1 = 5
    SIDE_BY_SIDE_2 = 6


@dataclasses.dataclass
class Settings:
    """Persisted user settings — same key set as the reference registry values
    (ref: HopperRender.cpp:1466-1607)."""

    activated: bool = True
    frame_output: int = int(FrameOutput.BLENDED_FRAME)
    target_fps: float = 60.0
    use_display_fps: bool = True
    delta_scalar: int = DEFAULT_DELTA_SCALAR
    neighbor_scalar: int = DEFAULT_NEIGHBOR_SCALAR
    black_level: int = DEFAULT_BLACK_LEVEL
    white_level: int = DEFAULT_WHITE_LEVEL
    max_calc_res: int = MAX_CALC_RES
    scene_change_threshold: int = DEFAULT_SCENE_CHANGE_THRESHOLD
    buffer_frames: int = DEFAULT_BUFFER_FRAMES
    # Test-mode knobs (compile-time in the reference): auto_quality disables the
    # search-radius scaler for reproducible measurements (ref: CHANGELOG.md Test
    # Mode, config.h:12); num_iterations pins the pyramid depth (0 = auto,
    # ref: config.h:6).
    auto_quality: bool = AUTO_SEARCH_RADIUS_ADJUST
    num_iterations: int = NUM_ITERATIONS
    # Per-pair batched warp dispatch (one warp_frames_batch launch per source
    # interval). Chip-proven bit-exact round 5; None = follow the engine
    # default (flow_engine.batched_warp_enabled, env-overridable), True/False
    # pins it — the honest settings surface for the flipped default.
    batched_warp: bool | None = None

    def validate(self) -> "Settings":
        """Range checks matching the property page (ref: HopperRenderSettings.cpp:370-378)."""
        if not self.target_fps > 0:
            # The reference guards dTargetFPS > 0.0 before using it
            # (ref: HopperRender.cpp:1376-1380); fps_to_frame_time divides by it.
            raise ValueError(f"target_fps must be > 0: {self.target_fps}")
        if not 0 <= self.delta_scalar <= 10:
            raise ValueError(f"delta_scalar out of range [0,10]: {self.delta_scalar}")
        if not 0 <= self.neighbor_scalar <= 10:
            raise ValueError(f"neighbor_scalar out of range [0,10]: {self.neighbor_scalar}")
        if not 0 <= self.black_level <= 255:
            raise ValueError(f"black_level out of range [0,255]: {self.black_level}")
        if not 0 <= self.white_level <= 255:
            raise ValueError(f"white_level out of range [0,255]: {self.white_level}")
        if not 0 <= self.scene_change_threshold <= 100000:
            raise ValueError(
                f"scene_change_threshold out of range [0,100000]: {self.scene_change_threshold}"
            )
        if not 0 <= self.buffer_frames <= 1000:
            raise ValueError(f"buffer_frames out of range [0,1000]: {self.buffer_frames}")
        if self.max_calc_res < 32:
            raise ValueError(f"max_calc_res must be >= 32: {self.max_calc_res}")
        if not 0 <= self.frame_output <= 6:
            raise ValueError(f"frame_output out of range [0,6]: {self.frame_output}")
        if self.num_iterations < 0:
            raise ValueError(f"num_iterations must be >= 0: {self.num_iterations}")
        return self

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "Settings":
        if not os.path.exists(path):
            return cls()
        with open(path) as f:
            data = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known}).validate()


def default_settings_path() -> str:
    """Config file location (registry-equivalent persistence)."""
    base = os.environ.get("XDG_CONFIG_HOME", os.path.expanduser("~/.config"))
    return os.path.join(base, "hopperrender_tpu", "settings.json")


def calc_resolution_scalar(frame_height: int, max_calc_res: int) -> int:
    """Number of 2x downscales so flow-calc height <= max_calc_res
    (ref: opticalFlowCalcSDR.cpp:217-220)."""
    res_scalar = 0
    while (frame_height >> res_scalar) > max_calc_res:
        res_scalar += 1
    return res_scalar


def calc_flow_dims(frame_height: int, frame_width: int, max_calc_res: int) -> tuple[int, int, int]:
    """(res_scalar, low_h, low_w) — flow grid dims (ref: opticalFlowCalcSDR.cpp:217-222)."""
    rs = calc_resolution_scalar(frame_height, max_calc_res)
    low_w = -(-frame_width // (1 << rs))   # ceil
    low_h = -(-frame_height // (1 << rs))  # ceil
    return rs, low_h, low_w


def initial_window_size(low_h: int, low_w: int) -> int:
    """next_pow2(max(low_w, low_h)) / 2 (ref: opticalFlowCalcSDR.cpp:48-59)."""
    max_dim = max(low_w, low_h)
    if max_dim and (max_dim & (max_dim - 1)) == 0:
        window = max_dim
    else:
        while max_dim & (max_dim - 1):
            max_dim &= max_dim - 1
        window = max_dim << 1
    return window // 2


def num_pyramid_iterations(window_size: int, num_iterations: int = NUM_ITERATIONS) -> int:
    """Iteration count; 0 = auto = log2(window) (ref: opticalFlowCalcSDR.cpp:62-65)."""
    auto = window_size.bit_length() - 1  # log2 for power of two
    if num_iterations == 0 or num_iterations > auto:
        return auto
    return num_iterations
