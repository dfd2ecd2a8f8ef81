"""The plain control plane of one stream: output cadence, timestamps and the
scene-change gate, and the plan of every output of a stream.

A frozen copy of the port's CadenceController and SceneChangeDetector
(hopperrender_tpu_torch/server/control.py), which follow the reference's
HopperRender.cpp:819-844, 938-972, 1031-1043, 1126-1197, and of the order in
which FrameServer.push_frame asks them (server/frame_server.py): the
cadence's count, the pair's frame delta once the stream is warm, then per
output the scene gate, the timing and the blending scalar. Times are
REFERENCE_TIME ticks (100 ns). The quality scaler is off in every cell, so
the state is ACTIVE (or NOT_NEEDED when the target is not above the source
rate) throughout.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque

ACTIVE, NOT_NEEDED = 2, 1
WARM_FRAMES = 3   # the engine interpolates from its third frame (frame_count >= 3)


def fps_to_frame_time(fps: float) -> int:
    return int((1.0 / float(fps)) * 1e7)


class SceneGate:
    """The 3 s frame-delta history and its decision (HopperRender.cpp:959-972,
    1126-1176). The 1 s scene-delta peaks only feed metrics and are left out."""

    def __init__(self) -> None:
        self.frame_deltas: deque[tuple[int, int]] = deque()

    def add_frame_delta(self, frame_count: int, total_delta: int, source_frame_time: int) -> None:
        frames_in_3s = int(3.0 * 1e7 / source_frame_time) if source_frame_time > 0 else 0
        self.frame_deltas.append((frame_count, total_delta))
        while self.frame_deltas and frame_count - self.frame_deltas[0][0] > frames_in_3s:
            self.frame_deltas.popleft()

    def evaluate(self, threshold: int) -> bool:
        hist = self.frame_deltas
        if len(hist) < 3:
            return False
        size = len(hist)
        count = min(size - 2, 10)
        average = sum(hist[size - 2 - i][1] for i in range(count)) // count
        delta1 = hist[size - 2][1] - average
        delta2 = hist[size - 2][1] - hist[size - 1][1]
        return delta1 >= threshold and delta1 > 0 and delta2 >= threshold and delta2 > 0


@dataclasses.dataclass(frozen=True)
class Output:
    """What a served output says of itself, besides its planes."""

    start_time: int
    end_time: int
    blending_scalar: float
    interpolated: bool
    scene_change: bool


def plan_stream(n_frames: int, frame_delta, *, source_fps: float, target_fps: float,
                scene_threshold: int, buffer_frames: int) -> list[list[Output]]:
    """Every output of the first n_frames source frames pushed from the start
    of a segment, pts = the frame's index times the source frame time.
    frame_delta(k) is the normalised delta of the pair (k - 1, k), k counted
    from 1; it is asked for k >= WARM_FRAMES only."""
    sft = fps_to_frame_time(source_fps)
    tft = fps_to_frame_time(target_fps)
    state = ACTIVE if sft > tft else NOT_NEEDED
    gate = SceneGate()
    blending = 0.0
    start = -1
    stream = []
    for k in range(1, n_frames + 1):
        if start == -1:
            start = (k - 1) * sft + 2 * sft + buffer_frames * tft
        num = max(math.ceil((1.0 - blending) / (tft / sft)), 1) if state == ACTIVE else 1
        warm = k >= WARM_FRAMES
        if state == ACTIVE and warm:
            gate.add_frame_delta(k, frame_delta(k), sft)
        outputs = []
        for _ in range(int(num)):
            scene = gate.evaluate(scene_threshold)
            outputs.append(Output(start, start + tft, blending,
                                  state == ACTIVE and warm and not scene, scene))
            start += tft
            if state == ACTIVE:
                blending += tft / sft
                if blending >= 1.0:
                    blending -= 1.0
        stream.append(outputs)
    return stream
