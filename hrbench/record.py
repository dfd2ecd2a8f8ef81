"""What a run records, which the metric readers and the check read."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Push:
    """One source frame pushed: its number k in the stream (from 1), the host
    clock around the call into the program, what each output says of itself
    (start_time, end_time, blending_scalar, interpolated, scene_change), the
    engine's own flow time after the push (None where no flow ran), the
    warp time of its outputs as the quality scaler sums them, and the
    outputs' host planes where the check keeps them."""

    k: int
    t0: float
    t1: float
    meta: list
    flow_s: float | None
    warp_s: float
    planes: list | None = None


@dataclasses.dataclass
class Run:
    """One run of one cell. window holds the pushes of the measured window;
    window_s is its length on the host clock, from the first push's call to
    the last push's return; radius the engine's search radius; device the
    torch.device served on. trace is a hrbench.trace.Trace in a traced run,
    else None."""

    cell: str
    config: dict
    traffic: dict
    warmup: list
    window: list
    window_s: float
    setup_s: float
    peak_bytes: int
    radius: int
    device: object
    trace: object = None
