"""engine.warp_window_roofline: the warps' least time as a share of the
engine's timed warp windows. Over the window's pushes with interpolated
outputs, the least time of their warps by the rule of hrbench/work.py
push_s (one warp of T outputs in modes 0-2, one an output in mode 3; a
copy beside them, where a push has one, by its copy rule), summed, over the
same pushes' warp time as the quality scaler sums it (engine.warp_ms times
their outputs), in percent. That time is the engine's CUDA events around
the warp call, which open before the blending scalars' upload and hold any
device time idle until the host has queued K2: the share is the warp
stage's, as the quality scaler times it, and not K2's own (a traced run's
device_ops give K2's device time)."""

import dataclasses

from hrbench import work


def read(run):
    pushes = [p for p in run.window if any(m[3] for m in p.meta)]
    spent = sum(p.warp_s * len(p.meta) for p in pushes)
    if not spent:
        return None
    mode = run.traffic["frame_output"]
    least = sum(work.push_s(run.config, run.radius, mode, dataclasses.replace(p, flow_s=None))
                for p in pushes)
    return 100.0 * least / spent
