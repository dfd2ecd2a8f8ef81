"""Closed loop, one client, one stream: the next source frame is pushed when
the previous push has returned with all of its outputs on the host, as the
reference filter's decoder thread calls Receive and waits for delivery
(HopperRender.cpp:847-1211). Frames come from the run's pool in its
ping-pong order, through FrameServer.push_frame, the served entry.

A warm-up of `warmup_frames` pushes runs first (the engine's two warm-up
copies, the first flow, every output count the cadence takes); after the
first push the engine's search radius is pinned to the configuration's.
Then pushes go back to back for the window's seconds. The client holds the
`render_queue` newest outputs, as a renderer holds the frames it has been
handed until it presents them (the reference filter delivers into a pool
of 5 output samples, HopperRender.cpp:538-541), and releases each older
one, unless the check keeps it.
"""

from __future__ import annotations

import collections
import time

from hrbench.record import Push


def _record(server, outputs, k: int, t0: float, t1: float) -> Push:
    m = server.metrics()
    meta = [(o.start_time, o.end_time, o.blending_scalar, o.interpolated, o.scene_change)
            for o in outputs]
    ran_flow = k >= 3 and m.active_state in (2, 3)
    warp_s = server.scaler.total_warp_duration / len(outputs) if outputs else 0.0
    return Push(k=k, t0=t0, t1=t1, meta=meta, flow_s=m.ofc_calc_time if ran_flow else None,
                warp_s=warp_s)


def serve(server, pool, traffic: dict, *, seconds: float, radius: int, keep, span,
          window_ctx):
    """Returns (warm-up pushes, window pushes, window seconds). keep(push,
    in_window, last) says whether to hold the push's host planes; span(name) is a
    context manager around each call into the program ("push_frame") and
    around the harness's own work between calls ("harness.bookkeeping");
    window_ctx() one around the window (the profiler in a traced run)."""
    warmup, window = [], []
    queue = collections.deque(maxlen=traffic["render_queue"])
    k = 0

    def push(in_window: bool, end: float = 0.0) -> Push:
        nonlocal k
        k += 1
        y, uv = pool.frames[pool.frame_index(k)]
        with span("push_frame"):
            t0 = time.perf_counter()
            outputs = server.push_frame(y, uv)
            t1 = time.perf_counter()
        with span("harness.bookkeeping"):
            rec = _record(server, outputs, k, t0, t1)
            if keep(rec, in_window, in_window and t1 >= end):
                rec.planes = [(o.y, o.uv) for o in outputs]
            queue.extend(outputs)
            del outputs
        return rec

    for _ in range(traffic["warmup_frames"]):
        warmup.append(push(False))
        if k == 1:
            server.engine.search_radius = radius
    with window_ctx():
        end = time.perf_counter() + seconds
        while True:
            rec = push(True, end)
            window.append(rec)
            if rec.t1 >= end:
                break
    return warmup, window, window[-1].t1 - window[0].t0
