"""engine.flow_window_roofline: the flow's least time as a share of the
engine's timed flow window. The least time of one flow (hrbench/work.py
flow_s: each pyramid step's cost volume, K3, and winners' commit, K4, at
the cell's radius, then the blur, K1, from the cell's shapes and the
published peaks) over the mean engine.flow_ms of the window's pushes that
ran a flow, in percent. That window is the engine's CUDA events from the
ingest to the flow's end, so it holds the ingest's copies and any device
time idle between the launches besides K3, K4 and K1: the share is the
flow stage's, as the quality scaler times it, and not the kernels' own
(a traced run's device_ops give their device time)."""

from hrbench import work


def read(run):
    times = [p.flow_s for p in run.window if p.flow_s is not None]
    if not times:
        return None
    device = run.device if run.device.type == "cuda" else "cpu"
    return 100.0 * work.flow_s(run.config, run.radius, device) * len(times) / sum(times)
