"""kernel.roofline: the least time of the work the window's pushes needed
(hrbench/work.py: each flow's cost volume, commit and blur at the cell's
radius, each interval's warp in the cell's mode, each copy, from the cell's
shapes and the published peaks), over the device time of every kernel in
the traced window, in percent. No copy or fill counts as a kernel."""

from hrbench import work


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    device = run.device if run.device.type == "cuda" else "cpu"
    least = sum(work.push_s(run.config, run.radius, run.traffic["frame_output"], p, device)
                for p in run.window)
    return 100.0 * least / sum(s for _, s in run.trace.kernels)
