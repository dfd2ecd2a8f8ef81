"""kernel.ms_per_frame: device time of every kernel in the traced window
(any name; no copy or fill), per source frame pushed."""


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    return sum(s for _, s in run.trace.kernels) / len(run.window) * 1e3
