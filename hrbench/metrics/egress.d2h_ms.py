"""egress.d2h_ms: device time of the device-to-host copies in the traced
window (FrameServer's _host: two planes an output), per source frame
pushed."""


def read(run):
    if run.trace is None:
        return None
    return sum(run.trace.d2h) / len(run.window) * 1e3
