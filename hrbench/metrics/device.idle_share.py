"""device.idle_share: the share of the traced window (first push_frame call
to last return, on the profiler's clock) in which the card ran no kernel,
copy or fill (the union of its activity), in percent."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
