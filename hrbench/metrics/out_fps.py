"""out_fps: output frames handed back by push_frame in the window, over the
window's seconds (host clock, first call to last return). Every output
counts, interpolated or copied."""


def read(run):
    return sum(len(p.meta) for p in run.window) / run.window_s
