"""frame_ms_p95: the 95th percentile, over every source frame pushed in the
window, of the host time from calling push_frame to its return with all of
that frame's outputs on the host: the tail that decides a dropped frame
against the source interval. Read in the traced run, so the profiler's
host overhead is in it."""

import numpy as np


def read(run):
    return float(np.percentile([(p.t1 - p.t0) * 1e3 for p in run.window], 95))
