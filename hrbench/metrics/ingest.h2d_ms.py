"""ingest.h2d_ms: device time of the host-to-device copies in the traced
window (the engine's update_frame takes two pageable planes a source
frame), per source frame pushed."""


def read(run):
    if run.trace is None:
        return None
    return sum(run.trace.h2d) / len(run.window) * 1e3
