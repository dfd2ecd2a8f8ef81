"""engine.warp_ms: the engine's warp (or copy) time per output in the
window, as the quality scaler sums it (a batched warp's per-output share
in modes 0-2; each output's own launch and sync in modes 3-6)."""


def read(run):
    n = sum(len(p.meta) for p in run.window)
    return sum(p.warp_s * len(p.meta) for p in run.window) / n * 1e3 if n else None
