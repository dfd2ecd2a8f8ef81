"""engine.flow_ms: the mean, over the window's pushes that ran a flow, of
FrameServer.metrics().ofc_calc_time after the push: the engine's own CUDA
events from the ingest to the flow's end (CalcTimeWindow), the time the
quality scaler reads."""


def read(run):
    times = [p.flow_s for p in run.window if p.flow_s is not None]
    return sum(times) / len(times) * 1e3 if times else None
