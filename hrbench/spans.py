"""The program's own spans and counters in a traced window
(hopperrender_tpu_torch/utils/trace.py): totals, self times (a span's
duration less what its child spans cover), counts and counters by span
name, and totals by request (one request a source frame); the program's
clock mapped onto the profiler's; each idle gap of the device put down to
the innermost program span covering its middle; and the host-side
readings of the served path a source frame (readings()).

The benchmark's own runs leave the program's tracer off. This module
serves a cell's warm-up and a traced window itself, as a traced run of the
benchmark does (the same pool, server, driver and profiler), with the
tracer on inside the profiler's window, and prints what the spans read:

    python3 -m hrbench.spans --workload <cell> --seed <n> --seconds <s>

Standard error gets the alignment's error, the coverage and the idle time
by program span; the last line of standard output is one JSON object of
the readings beside the benchmark's own readers of the same window
(out_fps, device.idle_share, device.events_per_frame, kernel.ms_per_frame).
A program without the tracer leaves no records, and then the readings are
empty.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import importlib
import json
import resource
import statistics
import sys
import time

import torch

from hrbench import harness, inputs
from hrbench import trace as trace_mod
from hrbench.record import Run

OUTSIDE = "outside program spans"
TOP = 10


@dataclasses.dataclass
class Spans:
    """The program's spans of one traced window; seconds."""

    total_s: dict        # span name -> summed duration
    self_s: dict         # span name -> summed self time
    count: dict          # span name -> number of spans
    counters: dict       # span name -> {counter: total}
    requests: list       # one (root name, seconds, {counter: total}) a request
    clock: ClockFit | None = None           # the program's clock on the profiler's
    push_cover: float | None = None         # root time / the harness's push time
    idle_in_push_s: float | None = None     # device idle inside the harness's pushes
    idle_named_s: float | None = None       # of which under a program span
    idle_by_span: list = dataclasses.field(default_factory=list)  # [[name, s]], TOP
    faults: int | None = None   # the serving thread's minor page faults in the window


def program_tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        return importlib.import_module("hopperrender_tpu_torch.utils.trace")
    except ImportError:
        return None


_tracer = program_tracer()
HOST_SYNC = getattr(_tracer, "HOST_SYNC", None)   # the program's host-sync counter
ROOT = getattr(_tracer, "FRAME", None)            # its span of one source frame


def _minflt() -> int:
    return resource.getrusage(resource.RUSAGE_THREAD).ru_minflt


@dataclasses.dataclass
class Window:
    """What the program recorded in a traced window."""

    records: list = dataclasses.field(default_factory=list)
    faults: int | None = None


@contextlib.contextmanager
def traced_window(prof, got: Window):
    """The profiler's window, with the program's tracer on inside it; when
    the window closes, what the tracer recorded goes to got.records, and
    the calling thread's (the serving thread's) minor page faults over the
    window to got.faults."""
    with prof:
        if _tracer is None:
            yield
            return
        _tracer.drain()
        _tracer.enable(True)
        flt0 = _minflt()
        try:
            yield
        finally:
            got.faults = _minflt() - flt0
            _tracer.enable(False)
            got.records.extend(_tracer.drain())


def _covered(merged, lo, hi, starts=None) -> float:
    """Length of [lo, hi] that `merged` (sorted, disjoint intervals) covers;
    `starts`, their starts, finds the first one at once."""
    k = max(0, bisect.bisect_right(starts, lo) - 1) if starts is not None else 0
    n = 0.0
    for s, e in merged[k:]:
        if s >= hi:
            break
        if e > lo:
            n += min(e, hi) - max(s, lo)
    return n


def _intersect(a, b) -> list:
    """The intersection of two lists of sorted, disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append([lo, hi])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def reduce(records) -> Spans:
    """Sums by span name and by request of the tracer's records."""
    children: dict[int, list] = {}
    for r in records:
        if r.parent:
            children.setdefault(r.parent, []).append((r.t0_ns, r.t1_ns))
    total, own, count, counters, by_request = {}, {}, {}, {}, {}
    for r in records:
        dur = r.t1_ns - r.t0_ns
        total[r.name] = total.get(r.name, 0) + dur
        own[r.name] = own.get(r.name, 0) + dur - _covered(
            trace_mod._union(children.get(r.span, ())), r.t0_ns, r.t1_ns)
        count[r.name] = count.get(r.name, 0) + 1
        mine = counters.setdefault(r.name, {})
        req = by_request.setdefault(r.request, [None, 0, {}])
        if not r.parent:
            req[0], req[1] = r.name, dur / 1e9
        for k, v in r.counters.items():
            mine[k] = mine.get(k, 0) + v
            req[2][k] = req[2].get(k, 0) + v
    return Spans(total_s={k: v / 1e9 for k, v in total.items()},
                 self_s={k: v / 1e9 for k, v in own.items()}, count=count,
                 counters=counters, requests=[tuple(v) for v in by_request.values()])


@dataclasses.dataclass
class ClockFit:
    """The program's clock (time.perf_counter) on the profiler's: profiler
    us = program us + offset_us."""

    offset_us: float
    spread_us: float    # max - min of the pushes' offsets: the alignment's error
    iqr_us: float       # the distance of their quartiles: the typical error

    def to_profiler_us(self, t_ns: int) -> float:
        return t_ns / 1e3 + self.offset_us


def clock_fit(prof_starts_us, host_t0_s) -> ClockFit:
    """The median over the window's pushes of the harness's push_frame
    range start (profiler clock) less that push's Push.t0."""
    d = [s - t * 1e6 for s, t in zip(prof_starts_us, host_t0_s)]
    q1, offset, q3 = statistics.quantiles(d, n=4) if len(d) > 1 else d * 3
    return ClockFit(offset_us=offset, spread_us=max(d) - min(d), iqr_us=q3 - q1)


def attribute_idle(busy, w0, w1, pushes, records, to_profiler_us):
    """Idle gaps of the device in [w0, w1] (profiler microseconds; `busy`
    the union of its activity, `pushes` the harness's push_frame ranges)
    put down to the innermost program span covering each gap's middle,
    the records' times mapped by to_profiler_us(ns). Returns ({span name:
    idle s}, idle s inside `pushes`, of which s inside a root program
    span)."""
    spans = sorted(((to_profiler_us(r.t0_ns), to_profiler_us(r.t1_ns), r.name)
                    for r in records))
    starts = [s for s, _, _ in spans]
    pushes = trace_mod._union(pushes)
    roots = trace_mod._union([(to_profiler_us(r.t0_ns), to_profiler_us(r.t1_ns))
                              for r in records if not r.parent])
    named_iv = _intersect(pushes, roots)
    push_starts = [s for s, _ in pushes]
    named_starts = [s for s, _ in named_iv]
    by_span, in_push, named, t = {}, 0.0, 0.0, w0
    for s, e in list(busy) + [[w1, w1]]:
        if s > t:
            mid = (s + t) / 2
            label = OUTSIDE
            i = bisect.bisect_right(starts, mid) - 1
            for s0, e0, name in reversed(spans[max(0, i - 256):i + 1]):
                if e0 >= mid:
                    label = name
                    break
            by_span[label] = by_span.get(label, 0.0) + (s - t) / 1e6
            in_push += _covered(pushes, t, s, push_starts) / 1e6
            named += _covered(named_iv, t, s, named_starts) / 1e6
        t = max(t, e)
    return by_span, in_push, named


def read(prof, got: Window, window) -> Spans | None:
    """The Spans of a traced window, with the profiler's device activity
    and the harness's push_frame ranges; prints the alignment's error, the
    coverage and the idle time by program span to standard error. None
    without records."""
    records = got.records
    if not records:
        return None
    out = reduce(records)
    out.faults = got.faults
    host_s = sum(p.t1 - p.t0 for p in window)
    out.push_cover = out.total_s.get(ROOT, 0.0) / host_s if host_s else None
    cuda = torch.autograd.DeviceType.CUDA
    pushes, device = [], []
    for e in prof.events():
        iv = (e.time_range.start, e.time_range.end)
        if e.name in trace_mod.SPANS:
            if e.name == "push_frame" and e.device_type != cuda:
                pushes.append(iv)
        elif e.device_type == cuda:
            device.append(iv)
    pushes.sort()
    line = (f"hrbench: program spans: {len(out.requests)} requests over {len(window)} pushes; "
            f"{ROOT} covers {100 * (out.push_cover or 0):.2f}% of the pushes' host time")
    if len(pushes) == len(window) and pushes:
        out.clock = fit = clock_fit([s for s, _ in pushes], [p.t0 for p in window])
        w0, w1 = pushes[0][0], max(e for _, e in pushes)
        inside = [(max(s, w0), min(e, w1)) for s, e in device if e > w0 and s < w1]
        by_span, out.idle_in_push_s, out.idle_named_s = attribute_idle(
            trace_mod._union(inside), w0, w1, pushes, records, fit.to_profiler_us)
        out.idle_by_span = [[k, v] for k, v in
                            sorted(by_span.items(), key=lambda kv: -kv[1])[:TOP]]
        share = out.idle_named_s / out.idle_in_push_s if out.idle_in_push_s else 0.0
        line += (f"; clock offset spread {fit.spread_us:.1f} us (quartiles {fit.iqr_us:.1f} "
                 f"us apart); device idle inside push_frame {out.idle_in_push_s:.3f} s, "
                 f"{100 * share:.2f}% under a program span; serving thread's minor faults "
                 f"{out.faults}")
        print(line, file=sys.stderr)
        print("hrbench: idle by program span: " + "; ".join(
            f"{k} {v:.3f} s" for k, v in out.idle_by_span), file=sys.stderr)
    else:
        print(line + f"; {len(pushes)} push_frame ranges in the profile, not aligned",
              file=sys.stderr)
    return out


def readings(s: Spans, window) -> dict:
    """What the spans of a traced window read, a source frame pushed (the
    window's pushes) unless named otherwise; a name whose spans the window
    lacks is left out. Host milliseconds:

    server.control_ms    the root's self time: the scaler, TooSlow, the
                         cadence, the scene plan, the OutputFrame building
    ingest.host_ms       engine.ingest: update_frame's two pageable H2D copies
    engine.flow_host_ms  engine.flow's self time, a flow: the host enqueueing
                         the pyramid's flow_step calls and K1
    engine.warp_host_ms  engine.warp and engine.copy's self time, an output:
                         the blending scalars' upload and the K2 or K6 call
    egress.host_ms       server.egress: each output's two D2H copies into new
                         host memory and their NumPy views
    device.host_wait_ms  the sync.* spans: the host's waits alone

    and counts: device.host_syncs_per_frame (the host_sync counter: each
    wait on work already queued on the card) and egress.faults_per_frame
    (the serving thread's minor page faults over the window: every
    output's host copy is made on that thread, so 0 here is 0 in egress)."""
    pushes = len(window)
    outputs = sum(len(p.meta) for p in window)
    out = {}
    if ROOT in s.self_s:
        out["server.control_ms"] = s.self_s[ROOT] / pushes * 1e3
    if "engine.ingest" in s.total_s:
        out["ingest.host_ms"] = s.total_s["engine.ingest"] / pushes * 1e3
    if s.count.get("engine.flow"):
        out["engine.flow_host_ms"] = s.self_s["engine.flow"] / s.count["engine.flow"] * 1e3
    warp = [s.self_s[n] for n in ("engine.warp", "engine.copy") if n in s.self_s]
    if warp and outputs:
        out["engine.warp_host_ms"] = sum(warp) / outputs * 1e3
    if "server.egress" in s.total_s:
        out["egress.host_ms"] = s.total_s["server.egress"] / pushes * 1e3
    if s.faults is not None:
        out["egress.faults_per_frame"] = s.faults / pushes
    waits = [v for name, v in s.total_s.items() if name.startswith("sync.")]
    if waits:
        out["device.host_wait_ms"] = sum(waits) / pushes * 1e3
    syncs = sum(c.get(HOST_SYNC, 0) for c in s.counters.values())
    if syncs:
        out["device.host_syncs_per_frame"] = syncs / pushes
    return out


def serve_traced(name: str, config: dict, traffic: dict, *, seed: int, seconds: float,
                 device, t_start: float):
    """Serve cell `name`'s warm-up and a traced window of `seconds` as the
    benchmark's traced run does, with the program's tracer on inside the
    profiler's window; no outputs are kept and nothing is checked. Returns
    (the Run, its Spans or None)."""
    device = torch.device(device)
    pool = inputs.make_pool(config, traffic, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    server = harness.make_server(config, traffic, device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    got = Window()
    warmup, window, window_s = harness.load_driver(traffic["driver"]).serve(
        server, pool, traffic, seconds=seconds, radius=config["search_radius"],
        keep=lambda *_: False, span=torch.profiler.record_function,
        window_ctx=lambda: traced_window(prof, got))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run = Run(cell=name, config=config, traffic=traffic, warmup=warmup, window=window,
              window_s=window_s, setup_s=window[0].t0 - t_start, peak_bytes=peak,
              radius=config["search_radius"], device=device, trace=trace_mod.reduce(prof))
    return run, read(prof, got, window)


BESIDE = ("out_fps", "device.idle_share", "device.events_per_frame", "kernel.ms_per_frame")


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(prog="python3 -m hrbench.spans",
                                 description="The program's spans in a traced window of a cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, config, traffic = harness.cell_parts(harness.load_benchmark(), args.workload)
    run, got = serve_traced(args.workload, config, traffic, seed=args.seed,
                            seconds=args.seconds, device=args.device, t_start=t_start)
    line = {"workload": args.workload, "seed": args.seed, "pushes": len(run.window)}
    for m in BESIDE:
        line[m] = harness.load_reader(m)(run)
    if got is not None:
        line.update(readings(got, run.window))
        line["push_cover"] = got.push_cover
        if got.clock is not None:
            line["clock_spread_us"] = got.clock.spread_us
            line["idle_in_push_s"] = got.idle_in_push_s
            line["idle_named_s"] = got.idle_named_s
            line["idle_by_span"] = got.idle_by_span
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
