"""hrbench/spans.py: the readings by hand, the clock fit and the idle
attribution on synthetic intervals, and a traced window on the CPU that
reads the program's spans."""

import collections
import json
import time

import pytest

from hrbench import harness, spans
from hrbench.record import Push

R = collections.namedtuple("R", "request span parent name thread t0_ns t1_ns counters")


def test_readings_by_hand():
    """One mode-2 push of three outputs (ms): the push 0-10; ingest 0.1-3.1;
    the flow 3.2-4.0 around its timer wait 3.7-3.9; the scene gate 4.0-4.1;
    the warp 4.2-4.4 around its wait 4.3-4.35; three egresses of 1.5 ms
    from 4.5, two syncs each. Self time is a span less its children: the
    push's 10 ms less ingest 3, flow 0.8, scene gate 0.1, warp 0.2 and
    egress 4.5 leaves 1.4 of control; the flow's 0.8 less its 0.2 wait 0.6;
    the warp's 0.2 less its 0.05 wait, over 3 outputs, 0.05. Syncs: 3 + 2 T
    for T = 3. The window's 300 page faults over its one push."""
    ms = 1_000_000
    spec = [(2, 1, "engine.ingest", 0.1, 3.1, {}),
            (4, 3, "sync.flow_timer", 3.7, 3.9, {"host_sync": 1}),
            (3, 1, "engine.flow", 3.2, 4.0, {}),
            (5, 1, "sync.scene_delta", 4.0, 4.1, {"host_sync": 1}),
            (7, 6, "sync.warp_timer", 4.3, 4.35, {"host_sync": 1}),
            (6, 1, "engine.warp", 4.2, 4.4, {})]
    spec += [(8 + i, 1, "server.egress", 4.5 + 1.5 * i, 6.0 + 1.5 * i, {"host_sync": 2})
             for i in range(3)]
    spec.append((1, 0, "server.push_frame", 0.0, 10.0, {}))
    s = spans.reduce([R(1, sid, parent, name, 7, round(t0 * ms), round(t1 * ms), c)
                      for sid, parent, name, t0, t1, c in spec])
    s.faults = 300
    window = [Push(k=13, t0=1.0, t1=1.01, meta=[(0, 1, 0.2, True, False)] * 3,
                   flow_s=0.001, warp_s=0.0001)]
    want = {"server.control_ms": 1.4, "ingest.host_ms": 3.0, "engine.flow_host_ms": 0.6,
            "engine.warp_host_ms": 0.05, "egress.host_ms": 4.5, "egress.faults_per_frame": 300,
            "device.host_wait_ms": 0.35, "device.host_syncs_per_frame": 9}
    assert spans.readings(s, window) == pytest.approx(want)
    assert s.requests == [("server.push_frame", 0.01, {"host_sync": 9})]
    assert s.count["server.egress"] == 3
    assert spans.readings(spans.reduce([]), window) == {}


def test_clock_fit_takes_the_median_offset():
    """Push starts on the profiler's clock 1000 us - 1e8 ahead of the
    program's, with up to 3 us of jitter: the offset is the median, its
    spread max - min, and its quartiles' distance the typical error."""
    host_t0 = [100.0 + 0.01 * i for i in range(8)]
    jitter = [0.0, 3.0, 1.0, 2.0, 1.5, 0.5, 1.0, 2.0]
    starts = [t * 1e6 + 1000.0 - 1e8 + j for t, j in zip(host_t0, jitter)]
    fit = spans.clock_fit(starts, host_t0)
    assert fit.offset_us == pytest.approx(1000.0 - 1e8 + 1.25, abs=1e-3)
    assert fit.spread_us == pytest.approx(3.0, abs=1e-3)
    assert fit.iqr_us == pytest.approx(1.375, abs=1e-3)
    assert fit.to_profiler_us(round(host_t0[0] * 1e9)) == pytest.approx(
        host_t0[0] * 1e6 + fit.offset_us, abs=1e-3)


def test_idle_gaps_go_to_the_innermost_program_span():
    """Profiler microseconds, the program's clock 1000 us behind. Pushes (the
    harness's ranges) 0-40 and 50-90; program roots 2-38 (ingest 5-15,
    egress 20-35) and 52-88 (flow 60-70 around its wait 65-69). The device
    idles 1-10 and 12-16 (ingest), 25-36 (egress), 44-46 (between pushes),
    60-66 (the flow's own time), 67-95 (the second root, 67-88 of it)."""
    offset = 1000.0

    def rec(sid, parent, req, name, t0, t1):
        return R(req, sid, parent, name, 1, round((t0 - offset) * 1e3),
                 round((t1 - offset) * 1e3), {})

    records = [rec(2, 1, 1, "engine.ingest", 5, 15), rec(3, 1, 1, "server.egress", 20, 35),
               rec(1, 0, 1, "server.push_frame", 2, 38), rec(6, 5, 4, "sync.flow_timer", 65, 69),
               rec(5, 4, 4, "engine.flow", 60, 70), rec(4, 0, 4, "server.push_frame", 52, 88)]
    busy = [[0, 1], [10, 12], [16, 25], [36, 44], [46, 60], [66, 67], [95, 100]]
    by_span, in_push, named = spans.attribute_idle(busy, 0, 100, [(0, 40), (50, 90)],
                                                   records, lambda ns: ns / 1e3 + offset)
    want = {"engine.ingest": 13, "server.egress": 11, spans.OUTSIDE: 2, "engine.flow": 6,
            "server.push_frame": 28}
    assert by_span == pytest.approx({k: v * 1e-6 for k, v in want.items()})
    assert in_push == pytest.approx((9 + 4 + 11 + 6 + 23) * 1e-6)
    assert named == pytest.approx((8 + 4 + 11 + 6 + 21) * 1e-6)


@pytest.mark.parametrize("cell, per_output", [("4k-hdr-p010.serve60", 2),
                                              ("4k-sdr-nv12.hsv60", 3)])
def test_traced_cpu_window_reads_the_programs_spans(cell, per_output):
    """A traced window at a tiny size: the program's spans cover the pushes,
    one request a push, and the window's host syncs are 3 + 2 T a push in
    mode 2 and 2 + 3 T in mode 3; the tracer is off again afterwards."""
    _, config, traffic = harness.cell_parts(harness.load_benchmark(), cell)
    config = dict(config, width=224, height=128, max_calc_res=32)
    run, got = spans.serve_traced(cell, config, traffic, seed=2**31 + 9, seconds=0.3,
                                  device="cpu", t_start=time.perf_counter())
    assert got is not None and 0.9 < got.push_cover <= 1.0
    assert len(got.requests) == len(run.window)
    t = sum(len(p.meta) for p in run.window) / len(run.window)
    read = spans.readings(got, run.window)
    assert read["device.host_syncs_per_frame"] == pytest.approx(
        (3 if per_output == 2 else 2) + per_output * t)
    for name in ("server.control_ms", "ingest.host_ms", "engine.flow_host_ms",
                 "engine.warp_host_ms", "egress.host_ms", "device.host_wait_ms"):
        assert read[name] > 0, name
    assert read["egress.faults_per_frame"] >= 0
    assert not spans.program_tracer().drain()


def test_main_prints_the_readings(capsys, monkeypatch):
    """The entry point on the CPU: one JSON line of the readings beside the
    benchmark's out_fps."""
    cell = "4k-hdr-p010.serve60"
    _, config, _ = harness.cell_parts(harness.load_benchmark(), cell)
    small = dict(config, width=224, height=128, max_calc_res=32)
    real = harness.cell_parts
    monkeypatch.setattr(harness, "cell_parts",
                        lambda bench, name: (None, small, real(bench, name)[2]))
    assert spans.main(["--workload", cell, "--seed", "5", "--seconds", "0.2",
                       "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["workload"] == cell and line["pushes"] > 0 and line["out_fps"] > 0
    assert line["device.host_syncs_per_frame"] > 0 and line["device.idle_share"] is None
