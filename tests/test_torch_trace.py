"""The port's tracer (hopperrender_tpu_torch/utils/trace.py) on the CPU:
nesting, request ids and per-thread stacks; sums by name without records
(what --stats reads); nothing recorded while it is off; and a FrameServer stream's span tree and host syncs, push by push,
against the count the served path gives (modes 0-2 batched 3 + 2T for T
outputs, modes 3-6 2 + 3T, a push that copies 3T before the flow runs and
2 + 3T after), with the outputs bit for bit those of the stream untraced."""

import threading

import numpy as np
import pytest

from hopperrender_tpu_torch.config import Settings
from hopperrender_tpu_torch.server.frame_server import FrameServer
from hopperrender_tpu_torch.utils import trace
from hopperrender_tpu_torch.vio import nv12

from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

H, W = 48, 64


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.enable(False)
    trace.drain()
    trace.per_frame()
    yield
    trace.enable(False)
    trace.drain()
    trace.per_frame()


def test_spans_nest_and_share_their_roots_request():
    trace.enable(True)
    with trace.span("a"):
        trace.count("n")
        with trace.span("b"):
            trace.count("n", 2)
            with trace.span("c"):
                pass
        with trace.span("b"):
            pass
    with trace.span("a"):
        pass
    trace.count("n")   # no open span: dropped
    recs = trace.drain()
    assert trace.drain() == []
    assert [r.name for r in recs] == ["c", "b", "b", "a", "a"]
    c, b1, b2, a1, a2 = recs
    assert a1.parent == 0 and a1.request == a1.span
    assert b1.parent == b2.parent == a1.span and c.parent == b1.span
    assert {r.request for r in (c, b1, b2)} == {a1.request}
    assert a2.parent == 0 and a2.request == a2.span != a1.request
    assert (a1.counters, b1.counters, b2.counters, c.counters) == ({"n": 1}, {"n": 2}, {}, {})
    assert a1.t0_ns <= b1.t0_ns <= c.t0_ns <= c.t1_ns <= b1.t1_ns <= b2.t0_ns <= b2.t1_ns \
        <= a1.t1_ns <= a2.t0_ns <= a2.t1_ns
    assert trace.per_frame(root="a") == {"stages_ms": {}, "host_syncs_per_frame": 0.0}

    # Without keep, the same spans are only summed by name: no record, and
    # per_frame() gives each name's mean ms over the spans named root.
    trace.enable(True, keep=False)
    for _ in range(2):
        with trace.span("a"):
            with trace.span("b"):
                trace.count(trace.HOST_SYNC, 3)
    assert trace.drain() == []
    stages = trace.per_frame(root="a")
    assert set(stages["stages_ms"]) == {"a", "b"}
    assert 0 < stages["stages_ms"]["b"] <= stages["stages_ms"]["a"]
    assert stages["host_syncs_per_frame"] == 3.0
    assert trace.per_frame(root="a")["stages_ms"] == {}   # read once, then cleared


def test_each_thread_has_its_own_stack():
    """Two threads inside their spans at once: each child hangs under its own
    thread's root, and the roots are two requests."""
    trace.enable(True)
    both_open = threading.Barrier(2, timeout=10)

    def work(name):
        with trace.span(name):
            both_open.wait()
            with trace.span(name + ".child"):
                trace.count(trace.HOST_SYNC)
                both_open.wait()

    threads = [threading.Thread(target=work, args=(n,)) for n in ("x", "y")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    recs = {r.name: r for r in trace.drain()}
    assert len(recs) == 4
    for n in ("x", "y"):
        root, child = recs[n], recs[n + ".child"]
        assert root.parent == 0 and root.request == root.span
        assert child.parent == root.span and child.request == root.request
        assert child.thread == root.thread
        assert child.counters == {trace.HOST_SYNC: 1} and root.counters == {}
    assert recs["x"].thread != recs["y"].thread
    assert recs["x"].request != recs["y"].request


def test_off_records_nothing():
    assert trace.span("a") is trace.span("b")   # one shared no-op
    with trace.span("a"):
        trace.count(trace.HOST_SYNC)
    assert trace.drain() == []


def _stream(mode, threshold, traced, keep=True):
    """Seven pushes of a pan, 24 -> 60; [(outputs, records)] a push."""
    settings = Settings(target_fps=60.0, use_display_fps=False, frame_output=mode,
                        auto_quality=False, scene_change_threshold=threshold)
    server = FrameServer(W, H, source_fps=24.0, device="cpu", settings=settings)
    rng = np.random.default_rng(7)
    trace.enable(traced, keep=keep)
    pushes = []
    for i in range(7):
        y, uv = nv12.synthetic_frame(rng, H, W, motion_x=3 * i)
        pushes.append((server.push_frame(y, uv), trace.drain()))
    trace.enable(False)
    return pushes


def _expected(mode, k, outputs):
    """The span names of push k as they close, and its host syncs."""
    t = len(outputs)
    flow = ["sync.flow_timer", "engine.flow", "sync.scene_delta"] if k >= 3 else []
    if not any(o.interpolated for o in outputs):
        names = flow + ["sync.warp_timer", "engine.copy", "server.egress"] * t
        syncs = 3 * t if k < 3 else 2 + 3 * t
    elif mode == 2:
        names = flow + ["sync.warp_timer", "engine.warp"] + ["server.egress"] * t
        syncs = 3 + 2 * t
    else:
        names = flow + ["sync.warp_timer", "engine.warp", "server.egress"] * t
        syncs = 2 + 3 * t
    return ["engine.ingest"] + names + ["server.push_frame"], syncs


PARENT = {"sync.flow_timer": ("engine.flow",), "sync.warp_timer": ("engine.warp", "engine.copy")}


# (output mode, scene-change threshold): mode 2 batched, mode 3 one warp an
# output, and mode 2 cut at every change past the warm-up, so its pushes copy
# with the flow running as well as before it.
@pytest.mark.parametrize("mode, threshold, kind", [(2, 10000, "interpolated"),
                                                   (3, 10000, "interpolated"),
                                                   (2, 1, "copied")])
def test_push_span_tree_and_host_syncs(mode, threshold, kind):
    plain = _stream(mode, threshold, traced=False)
    traced = _stream(mode, threshold, traced=True)
    assert all(recs == [] for _, recs in plain)
    kinds, total = set(), 0
    for k, ((want, _), (got, recs)) in enumerate(zip(plain, traced), start=1):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.y, w.y)
            np.testing.assert_array_equal(g.uv, w.uv)
            assert (g.start_time, g.end_time, g.interpolated) == \
                (w.start_time, w.end_time, w.interpolated)
        names, syncs = _expected(mode, k, got)
        assert [r.name for r in recs] == names, k
        root = recs[-1]
        by_span = {r.span: r for r in recs}
        assert root.parent == 0 and all(r.request == root.span for r in recs)
        for r in recs[:-1]:
            assert by_span[r.parent].name in PARENT.get(r.name, ("server.push_frame",)), r
            assert root.t0_ns <= r.t0_ns <= r.t1_ns <= root.t1_ns
        assert sum(r.counters.get(trace.HOST_SYNC, 0) for r in recs) == syncs, k
        for r in recs:
            if r.name == "server.egress":
                assert r.counters == {trace.HOST_SYNC: 2}
        total += syncs
        if k >= 3:
            kinds.add("interpolated" if got[0].interpolated else "copied")
    assert kind in kinds
    # The same stream summed without records, as --stats reads it.
    summed = _stream(mode, threshold, traced=True, keep=False)
    assert all(recs == [] for _, recs in summed)
    stats = trace.per_frame()
    assert stats["host_syncs_per_frame"] == total / 7
    assert set(stats["stages_ms"]) == {r.name for _, recs in traced for r in recs}
