"""The port's threaded serving path on the CPU against the JAX package's: the
native frame rings (C++ and NumPy fallback), the library's search order and
build, PipelinedServer streams frame for frame equal to JAX's (at rs 0 and
rs 1), renegotiation, failures on the engine thread, the wedge heartbeat, the
HTTP status endpoint, and the auto quality scaler and TooSlow wired through
the port's FrameServer."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from hopperrender_tpu.config import Settings as JaxSettings
from hopperrender_tpu.server.frame_server import FrameServer as JaxFrameServer
from hopperrender_tpu.server.pipeline import PipelinedServer as JaxPipelinedServer
from hopperrender_tpu.server.status_http import StatusServer as JaxStatusServer
from hopperrender_tpu_torch import config, native
from hopperrender_tpu_torch.config import ActiveState, Settings
from hopperrender_tpu_torch.ops import blur_kernel
from hopperrender_tpu_torch.server.frame_server import FrameServer
from hopperrender_tpu_torch.server.pipeline import PipelinedServer
from hopperrender_tpu_torch.server.status_http import StatusServer
from hopperrender_tpu_torch.vio import nv12

from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def make_server(h=32, w=48, **kw):
    settings = kw.pop("settings", Settings(target_fps=60.0, use_display_fps=False))
    return FrameServer(w, h, source_fps=24.0, device="cpu", settings=settings, **kw)


@pytest.fixture(params=["native", "numpy"])
def ring_path(request, monkeypatch):
    """Each ring test runs on the C++ ring and on the NumPy fallback."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "_lib", False)
    assert native.is_native() is (request.param == "native")
    return request.param


def test_ring_fifo_and_meta(ring_path):
    ring = native.FrameRing(4, 256)
    for i in range(4):
        assert ring.push(bytes([i]) * (i + 1), meta=(i, i * 10, 0, 0))
    assert not ring.push(b"x", timeout=0)  # full, non-blocking
    assert len(ring) == 4
    for i in range(4):
        data, meta = ring.pop()
        assert data == bytes([i]) * (i + 1)
        assert meta[:2] == (i, i * 10)
    assert ring.pop(timeout=0.05) is None  # empty times out
    ring.close()
    assert ring.is_closed() and ring.pop() is None  # closed + drained
    with pytest.raises(RuntimeError, match="ring closed"):
        ring.push(b"y")


def test_ring_oversize_rejected(ring_path):
    ring = native.FrameRing(2, 16)
    if ring_path == "native":
        with pytest.raises(ValueError):
            ring.push(b"z" * 17)
    assert ring.push(b"z" * 16)


def test_ring_blocking_backpressure(ring_path):
    ring = native.FrameRing(2, 64)
    ring.push(b"a")
    ring.push(b"b")
    popped = []

    def consumer():
        for _ in range(3):
            popped.append(ring.pop(timeout=5)[0])

    t = threading.Thread(target=consumer)
    t.start()
    assert ring.push(b"c", timeout=5)  # unblocks once the consumer pops
    t.join(timeout=5)
    assert not t.is_alive()
    assert popped == [b"a", b"b", b"c"]


def test_native_so_search_order_and_build(tmp_path, monkeypatch):
    """The package directory's copy, then the build directory's (named after
    a hash of the sources and the host's CPU), then None; a build makes the
    build directory's, through a temporary name that it does not leave."""
    pkg_so = tmp_path / "pkg" / "libhrt_native.so"
    build_dir = tmp_path / "build"
    pkg_so.parent.mkdir()
    monkeypatch.setattr(native, "_PKG_DIR", str(pkg_so.parent))
    monkeypatch.setattr(native, "BUILD_DIR", build_dir)
    built = native._built_so()
    assert os.path.dirname(built) == str(build_dir)
    assert os.path.basename(built).startswith("libhrt_native_")
    assert native._find_so() is None
    assert native._build()
    assert sorted(os.listdir(build_dir)) == [os.path.basename(built)]
    assert native._find_so() == built
    pkg_so.write_bytes(b"")
    assert native._find_so() == str(pkg_so)
    monkeypatch.setenv("HRT_NATIVE_LIB", str(pkg_so.parent / "elsewhere.so"))
    assert native._find_so() == str(pkg_so)   # no environment override


def _settings(**kw):
    st = dict(target_fps=60.0, use_display_fps=False, auto_quality=False)
    st.update(kw)
    return Settings(**st), JaxSettings(**st)


def _pipe_outputs(pipe, frames):
    for y, uv in frames:
        pipe.feed(y, uv)
    pipe.close()
    outs = list(pipe.outputs(timeout=120))
    pipe.join()
    assert len(outs) == pipe.stats.frames_out
    assert pipe.stats.frames_in == len(frames)
    return outs


def _require_same_outputs(got, want):
    assert len(got) == len(want)
    for g, j in zip(got, want):
        assert (g.start_time, g.end_time, g.interpolated, g.scene_change) == \
            (j.start_time, j.end_time, j.interpolated, j.scene_change)
        np.testing.assert_array_equal(g.y, np.asarray(j.y))
        np.testing.assert_array_equal(g.uv, np.asarray(j.uv))


# (h, w, max_calc_res, frames): rs 0, and rs 1 (the geometry of the JAX
# package's pipelined strip-path test, where JAX runs its strip kernels in
# interpret mode, 5-13 s a frame; the 4th frame is the first whose warps
# use a computed flow).
@pytest.mark.parametrize("h, w, mcr, n", [(32, 48, config.MAX_CALC_RES, 6), (72, 96, 36, 4)])
def test_pipelined_stream_matches_jax(h, w, mcr, n):
    st, jst = _settings(max_calc_res=mcr)
    rng = np.random.default_rng(3)
    frames = [nv12.synthetic_frame(rng, h, w, motion_x=2 * i) for i in range(n)]
    srv = FrameServer(w, h, source_fps=24.0, device="cpu", settings=st)
    got = _pipe_outputs(PipelinedServer(srv, input_slots=4, output_slots=8), frames)
    jsrv = JaxFrameServer(w, h, source_fps=24.0, settings=jst)
    want = _pipe_outputs(JaxPipelinedServer(jsrv, input_slots=4, output_slots=8), frames)
    _require_same_outputs(got, want)
    assert any(o.interpolated for o in got)
    assert [o.start_time for o in got] == sorted(o.start_time for o in got)
    assert srv.engine.res_scalar == (1 if mcr == 36 else 0)
    assert got[0].y.shape == (h, w)


def test_pipelined_server_error_propagates():
    pipe = PipelinedServer(make_server(), input_slots=2, output_slots=2)
    # A frame of the wrong size: the engine thread fails and says so.
    bad = np.zeros(nv12.frame_size_samples(32, 48) // 2, np.uint8)
    pipe._in_ring.push(bad)
    pipe.close()
    with pytest.raises(RuntimeError, match="engine thread failed"):
        list(pipe.outputs(timeout=10))
    pipe.join()


def test_kernel_failure_on_the_engine_thread_is_raised(monkeypatch):
    """A kernel that fails to build or launch on the engine thread (here the
    flow blur's wrapper raising as a failed nvcc would) ends the stream with
    RuntimeError("engine thread failed"), not a silent end of stream; the
    outputs made before it come first."""
    def failing_blur(x):
        raise RuntimeError("nvcc failed with code 1")

    monkeypatch.setattr(blur_kernel, "blur_flow", failing_blur)
    pipe = PipelinedServer(make_server(), input_slots=2, output_slots=8)
    rng = np.random.default_rng(4)
    outs = []
    with pytest.raises(RuntimeError, match="engine thread failed") as exc:
        for i in range(4):
            pipe.feed(*nv12.synthetic_frame(rng, 32, 48, motion_x=i))
        pipe.close()
        for out in pipe.outputs(timeout=30):
            outs.append(out)
    assert "nvcc failed" in str(exc.value.__cause__)
    assert outs and not any(o.interpolated for o in outs)   # the warmup copies
    pipe.join()
    assert not pipe.healthy()


def test_pipeline_mid_stream_resolution_grow():
    pipe = PipelinedServer(make_server(), input_slots=4, output_slots=8)
    rng = np.random.default_rng(5)
    frames = [nv12.synthetic_frame(rng, 32, 48, motion_x=i) for i in range(4)]
    frames += [nv12.synthetic_frame(rng, 64, 96, motion_x=i) for i in range(4)]
    outs = _pipe_outputs(pipe, frames)
    assert pipe.stats.renegotiations >= 1
    assert [o.y.shape for o in outs if o.y.shape == (32, 48)]
    assert [o.y.shape for o in outs if o.y.shape == (64, 96)]


def test_pipeline_worker_death_unblocks_producer():
    srv = make_server()
    pipe = PipelinedServer(srv, input_slots=2, output_slots=4)

    def boom(*a, **k):
        raise RuntimeError("engine exploded")

    srv.push_frame = boom
    y, uv = nv12.synthetic_frame(np.random.default_rng(6), 32, 48)
    with pytest.raises(RuntimeError):
        # The worker dies on the first frame; later feeds must not hang on a
        # full input ring.
        for _ in range(8):
            pipe.feed(y, uv)
    with pytest.raises(RuntimeError, match="engine thread failed"):
        list(pipe.outputs(timeout=10))
    pipe.join()


def _get(status, path):
    try:
        with urllib.request.urlopen(f"http://{status.host}:{status.port}{path}") as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(status, path, payload):
    req = urllib.request.Request(
        f"http://{status.host}:{status.port}{path}",
        data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_pipelined_server_wedged_device_detection():
    """A device call that hangs flips healthy() through the engine-call
    heartbeat, and /healthz answers 503 past the stall limit."""
    srv = make_server()
    pipe = PipelinedServer(srv, input_slots=2, output_slots=4)
    status = StatusServer(srv, pipeline=pipe)
    gate = threading.Event()
    try:
        assert pipe.healthy() and pipe.stall_seconds() == 0.0
        assert _get(status, "/healthz") == (200, {"status": "ok"})
        orig = srv.push_frame
        srv.push_frame = lambda *a, **kw: (gate.wait(), orig(*a, **kw))[1]
        pipe.feed(*nv12.synthetic_frame(np.random.default_rng(7), 32, 48))
        for _ in range(200):          # wait for the worker to enter the call
            if pipe.stall_seconds() > 0.05:
                break
            time.sleep(0.01)
        assert pipe.stall_seconds() > 0.05
        assert not pipe.healthy(stall_limit=0.01)
        assert pipe.healthy(stall_limit=60.0)
        pipe._busy_since -= 60.0      # as if wedged for a minute
        code, body = _get(status, "/healthz")
        assert code == 503 and body["status"] == "wedged" and body["stall_seconds"] >= 60
        gate.set()
        pipe.close()
        outs = list(pipe.outputs(timeout=30))   # drains after release
        assert outs and not any(o.interpolated for o in outs)
        pipe.join()
        assert pipe.healthy()
    finally:
        gate.set()
        status.close()


@pytest.fixture
def served_pair():
    """A port and a JAX FrameServer after the same four frames, each with
    its status endpoint."""
    st, jst = _settings()
    srv = FrameServer(48, 32, source_fps=24.0, device="cpu", settings=st)
    jsrv = JaxFrameServer(48, 32, source_fps=24.0, settings=jst)
    rng = np.random.default_rng(8)
    for i in range(4):
        y, uv = nv12.synthetic_frame(rng, 32, 48, motion_x=i)
        srv.push_frame(y, uv)
        jsrv.push_frame(y, uv)
    status, jstatus = StatusServer(srv), JaxStatusServer(jsrv)
    yield srv, status, jstatus
    status.close()
    jstatus.close()


def test_metrics_endpoint_differs_from_jax_by_warp_apron_only(served_pair):
    _, status, jstatus = served_pair
    code, m = _get(status, "/metrics")
    jcode, jm = _get(jstatus, "/metrics")
    assert code == jcode == 200
    assert set(m) == set(jm) - {"warp_apron"}
    assert "warp_apron" in jm
    timing = {"ofc_calc_time", "avg_ofc_calc_time", "peak_ofc_calc_time", "warp_calc_time",
              "batched_warp"}
    assert {k: v for k, v in m.items() if k not in timing} == \
        {k: v for k, v in jm.items() if k in m and k not in timing}
    assert m["dim_x"] == 48 and m["active_state"] == 2 and m["ofc_calc_time"] > 0


def test_settings_get_and_live_post(served_pair):
    srv, status, jstatus = served_pair
    assert _get(status, "/settings") == _get(jstatus, "/settings")
    code, s = _post(status, "/settings", {"target_fps": 120.0, "delta_scalar": 4})
    assert code == 200 and s["target_fps"] == 120.0
    assert srv.engine.delta_scalar == 4  # applied live to the engine
    assert s == _post(jstatus, "/settings", {"target_fps": 120.0, "delta_scalar": 4})[1]
    code, err = _post(status, "/settings", {"bogus": 1})
    assert code == 400 and "bogus" in err["error"]
    assert _post(status, "/settings", {"delta_scalar": 99})[0] == 400
    assert _get(status, "/healthz") == (200, {"status": "ok"})
    assert _get(status, "/nope")[0] == 404
    assert _post(status, "/nope", {})[0] == 404


class _Script:
    """Stands in for the engines' measured flow and warp times: each
    engine's CalcTimeWindow.record records `flow` or `warp` instead of what
    it measured."""

    def __init__(self):
        self.flow = self.warp = 0.0

    def install(self, eng):
        ofc, warp = eng.ofc_time.record, eng.warp_time.record
        eng.ofc_time.record = lambda seconds: ofc(self.flow)
        eng.warp_time.record = lambda seconds: warp(self.warp)


def test_scaler_and_too_slow_on_the_served_path_match_jax():
    """auto_quality on, 32x48, the port's and the JAX FrameServer fed the
    same frames and the same scripted flow and warp times: cheap frames
    (the radius climbs), over budget until radius 5 and ten more frames
    (TooSlow trips: copies only), then 30 frames under budget (it recovers
    and climbs again). Per source frame the radius, state, outputs and
    interpolated flags agree."""
    st, jst = _settings(auto_quality=True)
    srv = FrameServer(48, 32, source_fps=24.0, device="cpu", settings=st)
    jsrv = JaxFrameServer(48, 32, source_fps=24.0, settings=jst)
    script = _Script()
    for server in (srv, jsrv):   # built ahead of the first frame to script all its times
        server.engine = server._build_engine()
        script.install(server.engine)
    over, under, climb = 0.05, 0.01, 0.001   # the budget line is 29.76 ms
    rng = np.random.default_rng(9)
    trace, phase, at_floor = [], "climb", 0
    for i in range(55):
        y, uv = nv12.synthetic_frame(rng, 32, 48, motion_x=i % 7)
        got = srv.push_frame(y, uv)
        want = jsrv.push_frame(y, uv)
        _require_same_outputs(got, want)
        radius, state = srv.engine.search_radius, srv.cadence.state
        assert (radius, state) == (jsrv.engine.search_radius, jsrv.cadence.state)
        if state == ActiveState.TOO_SLOW:
            assert got and not any(o.interpolated for o in got)
        trace.append((radius, int(state)))
        # The next frame's times: climb to radius 8, fall to the floor and
        # stay over budget there, then recover.
        if phase == "climb" and radius >= 8:
            phase = "over"
        elif phase == "over" and radius == config.MIN_SEARCH_RADIUS:
            at_floor += 1
            if at_floor > config.TOO_SLOW_TRIP_FRAMES:
                phase = "under"
        script.flow = {"climb": climb, "over": over, "under": under}[phase]
        script.warp = 0.0001
    radii = [r for r, _ in trace]
    states = [s for _, s in trace]
    tripped = states.index(int(ActiveState.TOO_SLOW))
    recovered = tripped + states[tripped:].index(int(ActiveState.ACTIVE))
    assert max(radii[:tripped]) >= 8 and radii[tripped] == config.MIN_SEARCH_RADIUS
    # A frame's adjust reads the flow time recorded in the frame before, so
    # the trip comes on the 10th frame after the radius reached the floor, and
    # the first under-budget time is read two frames after the trip.
    assert tripped == radii.index(config.MIN_SEARCH_RADIUS) + config.TOO_SLOW_TRIP_FRAMES
    assert recovered - tripped == config.TOO_SLOW_RECOVER_FRAMES + 1
    assert radii[-1] > config.MIN_SEARCH_RADIUS   # climbing again after recovery
