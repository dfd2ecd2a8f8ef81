"""The PyTorch port's own control plane (config, server/control, sidedata,
display, vio/nv12, vio/video, native) against the JAX package's modules it was
copied from: the same inputs give the same trajectories, values and bytes."""

import dataclasses

import numpy as np
import pytest

from hopperrender_tpu import config as jax_config
from hopperrender_tpu import native as jax_native
from hopperrender_tpu.server import control as jax_control
from hopperrender_tpu.server import display as jax_display
from hopperrender_tpu.server import sidedata as jax_sidedata
from hopperrender_tpu.vio import nv12 as jax_nv12
from hopperrender_tpu.vio import video as jax_video
from hopperrender_tpu_torch import config, native
from hopperrender_tpu_torch.server import control, display, sidedata
from hopperrender_tpu_torch.vio import nv12, video

BOTH = ((jax_control, jax_config), (control, config))


def _cadence_trace(ctl, cfg, source_fps, target_fps, n_frames):
    """Outputs, timestamps and blending scalars of n_frames source frames,
    with a seek and a rate change half way."""
    c = ctl.CadenceController(source_fps, target_fps)
    trace = []
    for i in range(n_frames):
        if i == n_frames // 2:
            c.new_segment(rate=1.5)
        n = c.begin_source_frame(i * c.source_frame_time)
        for _ in range(n):
            t = c.next_output_timing()
            trace.append((t.start_time, t.end_time, t.blending_scalar))
            c.advance_blending()
        trace.append((n, int(c.state), c.playback_frame_time))
    c.set_target_fps(20.0)
    trace.append(int(c.state) == int(cfg.ActiveState.NOT_NEEDED))
    return trace


@pytest.mark.parametrize("target_fps", [60.0, 120.0])
def test_cadence_matches_jax(target_fps):
    jax_trace, port_trace = (_cadence_trace(ctl, cfg, 24.0, target_fps, 40)
                             for ctl, cfg in BOTH)
    assert port_trace == jax_trace
    assert port_trace[-1]


def _scaler_trace(ctl, cfg):
    """The auto quality scaler climbing, falling to the floor, tripping
    TooSlow and recovering, as (radius, too_slow) per source frame."""
    s = ctl.AutoQualityScaler(enabled=True)
    frame = ctl.fps_to_frame_time(24.0)
    budget = frame / 1e7
    radius = cfg.MIN_SEARCH_RADIUS
    trace = []
    phases = ([0.1 * budget] * 15                 # cheap: climbs to the top
              + [0.9 * budget] * 15                # dear: falls to the floor
              + [0.9 * budget] * (cfg.TOO_SLOW_TRIP_FRAMES + 2)   # trips
              + [0.2 * budget] * (cfg.TOO_SLOW_RECOVER_FRAMES + 2))  # recovers
    for flow_s in phases:
        s.add_warp_duration(0.01 * budget)
        radius = s.adjust(radius, flow_s, frame)
        trace.append((radius, s.too_slow))
    return trace


def test_scaler_and_too_slow_match_jax():
    jax_trace, port_trace = (_scaler_trace(ctl, cfg) for ctl, cfg in BOTH)
    assert port_trace == jax_trace
    radii = [r for r, _ in port_trace]
    assert max(radii) == config.MAX_SEARCH_RADIUS and min(radii) == config.MIN_SEARCH_RADIUS
    flags = [f for _, f in port_trace]
    assert True in flags and flags[-1] is False


def test_scene_gate_matches_jax():
    rng = np.random.default_rng(4)
    deltas = rng.integers(0, 300, 60).tolist()
    deltas[20] = deltas[21] = 5000          # a cut
    traces = []
    for ctl, _ in BOTH:
        det = ctl.SceneChangeDetector()
        trace = []
        for i, d in enumerate(deltas):
            det.add_frame_delta(i, d, ctl.fps_to_frame_time(24.0))
            trace.append((det.evaluate(i, ctl.fps_to_frame_time(24.0), 200),
                          det.peak_delta1, det.peak_delta2))
        traces.append(trace)
    assert traces[1] == traces[0]
    assert any(cut for cut, _, _ in traces[1])


def test_config_matches_jax():
    names = [n for n in dir(jax_config) if n.isupper()]
    assert names
    for n in names:
        assert getattr(config, n) == getattr(jax_config, n), n
    assert [dataclasses.asdict(s) for s in (config.Settings(), jax_config.Settings())] \
        == [dataclasses.asdict(jax_config.Settings())] * 2
    assert list(config.FrameOutput) == [int(m) for m in jax_config.FrameOutput]
    for h, w, mcr in ((2160, 3840, 270), (1080, 1920, 270), (86, 50, 64), (481, 853, 32)):
        assert config.calc_flow_dims(h, w, mcr) == jax_config.calc_flow_dims(h, w, mcr)
        _, low_h, low_w = config.calc_flow_dims(h, w, mcr)
        assert config.initial_window_size(low_h, low_w) == \
            jax_config.initial_window_size(low_h, low_w)
    for bad in (-1, 7):
        with pytest.raises(ValueError, match="frame_output"):
            config.Settings(frame_output=bad).validate()


@pytest.mark.parametrize("is_hdr", [False, True])
def test_nv12_matches_jax(is_hdr):
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    y, uv = nv12.synthetic_frame(a, 34, 50, is_hdr=is_hdr, motion_x=5)
    jy, juv = jax_nv12.synthetic_frame(b, 34, 50, is_hdr=is_hdr, motion_x=5)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(uv, juv)
    for stride in (None, 64):
        buf = nv12.pack(y, uv, stride)
        np.testing.assert_array_equal(buf, jax_nv12.pack(y, uv, stride))
        for got, want in zip(nv12.unpack(buf, 34, 50, stride, is_hdr=is_hdr),
                             jax_nv12.unpack(buf, 34, 50, stride, is_hdr=is_hdr)):
            np.testing.assert_array_equal(got, want)


def test_sidedata_and_display_match_jax():
    blobs = {"cll": b"\x01\x02", "mdm": bytes(range(24))}
    assert sidedata.passthrough(blobs) == jax_sidedata.passthrough(blobs)
    assert sidedata.passthrough(None) == jax_sidedata.passthrough(None)
    cll = sidedata.ContentLightLevel(1000, 400)
    assert cll.to_bytes() == jax_sidedata.ContentLightLevel(1000, 400).to_bytes()
    mdm = sidedata.MasteringDisplayMetadata((0.68, 0.265, 0.15), (0.32, 0.69, 0.06),
                                            (0.3127, 0.329), 1000.0, 0.005)
    assert sidedata.MasteringDisplayMetadata.from_bytes(mdm.to_bytes()) == mdm
    assert mdm.to_bytes() == jax_sidedata.MasteringDisplayMetadata(
        *dataclasses.astuple(mdm)).to_bytes()
    polls = []
    for mod in (jax_display, display):
        seq = iter([59.94, 120.0, 144.0])
        poller = mod.DisplayRatePoller(interval=5.0, probe=lambda: next(seq))
        polls.append([poller.poll(now=t) for t in (1.0, 2.0, 7.0, 8.0)]
                     + [poller.poll(now=9.0, force=True)])
    assert polls[1] == polls[0] == [59.94, None, 120.0, None, 144.0]


@pytest.mark.parametrize("is_hdr", [False, True])
def test_video_matches_jax(tmp_path, is_hdr):
    """vio/video.py: the port's raw and Y4M writers write JAX's bytes (a
    strided raw stream too), its readers read them into JAX's planes and
    attributes, open_reader/open_writer pick the same classes, and the
    ffmpeg reader is gated alike."""
    rng = np.random.default_rng(11)
    frames = [nv12.synthetic_frame(rng, 16, 32, is_hdr=is_hdr, motion_x=i) for i in range(3)]
    ext = ".p010" if is_hdr else ".nv12"
    for mod, tag in ((jax_video, "jax"), (video, "port")):
        for name in ("s" + ext, "s.y4m"):
            w = mod.open_writer(str(tmp_path / f"{tag}_{name}"), 32, 16, 24.0, is_hdr=is_hdr)
            for y, uv in frames:
                w.write(y, uv)
            w.close()
        strided = mod.RawWriter(str(tmp_path / f"{tag}_strided{ext}"), stride=40)
        strided.write(*frames[0])
        strided.close()
    for name in ("s" + ext, "s.y4m", "strided" + ext):
        assert (tmp_path / f"port_{name}").read_bytes() == (tmp_path / f"jax_{name}").read_bytes()
        if name.startswith("strided"):
            continue
        path = str(tmp_path / f"jax_{name}")
        got = video.open_reader(path, width=32, height=16, is_hdr=is_hdr)
        want = jax_video.open_reader(path, width=32, height=16, is_hdr=is_hdr)
        assert type(got).__name__ == type(want).__name__
        assert (got.width, got.height, got.fps, got.is_hdr) == \
            (want.width, want.height, want.fps, want.is_hdr)
        got_frames, want_frames = list(got), list(want)
        assert len(got_frames) == len(want_frames) == 3
        for (gy, guv), (wy, wuv) in zip(got_frames, want_frames):
            np.testing.assert_array_equal(gy, wy)
            np.testing.assert_array_equal(guv, wuv)
    assert type(video.open_writer("-", 32, 16, 24.0)).__name__ == "Y4MWriter"
    if not video.have_ffmpeg():
        for mod in (video, jax_video):
            with pytest.raises(RuntimeError, match="ffmpeg not found"):
                mod.FfmpegReader("x.mp4")


@pytest.mark.parametrize("is_hdr", [False, True])
@pytest.mark.parametrize("path", ["native", "numpy"])
def test_native_pack_unpack_match_jax(monkeypatch, path, is_hdr):
    """native.py: pack and unpack give the JAX module's bytes, through the
    port's C++ library and through its NumPy fallback."""
    if path == "numpy":
        monkeypatch.setattr(native, "_lib", False)
        monkeypatch.setattr(jax_native, "_lib", False)
    assert native.is_native() is (path == "native")
    h, w, stride = 32, 40, 48
    dtype = np.uint16 if is_hdr else np.uint8
    buf = np.random.default_rng(5).integers(0, 65536 if is_hdr else 256,
                                            nv12.frame_size_samples(h, stride), dtype=dtype)
    y, uv = native.unpack(buf, h, w, stride, is_hdr=is_hdr)
    jy, juv = jax_native.unpack(buf, h, w, stride, is_hdr=is_hdr)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(uv, juv)
    y2, uv2 = native.unpack(buf.tobytes(), h, w, stride, is_hdr=is_hdr)
    np.testing.assert_array_equal(y2, jy)
    for s in (None, stride):
        got, want = native.pack(y, uv, s), jax_native.pack(jy, juv, s)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="too small"):
        native.unpack(buf[:100], h, w, stride, is_hdr=is_hdr)
