"""The PyTorch port's FrameServer on the CPU: the four pinned-digest streams
of tests/fixtures/digests.json, and 24->60 streams of every output mode 2-6
against the JAX FrameServer (outputs, timestamps, interpolated flags)."""

import json
import os

import numpy as np
import pytest
import torch

from hopperrender_tpu.config import Settings
from hopperrender_tpu.server.frame_server import FrameServer as JaxFrameServer
from hopperrender_tpu.vio import nv12
from hopperrender_tpu_torch.server import digests
from hopperrender_tpu_torch.server.frame_server import FrameServer

from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "digests.json")

# The streams of tests/test_regression_digests.py:
# name: (h, w, max_calc_res, is_hdr, mode, radius, frames)
CONFIGS = {
    "sdr_rs1_mode0": (80, 96, 40, False, 0, 7, 6),
    "sdr_rs2_mode1": (128, 160, 32, False, 1, 16, 6),
    "hdr_rs1_mode0": (80, 96, 40, True, 0, 9, 6),
    "sdr_rs0_mode0": (56, 72, 64, False, 0, 5, 6),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pinned_digest(name):
    """tests/test_regression_digests.py::_stream with the port's FrameServer
    on the CPU (hopperrender_tpu_torch/server/digests.py, which the card
    replays too)."""
    with open(FIXTURE) as f:
        pinned = json.load(f)
    assert digests.stream_digest(name, "cpu") == pinned[name]


@pytest.mark.parametrize("batched", [None, False])
def test_mode2_stream_matches_jax_server(batched):
    """24->60 mode 2 with levels 16/235 (blending scalars 0.4/0.8/0.2/0.6):
    the port (one batched warp per interval, or one per output) against the
    JAX FrameServer."""
    h, w = 48, 64
    settings = dict(target_fps=60.0, use_display_fps=False, frame_output=2,
                    auto_quality=False, black_level=16, white_level=235)
    jsrv = JaxFrameServer(w, h, source_fps=24.0, settings=Settings(**settings))
    tsrv = FrameServer(w, h, source_fps=24.0, device="cpu",
                       settings=Settings(batched_warp=batched, **settings))
    rng = np.random.default_rng(7)
    n_interp = 0
    for i in range(7):
        y, uv = nv12.synthetic_frame(rng, h, w, motion_x=3 * i)
        want = jsrv.push_frame(y, uv, side_data={"cll": b"\x01\x02"})
        got = tsrv.push_frame(y, uv, side_data={"cll": b"\x01\x02"})
        assert len(got) == len(want)
        for g, j in zip(got, want):
            assert (g.start_time, g.end_time, g.interpolated, g.scene_change) == \
                (j.start_time, j.end_time, j.interpolated, j.scene_change)
            assert g.blending_scalar == j.blending_scalar and g.side_data == j.side_data
            np.testing.assert_array_equal(g.y, np.asarray(j.y))
            np.testing.assert_array_equal(g.uv, np.asarray(j.uv))
            n_interp += g.interpolated
    assert n_interp > 0
    assert tsrv.metrics().batched_warp is (batched is None)
    assert tsrv.metrics().low_dim_x == jsrv.metrics().low_dim_x


@pytest.mark.parametrize("mode", [3, 4, 5, 6])
def test_viz_mode_stream_matches_jax_server(mode):
    """24->60 in a visualisation mode, one warp per output (as the JAX server
    dispatches modes 3-6), against the JAX FrameServer. 50x86 gives an odd
    half width (43) for mode 6; mode 3 runs HDR."""
    is_hdr = mode == 3
    h, w = 50, 86
    settings = dict(target_fps=60.0, use_display_fps=False, frame_output=mode,
                    auto_quality=False, black_level=16, white_level=235)
    jsrv = JaxFrameServer(w, h, source_fps=24.0, is_hdr=is_hdr, settings=Settings(**settings))
    tsrv = FrameServer(w, h, source_fps=24.0, is_hdr=is_hdr, device="cpu",
                       settings=Settings(**settings))
    rng = np.random.default_rng(70 + mode)
    n_interp = 0
    for i in range(6):
        y, uv = nv12.synthetic_frame(rng, h, w, is_hdr=is_hdr, motion_x=4 * i)
        want = jsrv.push_frame(y, uv)
        got = tsrv.push_frame(y, uv)
        assert len(got) == len(want)
        for g, j in zip(got, want):
            assert (g.start_time, g.end_time, g.interpolated, g.scene_change) == \
                (j.start_time, j.end_time, j.interpolated, j.scene_change)
            np.testing.assert_array_equal(g.y, np.asarray(j.y))
            np.testing.assert_array_equal(g.uv, np.asarray(j.uv))
            n_interp += g.interpolated
    assert n_interp > 0
    assert tsrv.metrics().low_dim_y == jsrv.metrics().low_dim_y == 50


def test_server_refuses_unported_modes():
    """Only the output modes 0-6 exist: 7 and -1 are refused at construction
    and in a live settings update."""
    for mode in (7, -1):
        with pytest.raises(ValueError, match="frame_output"):
            FrameServer(64, 48, device="cpu", settings=Settings(frame_output=mode))
    srv = FrameServer(64, 48, device="cpu", settings=Settings(use_display_fps=False))
    for mode in (7, -1):
        with pytest.raises(ValueError, match="frame_output"):
            srv.update_settings(frame_output=mode)
    srv.update_settings(frame_output=6)
    assert srv.metrics().frame_output == 6


def test_shared_digest_streams_are_these_streams():
    """hopperrender_tpu_torch/server/digests.py, which test_pinned_digest, the
    card's tests and chip_smoke.py replay, defines the streams of CONFIGS."""
    assert digests.STREAMS == CONFIGS


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16])
def test_egress_on_the_cpu_hands_back_the_planes_own_array(dtype):
    """Served on the CPU, the egress returns the engine's plane itself (no
    copy, no pinned block) and counts one host sync and nothing else."""
    from hopperrender_tpu_torch.server import frame_server
    from hopperrender_tpu_torch.utils import trace

    t = torch.arange(24, dtype=torch.int32).reshape(4, 6).to(dtype)
    trace.enable(True)
    try:
        trace.drain()
        assert trace.is_on()
        with trace.span("server.egress"):
            a = frame_server._host(t)
        (rec,) = trace.drain()
    finally:
        trace.enable(False)
        trace.drain()
    assert not trace.is_on()
    assert a.ctypes.data == t.data_ptr() and a.shape == (4, 6)
    np.testing.assert_array_equal(a, np.arange(24).reshape(4, 6))
    assert rec.counters == {trace.HOST_SYNC: 1}
