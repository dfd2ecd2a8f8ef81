"""The PyTorch port's engine on the CPU: all five golden fixtures (modes 0-4)
replay byte for byte, and a stream handed over from the JAX engine
(load_state) continues with equal flow, scene delta and warped outputs."""

import os

import numpy as np
import pytest
import torch

from hopperrender_tpu.engine.flow_engine import OpticalFlowEngine as JaxEngine
from hopperrender_tpu.vio import nv12
from hopperrender_tpu_torch.engine.flow_engine import OpticalFlowEngine

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")
# Every fixture: 1080p-sdr holds modes 2 and 3, live mode 4, the rest mode 2.
PORTED_FIXTURES = ("480p-sdr", "4k-sdr", "4k-hdr", "1080p-sdr", "live")


def replay_fixture(path, device="cpu"):
    """Drive the port's engine exactly as tests/test_golden_fixtures.py drives
    the JAX one; returns (outs_y, outs_uv, deltas, fixture)."""
    z = np.load(path)
    meta = z["meta"]
    h, w, is_hdr, max_calc_res, num_iterations, black, white, n_modes = (
        int(v) for v in meta[:8])
    modes = [int(v) for v in meta[8:8 + n_modes]]
    eng = OpticalFlowEngine(h, w, is_hdr=bool(is_hdr), max_calc_res=max_calc_res,
                            num_iterations=num_iterations, black_level=float(black),
                            white_level=float(white), device=device)
    outs_y, outs_uv, deltas = [], [], []
    for i in range(z["in_y"].shape[0]):
        eng.update_frame(z["in_y"][i], z["in_uv"][i])
        if eng.frame_count < 3:
            y, uv = eng.copy_frame()
            outs_y.append(y.cpu().numpy())
            outs_uv.append(uv.cpu().numpy())
            continue
        eng.calculate_optical_flow()
        deltas.append(eng.fetch_total_frame_delta())
        for mode in modes:
            for t in (0.25, 0.75):
                y, uv = eng.warp_frames(t, mode)
                outs_y.append(y.cpu().numpy())
                outs_uv.append(uv.cpu().numpy())
    return np.stack(outs_y), np.stack(outs_uv), np.asarray(deltas, np.int64), z


@pytest.mark.parametrize("name", PORTED_FIXTURES)
def test_fixture_replay_bit_exact(name):
    ys, uvs, deltas, z = replay_fixture(os.path.join(FIXTURE_DIR, f"golden_{name}.npz"))
    np.testing.assert_array_equal(ys, z["out_y"])
    np.testing.assert_array_equal(uvs, z["out_uv"])
    np.testing.assert_array_equal(deltas, z["deltas"])


def export_state(eng) -> dict:
    """The JAX engine's stream state as numpy (what load_state takes)."""
    return {
        "_frames_y": [np.asarray(a) for a in eng._frames_y],
        "_frames_uv": [np.asarray(a) for a in eng._frames_uv],
        "_blurred": [np.asarray(a) for a in eng._blurred],
        "frame_count": eng.frame_count,
        "search_radius": eng.search_radius,
    }


def test_load_state_continues_jax_stream():
    """Four HDR frames through the JAX engine (rs 1: its strip path), the
    fifth ingested; the port takes its state and both compute one more flow
    and a batched 24->60 interval (t = 0.4, 0.8)."""
    h, w, mcr, is_hdr = 48, 64, 24, True
    rng = np.random.default_rng(11)
    frames = [nv12.synthetic_frame(rng, h, w, is_hdr=is_hdr, motion_x=3 * i)
              for i in range(5)]
    levels = dict(black_level=16.0, white_level=235.0)
    jeng = JaxEngine(h, w, is_hdr=is_hdr, max_calc_res=mcr, **levels)
    jeng.search_radius = 11
    for i, (y, uv) in enumerate(frames):
        jeng.update_frame(y, uv)
        if i < 4 and jeng.frame_count >= 3:
            jeng.calculate_optical_flow()
            jeng.fetch_total_frame_delta()
    teng = OpticalFlowEngine(h, w, is_hdr=is_hdr, max_calc_res=mcr, device="cpu", **levels)
    teng.load_state(export_state(jeng))
    assert teng.search_radius == 11 and teng.frame_count == 5

    for eng in (jeng, teng):
        eng.calculate_optical_flow()
    assert teng.fetch_total_frame_delta() == jeng.fetch_total_frame_delta()
    np.testing.assert_array_equal(teng._blurred[1].numpy(), np.asarray(jeng._blurred[1]))
    assert np.abs(np.asarray(jeng._blurred[1])).max() > 0
    for mode in (0, 1, 2):
        got = teng.warp_frames_batch([0.4, 0.8], mode)
        want = jeng.warp_frames_batch([0.4, 0.8], mode)
        for (ty, tuv), (jy, juv) in zip(got, want):
            np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
            np.testing.assert_array_equal(tuv.numpy(), np.asarray(juv))
    ty, tuv = teng.copy_frame()
    jy, juv = jeng.copy_frame()
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tuv.numpy(), np.asarray(juv))


def test_batch_equals_single_warps():
    """Every mode: a batched interval equals one warp per output."""
    rng = np.random.default_rng(3)
    eng = OpticalFlowEngine(32, 48, device="cpu")
    eng.search_radius = 8
    for i in range(4):
        eng.update_frame(*nv12.synthetic_frame(rng, 32, 48, motion_x=2 * i))
        if eng.frame_count >= 3:
            eng.calculate_optical_flow()
    for mode in range(7):
        batch = eng.warp_frames_batch([0.2, 0.6, 1.0], mode)
        for t, (by, buv) in zip([0.2, 0.6, 1.0], batch):
            y, uv = eng.warp_frames(t, mode)
            assert torch.equal(y, by) and torch.equal(uv, buv), f"mode {mode}"
    with pytest.raises(ValueError):
        eng.warp_frames(1.5, 2)
    for mode in (7, -1):
        with pytest.raises(ValueError, match="mode"):
            eng.warp_frames(0.5, mode)
