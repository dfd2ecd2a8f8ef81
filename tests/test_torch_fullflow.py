"""The flow at full resolution (MaxCalcRes at the frame's height, res_scalar
0) and at res_scalar 1, served on the CPU through FrameServer.push_frame as
the benchmark's cell 4k-hdr-p010-fullflow.serve60 serves it on the card
(hrbench.harness.make_server, the radius pinned to the configuration's after
the first push, a seeded pan of hrbench.inputs), against the benchmark's
plain reference (hrbench.reference: ReferenceStream and plan_stream) and
against the JAX FrameServer with the same settings and frames, exactly:
every output's description and both of its planes, in HDR and SDR,
in intervals of 2-3 outputs from one batched warp and of one output from
one warp each. And the scene gate's bound at res_scalar 0: the normalised
delta is K3's uint32 window sum over low_h * low_w * 6 (HDR), so it never
exceeds (2**32 - 1) // (low_h * low_w * 6); at 4K that is 86, under the
default threshold of 200."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from hopperrender_tpu.config import Settings as JaxSettings
from hopperrender_tpu.server.frame_server import FrameServer as JaxFrameServer
from hopperrender_tpu_torch import config as port_config
from hrbench import harness, inputs
from hrbench.reference import flow as rflow
from hrbench.reference.cadence import Output, plan_stream
from hrbench.reference.stream import ReferenceStream

from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

CONFIGS = Path(__file__).resolve().parents[1] / "hrbench" / "configs"
H, W = 64, 112
PUSHES = 10


def _config(is_hdr: bool, res_scalar: int) -> dict:
    """The cell's configuration (SDR: 4k-sdr-nv12's levels) at H x W, with
    MaxCalcRes that gives res_scalar."""
    name = "4k-hdr-p010-fullflow" if is_hdr else "4k-sdr-nv12"
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    cfg.update(height=H, width=W, max_calc_res=H >> res_scalar)
    assert rflow.calc_flow_dims(H, W, cfg["max_calc_res"])[0] == res_scalar
    return cfg


def _jax_server(cfg: dict, traffic: dict) -> JaxFrameServer:
    """The JAX FrameServer with the settings of hrbench.harness.make_server."""
    settings = JaxSettings(
        target_fps=float(traffic["target_fps"]), frame_output=int(traffic["frame_output"]),
        use_display_fps=cfg["use_display_fps"], auto_quality=cfg["auto_quality"],
        black_level=cfg["black_level"], white_level=cfg["white_level"],
        delta_scalar=cfg["delta_scalar"], neighbor_scalar=cfg["neighbor_scalar"],
        max_calc_res=cfg["max_calc_res"], num_iterations=cfg["num_iterations"],
        scene_change_threshold=cfg["scene_change_threshold"],
        buffer_frames=cfg["buffer_frames"])
    return JaxFrameServer(cfg["width"], cfg["height"], source_fps=float(cfg["source_fps"]),
                          is_hdr=cfg["format"] == "p010", settings=settings)


def _serve(cfg: dict, target_fps: int, seed: int):
    """PUSHES pushes of the seeded pan at 24 -> target_fps in mode 2, as the
    closed loop serves them, through the port and through the JAX
    FrameServer: [(meta, planes)] a push for each."""
    traffic = dict(target_fps=target_fps, frame_output=2, pan_px=3, pan_positions=6)
    pool = inputs.make_pool(cfg, traffic, seed, "cpu")
    servers = (harness.make_server(cfg, traffic, "cpu"), _jax_server(cfg, traffic))
    streams = ([], [])
    for k in range(1, PUSHES + 1):
        frame = [np.asarray(p) for p in pool.frames[pool.frame_index(k)]]
        for server, pushes in zip(servers, streams):
            outputs = server.push_frame(*frame)
            if k == 1:
                server.engine.search_radius = cfg["search_radius"]
            pushes.append(([(o.start_time, o.end_time, o.blending_scalar, o.interpolated,
                             o.scene_change) for o in outputs],
                           [(np.asarray(o.y), np.asarray(o.uv)) for o in outputs]))
    assert servers[0].engine.res_scalar == rflow.calc_flow_dims(H, W, cfg["max_calc_res"])[0]
    return pool, traffic, streams


@pytest.mark.parametrize("target_fps", [60, 30], ids=["batched", "single"])
@pytest.mark.parametrize("is_hdr", [True, False], ids=["hdr", "sdr"])
@pytest.mark.parametrize("res_scalar", [0, 1])
def test_served_stream_equals_the_reference(res_scalar, is_hdr, target_fps):
    """24 -> 60 gives intervals of 2-3 outputs, each one batched K2 call;
    24 -> 30 mostly one output an interval, each its own K2 call. The JAX
    FrameServer serves the same frames to the same outputs."""
    cfg = _config(is_hdr, res_scalar)
    pool, traffic, (pushes, jax_pushes) = _serve(cfg, target_fps,
                                                 seed=2_200_000_000 + 7 * res_scalar)
    ref = ReferenceStream(pool.frames, pool.frame_index, cfg, radius=cfg["search_radius"],
                          mode=2, device="cpu")
    plan = plan_stream(PUSHES, ref.frame_delta, source_fps=cfg["source_fps"],
                       target_fps=target_fps, scene_threshold=cfg["scene_change_threshold"],
                       buffer_frames=cfg["buffer_frames"])
    sizes = set()
    for k, ((meta, planes), want) in enumerate(zip(pushes, plan), start=1):
        assert [Output(*m) for m in meta] == want, k
        sizes.add(sum(o.interpolated for o in want))
        for (y, uv), (wy, wuv) in zip(planes, ref.outputs(k, want)):
            np.testing.assert_array_equal(y, wy)
            np.testing.assert_array_equal(uv, wuv)
    assert (sizes >= {2, 3}) if target_fps == 60 else (1 in sizes)
    for k, ((meta, planes), (jmeta, jplanes)) in enumerate(zip(pushes, jax_pushes), start=1):
        assert meta == jmeta, k
        for (y, uv), (jy, juv) in zip(planes, jplanes):
            np.testing.assert_array_equal(y, jy)
            np.testing.assert_array_equal(uv, juv)


def test_scene_delta_never_exceeds_its_uint32_bound_at_res_scalar_0():
    """Frames 0 and full scale at res_scalar 0 on a grid whose first window
    holds enough cells for K3's uint32 sum to wrap: the engine's normalised
    delta equals the reference's and stays within (2**32 - 1) // (low_h *
    low_w * 6), which at the cell's 4K geometry is 86 < 200."""
    from hopperrender_tpu_torch.engine.flow_engine import OpticalFlowEngine

    h, w = 192, 320
    rs, low_h, low_w = port_config.calc_flow_dims(h, w, h)
    bound = (2 ** 32 - 1) // (low_h * low_w * 6)
    window = port_config.initial_window_size(low_h, low_w)
    cells = min(window, low_h) * min(window, low_w)
    assert rs == 0 and cells * (3 * 255 << 8) > 2 ** 32   # the unwrapped sum would overflow
    eng = OpticalFlowEngine(h, w, is_hdr=True, max_calc_res=h, device="cpu")
    eng.search_radius = 16
    rng = np.random.default_rng(22)
    full = np.full((h, w), 0xFFC0, np.uint16)
    frames = [(np.zeros((h, w), np.uint16), np.zeros((h // 2, w), np.uint16)),
              (full, full[::2].copy()),
              tuple((rng.integers(0, 1024, s, dtype=np.uint16) << 6).astype(np.uint16)
                    for s in ((h, w), (h // 2, w)))]
    for i, (a, b) in enumerate(((0, 1), (1, 2))):
        for f in (frames[a], frames[b]) if i == 0 else (frames[b],):
            eng.update_frame(*f)
        eng.calculate_optical_flow()
        got = eng.fetch_total_frame_delta()
        want = rflow.frame_delta(*map(torch.from_numpy, frames[a] + frames[b]), 16,
                                 eng.delta_scalar, eng.neighbor_scalar, low_h=low_h,
                                 low_w=low_w, res_scalar=0, is_hdr=True)
        assert got == want <= bound
    cell = json.loads((CONFIGS / "4k-hdr-p010-fullflow.json").read_text())
    _, low_h, low_w = port_config.calc_flow_dims(cell["height"], cell["width"],
                                                 cell["max_calc_res"])
    assert (2 ** 32 - 1) // (low_h * low_w * 6) == 86 < cell["scene_change_threshold"]


# Peak device memory of the benchmark's cells on an NVIDIA H100 80GB HBM3
# (torch.cuda.max_memory_allocated over a 51 s window, PERF.md section 4):
# (height, width, is_hdr, max_calc_res, bytes).
MEASURED_PEAKS = [(2160, 3840, True, 2160, 474_477_056),   # fullflow serve60, T 2-3
                  (2160, 3840, True, 270, 202_458_624),    # serve120, T = 5
                  (2160, 3840, True, 270, 151_844_352),    # serve60
                  (2160, 3840, False, 270, 76_205_568),    # SDR serve60
                  (2160, 3840, False, 270, 63_716_864)]    # hsv60, T = 1


@pytest.mark.parametrize("h, w, is_hdr, max_calc_res, peak", MEASURED_PEAKS)
def test_device_estimate_is_within_twice_the_measured_peak(h, w, is_hdr, max_calc_res, peak):
    """The engine's pre-check estimate (estimate_device_bytes) against the
    peaks the cells measured: never under 0.9x, never over 2x."""
    from hopperrender_tpu_torch.engine.flow_engine import estimate_device_bytes

    need = estimate_device_bytes(h, w, is_hdr=is_hdr, max_calc_res=max_calc_res)
    assert 0.9 * peak <= need <= 2 * peak
