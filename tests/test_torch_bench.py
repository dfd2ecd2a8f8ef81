"""The port's headline bench on the CPU: the engine's bench units against the
JAX engine's (its jitted warp_unit, exactly, in every output mode; its
streamed flow for flow_unit) and against the port engine's own streaming
calls, and the bench's command line (python -m hopperrender_tpu_torch.bench):
its JSON lines, metric names, radius pick, and its one-line artifacts without
a card and at its deadline. Frames: 144x256 at max_calc_res 64 (res_scalar
2), panning 2 px a frame, levels 16/235."""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hopperrender_tpu.engine.flow_engine import OpticalFlowEngine as JaxEngine
from hopperrender_tpu.vio import nv12
from hopperrender_tpu_torch import bench
from hopperrender_tpu_torch.engine.flow_engine import OpticalFlowEngine

from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, MCR = 144, 256, 64
LEVELS = dict(black_level=16.0, white_level=235.0)
U32 = 0xFFFFFFFF


def _frames(is_hdr: bool, n: int = 3) -> list:
    rng = np.random.default_rng(21 + is_hdr)
    return [nv12.synthetic_frame(rng, H, W, is_hdr=is_hdr, motion_x=2 * i, coherent=True)
            for i in range(n)]


def _jax_flow(is_hdr: bool, radius: int, frames: list):
    """The JAX engine's streamed flow of frames (0, 1): (delta_raw, blurred)."""
    jeng = JaxEngine(H, W, is_hdr=is_hdr, max_calc_res=MCR, **LEVELS)
    jeng.search_radius = radius
    jeng.update_frame(*frames[0])
    jeng.update_frame(*frames[1])
    jeng.calculate_optical_flow()
    return jeng, int(jeng._pending_delta_raw), np.asarray(jeng._blurred[1])


@pytest.fixture(scope="module", params=[False, True], ids=["sdr", "hdr"])
def pair(request):
    """One geometry at radius 5: the frames, the JAX engine's streamed flow of
    frames (0, 1), its bench warp_unit jitted, and the port's CPU engine."""
    is_hdr = request.param
    frames = _frames(is_hdr)
    jeng, raw, blurred = _jax_flow(is_hdr, 5, frames)
    assert jeng.res_scalar == 2 and np.abs(blurred).max() > 0
    teng = OpticalFlowEngine(H, W, is_hdr=is_hdr, max_calc_res=MCR, device="cpu", **LEVELS)
    teng.search_radius = 5
    return types.SimpleNamespace(
        is_hdr=is_hdr, frames=frames, raw=raw, blurred=blurred, teng=teng,
        tflow=torch.tensor(blurred),
        jwarp=jax.jit(jeng.bench_units()[1], static_argnames=("mode",)),
        jsrc=[jnp.asarray(a) for a in (*frames[0], *frames[1])],
        tsrc=[torch.from_numpy(a) for a in (*frames[0], *frames[1])])


@pytest.mark.parametrize("mode", range(7))
def test_warp_unit_equals_the_jax_bench_unit(pair, mode):
    want = int(pair.jwarp(*pair.jsrc, jnp.asarray(pair.blurred), jnp.float32(0.4), mode=mode))
    _, warp_unit, _, _ = pair.teng.bench_units()
    got = warp_unit(*pair.tsrc, pair.tflow, 0.4, mode=mode)
    assert got.dtype == torch.int64 and got.shape == ()
    assert int(got) == want


@pytest.mark.parametrize("ts", [(0.4, 0.8), (0.2, 0.6, 1.0)])
def test_warp_batch_unit_is_the_sum_of_jax_warp_units(pair, ts):
    want = sum(int(pair.jwarp(*pair.jsrc, jnp.asarray(pair.blurred), jnp.float32(t), mode=2))
               for t in ts) & U32
    _, _, _, warp_batch_unit = pair.teng.bench_units()
    assert int(warp_batch_unit(*pair.tsrc, pair.tflow, ts)) == want


def test_flow_unit_equals_the_jax_stream_at_bucket_5(pair):
    flow_unit = pair.teng.bench_units()[0]
    want = (pair.raw + int(pair.blurred[0, 0, 0])) & U32
    assert int(flow_unit(*pair.tsrc)) == want


def test_flow_unit_equals_the_jax_stream_at_bucket_16():
    frames = _frames(True)
    _, raw, blurred = _jax_flow(True, 16, frames)
    teng = OpticalFlowEngine(H, W, is_hdr=True, max_calc_res=MCR, device="cpu", **LEVELS)
    teng.search_radius = 16
    flow_unit = teng.bench_units()[0]
    got = flow_unit(*(torch.from_numpy(a) for a in (*frames[0], *frames[1])))
    assert int(got) == (raw + int(blurred[0, 0, 0])) & U32


def _head_sum(y: torch.Tensor, uv: torch.Tensor) -> int:
    """The units' checksum of one output, from its numpy bytes."""
    return int(y.numpy()[0, :8].astype(np.int64).sum() + uv.numpy()[0, :8].astype(np.int64).sum())


def test_units_equal_the_engines_own_streaming_calls(pair):
    """The units on a ring's frames give the checksums of what the same engine
    serves from that ring: calculate_optical_flow, then warp_frames_batch of
    the previous pair, in every mode."""
    eng = OpticalFlowEngine(H, W, is_hdr=pair.is_hdr, max_calc_res=MCR, device="cpu", **LEVELS)
    eng.search_radius = 5
    flow_unit, warp_unit, wctx_unit, warp_batch_unit = eng.bench_units()
    eng.update_frame(*pair.frames[0])
    eng.update_frame(*pair.frames[1])
    eng.calculate_optical_flow()
    assert int(flow_unit(*pair.tsrc)) == (int(eng._pending_delta_raw)
                                          + int(eng._blurred[1][0, 0, 0])) & U32
    eng.update_frame(*pair.frames[2])
    eng.calculate_optical_flow()
    flow01 = eng._blurred[0]
    np.testing.assert_array_equal(flow01.numpy(), pair.blurred)
    for mode in range(7):
        outs = eng.warp_frames_batch([0.4, 0.8], mode)
        sums = [_head_sum(y, uv) for y, uv in outs]
        for t, s in zip((0.4, 0.8), sums):
            assert int(warp_unit(*pair.tsrc, flow01, t, mode=mode)) == s, f"mode {mode} t {t}"
        assert int(warp_batch_unit(*pair.tsrc, flow01, (0.4, 0.8), mode=mode)) == sum(sums)
    zero = wctx_unit(*pair.tsrc[:2])
    assert zero.device.type == "cpu" and int(zero) == 0


# -- the command line --------------------------------------------------------------------


def _env(**extra):
    # One intra-op thread: beside the other test workers, PyTorch's CPU
    # thread pool oversubscribes the cores and a 6 s run took over 240 s.
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.update(extra)
    return env


def _bench(*args, timeout=240, **env):
    out = subprocess.run([sys.executable, "-m", "hopperrender_tpu_torch.bench", *args],
                         cwd=ROOT, env=_env(**env), capture_output=True, text=True,
                         timeout=timeout)
    return out, [json.loads(line) for line in out.stdout.splitlines() if line.strip()]


def test_bench_on_the_cpu_prints_json_lines():
    out, lines = _bench("--device", "cpu", "--config", "480p-sdr", "--radius", "5",
                        "--json-only")
    assert out.returncode == 0, out.stderr
    assert len(lines) == 2 and lines[0]["buckets_done"] == "5<=16"
    assert set(lines[0]["measured"]) == {"radius", "flow_ms", "warp_ms", "per_source_ms"}
    last = lines[-1]
    assert {"metric", "value", "unit", "vs_baseline", "radius"} <= set(last)
    assert last["metric"] == "480p-sdr_flow_plus_warp_per_source_frame"
    assert last["radius"] == 5 and last["unit"] == "ms" and last["device"] == "cpu"
    assert last["value"] > 0
    assert abs(last["vs_baseline"] - 1e3 / 24 / last["value"]) < 2e-3
    assert "partial" not in last and "measured" not in last
    assert "per source frame" not in out.stderr   # --json-only: no breakdown


def test_bench_metric_names():
    name = lambda *a: bench.metric_name(bench.parse_args(list(a)))
    assert name() == "4k-hdr_flow_plus_warp_per_source_frame"
    assert name("--config", "1080p-sdr", "--target-fps", "120") == \
        "1080p-sdr_to120fps_flow_plus_warp_per_source_frame"
    assert name("--streams", "2", "--target-fps", "120", "--per-output-warp") == \
        "4k-hdr_x2streams_to120fps_per_output_flow_plus_warp_per_source_frame"


def _pick(per_source: dict, budget: float = 41.67):
    """pick_radius over auto's radii with per-source times from a table;
    returns (pick, radii measured, the chosen radius after each bucket)."""
    measured, chosen = [], []

    def measure(radius):
        measured.append(radius)
        return 1.0, 0.5, per_source[radius]

    rec = bench.pick_radius(bench.radii_to_measure("auto"), measure, budget,
                            lambda rec, chosen_rec: chosen.append(chosen_rec[0]))
    return rec, measured, chosen


def test_pick_radius_order_budget_fallback_and_early_stop():
    assert bench.radii_to_measure("auto") == [16, 8, 12, 5]
    assert bench.radii_to_measure("12") == [12]
    with pytest.raises(ValueError):
        bench.radii_to_measure("17")
    # 16 meets the budget: nothing left could raise the pick.
    rec, measured, _ = _pick({16: 40.0, 8: 30.0, 12: 35.0, 5: 20.0})
    assert rec == (16, 1.0, 0.5, 40.0) and measured == [16]
    # 8 meets it, 12 does not: 5 is never measured.
    rec, measured, chosen = _pick({16: 50.0, 8: 40.0, 12: 45.0, 5: 20.0})
    assert rec[0] == 8 and measured == [16, 8, 12] and chosen == [16, 8, 8]
    # 8 and 12 meet it: the higher radius wins.
    rec, measured, _ = _pick({16: 50.0, 8: 30.0, 12: 41.67, 5: 20.0})
    assert rec[0] == 12 and measured == [16, 8, 12]
    # None meets it: the fastest bucket measured, whatever its radius.
    rec, measured, chosen = _pick({16: 50.0, 8: 44.0, 12: 43.0, 5: 45.0})
    assert rec == (12, 1.0, 0.5, 43.0) and measured == [16, 8, 12, 5]
    assert chosen == [16, 8, 12, 12]


def test_bench_without_a_card_prints_one_failure_line():
    # CUDA_VISIBLE_DEVICES="" hides any card, so this holds on a GPU machine too.
    out, lines = _bench("--config", "480p-sdr", "--json-only", CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 1
    assert len(lines) == 1, out.stdout
    assert lines[0]["metric"] == "bench_failed"
    assert lines[0]["rc_cause"] == "backend-unavailable"
    assert lines[0]["vs_baseline"] is None


def test_bench_deadline_prints_one_failure_line():
    out, lines = _bench("--device", "cpu", "--config", "4k-hdr", "--json-only",
                        HRT_BENCH_DEADLINE="3")
    assert out.returncode == 3
    assert len(lines) == 1, out.stdout
    assert lines[0]["metric"] == "bench_failed"
    assert lines[0]["rc_cause"] == "timeout"
    assert "deadline" in lines[0]["error"]


def test_bench_failure_after_a_bucket_prints_the_partial_line(monkeypatch, capsys):
    """A failure in the second bucket keeps the first bucket's line, marked
    partial, with exit code 0. The chains' times are stubbed: 100 ms a unit."""
    monkeypatch.setattr(bench, "slope_ms", lambda *args, **kwargs: 100.0)
    calls = []
    units = OpticalFlowEngine.bench_units

    def failing_units(self):
        calls.append(self.search_radius)
        if len(calls) == 2:
            raise RuntimeError("injected")
        return units(self)

    monkeypatch.setattr(OpticalFlowEngine, "bench_units", failing_units)
    rc = bench.main(["--device", "cpu", "--config", "480p-sdr", "--json-only"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert rc == 0 and calls == [16, 8]
    assert len(lines) == 2 and lines[0]["radius"] == 16
    assert lines[1]["partial"] is True and "injected" in lines[1]["error"]
    assert lines[1]["value"] == lines[0]["value"] == 200.0   # a flow and a batch of warps
