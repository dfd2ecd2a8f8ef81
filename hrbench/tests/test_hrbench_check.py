"""The harness end to end on the CPU at a tiny size (the program's plain
versions behind FrameServer): a sound run is correct; the control, the
reference put in the program's place a step below float32 with FMA, is
not; nor is a run with the timed path broken underneath."""

import time

import numpy as np
import pytest

from hopperrender_tpu_torch.ops import cost_volume_kernel, warp_kernel
from hopperrender_tpu_torch.server import frame_server
from hrbench import harness

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


def tiny_run(cell, seed=2**31 + 7, seconds=0.4, controls=()):
    bench = harness.load_benchmark()
    _, config, traffic = harness.cell_parts(bench, cell)
    config = dict(config, width=224, height=128, max_calc_res=32)
    return harness.run_cell(cell, config, traffic, harness.cell_metrics(bench, cell, False),
                            seed=seed, seconds=seconds, traced=False, device="cpu",
                            t_start=time.perf_counter(), controls=controls)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_controls_are_not(cell):
    out = tiny_run(cell, controls=("bf16", "nofma"))
    assert out["correct"], out["checks"]
    assert out["outputs_compared"] > 0
    for control, checks in out["controls"].items():
        assert any(v > lim for v, lim in checks.values()), (control, checks)
    want = {m["name"] for m in harness.cell_metrics(harness.load_benchmark(), cell, False)}
    assert set(out["metrics"]) == want - {"peak_mem_mib"}   # no card, no peak to read


def _flow_step_unchanged(monkeypatch):
    monkeypatch.setattr(cost_volume_kernel, "flow_step", lambda state, k: None)


def _half_batch(monkeypatch):
    real = warp_kernel.warp_frames

    def half(*args, **kw):
        y, uv = real(*args, **kw)
        keep = -(-y.shape[0] // 2)
        y[keep:] = 0
        uv[keep:] = 0
        return y, uv

    monkeypatch.setattr(warp_kernel, "warp_frames", half)


def _altered_sample(monkeypatch):
    def host(t):
        a = t.cpu().numpy()
        a.flat[a.size // 2] ^= 1
        return a

    monkeypatch.setattr(frame_server, "_host", host)


def _timestamp_off(monkeypatch):
    from hopperrender_tpu_torch.server import control
    real = control.CadenceController.next_output_timing

    def late(self):
        timing = real(self)
        timing.end_time += 1
        return timing

    monkeypatch.setattr(control.CadenceController, "next_output_timing", late)


FAULTS = {"flow_step_unchanged": _flow_step_unchanged, "half_batch": _half_batch,
          "altered_sample": _altered_sample, "timestamp_off": _timestamp_off}


@pytest.mark.parametrize("cell,fault", [
    ("4k-hdr-p010.serve60", "flow_step_unchanged"), ("4k-hdr-p010.serve60", "half_batch"),
    ("4k-hdr-p010.serve60", "altered_sample"), ("4k-sdr-nv12.hsv60", "flow_step_unchanged"),
    ("4k-sdr-nv12.hsv60", "altered_sample"), ("4k-hdr-p010.serve120", "half_batch"),
    ("4k-hdr-p010.serve120", "timestamp_off")])
def test_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    out = tiny_run(cell)
    assert not out["correct"], out["checks"]
    caught = {"flow_step_unchanged": "y_mismatch", "half_batch": "y_mismatch",
              "altered_sample": "uv_mismatch", "timestamp_off": "meta_mismatch"}[fault]
    assert out["checks"][caught][0] > 0, out["checks"]


def test_sampled_pushes_are_spread_and_last_is_kept():
    out = tiny_run("4k-sdr-nv12.hsv60", seconds=0.8)
    run = out["run"]
    kept = [p.k for p in run.window if p.planes is not None]
    assert run.window[-1].planes is not None
    assert 2 <= len(kept) <= 9
    assert [p.k for p in run.warmup if p.planes is not None] == [1, 2, 3]
    assert np.all(np.diff(kept) > 0)
