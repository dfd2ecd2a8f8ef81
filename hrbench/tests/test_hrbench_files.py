"""The benchmark's data files, readers and frozen arithmetic."""

import json
import re
from pathlib import Path

import pytest
import torch

from hrbench import guard, harness, trace, work
from hrbench.record import Push, Run

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["hrbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("hrbench/") and c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] == "out_fps"
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_parse(cell):
    entry, config, traffic = harness.cell_parts(BENCH, cell)
    assert config["name"] == entry["config"]
    for key in ("width", "height", "format", "source_fps", "black_level", "white_level",
                "max_calc_res", "search_radius", "assumed", "reduced"):
        assert key in config
    assert (ROOT / "hrbench" / "drivers" / f"{traffic['driver']}.py").exists()
    harness.make_server(config, traffic, "cpu")   # the settings validate
    for traced in (False, True):
        assert harness.cell_metrics(BENCH, cell, traced)


def _run(traced: bool) -> Run:
    push = Push(k=13, t0=1.0, t1=1.01, meta=[(0, 1, 0.2, True, False)] * 3, flow_s=0.001,
                warp_s=0.0001)
    tr = trace.Trace(kernels=[("k", 0.0005)], h2d=[0.003], d2h=[0.005], other_copies=[],
                     busy_s=0.0085, window_s=0.01, device_ops=[], idle_gaps=[])
    cfg = json.loads((ROOT / "hrbench/configs/4k-hdr-p010.json").read_text())
    return Run(cell="c", config=cfg, traffic={"frame_output": 2}, warmup=[], window=[push],
               window_s=0.01, setup_s=5.0, peak_bytes=2 ** 20, radius=16,
               device=torch.device("cpu"), trace=tr if traced else None)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_readers(metric):
    read = harness.load_reader(metric)
    traced = metric in {m["name"] for m in BENCH["per_layer"]}
    value = read(_run(traced))
    assert isinstance(value, float) and value > 0
    if metric.startswith(("ingest", "egress", "kernel", "device")):
        assert read(_run(False)) is None   # nothing to read without a trace


def test_readers_by_hand():
    r = _run(True)
    read = harness.load_reader
    assert read("out_fps")(r) == pytest.approx(300.0)
    assert read("egress.d2h_ms")(r) == pytest.approx(5.0)
    assert read("device.idle_share")(r) == pytest.approx(15.0)
    assert read("device.events_per_frame")(r) == 3
    assert read("peak_mem_mib")(r) == 1.0


def test_work_matches_the_ports_bounds():
    """4K HDR at radius 16, against PERF.md's table of kernels (ms):
    flow_step 0.00547 a step, K1 0.00031, K2 mode 2 T = 3 0.0373, K2 mode 3
    T = 1 0.01749, K6 0.01486 (SDR 0.00743). K3 at a small size here; the 4K
    flow is counted on the card."""
    cfg = json.loads((ROOT / "hrbench/configs/4k-hdr-p010.json").read_text())
    s = work.Shapes(cfg, 16)
    assert work.warp_s(s, 3) * 1e3 == pytest.approx(0.0373, abs=5e-5)
    assert work.mode3_s(s) * 1e3 == pytest.approx(0.01749, abs=5e-6)
    assert work.copy_s(s) * 1e3 == pytest.approx(0.01486, abs=5e-6)
    sdr = work.Shapes(dict(cfg, format="nv12"), 16)
    assert work.copy_s(sdr) * 1e3 == pytest.approx(0.00743, abs=5e-6)
    k1 = work.roofline_s(2 * s.flow_bytes, 2 * s.low_h * s.low_w * work.K1_OPS,
                         work.INT32_OPS_PER_S)
    assert k1 * 1e3 == pytest.approx(0.00031, abs=5e-6)


def test_k3_bytes_match_chip_smoke():
    """The frozen sector count against chip_smoke.cost_volume_work on the same
    zero offsets, at a small geometry."""
    import chip_smoke
    port = chip_smoke.import_port()
    cfg = dict(height=128, width=224, format="p010", max_calc_res=32, num_iterations=0)
    s = work.Shapes(cfg, 8)
    frames = [torch.zeros((128, 224), dtype=torch.uint16), torch.zeros((64, 224),
                                                                       dtype=torch.uint16)] * 2
    offsets = torch.zeros((2, s.low_h, s.low_w), dtype=torch.int16)
    for window, step in ((16, 0), (4, 1), (1, 0)):
        hbm, _, ops = chip_smoke.cost_volume_work(port, frames, offsets, 8, window=window,
                                                  iteration=0, step=step, res_scalar=s.rs,
                                                  is_hdr=True, num_layers=8)
        assert work.k3_hbm_bytes(s, window=window, step=step) == hbm


def test_nothing_forbidden():
    assert guard.reference_imports() == []
    assert guard.loaded_forbidden({"hopperrender_tpu_torch.ops": 1, "jaxtyping": 1}) == []
    assert guard.loaded_forbidden({"jax.numpy": 1, "hopperrender_tpu": 1}) == [
        "hopperrender_tpu", "jax"]
