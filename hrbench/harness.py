"""One run of one cell: set-up, the measured window, the traced reading,
the check against the reference, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own that this module finds by the names in
BENCHMARK.json: hrbench/configs/<config>.json (the deployment: geometry,
sample format, levels, source rate, the server's settings),
hrbench/traffic/<mix>.json (the client: display rate, output mode, the pan,
the warm-up, and the driver in hrbench/drivers/ that serves it), and
hrbench/metrics/<metric>.py (a reader: read(run) returns the metric's value,
or None where the run holds nothing for it to read).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from hrbench import check, inputs
from hrbench import trace as trace_mod
from hrbench.record import Run

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def load_benchmark(path: Path = CHECKOUT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def cell_parts(bench: dict, name: str):
    """(workload entry, configuration, traffic mix) of cell `name`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((CHECKOUT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def cell_metrics(bench: dict, name: str, traced: bool) -> list[dict]:
    """The metric entries a run of cell `name` reports: its end-to-end
    metrics untraced, its per-layer metrics traced."""
    entries = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in entries if name in m.get("workloads", [name])]


def load_reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "hrbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_driver(name: str):
    return importlib.import_module(f"hrbench.drivers.{name}")


def make_server(config: dict, traffic: dict, device):
    """The system under test: the port's FrameServer with the cell's settings."""
    from hopperrender_tpu_torch.config import Settings
    from hopperrender_tpu_torch.server.frame_server import FrameServer
    settings = Settings(
        target_fps=float(traffic["target_fps"]), frame_output=int(traffic["frame_output"]),
        use_display_fps=config["use_display_fps"], auto_quality=config["auto_quality"],
        black_level=config["black_level"], white_level=config["white_level"],
        delta_scalar=config["delta_scalar"], neighbor_scalar=config["neighbor_scalar"],
        max_calc_res=config["max_calc_res"], num_iterations=config["num_iterations"],
        scene_change_threshold=config["scene_change_threshold"],
        buffer_frames=config["buffer_frames"])
    return FrameServer(config["width"], config["height"], source_fps=float(config["source_fps"]),
                       is_hdr=config["format"] == "p010", settings=settings, device=device)


def run_cell(name: str, config: dict, traffic: dict, metrics: list[dict], *, seed: int,
             seconds: float, traced: bool, device, t_start: float,
             controls=()) -> dict:
    """Set up, serve the window, check, and return the result line's fields
    (without the device's name and count, which the caller adds). controls:
    blend precisions of the check's control, each put in the program's
    place after the window (their readings under "controls")."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    t_enter = time.perf_counter()
    pool = inputs.make_pool(config, traffic, seed, device)
    t_pool = time.perf_counter()
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    server = make_server(config, traffic, device)
    keeper = check.Keeper(seed, seconds)
    span = torch.profiler.record_function if traced else (lambda _: contextlib.nullcontext())
    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)

    def window_ctx():
        return prof if prof is not None else contextlib.nullcontext()

    driver = load_driver(traffic["driver"])
    warmup, window, window_s = driver.serve(
        server, pool, traffic, seconds=seconds, radius=config["search_radius"], keep=keeper,
        span=span, window_ctx=window_ctx)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    run = Run(cell=name, config=config, traffic=traffic, warmup=warmup, window=window,
              window_s=window_s, setup_s=window[0].t0 - t_start, peak_bytes=peak,
              radius=config["search_radius"], device=device,
              trace=trace_mod.reduce(prof) if prof is not None else None)
    del server, prof
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    result = check.compare(run, pool, device, radius=config["search_radius"], controls=controls)
    ms = sorted((p.t1 - p.t0) * 1e3 for p in window)
    pick = lambda q: ms[min(len(ms) - 1, int(q * len(ms)))]  # noqa: E731
    print(f"hrbench: {name} seed {seed}: setup {run.setup_s:.3f} s (imports "
          f"{t_enter - t_start:.3f}, pool {t_pool - t_enter:.3f}, "
          f"server and warm-up {window[0].t0 - t_pool:.3f}); window {window_s:.3f} s, "
          f"{len(window)} pushes, ms a push min {ms[0]:.3f} median {pick(0.5):.3f} p90 "
          f"{pick(0.9):.3f} p99 {pick(0.99):.3f} max {ms[-1]:.3f}; check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    values = {}
    for m in metrics:
        value = load_reader(m["name"])(run)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": check.is_correct(result["checks"], result["outputs_compared"]),
           "controls": result["controls"], "attempted": len(window), "failed": 0,
           "metrics": values, "memory_peak_bytes": peak, "outputs_compared":
           result["outputs_compared"], "checks": result["checks"], "run": run}
    if run.trace is not None:
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    return out
