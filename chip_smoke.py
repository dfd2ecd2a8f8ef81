#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hopperrender_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Builds the hand-written CUDA kernels from hopperrender_tpu_torch/csrc (nvcc,
sm_90a), then runs these phases, one line each:

  1. the device: torch's name for it and nvidia-smi's name and power limit;
  2. the build: nvcc's time and the library's path;
  3. K1 (flow blur) against its plain PyTorch version at the 4K flow grid
     (2, 270, 480), exact;
  4. K2 (batched warp) against its plain version at 4K HDR P010, flow +-64,
     t = (0.4, 0.8) and (0.2, 0.6, 1.0), levels 16/235, modes 0/1/2, exact;
  5. the served slice: FrameServer at 3840x2160 HDR, 24 -> 60, mode 2, levels
     16/235, search radius 16, ten panning frames through the kernels; the
     output count against the cadence controller's, the kernels' launch
     counters, every output against the same stream run with the plain
     versions, and the mode-0/1/2 golden fixtures replayed byte for byte;
  6. the numbers: served wall time per source frame (host clock around
     push_frame), flow time per source frame, warp time per output, copy
     time, each kernel's time against its plain version's, peak memory, and
     a torch.profiler pass over three more served frames: device busy time,
     idle share and launches per source frame, and device time by kind.

Then one JSON line of the kernels, nvidia-smi's line, and as the last line
{"ok": true, "device": {...}}. Any failure raises: the script exits non-zero
and prints no result. It imports nothing of JAX and nothing of the JAX
package itself: the shared framework-free modules come through the port.
"""

from __future__ import annotations

import os

# hopperrender_tpu/__init__.py imports jax when JAX_PLATFORMS is set; the
# port imports that package's framework-free modules and must not load jax.
os.environ.pop("JAX_PLATFORMS", None)

import contextlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W = 2160, 3840           # 4K
LOW = (2, 270, 480)         # its flow grid (res_scalar 3)
P010_MASK = 0xFFC0          # 10-bit samples, MSB-aligned in 16 bits
N_PROFILED = 3              # served frames run under torch.profiler in phase 6


def log(line: str) -> None:
    print(line, flush=True)


def import_port() -> types.SimpleNamespace:
    """Everything the run uses, imported through hopperrender_tpu_torch only
    (the server module re-exports config, Settings, CadenceController and
    nv12, the JAX package's framework-free modules)."""
    from hopperrender_tpu_torch import _build
    from hopperrender_tpu_torch.ops import blur_kernel, warp_kernel
    from hopperrender_tpu_torch.server.frame_server import (
        CadenceController, FrameServer, Settings, config, nv12)
    return types.SimpleNamespace(
        _build=_build, blur_kernel=blur_kernel, warp_kernel=warp_kernel,
        CadenceController=CadenceController, FrameServer=FrameServer, Settings=Settings,
        config=config, nv12=nv12)


@contextlib.contextmanager
def plain_versions(port):
    """Points the K1 and K2 wrappers' module attributes at their plain
    versions while the block runs; their callers (ops/flow.blur_flow and the
    engine's warp) look them up at call time."""
    kernels = port.blur_kernel.blur_flow, port.warp_kernel.warp_frames
    port.blur_kernel.blur_flow = port.blur_kernel.blur_flow_reference
    port.warp_kernel.warp_frames = port.warp_kernel.warp_frames_reference
    try:
        yield
    finally:
        port.blur_kernel.blur_flow, port.warp_kernel.warp_frames = kernels


def device_profile(prof, wall_s: float) -> tuple[float, int, dict[str, float]]:
    """Device busy seconds (union of the device events' intervals), device
    event count, and device ms by kind, from a finished torch.profiler run."""
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise AssertionError(f"the profiler recorded no device event in {wall_s:.3f} s")
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    kinds: dict[str, float] = {}
    for e in events:
        name = e.name
        kind = ("K1 blur_flow" if "blur_flow_kernel" in name else
                "K2 warp" if "warp_plane_kernel" in name else
                "memcpy DtoH" if "DtoH" in name else
                "memcpy HtoD" if "HtoD" in name else
                "gather (index)" if "index" in name.lower() else "other")
        kinds[kind] = kinds.get(kind, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return busy_us / 1e6, len(events), kinds


def as_int32(t: torch.Tensor) -> torch.Tensor:
    from hopperrender_tpu_torch.ops.warp import to_int32
    return to_int32(t)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype differ: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    return int((as_int32(a) - as_int32(b)).abs().max())


def require_equal(a: torch.Tensor, b: torch.Tensor, what: str) -> int:
    err = max_abs_err(a, b)
    if err:
        diff = (as_int32(a) != as_int32(b)).nonzero()
        first = tuple(int(i) for i in diff[0])
        raise AssertionError(f"{what}: {diff.shape[0]} elements differ, max |err| {err}; "
                             f"first at {first}: kernel {int(as_int32(a)[first])} "
                             f"plain {int(as_int32(b)[first])}")
    return err


def time_ms(fn, n: int) -> float:
    """Mean device time of one call over n back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def time_pair(kernel, plain, n_kernel: int, n_plain: int) -> tuple[float, float]:
    """Kernel and plain version timed in turns (plain, kernel, kernel, plain)."""
    p1 = time_ms(plain, n_plain)
    k1 = time_ms(kernel, n_kernel)
    k2 = time_ms(kernel, n_kernel)
    p2 = time_ms(plain, n_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def replay_fixture(path: str, device) -> None:
    """A golden fixture through the port's engine, driven as
    tests/test_golden_fixtures.py drives the JAX engine; raises on any byte
    that differs."""
    from hopperrender_tpu_torch.engine.flow_engine import OpticalFlowEngine
    z = np.load(path)
    meta = z["meta"]
    h, w, is_hdr, mcr, nit, black, white, n_modes = (int(v) for v in meta[:8])
    modes = [int(v) for v in meta[8:8 + n_modes]]
    eng = OpticalFlowEngine(h, w, is_hdr=bool(is_hdr), max_calc_res=mcr, num_iterations=nit,
                            black_level=float(black), white_level=float(white), device=device)
    ys, uvs, deltas = [], [], []
    for i in range(z["in_y"].shape[0]):
        eng.update_frame(z["in_y"][i], z["in_uv"][i])
        if eng.frame_count < 3:
            outs = [eng.copy_frame()]
        else:
            eng.calculate_optical_flow()
            deltas.append(eng.fetch_total_frame_delta())
            outs = [eng.warp_frames(t, m) for m in modes for t in (0.25, 0.75)]
        for y, uv in outs:
            ys.append(y.cpu().numpy())
            uvs.append(uv.cpu().numpy())
    name = os.path.basename(path)
    for got, want, what in ((np.stack(ys), z["out_y"], "Y"), (np.stack(uvs), z["out_uv"], "UV"),
                            (np.asarray(deltas, np.int64), z["deltas"], "scene deltas")):
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: {what} differ from the fixture")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this needs a CUDA card",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "hopperrender_tpu_torch")):
        print(f"chip_smoke: no hopperrender_tpu_torch package beside {__file__}: run it "
              "from the repository root", file=sys.stderr)
        return 1
    port = import_port()
    _build, blur_kernel, warp_kernel = port._build, port.blur_kernel, port.warp_kernel
    config, nv12 = port.config, port.nv12
    # The wrappers, whose `launches` counters show which kernels the path ran.
    k1, k2 = blur_kernel.blur_flow, warp_kernel.warp_frames

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. device --------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log(f"phase 1 device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible); nvidia-smi: {card}")

    # -- 2. build ---------------------------------------------------------------
    lib = _build.load()
    ptxas = [l.strip() for l in lib.ptxas_log.splitlines() if "registers" in l or "spill" in l]
    print("\n".join(ptxas), file=sys.stderr)
    log(f"phase 2 build: nvcc {lib.build_seconds:.2f} s, {len(ptxas) // 2} kernel "
        f"instantiations, library {os.path.relpath(lib.path, ROOT)}")

    # -- 3. K1 against its plain version ----------------------------------------
    rng = np.random.default_rng(0)
    k1_err = 0
    offsets = torch.tensor(rng.integers(-500, 501, LOW).astype(np.int16), device=dev)
    minus3 = torch.full(LOW, -3, dtype=torch.int16, device=dev)
    for x, what in ((offsets, "random +-500"), (minus3, "all -3")):
        k1_err = max(k1_err, require_equal(blur_kernel.blur_flow(x),
                                           blur_kernel.blur_flow_reference(x), f"K1 {what}"))
    torch.cuda.synchronize()
    log(f"phase 3 K1 blur_flow {LOW} int16: equal to the plain version (random +-500, "
        f"all -3); max |err| {k1_err}")

    # -- 4. K2 against its plain version ----------------------------------------
    def p010(shape):
        return torch.tensor(rng.integers(0, 1024, shape, dtype=np.uint16) << 6, device=dev)

    src = [p010((H, W)), p010((H // 2, W)), p010((H, W)), p010((H // 2, W))]
    flow = torch.tensor(rng.integers(-64, 65, LOW).astype(np.int16), device=dev)
    black, white = 16 * 256.0, 235 * 256.0
    k2_err, n_checked = 0, 0
    for ts in ((0.4, 0.8), (0.2, 0.6, 1.0)):
        t = torch.tensor(ts, dtype=torch.float32, device=dev)
        for mode in (0, 1, 2):
            kw = dict(res_scalar=3, mode=mode, is_hdr=True)
            ky, kuv = warp_kernel.warp_frames(*src, flow, t, black, white, **kw)
            py, puv = warp_kernel.warp_frames_reference(*src, flow, t, black, white, **kw)
            k2_err = max(k2_err, require_equal(ky, py, f"K2 Y mode {mode} t {ts}"),
                         require_equal(kuv, puv, f"K2 UV mode {mode} t {ts}"))
            n_checked += len(ts)
    torch.cuda.synchronize()
    log(f"phase 4 K2 warp_frames {W}x{H} P010, flow +-64, modes 0/1/2, t (0.4, 0.8) and "
        f"(0.2, 0.6, 1.0): {n_checked} outputs equal to the plain version; max |err| {k2_err}")

    # -- 5. served slice ----------------------------------------------------------
    settings = dict(target_fps=60.0, use_display_fps=False, frame_output=2, black_level=16,
                    white_level=235, auto_quality=False)
    frame_rng = np.random.default_rng(0)
    frames = []
    for i in range(10 + N_PROFILED):   # 10 served and checked, then the profiled ones
        y, uv = nv12.synthetic_frame(frame_rng, H, W, is_hdr=True, motion_x=3 * i)
        frames.append((y & P010_MASK, uv & P010_MASK))

    def new_server():
        return port.FrameServer(W, H, source_fps=24.0, is_hdr=True, device=dev,
                                settings=port.Settings(**settings))

    def serve(srv, frames):
        """Frames through srv at search radius 16: the outputs, and for each
        source frame that ran flow, push_frame's wall seconds (host clock) and
        the engine's flow time; warp and copy times per output."""
        outs, wall_s, flow_s, warp_s, copy_s = [], [], [], [], []
        for y, uv in frames:
            if srv.engine is not None:
                srv.engine.search_radius = config.MAX_SEARCH_RADIUS
            start = time.perf_counter()
            got = srv.push_frame(y, uv)
            wall = time.perf_counter() - start
            eng = srv.engine
            if eng.frame_count >= 3:
                wall_s.append(wall)
                flow_s.append(eng.ofc_time.current)
            for o in got:
                (warp_s if o.interpolated else copy_s).append(eng.warp_time.current)
            outs.extend(got)
        return outs, wall_s, flow_s, warp_s, copy_s

    torch.cuda.reset_peak_memory_stats(dev)
    k1.launches = k2.launches = 0
    srv = new_server()
    outs, wall_s, flow_s, warp_s, copy_s = serve(srv, frames[:10])
    torch.cuda.synchronize()
    launches = {"blur_flow": k1.launches, "warp_frames": k2.launches}
    peak_bytes = torch.cuda.max_memory_allocated(dev)

    cadence = port.CadenceController(24.0, 60.0)
    expected = 0
    for i in range(10):
        n = cadence.begin_source_frame(i * cadence.source_frame_time)
        for _ in range(n):
            cadence.next_output_timing()
            cadence.advance_blending()
        expected += n
    n_interp = sum(o.interpolated for o in outs)
    if len(outs) != expected:
        raise AssertionError(f"served {len(outs)} outputs, the cadence gives {expected}")
    if n_interp == 0:
        raise AssertionError("no interpolated output")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    for o in outs:
        if o.y.shape != (H, W) or o.uv.shape != (H // 2, W) or o.y.dtype != np.uint16:
            raise AssertionError(f"output shape/dtype {o.y.shape} {o.uv.shape} {o.y.dtype}")
    if srv.metrics().search_radius != config.MAX_SEARCH_RADIUS:
        raise AssertionError(f"search radius {srv.metrics().search_radius}, not 16")

    with plain_versions(port):
        plain_outs = serve(new_server(), frames[:10])[0]
    if (k1.launches, k2.launches) != (launches["blur_flow"], launches["warp_frames"]):
        raise AssertionError("the plain-version stream launched a kernel")
    if len(plain_outs) != len(outs):
        raise AssertionError("the plain-version stream gave another output count")
    for i, (k, p) in enumerate(zip(outs, plain_outs)):
        if (k.start_time, k.end_time, k.interpolated) != (p.start_time, p.end_time, p.interpolated) \
                or not np.array_equal(k.y, p.y) or not np.array_equal(k.uv, p.uv):
            raise AssertionError(f"served output {i} differs from the plain-version stream")

    fixtures = [os.path.join(ROOT, "tests", "fixtures", f"golden_{n}.npz")
                for n in ("480p-sdr", "4k-sdr", "4k-hdr")]
    missing = [p for p in fixtures if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(f"golden fixtures missing: {missing}")
    for path in fixtures:
        replay_fixture(path, dev)
    log(f"phase 5 served slice {W}x{H} HDR 24->60 mode 2 r16: {len(outs)} outputs "
        f"(cadence {expected}), {n_interp} interpolated, launches {launches}, all equal to the "
        f"plain-version stream; golden {', '.join(os.path.basename(p) for p in fixtures)} "
        f"replayed byte for byte")

    # -- 6. numbers ------------------------------------------------------------------
    k1_ms, k1_plain_ms = time_pair(lambda: k1(offsets),
                                   lambda: blur_kernel.blur_flow_reference(offsets), 200, 50)
    t3 = torch.tensor((0.2, 0.6, 1.0), dtype=torch.float32, device=dev)
    kw = dict(res_scalar=3, mode=2, is_hdr=True)
    k2_ms, k2_plain_ms = time_pair(
        lambda: k2(*src, flow, t3, black, white, **kw),
        lambda: warp_kernel.warp_frames_reference(*src, flow, t3, black, white, **kw), 50, 3)

    # The served stream goes on for N_PROFILED more frames under torch.profiler.
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        serve(srv, frames[10:])
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - start
    busy_s, n_events, kinds = device_profile(prof, prof_wall)
    per_frame = lambda v: v / N_PROFILED
    by_kind = ", ".join(f"{k} {per_frame(v):.3f}"
                        for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
    ms = lambda s: 1e3 * statistics.median(s)
    log(f"phase 6 numbers [{card}]: served wall {ms(wall_s):.3f} ms/source frame (median of "
        f"{len(wall_s)}, host clock around push_frame), flow {ms(flow_s):.3f} ms/source frame "
        f"(median of {len(flow_s)}, CUDA events), warp {ms(warp_s):.3f} ms/output (median of "
        f"{len(warp_s)}, batched), copy {ms(copy_s):.3f} ms (median of {len(copy_s)}); "
        f"K1 {k1_ms:.4f} ms vs plain {k1_plain_ms:.4f} ms at {LOW}; K2 {k2_ms:.4f} ms vs plain "
        f"{k2_plain_ms:.4f} ms per T=3 mode-2 call at {W}x{H} HDR; peak memory "
        f"{peak_bytes / 2**20:.1f} MiB (served stream, max_memory_allocated); profiled "
        f"{N_PROFILED} more frames: wall {1e3 * per_frame(prof_wall):.3f} ms/source frame "
        f"under the profiler, device busy {1e3 * per_frame(busy_s):.3f} ms/source frame, idle "
        f"{100 * (1 - busy_s / prof_wall):.1f}%, {per_frame(n_events):.0f} device "
        f"events/source frame; device ms/source frame by kind: {by_kind}")

    kernels = [
        {"name": "blur_flow", "route": "cuda",
         "source": "hopperrender_tpu_torch/csrc/blur_flow.cu",
         "replaces": "hopperrender_tpu/ops/pallas_kernels.py:63",
         "launches": launches["blur_flow"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "warp_frames", "route": "cuda",
         "source": "hopperrender_tpu_torch/csrc/warp_frame.cu",
         "replaces": "hopperrender_tpu/ops/warp_band.py:695",
         "launches": launches["warp_frames"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    if "jax" in sys.modules:
        raise AssertionError("jax was loaded")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
