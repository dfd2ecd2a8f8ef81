#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hopperrender_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                   # from the repository root; needs one CUDA card
    python3 chip_smoke.py --parallel-only   # phases 1, 2 and 7; on four cards, 7c
                                            # adds meshes of a rank per card (NCCL)
    python3 chip_smoke.py --kernel-times    # phases 1, 2, then the kernels' times only

Builds the hand-written CUDA kernels from hopperrender_tpu_torch/csrc (nvcc,
sm_90a), then runs these phases, one line each:

  1. the device: torch's name for it and nvidia-smi's name and power limit;
  2. the build: nvcc's time and the library's path;
  3. K1 (flow blur) against its plain PyTorch version at the 4K flow grid
     (2, 270, 480) and at (2, 33, 65), exact;
  4. K2 (batched warp) against its plain version at 4K HDR P010, on three
     flow grids: random +-64, smooth (K1 over random +-500) and mirror-edge
     (+-64 toward both edges in x and y), t = (0.4, 0.8) and (0.2, 0.6,
     1.0), levels 16/235, modes 0/1/2, exact;
     4b. K2's raw_blend variant (mode 2 without levels) against its plain
     version, same sources and flows, t = (0.2, 0.6, 1.0), exact;
     4c. the HSV flow colour (mode 3) on the card against the same function
     on the CPU, every (ox, oy) in +-512, SDR and HDR, res_impact 1 and 4,
     channels 0/1/2, exact;
  5. the served slice: FrameServer at 3840x2160 HDR, 24 -> 60, mode 2, levels
     16/235, search radius 16, ten panning frames through the kernels; the
     output count against the cadence controller's, the kernels' launch
     counters, every output against the same stream run with the plain
     versions, and all five golden fixtures replayed byte for byte;
     5b. served mode 3 (HSV flow) the same way: ten frames through K1 and
     K2's raw_blend variant;
     5c. served modes 4, 5 and 6, six frames each (mode 4 runs K1 only,
     modes 5/6 K1 and K2);
  6. the numbers: served wall time per source frame (host clock around
     push_frame), flow time per source frame, warp time per output, copy
     time, peak memory, and a torch.profiler pass over three more served
     frames: device busy time, idle share and launches per source frame, and
     device time by kind; the warp time per output of modes 3-6 (CUDA
     events) from 5b/5c; and the kernels' device times, graph-timed (n
     calls captured in one CUDA graph, the replay timed with CUDA events, so
     no host time is in them) on random and on smooth flow: K1, K2 (mode 2
     T = 3) and its raw_blend variant, each wrapper's host us per call (the
     host clock over back-to-back calls before a synchronise), the plain
     versions (CUDA events), and the floor of an empty launch; beside them,
     what holds K2: mode 0 T = 3 and mode 2 T = 1, zero and pan flow, and a
     copy of K2's bytes (the card's reachable rate);
  7. the parallel path:
     7a. K2's mesh-sharded variant (warp_frames_band) against its plain
     version for every shard, and the shards stacked against the full K2:
     4K HDR P010, flow +-64, t (0.2, 0.6, 1.0), modes 0/1/2, levels 16/235,
     n = 2, 4, 8; smooth and mirror-edge flow at n = 2; and 1080p SDR at n =
     8, where UV's rows split unevenly; mode 3 at 4K HDR, n = 2: the band's
     raw_blend variant against its plain version (each flow), coloured by the
     banded HSV overlay, against the plain row route; the band graph-timed
     on random and smooth flow, as phase 6;
     7b. batched_step on two 4K HDR streams (panning 3 px/frame, radius 16,
     three steps): outputs, flow and delta against the single-stream path
     (pyramid_flow + K2), and against the same run on the plain versions;
     7c. make_multichip_step through launch.run_ranks at 4K HDR, rs 3, modes 2
     and 3, t_batch 3, on meshes (1, 2) and (2, 1) of ranks sharing this card
     over gloo (and (1, 4), (2, 2) over NCCL where four cards are visible):
     each rank writes its outputs to an .npz, held byte for byte to 7b's
     single-device results (mode 3: K2's raw_blend variant and the HSV
     overlay on the full frame); every rank must have launched the band
     kernel, and in mode 3 its raw_blend variant. Its numbers: each mesh's
     second mode-2 step (CUDA events in the ranks);
  8. the probes P1-P4 (hopperrender_tpu_torch/probes/):
     8a. each kernel against its plain version, exactly: every P1 and P2
     variant at n = 600 (past the 512-entry table) on 1 block and on 132,
     every slot; P3's three and P4's seven at indices and offsets whose
     windows clamp; transpose8 refused before a launch;
     8b. the probe path (probes/__main__.run_probe, what `python -m
     hopperrender_tpu_torch.probes` runs) with the counters at 0: chain and
     chain2 at 1 and 132 blocks (ns per iteration by the slope over n =
     20,000 and 120,000), the gather and mosaic kernels, and the block-gather
     rates; every probe kernel must have launched;
     8c. each probe's kernels against their plain versions and the one-call
     PyTorch counterparts (torch.gather; slicing and torch.roll).

Before each served path, and before the probe path, every launch counter
is set to 0, and after it each kernel of that path must have launched (the
ranks of 7c start at 0). Then one JSON line of the kernels
(with each one's bound: the least time the card could take for its work;
`ms` the graph-timed time on random flow, `smooth_ms` on smooth flow for
K1, K2, raw_blend and the band, and their `host_us`),
nvidia-smi's line, and as the last line {"ok": true, "device": {...}}. Any
failure raises: the script exits non-zero and prints no result. It imports
nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W = 2160, 3840           # 4K
LOW = (2, 270, 480)         # its flow grid (res_scalar 3)
P010_MASK = 0xFFC0          # 10-bit samples, MSB-aligned in 16 bits
N_PROFILED = 3              # served frames run under torch.profiler in phase 6
FIXTURES = ("480p-sdr", "4k-sdr", "4k-hdr", "1080p-sdr", "live")

# The bound of a kernel: the larger of its bytes (each input read once, each
# output written once) over the memory rate and its operations over the rate
# of their type: float32 on the CUDA cores from the H100 SXM data sheet;
# int32 from its 132 SMs of 64 INT32 lanes each (NVIDIA's Hopper
# architecture paper) at the 1,980 MHz boost clock.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Arithmetic operations per output element, integer and float alike: K1's
# separable 8x8 box sum (7 + 7 adds) and its truncating division; K2's flow
# lookup and back-projection (~10), two warped positions (~16 each: product,
# round, mirror, clamp, index), the blend (~4) and, for mode 2, the levels
# (~4). The raw_blend variant has no levels. K1's are integer operations.
OPS_PER_ELEMENT = {"blur_flow": 16, "warp_frames": 50, "warp_frames_raw_blend": 46,
                   "warp_frames_band": 50}
OPS_RATE = {"blur_flow": INT32_OPS_PER_S}
# The probes' least work, in integer operations (a load counts as one):
# (per element, per tile) of one iteration for P1/P2, of one launch for
# P3/P4. Per element: its address, its loads, its XOR, add or write. Per
# tile, once: what every element shares (the table's fields, c >> 2 and the
# lane start, the row start, the window clamps at 4 each, the tile's base
# address, the loop's count and test). Terms that no iteration changes
# (static rolls, P2's residual row group and lane p) are made before the
# loop and not counted. full and full_aligned_rows write only the 8 x 16
# elements of lanes [t_sub, t_sub + 16); each costs FULL_SECOND_WORD_OPS more
# (the second word's lane, address, load, two shifts and the OR) in the
# iterations whose c & 3 is not 0.
PROBE_OPS = {
    "chain_probe": {"empty": (1, 4), "smem_only": (1, 9), "load8x128": (3, 19),
                    "load8x256": (3, 19), "load16x256": (3, 19), "roll0": (6, 20),
                    "roll0_static": (3, 19), "roll1": (6, 20), "roll1_static": (3, 19),
                    "roll1_128": (6, 20), "full": (8, 28), "full_aligned_rows": (6, 28)},
    "chain_probe2": {"slice_static": (3, 19), "slice_static_x17": (35, 19), "vsel_x17": (9, 13),
                     "fastpath_tile": (9, 13), "cond_branch": (3, 22),
                     "dyngather_ax0_8": (6, 18), "dyngather_ax0_32": (6, 18),
                     "dyngather_ax0_256": (6, 18), "dyngather_ax1_8": (6, 18),
                     "dyngather_ax1_32": (6, 18)},
    "gather_probe": {"take_along_sublane": (8, 0), "take_along_lane": (9, 0),
                     "vector_index": (7, 0)},
    "mosaic_probe": {"dyn_sublane": (2, 6), "dyn_sublane_aligned": (2, 7),
                     "dyn_lane_aligned": (2, 7), "dyn_both": (2, 12), "dyn_roll_lane": (4, 1),
                     "dyn_roll_sublane": (4, 1), "dyn_sublane_16": (5, 7)},
}
FULL_LANES, FULL_SECOND_WORD_OPS = 8 * 16, 7
PROBE_N, PROBE_BLOCKS = 600, (1, 132)     # parity: past the table, one SM and every SM


def log(line: str) -> None:
    print(line, flush=True)


def import_port() -> types.SimpleNamespace:
    """Everything the run uses, imported from hopperrender_tpu_torch only."""
    from hopperrender_tpu_torch import _build, config, entry
    from hopperrender_tpu_torch.config import Settings
    from hopperrender_tpu_torch.ops import blur_kernel, warp_kernel, warp_viz
    from hopperrender_tpu_torch.ops import flow as flow_ops
    from hopperrender_tpu_torch.ops import warp as warp_ops
    from hopperrender_tpu_torch.parallel import launch
    from hopperrender_tpu_torch.parallel.batched import batched_step
    from hopperrender_tpu_torch.probes import __main__ as probe_path
    from hopperrender_tpu_torch.probes import chain_probe, chain_probe2, gather_probe
    from hopperrender_tpu_torch.probes import mosaic_probe
    from hopperrender_tpu_torch.server.control import CadenceController
    from hopperrender_tpu_torch.server.frame_server import FrameServer
    from hopperrender_tpu_torch.vio import nv12
    return types.SimpleNamespace(
        _build=_build, blur_kernel=blur_kernel, warp_kernel=warp_kernel, warp_viz=warp_viz,
        warp_ops=warp_ops, CadenceController=CadenceController, FrameServer=FrameServer,
        Settings=Settings, config=config, nv12=nv12, entry=entry, flow_ops=flow_ops,
        launch=launch, batched_step=batched_step, probe_path=probe_path,
        probes=dict(chain_probe=chain_probe, chain_probe2=chain_probe2,
                    gather_probe=gather_probe, mosaic_probe=mosaic_probe))


@contextlib.contextmanager
def plain_versions(port):
    """Points the K1 and K2 wrappers' module attributes (K2's mesh-sharded
    variant too) at their plain versions while the block runs; their callers
    (ops/flow.blur_flow, ops/warp_viz.warp_outputs, parallel/mesh.py) look
    them up at call time."""
    wk = port.warp_kernel
    kernels = port.blur_kernel.blur_flow, wk.warp_frames, wk.warp_frames_band
    port.blur_kernel.blur_flow = port.blur_kernel.blur_flow_reference
    wk.warp_frames = wk.warp_frames_reference  # raw_blend too
    wk.warp_frames_band = wk.warp_frames_band_reference
    try:
        yield
    finally:
        port.blur_kernel.blur_flow, wk.warp_frames, wk.warp_frames_band = kernels


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


def graph_ms(fn, n: int, replays: int = 3) -> float:
    """Device ms of one call: n calls captured in one CUDA graph, the graph
    replayed `replays` times, each replay timed with CUDA events; the median
    replay over n. The host's share of a call (Python, ctypes, allocation) is
    not in it: the kernels run back to back on the device."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                        # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def host_us(fn, n: int) -> float:
    """Host microseconds per call: the host clock over n back-to-back calls,
    before any synchronise (the wrapper's Python, ctypes call and launch)."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(n):
        fn()
    us = 1e6 * (time.perf_counter() - start) / n
    torch.cuda.synchronize()
    return us


def empty_launch_ms(port) -> float | None:
    """Graph-timed device ms of an empty launch (csrc/errors.cu): the floor
    under any launch-bound kernel. None where the library has no such entry
    point (a tree from before it was added)."""
    lib = port._build.load().lib
    launch = getattr(lib, "hrt_empty_launch", None)
    if launch is None:
        return None
    return graph_ms(lambda: port._build.check(
        launch(torch.cuda.current_stream().cuda_stream), "empty launch"), 200)


def smooth_flow(port, rng) -> torch.Tensor:
    """A smooth 4K flow grid: K1 over random +-500 offsets (the box average of
    8x8 cells; neighbouring cells share 7/8 of their window), +-60 or so."""
    offsets = torch.tensor(rng.integers(-500, 501, LOW).astype(np.int16), device="cuda")
    return port.blur_kernel.blur_flow(offsets)


def edge_flow(rng) -> torch.Tensor:
    """A 4K flow grid that drives runs across both mirror edges in x and in y:
    +64 in the left (top) half, -64 in the right (bottom) half, +-8 noise."""
    _, low_h, low_w = LOW
    yy, xx = np.mgrid[0:low_h, 0:low_w]
    noise = rng.integers(-8, 9, LOW)
    fx = np.where(xx < low_w // 2, 64, -64) + noise[0]
    fy = np.where(yy < low_h // 2, 64, -64) + noise[1]
    return torch.tensor(np.stack([fx, fy]).astype(np.int16), device="cuda")


def k2_inputs(port, dev) -> types.SimpleNamespace:
    """Phases 3, 4 and 6's inputs, from seed 0: K1's random +-500 offsets, two
    4K P010 source frames, and three flow grids: random +-64, smooth and
    mirror-edge."""
    rng = np.random.default_rng(0)
    offsets = torch.tensor(rng.integers(-500, 501, LOW).astype(np.int16), device=dev)

    def p010(shape):
        return torch.tensor(rng.integers(0, 1024, shape, dtype=np.uint16) << 6, device=dev)

    src = [p010((H, W)), p010((H // 2, W)), p010((H, W)), p010((H // 2, W))]
    flow = torch.tensor(rng.integers(-64, 65, LOW).astype(np.int16), device=dev)
    flows = {"random +-64": flow, "smooth": smooth_flow(port, rng), "mirror-edge": edge_flow(rng)}
    return types.SimpleNamespace(
        rng=rng, offsets=offsets, src=src, flows=flows,
        t1=torch.tensor((0.6,), dtype=torch.float32, device=dev),
        t3=torch.tensor((0.2, 0.6, 1.0), dtype=torch.float32, device=dev),
        black=16 * 256.0, white=235 * 256.0)


def band_numbers(port, src, flows: dict, t3, black: float, white: float) -> dict:
    """K2's band (n 2, shard 0, mode 2, T = 3, 4K HDR): graph-timed device ms
    on random and on smooth flow, host us per call, plain ms (CUDA events)."""
    wk = port.warp_kernel
    kw = dict(res_scalar=3, mode=2, is_hdr=True, num_shards=2, shard_index=0)

    def band(fl, fn=wk.warp_frames_band):
        return lambda: fn(*src, fl, t3, black, white, **kw)

    random, plain = flows["random +-64"], band(flows["random +-64"],
                                               wk.warp_frames_band_reference)
    return {"ms": graph_ms(band(random), 20), "smooth_ms": graph_ms(band(flows["smooth"]), 20),
            "host_us": host_us(band(random), 20),
            "plain_ms": (time_ms(plain, 2) + time_ms(plain, 2)) / 2}


def kernel_numbers(port, inp) -> dict:
    """Phase 6's kernel numbers at 4K HDR: K1, K2 (mode 2 T = 3) and its
    raw_blend variant, each graph-timed on random and on smooth flow, host us
    per wrapper call, the plain version's ms (CUDA events), and the
    empty-launch floor. To see what holds K2: mode 0 T = 3 and mode 2 T = 1
    on random, smooth and zero flow, mode 2 T = 3 on zero flow and on a
    pan, and a copy of K2's bytes."""
    k1, wk = port.blur_kernel, port.warp_kernel
    src, t1, t3, black, white = inp.src, inp.t1, inp.t3, inp.black, inp.white
    random, smooth = inp.flows["random +-64"], inp.flows["smooth"]

    def k2(fl, ts, mode=2, raw=False, fn=None):
        fn = fn or wk.warp_frames
        return lambda: fn(*src, fl, ts, black, white, res_scalar=3, mode=mode, is_hdr=True,
                          raw_blend=raw)

    def plain_ms(fn, n):
        return (time_ms(fn, n) + time_ms(fn, n)) / 2

    out = {"empty_launch_ms": empty_launch_ms(port)}
    out["blur_flow"] = {"ms": graph_ms(lambda: k1.blur_flow(inp.offsets), 200),
                        "smooth_ms": graph_ms(lambda: k1.blur_flow(smooth), 200),
                        "host_us": host_us(lambda: k1.blur_flow(inp.offsets), 200),
                        "plain_ms": plain_ms(lambda: k1.blur_flow_reference(inp.offsets), 20)}
    for name, mode, raw in (("warp_frames", 2, False), ("warp_frames_raw_blend", 2, True)):
        out[name] = {"ms": graph_ms(k2(random, t3, mode, raw), 20),
                     "smooth_ms": graph_ms(k2(smooth, t3, mode, raw), 20),
                     "host_us": host_us(k2(random, t3, mode, raw), 20),
                     "plain_ms": plain_ms(k2(random, t3, mode, raw, wk.warp_frames_reference), 2)}
    zero = torch.zeros_like(random)
    pan = zero.clone()
    pan[0] = 3       # every cell 3 px along x: the served stream's pan
    out["variants"] = {
        f"{label} {flow}": graph_ms(k2(fl, ts, mode), 20)
        for label, ts, mode in (("mode 0 T=3", t3, 0), ("mode 2 T=1", t1, 2))
        for flow, fl in (("random", random), ("smooth", smooth), ("zero flow", zero))}
    out["variants"]["mode 2 T=3 zero flow"] = graph_ms(k2(zero, t3, 2), 20)
    out["variants"]["mode 2 T=3 pan (3, 0)"] = graph_ms(k2(pan, t3, 2), 20)
    # The card's achievable rate for K2's bytes: a copy that reads half of
    # them and writes the other half.
    half = (nbytes(*src) + 3 * nbytes(src[0], src[1])) // 2
    buf, dst = (torch.empty(half, dtype=torch.uint8, device=random.device) for _ in range(2))
    out["variants"]["copy of K2's bytes"] = graph_ms(lambda: dst.copy_(buf), 20)
    return out


def format_numbers(numbers: dict) -> str:
    """One line of kernel_numbers (and band_numbers under "warp_frames_band")."""
    parts = []
    floor = numbers.get("empty_launch_ms")
    parts.append("empty launch " + ("not in this build" if floor is None else f"{floor:.5f} ms"))
    for name in ("blur_flow", "warp_frames", "warp_frames_raw_blend", "warp_frames_band"):
        if name in numbers:
            v = numbers[name]
            smooth = f", smooth {v['smooth_ms']:.5f}" if "smooth_ms" in v else ""
            parts.append(f"{name} {v['ms']:.5f} ms{smooth}, host {v['host_us']:.1f} us/call, "
                         f"plain {v['plain_ms']:.4f} ms")
    parts += [f"{k} {v:.5f} ms" for k, v in numbers.get("variants", {}).items()]
    return "; ".join(parts)


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


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def roofline(bytes_moved: int, ops: int, ops_per_s: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the bytes' time and the operations'."""
    bytes_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / ops_per_s
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def bound(name: str, bytes_moved: int, n_elements: int) -> tuple[float, str]:
    """(bound_ms, bound_by) of a kernel call that moves bytes_moved and
    computes n_elements output elements."""
    return roofline(bytes_moved, n_elements * OPS_PER_ELEMENT[name],
                    OPS_RATE.get(name, OPS_PER_S))


def reset_launches(k1, k2, k2_band) -> None:
    k1.launches = k2.launches = k2.raw_launches = k2_band.launches = 0


def read_launches(k1, k2, k2_band) -> dict[str, int]:
    return {"blur_flow": k1.launches, "warp_frames": k2.launches,
            "warp_frames_raw_blend": k2.raw_launches, "warp_frames_band": k2_band.launches}


def cadence_count(port, n_frames: int) -> int:
    """Outputs the cadence controller gives n_frames source frames at 24 -> 60."""
    cadence = port.CadenceController(24.0, 60.0)
    expected = 0
    for i in range(n_frames):
        n = cadence.begin_source_frame(i * cadence.source_frame_time)
        for _ in range(n):
            cadence.next_output_timing()
            cadence.advance_blending()
        expected += n
    return expected


def require_same_stream(outs, plain_outs, what: str) -> None:
    if len(plain_outs) != len(outs):
        raise AssertionError(f"{what}: the plain-version stream gave another output count")
    for i, (k, p) in enumerate(zip(outs, plain_outs)):
        if (k.start_time, k.end_time, k.interpolated) != (p.start_time, p.end_time, p.interpolated) \
                or not np.array_equal(k.y, p.y) or not np.array_equal(k.uv, p.uv):
            raise AssertionError(f"{what}: served output {i} differs from the plain-version stream")


def band_bound(src, flow, ts, num_shards: int, shard: int) -> tuple[float, str]:
    """Bound of one warp_frames_band call: it writes T (r_y + r_uv) W samples
    and reads its rows of both sources, plus a halo of this flow's largest
    vertical displacement (halved on UV), clipped to the planes, and the flow
    and ts once."""
    from hopperrender_tpu_torch.ops.warp import band_rows
    (h, w), itemsize = src[0].shape, src[0].element_size()
    halo = int(flow[1].abs().max())
    n_t, rows_read, rows_out = ts.shape[0], 0, 0
    for plane_h, plane_halo in ((h, halo), (h // 2, -(-halo // 2))):
        r = band_rows(plane_h, num_shards)
        row0 = shard * r
        rows_out += r
        rows_read += 2 * (min(plane_h, row0 + r + plane_halo) - max(0, row0 - plane_halo))
    moved = (n_t * rows_out + rows_read) * w * itemsize + nbytes(flow, ts)
    return bound("warp_frames_band", moved, n_t * rows_out * w)


def parallel_path(port, dev, card: str) -> dict:
    """Phase 7: K2's mesh-sharded variant against its plain version and the
    full K2 (7a), batched_step on two 4K HDR streams against the
    single-stream path (7b), and make_multichip_step on ranks of one card
    against 7b's results (7c). Returns the band kernel's entry of the
    `kernels` line."""
    wk, entry, launch = port.warp_kernel, port.entry, port.launch
    k1, k2, k2_band = port.blur_kernel.blur_flow, wk.warp_frames, wk.warp_frames_band

    # -- 7a. the kernel: every shard against its plain version, the shards
    # stacked against the full K2, at 4K HDR P010 with flow +-64 (n = 2, 4,
    # 8), smooth and mirror-edge flow (n = 2), and 1080p SDR (n = 8: UV's 540
    # rows split into 68-row bands, the last one 64).
    rng = np.random.default_rng(7)
    src = [torch.tensor(rng.integers(0, 1024, shape, dtype=np.uint16) << 6, device=dev)
           for shape in ((H, W), (H // 2, W)) * 2]
    flow = torch.tensor(rng.integers(-64, 65, LOW).astype(np.int16), device=dev)
    t3 = torch.tensor((0.2, 0.6, 1.0), dtype=torch.float32, device=dev)
    black, white = 16 * 256.0, 235 * 256.0
    sdr = [torch.tensor(rng.integers(0, 256, shape, dtype=np.uint8), device=dev)
           for shape in ((1080, 1920), (540, 1920)) * 2]
    sdr_flow = torch.tensor(rng.integers(-64, 65, (2, 270, 480)).astype(np.int16), device=dev)
    flows = {"random +-64": flow, "smooth": smooth_flow(port, rng), "mirror-edge": edge_flow(rng)}
    cases = [(src, flow, black, white, 3, True, n) for n in (2, 4, 8)]
    cases += [(src, flows[k], black, white, 3, True, 2) for k in ("smooth", "mirror-edge")]
    cases.append((sdr, sdr_flow, 16.0, 235.0, 2, False, 8))
    band_err, n_shards = 0, 0
    for srcs, fl, lo, hi, rs, is_hdr, n in cases:
        h = srcs[0].shape[0]
        for mode in (0, 1, 2):
            kw = dict(res_scalar=rs, mode=mode, is_hdr=is_hdr)
            full_y, full_uv = k2(*srcs, fl, t3, lo, hi, **kw)
            bands_y, bands_uv = [], []
            for shard in range(n):
                by, buv = k2_band(*srcs, fl, t3, lo, hi, num_shards=n, shard_index=shard, **kw)
                py, puv = wk.warp_frames_band_reference(*srcs, fl, t3, lo, hi, num_shards=n,
                                                        shard_index=shard, **kw)
                what = f"K2 band {h}p n {n} shard {shard} mode {mode}"
                band_err = max(band_err, require_equal(by, py, what + " Y"),
                               require_equal(buv, puv, what + " UV"))
                bands_y.append(by)
                bands_uv.append(buv)
                n_shards += 1
            require_equal(torch.cat(bands_y, 1)[:, :h], full_y, f"K2 bands {h}p n {n} Y")
            require_equal(torch.cat(bands_uv, 1)[:, :h // 2], full_uv, f"K2 bands {h}p n {n} UV")
    # Mode 3 at 4K HDR, n = 2: the band's raw_blend variant against its plain
    # version (each flow), and coloured by the banded overlay against the
    # plain row route (random flow).
    kw = dict(res_scalar=3, is_hdr=True)
    for shard in range(2):
        band = dict(num_shards=2, shard_index=shard)
        for flow_name, fl in flows.items():
            ry, ruv = k2_band(*src, fl, t3, black, white, mode=2, raw_blend=True, **band, **kw)
            py, puv = wk.warp_frames_band_reference(*src, fl, t3, black, white, mode=2,
                                                    raw_blend=True, **band, **kw)
            what = f"K2 band raw_blend 2160p {flow_name} n 2 shard {shard}"
            band_err = max(band_err, require_equal(ry, py, what + " Y"),
                           require_equal(ruv, puv, what + " UV"))
        ry, ruv = k2_band(*src, flow, t3, black, white, mode=2, raw_blend=True, **band, **kw)
        y, uv = port.warp_viz.hsv_flow_overlay(ry, ruv, flow, black, white, **kw,
                                               row_offsets=(shard * ry.shape[1],
                                                            shard * ruv.shape[1]))
        wy, wuv = port.warp_ops.warp_frame_rows(*src, flow, t3, black, white, mode=3, **band,
                                                **kw)
        require_equal(y, wy, f"mode 3 band 2160p n 2 shard {shard} Y")
        require_equal(uv, wuv, f"mode 3 band 2160p n 2 shard {shard} UV")
    torch.cuda.synchronize()
    band = band_numbers(port, src, flows, t3, black, white)
    log(f"phase 7a K2 band: {n_shards} shard calls (4K HDR P010 flow +-64 at n = 2, 4, 8; "
        f"smooth and mirror-edge flow at n = 2; 1080p SDR at n = 8), modes 0/1/2, t (0.2, "
        f"0.6, 1.0): each equal to its plain version, the shards stacked equal to the full K2; "
        f"mode 3 at 4K HDR n = 2: the raw_blend band equal to its plain version (each flow), "
        f"and with the banded HSV overlay equal to the plain row route; max |err| {band_err}")

    # -- 7b. batched_step: two 4K HDR streams panning 3 px/frame, radius 16,
    # three steps, against the single-stream path (pyramid_flow + K2) and
    # against itself on the plain versions.
    cfg = port.config
    n_frames, blend = 5, (0.6, 0.2)        # each stream's t: one of t3
    streams = []
    for seed in (1, 2):
        frame_rng = np.random.default_rng(seed)
        frames = [port.nv12.synthetic_frame(frame_rng, H, W, is_hdr=True, motion_x=3 * i)
                  for i in range(n_frames)]
        streams.append([(y & P010_MASK, uv & P010_MASK) for y, uv in frames])
    ys = torch.tensor(np.stack([[f[0] for f in s] for s in streams]), device=dev)
    uvs = torch.tensor(np.stack([[f[1] for f in s] for s in streams]), device=dev)
    scal = (cfg.MAX_SEARCH_RADIUS, cfg.DEFAULT_DELTA_SCALAR, cfg.DEFAULT_NEIGHBOR_SCALAR)
    kw = dict(low_h=LOW[1], low_w=LOW[2], res_scalar=3, is_hdr=True)
    blend_t = torch.tensor(blend, dtype=torch.float32, device=dev)
    zero_flow = torch.zeros(LOW, dtype=torch.int16, device=dev)

    def run_batched():
        flow_prev, outs = torch.stack([zero_flow] * 2), []
        for i in range(n_frames - 2):
            ring = [a[:, i + k].contiguous() for k in range(3) for a in (ys, uvs)]
            out = port.batched_step(*ring, flow_prev, *scal, blend_t, black, white, mode=2, **kw)
            flow_prev = out[2]
            outs.append(out)
        return outs

    reset_launches(k1, k2, k2_band)
    batched = run_batched()
    torch.cuda.synchronize()
    batched_launches = read_launches(k1, k2, k2_band)
    if min(batched_launches["blur_flow"], batched_launches["warp_frames"]) == 0:
        raise AssertionError(f"batched_step: a kernel never launched: {batched_launches}")
    # The single-stream path, with all three t of t3 (7c's t_batch).
    single = []   # single[b][i] = (y (3, H, W), uv, blurred, delta_raw)
    for b in range(2):
        flow_prev, steps = zero_flow, []
        for i in range(n_frames - 2):
            f0, f1, f2 = ((ys[b, i + k], uvs[b, i + k]) for k in range(3))
            _, blurred, delta = port.flow_ops.pyramid_flow(*f1, *f2, *scal, **kw)
            y, uv = k2(*f0, *f1, flow_prev, t3, black, white, res_scalar=3, mode=2, is_hdr=True)
            steps.append((y, uv, blurred, delta))
            flow_prev = blurred
        single.append(steps)
    for i, out in enumerate(batched):
        for b in range(2):
            y, uv, blurred, delta = single[b][i]
            ti = (0.2, 0.6, 1.0).index(blend[b])
            what = f"batched_step step {i} stream {b}"
            require_equal(out[0][b], y[ti], what + " Y")
            require_equal(out[1][b], uv[ti], what + " UV")
            require_equal(out[2][b], blurred, what + " flow")
            if int(out[3][b]) != int(delta):
                raise AssertionError(f"{what}: delta {int(out[3][b])} != {int(delta)}")
    if not any(int(single[b][-1][2].abs().max()) for b in range(2)):
        raise AssertionError("batched_step: the flow found no motion on a panning stream")
    with plain_versions(port):
        plain = run_batched()
    for i, (out, p_out) in enumerate(zip(batched, plain)):
        for a, b_, what in zip(out, p_out, ("Y", "UV", "flow", "delta")):
            require_equal(a, b_, f"batched_step step {i} {what} against the plain versions")
    log(f"phase 7b batched_step: 2 streams {W}x{H} HDR, radius 16, {n_frames - 2} steps, t "
        f"{blend}: outputs, flow and delta equal to the single-stream path and to the "
        f"plain-version run; launches {batched_launches}")

    # -- 7c. make_multichip_step on ranks of this card (gloo), rs 3, modes 2
    # and 3, t_batch 3: frames 1-4 of 7b's streams, the prior flow of 7b's
    # first step, two steps; the outputs against 7b's single-stream results
    # (mode 3: K2's raw_blend variant and the HSV overlay on the full frame).
    meshes = [(1, 2), (2, 1)]
    if torch.cuda.device_count() >= 4:
        meshes += [(1, 4), (2, 2)]        # NCCL, a rank per card
    mode3 = [[port.warp_viz.warp_outputs(ys[b, 1 + i], uvs[b, 1 + i], ys[b, 2 + i],
                                         uvs[b, 2 + i], single[b][i][2], t3, black, white,
                                         mode=3, res_scalar=3, is_hdr=True)
              for i in range(2)] for b in range(2)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh.")
    try:
        in_path = os.path.join(tmp, "streams.npz")
        np.savez(in_path, y=ys[:, 1:].cpu().numpy(), uv=uvs[:, 1:].cpu().numpy(),
                 flow=torch.stack([single[b][0][2] for b in range(2)]).cpu().numpy(),
                 ts=t3.cpu().numpy())
        jobs = [dict(in_path=in_path, mode=mode, res_scalar=3, radius=scal[0],
                     delta_scalar=scal[1], neighbor_scalar=scal[2], black=black, white=white)
                for mode in (2, 3)]
        mesh_launches, mesh_raw_launches, mesh_lines = 0, 0, []
        for dp, sp in meshes:
            for job in jobs:
                job["out_path"] = os.path.join(tmp, f"mesh{dp}x{sp}.mode{job['mode']}."
                                               + "{rank}.npz")
            start = time.perf_counter()
            rank_paths = launch.run_ranks(entry.run_stream_steps, dp, sp, device="cuda",
                                          workdir=tmp, args=(jobs,), timeout=600)
            wall = time.perf_counter() - start
            step_ms, backends = [], set()
            for rank, (path2, path3) in enumerate(rank_paths):
                with np.load(path2) as z2, np.load(path3) as z3:
                    # The counters of a rank run on: the mode-3 job's raw_blend
                    # launches are its own.
                    launched = (int(z2["band_launches"]), int(z3["band_raw_launches"]))
                    if min(launched) == 0 or z3["foreign_modules"].size:
                        raise AssertionError(f"mesh {dp}x{sp} rank {rank}: band launches "
                                             f"(mode 2, mode 3 raw_blend) {launched}, jax "
                                             f"modules {list(z3['foreign_modules'])}")
                    mesh_launches += launched[0]
                    mesh_raw_launches += launched[1]
                    step_ms.append(float(z2["step_ms"][-1]))
                    backends.add(str(z2["backend"]))
            for j, mode in enumerate((2, 3)):
                got = entry.gather_dp([p[j] for p in rank_paths], sp)
                for b in range(2):
                    for i in range(2):
                        y, uv, blurred, delta = single[b][i + 1]
                        if mode == 3:
                            y, uv = mode3[b][i]
                        what = f"mesh {dp}x{sp} mode {mode} stream {b} step {i}"
                        for g, want, name in ((got["y"][b, i], y, "Y"),
                                              (got["uv"][b, i], uv, "UV"),
                                              (got["blurred"][b, i], blurred, "flow")):
                            if not np.array_equal(g, want.cpu().numpy()):
                                raise AssertionError(f"{what}: {name} differs from 7b's "
                                                     "single-device result")
                        if int(got["delta"][b, i]) != int(delta):
                            raise AssertionError(f"{what}: delta differs")
            mesh_lines.append(f"{dp}x{sp} ({'/'.join(sorted(backends))}) {wall:.1f} s wall, "
                              f"second mode-2 step {statistics.median(step_ms):.3f} ms (median "
                              f"of {len(step_ms)} ranks, CUDA events)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 7c make_multichip_step {W}x{H} HDR rs 3 modes 2 and 3 t_batch 3, 2 streams x 2 "
        f"steps on meshes {meshes}: every rank's outputs, flow and delta equal to 7b's single-"
        f"device results byte for byte; K2 band launched {mesh_launches} times over the ranks "
        f"(mode 2), its raw_blend variant {mesh_raw_launches} times (mode 3); "
        + "; ".join(mesh_lines))
    log(f"phase 7 numbers [{card}]: K2 band (n 2, shard 0, mode 2, T = 3, {W}x{H} HDR) "
        f"graph-timed {band['ms']:.5f} ms (random +-64 flow), {band['smooth_ms']:.5f} ms "
        f"(smooth), host {band['host_us']:.1f} us/call, plain {band['plain_ms']:.4f} ms")
    bound_ms, bound_by = band_bound(src, flow, t3, 2, 0)
    return {"name": "warp_frames_band", "route": "cuda",
            "source": "hopperrender_tpu_torch/csrc/warp_frame.cu",
            "replaces": "hopperrender_tpu/ops/warp_band.py:695 (mesh-sharded variant)",
            "launches": mesh_launches, "max_abs_err": band_err, "ms": band["ms"],
            "smooth_ms": band["smooth_ms"], "host_us": band["host_us"],
            "plain_ms": band["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def u32_err(a: torch.Tensor, b: torch.Tensor, what: str) -> int:
    """max |a - b| of two uint32 tensors of one shape; raises where it is not 0."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    ai, bi = (t.view(torch.int32).long() & 0xFFFFFFFF for t in (a, b))
    err = int((ai - bi).abs().max())
    if err:
        raise AssertionError(f"{what}: {int((ai != bi).sum())} elements differ, max |err| {err}")
    return err


@contextlib.contextmanager
def recorded_band_reads(p1):
    """Points chain_probe.band_words, through which P1's and P2's plain
    versions read the band, at a recorder while the block runs: it marks
    every flat index read in the mask it yields and gives zeros."""
    seen = torch.zeros(p1.ROWS * p1.W32, dtype=torch.bool)

    class Reads:
        def __getitem__(self, flat):
            seen[flat.reshape(-1)] = True
            return torch.zeros_like(flat)

    band_words = p1.band_words
    p1.band_words = lambda band: Reads()
    try:
        yield seen
    finally:
        p1.band_words = band_words


def probe_work(port, name: str, variant: str, inputs: tuple, n: int,
               blocks: int) -> tuple[int, int]:
    """(bytes, operations) of one call of a probe variant on these CPU
    inputs: each distinct input word it reads, once, and its output; the
    operations of PROBE_OPS. P1/P2 (inputs tab, band[, res]; n iterations on
    `blocks` blocks): the band words the plain version reads (`full` counts
    its second word in every lane: an upper bound), the table fields it
    uses. P3/P4 (inputs idx): x is made of its own flat indices, so the
    plain version's output names the words read."""
    probes, (elem_ops, tile_ops) = port.probes, PROBE_OPS[name][variant]
    if name in ("chain_probe", "chain_probe2"):
        p1 = probes["chain_probe"]
        with recorded_band_reads(p1) as seen:
            probes[name].run_reference(variant, n, *inputs)
        fields = 1 if variant == "empty" else 3 if variant in ("smem_only", "full",
                                                               "full_aligned_rows") else 2
        reads_res = variant in ("vsel_x17", "fastpath_tile")
        moved = 4 * (int(seen.sum()) + fields * min(n, p1.T) + 1024 * (reads_res + blocks))
        if variant in ("full", "full_aligned_rows"):
            sub = inputs[0][1, torch.arange(n) & (p1.T - 1)].long() & 3
            ops = n * tile_ops + FULL_LANES * int((elem_ops + FULL_SECOND_WORD_OPS
                                                   * (sub != 0)).sum())
        else:
            ops = n * (tile_ops + 1024 * elem_ops)
        return moved, blocks * ops
    mod, (idx,) = probes[name], inputs
    pos = torch.arange(np.prod(mod.X_SHAPE), dtype=torch.int32).view(mod.X_SHAPE)
    if name == "gather_probe":
        read = mod.run_reference(variant, pos, idx)
        read = read[read != mod.FILL]
    else:
        read = mod.run_reference(variant, idx, pos)
    n_out = 1024 if name == "gather_probe" else 2048
    return 4 * (read.unique().numel() + n_out) + nbytes(idx), n_out * elem_ops + tile_ops


def probe_phase(port, dev, card: str) -> list[dict]:
    """Phase 8: the probes P1-P4 against their plain versions (8a), the probe
    path with the launch counters at 0 (8b), and the numbers (8c). Returns
    the four entries of the `kernels` line."""
    start = time.perf_counter()
    probes, probe_path = port.probes, port.probe_path
    p1, p2, p3, p4 = (probes[k] for k in ("chain_probe", "chain_probe2", "gather_probe",
                                      "mosaic_probe"))
    wrappers = {name: mod.run for name, mod in probes.items()}

    # -- 8a. parity. P1/P2: the script's inputs (seed 0) at n = 600, which
    # wraps the 512-entry table; every slot of 1 and of 132 blocks.
    errs = dict.fromkeys(probes, 0)
    variants = {"chain_probe": p1.VARIANTS, "chain_probe2": p2.KERNEL_VARIANTS,
                "gather_probe": p3.VARIANTS, "mosaic_probe": p4.VARIANTS}
    for name, names in variants.items():
        if set(PROBE_OPS[name]) != set(names):
            raise AssertionError(f"PROBE_OPS[{name!r}] does not count the variants {names}")
    p1_in, p2_in = p1.make_inputs(0, dev), p2.make_inputs(0, dev)
    for name, mod, inputs in (("chain_probe", p1, p1_in), ("chain_probe2", p2, p2_in)):
        for variant in variants[name]:
            want = mod.run_reference(variant, PROBE_N, *inputs)
            for blocks in PROBE_BLOCKS:
                got = mod.run(variant, PROBE_N, *inputs, blocks=blocks)
                errs[name] = max(errs[name], u32_err(
                    got, want.expand(blocks, -1, -1), f"{name} {variant} blocks {blocks}"))
    before = p2.run.launches
    try:
        p2.run("transpose8", 1, *p2_in)
        raise AssertionError("chain_probe2 transpose8 was not refused")
    except TypeError:
        if p2.run.launches != before:
            raise AssertionError("chain_probe2 transpose8 launched") from None
    # P3: the script's indices, and indices that wrap, fill or clamp; P4: the
    # script's offsets and offsets whose windows clamp or whose rolls wrap.
    x3, idx3 = p3.make_inputs(dev)
    edges = np.random.default_rng(8).integers(-263, 249, (8, 128)).astype(np.int32)
    edges[0, :12] = [0, 63, -1, -64, -65, 64, 248, 249, -7, -8, -263, 1000]
    for idx in (idx3, torch.from_numpy(edges).to(dev)):
        for variant in p3.VARIANTS:
            errs["gather_probe"] = max(errs["gather_probe"], require_equal(
                p3.run(variant, x3, idx), p3.run_reference(variant, x3, idx), f"P3 {variant}"))
    x4 = p4.make_inputs(device=dev)[1]
    for offsets in ((5, 128), (121, 255), (127, 256), (-1, -1), (-9, 1000), (17, 129)):
        idx4 = p4.make_inputs(offsets, dev)[0]
        for variant in p4.VARIANTS:
            errs["mosaic_probe"] = max(errs["mosaic_probe"], require_equal(
                p4.run(variant, idx4, x4), p4.run_reference(variant, idx4, x4),
                f"P4 {variant} idx {offsets}"))
    torch.cuda.synchronize()
    log(f"phase 8a probes: P1's {len(p1.VARIANTS)} and P2's "
        f"{len(p2.KERNEL_VARIANTS)} variants at n = {PROBE_N} on {PROBE_BLOCKS} blocks, "
        f"every slot, P3's 3 and P4's 7 kernels at clamping indices: each equal to its plain "
        f"version; transpose8 refused before a launch; max |err| {errs}")

    # -- 8b. the probe path, with every probe's counter at 0.
    hz = port.probe_path._timing.sm_clock_hz()
    for run in wrappers.values():
        run.launches = 0
    runs = [("chain", 1), ("chain", 132), ("chain2", 1), ("chain2", 132), ("gather", 1),
            ("mosaic", 1)]
    for probe, blocks in runs:
        results = probe_path.run_probe(probe, device=dev, blocks=blocks,
                                       echo=lambda line: log(f"phase 8b {probe} B={blocks}: "
                                                             f"{line}"))
        failed = [r.line for r in results if r.error and not r.expected_failure]
        if failed:
            raise AssertionError(f"the probe path failed: {failed}")
    launches = {name: run.launches for name, run in wrappers.items()}
    if min(launches.values()) == 0:
        raise AssertionError(f"a probe kernel never launched on the probe path: {launches}")
    clock = f"max SM clock {hz / 1e6:.0f} MHz" if hz else "max SM clock not read"
    log(f"phase 8b probe path [{card}, {clock}]: runs {runs}; launches {launches}")

    # -- 8c. numbers: each probe's variants, one call each, summed; against the
    # plain versions and, for P3/P4, one PyTorch call each. P1/P2 at n = 600
    # on 132 blocks.
    B = PROBE_BLOCKS[-1]
    idx3_long, idx3_lane = idx3.long(), (idx3 + 7).long()
    x3_128 = x3[:, :128]
    r0, lane = p4.IDX
    library = {   # the one-call counterpart of each P3/P4 kernel (the port never calls them)
        "take_along_sublane": lambda: torch.gather(x3_128, 0, idx3_long),
        "take_along_lane": lambda: torch.gather(x3[:8], 1, idx3_lane),
        "vector_index": lambda: torch.gather(x3_128, 0, idx3_long),
        "dyn_sublane": lambda: x4[r0:r0 + 8].contiguous(),
        "dyn_sublane_aligned": lambda: x4[r0 & ~7:(r0 & ~7) + 8].contiguous(),
        "dyn_lane_aligned": lambda: x4[:8, 0:256].contiguous(),
        "dyn_both": lambda: x4[r0:r0 + 8, 0:256].contiguous(),
        "dyn_roll_lane": lambda: torch.roll(x4[:8], r0, 1),
        "dyn_roll_sublane": lambda: torch.roll(x4[:16], r0, 0)[:8],
        "dyn_sublane_16": lambda: torch.roll(x4[r0 & ~7:(r0 & ~7) + 16], -(r0 & 7), 0)[:8],
    }
    idx4 = p4.make_inputs(device=dev)[0]
    calls = {
        "chain_probe": [(lambda v=v: p1.run(v, PROBE_N, *p1_in, blocks=B),
                         lambda v=v: p1.run_reference(v, PROBE_N, *p1_in, blocks=B), None)
                        for v in p1.VARIANTS],
        "chain_probe2": [(lambda v=v: p2.run(v, PROBE_N, *p2_in, blocks=B),
                          lambda v=v: p2.run_reference(v, PROBE_N, *p2_in, blocks=B), None)
                         for v in p2.KERNEL_VARIANTS],
        "gather_probe": [(lambda v=v: p3.run(v, x3, idx3),
                          lambda v=v: p3.run_reference(v, x3, idx3), library[v])
                         for v in p3.VARIANTS],
        "mosaic_probe": [(lambda v=v: p4.run(v, idx4, x4),
                          lambda v=v: p4.run_reference(v, idx4, x4), library[v])
                         for v in p4.VARIANTS],
    }
    # The bound of each entry: the sum of its variants' bounds, each the larger
    # of its bytes over the memory rate and its integer operations over the
    # int32 rate (probe_work).
    cpu_inputs = {"chain_probe": tuple(t.cpu() for t in p1_in),
                  "chain_probe2": tuple(t.cpu() for t in p2_in),
                  "gather_probe": (idx3.cpu(),), "mosaic_probe": (idx4.cpu(),)}
    sources = {"chain_probe": ("chain_probe.cu", "scripts/chain_probe.py:103"),
               "chain_probe2": ("chain_probe2.cu", "scripts/chain_probe2.py:113"),
               "gather_probe": ("gather_probe.cu", "scripts/gather_probe.py:40"),
               "mosaic_probe": ("mosaic_probe.cu", "scripts/mosaic_probe.py:14")}
    entries, numbers = [], []
    for name, per_variant in calls.items():
        ms = plain_ms = 0.0
        library_ms = None if per_variant[0][2] is None else 0.0
        for kernel, plain, lib_call in per_variant:
            k, p = time_pair(kernel, plain, 20, 2)
            ms, plain_ms = ms + k, plain_ms + p
            if lib_call is not None:
                library_ms += (time_ms(lib_call, 20) + time_ms(lib_call, 20)) / 2
        n_var = len(per_variant)
        by_kind = {"bytes": 0.0, "operations": 0.0}
        for variant in variants[name]:
            ms_v, by_v = roofline(*probe_work(port, name, variant, cpu_inputs[name], PROBE_N, B),
                                  INT32_OPS_PER_S)
            by_kind[by_v] += ms_v
        bound_ms = sum(by_kind.values())
        bound_by = max(by_kind, key=by_kind.get)
        src, replaces = sources[name]
        entries.append({"name": name, "route": "cuda",
                        "source": f"hopperrender_tpu_torch/csrc/{src}", "replaces": replaces,
                        "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms})
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        numbers.append(f"{name} ({n_var} variants) {ms:.4f} ms vs plain {plain_ms:.4f} ms, "
                       f"library {lib}, bound {bound_ms:.5f} ms ({bound_by})")
    log(f"phase 8c numbers [{card}]: one call of each variant, summed, CUDA events (P1/P2 at n "
        f"= {PROBE_N} on {B} blocks): " + "; ".join(numbers)
        + f"; phase 8 took {time.perf_counter() - start:.1f} s")
    return entries


def finish(port, kernels: list[dict], card: str, kind: str) -> int:
    """The last three lines: the kernels, nvidia-smi's card line, the result."""
    log(json.dumps({"kernels": kernels}))
    log(card)
    loaded = port.entry.foreign_modules()
    if loaded:
        raise AssertionError(f"the JAX package or jax was loaded: {sorted(loaded)[:5]}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parallel-only", action="store_true",
                        help="run phases 1, 2 and 7 only: the parallel path, e.g. on a host "
                             "with four cards, where 7c adds the NCCL meshes")
    parser.add_argument("--kernel-times", action="store_true",
                        help="run phases 1 and 2, then time the kernels only (phase 6's and "
                             "7a's kernel numbers), whichever hopperrender_tpu_torch sits beside "
                             "this script: a copy of it in an older tree times that tree's kernels")
    args = parser.parse_args(argv)
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
    k2_band = warp_kernel.warp_frames_band

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
    if args.parallel_only:
        return finish(port, [parallel_path(port, dev, card)], card, kind)
    if args.kernel_times:
        inp = k2_inputs(port, dev)
        numbers = kernel_numbers(port, inp)
        numbers["warp_frames_band"] = band_numbers(port, inp.src, inp.flows, inp.t3, inp.black,
                                                   inp.white)
        log(f"kernel times [{card}] of {ROOT}: {format_numbers(numbers)}")
        log(json.dumps(numbers))
        return 0

    # -- 3. K1 against its plain version ----------------------------------------
    inp = k2_inputs(port, dev)
    rng, offsets, src, flows = inp.rng, inp.offsets, inp.src, inp.flows
    black, white, t3 = inp.black, inp.white, inp.t3
    k1_err = 0
    minus3 = torch.full(LOW, -3, dtype=torch.int16, device=dev)
    odd = torch.tensor(rng.integers(-32768, 32768, (2, 33, 65)).astype(np.int16), device=dev)
    for x, what in ((offsets, "random +-500"), (minus3, "all -3"), (odd, "(2, 33, 65)")):
        k1_err = max(k1_err, require_equal(blur_kernel.blur_flow(x),
                                           blur_kernel.blur_flow_reference(x), f"K1 {what}"))
    torch.cuda.synchronize()
    log(f"phase 3 K1 blur_flow {LOW} int16: equal to the plain version (random +-500, "
        f"all -3; and (2, 33, 65), which its 16 x 32 tiles do not divide); max |err| {k1_err}")

    # -- 4. K2 against its plain version ----------------------------------------
    k2_err, n_checked = 0, 0
    for flow_name, flow in flows.items():
        for ts in ((0.4, 0.8), (0.2, 0.6, 1.0)):
            t = torch.tensor(ts, dtype=torch.float32, device=dev)
            for mode in (0, 1, 2):
                kw = dict(res_scalar=3, mode=mode, is_hdr=True)
                ky, kuv = warp_kernel.warp_frames(*src, flow, t, black, white, **kw)
                py, puv = warp_kernel.warp_frames_reference(*src, flow, t, black, white, **kw)
                what = f"K2 {flow_name} mode {mode} t {ts}"
                k2_err = max(k2_err, require_equal(ky, py, what + " Y"),
                             require_equal(kuv, puv, what + " UV"))
                n_checked += len(ts)
    torch.cuda.synchronize()
    log(f"phase 4 K2 warp_frames {W}x{H} P010, flow {', '.join(flows)}, modes 0/1/2, t "
        f"(0.4, 0.8) and (0.2, 0.6, 1.0): {n_checked} outputs equal to the plain version; "
        f"max |err| {k2_err}")

    # -- 4b. K2's raw_blend variant against its plain version ------------------
    raw_kw = dict(res_scalar=3, mode=2, is_hdr=True, raw_blend=True)
    raw_err = 0
    for flow_name, flow in flows.items():
        ky, kuv = warp_kernel.warp_frames(*src, flow, t3, black, white, **raw_kw)
        py, puv = warp_kernel.warp_frames_reference(*src, flow, t3, black, white, **raw_kw)
        raw_err = max(raw_err, require_equal(ky, py, f"K2 raw_blend {flow_name} Y"),
                      require_equal(kuv, puv, f"K2 raw_blend {flow_name} UV"))
    flow = flows["random +-64"]
    ky = warp_kernel.warp_frames(*src, flow, t3, black, white, **raw_kw)[0]
    levelled = warp_kernel.warp_frames(*src, flow, t3, black, white, res_scalar=3, mode=2,
                                       is_hdr=True)[0]
    if max_abs_err(levelled, ky) == 0:
        raise AssertionError("K2 raw_blend equals the levelled mode 2")
    torch.cuda.synchronize()
    log(f"phase 4b K2 raw_blend {W}x{H} P010, flow {', '.join(flows)}, t (0.2, 0.6, 1.0): Y "
        f"and UV equal to the plain version; max |err| {raw_err}")

    # -- 4c. the HSV colour on the card against the CPU ------------------------
    from hopperrender_tpu_torch.ops.warp import _visualize_flow
    v = torch.arange(-512, 513, dtype=torch.int16)
    ox, oy = (a.reshape(-1) for a in torch.meshgrid(v, v, indexing="xy"))
    n_colour = 0
    for is_hdr in (False, True):
        curr = torch.tensor(rng.integers(0, 65536 if is_hdr else 256, ox.shape[0]),
                            dtype=torch.int32)
        for impact in (1, 4):
            for channel in (0, 1, 2):
                chan = torch.full(ox.shape, channel, dtype=torch.int32)
                cpu = _visualize_flow(ox, oy, curr, chan, impact, is_hdr)
                gpu = _visualize_flow(ox.to(dev), oy.to(dev), curr.to(dev), chan.to(dev),
                                      impact, is_hdr)
                require_equal(gpu.cpu(), cpu, f"HSV colour hdr {is_hdr} res_impact {impact} "
                                              f"channel {channel}")
                n_colour += cpu.numel()
    log(f"phase 4c HSV colour: {n_colour} values (every (ox, oy) in +-512, SDR and HDR, "
        f"res_impact 1 and 4, channels 0/1/2) equal on the card and the CPU")

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
    reset_launches(k1, k2, k2_band)
    srv = new_server()
    outs, wall_s, flow_s, warp_s, copy_s = serve(srv, frames[:10])
    torch.cuda.synchronize()
    launches = read_launches(k1, k2, k2_band)
    peak_bytes = torch.cuda.max_memory_allocated(dev)

    expected = cadence_count(port, 10)
    n_interp = sum(o.interpolated for o in outs)
    if len(outs) != expected:
        raise AssertionError(f"served {len(outs)} outputs, the cadence gives {expected}")
    if n_interp == 0:
        raise AssertionError("no interpolated output")
    if min(launches["blur_flow"], launches["warp_frames"]) == 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    for o in outs:
        if o.y.shape != (H, W) or o.uv.shape != (H // 2, W) or o.y.dtype != np.uint16:
            raise AssertionError(f"output shape/dtype {o.y.shape} {o.uv.shape} {o.y.dtype}")
    if srv.metrics().search_radius != config.MAX_SEARCH_RADIUS:
        raise AssertionError(f"search radius {srv.metrics().search_radius}, not 16")

    with plain_versions(port):
        plain_outs = serve(new_server(), frames[:10])[0]
    if read_launches(k1, k2, k2_band) != launches:
        raise AssertionError("the plain-version stream launched a kernel")
    require_same_stream(outs, plain_outs, "mode 2")

    fixtures = [os.path.join(ROOT, "tests", "fixtures", f"golden_{n}.npz") for n in FIXTURES]
    missing = [p for p in fixtures if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(f"golden fixtures missing: {missing}")
    for path in fixtures:
        replay_fixture(path, dev)
    log(f"phase 5 served slice {W}x{H} HDR 24->60 mode 2 r16: {len(outs)} outputs "
        f"(cadence {expected}), {n_interp} interpolated, launches {launches}, all equal to the "
        f"plain-version stream; golden {', '.join(os.path.basename(p) for p in fixtures)} "
        f"replayed byte for byte")

    # -- 5b / 5c. served visualisation modes --------------------------------------
    # The kernels each mode's path runs (mode 4 needs the flow only).
    path_kernels = {3: ("blur_flow", "warp_frames_raw_blend"), 4: ("blur_flow",),
                    5: ("blur_flow", "warp_frames"), 6: ("blur_flow", "warp_frames")}
    viz_warp_ms, viz_launches = {}, {}
    for mode, n_frames in ((3, 10), (4, 6), (5, 6), (6, 6)):
        viz_settings = port.Settings(**{**settings, "frame_output": mode})

        def viz_server(st=viz_settings):
            return port.FrameServer(W, H, source_fps=24.0, is_hdr=True, device=dev, settings=st)

        reset_launches(k1, k2, k2_band)
        vouts, _, _, vwarp_s, _ = serve(viz_server(), frames[:n_frames])
        torch.cuda.synchronize()
        got = read_launches(k1, k2, k2_band)
        viz_launches[mode] = got
        missing = [k for k in path_kernels[mode] if got[k] == 0]
        if missing:
            raise AssertionError(f"mode {mode}: kernels of the path never launched: {missing} "
                                 f"({got})")
        expected = cadence_count(port, n_frames)
        if len(vouts) != expected or not any(o.interpolated for o in vouts):
            raise AssertionError(f"mode {mode}: {len(vouts)} outputs (cadence {expected}), "
                                 f"{sum(o.interpolated for o in vouts)} interpolated")
        with plain_versions(port):
            plain_vouts = serve(viz_server(), frames[:n_frames])[0]
        if read_launches(k1, k2, k2_band) != got:
            raise AssertionError(f"mode {mode}: the plain-version stream launched a kernel")
        require_same_stream(vouts, plain_vouts, f"mode {mode}")
        viz_warp_ms[mode] = 1e3 * statistics.median(vwarp_s)
        log(f"phase 5{'b' if mode == 3 else 'c'} served mode {mode} {W}x{H} HDR 24->60 r16: "
            f"{len(vouts)} outputs (cadence {expected}), "
            f"{sum(o.interpolated for o in vouts)} interpolated, launches {got}, all equal "
            f"to the plain-version stream")

    # -- 6. numbers ------------------------------------------------------------------
    numbers = kernel_numbers(port, inp)

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
        f"{len(warp_s)}, batched), copy {ms(copy_s):.3f} ms (median of {len(copy_s)}); peak memory "
        f"{peak_bytes / 2**20:.1f} MiB (served stream, max_memory_allocated); profiled "
        f"{N_PROFILED} more frames: wall {1e3 * per_frame(prof_wall):.3f} ms/source frame "
        f"under the profiler, device busy {1e3 * per_frame(busy_s):.3f} ms/source frame, idle "
        f"{100 * (1 - busy_s / prof_wall):.1f}%, {per_frame(n_events):.0f} device "
        f"events/source frame; device ms/source frame by kind: {by_kind}")
    log(f"phase 6 kernels [{card}] (graph-timed device ms per call, {LOW} flow, {W}x{H} HDR "
        f"T = 3 unless marked, random +-64 flow unless marked): {format_numbers(numbers)}")
    log(f"phase 6 numbers [{card}]: warp ms/output (median, CUDA events, one warp per "
        f"output) " + ", ".join(f"mode {m} {t:.3f}" for m, t in viz_warp_ms.items()))

    # -- 7. the parallel path -----------------------------------------------------
    band_entry = parallel_path(port, dev, card)

    # -- 8. the probes ------------------------------------------------------------
    probe_entries = probe_phase(port, dev, card)

    # Bounds from this run's inputs: K1 reads and writes one (2, 270, 480) int16
    # flow; K2 reads both source frames and the flow once and writes T outputs.
    k2_out = 3 * nbytes(src[0], src[1])
    k2_bytes = nbytes(*src, flow, t3) + k2_out
    k2_elems = 3 * (src[0].numel() + src[1].numel())
    bounds = {"blur_flow": bound("blur_flow", 2 * nbytes(offsets), offsets.numel()),
              "warp_frames": bound("warp_frames", k2_bytes, k2_elems),
              "warp_frames_raw_blend": bound("warp_frames_raw_blend", k2_bytes, k2_elems)}

    # library_ms is null: no single PyTorch call computes any of these functions
    # (grid_sample has neither the clamped remapping mirror nor C rounding;
    # avg_pool2d neither the symmetric mirror nor the truncating division).
    # ms is the graph-timed device time on random flow (K1: random +-500),
    # smooth_ms on the smooth flow.
    kernels = [
        {"name": "blur_flow", "route": "cuda",
         "source": "hopperrender_tpu_torch/csrc/blur_flow.cu",
         "replaces": "hopperrender_tpu/ops/pallas_kernels.py:63",
         "launches": launches["blur_flow"], "max_abs_err": k1_err},
        {"name": "warp_frames", "route": "cuda",
         "source": "hopperrender_tpu_torch/csrc/warp_frame.cu",
         "replaces": "hopperrender_tpu/ops/warp_band.py:695",
         "launches": launches["warp_frames"], "max_abs_err": k2_err},
        {"name": "warp_frames_raw_blend", "route": "cuda",
         "source": "hopperrender_tpu_torch/csrc/warp_frame.cu",
         "replaces": "hopperrender_tpu/ops/warp_band.py:695 (variant raw_blend)",
         "launches": viz_launches[3]["warp_frames_raw_blend"], "max_abs_err": raw_err},
    ]
    for k in kernels:
        v = numbers[k["name"]]
        k["ms"], k["smooth_ms"], k["plain_ms"] = v["ms"], v["smooth_ms"], v["plain_ms"]
        k["bound_ms"], k["bound_by"] = bounds[k["name"]]
        k["library_ms"] = None
        k["host_us"] = v["host_us"]
    return finish(port, kernels + [band_entry] + probe_entries, card, kind)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
