#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hopperrender_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                   # from the repository root; needs one CUDA card
    python3 chip_smoke.py --parallel-only   # phases 1, 2 and 7; on four cards, 7c
                                            # adds meshes of a rank per card (NCCL)

Builds the hand-written CUDA kernels from hopperrender_tpu_torch/csrc (nvcc,
sm_90a), then runs these phases, one line each:

  1. the device: torch's name for it and nvidia-smi's name and power limit;
  2. the build: nvcc's time and the library's path;
  3. K1 (flow blur) against its plain PyTorch version at the 4K flow grid
     (2, 270, 480), exact;
  4. K2 (batched warp) against its plain version at 4K HDR P010, flow +-64,
     t = (0.4, 0.8) and (0.2, 0.6, 1.0), levels 16/235, modes 0/1/2, exact;
     4b. K2's raw_blend variant (mode 2 without levels) against its plain
     version, same sources, t = (0.2, 0.6, 1.0), exact;
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
     time, each kernel's time against its plain version's, peak memory, and
     a torch.profiler pass over three more served frames: device busy time,
     idle share and launches per source frame, and device time by kind;
     the warp time per output of modes 3-6 (CUDA events) from 5b/5c;
  7. the parallel path:
     7a. K2's mesh-sharded variant (warp_frames_band) against its plain
     version for every shard, and the shards stacked against the full K2:
     4K HDR P010, flow +-64, t (0.2, 0.6, 1.0), modes 0/1/2, levels 16/235,
     n = 2, 4, 8; and 1080p SDR at n = 8, where UV's rows split unevenly;
     7b. batched_step on two 4K HDR streams (panning 3 px/frame, radius 16,
     three steps): outputs, flow and delta against the single-stream path
     (pyramid_flow + K2), and against the same run on the plain versions;
     7c. make_multichip_step through launch.run_ranks at 4K HDR, rs 3, mode 2,
     t_batch 3, on meshes (1, 2) and (2, 1) of ranks sharing this card over
     gloo (and (1, 4), (2, 2) over NCCL where four cards are visible): each
     rank writes its outputs to an .npz, held byte for byte to 7b's
     single-device results; every rank must have launched the band kernel.
     Its numbers: each mesh's second step (CUDA events in the ranks) and the
     band kernel against its plain version.

Before each served path every launch counter is set to 0, and after it each
kernel of that path must have launched (the ranks of 7c start at 0). Then one JSON line of the kernels
(with each one's bound: the least time the card could take for its work),
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
# output written once) over the memory rate and its operations over the
# float32 CUDA-core rate, from the H100 SXM data sheet.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# Arithmetic operations per output element, integer and float alike: K1's
# separable 8x8 box sum (7 + 7 adds) and its truncating division; K2's flow
# lookup and back-projection (~10), two warped positions (~16 each: product,
# round, mirror, clamp, index), the blend (~4) and, for mode 2, the levels
# (~4). The raw_blend variant has no levels.
OPS_PER_ELEMENT = {"blur_flow": 16, "warp_frames": 50, "warp_frames_raw_blend": 46,
                   "warp_frames_band": 50}


def log(line: str) -> None:
    print(line, flush=True)


def import_port() -> types.SimpleNamespace:
    """Everything the run uses, imported from hopperrender_tpu_torch only."""
    from hopperrender_tpu_torch import _build, config, entry
    from hopperrender_tpu_torch.config import Settings
    from hopperrender_tpu_torch.ops import blur_kernel, warp_kernel
    from hopperrender_tpu_torch.ops import flow as flow_ops
    from hopperrender_tpu_torch.parallel import launch
    from hopperrender_tpu_torch.parallel.batched import batched_step
    from hopperrender_tpu_torch.server.control import CadenceController
    from hopperrender_tpu_torch.server.frame_server import FrameServer
    from hopperrender_tpu_torch.vio import nv12
    return types.SimpleNamespace(
        _build=_build, blur_kernel=blur_kernel, warp_kernel=warp_kernel,
        CadenceController=CadenceController, FrameServer=FrameServer, Settings=Settings,
        config=config, nv12=nv12, entry=entry, flow_ops=flow_ops, launch=launch,
        batched_step=batched_step)


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


def bound(name: str, bytes_moved: int, n_elements: int) -> tuple[float, str]:
    """(bound_ms, bound_by) of a kernel call that moves bytes_moved and
    computes n_elements output elements."""
    bytes_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S
    ops_ms = 1e3 * n_elements * OPS_PER_ELEMENT[name] / OPS_PER_S
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


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
    # 8) and 1080p SDR (n = 8: UV's 540 rows split into 68-row bands, the
    # last one 64).
    rng = np.random.default_rng(7)
    src = [torch.tensor(rng.integers(0, 1024, shape, dtype=np.uint16) << 6, device=dev)
           for shape in ((H, W), (H // 2, W)) * 2]
    flow = torch.tensor(rng.integers(-64, 65, LOW).astype(np.int16), device=dev)
    t3 = torch.tensor((0.2, 0.6, 1.0), dtype=torch.float32, device=dev)
    black, white = 16 * 256.0, 235 * 256.0
    sdr = [torch.tensor(rng.integers(0, 256, shape, dtype=np.uint8), device=dev)
           for shape in ((1080, 1920), (540, 1920)) * 2]
    sdr_flow = torch.tensor(rng.integers(-64, 65, (2, 270, 480)).astype(np.int16), device=dev)
    cases = [(src, flow, black, white, 3, True, n) for n in (2, 4, 8)]
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
    torch.cuda.synchronize()
    band_ms, band_plain_ms = time_pair(
        lambda: k2_band(*src, flow, t3, black, white, res_scalar=3, mode=2, is_hdr=True,
                        num_shards=2, shard_index=0),
        lambda: wk.warp_frames_band_reference(*src, flow, t3, black, white, res_scalar=3,
                                              mode=2, is_hdr=True, num_shards=2, shard_index=0),
        50, 3)
    log(f"phase 7a K2 band: {n_shards} shard calls (4K HDR P010 flow +-64 at n = 2, 4, 8; "
        f"1080p SDR at n = 8), modes 0/1/2, t (0.2, 0.6, 1.0): each equal to its plain "
        f"version, the shards stacked equal to the full K2; max |err| {band_err}")

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

    # -- 7c. make_multichip_step on ranks of this card (gloo), rs 3, mode 2,
    # t_batch 3: frames 1-4 of 7b's streams, the prior flow of 7b's first
    # step, two steps; the outputs against 7b's single-stream results.
    meshes = [(1, 2), (2, 1)]
    if torch.cuda.device_count() >= 4:
        meshes += [(1, 4), (2, 2)]        # NCCL, a rank per card
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh.")
    try:
        in_path = os.path.join(tmp, "streams.npz")
        np.savez(in_path, y=ys[:, 1:].cpu().numpy(), uv=uvs[:, 1:].cpu().numpy(),
                 flow=torch.stack([single[b][0][2] for b in range(2)]).cpu().numpy(),
                 ts=t3.cpu().numpy())
        job = dict(in_path=in_path, mode=2, res_scalar=3, radius=scal[0],
                   delta_scalar=scal[1], neighbor_scalar=scal[2], black=black, white=white)
        mesh_launches, mesh_lines = 0, []
        for dp, sp in meshes:
            job["out_path"] = os.path.join(tmp, f"mesh{dp}x{sp}." + "{rank}.npz")
            start = time.perf_counter()
            paths = [p for (p,) in launch.run_ranks(entry.run_stream_steps, dp, sp,
                                                    device="cuda", workdir=tmp, args=([job],),
                                                    timeout=600)]
            wall = time.perf_counter() - start
            step_ms, backends = [], set()
            for rank, path in enumerate(paths):
                with np.load(path) as z:
                    if int(z["band_launches"]) == 0 or z["foreign_modules"].size:
                        raise AssertionError(f"mesh {dp}x{sp} rank {rank}: band launches "
                                             f"{int(z['band_launches'])}, jax modules "
                                             f"{list(z['foreign_modules'])}")
                    mesh_launches += int(z["band_launches"])
                    step_ms.append(float(z["step_ms"][-1]))
                    backends.add(str(z["backend"]))
            got = entry.gather_dp(paths, sp)
            for b in range(2):
                for i in range(2):
                    y, uv, blurred, delta = single[b][i + 1]
                    what = f"mesh {dp}x{sp} stream {b} step {i}"
                    for g, want, name in ((got["y"][b, i], y, "Y"), (got["uv"][b, i], uv, "UV"),
                                          (got["blurred"][b, i], blurred, "flow")):
                        if not np.array_equal(g, want.cpu().numpy()):
                            raise AssertionError(f"{what}: {name} differs from 7b's single-"
                                                 "device result")
                    if int(got["delta"][b, i]) != int(delta):
                        raise AssertionError(f"{what}: delta differs")
            mesh_lines.append(f"{dp}x{sp} ({'/'.join(sorted(backends))}) {wall:.1f} s wall, "
                              f"second step {statistics.median(step_ms):.3f} ms (median of "
                              f"{len(step_ms)} ranks, CUDA events)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 7c make_multichip_step {W}x{H} HDR rs 3 mode 2 t_batch 3, 2 streams x 2 steps "
        f"on meshes {meshes}: every rank's outputs, flow and delta equal to 7b's single-device "
        f"results byte for byte; K2 band launched {mesh_launches} times over the ranks; "
        + "; ".join(mesh_lines))
    log(f"phase 7 numbers [{card}]: K2 band (n 2, shard 0) {band_ms:.4f} ms vs plain "
        f"{band_plain_ms:.4f} ms per T=3 mode-2 call at {W}x{H} HDR")
    bound_ms, bound_by = band_bound(src, flow, t3, 2, 0)
    return {"name": "warp_frames_band", "route": "cuda",
            "source": "hopperrender_tpu_torch/csrc/warp_frame.cu",
            "replaces": "hopperrender_tpu/ops/warp_band.py:695 (mesh-sharded variant)",
            "launches": mesh_launches, "max_abs_err": band_err, "ms": band_ms,
            "plain_ms": band_plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


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

    # -- 4b. K2's raw_blend variant against its plain version ------------------
    t3 = torch.tensor((0.2, 0.6, 1.0), dtype=torch.float32, device=dev)
    raw_kw = dict(res_scalar=3, mode=2, is_hdr=True, raw_blend=True)
    ky, kuv = warp_kernel.warp_frames(*src, flow, t3, black, white, **raw_kw)
    py, puv = warp_kernel.warp_frames_reference(*src, flow, t3, black, white, **raw_kw)
    raw_err = max(require_equal(ky, py, "K2 raw_blend Y"),
                  require_equal(kuv, puv, "K2 raw_blend UV"))
    levelled = warp_kernel.warp_frames(*src, flow, t3, black, white, res_scalar=3, mode=2,
                                       is_hdr=True)[0]
    if max_abs_err(levelled, ky) == 0:
        raise AssertionError("K2 raw_blend equals the levelled mode 2")
    torch.cuda.synchronize()
    log(f"phase 4b K2 raw_blend {W}x{H} P010, flow +-64, t (0.2, 0.6, 1.0): Y and UV equal to "
        f"the plain version; max |err| {raw_err}")

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
    k1_ms, k1_plain_ms = time_pair(lambda: k1(offsets),
                                   lambda: blur_kernel.blur_flow_reference(offsets), 200, 50)
    kw = dict(res_scalar=3, mode=2, is_hdr=True)
    k2_ms, k2_plain_ms = time_pair(
        lambda: k2(*src, flow, t3, black, white, **kw),
        lambda: warp_kernel.warp_frames_reference(*src, flow, t3, black, white, **kw), 50, 3)
    raw_ms, raw_plain_ms = time_pair(
        lambda: k2(*src, flow, t3, black, white, **raw_kw),
        lambda: warp_kernel.warp_frames_reference(*src, flow, t3, black, white, **raw_kw), 50, 3)

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
    log(f"phase 6 numbers [{card}]: K2 raw_blend {raw_ms:.4f} ms vs plain {raw_plain_ms:.4f} ms "
        f"per T=3 call at {W}x{H} HDR; warp ms/output (median, CUDA events, one warp per "
        f"output) " + ", ".join(f"mode {m} {t:.3f}" for m, t in viz_warp_ms.items()))

    # -- 7. the parallel path -----------------------------------------------------
    band_entry = parallel_path(port, dev, card)

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
        {"name": "warp_frames_raw_blend", "route": "cuda",
         "source": "hopperrender_tpu_torch/csrc/warp_frame.cu",
         "replaces": "hopperrender_tpu/ops/warp_band.py:695 (variant raw_blend)",
         "launches": viz_launches[3]["warp_frames_raw_blend"], "max_abs_err": raw_err,
         "ms": raw_ms, "plain_ms": raw_plain_ms},
    ]
    for k in kernels:
        k["bound_ms"], k["bound_by"] = bounds[k["name"]]
        k["library_ms"] = None
    return finish(port, kernels + [band_entry], card, kind)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
