"""Entry points of the port's parallel path.

PyTorch counterparts of __graft_entry__.py:

entry(device)               -> (fn, example_args): the single-stream step of
                               parallel/batched.py at 1080p SDR (flow on the
                               newest pair, warp of the previous pair with the
                               prior flow: the 1-pair pipeline).
dryrun_multichip(n, device) -> factors n ranks into a dp x sp mesh, runs ONE
                               step of parallel/mesh.make_multichip_step at two
                               small geometries through launch.run_ranks, and
                               checks the output shapes.

run_stream_steps(mesh, jobs) is the rank function behind both the dryrun and
chip_smoke.py's phase 7: it reads streams from an .npz, runs the mesh step
over them and writes this rank's outputs to an .npz.
"""

from __future__ import annotations

import functools
import os
import sys
import tempfile
import time

import numpy as np
import torch

from hopperrender_tpu_torch import config
from hopperrender_tpu_torch.ops import warp_kernel
from hopperrender_tpu_torch.parallel import launch
from hopperrender_tpu_torch.parallel.batched import batched_step
from hopperrender_tpu_torch.parallel.mesh import make_multichip_step


def example_frames(h: int, w: int, low_h: int, low_w: int, *, batch: int):
    """Three random SDR frames per stream and a random prior flow, from seed
    0, as __graft_entry__ makes them: y (batch, 3, h, w) and uv (batch, 3,
    h/2, w) uint8, flow (batch, 2, low_h, low_w) int16 in [-8, 8]."""
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (batch, 3, h, w), dtype=np.uint8)
    uv = rng.integers(0, 256, (batch, 3, h // 2, w), dtype=np.uint8)
    flow = rng.integers(-8, 9, (batch, 2, low_h, low_w)).astype(np.int16)
    return y, uv, flow


def entry(device: str | torch.device = "cuda"):
    """The single-stream step (batched_step with B = 1) at 1080p SDR, mode 2,
    with example arguments on `device`."""
    h, w = 1080, 1920
    rs, low_h, low_w = config.calc_flow_dims(h, w, config.MAX_CALC_RES)
    y, uv, flow = example_frames(h, w, low_h, low_w, batch=1)
    dev = torch.device(device)
    frames = [torch.tensor(a[:, i], device=dev) for i in range(3) for a in (y, uv)]
    fn = functools.partial(batched_step, low_h=low_h, low_w=low_w, res_scalar=rs, mode=2,
                           is_hdr=False)
    example_args = (*frames, torch.tensor(flow, device=dev), config.MIN_SEARCH_RADIUS,
                    config.DEFAULT_DELTA_SCALAR, config.DEFAULT_NEIGHBOR_SCALAR,
                    torch.tensor([0.4], dtype=torch.float32, device=dev), 0.0, 255.0)
    return fn, example_args


def _elapsed_ms(device: torch.device, fn):
    """fn's result and its time in ms: CUDA events on a card, the host clock on
    the CPU."""
    if device.type != "cuda":
        start = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - start)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def foreign_modules() -> list[str]:
    """The modules of jax or of the JAX package loaded in this process: none,
    in any process of the port."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "hopperrender_tpu"))


def run_stream_steps(mesh, jobs: list[dict]) -> list[str]:
    """Rank function for launch.run_ranks. Each job names an .npz of streams
    (`in_path`: y (B, F, H, W) and uv (B, F, H/2, W) uint8 or uint16, flow
    (B, 2, low_h, low_w) int16, the first step's prior flow, and ts, the
    blending scalars), an output path pattern with "{rank}" (`out_path`) and
    the step's settings (mode, res_scalar, radius, delta_scalar,
    neighbor_scalar, black, white). This rank takes its dp row's share of the
    B streams and runs F - 2 steps (frames i, i+1, i+2 of each stream, each
    step warping with the previous step's flow). It writes y (B_local, F-2,
    [T,] H, W), uv, blurred (B_local, F-2, 2, low_h, low_w), delta (B_local,
    F-2), each step's ms, warp_frames_band.launches, the rank's place and
    backend, and foreign_modules(); returns the paths."""
    paths = []
    for job in jobs:
        with np.load(job["in_path"]) as z:
            y, uv, flow, ts = z["y"], z["uv"], z["flow"], z["ts"]
        n_streams, n_frames, h, w = y.shape
        if n_streams % mesh.dp or n_frames < 3:
            raise ValueError(f"{n_streams} streams of {n_frames} frames do not split into "
                             f"dp = {mesh.dp} rows of steps")
        local = slice(mesh.dp_index * (n_streams // mesh.dp),
                      (mesh.dp_index + 1) * (n_streams // mesh.dp))
        dev = mesh.device
        y, uv = torch.tensor(y[local], device=dev), torch.tensor(uv[local], device=dev)
        flow_prev = torch.tensor(flow[local], device=dev)
        t_batch = len(ts)
        step = make_multichip_step(mesh, h, w, low_h=flow.shape[2], low_w=flow.shape[3],
                                   res_scalar=job["res_scalar"], is_hdr=y.dtype == torch.uint16,
                                   mode=job["mode"], t_batch=t_batch)
        t = ts if t_batch > 1 else float(ts[0])
        outs, step_ms = [], []
        for i in range(n_frames - 2):
            ring = [a[:, i + k].contiguous() for k in range(3) for a in (y, uv)]
            out, ms = _elapsed_ms(dev, lambda: step(
                *ring, flow_prev, job["radius"], job["delta_scalar"], job["neighbor_scalar"],
                t, job["black"], job["white"]))
            flow_prev = out[2]
            outs.append([o.cpu().numpy() for o in out])
            step_ms.append(ms)
        y_o, uv_o, blurred, delta = (np.stack(parts, axis=1) for parts in zip(*outs))
        path = job["out_path"].format(rank=mesh.rank)
        np.savez(path, y=y_o, uv=uv_o, blurred=blurred, delta=delta,
                 step_ms=np.asarray(step_ms), band_launches=warp_kernel.warp_frames_band.launches,
                 dp_index=mesh.dp_index, sp_index=mesh.sp_index, backend=mesh.backend,
                 foreign_modules=np.asarray(foreign_modules(), dtype=str))
        paths.append(path)
    return paths


def gather_dp(paths: list[str], sp: int) -> dict[str, np.ndarray]:
    """The whole batch from the per-rank outputs of one job: the dp rows'
    streams in order, from each row's sp rank 0."""
    rows = []
    for path in paths[::sp]:
        with np.load(path) as z:
            rows.append({k: z[k] for k in ("y", "uv", "blurred", "delta")})
    return {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}


def factor_mesh(n_devices: int) -> tuple[int, int]:
    """(dp, sp) for n ranks: sp the largest of 8, 4, 2 that divides n (flow
    splits 16 layers, so sp divides 16), dp the rest."""
    sp = next((c for c in (8, 4, 2) if n_devices % c == 0), 1)
    return n_devices // sp, sp


def dryrun_multichip(n_devices: int, *, device: str | torch.device = "cuda",
                     workdir: str | None = None) -> dict[str, dict[str, tuple]]:
    """One step of the mesh on n_devices ranks at two small SDR geometries:
    32x64 at res_scalar 1, and 64x128 at res_scalar 2 with three blending
    scalars. Checks the shapes __graft_entry__.dryrun_multichip checks;
    returns them by geometry."""
    dp, sp = factor_mesh(n_devices)
    geometries = {"rs1": (32, 64, 1, (0.4,)), "rs2_t3": (64, 128, 2, (0.25, 0.5, 0.75))}
    shapes = {}
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        jobs = []
        for name, (h, w, rs, ts) in geometries.items():
            y, uv, flow = example_frames(h, w, h >> rs, w >> rs, batch=dp)
            in_path = os.path.join(tmp, f"{name}.npz")
            np.savez(in_path, y=y, uv=uv, flow=flow, ts=np.asarray(ts, np.float32))
            jobs.append(dict(in_path=in_path, out_path=os.path.join(tmp, name + ".{rank}.npz"),
                             mode=2, res_scalar=rs, radius=9, delta_scalar=8,
                             neighbor_scalar=6, black=0.0, white=255.0))
        paths = launch.run_ranks(run_stream_steps, dp, sp, device=device, workdir=tmp,
                                 args=(jobs,))
        for j, (name, (h, w, rs, ts)) in enumerate(geometries.items()):
            out = gather_dp([p[j] for p in paths], sp)
            t_axis = (len(ts),) if len(ts) > 1 else ()
            want = {"y": (dp, 1, *t_axis, h, w), "uv": (dp, 1, *t_axis, h // 2, w),
                    "blurred": (dp, 1, 2, h >> rs, w >> rs), "delta": (dp, 1)}
            got = {k: out[k].shape for k in want}
            if got != want:
                raise AssertionError(f"dryrun {name}: shapes {got}, expected {want}")
            shapes[name] = got
    return shapes
