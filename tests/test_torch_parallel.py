"""The port's parallel path against the JAX package's, on the CPU:
the layer-sharded cost volume (delta_window_sums with layer_offset), the
row-sharded warp (warp_frame_plane with row_offset/out_rows), the plain
version of K2's mesh-sharded variant, the bands of modes 3-6 composed from
it, batched_step, and make_multichip_step on gloo ranks (launch.run_ranks)
against JAX's make_multichip_step on the 8-device virtual CPU mesh of
tests/conftest.py.

Tolerances: exact everywhere, except the mode-2 output against the JAX mesh
step, which may differ by 1 LSB. That step warps through the JAX package's
strip formulation, and the JAX package itself allows 1 LSB between its warp
routes on the float blend (tests/test_parallel.py:166-171, 328-334); against
the jitted reference warp (hopperrender_tpu.ops.warp.warp_frame) the port's
mode 2 is exact.
"""

import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from hopperrender_tpu.ops import flow as jax_flow
from hopperrender_tpu.ops import warp as jax_warp
from hopperrender_tpu.parallel.batched import batched_step as jax_batched_step
from hopperrender_tpu.parallel.mesh import make_multichip_step as jax_multichip_step
from hopperrender_tpu_torch import entry
from hopperrender_tpu_torch.ops import flow as torch_flow
from hopperrender_tpu_torch.ops import warp as torch_warp
from hopperrender_tpu_torch.ops import warp_kernel, warp_viz
from hopperrender_tpu_torch.parallel import launch
from hopperrender_tpu_torch.parallel.batched import batched_step

from conftest import make_flow, make_frame
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _levels(is_hdr):
    s = 256.0 if is_hdr else 1.0
    return 16.0 * s, 235.0 * s


@pytest.mark.parametrize("is_hdr,step,iteration", [(False, 0, 4), (True, 1, 0)])
def test_layer_offset_slices_tile_and_match_jax(rng, is_hdr, step, iteration):
    """Sharded layer ranges tile the full cost volume, and each equals JAX's
    delta_window_sums(layer_offset=...) exactly (test_parallel.py:260-273)."""
    h, w, low_h, low_w = 32, 64, 16, 32
    frames = make_frame(rng, h, w, is_hdr) + make_frame(rng, h, w, is_hdr)
    offsets = make_flow(rng, low_h, low_w, max_mag=4)
    kw = dict(window_size=4, res_scalar=1, iteration=iteration, step=step, is_hdr=is_hdr)
    args = (*map(_t, frames), _t(offsets), 11, 8, 6)
    full = torch_flow.delta_window_sums(*args, **kw)
    parts = []
    for off in range(0, 16, 4):
        part = torch_flow.delta_window_sums(*args, num_layers=4, layer_offset=off, **kw)
        want = jax_flow.delta_window_sums(
            *map(jnp.asarray, frames), jnp.asarray(offsets), jnp.int32(11), jnp.int32(8),
            jnp.int32(6), jnp.int32(off), num_layers=4, **kw)
        np.testing.assert_array_equal(part.numpy(), np.asarray(want).astype(np.int64))
        parts.append(part)
    assert torch.equal(torch.cat(parts), full)


@pytest.mark.parametrize("is_hdr", [False, True])
def test_row_offset_bands_tile_and_match_jax(rng, is_hdr):
    """warp_frame_plane's row bands tile the full plane and each equals
    JAX's band exactly, modes 0-6, both planes (test_parallel.py:243-257)."""
    h, w, rs = 32, 64, 1
    y1, uv1 = make_frame(rng, h, w, is_hdr)
    y2, uv2 = make_frame(rng, h, w, is_hdr)
    flow = make_flow(rng, h >> rs, w >> rs, max_mag=12)
    black, white = _levels(is_hdr)
    srcs = (y1, uv1, y2, uv2, flow)
    for mode in range(7):
        kw = dict(res_scalar=rs, mode=mode, is_hdr=is_hdr)
        for cz, rows in ((0, 8), (1, 4)):
            full = torch_warp.warp_frame_plane(*map(_t, srcs), 0.375, black, white, cz=cz, **kw)
            bands = []
            for r in range(0, h >> cz, rows):
                band = torch_warp.warp_frame_plane(*map(_t, srcs), 0.375, black, white, cz=cz,
                                                   row_offset=r, out_rows=rows, **kw)
                want = jax_warp.warp_frame_plane(
                    *map(jnp.asarray, srcs), jnp.float32(0.375), jnp.float32(black),
                    jnp.float32(white), jnp.int32(r), cz=cz, out_rows=rows, **kw)
                np.testing.assert_array_equal(band.numpy(), np.asarray(want),
                                              err_msg=f"mode {mode} cz {cz} row {r}")
                bands.append(band)
            assert torch.equal(torch.cat(bands), full), f"mode {mode} cz {cz}"


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("is_hdr", [False, True])
def test_band_reference_stacks_to_the_full_warp(rng, n, is_hdr):
    """The plain version of K2's mesh-sharded variant: n shards' bands,
    stacked and cropped, equal the full warp_frames_reference, modes 0/1/2,
    scalar and (T,) t. 50 rows (UV 25) split unevenly for every n, and at
    n = 8 the last UV shard lies wholly past the plane (all zero). On CPU
    tensors the wrapper takes the plain version and counts no launch; a mode
    outside 0-6 is refused."""
    h, w, rs = 50, 96, 2
    srcs = make_frame(rng, h, w, is_hdr) + make_frame(rng, h, w, is_hdr)
    flow = make_flow(rng, -(-h >> rs), w >> rs, max_mag=30)
    args = (*map(_t, srcs), _t(flow))
    black, white = _levels(is_hdr)
    launches = warp_kernel.warp_frames_band.launches
    for mode in (0, 1, 2):
        for ts in ((0.6,), (0.2, 0.6, 1.0)):
            ts = torch.tensor(ts, dtype=torch.float32)
            kw = dict(res_scalar=rs, mode=mode, is_hdr=is_hdr)
            want_y, want_uv = warp_kernel.warp_frames_reference(*args, ts, black, white, **kw)
            bands = [warp_kernel.warp_frames_band(*args, ts, black, white, num_shards=n,
                                                  shard_index=s, **kw) for s in range(n)]
            r_y, r_uv = -(-h // n), -(-(h // 2) // n)
            assert all(b[0].shape == (len(ts), r_y, w) and b[1].shape == (len(ts), r_uv, w)
                       for b in bands)
            got_y = torch.cat([b[0] for b in bands], 1)
            got_uv = torch.cat([b[1] for b in bands], 1)
            assert torch.equal(got_y[:, :h], want_y) and torch.equal(got_uv[:, :h // 2], want_uv)
            assert not got_y[:, h:].any() and not got_uv[:, h // 2:].any()
    assert warp_kernel.warp_frames_band.launches == launches
    with pytest.raises(ValueError, match="shard"):
        warp_kernel.warp_frames_band(*args, ts, black, white, num_shards=n, shard_index=n, **kw)
    with pytest.raises(ValueError, match="mode"):
        warp_kernel.warp_frames_band(*args, ts, black, white, num_shards=n, shard_index=0,
                                     res_scalar=rs, mode=7, is_hdr=is_hdr)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("is_hdr", [False, True])
def test_banded_hsv_overlay_stacks_to_the_full_overlay(rng, n, is_hdr):
    """Mode 3 on the mesh: the HSV overlay of each shard's raw_blend band
    (K2's mesh-sharded raw_blend variant; its plain version on the CPU), at
    the band's row offsets, stacked over the shards and cropped, equals
    hsv_flow_overlay of the full-frame raw blend. 50 rows (UV 25) split
    unevenly for every n."""
    h, w, rs = 50, 96, 2
    srcs = make_frame(rng, h, w, is_hdr) + make_frame(rng, h, w, is_hdr)
    flow = _t(make_flow(rng, -(-h >> rs), w >> rs, max_mag=30))
    args = (*map(_t, srcs), flow)
    black, white = _levels(is_hdr)
    ts = torch.tensor((0.2, 0.6, 1.0), dtype=torch.float32)
    kw = dict(res_scalar=rs, is_hdr=is_hdr)
    raw = warp_kernel.warp_frames(*args, ts, black, white, mode=2, raw_blend=True, **kw)
    want_y, want_uv = warp_viz.hsv_flow_overlay(*raw, flow, black, white, **kw)
    bands = []
    for s in range(n):
        ry, ruv = warp_kernel.warp_frames_band(*args, ts, black, white, mode=2, raw_blend=True,
                                               num_shards=n, shard_index=s, **kw)
        bands.append(warp_viz.hsv_flow_overlay(ry, ruv, flow, black, white, **kw,
                                               row_offsets=(s * ry.shape[1], s * ruv.shape[1])))
    assert torch.equal(torch.cat([b[0] for b in bands], 1)[:, :h], want_y)
    assert torch.equal(torch.cat([b[1] for b in bands], 1)[:, :h // 2], want_uv)
    # ... and the mode-3 plain row route, per shard.
    for s, (by, buv) in enumerate(bands):
        py, puv = torch_warp.warp_frame_rows(*args, ts, black, white, mode=3, num_shards=n,
                                             shard_index=s, **kw)
        valid_y, valid_uv = max(0, h - s * by.shape[1]), max(0, h // 2 - s * buv.shape[1])
        assert torch.equal(by[:, :valid_y], py[:, :valid_y])
        assert torch.equal(buv[:, :valid_uv], puv[:, :valid_uv])


def _shard_rows(frame: torch.Tensor, n: int, s: int) -> torch.Tensor:
    """Shard s of n's row band of a (T, plane_h, W) plane, padded with 0 to
    band_rows(plane_h, n) rows, as the mesh's bands are."""
    rows = torch_warp.band_rows(frame.shape[1], n)
    band = torch.zeros((frame.shape[0], rows, frame.shape[2]), dtype=torch.int32)
    part = torch_warp.to_int32(frame[:, s * rows:(s + 1) * rows])
    band[:, :part.shape[1]] = part
    return torch_warp.from_int32(band, frame.dtype)


# (n, is_hdr, rs, ts, h, w): n = 2 and 4, both bit depths, res_scalar 0-3,
# T = 1 and 3; 50 rows split unevenly over 4 (Y 13-row bands, the last 11;
# UV 7-row bands, the last 4).
COMPOSED_BAND_CASES = [(2, False, 0, (0.375,), 32, 64), (4, True, 1, (0.2, 0.6, 1.0), 32, 64),
                       (4, False, 2, (0.25, 0.5, 0.875), 50, 96), (2, True, 3, (0.6,), 48, 64)]


@pytest.mark.parametrize("n,is_hdr,rs,ts,h,w", COMPOSED_BAND_CASES)
def test_composed_bands_of_modes_4_to_6_match_the_row_route_and_jax(n, is_hdr, rs, ts, h, w):
    """Modes 4-6 on the mesh, per shard, through the composed band route
    (warp_frame_band_sharded; mode 6 from the gathered mode-2 bands and
    side_by_side_2, as make_multichip_step does), with K2's band in its
    plain version: exactly the plain row route (warp_frame_rows), padding
    included, and JAX's warp_frame_plane with row_offset/out_rows on the
    rows inside the plane; stacked and cropped, exactly warp_outputs."""
    from hopperrender_tpu_torch.parallel import mesh as torch_mesh
    rng = np.random.default_rng(60 + rs)
    srcs = make_frame(rng, h, w, is_hdr) + make_frame(rng, h, w, is_hdr)
    flow = make_flow(rng, -(-h >> rs), -(-w >> rs), max_mag=30)
    args = (*map(_t, srcs), _t(flow))
    black, white = _levels(is_hdr)
    tts = torch.tensor(ts, dtype=torch.float32)
    kw = dict(res_scalar=rs, is_hdr=is_hdr)
    for mode in (4, 5, 6):
        bands = [torch_mesh.warp_frame_band_sharded(
            *args, tts, black, white, mode=2 if mode == 6 else mode, **kw,
            mesh=types.SimpleNamespace(sp=n, sp_index=s)) for s in range(n)]
        y = torch.cat([b[0] for b in bands], 1)[:, :h]
        uv = torch.cat([b[1] for b in bands], 1)[:, :h // 2]
        if mode == 6:
            y, uv = warp_viz.side_by_side_2(*args[:2], args[3], y, uv, args[4], tts, white, **kw)
            bands = [(_shard_rows(y, n, s), _shard_rows(uv, n, s)) for s in range(n)]
        want = warp_viz.warp_outputs(*args, tts, black, white, mode=mode, **kw)
        assert torch.equal(y, want[0]) and torch.equal(uv, want[1]), f"mode {mode}"
        for s, band in enumerate(bands):
            rows = torch_warp.warp_frame_rows(*args, tts, black, white, mode=mode, num_shards=n,
                                              shard_index=s, **kw)
            for cz, (got, plain) in enumerate(zip(band, rows)):
                what = f"mode {mode} shard {s} cz {cz}"
                assert got.shape == plain.shape and torch.equal(got, plain), what
                plane_h = h >> cz
                row0 = s * got.shape[1]
                valid = min(got.shape[1], plane_h - row0)
                for i, t in enumerate(ts):
                    jband = jax_warp.warp_frame_plane(
                        *map(jnp.asarray, srcs), jnp.asarray(flow), jnp.float32(t),
                        jnp.float32(black), jnp.float32(white), jnp.int32(row0), cz=cz,
                        out_rows=valid, mode=mode, **kw)
                    np.testing.assert_array_equal(got[i, :valid].numpy(), np.asarray(jband),
                                                  err_msg=f"{what} t {t}")


@pytest.mark.parametrize("mode", range(7))
def test_multichip_step_on_the_card_builds_every_mode(mode):
    """On a CUDA mesh every output mode 0-6 builds a step: nothing is left
    to the plain row route. The build touches no collective, so a stand-in
    mesh is enough; the step itself runs on the card in
    tests/test_torch_cuda.py and chip_smoke.py phase 7c."""
    from hopperrender_tpu_torch.parallel import mesh as torch_mesh
    card = types.SimpleNamespace(device=torch.device("cuda"))
    step = torch_mesh.make_multichip_step(card, H, W, mode=mode, low_h=LOW_H, low_w=LOW_W,
                                          res_scalar=RS)
    assert callable(step)


def test_plain_row_route_takes_cpu_tensors_only(rng):
    """warp_frame_sharded, the plain reference of the mesh's bands, refuses
    tensors off the CPU (here on the meta device), so nothing on the card
    can fall back to it; on the CPU it is warp_frame_rows."""
    from hopperrender_tpu_torch.parallel import mesh as torch_mesh
    srcs = [_t(a) for a in make_frame(rng, H, W) + make_frame(rng, H, W)]
    flow = _t(make_flow(rng, LOW_H, LOW_W))
    ts = torch.tensor([T1])
    shard = types.SimpleNamespace(sp=2, sp_index=1)
    kw = dict(res_scalar=RS, mode=6, is_hdr=False)
    got = torch_mesh.warp_frame_sharded(*srcs, flow, ts, 16.0, 235.0, mesh=shard, **kw)
    want = torch_warp.warp_frame_rows(*srcs, flow, ts, 16.0, 235.0, num_shards=2,
                                      shard_index=1, **kw)
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    with pytest.raises(NotImplementedError, match="CPU tensors only"):
        torch_mesh.warp_frame_sharded(*(t.to("meta") for t in srcs), flow.to("meta"),
                                      ts.to("meta"), 16.0, 235.0, mesh=shard, **kw)


@pytest.mark.parametrize("is_hdr,mode", [(False, 2), (True, 0)])
def test_batched_step_matches_jax(rng, is_hdr, mode):
    """batched_step against JAX's (jitted) batched_step per stream: flow and
    raw delta exactly; Y and UV exactly against the jitted reference warp."""
    B, h, w, rs = 3, 48, 96, 1
    low_h, low_w = h >> rs, w >> rs
    frames = [[make_frame(rng, h, w, is_hdr) for _ in range(B)] for _ in range(3)]
    planes = [np.stack([f[p] for f in slot]) for slot in frames for p in (0, 1)]
    flow_prev = np.stack([make_flow(rng, low_h, low_w, max_mag=10) for _ in range(B)])
    blend = np.asarray([0.2, 0.5, 0.9], np.float32)
    black, white = _levels(is_hdr)
    kw = dict(low_h=low_h, low_w=low_w, res_scalar=rs, mode=mode, is_hdr=is_hdr)
    got = batched_step(*map(_t, planes), _t(flow_prev), 12, 8, 6, _t(blend), black, white, **kw)
    want = jax_batched_step(*map(jnp.asarray, planes), jnp.asarray(flow_prev), jnp.int32(12),
                            jnp.int32(8), jnp.int32(6), jnp.asarray(blend), jnp.float32(black),
                            jnp.float32(white), **kw)
    assert got[0].shape == (B, h, w) and got[1].shape == (B, h // 2, w)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]).astype(np.int64))
    assert np.abs(np.asarray(want[2])).max() > 0          # the search moved
    for b in range(B):
        wy, wuv = jax_warp.warp_frame(
            *(jnp.asarray(p[b]) for p in planes[:4]), jnp.asarray(flow_prev[b]),
            jnp.float32(blend[b]), jnp.float32(black), jnp.float32(white), res_scalar=rs,
            mode=mode, is_hdr=is_hdr)
        np.testing.assert_array_equal(got[0][b].numpy(), np.asarray(wy), err_msg=f"stream {b}")
        np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(wuv), err_msg=f"stream {b}")


# The geometry of test_parallel.py:21-64.
H, W, RS, LOW_H, LOW_W = 32, 64, 1, 16, 32
RADIUS, DSC, NSC, T1 = 9, 8, 6, 0.375
T3 = (0.25, 0.5, 0.875)
# (mode, ts) of the jobs each mesh runs: modes 0/1/2 at one t, mode 2 at three,
# and the visualisation modes 3-6 (composed from K2's band), at one t and three.
JOBS = [(0, (T1,)), (1, (T1,)), (2, (T1,)), (2, T3), (3, (T1,)), (6, (T1,)), (4, (T1,)),
        (5, T3), (6, T3)]


# (dp, sp, is_hdr, the modes also held to JAX's mesh step): at most four ranks
# each. Every output is held to the jitted reference warp; a JAX mesh step
# compiles for several seconds, so modes 0/1 meet it on the first mesh only.
@pytest.mark.parametrize("dp,sp,is_hdr,jax_modes", [(1, 2, False, (0, 1, 2)),
                                                     (2, 2, False, (2,)), (1, 4, True, (2,))])
def test_multichip_step_on_gloo_ranks_matches_jax_mesh(tmp_path, rng, dp, sp, is_hdr, jax_modes):
    B = dp   # one stream per dp row
    streams = [[make_frame(rng, H, W, is_hdr) for _ in range(3)] for _ in range(B)]
    y = np.stack([[f[0] for f in s] for s in streams])
    uv = np.stack([[f[1] for f in s] for s in streams])
    flow_prev = np.stack([make_flow(rng, LOW_H, LOW_W, max_mag=5) for _ in range(B)])
    black, white = _levels(is_hdr)
    jobs = []
    for j, (mode, ts) in enumerate(JOBS):
        in_path = os.path.join(tmp_path, f"in{j}.npz")
        np.savez(in_path, y=y, uv=uv, flow=flow_prev, ts=np.asarray(ts, np.float32))
        jobs.append(dict(in_path=in_path, out_path=os.path.join(tmp_path, f"out{j}." "{rank}.npz"),
                         mode=mode, res_scalar=RS, radius=RADIUS, delta_scalar=DSC,
                         neighbor_scalar=NSC, black=black, white=white))
    paths = launch.run_ranks(entry.run_stream_steps, dp, sp, device="cpu",
                             workdir=str(tmp_path), args=(jobs,), timeout=300)

    devs = np.array(jax.devices()[:dp * sp]).reshape(dp, sp)
    jmesh = JaxMesh(devs, ("dp", "sp"))
    frames = [jnp.asarray(a[:, k]) for k in range(3) for a in (y, uv)]
    scalars = (jnp.int32(RADIUS), jnp.int32(DSC), jnp.int32(NSC))
    jax_steps = {}
    for j, (mode, ts) in enumerate(JOBS):
        ranks = [np.load(p[j]) for p in paths]
        for z in ranks:
            assert str(z["backend"]) == "gloo" and z["foreign_modules"].size == 0
            # Every rank of a dp row holds the row's whole outputs.
            same_row = ranks[int(z["dp_index"]) * sp]
            for k in ("y", "uv", "blurred", "delta"):
                np.testing.assert_array_equal(z[k], same_row[k])
        got = entry.gather_dp([p[j] for p in paths], sp)
        t_axis = (len(ts),) if len(ts) > 1 else ()
        assert got["y"].shape == (B, 1, *t_axis, H, W)
        # Flow and delta are the mode-2 step's where a mode is not held to
        # the JAX mesh (which warps modes 0-3 only at this geometry).
        jmode = mode if mode in jax_modes else 2
        if jmode not in jax_steps:
            jax_steps[jmode] = jax_multichip_step(jmesh, H, W, low_h=LOW_H, low_w=LOW_W,
                                                  res_scalar=RS, is_hdr=is_hdr, mode=jmode)
        for i, t in enumerate(ts):
            jy, juv, jblur, jdelta, _ = jax_steps[jmode](
                *frames, jnp.asarray(flow_prev), *scalars, jnp.float32(t), jnp.float32(black),
                jnp.float32(white))
            gy = got["y"][:, 0, i] if t_axis else got["y"][:, 0]
            guv = got["uv"][:, 0, i] if t_axis else got["uv"][:, 0]
            np.testing.assert_array_equal(got["blurred"][:, 0], np.asarray(jblur))
            np.testing.assert_array_equal(got["delta"][:, 0], np.asarray(jdelta).astype(np.int64))
            if mode == jmode:
                tol = 1 if mode == 2 else 0
                for g, want in ((gy, jy), (guv, juv)):
                    assert np.abs(g.astype(np.int64) - np.asarray(want).astype(np.int64)).max() \
                        <= tol, f"mode {mode} t {t}"
            for b in range(B):   # exact against the jitted reference warp
                wy, wuv = jax_warp.warp_frame(
                    *(f[b] for f in frames[:4]), jnp.asarray(flow_prev[b]), jnp.float32(t),
                    jnp.float32(black), jnp.float32(white), res_scalar=RS, mode=mode,
                    is_hdr=is_hdr)
                np.testing.assert_array_equal(gy[b], np.asarray(wy), err_msg=f"mode {mode}")
                np.testing.assert_array_equal(guv[b], np.asarray(wuv), err_msg=f"mode {mode}")


def test_modes_4_to_6_on_gloo_ranks_match_jax_mesh_at_res_scalar_0(tmp_path, rng):
    """At res_scalar 0 JAX's make_multichip_step takes its row route
    (warp_frame_plane over each shard's rows), which runs every mode: on a
    (1, 2) SDR mesh the port's step in modes 4, 5 and 6, through the
    composed band route on gloo ranks, equals it exactly, outputs, flow and
    delta."""
    low_h, low_w = H, W
    frames = [make_frame(rng, H, W) for _ in range(3)]
    y, uv = np.stack([[f[0] for f in frames]]), np.stack([[f[1] for f in frames]])
    flow_prev = make_flow(rng, low_h, low_w, max_mag=5)[None]
    black, white = _levels(False)
    in_path = os.path.join(tmp_path, "in.npz")
    np.savez(in_path, y=y, uv=uv, flow=flow_prev, ts=np.asarray([T1], np.float32))
    modes = (4, 5, 6)
    jobs = [dict(in_path=in_path, out_path=os.path.join(tmp_path, f"out{mode}." "{rank}.npz"),
                 mode=mode, res_scalar=0, radius=RADIUS, delta_scalar=DSC,
                 neighbor_scalar=NSC, black=black, white=white) for mode in modes]
    paths = launch.run_ranks(entry.run_stream_steps, 1, 2, device="cpu",
                             workdir=str(tmp_path), args=(jobs,), timeout=300)
    jmesh = JaxMesh(np.array(jax.devices()[:2]).reshape(1, 2), ("dp", "sp"))
    jframes = [jnp.asarray(a[:, k]) for k in range(3) for a in (y, uv)]
    for j, mode in enumerate(modes):
        got = entry.gather_dp([p[j] for p in paths], 2)
        jstep = jax_multichip_step(jmesh, H, W, low_h=low_h, low_w=low_w, res_scalar=0,
                                   is_hdr=False, mode=mode)
        want = jstep(*jframes, jnp.asarray(flow_prev), jnp.int32(RADIUS), jnp.int32(DSC),
                     jnp.int32(NSC), jnp.float32(T1), jnp.float32(black), jnp.float32(white))
        for k, w_ in zip(("y", "uv", "blurred", "delta"), want):
            np.testing.assert_array_equal(got[k][:, 0], np.asarray(w_).astype(got[k].dtype),
                                          err_msg=f"mode {mode} {k}")
    assert np.abs(got["blurred"]).max() > 0          # the search moved


def test_entry_gives_the_1080p_single_stream_step():
    """entry(): batched_step for one 1080p SDR stream with its example
    arguments on the device asked for (here the CPU; the step itself runs in
    tests/test_torch_cuda.py, on the card)."""
    fn, args = entry.entry(device="cpu")
    assert fn.func is batched_step and fn.keywords == dict(
        low_h=270, low_w=480, res_scalar=2, mode=2, is_hdr=False)
    frames, flow_prev, blend = args[:6], args[6], args[10]
    assert [tuple(f.shape) for f in frames] == [(1, 1080, 1920), (1, 540, 1920)] * 3
    assert all(f.dtype == torch.uint8 and f.device.type == "cpu" for f in frames)
    assert tuple(flow_prev.shape) == (1, 2, 270, 480) and flow_prev.dtype == torch.int16
    assert tuple(blend.shape) == (1,) and blend.dtype == torch.float32
