"""K2's output modes 4, 5 and 6 (ops/warp_kernel.py, csrc/warp_frame.cu): the
grey flow and the two side-by-side views, one K2 launch an output. On the CPU
the wrapper takes its plain version (ops/warp.warp_frame in each mode) and
counts no launch. Every comparison is exact, bit for bit:

  * the plain version against the JAX package's jitted warp_frame(mode=m),
    each t, over res scalars 0-3, SDR and HDR, even and odd halves (mode 5's
    runs straddle an odd half; mode 6's V columns take side_by_side_2's
    m_off path) and t in and outside [0, 1];
  * the same outputs against the JAX package's compositions
    (warp_strip.grey_flow_frame, warp_viz.side_by_side_1/2) where those
    apply (dim_x a multiple of the flow cell);
  * the mesh's row bands (K2's band in modes 4-6), stacked and cropped,
    equal the full frame, and their rows past the plane are 0;
  * warp_outputs, batched_step and the mesh's band route make one K2 call
    an output in modes 4-6, in that mode, and no mode-2 call;
  * make_multichip_step in modes 4-6 on gloo ranks equals one card.

The kernel itself runs only on the card (tests/test_torch_cuda.py -k viz,
chip_smoke.py phase 4e)."""

import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hopperrender_tpu.ops import warp as jax_warp
from hopperrender_tpu.ops import warp_strip as jax_strip
from hopperrender_tpu.ops import warp_viz as jax_viz
from hopperrender_tpu_torch import entry
from hopperrender_tpu_torch.ops import warp_kernel, warp_viz
from hopperrender_tpu_torch.parallel import launch
from hopperrender_tpu_torch.parallel import mesh as torch_mesh
from hopperrender_tpu_torch.parallel.batched import batched_step

from conftest import make_flow, make_frame
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _levels(is_hdr):
    s = 256.0 if is_hdr else 1.0
    return 16.0 * s, 235.0 * s


T1, T3, T_OUT = (0.4,), (0.2, 0.6, 1.0), (-0.25, 0.5, 1.5)
MODES = (4, 5, 6)


def _inputs(seed, rs, is_hdr, h, w, max_mag=100):
    """Two random frames and a flow grid of ceil(h / 2**rs) x ceil(w / 2**rs)
    cells, with cells at the int16 range."""
    rng = np.random.default_rng(seed)
    srcs = make_frame(rng, h, w, is_hdr) + make_frame(rng, h, w, is_hdr)
    flow = make_flow(rng, -(-h >> rs), -(-w >> rs), max_mag=max_mag)
    flow[:, 0, :2] = ((-32768, 32767), (32767, -32768))
    return srcs, flow


def _jax_frame(srcs, flow, t, black, white, rs, is_hdr, mode):
    return jax_warp.warp_frame(*(jnp.asarray(a) for a in srcs), jnp.asarray(flow),
                               jnp.float32(t), jnp.float32(black), jnp.float32(white),
                               res_scalar=rs, mode=mode, is_hdr=is_hdr)


# (rs, is_hdr, h, w, ts): every res scalar, both bit depths; halves 32, 43
# (odd), 44, 43 (odd), 43 (odd) and 56; 30 rows (mode 6's bands off a
# multiple of 4); widths that are not a multiple of the flow cell (86 at rs 2
# and 3); T = 1 and 3, and t outside [0, 1]; 4K-wide strips at rs 3, HDR and
# SDR (the geometry on which the card's kernel runs its compiled warp runs
# and reads mode 6's right half as spans; no run straddles the half).
CASES = [(0, False, 32, 64, T3), (1, True, 30, 86, T_OUT), (2, False, 48, 88, T1),
         (2, True, 50, 86, T3), (3, False, 50, 86, T_OUT), (3, True, 64, 112, T3),
         (3, True, 16, 3840, T3), (3, False, 16, 3840, T1)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rs,is_hdr,h,w,ts", CASES)
def test_plain_modes_4_to_6_match_jitted_jax(rs, is_hdr, h, w, ts, mode):
    """warp_frames in modes 4-6 on CPU tensors (its plain version; no launch
    counted) equals the JAX package's jitted warp_frame, each t."""
    srcs, flow = _inputs(10 + rs + 4 * is_hdr, rs, is_hdr, h, w)
    black, white = _levels(is_hdr)
    before = warp_kernel.warp_frames.viz_launches
    got = warp_kernel.warp_frames(*map(_t, srcs), _t(flow), torch.tensor(ts), black, white,
                                  res_scalar=rs, mode=mode, is_hdr=is_hdr)
    assert warp_kernel.warp_frames.viz_launches == before
    for i, t in enumerate(ts):
        want = _jax_frame(srcs, flow, t, black, white, rs, is_hdr, mode)
        for plane, g, wnt in zip(("Y", "UV"), got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(wnt), err_msg=f"{plane} t {t}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rs,is_hdr,h,w,ts", [c for c in CASES if c[3] % (1 << c[0]) == 0])
def test_modes_4_to_6_match_the_jax_compositions(rs, is_hdr, h, w, ts, mode):
    """Where the JAX package's compositions apply (dim_x a multiple of the
    flow cell), K2's plain version in modes 4-6 equals them: grey_flow_frame,
    and side_by_side_1 / side_by_side_2 over jitted warp_frame's mode 2."""
    srcs, flow = _inputs(40 + rs + 4 * is_hdr, rs, is_hdr, h, w)
    black, white = _levels(is_hdr)
    kw = dict(res_scalar=rs, is_hdr=is_hdr)
    got = warp_kernel.warp_frames(*map(_t, srcs), _t(flow), torch.tensor(ts), black, white,
                                  mode=mode, **kw)
    j = [jnp.asarray(a) for a in srcs]
    jflow = jnp.asarray(flow)
    for i, t in enumerate(ts):
        if mode == 4:
            want = jax_strip.grey_flow_frame(jflow, dim_y=h, dim_x=w, **kw)
        else:
            w2 = _jax_frame(srcs, flow, t, black, white, rs, is_hdr, 2)
            want = (jax_viz.side_by_side_1(j[0], j[1], *w2, dim_x=w) if mode == 5 else
                    jax_viz.side_by_side_2(j[0], j[1], j[3], *w2, jflow, jnp.float32(t),
                                           jnp.float32(white), dim_y=h, dim_x=w, **kw))
        for plane, g, wnt in zip(("Y", "UV"), got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(wnt), err_msg=f"{plane} t {t}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,rs,is_hdr,h,w", [(2, 1, False, 50, 86), (3, 2, True, 50, 86),
                                             (8, 3, False, 64, 112)])
def test_mesh_bands_stack_to_the_full_frame(n, rs, is_hdr, h, w, mode):
    """K2's band in modes 4-6 (its plain version on the CPU, no launch
    counted): the shards' bands stacked and cropped equal the full frame, and
    the rows past the plane (50 rows split unevenly over 3: Y 17-row bands,
    UV 9; over 8 the last bands lie past the plane) are 0. Mode 6's rows
    read source rows outside their band: the sources are whole."""
    srcs, flow = _inputs(60 + n, rs, is_hdr, h, w, max_mag=64)
    black, white = _levels(is_hdr)
    args = (*map(_t, srcs), _t(flow), torch.tensor(T3), black, white)
    kw = dict(res_scalar=rs, mode=mode, is_hdr=is_hdr)
    full = warp_kernel.warp_frames(*args, **kw)
    before = warp_kernel.warp_frames_band.viz_launches
    bands = [warp_kernel.warp_frames_band(*args, num_shards=n, shard_index=s, **kw)
             for s in range(n)]
    assert warp_kernel.warp_frames_band.viz_launches == before
    for cz, plane_h in enumerate((h, h // 2)):
        stacked = torch.cat([b[cz] for b in bands], 1)
        assert stacked.shape[1] >= plane_h
        assert torch.equal(stacked[:, :plane_h], full[cz]), f"plane {cz}"
        assert not stacked[:, plane_h:].any(), f"plane {cz} padding"


def _spy(monkeypatch):
    """Record K2's wrapper calls, full frame and band: (mode, raw_blend, T)."""
    calls = []
    warp, band = warp_kernel.warp_frames, warp_kernel.warp_frames_band

    def spy(fn):
        def call(*args, **kwargs):
            calls.append((kwargs["mode"], kwargs.get("raw_blend", False), len(args[5])))
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(warp_kernel, "warp_frames", spy(warp))
    monkeypatch.setattr(warp_kernel, "warp_frames_band", spy(band))
    return calls


@pytest.mark.parametrize("mode", (2, 4, 5, 6))
def test_warp_outputs_is_one_k2_call_in_its_mode(monkeypatch, mode):
    """ops/warp_viz.warp_outputs (the engine's warp): one K2 call in the
    output's own mode for all T outputs (mode 4 for the first t alone: its
    outputs are one frame), and no mode-2 call in modes 4-6; the outputs
    equal jitted JAX's warp_frame."""
    rs, is_hdr, h, w = 1, True, 30, 86
    srcs, flow = _inputs(30 + mode, rs, is_hdr, h, w)
    black, white = _levels(is_hdr)
    calls = _spy(monkeypatch)
    y, uv = warp_viz.warp_outputs(*map(_t, srcs), _t(flow), torch.tensor(T3), black, white,
                                  mode=mode, res_scalar=rs, is_hdr=is_hdr)
    assert calls == [(mode, False, 1 if mode == 4 else len(T3))]
    assert y.shape == (len(T3), h, w) and uv.shape == (len(T3), h // 2, w)
    for i, t in enumerate(T3):
        want = _jax_frame(srcs, flow, t, black, white, rs, is_hdr, mode)
        np.testing.assert_array_equal(y[i].numpy(), np.asarray(want[0]), err_msg=f"t {t}")
        np.testing.assert_array_equal(uv[i].numpy(), np.asarray(want[1]), err_msg=f"t {t}")


@pytest.mark.parametrize("mode", MODES)
def test_batched_step_is_one_k2_call_a_stream(monkeypatch, mode):
    """batched_step in modes 4-6 on two streams: one K2 call in the mode a
    stream, no other, each output equal to the stream's own warp_outputs."""
    rs, h, w = 1, 32, 64
    rng = np.random.default_rng(31)
    frames = [torch.stack([_t(make_frame(rng, h, w)[k]) for _ in range(2)])
              for _ in range(3) for k in (0, 1)]
    flow = _t(np.stack([make_flow(rng, h >> rs, w >> rs, max_mag=12) for _ in range(2)]))
    blend = torch.tensor([0.3, 0.7])
    kw = dict(low_h=h >> rs, low_w=w >> rs, res_scalar=rs, is_hdr=False)
    calls = _spy(monkeypatch)
    y, uv, _, _ = batched_step(*frames, flow, 4, 8, 6, blend, 16.0, 235.0, mode=mode, **kw)
    assert calls == [(mode, False, 1)] * 2
    for b in range(2):
        wy, wuv = warp_viz.warp_outputs(*(f[b] for f in frames[:4]), flow[b], blend[b:b + 1],
                                        16.0, 235.0, mode=mode, res_scalar=rs, is_hdr=False)
        assert torch.equal(y[b], wy[0]) and torch.equal(uv[b], wuv[0])


@pytest.mark.parametrize("mode", MODES)
def test_mesh_band_route_is_one_k2_band_call_a_rank(monkeypatch, mode):
    """parallel/mesh.warp_frame_band_sharded in modes 4-6: one call of K2's
    band in the mode a rank (mode 4 for the first t, its outputs views of
    it); the ranks' bands stacked and cropped equal warp_outputs on one
    card."""
    rs, is_hdr, h, w, n = 2, False, 50, 86, 3
    srcs, flow = _inputs(70 + mode, rs, is_hdr, h, w, max_mag=30)
    black, white = _levels(is_hdr)
    args = (*map(_t, srcs), _t(flow), torch.tensor(T3), black, white)
    kw = dict(res_scalar=rs, mode=mode, is_hdr=is_hdr)
    want = warp_viz.warp_outputs(*args, **kw)
    calls = _spy(monkeypatch)
    bands = [torch_mesh.warp_frame_band_sharded(*args, **kw,
                                                mesh=types.SimpleNamespace(sp=n, sp_index=s))
             for s in range(n)]
    assert calls == [(mode, False, 1 if mode == 4 else len(T3))] * n
    for cz, plane_h in enumerate((h, h // 2)):
        stacked = torch.cat([b[cz] for b in bands], 1)
        assert stacked.shape[0] == len(T3)
        assert torch.equal(stacked[:, :plane_h], want[cz]), f"plane {cz}"


def test_mesh_modes_4_to_6_on_gloo_ranks_match_one_card(tmp_path):
    """make_multichip_step in modes 4, 5 and 6 on a (1, 2) mesh of gloo
    ranks, t_batch 3: the gathered outputs equal warp_outputs on one card
    with the same flow, byte for byte, and each rank's job made no K2 launch
    (the plain band on the CPU)."""
    rs, h, w = 2, 48, 88
    y, uv, flow = entry.example_frames(h, w, h >> rs, w >> rs, batch=1)
    ts = np.asarray(T3, np.float32)
    in_path = os.path.join(tmp_path, "in.npz")
    np.savez(in_path, y=y, uv=uv, flow=flow, ts=ts)
    black, white = _levels(False)
    jobs = [dict(in_path=in_path, out_path=os.path.join(tmp_path, f"out{mode}." "{rank}.npz"),
                 mode=mode, res_scalar=rs, radius=9, delta_scalar=8, neighbor_scalar=6,
                 black=black, white=white) for mode in MODES]
    paths = launch.run_ranks(entry.run_stream_steps, 1, 2, device="cpu", workdir=str(tmp_path),
                             args=(jobs,), timeout=300)
    y_t, uv_t, flow_t = _t(y[0]), _t(uv[0]), _t(flow[0])
    for j, mode in enumerate(MODES):
        for rank_paths in paths:
            with np.load(rank_paths[j]) as z:
                assert int(z["band_launches"]) == int(z["band_mode3_launches"]) == 0
                assert int(z["band_viz_launches"]) == 0
        got = entry.gather_dp([p[j] for p in paths], 2)
        flow_prev = flow_t
        for i in range(y.shape[1] - 2):
            want = warp_viz.warp_outputs(y_t[i], uv_t[i], y_t[i + 1], uv_t[i + 1], flow_prev,
                                         torch.tensor(ts), black, white, mode=mode,
                                         res_scalar=rs, is_hdr=False)
            for k, wnt in zip(("y", "uv"), want):
                np.testing.assert_array_equal(got[k][0, i], wnt.numpy(),
                                              err_msg=f"mode {mode} step {i} {k}")
            flow_prev = _t(got["blurred"][0, i])
