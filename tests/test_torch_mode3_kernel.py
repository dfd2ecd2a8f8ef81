"""K2's mode 3 (ops/warp_kernel.py, csrc/warp_frame.cu): the HSV flow overlay
in K2's epilogue, one launch that warps, blends, colours and levels. On the
CPU the wrapper takes its plain version (ops/warp.warp_frame in mode 3) and
counts no launch. Every comparison is exact, bit for bit:

  * the plain version against the JAX package's jitted warp_frame(mode=3),
    each t, across res scalars, bit depths, ragged widths and T;
  * the plain version against the chain it replaces on the served path
    (K2's raw_blend variant, then K5's overlay), for t in [0, 1];
  * where the JAX package's two mode-3 formulations disagree (OVERLAY_FAULT),
    mode 3 follows warp_frame;
  * the mesh's row bands (K2's band in mode 3), stacked and cropped, equal
    the full frame, and their rows past the plane are 0;
  * the visualisation composition and batched_step make one K2 call a mode-3
    output and no K5 call.

The kernel itself runs only on the card (tests/test_torch_cuda.py -k mode3,
chip_smoke.py phase 4d)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hopperrender_tpu.ops import warp as jax_warp
from hopperrender_tpu.ops import warp_viz as jax_viz
from hopperrender_tpu_torch.ops import hsv_kernel, warp_kernel, warp_viz
from hopperrender_tpu_torch.parallel.batched import batched_step

from conftest import make_flow, make_frame
from test_torch_viz import OVERLAY_FAULT
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _levels(is_hdr):
    s = 256.0 if is_hdr else 1.0
    return 16.0 * s, 235.0 * s


T1, T3, T_OUT = (0.4,), (0.2, 0.6, 1.0), (-0.25, 0.5, 1.5)


def _inputs(seed, rs, is_hdr, h, w, max_mag=100):
    """Two random frames and a flow grid of ceil(h / 2**rs) x ceil(w / 2**rs)
    cells, with a cell of no flow, one of a flat hue and the int16 wrap."""
    rng = np.random.default_rng(seed)
    srcs = make_frame(rng, h, w, is_hdr) + make_frame(rng, h, w, is_hdr)
    flow = make_flow(rng, -(-h >> rs), -(-w >> rs), max_mag=max_mag)
    flow[:, 0, :3] = ((0, 5, -32768), (0, 0, 7))
    return srcs, flow


def _jax_mode3(srcs, flow, t, black, white, rs, is_hdr):
    return jax_warp.warp_frame(*(jnp.asarray(a) for a in srcs), jnp.asarray(flow),
                               jnp.float32(t), jnp.float32(black), jnp.float32(white),
                               res_scalar=rs, mode=3, is_hdr=is_hdr)


# (rs, is_hdr, h, w, ts): res scalars 0, 1, 2 and 3, both bit depths, ragged
# widths (86: rows off 16 bytes, cells cut at the right edge) and 112, T = 1
# and 3, and t outside [0, 1] (blends below 0 and above the peak).
CASES = [(0, False, 50, 86, T3), (0, True, 48, 112, T1), (1, False, 48, 112, T1),
         (1, True, 50, 86, T3), (2, True, 50, 86, T3), (3, False, 50, 86, T1),
         (3, True, 48, 112, T3), (3, True, 50, 86, T_OUT)]


@pytest.mark.parametrize("rs,is_hdr,h,w,ts", CASES)
def test_plain_mode3_matches_jitted_jax(rs, is_hdr, h, w, ts):
    """warp_frames(mode=3) on CPU tensors (its plain version; no launch
    counted) equals the JAX package's jitted warp_frame in mode 3, each t."""
    srcs, flow = _inputs(10 + rs + 4 * is_hdr, rs, is_hdr, h, w)
    black, white = _levels(is_hdr)
    before = warp_kernel.warp_frames.mode3_launches
    got = warp_kernel.warp_frames(*map(_t, srcs), _t(flow), torch.tensor(ts), black, white,
                                  res_scalar=rs, mode=3, is_hdr=is_hdr)
    assert warp_kernel.warp_frames.mode3_launches == before
    for i, t in enumerate(ts):
        want = _jax_mode3(srcs, flow, t, black, white, rs, is_hdr)
        for plane, g, wnt in zip(("Y", "UV"), got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(wnt), err_msg=f"{plane} t {t}")


@pytest.mark.parametrize("rs,is_hdr,h,w,ts", [c for c in CASES if c[4] != T_OUT])
def test_plain_mode3_is_the_raw_blend_chain(rs, is_hdr, h, w, ts):
    """The identity the fusion rests on: mode 3 equals K2's raw_blend variant
    coloured by K5 (the served path before the fusion), both plain, for t in
    [0, 1], where the raw blend fits its sample type. (Outside [0, 1] the
    chain narrows the raw blend to its type and mode 3 does not, as
    warp_frame does not.)"""
    srcs, flow = _inputs(20 + rs + 4 * is_hdr, rs, is_hdr, h, w)
    black, white = _levels(is_hdr)
    args = (*map(_t, srcs), _t(flow), torch.tensor(ts), black, white)
    kw = dict(res_scalar=rs, is_hdr=is_hdr)
    fused = warp_kernel.warp_frames_reference(*args, mode=3, **kw)
    raw = warp_kernel.warp_frames_reference(*args, mode=2, raw_blend=True, **kw)
    chain = hsv_kernel.hsv_flow_overlay_reference(*raw, _t(flow), black, white, **kw)
    for plane, f, c in zip(("Y", "UV"), fused, chain):
        assert torch.equal(f, c), plane


@pytest.mark.parametrize("pair", list(OVERLAY_FAULT))
def test_mode3_follows_warp_frame_where_jax_overlay_differs(pair):
    """HDR, res scalar 3, a flow cell whose colour pair is `pair`, where the
    JAX package's overlay (hsv_flow_overlay after raw_blend) and its
    warp_frame disagree by one colour step in Y: K2's mode 3 follows
    warp_frame, as the golden fixtures do."""
    rng = np.random.default_rng(3)
    h = w = 16
    rs, t = 3, 0.5
    black, white = _levels(True)
    flow = np.empty((2, 2, 2), np.int16)
    flow[0], flow[1] = -pair[0], -pair[1]      # the overlay colours the negated flow
    srcs = [rng.integers(0, 65536, s).astype(np.uint16)
            for s in ((h, w), (h // 2, w), (h, w), (h // 2, w))]
    kw = dict(res_scalar=rs, is_hdr=True)
    got = warp_kernel.warp_frames(*map(_t, srcs), _t(flow), torch.tensor([t]), black, white,
                                  mode=3, **kw)
    ref = _jax_mode3(srcs, flow, t, black, white, rs, True)
    for g, want in zip(got, ref):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(want))
    raw = warp_kernel.warp_frames(*map(_t, srcs), _t(flow), torch.tensor([t]), black, white,
                                  mode=2, raw_blend=True, **kw)
    jax_y = jax_viz.hsv_flow_overlay(jnp.asarray(raw[0][0].numpy()),
                                     jnp.asarray(raw[1][0].numpy()), jnp.asarray(flow),
                                     jnp.float32(black), jnp.float32(white), dim_y=h, dim_x=w,
                                     **kw)[0]
    assert (np.asarray(jax_y) != got[0][0].numpy()).all()
    assert (int(got[0][0, 0, 0]), int(jax_y[0, 0])) == OVERLAY_FAULT[pair]


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("rs,is_hdr,h,w", [(1, False, 50, 86), (3, True, 50, 112)])
def test_mesh_bands_stack_to_the_full_frame(rs, is_hdr, h, w, n):
    """The mesh's mode 3, K2's band in mode 3 (its plain version on the
    CPU, no launch counted): the shards' bands stacked and cropped equal the
    full frame, and the rows past the plane (50 rows: UV's 25 split
    unevenly) are 0, where the chain (K5 on the raw_blend band) coloured
    them."""
    srcs, flow = _inputs(60 + n, rs, is_hdr, h, w, max_mag=64)
    black, white = _levels(is_hdr)
    args = (*map(_t, srcs), _t(flow), torch.tensor(T3), black, white)
    kw = dict(res_scalar=rs, mode=3, is_hdr=is_hdr)
    full = warp_kernel.warp_frames(*args, **kw)
    before = warp_kernel.warp_frames_band.mode3_launches
    bands = [warp_kernel.warp_frames_band(*args, num_shards=n, shard_index=s, **kw)
             for s in range(n)]
    assert warp_kernel.warp_frames_band.mode3_launches == before
    for cz, plane_h in enumerate((h, h // 2)):
        stacked = torch.cat([b[cz] for b in bands], 1)
        assert stacked.shape[1] >= plane_h
        assert torch.equal(stacked[:, :plane_h], full[cz]), f"plane {cz}"
        assert not stacked[:, plane_h:].any(), f"plane {cz} padding"
    assert torch.cat([b[1] for b in bands], 1).shape[1] > h // 2   # UV has padding rows


def test_mode3_has_no_raw_blend():
    """raw_blend is a variant of mode 2: mode 3 with it is refused, full frame
    and band alike, before anything runs."""
    srcs, flow = _inputs(5, 3, True, 16, 32)
    args = (*map(_t, srcs), _t(flow), torch.tensor(T1), 0.0, 255.0 * 256)
    with pytest.raises(ValueError, match="raw_blend"):
        warp_kernel.warp_frames(*args, res_scalar=3, mode=3, is_hdr=True, raw_blend=True)
    with pytest.raises(ValueError, match="raw_blend"):
        warp_kernel.warp_frames_band(*args, res_scalar=3, mode=3, is_hdr=True, raw_blend=True,
                                     num_shards=2, shard_index=0)


def _spy(monkeypatch):
    """Record K2's and K5's wrapper calls: (mode, raw_blend) and K5's count."""
    calls, overlays = [], []
    warp, overlay = warp_kernel.warp_frames, hsv_kernel.hsv_flow_overlay

    def warp_spy(*args, **kwargs):
        calls.append((kwargs["mode"], kwargs.get("raw_blend", False)))
        return warp(*args, **kwargs)

    def overlay_spy(*args, **kwargs):
        overlays.append(1)
        return overlay(*args, **kwargs)

    monkeypatch.setattr(warp_kernel, "warp_frames", warp_spy)
    monkeypatch.setattr(hsv_kernel, "hsv_flow_overlay", overlay_spy)
    return calls, overlays


def test_warp_outputs_mode3_is_one_k2_call(monkeypatch):
    """ops/warp_viz.warp_outputs in mode 3 (the engine's warp): one K2 call
    in mode 3 for all T outputs, no raw_blend, no K5; the outputs equal
    jitted JAX's warp_frame."""
    rs, is_hdr, h, w = 2, False, 48, 112
    srcs, flow = _inputs(30, rs, is_hdr, h, w)
    black, white = _levels(is_hdr)
    calls, overlays = _spy(monkeypatch)
    y, uv = warp_viz.warp_outputs(*map(_t, srcs), _t(flow), torch.tensor(T3), black, white,
                                  mode=3, res_scalar=rs, is_hdr=is_hdr)
    assert calls == [(3, False)] and not overlays
    for i, t in enumerate(T3):
        want = _jax_mode3(srcs, flow, t, black, white, rs, is_hdr)
        np.testing.assert_array_equal(y[i].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(uv[i].numpy(), np.asarray(want[1]))


def test_batched_step_mode3_is_one_k2_call_a_stream(monkeypatch):
    """batched_step in mode 3 on two streams: one K2 call in mode 3 a stream
    (and no K5), each output equal to the stream's own warp_outputs."""
    rs, h, w = 1, 32, 64
    rng = np.random.default_rng(31)
    frames = [torch.stack([_t(make_frame(rng, h, w)[k]) for _ in range(2)])
              for _ in range(3) for k in (0, 1)]
    flow = _t(np.stack([make_flow(rng, h >> rs, w >> rs, max_mag=12) for _ in range(2)]))
    blend = torch.tensor([0.3, 0.7])
    kw = dict(low_h=h >> rs, low_w=w >> rs, res_scalar=rs, is_hdr=False)
    calls, overlays = _spy(monkeypatch)
    y, uv, _, _ = batched_step(*frames, flow, 4, 8, 6, blend, 16.0, 235.0, mode=3, **kw)
    assert calls == [(3, False)] * 2 and not overlays
    for b in range(2):
        wy, wuv = warp_viz.warp_outputs(*(f[b] for f in frames[:4]), flow[b], blend[b:b + 1],
                                        16.0, 235.0, mode=3, res_scalar=rs, is_hdr=False)
        assert torch.equal(y[b], wy[0]) and torch.equal(uv[b], wuv[0])
