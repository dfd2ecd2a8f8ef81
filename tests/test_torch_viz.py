"""The PyTorch port's visualisation modes against the JAX package, exactly:
the HSV flow colour (_visualize_flow) against jitted JAX over every (ox, oy)
in +-512 and 2**20 random int16 pairs, and the compositions of ops/warp_viz.py
(HSV overlay, grey flow, side by side) against the JAX package's
compositions and its reference-formulation warp."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hopperrender_tpu.ops import warp as jax_warp
from hopperrender_tpu.ops import warp_strip
from hopperrender_tpu.ops import warp_viz as jax_viz
from hopperrender_tpu_torch.ops import warp as torch_warp
from hopperrender_tpu_torch.ops import warp_kernel, warp_viz

from conftest import make_flow, make_frame


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _levels(is_hdr):
    s = 256.0 if is_hdr else 1.0
    return 16.0 * s, 235.0 * s


def _flow_pairs():
    """Every (ox, oy) in +-512, then 2**20 random int16 pairs (with -32768)."""
    v = np.arange(-512, 513, dtype=np.int16)
    oy, ox = (a.ravel() for a in np.meshgrid(v, v, indexing="ij"))
    rng = np.random.default_rng(20)
    rx = rng.integers(-32768, 32768, 1 << 20).astype(np.int16)
    ry = rng.integers(-32768, 32768, 1 << 20).astype(np.int16)
    rx[:3], ry[1:4] = -32768, -32768
    return np.concatenate([ox, rx]), np.concatenate([oy, ry])


_visualize_jit = jax.jit(jax_warp._visualize_flow, static_argnums=(4, 5))


@pytest.mark.parametrize("is_hdr,res_impact", [(False, 1), (False, 4), (True, 1), (True, 4)])
def test_visualize_flow_every_pair(is_hdr, res_impact):
    """Each channel over every pair, flat, as _visualize_flow is compiled on
    its own and inside warp_frame's mode 3. (XLA rounds by fusion: called on
    a (1, N) flow against (3, N) channels, or inside the JAX package's
    hsv_flow_overlay, it leaves the Y sum uncontracted, and Y then differs on
    a few pairs, e.g. HDR (183, 53) at res_impact 1.)"""
    ox, oy = _flow_pairs()
    rng = np.random.default_rng(21)
    for channel in (0, 1, 2):
        curr = rng.integers(0, 65536 if is_hdr else 256, ox.size).astype(np.int32)
        chan = np.full(ox.size, channel, np.int32)
        want = np.asarray(_visualize_jit(ox, oy, curr, chan, res_impact, is_hdr))
        got = torch_warp._visualize_flow(_t(ox), _t(oy), _t(curr), _t(chan), res_impact,
                                         is_hdr).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"channel {channel}")


def test_atan2f_is_the_compiled_atan2():
    """The port's atan2 equals the atan2 that jitted JAX computes, bit for bit
    (torch.atan2 does not)."""
    ox, oy = _flow_pairs()
    x, y = ox.astype(np.float32), oy.astype(np.float32)
    want = np.asarray(jax.jit(jnp.arctan2)(y, x))
    got = torch_warp._atan2f(_t(y), _t(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (torch.atan2(_t(y), _t(x)).numpy() != want).any()


# (rs, is_hdr, h, w): both bit depths at every res scalar; the JAX
# compositions repeat flow over whole cells, so w is a multiple of 1 << rs.
# (The JAX overlay's Y sum is uncontracted, see above; these inputs hold no
# pair where that changes Y.)
GEOMETRIES = [(0, False, 48, 86), (1, True, 48, 86), (2, True, 64, 112), (3, False, 64, 112)]


def _inputs(rng, rs, is_hdr, h, w):
    y1, uv1 = make_frame(rng, h, w, is_hdr)
    y2, uv2 = make_frame(rng, h, w, is_hdr)
    flow = make_flow(rng, -(-h >> rs), -(-w >> rs), max_mag=200)
    return (y1, uv1, y2, uv2), flow


@pytest.mark.parametrize("rs,is_hdr,h,w", GEOMETRIES)
def test_compositions_match_jax(rs, is_hdr, h, w):
    """hsv_flow_overlay over K2's raw blend, grey_flow_frame, side_by_side_1
    and side_by_side_2 against the JAX package's, for a T=2 batch."""
    rng = np.random.default_rng(30 + rs)
    srcs, flow = _inputs(rng, rs, is_hdr, h, w)
    black, white = _levels(is_hdr)
    ts = (0.3, 0.8)
    kw = dict(res_scalar=rs, is_hdr=is_hdr)
    tsrcs = [_t(a) for a in srcs]
    tflow = _t(flow)
    tts = torch.tensor(ts, dtype=torch.float32)
    raw_y, raw_uv = warp_kernel.warp_frames(*tsrcs, tflow, tts, black, white, mode=2,
                                            raw_blend=True, **kw)
    hsv = warp_viz.hsv_flow_overlay(raw_y, raw_uv, tflow, black, white, **kw)
    w2y, w2uv = warp_kernel.warp_frames(*tsrcs, tflow, tts, black, white, mode=2, **kw)
    sbs1 = warp_viz.side_by_side_1(tsrcs[0], tsrcs[1], w2y, w2uv)
    sbs2 = warp_viz.side_by_side_2(tsrcs[0], tsrcs[1], tsrcs[3], w2y, w2uv, tflow, tts,
                                   white, **kw)
    grey = warp_viz.grey_flow_frame(tflow, dim_y=h, dim_x=w, **kw)
    jgrey = warp_strip.grey_flow_frame(jnp.asarray(flow), dim_y=h, dim_x=w, **kw)
    for got, want in zip(grey, jgrey):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    j = [jnp.asarray(a) for a in srcs]
    jflow = jnp.asarray(flow)
    for i, t in enumerate(ts):
        args = (jnp.float32(t), jnp.float32(black), jnp.float32(white))
        jw2 = jax_warp.warp_frame(*j, jflow, *args, res_scalar=rs, mode=2, is_hdr=is_hdr)
        want = {
            "hsv": jax_viz.hsv_flow_overlay(
                jnp.asarray(raw_y[i].numpy()), jnp.asarray(raw_uv[i].numpy()), jflow,
                jnp.float32(black), jnp.float32(white), dim_y=h, dim_x=w, **kw),
            "sbs1": jax_viz.side_by_side_1(j[0], j[1], *jw2, dim_x=w),
            "sbs2": jax_viz.side_by_side_2(j[0], j[1], j[3], *jw2, jflow, jnp.float32(t),
                                           jnp.float32(white), dim_y=h, dim_x=w, **kw),
        }
        for name, got in (("hsv", hsv), ("sbs1", sbs1), ("sbs2", sbs2)):
            for plane, g, wnt in zip(("Y", "UV"), got, want[name]):
                np.testing.assert_array_equal(g[i].numpy(), np.asarray(wnt),
                                              err_msg=f"{name} {plane} t {t}")


# colour pair -> Y at pixel (0, 0): (port and reference warp, JAX overlay)
OVERLAY_FAULT = {(50, -84): (31016, 31166), (183, 53): (37133, 37283)}


@pytest.mark.parametrize("pair", list(OVERLAY_FAULT))
def test_overlay_follows_reference_warp_where_jax_overlay_differs(pair):
    """HDR, res scalar 3, a flow cell whose colour pair is `pair`: the JAX
    package's two mode-3 formulations disagree here by one colour step in Y
    (XLA contracts the Y sum in the reference warp and not in the overlay's
    fusion). The port's overlay follows the reference warp, whose rounding
    the golden fixtures carry."""
    rng = np.random.default_rng(3)
    h = w = 16
    rs, t = 3, 0.5
    black, white = _levels(True)
    flow = np.empty((2, 2, 2), np.int16)
    flow[0], flow[1] = -pair[0], -pair[1]      # the overlay colours the negated flow
    srcs = [rng.integers(0, 65536, s).astype(np.uint16)
            for s in ((h, w), (h // 2, w), (h, w), (h // 2, w))]
    kw = dict(res_scalar=rs, is_hdr=True)
    raw = warp_kernel.warp_frames(*(_t(a) for a in srcs), _t(flow), torch.tensor([t]), black,
                                  white, mode=2, raw_blend=True, **kw)
    port = warp_viz.hsv_flow_overlay(*raw, _t(flow), black, white, **kw)
    ref = jax_warp.warp_frame(*(jnp.asarray(a) for a in srcs), jnp.asarray(flow),
                              jnp.float32(t), jnp.float32(black), jnp.float32(white),
                              mode=3, **kw)
    for g, want in zip(port, ref):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(want))
    jax_y = jax_viz.hsv_flow_overlay(jnp.asarray(raw[0][0].numpy()),
                                     jnp.asarray(raw[1][0].numpy()), jnp.asarray(flow),
                                     jnp.float32(black), jnp.float32(white), dim_y=h, dim_x=w,
                                     **kw)[0]
    assert (np.asarray(jax_y) != np.asarray(ref[0])).all()
    assert (int(ref[0][0, 0]), int(jax_y[0, 0])) == OVERLAY_FAULT[pair]


@pytest.mark.parametrize("rs,is_hdr,h,w", [(2, False, 50, 86), (3, True, 50, 86)])
def test_compositions_any_even_geometry(rs, is_hdr, h, w):
    """Where the JAX compositions cannot go (86 is not a multiple of the
    cell; an odd half width for mode 6), the port's compositions equal the
    JAX reference-formulation warp of modes 3/4/5/6."""
    rng = np.random.default_rng(40 + rs)
    srcs, flow = _inputs(rng, rs, is_hdr, h, w)
    black, white = _levels(is_hdr)
    t = 0.6
    kw = dict(res_scalar=rs, is_hdr=is_hdr)
    tsrcs = [_t(a) for a in srcs]
    tflow = _t(flow)
    tts = torch.tensor([t], dtype=torch.float32)
    raw = warp_kernel.warp_frames(*tsrcs, tflow, tts, black, white, mode=2, raw_blend=True,
                                  **kw)
    w2 = warp_kernel.warp_frames(*tsrcs, tflow, tts, black, white, mode=2, **kw)
    got = {
        3: warp_viz.hsv_flow_overlay(*raw, tflow, black, white, **kw),
        4: tuple(p[None] for p in warp_viz.grey_flow_frame(tflow, dim_y=h, dim_x=w, **kw)),
        5: warp_viz.side_by_side_1(tsrcs[0], tsrcs[1], *w2),
        6: warp_viz.side_by_side_2(tsrcs[0], tsrcs[1], tsrcs[3], *w2, tflow, tts, white,
                                   **kw),
    }
    for mode, planes in got.items():
        want = jax_warp.warp_frame(*(jnp.asarray(a) for a in srcs), jnp.asarray(flow),
                                   jnp.float32(t), jnp.float32(black), jnp.float32(white),
                                   mode=mode, **kw)
        for plane, g, wnt in zip(("Y", "UV"), planes, want):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(wnt),
                                          err_msg=f"mode {mode} {plane}")
