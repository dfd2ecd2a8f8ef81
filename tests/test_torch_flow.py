"""The PyTorch port's flow ops against hopperrender_tpu.ops.flow: the cost
volume, the layer argmin, the offset adjust and the whole pyramid, exactly,
including int16 offset wraparound and uint32 window-sum wraparound."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hopperrender_tpu import config
from hopperrender_tpu.ops import flow as jax_flow
from hopperrender_tpu.vio import nv12
from hopperrender_tpu_torch.ops import flow as torch_flow

from conftest import make_frame


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(rng, h, w, is_hdr, motion=3):
    y1, uv1 = nv12.synthetic_frame(rng, h, w, is_hdr=is_hdr, motion_x=0)
    y2, uv2 = nv12.synthetic_frame(rng, h, w, is_hdr=is_hdr, motion_x=motion)
    return y1, uv1, y2, uv2


def _jax_sums(frames, offsets, radius, ds, ns, **kw):
    f = [jnp.asarray(a) for a in frames]
    return np.asarray(jax_flow.delta_window_sums(
        *f, jnp.asarray(offsets), jnp.int32(radius), jnp.int32(ds), jnp.int32(ns), **kw))


# (is_hdr, rs, radius, iteration, step, window): the neighbor bias starts at
# iteration 4; steps 0/1 search x/y.
@pytest.mark.parametrize("is_hdr,rs,radius,iteration,step,window", [
    (False, 0, 5, 0, 0, 16),
    (True, 1, 11, 0, 1, 8),
    (False, 2, 16, 4, 0, 4),
    (True, 0, 16, 5, 1, 2),
])
def test_delta_window_sums_and_argmin(rng, is_hdr, rs, radius, iteration, step, window):
    h, w = 32 << rs, 48 << rs
    frames = _pair(rng, h, w, is_hdr)
    offsets = rng.integers(-20, 21, (2, 32, 48)).astype(np.int16)
    kw = dict(window_size=window, res_scalar=rs, iteration=iteration, step=step,
              is_hdr=is_hdr)
    want = _jax_sums(frames, offsets, radius, 8, 6, **kw)
    got = torch_flow.delta_window_sums(*map(_t, frames), _t(offsets), radius, 8, 6, **kw)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(torch_flow.lowest_layer(got).numpy(),
                                  np.asarray(jax_flow.lowest_layer(jnp.asarray(want))))


def test_delta_window_sums_int16_and_uint32_wraparound(rng):
    """Offsets at the int16 limits wrap when the candidate is added; at
    iteration >= 4 with neighbor_scalar 10 the window sums pass 2**32 and wrap."""
    frames = make_frame(rng, 32, 64, True) + make_frame(rng, 32, 64, True)
    frames = (frames[0], frames[1], frames[2], frames[3])
    offsets = rng.choice(np.array([-32768, -32767, -30000, 30000, 32766, 32767]),
                         (2, 32, 64)).astype(np.int16)
    kw = dict(window_size=16, res_scalar=0, iteration=4, step=0, is_hdr=True)
    want = _jax_sums(frames, offsets, 16, 10, 10, **kw)
    got = torch_flow.delta_window_sums(*map(_t, frames), _t(offsets), 16, 10, 10, **kw)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # Layer radius//2 adds no candidate offset, so its neighbor bias alone is
    # sum |plane[clamped shift] - plane| << 10: past 2**32, the sum wrapped.
    plane = offsets[0].astype(np.int64)
    rows, cols = np.arange(32), np.arange(64)
    nb = sum(np.abs(plane[np.clip(rows + d, 0, 31)] - plane) for d in (-32, 32)) \
        + sum(np.abs(plane[:, np.clip(cols + d, 0, 63)] - plane) for d in (-32, 32))
    assert (nb << 10).reshape(2, 16, 4, 16).sum(axis=(1, 3)).max() > 2 ** 32


def test_adjust_offsets_wraps_int16(rng):
    offsets = rng.choice(np.array([-32768, -32760, 0, 32760, 32767]), (2, 20, 36)).astype(np.int16)
    winners = rng.integers(0, 16, (3, 5)).astype(np.int32)
    for step in (0, 1):
        want = np.asarray(jax_flow.adjust_offsets(jnp.asarray(offsets), jnp.asarray(winners),
                                                  jnp.int32(16), window_size=8, step=step))
        got = torch_flow.adjust_offsets(_t(offsets), _t(winners), 16, window_size=8, step=step)
        np.testing.assert_array_equal(got.numpy(), want)
    # |adjustment| <= 8*8 unless the int16 sum wrapped: some cell did.
    assert (np.abs(want.astype(np.int32) - offsets.astype(np.int32)) > 64).any()


def test_window_schedule_matches():
    for low in ((270, 480), (135, 240), (24, 40), (1, 1)):
        for nit in (0, 3):
            assert torch_flow.window_schedule(*low, nit) == jax_flow.window_schedule(*low, nit)


# (is_hdr, rs, radius, num_iterations): SDR and HDR, rs 0-2, radius 5/11/16,
# auto depth (0: through the neighbor-bias iterations) and 3.
@pytest.mark.parametrize("is_hdr,rs,radius,num_iterations", [
    (False, 0, 5, 0),
    (True, 1, 11, 0),
    (False, 2, 16, 3),
    (True, 2, 16, 0),
    (False, 1, 5, 3),
])
def test_pyramid_flow_matches(rng, is_hdr, rs, radius, num_iterations):
    h, w = 24 << rs, 40 << rs
    frames = _pair(rng, h, w, is_hdr, motion=5)
    low_h, low_w = h >> rs, w >> rs
    kw = dict(low_h=low_h, low_w=low_w, res_scalar=rs, is_hdr=is_hdr,
              num_iterations=num_iterations)
    off_j, blur_j, raw_j = jax_flow.pyramid_flow(
        *map(jnp.asarray, frames), jnp.int32(radius), jnp.int32(8), jnp.int32(6), **kw)
    bucket = next(b for b in (5, 8, 12, 16) if radius <= b)
    off_t, blur_t, raw_t = torch_flow.pyramid_flow(
        *map(_t, frames), radius, 8, 6, num_layers=bucket, **kw)
    np.testing.assert_array_equal(off_t.numpy(), np.asarray(off_j))
    np.testing.assert_array_equal(blur_t.numpy(), np.asarray(blur_j))
    assert int(raw_t) == int(raw_j)
    assert np.abs(np.asarray(off_j)).max() > 0   # the search moved


def test_pyramid_rejects_radius_above_layers(rng):
    frames = _pair(rng, 24, 40, False)
    with pytest.raises(ValueError):
        torch_flow.pyramid_flow(*map(_t, frames), config.MAX_SEARCH_RADIUS, 8, 6,
                                low_h=24, low_w=40, res_scalar=0, is_hdr=False,
                                num_layers=8)
