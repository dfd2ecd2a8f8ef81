"""The PyTorch port's warp (plain version of kernel K2, its raw_blend variant,
and the visualisation modes 3-6) against the JAX package: the Pallas band
kernel in interpret mode, the reference-formulation warp
(hopperrender_tpu.ops.warp), and the passthrough copy. Every comparison is
exact (bit for bit)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hopperrender_tpu.ops import warp as jax_warp
from hopperrender_tpu.ops import warp_band, warp_strip
from hopperrender_tpu_torch.ops import warp as torch_warp
from hopperrender_tpu_torch.ops import warp_kernel

from conftest import make_flow, make_frame
from torch_warp_cases import BAND_CASES, WARP_CASES, make_inputs
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


def _levels(is_hdr):
    s = 256.0 if is_hdr else 1.0
    return 16.0 * s, 235.0 * s


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# Four interpret-mode band programs (each takes several seconds on a CPU):
# both res scalars, both bit depths, all three modes, one batched T=3 call.
@pytest.mark.parametrize("rs,is_hdr,mode,ts", [
    (2, False, 2, (0.2, 0.6, 1.0)),
    (3, True, 2, (0.4,)),
    (2, True, 0, (0.8,)),
    (3, False, 1, (0.4,)),
])
def test_matches_band_kernel_interpret(rng, rs, is_hdr, mode, ts):
    h, w, apron = 64, 128, 32
    y1, uv1 = make_frame(rng, h, w, is_hdr)
    y2, uv2 = make_frame(rng, h, w, is_hdr)
    flow = make_flow(rng, h >> rs, w >> rs, max_mag=25)
    black, white = _levels(is_hdr)
    c1 = warp_strip.build_warp_context(jnp.asarray(y1), jnp.asarray(uv1), apron=apron,
                                       is_hdr=is_hdr)
    c2 = warp_strip.build_warp_context(jnp.asarray(y2), jnp.asarray(uv2), apron=apron,
                                       is_hdr=is_hdr)
    t_arg = jnp.asarray(ts, jnp.float32) if len(ts) > 1 else jnp.float32(ts[0])
    yb, uvb = warp_band.warp_frame_band(
        c1, c2, jnp.asarray(flow), t_arg, jnp.float32(black), jnp.float32(white),
        res_scalar=rs, mode=mode, is_hdr=is_hdr, dim_y=h, dim_x=w, apron=apron,
        interpret=True)
    yb, uvb = np.asarray(yb).reshape(len(ts), h, w), np.asarray(uvb).reshape(len(ts), h // 2, w)
    yt, uvt = warp_kernel.warp_frames(
        _t(y1), _t(uv1), _t(y2), _t(uv2), _t(flow), torch.tensor(ts, dtype=torch.float32),
        black, white, res_scalar=rs, mode=mode, is_hdr=is_hdr)
    np.testing.assert_array_equal(yt.numpy(), yb)
    np.testing.assert_array_equal(uvt.numpy(), uvb)


# Two interpret-mode band programs of the raw_blend variant: a batched T=3
# SDR call and a scalar HDR one.
@pytest.mark.parametrize("rs,is_hdr,ts", [(2, False, (0.2, 0.6, 1.0)), (3, True, (0.4,))])
def test_raw_blend_matches_band_kernel_interpret(rng, rs, is_hdr, ts):
    """K2's raw_blend plain version against the TPU kernel's raw_blend=True
    variant: mode 2's blend with no levels."""
    h, w, apron = 64, 128, 32
    y1, uv1 = make_frame(rng, h, w, is_hdr)
    y2, uv2 = make_frame(rng, h, w, is_hdr)
    flow = make_flow(rng, h >> rs, w >> rs, max_mag=25)
    black, white = _levels(is_hdr)
    c1 = warp_strip.build_warp_context(jnp.asarray(y1), jnp.asarray(uv1), apron=apron,
                                       is_hdr=is_hdr)
    c2 = warp_strip.build_warp_context(jnp.asarray(y2), jnp.asarray(uv2), apron=apron,
                                       is_hdr=is_hdr)
    t_arg = jnp.asarray(ts, jnp.float32) if len(ts) > 1 else jnp.float32(ts[0])
    yb, uvb = warp_band.warp_frame_band(
        c1, c2, jnp.asarray(flow), t_arg, jnp.float32(black), jnp.float32(white),
        res_scalar=rs, mode=2, is_hdr=is_hdr, dim_y=h, dim_x=w, apron=apron,
        interpret=True, raw_blend=True)
    yb, uvb = np.asarray(yb).reshape(len(ts), h, w), np.asarray(uvb).reshape(len(ts), h // 2, w)
    yt, uvt = warp_kernel.warp_frames(
        _t(y1), _t(uv1), _t(y2), _t(uv2), _t(flow), torch.tensor(ts, dtype=torch.float32),
        black, white, res_scalar=rs, mode=2, is_hdr=is_hdr, raw_blend=True)
    np.testing.assert_array_equal(yt.numpy(), yb)
    np.testing.assert_array_equal(uvt.numpy(), uvb)
    levelled = warp_kernel.warp_frames(
        _t(y1), _t(uv1), _t(y2), _t(uv2), _t(flow), torch.tensor(ts, dtype=torch.float32),
        black, white, res_scalar=rs, mode=2, is_hdr=is_hdr)
    assert not torch.equal(levelled[0], yt)


# (rs, is_hdr, h, w): every res scalar, both bit depths, widths 86 (not a
# multiple of the flow cell beyond rs 1; odd half width) and 112.
VIZ_GEOMETRIES = [(0, False, 48, 112), (1, True, 48, 86), (2, False, 50, 86),
                  (3, True, 64, 112), (2, True, 64, 112), (3, False, 50, 86)]


@pytest.mark.parametrize("rs,is_hdr,h,w", VIZ_GEOMETRIES)
def test_modes_3_to_6_match_reference_warp(rs, is_hdr, h, w):
    """warp_frame_plane's visualisation modes against the JAX package's
    jitted reference-formulation warp."""
    rng = np.random.default_rng(50 + rs + 4 * is_hdr)
    y1, uv1 = make_frame(rng, h, w, is_hdr)
    y2, uv2 = make_frame(rng, h, w, is_hdr)
    flow = make_flow(rng, -(-h >> rs), -(-w >> rs), max_mag=120)
    black, white = _levels(is_hdr)
    for mode in (3, 4, 5, 6):
        t = 0.2 + 0.2 * (mode - 3)
        yt, uvt = torch_warp.warp_frame(
            _t(y1), _t(uv1), _t(y2), _t(uv2), _t(flow), t, black, white,
            res_scalar=rs, mode=mode, is_hdr=is_hdr)
        yj, uvj = jax_warp.warp_frame(
            jnp.asarray(y1), jnp.asarray(uv1), jnp.asarray(y2), jnp.asarray(uv2),
            jnp.asarray(flow), jnp.float32(t), jnp.float32(black), jnp.float32(white),
            res_scalar=rs, mode=mode, is_hdr=is_hdr)
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj), err_msg=f"mode {mode}")
        np.testing.assert_array_equal(uvt.numpy(), np.asarray(uvj), err_msg=f"mode {mode}")


@pytest.mark.parametrize("rs", [0, 1, 2, 3])
@pytest.mark.parametrize("is_hdr", [False, True])
def test_matches_reference_warp(rng, rs, is_hdr):
    h, w = 48, 80
    y1, uv1 = make_frame(rng, h, w, is_hdr)
    y2, uv2 = make_frame(rng, h, w, is_hdr)
    flow = make_flow(rng, -(-h // (1 << rs)), -(-w // (1 << rs)), max_mag=40)
    black, white = _levels(is_hdr)
    ts = (0.0, 0.4, 0.8, 1.0)
    for mode in (0, 1, 2):
        yt, uvt = warp_kernel.warp_frames(
            _t(y1), _t(uv1), _t(y2), _t(uv2), _t(flow), torch.tensor(ts, dtype=torch.float32),
            black, white, res_scalar=rs, mode=mode, is_hdr=is_hdr)
        for i, t in enumerate(ts):
            yj, uvj = jax_warp.warp_frame(
                jnp.asarray(y1), jnp.asarray(uv1), jnp.asarray(y2), jnp.asarray(uv2),
                jnp.asarray(flow), jnp.float32(t), jnp.float32(black), jnp.float32(white),
                res_scalar=rs, mode=mode, is_hdr=is_hdr)
            np.testing.assert_array_equal(yt[i].numpy(), np.asarray(yj), err_msg=f"mode {mode} t {t}")
            np.testing.assert_array_equal(uvt[i].numpy(), np.asarray(uvj), err_msg=f"mode {mode} t {t}")


def _jax_outputs(inputs, t, case, mode):
    y1, uv1, y2, uv2, flow = (jnp.asarray(a) for a in inputs[:5])
    black, white = case.levels
    yj, uvj = jax_warp.warp_frame(y1, uv1, y2, uv2, flow, jnp.float32(t), jnp.float32(black),
                                  jnp.float32(white), res_scalar=case.rs, mode=mode,
                                  is_hdr=case.is_hdr)
    return np.asarray(yj), np.asarray(uvj)


@pytest.mark.parametrize("case", WARP_CASES, ids=lambda c: c.name)
def test_run_cases_match_reference_warp(case):
    """K2's plain version against the JAX package's jitted reference warp on
    the cases the kernel splits its paths on (tests/torch_warp_cases.py):
    smooth, constant and mirror-edge flow, ragged widths, T = 1 and 7."""
    inputs = make_inputs(case)
    black, white = case.levels
    for mode in (0, 1, 2):
        yt, uvt = warp_kernel.warp_frames(*(_t(a) for a in inputs), black, white,
                                          res_scalar=case.rs, mode=mode, is_hdr=case.is_hdr)
        for i, t in enumerate(case.ts):
            yj, uvj = _jax_outputs(inputs, t, case, mode)
            np.testing.assert_array_equal(yt[i].numpy(), yj, err_msg=f"mode {mode} t {t}")
            np.testing.assert_array_equal(uvt[i].numpy(), uvj, err_msg=f"mode {mode} t {t}")


@pytest.mark.parametrize("case", BAND_CASES, ids=lambda c: c.name)
def test_band_cases_match_reference_warp(case):
    """K2's row-band plain version on bands that cut across flow cells (n = 3
    on plane heights 3 does not divide): each shard equals its rows of the
    jitted JAX warp, zero past the plane."""
    inputs = make_inputs(case)
    black, white = case.levels
    n = case.shards
    for mode in (0, 2):
        want = [_jax_outputs(inputs, t, case, mode) for t in case.ts]
        for shard in range(n):
            got = warp_kernel.warp_frames_band(
                *(_t(a) for a in inputs), black, white, res_scalar=case.rs, mode=mode,
                is_hdr=case.is_hdr, num_shards=n, shard_index=shard)
            for plane, out in enumerate(got):
                r = out.shape[1]
                for i in range(len(case.ts)):
                    rows = want[i][plane][shard * r:(shard + 1) * r]
                    padded = np.zeros_like(out[i].numpy())
                    padded[:rows.shape[0]] = rows
                    np.testing.assert_array_equal(out[i].numpy(), padded,
                                                  err_msg=f"mode {mode} shard {shard} "
                                                          f"plane {plane} t {case.ts[i]}")


@pytest.mark.parametrize("is_hdr", [False, True])
def test_copy_frame_matches_reference(rng, is_hdr):
    y, uv = make_frame(rng, 32, 64, is_hdr)
    for black, white in ((0.0, 255.0), (16.0, 235.0), (3.0, 250.0)):
        if is_hdr:
            black, white = black * 256, white * 256
        yt, uvt = torch_warp.copy_frame(_t(y), _t(uv), black, white, is_hdr=is_hdr)
        yj, uvj = jax_warp.copy_frame(jnp.asarray(y), jnp.asarray(uv), jnp.float32(black),
                                      jnp.float32(white), is_hdr=is_hdr)
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        np.testing.assert_array_equal(uvt.numpy(), np.asarray(uvj))


def test_uv_levels_every_sample_value():
    """Every HDR and SDR sample value through the UV levels, against the JAX
    package's levels compiled as one program: pins the fused multiply-add that
    XLA makes of them (fma(q, peak, mid)). Run op by op, JAX would round
    twice."""
    levels_uv = jax.jit(jax_warp._apply_levels_uv, static_argnums=2)
    for is_hdr, n in ((False, 256), (True, 65536)):
        v = np.arange(n, dtype=np.uint16 if is_hdr else np.uint8).reshape(-1, 256)
        for white in (235.0, 255.0, 1.0, 77.0):
            wl = white * 256 if is_hdr else white
            got = torch_warp._apply_levels_uv(_t(v).to(torch.int32),
                                              torch.tensor(wl, dtype=torch.float32), is_hdr)
            want = levels_uv(jnp.asarray(v), jnp.float32(wl), is_hdr)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fma_is_single_rounding():
    """_fma_f32 rounds a*b+c once. Random operands against long double (a
    64-bit mantissa holds these sums exactly), plus a hand-made case where a
    float64 sum followed by a cast rounds twice and lands one ulp off."""
    rng = np.random.default_rng(5)
    n = 200_000
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    c = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 1e3], n)).astype(np.float32)
    exact = (a.astype(np.longdouble) * b + c).astype(np.float32)
    np.testing.assert_array_equal(torch_warp._fma_f32(_t(a), _t(b), _t(c)).numpy(), exact)
    # a*b = 2**-18 - 2**-64 sits just below half an ulp of c = 64 + 2**-17, so
    # a*b + c rounds down to c; float64 rounds the sum onto the tie, and the
    # tie then rounds to the even neighbour 64 + 2**-16.
    a1 = np.array([2.0 ** -9 * (1 + 2.0 ** -23)], np.float32)
    b1 = np.array([2.0 ** -9 * (1 - 2.0 ** -23)], np.float32)
    c1 = np.array([64 * (1 + 2.0 ** -23)], np.float32)
    assert (a1.astype(np.float64) * b1 + c1).astype(np.float32)[0] != c1[0]
    np.testing.assert_array_equal(torch_warp._fma_f32(_t(a1), _t(b1), _t(c1)).numpy(), c1)


def test_unported_modes_raise(rng):
    """Modes outside 0-6 are refused, by the plain warp and by K2, which
    computes every mode 0-6 and raw_blend for mode 2 alone."""
    y, uv = make_frame(rng, 16, 32)
    flow = make_flow(rng, 16, 32)
    args = (_t(y), _t(uv), _t(y), _t(uv), _t(flow))
    for mode in (7, -1):
        with pytest.raises(ValueError, match="mode"):
            torch_warp.warp_frame(*args, 0.5, 0.0, 255.0, res_scalar=0, mode=mode,
                                  is_hdr=False)
    for mode, raw in ((7, False), (-1, False), (1, True), (3, True), (4, True), (5, True),
                      (6, True)):
        with pytest.raises(ValueError):
            warp_kernel.warp_frames(*args, torch.tensor([0.5]), 0.0, 255.0, res_scalar=0,
                                    mode=mode, is_hdr=False, raw_blend=raw)
