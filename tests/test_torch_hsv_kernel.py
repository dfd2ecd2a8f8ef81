"""K5, the HSV flow overlay (ops/hsv_kernel.py, csrc/hsv_overlay.cu), on the
CPU: the wrapper takes its plain version for CPU tensors and counts no
launch; the plain version equals jitted JAX's hsv_flow_overlay bit for bit;
the mesh's row bands stack to the full frame; the engine replays the mode-3
golden fixture through K2's mode 3 (which colours in its epilogue, with no
K5 launch); and the colour's float32 constant table (csrc/hsv_colour.h,
shared by K5 and K2's mode 3) equals the plain version's constants. The
kernels themselves run only on the card (tests/test_torch_cuda.py -k hsv,
chip_smoke.py phases 4c and 4d)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hopperrender_tpu.ops import warp_viz as jax_viz
from hopperrender_tpu_torch.ops import hsv_kernel, warp_kernel, warp_viz
from hopperrender_tpu_torch.ops import warp as warp_ops

from test_torch_engine import FIXTURE_DIR, replay_fixture
from test_torch_viz import OVERLAY_FAULT
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

HSV_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "hopperrender_tpu_torch", "csrc", "hsv_colour.h")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _levels(is_hdr):
    s = 256.0 if is_hdr else 1.0
    return 16.0 * s, 235.0 * s


def _inputs(seed, rs, is_hdr, h, w, n_t=2, max_mag=64):
    """Raw blends (n_t, h, w) and (n_t, h/2, w) and a flow whose negated pairs
    hold none of OVERLAY_FAULT's (where the JAX overlay's Y sum differs from
    the reference warp's, which the port follows)."""
    rng = np.random.default_rng(seed)
    hi, dt = (65536, np.uint16) if is_hdr else (256, np.uint8)
    raw_y = rng.integers(0, hi, (n_t, h, w)).astype(dt)
    raw_uv = rng.integers(0, hi, (n_t, h // 2, w)).astype(dt)
    flow = rng.integers(-max_mag, max_mag + 1, (2, -(-h >> rs), -(-w >> rs))).astype(np.int16)
    flow[:, 0, :3] = ((0, 5, -32768), (0, 0, 7))   # no flow, a flat hue, the int16 wrap
    pairs = set(zip((-flow[0].astype(np.int32)).ravel(), (-flow[1].astype(np.int32)).ravel()))
    assert not pairs & set(OVERLAY_FAULT)
    return raw_y, raw_uv, flow


@pytest.mark.parametrize("rs,is_hdr,h,w", [(0, False, 24, 40), (3, True, 48, 112)])
def test_wrapper_on_the_cpu_is_the_plain_version(rs, is_hdr, h, w):
    """CPU tensors take hsv_flow_overlay_reference's bytes, and no launch is
    counted; the engine's call (ops/warp_viz.hsv_flow_overlay) goes through
    the wrapper."""
    raw_y, raw_uv, flow = (_t(a) for a in _inputs(1 + rs, rs, is_hdr, h, w))
    black, white = _levels(is_hdr)
    kw = dict(res_scalar=rs, is_hdr=is_hdr)
    before = hsv_kernel.hsv_flow_overlay.launches
    got = hsv_kernel.hsv_flow_overlay(raw_y, raw_uv, flow, black, white, **kw)
    via_viz = warp_viz.hsv_flow_overlay(raw_y, raw_uv, flow, black, white, **kw)
    want = hsv_kernel.hsv_flow_overlay_reference(raw_y, raw_uv, flow, black, white, **kw)
    assert hsv_kernel.hsv_flow_overlay.launches == before
    for g, v, wnt in zip(got, via_viz, want):
        assert g.dtype == wnt.dtype and g.shape == wnt.shape
        assert torch.equal(g, wnt) and torch.equal(v, wnt)


@pytest.mark.parametrize("rs,is_hdr,h,w", [(0, False, 24, 40), (3, True, 48, 112)])
def test_plain_version_matches_jax(rs, is_hdr, h, w):
    """hsv_flow_overlay_reference on a T = 2 batch equals jitted JAX's
    warp_viz.hsv_flow_overlay for each t, exactly: SDR at res_scalar 0
    (res_impact 4, a cell a column), HDR at res_scalar 3 (res_impact 1)."""
    raw_y, raw_uv, flow = _inputs(10 + rs, rs, is_hdr, h, w)
    black, white = _levels(is_hdr)
    kw = dict(res_scalar=rs, is_hdr=is_hdr)
    got = hsv_kernel.hsv_flow_overlay_reference(_t(raw_y), _t(raw_uv), _t(flow), black, white,
                                                **kw)
    for i in range(raw_y.shape[0]):
        want = jax_viz.hsv_flow_overlay(jnp.asarray(raw_y[i]), jnp.asarray(raw_uv[i]),
                                        jnp.asarray(flow), jnp.float32(black),
                                        jnp.float32(white), dim_y=h, dim_x=w, **kw)
        for plane, g, wnt in zip(("Y", "UV"), got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(wnt), err_msg=f"{plane} t {i}")


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("rs,is_hdr,h,w", [(1, False, 50, 86), (3, True, 50, 112)])
def test_mesh_bands_stack_to_the_full_frame(rs, is_hdr, h, w, n):
    """The mesh's route: K2's raw_blend band of each shard (its plain version
    on the CPU) coloured by the wrapper with the band's row_offsets; the
    bands stacked and cropped equal the full-frame wrapper (50 rows: UV's 25
    split unevenly, the last band padded past the plane)."""
    rng = np.random.default_rng(60 + n)
    hi, dt = (65536, np.uint16) if is_hdr else (256, np.uint8)
    srcs = [_t(rng.integers(0, hi, s).astype(dt)) for s in ((h, w), (h // 2, w)) * 2]
    flow = _t(rng.integers(-64, 65, (2, -(-h >> rs), -(-w >> rs))).astype(np.int16))
    ts = torch.tensor([0.3, 0.8], dtype=torch.float32)
    black, white = _levels(is_hdr)
    kw = dict(res_scalar=rs, is_hdr=is_hdr)
    raw = warp_kernel.warp_frames(*srcs, flow, ts, black, white, mode=2, raw_blend=True, **kw)
    full = hsv_kernel.hsv_flow_overlay(*raw, flow, black, white, **kw)
    bands = []
    for shard in range(n):
        ry, ruv = warp_kernel.warp_frames_band(*srcs, flow, ts, black, white, mode=2,
                                               raw_blend=True, num_shards=n,
                                               shard_index=shard, **kw)
        bands.append(hsv_kernel.hsv_flow_overlay(
            ry, ruv, flow, black, white, row_offsets=(shard * ry.shape[1], shard * ruv.shape[1]),
            **kw))
    for cz, plane_h in enumerate((h, h // 2)):
        stacked = torch.cat([b[cz] for b in bands], 1)
        assert stacked.shape[1] >= plane_h
        assert torch.equal(stacked[:, :plane_h], full[cz]), f"plane {cz}"


def test_engine_replays_the_mode_3_fixture_through_the_wrapper(monkeypatch):
    """The 1080p-sdr golden fixture (modes 2 and 3) through the port's engine
    on the CPU, byte for byte, with every mode-3 output made by one call of
    K2's wrapper in mode 3 (ops/warp_viz looks it up at call time), and none
    by K5's wrapper or K2's raw_blend variant: served mode 3 colours in K2's
    epilogue."""
    calls, overlays = [], []
    warp, overlay = warp_kernel.warp_frames, hsv_kernel.hsv_flow_overlay

    def spy(*args, **kwargs):
        calls.append((kwargs["mode"], kwargs.get("raw_blend", False), len(args[5])))
        return warp(*args, **kwargs)

    def overlay_spy(*args, **kwargs):
        overlays.append(args[0].shape)
        return overlay(*args, **kwargs)

    monkeypatch.setattr(warp_kernel, "warp_frames", spy)
    monkeypatch.setattr(hsv_kernel, "hsv_flow_overlay", overlay_spy)
    ys, uvs, deltas, z = replay_fixture(os.path.join(FIXTURE_DIR, "golden_1080p-sdr.npz"))
    np.testing.assert_array_equal(ys, z["out_y"])
    np.testing.assert_array_equal(uvs, z["out_uv"])
    np.testing.assert_array_equal(deltas, z["deltas"])
    # t 0.25 and 0.75 a flow, one output a call
    assert calls.count((3, False, 1)) == 2 * len(z["deltas"])
    assert not overlays and not any(raw for _, raw, _ in calls)


def test_wrapper_rejects_bad_input():
    raw_y, raw_uv, flow = (_t(a) for a in _inputs(5, 3, True, 16, 32))
    kw = dict(res_scalar=3, is_hdr=True)
    with pytest.raises(ValueError, match="uint8"):
        hsv_kernel.hsv_flow_overlay(raw_y, raw_uv, flow, 0.0, 255.0, res_scalar=3, is_hdr=False)
    with pytest.raises(ValueError, match="differ"):
        hsv_kernel.hsv_flow_overlay(raw_y, raw_uv[:1], flow, 0.0, 255.0, **kw)
    with pytest.raises(ValueError, match="int16"):
        hsv_kernel.hsv_flow_overlay(raw_y, raw_uv, flow.to(torch.int32), 0.0, 255.0, **kw)
    with pytest.raises(ValueError, match="negative"):
        hsv_kernel.hsv_flow_overlay(raw_y, raw_uv, flow, 0.0, 255.0, row_offsets=(-1, 0), **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        hsv_kernel.hsv_flow_overlay(*(a.to("meta") for a in (raw_y, raw_uv, flow)), 0.0,
                                    255.0, **kw)


# The kernel's constant table (name -> the plain version's value, as float32).
KERNEL_CONSTANTS = {
    **{f"kAtanHi{i}": v for i, v in enumerate(warp_ops._ATAN_HI)},
    **{f"kAtanLo{i}": v for i, v in enumerate(warp_ops._ATAN_LO)},
    **{f"kAt{i}": v for i, v in enumerate(warp_ops._AT)},
    "kPi": warp_ops._PI, "kPiLo": warp_ops._PI_LO, "kPiO2": warp_ops._PI_O_2,
    "kInv60": warp_ops._INV60, "kInv255": warp_ops._INV255,
    # ops/warp._visualize_flow's YUV weights
    "kYr": 0.299, "kYg": 0.587, "kYb": 0.114, "kUr": -0.168736, "kUg": -0.331264,
    "kVg": -0.418688, "kVb": -0.081312,
}


def test_kernel_constants_are_the_plain_versions():
    """Every float32 bit pattern of csrc/hsv_colour.h's table (the colour
    that K5 and K2's mode 3 include) is the float32 of the plain version's
    constant, and the table holds each of them: the kernels' arithmetic runs
    only on the card, their constants are checked here. pi, which 180/pi divides by, is ops/warp.py's float32 of
    3.14159274101257324."""
    with open(HSV_SOURCE) as f:
        table = {name: int(bits, 16) for name, bits in
                 re.findall(r"constexpr uint32_t (k\w+) = 0x([0-9A-Fa-f]{8})u;", f.read())}
    assert set(table) == set(KERNEL_CONSTANTS)
    for name, value in KERNEL_CONSTANTS.items():
        want = int(np.float32(np.float64(value)).view(np.uint32))
        assert table[name] == want, f"{name}: {table[name]:#010x} != {want:#010x}"
    assert table["kPi"] == int(np.float32(3.14159274101257324).view(np.uint32))
