"""Kernels K1 (flow blur) and K2 (batched warp, its raw_blend variant and its
mesh-sharded row-band variant) against their plain PyTorch versions on a
CUDA card, exactly, across bit depths, res scalars, modes and ragged shapes;
the HSV colour on the card against the CPU; and the mesh's dryrun on the
card. Every test skips without a card.

On the card (whose machine may lack jax, which tests/conftest.py imports):
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from hopperrender_tpu_torch.ops import blur_kernel, warp_kernel
from hopperrender_tpu_torch.ops import warp as warp_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _frame(rng, h, w, is_hdr, dev):
    hi = 65536 if is_hdr else 256
    dt = np.uint16 if is_hdr else np.uint8
    return (torch.tensor(rng.integers(0, hi, (h, w), dtype=dt), device=dev),
            torch.tensor(rng.integers(0, hi, (h // 2, w), dtype=dt), device=dev))


def _same(a, b):
    return torch.equal(a.view(torch.int16) if a.dtype == torch.uint16 else a,
                       b.view(torch.int16) if b.dtype == torch.uint16 else b)


@pytest.mark.parametrize("shape", [(3, 2), (11, 13), (34, 48), (270, 480)])
def test_blur_kernel_matches_plain(dev, shape):
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.integers(-32768, 32768, (2,) + shape).astype(np.int16), device=dev)
    before = blur_kernel.blur_flow.launches
    got = blur_kernel.blur_flow(x)
    assert blur_kernel.blur_flow.launches == before + 1
    assert torch.equal(got, blur_kernel.blur_flow_reference(x))


@pytest.mark.parametrize("is_hdr", [False, True])
@pytest.mark.parametrize("rs", [0, 1, 2, 3])
def test_warp_kernel_matches_plain(dev, is_hdr, rs):
    rng = np.random.default_rng(2 + rs)
    h, w = 50, 86                       # not multiples of the flow cell
    srcs = _frame(rng, h, w, is_hdr, dev) + _frame(rng, h, w, is_hdr, dev)
    low = (2, -(-h // (1 << rs)), -(-w // (1 << rs)))
    flow = torch.tensor(rng.integers(-70, 71, low).astype(np.int16), device=dev)
    s = 256.0 if is_hdr else 1.0
    ts = torch.tensor([0.0, 0.2, 0.4, 0.6, 0.8, 1.0, 0.3], dtype=torch.float32, device=dev)
    for mode in (0, 1, 2):
        kw = dict(res_scalar=rs, mode=mode, is_hdr=is_hdr)
        ky, kuv = warp_kernel.warp_frames(*srcs, flow, ts, 16 * s, 235 * s, **kw)
        py, puv = warp_kernel.warp_frames_reference(*srcs, flow, ts, 16 * s, 235 * s, **kw)
        assert _same(ky, py) and _same(kuv, puv), f"mode {mode}"


@pytest.mark.parametrize("is_hdr", [False, True])
@pytest.mark.parametrize("rs", [0, 3])
def test_warp_kernel_raw_blend_matches_plain(dev, is_hdr, rs):
    """The raw_blend variant (mode 2's blend, no levels) and its own counter."""
    rng = np.random.default_rng(20 + rs)
    h, w = 50, 86
    srcs = _frame(rng, h, w, is_hdr, dev) + _frame(rng, h, w, is_hdr, dev)
    low = (2, -(-h // (1 << rs)), -(-w // (1 << rs)))
    flow = torch.tensor(rng.integers(-70, 71, low).astype(np.int16), device=dev)
    s = 256.0 if is_hdr else 1.0
    ts = torch.tensor([0.0, 0.2, 0.6, 1.0, 0.3], dtype=torch.float32, device=dev)
    kw = dict(res_scalar=rs, mode=2, is_hdr=is_hdr, raw_blend=True)
    before = warp_kernel.warp_frames.launches, warp_kernel.warp_frames.raw_launches
    ky, kuv = warp_kernel.warp_frames(*srcs, flow, ts, 16 * s, 235 * s, **kw)
    assert (warp_kernel.warp_frames.launches, warp_kernel.warp_frames.raw_launches) == \
        (before[0], before[1] + 1)
    py, puv = warp_kernel.warp_frames_reference(*srcs, flow, ts, 16 * s, 235 * s, **kw)
    assert _same(ky, py) and _same(kuv, puv)


@pytest.mark.parametrize("is_hdr", [False, True])
def test_visualize_flow_cuda_matches_cpu(dev, is_hdr):
    """The HSV colour's float steps give the same bits on the card as on the
    CPU (where tests/test_torch_viz.py holds them to jitted JAX)."""
    v = torch.arange(-512, 513, dtype=torch.int16)
    ox, oy = (a.reshape(-1) for a in torch.meshgrid(v, v, indexing="xy"))
    curr = torch.randint(0, 65536 if is_hdr else 256, ox.shape, dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    for impact in (1, 4):
        for channel in (0, 1, 2):
            chan = torch.full(ox.shape, channel, dtype=torch.int32)
            args = (ox, oy, curr, chan)
            cpu = warp_ops._visualize_flow(*args, impact, is_hdr)
            gpu = warp_ops._visualize_flow(*(a.to(dev) for a in args), impact, is_hdr)
            assert torch.equal(gpu.cpu(), cpu), f"res_impact {impact} channel {channel}"


@pytest.mark.parametrize("is_hdr", [False, True])
def test_engine_viz_modes_match_cpu(dev, is_hdr):
    """Modes 3-6 through the engine on the card (K1, K2, its raw_blend
    variant and the compositions of ops/warp_viz.py) equal the same stream
    on the CPU. 86 wide: an odd half width for mode 6."""
    from hopperrender_tpu_torch.engine.flow_engine import OpticalFlowEngine
    from hopperrender_tpu_torch.vio import nv12
    h, w = 50, 86
    rng = np.random.default_rng(9)
    frames = [nv12.synthetic_frame(rng, h, w, is_hdr=is_hdr, motion_x=3 * i) for i in range(4)]
    engines = [OpticalFlowEngine(h, w, is_hdr=is_hdr, black_level=16.0, white_level=235.0,
                                 device=d) for d in ("cpu", dev)]
    for eng in engines:
        eng.search_radius = 8
        for y, uv in frames:
            eng.update_frame(y, uv)
            if eng.frame_count >= 3:
                eng.calculate_optical_flow()
    for mode in (3, 4, 5, 6):
        raw_before = warp_kernel.warp_frames.raw_launches
        want = engines[0].warp_frames_batch([0.4, 0.8], mode)
        got = engines[1].warp_frames_batch([0.4, 0.8], mode)
        assert (warp_kernel.warp_frames.raw_launches > raw_before) == (mode == 3)
        for (gy, guv), (wy, wuv) in zip(got, want):
            assert _same(gy.cpu(), wy) and _same(guv.cpu(), wuv), f"mode {mode}"


# (h, w, rs, is_hdr, n): 4K HDR split in two, and 1080p SDR in eight (UV's
# 540 rows do not split evenly: 68-row bands, the last one 64 rows).
@pytest.mark.parametrize("h,w,rs,is_hdr,n", [(2160, 3840, 3, True, 2), (1080, 1920, 2, False, 8)])
def test_warp_band_kernel_matches_plain_and_full(dev, h, w, rs, is_hdr, n):
    """K2's mesh-sharded variant: every shard equals its plain version, and
    the shards stacked and cropped equal the full-frame K2; its own counter."""
    rng = np.random.default_rng(30 + n)
    srcs = _frame(rng, h, w, is_hdr, dev) + _frame(rng, h, w, is_hdr, dev)
    flow = torch.tensor(rng.integers(-64, 65, (2, h >> rs, w >> rs)).astype(np.int16), device=dev)
    s = 256.0 if is_hdr else 1.0
    ts = torch.tensor([0.2, 0.6, 1.0], dtype=torch.float32, device=dev)
    for mode in (0, 1, 2):
        kw = dict(res_scalar=rs, mode=mode, is_hdr=is_hdr)
        full_y, full_uv = warp_kernel.warp_frames(*srcs, flow, ts, 16 * s, 235 * s, **kw)
        bands = []
        for shard in range(n):
            before = warp_kernel.warp_frames_band.launches
            by, buv = warp_kernel.warp_frames_band(*srcs, flow, ts, 16 * s, 235 * s,
                                                   num_shards=n, shard_index=shard, **kw)
            assert warp_kernel.warp_frames_band.launches == before + 1
            py, puv = warp_kernel.warp_frames_band_reference(
                *srcs, flow, ts, 16 * s, 235 * s, num_shards=n, shard_index=shard, **kw)
            assert _same(by, py) and _same(buv, puv), f"mode {mode} shard {shard}"
            bands.append((by, buv))
        got_y = torch.cat([warp_ops.to_int32(b[0]) for b in bands], 1)[:, :h]
        got_uv = torch.cat([warp_ops.to_int32(b[1]) for b in bands], 1)[:, :h // 2]
        assert torch.equal(got_y, warp_ops.to_int32(full_y)), f"mode {mode}"
        assert torch.equal(got_uv, warp_ops.to_int32(full_uv)), f"mode {mode}"


def test_dryrun_multichip_on_the_card(tmp_path):
    """Two ranks of the mesh on the card (gloo on one card, NCCL on two),
    both dryrun geometries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hopperrender_tpu_torch import entry
    shapes = entry.dryrun_multichip(2, device="cuda", workdir=str(tmp_path))
    assert shapes["rs2_t3"]["y"] == (1, 1, 3, 64, 128)


def test_entry_step_on_the_card(dev):
    """entry()'s 1080p SDR single-stream step runs through K1 and K2."""
    from hopperrender_tpu_torch import entry
    fn, args = entry.entry(device=dev)
    before = blur_kernel.blur_flow.launches, warp_kernel.warp_frames.launches
    y, uv, flow, delta = fn(*args)
    assert blur_kernel.blur_flow.launches > before[0]
    assert warp_kernel.warp_frames.launches > before[1]
    assert tuple(y.shape) == (1, 1080, 1920) and tuple(uv.shape) == (1, 540, 1920)
    assert tuple(flow.shape) == (1, 2, 270, 480) and tuple(delta.shape) == (1,)


def test_warp_kernel_rejects_bad_input(dev):
    rng = np.random.default_rng(3)
    y, uv = _frame(rng, 32, 64, False, dev)
    flow = torch.zeros((2, 32, 64), dtype=torch.int16, device=dev)
    ts = torch.tensor([0.5], device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        warp_kernel.warp_frames(y, uv, y, uv, flow.transpose(1, 2).contiguous().transpose(1, 2),
                                ts, 0.0, 255.0, res_scalar=0, mode=2, is_hdr=False)
    with pytest.raises(ValueError, match="one device"):
        warp_kernel.warp_frames(y, uv, y.cpu(), uv, flow, ts, 0.0, 255.0, res_scalar=0,
                                mode=2, is_hdr=False)
    with pytest.raises(ValueError, match="uint16"):
        warp_kernel.warp_frames(y, uv, y, uv, flow, ts, 0.0, 255.0, res_scalar=0, mode=2,
                                is_hdr=True)
