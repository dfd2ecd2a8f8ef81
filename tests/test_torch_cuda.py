"""Kernels K1 (flow blur), K2 (batched warp, its mode 3 with the HSV flow
overlay in its epilogue, its modes 4-6 (grey flow, side by side), its
raw_blend variant and its mesh-sharded row-band variant), K3 (the cost volume's window sums), K4 (the argmin and its commit)
K5 (the HSV flow overlay on a raw blend: every colour pair, the full
frame and the mesh's bands) and K6 (the levelled copy: every sample value at
the usual and the degenerate level pairs, ragged and misaligned planes, 4K,
the engine's warmup copies) against their plain PyTorch versions on a CUDA
card, exactly, across bit depths, res scalars, modes and ragged shapes (K3
and K4 over chip_smoke.py's phase 3b matrix); the pyramid on the card
against the CPU and replayed in a CUDA graph; the HSV colour on the card
against the CPU; the mesh's dryrun and its modes 3-6 on the card; the
probe kernels P1-P4 against their plain versions; the four pinned-digest
streams and the threaded pipeline served on the card. Every test skips
without a card.

On the card (whose machine may lack jax, which tests/conftest.py imports):
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import os
import sys

import numpy as np
import pytest
import torch

from hopperrender_tpu_torch.ops import (blur_kernel, copy_kernel, cost_volume_kernel, hsv_kernel,
                                        warp_kernel, warp_viz)
from hopperrender_tpu_torch.ops import warp as warp_ops
from hopperrender_tpu_torch.probes import chain_probe, chain_probe2, gather_probe, mosaic_probe
from hopperrender_tpu_torch.server import digests

from torch_warp_cases import BAND_CASES, VIZ_CASES, WARP_CASES, make_inputs

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


def _launches():
    """The launches of K1, K2 (modes 0/1/2), K3 and K4: K3's and K4's through
    their own wrappers and through flow_step, which launches both."""
    cv = cost_volume_kernel
    return (blur_kernel.blur_flow.launches, warp_kernel.warp_frames.launches,
            cv.delta_sums.launches + cv.flow_step.launches,
            cv.commit_winners.launches + cv.flow_step.launches)


def _chip_smoke():
    """chip_smoke.py from the repository root (its phase 3b holds the K3/K4
    parity matrix) and the port's modules as it imports them."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke, chip_smoke.import_port()


def _same(a, b):
    return torch.equal(a.view(torch.int16) if a.dtype == torch.uint16 else a,
                       b.view(torch.int16) if b.dtype == torch.uint16 else b)


# K1 stages tiles of 16 rows x 32 columns: planes smaller than a tile, equal
# to one, multiples of it, and not dividing it; (1, 1) and (3, 2) wrap the
# mirror.
@pytest.mark.parametrize("shape", [(1, 1), (3, 2), (11, 13), (16, 32), (32, 32), (33, 65),
                                   (34, 48), (64, 96), (270, 480)])
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


def _case_tensors(case, dev):
    return tuple(torch.from_numpy(a).to(dev) for a in make_inputs(case))


@pytest.mark.parametrize("case", WARP_CASES, ids=lambda c: c.name)
def test_warp_kernel_run_cases_match_plain(dev, case):
    """K2 on the cases it splits its paths on (tests/torch_warp_cases.py):
    modes 0/1/2 and the raw_blend variant against the plain version."""
    args = _case_tensors(case, dev)
    for mode, raw in ((0, False), (1, False), (2, False), (2, True)):
        kw = dict(res_scalar=case.rs, mode=mode, is_hdr=case.is_hdr, raw_blend=raw)
        ky, kuv = warp_kernel.warp_frames(*args, *case.levels, **kw)
        py, puv = warp_kernel.warp_frames_reference(*args, *case.levels, **kw)
        assert _same(ky, py) and _same(kuv, puv), f"mode {mode} raw {raw}"


@pytest.mark.parametrize("case", BAND_CASES, ids=lambda c: c.name)
def test_warp_band_kernel_run_cases_match_plain(dev, case):
    """K2's row band on bands across flow cells: every shard, modes 0/1/2 and
    raw_blend, against the plain band."""
    args = _case_tensors(case, dev)
    for mode, raw in ((0, False), (1, False), (2, False), (2, True)):
        kw = dict(res_scalar=case.rs, mode=mode, is_hdr=case.is_hdr, raw_blend=raw,
                  num_shards=case.shards)
        for shard in range(case.shards):
            ky, kuv = warp_kernel.warp_frames_band(*args, *case.levels, shard_index=shard, **kw)
            py, puv = warp_kernel.warp_frames_band_reference(*args, *case.levels,
                                                             shard_index=shard, **kw)
            assert _same(ky, py) and _same(kuv, puv), f"mode {mode} raw {raw} shard {shard}"


@pytest.mark.parametrize("case", WARP_CASES, ids=lambda c: c.name)
def test_warp_kernel_mode3_run_cases_match_plain(dev, case):
    """K2's mode 3 (the HSV flow overlay in its epilogue, one launch counted
    on its own counter) on the cases K2 splits its paths on, against its
    plain version (ops/warp.warp_frame in mode 3); with bands, every shard
    against the plain band."""
    args = _case_tensors(case, dev)
    kw = dict(res_scalar=case.rs, mode=3, is_hdr=case.is_hdr)
    before = warp_kernel.warp_frames.launches, warp_kernel.warp_frames.mode3_launches
    ky, kuv = warp_kernel.warp_frames(*args, *case.levels, **kw)
    assert (warp_kernel.warp_frames.launches, warp_kernel.warp_frames.mode3_launches) == \
        (before[0], before[1] + 1)
    py, puv = warp_kernel.warp_frames_reference(*args, *case.levels, **kw)
    assert _same(ky, py) and _same(kuv, puv)
    for shard in range(case.shards if case.shards > 1 else 0):
        band = dict(num_shards=case.shards, shard_index=shard)
        ky, kuv = warp_kernel.warp_frames_band(*args, *case.levels, **band, **kw)
        py, puv = warp_kernel.warp_frames_band_reference(*args, *case.levels, **band, **kw)
        assert _same(ky, py) and _same(kuv, puv), f"shard {shard}"


@pytest.mark.parametrize("case", VIZ_CASES, ids=lambda c: c.name)
def test_warp_kernel_viz_run_cases_match_plain(dev, case):
    """K2's modes 4, 5 and 6 (one launch each, counted on viz_launches) on
    the cases their tiles split on (tests/torch_warp_cases.py, VIZ_CASES:
    4K-wide strips, spans past both mirror edges at both ends of the right
    half, odd halves, every compiled width, bands across every tile kind),
    against their plain version (ops/warp.warp_frame in each mode); with
    bands, every shard against the plain band."""
    args = _case_tensors(case, dev)
    for mode in (4, 5, 6):
        kw = dict(res_scalar=case.rs, mode=mode, is_hdr=case.is_hdr)
        before = warp_kernel.warp_frames.launches, warp_kernel.warp_frames.viz_launches
        ky, kuv = warp_kernel.warp_frames(*args, *case.levels, **kw)
        assert (warp_kernel.warp_frames.launches, warp_kernel.warp_frames.viz_launches) == \
            (before[0], before[1] + 1)
        py, puv = warp_kernel.warp_frames_reference(*args, *case.levels, **kw)
        assert _same(ky, py) and _same(kuv, puv), f"mode {mode}"
        for shard in range(case.shards if case.shards > 1 else 0):
            band = dict(num_shards=case.shards, shard_index=shard)
            ky, kuv = warp_kernel.warp_frames_band(*args, *case.levels, **band, **kw)
            py, puv = warp_kernel.warp_frames_band_reference(*args, *case.levels, **band, **kw)
            assert _same(ky, py) and _same(kuv, puv), f"mode {mode} shard {shard}"


def test_warp_kernel_modes_4_to_6_match_plain(dev):
    """K2's modes 4, 5 and 6 over chip_smoke.py phase 4e's matrix: 4K HDR on
    three flows at T = 1 and 3 (and equal to the compositions they replace),
    the row bands at n = 2, 4 and 8, the small geometries (an odd half, t
    outside [0, 1], the int16 range) and rs 0 with cells to +-32767."""
    chip_smoke, port = _chip_smoke()
    err, outputs, launches = chip_smoke.viz_parity(port, dev, chip_smoke.k2_inputs(port, dev))
    assert err == 0 and outputs > 0 and launches > 0


def test_warp_kernel_mode3_matches_plain(dev):
    """K2's mode 3 over chip_smoke.py phase 4d's matrix: 4K HDR on three
    flows at T = 1 and 3 (and equal to K2 raw_blend + K5), the row bands at
    n = 2, 4 and 8, the small geometries and every (ox, oy) in +-512 at rs 0."""
    chip_smoke, port = _chip_smoke()
    err, outputs, launches = chip_smoke.mode3_parity(port, dev, chip_smoke.k2_inputs(port, dev))
    assert err == 0 and outputs > 0 and launches > 0


@pytest.mark.parametrize("is_hdr", [False, True])
def test_warp_kernel_levels_every_sample_value(dev, is_hdr):
    """Every sample value through K2's blend and levels: zero flow, the 1->2
    source holding each value once, t = 0 and 1 (the blend is then a sample)
    and 0.5; levels with fractional and inverted black and white."""
    n, w = (65536 if is_hdr else 256), 256
    h = 2 * n // w                            # Y and UV each hold every value
    planes = [(np.arange(rows * w) % n).reshape(rows, w).astype(np.uint16 if is_hdr else np.uint8)
              for rows in (h, h // 2)]
    y12, uv12, y21, uv21 = (torch.tensor(np.ascontiguousarray(p), device=dev)
                            for p in planes + [p[:, ::-1] for p in planes])
    flow = torch.zeros((2, h, w), dtype=torch.int16, device=dev)
    ts = torch.tensor([0.0, 1.0, 0.5], dtype=torch.float32, device=dev)
    s = 256.0 if is_hdr else 1.0
    for black, white in ((16.0, 235.0), (0.0, 255.0), (3.5, 250.25), (100.0, 50.0)):
        kw = dict(res_scalar=0, mode=2, is_hdr=is_hdr)
        args = (y12, uv12, y21, uv21, flow, ts, black * s, white * s)
        ky, kuv = warp_kernel.warp_frames(*args, **kw)
        py, puv = warp_kernel.warp_frames_reference(*args, **kw)
        assert _same(ky, py) and _same(kuv, puv), f"levels {black}/{white}"


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
    """Modes 3-6 through the engine on the card (K1, K2 in each mode) equal
    the same stream on the CPU; K2's mode 3 launches in mode 3 only, its
    modes 4-6 in those modes only, K2's mode 2 in none of them, and neither
    K2's raw_blend variant nor K5 in any mode. 86 wide: an odd half width
    for modes 5 and 6."""
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
        mode3_before = warp_kernel.warp_frames.mode3_launches
        viz_before = warp_kernel.warp_frames.viz_launches
        mode2_before = warp_kernel.warp_frames.launches
        raw_before = warp_kernel.warp_frames.raw_launches
        hsv_before = hsv_kernel.hsv_flow_overlay.launches
        want = engines[0].warp_frames_batch([0.4, 0.8], mode)
        got = engines[1].warp_frames_batch([0.4, 0.8], mode)
        assert (warp_kernel.warp_frames.mode3_launches > mode3_before) == (mode == 3)
        assert (warp_kernel.warp_frames.viz_launches > viz_before) == (mode != 3)
        assert warp_kernel.warp_frames.launches == mode2_before
        assert warp_kernel.warp_frames.raw_launches == raw_before
        assert hsv_kernel.hsv_flow_overlay.launches == hsv_before
        for (gy, guv), (wy, wuv) in zip(got, want):
            assert _same(gy.cpu(), wy) and _same(guv.cpu(), wuv), f"mode {mode}"


@pytest.mark.parametrize("rs", [0, 3])
@pytest.mark.parametrize("is_hdr", [False, True])
def test_hsv_kernel_every_pair_matches_plain(dev, is_hdr, rs):
    """K5 against its plain version over every (ox, oy) in +-512 as the
    colour's pair, on Y and both UV channels: res_impact 4 (rs 0) and 1 (rs
    3), chip_smoke.py phase 4c's matrix."""
    chip_smoke, port = _chip_smoke()
    err, values = chip_smoke.hsv_pair_parity(port, dev, is_hdr, rs)
    assert err == 0 and values >= 3 * 1025 * 1025


@pytest.mark.parametrize("n_t", [1, 3])
def test_hsv_kernel_4k_hdr_matches_plain(dev, n_t):
    """K5 on K2's raw blend at 4K HDR, res_scalar 3, random +-64 flow, equal
    to its plain version; one launch counted a call."""
    rng = np.random.default_rng(80 + n_t)
    h, w = 2160, 3840
    srcs = _frame(rng, h, w, True, dev) + _frame(rng, h, w, True, dev)
    flow = torch.tensor(rng.integers(-64, 65, (2, 270, 480)).astype(np.int16), device=dev)
    ts = torch.tensor([0.6, 0.2, 1.0][:n_t], dtype=torch.float32, device=dev)
    kw = dict(res_scalar=3, is_hdr=True)
    raw = warp_kernel.warp_frames(*srcs, flow, ts, 16 * 256.0, 235 * 256.0, mode=2,
                                  raw_blend=True, **kw)
    before = hsv_kernel.hsv_flow_overlay.launches
    got = hsv_kernel.hsv_flow_overlay(*raw, flow, 16 * 256.0, 235 * 256.0, **kw)
    assert hsv_kernel.hsv_flow_overlay.launches == before + 1
    want = hsv_kernel.hsv_flow_overlay_reference(*raw, flow, 16 * 256.0, 235 * 256.0, **kw)
    assert _same(got[0], want[0]) and _same(got[1], want[1])


def test_hsv_kernel_cases_match_plain(dev):
    """K5 against its plain version on chip_smoke.py's HSV_CASES: narrow runs
    (rs 1, 2), ragged rows and rows off 16 bytes, row offsets, the int16
    range, 1080p SDR."""
    chip_smoke, port = _chip_smoke()
    err, calls = chip_smoke.hsv_case_parity(port, dev)
    assert err == 0 and calls == len(chip_smoke.HSV_CASES)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("h,w,rs,is_hdr", [(2160, 3840, 3, True), (50, 86, 1, False)])
def test_hsv_kernel_bands_match_plain_and_full(dev, h, w, rs, is_hdr, n):
    """The mesh's mode 3: K5 on each shard's raw_blend band (K2's band
    kernel) with the band's row offsets equals its plain version, and the
    bands stacked and cropped equal K5 on the full frame."""
    rng = np.random.default_rng(90 + n)
    srcs = _frame(rng, h, w, is_hdr, dev) + _frame(rng, h, w, is_hdr, dev)
    low = (2, -(-h // (1 << rs)), -(-w // (1 << rs)))
    flow = torch.tensor(rng.integers(-64, 65, low).astype(np.int16), device=dev)
    s = 256.0 if is_hdr else 1.0
    ts = torch.tensor([0.2, 0.6, 1.0], dtype=torch.float32, device=dev)
    kw = dict(res_scalar=rs, is_hdr=is_hdr)
    raw = warp_kernel.warp_frames(*srcs, flow, ts, 16 * s, 235 * s, mode=2, raw_blend=True, **kw)
    full = hsv_kernel.hsv_flow_overlay(*raw, flow, 16 * s, 235 * s, **kw)
    bands = []
    for shard in range(n):
        ry, ruv = warp_kernel.warp_frames_band(*srcs, flow, ts, 16 * s, 235 * s, mode=2,
                                               raw_blend=True, num_shards=n, shard_index=shard,
                                               **kw)
        rows = (shard * ry.shape[1], shard * ruv.shape[1])
        got = hsv_kernel.hsv_flow_overlay(ry, ruv, flow, 16 * s, 235 * s, row_offsets=rows, **kw)
        want = hsv_kernel.hsv_flow_overlay_reference(ry, ruv, flow, 16 * s, 235 * s,
                                                     row_offsets=rows, **kw)
        assert _same(got[0], want[0]) and _same(got[1], want[1]), f"shard {shard}"
        bands.append(got)
    for cz, plane_h in enumerate((h, h // 2)):
        assert _same(torch.cat([b[cz] for b in bands], 1)[:, :plane_h], full[cz])


def test_hsv_kernel_rejects_bad_input(dev):
    rng = np.random.default_rng(3)
    y, uv = _frame(rng, 16, 32, True, dev)
    flow = torch.zeros((2, 2, 4), dtype=torch.int16, device=dev)
    kw = dict(res_scalar=3, is_hdr=True)
    strided = _frame(rng, 16, 64, True, dev)[0][:, ::2]     # (16, 32), every other column
    with pytest.raises(ValueError, match="contiguous"):
        hsv_kernel.hsv_flow_overlay(strided, uv, flow, 0.0, 255.0, **kw)
    with pytest.raises(ValueError, match="one device"):
        hsv_kernel.hsv_flow_overlay(y, uv, flow.cpu(), 0.0, 255.0, **kw)
    with pytest.raises(ValueError, match="uint8"):
        hsv_kernel.hsv_flow_overlay(y, uv, flow, 0.0, 255.0, res_scalar=3, is_hdr=False)


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


@pytest.mark.parametrize("radius", [5, 8, 12, 16])
@pytest.mark.parametrize("geometry", ["4K HDR", "1080p SDR"])
def test_cost_volume_kernels_match_plain(dev, geometry, radius):
    """K3 and K4 against their plain versions over chip_smoke.py's phase 3b
    matrix at one geometry and radius (every (iteration, window) of the 4K
    schedule, both steps, offsets random in +-64 and near +-32767, scalars
    8/6 and 10/10, K4 new and in place), and K3's layer shards (sp 2 and 4)
    at radius 12 and 16."""
    cs, port = _chip_smoke()
    before = _launches()
    n_k3, n_k4, err = cs.cost_volume_parity(port, dev, geometry, radius)
    assert err == 0 and (n_k3, n_k4) == (8 * 2 * 2 * 2, 8 * 2 * 2 * 2 * 2)
    after = _launches()
    assert after[2] >= before[2] + n_k3 and after[3] >= before[3] + n_k4
    if radius in (12, 16):
        n, err = cs.cost_volume_shards(port, dev, geometry, radius)
        assert err == 0 and n == 8 * 2 * (2 + 4)


@pytest.mark.parametrize("radius", [16, 5])
def test_pyramid_flow_on_the_card_matches_the_cpu(dev, radius):
    """pyramid_flow on 4K HDR panning frames at the engine's layers: on the
    card (16 steps of K3 and K4, then K1) equal to the CPU's plain run."""
    from hopperrender_tpu_torch.ops import flow as flow_ops
    from hopperrender_tpu_torch.vio import nv12

    rng = np.random.default_rng(8)
    frames = [a for i in range(2) for a in nv12.synthetic_frame(
        rng, 2160, 3840, is_hdr=True, motion_x=3 * i, coherent=True)]
    kw = dict(low_h=270, low_w=480, res_scalar=3, is_hdr=True,
              num_layers=next(b for b in (5, 8, 12, 16) if radius <= b))
    before = _launches()
    got = flow_ops.pyramid_flow(*(torch.tensor(a, device=dev) for a in frames), radius, 8, 6,
                                **kw)
    after = _launches()
    assert (after[0] - before[0], after[2] - before[2], after[3] - before[3]) == (1, 16, 16)
    want = flow_ops.pyramid_flow(*map(torch.tensor, frames), radius, 8, 6, **kw)
    for g, w, what in zip(got, want, ("offsets", "blurred", "total_delta_raw")):
        assert torch.equal(g.cpu(), w), what
    assert want[0].abs().max() > 0


def test_pyramid_replays_in_a_cuda_graph(dev):
    """pyramid_flow at 1080p SDR (16 steps of K3 and K4, then K1) captured in
    one CUDA graph: the replay equals the eager call, and after other frames
    are copied into the captured inputs, the replay equals the eager call on
    those."""
    from hopperrender_tpu_torch.ops import flow as flow_ops
    from hopperrender_tpu_torch.vio import nv12

    rng = np.random.default_rng(9)
    pairs = [[torch.tensor(a, device=dev) for i in range(2) for a in nv12.synthetic_frame(
        rng, 1080, 1920, motion_x=(2 + 3 * k) * i, coherent=True)] for k in range(2)]
    kw = dict(low_h=270, low_w=480, res_scalar=2, is_hdr=False, num_layers=16)
    inputs = [t.clone() for t in pairs[0]]
    eager = [flow_ops.pyramid_flow(*pair, 16, 8, 6, **kw) for pair in pairs]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flow_ops.pyramid_flow(*inputs, 16, 8, 6, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = flow_ops.pyramid_flow(*inputs, 16, 8, 6, **kw)
    for k, pair in enumerate(pairs):
        for t, src in zip(inputs, pair):
            t.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        for g, e, what in zip(captured, eager[k], ("offsets", "blurred", "total_delta_raw")):
            assert torch.equal(g, e), f"pair {k} {what}"
    assert not torch.equal(eager[0][0], eager[1][0])


@pytest.mark.parametrize("radius", [5, 12, 16])
@pytest.mark.parametrize("geometry", ["4K HDR", "1080p SDR"])
def test_flow_step_matches_plain(dev, geometry, radius):
    """flow_step against flow_step_reference, exactly, over every step of a
    pan's pyramid (chip_smoke.py's phase 3b): the offsets, the raw delta and
    K3's sums of each step, and the pyramid run twice gives the same bits."""
    cs, port = _chip_smoke()
    before = cost_volume_kernel.flow_step.launches
    n, err = cs.flow_step_parity(port, dev, geometry, radius)
    assert err == 0 and n == 16
    assert cost_volume_kernel.flow_step.launches == before + 2 * n


def test_delta_sums_twice_gives_the_same_bits(dev):
    """K3 on the same inputs twice, at every window of a 4K HDR schedule
    (atomics from 256 to 16, block-owned stores from 8 to 2): the same bits."""
    cs, port = _chip_smoke()
    rs, frames, offsets = cs.cost_volume_inputs(port, dev, "4K HDR")
    off = offsets["random +-64"]
    for iteration, window in port.flow_ops.window_schedule(*off.shape[1:]):
        for step in (0, 1):
            kw = dict(window_size=window, res_scalar=rs, iteration=iteration, step=step,
                      is_hdr=True)
            a = cost_volume_kernel.delta_sums(*frames, off, 16, 8, 6, **kw)
            b = cost_volume_kernel.delta_sums(*frames, off, 16, 8, 6, **kw)
            assert torch.equal(a, b), (window, step)


def test_pyramid_makes_one_flow_step_call_a_step(dev):
    """pyramid_flow on 4K HDR frames: 16 flow_step calls (K3 then K4 each)
    and one K1, no standalone K3 or K4."""
    from hopperrender_tpu_torch.ops import flow as flow_ops
    cv = cost_volume_kernel
    rng = np.random.default_rng(3)
    frames = [t for _ in range(2) for t in _frame(rng, 2160, 3840, True, dev)]
    counters = (cv.flow_step, cv.delta_sums, cv.commit_winners, blur_kernel.blur_flow)
    before = [f.launches for f in counters]
    flow_ops.pyramid_flow(*frames, 16, 8, 6, low_h=270, low_w=480, res_scalar=3, is_hdr=True)
    assert [f.launches - b for f, b in zip(counters, before)] == [16, 0, 0, 1]


def test_cost_volume_kernels_refuse_odd_or_misaligned_uv(dev):
    """U and V load as one pair: a UV row of odd width, one narrower than the
    Y row, and a UV plane off a pair's alignment raise before any launch,
    in delta_sums and when a pyramid's state is built."""
    cv = cost_volume_kernel
    rng = np.random.default_rng(5)
    y, _ = _frame(rng, 32, 63, True, dev)
    odd = torch.zeros((16, 63), dtype=torch.uint16, device=dev)
    y64, uv64 = _frame(rng, 32, 64, True, dev)
    narrow = uv64[:, :62].contiguous()
    shifted = torch.zeros(16 * 64 + 1, dtype=torch.uint16, device=dev)[1:].view(16, 64)
    off = torch.zeros((2, 32, 63), dtype=torch.int16, device=dev)
    off64 = torch.zeros((2, 32, 64), dtype=torch.int16, device=dev)
    kw = dict(window_size=16, res_scalar=0, iteration=0, step=0, is_hdr=True)
    state = dict(low_h=32, low_w=64, res_scalar=0, is_hdr=True, num_layers=16,
                 schedule=[(0, 16)])
    before = _launches()
    with pytest.raises(ValueError, match="odd or narrower"):
        cv.delta_sums(y, odd, y, odd, off, 16, 8, 6, **kw)
    with pytest.raises(ValueError, match="odd or narrower"):
        cv.delta_sums(y64, narrow, y64, narrow, off64, 16, 8, 6, **kw)
    with pytest.raises(ValueError, match="aligned"):
        cv.delta_sums(y64, shifted, y64, uv64, off64, 16, 8, 6, **kw)
    with pytest.raises(ValueError, match="odd or narrower"):
        cv.PyramidState(y, odd, y, odd, 16, 8, 6, **dict(state, low_w=63))
    with pytest.raises(ValueError, match="aligned"):
        cv.PyramidState(y64, uv64, y64, shifted, 16, 8, 6, **state)
    assert _launches() == before


def test_cost_volume_kernels_reject_bad_input(dev):
    """What the kernels do not take raises before a launch: a window that is
    not a power of two, more than 16 layers, planes of the other bit depth,
    tensors on two devices, sums of another window grid."""
    cv = cost_volume_kernel
    rng = np.random.default_rng(4)
    y, uv = _frame(rng, 32, 64, False, dev)
    off = torch.zeros((2, 32, 64), dtype=torch.int16, device=dev)
    kw = dict(res_scalar=0, iteration=0, step=0, is_hdr=False)
    before = _launches()
    with pytest.raises(ValueError, match="power of two"):
        cv.delta_sums(y, uv, y, uv, off, 8, 8, 6, window_size=6, **kw)
    with pytest.raises(ValueError, match="num_layers"):
        cv.delta_sums(y, uv, y, uv, off, 8, 8, 6, window_size=16, num_layers=17, **kw)
    with pytest.raises(ValueError, match="planes must be"):
        cv.delta_sums(y, uv, y, uv, off, 8, 8, 6, window_size=16, **dict(kw, is_hdr=True))
    with pytest.raises(ValueError, match="one device"):
        cv.delta_sums(y.cpu(), uv, y, uv, off, 8, 8, 6, window_size=16, **kw)
    assert _launches() == before
    sums = cv.delta_sums(y, uv, y, uv, off, 8, 8, 6, window_size=16, **kw)
    with pytest.raises(ValueError, match="sums"):
        cv.commit_winners(off, sums[:, :1], 8, window_size=16, step=0)
    with pytest.raises(ValueError, match="power of two"):   # sums of window 12's grid
        cv.commit_winners(off, sums.new_zeros((16, 3, 6)), 8, window_size=12, step=0)
    assert _launches()[2:] == (before[2] + 1, before[3])


def test_dryrun_multichip_on_the_card(tmp_path):
    """Two ranks of the mesh on the card (gloo on one card, NCCL on two),
    both dryrun geometries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hopperrender_tpu_torch import entry
    shapes = entry.dryrun_multichip(2, device="cuda", workdir=str(tmp_path))
    assert shapes["rs2_t3"]["y"] == (1, 1, 3, 64, 128)
    for name, got in shapes.items():   # every rank ran its flow through K3 and K4
        for kernel, per_rank in got["launches"].items():
            assert len(per_rank) == 2 and min(per_rank) > 0, (name, kernel, per_rank)


def test_entry_step_on_the_card(dev):
    """entry()'s 1080p SDR single-stream step runs through K1-K4."""
    from hopperrender_tpu_torch import entry
    fn, args = entry.entry(device=dev)
    before = _launches()
    y, uv, flow, delta = fn(*args)
    assert all(a > b for a, b in zip(_launches(), before)), (before, _launches())
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


@pytest.mark.parametrize("h,w,rs,is_hdr,n", [(2160, 3840, 3, True, 2), (50, 86, 1, False, 3)])
def test_mesh_mode_3_band_route_matches_the_plain_row_route(dev, h, w, rs, is_hdr, n):
    """Mode 3 on the mesh: K2's mesh-sharded band in mode 3 (its own counter,
    equal to its plain version) equals the plain row route
    (ops/warp.warp_frame_rows in mode 3) on every shard, padding rows 0
    included; so does the chain it replaced (the raw_blend band coloured by
    the banded HSV overlay) on the plane's rows."""
    rng = np.random.default_rng(50 + n)
    srcs = _frame(rng, h, w, is_hdr, dev) + _frame(rng, h, w, is_hdr, dev)
    low = (2, -(-h // (1 << rs)), -(-w // (1 << rs)))
    flow = torch.tensor(rng.integers(-64, 65, low).astype(np.int16), device=dev)
    s = 256.0 if is_hdr else 1.0
    ts = torch.tensor([0.2, 0.6, 1.0], dtype=torch.float32, device=dev)
    kw = dict(res_scalar=rs, is_hdr=is_hdr)
    for shard in range(n):
        band = dict(num_shards=n, shard_index=shard)
        before = warp_kernel.warp_frames_band.launches, warp_kernel.warp_frames_band.mode3_launches
        y, uv = warp_kernel.warp_frames_band(*srcs, flow, ts, 16 * s, 235 * s, mode=3, **band,
                                             **kw)
        assert (warp_kernel.warp_frames_band.launches,
                warp_kernel.warp_frames_band.mode3_launches) == (before[0], before[1] + 1)
        py, puv = warp_kernel.warp_frames_band_reference(*srcs, flow, ts, 16 * s, 235 * s,
                                                         mode=3, **band, **kw)
        assert _same(y, py) and _same(uv, puv), f"mode 3 band shard {shard}"
        wy, wuv = warp_ops.warp_frame_rows(*srcs, flow, ts, 16 * s, 235 * s, mode=3, **band, **kw)
        assert _same(y, wy) and _same(uv, wuv), f"shard {shard}"
        ry, ruv = warp_kernel.warp_frames_band(*srcs, flow, ts, 16 * s, 235 * s, mode=2,
                                               raw_blend=True, **band, **kw)
        cy, cuv = warp_viz.hsv_flow_overlay(ry, ruv, flow, 16 * s, 235 * s, **kw,
                                            row_offsets=(shard * ry.shape[1], shard * ruv.shape[1]))
        vy, vuv = max(0, h - shard * ry.shape[1]), max(0, h // 2 - shard * ruv.shape[1])
        assert _same(cy[:, :vy], y[:, :vy]) and _same(cuv[:, :vuv], uv[:, :vuv]), f"shard {shard}"


def test_mesh_mode_3_on_the_card_matches_the_cpu(tmp_path):
    """make_multichip_step in mode 3 on a (1, 2) mesh of ranks sharing the
    card (gloo): the same outputs as the CPU ranks, through the band kernel's
    mode 3 on every rank."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hopperrender_tpu_torch import entry
    from hopperrender_tpu_torch.parallel import launch
    y, uv, flow = entry.example_frames(64, 128, 16, 32, batch=1)
    in_path = str(tmp_path / "in.npz")
    np.savez(in_path, y=y, uv=uv, flow=flow, ts=np.asarray([0.375], np.float32))
    got = {}
    for device in ("cpu", "cuda"):
        job = dict(in_path=in_path, out_path=str(tmp_path / (device + ".{rank}.npz")), mode=3,
                   res_scalar=2, radius=9, delta_scalar=8, neighbor_scalar=6, black=16.0,
                   white=235.0)
        paths = [p for (p,) in launch.run_ranks(entry.run_stream_steps, 1, 2, device=device,
                                                 workdir=str(tmp_path), args=([job],),
                                                 timeout=300)]
        for path in paths:
            with np.load(path) as z:
                assert (int(z["band_mode3_launches"]) > 0) == (device == "cuda")
                assert int(z["band_launches"]) == 0
        got[device] = entry.gather_dp(paths, 2)
    for k in ("y", "uv", "blurred", "delta"):
        np.testing.assert_array_equal(got["cuda"][k], got["cpu"][k], err_msg=k)


@pytest.mark.parametrize("mode", (4, 5, 6))
def test_mesh_modes_4_to_6_on_the_card_match_the_cpu(tmp_path, mode):
    """make_multichip_step in modes 4-6 on a (1, 2) mesh of ranks sharing
    the card (gloo): the same outputs as the CPU ranks, byte for byte.
    Each mode launches K2's band in that mode once a step on every rank,
    and no band in another mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hopperrender_tpu_torch import entry
    from hopperrender_tpu_torch.parallel import launch
    y, uv, flow = entry.example_frames(64, 128, 16, 32, batch=1)
    in_path = str(tmp_path / "in.npz")
    np.savez(in_path, y=y, uv=uv, flow=flow, ts=np.asarray([0.25, 0.5, 0.75], np.float32))
    got = {}
    for device in ("cpu", "cuda"):
        job = dict(in_path=in_path, out_path=str(tmp_path / (device + ".{rank}.npz")), mode=mode,
                   res_scalar=2, radius=9, delta_scalar=8, neighbor_scalar=6, black=16.0,
                   white=235.0)
        paths = [p for (p,) in launch.run_ranks(entry.run_stream_steps, 1, 2, device=device,
                                                 workdir=str(tmp_path), args=([job],),
                                                 timeout=300)]
        for path in paths:
            with np.load(path) as z:
                launched = int(z["band_viz_launches"])
                assert launched == (1 if device == "cuda" else 0), (device, launched)
                assert int(z["band_launches"]) == int(z["band_mode3_launches"]) == 0
        got[device] = entry.gather_dp(paths, 2)
    for k in ("y", "uv", "blurred", "delta"):
        np.testing.assert_array_equal(got["cuda"][k], got["cpu"][k], err_msg=k)


def _u32(t):
    return t.view(torch.int32)


def _probe_tables(r0_high):
    """The script's table, one with crafted edge rows (the top r0, the lane
    window's clamp, every c & 3) and one outside the script's ranges."""
    rng = np.random.default_rng(40)
    script = chain_probe.make_table(rng, r0_high)
    edges = script.copy()
    edges[:, :4] = [[r0_high - 1, 0, 288, r0_high - 8], [3839, 3836, 3837, 3838], [7, 0, 1, 3]]
    wild = np.stack([rng.integers(-700, 1200, 512), rng.integers(-5000, 9000, 512),
                     rng.integers(-20, 20, 512)]).astype(np.int32)
    return {"script": script, "edges": edges, "wild": wild}


# Loop counts around the kernels' groups of 8 iterations (the remainder of
# n mod 8) and the 512-entry table's wrap.
CHAIN_NS = (0, 1, 2, 3, 7, 8, 9, 511, 512, 513, 600, 1031)


@pytest.mark.parametrize("variant", chain_probe.VARIANTS)
def test_chain_probe_kernel_matches_plain(dev, variant):
    """P1 at every n of CHAIN_NS, on one block and on 132; every slot equal
    to the plain version."""
    band = torch.from_numpy(chain_probe.make_band(np.random.default_rng(41))).to(dev)
    for name, tab in _probe_tables(chain_probe.ROWS - 16).items():
        tab = torch.from_numpy(tab).to(dev)
        for n in CHAIN_NS:
            want = chain_probe.run_reference(variant, n, tab, band)
            for blocks in (1, 132):
                before = chain_probe.run.launches
                got = chain_probe.run(variant, n, tab, band, blocks=blocks)
                assert chain_probe.run.launches == before + 1
                assert torch.equal(_u32(got), _u32(want.expand(blocks, -1, -1))), \
                    f"{name} n {n} blocks {blocks}"


@pytest.mark.parametrize("variant", chain_probe2.KERNEL_VARIANTS)
def test_chain_probe2_kernel_matches_plain(dev, variant):
    """P2 at every n of CHAIN_NS, on one block and on 132, with the script's
    residuals and residuals outside 0..16; every slot equal to the plain
    version."""
    rng = np.random.default_rng(42)
    band = torch.from_numpy(chain_probe.make_band(rng)).to(dev)
    residuals = {"res": rng.integers(0, 17, (8, 128), dtype=np.int32),
                 "wild res": rng.integers(-3, 21, (8, 128), dtype=np.int32)}
    for name, tab in _probe_tables(chain_probe.ROWS - 32).items():
        tab = torch.from_numpy(tab).to(dev)
        for r, res in residuals.items():
            res = torch.from_numpy(res).to(dev)
            for n in CHAIN_NS:
                want = chain_probe2.run_reference(variant, n, tab, band, res)
                for blocks in (1, 132):
                    before = chain_probe2.run.launches
                    got = chain_probe2.run(variant, n, tab, band, res, blocks=blocks)
                    assert chain_probe2.run.launches == before + 1
                    assert torch.equal(_u32(got), _u32(want.expand(blocks, -1, -1))), \
                        f"{name} {r} n {n} B {blocks}"


def test_chain_probe2_x17_on_a_band_off_16_bytes(dev):
    """slice_static_x17 loads and stores 16 bytes where the band and the
    output allow it; a band view one word into its storage takes the word
    loads, with the same result."""
    tab, band, res = chain_probe2.make_inputs(3, dev)
    storage = torch.empty(band.numel() + 1, dtype=torch.int32, device=dev)
    storage[1:].copy_(band.view(torch.int32).reshape(-1))
    off = storage[1:].view(torch.uint32).view(band.shape)
    assert off.data_ptr() % 16 == 4
    for n in (9, 600):
        want = chain_probe2.run_reference("slice_static_x17", n, tab, band, res, blocks=2)
        got = chain_probe2.run("slice_static_x17", n, tab, off, res, blocks=2)
        assert torch.equal(_u32(got), _u32(want)), f"n {n}"


def test_l2_read_entry_point(dev):
    """chip_smoke's L2 read rate: one call of hrt_l2_read launches once and
    every block sums the whole buffer, passes times; the rate is finite."""
    import chip_smoke

    port = chip_smoke.import_port()
    src = torch.arange(512 * 1024, dtype=torch.int32, device=dev) * 7919
    out = torch.zeros(3 * 1024, dtype=torch.int32, device=dev)
    before = chip_smoke.l2_read.launches
    chip_smoke.l2_read(port, src, out, 2, 3)
    assert chip_smoke.l2_read.launches == before + 1
    sums = out.view(3, -1).long().sum(1) & 0xFFFFFFFF
    assert sums.tolist() == [(2 * int(src.long().sum())) & 0xFFFFFFFF] * 3
    rate = chip_smoke.l2_read_rate(port, dev)
    assert np.isfinite(rate["bytes_per_s"]) and rate["bytes_per_s"] > 0


def test_transpose8_is_refused_before_a_launch(dev):
    tab, band, res = chain_probe2.make_inputs(0, dev)
    before = chain_probe2.run.launches
    with pytest.raises(TypeError, match="incompatible shapes"):
        chain_probe2.run("transpose8", 1, tab, band, res)
    assert chain_probe2.run.launches == before


@pytest.mark.parametrize("variant", gather_probe.VARIANTS)
def test_gather_probe_kernel_matches_plain(dev, variant):
    rng = np.random.default_rng(43)
    x, script_idx = gather_probe.make_inputs(dev)
    edges = rng.integers(0, 64, (8, 128), dtype=np.int32)
    edges[0, :12] = [0, 63, -1, -64, -65, 64, 248, 249, -7, -8, -263, 1000]
    for idx in (script_idx, torch.from_numpy(edges).to(dev),
                torch.from_numpy(rng.integers(-263, 249, (8, 128), dtype=np.int32)).to(dev)):
        before = gather_probe.run.launches
        got = gather_probe.run(variant, x, idx)
        assert gather_probe.run.launches == before + 1
        assert torch.equal(got, gather_probe.run_reference(variant, x, idx))


@pytest.mark.parametrize("variant", mosaic_probe.VARIANTS)
def test_mosaic_probe_kernel_matches_plain(dev, variant):
    x = torch.from_numpy(np.random.default_rng(44).integers(
        -2**31, 2**31, (128, 256), dtype=np.int32)).to(dev)
    for offsets in [(5, 128), (0, 0), (120, 127), (121, 255), (127, 256), (-1, -1), (-9, 1000),
                    (-300, 7), (17, 129), (-2**31, 2**31 - 1)]:
        idx, _ = mosaic_probe.make_inputs(offsets, dev)
        before = mosaic_probe.run.launches
        got = mosaic_probe.run(variant, idx, x)
        assert mosaic_probe.run.launches == before + 1
        assert torch.equal(got, mosaic_probe.run_reference(variant, idx, x)), f"idx {offsets}"


MOSAIC_LANES = (0, 127, 128, 255, 256, -1)


def _unaligned(t):
    """A copy of t whose data starts 4 bytes past a 16-byte boundary: the
    kernels' scalar instantiations."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 and view.is_contiguous()
    return view


def test_mosaic_probe_kernel_every_r0(dev):
    """P4's seven kernels at every r0 in [-300, 300] and lanes 0, 127, 128,
    255, 256 and -1, each equal to the plain version; at r0 = -300, 0, 7 and
    299 also from unaligned idx and x."""
    x_cpu = torch.from_numpy(np.random.default_rng(45).integers(
        -2**31, 2**31, (128, 256), dtype=np.int32))
    x = x_cpu.to(dev)
    offsets = [(r0, lane) for r0 in range(-300, 301) for lane in MOSAIC_LANES]
    idx = torch.tensor(offsets, dtype=torch.int32, device=dev)     # row k: 8-byte aligned
    odd = [k for k, (r0, _) in enumerate(offsets) if r0 in (-300, 0, 7, 299)]
    x_odd = _unaligned(x)
    for variant in mosaic_probe.VARIANTS:
        before = mosaic_probe.run.launches
        got = torch.stack([mosaic_probe.run(variant, idx[k], x) for k in range(len(offsets))])
        got_odd = torch.stack([mosaic_probe.run(variant, _unaligned(idx[k]), x_odd) for k in odd])
        assert mosaic_probe.run.launches == before + len(offsets) + len(odd)
        got, got_odd = got.cpu(), got_odd.cpu()
        for k, off in enumerate(offsets):
            want = mosaic_probe.run_reference(variant, torch.tensor(off, dtype=torch.int32), x_cpu)
            assert torch.equal(got[k], want), f"{variant} idx {off}"
        for j, k in enumerate(odd):
            want = mosaic_probe.run_reference(variant, idx[k].cpu(), x_cpu)
            assert torch.equal(got_odd[j], want), f"{variant} unaligned idx {offsets[k]}"


def test_gather_probe_kernel_every_index(dev):
    """P3's three kernels over index tiles that hold every value in [-263,
    249] (every wrap, fill and clamp of both axes), each equal to the plain
    version; the same tiles from unaligned idx."""
    x = torch.from_numpy(np.random.default_rng(46).integers(
        -2**31, 2**31, (64, 256), dtype=np.int32)).to(dev)
    values = np.arange(-263, 250, dtype=np.int32)
    tiles = [torch.from_numpy(np.resize(np.roll(values, 97 * k), (8, 128))).to(dev)
             for k in range(3)]
    for variant in gather_probe.VARIANTS:
        for t, tile in enumerate(tiles):
            want = gather_probe.run_reference(variant, x, tile)
            assert torch.equal(gather_probe.run(variant, x, tile), want), f"{variant} tile {t}"
            assert torch.equal(gather_probe.run(variant, x, _unaligned(tile)), want), \
                f"{variant} unaligned tile {t}"


def test_probe_wrappers_replay_in_a_cuda_graph(dev):
    """P3's and P4's wrappers captured into one CUDA graph: the replay equals
    the eager calls, and after new offsets are written into P4's idx in
    place, the replay reads them on the card."""
    x3, idx3 = gather_probe.make_inputs(dev)
    idx4, x4 = mosaic_probe.make_inputs((-9, 1000), dev)
    calls = ([lambda v=v: gather_probe.run(v, x3, idx3) for v in gather_probe.VARIANTS]
             + [lambda v=v: mosaic_probe.run(v, idx4, x4) for v in mosaic_probe.VARIANTS])
    eager = [call() for call in calls]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [call() for call in calls]
    graph.replay()
    torch.cuda.synchronize()
    for k, (got, want) in enumerate(zip(captured, eager)):
        assert torch.equal(got, want), f"call {k}"
    idx4.copy_(torch.tensor((121, 255), dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    for v, got in zip(mosaic_probe.VARIANTS, captured[len(gather_probe.VARIANTS):]):
        assert torch.equal(got, mosaic_probe.run(v, idx4, x4)), f"{v} after new offsets"


def test_probe_wrappers_on_a_device_that_is_not_current(dev):
    """P3 and P4 on tensors of card 1 while card 0 is current: the launch
    goes to card 1, and card 0 stays current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    other = torch.device("cuda", 1)
    x3, idx3 = gather_probe.make_inputs(other)
    idx4, x4 = mosaic_probe.make_inputs((17, 129), other)
    with torch.cuda.device(0):
        for v in gather_probe.VARIANTS:
            got = gather_probe.run(v, x3, idx3)
            assert got.device == other
            assert torch.equal(got, gather_probe.run_reference(v, x3, idx3)), v
        for v in mosaic_probe.VARIANTS:
            got = mosaic_probe.run(v, idx4, x4)
            assert got.device == other
            assert torch.equal(got, mosaic_probe.run_reference(v, idx4, x4)), v
        assert torch.cuda.current_device() == 0


@pytest.mark.parametrize("name", list(digests.STREAMS))
def test_pinned_digest_on_the_card(dev, name):
    """The pinned-digest streams of tests/fixtures/digests.json served through
    K1 and K2 on the card."""
    import json
    import os
    with open(os.path.join(os.path.dirname(__file__), "fixtures", "digests.json")) as f:
        pinned = json.load(f)[name]
    before = _launches()
    assert digests.stream_digest(name, dev) == pinned
    assert all(a > b for a, b in zip(_launches(), before)), (before, _launches())


def test_pipelined_server_on_the_card(dev):
    """PipelinedServer builds the engine and launches K1 and K2 on its engine
    thread; the stream equals the same frames served on the CPU."""
    from hopperrender_tpu_torch.config import Settings
    from hopperrender_tpu_torch.server.frame_server import FrameServer
    from hopperrender_tpu_torch.server.pipeline import PipelinedServer
    from hopperrender_tpu_torch.vio import nv12

    settings = Settings(target_fps=60.0, use_display_fps=False, auto_quality=False,
                        max_calc_res=36)
    h, w = 72, 96
    rng = np.random.default_rng(12)
    frames = [nv12.synthetic_frame(rng, h, w, motion_x=2 * i) for i in range(6)]
    import threading

    srv = FrameServer(w, h, device=dev, settings=settings)
    pipe = PipelinedServer(srv, input_slots=2, output_slots=4)
    before = _launches()

    def feed():   # on its own thread: the rings are smaller than the stream
        for y, uv in frames:
            pipe.feed(y, uv)
        pipe.close()

    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    outs = list(pipe.outputs(timeout=120))
    feeder.join(timeout=60)
    pipe.join()
    assert not feeder.is_alive()
    assert all(a > b for a, b in zip(_launches(), before)), (before, _launches())
    cpu = FrameServer(w, h, device="cpu", settings=settings)
    want = [o for y, uv in frames for o in cpu.push_frame(y, uv)]
    assert len(outs) == len(want) and any(o.interpolated for o in outs)
    for got, ref in zip(outs, want):
        assert (got.start_time, got.interpolated) == (ref.start_time, ref.interpolated)
        np.testing.assert_array_equal(got.y, ref.y)
        np.testing.assert_array_equal(got.uv, ref.uv)


@pytest.mark.parametrize("h,w,is_hdr", [(1080, 1920, False), (2160, 3840, True)],
                         ids=["1080p-sdr", "4k-hdr"])
def test_bench_units_on_the_card_match_the_cpu(dev, h, w, is_hdr):
    """The bench's units (hopperrender_tpu_torch/bench.py) on panning frames at
    radius 16: flow_unit, and warp_unit and warp_batch_unit in modes 0/1/2 with
    the CPU's flow of the pair, equal on the card and the CPU; K1-K4
    launched on the card."""
    from hopperrender_tpu_torch.engine.flow_engine import OpticalFlowEngine
    from hopperrender_tpu_torch.vio import nv12

    rng = np.random.default_rng(6)
    frames = [a for i in range(2) for a in nv12.synthetic_frame(
        rng, h, w, is_hdr=is_hdr, motion_x=3 * i, coherent=True)]
    units, flow = [], None
    before = _launches()
    for where in (torch.device("cpu"), dev):
        eng = OpticalFlowEngine(h, w, is_hdr=is_hdr, device=where, black_level=16,
                                white_level=235)
        eng.search_radius = 16
        src = [torch.tensor(a, device=where) for a in frames]
        if flow is None:
            flow = eng._run_pyramid(*src, num_layers=16)[0]
            assert flow.abs().max() > 0
        flow_unit, warp_unit, _, warp_batch_unit = eng.bench_units()
        got = {"flow": int(flow_unit(*src))}
        for mode in (0, 1, 2):
            got[f"warp {mode}"] = int(warp_unit(*src, flow.to(where), 0.4, mode=mode))
            got[f"batch {mode}"] = int(warp_batch_unit(*src, flow.to(where), (0.2, 0.6, 1.0),
                                                       mode=mode))
        units.append(got)
    assert units[1] == units[0]
    after = _launches()
    assert after[0] > before[0] and after[1] == before[1] + 6
    assert after[2] > before[2] and after[3] > before[3]


# K6's level pairs (black, white) in 8-bit units, x256 for HDR: the usual
# ones, then the degenerate ones that Settings accepts.
COPY_LEVEL_PAIRS = ((0, 255), (16, 235), (3, 250), (16, 16), (0, 0), (16, 0), (235, 16))


def _copy_levels(pair, is_hdr):
    s = 256.0 if is_hdr else 1.0
    return pair[0] * s, pair[1] * s


def _copy_check(y, uv, black, white, is_hdr):
    """One K6 call against its plain version: one launch, new planes."""
    before = copy_kernel.copy_frame.launches
    got = copy_kernel.copy_frame(y, uv, black, white, is_hdr=is_hdr)
    assert copy_kernel.copy_frame.launches == before + 1
    want = copy_kernel.copy_frame_reference(y, uv, black, white, is_hdr=is_hdr)
    for g, w, src in zip(got, want, (y, uv)):
        assert g.shape == src.shape and g.dtype == src.dtype and g.is_cuda
        assert g.data_ptr() != src.data_ptr()
        assert _same(g, w)


@pytest.mark.parametrize("pair", COPY_LEVEL_PAIRS, ids=str)
@pytest.mark.parametrize("is_hdr", [False, True])
def test_copy_kernel_every_sample_value(dev, is_hdr, pair):
    """Every sample value through K6 (Y twice, UV once) at each level pair,
    equal to the plain version on the card."""
    n = 65536 if is_hdr else 256
    y = torch.tensor((np.arange(2 * n) % n).astype(np.uint16 if is_hdr else np.uint8)
                     .reshape(-1, 256), device=dev)
    _copy_check(y, y[:y.shape[0] // 2].clone(), *_copy_levels(pair, is_hdr), is_hdr)


@pytest.mark.parametrize("h,w,is_hdr,off", [(50, 86, False, 0), (50, 86, True, 0),
                                             (50, 86, False, 1), (50, 86, True, 1),
                                             (2160, 3840, True, 0), (2160, 3840, False, 0)],
                         ids=["50x86-sdr", "50x86-hdr", "50x86-sdr-off16", "50x86-hdr-off16",
                              "4k-hdr", "4k-sdr"])
def test_copy_kernel_shapes(dev, h, w, is_hdr, off):
    """K6 on planes whose lengths are not a multiple of 16 bytes (50 x 86),
    on planes that start off 16 bytes (off: one sample into a buffer), and
    at 4K HDR and SDR."""
    rng = np.random.default_rng(h + off)
    planes = []
    for p in _frame(rng, h, w, is_hdr, dev):
        buf = torch.empty(p.numel() + off, dtype=p.dtype, device=dev)
        planes.append(buf[off:].view(p.shape))
        planes[-1].copy_(p)
    _copy_check(*planes, *_copy_levels((16, 235), is_hdr), is_hdr)


@pytest.mark.parametrize("is_hdr", [False, True])
def test_engine_copy_frame_on_the_card_matches_cpu(dev, is_hdr):
    """engine.copy_frame through warmup (the slot it copies moves as frames
    arrive) on the card equals the CPU engine; one K6 launch a copy, new
    planes, not the ring slot."""
    from hopperrender_tpu_torch.engine.flow_engine import OpticalFlowEngine
    from hopperrender_tpu_torch.vio import nv12
    h, w = 50, 86
    rng = np.random.default_rng(10)
    frames = [nv12.synthetic_frame(rng, h, w, is_hdr=is_hdr, motion_x=3 * i) for i in range(4)]
    s = 256.0 if is_hdr else 1.0
    engines = [OpticalFlowEngine(h, w, is_hdr=is_hdr, black_level=16.0 * s,
                                 white_level=235.0 * s, device=d) for d in ("cpu", dev)]
    for y, uv in frames:
        for eng in engines:
            eng.update_frame(y, uv)
        want = engines[0].copy_frame()
        before = copy_kernel.copy_frame.launches
        got = engines[1].copy_frame()
        assert copy_kernel.copy_frame.launches == before + 1
        slots = {t.data_ptr() for t in engines[1]._frames_y + engines[1]._frames_uv}
        assert not slots & {t.data_ptr() for t in got}
        assert _same(got[0].cpu(), want[0]) and _same(got[1].cpu(), want[1])


def test_copy_kernel_rejects_bad_input(dev):
    y, uv = _frame(np.random.default_rng(4), 32, 64, False, dev)
    with pytest.raises(ValueError, match="contiguous"):
        copy_kernel.copy_frame(y.t().contiguous().t(), uv, 0.0, 255.0, is_hdr=False)
    with pytest.raises(ValueError, match="one device"):
        copy_kernel.copy_frame(y, uv.cpu(), 0.0, 255.0, is_hdr=False)
    with pytest.raises(ValueError, match="uint16"):
        copy_kernel.copy_frame(y, uv, 0.0, 255.0, is_hdr=True)


@pytest.mark.parametrize("is_hdr", [False, True])
def test_warp_kernel_levels_degenerate_pairs(dev, is_hdr):
    """K2's mode 2 shares K6's clip: every sample value through its blend and
    levels (zero flow, t = 0, 1 and 0.5) at the degenerate level pairs that
    Settings accepts, equal to the plain version."""
    n, w = (65536 if is_hdr else 256), 256
    h = 2 * n // w
    planes = [(np.arange(rows * w) % n).reshape(rows, w).astype(np.uint16 if is_hdr else np.uint8)
              for rows in (h, h // 2)]
    y12, uv12, y21, uv21 = (torch.tensor(np.ascontiguousarray(p), device=dev)
                            for p in planes + [p[:, ::-1] for p in planes])
    flow = torch.zeros((2, h, w), dtype=torch.int16, device=dev)
    ts = torch.tensor([0.0, 1.0, 0.5], dtype=torch.float32, device=dev)
    for pair in COPY_LEVEL_PAIRS[3:]:
        args = (y12, uv12, y21, uv21, flow, ts, *_copy_levels(pair, is_hdr))
        kw = dict(res_scalar=0, mode=2, is_hdr=is_hdr)
        ky, kuv = warp_kernel.warp_frames(*args, **kw)
        py, puv = warp_kernel.warp_frames_reference(*args, **kw)
        assert _same(ky, py) and _same(kuv, puv), f"levels {pair}"
