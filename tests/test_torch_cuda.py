"""Kernels K1 (flow blur) and K2 (batched warp, its raw_blend variant and its
mesh-sharded row-band variant) against their plain PyTorch versions on a
CUDA card, exactly, across bit depths, res scalars, modes and ragged shapes;
the HSV colour on the card against the CPU; the mesh's dryrun and its mode-3
route on the card; and the probe kernels P1-P4 against their plain versions.
Every test skips without a card.

On the card (whose machine may lack jax, which tests/conftest.py imports):
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from hopperrender_tpu_torch.ops import blur_kernel, warp_kernel, warp_viz
from hopperrender_tpu_torch.ops import warp as warp_ops
from hopperrender_tpu_torch.probes import chain_probe, chain_probe2, gather_probe, mosaic_probe

from torch_warp_cases import BAND_CASES, WARP_CASES, make_inputs

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


@pytest.mark.parametrize("h,w,rs,is_hdr,n", [(2160, 3840, 3, True, 2), (50, 86, 1, False, 3)])
def test_mesh_mode_3_band_route_matches_the_plain_row_route(dev, h, w, rs, is_hdr, n):
    """Mode 3 on the mesh: K2's mesh-sharded raw_blend band (its own counter,
    equal to its plain version) coloured by the banded HSV overlay equals the
    plain row route (ops/warp.warp_frame_rows in mode 3) on every shard."""
    rng = np.random.default_rng(50 + n)
    srcs = _frame(rng, h, w, is_hdr, dev) + _frame(rng, h, w, is_hdr, dev)
    low = (2, -(-h // (1 << rs)), -(-w // (1 << rs)))
    flow = torch.tensor(rng.integers(-64, 65, low).astype(np.int16), device=dev)
    s = 256.0 if is_hdr else 1.0
    ts = torch.tensor([0.2, 0.6, 1.0], dtype=torch.float32, device=dev)
    kw = dict(res_scalar=rs, is_hdr=is_hdr)
    for shard in range(n):
        band = dict(num_shards=n, shard_index=shard)
        before = warp_kernel.warp_frames_band.launches, warp_kernel.warp_frames_band.raw_launches
        ry, ruv = warp_kernel.warp_frames_band(*srcs, flow, ts, 16 * s, 235 * s, mode=2,
                                               raw_blend=True, **band, **kw)
        assert (warp_kernel.warp_frames_band.launches,
                warp_kernel.warp_frames_band.raw_launches) == (before[0], before[1] + 1)
        py, puv = warp_kernel.warp_frames_band_reference(*srcs, flow, ts, 16 * s, 235 * s,
                                                         mode=2, raw_blend=True, **band, **kw)
        assert _same(ry, py) and _same(ruv, puv), f"raw band shard {shard}"
        y, uv = warp_viz.hsv_flow_overlay(ry, ruv, flow, 16 * s, 235 * s, **kw,
                                          row_offsets=(shard * ry.shape[1], shard * ruv.shape[1]))
        wy, wuv = warp_ops.warp_frame_rows(*srcs, flow, ts, 16 * s, 235 * s, mode=3, **band, **kw)
        vy, vuv = max(0, h - shard * ry.shape[1]), max(0, h // 2 - shard * ruv.shape[1])
        assert _same(y[:, :vy], wy[:, :vy]) and _same(uv[:, :vuv], wuv[:, :vuv]), f"shard {shard}"


def test_mesh_mode_3_on_the_card_matches_the_cpu(tmp_path):
    """make_multichip_step in mode 3 on a (1, 2) mesh of ranks sharing the
    card (gloo): the same outputs as the CPU ranks, through the raw_blend band
    kernel on every rank."""
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
                assert (int(z["band_raw_launches"]) > 0) == (device == "cuda")
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


@pytest.mark.parametrize("variant", chain_probe.VARIANTS)
def test_chain_probe_kernel_matches_plain(dev, variant):
    """P1 at n = 0, 1 and 600 (past the 512-entry table), on one block and on
    132; every slot equal to the plain version."""
    band = torch.from_numpy(chain_probe.make_band(np.random.default_rng(41))).to(dev)
    for name, tab in _probe_tables(chain_probe.ROWS - 16).items():
        tab = torch.from_numpy(tab).to(dev)
        for n in (0, 1, 600):
            for blocks in (1, 132):
                before = chain_probe.run.launches
                got = chain_probe.run(variant, n, tab, band, blocks=blocks)
                assert chain_probe.run.launches == before + 1
                want = chain_probe.run_reference(variant, n, tab, band, blocks=blocks)
                assert torch.equal(_u32(got), _u32(want)), f"{name} n {n} blocks {blocks}"


@pytest.mark.parametrize("variant", chain_probe2.KERNEL_VARIANTS)
def test_chain_probe2_kernel_matches_plain(dev, variant):
    rng = np.random.default_rng(42)
    band = torch.from_numpy(chain_probe.make_band(rng)).to(dev)
    residuals = {"res": rng.integers(0, 17, (8, 128), dtype=np.int32),
                 "wild res": rng.integers(-3, 21, (8, 128), dtype=np.int32)}
    for name, tab in _probe_tables(chain_probe.ROWS - 32).items():
        tab = torch.from_numpy(tab).to(dev)
        for r, res in residuals.items():
            res = torch.from_numpy(res).to(dev)
            for n in (0, 1, 600):
                for blocks in (1, 132):
                    got = chain_probe2.run(variant, n, tab, band, res, blocks=blocks)
                    want = chain_probe2.run_reference(variant, n, tab, band, res, blocks=blocks)
                    assert torch.equal(_u32(got), _u32(want)), f"{name} {r} n {n} B {blocks}"


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
