"""The primitive probes P1-P4 of the port (hopperrender_tpu_torch/probes/)
against the TPU kernels of scripts/, run in Pallas interpret mode on the CPU:
every traceable variant bit for bit, at loop counts 0, 1, 5 and 513 (past
the 512-entry table), on the scripts' inputs, on tables with crafted edge
rows (the top r0, whose 256-row window start clamps; the lane-window clamp;
every byte offset c & 3), and on tables and offsets outside the scripts'
ranges, where interpret mode normalises and clamps every window start.
transpose8 is refused by both sides. Then the probe path
(`python -m hopperrender_tpu_torch.probes`) and the slope timer.

The scripts are reached without editing them: P1/P2's pallas_call is built
from each script's make_kernel with its in_specs and interpret=True; P3's
kernels are closures, caught through a stand-in for the script's `pl`; P4's
module runs its probes when imported, so only its imports and defs are
executed.
"""

import ast
import functools
import importlib.util
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hopperrender_tpu_torch import _build
from hopperrender_tpu_torch.probes import __main__ as probe_path
from hopperrender_tpu_torch.probes import _timing, chain_probe, chain_probe2, gather_probe
from hopperrender_tpu_torch.probes import mosaic_probe

from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
NS = (0, 1, 5, 513)
SMEM, VMEM = pltpu.SMEM, pltpu.VMEM


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _chain_kernel(script, variant):
    """The script's kernel for `variant`, with its own in_specs, in interpret mode."""
    mod = _load_script(script)
    n_in = 3 if script == "chain_probe" else 4
    return jax.jit(pl.pallas_call(
        mod.make_kernel(variant),
        in_specs=([pl.BlockSpec(memory_space=SMEM)] * 2
                  + [pl.BlockSpec(memory_space=VMEM)] * (n_in - 2)),
        out_specs=pl.BlockSpec(memory_space=VMEM),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.uint32), interpret=True))


def _edge_table(rng, r0_top):
    """A table in the script's ranges whose first rows are crafted: r0 at its
    top (the R = 256 gather window clamps its start) and near 0, c at the top
    of its range (the lane window clamps to 768) with every c & 3, c at the
    lane-window steps, every t_sub."""
    tab = chain_probe.make_table(rng, r0_high=r0_top + 1)
    rows = [(r0_top, 3839, 7), (r0_top - 7, 3836, 0), (0, 3837, 1), (288, 3838, 3),
            (r0_top, 511, 5), (7, 512, 6), (255, 0, 2), (256, 2, 4), (r0_top - 1, 1, 7)]
    for j, (r0, c, t) in enumerate(rows):
        tab[:, j] = (r0, c, t)
    return tab


def _wild_table(rng):
    """Values outside the script's ranges, negative ones too: interpret mode
    normalises and clamps every window start."""
    t = chain_probe.T
    return np.stack([rng.integers(-700, 1200, t), rng.integers(-5000, 9000, t),
                     rng.integers(-20, 20, t)]).astype(np.int32)


def _tables(r0_high):
    rng = np.random.default_rng(11)
    return {"script": chain_probe.make_table(rng, r0_high),
            "edges": _edge_table(rng, r0_high - 1), "wild": _wild_table(rng)}


def _band():
    return chain_probe.make_band(np.random.default_rng(12))


def _same_slots(got, want, what):
    """Every (8, 128) slot of the port's (blocks, 8, 128) output equals JAX's."""
    got = got.numpy()
    for b in range(got.shape[0]):
        np.testing.assert_array_equal(got[b], want, err_msg=f"{what} slot {b}")


@pytest.mark.parametrize("variant", chain_probe.VARIANTS)
def test_chain_probe_matches_the_tpu_kernel(variant):
    band = _band()
    kernel = _chain_kernel("chain_probe", variant)
    launches = chain_probe.run.launches
    for name, tab in _tables(chain_probe.ROWS - 16).items():
        for n in NS:
            want = np.asarray(kernel(np.full((1, 1), n, np.int32), tab, band))
            got = chain_probe.run(variant, n, torch.from_numpy(tab), torch.from_numpy(band),
                                  blocks=2)
            assert got.shape == (2, 8, 128) and got.dtype == torch.uint32
            _same_slots(got, want, f"{variant} {name} n {n}")
    assert chain_probe.run.launches == launches      # CPU tensors: the plain version


@pytest.mark.parametrize("variant", chain_probe2.KERNEL_VARIANTS)
def test_chain_probe2_matches_the_tpu_kernel(variant):
    band = _band()
    rng = np.random.default_rng(13)
    residuals = {"res": rng.integers(0, chain_probe2.KV, (8, 128), dtype=np.int32)}
    if variant in ("vsel_x17", "fastpath_tile"):      # the variants that read res
        residuals["wild res"] = rng.integers(-3, 21, (8, 128), dtype=np.int32)
    kernel = _chain_kernel("chain_probe2", variant)
    for name, tab in _tables(chain_probe.ROWS - 32).items():
        for r, res in residuals.items():
            for n in NS:
                want = np.asarray(kernel(np.full((1, 1), n, np.int32), tab, band, res))
                got = chain_probe2.run(variant, n, torch.from_numpy(tab), torch.from_numpy(band),
                                       torch.from_numpy(res), blocks=3)
                _same_slots(got, want, f"{variant} {name} {r} n {n}")


def test_the_256_row_gather_window_clamps_as_in_interpret_mode():
    """The script's own table runs dyngather_ax0_256's window past the band
    (r0 = 479: ra & ~31 = 448, and 448 + 256 > 512): interpret mode reads
    rows from 256, and so does the port."""
    band = _band()
    tab = _edge_table(np.random.default_rng(14), chain_probe.ROWS - 33)
    assert (tab[0, 0] & ~7 & ~31) + 256 > chain_probe.ROWS
    res = np.zeros((8, 128), np.int32)
    args = [torch.from_numpy(a) for a in (tab, band, res)]
    got = chain_probe2.run("dyngather_ax0_256", 1, *args)[0].numpy()
    s, l = np.arange(8)[:, None], np.arange(128)[None, :]
    r0, la = int(tab[0, 0]), min((int(tab[1, 0]) >> 2) & ~127, 768)
    np.testing.assert_array_equal(got, band[256 + (s + l + r0) % 256, la + l])


def test_transpose8_is_refused_on_both_sides():
    """The JAX kernel does not trace (an (8, 128) XOR an (8, 8)); the port
    refuses it the same way, before any launch, in the wrapper, the plain
    version and the probe path."""
    tab, band, res = chain_probe2.make_inputs(0)
    with pytest.raises(TypeError, match="incompatible shapes for broadcasting"):
        _chain_kernel("chain_probe2", "transpose8")(np.full((1, 1), 1, np.int32), tab.numpy(),
                                                    band.numpy(), res.numpy())
    launches = chain_probe2.run.launches
    for fn in (chain_probe2.run, chain_probe2.run_reference):
        with pytest.raises(TypeError, match="incompatible shapes for broadcasting"):
            fn("transpose8", 1, tab, band, res)
    assert chain_probe2.run.launches == launches
    [result] = probe_path.run_probe("chain2", ["transpose8"], device="cpu", n1=1, n2=2)
    assert result.line.split()[1:3] == ["FAIL", "TypeError:"] and result.expected_failure
    assert result.slope is None


def _gather_kernels():
    """P3's three interpret-mode kernels, by name, caught as the script's
    probe_mosaic_vector_ops builds them through a stand-in for its `pl`."""
    mod = _load_script("gather_probe")
    caught = []

    def pallas_call(kernel, **kw):
        call = jax.jit(pl.pallas_call(kernel, interpret=True, **kw))
        caught.append(call)
        return call

    mod.pl = types.SimpleNamespace(BlockSpec=pl.BlockSpec, pallas_call=pallas_call)
    mod.probe_mosaic_vector_ops()
    return dict(zip(gather_probe.VARIANTS, caught))


def _gather_indices():
    rng = np.random.default_rng(15)
    _, script_idx = gather_probe.make_inputs()
    edges = rng.integers(0, 64, (8, 128), dtype=np.int32)
    edges[0, :12] = [0, 63, -1, -64, -65, 64, 248, 249, -7, -8, -263, 1000]
    return {"script": script_idx.numpy(),
            "in range": rng.integers(0, 64, (8, 128), dtype=np.int32),
            "lane range": rng.integers(-263, 249, (8, 128), dtype=np.int32),
            "out of range": edges}


@pytest.mark.parametrize("variant", gather_probe.VARIANTS)
def test_gather_probe_matches_the_tpu_kernel(variant):
    kernel = _gather_kernels()[variant]
    xs = {"script": gather_probe.make_inputs()[0].numpy(),
          "random": np.random.default_rng(16).integers(-2**31, 2**31, (64, 256), dtype=np.int32)}
    for xname, x in xs.items():
        for iname, idx in _gather_indices().items():
            want = np.asarray(kernel(x, idx))
            got = gather_probe.run(variant, torch.from_numpy(x), torch.from_numpy(idx))
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{variant} {xname} {iname}")


def _mosaic_kernels():
    """P4's kernels k_dyn_*, from the script's imports and defs only:
    importing it would run its probes."""
    path = os.path.join(SCRIPTS, "mosaic_probe.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    keep = (ast.Import, ast.ImportFrom, ast.FunctionDef)
    tree.body = [n for n in tree.body if isinstance(n, keep)]
    ns = {}
    exec(compile(tree, path, "exec"), ns)
    return ns


MOSAIC_IDX = [(5, 128), (0, 0), (120, 127), (121, 255), (127, 256), (200, 300), (-1, -1),
              (-5, -129), (-9, 1000), (-300, 7), (17, 129), (255, -256), (-2**31, 2**31 - 1)]


@pytest.mark.parametrize("variant", mosaic_probe.VARIANTS)
def test_mosaic_probe_matches_the_tpu_kernel(variant):
    """Every variant at the script's offsets and at offsets whose windows
    clamp (r0 > 120, r0 < 0, a lane start past 0) or whose rolls wrap."""
    kernel = jax.jit(pl.pallas_call(
        _mosaic_kernels()[f"k_{variant}"],
        in_specs=[pl.BlockSpec(memory_space=SMEM), pl.BlockSpec(memory_space=VMEM)],
        out_specs=pl.BlockSpec(memory_space=VMEM),
        out_shape=jax.ShapeDtypeStruct((8, 256), jnp.int32), interpret=True))
    x = np.random.default_rng(17).integers(-2**31, 2**31, (128, 256), dtype=np.int32)
    for offsets in MOSAIC_IDX:
        idx, _ = mosaic_probe.make_inputs(offsets)
        want = np.asarray(kernel(idx.numpy(), x))
        got = mosaic_probe.run(variant, idx, torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{variant} idx {offsets}")


def _window_start(start, dim, size):
    return min(max(start + dim if start < 0 else start, 0), dim - size)


def _brute_words(variant, r0, c):
    """The flat band index of every word one iteration of `variant` reads at
    table entry (r0, c), from the closed forms of the TPU kernels."""
    s, l = np.meshgrid(np.arange(8), np.arange(128), indexing="ij")
    c32 = c >> 2
    la, ra = min(c32 & ~127, 768), r0 & ~7
    rows8 = _window_start(ra, 512, 8) + s
    if variant == "load8x128":
        rows, lanes = rows8, _window_start(la, 1024, 128) + l
    elif variant == "roll1":
        rows, lanes = rows8, _window_start(la, 1024, 256) + ((l + c32 - la) & 255)
    elif variant == "slice_static_x17":
        rows = rows8[..., None]
        lanes = _window_start(la, 1024, 256) + 8 + l[..., None] + np.arange(17)
    else:   # dyngather_ax0_256
        rows = _window_start(ra & ~31, 512, 256) + ((s + l + r0) & 255)
        lanes = _window_start(la, 1024, 128) + l
    return (rows * 1024 + lanes).ravel()


# (probe, variant, table entries (r0, c, t_sub), what each iteration's count must be)
L2_CASES = [
    ("chain_probe", "load8x128", [(40, 4 * 256, 0)], lambda k: k == 128),   # aligned: 8 x 16
    ("chain_probe", "roll1", [(40, 4 * 259, 0), (8, 4 * 264, 0), (0, 0, 0)],
     lambda k: k >= 128),                       # a lane shift of 3 crosses sectors: 8 x 17
    ("chain_probe2", "slice_static_x17", [(40, 4 * 256, 0), (479, 3839, 0)],
     lambda k: k in (8 * 18, 8 * 19)),          # one row's 144 words
    ("chain_probe2", "dyngather_ax0_256", [(100, 4 * 300, 0), (479, 0, 0)],
     lambda k: 128 < k <= 8 * 128),             # its diagonal rows
]


@pytest.mark.parametrize("name,variant,entries,expect", L2_CASES,
                         ids=[c[1] for c in L2_CASES])
def test_l2_sectors_match_a_brute_force_count(name, variant, entries, expect):
    """chip_smoke's L2 term of P1/P2: the distinct 32-byte sectors each
    iteration reads, counted from the plain version, equal a count over the
    closed forms of hand-made tables of 1-3 iterations; the bytes are 32 per
    sector per block."""
    import chip_smoke

    port = chip_smoke.import_port()
    tab = np.zeros((3, chain_probe.T), np.int32)
    for j, entry in enumerate(entries):
        tab[:, j] = entry
    inputs = (torch.from_numpy(tab), torch.from_numpy(_band()))
    if name == "chain_probe2":
        inputs += (torch.zeros(chain_probe.TILE, dtype=torch.int32),)
    n = len(entries)
    got = chip_smoke.probe_sectors(port, name, variant, inputs, n).tolist()
    brute = [len({int(w) >> 3 for w in _brute_words(variant, r0, c)}) for r0, c, _ in entries]
    assert got == brute
    assert all(expect(k) for k in got), got
    if variant == "roll1":
        assert got[0] > 128
    one = chip_smoke.probe_l2_bytes(port, name, variant, inputs, n, 1)
    assert one == 32 * sum(brute)
    assert chip_smoke.probe_l2_bytes(port, name, variant, inputs, n, 132) == 132 * one


def test_wrappers_check_their_inputs():
    tab, band = chain_probe.make_inputs(0)
    with pytest.raises(ValueError, match="unknown variant"):
        chain_probe.run("nope", 1, tab, band)
    with pytest.raises(ValueError, match="band"):
        chain_probe.run("full", 1, tab, band.view(torch.int32))
    with pytest.raises(ValueError, match="n = -1"):
        chain_probe.run("full", -1, tab, band)
    with pytest.raises(ValueError, match="unsupported device"):
        chain_probe.run("full", 1, tab.to("meta"), band.to("meta"))
    tab2, band2, res = chain_probe2.make_inputs(0)
    with pytest.raises(ValueError, match="res"):
        chain_probe2.run("vsel_x17", 1, tab2, band2, res[:4])
    x, idx = gather_probe.make_inputs()
    with pytest.raises(ValueError, match="idx"):
        gather_probe.run("vector_index", x, idx.long())
    midx, mx = mosaic_probe.make_inputs()
    with pytest.raises(ValueError, match="unsupported device"):
        mosaic_probe.run("dyn_both", midx.to("meta"), mx.to("meta"))


def test_probe_wrappers_on_the_cpu_never_load_the_library(monkeypatch):
    """P3 and P4 on CPU tensors take their plain versions and never ask for
    the kernel library, its entry points or a launch."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel library was asked for")

    for name in ("load", "entry", "launch"):
        monkeypatch.setattr(_build, name, refuse)
    launches = gather_probe.run.launches, mosaic_probe.run.launches
    x, idx = gather_probe.make_inputs()
    for variant in gather_probe.VARIANTS:
        assert torch.equal(gather_probe.run(variant, x, idx),
                           gather_probe.run_reference(variant, x, idx))
    idx4, x4 = mosaic_probe.make_inputs((-9, 1000))
    for variant in mosaic_probe.VARIANTS:
        assert torch.equal(mosaic_probe.run(variant, idx4, x4),
                           mosaic_probe.run_reference(variant, idx4, x4))
    assert (gather_probe.run.launches, mosaic_probe.run.launches) == launches


def test_block_gather_chain_sums_the_gathered_first_words():
    """The XLA half of P3 as plain PyTorch: k chained gathers; one gather's
    sum recomputed from its indices."""
    plane = gather_probe.make_plane(0)[:64]
    base, shift = gather_probe.block_gather_indices((64, 1024), g32=4, n_idx=100, k=3)
    got = gather_probe.block_gather_chain(plane, 0, base[:1], shift[:1], g32=4)
    gen = torch.Generator().manual_seed(0)
    ri = torch.randint(0, 64, (100,), generator=gen)
    bi = torch.randint(0, 256, (100,), generator=gen)
    words = plane.reshape(64, 256, 4)[ri, bi, 0].long() & 0xFFFFFFFF
    assert int(got) == int(words.sum()) & 0xFFFFFFFF
    # An odd salt moves every row down one, but the last: the script's clip.
    moved = plane.reshape(64, 256, 4)[(ri + 1).clamp(max=63), bi, 0].long() & 0xFFFFFFFF
    odd = gather_probe.block_gather_chain(plane, 1, base[:1], shift[:1], g32=4)
    assert int(odd) == (1 + int(moved.sum())) & 0xFFFFFFFF
    three = gather_probe.block_gather_chain(plane, 0, base, shift, g32=4)
    assert int(three) != int(got)
    runner = gather_probe.block_gather_runner(plane, g32=4, n_idx=100, k_max=3)
    assert int(runner(1)) == int(got) and int(runner(3)) == int(three)


@pytest.mark.parametrize("probe,variants", [
    ("chain", ["full", "roll1"]), ("chain2", ["fastpath_tile", "transpose8"]),
    ("gather", ["take_along_lane", "block8"]), ("mosaic", ["dyn_sublane_16"])])
def test_probe_path_prints_one_line_per_variant(capsys, probe, variants):
    assert probe_path.main([probe, *variants, "--device", "cpu", "--n1", "1", "--n2", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu") and len(lines) == 1 + len(variants)
    for line, variant in zip(lines[1:], variants):
        if variant == "transpose8":
            assert "FAIL TypeError" in line
        elif variant.startswith("block"):
            assert line.startswith(f"block gather {int(variant[5:]):4d} B:") and "ns/idx" in line
        else:
            assert line.split()[0] == variant and f"ns/{probe_path.UNIT[probe]}" in line
            assert "(t1=" in line and " t3=" in line


def test_probe_path_results_carry_their_two_times():
    """run_probe's Result carries its slope: the two times its line prints,
    which chip_smoke's check that P1's and P2's time grows with n reads."""
    [result] = probe_path.run_probe("chain2", ["slice_static"], device="cpu", n1=1, n2=3)
    sl = result.slope
    assert (sl.n1, sl.n2) == (1, 3) and 0 < sl.t1_s and 0 < sl.t2_s
    assert f"(t1={sl.t1_s * 1e3:.3f}ms t3={sl.t2_s * 1e3:.3f}ms)" in result.line


def test_probe_path_fails_on_a_failing_variant(capsys):
    assert probe_path.main(["mosaic", "dyn_nothing", "dyn_both", "--device", "cpu",
                            "--n1", "1", "--n2", "2"]) == 1
    lines = capsys.readouterr().out.splitlines()
    assert "FAIL ValueError" in lines[1] and lines[2].startswith("dyn_both")


def test_probe_path_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_path.main(["chain", "full"])


def test_probe_path_as_a_module():
    """`python -m hopperrender_tpu_torch.probes` end to end on the CPU (its
    refusal without a card: test_probe_path_raises_without_a_card)."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env.update(PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "hopperrender_tpu_torch.probes", "chain2", "vsel_x17",
           "--device", "cpu", "--n1", "2", "--n2", "4"]
    ok = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0, ok.stderr
    assert ok.stdout.splitlines()[1].startswith("vsel_x17") and "ns/iter" in ok.stdout


def test_slope_and_the_sm_clock(monkeypatch):
    sl = _timing.Slope(n1=10, n2=30, t1_s=0.5, t2_s=1.5)
    assert sl.per_s == 0.05
    calls = []
    got = _timing.slope(lambda n: calls.append(n), 2, 5, torch.device("cpu"))
    assert calls == [2] * 4 + [5] * 4 and got.n1 == 2 and got.n2 == 5
    with pytest.raises(ValueError):
        _timing.slope(lambda n: None, 5, 5, torch.device("cpu"))
    assert got.sm_hz is None     # the CPU reads no clock
    asked = []

    def smi(cmd, **kwargs):
        asked.append(cmd)
        return types.SimpleNamespace(stdout="1980 MHz\n")
    monkeypatch.setattr(_timing.subprocess, "run", smi)
    assert _timing.sm_clock_hz() == 1.98e9
    assert _timing.sm_clock_hz("clocks.sm", 1) == 1.98e9
    assert "--query-gpu=clocks.max.sm" in asked[0] and "--id=0" in asked[0]
    assert "--query-gpu=clocks.sm" in asked[1] and "--id=1" in asked[1]

    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")
    monkeypatch.setattr(_timing.subprocess, "run", missing)
    assert _timing.sm_clock_hz() is None
