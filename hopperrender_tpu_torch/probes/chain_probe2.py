"""P2: the residual-select probe — wrapper of csrc/chain_probe2.cu and its
plain version.

Replaces scripts/chain_probe2.py::run / make_kernel (the TPU kernel): P1's
loop over a table and a (512, 1024) uint32 band, with an (8, 128) int32 tile
of residuals (0..16 in the script), in 11 variants: per-lane row selects,
static lane slices, a branch and dynamic gathers. `run` launches the CUDA
kernel for CUDA tensors and takes the plain PyTorch version `run_reference`
only for CPU tensors; its counter is `run.launches`.

transpose8 has no kernel: the JAX kernel XORs an (8, 128) accumulator with an
(8, 8) value and does not trace (jnp raises TypeError, "incompatible shapes
for broadcasting"). `run` and `run_reference` refuse it the same way, before
any launch.
"""

from __future__ import annotations

import numpy as np
import torch

from hopperrender_tpu_torch import _build
from hopperrender_tpu_torch.probes import chain_probe as p1
from hopperrender_tpu_torch.probes.chain_probe import ROWS, T, TILE, W32, window_start

KV = KH = 17     # vertical and horizontal residual options
# The script's default list, and the variants that have a kernel, in the
# order of the kernel's Variant enum.
VARIANTS = ("slice_static", "slice_static_x17", "vsel_x17", "fastpath_tile", "transpose8",
            "cond_branch", "dyngather_ax0_8", "dyngather_ax0_32", "dyngather_ax0_256",
            "dyngather_ax1_8", "dyngather_ax1_32")
KERNEL_VARIANTS = tuple(v for v in VARIANTS if v != "transpose8")
REFUSED = {"transpose8": "xor got incompatible shapes for broadcasting: (8, 128), (8, 8): the "
                         "JAX kernel XORs the accumulator with an (8, 8) transposed slice"}


def _iteration(variant: str, band: torch.Tensor, res: torch.Tensor):
    """The per-iteration values of a P2 variant: fields -> (kind, values, mask)."""
    words = p1.band_words(band)
    s, l = p1.tile_coords(band.device)
    dy = res.long()[None]                                   # (1, 8, 128)
    is_option = (dy >= 0) & (dy < KV)

    def at(row, lane):
        return words[row * W32 + lane]

    def step(f):
        r0, la, ra = f["r0"], f["la"], f["ra"]
        rows8 = window_start(ra, ROWS, 8)
        lanes128, lanes256 = window_start(la, W32, 128), window_start(la, W32, 256)
        if variant == "slice_static":
            return "xor", at(rows8 + s, lanes256 + 37 + l), None
        if variant == "slice_static_x17":
            v = at(rows8 + s, lanes256 + 8 + l)
            for k in range(1, KH):
                v = v ^ at(rows8 + s, lanes256 + 8 + k + l)
            return "xor", v, None
        if variant == "vsel_x17":
            rows = window_start(ra + 8 * (dy.clamp(min=0) % 3), ROWS, 8)
            return "replace", at(rows + s, lanes128 + l), is_option
        if variant == "fastpath_tile":
            p = l + dy.clamp(0, KH - 1)
            dy_p = dy[0].gather(1, (p[0] & 127))[None]          # dy at column p mod 128
            rows = window_start(ra + 8 * (dy_p.clamp(min=0) % 3), ROWS, 8)
            v = torch.where((dy_p >= 0) & (dy_p < KV), at(rows + s, lanes256 + p), 0)
            return "replace", v, is_option
        if variant == "cond_branch":
            return "xor", at(window_start(ra + 8 * (r0 & 1), ROWS, 8) + s, lanes128 + l), None
        axis, r = variant.removeprefix("dyngather_ax").split("_")
        r = int(r)
        w0 = window_start(ra & ~31, ROWS, r)
        if axis == "0":
            return "xor", at(w0 + ((s + l + r0) & (r - 1)), lanes128 + l), None
        return "xor", at(w0 + s, lanes128 + ((s + l + r0) & 127)), None

    return step


def _check(variant, n, tab, band, res, blocks):
    if variant in REFUSED:
        raise TypeError(f"chain_probe2 {variant}: {REFUSED[variant]}")
    if variant not in KERNEL_VARIANTS:
        raise ValueError(f"chain_probe2: unknown variant {variant!r}; one of {VARIANTS}")
    if not 0 <= n < 2**31:
        raise ValueError(f"chain_probe2: n = {n} outside [0, 2^31)")
    if blocks < 1:
        raise ValueError(f"chain_probe2: blocks = {blocks} < 1")
    for name, t, shape, dtype in (("tab", tab, (3, T), torch.int32),
                                  ("band", band, (ROWS, W32), torch.uint32),
                                  ("res", res, TILE, torch.int32)):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"chain_probe2: {name}: expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if not tab.device == band.device == res.device:
        raise ValueError("chain_probe2: tab, band and res must be on one device")


def run_reference(variant: str, n: int, tab: torch.Tensor, band: torch.Tensor,
                  res: torch.Tensor, *, blocks: int = 1) -> torch.Tensor:
    """Plain PyTorch version of P2: (blocks, 8, 128) uint32, every slot the
    JAX kernel's (8, 128) result."""
    _check(variant, n, tab, band, res, blocks)
    return p1.run_plain(_iteration(variant, band, res), n, tab, blocks)


def run(variant: str, n: int, tab: torch.Tensor, band: torch.Tensor, res: torch.Tensor, *,
        blocks: int = 1) -> torch.Tensor:
    """P2 wrapper: n iterations of `variant` over the (3, 512) int32 table,
    the (512, 1024) uint32 band and the (8, 128) int32 residuals ->
    (blocks, 8, 128) uint32, bit-identical to run_reference. Launches the CUDA
    kernel for CUDA tensors (on the current stream, no synchronisation); CPU
    tensors take the plain version."""
    _check(variant, n, tab, band, res, blocks)
    if tab.device.type == "cpu":
        return run_reference(variant, n, tab, band, res, blocks=blocks)
    if tab.device.type != "cuda":
        raise ValueError(f"chain_probe2: unsupported device {tab.device}")
    if not (tab.is_contiguous() and band.is_contiguous() and res.is_contiguous()):
        raise ValueError("chain_probe2: tab, band and res must be contiguous")
    out = band.new_empty((blocks, *TILE))   # uint32, as band
    _build.launch("hrt_chain_probe2", tab.get_device(), KERNEL_VARIANTS.index(variant), n,
                  tab.data_ptr(), band.data_ptr(), res.data_ptr(), out.data_ptr(), blocks)
    run.launches += 1
    return out


run.launches = 0


def make_inputs(seed: int = 0, device="cpu") -> tuple[torch.Tensor, ...]:
    """(tab, band, res) as the script makes them: the band, residuals in
    0..16, then a table with r0 in [0, ROWS - 32)."""
    rng = np.random.default_rng(seed)
    band = p1.make_band(rng)
    res = rng.integers(0, KV, TILE, dtype=np.int32)
    tab = p1.make_table(rng, r0_high=ROWS - 32)
    return tuple(torch.from_numpy(a).to(device) for a in (tab, band, res))
