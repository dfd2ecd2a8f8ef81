"""P1: the per-chain cost probe — wrapper of csrc/chain_probe.cu and its plain
version.

Replaces scripts/chain_probe.py::run / make_kernel (the TPU kernel): n
iterations of a table-driven fetch from a (512, 1024) uint32 band into an
(8, 128) uint32 accumulator, in 12 variants. `run` launches the CUDA kernel
for CUDA tensors and takes the plain PyTorch version `run_reference` only for
CPU tensors; its counter is `run.launches`. On the card the kernel runs as
`blocks` identical blocks, each writing its own (8, 128) slot: 1 is the TPU's
one core, 132 one block on every SM of an H100.

The plain version computes, for each iteration, the band word each element
reads (the closed forms of csrc/chain_probe.cu) and combines them: a sum, an
XOR, or a masked replacement. It carries uint32 words as int64 masked to 32
bits, so that right shifts are logical. Iterations go in chunks, so memory
stays bounded at any n.
"""

from __future__ import annotations

import numpy as np
import torch

from hopperrender_tpu_torch import _build

T = 512                    # table entries
ROWS, W32 = 512, 1024      # the band: 2 MB of uint32
TILE = (8, 128)
MASK32 = 0xFFFFFFFF
CHUNK = 2048               # iterations per step of the plain version
# In the order of the kernel's Variant enum (and of the script's default list).
VARIANTS = ("empty", "smem_only", "load8x128", "load8x256", "load16x256", "roll0",
            "roll0_static", "roll1", "roll1_static", "roll1_128", "full", "full_aligned_rows")


def window_start(start: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """pl.ds(start, size) over a dimension of dim, as the JAX kernel resolves
    it in interpret mode: a negative start counts from the end once, then
    the start is clamped to [0, dim - size]."""
    return torch.where(start < 0, start + dim, start).clamp(0, dim - size)


def table_fields(tab: torch.Tensor, i0: int, i1: int) -> dict[str, torch.Tensor]:
    """The fields of iterations [i0, i1) of the (3, 512) int32 table, each
    int64 of shape (i1 - i0, 1, 1)."""
    j = torch.arange(i0, i1, device=tab.device) & (T - 1)
    r0, c = tab[0, j].long(), tab[1, j].long()
    c32 = c >> 2
    f = dict(r0=r0, c=c, t_sub=tab[2, j].long() & 7, c32=c32, sub=c & 3,
             la=torch.clamp(c32 & ~127, max=W32 - 256), ra=r0 & ~7)
    return {k: v.view(-1, 1, 1) for k, v in f.items()}


def tile_coords(device) -> tuple[torch.Tensor, torch.Tensor]:
    """Sublane s (1, 8, 1) and lane l (1, 1, 128) of the tile's elements."""
    return (torch.arange(TILE[0], device=device).view(1, -1, 1),
            torch.arange(TILE[1], device=device).view(1, 1, -1))


def band_words(band: torch.Tensor) -> torch.Tensor:
    """The band's words, flat, as int64 in [0, 2^32)."""
    return band.reshape(-1).view(torch.int32).long() & MASK32


def xor_reduce(v: torch.Tensor) -> torch.Tensor:
    """XOR of v over its first axis (zeros where it is empty)."""
    if v.shape[0] == 0:
        return torch.zeros(v.shape[1:], dtype=v.dtype, device=v.device)
    while v.shape[0] > 1:
        if v.shape[0] % 2:
            v = torch.cat([v, torch.zeros_like(v[:1])])
        v = v[0::2] ^ v[1::2]
    return v[0]


def combine(kind: str, acc: torch.Tensor, vals: torch.Tensor, mask) -> torch.Tensor:
    """One chunk of iterations folded into the (8, 128) int64 accumulator:
    "add" sums, "xor" XORs, "replace" takes each element's value from the
    last iteration whose mask covers it."""
    if kind == "add":
        return (acc + vals.sum(0)) & MASK32
    if kind == "xor":
        return acc ^ xor_reduce(vals)
    vals = vals.expand(-1, *TILE)
    mask = mask.expand_as(vals)
    k = torch.arange(vals.shape[0], device=vals.device).view(-1, 1, 1)
    last = torch.where(mask, k, -1).amax(0)
    taken = vals.gather(0, last.clamp(min=0)[None])[0]
    return torch.where(last >= 0, taken, acc)


def to_uint32(acc: torch.Tensor, blocks: int) -> torch.Tensor:
    """The int64 accumulator in [0, 2^32) as the kernel's (blocks, 8, 128)
    uint32 output: every block computes the same tile."""
    as_int32 = (acc - ((acc >> 31) << 32)).to(torch.int32)
    return as_int32.view(torch.uint32).expand(blocks, *TILE).contiguous()


def run_plain(iteration, n: int, tab: torch.Tensor, blocks: int) -> torch.Tensor:
    """The plain loop shared by P1 and P2: iteration(fields) gives (kind, the
    chunk's values, its mask or None) for a chunk of iterations' fields."""
    acc = torch.zeros(TILE, dtype=torch.int64, device=tab.device)
    for i0 in range(0, n, CHUNK):
        kind, vals, mask = iteration(table_fields(tab, i0, min(n, i0 + CHUNK)))
        acc = combine(kind, acc, vals, mask)
    return to_uint32(acc, blocks)


def _iteration(variant: str, band: torch.Tensor):
    """The per-iteration values of a P1 variant: fields -> (kind, values, mask)."""
    words = band_words(band)
    s, l = tile_coords(band.device)

    def at(row, lane):
        return words[row * W32 + lane]

    def step(f):
        r0, c32, la, ra = f["r0"], f["c32"], f["la"], f["ra"]
        if variant == "empty":
            return "add", r0 & MASK32, None
        if variant == "smem_only":
            return "add", (r0 + f["c"] + f["t_sub"]) & MASK32, None
        rows8, rows16 = window_start(ra, ROWS, 8), window_start(ra, ROWS, 16)
        lanes128, lanes256 = window_start(la, W32, 128), window_start(la, W32, 256)
        if variant == "load8x128":
            return "xor", at(rows8 + s, lanes128 + l), None
        if variant == "load8x256":
            return "xor", at(rows8 + s, lanes256 + l), None
        if variant == "load16x256":
            return "xor", at(rows16 + s, lanes256 + l), None
        if variant == "roll0":
            return "xor", at(rows16 + ((s + r0 - ra) & 15), lanes256 + l), None
        if variant == "roll0_static":
            return "xor", at(rows16 + ((s - 5) & 15), lanes256 + l), None
        if variant == "roll1":
            return "xor", at(rows8 + s, lanes256 + ((l + c32 - la) & 255)), None
        if variant == "roll1_static":
            return "xor", at(rows8 + s, lanes256 + ((l - 37) & 255)), None
        if variant == "roll1_128":
            return "xor", at(rows8 + s, lanes128 + ((l + c32 - la) & 127)), None
        # full, full_aligned_rows: the byte-realigned word, into lanes [t_sub, t_sub + 16)
        row = rows16 + ((s + r0 - ra) & 15) if variant == "full" else rows8 + s
        w = at(row, lanes256 + ((l + c32 - la) & 255))
        w1 = at(row, lanes256 + ((l + 1 + c32 - la) & 255))
        sh = 8 * f["sub"]
        shifted = ((w >> sh) | (w1 << (32 - sh))) & MASK32
        t_sub = f["t_sub"]
        return "replace", torch.where(f["sub"] == 0, w, shifted), (l >= t_sub) & (l < t_sub + 16)

    return step


def _check(variant, n, tab, band, blocks):
    if variant not in VARIANTS:
        raise ValueError(f"chain_probe: unknown variant {variant!r}; one of {VARIANTS}")
    if not 0 <= n < 2**31:
        raise ValueError(f"chain_probe: n = {n} outside [0, 2^31)")
    if blocks < 1:
        raise ValueError(f"chain_probe: blocks = {blocks} < 1")
    for name, t, shape, dtype in (("tab", tab, (3, T), torch.int32),
                                  ("band", band, (ROWS, W32), torch.uint32)):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"chain_probe: {name}: expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if tab.device != band.device:
        raise ValueError("chain_probe: tab and band must be on one device")


def run_reference(variant: str, n: int, tab: torch.Tensor, band: torch.Tensor, *,
                  blocks: int = 1) -> torch.Tensor:
    """Plain PyTorch version of P1: (blocks, 8, 128) uint32, every slot the
    JAX kernel's (8, 128) result."""
    _check(variant, n, tab, band, blocks)
    return run_plain(_iteration(variant, band), n, tab, blocks)


def run(variant: str, n: int, tab: torch.Tensor, band: torch.Tensor, *,
        blocks: int = 1) -> torch.Tensor:
    """P1 wrapper: n iterations of `variant` over the (3, 512) int32 table and
    the (512, 1024) uint32 band -> (blocks, 8, 128) uint32, bit-identical to
    run_reference. Launches the CUDA kernel for CUDA tensors (on the current
    stream, no synchronisation); CPU tensors take the plain version."""
    _check(variant, n, tab, band, blocks)
    if tab.device.type == "cpu":
        return run_reference(variant, n, tab, band, blocks=blocks)
    if tab.device.type != "cuda":
        raise ValueError(f"chain_probe: unsupported device {tab.device}")
    if not (tab.is_contiguous() and band.is_contiguous()):
        raise ValueError("chain_probe: tab and band must be contiguous")
    out = band.new_empty((blocks, *TILE))   # uint32, as band
    _build.launch("hrt_chain_probe", tab.get_device(), VARIANTS.index(variant), n, tab.data_ptr(),
                  band.data_ptr(), out.data_ptr(), blocks)
    run.launches += 1
    return out


run.launches = 0


def make_band(rng: np.random.Generator) -> np.ndarray:
    return rng.integers(0, 2**32, (ROWS, W32), dtype=np.uint32)


def make_table(rng: np.random.Generator, r0_high: int = ROWS - 16) -> np.ndarray:
    """A table in the script's ranges: r0 in [0, r0_high), c in
    [0, (W32 - 64) * 4), t_sub in [0, 8)."""
    return np.stack([rng.integers(0, r0_high, T), rng.integers(0, (W32 - 64) * 4, T),
                     rng.integers(0, 8, T)]).astype(np.int32)


def make_inputs(seed: int = 0, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(tab, band) as the script makes them: the band first, then a table."""
    rng = np.random.default_rng(seed)
    band = make_band(rng)
    return (torch.from_numpy(make_table(rng)).to(device), torch.from_numpy(band).to(device))
