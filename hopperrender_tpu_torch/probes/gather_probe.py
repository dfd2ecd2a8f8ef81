"""P3: the per-lane gather probe — wrapper of csrc/gather_probe.cu and its
plain version; and the block-gather rates in plain PyTorch.

Replaces the TPU kernels of scripts/gather_probe.py::probe_mosaic_vector_ops
(k_take_sublane, k_take_lane, k_vec_index): three (8, 128) int32 gathers from
a (64, 256) int32 operand by an (8, 128) int32 index tile. `run` launches the
CUDA kernel for CUDA tensors and takes the plain PyTorch version
`run_reference` only for CPU tensors; its counter is `run.launches`.

Out-of-range indices follow JAX in interpret mode: a negative index counts
from the end once; take_along_axis fills what is still out of range with
INT32_MIN, NumPy-style indexing (vector_index) clamps it.

`block_gather_chain` is the script's XLA half (scripts/gather_probe.py:54-68):
k chained gathers of n_idx blocks of g32 words from a 16 MB operand, as plain
PyTorch indexing. It measures a rate; its random indices come from
torch.Generator, not from jax.random, and are made before the timed chain
(`block_gather_runner`, which replays the chain as a CUDA graph on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from hopperrender_tpu_torch import _build

X_SHAPE = (64, 256)
TILE = (8, 128)
FILL = -(2**31)           # take_along_axis's fill value for int32
VARIANTS = ("take_along_sublane", "take_along_lane", "vector_index")
# The script's XLA half: an operand of 4096 x 1024 uint32 (16 MB, 4K-frame
# scale), 400,000 indices, blocks of 2..64 words (8..256 bytes).
PLANE_SHAPE = (4096, 1024)
N_IDX = 400_000
BLOCK_WORDS = (2, 4, 8, 16, 32, 64)


def _wrap(k: torch.Tensor, size: int) -> torch.Tensor:
    return torch.where(k < 0, k + size, k)


_VARIANT_ID = {v: i for i, v in enumerate(VARIANTS)}


def _check(variant, x, idx):
    if variant not in _VARIANT_ID:
        raise ValueError(f"gather_probe: unknown variant {variant!r}; one of {VARIANTS}")
    if x.dtype != torch.int32 or x.shape != X_SHAPE:
        raise ValueError(f"gather_probe: x: expected {X_SHAPE} int32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if idx.dtype != torch.int32 or idx.shape != TILE:
        raise ValueError(f"gather_probe: idx: expected {TILE} int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if x.device != idx.device:
        raise ValueError("gather_probe: x and idx must be on one device")


def run_reference(variant: str, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of P3: the (8, 128) int32 gather of `variant`."""
    _check(variant, x, idx)
    i = torch.arange(TILE[0], device=x.device).view(-1, 1)
    l = torch.arange(TILE[1], device=x.device).view(1, -1)
    if variant == "take_along_lane":
        k = _wrap(idx.long() + 7, X_SHAPE[1])
        inside = (k >= 0) & (k < X_SHAPE[1])
        return torch.where(inside, x[i, k.clamp(0, X_SHAPE[1] - 1)], FILL)
    k = _wrap(idx.long(), X_SHAPE[0])
    if variant == "vector_index":
        return x[k.clamp(0, X_SHAPE[0] - 1), l]
    inside = (k >= 0) & (k < X_SHAPE[0])
    return torch.where(inside, x[k.clamp(0, X_SHAPE[0] - 1), l], FILL)


def run(variant: str, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P3 wrapper: the (8, 128) int32 gather of `variant` from the (64, 256)
    int32 x by the (8, 128) int32 idx, bit-identical to run_reference.
    Launches the CUDA kernel for CUDA tensors (on the current stream, no
    synchronisation); CPU tensors take the plain version."""
    _check(variant, x, idx)
    if not x.is_cuda:
        if x.device.type == "cpu":
            return run_reference(variant, x, idx)
        raise ValueError(f"gather_probe: unsupported device {x.device}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_probe: x and idx must be contiguous")
    out = torch.empty_like(idx)    # the (8, 128) int32 tile, as idx
    _build.launch("hrt_gather_probe", x.get_device(), _VARIANT_ID[variant], x.data_ptr(),
                  idx.data_ptr(), out.data_ptr())
    run.launches += 1
    return out


run.launches = 0


def make_inputs(device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(x, idx) as the script makes them: x = arange reshaped to (64, 256),
    idx[i, l] = 3 i mod 64."""
    x = np.arange(X_SHAPE[0] * X_SHAPE[1], dtype=np.int32).reshape(X_SHAPE)
    idx = np.tile(np.arange(TILE[0], dtype=np.int32)[:, None], (1, TILE[1])) * 3 % X_SHAPE[0]
    return torch.from_numpy(x).to(device), torch.from_numpy(idx).to(device)


def make_plane(seed: int = 0, device="cpu") -> torch.Tensor:
    """The block gathers' 16 MB uint32 operand, as int32 (the same bits:
    PyTorch's CUDA indexing takes no uint32)."""
    rng = np.random.default_rng(seed)
    plane = rng.integers(0, 2**32, PLANE_SHAPE, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(plane).to(device)


def block_gather_indices(shape: tuple[int, int], *, g32: int, n_idx: int, k: int,
                         device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """The random blocks of k chained gathers, as the script draws them per
    step i (row ri and block bi from the key i): (k, n_idx) int64 flat block
    indices ri * nb + bi, and the move of one row down from each, nb, or 0 on
    the last row, where the script's clip holds the row."""
    rows, cols = shape
    nb = cols // g32
    base, shift = [], []
    for i in range(k):
        gen = torch.Generator(device=device).manual_seed(i)
        ri = torch.randint(0, rows, (n_idx,), generator=gen, device=device)
        bi = torch.randint(0, nb, (n_idx,), generator=gen, device=device)
        base.append(ri * nb + bi)
        shift.append((ri < rows - 1).long() * nb)
    return torch.stack(base), torch.stack(shift)


def block_gather_chain(plane: torch.Tensor, salt: int, base: torch.Tensor, shift: torch.Tensor,
                       *, g32: int) -> torch.Tensor:
    """len(base) chained block gathers of blocks of g32 words, at the indices
    of block_gather_indices: gather i moves its rows down by the low bit of
    the running sum of the earlier gathers' first words, so the gathers run
    one after another. Returns that sum mod 2^32 (int64). The sum of int32
    words equals the sum of their uint32 bits mod 2^32."""
    blocks = plane.reshape(-1, g32)
    acc = torch.full((), salt, dtype=torch.int64, device=plane.device)
    for i in range(base.shape[0]):
        g = blocks.index_select(0, torch.addcmul(base[i], shift[i], acc & 1))   # (n_idx, g32)
        acc = acc + g[:, 0].sum(dtype=torch.int64)
    return acc & 0xFFFFFFFF


def block_gather_runner(plane: torch.Tensor, *, g32: int, n_idx: int, k_max: int):
    """call(k): k <= k_max chained block gathers of `plane`, their indices
    made here, before any timed call. On the card each k's chain is captured
    into a CUDA graph at its first call and replayed at every call, so a
    timed call holds the gathers and the chain's few small reductions, and
    no host dispatch. On the CPU the chain runs eagerly."""
    base, shift = block_gather_indices(tuple(plane.shape), g32=g32, n_idx=n_idx, k=k_max,
                                       device=plane.device)
    if plane.device.type != "cuda":
        return lambda k: block_gather_chain(plane, 0, base[:k], shift[:k], g32=g32)
    graphs = {}

    def call(k):
        if k not in graphs:
            side = torch.cuda.Stream(plane.device)     # capture wants a warmed-up side stream
            side.wait_stream(torch.cuda.current_stream(plane.device))
            with torch.cuda.stream(side):
                block_gather_chain(plane, 0, base[:k], shift[:k], g32=g32)
            torch.cuda.current_stream(plane.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = block_gather_chain(plane, 0, base[:k], shift[:k], g32=g32)
            graphs[k] = graph, out
        graph, out = graphs[k]
        graph.replay()
        return out
    return call
