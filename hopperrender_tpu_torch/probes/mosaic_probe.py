"""P4: the dynamic-slice probe — wrapper of csrc/mosaic_probe.cu and its plain
version.

Replaces the TPU kernels of scripts/mosaic_probe.py::run (k_dyn_*): seven
(8, 256) int32 windows and rolls of a (128, 256) int32 operand at offsets
read from a (2,) int32 input [r0, lane]. `run` launches the CUDA kernel for
CUDA tensors and takes the plain PyTorch version `run_reference` only for CPU
tensors; its counter is `run.launches`.

Each window start follows the JAX kernel in interpret mode: a negative start
counts from the end once, then clamps so that the window fits (dyn_sublane
reads rows 120..127 for any r0 > 120; the 256-wide lane window of a
256-wide operand always starts at 0).
"""

from __future__ import annotations

import numpy as np
import torch

from hopperrender_tpu_torch import _build
from hopperrender_tpu_torch.probes.chain_probe import window_start

X_SHAPE = (128, 256)
IDX_SHAPE = (2,)
OUT_SHAPE = (8, 256)
# The script's default order (its short names: sublane, sublane_aligned, lane,
# both, roll_lane, roll_sublane, sublane16).
VARIANTS = ("dyn_sublane", "dyn_sublane_aligned", "dyn_lane_aligned", "dyn_both",
            "dyn_roll_lane", "dyn_roll_sublane", "dyn_sublane_16")
IDX = (5, 128)            # the script's offsets


_VARIANT_ID = {v: i for i, v in enumerate(VARIANTS)}


def _check(variant, idx, x):
    if variant not in _VARIANT_ID:
        raise ValueError(f"mosaic_probe: unknown variant {variant!r}; one of {VARIANTS}")
    if idx.dtype != torch.int32 or idx.shape != IDX_SHAPE:
        raise ValueError(f"mosaic_probe: idx: expected {IDX_SHAPE} int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if x.dtype != torch.int32 or x.shape != X_SHAPE:
        raise ValueError(f"mosaic_probe: x: expected {X_SHAPE} int32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device != idx.device:
        raise ValueError("mosaic_probe: idx and x must be on one device")


def run_reference(variant: str, idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of P4: the (8, 256) int32 window of `variant`."""
    _check(variant, idx, x)
    r0, lane = idx.long().cpu()
    la, ra = lane & ~127, r0 & ~7
    rows, cols = X_SHAPE

    def start(s, dim, size):
        return int(window_start(s, dim, size))

    if variant == "dyn_sublane":
        return x[start(r0, rows, 8):][:8].clone()
    if variant == "dyn_sublane_aligned":
        return x[start(ra, rows, 8):][:8].clone()
    if variant == "dyn_lane_aligned":
        return x[:8, start(la, cols, 256):][:, :256].clone()
    if variant == "dyn_both":
        return x[start(r0, rows, 8):][:8, start(la, cols, 256):].clone()
    if variant == "dyn_roll_lane":
        return torch.roll(x[:8], int(r0) % 256, dims=1)
    if variant == "dyn_roll_sublane":
        return torch.roll(x[:16], int(r0) % 16, dims=0)[:8].clone()
    i = torch.arange(OUT_SHAPE[0], device=x.device)                # dyn_sublane_16
    return x[start(ra, rows, 16) + ((i + int(r0 - ra)) & 15)]


def run(variant: str, idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """P4 wrapper: the (8, 256) int32 window of `variant` of the (128, 256)
    int32 x at the (2,) int32 offsets idx, bit-identical to run_reference.
    Launches the CUDA kernel for CUDA tensors (on the current stream, no
    synchronisation; the kernel reads idx on the card); CPU tensors take the
    plain version."""
    _check(variant, idx, x)
    if not x.is_cuda:
        if x.device.type == "cpu":
            return run_reference(variant, idx, x)
        raise ValueError(f"mosaic_probe: unsupported device {x.device}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("mosaic_probe: idx and x must be contiguous")
    out = x.new_empty(OUT_SHAPE)   # int32 on x's device: cheaper than torch.empty's arguments
    _build.launch("hrt_mosaic_probe", x.get_device(), _VARIANT_ID[variant], idx.data_ptr(),
                  x.data_ptr(), out.data_ptr())
    run.launches += 1
    return out


run.launches = 0


def make_inputs(idx=IDX, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(idx, x) as the script makes them: x = arange reshaped to (128, 256)."""
    x = np.arange(X_SHAPE[0] * X_SHAPE[1], dtype=np.int32).reshape(X_SHAPE)
    return (torch.tensor(idx, dtype=torch.int32, device=device),
            torch.from_numpy(x).to(device))
