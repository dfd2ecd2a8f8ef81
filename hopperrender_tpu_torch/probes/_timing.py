"""The slope method of the probe scripts, on the card or on the CPU.

A probe runs its work at two loop counts n1 < n2, takes the best of three
runs at each after one warm-up run, and reports (t(n2) - t(n1)) / (n2 - n1):
the time per iteration, with the launch, the set-up and the loop's fixed
costs taken out. On the card each run is timed with CUDA events around the
call; on the CPU with the host clock. The cycles column uses the SM clock
nvidia-smi reads on the card while the runs at n2 go (clocks.sm, on a
thread), never a number written here; the card's maximum (clocks.max.sm) is
printed beside it.
"""

from __future__ import annotations

import dataclasses
import subprocess
import threading
import time
from typing import Callable

import torch

REPEATS = 3


@dataclasses.dataclass(frozen=True)
class Slope:
    n1: int
    n2: int
    t1_s: float      # best run at n1
    t2_s: float      # best run at n2
    sm_hz: float | None = None    # the card's SM clock read during the runs at n2

    @property
    def per_s(self) -> float:
        return (self.t2_s - self.t1_s) / (self.n2 - self.n1)


def best_time(call: Callable[[int], object], n: int, device: torch.device,
              repeats: int = REPEATS) -> float:
    """Seconds of the best of `repeats` runs of call(n), after one warm-up run."""
    cuda = device.type == "cuda"
    call(n)
    if cuda:
        torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call(n)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            call(n)
            seconds = time.perf_counter() - t0
        best = min(best, seconds)
    return best


def slope(call: Callable[[int], object], n1: int, n2: int, device: torch.device,
          repeats: int = REPEATS) -> Slope:
    if not 0 <= n1 < n2:
        raise ValueError(f"the slope needs 0 <= n1 < n2, got {n1}, {n2}")
    t1 = best_time(call, n1, device, repeats)
    if device.type != "cuda":
        return Slope(n1, n2, t1, best_time(call, n2, device, repeats))
    index = torch.cuda.current_device() if device.index is None else device.index
    clock: list[float | None] = []
    reader = threading.Thread(target=lambda: clock.append(sm_clock_hz("clocks.sm", index)),
                              daemon=True)
    reader.start()
    t2 = best_time(call, n2, device, repeats)
    reader.join()
    return Slope(n1, n2, t1, t2, clock[0])


def sm_clock_hz(query: str = "clocks.max.sm", index: int = 0) -> float | None:
    """Card `index`'s SM clock in Hz as nvidia-smi reads it: its maximum
    (clocks.max.sm) or the current one (clocks.sm). None where nvidia-smi is
    missing or reads no clock. nvidia-smi numbers the cards in PCI order,
    which CUDA follows on a host of one card model."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
                              f"--id={index}"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:   # "1980 MHz"
        return float(out.stdout.splitlines()[0].split()[0]) * 1e6
    except (IndexError, ValueError):
        return None
