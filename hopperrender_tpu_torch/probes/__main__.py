"""The probe path: the port's counterpart of `python scripts/<probe>.py [variant ...]`.

    python -m hopperrender_tpu_torch.probes {chain,chain2,gather,mosaic} [variant ...]
        [--device cuda|cpu] [--blocks 1|132] [--n1 N --n2 N]

Prints a device line, then one line per variant in the format of the
scripts: the time per iteration by the slope method (probes/_timing.py), the
cycles at the SM clock read during the runs (the card's maximum is on the
device line), and the best times at n1 and n2. An iteration is one pass of
the chain loop for chain/chain2 (n1 20,000 and n2 120,000 by default, as the
scripts), and one launch for the gather and mosaic kernels (n1 100, n2 1,000
launches back to back). The gather probe's block variants (block8 ..
block256) are the script's XLA half: k = 1 and 9 chained gathers of 400,000
blocks, replayed as CUDA graphs on the card; ns per index and GB/s.

`--blocks` (chain, chain2) launches that many identical blocks: 1 is one SM,
132 one on every SM of an H100. `--device cuda` (the default) raises without
a card; `--device cpu` runs the plain versions on the host clock. A variant
that fails prints `FAIL <type>: <message>`, as the scripts do: chain2's
transpose8, which does not trace in JAX, is the one expected failure; any
other makes the run exit 1, after every line is printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable

import torch

from hopperrender_tpu_torch.probes import _timing, chain_probe, chain_probe2, gather_probe
from hopperrender_tpu_torch.probes import mosaic_probe

BLOCK_VARIANTS = tuple(f"block{4 * g32}" for g32 in gather_probe.BLOCK_WORDS)
VARIANTS = {"chain": chain_probe.VARIANTS, "chain2": chain_probe2.VARIANTS,
            "gather": gather_probe.VARIANTS + BLOCK_VARIANTS, "mosaic": mosaic_probe.VARIANTS}
DEFAULT_N = {"chain": (20_000, 120_000), "chain2": (20_000, 120_000),
             "gather": (100, 1_000), "mosaic": (100, 1_000)}
BLOCK_K = (1, 9)          # chained block gathers per run (the script's 1 and 3, spread)
UNIT = {"chain": "chain", "chain2": "iter", "gather": "launch", "mosaic": "launch"}
EXPECTED_FAILURES = {("chain2", v) for v in chain_probe2.REFUSED}


@dataclasses.dataclass(frozen=True)
class Result:
    variant: str
    line: str
    error: str | None = None          # "<type>: <first line of the message>"
    expected_failure: bool = False
    slope: _timing.Slope | None = None    # its two times; None where it failed


def _caller(probe: str, variant: str, device: torch.device,
            blocks: int) -> Callable[[int], object]:
    """call(n) of one variant: n iterations of the chain loop, n launches of a
    gather or mosaic kernel, or n chained block gathers."""
    if probe == "chain":
        tab, band = chain_probe.make_inputs(0, device)
        return lambda n: chain_probe.run(variant, n, tab, band, blocks=blocks)
    if probe == "chain2":
        tab, band, res = chain_probe2.make_inputs(0, device)
        return lambda n: chain_probe2.run(variant, n, tab, band, res, blocks=blocks)
    if probe == "gather" and variant in BLOCK_VARIANTS:
        g32 = int(variant.removeprefix("block")) // 4
        return gather_probe.block_gather_runner(gather_probe.make_plane(0, device), g32=g32,
                                                n_idx=gather_probe.N_IDX, k_max=BLOCK_K[1])
    mod = gather_probe if probe == "gather" else mosaic_probe
    inputs = mod.make_inputs(device=device)

    def launches(n):
        for _ in range(n):
            mod.run(variant, *inputs)
    return launches


def _line(probe: str, variant: str, sl: _timing.Slope) -> str:
    per = sl.per_s
    if variant in BLOCK_VARIANTS:
        size = int(variant.removeprefix("block"))
        return (f"block gather {size:4d} B: {per / gather_probe.N_IDX * 1e9:7.2f} ns/idx "
                f"({gather_probe.N_IDX * size / per / 1e9:7.2f} GB/s)  (k{sl.n1}="
                f"{sl.t1_s * 1e3:.3f}ms k{sl.n2}={sl.t2_s * 1e3:.3f}ms)")
    hz = sl.sm_hz
    cycles = f"{per * hz:7.1f} cyc at {hz / 1e6:.0f} MHz" if hz else "      - cyc"
    return (f"{variant:20s} {per * 1e9:9.1f} ns/{UNIT[probe]}  ~{cycles}  (t{sl.n1}="
            f"{sl.t1_s * 1e3:.3f}ms t{sl.n2}={sl.t2_s * 1e3:.3f}ms)")


def run_probe(probe: str, variants=None, *, device: str | torch.device = "cuda",
              blocks: int = 1, n1: int | None = None, n2: int | None = None,
              echo: Callable[[str], None] | None = None) -> list[Result]:
    """Every variant of a probe (all of them by default) through the slope
    method; one Result each, its line passed to `echo` as it is made."""
    if probe not in VARIANTS:
        raise ValueError(f"unknown probe {probe!r}; one of {tuple(VARIANTS)}")
    device = torch.device(device)
    d1, d2 = DEFAULT_N[probe]
    n1, n2 = d1 if n1 is None else n1, d2 if n2 is None else n2
    results = []
    for variant in variants or VARIANTS[probe]:
        try:
            k1, k2 = BLOCK_K if variant in BLOCK_VARIANTS else (n1, n2)
            sl = _timing.slope(_caller(probe, variant, device, blocks), k1, k2, device)
            result = Result(variant, _line(probe, variant, sl), slope=sl)
        except Exception as exc:   # a variant that fails prints FAIL, as the scripts do
            msg = f"{type(exc).__name__}: {(str(exc).splitlines() or [''])[0][:200]}"
            result = Result(variant, f"{variant:20s} FAIL {msg}", error=msg,
                            expected_failure=(probe, variant) in EXPECTED_FAILURES)
        if echo:
            echo(result.line)
        results.append(result)
    return results


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m hopperrender_tpu_torch.probes",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("probe", choices=tuple(VARIANTS))
    parser.add_argument("variants", nargs="*", help="variants to run (default: all)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--blocks", type=int, default=1,
                        help="identical blocks of chain/chain2 (1: one SM; 132: every SM)")
    parser.add_argument("--n1", type=int, help="the smaller loop or launch count")
    parser.add_argument("--n2", type=int, help="the larger loop or launch count")
    args = parser.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("probes: device 'cuda' requested but no CUDA device is "
                               "available (pass --device cpu to run the plain versions)")
        name, hz = torch.cuda.get_device_name(0), _timing.sm_clock_hz()
        clock = f"max SM clock {hz / 1e6:.0f} MHz" if hz else "max SM clock not read"
        print(f"device: {name} ({clock}); blocks {args.blocks}", flush=True)
    else:
        print("device: cpu (plain versions, host clock; no cycles)", flush=True)
    results = run_probe(args.probe, args.variants, device=args.device, blocks=args.blocks,
                        n1=args.n1, n2=args.n2, echo=lambda s: print(s, flush=True))
    return 1 if any(r.error and not r.expected_failure for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
