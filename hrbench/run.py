"""Run one cell of the port's benchmark and print its result line.

    python3 -m hrbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, hrbench/ and the port
(hopperrender_tpu_torch/). The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer metrics), device, with --trace 1 breakdown,
and last the numbers the check compared, each with its limit; the same
numbers are the last lines of standard error. Exits non-zero without a
result when there is no CUDA card (or fewer than the cell asks for), when
the reference imports the program, or when the process has loaded JAX or
the JAX package.
"""

import time

T_START = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m hrbench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from hrbench import guard, harness
    bad = guard.reference_imports()
    if bad:
        print(f"hrbench: the reference imports what it may not: {bad}", file=sys.stderr)
        return 3
    bench = harness.load_benchmark()
    cell, config, traffic = harness.cell_parts(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"hrbench: {args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    traced = bool(args.trace)
    out = harness.run_cell(args.workload, config, traffic,
                           harness.cell_metrics(bench, args.workload, traced), seed=args.seed,
                           seconds=args.seconds, traced=traced, device="cuda",
                           t_start=T_START)
    loaded = guard.loaded_forbidden()
    if loaded:
        print(f"hrbench: the process loaded {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(result_line(out, cell["chips"])))
    return 0


def result_line(out: dict, chips: int) -> dict:
    """The printed object; prints the compared numbers to standard error."""
    import torch

    run = out["run"]
    on_card = run.device.type == "cuda"
    device = {"platform": "gpu" if on_card else run.device.type,
              "kind": torch.cuda.get_device_name(run.device) if on_card else "cpu",
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = out["breakdown"]
    checks = {name: {"value": v, "limit": lim} for name, (v, lim) in out["checks"].items()}
    checks["outputs_compared"] = {"value": out["outputs_compared"], "limit": "> 0"}
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    return line


if __name__ == "__main__":
    sys.exit(main())
