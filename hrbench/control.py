"""The check's readings on sound runs and on its control, for setting and
proving the limits; not part of the benchmark's own runs.

    python3 -m hrbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, one run of the cell (its set-up, a window of the given
seconds at the cell's own load, the check), in one process: the numbers the
check compares for the program, and for the reference put in the program's
place with its blend computed a step below the configuration's float32
with fused multiply-add: bfloat16 ("bf16", the precision below float32) and
float32 rounded twice ("nofma"). One JSON line a seed; exits non-zero
unless every program reading is within its limit and every control fails
one.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

CONTROLS = ("bf16", "nofma")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m hrbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from hrbench import check, harness
    bench = harness.load_benchmark()
    _, config, traffic = harness.cell_parts(bench, args.workload)
    ok = True
    for seed in args.seeds:
        out = harness.run_cell(args.workload, config, traffic, [], seed=seed,
                               seconds=args.seconds, traced=False, device=args.device,
                               t_start=time.perf_counter(), controls=CONTROLS)
        fails = {c: not check.is_correct(r, out["outputs_compared"])
                 for c, r in out["controls"].items()}
        ok &= out["correct"] and all(fails.values())
        print(json.dumps({"workload": args.workload, "seed": seed, "pushes": out["attempted"],
                          "outputs_compared": out["outputs_compared"],
                          "program": {k: v for k, (v, _) in out["checks"].items()},
                          "controls": {c: {k: v for k, (v, _) in r.items()}
                                       for c, r in out["controls"].items()},
                          "control_fails": fails}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
