"""How `correct` is decided: what the timed path served, against the plain
reference (hrbench/reference/), exactly.

What is kept during the run, beside every output's own description:
  * the host planes of the warm-up's first three pushes (the engine's two
    warm-up copies through the levels, K6 on the card, and its first warp,
    on a zero flow);
  * the host planes of the window's pushes at SAMPLED_PUSHES moments drawn
    from the seed, and of its last push.
After the window has closed, the program freed and the peak memory read,
the reference plans every output of the whole stream (its count, its
timestamps, its blending scalar, whether it is interpolated and whether the
scene gate fired) from its own frame deltas, and works out every kept
push's planes from the harness's own frames: its flow (the pyramid at the
configuration's radius, then the blur) and each output's warp in the
cell's mode, or its copy.

The numbers compared, each with limit 0 (an exact comparison):
  * meta_mismatch: outputs whose description differs from the plan, a
    missing or extra output counted as one;
  * y_mismatch, uv_mismatch: samples of the kept outputs' Y and UV planes
    that differ from the reference's.
A run that kept no output to compare is not correct.

The control (`control=` "bf16" or "nofma") puts the reference itself in the
program's place, its blend computed a step below the configuration's
float32 with fused multiply-add, and must come out not correct.
"""

from __future__ import annotations

import random

import numpy as np

from hrbench.reference.cadence import Output, plan_stream
from hrbench.reference.stream import ReferenceStream

SAMPLED_PUSHES = 8
WARMUP_KEPT = 3
LIMITS = {"meta_mismatch": 0, "y_mismatch": 0, "uv_mismatch": 0}


class Keeper:
    """Which pushes' host planes the run holds for the check: the warm-up's
    first WARMUP_KEPT, the window's push at each of `sampled` moments drawn
    from the seed (uniform over the window's seconds, so the sample does not
    depend on how many pushes the window holds), and the window's last.

    A held push keeps its output buffers from the allocator, so the next
    push takes fresh host pages; the draw fixes how many such pushes a
    window has, and spreads them over it."""

    def __init__(self, seed: int, seconds: float, sampled: int = SAMPLED_PUSHES):
        rng = random.Random(seed ^ 0x6872_6265)
        self.marks = sorted(rng.random() * seconds for _ in range(sampled))
        self.start = None

    def __call__(self, rec, in_window: bool, last: bool = False) -> bool:
        if not in_window:
            return rec.k <= WARMUP_KEPT
        if self.start is None:
            self.start = rec.t0
        hit = False
        while self.marks and self.marks[0] <= rec.t1 - self.start:
            self.marks.pop(0)
            hit = True
        return hit or last


def compare(run, pool, device, *, radius: int, controls=()) -> dict:
    """The check of `run` (a hrbench.record.Run): {"checks": {name: (reading,
    limit)}, "outputs_compared": n, "controls": {precision: {name: (reading,
    limit)}}}, the last for each control put in the program's place."""
    cfg, traffic = run.config, run.traffic
    pushes = run.warmup + run.window
    ref = ReferenceStream(pool.frames, pool.frame_index, cfg, radius=radius,
                          mode=traffic["frame_output"], device=device)
    plan = plan_stream(len(pushes), ref.frame_delta, source_fps=cfg["source_fps"],
                       target_fps=traffic["target_fps"],
                       scene_threshold=cfg["scene_change_threshold"],
                       buffer_frames=cfg["buffer_frames"])
    meta_bad = 0
    for rec, want in zip(pushes, plan):
        got = [Output(*m) for m in rec.meta]
        meta_bad += sum(g != w for g, w in zip(got, want)) + abs(len(got) - len(want))
    sides = {None: [0, 0]} | {c: [0, 0] for c in controls}
    compared = 0
    for rec in pushes:
        if rec.planes is None:
            continue
        want = ref.outputs(rec.k, plan[rec.k - 1])
        compared += min(len(want), len(rec.planes))
        for side, bad in sides.items():
            got = (rec.planes if side is None else
                   ref.outputs(rec.k, plan[rec.k - 1], blend_precision=side))
            for plane in (0, 1):
                bad[plane] += sum(int(np.count_nonzero(g[plane] != w[plane]))
                                  if g[plane].shape == w[plane].shape else w[plane].size
                                  for g, w in zip(got, want))
                bad[plane] += sum(w[plane].size for w in want[len(got):])

    def checks(bad):
        readings = {"meta_mismatch": meta_bad, "y_mismatch": bad[0], "uv_mismatch": bad[1]}
        return {name: (readings[name], LIMITS[name]) for name in LIMITS}

    return {"checks": checks(sides.pop(None)), "outputs_compared": compared,
            "controls": {c: checks(bad) for c, bad in sides.items()}}


def is_correct(checks: dict, outputs_compared: int) -> bool:
    return outputs_compared > 0 and all(value <= limit for value, limit in checks.values())
