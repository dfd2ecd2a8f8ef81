#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hopperrender_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                   # from the repository root; needs one CUDA card
    python3 chip_smoke.py --parallel-only   # phases 1, 2 and 7; on four cards, 7c
                                            # adds meshes of a rank per card (NCCL)
    python3 chip_smoke.py --bench-only      # phases 1, 2 and 10: the bench
    python3 chip_smoke.py --kernel-times    # phases 1, 2, then the kernels' times only:
                                            # K1, K2, the band, K5, K2's mode 3 beside
                                            # K2 raw_blend + K5 and without its colour,
                                            # K2's modes 4-6 beside their compositions,
                                            # K6 (the copy), K3, K4, the pyramid
                                            # step (flow_step), P1-P4 and the L2 read
                                            # rate, P1/P2 on the probe path on 1 and
                                            # 132 blocks, the split of a wrapper call's
                                            # host time into stages and the floor of a
                                            # one-block launch taken apart

Builds the hand-written CUDA kernels from hopperrender_tpu_torch/csrc (nvcc,
sm_90a), then runs these phases, one line each:

  1. the device: torch's name for it and nvidia-smi's name and power limit;
  2. the build: nvcc's time and the library's path; each kernel's registers
     and spill bytes from ptxas (stderr), and those of K2's modes 5 and 6;
  3. K1 (flow blur) against its plain PyTorch version at the 4K flow grid
     (2, 270, 480) and at (2, 33, 65), exact;
     3b. K3 (the cost volume's window sums) and K4 (the argmin and its
     commit) against their plain versions, exact: 4K HDR and 1080p SDR on
     the 270 x 480 grid, radius 5/8/12/16 at the engine's layers, every
     (iteration, window) of the schedule, both steps, offsets random +-64
     and near +-32767, scalars 8/6 and 10/10 (the uint32 sums wrap), K4
     new and in place; K3's layer shards for sp = 2 and 4 at radius 12 and
     16, stacked against the full K3; flow_step (K3 then K4, one call a
     pyramid step) against flow_step_reference over every step of a pan's
     pyramid at both geometries and radius 5/12/16 (offsets, raw delta,
     K3's sums), and run twice for the same bits; pyramid_flow on 4K HDR
     panning frames at radius 16 and 5 against the plain run;
  4. K2 (batched warp) against its plain version at 4K HDR P010, on three
     flow grids: random +-64, smooth (K1 over random +-500) and mirror-edge
     (+-64 toward both edges in x and y), t = (0.4, 0.8) and (0.2, 0.6,
     1.0), levels 16/235, modes 0/1/2, exact;
     4b. K2's raw_blend variant (mode 2 without levels) against its plain
     version, same sources and flows, t = (0.2, 0.6, 1.0), exact;
     4c. the HSV flow colour (mode 3) on the card against the same function
     on the CPU, every (ox, oy) in +-512, SDR and HDR, res_impact 1 and 4,
     channels 0/1/2, exact; K5 (the HSV flow overlay) against its plain
     version, exact: every (ox, oy) in +-512 as the colour's pair on Y and on
     both UV channels, SDR and HDR, res_impact 4 (rs 0) and 1 (rs 3); 4K HDR
     on K2's raw blend of the three flows at T = 1 and 3; rs 1-3 at 50 x 86
     (ragged rows, rows off 16 bytes, row offsets, the int16 range) and 1080p
     SDR at rs 2 (K5 is off the served path since K2's mode 3; phase 4c
     holds it, and K2's raw_blend variant, as 4b does);
     4d. K2's mode 3 (the HSV flow overlay in K2's epilogue, one launch)
     against its plain version, exact: 4K HDR on the three flows at T = 1
     and 3 (also equal to K2 raw_blend + K5 on the same inputs); the row
     bands at n = 2, 4 and 8 against their plain bands and stacked against
     the full frame; rs 1-3 at 50 x 86 (with bands of n = 3, t outside
     [0, 1], the int16 range) and 1080p SDR at rs 2; a flow grid at rs 0
     whose cells run through every (ox, oy) in +-512, SDR and HDR. It runs
     after phase 6, so that phases 5 and 6 measure the served stream in the
     process state they had before K2 took mode 3;
     4e. K2's modes 4, 5 and 6 (one launch each) against their plain version
     and against the composition each replaced (K2's mode 2 and
     warp_viz.side_by_side_1 / side_by_side_2; mode 4 grey_flow_frame),
     exact: 4K HDR on the three flows at T = 1 and 3; the row bands at n =
     2, 4 and 8 against their plain bands and stacked against the full
     frame; rs 1-3 at 50 x 86 (an odd half: mode 5's runs straddle it, mode
     6's V columns take the m_off path; bands of n = 3, t outside [0, 1],
     the int16 range), 1080p SDR at rs 2, and rs 0 with flow cells to
     +-32767. It runs after phase 6, as 4d does;
     4f. K6 (the levelled copy of both planes, one launch) against its plain
     version, exact: every SDR and HDR sample value as a frame at levels
     0/255, 16/235, 3/250 and the degenerate 16/16, 0/0, 16/0 and 235/16;
     random 4K HDR and 4K SDR frames and 86 x 50 (planes whose lengths are
     not a multiple of 16 bytes) at 16/235, and 86 x 50 one sample off 16
     bytes; one launch a call, into new planes. It runs after phase 6, as
     4d does;
  5. the served slice: FrameServer at 3840x2160 HDR, 24 -> 60, mode 2, levels
     16/235, search radius 16, ten panning frames through the kernels; the
     output count against the cadence controller's, the kernels' launch
     counters (K1 and flow_step must each have launched, 16 flow_step calls
     a flow and no standalone K3 or K4; each warmup copy one K6 launch and
     no plain copy on the card), every output against the
     same stream run with the plain versions, and all five golden fixtures
     replayed byte for byte;
     5b. served mode 3 (HSV flow) the same way: ten frames through K1,
     flow_step and K2's mode 3 (no raw_blend, no K5 launched; the
     plain-version stream launches nothing);
     5c. served modes 4, 5 and 6, six frames each: K1, flow_step and K2 in
     the mode, exactly one K2 launch an interpolated output, and no mode-2
     (or mode-3) K2 launch; in 5b and 5c too, one K6 launch a copy;
     5d. served mode 3 at 4K HDR with the quality scaler on, 30 panning
     frames: the radius, the cadence state and the engine compute (flow +
     warps, what the scaler reads) of each source frame, and its
     ACTIVE/TOO_SLOW edges; it fails if the stream ever enters TOO_SLOW, a
     kernel of the path never launched or the old chain launched. The same
     frames through that chain (K2's raw_blend variant, then K5: mode 3's
     path before K2's mode 3) and with the plain overlay (mode 3's path
     before K5) are reported beside it;
  6. the numbers: served wall time per source frame (host clock around
     push_frame), flow time per source frame, warp time per output, copy
     time, peak memory, and a torch.profiler pass over three more served
     frames: device busy time, idle share and launches per source frame, and
     device time by kind (it fails if K3's fill ran); the warp time per
     output of modes 3-6 (CUDA
     events) from 5b/5c, and of mode 3 in 5d on K2's mode 3, on the chain
     and with the plain overlay; K2's mode 3 at 4K HDR, T = 1 and 3,
     graph-timed in turns with the chain it replaced (K2 raw_blend + K5) on
     the same inputs, on random and smooth flow, with its host us a call
     and the chain's, its plain version, an empty launch of its one grid,
     its bound (both sources' Y planes and the flow read, both planes
     written; operations counted from its code) and its ratios to the bound
     and to the chain; K2's modes 4, 5 and 6 at 4K HDR, T = 1 and 3,
     graph-timed in turns with an empty launch of their grid, with host us a
     call, the plain version, the bound and the composition each replaced
     (CUDA events over back-to-back calls, the kernel's beside it: the
     composition copies scalars to the card, which a CUDA graph cannot
     capture); K5 at 4K HDR on K2's raw blend, T = 1 and 3, graph-timed on
     random and smooth flow, with its host us a call, its plain version, an
     empty launch of its two grids and its bound (the raw Y plane and the
     flow read, both planes written; operations counted from its code); and
     K6 at 4K HDR and 4K SDR, graph-timed over 8 source frames in turn
     (more than the L2 holds) in turns with an empty launch of its grid,
     with host us a call, its plain version and its bound (both planes read
     and written once), beside the served copy (phase 5's median); and
     the kernels' device times, graph-timed (n
     calls captured in one CUDA graph, the replay timed with CUDA events, so
     no host time is in them) on random and on smooth flow: K1, K2 (mode 2
     T = 3) and its raw_blend variant, each wrapper's host us per call (the
     host clock over back-to-back calls before a synchronise), the plain
     versions (CUDA events), and the floor of an empty launch; beside them,
     what holds K2: mode 0 T = 3 and mode 2 T = 1, zero and pan flow, and a
     copy of K2's bytes (the card's reachable rate); the flow a source
     frame at radius 16 and 5 (in turns on one server), the flow_step,
     standalone K3 and K4 calls a source frame, and K3 (with its fill, and
     alone as flow_step launches it), K4 and flow_step on one 4K HDR flow's
     16 steps at radius 16 and 5, graph-timed, with their plain versions,
     host us a call and bound (the largest of HBM bytes, L2 bytes over this
     run's L2 read rate and int32 operations), and K3's and K4's timing
     variants (gathers at the cell's own pixel, one store a thread in place
     of the reduction, an empty launch of each grid, K4's serial scan, K4
     without its scan, K4 without its offsets' loads);
  7. the parallel path:
     7a. K2's mesh-sharded variant (warp_frames_band) against its plain
     version for every shard, and the shards stacked against the full K2:
     4K HDR P010, flow +-64, t (0.2, 0.6, 1.0), modes 0/1/2, levels 16/235,
     n = 2, 4, 8; smooth and mirror-edge flow at n = 2; and 1080p SDR at n =
     8, where UV's rows split unevenly; mode 3 at 4K HDR, n = 2: the band
     in mode 3 against the plain row route; the band's raw_blend variant
     against its plain version (each flow), coloured by K5 with the band's
     row offsets against K5's plain version and the plain row route; the
     band graph-timed on random and smooth flow, as phase 6;
     7b. batched_step on two 4K HDR streams (panning 3 px/frame, radius 16,
     three steps): outputs, flow and delta against the single-stream path
     (pyramid_flow + K2), and against the same run on the plain versions;
     K1, flow_step and K2 must each have launched; then in mode 3, each
     output against the single-stream K2 mode 3 (K2's mode 3 must have
     launched, and neither K5, the raw_blend variant nor mode 2); in modes
     4, 5 and 6, one K2 launch in the mode a stream and step, each output
     against the single-stream warp_outputs;
     7c. make_multichip_step through launch.run_ranks at 4K HDR, rs 3, modes
     2-6, t_batch 3, on meshes (1, 2) and (2, 1) of ranks sharing this card
     over gloo (and (1, 4), (2, 2) over NCCL where four cards are visible):
     each rank writes its outputs to an .npz, held byte for byte to 7b's
     single-device results (modes 3-6: warp_viz.warp_outputs on the full
     frame); every rank must have launched the band kernel once a step in
     each mode, on that mode's counter (modes 0-2, 3, 4-6) and on no other,
     the
     standalone K3 and K4 (the mesh gathers the layer shards between them)
     in every mode, and no
     rank may load a module of jax or of the JAX package. Its numbers: each
     rank's second step in each mode (CUDA events in the ranks);
  8. the probes P1-P4 (hopperrender_tpu_torch/probes/):
     8a. each kernel against its plain version, exactly: every P1 and P2
     variant at n = 0 to 1,031 (around the kernels' groups of 8 iterations
     and the 512-entry table's wrap) on 1 block and on 132, every slot;
     P3's three and P4's seven at indices and offsets whose windows clamp;
     transpose8 refused before a launch;
     8b. the probe path (probes/__main__.run_probe, what `python -m
     hopperrender_tpu_torch.probes` runs) with the counters at 0: chain and
     chain2 at 1 and 132 blocks (ns per iteration by the slope over n =
     20,000 and 120,000), the gather and mosaic kernels, and the block-gather
     rates; every probe kernel must have launched; and for every P1/P2
     variant on 132 blocks t(n = 120,000) / t(n = 20,000) >= 4, or the run
     fails: a loop whose loads were dropped would not grow with n;
     8c. each probe's kernels against their plain versions and the bound,
     graph-timed (n calls in one CUDA graph; P1/P2 at n = 600 on 132 blocks)
     against an empty launch per variant timed beside them (the floor); P3's
     and P4's against their one-call PyTorch counterparts (torch.gather;
     slicing copied out and torch.roll), each first checked equal to the
     kernel's output; host us per wrapper call and per library call. The
     card's L2 read rate (132 blocks stream a 2 MB buffer in step), which
     bounds P1 and P2 with their L2 bytes (the distinct 32-byte sectors each
     iteration reads, per block); a P1/P2 variant timed below 0.95 of its
     bound fails the run: that bound or that kernel is wrong;
  9. the serving surface:
     9a. `python -m hopperrender_tpu_torch interpolate` and `serve
     --status-port 0 --stats`, two processes at once, on 12 panning 1080p
     SDR frames, mode 2, 24 -> 60, the scaler off: both Y4M outputs byte-equal
     to each other and to the stream through FrameServers in this process on
     the kernels and on the plain versions; each CLI process's K1, K2,
     flow_step, K3, K4 and K6 counters (set to 0 before, printed at exit;
     K1, K2, flow_step and K6 must have moved, 16 flow_step calls a flow,
     no standalone K3 or K4) and the native ring loaded;
     9b. the four pinned-digest streams of tests/fixtures/digests.json, K6
     launched and no plain copy on the card;
     9c. PipelinedServer with the StatusServer, 4K HDR P010 24 -> 60, mode
     2, levels 16/235, the quality scaler on, 40 panning frames, /metrics
     and /healthz polled throughout: the radius per source frame, the
     ACTIVE/TOO_SLOW edges (whether TooSlow trips and recovers), the median
     flow and push_frame times and the output fps, printed; it fails if the
     scaler's recorded calls differ from their replay on a fresh
     AutoQualityScaler, a kernel of the path never launched, a radius leaves [5,
     16], an output made while TOO_SLOW is not the copy of its source
     frame (the plain copy on the card), a copy (warmup or TOO_SLOW) was
     not one K6 launch or a plain copy ran on the card, the engine thread
     raised, or /healthz answered other than 200;
 10. the bench (hopperrender_tpu_torch/bench.py, the port of the JAX
     package's bench.py):
     10a. bench.main in this process, stdout captured, for `--config 4k-hdr
     --json-only` (radius auto), `--config 4k-hdr --target-fps 120
     --radius 16`, and `--config 4k-hdr --radius 16` and `--radius 5` in
     turns (16, 5, 5, 16): the last line's metric, a radius bucket, a
     positive value and vs_baseline = 41.667 / value, not partial, not
     bench_failed, and K1, flow_step (16 a flow) and K2 launched in each
     run;
     10b. the bench units (flow_unit at radius 16, warp_unit and
     warp_batch_unit in modes 0/1/2) on 4K HDR panning frames on the card
     against the same calls on a CPU engine, exactly;
     10c. `python -m hopperrender_tpu_torch.bench --config 1080p-sdr
     --radius 16 --json-only` in a process of its own on the default device.
     It prints each run's flow, warp and per-source ms at each radius
     measured beside phase 6's median flow; no rule is set on any time.

Before each served path, the probe path and each of 10a's runs, every launch counter
is set to 0, and after it each kernel of that path must have launched (the
ranks of 7c and the CLI's processes of 9a start at 0). Then one JSON line of
the kernels
(with each one's bound: the least time the card could take for its work;
`ms` the graph-timed time on random flow, `smooth_ms` on smooth flow for
K1, K2, raw_blend and the band, and their `host_us`; K1's, K2's,
flow_step's, K3's and K4's `cli_launches` in 9a's two CLI processes and
`bench_launches` in 10a's runs; flow_step's, K3's and K4's ms, plain_ms,
host_us and bound a call over one 4K HDR flow at radius 16 (`r5` at radius
5), `launches_per_source_frame`, `batched_launches` (7b) and
`mesh_launches` (7c's ranks), flow_step's `launches` those of the served
slice (phase 5), K3's and K4's those of the mesh (7c), their path, with
`main_path_launches` (0) beside them, and K3's timing `variants`; K5's
`ms`, `plain_ms`, `host_us` and bound at T = 1 (as mode 3 was served), `t3`
at T = 3, `grid_ms`, its `launches` those of the served mode-3 path (5b;
0 since K2's mode 3) beside 5d's, 4c's (`parity_launches`) and 7a's; K2's
mode 3 (`warp_frames_mode3`) the same at T = 1 and 3, with `chain_ms` (K2
raw_blend + K5 on the same inputs) and `vs_chain`, its `launches` in 5b
beside 5d's, 4d's, 7b's, 7a's and 7c's; K2's modes 4, 5 and 6
(`warp_frames_mode4` .. `mode6`) the same at T = 1 and 3, with
`composition_ms` (the composition each replaced, CUDA events) beside
`events_ms`, `launches` those of the served mode (5c) beside 4e's, 7b's
and 7c's, and for modes 5 and 6 `registers` (ptxas's, the most any of the
mode's instances takes) and `spill_bytes` (the most any of them and the
element-by-element functions spill); K2 raw_blend's `launches` those of
5b (0) beside 4b's (`parity_launches`) and 7a's bands'; the band's
`launches` 7c's in mode 2, and `launches_by_mode` (each mode's own
counter); K6's (`copy_frame`) `ms`, `plain_ms`, `host_us`, `grid_ms` and
bound at 4K HDR (`sdr`: at 4K SDR), `served_copy_ms` phase 5's median
copy, `launches` phase 5's warmup copies beside 5b/5c's (`viz_launches`),
9a's (`cli_launches`), 9b's, 9c's and 4f's (`parity_launches`); for the
probes `ms`
summed over the variants, graph-timed, P1/P2's bound beside the bound
without its L2 term (`bound_ms_without_l2`) and each variant's ms and
bound, `host_us` and `library_host_us` the means over the variants,
`floor_ms` the variants' count times an empty launch),
nvidia-smi's line, and as the last line {"ok": true, "device": {...}}. Any
failure raises: the script exits non-zero and prints no result. It imports
nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import io
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W = 2160, 3840           # 4K
LOW = (2, 270, 480)         # its flow grid (res_scalar 3)
P010_MASK = 0xFFC0          # 10-bit samples, MSB-aligned in 16 bits
N_PROFILED = 3              # served frames run under torch.profiler in phase 6
FIXTURES = ("480p-sdr", "4k-sdr", "4k-hdr", "1080p-sdr", "live")

# The bound of a kernel: the larger of its bytes (each input read once, each
# output written once) over the memory rate and its operations over the rate
# of their type: float32 on the CUDA cores from the H100 SXM data sheet;
# int32 from its 132 SMs of 64 INT32 lanes each (NVIDIA's Hopper
# architecture paper) at the 1,980 MHz boost clock.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Arithmetic operations per output element, integer and float alike: K1's
# separable 8x8 box sum (7 + 7 adds) and its truncating division; K2's flow
# lookup and back-projection (~10), two warped positions (~16 each: product,
# round, mirror, clamp, index), the blend (~4) and, for mode 2, the levels
# (~4). The raw_blend variant has no levels. K1's are integer operations.
OPS_PER_ELEMENT = {"blur_flow": 16, "warp_frames": 50, "warp_frames_raw_blend": 46,
                   "warp_frames_band": 50}
OPS_RATE = {"blur_flow": INT32_OPS_PER_S}
# The probes' least work, in integer operations (a load counts as one):
# (per element, per tile) of one iteration for P1/P2, of one launch for
# P3/P4. Per element: its address, its loads, its XOR, add or write. Per
# tile, once: what every element shares (the table's fields, c >> 2 and the
# lane start, the row start, the window clamps at 4 each, the tile's base
# address, the loop's count and test). Terms that no iteration changes
# (static rolls, P2's residual row group and lane p) are made before the
# loop and not counted. full and full_aligned_rows write only the 8 x 16
# elements of lanes [t_sub, t_sub + 16); each costs FULL_SECOND_WORD_OPS more
# (the second word's lane, address, load, two shifts and the OR) in the
# iterations whose c & 3 is not 0. Where the function needs fewer operations
# than the TPU kernel's formulation, the count is the fewer: roll0's row roll
# is one offset of the tile's window (per tile), not a roll of every element;
# slice_static_x17's XOR of 17 neighbouring lanes is a sliding window of one
# row, its address, its load, a prefix XOR and the XOR of two prefixes, then
# the fold, where the TPU kernel makes 17 loads and 17 XORs per element.
PROBE_OPS = {
    "chain_probe": {"empty": (1, 4), "smem_only": (1, 9), "load8x128": (3, 19),
                    "load8x256": (3, 19), "load16x256": (3, 19), "roll0": (3, 20),
                    "roll0_static": (3, 19), "roll1": (6, 20), "roll1_static": (3, 19),
                    "roll1_128": (6, 20), "full": (8, 28), "full_aligned_rows": (6, 28)},
    "chain_probe2": {"slice_static": (3, 19), "slice_static_x17": (5, 19), "vsel_x17": (9, 13),
                     "fastpath_tile": (9, 13), "cond_branch": (3, 22),
                     "dyngather_ax0_8": (6, 18), "dyngather_ax0_32": (6, 18),
                     "dyngather_ax0_256": (6, 18), "dyngather_ax1_8": (6, 18),
                     "dyngather_ax1_32": (6, 18)},
    "gather_probe": {"take_along_sublane": (8, 0), "take_along_lane": (9, 0),
                     "vector_index": (7, 0)},
    "mosaic_probe": {"dyn_sublane": (2, 6), "dyn_sublane_aligned": (2, 7),
                     "dyn_lane_aligned": (2, 7), "dyn_both": (2, 12), "dyn_roll_lane": (4, 1),
                     "dyn_roll_sublane": (4, 1), "dyn_sublane_16": (5, 7)},
}
FULL_LANES, FULL_SECOND_WORD_OPS = 8 * 16, 7
PROBE_N, PROBE_BLOCKS = 600, (1, 132)     # timed: past the table; one SM and every SM
# P1/P2 parity: around the kernels' groups of 8 iterations and the table's wrap.
PARITY_NS = (0, 1, 2, 3, 7, 8, 9, 511, 512, 513, 600, 1031)
# Calls captured in one CUDA graph (P3/P4), and back-to-back calls on the
# host clock (P3/P4; P1/P2, whose n = PROBE_N iterations queue up on the card
# while the host goes on).
PROBE_GRAPH_CALLS, HOST_CALLS, CHAIN_HOST_CALLS = 200, 1000, 200
# P1/P2 calls captured in one CUDA graph (n = PROBE_N on 132 blocks); the
# least ratio t(n2) / t(n1) of the probe path's two loop counts (20,000 and
# 120,000) on 132 blocks that the check that their time grows with n accepts
# (an unchanged loop gives 6; a loop whose loads were dropped about 1); and
# the least ratio of a P1/P2 variant's time to its bound (below it, the
# bound or the kernel is wrong).
CHAIN_GRAPH_CALLS, MIN_SCALING, MIN_BOUND_RATIO = 20, 4.0, 0.95
# The L2 read rate (csrc/errors.cu, hrt_l2_read): blocks, and passes over a
# 2 MB buffer per block; the bytes of one sector, P1/P2's L2 traffic unit.
L2_BLOCKS, L2_PASSES, SECTOR_BYTES = 132, 40, 32


def log(line: str) -> None:
    print(line, flush=True)


def import_port() -> types.SimpleNamespace:
    """Everything the run uses, imported from hopperrender_tpu_torch only."""
    from hopperrender_tpu_torch import _build, bench, config, entry
    from hopperrender_tpu_torch.config import Settings
    from hopperrender_tpu_torch.engine import flow_engine
    from hopperrender_tpu_torch.engine.flow_engine import OpticalFlowEngine
    from hopperrender_tpu_torch.ops import blur_kernel, warp_kernel, warp_viz
    from hopperrender_tpu_torch.ops import flow as flow_ops
    from hopperrender_tpu_torch.ops import warp as warp_ops
    from hopperrender_tpu_torch.parallel import launch
    from hopperrender_tpu_torch.parallel.batched import batched_step
    from hopperrender_tpu_torch.probes import __main__ as probe_path
    from hopperrender_tpu_torch.probes import chain_probe, chain_probe2, gather_probe
    from hopperrender_tpu_torch.probes import mosaic_probe
    from hopperrender_tpu_torch import native
    from hopperrender_tpu_torch.server import digests
    from hopperrender_tpu_torch.server.control import AutoQualityScaler, CadenceController
    from hopperrender_tpu_torch.server.frame_server import FrameServer
    from hopperrender_tpu_torch.server.pipeline import PipelinedServer
    from hopperrender_tpu_torch.server.status_http import StatusServer
    from hopperrender_tpu_torch.vio import nv12, video
    # K3 and K4; None in a tree from before them (--kernel-times copied there).
    cv_name = "hopperrender_tpu_torch.ops.cost_volume_kernel"
    cost_volume_kernel = (importlib.import_module(cv_name) if importlib.util.find_spec(cv_name)
                          else None)
    # K5; None in a tree from before it.
    hsv_name = "hopperrender_tpu_torch.ops.hsv_kernel"
    hsv_kernel = (importlib.import_module(hsv_name) if importlib.util.find_spec(hsv_name)
                  else None)
    # K6; None in a tree from before it.
    copy_name = "hopperrender_tpu_torch.ops.copy_kernel"
    copy_kernel = (importlib.import_module(copy_name) if importlib.util.find_spec(copy_name)
                   else None)
    return types.SimpleNamespace(
        _build=_build, blur_kernel=blur_kernel, warp_kernel=warp_kernel, warp_viz=warp_viz,
        cost_volume_kernel=cost_volume_kernel, hsv_kernel=hsv_kernel, copy_kernel=copy_kernel,
        flow_engine=flow_engine,
        warp_ops=warp_ops, CadenceController=CadenceController, FrameServer=FrameServer,
        Settings=Settings, config=config, nv12=nv12, entry=entry, flow_ops=flow_ops,
        launch=launch, batched_step=batched_step, probe_path=probe_path,
        probes=dict(chain_probe=chain_probe, chain_probe2=chain_probe2,
                    gather_probe=gather_probe, mosaic_probe=mosaic_probe),
        native=native, video=video, digests=digests, AutoQualityScaler=AutoQualityScaler,
        PipelinedServer=PipelinedServer, StatusServer=StatusServer, bench=bench,
        OpticalFlowEngine=OpticalFlowEngine)


@contextlib.contextmanager
def plain_overlay(port):
    """Points K5's wrapper attribute (ops/hsv_kernel.hsv_flow_overlay) at its
    plain version while the block runs: mode 3's path as it was before K5.
    ops/warp_viz looks it up at call time."""
    hk = port.hsv_kernel
    kernel = hk.hsv_flow_overlay
    hk.hsv_flow_overlay = hk.hsv_flow_overlay_reference
    try:
        yield
    finally:
        hk.hsv_flow_overlay = kernel


def mode3_chain_call(port, kernel):
    """K2's wrapper `kernel` with mode 3 made as it was served before K2's
    mode 3: K2's raw_blend variant, then hsv_kernel.hsv_flow_overlay (K5, or
    what that attribute points at), one more wrapper call. Other modes go to
    `kernel` as they are."""
    hk = port.hsv_kernel

    def call(*args, mode, raw_blend=False, **kw):
        if mode != 3:
            return kernel(*args, mode=mode, raw_blend=raw_blend, **kw)
        raw = kernel(*args, mode=2, raw_blend=True, **kw)
        return hk.hsv_flow_overlay(*raw, args[4], *args[6:8], **kw)
    return call


@contextlib.contextmanager
def mode3_chain(port):
    """Points K2's wrapper attribute (ops/warp_kernel.warp_frames) at
    mode3_chain_call while the block runs: mode 3 served by the chain of K2's
    raw_blend variant and K5. ops/warp_viz looks it up at call time."""
    wk = port.warp_kernel
    kernel = wk.warp_frames
    wk.warp_frames = mode3_chain_call(port, kernel)
    try:
        yield
    finally:
        wk.warp_frames = kernel


@contextlib.contextmanager
def plain_versions(port):
    """Points the K1, K2, K3, K4, K5 and K6 wrappers' module attributes (K2's
    mesh-sharded variant and the pyramid step too) at their plain versions
    while the block runs; their callers (ops/flow.py, ops/warp_viz.py,
    parallel/mesh.py, the engine) look them up at call time."""
    wk, cv, ck = port.warp_kernel, port.cost_volume_kernel, port.copy_kernel
    kernels = (port.blur_kernel.blur_flow, wk.warp_frames, wk.warp_frames_band, cv.delta_sums,
               cv.commit_winners, cv.flow_step, ck.copy_frame)
    port.blur_kernel.blur_flow = port.blur_kernel.blur_flow_reference
    wk.warp_frames = wk.warp_frames_reference  # raw_blend too
    wk.warp_frames_band = wk.warp_frames_band_reference
    cv.delta_sums, cv.commit_winners = cv.delta_sums_reference, cv.commit_winners_reference
    cv.flow_step = cv.flow_step_reference
    ck.copy_frame = ck.copy_frame_reference
    try:
        with plain_overlay(port):
            yield
    finally:
        (port.blur_kernel.blur_flow, wk.warp_frames, wk.warp_frames_band, cv.delta_sums,
         cv.commit_winners, cv.flow_step, ck.copy_frame) = kernels


@contextlib.contextmanager
def plain_copies_on_the_card(port):
    """Counts the calls of the plain copy (ops/warp.copy_frame, which K6's
    plain version calls) on CUDA tensors while the block runs: a list with
    one entry a call. A served stream on the card makes none."""
    wo = port.warp_ops
    plain, calls = wo.copy_frame, []

    def counting(src_y, *args, **kw):
        if src_y.is_cuda:
            calls.append(tuple(src_y.shape))
        return plain(src_y, *args, **kw)

    wo.copy_frame = counting
    try:
        yield calls
    finally:
        wo.copy_frame = plain


def device_profile(prof, wall_s: float) -> tuple[float, int, dict[str, float]]:
    """Device busy seconds (union of the device events' intervals), device
    event count, and device ms by kind, from a finished torch.profiler run."""
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise AssertionError(f"the profiler recorded no device event in {wall_s:.3f} s")
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    kinds: dict[str, float] = {}
    for e in events:
        name = e.name
        kind = ("K1 blur_flow" if "blur_flow_kernel" in name else
                "K2 warp" if "warp_plane_kernel" in name else
                "K2 mode 3" if "warp_mode3_kernel" in name else
                "K2 modes 4-6" if "warp_viz_kernel" in name or "grey_flow_kernel" in name else
                "K3 delta_sums" if "delta_sums_kernel" in name else
                "K3's fill" if "fill_sums_kernel" in name else
                "K4 commit_winners" if "commit_winners_kernel" in name else
                "K5 hsv_overlay" if "hsv_overlay_kernel" in name else
                "K6 copy_frame" if "copy_frame_kernel" in name else
                "memcpy DtoH" if "DtoH" in name else
                "memcpy HtoD" if "HtoD" in name else
                "gather (index)" if "index" in name.lower() else "other")
        kinds[kind] = kinds.get(kind, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return busy_us / 1e6, len(events), kinds


def as_int32(t: torch.Tensor) -> torch.Tensor:
    from hopperrender_tpu_torch.ops.warp import to_int32
    return to_int32(t)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype differ: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    return int((as_int32(a) - as_int32(b)).abs().max())


def require_equal(a: torch.Tensor, b: torch.Tensor, what: str) -> int:
    err = max_abs_err(a, b)
    if err:
        diff = (as_int32(a) != as_int32(b)).nonzero()
        first = tuple(int(i) for i in diff[0])
        raise AssertionError(f"{what}: {diff.shape[0]} elements differ, max |err| {err}; "
                             f"first at {first}: kernel {int(as_int32(a)[first])} "
                             f"plain {int(as_int32(b)[first])}")
    return err


def time_ms(fn, n: int) -> float:
    """Mean device time of one call over n back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n: int, replays: int = 3) -> float:
    """Device ms of one call: n calls captured in one CUDA graph, the graph
    replayed `replays` times, each replay timed with CUDA events; the median
    replay over n. The host's share of a call (Python, ctypes, allocation) is
    not in it: the kernels run back to back on the device."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                        # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def host_us(fn, n: int) -> float:
    """Host microseconds per call: the host clock over n back-to-back calls,
    before any synchronise (the wrapper's Python, ctypes call and launch)."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(n):
        fn()
    us = 1e6 * (time.perf_counter() - start) / n
    torch.cuda.synchronize()
    return us


def empty_launch_ms(port) -> float | None:
    """Graph-timed device ms of an empty launch (csrc/errors.cu): the floor
    under any launch-bound kernel. None where the library has no such entry
    point (a tree from before it was added)."""
    lib = port._build.load().lib
    launch = getattr(lib, "hrt_empty_launch", None)
    if launch is None:
        return None
    return graph_ms(lambda: port._build.check(
        launch(torch.cuda.current_stream().cuda_stream), "empty launch"), 200)


def probe_library(port, x3, idx3, x4) -> dict:
    """The one-call PyTorch counterpart of each P3/P4 kernel at the scripts'
    inputs (idx (5, 128) for P4): torch.gather, and slicing copied out or
    torch.roll. The port never calls them."""
    idx3_long, idx3_lane = idx3.long(), (idx3 + 7).long()
    x3_128 = x3[:, :128]
    r0, _ = port.probes["mosaic_probe"].IDX
    ra = r0 & ~7
    return {
        "take_along_sublane": lambda: torch.gather(x3_128, 0, idx3_long),
        "take_along_lane": lambda: torch.gather(x3[:8], 1, idx3_lane),
        "vector_index": lambda: torch.gather(x3_128, 0, idx3_long),
        "dyn_sublane": lambda: x4[r0:r0 + 8].clone(),
        "dyn_sublane_aligned": lambda: x4[ra:ra + 8].clone(),
        "dyn_lane_aligned": lambda: x4[:8, 0:256].clone(),
        "dyn_both": lambda: x4[r0:r0 + 8, 0:256].clone(),
        "dyn_roll_lane": lambda: torch.roll(x4[:8], r0, 1),
        "dyn_roll_sublane": lambda: torch.roll(x4[:16], r0, 0)[:8],
        "dyn_sublane_16": lambda: torch.roll(x4[ra:ra + 16], -(r0 - ra), 0)[:8],
    }


def probe_numbers(port, dev) -> dict:
    """The probes' numbers at the scripts' inputs. P3 and P4: each variant's
    kernel and its one-call PyTorch counterpart (checked equal to the
    kernel's output first), graph-timed device ms (PROBE_GRAPH_CALLS calls
    in one CUDA graph) and host us per call (HOST_CALLS back-to-back
    calls); per probe ms and library_ms summed over the variants, host_us
    and library_host_us their means, empty_launch_ms the empty launch timed
    just before and just after the probe's variants (the mean; it moves
    over a run), floor_ms the variants' count times it, and each variant's
    four numbers. P1 and P2 the same way at n = PROBE_N on 132 blocks
    (CHAIN_GRAPH_CALLS calls in a graph), with no library call; their
    host_us on one block over CHAIN_HOST_CALLS calls. "l2_read" is the L2
    read rate (l2_read_rate; None in a tree without it)."""
    p1, p2, p3, p4 = (port.probes[k] for k in ("chain_probe", "chain_probe2", "gather_probe",
                                               "mosaic_probe"))
    x3, idx3 = p3.make_inputs(dev)
    idx4, x4 = p4.make_inputs(device=dev)
    library = probe_library(port, x3, idx3, x4)
    p1_in, p2_in = p1.make_inputs(0, dev), p2.make_inputs(0, dev)
    B = PROBE_BLOCKS[-1]
    out = {"l2_read": l2_read_rate(port, dev)}
    for name, mod, args in (("gather_probe", p3, (x3, idx3)), ("mosaic_probe", p4, (idx4, x4)),
                            ("chain_probe", p1, p1_in), ("chain_probe2", p2, p2_in)):
        chain = name.startswith("chain")
        floors, per = [empty_launch_ms(port)], {}
        for v in (mod.KERNEL_VARIANTS if mod is p2 else mod.VARIANTS):
            if chain:
                kernel = lambda v=v: mod.run(v, PROBE_N, *args, blocks=B)
                per[v] = {"ms": graph_ms(kernel, CHAIN_GRAPH_CALLS, 5),
                          "host_us": host_us(lambda v=v: mod.run(v, PROBE_N, *args),
                                             CHAIN_HOST_CALLS)}
                continue
            kernel, lib_call = (lambda v=v: mod.run(v, *args)), library[v]
            require_equal(lib_call(), kernel(), f"{name} {v}: the library call")
            per[v] = {"ms": graph_ms(kernel, PROBE_GRAPH_CALLS, 5),
                      "library_ms": graph_ms(lib_call, PROBE_GRAPH_CALLS, 5),
                      "host_us": host_us(kernel, HOST_CALLS),
                      "library_host_us": host_us(lib_call, HOST_CALLS)}
        floors.append(empty_launch_ms(port))
        floor = None if None in floors else statistics.mean(floors)
        out[name] = {"ms": sum(p["ms"] for p in per.values()),
                     "library_ms": None if chain else sum(p["library_ms"] for p in per.values()),
                     "host_us": statistics.mean(p["host_us"] for p in per.values()),
                     "library_host_us": None if chain else statistics.mean(
                         p["library_host_us"] for p in per.values()),
                     "empty_launch_ms": floor,
                     "floor_ms": None if floor is None else len(per) * floor, "variants": per}
    return out


def format_l2(rate: dict) -> str:
    return f"{rate['bytes_per_s'] / 1e12:.3f} TB/s ({rate['ms']:.4f} ms for {rate['bytes']} bytes)"


def format_probe_numbers(numbers: dict) -> str:
    parts = []
    for name, v in numbers.items():
        if name == "l2_read":
            parts.append("L2 read rate not in this build" if v is None else
                         f"L2 read rate {format_l2(v)}")
            continue
        floor = "not in this build" if v["floor_ms"] is None else f"{v['floor_ms']:.5f} ms"
        lib = ("" if v["library_ms"] is None else f"; library {v['library_ms']:.5f} ms, host "
               f"{v['library_host_us']:.2f} us/call")
        each = ", ".join(f"{k} {p['ms']:.5f}" for k, p in v["variants"].items())
        parts.append(f"{name} ({len(v['variants'])} variants) {v['ms']:.5f} ms, floor {floor}, "
                     f"host {v['host_us']:.2f} us/call{lib} [{each}]")
    return "; ".join(parts)


def wrapper_split(port, dev, n: int = 2000) -> dict:
    """Host us of each stage of one wrapper call, each stage alone over n
    back-to-back calls. Shared: the stages of the older launch path
    (_build.load, the device context, current_stream(...).cuda_stream) and
    of the shared one (_build.entry where the tree has it, the
    current-device test, the raw stream), the device tests, data_ptr, the
    counter, a ctypes call of five arguments that launches nothing (where
    the tree has hrt_floor_launch) and an empty lambda (the loop's own cost,
    in every stage). Per
    wrapper, P4 (dyn_both, its script inputs) and K1 (a (2, 33, 65) flow, so
    that no launch waits for the device): the checks, the allocation
    (torch.empty with its arguments, new_empty, empty_like), the ctypes
    call (a real launch) and the whole call."""
    b, p4, k1 = port._build, port.probes["mosaic_probe"], port.blur_kernel
    idx, x = p4.make_inputs(device=dev)
    offsets = torch.zeros((2, 33, 65), dtype=torch.int16, device=dev)
    lib, index = b.load().lib, dev.index
    stream = torch.cuda.current_stream(dev).cuda_stream
    out4, out1 = torch.empty(p4.OUT_SHAPE, dtype=torch.int32, device=dev), torch.empty_like(offsets)
    dyn_both = p4.VARIANTS.index("dyn_both")
    raw_stream = torch._C._cuda_getCurrentRawStream

    def device_context():
        with torch.cuda.device(dev):
            pass

    def counter():
        p4.run.launches += 1

    def k1_check():
        if offsets.dtype != torch.int16 or offsets.dim() != 3 or offsets.shape[0] != 2:
            raise AssertionError
        return offsets.device.type == "cpu" or not offsets.is_contiguous()

    launches = p4.run.launches, k1.blur_flow.launches
    shared = {"empty lambda": lambda: None, "_build.load()": b.load,
              "device context": device_context,
              "current_stream(...).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
              "current-device test": lambda: torch._C._cuda_getDevice() == index,
              "raw stream": lambda: raw_stream(index), "x.device.type": lambda: x.device.type,
              "x.is_cuda": lambda: x.is_cuda, "x.get_device()": x.get_device,
              "data_ptr()": x.data_ptr, "counter": counter}
    stages = {
        "mosaic_probe dyn_both": {
            "_check": lambda: p4._check("dyn_both", idx, x),
            "torch.empty(shape, dtype=, device=)": lambda: torch.empty(
                p4.OUT_SHAPE, dtype=torch.int32, device=dev),
            "x.new_empty(shape)": lambda: x.new_empty(p4.OUT_SHAPE),
            "torch.empty_like": lambda: torch.empty_like(out4),
            "ctypes call": lambda: lib.hrt_mosaic_probe(dyn_both, idx.data_ptr(), x.data_ptr(),
                                                        out4.data_ptr(), stream),
            "whole call": lambda: p4.run("dyn_both", idx, x)},
        "blur_flow (2, 33, 65)": {
            "_check": k1_check, "torch.empty_like": lambda: torch.empty_like(offsets),
            "ctypes call": lambda: lib.hrt_blur_flow(offsets.data_ptr(), out1.data_ptr(), 33, 65,
                                                     stream),
            "whole call": lambda: k1.blur_flow(offsets)}}
    if hasattr(b, "entry"):
        shared["_build.entry()"] = lambda: b.entry("hrt_mosaic_probe")
    floor_launch = getattr(lib, "hrt_floor_launch", None)
    if floor_launch is not None:   # five arguments, as P4's entry point; no launch
        shared["ctypes call without a launch"] = lambda: floor_launch(3, 32, idx.data_ptr(),
                                                                      out4.data_ptr(), stream)
    split = {what: {stage: host_us(fn, n) for stage, fn in fns.items()}
             for what, fns in {"shared": shared, **stages}.items()}
    p4.run.launches, k1.blur_flow.launches = launches
    return split


def floor_numbers(port, dev) -> dict | None:
    """Graph-timed device ms of the launches that take a one-block kernel's
    floor apart (hrt_floor_launch, csrc/errors.cu): one block of 32, 256 or
    512 threads that does nothing, makes one L2 round trip, or two dependent
    ones (P3's index and element, P4's offsets and window). None where the
    tree has no such entry point."""
    launch = getattr(port._build.load().lib, "hrt_floor_launch", None)
    if launch is None:
        return None
    src = torch.arange(128, dtype=torch.int32, device=dev)
    out = torch.empty(1024, dtype=torch.int32, device=dev)
    numbers = {}
    for kind, what, want in ((0, "empty", None), (1, "one load", 0), (2, "two dependent loads", 64)):
        for threads in (32, 256, 512):
            def call(kind=kind, threads=threads):
                port._build.check(launch(kind, threads, src.data_ptr(), out.data_ptr(),
                                         torch.cuda.current_stream().cuda_stream), "floor launch")
            if want is not None:
                out.fill_(-1)
                call()
                if int((out[:threads] != want).sum()):
                    raise AssertionError(f"floor launch {what} 1x{threads}: wrong values")
            numbers[f"{what} 1x{threads}"] = graph_ms(call, PROBE_GRAPH_CALLS, 5)
    return numbers


def format_split(split: dict) -> str:
    return "; ".join(f"{what}: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
                     for what, stages in split.items())


def smooth_flow(port, rng) -> torch.Tensor:
    """A smooth 4K flow grid: K1 over random +-500 offsets (the box average of
    8x8 cells; neighbouring cells share 7/8 of their window), +-60 or so."""
    offsets = torch.tensor(rng.integers(-500, 501, LOW).astype(np.int16), device="cuda")
    return port.blur_kernel.blur_flow(offsets)


def edge_flow(rng) -> torch.Tensor:
    """A 4K flow grid that drives runs across both mirror edges in x and in y:
    +64 in the left (top) half, -64 in the right (bottom) half, +-8 noise."""
    _, low_h, low_w = LOW
    yy, xx = np.mgrid[0:low_h, 0:low_w]
    noise = rng.integers(-8, 9, LOW)
    fx = np.where(xx < low_w // 2, 64, -64) + noise[0]
    fy = np.where(yy < low_h // 2, 64, -64) + noise[1]
    return torch.tensor(np.stack([fx, fy]).astype(np.int16), device="cuda")


def k2_inputs(port, dev) -> types.SimpleNamespace:
    """Phases 3, 4 and 6's inputs, from seed 0: K1's random +-500 offsets, two
    4K P010 source frames, and three flow grids: random +-64, smooth and
    mirror-edge."""
    rng = np.random.default_rng(0)
    offsets = torch.tensor(rng.integers(-500, 501, LOW).astype(np.int16), device=dev)

    def p010(shape):
        return torch.tensor(rng.integers(0, 1024, shape, dtype=np.uint16) << 6, device=dev)

    src = [p010((H, W)), p010((H // 2, W)), p010((H, W)), p010((H // 2, W))]
    flow = torch.tensor(rng.integers(-64, 65, LOW).astype(np.int16), device=dev)
    flows = {"random +-64": flow, "smooth": smooth_flow(port, rng), "mirror-edge": edge_flow(rng)}
    return types.SimpleNamespace(
        rng=rng, offsets=offsets, src=src, flows=flows,
        t1=torch.tensor((0.6,), dtype=torch.float32, device=dev),
        t3=torch.tensor((0.2, 0.6, 1.0), dtype=torch.float32, device=dev),
        black=16 * 256.0, white=235 * 256.0)


def band_numbers(port, src, flows: dict, t3, black: float, white: float) -> dict:
    """K2's band (n 2, shard 0, mode 2, T = 3, 4K HDR): graph-timed device ms
    on random and on smooth flow, host us per call, plain ms (CUDA events)."""
    wk = port.warp_kernel
    kw = dict(res_scalar=3, mode=2, is_hdr=True, num_shards=2, shard_index=0)

    def band(fl, fn=wk.warp_frames_band):
        return lambda: fn(*src, fl, t3, black, white, **kw)

    random, plain = flows["random +-64"], band(flows["random +-64"],
                                               wk.warp_frames_band_reference)
    return {"ms": graph_ms(band(random), 20), "smooth_ms": graph_ms(band(flows["smooth"]), 20),
            "host_us": host_us(band(random), 20),
            "plain_ms": (time_ms(plain, 2) + time_ms(plain, 2)) / 2}


def kernel_numbers(port, inp) -> dict:
    """Phase 6's kernel numbers at 4K HDR: K1, K2 (mode 2 T = 3) and its
    raw_blend variant, each graph-timed on random and on smooth flow, host us
    per wrapper call, the plain version's ms (CUDA events), and the
    empty-launch floor. To see what holds K2: mode 0 T = 3 and mode 2 T = 1
    on random, smooth and zero flow, mode 2 T = 3 on zero flow and on a
    pan, and a copy of K2's bytes."""
    k1, wk = port.blur_kernel, port.warp_kernel
    src, t1, t3, black, white = inp.src, inp.t1, inp.t3, inp.black, inp.white
    random, smooth = inp.flows["random +-64"], inp.flows["smooth"]

    def k2(fl, ts, mode=2, raw=False, fn=None):
        fn = fn or wk.warp_frames
        return lambda: fn(*src, fl, ts, black, white, res_scalar=3, mode=mode, is_hdr=True,
                          raw_blend=raw)

    def plain_ms(fn, n):
        return (time_ms(fn, n) + time_ms(fn, n)) / 2

    out = {"empty_launch_ms": empty_launch_ms(port)}
    out["blur_flow"] = {"ms": graph_ms(lambda: k1.blur_flow(inp.offsets), 200),
                        "smooth_ms": graph_ms(lambda: k1.blur_flow(smooth), 200),
                        "host_us": host_us(lambda: k1.blur_flow(inp.offsets), 200),
                        "plain_ms": plain_ms(lambda: k1.blur_flow_reference(inp.offsets), 20)}
    for name, mode, raw in (("warp_frames", 2, False), ("warp_frames_raw_blend", 2, True)):
        out[name] = {"ms": graph_ms(k2(random, t3, mode, raw), 20),
                     "smooth_ms": graph_ms(k2(smooth, t3, mode, raw), 20),
                     "host_us": host_us(k2(random, t3, mode, raw), 20),
                     "plain_ms": plain_ms(k2(random, t3, mode, raw, wk.warp_frames_reference), 2)}
    zero = torch.zeros_like(random)
    pan = zero.clone()
    pan[0] = 3       # every cell 3 px along x: the served stream's pan
    out["variants"] = {
        f"{label} {flow}": graph_ms(k2(fl, ts, mode), 20)
        for label, ts, mode in (("mode 0 T=3", t3, 0), ("mode 2 T=1", t1, 2))
        for flow, fl in (("random", random), ("smooth", smooth), ("zero flow", zero))}
    out["variants"]["mode 2 T=3 zero flow"] = graph_ms(k2(zero, t3, 2), 20)
    out["variants"]["mode 2 T=3 pan (3, 0)"] = graph_ms(k2(pan, t3, 2), 20)
    # The card's achievable rate for K2's bytes: a copy that reads half of
    # them and writes the other half.
    half = (nbytes(*src) + 3 * nbytes(src[0], src[1])) // 2
    buf, dst = (torch.empty(half, dtype=torch.uint8, device=random.device) for _ in range(2))
    out["variants"]["copy of K2's bytes"] = graph_ms(lambda: dst.copy_(buf), 20)
    return out


def format_numbers(numbers: dict) -> str:
    """One line of kernel_numbers (and band_numbers under "warp_frames_band")."""
    parts = []
    floor = numbers.get("empty_launch_ms")
    parts.append("empty launch " + ("not in this build" if floor is None else f"{floor:.5f} ms"))
    for name in ("blur_flow", "warp_frames", "warp_frames_raw_blend", "warp_frames_band"):
        if name in numbers:
            v = numbers[name]
            smooth = f", smooth {v['smooth_ms']:.5f}" if "smooth_ms" in v else ""
            parts.append(f"{name} {v['ms']:.5f} ms{smooth}, host {v['host_us']:.1f} us/call, "
                         f"plain {v['plain_ms']:.4f} ms")
    parts += [f"{k} {v:.5f} ms" for k, v in numbers.get("variants", {}).items()]
    return "; ".join(parts)


def replay_fixture(path: str, device) -> None:
    """A golden fixture through the port's engine, driven as
    tests/test_golden_fixtures.py drives the JAX engine; raises on any byte
    that differs."""
    from hopperrender_tpu_torch.engine.flow_engine import OpticalFlowEngine
    z = np.load(path)
    meta = z["meta"]
    h, w, is_hdr, mcr, nit, black, white, n_modes = (int(v) for v in meta[:8])
    modes = [int(v) for v in meta[8:8 + n_modes]]
    eng = OpticalFlowEngine(h, w, is_hdr=bool(is_hdr), max_calc_res=mcr, num_iterations=nit,
                            black_level=float(black), white_level=float(white), device=device)
    ys, uvs, deltas = [], [], []
    for i in range(z["in_y"].shape[0]):
        eng.update_frame(z["in_y"][i], z["in_uv"][i])
        if eng.frame_count < 3:
            outs = [eng.copy_frame()]
        else:
            eng.calculate_optical_flow()
            deltas.append(eng.fetch_total_frame_delta())
            outs = [eng.warp_frames(t, m) for m in modes for t in (0.25, 0.75)]
        for y, uv in outs:
            ys.append(y.cpu().numpy())
            uvs.append(uv.cpu().numpy())
    name = os.path.basename(path)
    for got, want, what in ((np.stack(ys), z["out_y"], "Y"), (np.stack(uvs), z["out_uv"], "UV"),
                            (np.asarray(deltas, np.int64), z["deltas"], "scene deltas")):
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: {what} differ from the fixture")


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def roofline(bytes_moved: int, ops: int, ops_per_s: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the bytes' time and the operations'."""
    bytes_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / ops_per_s
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def bound(name: str, bytes_moved: int, n_elements: int) -> tuple[float, str]:
    """(bound_ms, bound_by) of a kernel call that moves bytes_moved and
    computes n_elements output elements."""
    return roofline(bytes_moved, n_elements * OPS_PER_ELEMENT[name],
                    OPS_RATE.get(name, OPS_PER_S))


def launch_counters(port) -> dict:
    """Each kernel's name in the `kernels` line -> (its wrapper, the wrapper's
    counter attribute)."""
    wk, cv = port.warp_kernel, port.cost_volume_kernel
    return {"blur_flow": (port.blur_kernel.blur_flow, "launches"),
            "warp_frames": (wk.warp_frames, "launches"),
            "warp_frames_mode3": (wk.warp_frames, "mode3_launches"),
            "warp_frames_viz": (wk.warp_frames, "viz_launches"),
            "warp_frames_raw_blend": (wk.warp_frames, "raw_launches"),
            "warp_frames_band": (wk.warp_frames_band, "launches"),
            "warp_frames_band_mode3": (wk.warp_frames_band, "mode3_launches"),
            "warp_frames_band_viz": (wk.warp_frames_band, "viz_launches"),
            "flow_step": (cv.flow_step, "launches"),
            "delta_sums": (cv.delta_sums, "launches"),
            "commit_winners": (cv.commit_winners, "launches"),
            "hsv_flow_overlay": (port.hsv_kernel.hsv_flow_overlay, "launches"),
            "copy_frame": (port.copy_kernel.copy_frame, "launches")}


def reset_launches(port) -> None:
    for fn, attr in launch_counters(port).values():
        setattr(fn, attr, 0)


def read_launches(port) -> dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in launch_counters(port).items()}


# The flow's kernels: the main path's (pyramid_flow: a flow_step call a
# pyramid step, K3 then K4, then K1) and the mesh's (K3 on each layer shard,
# the all-gather, K4 on the gathered sums, then K1).
FLOW_KERNELS = ("flow_step", "blur_flow")
# The chain that served mode 3 before K2's mode 3: no served path launches it.
MODE3_OFF_PATH = ("warp_frames_raw_blend", "hsv_flow_overlay")
MESH_FLOW_KERNELS = ("delta_sums", "commit_winners")
STEPS_PER_FLOW = 16          # a 270 x 480 grid's schedule: 8 windows, two steps each


def require_launched(launches: dict, names, what: str) -> None:
    """Raise unless every kernel of `names` launched (its count is above 0)."""
    missing = [name for name in names if not launches.get(name)]
    if missing:
        raise AssertionError(f"{what}: kernels of the path never launched: {missing} "
                             f"({launches})")


def require_pyramid_path(launches: dict, what: str) -> None:
    """Raise unless every flow of the run went through flow_step, a call a
    pyramid step (STEPS_PER_FLOW for each K1 launch, one a flow), and no
    standalone K3 or K4 launched."""
    if launches["flow_step"] != STEPS_PER_FLOW * launches["blur_flow"] or any(
            launches[k] for k in MESH_FLOW_KERNELS):
        raise AssertionError(f"{what}: not {STEPS_PER_FLOW} flow_step calls a flow and no "
                             f"standalone K3/K4: {launches}")


def require_copies_on_k6(launches: dict, copies: int, plain_copies: list, what: str) -> None:
    """Raise unless each of a served run's `copies` outputs was one K6 launch
    and no plain copy ran on the card (plain_copies_on_the_card's list)."""
    if launches["copy_frame"] != copies or plain_copies:
        raise AssertionError(f"{what}: {launches['copy_frame']} K6 launches for {copies} "
                             f"copies, {len(plain_copies)} plain copies on the card")


def cadence_count(port, n_frames: int) -> int:
    """Outputs the cadence controller gives n_frames source frames at 24 -> 60."""
    cadence = port.CadenceController(24.0, 60.0)
    expected = 0
    for i in range(n_frames):
        n = cadence.begin_source_frame(i * cadence.source_frame_time)
        for _ in range(n):
            cadence.next_output_timing()
            cadence.advance_blending()
        expected += n
    return expected


def require_same_stream(outs, plain_outs, what: str) -> None:
    if len(plain_outs) != len(outs):
        raise AssertionError(f"{what}: the plain-version stream gave another output count")
    for i, (k, p) in enumerate(zip(outs, plain_outs)):
        if (k.start_time, k.end_time, k.interpolated) != (p.start_time, p.end_time, p.interpolated) \
                or not np.array_equal(k.y, p.y) or not np.array_equal(k.uv, p.uv):
            raise AssertionError(f"{what}: served output {i} differs from the plain-version stream")


def band_bound(src, flow, ts, num_shards: int, shard: int) -> tuple[float, str]:
    """Bound of one warp_frames_band call: it writes T (r_y + r_uv) W samples
    and reads its rows of both sources, plus a halo of this flow's largest
    vertical displacement (halved on UV), clipped to the planes, and the flow
    and ts once."""
    from hopperrender_tpu_torch.ops.warp import band_rows
    (h, w), itemsize = src[0].shape, src[0].element_size()
    halo = int(flow[1].abs().max())
    n_t, rows_read, rows_out = ts.shape[0], 0, 0
    for plane_h, plane_halo in ((h, halo), (h // 2, -(-halo // 2))):
        r = band_rows(plane_h, num_shards)
        row0 = shard * r
        rows_out += r
        rows_read += 2 * (min(plane_h, row0 + r + plane_halo) - max(0, row0 - plane_halo))
    moved = (n_t * rows_out + rows_read) * w * itemsize + nbytes(flow, ts)
    return bound("warp_frames_band", moved, n_t * rows_out * w)


# K5's work, in operations (float and integer alike, an FMA counts two),
# counted from csrc/hsv_overlay.cu: the colour of one flow cell (the cell's
# lookup and negation ~12, atan2f ~14 around atanf's reduction ~9, z and w,
# its two polynomials 20, and its sum ~6; the angle ~8, the hue ~13, |ox| +
# |oy| 4, r, g and b 27): 115, made once a run; then a Y run's luma and base
# (10) or a UV run's U and V sums, shifts and levels (34); and each Y sample's
# shift, add and levels with their division (9). A UV sample is a store.
HSV_CELL_OPS, HSV_Y_RUN_OPS, HSV_UV_RUN_OPS, HSV_Y_SAMPLE_OPS = 115, 10, 34, 9
HSV_BLOCK = (32, 8)   # K5's block: 8 rows of 32 runs (csrc/hsv_overlay.cu)


def hsv_runs(dim_x: int, res_scalar: int, is_hdr: bool) -> tuple[int, int]:
    """K5's runs a row (Y, UV): up to 16 bytes, at most a flow cell wide."""
    max_shift = 3 if is_hdr else 4
    return (-(-dim_x >> min(res_scalar, max_shift)),
            -(-dim_x >> min(res_scalar + 1, max_shift)))


def hsv_grids(raw_y, raw_uv, res_scalar: int, is_hdr: bool) -> list[tuple[int, int]]:
    """K5's two grids (Y, UV) of HSV_BLOCK blocks for these planes."""
    runs = hsv_runs(raw_y.shape[-1], res_scalar, is_hdr)
    return [(-(-r // HSV_BLOCK[0]), -(-raw.shape[-2] // HSV_BLOCK[1]))
            for r, raw in zip(runs, (raw_y, raw_uv))]


def hsv_bound(raw_y, raw_uv, flow, res_scalar: int, is_hdr: bool) -> tuple[float, str]:
    """Bound of one K5 call: it reads raw_y and the flow once and writes both
    planes; the colour replaces the raw UV, so raw_uv is not read. Its
    operations: a colour a run (what the kernel computes), each Y sample's
    levels."""
    runs_y, runs_uv = hsv_runs(raw_y.shape[-1], res_scalar, is_hdr)
    moved = 2 * nbytes(raw_y) + nbytes(raw_uv, flow)
    ops = (runs_y * raw_y.shape[-2] * (HSV_CELL_OPS + HSV_Y_RUN_OPS)
           + runs_uv * raw_uv.shape[-2] * (HSV_CELL_OPS + HSV_UV_RUN_OPS)
           + raw_y.numel() * HSV_Y_SAMPLE_OPS)
    return roofline(moved, ops, OPS_PER_S)


def random_planes(gen, n_t: int, h: int, w: int, is_hdr: bool, dev):
    """(n_t, h, w) and (n_t, h/2, w) planes of random samples, made on the card."""
    from hopperrender_tpu_torch.ops.warp import from_int32
    hi, dtype = (65536, torch.uint16) if is_hdr else (256, torch.uint8)
    return tuple(from_int32(torch.randint(0, hi, shape, generator=gen, device=dev,
                                          dtype=torch.int32), dtype)
                 for shape in ((n_t, h, w), (n_t, h // 2, w)))


def hsv_levels(is_hdr: bool) -> tuple[float, float]:
    s = 256.0 if is_hdr else 1.0
    return 16.0 * s, 235.0 * s


HSV_PAIRS = np.arange(-512, 513, dtype=np.int16)
HSV_PAIR_STRIPS = {0: 1, 3: 8}   # res_scalar -> calls the +-512 square is cut into


def hsv_pair_parity(port, dev, is_hdr: bool, res_scalar: int) -> tuple[int, int]:
    """K5 against its plain version over every (ox, oy) in +-512 as the
    colour's pair, at res_scalar 0 (res_impact 4) or 3 (res_impact 1), T = 1.
    The flow's cell (r, c) holds (HSV_PAIRS[c >> 1], oy[r >> 1]), so Y (every
    cell) and UV (even cells only, U and V each) colour every pair; oy is a
    strip of HSV_PAIRS, the square cut into HSV_PAIR_STRIPS[res_scalar]
    calls. Returns (max |err|, values compared); raises where they differ."""
    hk = port.hsv_kernel
    gen = torch.Generator(device=dev).manual_seed(13 + 2 * res_scalar + is_hdr)
    black, white = hsv_levels(is_hdr)
    kw = dict(res_scalar=res_scalar, is_hdr=is_hdr)
    err, values = 0, 0
    for k, oy in enumerate(np.array_split(HSV_PAIRS, HSV_PAIR_STRIPS[res_scalar])):
        shape = (2 * len(oy), 2 * len(HSV_PAIRS))
        fx = np.broadcast_to(np.repeat(HSV_PAIRS, 2)[None, :], shape)
        fy = np.broadcast_to(np.repeat(oy, 2)[:, None], shape)
        flow = torch.tensor(np.stack([fx, fy]), device=dev)
        raw = random_planes(gen, 1, shape[0] << res_scalar, shape[1] << res_scalar, is_hdr, dev)
        got = hk.hsv_flow_overlay(*raw, flow, black, white, **kw)
        want = hk.hsv_flow_overlay_reference(*raw, flow, black, white, **kw)
        what = f"K5 every pair {'HDR' if is_hdr else 'SDR'} rs {res_scalar} strip {k}"
        err = max(err, require_equal(got[0], want[0], what + " Y"),
                  require_equal(got[1], want[1], what + " UV"))
        values += got[0].numel() + got[1].numel()
    return err, values


# K5's other cases: (h, w, res_scalar, is_hdr, T, row_offsets, flow magnitude).
# Narrow runs (rs 1 and 2: the generic instance), ragged row tails and rows
# that start off 16 bytes (w = 86), a band's row offsets, the int16 range
# (the -32768 wrap, the colour's clip), and 1080p SDR at rs 2.
HSV_CASES = [(50, 86, 1, False, 2, (0, 0), 64), (50, 86, 3, True, 3, (0, 0), 64),
             (50, 86, 2, True, 1, (13, 7), 64), (50, 86, 3, False, 3, (24, 12), 32768),
             (1080, 1920, 2, False, 3, (0, 0), 64)]


def hsv_case_parity(port, dev, cases=HSV_CASES) -> tuple[int, int]:
    """K5 against its plain version on `cases` (random raw planes, random
    flow); returns (max |err|, calls)."""
    hk = port.hsv_kernel
    rng = np.random.default_rng(17)
    gen = torch.Generator(device=dev).manual_seed(17)
    err = 0
    for h, w, rs, is_hdr, n_t, offsets, mag in cases:
        low = (2, -(-h >> rs), -(-w >> rs))
        flow = torch.tensor(rng.integers(-mag, mag, low, endpoint=mag < 32768).astype(np.int16),
                            device=dev)
        raw = random_planes(gen, n_t, h, w, is_hdr, dev)
        black, white = hsv_levels(is_hdr)
        kw = dict(res_scalar=rs, is_hdr=is_hdr, row_offsets=offsets)
        got = hk.hsv_flow_overlay(*raw, flow, black, white, **kw)
        want = hk.hsv_flow_overlay_reference(*raw, flow, black, white, **kw)
        what = f"K5 {h}x{w} rs {rs} {'HDR' if is_hdr else 'SDR'} T {n_t} rows {offsets}"
        err = max(err, require_equal(got[0], want[0], what + " Y"),
                  require_equal(got[1], want[1], what + " UV"))
    return err, len(cases)


def hsv_numbers(port, inp) -> dict:
    """Phase 6's K5 numbers at 4K HDR on K2's raw blend, T = 1 (the served
    path: one output a call) and T = 3: graph-timed device ms on random and
    smooth flow, host us per wrapper call, the plain version's ms (CUDA
    events), an empty launch of K5's two grids (graph-timed), and the bound."""
    hk, wk, b = port.hsv_kernel, port.warp_kernel, port._build
    black, white = inp.black, inp.white
    index = inp.src[0].get_device()
    out = {}
    for label, ts in (("T1", inp.t1), ("T3", inp.t3)):
        def raw(fl):
            return wk.warp_frames(*inp.src, fl, ts, black, white, res_scalar=3, mode=2,
                                  is_hdr=True, raw_blend=True)

        def call(fl, fn=hk.hsv_flow_overlay):
            planes = raw(fl)
            return lambda: fn(*planes, fl, black, white, res_scalar=3, is_hdr=True)

        random, smooth = inp.flows["random +-64"], inp.flows["smooth"]
        planes = raw(random)
        grids = hsv_grids(*planes, 3, True)

        def empty_grids():
            for gx, gy in grids:
                b.launch("hrt_empty_grid", index, gx, gy, *HSV_BLOCK)

        plain = call(random, hk.hsv_flow_overlay_reference)
        bound_ms, bound_by = hsv_bound(*planes, random, 3, True)
        out[label] = {"ms": graph_ms(call(random), 20), "smooth_ms": graph_ms(call(smooth), 20),
                      "host_us": host_us(call(random), 20),
                      "plain_ms": (time_ms(plain, 2) + time_ms(plain, 2)) / 2,
                      "grid_ms": graph_ms(empty_grids, 20), "grids": grids,
                      "bound_ms": bound_ms, "bound_by": bound_by}
    return out


def format_hsv(numbers: dict) -> str:
    return "; ".join(
        f"{label}: {v['ms']:.5f} ms, smooth {v['smooth_ms']:.5f}, host {v['host_us']:.1f} "
        f"us/call, plain {v['plain_ms']:.4f} ms, empty launch of its grids {v['grids']} "
        f"{v['grid_ms']:.5f} ms, bound {v['bound_ms']:.5f} ms ({v['bound_by']})"
        for label, v in numbers.items())


def mode3_blocks(dim_y: int, dim_x: int, res_scalar: int, is_hdr: bool) -> int:
    """The blocks of K2's mode-3 grid (csrc/warp_frame.cu, launch_mode3): the
    Y plane's tiles of HSV_BLOCK runs, then the UV plane's, in one grid."""
    runs_y, runs_uv = hsv_runs(dim_x, res_scalar, is_hdr)
    bx, by = HSV_BLOCK
    return (-(-runs_y // bx) * -(-dim_y // by)) + (-(-runs_uv // bx) * -(-(dim_y // 2) // by))


def mode3_colours(dim_y: int, dim_x: int, res_scalar: int, is_hdr: bool) -> tuple[int, int]:
    """The colours K2's mode 3 makes (Y, UV): one per distinct flow cell of
    each block of HSV_BLOCK runs (its leader's), counted over the plane's
    tiling: the blocks' distinct cell columns times their distinct cell rows."""
    max_shift = 3 if is_hdr else 4
    out = []
    for plane_h, shift, uv in ((dim_y, min(res_scalar, max_shift), 0),
                               (dim_y // 2, min(res_scalar + 1, max_shift), 1)):
        x0 = np.arange(0, dim_x, 1 << shift)
        cols = len(set(zip((np.arange(len(x0)) // HSV_BLOCK[0]).tolist(),
                           ((x0 >> res_scalar) >> uv).tolist())))
        cy = np.arange(plane_h)
        rows = len(set(zip((cy // HSV_BLOCK[1]).tolist(), (cy >> res_scalar).tolist())))
        out.append(cols * rows)
    return out[0], out[1]


def mode3_bound(src, flow, ts, res_scalar: int, is_hdr: bool) -> tuple[float, str]:
    """Bound of one call of K2's mode 3: it reads both sources' Y planes and
    the flow once and writes both output planes for each t (the colour
    replaces the UV blend, so no UV source is read). Its operations: each Y
    output's warp and raw blend (as the raw_blend variant's) and its colour's
    shift, add and levels; a colour per distinct flow cell of a block, with a
    Y run's base or a UV run's levelled U and V. A UV output is a store."""
    dim_y, dim_x = src[0].shape
    moved = 2 * nbytes(src[0]) + nbytes(flow, ts) + ts.shape[0] * nbytes(src[0], src[1])
    colours_y, colours_uv = mode3_colours(dim_y, dim_x, res_scalar, is_hdr)
    ops = (ts.shape[0] * src[0].numel() * (OPS_PER_ELEMENT["warp_frames_raw_blend"]
                                           + HSV_Y_SAMPLE_OPS)
           + colours_y * (HSV_CELL_OPS + HSV_Y_RUN_OPS)
           + colours_uv * (HSV_CELL_OPS + HSV_UV_RUN_OPS))
    return roofline(moved, ops, OPS_PER_S)


# 4d's small cases: (h, w, res_scalar, is_hdr, ts, flow magnitude). rs 1-3 at
# 50 x 86 (narrow runs take the generic instance; ragged row tails, rows off
# 16 bytes), SDR and HDR, t outside [0, 1] (the blend's other conversion),
# the int16 range; 1080p SDR at rs 2.
MODE3_CASES = [(50, 86, 1, False, (0.2, 0.6, 1.0), 64), (50, 86, 1, True, (0.4,), 64),
               (50, 86, 2, False, (0.0, 0.5, 1.0), 64), (50, 86, 2, True, (-0.25, 0.5, 1.5), 64),
               (50, 86, 3, False, (0.3,), 32768), (50, 86, 3, True, (0.2, 0.6, 1.0), 64),
               (1080, 1920, 2, False, (0.2, 0.6, 1.0), 64)]
MODE3_BAND_SHARDS = (2, 4, 8)   # 4d's row bands at 4K HDR


def mode3_parity(port, dev, inp) -> tuple[int, int, int]:
    """4d: K2's mode 3 against its plain version (ops/warp.warp_frame in mode
    3), exactly: 4K HDR on the three flows at T = 1 and 3 (and equal to the
    chain it replaced, K2's raw_blend variant then K5); the row bands at n =
    2, 4 and 8 (each against its plain band, stacked against the full
    frame); MODE3_CASES (each also as bands of n = 3); and a flow grid at rs
    0 whose cells run through every (ox, oy) in +-512, SDR and HDR. Returns
    (max |err|, outputs compared, the kernel's launches)."""
    wk = port.warp_kernel
    err, outputs = 0, 0
    launches_before = wk.warp_frames.mode3_launches + wk.warp_frames_band.mode3_launches

    def check(got, want, what):
        nonlocal err
        err = max(err, require_equal(got[0], want[0], what + " Y"),
                  require_equal(got[1], want[1], what + " UV"))

    def bands(args, n, kw, what):
        full = wk.warp_frames(*args, **kw)
        parts = []
        for shard in range(n):
            got = wk.warp_frames_band(*args, num_shards=n, shard_index=shard, **kw)
            check(got, wk.warp_frames_band_reference(*args, num_shards=n, shard_index=shard,
                                                     **kw), f"{what} band n {n} shard {shard}")
            parts.append(got)
        for cz, plane_h in enumerate((args[0].shape[0], args[1].shape[0])):
            require_equal(torch.cat([b[cz] for b in parts], 1)[:, :plane_h], full[cz],
                          f"{what} bands n {n} stacked, plane {cz}")

    kw = dict(res_scalar=3, mode=3, is_hdr=True)
    chain = mode3_chain_call(port, wk.warp_frames)
    for flow_name, fl in inp.flows.items():
        for ts in (inp.t1, inp.t3):
            args = (*inp.src, fl, ts, inp.black, inp.white)
            what = f"K2 mode 3 4K HDR {flow_name} T {len(ts)}"
            got = wk.warp_frames(*args, **kw)
            check(got, wk.warp_frames_reference(*args, **kw), what)
            check(got, chain(*args, **kw), what + " against raw_blend + K5")
            outputs += len(ts)
    for n in MODE3_BAND_SHARDS:
        bands((*inp.src, inp.flows["random +-64"], inp.t3, inp.black, inp.white), n, kw,
              "K2 mode 3 4K HDR")
    rng = np.random.default_rng(19)
    gen = torch.Generator(device=dev).manual_seed(19)
    for h, w, rs, is_hdr, ts, mag in MODE3_CASES:
        y, uv = random_planes(gen, 2, h, w, is_hdr, dev)
        low = (2, -(-h >> rs), -(-w >> rs))
        flow = torch.tensor(rng.integers(-mag, mag, low, endpoint=mag < 32768).astype(np.int16),
                            device=dev)
        t = torch.tensor(ts, dtype=torch.float32, device=dev)
        args = (y[0], uv[0], y[1], uv[1], flow, t, *hsv_levels(is_hdr))
        case_kw = dict(res_scalar=rs, mode=3, is_hdr=is_hdr)
        what = f"K2 mode 3 {h}x{w} rs {rs} {'HDR' if is_hdr else 'SDR'} t {ts}"
        check(wk.warp_frames(*args, **case_kw), wk.warp_frames_reference(*args, **case_kw), what)
        if h == 50:
            bands(args, 3, case_kw, what)
        outputs += len(ts)
    # Every pair at rs 0: flow cell (r, c) holds (HSV_PAIRS[c >> 1], HSV_PAIRS[r >> 1]),
    # so Y (every cell) and U and V (even cells of even rows) colour every pair.
    shape = (2 * len(HSV_PAIRS), 2 * len(HSV_PAIRS))
    fx = np.broadcast_to(np.repeat(HSV_PAIRS, 2)[None, :], shape)
    fy = np.broadcast_to(np.repeat(HSV_PAIRS, 2)[:, None], shape)
    flow = torch.tensor(np.stack([fx, fy]), device=dev)
    for is_hdr in (False, True):
        y, uv = random_planes(gen, 2, *shape, is_hdr, dev)
        args = (y[0], uv[0], y[1], uv[1], flow, inp.t1, *hsv_levels(is_hdr))
        pair_kw = dict(res_scalar=0, mode=3, is_hdr=is_hdr)
        check(wk.warp_frames(*args, **pair_kw), wk.warp_frames_reference(*args, **pair_kw),
              f"K2 mode 3 every pair {'HDR' if is_hdr else 'SDR'} rs 0")
        outputs += 1
    launches = wk.warp_frames.mode3_launches + wk.warp_frames_band.mode3_launches
    return err, outputs, launches - launches_before


# Timing variants of K2's mode 3 (csrc/warp_frame.cu, hrt_warp_mode3_probe):
# name -> variant; the last column says whether its output is the path's.
MODE3_VARIANTS = {"as on the path": (0, True), "no colour": (1, False)}


def mode3_variants(port, inp, ts) -> dict | None:
    """Graph-timed device ms of each of MODE3_VARIANTS on 4K HDR random flow
    at these ts, each first checked equal to the path's output where it
    should be. None where the library has no such entry point."""
    b, wk = port._build, port.warp_kernel
    if not hasattr(b.load().lib, "hrt_warp_mode3_probe"):
        return None
    src, fl = inp.src, inp.flows["random +-64"]
    index = src[0].get_device()
    want = wk.warp_frames(*src, fl, ts, inp.black, inp.white, res_scalar=3, mode=3,
                          is_hdr=True)
    out_y, out_uv = torch.empty_like(want[0]), torch.empty_like(want[1])
    out = {}
    for name, (variant, same) in MODE3_VARIANTS.items():
        def call(v=variant):
            b.launch("hrt_warp_mode3_probe", index, v, src[0].data_ptr(), src[2].data_ptr(),
                     fl.data_ptr(), ts.data_ptr(), ts.shape[0], out_y.data_ptr(),
                     out_uv.data_ptr(), H, W, fl.shape[1], fl.shape[2], 3, inp.black, inp.white)
        call()
        if same:
            require_equal(out_y, want[0], f"mode 3 variant {name} Y")
            require_equal(out_uv, want[1], f"mode 3 variant {name} UV")
        out[name] = graph_ms(call, 20)
    return out


def mode3_numbers(port, inp, variants: bool = False) -> dict:
    """K2's mode 3 at 4K HDR, T = 1 (the served path: one output a call) and
    T = 3, beside the chain it replaced (K2's raw_blend variant, then K5) on
    the same inputs: graph-timed device ms in turns (fused, chain, chain,
    fused; random flow; smooth flow for the fused call), host us per call of
    each, the plain version's ms (CUDA events), an empty launch of its one
    grid (graph-timed) and the bound; with variants, MODE3_VARIANTS too."""
    wk, b = port.warp_kernel, port._build
    index = inp.src[0].get_device()
    random, smooth = inp.flows["random +-64"], inp.flows["smooth"]
    chain_kernel = mode3_chain_call(port, wk.warp_frames)
    out = {}
    for label, ts in (("T1", inp.t1), ("T3", inp.t3)):
        def call(fl, fn=wk.warp_frames):
            return lambda: fn(*inp.src, fl, ts, inp.black, inp.white, res_scalar=3, mode=3,
                              is_hdr=True)

        blocks = mode3_blocks(H, W, 3, True)

        def empty_grid():
            b.launch("hrt_empty_grid", index, blocks, 1, *HSV_BLOCK)

        plain = call(random, wk.warp_frames_reference)
        turns = [graph_ms(call(random, fn), 20)
                 for fn in (wk.warp_frames, chain_kernel, chain_kernel, wk.warp_frames)]
        fused_ms, chain_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        bound_ms, bound_by = mode3_bound(inp.src, random, ts, 3, True)
        out[label] = {"ms": fused_ms, "smooth_ms": graph_ms(call(smooth), 20),
                      "host_us": host_us(call(random), 20),
                      "plain_ms": (time_ms(plain, 2) + time_ms(plain, 2)) / 2,
                      "grid_ms": graph_ms(empty_grid, 20), "blocks": blocks,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "chain_ms": chain_ms,
                      "chain_host_us": host_us(call(random, chain_kernel), 20),
                      "turns_ms": turns, "vs_chain": fused_ms / chain_ms,
                      "vs_bound": fused_ms / bound_ms,
                      "variants": mode3_variants(port, inp, ts) if variants else None}
    return out


def format_mode3(numbers: dict) -> str:
    return "; ".join(
        f"{label}: {v['ms']:.5f} ms (turns fused/chain/chain/fused "
        f"{'/'.join(f'{t:.5f}' for t in v['turns_ms'])}), smooth {v['smooth_ms']:.5f}, "
        f"host {v['host_us']:.1f} us/call, plain {v['plain_ms']:.4f} ms, empty launch of its "
        f"grid ({v['blocks']} blocks) {v['grid_ms']:.5f} ms, bound {v['bound_ms']:.5f} ms "
        f"({v['bound_by']}), {v['vs_bound']:.2f}x its bound; the chain (raw_blend + K5) "
        f"{v['chain_ms']:.5f} ms, host {v['chain_host_us']:.1f} us/call; fused / chain "
        f"{v['vs_chain']:.3f}" + ("" if not v.get("variants") else "; variants " + ", ".join(
            f"{name} {ms:.5f}" for name, ms in v["variants"].items()))
        for label, v in numbers.items())


# -- K2's modes 4, 5 and 6 ------------------------------------------------------

VIZ_MODES = (4, 5, 6)
VIZ_NAMES = {4: "warp_frames_mode4", 5: "warp_frames_mode5", 6: "warp_frames_mode6"}


def viz_composition(port, mode: int, args, res_scalar: int, is_hdr: bool):
    """Modes 4-6 as they were served before K2 took them: the grey flow of
    ops/warp_viz.grey_flow_frame (expanded over T), or K2's mode 2 then
    warp_viz.side_by_side_1 / side_by_side_2."""
    wv, wk = port.warp_viz, port.warp_kernel
    s12y, s12uv, s21y, s21uv, flow, ts, black, white = args
    kw = dict(res_scalar=res_scalar, is_hdr=is_hdr)
    if mode == 4:
        y, uv = wv.grey_flow_frame(flow, dim_y=s12y.shape[0], dim_x=s12y.shape[1], **kw)
        return y.expand(len(ts), -1, -1), uv.expand(len(ts), -1, -1)
    y, uv = wk.warp_frames(*args, mode=2, **kw)
    if mode == 5:
        return wv.side_by_side_1(s12y, s12uv, y, uv)
    return wv.side_by_side_2(s12y, s12uv, s21uv, y, uv, flow, ts, white, **kw)


VIZ_STREAM_RUNS = 4   # runs a thread of a stream tile takes in modes 5 and 6 (kVizStreamRuns)


def viz_blocks(mode: int, dim_y: int, dim_x: int, res_scalar: int, is_hdr: bool) -> int:
    """The blocks of K2's grid in mode 4, 5 or 6 over the whole frame
    (csrc/warp_frame.cu: launch_grey; viz_grid): per plane, the tiles of
    HSV_BLOCK threads of each segment. Mode 4: a run a thread, on Y one flow
    cell, on UV 16 bytes. Modes 5 and 6: a thread of a stream tile (fill,
    copy, halve) takes VIZ_STREAM_RUNS runs of 16 bytes, of a warp tile one
    run: mode 5's right half one flow cell from the half rounded down to it,
    mode 6's right half 16 bytes."""
    max_shift = 3 if is_hdr else 4
    bx, by = HSV_BLOCK
    half = dim_x >> 1

    def tiles(stream: bool, shift: int, x0: int, x1: int, r0: int, r1: int) -> int:
        if x1 <= x0 or r1 <= r0:
            return 0
        a_thread = (1 if mode == 4 else VIZ_STREAM_RUNS) if stream else 1
        runs = (x1 - x0 + (1 << shift) - 1) >> shift
        return -(-runs // (bx * a_thread)) * -(-(r1 - r0) // by)

    blocks = 0
    for uv in (0, 1):
        plane_h = dim_y // 2 if uv else dim_y
        if mode == 4:
            blocks += tiles(uv == 1, max_shift if uv else min(res_scalar, max_shift), 0, dim_x, 0,
                            plane_h)
        elif mode == 5:
            shift = min(res_scalar + uv, 3)
            cb = (half >> shift) << shift
            blocks += (tiles(True, max_shift, 0, cb, 0, plane_h)
                       + tiles(False, shift, cb, dim_x, 0, plane_h))
        else:
            vb = (dim_y >> 2) >> uv
            ve = vb + (dim_y >> (1 + uv))
            blocks += (tiles(True, max_shift, 0, dim_x, 0, vb)
                       + tiles(True, max_shift, 0, dim_x, ve, plane_h)
                       + tiles(True, max_shift, 0, half, vb, ve)
                       + tiles(False, max_shift, half, dim_x, vb, ve))
    return blocks


def ptxas_table(log: str) -> dict[str, dict]:
    """Each function of nvcc's -Xptxas -v report (its mangled name: kernels
    and functions that are not inlined) -> its "registers" (kernels), "stack",
    "spill_stores" and "spill_loads" bytes."""
    table, name = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif "spill stores" in line:
            words = line.replace(",", " ").split()
            table.setdefault(name, {}).update(
                stack=int(words[0]), spill_stores=int(words[4]), spill_loads=int(words[8]))
        elif "Used" in line and "registers" in line:
            table.setdefault(name, {})["registers"] = int(line.split("Used")[1].split()[0])
    return table


# K2's modes 5 and 6 in ptxas's names (csrc/warp_frame.cu): warp_viz_kernel<T,
# mode, ...>.
VIZ_KERNEL = re.compile(r"warp_viz_kernelI[ht]Li(\d)E")


def viz_ptxas(table: dict[str, dict]) -> dict[int, dict]:
    """Modes 5 and 6 from ptxas_table: the most registers any instance of the
    mode takes, and the most bytes it, or warp_elements and stream_elements
    (their element-by-element runs, not inlined), spills (stores)."""
    slow = max((v.get("spill_stores", 0) for name, v in table.items()
                if "warp_elements" in name or "stream_elements" in name), default=0)
    out = {}
    for mode in (5, 6):
        instances = [v for name, v in table.items()
                     if (m := VIZ_KERNEL.search(name)) and int(m[1]) == mode]
        out[mode] = {"registers": max(v["registers"] for v in instances),
                     "instances": len(instances),
                     "spill_bytes": max([slow] + [v.get("spill_stores", 0) for v in instances])}
    return out


# Operations per output element of modes 4-6, counted from csrc/warp_frame.cu:
# a store (mode 4's UV, a fill, a copied sample) is one; mode 4's Y grey is
# its cell's lookup and |ox| + |oy|, shift and cap, shared by a run, and a
# store; a warped output (mode 5's right half, mode 6's right half in the
# band) is mode 2's (OPS_PER_ELEMENT["warp_frames"]).
VIZ_STORE_OPS = 1


def viz_bound(mode: int, src, flow, ts) -> tuple[float, str]:
    """Bound of one call of K2 in mode 4, 5 or 6 at these inputs: it writes
    both output planes for each t and reads what its outputs need once. Mode
    4 reads the flow only. Mode 5 reads source 1 whole (its left half is
    copied, its right half warped) and source 2's right half, and the flow.
    Mode 6 reads half of each source (its band shows every other row: source
    1's even rows on the left, both sources' even rows under the right half's
    warp) and the flow. Operations: VIZ_STORE_OPS a store, mode 2's a warped
    output."""
    h, w = src[0].shape
    n_t, plane = ts.shape[0], src[0].numel() + src[1].numel()
    written = n_t * nbytes(src[0], src[1])
    one = nbytes(src[0], src[1])
    read = {4: 0, 5: one + one // 2, 6: one}[mode] + nbytes(flow, ts)
    warped = {4: 0, 5: plane - plane // 2, 6: plane // 4}[mode]
    ops = n_t * (warped * OPS_PER_ELEMENT["warp_frames"] + (plane - warped) * VIZ_STORE_OPS)
    return roofline(written + read, ops, OPS_PER_S)


# 4e's small cases: (h, w, res_scalar, is_hdr, ts, flow magnitude). 50 x 86 at
# rs 1-3: the half (43) is odd, so mode 5's runs straddle it and mode 6's V
# columns take side_by_side_2's m_off path; ragged rows, rows off 16 bytes;
# SDR and HDR; t outside [0, 1] (the blend's other conversion); the int16
# range. 1080p SDR at rs 2. A 64 x 128 flow grid at rs 0 whose cells reach
# +-32767 (and -32768), SDR and HDR.
VIZ_CASES = [(50, 86, 1, False, (0.2, 0.6, 1.0), 64), (50, 86, 1, True, (-0.25, 0.5, 1.5), 64),
             (50, 86, 2, False, (0.0, 0.5, 1.0), 32768), (50, 86, 2, True, (0.4,), 64),
             (50, 86, 3, False, (-0.5, 0.3, 1.25), 64), (50, 86, 3, True, (0.2, 0.6, 1.0), 32768),
             (1080, 1920, 2, False, (0.2, 0.6, 1.0), 64),
             (64, 128, 0, False, (0.3, 0.9), 32768), (64, 128, 0, True, (0.7,), 32768)]
VIZ_BAND_SHARDS = (2, 4, 8)   # 4e's row bands at 4K HDR


def viz_parity(port, dev, inp) -> tuple[int, int, int]:
    """4e: K2's modes 4, 5 and 6 against their plain version (ops/warp.warp_frame
    in each mode) and the composition they replace (viz_composition), exactly:
    4K HDR on the three flows at T = 1 and 3; the row bands at n = 2, 4 and 8
    (each against its plain band, stacked against the full frame); VIZ_CASES
    (the 50-row ones also as bands of n = 3). Returns (max |err|, outputs
    compared, the kernel's launches)."""
    wk = port.warp_kernel
    err, outputs = 0, 0
    launches_before = wk.warp_frames.viz_launches + wk.warp_frames_band.viz_launches

    def check(got, want, what):
        nonlocal err
        err = max(err, require_equal(got[0], want[0], what + " Y"),
                  require_equal(got[1], want[1], what + " UV"))

    def bands(args, n, kw, full, what):
        parts = []
        for shard in range(n):
            got = wk.warp_frames_band(*args, num_shards=n, shard_index=shard, **kw)
            check(got, wk.warp_frames_band_reference(*args, num_shards=n, shard_index=shard,
                                                     **kw), f"{what} band n {n} shard {shard}")
            parts.append(got)
        for cz, plane_h in enumerate((args[0].shape[0], args[1].shape[0])):
            stacked = torch.cat([b[cz] for b in parts], 1)
            require_equal(stacked[:, :plane_h], full[cz], f"{what} bands n {n} stacked, plane {cz}")
            if stacked.shape[1] > plane_h and as_int32(stacked[:, plane_h:]).any():
                raise AssertionError(f"{what} bands n {n}: rows past plane {cz} are not 0")

    def case(args, rs, is_hdr, what, shards=()):
        nonlocal outputs
        for mode in VIZ_MODES:
            kw = dict(res_scalar=rs, mode=mode, is_hdr=is_hdr)
            got = wk.warp_frames(*args, **kw)
            check(got, wk.warp_frames_reference(*args, **kw), f"K2 mode {mode} {what}")
            check(got, viz_composition(port, mode, args, rs, is_hdr),
                  f"K2 mode {mode} {what} against the composition")
            for n in shards:
                bands(args, n, kw, got, f"K2 mode {mode} {what}")
            outputs += len(args[5])

    for flow_name, fl in inp.flows.items():
        for ts in (inp.t1, inp.t3):
            case((*inp.src, fl, ts, inp.black, inp.white), 3, True,
                 f"4K HDR {flow_name} T {len(ts)}",
                 VIZ_BAND_SHARDS if flow_name == "random +-64" and len(ts) == 3 else ())
    rng = np.random.default_rng(23)
    gen = torch.Generator(device=dev).manual_seed(23)
    for h, w, rs, is_hdr, ts, mag in VIZ_CASES:
        y, uv = random_planes(gen, 2, h, w, is_hdr, dev)
        low = (2, -(-h >> rs), -(-w >> rs))
        flow = torch.tensor(rng.integers(-mag, mag, low, endpoint=mag < 32768).astype(np.int16),
                            device=dev)
        t = torch.tensor(ts, dtype=torch.float32, device=dev)
        case((y[0], uv[0], y[1], uv[1], flow, t, *hsv_levels(is_hdr)), rs, is_hdr,
             f"{h}x{w} rs {rs} {'HDR' if is_hdr else 'SDR'} t {ts}", (3,) if h == 50 else ())
    launches = wk.warp_frames.viz_launches + wk.warp_frames_band.viz_launches
    return err, outputs, launches - launches_before


def viz_numbers(port, inp) -> dict:
    """K2's modes 4, 5 and 6 at 4K HDR, T = 1 (the served path: one output a
    call) and T = 3, on random +-64 flow: graph-timed device ms in turns with
    an empty launch of its grid (kernel, grid, grid, kernel), smooth flow, host
    us per call, the plain version's ms (CUDA events), and the composition it
    replaced (viz_composition: plain PyTorch around K2's mode 2, which a CUDA
    graph cannot capture: it copies scalars to the card) beside the kernel,
    both with CUDA events over back-to-back calls in turns (kernel,
    composition, composition, kernel), host gaps included; the bound."""
    wk, b = port.warp_kernel, port._build
    index = inp.src[0].get_device()
    random, smooth = inp.flows["random +-64"], inp.flows["smooth"]
    out = {}
    for mode in VIZ_MODES:
        blocks = viz_blocks(mode, H, W, 3, True)

        def empty_grid():
            b.launch("hrt_empty_grid", index, blocks, 1, *HSV_BLOCK)

        for label, ts in (("T1", inp.t1), ("T3", inp.t3)):
            def call(fl, fn=wk.warp_frames):
                return lambda: fn(*inp.src, fl, ts, inp.black, inp.white, res_scalar=3,
                                  mode=mode, is_hdr=True)

            def composition():
                return viz_composition(port, mode, (*inp.src, random, ts, inp.black, inp.white),
                                       3, True)

            graph_turns = [graph_ms(fn, 20) for fn in (call(random), empty_grid, empty_grid,
                                                       call(random))]
            event_turns = [time_ms(fn, 10) for fn in (call(random), composition, composition,
                                                      call(random))]
            plain = call(random, wk.warp_frames_reference)
            bound_ms, bound_by = viz_bound(mode, inp.src, random, ts)
            ms = (graph_turns[0] + graph_turns[3]) / 2
            out[f"mode{mode} {label}"] = {
                "ms": ms, "smooth_ms": graph_ms(call(smooth), 20),
                "host_us": host_us(call(random), 20),
                "plain_ms": (time_ms(plain, 2) + time_ms(plain, 2)) / 2,
                "grid_ms": (graph_turns[1] + graph_turns[2]) / 2, "blocks": blocks,
                "bound_ms": bound_ms, "bound_by": bound_by, "vs_bound": ms / bound_ms,
                "events_ms": (event_turns[0] + event_turns[3]) / 2,
                "composition_ms": (event_turns[1] + event_turns[2]) / 2,
                "composition_host_us": host_us(composition, 10),
                "graph_turns_ms": graph_turns, "event_turns_ms": event_turns}
    return out


def format_viz(numbers: dict) -> str:
    return "; ".join(
        f"{label}: {v['ms']:.5f} ms (turns kernel/grid/grid/kernel "
        f"{'/'.join(f'{t:.5f}' for t in v['graph_turns_ms'])}), smooth {v['smooth_ms']:.5f}, "
        f"host {v['host_us']:.1f} us/call, plain {v['plain_ms']:.4f} ms, empty launch of its "
        f"grid ({v['blocks']} blocks) {v['grid_ms']:.5f} ms, bound {v['bound_ms']:.5f} ms "
        f"({v['bound_by']}), {v['vs_bound']:.2f}x its bound; CUDA events back to back: kernel "
        f"{v['events_ms']:.5f} ms, the composition (K2 mode 2 + warp_viz) "
        f"{v['composition_ms']:.5f} ms (turns "
        f"{'/'.join(f'{t:.5f}' for t in v['event_turns_ms'])}), host "
        f"{v['composition_host_us']:.1f} us/call"
        for label, v in numbers.items())


# -- K6, the levelled passthrough -------------------------------------------------

# 4f's level pairs (black, white) in 8-bit units, x256 for HDR: the usual
# pairs, then the degenerate ones that Settings accepts (black == white,
# white 0, black above white), whose divisions give infinities and NaN.
COPY_LEVELS = ((0, 255), (16, 235), (3, 250), (16, 16), (0, 0), (16, 0), (235, 16))
# K6's block (csrc/copy_frame.cu: kThreads) and the 16-byte runs a block takes
# (kThreads * kRuns).
COPY_THREADS, COPY_BLOCK_RUNS = 256, 1024
# K6's float32 operations a sample: the subtraction, the division, the clip's
# two and the truncation, and the product (Y) or the FMA (UV, counted two).
COPY_OPS = {"Y": 6, "UV": 7}
# Phase 6: source frames the timed calls take in turn, so that their reads
# (more than the 50 MB L2 together) come from device memory, as a served
# copy's do; calls captured in one CUDA graph.
COPY_SOURCES, COPY_GRAPH_CALLS = 8, 48


def copy_blocks(dim_y: int, dim_x: int, is_hdr: bool) -> int:
    """The blocks of K6's grid (csrc/copy_frame.cu, hrt_copy_frame): each
    plane's 16-byte runs, COPY_BLOCK_RUNS a block, the Y plane's then UV's."""
    e = 2 if is_hdr else 1
    runs = [-(-n * e // 16) for n in (dim_y * dim_x, dim_y // 2 * dim_x)]
    return sum(-(-r // COPY_BLOCK_RUNS) for r in runs)


def copy_bound(y: torch.Tensor, uv: torch.Tensor) -> tuple[float, str]:
    """K6's bound: both planes read once and written once; its operations."""
    return roofline(2 * nbytes(y, uv), COPY_OPS["Y"] * y.numel() + COPY_OPS["UV"] * uv.numel(),
                    OPS_PER_S)


def every_sample_frame(port, is_hdr: bool, dev):
    """On the card: Y (2n/256, 256) holding every sample value twice and UV
    (n/256, 256) once, n = 256 (SDR) or 65,536 (HDR)."""
    n = 65536 if is_hdr else 256
    y = port.warp_ops.from_int32(
        (torch.arange(2 * n, dtype=torch.int32, device=dev) % n).reshape(-1, 256),
        torch.uint16 if is_hdr else torch.uint8)
    return y, y[:y.shape[0] // 2].clone()


def off_16_bytes(planes):
    """Copies of the planes that each start one sample past 16 bytes."""
    out = []
    for p in planes:
        buf = torch.empty(p.numel() + 1, dtype=p.dtype, device=p.device)
        out.append(buf[1:].view(p.shape))
        out[-1].copy_(p)
    return tuple(out)


def copy_parity(port, dev) -> tuple[int, int, int]:
    """4f: K6 against its plain version on the card, exactly: every sample
    value as a frame at each of COPY_LEVELS, SDR and HDR; random 4K HDR and
    4K SDR frames and 50 x 86 (planes whose lengths are not a multiple of 16
    bytes) at 16/235, and that 50 x 86 frame one sample off 16 bytes (every
    run element by element). Each call must launch K6 once, into planes that
    are not its sources. Returns (max |err|, samples compared, launches)."""
    ck = port.copy_kernel
    gen = torch.Generator(device=dev).manual_seed(17)
    cases = []    # (what, y, uv, black, white, is_hdr)
    for is_hdr in (False, True):
        s, kind = (256.0, "HDR") if is_hdr else (1.0, "SDR")
        y, uv = every_sample_frame(port, is_hdr, dev)
        cases += [(f"every {kind} sample, levels {b}/{w}", y, uv, b * s, w * s, is_hdr)
                  for b, w in COPY_LEVELS]
        for h, w in ((H, W), (50, 86)):
            y, uv = (p[0] for p in random_planes(gen, 1, h, w, is_hdr, dev))
            cases.append((f"{w}x{h} {kind}", y, uv, 16 * s, 235 * s, is_hdr))
        cases.append((f"86x50 {kind} off 16 bytes", *off_16_bytes((y, uv)), 16 * s, 235 * s,
                      is_hdr))
    err, samples, before = 0, 0, ck.copy_frame.launches
    for what, y, uv, black, white, is_hdr in cases:
        got = ck.copy_frame(y, uv, black, white, is_hdr=is_hdr)
        want = ck.copy_frame_reference(y, uv, black, white, is_hdr=is_hdr)
        for g, p, src, plane in zip(got, want, (y, uv), ("Y", "UV")):
            if g.data_ptr() == src.data_ptr():
                raise AssertionError(f"K6 {what}: the {plane} output is its source")
            err = max(err, require_equal(g, p, f"K6 {what} {plane}"))
            samples += g.numel()
    launches = ck.copy_frame.launches - before
    if launches != len(cases):
        raise AssertionError(f"K6: {launches} launches for {len(cases)} calls")
    return err, samples, launches


def copy_numbers(port, dev) -> dict:
    """Phase 6's K6 numbers at 4K HDR and 4K SDR, levels 16/235, the calls
    taking COPY_SOURCES random source frames in turn: graph-timed device ms
    in turns with an empty launch of its grid (kernel, grid, grid, kernel),
    host us per wrapper call, the plain version's ms (CUDA events) and the
    bound."""
    ck, b = port.copy_kernel, port._build
    gen = torch.Generator(device=dev).manual_seed(18)
    out = {}
    for label, is_hdr in (("4K HDR", True), ("4K SDR", False)):
        planes = random_planes(gen, COPY_SOURCES, H, W, is_hdr, dev)
        sources = [(planes[0][i], planes[1][i]) for i in range(COPY_SOURCES)]
        black, white = hsv_levels(is_hdr)
        blocks = copy_blocks(H, W, is_hdr)
        turn = itertools.cycle(sources)

        def call(fn=ck.copy_frame):
            y, uv = next(turn)
            return fn(y, uv, black, white, is_hdr=is_hdr)

        def empty_grid():
            b.launch("hrt_empty_grid", dev.index or 0, blocks, 1, COPY_THREADS, 1)

        def plain():
            return call(ck.copy_frame_reference)

        turns = [graph_ms(fn, COPY_GRAPH_CALLS) for fn in (call, empty_grid, empty_grid, call)]
        ms = (turns[0] + turns[3]) / 2
        bound_ms, bound_by = copy_bound(*sources[0])
        out[label] = {"ms": ms, "host_us": host_us(call, 200),
                      "plain_ms": (time_ms(plain, 8) + time_ms(plain, 8)) / 2,
                      "grid_ms": (turns[1] + turns[2]) / 2, "blocks": blocks,
                      "bound_ms": bound_ms, "bound_by": bound_by, "vs_bound": ms / bound_ms,
                      "graph_turns_ms": turns}
    return out


def format_copy(numbers: dict) -> str:
    return "; ".join(
        f"{label}: {v['ms']:.5f} ms (turns kernel/grid/grid/kernel "
        f"{'/'.join(f'{t:.5f}' for t in v['graph_turns_ms'])}), host {v['host_us']:.1f} "
        f"us/call, plain {v['plain_ms']:.4f} ms, empty launch of its grid ({v['blocks']} "
        f"blocks) {v['grid_ms']:.5f} ms, bound {v['bound_ms']:.5f} ms ({v['bound_by']}), "
        f"{v['vs_bound']:.2f}x its bound"
        for label, v in numbers.items())


MODE3_SCALER_FRAMES = 30      # 5d: 4K HDR mode-3 source frames, the scaler on


def mode3_scaler_stream(port, dev, frames) -> dict:
    """5d: FrameServer at 4K HDR P010 24 -> 60 in mode 3, levels 16/235, the
    quality scaler on (auto_quality, the Settings default). For each source
    frame: the search radius its flow ran at, the cadence state, and the
    engine compute the scaler reads (the flow's time and the warps' and
    copies' times it is handed, CUDA events); each interpolated output's
    warp time; the launches of the run. Reports; the caller sets the
    rules."""
    config = port.config
    st = port.Settings(target_fps=60.0, use_display_fps=False, frame_output=3, black_level=16,
                       white_level=235)
    srv = port.FrameServer(W, H, source_fps=24.0, is_hdr=True, device=dev, settings=st)
    if not srv.scaler.enabled:
        raise AssertionError("the quality scaler is off")
    warps = []
    add_warp = srv.scaler.add_warp_duration

    def record_warp(seconds):
        warps.append(seconds)
        add_warp(seconds)

    srv.scaler.add_warp_duration = record_warp
    reset_launches(port)
    radii, states, compute_ms, warp_ms, outputs = [], [], [], [], 0
    for y, uv in frames:
        warps.clear()
        outs = srv.push_frame(y, uv)
        eng = srv.engine
        flow_s = eng.ofc_time.current if eng.frame_count >= 3 else 0.0
        radii.append(eng.search_radius)
        states.append(config.ActiveState(srv.cadence.state).name)
        compute_ms.append(1e3 * (flow_s + sum(warps)))
        warp_ms += [1e3 * w for w, o in zip(warps, outs) if o.interpolated]
        outputs += len(outs)
    torch.cuda.synchronize()
    edges = [(k, states[k - 1], states[k]) for k in range(1, len(states))
             if states[k] != states[k - 1]]
    return dict(radii=radii, states=states, edges=edges, compute_ms=compute_ms,
                warp_ms=warp_ms, outputs=outputs, interpolated=len(warp_ms),
                launches=read_launches(port))


# K3's and K4's least work, in integer operations (a load counts as one). K3,
# per candidate (a layer below the radius, of a cell of the grid): its offset
# and the offset's int16 wrap (2), the mirror and clamp (5), the U and V
# columns (4), three loads, three differences and their absolutes (9), the
# delta's shift and two adds (3), |offset| and its add (2), and its add to
# the window's sum (1): 26, and 3 more in HDR (the samples' shifts); from
# FIRST_NEIGHBOR_ITERATION on 13 more (four differences, four absolutes,
# three adds, the shift and the add). Per cell, once: frame 2's three loads
# and their shifts, the other axis's mirror and UV index, the offsets' two
# loads and the neighbours' four: 16. K4, per cell: a compare for each layer
# scanned, then the winner's square, the add, the wrap, a load and a store.
K3_CANDIDATE_OPS, K3_HDR_OPS, K3_NEIGHBOR_OPS, K3_CELL_OPS = 26, 3, 13, 16
K4_CELL_OPS = 5
K3_TILE = (8, 32)   # K3's block: 8 rows of 32 cells (csrc/cost_volume.cu)


def radius_layers(port, radius: int) -> int:
    """K3's num_layers at this radius: the engine's radius bucket."""
    return next(b for b in port.flow_engine.RADIUS_BUCKETS if radius <= b)


def cost_volume_frames(rng, h: int, w: int, is_hdr: bool, dev) -> list[torch.Tensor]:
    """Two random frames (f1y, f1uv, f2y, f2uv): P010 (10-bit samples) or NV12."""
    if is_hdr:
        return [torch.tensor(rng.integers(0, 1024, shape, dtype=np.uint16) << 6, device=dev)
                for shape in ((h, w), (h // 2, w)) * 2]
    return [torch.tensor(rng.integers(0, 256, shape, dtype=np.uint8), device=dev)
            for shape in ((h, w), (h // 2, w)) * 2]


# Phase 3b's geometries: name -> (height, width, is_hdr); both on the 270 x
# 480 flow grid (rs 3 and rs 2).
CV_GEOMETRIES = {"4K HDR": (H, W, True), "1080p SDR": (1080, 1920, False)}
CV_RADII = (5, 8, 12, 16)


def cost_volume_inputs(port, dev, geometry: str):
    """Phase 3b's inputs at one geometry, from a seed: (res_scalar, frames,
    offsets by kind: random in +-64 and near +-32767)."""
    h, w, is_hdr = CV_GEOMETRIES[geometry]
    rs, low_h, low_w = port.config.calc_flow_dims(h, w, port.config.MAX_CALC_RES)
    rng = np.random.default_rng(11 + list(CV_GEOMETRIES).index(geometry))
    frames = cost_volume_frames(rng, h, w, is_hdr, dev)
    near = np.array([-32768, -32767, -32760, -32700, 32700, 32760, 32766, 32767])
    offsets = {"random +-64": rng.integers(-64, 65, (2, low_h, low_w)),
               "near +-32767": rng.choice(near, (2, low_h, low_w))}
    return rs, frames, {k: torch.tensor(v.astype(np.int16), device=dev)
                        for k, v in offsets.items()}


def cost_volume_parity(port, dev, geometry: str, radius: int) -> tuple[int, int, int]:
    """K3 and K4 against their plain versions, exactly, at one geometry and
    radius: K3 at the engine's bucket of layers, every (iteration, window) of
    the schedule, both steps, both kinds of offsets, scalars 8/6 and 10/10
    (the uint32 sums wrap); K4 on K3's sums, returning new offsets and in
    place. Returns (K3 calls, K4 calls, the largest |err|)."""
    cv = port.cost_volume_kernel
    _, _, is_hdr = CV_GEOMETRIES[geometry]
    rs, frames, offsets = cost_volume_inputs(port, dev, geometry)
    err, n_k3, n_k4 = 0, 0, 0
    for iteration, window in port.flow_ops.window_schedule(*offsets["random +-64"].shape[1:]):
        for step in (0, 1):
            kw = dict(window_size=window, res_scalar=rs, iteration=iteration, step=step,
                      is_hdr=is_hdr, num_layers=radius_layers(port, radius))
            cw = dict(window_size=window, step=step)
            for off_name, off in offsets.items():
                for scalars in ((8, 6), (10, 10)):
                    what = (f"{geometry} r{radius} it{iteration} w{window} step {step} "
                            f"{off_name} scalars {scalars}")
                    got = cv.delta_sums(*frames, off, radius, *scalars, **kw)
                    want = cv.delta_sums_reference(*frames, off, radius, *scalars, **kw)
                    err = max(err, require_equal(got, want, f"K3 {what}"))
                    new = cv.commit_winners(off, got, radius, **cw)
                    err = max(err, require_equal(
                        new, cv.commit_winners_reference(off, want, radius, **cw), f"K4 {what}"))
                    inplace = off.clone()
                    cv.commit_winners(inplace, got, radius, **cw, out=inplace)
                    err = max(err, require_equal(inplace, new, f"K4 in place {what}"))
                    n_k3, n_k4 = n_k3 + 1, n_k4 + 2
    return n_k3, n_k4, err


def cost_volume_shards(port, dev, geometry: str, radius: int) -> tuple[int, int]:
    """K3 on the layer shards of sp = 2 and 4 (num_layers 16 / sp, each
    shard's layer_offset) at one geometry and radius, random offsets, every
    (iteration, window) and step: each shard against its plain version, the
    shards stacked against the full K3. Returns (shard calls, max |err|)."""
    cv = port.cost_volume_kernel
    _, _, is_hdr = CV_GEOMETRIES[geometry]
    rs, frames, offsets = cost_volume_inputs(port, dev, geometry)
    off = offsets["random +-64"]
    err, n = 0, 0
    for iteration, window in port.flow_ops.window_schedule(*off.shape[1:]):
        for step in (0, 1):
            kw = dict(window_size=window, res_scalar=rs, iteration=iteration, step=step,
                      is_hdr=is_hdr)
            full = cv.delta_sums(*frames, off, radius, 8, 6, **kw)
            for sp in (2, 4):
                layers = port.config.MAX_SEARCH_RADIUS // sp
                parts = []
                for shard in range(sp):
                    sh = dict(kw, num_layers=layers, layer_offset=shard * layers)
                    parts.append(cv.delta_sums(*frames, off, radius, 8, 6, **sh))
                    err = max(err, require_equal(
                        parts[-1], cv.delta_sums_reference(*frames, off, radius, 8, 6, **sh),
                        f"K3 {geometry} r{radius} it{iteration} step {step} sp {sp} "
                        f"shard {shard}"))
                    n += 1
                err = max(err, require_equal(torch.cat(parts), full,
                                             f"K3 {geometry} r{radius} sp {sp} stacked"))
    return n, err


def pyramid_parity(port, dev, radius: int) -> tuple[int, int]:
    """pyramid_flow on two 4K HDR panning frames at this radius (the
    engine's layers) against the same call on the plain versions: offsets,
    blurred flow and total_delta_raw, exactly. Returns (total_delta_raw,
    max |err|)."""
    flow_ops = port.flow_ops
    pair = [torch.tensor(np.ascontiguousarray(a), device=dev)
            for f in panning_frames(port, H, W, 2, is_hdr=True) for a in f]
    kw = dict(low_h=LOW[1], low_w=LOW[2], res_scalar=3, is_hdr=True,
              num_layers=radius_layers(port, radius))
    got = flow_ops.pyramid_flow(*pair, radius, 8, 6, **kw)
    with plain_versions(port):
        want = flow_ops.pyramid_flow(*pair, radius, 8, 6, **kw)
    err = max(require_equal(g, w_, f"pyramid_flow r{radius} {what}")
              for g, w_, what in zip(got, want, ("offsets", "blurred flow", "total_delta_raw")))
    if not int(got[0].abs().max()):
        raise AssertionError(f"pyramid_flow r{radius}: no motion found on a pan")
    return int(got[2]), err


FLOW_STEP_RADII = (5, 12, 16)


def flow_step_parity(port, dev, geometry: str, radius: int) -> tuple[int, int]:
    """flow_step against flow_step_reference, exactly, over every step of a
    pan's pyramid at one geometry and radius (the engine's layers): after
    each step the offsets (and after step 0 the raw delta) against
    flow_step_reference run from the offsets that step saw, and K3's sums
    (state.step_sums) against delta_sums_reference; then the same pyramid on
    a second state gives every step's sums and offsets bit for bit again
    (the atomics' order does not show). Returns (steps, max |err|)."""
    cv = port.cost_volume_kernel
    h, w, is_hdr = CV_GEOMETRIES[geometry]
    rs, low_h, low_w = port.config.calc_flow_dims(h, w, port.config.MAX_CALC_RES)
    frames = [torch.tensor(np.ascontiguousarray(a), device=dev)
              for f in panning_frames(port, h, w, 2, is_hdr=is_hdr) for a in f]
    kw = dict(low_h=low_h, low_w=low_w, res_scalar=rs, is_hdr=is_hdr,
              num_layers=radius_layers(port, radius),
              schedule=port.flow_ops.window_schedule(low_h, low_w))
    runs, err = [], 0
    for run in range(2):
        state, plain = (cv.PyramidState(*frames, radius, 8, 6, **kw) for _ in range(2))
        got = []
        for k, (iteration, window, step) in enumerate(state.steps):
            before = state.offsets.clone()
            cv.flow_step(state, k)
            got.append((state.step_sums(k).clone(), state.offsets.clone()))
            if run:
                continue
            what = f"flow_step {geometry} r{radius} step {k} (it{iteration} w{window} s{step})"
            plain.offsets.copy_(before)
            cv.flow_step_reference(plain, k)
            err = max(err, require_equal(state.offsets, plain.offsets, what + " offsets"))
            if k == 0:
                err = max(err, require_equal(state.delta, plain.delta, what + " raw delta"))
            want = cv.delta_sums_reference(*frames, before, radius, 8, 6, window_size=window,
                                           res_scalar=rs, iteration=iteration, step=step,
                                           is_hdr=is_hdr, num_layers=kw["num_layers"])
            err = max(err, require_equal(got[-1][0], want[:radius], what + " K3 sums"))
        runs.append(got)
    for k, (a, b) in enumerate(zip(*runs)):
        for x, y, what in zip(a, b, ("sums", "offsets")):
            require_equal(x, y, f"flow_step {geometry} r{radius} step {k} {what}, run twice")
    if not int(runs[0][-1][1].abs().max()):
        raise AssertionError(f"flow_step {geometry} r{radius}: no motion found on a pan")
    return len(runs[0]), err


def cost_volume_phase(port, dev) -> int:
    """Phase 3b: cost_volume_parity at both geometries and every radius of
    CV_RADII, cost_volume_shards at both geometries and radius 12 and 16,
    flow_step_parity at both geometries and FLOW_STEP_RADII, and
    pyramid_parity at radius 16 and 5. Returns the largest |err| (0)."""
    err, n_k3, n_k4, n_shards, n_steps = 0, 0, 0, 0, 0
    for geometry in CV_GEOMETRIES:
        for radius in CV_RADII:
            k3, k4, e = cost_volume_parity(port, dev, geometry, radius)
            n_k3, n_k4, err = n_k3 + k3, n_k4 + k4, max(err, e)
        for radius in (12, 16):
            n, e = cost_volume_shards(port, dev, geometry, radius)
            n_shards, err = n_shards + n, max(err, e)
        for radius in FLOW_STEP_RADII:
            n, e = flow_step_parity(port, dev, geometry, radius)
            n_steps, err = n_steps + n, max(err, e)
    torch.cuda.synchronize()
    deltas = {}
    for radius in (16, 5):
        deltas[radius], e = pyramid_parity(port, dev, radius)
        err = max(err, e)
    log(f"phase 3b K3 delta_sums / K4 commit_winners: {n_k3} K3 and {n_k4} K4 calls (4K HDR "
        f"rs 3 and 1080p SDR rs 2 on the {LOW[1]}x{LOW[2]} grid; radius 5/8/12/16 at the "
        f"engine's layers; every (iteration, window) of the schedule, both steps; offsets "
        f"random +-64 and near +-32767; scalars 8/6 and 10/10; K4 new and in place) and "
        f"{n_shards} K3 layer shards (sp 2 and 4, radius 12 and 16, stacked equal to the full "
        f"K3) equal to the plain versions; {n_steps} flow_step calls (every step of a pan's "
        f"pyramid at both geometries, radius {'/'.join(map(str, FLOW_STEP_RADII))}) equal to "
        f"flow_step_reference (offsets, raw delta, K3's sums) and to themselves run twice; "
        f"pyramid_flow on 4K HDR panning frames at radius 16 and 5 equal to the plain run "
        f"(offsets, blurred flow, total_delta_raw {deltas}); max |err| {err}")
    return err


def cost_volume_work(port, frames, offsets, radius: int, *, window: int, iteration: int,
                     step: int, res_scalar: int, is_hdr: bool, num_layers: int):
    """(HBM bytes, L2 bytes, operations) of one K3 call on these inputs: the
    distinct 32-byte sectors of each plane its candidates read (frame 1 for
    the layers below the radius of cells inside the frame, frame 2 once a
    cell), the offsets once and the sums written once; the L2 bytes are the
    distinct sectors each of its 8 x 32-cell blocks reads (blocks share no
    L1), summed; the operations of K3_*_OPS. From the plain version's own
    sample indices (cost_volume_kernel.candidate_reads)."""
    cv = port.cost_volume_kernel
    f1y, f1uv = frames[:2]
    low_h, low_w = offsets.shape[1:]
    active = max(0, min(num_layers, radius))
    c = cv.candidate_reads(f1y, f1uv, offsets, radius, res_scalar=res_scalar, step=step,
                           num_layers=active)
    item = f1y.element_size()
    tile = ((torch.arange(low_h, device=offsets.device)[:, None] // K3_TILE[0])
            * -(-low_w // K3_TILE[1])
            + torch.arange(low_w, device=offsets.device)[None, :] // K3_TILE[1])
    in_frame = c.in_frame[0]
    keys, tile_keys = [], []
    for plane, idx, mask in ((0, c.y, in_frame), (1, c.u, in_frame), (1, c.v, in_frame),
                             (2, c.y2, None), (3, c.u2, None), (3, c.v2, None)):
        idx = idx.expand(-1, low_h, low_w) if idx.dim() == 3 else idx[None]
        sel = (torch.ones_like(in_frame) if mask is None else mask).expand_as(idx)
        sector = (idx[sel] * item) >> 5
        key = (plane << 30) + sector
        keys.append(key)
        tile_keys.append((tile.expand_as(idx)[sel] << 32) + key)
    hbm = 32 * int(torch.cat(keys).unique().numel()) + nbytes(offsets)
    hbm += 4 * num_layers * -(-low_h // window) * -(-low_w // window)
    l2 = 32 * int(torch.cat(tile_keys).unique().numel())
    per_candidate = K3_CANDIDATE_OPS + K3_HDR_OPS * is_hdr + K3_NEIGHBOR_OPS * (
        iteration >= port.config.FIRST_NEIGHBOR_ITERATION)
    cells = low_h * low_w
    return hbm, l2, active * cells * per_candidate + cells * K3_CELL_OPS


def cost_volume_numbers(port, dev, l2_rate: float) -> dict:
    """K3 and K4 on the 16 steps of one 4K HDR flow (panning frames, the
    offsets each step of the kernels' own pyramid saw) at radius 16 and 5:
    graph-timed device ms a call (the 16 calls of a flow captured in one CUDA
    graph, the mean), the plain versions' ms a call (CUDA events), host us a
    wrapper call, and the bound a call (the mean of each call's largest of
    its HBM bytes over the memory rate, its L2 bytes over l2_rate and its
    operations over the int32 rate)."""
    cv = port.cost_volume_kernel
    pan = panning_frames(port, H, W, 2, is_hdr=True)
    frames = [torch.tensor(np.ascontiguousarray(a), device=dev) for f in pan for a in f]
    low_h, low_w = LOW[1:]
    out = {}
    for radius in (16, 5):
        layers = radius_layers(port, radius)
        steps, offsets = [], torch.zeros(LOW, dtype=torch.int16, device=dev)
        for iteration, window in port.flow_ops.window_schedule(low_h, low_w):
            for step in (0, 1):
                kw = dict(window_size=window, res_scalar=3, iteration=iteration, step=step,
                          is_hdr=True, num_layers=layers)
                before = offsets.clone()
                sums = cv.delta_sums(*frames, before, radius, 8, 6, **kw)
                cv.commit_winners(offsets, sums, radius, window_size=window, step=step,
                                  out=offsets)
                steps.append((before, kw, sums, offsets.clone()))
        n = len(steps)
        k4_bufs = [before.clone() for before, *_ in steps]

        def k3_flow(fn=cv.delta_sums):
            for before, kw, _, _ in steps:
                fn(*frames, before, radius, 8, 6, **kw)

        def k4_flow(fn=cv.commit_winners):
            for (_, kw, sums, _), buf in zip(steps, k4_bufs):
                fn(buf, sums, radius, window_size=kw["window_size"], step=kw["step"], out=buf)

        k3_ms = graph_ms(k3_flow, 5) / n
        k4_ms = graph_ms(k4_flow, 5) / n
        variants = cost_volume_variants(port, frames, steps, radius, layers)
        step = flow_step_numbers(port, frames, radius, layers) if hasattr(
            cv, "flow_step") else None
        for before, kw, sums, _ in steps:   # the atomics' order does not change the sums
            if not torch.equal(cv.delta_sums(*frames, before, radius, 8, 6, **kw), sums):
                raise AssertionError(f"K3 r{radius}: a call differs from its first")
        plain3 = (time_ms(lambda: k3_flow(cv.delta_sums_reference), 1)
                  + time_ms(lambda: k3_flow(cv.delta_sums_reference), 1)) / (2 * n)
        plain4 = (time_ms(lambda: k4_flow(cv.commit_winners_reference), 1)
                  + time_ms(lambda: k4_flow(cv.commit_winners_reference), 1)) / (2 * n)
        before, kw, sums, _ = steps[0]
        host3 = host_us(lambda: cv.delta_sums(*frames, before, radius, 8, 6, **kw), 200)
        host4 = host_us(lambda: cv.commit_winners(k4_bufs[0], sums, radius,
                                                  window_size=kw["window_size"], step=0,
                                                  out=k4_bufs[0]), 200)
        bound3, bound4, by3, by4 = 0.0, 0.0, {}, {}
        for before, kw, sums, _ in steps:
            hbm, l2, ops = cost_volume_work(
                port, frames, before, radius, window=kw["window_size"],
                iteration=kw["iteration"], step=kw["step"], res_scalar=3, is_hdr=True,
                num_layers=layers)
            ms_, b = probe_bound(hbm, l2, ops, l2_rate)
            bound3 += ms_ / n
            by3[b] = by3.get(b, 0) + 1
            scan = min(radius, layers)
            moved4 = 2 * 2 * low_h * low_w + 4 * scan * sums[0].numel()
            ms_, b = roofline(moved4, low_h * low_w * (scan + K4_CELL_OPS), INT32_OPS_PER_S)
            bound4 += ms_ / n
            by4[b] = by4.get(b, 0) + 1
        out[radius] = {"delta_sums": {"ms": k3_ms, "plain_ms": plain3, "host_us": host3,
                                      "bound_ms": bound3, "bound_by": max(by3, key=by3.get)},
                       "commit_winners": {"ms": k4_ms, "plain_ms": plain4, "host_us": host4,
                                          "bound_ms": bound4, "bound_by": max(by4, key=by4.get)},
                       "calls_per_flow": n, "variants": variants}
        if step is not None:
            out[radius]["flow_step"] = dict(step, bound_ms=bound3 + bound4,
                                            bound_by=max(by3, key=by3.get))
    return out


def flow_step_numbers(port, frames, radius: int, layers: int) -> dict:
    """flow_step on one 4K HDR flow's steps (its own pyramid, reset before
    each flow, the reset's one fill included): graph-timed device ms a step
    (five flows captured in one CUDA graph, the mean), the plain version's
    ms a step (CUDA events), and host us a wrapper call."""
    cv = port.cost_volume_kernel
    low_h, low_w = LOW[1:]
    state = cv.PyramidState(*frames, radius, 8, 6, low_h=low_h, low_w=low_w, res_scalar=3,
                            is_hdr=True, num_layers=layers,
                            schedule=port.flow_ops.window_schedule(low_h, low_w))
    n = len(state.steps)

    def flow(fn=cv.flow_step):
        state.reset()
        for k in range(n):
            fn(state, k)

    ms = graph_ms(flow, 5) / n
    plain_ms = (time_ms(lambda: flow(cv.flow_step_reference), 1)
                + time_ms(lambda: flow(cv.flow_step_reference), 1)) / (2 * n)
    return {"ms": ms, "plain_ms": plain_ms,
            "host_us": host_us(lambda: cv.flow_step(state, 0), 200)}


# Timing variants (csrc/cost_volume.cu, hrt_delta_sums_probe and
# hrt_commit_winners_probe): name -> (entry point, variant).
CV_VARIANTS = {"K3 alone (no fill)": ("hrt_delta_sums_probe", 0),
               "K3 gathers at the cell's own pixel": ("hrt_delta_sums_probe", 1),
               "K3 one store a thread, no reduction": ("hrt_delta_sums_probe", 2),
               "K3's grid, empty": ("hrt_delta_sums_probe", 3),
               "K4 unrolled scan": ("hrt_commit_winners_probe", 0),
               "K4 serial scan": ("hrt_commit_winners_probe", 1),
               "K4's grid, empty": ("hrt_commit_winners_probe", 2),
               "K4 no scan": ("hrt_commit_winners_probe", 3),
               "K4 no offsets read": ("hrt_commit_winners_probe", 4)}


def cost_volume_variants(port, frames, steps, radius: int, layers: int) -> dict:
    """Graph-timed device ms a call of each of CV_VARIANTS over one flow's
    steps (K3's on each step's offsets, into a scratch sums buffer that is
    never read; K4's on each step's sums), the mean a call. {} where the
    library has no such entry point (a tree from before them)."""
    lib = port._build.load().lib
    if not all(hasattr(lib, entry) for entry, _ in CV_VARIANTS.values()):
        return {}
    f1y, f1uv = frames[:2]
    low_h, low_w = steps[0][0].shape[1:]
    dev_index = f1y.get_device()
    scratch = torch.empty(layers * low_h * low_w, dtype=torch.int32, device=f1y.device)
    probe_out = torch.empty(low_h * low_w, dtype=torch.int32, device=f1y.device)
    bufs = [before.clone() for before, *_ in steps]
    out = {}
    for name, (entry, variant) in CV_VARIANTS.items():
        def flow(entry=entry, variant=variant):
            for (before, kw, sums, _), buf in zip(steps, bufs):
                w = kw["window_size"]
                if entry == "hrt_delta_sums_probe":
                    port._build.launch(
                        entry, dev_index, variant, *(t.data_ptr() for t in frames),
                        before.data_ptr(), scratch.data_ptr(), probe_out.data_ptr(),
                        *f1y.shape, *f1uv.shape, low_h, low_w, radius, 8, 6, w, 3,
                        int(kw["iteration"] >= port.config.FIRST_NEIGHBOR_ITERATION),
                        kw["step"], layers)
                else:
                    port._build.launch(entry, dev_index, variant, buf.data_ptr(),
                                       buf.data_ptr(), sums.data_ptr(), low_h, low_w,
                                       sums.shape[0], radius, w, kw["step"])
        out[name] = graph_ms(flow, 5) / len(steps)
    return out


def format_cost_volume(numbers: dict) -> str:
    return "; ".join(
        f"r{r}: " + ", ".join(f"{k} {v['ms']:.5f} ms a call ({v['ms'] * d['calls_per_flow']:.4f} "
                              f"a flow), bound {v['bound_ms']:.5f} ({v['bound_by']}), host "
                              f"{v['host_us']:.1f} us/call, plain {v['plain_ms']:.4f} ms"
                              for k, v in d.items() if k not in ("calls_per_flow", "variants"))
        for r, d in numbers.items()) + "; variants (graph-timed ms a call): " + "; ".join(
        f"r{r}: " + ", ".join(f"{k} {v:.5f}" for k, v in d.get("variants", {}).items())
        for r, d in numbers.items())



def parallel_path(port, dev, card: str) -> dict:
    """Phase 7: K2's mesh-sharded variant against its plain version and the
    full K2 (7a), batched_step on two 4K HDR streams against the
    single-stream path (7b), and make_multichip_step on ranks of one card
    against 7b's results (7c). Returns the band kernel's entry of the
    `kernels` line, and K3's and K4's launches in 7b and over 7c's ranks."""
    wk, entry, launch = port.warp_kernel, port.entry, port.launch
    k2, k2_band = wk.warp_frames, wk.warp_frames_band

    # -- 7a. the kernel: every shard against its plain version, the shards
    # stacked against the full K2, at 4K HDR P010 with flow +-64 (n = 2, 4,
    # 8), smooth and mirror-edge flow (n = 2), and 1080p SDR (n = 8: UV's 540
    # rows split into 68-row bands, the last one 64).
    rng = np.random.default_rng(7)
    src = [torch.tensor(rng.integers(0, 1024, shape, dtype=np.uint16) << 6, device=dev)
           for shape in ((H, W), (H // 2, W)) * 2]
    flow = torch.tensor(rng.integers(-64, 65, LOW).astype(np.int16), device=dev)
    t3 = torch.tensor((0.2, 0.6, 1.0), dtype=torch.float32, device=dev)
    black, white = 16 * 256.0, 235 * 256.0
    sdr = [torch.tensor(rng.integers(0, 256, shape, dtype=np.uint8), device=dev)
           for shape in ((1080, 1920), (540, 1920)) * 2]
    sdr_flow = torch.tensor(rng.integers(-64, 65, (2, 270, 480)).astype(np.int16), device=dev)
    flows = {"random +-64": flow, "smooth": smooth_flow(port, rng), "mirror-edge": edge_flow(rng)}
    cases = [(src, flow, black, white, 3, True, n) for n in (2, 4, 8)]
    cases += [(src, flows[k], black, white, 3, True, 2) for k in ("smooth", "mirror-edge")]
    cases.append((sdr, sdr_flow, 16.0, 235.0, 2, False, 8))
    band_err, n_shards = 0, 0
    for srcs, fl, lo, hi, rs, is_hdr, n in cases:
        h = srcs[0].shape[0]
        for mode in (0, 1, 2):
            kw = dict(res_scalar=rs, mode=mode, is_hdr=is_hdr)
            full_y, full_uv = k2(*srcs, fl, t3, lo, hi, **kw)
            bands_y, bands_uv = [], []
            for shard in range(n):
                by, buv = k2_band(*srcs, fl, t3, lo, hi, num_shards=n, shard_index=shard, **kw)
                py, puv = wk.warp_frames_band_reference(*srcs, fl, t3, lo, hi, num_shards=n,
                                                        shard_index=shard, **kw)
                what = f"K2 band {h}p n {n} shard {shard} mode {mode}"
                band_err = max(band_err, require_equal(by, py, what + " Y"),
                               require_equal(buv, puv, what + " UV"))
                bands_y.append(by)
                bands_uv.append(buv)
                n_shards += 1
            require_equal(torch.cat(bands_y, 1)[:, :h], full_y, f"K2 bands {h}p n {n} Y")
            require_equal(torch.cat(bands_uv, 1)[:, :h // 2], full_uv, f"K2 bands {h}p n {n} UV")
    # Mode 3 at 4K HDR, n = 2: the band in mode 3 (the mesh's mode 3) against
    # the plain row route; the band's raw_blend variant against its plain
    # version (each flow), and coloured by the banded overlay (K5 with the
    # band's row offsets) against K5's plain version and the plain row route
    # (random flow).
    kw = dict(res_scalar=3, is_hdr=True)
    hk = port.hsv_kernel
    hsv_before = hk.hsv_flow_overlay.launches
    band_mode3_before = k2_band.mode3_launches
    band_raw_before = k2_band.raw_launches
    for shard in range(2):
        band = dict(num_shards=2, shard_index=shard)
        for flow_name, fl in flows.items():
            ry, ruv = k2_band(*src, fl, t3, black, white, mode=2, raw_blend=True, **band, **kw)
            py, puv = wk.warp_frames_band_reference(*src, fl, t3, black, white, mode=2,
                                                    raw_blend=True, **band, **kw)
            what = f"K2 band raw_blend 2160p {flow_name} n 2 shard {shard}"
            band_err = max(band_err, require_equal(ry, py, what + " Y"),
                           require_equal(ruv, puv, what + " UV"))
        ry, ruv = k2_band(*src, flow, t3, black, white, mode=2, raw_blend=True, **band, **kw)
        rows = (shard * ry.shape[1], shard * ruv.shape[1])
        y, uv = port.warp_viz.hsv_flow_overlay(ry, ruv, flow, black, white, **kw,
                                               row_offsets=rows)
        py, puv = hk.hsv_flow_overlay_reference(ry, ruv, flow, black, white, **kw,
                                                row_offsets=rows)
        wy, wuv = port.warp_ops.warp_frame_rows(*src, flow, t3, black, white, mode=3, **band,
                                                **kw)
        band_err = max(band_err, require_equal(y, py, f"K5 band 2160p n 2 shard {shard} Y"),
                       require_equal(uv, puv, f"K5 band 2160p n 2 shard {shard} UV"))
        require_equal(y, wy, f"mode 3 band 2160p n 2 shard {shard} Y")
        require_equal(uv, wuv, f"mode 3 band 2160p n 2 shard {shard} UV")
        fy, fuv = k2_band(*src, flow, t3, black, white, mode=3, **band, **kw)
        band_err = max(band_err, require_equal(fy, wy, f"K2 mode 3 band 2160p n 2 shard {shard} Y"),
                       require_equal(fuv, wuv, f"K2 mode 3 band 2160p n 2 shard {shard} UV"))
    band_hsv_launches = hk.hsv_flow_overlay.launches - hsv_before
    band_mode3_launches = k2_band.mode3_launches - band_mode3_before
    band_raw_launches = k2_band.raw_launches - band_raw_before
    if band_hsv_launches != 2 or band_mode3_launches != 2:
        raise AssertionError(f"7a: the mode-3 bands made {band_hsv_launches} K5 and "
                             f"{band_mode3_launches} K2 mode-3 launches, not 2 each")
    torch.cuda.synchronize()
    band = band_numbers(port, src, flows, t3, black, white)
    log(f"phase 7a K2 band: {n_shards} shard calls (4K HDR P010 flow +-64 at n = 2, 4, 8; "
        f"smooth and mirror-edge flow at n = 2; 1080p SDR at n = 8), modes 0/1/2, t (0.2, "
        f"0.6, 1.0): each equal to its plain version, the shards stacked equal to the full K2; "
        f"mode 3 at 4K HDR n = 2: the band in mode 3 ({band_mode3_launches} launches) equal to "
        f"the plain row route; the raw_blend band equal to its plain version (each flow), "
        f"and coloured by K5 ({band_hsv_launches} launches) equal to K5's plain version and to "
        f"the plain row route; max |err| {band_err}")

    # -- 7b. batched_step: two 4K HDR streams panning 3 px/frame, radius 16,
    # three steps, against the single-stream path (pyramid_flow + K2) and
    # against itself on the plain versions.
    cfg = port.config
    n_frames, blend = 5, (0.6, 0.2)        # each stream's t: one of t3
    streams = []
    for seed in (1, 2):
        frame_rng = np.random.default_rng(seed)
        frames = [port.nv12.synthetic_frame(frame_rng, H, W, is_hdr=True, motion_x=3 * i)
                  for i in range(n_frames)]
        streams.append([(y & P010_MASK, uv & P010_MASK) for y, uv in frames])
    ys = torch.tensor(np.stack([[f[0] for f in s] for s in streams]), device=dev)
    uvs = torch.tensor(np.stack([[f[1] for f in s] for s in streams]), device=dev)
    scal = (cfg.MAX_SEARCH_RADIUS, cfg.DEFAULT_DELTA_SCALAR, cfg.DEFAULT_NEIGHBOR_SCALAR)
    kw = dict(low_h=LOW[1], low_w=LOW[2], res_scalar=3, is_hdr=True)
    blend_t = torch.tensor(blend, dtype=torch.float32, device=dev)
    zero_flow = torch.zeros(LOW, dtype=torch.int16, device=dev)

    def run_batched(mode=2):
        flow_prev, outs = torch.stack([zero_flow] * 2), []
        for i in range(n_frames - 2):
            ring = [a[:, i + k].contiguous() for k in range(3) for a in (ys, uvs)]
            out = port.batched_step(*ring, flow_prev, *scal, blend_t, black, white, mode=mode,
                                    **kw)
            flow_prev = out[2]
            outs.append(out)
        return outs

    reset_launches(port)
    batched = run_batched()
    torch.cuda.synchronize()
    batched_launches = read_launches(port)
    require_launched(batched_launches, FLOW_KERNELS + ("warp_frames",), "7b batched_step")
    # The single-stream path, with all three t of t3 (7c's t_batch).
    single = []   # single[b][i] = (y (3, H, W), uv, blurred, delta_raw)
    for b in range(2):
        flow_prev, steps = zero_flow, []
        for i in range(n_frames - 2):
            f0, f1, f2 = ((ys[b, i + k], uvs[b, i + k]) for k in range(3))
            _, blurred, delta = port.flow_ops.pyramid_flow(*f1, *f2, *scal, **kw)
            y, uv = k2(*f0, *f1, flow_prev, t3, black, white, res_scalar=3, mode=2, is_hdr=True)
            steps.append((y, uv, blurred, delta))
            flow_prev = blurred
        single.append(steps)
    for i, out in enumerate(batched):
        for b in range(2):
            y, uv, blurred, delta = single[b][i]
            ti = (0.2, 0.6, 1.0).index(blend[b])
            what = f"batched_step step {i} stream {b}"
            require_equal(out[0][b], y[ti], what + " Y")
            require_equal(out[1][b], uv[ti], what + " UV")
            require_equal(out[2][b], blurred, what + " flow")
            if int(out[3][b]) != int(delta):
                raise AssertionError(f"{what}: delta {int(out[3][b])} != {int(delta)}")
    if not any(int(single[b][-1][2].abs().max()) for b in range(2)):
        raise AssertionError("batched_step: the flow found no motion on a panning stream")
    with plain_versions(port):
        plain = run_batched()
    for i, (out, p_out) in enumerate(zip(batched, plain)):
        for a, b_, what in zip(out, p_out, ("Y", "UV", "flow", "delta")):
            require_equal(a, b_, f"batched_step step {i} {what} against the plain versions")
    # Mode 3: the same streams through K2's mode 3, each output against the
    # single-stream call with the same flow, the flow against mode 2's run.
    reset_launches(port)
    batched3 = run_batched(mode=3)
    torch.cuda.synchronize()
    batched3_launches = read_launches(port)
    require_launched(batched3_launches, FLOW_KERNELS + ("warp_frames_mode3",),
                     "7b batched_step mode 3")
    if any(batched3_launches[k] for k in MODE3_OFF_PATH + ("warp_frames",)):
        raise AssertionError(f"7b: mode 3 launched more than K2's mode 3: {batched3_launches}")
    for i, out in enumerate(batched3):
        for b in range(2):
            flow_prev = zero_flow if i == 0 else single[b][i - 1][2]
            f0, f1 = ((ys[b, i + k], uvs[b, i + k]) for k in range(2))
            y, uv = k2(*f0, *f1, flow_prev, blend_t[b:b + 1], black, white, res_scalar=3, mode=3,
                       is_hdr=True)
            what = f"batched_step mode 3 step {i} stream {b}"
            require_equal(out[0][b], y[0], what + " Y")
            require_equal(out[1][b], uv[0], what + " UV")
            require_equal(out[2][b], batched[i][2][b], what + " flow")
    # Modes 4-6: one K2 launch in the mode a stream and step, and no other
    # K2; each output the single-stream warp_outputs with the same flow.
    batched_viz = {}
    for mode in VIZ_MODES:
        reset_launches(port)
        outs = run_batched(mode=mode)
        torch.cuda.synchronize()
        got = read_launches(port)
        if got["warp_frames_viz"] != 2 * len(outs) or any(
                got[k] for k in MODE3_OFF_PATH + ("warp_frames", "warp_frames_mode3")):
            raise AssertionError(f"7b: mode {mode} made not one K2 launch in its mode a stream "
                                 f"and step ({2 * len(outs)}): {got}")
        batched_viz[mode] = got["warp_frames_viz"]
        for i, out in enumerate(outs):
            for b in range(2):
                flow_prev = zero_flow if i == 0 else single[b][i - 1][2]
                f0, f1 = ((ys[b, i + k], uvs[b, i + k]) for k in range(2))
                y, uv = port.warp_viz.warp_outputs(*f0, *f1, flow_prev, blend_t[b:b + 1], black,
                                                   white, mode=mode, res_scalar=3, is_hdr=True)
                what = f"batched_step mode {mode} step {i} stream {b}"
                require_equal(out[0][b], y[0], what + " Y")
                require_equal(out[1][b], uv[0], what + " UV")
    log(f"phase 7b batched_step: 2 streams {W}x{H} HDR, radius 16, {n_frames - 2} steps, t "
        f"{blend}: outputs, flow and delta equal to the single-stream path and to the "
        f"plain-version run; launches {batched_launches}; in mode 3 each output equal to the "
        f"single-stream K2 mode 3, launches {batched3_launches}; in modes 4, 5 and 6 each "
        f"output equal to the single-stream warp_outputs, K2 launches in the mode "
        f"{batched_viz} (one a stream and step)")

    # -- 7c. make_multichip_step on ranks of this card (gloo), rs 3, modes
    # 2-6, t_batch 3: frames 1-4 of 7b's streams, the prior flow of 7b's
    # first step, two steps; the outputs against 7b's single-stream results
    # (modes 3-6: warp_viz.warp_outputs on the full frame, K2 beneath).
    meshes = [(1, 2), (2, 1)]
    if torch.cuda.device_count() >= 4:
        meshes += [(1, 4), (2, 2)]        # NCCL, a rank per card
    mesh_modes = (2, 3, 4, 5, 6)
    viz = {mode: [[port.warp_viz.warp_outputs(ys[b, 1 + i], uvs[b, 1 + i], ys[b, 2 + i],
                                              uvs[b, 2 + i], single[b][i][2], t3, black, white,
                                              mode=mode, res_scalar=3, is_hdr=True)
                   for i in range(2)] for b in range(2)] for mode in mesh_modes[1:]}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh.")
    try:
        in_path = os.path.join(tmp, "streams.npz")
        np.savez(in_path, y=ys[:, 1:].cpu().numpy(), uv=uvs[:, 1:].cpu().numpy(),
                 flow=torch.stack([single[b][0][2] for b in range(2)]).cpu().numpy(),
                 ts=t3.cpu().numpy())
        jobs = [dict(in_path=in_path, mode=mode, res_scalar=3, radius=scal[0],
                     delta_scalar=scal[1], neighbor_scalar=scal[2], black=black, white=white)
                for mode in mesh_modes]
        mesh_launches, mesh_mode3_launches, mesh_viz_launches = 0, 0, 0
        mode_launches, mesh_lines = {}, []
        flow_launches = {k: 0 for k in MESH_FLOW_KERNELS}
        for dp, sp in meshes:
            for job in jobs:
                job["out_path"] = os.path.join(tmp, f"mesh{dp}x{sp}.mode{job['mode']}."
                                               + "{rank}.npz")
            start = time.perf_counter()
            rank_paths = launch.run_ranks(entry.run_stream_steps, dp, sp, device="cuda",
                                          workdir=tmp, args=(jobs,), timeout=600)
            wall = time.perf_counter() - start
            step_ms, backends = {mode: [] for mode in mesh_modes}, set()
            # A rank's streams times its steps: one band launch each.
            rank_steps = (2 // dp) * 2
            for rank, paths in enumerate(rank_paths):
                for mode, path in zip(mesh_modes, paths):
                    with np.load(path) as z:
                        # Each job's own launches: one band a step, in the
                        # mode's counter (modes 0-2, 3, 4-6), none in another.
                        got_n = (int(z["band_launches"]), int(z["band_mode3_launches"]),
                                 int(z["band_viz_launches"]))
                        want = tuple(rank_steps if k == min(2, max(0, mode - 2)) else 0
                                     for k in range(3))
                        # K3 and K4: the flow, in every mode.
                        flow_n = {k: int(z[f"{k}_launches"]) for k in flow_launches}
                        if got_n != want or min(flow_n.values()) == 0 \
                                or z["foreign_modules"].size:
                            raise AssertionError(
                                f"mesh {dp}x{sp} rank {rank} mode {mode}: band launches "
                                f"(modes 0-2, 3, 4-6) {got_n}, not {want}; flow {flow_n}, jax "
                                f"modules {list(z['foreign_modules'])}")
                        for k, n in flow_n.items():
                            flow_launches[k] += n
                        mesh_launches += got_n[0]
                        mesh_mode3_launches += got_n[1]
                        mesh_viz_launches += got_n[2]
                        mode_launches[mode] = mode_launches.get(mode, 0) + sum(got_n)
                        step_ms[mode].append(float(z["step_ms"][-1]))
                        backends.add(str(z["backend"]))
            for j, mode in enumerate(mesh_modes):
                got = entry.gather_dp([p[j] for p in rank_paths], sp)
                for b in range(2):
                    for i in range(2):
                        y, uv, blurred, delta = single[b][i + 1]
                        if mode != 2:
                            y, uv = viz[mode][b][i]
                        what = f"mesh {dp}x{sp} mode {mode} stream {b} step {i}"
                        for g, want, name in ((got["y"][b, i], y, "Y"),
                                              (got["uv"][b, i], uv, "UV"),
                                              (got["blurred"][b, i], blurred, "flow")):
                            if not np.array_equal(g, want.cpu().numpy()):
                                raise AssertionError(f"{what}: {name} differs from the "
                                                     "single-device result")
                        if int(got["delta"][b, i]) != int(delta):
                            raise AssertionError(f"{what}: delta differs")
            per_mode = ", ".join(f"mode {mode} " + "/".join(f"{ms:.3f}" for ms in step_ms[mode])
                                 for mode in mesh_modes)
            mesh_lines.append(f"{dp}x{sp} ({'/'.join(sorted(backends))}) {wall:.1f} s wall, "
                              f"second step ms per rank (CUDA events): {per_mode}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 7c make_multichip_step {W}x{H} HDR rs 3 modes 2-6 t_batch 3, 2 streams x 2 "
        f"steps on meshes {meshes}: every rank's outputs, flow and delta equal to the "
        f"single-device results (7b; warp_outputs in modes 3-6) byte for byte; K2 band "
        f"launched once a rank and step in each mode: {mesh_launches} times over the ranks "
        f"in mode 2, {mesh_mode3_launches} in mode 3, {mesh_viz_launches} in modes 4-6; "
        f"launches by mode {mode_launches}; K3 and K4 "
        f"launched by every rank in every mode, {flow_launches} in all; "
        + "; ".join(mesh_lines))
    log(f"phase 7 numbers [{card}]: K2 band (n 2, shard 0, mode 2, T = 3, {W}x{H} HDR) "
        f"graph-timed {band['ms']:.5f} ms (random +-64 flow), {band['smooth_ms']:.5f} ms "
        f"(smooth), host {band['host_us']:.1f} us/call, plain {band['plain_ms']:.4f} ms")
    bound_ms, bound_by = band_bound(src, flow, t3, 2, 0)
    return {"name": "warp_frames_band", "route": "cuda",
            "source": "hopperrender_tpu_torch/csrc/warp_frame.cu",
            "replaces": "hopperrender_tpu/ops/warp_band.py:695 (mesh-sharded variant)",
            "launches": mesh_launches,
            "launches_by_mode": {str(mode): n for mode, n in sorted(mode_launches.items())},
            "max_abs_err": band_err, "ms": band["ms"],
            "smooth_ms": band["smooth_ms"], "host_us": band["host_us"],
            "plain_ms": band["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}, {
                "batched": {k: batched_launches[k] for k in ("flow_step", *flow_launches)},
                "batched_mode3": batched3_launches["warp_frames_mode3"],
                "batched_viz": batched_viz,
                "mesh": flow_launches, "mesh_mode3": mesh_mode3_launches,
                "mesh_viz": {str(m): mode_launches[m] for m in VIZ_MODES},
                "band_hsv": band_hsv_launches, "band_mode3": band_mode3_launches,
                "band_raw": band_raw_launches}


def u32_err(a: torch.Tensor, b: torch.Tensor, what: str) -> int:
    """max |a - b| of two uint32 tensors of one shape; raises where it is not 0."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    ai, bi = (t.view(torch.int32).long() & 0xFFFFFFFF for t in (a, b))
    err = int((ai - bi).abs().max())
    if err:
        raise AssertionError(f"{what}: {int((ai != bi).sum())} elements differ, max |err| {err}")
    return err


@contextlib.contextmanager
def recorded_band_reads(p1, sectors: list | None = None):
    """Points chain_probe.band_words, through which P1's and P2's plain
    versions read the band, at a recorder while the block runs: it marks
    every flat index read in the mask it yields and gives zeros. Where
    `sectors` is given, it also appends to it, for each chunk of iterations
    the plain version takes (chain_probe.table_fields marks where one
    starts), the chunk's iteration count and the 32-byte sectors (flat index
    >> 3, int32, one row per iteration) of each read the chunk made."""
    seen = torch.zeros(p1.ROWS * p1.W32, dtype=torch.bool)

    class Reads:
        def __getitem__(self, flat):
            seen[flat.reshape(-1)] = True
            if sectors is not None:
                sectors[-1][1].append((flat >> 3).to(torch.int32))
            return torch.zeros_like(flat)

    def table_fields(tab, i0, i1):
        if sectors is not None:
            sectors.append((i1 - i0, []))
        return fields(tab, i0, i1)

    band_words, fields = p1.band_words, p1.table_fields
    p1.band_words, p1.table_fields = (lambda band: Reads()), table_fields
    try:
        yield seen
    finally:
        p1.band_words, p1.table_fields = band_words, fields


def probe_sectors(port, name: str, variant: str, inputs: tuple, n: int) -> torch.Tensor:
    """The distinct 32-byte band sectors each of the n iterations of a P1 or
    P2 variant reads on these CPU inputs (tab, band[, res]), from the words
    its plain version names: (n,) int64. A block reads them from the L2 (the
    band is L2-resident; blocks share no L1)."""
    chunks = []
    with recorded_band_reads(port.probes["chain_probe"], chunks):
        port.probes[name].run_reference(variant, n, *inputs)
    counts = []
    for k, reads in chunks:
        if not reads:
            counts.append(torch.zeros(k, dtype=torch.int64))
            continue
        sec = torch.cat([r.reshape(r.shape[0], -1).expand(k, -1) for r in reads], 1)
        sec = sec.sort(1).values
        counts.append(1 + (sec[:, 1:] != sec[:, :-1]).sum(1))
    return torch.cat(counts) if counts else torch.zeros(0, dtype=torch.int64)


def probe_l2_bytes(port, name: str, variant: str, inputs: tuple, n: int, blocks: int) -> int:
    """The L2 bytes of one call of a P1 or P2 variant: `blocks` x the sum
    over its iterations of the distinct sectors each reads x 32 B."""
    return SECTOR_BYTES * blocks * int(probe_sectors(port, name, variant, inputs, n).sum())


def probe_bound(moved: int, l2_bytes: int, ops: int,
                l2_bytes_per_s: float | None) -> tuple[float, str]:
    """(bound_ms, bound_by) of a probe call: the largest of its HBM bytes over
    the memory rate, its L2 bytes over the L2 read rate measured in this run
    (where there is one) and its integer operations over the int32 rate."""
    terms = {"bytes": 1e3 * moved / HBM_BYTES_PER_S, "operations": 1e3 * ops / INT32_OPS_PER_S}
    if l2_bytes_per_s:
        terms["l2"] = 1e3 * l2_bytes / l2_bytes_per_s
    by = max(terms, key=terms.get)
    return terms[by], by


def l2_read(port, src: torch.Tensor, out: torch.Tensor, passes: int, blocks: int) -> None:
    """One launch of hrt_l2_read (csrc/errors.cu): `blocks` blocks each read
    all of src (L2-resident) `passes` times with 16-byte loads, all in step;
    counted in l2_read.launches."""
    port._build.check(port._build.entry("hrt_l2_read")(
        passes, src.numel() // 4, src.data_ptr(), out.data_ptr(), blocks,
        torch.cuda.current_stream().cuda_stream), "l2 read")
    l2_read.launches += 1


l2_read.launches = 0


def l2_read_rate(port, dev) -> dict | None:
    """The card's L2 read rate: L2_BLOCKS blocks stream a 2 MB buffer (the
    band's size) L2_PASSES times each, in step (as P1's and P2's identical
    blocks read), graph-timed; every block's sum is checked first. The
    ceiling the probes' bound uses. None where the library has no
    hrt_l2_read (an older tree)."""
    if getattr(port._build.load().lib, "hrt_l2_read", None) is None:
        return None
    src = torch.from_numpy(np.random.default_rng(5).integers(
        -2**31, 2**31, 512 * 1024, dtype=np.int64).astype(np.int32)).to(dev)
    out = torch.empty(L2_BLOCKS * 1024, dtype=torch.int32, device=dev)
    want = (3 * int(src.long().sum())) & 0xFFFFFFFF
    l2_read(port, src, out, 3, L2_BLOCKS)
    sums = out.view(L2_BLOCKS, -1).long().sum(1) & 0xFFFFFFFF
    if int((sums != want).sum()):
        raise AssertionError("l2 read: a block's sum differs from the buffer's")
    moved = L2_BLOCKS * L2_PASSES * nbytes(src)
    ms = graph_ms(lambda: l2_read(port, src, out, L2_PASSES, L2_BLOCKS), 5)
    return {"bytes": moved, "ms": ms, "bytes_per_s": moved / (ms / 1e3)}


def probe_work(port, name: str, variant: str, inputs: tuple, n: int,
               blocks: int) -> tuple[int, int]:
    """(bytes, operations) of one call of a probe variant on these CPU
    inputs: each distinct input word it reads, once, and its output; the
    operations of PROBE_OPS. P1/P2 (inputs tab, band[, res]; n iterations on
    `blocks` blocks): the band words the plain version reads (`full` counts
    its second word in every lane: an upper bound), the table fields it
    uses. P3/P4 (inputs idx): x is made of its own flat indices, so the
    plain version's output names the words read."""
    probes, (elem_ops, tile_ops) = port.probes, PROBE_OPS[name][variant]
    if name in ("chain_probe", "chain_probe2"):
        p1 = probes["chain_probe"]
        with recorded_band_reads(p1) as seen:
            probes[name].run_reference(variant, n, *inputs)
        fields = 1 if variant == "empty" else 3 if variant in ("smem_only", "full",
                                                               "full_aligned_rows") else 2
        reads_res = variant in ("vsel_x17", "fastpath_tile")
        moved = 4 * (int(seen.sum()) + fields * min(n, p1.T) + 1024 * (reads_res + blocks))
        if variant in ("full", "full_aligned_rows"):
            sub = inputs[0][1, torch.arange(n) & (p1.T - 1)].long() & 3
            ops = n * tile_ops + FULL_LANES * int((elem_ops + FULL_SECOND_WORD_OPS
                                                   * (sub != 0)).sum())
        else:
            ops = n * (tile_ops + 1024 * elem_ops)
        return moved, blocks * ops
    mod, (idx,) = probes[name], inputs
    pos = torch.arange(np.prod(mod.X_SHAPE), dtype=torch.int32).view(mod.X_SHAPE)
    if name == "gather_probe":
        read = mod.run_reference(variant, pos, idx)
        read = read[read != mod.FILL]
    else:
        read = mod.run_reference(variant, idx, pos)
    n_out = 1024 if name == "gather_probe" else 2048
    return 4 * (read.unique().numel() + n_out) + nbytes(idx), n_out * elem_ops + tile_ops


def probe_phase(port, dev, card: str) -> list[dict]:
    """Phase 8: the probes P1-P4 against their plain versions (8a), the probe
    path with the launch counters at 0 (8b), and the numbers (8c). Returns
    the four entries of the `kernels` line."""
    start = time.perf_counter()
    probes, probe_path = port.probes, port.probe_path
    p1, p2, p3, p4 = (probes[k] for k in ("chain_probe", "chain_probe2", "gather_probe",
                                      "mosaic_probe"))
    wrappers = {name: mod.run for name, mod in probes.items()}

    # -- 8a. parity. P1/P2: the script's inputs (seed 0) at every n of
    # PARITY_NS; every slot of 1 and of 132 blocks.
    errs = dict.fromkeys(probes, 0)
    variants = {"chain_probe": p1.VARIANTS, "chain_probe2": p2.KERNEL_VARIANTS,
                "gather_probe": p3.VARIANTS, "mosaic_probe": p4.VARIANTS}
    for name, names in variants.items():
        if set(PROBE_OPS[name]) != set(names):
            raise AssertionError(f"PROBE_OPS[{name!r}] does not count the variants {names}")
    p1_in, p2_in = p1.make_inputs(0, dev), p2.make_inputs(0, dev)
    for name, mod, inputs in (("chain_probe", p1, p1_in), ("chain_probe2", p2, p2_in)):
        for variant in variants[name]:
            for n in PARITY_NS:
                want = mod.run_reference(variant, n, *inputs)
                for blocks in PROBE_BLOCKS:
                    got = mod.run(variant, n, *inputs, blocks=blocks)
                    errs[name] = max(errs[name], u32_err(
                        got, want.expand(blocks, -1, -1), f"{name} {variant} n {n} B {blocks}"))
    before = p2.run.launches
    try:
        p2.run("transpose8", 1, *p2_in)
        raise AssertionError("chain_probe2 transpose8 was not refused")
    except TypeError:
        if p2.run.launches != before:
            raise AssertionError("chain_probe2 transpose8 launched") from None
    # P3: the script's indices, and indices that wrap, fill or clamp; P4: the
    # script's offsets and offsets whose windows clamp or whose rolls wrap.
    x3, idx3 = p3.make_inputs(dev)
    edges = np.random.default_rng(8).integers(-263, 249, (8, 128)).astype(np.int32)
    edges[0, :12] = [0, 63, -1, -64, -65, 64, 248, 249, -7, -8, -263, 1000]
    for idx in (idx3, torch.from_numpy(edges).to(dev)):
        for variant in p3.VARIANTS:
            errs["gather_probe"] = max(errs["gather_probe"], require_equal(
                p3.run(variant, x3, idx), p3.run_reference(variant, x3, idx), f"P3 {variant}"))
    x4 = p4.make_inputs(device=dev)[1]
    for offsets in ((5, 128), (121, 255), (127, 256), (-1, -1), (-9, 1000), (17, 129)):
        idx4 = p4.make_inputs(offsets, dev)[0]
        for variant in p4.VARIANTS:
            errs["mosaic_probe"] = max(errs["mosaic_probe"], require_equal(
                p4.run(variant, idx4, x4), p4.run_reference(variant, idx4, x4),
                f"P4 {variant} idx {offsets}"))
    torch.cuda.synchronize()
    log(f"phase 8a probes: P1's {len(p1.VARIANTS)} and P2's "
        f"{len(p2.KERNEL_VARIANTS)} variants at n = {PARITY_NS} on {PROBE_BLOCKS} blocks, "
        f"every slot, P3's 3 and P4's 7 kernels at clamping indices: each equal to its plain "
        f"version; transpose8 refused before a launch; max |err| {errs}")

    # -- 8b. the probe path, with every probe's counter at 0.
    hz = port.probe_path._timing.sm_clock_hz()
    for run in wrappers.values():
        run.launches = 0
    runs = [("chain", 1), ("chain", 132), ("chain2", 1), ("chain2", 132), ("gather", 1),
            ("mosaic", 1)]
    scaling = {}    # "<probe> <variant>": its Slope on 132 blocks
    for probe, blocks in runs:
        results = probe_path.run_probe(probe, device=dev, blocks=blocks,
                                       echo=lambda line: log(f"phase 8b {probe} B={blocks}: "
                                                             f"{line}"))
        failed = [r.line for r in results if r.error and not r.expected_failure]
        if failed:
            raise AssertionError(f"the probe path failed: {failed}")
        if probe.startswith("chain") and blocks == PROBE_BLOCKS[-1]:
            scaling.update((f"{probe} {r.variant}", r.slope) for r in results if r.slope)
    launches = {name: run.launches for name, run in wrappers.items()}
    if min(launches.values()) == 0:
        raise AssertionError(f"a probe kernel never launched on the probe path: {launches}")
    clock = f"max SM clock {hz / 1e6:.0f} MHz" if hz else "max SM clock not read"
    log(f"phase 8b probe path [{card}, {clock}]: runs {runs}; launches {launches}")
    if len(scaling) != len(p1.VARIANTS) + len(p2.KERNEL_VARIANTS):
        raise AssertionError(f"the probe path timed {len(scaling)} P1/P2 variants on "
                             f"{PROBE_BLOCKS[-1]} blocks")
    ratio = {k: sl.t2_s / sl.t1_s for k, sl in scaling.items()}
    n1, n2 = probe_path.DEFAULT_N["chain"]
    low = {k: round(r, 3) for k, r in ratio.items() if r < MIN_SCALING}
    if low:
        raise AssertionError(f"t(n = {n2}) / t(n = {n1}) on {PROBE_BLOCKS[-1]} blocks below "
                             f"{MIN_SCALING}: the loop's work does not grow with n: {low}")
    log(f"phase 8b scaling [{card}]: t(n = {n2}) / t(n = {n1}) on {PROBE_BLOCKS[-1]} blocks, "
        f"each >= {MIN_SCALING}: " + ", ".join(f"{k} {r:.3f}" for k, r in ratio.items()))

    # -- 8c. numbers: probe_numbers (every probe graph-timed, P1/P2 at n = 600
    # on 132 blocks, the floor timed beside each probe, P3/P4 against their
    # one-call PyTorch counterparts; the L2 read rate); the plain versions by
    # CUDA events; each P1/P2 variant held to its bound.
    B = PROBE_BLOCKS[-1]
    timed = probe_numbers(port, dev)
    l2 = timed["l2_read"]
    if l2 is None:
        raise AssertionError("no L2 read rate: the library has no hrt_l2_read")
    log(f"phase 8c L2 read rate [{card}]: {format_l2(l2)} ({L2_BLOCKS} blocks each read a 2 "
        f"MB buffer {L2_PASSES} times in step, 16-byte .cg loads, graph-timed)")
    idx4 = p4.make_inputs(device=dev)[0]
    plain_calls = {
        "chain_probe": [lambda v=v: p1.run_reference(v, PROBE_N, *p1_in, blocks=B)
                        for v in p1.VARIANTS],
        "chain_probe2": [lambda v=v: p2.run_reference(v, PROBE_N, *p2_in, blocks=B)
                         for v in p2.KERNEL_VARIANTS],
        "gather_probe": [lambda v=v: p3.run_reference(v, x3, idx3) for v in p3.VARIANTS],
        "mosaic_probe": [lambda v=v: p4.run_reference(v, idx4, x4) for v in p4.VARIANTS]}
    # The bound of each entry: the sum of its variants' bounds, each the
    # largest of its HBM bytes over the memory rate, its L2 bytes (P1/P2:
    # probe_l2_bytes) over the L2 read rate measured above, and its integer
    # operations over the int32 rate (probe_work); beside it for P1/P2 the
    # bound without the L2 term, as it stood before the L2 term.
    cpu_inputs = {"chain_probe": tuple(t.cpu() for t in p1_in),
                  "chain_probe2": tuple(t.cpu() for t in p2_in),
                  "gather_probe": (idx3.cpu(),), "mosaic_probe": (idx4.cpu(),)}
    sources = {"chain_probe": ("chain_probe.cu", "scripts/chain_probe.py:103"),
               "chain_probe2": ("chain_probe2.cu", "scripts/chain_probe2.py:113"),
               "gather_probe": ("gather_probe.cu", "scripts/gather_probe.py:40"),
               "mosaic_probe": ("mosaic_probe.cu", "scripts/mosaic_probe.py:14")}
    entries, numbers, per_variant = [], [], []
    for name, plains in plain_calls.items():
        n_var, t, chain = len(plains), timed[name], name.startswith("chain")
        plain_ms = sum((time_ms(plain, 2) + time_ms(plain, 2)) / 2 for plain in plains)
        by_kind = {"bytes": 0.0, "l2": 0.0, "operations": 0.0}
        without_l2, l2_total, variant_bounds = 0.0, 0, {}
        for variant in variants[name]:
            moved, ops = probe_work(port, name, variant, cpu_inputs[name], PROBE_N, B)
            l2_bytes = (probe_l2_bytes(port, name, variant, cpu_inputs[name], PROBE_N, B)
                        if chain else 0)
            ms_v, by_v = probe_bound(moved, l2_bytes, ops, l2["bytes_per_s"])
            variant_bounds[variant] = ms_v, by_v
            by_kind[by_v] += ms_v
            without_l2 += probe_bound(moved, 0, ops, None)[0]
            l2_total += l2_bytes
        bound_ms = sum(by_kind.values())
        bound_by = max(by_kind, key=by_kind.get)
        src, replaces = sources[name]
        entry = {"name": name, "route": "cuda",
                 "source": f"hopperrender_tpu_torch/csrc/{src}", "replaces": replaces,
                 "launches": launches[name], "max_abs_err": errs[name], "ms": t["ms"],
                 "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": t["library_ms"], "host_us": t["host_us"],
                 "library_host_us": t["library_host_us"], "floor_ms": t["floor_ms"]}
        if chain:
            entry.update(bound_ms_without_l2=without_l2, l2_bytes=l2_total,
                         l2_bytes_per_s=l2["bytes_per_s"],
                         variants_ms={v: p["ms"] for v, p in t["variants"].items()},
                         variants_bound_ms={v: b for v, (b, _) in variant_bounds.items()})
            below = {v: round(p["ms"] / variant_bounds[v][0], 3) for v, p in t["variants"].items()
                     if p["ms"] < MIN_BOUND_RATIO * variant_bounds[v][0]}
            if below:
                raise AssertionError(f"{name}: variants timed below {MIN_BOUND_RATIO} of their "
                                     f"bound (time / bound): {below}")
            per_variant.append(f"{name} " + ", ".join(
                f"{v} {p['ms']:.5f} ms ({p['ms'] / variant_bounds[v][0]:.2f}x its bound, "
                f"{variant_bounds[v][1]})" for v, p in t["variants"].items()))
        entries.append(entry)
        lib = ("none" if t["library_ms"] is None else
               f"{t['library_ms']:.5f} ms graph-timed, host {t['library_host_us']:.2f} us/call")
        floor_ms = t["floor_ms"]
        old = f", without the L2 term {without_l2:.5f} ms" if chain else ""
        numbers.append(f"{name} ({n_var} variants) {t['ms']:.5f} ms graph-timed, floor "
                       f"{floor_ms if floor_ms is None else f'{floor_ms:.5f}'} ms, host "
                       f"{t['host_us']:.2f} us/call; plain {plain_ms:.4f} ms; library {lib}; bound "
                       f"{bound_ms:.5f} ms ({bound_by}; " + ", ".join(
                           f"{k} {v:.5f}" for k, v in by_kind.items()) + f"){old}")
    log(f"phase 8c numbers [{card}]: one call of each variant, summed, graph-timed (P1/P2 at n "
        f"= {PROBE_N} on {B} blocks, {CHAIN_GRAPH_CALLS} calls a CUDA graph; P3/P4 "
        f"{PROBE_GRAPH_CALLS} calls, each library call equal to its kernel), the floor timed "
        f"beside each probe; host us per call over {HOST_CALLS} calls for P3/P4, "
        f"{CHAIN_HOST_CALLS} on one block for P1/P2, the mean over the variants: "
        + "; ".join(numbers) + f"; phase 8 took {time.perf_counter() - start:.1f} s")
    log(f"phase 8c P1/P2 per variant [{card}] (graph-timed ms at n = {PROBE_N} on {B} blocks, "
        f"against its bound): " + "; ".join(per_variant))
    return entries


# -- 9. the serving surface ------------------------------------------------------

# `python -m hopperrender_tpu_torch ARGS`, with the launch counters of K1-K4
# and K6 set to 0 before it and printed to stderr (one line, "launches
# {...}") after it, however it ends.
CLI_WITH_COUNTERS = """
import json, runpy, sys
from hopperrender_tpu_torch.ops import blur_kernel, copy_kernel, cost_volume_kernel, warp_kernel
k1, k2, k6 = blur_kernel.blur_flow, warp_kernel.warp_frames, copy_kernel.copy_frame
cv = cost_volume_kernel
step, k3, k4 = cv.flow_step, cv.delta_sums, cv.commit_winners
k1.launches = k2.launches = k2.raw_launches = step.launches = k3.launches = k4.launches = 0
k6.launches = 0
try:
    runpy.run_module("hopperrender_tpu_torch", run_name="__main__", alter_sys=True)
finally:
    print("launches " + json.dumps({"blur_flow": k1.launches, "warp_frames": k2.launches,
                                    "flow_step": step.launches, "delta_sums": k3.launches,
                                    "commit_winners": k4.launches,
                                    "copy_frame": k6.launches}),
          file=sys.stderr, flush=True)
"""
CLI_H, CLI_W, CLI_FRAMES = 1080, 1920, 12   # 9a: the CLI's SDR stream
SERVE_FRAMES = 40            # 9c: 4K HDR source frames through the pipeline


def panning_frames(port, h: int, w: int, n: int, *, is_hdr: bool, step: int = 3) -> list:
    """n frames of one textured canvas, each `step` px further right: a pan
    whose noise moves with it, made with one synthetic_frame call."""
    y, uv = port.nv12.synthetic_frame(np.random.default_rng(9), h, w + step * n, is_hdr=is_hdr)
    if is_hdr:
        y, uv = y & P010_MASK, uv & P010_MASK
    return [(y[:, step * i:step * i + w], uv[:, step * i:step * i + w]) for i in range(n)]


def serve_to_y4m(port, srv, frames, path: str) -> None:
    """frames through FrameServer srv, written as the CLI writes them."""
    writer = port.video.Y4MWriter(path, srv.width, srv.height, 60.0, is_hdr=srv.is_hdr)
    try:
        for y, uv in frames:
            for out in srv.push_frame(y, uv):
                writer.write(out.y, out.uv)
    finally:
        writer.close()


def cli_phase(port, dev, tmp: str) -> dict:
    """9a: 12 panning 1080p SDR frames through `python -m hopperrender_tpu_torch
    interpolate` and `serve --status-port 0 --stats` (two processes at once),
    mode 2, 24 -> 60, the scaler off; both outputs byte-equal to each other and
    to the stream through two FrameServers in this process, on the kernels and
    on the plain versions; each run's K1-K4 and K6 launch counters."""
    if not port.native.is_native():
        raise AssertionError("the native frame ring did not build or load (NumPy fallback)")
    h, w, n = CLI_H, CLI_W, CLI_FRAMES
    frames = panning_frames(port, h, w, n, is_hdr=False)
    src, settings = os.path.join(tmp, "pan.nv12"), os.path.join(tmp, "settings.json")
    with open(src, "wb") as f:
        for y, uv in frames:
            f.write(port.nv12.pack(y, uv).tobytes())
    with open(settings, "w") as f:
        json.dump({"auto_quality": False}, f)
    args = ["--width", str(w), "--height", str(h), "--fps", "24", "--target-fps", "60",
            "--mode", "2", "--settings", settings, "--stats", "--device", dev.type]
    runs = {"interpolate": ["interpolate", src, os.path.join(tmp, "interpolate.y4m"), *args],
            "serve": ["serve", src, os.path.join(tmp, "serve.y4m"), *args,
                      "--status-port", "0"]}
    start = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, "-c", CLI_WITH_COUNTERS, *argv], cwd=ROOT,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, argv in runs.items()}
    results = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"the CLI's {name} exited {proc.returncode}:\n{err[-3000:]}")
            counts = [l for l in err.splitlines() if l.startswith("launches ")]
            results[name] = dict(stats=json.loads(out.strip().splitlines()[-1]),
                                 launches=json.loads(counts[-1].split(" ", 1)[1]))
            if name == "serve" and "status endpoint: http://" not in err:
                raise AssertionError("serve printed no status endpoint")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    cli_s = time.perf_counter() - start

    st = port.Settings(target_fps=60.0, use_display_fps=False, frame_output=2,
                       auto_quality=False)
    new_server = lambda: port.FrameServer(w, h, source_fps=24.0, device=dev, settings=st)
    reset_launches(port)
    serve_to_y4m(port, new_server(), frames, os.path.join(tmp, "kernels.y4m"))
    torch.cuda.synchronize()
    launches = read_launches(port)
    with plain_versions(port):
        serve_to_y4m(port, new_server(), frames, os.path.join(tmp, "plain.y4m"))
    if read_launches(port) != launches:
        raise AssertionError("the plain-version stream launched a kernel")
    counts = {"this process": launches, **{f"the CLI's {k}": v["launches"]
                                           for k, v in results.items()}}
    for run, count in counts.items():
        require_launched(count, FLOW_KERNELS + ("warp_frames", "copy_frame"), f"9a, {run}")
        require_pyramid_path(count, f"9a, {run}")
    outputs = {}
    for name in ("interpolate", "serve", "kernels", "plain"):
        with open(os.path.join(tmp, f"{name}.y4m"), "rb") as f:
            outputs[name] = f.read()
    for name, data in outputs.items():
        if data != outputs["plain"]:
            raise AssertionError(f"9a: the {name} Y4M differs from the plain-version stream's")
    expected = cadence_count(port, n)
    for name, r in results.items():
        if (r["stats"]["frames_in"], r["stats"]["frames_out"]) != (n, expected):
            raise AssertionError(f"the CLI's {name}: {r['stats']['frames_in']} in, "
                                 f"{r['stats']['frames_out']} out (cadence {expected})")
    return dict(results=results, launches=launches, cli_s=cli_s, frames_out=expected,
                y4m_bytes=len(outputs["plain"]))


def digest_phase(port, dev) -> dict:
    """9b: the four pinned-digest streams of tests/fixtures/digests.json on
    the card, through K1-K4 and K6 (their warmup copies), no plain copy."""
    with open(os.path.join(ROOT, "tests", "fixtures", "digests.json")) as f:
        pinned = json.load(f)
    reset_launches(port)
    with plain_copies_on_the_card(port) as plain_copies:
        for name in port.digests.STREAMS:
            got = port.digests.stream_digest(name, dev)
            if got != pinned[name]:
                raise AssertionError(f"digest {name}: {got} != pinned {pinned[name]}")
    launches = read_launches(port)
    require_launched(launches, FLOW_KERNELS + ("warp_frames", "copy_frame"), "9b")
    if plain_copies:
        raise AssertionError(f"9b: {len(plain_copies)} plain copies on the card")
    return launches


def get_json(url: str) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def scaler_phase(port, dev) -> dict:
    """9c: PipelinedServer with a StatusServer, 4K HDR P010 24 -> 60, mode 2,
    levels 16/235, the quality scaler on, SERVE_FRAMES panning frames. A
    thread polls /metrics and /healthz throughout. Every call the server
    makes to its scaler is recorded (wrapped here, not in the package) and
    replayed on a fresh AutoQualityScaler; each source frame's state and
    outputs are recorded on the engine thread. Fails on what the control
    logic guarantees: the replay differs, a radius leaves [5, 16], an output
    made while TOO_SLOW is not the copy of its source frame, a copy (warmup
    or TOO_SLOW) was not one K6 launch or a plain copy ran on the card, the
    engine thread raised, or /healthz answered other than 200. What the
    scaler does on this card is reported, not judged."""
    config = port.config
    frames = panning_frames(port, H, W, SERVE_FRAMES, is_hdr=True)
    st = port.Settings(target_fps=60.0, use_display_fps=False, frame_output=2,
                       black_level=16, white_level=235)
    srv = port.FrameServer(W, H, source_fps=24.0, is_hdr=True, device=dev, settings=st)
    if not srv.scaler.enabled:
        raise AssertionError("the quality scaler is off")

    calls = []            # ("warp", seconds) and ("adjust", args, returned, too_slow)
    scaler = srv.scaler
    add_warp, adjust = scaler.add_warp_duration, scaler.adjust

    def record_warp(seconds):
        calls.append(("warp", seconds))
        add_warp(seconds)

    def record_adjust(*a):
        radius = adjust(*a)
        calls.append(("adjust", a, radius, scaler.too_slow))
        return radius

    scaler.add_warp_duration, scaler.adjust = record_warp, record_adjust
    per_frame = []        # (state, outputs, flow seconds or None, push_frame wall seconds)
    push = srv.push_frame

    def record_push(y, uv, **kw):
        start = time.perf_counter()
        outs = push(y, uv, **kw)
        wall = time.perf_counter() - start
        eng = srv.engine
        per_frame.append((srv.cadence.state, len(outs),
                          eng.ofc_time.current if eng.frame_count >= 3 else None, wall))
        return outs

    srv.push_frame = record_push
    reset_launches(port)
    pipe = port.PipelinedServer(srv)
    status = port.StatusServer(srv, pipeline=pipe)
    base = f"http://{status.host}:{status.port}"
    polls, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            try:
                code, health = get_json(base + "/healthz")
                _, metrics = get_json(base + "/metrics")
                polls.append((code, health, metrics["search_radius"]))
            except OSError as e:     # no answer counts as unhealthy
                polls.append((None, repr(e), config.MIN_SEARCH_RADIUS))
            stop.wait(0.05)

    def feed():
        try:
            for y, uv in frames:
                pipe.feed(y, uv)
        finally:
            pipe.close()

    poller = threading.Thread(target=poll, name="chip-smoke-poll", daemon=True)
    feeder = threading.Thread(target=feed, name="chip-smoke-feed", daemon=True)
    outs, arrivals = [], []
    start = time.perf_counter()
    poller.start()
    feeder.start()
    try:
        with plain_copies_on_the_card(port) as plain_copies:
            for out in pipe.outputs(timeout=300):   # raises if the engine thread failed
                outs.append(out)
                arrivals.append(time.perf_counter())
            wall = time.perf_counter() - start
            pipe.join()
    finally:
        feeder.join(timeout=60)
        pipe.join()
        stop.set()
        poller.join(timeout=30)
        status.close()
    torch.cuda.synchronize()
    launches = read_launches(port)
    if pipe._error is not None or not pipe.healthy():
        raise AssertionError(f"the engine thread failed: {pipe._error!r}")
    if not polls or any(code != 200 for code, *_ in polls):
        raise AssertionError(f"/healthz: {[p[:2] for p in polls if p[0] != 200][:3]} "
                             f"({len(polls)} polls)")
    if len(per_frame) != SERVE_FRAMES or sum(f[1] for f in per_frame) != len(outs):
        raise AssertionError("the pipeline lost or added frames")
    require_launched(launches, FLOW_KERNELS + (("warp_frames",) if any(
        o.interpolated for o in outs) else ()), "9c")
    require_copies_on_k6(launches, sum(not o.interpolated for o in outs), plain_copies, "9c")

    # The replay: the same calls on a fresh scaler give the same radii and flags.
    fresh = port.AutoQualityScaler(enabled=True)
    radii = []
    for call in calls:
        if call[0] == "warp":
            fresh.add_warp_duration(call[1])
            continue
        _, a, radius, too_slow = call
        if (fresh.adjust(*a), fresh.too_slow) != (radius, too_slow):
            raise AssertionError(f"the scaler's call {len(radii)} differs from its replay")
        radii.append(radius)
    if len(radii) != SERVE_FRAMES:
        raise AssertionError(f"{len(radii)} scaler calls for {SERVE_FRAMES} frames")
    seen = radii + [p[2] for p in polls]
    if not all(config.MIN_SEARCH_RADIUS <= r <= config.MAX_SEARCH_RADIUS for r in seen):
        raise AssertionError(f"a radius outside [5, 16]: {sorted(set(seen))}")

    # Outputs made while TOO_SLOW: copies (with levels) of their source frame,
    # the one two frames back (the engine's pipeline latency).
    dev_frames = {}
    copies, i = 0, 0
    for k, (state, n, _, _) in enumerate(per_frame):
        for out in outs[i:i + n]:
            if state != config.ActiveState.TOO_SLOW:
                continue
            if out.interpolated:
                raise AssertionError(f"source frame {k}: an interpolated output while TOO_SLOW")
            j = max(k - 2, 0)
            if j not in dev_frames:
                y, uv = (torch.tensor(np.ascontiguousarray(p), device=dev) for p in frames[j])
                cy, cuv = port.warp_ops.copy_frame(y, uv, 16 * 256.0, 235 * 256.0, is_hdr=True)
                dev_frames[j] = (cy.cpu().numpy(), cuv.cpu().numpy())
            if not (np.array_equal(out.y, dev_frames[j][0])
                    and np.array_equal(out.uv, dev_frames[j][1])):
                raise AssertionError(f"source frame {k}: an output while TOO_SLOW is not the "
                                     f"copy of source frame {j}")
            copies += 1
        i += n
    states = [int(f[0]) for f in per_frame]
    edges = [(k, config.ActiveState(states[k - 1]).name, config.ActiveState(states[k]).name)
             for k in range(1, len(states)) if states[k] != states[k - 1]]
    flows = [f[2] for f in per_frame if f[2] is not None]
    return dict(radii=radii, edges=edges, copies=copies, launches=launches, polls=len(polls),
                flow_ms=1e3 * statistics.median(flows), outputs=len(outs), wall=wall,
                out_fps=len(outs) / wall, interpolated=sum(o.interpolated for o in outs),
                steady_fps=(len(outs) - 1) / (arrivals[-1] - arrivals[0]),
                push_ms=1e3 * statistics.median(f[3] for f in per_frame[3:]),
                high_water=pipe.stats.input_ring_high_water,
                metrics_radii=sorted({p[2] for p in polls}))


def serving_phase(port, dev, card: str) -> dict:
    """Phase 9: the command line (9a), the pinned digests (9b) and the
    quality scaler live in the threaded pipeline (9c), on the card. Returns
    9a's results with 9b's and 9c's launches and 9c's TOO_SLOW copies."""
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        cli = cli_phase(port, dev, tmp)
    r = cli["results"]
    log(f"phase 9a CLI [{card}] {CLI_W}x{CLI_H} SDR 24->60 mode 2, {CLI_FRAMES} frames: "
        f"interpolate and serve "
        f"(python -m hopperrender_tpu_torch, two processes, {cli['cli_s']:.1f} s) gave "
        f"{cli['frames_out']} frames, Y4M ({cli['y4m_bytes']} bytes) equal to each other and to "
        f"the kernel and plain-version streams in this process; launches: interpolate "
        f"{r['interpolate']['launches']}, serve {r['serve']['launches']}, in process "
        f"{cli['launches']}; out fps (the CLI's stats, engine build included): interpolate "
        f"{r['interpolate']['stats']['out_fps']}, serve {r['serve']['stats']['out_fps']}; "
        f"native ring loaded")
    launches = digest_phase(port, dev)
    log(f"phase 9b pinned digests: {', '.join(port.digests.STREAMS)} equal to "
        f"tests/fixtures/digests.json on the card; launches {launches}")
    sc = scaler_phase(port, dev)
    slow = port.config.ActiveState.TOO_SLOW.name
    tripped = any(to == slow for _, _, to in sc["edges"])
    recovered = any(frm == slow for _, frm, _ in sc["edges"])
    log(f"phase 9c scaler live [{card}] {W}x{H} HDR 24->60 mode 2, PipelinedServer + "
        f"StatusServer, {SERVE_FRAMES} frames: radius per source frame {sc['radii']}; "
        f"ACTIVE/TOO_SLOW edges (frame, from, to) {sc['edges'] or 'none'}: TooSlow "
        f"{'tripped' if tripped else 'never tripped'}"
        + (f", {'recovered' if recovered else 'never recovered'}" if tripped else "")
        + f"; {sc['outputs']} "
        f"outputs ({sc['interpolated']} interpolated, {sc['copies']} TOO_SLOW copies checked, "
        f"{sc['launches']['copy_frame']} K6 launches for the copies, no plain copy on the card); "
        f"median flow {sc['flow_ms']:.3f} ms/source frame (CUDA events), median push_frame "
        f"{sc['push_ms']:.3f} ms on the engine thread (host clock, frames 3-); output "
        f"{sc['out_fps']:.2f} fps over {sc['wall']:.3f} s (engine build included), "
        f"{sc['steady_fps']:.2f} fps from the first output to the last; input ring high "
        f"water {sc['high_water']}; "
        f"{sc['polls']} polls, /healthz 200 throughout, /metrics radii {sc['metrics_radii']}; "
        f"launches {sc['launches']}; equal to the replay on a fresh AutoQualityScaler; "
        f"phase 9 took {time.perf_counter() - start:.1f} s")
    return dict(cli, digest_launches=launches, scaler_launches=sc["launches"],
                too_slow_copies=sc["copies"])


# Phase 10: the bench's runs in this process (10a), and the run as a user
# starts it (10c).
# Each run: its label -> (its metric's prefix, its arguments). The runs at
# --radius 16 and 5 go in turns: 16, 5, 5, 16.
R16, R5 = ("--config", "4k-hdr", "--radius", "16"), ("--config", "4k-hdr", "--radius", "5")
BENCH_RUNS = {"4k-hdr": ("4k-hdr", ("--config", "4k-hdr", "--json-only")),
              "4k-hdr_to120fps": ("4k-hdr_to120fps", ("--config", "4k-hdr", "--target-fps",
                                                      "120", "--radius", "16")),
              "4k-hdr r16 (1)": ("4k-hdr", R16), "4k-hdr r5 (1)": ("4k-hdr", R5),
              "4k-hdr r5 (2)": ("4k-hdr", R5), "4k-hdr r16 (2)": ("4k-hdr", R16)}
BENCH_USER_RUN = ("--config", "1080p-sdr", "--radius", "16", "--json-only")


def bench_result(port, lines: list[dict], metric: str, what: str) -> dict:
    """The bench's last line, checked: the metric, a radius bucket, a positive
    value and vs_baseline = budget / value (each rounded to 3 places)."""
    if not lines:
        raise AssertionError(f"{what}: no JSON line")
    last = lines[-1]
    if last.get("metric") != metric or last.get("partial"):
        raise AssertionError(f"{what}: last line {last}, wanted metric {metric}, not partial")
    value, budget = last["value"], 1e3 / 24.0
    if last["radius"] not in port.bench.BUCKETS or not value > 0:
        raise AssertionError(f"{what}: radius {last['radius']}, value {value}")
    tol = 5e-4 + budget * 5e-4 / value ** 2
    if abs(last["vs_baseline"] - budget / value) > tol:
        raise AssertionError(f"{what}: vs_baseline {last['vs_baseline']} != {budget} / {value}")
    return last


def bench_in_process(port, argv) -> tuple[int, list[dict]]:
    """bench.main(argv) with its stdout captured: (exit code, its JSON lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port.bench.main(list(argv))
    print(out.getvalue(), end="", file=sys.stderr)
    return rc, [json.loads(line) for line in out.getvalue().splitlines() if line.strip()]


def bench_units_on_the_card(port, dev) -> int:
    """10b: flow_unit, warp_unit (modes 0/1/2) and warp_batch_unit (t 0.2,
    0.6, 1.0; modes 0/1/2) on 4K HDR panning frames at radius 16, on a CPU
    engine and on the card: equal, exactly. The warps take the CPU engine's
    flow of the pair. Returns the number of units compared."""
    frames = [a for pair in panning_frames(port, H, W, 2, is_hdr=True) for a in pair]
    units, flow = [], None
    for where in (torch.device("cpu"), dev):
        eng = port.OpticalFlowEngine(H, W, is_hdr=True, device=where, black_level=16,
                                     white_level=235)
        eng.search_radius = 16
        src = [torch.tensor(a, device=where) for a in frames]
        if flow is None:
            flow = eng._run_pyramid(*src, num_layers=16)[0]
        fl = flow.to(where)
        flow_unit, warp_unit, _, warp_batch_unit = eng.bench_units()
        got = {"flow_unit": flow_unit(*src)}
        for mode in (0, 1, 2):
            got[f"warp_unit mode {mode}"] = warp_unit(*src, fl, 0.4, mode=mode)
            got[f"warp_batch_unit mode {mode}"] = warp_batch_unit(*src, fl, (0.2, 0.6, 1.0),
                                                                  mode=mode)
        units.append({k: int(v) for k, v in got.items()})
    if units[0] != units[1]:
        raise AssertionError(f"bench units: CPU {units[0]} != card {units[1]}")
    return len(units[0])


def bench_phase(port, dev, card: str, flow16_ms: float | None) -> dict:
    """Phase 10: the bench on the card. 10a: bench.main in this process for
    each of BENCH_RUNS, the counters set to 0 before each and read after, and
    K1-K4 must each have launched; 10b: the units on the card against
    a CPU engine; 10c: `python -m hopperrender_tpu_torch.bench` as a user runs
    it, on the default device. Prints each run's times at each radius beside
    phase 6's median flow; sets no rule on any time. Returns the launches."""
    start = time.perf_counter()
    launches, lines_by_run = {}, {}
    for name, (prefix, argv) in BENCH_RUNS.items():
        reset_launches(port)
        rc, lines = bench_in_process(port, argv)
        torch.cuda.synchronize()
        launches[name] = read_launches(port)
        if rc != 0:
            raise AssertionError(f"bench {name}: exit code {rc}: {lines[-1:]}")
        bench_result(port, lines, f"{prefix}_flow_plus_warp_per_source_frame", f"bench {name}")
        require_launched(launches[name], FLOW_KERNELS + ("warp_frames",), f"bench {name}")
        require_pyramid_path(launches[name], f"bench {name}")
        lines_by_run[name] = lines
    n_units = bench_units_on_the_card(port, dev)
    out = subprocess.run([sys.executable, "-m", "hopperrender_tpu_torch.bench",
                          *BENCH_USER_RUN], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    print(out.stderr, end="", file=sys.stderr)
    if out.returncode != 0:
        raise AssertionError(f"python -m hopperrender_tpu_torch.bench: exit code "
                             f"{out.returncode}: {out.stdout[-500:]}")
    user_lines = [json.loads(line) for line in out.stdout.splitlines() if line.strip()]
    bench_result(port, user_lines, "1080p-sdr_flow_plus_warp_per_source_frame", "10c")

    def fmt(lines):
        done = [ln["measured"] for ln in lines if "measured" in ln]
        last = lines[-1]
        return ("; ".join(f"r{m['radius']} flow {m['flow_ms']:.3f}, warp {m['warp_ms']:.3f}, "
                          f"per source {m['per_source_ms']:.3f}" for m in done)
                + f" -> {json.dumps(last)}")

    for name, lines in lines_by_run.items():
        log(f"phase 10a bench [{card}] {' '.join(BENCH_RUNS[name][1])}: {fmt(lines)}; "
            f"launches {launches[name]}")
    log(f"phase 10b bench units: {n_units} units (flow_unit r16, warp_unit and warp_batch_unit "
        f"modes 0/1/2) on 4K HDR panning frames equal on the card and the CPU")
    log(f"phase 10c bench [{card}] python -m hopperrender_tpu_torch.bench "
        f"{' '.join(BENCH_USER_RUN)}: {fmt(user_lines)}")
    log(f"phase 10 numbers [{card}]: phase 6's median flow at radius 16 (served, this run) "
        + ("not run" if flow16_ms is None else f"{flow16_ms:.3f} ms")
        + f"; ms are the bench's slope (CUDA events around eager chains); phase 10 took "
          f"{time.perf_counter() - start:.1f} s")
    return launches


def finish(port, kernels: list[dict], card: str, kind: str) -> int:
    """The last three lines: the kernels, nvidia-smi's card line, the result."""
    log(json.dumps({"kernels": kernels}))
    log(card)
    loaded = port.entry.foreign_modules()
    if loaded:
        raise AssertionError(f"the JAX package or jax was loaded: {sorted(loaded)[:5]}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parallel-only", action="store_true",
                        help="run phases 1, 2 and 7 only: the parallel path, e.g. on a host "
                             "with four cards, where 7c adds the NCCL meshes")
    parser.add_argument("--bench-only", action="store_true",
                        help="run phases 1, 2 and 10 only: the bench (hopperrender_tpu_torch/"
                             "bench.py) in this process and as a user runs it")
    parser.add_argument("--kernel-times", action="store_true",
                        help="run phases 1 and 2, then time the kernels only (phase 6's and "
                             "7a's kernel numbers, P3's and P4's of 8c, and the host split of a "
                             "wrapper call), whichever hopperrender_tpu_torch sits beside this "
                             "script: a copy of it in an older tree times that tree's kernels")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this needs a CUDA card",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "hopperrender_tpu_torch")):
        print(f"chip_smoke: no hopperrender_tpu_torch package beside {__file__}: run it "
              "from the repository root", file=sys.stderr)
        return 1
    port = import_port()
    _build, blur_kernel, warp_kernel = port._build, port.blur_kernel, port.warp_kernel
    config = port.config

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. device --------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log(f"phase 1 device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible); nvidia-smi: {card}")

    # -- 2. build ---------------------------------------------------------------
    lib = _build.load()
    ptxas = ptxas_table(lib.ptxas_log)
    print("\n".join(f"{name}: {v}" for name, v in ptxas.items()), file=sys.stderr)
    viz_regs = viz_ptxas(ptxas)
    log(f"phase 2 build: nvcc {lib.build_seconds:.2f} s, "
        f"{sum('registers' in v for v in ptxas.values())} kernel instantiations, library "
        f"{os.path.relpath(lib.path, ROOT)}; K2 modes 5 and 6 (ptxas): " + ", ".join(
            f"mode {m} at most {v['registers']} registers and {v['spill_bytes']} spill bytes "
            f"over its {v['instances']} instances"
            for m, v in viz_regs.items()))
    if args.parallel_only:
        band_entry, flow_launches = parallel_path(port, dev, card)
        return finish(port, [band_entry] + [
            {"name": k, "batched_launches": n, "mesh_launches": flow_launches["mesh"].get(k, 0)}
            for k, n in flow_launches["batched"].items()], card, kind)
    if args.bench_only:
        launches = bench_phase(port, dev, card, None)
        return finish(port, [{"name": name, "bench_launches": {run: n[name] for run, n in
                                                                launches.items()}}
                             for name in FLOW_KERNELS + ("warp_frames",)], card, kind)
    if args.kernel_times:
        inp = k2_inputs(port, dev)
        numbers = kernel_numbers(port, inp)
        numbers["warp_frames_band"] = band_numbers(port, inp.src, inp.flows, inp.t3, inp.black,
                                                   inp.white)
        numbers["probes"] = probe_numbers(port, dev)
        if port.hsv_kernel is not None:
            numbers["hsv_flow_overlay"] = hsv_numbers(port, inp)
            log(f"K5 times [{card}] of {ROOT}: {format_hsv(numbers['hsv_flow_overlay'])}")
        if 3 in getattr(warp_kernel, "KERNEL_MODES", ()):
            numbers["warp_frames_mode3"] = mode3_numbers(port, inp, variants=True)
            log(f"K2 mode 3 times [{card}] of {ROOT}: "
                f"{format_mode3(numbers['warp_frames_mode3'])}")
        if 6 in getattr(warp_kernel, "KERNEL_MODES", ()):
            numbers["warp_frames_viz"] = viz_numbers(port, inp)
            log(f"K2 modes 4-6 times [{card}] of {ROOT}: {format_viz(numbers['warp_frames_viz'])}")
        if port.copy_kernel is not None:
            numbers["copy_frame"] = copy_numbers(port, dev)
            log(f"K6 times [{card}] of {ROOT}: {format_copy(numbers['copy_frame'])}")
        numbers["wrapper_split_us"] = wrapper_split(port, dev)
        numbers["launch_anatomy_ms"] = floor_numbers(port, dev)
        if port.cost_volume_kernel is not None:
            l2 = l2_read_rate(port, dev)
            numbers["cost_volume"] = cost_volume_numbers(port, dev, l2["bytes_per_s"])
            log(f"K3/K4 times [{card}] of {ROOT} (4K HDR, one flow's calls in a CUDA graph, "
                f"the mean a call): {format_cost_volume(numbers['cost_volume'])}")
        log(f"kernel times [{card}] of {ROOT}: {format_numbers(numbers)}")
        log(f"probe times [{card}] of {ROOT} (graph-timed device ms of one call of each variant, "
            f"summed; host us per call, the mean over the variants): "
            f"{format_probe_numbers(numbers['probes'])}")
        for probe in ("chain", "chain2"):
            for b in PROBE_BLOCKS:
                port.probe_path.run_probe(probe, device=dev, blocks=b, echo=lambda line: log(
                    f"probe path {probe} B={b} [{card}] of {ROOT}: {line}"))
        log(f"wrapper split [{card}] of {ROOT} (host us per call of each stage alone): "
            f"{format_split(numbers['wrapper_split_us'])}")
        anatomy = numbers["launch_anatomy_ms"]
        log(f"launch anatomy [{card}] of {ROOT} (graph-timed device ms): " + (
            "not in this build" if anatomy is None else
            ", ".join(f"{k} {v:.5f}" for k, v in anatomy.items())))
        log(json.dumps(numbers))
        return 0

    # -- 3. K1 against its plain version ----------------------------------------
    inp = k2_inputs(port, dev)
    rng, offsets, src, flows = inp.rng, inp.offsets, inp.src, inp.flows
    black, white, t3 = inp.black, inp.white, inp.t3
    k1_err = 0
    minus3 = torch.full(LOW, -3, dtype=torch.int16, device=dev)
    odd = torch.tensor(rng.integers(-32768, 32768, (2, 33, 65)).astype(np.int16), device=dev)
    for x, what in ((offsets, "random +-500"), (minus3, "all -3"), (odd, "(2, 33, 65)")):
        k1_err = max(k1_err, require_equal(blur_kernel.blur_flow(x),
                                           blur_kernel.blur_flow_reference(x), f"K1 {what}"))
    torch.cuda.synchronize()
    log(f"phase 3 K1 blur_flow {LOW} int16: equal to the plain version (random +-500, "
        f"all -3; and (2, 33, 65), which its 16 x 32 tiles do not divide); max |err| {k1_err}")

    # -- 3b. K3 and K4 against their plain versions ------------------------------
    cost_volume_err = cost_volume_phase(port, dev)

    # -- 4. K2 against its plain version ----------------------------------------
    k2_err, n_checked = 0, 0
    for flow_name, flow in flows.items():
        for ts in ((0.4, 0.8), (0.2, 0.6, 1.0)):
            t = torch.tensor(ts, dtype=torch.float32, device=dev)
            for mode in (0, 1, 2):
                kw = dict(res_scalar=3, mode=mode, is_hdr=True)
                ky, kuv = warp_kernel.warp_frames(*src, flow, t, black, white, **kw)
                py, puv = warp_kernel.warp_frames_reference(*src, flow, t, black, white, **kw)
                what = f"K2 {flow_name} mode {mode} t {ts}"
                k2_err = max(k2_err, require_equal(ky, py, what + " Y"),
                             require_equal(kuv, puv, what + " UV"))
                n_checked += len(ts)
    torch.cuda.synchronize()
    log(f"phase 4 K2 warp_frames {W}x{H} P010, flow {', '.join(flows)}, modes 0/1/2, t "
        f"(0.4, 0.8) and (0.2, 0.6, 1.0): {n_checked} outputs equal to the plain version; "
        f"max |err| {k2_err}")

    # -- 4b. K2's raw_blend variant against its plain version ------------------
    raw_kw = dict(res_scalar=3, mode=2, is_hdr=True, raw_blend=True)
    raw_err = 0
    raw_before = warp_kernel.warp_frames.raw_launches
    for flow_name, flow in flows.items():
        ky, kuv = warp_kernel.warp_frames(*src, flow, t3, black, white, **raw_kw)
        py, puv = warp_kernel.warp_frames_reference(*src, flow, t3, black, white, **raw_kw)
        raw_err = max(raw_err, require_equal(ky, py, f"K2 raw_blend {flow_name} Y"),
                      require_equal(kuv, puv, f"K2 raw_blend {flow_name} UV"))
    flow = flows["random +-64"]
    ky = warp_kernel.warp_frames(*src, flow, t3, black, white, **raw_kw)[0]
    levelled = warp_kernel.warp_frames(*src, flow, t3, black, white, res_scalar=3, mode=2,
                                       is_hdr=True)[0]
    if max_abs_err(levelled, ky) == 0:
        raise AssertionError("K2 raw_blend equals the levelled mode 2")
    torch.cuda.synchronize()
    raw_launches_4b = warp_kernel.warp_frames.raw_launches - raw_before
    log(f"phase 4b K2 raw_blend {W}x{H} P010, flow {', '.join(flows)}, t (0.2, 0.6, 1.0): Y "
        f"and UV equal to the plain version; max |err| {raw_err}")

    # -- 4c. the HSV colour on the card against the CPU ------------------------
    from hopperrender_tpu_torch.ops.warp import _visualize_flow
    v = torch.arange(-512, 513, dtype=torch.int16)
    ox, oy = (a.reshape(-1) for a in torch.meshgrid(v, v, indexing="xy"))
    n_colour = 0
    for is_hdr in (False, True):
        curr = torch.tensor(rng.integers(0, 65536 if is_hdr else 256, ox.shape[0]),
                            dtype=torch.int32)
        for impact in (1, 4):
            for channel in (0, 1, 2):
                chan = torch.full(ox.shape, channel, dtype=torch.int32)
                cpu = _visualize_flow(ox, oy, curr, chan, impact, is_hdr)
                gpu = _visualize_flow(ox.to(dev), oy.to(dev), curr.to(dev), chan.to(dev),
                                      impact, is_hdr)
                require_equal(gpu.cpu(), cpu, f"HSV colour hdr {is_hdr} res_impact {impact} "
                                              f"channel {channel}")
                n_colour += cpu.numel()
    # K5 against its plain version: every pair at res_impact 4 and 1, SDR and
    # HDR; 4K HDR on K2's raw blend of each flow, T = 1 and 3; HSV_CASES.
    hk = port.hsv_kernel
    hsv_err, n_hsv = 0, 0
    hsv_before = hk.hsv_flow_overlay.launches
    for is_hdr in (False, True):
        for rs in HSV_PAIR_STRIPS:
            err, values = hsv_pair_parity(port, dev, is_hdr, rs)
            hsv_err, n_hsv = max(hsv_err, err), n_hsv + values
    for flow_name, fl in flows.items():
        for ts in (inp.t1, t3):
            raw = warp_kernel.warp_frames(*src, fl, ts, black, white, **raw_kw)
            got = hk.hsv_flow_overlay(*raw, fl, black, white, res_scalar=3, is_hdr=True)
            want = hk.hsv_flow_overlay_reference(*raw, fl, black, white, res_scalar=3,
                                                 is_hdr=True)
            what = f"K5 4K HDR {flow_name} T {len(ts)}"
            hsv_err = max(hsv_err, require_equal(got[0], want[0], what + " Y"),
                          require_equal(got[1], want[1], what + " UV"))
    del raw, got, want    # phase 5's peak memory counts the served stream's tensors only
    case_err, n_cases = hsv_case_parity(port, dev)
    hsv_err = max(hsv_err, case_err)
    torch.cuda.synchronize()
    hsv_launches_4c = hk.hsv_flow_overlay.launches - hsv_before
    log(f"phase 4c HSV colour: {n_colour} values (every (ox, oy) in +-512, SDR and HDR, "
        f"res_impact 1 and 4, channels 0/1/2) equal on the card and the CPU; K5 "
        f"hsv_flow_overlay equal to its plain version: {n_hsv} values over every (ox, oy) in "
        f"+-512 (SDR and HDR, res_impact 4 at rs 0 and 1 at rs 3, Y and both UV channels), "
        f"{W}x{H} HDR on K2's raw blend of {', '.join(flows)} flow at T = 1 and 3, and "
        f"{n_cases} more geometries (rs 1-3, ragged rows, row offsets, the int16 range, 1080p "
        f"SDR); max |err| {hsv_err}")

    # -- 5. served slice ----------------------------------------------------------
    settings = dict(target_fps=60.0, use_display_fps=False, frame_output=2, black_level=16,
                    white_level=235, auto_quality=False)
    frame_rng = np.random.default_rng(0)
    frames = []
    for i in range(10 + N_PROFILED):   # 10 served and checked, then the profiled ones
        y, uv = port.nv12.synthetic_frame(frame_rng, H, W, is_hdr=True, motion_x=3 * i)
        frames.append((y & P010_MASK, uv & P010_MASK))

    def new_server():
        return port.FrameServer(W, H, source_fps=24.0, is_hdr=True, device=dev,
                                settings=port.Settings(**settings))

    def serve(srv, frames, radius=config.MAX_SEARCH_RADIUS):
        """Frames through srv at this search radius: the outputs, and for each
        source frame that ran flow, push_frame's wall seconds (host clock) and
        the engine's flow time; warp and copy times per output."""
        outs, wall_s, flow_s, warp_s, copy_s = [], [], [], [], []
        for y, uv in frames:
            if srv.engine is not None:
                srv.engine.search_radius = radius
            start = time.perf_counter()
            got = srv.push_frame(y, uv)
            wall = time.perf_counter() - start
            eng = srv.engine
            if eng.frame_count >= 3:
                wall_s.append(wall)
                flow_s.append(eng.ofc_time.current)
            for o in got:
                (warp_s if o.interpolated else copy_s).append(eng.warp_time.current)
            outs.extend(got)
        return outs, wall_s, flow_s, warp_s, copy_s

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(port)
    srv = new_server()
    with plain_copies_on_the_card(port) as plain_copies:
        outs, wall_s, flow_s, warp_s, copy_s = serve(srv, frames[:10])
    torch.cuda.synchronize()
    launches = read_launches(port)
    peak_bytes = torch.cuda.max_memory_allocated(dev)

    expected = cadence_count(port, 10)
    n_interp = sum(o.interpolated for o in outs)
    if len(outs) != expected:
        raise AssertionError(f"served {len(outs)} outputs, the cadence gives {expected}")
    if n_interp == 0:
        raise AssertionError("no interpolated output")
    require_launched(launches, FLOW_KERNELS + ("warp_frames", "copy_frame"), "phase 5")
    require_pyramid_path(launches, "phase 5")
    require_copies_on_k6(launches, len(outs) - n_interp, plain_copies, "phase 5")
    for o in outs:
        if o.y.shape != (H, W) or o.uv.shape != (H // 2, W) or o.y.dtype != np.uint16:
            raise AssertionError(f"output shape/dtype {o.y.shape} {o.uv.shape} {o.y.dtype}")
    if srv.metrics().search_radius != config.MAX_SEARCH_RADIUS:
        raise AssertionError(f"search radius {srv.metrics().search_radius}, not 16")

    with plain_versions(port):
        plain_outs = serve(new_server(), frames[:10])[0]
    if read_launches(port) != launches:
        raise AssertionError("the plain-version stream launched a kernel")
    require_same_stream(outs, plain_outs, "mode 2")

    fixtures = [os.path.join(ROOT, "tests", "fixtures", f"golden_{n}.npz") for n in FIXTURES]
    missing = [p for p in fixtures if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(f"golden fixtures missing: {missing}")
    for path in fixtures:
        replay_fixture(path, dev)
    log(f"phase 5 served slice {W}x{H} HDR 24->60 mode 2 r16: {len(outs)} outputs "
        f"(cadence {expected}), {n_interp} interpolated, {len(outs) - n_interp} copies (one K6 "
        f"launch each, no plain copy on the card), launches {launches}, all equal to the "
        f"plain-version stream; golden {', '.join(os.path.basename(p) for p in fixtures)} "
        f"replayed byte for byte")

    # -- 5b / 5c. served visualisation modes --------------------------------------
    # The kernels each mode's path runs: the flow's and K2 in that mode, one
    # launch an interpolated output (modes 3-6 launch no mode-2 K2).
    path_kernels = {3: FLOW_KERNELS + ("warp_frames_mode3", "copy_frame"),
                    **{m: FLOW_KERNELS + ("warp_frames_viz", "copy_frame") for m in VIZ_MODES}}
    viz_warp_ms, viz_launches = {}, {}
    for mode, n_frames in ((3, 10), (4, 6), (5, 6), (6, 6)):
        viz_settings = port.Settings(**{**settings, "frame_output": mode})

        def viz_server(st=viz_settings):
            return port.FrameServer(W, H, source_fps=24.0, is_hdr=True, device=dev, settings=st)

        reset_launches(port)
        with plain_copies_on_the_card(port) as plain_copies:
            vouts, _, _, vwarp_s, _ = serve(viz_server(), frames[:n_frames])
        torch.cuda.synchronize()
        got = read_launches(port)
        viz_launches[mode] = got
        require_launched(got, path_kernels[mode], f"mode {mode}")
        require_copies_on_k6(got, sum(not o.interpolated for o in vouts), plain_copies,
                             f"mode {mode}")
        off_path = [k for k in MODE3_OFF_PATH + ("warp_frames",)
                    + (("warp_frames_mode3",) if mode != 3 else ("warp_frames_viz",)) if got[k]]
        if off_path:
            raise AssertionError(f"mode {mode} launched {off_path}, off the served path: {got}")
        expected = cadence_count(port, n_frames)
        n_interp = sum(o.interpolated for o in vouts)
        if len(vouts) != expected or not n_interp:
            raise AssertionError(f"mode {mode}: {len(vouts)} outputs (cadence {expected}), "
                                 f"{n_interp} interpolated")
        k2_calls = got["warp_frames_mode3" if mode == 3 else "warp_frames_viz"]
        if mode != 3 and k2_calls != n_interp:
            raise AssertionError(f"mode {mode}: {k2_calls} K2 launches for {n_interp} "
                                 "interpolated outputs, not one each")
        with plain_versions(port):
            plain_vouts = serve(viz_server(), frames[:n_frames])[0]
        if read_launches(port) != got:
            raise AssertionError(f"mode {mode}: the plain-version stream launched a kernel")
        require_same_stream(vouts, plain_vouts, f"mode {mode}")
        viz_warp_ms[mode] = 1e3 * statistics.median(vwarp_s)
        log(f"phase 5{'b' if mode == 3 else 'c'} served mode {mode} {W}x{H} HDR 24->60 r16: "
            f"{len(vouts)} outputs (cadence {expected}), "
            f"{sum(o.interpolated for o in vouts)} interpolated, launches {got}, all equal "
            f"to the plain-version stream")

    # -- 5d. mode 3 with the quality scaler on ------------------------------------
    # K2's mode-3 stream must never enter TOO_SLOW. Beside it: the same frames
    # through the chain that served mode 3 before (K2's raw_blend variant,
    # then K5), and through the chain with the plain overlay (mode 3's path
    # before K5).
    m3_frames = panning_frames(port, H, W, MODE3_SCALER_FRAMES, is_hdr=True)
    m3 = mode3_scaler_stream(port, dev, m3_frames)
    require_launched(m3["launches"], path_kernels[3], "5d")
    if any(m3["launches"][k] for k in MODE3_OFF_PATH):
        raise AssertionError(f"5d: K2's mode-3 stream launched the chain: {m3['launches']}")
    if "TOO_SLOW" in m3["states"] or m3["interpolated"] == 0:
        raise AssertionError(f"5d: mode 3 on K2 entered TOO_SLOW or interpolated nothing: "
                             f"edges {m3['edges']}, radii {m3['radii']}")
    with mode3_chain(port):
        m3_chain = mode3_scaler_stream(port, dev, m3_frames)
        with plain_overlay(port):
            m3_plain = mode3_scaler_stream(port, dev, m3_frames)
    require_launched(m3_chain["launches"], FLOW_KERNELS + MODE3_OFF_PATH, "5d chain")
    if m3_chain["launches"]["warp_frames_mode3"] or m3_plain["launches"]["warp_frames_mode3"] \
            or m3_plain["launches"]["hsv_flow_overlay"]:
        raise AssertionError(f"5d: the chain streams launched K2's mode 3 or the plain-overlay "
                             f"stream K5: {m3_chain['launches']}, {m3_plain['launches']}")
    del m3_frames
    for label, run in (("K2 mode 3", m3), ("K2 raw_blend + K5", m3_chain),
                       ("K2 raw_blend + plain overlay", m3_plain)):
        trip = next((k for k, st in enumerate(run["states"]) if st == "TOO_SLOW"), None)
        log(f"phase 5d served mode 3 {W}x{H} HDR 24->60, scaler on, {MODE3_SCALER_FRAMES} "
            f"panning frames, {label}: {run['outputs']} outputs, {run['interpolated']} "
            f"interpolated; TOO_SLOW {'never' if trip is None else f'from frame {trip}'}; "
            f"edges {run['edges']}; radius per frame {run['radii']}; engine compute ms per "
            f"source frame (flow + warps, CUDA events) "
            f"{', '.join(f'{t:.3f}' for t in run['compute_ms'])}; median after warm-up "
            f"{statistics.median(run['compute_ms'][3:]):.3f}; warp ms/output median "
            f"{statistics.median(run['warp_ms']):.3f}")

    # -- 6. numbers ------------------------------------------------------------------
    numbers = kernel_numbers(port, inp)
    hsv = hsv_numbers(port, inp)
    mode3 = mode3_numbers(port, inp)
    viz = viz_numbers(port, inp)
    copy = copy_numbers(port, dev)

    # The served stream goes on for N_PROFILED more frames under torch.profiler.
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        serve(srv, frames[10:])
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - start
    busy_s, n_events, kinds = device_profile(prof, prof_wall)
    if "K3's fill" in kinds:
        raise AssertionError(f"the served path launched K3's fill: {kinds}")
    per_frame = lambda v: v / N_PROFILED
    by_kind = ", ".join(f"{k} {per_frame(v):.3f}"
                        for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
    ms = lambda s: 1e3 * statistics.median(s)
    log(f"phase 6 numbers [{card}]: served wall {ms(wall_s):.3f} ms/source frame (median of "
        f"{len(wall_s)}, host clock around push_frame), flow {ms(flow_s):.3f} ms/source frame "
        f"(median of {len(flow_s)}, CUDA events), warp {ms(warp_s):.3f} ms/output (median of "
        f"{len(warp_s)}, batched), copy {ms(copy_s):.3f} ms (median of {len(copy_s)}); peak memory "
        f"{peak_bytes / 2**20:.1f} MiB (served stream, max_memory_allocated); profiled "
        f"{N_PROFILED} more frames: wall {1e3 * per_frame(prof_wall):.3f} ms/source frame "
        f"under the profiler, device busy {1e3 * per_frame(busy_s):.3f} ms/source frame, idle "
        f"{100 * (1 - busy_s / prof_wall):.1f}%, {per_frame(n_events):.0f} device "
        f"events/source frame; device ms/source frame by kind: {by_kind}")
    log(f"phase 6 kernels [{card}] (graph-timed device ms per call, {LOW} flow, {W}x{H} HDR "
        f"T = 3 unless marked, random +-64 flow unless marked): {format_numbers(numbers)}")
    log(f"phase 6 numbers [{card}]: warp ms/output (median, CUDA events, one warp per "
        f"output) " + ", ".join(f"mode {m} {t:.3f}" for m, t in viz_warp_ms.items())
        + f"; mode 3 in 5d, scaler on: K2 mode 3 {statistics.median(m3['warp_ms']):.3f}, K2 "
        f"raw_blend + K5 {statistics.median(m3_chain['warp_ms']):.3f}, K2 raw_blend + the plain "
        f"overlay {statistics.median(m3_plain['warp_ms']):.3f}")
    log(f"phase 6 K2 mode 3 [{card}] ({W}x{H} HDR, random +-64 flow unless marked, "
        f"graph-timed device ms per call): {format_mode3(mode3)}")
    log(f"phase 6 K5 [{card}] (hsv_flow_overlay on K2's raw blend, {W}x{H} HDR, random +-64 "
        f"flow unless marked, graph-timed device ms per call): {format_hsv(hsv)}")
    log(f"phase 6 K2 modes 4-6 [{card}] ({W}x{H} HDR, random +-64 flow unless marked, "
        f"graph-timed device ms per call unless marked): {format_viz(viz)}")
    log(f"phase 6 K6 copy_frame [{card}] (levels 16/235, {COPY_GRAPH_CALLS} calls over "
        f"{COPY_SOURCES} random source frames in one CUDA graph, device ms per call): "
        f"{format_copy(copy)}; the served copy (phase 5, the engine's CUDA events, host launch "
        f"included) {ms(copy_s):.3f} ms")
    # The flow at radius 16 and 5 in turns: phase 5's ten frames on one new
    # server, even frames at 16, odd frames at 5.
    alt, turns = new_server(), {16: [], 5: []}
    for i, frame in enumerate(frames[:10]):
        radius = (16, 5)[i % 2]
        turns[radius] += serve(alt, [frame], radius=radius)[2]
    l2 = l2_read_rate(port, dev)
    cost_volume = cost_volume_numbers(port, dev, l2["bytes_per_s"])
    flows = len(flow_s)
    log(f"phase 6 flow [{card}]: {ms(flow_s):.3f} ms/source frame at radius 16 (phase 5, "
        f"median of {flows}, CUDA events); in turns on one server: radius 16 "
        f"{ms(turns[16]):.3f}, radius 5 {ms(turns[5]):.3f} (medians of {len(turns[16])} and "
        f"{len(turns[5])}; each: {', '.join(f'{1e3 * t:.3f}' for t in turns[16])} / "
        f"{', '.join(f'{1e3 * t:.3f}' for t in turns[5])}); a source frame made "
        f"{launches['flow_step'] / flows:.1f} flow_step calls (K3 then K4) and "
        f"{launches['delta_sums'] / flows:.1f} standalone K3 and "
        f"{launches['commit_winners'] / flows:.1f} standalone K4 calls (phase 5)")
    log(f"phase 6 K3/K4 [{card}] (4K HDR panning frames, one flow's "
        f"{cost_volume[16]['calls_per_flow']} calls captured in a CUDA graph, the mean a "
        f"call; bound: the largest of HBM bytes "
        f"over {HBM_BYTES_PER_S / 1e12:.2f} TB/s, L2 bytes over this run's L2 read rate "
        f"{format_l2(l2)}, int32 operations over {INT32_OPS_PER_S / 1e12:.2f} TOP/s): "
        + format_cost_volume(cost_volume))

    # -- 4d. K2's mode 3 against its plain version --------------------------------
    # It runs after phase 6, so that phases 5 and 6 measure the served stream
    # in the process state they had before K2 took mode 3.
    mode3_err, n_mode3, mode3_launches_4d = mode3_parity(port, dev, inp)
    torch.cuda.synchronize()
    log(f"phase 4d K2 mode 3 (the HSV flow overlay in K2's epilogue, one launch): {n_mode3} "
        f"outputs equal to the plain version ({W}x{H} HDR on {', '.join(inp.flows)} flow at T "
        f"= 1 and 3, also equal to K2 raw_blend + K5; the row bands at n = "
        f"{', '.join(map(str, MODE3_BAND_SHARDS))}, each against its plain band and stacked "
        f"against the full frame; {len(MODE3_CASES)} more geometries (rs 1-3 at 50 x 86 with "
        f"bands of n = 3, t outside [0, 1], the int16 range, 1080p SDR at rs 2); every (ox, oy) "
        f"in +-512 as a flow cell at rs 0, SDR and HDR), {mode3_launches_4d} launches; max "
        f"|err| {mode3_err}")

    # -- 4e. K2's modes 4, 5 and 6 against their plain versions ------------------
    # After phase 6 too, as 4d: phases 5 and 6 keep their process state.
    viz_err, n_viz, viz_launches_4e = viz_parity(port, dev, inp)
    torch.cuda.synchronize()
    log(f"phase 4e K2 modes 4, 5 and 6 (one launch each): {n_viz} outputs equal to the plain "
        f"version and to the composition they replace (K2 mode 2 + warp_viz; mode 4 "
        f"grey_flow_frame) ({W}x{H} HDR on {', '.join(inp.flows)} flow at T = 1 and 3; the row "
        f"bands at n = {', '.join(map(str, VIZ_BAND_SHARDS))}, each against its plain band and "
        f"stacked against the full frame; {len(VIZ_CASES)} more geometries (rs 1-3 at 50 x 86 "
        f"with bands of n = 3, an odd half, t outside [0, 1], the int16 range; 1080p SDR at rs "
        f"2; rs 0 with flow cells to +-32767), {viz_launches_4e} launches; max |err| {viz_err}")

    # -- 4f. K6 against its plain version ---------------------------------------
    # After phase 6 too, as 4d: phases 5 and 6 keep their process state.
    copy_err, n_copy, copy_launches_4f = copy_parity(port, dev)
    torch.cuda.synchronize()
    log(f"phase 4f K6 copy_frame (both planes' levels, one launch): {n_copy} samples equal to "
        f"the plain version (every SDR and HDR sample value at levels "
        f"{', '.join(f'{b}/{w}' for b, w in COPY_LEVELS)}; random {W}x{H} HDR and SDR and 86x50 "
        f"at 16/235, 86x50 also one sample off 16 bytes), {copy_launches_4f} launches, each "
        f"into new planes; max |err| {copy_err}")

    # -- 7. the parallel path -----------------------------------------------------
    band_entry, parallel_flow_launches = parallel_path(port, dev, card)

    # -- 8. the probes ------------------------------------------------------------
    probe_entries = probe_phase(port, dev, card)

    # -- 9. the serving surface ----------------------------------------------------
    cli = serving_phase(port, dev, card)

    # -- 10. the bench ----------------------------------------------------------------
    bench_launches = bench_phase(port, dev, card, ms(flow_s))

    # Bounds from this run's inputs: K1 reads and writes one (2, 270, 480) int16
    # flow; K2 reads both source frames and the flow once and writes T outputs.
    k2_out = 3 * nbytes(src[0], src[1])
    k2_bytes = nbytes(*src, flow, t3) + k2_out
    k2_elems = 3 * (src[0].numel() + src[1].numel())
    bounds = {"blur_flow": bound("blur_flow", 2 * nbytes(offsets), offsets.numel()),
              "warp_frames": bound("warp_frames", k2_bytes, k2_elems),
              "warp_frames_raw_blend": bound("warp_frames_raw_blend", k2_bytes, k2_elems)}

    # library_ms is null: no single PyTorch call computes any of these functions
    # (grid_sample has neither the clamped remapping mirror nor C rounding;
    # avg_pool2d neither the symmetric mirror nor the truncating division).
    # ms is the graph-timed device time on random flow (K1: random +-500),
    # smooth_ms on the smooth flow.
    kernels = [
        {"name": "blur_flow", "route": "cuda",
         "source": "hopperrender_tpu_torch/csrc/blur_flow.cu",
         "replaces": "hopperrender_tpu/ops/pallas_kernels.py:63",
         "launches": launches["blur_flow"], "max_abs_err": k1_err},
        {"name": "warp_frames", "route": "cuda",
         "source": "hopperrender_tpu_torch/csrc/warp_frame.cu",
         "replaces": "hopperrender_tpu/ops/warp_band.py:695",
         "launches": launches["warp_frames"], "max_abs_err": k2_err},
        {"name": "warp_frames_raw_blend", "route": "cuda",
         "source": "hopperrender_tpu_torch/csrc/warp_frame.cu",
         "replaces": "hopperrender_tpu/ops/warp_band.py:695 (variant raw_blend)",
         "launches": viz_launches[3]["warp_frames_raw_blend"],
         "launches_path": "5b served mode 3 (off the served path since K2's mode 3)",
         "parity_launches": raw_launches_4b,
         "band_launches": parallel_flow_launches["band_raw"], "max_abs_err": raw_err},
    ]
    for k in kernels[:2]:   # K1 and K2 in the CLI's processes (9a) and the bench's runs (10a)
        k["cli_launches"] = {c: r["launches"][k["name"]] for c, r in cli["results"].items()}
        k["bench_launches"] = {run: n[k["name"]] for run, n in bench_launches.items()}
    for k in kernels:
        v = numbers[k["name"]]
        k["ms"], k["smooth_ms"], k["plain_ms"] = v["ms"], v["smooth_ms"], v["plain_ms"]
        k["bound_ms"], k["bound_by"] = bounds[k["name"]]
        k["library_ms"] = None
        k["host_us"] = v["host_us"]
    # K2's mode 3: ms, plain_ms, host_us and the bound at T = 1, the served
    # path's one output a call (t3: at T = 3), beside the chain it replaced
    # (chain_ms: K2's raw_blend variant then K5, graph-timed in turns on the
    # same inputs); `launches` those of the served mode-3 path (5b), beside
    # 5d's stream's, 4d's, 7a's bands' and 7c's ranks'; grid_ms an empty
    # launch of its one grid. library_ms is null: no single PyTorch call
    # computes the warp with its clamped mirror and C rounding, or this
    # colour.
    kernels.append({
        "name": "warp_frames_mode3", "route": "cuda",
        "source": "hopperrender_tpu_torch/csrc/warp_frame.cu",
        "replaces": "hopperrender_tpu/ops/warp_band.py:695 (variant raw_blend) and, with no "
                    "pallas_call, hopperrender_tpu/ops/warp_viz.py:54 (XLA): mode 3 as "
                    "hopperrender_tpu/ops/warp.py:223-236 computes it",
        "launches": viz_launches[3]["warp_frames_mode3"], "launches_path": "5b served mode 3",
        "max_abs_err": mode3_err, "ms": mode3["T1"]["ms"],
        "smooth_ms": mode3["T1"]["smooth_ms"], "plain_ms": mode3["T1"]["plain_ms"],
        "bound_ms": mode3["T1"]["bound_ms"], "bound_by": mode3["T1"]["bound_by"],
        "library_ms": None, "host_us": mode3["T1"]["host_us"],
        "grid_ms": mode3["T1"]["grid_ms"], "chain_ms": mode3["T1"]["chain_ms"],
        "vs_chain": mode3["T1"]["vs_chain"], "t3": mode3["T3"],
        "scaler_stream_launches": m3["launches"]["warp_frames_mode3"],
        "parity_launches": mode3_launches_4d,
        "batched_launches": parallel_flow_launches["batched_mode3"],
        "band_launches": parallel_flow_launches["band_mode3"],
        "mesh_launches": parallel_flow_launches["mesh_mode3"]})
    # K2's modes 4, 5 and 6: ms, plain_ms, host_us and the bound at T = 1, the
    # served path's one output a call (t3: at T = 3), beside the composition
    # each replaced (composition_ms, CUDA events, with the kernel's own
    # events_ms beside it); `launches` those of the served mode's path (5c),
    # beside 4e's (all three modes), 7b's and 7c's. library_ms is null: no
    # single PyTorch call computes the clamped mirror, C rounding and this
    # composition.
    replaces = {
        4: "no pallas_call: hopperrender_tpu/engine/flow_engine.py:622-664 and "
           "hopperrender_tpu/ops/warp_strip.py:318 grey_flow_frame (XLA): mode 4 as "
           "hopperrender_tpu/ops/warp.py:196-202 computes it",
        5: "no pallas_call: hopperrender_tpu/engine/flow_engine.py:622-664 and "
           "hopperrender_tpu/ops/warp_viz.py:100 side_by_side_1 (XLA) over "
           "hopperrender_tpu/ops/warp_band.py:695: mode 5 as hopperrender_tpu/ops/warp.py:158-161 "
           "computes it",
        6: "no pallas_call: hopperrender_tpu/engine/flow_engine.py:622-664 and "
           "hopperrender_tpu/ops/warp_viz.py:160 side_by_side_2 (XLA) over "
           "hopperrender_tpu/ops/warp_band.py:695: mode 6 as hopperrender_tpu/ops/warp.py:162-176 "
           "and :205-238 compute it"}
    for mode in VIZ_MODES:
        t1, t3 = viz[f"mode{mode} T1"], viz[f"mode{mode} T3"]
        kernels.append({
            "name": VIZ_NAMES[mode], "route": "cuda",
            "source": "hopperrender_tpu_torch/csrc/warp_frame.cu", "replaces": replaces[mode],
            "launches": viz_launches[mode]["warp_frames_viz"],
            "launches_path": f"5c served mode {mode}", "max_abs_err": viz_err,
            "ms": t1["ms"], "smooth_ms": t1["smooth_ms"], "plain_ms": t1["plain_ms"],
            "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"], "library_ms": None,
            "host_us": t1["host_us"], "grid_ms": t1["grid_ms"], "events_ms": t1["events_ms"],
            "composition_ms": t1["composition_ms"],
            "composition_host_us": t1["composition_host_us"], "t3": t3,
            "served_warp_ms_per_output": viz_warp_ms[mode],
            "parity_launches_4e_all_modes": viz_launches_4e,
            "batched_launches": parallel_flow_launches["batched_viz"][mode],
            "mesh_launches": parallel_flow_launches["mesh_viz"][str(mode)],
            **({"registers": viz_regs[mode]["registers"],
                "spill_bytes": viz_regs[mode]["spill_bytes"]} if mode != 4 else {})})
    # K5: ms, plain_ms, host_us and the bound at T = 1 (t3: at T = 3); off
    # the served path since K2's mode 3, so `launches` (the served mode-3
    # path's, 5b) are 0, beside 4c's (its parity) and 7a's raw_blend bands';
    # grid_ms an empty launch of its two grids. library_ms is null: no single
    # PyTorch call computes fdlibm's atan2 and this colour.
    kernels.append({
        "name": "hsv_flow_overlay", "route": "cuda",
        "source": "hopperrender_tpu_torch/csrc/hsv_overlay.cu",
        "replaces": "no pallas_call: hopperrender_tpu/ops/warp_viz.py:54 (XLA)",
        "launches": viz_launches[3]["hsv_flow_overlay"],
        "launches_path": "5b served mode 3 (off the served path since K2's mode 3)",
        "parity_launches": hsv_launches_4c, "max_abs_err": hsv_err, "ms": hsv["T1"]["ms"],
        "smooth_ms": hsv["T1"]["smooth_ms"],
        "plain_ms": hsv["T1"]["plain_ms"], "bound_ms": hsv["T1"]["bound_ms"],
        "bound_by": hsv["T1"]["bound_by"], "library_ms": None, "host_us": hsv["T1"]["host_us"],
        "grid_ms": hsv["T1"]["grid_ms"], "t3": hsv["T3"],
        "scaler_stream_launches": m3["launches"]["hsv_flow_overlay"],
        "chain_stream_launches": m3_chain["launches"]["hsv_flow_overlay"],
        "band_launches": parallel_flow_launches["band_hsv"]})
    # K6: ms, plain_ms, host_us, grid_ms and the bound at 4K HDR (sdr: at 4K
    # SDR), graph-timed over COPY_SOURCES source frames in turn; `launches`
    # those of the served slice (phase 5's warmup copies), beside 5b/5c's,
    # 9a's CLI processes', 9b's, 9c's (warmup and any TOO_SLOW copies) and
    # 4f's. library_ms is null: no single PyTorch call computes the levels
    # with their clip and truncation.
    served_copies = {f"mode {m}": n["copy_frame"] for m, n in viz_launches.items()}
    kernels.append({
        "name": "copy_frame", "route": "cuda", "source": "hopperrender_tpu_torch/csrc/copy_frame.cu",
        "replaces": "no pallas_call: hopperrender_tpu/ops/warp.py:258 copy_frame (XLA)",
        "launches": launches["copy_frame"], "launches_path": "phase 5 served slice (warmup)",
        "max_abs_err": copy_err, "ms": copy["4K HDR"]["ms"],
        "plain_ms": copy["4K HDR"]["plain_ms"], "bound_ms": copy["4K HDR"]["bound_ms"],
        "bound_by": copy["4K HDR"]["bound_by"], "library_ms": None,
        "host_us": copy["4K HDR"]["host_us"], "grid_ms": copy["4K HDR"]["grid_ms"],
        "vs_bound": copy["4K HDR"]["vs_bound"], "sdr": copy["4K SDR"],
        "served_copy_ms": ms(copy_s), "viz_launches": served_copies,
        "cli_launches": {c: r["launches"]["copy_frame"] for c, r in cli["results"].items()},
        "digest_launches": cli["digest_launches"]["copy_frame"],
        "scaler_launches": cli["scaler_launches"]["copy_frame"],
        "too_slow_copies": cli["too_slow_copies"], "parity_launches": copy_launches_4f})
    # flow_step (K3 then K4, the main path's one call a pyramid step), K3 and K4
    # (the mesh's standalone calls): ms, plain_ms, host_us and the bound are a
    # call's, the mean over one 4K HDR flow's 16 calls at radius 16 (r5: at
    # radius 5); flow_step's ms includes the reset of its state (one fill a
    # flow), its bound is K3's and K4's. delta_sums' ms includes its fill
    # launch; "variants" holds K3 alone (as flow_step launches it) and the
    # timing variants. `launches`: flow_step's on the main path (phase 5),
    # K3's and K4's on their path, the mesh (7c), where phase 5 launched
    # none. library_ms is null: no single PyTorch call computes either
    # function (a gathered, mirrored, windowed sum of absolute differences; a
    # first-minimum argmin over uint32 committed into int16 offsets).
    for name in ("flow_step", "delta_sums", "commit_winners"):
        v = cost_volume[16][name]
        on_mesh = name in MESH_FLOW_KERNELS
        kernels.append({
            "name": name, "route": "cuda", "source": "hopperrender_tpu_torch/csrc/cost_volume.cu",
            "replaces": "no pallas_call: hopperrender_tpu/ops/flow.py:63 / :178-201 (reference "
                        "calcDeltaSums / determineLowestLayer + adjustOffsetArray)",
            "launches": parallel_flow_launches["mesh"][name] if on_mesh else launches[name],
            "launches_path": "7c make_multichip_step" if on_mesh else "phase 5 served slice",
            "main_path_launches": launches[name],
            "launches_per_source_frame": launches[name] / flows,
            "max_abs_err": cost_volume_err, "ms": v["ms"], "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"], "library_ms": None,
            "host_us": v["host_us"], "r5": cost_volume[5][name],
            "variants": {r: cost_volume[r]["variants"] for r in (16, 5)} if name == "delta_sums"
            else None,
            "cli_launches": {c: r["launches"][name] for c, r in cli["results"].items()},
            "bench_launches": {run: n[name] for run, n in bench_launches.items()},
            "batched_launches": parallel_flow_launches["batched"][name],
            "mesh_launches": parallel_flow_launches["mesh"].get(name, 0)})
    return finish(port, kernels + [band_entry] + probe_entries, card, kind)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
