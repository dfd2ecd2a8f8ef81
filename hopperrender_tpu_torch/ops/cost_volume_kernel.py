"""K3 and K4: the cost volume of one pyramid step and the winners' commit —
wrappers of csrc/cost_volume.cu and their plain versions.

Neither replaces a pallas_call: the JAX package runs both in XLA
(hopperrender_tpu/ops/flow.py:63 delta_window_sums, :178-201 lowest_layer +
adjust_offsets). They are the reference's calcDeltaSums and
determineLowestLayer + adjustOffsetArray (ref: opticalFlowCalcSDR.cpp:67-116).

  * `flow_step` (K3 then K4): one step of the pyramid on a `PyramidState`,
    which one flow builds once (its checks, its offsets, its two sums
    buffers used in turn and the raw frame delta). One wrapper call a step,
    the path of ops/flow.pyramid_flow. Plain version `flow_step_reference`.
  * `delta_sums` (K3): the compact window sums of one step, (num_layers,
    n_win_y, n_win_x) uint32 held in an int32 tensor; global layers >= radius
    are 0xFFFFFFFF. Plain version `delta_sums_reference`. The mesh's layer
    shards (parallel/mesh.py) call it, and all-gather between K3 and K4.
  * `commit_winners` (K4): each window's first minimum over layers
    [0, min(radius, num_layers)), compared as uint32, committed to the
    offsets' plane step & 1. Plain version `commit_winners_reference`.

Each launches its CUDA kernels for CUDA tensors and takes its plain version
only for CPU tensors; any other device raises. Counters: `flow_step.launches`,
`delta_sums.launches` and `commit_winners.launches` (each wrapper's own
calls); with the port's tracer on, each flow_step call adds one to the
tracer's `flow.steps` (one K3 + K4 pair on the card, its plain version on
the CPU).

Integer semantics follow the reference exactly: int16 offsets wrap (sums in
int32 narrowed with .to(int16)); uint32 window sums wrap (the plain version
accumulates in int64, every term an add or a left shift, and keeps the low 32
bits); HDR samples compare as sample >> 8, shifted in int32 (uint16 has no
>>).
"""

from __future__ import annotations

import types

import torch

from hopperrender_tpu_torch import _build, config
from hopperrender_tpu_torch.ops.warp import to_int32
from hopperrender_tpu_torch.utils import trace

MAX_R = config.MAX_SEARCH_RADIUS
UINT32_MASK = 0xFFFFFFFF
MAX_SHIFT = 31   # the kernel's uint32 shifts; config keeps the scalars in [0, 10]
MAX_INDEX = 2 ** 31   # the kernels index planes with 32-bit ints


def _signed_square(rel: torch.Tensor) -> torch.Tensor:
    """rel * |rel| as int16 (ref: calcDeltaSumsKernelSDR.h:73-79)."""
    r = rel.to(torch.int32)
    return (r * r * torch.where(r > 0, 1, -1)).to(torch.int16)


def _mirror_in_frame(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """Single-branch mirror + clamp (ref: calcDeltaSumsKernelSDR.h:86-95)."""
    m = torch.where(pos >= dim, dim - (pos - dim + 1), torch.where(pos < 0, -pos - 1, pos))
    return m.clamp(0, dim - 1)


def _to_uint32_in_int32(sums: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) as the int32 of the same 32 bits."""
    return torch.where(sums > 0x7FFFFFFF, sums - (1 << 32), sums).to(torch.int32)


def candidate_reads(f1y, f1uv, offsets, radius: int, *, res_scalar: int, step: int,
                    num_layers: int = MAX_R, layer_offset: int = 0) -> types.SimpleNamespace:
    """The candidates of one pyramid step: offset_x, offset_y (num_layers,
    low_h, low_w) int16 (wrapped), in_frame (1, low_h, low_w) bool, and the
    flat element index of every sample read: frame 1's y, u, v
    (num_layers, low_h, low_w) into its Y and UV planes, frame 2's y2, u2, v2
    (low_h, low_w), int64."""
    dim_y, dim_x = f1y.shape
    uv_h, uv_w = f1uv.shape
    low_h, low_w = offsets.shape[1:]
    dev = offsets.device
    cx = torch.arange(low_w, dtype=torch.int32, device=dev)[None, None, :]
    cy = torch.arange(low_h, dtype=torch.int32, device=dev)[None, :, None]
    lz = torch.arange(layer_offset, layer_offset + num_layers, dtype=torch.int32,
                      device=dev)[:, None, None]
    scaled_cx = cx << res_scalar
    scaled_cy = cy << res_scalar

    rel_sq = _signed_square(lz % radius - radius // 2)
    zero = torch.zeros_like(rel_sq)
    rel_x, rel_y = (rel_sq, zero) if step % 2 == 0 else (zero, rel_sq)
    offsets_i = offsets.to(torch.int32)
    offset_x = (offsets_i[0][None] + rel_x).to(torch.int16)  # int16, wraps
    offset_y = (offsets_i[1][None] + rel_y).to(torch.int16)

    m_cx = _mirror_in_frame(scaled_cx + offset_x.to(torch.int32), dim_x).long()
    m_cy = _mirror_in_frame(scaled_cy + offset_y.to(torch.int32), dim_y).long()
    s_cx = scaled_cx.clamp(0, dim_x - 1)[0].long()
    s_cy = scaled_cy.clamp(0, dim_y - 1)[0].long()

    def uv_reads(yy, xx):
        row = (yy >> 1).clamp(0, uv_h - 1) * uv_w
        return row + (xx & ~1).clamp(0, uv_w - 1), row + ((xx & ~1) + 1).clamp(0, uv_w - 1)

    u, v = uv_reads(m_cy, m_cx)
    u2, v2 = uv_reads(s_cy, s_cx)
    return types.SimpleNamespace(
        offset_x=offset_x, offset_y=offset_y,
        in_frame=(scaled_cx < dim_x) & (scaled_cy < dim_y),
        y=m_cy * dim_x + m_cx, u=u, v=v, y2=s_cy * dim_x + s_cx, u2=u2, v2=v2)


def delta_sums_reference(
    f1y: torch.Tensor, f1uv: torch.Tensor, f2y: torch.Tensor, f2uv: torch.Tensor,
    offsets: torch.Tensor,   # (2, low_h, low_w) int16
    radius: int, delta_scalar: int, neighbor_scalar: int, *,
    window_size: int, res_scalar: int, iteration: int, step: int, is_hdr: bool,
    num_layers: int = MAX_R, layer_offset: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of K3 (ref: calcDeltaSumsKernelSDR.h:36-191):
    (num_layers, n_win_y, n_win_x) int32 holding uint32; global layers >=
    radius are 0xFFFFFFFF. num_layers/layer_offset shard the search-layer
    axis: a shard computes global layers [layer_offset, layer_offset +
    num_layers)."""
    low_h, low_w = offsets.shape[1:]
    c = candidate_reads(f1y, f1uv, offsets, radius, res_scalar=res_scalar, step=step,
                        num_layers=num_layers, layer_offset=layer_offset)
    shift = 8 if is_hdr else 0
    f1y_i, f2y_i, f1uv_i, f2uv_i = (to_int32(f).reshape(-1) >> shift
                                    for f in (f1y, f2y, f1uv, f2uv))
    # frame2 samples are layer-independent (the source pixel grid).
    delta = ((f1y_i[c.y] - f2y_i[c.y2][None]).abs()
             + (f1uv_i[c.u] - f2uv_i[c.u2][None]).abs()
             + (f1uv_i[c.v] - f2uv_i[c.v2][None]).abs()).to(torch.int64)
    delta = torch.where(c.in_frame, delta << delta_scalar, 0)

    active = c.offset_x if step == 0 else c.offset_y
    total = delta + active.to(torch.int64).abs()

    if iteration >= config.FIRST_NEIGHBOR_ITERATION:
        dev = offsets.device
        plane = offsets.to(torch.int32)[0 if step == 0 else 1]
        active_i = active.to(torch.int32)
        nb = torch.zeros((num_layers, low_h, low_w), dtype=torch.int64, device=dev)
        # down, right, left, up at +-2*windowSize, edge-clamped
        # (ref: calcDeltaSumsKernelSDR.h:112-131).
        for dx, dy in ((0, 2 * window_size), (2 * window_size, 0),
                       (-2 * window_size, 0), (0, -2 * window_size)):
            if dy:
                idx = (torch.arange(low_h, device=dev) + dy).clamp(0, low_h - 1)
                n_off = plane[idx, :][None]
            else:
                idx = (torch.arange(low_w, device=dev) + dx).clamp(0, low_w - 1)
                n_off = plane[:, idx][None]
            nb = nb + (n_off - active_i).abs()
        total = total + (nb << neighbor_scalar)

    n_win_y = -(-low_h // window_size)
    n_win_x = -(-low_w // window_size)
    padded = torch.nn.functional.pad(
        total, (0, n_win_x * window_size - low_w, 0, n_win_y * window_size - low_h))
    sums = padded.reshape(num_layers, n_win_y, window_size, n_win_x, window_size).sum(
        dim=(2, 4)) & UINT32_MASK
    # Layers at index >= radius are padding: masked so argmin never picks them.
    lz = torch.arange(layer_offset, layer_offset + num_layers, device=sums.device)
    return _to_uint32_in_int32(torch.where(lz[:, None, None] < radius, sums, UINT32_MASK))


def delta_sums(
    f1y: torch.Tensor, f1uv: torch.Tensor, f2y: torch.Tensor, f2uv: torch.Tensor,
    offsets: torch.Tensor, radius: int, delta_scalar: int, neighbor_scalar: int, *,
    window_size: int, res_scalar: int, iteration: int, step: int, is_hdr: bool,
    num_layers: int = MAX_R, layer_offset: int = 0,
) -> torch.Tensor:
    """K3 wrapper: equal to delta_sums_reference. Launches the CUDA kernels on
    CUDA tensors (on the current stream, no synchronisation): the sums
    buffer is filled, then summed; a CPU tensor takes the plain version."""
    if offsets.dtype != torch.int16 or offsets.dim() != 3 or offsets.shape[0] != 2:
        raise ValueError(f"delta_sums takes (2, low_h, low_w) int16 offsets, got "
                         f"{tuple(offsets.shape)} {offsets.dtype}")
    low_h, low_w = offsets.shape[1:]
    if step not in (0, 1):
        raise ValueError(f"step must be 0 or 1, got {step}")
    kw = dict(window_size=window_size, res_scalar=res_scalar, iteration=iteration, step=step,
              is_hdr=is_hdr, num_layers=num_layers, layer_offset=layer_offset)
    planes = (f1y, f1uv, f2y, f2uv)
    if all(t.device.type == "cpu" for t in (*planes, offsets)):
        return delta_sums_reference(*planes, offsets, radius, delta_scalar, neighbor_scalar,
                                    **kw)
    _check_cuda("delta_sums", *planes, offsets)
    dim_y, dim_x, uv_h, uv_w = _plane_dims("delta_sums", planes, is_hdr, (offsets,))
    if layer_offset < 0:
        raise ValueError(f"delta_sums: layer_offset {layer_offset} below range")
    _check_scalars("delta_sums", radius, delta_scalar, neighbor_scalar, num_layers,
                   (window_size,))
    n_win_y, n_win_x = -(-low_h // window_size), -(-low_w // window_size)
    sums = offsets.new_empty((num_layers, n_win_y, n_win_x), dtype=torch.int32)
    neighbors = iteration >= config.FIRST_NEIGHBOR_ITERATION
    _build.launch("hrt_delta_sums", offsets.get_device(), f1y.data_ptr(), f1uv.data_ptr(),
                  f2y.data_ptr(), f2uv.data_ptr(), offsets.data_ptr(), sums.data_ptr(),
                  dim_y, dim_x, uv_h, uv_w, low_h, low_w, n_win_y, n_win_x, radius,
                  delta_scalar, neighbor_scalar, window_size, res_scalar, int(neighbors), step,
                  layer_offset, num_layers, int(is_hdr))
    delta_sums.launches += 1
    return sums


delta_sums.launches = 0


def lowest_layer_u32(sums: torch.Tensor, radius: int) -> torch.Tensor:
    """Per-window first minimum over layers [0, min(radius, num_layers)) of
    int32-held uint32 sums, compared unsigned (ref:
    determineLowestLayerKernelSDR.h:16-27): (n_win_y, n_win_x) int32."""
    scan = sums[:min(radius, sums.shape[0])].to(torch.int64) & UINT32_MASK
    return torch.argmin(scan, dim=0).to(torch.int32)


def adjust_reference(offsets: torch.Tensor, winners: torch.Tensor, radius: int, *,
                     window_size: int, step: int) -> torch.Tensor:
    """Commit each window's winning candidate; returns new offsets
    (ref: adjustOffsetArrayKernelSDR.h:11-20)."""
    low_h, low_w = offsets.shape[1:]
    adj = _signed_square(winners % radius - radius // 2)
    adj_full = adj.repeat_interleave(window_size, 0).repeat_interleave(window_size, 1)
    adj_full = adj_full[:low_h, :low_w]
    plane = step & 1
    out = offsets.clone()
    out[plane] = (offsets[plane].to(torch.int32) + adj_full.to(torch.int32)).to(torch.int16)
    return out


def commit_winners_reference(offsets: torch.Tensor, sums: torch.Tensor, radius: int, *,
                             window_size: int, step: int,
                             out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K4: lowest_layer_u32 then adjust_reference.
    Returns new offsets, or writes them into `out` (which may be `offsets`)
    and returns it."""
    new = adjust_reference(offsets, lowest_layer_u32(sums, radius), radius,
                           window_size=window_size, step=step)
    return new if out is None else out.copy_(new)


def commit_winners(offsets: torch.Tensor, sums: torch.Tensor, radius: int, *,
                   window_size: int, step: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """K4 wrapper: equal to commit_winners_reference. offsets (2, low_h,
    low_w) int16; sums (num_layers, n_win_y, n_win_x) int32 holding uint32
    (K3's). Returns new offsets, or writes into `out` (out=offsets updates
    the caller's buffer in place: only plane step & 1 is written). Launches
    the CUDA kernel on CUDA tensors; a CPU tensor takes the plain version."""
    if offsets.dtype != torch.int16 or offsets.dim() != 3 or offsets.shape[0] != 2:
        raise ValueError(f"commit_winners takes (2, low_h, low_w) int16 offsets, got "
                         f"{tuple(offsets.shape)} {offsets.dtype}")
    low_h, low_w = offsets.shape[1:]
    n_win_y, n_win_x = -(-low_h // window_size), -(-low_w // window_size)
    if sums.dtype != torch.int32 or sums.dim() != 3 or tuple(sums.shape[1:]) != (n_win_y,
                                                                                  n_win_x):
        raise ValueError(f"commit_winners: sums {tuple(sums.shape)} {sums.dtype}, expected "
                         f"(layers, {n_win_y}, {n_win_x}) int32")
    if out is not None and (out.shape != offsets.shape or out.dtype != offsets.dtype):
        raise ValueError("commit_winners: out must match offsets")
    if step not in (0, 1) or radius < 1:
        raise ValueError(f"commit_winners: step {step}, radius {radius}")
    tensors = (offsets, sums) if out is None else (offsets, sums, out)
    if all(t.device.type == "cpu" for t in tensors):
        return commit_winners_reference(offsets, sums, radius, window_size=window_size,
                                        step=step, out=out)
    _check_cuda("commit_winners", *tensors)
    if window_size < 1 or window_size & (window_size - 1):
        raise ValueError(f"commit_winners: window_size {window_size} is not a power of two")
    if out is None:
        out = torch.empty_like(offsets)
    elif not out.is_contiguous():
        raise ValueError("commit_winners: out must be contiguous")
    _build.launch("hrt_commit_winners", offsets.get_device(), offsets.data_ptr(),
                  out.data_ptr(), sums.data_ptr(), low_h, low_w, n_win_y, n_win_x,
                  sums.shape[0], radius, window_size, step)
    commit_winners.launches += 1
    return out


commit_winners.launches = 0


class PyramidState:
    """One flow's pyramid on one device: the frames and scalars, the steps
    ((iteration, window, step) of each schedule entry, both steps each), the
    offsets (2, low_h, low_w) int16 and the raw frame delta (0-dim int64,
    uint32 value, written at iteration 0 step 0), both zeroed. Built once a
    flow: on CUDA tensors it checks what the kernels take (as delta_sums
    does), allocates one workspace (the delta, the offsets and two sums
    buffers used in turn, each for the finest window), zeroes the delta, the
    offsets and the first step's sums with one fill, and prepares every
    step's launch arguments, so that flow_step does no check. Belongs to one
    flow on one stream: never share it between two streams."""

    def __init__(self, f1y, f1uv, f2y, f2uv, radius: int, delta_scalar: int,
                 neighbor_scalar: int, *, low_h: int, low_w: int, res_scalar: int,
                 is_hdr: bool, num_layers: int, schedule):
        self.frames = (f1y, f1uv, f2y, f2uv)
        self.radius, self.delta_scalar, self.neighbor_scalar = (radius, delta_scalar,
                                                                neighbor_scalar)
        self.res_scalar, self.is_hdr, self.num_layers = res_scalar, is_hdr, num_layers
        self.steps = [(it, window, step) for it, window in schedule for step in (0, 1)]
        self.device = f1y.device
        if all(t.device.type == "cpu" for t in self.frames):
            self.offsets = torch.zeros((2, low_h, low_w), dtype=torch.int16)
            self.delta = torch.zeros((), dtype=torch.int64)
            return
        _check_cuda("flow_step", *self.frames)
        dims = _plane_dims("flow_step", self.frames, is_hdr)
        if not 0 < radius <= num_layers:
            raise ValueError(f"flow_step: radius {radius} outside (0, num_layers={num_layers}]")
        _check_scalars("flow_step", radius, delta_scalar, neighbor_scalar, num_layers,
                       [w for _, w, _ in self.steps])
        if 2 * low_h * low_w >= MAX_INDEX:
            raise ValueError(f"flow_step: a ({low_h}, {low_w}) flow grid exceeds 2**31 offsets")
        n_win = [-(-low_h // w) * -(-low_w // w) for _, w, _ in self.steps]
        buf = -(-num_layers * max(n_win, default=0) // 4) * 4       # words, 16-byte multiples
        off_bytes = -(-4 * low_h * low_w // 16) * 16
        first = 4 * radius * n_win[0] if n_win else 0
        ws = torch.empty(16 + off_bytes + 8 * buf, dtype=torch.uint8, device=self.device)
        self.delta = ws[:8].view(torch.int64)[0]
        self.offsets = ws[16:16 + 4 * low_h * low_w].view(torch.int16).view(2, low_h, low_w)
        self.sums = (ws[16 + off_bytes:16 + off_bytes + 4 * buf].view(torch.int32),
                     ws[16 + off_bytes + 4 * buf:].view(torch.int32))
        self._zeroed = ws[:16 + off_bytes + first]
        self.reset()
        self.device_index = self.device.index
        ptrs = [t.data_ptr() for t in self.frames]
        self.args = []
        for k, (iteration, window, step) in enumerate(self.steps):
            nxt = self.steps[k + 1][1] if k + 1 < len(self.steps) else 0
            self.args.append((
                *ptrs, self.offsets.data_ptr(), self.sums[k % 2].data_ptr(),
                self.sums[(k + 1) % 2].data_ptr(),
                self.delta.data_ptr() if (iteration, step) == (0, 0) else None, *dims,
                low_h, low_w, radius, delta_scalar, neighbor_scalar, window, nxt, res_scalar,
                int(iteration >= config.FIRST_NEIGHBOR_ITERATION), step, num_layers,
                int(is_hdr)))

    def reset(self) -> None:
        """Zero the offsets, the delta and (on the card) the first step's
        sums, with one fill: the state starts its flow again."""
        if self.device.type == "cpu":
            self.offsets.zero_()
            self.delta.zero_()
        else:
            self._zeroed.zero_()

    def step_sums(self, k: int) -> torch.Tensor:
        """K3's sums of step k on the card, (radius, n_win_y, n_win_x) int32
        holding uint32: valid after flow_step(self, k) until step k + 1 runs."""
        _, window, _ = self.steps[k]
        low_h, low_w = self.offsets.shape[1:]
        n_win_y, n_win_x = -(-low_h // window), -(-low_w // window)
        return self.sums[k % 2][:self.radius * n_win_y * n_win_x].view(self.radius, n_win_y,
                                                                        n_win_x)


def flow_step_reference(state: PyramidState, k: int) -> None:
    """Plain PyTorch version of flow_step: delta_sums_reference, the raw frame
    delta at iteration 0 step 0 (window (0, 0) of layer radius // 2 - 1,
    ref: opticalFlowCalcSDR.cpp:91), then commit_winners_reference into
    state.offsets in place. Any device."""
    iteration, window, step = state.steps[k]
    sums = delta_sums_reference(
        *state.frames, state.offsets, state.radius, state.delta_scalar, state.neighbor_scalar,
        window_size=window, res_scalar=state.res_scalar, iteration=iteration, step=step,
        is_hdr=state.is_hdr, num_layers=state.num_layers)
    if (iteration, step) == (0, 0):
        state.delta.copy_(sums[state.radius // 2 - 1, 0, 0].to(torch.int64) & UINT32_MASK)
    commit_winners_reference(state.offsets, sums, state.radius, window_size=window, step=step,
                             out=state.offsets)


def flow_step(state: PyramidState, k: int) -> None:
    """Step k of state's pyramid, equal to flow_step_reference: on the card
    one launch of K3 (the step's sums, no fill) and one of K4 (the commit
    into state.offsets in place, the next step's sums cleared, the raw
    delta at iteration 0 step 0), in stream order; CPU tensors take the
    plain version. The checks were done when the state was built."""
    trace.count(trace.FLOW_STEPS)
    if state.device.type == "cpu":
        flow_step_reference(state, k)
        return
    _build.launch("hrt_flow_step", state.device_index, *state.args[k])
    flow_step.launches += 1


flow_step.launches = 0


def _plane_dims(name: str, planes, is_hdr: bool, others=()) -> tuple[int, int, int, int]:
    """(dim_y, dim_x, uv_h, uv_w) of CUDA planes that the kernels take: the
    bit depth's dtype, both frames of one shape, a UV row of an even width
    at least the Y row's (U and V load as one pair), UV planes aligned to a
    pair, and planes (and `others`) below 2**31 elements."""
    dtype = torch.uint16 if is_hdr else torch.uint8
    if any(p.dtype != dtype for p in planes):
        raise ValueError(f"{name}: planes must be {dtype} (is_hdr={is_hdr})")
    f1y, f1uv, f2y, f2uv = planes
    if f2y.shape != f1y.shape or f2uv.shape != f1uv.shape:
        raise ValueError(f"{name}: the two frames' planes differ in shape")
    (dim_y, dim_x), (uv_h, uv_w) = f1y.shape, f1uv.shape
    if uv_w % 2 or uv_w < dim_x:
        raise ValueError(f"{name}: a UV row of width {uv_w} is odd or narrower than the Y "
                         f"row ({dim_x}): U and V load as one pair")
    pair = 2 * f1uv.element_size()
    if f1uv.data_ptr() % pair or f2uv.data_ptr() % pair:
        raise ValueError(f"{name}: a UV plane is not aligned to a {pair}-byte (U, V) pair")
    if max(p.numel() for p in (*planes, *others)) >= MAX_INDEX:
        raise ValueError(f"{name}: a plane exceeds 2**31 elements")
    return dim_y, dim_x, uv_h, uv_w


def _check_scalars(name: str, radius: int, delta_scalar: int, neighbor_scalar: int,
                   num_layers: int, windows) -> None:
    if not 1 <= num_layers <= MAX_R or radius < 1:
        raise ValueError(f"{name}: num_layers {num_layers} outside [1, {MAX_R}] or radius "
                         f"{radius} below 1")
    bad = [w for w in windows if w < 1 or w & (w - 1)]
    if bad:
        raise ValueError(f"{name}: window_size {bad[0]} is not a power of two")
    if not (0 <= delta_scalar <= MAX_SHIFT and 0 <= neighbor_scalar <= MAX_SHIFT):
        raise ValueError(f"{name}: scalars {delta_scalar}, {neighbor_scalar} outside "
                         f"[0, {MAX_SHIFT}]")


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor contiguous and on one CUDA device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors must be on one device, got {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
