"""K3 (the cost volume's window sums) and K4 (the argmin and its commit) of
the PyTorch port, through their wrappers in hopperrender_tpu_torch/ops/
cost_volume_kernel.py, against hopperrender_tpu.ops.flow on the CPU,
exactly: the wrappers take their plain versions for CPU tensors. Also the
wrappers' dispatch: CPU tensors launch nothing, and a device that is neither
the CPU nor CUDA raises. The kernels themselves are held to these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py phase 3b)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hopperrender_tpu.ops import flow as jax_flow
from hopperrender_tpu_torch.ops import cost_volume_kernel as cv
from hopperrender_tpu_torch.ops import flow as torch_flow

from conftest import make_frame
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

H, W = 64, 96
U32 = 0xFFFFFFFF


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _offsets(rng, kind, low_h, low_w):
    if kind == "wrap":   # near the int16 limits: the candidate's offset wraps
        values = np.array([-32768, -32767, -32760, 32760, 32766, 32767])
        return rng.choice(values, (2, low_h, low_w)).astype(np.int16)
    return rng.integers(-20, 21, (2, low_h, low_w)).astype(np.int16)


# (is_hdr, rs, radius, iteration, step, window, scalars, offsets, num_layers,
# layer_offset): SDR and HDR, rs 0-1, radius 5/8/9/10/12/16, both steps, the
# neighbour term off (iteration < 4) and on, windows 64 to 2 (and 6, which
# only the plain version takes), scalars at 10 so that the uint32 sums wrap,
# offsets that wrap int16, and layer shards whose layers past the radius are
# 0xFFFFFFFF (the last: every layer of the shard).
K3_CASES = [
    (False, 0, 5, 0, 0, 64, (8, 6), "random", 5, 0),
    (True, 1, 8, 1, 1, 16, (8, 6), "random", 8, 0),
    (False, 1, 12, 4, 0, 4, (8, 6), "random", 12, 0),
    (True, 0, 16, 5, 1, 2, (8, 6), "random", 16, 0),
    (True, 1, 16, 4, 0, 8, (10, 10), "wrap", 16, 0),
    (False, 0, 16, 6, 1, 6, (10, 10), "wrap", 16, 0),
    (False, 0, 9, 4, 1, 8, (8, 6), "random", 4, 8),
    (True, 1, 10, 0, 0, 32, (8, 6), "random", 4, 12),
]


@pytest.mark.parametrize("case", K3_CASES, ids=lambda c: "-".join(map(str, c)))
def test_delta_sums_plain_matches_jax(rng, case):
    is_hdr, rs, radius, iteration, step, window, (ds, ns), kind, num_layers, layer_offset = case
    frames = make_frame(rng, H, W, is_hdr) + make_frame(rng, H, W, is_hdr)
    low_h, low_w = H >> rs, W >> rs
    offsets = _offsets(rng, kind, low_h, low_w)
    kw = dict(window_size=window, res_scalar=rs, iteration=iteration, step=step,
              is_hdr=is_hdr, num_layers=num_layers)
    want = np.asarray(jax_flow.delta_window_sums(
        *map(jnp.asarray, frames), jnp.asarray(offsets), jnp.int32(radius), jnp.int32(ds),
        jnp.int32(ns), jnp.int32(layer_offset), **kw))
    got = cv.delta_sums(*map(_t, frames), _t(offsets), radius, ds, ns,
                        layer_offset=layer_offset, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    past = np.arange(layer_offset, layer_offset + num_layers) >= radius
    assert (want[past] == U32).all()
    if not past.all():
        assert (want[~past] != U32).any()
    if kind == "wrap":   # the sums passed 2**32 before they were cut
        full = torch_flow.delta_window_sums(*map(_t, frames), _t(offsets), radius, ds, ns,
                                            layer_offset=layer_offset, **kw)
        np.testing.assert_array_equal(full.numpy(), want.astype(np.int64))


def _sums(rng, radius, n_win_y, n_win_x):
    """(16, n_win_y, n_win_x) uint32 window sums with layers >= radius at
    0xFFFFFFFF, values across the whole uint32 range (half of them read
    negative as int32), and windows whose winner is the first layer, the
    last real layer, a tie (first of two, and all layers equal) and a
    minimum at or above 2**31."""
    s = rng.integers(0, 2 ** 32, (16, n_win_y, n_win_x), dtype=np.uint64)
    s[:, 0, 0] = 2 ** 31 + 5
    s[0, 0, 0] = 2 ** 31 + 1                 # first layer
    s[:, 0, 1] = 7
    s[radius - 1, 0, 1] = 3                  # last real layer
    s[:, 1, 0] = U32 - 1
    s[2, 1, 0] = s[radius - 1, 1, 0] = 40    # a tie: the first of the two
    s[:, 1, 1] = 12345                       # every layer equal: layer 0
    s[:, 2, 2] = U32
    s[1, 2, 2] = 2 ** 31                     # unsigned: 2**31 is below U32
    s[radius:] = U32
    return s.astype(np.uint32)


@pytest.mark.parametrize("radius", [5, 8, 12, 16])
def test_commit_winners_plain_matches_jax(rng, radius):
    low_h, low_w, window = 20, 36, 8
    n_win_y, n_win_x = 3, 5
    sums = _sums(rng, radius, n_win_y, n_win_x)
    offsets = _offsets(rng, "wrap", low_h, low_w)
    winners = np.asarray(jax_flow.lowest_layer(jnp.asarray(sums)))
    assert (winners[0, 0], winners[0, 1], winners[1, 0], winners[1, 1], winners[2, 2]) == \
        (0, radius - 1, min(2, radius - 1), 0, 1)
    bucket = next(b for b in (5, 8, 12, 16) if radius <= b)
    for step in (0, 1):
        want = np.asarray(jax_flow.adjust_offsets(jnp.asarray(offsets), jnp.asarray(winners),
                                                  jnp.int32(radius), window_size=window,
                                                  step=step))
        for layers in (16, bucket):   # the full volume and the engine's bucket
            s = _t(sums[:layers].view(np.int32))
            off = torch.tensor(offsets)   # a copy: `out=off` writes into it
            got = cv.commit_winners(off, s, radius, window_size=window, step=step)
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(off.numpy(), offsets)   # not mutated
            same = cv.commit_winners(off, s, radius, window_size=window, step=step, out=off)
            assert same is off
            np.testing.assert_array_equal(off.numpy(), want)       # in place
    # |adjustment| <= 8 * 8 unless the int16 sum wrapped: some cell did.
    assert (np.abs(want.astype(np.int32) - offsets.astype(np.int32)) > 64).any()


def test_wrappers_on_the_cpu_launch_nothing(rng):
    """CPU tensors take the plain versions: neither counter moves, through the
    wrappers and through the whole pyramid."""
    before = cv.delta_sums.launches, cv.commit_winners.launches
    frames = [_t(a) for a in make_frame(rng, 32, 48) + make_frame(rng, 32, 48)]
    offsets = torch.zeros((2, 32, 48), dtype=torch.int16)
    sums = cv.delta_sums(*frames, offsets, 8, 8, 6, window_size=16, res_scalar=0,
                         iteration=0, step=0, is_hdr=False, num_layers=8)
    cv.commit_winners(offsets, sums, 8, window_size=16, step=0)
    torch_flow.pyramid_flow(*frames, 8, 8, 6, low_h=32, low_w=48, res_scalar=0,
                            is_hdr=False, num_layers=8)
    assert (cv.delta_sums.launches, cv.commit_winners.launches) == before


def test_wrappers_refuse_other_devices():
    """A meta tensor (neither the CPU nor CUDA) raises before any launch, and
    so do tensors on two devices."""
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    y, uv = meta((32, 48), torch.uint8), meta((16, 48), torch.uint8)
    offsets = meta((2, 32, 48), torch.int16)
    kw = dict(window_size=16, res_scalar=0, iteration=0, step=0, is_hdr=False)
    before = cv.delta_sums.launches, cv.commit_winners.launches
    with pytest.raises(ValueError, match="unsupported device"):
        cv.delta_sums(y, uv, y, uv, offsets, 8, 8, 6, **kw)
    sums = meta((16, 2, 3), torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        cv.commit_winners(offsets, sums, 8, window_size=16, step=0)
    with pytest.raises(ValueError, match="one device"):
        cv.commit_winners(torch.zeros((2, 32, 48), dtype=torch.int16), sums, 8,
                          window_size=16, step=0)
    with pytest.raises(ValueError, match="one device"):
        cv.delta_sums(torch.zeros((32, 48), dtype=torch.uint8), uv, y, uv, offsets, 8, 8, 6,
                      **kw)
    assert (cv.delta_sums.launches, cv.commit_winners.launches) == before


def _flow_state(frames, radius, ds, ns, *, low_h, low_w, rs, is_hdr, num_layers, schedule):
    return cv.PyramidState(*map(_t, frames), radius, ds, ns, low_h=low_h, low_w=low_w,
                           res_scalar=rs, is_hdr=is_hdr, num_layers=num_layers,
                           schedule=schedule)


@pytest.mark.parametrize("case", K3_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flow_step_plain_matches_jax(rng, case):
    """flow_step_reference (K3's sums, the raw delta at iteration 0 step 0,
    then K4's commit) against JAX's delta_window_sums -> lowest_layer ->
    adjust_offsets on the same inputs. flow_step has no layer shards: the
    shard cases run layers [0, max(num_layers, radius))."""
    is_hdr, rs, radius, iteration, step, window, (ds, ns), kind, num_layers, _ = case
    layers = max(num_layers, radius)
    frames = make_frame(rng, H, W, is_hdr) + make_frame(rng, H, W, is_hdr)
    low_h, low_w = H >> rs, W >> rs
    offsets = _offsets(rng, kind, low_h, low_w)
    sums = jax_flow.delta_window_sums(
        *map(jnp.asarray, frames), jnp.asarray(offsets), jnp.int32(radius), jnp.int32(ds),
        jnp.int32(ns), window_size=window, res_scalar=rs, iteration=iteration, step=step,
        is_hdr=is_hdr, num_layers=layers)
    want = np.asarray(jax_flow.adjust_offsets(
        jnp.asarray(offsets), jax_flow.lowest_layer(sums), jnp.int32(radius),
        window_size=window, step=step))
    state = _flow_state(frames, radius, ds, ns, low_h=low_h, low_w=low_w, rs=rs,
                        is_hdr=is_hdr, num_layers=layers, schedule=[(iteration, window)])
    assert state.steps == [(iteration, window, 0), (iteration, window, 1)]
    state.offsets.copy_(_t(offsets))
    cv.flow_step_reference(state, step)
    np.testing.assert_array_equal(state.offsets.numpy(), want)
    raw = int(np.asarray(sums)[radius // 2 - 1, 0, 0]) if (iteration, step) == (0, 0) else 0
    assert state.delta.dtype == torch.int64 and int(state.delta) == raw
    if kind == "wrap":
        assert (np.abs(want.astype(np.int32) - offsets.astype(np.int32)) > 64).any()


# radius 1-3 put the raw delta's layer radius // 2 - 1 at -1 (the last layer,
# as Python and JAX index) and 0; one layer makes -1 the radius's own layer.
@pytest.mark.parametrize("radius,num_layers", [(1, 16), (1, 1), (2, 5), (3, 8), (7, 8)])
def test_pyramid_flow_raw_delta_layers_match_jax(rng, radius, num_layers):
    """pyramid_flow (a flow_step call a step) on the CPU equals JAX's
    pyramid, the raw delta included, where the delta's layer wraps."""
    h, w = 32, 48
    frames = make_frame(rng, h, w) + make_frame(rng, h, w)
    kw = dict(low_h=h, low_w=w, res_scalar=0, is_hdr=False, num_layers=num_layers)
    off_j, blur_j, raw_j = jax_flow.pyramid_flow(
        *map(jnp.asarray, frames), jnp.int32(radius), jnp.int32(8), jnp.int32(6), **kw)
    off_t, blur_t, raw_t = torch_flow.pyramid_flow(*map(_t, frames), radius, 8, 6, **kw)
    np.testing.assert_array_equal(off_t.numpy(), np.asarray(off_j))
    np.testing.assert_array_equal(blur_t.numpy(), np.asarray(blur_j))
    assert raw_t.dtype == torch.int64 and int(raw_t) == int(raw_j)
    assert (int(raw_t) == U32) == (num_layers > 1 and radius == 1)


def test_flow_step_on_the_cpu_launches_nothing(rng):
    """flow_step on a CPU state takes flow_step_reference: no counter moves,
    through the wrapper and through the whole pyramid; the state's steps are
    the schedule's, both steps each."""
    counters = (cv.flow_step, cv.delta_sums, cv.commit_winners)
    before = [f.launches for f in counters]
    frames = make_frame(rng, 32, 48) + make_frame(rng, 32, 48)
    schedule = torch_flow.window_schedule(32, 48)
    state = _flow_state(frames, 8, 8, 6, low_h=32, low_w=48, rs=0, is_hdr=False, num_layers=8,
                        schedule=schedule)
    assert state.steps == [(it, win, s) for it, win in schedule for s in (0, 1)]
    plain = _flow_state(frames, 8, 8, 6, low_h=32, low_w=48, rs=0, is_hdr=False,
                        num_layers=8, schedule=schedule)
    for k in range(len(state.steps)):
        cv.flow_step(state, k)
        cv.flow_step_reference(plain, k)
    assert torch.equal(state.offsets, plain.offsets) and int(state.delta) == int(plain.delta)
    got = torch_flow.pyramid_flow(*map(_t, frames), 8, 8, 6, low_h=32, low_w=48, res_scalar=0,
                                  is_hdr=False, num_layers=8)
    assert torch.equal(got[0], state.offsets) and int(got[2]) == int(state.delta)
    assert [f.launches for f in counters] == before
    state.reset()
    assert not state.offsets.any() and int(state.delta) == 0


def test_flow_step_refuses_other_devices():
    """A state of meta tensors (neither the CPU nor CUDA) raises when it is
    built, before any launch, and so do frames on two devices."""
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    y, uv = meta((32, 48), torch.uint8), meta((16, 48), torch.uint8)
    kw = dict(low_h=32, low_w=48, res_scalar=0, is_hdr=False, num_layers=8,
              schedule=[(0, 16)])
    before = cv.flow_step.launches
    with pytest.raises(ValueError, match="unsupported device"):
        cv.flow_step(cv.PyramidState(y, uv, y, uv, 8, 8, 6, **kw), 0)
    with pytest.raises(ValueError, match="one device"):
        cv.PyramidState(torch.zeros((32, 48), dtype=torch.uint8), uv, y, uv, 8, 8, 6, **kw)
    assert cv.flow_step.launches == before
