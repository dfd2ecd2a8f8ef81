"""K6, the levelled passthrough (ops/copy_kernel.py, csrc/copy_frame.cu), on
the CPU: the wrapper takes its plain version for CPU tensors and counts no
launch; the plain version equals jitted JAX's copy_frame bit for bit on
every SDR and HDR sample value at the usual level pairs and at the
degenerate ones that Settings accepts (black == white, white 0, black above
white: the division gives infinities and NaN, which clip to peak, 0 and 0);
the engine's copies go through the wrapper. The kernel itself runs only on
the card (tests/test_torch_cuda.py -k copy, chip_smoke.py phase 4f)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hopperrender_tpu.engine.flow_engine import OpticalFlowEngine as JaxEngine
from hopperrender_tpu.ops import warp as jax_warp
from hopperrender_tpu.vio import nv12
from hopperrender_tpu_torch.engine.flow_engine import OpticalFlowEngine
from hopperrender_tpu_torch.ops import copy_kernel

from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

# (black, white) in 8-bit units, x256 for HDR: the usual pairs, then the
# degenerate ones (config.Settings checks only that both lie in [0, 255]).
LEVEL_PAIRS = ((0, 255), (16, 235), (3, 250))
DEGENERATE_PAIRS = ((16, 16), (0, 0), (16, 0), (235, 16))


def every_sample_planes(is_hdr):
    """Y (2n/256, 256) holding every sample value twice, UV (n/256, 256) once."""
    n = 65536 if is_hdr else 256
    dt = np.uint16 if is_hdr else np.uint8
    y = (np.arange(2 * n) % n).astype(dt).reshape(-1, 256)
    return y, y[:y.shape[0] // 2].copy()


def _levels(pair, is_hdr):
    s = 256.0 if is_hdr else 1.0
    return pair[0] * s, pair[1] * s


@pytest.mark.parametrize("is_hdr", [False, True])
def test_wrapper_on_the_cpu_is_the_plain_version(is_hdr):
    """CPU tensors take copy_frame_reference's bytes into new tensors, and
    no launch is counted."""
    rng = np.random.default_rng(1)
    y, uv = (torch.from_numpy(p) for p in nv12.synthetic_frame(rng, 50, 86, is_hdr=is_hdr))
    black, white = _levels((16, 235), is_hdr)
    before = copy_kernel.copy_frame.launches
    got = copy_kernel.copy_frame(y, uv, black, white, is_hdr=is_hdr)
    want = copy_kernel.copy_frame_reference(y, uv, black, white, is_hdr=is_hdr)
    assert copy_kernel.copy_frame.launches == before
    for g, w, src in zip(got, want, (y, uv)):
        assert g.dtype == src.dtype and g.shape == src.shape
        assert torch.equal(g, w)
        assert g.data_ptr() != src.data_ptr()


@pytest.mark.parametrize("pair", LEVEL_PAIRS + DEGENERATE_PAIRS, ids=str)
@pytest.mark.parametrize("is_hdr", [False, True])
def test_plain_version_matches_jax_every_sample_value(is_hdr, pair):
    """Every sample value through the plain version and jitted JAX's
    copy_frame (whose UV levels XLA contracts into one FMA), exactly."""
    y, uv = every_sample_planes(is_hdr)
    black, white = _levels(pair, is_hdr)
    ty, tuv = copy_kernel.copy_frame_reference(torch.from_numpy(y), torch.from_numpy(uv),
                                               black, white, is_hdr=is_hdr)
    jy, juv = jax_warp.copy_frame(jnp.asarray(y), jnp.asarray(uv), jnp.float32(black),
                                  jnp.float32(white), is_hdr=is_hdr)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tuv.numpy(), np.asarray(juv))


@pytest.mark.parametrize("is_hdr", [False, True])
def test_degenerate_levels_clip_nan_to_zero(is_hdr):
    """The degenerate pairs' edges, pinned: 0/0 (a sample at black when
    black == white; UV at mid when white is 0) gives NaN, which the clip
    takes to 0, as XLA's clamp and conversion do; +-inf clip to peak and 0."""
    peak = 65535 if is_hdr else 255
    s, mid = (256, 32768) if is_hdr else (1, 128)
    dt = torch.uint16 if is_hdr else torch.uint8
    y = torch.tensor([[0, 16 * s, 17 * s, mid]] * 2, dtype=dt)
    uv = torch.tensor([[0, mid - 1, mid, mid + 1]], dtype=dt)
    oy, _ = copy_kernel.copy_frame(y, uv, 16.0 * s, 16.0 * s, is_hdr=is_hdr)
    assert oy[0].tolist() == [0, 0, peak, peak]
    oy, ouv = copy_kernel.copy_frame(y, uv, 0.0, 0.0, is_hdr=is_hdr)
    assert oy[0].tolist() == [0, peak, peak, peak] and ouv[0].tolist() == [0, 0, 0, peak]


def test_engine_copies_go_through_the_wrapper(monkeypatch):
    """Each warmup copy of the engine is one wrapper call, on the slot the
    JAX engine copies, with equal bytes."""
    calls = []
    kernel = copy_kernel.copy_frame

    def counting(*args, **kw):
        calls.append(args[0])
        return kernel(*args, **kw)

    monkeypatch.setattr(copy_kernel, "copy_frame", counting)
    h, w = 32, 64
    rng = np.random.default_rng(5)
    frames = [nv12.synthetic_frame(rng, h, w, is_hdr=True, motion_x=2 * i) for i in range(3)]
    kw = dict(is_hdr=True, black_level=16.0 * 256, white_level=235.0 * 256)
    eng, jeng = OpticalFlowEngine(h, w, device="cpu", **kw), JaxEngine(h, w, **kw)
    for i, (y, uv) in enumerate(frames):
        eng.update_frame(y, uv)
        jeng.update_frame(y, uv)
        ty, tuv = eng.copy_frame()
        jy, juv = jeng.copy_frame()
        assert len(calls) == i + 1
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(tuv.numpy(), np.asarray(juv))


def test_wrapper_rejects_bad_input():
    y, uv = torch.zeros((4, 8), dtype=torch.uint8), torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint16"):
        copy_kernel.copy_frame(y, uv, 0.0, 255.0, is_hdr=True)
    with pytest.raises(ValueError, match="H even"):
        copy_kernel.copy_frame(y, uv[:1], 0.0, 255.0, is_hdr=False)
    with pytest.raises(ValueError, match="H even"):
        copy_kernel.copy_frame(y[:3], uv[:1], 0.0, 255.0, is_hdr=False)
    with pytest.raises(ValueError, match="2-D"):
        copy_kernel.copy_frame(y[None], uv, 0.0, 255.0, is_hdr=False)
    with pytest.raises(ValueError, match="one device"):
        copy_kernel.copy_frame(y, uv.to("meta"), 0.0, 255.0, is_hdr=False)
    with pytest.raises(ValueError, match="unsupported device"):
        copy_kernel.copy_frame(y.to("meta"), uv.to("meta"), 0.0, 255.0, is_hdr=False)
