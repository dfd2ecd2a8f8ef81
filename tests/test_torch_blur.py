"""The PyTorch port's flow blur (plain version of kernel K1) against the JAX
package's Pallas kernel in interpret mode and its XLA formulation: exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hopperrender_tpu.ops import flow as jax_flow
from hopperrender_tpu.ops import pallas_kernels
from hopperrender_tpu_torch.ops import blur_kernel
from hopperrender_tpu_torch.ops import flow as torch_flow

from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("shape", [(11, 13), (34, 48), (270, 480)])
def test_blur_matches_pallas_and_xla(rng, shape):
    h, w = shape
    offsets = rng.integers(-500, 501, (2, h, w)).astype(np.int16)
    got = torch_flow.blur_flow(torch.from_numpy(offsets)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(pallas_kernels.blur_flow_pallas(jnp.asarray(offsets), interpret=True)))
    np.testing.assert_array_equal(
        got, np.asarray(jax_flow.blur_flow(jnp.asarray(offsets), backend="xla")))


def test_blur_truncates_toward_zero():
    """Plane 0 all -3: every window sums to -192 -> -3. Plane 1 all -1 but a
    zero corner, which the mirror puts four times into the corner's window:
    -60 / 64 truncates to 0 where flooring would give -1."""
    offsets = np.full((2, 12, 20), -3, np.int16)
    offsets[1] = -1
    offsets[1, 0, 0] = 0
    got = blur_kernel.blur_flow(torch.from_numpy(offsets)).numpy()
    want = np.asarray(pallas_kernels.blur_flow_pallas(jnp.asarray(offsets), interpret=True))
    np.testing.assert_array_equal(got, want)
    assert (got[0] == -3).all() and got[1, 0, 0] == 0


def test_blur_small_planes_mirror_periodically(rng):
    """Planes narrower than the blur radius mirror with period 2*dim, as numpy's
    "symmetric" pad does."""
    offsets = rng.integers(-500, 501, (2, 3, 2)).astype(np.int16)
    np.testing.assert_array_equal(
        blur_kernel.blur_flow(torch.from_numpy(offsets)).numpy(),
        np.asarray(jax_flow.blur_flow(jnp.asarray(offsets), backend="xla")))


def test_blur_rejects_bad_input():
    with pytest.raises(ValueError):
        blur_kernel.blur_flow(torch.zeros((2, 4, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        blur_kernel.blur_flow(torch.zeros((3, 4, 4), dtype=torch.int16))
