"""The frozen reference against the port's golden fixtures: the JAX
package's outputs compiled by XLA, which the port equals byte for byte."""

from pathlib import Path

import numpy as np
import pytest

from hrbench.reference.cadence import Output
from hrbench.reference.stream import ReferenceStream

FIXTURES = Path(__file__).resolve().parents[2] / "tests" / "fixtures"


@pytest.mark.parametrize("name", ["480p-sdr", "1080p-sdr", "4k-hdr", "4k-sdr"])
def test_reference_equals_golden_fixture(name):
    """Driven as tests/test_golden_fixtures.py drives an engine: two warm-up
    copies, then each frame's flow (radius 5, the engine's first), its scene
    delta and its warps at t = 0.25 and 0.75 in each of the fixture's modes
    (2, and 3 for 1080p-sdr)."""
    z = np.load(FIXTURES / f"golden_{name}.npz")
    h, w, hdr, mcr, nit, black, white, n_modes = (int(v) for v in z["meta"][:8])
    modes = [int(v) for v in z["meta"][8:8 + n_modes]]
    cfg = dict(format="p010" if hdr else "nv12", height=h, width=w, max_calc_res=mcr,
               num_iterations=nit, black_level=black, white_level=white, delta_scalar=8,
               neighbor_scalar=6)
    pool = list(zip(z["in_y"], z["in_uv"]))
    ref = ReferenceStream(pool, lambda k: k - 1, cfg, radius=5, mode=2, device="cpu")
    ys, uvs, deltas = [], [], []
    for k in range(1, len(pool) + 1):
        if k < 3:
            outs = ref.outputs(k, [Output(0, 0, 0.0, False, False)])
        else:
            deltas.append(ref.frame_delta(k))
            outs = []
            for m in modes:
                ref.mode = m
                outs += ref.outputs(k, [Output(0, 0, t, True, False) for t in (0.25, 0.75)])
        ys += [y for y, _ in outs]
        uvs += [uv for _, uv in outs]
    assert deltas == [int(d) for d in z["deltas"]]
    assert np.array_equal(np.stack(ys), z["out_y"])
    assert np.array_equal(np.stack(uvs), z["out_uv"])
