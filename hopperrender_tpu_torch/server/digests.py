"""The four pinned-digest streams of tests/fixtures/digests.json through the
port's FrameServer, on any device.

One definition for every caller that replays them: the CPU tests
(tests/test_torch_server.py checks STREAMS against the streams of
tests/test_regression_digests.py), the card's tests (tests/test_torch_cuda.py)
and chip_smoke.py. It imports nothing of the JAX package.

Each stream runs 24 -> 60 with the auto quality scaler off, the search radius
set before every frame, and frames that pan 2 px a frame, drawn from numpy's
generator seeded 2026. The digest is SHA-256 over every output's Y and UV
bytes, its start time (int64) and its interpolated flag (one byte).
"""

from __future__ import annotations

import hashlib

import numpy as np

from hopperrender_tpu_torch.config import Settings
from hopperrender_tpu_torch.server.frame_server import FrameServer
from hopperrender_tpu_torch.vio import nv12

# name: (h, w, max_calc_res, is_hdr, mode, radius, frames)
STREAMS = {
    "sdr_rs1_mode0": (80, 96, 40, False, 0, 7, 6),
    "sdr_rs2_mode1": (128, 160, 32, False, 1, 16, 6),
    "hdr_rs1_mode0": (80, 96, 40, True, 0, 9, 6),
    "sdr_rs0_mode0": (56, 72, 64, False, 0, 5, 6),
}


def stream_digest(name: str, device) -> str:
    """The hex digest of stream `name` served on `device`."""
    h, w, mcr, is_hdr, mode, radius, n = STREAMS[name]
    srv = FrameServer(w, h, source_fps=24.0, is_hdr=is_hdr, device=device,
                      settings=Settings(target_fps=60.0, use_display_fps=False,
                                        frame_output=mode, auto_quality=False,
                                        max_calc_res=mcr))
    rng = np.random.default_rng(2026)
    digest = hashlib.sha256()
    for i in range(n):
        y, uv = nv12.synthetic_frame(rng, h, w, is_hdr=is_hdr, motion_x=i * 2)
        if srv.engine is not None:
            srv.engine.search_radius = radius
        for out in srv.push_frame(y, uv):
            digest.update(out.y.tobytes())
            digest.update(out.uv.tobytes())
            digest.update(np.int64(out.start_time).tobytes())
            digest.update(b"\x01" if out.interpolated else b"\x00")
    return digest.hexdigest()
