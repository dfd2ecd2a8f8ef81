"""The port's command line, python -m hopperrender_tpu_torch, on the CPU
(--device cpu) against the JAX package's (hopperrender_tpu.cli.main, driven
in-process): byte-equal Y4M for the same raw and Y4M input, SDR and HDR, modes
2 and 3, interpolate and serve, and stdin/stdout pipes; the same probe and
settings output; and without a card the default --device cuda exits 1 and
writes no frame. The scaler is off (--settings) wherever bytes are compared:
JAX's first-frame compile time would move its radius."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hopperrender_tpu import cli as jax_cli
from hopperrender_tpu_torch import _build, cli
from hopperrender_tpu_torch.vio import nv12, video

from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 16, 32


def _inputs(tmp_path, is_hdr, seed=0):
    """Six panning frames as a raw stream and as Y4M (HDR samples keep 10
    significant bits, so both carry the same samples), and a settings file
    that turns the scaler off."""
    rng = np.random.default_rng(seed)
    raw = tmp_path / ("in.p010" if is_hdr else "in.nv12")
    y4m = tmp_path / "in.y4m"
    writer = video.Y4MWriter(str(y4m), W, H, 24.0, is_hdr=is_hdr)
    with open(raw, "wb") as f:
        for i in range(6):
            y, uv = nv12.synthetic_frame(rng, H, W, is_hdr=is_hdr, motion_x=i)
            if is_hdr:
                y, uv = y & np.uint16(0xFFC0), uv & np.uint16(0xFFC0)
            f.write(nv12.pack(y, uv).tobytes())
            writer.write(y, uv)
    writer.close()
    settings = tmp_path / "settings.json"
    settings.write_text(json.dumps({"auto_quality": False}))
    return raw, y4m, settings


def _geometry(is_hdr):
    return ["--width", str(W), "--height", str(H), "--fps", "24"] + (["--hdr"] if is_hdr else [])


def _stats(captured):
    return json.loads(captured.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", [2, 3])
@pytest.mark.parametrize("is_hdr", [False, True])
def test_cli_output_matches_jax(tmp_path, capsys, is_hdr, mode):
    """interpolate from raw and from Y4M, and serve (threaded pipeline, status
    endpoint, --stats): every port output equals the JAX CLI's, byte for byte;
    serve's stats line carries JAX's keys and the tracer's stages_ms and
    host_syncs_per_frame, and its metrics JAX's but warp_apron."""
    raw, y4m, settings = _inputs(tmp_path, is_hdr)
    common = ["--target-fps", "60", "--mode", str(mode), "--settings", str(settings)]
    jax_serve = tmp_path / "jax_serve.y4m"
    assert jax_cli.main(["interpolate", str(raw), str(tmp_path / "jax.y4m"),
                         *_geometry(is_hdr), *common]) == 0
    assert jax_cli.main(["serve", str(raw), str(jax_serve), *_geometry(is_hdr), *common,
                         "--stats", "--status-port", "0"]) == 0
    jax_stats = _stats(capsys.readouterr().out)
    want = (tmp_path / "jax.y4m").read_bytes()
    assert jax_serve.read_bytes() == want

    runs = {"interpolate_raw": ["interpolate", str(raw), *_geometry(is_hdr)],
            "interpolate_y4m": ["interpolate", str(y4m)],
            "serve_raw": ["serve", str(raw), *_geometry(is_hdr), "--stats", "--status-port", "0"]}
    for name, argv in runs.items():
        out = tmp_path / f"{name}.y4m"
        assert cli.main([*argv[:2], str(out), *argv[2:], *common, "--device", "cpu"]) == 0
        assert out.read_bytes() == want, name
    captured = capsys.readouterr()
    stats = _stats(captured.out)
    assert "status endpoint: http://127.0.0.1:" in captured.err
    assert set(stats) == set(jax_stats) | {"stages_ms", "host_syncs_per_frame"}
    assert {"pipe.frame", "pipe.wait_input", "pipe.unpack", "server.push_frame", "pipe.emit",
            "engine.ingest", "engine.flow", "server.egress"} <= set(stats["stages_ms"])
    # two warm-up pushes of three copies (3 syncs each), then four with the flow
    # timer and the scene gate, one warp timer (mode 2) or one an output
    # (mode 3), and two planes an output
    late = stats["frames_out"] - 6
    syncs = 18 + (4 * 3 + 2 * late if mode == 2 else 4 * 2 + 3 * late)
    assert stats["host_syncs_per_frame"] == syncs / 6
    assert set(stats["metrics"]) == set(jax_stats["metrics"]) - {"warp_apron"}
    for key in ("frames_in", "frames_out", "renegotiations"):
        assert stats[key] == jax_stats[key], key
    outs = list(video.Y4MReader(str(tmp_path / "serve_raw.y4m")))
    assert stats["frames_in"] == 6 and stats["frames_out"] == len(outs) >= 10
    assert stats["metrics"]["frame_output"] == mode


# (command, HDR): Y4M on stdin (SDR), raw P010 on stdin with --width/--height.
@pytest.mark.parametrize("command, is_hdr", [("interpolate", False), ("serve", True)])
def test_pipes_match_jax(tmp_path, command, is_hdr):
    """'-' in and out through python -m hopperrender_tpu_torch: stdout
    carries exactly the JAX CLI's Y4M (the stats line goes to stderr)."""
    raw, y4m, settings = _inputs(tmp_path, is_hdr, seed=1)
    src, geometry = (raw, _geometry(True)) if is_hdr else (y4m, [])
    common = ["--target-fps", "60", "--settings", str(settings)]
    jax_out = tmp_path / "jax.y4m"
    assert jax_cli.main([command, str(src), str(jax_out), *geometry, *common]) == 0
    with open(src, "rb") as fin:
        r = subprocess.run([sys.executable, "-m", "hopperrender_tpu_torch", command, "-", "-",
                            *geometry, *common, "--device", "cpu", "--stats"],
                           stdin=fin, capture_output=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == jax_out.read_bytes()
    assert _stats(r.stderr.decode())["frames_in"] == 6


def test_without_a_card_the_default_device_exits_1_and_writes_nothing(tmp_path, capsys,
                                                                      monkeypatch):
    """--device defaults to cuda: with no card the command fails with the
    FrameServer's error before it opens the output, whether a file or '-'."""
    raw, _, _ = _inputs(tmp_path, False)
    out = tmp_path / "out.y4m"
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, "-m", "hopperrender_tpu_torch", "serve", str(raw),
                        str(out), *_geometry(False)],
                       capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert r.returncode == 1
    assert "error: FrameServer: device 'cuda' requested but no CUDA device" in r.stderr
    assert r.stdout == "" and not out.exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for command in ("interpolate", "serve"):
        assert cli.main([command, str(raw), "-", *_geometry(False)]) == 1
        captured = capsys.readouterr()
        assert captured.out == "" and "no CUDA device" in captured.err


def test_probe_and_settings_match_jax(tmp_path, capsys, monkeypatch):
    """probe and settings print what the JAX CLI prints and exit as it
    exits, with no card and without building a kernel."""
    def no_build():
        raise AssertionError("probe and settings must not build kernels")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw, y4m, _ = _inputs(tmp_path, True)
    port_file, jax_file = tmp_path / "port" / "s.json", tmp_path / "jax" / "s.json"
    commands = [["probe", str(raw), *_geometry(True)], ["probe", str(y4m), "--fps", "30"],
                ["settings", "--set", "target_fps=120", "--set", "delta_scalar=5",
                 "--set", "activated=false"],
                ["settings"],
                ["settings", "--set", "delta_scalar=99"],
                ["settings", "--set", "bogus=1"],
                ["settings", "--reset"]]
    codes = []
    for argv in commands:
        results = []
        for main, path in ((jax_cli.main, jax_file), (cli.main, port_file)):
            extra = ["--file", str(path)] if argv[0] == "settings" else []
            code = main([*argv, *extra])
            results.append((code, capsys.readouterr()))
        (jcode, jout), (code, out) = results
        assert code == jcode and out.out == jout.out, argv
        codes.append(code)
        if argv[0] == "settings":
            assert port_file.read_bytes() == jax_file.read_bytes()
    assert codes == [0, 0, 0, 0, 1, 2, 0]
    assert json.loads(jout.out)["delta_scalar"] == 8   # after --reset
