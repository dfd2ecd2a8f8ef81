"""Import hygiene of the PyTorch port and its refusal to run without a card:
the port never loads jax, a CUDA engine or server raises when CUDA is absent,
and chip_smoke.py exits non-zero without a card and outside the repository."""

import ast
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from hopperrender_tpu_torch.engine.flow_engine import OpticalFlowEngine
from hopperrender_tpu_torch.server.frame_server import FrameServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = ROOT
    env.update(extra)
    return env


def _port_modules():
    """Every module of the port, as a dotted name."""
    pkg = os.path.join(ROOT, "hopperrender_tpu_torch")
    mods = []
    for dirpath, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


def test_port_never_imports_jax():
    """Every port module and chip_smoke, imported with JAX_PLATFORMS set
    (which makes hopperrender_tpu/__init__.py import jax), leave neither jax
    nor anything of the JAX package in sys.modules."""
    mods = _port_modules()
    assert "hopperrender_tpu_torch.server.control" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "port = chip_smoke.import_port()\n"
            "assert port.FrameServer and port.Settings and port.CadenceController\n"
            "assert port.nv12.synthetic_frame and port.config.MAX_SEARCH_RADIUS\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'hopperrender_tpu' or m.startswith('hopperrender_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_env(JAX_PLATFORMS="cpu"), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_names(path):
    """The modules of jax or of the JAX package that a file imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    return [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "hopperrender_tpu")]


def test_chip_smoke_imports_nothing_of_the_jax_package():
    assert not _imported_names(os.path.join(ROOT, "chip_smoke.py"))
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        assert "JAX_PLATFORMS" not in f.read()


def test_port_files_import_nothing_of_the_jax_package():
    paths = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "hopperrender_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    assert len(paths) > 15
    assert {p: _imported_names(p) for p in paths if _imported_names(p)} == {}


def test_plain_versions_swaps_the_wrappers_and_restores_them():
    import chip_smoke
    from hopperrender_tpu_torch.ops import blur_kernel, warp_kernel

    port = chip_smoke.import_port()
    kernels = blur_kernel.blur_flow, warp_kernel.warp_frames
    with pytest.raises(KeyError):
        with chip_smoke.plain_versions(port):
            assert blur_kernel.blur_flow is blur_kernel.blur_flow_reference
            assert warp_kernel.warp_frames is warp_kernel.warp_frames_reference
            raise KeyError("restored on the way out")
    assert (blur_kernel.blur_flow, warp_kernel.warp_frames) == kernels


def test_cuda_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        OpticalFlowEngine(64, 96, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        FrameServer(96, 64, device="cuda")


def _assert_refused(out):
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_refuses_without_cuda():
    # CUDA_VISIBLE_DEVICES="" hides any card, so this holds on a GPU machine too.
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True,
                         text=True, timeout=120)
    _assert_refused(out)
    assert "is_available() is False" in out.stderr


def test_chip_smoke_refuses_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = _env()
    del env["PYTHONPATH"]
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    _assert_refused(out)


def _stream_job(tmp_path, name, *, n_streams=1, out_dir=None):
    """A run_stream_steps job over n_streams tiny SDR streams of 3 frames."""
    from hopperrender_tpu_torch import entry
    y, uv, flow = entry.example_frames(32, 64, 16, 32, batch=n_streams)
    in_path = os.path.join(tmp_path, f"{name}.npz")
    np.savez(in_path, y=y, uv=uv, flow=flow, ts=np.asarray([0.5], np.float32))
    out = os.path.join(out_dir or tmp_path, name + ".{rank}.npz")
    return dict(in_path=in_path, out_path=out, mode=2, res_scalar=1, radius=9, delta_scalar=8,
                neighbor_scalar=6, black=0.0, white=255.0)


def test_run_ranks_children_never_import_jax(tmp_path):
    """Ranks started by run_ranks from this test process (which has jax and
    the JAX package loaded) load neither: they unpickle a port function and
    nothing else."""
    from hopperrender_tpu_torch import entry
    from hopperrender_tpu_torch.parallel import launch
    assert "jax" in sys.modules
    paths = launch.run_ranks(entry.run_stream_steps, 1, 2, device="cpu", workdir=str(tmp_path),
                             args=([_stream_job(tmp_path, "one")],), timeout=120)
    for (path,) in paths:
        with np.load(path) as z:
            assert z["foreign_modules"].size == 0
            assert str(z["backend"]) == "gloo"


def test_run_ranks_raises_on_a_failed_rank_and_kills_the_rest(tmp_path):
    """Rank 1 fails writing the first job's output (its directory is
    missing); rank 0 goes on to the second job and blocks in its first
    collective on the dead peer. run_ranks raises with rank 1's traceback
    instead of waiting, and leaves no rank running."""
    import multiprocessing

    from hopperrender_tpu_torch import entry
    from hopperrender_tpu_torch.parallel import launch
    os.makedirs(tmp_path / "0")
    first = _stream_job(tmp_path, "a", out_dir=str(tmp_path / "{rank}"))
    second = _stream_job(tmp_path, "b")
    start = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 1x2 failed") as exc:
        launch.run_ranks(entry.run_stream_steps, 1, 2, device="cpu", workdir=str(tmp_path),
                         args=([first, second],), timeout=120)
    assert "FileNotFoundError" in str(exc.value)
    assert time.monotonic() - start < 100
    assert not multiprocessing.active_children()


def test_run_ranks_times_out_and_kills_the_ranks(tmp_path):
    """A run that outlasts its timeout raises TimeoutError and leaves no rank
    running (half a second: less than a rank needs to start)."""
    import multiprocessing

    from hopperrender_tpu_torch import entry
    from hopperrender_tpu_torch.parallel import launch
    with pytest.raises(TimeoutError):
        launch.run_ranks(entry.run_stream_steps, 1, 2, device="cpu", workdir=str(tmp_path),
                         args=([_stream_job(tmp_path, "slow")],), timeout=0.5)
    assert not multiprocessing.active_children()


def test_run_ranks_refuses_streams_that_do_not_split_over_dp(tmp_path):
    from hopperrender_tpu_torch import entry
    from hopperrender_tpu_torch.parallel import launch
    with pytest.raises(RuntimeError, match="do not split"):
        launch.run_ranks(entry.run_stream_steps, 2, 1, device="cpu", workdir=str(tmp_path),
                         args=([_stream_job(tmp_path, "odd", n_streams=3)],), timeout=120)
