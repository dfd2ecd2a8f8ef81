"""Build and load the port's hand-written CUDA kernels.

On first use, nvcc compiles every `csrc/*.cu` (one nvcc process per source,
all started together) and links the objects into ONE shared library with a
plain C interface, under `build/hopperrender_tpu_torch/` beside the package,
and ctypes loads it. The library's name carries a hash of the sources and the
flags, so editing a source triggers a rebuild and an unchanged tree reuses the
library. No PyTorch header is included, so a build takes seconds, not the
minutes `torch.utils.cpp_extension.load` needs.

Every C entry point launches on the stream it is given, allocates nothing,
does not synchronise, and returns `cudaGetLastError()` as an int; `check`
turns a non-zero code into an exception.

`launch` is the wrappers' one way in: the entry point resolved once per
process (`entry`), the raw handle of the current stream of the tensors'
device, a device switch only when that device is not the current one, and
the error check. It takes no lock once the library is loaded.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "hopperrender_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argtypes. Pointers and the stream are c_void_p: left
# undeclared, ctypes would pass them as 32-bit ints and cut them.
SIGNATURES = {
    # (in, out, low_h, low_w, stream)
    "hrt_blur_flow": (_P, _P, _I, _I, _P),
    # (src12_y, src12_uv, src21_y, src21_uv, flow, ts, n_t, out_y, out_uv,
    #  dim_y, dim_x, row0_y, rows_y, row0_uv, rows_uv, low_h, low_w, res_scalar, mode,
    #  raw_blend, is_hdr, black, white, stream)
    "hrt_warp_frames": (_P, _P, _P, _P, _P, _P, _I, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P),
    # K3 (f1y, f1uv, f2y, f2uv, offsets, sums, dim_y, dim_x, uv_h, uv_w, low_h, low_w,
    #  n_win_y, n_win_x, radius, delta_scalar, neighbor_scalar, window_size, res_scalar,
    #  neighbors, step, layer_offset, num_layers, is_hdr, stream)
    "hrt_delta_sums": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _I, _I, _I, _I, _I, _I, _P),
    # K4 (in, out, sums, low_h, low_w, n_win_y, n_win_x, num_layers, radius, window_size,
    #  step, stream)
    "hrt_commit_winners": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # One pyramid step, K3 then K4 (f1y, f1uv, f2y, f2uv, offsets, sums, next_sums, delta_out,
    #  dim_y, dim_x, uv_h, uv_w, low_h, low_w, radius, delta_scalar, neighbor_scalar,
    #  window_size, next_window, res_scalar, neighbors, step, num_layers, is_hdr, stream)
    "hrt_flow_step": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                      _I, _I, _I, _I, _I, _I, _P),
    # K3 alone in a timing variant (variant, f1y, f1uv, f2y, f2uv, offsets, sums, probe_out,
    #  dim_y, dim_x, uv_h, uv_w, low_h, low_w, radius, delta_scalar, neighbor_scalar,
    #  window_size, res_scalar, neighbors, step, num_layers, stream)
    "hrt_delta_sums_probe": (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _P),
    # K4 in a timing variant (variant, in, out, sums, low_h, low_w, num_layers, radius,
    #  window_size, step, stream)
    "hrt_commit_winners_probe": (_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # K2's mode 3 in a timing variant (variant, src12_y, src21_y, flow, ts, n_t, out_y,
    #  out_uv, dim_y, dim_x, low_h, low_w, res_scalar, black, white, stream)
    "hrt_warp_mode3_probe": (_I, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P),
    # K5 (raw_y, flow, out_y, out_uv, n_t, rows_y, rows_uv, dim_x, row0_y, row0_uv, low_h,
    #  low_w, res_scalar, is_hdr, black, white, stream)
    "hrt_hsv_overlay": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P),
    # K6 (src_y, src_uv, out_y, out_uv, dim_y, dim_x, is_hdr, black, white, stream)
    "hrt_copy_frame": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _P),
    # (stream): an empty kernel, the floor under a launch-bound kernel's time
    "hrt_empty_launch": (_P,),
    # (grid_x, grid_y, block_x, block_y, stream): an empty launch of a kernel's grid
    "hrt_empty_grid": (_I, _I, _I, _I, _P),
    # (kind, threads, src, out, stream): that floor taken apart
    "hrt_floor_launch": (_I, _I, _P, _P, _P),
    # (passes, n16, src, out, blocks, stream): reads of an L2-resident buffer
    "hrt_l2_read": (_I, _I, _P, _P, _I, _P),
    # The probes (probes/): (variant, n, tab, band, out, blocks, stream)
    "hrt_chain_probe": (_I, _I, _P, _P, _P, _I, _P),
    # (variant, n, tab, band, res, out, blocks, stream)
    "hrt_chain_probe2": (_I, _I, _P, _P, _P, _P, _I, _P),
    # (variant, x, idx, out, stream)
    "hrt_gather_probe": (_I, _P, _P, _P, _P),
    # (variant, idx, x, out, stream)
    "hrt_mosaic_probe": (_I, _P, _P, _P, _P),
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an up-to-date library was reused
    ptxas_log: str         # nvcc's -Xptxas -v report (registers, spills)


_lock = threading.Lock()
_loaded: KernelLibrary | None = None
_entries: dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(cuda_home, "bin", "nvcc")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.h"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhrt_kernels_{h.hexdigest()[:16]}.so"


def _run_nvcc(cmds: list[list[str]]) -> str:
    """Run the nvcc commands side by side; their joined output, or raise."""
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for cmd in cmds]
    except FileNotFoundError as exc:
        raise RuntimeError(f"nvcc not found ({cmds[0][0]}): the CUDA toolkit is "
                           "needed to build the kernels") from exc
    log, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        log.append(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(log)


def _compile(so: Path) -> tuple[float, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    tmp = so.with_name(f".{tag}.tmp")
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [so.with_name(f".{tag}.{src.stem}.o") for src in srcs]
    start = time.perf_counter()
    try:
        log = _run_nvcc([[nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
                          str(src)] for src, obj in zip(srcs, objs)])
        log += _run_nvcc([[nvcc_path(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *(str(o) for o in objs)]])
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - start
    so.with_suffix(".log").write_text(log)
    os.replace(tmp, so)   # atomic: a concurrent loader never sees half a file
    return seconds, log


def load() -> KernelLibrary:
    """The kernel library, built on the first call of the process if needed."""
    global _loaded
    with _lock:
        if _loaded is None:
            so = _library_path()
            if so.exists():
                seconds, log_path = 0.0, so.with_suffix(".log")
                log = log_path.read_text() if log_path.exists() else ""
            else:
                seconds, log = _compile(so)
            lib = ctypes.CDLL(str(so))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.hrt_error_string.argtypes = [ctypes.c_int]
            lib.hrt_error_string.restype = ctypes.c_char_p
            lib.hrt_warp_generic_launches.argtypes = []
            lib.hrt_warp_generic_launches.restype = ctypes.c_longlong
            _loaded = KernelLibrary(lib=lib, path=so, build_seconds=seconds,
                                    ptxas_log=log)
        return _loaded


def check(code: int, name: str) -> None:
    """Raise when a kernel's launch returned a CUDA error."""
    if code != 0:
        msg = load().lib.hrt_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")


def entry(name: str) -> ctypes._CFuncPtr:
    """The C entry point `name` with its argtypes: the first call of the
    process loads (and if needed builds) the library; every later call is
    one dict lookup, with no lock."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(load().lib, name)
    return fn


def launch(name: str, index: int, *args) -> None:
    """Call the C entry point `name` with args and the raw handle of the
    current stream of CUDA device `index` (the capturing stream under CUDA
    graph capture), with that device current; raise if it returns an error."""
    fn = entry(name)
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch._C._cuda_getDevice():
        code = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            code = fn(*args, stream)
    if code:
        check(code, name)
