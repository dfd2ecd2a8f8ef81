"""ctypes bindings to the C++ native runtime (native/frame_ring.cpp).

The PyTorch port's own copy of hopperrender_tpu/native.py (the port imports
nothing of the JAX package); tests/test_torch_control.py holds the two
to the same behaviour. It differs in where the library comes from: the port
builds its own copy into build/hopperrender_tpu_torch/ (_build.BUILD_DIR)
and never loads native/libhrt_native.so, which the Makefile builds with
-march=native for whichever host ran it.

The native layer covers the roles the reference implements in C++ around its GPU
engine: the fixed-size sample pool + transport (ref: CustomAllocator.cpp:23-113,
HopperRender.cpp:529-541) and CPU-side stride compaction (ref:
HopperRender.cpp:740-758,851-865). Pure-NumPy fallbacks keep everything working
when no C++ toolchain is available; `is_native()` reports which path is active.
These are host code: no device path runs here.

Builds lazily on first use with the Makefile's own flags (g++ and make are
needed; without them the NumPy fallbacks run).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from hopperrender_tpu_torch._build import BUILD_DIR
from hopperrender_tpu_torch.utils.logging import get_logger
from hopperrender_tpu_torch.vio import nv12

log = get_logger("native")

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
_SO_NAME = "libhrt_native.so"


def _host_cpu() -> bytes:
    """The CPU's feature flags: -march=native ties a build to them."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return b""


def _built_so() -> str:
    """The build directory's library, named after a hash of the sources, the
    Makefile and the host's CPU flags, so a tree copied to another host
    builds its own."""
    h = hashlib.sha256(_host_cpu())
    for name in ("frame_ring.cpp", "Makefile"):
        with open(os.path.join(_NATIVE_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libhrt_native_{h.hexdigest()[:16]}.so")


def _find_so() -> str | None:
    """Locate the native library: a copy installed in the package directory,
    then the build directory's. Returns None if neither exists yet (the
    caller may then build)."""
    for cand in (os.path.join(_PKG_DIR, _SO_NAME), _built_so()):
        if os.path.exists(cand):
            return cand
    return None

_lib = None
_lib_lock = threading.Lock()
_META_WORDS = 4


def _build() -> bool:
    """make -C native into a temporary name, then an atomic rename: a
    concurrent loader (another process) never sees half a file."""
    so = _built_so()
    tmp = os.path.join(os.path.dirname(so), f".{os.path.basename(so)}.{os.getpid()}.tmp")
    try:
        os.makedirs(os.path.dirname(so), exist_ok=True)
        subprocess.run(["make", "-C", _NATIVE_DIR, f"SO={tmp}"], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (subprocess.SubprocessError, OSError) as e:
        detail = getattr(e, "stderr", None) or b""
        log.warning("native build failed (%s %s); using NumPy fallbacks", e,
                    detail.decode(errors="replace").strip())
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = _find_so()
        if so is None:
            if not _build():
                _lib = False
                return _lib
            so = _find_so()
            if so is None:
                log.warning("native build produced no %s; using NumPy "
                            "fallbacks", _SO_NAME)
                _lib = False
                return _lib
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            log.warning("failed to load %s (%s); using NumPy fallbacks", so, e)
            _lib = False
            return _lib
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        i64p = ctypes.POINTER(i64)
        lib.hrt_unpack.argtypes = [u8p, i64, i64, i64, i64, u8p, u8p]
        lib.hrt_pack.argtypes = [u8p, u8p, i64, i64, i64, i64, u8p]
        lib.hrt_ring_create.restype = ctypes.c_void_p
        lib.hrt_ring_create.argtypes = [i64, i64]
        lib.hrt_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.hrt_ring_size.argtypes = [ctypes.c_void_p]
        lib.hrt_ring_size.restype = i64
        lib.hrt_ring_close.argtypes = [ctypes.c_void_p]
        lib.hrt_ring_closed.argtypes = [ctypes.c_void_p]
        lib.hrt_ring_closed.restype = ctypes.c_int
        lib.hrt_ring_push.argtypes = [ctypes.c_void_p, u8p, i64, i64p, i64]
        lib.hrt_ring_push.restype = ctypes.c_int
        lib.hrt_ring_pop.argtypes = [ctypes.c_void_p, u8p, i64p, i64]
        lib.hrt_ring_pop.restype = i64
        _lib = lib
        return _lib


def is_native() -> bool:
    return bool(_load())


def _u8view(a: np.ndarray):
    return a.view(np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def unpack(buf: np.ndarray | bytes, height: int, width: int,
           stride: int | None = None, *, is_hdr: bool = False):
    """Strided packed frame -> tight (y, uv) planes. Native memcpy when available."""
    stride = stride or width
    dtype = np.uint16 if is_hdr else np.uint8
    lib = _load()
    flat = np.frombuffer(buf, dtype=dtype) if not isinstance(buf, np.ndarray) \
        else np.ascontiguousarray(buf).view(dtype).ravel()
    need = height * stride + (height // 2) * stride
    if flat.size < need:
        raise ValueError(f"buffer too small: {flat.size} < {need} samples")
    if not lib:
        return nv12.unpack(flat, height, width, stride, is_hdr=is_hdr)
    y = np.empty((height, width), dtype)
    uv = np.empty((height // 2, width), dtype)
    lib.hrt_unpack(_u8view(flat), height, width, stride, flat.itemsize,
                   _u8view(y), _u8view(uv))
    return y, uv


def pack(y: np.ndarray, uv: np.ndarray, stride: int | None = None) -> np.ndarray:
    """Tight planes -> packed frame with output stride."""
    height, width = y.shape
    stride = stride or width
    lib = _load()
    if not lib:
        return nv12.pack(y, uv, stride)
    out = np.empty((height + height // 2) * stride, y.dtype)
    lib.hrt_pack(_u8view(np.ascontiguousarray(y)), _u8view(np.ascontiguousarray(uv)),
                 height, width, stride, y.dtype.itemsize, _u8view(out))
    return out


class FrameRing:
    """SPSC blocking frame queue backed by the native preallocated slab.

    The decode-thread -> engine-thread transport (sample-pool equivalent). Falls
    back to a Python deque + condition when the native library is unavailable.
    Payloads are opaque byte buffers + 4 int64 metadata words (pts, flags, ...).
    """

    def __init__(self, capacity: int, slot_bytes: int):
        self.capacity = capacity
        self.slot_bytes = slot_bytes
        lib = _load()
        self._lib = lib if lib else None
        if self._lib:
            self._ring = ctypes.c_void_p(lib.hrt_ring_create(capacity, slot_bytes))
            if not self._ring:
                raise MemoryError("hrt_ring_create failed")
        else:
            import collections

            self._dq = collections.deque()
            self._cond = threading.Condition()
            self._closed = False

    # timeout semantics: None = block forever, 0 = non-blocking, else seconds.
    def push(self, data: np.ndarray | bytes, meta: tuple[int, int, int, int] = (0, 0, 0, 0),
             timeout: float | None = None) -> bool:
        arr = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
            else np.ascontiguousarray(data).view(np.uint8).ravel()
        if self._lib:
            m = (ctypes.c_int64 * _META_WORDS)(*meta)
            tmo = -1 if timeout is None else int(timeout * 1000)
            rc = self._lib.hrt_ring_push(
                self._ring, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                arr.size, m, tmo)
            if rc == -3:
                raise ValueError(f"payload {arr.size} > slot {self.slot_bytes}")
            if rc == -2:
                raise RuntimeError("ring closed")
            return rc == 0
        with self._cond:
            if timeout == 0 and len(self._dq) >= self.capacity:
                return False
            ok = self._cond.wait_for(
                lambda: len(self._dq) < self.capacity or self._closed, timeout)
            if self._closed:
                raise RuntimeError("ring closed")
            if not ok:
                return False
            self._dq.append((bytes(arr.tobytes()), tuple(meta)))
            self._cond.notify_all()
            return True

    def pop(self, timeout: float | None = None):
        """Returns (payload bytes, meta tuple) or None on timeout / closed+drained."""
        if self._lib:
            buf = np.empty(self.slot_bytes, np.uint8)
            m = (ctypes.c_int64 * _META_WORDS)()
            tmo = -1 if timeout is None else int(timeout * 1000)
            size = self._lib.hrt_ring_pop(
                self._ring, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), m, tmo)
            if size < 0:
                return None
            return buf[:size].tobytes(), tuple(m)
        with self._cond:
            ok = self._cond.wait_for(lambda: self._dq or self._closed, timeout)
            if not ok or not self._dq:
                return None
            item = self._dq.popleft()
            self._cond.notify_all()
            return item

    def __len__(self) -> int:
        if self._lib:
            return int(self._lib.hrt_ring_size(self._ring))
        with self._cond:
            return len(self._dq)

    def close(self) -> None:
        if self._lib:
            self._lib.hrt_ring_close(self._ring)
        else:
            with self._cond:
                self._closed = True
                self._cond.notify_all()

    def is_closed(self) -> bool:
        if self._lib:
            return bool(self._lib.hrt_ring_closed(self._ring))
        with self._cond:
            return self._closed

    def __del__(self):
        try:
            if getattr(self, "_lib", None) and getattr(self, "_ring", None):
                self._lib.hrt_ring_destroy(self._ring)
                self._ring = None
        except Exception:
            pass
