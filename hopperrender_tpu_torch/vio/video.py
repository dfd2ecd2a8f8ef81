"""Offline video IO: raw NV12/P010 streams, Y4M, and (gated) ffmpeg piping.

The PyTorch port's own copy of hopperrender_tpu/vio/video.py (the port imports
nothing of the JAX package); tests/test_torch_control.py holds the two
to the same behaviour.

The reference's offline analogue was a GUI exporter rendering files through the same
backend (ref: CHANGELOG.md:253-255). Here the offline mode is first-class:

  * RawReader / RawWriter — headerless packed NV12 (8-bit) or P010 (16-bit LE,
    MSB-aligned) frame streams, the exact layout the engine ingests.
  * Y4MReader / Y4MWriter — YUV4MPEG2 with C420mpeg2/C420 (8-bit) and C420p10
    (10-bit) colorspaces; planar U/V converted to/from the NV12 interleaved layout.
  * FfmpegReader / FfmpegWriter — any container via an ffmpeg subprocess pipe,
    available only when ffmpeg is on PATH (this image has none; the classes raise a
    clear error instead of importing-failing).
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from fractions import Fraction

import numpy as np

from hopperrender_tpu_torch.vio import nv12


def _open_in(path: str):
    """'-' means stdin (binary); otherwise a regular file. Returns
    (file, owned) — std streams are not owned and must not be closed."""
    if path == "-":
        return sys.stdin.buffer, False
    return open(path, "rb"), True


def _open_out(path: str):
    if path == "-":
        return sys.stdout.buffer, False
    return open(path, "wb"), True


def _read_exact(f, n: int) -> bytes:
    """Read exactly n bytes, looping over short reads (pipes deliver data in
    arbitrary chunks, unlike regular files). Returns fewer bytes only at EOF."""
    chunks = []
    remaining = n
    while remaining:
        buf = f.read(remaining)
        if not buf:
            break
        chunks.append(buf)
        remaining -= len(buf)
    return b"".join(chunks)


class RawReader:
    """Headerless packed NV12/P010 frame stream (file or '-' = stdin pipe)."""

    def __init__(self, path: str, width: int, height: int, *, is_hdr: bool = False,
                 fps: float = 24.0):
        self.width, self.height, self.is_hdr, self.fps = width, height, is_hdr, fps
        self._bytes_per_sample = 2 if is_hdr else 1
        self._frame_bytes = nv12.frame_size_samples(height, width) * self._bytes_per_sample
        self._f, self._own = _open_in(path)

    def __iter__(self):
        return self

    def __next__(self):
        buf = _read_exact(self._f, self._frame_bytes)
        if len(buf) < self._frame_bytes:
            self.close()
            raise StopIteration
        return nv12.unpack(buf, self.height, self.width, is_hdr=self.is_hdr)

    def close(self):
        if self._own:
            self._f.close()


class RawWriter:
    def __init__(self, path: str, *, stride: int | None = None):
        self._f, self._own = _open_out(path)
        self._stride = stride

    def write(self, y: np.ndarray, uv: np.ndarray) -> None:
        self._f.write(nv12.pack(y, uv, self._stride).tobytes())

    def close(self):
        self._f.close() if self._own else self._f.flush()


def _uv_interleaved_to_planar(uv: np.ndarray):
    return uv[:, 0::2], uv[:, 1::2]


def _uv_planar_to_interleaved(u: np.ndarray, v: np.ndarray):
    uv = np.empty((u.shape[0], u.shape[1] * 2), dtype=u.dtype)
    uv[:, 0::2] = u
    uv[:, 1::2] = v
    return uv


class Y4MWriter:
    """YUV4MPEG2 writer; 8-bit C420mpeg2 or 10-bit C420p10 (P010 samples are
    MSB-aligned 10-bit: written as >> 6)."""

    def __init__(self, path: str, width: int, height: int, fps: float, *,
                 is_hdr: bool = False):
        self.width, self.height, self.is_hdr = width, height, is_hdr
        self._f, self._own = _open_out(path)
        rate = Fraction(fps).limit_denominator(1001 * 120)
        cs = "C420p10" if is_hdr else "C420mpeg2"
        self._f.write(
            f"YUV4MPEG2 W{width} H{height} F{rate.numerator}:{rate.denominator} "
            f"Ip A1:1 {cs}\n".encode()
        )

    def write(self, y: np.ndarray, uv: np.ndarray) -> None:
        u, v = _uv_interleaved_to_planar(uv)
        self._f.write(b"FRAME\n")
        # .write(tobytes()) rather than ndarray.tofile: tofile requires a real
        # seekable file and fails on pipes.
        if self.is_hdr:
            for plane in (y, u, v):
                self._f.write((plane.astype(np.uint16) >> 6)
                              .astype("<u2").tobytes())
        else:
            for plane in (y, u, v):
                self._f.write(plane.astype(np.uint8).tobytes())

    def close(self):
        self._f.close() if self._own else self._f.flush()


class Y4MReader:
    def __init__(self, path: str):
        self._f, self._own = _open_in(path)
        header = self._f.readline().decode()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError("not a YUV4MPEG2 file")
        self.width = int(re.search(r"\bW(\d+)", header).group(1))
        self.height = int(re.search(r"\bH(\d+)", header).group(1))
        m = re.search(r"\bF(\d+):(\d+)", header)
        self.fps = int(m.group(1)) / int(m.group(2)) if m else 24.0
        cs = re.search(r"\bC(\S+)", header)
        self.colorspace = cs.group(1) if cs else "420mpeg2"
        if self.colorspace.startswith("420p10"):
            self.is_hdr = True
        elif self.colorspace.startswith("420"):
            self.is_hdr = False
        else:
            raise ValueError(f"unsupported y4m colorspace {self.colorspace}")

    def __iter__(self):
        return self

    def __next__(self):
        marker = self._f.readline()
        if not marker:
            self.close()
            raise StopIteration
        if not marker.startswith(b"FRAME"):
            raise ValueError("bad y4m frame marker")
        w, h = self.width, self.height
        n_y, n_c = w * h, (w // 2) * (h // 2)
        bps = 2 if self.is_hdr else 1
        raw = _read_exact(self._f, (n_y + 2 * n_c) * bps)
        if len(raw) < (n_y + 2 * n_c) * bps:
            self.close()
            raise StopIteration
        if self.is_hdr:
            data = np.frombuffer(raw, dtype="<u2")
            y = (data[:n_y] << 6).astype(np.uint16).reshape(h, w)  # back to MSB-aligned
            u = (data[n_y:n_y + n_c] << 6).astype(np.uint16).reshape(h // 2, w // 2)
            v = (data[n_y + n_c:] << 6).astype(np.uint16).reshape(h // 2, w // 2)
        else:
            data = np.frombuffer(raw, dtype=np.uint8)
            y = data[:n_y].reshape(h, w)
            u = data[n_y:n_y + n_c].reshape(h // 2, w // 2)
            v = data[n_y + n_c:].reshape(h // 2, w // 2)
        return y.copy(), _uv_planar_to_interleaved(u, v)

    def close(self):
        if self._own:
            self._f.close()


# --- ffmpeg gateway (optional) ----------------------------------------------

def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def probe_fps(path: str) -> float | None:
    """Container frame rate via ffprobe — the MediaInfo probe analogue
    (ref: HopperRender.cpp:348-443). Returns None when unavailable."""
    if shutil.which("ffprobe") is None:
        return None
    try:
        out = subprocess.run(
            ["ffprobe", "-v", "error", "-select_streams", "v:0", "-show_entries",
             "stream=r_frame_rate", "-of", "csv=p=0", path],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
        num, _, den = out.partition("/")
        return float(num) / float(den or 1)
    except (subprocess.SubprocessError, ValueError, ZeroDivisionError):
        return None


class FfmpegReader:
    """Decode any container to an NV12/P010 pipe. Requires ffmpeg on PATH."""

    def __init__(self, path: str, *, is_hdr: bool = False, width: int | None = None,
                 height: int | None = None, fps: float | None = None):
        if not have_ffmpeg():
            raise RuntimeError(
                "ffmpeg not found on PATH — use RawReader/Y4MReader for offline files"
            )
        if width is None or height is None:
            probe = subprocess.run(
                ["ffprobe", "-v", "error", "-select_streams", "v:0", "-show_entries",
                 "stream=width,height", "-of", "csv=p=0", path],
                capture_output=True, text=True, timeout=30, check=True,
            ).stdout.strip()
            width, height = (int(x) for x in probe.split(",")[:2])
        self.width, self.height, self.is_hdr = width, height, is_hdr
        self.fps = fps or probe_fps(path) or 24.0
        pix = "p010le" if is_hdr else "nv12"
        self._proc = subprocess.Popen(
            ["ffmpeg", "-v", "error", "-i", path, "-f", "rawvideo",
             "-pix_fmt", pix, "-"],
            stdout=subprocess.PIPE,
        )
        self._frame_bytes = nv12.frame_size_samples(height, width) * (2 if is_hdr else 1)

    def __iter__(self):
        return self

    def __next__(self):
        buf = self._proc.stdout.read(self._frame_bytes)
        if not buf or len(buf) < self._frame_bytes:
            self.close()
            raise StopIteration
        return nv12.unpack(buf, self.height, self.width, is_hdr=self.is_hdr)

    def close(self):
        if self._proc.stdout:
            self._proc.stdout.close()
        self._proc.wait()


class FfmpegWriter:
    """Encode outputs through ffmpeg. Requires ffmpeg on PATH."""

    def __init__(self, path: str, width: int, height: int, fps: float, *,
                 is_hdr: bool = False, codec: str = "libx264"):
        if not have_ffmpeg():
            raise RuntimeError("ffmpeg not found on PATH — use RawWriter/Y4MWriter")
        pix = "p010le" if is_hdr else "nv12"
        self._proc = subprocess.Popen(
            ["ffmpeg", "-v", "error", "-y", "-f", "rawvideo", "-pix_fmt", pix,
             "-s", f"{width}x{height}", "-r", f"{fps}", "-i", "-",
             "-c:v", codec, path],
            stdin=subprocess.PIPE,
        )

    def write(self, y: np.ndarray, uv: np.ndarray) -> None:
        self._proc.stdin.write(nv12.pack(y, uv).tobytes())

    def close(self):
        self._proc.stdin.close()
        self._proc.wait()


def open_reader(path: str, *, width: int | None = None, height: int | None = None,
                is_hdr: bool = False, fps: float | None = None):
    """Dispatch by extension: .y4m, raw (.nv12/.p010/.yuv/.raw), else ffmpeg.
    '-' reads stdin: raw when --width/--height are given, else y4m (the
    self-describing pipe format — e.g. `ffmpeg ... -f yuv4mpegpipe - | ...`)."""
    if path == "-":
        if width is not None and height is not None:
            return RawReader(path, width, height, is_hdr=is_hdr, fps=fps or 24.0)
        return Y4MReader(path)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".y4m":
        return Y4MReader(path)
    if ext in (".nv12", ".p010", ".yuv", ".raw"):
        if width is None or height is None:
            raise ValueError("raw input requires --width and --height")
        return RawReader(path, width, height, is_hdr=is_hdr or ext == ".p010",
                         fps=fps or 24.0)
    return FfmpegReader(path, is_hdr=is_hdr, width=width, height=height, fps=fps)


def open_writer(path: str, width: int, height: int, fps: float, *, is_hdr: bool = False):
    """'-' writes y4m to stdout (self-describing, mpv/ffmpeg-consumable)."""
    if path == "-":
        return Y4MWriter(path, width, height, fps, is_hdr=is_hdr)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".y4m":
        return Y4MWriter(path, width, height, fps, is_hdr=is_hdr)
    if ext in (".nv12", ".p010", ".yuv", ".raw"):
        return RawWriter(path)
    return FfmpegWriter(path, width, height, fps, is_hdr=is_hdr)
