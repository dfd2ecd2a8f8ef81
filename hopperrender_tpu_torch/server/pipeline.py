"""Pipelined streaming mode: decode thread -> frame ring -> engine thread -> output
ring -> consumer.

PyTorch port of hopperrender_tpu/server/pipeline.py over the port's FrameServer.
The FrameServer builds its engine lazily inside push_frame, which runs on the
engine thread: the first-use kernel build (nvcc) and every CUDA call of the
stream happen there. Any failure on that thread, a kernel's build or launch
included, is raised by outputs() (and by the next feed) as
RuntimeError("engine thread failed"), never taken for the end of the stream.

This is the runtime equivalent of the reference's push-model streaming graph: the
upstream decoder thread pushes samples into the filter while the downstream renderer
consumes from a 5-deep output pool, letting decode, GPU work and presentation overlap
(ref: CTransformFilter::Receive transfrm.cpp:302-380; DecideBufferSize
HopperRender.cpp:529-541). Here the pools are native preallocated rings
(hopperrender_tpu_torch.native.FrameRing) and the engine runs on its own thread so
host decode and device work overlap.

Mid-stream resolution changes renegotiate the rings the way the reference
renegotiates its allocator on a dynamic format change
(ref: CustomInputPin::ReceiveConnection CustomInputPin.cpp:60-183): the side that
owns the push end allocates a replacement pool sized for the new format, enqueues a
renegotiation marker, closes the old ring, and continues on the new one; the pop
side switches rings when it drains the marker. Frames therefore stay strictly
ordered across the change and neither side ever blocks on a stale pool.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from hopperrender_tpu_torch.native import FrameRing, pack as native_pack, unpack as native_unpack
from hopperrender_tpu_torch.server.frame_server import FrameServer, OutputFrame
from hopperrender_tpu_torch.utils import trace
from hopperrender_tpu_torch.utils.logging import get_logger
from hopperrender_tpu_torch.vio import nv12

log = get_logger("pipeline")

_KIND_FRAME = 0
_KIND_RENEGOTIATE = 1


@dataclasses.dataclass
class PipelineStats:
    frames_in: int = 0
    frames_out: int = 0
    input_ring_high_water: int = 0
    renegotiations: int = 0


class PipelinedServer:
    """Threaded wrapper around FrameServer.

    Producer side: feed(y, uv, pts) / feed_packed(buf, pts) — blocks when the input
    pool is full (backpressure, like the upstream pin blocking on the allocator).
    Consumer side: iterate outputs() — yields OutputFrame until close() + drained.
    """

    def __init__(self, server: FrameServer, *, input_slots: int = 8,
                 output_slots: int = 16):
        self.server = server
        self._input_slots = input_slots
        self._output_slots = output_slots
        elem = 2 if server.is_hdr else 1
        slot = nv12.frame_size_samples(server.height, server.width) * elem
        self._in_ring = FrameRing(input_slots, slot)     # producer's current ring
        self._out_ring = FrameRing(output_slots, slot)   # worker's current ring
        self._out_cons = self._out_ring                  # consumer's current ring
        # Renegotiation handoffs: the push side appends the replacement ring BEFORE
        # enqueueing the marker, so the pop side always finds it when the marker
        # arrives (ring FIFO order is the synchronization).
        self._in_handoff: list[FrameRing] = []
        self._out_handoff: list[FrameRing] = []
        self._out_meta: dict[int, OutputFrame] = {}
        self._meta_lock = threading.Lock()
        self._seq = 0
        self.stats = PipelineStats()
        self._error: BaseException | None = None
        # Engine-call heartbeat: device runtimes can HANG (not die) — e.g. a
        # dropped accelerator transport blocks the dispatch RPC forever with
        # no exception for the worker-death propagation to surface. The
        # engine thread stamps _busy_since around each push_frame so the
        # host can detect a wedged device call and report unhealthy.
        self._busy_since: float | None = None
        self._worker = threading.Thread(target=self._run, name="hrt-engine", daemon=True)
        self._worker.start()

    # -- producer -------------------------------------------------------------

    def feed(self, y: np.ndarray, uv: np.ndarray, *, pts: int = -1) -> None:
        h, w = np.asarray(y).shape
        self.feed_packed(native_pack(y, uv), pts=pts, height=h, width=w)

    def feed_packed(self, buf, *, pts: int = -1, height: int = 0,
                    width: int = 0) -> None:
        """Push one packed source frame. height/width describe the frame when it
        differs from the server's current format (0 = current format)."""
        if self._error:
            raise RuntimeError("engine thread failed") from self._error
        data = buf if isinstance(buf, np.ndarray) else np.frombuffer(buf, np.uint8)
        payload = data if data.dtype == np.uint8 else data.view(np.uint8).ravel()
        if payload.nbytes > self._in_ring.slot_bytes:
            # Dynamic format grew past the pool's slot size: renegotiate
            # (ref: CustomInputPin.cpp:60-183).
            log.info("input renegotiation: slot %d -> %d bytes",
                     self._in_ring.slot_bytes, payload.nbytes)
            new_ring = FrameRing(self._input_slots, payload.nbytes)
            old = self._in_ring
            self._in_handoff.append(new_ring)
            old.push(b"", meta=(0, 0, 0, _KIND_RENEGOTIATE), timeout=None)
            old.close()
            self._in_ring = new_ring
            self.stats.renegotiations += 1
        self._in_ring.push(payload, meta=(pts, height, width, _KIND_FRAME),
                           timeout=None)
        self.stats.frames_in += 1
        self.stats.input_ring_high_water = max(
            self.stats.input_ring_high_water, len(self._in_ring))

    def close(self) -> None:
        """No more input; the engine drains, then the output ring closes."""
        self._in_ring.close()

    # -- engine thread ----------------------------------------------------------

    def _emit(self, out: OutputFrame) -> None:
        with self._meta_lock:
            seq = self._seq
            self._seq += 1
            self._out_meta[seq] = out
        payload = native_pack(out.y, out.uv)
        raw = payload.view(np.uint8).ravel()
        if raw.nbytes > self._out_ring.slot_bytes:
            log.info("output renegotiation: slot %d -> %d bytes",
                     self._out_ring.slot_bytes, raw.nbytes)
            new_ring = FrameRing(self._output_slots, raw.nbytes)
            old = self._out_ring
            self._out_handoff.append(new_ring)
            old.push(b"", meta=(-1, 0, 0, _KIND_RENEGOTIATE), timeout=None)
            old.close()
            self._out_ring = new_ring
        self._out_ring.push(raw, meta=(seq, out.start_time, out.end_time,
                                       _KIND_FRAME), timeout=None)
        self.stats.frames_out += 1

    def _run(self) -> None:
        in_ring = self._in_ring
        try:
            while True:
                with trace.span("pipe.frame"):
                    with trace.span("pipe.wait_input"):
                        item = in_ring.pop(timeout=None)
                    if item is None:  # closed and drained
                        if self._in_handoff:  # raced a renegotiation-in-flight
                            in_ring = self._in_handoff.pop(0)
                            continue
                        break
                    buf, meta = item
                    if meta[3] == _KIND_RENEGOTIATE:
                        in_ring = self._in_handoff.pop(0)
                        continue
                    pts = meta[0] if meta[0] >= 0 else None
                    h = int(meta[1]) or self.server.height
                    w = int(meta[2]) or self.server.width
                    with trace.span("pipe.unpack"):
                        y, uv = native_unpack(buf, h, w, is_hdr=self.server.is_hdr)
                    self._busy_since = time.monotonic()
                    try:
                        for out in self.server.push_frame(y, uv, pts=pts):
                            with trace.span("pipe.emit"):
                                self._emit(out)
                    finally:
                        self._busy_since = None
        except BaseException as e:  # surfaced to both producer and consumer
            self._error = e
            log.error("engine thread failed: %s", e)
        finally:
            # Unblock both sides: a producer blocked in push sees the close, and
            # the consumer sees end-of-stream once drained.
            in_ring.close()
            self._in_ring.close()
            self._out_ring.close()

    # -- consumer ---------------------------------------------------------------

    def outputs(self, timeout: float | None = None):
        """Yield OutputFrame objects in presentation order until the stream ends.
        `timeout` bounds each wait: a stall longer than that raises TimeoutError
        (the stream may still be live); end-of-stream returns normally."""
        while True:
            item = self._out_cons.pop(timeout=timeout)
            if item is None:
                if self._error:
                    raise RuntimeError("engine thread failed") from self._error
                if self._out_cons.is_closed() and len(self._out_cons) == 0:
                    if self._out_handoff:  # closed by a renegotiation, not EOS
                        self._out_cons = self._out_handoff.pop(0)
                        continue
                    return
                raise TimeoutError(f"no output frame within {timeout}s")
            _, meta = item
            if meta[3] == _KIND_RENEGOTIATE:
                self._out_cons = self._out_handoff.pop(0)
                continue
            with self._meta_lock:
                out = self._out_meta.pop(meta[0])
            yield out

    def stall_seconds(self) -> float:
        """How long the engine thread has been inside ONE push_frame call
        (0.0 when idle/between frames). A large value means the device call
        itself is wedged — the failure mode a dead accelerator transport
        produces (it blocks rather than raising)."""
        t = self._busy_since
        return 0.0 if t is None else max(0.0, time.monotonic() - t)

    def healthy(self, stall_limit: float = 30.0) -> bool:
        """False once the engine thread failed OR a single device call has
        been stuck past stall_limit seconds. Serving hosts poll this (ref
        analogue: the filter's TooSlow state is a per-frame budget check,
        HopperRender.cpp:1438-1463; this catches the hang class the budget
        check cannot see)."""
        return self._error is None and self.stall_seconds() < stall_limit

    def join(self) -> None:
        self._worker.join()
