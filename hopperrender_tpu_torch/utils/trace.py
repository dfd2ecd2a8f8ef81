"""The port's tracer: spans and counters on the served path, kept in memory.

Process-wide and off by default. While off, span() returns one shared
no-op context after a single flag test and count() returns at once: no
allocation, no clock read. While on, each finished span becomes a Record:

    trace.enable(True)
    with trace.span(trace.FRAME):
        with trace.span("server.egress"):
            trace.count(trace.HOST_SYNC, 2)
    records = trace.drain()     # the finished records, oldest exit first
    trace.enable(False)

A span opened with no open span on its thread starts a new request id;
the spans under it share that id, so every span of one source frame
carries one identifier. Times are time.perf_counter_ns(), the clock the
benchmark stamps its own calls with. count() adds to the innermost open
span of the calling thread (and is dropped where none is open).

enable(True, keep=False) keeps no records: each finished span is only
added to sums by name, which per_frame() reads, so a live stream's
`--stats` holds the same few numbers however long it runs.

Nothing is written or logged while serving, and no profiler range is
opened: a profiler repeats its ranges on the device's timeline, where a
trace reader would take them for device work.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple

HOST_SYNC = "host_sync"   # one for each host wait on work already queued on the device
FRAME = "server.push_frame"   # the span of one source frame through FrameServer.push_frame


class Record(NamedTuple):
    request: int      # shared by a root span and every span under it
    span: int
    parent: int       # 0 for a root span
    name: str
    thread: int
    t0_ns: int
    t1_ns: int
    counters: dict    # name -> total, over the span's own extent


_OFF = contextlib.nullcontext()   # what span() returns while the tracer is off
_on = False
_keep = True
_ids = itertools.count(1)
_local = threading.local()
# Finished spans as flat tuples of ints and strings, each counter's name and
# total appended: the garbage collector stops tracking such a tuple, so a
# window's records do not lengthen its collections.
_records: collections.deque = collections.deque()
# Without keep: span name -> [spans, ns, host syncs], folded under the lock.
_sums: dict[str, list[int]] = {}
_sums_lock = threading.Lock()


class _Span:
    __slots__ = ("name", "request", "span", "parent", "counters", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.span = next(_ids)
        if stack:
            top = stack[-1]
            self.request, self.parent = top.request, top.span
        else:
            self.request, self.parent = self.span, 0
        self.counters = {}
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _local.stack.pop()
        if not _keep:
            with _sums_lock:
                sums = _sums.setdefault(self.name, [0, 0, 0])
                sums[0] += 1
                sums[1] += t1 - self.t0
                sums[2] += self.counters.get(HOST_SYNC, 0)
            return False
        rec = (self.request, self.span, self.parent, self.name, threading.get_ident(),
               self.t0, t1)
        for item in self.counters.items():
            rec += item
        _records.append(rec)
        return False


def enable(on: bool, *, keep: bool = True) -> None:
    """Turn the tracer on or off for the whole process. With keep, each
    finished span is kept as a Record for drain(); without, it is only
    added to the sums by name that per_frame() reads. Spans already open
    when it turns off still finish."""
    global _on, _keep
    _on, _keep = bool(on), bool(keep)


def span(name: str):
    """A context manager around one step of the served path."""
    if not _on:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` of the calling thread's innermost open span."""
    if not _on:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        counters = stack[-1].counters
        counters[name] = counters.get(name, 0) + n


def drain() -> list[Record]:
    """The finished records since the last drain, in the order they closed;
    clears them. A record another thread finishes meanwhile is kept for the
    next drain."""
    out = []
    for _ in range(len(_records)):
        rec = _records.popleft()
        out.append(Record(*rec[:7], dict(zip(rec[7::2], rec[8::2]))))
    return out


def per_frame(root: str = FRAME) -> dict:
    """What `--stats` prints of the sums that spans finished without keep
    added up since the last call (which it clears): stages_ms, the mean host
    ms of each span name over the source frames (the spans named `root`,
    one a frame pushed), and host_syncs_per_frame."""
    with _sums_lock:
        sums = dict(_sums)
        _sums.clear()
    frames = sums.get(root, (0,))[0]
    if not frames:
        return {"stages_ms": {}, "host_syncs_per_frame": 0.0}
    return {"stages_ms": {k: v[1] / frames / 1e6 for k, v in sorted(sums.items())},
            "host_syncs_per_frame": sum(v[2] for v in sums.values()) / frames}
