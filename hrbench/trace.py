"""The traced run's reading of torch.profiler: device activity by kind, the
device's busy time (the union of its kernels, copies and fills), and the
idle gaps labelled by what the host was doing.

The traced window runs from the start of the first "push_frame" span to the
end of the last, the harness's own spans around its calls into the program
(hrbench/drivers/). A device gap is labelled "<span>/<innermost host event>":
the harness's span that covers its middle and the latest-starting host event
(an operator or a CUDA runtime call) that covers it too.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

import torch

SPANS = ("push_frame", "harness.bookkeeping")
TOP = 10


@dataclasses.dataclass
class Trace:
    """Device intervals inside the traced window, in seconds."""

    kernels: list          # (name, seconds)
    h2d: list              # seconds of each host-to-device copy
    d2h: list              # seconds of each device-to-host copy
    other_copies: list     # device-to-device copies and fills, seconds
    busy_s: float
    window_s: float
    device_ops: list       # [[name, seconds]] the TOP names by device time
    idle_gaps: list        # [[label, seconds]] the TOP labels by idle time

    @property
    def events(self) -> int:
        return len(self.kernels) + len(self.h2d) + len(self.d2h) + len(self.other_copies)


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters; copies and fills keep theirs."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    base = re.sub(r"\(.*$", "", name.split("<", 1)[0])
    return base.split(" ")[-1].split("::")[-1] or name


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label(mid: float, spans, span_starts, host, host_starts) -> str:
    j = bisect.bisect_right(span_starts, mid) - 1
    outer = spans[j][2] if j >= 0 and spans[j][1] >= mid else "outside spans"
    inner = None
    i = bisect.bisect_right(host_starts, mid) - 1
    for s, e, name in reversed(host[max(0, i - 256):i + 1]):
        if e >= mid and name not in SPANS:
            inner = name
            break
    return outer if inner is None else f"{outer}/{inner}"


def reduce(prof) -> Trace | None:
    """The Trace of a finished profiler run, or None without device events."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, host, device = [], [], []
    for e in prof.events():
        iv = (e.time_range.start, e.time_range.end, e.name)
        if e.name in SPANS:   # the profiler repeats each span on the device's timeline
            if e.device_type != cuda:
                spans.append(iv)
        elif e.device_type == cuda:
            device.append(iv)
        else:
            host.append(iv)
    pushes = [s for s in spans if s[2] == "push_frame"]
    if not device or not pushes:
        return None
    w0 = min(s for s, _, _ in pushes)
    w1 = max(e for _, e, _ in pushes)
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    kernels, h2d, d2h, other, by_name = [], [], [], [], {}
    for s, e, n in inside:
        sec = (e - s) / 1e6
        if n.startswith("Memcpy HtoD"):
            h2d.append(sec)
        elif n.startswith("Memcpy DtoH"):
            d2h.append(sec)
        elif n.startswith(("Memcpy", "Memset")):
            other.append(sec)
        else:
            kernels.append((n, sec))
        key = short_name(n)
        by_name[key] = by_name.get(key, 0.0) + sec
    busy = _union([(s, e) for s, e, _ in inside])
    spans.sort()
    host.sort()
    host_starts = [s for s, _, _ in host]
    span_starts = [s for s, _, _ in spans]
    gaps, t = {}, w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            label = _label((s + t) / 2, spans, span_starts, host, host_starts)
            gaps[label] = gaps.get(label, 0.0) + (s - t) / 1e6
        t = max(t, e)
    return Trace(kernels=kernels, h2d=h2d, d2h=d2h, other_copies=other,
                 busy_s=sum(e - s for s, e in busy) / 1e6, window_s=(w1 - w0) / 1e6,
                 device_ops=_top(by_name), idle_gaps=_top(gaps))


def _top(seconds: dict) -> list:
    return [[k, v] for k, v in sorted(seconds.items(), key=lambda kv: -kv[1])[:TOP]]
