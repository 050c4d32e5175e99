"""Reduction of a torch.profiler trace of one segment to what the per-layer
readers take: device time and launches by kernel name, the device's busy
time as the union of its operations' intervals, and the idle gaps between
them, each named by the host operation that was running when it began.

Two profiles serve two purposes. `profile_device` records the device's
activity alone, which leaves the host's pace nearly as it is unprofiled:
busy time, the window and kernel times come from it. `profile` records the
host's operations as well, which slows a host-paced segment by a large
factor: only the idle gaps' names come from it."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

SEGMENT = "splatbench.segment"
TOP = 10


class Interval(NamedTuple):
    start: int  # ns
    end: int
    name: str


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    device_ops: Dict[str, Tuple[float, int]]  # name -> (seconds, launches)
    idle_by_host_op: Dict[str, float]          # host op -> idle seconds

    def kernel(self, fragment: str) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds fragment."""
        sec = sum(s for n, (s, _) in self.device_ops.items() if fragment in n)
        launches = sum(c for n, (_, c) in self.device_ops.items() if fragment in n)
        return sec, launches

    def breakdown(self) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1][0])[:TOP]
        gaps = sorted(self.idle_by_host_op.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, (s, _) in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Union of [start, end) intervals, sorted and disjoint."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce(window: Tuple[int, int], device: List[Interval], host: List[Interval]) -> Trace:
    """Everything is clipped to the window (ns)."""
    w0, w1 = window
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    spans = []
    for ev in device:
        s, e = max(ev.start, w0), min(ev.end, w1)
        if e <= s:
            continue
        by_name[ev.name][0] += (e - s) * 1e-9
        by_name[ev.name][1] += 1
        spans.append((s, e))
    busy = merge(spans)
    busy_ns = sum(e - s for s, e in busy)
    gaps, cursor = [], w0
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = e
    if w1 > cursor:
        gaps.append((cursor, w1))
    hosts = sorted(host)
    starts = [h.start for h in hosts]
    idle: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        idle[_host_op_at(hosts, starts, s)] += (e - s) * 1e-9
    return Trace((w1 - w0) * 1e-9, busy_ns * 1e-9,
                 {n: (v[0], int(v[1])) for n, v in by_name.items()}, dict(idle))


def _host_op_at(hosts: List[Interval], starts: List[int], t: int, look_back: int = 256) -> str:
    """The innermost host operation running at t: the latest-starting one
    that spans it."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look_back, -1), -1):
        if hosts[j].end >= t:
            return hosts[j].name
    return "(host between operations)"


def profile_device(fn, sync) -> Trace:
    """Run fn, then sync, under torch.profiler recording the device's
    activity alone; the window is the host clock's time from fn's start to
    sync's end, and every device operation of the profile lies inside it."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile as _profile

    def timed() -> int:
        t = time.perf_counter()
        fn()
        sync()
        return int((time.perf_counter() - t) * 1e9)

    if not torch.cuda.is_available():  # no device to record: the window alone
        return reduce((0, timed()), [], [])._replace(idle_by_host_op={})
    with _profile(activities=[ProfilerActivity.CUDA]) as prof:
        window_ns = timed()
    device = [Interval(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
              for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == torch.autograd.DeviceType.CUDA
              and not ev.is_user_annotation()]
    w0 = min((d.start for d in device), default=0)
    return reduce((w0, w0 + window_ns), device, [])._replace(idle_by_host_op={})


def profile(fn, sync) -> Trace:
    """Run fn, then sync, under torch.profiler (CPU and CUDA) inside a
    SEGMENT span, and reduce the trace over that span."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile, record_function

    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SEGMENT):
            fn()
            sync()
    window, device, host = None, [], []
    for ev in prof.profiler.kineto_results.events():
        iv = Interval(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
        on_device = ev.device_type() == torch.autograd.DeviceType.CUDA
        if ev.name() == SEGMENT:
            if not on_device:
                window = (iv.start, iv.end)
        elif on_device:
            # a span's mirror on the device timeline is no device operation
            if not ev.is_user_annotation():
                device.append(iv)
        else:
            host.append(iv)
    if window is None:
        raise RuntimeError(f"the profiler recorded no {SEGMENT} span")
    return reduce(window, device, host)
