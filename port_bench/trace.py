"""The device trace of a ``--trace 1`` run, reduced in memory.

``torch.profiler`` records the card's activity (kernels, copies, sets)
and the host's (aten ops and the harness's own ``bench.*`` spans) over a
sub-window of the measured window.  Nothing is written to disk: the
kineto events are read directly and reduced to the device's busy time,
each kernel's device time by name, the launches, and the idle gaps
labelled by what the host was doing when each began.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation")
NAME_CHARS = 120          # a kernel's name in the breakdown, cut to this


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    launches: int                          # kernels run in the window
    kernel_s: Dict[str, float]             # device seconds by kernel name
    kernel_n: Dict[str, int]
    device_ops: List[Tuple[str, float]]    # top device operations
    idle_gaps: List[Tuple[str, float]]     # idle seconds by host activity


class Profile:
    """Start and stop the profiler between the harness's slices; each
    edge synchronises so the sub-window holds whole rounds and prefills."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        _sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        _sync()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.t1

    def summary(self) -> TraceSummary:
        return reduce_events(_kineto_events(self.prof), self.t1 - self.t0)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _kind(e, on_device: bool) -> str:
    """The event's kineto activity type; a build whose events lack
    ``activity_type`` is told it by the annotation flag and the name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if e.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    if not on_device:
        return "cpu_op"
    name = e.name()
    return ("gpu_memcpy" if name.startswith("Memcpy") else
            "gpu_memset" if name.startswith("Memset") else "kernel")


def _kineto_events(prof):
    cpu = torch.autograd.DeviceType.CPU
    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() != cpu
        out.append((_kind(e, on_device), e.name(), e.start_ns(),
                    e.start_ns() + e.duration_ns(), on_device))
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce_events(events, window_s: float, top: int = 10
                  ) -> Optional[TraceSummary]:
    """``events``: (kind, name, start ns, end ns, on device) tuples over a
    window of ``window_s`` host seconds; busy is the union of the device
    events.  None where the device ran nothing."""
    dev = [(s, e, n, k) for k, n, s, e, on_dev in events
           if on_dev and k in DEVICE_KINDS and e > s]
    if not dev:
        return None
    busy = _union([(s, e) for s, e, _, _ in dev])
    kernel_s: Dict[str, float] = collections.defaultdict(float)
    kernel_n: Dict[str, int] = collections.Counter()
    for s, e, n, _ in dev:
        kernel_s[n] += (e - s) / 1e9
        kernel_n[n] += 1
    launches = sum(k == "kernel" for _, _, _, k in dev)
    host = [(s, e, n) for k, n, s, e, on_dev in events
            if not on_dev and k in HOST_KINDS]
    spans = sorted(h for h in host if h[2].startswith("bench."))
    ops = sorted(h for h in host if not h[2].startswith("bench."))
    idle: Dict[str, float] = collections.defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        idle[_host_label(spans, ops, a)] += (b - a) / 1e9
    return TraceSummary(
        window_s, sum(e - s for s, e in busy) / 1e9, launches,
        dict(kernel_s), dict(kernel_n),
        [(n[:NAME_CHARS], t) for n, t in
         sorted(kernel_s.items(), key=lambda kv: -kv[1])[:top]],
        sorted(idle.items(), key=lambda kv: -kv[1])[:top])


def _covering(events, t: int, depth: int):
    """The latest-starting of the last ``depth`` events starting at or
    before ``t`` that is still running at ``t`` (the innermost), or None."""
    i = bisect.bisect_right(events, (t, float("inf"), ""))
    for s, e, n in reversed(events[max(0, i - depth):i]):
        if e >= t:
            return n
    return None


def _host_label(spans, ops, t: int) -> str:
    """What the host was doing when an idle gap began at ``t``: the
    harness span and the innermost host op running then."""
    span = _covering(spans, t, 8) or "outside the harness's spans"
    op = _covering(ops, t, 64)
    return span if op is None else f"{span} > {op}"
