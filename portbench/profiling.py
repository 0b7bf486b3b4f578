"""Reduction of a ``torch.profiler`` window to what the per-layer metrics
read: the device's busy time as the union of its kernels' and copies'
intervals, each device activity's time and count, the class of a kernel
by its name, and the device's idle gaps named by what the host was doing.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

K1 = "K1 nstep_returns"
K2 = "K2 vtrace_returns"
CONV = "convolution"
GEMM = "GEMM"
COPY = "copy/set"
ELEMENTWISE = "elementwise/reduction"
SCAN = 256  # host events looked back over for the one covering a gap


def kernel_class(name: str) -> str:
    """The class of a device activity by its name."""
    n = name.lower()
    if "nstep" in n:
        return K1
    if "vtrace" in n:
        return K2
    if any(k in n for k in ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                            "implicit", "winograd", "fft")):
        return CONV
    if any(k in n for k in ("gemm", "nvjet", "cublas", "cutlass", "splitk")):
        return GEMM
    if "memcpy" in n or "memset" in n:
        return COPY
    return ELEMENTWISE


def merge(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    """Sorted, merged copies of ``(start, end)`` intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclass
class Activity:
    name: str
    start_s: float
    end_s: float


@dataclass
class Window:
    """A profiled stretch of ``iterations`` iterations lasting ``window_s``
    on the host's clock."""
    iterations: int
    window_s: float
    device: List[Activity]
    host: List[Activity]
    by_name: Dict[str, List[float]] = field(default_factory=dict)
    by_class: Dict[str, List[float]] = field(default_factory=dict)
    busy_s: float = 0.0

    def __post_init__(self):
        self.busy_s = sum(b - a for a, b in merge(
            (e.start_s, e.end_s) for e in self.device))
        for e in self.device:
            for table, key in ((self.by_name, e.name),
                               (self.by_class, kernel_class(e.name))):
                row = table.setdefault(key, [0.0, 0])
                row[0] += e.end_s - e.start_s
                row[1] += 1

    def class_seconds(self, *classes: str) -> float:
        return sum(self.by_class.get(c, [0.0, 0])[0] for c in classes)

    def class_count(self, *classes: str) -> int:
        return sum(self.by_class.get(c, [0.0, 0])[1] for c in classes)

    def top_ops(self, n: int = 10, width: int = 96) -> List[list]:
        rows = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:n]
        return [[name[:width], secs] for name, (secs, _) in rows]

    def idle_gaps(self, n: int = 10, width: int = 96) -> List[list]:
        """The device's idle time between its first and last activity,
        each gap named by the latest-starting host event over its middle
        (or "host between events"), summed by name, the largest first."""
        busy = merge((e.start_s, e.end_s) for e in self.device)
        host = sorted((e.start_s, e.end_s, e.name) for e in self.host)
        starts = [h[0] for h in host]
        total: Dict[str, float] = {}
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid, name = (a + b) / 2, "host between events"
            # the latest-starting host event that still covers the middle
            i = bisect.bisect_right(starts, mid)
            for _, end, event in reversed(host[max(0, i - SCAN):i]):
                if end >= mid:
                    name = event
                    break
            total[name[:width]] = total.get(name[:width], 0.0) + (b - a)
        rows = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v] for k, v in rows]


def read_profile(prof, iterations: int, window_s: float) -> Window:
    """A ``Window`` from a finished ``torch.profiler.profile``, read from the
    profiler's own records (building torch's event tree over thousands of
    kernels takes longer than the window)."""
    from torch.autograd import DeviceType

    events = getattr(prof, "profiler", prof).kineto_results.events()
    device, host = [], []
    for e in events:
        act = Activity(e.name(), e.start_ns() / 1e9, e.end_ns() / 1e9)
        if e.device_type() == DeviceType.CUDA:
            device.append(act)
        elif e.device_type() == DeviceType.CPU:
            host.append(act)
    return Window(iterations, window_s, device, host)
