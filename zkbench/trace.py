"""Device time from a torch.profiler trace: the union of the device's
operation intervals (busy), the gaps between them (idle) labelled by what
the host was doing, and the device time by operation name.

The interval arithmetic is a frozen copy of chip_smoke.py's
``prove_profiled`` (sort the kernels' intervals, merge overlaps, sum the
union), extended with the gaps and their labels.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """Sorted, merged intervals covering the same time."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def busy(intervals: Sequence[Interval]) -> float:
    return sum(b - a for a, b in union(intervals))


def gaps(intervals: Sequence[Interval], start: float,
         end: float) -> List[Interval]:
    """The idle stretches of [start, end] outside the intervals."""
    out, t = [], start
    for a, b in union(intervals):
        a, b = max(a, start), min(b, end)
        if b <= a:
            continue
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if end > t:
        out.append((t, end))
    return out


def idle_share(intervals: Sequence[Interval], start: float,
               end: float) -> float:
    """Percent of [start, end] in which no device operation ran."""
    inside = [(max(a, start), min(b, end)) for a, b in intervals
              if min(b, end) > max(a, start)]
    return 100.0 * (1.0 - busy(inside) / (end - start))


def top(totals: Dict[str, float], k: int = 10) -> List[list]:
    return [[name, v] for name, v in Counter(totals).most_common(k)]


class Summary:
    """A traced window: device ops as (name, start, end) in seconds on the
    host clock (perf_counter), the window's bounds, and a labeller of host
    time for the idle gaps."""

    def __init__(self, ops: List[Tuple[str, float, float]], start: float,
                 end: float, label: Optional[Callable[[float], str]] = None):
        self.ops = [op for op in ops if op[2] > start and op[1] < end]
        self.start, self.end = start, end
        self.label = label or (lambda t: "host")

    @property
    def intervals(self) -> List[Interval]:
        return [(max(a, self.start), min(b, self.end))
                for _, a, b in self.ops]

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return busy(self.intervals)

    def idle_percent(self) -> float:
        return idle_share(self.intervals, self.start, self.end)

    def seconds_of(self, pieces: Sequence[str]) -> float:
        """Device seconds of the operations whose name holds any piece."""
        return sum(b - a for name, a, b in self.ops
                   if any(p in name for p in pieces))

    def device_ops(self, k: int = 10) -> List[list]:
        totals: Dict[str, float] = Counter()
        for name, a, b in self.ops:
            totals[name[:96]] += b - a
        return top(totals, k)

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Idle seconds by what the host was doing at each gap's middle."""
        totals: Dict[str, float] = Counter()
        for a, b in gaps(self.intervals, self.start, self.end):
            totals[self.label((a + b) / 2)] += b - a
        return top(totals, k)


def device_ops_of(prof, offset: float) -> List[Tuple[str, float, float]]:
    """(name, start, end) of every device operation of a finished
    torch.profiler run, in host seconds: profiler microseconds + offset."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.events():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        out.append((ev.name, ev.time_range.start / 1e6 + offset,
                    ev.time_range.end / 1e6 + offset))
    return out


def marker_offset(prof, name: str, host_t: float) -> Optional[float]:
    """Host seconds less profiler seconds, from a record_function marker
    `name` entered at host time `host_t` (perf_counter)."""
    for ev in prof.events():
        if ev.name == name:
            return host_t - ev.time_range.start / 1e6
    return None
