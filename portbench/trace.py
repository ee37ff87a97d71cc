"""The traced run's profiler events, reduced to what the per-layer metrics
read: host spans, device intervals and the traced window.

The events stay in memory; nothing is written to disk.  Times are in
microseconds on the profiler's clock, which the host spans and the device
intervals share.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict

#: The span the harness puts around the traced passes.
WINDOW = "portbench.window"
#: Device-side records that are not device work: the profiler's own buffer,
#: and the device copies of the host annotations.
NOT_DEVICE_WORK = ("Activity Buffer Request",)
ANNOTATION_PREFIXES = ("rans.", "portbench.")


@dataclasses.dataclass
class Trace:
    host: list[tuple[str, float, float]]     # name, start, end
    device: list[tuple[str, float, float]]   # kernels, copies and fills
    window: tuple[float, float]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def clipped(self, intervals):
        lo, hi = self.window
        for name, a, b in intervals:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                yield name, a, b

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device intervals inside the window, sorted."""
        out: list[list[float]] = []
        for _, a, b in sorted(self.clipped(self.device),
                              key=lambda e: e[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def device_s(self, match) -> float:
        """Summed device time of the operations whose name ``match``
        accepts."""
        return sum(b - a for name, a, b in self.clipped(self.device)
                   if match(name)) / 1e6

    def host_s(self, names) -> float:
        """Summed time of the host spans named in ``names``."""
        return sum(b - a for name, a, b in self.clipped(self.host)
                   if name in names) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the device's idle
        time by the host span under way at each gap's midpoint: the
        innermost ``rans.*`` span, else a call's own span, else the
        harness between calls."""
        ops: dict[str, float] = defaultdict(float)
        for name, a, b in self.clipped(self.device):
            ops[name] += (b - a) / 1e6
        mids, lengths = [], []
        edge = self.window[0]
        for a, b in self.busy() + [(self.window[1], self.window[1])]:
            if a > edge:
                mids.append((edge + a) / 2)
                lengths.append((a - edge) / 1e6)
            edge = max(edge, b)
        gaps: dict[str, float] = defaultdict(float)
        for name, length in zip(self._hosts_at(mids), lengths):
            gaps[name] += length

        def top_of(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]
        return {"device_ops": top_of(ops), "idle_gaps": top_of(gaps)}

    def _hosts_at(self, times) -> list[str]:
        """For each of the ascending ``times``, the innermost ``rans.*``
        span that holds it (of those that do, the latest to start, then
        the first to end), else ``call outside rans spans`` where another
        span but the window holds it, else ``harness``.

        One sweep over every span: each span enters a heap when a time
        reaches its start and leaves once a time passes its end, since
        the times only grow."""
        spans = sorted(self.clipped(self.host), key=lambda e: e[1])
        rans: list[tuple[float, float, str]] = []
        other: list[tuple[float, float, str]] = []
        out, i = [], 0
        for t in times:
            while i < len(spans) and spans[i][1] <= t:
                name, a, b = spans[i]
                i += 1
                if name != WINDOW:
                    heapq.heappush(rans if name.startswith("rans.")
                                   else other, (-a, b, name))
            for heap in (rans, other):
                while heap and heap[0][1] < t:
                    heapq.heappop(heap)
            out.append(rans[0][2] if rans else
                       "call outside rans spans" if other else "harness")
        return out


def from_profiler(events) -> Trace:
    """Reduce ``torch.profiler.profile(...).events()``."""
    from torch.autograd import DeviceType

    host, device, window = [], [], None
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            if e.name == WINDOW:
                window = (a, b)
            elif e.name.startswith(ANNOTATION_PREFIXES):
                host.append((e.name, a, b))
        elif (e.name not in NOT_DEVICE_WORK
              and not e.name.startswith(ANNOTATION_PREFIXES)):
            device.append((e.name, a, b))
    if window is None:
        raise RuntimeError(f"the profiler recorded no {WINDOW} span")
    return Trace(host, device, window)
