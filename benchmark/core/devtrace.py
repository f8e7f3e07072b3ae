"""What the profiler saw on the device over the traced window.

Reads the profiler's Chrome trace: device activity is every event of
category ``kernel``, ``gpu_memcpy`` or ``gpu_memset``; the window and the
stage spans are the ``span:<name>`` ranges the harness and the tracer open,
on the same clock.  Busy time is the union of device intervals inside the
window."""
from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "span:window"


@dataclass
class DeviceTrace:
    window: Tuple[float, float] = (0.0, 0.0)          # us
    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        iv = sorted((max(s, lo), min(e, hi)) for _, s, e in self.ops
                    if e > lo and s < hi)
        merged = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def op_seconds(self, contains: str) -> float:
        lo, hi = self.window
        return sum(e - s for n, s, e in self.ops
                   if contains in n and lo <= s < hi) * 1e-6

    def top_ops(self, k: int = 10) -> List[list]:
        lo, hi = self.window
        tot: Dict[str, float] = defaultdict(float)
        for n, s, e in self.ops:
            if lo <= s < hi:
                tot[n] += (e - s) * 1e-6
        return [[n, v] for n, v in sorted(tot.items(), key=lambda x: -x[1])[:k]]

    def _stage_at(self, t: float) -> str:
        best, start = "outside_stages", -1.0
        for n, s, e in self.spans:
            if s <= t < e and s > start:
                best, start = n, s
        return best

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The ``k`` longest stretches with nothing on the device, each cut
        at the stage spans' bounds and named by the innermost stage span
        open there (what the host was doing)."""
        lo, hi = self.window
        edges = [lo]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(hi)
        cuts = sorted({t for _, s, e in self.spans for t in (s, e)
                       if lo < t < hi})
        pieces = []
        for i in range(0, len(edges), 2):
            a, b = edges[i], edges[i + 1]
            if b <= a:
                continue
            inner = [t for t in cuts if a < t < b]
            for s, e in zip([a] + inner, inner + [b]):
                name = self._stage_at((s + e) / 2)
                if pieces and pieces[-1][0] == name and pieces[-1][2] == s:
                    pieces[-1][2] = e
                else:
                    pieces.append([name, s, e])
        pieces.sort(key=lambda p: p[1] - p[2])
        return [[n, (e - s) * 1e-6] for n, s, e in pieces[:k]]


def read_chrome_trace(path: str) -> DeviceTrace:
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    t = DeviceTrace()
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        name = ev.get("name", "")
        if ev.get("cat") in DEVICE_CATS:
            t.ops.append((name, s, e))
        elif ev.get("cat") != "user_annotation":
            continue
        elif name == WINDOW:
            t.window = (s, e)
        elif name.startswith("span:"):
            t.spans.append((name[5:], s, e))
    return t
