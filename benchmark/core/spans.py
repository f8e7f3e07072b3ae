"""Spans and counters around the program's functions, installed only for a
traced run.  A span records (name, start, end) on the host clock and opens
a profiler range ``span:<name>``, so that the device trace can say which
stage the host was in; a span that covers device work ends in
``torch.cuda.synchronize()``.  A counter adds a number computed from each
call's arguments."""
from __future__ import annotations

import functools
import importlib
import time
from collections import defaultdict


def _resolve(target: str):
    """``package.module:Owner.attr`` -> (owner object, attribute name)."""
    mod_name, _, path = target.partition(":")
    owner = importlib.import_module(mod_name)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


class Tracer:
    def __init__(self, sync_device: bool):
        self.sync_device = sync_device
        self.spans = []                 # (name, t0, t1)
        self.counts = defaultdict(float)
        self._undo = []

    def _patch(self, target: str, make):
        owner, attr = _resolve(target)
        orig = owner.__dict__[attr] if attr in vars(owner) else getattr(owner, attr)
        setattr(owner, attr, functools.wraps(orig)(make(orig)))
        self._undo.append((owner, attr, orig))

    def span(self, name: str, target: str, sync: bool) -> None:
        import torch

        sync = sync and self.sync_device

        def make(fn):
            def wrapper(*a, **k):
                t0 = time.perf_counter()
                with torch.profiler.record_function("span:" + name):
                    try:
                        return fn(*a, **k)
                    finally:
                        if sync:
                            torch.cuda.synchronize()
                        self.spans.append((name, t0, time.perf_counter()))
            return wrapper
        self._patch(target, make)

    def counter(self, name: str, target: str, count) -> None:
        def make(fn):
            def wrapper(*a, **k):
                out = fn(*a, **k)
                self.counts[name] += count(a, k, out)
                return out
            return wrapper
        self._patch(target, make)

    def install(self, readers) -> None:
        """Every span and counter the metric readers name, once each."""
        done = set()
        for r in readers:
            sync = set(getattr(r, "SYNC", ()))
            for name, targets in getattr(r, "SPANS", {}).items():
                for t in targets:
                    if (name, t) not in done:
                        done.add((name, t))
                        self.span(name, t, name in sync)
            for name, (target, count) in getattr(r, "COUNTERS", {}).items():
                if (name, target) not in done:
                    done.add((name, target))
                    self.counter(name, target, count)

    def uninstall(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()

    def seconds(self, name: str, t0: float, t1: float) -> float:
        """Summed seconds of ``name`` spans that started in [t0, t1]."""
        return sum(e - s for n, s, e in self.spans if n == name and t0 <= s <= t1)
