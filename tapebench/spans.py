"""The traced run's wrappers, set on attributes of the program's modules
for the traced phases only and taken off after them.

``Spans`` times each wrapped call with a synchronize on each side and
sums it into the current capture's record (the calls into a layer, as
the benchmark sees them from outside the program). ``Recorder`` notes
each call's arguments and calls through, with no synchronize, so that
the profiled phase is undisturbed. A target that is not there is left
out: its metric then reads nothing.
"""

from __future__ import annotations

import functools
import statistics
import time
from contextlib import contextmanager

import torch


def _resolve(owner, attr):
    return getattr(owner, attr, None) if owner is not None else None


@contextmanager
def patched(targets):
    """targets: [(owner, attribute, make_wrapper(original))]. Sets each
    wrapper that has an original, restores every one on exit."""
    saved = []
    try:
        for owner, attr, make in targets:
            orig = _resolve(owner, attr)
            if orig is None:
                continue
            saved.append((owner, attr, orig))
            setattr(owner, attr, make(orig))
        yield
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


class Spans:
    """Per-capture sums of synchronized spans by name."""

    def __init__(self, sync):
        self.sync = sync
        self.captures = []
        self.current = None

    def begin(self):
        self.current = {}

    def end(self, wall: float):
        self.current["wall"] = wall
        self.captures.append(self.current)
        self.current = None

    def wrap(self, name):
        def make(fn):
            @functools.wraps(fn)
            def timed(*a, **k):
                self.sync()
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    self.sync()
                    if self.current is not None:
                        self.current[name] = (self.current.get(name, 0.0)
                                              + time.perf_counter() - t0)
            return timed
        return make


class Recorder:
    """Each call's first tensor's shape and its number-valued keyword
    arguments, by name, under a profiler label of the same name."""

    def __init__(self):
        self.calls = {}

    def wrap(self, name):
        def make(fn):
            @functools.wraps(fn)
            def noted(*a, **k):
                if a and torch.is_tensor(a[0]):
                    note = {kk: v for kk, v in k.items()
                            if isinstance(v, (int, float, tuple))}
                    note["shape"] = tuple(a[0].shape)
                    self.calls.setdefault(name, []).append(note)
                with torch.profiler.record_function("tapebench." + name):
                    return fn(*a, **k)
            return noted
        return make


def median_ms(spans, *names):
    """The median over captures of the named spans' per-capture sum, in
    ms; None where no capture has them all."""
    vals = [sum(c[n] for n in names) for c in spans
            if all(n in c for n in names)]
    return statistics.median(vals) * 1e3 if vals else None
