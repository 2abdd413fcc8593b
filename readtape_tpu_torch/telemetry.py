"""Spans and counters inside the decode, kept only while a caller asks.

    from readtape_tpu_torch import telemetry
    with telemetry.recording() as rec:
        decode_tape(samples, opts)
    rec.spans       # [Span], in the order they closed
    rec.counters    # {name: total}
    rec.self_ns()   # {span id: its duration less its children's}

Off (the default) ``span`` and ``count`` test one module-level boolean
and return: no clock read, no record, no profiler call. On, each span
keeps its name, an id, its parent's id (a stack per thread, so client
threads do not mix), the id of the enclosing ``capture`` span,
``time.perf_counter_ns()`` at entry and exit, its attributes (ints and
short strings) and its own counters. Under an active torch.profiler a
span also opens ``record_function("readtape." + name)``, so that it lies
on the profiler's clock beside the card's kernels and copies.

Records stay in memory; the caller of ``recording()`` reads them.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

PREFIX = "readtape."
CAPTURE = "capture"

_on = False
_rec = None
_local = threading.local()


@dataclass
class Span:
    name: str
    id: int
    parent: int | None
    capture: int | None
    t0: int
    t1: int = 0
    attrs: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)

    @property
    def ns(self) -> int:
        return self.t1 - self.t0


class Recording:
    """What one ``recording()`` kept: closed spans and counter totals."""

    def __init__(self):
        self.spans = []
        self.counters = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def self_ns(self) -> dict:
        """Each span's duration less what its children cover, by id."""
        own = {s.id: s.ns for s in self.spans}
        for s in self.spans:
            if s.parent in own:
                own[s.parent] -= s.ns
        return own

    def by_capture(self) -> dict:
        """{capture id: [spans under that capture, the root among them]}."""
        out = {}
        for s in self.spans:
            if s.capture is not None:
                out.setdefault(s.capture, []).append(s)
        return out

    def _add(self, name, n, top):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
            if top is not None:
                top.counters[name] = top.counters.get(name, 0) + n


class _Null:
    """The shared context of a span while nothing records."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _profiling() -> bool:
    return bool(torch.autograd.profiler._is_profiler_enabled)


class _Live:
    __slots__ = ("rec", "span", "rf")

    def __init__(self, rec, name, attrs):
        self.rec = rec
        self.span = Span(name, 0, None, None, 0, attrs=attrs)
        self.rf = None

    def __enter__(self):
        s, st = self.span, _stack()
        s.id = next(self.rec._ids)
        if st:
            s.parent, s.capture = st[-1].id, st[-1].capture
        if s.name == CAPTURE:
            s.capture = s.id
        st.append(s)
        if _profiling():
            self.rf = torch.profiler.record_function(PREFIX + s.name)
            self.rf.__enter__()
        s.t0 = time.perf_counter_ns()
        return s

    def __exit__(self, *exc):
        s = self.span
        s.t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack().pop()
        with self.rec._lock:
            self.rec.spans.append(s)
        return False


def span(name: str, **attrs):
    """A context that records the span `name` while recording is on."""
    if not _on:
        return _NULL
    return _Live(_rec, name, attrs)


def count(name: str, n: int = 1):
    """Add n to the counter `name`, and to the innermost open span's."""
    if not _on:
        return
    st = _stack()
    _rec._add(name, n, st[-1] if st else None)


def wait(site: str, n: int = 1):
    """The span ``wait.<site>`` around a host wait on the card, counted
    as n waits under ``host_waits`` and ``host_waits.<site>``. Inside a
    span with a ``device`` attribute (a mesh's shard) the wait carries
    that device too."""
    if not _on:
        return _NULL
    count("host_waits", n)
    count("host_waits." + site, n)
    dev = next((s.attrs["device"] for s in reversed(_stack())
                if "device" in s.attrs), None)
    return _Live(_rec, "wait." + site, {} if dev is None else
                 {"device": dev})


def spanned(name: str):
    """A decorator: the function's calls are spans of that name."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*a, **k):
            if not _on:
                return fn(*a, **k)
            with _Live(_rec, name, {}):
                return fn(*a, **k)
        return run
    return deco


@contextmanager
def recording():
    """Record every span and counter, in every thread, until exit."""
    global _on, _rec
    if _on:
        raise RuntimeError("telemetry is already recording")
    _rec = Recording()
    _on = True
    try:
        yield _rec
    finally:
        _on = False
