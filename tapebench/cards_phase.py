"""The traced run's per-card phase: each card's own busy time, the
card-to-card copies, and the program's spans and counters of a decode
mesh (readtape_tpu_torch).

A profiled trace holds every card's kernels and copies, each with its
device index; devtrace keeps the intervals and drops the index, so the
union it takes lets one busy card hide three idle ones. This phase keeps
the index, and keeps the card-to-card copies (``Memcpy PtoP``) apart.
The pool decodes round-robin for at least CAPTURES captures inside
``telemetry.recording()`` (where the program has it) and, on a card,
under torch.profiler (CPU and CUDA activity), with none of the
harness's wrappers set. The phase runs once a traced run, when the first
of the metrics that read it is read, and only after the telemetry phase
(``telemetry_phase.of``), so that every earlier reading is as before. As
that phase does, it takes the run's program, pool and list of decodes
from the frame of ``harness._run`` and adds its decodes to that list, so
that the reference check compares them like every other decode. Its
result reaches the readers as ``ctx.cards``: a ``Cards``, or None where
no run is found.

On standard error: each card's busy time, its idle gaps, each labelled
by the innermost program span over its middle, and its longest gap with
its place in the window; and per device, the program's shard spans
(dispatch.shard, fetch.shard, wait.*) per capture.
"""

from __future__ import annotations

import contextlib
import statistics
from dataclasses import dataclass, field

import torch

from . import devtrace, harness, telemetry_phase

CAPTURES = 16
WINDOW = "tapebench.cards"
# device-side twins of the program's and the harness's labels: no work
LABELS = (telemetry_phase.PREFIX, "tapebench.")
# kineto's name of a copy from one card to another
PEER = "Memcpy PtoP"


@dataclass
class Cards:
    """The profiled window's device intervals by card (seconds from the
    window's start; every card of the cell listed, one with no work as an
    empty list, and nothing without a card), the union of its
    card-to-card copies in seconds, the captures it held, and per capture
    the program's dispatch.pad_lanes (None where the program has no such
    counter)."""
    intervals: dict = field(default_factory=dict)
    window_s: float = 0.0
    peer_s: float = 0.0
    captures: int = 0
    pad_lanes: list | None = None


def card_idle_pct(cards: Cards):
    """The mean over the cards of each card's idle share of the window,
    in % (one card: device.idle_pct's arithmetic)."""
    if cards is None or cards.window_s <= 0 or not any(
            cards.intervals.values()):
        return None
    return statistics.mean(
        100.0 * (1.0 - devtrace.union_seconds(iv) / cards.window_s)
        for iv in cards.intervals.values())


def overlap(cards: Cards):
    """The cards' busy times summed, over the union of all their busy
    time: 1.0 where they take turns, n where n work at once."""
    if cards is None or not any(cards.intervals.values()):
        return None
    every = [iv for ivs in cards.intervals.values() for iv in ivs]
    return (sum(devtrace.union_seconds(iv)
                for iv in cards.intervals.values())
            / devtrace.union_seconds(every))


def peer_ms(cards: Cards):
    """The card-to-card copies' time a capture, in ms: the union of the
    window's Memcpy PtoP intervals over its captures (the tape's copies
    to the mesh's other cards and the parmsets' after them); nothing
    where the window has none."""
    if cards is None or cards.peer_s <= 0 or cards.captures <= 0:
        return None
    return 1e3 * cards.peer_s / cards.captures


def pad_lanes(rec):
    """dispatch.pad_lanes for each capture of a Recording; None where no
    capture has it."""
    pads, seen = [], False
    for spans in rec.by_capture().values():
        p = 0
        for s in spans:
            if "dispatch.pad_lanes" in s.counters:
                p += s.counters["dispatch.pad_lanes"]
                seen = True
        pads.append(p)
    return pads if seen else None


def card_index(dev) -> int:
    dev = torch.device(dev)
    return dev.index if dev.index is not None else torch.cuda.current_device()


def from_profiler(prof, cards) -> tuple:
    """The window (the host span WINDOW): each listed card's device
    intervals, every card's card-to-card copies and the program's spans,
    in seconds from the window's start, and the window's length in
    seconds."""
    dev, peer, host, win = {c: [] for c in cards}, [], [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = devtrace._ns(ev, "start")
        e = s + (float(ev.duration_ns()) if hasattr(ev, "duration_ns")
                 else float(ev.duration_us()) * 1e3)
        if "CUDA" in str(ev.device_type()):
            if name.startswith(PEER):
                peer.append((s, e))
            if not name.startswith(LABELS) and ev.device_index() in dev:
                dev[ev.device_index()].append((s, e))
        elif name == WINDOW:
            win = (s, e)
        elif name.startswith(telemetry_phase.PREFIX):
            host.append((name[len(telemetry_phase.PREFIX):], s, e))
    if win is None:
        raise RuntimeError("the per-card window's label is missing")
    t0, t1 = win

    def rel(a, b):
        return (max(a - t0, 0.0) * 1e-9, (min(b, t1) - t0) * 1e-9)
    def within(iv):
        return [rel(s, e) for s, e in iv if e > t0 and s < t1]
    return ({c: within(iv) for c, iv in dev.items()}, within(peer),
            [(n, *rel(s, e)) for n, s, e in host if e > t0 and s < t1],
            (t1 - t0) * 1e-9)


def _log_cards(cards: Cards, host, ncaptures):
    for c, iv in sorted(cards.intervals.items()):
        busy = devtrace.union_seconds(iv)
        gaps = devtrace.gaps(iv, 0.0, cards.window_s)
        idle, longest = {}, (0.0, 0.0, None)
        for (a, b), lab in zip(gaps, telemetry_phase.innermost(
                [0.5 * (a + b) for a, b in gaps], host)):
            lab = lab or telemetry_phase.UNLABELLED
            idle[lab] = idle.get(lab, 0.0) + (b - a)
            longest = max(longest, (b - a, a, lab))
        harness.log(
            f"cards: card {c} busy {busy:.6f} of {cards.window_s:.6f} s "
            f"over {ncaptures} captures; longest gap {longest[0]:.6f} s "
            f"at {longest[1]:.6f} s under {longest[2]}; idle gaps by "
            f"program span (s): "
            + ", ".join(f"{k} {v:.6f}" for k, v in
                        sorted(idle.items(), key=lambda kv: -kv[1])[:10]))


def _log_shards(rec, ncaptures):
    by = {}
    for s in rec.spans:
        dev = s.attrs.get("device")
        if dev is not None:
            key = (dev, s.name)
            by[key] = by.get(key, 0) + s.ns
    if by:
        harness.log("cards: per device, ms a capture: " + "; ".join(
            f"{d} {n} {ns * 1e-6 / ncaptures:.3f}"
            for (d, n), ns in sorted(by.items())))


def run(program, captures, decodes) -> Cards:
    """Decode the pool round-robin for at least CAPTURES captures under
    the profiler (on a card) and the program's recording (where it has
    one); add the decodes to `decodes`."""
    try:
        from readtape_tpu_torch import telemetry
        recording = telemetry.recording()
    except ImportError:
        recording = contextlib.nullcontext()
    n = -(-CAPTURES // len(captures)) * len(captures)
    card = program.device == "cuda"
    cards = sorted({card_index(d) for d in
                    program.mesh_devices or ["cuda"]}) if card else []
    prof = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if card
        else contextlib.nullcontext())
    outs = []
    program.sync()
    with recording as rec:
        with prof:
            with torch.profiler.record_function(WINDOW):
                for k in range(n):
                    cap = captures[k % len(captures)]
                    outs.append((cap.index, program.decode(cap)))
                program.sync()
    decodes.extend(outs)
    out = Cards(captures=n)
    if rec is not None:
        out.pad_lanes = pad_lanes(rec)
        _log_shards(rec, n)
    if card:
        out.intervals, peer, host, out.window_s = from_profiler(prof, cards)
        out.peer_s = devtrace.union_seconds(peer)
        _log_cards(out, host, n)
    harness.log(f"cards: {n} captures on {len(cards)} cards; "
                f"card.idle_pct {card_idle_pct(out)}, mesh.overlap "
                f"{overlap(out)}; card-to-card copies ms a capture "
                f"{peer_ms(out)}; dispatch.pad_lanes a capture "
                f"{out.pad_lanes}")
    return out


def of(ctx) -> Cards | None:
    """The run's per-card phase, run by the first reader that asks, after
    the telemetry phase."""
    if not hasattr(ctx, "cards"):
        telemetry_phase.of(ctx)
        loc = telemetry_phase._run_locals()
        ctx.cards = (None if loc is None else
                     run(loc["program"], loc["captures"], loc["decodes"]))
    return ctx.cards
