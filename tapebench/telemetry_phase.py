"""The traced run's telemetry phase: the program's own spans and counters
(readtape_tpu_torch.telemetry) over the pool, on the device trace's clock.

The pool decodes round-robin for at least CAPTURES captures inside
``telemetry.recording()``, on a card under torch.profiler (CPU and CUDA
activity), with none of the harness's wrappers set. (On the CPU no
profiler runs: its trace would hold no card, and the plain versions'
hundreds of thousands of operations a capture would take minutes to
read.) The phase runs once a traced run, when the first of the metrics
that read it is read: after the three earlier phases and every earlier
metric, so that what those read does not move. It takes the run's program, pool and
list of decodes from the frame of ``harness._run`` (the frame that reads
the metrics), and adds its decodes to that list, so that the reference
check compares them like every other decode. Its result reaches the
readers as ``ctx.telemetry``: a ``Telemetry``, or None where the program
has no telemetry module (its metrics then read nothing) or no run is
found.

On standard error: the card's idle gaps, each labelled by the innermost
program span over its middle, the share of the idle time under a named
span below ``capture``, and every host synchronisation the CUDA runtime
made outside a ``wait.*`` or ``resident.upload`` span.
"""

from __future__ import annotations

import bisect
import contextlib
import statistics
import sys
from dataclasses import dataclass, field

import torch

from . import devtrace, harness

CAPTURES = 16
WINDOW = "tapebench.telemetry"
PREFIX = "readtape."
UNLABELLED = "host, unlabelled"
# CUDA runtime and driver calls: those that launch a kernel, and those
# that block the host until the card has caught up
LAUNCHES = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx",
                      "cudaLaunchCooperativeKernel"))
SYNCS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy",
                   "cuStreamSynchronize", "cuCtxSynchronize"))
# spans in which a synchronisation is expected: the marked waits, and the
# tape's upload, which is its own metric
WAITED = ("wait.", "resident.upload")


@dataclass
class Telemetry:
    """Per capture: {quantity: value}, from the program's records; from
    the profiler: kernel launches inside finish spans per capture (None
    without CUDA runtime events) and the labelled idle gaps."""
    captures: list
    finish_launches: float | None = None
    idle: dict = field(default_factory=dict)
    idle_s: float = 0.0
    window_s: float = 0.0


def per_capture(rec) -> list:
    """For each capture of a Recording: the summed ns of resident.scan,
    resident.upload and the wait.* spans, the host waits counted, and the
    driver's own ns (self time of capture and of the driver.* spans)."""
    own = rec.self_ns()
    out = []
    for spans in rec.by_capture().values():
        c = dict(scan_ns=0, upload_ns=0, wait_ns=0, waits=0, driver_ns=0)
        for s in spans:
            c["waits"] += s.counters.get("host_waits", 0)
            if s.name == "resident.scan":
                c["scan_ns"] += s.ns
            elif s.name == "resident.upload":
                c["upload_ns"] += s.ns
            elif s.name.startswith("wait."):
                c["wait_ns"] += s.ns
            if s.name == "capture" or s.name.startswith("driver."):
                c["driver_ns"] += own[s.id]
        out.append(c)
    return out


def median_ms(tel, key):
    if tel is None or not tel.captures:
        return None
    return statistics.median(c[key] for c in tel.captures) * 1e-6


def innermost(points, spans) -> list:
    """The name of the innermost of the nested (name, start, end) spans
    that covers each point, or None: a sweep, as devtrace.label_of for
    many points."""
    order = sorted(spans, key=lambda s: (s[1], -s[2]))
    idx = sorted(range(len(points)), key=lambda i: points[i])
    out, stack, j = [None] * len(points), [], 0
    for i in idx:
        p = points[i]
        while j < len(order) and order[j][1] <= p:
            while stack and stack[-1][2] <= order[j][1]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and stack[-1][2] <= p:
            stack.pop()
        out[i] = stack[-1][0] if stack else None
    return out


def from_profiler(prof, ncaptures: int) -> dict:
    """The profiled window (the host span WINDOW): device intervals, the
    program's spans, the runtime's launch and synchronisation calls, in
    seconds from the window's start. Returns the finish spans' launches
    per capture, the idle gaps by innermost program span, and the
    unmarked synchronisations by span."""
    dev, host, launch, sync, win = [], [], [], [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = devtrace._ns(ev, "start")
        e = s + (float(ev.duration_ns()) if hasattr(ev, "duration_ns")
                 else float(ev.duration_us()) * 1e3)
        if "CUDA" in str(ev.device_type()):
            if not name.startswith((PREFIX, "tapebench.")):
                dev.append((s, e))
        elif name == WINDOW:
            win = (s, e)
        elif name.startswith(PREFIX):
            host.append((name[len(PREFIX):], s, e))
        elif name in LAUNCHES:
            launch.append(s)
        elif name in SYNCS:
            sync.append(s)
    if win is None:
        raise RuntimeError("the telemetry window's label is missing")
    t0, t1 = win
    fin = sorted((s, e) for n, s, e in host if n == "finish")
    starts = [s for s, _ in fin]
    in_finish = 0
    for t in launch:
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t < fin[k][1]:
            in_finish += 1
    gaps = devtrace.gaps([iv for iv in dev if iv[1] > t0 and iv[0] < t1],
                         t0, t1)
    labels = innermost([0.5 * (a + b) for a, b in gaps], host)
    idle = {}
    for (a, b), lab in zip(gaps, labels):
        lab = lab or UNLABELLED
        idle[lab] = idle.get(lab, 0.0) + (b - a) * 1e-9
    unmarked = {}
    for lab in innermost(sync, host):
        if lab is None or not lab.startswith(WAITED):
            lab = lab or UNLABELLED
            unmarked[lab] = unmarked.get(lab, 0) + 1
    return dict(finish_launches=(in_finish / ncaptures if dev else None),
                idle=idle, idle_s=sum(idle.values()),
                window_s=(t1 - t0) * 1e-9, unmarked=unmarked,
                syncs=len(sync), launches=len(launch))


def _run_locals():
    """The locals of the harness._run frame on the stack, or None."""
    f = sys._getframe(1)
    while f is not None and f.f_code is not harness._run.__code__:
        f = f.f_back
    return None if f is None else f.f_locals


def run(program, captures, decodes) -> Telemetry | None:
    """Decode the pool round-robin for at least CAPTURES captures under the
    profiler and the program's recording; add the decodes to `decodes`."""
    try:
        from readtape_tpu_torch import telemetry
    except ImportError:
        return None
    n = -(-CAPTURES // len(captures)) * len(captures)
    card = program.device == "cuda"
    prof = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if card
        else contextlib.nullcontext())
    outs = []
    program.sync()
    with telemetry.recording() as rec:
        with prof:
            with torch.profiler.record_function(WINDOW):
                for k in range(n):
                    cap = captures[k % len(captures)]
                    outs.append((cap.index, program.decode(cap)))
                program.sync()
    decodes.extend(outs)
    tel = Telemetry(per_capture(rec))
    if not card:
        harness.log(f"telemetry: {n} captures, {len(rec.spans)} spans, "
                    f"no card; counters {dict(sorted(rec.counters.items()))}")
        return tel
    tr = from_profiler(prof, n)
    tel.finish_launches = tr["finish_launches"]
    tel.idle, tel.idle_s, tel.window_s = (tr["idle"], tr["idle_s"],
                                          tr["window_s"])
    named = sum(v for k, v in tel.idle.items()
                if k not in ("capture", UNLABELLED))
    harness.log(
        f"telemetry: {n} captures, {len(rec.spans)} spans; card idle "
        f"{tel.idle_s:.6f} of {tel.window_s:.6f} s, "
        f"{100 * named / tel.idle_s if tel.idle_s else 0.0:.2f}% of it "
        f"under a named span below capture")
    harness.log("telemetry idle gaps by program span (s): " + ", ".join(
        f"{k} {v:.6f}" for k, v in sorted(tel.idle.items(),
                                          key=lambda kv: -kv[1])))
    harness.log(f"telemetry runtime calls: {tr['launches']} launches, "
                f"{tr['syncs']} synchronisations, outside wait.* and "
                f"resident.upload spans: {tr['unmarked']}; counters "
                f"{dict(sorted(rec.counters.items()))}")
    return tel


def of(ctx) -> Telemetry | None:
    """The run's telemetry phase, run by the first reader that asks."""
    if not hasattr(ctx, "telemetry"):
        loc = _run_locals()
        ctx.telemetry = (None if loc is None else
                         run(loc["program"], loc["captures"],
                             loc["decodes"]))
    return ctx.telemetry
