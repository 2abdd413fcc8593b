"""Reading a torch.profiler trace of the card: the union of device
intervals (busy time: overlapping kernels and copies count once), device
time by kernel name, and the breakdown's longest operations and idle
gaps."""

from __future__ import annotations

from dataclasses import dataclass, field


def union_seconds(intervals) -> float:
    """Length of the union of [start, end) intervals (any unit)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi):
    """The idle stretches of [lo, hi) outside the union of intervals:
    [(start, end)]."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def label_of(gap, spans) -> str:
    """The innermost labelled host span covering the gap's middle."""
    mid = 0.5 * (gap[0] + gap[1])
    best = None
    for name, s, e in spans:
        if s <= mid < e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return best[0] if best else "host, unlabelled"


@dataclass
class DeviceTrace:
    """A profiled stretch: device intervals in seconds from its start,
    host labels, and its length."""
    window_s: float
    device: list = field(default_factory=list)   # (name, start, end)
    host: list = field(default_factory=list)     # (label, start, end)
    launches: dict = field(default_factory=dict)  # recorder's calls

    @property
    def busy_s(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.device])

    def kernel_seconds(self, device_name: str) -> float:
        return sum(e - s for n, s, e in self.device if device_name in n)

    def breakdown(self, top: int = 10) -> dict:
        by = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s)
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        idle = {}
        for g in gaps([(s, e) for _, s, e in self.device], 0.0,
                      self.window_s):
            lab = label_of(g, self.host)
            idle[lab] = idle.get(lab, 0.0) + (g[1] - g[0])
        gl = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in gl]}


def _ns(ev, what):
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(ev, what + "_us")()) * 1e3


def from_profiler(prof, prefix: str, launches: dict) -> DeviceTrace:
    """A DeviceTrace from a finished torch.profiler.profile whose window
    is the host span labelled prefix + "window"; the other labels with
    the prefix name the host's work in the idle gaps."""
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        end = start + (float(ev.duration_ns()) if hasattr(ev, "duration_ns")
                       else float(ev.duration_us()) * 1e3)
        if "CUDA" in str(ev.device_type()):
            # a label's device-side twin (gpu_user_annotation) is no work
            if not ev.name().startswith(prefix):
                dev.append((ev.name(), start, end))
        elif ev.name().startswith(prefix):
            host.append((ev.name()[len(prefix):], start, end))
    win = [(s, e) for n, s, e in host if n == "window"]
    if not win:
        raise RuntimeError("the profiled window's label is missing")
    t0, t1 = win[0]
    window_s = (t1 - t0) * 1e-9

    def rel(rows):
        return [(n, max((s - t0) * 1e-9, 0.0), min((e - t0) * 1e-9, window_s))
                for n, s, e in rows if e > t0 and s < t1]
    return DeviceTrace(window_s, rel(dev),
                       [r for r in rel(host) if r[0] != "window"], launches)
