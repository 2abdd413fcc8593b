"""One run of one cell: set-up, the measured window, the traced phases
(with --trace 1), the check against the plain reference, and the result.

The program is readtape_tpu_torch, driven through its public entry
points: ``decode.pipeline.decode_tape(samples, opts, device=...)`` per
capture, ``kernels.load`` at set-up, ``parallel.mesh`` for a
configuration that names a mesh.
"""

from __future__ import annotations

import gc
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from . import check, devtrace, manifest, spans as spans_mod, synth
from .pool import make_pool

FORBIDDEN = ("jax", "jaxlib", "flax", "readtape_tpu")
LABELS = "tapebench."
# set-up decodes the pool round-robin for at least this long (every
# capture at least once), so the window starts on a warm host and card
WARM_SECONDS = 3.0
# segments of the checked capture that the reference decodes, besides
# its longest and its last
CHECK_SEGMENTS = 12


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def p90(values):
    """The 90th percentile of all values (Python's inclusive quantiles)."""
    if len(values) < 2:
        return float(values[0])
    return float(statistics.quantiles(values, n=10, method="inclusive")[8])


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def option_kwargs(config: dict) -> dict:
    """The decode options of a configuration, as keyword arguments that
    both the program's DecodeOptions and the reference's Options take:
    the tape's own (mode, tracks, density, speed, sample period, full
    scale) from its description, and every key of its `decode` group as
    it stands."""
    tape = dict(mode=synth.ENCODINGS[config["encoding"]],
                ntrks=int(config["tracks"]), bpi=float(config["bpi"]),
                ips=float(config["ips"]),
                deltat=1.0 / float(config["sample_rate_hz"]),
                maxvolts=float(config["maxvolts"]))
    decode = dict(config["decode"])
    clash = sorted(set(decode) & (set(tape) | {"parmsets"}))
    if clash:
        raise ValueError(f"decode options {clash} come from the tape's "
                         f"description or the built-in parmsets")
    return {**tape, **decode}


def _options(cls, config: dict, side: str):
    try:
        return cls(**option_kwargs(config))
    except TypeError as e:
        raise ValueError(f"{config['name']}: an option {side} does not "
                         f"take: {e}") from None


class Program:
    """The system under test, as one cell runs it."""

    def __init__(self, config: dict, device: str):
        from readtape_tpu_torch.decode import pipeline
        self.pl = pipeline
        self.device = device
        self.config = config
        self.opts = _options(pipeline.DecodeOptions, config, "the program")
        self.kernel_path = config["kernel_path"]
        self.mesh_devices = []
        mesh = config["mesh"]
        if mesh:
            from readtape_tpu_torch.parallel import mesh as pmesh
            n = int(mesh["data"]) * int(mesh["parm"])
            devs = pmesh.visible_devices(device)
            if len(devs) < n:
                raise RuntimeError(f"the mesh needs {n} devices, "
                                   f"{len(devs)} visible")
            self.mesh_devices = devs[:n]
            pmesh.set_decode_mesh(pmesh.make_decode_mesh(
                self.mesh_devices, parm_axis=int(mesh["parm"])))

    def load_kernels(self):
        if self.device == "cuda":
            from readtape_tpu_torch import kernels
            return kernels.build()[1], kernels.load()
        return 0.0, None

    def decode(self, capture):
        return self.pl.decode_tape(capture.samples, self.opts,
                                   device=self.device,
                                   kernel_path=self.kernel_path)

    def sync(self):
        if self.device == "cuda":
            for d in self.mesh_devices or [None]:
                torch.cuda.synchronize(d)

    def memory_peak(self):
        if self.device != "cuda":
            return 0
        devs = self.mesh_devices or [torch.cuda.current_device()]
        return max(int(torch.cuda.max_memory_allocated(d)) for d in devs)

    def close(self):
        if self.mesh_devices:
            from readtape_tpu_torch.parallel import mesh as pmesh
            pmesh.set_decode_mesh(None)

    # the traced phases' targets: (owner, attribute, name)
    def span_targets(self):
        pl = self.pl
        return [(pl, "_resident_tape", "resident"),
                (pl.TapeDecoder, "dispatch_segment_batch", "dispatch"),
                (getattr(pl, "nrzi_mod", None), "nrzi_finish", "finish"),
                (getattr(pl, "pe_mod", None), "pe_finish", "finish"),
                (pl, "_fetch", "fetch")]

    def kernel_targets(self):
        fused = getattr(self.pl, "fused_mod", None)
        return [(fused, "nrzi_fused_scan", "nrzi_fused_scan"),
                (fused, "pe_fused_scan", "pe_fused_scan")]

    def launch_count(self) -> int:
        """Sum of the kernel wrappers' .launches counters."""
        total = 0
        for mod in {id(m): m for m in (
                getattr(self.pl, n, None) for n in
                ("fused_mod", "scan_mod", "slot_mod", "zeros_mod"))
                if m is not None}.values():
            for v in vars(mod).values():
                n = getattr(v, "launches", None)
                if callable(v) and isinstance(n, int):
                    total += n
        return total


def closed_loop(program, captures, clients: int, seconds: float,
                record=None):
    """`clients` closed loops (threads, each on its own CUDA stream, one
    process on the card), each decoding its share of the pool round-robin,
    back to back, for `seconds`. Returns (records, t_start): a record
    (capture index, t0, t1, (blocks, stats)) per capture that completed
    inside the window. A capture still running at the window's end is
    finished but not kept."""
    done, lock = [], threading.Lock()
    t_start = time.perf_counter()
    deadline = t_start + seconds

    def client(c):
        mine = captures[c::clients] or captures
        stream = (torch.cuda.Stream() if program.device == "cuda"
                  and clients > 1 else None)
        k = 0
        while time.perf_counter() < deadline:
            cap = mine[k % len(mine)]
            k += 1
            if record is not None:
                record.begin()
            t0 = time.perf_counter()
            if stream is None:
                out = program.decode(cap)
            else:
                with torch.cuda.stream(stream):
                    out = program.decode(cap)
            t1 = time.perf_counter()
            if record is not None:
                record.end(t1 - t0)
            if t1 > deadline:
                break
            with lock:
                done.append((cap.index, t0, t1, out))
                # what the harness keeps is no work for the collector
                # of the program's own garbage
                gc.freeze()

    if clients == 1:
        client(0)
    else:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    gc.unfreeze()
    done.sort(key=lambda r: r[2])
    return done, t_start


def rate_msps(done, captures, t_start) -> float:
    """Sample rows of every capture completed in the window over the time
    from its start to the last completion."""
    if not done:
        return None
    rows = sum(captures[i].samples.shape[0] for i, *_ in done)
    return rows / (done[-1][2] - t_start) / 1e6


def profiled_round(program, captures):
    """One round of the pool under torch.profiler, each call into a layer
    labelled and each kernel launch's shapes noted (no synchronize)."""
    rec = spans_mod.Recorder()
    targets = [(o, a, rec.wrap(n)) for o, a, n in
               program.span_targets() + program.kernel_targets()]
    acts = [torch.profiler.ProfilerActivity.CPU]
    if program.device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    outs = []
    with spans_mod.patched(targets):
        program.sync()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(LABELS + "window"):
                for cap in captures:
                    outs.append((cap.index, program.decode(cap)))
                program.sync()
    kernels = {n: rec.calls.get(n, []) for _, _, n in program.kernel_targets()}
    return devtrace.from_profiler(prof, LABELS, kernels), outs


def spanned(program, captures, seconds):
    """A closed loop of one client with the span wrappers on."""
    sp = spans_mod.Spans(program.sync)
    targets = [(o, a, sp.wrap(n)) for o, a, n in program.span_targets()]
    launches0 = program.launch_count()
    with spans_mod.patched(targets):
        done, _ = closed_loop(program, captures, 1, seconds, record=sp)
    n = len(sp.captures)
    launches = (program.launch_count() - launches0) / n if n else None
    return sp.captures, launches, done


class Context:
    """What the per-layer readers read (metrics/<name>.py)."""

    def __init__(self, walls, spans, launches_per_capture, stats, trace):
        self.walls = walls                  # seconds, per capture
        self.spans = spans                  # per capture: {layer: seconds}
        self.launches_per_capture = launches_per_capture
        self.stats = stats                  # decode_tape's stats dicts
        self.trace = trace                  # devtrace.DeviceTrace or None


def checked_capture(pool_size: int, seed: int) -> int:
    """The pool capture whose decodes the reference checks, from the seed."""
    return int(np.random.default_rng([int(seed), 7]).integers(pool_size))


def checked_segments(segments, seed: int) -> list:
    """The checked capture's sampled segments, from the seed:
    CHECK_SEGMENTS at random, its longest and its last."""
    rng = np.random.default_rng([int(seed), 8])
    n = len(segments)
    picks = set(rng.choice(n, size=min(CHECK_SEGMENTS, n),
                           replace=False).tolist())
    picks.add(max(range(n), key=lambda i: segments[i][1] - segments[i][0]))
    picks.add(n - 1)
    return sorted(picks)


def reference_options(config):
    """The reference's options for a configuration; a ValueError where
    it asks for an option the reference does not implement."""
    from .reference import decode as ref
    return _options(ref.Options, config, "the reference")


def reference_check(config, captures, decodes, seed):
    """Decode the checked capture's sampled segments with the plain
    reference and compare every decode of that capture in `decodes`
    ([(capture index, (blocks, stats))]): its blocks, and the skew
    delays it decoded them with. Returns the numbers compared, how many
    decodes were compared, the capture, its sampled segments, and the
    items of them on which the decodes' answers are not the reference's
    (the run's `failed`)."""
    from .reference import decode as ref
    ropts = reference_options(config)
    cap = checked_capture(len(captures), seed)
    picks = checked_segments(
        ref.Decoder(captures[cap].samples, ropts).segments(), seed)
    segs, blocks, skew = ref.decode_sample(captures[cap].samples, ropts,
                                           picks)
    differ, gap, n, wrong = 0, 0.0, 0, 0
    for i, (out, stats) in decodes:
        if i != cap:
            continue
        d, g = check.compare(out, blocks, segs, ropts.deltat)
        skewed = check.skew_of(stats) != skew
        if skewed:
            d = len(blocks)
        wrong += check.wrong_items(out, blocks, segs, ropts.deltat, skewed)
        differ, gap, n = differ + d, max(gap, g), n + 1
    return ({"blocks_differ": differ, "float_gap": gap}, n, cap, len(picks),
            wrong)


def execute(workload: str, seed: int, seconds: float, trace: bool, *,
            device: str = "cuda", bench: dict = None, root: str = None,
            t_process: float = None):
    """One run; returns the result dict (the last line's object)."""
    t_process = time.perf_counter() if t_process is None else t_process
    cell = manifest.Cell(bench or manifest.load_bench(), workload,
                         root or manifest.HERE)
    reference_options(cell.config)      # refused before any set-up
    program = Program(cell.config, device)
    try:
        return _run(cell, program, seed, seconds, trace, t_process)
    finally:
        program.close()


def _run(cell, program, seed, seconds, trace, t_process):
    config, traffic = cell.config, cell.traffic
    clients = int(traffic.get("clients", 1))
    if program.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    build_s, _ = program.load_kernels()
    t1 = time.perf_counter()
    captures = make_pool(config, traffic, seed, program.device)
    t2 = time.perf_counter()
    warm = []
    while len(warm) < len(captures) or \
            time.perf_counter() - t2 < WARM_SECONDS:
        cap = captures[len(warm) % len(captures)]
        warm.append((cap.index, program.decode(cap)))
    program.sync()
    t3 = time.perf_counter()
    setup_s = t3 - t_process
    log(f"set-up: {setup_s:.3f} s (imports and card {t0 - t_process:.3f}, "
        f"kernels {t1 - t0:.3f} (built {build_s:.3f}), pool "
        f"{t2 - t1:.3f}, warm-up {t3 - t2:.3f}); pool "
        f"{[c.samples.shape[0] for c in captures]} samples")
    stats0 = warm[0][1][1]
    log(f"warm decode of capture 0: tried {list(stats0['tried'])} chosen "
        f"{list(stats0['chosen'])} blocks {stats0['nblocks']} with errors "
        f"{stats0['nerrblocks']} skew {check.skew_of(stats0)}")

    metrics = {}
    decodes = []
    if not trace:
        done, t_start = closed_loop(program, captures, clients, seconds)
        decodes = [(i, out) for i, _, _, out in done]
        walls = [b - a for _, a, b, _ in done]
        msps = rate_msps(done, captures, t_start)
        values = {"decode_msps": msps, "setup_s": setup_s,
                  "capture_p90_ms": p90(walls) * 1e3 if walls else None}
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        thirds = [statistics.median(walls[k * len(walls) // 3:
                                          (k + 1) * len(walls) // 3] or [0])
                  * 1e3 for k in range(3)]
        log(f"window: {len(done)} captures, {msps} Msamples/s, "
            f"p50 {statistics.median(walls) * 1e3 if walls else None} ms, "
            f"p90 {values['capture_p90_ms']} ms; p50 by thirds {thirds} ms; "
            f"warm-up {len(warm)} decodes")
        tr = None
    else:
        done, _ = closed_loop(program, captures, clients, seconds / 2)
        walls = [b - a for _, a, b, _ in done]
        tr, outs = profiled_round(program, captures)
        sp, launches, done2 = spanned(program, captures, seconds / 2)
        decodes = ([(i, out) for i, _, _, out in done + done2]
                   + [(i, out) for i, out in outs])
        ctx = Context(walls, sp, launches,
                      [out[1] for _, out in decodes], tr)
        for m in cell.per_layer:
            v = cell.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        log(f"traced: {len(done)} timed, {len(outs)} profiled, "
            f"{len(done2)} spanned captures; busy {tr.busy_s:.6f} of "
            f"{tr.window_s:.6f} s")

    peak = program.memory_peak()
    if program.device == "cuda":
        torch.cuda.empty_cache()

    attempted = 0
    kinds = dict.fromkeys(check.FAILURE_KINDS, 0)
    per_capture = {}
    for i, (blocks, _stats) in decodes:
        cap = captures[i]
        attempted += len(cap.items)
        per_capture[i] = check.failure_kinds(
            blocks, cap.items, cap.spans,
            1.0 / float(config["sample_rate_hz"]))
        for name, n in per_capture[i].items():
            kinds[name] += n
    log(f"items: {attempted} attempted; against the payloads (what the "
        f"tape lost; failed counts answers that are not the reference's) "
        f"{kinds}; "
        f"per pool capture {dict(sorted(per_capture.items()))}")
    t4 = time.perf_counter()
    numbers, ncompared, cap_i, npicks, failed = reference_check(
        config, captures, decodes, seed)
    log(f"reference check: capture {cap_i}, {npicks} segments, "
        f"{ncompared} decodes compared, {failed} items failed, "
        f"{time.perf_counter() - t4:.3f} s")
    correct = ncompared > 0 and check.verdict(numbers)
    limits = {k: {"value": numbers[k], "limit": check.LIMITS[k]}
              for k in check.LIMITS}
    limits["decodes_compared"] = {"value": ncompared, "limit": "at least 1"}
    device = {"platform": "gpu" if program.device == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name()
                       if program.device == "cuda" else "cpu"),
              "count": max(1, len(program.mesh_devices)),
              "memory_peak_bytes": peak,
              "power_limit_w": (power_limit()
                                if program.device == "cuda" else None)}
    # last, once the reference has run: nothing the program, the check or
    # the reference loaded may be jax or the JAX package
    mods = forbidden_modules()
    if mods:
        raise RuntimeError(f"forbidden modules loaded: {mods}")
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["check"] = limits
    for k, v in limits.items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    return result
