"""Build, load and launch the port's CUDA kernels.

``nvcc`` compiles each ``csrc/*.cu`` (one compiler process per source,
all started together) and links them into one shared library with a
plain C interface, which ``ctypes`` loads (a source that includes
PyTorch's headers takes minutes to build; this takes seconds). The build
runs at first use, into ``build/torch_kernels/<hash of sources and
flags>/`` next to the package, so a fresh checkout builds everything it
runs. A missing ``nvcc`` or a failed build raises with the compiler's
output: nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

from . import telemetry

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
                     "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libreadtape_kernels.so"


class NrziArgs(ctypes.Structure):
    """csrc/nrzi_core.h::NrziArgs, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "volts", "seg_len", "lead", "p_w", "p_agc_window", "p_clk_window",
        "p_rise", "p_minp", "p_agc_alpha", "p_clk_alpha", "p_pulse_adj",
        "p_midbit", "wset", "rise_floor", "min_floor", "cand", "tr_s",
        "tr_t", "tr_agc", "bits", "hist", "trk_i", "trk_f", "lane_i",
        "stamps")] + [
        (n, ctypes.c_int32) for n in (
            "B", "P", "T", "S", "G", "K", "maxb", "max_slots",
            "max_steps", "do_correct", "exp_par", "wmax")] + [
        (n, ctypes.c_float) for n in ("spb", "stat_lb", "stat_bw")]


class NrziScanArgs(ctypes.Structure):
    """csrc/nrzi_core.h::NrziScanArgs, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "feat", "nxt", "grp", "p_w", "p_agc_window", "p_rise", "p_minp",
        "p_agc_alpha", "tr_s", "tr_t", "tr_agc", "tr_top", "n_admitted",
        "max_agc_gain", "min_agc_gain", "incomplete", "stamps")] + [
        (n, ctypes.c_int32) for n in ("B", "P", "T", "S", "G", "K",
                                      "max_steps")]


class NrziSlotArgs(ctypes.Structure):
    """csrc/nrzi_core.h::NrziSlotArgs, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "tr_s", "tr_t", "tr_agc", "n_admitted", "max_agc_gain",
        "min_agc_gain", "incomplete", "p_clk_window", "p_clk_alpha",
        "p_pulse_adj", "p_midbit", "bits", "hist", "trk_i", "trk_f",
        "lane_i", "stamps", "adj0", "adj", "bitspace", "dbg_slot",
        "col_slot")] + [
        (n, ctypes.c_int32) for n in (
            "B", "P", "T", "S", "K", "maxb", "max_slots", "do_correct",
            "exp_par", "clk_avg_fma")] + [
        (n, ctypes.c_float) for n in ("spb", "stat_lb", "stat_bw")]


class PeArgs(ctypes.Structure):
    """csrc/pe_core.h::PeArgs, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "volts", "seg_len", "lead", "p_w", "p_agc_window", "p_clk_window",
        "p_rise", "p_minp", "p_agc_alpha", "p_clk_alpha", "p_clk_factor",
        "p_pulse_adj", "wset", "rise_floor", "min_floor", "cand", "rec_i",
        "rec_f", "ie", "scan", "bits", "faked", "hist", "trk_i", "trk_f",
        "lane_i", "stamps", "dbg_f", "dbg_i")] + [
        (n, ctypes.c_int32) for n in (
            "B", "P", "T", "S", "G", "K", "maxb", "max_steps", "wmax")] + [
        (n, ctypes.c_float) for n in ("spb", "stat_lb", "stat_bw")]


class GcrArgs(ctypes.Structure):
    """csrc/gcr_core.h::GcrArgs, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "volts", "seg_len", "lead", "p_w", "p_agc_window", "p_clk_window",
        "p_rise", "p_minp", "p_agc_alpha", "p_clk_alpha", "p_z1pt",
        "p_z2pt", "p_pulse_adj", "wset", "rise_floor", "min_floor", "cand",
        "rec_i", "rec_f", "ie", "scan", "bits", "hist", "trk_i", "trk_f",
        "lane_i", "stamps", "dbg_f", "dbg_i")] + [
        (n, ctypes.c_int32) for n in (
            "B", "P", "T", "S", "G", "K", "maxb", "max_steps", "wmax")] + [
        (n, ctypes.c_float) for n in ("spb", "stat_lb", "stat_bw")]


class WwArgs(ctypes.Structure):
    """csrc/ww_core.h::WwArgs, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "volts", "rise_floor", "min_floor", "vah", "cand", "tr_s", "tr_frac",
        "tr_top", "ev_s", "ev_frac", "ev_tt", "chars", "blk_i", "blk_f",
        "hist", "trk_i", "trk_f", "scal", "stamps", "tr_t", "char_t")] + [
        (n, ctypes.c_int32) for n in (
            "T", "S", "W", "K", "maxchars", "maxblocks", "agc_window",
            "clk_window", "fluxdir", "span")] + [
        ("role", ctypes.c_int32 * 6)] + [
        (n, ctypes.c_float) for n in ("rise", "minp", "agc_alpha",
                                      "clk_alpha", "spb", "stat_lb",
                                      "stat_bw")]


class ZcArgs(ctypes.Structure):
    """csrc/zeros_core.h::ZcArgs, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "volts", "seg_len", "lead", "t", "dt", "det", "ok", "is_top",
        "valid", "n_found", "stamps")] + [
        (n, ctypes.c_int32) for n in ("B", "T", "S", "cap", "diff")]


class ZsArgs(ctypes.Structure):
    """csrc/zeros_core.h::ZsArgs, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "t", "dt", "ok", "valid", "p_clk_window", "p_clk_alpha", "p_z1pt",
        "p_z2pt", "p_pulse_adj", "bits", "datacount", "peakcount",
        "t_firstbit", "t_lastbit", "stamps")] + [
        (n, ctypes.c_int32) for n in ("B", "P", "T", "cap", "maxb",
                                      "ring")] + [
        ("spb", ctypes.c_float)]


class ActivityArgs(ctypes.Structure):
    """csrc/activity.cu::ActivityArgs, field for field."""
    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("N", ctypes.c_int64), ("T", ctypes.c_int32),
                ("step", ctypes.c_int32)]


# csrc/activity.cu's chunk (rows a maximum covers) and histogram bins
# (|int16| from 0 to 32768)
ACT_CHUNK, ACT_BINS = 16, 32769
# the record and scan-buffer widths of pe_core.h and gcr_core.h
PE_N_PR, PE_N_PRF, PE_N_PS, PE_IDLE_CAP = 6, 4, 4, 510
# pe_core.h's phase stamps (the PE and GCR kernels): global timer (ns) at
# the start, clock64() at the start and after phases 0, A, B and C, global
# timer at the end, then each of up to 16 tracks' cycles spent walking in
# phase A, then their admission steps
PE_ST_WALK, PE_ST_STEPS, PE_NSTAMP = 7, 7 + 16, 7 + 32
# nrzi_core.h's phase stamps. B1: global timer at the start, clock64() at
# the start and after phases 0, A and B, global timer at the end, then
# each of up to 16 tracks' cycles spent walking in phase A, then the slot
# machine's cycles in each kind of step (NRZI_MACH), summed over the slots.
# B6: global timer, clock64() at the start and end of the slot machine,
# global timer, then its cycles per step as B1's
NRZI_MACH = ("tracks", "realign", "close")
NRZI_ST_WALK, NRZI_ST_MACH = 6, 6 + 16
NRZI_NSTAMP = NRZI_ST_MACH + len(NRZI_MACH)
SLOT_ST_MACH = 4
SLOT_NSTAMP = SLOT_ST_MACH + len(NRZI_MACH)
# B5b's per-lane walk stamps: global timer and clock64() at the walk's
# start and end, the walker's cycles spent walking, its steps; B5a's per
# walker also its cycles at the block's barrier after the chunks it walked
SCAN_ST_G0, SCAN_ST_C0, SCAN_ST_C1, SCAN_ST_G1 = 0, 1, 2, 3
SCAN_ST_WALK, SCAN_ST_STEPS, SCAN_NSTAMP = 4, 5, 6
SCAN_ST_WAIT, SCANA_NSTAMP = 6, 7
# zeros_core.h's stamps. Z1 per (segment, track) lane: global timer and
# clock64() at the start and end, thread 0's cycles in passes A, B and C,
# the buckets pass B stepped over. Z2 per (segment, parmset, track)
# walker: global timer and clock64() at the start and end, its cycles
# walking, the entries it walked, the transitions it emitted
ZC_ST_A, ZC_ST_B, ZC_ST_C, ZC_ST_NB, ZC_NSTAMP = 4, 5, 6, 7, 8
ZS_ST_WALK, ZS_ST_ENT, ZS_ST_STEPS, ZS_NSTAMP = 4, 5, 6, 7
GCR_N_GR = 5
# the launch functions of the library and their argument blocks
LAUNCHES = {"nrzi_fused_launch": NrziArgs, "nrzi_scan_launch": NrziScanArgs,
            "nrzi_scan_tracks_launch": NrziScanArgs,
            "nrzi_slot_launch": NrziSlotArgs, "pe_fused_launch": PeArgs,
            "gcr_fused_launch": GcrArgs, "ww_fused_launch": WwArgs,
            "zerocross_launch": ZcArgs, "gcr_zeros_launch": ZsArgs,
            "activity_scan_launch": ActivityArgs}
# the parmset knobs every kernel reads: argument field -> ParmArrays field
_KNOBS = dict(p_agc_window="agc_window", p_clk_window="clk_window",
              p_rise="pkww_rise", p_minp="min_peak",
              p_agc_alpha="agc_alpha", p_clk_alpha="clk_alpha",
              p_pulse_adj="pulse_adj")
I32, F32, I8 = torch.int32, torch.float32, torch.int8
BIG_S = 2 ** 30            # tr_s fill past each track's admissions
# csrc/nrzi_core.h's per-lane arrays: tracks, the AGC and clock rings
NRZI_MAX_TRACKS, NRZI_MAX_AGC_RING, NRZI_MAX_CLK_RING = 16, 16, 64
# nrzi_core.h's NRZI_CORRECT_*: -correct's parity check in B6
NRZI_CORRECT_OFF, NRZI_CORRECT_RELEASE, NRZI_CORRECT_DEBUG = 0, 1, 2


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels "
                       "from readtape_tpu_torch/csrc)")


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) +
                  glob.glob(os.path.join(CSRC, "*.h")))


@functools.lru_cache(maxsize=None)
def build() -> tuple:
    """Compile csrc into the cached library unless it exists. Returns
    (library path, seconds spent building, compiler log)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    out_dir = os.path.join(BUILD_DIR, h.hexdigest()[:16])
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib):
        return lib, 0.0, ""
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for cu in (p for p in sources() if p.endswith(".cu")):
        obj = os.path.join(out_dir, f"{os.path.basename(cu)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", obj, cu]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            for _, _, other in jobs:
                other.wait()
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    tmp = f"{lib}.{tag}"
    cmd = [nvcc, *ARCH, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({r.returncode}): "
                           f"{' '.join(cmd)}\n{r.stdout}\n{r.stderr}")
    for _, obj, _ in jobs:
        os.remove(obj)
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0, "".join(log)


@functools.lru_cache(maxsize=None)
def load():
    lib = ctypes.CDLL(build()[0])
    for name, struct in LAUNCHES.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(struct), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.ww_fused_phase_ms.argtypes = [ctypes.POINTER(WwArgs), ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_float)]
    lib.ww_fused_phase_ms.restype = ctypes.c_int
    lib.ww_fused_nphase.restype = ctypes.c_int
    return lib


def _require_on(dev, tensors: dict):
    """Raise ValueError naming each tensor of `tensors` (argument field ->
    value) that is not on the launch's device: its pointer would be read
    as another device's memory. Values that are not tensors pass."""
    bad = [k for k, v in tensors.items()
           if torch.is_tensor(v) and v.device != dev]
    if bad:
        raise ValueError(f"{', '.join(bad)}: not on the launch's device "
                         f"{dev}")


def _prepare(struct, volts, seg_lens, leads, pa, *, Ws, rise_floor,
             min_floor, knobs, scratch, out, **scalars):
    """Allocate one launch's scratch and outputs on volts' device and fill
    its argument block `struct`. knobs: the kernel's own parmset knobs
    (argument field -> ParmArrays field) beside _KNOBS; scratch, out:
    name -> (shape, dtype); scalars: the block's remaining integer and
    float fields. Returns (args, outputs, keep): `keep` holds every tensor
    the launch reads, alive until it is enqueued."""
    dev = volts.device
    B, T, S = volts.shape
    wset = sorted(set(Ws))
    knobs = {f: getattr(pa, n) for f, n in dict(_KNOBS, **knobs).items()}
    _require_on(dev, dict(seg_len=seg_lens, lead=leads,
                          rise_floor=rise_floor, min_floor=min_floor,
                          **knobs))

    def put(x, dt):
        return torch.as_tensor(x, dtype=dt, device=dev).contiguous()
    with telemetry.wait("kernel_args", 2):
        widths = put(list(Ws), I32), put(wset, I32)
    ins = dict(volts=volts.contiguous(), seg_len=put(seg_lens, I32),
               lead=put(leads, I32), p_w=widths[0], wset=widths[1],
               rise_floor=put(rise_floor, F32),
               min_floor=put(min_floor, F32))
    for field, x in knobs.items():
        ins[field] = put(x, x.dtype)
    scratch = {k: torch.empty(shape, dtype=dt, device=dev)
               for k, (shape, dt) in scratch.items()}
    out = {k: torch.empty(shape, dtype=dt, device=dev)
           for k, (shape, dt) in out.items()}
    ptrs = {k: v.data_ptr() for d in (ins, scratch, out) for k, v in d.items()}
    args = struct(**ptrs, B=B, P=len(Ws), T=T, S=S, G=len(wset), **scalars)
    return args, out, (ins, scratch)


def _launch(name, prepare, volts, *args, **kw):
    """Prepare and launch the library's <name>_launch on volts' CUDA
    device, on PyTorch's current stream (no synchronisation); raise if the
    launch is refused."""
    lib = load()
    with torch.cuda.device(volts.device):
        block, out, keep = prepare(volts, *args, **kw)
        stream = torch.cuda.current_stream(volts.device).cuda_stream
        rc = getattr(lib, name + "_launch")(ctypes.byref(block), stream)
    del keep
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out


def nrzi_prepare(volts, seg_lens, leads, pa, *, Ws, rise_floor, min_floor,
                 stat_lb, stat_bw, expected_parity, spb, do_correct, maxb,
                 max_slots, K, max_steps):
    """The NrziArgs block, outputs and scratch of one nrzi_fused launch
    (_prepare's return)."""
    B, T, S = volts.shape
    N, P = B * len(Ws), len(Ws)
    return _prepare(
        NrziArgs, volts, seg_lens, leads, pa, Ws=Ws, rise_floor=rise_floor,
        min_floor=min_floor, knobs=dict(p_midbit="midbit"),
        scratch=dict(cand=((N, T, (S + 31) // 32), I32),
                     tr_s=((N, T, K), I32), tr_t=((N, T, K), F32),
                     tr_agc=((N, T, K), F32)),
        out=dict(bits=((B, P, T, maxb), I8), hist=((B, P, T, 50), I32),
                 trk_i=((B, P, T, 5), I32), trk_f=((B, P, T, 4), F32),
                 lane_i=((B, P, 6), I32)),
        K=K, maxb=maxb, max_slots=max_slots, max_steps=max_steps,
        do_correct=int(bool(do_correct)), exp_par=int(expected_parity),
        wmax=max(Ws), spb=float(spb), stat_lb=float(stat_lb),
        stat_bw=float(stat_bw))


def nrzi_fused(volts, seg_lens, leads, pa, **kw):
    """Launch csrc/nrzi_fused.cu. Arguments and outputs as
    decode.fused.nrzi_fused_scan."""
    return _launch("nrzi_fused", nrzi_prepare, volts, seg_lens, leads, pa,
                   **kw)


def _knob_tensors(pa, dev, **fields):
    """The parmset knobs a kernel reads (argument field -> ParmArrays
    field), each a contiguous tensor on dev (ValueError if one is not)."""
    knobs = {f: getattr(pa, n) for f, n in fields.items()}
    _require_on(dev, knobs)
    return {f: x.contiguous() for f, x in knobs.items()}


def nrzi_scan_prepare(feat, nxt, pa, *, Ws, K, max_steps):
    """The NrziScanArgs block and pre-filled outputs of one nrzi_scan
    launch (_prepare's return). Arguments and outputs as
    decode.scan.nrzi_track_scan."""
    dev = feat.device
    G, B, T, S, _ = feat.shape
    P = len(Ws)
    wset = sorted(set(Ws))
    _require_on(dev, dict(nxt=nxt))
    with telemetry.wait("kernel_args", 2):
        grp = torch.as_tensor([wset.index(w) for w in Ws], dtype=I32,
                              device=dev)
        p_w = torch.as_tensor(list(Ws), dtype=I32, device=dev)
    ins = dict(feat=feat.contiguous(), nxt=nxt.to(I32).contiguous(),
               grp=grp, p_w=p_w,
               **_knob_tensors(pa, dev, p_agc_window="agc_window",
                               p_rise="pkww_rise", p_minp="min_peak",
                               p_agc_alpha="agc_alpha"))
    shape = (B, P, T, K)
    out = dict(tr_s=torch.full(shape, BIG_S, dtype=I32, device=dev),
               tr_t=torch.zeros(shape, dtype=F32, device=dev),
               tr_agc=torch.ones(shape, dtype=F32, device=dev),
               tr_top=torch.zeros(shape, dtype=torch.bool, device=dev),
               n_admitted=torch.empty((B, P, T), dtype=I32, device=dev),
               max_agc_gain=torch.empty((B, P, T), dtype=F32, device=dev),
               min_agc_gain=torch.empty((B, P, T), dtype=F32, device=dev),
               incomplete=torch.empty((B, P, T), dtype=torch.bool,
                                      device=dev))
    ptrs = {k: v.data_ptr() for d in (ins, out) for k, v in d.items()}
    args = NrziScanArgs(**ptrs, B=B, P=P, T=T, S=S, G=G, K=K,
                        max_steps=max_steps)
    return args, out, ins


def nrzi_scan(feat, nxt, pa, **kw):
    """Launch csrc/nrzi_scan.cu's B5a entry (parmsets of any widths).
    Arguments and outputs as decode.scan.nrzi_track_scan."""
    return _launch("nrzi_scan", nrzi_scan_prepare, feat, nxt, pa, **kw)


def nrzi_scan_tracks(feat, nxt, pa, **kw):
    """Launch csrc/nrzi_scan.cu's B5b entry (one shared width, G = 1)."""
    return _launch("nrzi_scan_tracks", nrzi_scan_prepare, feat, nxt, pa,
                   **kw)


def nrzi_slot_prepare(tr_s, fin, pa, *, S, spb, expected_parity,
                      do_correct, maxb, max_slots, stat_lb, stat_bw,
                      clk_avg_fma=False, correct_debug=False, adj_init=None,
                      records=False):
    """The NrziSlotArgs block and zeroed outputs of one nrzi_slot launch
    (_prepare's return). fin: nrzi_scan's outputs (tr_s is fin's, first so
    that _launch finds the device). Outputs as decode.slot.nrzi_slot_scan
    (FusedOut, with adj_init "adj" and "bitspace", with records "slot_f"
    and "col_slot")."""
    dev = tr_s.device
    B, P, T, K = tr_s.shape
    ins = {k: fin[k] for k in (
        "tr_s", "tr_t", "tr_agc", "n_admitted", "max_agc_gain",
        "min_agc_gain", "incomplete")}
    _require_on(dev, ins)
    for x in adj_init or ():
        _require_on(dev, dict(adj0=x))
    ins = {k: v.contiguous() for k, v in ins.items()}
    ins.update(_knob_tensors(pa, dev, p_clk_window="clk_window",
                             p_clk_alpha="clk_alpha",
                             p_pulse_adj="pulse_adj", p_midbit="midbit"))
    out = dict(bits=torch.zeros((B, P, T, maxb), dtype=I8, device=dev),
               hist=torch.zeros((B, P, T, 50), dtype=I32, device=dev),
               trk_i=torch.empty((B, P, T, 5), dtype=I32, device=dev),
               trk_f=torch.empty((B, P, T, 4), dtype=F32, device=dev),
               lane_i=torch.empty((B, P, 6), dtype=I32, device=dev))
    if adj_init is not None:
        ins["adj0"] = torch.stack([x.to(F32) for x in adj_init],
                                  dim=-1).contiguous()
        out["adj"] = torch.empty((B, P, T, 2), dtype=F32, device=dev)
        out["bitspace"] = torch.empty((B, P), dtype=F32, device=dev)
    correct = (NRZI_CORRECT_DEBUG if correct_debug else
               NRZI_CORRECT_RELEASE if do_correct else NRZI_CORRECT_OFF)
    ptrs = {k: v.data_ptr() for d in (ins, out) for k, v in d.items()}
    args = NrziSlotArgs(**ptrs, B=B, P=P, T=T, S=S, K=K, maxb=maxb,
                        max_slots=max_slots, do_correct=correct,
                        exp_par=int(expected_parity),
                        clk_avg_fma=int(bool(clk_avg_fma)), spb=float(spb),
                        stat_lb=float(stat_lb), stat_bw=float(stat_bw))
    if records:
        out["slot_f"] = torch.zeros((B, P, max_slots, 2), dtype=F32,
                                    device=dev)
        out["col_slot"] = torch.full((B, P, T, maxb), -1, dtype=I32,
                                     device=dev)
        args.dbg_slot = out["slot_f"].data_ptr()
        args.col_slot = out["col_slot"].data_ptr()
    return args, out, ins


def nrzi_slot(fin, pa, **kw):
    """Launch csrc/nrzi_slot.cu. Arguments and outputs as
    decode.slot.nrzi_slot_scan."""
    return _launch("nrzi_slot", nrzi_slot_prepare, fin["tr_s"], fin, pa,
                   **kw)


def _idle_prepare(struct, knobs, n_rec_i, out, volts, seg_lens, leads, pa,
                  *, Ws, rise_floor, min_floor, stat_lb, stat_bw, spb, maxb,
                  K, max_steps, trace_scan=False):
    """_prepare for the PE and GCR kernels, which share their scratch
    layout: candidacy words, n_rec_i integer and PE_N_PRF float columns
    per record, the idle intervals and the per-track scan results. out:
    the kernel's outputs beyond bits and hist, shapes after [B, P]. With
    trace_scan, the record mode's rows (dbg_f, dbg_i: decode.fused's rec_f,
    rec_i, zeroed) and the scan results (rec_n is their PS_NADM column)
    are outputs too."""
    B, T, S = volts.shape
    N, P = B * len(Ws), len(Ws)
    outs = dict(bits=((B, P, T, maxb), I8), hist=((B, P, T, 50), I32))
    outs.update({k: ((B, P) + tail, dt) for k, (tail, dt) in out.items()})
    args, outs, keep = _prepare(
        struct, volts, seg_lens, leads, pa, Ws=Ws, rise_floor=rise_floor,
        min_floor=min_floor, knobs=knobs,
        scratch=dict(cand=((N, T, (S + 31) // 32), I32),
                     rec_i=((N, T, K, n_rec_i), I32),
                     rec_f=((N, T, K, PE_N_PRF), F32),
                     ie=((N, T, PE_IDLE_CAP, 2), I32),
                     scan=((N, T, PE_N_PS), I32)),
        out=outs, K=K, maxb=maxb, max_steps=max_steps, spb=float(spb),
        stat_lb=float(stat_lb), stat_bw=float(stat_bw))
    if trace_scan:
        dev = volts.device
        outs["rec_f"] = torch.zeros((B, P, T, K, 2), dtype=F32, device=dev)
        outs["rec_i"] = torch.zeros((B, P, T, K, 2), dtype=I32, device=dev)
        args.dbg_f = outs["rec_f"].data_ptr()
        args.dbg_i = outs["rec_i"].data_ptr()
        outs["rec_n"] = keep[1]["scan"].view(B, P, T, PE_N_PS)[..., 0]
    return args, outs, keep


def pe_prepare(volts, seg_lens, leads, pa, **kw):
    """The PeArgs block, outputs and scratch of one pe_fused launch
    (_prepare's return)."""
    T = volts.shape[1]
    args, out, keep = _idle_prepare(
        PeArgs, dict(p_clk_factor="clk_factor"), PE_N_PR,
        dict(faked=((T, kw["maxb"]), I8), trk_i=((T, 6), I32),
             trk_f=((T, 4), F32), lane_i=((4,), I32)),
        volts, seg_lens, leads, pa, **kw)
    args.wmax = max(kw["Ws"])
    return args, out, keep


def pe_fused(volts, seg_lens, leads, pa, **kw):
    """Launch csrc/pe_fused.cu. Arguments and outputs as
    decode.fused.pe_fused_scan."""
    return _launch("pe_fused", pe_prepare, volts, seg_lens, leads, pa, **kw)


def _phase_stamps(name, prepare, nstamp, first, *args, per_track=False,
                  **kw):
    """One <name>_launch with per-lane phase stamps (nstamp int64 each),
    synchronized (for timing only); `first` is the tensor whose device the
    launch runs on. Lanes are (segment, parmset) pairs, or with per_track
    (segment, parmset, track) triples (Z1, without parmsets: (segment,
    track) pairs). Returns (outputs, stamps [lanes, nstamp] on the
    host)."""
    lib = load()
    with torch.cuda.device(first.device):
        block, out, keep = prepare(first, *args, **kw)
        lanes = (block.B * getattr(block, "P", 1)
                 * (block.T if per_track else 1))
        st = torch.zeros((lanes, nstamp), dtype=torch.int64,
                         device=first.device)
        block.stamps = st.data_ptr()
        stream = torch.cuda.current_stream(first.device).cuda_stream
        rc = getattr(lib, name + "_launch")(ctypes.byref(block), stream)
        torch.cuda.synchronize(first.device)
    del keep
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out, st.cpu()


def pe_phase_stamps(volts, seg_lens, leads, pa, **kw):
    """pe_fused with pe_core.h's phase stamps [B*P, PE_NSTAMP]."""
    return _phase_stamps("pe_fused", pe_prepare, PE_NSTAMP, volts, seg_lens,
                         leads, pa, **kw)


def nrzi_phase_stamps(volts, seg_lens, leads, pa, **kw):
    """nrzi_fused with nrzi_core.h's phase stamps [B*P, NRZI_NSTAMP]."""
    return _phase_stamps("nrzi_fused", nrzi_prepare, NRZI_NSTAMP, volts,
                         seg_lens, leads, pa, **kw)


def scan_stamps(feat, nxt, pa, **kw):
    """nrzi_scan (B5a) with nrzi_core.h's walker stamps [B*P*T,
    SCANA_NSTAMP]."""
    return _phase_stamps("nrzi_scan", nrzi_scan_prepare, SCANA_NSTAMP,
                         feat, nxt, pa, per_track=True, **kw)


def scan_tracks_stamps(feat, nxt, pa, **kw):
    """nrzi_scan_tracks (B5b) with nrzi_core.h's walk stamps [B*P*T,
    SCAN_NSTAMP]."""
    return _phase_stamps("nrzi_scan_tracks", nrzi_scan_prepare, SCAN_NSTAMP,
                         feat, nxt, pa, per_track=True, **kw)


def slot_phase_stamps(fin, pa, **kw):
    """nrzi_slot with nrzi_core.h's loop stamps [B*P, SLOT_NSTAMP]."""
    return _phase_stamps("nrzi_slot", nrzi_slot_prepare, SLOT_NSTAMP,
                         fin["tr_s"], fin, pa, **kw)


def gcr_prepare(volts, seg_lens, leads, pa, **kw):
    """The GcrArgs block, outputs and scratch of one gcr_fused launch
    (_prepare's return)."""
    T = volts.shape[1]
    args, out, keep = _idle_prepare(
        GcrArgs, dict(p_z1pt="z1pt", p_z2pt="z2pt"), GCR_N_GR,
        dict(trk_i=((T, 5), I32), trk_f=((T, 4), F32), lane_i=((2,), I32)),
        volts, seg_lens, leads, pa, **kw)
    args.wmax = max(kw["Ws"])
    return args, out, keep


def gcr_phase_stamps(volts, seg_lens, leads, pa, **kw):
    """gcr_fused with pe_core.h's phase stamps [B*P, PE_NSTAMP]."""
    return _phase_stamps("gcr_fused", gcr_prepare, PE_NSTAMP, volts,
                         seg_lens, leads, pa, **kw)


def gcr_fused(volts, seg_lens, leads, pa, **kw):
    """Launch csrc/gcr_fused.cu. Arguments and outputs as
    decode.fused.gcr_fused_scan."""
    return _launch("gcr_fused", gcr_prepare, volts, seg_lens, leads, pa,
                   **kw)


def ww_prepare(volts, *, W, rise_floor, min_floor, v_avg_height, parms, spb,
               stat_lb, stat_bw, K, maxchars, fluxdir, roles, maxblocks,
               span, records=False):
    """The WwArgs block, zeroed outputs and scratch of one ww_fused launch
    (_prepare's return). Arguments as decode.fused.ww_fused_scan; with
    records, tr_t, tr_top (the scratch records, zeroed) and char_t are
    outputs too."""
    dev = volts.device
    T, S = volts.shape
    _require_on(dev, dict(rise_floor=rise_floor, min_floor=min_floor,
                          vah=v_avg_height))

    def put(x):
        return torch.as_tensor(x, dtype=F32, device=dev).contiguous()
    ins = dict(volts=volts.contiguous(), rise_floor=put(rise_floor),
               min_floor=put(min_floor), vah=put(v_avg_height))
    scratch = dict(cand=torch.empty((T, (S + 31) // 32), dtype=I32,
                                    device=dev),
                   tr_s=torch.empty((T, K), dtype=I32, device=dev),
                   tr_frac=torch.empty((T, K), dtype=F32, device=dev),
                   tr_top=torch.empty((T, K), dtype=I8, device=dev),
                   # the merged events; ev_tt padded to whole 4-byte words
                   ev_s=torch.empty((T * K,), dtype=I32, device=dev),
                   ev_frac=torch.empty((T * K,), dtype=F32, device=dev),
                   ev_tt=torch.empty((T * K + 4,), dtype=torch.uint8,
                                     device=dev))
    out = {k: torch.zeros(shape, dtype=dt, device=dev) for k, (shape, dt) in
           dict(chars=((maxchars,), I8), blk_i=((maxblocks, 6), I32),
                blk_f=((maxblocks, 2), F32), hist=((T, 50), I32),
                trk_i=((T, 4), I32), trk_f=((T,), F32),
                scal=((6,), I32)).items()}
    if records:
        scratch["tr_top"].zero_()
        out.update(tr_t=torch.zeros((T, K), dtype=F32, device=dev),
                   tr_top=scratch["tr_top"],
                   char_t=torch.zeros((maxchars,), dtype=F32, device=dev))
    ptrs = {k: v.data_ptr() for d in (ins, scratch, out) for k, v in d.items()}
    args = WwArgs(**ptrs, T=T, S=S, W=W, K=K, maxchars=maxchars,
                  maxblocks=maxblocks,
                  agc_window=int(parms.agc_window),
                  clk_window=int(parms.clk_window), fluxdir=fluxdir,
                  span=span, role=(ctypes.c_int32 * 6)(*roles),
                  rise=parms.pkww_rise, minp=parms.min_peak,
                  agc_alpha=parms.agc_alpha, clk_alpha=parms.clk_alpha,
                  spb=spb, stat_lb=stat_lb, stat_bw=stat_bw)
    return args, out, (ins, scratch)


def ww_fused(volts, **kw):
    """Launch csrc/ww_fused.cu (four kernels on the current stream).
    Arguments and outputs as decode.fused.ww_fused_scan."""
    return _launch("ww_fused", ww_prepare, volts, **kw)


def ww_phase_ms(volts, **kw):
    """One ww_fused call with a CUDA event between its launches and the
    kernels' timing stamps (ww_core.h WW_NSTAMP), synchronized (for timing
    only). Returns (outputs, [ms per launch], stamps [2 T + 4] int64 on
    the host)."""
    lib = load()
    n = lib.ww_fused_nphase()
    ms = (ctypes.c_float * n)()
    with torch.cuda.device(volts.device):
        block, out, keep = ww_prepare(volts, **kw)
        st = torch.zeros((2 * block.T + 4,), dtype=torch.int64,
                         device=volts.device)
        block.stamps = st.data_ptr()
        stream = torch.cuda.current_stream(volts.device).cuda_stream
        rc = lib.ww_fused_phase_ms(ctypes.byref(block), stream, ms)
    del keep
    if rc != 0:
        raise RuntimeError(f"ww_fused kernel launch failed: CUDA error {rc}")
    return out, list(ms), st.cpu()


def zerocross_prepare(volts, seg_lens, leads, *, cap, differentiated):
    """The ZcArgs block and outputs of one zerocross launch (_prepare's
    return). Arguments and outputs as decode.zeros.zerocross_transitions,
    with n_found [B, T] in place of overflow."""
    dev = volts.device
    B, T, S = volts.shape
    _require_on(dev, dict(seg_len=seg_lens, lead=leads))
    ins = dict(volts=volts.contiguous(),
               seg_len=seg_lens.to(dtype=I32).contiguous(),
               lead=leads.to(dtype=I32).contiguous())
    shape = (B, T, cap)
    out = dict(t=torch.empty(shape, dtype=F32, device=dev),
               ok=torch.empty(shape, dtype=torch.bool, device=dev),
               dt=torch.empty(shape, dtype=F32, device=dev),
               det=torch.empty(shape, dtype=I32, device=dev),
               is_top=torch.empty(shape, dtype=torch.bool, device=dev),
               valid=torch.empty(shape, dtype=torch.bool, device=dev),
               n_found=torch.empty((B, T), dtype=I32, device=dev))
    ptrs = {k: v.data_ptr() for d in (ins, out) for k, v in d.items()}
    args = ZcArgs(**ptrs, stamps=None, B=B, T=T, S=S, cap=cap,
                  diff=int(bool(differentiated)))
    return args, out, ins


def zerocross(volts, seg_lens, leads, **kw):
    """Launch csrc/zeros.cu's Z1."""
    return _launch("zerocross", zerocross_prepare, volts, seg_lens, leads,
                   **kw)


def zerocross_stamps(volts, seg_lens, leads, **kw):
    """Z1 with zeros_core.h's stamps [B*T, ZC_NSTAMP]."""
    return _phase_stamps("zerocross", zerocross_prepare, ZC_NSTAMP, volts,
                         seg_lens, leads, per_track=True, **kw)


def gcr_zeros_prepare(t, trans, pa, *, spb, maxb):
    """The ZsArgs block and zeroed outputs of one gcr_zeros launch
    (_prepare's return). trans: Z1's lists (t is trans["t"], first so
    that _launch finds the device). Outputs: bits [B, P, T, maxb],
    datacount, peakcount, t_firstbit, t_lastbit [B, P, T]."""
    dev = t.device
    B, T, cap = t.shape
    P = len(pa.z1pt)
    with telemetry.wait("ring_check"):
        ring = max(1, int(pa.clk_window.max()))    # each walker's clock ring
    if ring > NRZI_MAX_CLK_RING:
        raise ValueError("clk_window beyond the kernel's ring")
    ins = {k: trans[k] for k in ("t", "dt", "ok", "valid")}
    _require_on(dev, ins)
    ins = {k: v.contiguous() for k, v in ins.items()}
    ins.update(_knob_tensors(pa, dev, p_clk_window="clk_window",
                             p_clk_alpha="clk_alpha", p_z1pt="z1pt",
                             p_z2pt="z2pt", p_pulse_adj="pulse_adj"))
    shape = (B, P, T)
    out = dict(bits=torch.zeros(shape + (maxb,), dtype=I8, device=dev),
               datacount=torch.empty(shape, dtype=I32, device=dev),
               peakcount=torch.empty(shape, dtype=I32, device=dev),
               t_firstbit=torch.empty(shape, dtype=F32, device=dev),
               t_lastbit=torch.empty(shape, dtype=F32, device=dev))
    ptrs = {k: v.data_ptr() for d in (ins, out) for k, v in d.items()}
    args = ZsArgs(**ptrs, stamps=None, B=B, P=P, T=T, cap=cap, maxb=maxb,
                  ring=ring, spb=float(spb))
    return args, out, ins


def gcr_zeros(trans, pa, **kw):
    """Launch csrc/zeros.cu's Z2."""
    return _launch("gcr_zeros", gcr_zeros_prepare, trans["t"], trans, pa,
                   **kw)


def gcr_zeros_stamps(trans, pa, **kw):
    """Z2 with zeros_core.h's walker stamps [B*P*T, ZS_NSTAMP]."""
    return _phase_stamps("gcr_zeros", gcr_zeros_prepare, ZS_NSTAMP,
                         trans["t"], trans, pa, per_track=True, **kw)


def activity_prepare(tape, *, step):
    """The ActivityArgs block and zeroed output of one activity_scan
    launch over the int16 tape [N, T] (_prepare's return)."""
    N, T = tape.shape
    out = torch.zeros(N // ACT_CHUNK + ACT_BINS, dtype=I32,
                      device=tape.device)
    args = ActivityArgs(x=tape.data_ptr(), out=out.data_ptr(), N=N, T=T,
                        step=step)
    return args, out, tape


def activity_scan(tape, **kw):
    """Launch csrc/activity.cu. Arguments and output as
    decode.segment.activity_scan."""
    return _launch("activity_scan", activity_prepare, tape, **kw)
