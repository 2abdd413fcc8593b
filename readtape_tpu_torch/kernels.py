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
        "tr_t", "tr_agc", "bits", "hist", "trk_i", "trk_f", "lane_i")] + [
        (n, ctypes.c_int32) for n in (
            "B", "P", "T", "S", "G", "K", "maxb", "max_slots",
            "max_steps", "do_correct", "exp_par")] + [
        (n, ctypes.c_float) for n in ("spb", "stat_lb", "stat_bw")]


class PeArgs(ctypes.Structure):
    """csrc/pe_core.h::PeArgs, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "volts", "seg_len", "lead", "p_w", "p_agc_window", "p_clk_window",
        "p_rise", "p_minp", "p_agc_alpha", "p_clk_alpha", "p_clk_factor",
        "p_pulse_adj", "wset", "rise_floor", "min_floor", "cand", "rec_i",
        "rec_f", "ie", "scan", "bits", "faked", "hist", "trk_i", "trk_f",
        "lane_i")] + [
        (n, ctypes.c_int32) for n in (
            "B", "P", "T", "S", "G", "K", "maxb", "max_steps")] + [
        (n, ctypes.c_float) for n in ("spb", "stat_lb", "stat_bw")]

# pe_core.h's record and scan-buffer shapes
PE_N_PR, PE_N_PRF, PE_N_PS, PE_IDLE_CAP = 6, 4, 4, 510


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
    lib.nrzi_fused_launch.argtypes = [ctypes.POINTER(NrziArgs),
                                      ctypes.c_void_p]
    lib.nrzi_fused_launch.restype = ctypes.c_int
    lib.pe_fused_launch.argtypes = [ctypes.POINTER(PeArgs), ctypes.c_void_p]
    lib.pe_fused_launch.restype = ctypes.c_int
    return lib


def nrzi_prepare(volts, seg_lens, leads, pa, *, Ws, rise_floor, min_floor,
                 stat_lb, stat_bw, expected_parity, spb, do_correct, maxb,
                 max_slots, K, max_steps):
    """Allocate the outputs and scratch of one nrzi_fused launch on volts'
    device and fill the NrziArgs block. Returns (args, outputs, keep):
    `keep` holds every tensor the launch reads, alive until it is
    enqueued."""
    dev = volts.device
    B, T, S = volts.shape
    P = len(Ws)
    wset = sorted(set(Ws))
    N = B * P
    nw = (S + 31) // 32

    def i32(x):
        return torch.as_tensor(x, dtype=torch.int32, device=dev).contiguous()

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()

    ins = dict(volts=volts.contiguous(), seg_len=i32(seg_lens),
               lead=i32(leads), p_w=i32(list(Ws)),
               p_agc_window=i32(pa.agc_window),
               p_clk_window=i32(pa.clk_window), p_rise=f32(pa.pkww_rise),
               p_minp=f32(pa.min_peak), p_agc_alpha=f32(pa.agc_alpha),
               p_clk_alpha=f32(pa.clk_alpha), p_pulse_adj=f32(pa.pulse_adj),
               p_midbit=f32(pa.midbit), wset=i32(wset),
               rise_floor=f32(rise_floor), min_floor=f32(min_floor))
    scratch = dict(
        cand=torch.empty((N, T, nw), dtype=torch.int32, device=dev),
        tr_s=torch.empty((N, T, K), dtype=torch.int32, device=dev),
        tr_t=torch.empty((N, T, K), dtype=torch.float32, device=dev),
        tr_agc=torch.empty((N, T, K), dtype=torch.float32, device=dev))
    out = dict(
        bits=torch.empty((B, P, T, maxb), dtype=torch.int8, device=dev),
        hist=torch.empty((B, P, T, 50), dtype=torch.int32, device=dev),
        trk_i=torch.empty((B, P, T, 5), dtype=torch.int32, device=dev),
        trk_f=torch.empty((B, P, T, 4), dtype=torch.float32, device=dev),
        lane_i=torch.empty((B, P, 6), dtype=torch.int32, device=dev))
    ptrs = {k: v.data_ptr() for d in (ins, scratch, out) for k, v in d.items()}
    args = NrziArgs(**ptrs, B=B, P=P, T=T, S=S, G=len(wset), K=K, maxb=maxb,
                    max_slots=max_slots, max_steps=max_steps,
                    do_correct=int(bool(do_correct)),
                    exp_par=int(expected_parity), spb=float(spb),
                    stat_lb=float(stat_lb), stat_bw=float(stat_bw))
    return args, out, (ins, scratch)


def nrzi_fused(volts, seg_lens, leads, pa, **kw):
    """Launch csrc/nrzi_fused.cu on volts' CUDA device, on PyTorch's
    current stream (no synchronisation). Arguments and outputs as
    decode.fused.nrzi_fused_scan."""
    lib = load()
    with torch.cuda.device(volts.device):
        args, out, keep = nrzi_prepare(volts, seg_lens, leads, pa, **kw)
        stream = torch.cuda.current_stream(volts.device).cuda_stream
        rc = lib.nrzi_fused_launch(ctypes.byref(args), stream)
    del keep
    if rc != 0:
        raise RuntimeError(f"nrzi_fused kernel launch failed: CUDA error {rc}")
    return out


def pe_prepare(volts, seg_lens, leads, pa, *, Ws, rise_floor, min_floor,
               stat_lb, stat_bw, spb, maxb, K, max_steps):
    """Allocate the outputs and scratch of one pe_fused launch on volts'
    device and fill the PeArgs block. Returns (args, outputs, keep) as
    nrzi_prepare does."""
    dev = volts.device
    B, T, S = volts.shape
    P = len(Ws)
    wset = sorted(set(Ws))
    N = B * P
    nw = (S + 31) // 32

    def i32(x):
        return torch.as_tensor(x, dtype=torch.int32, device=dev).contiguous()

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()

    ins = dict(volts=volts.contiguous(), seg_len=i32(seg_lens),
               lead=i32(leads), p_w=i32(list(Ws)),
               p_agc_window=i32(pa.agc_window),
               p_clk_window=i32(pa.clk_window), p_rise=f32(pa.pkww_rise),
               p_minp=f32(pa.min_peak), p_agc_alpha=f32(pa.agc_alpha),
               p_clk_alpha=f32(pa.clk_alpha),
               p_clk_factor=f32(pa.clk_factor),
               p_pulse_adj=f32(pa.pulse_adj), wset=i32(wset),
               rise_floor=f32(rise_floor), min_floor=f32(min_floor))
    scratch = dict(
        cand=torch.empty((N, T, nw), dtype=torch.int32, device=dev),
        rec_i=torch.empty((N, T, K, PE_N_PR), dtype=torch.int32, device=dev),
        rec_f=torch.empty((N, T, K, PE_N_PRF), dtype=torch.float32,
                          device=dev),
        ie=torch.empty((N, T, PE_IDLE_CAP, 2), dtype=torch.int32,
                       device=dev),
        scan=torch.empty((N, T, PE_N_PS), dtype=torch.int32, device=dev))
    out = dict(
        bits=torch.empty((B, P, T, maxb), dtype=torch.int8, device=dev),
        faked=torch.empty((B, P, T, maxb), dtype=torch.int8, device=dev),
        hist=torch.empty((B, P, T, 50), dtype=torch.int32, device=dev),
        trk_i=torch.empty((B, P, T, 6), dtype=torch.int32, device=dev),
        trk_f=torch.empty((B, P, T, 4), dtype=torch.float32, device=dev),
        lane_i=torch.empty((B, P, 4), dtype=torch.int32, device=dev))
    ptrs = {k: v.data_ptr() for d in (ins, scratch, out) for k, v in d.items()}
    args = PeArgs(**ptrs, B=B, P=P, T=T, S=S, G=len(wset), K=K, maxb=maxb,
                  max_steps=max_steps, spb=float(spb),
                  stat_lb=float(stat_lb), stat_bw=float(stat_bw))
    return args, out, (ins, scratch)


def pe_fused(volts, seg_lens, leads, pa, **kw):
    """Launch csrc/pe_fused.cu on volts' CUDA device, on PyTorch's current
    stream (no synchronisation). Arguments and outputs as
    decode.fused.pe_fused_scan."""
    lib = load()
    with torch.cuda.device(volts.device):
        args, out, keep = pe_prepare(volts, seg_lens, leads, pa, **kw)
        stream = torch.cuda.current_stream(volts.device).cuda_stream
        rc = lib.pe_fused_launch(ctypes.byref(args), stream)
    del keep
    if rc != 0:
        raise RuntimeError(f"pe_fused kernel launch failed: CUDA error {rc}")
    return out
