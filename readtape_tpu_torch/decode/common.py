"""Shared constants and numeric helpers for the decode engine
(counterpart of readtape_tpu/decode/common.py).

Times inside the decode are float32 sample units relative to the start of
the segment, as in the JAX package. The state-dict helpers below work on
tensors with any leading batch shape (one entry per lane), so the plain
scans vectorize over segments x parmsets x tracks; rings carry one extra
trailing axis. Operation order follows the JAX functions exactly: the
decode is held to them bit for bit.

Constant values mirror decoder.h:101-155.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

F32 = torch.float32
I32 = torch.int32

PKWW_MAX_WIDTH = 50
PKWW_PEAKHEIGHT = 4.0          # nominal peak-to-peak volts for rise scaling
PEAK_THRESHOLD = 0.005         # volts defining "same peak" (refine interp)
AGC_MAX_WINDOW = 10
AGC_MAX_VALUE = 2.0
AGC_STARTBASE = 5              # peaks 5..15 measure the baseline height
AGC_ENDBASE = 15
CLKRATE_WINDOW = 50

NRZI_IBG_SECS = 200e-6
NRZI_MIN_BLOCK = 10
NRZI_MAX_MISMATCH = 10
NRZI_BADTRK_FACTOR = 2.0
GCR_IDLE_THRESH = 6.0
GCR_IBG_SECS = 200e-6
PE_IDLE_FACTOR = 2.5
PE_IBG_SECS = 200e-6
PE_IGNORE_POSTBITS = 5
PE_MIN_PREBITS = 70
PE_MAX_POSTBITS = 40
WW_CLKSTOP_BITS = 1.5
WW_PEAKSCLOSE_BITS = 0.5
WW_PEAKSFAR_BITS = 2.0
WW_MAX_CLK_VARIATION = 0.10
MAXBLOCK = 131072

FLT_MAX = float(np.float32(3.4028235e38))

_INT_FIELDS = ("clk_window", "agc_window")


@dataclasses.dataclass(frozen=True)
class ParmArrays:
    """Parmset values as stacked tensors, one entry per parmset: the batch
    axis that replaces the reference's sequential retry-with-reseek loop
    (readtape.c:1755-1795)."""
    clk_window: torch.Tensor     # int32 [P]
    clk_alpha: torch.Tensor      # f32 [P]
    agc_window: torch.Tensor     # int32 [P]
    agc_alpha: torch.Tensor      # f32 [P]
    min_peak: torch.Tensor       # f32 [P]
    clk_factor: torch.Tensor     # f32 [P]
    pulse_adj: torch.Tensor      # f32 [P]
    pkww_bitfrac: torch.Tensor   # f32 [P]
    pkww_rise: torch.Tensor      # f32 [P]
    midbit: torch.Tensor         # f32 [P]
    z1pt: torch.Tensor           # f32 [P]
    z2pt: torch.Tensor           # f32 [P]

    @staticmethod
    def from_parmsets(ps, device) -> "ParmArrays":
        return ParmArrays.from_numpy(
            {f.name: np.asarray([getattr(p, f.name) for p in ps.sets])
             for f in dataclasses.fields(ParmArrays)}, device)

    @staticmethod
    def from_numpy(d: dict, device) -> "ParmArrays":
        """Build the parmset tensors from numpy arrays keyed by field name,
        e.g. ``{f: np.asarray(getattr(jax_pa, f)) ...}`` of the JAX
        package's ParmArrays, so both packages decode with the same
        parameters."""
        out = {}
        for f in dataclasses.fields(ParmArrays):
            dt = I32 if f.name in _INT_FIELDS else F32
            arr = np.array(d[f.name],
                             np.int32 if dt == I32 else np.float32)
            out[f.name] = torch.as_tensor(arr, device=device)
        return ParmArrays(**out)

    def select(self, idx) -> "ParmArrays":
        """The parmsets at `idx` (a list of indices), in that order."""
        ix = torch.as_tensor(list(idx), dtype=torch.long,
                             device=self.clk_window.device)
        return ParmArrays(**{f.name: getattr(self, f.name)[ix]
                             for f in dataclasses.fields(self)})


def pkww_width_for(bitfrac: float, bpi: float, ips: float, deltat: float) -> int:
    """Peak-window width in samples (readtape.c:1455-1457)."""
    if bpi <= 0:
        return 8
    return max(2, min(PKWW_MAX_WIDTH, int(bitfrac / (bpi * ips * deltat))))


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=like.device)


def fdiv(a, b) -> torch.Tensor:
    """a / b as an IEEE f32 division on every device. PyTorch computes
    ``scalar / tensor`` as ``reciprocal(tensor) * scalar``, and on CUDA
    turns division by a host scalar into a multiplication by its
    reciprocal; both differ from the JAX package in the last bit. So both
    operands become tensors on one device first."""
    if not torch.is_tensor(a):
        a = torch.as_tensor(a, dtype=F32, device=b.device)
    if not torch.is_tensor(b) or b.device != a.device:
        b = torch.as_tensor(b, dtype=F32, device=a.device)
    return torch.div(a, b)


def fma(a, b, c) -> torch.Tensor:
    """a * b + c in f32 with ONE rounding, on any device.

    The JAX package's XLA scans, compiled for the CPU, contract the
    reference's ``a*x + (1-a)*y`` and ``x + y*z`` updates into fused
    multiply-adds; the port does the same at the same places so both
    packages decode bit for bit alike (the CUDA kernel uses fmaf() there
    and is built with --fmad=false everywhere else). Computed in f64: the
    product is exact there, and a sum that lands exactly on an f32
    rounding tie is nudged by its TwoSum error so it rounds like the
    exact value."""
    dev = (a if torch.is_tensor(a) else b if torch.is_tensor(b) else c).device
    a64, b64, c64 = (torch.as_tensor(x, device=dev).to(torch.float64)
                     for x in (a, b, c))
    p = a64 * b64
    s = p + c64
    t = s - p
    err = (p - (s - t)) + (c64 - t)
    r = s.to(F32)
    away = torch.where(s > r.to(torch.float64), np.inf, -np.inf).to(F32)
    tie = s == (r.to(torch.float64) + torch.nextafter(r, away).to(
        torch.float64)) / 2
    toward = torch.where(err > 0, np.inf, -np.inf).to(torch.float64)
    s = torch.where(tie & (err != 0), torch.nextafter(s, toward), s)
    return s.to(F32)


# ---------------------------------------------------------------------------
# AGC: automatic gain control (decoder.c:500-531)
# ---------------------------------------------------------------------------

def agc_state_init(shape, device, agc_ring: int = AGC_MAX_WINDOW):
    """AGC state for lanes of `shape`; agc_ring: ring size (only the
    largest active parmset's agc_window entries are ever read)."""
    def full(v, dt=F32):
        return torch.full(tuple(shape), v, dtype=dt, device=device)
    return dict(
        agc_gain=full(1.0),
        v_avg_height=full(PKWW_PEAKHEIGHT),
        v_avg_height_sum=full(0.0),
        v_avg_height_count=full(0, I32),
        v_heights=torch.zeros(tuple(shape) + (agc_ring,), dtype=F32,
                              device=device),
        heightndx=full(0, I32),
        max_agc_gain=full(0.0),
        min_agc_gain=full(FLT_MAX),
        v_lasttop=full(0.0),
        v_lastbot=full(0.0),
        peakcount=full(0, I32),
    )


def _ring_set(ring, ndx, val):
    return ring.scatter(-1, ndx.long().unsqueeze(-1), val.unsqueeze(-1))


def adjust_agc(st, agc_alpha, agc_window, exp: bool = True,
               win: bool = True):
    """One AGC update; returns the new state dict. Mirrors decoder.c:500-531:
    exponential smoothing when agc_alpha > 0, else min-of-window when
    agc_window > 0, both capped at AGC_MAX_VALUE. exp=False / win=False:
    the caller knows no lane has agc_alpha > 0 / agc_window > 0, so that
    variant is not computed (it would be selected nowhere)."""
    lastheight = st["v_lasttop"] - st["v_lastbot"]
    gain = st["agc_gain"]
    heights = st["v_heights"]
    ndx = st["heightndx"]
    eps = _f32(1e-9, gain)

    # exponential variant
    use_exp = (agc_alpha > 0) & (lastheight > 0)
    if exp:
        g_exp = fdiv(st["v_avg_height"], torch.maximum(lastheight, eps))
        g_exp = fma(agc_alpha, g_exp, (1 - agc_alpha) * st["agc_gain"])
        g_exp = torch.clamp_max(g_exp, AGC_MAX_VALUE)
        gain = torch.where(use_exp, g_exp, gain)

    # min-of-window variant
    use_win = (agc_window > 0) & (lastheight > 0)
    if win:
        heights_w = _ring_set(heights, ndx, lastheight)
        ndx_w = torch.where(ndx + 1 >= agc_window, 0, ndx + 1).to(I32)
        lane = torch.arange(heights.shape[-1], device=heights.device)
        aw = torch.as_tensor(agc_window, device=heights.device)
        minheight = torch.where(lane < aw.unsqueeze(-1), heights_w,
                                FLT_MAX).amin(dim=-1)
        g_win = torch.clamp_max(
            fdiv(st["v_avg_height"], torch.maximum(minheight, eps)),
            AGC_MAX_VALUE)
        gain = torch.where(use_win, g_win, gain)
        heights = torch.where(use_win.unsqueeze(-1), heights_w, heights)
        ndx = torch.where(use_win, ndx_w, ndx)
    changed = use_exp | use_win
    out = dict(st)
    out["agc_gain"] = gain
    out["v_heights"] = heights
    out["heightndx"] = ndx
    out["max_agc_gain"] = torch.where(changed & (gain > st["max_agc_gain"]),
                                      gain, st["max_agc_gain"])
    out["min_agc_gain"] = torch.where(changed & (gain < st["min_agc_gain"]),
                                      gain, st["min_agc_gain"])
    return out


def accumulate_baseline(st, height, agc_window):
    """Accumulate a peak-to-peak height into the baseline average
    (decode_nrzi.c:218-222 and friends)."""
    out = dict(st)
    out["v_avg_height_sum"] = st["v_avg_height_sum"] + height
    out["v_avg_height_count"] = st["v_avg_height_count"] + 1
    out["v_heights"] = _ring_set(st["v_heights"], st["heightndx"], height)
    out["heightndx"] = torch.where(st["heightndx"] + 1 >= agc_window,
                                   0, st["heightndx"] + 1).to(I32)
    return out


def finish_baseline(st):
    """First peak beyond AGC_ENDBASE: freeze the baseline average."""
    out = dict(st)
    cnt = torch.clamp_min(st["v_avg_height_count"], 1)
    out["v_avg_height"] = fdiv(st["v_avg_height_sum"], cnt.to(F32))
    out["v_avg_height_count"] = torch.zeros_like(st["v_avg_height_count"])
    return out


# ---------------------------------------------------------------------------
# clock averaging (decoder.c:533-558); clkavg state is (spacing window, idx,
# current average), all in sample units
# ---------------------------------------------------------------------------

def clkavg_init(spb: float, shape, device, clk_ring: int = CLKRATE_WINDOW):
    """clk_ring: moving-window ring size; only the largest active
    parmset's clk_window entries are ever read (decoder.h:189)."""
    spb32 = float(np.float32(spb))
    return dict(
        t_bitspacing=torch.full(tuple(shape) + (clk_ring,), spb32,
                                dtype=F32, device=device),
        bitndx=torch.zeros(tuple(shape), dtype=I32, device=device),
        t_bitspaceavg=torch.full(tuple(shape), spb32, dtype=F32,
                                 device=device),
    )


def adjust_clock(c, delta, clk_window, clk_alpha, const_spb,
                 win: bool = True, exp: bool = True, avg_fma: bool = False):
    """Mirrors adjust_clock's three strategies: moving window (with the same
    incremental-average update the C uses), exponential, constant.
    win=False / exp=False: the caller knows no lane uses that strategy,
    so it is not computed (it would be selected nowhere). The exponential
    average a * delta + (1 - a) * avg is one fused multiply-add, as XLA's
    CPU build contracts the JAX package's: fma(a, delta, (1 - a) * avg),
    or with avg_fma fma(1 - a, avg, a * delta) (which product XLA fuses
    depends on the program: decode/slot.py)."""
    use_w = torch.as_tensor(clk_window > 0)
    use_e = (~use_w) & (clk_alpha > 0)
    avg = _f32(const_spb, c["t_bitspaceavg"])
    if exp:
        avg_e = (fma(1 - clk_alpha, c["t_bitspaceavg"], clk_alpha * delta)
                 if avg_fma else
                 fma(clk_alpha, delta, (1 - clk_alpha) * c["t_bitspaceavg"]))
        avg = torch.where(use_e, avg_e, avg)
    out = dict(c)
    if win:
        old = c["t_bitspacing"].gather(
            -1, c["bitndx"].long().unsqueeze(-1))[..., 0]
        spc_w = _ring_set(c["t_bitspacing"], c["bitndx"], delta)
        ndx_w = torch.where(c["bitndx"] + 1 >= clk_window, 0,
                            c["bitndx"] + 1).to(I32)
        avg_w = c["t_bitspaceavg"] + fdiv(
            delta - old,
            torch.clamp_min(torch.as_tensor(clk_window), 1).to(F32))
        avg = torch.where(use_w, avg_w, avg)
        out["t_bitspacing"] = torch.where(use_w.unsqueeze(-1), spc_w,
                                          c["t_bitspacing"])
        out["bitndx"] = torch.where(use_w, ndx_w, c["bitndx"])
    out["t_bitspaceavg"] = avg
    return out


def force_clock(c, delta):
    delta = torch.as_tensor(delta, dtype=F32,
                            device=c["t_bitspaceavg"].device)
    return dict(
        t_bitspacing=delta.unsqueeze(-1).expand(
            c["t_bitspacing"].shape).clone(),
        bitndx=c["bitndx"],
        t_bitspaceavg=delta.expand(c["t_bitspaceavg"].shape).clone(),
    )


def parity9(frames: torch.Tensor) -> torch.Tensor:
    """Bit parity of each value (up to 31 bits); int tensor in, {0,1} out."""
    v = frames.to(I32)
    v = v ^ (v >> 16)
    v = v ^ (v >> 8)
    v = v ^ (v >> 4)
    v = v ^ (v >> 2)
    v = v ^ (v >> 1)
    return v & 1
