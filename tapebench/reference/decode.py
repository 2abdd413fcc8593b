"""The benchmark's plain reference decode of NRZI and PE captures.

A frozen copy of the block decode of readtape_tpu_torch/decode/pipeline.py
(``_decode_tape_blocks``: segments, the staged retry, NRZI's remainder
rounds or PE's block walk, ``pick_best`` and block emission) over the
plain PyTorch versions of its kernels (``fused.py`` here), on the host.
It imports nothing of the program: the modules beside it are copies.

Two departures, neither of which changes a block:

- ``decode_sample`` decodes only the segments it is given (each with its
  own chain of remainder or walk hops), against the segmentation, height
  estimate and window bucket of the whole capture. A segment's lanes do
  not depend on the other lanes of its batch, so every batch here holds
  all the given segments at once.
- ``volts_dtype`` rounds the volts the scans read to a lower precision
  (torch.bfloat16 for the control); None keeps float32, as the program.

Under the options ``Options`` holds, which are the benchmark's: the
staged retry, the expected parity and ``-deskew`` (its calibration pass,
``calibrate_deskew``, and the per-track delay lines); no -zeros,
-adjskew, -correctdbg, -parmscan or density detection. A configuration
that asks for another option is refused, since ``Options`` has no field
for it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import common as cm
from . import fused as fused_mod
from . import nrzi as nrzi_mod
from . import pe as pe_mod
from . import segment as seg
from .common import F32, I32, ParmArrays
from .parms import MODE_NRZI, MODE_PE, ParmSets, builtin_parmsets

SEG_WARMUP = 64


@dataclass
class Options:
    mode: int = MODE_NRZI
    ntrks: int = 9
    bpi: float = 800.0
    ips: float = 50.0
    deltat: float = 1.28e-6
    maxvolts: float = 6.0
    parmsets: ParmSets = None
    multiple_tries: bool = True
    expected_parity: int = 1
    revparity: int = 0
    deskew: bool = False
    t0_seconds: float = 0.0

    def __post_init__(self):
        if self.parmsets is None:
            self.parmsets = builtin_parmsets(self.mode)

    @property
    def spb(self) -> float:
        return 1.0 / (self.bpi * self.ips * self.deltat)


@dataclass
class Block:
    kind: str
    data: bytes = b""
    parmset: int = 0
    tries: int = 1
    errcount: int = 0
    warncount: int = 0
    detail: dict = field(default_factory=dict)
    t_start: float = 0.0
    t_end: float = 0.0


def _prep_volts(v_i16, maxvolts, volts_dtype, skew):
    """int16 [..., T, S] -> float32 volts, each track delayed by its
    skew [T] samples (decoder.c:819-830's delay lines: the first samples
    repeat sample 0) where any skew is set."""
    scale = float(np.float32(maxvolts) * (np.float32(1) / np.float32(32767)))
    v = v_i16.to(F32) * scale * 1.0
    if volts_dtype is not None:
        v = v.to(volts_dtype).to(F32)
    if not np.any(skew):
        return v
    S = v.shape[-1]
    idx = torch.clamp_min(torch.arange(S) - torch.as_tensor(
        skew, dtype=torch.long).unsqueeze(-1), 0)
    return torch.gather(v, -1, idx.expand(v.shape))


def _segment_volts(tape, offsets, S, maxvolts, volts_dtype, skew):
    idx = offsets.view(-1, 1) + torch.arange(S, device=tape.device)
    v_i16 = tape[:, idx].permute(1, 0, 2)
    return _prep_volts(v_i16, maxvolts, volts_dtype, skew).contiguous()


def _nrzi_results(out, T, expected_parity, revparity, maxb):
    st = fused_mod.fused_state(out)
    r = nrzi_mod.nrzi_finish(st, T, expected_parity, revparity, maxb)
    r["end_s"] = st["end_s"]
    r["unconsumed"] = torch.clamp_min(st["n_admitted"] - st["kvis"],
                                      0).sum(dim=-1).to(I32)
    r["alltrk_max_agc"] = st["max_agc_gain"].amax(dim=-1)
    r["alltrk_min_agc"] = st["min_agc_gain"].amin(dim=-1)
    r["event_overflow"] = st["incomplete"].any(dim=-1)
    return r


def _pe_results(out, seg_lens, T, expected_parity, revparity, maxb):
    st = fused_mod.pe_fused_state(out)
    r = pe_mod.pe_finish(st, T, expected_parity, revparity, maxb)
    B, P = st["tau"].shape
    r["event_overflow"] = st["incomplete"].flatten(1).any(
        dim=-1, keepdim=True).expand(B, P)
    r["end_s"] = torch.minimum(st["tau"], seg_lens.view(B, 1)).to(I32)
    r["tau_gaveup"] = st["tau_gaveup"]
    r["scan_incomplete"] = st["incomplete"].any(dim=-1)
    r["consumed"] = st["n_consumed"].sum(dim=-1).to(I32)
    r["unconsumed"] = (st["n_total"] - st["n_consumed"]).sum(dim=-1).to(I32)
    r["cand_after"] = st["cand_after"]
    r["cand_race"] = st["cand_race"]
    return r


def _fetch(res) -> dict:
    out = {}
    for k, x in res.items():
        a = x.cpu().numpy()
        out[k] = a.astype(bool) if x.dtype == torch.bool else a
    return out


def is_stopping_decode(bt, err, warn, minbits, mode) -> bool:
    perfect = bt == nrzi_mod.BS_BLOCK and err == 0 and warn == 0
    return (bt == nrzi_mod.BS_TAPEMARK or bt == nrzi_mod.BS_NOISE
            or perfect or (mode == MODE_PE and minbits == 0))


def pick_best(res_host: dict, P: int, multiple_tries: bool, mode: int):
    """readtape.c:1776-1843's stopping rule and 4-stage pick, as
    pipeline.pick_best: (chosen index, tries)."""
    bt = res_host["blktype"]
    err = res_host["errcount"]
    warn = res_host["warncount"]
    minbits = res_host["minbits"]
    if not multiple_tries:
        return 0, 1
    tried = P
    for i in range(P):
        if is_stopping_decode(bt[i], err[i], warn[i], minbits[i], mode):
            tried = i + 1
            break
    cand = range(tried)
    last = tried - 1
    if bt[last] in (nrzi_mod.BS_TAPEMARK, nrzi_mod.BS_NOISE):
        return last, tried
    if bt[last] == nrzi_mod.BS_BLOCK and err[last] == 0 and warn[last] == 0:
        return last, tried
    best, best_w = -1, None
    for i in cand:
        if bt[i] == nrzi_mod.BS_BLOCK and err[i] == 0:
            if best_w is None or warn[i] < best_w:
                best, best_w = i, warn[i]
    if best >= 0:
        return best, tried
    best, best_e = -1, None
    for i in cand:
        if bt[i] == nrzi_mod.BS_BLOCK:
            if best_e is None or err[i] < best_e:
                best, best_e = i, err[i]
    if best >= 0:
        return best, tried
    best, best_m = -1, None
    for i in cand:
        if bt[i] == nrzi_mod.BS_BADBLOCK:
            m = res_host["track_mismatch"][i]
            if best_m is None or m < best_m:
                best, best_m = i, m
    if best >= 0:
        return best, tried
    for i in cand:
        if bt[i] == nrzi_mod.BS_NOISE:
            return i, tried
    return last, tried


def _peakstat_bins(mode: int, bitspacing_secs: float):
    rangef = {MODE_NRZI: 1.0, MODE_PE: 1.2}[mode]
    rng = bitspacing_secs * rangef
    binwidth = rng / 50
    binwidth = (int(binwidth * 10e6 + 0.5) * 1e-6) / 10.0
    leftbin = bitspacing_secs - rng / 2
    leftbin = int(leftbin / binwidth) * binwidth
    return leftbin, binwidth


class Decoder:
    """The capture [T, N] int16 on the host, its height estimate and
    activity mask, and the segment decodes over it."""

    def __init__(self, samples: np.ndarray, opts: Options, volts_dtype=None):
        if samples.dtype != np.int16:
            raise ValueError("int16 samples")
        self.opts = opts
        self.volts_dtype = volts_dtype
        self.n_samples = samples.shape[0]
        self.tape = torch.from_numpy(np.ascontiguousarray(samples.T))
        self.h_est, self._act = seg.host_activity(samples, opts.maxvolts)
        self.pa = ParmArrays.from_parmsets(opts.parmsets, "cpu")
        self.P = len(opts.parmsets)
        self.skew = np.zeros(opts.ntrks, np.int32)

    def segments(self):
        opts = self.opts
        spb = opts.spb
        blank = 0
        if opts.mode == MODE_PE:
            min_gap_secs = cm.PE_IDLE_FACTOR * spb * opts.deltat
            blank = int(cm.PE_IDLE_FACTOR * spb +
                        cm.PE_IBG_SECS / opts.deltat)
            post_bits = 3.0
        else:
            min_gap_secs = max(20 * spb * opts.deltat, 0.0015)
            post_bits = 13.0
        min_gap_chunks = max(2, int(min_gap_secs / (opts.deltat * seg.CHUNK)))
        return seg.find_segments(
            self._act, min_gap_chunks, self.n_samples,
            pre_margin=int(2 * spb), post_margin=int(post_bits * spb),
            blank=blank)

    def _tape_padded(self, min_len: int):
        if self.tape.shape[1] < min_len:
            n_pad = seg.bucket_length(min_len)
            self.tape = torch.nn.functional.pad(
                self.tape, (0, n_pad - self.tape.shape[1]))
        return self.tape

    @torch.inference_mode()
    def decode_batch(self, spans, S, nparms):
        """One batch of segments and the first nparms parmsets: host numpy
        results with leading [B, P] axes."""
        opts = self.opts
        sel = list(range(min(nparms, self.P)))
        active = [opts.parmsets.sets[k] for k in sel]
        pa = self.pa if len(sel) == self.P else self.pa.select(sel)

        def a0(a):
            return max(a - SEG_WARMUP, 0)
        self._tape_padded(max(a0(a) for a, b in spans) + S)
        T = opts.ntrks
        offsets = torch.as_tensor([a0(a) for a, b in spans])
        seg_lens = torch.as_tensor([b - a0(a) for a, b in spans], dtype=I32)
        leads = torch.as_tensor([a - a0(a) for a, b in spans], dtype=I32)
        spb = opts.spb
        Ws = tuple(cm.pkww_width_for(p.pkww_bitfrac, opts.bpi, opts.ips,
                                     opts.deltat) for p in active)
        max_steps = fused_mod.scan_step_budget(int(S / spb * 3.2) + 64)
        K = int(S / spb * 2.5) + 64
        maxb = int(S / spb * 1.3) + 64
        max_slots = int(S / spb * 1.25) + 48
        scale = min(1.0, self.h_est / cm.PKWW_PEAKHEIGHT)
        rise_min = min(p.pkww_rise for p in active)
        minp_min = min(p.min_peak for p in active)
        rise_floor = torch.full(
            (T,), rise_min * scale / cm.AGC_MAX_VALUE * 0.8, dtype=F32)
        min_floor = torch.full(
            (T,), minp_min * scale / cm.AGC_MAX_VALUE * 0.8, dtype=F32)
        lb, bw = _peakstat_bins(opts.mode, 1.0 / (opts.bpi * opts.ips))
        stat_lb = float(np.float32(lb / opts.deltat))
        stat_bw = float(np.float32(bw / opts.deltat))
        volts = _segment_volts(self.tape, offsets, S, opts.maxvolts,
                               self.volts_dtype, self.skew)
        if opts.mode == MODE_PE:
            out = fused_mod.pe_fused_scan_plain(
                volts, seg_lens, leads, pa, Ws=Ws, rise_floor=rise_floor,
                min_floor=min_floor, stat_lb=stat_lb, stat_bw=stat_bw,
                spb=spb, maxb=maxb, K=max_steps, max_steps=max_steps)
            res = _pe_results(out, seg_lens, T, opts.expected_parity,
                              opts.revparity, maxb)
        else:
            out = fused_mod.nrzi_fused_scan_plain(
                volts, seg_lens, leads, pa, Ws=Ws, rise_floor=rise_floor,
                min_floor=min_floor, stat_lb=stat_lb, stat_bw=stat_bw,
                expected_parity=opts.expected_parity, spb=spb,
                do_correct=False, maxb=maxb, max_slots=max_slots, K=K,
                max_steps=max_steps)
            res = _nrzi_results(out, T, opts.expected_parity,
                                opts.revparity, maxb)
        return _fetch(res)

    def calibrate_deskew(self, segments, max_blocks=100,
                         min_transitions=1000, batch=4):
        """-deskew's calibration pass (decoder.c:243-281, readtape.c:
        1676-1717): parmset 0's peak histograms of the leading segments
        that are not noise, until 100 of them or 1,000 transitions on
        every track, then each track's delay from its average peak
        position. Each segment decodes alone at its own bucket, as the
        program's pass does; `batch` of them at a time, which changes no
        lane."""
        opts = self.opts
        lb, bw = _peakstat_bins(opts.mode, 1.0 / (opts.bpi * opts.ips))
        hist = np.zeros((opts.ntrks, 50), np.int64)
        trksums = np.zeros(opts.ntrks, np.int64)
        nblks = 0
        done = False
        for k in range(0, len(segments), batch):
            chunk = segments[k:k + batch]
            res = [None] * len(chunk)
            by_bucket = {}
            for j, (a, b) in enumerate(chunk):
                S = seg.bucket_length(b - max(a - SEG_WARMUP, 0))
                by_bucket.setdefault(S, []).append(j)
            for S, js in sorted(by_bucket.items()):
                r = self.decode_batch([chunk[j] for j in js], S, 1)
                for n, j in enumerate(js):
                    res[j] = {key: v[n][0] for key, v in r.items()}
            for r in res:
                if r["blktype"] == nrzi_mod.BS_NOISE:
                    continue
                hist += r["hist"]
                trksums += r["trksums"]
                nblks += 1
                if nblks >= max_blocks or trksums.min() >= min_transitions:
                    done = True
                    break
            if done:
                break
        if trksums.min() == 0:
            return False
        lb32 = np.float64(np.float32(lb)) * 1e6
        bw32 = np.float64(np.float32(bw)) * 1e6
        avgsum = np.asarray(
            [sum(int(int(hist[t, k]) * (bw32 * k + lb32))
                 for k in range(1, 49)) for t in range(opts.ntrks)])
        avg = (np.float32(avgsum) / np.float32(trksums)).astype(np.float32)
        maxavg = avg.max()
        t_sec = np.where(trksums > 0,
                         ((maxavg - avg).astype(np.float32)
                          / np.float32(1e6)), np.float32(0))
        delays = np.minimum(
            ((t_sec.astype(np.float64) + opts.deltat / 2)
             / opts.deltat).astype(int), 50)
        self.skew = delays.astype(np.int32)
        return True


def decode_sample(samples: np.ndarray, opts: Options, picks,
                  volts_dtype=None):
    """Decode the segments `picks` (indices into the capture's segments)
    as the program's decode_tape decodes them within the whole capture.
    Returns (segments, {pick: [Block, ...]}, skew): each pick's blocks in
    tape order, from its own segment and the segments its chain spawned,
    and the per-track skew delays the segments were decoded with."""
    dec = Decoder(samples, opts, volts_dtype)
    segs = dec.segments()
    if opts.deskew:
        dec.calibrate_deskew(segs)
    all_segs = list(segs)
    buckets = [seg.bucket_length(b - max(a - SEG_WARMUP, 0))
               for a, b in segs]
    maxbkt = max(buckets)
    unified = opts.mode == MODE_NRZI and maxbkt <= 65536
    if unified:
        buckets = [maxbkt] * len(buckets)
    results = [None] * len(segs)
    owner = {}                                 # segment index -> pick

    def collect(indices, nparms):
        by_bucket = {}
        for i in indices:
            by_bucket.setdefault(buckets[i], []).append(i)
        for S, idxs in sorted(by_bucket.items()):
            res = dec.decode_batch([segs[i] for i in idxs], S, nparms)
            for j, i in enumerate(idxs):
                results[i] = {k: v[j] for k, v in res.items()}

    def pe_unreliable(res, j, seg_len):
        return ((int(res["end_s"][j]) >= seg_len
                 or bool(res["tau_gaveup"][j])
                 or bool(res["scan_incomplete"][j]))
                and int(res["blktype"][j]) in (nrzi_mod.BS_BLOCK,
                                               nrzi_mod.BS_BADBLOCK)
                and int(res["minbits"][j]) == 0
                and int(res["errcount"][j]) > 0)

    def stopper(i):
        res = results[i]
        a, b = segs[i]
        mb = int(res["minbits"][0])
        if opts.mode == MODE_PE and pe_unreliable(
                res, 0, b - max(a - SEG_WARMUP, 0)):
            mb = 1
        return is_stopping_decode(
            int(res["blktype"][0]), int(res["errcount"][0]),
            int(res["warncount"][0]), mb, opts.mode)

    def decode_indices(idxs):
        collect(idxs, 1)
        if opts.multiple_tries and dec.P > 1:
            retry = [i for i in idxs if not stopper(i)]
            if retry:
                collect(retry, dec.P)

    def add_segment(a, b, after):
        j = len(segs)
        segs.append((a, b))
        buckets.append(maxbkt if unified else
                       seg.bucket_length(b - max(a - SEG_WARMUP, 0)))
        results.append(None)
        order.insert(order.index(after) + 1, j)
        owner[j] = owner[after]
        return j

    def nrzi_rounds():
        frontier = order[:]
        for _round in range(65536):
            spawned = []
            for i in frontier:
                a, b = segs[i]
                res = results[i]
                p, _ = pick_best(res, len(res["blktype"]),
                                 opts.multiple_tries, opts.mode)
                a0 = max(a - SEG_WARMUP, 0)
                if int(res["unconsumed"][p]) <= 0:
                    continue
                off = int(res["end_s"][p]) + int(cm.NRZI_IBG_SECS
                                                  / opts.deltat)
                if a < a0 + off < b - 4:
                    spawned.append(add_segment(a0 + off, b, i))
            if not spawned:
                break
            decode_indices(spawned)
            frontier = spawned

    def pe_walk():
        ibg_blank = int(cm.PE_IBG_SECS / opts.deltat)
        maxW = max(cm.pkww_width_for(ps.pkww_bitfrac, opts.bpi, opts.ips,
                                     opts.deltat)
                   for ps in opts.parmsets.sets)
        anchor = maxW + opts.ntrks - 2
        n_total = dec.n_samples
        orig_ends = sorted(b for _, b in all_segs)
        consumed_until = -1
        endfile = False

        def tried_prefix(res, P_):
            if not opts.multiple_tries:
                return 1
            for j in range(P_):
                if is_stopping_decode(int(res["blktype"][j]),
                                      int(res["errcount"][j]),
                                      int(res["warncount"][j]),
                                      int(res["minbits"][j]), opts.mode):
                    return j + 1
            return P_

        for i0 in order[:]:
            if endfile or segs[i0][0] < consumed_until:
                if i0 in order:
                    order.remove(i0)
                continue
            cur = i0
            for _hop in range(65536):
                if results[cur] is None:
                    decode_indices([cur])
                res = results[cur]
                a_c, b_c = segs[cur]
                a0_ = max(a_c - SEG_WARMUP, 0)
                seg_len_c = b_c - a0_
                P_ = len(res["blktype"])
                unrel = [j for j in range(P_)
                         if pe_unreliable(res, j, seg_len_c)]
                if unrel:
                    res = dict(res, minbits=np.array(res["minbits"]))
                    res["minbits"][unrel] = 1
                    results[cur] = res
                tp = tried_prefix(res, P_)
                unfinished = [j for j in range(tp)
                              if int(res["end_s"][j]) >= seg_len_c
                              and not bool(res["tau_gaveup"][j])
                              and not bool(res["scan_incomplete"][j])]
                if unfinished and b_c < n_total - 4:
                    nxt_b = next((e for e in orig_ends if e > b_c), n_total)
                    nxt_b = max(nxt_b, min(2 * b_c - a_c, n_total))
                    segs[cur] = (a_c, nxt_b)
                    buckets[cur] = seg.bucket_length(nxt_b - a0_)
                    results[cur] = None
                    continue
                p, _t = pick_best(res, P_, opts.multiple_tries, opts.mode)
                if unfinished and p in unfinished:
                    if cur in order:
                        order.remove(cur)
                    endfile = True
                    break
                bt = int(res["blktype"][p])
                end_s = int(res["end_s"][p])
                cand = int(res["cand_after"][p])
                cand_abs = a0_ + cand if cand < seg_len_c else None
                if int(res["consumed"][p]) == 0 and bt == nrzi_mod.BS_NOISE:
                    race = int(res["cand_race"][p])
                    if race >= seg_len_c:
                        break
                    nxt_start = max(a_c + 1, a0_ + race - anchor)
                else:
                    step = (ibg_blank if bt in (nrzi_mod.BS_BLOCK,
                                                nrzi_mod.BS_BADBLOCK)
                            else 1)
                    if cand_abs is None:
                        break
                    nxt_start = max(a0_ + end_s + step, cand_abs - anchor)
                if not (a_c < nxt_start < b_c - 4):
                    break
                b_hop = next((e for e in orig_ends if e > nxt_start + 4), b_c)
                b_hop = min(max(b_hop, nxt_start + 5), b_c)
                cur = add_segment(nxt_start, b_hop, cur)
            consumed_until = max(consumed_until, segs[cur][1])

    order = sorted(set(int(i) for i in picks))
    for i in order:
        owner[i] = i
    decode_indices(order[:])
    if opts.mode == MODE_PE:
        pe_walk()
    else:
        nrzi_rounds()

    blocks = {i: [] for i in sorted(set(int(i) for i in picks))}
    for i in order:
        a, b = segs[i]
        res = results[i]
        p, tries = pick_best(res, len(res["blktype"]),
                             opts.multiple_tries, opts.mode)
        bt = int(res["blktype"][p])
        t_start = opts.t0_seconds + a * opts.deltat
        end_b = min(max(a - SEG_WARMUP, 0) + int(res["end_s"][p]), b)
        t_end = opts.t0_seconds + end_b * opts.deltat
        out = blocks[owner[i]]
        if bt in (nrzi_mod.BS_NONE, nrzi_mod.BS_NOISE):
            continue
        if bt == nrzi_mod.BS_TAPEMARK:
            out.append(Block("tapemark", parmset=p, tries=tries,
                             t_start=t_start, t_end=t_end))
            continue
        err = int(res["errcount"][p])
        warn = int(res["warncount"][p])
        detail = {k: np.asarray(res[k][p]).tolist()
                  for k in ("minbits", "maxbits", "track_mismatch",
                            "vparity_errs", "crc_errs", "lrc_errs",
                            "missed_midbits", "corrected_bits",
                            "faked_tracks", "avg_bit_spacing",
                            "alltrk_max_agc", "alltrk_min_agc")}
        if bt == nrzi_mod.BS_BADBLOCK:
            out.append(Block("badblock", parmset=p, tries=tries,
                             errcount=err, warncount=warn, detail=detail,
                             t_start=t_start, t_end=t_end))
            continue
        n = int(res["minbits"][p])
        frames = res["frames"][p][:n]
        data = (frames >> 1).astype(np.uint8)
        out.append(Block("data", bytes(data.tobytes()), parmset=p,
                         tries=tries, errcount=err, warncount=warn,
                         detail=detail, t_start=t_start, t_end=t_end))
    return all_segs, blocks, dec.skew.tolist()
