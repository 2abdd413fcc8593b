"""NRZI decoder (7-track 200/556/800 BPI, 9-track 800 BPI) -- counterpart
of readtape_tpu/decode/nrzi.py.

NRZI has one global bit clock synchronized to transitions on any track
(decoder.h:260-264). The per-track transition lists come from the
admission scan; a scan over bit slots then replays the global clock: each
slot consumes the transitions that became visible (detection order, like
the C), appends their 1-bits, runs the zerocheck branch logic, adjusts the
clock and advances. ``nrzi_slot_scan`` is the plain version of the slot
machine inside the fused kernel: a Python loop over slots, vectorized over
lanes, writing the bit buffers directly in program order (last write
wins, as in the JAX replay). Because it writes them in place, the
DEBUG-build ``-correct`` (``correct_debug``: the parity check reads the
column of the last complete byte at slot time) runs inside the machine,
where the JAX package streams write records out of its scan and replays
the chain on the host (its correct_debug_replay).

Block postprocess (tapemark/noise/mismatch/CRC/LRC/parity,
decode_nrzi.c:35-113) is batched over lanes; the 9-track CRC recurrence is
GF(2)-linear, so it is a gather over precomputed powers of its matrix.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import telemetry
from . import common as cm
from .common import F32, I32

BIG_S = 2 ** 30                    # s_det sentinel for unused slots
NEG_T = float(np.float32(-1e30))
CHECK_EVERY = 16         # slots between host checks for finished lanes

# block-status codes (mirrors enum bstate_t, decoder.h:318-325)
BS_NONE, BS_TAPEMARK, BS_NOISE, BS_BADBLOCK, BS_BLOCK = 0, 1, 2, 3, 4


# ---------------------------------------------------------------------------
# CRC as a linear map: crc' = L(crc ^ frame); L = rotate-right-9 after the
# conditional 0xf0 flip (decode_nrzi.c:62-66). L is GF(2)-linear and
# invertible, so crc_final = XOR_i L^(n-i)(frame_i) ^ 0x1af.
# ---------------------------------------------------------------------------

def _crc_step_int(t: int) -> int:
    if t & 2:
        t ^= 0xF0
    lsb = t & 1
    t >>= 1
    if lsb:
        t |= 0x100
    return t


@lru_cache(None)
def _crc_power_table():
    """Masks for L^k, k in [0, cycle): out bit j = parity(x & mask[k][j])."""
    basis = [_crc_step_int(1 << b) for b in range(9)]   # L as columns

    def mat_from_cols(cols):
        masks = [0] * 9
        for b, c in enumerate(cols):
            for j in range(9):
                if (c >> j) & 1:
                    masks[j] |= 1 << b
        return masks

    def apply_mat(masks, x):
        out = 0
        for j in range(9):
            out |= (bin(x & masks[j]).count("1") & 1) << j
        return out

    ident = mat_from_cols([1 << b for b in range(9)])
    L = mat_from_cols(basis)
    tables = [ident]
    cur = L
    while cur != ident:
        tables.append(cur)
        cur = mat_from_cols([apply_mat(cur, _crc_step_int(1 << b))
                             for b in range(9)])
        if len(tables) > 4096:
            raise RuntimeError("CRC matrix cycle not found")
    return np.asarray(tables, np.int32)        # [cycle, 9]


def xor_fold(vals: torch.Tensor) -> torch.Tensor:
    """Log-depth XOR reduction over the last axis."""
    n = vals.shape[-1]
    m = 1
    while m < n:
        m *= 2
    v = vals
    if m != n:
        v = torch.cat([vals, vals.new_zeros(vals.shape[:-1] + (m - n,))],
                      dim=-1)
    while m > 1:
        v = v[..., :m // 2] ^ v[..., m // 2:m]
        m //= 2
    return v[..., 0]


def crc9_of_frames(frames: torch.Tensor, n) -> torch.Tensor:
    """CRC over frames[..., 0:n] (frames: int32 [..., M], n: [...])."""
    with telemetry.wait("const_upload"):
        table = torch.as_tensor(_crc_power_table(), device=frames.device)
    C = table.shape[0]
    M = frames.shape[-1]
    n = torch.as_tensor(n, device=frames.device)
    i = torch.arange(M, dtype=I32, device=frames.device)
    k = torch.remainder(n.unsqueeze(-1) - i, C).long()   # L^(n-i)
    masks = table[k]                                      # [..., M, 9]
    contrib = cm.parity9(frames.unsqueeze(-1) & masks)   # [..., M, 9] bits
    bits = contrib << torch.arange(9, dtype=I32, device=frames.device)
    per_frame = bits.sum(dim=-1).to(I32)     # value of L^(n-i)(frame_i)
    per_frame = torch.where(i < n.unsqueeze(-1), per_frame, 0)
    return xor_fold(per_frame) ^ 0x1AF


def xor_reduce_masked(frames, keep):
    return xor_fold(torch.where(keep, frames, 0))


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in index order. The JAX package's f32 track
    sums accumulate sequentially; a vectorized reduction may not."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """Truncate toward zero to int32, clamped so an out-of-range value
    keeps its sign instead of wrapping."""
    return torch.clamp(x, -2.0 ** 30, 2.0 ** 30).to(I32)


# ---------------------------------------------------------------------------
# the global bit-slot scan
# ---------------------------------------------------------------------------

def last_complete_byte(cand: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """The DEBUG build's last_complete_byte (decode_nrzi.c:258,262) of each
    lane: the track loop leaves the index of the HIGHEST track with a peak
    in the zerocheck window. cand [N, T] bool (a peak in the window), idx
    [N, T] each track's index; -1 where no track has a peak."""
    T = cand.shape[-1]
    hi_trk = (T - 1) - torch.argmax(cand.flip(-1).to(I32), dim=-1)
    return torch.where(cand.any(dim=-1), idx.gather(
        1, hi_trk.unsqueeze(-1)).squeeze(-1), -1)


def nrzi_slot_scan(trans_s, trans_t, trans_agc, counts, S: int, spb: float,
                   clk_window, clk_alpha, pulse_adj, midbit,
                   expected_parity: int, do_correct: bool,
                   maxb: int, max_slots: int,
                   stat_leftbin: float, stat_binwidth: float,
                   clk_ring: int = cm.CLKRATE_WINDOW,
                   clk_avg_fma: bool = False, correct_debug: bool = False,
                   adj_init=None, debug: bool = False):
    """N lanes at once. trans_*: [N, T, K] admitted transitions per track
    (s_det ascending; entries past each lane's count hold BIG_S / 0.0 /
    1.0); counts [N, T]; the clock knobs are [N]. Runs at most max_slots
    slots per lane, as the fused kernel does. clk_avg_fma: the exponential
    clock's contraction (common.adjust_clock's avg_fma). correct_debug:
    -correct as the reference's DEBUG build computes it (do_correct is
    then not read). adj_init=(n0 [N, T], mean0 [N, T]) f32: the -adjskew
    accumulators (decoder.c:169-173), per track the incremental mean of
    (peak time - bit spacing) over the recorded in-range peaks, seeded
    with the running values; they come back as adj_n / adj_mean, with the
    clock's final t_bitspaceavg [N]. debug (with -correct off): the -trace
    records, dbg_zc and dbg_avgpos [N, max_slots] f32 (each live slot's
    boundary min(s_z, S), its adjusted clock position where it had
    transitions, else 0; 0 past nslots) and dbg_col_slot [N, T, maxb]
    int32, the slot of the last write to each column (-1: none): the JAX
    package's debug=True fields, dbg_live being slot < nslots. Returns
    the per-track bit buffers [N, T, maxb] int8 and the block-result
    fields."""
    N, T, K = trans_s.shape
    dev = trans_s.device
    ar = torch.arange(N, device=dev)
    trk = torch.arange(T, device=dev)

    def fN(v):
        return torch.full((N,), v, dtype=F32, device=dev)

    spb32 = fN(float(np.float32(spb)))
    lb = torch.full((N, T), float(np.float32(stat_leftbin)), dtype=F32,
                    device=dev)
    bw = torch.full((N, T), float(np.float32(stat_binwidth)), dtype=F32,
                    device=dev)

    any_trans = counts.sum(dim=-1) > 0
    first_k = torch.argmin(trans_s[:, :, 0], dim=-1)   # low track wins ties
    t_first = trans_t[ar, first_k, 0]
    t_lc = t_first - spb32
    t_lm = cm.fma(midbit, spb32, t_lc)
    clk = cm.clkavg_init(spb, (N,), dev, clk_ring)
    post = torch.zeros(N, dtype=I32, device=dev)
    kvis = torch.zeros((N, T), dtype=torch.long, device=dev)
    dc = torch.zeros((N, T), dtype=torch.long, device=dev)
    t_firstbit = torch.zeros((N, T), dtype=F32, device=dev)
    t_lastbit = torch.zeros((N, T), dtype=F32, device=dev)
    missed = torch.zeros(N, dtype=I32, device=dev)
    corrected = torch.zeros(N, dtype=I32, device=dev)
    faked = torch.zeros(N, dtype=I32, device=dev)
    overflow = torch.zeros(N, dtype=torch.bool, device=dev)
    done = ~any_trans
    end_s = torch.full((N,), S, dtype=I32, device=dev)
    nslots = torch.zeros(N, dtype=I32, device=dev)
    trksums = torch.zeros((N, T), dtype=I32, device=dev)
    # one spare column each: index maxb drops a write, 50 a statistic
    bits = torch.zeros((N, T, maxb + 1), dtype=torch.int8, device=dev)
    hist = torch.zeros((N, T, 51), dtype=I32, device=dev)
    ones_h = torch.ones((N, T, 1), dtype=I32, device=dev)
    adj = adj_init is not None
    if adj:
        adj_n = adj_init[0].to(F32).clone()
        adj_mean = adj_init[1].to(F32).clone()

    if debug:
        assert not (do_correct or correct_debug), "-trace runs -correct off"
        dbg_zc = torch.zeros((N, max_slots), dtype=F32, device=dev)
        dbg_avgpos = torch.zeros((N, max_slots), dtype=F32, device=dev)
        col_slot = torch.full((N, T, maxb + 1), -1, dtype=I32, device=dev)

    def at(buf, k):
        return buf.gather(2, k.unsqueeze(-1)).squeeze(-1)

    def write(idx, val):
        bits.scatter_(2, idx.unsqueeze(-1), val)
        if debug:
            col_slot.scatter_(2, idx.unsqueeze(-1), k_slot)

    for k_slot in range(max_slots):
        if k_slot % CHECK_EVERY == 0 and bool(done.all()):
            break
        live = ~done
        b0 = clk["t_bitspaceavg"]

        def consume(s_zc):
            """Append 1-bits for transitions with s_det < s_zc (detection
            order): at most 3 per track, a 4th sets the overflow flag;
            then the post-area clock realignment (nrzi_addbit:171-175)."""
            nonlocal kvis, dc, t_firstbit, t_lastbit, missed, overflow
            nonlocal trksums, t_lc, adj_n, adj_mean
            seen = []
            for j in range(4):
                kj = kvis + j
                sj = at(trans_s, torch.clamp_max(kj, K - 1)).long()
                seen.append((kj < K) & (sj < s_zc.unsqueeze(-1))
                            & live.unsqueeze(-1))
            n_new = sum(s.long() for s in seen)
            newmax = torch.full((N, T), NEG_T, dtype=F32, device=dev)
            for j in range(3):
                has = seen[j]
                kj = torch.clamp_max(kvis + j, K - 1)
                tj = at(trans_t, kj)
                write(torch.where(has, torch.clamp_max(dc + j, maxb - 1),
                                  maxb), 1)
                t_firstbit = torch.where(has & (dc + j == 0), tj,
                                         t_firstbit)
                t_lastbit = torch.where(has, tj, t_lastbit)
                newmax = torch.where(has, torch.maximum(newmax, tj), newmax)
                quiet = (post == 0).unsqueeze(-1)
                miss = has & (tj < t_lm.unsqueeze(-1)) & quiet
                missed = missed + miss.sum(dim=-1).to(I32)
                # the block's very first transition is never recorded
                # (decode_nrzi.c:156-162)
                stat_ok = has & quiet & ~((trk == first_k.unsqueeze(-1))
                                          & (kj == 0))
                val = tj - t_lc.unsqueeze(-1)
                bkt = f32_to_i32(cm.fdiv(val - lb, bw))
                code = torch.where(bkt < 0, 0, torch.where(bkt > 49, 49, bkt))
                hist.scatter_add_(2, torch.where(stat_ok, code, 50)
                                  .long().unsqueeze(-1), ones_h)
                in_range = stat_ok & (bkt >= 0) & (bkt <= 49)
                trksums = trksums + in_range.to(I32)
                if adj:
                    # the C's expression order, in-range buckets only
                    n2 = adj_n + in_range.to(F32)
                    adj_mean = torch.where(
                        in_range, adj_mean + cm.fdiv(
                            (val - b0.unsqueeze(-1)) - adj_mean,
                            torch.clamp_min(n2, 1.0)), adj_mean)
                    adj_n = n2
            dc = torch.clamp_max(dc + n_new, maxb)
            kvis = torch.clamp_max(kvis + n_new, K)
            overflow = overflow | seen[3].any(dim=-1)
            t_max = newmax.amax(dim=-1)
            realign = ((post > 0) & (t_max > NEG_T / 2) &
                       (t_lc < cm.fma(-(2 - midbit), b0, t_max)))
            t_lc = torch.where(realign, t_max - 2 * b0, t_lc)

        def boundary():
            return torch.floor(t_lc + 2 * b0).clamp(-2.0 ** 40, 2.0 ** 40) \
                .long() + 1

        consume(torch.clamp_max(boundary(), S))
        # realignment may have pushed the boundary later: recompute once
        s_z = boundary()
        consume(torch.clamp_max(s_z, S))
        past_end = s_z >= S

        # ---- zerocheck (decode_nrzi.c:232-314) ----
        b = clk["t_bitspaceavg"]
        left = t_lm.unsqueeze(-1)
        right = cm.fma(1 + midbit, b, t_lc)
        lastpeak = torch.where(kvis >= 1, at(trans_t, torch.clamp_min(kvis - 1, 0)),
                               NEG_T)
        prevlast = torch.where(kvis >= 2, at(trans_t, torch.clamp_min(kvis - 2, 0)),
                               NEG_T)
        r = right.unsqueeze(-1)
        last_in = (lastpeak > left) & (lastpeak < r)
        prev_in = (prevlast > left) & (prevlast < r)
        dup = last_in & prev_in                      # noisy double peak
        b2 = (~last_in) & prev_in
        later = (~last_in) & (~prev_in) & (lastpeak > r)
        zero = (~last_in) & (~prev_in) & (~later)

        lv = live.unsqueeze(-1)
        d = torch.where(dup, dc - 1, dc)
        # later: insert 0 before the (future) 1 just appended
        write(torch.where(later & lv, torch.clamp_min(d - 1, 0), maxb), 0)
        write(torch.where(later & lv, torch.clamp_max(d, maxb - 1), maxb), 1)
        d = torch.where(later, torch.clamp_max(d + 1, maxb), d)
        # plain zero: append a 0
        write(torch.where(zero & lv, torch.clamp_max(d, maxb - 1), maxb), 0)
        d = torch.where(zero, torch.clamp_max(d + 1, maxb), d)

        tz = (t_lc + b).unsqueeze(-1)
        zlike = later | zero
        tfb = torch.where(zlike & (dc == 0) & (d > dc), tz, t_firstbit)
        tlb = torch.where(later, lastpeak, torch.where(zero, tz, t_lastbit))

        numbits = (last_in | b2).sum(dim=-1).to(I32)
        numlater = later.sum(dim=-1).to(I32)
        avg_pos = seq_sum(torch.where(last_in, lastpeak,
                                      torch.where(b2, prevlast, 0.0)))
        have = numbits > 0

        # --- have-transitions path ---
        post_h = torch.where(post == 1, 0, post)     # cancel a fresh post
        avg = cm.fdiv(avg_pos, torch.clamp_min(numbits, 1).to(F32))
        expected = t_lc + b
        adjusted = torch.where(post_h > 0, avg,
                               cm.fma(pulse_adj, avg - expected, expected))
        delta = adjusted - t_lc
        clk_h = cm.adjust_clock(clk, delta, clk_window, clk_alpha, spb32,
                                avg_fma=clk_avg_fma)
        do_clk = live & have & (post_h == 0)
        clk = {k_: torch.where(do_clk.view((N,) + (1,) * (v.dim() - 1)),
                               v, clk[k_]) for k_, v in clk_h.items()}
        post_h = torch.where(post_h > 0, post_h + 1, post_h)

        # --- no-transitions path ---
        post_n = torch.where((numlater == 0) & (post == 0), 1,
                             torch.where(post > 0, post + 1, post))
        post2 = torch.where(have, post_h, post_n).to(I32)
        t_lc2 = torch.where(have, adjusted, t_lc + b)

        if correct_debug:
            # each track's index: datacount-1 after a dup deletion when
            # its last peak is in the window, else datacount-2
            dcp = torch.where(dup, dc - 1, dc)
            lcb = last_complete_byte(last_in | prev_in,
                                     torch.where(last_in, dcp - 1, dcp - 2))

        dc = torch.where(lv, d, dc)
        t_firstbit = torch.where(lv, tfb, t_firstbit)
        t_lastbit = torch.where(lv, tlb, t_lastbit)
        post = torch.where(live, post2, post)
        t_lc = torch.where(live, t_lc2, t_lc)
        t_lm = torch.where(live, right, t_lm)

        # --- optional error correction: the parity check reads column 0
        # (the release binary; readtape.c nrzi_zerocheck:245,302) or,
        # DEBUG build, column last_complete_byte after the slot's writes
        if do_correct or correct_debug:
            col = (torch.clamp(lcb, 0, maxb - 1) if correct_debug
                   else torch.zeros(N, dtype=torch.long, device=dev))
            colv = bits.gather(2, col.view(N, 1, 1).expand(N, T, 1)
                               ).squeeze(-1).to(I32)
            frame = (colv << (T - 1 - trk)).sum(dim=-1).to(I32)
            par_bad = cm.parity9(frame) != expected_parity
            agc_now = torch.where(kvis >= 1,
                                  at(trans_agc, torch.clamp_min(kvis - 1, 0)),
                                  1.0)
            hi, badtrk = agc_now.max(dim=-1)          # first max wins
            next_hi = agc_now.scatter(1, badtrk.unsqueeze(-1),
                                      -1.0).amax(dim=-1)
            do_fix = (live & have & par_bad &
                      (hi >= cm.NRZI_BADTRK_FACTOR * next_hi))
            if correct_debug:
                do_fix = do_fix & (lcb >= 0) & (lcb < maxb)
            cur = bits[ar, badtrk, col]
            bits[ar, badtrk, col] = torch.where(do_fix, 1 - cur, cur)
            corrected = corrected + do_fix.to(I32)
            faked = faked | torch.where(
                do_fix, (1 << (T - 1 - badtrk)).to(I32), 0)

        if debug:
            dbg_zc[:, k_slot] = torch.where(
                live, torch.clamp_max(s_z, S).to(F32), 0.0)
            dbg_avgpos[:, k_slot] = torch.where(live & have, adjusted, 0.0)
        ended = post2 >= 8
        end_s = torch.where(live & ended,
                            torch.clamp_max(s_z, S).to(I32), end_s)
        done = done | (live & (ended | past_end))
        nslots = nslots + live.to(I32)

    out = dict(
        bits=bits[:, :, :maxb], hist=hist[:, :, :50], trksums=trksums,
        dc=dc.to(I32), kvis=kvis.to(I32), t_firstbit=t_firstbit,
        t_lastbit=t_lastbit, missed_midbits=missed,
        corrected_bits=corrected, faked_tracks=faked,
        consume_overflow=overflow, end_s=end_s, nslots=nslots)
    if adj:
        out.update(adj_n=adj_n, adj_mean=adj_mean,
                   t_bitspaceavg=clk["t_bitspaceavg"])
    if debug:
        out.update(dbg_zc=dbg_zc, dbg_avgpos=dbg_avgpos,
                   dbg_col_slot=col_slot[:, :, :maxb])
    return out


# ---------------------------------------------------------------------------
# end-of-block processing (nrzi_end_of_block + nrzi_postprocess)
# ---------------------------------------------------------------------------

@telemetry.spanned("finish")
def nrzi_finish(st, ntrks: int, expected_parity: int, revparity: int,
                maxb: int):
    """Block classification + CRC/LRC/parity checks, batched over the
    leading lane axes of st (per-track fields [..., T], bits
    [..., T, maxb]). Returns a dict of results_t-like fields plus the
    frame array."""
    T = ntrks
    dev = st["dc"].device
    trk = torch.arange(T, device=dev)
    dc = st["dc"]
    minbits = dc.amin(dim=-1)
    maxbits = dc.amax(dim=-1)
    started = st["kvis"].sum(dim=-1) > 0

    spacing = cm.fdiv(st["t_lastbit"] - st["t_firstbit"],
                      torch.clamp_min(dc, 1).to(F32))
    # jnp.mean under jit: an in-order sum times the f32 reciprocal of T
    avg_bit_spacing = seq_sum(spacing) * float(np.float32(1) / np.float32(T))

    frames = (st["bits"].to(I32) << (T - 1 - trk).to(I32).unsqueeze(-1)
              ).sum(dim=-2).to(I32)                        # [..., maxb]

    def frame_at(i):
        return frames.gather(-1, i.long().unsqueeze(-1)).squeeze(-1)

    if T == 9:
        is_tm = (minbits == 9) & (frames[..., 0] == 0x26) & \
            (frames[..., 8] == 0x26)
    else:
        is_tm = ((minbits == 9) & (frames[..., 0] == 0x1E) &
                 ((frames[..., 3] == 0x1E) | (frames[..., 4] == 0x1E)))
    is_noise = (~is_tm) & (maxbits <= cm.NRZI_MIN_BLOCK)
    mismatch = maxbits - minbits
    is_bad = (~is_tm) & (~is_noise) & (mismatch > cm.NRZI_MAX_MISMATCH)
    is_block = (~is_tm) & (~is_noise) & (~is_bad)

    # postprocess (decode_nrzi.c:35-75): strip the 8 post frames
    has_post = minbits > 8
    n = torch.clamp_min(minbits - 8, 0)
    idx = torch.arange(maxb, dtype=I32, device=dev)
    keep = idx < n.unsqueeze(-1)

    flip = (revparity > 0) & (maxbits - 8 == revparity)
    exp_par = torch.where(flip, 1 - expected_parity, expected_parity)
    par = cm.parity9(frames)
    counted = keep & (is_block & has_post).unsqueeze(-1)
    vparity_errs = (counted & (par != exp_par.unsqueeze(-1))).sum(
        dim=-1).to(I32)
    lrc_data = xor_reduce_masked(frames, keep)
    zero = torch.zeros_like(minbits)
    crc_errs = zero
    lrc_errs = zero
    stored_crc = zero
    stored_lrc = zero
    mb = torch.clamp_min(minbits, 9)
    checked = is_block & has_post
    if T == 9:
        crc_calc = crc9_of_frames(frames, n)
        stored_crc = frame_at(mb - 6) | frame_at(mb - 5) | frame_at(mb - 4)
        stored_lrc = frame_at(mb - 1)
        lrc_calc = lrc_data ^ crc_calc
        crc_errs = (checked & (crc_calc != stored_crc)).to(I32)
        lrc_errs = (checked & (lrc_calc != stored_lrc)).to(I32)
    else:
        stored_lrc = frame_at(mb - 6) | frame_at(mb - 5) | frame_at(mb - 4)
        lrc_errs = (checked & (lrc_data != stored_lrc)).to(I32)

    blktype = torch.where(
        ~started, BS_NONE, torch.where(
            is_tm, BS_TAPEMARK, torch.where(
                is_noise, BS_NOISE, torch.where(is_bad, BS_BADBLOCK,
                                                BS_BLOCK)))).to(I32)
    out_min = torch.where(checked, minbits - 8, minbits)
    out_max = torch.where(checked, maxbits - 8, maxbits)

    errcount = (torch.where(is_bad, mismatch, 0) + vparity_errs +
                crc_errs + lrc_errs)
    warncount = st["missed_midbits"] + st["corrected_bits"]

    i32 = lambda x: x.to(I32)                          # noqa: E731
    return dict(
        blktype=blktype, minbits=i32(out_min), maxbits=i32(out_max),
        track_mismatch=i32(torch.where(is_bad, mismatch, 0)),
        vparity_errs=vparity_errs, crc_errs=i32(crc_errs),
        lrc_errs=i32(lrc_errs),
        stored_crc=i32(stored_crc), stored_lrc=i32(stored_lrc),
        errcount=i32(errcount), warncount=i32(warncount),
        missed_midbits=st["missed_midbits"],
        corrected_bits=st["corrected_bits"],
        faked_tracks=st["faked_tracks"],
        avg_bit_spacing=avg_bit_spacing,
        frames=frames,
        hist=st["hist"], trksums=st["trksums"],
        consume_overflow=st["consume_overflow"],
    )
