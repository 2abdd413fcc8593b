"""Stage 2: exact peak admission as a position-jumping scan -- the NRZI
subset of readtape_tpu/decode/trackscan.py.

This is the PLAIN version that the hand-written kernel is held against
(decode/fused.py): a Python loop over scan steps, vectorized over lanes
(segments x parmsets x tracks flattened to N). Each step tests the exact
admission at the lane's cursor, refines the peak time, applies the
blind-until-the-peak-exits-the-window rule by jumping the cursor past the
blind region, and otherwise snaps to the next loose candidate through the
jump table. Unlike the JAX XLA scan it has no step cap: it runs until
every cursor passes the segment, as the fused kernel does.

Lane inputs are passed as shared source tables plus per-lane row indices
(``feat[src]``, ``nxt[nsrc]``), so parmsets that share a window width
share one feature table instead of a copy each.
"""

from __future__ import annotations

import torch

from . import common as cm
from . import stage1
from .common import F32, I32

BIG_S = 2 ** 30

FEATURES = ("wmax", "wmin", "v_left", "v_right", "l_top", "prevmax",
            "nextmax", "l_bot", "prevmin", "nextmin")
N_FEAT = len(FEATURES)
CHECK_EVERY = 32         # steps between host checks for live lanes


def _sel(mask, a, b):
    """where(mask, a, b) with mask broadcast over a's trailing ring axes."""
    while mask.dim() < a.dim():
        mask = mask.unsqueeze(-1)
    return torch.where(mask, a, b)


def loose_jump_table(v: torch.Tensor, W: int, rise_floor, min_floor):
    """[..., T, S] voltages -> jump table nxt[..., T, S+1] (int32):
    nxt[i] = first sample j >= i where the loose candidate test passes
    (S if none)."""
    S = v.shape[-1]
    wmax, wmin = stage1.window_minmax(v, W)
    v_left = stage1.left_edge_values(v, W)
    loose = stage1.candidate_mask(v, wmax, wmin, v_left, rise_floor, min_floor)
    idx = torch.where(loose, torch.arange(S, dtype=I32, device=v.device), S)
    run = torch.cummin(torch.flip(idx, dims=(-1,)), dim=-1).values
    nxt = torch.flip(run, dims=(-1,)).to(I32)
    tail = torch.full(nxt.shape[:-1] + (1,), S, dtype=I32, device=v.device)
    return torch.cat([nxt, tail], dim=-1)


def admission_init(W, shape, device, agc_ring: int = cm.AGC_MAX_WINDOW):
    st = cm.agc_state_init(shape, device, agc_ring)
    st.update(
        pos=torch.zeros(tuple(shape), dtype=torch.long, device=device),
        W=torch.as_tensor(W, dtype=I32, device=device).expand(
            tuple(shape)).clone(),
        v_top=torch.zeros(tuple(shape), dtype=F32, device=device),
        v_bot=torch.zeros(tuple(shape), dtype=F32, device=device),
        n_admitted=torch.zeros(tuple(shape), dtype=I32, device=device),
    )
    return st


def admission_test(st, ev, rise_parm, min_parm):
    """The exact lookfor_peak threshold test (decoder.c:781-810)."""
    scale = cm.fdiv(st["v_avg_height"], cm.PKWW_PEAKHEIGHT)
    rise = cm.fdiv(rise_parm * scale, st["agc_gain"])
    rmin = cm.fdiv(min_parm * scale, st["agc_gain"])
    no_min = min_parm == 0
    is_top = ((ev["wmax"] > ev["v_left"] + rise) &
              (ev["wmax"] > ev["v_right"] + rise) &
              (no_min | (ev["wmax"] > rmin)))
    is_bot = ((~is_top) &
              (ev["wmin"] < ev["v_left"] - rise) &
              (ev["wmin"] < ev["v_right"] - rise) &
              (no_min | (ev["wmin"] < -rmin)))
    return is_top, is_bot


def refine_frac(st, ev, admit_top):
    """refine_peak's sub-sample offset relative to the detection sample
    (decoder.c:700-749): frac = -((W - L) - adj), an exact f32 (small
    integer +- 0.5)."""
    L = torch.where(admit_top, ev["l_top"], ev["l_bot"])
    val = torch.where(admit_top, ev["wmax"], ev["wmin"])
    prev = torch.where(admit_top, ev["prevmax"], ev["prevmin"])
    nxt = torch.where(admit_top, ev["nextmax"], ev["nextmin"])
    thr = cm.fdiv(cm.PEAK_THRESHOLD, st["agc_gain"])
    ref = torch.where(admit_top, val - thr, val + thr)
    prev_close = torch.where(admit_top, prev > ref, prev < ref)
    next_close = torch.where(admit_top, nxt > ref, nxt < ref)
    zero = torch.zeros_like(val)
    adj = torch.where(prev_close & ~next_close, zero - 0.5,
                      torch.where(next_close & ~prev_close, zero + 0.5, zero))
    return -((st["W"] - L).to(F32) - adj), L


def precompute_window_features(v: torch.Tensor, W: int):
    """All window features for every sample position at a static window
    width, data-parallel: [..., T, S] -> [..., T, 10, S] f32 (rows:
    wmax, wmin, v_left, v_right, l_top, prevmax, nextmax, l_bot, prevmin,
    nextmin). Ties take the first (leftmost) occurrence of the extremum.
    The extremum's neighbours ride through the sparse-table doubling
    alongside the argmax, as in the JAX version."""
    S = v.shape[-1]
    iota = torch.arange(S, dtype=I32, device=v.device).expand(v.shape)

    def shift(a, d, fill):
        pad = torch.full(a.shape[:-1] + (d,), fill, dtype=a.dtype,
                         device=a.device)
        return torch.cat([pad, a[..., :S - d]], dim=-1)

    vprev = shift(v, 1, 0.0)
    vnext = torch.cat([v[..., 1:], torch.zeros_like(v[..., :1])], dim=-1)

    def combine(acc, d):
        """Merge trailing-window (value, first-index, neighbours) tables:
        acc with acc shifted right by d (the shifted copy covers strictly
        earlier indices, so ties prefer it -> leftmost occurrence)."""
        def half(cur, fills, better):
            sh = [shift(a, d, f) for a, f in zip(cur, fills)]
            take = better(sh[0], cur[0])
            return [torch.where(take, s, c) for s, c in zip(sh, cur)]

        mx, mn = acc
        mx = half(mx, [float("-inf"), 0, 0.0, 0.0], lambda a, b: a >= b)
        mn = half(mn, [float("inf"), 0, 0.0, 0.0], lambda a, b: a <= b)
        return mx, mn

    acc = ([v, iota, vprev, vnext], [v, iota, vprev, vnext])
    p = 1
    while 2 * p <= W:
        acc = combine(acc, p)
        p *= 2
    if p < W:
        acc = combine(acc, W - p)
    (best_v, best_k, prevmax, nextmax), (worst_v, worst_k,
                                         prevmin, nextmin) = acc
    left_pos = torch.clamp_min(iota - W + 1, 0)
    v_left = shift(v, W - 1, 0.0) if W > 1 else v
    if W > 1:
        v_left = torch.where(iota < W - 1, v[..., :1], v_left)
    l_top = (best_k - left_pos + 1).to(v.dtype)
    l_bot = (worst_k - left_pos + 1).to(v.dtype)
    return torch.stack([best_v, worst_v, v_left, v, l_top, prevmax, nextmax,
                        l_bot, prevmin, nextmin], dim=-2)


def gather_window_features(feat: torch.Tensor, src, s):
    """Unpack the precomputed features of each lane at its position:
    feat [M, S, 10] (source rows x positions x features), src [N] row
    index of each lane, s [N] positions -> ev dict of [N] tensors."""
    f = feat[src, s]
    ev = {name: f[:, k] for k, name in enumerate(FEATURES)}
    ev["l_top"] = ev["l_top"].to(I32)
    ev["l_bot"] = ev["l_bot"].to(I32)
    return ev


def run_jump_scan_seq(step_extra, init, ev_fn, nxt_fn, S: int,
                      rise_parm, min_parm, max_steps: int):
    """Drive the admission scan for all lanes with per-step outputs.

    step_extra(st2, st, ev, admit_top, admit_bot, t_peak, s) -> (st3,
    out_dict) applies the mode's state updates after the admission
    decision; t_peak is refine_peak's time (decoder.c:700-749), f32(s) +
    ev["frac"], the sub-sample offset. ev_fn(st, s) supplies the window
    features at s; nxt_fn(i)
    reads each lane's masked jump table at i. After an admission the
    cursor jumps blind to s+L+1; a position that is not a candidate
    (nxt[s] != s) rejects and snaps to nxt[s+1]. Lanes whose cursor passed
    S, or that took max_steps steps (the JAX XLA scan's step budget), are
    dead: they keep their state and emit inert outputs; a lane stopped by
    the budget ends `incomplete`. The loop ends when every lane is dead.
    Returns (final_state, outputs) with each output stacked along a
    trailing step axis of at least one step."""
    st = dict(init)
    st["pos"] = nxt_fn(torch.zeros_like(st["pos"])).long()
    outs = []
    k = 0
    while k < max_steps:
        # the first step always runs (inert for a dead lane), so every
        # output has at least one step
        if k and k % CHECK_EVERY == 0 and not bool((st["pos"] < S).any()):
            break
        s = st["pos"]
        live = s < S
        sc = torch.clamp_max(s, S - 1)
        ev = ev_fn(st, sc)
        is_top, is_bot = admission_test(st, ev, rise_parm, min_parm)
        at_cand = nxt_fn(sc).long() == s
        admit_top = live & is_top & at_cand
        admit_bot = live & is_bot & at_cand
        admit = admit_top | admit_bot
        ev["frac"], L = refine_frac(st, ev, admit_top)
        t_peak = s.to(F32) + ev["frac"]

        st2 = dict(st)
        st2["v_top"] = torch.where(admit_top, ev["wmax"], st["v_top"])
        st2["v_bot"] = torch.where(admit_bot, ev["wmin"], st["v_bot"])
        st2["n_admitted"] = st["n_admitted"] + admit.to(I32)

        st3, out = step_extra(st2, st, ev, admit_top, admit_bot, t_peak, s)
        pos2 = torch.where(admit, s + L.long() + 1,
                           nxt_fn(torch.clamp_max(s + 1, S)).long())
        st3["pos"] = torch.where(live, pos2, s)
        st = st3
        outs.append(out)
        k += 1
    st["incomplete"] = st["pos"] < S
    return st, {name: torch.stack([o[name] for o in outs], dim=-1)
                for name in outs[0]}


def compact_outputs(flags, rank_cap: int, **fields):
    """Compact per-step outputs where `flags` is true into [..., cap]
    buffers in step order. fields: name -> (values, fill). Overflow lands
    in the last slot, which keeps the LAST flagged value (the JAX
    version's last-write-wins scatter), so the buffer stays sorted."""
    fl = flags.to(torch.long)
    rank = torch.cumsum(fl, dim=-1) - 1
    cnt = fl.sum(dim=-1, keepdim=True)
    keep = flags & ((rank < rank_cap - 1) | (rank == cnt - 1))
    idx = torch.where(keep, torch.clamp_max(rank, rank_cap - 1), rank_cap)
    out = {}
    for name, (vals, fill) in fields.items():
        buf = torch.full(vals.shape[:-1] + (rank_cap + 1,), fill,
                         dtype=vals.dtype, device=vals.device)
        buf.scatter_(-1, idx, vals)
        out[name] = buf[..., :rank_cap]
    return out


# ---------------------------------------------------------------------------
# NRZI lane: admission + the nrzi_top/bot AGC policy (decode_nrzi.c:184-230);
# bits are emitted later by the global slot scan.
# ---------------------------------------------------------------------------

def nrzi_agc_policy(st2, st, admit_top, admit_bot, agc_alpha, agc_window):
    """AGC bookkeeping shared by nrzi_top/bot: top peaks 5..15 accumulate
    the baseline; beyond 15 the first top finishes it; later tops and
    bots adjust AGC."""
    admit = admit_top | admit_bot
    pc = st["peakcount"] + admit.to(I32)
    height = st2["v_top"] - st2["v_bot"]
    in_base = admit_top & (pc >= cm.AGC_STARTBASE) & (pc <= cm.AGC_ENDBASE)
    past = pc > cm.AGC_ENDBASE
    do_finish = admit_top & past & (st["v_avg_height_count"] > 0)
    do_agc = admit & past & (st["v_avg_height_count"] == 0)

    acc = cm.accumulate_baseline(st2, height, agc_window)
    fin = cm.finish_baseline(st2)
    agc = cm.adjust_agc(st2, agc_alpha, agc_window)

    out = dict(st2)
    for k in ("v_avg_height_sum", "v_avg_height_count", "v_heights",
              "heightndx", "v_avg_height", "agc_gain",
              "max_agc_gain", "min_agc_gain"):
        out[k] = _sel(in_base, acc[k],
                      _sel(do_finish, fin[k],
                           _sel(do_agc, agc[k], st2[k])))
    out["peakcount"] = pc
    return out


def nrzi_track_scan_pre(feat, src, nxt, nsrc, W, S: int, K: int,
                        max_steps: int, rise_parm, min_parm, agc_alpha,
                        agc_window, agc_ring: int = cm.AGC_MAX_WINDOW):
    """Admission + AGC for NRZI over precomputed window features, for N
    lanes at once. feat [M, S, 10] with lane rows src [N]; nxt [M2, S+1]
    masked jump tables with lane rows nsrc [N]; W and the parmset knobs
    are [N] per lane; each lane takes at most max_steps steps. Admitted
    transitions are compacted into [N, K] buffers (tr_s, tr_t, tr_agc,
    tr_top) after the scan."""
    N = src.shape[0]
    device = feat.device

    def extra(st2, st, ev, admit_top, admit_bot, t_peak, s):
        admit = admit_top | admit_bot
        # first data bit initializes max_agc_gain (nrzi_addbit:149)
        first = admit & (st["n_admitted"] == 0)
        st2["max_agc_gain"] = torch.where(first, st["agc_gain"],
                                          st["max_agc_gain"])
        st3 = nrzi_agc_policy(st2, st, admit_top, admit_bot,
                              agc_alpha, agc_window)
        st3["v_lasttop"] = torch.where(admit_top, ev["wmax"],
                                       st["v_lasttop"])
        st3["v_lastbot"] = torch.where(admit_bot, ev["wmin"],
                                       st["v_lastbot"])
        out = dict(admit=admit, s_det=s.to(I32), t_peak=t_peak,
                   agc_after=st3["agc_gain"], is_top=admit_top)
        return st3, out

    def ev_fn(st, s):
        return gather_window_features(feat, src, s)

    def nxt_fn(i):
        return nxt[nsrc, i]

    init = admission_init(W, (N,), device, agc_ring)
    final, outs = run_jump_scan_seq(extra, init, ev_fn, nxt_fn, S,
                                    rise_parm, min_parm, max_steps)
    final.update(compact_outputs(
        outs["admit"], K,
        tr_s=(outs["s_det"], BIG_S),
        tr_t=(outs["t_peak"], 0.0),
        tr_agc=(outs["agc_after"], 1.0),
        tr_top=(outs["is_top"], False)))
    return final
