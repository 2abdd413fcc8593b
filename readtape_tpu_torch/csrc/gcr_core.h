// The GCR decode state machine shared by the CUDA kernel (gcr_fused.cu)
// and a host build used only by the tests. Every function is
// __host__ __device__ and touches one (segment, parmset) lane.
//
// Semantics: the JAX package's _gcr_segment_device without -zeros
// (readtape_tpu/decode/pipeline.py) over readtape_tpu/decode/gcr.py --
// gcr_track_scan(pre=True, idle_out=True) and gcr_apply_tau -- and, for
// the all-idle point, pe.pe_idle_tau, which the plain PyTorch version
// (readtape_tpu_torch/decode/fused.py::gcr_fused_scan_plain) mirrors.
// Phase 0 (the candidacy bitmask) and phase B (tau) are pe_core.h's, the
// admission test and AGC policy nrzi_core.h's.
// Float expressions keep the reference's operation order; fmaf() stands
// exactly where the plain version calls common.fma (XLA's CPU
// contractions), and everything else rounds on its own (--fmad=false;
// host: -ffp-contract=off).
#pragma once

#include "pe_core.h"

#define GCR_IDLE_THRESH 6.0f
#define GCR_MARK1 0x07
#define GCR_MARK2 0x1C

// per-track / per-lane output columns (decode/fused.py GI_*, GL_*)
#define GI_DC 0
#define GI_PEAKCNT 1
#define GI_TRKSUM 2
#define GI_INCOMP 3
#define GI_NTOTAL 4
#define N_GI 5
#define GL_TAU 0
#define GL_CAND_AFTER 1
#define N_GL 2

// one record per admitted peak: integer columns (the float columns are
// pe_core.h's PRF_*)
#define GR_SDET 0
#define GR_WR0 1          // the step's three bit writes: 0, 0, then the 1
#define GR_HB 4           // histogram code: 0..49, 52/53 out of range, 50 none
#define N_GR 5

// Everything one launch needs. Pointers are device pointers for the
// kernel and host pointers for the host build. Lane = b * P + p.
struct GcrArgs {
  const float* volts;        // [B, T, S]
  const int32_t* seg_len;    // [B]
  const int32_t* lead;       // [B]
  const int32_t* p_w;        // [P] window width
  const int32_t* p_agc_window;
  const int32_t* p_clk_window;
  const float* p_rise;
  const float* p_minp;
  const float* p_agc_alpha;
  const float* p_clk_alpha;
  const float* p_z1pt;
  const float* p_z2pt;
  const float* p_pulse_adj;
  const int32_t* wset;       // [G] distinct window widths, ascending
  const float* rise_floor;   // [T]
  const float* min_floor;    // [T]
  uint32_t* cand;            // scratch [B*P, T, NW] candidate bit words
  int32_t* rec_i;            // scratch [B*P, T, K, N_GR]
  float* rec_f;              // scratch [B*P, T, K, N_PRF]
  int32_t* ie;               // scratch [B*P, T, PE_IDLE_CAP, 2] (entry, wake)
  int32_t* scan;             // scratch [B*P, T, N_PS]
  int8_t* bits;              // [B*P, T, maxb]
  int32_t* hist;             // [B*P, T, 50]
  int32_t* trk_i;            // [B*P, T, N_GI]
  float* trk_f;              // [B*P, T, N_TF]
  int32_t* lane_i;           // [B*P, N_GL]
  int64_t* stamps;           // [B*P, PE_NSTAMP] phase clocks, or null
  // -trace's record mode (pe_core.h), or null
  float* dbg_f;              // [B*P, T, K, 2] peak time, pulse adjustment after it
  int32_t* dbg_i;            // [B*P, T, K, 2] top, zeros inferred before it
  int32_t B, P, T, S, G, K, maxb, max_steps;
  int32_t wmax;              // the widest of p_w
  float spb, stat_lb, stat_bw;
};

// gcr.gcr_idle_entry_sample: the first integer sample >= s_floor where
// f32(s) > t_lp + GCR_IDLE_THRESH * b (the threshold added to the peak
// time, not PE's subtracted gap; XLA contracts the sum into an FMA), by
// four probes around its floor
NRZI_HD int gcr_idle_entry(float t_lp, float b, int s_floor) {
  const float x = fmaf(GCR_IDLE_THRESH, b, t_lp);
  const int c = nrzi_f2i(floorf(x));
  int e = c + 2;
  for (int k = 3; k >= 0; --k)
    if ((float)(c - 1 + k) > x) e = c - 1 + k;
  return pe_imax(e, s_floor);
}

// the per-track clock (common.clkavg_init / adjust_clock / force_clock)
struct GcrClock {
  float* ring;               // [NRZI_MAX_CLK_RING]: the first cwin are read
  int ndx;
  float avg;
};

NRZI_HD void gcr_adjust_clock(GcrClock& c, float delta, int cwin, float ca,
                              float spb) {
  if (cwin > 0) {
    const float old = c.ring[c.ndx];
    c.ring[c.ndx] = delta;
    c.ndx = c.ndx + 1 >= cwin ? 0 : c.ndx + 1;
    c.avg = c.avg + (delta - old) / (float)cwin;
  } else if (ca > 0.0f) {
    c.avg = fmaf(ca, delta, (1.0f - ca) * c.avg);
  } else {
    c.avg = spb;
  }
}

// the bit-recovery state of gcr.gcr_bit_state_init
struct GcrBits {
  GcrClock clk;
  float t_pulse_adj, t_peakdelta, t_firstbit, t_lastbit, t_lastpeak;
  bool datablock;
  int dc, lastbits, rsc;
};

// one gcr_addbit (decode_gcr.c:731-787): write, shift the pattern
// register, resync detection at 5-bit boundaries, the mid-resync
// force_clock (of the cwin ring entries that are ever read); returns the
// write index (maxb = none)
NRZI_HD int gcr_add_bit(GcrBits& g, int bitval, bool enable, float tpd_new,
                        int maxb, int cwin) {
  if (!enable) return maxb;
  const int w = pe_imin(g.dc, maxb - 1);
  g.dc = pe_imin(g.dc + 1, maxb);
  g.lastbits = ((g.lastbits << 1) | bitval) & 0xFF;
  if (g.dc % 5 == 0) {
    const int code = g.lastbits & 0x1F;
    if (code == GCR_MARK2) g.rsc = 1;
    else if (code == GCR_MARK1 && g.rsc > 0) g.rsc = 0;
  }
  if (g.rsc > 0) {
    if (g.rsc == 5) {
      for (int k = 0; k < cwin; ++k) g.clk.ring[k] = tpd_new;
      g.clk.avg = tpd_new;
    }
    g.rsc += 1;
  }
  return w;
}

// gcr.gcr_bit_step for one admitted transition at t_this: up to two
// inferred zeros, the three-ones clock adjust (pattern register read
// before the 1-bit), the pulse adjustment from the adjusted clock, then
// the 1-bit
NRZI_HD void gcr_bit_step(GcrBits& g, float t_this, float z1, float z2,
                          float padj, int cwin, float ca, float spb, int maxb,
                          int32_t* wr) {
  const float b = g.clk.avg;
  const float delta = t_this - g.t_lastpeak;
  const bool in_blk = g.datablock;
  const bool zero1 = in_blk && (delta - g.t_pulse_adj > z1 * b);
  const bool zero2 = zero1 && (delta - g.t_pulse_adj > z2 * b);
  const int numbits = 1 + (int)zero1 + (int)zero2;
  const float tpd_new = in_blk ? delta : g.t_peakdelta;
  const int dc0 = g.dc;
  wr[0] = gcr_add_bit(g, 0, zero1, tpd_new, maxb, cwin);
  wr[1] = gcr_add_bit(g, 0, zero2, tpd_new, maxb, cwin);
  const int prev2 = g.dc >= 2 ? (g.lastbits >> 1) & 1 : 0;
  if (in_blk && g.dc > 3 && numbits == 1 && prev2 == 1)
    gcr_adjust_clock(g.clk, g.t_peakdelta, cwin, ca, spb);
  if (in_blk) g.t_pulse_adj = padj * fmaf((float)numbits, g.clk.avg, -delta);
  wr[2] = gcr_add_bit(g, 1, true, tpd_new, maxb, cwin);
  g.t_peakdelta = tpd_new;
  g.datablock = true;
  if (dc0 == 0) g.t_firstbit = t_this;
  g.t_lastbit = t_this;
  g.t_lastpeak = t_this;
}

// ---------------------------------------------------------------------------
// phase A: one track's admission scan (trackscan.run_jump_scan_seq with
// nrzi_agc_policy, then gcr.gcr_track_scan's step). Non-admitting steps
// leave the state untouched, so only admissions run it; each admission
// appends one record and, when the track had gone idle before it, one
// idle interval (entry, wake). The walk goes chunk by chunk
// (nrzi_walk_chunk) over feature rows the caller computes ahead of it
// (nrzi_feature_rows); the admission test, refinement and AGC policy are
// NrziWalk's (nrzi_core.h)
// ---------------------------------------------------------------------------

// one track's admission walk: its knobs, outputs and state. REC: the
// record mode (GcrArgs::dbg_f set), its own instantiation (GcrTraceWalk)
template <bool REC>
struct GcrWalkT {
  NrziCursor cur;
  int steps, n_adm;
  NrziAgc g;
  GcrBits gb;
  bool had_data;
  int s_lastdet, n_ie;
  // knobs and outputs
  int W, aw, cwin, maxb;
  float rise, minp, aa, ca, z1, z2, padj, spb, stat_lb, stat_bw;
  int32_t* rec_i;            // [K, N_GR]
  float* rec_f;              // [K, N_PRF]
  int32_t* ie;               // [PE_IDLE_CAP, 2]
  float* dbg_f;              // [K, 2] record mode's rows
  int32_t* dbg_i;            // [K, 2]

  // one step at a candidate s with window features f
  NRZI_HDM void admit(int s, const NrziFeat& f) {
    const int adm = nrzi_admission_test(g, f, rise, minp);
    if (!adm) {
      cur.pos = s + 1;
      cur.search = true;
      return;
    }
    const bool is_top = adm > 0;
    int L;
    const float t_this = nrzi_refine_frac(g, f, is_top, s, W, L);
    if (gb.dc == 0) g.max_agc = g.agc;      // the first bit (gcr_addbit)
    nrzi_agc_policy(g, is_top, f, aw, aa);

    // peak statistics once the track has ever had data (decode_gcr.c:839)
    int hb = 50;
    if (had_data) {
      const int bkt = nrzi_f2i(((t_this - gb.t_lastpeak) - stat_lb) / stat_bw);
      hb = bkt < 0 ? 52 : (bkt > 49 ? 53 : bkt);
    }
    // mid-scan idle (decoder.c:879-888): an idle entry before this
    // detection drops datablock, so this admission re-seeds the block;
    // compact_outputs' overflow rule keeps the last interval in the last
    // slot (record mode: the interval is kept, datablock stays)
    const int entry = gcr_idle_entry(gb.t_lastpeak, gb.clk.avg, s_lastdet);
    if (gb.datablock && entry <= s - 1) {
      const int slot = n_ie < PE_IDLE_CAP - 1 ? n_ie : PE_IDLE_CAP - 1;
      ie[2 * slot] = entry;
      ie[2 * slot + 1] = s;
      n_ie += 1;
      if (!REC) gb.datablock = false;
    }
    s_lastdet = s;
    had_data = true;

    // the record (K >= max_steps: one per step at most, never overflows)
    int32_t* ri = rec_i + (int64_t)n_adm * N_GR;
    float* rf = rec_f + (int64_t)n_adm * N_PRF;
    const int dc0 = gb.dc;
    gcr_bit_step(gb, t_this, z1, z2, padj, cwin, ca, spb, maxb, ri + GR_WR0);
    if (REC) {
      dbg_f[2 * n_adm] = t_this;
      dbg_f[2 * n_adm + 1] = gb.t_pulse_adj;
      dbg_i[2 * n_adm] = is_top;
      dbg_i[2 * n_adm + 1] = (int8_t)(gb.dc - dc0 - 1);
    }
    ri[GR_SDET] = s;
    ri[GR_HB] = hb;
    rf[PRF_TFB] = gb.t_firstbit;
    rf[PRF_TLB] = gb.t_lastbit;
    rf[PRF_AGCMX] = g.max_agc;
    rf[PRF_AGCMN] = g.min_agc;
    n_adm += 1;
    // blind until the peak leaves the window: the next step tests s + L + 1
    cur.pos = s + L + 1;
    cur.search = false;
  }
};
using GcrWalk = GcrWalkT<false>;
using GcrTraceWalk = GcrWalkT<true>;

// track t of a lane at the start of its segment; heights, ring:
// NRZI_MAX_AGC_RING and NRZI_MAX_CLK_RING floats
template <bool REC>
NRZI_HD void gcr_walk_init(GcrWalkT<REC>& w, const GcrArgs& a, int lane, int t,
                           float* heights, float* ring) {
  const int b = lane / a.P, p = lane % a.P;
  const int64_t row = (int64_t)lane * a.T + t;
  w.cur.pos = 0;
  w.cur.search = true;
  w.steps = w.n_adm = 0;
  nrzi_agc_init(w.g, heights);
  w.spb = a.spb;
  w.gb.clk.ring = ring;
  for (int k = 0; k < NRZI_MAX_CLK_RING; ++k) ring[k] = a.spb;
  w.gb.clk.ndx = 0;
  w.gb.clk.avg = a.spb;
  w.gb.t_pulse_adj = w.gb.t_peakdelta = w.gb.t_firstbit = w.gb.t_lastbit = 0.0f;
  w.gb.t_lastpeak = 0.0f;
  w.gb.datablock = false;
  w.gb.dc = w.gb.lastbits = w.gb.rsc = 0;
  w.had_data = false;
  w.s_lastdet = a.lead[b] + t + 1;
  w.n_ie = 0;
  w.W = a.p_w[p];
  w.aw = a.p_agc_window[p];
  w.cwin = a.p_clk_window[p];
  w.maxb = a.maxb;
  w.rise = a.p_rise[p];
  w.minp = a.p_minp[p];
  w.aa = a.p_agc_alpha[p];
  w.ca = a.p_clk_alpha[p];
  w.z1 = a.p_z1pt[p];
  w.z2 = a.p_z2pt[p];
  w.padj = a.p_pulse_adj[p];
  w.stat_lb = a.stat_lb;
  w.stat_bw = a.stat_bw;
  w.rec_i = a.rec_i + row * a.K * N_GR;
  w.rec_f = a.rec_f + row * a.K * N_PRF;
  w.ie = a.ie + row * PE_IDLE_CAP * 2;
  if (REC) {
    w.dbg_f = a.dbg_f + row * a.K * 2;
    w.dbg_i = a.dbg_i + row * a.K * 2;
  }
}

// the track's scan results once its walk has stopped
template <bool REC>
NRZI_HD void gcr_walk_finish(const GcrWalkT<REC>& w, const GcrArgs& a, int lane, int t) {
  int32_t* sc = a.scan + ((int64_t)lane * a.T + t) * N_PS;
  sc[PS_NADM] = w.n_adm;
  sc[PS_INCOMP] = w.cur.pos < a.S;
  sc[PS_NIE] = w.n_ie;
  // a dead or never-written track never goes idle (decoder.c:879)
  sc[PS_TRAIL] = w.gb.datablock
                     ? gcr_idle_entry(w.gb.t_lastpeak, w.gb.clk.avg, w.s_lastdet)
                     : PE_BIG_TAU;
}

// ---------------------------------------------------------------------------
// phase C: one track's records replayed up to tau (gcr.gcr_apply_tau) and
// its first candidate after tau
// ---------------------------------------------------------------------------

template <bool REC>
NRZI_HD int gcr_apply_track(const GcrArgs& a, int lane, int t, int tau) {
  const int64_t row = (int64_t)lane * a.T + t;
  const int maxb = a.maxb;
  const int32_t* rec_i = a.rec_i + row * a.K * N_GR;
  const float* rec_f = a.rec_f + row * a.K * N_PRF;
  int8_t* bits = a.bits + row * maxb;
  int32_t* hist = a.hist + row * 50;
  const int n_adm = a.scan[row * N_PS + PS_NADM];

  // records are in detection order: the kept ones are a prefix
  int n_keep = 0;
  while (n_keep < n_adm && rec_i[(int64_t)n_keep * N_GR + GR_SDET] < tau) ++n_keep;
  int nwr = 0, trksum = 0;
  for (int r = 0; r < n_keep; ++r) {
    const int32_t* ri = rec_i + (int64_t)r * N_GR;
    for (int j = 0; j < 3; ++j) {
      const int w = ri[GR_WR0 + j];
      if (w < maxb) {
        bits[w] = (int8_t)(j == 2);        // the last write wins
        nwr += 1;
      }
    }
    const int hb = ri[GR_HB];
    if (hb != 50) hist[hb == 52 ? 0 : (hb == 53 ? 49 : hb)] += 1;
    if (hb <= 49) trksum += 1;
  }
  int32_t* ti = a.trk_i + row * N_GI;
  float* tf = a.trk_f + row * N_TF;
  ti[GI_DC] = pe_imin(nwr, maxb);
  ti[GI_PEAKCNT] = n_keep;
  ti[GI_TRKSUM] = trksum;
  ti[GI_INCOMP] = a.scan[row * N_PS + PS_INCOMP];
  ti[GI_NTOTAL] = n_adm;
  // the state after the last kept admission (or the initial state)
  tf[TF_TFIRST] = 0.0f;
  tf[TF_TLAST] = 0.0f;
  tf[TF_MAXAGC] = 0.0f;
  tf[TF_MINAGC] = NRZI_FLT_MAX;
  if (n_keep > 0) {
    const float* last = rec_f + (int64_t)(n_keep - 1) * N_PRF;
    tf[TF_TFIRST] = last[PRF_TFB];
    tf[TF_TLAST] = last[PRF_TLB];
    tf[TF_MAXAGC] = last[PRF_AGCMX];
    tf[TF_MINAGC] = last[PRF_AGCMN];
  }
  return pe_first_cand<REC>(a, lane, t, pe_imax(0, pe_imin(tau + 1, a.S)));
}

NRZI_HD void gcr_write_lane(const GcrArgs& a, int lane, int tau, bool overflow,
                            int cand_after) {
  int32_t* li = a.lane_i + (int64_t)lane * N_GL;
  li[GL_TAU] = overflow ? PE_BIG_TAU : tau;
  li[GL_CAND_AFTER] = cand_after;
}

// zero one lane's bit and histogram buffers (threads tid of n)
NRZI_HD void gcr_zero_lane(const GcrArgs& a, int lane, int tid, int n) {
  const int64_t nb = (int64_t)a.T * a.maxb;
  int8_t* bits = a.bits + (int64_t)lane * nb;
  for (int64_t i = tid; i < nb; i += n) bits[i] = 0;
  int32_t* hist = a.hist + (int64_t)lane * a.T * 50;
  for (int i = tid; i < a.T * 50; i += n) hist[i] = 0;
}
