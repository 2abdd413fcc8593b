// The Whirlwind decode shared by the CUDA kernel (ww_fused.cu) and a host
// build used only by the tests. Every function is __host__ __device__.
//
// Semantics: readtape_tpu/decode/ww.py (ww_track_scan with pre=True,
// merge_transitions, ww_global_scan with its flush), composed as the JAX
// package's XLA path composes them (pipeline.py run_pass_single), which
// the plain PyTorch version (readtape_tpu_torch/decode/fused.py::
// ww_fused_scan_plain) mirrors. Float expressions keep the reference's
// operation order; fmaf() stands only where the JAX package's XLA scans
// form a fused multiply-add (common.fma in the plain version), and the
// code is built with --fmad=false (host: -ffp-contract=off).
#pragma once

#include "nrzi_core.h"

#define WW_MAX_TRACKS 16
#define WW_AGC_RING 10           // AGC_MAX_WINDOW: agc_window <= 10
#define WW_CLK_RING 50           // CLKRATE_WINDOW: clk_window <= 50
#define WW_BS_TAPEMARK 1
#define WW_BS_BLOCK 4
#define WW_FLUX_POS 0
#define WW_FLUX_NEG 1
#define WW_FLUX_AUTO 2

// output columns (decode/fused.py WB_*, WBF_*, WT_*, WS_*)
#define WB_START 0
#define WB_END 1
#define WB_TYPE 2
#define WB_TBASE 3
#define WB_MISS1 4
#define WB_MISSCLK 5
#define N_WB 6
#define WBF_TEND 0
#define WBF_BITSPACE 1
#define N_WBF 2
#define WT_TRKSUM 0
#define WT_NADM 1
#define WT_HCNT 2
#define WT_STEPS 3
#define N_WT 4
#define WS_DATACOUNT 0
#define WS_NBLOCKS 1
#define WS_FLUX 2
#define WS_NFLUX 3
#define WS_BASE 4
#define WS_NEVENTS 5
#define N_WS 6

// track roles, decode/ww.py ROLES order
#define WW_PRI_CLK 0
#define WW_PRI_LSB 1
#define WW_PRI_MSB 2
#define WW_ALT_CLK 3
#define WW_ALT_LSB 4
#define WW_ALT_MSB 5

// timing stamps (only when WwArgs::stamps is set), in clock64() cycles:
// [t] track t's admission walk, [T + t] its admission block; [2T] the
// machine's event loop, [2T + 1] the machine's block; then the global
// timer (ns) at the machine's start and end, to turn cycles into time
#define WW_NSTAMP(T) (2 * (T) + 4)

// Everything one launch needs: one tape, one parmset. Pointers are device
// pointers for the kernel and host pointers for the host build. Outputs
// must be zeroed before the launch.
struct WwArgs {
  const float* volts;        // [T, S]
  const float* rise_floor;   // [T]
  const float* min_floor;    // [T]
  const float* vah;          // [T] v_avg_height
  uint32_t* cand;            // scratch [T, NW] candidate bit words
  int32_t* tr_s;             // scratch [T, K] detection samples
  float* tr_frac;            // scratch [T, K] sub-sample offsets
  int8_t* tr_top;            // scratch [T, K] top (1) or bottom (0) peak
  int32_t* ev_s;             // scratch [T * K] merged events: sample,
  float* ev_frac;            //   sub-sample offset,
  uint8_t* ev_tt;            //   track | is_top << 4
  int8_t* chars;             // [maxchars]
  int32_t* blk_i;            // [maxblocks, N_WB]
  float* blk_f;              // [maxblocks, N_WBF]
  int32_t* hist;             // [T, 50]
  int32_t* trk_i;            // [T, N_WT]
  float* trk_f;              // [T] h_sum
  int32_t* scal;             // [N_WS]
  int64_t* stamps;           // [WW_NSTAMP(T)] timing stamps, or null
  // -trace's record mode (both set), or null: each record's peak time
  // f32(s) + frac beside tr_s, and each data character's clock-end time
  // (in the machine's carried time base) beside chars; the admission and
  // the machine compile it as instantiations of their own
  float* tr_t;               // [T, K]
  float* char_t;             // [maxchars]
  int32_t T, S, W, K, maxchars, maxblocks, agc_window, clk_window, fluxdir,
      span;
  int32_t role[6];
  float rise, minp, agc_alpha, clk_alpha, spb, stat_lb, stat_bw;
};

NRZI_HD int ww_nwords(const WwArgs& a) { return (a.S + 31) >> 5; }
NRZI_HD int ww_imin(int x, int y) { return x < y ? x : y; }

// ---------------------------------------------------------------------------
// phase 0: loose candidacy (trackscan.loose_jump_table) over the whole tape
// ---------------------------------------------------------------------------

NRZI_HD uint32_t ww_cand_word(const WwArgs& a, int t, int w) {
  const float* v = a.volts + (int64_t)t * a.S;
  const float rf = a.rise_floor[t], mf = a.min_floor[t];
  uint32_t word = 0;
  for (int i = 0; i < 32; ++i) {
    int s = (w << 5) + i;
    if (s >= a.S) break;
    if (nrzi_loose_at(v, s, a.W, rf, mf)) word |= 1u << i;
  }
  return word;
}

// ---------------------------------------------------------------------------
// phase A: one track's admission scan (ww.ww_track_scan over
// trackscan.run_jump_scan_seq): adjust_agc on every admitted edge, the
// pulse-height sums, and the compacted (s, frac, is_top) records. No step
// budget: the cursor runs to S (every step moves it forward), as in the
// TPU kernel; the XLA path's budget truncates dense tapes. The walk goes
// chunk by chunk (nrzi_walk_chunk) over feature rows the caller computes
// ahead of it (nrzi_feature_rows)
// ---------------------------------------------------------------------------

// one track's admission walk: its knobs, outputs and state. REC: the
// record mode (WwArgs::tr_t set), its own instantiation, so that the
// decode's walk (WwWalk) carries none of it
template <bool REC>
struct WwWalkT {
  NrziCursor cur;
  int steps;
  float agc, v_lasttop, v_lastbot, v_top, v_bot, h_sum;
  int hndx, n_adm, h_cnt;
  float* heights;            // [WW_AGC_RING] the AGC window
  float vah, rise, minp, aa;
  int aw, W, K;
  int32_t* tr_s;             // [K] records
  float* tr_frac;
  int8_t* tr_top;
  float* tr_t;               // record mode: the peak times

  // one step at a candidate s with window features f
  NRZI_HDM void admit(int s, const NrziFeat& f) {
    // admission_test (decoder.c:781-810)
    float scale = vah / 4.0f;
    float rise_t = rise * scale / agc;
    float rmin = minp * scale / agc;
    bool no_min = minp == 0.0f;
    bool is_top = (f.wmax > f.vleft + rise_t) && (f.wmax > f.vright + rise_t) &&
                  (no_min || f.wmax > rmin);
    bool is_bot = !is_top && (f.wmin < f.vleft - rise_t) &&
                  (f.wmin < f.vright - rise_t) && (no_min || f.wmin < -rmin);
    if (!is_top && !is_bot) {
      cur.pos = s + 1;
      cur.search = true;
      return;
    }
    // refine_frac: +-0.5-sample interpolation (decoder.c:700-749)
    int L = is_top ? f.ltop : f.lbot;
    float val = is_top ? f.wmax : f.wmin;
    float prv = is_top ? f.prevmax : f.prevmin;
    float nxt = is_top ? f.nextmax : f.nextmin;
    float thr = 0.005f / agc;
    float ref = is_top ? val - thr : val + thr;
    bool pclose = is_top ? prv > ref : prv < ref;
    bool nclose = is_top ? nxt > ref : nxt < ref;
    float adj = (pclose && !nclose) ? -0.5f : ((nclose && !pclose) ? 0.5f : 0.0f);
    float frac = -((float)(W - L) - adj);

    if (is_top) v_top = val; else v_bot = val;
    // adjust_agc on every pulse edge (decode_ww.c:171,190)
    float lastheight = v_lasttop - v_lastbot;
    bool use_exp = aa > 0.0f && lastheight > 0.0f;
    bool use_win = aw > 0 && lastheight > 0.0f;
    if (use_exp) {
      float g_exp = vah / nrzi_maxf(lastheight, 1e-9f);
      g_exp = fmaf(aa, g_exp, (1.0f - aa) * agc);
      agc = nrzi_minf(g_exp, 2.0f);
    }
    if (use_win) {
      heights[hndx] = lastheight;
      hndx = (hndx + 1 >= aw) ? 0 : hndx + 1;
      float minh = NRZI_FLT_MAX;
      for (int k = 0; k < WW_AGC_RING && k < aw; ++k) minh = nrzi_minf(minh, heights[k]);
      agc = nrzi_minf(vah / nrzi_maxf(minh, 1e-9f), 2.0f);
    }
    // average pulse height at pulse ends (accumulate_avg_height,
    // decode_ww.c:189), for the deskew calibration pass
    float height = v_top - v_bot;
    if (is_top && height > 0.0f) {
      h_sum = h_sum + height;
      h_cnt += 1;
    }
    if (is_top) v_lasttop = f.wmax; else v_lastbot = f.wmin;

    // compact_outputs: overflow keeps the last admission in slot K-1
    int idx = n_adm < K - 1 ? n_adm : K - 1;
    tr_s[idx] = s;
    tr_frac[idx] = frac;
    tr_top[idx] = is_top ? 1 : 0;
    if (REC) tr_t[idx] = (float)s + frac;
    n_adm += 1;
    // blind until the peak leaves the window: the next step tests s + L + 1
    cur.pos = s + L + 1;
    cur.search = false;
  }
};
using WwWalk = WwWalkT<false>;

// track t's walk at the start of the tape; heights: WW_AGC_RING floats
template <bool REC>
NRZI_HD void ww_walk_init(WwWalkT<REC>& w, const WwArgs& a, int t, float* heights) {
  w.cur.pos = 0;
  w.cur.search = true;
  w.steps = 0;
  w.agc = 1.0f;
  w.v_lasttop = w.v_lastbot = w.v_top = w.v_bot = w.h_sum = 0.0f;
  w.hndx = w.n_adm = w.h_cnt = 0;
  w.heights = heights;
  for (int k = 0; k < WW_AGC_RING; ++k) heights[k] = 0.0f;
  w.vah = a.vah[t];
  w.rise = a.rise;
  w.minp = a.minp;
  w.aa = a.agc_alpha;
  w.aw = a.agc_window;
  w.W = a.W;
  w.K = a.K;
  w.tr_s = a.tr_s + (int64_t)t * a.K;
  w.tr_frac = a.tr_frac + (int64_t)t * a.K;
  w.tr_top = a.tr_top + (int64_t)t * a.K;
  if (REC) w.tr_t = a.tr_t + (int64_t)t * a.K;
}

// the walk of a chunk, with no step budget
template <class Walk>
NRZI_HD bool ww_walk_chunk(Walk& w, const uint32_t* words,
                           const NrziFeat* rows, int c0, int c1, int S) {
  return nrzi_walk_chunk(w, words, rows, c0, c1, S, 0x7fffffff);
}

template <bool REC>
NRZI_HD void ww_walk_finish(const WwWalkT<REC>& w, const WwArgs& a, int t) {
  int32_t* ti = a.trk_i + (int64_t)t * N_WT;
  ti[WT_NADM] = w.n_adm;
  ti[WT_HCNT] = w.h_cnt;
  ti[WT_STEPS] = w.steps;
  a.trk_f[t] = w.h_sum;
}

// ---------------------------------------------------------------------------
// the merge (ww.merge_transitions): each record's place in detection
// order, (s, track) ascending, found on its own by binary searches in the
// other tracks' sorted records, and the records scattered into one packed
// event array
// ---------------------------------------------------------------------------

// records kept for track t: min(count, K), the last in slot K-1
NRZI_HD int ww_nrec(const WwArgs& a, int t) {
  return ww_imin(a.trk_i[t * N_WT + WT_NADM], a.K);
}

// how many of xs[0, n) (ascending) are below s, or at most s
NRZI_HD int ww_count_below(const int32_t* xs, int n, int s, bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (xs[mid] < s || (or_equal && xs[mid] == s)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// record k of track t (k < ww_nrec) into its place among all events: on
// equal s the lower track goes first
NRZI_HD void ww_scatter_one(const WwArgs& a, int t, int k) {
  const int64_t j = (int64_t)t * a.K + k;
  const int s = a.tr_s[j];
  int r = k;
  for (int u = 0; u < a.T; ++u)
    if (u != t) r += ww_count_below(a.tr_s + (int64_t)u * a.K, ww_nrec(a, u), s, u < t);
  a.ev_s[r] = s;
  a.ev_frac[r] = a.tr_frac[j];
  a.ev_tt[r] = (uint8_t)(t | (a.tr_top[j] != 0 ? 16 : 0));
}

// ---------------------------------------------------------------------------
// phase B: the pulse/clock/blockmark machine (ww.ww_global_scan) over the
// merged events, one thread
// ---------------------------------------------------------------------------

// the machine's arrays: shared memory on the card, the stack on the host
struct WwMachineMem {
  float ring[WW_CLK_RING];            // clkavg.t_bitspacing
  float lps[WW_MAX_TRACKS];           // per-track last pulse start
  float lpe[WW_MAX_TRACKS];           // per-track last pulse end
  float lpk[WW_MAX_TRACKS];           // per-track last peak
  float plpk[WW_MAX_TRACKS];          // per-track peak before that
  int32_t hist[WW_MAX_TRACKS * 50];   // the skew histogram
  int32_t trksum[WW_MAX_TRACKS];      // its in-range counts
};

struct WwMachine {
  float avg;                          // clkavg.t_bitspaceavg
  int bitndx;
  float t_lcs, t_lce;                 // last clock pulse start / end
  float t_lpcs, t_lacs, t_lpce;       // last pri/alt clock start, pri end
  float t_lbm, ww_lastpeak;           // last blockmark, last peak
  int datablock, flux, flux_set, nflux;
  int datacount, blockstart, nblocks, miss1, missclk, base, nev;
  WwMachineMem* mem;
};

NRZI_HD void ww_clock_reset(WwMachine& m, float spb) {
  m.avg = spb;
  for (int k = 0; k < WW_CLK_RING; ++k) m.mem->ring[k] = spb;
  m.bitndx = 0;
}

NRZI_HD float ww_shift(float x, float dsf) { return x == 0.0f ? 0.0f : x - dsf; }

// every carried time shifts down by dsf; 0.0 ('never') stays
NRZI_HD void ww_rebase(WwMachine& m, int T, float dsf) {
  m.t_lcs = ww_shift(m.t_lcs, dsf);
  m.t_lce = ww_shift(m.t_lce, dsf);
  m.t_lpcs = ww_shift(m.t_lpcs, dsf);
  m.t_lacs = ww_shift(m.t_lacs, dsf);
  m.t_lpce = ww_shift(m.t_lpce, dsf);
  m.t_lbm = ww_shift(m.t_lbm, dsf);
  m.ww_lastpeak = ww_shift(m.ww_lastpeak, dsf);
  WwMachineMem& q = *m.mem;
  for (int t = 0; t < T; ++t) {
    q.lps[t] = ww_shift(q.lps[t], dsf);
    q.lpe[t] = ww_shift(q.lpe[t], dsf);
    q.lpk[t] = ww_shift(q.lpk[t], dsf);
    q.plpk[t] = ww_shift(q.plpk[t], dsf);
  }
}

// a block boundary (ww_end_of_block / ww_blockmark): the record, clamped
// to the last one once full; then ww_init_blockstate
NRZI_HD void ww_emit(WwMachine& m, const WwArgs& a, int btype, float end_t) {
  int i = ww_imin(m.nblocks, a.maxblocks - 1);
  int32_t* bi = a.blk_i + (int64_t)i * N_WB;
  bi[WB_START] = m.blockstart;
  bi[WB_END] = m.datacount;
  bi[WB_TYPE] = btype;
  bi[WB_TBASE] = m.base;
  bi[WB_MISS1] = m.miss1;
  bi[WB_MISSCLK] = m.missclk;
  a.blk_f[(int64_t)i * N_WBF + WBF_TEND] = end_t;
  a.blk_f[(int64_t)i * N_WBF + WBF_BITSPACE] = m.avg;
  m.nblocks += 1;
  m.blockstart = m.datacount;
  m.miss1 = 0;
  m.missclk = 0;
  ww_clock_reset(m, a.spb);
  m.t_lcs = m.t_lce = m.t_lpce = m.t_lpcs = m.t_lacs = 0.0f;
  m.datablock = 0;
  for (int t = 0; t < a.T; ++t) m.mem->lpk[t] = m.mem->plpk[t] = 0.0f;
}

// common.adjust_clock: moving window, exponential or constant
NRZI_HD void ww_adjust_clock(WwMachine& m, const WwArgs& a, float delta) {
  const int cw = a.clk_window;
  if (cw > 0) {
    float old = m.mem->ring[m.bitndx];
    m.mem->ring[m.bitndx] = delta;
    m.bitndx = m.bitndx + 1 >= cw ? 0 : m.bitndx + 1;
    m.avg = m.avg + (delta - old) / (float)cw;
  } else if (a.clk_alpha > 0.0f) {
    // XLA fuses (1 - a) * avg here, not a * delta as in the NRZI machine
    m.avg = fmaf(1.0f - a.clk_alpha, m.avg, a.clk_alpha * delta);
  } else {
    m.avg = a.spb;
  }
}

// ww_chk_databits at a clock pulse end (decode_ww.c:51-92): 1 = a pulse
// start within the bit time before clkend, 2 = none, 0 = no such track
NRZI_HD int ww_chk(const WwMachine& m, int trk, float lo, float clkend) {
  if (trk < 0) return 0;
  float tps = m.mem->lps[trk];
  return (tps > lo && tps < clkend) ? 1 : 2;
}

template <bool REC>
NRZI_HD void ww_chk_databits(WwMachine& m, const WwArgs& a, float clkend) {
  const float lo = clkend - m.avg;
  int r_pm = ww_chk(m, a.role[WW_PRI_MSB], lo, clkend);
  int r_am = ww_chk(m, a.role[WW_ALT_MSB], lo, clkend);
  int r_pl = ww_chk(m, a.role[WW_PRI_LSB], lo, clkend);
  int r_al = ww_chk(m, a.role[WW_ALT_LSB], lo, clkend);
  int msb = (r_pm == 1 || r_am == 1) ? 1 : 0;
  int lsb = (r_pl == 1 || r_al == 1) ? 1 : 0;
  int miss = ((r_pm | r_am) == 3 ? 1 : 0) + ((r_pl | r_al) == 3 ? 1 : 0);
  a.chars[ww_imin(m.datacount, a.maxchars - 1)] = (int8_t)((msb << 1) | lsb);
  if (REC) a.char_t[ww_imin(m.datacount, a.maxchars - 1)] = clkend;
  m.datacount = ww_imin(m.datacount + 1, a.maxchars);
  m.miss1 += miss;
}

NRZI_HD bool ww_is_clk(const WwArgs& a, int trk) {
  return trk == a.role[WW_PRI_CLK] || trk == a.role[WW_ALT_CLK];
}

NRZI_HD bool ww_is_lsb(const WwArgs& a, int trk) {
  return trk == a.role[WW_PRI_LSB] || trk == a.role[WW_ALT_LSB];
}

// an LSB pulse end straggling past the last clock (decode_ww.c:148-158)
NRZI_HD bool ww_lsb_strag(const WwMachine& m, const WwArgs& a, float b) {
  bool strag = false;
  const int lt[2] = {a.role[WW_PRI_LSB], a.role[WW_ALT_LSB]};
  for (int k = 0; k < 2; ++k)
    if (lt[k] >= 0) strag = strag || (m.mem->lpe[lt[k]] - m.t_lce > b * 0.5f);
  return strag;
}

// the machine before the first event; mem: its arrays
NRZI_HD void ww_machine_init(WwMachine& m, const WwArgs& a, WwMachineMem* mem) {
  m.mem = mem;
  ww_clock_reset(m, a.spb);
  m.t_lcs = m.t_lce = m.t_lpcs = m.t_lacs = m.t_lpce = m.t_lbm = 0.0f;
  m.ww_lastpeak = 0.0f;
  for (int t = 0; t < WW_MAX_TRACKS; ++t) {
    mem->lps[t] = mem->lpe[t] = mem->lpk[t] = mem->plpk[t] = 0.0f;
    mem->trksum[t] = 0;
  }
  for (int i = 0; i < WW_MAX_TRACKS * 50; ++i) mem->hist[i] = 0;
  m.datablock = 0;
  m.flux = a.fluxdir == WW_FLUX_AUTO ? WW_FLUX_NEG : a.fluxdir;
  m.flux_set = 0;
  m.nflux = 0;
  m.datacount = m.blockstart = m.nblocks = m.miss1 = m.missclk = m.base = 0;
  m.nev = 0;
}

// one merged event (ww_global_scan's step for a valid event); tt: the
// packed track | is_top << 4; REC: the record mode (WwArgs::char_t set)
template <bool REC = false>
NRZI_HD void ww_event(WwMachine& m, const WwArgs& a, int s, float frac, int tt) {
  const int trk = tt & 15;
  const bool is_top = (tt & 16) != 0;
  WwMachineMem& q = *m.mem;
  m.nev += 1;
  const float b = m.avg;
  // the rolling rebase: carried times are relative to an integer base
  const int ds = s - m.base;
  if (ds > a.span) {
    ww_rebase(m, a.T, (float)ds);
    m.base = s;
  }
  const float s_rel = (float)(s - m.base);
  const float t = s_rel + frac;

  // block end between events: the clock stopped (decoder.c:892-894)
  if (m.datablock && m.t_lce > 0.0f && s_rel - m.t_lce > b * 1.5f) {
    bool strag = ww_lsb_strag(m, a, b);
    ww_emit(m, a, WW_BS_BLOCK, t);
    if (strag) {
      ww_emit(m, a, WW_BS_TAPEMARK, t);
      m.t_lbm = t;
    }
  }

  // flux direction (decode_ww.c:244-271)
  int flux = a.fluxdir;
  if (a.fluxdir == WW_FLUX_AUTO) {
    if (t - m.ww_lastpeak > b * 2.0f) {
      int newdir = is_top ? WW_FLUX_POS : WW_FLUX_NEG;
      if (m.flux_set && newdir != m.flux) m.nflux += 1;
      m.flux = newdir;
      m.flux_set = 1;
    }
    flux = m.flux;
  }
  m.ww_lastpeak = t;

  if (is_top == (flux == WW_FLUX_POS)) {
    // ---- pulse start (decode_ww.c:167-183) ----
    q.lps[trk] = t;
    if (ww_is_clk(a, trk)) {
      m.datablock = 1;
      float d = t - q.plpk[trk];
      if (d < b * 2.0f) ww_adjust_clock(m, a, d);
      m.t_lcs = t;
    }
    if (trk == a.role[WW_PRI_CLK]) m.t_lpcs = t;
    if (trk == a.role[WW_ALT_CLK]) m.t_lacs = t;
  } else {
    // ---- pulse end (decode_ww.c:185-232) ----
    q.lpe[trk] = t;
    // skew statistics vs the last primary clock pulse end
    float delta = t - m.t_lpce;
    if (m.t_lpce > 0.0f && delta > -b * 1.5f && delta < b * 1.5f) {
      if (delta <= 0.0f || delta < b * 0.5f) delta = delta + b;
      int bkt = nrzi_f2i((delta - a.stat_lb) / a.stat_bw);
      q.hist[trk * 50 + (bkt < 0 ? 0 : (bkt > 49 ? 49 : bkt))] += 1;
      if (bkt >= 0 && bkt <= 49) q.trksum[trk] += 1;
    }
    if (ww_is_clk(a, trk)) {
      if (t - m.t_lce > b * 0.5f) ww_chk_databits<REC>(m, a, t);
      m.t_lce = t;
    }
    // missing-clock warnings (decode_ww.c:210-223)
    if (trk == a.role[WW_PRI_CLK]) {
      if (m.t_lacs > 0.0f && m.t_lacs < t - b) m.missclk += 1;
      m.t_lpce = t;
    }
    if (trk == a.role[WW_ALT_CLK] && m.t_lpcs > 0.0f && m.t_lpcs < t - b)
      m.missclk += 1;
    // standalone blockmark: LSB pulse end with no clock running
    if (ww_is_lsb(a, trk) && m.t_lcs == 0.0f && t - m.t_lbm > b) {
      ww_emit(m, a, WW_BS_TAPEMARK, t);
      m.t_lbm = t;
    }
  }
  // per-track peak history (process_up/down_transition tail)
  q.plpk[trk] = q.lpk[trk];
  q.lpk[trk] = t;
}

// after the last event: flush a trailing block (samples continue past the
// last event, so the clock-stop check would have fired eventually), then
// the histogram, its in-range counts and the scalars
NRZI_HD void ww_machine_finish(WwMachine& m, const WwArgs& a) {
  bool strag = ww_lsb_strag(m, a, m.avg);
  if (m.datablock && m.t_lce > 0.0f) {
    ww_emit(m, a, WW_BS_BLOCK, m.t_lce);
    if (strag) ww_emit(m, a, WW_BS_TAPEMARK, m.t_lce);
  }
  for (int i = 0; i < a.T * 50; ++i) a.hist[i] = m.mem->hist[i];
  for (int t = 0; t < a.T; ++t) a.trk_i[t * N_WT + WT_TRKSUM] = m.mem->trksum[t];
  a.scal[WS_DATACOUNT] = m.datacount;
  a.scal[WS_NBLOCKS] = m.nblocks;
  a.scal[WS_FLUX] = m.flux;
  a.scal[WS_NFLUX] = m.nflux;
  a.scal[WS_BASE] = m.base;
  a.scal[WS_NEVENTS] = m.nev;
}

// the number of merged events: every track's kept records
NRZI_HD int ww_nevents(const WwArgs& a) {
  int n = 0;
  for (int t = 0; t < a.T; ++t) n += ww_nrec(a, t);
  return n;
}
