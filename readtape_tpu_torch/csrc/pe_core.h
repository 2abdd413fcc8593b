// The PE decode state machine shared by the CUDA kernel (pe_fused.cu) and
// a host build used only by the tests. Every function is
// __host__ __device__ and touches one (segment, parmset) lane.
//
// Semantics: the JAX package's _pe_segment_device
// (readtape_tpu/decode/pipeline.py) over readtape_tpu/decode/pe.py --
// pe_track_scan(pre=True, idle_out=True), pe_idle_tau, pe_apply_tau and
// pe_replay_streams -- which the plain PyTorch version
// (readtape_tpu_torch/decode/fused.py::pe_fused_scan_plain) mirrors.
// Float expressions keep the reference's operation order; fmaf() stands
// exactly where the plain version calls common.fma (XLA's CPU
// contractions), and everything else rounds on its own (--fmad=false;
// host: -ffp-contract=off).
#pragma once

#include "nrzi_core.h"

#define PE_RUN_CAP 128
#define PE_IDLE_CAP 510
#define PE_IDLE_ECAP 128
#define PE_BIG_TAU (1 << 30)
#define PE_IDLE_FACTOR 2.5f

// per-track / per-lane output columns (decode/fused.py PI_*, TF_*, PL_*)
#define PI_DC 0
#define PI_PEAKCNT 1
#define PI_CORR 2
#define PI_TRKSUM 3
#define PI_INCOMP 4
#define PI_NTOTAL 5
#define N_PI 6
#define PL_TAU 0
#define PL_GAVEUP 1
#define PL_CAND_AFTER 2
#define PL_CAND_RACE 3
#define N_PL 4

// one record per admitted peak: integer and float columns
#define PR_SDET 0
#define PR_WIDX 1
#define PR_RSTART 2
#define PR_RLEN 3
#define PR_FLAGS 4        // bitval | run_bit << 1 | run_valid << 2
#define PR_HB 5           // histogram code: 0..49, 52/53 out of range, 50 none
#define N_PR 6
#define PRF_TFB 0
#define PRF_TLB 1
#define PRF_AGCMX 2
#define PRF_AGCMN 3
#define N_PRF 4
// per-track scan results
#define PS_NADM 0
#define PS_INCOMP 1
#define PS_NIE 2
#define PS_TRAIL 3
#define N_PS 4
// per-lane phase stamps (only when the PE or GCR argument block's stamps
// is set): the global timer (ns) at the start and end, clock64() at the
// start and after phases 0, A, B and C, then each track's clock64()
// cycles spent walking in phase A (the rest of the phase it waits at the
// chunk barriers), then each track's admission steps
#define PE_ST_G0 0
#define PE_ST_C0 1
#define PE_ST_CZ 2
#define PE_ST_CA 3
#define PE_ST_CB 4
#define PE_ST_CC 5
#define PE_ST_G1 6
#define PE_ST_WALK 7
#define PE_ST_STEPS (PE_ST_WALK + NRZI_MAX_TRACKS)
#define PE_NSTAMP (PE_ST_STEPS + NRZI_MAX_TRACKS)

#ifdef __CUDACC__
// The PE and GCR kernels (one block per lane, argument blocks with stamps
// and the lane's widest window wmax)
#define PE_THREADS 512
#define PE_WALK_WARPS 12         // at most this many warps hold walkers
#define PE_CHUNK 256             // phase A: samples per chunk, at most
#define PE_SMEM_MAX 232448       // shared memory a block may use

// thread 0 stamps column k of the lane's phase clocks (breakdown only)
template <class A>
__device__ __forceinline__ void pe_stamp(const A& a, int lane, int k) {
  if (a.stamps && threadIdx.x == 0)
    a.stamps[(int64_t)lane * PE_NSTAMP + k] =
        k == PE_ST_G0 || k == PE_ST_G1 ? nrzi_gtimer() : clock64();
}

// phase A's shared memory at chunk C for T tracks, window widths <= Wmax:
// the staging and feature slots, each track's AGC and clock rings
static inline size_t pe_smem(int T, int C, int Wmax) {
  return nrzi_stage_smem(T, C, Wmax) +
         (size_t)T * (NRZI_MAX_AGC_RING + NRZI_MAX_CLK_RING) * 4;
}

// phase A's chunk: PE_CHUNK, halved until the shared memory fits (0: none
// fits)
static inline int pe_chunk(int T, int Wmax) {
  int C = PE_CHUNK;
  while (C > 32 && pe_smem(T, C, Wmax) > PE_SMEM_MAX) C >>= 1;
  return pe_smem(T, C, Wmax) > PE_SMEM_MAX ? 0 : C;
}
#endif

// Everything one launch needs. Pointers are device pointers for the
// kernel and host pointers for the host build. Lane = b * P + p.
struct PeArgs {
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
  const float* p_clk_factor;
  const float* p_pulse_adj;
  const int32_t* wset;       // [G] distinct window widths, ascending
  const float* rise_floor;   // [T]
  const float* min_floor;    // [T]
  uint32_t* cand;            // scratch [B*P, T, NW] candidate bit words
  int32_t* rec_i;            // scratch [B*P, T, K, N_PR]
  float* rec_f;              // scratch [B*P, T, K, N_PRF]
  int32_t* ie;               // scratch [B*P, T, PE_IDLE_CAP, 2] (entry, wake)
  int32_t* scan;             // scratch [B*P, T, N_PS]
  int8_t* bits;              // [B*P, T, maxb]
  int8_t* faked;             // [B*P, T, maxb]
  int32_t* hist;             // [B*P, T, 50]
  int32_t* trk_i;            // [B*P, T, N_PI]
  float* trk_f;              // [B*P, T, N_TF]
  int32_t* lane_i;           // [B*P, N_PL]
  int64_t* stamps;           // [B*P, PE_NSTAMP] phase clocks, or null
  // -trace's record mode, or null (PE_DBG_* below)
  float* dbg_f;              // [B*P, T, K, 2] peak time, clock window after it
  int32_t* dbg_i;            // [B*P, T, K, 2] top, is_data | bitval << 1
  int32_t B, P, T, S, G, K, maxb, max_steps;
  int32_t wmax;              // the widest of p_w
  float spb, stat_lb, stat_bw;
};

// Record mode (dbg_f set; REC in the PE and GCR kernels, each its own
// instantiation of the kernel, its walk and its candidate floor, so that
// the decode's instantiation carries none of it): the JAX package's
// -trace scan (pe_track_scan / gcr_track_scan without idle tracking)
// instead of the decode's: every track's candidates in [0, seg_len), no
// staggered start; PE's pre-first-peak t_lastpeak 0 and its exponential
// clock contracted as fma(1 - a, avg, a * delta), as XLA's CPU build
// compiles that scan; GCR's mid-scan idle never drops datablock. Each
// admission also writes its row of dbg_f and dbg_i (two columns each,
// what the -trace lanes read). The other outputs are then those of that
// scan, which nothing reads.

// Phase 0 and phase B below also serve the GCR kernel (gcr_core.h): they
// are templates over the argument block, which must have the fields they
// read (volts, seg_len, lead, p_w, wset, rise_floor, min_floor, cand, ie,
// scan, B, P, T, S, G) with PeArgs' meaning and layouts. REC selects
// the record mode's candidate floor.
template <class A>
NRZI_HD int pe_nwords(const A& a) { return (a.S + 31) >> 5; }

NRZI_HD int pe_imin(int x, int y) { return x < y ? x : y; }
NRZI_HD int pe_imax(int x, int y) { return x > y ? x : y; }

// ---------------------------------------------------------------------------
// phase 0: loose candidacy over the union of window widths, masked to the
// track's own [lead + t + W - 1, seg_len): the reference's moving window
// refills sample by sample after each track's staggered start
// (pipeline.py _pe_segment_device, _mask_jump_table per window width)
// ---------------------------------------------------------------------------

template <class A>
NRZI_HD bool pe_union_at(const A& a, const float* v, int t, int s) {
  bool c = false;
  for (int g = 0; g < a.G && !c; ++g)
    c = nrzi_loose_at(v, s, a.wset[g], a.rise_floor[t], a.min_floor[t]);
  return c;
}

// the first sample of segment b where track t's window of width W may
// hold a candidate (0 in record mode)
template <bool REC, class A>
NRZI_HD int pe_track_lo(const A& a, int b, int t, int W) {
  return REC ? 0 : a.lead[b] + t + W - 1;
}

// the candidate bit of sample s of track t (a kernel builds a word from 32
// lanes: each reads its own window, so neighbouring lanes read
// neighbouring samples)
template <bool REC, class A>
NRZI_HD bool pe_cand_bit(const A& a, int lane, int t, int s) {
  const int b = lane / a.P, p = lane % a.P;
  const float* v = a.volts + ((int64_t)b * a.T + t) * a.S;
  const int lo = pe_track_lo<REC>(a, b, t, a.p_w[p]);
  const int hi = pe_imin(a.seg_len[b], a.S);
  return s >= lo && s < hi && pe_union_at(a, v, t, s);
}

// pe.idle_entry_sample: the first integer sample >= s_floor where
// f32(s) - t_lp > thr, by four probes around floor(t_lp + thr)
NRZI_HD int pe_idle_entry(float t_lp, float thr, int s_floor) {
  const int c = nrzi_f2i(floorf(t_lp + thr));
  int e = c + 2;
  for (int k = 3; k >= 0; --k)
    if (((float)(c - 1 + k) - t_lp) > thr) e = c - 1 + k;
  return pe_imax(e, s_floor);
}

// ---------------------------------------------------------------------------
// phase A: one track's admission scan with the PE state machine
// (trackscan.run_jump_scan_seq + pe.pe_track_scan's step). Non-admitting
// steps leave the PE state untouched, so only admissions run it; each
// admission appends one record and, when the track had gone idle before
// it, one idle interval (entry, wake). The walk goes chunk by chunk
// (nrzi_walk_chunk) over feature rows the caller computes ahead of it
// (nrzi_feature_rows).
// ---------------------------------------------------------------------------

// one track's admission walk: its knobs, outputs and state. REC: the
// record mode (PeArgs::dbg_f set), its own instantiation (PeTraceWalk), so
// that the decode's walk (PeWalk) carries none of it
template <bool REC>
struct PeWalkT {
  NrziCursor cur;
  int steps;
  // admission + AGC state (trackscan.admission_init, common.agc_state_init)
  float agc, vah, vah_sum;
  int vah_cnt, hndx, peakcount, n_adm;
  float max_agc, min_agc, v_lasttop, v_lastbot, v_top, v_bot;
  float* heights;            // [NRZI_MAX_AGC_RING] the AGC window
  // clock (common.clkavg_init)
  float* ring;               // [NRZI_MAX_CLK_RING] clkavg.t_bitspacing
  int bitndx;
  float avg;
  // PE state
  bool idle, datablock, clknext, bit1_up, lastdatabit;
  float t_clkwindow, t_pulse_adj, t_lastbit, t_firstbit, t_lastpeak;
  int dc, s_lastdet, n_ie;
  // knobs and outputs
  int W, aw, cwin, maxb;
  float rise, minp, aa, ca, cf, padj, spb, stat_lb, stat_bw;
  int32_t* rec_i;            // [K, N_PR]
  float* rec_f;              // [K, N_PRF]
  int32_t* ie;               // [PE_IDLE_CAP, 2]
  float* dbg_f;              // [K, 2] record mode's rows
  int32_t* dbg_i;            // [K, 2]

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
    float thr0 = 0.005f / agc;
    float ref = is_top ? val - thr0 : val + thr0;
    bool pclose = is_top ? prv > ref : prv < ref;
    bool nclose = is_top ? nxt > ref : nxt < ref;
    float adj = (pclose && !nclose) ? -0.5f : ((nclose && !pclose) ? 0.5f : 0.0f);
    const float t_this = (float)s + (-((float)(W - L) - adj));
    if (is_top) v_top = val; else v_bot = val;

    const float s_now = (float)s;
    const float bsp = avg;                    // the pre-admission clock
    const int pc = peakcount + 1;

    // idle detection + fake-bit runs (decoder.c:868-877, decode_pe.c:245-258)
    const bool was_idle = idle || ((s_now - 1.0f - t_lastpeak) > bsp * PE_IDLE_FACTOR);
    const bool gen_fakes = was_idle && datablock && dc > 1;
    int numfake = 0;
    if (gen_fakes) {
      numfake = nrzi_f2i(floorf((s_now - t_lastbit) / nrzi_maxf(bsp, 1e-3f)));
      numfake = numfake > 0 ? numfake : 0;
    }
    const bool run_valid = gen_fakes && numfake > 0;
    const int run_start = dc;
    const bool run_bit = lastdatabit;
    int dcn = pe_imin(dc + numfake, maxb);
    float tlb = run_valid ? 0.0f : t_lastbit;
    const bool clknext_f = gen_fakes ? lastdatabit : clknext;
    idle = false;

    // preamble (decode_pe.c:127-155)
    const bool in_pre = !datablock;
    const bool bit1 = (in_pre && pc == 1) ? !is_top : bit1_up;
    const bool start_data = in_pre && pc > 70 && (bit1 == is_top) &&
                            ((t_this - t_lastpeak) > t_clkwindow);
    const bool clknext_pre = is_top != bit1;
    const bool acc_ok = in_pre && !start_data && pc >= 5 && pc <= 15 && v_top > v_bot;
    const float vah_next =
        start_data ? vah_sum / (float)(vah_cnt > 1 ? vah_cnt : 1) : vah;

    // data classification (decode_pe.c:157-201)
    const bool in_data = datablock;
    int hb = 50;
    if (in_data) {
      int bkt = nrzi_f2i(((t_this - t_lastpeak) - stat_lb) / stat_bw);
      hb = bkt < 0 ? 52 : (bkt > 49 ? 53 : bkt);
    }
    const bool missed = (t_this + t_pulse_adj) - t_lastpeak > t_clkwindow;
    const bool is_data = in_data && (!clknext || missed);
    const bool bitval = is_top ? bit1 : !bit1;
    int widx = maxb;
    if (is_data) {
      // pe_addbit (decode_pe.c:104-125): adjust_clock on every data bit
      const float seed = (tlb == 0.0f) ? t_this - spb : tlb;
      const float delta = t_this - seed;
      if (cwin > 0) {
        float old = ring[bitndx];
        ring[bitndx] = delta;
        bitndx = bitndx + 1 >= cwin ? 0 : bitndx + 1;
        avg = bsp + (delta - old) / (float)cwin;
      } else if (ca > 0.0f) {
        // XLA's CPU build contracts the -trace scan's the other way
        avg = REC ? fmaf(1.0f - ca, bsp, ca * delta) : fmaf(ca, delta, (1.0f - ca) * bsp);
      } else {
        avg = spb;
      }
      t_clkwindow = avg / 2.0f * cf;
      widx = pe_imin(dcn, maxb - 1);
      if (dcn == 0) t_firstbit = t_this;
      dcn = pe_imin(dcn + 1, maxb);
      tlb = t_this;
      lastdatabit = bitval;
    }
    const bool clknext_n = in_data ? is_data : ((in_pre && !start_data) ? clknext_pre : clknext_f);
    if (in_data)
      t_pulse_adj = ((t_this - t_lastpeak) - avg / (missed ? 1.0f : 2.0f)) * padj;

    // AGC: adjust_agc on every data-block peak, baseline in the preamble
    if (in_data) {
      const float lastheight = v_lasttop - v_lastbot;
      float g_exp = vah / nrzi_maxf(lastheight, 1e-9f);
      g_exp = fmaf(aa, g_exp, (1.0f - aa) * agc);
      g_exp = nrzi_minf(g_exp, 2.0f);
      const bool use_exp = aa > 0.0f && lastheight > 0.0f;
      const bool use_win = aw > 0 && lastheight > 0.0f;
      float gain = agc;
      if (use_exp) gain = g_exp;
      if (use_win) {
        heights[hndx] = lastheight;
        hndx = (hndx + 1 >= aw) ? 0 : hndx + 1;
        float minh = NRZI_FLT_MAX;
        for (int k = 0; k < NRZI_MAX_AGC_RING && k < aw; ++k)
          minh = nrzi_minf(minh, heights[k]);
        gain = nrzi_minf(vah / nrzi_maxf(minh, 1e-9f), 2.0f);
      }
      if (use_exp || use_win) {
        if (gain > max_agc) max_agc = gain;
        if (gain < min_agc) min_agc = gain;
      }
      agc = gain;
    } else if (acc_ok) {                       // accumulate_baseline
      const float height = v_top - v_bot;
      vah_sum = vah_sum + height;
      vah_cnt += 1;
      heights[hndx] = height;
      hndx = (hndx + 1 >= aw) ? 0 : hndx + 1;
    }
    vah = vah_next;
    if (is_top) v_lasttop = f.wmax; else v_lastbot = f.wmin;

    // idle interval: entry from the pre-admission clock and t_lastpeak,
    // no earlier than the previous detection; compact_outputs' overflow
    // rule keeps the last one in the last slot
    const int entry = pe_idle_entry(t_lastpeak, bsp * PE_IDLE_FACTOR, s_lastdet);
    if (entry <= s - 1) {
      const int slot = n_ie < PE_IDLE_CAP - 1 ? n_ie : PE_IDLE_CAP - 1;
      ie[2 * slot] = entry;
      ie[2 * slot + 1] = s;
      n_ie += 1;
    }
    s_lastdet = s;
    t_lastpeak = t_this;
    peakcount = pc;
    dc = dcn;
    t_lastbit = tlb;
    clknext = clknext_n;
    bit1_up = bit1;
    datablock = datablock || start_data;

    // the record (K >= max_steps: one per step at most, never overflows)
    int32_t* ri = rec_i + (int64_t)n_adm * N_PR;
    float* rf = rec_f + (int64_t)n_adm * N_PRF;
    ri[PR_SDET] = s;
    ri[PR_WIDX] = widx;
    ri[PR_RSTART] = run_start;
    ri[PR_RLEN] = numfake;
    ri[PR_FLAGS] = (int)bitval | ((int)run_bit << 1) | ((int)run_valid << 2);
    ri[PR_HB] = hb;
    rf[PRF_TFB] = t_firstbit;
    rf[PRF_TLB] = t_lastbit;
    rf[PRF_AGCMX] = max_agc;
    rf[PRF_AGCMN] = min_agc;
    if (REC) {
      dbg_f[2 * n_adm] = t_this;
      dbg_f[2 * n_adm + 1] = t_clkwindow;
      dbg_i[2 * n_adm] = is_top;
      dbg_i[2 * n_adm + 1] = (int)is_data | ((int)bitval << 1);
    }
    n_adm += 1;
    // blind until the peak leaves the window: the next step tests s + L + 1
    cur.pos = s + L + 1;
    cur.search = false;
  }
};
using PeWalk = PeWalkT<false>;
using PeTraceWalk = PeWalkT<true>;

// track t of a lane at the start of its segment; heights, ring:
// NRZI_MAX_AGC_RING and NRZI_MAX_CLK_RING floats
template <bool REC>
NRZI_HD void pe_walk_init(PeWalkT<REC>& w, const PeArgs& a, int lane, int t,
                          float* heights, float* ring) {
  const int b = lane / a.P, p = lane % a.P;
  const int64_t row = (int64_t)lane * a.T + t;
  w.cur.pos = 0;
  w.cur.search = true;
  w.steps = 0;
  w.agc = 1.0f;
  w.vah = 4.0f;
  w.vah_sum = 0.0f;
  w.vah_cnt = w.hndx = w.peakcount = w.n_adm = 0;
  w.max_agc = 0.0f;
  w.min_agc = NRZI_FLT_MAX;
  w.v_lasttop = w.v_lastbot = w.v_top = w.v_bot = 0.0f;
  w.heights = heights;
  for (int k = 0; k < NRZI_MAX_AGC_RING; ++k) heights[k] = 0.0f;
  w.spb = a.spb;
  w.ring = ring;
  for (int k = 0; k < NRZI_MAX_CLK_RING; ++k) ring[k] = a.spb;
  w.bitndx = 0;
  w.avg = a.spb;
  // the virtual pre-first-peak t_lastpeak is the track's staggered start
  // (decoder.c:856-862; 0 in record mode), its first idle check one later
  w.idle = true;
  w.datablock = w.clknext = false;
  w.bit1_up = true;
  w.lastdatabit = false;
  w.cf = a.p_clk_factor[p];
  w.t_clkwindow = a.spb / 2.0f * w.cf;
  w.t_pulse_adj = w.t_lastbit = w.t_firstbit = 0.0f;
  w.t_lastpeak = REC ? 0.0f : (float)(a.lead[b] + t);
  w.dc = 0;
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
  w.padj = a.p_pulse_adj[p];
  w.stat_lb = a.stat_lb;
  w.stat_bw = a.stat_bw;
  w.rec_i = a.rec_i + row * a.K * N_PR;
  w.rec_f = a.rec_f + row * a.K * N_PRF;
  w.ie = a.ie + row * PE_IDLE_CAP * 2;
  if (REC) {
    w.dbg_f = a.dbg_f + row * a.K * 2;
    w.dbg_i = a.dbg_i + row * a.K * 2;
  }
}

// the track's scan results once its walk has stopped
template <bool REC>
NRZI_HD void pe_walk_finish(const PeWalkT<REC>& w, const PeArgs& a, int lane, int t) {
  int32_t* sc = a.scan + ((int64_t)lane * a.T + t) * N_PS;
  sc[PS_NADM] = w.n_adm;
  sc[PS_INCOMP] = w.cur.pos < a.S;
  sc[PS_NIE] = w.n_ie;
  sc[PS_TRAIL] = pe_idle_entry(w.t_lastpeak, w.avg * PE_IDLE_FACTOR, w.s_lastdet);
}

// ---------------------------------------------------------------------------
// phase B: the all-idle point tau (pe.pe_idle_tau over the intervals with
// the trailing entry appended, as _pe_segment_device builds them)
// ---------------------------------------------------------------------------

// interval c of track t: (entry, wake); c == n_c is the trailing entry
template <class A>
NRZI_HD void pe_interval(const A& a, int lane, int t, int c, int n_c, int& e,
                         int& w) {
  const int64_t row = (int64_t)lane * a.T + t;
  if (c < n_c) {
    e = a.ie[(row * PE_IDLE_CAP + c) * 2];
    w = a.ie[(row * PE_IDLE_CAP + c) * 2 + 1];
  } else {
    e = a.scan[row * N_PS + PS_TRAIL];
    w = PE_BIG_TAU;
  }
}

template <class A>
NRZI_HD int pe_count(const A& a, int lane, int t) {
  return pe_imin(a.scan[((int64_t)lane * a.T + t) * N_PS + PS_NIE], PE_IDLE_CAP);
}

// Is track t idle at sample s? Its intervals are sorted and disjoint by
// construction (each entry is no earlier than the detection that woke the
// previous interval), so the last interval starting at or before s
// decides: a binary search gives pe_idle_tau's any-over-intervals.
template <class A>
NRZI_HD bool pe_idle_at(const A& a, int lane, int t, int s) {
  const int n_c = pe_count(a, lane, t);
  const int nv = n_c < PE_IDLE_CAP ? n_c + 1 : n_c;   // valid intervals
  int lo = 0, hi = nv - 1, found = -1;
  while (lo <= hi) {
    const int mid = (lo + hi) >> 1;
    int e, w;
    pe_interval(a, lane, t, mid, n_c, e, w);
    if (e <= s) { found = mid; lo = mid + 1; } else { hi = mid - 1; }
  }
  if (found < 0) return false;
  int e, w;
  pe_interval(a, lane, t, found, n_c, e, w);
  return s < w;
}

// the smallest firing candidate among candidates tid, tid + n, ... of the
// lane's T * ECAP (track i, entry s): tracks k < i idle at s, k > i at s-1
template <class A>
NRZI_HD int pe_tau_part(const A& a, int lane, int tid, int n) {
  int best = PE_BIG_TAU;
  for (int q = tid; q < a.T * PE_IDLE_ECAP; q += n) {
    const int i = q / PE_IDLE_ECAP, c = q % PE_IDLE_ECAP;
    const int n_c = pe_count(a, lane, i);
    if (c > n_c) continue;
    int s, w;
    pe_interval(a, lane, i, c, n_c, s, w);
    if (s >= best) continue;
    bool fire = true;
    for (int k = 0; k < a.T && fire; ++k)
      if (k != i) fire = pe_idle_at(a, lane, k, k < i ? s : s - 1);
    if (fire) best = s;
  }
  return best;
}

// overflow: some track's intervals did not fit; deep: some track has more
// intervals than the candidate horizon
template <class A>
NRZI_HD void pe_lane_flags(const A& a, int lane, bool& overflow, bool& deep) {
  overflow = false;
  deep = false;
  for (int t = 0; t < a.T; ++t) {
    const int n = a.scan[((int64_t)lane * a.T + t) * N_PS + PS_NIE];
    overflow = overflow || n > PE_IDLE_CAP;
    deep = deep || n > PE_IDLE_ECAP;
  }
}

// ---------------------------------------------------------------------------
// phase C: one track's records replayed up to tau (pe.pe_apply_tau,
// pe_replay_streams), and its first candidates after tau
// ---------------------------------------------------------------------------

// first union candidate >= x on track t masked to [lead + t + Wmin - 1,
// seg_len) (the smallest-W jump table of _pe_segment_device), or S
template <bool REC, class A>
NRZI_HD int pe_first_cand(const A& a, int lane, int t, int x) {
  const int b = lane / a.P, p = lane % a.P, S = a.S;
  const float* v = a.volts + ((int64_t)b * a.T + t) * S;
  const int hi = pe_imin(a.seg_len[b], S);
  const int own = pe_track_lo<REC>(a, b, t, a.p_w[p]);   // the lane's bitmask starts here
  int s = pe_imax(x, pe_track_lo<REC>(a, b, t, a.wset[0]));
  for (; s < own && s < hi; ++s)
    if (pe_union_at(a, v, t, s)) return s;
  const int nw = pe_nwords(a);
  return nrzi_next_cand(a.cand + ((int64_t)lane * a.T + t) * nw, nw, S,
                        pe_imax(s, own));
}

template <bool REC>
NRZI_HD void pe_apply_track(const PeArgs& a, int lane, int t, int tau,
                            int& cand_after, int& cand_race) {
  const int64_t row = (int64_t)lane * a.T + t;
  const int maxb = a.maxb;
  const int32_t* rec_i = a.rec_i + row * a.K * N_PR;
  const float* rec_f = a.rec_f + row * a.K * N_PRF;
  int8_t* bits = a.bits + row * maxb;
  int8_t* faked = a.faked + row * maxb;
  int32_t* hist = a.hist + row * 50;
  const int n_adm = a.scan[row * N_PS + PS_NADM];

  // records are in detection order: the kept ones are a prefix
  int n_keep = 0;
  while (n_keep < n_adm && rec_i[(int64_t)n_keep * N_PR + PR_SDET] < tau) ++n_keep;
  int ndata = 0, fakes = 0, nruns = 0, trksum = 0;
  for (int r = 0; r < n_keep; ++r) {
    const int32_t* ri = rec_i + (int64_t)r * N_PR;
    const int widx = ri[PR_WIDX];
    if (widx < maxb) {
      bits[widx] = (int8_t)(ri[PR_FLAGS] & 1);        // the last write wins
      ndata += 1;
    }
    const int hb = ri[PR_HB];
    if (hb != 50) hist[hb == 52 ? 0 : (hb == 53 ? 49 : hb)] += 1;
    if (hb <= 49) trksum += 1;
    if (ri[PR_FLAGS] & 4) {
      fakes += ri[PR_RLEN];
      nruns += 1;
    }
  }
  // fake-bit runs overwrite the bits (non-overlapping by construction);
  // compact_outputs keeps the first RUN_CAP - 1 and the last one
  for (int r = 0, rank = 0; r < n_keep; ++r) {
    const int32_t* ri = rec_i + (int64_t)r * N_PR;
    if (!(ri[PR_FLAGS] & 4)) continue;
    if (rank < PE_RUN_CAP - 1 || rank == nruns - 1) {
      const int st = ri[PR_RSTART];
      const int en = pe_imin(st + ri[PR_RLEN], maxb);
      const int8_t bit = (int8_t)((ri[PR_FLAGS] >> 1) & 1);
      for (int i = st; i < en; ++i) {
        bits[i] = bit;
        faked[i] = 1;
      }
    }
    rank += 1;
  }
  int32_t* ti = a.trk_i + row * N_PI;
  float* tf = a.trk_f + row * N_TF;
  ti[PI_DC] = pe_imin(ndata + fakes, maxb);
  ti[PI_PEAKCNT] = n_keep;
  ti[PI_CORR] = fakes;
  ti[PI_TRKSUM] = trksum;
  ti[PI_INCOMP] = a.scan[row * N_PS + PS_INCOMP];
  ti[PI_NTOTAL] = n_adm;
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

  int max_w = 0;
  for (int p = 0; p < a.P; ++p) max_w = pe_imax(max_w, a.p_w[p]);
  const int S = a.S;
  cand_after = pe_first_cand<REC>(a, lane, t, pe_imax(0, pe_imin(tau + 1, S)));
  cand_race = pe_first_cand<REC>(a, lane, t, pe_imax(0, pe_imin(tau - max_w, S)));
}

NRZI_HD void pe_write_lane(const PeArgs& a, int lane, int tau, bool overflow,
                           bool deep, int cand_after, int cand_race) {
  int32_t* li = a.lane_i + (int64_t)lane * N_PL;
  if (overflow) tau = PE_BIG_TAU;
  li[PL_TAU] = tau;
  li[PL_GAVEUP] = overflow || (deep && tau >= PE_BIG_TAU);
  li[PL_CAND_AFTER] = cand_after;
  li[PL_CAND_RACE] = cand_race;
}

// zero one lane's bit, fake and histogram buffers (threads tid of n)
NRZI_HD void pe_zero_lane(const PeArgs& a, int lane, int tid, int n) {
  const int64_t nb = (int64_t)a.T * a.maxb;
  int8_t* bits = a.bits + (int64_t)lane * nb;
  int8_t* faked = a.faked + (int64_t)lane * nb;
  for (int64_t i = tid; i < nb; i += n) {
    bits[i] = 0;
    faked[i] = 0;
  }
  int32_t* hist = a.hist + (int64_t)lane * a.T * 50;
  for (int i = tid; i < a.T * 50; i += n) hist[i] = 0;
}

#ifdef __CUDACC__
// ---------------------------------------------------------------------------
// Phases 0 and A of the PE and GCR kernels (one block of PE_THREADS per
// lane), over their argument blocks A and their walks Walk
// ---------------------------------------------------------------------------

// phase 0's candidate words of a lane, cw [T, NW]: a warp per word, lane
// l tests sample 32 w + l (coalesced) and one ballot makes the word
template <bool REC, class A>
__device__ void pe_cand_words(const A& a, int lane, uint32_t* cw) {
  const int nw = pe_nwords(a), tid = threadIdx.x;
  for (int q = tid >> 5; q < a.T * nw; q += blockDim.x >> 5) {
    const bool c = pe_cand_bit<REC>(a, lane, q / nw, ((q % nw) << 5) + (tid & 31));
    const unsigned word = __ballot_sync(0xffffffffu, c);
    if ((tid & 31) == 0) cw[q] = word;
  }
}

// Phase A: one walker thread per track, each in a warp of its own (two
// per warp beyond PE_WALK_WARPS tracks); the other warps stage the lane in
// chunks of C samples a chunk ahead (NrziStager, with the lane's width
// W); the walkers walk each chunk (nrzi_walk_chunk) with their AGC and
// clock rings in shared memory and hand chunks over at a block barrier,
// which also ends the phase once every track has stopped. init(w, t,
// heights, ring) starts track t's walk, finish(w, t) writes its results.
// sm: pe_smem(T, C, a.wmax) bytes. Stamps each track's walking cycles and
// steps when a.stamps is set
template <class Walk, class A, class Init, class Finish>
__device__ void pe_phase_a(const A& a, int lane, const uint32_t* cw, unsigned char* sm,
                           int C, Init init, Finish finish) {
  const int tid = threadIdx.x, b = lane / a.P, T = a.T, S = a.S;
  const int nch = (S + C - 1) / C;
  // the walker of track t: lane t / nww of warp t % nww
  const int nww = T < PE_WALK_WARPS ? T : PE_WALK_WARPS;
  const int wt = (tid & 31) * nww + (tid >> 5);
  const int track = (tid >> 5) < nww && wt < T ? wt : -1;
  const int np = blockDim.x - 32 * nww, ptid = tid - 32 * nww;
  const bool stager = ptid >= 0;
  NrziStager sg;
  float* heights = (float*)sg.init(sm, a.volts + (int64_t)b * T * S, cw, T, S,
                                   a.p_w[lane % a.P], C, a.wmax, pe_nwords(a), ptid,
                                   np);                     // [T][NRZI_MAX_AGC_RING]
  float* rings = heights + T * NRZI_MAX_AGC_RING;           // [T][NRZI_MAX_CLK_RING]

  Walk w;
  bool alive = track >= 0;
  long long walked = 0;                    // cycles spent walking
  if (stager)
    sg.prime(nch);
  else if (alive)
    init(w, track, heights + track * NRZI_MAX_AGC_RING, rings + track * NRZI_MAX_CLK_RING);
  __syncthreads();
  for (int i = 0; i < nch; ++i) {
    if (stager) {
      sg.advance(i, nch);
    } else if (alive) {
      const int c0 = i * C;
      const long long c = clock64();
      alive = nrzi_walk_chunk(w, sg.words(i, track), sg.feat(i, track), c0,
                              min(c0 + C, S), S, a.max_steps);
      walked += clock64() - c;
    }
    if (!__syncthreads_or(alive)) break;
  }
  if (stager) nrzi_cp_wait();
  if (track >= 0) {
    finish(w, track);
    if (a.stamps) {
      a.stamps[(int64_t)lane * PE_NSTAMP + PE_ST_WALK + track] = walked;
      a.stamps[(int64_t)lane * PE_NSTAMP + PE_ST_STEPS + track] = w.steps;
    }
  }
  __syncthreads();
}
#endif
