// The NRZI decode state machine shared by the CUDA kernels (nrzi_fused.cu:
// B1, everything in one launch; nrzi_scan.cu: B5, admission alone;
// nrzi_slot.cu: B6, the slot machine alone) and a host build used only by
// the tests. Every function is __host__ __device__ and touches one
// (segment, parmset) lane, or one track of it.
//
// Semantics: readtape_tpu/decode/trackscan.py (admission, AGC policy) and
// readtape_tpu/decode/nrzi.py::nrzi_slot_scan (global slot machine,
// zerocheck, -correct), which the plain PyTorch version
// (readtape_tpu_torch/decode/fused.py::nrzi_fused_scan_plain) mirrors.
// Float expressions keep the reference's operation order. Where the JAX
// package's XLA scans form a fused multiply-add (common.fma in the plain
// version), this code calls fmaf(); everywhere else it must round every
// operation, so it is built with --fmad=false (host: -ffp-contract=off).
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define NRZI_HD __host__ __device__ __forceinline__
#define NRZI_HDM __host__ __device__ __forceinline__
#else
#define NRZI_HD static inline
#define NRZI_HDM inline
#endif

#define NRZI_MAX_TRACKS 16
#define NRZI_MAX_AGC_RING 16
#define NRZI_MAX_CLK_RING 64
#define NRZI_BIG_S (1 << 30)
#define NRZI_FLT_MAX 3.4028234663852886e38f
#define NRZI_NEG_T (-1e30f)

// per-track / per-lane output columns (decode/fused.py TI_*, TF_*, LI_*)
#define TI_DC 0
#define TI_KVIS 1
#define TI_NADM 2
#define TI_TRKSUM 3
#define TI_INCOMP 4
#define N_TI 5
#define TF_TFIRST 0
#define TF_TLAST 1
#define TF_MAXAGC 2
#define TF_MINAGC 3
#define N_TF 4
#define LI_MISSMID 0
#define LI_CORR 1
#define LI_FAKED 2
#define LI_CONSOVF 3
#define LI_ENDS 4
#define LI_NSLOT 5
#define N_LI 6

// Everything one launch needs. Pointers are device pointers for the
// kernel and host pointers for the host build. Lane = b * P + p.
struct NrziArgs {
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
  const float* p_pulse_adj;
  const float* p_midbit;
  const int32_t* wset;       // [G] distinct window widths
  const float* rise_floor;   // [T]
  const float* min_floor;    // [T]
  uint32_t* cand;            // scratch [B*P, T, NW] candidate bit words
  int32_t* tr_s;             // scratch [B*P, T, K]
  float* tr_t;
  float* tr_agc;
  int8_t* bits;              // [B*P, T, maxb]
  int32_t* hist;             // [B*P, T, 50]
  int32_t* trk_i;            // [B*P, T, N_TI]
  float* trk_f;              // [B*P, T, N_TF]
  int32_t* lane_i;           // [B*P, N_LI]
  int32_t B, P, T, S, G, K, maxb, max_slots, max_steps;
  int32_t do_correct, exp_par;
  float spb, stat_lb, stat_bw;
};

NRZI_HD int nrzi_nwords(const NrziArgs& a) { return (a.S + 31) >> 5; }

NRZI_HD float nrzi_maxf(float x, float y) { return x > y ? x : y; }
NRZI_HD float nrzi_minf(float x, float y) { return x < y ? x : y; }

// float -> int32 truncating toward zero, clamped (keeps the sign of an
// out-of-range quotient; the JAX side never sees one)
NRZI_HD int32_t nrzi_f2i(float x) {
  if (x > 1073741824.0f) return 1073741824;
  if (x < -1073741824.0f) return -1073741824;
  return (int32_t)x;
}

NRZI_HD int nrzi_ctz(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __ffs((int)m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// ---------------------------------------------------------------------------
// phase 0: loose candidacy (stage1.candidate_mask over the union of window
// widths), masked to [lead, seg_len) -- one 32-position word at a time
// ---------------------------------------------------------------------------

NRZI_HD bool nrzi_loose_at(const float* v, int s, int W, float rf, float mf) {
  int lo = s - W + 1;
  if (lo < 0) lo = 0;
  float wmax = v[lo], wmin = v[lo];
  for (int k = lo + 1; k <= s; ++k) {
    float x = v[k];
    wmax = x > wmax ? x : wmax;
    wmin = x < wmin ? x : wmin;
  }
  float vl = v[lo], vr = v[s];
  bool top = (wmax > vl + rf) && (wmax > vr + rf) && (mf <= 0.0f || wmax > mf);
  bool bot = (wmin < vl - rf) && (wmin < vr - rf) && (mf <= 0.0f || wmin < -mf);
  return top || bot;
}

NRZI_HD uint32_t nrzi_cand_word(const NrziArgs& a, int lane, int t, int w) {
  int b = lane / a.P;
  const float* v = a.volts + ((int64_t)b * a.T + t) * a.S;
  int lo = a.lead[b], hi = a.seg_len[b];
  if (hi > a.S) hi = a.S;
  float rf = a.rise_floor[t], mf = a.min_floor[t];
  uint32_t word = 0;
  for (int i = 0; i < 32; ++i) {
    int s = (w << 5) + i;
    if (s < lo || s >= hi) continue;
    bool c = false;
    for (int g = 0; g < a.G && !c; ++g) c = nrzi_loose_at(v, s, a.wset[g], rf, mf);
    if (c) word |= 1u << i;
  }
  return word;
}

// first candidate >= p, or S
NRZI_HD int nrzi_next_cand(const uint32_t* words, int nw, int S, int p) {
  if (p >= S) return S;
  int w = p >> 5;
  uint32_t m = words[w] & (0xffffffffu << (p & 31));
  while (m == 0) {
    if (++w >= nw) return S;
    m = words[w];
  }
  int s = (w << 5) + nrzi_ctz(m);
  return s < S ? s : S;
}

// ---------------------------------------------------------------------------
// phase A: one track's admission scan (trackscan.run_jump_scan_seq +
// nrzi_track_scan_pre + nrzi_agc_policy), over a candidate source: B1's
// candidate bitmask with features computed from the volts, or B5's masked
// jump table with precomputed features (NrziMaskSrc / NrziTableSrc)
// ---------------------------------------------------------------------------

struct NrziFeat {
  float wmax, wmin, vleft, vright, prevmax, nextmax, prevmin, nextmin;
  int ltop, lbot;
};

// trackscan.precompute_window_features at one position: the trailing
// window [max(0, s-W+1), s], first (leftmost) extremum, its neighbours
// (0.0 past either end of the segment). v[k - base] holds sample k: the
// samples s-W .. s+1 that lie in [0, S) must be there
NRZI_HD void nrzi_features_at(const float* v, int base, int S, int s, int W,
                              NrziFeat& f) {
  int lo = s - W + 1;
  if (lo < 0) lo = 0;
  int kt = lo, kb = lo;
  float mx = v[lo - base], mn = v[lo - base];
  for (int k = lo + 1; k <= s; ++k) {
    float x = v[k - base];
    if (x > mx) { mx = x; kt = k; }
    if (x < mn) { mn = x; kb = k; }
  }
  f.wmax = mx;
  f.wmin = mn;
  f.vleft = v[lo - base];
  f.vright = v[s - base];
  f.prevmax = kt > 0 ? v[kt - 1 - base] : 0.0f;
  f.nextmax = kt + 1 < S ? v[kt + 1 - base] : 0.0f;
  f.prevmin = kb > 0 ? v[kb - 1 - base] : 0.0f;
  f.nextmin = kb + 1 < S ? v[kb + 1 - base] : 0.0f;
  f.ltop = kt - lo + 1;
  f.lbot = kb - lo + 1;
}

NRZI_HD void nrzi_features(const float* v, int S, int s, int W, NrziFeat& f) {
  nrzi_features_at(v, 0, S, s, W, f);
}

// ---------------------------------------------------------------------------
// The chunked admission walk (B2, B4): a track's tape is cut into chunks
// of C samples (C a multiple of 32); for each chunk the caller provides
// the chunk's candidate words and the window features at its candidates,
// and the walk runs the same steps run_jump_scan_seq takes over the whole
// track. The cursor carries across chunks: a blind jump may land past the
// chunk, and a search for the next candidate goes on in the next one.
// ---------------------------------------------------------------------------

// where a track's walk stands: the next sample to test (landed), or the
// sample to search for the next candidate from (search)
struct NrziCursor {
  int pos;
  bool search;
};

// words[i]: the candidate bits of samples c0 + 32 i .. c0 + 32 i + 31
NRZI_HD bool nrzi_chunk_cand(const uint32_t* words, int c0, int s) {
  const int i = s - c0;
  return (words[i >> 5] >> (i & 31)) & 1u;
}

// A searching cursor moves to the first candidate >= pos in [pos, c1)
// and lands there; with none, it moves to c1 and searches on in the next
// chunk, or lands at S (none left: nrzi_next_cand's S)
NRZI_HD void nrzi_cursor_seek(NrziCursor& c, const uint32_t* words, int c0,
                              int c1, int S) {
  int i = c.pos - c0;
  const int n = c1 - c0;
  while (i < n) {
    uint32_t m = words[i >> 5] & (0xffffffffu << (i & 31));
    if (m) {
      const int s = c0 + ((i >> 5) << 5) + nrzi_ctz(m);
      if (s < c1) {
        c.pos = s < S ? s : S;
        c.search = false;
        return;
      }
      break;
    }
    i = ((i >> 5) + 1) << 5;
  }
  c.pos = c1 < S ? c1 : S;
  c.search = c1 < S;
}

// the window features at the candidates of the chunk [c0, c1) into
// rows[s - c0] (other rows untouched): v[k - base] holds sample k for k
// in [nrzi_stage_lo, nrzi_stage_hi), words the chunk's candidate words.
// Threads tid of n share the rows
NRZI_HD void nrzi_feature_rows(const float* v, int base, int S, int W,
                               const uint32_t* words, int c0, int c1,
                               NrziFeat* rows, int tid, int n) {
  for (int s = c0 + tid; s < c1; s += n)
    if (nrzi_chunk_cand(words, c0, s)) nrzi_features_at(v, base, S, s, W, rows[s - c0]);
}

// the samples the features of the chunk [c0, c1) read: [lo, hi)
NRZI_HD int nrzi_stage_lo(int c0, int W) { return c0 - W > 0 ? c0 - W : 0; }
NRZI_HD int nrzi_stage_hi(int c1, int S) { return c1 + 1 < S ? c1 + 1 : S; }

// Walk one track through the chunk [c0, c1): w.admit(s, f) runs one step
// at a candidate s with its features f = rows[s - c0] and moves w.cur (a
// blind jump, or a search from s + 1). One step per landing, as the JAX
// XLA scan counts them; a track stops at S or, landed, after max_steps
// steps. Returns false once the track has stopped.
template <class Walk>
NRZI_HD bool nrzi_walk_chunk(Walk& w, const uint32_t* words,
                             const NrziFeat* rows, int c0, int c1, int S,
                             int max_steps) {
  for (;;) {
    if (w.cur.search) {
      nrzi_cursor_seek(w.cur, words, c0, c1, S);
      if (w.cur.search) return true;         // on into the next chunk
    }
    const int s = w.cur.pos;
    if (s >= S || w.steps >= max_steps) return false;
    if (s >= c1) return true;                // a blind jump past the chunk
    w.steps += 1;
    if (!nrzi_chunk_cand(words, c0, s)) {
      // a blind jump landed on a non-candidate: reject and snap
      w.cur.pos = s + 1;
      w.cur.search = true;
      continue;
    }
    w.admit(s, rows[s - c0]);
  }
}

// B1: one track's candidate bitmask; features from the volts
struct NrziMaskSrc {
  const float* v;          // [S]
  const uint32_t* cw;      // [nw]
  int nw, S;
  NRZI_HDM int next(int p) const { return nrzi_next_cand(cw, nw, S, p); }
  NRZI_HDM bool cand(int s) const { return (cw[s >> 5] >> (s & 31)) & 1u; }
  NRZI_HDM void feat(int s, int W, NrziFeat& f) const { nrzi_features(v, S, s, W, f); }
};

// B5: one track's masked jump table (nxt[i] = first candidate >= i, S if
// none) and its precomputed features, rows in trackscan.FEATURES order
#define NRZI_NFEAT 10
struct NrziTableSrc {
  const float* ft;         // [S, NRZI_NFEAT]
  const int32_t* nxt;      // [S + 1]
  int S;
  NRZI_HDM int next(int p) const { return nxt[p < S ? p : S]; }
  NRZI_HDM bool cand(int s) const { return nxt[s] == s; }
  NRZI_HDM void feat(int s, int, NrziFeat& f) const {
    const float* r = ft + (int64_t)s * NRZI_NFEAT;
    f.wmax = r[0];
    f.wmin = r[1];
    f.vleft = r[2];
    f.vright = r[3];
    f.ltop = (int)r[4];
    f.prevmax = r[5];
    f.nextmax = r[6];
    f.lbot = (int)r[7];
    f.prevmin = r[8];
    f.nextmin = r[9];
  }
};

// one parmset's admission knobs
struct NrziKnobs {
  int W, aw;
  float rise, minp, aa;
};

// where one track's admitted transitions go: [K] buffers (top may be null)
struct NrziTrack {
  int32_t* s;
  float* t;
  float* agc;
  int8_t* top;
  int K;
};

struct NrziAdmitRes {
  int n_adm, incomplete;   // incomplete: the cursor stopped before S
  float max_agc, min_agc;
};

template <class Src>
NRZI_HD NrziAdmitRes nrzi_admit_scan(const Src& src, int S, int max_steps,
                                     const NrziKnobs& kn, const NrziTrack& o) {
  const int K = o.K, W = kn.W, aw = kn.aw;
  const float rise = kn.rise, minp = kn.minp, aa = kn.aa;

  float agc = 1.0f, vah = 4.0f, vah_sum = 0.0f;
  int vah_cnt = 0, hndx = 0, peakcount = 0, n_adm = 0;
  float max_agc = 0.0f, min_agc = NRZI_FLT_MAX;
  float v_lasttop = 0.0f, v_lastbot = 0.0f, v_top = 0.0f, v_bot = 0.0f;
  float heights[NRZI_MAX_AGC_RING];
  for (int k = 0; k < NRZI_MAX_AGC_RING; ++k) heights[k] = 0.0f;

  // one step per loop pass, as the JAX XLA scan counts them: a lane stops
  // after max_steps steps (its budget) or when its cursor passes S
  int pos = src.next(0);
  int steps = 0;
  while (pos < S && steps < max_steps) {
    const int s = pos;
    steps += 1;
    if (!src.cand(s)) {
      // a blind jump landed on a non-candidate: reject and snap
      pos = src.next(s + 1);
      continue;
    }
    NrziFeat f;
    src.feat(s, W, f);
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
      pos = src.next(s + 1);
      continue;
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
    float t_peak = (float)s + (-((float)(W - L) - adj));

    if (is_top) v_top = val; else v_bot = val;
    if (n_adm == 0) max_agc = agc;   // first data bit (nrzi_addbit:149)

    // nrzi_agc_policy
    int pc = peakcount + 1;
    float height = v_top - v_bot;
    bool in_base = is_top && pc >= 5 && pc <= 15;
    bool past = pc > 15;
    if (in_base) {                         // accumulate_baseline
      vah_sum = vah_sum + height;
      vah_cnt += 1;
      heights[hndx] = height;
      hndx = (hndx + 1 >= aw) ? 0 : hndx + 1;
    } else if (is_top && past && vah_cnt > 0) {   // finish_baseline
      vah = vah_sum / (float)(vah_cnt > 1 ? vah_cnt : 1);
      vah_cnt = 0;
    } else if (past && vah_cnt == 0) {            // adjust_agc
      float lastheight = v_lasttop - v_lastbot;
      float g_exp = vah / nrzi_maxf(lastheight, 1e-9f);
      g_exp = fmaf(aa, g_exp, (1.0f - aa) * agc);
      g_exp = nrzi_minf(g_exp, 2.0f);
      bool use_exp = aa > 0.0f && lastheight > 0.0f;
      bool use_win = aw > 0 && lastheight > 0.0f;
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
    }
    peakcount = pc;
    if (is_top) v_lasttop = f.wmax; else v_lastbot = f.wmin;

    // compact_outputs: overflow keeps the last admission in slot K-1
    int idx = n_adm < K - 1 ? n_adm : K - 1;
    o.s[idx] = s;
    o.t[idx] = t_peak;
    o.agc[idx] = agc;
    if (o.top) o.top[idx] = is_top;
    n_adm += 1;
    // blind until the peak leaves the window: the next step tests s + L + 1
    pos = s + L + 1;
  }
  NrziAdmitRes r;
  r.n_adm = n_adm;
  r.incomplete = pos < S;
  r.max_agc = max_agc;
  r.min_agc = min_agc;
  return r;
}

NRZI_HD NrziKnobs nrzi_knobs(const int32_t* p_w, const int32_t* p_agc_window,
                             const float* p_rise, const float* p_minp,
                             const float* p_agc_alpha, int p) {
  NrziKnobs kn;
  kn.W = p_w[p];
  kn.aw = p_agc_window[p];
  kn.rise = p_rise[p];
  kn.minp = p_minp[p];
  kn.aa = p_agc_alpha[p];
  return kn;
}

// B1's phase A for track t of a lane
NRZI_HD void nrzi_admit_track(const NrziArgs& a, int lane, int t) {
  const int b = lane / a.P, p = lane % a.P;
  const int64_t lt = (int64_t)lane * a.T + t;
  NrziMaskSrc src;
  src.v = a.volts + ((int64_t)b * a.T + t) * a.S;
  src.nw = nrzi_nwords(a);
  src.cw = a.cand + lt * src.nw;
  src.S = a.S;
  NrziTrack o;
  o.s = a.tr_s + lt * a.K;
  o.t = a.tr_t + lt * a.K;
  o.agc = a.tr_agc + lt * a.K;
  o.top = 0;
  o.K = a.K;
  NrziAdmitRes r = nrzi_admit_scan(
      src, a.S, a.max_steps,
      nrzi_knobs(a.p_w, a.p_agc_window, a.p_rise, a.p_minp, a.p_agc_alpha, p), o);
  int32_t* ti = a.trk_i + lt * N_TI;
  float* tf = a.trk_f + lt * N_TF;
  ti[TI_NADM] = r.n_adm;
  ti[TI_INCOMP] = r.incomplete;
  tf[TF_MAXAGC] = r.max_agc;
  tf[TF_MINAGC] = r.min_agc;
}

// ---------------------------------------------------------------------------
// phase B: the global bit-slot machine (nrzi.nrzi_slot_scan) for one lane
// ---------------------------------------------------------------------------

struct NrziSlot {
  const int32_t* tr_s;
  const float* tr_t;
  const float* tr_agc;
  int8_t* bits;
  int32_t* hist;
  int T, K, S, maxb, first_k;
  int lim[NRZI_MAX_TRACKS];      // min(count, K): valid entries per track
  int kvis[NRZI_MAX_TRACKS];
  int dc[NRZI_MAX_TRACKS];
  int trksum[NRZI_MAX_TRACKS];
  float tfirst[NRZI_MAX_TRACKS];
  float tlast[NRZI_MAX_TRACKS];
  float t_lc, t_lm, lb, bw;
  int post, missed, overflow;
};

NRZI_HD float nrzi_tt(const NrziSlot& m, int t, int k) { return m.tr_t[(int64_t)t * m.K + k]; }

// one consume round: up to 3 transitions per track with s_det < s_zc become
// 1-bits; a 4th sets the overflow flag; then the post-area realignment
NRZI_HD void nrzi_consume(NrziSlot& m, int s_zc, float b, float midbit) {
  float t_max = NRZI_NEG_T;
  for (int t = 0; t < m.T; ++t) {
    int n_new = 0;
    for (int j = 0; j < 4; ++j) {
      int kj = m.kvis[t] + j;
      if (kj < m.lim[t] && m.tr_s[(int64_t)t * m.K + kj] < s_zc) n_new = j + 1;
      else break;
    }
    for (int j = 0; j < 3 && j < n_new; ++j) {
      int kj = m.kvis[t] + j;
      float tj = nrzi_tt(m, t, kj);
      int wi = m.dc[t] + j < m.maxb - 1 ? m.dc[t] + j : m.maxb - 1;
      m.bits[(int64_t)t * m.maxb + wi] = 1;
      if (m.dc[t] + j == 0) m.tfirst[t] = tj;
      m.tlast[t] = tj;
      t_max = nrzi_maxf(t_max, tj);
      if (tj < m.t_lm && m.post == 0) m.missed += 1;
      // the block's very first transition is never recorded
      // (decode_nrzi.c:156-162)
      if (m.post == 0 && !(t == m.first_k && kj == 0)) {
        float val = tj - m.t_lc;
        int bkt = nrzi_f2i((val - m.lb) / m.bw);
        int code = bkt < 0 ? 0 : (bkt > 49 ? 49 : bkt);
        m.hist[t * 50 + code] += 1;
        if (bkt >= 0 && bkt <= 49) m.trksum[t] += 1;
      }
    }
    if (n_new == 4) m.overflow = 1;
    m.dc[t] = m.dc[t] + n_new < m.maxb ? m.dc[t] + n_new : m.maxb;
    m.kvis[t] = m.kvis[t] + n_new < m.K ? m.kvis[t] + n_new : m.K;
  }
  if (m.post > 0 && t_max > NRZI_NEG_T / 2 && m.t_lc < fmaf(-(2.0f - midbit), b, t_max))
    m.t_lc = t_max - 2.0f * b;
}

NRZI_HD int nrzi_boundary(float t_lc, float b) {
  float x = floorf(t_lc + 2.0f * b);
  return nrzi_f2i(x) + 1;
}

// one lane of the slot machine: its transition buffers, outputs and knobs
struct NrziSlotLane {
  const int32_t* tr_s;     // [T, K] admitted transitions, first count valid
  const float* tr_t;
  const float* tr_agc;
  int8_t* bits;            // [T, maxb], zeroed
  int32_t* hist;           // [T, 50], zeroed
  int32_t* trk_i;          // [T, N_TI]: reads TI_NADM; writes DC, KVIS, TRKSUM
  float* trk_f;            // [T, N_TF]: writes TFIRST, TLAST
  int32_t* lane_i;         // [N_LI]
  int T, K, S, maxb, max_slots, do_correct, exp_par, cw;
  float ca, padj, midbit, spb, lb, bw;
};

NRZI_HD void nrzi_slot_run(const NrziSlotLane& a) {
  NrziSlot m;
  m.T = a.T;
  m.K = a.K;
  m.S = a.S;
  m.maxb = a.maxb;
  m.tr_s = a.tr_s;
  m.tr_t = a.tr_t;
  m.tr_agc = a.tr_agc;
  m.bits = a.bits;
  m.hist = a.hist;
  const int32_t* ti_in = a.trk_i;
  const int cw = a.cw;
  const float ca = a.ca, padj = a.padj, midbit = a.midbit;
  const float spb = a.spb;
  m.lb = a.lb;
  m.bw = a.bw;

  bool any = false;
  int first_key = NRZI_BIG_S;
  m.first_k = 0;
  for (int t = 0; t < m.T; ++t) {
    int cnt = ti_in[t * N_TI + TI_NADM];
    m.lim[t] = cnt < m.K ? cnt : m.K;
    any = any || cnt > 0;
    int key = cnt > 0 ? m.tr_s[(int64_t)t * m.K] : NRZI_BIG_S;
    if (key < first_key) { first_key = key; m.first_k = t; }
    m.kvis[t] = 0;
    m.dc[t] = 0;
    m.trksum[t] = 0;
    m.tfirst[t] = 0.0f;
    m.tlast[t] = 0.0f;
  }
  float ring[NRZI_MAX_CLK_RING];
  for (int k = 0; k < NRZI_MAX_CLK_RING; ++k) ring[k] = spb;
  int bitndx = 0;
  float avg = spb;
  m.t_lc = any ? nrzi_tt(m, m.first_k, 0) - spb : 0.0f;
  m.t_lm = fmaf(midbit, spb, m.t_lc);
  m.post = 0;
  m.missed = 0;
  m.overflow = 0;
  int corrected = 0, faked = 0, end_s = m.S, nslot = 0;
  bool done = !any;

  while (!done && nslot < a.max_slots) {
    const float b = avg;
    int s_z = nrzi_boundary(m.t_lc, b);
    nrzi_consume(m, s_z < m.S ? s_z : m.S, b, midbit);
    // realignment may have pushed the boundary later: recompute once
    s_z = nrzi_boundary(m.t_lc, b);
    nrzi_consume(m, s_z < m.S ? s_z : m.S, b, midbit);
    bool past_end = s_z >= m.S;

    // ---- zerocheck (decode_nrzi.c:232-314) ----
    const float left = m.t_lm;
    const float right = fmaf(1.0f + midbit, b, m.t_lc);
    const float tz = m.t_lc + b;
    int numbits = 0, numlater = 0;
    float avg_pos = 0.0f;
    for (int t = 0; t < m.T; ++t) {
      int k = m.kvis[t];
      float lastpeak = k >= 1 ? nrzi_tt(m, t, k - 1) : NRZI_NEG_T;
      float prevlast = k >= 2 ? nrzi_tt(m, t, k - 2) : NRZI_NEG_T;
      bool last_in = lastpeak > left && lastpeak < right;
      bool prev_in = prevlast > left && prevlast < right;
      bool dup = last_in && prev_in;          // noisy double peak
      bool b2 = !last_in && prev_in;
      bool later = !last_in && !prev_in && lastpeak > right;
      bool zero = !last_in && !prev_in && !later;
      int8_t* bt = m.bits + (int64_t)t * m.maxb;
      int dc0 = m.dc[t];
      int d = dup ? dc0 - 1 : dc0;
      if (later) {                 // insert 0 before the 1 just appended
        bt[d - 1 > 0 ? d - 1 : 0] = 0;
        bt[d < m.maxb - 1 ? d : m.maxb - 1] = 1;
        d = d + 1 < m.maxb ? d + 1 : m.maxb;
      }
      if (zero) {                  // plain zero: append a 0
        bt[d < m.maxb - 1 ? d : m.maxb - 1] = 0;
        d = d + 1 < m.maxb ? d + 1 : m.maxb;
      }
      if ((later || zero) && dc0 == 0 && d > dc0) m.tfirst[t] = tz;
      if (later) m.tlast[t] = lastpeak;
      else if (zero) m.tlast[t] = tz;
      m.dc[t] = d;
      if (last_in || b2) numbits += 1;
      if (later) numlater += 1;
      avg_pos = avg_pos + (last_in ? lastpeak : (b2 ? prevlast : 0.0f));
    }
    const bool have = numbits > 0;
    const int post = m.post;
    int post_h = post == 1 ? 0 : post;        // cancel a fresh post
    float avgp = avg_pos / (float)(numbits > 1 ? numbits : 1);
    float expected = m.t_lc + b;
    float adjusted = post_h > 0 ? avgp : fmaf(padj, avgp - expected, expected);
    float delta = adjusted - m.t_lc;
    if (have && post_h == 0) {                // adjust_clock
      if (cw > 0) {
        float old = ring[bitndx];
        ring[bitndx] = delta;
        bitndx = bitndx + 1 >= cw ? 0 : bitndx + 1;
        avg = b + (delta - old) / (float)cw;
      } else if (ca > 0.0f) {
        avg = fmaf(ca, delta, (1.0f - ca) * b);
      } else {
        avg = spb;
      }
    }
    post_h = post_h > 0 ? post_h + 1 : post_h;
    int post_n = (numlater == 0 && post == 0) ? 1 : (post > 0 ? post + 1 : post);
    m.post = have ? post_h : post_n;
    m.t_lc = have ? adjusted : m.t_lc + b;
    m.t_lm = right;

    // -correct, release-binary semantics: the parity check reads column 0
    // (readtape.c nrzi_zerocheck:245,302)
    if (a.do_correct) {
      int frame0 = 0;
      for (int t = 0; t < m.T; ++t) frame0 |= (m.bits[(int64_t)t * m.maxb] & 1) << (m.T - 1 - t);
      int par = 0;
      for (int x = frame0; x; x >>= 1) par ^= x & 1;
      float hi = -1.0f;
      int badtrk = 0;
      for (int t = 0; t < m.T; ++t) {
        int k = m.kvis[t];
        float g = k >= 1 ? m.tr_agc[(int64_t)t * m.K + k - 1] : 1.0f;
        if (t == 0 || g > hi) { hi = g; badtrk = t; }
      }
      float next_hi = -1.0f;
      for (int t = 0; t < m.T; ++t) {
        int k = m.kvis[t];
        float g = t == badtrk ? -1.0f
                  : (k >= 1 ? m.tr_agc[(int64_t)t * m.K + k - 1] : 1.0f);
        if (t == 0 || g > next_hi) next_hi = g;
      }
      if (have && par != a.exp_par && hi >= 2.0f * next_hi) {
        m.bits[(int64_t)badtrk * m.maxb] ^= 1;
        corrected += 1;
        faked |= 1 << (m.T - 1 - badtrk);
      }
    }
    nslot += 1;
    if (m.post >= 8) {
      end_s = s_z < m.S ? s_z : m.S;
      done = true;
    }
    if (past_end) done = true;
  }

  int32_t* ti = a.trk_i;
  float* tf = a.trk_f;
  for (int t = 0; t < m.T; ++t) {
    ti[t * N_TI + TI_DC] = m.dc[t];
    ti[t * N_TI + TI_KVIS] = m.kvis[t];
    ti[t * N_TI + TI_TRKSUM] = m.trksum[t];
    tf[t * N_TF + TF_TFIRST] = m.tfirst[t];
    tf[t * N_TF + TF_TLAST] = m.tlast[t];
  }
  int32_t* li = a.lane_i;
  li[LI_MISSMID] = m.missed;
  li[LI_CORR] = corrected;
  li[LI_FAKED] = faked;
  li[LI_CONSOVF] = m.overflow;
  li[LI_ENDS] = end_s;
  li[LI_NSLOT] = nslot;
}

// B1's phase B for a lane, over the buffers phase A filled
NRZI_HD void nrzi_slot_machine(const NrziArgs& a, int lane) {
  const int p = lane % a.P;
  const int64_t row = (int64_t)lane * a.T;
  NrziSlotLane L;
  L.tr_s = a.tr_s + row * a.K;
  L.tr_t = a.tr_t + row * a.K;
  L.tr_agc = a.tr_agc + row * a.K;
  L.bits = a.bits + row * a.maxb;
  L.hist = a.hist + row * 50;
  L.trk_i = a.trk_i + row * N_TI;
  L.trk_f = a.trk_f + row * N_TF;
  L.lane_i = a.lane_i + (int64_t)lane * N_LI;
  L.T = a.T;
  L.K = a.K;
  L.S = a.S;
  L.maxb = a.maxb;
  L.max_slots = a.max_slots;
  L.do_correct = a.do_correct;
  L.exp_par = a.exp_par;
  L.cw = a.p_clk_window[p];
  L.ca = a.p_clk_alpha[p];
  L.padj = a.p_pulse_adj[p];
  L.midbit = a.p_midbit[p];
  L.spb = a.spb;
  L.lb = a.stat_lb;
  L.bw = a.stat_bw;
  nrzi_slot_run(L);
}

// zero one lane's bit buffer and histogram (threads tid of n cooperate)
NRZI_HD void nrzi_zero_lane(const NrziArgs& a, int lane, int tid, int n) {
  int64_t nb = (int64_t)a.T * a.maxb;
  int8_t* bits = a.bits + (int64_t)lane * nb;
  for (int64_t i = tid; i < nb; i += n) bits[i] = 0;
  int32_t* hist = a.hist + (int64_t)lane * a.T * 50;
  for (int i = tid; i < a.T * 50; i += n) hist[i] = 0;
}

// ---------------------------------------------------------------------------
// B5 (admission alone) and B6 (the slot machine alone), one lane each; the
// kernels of nrzi_scan.cu and nrzi_slot.cu call these per thread. Their
// outputs come pre-filled from the wrapper (kernels.py): transition buffers
// with compact_outputs' fill (BIG_S, 0.0, 1.0, false), bits and hist zeroed
// ---------------------------------------------------------------------------

struct NrziScanArgs {
  const float* feat;         // [G*B*T, S, NRZI_NFEAT], row (g*B + b)*T + t
  const int32_t* nxt;        // [B*T, S+1] masked jump tables
  const int32_t* grp;        // [P] feature group of each parmset
  const int32_t* p_w;        // [P] window width
  const int32_t* p_agc_window;
  const float* p_rise;
  const float* p_minp;
  const float* p_agc_alpha;
  int32_t* tr_s;             // [B, P, T, K]
  float* tr_t;
  float* tr_agc;
  int8_t* tr_top;
  int32_t* n_admitted;       // [B, P, T]
  float* max_agc_gain;
  float* min_agc_gain;
  int8_t* incomplete;
  int32_t B, P, T, S, G, K, max_steps;
};

// lane = (b*P + p)*T + t. incomplete: the cursor stopped before S (the
// step budget) or admissions overflowed the K buffer entries
NRZI_HD void nrzi_scan_lane(const NrziScanArgs& a, int lane) {
  const int t = lane % a.T, bp = lane / a.T;
  const int p = bp % a.P, b = bp / a.P;
  NrziTableSrc src;
  src.ft = a.feat + (((int64_t)a.grp[p] * a.B + b) * a.T + t) * a.S * NRZI_NFEAT;
  src.nxt = a.nxt + ((int64_t)b * a.T + t) * (a.S + 1);
  src.S = a.S;
  NrziTrack o;
  o.s = a.tr_s + (int64_t)lane * a.K;
  o.t = a.tr_t + (int64_t)lane * a.K;
  o.agc = a.tr_agc + (int64_t)lane * a.K;
  o.top = a.tr_top + (int64_t)lane * a.K;
  o.K = a.K;
  NrziAdmitRes r = nrzi_admit_scan(
      src, a.S, a.max_steps,
      nrzi_knobs(a.p_w, a.p_agc_window, a.p_rise, a.p_minp, a.p_agc_alpha, p), o);
  a.n_admitted[lane] = r.n_adm;
  a.max_agc_gain[lane] = r.max_agc;
  a.min_agc_gain[lane] = r.min_agc;
  a.incomplete[lane] = r.incomplete || r.n_adm > a.K;
}

struct NrziSlotArgs {
  const int32_t* tr_s;       // [B*P, T, K] (nrzi_scan's outputs)
  const float* tr_t;
  const float* tr_agc;
  const int32_t* n_admitted; // [B*P, T]
  const float* max_agc_gain;
  const float* min_agc_gain;
  const int8_t* incomplete;
  const int32_t* p_clk_window;   // [P]
  const float* p_clk_alpha;
  const float* p_pulse_adj;
  const float* p_midbit;
  int8_t* bits;              // [B*P, T, maxb], zeroed
  int32_t* hist;             // [B*P, T, 50], zeroed
  int32_t* trk_i;            // [B*P, T, N_TI]
  float* trk_f;              // [B*P, T, N_TF]
  int32_t* lane_i;           // [B*P, N_LI]
  int32_t B, P, T, S, K, maxb, max_slots, do_correct, exp_par;
  float spb, stat_lb, stat_bw;
};

// lane = b*P + p: copy the admission's per-track fields into B1's output
// columns, then run the slot machine over the lane's buffers
NRZI_HD void nrzi_slot_lane(const NrziSlotArgs& a, int lane) {
  const int p = lane % a.P;
  const int64_t row = (int64_t)lane * a.T;
  NrziSlotLane L;
  L.trk_i = a.trk_i + row * N_TI;
  L.trk_f = a.trk_f + row * N_TF;
  for (int t = 0; t < a.T; ++t) {
    L.trk_i[t * N_TI + TI_NADM] = a.n_admitted[row + t];
    L.trk_i[t * N_TI + TI_INCOMP] = a.incomplete[row + t] != 0;
    L.trk_f[t * N_TF + TF_MAXAGC] = a.max_agc_gain[row + t];
    L.trk_f[t * N_TF + TF_MINAGC] = a.min_agc_gain[row + t];
  }
  L.tr_s = a.tr_s + row * a.K;
  L.tr_t = a.tr_t + row * a.K;
  L.tr_agc = a.tr_agc + row * a.K;
  L.bits = a.bits + row * a.maxb;
  L.hist = a.hist + row * 50;
  L.lane_i = a.lane_i + (int64_t)lane * N_LI;
  L.T = a.T;
  L.K = a.K;
  L.S = a.S;
  L.maxb = a.maxb;
  L.max_slots = a.max_slots;
  L.do_correct = a.do_correct;
  L.exp_par = a.exp_par;
  L.cw = a.p_clk_window[p];
  L.ca = a.p_clk_alpha[p];
  L.padj = a.p_pulse_adj[p];
  L.midbit = a.p_midbit[p];
  L.spb = a.spb;
  L.lb = a.stat_lb;
  L.bw = a.stat_bw;
  nrzi_slot_run(L);
}
