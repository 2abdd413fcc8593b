// The NRZI decode state machine shared by the CUDA kernels (nrzi_fused.cu:
// B1, everything in one launch; nrzi_scan.cu: B5, admission alone;
// nrzi_slot.cu: B6, the slot machine alone) and a host build used only by
// the tests. Every function is __host__ __device__ and touches one
// (segment, parmset) lane, or one track of it. There is one copy of each
// machine: the admission step (NrziWalk::admit, whose admission test and
// AGC policy GCR's walk shares) that B1, B5a and B5b drive chunk by chunk,
// and the slot machine's per-track steps
// and per-lane combines (nrzi_slot_drive) that the card runs with one
// thread per track of a warp and the host runs serially, track by track.
//
// Semantics: readtape_tpu/decode/trackscan.py (admission, AGC policy) and
// readtape_tpu/decode/nrzi.py::nrzi_slot_scan (global slot machine,
// zerocheck, -correct, the -adjskew accumulators) with
// nrzi.correct_debug_replay (the DEBUG build's -correct), which the plain
// PyTorch version
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
#define NRZI_UNROLL _Pragma("unroll")
#else
#define NRZI_HD static inline
#define NRZI_HDM inline
#define NRZI_UNROLL
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
// -correct's parity check (NrziSlotLane::correct): none, the release
// binary's over column 0, or the DEBUG build's over the column of the
// last complete byte, after the slot's writes
#define NRZI_CORRECT_OFF 0
#define NRZI_CORRECT_RELEASE 1
#define NRZI_CORRECT_DEBUG 2
// per-lane phase stamps (only when the argument block's stamps is set).
// B1: the global timer (ns) at the start and end, clock64() at the start
// and after phases 0, A and B, then each track's clock64() cycles spent
// walking in phase A, then the slot machine's cycles in each kind of
// step (NRZI_M_*), summed over the slots. B6: the global timer at the
// start and end, clock64() at the start and end of the slot machine,
// then its cycles per kind of step as B1's
#define NRZI_M_TRACKS 0    // the tracks' steps: consume rounds, zerocheck
#define NRZI_M_REALIGN 1
#define NRZI_M_CLOSE 2
#define NRZI_NMACH 3
#define NRZI_ST_G0 0
#define NRZI_ST_C0 1
#define NRZI_ST_CZ 2
#define NRZI_ST_CA 3
#define NRZI_ST_CB 4
#define NRZI_ST_G1 5
#define NRZI_ST_WALK 6
#define NRZI_ST_MACH (NRZI_ST_WALK + NRZI_MAX_TRACKS)
#define NRZI_NSTAMP (NRZI_ST_MACH + NRZI_NMACH)
#define SLOT_ST_G0 0
#define SLOT_ST_C0 1
#define SLOT_ST_C1 2
#define SLOT_ST_G1 3
#define SLOT_ST_MACH 4
#define SLOT_NSTAMP (SLOT_ST_MACH + NRZI_NMACH)
// B5b's per-lane stamps (only when NrziScanArgs::stamps is set): the
// global timer (ns) at the start and end of the lane's walk, clock64() at
// its start and end, the walker's clock64() cycles spent walking (the rest
// it waits for staged chunks), and its steps
#define SCAN_ST_G0 0
#define SCAN_ST_C0 1
#define SCAN_ST_C1 2
#define SCAN_ST_G1 3
#define SCAN_ST_WALK 4
#define SCAN_ST_STEPS 5
#define SCAN_NSTAMP 6
// B5a's per-walker stamps: B5b's, and the walker's clock64() cycles at the
// block's chunk barriers after the chunks it walked (waiting for slower
// walkers of its block, or for the staging)
#define SCAN_ST_WAIT 6
#define SCANA_NSTAMP 7

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
  int64_t* stamps;           // [B*P, NRZI_NSTAMP] phase clocks, or null
  int32_t B, P, T, S, G, K, maxb, max_slots, max_steps;
  int32_t do_correct, exp_par;
  int32_t wmax;              // the widest of p_w
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
// widths), masked to [lead, seg_len), one sample at a time (B1's kernel
// gathers a warp's 32 samples into a candidate word with one ballot)
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

// the candidate bit of sample s of track t: the loose test over the union
// of the window widths, masked to [lead, seg_len)
NRZI_HD bool nrzi_cand_bit(const NrziArgs& a, int lane, int t, int s) {
  const int b = lane / a.P;
  const int hi = a.seg_len[b] < a.S ? a.seg_len[b] : a.S;
  if (s < a.lead[b] || s >= hi) return false;
  const float* v = a.volts + ((int64_t)b * a.T + t) * a.S;
  bool c = false;
  for (int g = 0; g < a.G && !c; ++g)
    c = nrzi_loose_at(v, s, a.wset[g], a.rise_floor[t], a.min_floor[t]);
  return c;
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
// nrzi_track_scan_pre + nrzi_agc_policy), one step struct (NrziWalk)
// walked chunk by chunk (nrzi_walk_chunk): B1 over window features
// computed a chunk ahead, B5a and B5b over their table's rows staged a
// chunk ahead
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

// B5: a row of a track's precomputed feature table, in trackscan.FEATURES
// order (the offsets ltop and lbot as floats)
#define NRZI_NFEAT 10
struct NrziTableRow {
  float r[NRZI_NFEAT];
};

// the walk's features of a row: computed (NrziFeat) or read from B5's table
NRZI_HD const NrziFeat& nrzi_feat_of(const NrziFeat& f) { return f; }
NRZI_HD NrziFeat nrzi_feat_of(const NrziTableRow& row) {
  const float* r = row.r;
  NrziFeat f;
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
  return f;
}

// ---------------------------------------------------------------------------
// The chunked admission walk (B1, B2, B3, B4, B5): a track's tape is cut
// into chunks of C samples (C a multiple of 32); for each chunk the caller
// provides the chunk's candidate words and the window features at its
// candidates (computed rows, or B5's table rows), and the walk runs the
// same steps run_jump_scan_seq takes over the whole track. The cursor carries across chunks: a blind jump may land past the
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
// at a candidate s with its features f of rows[s - c0] and moves w.cur (a
// blind jump, or a search from s + 1). One step per landing, as the JAX
// XLA scan counts them; a track stops at S or,
// landed, after max_steps steps. Returns false once the track has stopped.
template <class Walk, class Row>
NRZI_HD bool nrzi_walk_chunk(Walk& w, const uint32_t* words, const Row* rows,
                             int c0, int c1, int S, int max_steps) {
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
    w.admit(s, nrzi_feat_of(rows[s - c0]));
  }
}

#ifdef __CUDACC__
// ---------------------------------------------------------------------------
// Chunk staging on the card (B1, B2, B3, B4's admission): while the walkers
// walk chunk i, the block's other threads (stager ptid of np) copy chunk
// i + 2 of each of T tracks -- its samples [c0 - W, c1] and its candidate
// words -- into staging slot i & 1 by cp.async, and turn chunk i + 1 into
// feature slot (i + 1) & 1: its words and every candidate's window
// features. So no step of a walk waits on device memory
// ---------------------------------------------------------------------------

// cp.async of 4 bytes (__host__ __device__ for the slot machine's ring;
// it copies in the device build only)
NRZI_HDM void nrzi_cp4(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
#endif
}

__device__ __forceinline__ void nrzi_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void nrzi_cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// barrier 1 among the n staging threads only
__device__ __forceinline__ void nrzi_stage_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

__device__ __forceinline__ long long nrzi_gtimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// the two feature and two staging slots of T tracks at chunk C, window
// widths <= Wmax
static inline size_t nrzi_stage_smem(int T, int C, int Wmax) {
  return (size_t)T * (2 * (size_t)C * sizeof(NrziFeat) + 4 * (size_t)(C / 32) * 4 +
                      2 * (size_t)(C + Wmax + 1) * 4);
}

struct NrziStager {
  const float* v;            // track t's samples at v + t * S
  const uint32_t* cw;        // its candidate words at cw + t * nw
  NrziFeat* rows;            // [2][T][C] feature slots: rows, words
  uint32_t* fwords;          // [2][T][CW]
  uint32_t* swords;          // [2][T][CW] staging slots: words, samples
  float* vst;                // [2][T][VN]
  int T, S, W, C, CW, VN, nw, ptid, np;

  // the slots carved from sm (nrzi_stage_smem bytes); returns their end
  __device__ unsigned char* init(unsigned char* sm, const float* v_, const uint32_t* cw_,
                                 int T_, int S_, int W_, int C_, int Wmax, int nw_,
                                 int ptid_, int np_) {
    v = v_;
    cw = cw_;
    T = T_;
    S = S_;
    W = W_;
    C = C_;
    CW = C >> 5;
    VN = C + Wmax + 1;
    nw = nw_;
    ptid = ptid_;
    np = np_;
    rows = (NrziFeat*)sm;
    fwords = (uint32_t*)(rows + 2 * T * C);
    swords = fwords + 2 * T * CW;
    vst = (float*)(swords + 2 * T * CW);
    return (unsigned char*)(vst + 2 * T * VN);
  }
  // staging slot i & 1 <- every track's samples [c0 - W, c1] and words
  __device__ void stage(int i) const {
    const int c0 = i * C, c1 = min(c0 + C, S), base = c0 - W;
    const int lo = nrzi_stage_lo(c0, W), n = nrzi_stage_hi(c1, S) - lo;
    const int nwc = (c1 - c0 + 31) >> 5;
    for (int q = ptid; q < T * n; q += np) {
      const int t = q / n, k = lo + q % n;
      nrzi_cp4(vst + ((i & 1) * T + t) * VN + (k - base), v + (int64_t)t * S + k);
    }
    for (int q = ptid; q < T * nwc; q += np) {
      const int t = q / nwc, w = q % nwc;
      nrzi_cp4(swords + ((i & 1) * T + t) * CW + w, cw + (int64_t)t * nw + (c0 >> 5) + w);
    }
    nrzi_cp_commit();
  }
  // feature slot i & 1 <- every track's words and candidates' features
  __device__ void features(int i) const {
    const int c0 = i * C, c1 = min(c0 + C, S), nwc = (c1 - c0 + 31) >> 5;
    const uint32_t* ws = swords + (i & 1) * T * CW;
    uint32_t* fw = fwords + (i & 1) * T * CW;
    for (int q = ptid; q < T * CW; q += np) fw[q] = q % CW < nwc ? ws[q] : 0u;
    NrziFeat* rs = rows + (i & 1) * T * C;
    const float* vs = vst + (i & 1) * T * VN;
    for (int q = ptid; q < T * C; q += np) {
      const int t = q / C, s = c0 + q % C;
      if (s < c1 && nrzi_chunk_cand(ws + t * CW, c0, s))
        nrzi_features_at(vs + t * VN, c0 - W, S, s, W, rs[q]);
    }
  }
  // before the walk: chunk 0 in its feature slot, chunk 1 on its way
  __device__ void prime(int nch) const {
    stage(0);
    nrzi_cp_wait();
    nrzi_stage_sync(np);
    if (nch > 1) stage(1);
    features(0);
  }
  // while the walkers walk chunk i: chunk i + 1 into its feature slot,
  // chunk i + 2 on its way
  __device__ void advance(int i, int nch) const {
    if (i + 1 >= nch) return;
    nrzi_cp_wait();                        // chunk i + 1 staged
    nrzi_stage_sync(np);
    if (i + 2 < nch) stage(i + 2);
    features(i + 1);
  }
  // the feature slot of chunk i, track t: its words and rows
  __device__ const uint32_t* words(int i, int t) const { return fwords + ((i & 1) * T + t) * CW; }
  __device__ const NrziFeat* feat(int i, int t) const { return rows + ((i & 1) * T + t) * C; }
};
#endif

// B5: one track's masked jump table (nxt[i] = first candidate >= i, S if
// none: s is a candidate iff nxt[s] == s) and its precomputed features
struct NrziTableSrc {
  const NrziTableRow* ft;  // [S]
  const int32_t* nxt;      // [S + 1]
  int S;
  NRZI_HDM bool cand(int s) const { return nxt[s] == s; }
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

// ---------------------------------------------------------------------------
// The admission test, the peak's refinement and the AGC policy, shared by
// the NRZI walk (NrziWalk::admit) and the GCR walk (gcr_core.h GcrWalk):
// trackscan.admission_test, refine_frac and nrzi_agc_policy
// ---------------------------------------------------------------------------

// a track's admission and AGC state (trackscan.admission_init,
// common.agc_state_init)
struct NrziAgc {
  float agc, vah, vah_sum;
  int vah_cnt, hndx, peakcount;
  float max_agc, min_agc, v_lasttop, v_lastbot, v_top, v_bot;
  float* heights;            // [NRZI_MAX_AGC_RING] the AGC window
};

// heights: NRZI_MAX_AGC_RING floats
NRZI_HD void nrzi_agc_init(NrziAgc& g, float* heights) {
  g.agc = 1.0f;
  g.vah = 4.0f;
  g.vah_sum = 0.0f;
  g.vah_cnt = g.hndx = g.peakcount = 0;
  g.max_agc = 0.0f;
  g.min_agc = NRZI_FLT_MAX;
  g.v_lasttop = g.v_lastbot = g.v_top = g.v_bot = 0.0f;
  g.heights = heights;
  for (int k = 0; k < NRZI_MAX_AGC_RING; ++k) heights[k] = 0.0f;
}

// admission_test (decoder.c:781-810): 1 a top, -1 a bottom, 0 neither
NRZI_HD int nrzi_admission_test(const NrziAgc& g, const NrziFeat& f, float rise,
                                float minp) {
  const float scale = g.vah / 4.0f;
  const float rise_t = rise * scale / g.agc;
  const float rmin = minp * scale / g.agc;
  const bool no_min = minp == 0.0f;
  const bool is_top = (f.wmax > f.vleft + rise_t) && (f.wmax > f.vright + rise_t) &&
                      (no_min || f.wmax > rmin);
  if (is_top) return 1;
  const bool is_bot = (f.wmin < f.vleft - rise_t) && (f.wmin < f.vright - rise_t) &&
                      (no_min || f.wmin < -rmin);
  return is_bot ? -1 : 0;
}

// refine_frac (decoder.c:700-749): the peak's time at a candidate s with
// window width W, by +-0.5-sample interpolation; its window offset into L.
// Records the peak's value as the track's top or bottom
NRZI_HD float nrzi_refine_frac(NrziAgc& g, const NrziFeat& f, bool is_top, int s,
                               int W, int& L) {
  L = is_top ? f.ltop : f.lbot;
  const float val = is_top ? f.wmax : f.wmin;
  const float prv = is_top ? f.prevmax : f.prevmin;
  const float nxt = is_top ? f.nextmax : f.nextmin;
  const float thr = 0.005f / g.agc;
  const float ref = is_top ? val - thr : val + thr;
  const bool pclose = is_top ? prv > ref : prv < ref;
  const bool nclose = is_top ? nxt > ref : nxt < ref;
  const float adj = (pclose && !nclose) ? -0.5f : ((nclose && !pclose) ? 0.5f : 0.0f);
  if (is_top) g.v_top = val; else g.v_bot = val;
  return (float)s + (-((float)(W - L) - adj));
}

// nrzi_agc_policy after an admitted peak: the baseline over peaks 5..15,
// then adjust_agc (aw: the AGC window, aa: its alpha)
NRZI_HD void nrzi_agc_policy(NrziAgc& g, bool is_top, const NrziFeat& f, int aw,
                             float aa) {
  const int pc = g.peakcount + 1;
  const float height = g.v_top - g.v_bot;
  const bool past = pc > 15;
  if (is_top && pc >= 5 && !past) {                // accumulate_baseline
    g.vah_sum = g.vah_sum + height;
    g.vah_cnt += 1;
    g.heights[g.hndx] = height;
    g.hndx = (g.hndx + 1 >= aw) ? 0 : g.hndx + 1;
  } else if (is_top && past && g.vah_cnt > 0) {    // finish_baseline
    g.vah = g.vah_sum / (float)(g.vah_cnt > 1 ? g.vah_cnt : 1);
    g.vah_cnt = 0;
  } else if (past && g.vah_cnt == 0) {             // adjust_agc
    const float lastheight = g.v_lasttop - g.v_lastbot;
    float g_exp = g.vah / nrzi_maxf(lastheight, 1e-9f);
    g_exp = fmaf(aa, g_exp, (1.0f - aa) * g.agc);
    g_exp = nrzi_minf(g_exp, 2.0f);
    const bool use_exp = aa > 0.0f && lastheight > 0.0f;
    const bool use_win = aw > 0 && lastheight > 0.0f;
    float gain = g.agc;
    if (use_exp) gain = g_exp;
    if (use_win) {
      g.heights[g.hndx] = lastheight;
      g.hndx = (g.hndx + 1 >= aw) ? 0 : g.hndx + 1;
      float minh = NRZI_FLT_MAX;
      for (int k = 0; k < NRZI_MAX_AGC_RING && k < aw; ++k)
        minh = nrzi_minf(minh, g.heights[k]);
      gain = nrzi_minf(g.vah / nrzi_maxf(minh, 1e-9f), 2.0f);
    }
    if (use_exp || use_win) {
      if (gain > g.max_agc) g.max_agc = gain;
      if (gain < g.min_agc) g.min_agc = gain;
    }
    g.agc = gain;
  }
  g.peakcount = pc;
  if (is_top) g.v_lasttop = f.wmax; else g.v_lastbot = f.wmin;
}

// One track's admission walk: its cursor and step count, AGC state, knobs
// and outputs. admit(s, f) is one step at a candidate s with the window
// features f: the admission test, then, for a peak, the refinement, the
// AGC policy and the output; it moves the cursor on (a search from s + 1
// after a rejection, a blind landing at s + L + 1 after an admission)
struct NrziWalk {
  NrziCursor cur;
  int steps, n_adm;
  NrziAgc g;
  NrziKnobs kn;
  NrziTrack o;

  NRZI_HDM void admit(int s, const NrziFeat& f) {
    const int adm = nrzi_admission_test(g, f, kn.rise, kn.minp);
    if (!adm) {
      cur.pos = s + 1;
      cur.search = true;
      return;
    }
    const bool is_top = adm > 0;
    int L;
    const float t_peak = nrzi_refine_frac(g, f, is_top, s, kn.W, L);
    if (n_adm == 0) g.max_agc = g.agc;   // first data bit (nrzi_addbit:149)
    nrzi_agc_policy(g, is_top, f, kn.aw, kn.aa);

    // compact_outputs: overflow keeps the last admission in slot K-1
    int idx = n_adm < o.K - 1 ? n_adm : o.K - 1;
    o.s[idx] = s;
    o.t[idx] = t_peak;
    o.agc[idx] = g.agc;
    if (o.top) o.top[idx] = is_top;
    n_adm += 1;
    // blind until the peak leaves the window: the next step tests s + L + 1
    cur.pos = s + L + 1;
    cur.search = false;
  }
};

// a track's walk at the start of its segment; heights: NRZI_MAX_AGC_RING
// floats
NRZI_HD void nrzi_walk_init(NrziWalk& w, const NrziKnobs& kn, const NrziTrack& o,
                            float* heights) {
  w.cur.pos = 0;
  w.cur.search = true;
  w.steps = 0;
  w.n_adm = 0;
  nrzi_agc_init(w.g, heights);
  w.kn = kn;
  w.o = o;
}

NRZI_HD NrziAdmitRes nrzi_walk_result(const NrziWalk& w, int S) {
  NrziAdmitRes r;
  r.n_adm = w.n_adm;
  r.incomplete = w.cur.pos < S;
  r.max_agc = w.g.max_agc;
  r.min_agc = w.g.min_agc;
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

// B1's phase A, track t of a lane: its walk at the start (heights:
// NRZI_MAX_AGC_RING floats), and its results once the walk has stopped
NRZI_HD void nrzi_fused_walk_init(NrziWalk& w, const NrziArgs& a, int lane, int t,
                                  float* heights) {
  const int64_t lt = (int64_t)lane * a.T + t;
  NrziTrack o;
  o.s = a.tr_s + lt * a.K;
  o.t = a.tr_t + lt * a.K;
  o.agc = a.tr_agc + lt * a.K;
  o.top = 0;
  o.K = a.K;
  nrzi_walk_init(w, nrzi_knobs(a.p_w, a.p_agc_window, a.p_rise, a.p_minp,
                               a.p_agc_alpha, lane % a.P),
                 o, heights);
}

NRZI_HD void nrzi_fused_walk_finish(const NrziWalk& w, const NrziArgs& a, int lane,
                                    int t) {
  const NrziAdmitRes r = nrzi_walk_result(w, a.S);
  const int64_t lt = (int64_t)lane * a.T + t;
  int32_t* ti = a.trk_i + lt * N_TI;
  float* tf = a.trk_f + lt * N_TF;
  ti[TI_NADM] = r.n_adm;
  ti[TI_INCOMP] = r.incomplete;
  tf[TF_MAXAGC] = r.max_agc;
  tf[TF_MINAGC] = r.min_agc;
}

// ---------------------------------------------------------------------------
// phase B: the global bit-slot machine (nrzi.nrzi_slot_scan) for one lane.
// Within a slot the tracks' work is independent; they meet only in a few
// per-lane combines. So the machine is cut into per-track steps (consume,
// zerocheck with -correct's reads) that own one track's state and hand one
// result each (NrziSlotPart) to per-lane combines that read the results in
// track order (open, realignment, the slot's close: clock, post-area and
// -correct; finish). nrzi_slot_drive runs them slot by slot over an
// executor: the host's NrziSerial loops over the tracks; the card's
// NrziWarp runs track t on thread t of a warp and each combine on thread
// 0, a __syncwarp() after each. A combine runs on one thread in track
// order, so avg_pos keeps its summation order and badtrk its first-maximum
// tie-break.
// ---------------------------------------------------------------------------

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
  const float* adj0;       // [T, 2] -adjskew's seeds (count, mean), or null
  float* adj;              // [T, 2] the accumulators at the end (with adj0)
  float* bitspace;         // the clock's t_bitspaceavg at the end, or null
  // -trace's record mode (-correct off), or null: per slot its boundary
  // min(s_z, S) and adjusted clock position (0 without transitions), per
  // (track, column) the slot of the last write, -1 before any
  float* dbg_slot;         // [max_slots, 2]
  int32_t* col_slot;       // [T, maxb], filled with -1
  int T, K, S, maxb, max_slots, exp_par, cw;
  int correct;             // NRZI_CORRECT_*
  int clk_avg_fma;         // the exponential clock's other contraction
  float ca, padj, midbit, spb, lb, bw;
};

// one track's state, owned by its steps
struct NrziSlotTrk {
  int8_t* bits;            // the track's [maxb] row
  int32_t* hist;           // its [50] histogram row
  int32_t* cslot;          // record mode: its [maxb] row of col_slot
  int slot;                // record mode: the slot its steps run in
  int lim;                 // min(count, K): its valid transitions
  int kvis, dc, trksum, missed, overflow;
  int n_new;               // what the last consume round found
  int col0;                // bits[0], the column -correct's parity reads
  float tfirst, tlast;
  float adj_n, adj_mean;   // -adjskew's count and mean deviation
  template <bool REC = false>
  NRZI_HDM void put(int i, int v) {
    bits[i] = (int8_t)v;
    if (i == 0) col0 = v;
    if (REC) cslot[i] = slot;
  }
};

// what one track's step hands the next combine (16 bytes: one load)
struct alignas(16) NrziSlotPart {
  float x;     // open: its first transition's time; consume: its latest
               // consumed time (NRZI_NEG_T if none); zerocheck: its avg_pos term
  float g;     // zerocheck: the AGC gain -correct reads
  int key;     // open: its first transition's sample; zerocheck: its
               // last complete byte (with NRZI_PF_CAND); finish: missed mid-bits
  int flags;   // NRZI_PF_*
};
#define NRZI_PF_ANY 1      // open: it admitted transitions
#define NRZI_PF_BIT 2      // zerocheck: a 1-bit in the window (numbits)
#define NRZI_PF_LATER 4    // zerocheck: a later peak (numlater)
#define NRZI_PF_COL0 8     // zerocheck: its bit in column 0
#define NRZI_PF_OVF 16     // finish: a consume round overflowed
#define NRZI_PF_CAND 32    // zerocheck: a peak in the window (the DEBUG build's
                           // last_complete_byte candidates)

// the lane's state, owned by the combines
struct alignas(16) NrziSlotState {
  float t_lc, t_lm, avg;
  int post, first_k, nslot, end_s, corrected, faked, bitndx;
  int flip;                // the track -correct flips before the next slot, or -1
  int flipcol;             // the column it flips
  int dcheck, lcb;         // DEBUG -correct: check column lcb's parity
  int done;
  float ring[NRZI_MAX_CLK_RING];   // the clock window
};

// A track's transitions read from its [K] rows (the host). Every source
// has s(k), t(k), agc(k) for k < lim, and s_near, t_near for k in
// [kvis - 2, kvis + 8): the entry for 0 <= k < lim, anything elsewhere
// (the card's ring reads them unguarded, several at once)
struct NrziRowSrc {
  const int32_t* rs;
  const float* rt;
  const float* ragc;
  int K;
  NRZI_HDM void start(int) {}
  NRZI_HDM void ahead(int) {}
  NRZI_HDM int s(int k) const { return rs[k]; }
  NRZI_HDM float t(int k) const { return rt[k]; }
  NRZI_HDM float agc(int k) const { return ragc[k]; }
  NRZI_HDM int s_near(int k) const { return k >= 0 && k < K ? rs[k] : 0; }
  NRZI_HDM float t_near(int k) const { return k >= 0 && k < K ? rt[k] : 0.0f; }
};

NRZI_HD int nrzi_boundary(float t_lc, float b) {
  float x = floorf(t_lc + 2.0f * b);
  return nrzi_f2i(x) + 1;
}

// track t at the start of the lane; k.bits and k.hist are set
template <class Tr>
NRZI_HD NrziSlotPart nrzi_slot_track_open(NrziSlotTrk& k, Tr& tr, const NrziSlotLane& a,
                                          int t) {
  const int cnt = a.trk_i[t * N_TI + TI_NADM];
  k.lim = cnt < a.K ? cnt : a.K;
  k.kvis = k.dc = k.trksum = k.missed = k.overflow = k.col0 = 0;
  k.tfirst = k.tlast = 0.0f;
  k.adj_n = a.adj0 ? a.adj0[2 * t] : 0.0f;
  k.adj_mean = a.adj0 ? a.adj0[2 * t + 1] : 0.0f;
  k.cslot = a.col_slot ? a.col_slot + (int64_t)t * a.maxb : 0;
  k.slot = 0;
  tr.start(k.lim);
  tr.ahead(0);
  NrziSlotPart p;
  p.flags = cnt > 0 ? NRZI_PF_ANY : 0;
  p.key = cnt > 0 ? tr.s(0) : NRZI_BIG_S;
  p.x = cnt > 0 ? tr.t(0) : 0.0f;
  p.g = 0.0f;
  return p;
}

// the lane at its start: the block's first transition sets the clock
NRZI_HD void nrzi_slot_open(NrziSlotState& L, const NrziSlotPart* part,
                            const NrziSlotLane& a) {
  bool any = false;
  int first_key = NRZI_BIG_S, first_k = 0;
NRZI_UNROLL
  for (int t = 0; t < NRZI_MAX_TRACKS; ++t) {
    const NrziSlotPart p = part[t];
    if (t >= a.T) continue;
    any = any || (p.flags & NRZI_PF_ANY);
    if (p.key < first_key) {
      first_key = p.key;
      first_k = t;
    }
  }
  L.first_k = first_k;
  for (int k = 0; k < NRZI_MAX_CLK_RING; ++k) L.ring[k] = a.spb;
  L.bitndx = 0;
  L.avg = a.spb;
  L.t_lc = any ? part[L.first_k].x - a.spb : 0.0f;
  L.t_lm = fmaf(a.midbit, a.spb, L.t_lc);
  L.post = 0;
  L.nslot = 0;
  L.end_s = a.S;
  L.corrected = 0;
  L.faked = 0;
  L.flip = -1;
  L.flipcol = 0;
  L.dcheck = 0;
  L.lcb = 0;
  L.done = !any;
}

// one consume round of track t: up to 3 of its transitions with s_det <
// s_zc become 1-bits; a 4th sets the overflow flag. Returns the latest of
// their times (NRZI_NEG_T if none) for the realignment, and leaves in
// k.n_new how many it found
template <bool REC, class Tr>
NRZI_HD float nrzi_consume_track(NrziSlotTrk& k, const Tr& tr, int t, int s_zc,
                                 const NrziSlotState& L, const NrziSlotLane& a) {
  // the next four samples and three times, read at once
  int sv[4];
  float tv[3];
NRZI_UNROLL
  for (int j = 0; j < 4; ++j) sv[j] = tr.s_near(k.kvis + j);
NRZI_UNROLL
  for (int j = 0; j < 3; ++j) tv[j] = tr.t_near(k.kvis + j);
  float t_max = NRZI_NEG_T;
  int n_new = 0;
NRZI_UNROLL
  for (int j = 0; j < 4; ++j)
    if (n_new == j && k.kvis + j < k.lim && sv[j] < s_zc) n_new = j + 1;
NRZI_UNROLL
  for (int j = 0; j < 3; ++j) {
    if (j >= n_new) break;
    const int kj = k.kvis + j;
    const float tj = tv[j];
    k.put<REC>(k.dc + j < a.maxb - 1 ? k.dc + j : a.maxb - 1, 1);
    if (k.dc + j == 0) k.tfirst = tj;
    k.tlast = tj;
    t_max = nrzi_maxf(t_max, tj);
    if (tj < L.t_lm && L.post == 0) k.missed += 1;
    // the block's very first transition is never recorded
    // (decode_nrzi.c:156-162)
    if (L.post == 0 && !(t == L.first_k && kj == 0)) {
      const float val = tj - L.t_lc;
      const int bkt = nrzi_f2i((val - a.lb) / a.bw);
      k.hist[bkt < 0 ? 0 : (bkt > 49 ? 49 : bkt)] += 1;
      if (bkt >= 0 && bkt <= 49) {
        k.trksum += 1;
        if (a.adj0) {
          // -adjskew's incremental mean of (peak time - bit spacing), in
          // the C's expression order (decoder.c:169-173); L.avg is the
          // slot's bit spacing until the close
          const float n2 = k.adj_n + 1.0f;
          k.adj_mean = k.adj_mean + ((val - L.avg) - k.adj_mean) / nrzi_maxf(n2, 1.0f);
          k.adj_n = n2;
        }
      }
    }
  }
  if (n_new == 4) k.overflow = 1;
  k.dc = k.dc + n_new < a.maxb ? k.dc + n_new : a.maxb;
  k.kvis = k.kvis + n_new < a.K ? k.kvis + n_new : a.K;
  k.n_new = n_new;
  return t_max;
}

// after a consume round: the post-area realignment to the latest
// transition of any track (the max of each track's latest, in track order,
// is the max over all of them in the reference's order, ties included)
NRZI_HD void nrzi_slot_realign(NrziSlotState& L, const NrziSlotPart* part,
                               const NrziSlotLane& a, float b) {
  float t_max = NRZI_NEG_T;
NRZI_UNROLL
  for (int t = 0; t < NRZI_MAX_TRACKS; ++t) {
    if (t >= a.T) break;
    t_max = nrzi_maxf(t_max, part[t].x);
  }
  if (L.post > 0 && t_max > NRZI_NEG_T / 2 && L.t_lc < fmaf(-(2.0f - a.midbit), b, t_max))
    L.t_lc = t_max - 2.0f * b;
}

// the zerocheck of one track (decode_nrzi.c:232-314), and what -correct
// reads of it: its bit in column 0, the gain of its last consumed
// transition and, for the DEBUG build's check, the index it leaves in
// last_complete_byte (decode_nrzi.c:258,262): datacount-1 after a dup
// deletion when its last peak is in the window, else datacount-2
template <bool REC, class Tr>
NRZI_HD NrziSlotPart nrzi_zerocheck_track(NrziSlotTrk& k, const Tr& tr,
                                          const NrziSlotState& L,
                                          const NrziSlotLane& a, float b) {
  const float left = L.t_lm;
  const float right = fmaf(1.0f + a.midbit, b, L.t_lc);
  const float tz = L.t_lc + b;
  const int kv = k.kvis, maxb = a.maxb, dc0 = k.dc;
  const float t1 = tr.t_near(kv - 1), t2 = tr.t_near(kv - 2);
  const float lastpeak = kv >= 1 ? t1 : NRZI_NEG_T;
  const float prevlast = kv >= 2 ? t2 : NRZI_NEG_T;
  const bool last_in = lastpeak > left && lastpeak < right;
  const bool prev_in = prevlast > left && prevlast < right;
  const bool dup = last_in && prev_in;          // noisy double peak
  const bool b2 = !last_in && prev_in;
  const bool later = !last_in && !prev_in && lastpeak > right;
  const bool zero = !last_in && !prev_in && !later;
  int d = dup ? dc0 - 1 : dc0;
  if (later) {                 // insert 0 before the 1 just appended
    k.put<REC>(d - 1 > 0 ? d - 1 : 0, 0);
    k.put<REC>(d < maxb - 1 ? d : maxb - 1, 1);
    d = d + 1 < maxb ? d + 1 : maxb;
  }
  if (zero) {                  // plain zero: append a 0
    k.put<REC>(d < maxb - 1 ? d : maxb - 1, 0);
    d = d + 1 < maxb ? d + 1 : maxb;
  }
  if ((later || zero) && dc0 == 0 && d > dc0) k.tfirst = tz;
  if (later) k.tlast = lastpeak;
  else if (zero) k.tlast = tz;
  k.dc = d;
  NrziSlotPart p;
  p.x = last_in ? lastpeak : (b2 ? prevlast : 0.0f);
  p.g = a.correct && kv >= 1 ? tr.agc(kv - 1) : 1.0f;
  p.key = last_in ? dc0 - (dup ? 2 : 1) : dc0 - 2;
  p.flags = (last_in || b2 ? NRZI_PF_BIT : 0) | (later ? NRZI_PF_LATER : 0) |
            ((k.col0 & 1) ? NRZI_PF_COL0 : 0) | (last_in || prev_in ? NRZI_PF_CAND : 0);
  return p;
}

// -correct's choice of the track to flip: the first of the highest AGC
// gain, when it is at least twice the next highest
NRZI_HD bool nrzi_slot_badtrk(const NrziSlotPart* part, const NrziSlotLane& a,
                              int& badtrk) {
  float hi = -1.0f;
  badtrk = 0;
NRZI_UNROLL
  for (int t = 0; t < NRZI_MAX_TRACKS; ++t) {
    const float g = part[t].g;
    if (t < a.T && (t == 0 || g > hi)) {
      hi = g;
      badtrk = t;
    }
  }
  float next_hi = -1.0f;
NRZI_UNROLL
  for (int t = 0; t < NRZI_MAX_TRACKS; ++t) {
    const float g = t == badtrk ? -1.0f : part[t].g;
    if (t < a.T && (t == 0 || g > next_hi)) next_hi = g;
  }
  return hi >= 2.0f * next_hi;
}

// the slot's close over the tracks' zerocheck parts: the clock, the
// post-area count, the next slot's window and -correct; s_z: the slot's
// boundary; REC, the record mode: s_last, the boundary its last consume
// round ran to
template <bool REC>
NRZI_HD void nrzi_slot_close(NrziSlotState& L, const NrziSlotPart* part,
                             const NrziSlotLane& a, float b, int s_z, int s_last) {
  int numbits = 0, numlater = 0, par = 0;
  float avg_pos = 0.0f;
NRZI_UNROLL
  for (int t = 0; t < NRZI_MAX_TRACKS; ++t) {
    if (t >= a.T) break;
    const NrziSlotPart p = part[t];
    numbits += (p.flags & NRZI_PF_BIT) != 0;
    numlater += (p.flags & NRZI_PF_LATER) != 0;
    par ^= (p.flags & NRZI_PF_COL0) != 0;
    avg_pos = avg_pos + p.x;
  }
  const bool have = numbits > 0;
  const int post = L.post;
  const float right = fmaf(1.0f + a.midbit, b, L.t_lc);
  int post_h = post == 1 ? 0 : post;        // cancel a fresh post
  const float avgp = avg_pos / (float)(numbits > 1 ? numbits : 1);
  const float expected = L.t_lc + b;
  const float adjusted = post_h > 0 ? avgp : fmaf(a.padj, avgp - expected, expected);
  const float delta = adjusted - L.t_lc;
  if (have && post_h == 0) {                // adjust_clock
    if (a.cw > 0) {
      const float old = L.ring[L.bitndx];
      L.ring[L.bitndx] = delta;
      L.bitndx = L.bitndx + 1 >= a.cw ? 0 : L.bitndx + 1;
      L.avg = b + (delta - old) / (float)a.cw;
    } else if (a.ca > 0.0f) {
      // XLA's CPU build fuses either product of the JAX package's
      // a * delta + (1 - a) * avg, by program (decode/slot.py)
      L.avg = a.clk_avg_fma ? fmaf(1.0f - a.ca, b, a.ca * delta)
                            : fmaf(a.ca, delta, (1.0f - a.ca) * b);
    } else {
      L.avg = a.spb;
    }
  }
  post_h = post_h > 0 ? post_h + 1 : post_h;
  const int post_n = (numlater == 0 && post == 0) ? 1 : (post > 0 ? post + 1 : post);
  L.post = have ? post_h : post_n;
  L.t_lc = have ? adjusted : L.t_lc + b;
  L.t_lm = right;

  // -correct, release-binary semantics: the parity check reads column 0
  // (readtape.c nrzi_zerocheck:245,302)
  L.flip = -1;
  L.flipcol = 0;
  L.dcheck = 0;
  int badtrk;
  if (a.correct == NRZI_CORRECT_RELEASE && have && par != a.exp_par &&
      nrzi_slot_badtrk(part, a, badtrk)) {
    L.flip = badtrk;
    L.corrected += 1;
    L.faked |= 1 << (a.T - 1 - badtrk);
  }
  // the DEBUG build's: last_complete_byte is what the highest track with a
  // peak in the window leaves; the drive takes that column's parity next
  if (a.correct == NRZI_CORRECT_DEBUG && have) {
    int hi_t = -1;
NRZI_UNROLL
    for (int t = 0; t < NRZI_MAX_TRACKS; ++t)
      if (t < a.T && (part[t].flags & NRZI_PF_CAND)) hi_t = t;
    const int lcb = hi_t >= 0 ? part[hi_t].key : -1;
    L.dcheck = lcb >= 0 && lcb < a.maxb;
    L.lcb = lcb;
  }
  if (REC) {
    a.dbg_slot[2 * L.nslot] = (float)(s_last < a.S ? s_last : a.S);
    a.dbg_slot[2 * L.nslot + 1] = have ? adjusted : 0.0f;
  }
  L.nslot += 1;
  if (L.post >= 8) {
    L.end_s = s_z < a.S ? s_z : a.S;
    L.done = 1;
  }
  if (s_z >= a.S) L.done = 1;
}

// the DEBUG build's -correct after the slot's writes found column L.lcb's
// parity wrong: the release check's choice of track, flipped there
NRZI_HD void nrzi_slot_debug_fix(NrziSlotState& L, const NrziSlotPart* part,
                                 const NrziSlotLane& a) {
  int badtrk;
  if (!nrzi_slot_badtrk(part, a, badtrk)) return;
  L.flip = badtrk;
  L.flipcol = L.lcb;
  L.corrected += 1;
  L.faked |= 1 << (a.T - 1 - badtrk);
}

// -correct's flip of the slot just closed, by the track it flips
NRZI_HD void nrzi_slot_flip(NrziSlotTrk& k, const NrziSlotState& L, int t) {
  if (t == L.flip) {
    const int c = L.flipcol;
    k.put(c, (c == 0 ? k.col0 : k.bits[c]) ^ 1);
  }
}

// track t's outputs once the machine has stopped, and its counts
NRZI_HD NrziSlotPart nrzi_slot_track_finish(const NrziSlotTrk& k, const NrziSlotLane& a,
                                            int t) {
  int32_t* ti = a.trk_i + t * N_TI;
  float* tf = a.trk_f + t * N_TF;
  ti[TI_DC] = k.dc;
  ti[TI_KVIS] = k.kvis;
  ti[TI_TRKSUM] = k.trksum;
  tf[TF_TFIRST] = k.tfirst;
  tf[TF_TLAST] = k.tlast;
  if (a.adj0) {
    a.adj[2 * t] = k.adj_n;
    a.adj[2 * t + 1] = k.adj_mean;
  }
  NrziSlotPart p;
  p.x = p.g = 0.0f;
  p.key = k.missed;
  p.flags = k.overflow ? NRZI_PF_OVF : 0;
  return p;
}

NRZI_HD void nrzi_slot_finish(const NrziSlotState& L, const NrziSlotPart* part,
                              const NrziSlotLane& a) {
  int missed = 0, overflow = 0;
NRZI_UNROLL
  for (int t = 0; t < NRZI_MAX_TRACKS; ++t) {
    const NrziSlotPart p = part[t];
    if (t >= a.T) continue;
    missed += p.key;
    overflow |= (p.flags & NRZI_PF_OVF) != 0;
  }
  int32_t* li = a.lane_i;
  li[LI_MISSMID] = missed;
  li[LI_CORR] = L.corrected;
  li[LI_FAKED] = L.faked;
  li[LI_CONSOVF] = overflow;
  li[LI_ENDS] = L.end_s;
  li[LI_NSLOT] = L.nslot;
  if (a.bitspace) *a.bitspace = L.avg;
}

// The machine over one lane. ex.each(m, f) calls f(track state,
// transition source, t) for every track and ex.one(m, f) calls f() once;
// each returns once every call is done (m: the kind of step, NRZI_M_*,
// or -1). ex.parity(f) returns the XOR over the tracks of f(track state,
// t) & 1. L and part: the lane's state and NRZI_MAX_TRACKS parts, where
// every track and the combines see them (the combines read all of them
// at once and use the first T). REC: the record mode (NrziSlotLane::
// dbg_slot and col_slot set), a separate instantiation so that the
// decode's machine carries none of it
template <bool REC, class Exec>
NRZI_HD void nrzi_slot_drive(Exec& ex, const NrziSlotLane& a, NrziSlotState& L,
                             NrziSlotPart* part) {
  ex.each(-1, [&](NrziSlotTrk& k, auto& tr, int t) {
    part[t] = nrzi_slot_track_open(k, tr, a, t);
  });
  ex.one(-1, [&] { nrzi_slot_open(L, part, a); });
  while (!L.done && L.nslot < a.max_slots) {
    const float b = L.avg;
    // Two consume rounds, then the zerocheck. In the post area a
    // realignment follows each round and may push the next boundary
    // later. Elsewhere both rounds share one boundary, so a track runs
    // its steps at once: its second round only after a first that filled
    // all four places (else it finds nothing), then its zerocheck
    const bool realign = L.post > 0;
    int s_last = 0;
    for (int r = 0; r < (realign ? 2 : 1); ++r) {
      if (REC) s_last = nrzi_boundary(L.t_lc, b);
      ex.each(NRZI_M_TRACKS, [&](NrziSlotTrk& k, auto& tr, int t) {
        if (r == 0) {
          nrzi_slot_flip(k, L, t);
          tr.ahead(k.kvis);
          if (REC) k.slot = L.nslot;
        }
        const int s_z = nrzi_boundary(L.t_lc, b);
        const int s_zc = s_z < a.S ? s_z : a.S;
        part[t].x = nrzi_consume_track<REC>(k, tr, t, s_zc, L, a);
        if (!realign) {
          if (k.n_new == 4) nrzi_consume_track<REC>(k, tr, t, s_zc, L, a);
          part[t] = nrzi_zerocheck_track<REC>(k, tr, L, a, b);
        }
      });
      if (realign) ex.one(NRZI_M_REALIGN, [&] { nrzi_slot_realign(L, part, a, b); });
    }
    if (realign)
      ex.each(NRZI_M_TRACKS, [&](NrziSlotTrk& k, auto& tr, int t) {
        part[t] = nrzi_zerocheck_track<REC>(k, tr, L, a, b);
      });
    const int s_z = nrzi_boundary(L.t_lc, b);
    ex.one(NRZI_M_CLOSE, [&] { nrzi_slot_close<REC>(L, part, a, b, s_z, s_last); });
    if (L.dcheck) {          // the DEBUG build's check: each track reads its own row
      const int par = ex.parity([&](NrziSlotTrk& k, int) { return (int)k.bits[L.lcb]; });
      if (par != a.exp_par) ex.one(NRZI_M_CLOSE, [&] { nrzi_slot_debug_fix(L, part, a); });
    }
  }
  ex.each(-1, [&](NrziSlotTrk& k, auto&, int t) {
    nrzi_slot_flip(k, L, t);
    part[t] = nrzi_slot_track_finish(k, a, t);
  });
  ex.one(-1, [&] { nrzi_slot_finish(L, part, a); });
}

// the host's executor: the tracks one after another
struct NrziSerial {
  NrziSlotTrk k[NRZI_MAX_TRACKS];
  NrziRowSrc tr[NRZI_MAX_TRACKS];
  int T;
  template <class F> NRZI_HDM void each(int, F f) {
    for (int t = 0; t < T; ++t) f(k[t], tr[t], t);
  }
  template <class F> NRZI_HDM void one(int, F f) { f(); }
  template <class F> NRZI_HDM int parity(F f) {
    int p = 0;
    for (int t = 0; t < T; ++t) p ^= f(k[t], t) & 1;
    return p;
  }
};

// the slot machine of one lane, serially (the host build)
NRZI_HD void nrzi_slot_run(const NrziSlotLane& a) {
  NrziSerial ex;
  ex.T = a.T;
  for (int t = 0; t < a.T; ++t) {
    ex.k[t].bits = a.bits + (int64_t)t * a.maxb;
    ex.k[t].hist = a.hist + t * 50;
    ex.tr[t].rs = a.tr_s + (int64_t)t * a.K;
    ex.tr[t].rt = a.tr_t + (int64_t)t * a.K;
    ex.tr[t].ragc = a.tr_agc + (int64_t)t * a.K;
    ex.tr[t].K = a.K;
  }
  NrziSlotState L;
  NrziSlotPart part[NRZI_MAX_TRACKS] = {};
  if (a.dbg_slot)
    nrzi_slot_drive<true>(ex, a, L, part);
  else
    nrzi_slot_drive<false>(ex, a, L, part);
}

#ifdef __CUDACC__
// ---------------------------------------------------------------------------
// the card's executor: one lane per warp, track t on thread t (T <= 16),
// the combines on thread 0. Each track's transitions come from a ring of
// NRZI_RING entries in shared memory, refilled by cp.async NRZI_RING_BLK
// entries at a time, two blocks ahead of the one its cursor reads: kvis
// grows by at most 8 a slot and a slot reads kvis - 2 .. kvis + 7, so no
// slot waits on device memory once the first two blocks have arrived
// ---------------------------------------------------------------------------

#define NRZI_RING 128
#define NRZI_RING_BLK 32

// (the executor's members are __host__ __device__ so that the drive's
// template may call them; they do their work in the device build only)
struct NrziRingSrc {
  int32_t* rs;               // shared [NRZI_RING]
  float* rt;
  float* ragc;
  const int32_t* gs;         // the track's [K] rows in device memory
  const float* gt;
  const float* gagc;
  int lim, nxt;              // valid entries; the next block to load
  NRZI_HDM int s(int k) const { return rs[k & (NRZI_RING - 1)]; }
  NRZI_HDM float t(int k) const { return rt[k & (NRZI_RING - 1)]; }
  NRZI_HDM float agc(int k) const { return ragc[k & (NRZI_RING - 1)]; }
  NRZI_HDM int s_near(int k) const { return s(k); }
  NRZI_HDM float t_near(int k) const { return t(k); }
  // one block, as one cp.async group (empty past lim)
  NRZI_HDM void load(int blk) {
    const int k0 = blk * NRZI_RING_BLK;
    const int k1 = k0 + NRZI_RING_BLK < lim ? k0 + NRZI_RING_BLK : lim;
    for (int k = k0; k < k1; ++k) {
      const int r = k & (NRZI_RING - 1);
      nrzi_cp4(rs + r, gs + k);
      nrzi_cp4(rt + r, gt + k);
      nrzi_cp4(ragc + r, gagc + k);
    }
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
  }
  NRZI_HDM void start(int n) {
    lim = n;
    for (nxt = 0; nxt < 3; ++nxt) load(nxt);
  }
  // before a slot at kvis: the blocks through kvis's next resident, the
  // one after that on its way
  NRZI_HDM void ahead(int kvis) {
    if (nxt <= (kvis >> 5) + 2) load(nxt++);
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
  }
};

NRZI_HDM long long nrzi_clock() {
#ifdef __CUDA_ARCH__
  return clock64();
#else
  return 0;
#endif
}

struct NrziWarp {
  NrziSlotTrk k;
  NrziRingSrc tr;
  int t;                     // this thread's track, if own
  bool own;
  long long* acc;            // shared [NRZI_NMACH] cycles per step, or null
  template <class F> NRZI_HDM void each(int m, F f) {
    const long long c = acc ? nrzi_clock() : 0;
    if (own) f(k, tr, t);
    sync(m, c);
  }
  template <class F> NRZI_HDM void one(int m, F f) {
    const long long c = acc ? nrzi_clock() : 0;
    if (t == 0) f();
    sync(m, c);
  }
  // a warp vote: every thread of the warp calls it
  template <class F> NRZI_HDM int parity(F f) {
    const int v = own ? f(k, t) & 1 : 0;
#ifdef __CUDA_ARCH__
    return __popc(__ballot_sync(0xffffffffu, v)) & 1;
#else
    return v;
#endif
  }
  NRZI_HDM void sync(int m, long long c) {
#ifdef __CUDA_ARCH__
    __syncwarp();
    if (acc && t == 0 && m >= 0) acc[m] += clock64() - c;
#endif
  }
};

// shared memory of one warp's slot machine for T tracks
static inline size_t nrzi_slot_smem(int T) {
  return sizeof(NrziSlotState) + NRZI_MAX_TRACKS * sizeof(NrziSlotPart) +
         NRZI_NMACH * 8 + (size_t)T * (NRZI_RING * 12 + 50 * 4);
}

// The slot machine of one lane on one warp: all 32 threads call it. sm:
// nrzi_slot_smem(a.T) bytes of shared memory, 16-byte aligned. The
// histogram rows live there and are written out at the end. mach: null,
// or where thread 0 writes the cycles spent in each step (NRZI_NMACH).
// REC: the record mode (nrzi_slot_drive)
template <bool REC = false>
static __device__ void nrzi_slot_warp(const NrziSlotLane& a, unsigned char* sm,
                                      int64_t* mach) {
  NrziSlotState& L = *(NrziSlotState*)sm;
  NrziSlotPart* part = (NrziSlotPart*)(&L + 1);              // [NRZI_MAX_TRACKS]
  long long* acc = (long long*)(part + NRZI_MAX_TRACKS);     // [NRZI_NMACH]
  int32_t* rs = (int32_t*)(acc + NRZI_NMACH);                // [T][NRZI_RING]
  float* rt = (float*)(rs + a.T * NRZI_RING);
  float* ragc = rt + a.T * NRZI_RING;
  int32_t* hist = (int32_t*)(ragc + a.T * NRZI_RING);        // [T][50]
  NrziWarp ex;
  ex.t = threadIdx.x & 31;
  ex.own = ex.t < a.T;
  ex.acc = mach ? acc : 0;
  if (mach && ex.t == 0)
    for (int i = 0; i < NRZI_NMACH; ++i) acc[i] = 0;
  if (ex.own) {
    const int t = ex.t;
    ex.k.bits = a.bits + (int64_t)t * a.maxb;
    ex.k.hist = hist + t * 50;
    for (int i = 0; i < 50; ++i) ex.k.hist[i] = 0;
    ex.tr.rs = rs + t * NRZI_RING;
    ex.tr.rt = rt + t * NRZI_RING;
    ex.tr.ragc = ragc + t * NRZI_RING;
    ex.tr.gs = a.tr_s + (int64_t)t * a.K;
    ex.tr.gt = a.tr_t + (int64_t)t * a.K;
    ex.tr.gagc = a.tr_agc + (int64_t)t * a.K;
  }
  nrzi_slot_drive<REC>(ex, a, L, part);
  if (ex.own) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    for (int i = 0; i < 50; ++i) a.hist[ex.t * 50 + i] = ex.k.hist[i];
  }
  if (mach && ex.t == 0)
    for (int i = 0; i < NRZI_NMACH; ++i) mach[i] = acc[i];
}
#endif

// lane b*P + p of the slot machine, over its [T, K] buffers: B1's phase
// B (NrziArgs, the buffers phase A filled) or B6 (NrziSlotArgs, the
// admission's), whose blocks share these fields
template <class A>
NRZI_HD NrziSlotLane nrzi_slot_lane_of(const A& a, int lane) {
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
  L.adj0 = 0;
  L.adj = 0;
  L.bitspace = 0;
  L.dbg_slot = 0;
  L.col_slot = 0;
  L.T = a.T;
  L.K = a.K;
  L.S = a.S;
  L.maxb = a.maxb;
  L.max_slots = a.max_slots;
  L.correct = a.do_correct;
  L.exp_par = a.exp_par;
  L.cw = a.p_clk_window[p];
  L.clk_avg_fma = 0;
  L.ca = a.p_clk_alpha[p];
  L.padj = a.p_pulse_adj[p];
  L.midbit = a.p_midbit[p];
  L.spb = a.spb;
  L.lb = a.stat_lb;
  L.bw = a.stat_bw;
  return L;
}

// B1's phase B for a lane, serially (the host build)
NRZI_HD void nrzi_slot_machine(const NrziArgs& a, int lane) {
  nrzi_slot_run(nrzi_slot_lane_of(a, lane));
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
// B5 (admission alone, nrzi_scan.cu: B5a a block per (segment, track),
// its parmsets' walkers over chunks staged once for all of them; B5b a
// block per (segment, parmset, track) lane; both walk chunk by chunk over
// entries staged in shared memory) and B6 (the slot machine alone:
// nrzi_slot.cu runs a lane per warp, the host build nrzi_slot_lane).
// Their outputs come pre-filled from the wrapper (kernels.py): transition
// buffers with compact_outputs' fill (BIG_S, 0.0, 1.0, false), bits and
// hist zeroed
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
  int64_t* stamps;           // [B*P*T, SCAN_NSTAMP] B5b's walk clocks
                             // (B5a: SCANA_NSTAMP), or null
  int32_t B, P, T, S, G, K, max_steps;
};

// lane = (b*P + p)*T + t: its jump table and feature rows
NRZI_HD NrziTableSrc nrzi_scan_src(const NrziScanArgs& a, int lane) {
  const int t = lane % a.T, bp = lane / a.T;
  const int p = bp % a.P, b = bp / a.P;
  NrziTableSrc src;
  src.ft = (const NrziTableRow*)(a.feat + (((int64_t)a.grp[p] * a.B + b) * a.T + t) *
                                              a.S * NRZI_NFEAT);
  src.nxt = a.nxt + ((int64_t)b * a.T + t) * (a.S + 1);
  src.S = a.S;
  return src;
}

// the lane's walk at its start (heights: NRZI_MAX_AGC_RING floats)
NRZI_HD void nrzi_scan_walk_init(NrziWalk& w, const NrziScanArgs& a, int lane,
                                 float* heights) {
  NrziTrack o;
  o.s = a.tr_s + (int64_t)lane * a.K;
  o.t = a.tr_t + (int64_t)lane * a.K;
  o.agc = a.tr_agc + (int64_t)lane * a.K;
  o.top = a.tr_top + (int64_t)lane * a.K;
  o.K = a.K;
  nrzi_walk_init(w, nrzi_knobs(a.p_w, a.p_agc_window, a.p_rise, a.p_minp, a.p_agc_alpha,
                               (lane / a.T) % a.P),
                 o, heights);
}

// the lane's results once its walk has stopped. incomplete: the cursor
// stopped before S (the step budget) or admissions overflowed the K
// buffer entries
NRZI_HD void nrzi_scan_walk_finish(const NrziWalk& w, const NrziScanArgs& a, int lane) {
  const NrziAdmitRes r = nrzi_walk_result(w, a.S);
  a.n_admitted[lane] = r.n_adm;
  a.max_agc_gain[lane] = r.max_agc;
  a.min_agc_gain[lane] = r.min_agc;
  a.incomplete[lane] = r.incomplete || r.n_adm > a.K;
}

// ---------------------------------------------------------------------------
// B5a's block (nrzi_scan.cu nrzi_scan_kernel): one (segment, track) row
// b*T + t and a walker for each of the parmsets p0 .. p0 + nw - 1 (P cut
// into nrzi_scan_parts parts). The walkers read one jump table and at
// most nw feature groups, so the block stages each chunk of C table
// entries once for all of them, into slot i & 1: its entries, its
// candidate words (bit s: nxt[s] == s) and, for each group a walker
// reads, the feature rows at its candidates. Each live walker then walks
// the chunk (nrzi_walk_chunk) over the words and its group's rows under
// its own step budget, and stops on its own; the block goes on while any
// walker is alive. An executor ex runs the two: on the card (nrzi_scan.cu
// ScanCard) staging warps fill chunk i + 1 while each walker, thread 0 of
// a warp of its own, walks chunk i; on the host (NrziScanSerial) the
// staging, then each walker, in turn
// ---------------------------------------------------------------------------

#define NRZI_SCAN_MAX_WALK 8       // walkers (parmsets) per block

// P parmsets cut into parts of at most NRZI_SCAN_MAX_WALK, as even as
// they go: returns the number of parts, *pb the parmsets of the largest
NRZI_HD int nrzi_scan_parts(int P, int* pb) {
  const int n = (P + NRZI_SCAN_MAX_WALK - 1) / NRZI_SCAN_MAX_WALK;
  *pb = (P + n - 1) / n;
  return n;
}

struct NrziScanBlk {
  const int32_t* nxt;        // the row's jump table [S + 1]
  const NrziTableRow* ft;    // the row's rows of group 0 [S]; group g's at
  int64_t gstride;           //   ft + g * gstride
  int32_t* ent;              // [2][C] staged entries
  uint32_t* wd;              // [2][CW] candidate words
  NrziTableRow* rows;        // [2][ng][C] feature rows, at candidates only
  int S, C, CW, ng;
  int gsrc[NRZI_SCAN_MAX_WALK];   // the group of each of the ng row blocks
};

// one walker: its walk, lane (b*P + p)*T + t, row block; with stamps, the
// clock64() cycles it walked and waited at the block's barrier after the
// chunks it walked
struct NrziScanWalker {
  NrziWalk w;
  int lane, gslot;
  bool alive;
  long long walked, waited;
};

// bytes of a block's slots at chunk C, ng groups and nw walkers
NRZI_HD size_t nrzi_scan_blk_smem(int C, int ng, int nw) {
  return (size_t)2 * ng * C * sizeof(NrziTableRow) + (size_t)2 * C * 4 +
         (size_t)2 * (C >> 5) * 4 + (size_t)nw * NRZI_MAX_AGC_RING * 4;
}

// The block of row b*T + t and parmsets p0 .. p0 + nw - 1 over the slots
// at sm (nrzi_scan_blk_smem(C, ng, nw), 16-byte aligned, ng at least the
// groups these parmsets read); *heights: the walkers' AGC rings there
NRZI_HD NrziScanBlk nrzi_scan_blk(const NrziScanArgs& a, int row, int p0, int nw, int C,
                                  int ng, unsigned char* sm, float** heights) {
  NrziScanBlk k;
  k.nxt = a.nxt + (int64_t)row * (a.S + 1);
  k.ft = (const NrziTableRow*)a.feat + (int64_t)row * a.S;
  k.gstride = (int64_t)a.B * a.T * a.S;
  k.S = a.S;
  k.C = C;
  k.CW = C >> 5;
  k.ng = 0;
  for (int g = 0; g < a.G; ++g)
    for (int j = 0; j < nw; ++j)
      if (a.grp[p0 + j] == g) {
        k.gsrc[k.ng++] = g;
        break;
      }
  k.rows = (NrziTableRow*)sm;
  k.ent = (int32_t*)(k.rows + 2 * ng * C);
  k.wd = (uint32_t*)(k.ent + 2 * C);
  *heights = (float*)(k.wd + 2 * k.CW);
  return k;
}

// walker j of the block (parmset p0 + j) at its start
NRZI_HD void nrzi_scan_walker_init(NrziScanWalker& w, const NrziScanArgs& a,
                                   const NrziScanBlk& k, int row, int p0, int j,
                                   float* heights) {
  const int p = p0 + j;
  w.lane = ((row / a.T) * a.P + p) * a.T + row % a.T;
  nrzi_scan_walk_init(w.w, a, w.lane, heights + j * NRZI_MAX_AGC_RING);
  w.gslot = 0;
  for (int g = 0; g < k.ng; ++g)
    if (k.gsrc[g] == a.grp[p]) w.gslot = g;
  w.alive = true;
  w.walked = w.waited = 0;
}

NRZI_HD int nrzi_scan_c1(const NrziScanBlk& k, int i) {
  return (i + 1) * k.C < k.S ? (i + 1) * k.C : k.S;
}

// entry slot i & 1 <- nxt[c0 .. c1), staging thread ex.tid of ex.n a share
template <class Ex>
NRZI_HD void nrzi_scan_entries(Ex& ex, const NrziScanBlk& k, int i) {
  const int c0 = i * k.C, c1 = nrzi_scan_c1(k, i);
  int32_t* e = k.ent + (i & 1) * k.C;
  for (int s = c0 + ex.tid; s < c1; s += ex.n) ex.cp4(e + (s - c0), k.nxt + s);
  ex.commit();
}

// row slot i & 1 <- chunk i's candidate words, a word per staging warp in
// turn (one vote of its 32 lanes over the staged entries), and each
// candidate's row of every staged group (its lane copies them)
template <class Ex>
NRZI_HD void nrzi_scan_rows(Ex& ex, const NrziScanBlk& k, int i) {
  const int c0 = i * k.C, c1 = nrzi_scan_c1(k, i);
  const int32_t* e = k.ent + (i & 1) * k.C;
  uint32_t* wd = k.wd + (i & 1) * k.CW;
  NrziTableRow* r = k.rows + (i & 1) * k.ng * k.C;
  for (int q = ex.warp; q < k.CW; q += ex.nwarp) {
    const int x0 = q << 5;
    const uint32_t word =
        ex.ballot([&](int l) { return c0 + x0 + l < c1 && e[x0 + l] == c0 + x0 + l; });
    ex.lanes([&](int l) {
      if (l == 0) wd[q] = word;
      if ((word >> l) & 1u)
        for (int j = 0; j < k.ng; ++j)
          ex.cp_row(r + j * k.C + x0 + l, k.ft + k.gsrc[j] * k.gstride + c0 + x0 + l);
    });
  }
  ex.commit();
}

// chunk i's words and rows from its staged entries, chunk i + 1's entries
// on their way; returns once chunk i's rows have landed
template <class Ex>
NRZI_HD void nrzi_scan_fill(Ex& ex, const NrziScanBlk& k, int i, int nch) {
  ex.wait_entries();
  nrzi_scan_rows(ex, k, i);
  if (i + 1 < nch) nrzi_scan_entries(ex, k, i + 1);
  else ex.commit();
  ex.wait_rows();
}

// before chunk 0 (nch >= 1): chunk 0 staged, chunk 1's entries on their way
template <class Ex>
NRZI_HD void nrzi_scan_prime(Ex& ex, const NrziScanBlk& k, int nch) {
  ex.stage([&] {
    nrzi_scan_entries(ex, k, 0);
    nrzi_scan_fill(ex, k, 0, nch);
  });
  ex.any();
}

// The block's step at chunk i of nch: the staging fills chunk i + 1 while
// each live walker walks chunk i over its words and its group's rows, with
// the budget max_steps. Returns, at a barrier of the block, whether any
// walker is still alive
template <class Ex>
NRZI_HD bool nrzi_scan_chunk(Ex& ex, const NrziScanBlk& k, int i, int nch, int max_steps) {
  if (i + 1 < nch) ex.stage([&] { nrzi_scan_fill(ex, k, i + 1, nch); });
  const int c0 = i * k.C, c1 = nrzi_scan_c1(k, i);
  const uint32_t* wd = k.wd + (i & 1) * k.CW;
  const NrziTableRow* r = k.rows + (i & 1) * k.ng * k.C;
  ex.walk([&](NrziScanWalker& w) {
    w.alive = nrzi_walk_chunk(w.w, wd, r + w.gslot * k.C, c0, c1, k.S, max_steps);
  });
  return ex.any();
}

// B5a's executor on the host: the staging (one thread, its warp's 32
// lanes in a loop), then each live walker, in turn
struct NrziScanSerial {
  NrziScanWalker* w;         // [nw]
  int nw;
  int tid, n, warp, nwarp;   // the staging thread: 0 of 1, warp 0 of 1
  template <class F> NRZI_HDM void stage(F f) { f(); }
  template <class F> NRZI_HDM void walk(F f) {
    for (int j = 0; j < nw; ++j)
      if (w[j].alive) f(w[j]);
  }
  NRZI_HDM bool any() const {
    bool r = false;
    for (int j = 0; j < nw; ++j) r = r || w[j].alive;
    return r;
  }
  template <class F> NRZI_HDM uint32_t ballot(F f) const {
    uint32_t m = 0;
    for (int l = 0; l < 32; ++l)
      if (f(l)) m |= 1u << l;
    return m;
  }
  template <class F> NRZI_HDM void lanes(F f) const {
    for (int l = 0; l < 32; ++l) f(l);
  }
  NRZI_HDM void cp4(int32_t* d, const int32_t* s) const { *d = *s; }
  NRZI_HDM void cp_row(NrziTableRow* d, const NrziTableRow* s) const { *d = *s; }
  NRZI_HDM void commit() const {}
  NRZI_HDM void wait_entries() const {}
  NRZI_HDM void wait_rows() const {}
};

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
  int64_t* stamps;           // [B*P, SLOT_NSTAMP] loop clocks, or null
  const float* adj0;         // [B*P, T, 2] -adjskew's seeds, or null (B6 only)
  float* adj;                // [B*P, T, 2] the accumulators at the end
  float* bitspace;           // [B*P] the clock at the end
  float* dbg_slot;           // [B*P, max_slots, 2] -trace's records, or null
  int32_t* col_slot;         // [B*P, T, maxb] (B6 only, -correct off)
  int32_t B, P, T, S, K, maxb, max_slots;
  int32_t do_correct;        // NRZI_CORRECT_* (B1's NrziArgs: off or release)
  int32_t exp_par;
  int32_t clk_avg_fma;       // 1: the clock's other contraction (B6 only)
  float spb, stat_lb, stat_bw;
};

// track t's admission fields copied into B1's output columns, which the
// machine's open reads
NRZI_HD void nrzi_slot_copy_track(const NrziSlotArgs& a, int lane, int t) {
  const int64_t lt = (int64_t)lane * a.T + t;
  a.trk_i[lt * N_TI + TI_NADM] = a.n_admitted[lt];
  a.trk_i[lt * N_TI + TI_INCOMP] = a.incomplete[lt] != 0;
  a.trk_f[lt * N_TF + TF_MAXAGC] = a.max_agc_gain[lt];
  a.trk_f[lt * N_TF + TF_MINAGC] = a.min_agc_gain[lt];
}

// B6's lane: nrzi_slot_lane_of with the clock contraction and the
// -adjskew seeds it was given
NRZI_HD NrziSlotLane nrzi_slot_lane_b6(const NrziSlotArgs& a, int lane) {
  NrziSlotLane L = nrzi_slot_lane_of(a, lane);
  L.clk_avg_fma = a.clk_avg_fma;
  if (a.adj0) {
    const int64_t row = (int64_t)lane * a.T * 2;
    L.adj0 = a.adj0 + row;
    L.adj = a.adj + row;
    L.bitspace = a.bitspace + lane;
  }
  if (a.dbg_slot) {
    L.dbg_slot = a.dbg_slot + (int64_t)lane * a.max_slots * 2;
    L.col_slot = a.col_slot + (int64_t)lane * a.T * a.maxb;
  }
  return L;
}

// B6 for a lane, serially (the host build)
NRZI_HD void nrzi_slot_lane(const NrziSlotArgs& a, int lane) {
  for (int t = 0; t < a.T; ++t) nrzi_slot_copy_track(a, lane, t);
  nrzi_slot_run(nrzi_slot_lane_b6(a, lane));
}
