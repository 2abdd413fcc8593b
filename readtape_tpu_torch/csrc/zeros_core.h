// The -zeros machines shared by the CUDA kernels (zeros.cu: Z1, the
// zero-crossing transition lists; Z2, the GCR bit machine over them) and a
// host build used only by the tests. Every function is
// __host__ __device__ and touches one lane: Z1 one (segment, track), Z2
// one (segment, parmset, track).
//
// Semantics: the JAX package's readtape_tpu/decode/gcr.py
// zerocross_transitions (plain and differentiated) and
// gcr_zeros_track_scan, which the plain PyTorch versions
// (readtape_tpu_torch/decode/gcr.py) mirror. The JAX function computes the
// transitions with associative scans and one serial scan over each
// track's significant phases; here one walk over the samples computes the
// same lists: a sample opens, extends or closes a phase, and a bucket
// (a significant phase and the samples up to the next one) is settled
// when the next significant phase begins. Only comparisons and maxima
// touch floats in Z1; Z2 is gcr_core.h's gcr_bit_step.
#pragma once

#include "gcr_core.h"

#define ZC_PEAK 0.2f             // ZEROCROSS_PEAK
#define ZC_SLOPE 1.5f            // ZEROCROSS_SLOPE

// Z1's arguments. Pointers are device pointers for the kernel and host
// pointers for the host build. Lane = b * T + t; outputs [B, T, cap].
struct ZcArgs {
  const float* volts;        // [B, T, S]
  const int32_t* seg_len;    // [B]: samples >= seg_len read as 0
  const int32_t* lead;       // [B]: samples < lead read as 0
  float* t;                  // crossing time
  float* dt;                 // confirmation lag (plain), 0 (differentiated)
  int32_t* det;              // confirmation sample
  int8_t* ok;
  int8_t* is_top;
  int8_t* valid;
  int32_t* n_found;          // [B, T]: transitions found (> cap: overflow)
  int32_t B, T, S, cap, diff;
};

NRZI_HD int zc_sign(float x) { return x > 0.0f ? 1 : (x < 0.0f ? -1 : 0); }

// one output slot of lane `lane`
NRZI_HD void zc_put(const ZcArgs& a, int lane, int k, float t, bool ok, float dt,
                    int det, bool top, bool valid) {
  const int64_t o = (int64_t)lane * a.cap + k;
  a.t[o] = t;
  a.ok[o] = ok;
  a.dt[o] = dt;
  a.det[o] = det;
  a.is_top[o] = top;
  a.valid[o] = valid;
}

// The plain variant (decoder.c:617-649 as gcr.zerocross_transitions
// computes it). A phase is a maximal run of same-sign samples, exact zeros
// transparent; it is significant once one of its samples exceeds ZC_PEAK.
// Significant phase k opens bucket k, which runs to the next significant
// phase: its threshold comes from the carried extrema (ct = v_top, cbm =
// -v_bot) when it opens, its first sample above the threshold is the
// confirmation point, and its maximum updates the carry when it closes.
// Samples of a phase before it turns significant are <= ZC_PEAK, below
// every threshold and every significant maximum, so counting them in the
// previous bucket changes nothing.
struct ZcPlain {
  float ct, cbm;             // carried extrema magnitudes
  int k;                     // significant phases so far
  // the open bucket k (1 <= k <= cap)
  int a, j;                  // its phase start, its first sample above thr
  bool top, pend;
  float thr, M;
  // the current phase
  int ps, pf;                // start, last nonzero sign
  bool p_strict, p_sig;
  float p_va;
  int prev;                  // the previous sample's sign

  NRZI_HDM void init() {
    ct = cbm = 0.0f;
    k = 0;
    a = j = 0;
    top = pend = false;
    thr = M = 0.0f;
    ps = -1;
    pf = 0;
    p_strict = p_sig = false;
    p_va = 0.0f;
    prev = 0;
  }
  // phase_step for the open bucket, and its list entry
  NRZI_HDM void close(const ZcArgs& a_, int lane) {
    const float own = top ? ct : cbm, opp = top ? cbm : ct;
    const bool conf = pend && M > thr;
    const float own2 = fmaxf(own, M), opp2 = conf ? 0.0f : opp;
    ct = top ? own2 : opp2;
    cbm = top ? opp2 : own2;
    zc_put(a_, lane, k - 1, (float)a, conf, conf ? (float)(j - a) : 0.0f,
           conf ? j : a_.S - 1, top, true);
  }
  NRZI_HDM void step(const ZcArgs& a_, int lane, int i, float x) {
    const int s = zc_sign(x);
    const float am = fabsf(x);
    if (s != 0 && s != pf) {             // a phase starts
      ps = i;
      pf = s;
      p_strict = prev == -s;
      p_va = am;
      p_sig = false;
    }
    if (ps >= 0 && !p_sig && am > ZC_PEAK) {   // ... and turns significant
      p_sig = true;
      if (k >= 1 && k <= a_.cap) close(a_, lane);
      k += 1;
      if (k <= a_.cap) {
        top = pf > 0;
        a = ps;
        j = -1;
        const float own = top ? ct : cbm, opp = top ? cbm : ct;
        pend = p_strict && opp > ZC_PEAK;
        thr = fmaxf(fmaxf(own, p_va), ZC_PEAK);
        M = am;
      }
    }
    if (k >= 1 && k <= a_.cap) {
      M = fmaxf(M, am);
      if (pend && j < 0 && am > thr) j = i;
    }
    prev = s;
  }
  // after the last sample: the open bucket closes; returns the count
  NRZI_HDM int finish(const ZcArgs& a_, int lane) {
    if (k >= 1 && k <= a_.cap) close(a_, lane);
    return k;
  }
  // the unused slots' time and is_top
  NRZI_HDM void fill_value(const ZcArgs& a_, float& t, bool& top_) const {
    t = (float)a_.S;
    top_ = false;
  }
};

// The differentiated variant (decoder.c:654-683 as gcr.zerocross_
// transitions computes it): a crossing (a nonzero sample of the other
// sign than the last nonzero one) fires iff a sample since the previous
// crossing (or the start) exceeded ZC_PEAK; its time is the midpoint of
// the first zero after the last exceeding sample and the last zero before
// the crossing, or the crossing less half a sample. Past cap crossings
// the last one overwrites slot cap - 1 (the JAX scatter's last write).
struct ZcDiff {
  int pf;                    // the last nonzero sign
  bool span_att;             // a sample above ZC_PEAK since the last crossing
  int zf;                    // the first zero after the last such sample (-1)
  int lz;                    // the last zero (-1)
  int n;                     // crossings kept
  // the unused slots' fill: the JAX function reads them at sample S - 1
  int f_zf, f_lz, f_sign;

  NRZI_HDM void init() {
    pf = 0;
    span_att = false;
    zf = lz = -1;
    n = 0;
    f_zf = f_lz = -1;
    f_sign = 0;
  }
  NRZI_HDM float time_at(int pos, int zf_, int lz_) const {
    return zf_ >= 0 && zf_ < pos && lz_ >= zf_ ? ((float)zf_ + (float)lz_) / 2.0f
                                              : (float)pos - 0.5f;
  }
  NRZI_HDM void step(const ZcArgs& a_, int lane, int i, float x) {
    const int s = zc_sign(x);
    const bool att = fabsf(x) > ZC_PEAK;
    if (i == a_.S - 1) {
      f_zf = zf;
      f_lz = lz;
      f_sign = s;
    }
    if (s != 0 && pf != 0 && s != pf) {
      if (span_att) {
        zc_put(a_, lane, n < a_.cap ? n : a_.cap - 1, time_at(i, zf, lz), true, 0.0f, i,
               s > 0, true);
        n += 1;
      }
      span_att = att;
    } else {
      span_att = span_att || att;
    }
    if (att) zf = -1;
    if (s == 0) {
      lz = i;
      if (zf < 0) zf = i;
    }
    if (s != 0) pf = s;
  }
  NRZI_HDM int finish(const ZcArgs&, int) { return n; }
  NRZI_HDM void fill_value(const ZcArgs& a_, float& t, bool& top) const {
    t = time_at(a_.S - 1, f_zf, f_lz);
    top = f_sign > 0;
  }
};

// the fill of slots [n, cap) (threads tid of nt), the values of the
// walk's fill_value
NRZI_HD void zc_fill(const ZcArgs& a, int lane, int n, float t, bool top, int tid, int nt) {
  for (int k = n + tid; k < a.cap; k += nt) zc_put(a, lane, k, t, false, 0.0f, a.S - 1, top, false);
}

// the value of sample i of a segment whose eligible window is [lo, hi)
NRZI_HD float zc_elig(int lo, int hi, int i, float x) { return i < hi && i >= lo ? x : 0.0f; }

// ---------------------------------------------------------------------------
// Z2: gcr.gcr_zeros_track_scan for one (segment, parmset, track) lane
// ---------------------------------------------------------------------------

struct ZsArgs {
  const float* t;            // [B, T, cap] Z1's lists
  const float* dt;
  const int8_t* ok;
  const int8_t* valid;
  const int32_t* p_clk_window;   // [P]
  const float* p_clk_alpha;
  const float* p_z1pt;
  const float* p_z2pt;
  const float* p_pulse_adj;
  int8_t* bits;              // [B, P, T, maxb], zeroed by the caller
  int32_t* datacount;        // [B, P, T]
  int32_t* peakcount;
  float* t_firstbit;
  float* t_lastbit;
  int32_t B, P, T, cap, maxb;
  float spb;
};

// ring: NRZI_MAX_CLK_RING floats of the lane's own
NRZI_HD void zs_lane(const ZsArgs& a, int lane, float* ring) {
  const int t = lane % a.T, p = (lane / a.T) % a.P, b = lane / (a.T * a.P);
  const int64_t row = ((int64_t)b * a.T + t) * a.cap;
  const int cwin = a.p_clk_window[p], maxb = a.maxb;
  const float ca = a.p_clk_alpha[p], z1 = a.p_z1pt[p], z2 = a.p_z2pt[p];
  const float padj = a.p_pulse_adj[p], spb = a.spb;
  GcrBits g;
  g.clk.ring = ring;
  for (int k = 0; k < NRZI_MAX_CLK_RING; ++k) ring[k] = spb;
  g.clk.ndx = 0;
  g.clk.avg = spb;
  g.t_pulse_adj = g.t_peakdelta = g.t_firstbit = g.t_lastbit = g.t_lastpeak = 0.0f;
  g.datablock = false;
  g.dc = g.lastbits = g.rsc = 0;
  int8_t* bits = a.bits + (int64_t)lane * maxb;
  int peaks = 0;
  int32_t wr[3];
  // the valid entries are a prefix; the slope gate reads the live clock
  for (int k = 0; k < a.cap && a.valid[row + k]; ++k) {
    if (!a.ok[row + k] || !(a.dt[row + k] <= g.clk.avg * ZC_SLOPE)) continue;
    gcr_bit_step(g, a.t[row + k], z1, z2, padj, cwin, ca, spb, maxb, wr);
    for (int q = 0; q < 3; ++q)
      if (wr[q] < maxb) bits[wr[q]] = (int8_t)(q == 2);
    peaks += 1;
  }
  a.datacount[lane] = g.dc;
  a.peakcount[lane] = peaks;
  a.t_firstbit[lane] = g.t_firstbit;
  a.t_lastbit[lane] = g.t_lastbit;
}
