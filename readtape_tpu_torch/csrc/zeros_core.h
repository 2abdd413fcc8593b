// The -zeros passes shared by the CUDA kernels (zeros.cu: Z1, the
// zero-crossing transition lists; Z2, the GCR bit machine over them) and a
// host build used only by the tests, which calls them in the kernels'
// order. Every function is __host__ __device__. Z1's touch one thread's
// ZC_R consecutive samples, or (pass B, the entries) one (segment, track)
// lane's buckets; Z2's one walker, a (segment, parmset, track) lane.
//
// Semantics: the JAX package's readtape_tpu/decode/gcr.py
// zerocross_transitions (plain and differentiated) and
// gcr_zeros_track_scan, which the plain PyTorch versions
// (readtape_tpu_torch/decode/gcr.py) mirror.
//
// Z1 works on one chunk of a lane's samples at a time, ZC_R samples per
// thread. Every per-sample quantity of the reference's state machines is
// an exclusive scan: round 1 (ZcScan1) gives each sample the last
// positive, negative, above-ZC_PEAK and zero sample before it and the
// first zero after that above-ZC_PEAK one; round 2 (ZcScan2) the last
// phase start and the count of events (plain) or kept crossings
// (differentiated). A phase is a maximal run of same-sign samples, exact
// zeros transparent; its event is its first sample above ZC_PEAK, and
// event k opens bucket k, which runs to event k + 1: the walk's M and
// confirmation sample range over exactly [e_k, e_{k+1}). Samples of a phase
// before its event are <= ZC_PEAK, below every threshold and every
// bucket's maximum, so the bucket ranges need no phase bounds. The plain
// variant's only serial state, the carried extrema (ct = v_top,
// cbm = -v_bot), is pass B, one thread stepping over the buckets alone;
// the confirmation samples are pass C, an atomicMin per bucket. Only
// comparisons and maxima touch floats, so the reordering is exact.
// Z2 is gcr_core.h's gcr_bit_step over a track's list staged in chunks.
#pragma once

#include <string.h>

#include "gcr_core.h"

#define ZC_PEAK 0.2f             // ZEROCROSS_PEAK
#define ZC_SLOPE 1.5f            // ZEROCROSS_SLOPE
#define ZC_R 8                   // samples per thread in Z1's passes
#define ZC_NONE 0x7fffffff       // no confirmation sample (yet)

// Z1's per-lane stamps (only when ZcArgs::stamps is set): the global
// timer (ns) and clock64() at the start and end, thread 0's cycles in
// pass A (the scans and bucket records), pass B and pass C (with the
// entries), and the buckets pass B stepped over
#define ZC_ST_G0 0
#define ZC_ST_C0 1
#define ZC_ST_C1 2
#define ZC_ST_G1 3
#define ZC_ST_A 4
#define ZC_ST_B 5
#define ZC_ST_C 6
#define ZC_ST_NB 7
#define ZC_NSTAMP 8

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
  int64_t* stamps;           // [B, T, ZC_NSTAMP] or null
  int32_t B, T, S, cap, diff;
};

NRZI_HD int zc_sign(float x) { return x > 0.0f ? 1 : (x < 0.0f ? -1 : 0); }

// the value of sample i of a segment whose eligible window is [lo, hi)
NRZI_HD float zc_elig(int lo, int hi, int i, float x) { return i < hi && i >= lo ? x : 0.0f; }

NRZI_HD uint32_t zc_f2u(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  uint32_t u;
  memcpy(&u, &x, 4);
  return u;
#endif
}

NRZI_HD float zc_u2f(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float x;
  memcpy(&x, &u, 4);
  return x;
#endif
}

// shared-memory atomics on the card; the host build runs one thread
NRZI_HD void zc_amax(uint32_t* p, uint32_t v) {
#ifdef __CUDA_ARCH__
  atomicMax(p, v);
#else
  if (v > *p) *p = v;
#endif
}

NRZI_HD void zc_amin(int32_t* p, int32_t v) {
#ifdef __CUDA_ARCH__
  atomicMin(p, v);
#else
  if (v < *p) *p = v;
#endif
}

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

// the fill of slots [n, cap) (threads tid of nt)
NRZI_HD void zc_fill(const ZcArgs& a, int lane, int n, float t, bool top, int tid, int nt) {
  for (int k = n + tid; k < a.cap; k += nt) zc_put(a, lane, k, t, false, 0.0f, a.S - 1, top, false);
}

// the differentiated variant's transition time at a crossing `pos`: the
// midpoint of the first zero after the last sample above ZC_PEAK and the
// last zero before the crossing, or the crossing less half a sample
NRZI_HD float zc_time_at(int pos, int zf, int lz) {
  return zf >= 0 && zf < pos && lz >= zf ? ((float)zf + (float)lz) / 2.0f : (float)pos - 0.5f;
}

// ---------------------------------------------------------------------------
// Z1, the scans: absolute sample indices, -1 for none
// ---------------------------------------------------------------------------

// round 1: the last positive, negative, above-ZC_PEAK ("att") and zero
// sample, and the first zero after that att sample (or since the start)
struct ZcScan1 {
  int lp, ln, la, lz, fz;
};

// round 2: the last phase start (plain), and the events (plain) or kept
// crossings (differentiated)
struct ZcScan2 {
  int ps, n;
};

NRZI_HD ZcScan1 zc_scan1_id() {
  ZcScan1 c;
  c.lp = c.ln = c.la = c.lz = c.fz = -1;
  return c;
}

NRZI_HD ZcScan2 zc_scan2_id() {
  ZcScan2 c;
  c.ps = -1;
  c.n = 0;
  return c;
}

// l then r (both summaries of consecutive sample ranges)
NRZI_HD ZcScan1 zc_comb(const ZcScan1& l, const ZcScan1& r) {
  ZcScan1 o;
  o.lp = pe_imax(l.lp, r.lp);
  o.ln = pe_imax(l.ln, r.ln);
  o.la = pe_imax(l.la, r.la);
  o.lz = pe_imax(l.lz, r.lz);
  o.fz = r.la >= 0 ? r.fz : (l.fz >= 0 ? l.fz : r.fz);
  return o;
}

NRZI_HD ZcScan2 zc_comb(const ZcScan2& l, const ZcScan2& r) {
  ZcScan2 o;
  o.ps = pe_imax(l.ps, r.ps);
  o.n = l.n + r.n;
  return o;
}

// sample i (value x) appended to a round-1 summary
NRZI_HD void zc_add1(ZcScan1& c, int i, float x) {
  const int s = zc_sign(x);
  if (s > 0) c.lp = i;
  if (s < 0) c.ln = i;
  if (fabsf(x) > ZC_PEAK) {
    c.la = i;
    c.fz = -1;
  }
  if (s == 0) {
    c.lz = i;
    if (c.fz < 0) c.fz = i;
  }
}

// one thread's samples [i0, i0 + ZC_R) and what the passes learn of them
struct ZcThread {
  int i0;
  float x[ZC_R];             // eligible values (0 past S)
  ZcScan1 e1;                // round 1 before i0
  ZcScan2 e2;                // round 2 before i0
  int lopp[ZC_R];            // plain: the last opposite-sign sample before each
  float tm[ZC_R];            // differentiated: each kept crossing's time
  uint32_t ev, ps;           // bit r: an event / kept crossing; a phase start
};

NRZI_HD void zc_t_load(ZcThread& t, const float* raw, int i0, int lo, int hi, int S) {
  t.i0 = i0;
  NRZI_UNROLL
  for (int r = 0; r < ZC_R; ++r) {
    const int i = i0 + r;
    t.x[r] = i < S ? zc_elig(lo, hi, i, raw[r]) : 0.0f;
  }
}

NRZI_HD ZcScan1 zc_t_sum1(const ZcThread& t) {
  ZcScan1 c = zc_scan1_id();
  NRZI_UNROLL
  for (int r = 0; r < ZC_R; ++r) zc_add1(c, t.i0 + r, t.x[r]);
  return c;
}

// ---------------------------------------------------------------------------
// Z1, plain variant (decoder.c:617-649 as gcr.zerocross_transitions
// computes it). A phase starts at a nonzero sample whose sign differs from
// the last nonzero one's; its event is the first sample above ZC_PEAK in
// it: an att sample with no att sample since the last opposite-sign one.
// Bucket k's threshold comes from the carried extrema when it opens
// (pend: the phase began on a literal sign flip and the opposite extremum
// exceeds ZC_PEAK), it confirms iff its maximum exceeds the threshold, at
// its first sample above it, and the maximum updates the carry when it
// closes. Past cap, buckets are counted but neither written nor allowed to
// move the carry.
// ---------------------------------------------------------------------------

// round 2 of one thread: its phase starts and events
NRZI_HD ZcScan2 zc_t_plain2(ZcThread& t) {
  ZcScan1 c = t.e1;
  ZcScan2 s = zc_scan2_id();
  t.ev = t.ps = 0;
  NRZI_UNROLL
  for (int r = 0; r < ZC_R; ++r) {
    const int i = t.i0 + r, sg = zc_sign(t.x[r]);
    const int own = sg > 0 ? c.lp : c.ln, opp = sg > 0 ? c.ln : c.lp;
    if (sg != 0 && own <= opp) {
      t.ps |= 1u << r;
      s.ps = i;
    }
    t.lopp[r] = opp;
    if (fabsf(t.x[r]) > ZC_PEAK && c.la <= opp) {
      t.ev |= 1u << r;
      s.n += 1;
    }
    zc_add1(c, i, t.x[r]);
  }
  return s;
}

#define ZC_F_STRICT 1            // the phase began on a literal sign flip
#define ZC_F_TOP 2               // a positive phase
#define ZC_F_PEND 4              // armed (pass B)
#define ZC_F_CONF 8              // confirmed (pass B)

// one chunk's buckets, local index q = k - kc for bucket k (1-based) when
// kc buckets opened before the chunk: [0] the bucket open at its start,
// [q] the one its q-th event opens. ZC_CHUNK + 2 entries each (pass B
// reads one past the last)
struct ZcRecs {
  int32_t* a;                // phase start
  float* v;                  // |x| at the phase start; pass B: the threshold
  uint32_t* m;               // max |x| of the bucket's samples in the chunk (f32 bits)
  int32_t* j;                // first sample above the threshold, or ZC_NONE
  uint8_t* f;                // ZC_F_*
};

// one thread's bucket records and its samples' share of each bucket's
// maximum (m zeroed before). The threshold takes |x| at the phase start
// (va), which is above ZC_PEAK only when the phase start is the event
// itself: otherwise every sample from the start to the event is <=
// ZC_PEAK and leaves max(own, va, ZC_PEAK) as it is, so va is recorded as
// 0 there and no phase start's value is carried across chunks
NRZI_HD void zc_t_records(const ZcThread& t, const ZcRecs& R, int kc, int cap) {
  int ps = t.e2.ps, n = t.e2.n, rq = -1;
  uint32_t run = 0;                        // the max of the current bucket's run
  NRZI_UNROLL
  for (int r = 0; r < ZC_R; ++r) {
    const int i = t.i0 + r;
    const float am = fabsf(t.x[r]);
    if (t.ps >> r & 1u) ps = i;
    if (t.ev >> r & 1u) {
      n += 1;
      if (n <= cap) {
        const int q = n - kc;
        R.a[q] = ps;
        R.v[q] = ps == i ? am : 0.0f;
        R.f[q] = (ps >= 1 && t.lopp[r] == ps - 1 ? ZC_F_STRICT : 0) | (t.x[r] > 0.0f ? ZC_F_TOP : 0);
      }
    }
    // only samples above ZC_PEAK can raise a bucket's maximum
    if (n >= 1 && n <= cap && am > ZC_PEAK) {
      const int q = n - kc;
      const uint32_t u = zc_f2u(am);
      if (q != rq) {
        if (rq >= 0) zc_amax(&R.m[rq], run);
        rq = q;
        run = u;
      } else if (u > run) {
        run = u;
      }
    }
  }
  if (rq >= 0) zc_amax(&R.m[rq], run);
}

// the lane's carried state, kept by pass B's thread
struct ZcLane {
  float ct, cbm;             // carried extrema magnitudes
  int kc;                    // buckets opened (events) so far
  // the open bucket (1 <= kc <= cap)
  int a, j;
  bool top, pend;
  float thr, M;
};

NRZI_HD void zc_lane_init(ZcLane& L) {
  L.ct = L.cbm = 0.0f;
  L.kc = 0;
  L.a = 0;
  L.j = ZC_NONE;
  L.top = L.pend = false;
  L.thr = L.M = 0.0f;
}

// the carry update when a bucket closes (ZcLane ct/cbm); returns conf
NRZI_HD bool zc_close(ZcLane& L, bool top, bool pend, float thr, float M) {
  const float own = top ? L.ct : L.cbm, opp = top ? L.cbm : L.ct;
  const bool conf = pend && M > thr;
  const float own2 = fmaxf(own, M), opp2 = conf ? 0.0f : opp;
  L.ct = top ? own2 : opp2;
  L.cbm = top ? opp2 : own2;
  return conf;
}

// pass B: the chunk's events in order, each closing the open bucket and
// opening its own, over the records alone; leaves each threshold in R.v,
// the armed and confirmed flags in R.f, and the carried-in bucket's state
// in R[0] for pass C. Returns the buckets stepped over
struct ZcPassB {
  ZcLane& L;
  const ZcRecs& R;
  bool top, pend;
  float thr, M;
  uint8_t fo;                // the open bucket's flags

  // the open bucket (local q - 1) closes
  NRZI_HDM void close(int q) {
    R.f[q - 1] = (uint8_t)(fo | (zc_close(L, top, pend, thr, M) ? ZC_F_CONF : 0));
  }
  // bucket local q opens from its record (f, va, mq)
  NRZI_HDM void open(int q, uint8_t f, float va, uint32_t mq) {
    top = (f & ZC_F_TOP) != 0;
    const float own = top ? L.ct : L.cbm, opp = top ? L.cbm : L.ct;
    pend = (f & ZC_F_STRICT) && opp > ZC_PEAK;
    thr = fmaxf(fmaxf(own, va), ZC_PEAK);
    M = zc_u2f(mq);
    fo = (uint8_t)(f | (pend ? ZC_F_PEND : 0));
    R.v[q] = thr;
    R.f[q] = fo;
  }
};

NRZI_HD int zc_pass_b(ZcLane& L, const ZcRecs& R, int nev, int cap) {
  const int kc = L.kc;
  // events up to qe close buckets up to cap; up to qo also open one
  const int qe = nev < cap + 1 - kc ? nev : cap + 1 - kc;
  const int qo = qe < cap - kc ? qe : cap - kc;
  ZcPassB b{L, R, L.top, L.pend, L.thr, fmaxf(L.M, zc_u2f(R.m[0])), (uint8_t)0};
  if (kc >= 1 && kc <= cap) b.fo = (uint8_t)((b.top ? ZC_F_TOP : 0) | (b.pend ? ZC_F_PEND : 0));
  R.a[0] = L.a;
  R.v[0] = b.thr;
  R.j[0] = L.j;
  R.f[0] = b.fo;
  int q = 1;
  if (kc == 0 && qo >= 1) {                // the lane's first bucket: nothing to close
    b.open(1, R.f[1], R.v[1], R.m[1]);
    q = 2;
  }
  // the steady state, branch-free: each record loaded a step ahead of its
  // use (R has a spare entry past the last), so the chain waits on no load
  uint8_t fn = R.f[q];
  float vn = R.v[q];
  uint32_t mn = R.m[q];
  for (; q <= qo; ++q) {
    const uint8_t f = fn;
    const float va = vn;
    const uint32_t mq = mn;
    fn = R.f[q + 1];
    vn = R.v[q + 1];
    mn = R.m[q + 1];
    b.close(q);
    b.open(q, f, va, mq);
  }
  if (q <= qe) b.close(q);                 // the event past bucket cap closes it
  L.kc = kc + nev;
  if (L.kc >= 1 && L.kc <= cap) {
    if (nev > 0) L.a = R.a[nev];
    L.top = b.top;
    L.pend = b.pend;
    L.thr = b.thr;
    L.M = b.M;
  }
  return qe > 0 ? qe : 0;
}

// pass C: each armed bucket's first sample above its threshold
NRZI_HD void zc_t_pass_c(const ZcThread& t, const ZcRecs& R, int kc, int cap) {
  int n = t.e2.n, done = -1;
  NRZI_UNROLL
  for (int r = 0; r < ZC_R; ++r) {
    if (t.ev >> r & 1u) n += 1;
    const float am = fabsf(t.x[r]);
    const int q = n - kc;
    if (n >= 1 && n <= cap && q != done && am > ZC_PEAK && (R.f[q] & ZC_F_PEND) && am > R.v[q]) {
      zc_amin(&R.j[q], t.i0 + r);
      done = q;
    }
  }
}

// the list entry of bucket k (local q), closed in this chunk
NRZI_HD void zc_put_bucket(const ZcArgs& a, int lane, const ZcRecs& R, int q, int k) {
  const int A = R.a[q], j = R.j[q];
  const bool conf = (R.f[q] & ZC_F_CONF) != 0;
  zc_put(a, lane, k - 1, (float)A, conf, conf ? (float)(j - A) : 0.0f, conf ? j : a.S - 1,
         (R.f[q] & ZC_F_TOP) != 0, true);
}

// after pass C: the open bucket's confirmation sample so far (kc: the
// buckets opened before the chunk)
NRZI_HD void zc_lane_j(ZcLane& L, const ZcRecs& R, int kc, int cap) {
  if (L.kc >= 1 && L.kc <= cap) L.j = R.j[L.kc - kc];
}

// after the last chunk: the open bucket closes; returns the count
NRZI_HD int zc_finish(const ZcArgs& a, int lane, ZcLane& L) {
  if (L.kc >= 1 && L.kc <= a.cap) {
    const bool conf = zc_close(L, L.top, L.pend, L.thr, L.M);
    zc_put(a, lane, L.kc - 1, (float)L.a, conf, conf ? (float)(L.j - L.a) : 0.0f,
           conf ? L.j : a.S - 1, L.top, true);
  }
  return L.kc;
}

// ---------------------------------------------------------------------------
// Z1, differentiated variant (decoder.c:654-683 as gcr.zerocross_
// transitions computes it): a crossing (a nonzero sample of the other sign
// than the last nonzero one) fires iff a sample since the previous
// crossing (or the start) exceeded ZC_PEAK: iff the last att sample before
// it has the opposite sign and no sample of its own sign came after that
// one. Its time is zc_time_at. Past cap crossings the last one lands in
// slot cap - 1 (the JAX scatter's last write). No serial pass.
// ---------------------------------------------------------------------------

// round 2 of one thread: its kept crossings and their times; the thread
// holding sample S - 1 writes the unused slots' time and is_top, taken
// from the state before that sample
NRZI_HD ZcScan2 zc_t_diff2(ZcThread& t, int S, float* fill_t, int* fill_top) {
  ZcScan1 c = t.e1;
  ZcScan2 s = zc_scan2_id();
  t.ev = 0;
  NRZI_UNROLL
  for (int r = 0; r < ZC_R; ++r) {
    const int i = t.i0 + r, sg = zc_sign(t.x[r]);
    if (sg != 0 && c.la >= 0 && (sg > 0 ? c.lp : c.ln) < c.la) {
      t.ev |= 1u << r;
      t.tm[r] = zc_time_at(i, c.fz, c.lz);
      s.n += 1;
    }
    if (i == S - 1) {
      *fill_t = zc_time_at(i, c.fz, c.lz);
      *fill_top = sg > 0;
    }
    zc_add1(c, i, t.x[r]);
  }
  return s;
}

// one thread's kept crossings into their slots; total: the crossings
// kept up to the chunk's end (the chunk's last one alone writes slot
// cap - 1 once the list is full)
NRZI_HD void zc_t_diff_put(const ZcThread& t, const ZcArgs& a, int lane, int total) {
  int n = t.e2.n;
  NRZI_UNROLL
  for (int r = 0; r < ZC_R; ++r) {
    if (!(t.ev >> r & 1u)) continue;
    if (n < a.cap - 1 || n == total - 1)
      zc_put(a, lane, n < a.cap ? n : a.cap - 1, t.tm[r], true, 0.0f, t.i0 + r, t.x[r] > 0.0f,
             true);
    n += 1;
  }
}

// ---------------------------------------------------------------------------
// Z2: gcr.gcr_zeros_track_scan, one walker per (segment, parmset, track)
// over its track's list, staged a chunk at a time
// ---------------------------------------------------------------------------

// Z2's per-walker stamps (only when ZsArgs::stamps is set): the global
// timer (ns) and clock64() at the start and end of the block, the
// walker's cycles walking (the rest it waits at the chunk barriers), the
// entries it walked and the transitions it emitted
#define ZS_ST_G0 0
#define ZS_ST_C0 1
#define ZS_ST_C1 2
#define ZS_ST_G1 3
#define ZS_ST_WALK 4
#define ZS_ST_ENT 5
#define ZS_ST_STEPS 6
#define ZS_NSTAMP 7

#define ZS_F_VALID 1
#define ZS_F_OK 2

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
  int64_t* stamps;           // [B, P, T, ZS_NSTAMP] or null
  int32_t B, P, T, cap, maxb;
  int32_t ring;              // clock ring floats per walker: max clk_window (>= 1)
  float spb;
};

// entry o's flags, as the stager packs them
NRZI_HD uint8_t zs_flags(const ZsArgs& a, int64_t o) {
  return (uint8_t)((a.valid[o] ? ZS_F_VALID : 0) | (a.ok[o] ? ZS_F_OK : 0));
}

struct ZsWalker {
  GcrBits g;
  int cwin, peaks, n;        // n: entries walked
  float ca, z1, z2, padj;
  bool alive;                // no invalid entry yet (the valid ones are a prefix)
  int8_t* bits;
};

// walker p of track row = b * T + t; ring: a.ring floats of its own
NRZI_HD void zs_walker_init(ZsWalker& w, const ZsArgs& a, int row, int p, float* ring) {
  const int b = row / a.T, t = row % a.T;
  const float spb = a.spb;
  w.cwin = a.p_clk_window[p];
  w.ca = a.p_clk_alpha[p];
  w.z1 = a.p_z1pt[p];
  w.z2 = a.p_z2pt[p];
  w.padj = a.p_pulse_adj[p];
  w.g.clk.ring = ring;
  for (int k = 0; k < a.ring; ++k) ring[k] = spb;
  w.g.clk.ndx = 0;
  w.g.clk.avg = spb;
  w.g.t_pulse_adj = w.g.t_peakdelta = w.g.t_firstbit = w.g.t_lastbit = w.g.t_lastpeak = 0.0f;
  w.g.datablock = false;
  w.g.dc = w.g.lastbits = w.g.rsc = 0;
  w.peaks = w.n = 0;
  w.alive = true;
  w.bits = a.bits + (((int64_t)b * a.P + p) * a.T + t) * a.maxb;
}

// one staged chunk of n entries (t, dt, flags); the slope gate reads the
// live clock
NRZI_HD void zs_walk_chunk(ZsWalker& w, const float* et, const float* edt, const uint8_t* ef,
                           int n, float spb, int maxb) {
  for (int k = 0; k < n; ++k) {
    const uint8_t f = ef[k];
    if (!(f & ZS_F_VALID)) {
      w.alive = false;
      return;
    }
    w.n += 1;
    if (!(f & ZS_F_OK) || !(edt[k] <= w.g.clk.avg * ZC_SLOPE)) continue;
    int32_t wr[3];
    gcr_bit_step(w.g, et[k], w.z1, w.z2, w.padj, w.cwin, w.ca, spb, maxb, wr);
    for (int q = 0; q < 3; ++q)
      if (wr[q] < maxb) w.bits[wr[q]] = (int8_t)(q == 2);
    w.peaks += 1;
  }
}

NRZI_HD void zs_walker_finish(const ZsWalker& w, const ZsArgs& a, int row, int p) {
  const int b = row / a.T, t = row % a.T;
  const int64_t o = ((int64_t)b * a.P + p) * a.T + t;
  a.datacount[o] = w.g.dc;
  a.peakcount[o] = w.peaks;
  a.t_firstbit[o] = w.g.t_firstbit;
  a.t_lastbit[o] = w.g.t_lastbit;
}
