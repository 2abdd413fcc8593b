// zeros: the -zeros kernels for Hopper (sm_90a).
//
// The JAX package computes -zeros with XLA, outside any Pallas kernel, so
// these replace no TPU kernel: Z1 replaces
// readtape_tpu/decode/gcr.py::zerocross_transitions (associative scans and
// a serial lax.scan over each track's significant phases) and Z2
// gcr.py::gcr_zeros_track_scan (a lax.scan over each track's transition
// list). In PyTorch each serial scan would be a Python loop of thousands
// of steps, each launching tens of small kernels.
//
// Z1: one block of ZC_THREADS threads per (segment, track) lane, over the
// lane's samples a chunk of ZC_CHUNK at a time, ZC_R consecutive samples
// per thread; every thread stages the next chunk by cp.async while the
// block works on this one. Per chunk (zeros_core.h): two exclusive block
// scans (warp shuffles, then the warps' totals, with the lane's carry)
// give every sample the reference walk's state. Plain variant: pass A
// writes each significant phase's bucket record and its samples' share of
// the bucket maximum (shared-memory atomicMax); pass B, thread 0 alone,
// steps over the chunk's buckets, the only serial chain (the carried
// extrema), each record loaded a step ahead; pass C finds each armed
// bucket's confirmation sample (atomicMin) and the block writes the
// entries of the buckets that closed. The differentiated variant has no
// serial pass: its crossings, their times and slots come out of the two
// scans. At the end the block fills the unused list slots. Registers are
// capped so that ZC_MIN_BLOCKS blocks share an SM (the GCR -zeros bench's
// 360 lanes in one wave). What bounds it: the f32 window read once and
// the lists written once (~30 us at B = 40, T = 9, S = 32768); what the
// card spends is pass B's chain, one step per significant phase (~1,300
// a track on the GCR bench), and each chunk's scans and barriers.
//
// Z2: one block per (segment, track), B * T blocks, its P parmset walkers
// one per warp (lane 0; walker p on warp p % nww, lane p / nww when
// P > ZS_MAX_WALK), with ZS_STAGE_WARPS warps staging the track's list
// (t, dt by cp.async; ok and valid packed into one flag byte) a chunk
// ahead into shared memory; each walker's clock ring is in shared memory,
// and it writes its bits straight to [B, P, T, maxb], which no list read
// can alias. What bounds it: the chain of admitted transitions per
// walker, gcr_core.h's gcr_bit_step.
//
// Built with --fmad=false; fmaf() only where gcr_core.h has it.
#include <cuda_runtime.h>

#include "nrzi_core.h"
#include "zeros_core.h"

#define ZC_THREADS 256
#define ZC_WARPS (ZC_THREADS / 32)
#define ZC_CHUNK (ZC_THREADS * ZC_R)
#define ZC_MIN_BLOCKS 3          // B = 40, T = 9: 360 lanes in one wave
#define ZS_CHUNK 1024
#define ZS_STAGE_WARPS 2
#define ZS_MAX_WALK 30

// x from the lane d below (d < 32), field by field
template <class T>
__device__ __forceinline__ T zc_shfl_up(const T& x, int d) {
  static_assert(sizeof(T) % 4 == 0, "ints only");
  T y;
  const int* xs = reinterpret_cast<const int*>(&x);
  int* ys = reinterpret_cast<int*>(&y);
#pragma unroll
  for (int w = 0; w < (int)(sizeof(T) / 4); ++w) ys[w] = __shfl_up_sync(0xffffffffu, xs[w], d);
  return y;
}

// The exclusive scan of x over the block's threads in order, after
// `carry` (the lane's samples before the chunk); carry becomes the
// chunk's inclusive total. tot: ZC_WARPS entries of shared memory, not
// read again before the caller's next barrier. One barrier.
template <class T>
__device__ __forceinline__ T zc_block_exscan(const T& x, T& carry, T* tot) {
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
  T inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = zc_shfl_up(inc, d);
    if (l >= d) inc = zc_comb(y, inc);
  }
  const T exc = zc_shfl_up(inc, 1);
  if (l == 31) tot[w] = inc;
  __syncthreads();
  T pre = carry;
  for (int q = 0; q < w; ++q) pre = zc_comb(pre, tot[q]);
  T all = pre;
  for (int q = w; q < ZC_WARPS; ++q) all = zc_comb(all, tot[q]);
  carry = all;
  return l > 0 ? zc_comb(pre, exc) : pre;
}

static size_t zc_smem(bool diff) {
  return 2 * (size_t)ZC_CHUNK * 4 + (diff ? 0 : (size_t)(ZC_CHUNK + 2) * (4 + 4 + 4 + 4 + 1));
}

template <bool DIFF>
__global__ void __launch_bounds__(ZC_THREADS, ZC_MIN_BLOCKS) zc_kernel(ZcArgs a) {
  extern __shared__ __align__(16) unsigned char zc_sm[];
  __shared__ ZcScan1 tot1[ZC_WARPS];
  __shared__ ZcScan2 tot2[ZC_WARPS];
  __shared__ float fill_t;
  __shared__ int fill_top;
  float* buf = (float*)zc_sm;              // [2][ZC_CHUNK] staged samples
  ZcRecs R;
  R.a = (int32_t*)(buf + 2 * ZC_CHUNK);
  R.v = (float*)(R.a + ZC_CHUNK + 2);
  R.m = (uint32_t*)(R.v + ZC_CHUNK + 2);
  R.j = (int32_t*)(R.m + ZC_CHUNK + 2);
  R.f = (uint8_t*)(R.j + ZC_CHUNK + 2);
  const int lane = blockIdx.x, b = lane / a.T, tid = threadIdx.x, S = a.S, cap = a.cap;
  int64_t* st = a.stamps && tid == 0 ? a.stamps + (int64_t)lane * ZC_NSTAMP : 0;
  if (st) {
    st[ZC_ST_G0] = nrzi_gtimer();
    st[ZC_ST_C0] = clock64();
  }
  const float* v = a.volts + (int64_t)lane * S;
  const int lo = a.lead[b], hi = a.seg_len[b];
  const int nch = (S + ZC_CHUNK - 1) / ZC_CHUNK;
  auto stage = [&](int i) {
    const int c0 = i * ZC_CHUNK, n = min(ZC_CHUNK, S - c0);
    float* d = buf + (i & 1) * ZC_CHUNK;
    for (int q = tid; q < n; q += ZC_THREADS) nrzi_cp4(d + q, v + c0 + q);
    nrzi_cp_commit();
  };
  ZcScan1 c1 = zc_scan1_id();
  ZcScan2 c2 = zc_scan2_id();
  ZcLane L;
  zc_lane_init(L);
  long long cyc_a = 0, cyc_b = 0, cyc_c = 0;
  int nb = 0;
  stage(0);
  for (int i = 0; i < nch; ++i) {
    const int c0 = i * ZC_CHUNK, i0 = c0 + tid * ZC_R, kc = c2.n;
    const float* chunk = buf + (i & 1) * ZC_CHUNK;
    nrzi_cp_wait();
    __syncthreads();                       // chunk i staged; chunk i - 1 done with
    const long long t0 = st ? clock64() : 0;
    if (i + 1 < nch) stage(i + 1);
    if (!DIFF)
      for (int q = tid; q <= ZC_CHUNK; q += ZC_THREADS) {
        R.m[q] = 0u;
        R.j[q] = ZC_NONE;
      }
    ZcThread th;
    {
      float raw[ZC_R];
      const float4* x4 = reinterpret_cast<const float4*>(chunk + tid * ZC_R);
#pragma unroll
      for (int r = 0; r < ZC_R / 4; ++r) {
        const float4 q = x4[r];
        raw[4 * r] = q.x;
        raw[4 * r + 1] = q.y;
        raw[4 * r + 2] = q.z;
        raw[4 * r + 3] = q.w;
      }
      zc_t_load(th, raw, i0, lo, hi, S);
    }
    th.e1 = zc_block_exscan(zc_t_sum1(th), c1, tot1);
    if (DIFF) {
      th.e2 = zc_block_exscan(zc_t_diff2(th, S, &fill_t, &fill_top), c2, tot2);
      zc_t_diff_put(th, a, lane, c2.n);
      if (st) cyc_a += clock64() - t0;
      continue;
    }
    th.e2 = zc_block_exscan(zc_t_plain2(th), c2, tot2);
    zc_t_records(th, R, kc, cap);
    const int nev = c2.n - kc;
    __syncthreads();                       // records and maxima complete
    const long long t1 = st ? clock64() : 0;
    if (tid == 0) nb += zc_pass_b(L, R, nev, cap);
    __syncthreads();                       // thresholds and flags
    const long long t2 = st ? clock64() : 0;
    zc_t_pass_c(th, R, kc, cap);
    __syncthreads();                       // confirmation samples
    for (int k = max(kc, 1) + tid; k <= min(kc + nev - 1, cap); k += ZC_THREADS)
      zc_put_bucket(a, lane, R, k - kc, k);
    if (tid == 0) zc_lane_j(L, R, kc, cap);
    if (st) {
      cyc_a += t1 - t0;
      cyc_b += t2 - t1;
      cyc_c += clock64() - t2;
    }
  }
  __syncthreads();
  const int n = DIFF ? c2.n : (tid == 0 ? zc_finish(a, lane, L) : c2.n);
  if (tid == 0) a.n_found[lane] = n;
  zc_fill(a, lane, n, DIFF ? fill_t : (float)S, DIFF ? fill_top != 0 : false, tid, ZC_THREADS);
  if (st) {
    st[ZC_ST_A] = cyc_a;
    st[ZC_ST_B] = cyc_b;
    st[ZC_ST_C] = cyc_c;
    st[ZC_ST_NB] = nb;
    st[ZC_ST_C1] = clock64();
    st[ZC_ST_G1] = nrzi_gtimer();
  }
}

static size_t zs_smem(int P, int ring) {
  return 2 * (size_t)ZS_CHUNK * (4 + 4 + 1) + (size_t)P * ring * 4;
}

__global__ void __launch_bounds__(1024) zs_kernel(ZsArgs a, int nww) {
  extern __shared__ __align__(16) unsigned char zs_sm[];
  float* et = (float*)zs_sm;               // [2][ZS_CHUNK] t
  float* edt = et + 2 * ZS_CHUNK;          // [2][ZS_CHUNK] dt
  float* rings = edt + 2 * ZS_CHUNK;       // [P][ring]
  uint8_t* ef = (uint8_t*)(rings + a.P * a.ring);   // [2][ZS_CHUNK] ZS_F_*
  const int row = blockIdx.x, tid = threadIdx.x, wp = tid >> 5, l = tid & 31;
  const int b = row / a.T, t = row % a.T;
  const int64_t base = (int64_t)row * a.cap;
  const int nch = (a.cap + ZS_CHUNK - 1) / ZS_CHUNK;
  const bool stager = wp >= nww;
  const int ptid = tid - nww * 32, np = ZS_STAGE_WARPS * 32, p = l * nww + wp;
  const bool walker = !stager && p < a.P;
  int64_t* st = a.stamps && walker ? a.stamps + (((int64_t)b * a.P + p) * a.T + t) * ZS_NSTAMP : 0;
  if (st) {
    st[ZS_ST_G0] = nrzi_gtimer();
    st[ZS_ST_C0] = clock64();
  }
  auto stage = [&](int i) {
    const int c0 = i * ZS_CHUNK, n = min(ZS_CHUNK, a.cap - c0), s = (i & 1) * ZS_CHUNK;
    for (int q = ptid; q < n; q += np) {
      nrzi_cp4(et + s + q, a.t + base + c0 + q);
      nrzi_cp4(edt + s + q, a.dt + base + c0 + q);
      ef[s + q] = zs_flags(a, base + c0 + q);
    }
    nrzi_cp_commit();
  };
  ZsWalker w;
  if (walker) zs_walker_init(w, a, row, p, rings + p * a.ring);
  if (stager) {
    stage(0);
    nrzi_cp_wait();
  }
  __syncthreads();
  bool alive = walker;
  long long walked = 0;
  for (int i = 0; i < nch; ++i) {
    if (stager && i + 1 < nch) stage(i + 1);
    if (alive) {
      const int s = (i & 1) * ZS_CHUNK;
      const long long c = clock64();
      zs_walk_chunk(w, et + s, edt + s, ef + s, min(ZS_CHUNK, a.cap - i * ZS_CHUNK), a.spb,
                    a.maxb);
      alive = w.alive;
      walked += clock64() - c;
    }
    if (stager) nrzi_cp_wait();
    if (!__syncthreads_or(alive)) break;
  }
  if (walker) {
    zs_walker_finish(w, a, row, p);
    if (st) {
      st[ZS_ST_WALK] = walked;
      st[ZS_ST_ENT] = w.n;
      st[ZS_ST_STEPS] = w.peaks;
      st[ZS_ST_C1] = clock64();
      st[ZS_ST_G1] = nrzi_gtimer();
    }
  }
}

// the dynamic shared memory a kernel may take beyond 48 KB
template <class K>
static int zeros_smem_attr(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// Launch on `stream`; each returns cudaGetLastError() (0 = launched).
extern "C" int zerocross_launch(const ZcArgs* a, void* stream) {
  if (a->cap < 1 || a->S < 1) return (int)cudaErrorInvalidValue;
  const int n = a->B * a->T;
  if (n <= 0) return 0;
  const size_t smem = zc_smem(a->diff != 0);
  int rc;
  if (a->diff) {
    if ((rc = zeros_smem_attr(zc_kernel<true>, smem))) return rc;
    zc_kernel<true><<<n, ZC_THREADS, smem, (cudaStream_t)stream>>>(*a);
  } else {
    if ((rc = zeros_smem_attr(zc_kernel<false>, smem))) return rc;
    zc_kernel<false><<<n, ZC_THREADS, smem, (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}

extern "C" int gcr_zeros_launch(const ZsArgs* a, void* stream) {
  if (a->cap < 1 || a->maxb < 1 || a->P < 1 || a->ring < 1 || a->ring > NRZI_MAX_CLK_RING)
    return (int)cudaErrorInvalidValue;
  const int n = a->B * a->T;
  if (n <= 0) return 0;
  const int nww = a->P < ZS_MAX_WALK ? a->P : ZS_MAX_WALK;
  const size_t smem = zs_smem(a->P, a->ring);
  int rc;
  if ((rc = zeros_smem_attr(zs_kernel, smem))) return rc;
  zs_kernel<<<n, (nww + ZS_STAGE_WARPS) * 32, smem, (cudaStream_t)stream>>>(*a, nww);
  return (int)cudaGetLastError();
}
