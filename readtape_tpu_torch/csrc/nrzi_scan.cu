// nrzi_scan: NRZI admission alone, for Hopper (sm_90a).
//
// Replaces readtape_tpu/decode/pallas_scan.py::nrzi_track_scan_pallas
// (B5a, TPU kernel `_kernel`: parmsets on sublanes, so parmsets of mixed
// window widths read their own feature group) and
// ::nrzi_track_scan_pallas_tracks (B5b, `_kernel_tracks`: tracks on
// sublanes, one shared window width): exact peak admission with AGC over
// precomputed window features and a masked jump table, for every
// (segment, parmset, track) lane, into [B, P, T, K] transition buffers.
// Unlike B1 no slot machine couples the tracks here, so every lane is
// independent.
//
// What bounds it: serial latency. A lane's steps form a dependent chain
// (the AGC state of one admission sets the thresholds of the next), and
// each step reads a 40-byte feature row and a jump-table entry at a
// data-dependent position. So no step reads device memory: the walks read
// chunks of the table staged in shared memory. The two entry points:
//   B5a  one block per (segment, track), with a walker for each of its
//        parmsets (up to NRZI_SCAN_MAX_WALK a block; more parmsets take
//        more blocks, the grid's y): they read the same jump table and at
//        most G feature groups, so two staging warps stage each chunk
//        once for all of them -- its entries by cp.async, its candidate
//        words by ballot, and the candidates' rows of each group its
//        walkers read by cp.async -- into one of two shared-memory slots,
//        a chunk ahead of the walks. Each walker is thread 0 of a warp of
//        its own, so walkers of different parmsets never diverge within a
//        warp; each keeps its own walk, AGC ring and step budget and
//        stops on its own, and the block goes on while any walker is
//        alive (nrzi_core.h nrzi_scan_chunk, the host build's twin too).
//        The walkers of a block meet at a barrier after every chunk, so
//        a chunk costs its slowest walker's time
//   B5b  one block per lane: thread 0 of warp 0 walks, warp 1 stages the
//        lane's table in chunks of C entries, a chunk ahead of the walk:
//        the chunk's jump-table entries by cp.async, its candidate words
//        by ballot (bit s: nxt[s] == s), and the feature rows of its
//        candidates only by cp.async, into one of two shared-memory
//        slots. The walk (nrzi_walk_chunk with NrziWalk, B1's step) reads
//        only shared memory; walker and stager hand chunks over at a
//        barrier of the block alone, so no lane waits for another
// Built with --fmad=false; the AGC's one fused multiply-add is an explicit
// fmaf().
//
// The wrapper (kernels.py) pre-fills the outputs with compact_outputs'
// fill; there is no step budget unless the caller passes one (density
// detection passes the JAX XLA scan's).
#include <cuda_runtime.h>

#include "nrzi_core.h"

#define SCANA_CHUNK 256          // B5a: table entries per chunk
#define SCANA_STAGE_WARPS 2      // B5a: staging warps per block
#define SCAN_CHUNK 256           // B5b: table entries per chunk
#define SCAN_THREADS 64          // B5b: the walker's warp, the staging warp
#define SCAN_MIN_BLOCKS 9        // B5b: blocks per SM (1,152 lanes, 132 SMs)

// cp.async of 8 bytes
__device__ __forceinline__ void scan_cp8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
               : "memory");
}

// B5b's staging of one lane's table (the staging threads ptid of np, whole
// warps): chunk i's jump-table entries into entry slot i & 1, then its
// candidate words and its candidates' feature rows into row slot i & 1
struct ScanStager {
  NrziTableSrc src;
  int32_t* ent;              // [2][C] staged jump-table entries
  uint32_t* wd;              // [2][CW] candidate words
  NrziTableRow* rows;        // [2][C] feature rows, at candidates only
  int S, C, CW, ptid, np;

  // the slots carved from sm; returns their end
  __device__ unsigned char* init(unsigned char* sm, const NrziTableSrc& src_, int C_,
                                 int ptid_, int np_) {
    src = src_;
    S = src.S;
    C = C_;
    CW = C >> 5;
    ptid = ptid_;
    np = np_;
    rows = (NrziTableRow*)sm;
    ent = (int32_t*)(rows + 2 * C);
    wd = (uint32_t*)(ent + 2 * C);
    return (unsigned char*)(wd + 2 * CW);
  }
  // entry slot i & 1 <- nxt[c0 .. c1)
  __device__ void stage(int i) const {
    const int c0 = i * C, c1 = min(c0 + C, S);
    int32_t* e = ent + (i & 1) * C;
    for (int s = c0 + ptid; s < c1; s += np) nrzi_cp4(e + (s - c0), src.nxt + s);
    nrzi_cp_commit();
  }
  // row slot i & 1 <- the words of chunk i, one ballot per word, and each
  // candidate's row (its lane copies it)
  __device__ void rows_of(int i) const {
    const int c0 = i * C, c1 = min(c0 + C, S), l = ptid & 31;
    const int32_t* e = ent + (i & 1) * C;
    uint32_t* w = wd + (i & 1) * CW;
    NrziTableRow* r = rows + (i & 1) * C;
    for (int q = ptid >> 5; q < CW; q += np >> 5) {
      const int s = c0 + (q << 5) + l;
      const bool c = s < c1 && e[s - c0] == s;
      const unsigned word = __ballot_sync(0xffffffffu, c);
      if (l == 0) w[q] = word;
      if (c)
        for (int k = 0; k < NRZI_NFEAT; k += 2) scan_cp8(&r[s - c0].r[k], &src.ft[s].r[k]);
    }
    nrzi_cp_commit();
  }
  // chunk i's rows, with chunk i + 1's entries on their way; returns once
  // chunk i's rows have landed
  __device__ void fill(int i, int nch) const {
    nrzi_cp_wait();                        // chunk i's entries
    nrzi_stage_sync(np);
    rows_of(i);
    if (i + 1 < nch) stage(i + 1);
    else nrzi_cp_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  }
  __device__ const uint32_t* words(int i) const { return wd + (i & 1) * CW; }
  __device__ const NrziTableRow* feat(int i) const { return rows + (i & 1) * C; }
};

static size_t scan_smem(int C) {
  return (size_t)C * 2 * (sizeof(NrziTableRow) + 4) + (size_t)(C / 32) * 2 * 4 +
         NRZI_MAX_AGC_RING * 4;
}

__global__ void __launch_bounds__(SCAN_THREADS, SCAN_MIN_BLOCKS)
    nrzi_scan_tracks_kernel(NrziScanArgs a, int C) {
  extern __shared__ __align__(16) unsigned char scan_sm[];
  const int lane = blockIdx.x, tid = threadIdx.x, S = a.S;
  int64_t* st = a.stamps && tid == 0 ? a.stamps + (int64_t)lane * SCAN_NSTAMP : 0;
  if (st) {
    st[SCAN_ST_G0] = nrzi_gtimer();
    st[SCAN_ST_C0] = clock64();
  }
  const int nch = (S + C - 1) / C;
  const bool stager = tid >= 32;
  ScanStager sg;
  float* heights = (float*)sg.init(scan_sm, nrzi_scan_src(a, lane), C, tid - 32,
                                   blockDim.x - 32);
  NrziWalk w;
  bool alive = tid == 0;
  long long walked = 0;                    // cycles spent walking
  if (stager) {
    sg.stage(0);
    if (nch > 0) sg.fill(0, nch);
  } else if (alive) {
    nrzi_scan_walk_init(w, a, lane, heights);
  }
  __syncthreads();
  for (int i = 0; i < nch; ++i) {
    if (stager) {
      if (i + 1 < nch) sg.fill(i + 1, nch);
    } else if (alive) {
      const int c0 = i * C;
      const long long c = clock64();
      alive = nrzi_walk_chunk(w, sg.words(i), sg.feat(i), c0, min(c0 + C, S), S,
                              a.max_steps);
      walked += clock64() - c;
    }
    if (!__syncthreads_or(alive)) break;
  }
  if (stager) nrzi_cp_wait();
  if (tid == 0) {
    nrzi_scan_walk_finish(w, a, lane);
    if (st) {
      st[SCAN_ST_C1] = clock64();
      st[SCAN_ST_G1] = nrzi_gtimer();
      st[SCAN_ST_WALK] = walked;
      st[SCAN_ST_STEPS] = w.steps;
    }
  }
}

// B5a's executor on the card (nrzi_core.h nrzi_scan_chunk): warps 0 ..
// pb - 1 walk (thread 0 of warp j runs walker j, where the block has it),
// the SCANA_STAGE_WARPS warps after them stage. Its members are __host__
// __device__ so that the step's template may call them; they do their
// work in the device build only
struct ScanCard {
  NrziScanWalker w;
  bool walker, stager, walked;   // walked: this walker walked this chunk
  int tid, n, warp, nwarp, lane; // staging thread tid of n, warp of nwarp
  template <class F> NRZI_HDM void stage(F f) {
    if (stager) f();
  }
  template <class F> NRZI_HDM void walk(F f) {
    walked = walker && w.alive;
    if (walked) {
      const long long c = nrzi_clock();
      f(w);
      w.walked += nrzi_clock() - c;
    }
  }
  NRZI_HDM bool any() {
#ifdef __CUDA_ARCH__
    const long long c = clock64();
    const bool r = __syncthreads_or(walker && w.alive);
    if (walked) w.waited += clock64() - c;
    walked = false;
    return r;
#else
    return false;
#endif
  }
  template <class F> NRZI_HDM uint32_t ballot(F f) const {
#ifdef __CUDA_ARCH__
    return __ballot_sync(0xffffffffu, f(lane));
#else
    return 0;
#endif
  }
  template <class F> NRZI_HDM void lanes(F f) const { f(lane); }
  NRZI_HDM void cp4(int32_t* d, const int32_t* s) const { nrzi_cp4(d, s); }
  NRZI_HDM void cp_row(NrziTableRow* d, const NrziTableRow* s) const {
#ifdef __CUDA_ARCH__
    for (int k = 0; k < NRZI_NFEAT; k += 2) scan_cp8(&d->r[k], &s->r[k]);
#endif
  }
  NRZI_HDM void commit() const {
#ifdef __CUDA_ARCH__
    nrzi_cp_commit();
#endif
  }
  // chunk i's entries, staged by every staging thread
  NRZI_HDM void wait_entries() const {
#ifdef __CUDA_ARCH__
    nrzi_cp_wait();
    nrzi_stage_sync(n);
#endif
  }
  // all but the last group: chunk i's rows, with chunk i + 1's entries
  // still on their way
  NRZI_HDM void wait_rows() const {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
  }
};

// B5a: block (row b*T + t, part y) of a grid (B*T, parts); pb parmsets a
// part, ng >= the groups any part reads
__global__ void __launch_bounds__((NRZI_SCAN_MAX_WALK + SCANA_STAGE_WARPS) * 32)
    nrzi_scan_kernel(NrziScanArgs a, int C, int pb, int ng) {
  extern __shared__ __align__(16) unsigned char scana_sm[];
  const int row = blockIdx.x, p0 = blockIdx.y * pb, tid = threadIdx.x, wp = tid >> 5;
  const int nw = min(pb, a.P - p0);
  ScanCard ex;
  ex.walker = wp < nw && (tid & 31) == 0;
  ex.stager = wp >= pb;
  ex.walked = false;
  ex.lane = tid & 31;
  ex.tid = tid - pb * 32;
  ex.n = blockDim.x - pb * 32;
  ex.warp = ex.tid >> 5;
  ex.nwarp = ex.n >> 5;
  float* heights;
  const NrziScanBlk k = nrzi_scan_blk(a, row, p0, nw, C, ng, scana_sm, &heights);
  int64_t* st = 0;
  if (ex.walker) {
    nrzi_scan_walker_init(ex.w, a, k, row, p0, wp, heights);
    if (a.stamps) {
      st = a.stamps + (int64_t)ex.w.lane * SCANA_NSTAMP;
      st[SCAN_ST_G0] = nrzi_gtimer();
      st[SCAN_ST_C0] = clock64();
    }
  }
  const int nch = (a.S + C - 1) / C;
  nrzi_scan_prime(ex, k, nch);
  for (int i = 0; i < nch; ++i)
    if (!nrzi_scan_chunk(ex, k, i, nch, a.max_steps)) break;
  if (ex.stager) nrzi_cp_wait();
  if (ex.walker) {
    nrzi_scan_walk_finish(ex.w.w, a, ex.w.lane);
    if (st) {
      st[SCAN_ST_C1] = clock64();
      st[SCAN_ST_G1] = nrzi_gtimer();
      st[SCAN_ST_WALK] = ex.w.walked;
      st[SCAN_ST_STEPS] = ex.w.w.steps;
      st[SCAN_ST_WAIT] = ex.w.waited;
    }
  }
}

// B5a: parmsets of any window widths (G feature groups). The block's
// shared memory (~64 KB at G = 3 and 8 parmsets, up to ~163 KB) is
// granted beyond the 48 KB default, or the launch fails. Launches on
// `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int nrzi_scan_launch(const NrziScanArgs* a, void* stream) {
  if (a->P < 1 || a->G < 1 || a->G > a->P || a->S < 1) return (int)cudaErrorInvalidValue;
  const int n = a->B * a->T;
  if (n <= 0) return 0;
  int pb;
  const int parts = nrzi_scan_parts(a->P, &pb);
  const int ng = a->G < pb ? a->G : pb;
  const size_t smem = nrzi_scan_blk_smem(SCANA_CHUNK, ng, pb);
  const cudaError_t e = cudaFuncSetAttribute(
      nrzi_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  nrzi_scan_kernel<<<dim3(n, parts), (pb + SCANA_STAGE_WARPS) * 32, smem,
                     (cudaStream_t)stream>>>(*a, SCANA_CHUNK, pb, ng);
  return (int)cudaGetLastError();
}

// B5b: every parmset shares one window width (G = 1); a block per lane
extern "C" int nrzi_scan_tracks_launch(const NrziScanArgs* a, void* stream) {
  if (a->G != 1) return (int)cudaErrorInvalidValue;
  const int n = a->B * a->P * a->T;
  if (n <= 0) return 0;
  nrzi_scan_tracks_kernel<<<n, SCAN_THREADS, scan_smem(SCAN_CHUNK),
                            (cudaStream_t)stream>>>(*a, SCAN_CHUNK);
  return (int)cudaGetLastError();
}
