// pe_fused: the PE kernel for Hopper (sm_90a).
//
// Replaces readtape_tpu/decode/pallas_fused.py::pe_fused_scan (the TPU
// kernel `_pe_kernel`): PE peak admission with AGC, preamble and polarity
// detection, clock/data classification, fake-bit runs, the bit buffers,
// the peak histogram and the block scalars, for one (segment, parmset)
// lane per thread block. Unlike the TPU kernel it also computes what the
// JAX package's XLA path (_pe_segment_device) adds to that and the PE walk
// needs: each track's idle intervals, the lane's all-idle point tau, the
// records replayed only up to tau, and the first candidates after it.
//
// What bounds it: serial latency in phase A. Each track's admissions form
// a chain of dependent steps (the AGC and clock state of one admission set
// the thresholds of the next), one thread per track. What a chain reads
// does not depend on its state -- the samples, the candidate words, each
// candidate's window features -- so the threads that are not walking
// stage it into shared memory ahead of the walkers, and no step of a
// chain waits on device memory. The phases, one block of 512 threads per
// lane:
//   phase 0  all threads: zero the lane's outputs and build its candidate
//            bitmask [T, S/32], masked to each track's own lead, a warp
//            per 32-sample word (pe_cand_bit per lane, one ballot)
//   phase A  the walkers: one thread per track, each in a warp of its own
//            (two per warp beyond 12 tracks); the other warps stage the
//            lane in chunks of C samples (cp.async: each track's samples
//            with a W + 1 halo, its candidate words) and compute every
//            candidate's window features (the lane's one width W) into
//            one of two shared-memory slots, a chunk ahead. The walkers
//            run the PE state machine from shared memory, with their AGC
//            and clock rings there too, and append one record per
//            admission and one interval per idle stretch to device buffers
//            (K >= max_steps records, so nothing overflows or bails). The
//            tracks hand chunks over at a block barrier, which also ends
//            the phase once every track has stopped
//   phase B  all threads: the candidate entries split over the threads,
//            block-wide min -> tau
//   phase C  one thread per track: replay the records before tau into
//            bits, fake runs, histogram and scalars; first candidates
//            after tau
// Integer state stays integer. Built with --fmad=false, fmaf() only where
// the JAX package's XLA scans contract a multiply-add.
#include <cuda_runtime.h>

#include "pe_core.h"

#define PE_THREADS 512
#define PE_WALK_WARPS 12         // at most this many warps hold walkers
#define PE_CHUNK 256             // phase A: samples per chunk, at most
#define PE_SMEM_MAX 232448       // shared memory a block may use

// thread 0 stamps column k of the lane's phase clocks (breakdown only)
__device__ __forceinline__ void pe_stamp(const PeArgs& a, int lane, int k) {
  if (a.stamps && threadIdx.x == 0)
    a.stamps[(int64_t)lane * PE_NSTAMP + k] =
        k == PE_ST_G0 || k == PE_ST_G1 ? nrzi_gtimer() : clock64();
}

// phase A's shared memory at chunk C for T tracks, window widths <= Wmax:
// the staging and feature slots, each track's AGC and clock rings
static size_t pe_smem(int T, int C, int Wmax) {
  return nrzi_stage_smem(T, C, Wmax) +
         (size_t)T * (NRZI_MAX_AGC_RING + NRZI_MAX_CLK_RING) * 4;
}

__global__ void __launch_bounds__(PE_THREADS, 1) pe_fused_kernel(PeArgs a, int C) {
  extern __shared__ __align__(16) unsigned char pe_sm[];
  const int lane = blockIdx.x, tid = threadIdx.x;
  const int b = lane / a.P, p = lane % a.P, T = a.T, S = a.S, W = a.p_w[p];
  const int nw = pe_nwords(a);
  pe_stamp(a, lane, PE_ST_G0);
  pe_stamp(a, lane, PE_ST_C0);
  __shared__ int tau_sh, after_sh, race_sh;
  if (tid == 0) {
    tau_sh = PE_BIG_TAU;
    after_sh = S;
    race_sh = S;
  }
  pe_zero_lane(a, lane, tid, blockDim.x);
  // a warp per candidate word: lane l tests sample 32 w + l (coalesced)
  uint32_t* cw = a.cand + (int64_t)lane * T * nw;
  for (int q = tid >> 5; q < T * nw; q += blockDim.x >> 5) {
    const bool c = pe_cand_bit(a, lane, q / nw, ((q % nw) << 5) + (tid & 31));
    const unsigned word = __ballot_sync(0xffffffffu, c);
    if ((tid & 31) == 0) cw[q] = word;
  }
  __syncthreads();
  pe_stamp(a, lane, PE_ST_CZ);

  // ---- phase A ----
  const int nch = (S + C - 1) / C;
  // the walker of track t: lane t / nww of warp t % nww
  const int nww = T < PE_WALK_WARPS ? T : PE_WALK_WARPS;
  const int wt = (tid & 31) * nww + (tid >> 5);
  const int track = (tid >> 5) < nww && wt < T ? wt : -1;
  const int np = blockDim.x - 32 * nww, ptid = tid - 32 * nww;
  const bool stager = ptid >= 0;
  NrziStager sg;
  float* heights = (float*)sg.init(pe_sm, a.volts + (int64_t)b * T * S, cw, T, S, W, C,
                                   a.wmax, nw, ptid, np);   // [T][NRZI_MAX_AGC_RING]
  float* rings = heights + T * NRZI_MAX_AGC_RING;           // [T][NRZI_MAX_CLK_RING]

  PeWalk w;
  bool alive = track >= 0;
  long long walked = 0;                    // cycles spent walking
  if (stager)
    sg.prime(nch);
  else if (alive)
    pe_walk_init(w, a, lane, track, heights + track * NRZI_MAX_AGC_RING,
                 rings + track * NRZI_MAX_CLK_RING);
  __syncthreads();
  for (int i = 0; i < nch; ++i) {
    if (stager) {
      sg.advance(i, nch);
    } else if (alive) {
      const int c0 = i * C;
      const long long c = clock64();
      alive = pe_walk_chunk(w, a, sg.words(i, track), sg.feat(i, track), c0,
                            min(c0 + C, S));
      walked += clock64() - c;
    }
    if (!__syncthreads_or(alive)) break;
  }
  if (stager) nrzi_cp_wait();
  if (track >= 0) {
    pe_walk_finish(w, a, lane, track);
    if (a.stamps) {
      a.stamps[(int64_t)lane * PE_NSTAMP + PE_ST_WALK + track] = walked;
      a.stamps[(int64_t)lane * PE_NSTAMP + PE_ST_STEPS + track] = w.steps;
    }
  }
  __syncthreads();
  pe_stamp(a, lane, PE_ST_CA);

  // ---- phase B ----
  bool overflow, deep;
  pe_lane_flags(a, lane, overflow, deep);
  if (!overflow) atomicMin(&tau_sh, pe_tau_part(a, lane, tid, blockDim.x));
  __syncthreads();
  pe_stamp(a, lane, PE_ST_CB);

  // ---- phase C ----
  const int tau = overflow ? PE_BIG_TAU : tau_sh;
  if (tid < T) {
    int ca, cr;
    pe_apply_track(a, lane, tid, tau, ca, cr);
    atomicMin(&after_sh, ca);
    atomicMin(&race_sh, cr);
  }
  __syncthreads();
  pe_stamp(a, lane, PE_ST_CC);
  if (tid == 0) pe_write_lane(a, lane, tau, overflow, deep, after_sh, race_sh);
  pe_stamp(a, lane, PE_ST_G1);
}

// phase A's chunk: PE_CHUNK, halved until the shared memory fits
static int pe_chunk(int T, int Wmax) {
  int C = PE_CHUNK;
  while (C > 32 && pe_smem(T, C, Wmax) > PE_SMEM_MAX) C >>= 1;
  return pe_smem(T, C, Wmax) > PE_SMEM_MAX ? 0 : C;
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int pe_fused_launch(const PeArgs* a, void* stream) {
  if (a->T < 1 || a->T > NRZI_MAX_TRACKS || a->K < a->max_steps ||
      a->wmax < 1 || pe_chunk(a->T, a->wmax) == 0)
    return (int)cudaErrorInvalidValue;
  const int C = pe_chunk(a->T, a->wmax);
  const size_t smem = pe_smem(a->T, C, a->wmax);
  cudaError_t e = cudaFuncSetAttribute(
      pe_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  pe_fused_kernel<<<a->B * a->P, PE_THREADS, smem, (cudaStream_t)stream>>>(*a, C);
  return (int)cudaGetLastError();
}
