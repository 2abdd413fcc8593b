// nrzi_fused: the NRZI main-path kernel for Hopper (sm_90a).
//
// Replaces readtape_tpu/decode/pallas_fused.py::nrzi_fused_scan (the TPU
// kernel `_kernel`, read out by `fused_state`): loose candidacy, exact
// peak admission with AGC, the global bit-slot machine with -correct, the
// bit buffers, the peak histogram and the block scalars, for one
// (segment, parmset) lane per thread block.
//
// What bounds it: serial latency. Each track's admission is a chain of
// dependent steps (the AGC state of one admission sets the thresholds of
// the next), and the slot machine couples all tracks of a lane, one slot
// after another. What a chain reads does not depend on its state, so the
// design keeps every chain off device memory. One block of 512 threads
// per lane:
//   phase 0  all threads: zero the lane's outputs and build its candidate
//            bitmask [T, S/32], a warp per 32-sample word (nrzi_cand_bit
//            per lane, one ballot)
//   phase A  the walkers: one thread per track, each in a warp of its own
//            (two per warp beyond 12 tracks); the other warps stage the
//            lane in chunks of C samples (cp.async: each track's samples
//            with a W + 1 halo, its candidate words) and compute every
//            candidate's window features (the lane's width W) into one of
//            two shared-memory slots, a chunk ahead. The walkers run the
//            admission step (NrziWalk::admit, B5's too) from shared memory,
//            with their AGC windows there, and append (s, t_peak, agc) to
//            the lane's [T, K] buffers in device memory (an overflow keeps
//            the last in K-1, so nothing ever bails). The tracks hand
//            chunks over at a block barrier, which also ends the phase
//            once every track has stopped
//   phase B  warp 0: the slot machine (nrzi_core.h nrzi_slot_warp, B6's
//            too) over those buffers, track t on thread t, the buffers
//            streamed into shared-memory rings ahead of each track's cursor
// Integer state stays integer. Built with --fmad=false: the reference's
// a*x + (1-a)*y updates must round twice, not once as an FMA would.
#include <cuda_runtime.h>

#include "nrzi_core.h"

#define NRZI_THREADS 512
#define NRZI_WALK_WARPS 12       // at most this many warps hold walkers
#define NRZI_CHUNK 256           // phase A: samples per chunk, at most
#define NRZI_SMEM_MAX 232448     // shared memory a block may use

// phase A's shared memory at chunk C for T tracks, window widths <= Wmax:
// the staging and feature slots, each track's AGC window; phase B reuses it
static size_t nrzi_smem(int T, int C, int Wmax) {
  const size_t walk = nrzi_stage_smem(T, C, Wmax) + (size_t)T * NRZI_MAX_AGC_RING * 4;
  const size_t slot = nrzi_slot_smem(T);
  return walk > slot ? walk : slot;
}

__global__ void __launch_bounds__(NRZI_THREADS, 1) nrzi_fused_kernel(NrziArgs a, int C) {
  extern __shared__ __align__(16) unsigned char nrzi_sm[];
  const int lane = blockIdx.x, tid = threadIdx.x;
  const int b = lane / a.P, p = lane % a.P, T = a.T, S = a.S, W = a.p_w[p];
  const int nw = nrzi_nwords(a);
  int64_t* st = a.stamps && tid == 0 ? a.stamps + (int64_t)lane * NRZI_NSTAMP : 0;
  if (st) {
    st[NRZI_ST_G0] = nrzi_gtimer();
    st[NRZI_ST_C0] = clock64();
  }

  // ---- phase 0 ----
  nrzi_zero_lane(a, lane, tid, blockDim.x);
  // a warp per candidate word: lane l tests sample 32 w + l (coalesced)
  uint32_t* cw = a.cand + (int64_t)lane * T * nw;
  for (int q = tid >> 5; q < T * nw; q += blockDim.x >> 5) {
    const bool c = nrzi_cand_bit(a, lane, q / nw, ((q % nw) << 5) + (tid & 31));
    const unsigned word = __ballot_sync(0xffffffffu, c);
    if ((tid & 31) == 0) cw[q] = word;
  }
  __syncthreads();
  if (st) st[NRZI_ST_CZ] = clock64();

  // ---- phase A ----
  const int nch = (S + C - 1) / C;
  // the walker of track t: lane t / nww of warp t % nww
  const int nww = T < NRZI_WALK_WARPS ? T : NRZI_WALK_WARPS;
  const int wt = (tid & 31) * nww + (tid >> 5);
  const int track = (tid >> 5) < nww && wt < T ? wt : -1;
  const int np = blockDim.x - 32 * nww, ptid = tid - 32 * nww;
  const bool stager = ptid >= 0;
  NrziStager sg;
  float* heights = (float*)sg.init(nrzi_sm, a.volts + (int64_t)b * T * S, cw, T, S, W,
                                   C, a.wmax, nw, ptid, np);   // [T][NRZI_MAX_AGC_RING]

  NrziWalk w;
  bool alive = track >= 0;
  long long walked = 0;                    // cycles spent walking
  if (stager) sg.prime(nch);
  else if (alive) nrzi_fused_walk_init(w, a, lane, track, heights + track * NRZI_MAX_AGC_RING);
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
    nrzi_fused_walk_finish(w, a, lane, track);
    if (a.stamps) a.stamps[(int64_t)lane * NRZI_NSTAMP + NRZI_ST_WALK + track] = walked;
  }
  __syncthreads();
  if (st) st[NRZI_ST_CA] = clock64();

  // ---- phase B ----
  if (tid < 32)
    nrzi_slot_warp(nrzi_slot_lane_of(a, lane), nrzi_sm, st ? st + NRZI_ST_MACH : 0);
  if (st) {
    st[NRZI_ST_CB] = clock64();
    st[NRZI_ST_G1] = nrzi_gtimer();
  }
}

// phase A's chunk: NRZI_CHUNK, halved until the shared memory fits
static int nrzi_chunk(int T, int Wmax) {
  int C = NRZI_CHUNK;
  while (C > 32 && nrzi_smem(T, C, Wmax) > NRZI_SMEM_MAX) C >>= 1;
  return nrzi_smem(T, C, Wmax) > NRZI_SMEM_MAX ? 0 : C;
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int nrzi_fused_launch(const NrziArgs* a, void* stream) {
  if (a->T < 1 || a->T > NRZI_MAX_TRACKS || a->K < 1 || a->wmax < 1 ||
      nrzi_chunk(a->T, a->wmax) == 0)
    return (int)cudaErrorInvalidValue;
  const int C = nrzi_chunk(a->T, a->wmax);
  const size_t smem = nrzi_smem(a->T, C, a->wmax);
  cudaError_t e = cudaFuncSetAttribute(
      nrzi_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  nrzi_fused_kernel<<<a->B * a->P, NRZI_THREADS, smem, (cudaStream_t)stream>>>(*a, C);
  return (int)cudaGetLastError();
}
