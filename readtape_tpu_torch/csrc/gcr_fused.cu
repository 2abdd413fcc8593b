// gcr_fused: the GCR kernel for Hopper (sm_90a).
//
// Replaces readtape_tpu/decode/pallas_fused.py::gcr_fused_scan (the TPU
// kernel `_gcr_kernel`): GCR peak admission with AGC, zero inference from
// the peak spacing, pulse adjustment, clock tracking and resync, the bit
// buffers, the peak histogram and the per-track scalars, for one
// (segment, parmset) lane per thread block. Like the PE kernel it also
// computes what the JAX package's XLA path (_gcr_segment_device) adds and
// the multi-block rounds need: each track's idle intervals, the lane's
// all-idle point tau, the records replayed only up to tau, and the first
// candidate after it. The group-level postprocess (5-bit groups, ECC,
// -correct) stays outside, in PyTorch (decode/gcr.py::gcr_finish).
// With GcrArgs::dbg_f set (-trace's record mode, pe_core.h) it runs the
// JAX trace's scan instead and writes each admission's row of the trace.
//
// What bounds it: serial latency in phase A. Each track's admissions form
// a chain of dependent steps (the AGC, clock and pulse-adjust state of one
// admission set the thresholds of the next), one thread per track. What a
// chain reads does not depend on its state -- the samples, the candidate
// words, each candidate's window features -- so, as in pe_fused.cu, the
// threads that are not walking stage it into shared memory ahead of the
// walkers, and no step of a chain waits on device memory. The phases, one
// block of 512 threads per lane:
//   phase 0  all threads: zero the lane's outputs and build its candidate
//            bitmask [T, S/32], masked to each track's own lead, a warp
//            per 32-sample word (pe_cand_bit per lane, one ballot)
//   phase A  the walkers: one thread per track, each in a warp of its own
//            (two per warp beyond 12 tracks); the other warps stage the
//            lane in chunks of C samples (NrziStager: cp.async of each
//            track's samples with a W + 1 halo and its candidate words,
//            then every candidate's window features for the lane's width
//            W) into one of two shared-memory slots, a chunk ahead. The
//            walkers run GcrWalk::admit (the admission test and AGC policy
//            of nrzi_core.h, then the GCR bit machine) from shared memory,
//            with their AGC and clock rings there too, and append one
//            record per admission and one interval per idle stretch to
//            device buffers (K >= max_steps). The tracks hand chunks over
//            at a block barrier, which also ends the phase once every
//            track has stopped
//   phase B  all threads: the candidate entries split over the threads,
//            block-wide min -> tau
//   phase C  one thread per track: replay the records before tau into
//            bits, histogram and scalars; first candidate after tau
// Integer state stays integer; bits go straight to [B, P, T, maxb]. Built
// with --fmad=false, fmaf() only where the JAX package's XLA scans
// contract a multiply-add.
#include <cuda_runtime.h>

#include "gcr_core.h"

// REC: the record mode (dbg_f set), its own instantiation, so that the
// decode's kernel carries none of it
template <bool REC>
__global__ void __launch_bounds__(PE_THREADS, 1) gcr_fused_kernel(GcrArgs a, int C) {
  extern __shared__ __align__(16) unsigned char gcr_sm[];
  const int lane = blockIdx.x, tid = threadIdx.x;
  const int T = a.T, S = a.S;
  pe_stamp(a, lane, PE_ST_G0);
  pe_stamp(a, lane, PE_ST_C0);
  __shared__ int tau_sh, after_sh;
  if (tid == 0) {
    tau_sh = PE_BIG_TAU;
    after_sh = S;
  }
  gcr_zero_lane(a, lane, tid, blockDim.x);
  uint32_t* cw = a.cand + (int64_t)lane * T * pe_nwords(a);
  pe_cand_words<REC>(a, lane, cw);
  __syncthreads();
  pe_stamp(a, lane, PE_ST_CZ);

  // ---- phase A ----
  pe_phase_a<GcrWalkT<REC>>(
      a, lane, cw, gcr_sm, C,
      [&](GcrWalkT<REC>& w, int t, float* heights, float* ring) {
        gcr_walk_init(w, a, lane, t, heights, ring);
      },
      [&](const GcrWalkT<REC>& w, int t) { gcr_walk_finish(w, a, lane, t); });
  pe_stamp(a, lane, PE_ST_CA);

  // ---- phase B ----
  bool overflow, deep;
  pe_lane_flags(a, lane, overflow, deep);
  if (!overflow) atomicMin(&tau_sh, pe_tau_part(a, lane, tid, blockDim.x));
  __syncthreads();
  pe_stamp(a, lane, PE_ST_CB);

  // ---- phase C ----
  const int tau = overflow ? PE_BIG_TAU : tau_sh;
  if (tid < T) atomicMin(&after_sh, gcr_apply_track<REC>(a, lane, tid, tau));
  __syncthreads();
  pe_stamp(a, lane, PE_ST_CC);
  if (tid == 0) gcr_write_lane(a, lane, tau, overflow, after_sh);
  pe_stamp(a, lane, PE_ST_G1);
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int gcr_fused_launch(const GcrArgs* a, void* stream) {
  if (a->T < 1 || a->T > NRZI_MAX_TRACKS || a->K < a->max_steps || a->wmax < 1 ||
      pe_chunk(a->T, a->wmax) == 0)
    return (int)cudaErrorInvalidValue;
  const int C = pe_chunk(a->T, a->wmax);
  const size_t smem = pe_smem(a->T, C, a->wmax);
  // the record mode's instantiation, or the decode's
  void (*kernel)(GcrArgs, int) = a->dbg_f ? gcr_fused_kernel<true> : gcr_fused_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<a->B * a->P, PE_THREADS, smem, (cudaStream_t)stream>>>(*a, C);
  return (int)cudaGetLastError();
}
