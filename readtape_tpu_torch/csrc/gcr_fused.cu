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
//
// What bounds it: serial latency in phase A (each track's admissions form
// a chain of dependent steps: the AGC, clock and pulse-adjust state of one
// admission set the thresholds of the next) and, in phase B, T * ECAP
// candidate entries per lane, each tested against every other track. The
// card's width is used only through the B * P blocks and the 128 threads
// of phases 0 and B. The design keeps it simple and exact, as pe_fused.cu:
//   phase 0  all threads: zero the lane's outputs and build its candidate
//            bitmask [T, S/32], masked to each track's own lead
//   phase A  one thread per track: walk the candidates, admit peaks, run
//            the GCR bit machine, append one record per admission and one
//            interval per idle stretch to device buffers (K >= max_steps)
//   phase B  all threads: the candidate entries split over the threads,
//            block-wide min -> tau
//   phase C  one thread per track: replay the records before tau into
//            bits, histogram and scalars; first candidate after tau
// Integer state stays integer; bits go straight to [B, P, T, maxb]. Built
// with --fmad=false, fmaf() only where the JAX package's XLA scans
// contract a multiply-add.
#include <cuda_runtime.h>

#include "gcr_core.h"

#define GCR_THREADS 128

__global__ void __launch_bounds__(GCR_THREADS) gcr_fused_kernel(GcrArgs a) {
  const int lane = blockIdx.x;
  const int nw = pe_nwords(a);
  __shared__ int tau_sh, after_sh;
  if (threadIdx.x == 0) {
    tau_sh = PE_BIG_TAU;
    after_sh = a.S;
  }
  gcr_zero_lane(a, lane, threadIdx.x, blockDim.x);
  uint32_t* cw = a.cand + (int64_t)lane * a.T * nw;
  for (int i = threadIdx.x; i < a.T * nw; i += blockDim.x)
    cw[i] = pe_cand_word(a, lane, i / nw, i % nw);
  __syncthreads();
  if (threadIdx.x < a.T) gcr_admit_track(a, lane, threadIdx.x);
  __syncthreads();
  bool overflow, deep;
  pe_lane_flags(a, lane, overflow, deep);
  if (!overflow) atomicMin(&tau_sh, pe_tau_part(a, lane, threadIdx.x, blockDim.x));
  __syncthreads();
  const int tau = overflow ? PE_BIG_TAU : tau_sh;
  if (threadIdx.x < a.T) atomicMin(&after_sh, gcr_apply_track(a, lane, threadIdx.x, tau));
  __syncthreads();
  if (threadIdx.x == 0) gcr_write_lane(a, lane, tau, overflow, after_sh);
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int gcr_fused_launch(const GcrArgs* a, void* stream) {
  if (a->T > NRZI_MAX_TRACKS || a->T > GCR_THREADS || a->K < a->max_steps)
    return (int)cudaErrorInvalidValue;
  gcr_fused_kernel<<<a->B * a->P, GCR_THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
