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
// What bounds it: serial latency in phase A (each track's admissions form
// a chain of dependent steps: the AGC and clock state of one admission set
// the thresholds of the next) and, in phase B, T * ECAP candidate entries
// per lane, each tested against every other track (T * log2(C) compares
// with the binary search below, T * C for pe_idle_tau's any-over-intervals).
// The card's width is used only through the B * P blocks and the 128
// threads of phases 0 and B. The design keeps it simple and exact:
//   phase 0  all threads: zero the lane's outputs and build its candidate
//            bitmask [T, S/32], masked to each track's own lead
//   phase A  one thread per track: walk the candidates, admit peaks, run
//            the PE state machine, append one record per admission and one
//            interval per idle stretch to device buffers (K >= max_steps
//            records, so nothing overflows or bails)
//   phase B  all threads: the candidate entries split over the threads,
//            block-wide min -> tau
//   phase C  one thread per track: replay the records before tau into
//            bits, fake runs, histogram and scalars; first candidates
//            after tau
// Integer state stays integer. Built with --fmad=false, fmaf() only where
// the JAX package's XLA scans contract a multiply-add.
//
// Making it fast is later work: several lanes per warp, tracks x parmsets
// across a warp, overlapping phase A of one lane with phase C of another.
#include <cuda_runtime.h>

#include "pe_core.h"

#define PE_THREADS 128

__global__ void __launch_bounds__(PE_THREADS) pe_fused_kernel(PeArgs a) {
  const int lane = blockIdx.x;
  const int nw = pe_nwords(a);
  __shared__ int tau_sh, after_sh, race_sh;
  if (threadIdx.x == 0) {
    tau_sh = PE_BIG_TAU;
    after_sh = a.S;
    race_sh = a.S;
  }
  pe_zero_lane(a, lane, threadIdx.x, blockDim.x);
  uint32_t* cw = a.cand + (int64_t)lane * a.T * nw;
  for (int i = threadIdx.x; i < a.T * nw; i += blockDim.x)
    cw[i] = pe_cand_word(a, lane, i / nw, i % nw);
  __syncthreads();
  if (threadIdx.x < a.T) pe_admit_track(a, lane, threadIdx.x);
  __syncthreads();
  bool overflow, deep;
  pe_lane_flags(a, lane, overflow, deep);
  if (!overflow) atomicMin(&tau_sh, pe_tau_part(a, lane, threadIdx.x, blockDim.x));
  __syncthreads();
  const int tau = overflow ? PE_BIG_TAU : tau_sh;
  if (threadIdx.x < a.T) {
    int ca, cr;
    pe_apply_track(a, lane, threadIdx.x, tau, ca, cr);
    atomicMin(&after_sh, ca);
    atomicMin(&race_sh, cr);
  }
  __syncthreads();
  if (threadIdx.x == 0) pe_write_lane(a, lane, tau, overflow, deep, after_sh, race_sh);
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int pe_fused_launch(const PeArgs* a, void* stream) {
  if (a->T > NRZI_MAX_TRACKS || a->T > PE_THREADS || a->K < a->max_steps)
    return (int)cudaErrorInvalidValue;
  pe_fused_kernel<<<a->B * a->P, PE_THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
