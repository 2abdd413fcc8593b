// ww_fused: the Whirlwind kernel for Hopper (sm_90a).
//
// Replaces readtape_tpu/decode/pallas_fused.py::ww_fused_scan (the TPU
// kernel `_ww_kernel`, read out by `ww_fused_state`): per-track peak
// admission with WW's AGC policy, the merge of every track's transitions in
// detection order, and the pulse/clock/blockmark machine with the skew
// histogram, for one whole tape under one parmset. It computes what the
// JAX package's XLA path (run_pass_single) computes, not the TPU kernel:
// no 2048-record block window and no bail, int32 positions with the
// XLA path's rolling integer base and int32 counters, and the XLA flush's
// end time for a tapemark at the end of the tape.
//
// What bounds it: serial latency. WW has one lane, not a batch of
// segments: each track's admissions form a chain of dependent steps (the
// AGC state of one sets the thresholds of the next), and the machine is
// one chain over every track's events in time order. Only candidacy is
// data-parallel. So the design is three launches on one stream:
//   ww_cand_kernel     grid-wide: the loose candidate bitmask [T, S/32],
//                      one 32-position word per thread
//   ww_admit_kernel    one block per track, one thread working: walk the
//                      candidates, admit peaks, append (s, frac, is_top)
//                      to the track's [K] records
//   ww_machine_kernel  one thread: T-way merge by (s, track), the machine
//                      per event, the trailing flush
// Built with --fmad=false, fmaf() only where the JAX package's XLA scans
// contract a multiply-add. Making it fast is later work: overlapping the
// merge with admission, or a warp-parallel merge.
#include <cuda_runtime.h>

#include "ww_core.h"

#define WW_CAND_THREADS 256

__global__ void __launch_bounds__(WW_CAND_THREADS) ww_cand_kernel(WwArgs a) {
  const int nw = ww_nwords(a);
  const int64_t n = (int64_t)a.T * nw;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    a.cand[i] = ww_cand_word(a, (int)(i / nw), (int)(i % nw));
}

__global__ void __launch_bounds__(32) ww_admit_kernel(WwArgs a) {
  if (threadIdx.x == 0) ww_admit_track(a, blockIdx.x);
}

__global__ void __launch_bounds__(32) ww_machine_kernel(WwArgs a) {
  if (threadIdx.x == 0) ww_machine(a);
}

// Launches the three kernels on `stream`; returns cudaGetLastError()
// (0 = launched).
extern "C" int ww_fused_launch(const WwArgs* a, void* stream) {
  if (a->T < 1 || a->T > WW_MAX_TRACKS || a->agc_window > WW_AGC_RING ||
      a->clk_window > WW_CLK_RING || a->K < 1 || a->S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t words = (int64_t)a->T * ww_nwords(*a);
  int64_t blocks = (words + WW_CAND_THREADS - 1) / WW_CAND_THREADS;
  if (blocks > 65535) blocks = 65535;
  ww_cand_kernel<<<(int)blocks, WW_CAND_THREADS, 0, st>>>(*a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ww_admit_kernel<<<a->T, 32, 0, st>>>(*a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ww_machine_kernel<<<1, 32, 0, st>>>(*a);
  return (int)cudaGetLastError();
}
