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
// Z1: one block of 64 threads per (segment, track) lane. Thread 0 walks the
// lane's samples once (zeros_core.h ZcPlain or ZcDiff) and writes each
// transition when it is settled; warp 1 stages the samples a chunk ahead
// into one of two shared-memory slots by cp.async, so the walk never waits
// on device memory; at the end the block fills the unused list slots.
// What bounds it: the walk, one dependent chain of S steps per lane (the
// bytes, the f32 window read once, would take ~14 us at B = 40, T = 9,
// S = 32768 over 3.35 TB/s).
//
// Z2: one thread per (segment, parmset, track) lane, walking its track's
// list with gcr_core.h's gcr_bit_step and writing the bits in place (the
// wrapper zeroes them). What bounds it: the chain of admitted transitions
// per lane; each step reads one list entry (cached: the P lanes of a
// track share it).
//
// Built with --fmad=false; fmaf() only where gcr_core.h has it.
#include <cuda_runtime.h>

#include "nrzi_core.h"
#include "zeros_core.h"

#define ZC_THREADS 64
#define ZC_CHUNK 4096
#define ZS_THREADS 128

template <class Walk>
__global__ void __launch_bounds__(ZC_THREADS) zc_kernel(ZcArgs a) {
  __shared__ __align__(16) float buf[2][ZC_CHUNK];
  __shared__ int n_sh;
  __shared__ bool top_sh;
  __shared__ float t_sh;
  const int lane = blockIdx.x, b = lane / a.T, tid = threadIdx.x, S = a.S;
  const float* v = a.volts + (int64_t)lane * S;
  const int nch = (S + ZC_CHUNK - 1) / ZC_CHUNK;
  const bool stager = tid >= 32;
  auto stage = [&](int i) {
    const int c0 = i * ZC_CHUNK, n = min(ZC_CHUNK, S - c0);
    for (int q = tid - 32; q < n; q += ZC_THREADS - 32) nrzi_cp4(&buf[i & 1][q], v + c0 + q);
    nrzi_cp_commit();
  };
  // the eligible window in registers: the walk's stores could alias it
  const int lo = a.lead[b], hi = a.seg_len[b];
  Walk w;
  if (stager) {
    stage(0);
    nrzi_cp_wait();
  } else if (tid == 0) {
    w.init();
  }
  __syncthreads();
  for (int i = 0; i < nch; ++i) {
    if (stager && i + 1 < nch) stage(i + 1);
    if (tid == 0) {
      const int c0 = i * ZC_CHUNK, c1 = min(c0 + ZC_CHUNK, S);
      const float* x = buf[i & 1];
      for (int s = c0; s < c1; ++s) w.step(a, lane, s, zc_elig(lo, hi, s, x[s - c0]));
    }
    if (stager) nrzi_cp_wait();
    __syncthreads();
  }
  if (tid == 0) {
    n_sh = w.finish(a, lane);
    a.n_found[lane] = n_sh;
    w.fill_value(a, t_sh, top_sh);
  }
  __syncthreads();
  zc_fill(a, lane, n_sh, t_sh, top_sh, tid, ZC_THREADS);
}

__global__ void __launch_bounds__(ZS_THREADS) zs_kernel(ZsArgs a) {
  const int lane = blockIdx.x * ZS_THREADS + threadIdx.x;
  if (lane >= a.B * a.P * a.T) return;
  float ring[NRZI_MAX_CLK_RING];
  zs_lane(a, lane, ring);
}

// Launch on `stream`; each returns cudaGetLastError() (0 = launched).
extern "C" int zerocross_launch(const ZcArgs* a, void* stream) {
  if (a->cap < 1 || a->S < 1) return (int)cudaErrorInvalidValue;
  const int n = a->B * a->T;
  if (n <= 0) return 0;
  if (a->diff)
    zc_kernel<ZcDiff><<<n, ZC_THREADS, 0, (cudaStream_t)stream>>>(*a);
  else
    zc_kernel<ZcPlain><<<n, ZC_THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int gcr_zeros_launch(const ZsArgs* a, void* stream) {
  if (a->cap < 1 || a->maxb < 1) return (int)cudaErrorInvalidValue;
  const int n = a->B * a->P * a->T;
  if (n <= 0) return 0;
  zs_kernel<<<(n + ZS_THREADS - 1) / ZS_THREADS, ZS_THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
