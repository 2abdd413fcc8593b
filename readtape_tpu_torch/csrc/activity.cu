// activity: the int16 activity scan for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package scans an int16 tape on the host
// (readtape_tpu/decode/segment.py host_activity: the native tape_scan of
// native/readtape_io.cpp, then numpy's quantile over the subsample), so
// that its TPU decode never waits for the upload. In this port the tape is
// already on the card when the scan runs (pipeline._resident_tape uploads
// first), and the host scan was the largest wait of an int16 capture.
//
// What it computes, for the [N, T] int16 tape as it was uploaded (row
// order, before the transpose into [T, N], which copies): exactly what
// tape_scan computes, with the subsample kept as counts:
//   out[c], c < N / 16          max |x| over rows 16c..16c+15, every track
//   out[N / 16 + v], v <= 32768 the number of (row, track) pairs with
//                               row % step == 0 and |x| = v, rows past the
//                               last full chunk included
// |x| is taken in int32 (|-32768| = 32768). The histogram part must be
// zeroed by the caller. From the histogram the host reads the quantile's
// two order statistics exactly (segment.tape_activity).
//
// What bounds it: bytes, the tape read once (80.7 MB for a 4.48 M-sample
// 9-track capture, ~24 us at 3.35 TB/s) and ~1.3 MB written. The design:
// one thread per chunk, grid-stride, a chunk being 16 T int16 = 2 T
// 16-byte vectors (16 T * 2 bytes is a multiple of 16 for every T, so a
// vector never straddles two chunks), its maximum kept as packed 16-bit
// max and min (__vmaxs2/__vmins2) and taken as max(max, -min) in int32
// once per chunk. The subsample is one row in `step` (~2 M increments per
// capture, most in a few low bins on the idle tape), counted into a
// histogram private to the block in shared memory (32,769 int32 bins,
// 131 KB: one block of ACT_THREADS threads per SM) and merged into the
// global one with one atomic per non-empty bin. The subsample's rows are
// read again as scalars, from the lines the chunk's vectors just brought
// into the caches.
#include <cuda_runtime.h>
#include <stdint.h>

#define ACT_CHUNK 16
#define ACT_BINS 32769
#define ACT_THREADS 1024

struct ActivityArgs {
  const int16_t* x;    // [N, T] row-major, 16-byte aligned
  int32_t* out;        // [N / 16 + ACT_BINS]: chunk maxima, then the histogram (zeroed)
  int64_t N;
  int32_t T, step;
};

__global__ void __launch_bounds__(ACT_THREADS, 1) activity_kernel(ActivityArgs a) {
  extern __shared__ int32_t act_hist[];    // [ACT_BINS]
  for (int b = threadIdx.x; b < ACT_BINS; b += blockDim.x) act_hist[b] = 0;
  __syncthreads();
  const int T = a.T, nv = 2 * T;
  const int64_t nc = a.N / ACT_CHUNK, nall = (a.N + ACT_CHUNK - 1) / ACT_CHUNK;
  const int4* xv = reinterpret_cast<const int4*>(a.x);
  for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; c < nall;
       c += (int64_t)gridDim.x * blockDim.x) {
    if (c < nc) {
      const int4* v = xv + c * nv;
      unsigned mx = 0x80008000u, mn = 0x7fff7fffu;
#pragma unroll 6
      for (int k = 0; k < nv; ++k) {
        const int4 w = __ldg(v + k);
        const unsigned q[4] = {(unsigned)w.x, (unsigned)w.y, (unsigned)w.z, (unsigned)w.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mx = __vmaxs2(mx, q[j]);
          mn = __vmins2(mn, q[j]);
        }
      }
      const int hi = max((int)(int16_t)(mx & 0xffffu), (int)(int16_t)(mx >> 16));
      const int lo = min((int)(int16_t)(mn & 0xffffu), (int)(int16_t)(mn >> 16));
      a.out[c] = max(hi, -lo);
    }
    // this chunk's rows in the subsample (the last, partial chunk's too)
    const int64_t r0 = c * ACT_CHUNK, r1 = r0 + ACT_CHUNK < a.N ? r0 + ACT_CHUNK : a.N;
    for (int64_t r = (r0 + a.step - 1) / a.step * a.step; r < r1; r += a.step) {
      const int16_t* row = a.x + r * T;
      for (int t = 0; t < T; ++t) {
        const int v = row[t];
        atomicAdd(act_hist + (v < 0 ? -v : v), 1);
      }
    }
  }
  __syncthreads();
  int32_t* hist = a.out + nc;
  for (int b = threadIdx.x; b < ACT_BINS; b += blockDim.x) {
    const int32_t n = act_hist[b];
    if (n) atomicAdd(hist + b, n);
  }
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int activity_scan_launch(const ActivityArgs* a, void* stream) {
  if (a->N < 0 || a->T < 1 || a->step < 1 || ((uintptr_t)a->x & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t nall = (a->N + ACT_CHUNK - 1) / ACT_CHUNK;
  if (nall == 0) return 0;
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = ACT_BINS * sizeof(int32_t);
  e = cudaFuncSetAttribute(activity_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t need = (nall + ACT_THREADS - 1) / ACT_THREADS;
  const int grid = (int)(need < sms ? need : sms);
  activity_kernel<<<grid, ACT_THREADS, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
