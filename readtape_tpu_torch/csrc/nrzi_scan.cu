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
// independent: one thread per lane, 32 lanes per block.
//
// What bounds it: serial latency. A lane's steps form a dependent chain
// (the AGC state of one admission sets the thresholds of the next), and
// each step gathers one 40-byte feature row and a jump-table entry at a
// data-dependent position. The card's width is used only through the
// B*P*T lanes. The two entry points differ in which lanes share a warp:
// B5a puts a track's parmsets side by side (they read the same jump
// table), B5b a lane's tracks (as the TPU kernel's sublanes). Built with
// --fmad=false; the AGC's one fused multiply-add is an explicit fmaf().
//
// The wrapper (kernels.py) pre-fills the outputs with compact_outputs'
// fill; there is no step budget unless the caller passes one (density
// detection passes the JAX XLA scan's).
#include <cuda_runtime.h>

#include "nrzi_core.h"

#define NRZI_SCAN_THREADS 32

template <bool PARMSET_MINOR>
__global__ void __launch_bounds__(NRZI_SCAN_THREADS) nrzi_scan_kernel(NrziScanArgs a) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= a.B * a.P * a.T) return;
  int lane = j;                            // B5b: (b, p, t), t fastest
  if (PARMSET_MINOR) {                     // B5a: (b, t, p), p fastest
    const int p = j % a.P, t = (j / a.P) % a.T, b = j / (a.P * a.T);
    lane = (b * a.P + p) * a.T + t;
  }
  nrzi_scan_lane(a, lane);
}

template <bool PARMSET_MINOR>
static int nrzi_scan_go(const NrziScanArgs* a, void* stream) {
  const int n = a->B * a->P * a->T;
  if (n <= 0) return 0;
  nrzi_scan_kernel<PARMSET_MINOR>
      <<<(n + NRZI_SCAN_THREADS - 1) / NRZI_SCAN_THREADS, NRZI_SCAN_THREADS, 0,
         (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// B5a: parmsets of any window widths (G feature groups). Launches on
// `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int nrzi_scan_launch(const NrziScanArgs* a, void* stream) {
  return nrzi_scan_go<true>(a, stream);
}

// B5b: every parmset shares one window width (G = 1)
extern "C" int nrzi_scan_tracks_launch(const NrziScanArgs* a, void* stream) {
  if (a->G != 1) return (int)cudaErrorInvalidValue;
  return nrzi_scan_go<false>(a, stream);
}
