// nrzi_slot: the NRZI global bit-slot machine alone, for Hopper (sm_90a).
//
// Replaces readtape_tpu/decode/pallas_slot.py::nrzi_slot_scan_pallas (B6,
// TPU kernel `_kernel`, read out by slot_stream_reconstruct): the slot
// machine of nrzi.nrzi_slot_scan over the per-track transition buffers
// that nrzi_scan.cu (B5) wrote, for every (segment, parmset) lane. It
// writes the slot scan's final state directly, in B1's output layout
// (decode/fused.py FusedOut), so nothing is reconstructed afterwards; and
// it keeps what the XLA scan does and the TPU kernel does not: -correct
// (from tr_agc), up to 16 tracks, any S below 2^30.
//
// What bounds it: serial latency. The machine couples all tracks of a
// lane, one slot after another; each slot reads the next few transitions
// of every track. One thread per lane, 32 lanes per block. Built with
// --fmad=false; the clock's fused multiply-adds are explicit fmaf().
//
// The wrapper (kernels.py) zeroes the bit buffers and histograms.
#include <cuda_runtime.h>

#include "nrzi_core.h"

#define NRZI_SLOT_THREADS 32

__global__ void __launch_bounds__(NRZI_SLOT_THREADS) nrzi_slot_kernel(NrziSlotArgs a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < a.B * a.P) nrzi_slot_lane(a, lane);
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int nrzi_slot_launch(const NrziSlotArgs* a, void* stream) {
  if (a->T > NRZI_MAX_TRACKS) return (int)cudaErrorInvalidValue;
  const int n = a->B * a->P;
  if (n <= 0) return 0;
  nrzi_slot_kernel<<<(n + NRZI_SLOT_THREADS - 1) / NRZI_SLOT_THREADS,
                     NRZI_SLOT_THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
