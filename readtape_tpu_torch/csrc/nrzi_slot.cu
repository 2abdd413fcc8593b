// nrzi_slot: the NRZI global bit-slot machine alone, for Hopper (sm_90a).
//
// Replaces readtape_tpu/decode/pallas_slot.py::nrzi_slot_scan_pallas (B6,
// TPU kernel `_kernel`, read out by slot_stream_reconstruct): the slot
// machine of nrzi.nrzi_slot_scan over the per-track transition buffers
// that nrzi_scan.cu (B5) wrote, for every (segment, parmset) lane. It
// writes the slot scan's final state directly, in B1's output layout
// (decode/fused.py FusedOut), so nothing is reconstructed afterwards; and
// it keeps what the XLA scan does and the TPU kernel does not: -correct
// (from tr_agc), up to 16 tracks, any S below 2^30. It also runs the two
// modes that only the JAX package's XLA scan has, and B1 never runs:
// -adjskew's per-track deviation accumulators (seeded from adj0, written
// to adj, with the final clock in bitspace) and -correct as the DEBUG
// build computes it (the parity of the last complete byte's column, a
// warp vote over each track's own row; the JAX package replays that on
// the host from streamed write records).
// With NrziSlotArgs::dbg_slot set (-trace's record mode, -correct off) it
// also writes each slot's boundary and adjusted clock position and, per
// (track, column), the slot of the last write: what the JAX package's
// debug scan streams for the trace's zerchk, avgpos, data and parerr
// lanes.
//
// What bounds it: serial latency. The machine couples all tracks of a
// lane, one slot after another, but within a slot each track's work is
// its own. So a lane runs on one warp (one block each, so the lanes spread
// over the SMs), track t on thread t, the per-lane combines on thread 0
// (nrzi_core.h nrzi_slot_warp); each track's transitions stream into a
// ring in shared memory ahead of its cursor, so no slot waits on device
// memory. Built with --fmad=false; the clock's fused multiply-adds are
// explicit fmaf().
//
// The wrapper (kernels.py) zeroes the bit buffers and histograms.
#include <cuda_runtime.h>

#include "nrzi_core.h"

// REC: the record mode (NrziSlotArgs::dbg_slot set), its own
// instantiation, so that the decode's kernel carries none of it
template <bool REC>
__global__ void __launch_bounds__(32) nrzi_slot_kernel(NrziSlotArgs a) {
  extern __shared__ __align__(16) unsigned char slot_sm[];
  const int lane = blockIdx.x, t = threadIdx.x;
  int64_t* st = a.stamps && t == 0 ? a.stamps + (int64_t)lane * SLOT_NSTAMP : 0;
  if (st) st[SLOT_ST_G0] = nrzi_gtimer();
  // each track's thread copies its admission fields, then reads them back
  if (t < a.T) nrzi_slot_copy_track(a, lane, t);
  if (st) st[SLOT_ST_C0] = clock64();
  nrzi_slot_warp<REC>(nrzi_slot_lane_b6(a, lane), slot_sm, st ? st + SLOT_ST_MACH : 0);
  if (st) {
    st[SLOT_ST_C1] = clock64();
    st[SLOT_ST_G1] = nrzi_gtimer();
  }
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int nrzi_slot_launch(const NrziSlotArgs* a, void* stream) {
  if (a->T < 1 || a->T > NRZI_MAX_TRACKS || a->K < 1) return (int)cudaErrorInvalidValue;
  const int n = a->B * a->P;
  if (n <= 0) return 0;
  if (a->dbg_slot)
    nrzi_slot_kernel<true><<<n, 32, nrzi_slot_smem(a->T), (cudaStream_t)stream>>>(*a);
  else
    nrzi_slot_kernel<false><<<n, 32, nrzi_slot_smem(a->T), (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
