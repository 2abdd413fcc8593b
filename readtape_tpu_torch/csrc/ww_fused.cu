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
// end time for a tapemark at the end of the tape. With WwArgs::tr_t set
// (-trace's record mode) it also writes each record's peak time and each
// character's clock-end time.
//
// What bounds it: serial latency. WW has one lane, not a batch of
// segments: each track's admissions form a chain of dependent steps (the
// AGC state of one sets the thresholds of the next), and the machine is
// one chain over every track's events in time order. Each chain runs on
// one thread, so the design keeps device memory off the chains: what a
// chain reads does not depend on its state (the samples, each candidate's
// window features, the merged order of the events), so other warps stage
// it into shared memory ahead of the chain. Four launches on one stream:
//   ww_cand_kernel     grid-wide: the loose candidate bitmask [T, S/32],
//                      one 32-position word per thread
//   ww_admit_kernel    one block per track. Warps 1-7 stage the track in
//                      chunks of C samples (cp.async: the samples with a
//                      W + 1 halo, the candidate words) and compute each
//                      candidate's window features into a shared-memory
//                      slot, a chunk ahead; thread 0 walks the chunks
//                      (admission, refine_frac, AGC, height sums) from
//                      shared memory and appends (s, frac, is_top) to the
//                      track's [K] records. Two slots, a barrier a chunk
//   ww_rank_kernel     grid-wide, one thread per record: its place in
//                      (s, track) order, by binary searches in the other
//                      tracks' sorted records; scatters it into one packed
//                      event array
//   ww_machine_kernel  one block: warp 1 streams the packed events into
//                      shared memory a chunk ahead (cp.async); thread 0
//                      runs the machine per event with its per-track
//                      arrays, clock ring and histogram in shared memory,
//                      then the trailing flush
// Built with --fmad=false, fmaf() only where the JAX package's XLA scans
// contract a multiply-add.
#include <cuda_runtime.h>

#include "ww_core.h"

#define WW_CAND_THREADS 256
#define WW_RANK_THREADS 256
#define WW_ADMIT_THREADS 256     // warp 0: the walk; warps 1-7: staging
#define WW_CHUNK 2048            // admission: samples per chunk
#define WW_MACHINE_THREADS 64    // warp 0: the machine; warp 1: staging
#define WW_EV_CHUNK 2048         // machine: events per chunk
#define WW_SMEM_MAX 232448       // shared memory a block may use

__global__ void __launch_bounds__(WW_CAND_THREADS) ww_cand_kernel(WwArgs a) {
  const int nw = ww_nwords(a);
  const int64_t n = (int64_t)a.T * nw;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    a.cand[i] = ww_cand_word(a, (int)(i / nw), (int)(i % nw));
}

// shared memory of ww_admit_kernel at chunk C: the staging and feature
// slots of its track, the AGC window
static size_t ww_admit_smem(int C, int W) {
  return nrzi_stage_smem(1, C, W) + WW_AGC_RING * 4;
}

// REC (here and in ww_machine_kernel): the record mode (WwArgs::tr_t and
// char_t set), its own instantiation
template <bool REC>
__global__ void __launch_bounds__(WW_ADMIT_THREADS, 1) ww_admit_kernel(WwArgs a, int C) {
  extern __shared__ __align__(16) unsigned char ww_sm[];
  const int t = blockIdx.x, S = a.S, W = a.W, nw = ww_nwords(a);
  const int nch = (S + C - 1) / C;
  const int tid = threadIdx.x, ptid = tid - 32, np = blockDim.x - 32;
  const bool stager = tid >= 32;
  NrziStager sg;
  float* heights = (float*)sg.init(ww_sm, a.volts + (int64_t)t * S,
                                   a.cand + (int64_t)t * nw, 1, S, W, C, W, nw,
                                   ptid, np);        // [WW_AGC_RING]

  WwWalkT<REC> w;
  const long long c_start = clock64();
  long long walked = 0;                    // cycles spent walking
  if (stager) sg.prime(nch);
  else if (tid == 0) ww_walk_init(w, a, t, heights);
  __syncthreads();
  for (int i = 0; i < nch; ++i) {
    if (stager) {
      sg.advance(i, nch);
    } else if (tid == 0) {
      const int c0 = i * C;
      const long long c = clock64();
      ww_walk_chunk(w, sg.words(i, 0), sg.feat(i, 0), c0, min(c0 + C, S), S);
      walked += clock64() - c;
    }
    __syncthreads();
  }
  if (tid == 0) {
    ww_walk_finish(w, a, t);
    if (a.stamps) {
      a.stamps[t] = walked;
      a.stamps[a.T + t] = clock64() - c_start;
    }
  }
}

__global__ void __launch_bounds__(WW_RANK_THREADS) ww_rank_kernel(WwArgs a) {
  const int64_t n = (int64_t)a.T * a.K;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int t = (int)(i / a.K), k = (int)(i % a.K);
    if (k < ww_nrec(a, t)) ww_scatter_one(a, t, k);
  }
}

template <bool REC>
__global__ void __launch_bounds__(WW_MACHINE_THREADS, 1) ww_machine_kernel(WwArgs a) {
  __shared__ int32_t es[2][WW_EV_CHUNK];
  __shared__ float ef[2][WW_EV_CHUNK];
  __shared__ __align__(4) uint8_t et[2][WW_EV_CHUNK];
  __shared__ WwMachineMem mem;
  const int tid = threadIdx.x, ptid = tid - 32;
  const bool stager = tid >= 32;
  const int N = ww_nevents(a), nch = (N + WW_EV_CHUNK - 1) / WW_EV_CHUNK;

  // slot i & 1 <- events [i E, i E + E): ev_tt is padded to whole words
  auto stage = [&](int i) {
    const int j0 = i * WW_EV_CHUNK, n = min(WW_EV_CHUNK, N - j0), b = i & 1;
    for (int j = ptid; j < n; j += 32) {
      nrzi_cp4(&es[b][j], a.ev_s + j0 + j);
      nrzi_cp4(&ef[b][j], a.ev_frac + j0 + j);
    }
    for (int j = 4 * ptid; j < n; j += 128) nrzi_cp4(&et[b][j], a.ev_tt + j0 + j);
    nrzi_cp_commit();
  };

  WwMachine m;
  const long long c_start = clock64(), g_start = nrzi_gtimer();
  long long looped = 0;                    // cycles in the event loop
  if (stager) {
    if (nch > 0) stage(0);
  } else if (tid == 0) {
    ww_machine_init(m, a, &mem);
  }
  for (int i = 0; i < nch; ++i) {
    if (stager) nrzi_cp_wait();      // chunk i staged
    __syncthreads();               // ... and visible; chunk i - 1 consumed
    if (stager) {
      if (i + 1 < nch) stage(i + 1);
    } else if (tid == 0) {
      const int b = i & 1, n = min(WW_EV_CHUNK, N - i * WW_EV_CHUNK);
      const long long c = clock64();
      for (int j = 0; j < n; ++j) ww_event<REC>(m, a, es[b][j], ef[b][j], et[b][j]);
      looped += clock64() - c;
    }
  }
  if (tid == 0) {
    ww_machine_finish(m, a);
    if (a.stamps) {
      a.stamps[2 * a.T] = looped;
      a.stamps[2 * a.T + 1] = clock64() - c_start;
      a.stamps[2 * a.T + 2] = g_start;
      a.stamps[2 * a.T + 3] = nrzi_gtimer();
    }
  }
}

// the admission chunk: WW_CHUNK, halved until its shared memory fits
static int ww_admit_chunk(int W) {
  int C = WW_CHUNK;
  while (C > 32 && ww_admit_smem(C, W) > WW_SMEM_MAX) C >>= 1;
  return ww_admit_smem(C, W) > WW_SMEM_MAX ? 0 : C;
}

static int ww_grid(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  return (int)(blocks > 65535 ? 65535 : (blocks < 1 ? 1 : blocks));
}

#define WW_NPHASE 4

// launch phase i of the decode on st
static cudaError_t ww_phase(const WwArgs& a, int i, cudaStream_t st) {
  if (i == 0) {
    ww_cand_kernel<<<ww_grid((int64_t)a.T * ww_nwords(a), WW_CAND_THREADS),
                     WW_CAND_THREADS, 0, st>>>(a);
  } else if (i == 1) {
    const int C = ww_admit_chunk(a.W);
    const size_t smem = ww_admit_smem(C, a.W);
    void (*admit)(WwArgs, int) = a.tr_t ? ww_admit_kernel<true> : ww_admit_kernel<false>;
    cudaError_t e = cudaFuncSetAttribute(
        admit, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    admit<<<a.T, WW_ADMIT_THREADS, smem, st>>>(a, C);
  } else if (i == 2) {
    ww_rank_kernel<<<ww_grid((int64_t)a.T * a.K, WW_RANK_THREADS),
                     WW_RANK_THREADS, 0, st>>>(a);
  } else {
    if (a.tr_t)
      ww_machine_kernel<true><<<1, WW_MACHINE_THREADS, 0, st>>>(a);
    else
      ww_machine_kernel<false><<<1, WW_MACHINE_THREADS, 0, st>>>(a);
  }
  return cudaGetLastError();
}

static bool ww_args_ok(const WwArgs* a) {
  return a->T >= 1 && a->T <= WW_MAX_TRACKS && a->agc_window <= WW_AGC_RING &&
         a->clk_window <= WW_CLK_RING && a->K >= 1 && a->S >= 1 &&
         ww_admit_chunk(a->W) > 0;
}

// Launches the kernels on `stream`; returns cudaGetLastError() (0 =
// launched).
extern "C" int ww_fused_launch(const WwArgs* a, void* stream) {
  if (!ww_args_ok(a)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < WW_NPHASE; ++i) {
    cudaError_t e = ww_phase(*a, i, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The number of launches, for ww_fused_phase_ms.
extern "C" int ww_fused_nphase() { return WW_NPHASE; }

// The same launches with a CUDA event between each two; waits for them
// and writes each launch's ms to ms[0 .. WW_NPHASE). For timing only.
extern "C" int ww_fused_phase_ms(const WwArgs* a, void* stream, float* ms) {
  if (!ww_args_ok(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaEvent_t ev[WW_NPHASE + 1];
  for (int i = 0; i <= WW_NPHASE; ++i) cudaEventCreate(&ev[i]);
  cudaError_t e = cudaEventRecord(ev[0], st);
  for (int i = 0; i < WW_NPHASE && e == cudaSuccess; ++i) {
    e = ww_phase(*a, i, st);
    if (e == cudaSuccess) e = cudaEventRecord(ev[i + 1], st);
  }
  if (e == cudaSuccess) e = cudaEventSynchronize(ev[WW_NPHASE]);
  for (int i = 0; i < WW_NPHASE && e == cudaSuccess; ++i)
    e = cudaEventElapsedTime(&ms[i], ev[i], ev[i + 1]);
  for (int i = 0; i <= WW_NPHASE; ++i) cudaEventDestroy(ev[i]);
  return (int)e;
}
