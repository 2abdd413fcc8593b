#!/usr/bin/env python3
"""Drive the PyTorch port's NRZI, PE, GCR and Whirlwind paths, -zeros and
float (CSV) tapes included, its command line (-parmscan included), NRZI
-adjskew and -correctdbg, -trace, the host tools csvtbin and dumptap, and
the decode mesh (-mesh), on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, in order; each prints its lines, and the first failure exits
non-zero:

  1. device   a CUDA card is present (there is no CPU path); its name and
              power limit
  2. build    nvcc builds readtape_tpu_torch/csrc into build/torch_kernels
              (one compiler process per source, all started together)
  3. kernel   each CUDA kernel on the card against its plain PyTorch
              version run on a host copy of the same inputs (two to three
              times faster than on the card): nrzi_fused_scan on
              synthesized 9-track segments (B=4, 8 parmsets, S=16384, one
              noisy), with -correct, on 7-track
              segments and on the first batch that phase 4's NRZI decode
              hands it; the tiered NRZI kernels on the same segments:
              nrzi_track_scan (B5a, the 8 parmsets' three window widths;
              and 15 parmsets, six widths, under a step budget that
              stops some lanes and not others),
              nrzi_track_scan_tracks (B5b, parmset 0), nrzi_slot_scan (B6,
              over B5a's buffers, with and without -correct, and on the
              7-track segments), and each at the first batch that phase
              4's tiered decode hands it (B5b also at its second batch,
              B=34, and at density detection's launch, B=1, under the
              step budget); pe_fused_scan on synthesized
              9-track PE segments (B=4, 8 parmsets, S=16384: clean, noisy
              with a weak track, a dropout that forces fake bits, two
              blocks behind a short gap so that the all-idle point falls
              inside the window) and on the first two batches of phase
              4's PE decode (B=60, then a walk hop, B=1); gcr_fused_scan
              on synthesized 9-track GCR segments (B=4, 5 parmsets,
              S=16384: clean, noisy, one weak track, two blocks behind a
              short gap) and on the first batch of phase 4's GCR decode;
              ww_fused_scan on a noisy 6-track Whirlwind tape (about
              160,000 samples, one weak track, -fluxdir=auto) as
              decode_tape hands it, and again with a rolling-base span
              of 2^14 samples so that the base moves, and on the Whirlwind
              bench tape as decode_tape hands it, timed there and held to
              the plain version on the first 786,432 samples of the same
              inputs (4 blocks); the -zeros
              kernels: zerocross_transitions (Z1) plain and
              differentiated and gcr_zeros_scan (Z2) on synthesized
              9-track GCR segments (B=4, S=16384), Z1 at the first launch
              of phase 4's GCR -zeros decode (B=40), of the NRZI -zeros
              chain (B=1, the launch the chain makes 1,096 times) and of
              the -differentiate -zeros decode, Z2 at the GCR -zeros
              decode's retry (B=16, P=5), and nrzi_slot_scan (B6) on
              Z1's NRZI transitions at the first launch of the NRZI
              -zeros chain; B6 in the modes of -adjskew (B=1, P=1, the
              bench's first segment, random non-zero accumulator seeds)
              and -correctdbg (B=16, P=8; and with a mid-block bit
              dropped per lane, so that every lane corrects), and the
              admission before each (B5b, B5a), at the first launch
              each option's bench decode makes; -trace's record modes at
              the launches the trace makes (B=1, P=1, one window of the
              bench tape): B5b then B6 with its per-slot and per-column
              records on the NRZI bench tape and on the flipped-bit tape
              (a parity error inside a block), B2 and B3 with their
              per-admission rows on the PE and GCR bench tapes, B4 with
              its peak and character times on the Whirlwind one; all
              timed (-trace's: the mean of 20 launches), each with its
              bound and its
              serial chain (Z1 plain: the significant phases of pass B;
              Z2: the admitted transitions; Z1 differentiated: none); last,
              activity_scan (the int16 activity scan) at the benchmark's
              NRZI and PE capture shapes, timed beside its bound, and
              segment.tape_activity on the card against host_activity
              (height estimate and mask equal; both timed)
  4. main     decode_tape on the card at bench scale, each path with the
              launch counts set to 0 just before it and read just after:
              NRZI (160 blocks of 1200 bytes, 2 tapemarks, seed 2026, 8
              parmsets) through the fused kernel and through the tiered
              kernels (kernel_path="tiered": B5b and B6, not B1; blocks
              equal to the fused decode's), PE (60 blocks of 1200 bytes,
              seed 4100, 8 parmsets), GCR (40 blocks of 1200 bytes, seed
              5100, 5 parmsets) and Whirlwind (12 blocks of 400 words, seed
              6100, -fluxdir=neg, one pass), each run twice; every block
              against the synthesizer's ground truth, and proof that the
              decode went through the kernels. Then a Whirlwind tape of 24
              such blocks (beyond 2^22 samples, so the rolling base moves)
              against its ground truth; a noisy NRZI tape through the
              tiered path (the 8-parmset retry: B5a), noisy PE and GCR
              tapes with short gaps (the all-idle point, the PE walk, the
              all-parmset retry), a GCR tape whose segment holds two blocks
              (a multi-block round) and a skewed Whirlwind tape under
              -deskew (two passes) decoded on the card and on the CPU,
              block for block equal. Float tapes and -zeros: the GCR bench
              tape as float32 volts (maxvolts 32767, the activity scan on
              the card; blocks equal to the int16 decode's), with -zeros
              (Z1 and Z2; its blocks are not recovered, in the JAX package
              neither, so the card's decode is held to the CPU's, block for
              block), example3's recipe at bench length (40 blocks of 1200
              bytes, pulses 0.45 bits wide, no noise) as float volts with
              -differentiate -zeros (every block against the ground truth),
              and the NRZI bench tape with -zeros (the sequential chain: Z1
              and B6; not recovered either, so its first two blocks are
              decoded on the card and on the CPU, block for block equal).
              Last, density detection on the card:
              the NRZI and PE bench tapes decoded with bpi=0 detect 800 and
              1600 bpi (B5b) and decode to their ground truth
  5. golden   the four NRZI, two PE, three GCR (-zeros -correct, and a CSV
              capture written and read back by the port with
              -differentiate -zeros) and one Whirlwind example tapes
              written as .tbin (or .csv) and run through the port's
              command line with each example's own arguments on the
              card, and the four NRZI ones again through the tiered
              kernels; the SHA-256 of each .tap against
              examples/golden.json
  6. cli      the NRZI bench tape written as .tbin and run through the
              command line with -v -m -nrzi -tap -textfile -hex -ebcdic
              (warm, launch counts set to 0 just before): its .tap blocks
              against the ground truth, the CLI's wall and the decode's
              inside it; then the 9trk_NRZI/example tape through the same
              command line on the card and on the CPU: .tap, .txt,
              .peakstats.csv and .log equal (the time masked)
  7. parmscan GCR -parmscan on tests/test_parmscan.py's one-block tape:
              gcr_fused_scan at the grid's shape (B=1, P=64: the first 64
              combos) against its plain version, and its 64 clk_alpha
              lines equal to the plain version's; then the whole
              5,280-combo grid through the command line (its launches of
              B3 and its time), the .tap against the ground truth
  8. options  -adjskew on tests/test_cli_oracle.py's recipe (skewed
              tracks, five blocks and a tapemark, seed 42), -correctdbg on
              its recipe (seed 67) and on a tape where it corrects a bit
              that -correct does not: each decoded on the card and on
              the CPU (blocks, per-track reports, final skew equal; B5b
              or B5a and B6 launched, B1 not) and through the command
              line on both (.tap and .log equal); then the NRZI bench
              tape under each option, timed with the launch counts set
              to 0 just before, every block against the ground truth
  9. trace    the command line with -trace=a,b on the NRZI, PE, GCR and
              Whirlwind bench tapes (a window holding a block) and with
              -trace on the NRZI one: the trace step timed alone with the
              launch counts set to 0 just before (each record mode's
              kernel once, no plain version), its .trace.csv byte for
              byte equal to the one the same step writes on the CPU
              over the window (the plain versions; no CPU decode of the
              tape)
 10. tools    the host tools, through the port alone: the NRZI bench
              recipe cut to 20 blocks written as a CSV of volts, turned
              into a .tbin by csvtbin (the native scanfast scanner, which
              must have built) and decoded by the command line on the
              card (B1 launched; every block against the ground truth,
              both tapemarks); 9trk_GCR/example3's CSV through csvtbin
              and the command line with -differentiate -zeros on the card
              (Z1, Z2) and on the CPU, the two .tap equal byte for byte;
              dumptap -hex -ebcdic on the first .tap (a line per record
              and per tapemark, as in the .tap); csvtbin -read of the
              .tbin (a row per sample); csvtbin's and the CLI's walls
 11. mesh     decode_tape under make_decode_mesh([card] * 4, parm_axis=2),
              a (data 2, parm 2) grid naming the card four times, each
              entry a shard that runs after the others on the card, warm,
              the launch counts set to 0 just before and read just after,
              each launch's B and P printed, the wall beside the
              one-device wall: the NRZI bench tape (the data axis: B1 at
              B=64, 64, 17, 17 for the batches of 128 and 34), the noisy
              PE short-gap tape (the 8-parmset retry over the parm axis
              too: B2 at P=4) and gcr_parmscan on phase 7's tape cut to
              128 combos (B3 at B=1 padded to 2, P=32); blocks (for
              -parmscan the log lines) equal to the one-device run's,
              and the NRZI blocks to the ground truth. With more than one
              card, the NRZI bench tape also over make_decode_mesh() of
              every card, once more with the telemetry recording: one
              resident.replicate span whose d2d_bytes are the tape's
              bytes times the other cards, and the blocks equal to the
              one-card decode's; with one card, a line says that part
              was not run

Each phase prints the seconds it took. Then one JSON line describing the
kernels, the card's name and power limit as nvidia-smi reports them, and a
last JSON line {"ok": true, ...}.

    python3 chip_smoke.py breakdown

runs none of the checks: it prints nvcc's -Xptxas -v lines (registers,
stack frame, spills of each kernel), the phases of nrzi_fused_scan and
the slot machine of nrzi_slot_scan at their NRZI bench launches (with
the machine's time per slot by kind of step), nrzi_track_scan_tracks'
walk per lane at the tiered bench's first launch, nrzi_track_scan's
walk and barrier wait per walker at -correctdbg's first launch on the
NRZI bench tape, the phases of
gcr_fused_scan at the GCR bench's launch, Z1's passes A, B and C per
lane (plain at B=40 and at the NRZI chain's B=1, differentiated) and
Z2's walk per admitted transition, the time of each of
ww_fused_scan's launches at the Whirlwind bench tape and of each phase
of pe_fused_scan at the PE bench decode's first launch and at its
second (a walk hop, B=1), then times where a warm decode_tape of each
bench tape spends its wall (each step with a synchronize around it; the
NRZI bench also tiered and under -correctdbg, the GCR bench also as
float volts and with -zeros),
and profiles one more decode with torch.profiler for the card's busy
time.
Imports nothing of JAX and nothing of the JAX package: the example tapes
come from the port's own synthesizer and the recipe table below.
"""

import contextlib
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# the port's kernels: the module of the wrapper, the CUDA source and the
# TPU kernel each replaces (the function that reaches pl.pallas_call)
KERNELS = {
    "nrzi_fused_scan": dict(
        module="fused", source="readtape_tpu_torch/csrc/nrzi_fused.cu",
        replaces="readtape_tpu/decode/pallas_fused.py:1102"),
    "nrzi_track_scan": dict(
        module="scan", source="readtape_tpu_torch/csrc/nrzi_scan.cu",
        replaces="readtape_tpu/decode/pallas_scan.py:551"),
    "nrzi_track_scan_tracks": dict(
        module="scan", source="readtape_tpu_torch/csrc/nrzi_scan.cu",
        replaces="readtape_tpu/decode/pallas_scan.py:472"),
    "nrzi_slot_scan": dict(
        module="slot", source="readtape_tpu_torch/csrc/nrzi_slot.cu",
        replaces="readtape_tpu/decode/pallas_slot.py:390"),
    "pe_fused_scan": dict(
        module="fused", source="readtape_tpu_torch/csrc/pe_fused.cu",
        replaces="readtape_tpu/decode/pallas_fused.py:1760"),
    "gcr_fused_scan": dict(
        module="fused", source="readtape_tpu_torch/csrc/gcr_fused.cu",
        replaces="readtape_tpu/decode/pallas_fused.py:2326"),
    "ww_fused_scan": dict(
        module="fused", source="readtape_tpu_torch/csrc/ww_fused.cu",
        replaces="readtape_tpu/decode/pallas_fused.py:3104"),
    # -zeros: the JAX package computes these with XLA, no TPU kernel
    "zerocross_transitions": dict(
        module="zeros", source="readtape_tpu_torch/csrc/zeros.cu",
        replaces="readtape_tpu/decode/gcr.py:338 zerocross_transitions "
                 "(XLA; no TPU kernel)"),
    "gcr_zeros_scan": dict(
        module="zeros", source="readtape_tpu_torch/csrc/zeros.cu",
        replaces="readtape_tpu/decode/gcr.py:551 gcr_zeros_track_scan "
                 "(XLA; no TPU kernel)"),
    # the int16 activity scan: the JAX package runs it on the host
    "activity_scan": dict(
        module="segment", source="readtape_tpu_torch/csrc/activity.cu",
        replaces="readtape_tpu/decode/segment.py:126 host_activity "
                 "(host; no TPU kernel)"),
}
# the benchmark's captures (tapebench/configs): sample rows, tracks
ACTIVITY_SHAPES = {"activity nrzi": (4_481_584, 9),
                   "activity pe": (2_331_780, 9)}
# kernel vs plain: integers and bits equal; floats equal as well, since
# both round every f32 operation in the same order (the kernels are built
# with --fmad=false and the plain versions run one PyTorch op at a time)
F32_TOL = 0.0
DEVICE = "cuda"
# one H100 SXM (NVIDIA's data sheet): memory rate, f32 rate off the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# The example tapes of examples/make_examples.py that the port decodes:
# (mode, default_spec overrides), generator seed, item kind, block sizes
# and the command line. A CPU test holds this table to make_examples.CASES.
EXAMPLES = {
    "9trk_NRZI/example": dict(
        spec=("NRZI", {}), seed=101, mode="blocks",
        sizes=[200, 80, 512, 120, 300],
        args=["-v", "-m", "-nrzi", "-tap"]),
    "9trk_NRZI/example2": dict(
        spec=("NRZI", dict(skew_samples=(0, 3, 1, 5, 2, 0, 4, 1, 2))),
        seed=106, mode="blocks", sizes=[256, 96, 400],
        args=["-v", "-m", "-nrzi", "-deskew", "-tap"]),
    "7trk_NRZI/example": dict(
        spec=("NRZI", dict(ntrks=7, bpi=556)), seed=102, mode="blocks6",
        sizes=[100, 120, 64],
        args=["-v", "-m", "-nrzi", "-ntrks=7", "-tap"]),
    "7trk_NRZI/example2": dict(
        spec=("NRZI", dict(ntrks=7, bpi=200)), seed=107, mode="blocks6",
        sizes=[84, 120],
        args=["-v", "-m", "-nrzi", "-ntrks=7", "-bpi=200", "-tap"]),
    "9trk_PE/example": dict(
        spec=("PE", {}), seed=103, mode="blocks", sizes=[150, 300, 64],
        args=["-v", "-m", "-pe", "-bpi=1600", "-ips=50", "-tap"]),
    "9trk_PE/example2": dict(
        spec=("PE", {}), seed=108, mode="blocks", sizes=[512, 80, 200, 150],
        args=["-v", "-m", "-pe", "-bpi=1600", "-ips=50", "-tap"]),
    "9trk_GCR/example": dict(
        spec=("GCR", {}), seed=104, mode="blocks", sizes=[154, 100, 210],
        args=["-v", "-m", "-gcr", "-ips=25", "-tap"]),
    "9trk_GCR/example2": dict(
        spec=("GCR", {}), seed=109, mode="blocks", sizes=[140, 210, 77],
        args=["-v", "-m", "-gcr", "-ips=25", "-zeros", "-correct",
              "-tap"]),
    "9trk_GCR/example3": dict(
        spec=("GCR", dict(pulse_width_bits=0.45, noise_rms=0.0)), seed=110,
        mode="blocks", fmt="csv", sizes=[154, 64],
        args=["-v", "-m", "-gcr", "-bpi=9042", "-ips=25", "-differentiate",
              "-zeros", "-tap"]),
    "6trk_Whirlwind/example": dict(
        spec=("WW", {}), seed=105, mode="words", sizes=[24, 8],
        args=["-v", "-whirlwind", "-fluxdir=auto", "-tap"]),
}
GOLDEN_CASES = tuple(EXAMPLES)


def fail(phase, msg):
    print(f"FAIL {phase}: {msg}", flush=True)
    sys.exit(1)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0].strip()


def sync():
    import torch
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def wrapper(name):
    """(the KERNELS entry's wrapper, its plain version)."""
    import importlib
    mod = importlib.import_module("readtape_tpu_torch.decode."
                                  + KERNELS[name]["module"])
    return getattr(mod, name), getattr(mod, name + "_plain")


def reset_counts():
    for name in KERNELS:
        fn, plain = wrapper(name)
        fn.launches = 0
        plain.calls = 0


def counts():
    """{kernel: (launches, plain-version calls)} since reset_counts."""
    return {name: (wrapper(name)[0].launches, wrapper(name)[1].calls)
            for name in KERNELS}


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def build_example(name):
    """(header, int16 samples) of one EXAMPLES tape, as
    examples/make_examples.py builds it, with the port's synthesizer."""
    import numpy as np
    from readtape_tpu_torch.formats import tbin as tb
    from readtape_tpu_torch.synth import default_spec, synthesize_tape
    case = EXAMPLES[name]
    mode, kw = case["spec"]
    spec = default_spec(getattr(tb, "MODE_" + mode), **kw)
    rng = np.random.default_rng(case["seed"])
    items = []
    for n in case["sizes"]:
        if case["mode"] == "words":           # Whirlwind: 16-bit words
            items.append(("block", [int(w) for w in
                                    rng.integers(0, 65536, n)]))
        else:
            hi = 64 if case["mode"] == "blocks6" else 256
            items.append(("block", bytes(rng.integers(0, hi, n,
                                                      dtype=np.uint8))))
        items.append(("tapemark",))
    return synthesize_tape(spec, items)


def synth_segments(T, B, S, noisy, seed):
    """B one-block NRZI tapes cut to S samples: (int16 [B, S, T], h_est,
    deltat, maxvolts). Segment `noisy` gets numpy noise of 0.05 V rms and
    a weak track 4 (x0.3), so the slot machine meets errors."""
    import numpy as np
    from readtape_tpu_torch.decode import segment as seg
    from readtape_tpu_torch.formats import tbin as tb
    from readtape_tpu_torch.synth import default_spec, synthesize_tape
    rng = np.random.default_rng(seed)
    out = np.zeros((B, S, T), np.int16)
    spec = default_spec(tb.MODE_NRZI, ntrks=T, ibg_secs=0.001,
                        start_gap_secs=0.001, seed=seed)
    hi = 256 if T == 9 else 64
    for b in range(B):
        payload = bytes(rng.integers(0, hi, 500, dtype=np.uint8))
        hdr, samples = synthesize_tape(spec, [("block", payload)])
        x = samples[:S].astype(np.float64)
        if b == noisy:
            x[:, 4] *= 0.3
            x += rng.normal(0.0, 0.05 / hdr.maxvolts * 32767, x.shape)
        out[b, :len(x)] = np.clip(np.rint(x), -32767, 32767)
    h_est, _ = seg.host_activity(out.reshape(-1, T), hdr.maxvolts)
    return out, h_est, hdr.tdelta_ns * 1e-9, hdr.maxvolts


def _segment_args(mode, raw, h_est, deltat, maxvolts, bpi, ips, nparms,
                  device, differentiate=False):
    """volts, parmsets and the batch knobs that the pipeline derives for
    a batch of segments raw [B, S, T] (TapeDecoder.dispatch_segment_batch)."""
    import numpy as np
    import torch
    from readtape_tpu_torch.decode import common as cm
    from readtape_tpu_torch.decode import pipeline as tpl
    from readtape_tpu_torch.formats.parms import builtin_parmsets
    B, S, T = raw.shape
    spb = 1.0 / (bpi * ips * deltat)
    sets = builtin_parmsets(mode).sets[:nparms]
    dev = torch.device(device)
    pa = cm.ParmArrays.from_parmsets(builtin_parmsets(mode), dev).select(
        range(nparms))
    v = torch.from_numpy(raw).to(dev).permute(0, 2, 1)       # [B, T, S]
    volts = tpl._prep_volts(v, maxvolts, 1.0, None,
                            differentiate=differentiate, spb_int=int(spb),
                            apply_skew=False).contiguous()
    scale = min(1.0, h_est / cm.PKWW_PEAKHEIGHT)
    rf = min(p.pkww_rise for p in sets) * scale / cm.AGC_MAX_VALUE * 0.8
    mf = min(p.min_peak for p in sets) * scale / cm.AGC_MAX_VALUE * 0.8
    lb, bw = tpl._peakstat_bins(mode, 1.0 / (bpi * ips))
    kw = dict(Ws=tuple(cm.pkww_width_for(p.pkww_bitfrac, bpi, ips, deltat)
                       for p in sets),
              rise_floor=torch.full((T,), rf, dtype=torch.float32,
                                    device=dev),
              min_floor=torch.full((T,), mf, dtype=torch.float32,
                                   device=dev),
              stat_lb=float(np.float32(lb / deltat)),
              stat_bw=float(np.float32(bw / deltat)), spb=spb,
              maxb=int(S / spb * 1.3) + 64)
    seg_lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    leads = torch.full((B,), 64, dtype=torch.int32, device=dev)
    return volts, seg_lens, leads, pa, kw


def kernel_inputs(T, S, do_correct, seed, device=DEVICE):
    """nrzi_fused_scan's arguments for 4 synthesized segments (one noisy),
    all 8 parmsets."""
    from readtape_tpu_torch.decode import fused as tfu
    from readtape_tpu_torch.formats import tbin as tb
    raw, h_est, deltat, maxvolts = synth_segments(T, 4, S, noisy=3,
                                                  seed=seed)
    volts, seg_lens, leads, pa, kw = _segment_args(
        tb.MODE_NRZI, raw, h_est, deltat, maxvolts, 800.0, 50.0, 8, device)
    spb = kw["spb"]
    kw.update(expected_parity=1, do_correct=do_correct,
              max_slots=int(S / spb * 1.25) + 48,
              K=int(S / spb * 2.5) + 64,
              max_steps=tfu.scan_step_budget(int(S / spb * 3.2) + 64))
    return volts, seg_lens, leads, pa, kw


def pe_segments(S, seed):
    """Four 9-track PE segments cut to S samples, each starting 64 + 2
    bits' worth of samples before its first block (the pipeline's warmup
    lead and pre-margin): clean, noisy (0.05 V rms numpy noise, track 4 at
    x0.3), a 400-sample dropout on track 4 (fake bits), and two 150-byte
    blocks behind a 0.6 ms gap (the all-idle point inside the window).
    Returns (int16 [4, S, 9], h_est, deltat, maxvolts)."""
    import numpy as np
    from readtape_tpu_torch.decode import segment as seg
    from readtape_tpu_torch.formats import tbin as tb
    from readtape_tpu_torch.synth import default_spec, synthesize_tape
    rng = np.random.default_rng(seed)
    out = np.zeros((4, S, 9), np.int16)
    for b in range(4):
        spec = default_spec(tb.MODE_PE, ibg_secs=0.0006 if b == 3 else 0.001,
                            start_gap_secs=0.001, seed=seed + b)
        n = 150 if b == 3 else 400
        items = [("block", bytes(rng.integers(0, 256, n, dtype=np.uint8)))
                 for _ in range(2 if b == 3 else 1)]
        hdr, samples = synthesize_tape(spec, items)
        deltat = hdr.tdelta_ns * 1e-9
        st = int(0.001 / deltat) - 64 - int(2 / (1600 * 50 * deltat))
        x = samples[st:st + S].astype(np.float64)
        if b == 1:
            x[:, 4] *= 0.3
            x += rng.normal(0.0, 0.05 / hdr.maxvolts * 32767, x.shape)
        if b == 2:
            x[3000:3400, 4] = 0
        out[b, :len(x)] = np.clip(np.rint(x), -32767, 32767)
    h_est, _ = seg.host_activity(out.reshape(-1, 9), hdr.maxvolts)
    return out, h_est, deltat, hdr.maxvolts


def pe_kernel_inputs(S, seed, nparms=8, device=DEVICE):
    """pe_fused_scan's arguments for pe_segments, the first nparms PE
    parmsets."""
    from readtape_tpu_torch.decode import fused as tfu
    from readtape_tpu_torch.formats import tbin as tb
    raw, h_est, deltat, maxvolts = pe_segments(S, seed)
    volts, seg_lens, leads, pa, kw = _segment_args(
        tb.MODE_PE, raw, h_est, deltat, maxvolts, 1600.0, 50.0, nparms,
        device)
    spb = kw["spb"]
    steps = tfu.scan_step_budget(int(S / spb * 3.2) + 64)
    kw.update(K=steps, max_steps=steps)
    return volts, seg_lens, leads, pa, kw


def gcr_segments(S, seed):
    """Four 9-track GCR segments cut to S samples, each starting 64 + 2
    bits' worth of samples before its first block (the pipeline's warmup
    lead and pre-margin): clean, noisy (0.05 V rms numpy noise), one weak
    track (track 4 at x0.3), and two 150-byte blocks behind a 0.5 ms gap
    (the all-idle point inside the window). Returns (int16 [4, S, 9],
    h_est, deltat, maxvolts)."""
    import numpy as np
    from readtape_tpu_torch.decode import segment as seg
    from readtape_tpu_torch.formats import tbin as tb
    from readtape_tpu_torch.synth import default_spec, synthesize_tape
    rng = np.random.default_rng(seed)
    out = np.zeros((4, S, 9), np.int16)
    for b in range(4):
        spec = default_spec(tb.MODE_GCR, ibg_secs=0.0005 if b == 3 else 0.001,
                            start_gap_secs=0.001, seed=seed + b)
        n = 150 if b == 3 else 600
        items = [("block", bytes(rng.integers(0, 256, n, dtype=np.uint8)))
                 for _ in range(2 if b == 3 else 1)]
        hdr, samples = synthesize_tape(spec, items)
        deltat = hdr.tdelta_ns * 1e-9
        st = int(0.001 / deltat) - 64 - int(2 / (9042 * 25 * deltat))
        x = samples[st:st + S].astype(np.float64)
        if b == 1:
            x += rng.normal(0.0, 0.05 / hdr.maxvolts * 32767, x.shape)
        if b == 2:
            x[:, 4] *= 0.3
        out[b, :len(x)] = np.clip(np.rint(x), -32767, 32767)
    h_est, _ = seg.host_activity(out.reshape(-1, 9), hdr.maxvolts)
    return out, h_est, deltat, hdr.maxvolts


def gcr_kernel_inputs(S, seed, nparms=5, device=DEVICE):
    """gcr_fused_scan's arguments for gcr_segments, the first nparms GCR
    parmsets."""
    from readtape_tpu_torch.decode import fused as tfu
    from readtape_tpu_torch.formats import tbin as tb
    raw, h_est, deltat, maxvolts = gcr_segments(S, seed)
    volts, seg_lens, leads, pa, kw = _segment_args(
        tb.MODE_GCR, raw, h_est, deltat, maxvolts, 9042.0, 25.0, nparms,
        device)
    spb = kw["spb"]
    steps = tfu.scan_step_budget(int(S / spb * 3.2) + 64)
    kw.update(K=steps, max_steps=steps)
    return volts, seg_lens, leads, pa, kw


def zeros_inputs(S, seed, differentiated, device=DEVICE):
    """Z1's and Z2's arguments for gcr_segments under -zeros (plain, or
    -differentiate): volts [4, 9, S], eligible windows [lead, seg_len)
    of several lengths, the 5 GCR parmsets, and (Z1's keywords, Z2's
    keywords)."""
    import torch
    from readtape_tpu_torch.formats import tbin as tb
    raw, h_est, deltat, maxvolts = gcr_segments(S, seed)
    volts, _, _, pa, kw = _segment_args(
        tb.MODE_GCR, raw, h_est, deltat, maxvolts, 9042.0, 25.0, 5, device,
        differentiate=differentiated)
    dev = volts.device
    seg_lens = torch.tensor([S, S - 2000, S, S - 5000], dtype=torch.int32,
                            device=dev)
    leads = torch.tensor([64, 300, 0, 64], dtype=torch.int32, device=dev)
    spb = kw["spb"]
    return (volts, seg_lens, leads, pa,
            dict(cap=int(S / spb * 3.2) + 64, differentiated=differentiated),
            dict(spb=spb, maxb=kw["maxb"]))


def as_volts(hdr, samples):
    """An int16 tape as the float32 volts of a CSV capture of it
    (examples/make_examples.py's conversion, without the CSV's 7
    decimals), and the maxvolts a CSV tape decodes with (32767: the
    samples are volts already)."""
    import numpy as np
    return (samples.astype(np.float64) * (hdr.maxvolts / 32767.0)).astype(
        np.float32), 32767.0


def bench_tape(seed=2026, nblocks=160, blocksize=1200):
    """bench.py's NRZI tape: 160 random blocks, a tapemark in the middle
    and one at the end."""
    from dataclasses import replace

    import numpy as np
    from readtape_tpu_torch.formats import tbin as tb
    from readtape_tpu_torch.synth import default_spec, synthesize_tape
    spec = default_spec(tb.MODE_NRZI, ibg_secs=0.005, start_gap_secs=0.005)
    rng = np.random.default_rng(seed)
    blocks = [bytes(rng.integers(0, 256, blocksize, dtype=np.uint8))
              for _ in range(nblocks)]
    items = [("block", b) for b in blocks]
    items.insert(nblocks // 2, ("tapemark",))
    items.append(("tapemark",))
    hdr, samples = synthesize_tape(replace(spec, seed=seed), items)
    return blocks, hdr, samples


def nrzi_noisy_tape(seed=1):
    """Three 420-byte NRZI blocks with noise (0.03 V rms), amplitude
    jitter (30%) and timing jitter (0.1 bit) from the synthesizer, seed 1
    (tests/test_torch_pipeline.py's noisy tape): parmset 0 fails every
    block, so the 8-parmset retry, with three window widths, runs."""
    import numpy as np
    from readtape_tpu_torch.formats import tbin as tb
    from readtape_tpu_torch.synth import default_spec, synthesize_tape
    rng = np.random.default_rng(seed)
    blocks = [bytes(rng.integers(0, 256, 420, dtype=np.uint8))
              for _ in range(3)]
    spec = default_spec(tb.MODE_NRZI, noise_rms=0.03, amp_jitter=0.3,
                        time_jitter_bits=0.1, ibg_secs=0.004,
                        start_gap_secs=0.004, seed=seed)
    return synthesize_tape(spec, [("block", b) for b in blocks])


def adjskew_tape(seed=42):
    """tests/test_cli_oracle.py's -adjskew recipe: five blocks of 200, 80,
    512, 120 and 300 bytes with a tapemark after the second, track skews
    of 0,3,1,5,2,0,4,1,2 samples, seed 42. Returns (blocks, hdr,
    samples)."""
    import numpy as np
    from readtape_tpu_torch.formats import tbin as tb
    from readtape_tpu_torch.synth import default_spec, synthesize_tape
    rng = np.random.default_rng(seed)
    spec = default_spec(tb.MODE_NRZI,
                        skew_samples=(0, 3, 1, 5, 2, 0, 4, 1, 2))
    blocks = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
              for n in (200, 80, 512, 120, 300)]
    items = [("block", b) for b in blocks]
    items.insert(2, ("tapemark",))
    return (blocks,) + synthesize_tape(spec, items)


def correctdbg_tape(seed=67):
    """tests/test_cli_oracle.py's -correctdbg recipe: three blocks of 150
    bytes, 0.04 V noise, 8% amplitude jitter, seed 67. Returns (blocks,
    hdr, samples)."""
    import numpy as np
    from readtape_tpu_torch.formats import tbin as tb
    from readtape_tpu_torch.synth import default_spec, synthesize_tape
    rng = np.random.default_rng(seed)
    blocks = [bytes(rng.integers(0, 256, 150, dtype=np.uint8))
              for _ in range(3)]
    spec = default_spec(tb.MODE_NRZI, noise_rms=0.04, amp_jitter=0.08)
    return (blocks,) + synthesize_tape(spec, [("block", b) for b in blocks])


def flipped_bit_tape(flip=90, trk=4, weak=0.4, strong=1.3):
    """tests/test_torch_correctdbg.py's tape where -correctdbg and
    -correct differ: the -correctdbg recipe's blocks without amplitude
    jitter, one data bit of track 4 flipped in frame 90 of every block
    (the CRC and LRC written for the true data), and from a fifth of each
    block on track 4 at 0.4 and the other tracks at 1.3 times their
    amplitude, so that track 4's AGC gain reaches twice the others': the
    DEBUG build's check corrects the bit. Returns (blocks, hdr,
    samples)."""
    import numpy as np
    from readtape_tpu_torch.formats import tbin as tb
    from readtape_tpu_torch.synth import default_spec, synthesize_tape
    from readtape_tpu_torch.synth import synthesize as syn
    rng = np.random.default_rng(67)
    blocks = [bytes(rng.integers(0, 256, 150, dtype=np.uint8))
              for _ in range(3)]
    frames = syn.nrzi_block_frames

    def flipped(data, spec):
        fr = list(frames(data, spec))
        fr[flip] ^= 1 << (spec.ntrks - 1 - trk)
        return fr
    syn.nrzi_block_frames = flipped
    try:
        hdr, samples = synthesize_tape(
            default_spec(tb.MODE_NRZI, noise_rms=0.01, seed=67),
            [("block", b) for b in blocks])
    finally:
        syn.nrzi_block_frames = frames
    x = samples.astype(np.float64)
    active = np.nonzero(np.abs(x).max(axis=1) > 0.3 * np.abs(x).max())[0]
    for blk in np.split(active, np.nonzero(np.diff(active) > 1000)[0] + 1):
        a, b = int(blk[0] + (blk[-1] - blk[0]) * 0.2), int(blk[-1]) + 40
        x[a:b] *= strong
        x[a:b, trk] *= weak / strong
    return blocks, hdr, np.clip(np.rint(x), -32767, 32767).astype(np.int16)


def pe_bench_tape(seed=4100, nblocks=60, blocksize=1200):
    """bench.py's PE tape: 60 random blocks of 1200 bytes."""
    from dataclasses import replace

    import numpy as np
    from readtape_tpu_torch.formats import tbin as tb
    from readtape_tpu_torch.synth import default_spec, synthesize_tape
    spec = default_spec(tb.MODE_PE, ibg_secs=0.005, start_gap_secs=0.005)
    rng = np.random.default_rng(seed)
    blocks = [bytes(rng.integers(0, 256, blocksize, dtype=np.uint8))
              for _ in range(nblocks)]
    hdr, samples = synthesize_tape(replace(spec, seed=seed),
                                   [("block", b) for b in blocks])
    return blocks, hdr, samples


def pe_short_gap_tape(seed=89, noise_v=0.06):
    """Three 90-byte PE blocks behind 0.6 ms gaps (tests/test_multiblock.py's
    short-gap recipe) plus numpy noise of noise_v V rms: tau fires, the
    walk hops and the 8-parmset retry runs."""
    import numpy as np
    from readtape_tpu_torch.formats import tbin as tb
    from readtape_tpu_torch.synth import default_spec, synthesize_tape
    rng = np.random.default_rng(seed)
    blocks = [bytes(rng.integers(0, 256, 90, dtype=np.uint8))
              for _ in range(3)]
    spec = default_spec(tb.MODE_PE, ibg_secs=0.0006, start_gap_secs=0.003)
    hdr, samples = synthesize_tape(spec, [("block", b) for b in blocks])
    x = samples.astype(np.float64) + rng.normal(
        0.0, noise_v / hdr.maxvolts * 32767, samples.shape)
    return hdr, np.clip(np.rint(x), -32767, 32767).astype(np.int16)


def gcr_bench_tape(seed=5100, nblocks=40, blocksize=1200):
    """bench.py's GCR tape: 40 random blocks of 1200 bytes, 9042 bpi, 25
    ips."""
    from dataclasses import replace

    import numpy as np
    from readtape_tpu_torch.formats import tbin as tb
    from readtape_tpu_torch.synth import default_spec, synthesize_tape
    spec = default_spec(tb.MODE_GCR, ibg_secs=0.005, start_gap_secs=0.005)
    rng = np.random.default_rng(seed)
    blocks = [bytes(rng.integers(0, 256, blocksize, dtype=np.uint8))
              for _ in range(nblocks)]
    hdr, samples = synthesize_tape(replace(spec, seed=seed),
                                   [("block", b) for b in blocks])
    return blocks, hdr, samples


def gcr_diff_bench_tape(seed=5100, nblocks=40, blocksize=1200):
    """9trk_GCR/example3's recipe (pulses 0.45 bits wide, no noise) at the
    GCR bench tape's length: 40 random blocks of 1200 bytes, 5 ms gaps,
    seed 5100, as float32 volts (as_volts). Returns (blocks, header,
    volts); it decodes with -differentiate -zeros."""
    from dataclasses import replace

    import numpy as np
    from readtape_tpu_torch.formats import tbin as tb
    from readtape_tpu_torch.synth import default_spec, synthesize_tape
    spec = default_spec(tb.MODE_GCR, pulse_width_bits=0.45, noise_rms=0.0,
                        ibg_secs=0.005, start_gap_secs=0.005)
    rng = np.random.default_rng(seed)
    blocks = [bytes(rng.integers(0, 256, blocksize, dtype=np.uint8))
              for _ in range(nblocks)]
    hdr, samples = synthesize_tape(replace(spec, seed=seed),
                                   [("block", b) for b in blocks])
    return blocks, hdr, as_volts(hdr, samples)[0]


def gcr_short_gap_tape(seed=7, noise_v=0.07):
    """Three 80-byte GCR blocks behind 0.5 ms gaps and a 3 ms start gap
    (tests/test_multiblock.py's GCR short-gap recipe) plus numpy noise of
    noise_v V rms; blocks and noise from one generator seeded `seed`."""
    import numpy as np
    from readtape_tpu_torch.formats import tbin as tb
    from readtape_tpu_torch.synth import default_spec, synthesize_tape
    rng = np.random.default_rng(seed)
    blocks = [bytes(rng.integers(0, 256, 80, dtype=np.uint8))
              for _ in range(3)]
    spec = default_spec(tb.MODE_GCR, ibg_secs=0.0005, start_gap_secs=0.003)
    hdr, samples = synthesize_tape(spec, [("block", b) for b in blocks])
    x = samples.astype(np.float64) + rng.normal(
        0.0, noise_v / hdr.maxvolts * 32767, samples.shape)
    return hdr, np.clip(np.rint(x), -32767, 32767).astype(np.int16)


def gcr_merged_tape():
    """tests/test_multiblock.py's GCR short-gap tape (three 80-byte blocks,
    seed 91) with a flat 0.5 V level on track 0 across the first gap: one
    segment holds the first two blocks, the all-idle point ends the first
    and a multi-block round decodes the second."""
    import numpy as np
    from readtape_tpu_torch.decode import pipeline as tpl
    from readtape_tpu_torch.formats import tbin as tb
    from readtape_tpu_torch.synth import default_spec, synthesize_tape
    rng = np.random.default_rng(91)
    blocks = [bytes(rng.integers(0, 256, 80, dtype=np.uint8))
              for _ in range(3)]
    spec = default_spec(tb.MODE_GCR, ibg_secs=0.0005, start_gap_secs=0.003)
    hdr, samples = synthesize_tape(spec, [("block", b) for b in blocks])
    opts = tape_options(hdr, tb.MODE_GCR, 9042, 25)
    (_, b1), (a2, _) = tpl.TapeDecoder(samples, opts,
                                       device="cpu").segments()[:2]
    samples = np.array(samples)
    samples[b1 - int(7 * opts.spb):a2 + int(opts.spb), 0] += np.int16(
        0.5 / hdr.maxvolts * 32767)
    return hdr, samples


def tape_options(hdr, mode, bpi, ips=50.0, **kw):
    """decode_tape's options for a synthesized tape; kw overrides (for
    example maxvolts=32767 for its float volts, find_zeros=True)."""
    from readtape_tpu_torch.decode import pipeline as tpl
    return tpl.DecodeOptions(**dict(dict(
        mode=mode, ntrks=hdr.ntrks, bpi=bpi, ips=ips,
        deltat=hdr.tdelta_ns * 1e-9, maxvolts=hdr.maxvolts), **kw))


def _words_bytes(words):
    return b"".join(bytes([w >> 8, w & 0xFF]) for w in words)


def ww_tape(seed=61, sizes=(64, 120, 96)):
    """A 6-track Whirlwind tape for phase 3 (about 160,000 samples): blocks
    of `sizes` words with a tapemark after the first, numpy noise of 0.05
    V rms and a weak track 2 (the primary LSB, x0.6: still above min_peak,
    so it is admitted), from one generator seeded `seed`. Returns
    (expected data blocks, header, int16 samples)."""
    import numpy as np
    from readtape_tpu_torch.formats import tbin as tb
    from readtape_tpu_torch.synth import default_spec, synthesize_tape
    rng = np.random.default_rng(seed)
    words = [[int(w) for w in rng.integers(0, 65536, n)] for n in sizes]
    items = [("block", words[0]), ("tapemark",)]
    items += [("block", w) for w in words[1:]]
    hdr, samples = synthesize_tape(default_spec(tb.MODE_WW, seed=seed),
                                   items)
    x = samples.astype(np.float64)
    x[:, 2] *= 0.6
    x += rng.normal(0.0, 0.05 / hdr.maxvolts * 32767, x.shape)
    return ([_words_bytes(w) for w in words], hdr,
            np.clip(np.rint(x), -32767, 32767).astype(np.int16))


def ww_bench_tape(seed=6100, nblocks=12, nwords=400):
    """bench.py's Whirlwind tape: 12 random blocks of 400 words, 5 ms
    gaps (about 2.6 million samples). nblocks=24 makes the long tape,
    beyond the rolling base's span of 2^22 samples."""
    from dataclasses import replace

    import numpy as np
    from readtape_tpu_torch.formats import tbin as tb
    from readtape_tpu_torch.synth import default_spec, synthesize_tape
    spec = default_spec(tb.MODE_WW, ibg_secs=0.005, start_gap_secs=0.005)
    rng = np.random.default_rng(seed)
    words = [[int(w) for w in rng.integers(0, 65536, nwords)]
             for _ in range(nblocks)]
    hdr, samples = synthesize_tape(replace(spec, seed=seed),
                                   [("block", w) for w in words])
    return [_words_bytes(w) for w in words], hdr, samples


def ww_deskew_tape():
    """Two blocks of 32 and 16 words and a tapemark with per-track skews
    of up to 7 samples, for -deskew."""
    import numpy as np
    from readtape_tpu_torch.formats import tbin as tb
    from readtape_tpu_torch.synth import default_spec, synthesize_tape
    rng = np.random.default_rng(44)
    w = [int(x) for x in rng.integers(0, 65536, 32)]
    spec = default_spec(tb.MODE_WW, skew_samples=(0, 4, 2, 7, 1, 3))
    return synthesize_tape(spec, [("block", w), ("tapemark",),
                                  ("block", w[:16])])


def ww_options(hdr, fluxdir="neg", **kw):
    """decode_tape's options for a synthesized Whirlwind tape, as the
    command line -whirlwind -fluxdir=<fluxdir> resolves them."""
    from readtape_tpu_torch.decode import pipeline as tpl
    from readtape_tpu_torch.formats import tbin as tb
    return tpl.DecodeOptions(mode=tb.MODE_WW, ntrks=6, bpi=100, ips=30,
                             deltat=hdr.tdelta_ns * 1e-9,
                             maxvolts=hdr.maxvolts,
                             ww_order=hdr.trkorder or "CMLcml",
                             fluxdir=fluxdir, multiple_tries=False, **kw)


def call_of(module, name, run, index=0):
    """(args, kwargs) of the first call (or the index-th, from 0) of
    module.<name> that run() makes; the function is wrapped only while
    run() runs."""
    seen = []
    fn = getattr(module, name)

    def record(*args, **kw):
        if len(seen) <= index:
            seen.append((args, kw))
        return fn(*args, **kw)
    setattr(module, name, record)
    try:
        run()
    finally:
        setattr(module, name, fn)
    if len(seen) <= index:
        raise AssertionError(f"{len(seen)} calls of {name}")
    return seen[index]


def first_call(module, name, samples, opts, kernel_path="fused", index=0):
    """call_of for the calls that decode_tape makes on `samples`: the
    shape the main path gives module.<name>."""
    from readtape_tpu_torch.decode import pipeline as tpl
    return call_of(module, name, lambda: tpl.decode_tape(
        samples, opts, device=DEVICE, kernel_path=kernel_path), index)


def main_path_inputs(launcher, samples, opts, index=0):
    """The arguments of the first (or index-th) launch of
    kernels.<launcher> that decode_tape makes on `samples`: the shape the
    main path gives that kernel. The launcher is wrapped only for this one
    decode."""
    from readtape_tpu_torch import kernels
    (volts, seg_lens, leads, pa), kw = first_call(kernels, launcher, samples,
                                                  opts, index=index)
    return volts, seg_lens, leads, pa, kw


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_of(n_bytes, ops):
    """The least time (ms) the card could take for one call that must
    move n_bytes and do ops f32 operations: the larger of the bytes over
    the memory rate and the operations over the f32 rate. Returns (ms,
    "bytes" | "operations")."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(name, volts, out, ops):
    """bound_of for a call that reads volts once and writes out once."""
    return bound_of(nbytes([volts]) + nbytes(out.values()), ops)


def kernel_ops(volts, kw, n_steps):
    """f32 operations this call does on its inputs: the candidacy pass
    (a running max and min over each window width at every sample of every
    lane and track) plus ~60 per admission step (thresholds, refinement,
    AGC and clock updates), counted from this run's admitted steps."""
    B, T, S = volts.shape
    P = len(kw["Ws"])
    return 2 * B * P * T * S * sum(set(kw["Ws"])) + 60 * n_steps


def time_launches(fn, reps):
    """Mean ms of one fn() on the card: CUDA events around reps calls
    after one warm-up call."""
    import torch
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def check_equal(name, got, want):
    """Every output of a kernel equal to its plain version's: integers
    and bits exactly, f32 within F32_TOL. Returns the max f32 error."""
    import torch
    err = 0.0
    for k in want:
        if want[k].dtype == torch.float32:
            err = max(err, float((got[k] - want[k]).abs().max()))
        elif not torch.equal(got[k], want[k]):
            bad = (got[k] != want[k]).nonzero()[:5].tolist()
            raise AssertionError(f"{name}: {k} differs at {bad}")
    if not err <= F32_TOL:
        raise AssertionError(f"{name}: f32 fields differ by {err}")
    return err


def plain_on_host(plain, *args, **kw):
    """(plain(*args, **kw) run on host copies of its tensor arguments,
    its outputs moved back to the card; its ms). The plain versions take
    a host round trip per step on the card and run two to three times
    faster on the host, with the same results: their f32 operations
    round alike on both devices (common.fma, common.fdiv; PERF.md, PR
    17)."""
    from readtape_tpu_torch.parallel.mesh import tree_map
    t0 = time.perf_counter()
    out = plain(*tree_map(lambda t: t.cpu(), args),
                **tree_map(lambda t: t.cpu(), kw))
    ms = (time.perf_counter() - t0) * 1e3
    return tree_map(lambda t: t.to(DEVICE), out), ms


def chain_note(n, what, ms):
    """The longest dependent chain of a launch (n links: admissions,
    slots, steps or events) and the kernel's time per link, for phase
    3's lines: what a redesign of a serial kernel moves."""
    return f"longest chain {n} {what}, {ms * 1e6 / max(n, 1):.0f} ns per link"


def compare_kernel(name, kernel, volts, seg_lens, leads, pa, kw, reps=10):
    """One launch of `kernel` (a decode.fused wrapper's name) against its
    plain version on a host copy of the same inputs (plain_on_host), then
    the mean of reps
    launches. Returns a dict with the max abs f32 error, kernel ms, plain
    ms and the bound."""
    import torch
    from readtape_tpu_torch.decode import fused as tfu
    kern = getattr(tfu, kernel)
    plain = getattr(tfu, kernel + "_plain")
    got = kern(volts, seg_lens, leads, pa, **kw)
    sync()
    want, t_plain = plain_on_host(plain, volts, seg_lens, leads, pa, **kw)
    err = check_equal(name, got, want)
    ti = want["trk_i"]
    dc, nadm = {"nrzi_fused_scan": (tfu.TI_DC, tfu.TI_NADM),
                "pe_fused_scan": (tfu.PI_DC, tfu.PI_NTOTAL),
                "gcr_fused_scan": (tfu.GI_DC, tfu.GI_NTOTAL)}[kernel]
    # a record mode's (-trace's) blocks are not read: its records are
    if int(want["rec_n"].max() if kw.get("trace_scan")
           else ti[..., dc].max()) < 150:
        raise AssertionError(f"{name}: segments decoded too little")
    n_adm = int(ti[..., nadm].sum())
    # a lane's longest track admits, then (NRZI) its slot machine runs
    chain, what = int(ti[..., nadm].max()), "admissions"
    if kernel == "nrzi_fused_scan":
        chain += int(want["lane_i"][..., tfu.LI_NSLOT].max())
        what = "admissions + slots"
    t_kern = time_launches(lambda: kern(volts, seg_lens, leads, pa, **kw),
                           reps)
    b_ms, b_by = bound(name, volts, want, kernel_ops(volts, kw, n_adm))
    B, T, S = volts.shape
    print(f"  {name} (B={B} P={len(kw['Ws'])} T={T} S={S}): kernel "
          f"{t_kern:.3f} ms, plain on the host {t_plain:.1f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}), {chain_note(chain, what, t_kern)}, "
          f"equal (max f32 err {err})", flush=True)
    return dict(err=err, ms=t_kern, plain_ms=t_plain, bound_ms=b_ms,
                bound_by=b_by, out=want)


def ww_ops(volts, out, W):
    """f32 operations of one ww_fused_scan call on its inputs: the
    candidacy pass (a running max and min over the window at every sample
    of every track), ~60 per admission (thresholds, refinement, AGC) and
    ~100 per merged event (merge, pulse/clock/blockmark machine), counted
    from this run's admissions and events."""
    from readtape_tpu_torch.decode import fused as tfu
    T, S = volts.shape
    n_adm = int(out["trk_i"][:, tfu.WT_NADM].sum())
    n_ev = int(out["scal"][tfu.WS_NEVENTS])
    return 2 * T * S * W + 60 * n_adm + 100 * n_ev


def compare_ww(name, volts, kw, min_blocks=3, reps=3, timed=None):
    """One ww_fused_scan launch on the card against ww_fused_scan_plain
    on host copies of the same inputs: every output equal, integers,
    characters and floats (F32_TOL); at least min_blocks blocks and 1000
    characters. timed: other volts (the whole tape, of which `volts` is a
    prefix) at which the kernel is timed and its bound and chain counted
    instead. Returns compare_kernel's dict."""
    from readtape_tpu_torch.decode import fused as tfu
    got = tfu.ww_fused_scan(volts, **kw)
    sync()
    want, t_plain = plain_on_host(tfu.ww_fused_scan_plain, volts, **kw)
    err = check_equal(name, got, want)
    sc = want["scal"]
    if int(sc[tfu.WS_NBLOCKS]) < min_blocks or \
            int(sc[tfu.WS_DATACOUNT]) < 1000:
        raise AssertionError(f"{name}: the tape decoded too little")
    note = ""
    if timed is not None:
        note = (f" (held to the plain version on the first "
                f"{volts.shape[1]:,} samples, {int(sc[tfu.WS_NBLOCKS])} "
                f"blocks)")
        volts = timed
        want = tfu.ww_fused_scan(volts, **kw)
        sc = want["scal"]
    t_kern = time_launches(lambda: tfu.ww_fused_scan(volts, **kw), reps)
    b_ms, b_by = bound(name, volts, want, ww_ops(volts, want, kw["W"]))
    T, S = volts.shape
    # the longest track's admission steps, then the machine's events
    chain = (int(want["trk_i"][:, tfu.WT_STEPS].max())
             + int(sc[tfu.WS_NEVENTS]))
    print(f"  {name} (T={T} S={S} span={kw['span']}): kernel {t_kern:.3f} "
          f"ms, plain on the host {t_plain:.1f} ms{note}, bound "
          f"{b_ms:.4f} ms ({b_by}), {int(sc[tfu.WS_NEVENTS])} events, base "
          f"{int(sc[tfu.WS_BASE])}, "
          f"{chain_note(chain, 'steps + events', t_kern)}, equal (max f32 "
          f"err {err})", flush=True)
    return dict(err=err, ms=t_kern, plain_ms=t_plain, bound_ms=b_ms,
                bound_by=b_by, out=want)


WW_PREFIX = 786_432        # 30% of the WW bench tape's window: 4 blocks


def phase_ww_kernel():
    """B4: kernel vs plain on ww_tape, once as the decode gives it
    (-fluxdir=auto) and once with a rolling-base span of 2^14 samples;
    then on the bench tape as decode_tape hands it (the main path's
    shape), timed there, and held to the plain version on the first
    WW_PREFIX samples of the same inputs: the whole tape's ~300,000
    events take the plain version about 2 minutes on the host."""
    from readtape_tpu_torch import kernels
    from readtape_tpu_torch.decode import fused as tfu
    res = {}
    _, hdr, samples = ww_tape()
    (volts,), kw = first_call(kernels, "ww_fused", samples,
                              ww_options(hdr, "auto"))
    res["ww noisy"] = compare_ww("ww noisy", volts, kw)
    span = 1 << 14
    r = res["ww rebase"] = compare_ww("ww rebase", volts, dict(kw, span=span))
    # events are never more than 2,000 samples apart on this tape, so each
    # move of the base lands within span + 2,000 of the last one
    if int(r["out"]["scal"][tfu.WS_BASE]) <= 2 * (span + 2000):
        raise AssertionError("ww rebase: the base moved fewer than 3 times")
    _, hdr, samples = ww_bench_tape()
    (volts,), kw = first_call(kernels, "ww_fused", samples, ww_options(hdr))
    t0 = time.perf_counter()
    res["ww main"] = compare_ww("ww main", volts[:, :WW_PREFIX].contiguous(),
                                kw, timed=volts)
    print(f"  ww main: the comparison took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return res


def tiered_inputs(volts, seg_lens, leads, pa, kw, nparms):
    """The tiered path's admission inputs for the first nparms parmsets
    of nrzi_fused_scan's arguments, built as _nrzi_group_tiered builds
    them: (window features, masked union jump table, parmsets, scan
    kwargs)."""
    from readtape_tpu_torch.decode import fused as tfu
    from readtape_tpu_torch.decode import scan
    Ws = kw["Ws"][:nparms]
    nxt = tfu._mask_jump_table(
        tfu._union_jump_table(volts, Ws, kw["rise_floor"], kw["min_floor"]),
        seg_lens, leads, volts.shape[-1])
    return (scan.window_features(volts, Ws), nxt, pa.select(range(nparms)),
            dict(Ws=Ws, K=kw["K"]))


def p15_inputs(volts, seg_lens, leads, pa, kw):
    """B5a's arguments with 15 parmsets, the most a parms file holds:
    kernel_inputs' 8 builtin ones and 7 more with wider windows (bitfrac
    + 0.15) and a lower rise (x 0.6), six widths in all, so the kernel
    takes two blocks per (segment, track); under kernel_inputs' XLA step
    budget, which binds on the noisy segment's lanes and not on the clean
    ones'."""
    import dataclasses

    import torch
    from readtape_tpu_torch.decode import common as cm
    pa15 = pa.select(list(range(8)) + list(range(7)))
    more = (torch.arange(15, device=volts.device) >= 8).float()
    pa15 = dataclasses.replace(
        pa15, pkww_bitfrac=pa15.pkww_bitfrac + 0.15 * more,
        pkww_rise=pa15.pkww_rise * (1.0 - 0.4 * more))
    deltat = 1.0 / (800.0 * 50.0 * kw["spb"])
    Ws = tuple(cm.pkww_width_for(f, 800.0, 50.0, deltat)
               for f in pa15.pkww_bitfrac.tolist())
    feat, nxt, pa15, skw = tiered_inputs(volts, seg_lens, leads, pa15,
                                         dict(kw, Ws=Ws), 15)
    return feat, nxt, pa15, dict(skw, max_steps=kw["max_steps"])


def compare_scan(name, kernel, feat, nxt, pa, kw, reps=10):
    """One launch of B5a or B5b (`kernel`) against its plain version on
    host copies of the same inputs; compare_kernel's dict, with the
    kernel's outputs as "out". The bound counts each admission's feature
    row and jump-table entry read once (rejected steps are not counted)
    and every output written once; ~60 f32 operations per admission."""
    fn, plain = wrapper(kernel)
    got = fn(feat, nxt, pa, **kw)
    sync()
    want, t_plain = plain_on_host(plain, feat, nxt, pa, **kw)
    err = check_equal(name, got, want)
    n_adm = int(want["n_admitted"].sum())
    if int(want["n_admitted"].max()) < 150:
        raise AssertionError(f"{name}: segments admitted too little")
    t_kern = time_launches(lambda: fn(feat, nxt, pa, **kw), reps)
    b_ms, b_by = bound_of(n_adm * (10 * 4 + 4) + nbytes(want.values()),
                          60 * n_adm)
    G, B, T, S, _ = feat.shape
    chain = int(want["n_admitted"].max())
    print(f"  {name} (B={B} P={len(kw['Ws'])} G={G} T={T} S={S}): kernel "
          f"{t_kern:.3f} ms, plain on the host {t_plain:.1f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}), {n_adm} admissions, "
          f"{chain_note(chain, 'admissions', t_kern)}, equal (max f32 err "
          f"{err})", flush=True)
    return dict(err=err, ms=t_kern, plain_ms=t_plain, bound_ms=b_ms,
                bound_by=b_by, out=got)


def compare_slot(name, fin, pa, kw, must_correct=None, reps=10):
    """One launch of B6 against its plain version on host copies of the
    same buffers; compare_kernel's dict. The bound counts each admitted
    transition's (s, t, agc) read once, -adjskew's seeds read once and
    every output written once; ~40 f32 operations per track and slot.
    must_correct:
    True, -correct must flip a bit somewhere; a [B, P] bool mask, in
    every lane it holds (at least one)."""
    from readtape_tpu_torch.decode import fused as tfu
    from readtape_tpu_torch.decode import slot
    got = slot.nrzi_slot_scan(fin, pa, **kw)
    sync()
    want, t_plain = plain_on_host(slot.nrzi_slot_scan_plain, fin, pa, **kw)
    err = check_equal(name, got, want)
    if int(want["trk_i"][..., tfu.TI_DC].max()) < 150:
        raise AssertionError(f"{name}: segments decoded too little")
    B, P, T, K = fin["tr_s"].shape
    n_tr = int(fin["n_admitted"].clamp(max=K).sum())
    n_slots = int(want["lane_i"][..., tfu.LI_NSLOT].sum())
    t_kern = time_launches(lambda: slot.nrzi_slot_scan(fin, pa, **kw), reps)
    seeds = kw.get("adj_init") or ()
    b_ms, b_by = bound_of(n_tr * 12 + nbytes(seeds) + nbytes(want.values()),
                          40 * T * n_slots)
    corr = int(want["lane_i"][..., tfu.LI_CORR].sum())
    flipped = want["lane_i"][..., tfu.LI_CORR] > 0
    if must_correct is True and not bool(flipped.any()):
        raise AssertionError(f"{name}: -correct flipped no bit")
    if must_correct is not None and must_correct is not True and not (
            bool(must_correct.any())
            and bool(flipped[must_correct.to(flipped.device)].all())):
        raise AssertionError(f"{name}: -correct flipped no bit in a lane "
                             f"that needs it")
    chain = int(want["lane_i"][..., tfu.LI_NSLOT].max())
    print(f"  {name} (B={B} P={P} T={T} K={K}): kernel {t_kern:.3f} ms, "
          f"plain on the host {t_plain:.1f} ms, bound {b_ms:.4f} ms ({b_by}), "
          f"{n_slots} slots, {corr} corrected, "
          f"{chain_note(chain, 'slots', t_kern)}, equal (max f32 err "
          f"{err})", flush=True)
    return dict(err=err, ms=t_kern, plain_ms=t_plain, bound_ms=b_ms,
                bound_by=b_by)


def drop_first_bits(fin, spb):
    """B5's outputs with, in every lane, one track's transition in the
    block's first frame removed (column 0, which the release binary's
    parity check reads) and that track's AGC gain at 5.0, more than twice
    the AGC's cap of 2 that bounds the others', so that -correct flips
    the bit back (tests/test_torch_slot.py's -correct case, per lane)."""
    import torch
    host = {k: v.cpu().clone() for k, v in fin.items()}
    s, t, agc, n = (host[k] for k in ("tr_s", "tr_t", "tr_agc",
                                      "n_admitted"))
    B, P, T, K = s.shape
    for b in range(B):
        for p in range(P):
            first = int(torch.argmin(s[b, p, :, 0]))
            ks = [k for k in range(T) if k != first and n[b, p, k] > 0
                  and t[b, p, k, 0] < t[b, p, first, 0] + spb / 2]
            if not ks:
                continue
            k = ks[0]
            for buf, fill in ((s, 2 ** 30), (t, 0.0), (agc, 1.0)):
                buf[b, p, k, :-1] = buf[b, p, k, 1:].clone()
                buf[b, p, k, -1] = fill
            n[b, p, k] -= 1
            agc[b, p, k, :int(n[b, p, k])] = 5.0
    return {k: v.to(fin[k].device) for k, v in host.items()}


def drop_mid_bits(fin, spb, frame=40):
    """B5's outputs with, in every lane, one track's transition in the
    block's frame `frame` removed and that track's AGC gain at 5.0, so
    that the DEBUG build's -correct flips the bit back in that column
    (tests/test_torch_correctdbg.py's mid-block case, per lane); lanes
    with nothing there are left as they are. Returns (the buffers, [B, P]
    bool: the lanes that lost a transition)."""
    import torch
    host = {k: v.cpu().clone() for k, v in fin.items()}
    s, t, agc, n = (host[k] for k in ("tr_s", "tr_t", "tr_agc",
                                      "n_admitted"))
    B, P, T, K = s.shape
    dropped = torch.zeros((B, P), dtype=torch.bool)
    for b in range(B):
        for p in range(P):
            if int(n[b, p].max()) < frame + 10:
                continue
            t0 = t[b, p, int(torch.argmin(s[b, p, :, 0])), 0]
            valid = torch.arange(K) < n[b, p].unsqueeze(-1)
            d = torch.where(valid, (t[b, p] - (t0 + frame * spb)).abs(),
                            float("inf"))
            near, j_of = d.min(dim=-1)             # per track
            hit = (near < spb / 2).nonzero()
            if not len(hit):
                continue
            k = int(hit[0, 0])
            j = int(j_of[k])
            for buf, fill in ((s, 2 ** 30), (t, 0.0), (agc, 1.0)):
                buf[b, p, k, j:-1] = buf[b, p, k, j + 1:].clone()
                buf[b, p, k, -1] = fill
            n[b, p, k] -= 1
            agc[b, p, k, :int(n[b, p, k])] = 5.0
            dropped[b, p] = True
    return {k: v.to(fin[k].device) for k, v in host.items()}, dropped


def phase_option_kernel():
    """B6 in the two modes only -adjskew and -correctdbg run, and the
    admission each takes, against their plain versions at the first
    launch each makes on the NRZI bench tape: -adjskew's B=1, P=1 (the
    first segment; B5b, then B6 seeded with random non-zero accumulators,
    numpy seed 13), -correctdbg's B=16, P=8 (B5a: the 8 parmsets have
    three window widths; then B6 with the DEBUG build's -correct, and
    again with one mid-block transition per lane dropped and that track's
    gain raised, so that the check flips a bit in every lane)."""
    import dataclasses

    import numpy as np
    import torch
    from readtape_tpu_torch import kernels
    from readtape_tpu_torch.formats import tbin as tb
    _, hdr, samples = bench_tape()
    base = tape_options(hdr, tb.MODE_NRZI, 800)
    adj = dataclasses.replace(base, adjskew=True)
    dbg = dataclasses.replace(base, do_correct=True, do_correct_debug=True)
    res = {}
    (feat, nxt, pa), kw = first_call(kernels, "nrzi_scan_tracks", samples,
                                     adj)
    res["b5b adjskew"] = compare_scan("b5b adjskew", "nrzi_track_scan_tracks",
                                      feat, nxt, pa, kw)
    del feat, nxt
    (fin, pa), kw = first_call(kernels, "nrzi_slot", samples, adj)
    B, P, T, _ = fin["tr_s"].shape
    rng = np.random.default_rng(13)
    kw["adj_init"] = (
        torch.as_tensor(rng.integers(1, 60, (B, P, T)).astype(np.float32),
                        device=DEVICE),
        torch.as_tensor(rng.uniform(-3, 3, (B, P, T)).astype(np.float32),
                        device=DEVICE))
    res["b6 adjskew"] = compare_slot("b6 adjskew", fin, pa, kw)
    (feat, nxt, pa), kw = first_call(kernels, "nrzi_scan", samples, dbg)
    res["b5a correctdbg"] = compare_scan("b5a correctdbg", "nrzi_track_scan",
                                         feat, nxt, pa, kw)
    del feat, nxt
    (fin, pa), kw = first_call(kernels, "nrzi_slot", samples, dbg)
    res["b6 correctdbg"] = compare_slot("b6 correctdbg", fin, pa, kw)
    fin, dropped = drop_mid_bits(fin, kw["spb"])
    res["b6 correctdbg-drop"] = compare_slot("b6 correctdbg-drop", fin, pa,
                                             kw, must_correct=dropped)
    return res


def slot_kwargs(kw, S, do_correct):
    """nrzi_slot_scan's arguments beside its buffers, from
    nrzi_fused_scan's."""
    return dict(S=S, spb=kw["spb"], expected_parity=1,
                do_correct=do_correct, maxb=kw["maxb"],
                max_slots=kw["max_slots"], stat_lb=kw["stat_lb"],
                stat_bw=kw["stat_bw"])


def phase_tiered_kernel():
    """B5a, B5b and B6 against their plain versions on the card: on
    kernel_inputs' segments (B5a with all 8 parmsets and their three
    window widths, B5b with parmset 0, B6 over B5a's buffers, and under
    -correct over them with one first-frame bit per lane removed; the
    same, without -correct, on 7-track segments; B5a also with 15
    parmsets, two blocks per (segment, track), under a step budget that
    stops some lanes and not others), then each at the first batch that
    phase 4's tiered decode hands it (B5b and B6 on the NRZI bench tape's
    first pass, B5a on the noisy tape's retry); B5b also at the bench
    decode's second batch and at density detection's launch."""
    import dataclasses

    from readtape_tpu_torch import kernels
    from readtape_tpu_torch.formats import tbin as tb
    res = {}
    for T in (9, 7):
        volts, seg_lens, leads, pa, kw = kernel_inputs(T, 16384, False,
                                                       seed=5)
        S = volts.shape[-1]
        tag = f"{T}trk"
        feat, nxt, pa8, skw = tiered_inputs(volts, seg_lens, leads, pa, kw,
                                            8)
        r = res[f"b5a {tag}"] = compare_scan(f"b5a {tag}", "nrzi_track_scan",
                                             feat, nxt, pa8, skw)
        fin = r.pop("out")
        del feat, nxt
        res[f"b6 {tag}"] = compare_slot(f"b6 {tag}", fin, pa8,
                                        slot_kwargs(kw, S, False))
        if T == 9:
            res["b6 9trk-correct"] = compare_slot(
                "b6 9trk-correct", drop_first_bits(fin, kw["spb"]), pa8,
                slot_kwargs(kw, S, True), must_correct=True)
        if T == 9:
            feat, nxt, pa1, skw = tiered_inputs(volts, seg_lens, leads, pa,
                                                kw, 1)
            res[f"b5b {tag}"] = compare_scan(f"b5b {tag}",
                                             "nrzi_track_scan_tracks",
                                             feat, nxt, pa1, skw)
            feat, nxt, pa15, skw = p15_inputs(volts, seg_lens, leads, pa, kw)
            r = res["b5a p15"] = compare_scan("b5a p15", "nrzi_track_scan",
                                              feat, nxt, pa15, skw)
            out = r.pop("out")
            inc, nadm = out["incomplete"], out["n_admitted"]
            if not (bool(inc.any()) and not bool(inc.all())
                    and int(nadm.max()) <= skw["K"]):
                raise AssertionError(
                    f"b5a p15: the budget stopped {int(inc.sum())} of "
                    f"{inc.numel()} lanes, or K overflowed")
            print(f"  b5a p15: the budget of {skw['max_steps']} steps "
                  f"stopped {int(inc.sum())} of {inc.numel()} lanes",
                  flush=True)
            del feat, nxt, out
    _, hdr, samples = bench_tape()
    opts = tape_options(hdr, tb.MODE_NRZI, 800)
    # B5b at the tiered decode's two batches (B=128, then 34) and at
    # density detection's (B=1, window 8, the XLA scan's step budget)
    for case, o, path, index in (
            ("b5b main", opts, "tiered", 0), ("b5b main2", opts, "tiered", 1),
            ("b5b density", dataclasses.replace(opts, bpi=0.0), "fused", 0)):
        (feat, nxt, pa), kw = first_call(kernels, "nrzi_scan_tracks", samples,
                                         o, path, index=index)
        res[case] = compare_scan(case, "nrzi_track_scan_tracks", feat, nxt,
                                 pa, kw)
        del feat, nxt
    (fin, pa), kw = first_call(kernels, "nrzi_slot", samples, opts,
                               "tiered")
    res["b6 main"] = compare_slot("b6 main", fin, pa, kw)
    del fin
    hdr, samples = nrzi_noisy_tape()
    (feat, nxt, pa), kw = first_call(kernels, "nrzi_scan", samples,
                                     tape_options(hdr, tb.MODE_NRZI, 800),
                                     "tiered")
    res["b5a main"] = compare_scan("b5a main", "nrzi_track_scan", feat, nxt,
                                   pa, kw)
    return res


def compare_zc(name, volts, seg_lens, leads, kw):
    """One launch of Z1 against its plain version on host copies of the
    same inputs; compare_kernel's dict, with the kernel's lists as
    "out". The bound reads the volts once and writes the lists once; ~5
    f32 operations (abs, compares, max) per sample. The chain: the plain
    variant's pass B, one step per significant phase (a lane's longest
    list); the differentiated variant has no serial pass."""
    from readtape_tpu_torch.decode import zeros
    got = zeros.zerocross_transitions(volts, seg_lens, leads, **kw)
    sync()
    want, t_plain = plain_on_host(zeros.zerocross_transitions_plain, volts,
                                  seg_lens, leads, **kw)
    err = check_equal(name, got, want)
    if int(want["ok"].sum(dim=-1).max()) < 150:
        raise AssertionError(f"{name}: too few transitions")
    t_kern = time_launches(
        lambda: zeros.zerocross_transitions(volts, seg_lens, leads, **kw), 10)
    b_ms, b_by = bound_of(nbytes([volts]) + nbytes(want.values()),
                          5 * volts.numel())
    B, T, S = volts.shape
    chain = ("no serial pass" if kw["differentiated"] else chain_note(
        int(want["valid"].sum(dim=-1).max()), "significant phases", t_kern))
    print(f"  {name} (B={B} T={T} S={S} cap={kw['cap']}): kernel "
          f"{t_kern:.3f} ms, plain on the host {t_plain:.1f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}), {int(want['valid'].sum())} transitions, "
          f"{int(want['overflow'].sum())} segments over cap, {chain}, "
          f"equal (max f32 err {err})", flush=True)
    return dict(err=err, ms=t_kern, plain_ms=t_plain, bound_ms=b_ms,
                bound_by=b_by, out=got)


def compare_zs(name, trans, pa, kw):
    """One launch of Z2 against its plain version on host copies of the
    same inputs; compare_kernel's dict. The bound reads each track's valid
    list entries (t, dt, ok, valid) once and writes the bits and
    per-track fields once; ~30 f32 operations per emitted transition.
    The chain is the longest walker's admitted (emitted) transitions."""
    from readtape_tpu_torch.decode import zeros
    got = zeros.gcr_zeros_scan(trans, pa, **kw)
    sync()
    want, t_plain = plain_on_host(zeros.gcr_zeros_scan_plain, trans, pa,
                                  **kw)
    err = check_equal(name, got, want)
    if int(want["datacount"].max()) < 150:
        raise AssertionError(f"{name}: segments decoded too little")
    t_kern = time_launches(lambda: zeros.gcr_zeros_scan(trans, pa, **kw), 10)
    n_emit = int(want["peakcount"].sum())
    b_ms, b_by = bound_of(
        int(trans["valid"].sum()) * 10
        + nbytes([got[k] for k in ("bits", "datacount", "peakcount",
                                   "t_firstbit", "t_lastbit")]),
        30 * n_emit)
    B, P, T = want["datacount"].shape
    chain = int(want["peakcount"].max())
    print(f"  {name} (B={B} P={P} T={T} cap={trans['t'].shape[-1]}): "
          f"kernel {t_kern:.3f} ms, plain on the host {t_plain:.1f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}), {n_emit} emitted transitions, "
          f"{chain_note(chain, 'admitted transitions', t_kern)}, equal "
          f"(max f32 err "
          f"{err})", flush=True)
    return dict(err=err, ms=t_kern, plain_ms=t_plain, bound_ms=b_ms,
                bound_by=b_by)


def phase_zeros_kernel():
    """Z1 (plain and differentiated) and Z2 against their plain versions
    on zeros_inputs' segments (S=16384, Z2 over Z1's plain lists with the
    5 GCR parmsets), then each at the launches of phase 4's -zeros
    decodes: Z1 at the GCR bench tape's first (B=40), at the NRZI bench
    tape's -zeros chain's first window (B=1: the launch the chain makes
    1,096 times) and at the example3-recipe bench's (differentiated), Z2
    at the GCR bench's first retry (B=16, P=5); and B6 on Z1's NRZI
    transitions, at the chain's first launch (the tape's first two
    blocks)."""
    import dataclasses

    from readtape_tpu_torch import kernels
    from readtape_tpu_torch.formats import tbin as tb
    res = {}
    for diff in (False, True):
        volts, seg_lens, leads, pa, zkw, skw = zeros_inputs(16384, 5, diff)
        tag = "z1 diff" if diff else "z1 9trk"
        r = res[tag] = compare_zc(tag, volts, seg_lens, leads, zkw)
        if not diff:
            res["z2 9trk"] = compare_zs("z2 9trk", r["out"], pa, skw)
    _, hdr, samples = gcr_bench_tape()
    opts = tape_options(hdr, tb.MODE_GCR, 9042, 25, find_zeros=True)
    (volts, seg_lens, leads), kw = first_call(kernels, "zerocross", samples,
                                              opts)
    res["z1 main"] = compare_zc("z1 main", volts, seg_lens, leads, kw)
    del volts
    (trans, pa), kw = first_call(kernels, "gcr_zeros", samples, opts,
                                    index=1)
    res["z2 main"] = compare_zs("z2 main", trans, pa, kw)
    del trans
    _, hdr, volts = gcr_diff_bench_tape()
    (v, seg_lens, leads), kw = first_call(
        kernels, "zerocross", volts, tape_options(
            hdr, tb.MODE_GCR, 9042, 25, maxvolts=32767.0,
            differentiate=True, find_zeros=True))
    res["z1 diff main"] = compare_zc("z1 diff main", v, seg_lens, leads, kw)
    del v
    _, hdr, samples = bench_tape(nblocks=2)
    zopts = dataclasses.replace(tape_options(hdr, tb.MODE_NRZI, 800),
                                find_zeros=True)
    (v, seg_lens, leads), kw = first_call(kernels, "zerocross", samples,
                                          zopts)
    res["z1 chain"] = compare_zc("z1 chain", v, seg_lens, leads, kw)
    del v
    (fin, pa), kw = first_call(kernels, "nrzi_slot", samples, zopts)
    res["b6 zeros"] = compare_slot("b6 zeros", fin, pa, kw)
    return res


def activity_capture(n, t, seed):
    """An int16 capture of n rows and t tracks: idle-tape noise, a burst
    of strong signal every 100,000 rows, and both extremes (-32768 and
    32767) present."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 300.0, (n, t))
    for r in range(0, n, 100_000):
        x[r:r + 30_000] *= 25.0
    x = np.clip(np.rint(x), -32768, 32767).astype(np.int16)
    x[1, 0], x[n // 2, t - 1] = -32768, 32767
    return x


def phase_activity_kernel(reps=50):
    """activity_scan against its plain version on a host copy, at the
    benchmark's capture shapes (ACTIVITY_SHAPES; the subsample step
    host_activity takes), timed beside its bound; then the whole card
    scan (segment.tape_activity: the launch, the copy to the host and the
    host's finish) against the host scan it replaces (host_activity),
    their results equal."""
    import numpy as np
    import torch
    from readtape_tpu_torch.decode import segment as seg
    res = {}
    for seed, (name, (n, t)) in enumerate(ACTIVITY_SHAPES.items()):
        samples = activity_capture(n, t, seed)
        step = max(1, samples.size // 2_000_000)
        tape = torch.from_numpy(samples).to(DEVICE)
        got = seg.activity_scan(tape, step)
        sync()
        want, t_plain = plain_on_host(seg.activity_scan_plain, tape, step)
        if not torch.equal(got, want):
            bad = (got != want).nonzero()[:5].flatten().tolist()
            raise AssertionError(f"{name}: differs at {bad} (the histogram "
                                 f"starts at {n // 16})")
        t_kern = time_launches(lambda: seg.activity_scan(tape, step), reps)
        b_ms, b_by = bound_of(nbytes([tape, want]), 0)
        walls = {}
        for label, fn in (("card", lambda: seg.tape_activity(tape, 1.0,
                                                             step)),
                          ("host", lambda: seg.host_activity(samples, 1.0))):
            fn()
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                out = fn()
                ts.append(time.perf_counter() - t0)
            walls[label] = (sorted(ts)[2] * 1e3, out)
        (h_c, a_c), (h_h, a_h) = walls["card"][1], walls["host"][1]
        if h_c != h_h or not np.array_equal(a_c, a_h):
            raise AssertionError(f"{name}: tape_activity {h_c} != "
                                 f"host_activity {h_h}, or the masks differ")
        print(f"  {name} (N={n} T={t} step={step}): kernel {t_kern:.4f} ms, "
              f"plain on the host {t_plain:.1f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), equal (max err 0); tape_activity "
              f"{walls['card'][0]:.2f} ms against host_activity "
              f"{walls['host'][0]:.2f} ms (medians of 5), h_est {h_c} and "
              f"the mask equal", flush=True)
        res[name] = dict(err=0.0, ms=t_kern, plain_ms=t_plain,
                         bound_ms=b_ms, bound_by=b_by)
        del tape, got, want
    return res


# -trace's cells: the bench tapes, each with the command line's mode flag
# and a window of seconds that holds the start of a block (NRZI also the
# default -trace, the first 10,000 samples)
TRACE_TAPES = {
    "nrzi": (bench_tape, "NRZI", ["-nrzi"], 800, 50, (0.004, 0.024)),
    "pe": (pe_bench_tape, "PE", ["-pe"], 1600, 50, (0.0045, 0.0145)),
    "gcr": (gcr_bench_tape, "GCR", ["-gcr"], 9042, 25, (0.0045, 0.011)),
    "ww": (ww_bench_tape, "WW", ["-whirlwind", "-fluxdir=neg"], 100, 30,
           (0.004, 1.2)),
}


def trace_tape(name):
    """(header, samples, decode options, window [a, b) in samples) of a
    TRACE_TAPES cell, the window as the command line computes it."""
    from readtape_tpu_torch.formats import tbin as tb
    make, mode, _, bpi, ips, (s0, s1) = TRACE_TAPES[name]
    _, hdr, samples = make()
    mode = getattr(tb, "MODE_" + mode)
    opts = (ww_options(hdr) if mode == tb.MODE_WW
            else tape_options(hdr, mode, bpi, ips))
    dt = hdr.tdelta_ns * 1e-9
    return hdr, samples, opts, (int(s0 / dt), min(len(samples),
                                                  int(s1 / dt)))


def trace_run(opts, samples, a, b, device=None):
    """-trace's lanes of samples [a, b) on `device` (DEVICE if None):
    TapeDecoder.trace_lanes, or for Whirlwind ww_trace_lanes."""
    from readtape_tpu_torch.decode import pipeline as tpl
    from readtape_tpu_torch.formats import tbin as tb
    device = device or DEVICE
    if opts.mode == tb.MODE_WW:
        return tpl.ww_trace_lanes(samples, opts, a, b, device=device)
    return tpl.TapeDecoder(samples, opts, device=device).trace_lanes(a, b)


def phase_trace_kernel():
    """-trace's record modes against their plain versions on the card, at
    the launches the trace makes (B=1, P=1, one window; the means of 20
    launches): B5b and then B6 with its per-slot and per-column records
    on the NRZI bench tape's window and on the flipped-bit tape's first
    10,000 samples (a parity error inside a block), B2 and B3 with their
    per-admission rows on the PE and GCR bench tapes' windows, B4 with
    its peak and character times on the Whirlwind bench tape's window."""
    from readtape_tpu_torch import kernels
    from readtape_tpu_torch.formats import tbin as tb
    res = {}
    hdr, samples, opts, (a, b) = trace_tape("nrzi")
    _, fhdr, fsamples = flipped_bit_tape()
    fopts = tape_options(fhdr, tb.MODE_NRZI, 800)
    for tag, (o, x, w) in (("trace", (opts, samples, (a, b))),
                           ("trace flipped", (fopts, fsamples, (0, 10000)))):
        def run():
            return trace_run(o, x, *w)
        if tag == "trace":
            (feat, nxt, pa), kw = call_of(kernels, "nrzi_scan_tracks", run)
            res["b5b trace"] = compare_scan("b5b trace",
                                            "nrzi_track_scan_tracks", feat,
                                            nxt, pa, kw, reps=20)
            del feat, nxt
        (fin, pa), kw = call_of(kernels, "nrzi_slot", run)
        res[f"b6 {tag}"] = compare_slot(f"b6 {tag}", fin, pa, kw, reps=20)
    perr = trace_run(fopts, fsamples, 0, 10000)[1]["parerr"]
    if not perr:
        raise AssertionError("b6 trace flipped: no parity error event")
    print(f"  b6 trace flipped: {len(perr)} parity error events", flush=True)
    for name, launcher, kernel in (("pe", "pe_fused", "pe_fused_scan"),
                                   ("gcr", "gcr_fused", "gcr_fused_scan")):
        hdr, samples, opts, (a, b) = trace_tape(name)
        (volts, seg_lens, leads, pa), kw = call_of(
            kernels, launcher, lambda: trace_run(opts, samples, a, b))
        res[f"{name} trace"] = compare_kernel(f"{name} trace", kernel, volts,
                                              seg_lens, leads, pa, kw,
                                              reps=20)
    hdr, samples, opts, (a, b) = trace_tape("ww")
    (volts,), kw = call_of(kernels, "ww_fused",
                           lambda: trace_run(opts, samples, a, b))
    res["ww trace"] = compare_ww("ww trace", volts, kw, min_blocks=1,
                                 reps=20)
    return res


def phase_kernel():
    """Each kernel on the card against its plain version on a host copy
    of the inputs. Returns {case: compare_kernel dict}."""
    import torch
    from readtape_tpu_torch.decode import fused as tfu
    from readtape_tpu_torch.formats import tbin as tb
    res = {}
    for name, T, corr in (("nrzi 9trk", 9, False),
                          ("nrzi 9trk-correct", 9, True),
                          ("nrzi 7trk", 7, False)):
        res[name] = compare_kernel(name, "nrzi_fused_scan",
                                   *kernel_inputs(T, 16384, corr, seed=5))
    _, hdr, samples = bench_tape()
    res["nrzi main"] = compare_kernel(
        "nrzi main", "nrzi_fused_scan", *main_path_inputs(
            "nrzi_fused", samples, tape_options(hdr, tb.MODE_NRZI, 800)))
    res.update(phase_tiered_kernel())
    res.update(phase_option_kernel())
    r = res["pe 9trk"] = compare_kernel(
        "pe 9trk", "pe_fused_scan", *pe_kernel_inputs(16384, seed=5))
    lane = r["out"]["lane_i"]
    if not (bool((lane[..., tfu.PL_TAU] < 16384).any())
            and int(r["out"]["faked"].sum()) > 0):
        raise AssertionError("pe 9trk: no lane reached its all-idle point "
                             "or no fake bits")
    _, hdr, samples = pe_bench_tape()
    pe_opts = tape_options(hdr, tb.MODE_PE, 1600)
    res["pe main"] = compare_kernel(
        "pe main", "pe_fused_scan", *main_path_inputs(
            "pe_fused", samples, pe_opts))
    # the PE walk's hops: 14 of the bench decode's 15 launches are B=1
    res["pe hop"] = compare_kernel(
        "pe hop", "pe_fused_scan", *main_path_inputs(
            "pe_fused", samples, pe_opts, index=1))
    r = res["gcr 9trk"] = compare_kernel(
        "gcr 9trk", "gcr_fused_scan", *gcr_kernel_inputs(16384, seed=5))
    if not bool((r["out"]["lane_i"][3, :, tfu.GL_TAU] < 16384).all()):
        raise AssertionError("gcr 9trk: the two-block segment's lanes did "
                             "not reach their all-idle point")
    _, hdr, samples = gcr_bench_tape()
    res["gcr main"] = compare_kernel(
        "gcr main", "gcr_fused_scan", *main_path_inputs(
            "gcr_fused", samples, tape_options(hdr, tb.MODE_GCR, 9042, 25)))
    res.update(phase_ww_kernel())
    res.update(phase_zeros_kernel())
    res.update(phase_trace_kernel())
    res.update(phase_activity_kernel())
    for r in res.values():
        r.pop("out", None)
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 4: the main paths at bench scale
# ---------------------------------------------------------------------------

def check_launches(name, launched, absent=()):
    """Since reset_counts: every kernel of `launched` launched, none of
    `absent`, and no plain version ran. Returns {kernel: launches}."""
    got = counts()
    for k in launched:
        if got[k][0] <= 0:
            raise AssertionError(f"{name}: the main path never launched {k}")
    for k in absent:
        if got[k][0]:
            raise AssertionError(f"{name}: {k} launched {got[k][0]} times")
    plain = {k: c for k, (_, c) in got.items() if c}
    if plain:
        raise AssertionError(f"{name}: the main path ran plain versions "
                             f"{plain}")
    return {k: got[k][0] for k in launched}


def decode_timed(name, kernels, samples, opts, kernel_path="fused",
                 absent=()):
    """decode_tape on the card, warm-up then timed with the launch counts
    set to 0 just before and read just after. Returns ({kernel: launches}
    for `kernels`, wall seconds, Msamples/s, the blocks, the stats)."""
    from readtape_tpu_torch.decode import pipeline as tpl
    tpl.decode_tape(samples, opts, device=DEVICE,
                    kernel_path=kernel_path)                # warm-up run
    sync()
    reset_counts()
    t0 = time.perf_counter()
    out, stats = tpl.decode_tape(samples, opts, device=DEVICE,
                                 kernel_path=kernel_path)
    sync()
    wall = time.perf_counter() - t0
    launches = check_launches(name, kernels, absent)
    return launches, wall, samples.shape[0] / wall / 1e6, out, stats


def decode_bench(name, kernels, blocks, hdr, samples, opts, card, marks,
                 kernel_path="fused", absent=()):
    """decode_timed, then every block against the ground truth. Returns
    ({kernel: launches} for `kernels`, wall seconds, Msamples/s, the
    blocks)."""
    launches, wall, msps, out, stats = decode_timed(
        name, kernels, samples, opts, kernel_path, absent)
    data = [b.data for b in out if b.kind == "data"]
    if data != blocks:
        bad = [i for i, (x, y) in enumerate(zip(data, blocks)) if x != y]
        raise AssertionError(f"{name}: {len(data)} data blocks, "
                             f"{len(blocks)} expected; first differing "
                             f"{bad[:5]}")
    if stats["ntapemarks"] != marks or stats["nerrblocks"] != 0:
        raise AssertionError(f"{name}: ntapemarks {stats['ntapemarks']}, "
                             f"nerrblocks {stats['nerrblocks']}")
    print(f"  {name}: {samples.shape[0]:,} samples, {len(out)} blocks, "
          f"launches {launches}: {wall:.3f} s wall, {msps:.3f} Msamples/s "
          f"({card})", flush=True)
    return launches, wall, msps, out


def decode_vs_cpu(name, kernels, blocks, samples, opts, card, absent=()):
    """A bench tape whose -zeros decode does not recover the ground truth
    (nor does the JAX package's, on the CPU): decode_timed on the card,
    then the same decode on the CPU (plain versions), block for block
    equal with the run statistics. Returns decode_timed's first three."""
    import numpy as np
    from readtape_tpu_torch.decode import pipeline as tpl
    launches, wall, msps, out, stats = decode_timed(name, kernels, samples,
                                                    opts, absent=absent)
    t0 = time.perf_counter()
    out_cpu, st_cpu = tpl.decode_tape(samples, opts, device="cpu")
    t_cpu = time.perf_counter() - t0
    if out != out_cpu:
        raise AssertionError(f"{name}: card {[b.kind for b in out]} != "
                             f"cpu {[b.kind for b in out_cpu]}")
    for k in ("peak_hist", "tried", "chosen"):
        if not np.array_equal(stats[k], st_cpu[k]):
            raise AssertionError(f"{name}: {k} differs")
    kinds = "".join(b.kind[0] for b in out)
    good = sum(b.data in blocks for b in out if b.kind == "data")
    print(f"  {name}: {samples.shape[0]:,} samples, {len(out)} blocks "
          f"({kinds}), {good} of {len(blocks)} equal to the ground truth "
          f"(the JAX package recovers none: PERF.md), launches {launches}: "
          f"{wall:.3f} s wall, {msps:.3f} Msamples/s; card == cpu (the cpu "
          f"took {t_cpu:.1f} s) ({card})", flush=True)
    return launches, wall, msps


def phase_short_gap(name, kernels, hdr, samples, opts, card,
                    kernel_path="fused"):
    """A noisy short-gap tape on the card and on the CPU (plain versions):
    block for block equal, with the run statistics. Returns {kernel:
    launches} of the card's decode."""
    import numpy as np
    from readtape_tpu_torch.decode import pipeline as tpl
    reset_counts()
    out_gpu, st_gpu = tpl.decode_tape(samples, opts, device=DEVICE,
                                      kernel_path=kernel_path)
    sync()
    launches = check_launches(name, kernels)
    out_cpu, st_cpu = tpl.decode_tape(samples, opts, device="cpu",
                                      kernel_path=kernel_path)
    if out_gpu != out_cpu:
        raise AssertionError(f"{name}: card {[b.kind for b in out_gpu]}"
                             f" != cpu {[b.kind for b in out_cpu]}")
    for k in ("peak_hist", "tried", "chosen"):
        if not np.array_equal(st_gpu[k], st_cpu[k]):
            raise AssertionError(f"{name}: {k} differs")
    print(f"  {name}: {len(out_gpu)} blocks "
          f"{[(b.kind, len(b.data), b.errcount) for b in out_gpu]}, tried "
          f"{st_gpu['tried'].tolist()}, launches {launches}; card == cpu "
          f"({card})", flush=True)
    return launches


def phase_density(card):
    """The NRZI and PE bench tapes decoded on the card with bpi=0: the
    density is detected (B5b) as 800 and 1600 bpi, and the tape then
    decodes to its ground truth."""
    import dataclasses
    import torch
    from readtape_tpu_torch.decode import pipeline as tpl
    from readtape_tpu_torch.formats import tbin as tb
    for name, tape, mode, bpi, kernel in (
            ("NRZI bench", bench_tape, tb.MODE_NRZI, 800, "nrzi_fused_scan"),
            ("PE bench", pe_bench_tape, tb.MODE_PE, 1600, "pe_fused_scan")):
        blocks, hdr, samples = tape()
        opts = dataclasses.replace(tape_options(hdr, mode, bpi), bpi=0.0)
        reset_counts()
        t0 = time.perf_counter()
        out, stats = tpl.decode_tape(samples, opts, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = check_launches(f"{name} density",
                                  ["nrzi_track_scan_tracks", kernel])
        std, raw = stats["density"]
        if std != bpi:
            raise AssertionError(f"{name}: density {std} ({raw:.1f}) "
                                 f"detected, {bpi} expected")
        if [b.data for b in out if b.kind == "data"] != blocks:
            raise AssertionError(f"{name}: decoded with the detected "
                                 f"density, the blocks differ")
        print(f"  {name}, bpi=0: detected {std:.0f} bpi (raw {raw:.3f}), "
              f"{len(blocks)} blocks equal to the ground truth, launches "
              f"{launches}, {wall:.3f} s with detection ({card})",
              flush=True)


def phase_main(card):
    """Returns {kernel: (launches on its main path, wall s, Msamples/s)}
    (wall and rate None where the main path is not a timed bench)."""
    import dataclasses

    import torch
    from readtape_tpu_torch import native
    from readtape_tpu_torch.formats import tbin as tb
    print(f"  host activity scan: "
          f"{'native tape_scan' if native.available() else 'numpy'}",
          flush=True)
    runs = {}

    def keep(launches, wall, msps):
        for k, n in launches.items():
            runs[k] = (n, wall, msps)
    blocks, hdr, samples = bench_tape()
    opts = tape_options(hdr, tb.MODE_NRZI, 800)
    n, w, m, fused_out = decode_bench(
        "NRZI bench", ["nrzi_fused_scan", "activity_scan"], blocks, hdr,
        samples, opts, card, marks=2)
    keep(n, w, m)
    torch.cuda.reset_peak_memory_stats()
    n, w, m, out = decode_bench(
        "NRZI bench, tiered", ["nrzi_track_scan_tracks", "nrzi_slot_scan"],
        blocks, hdr, samples, opts, card, marks=2, kernel_path="tiered",
        absent=["nrzi_fused_scan"])
    keep(n, w, m)
    if out != fused_out:
        raise AssertionError("NRZI bench: the tiered blocks differ from "
                             "the fused ones")
    print(f"  NRZI bench, tiered: blocks equal to the fused decode's; peak "
          f"allocation {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
          flush=True)
    hdr, samples = nrzi_noisy_tape()
    n = phase_short_gap("NRZI noisy, tiered (8-parmset retry)",
                        ["nrzi_track_scan", "nrzi_track_scan_tracks",
                         "nrzi_slot_scan"], hdr, samples,
                        tape_options(hdr, tb.MODE_NRZI, 800), card,
                        kernel_path="tiered")
    runs["nrzi_track_scan"] = (n["nrzi_track_scan"], None, None)
    blocks, hdr, samples = pe_bench_tape()
    keep(*decode_bench("PE bench", ["pe_fused_scan", "activity_scan"],
                       blocks, hdr, samples,
                       tape_options(hdr, tb.MODE_PE, 1600), card,
                       marks=0)[:3])
    blocks, hdr, samples = gcr_bench_tape()
    gcr_opts = tape_options(hdr, tb.MODE_GCR, 9042, 25)
    n, w, m, gcr_out = decode_bench("GCR bench", ["gcr_fused_scan"], blocks,
                                    hdr, samples, gcr_opts, card, marks=0)
    keep(n, w, m)
    volts, maxvolts = as_volts(hdr, samples)
    out = decode_bench("GCR bench, float volts", ["gcr_fused_scan"], blocks,
                       hdr, volts, dataclasses.replace(gcr_opts,
                                                       maxvolts=maxvolts),
                       card, marks=0, absent=["activity_scan"])[3]

    def summary(blocks_):
        return [(b.kind, b.data, b.parmset, b.errcount, b.warncount)
                for b in blocks_]
    if summary(out) != summary(gcr_out):
        raise AssertionError("GCR bench, float volts: the blocks differ from "
                             "the int16 decode's")
    print("  GCR bench, float volts: blocks equal to the int16 decode's",
          flush=True)
    keep(*decode_vs_cpu("GCR bench, -zeros", ["zerocross_transitions",
                                              "gcr_zeros_scan"], blocks,
                        samples, dataclasses.replace(gcr_opts,
                                                     find_zeros=True),
                        card, absent=["gcr_fused_scan"]))
    blocks, hdr, volts = gcr_diff_bench_tape()
    decode_bench("GCR bench, example3's recipe, -differentiate -zeros",
                 ["zerocross_transitions", "gcr_zeros_scan"], blocks, hdr,
                 volts, tape_options(hdr, tb.MODE_GCR, 9042, 25,
                                     maxvolts=32767.0, differentiate=True,
                                     find_zeros=True), card, marks=0,
                 absent=["gcr_fused_scan"])
    blocks, hdr, samples = bench_tape()
    zopts = tape_options(hdr, tb.MODE_NRZI, 800, find_zeros=True)
    launches, wall, msps, out, _ = decode_timed(
        "NRZI bench, -zeros", ["zerocross_transitions", "nrzi_slot_scan"],
        samples, zopts, absent=["nrzi_fused_scan", "nrzi_track_scan_tracks"])
    good = sum(b.data in blocks for b in out if b.kind == "data")
    print(f"  NRZI bench, -zeros (the chain): {samples.shape[0]:,} samples, "
          f"{len(out)} blocks, {good} of {len(blocks)} equal to the ground "
          f"truth (the JAX package recovers none: PERF.md), launches "
          f"{launches}: {wall:.3f} s wall, {msps:.3f} Msamples/s ({card})",
          flush=True)
    runs["nrzi_slot_scan -zeros"] = (launches["nrzi_slot_scan"], wall, msps)
    _, hdr, samples = bench_tape(nblocks=2)
    phase_short_gap("NRZI bench's first two blocks, -zeros",
                    ["zerocross_transitions", "nrzi_slot_scan"], hdr,
                    samples, tape_options(hdr, tb.MODE_NRZI, 800,
                                          find_zeros=True), card)
    hdr, samples = pe_short_gap_tape()
    phase_short_gap("PE short gap, 0.06 V noise", ["pe_fused_scan"], hdr,
                    samples, tape_options(hdr, tb.MODE_PE, 1600), card)
    hdr, samples = gcr_short_gap_tape()
    phase_short_gap("GCR short gap, 0.07 V noise", ["gcr_fused_scan"], hdr,
                    samples, tape_options(hdr, tb.MODE_GCR, 9042, 25), card)
    hdr, samples = gcr_merged_tape()
    phase_short_gap("GCR merged blocks (multi-block round)",
                    ["gcr_fused_scan"], hdr, samples,
                    tape_options(hdr, tb.MODE_GCR, 9042, 25), card)
    blocks, hdr, samples = ww_bench_tape()
    torch.cuda.reset_peak_memory_stats()
    keep(*decode_bench("WW bench", ["ww_fused_scan"], blocks, hdr, samples,
                       ww_options(hdr), card, marks=0)[:3])
    print(f"  WW bench: peak allocation "
          f"{torch.cuda.max_memory_allocated() / 2**20:.3f} MiB", flush=True)
    # 24 blocks: about 5.2 million samples, so the machine's rolling base
    # moves (its span is 2^22 samples)
    blocks, hdr, samples = ww_bench_tape(nblocks=24)
    if samples.shape[0] <= (1 << 22) + 200_000:
        raise AssertionError("the long WW tape is too short")
    decode_bench("WW long tape", ["ww_fused_scan"], blocks, hdr, samples,
                 ww_options(hdr), card, marks=0)
    hdr, samples = ww_deskew_tape()
    phase_short_gap("WW -deskew (two passes)", ["ww_fused_scan"], hdr,
                    samples, ww_options(hdr, deskew=True), card)
    phase_density(card)
    return runs


# ---------------------------------------------------------------------------
# phase 5: golden .tap hashes
# ---------------------------------------------------------------------------

def write_example(name, directory):
    """Write one EXAMPLES tape into `directory` as the command line reads
    it: a .tbin file with the port's write_tbin, or for a CSV example its
    volts with the port's write_csv (as examples/make_examples.py generate
    writes them). Returns the base name to give the command line."""
    from readtape_tpu_torch.formats import csvfmt
    from readtape_tpu_torch.formats import tbin as tb
    hdr, samples = build_example(name)
    base = os.path.join(directory, name.replace("/", "_"))
    if EXAMPLES[name].get("fmt") == "csv":
        csvfmt.write_csv(base + ".csv", 0.0, hdr.tdelta_ns * 1e-9,
                         samples.astype("float64") * (hdr.maxvolts / 32767.0))
    else:
        tb.write_tbin(base + ".tbin", hdr, samples)
    return base


def run_cli(argv, device, kernel_path="fused"):
    """The port's command line, main(argv), on `device`, its log lines
    kept off this script's output; raises unless it exits 0."""
    from readtape_tpu_torch import cli
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv, device=device, kernel_path=kernel_path)
    if rc != 0:
        raise AssertionError(f"{' '.join(argv)}: exit code {rc}")


def run_example(name, device, directory, kernel_path="fused"):
    """One EXAMPLES tape through the port's command line with the
    example's own arguments, in <directory>/<kernel_path>; returns the
    SHA-256 of the .tap it writes."""
    d = os.path.join(directory, kernel_path)
    os.makedirs(d, exist_ok=True)
    base = write_example(name, d)
    run_cli(EXAMPLES[name]["args"] + [base], device, kernel_path)
    with open(base + ".tap", "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def phase_golden():
    """Every example through the port's command line on the card, and the
    NRZI ones again through the tiered kernels (checking that they
    launched)."""
    with open(os.path.join(REPO, "examples", "golden.json")) as f:
        golden = json.load(f)
    runs = [(name, "fused") for name in GOLDEN_CASES]
    runs += [(name, "tiered") for name in GOLDEN_CASES if "NRZI" in name]
    with tempfile.TemporaryDirectory() as tmp:
        for name, path in runs:
            reset_counts()
            h = run_example(name, DEVICE, tmp, kernel_path=path)
            if path == "tiered":
                check_launches(name, ["nrzi_track_scan_tracks",
                                      "nrzi_slot_scan"], ["nrzi_fused_scan"])
            else:
                check_launches(name, [])
            if h != golden[name]:
                raise AssertionError(f"{name} ({path}): sha256 {h[:16]} != "
                                     f"golden {golden[name][:16]}")
            print(f"  {name} ({path}): {' '.join(EXAMPLES[name]['args'])}, "
                  f"sha256 {h[:16]} ok", flush=True)


# ---------------------------------------------------------------------------
# phases 6 and 7: the command line at full width, and -parmscan
# ---------------------------------------------------------------------------

CLI_ARGS = ["-v", "-m", "-nrzi", "-tap", "-textfile", "-hex", "-ebcdic"]


def masked_lines(path):
    """An output file's lines, with those that carry the time masked: a
    .txt's line 2, a .log's "version ... running on" and "... processed
    in N seconds" lines."""
    with open(path, encoding="latin-1") as f:
        lines = f.read().split("\n")
    if path.endswith(".txt"):
        return lines[:1] + lines[2:]
    return ["<time>" if (ln.startswith("version ") and " running on " in ln)
            or " samples were processed in " in ln else ln for ln in lines]


def tap_contents(path):
    """(data records, tapemarks) of a .tap file."""
    from readtape_tpu_torch.formats import simh
    recs = simh.read_tap(path)
    return ([r.data for r in recs if r.kind == "data"],
            sum(r.kind == "tapemark" for r in recs))


class DecodeClock:
    """Times every call of decode.pipeline.<name> (synchronized) while it
    is active, and counts the launches of each KERNELS entry inside it;
    the command line looks the function up at each call."""

    def __init__(self, name):
        self.name, self.spans, self.launches = name, [], {}

    def __enter__(self):
        from readtape_tpu_torch.decode import pipeline as tpl
        self.fn = fn = getattr(tpl, self.name)

        def timed(*args, **kw):
            sync()
            before = counts()
            t0 = time.perf_counter()
            r = fn(*args, **kw)
            sync()
            self.spans.append(time.perf_counter() - t0)
            for k, (n, _) in counts().items():
                self.launches[k] = self.launches.get(k, 0) + n - before[k][0]
            return r
        setattr(tpl, self.name, timed)
        return self

    def __exit__(self, *exc):
        from readtape_tpu_torch.decode import pipeline as tpl
        setattr(tpl, self.name, self.fn)


def phase_cli(card):
    """The NRZI bench tape (160 blocks, 9 tracks, 8 parmsets) written as
    .tbin and run through the port's command line on the card with
    CLI_ARGS, warm: every .tap block against the ground truth, the CLI's
    wall and the decode inside it. Then the 9trk_NRZI/example tape through
    the same command line on the card and on the CPU, in directories of
    their own: .tap, .txt, .peakstats.csv and .log equal under the mask.
    Returns {kernel: launches} of the bench run."""
    from readtape_tpu_torch.formats import tbin as tb
    blocks, hdr, samples = bench_tape()
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "bench")
        tb.write_tbin(base + ".tbin", hdr, samples)
        run_cli(CLI_ARGS + [base], DEVICE)                  # warm-up run
        with DecodeClock("decode_tape") as clock:
            reset_counts()
            t0 = time.perf_counter()
            run_cli(CLI_ARGS + [base], DEVICE)
            wall = time.perf_counter() - t0
        launches = check_launches("NRZI bench CLI", ["nrzi_fused_scan"])
        data, marks = tap_contents(base + ".tap")
        if data != blocks or marks != 2:
            raise AssertionError(f"NRZI bench CLI: {len(data)} .tap blocks, "
                                 f"{marks} tapemarks; not the ground truth")
        txt = os.path.getsize(base + ".hex.ebcdic.txt")
        print(f"  NRZI bench through the CLI ({' '.join(CLI_ARGS)}): "
              f"{samples.shape[0]:,} samples, {len(data)} .tap blocks equal "
              f"to the ground truth, launches {launches}: CLI wall "
              f"{wall:.3f} s, decode_tape inside it {clock.spans[0]:.3f} s, "
              f".txt {txt:,} bytes ({card})", flush=True)
        name = "9trk_NRZI/example"
        here = os.getcwd()
        outs = {}
        try:
            for where, dev in (("card", DEVICE), ("cpu", "cpu")):
                os.makedirs(os.path.join(tmp, where))
                os.chdir(os.path.join(tmp, where))
                base = os.path.basename(write_example(name, "."))
                reset_counts()
                run_cli(CLI_ARGS + [base], dev)
                if where == "card":
                    check_launches(name, ["nrzi_fused_scan"])
                outs[where] = {ext: (masked_lines(base + ext) if ext != ".tap"
                                   else tap_contents(base + ext))
                             for ext in (".tap", ".hex.ebcdic.txt",
                                         ".peakstats.csv", ".log")}
        finally:
            os.chdir(here)
        for ext, got in outs["card"].items():
            if got != outs["cpu"][ext]:
                raise AssertionError(f"{name} through the CLI: the card's "
                                     f"{ext} differs from the CPU's")
        print(f"  {name} through the CLI on the card and on the CPU: .tap, "
              f".txt, .peakstats.csv and .log equal (the time masked)",
              flush=True)
    return launches


def parmscan_tape():
    """The -parmscan tape (tests/test_parmscan.py's recipe): one GCR block
    of 154 random bytes (seed 77) with 0.025-bit time jitter, then a
    tapemark."""
    import numpy as np
    from readtape_tpu_torch.formats import tbin as tb
    from readtape_tpu_torch.synth import default_spec, synthesize_tape
    rng = np.random.default_rng(77)
    block = bytes(rng.integers(0, 256, 154, dtype=np.uint8))
    spec = default_spec(tb.MODE_GCR, time_jitter_bits=0.025, seed=77)
    hdr, samples = synthesize_tape(spec, [("block", block), ("tapemark",)])
    return block, hdr, samples


def phase_parmscan(card):
    """GCR -parmscan on the card: B3 at the grid's shape (B=1, P=64, the
    first 64 combos) against its plain version on the same inputs, and
    the 64 clk_alpha lines from B3 equal to those from its plain version;
    then the whole 5,280-combo grid through the port's command line.
    Returns (compare_kernel's dict, the grid's launches of B3)."""
    from readtape_tpu_torch import kernels
    from readtape_tpu_torch.decode import fused as tfu
    from readtape_tpu_torch.decode import pipeline as tpl
    from readtape_tpu_torch.formats import tbin as tb
    block, hdr, samples = parmscan_tape()
    grid = tpl.parmscan_grid()
    dec = tpl.TapeDecoder(samples, tape_options(hdr, tb.MODE_GCR, 9042, 25),
                          device=DEVICE)
    span = dec.segments()[0]
    seen, launch = [], kernels.gcr_fused

    def record(*args, **kw):
        seen.append((args, kw))
        return launch(*args, **kw)
    lines = {}
    kernels.gcr_fused = record
    try:
        reset_counts()
        lines["kernel"] = []
        tpl.gcr_parmscan(dec, span, lines["kernel"].append, combos=grid[:64])
        sync()
        check_launches("-parmscan, 64 combos", ["gcr_fused_scan"])
    finally:
        kernels.gcr_fused = launch
    (volts, seg_lens, leads, pa), kw = seen[0]
    res = compare_kernel("gcr parmscan", "gcr_fused_scan", volts, seg_lens,
                         leads, pa, kw)
    kern, tfu.gcr_fused_scan = tfu.gcr_fused_scan, tfu.gcr_fused_scan_plain
    try:
        lines["plain"] = []
        tpl.gcr_parmscan(dec, span, lines["plain"].append, combos=grid[:64])
    finally:
        tfu.gcr_fused_scan = kern
    if lines["kernel"] != lines["plain"]:
        bad = [i for i, (x, y) in enumerate(zip(lines["kernel"],
                                                lines["plain"])) if x != y]
        raise AssertionError(f"-parmscan: the kernel's lines differ from the "
                             f"plain version's at combos {bad[:5]}")
    print(f"  -parmscan, the first 64 combos: B3's 64 clk_alpha lines equal "
          f"to its plain version's on the card", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "parmscan")
        tb.write_tbin(base + ".tbin", hdr, samples)
        with DecodeClock("gcr_parmscan") as clock:
            reset_counts()
            t0 = time.perf_counter()
            run_cli(["-v", "-m", "-gcr", "-ips=25", "-tap", "-parmscan",
                     base], DEVICE)
            wall = time.perf_counter() - t0
        total = check_launches("-parmscan CLI", ["gcr_fused_scan"])
        with open(base + ".log") as f:
            n = sum(ln.startswith("clk_alpha ") for ln in f)
        if n != len(grid) or tap_contents(base + ".tap") != ([block], 1):
            raise AssertionError(f"-parmscan CLI: {n} clk_alpha lines, "
                                 f"{len(grid)} expected, or the .tap is not "
                                 "the ground truth")
    n_grid = clock.launches["gcr_fused_scan"]
    print(f"  -parmscan through the CLI: {n} clk_alpha lines, the .tap equal "
          f"to the ground truth; grid {sum(clock.spans):.3f} s over "
          f"{len(clock.spans)} segment(s), {n_grid} launches of B3 at B=1 "
          f"P=64; CLI wall {wall:.3f} s, launches {total} ({card})",
          flush=True)
    return res, n_grid


# ---------------------------------------------------------------------------
# phase 8: -adjskew and -correctdbg
# ---------------------------------------------------------------------------

DEBUG_CORRECT = dict(do_correct=True, do_correct_debug=True)
# admission on each option's path: one parmset a try (B5b), all eight
# with their three window widths (B5a)
OPTION_PATHS = (("-adjskew", dict(adjskew=True), "nrzi_track_scan_tracks"),
                ("-correctdbg", DEBUG_CORRECT, "nrzi_track_scan"))


def same_decodes(name, a, b):
    """Two decode_tape results, block for block (detail, -adjskew's
    reports included) with the run statistics and the final skew."""
    import numpy as np
    (out_a, st_a), (out_b, st_b) = a, b
    if out_a != out_b:
        raise AssertionError(f"{name}: card {[b.kind for b in out_a]} != "
                             f"cpu {[b.kind for b in out_b]}")
    for k in ("peak_hist", "tried", "chosen"):
        if not np.array_equal(st_a[k], st_b[k]):
            raise AssertionError(f"{name}: {k} differs")
    if st_a["skew"] != st_b["skew"]:
        raise AssertionError(f"{name}: final skew {st_a['skew']} != "
                             f"{st_b['skew']}")


def phase_options(card):
    """-adjskew and -correctdbg on the card. First tests/test_cli_oracle.py's
    two recipes and the tape where -correctdbg and -correct differ
    (flipped_bit_tape), each decoded on the card (launch counts set to 0
    just before, read just after: B5b or B5a and B6, not B1) and on the
    CPU: blocks, -adjskew's reports and the final skew equal, the blocks
    the ground truth; then through the command line on the card and on
    the CPU: .tap and .log equal (the time masked). Then the NRZI bench
    tape under each option, timed (decode_timed): its blocks against the
    ground truth, its wall and launches. Returns {kernels-line entry:
    (launches, wall s, Msamples/s)}: B6's and the admission's under each
    option."""
    import dataclasses
    from readtape_tpu_torch.decode import pipeline as tpl
    from readtape_tpu_torch.formats import tbin as tb
    tapes = (("-adjskew recipe", adjskew_tape(), OPTION_PATHS[0]),
             ("-correctdbg recipe", correctdbg_tape(), OPTION_PATHS[1]),
             ("-correctdbg, flipped bit", flipped_bit_tape(),
              OPTION_PATHS[1]))
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, (blocks, hdr, samples), (opt, over, admit)) in \
                enumerate(tapes):
            opts = tape_options(hdr, tb.MODE_NRZI, 800, **over)
            reset_counts()
            card_res = tpl.decode_tape(samples, opts, device=DEVICE)
            sync()
            launches = check_launches(name, [admit, "nrzi_slot_scan"],
                                      ["nrzi_fused_scan"])
            same_decodes(name, card_res,
                         tpl.decode_tape(samples, opts, device="cpu"))
            out, stats = card_res
            if [b.data for b in out if b.kind == "data"] != blocks:
                raise AssertionError(f"{name}: not the ground truth")
            corr = sum(b.detail.get("corrected_bits", 0) for b in out)
            if "flipped" in name and corr != len(blocks):
                raise AssertionError(f"{name}: {corr} bits corrected")
            logs = {}
            here = os.getcwd()
            try:
                for where, dev in (("card", DEVICE), ("cpu", "cpu")):
                    # the same relative base name: the .log names it
                    os.makedirs(os.path.join(tmp, f"{i}{where}"))
                    os.chdir(os.path.join(tmp, f"{i}{where}"))
                    tb.write_tbin("t.tbin", hdr, samples)
                    run_cli(["-v", "-m", "-nrzi", opt, "-tap", "t"], dev)
                    logs[where] = (tap_contents("t.tap"),
                                   masked_lines("t.log"))
            finally:
                os.chdir(here)
            if logs["card"] != logs["cpu"]:
                raise AssertionError(f"{name}: the card's .tap or .log "
                                     f"differs from the CPU's")
            ndev = sum("deviation is" in ln for ln in logs["card"][1])
            print(f"  {name}: {len(out)} blocks equal to the ground truth, "
                  f"{corr} bits corrected, final skew {stats['skew']}, "
                  f"launches {launches}; card == cpu; through the CLI .tap "
                  f"and .log equal ({ndev} deviation lines)", flush=True)
    runs = {}
    blocks, hdr, samples = bench_tape()
    for opt, over, admit in OPTION_PATHS:
        entry = f"nrzi_slot_scan {opt}"
        opts = tape_options(hdr, tb.MODE_NRZI, 800, **over)
        launches, wall, msps, out, stats = decode_timed(
            f"NRZI bench, {opt}", [admit, "nrzi_slot_scan"], samples, opts,
            absent=["nrzi_fused_scan"])
        data = [b.data for b in out if b.kind == "data"]
        if data != blocks or stats["ntapemarks"] != 2:
            raise AssertionError(f"NRZI bench, {opt}: not the ground truth")
        print(f"  NRZI bench, {opt}: {samples.shape[0]:,} samples, "
              f"{len(data)} blocks equal to the ground truth, tries "
              f"{stats['tried'].tolist()}, final skew {stats['skew']}, "
              f"launches {launches}: {wall:.3f} s wall, {msps:.3f} "
              f"Msamples/s ({card})", flush=True)
        runs[entry] = (launches["nrzi_slot_scan"], wall, msps)
        runs[f"{admit} {opt}"] = (launches[admit], wall, msps)
    return runs


# ---------------------------------------------------------------------------
# phase 9: -trace
# ---------------------------------------------------------------------------

TRACE_KERNELS = {"nrzi": ["nrzi_track_scan_tracks", "nrzi_slot_scan"],
                 "pe": ["pe_fused_scan"], "gcr": ["gcr_fused_scan"],
                 "ww": ["ww_fused_scan"]}


def phase_trace(card):
    """The command line with -trace=a,b on the card for each bench tape
    of TRACE_TAPES, and with -trace (the first 10,000 samples) on the
    NRZI one. Its trace step (cli.write_trace_file) is timed on its own,
    with the launch counts set to 0 just before it and read just after:
    only the record modes' kernels ran, once each, and no plain version.
    The .trace.csv must equal, byte for byte, the one the same step
    writes on the CPU with the command line's own options: the plain
    versions over the window alone (no CPU decode of the tape). Returns
    {kernels-line entry: (launches, wall s, None)} of the -trace=a,b
    runs."""
    from readtape_tpu_torch import cli
    from readtape_tpu_torch.formats import tbin as tb
    runs = {}
    write = cli.write_trace_file
    cases = [(name, f"-trace={TRACE_TAPES[name][5][0]},"
              f"{TRACE_TAPES[name][5][1]}") for name in TRACE_TAPES]
    cases.insert(1, ("nrzi", "-trace"))

    class Quiet:
        def info(self, *_):
            pass
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, opt) in enumerate(cases):
            make, _, flags, *_ = TRACE_TAPES[name]
            _, hdr, samples = make()
            seen = {}

            def timed(*args, **kw):
                reset_counts()
                t0 = time.perf_counter()
                write(*args, **kw)
                sync()
                seen["wall"] = time.perf_counter() - t0
                seen["launches"] = check_launches(f"{name} {opt}",
                                                  TRACE_KERNELS[name])
                seen["call"] = (args, kw)
            d = os.path.join(tmp, str(i))
            os.makedirs(d)
            here = os.getcwd()
            os.chdir(d)
            try:
                tb.write_tbin("t.tbin", hdr, samples)
                cli.write_trace_file = timed
                try:
                    run_cli(flags + [opt, "t"], DEVICE)
                finally:
                    cli.write_trace_file = write
                if seen["launches"] != {k: 1 for k in TRACE_KERNELS[name]}:
                    raise AssertionError(f"{name} {opt}: launches "
                                         f"{seen['launches']}")
                (o, _, x, dopts, _, _), kw = seen["call"]
                t0 = time.perf_counter()
                write(o, "cpu", x, dopts, None, Quiet(),
                      **dict(kw, device="cpu"))
                t_cpu = time.perf_counter() - t0
                with open("t.trace.csv", "rb") as f:
                    got = f.read()
                with open("cpu.trace.csv", "rb") as f:
                    want = f.read()
                with open("t.log") as f:
                    logged = f.read()
            finally:
                os.chdir(here)
            if got != want:
                raise AssertionError(f"{name} {opt}: the card's .trace.csv "
                                     f"differs from the CPU's")
            nl = got.count(b"\n") - 1
            if f'created trace file "t.trace.csv" ({nl} lines)' \
                    not in logged:
                raise AssertionError(f"{name} {opt}: no log line")
            print(f"  {name} {opt}: {nl} lines, {len(got):,} bytes equal "
                  f"to the CPU's; trace step {seen['wall']:.3f} s on the "
                  f"card (launches {seen['launches']}), {t_cpu:.3f} s on "
                  f"the CPU ({card})", flush=True)
            if opt != "-trace":
                for k, n in seen["launches"].items():
                    runs[f"{k} -trace"] = (n, seen["wall"], None)
    return runs


# ---------------------------------------------------------------------------
# phase 10: the host tools, csvtbin and dumptap
# ---------------------------------------------------------------------------

CSVTBIN_NRZI = ["-ntrks=9", "-nrzi", "-bpi=800", "-ips=50"]
CSVTBIN_GCR = ["-ntrks=9", "-gcr", "-bpi=9042", "-ips=25"]
TOOLS_BLOCKS = 20          # of the NRZI bench recipe: ~0.55 M samples


def run_tool(main, argv):
    """A host tool's main(argv), its stdout kept off this script's output;
    raises unless it exits 0. Returns the stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"{' '.join(argv)}: exit code {rc}")
    return buf.getvalue()


def dump_entries(path):
    """A dumptap listing's entries: ("mark",) per tapemark line, (flag,
    length) per record's first line."""
    out = []
    with open(path) as f:
        for ln in f:
            m = re.match(r"([ !]) *(\d+): ", ln)
            if m:
                out.append((m.group(1), int(m.group(2))))
            elif ln == ".tap tape mark\n":
                out.append(("mark",))
    return out


def phase_tools(card, nblocks=TOOLS_BLOCKS):
    """An archivist's workflow through the port alone. (a) The NRZI bench
    recipe cut to `nblocks` blocks, written as a CSV of volts with the
    port's write_csv, goes through csvtbin (CSVTBIN_NRZI) into a .tbin,
    which the command line decodes on the card with CLI_ARGS, the launch
    counts set to 0 just before and read just after: every data block
    equals the ground truth and both tapemarks are there. (b) The
    9trk_GCR/example3 CSV goes through csvtbin (CSVTBIN_GCR) and the
    command line decodes the .tbin with the example's arguments
    (-differentiate -zeros: Z1 and Z2) on the card and on the CPU, each in
    a directory of its own: the two .tap files are equal byte for byte.
    (c) dumptap -hex -ebcdic lists (a)'s .tap: a line per record, with
    its length and no error flag, and a line per tapemark, in the .tap's
    order. (d) csvtbin -read regenerates (a)'s CSV from the .tbin, a row
    per sample. csvtbin must run the native scanfast scanner (g++ builds
    it; the Python replica would take hours on this CSV). Returns
    {kernel: launches} of (a) and (b)'s card decodes."""
    import numpy as np
    from readtape_tpu_torch import csvtbin, dumptap, native
    from readtape_tpu_torch.formats import csvfmt, simh
    from readtape_tpu_torch.formats import tbin as tb
    if not native.available():
        raise AssertionError("the native CSV scanner did not build (g++ "
                             "over native/readtape_io.cpp)")
    scans = []
    scan = native.csv_scan_native

    def counted(path, scanfast=False):
        scans.append(scanfast)
        return scan(path, scanfast)
    blocks, hdr, samples = bench_tape(nblocks=nblocks)
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "bench")
        csvfmt.write_csv(base + ".csv", 0.0, hdr.tdelta_ns * 1e-9,
                         samples.astype(np.float64)
                         * (hdr.maxvolts / 32767.0))
        csv_mb = os.path.getsize(base + ".csv") / 1e6
        native.csv_scan_native = counted
        try:
            t0 = time.perf_counter()
            said = run_tool(csvtbin.main, CSVTBIN_NRZI + [base + ".csv",
                                                          base + ".tbin"])
            t_csvtbin = time.perf_counter() - t0
        finally:
            native.csv_scan_native = scan
        if scans != [True]:
            raise AssertionError(f"csvtbin's scanner calls {scans}: not the "
                                 f"native scanfast scanner once")
        thdr, tsamples = tb.read_tbin(base + ".tbin")
        if tsamples.shape != samples.shape or thdr.mode != tb.MODE_NRZI:
            raise AssertionError(f"csvtbin wrote {tsamples.shape}, mode "
                                 f"{thdr.mode}; {samples.shape} expected")
        print(f"  (a) csvtbin {' '.join(CSVTBIN_NRZI)}: {csv_mb:.1f} MB CSV, "
              f"{tsamples.shape[0]:,} rows x 9 tracks, native scanfast "
              f"scanner (g++), {t_csvtbin:.3f} s wall; "
              f"{said.strip().splitlines()[-1].replace(tmp + os.sep, '')} "
              f"({card})", flush=True)

        reset_counts()
        t0 = time.perf_counter()
        run_cli(CLI_ARGS + [base + ".tbin"], DEVICE)
        wall = time.perf_counter() - t0
        launches = check_launches("csvtbin NRZI CLI", ["nrzi_fused_scan"])
        data, marks = tap_contents(base + ".tap")
        if data != blocks or marks != 2:
            raise AssertionError(f"csvtbin NRZI CLI: {len(data)} .tap "
                                 f"blocks, {marks} tapemarks; not the "
                                 f"ground truth")
        print(f"  (a) the CLI on its .tbin ({' '.join(CLI_ARGS)}): "
              f"{len(data)} .tap blocks equal to the ground truth, 2 "
              f"tapemarks, launches {launches}: CLI wall {wall:.3f} s "
              f"({card})", flush=True)

        name = "9trk_GCR/example3"
        taps = {}
        for where, dev in (("card", DEVICE), ("cpu", "cpu")):
            d = os.path.join(tmp, where)
            os.makedirs(d)
            ex = write_example(name, d)
            run_tool(csvtbin.main, CSVTBIN_GCR + [ex + ".csv", ex + ".tbin"])
            reset_counts()
            run_cli(EXAMPLES[name]["args"] + [ex + ".tbin"], dev)
            if where == "card":
                launches.update(check_launches(name, [
                    "zerocross_transitions", "gcr_zeros_scan"]))
            with open(ex + ".tap", "rb") as f:
                taps[where] = f.read()
        if taps["card"] != taps["cpu"]:
            raise AssertionError(f"{name} via csvtbin: the card's .tap "
                                 f"differs from the CPU's")
        recs = [r.kind[0] for r in simh.read_tap(ex + ".tap")]
        print(f"  (b) {name}'s CSV through csvtbin "
              f"{' '.join(CSVTBIN_GCR)}, then the CLI "
              f"({' '.join(EXAMPLES[name]['args'])}): card .tap == cpu .tap, "
              f"{len(taps['card']):,} bytes ({''.join(recs)}), launches "
              f"{launches}", flush=True)

        t0 = time.perf_counter()
        said = run_tool(dumptap.main, ["-hex", "-ebcdic", base])
        t_dump = time.perf_counter() - t0
        want = [("mark",) if r.kind == "tapemark" else
                ("!" if r.error else " ", len(r.data))
                for r in simh.read_tap(base + ".tap")
                if r.kind in ("data", "tapemark")]
        got = dump_entries(base + ".hex.EBCDIC.txt")
        if got != want or len(want) != nblocks + 2 or \
                {e[0] for e in got} != {" ", "mark"}:
            raise AssertionError(f"dumptap: {len(got)} entries, "
                                 f"{len(want)} in the .tap")
        print(f"  (c) dumptap -hex -ebcdic: {len(got) - 2} record lines of "
              f"{len(blocks[0])} bytes, no error flag, 2 tapemark "
              f"lines, in the .tap's order; {t_dump:.3f} s; "
              f"{said.strip().replace(tmp + os.sep, '')}", flush=True)

        t0 = time.perf_counter()
        run_tool(csvtbin.main, ["-read", base + ".tbin", base + ".read.csv"])
        t_read = time.perf_counter() - t0
        with open(base + ".read.csv", "rb") as f:
            rows = sum(1 for _ in f) - 2
        if rows != tsamples.shape[0]:
            raise AssertionError(f"csvtbin -read: {rows} rows, "
                                 f"{tsamples.shape[0]} samples")
        print(f"  (d) csvtbin -read: {rows:,} rows, one per sample; "
              f"{t_read:.3f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 11: -mesh
# ---------------------------------------------------------------------------

MESH_LAUNCHERS = {"nrzi_fused_scan": "nrzi_fused", "pe_fused_scan": "pe_fused",
                  "gcr_fused_scan": "gcr_fused"}


@contextlib.contextmanager
def launch_shapes(kernel):
    """The (B, P) of every launch of `kernel` (a MESH_LAUNCHERS key) while
    the block runs."""
    from readtape_tpu_torch import kernels
    name = MESH_LAUNCHERS[kernel]
    fn, seen = getattr(kernels, name), []

    def record(volts, seg_lens, leads, pa, **kw):
        seen.append((volts.shape[0], len(kw["Ws"])))
        return fn(volts, seg_lens, leads, pa, **kw)
    setattr(kernels, name, record)
    try:
        yield seen
    finally:
        setattr(kernels, name, fn)


def mesh_vs_one(name, kernel, run, mesh, card):
    """run() on one device and under `mesh`, each warm and timed; under
    the mesh with the launch counts set to 0 just before and read just
    after, and each launch's (B, P) recorded. The mesh is cleared after.
    Returns (one-device result, mesh result, {kernel: launches},
    [(B, P) per launch])."""
    from readtape_tpu_torch.parallel import mesh as pmesh

    def timed():
        run()
        sync()
        t0 = time.perf_counter()
        r = run()
        sync()
        return r, time.perf_counter() - t0
    one, t_one = timed()
    pmesh.set_decode_mesh(mesh)
    try:
        run()
        sync()
        reset_counts()
        with launch_shapes(kernel) as shapes:
            t0 = time.perf_counter()
            got = run()
            sync()
            wall = time.perf_counter() - t0
        launches = check_launches(name, [kernel])
    finally:
        pmesh.set_decode_mesh(None)
    grid = "x".join(str(v) for v in mesh.shape.values())
    print(f"  {name}: {kernel} launched {launches[kernel]} times under the "
          f"{grid} mesh, (B, P) per launch {shapes}; wall {wall:.3f} s, one "
          f"device {t_one:.3f} s ({card})", flush=True)
    return one, got, launches, shapes


def same_blocks(name, one, got, blocks=None, marks=None):
    """Two decode_tape results block for block and in tried, chosen and
    peak_hist equal; with `blocks`, the data blocks the ground truth and
    `marks` tapemarks."""
    import numpy as np
    sig = [[(b.kind, b.data, b.parmset, b.tries, b.errcount, b.warncount)
            for b in r[0]] for r in (one, got)]
    if sig[0] != sig[1]:
        raise AssertionError(f"{name}: the mesh's blocks differ from the "
                             f"one-device decode's")
    for k in ("tried", "chosen", "peak_hist"):
        if not np.array_equal(one[1][k], got[1][k]):
            raise AssertionError(f"{name}: {k} differs under the mesh")
    if blocks is not None and (
            [b.data for b in got[0] if b.kind == "data"] != blocks
            or got[1]["ntapemarks"] != marks):
        raise AssertionError(f"{name}: not the ground truth")


def replicated(name, one, samples, opts, mesh):
    """decode_tape under `mesh` with the telemetry recording: one
    resident.replicate span, inside resident.upload, whose d2d_bytes are
    the int16 tape's bytes times the mesh's other cards, and the blocks
    of `one` (the one-card decode)."""
    from readtape_tpu_torch import telemetry
    from readtape_tpu_torch.decode import pipeline as tpl
    from readtape_tpu_torch.parallel import mesh as pmesh
    pmesh.set_decode_mesh(mesh)
    try:
        with telemetry.recording() as rec:
            got = tpl.decode_tape(samples, opts, device=DEVICE)
    finally:
        pmesh.set_decode_mesh(None)
    same_blocks(name, one, got)
    reps = [s for s in rec.spans if s.name == "resident.replicate"]
    parents = {s.id: s.name for s in rec.spans}
    want = samples.astype("int16").nbytes * (len(mesh.distinct()) - 1)
    if (len(reps) != 1 or parents.get(reps[0].parent) != "resident.upload"
            or reps[0].counters.get("d2d_bytes") != want
            or rec.counters.get("d2d_bytes") != want):
        raise AssertionError(
            f"{name}: resident.replicate {[(s.ns, s.counters) for s in reps]}"
            f", d2d_bytes {rec.counters.get('d2d_bytes')}, want {want}")
    print(f"  {name}: resident.replicate {reps[0].ns / 1e6:.3f} ms, "
          f"d2d_bytes {want} ({len(mesh.distinct()) - 1} other cards); "
          f"dispatch.pad_lanes {rec.counters.get('dispatch.pad_lanes')}; "
          f"blocks equal to the one-card decode", flush=True)


def phase_mesh(card):
    """-mesh on one card: make_decode_mesh([card] * 4, parm_axis=2), a
    (data 2, parm 2) grid naming the card four times, each entry a shard
    of its own. (a) The NRZI bench tape through B1: the data axis, each
    batch padded to a multiple of 2 and halved (B=128 -> 2 x 64, B=34 ->
    2 x 17). (b) The noisy PE short-gap tape: the 8-parmset retry splits
    over the parm axis as well (B2 at P=4). (c) gcr_parmscan on phase 7's
    one-block tape, cut to 128 combos: B3 at B=1 padded to 2, P=64 split
    in 2 x 32. Each against the one-device run: blocks (for -parmscan the
    log lines) equal, and the ground truth where the tape has one. With
    more than one card, the NRZI bench tape also over make_decode_mesh()
    of every card. Returns {kernel: launches under the mesh}."""
    import torch
    from readtape_tpu_torch.decode import pipeline as tpl
    from readtape_tpu_torch.formats import tbin as tb
    from readtape_tpu_torch.parallel import mesh as pmesh
    card_dev = torch.empty(0, device=DEVICE).device
    mesh = pmesh.make_decode_mesh([card_dev] * 4, parm_axis=2)
    launches = {}
    blocks, hdr, samples = bench_tape()
    opts = tape_options(hdr, tb.MODE_NRZI, 800)

    def nrzi():
        return tpl.decode_tape(samples, opts, device=DEVICE)
    one, got, n, shapes = mesh_vs_one("(a) NRZI bench", "nrzi_fused_scan",
                                      nrzi, mesh, card)
    same_blocks("(a) NRZI bench", one, got, blocks, 2)
    if sorted(shapes) != [(17, 1), (17, 1), (64, 1), (64, 1)]:
        raise AssertionError(f"(a) NRZI bench: launches {shapes}")
    launches.update(n)

    hdr, samples = pe_short_gap_tape()
    pe_opts = tape_options(hdr, tb.MODE_PE, 1600)
    one, got, n, shapes = mesh_vs_one(
        "(b) PE short gap, 0.06 V noise", "pe_fused_scan",
        lambda: tpl.decode_tape(samples, pe_opts, device=DEVICE), mesh, card)
    same_blocks("(b) PE short gap", one, got)
    if 4 not in {p for _, p in shapes} or {p for _, p in shapes} - {1, 4}:
        raise AssertionError(f"(b) PE short gap: launches {shapes}; no "
                             f"parm shard of P=4")
    launches.update(n)

    block, hdr, samples = parmscan_tape()
    ps_opts = tape_options(hdr, tb.MODE_GCR, 9042, 25)
    span = tpl.TapeDecoder(samples, ps_opts, device=DEVICE).segments()[0]
    grid = tpl.parmscan_grid()[:128]

    def scan():
        lines = []
        tpl.gcr_parmscan(tpl.TapeDecoder(samples, ps_opts, device=DEVICE),
                         span, lines.append, combos=grid)
        return lines
    one, got, n, shapes = mesh_vs_one("(c) -parmscan, 128 combos",
                                      "gcr_fused_scan", scan, mesh, card)
    if got != one or len(got) != 128:
        raise AssertionError("(c) -parmscan: the mesh's lines differ")
    if shapes != [(1, 32)] * 8:
        raise AssertionError(f"(c) -parmscan: launches {shapes}")
    launches.update(n)

    cards = torch.cuda.device_count()
    if cards > 1:
        blocks, hdr, samples = bench_tape()
        every = pmesh.make_decode_mesh()
        one, got, n, shapes = mesh_vs_one(
            f"(d) NRZI bench over all {cards} cards", "nrzi_fused_scan",
            nrzi, every, card)
        same_blocks("(d) NRZI bench, every card", one, got, blocks, 2)
        replicated("(d) NRZI bench, every card, recorded", one, samples,
                   opts, every)
    else:
        print("  (d) NRZI bench over every card: not run, "
              "torch.cuda.device_count() is 1 (the grids above name the "
              "one card four times)", flush=True)
    return launches


# ---------------------------------------------------------------------------
# breakdown: where a bench decode's wall goes
# ---------------------------------------------------------------------------

def time_steps(samples, opts, kernel_path):
    """One warm decode_tape with a synchronize around each step it
    takes; returns (wall s, {step: [seconds, calls]})."""
    import importlib

    import torch
    from readtape_tpu_torch.decode import fused as tfu
    from readtape_tpu_torch.decode import gcr as gcr_mod
    from readtape_tpu_torch.decode import nrzi as nrzi_mod
    from readtape_tpu_torch.decode import pe as pe_mod
    from readtape_tpu_torch.decode import pipeline as tpl
    from readtape_tpu_torch.decode import scan as scan_mod
    from readtape_tpu_torch.decode import segment as seg
    from readtape_tpu_torch.decode import ww as ww_mod
    from readtape_tpu_torch.formats import tbin as tb
    steps = {}
    spots = [(seg, "tape_activity", "activity scan (kernel, copy, finish)"),
             (seg, "device_activity", "device activity scan"),
             (tpl, "_prep_volts", "window gather + volts")]
    spots += [(importlib.import_module("readtape_tpu_torch.decode."
                                       + KERNELS[name]["module"]), name,
               f"kernel {name}") for name in KERNELS]
    spots += [(tfu, "_union_jump_table", "jump table"),
              (scan_mod, "window_features", "window features"),
              (nrzi_mod, "nrzi_finish", "finish"),
              (pe_mod, "pe_finish", "finish"),
              (gcr_mod, "gcr_finish", "finish"),
              (tfu, "ww_fused_state", "read-out"),
              (ww_mod, "assemble_ww_blocks", "block assembly (host)"),
              (tpl, "_fetch", "fetch (D2H)")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in spots]

    def timed(fn, label):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            st = steps.setdefault(label, [0.0, 0])
            st[0] += time.perf_counter() - t0
            st[1] += 1
            return out
        run.__dict__.update(fn.__dict__)        # the launch counters
        return run
    for mod, name, label in spots:
        setattr(mod, name, timed(getattr(mod, name), label))
    try:
        sync()
        t0 = time.perf_counter()
        dec = None
        if opts.mode != tb.MODE_WW:       # a Whirlwind tape decodes whole
            dec = tpl.TapeDecoder(samples, opts, device=DEVICE,
                                  kernel_path=kernel_path)
            sync()
            steps["TapeDecoder (scan + upload)"] = [time.perf_counter() - t0,
                                                    1]
        tpl.decode_tape(samples, opts, device=DEVICE, decoder=dec)
        sync()
        wall = time.perf_counter() - t0
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return wall, steps


def busy_share(samples, opts, kernel_path):
    """(wall s, CUDA kernel time s) of one decode under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from readtape_tpu_torch.decode import pipeline as tpl
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        tpl.decode_tape(samples, opts, device=DEVICE,
                        kernel_path=kernel_path)
        sync()
        wall = time.perf_counter() - t0
    dev = sum(getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0))
              for e in prof.key_averages()) / 1e6
    top = sorted(prof.key_averages(), key=lambda e: -getattr(
        e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)))
    return wall, dev, [(e.key[:40], getattr(e, "self_device_time_total",
                                            getattr(e, "self_cuda_time_total",
                                                    0)) / 1e3)
                       for e in top[:6]]


def ptxas_lines(log):
    """The per-kernel lines of nvcc -Xptxas -v: entry, registers, stack
    frame and spills."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln
            or "stack frame" in ln]


def idle_phases(st):
    """B2's or B3's per-lane phase stamps (pe_core.h PE_ST_*, as float64):
    (ns per clock64() cycle of each lane, by the global timer over the
    same span; "phase X mean .. max .. ms" for phases 0, A, B and C)."""
    ns = (st[:, 6] - st[:, 0]) / (st[:, 5] - st[:, 1])
    parts = []
    for k, label in ((2, "phase 0"), (3, "phase A"), (4, "phase B"),
                     (5, "phase C")):
        d = (st[:, k] - st[:, k - 1]) * ns / 1e6
        parts.append(f"{label} mean {float(d.mean()):.3f} max "
                     f"{float(d.max()):.3f} ms")
    return ns, parts


def kernel_phases():
    """Where B4's and B2's time goes at their main-path shapes: B4's
    launches each timed with CUDA events (mean of 3 calls after a warm
    one), and its chains from clock64() stamps: each track's admission
    walk against its block, the machine's event loop against its block;
    B2's phases from per-lane clock64() stamps (pe main: the PE bench
    decode's first launch, B=60; pe hop: its second, B=1), mean and max
    over lanes, with the longest track walk of phase A; cycles turned
    into ms by the global timer over the same span."""
    from readtape_tpu_torch import kernels
    from readtape_tpu_torch.decode import fused as tfu
    from readtape_tpu_torch.formats import tbin as tb
    _, hdr, samples = ww_bench_tape()
    (volts,), kw = first_call(kernels, "ww_fused", samples, ww_options(hdr))
    kernels.ww_phase_ms(volts, **kw)
    runs = [kernels.ww_phase_ms(volts, **kw) for _ in range(3)]
    names = ("candidacy", "admission", "rank", "machine")
    ms = [sum(r[1][i] for r in runs) / len(runs) for i in range(len(names))]
    T = volts.shape[0]
    out, st = runs[-1][0], runs[-1][2].double()
    walk_t = int(st[:T].argmax())
    steps = int(out["trk_i"][walk_t, tfu.WT_STEPS])
    nev = int(out["scal"][tfu.WS_NEVENTS])
    ns = (st[2 * T + 3] - st[2 * T + 2]) / st[2 * T + 1]   # per cycle
    walk = st[:T] * ns / 1e6
    block = st[T:2 * T] * ns / 1e6
    print("B4 ww_fused_scan per launch (WW bench, T=6 S="
          f"{volts.shape[1]}): " + ", ".join(
              f"{n} {m:.3f} ms" for n, m in zip(names, ms))
          + f"; total {sum(ms):.3f} ms; admission walk (clock64) max "
          f"{float(walk.max()):.3f} ms of its block's "
          f"{float(block[int(walk.argmax())]):.3f} ms ({steps} steps, "
          f"{float(walk.max()) * 1e6 / steps:.0f} ns per step); machine "
          f"event loop {float(st[2 * T] * ns / 1e6):.3f} ms of its block's "
          f"{float(st[2 * T + 1] * ns / 1e6):.3f} ms ({nev} events, "
          f"{float(st[2 * T] * ns) / nev:.0f} ns per event)", flush=True)
    del volts
    _, hdr, samples = pe_bench_tape()
    opts = tape_options(hdr, tb.MODE_PE, 1600)
    for case, index in (("pe main", 0), ("pe hop", 1)):
        volts, seg_lens, leads, pa, kw = main_path_inputs(
            "pe_fused", samples, opts, index=index)
        kernels.pe_phase_stamps(volts, seg_lens, leads, pa, **kw)
        _, st = kernels.pe_phase_stamps(volts, seg_lens, leads, pa, **kw)
        st = st.double()
        ns, parts = idle_phases(st)
        ns = ns.mean()
        walk = st[:, kernels.PE_ST_WALK:kernels.PE_ST_STEPS]
        steps = st[:, kernels.PE_ST_STEPS:]
        lane = int(walk.max(dim=1).values.argmax())
        track = int(walk[lane].argmax())
        per_step = float(walk[lane, track] * ns / steps[lane, track])
        walk = walk.max(dim=1).values * ns / 1e6
        whole = (st[:, 6] - st[:, 0]) / 1e6
        fn = (lambda: kernels.pe_fused(volts, seg_lens, leads, pa, **kw))
        t = time_launches(fn, 10)
        print(f"B2 pe_fused_scan {case} (B={volts.shape[0]} S="
              f"{volts.shape[2]}): kernel {t:.3f} ms; per lane (clock64): "
              + "; ".join(parts) + f"; longest track walk in phase A mean "
              f"{float(walk.mean()):.3f} max {float(walk.max()):.3f} ms "
              f"({int(steps[lane, track])} steps, {per_step:.0f} ns per "
              f"step); lane wall max {float(whole.max()):.3f} ms",
              flush=True)


def gcr_phases():
    """Where B3's time goes at its main-path shape (the GCR bench decode's
    first launch, B=40): per-lane clock64() stamps of phases 0, A, B and
    C, mean and max over lanes, and the longest track walk of phase A per
    admission and per step; cycles turned into ms by the global timer
    over the same span."""
    from readtape_tpu_torch import kernels
    from readtape_tpu_torch.decode import fused as tfu
    from readtape_tpu_torch.formats import tbin as tb
    _, hdr, samples = gcr_bench_tape()
    volts, seg_lens, leads, pa, kw = main_path_inputs(
        "gcr_fused", samples, tape_options(hdr, tb.MODE_GCR, 9042, 25))
    kernels.gcr_phase_stamps(volts, seg_lens, leads, pa, **kw)
    out, st = kernels.gcr_phase_stamps(volts, seg_lens, leads, pa, **kw)
    st = st.double()
    ns, parts = idle_phases(st)
    T = volts.shape[1]
    walk = st[:, kernels.PE_ST_WALK:kernels.PE_ST_WALK + T] * ns[:, None]
    steps = st[:, kernels.PE_ST_STEPS:kernels.PE_ST_STEPS + T]
    nadm = out["trk_i"][..., tfu.GI_NTOTAL].reshape(-1, T).double().cpu()
    lane = int(walk.max(dim=1).values.argmax())
    track = int(walk[lane].argmax())
    w = float(walk[lane, track])
    t = time_launches(lambda: kernels.gcr_fused(volts, seg_lens, leads, pa,
                                                **kw), 10)
    print(f"B3 gcr_fused_scan gcr main (B={volts.shape[0]} "
          f"P={len(kw['Ws'])} T={T} S={volts.shape[2]}): kernel {t:.3f} ms; "
          "per lane (clock64): " + "; ".join(parts)
          + f"; longest track walk in phase A {w / 1e6:.3f} ms "
          f"({int(nadm[lane, track])} admissions, "
          f"{w / float(nadm[lane, track]):.0f} ns per admission; "
          f"{int(steps[lane, track])} steps, "
          f"{w / float(steps[lane, track]):.0f} ns per step); SM clock "
          f"{float(1 / ns.mean()):.3f} GHz", flush=True)


def zeros_phases():
    """Where Z1's and Z2's time goes at their main-path shapes, from
    clock64() stamps (cycles turned into ns by the global timer over the
    same span). Z1 at the GCR -zeros bench's first launch (B=40), at the
    NRZI -zeros chain's first window (B=1) and differentiated at the
    example3 recipe's (B=40): per (segment, track) lane, thread 0's time
    in pass A (the scans and bucket records), pass B (the serial pass over
    the significant phases; none when differentiated) and pass C (the
    confirmation samples and the entries), mean and max over lanes, and
    the longest pass B per bucket. Z2 at the first retry (B=16, P=5): each
    walker's time walking per admitted transition and per list entry."""
    import dataclasses

    from readtape_tpu_torch import kernels
    from readtape_tpu_torch.formats import tbin as tb
    _, hdr, samples = gcr_bench_tape()
    gopts = tape_options(hdr, tb.MODE_GCR, 9042, 25, find_zeros=True)
    _, hdr, dvolts = gcr_diff_bench_tape()
    dopts = tape_options(hdr, tb.MODE_GCR, 9042, 25, maxvolts=32767.0,
                         differentiate=True, find_zeros=True)
    _, hdr, nsamples = bench_tape(nblocks=2)
    nopts = dataclasses.replace(tape_options(hdr, tb.MODE_NRZI, 800),
                                find_zeros=True)
    for case, smp, opts in (("z1 main", samples, gopts),
                            ("z1 chain", nsamples, nopts),
                            ("z1 diff main", dvolts, dopts)):
        (volts, seg_lens, leads), kw = first_call(kernels, "zerocross", smp,
                                                  opts)
        kernels.zerocross_stamps(volts, seg_lens, leads, **kw)
        _, st = kernels.zerocross_stamps(volts, seg_lens, leads, **kw)
        st = st.double()
        ns = (st[:, 3] - st[:, 0]) / (st[:, 2] - st[:, 1])
        parts = []
        for k, label in ((kernels.ZC_ST_A, "pass A"),
                         (kernels.ZC_ST_B, "pass B"),
                         (kernels.ZC_ST_C, "pass C")):
            d = st[:, k] * ns / 1e6
            parts.append(f"{label} mean {float(d.mean()):.3f} max "
                         f"{float(d.max()):.3f} ms")
        pb = st[:, kernels.ZC_ST_B] * ns
        lb = int(pb.argmax())
        nb = max(float(st[lb, kernels.ZC_ST_NB]), 1.0)
        wall = (st[:, 3] - st[:, 0]) / 1e6
        t = time_launches(lambda: kernels.zerocross(volts, seg_lens, leads,
                                                    **kw), 10)
        B, T, S = volts.shape
        print(f"Z1 zerocross_transitions {case} (B={B} T={T} S={S}): kernel "
              f"{t:.3f} ms; per lane (clock64): " + "; ".join(parts)
              + f"; longest pass B {float(pb[lb]) / 1e6:.3f} ms ({int(nb)} "
              f"buckets, {float(pb[lb]) / nb:.0f} ns per bucket); lane wall "
              f"mean {float(wall.mean()):.3f} max {float(wall.max()):.3f} "
              f"ms; SM clock {float(1 / ns.mean()):.3f} GHz", flush=True)
        del volts
    (trans, pa), kw = first_call(kernels, "gcr_zeros", samples, gopts,
                                 index=1)
    kernels.gcr_zeros_stamps(trans, pa, **kw)
    _, st = kernels.gcr_zeros_stamps(trans, pa, **kw)
    st = st.double()
    ns = (st[:, 3] - st[:, 0]) / (st[:, 2] - st[:, 1])
    walk = st[:, kernels.ZS_ST_WALK] * ns
    lane = int(walk.argmax())
    w = float(walk[lane])
    steps = max(float(st[lane, kernels.ZS_ST_STEPS]), 1.0)
    ent = max(float(st[lane, kernels.ZS_ST_ENT]), 1.0)
    t = time_launches(lambda: kernels.gcr_zeros(trans, pa, **kw), 10)
    B, T, cap = trans["t"].shape
    print(f"Z2 gcr_zeros_scan z2 main (B={B} P={len(pa.z1pt)} T={T} "
          f"cap={cap}): kernel {t:.3f} ms; per walker walk (clock64) mean "
          f"{float(walk.mean()) / 1e6:.3f} max {w / 1e6:.3f} ms ("
          f"{int(steps)} admitted transitions, {w / steps:.0f} ns per "
          f"transition; {int(ent)} entries, {w / ent:.0f} ns per entry); "
          f"SM clock {float(1 / ns.mean()):.3f} GHz", flush=True)


def b5b_phases():
    """Where B5b's time goes at its main-path shape (the tiered NRZI bench
    decode's first launch, B=128): per (segment, parmset, track) lane, the
    walker's clock64() cycles walking and its steps, and the lane's wall
    from its first stamp to its last; the longest walk per admission and
    per step."""
    from readtape_tpu_torch import kernels
    from readtape_tpu_torch.formats import tbin as tb
    _, hdr, samples = bench_tape()
    (feat, nxt, pa), kw = first_call(kernels, "nrzi_scan_tracks", samples,
                                     tape_options(hdr, tb.MODE_NRZI, 800),
                                     "tiered")
    kernels.scan_tracks_stamps(feat, nxt, pa, **kw)
    out, st = kernels.scan_tracks_stamps(feat, nxt, pa, **kw)
    st = st.double()
    ns = ((st[:, kernels.SCAN_ST_G1] - st[:, kernels.SCAN_ST_G0])
          / (st[:, kernels.SCAN_ST_C1] - st[:, kernels.SCAN_ST_C0]))
    walk = st[:, kernels.SCAN_ST_WALK] * ns
    steps = st[:, kernels.SCAN_ST_STEPS]
    wall = (st[:, kernels.SCAN_ST_G1] - st[:, kernels.SCAN_ST_G0]) / 1e6
    nadm = out["n_admitted"].reshape(-1).double().cpu()
    lane = int(walk.argmax())
    w = float(walk[lane])
    t = time_launches(lambda: kernels.nrzi_scan_tracks(feat, nxt, pa, **kw),
                      10)
    G, B, T, S, _ = feat.shape
    print(f"B5b nrzi_track_scan_tracks b5b main (B={B} P={len(kw['Ws'])} "
          f"T={T} S={S}): kernel {t:.3f} ms; per lane walk (clock64) mean "
          f"{float(walk.mean()) / 1e6:.3f} max {w / 1e6:.3f} ms ("
          f"{int(nadm[lane])} admissions, {w / float(nadm[lane]):.0f} ns "
          f"per admission; {int(steps[lane])} steps, "
          f"{w / float(steps[lane]):.0f} ns per step); lane wall mean "
          f"{float(wall.mean()):.3f} max {float(wall.max()):.3f} ms; SM "
          f"clock {float(1 / ns.mean()):.3f} GHz", flush=True)


def b5a_phases():
    """Where B5a's time goes at -correctdbg's launch (the NRZI bench
    decode's first, B=16, P=8, G=3): per walker (a (segment, parmset,
    track) lane), its clock64() cycles walking and waiting at its block's
    barrier after the chunks it walked (for its block's slower walkers,
    or for the staging), and its steps; the wait's share of the walk over
    all walkers; per block the least wait of its walkers (what the block
    waited for the staging alone); the longest walk per admission and
    per step, and that walker's own wait (what a deeper ring of chunks,
    letting walkers drift apart, could take off the kernel's time)."""
    from readtape_tpu_torch import kernels
    from readtape_tpu_torch.formats import tbin as tb
    _, hdr, samples = bench_tape()
    (feat, nxt, pa), kw = first_call(
        kernels, "nrzi_scan", samples,
        tape_options(hdr, tb.MODE_NRZI, 800, **DEBUG_CORRECT))
    kernels.scan_stamps(feat, nxt, pa, **kw)
    out, st = kernels.scan_stamps(feat, nxt, pa, **kw)
    st = st.double()
    ns = ((st[:, kernels.SCAN_ST_G1] - st[:, kernels.SCAN_ST_G0])
          / (st[:, kernels.SCAN_ST_C1] - st[:, kernels.SCAN_ST_C0]))
    walk = st[:, kernels.SCAN_ST_WALK] * ns
    wait = st[:, kernels.SCAN_ST_WAIT] * ns
    steps = st[:, kernels.SCAN_ST_STEPS]
    wall = (st[:, kernels.SCAN_ST_G1] - st[:, kernels.SCAN_ST_G0]) / 1e6
    nadm = out["n_admitted"].reshape(-1).double().cpu()
    G, B, T, S, _ = feat.shape
    P = len(kw["Ws"])
    # lanes (b*P + p)*T + t; a block: one (b, t), every p (P <= 8)
    least = wait.reshape(B, P, T).min(dim=1).values
    lane = int(walk.argmax())
    w = float(walk[lane])
    t = time_launches(lambda: kernels.nrzi_scan(feat, nxt, pa, **kw), 10)
    print(f"B5a nrzi_track_scan b5a correctdbg (B={B} P={P} G={G} T={T} "
          f"S={S}): kernel {t:.3f} ms; per walker walk (clock64) mean "
          f"{float(walk.mean()) / 1e6:.3f} max {w / 1e6:.3f} ms ("
          f"{int(nadm[lane])} admissions, {w / float(nadm[lane]):.0f} ns "
          f"per admission; {int(steps[lane])} steps, "
          f"{w / float(steps[lane]):.0f} ns per step; it waited "
          f"{float(wait[lane]) / 1e6:.3f} ms); barrier wait mean "
          f"{float(wait.mean()) / 1e6:.3f} max "
          f"{float(wait.max()) / 1e6:.3f} ms, "
          f"{100 * float(wait.sum() / walk.sum()):.1f}% of the walk; a "
          f"block's least wait mean {float(least.mean()) / 1e6:.3f} max "
          f"{float(least.max()) / 1e6:.3f} ms; walker wall mean "
          f"{float(wall.mean()):.3f} max {float(wall.max()):.3f} ms; SM "
          f"clock {float(1 / ns.mean()):.3f} GHz", flush=True)


def mach_note(cycles, ns, nslot):
    """The slot machine's ns per slot in each of its steps (cycles summed
    over a lane's slots, on thread 0: a step ends when every track has)."""
    from readtape_tpu_torch import kernels
    return "per slot by step " + ", ".join(
        f"{name} {float(c * ns / nslot):.0f}"
        for name, c in zip(kernels.NRZI_MACH, cycles)) + (
        f" ns (SM clock {float(1 / ns):.3f} GHz)")


def nrzi_phases():
    """Where B1's and B6's time goes at their main-path shapes (the NRZI
    bench decode's first launch of each, fused and tiered): per-lane
    clock64() stamps, cycles turned into ms by the global timer over the
    same span; mean and max over lanes. B1: phases 0, A and B, the
    longest track walk of phase A per admission, phase B per slot. B6:
    its slot machine per slot. Both: the machine's time per slot in each
    kind of step, on its longest lane."""
    from readtape_tpu_torch import kernels
    from readtape_tpu_torch.decode import fused as tfu
    from readtape_tpu_torch.formats import tbin as tb
    _, hdr, samples = bench_tape()
    opts = tape_options(hdr, tb.MODE_NRZI, 800)
    volts, seg_lens, leads, pa, kw = main_path_inputs("nrzi_fused", samples,
                                                      opts)
    kernels.nrzi_phase_stamps(volts, seg_lens, leads, pa, **kw)
    out, st = kernels.nrzi_phase_stamps(volts, seg_lens, leads, pa, **kw)
    st = st.double()
    ns = (st[:, 5] - st[:, 0]) / (st[:, 4] - st[:, 1])      # per cycle
    parts = []
    for k, label in ((2, "phase 0"), (3, "phase A"), (4, "phase B")):
        d = (st[:, k] - st[:, k - 1]) * ns / 1e6
        parts.append(f"{label} mean {float(d.mean()):.3f} max "
                     f"{float(d.max()):.3f} ms")
    T = volts.shape[1]
    walk = st[:, kernels.NRZI_ST_WALK:kernels.NRZI_ST_WALK + T] * ns[:, None]
    nadm = out["trk_i"][..., tfu.TI_NADM].reshape(-1, T).double().cpu()
    lane = int(walk.max(dim=1).values.argmax())
    track = int(walk[lane].argmax())
    phase_b = (st[:, 4] - st[:, 3]) * ns
    nslot = out["lane_i"][..., tfu.LI_NSLOT].reshape(-1).double().cpu()
    lb = int(phase_b.argmax())
    t = time_launches(lambda: kernels.nrzi_fused(volts, seg_lens, leads, pa,
                                                 **kw), 10)
    print(f"B1 nrzi_fused_scan nrzi main (B={volts.shape[0]} "
          f"P={len(kw['Ws'])} T={T} S={volts.shape[2]}): kernel {t:.3f} ms; "
          "per lane (clock64): " + "; ".join(parts)
          + f"; longest track walk in phase A "
          f"{float(walk[lane, track]) / 1e6:.3f} ms ("
          f"{int(nadm[lane, track])} admissions, "
          f"{float(walk[lane, track] / nadm[lane, track]):.0f} ns per "
          f"admission); longest phase B {float(phase_b[lb]) / 1e6:.3f} ms ("
          f"{int(nslot[lb])} slots, {float(phase_b[lb] / nslot[lb]):.0f} ns "
          f"per slot); mean phase B per slot "
          f"{float((phase_b / nslot).mean()):.0f} ns; "
          + mach_note(st[lb, kernels.NRZI_ST_MACH:], ns[lb], nslot[lb]),
          flush=True)
    del volts
    (fin, pa), kw = first_call(kernels, "nrzi_slot", samples, opts,
                               "tiered")
    kernels.slot_phase_stamps(fin, pa, **kw)
    out, st = kernels.slot_phase_stamps(fin, pa, **kw)
    st = st.double()
    ns = (st[:, 3] - st[:, 0]) / (st[:, 2] - st[:, 1])
    loop = (st[:, 2] - st[:, 1]) * ns
    nslot = out["lane_i"][..., tfu.LI_NSLOT].reshape(-1).double().cpu()
    lb = int(loop.argmax())
    t = time_launches(lambda: kernels.nrzi_slot(fin, pa, **kw), 10)
    B, P, T, K = fin["tr_s"].shape
    print(f"B6 nrzi_slot_scan b6 main (B={B} P={P} T={T} K={K}): kernel "
          f"{t:.3f} ms; slot machine per lane (clock64) mean "
          f"{float(loop.mean()) / 1e6:.3f} max {float(loop.max()) / 1e6:.3f} "
          f"ms; longest lane {int(nslot[lb])} slots, "
          f"{float(loop[lb] / nslot[lb]):.0f} ns per slot; mean per slot "
          f"{float((loop / nslot).mean()):.0f} ns; "
          + mach_note(st[lb, kernels.SLOT_ST_MACH:], ns[lb], nslot[lb]),
          flush=True)


def breakdown(card):
    from readtape_tpu_torch import kernels, native
    from readtape_tpu_torch.formats import tbin as tb
    _, _, log = kernels.build()
    for ln in ptxas_lines(log):
        print(f"  {ln}", flush=True)
    nrzi_phases()
    b5b_phases()
    b5a_phases()
    gcr_phases()
    zeros_phases()
    kernel_phases()
    print(f"host activity scan: "
          f"{'native tape_scan' if native.available() else 'numpy'}; {card}",
          flush=True)
    _, hdr, samples = bench_tape()
    nrzi = tape_options(hdr, tb.MODE_NRZI, 800)
    tapes = [("NRZI bench", samples, nrzi, "fused"),
             ("NRZI bench, tiered", samples, nrzi, "tiered"),
             ("NRZI bench, -correctdbg", samples,
              tape_options(hdr, tb.MODE_NRZI, 800, **DEBUG_CORRECT),
              "fused")]
    _, hdr, samples = pe_bench_tape()
    tapes.append(("PE bench", samples, tape_options(hdr, tb.MODE_PE, 1600),
                  "fused"))
    _, hdr, samples = gcr_bench_tape()
    tapes.append(("GCR bench", samples,
                  tape_options(hdr, tb.MODE_GCR, 9042, 25), "fused"))
    volts, maxvolts = as_volts(hdr, samples)
    tapes.append(("GCR bench, float volts", volts,
                  tape_options(hdr, tb.MODE_GCR, 9042, 25,
                               maxvolts=maxvolts), "fused"))
    tapes.append(("GCR bench, -zeros", samples,
                  tape_options(hdr, tb.MODE_GCR, 9042, 25, find_zeros=True),
                  "fused"))
    _, hdr, samples = ww_bench_tape()
    tapes.append(("WW bench", samples, ww_options(hdr), "fused"))
    from readtape_tpu_torch.decode import pipeline as tpl
    for name, samples, opts, path in tapes:
        tpl.decode_tape(samples, opts, device=DEVICE,
                        kernel_path=path)                    # warm-up
        wall, steps = time_steps(samples, opts, path)
        parts = "; ".join(f"{k} {v[0] * 1e3:.2f} ms x{v[1]}"
                          for k, v in steps.items())
        print(f"{name}: synchronized wall {wall * 1e3:.2f} ms; {parts}",
              flush=True)
        wall, dev, top = busy_share(samples, opts, path)
        print(f"{name}: profiled wall {wall * 1e3:.2f} ms, device busy "
              f"{dev * 1e3:.2f} ms ({100 * dev / wall:.1f}%); top "
              + ", ".join(f"{k} {ms:.2f} ms" for k, ms in top), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is false; the port's "
             "main path needs a CUDA card")
    sys.path.insert(0, REPO)
    try:
        from readtape_tpu_torch import kernels
    except ImportError as e:
        fail("device", f"the port is not importable next to this script: "
             f"{e}")
    if "jax" in sys.modules:
        fail("device", "jax was imported")
    t_last = [time.perf_counter()]

    def lap():
        t, t_last[0] = t_last[0], time.perf_counter()
        return t_last[0] - t
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    if sys.argv[1:] == ["breakdown"]:
        breakdown(card)
        return 0
    print(f"phase 1 device: ok, {kind}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {card}", flush=True)
    print(f"  phase 1 took {lap():.1f} s", flush=True)

    try:
        _, secs, log = kernels.build()
    except RuntimeError as e:
        fail("build", str(e))
    print(f"phase 2 build: ok in {secs:.1f} s", flush=True)
    print(f"  phase 2 took {lap():.1f} s", flush=True)
    for ln in ptxas_lines(log):
        print(f"  {ln}", flush=True)

    try:
        times = phase_kernel()
    except AssertionError as e:
        fail("kernel", str(e))
    print(f"phase 3 kernel: ok, all {len(KERNELS)} kernels equal to plain "
          f"({card})", flush=True)
    print(f"  phase 3 took {lap():.1f} s", flush=True)

    try:
        runs = phase_main(card)
    except AssertionError as e:
        fail("main", str(e))
    print("phase 4 main: ok, " + "; ".join(
        f"{k} {w:.3f} s, {m:.3f} Msamples/s, {n} launches"
        if w is not None else f"{k} {n} launches"
        for k, (n, w, m) in runs.items()) + f" ({card})", flush=True)
    print(f"  phase 4 took {lap():.1f} s", flush=True)

    try:
        phase_golden()
    except AssertionError as e:
        fail("golden", str(e))
    print(f"phase 5 golden: ok, {len(GOLDEN_CASES)} NRZI, PE, GCR and "
          f"Whirlwind .tap hashes match through the port's command line, "
          f"the NRZI ones also through the tiered kernels", flush=True)
    print(f"  phase 5 took {lap():.1f} s", flush=True)

    try:
        n = phase_cli(card)
    except AssertionError as e:
        fail("cli", str(e))
    print(f"phase 6 cli: ok, the NRZI bench through the command line, "
          f"launches {n} ({card})", flush=True)
    print(f"  phase 6 took {lap():.1f} s", flush=True)

    try:
        times["gcr parmscan"], n = phase_parmscan(card)
    except AssertionError as e:
        fail("parmscan", str(e))
    print(f"phase 7 parmscan: ok, B3 at B=1 P=64 equal to plain, the "
          f"5,280-combo grid in {n} launches ({card})", flush=True)
    print(f"  phase 7 took {lap():.1f} s", flush=True)
    try:
        runs.update(phase_options(card))
    except AssertionError as e:
        fail("options", str(e))
    print(f"phase 8 options: ok, -adjskew and -correctdbg card == cpu on "
          f"their recipes, the bench tape under each to its ground truth "
          f"({card})", flush=True)
    print(f"  phase 8 took {lap():.1f} s", flush=True)
    try:
        runs.update(phase_trace(card))
    except AssertionError as e:
        fail("trace", str(e))
    print(f"phase 9 trace: ok, -trace on the four bench tapes through the "
          f"command line, each .trace.csv equal to the CPU's ({card})",
          flush=True)
    print(f"  phase 9 took {lap():.1f} s", flush=True)
    try:
        n = phase_tools(card)
    except AssertionError as e:
        fail("tools", str(e))
    print(f"phase 10 tools: ok, a CSV capture through csvtbin, decoded on "
          f"the card and dumped by dumptap, through the port alone, "
          f"launches {n} ({card})", flush=True)
    print(f"  phase 10 took {lap():.1f} s", flush=True)
    try:
        n = phase_mesh(card)
    except AssertionError as e:
        fail("mesh", str(e))
    print(f"phase 11 mesh: ok, the NRZI bench (data axis), the noisy PE "
          f"short-gap tape (parm axis) and 128 -parmscan combos under a "
          f"2x2 mesh of the card equal to one device, launches {n} "
          f"({card})", flush=True)
    print(f"  phase 11 took {lap():.1f} s", flush=True)
    if any(m == "jax" or m.startswith("jax.") or m == "readtape_tpu"
           or m.startswith("readtape_tpu.") for m in sys.modules):
        fail("mesh", "jax or the JAX package was imported")

    line = []
    for name, main_case in (("nrzi_fused_scan", "nrzi main"),
                            ("nrzi_track_scan", "b5a main"),
                            ("nrzi_track_scan_tracks", "b5b main"),
                            ("nrzi_slot_scan", "b6 main"),
                            ("pe_fused_scan", "pe main"),
                            ("gcr_fused_scan", "gcr main"),
                            ("ww_fused_scan", "ww main"),
                            ("zerocross_transitions", "z1 main"),
                            ("gcr_zeros_scan", "z2 main"),
                            ("nrzi_slot_scan -adjskew", "b6 adjskew"),
                            ("nrzi_slot_scan -correctdbg", "b6 correctdbg"),
                            ("nrzi_track_scan_tracks -adjskew", "b5b adjskew"),
                            ("nrzi_track_scan -correctdbg",
                             "b5a correctdbg"),
                            ("nrzi_track_scan_tracks -trace", "b5b trace"),
                            ("nrzi_slot_scan -trace", "b6 trace"),
                            ("pe_fused_scan -trace", "pe trace"),
                            ("gcr_fused_scan -trace", "gcr trace"),
                            ("ww_fused_scan -trace", "ww trace"),
                            ("activity_scan", "activity nrzi")):
        r = times[main_case]
        kernel = name.split()[0]
        line.append(dict(
            name=name, route="cuda", source=KERNELS[kernel]["source"],
            replaces=KERNELS[kernel]["replaces"], launches=runs[name][0],
            max_abs_err=max(v["err"] for k, v in times.items()
                            if k.split()[0] == main_case.split()[0]),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None))
    print(json.dumps({"kernels": line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
