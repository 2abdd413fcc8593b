#!/usr/bin/env python3
"""Drive the PyTorch port's NRZI, PE, GCR and Whirlwind paths on one
NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, in order; each prints its lines, and the first failure exits
non-zero:

  1. device   a CUDA card is present (there is no CPU path); its name and
              power limit
  2. build    nvcc builds readtape_tpu_torch/csrc into build/torch_kernels
              (one compiler process per source, all started together)
  3. kernel   each CUDA kernel against its plain PyTorch version on the
              card: nrzi_fused_scan on synthesized 9-track segments (B=4,
              8 parmsets, S=16384, one noisy), with -correct, on 7-track
              segments and on the first batch that phase 4's NRZI decode
              hands it; pe_fused_scan on synthesized 9-track PE segments
              (B=4, 8 parmsets, S=16384: clean, noisy with a weak track, a
              dropout that forces fake bits, two blocks behind a short gap
              so that the all-idle point falls inside the window) and on
              the first batch of phase 4's PE decode; gcr_fused_scan on
              synthesized 9-track GCR segments (B=4, 5 parmsets, S=16384:
              clean, noisy, one weak track, two blocks behind a short gap)
              and on the first batch of phase 4's GCR decode;
              ww_fused_scan on a noisy 6-track Whirlwind tape (about
              160,000 samples, one weak track, -fluxdir=auto) as decode_tape
              hands it, and again with a rolling-base span of 2^14 samples
              so that the base moves, and on the Whirlwind bench tape as
              decode_tape hands it, there against the plain version run
              on a host copy of the same inputs (on the card its
              ~300,000 events would take many minutes); all timed
  4. main     decode_tape on the card at bench scale, each path with the
              launch counts set to 0 just before it and read just after:
              NRZI (160 blocks of 1200 bytes, 2 tapemarks, seed 2026, 8
              parmsets), PE (60 blocks of 1200 bytes, seed 4100, 8
              parmsets), GCR (40 blocks of 1200 bytes, seed 5100, 5
              parmsets) and Whirlwind (12 blocks of 400 words, seed 6100,
              -fluxdir=neg, one pass), each run twice; every block against
              the synthesizer's ground truth, and proof that the decode went
              through the kernel. Then a Whirlwind tape of 24 such blocks
              (beyond 2^22 samples, so the rolling base moves) against its
              ground truth; noisy PE and GCR tapes with short gaps (the
              all-idle point, the PE walk, the all-parmset retry), a GCR
              tape whose segment holds two blocks (a multi-block round) and
              a skewed Whirlwind tape under -deskew (two passes) decoded on
              the card and on the CPU, block for block equal
  5. golden   the four NRZI, two PE, one GCR and one Whirlwind example
              tapes decoded on the card and written as .tap; SHA-256
              against examples/golden.json

Then one JSON line describing the kernels, the card's name and power
limit as nvidia-smi reports them, and a last JSON line {"ok": true, ...}.

    python3 chip_smoke.py breakdown

runs none of the checks: it times where a warm decode_tape of each bench
tape spends its wall (each step with a synchronize around it), then
profiles one more decode with torch.profiler for the card's busy time.
Imports nothing of JAX and nothing of the JAX package: the example tapes
come from the port's own synthesizer and the recipe table below.
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# the port's kernels: the CUDA source and the TPU kernel each replaces (the
# function that reaches pl.pallas_call)
KERNELS = {
    "nrzi_fused_scan": dict(
        source="readtape_tpu_torch/csrc/nrzi_fused.cu",
        replaces="readtape_tpu/decode/pallas_fused.py:1102"),
    "pe_fused_scan": dict(
        source="readtape_tpu_torch/csrc/pe_fused.cu",
        replaces="readtape_tpu/decode/pallas_fused.py:1760"),
    "gcr_fused_scan": dict(
        source="readtape_tpu_torch/csrc/gcr_fused.cu",
        replaces="readtape_tpu/decode/pallas_fused.py:2326"),
    "ww_fused_scan": dict(
        source="readtape_tpu_torch/csrc/ww_fused.cu",
        replaces="readtape_tpu/decode/pallas_fused.py:3104"),
}
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


def reset_counts():
    from readtape_tpu_torch.decode import fused as tfu
    for name in KERNELS:
        getattr(tfu, name).launches = 0
        getattr(tfu, name + "_plain").calls = 0


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
                  device):
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
    volts = tpl._prep_volts(v, maxvolts, 1.0, None, differentiate=False,
                            spb_int=int(spb), apply_skew=False).contiguous()
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


def tape_options(hdr, mode, bpi, ips=50.0):
    from readtape_tpu_torch.decode import pipeline as tpl
    return tpl.DecodeOptions(mode=mode, ntrks=hdr.ntrks, bpi=bpi, ips=ips,
                             deltat=hdr.tdelta_ns * 1e-9,
                             maxvolts=hdr.maxvolts)


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


def first_call(module, name, samples, opts):
    """(args, kwargs) of the first call of module.<name> that decode_tape
    makes on `samples`: the shape the main path gives it. The function is
    wrapped only for this one decode."""
    from readtape_tpu_torch.decode import pipeline as tpl
    seen = []
    fn = getattr(module, name)

    def record(*args, **kw):
        seen.append((args, kw))
        return fn(*args, **kw)
    setattr(module, name, record)
    try:
        tpl.decode_tape(samples, opts, device=DEVICE)
    finally:
        setattr(module, name, fn)
    if not seen:
        raise AssertionError(f"decode_tape never reached {name}")
    return seen[0]


def main_path_inputs(launcher, samples, opts):
    """The arguments of the first launch of kernels.<launcher> that
    decode_tape makes on `samples`: the shape the main path gives that
    kernel. The launcher is wrapped only for this one decode."""
    from readtape_tpu_torch import kernels
    (volts, seg_lens, leads, pa), kw = first_call(kernels, launcher, samples,
                                                  opts)
    return volts, seg_lens, leads, pa, kw


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def bound(name, volts, out, ops):
    """The least time (ms) the card could take for one call: the bytes it
    must move (each input read once, each output written once) over the
    memory rate, or its f32 operations over the f32 rate, whichever is
    larger. Returns (ms, "bytes" | "operations")."""
    nbytes = volts.numel() * volts.element_size() + sum(
        t.numel() * t.element_size() for t in out.values())
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def compare_kernel(name, kernel, volts, seg_lens, leads, pa, kw):
    """One launch of `kernel` (a decode.fused wrapper's name) against its
    plain version on the same card inputs. Returns a dict with the max
    abs f32 error, kernel ms, plain ms and the bound."""
    import torch
    from readtape_tpu_torch.decode import fused as tfu
    kern = getattr(tfu, kernel)
    plain = getattr(tfu, kernel + "_plain")
    got = kern(volts, seg_lens, leads, pa, **kw)
    sync()
    t0 = time.perf_counter()
    want = plain(volts, seg_lens, leads, pa, **kw)
    sync()
    t_plain = (time.perf_counter() - t0) * 1e3
    for k in want:
        if k == "trk_f":
            continue
        if not torch.equal(got[k], want[k]):
            bad = (got[k] != want[k]).nonzero()[:5].tolist()
            raise AssertionError(f"{name}: {k} differs at {bad}")
    err = float((got["trk_f"] - want["trk_f"]).abs().max())
    if not err <= F32_TOL:
        raise AssertionError(f"{name}: f32 fields differ by {err}")
    ti = want["trk_i"]
    dc, nadm = {"nrzi_fused_scan": (tfu.TI_DC, tfu.TI_NADM),
                "pe_fused_scan": (tfu.PI_DC, tfu.PI_NTOTAL),
                "gcr_fused_scan": (tfu.GI_DC, tfu.GI_NTOTAL)}[kernel]
    if int(ti[..., dc].max()) < 150:
        raise AssertionError(f"{name}: segments decoded too little")
    n_adm = int(ti[..., nadm].sum())
    t_kern = time_launches(lambda: kern(volts, seg_lens, leads, pa, **kw), 10)
    b_ms, b_by = bound(name, volts, want, kernel_ops(volts, kw, n_adm))
    B, T, S = volts.shape
    print(f"  {name} (B={B} P={len(kw['Ws'])} T={T} S={S}): kernel "
          f"{t_kern:.3f} ms, plain {t_plain:.1f} ms, bound {b_ms:.4f} ms "
          f"({b_by}), equal (max f32 err {err})", flush=True)
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


def compare_ww(name, volts, kw, plain_device=DEVICE):
    """One ww_fused_scan launch on the card against ww_fused_scan_plain
    on the same inputs, copied to `plain_device` first: every output
    equal, integers, characters and floats (F32_TOL). Returns
    compare_kernel's dict."""
    import torch
    from readtape_tpu_torch.decode import fused as tfu
    got = tfu.ww_fused_scan(volts, **kw)
    sync()
    got = {k: v.to(plain_device) for k, v in got.items()}
    p_volts = volts.to(plain_device)
    p_kw = {k: v.to(plain_device) if torch.is_tensor(v) else v
            for k, v in kw.items()}
    t0 = time.perf_counter()
    want = tfu.ww_fused_scan_plain(p_volts, **p_kw)
    sync()
    t_plain = (time.perf_counter() - t0) * 1e3
    for k in want:
        if k in ("blk_f", "trk_f"):
            continue
        if not torch.equal(got[k], want[k]):
            bad = (got[k] != want[k]).nonzero()[:5].tolist()
            raise AssertionError(f"{name}: {k} differs at {bad}")
    err = max(float((got[k] - want[k]).abs().max()) for k in ("blk_f",
                                                              "trk_f"))
    if not err <= F32_TOL:
        raise AssertionError(f"{name}: f32 fields differ by {err}")
    sc = want["scal"]
    if int(sc[tfu.WS_NBLOCKS]) < 3 or int(sc[tfu.WS_DATACOUNT]) < 1000:
        raise AssertionError(f"{name}: the tape decoded too little")
    t_kern = time_launches(lambda: tfu.ww_fused_scan(volts, **kw), 3)
    b_ms, b_by = bound(name, volts, want, ww_ops(volts, want, kw["W"]))
    T, S = volts.shape
    print(f"  {name} (T={T} S={S} span={kw['span']}): kernel {t_kern:.3f} "
          f"ms, plain on {plain_device} {t_plain:.1f} ms, bound {b_ms:.4f} "
          f"ms ({b_by}), {int(sc[tfu.WS_NEVENTS])} events, base "
          f"{int(sc[tfu.WS_BASE])}, equal (max f32 err {err})", flush=True)
    return dict(err=err, ms=t_kern, plain_ms=t_plain, bound_ms=b_ms,
                bound_by=b_by, out=want)


def phase_ww_kernel():
    """B4: kernel vs plain on ww_tape, once as the decode gives it
    (-fluxdir=auto) and once with a rolling-base span of 2^14 samples,
    the plain version on the card; then on the bench tape as decode_tape
    hands it (the main path's shape), with the plain version on a host
    copy of the same inputs: it makes a host round trip per event, and on
    the card its ~300,000 events would take about 7 minutes, on the host
    about 1.5. Its f32 operations round alike on both devices (common.fma
    and common.fdiv)."""
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
    res["ww main"] = compare_ww("ww main", volts, kw, plain_device="cpu")
    print(f"  ww main: the comparison took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return res


def phase_kernel():
    """Kernel vs plain on the card. Returns {case: compare_kernel dict}."""
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
    r = res["pe 9trk"] = compare_kernel(
        "pe 9trk", "pe_fused_scan", *pe_kernel_inputs(16384, seed=5))
    lane = r["out"]["lane_i"]
    if not (bool((lane[..., tfu.PL_TAU] < 16384).any())
            and int(r["out"]["faked"].sum()) > 0):
        raise AssertionError("pe 9trk: no lane reached its all-idle point "
                             "or no fake bits")
    _, hdr, samples = pe_bench_tape()
    res["pe main"] = compare_kernel(
        "pe main", "pe_fused_scan", *main_path_inputs(
            "pe_fused", samples, tape_options(hdr, tb.MODE_PE, 1600)))
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
    for r in res.values():
        r.pop("out", None)
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 4: the main paths at bench scale
# ---------------------------------------------------------------------------

def decode_bench(name, kernel, blocks, hdr, samples, opts, card, marks):
    """decode_tape on the card, warm-up then timed with the launch counts
    set to 0 just before and read just after; every block against the
    ground truth. Returns (launches of `kernel`, wall seconds, Msamples/s)."""
    from readtape_tpu_torch.decode import fused as tfu
    from readtape_tpu_torch.decode import pipeline as tpl
    tpl.decode_tape(samples, opts, device=DEVICE)          # warm-up run
    sync()
    reset_counts()
    t0 = time.perf_counter()
    out, stats = tpl.decode_tape(samples, opts, device=DEVICE)
    sync()
    wall = time.perf_counter() - t0
    launches = getattr(tfu, kernel).launches
    plain_calls = getattr(tfu, kernel + "_plain").calls
    data = [b.data for b in out if b.kind == "data"]
    if data != blocks:
        bad = [i for i, (x, y) in enumerate(zip(data, blocks)) if x != y]
        raise AssertionError(f"{name}: {len(data)} data blocks, "
                             f"{len(blocks)} expected; first differing "
                             f"{bad[:5]}")
    if stats["ntapemarks"] != marks or stats["nerrblocks"] != 0:
        raise AssertionError(f"{name}: ntapemarks {stats['ntapemarks']}, "
                             f"nerrblocks {stats['nerrblocks']}")
    if launches <= 0:
        raise AssertionError(f"{name}: the main path never launched "
                             f"{kernel}")
    if plain_calls != 0:
        raise AssertionError(f"{name}: the main path ran the plain "
                             f"version {plain_calls} times")
    msps = samples.shape[0] / wall / 1e6
    print(f"  {name}: {samples.shape[0]:,} samples, {len(out)} blocks, "
          f"{launches} {kernel} launches: {wall:.3f} s wall, "
          f"{msps:.3f} Msamples/s ({card})", flush=True)
    return launches, wall, msps


def phase_short_gap(name, kernel, hdr, samples, opts, card):
    """A noisy short-gap tape on the card and on the CPU (plain versions):
    block for block equal, with the run statistics."""
    import numpy as np
    from readtape_tpu_torch.decode import fused as tfu
    from readtape_tpu_torch.decode import pipeline as tpl
    reset_counts()
    out_gpu, st_gpu = tpl.decode_tape(samples, opts, device=DEVICE)
    sync()
    launches = getattr(tfu, kernel).launches
    if getattr(tfu, kernel + "_plain").calls or not launches:
        raise AssertionError(f"{name}: the card decode did not run on the "
                             f"kernel alone")
    out_cpu, st_cpu = tpl.decode_tape(samples, opts, device="cpu")
    if out_gpu != out_cpu:
        raise AssertionError(f"{name}: card {[b.kind for b in out_gpu]}"
                             f" != cpu {[b.kind for b in out_cpu]}")
    for k in ("peak_hist", "tried", "chosen"):
        if not np.array_equal(st_gpu[k], st_cpu[k]):
            raise AssertionError(f"{name}: {k} differs")
    print(f"  {name}: {len(out_gpu)} blocks "
          f"{[(b.kind, len(b.data), b.errcount) for b in out_gpu]}, tried "
          f"{st_gpu['tried'].tolist()}, {launches} launches; card == cpu "
          f"({card})", flush=True)


def phase_main(card):
    from readtape_tpu_torch import native
    from readtape_tpu_torch.formats import tbin as tb
    print(f"  host activity scan: "
          f"{'native tape_scan' if native.available() else 'numpy'}",
          flush=True)
    blocks, hdr, samples = bench_tape()
    nrzi = decode_bench("NRZI bench", "nrzi_fused_scan", blocks, hdr,
                        samples, tape_options(hdr, tb.MODE_NRZI, 800), card,
                        marks=2)
    blocks, hdr, samples = pe_bench_tape()
    pe = decode_bench("PE bench", "pe_fused_scan", blocks, hdr, samples,
                      tape_options(hdr, tb.MODE_PE, 1600), card, marks=0)
    blocks, hdr, samples = gcr_bench_tape()
    gcr = decode_bench("GCR bench", "gcr_fused_scan", blocks, hdr, samples,
                       tape_options(hdr, tb.MODE_GCR, 9042, 25), card,
                       marks=0)
    hdr, samples = pe_short_gap_tape()
    phase_short_gap("PE short gap, 0.06 V noise", "pe_fused_scan", hdr,
                    samples, tape_options(hdr, tb.MODE_PE, 1600), card)
    hdr, samples = gcr_short_gap_tape()
    phase_short_gap("GCR short gap, 0.07 V noise", "gcr_fused_scan", hdr,
                    samples, tape_options(hdr, tb.MODE_GCR, 9042, 25), card)
    hdr, samples = gcr_merged_tape()
    phase_short_gap("GCR merged blocks (multi-block round)",
                    "gcr_fused_scan", hdr, samples,
                    tape_options(hdr, tb.MODE_GCR, 9042, 25), card)
    blocks, hdr, samples = ww_bench_tape()
    ww = decode_bench("WW bench", "ww_fused_scan", blocks, hdr, samples,
                      ww_options(hdr), card, marks=0)
    # 24 blocks: about 5.2 million samples, so the machine's rolling base
    # moves (its span is 2^22 samples)
    blocks, hdr, samples = ww_bench_tape(nblocks=24)
    if samples.shape[0] <= (1 << 22) + 200_000:
        raise AssertionError("the long WW tape is too short")
    decode_bench("WW long tape", "ww_fused_scan", blocks, hdr, samples,
                 ww_options(hdr), card, marks=0)
    hdr, samples = ww_deskew_tape()
    phase_short_gap("WW -deskew (two passes)", "ww_fused_scan", hdr,
                    samples, ww_options(hdr, deskew=True), card)
    return {"nrzi_fused_scan": nrzi, "pe_fused_scan": pe,
            "gcr_fused_scan": gcr, "ww_fused_scan": ww}


# ---------------------------------------------------------------------------
# phase 5: golden .tap hashes
# ---------------------------------------------------------------------------

def write_tap(path, blocks):
    """.tap output as readtape_tpu.cli.write_outputs writes it: tapemarks,
    data blocks flagged when errcount > 0, unusable and empty blocks
    skipped, then end of medium."""
    from readtape_tpu_torch.formats.simh import TapWriter
    w = TapWriter(path)
    for blk in blocks:
        if blk.kind == "tapemark":
            w.write_tapemark()
        elif blk.kind == "data" and len(blk.data):
            w.write_block(blk.data, error=blk.errcount > 0)
    w.write_eom()
    w.close()


def golden_options(args, hdr):
    """DecodeOptions fields for an example's command line, resolved the
    way readtape_tpu.cli.process_file does: the mode, -ntrks, -bpi and
    -ips from the command line, else the .tbin header's (-whirlwind sets
    100 bpi); deltat, maxvolts and the Whirlwind track order from the
    header ("CMLcml" without one); -fluxdir= and -reverse. Every example
    carries its density, so no density detection (bpi <= 0) is needed."""
    from readtape_tpu_torch.formats import tbin as tb
    kv = dict(a[1:].split("=", 1) for a in args if "=" in a)
    ww = "-whirlwind" in args
    mode = (tb.MODE_PE if "-pe" in args else
            tb.MODE_NRZI if "-nrzi" in args else
            tb.MODE_GCR if "-gcr" in args else
            tb.MODE_WW if ww else hdr.mode)
    bpi = float(kv.get("bpi", 100 if ww else hdr.bpi or 0))
    if bpi <= 0:
        raise AssertionError("example header carries no density")
    return dict(mode=mode, ntrks=int(kv.get("ntrks", hdr.ntrks)),
                bpi=bpi, ips=float(kv.get("ips", hdr.ips or 50.0)),
                deltat=hdr.tdelta_ns * 1e-9, maxvolts=hdr.maxvolts,
                multiple_tries="-m" in args, deskew="-deskew" in args,
                t0_seconds=hdr.tstart_ns * 1e-9,
                fluxdir=kv.get("fluxdir", "neg"), reverse="-reverse" in args,
                ww_order=hdr.trkorder or "CMLcml")


def decode_example(name, device, directory):
    """Decode one example tape on `device` into <directory>/<name>.tap;
    returns (blocks, SHA-256 of the .tap)."""
    from readtape_tpu_torch.decode import pipeline as tpl
    hdr, samples = build_example(name)
    opts = tpl.DecodeOptions(**golden_options(EXAMPLES[name]["args"], hdr))
    blocks, _ = tpl.decode_tape(samples, opts, device=device)
    path = os.path.join(directory, name.replace("/", "_") + ".tap")
    write_tap(path, blocks)
    with open(path, "rb") as f:
        return blocks, hashlib.sha256(f.read()).hexdigest()


def phase_golden():
    with open(os.path.join(REPO, "examples", "golden.json")) as f:
        golden = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        for name in GOLDEN_CASES:
            blocks, h = decode_example(name, DEVICE, tmp)
            if h != golden[name]:
                raise AssertionError(f"{name}: sha256 {h[:16]} != golden "
                                     f"{golden[name][:16]}")
            print(f"  {name}: {len(blocks)} blocks, sha256 {h[:16]} ok",
                  flush=True)


# ---------------------------------------------------------------------------
# breakdown: where a bench decode's wall goes
# ---------------------------------------------------------------------------

def time_steps(samples, opts):
    """One warm decode_tape with a synchronize around each step it
    takes; returns (wall s, {step: [seconds, calls]})."""
    import torch
    from readtape_tpu_torch.decode import fused as tfu
    from readtape_tpu_torch.decode import gcr as gcr_mod
    from readtape_tpu_torch.decode import nrzi as nrzi_mod
    from readtape_tpu_torch.decode import pe as pe_mod
    from readtape_tpu_torch.decode import pipeline as tpl
    from readtape_tpu_torch.decode import segment as seg
    from readtape_tpu_torch.decode import ww as ww_mod
    from readtape_tpu_torch.formats import tbin as tb
    steps = {}
    spots = [(seg, "host_activity", "host activity scan"),
             (tpl, "_prep_volts", "window gather + volts")]
    spots += [(tfu, name, "kernel") for name in KERNELS]
    spots += [(nrzi_mod, "nrzi_finish", "finish"),
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
            dec = tpl.TapeDecoder(samples, opts, device=DEVICE)
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


def busy_share(samples, opts):
    """(wall s, CUDA kernel time s) of one decode under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from readtape_tpu_torch.decode import pipeline as tpl
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        tpl.decode_tape(samples, opts, device=DEVICE)
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


def breakdown(card):
    from readtape_tpu_torch import kernels, native
    from readtape_tpu_torch.formats import tbin as tb
    kernels.build()
    print(f"host activity scan: "
          f"{'native tape_scan' if native.available() else 'numpy'}; {card}",
          flush=True)
    _, hdr, samples = bench_tape()
    tapes = [("NRZI bench", samples, tape_options(hdr, tb.MODE_NRZI, 800))]
    _, hdr, samples = pe_bench_tape()
    tapes.append(("PE bench", samples, tape_options(hdr, tb.MODE_PE, 1600)))
    _, hdr, samples = gcr_bench_tape()
    tapes.append(("GCR bench", samples,
                  tape_options(hdr, tb.MODE_GCR, 9042, 25)))
    _, hdr, samples = ww_bench_tape()
    tapes.append(("WW bench", samples, ww_options(hdr)))
    from readtape_tpu_torch.decode import pipeline as tpl
    for name, samples, opts in tapes:
        tpl.decode_tape(samples, opts, device=DEVICE)        # warm-up
        wall, steps = time_steps(samples, opts)
        parts = "; ".join(f"{k} {v[0] * 1e3:.2f} ms x{v[1]}"
                          for k, v in steps.items())
        print(f"{name}: synchronized wall {wall * 1e3:.2f} ms; {parts}",
              flush=True)
        wall, dev, top = busy_share(samples, opts)
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
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    if sys.argv[1:] == ["breakdown"]:
        breakdown(card)
        return 0
    print(f"phase 1 device: ok, {kind}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {card}", flush=True)

    try:
        _, secs, log = kernels.build()
    except RuntimeError as e:
        fail("build", str(e))
    ptx = [ln.strip() for ln in log.splitlines()
           if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    print(f"phase 2 build: ok in {secs:.1f} s", flush=True)
    for ln in ptx:
        print(f"  {ln}", flush=True)

    try:
        times = phase_kernel()
    except AssertionError as e:
        fail("kernel", str(e))
    print(f"phase 3 kernel: ok, all {len(KERNELS)} kernels equal to plain "
          f"({card})", flush=True)

    try:
        runs = phase_main(card)
    except AssertionError as e:
        fail("main", str(e))
    print("phase 4 main: ok, " + "; ".join(
        f"{k} {w:.3f} s, {m:.3f} Msamples/s, {n} launches"
        for k, (n, w, m) in runs.items()) + f" ({card})", flush=True)

    try:
        phase_golden()
    except AssertionError as e:
        fail("golden", str(e))
    print(f"phase 5 golden: ok, {len(GOLDEN_CASES)} NRZI, PE, GCR and "
          f"Whirlwind .tap hashes match", flush=True)
    if any(m == "jax" or m.startswith("jax.") or m == "readtape_tpu"
           or m.startswith("readtape_tpu.") for m in sys.modules):
        fail("golden", "jax or the JAX package was imported")

    line = []
    for name, main_case in (("nrzi_fused_scan", "nrzi main"),
                            ("pe_fused_scan", "pe main"),
                            ("gcr_fused_scan", "gcr main"),
                            ("ww_fused_scan", "ww main")):
        r = times[main_case]
        line.append(dict(
            name=name, route="cuda", source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"], launches=runs[name][0],
            max_abs_err=max(v["err"] for k, v in times.items()
                            if k.startswith(main_case.split()[0])),
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
