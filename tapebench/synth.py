"""The benchmark's capture synthesizer.

A frozen copy of readtape_tpu_torch/synth/synthesize.py's NRZI and PE
encoders and renderer, and of formats/tbin.py's int16 conversion, with
the per-bit loops written as array operations and the waveform rendered
on the card (the transitions' Gaussian pulses summed in float64, then
rounded to float32, the noise drawn from a torch.Generator there), in
well under a second a capture. Tapes come out alike in every respect the
decoder sees, not sample for sample: the same seed gives the same
capture here, which is all the benchmark needs. Each capture's payloads
are known by construction, and each item's time span is returned beside
them.

Two additions to the copy: a capture has exactly the configuration's
``samples`` (the documented capture's count), its inter-block gaps
sized to fill it, and each track's transitions may lie ``skew_bits``
late, the head skew that ``-deskew`` calibrates out.
"""

from __future__ import annotations

import numpy as np
import torch

MODE_PE, MODE_NRZI = 0x01, 0x02
ENCODINGS = {"NRZI": MODE_NRZI, "PE": MODE_PE}
# the shortest inter-block gap a capture may be given: the decoders'
# segmentation needs a few ms of idle tape between blocks
MIN_GAP_SECS = 0.004


def _parity(values: np.ndarray, even: bool = False) -> np.ndarray:
    ones = np.zeros_like(values)
    for k in range(8):
        ones ^= (values >> k) & 1
    return ones ^ (0 if even else 1)


def frames_of(data: bytes) -> np.ndarray:
    """Data byte << 1 | odd parity: the reference's 9-track frame layout
    (decoder.c:101)."""
    v = np.frombuffer(data, np.uint8).astype(np.int64)
    return (v << 1) | _parity(v)


def nrzi_crc9(frames) -> int:
    """9-track NRZI CRC, IBM Form A22-6862-4 (decode_nrzi.c:56-67)."""
    crc = 0
    for f in frames.tolist():
        crc ^= f
        if crc & 2:
            crc ^= 0xF0
        lsb = crc & 1
        crc >>= 1
        if lsb:
            crc |= 0x100
    return crc ^ 0x1AF


def nrzi_block_frames(data: bytes) -> np.ndarray:
    """Data frames, then 00 00 00 CRC 00 00 00 LRC (decode_nrzi.c:41-45)."""
    frames = frames_of(data)
    crc = nrzi_crc9(frames)
    lrc = (crc ^ int(np.bitwise_xor.reduce(frames))) & 0x1FF
    return np.concatenate([frames, [0, 0, 0, crc, 0, 0, 0, lrc]])


NRZI_TAPEMARK = np.array([0x26, 0, 0, 0, 0, 0, 0, 0, 0x26])


def _nrzi_transitions(frames, t0, bs, ntrks):
    """NRZI: a flux transition at the bit time of every 1."""
    t = t0 + np.arange(len(frames)) * bs
    per = [t[((frames >> (ntrks - 1 - trk)) & 1) == 1] for trk in range(ntrks)]
    return [(x, None) for x in per], t0 + len(frames) * bs


def _pe_transitions(data, t0, bs, ntrks):
    """PE: 1 an up transition at the bit centre, 0 a down one, a phase
    transition at the boundary between equal bits; 41 zeros and a 1
    before the data, a 1 and 40 zeros after (decode_pe.c:33-102)."""
    frames = frames_of(data)
    per = []
    n = 41 + 1 + len(frames) + 1 + 40
    centre = t0 + np.arange(n) * bs
    for trk in range(ntrks):
        bits = np.concatenate([np.zeros(41, bool), [True],
                               ((frames >> (ntrks - 1 - trk)) & 1) == 1,
                               [True], np.zeros(40, bool)])
        same = np.concatenate([[False], bits[1:] == bits[:-1]])
        times = np.concatenate([centre[same] - bs / 2, centre])
        dirs = np.concatenate([~bits[same], bits])
        per.append((times, dirs))
    return per, t0 + n * bs


def _pe_tapemark(t0, bs, ntrks):
    """64 zero bits on tracks 0, 2, 5, 6, 7 and P, DC erase on the rest
    (decode_pe.c:38-53)."""
    centre = t0 + np.arange(64) * bs
    times = np.concatenate([centre[1:] - bs / 2, centre])
    dirs = np.concatenate([np.ones(63, bool), np.zeros(64, bool)])
    empty = (np.zeros(0), np.zeros(0, bool))
    return [(times, dirs) if trk in (0, 2, 5, 6, 7, 8) else empty
            for trk in range(ntrks)], t0 + 64 * bs


def render(events, nsamples, *, deltat, bs, ntrks, amplitude, noise_rms,
           pulse_width_bits, amp_jitter, time_jitter_bits, gen, device):
    """Per track (times [n], directions [n] or None: alternate), a
    Gaussian bell of sigma pulse_width_bits per transition, its sign the
    direction, plus white noise: float32 volts [ntrks, N] on `device`,
    drawn from the torch.Generator `gen`, `nsamples` long. Each tap is one index_add_ over
    a track's transitions, which are more than a sample apart, so no two
    adds of one launch meet and the sums repeat exactly."""
    out = torch.zeros((ntrks, nsamples), dtype=torch.float64, device=device)
    sigma = pulse_width_bits * bs / deltat
    half = int(np.ceil(4 * sigma))
    taps = torch.arange(-half, half + 1, device=device)
    f64 = dict(dtype=torch.float64, device=device)
    for trk in range(ntrks):
        times, dirs = events[trk]
        if len(times) == 0:
            continue
        t = torch.as_tensor(times, **f64)
        if time_jitter_bits:
            t = t + torch.randn(len(t), generator=gen, **f64) * (
                time_jitter_bits * bs)
        order = torch.argsort(t, stable=True)
        t = t[order]
        if dirs is None:
            signs = torch.where(torch.arange(len(t), device=device) % 2 == 0,
                                -1.0, 1.0).to(torch.float64)
        else:
            signs = torch.where(torch.as_tensor(dirs, device=device)[order],
                                1.0, -1.0).to(torch.float64)
        amps = torch.full((len(t),), amplitude, **f64)
        if amp_jitter:
            amps = amps * (1.0 + torch.randn(len(t), generator=gen, **f64)
                           * amp_jitter)
        centres = t / deltat
        base = torch.round(centres)
        frac = centres - base
        scale = signs * amps
        for k in taps.tolist():
            idx = base.long() + k
            ok = (idx >= 0) & (idx < nsamples)
            vals = scale * torch.exp(-0.5 * ((k - frac) / sigma) ** 2)
            out[trk].index_add_(0, idx[ok], vals[ok])
    out = out.to(torch.float32)
    if noise_rms:
        out += torch.randn(out.shape, generator=gen, dtype=torch.float32,
                           device=device) * np.float32(noise_rms)
    return out


def volts_to_samples(volts, maxvolts: float) -> np.ndarray:
    """float32 volts [T, N] on the device -> host int16 [N, T], rounded
    to nearest (csvtbin.c's write)."""
    return torch.clamp(torch.round(volts / maxvolts * 32767.0), -32767,
                       32767).to(torch.int16).T.contiguous().cpu().numpy()


def generator(seed: int, index: int, device) -> torch.Generator:
    """The waveform's generator for capture `index` of seed `seed` (any
    whole number: mixed down to 64 bits by NumPy's SeedSequence)."""
    state = np.random.SeedSequence([int(seed), index, 1]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def payloads(config: dict, rng) -> list:
    """The capture's items: ("block", bytes) at the configuration's block
    sizes, then its tapemarks."""
    sizes = []
    for n, count in config["block_sizes"]:
        sizes += [int(n)] * int(count)
    items = [("block", rng.integers(0, 256, n, dtype=np.uint8).tobytes())
             for n in sizes]
    return items + [("tapemark",)] * int(config.get("tapemarks_at_end", 0))


def item_duration(config: dict, item) -> float:
    """Seconds of tape an item's frames take."""
    bs = 1.0 / (float(config["bpi"]) * float(config["ips"]))
    if config["encoding"] == "NRZI":
        return bs * (len(item[1]) + 8 if item[0] == "block"
                     else len(NRZI_TAPEMARK))
    return bs * (len(item[1]) + 83 if item[0] == "block" else 64)


def item_gap(config: dict, synth: dict, items) -> float:
    """The gap after each item (the last one's is the trailer) that makes
    the capture `samples` long: the documented capture's idle tape, shared
    alike between its items."""
    deltat = 1.0 / float(config["sample_rate_hz"])
    spare = ((int(config["samples"]) - 1) * deltat
             - float(synth["start_gap_secs"])
             - sum(item_duration(config, it) for it in items))
    gap = spare / len(items)
    if gap < MIN_GAP_SECS:
        raise ValueError(f"{len(items)} items leave {gap * 1e3:.3f} ms "
                         f"gaps in {config['samples']} samples")
    return gap


def samples_for(config: dict, gap_secs: float) -> int:
    """The `samples` that give a configuration's items gaps of gap_secs
    (for cutting a configuration down to a test's size)."""
    deltat = 1.0 / float(config["sample_rate_hz"])
    items = payloads(config, np.random.default_rng(0))
    return int((float(config["synth"]["start_gap_secs"])
                + sum(item_duration(config, it) for it in items)
                + len(items) * gap_secs) / deltat) + 1


def synthesize(config: dict, traffic: dict, seed: int, index: int,
               device="cpu"):
    """Capture `index` of a pool made from `seed`: (host int16 samples
    [N, T], items, spans [(t0, t1)] in seconds). The payloads come from
    NumPy, the waveform from a torch.Generator on `device`: one seed
    gives one capture on one kind of device."""
    mode = ENCODINGS[config["encoding"]]
    ntrks = int(config["tracks"])
    if ntrks != 9:
        raise ValueError("9-track captures only")
    synth = dict(config["synth"], **traffic.get("synth", {}))
    deltat = 1.0 / float(config["sample_rate_hz"])
    bs = 1.0 / (float(config["bpi"]) * float(config["ips"]))
    nsamples = int(config["samples"])
    items = payloads(config, np.random.default_rng([int(seed), index, 0]))
    ibg = item_gap(config, synth, items)
    skew = [float(x) * bs for x in synth.get("skew_bits", [0.0] * ntrks)]
    t = float(synth["start_gap_secs"])
    events = [([], []) for _ in range(ntrks)]
    spans = []
    for item in items:
        t0 = t
        if mode == MODE_NRZI:
            frames = (nrzi_block_frames(item[1]) if item[0] == "block"
                      else NRZI_TAPEMARK)
            per, t = _nrzi_transitions(frames, t, bs, ntrks)
        elif item[0] == "block":
            per, t = _pe_transitions(item[1], t, bs, ntrks)
        else:
            per, t = _pe_tapemark(t, bs, ntrks)
        for trk in range(ntrks):
            events[trk][0].append(per[trk][0] + skew[trk])
            if per[trk][1] is not None:
                events[trk][1].append(per[trk][1])
        spans.append((t0, t))
        t += ibg
    ev = [(np.concatenate(ts) if ts else np.zeros(0),
           np.concatenate(ds) if ds else None) for ts, ds in events]
    volts = render(ev, nsamples, deltat=deltat, bs=bs, ntrks=ntrks,
                   amplitude=float(synth["amplitude"]),
                   noise_rms=float(synth["noise_rms"]),
                   pulse_width_bits=float(synth["pulse_width_bits"]),
                   amp_jitter=float(synth.get("amp_jitter", 0.0)),
                   time_jitter_bits=float(synth.get("time_jitter_bits", 0.0)),
                   gen=generator(seed, index, device), device=device)
    return volts_to_samples(volts, float(config["maxvolts"])), items, spans
