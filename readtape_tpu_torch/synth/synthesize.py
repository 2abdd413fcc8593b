"""Waveform synthesizer: encode known data into NRZI / PE / GCR / Whirlwind
flux transitions and render a band-limited analog multi-track waveform.

The bundled example .tbin inputs are stripped from the reference mirror
(.MISSING_LARGE_BLOBS), so synthetic tapes are the test fixtures. Synthesized
tapes are validated differentially: the reference C binary must decode them
bit-exactly, and then our TPU decoder must match.

Physics model: a read head produces a voltage pulse at each flux transition,
alternating polarity (every transition is a flux *reversal*). We render each
transition as a Gaussian bell of width ~1/3 bit cell. This matches the
detection model of the reference engine (relative minima/maxima at
transitions; decoder.c:10-16).

Encoding references:
  NRZI frames/CRC/LRC layout     decode_nrzi.c:35-113 (9trk CRC per IBM A22-6862)
  NRZI tapemark patterns         decode_nrzi.c:97-101
  PE preamble/postamble/tapemark decode_pe.c:33-102, 127-155
  GCR groups/ECC/marks           decode_gcr.c:420-674, X3.54
  WW pulse pairs/blockmarks      decode_ww.c:51-232

The port's own copy of readtape_tpu/synth/synthesize.py: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..formats import tbin as tb


@dataclass
class SynthSpec:
    mode: int = tb.MODE_NRZI
    ntrks: int = 9
    bpi: float = 800.0
    ips: float = 50.0
    sample_rate_hz: float = 781250.0
    maxvolts: float = 6.0
    amplitude: float = 2.0            # peak voltage of a lone transition
    noise_rms: float = 0.01
    pulse_width_bits: float = 0.30    # gaussian sigma as a fraction of a bit
    ibg_secs: float = 0.008           # interblock gap
    start_gap_secs: float = 0.004
    skew_samples: tuple = ()          # per-track extra delay in samples
    even_parity: bool = False         # 7-track BCD tapes use even parity
    seed: int = 12345
    amp_jitter: float = 0.0           # relative random amplitude variation
    time_jitter_bits: float = 0.0     # random transition-time jitter
    ww_order: str = "CMLcml"          # whirlwind track-type layout
    ww_flux_neg: bool = True          # negative pulse first (the common case)

    @property
    def bit_spacing(self) -> float:
        return 1.0 / (self.bpi * self.ips)

    @property
    def deltat(self) -> float:
        return 1.0 / self.sample_rate_hz


def default_spec(mode: int, **overrides) -> SynthSpec:
    """A SynthSpec with realistic per-mode densities/rates matching the
    bundled examples (validated against the reference C binary: all decode
    with zero errors). GCR must not be grossly oversampled (the reference's
    peak engine expects ~10-30 samples/bit; readtape.c:1473-1474 warns at
    100); Whirlwind pulses are narrow relative to its huge 333 us bit cell."""
    base = {
        tb.MODE_NRZI: dict(mode=mode, ntrks=9, bpi=800, ips=50,
                           sample_rate_hz=781250.0),
        # PE transitions come every half bit, so pulses must be narrow
        # relative to the half-bit cell for realistic peak separation
        tb.MODE_PE: dict(mode=mode, ntrks=9, bpi=1600, ips=50,
                         sample_rate_hz=1562500.0, pulse_width_bits=0.15),
        tb.MODE_GCR: dict(mode=mode, ntrks=9, bpi=9042, ips=25,
                          sample_rate_hz=2500000.0),
        tb.MODE_WW: dict(mode=mode, ntrks=6, bpi=100, ips=30,
                         sample_rate_hz=200000.0, pulse_width_bits=0.06),
    }[mode]
    base.update(overrides)
    return SynthSpec(**base)


def parity_bit(value: int, even: bool = False) -> int:
    """Parity bit making the frame odd (or even) parity overall."""
    p = bin(value).count("1") & 1
    want = 0 if even else 1
    return want ^ p


def frame_of(byte_val: int, ntrks: int, even: bool = False) -> int:
    """Pack a data byte + computed parity into the reference's frame layout:
    bit (ntrks-1)..1 = data msb..lsb, bit 0 = parity (decoder.c:101)."""
    nbits = ntrks - 1
    assert 0 <= byte_val < (1 << nbits)
    return (byte_val << 1) | parity_bit(byte_val, even)


def nrzi_crc9(frames) -> int:
    """9-track NRZI CRC over 9-bit frames, per IBM Form A22-6862-4
    (decode_nrzi.c:56-67)."""
    crc = 0
    for f in frames:
        crc ^= int(f)
        if crc & 2:
            crc ^= 0xF0
        lsb = crc & 1
        crc >>= 1
        if lsb:
            crc |= 0x100
    return crc ^ 0x1AF


def nrzi_lrc(frames, crc: int = 0) -> int:
    lrc = crc
    for f in frames:
        lrc ^= int(f)
    return lrc & 0x1FF


# ----------------------------------------------------------------------------
# transition-list builders: produce, per track, a sorted list of transition
# times in seconds. Polarity alternates per track automatically (rendering).
# For PE the *absolute* direction matters, so PE builds (time, direction).
# ----------------------------------------------------------------------------

def _nrzi_block_transitions(spec: SynthSpec, frames, t0: float):
    """NRZI: a 1-bit is a flux transition at the bit time; 0 is no transition.
    Returns (per-track transition time lists, end_time)."""
    bs = spec.bit_spacing
    per_trk = [[] for _ in range(spec.ntrks)]
    for k, f in enumerate(frames):
        t = t0 + k * bs
        for trk in range(spec.ntrks):
            if (f >> (spec.ntrks - 1 - trk)) & 1:
                per_trk[trk].append(t)
    return per_trk, t0 + len(frames) * bs


def nrzi_block_frames(data: bytes, spec: SynthSpec):
    """Data frames followed by CRC/LRC area frames (decode_nrzi.c:41-45):
    9-track: data, 00, 00, 00, CRC, 00, 00, 00, LRC
    7-track: data, 00, 00, 00, LRC, 00, 00, 00, 00  (LRC 4 frames after data)
    """
    frames = [frame_of(b, spec.ntrks, spec.even_parity) for b in data]
    post = [0] * 8
    if spec.ntrks == 9:
        crc = nrzi_crc9(frames)
        lrc = nrzi_lrc(frames, crc)
        post[3] = crc      # minbits-5 position
        post[7] = lrc      # minbits-1 position
    else:
        lrc = nrzi_lrc(frames)
        post[3] = lrc      # 4 frames after the last data frame
    return frames + post


def nrzi_tapemark_frames(spec: SynthSpec):
    """decode_nrzi.c:97-101: 9trk 0x26 ... 0x26 (8 frames apart);
    7trk 0x1e ... 0x1e (3 or 4 frames apart; we write 4)."""
    if spec.ntrks == 9:
        return [0x26, 0, 0, 0, 0, 0, 0, 0, 0x26]
    return [0x1E, 0, 0, 0, 0x1E, 0, 0, 0, 0]


def _pe_block_transitions(spec: SynthSpec, data: bytes, t0: float):
    """PE (phase encoding): 1 = up transition at bit center, 0 = down; a phase
    (clock) transition at the bit boundary whenever consecutive bits are equal.
    Preamble: ~40 zero bits then one 1; postamble: one 1 then ~40 zeros
    (decode_pe.c:33-102). Returns per-track (time, direction) lists."""
    bs = spec.bit_spacing
    per_trk = [[] for _ in range(spec.ntrks)]
    frames = [frame_of(b, spec.ntrks, spec.even_parity) for b in data]
    n_pre, n_post = 41, 40
    for trk in range(spec.ntrks):
        mask = 1 << (spec.ntrks - 1 - trk)
        bits = [0] * n_pre + [1] + [(f & mask) != 0 for f in frames] + [1] + [0] * n_post
        trans = per_trk[trk]
        prev = None
        for k, bit in enumerate(bits):
            center = t0 + k * bs
            if prev is not None and prev == bit:
                # clock transition at boundary, opposite direction of the bit
                trans.append((center - bs / 2, not bit))
            trans.append((center, bool(bit)))
            prev = bit
    end = t0 + (n_pre + 1 + len(frames) + 1 + n_post) * bs
    return per_trk, end


def _pe_tapemark_transitions(spec: SynthSpec, t0: float):
    """PE tapemark: >=80 flux reversals but no data on tracks 0,2,5,6,7,P and
    DC erase on 1,3,4 (decode_pe.c:38-53): a burst of zero bits."""
    bs = spec.bit_spacing
    per_trk = [[] for _ in range(spec.ntrks)]
    active = [0, 2, 5, 6, 7, 8]
    nbits = 64
    for trk in active:
        trans = per_trk[trk]
        for k in range(nbits):
            center = t0 + k * bs
            if k > 0:
                trans.append((center - bs / 2, True))   # clock (0 then 0)
            trans.append((center, False))               # zero bit: down
    return per_trk, t0 + nbits * bs


# ---------------- GCR ----------------

# inverse of decode_gcr.c:430-436 gcr_datamap: 4-bit data -> 5-bit storage code
GCR_DATA_TO_SGROUP = [0b11001, 0b11011, 0b10010, 0b10011,
                      0b11101, 0b10101, 0b10110, 0b10111,
                      0b11010, 0b01001, 0b01010, 0b01011,
                      0b11110, 0b01101, 0b01110, 0b01111]
GCR_MARK1, GCR_MARK2, GCR_SYNC = 0b00111, 0b11100, 0b11111
GCR_TERML1, GCR_TERML0 = 0b10101, 0b10100
GCR_SECOND1, GCR_SECOND2 = 0b01111, 0b11110

_GCR_ECC_A = [0x0F6A71994C5230, 0x70110840108004, 0x5A701108401080,
              0x372BE95D5A7011, 0xE95D5A70110840, 0x4C523001884412,
              0x2BE95D5A701108, 0x5D5A7011084010]


def gcr_compute_ecc(data7) -> int:
    """ECC over 7 data bytes (sans parity) as a 56-bit big-endian integer;
    bit i of the ECC is the GF(2) dot product with row i (decode_gcr.c:127-144)."""
    dblock = 0
    for b in data7:
        dblock = (dblock << 8) | (b & 0xFF)
    ecc = 0
    for i, row in enumerate(_GCR_ECC_A):
        ecc |= (bin(dblock & row).count("1") & 1) << i
    return ecc


def gcr_storage_bits(data: bytes, spec: SynthSpec):
    """Build the per-track storage (NRZI) bit strings for a GCR block.

    Layout per X3.54 as parsed by gcr_postprocess (decode_gcr.c:503-674):
      preamble: 16x SYNC, MARK1,
      repeat per 7 data bytes: dgroup A (4 bytes) + dgroup B (3 bytes + ECC),
      SYNC, residual A+B (padding + residual count), CRC A+B (zeros: the
      reference doesn't check CRC), MARK2, 14x SYNC, SECOND, TERML
    Each "dgroup" is 5 storage bits per track encoding 4 data bits per track.
    """
    frames_bits = [[] for _ in range(9)]   # per track storage bits

    def emit_sgroups(sgroups):             # one 5-bit code per track
        for trk in range(9):
            code = sgroups[trk]
            for b in range(4, -1, -1):
                frames_bits[trk].append((code >> b) & 1)

    def emit_uniform(code, times=1):
        for _ in range(times):
            emit_sgroups([code] * 9)

    def bytes_to_sgroup_pairs(bs8):
        """8 frames (9-bit incl parity) -> (groupA, groupB) 5-bit codes/track."""
        frames = [frame_of(b, 9, False) for b in bs8[:7]]
        ecc = gcr_compute_ecc(bs8[:7])
        frames.append(frame_of(ecc, 9, False))
        out = []
        for half in range(2):
            sg = []
            for trk in range(9):
                nib = 0
                for j in range(4):
                    bit = (frames[half * 4 + j] >> (8 - trk)) & 1
                    nib = (nib << 1) | bit
                sg.append(GCR_DATA_TO_SGROUP[nib])
            out.append(sg)
        return out

    emit_uniform(GCR_SYNC, 16)
    emit_uniform(GCR_MARK1)
    n = len(data)
    full = n // 7
    residual = n - full * 7
    for g in range(full):
        a, b = bytes_to_sgroup_pairs(list(data[g * 7:(g + 1) * 7]))
        emit_sgroups(a)
        emit_sgroups(b)
    emit_uniform(GCR_SYNC)
    # residual groups: 6 leftover-data/pad bytes + residual-count char + ECC-ish
    resid_bytes = list(data[full * 7:]) + [0] * (6 - residual)
    a, b = bytes_to_sgroup_pairs(resid_bytes[:6] + [residual << 5])
    emit_sgroups(a)
    emit_sgroups(b)
    # CRC groups (contents unchecked by the reference; the residual count is
    # in byte 6 of the CRC group: "BCCC CCXE", X = residual char)
    a, b = bytes_to_sgroup_pairs([0, 0, 0, 0, 0, 0, residual << 5])
    emit_sgroups(a)
    emit_sgroups(b)
    emit_uniform(GCR_MARK2)
    emit_uniform(GCR_SYNC, 14)
    emit_uniform(GCR_SECOND1)
    emit_uniform(GCR_TERML1)
    return frames_bits


def _gcr_block_transitions(spec: SynthSpec, data: bytes, t0: float):
    bs = spec.bit_spacing
    per_trk_bits = gcr_storage_bits(data, spec)
    per_trk = [[] for _ in range(spec.ntrks)]
    for trk in range(spec.ntrks):
        for k, bit in enumerate(per_trk_bits[trk]):
            if bit:
                per_trk[trk].append(t0 + k * bs)
    nbits = len(per_trk_bits[0])
    return per_trk, t0 + nbits * bs


def _gcr_tapemark_transitions(spec: SynthSpec, t0: float):
    """GCR tapemark: 250-400 all-ones flux changes on tracks {0,2,5,6,7,8},
    nothing on {1,3,4} (decode_gcr.c:708-721)."""
    bs = spec.bit_spacing
    per_trk = [[] for _ in range(spec.ntrks)]
    for trk in [0, 2, 5, 6, 7, 8]:
        for k in range(300):
            per_trk[trk].append(t0 + k * bs)
    return per_trk, t0 + 300 * bs


# ---------------- Whirlwind ----------------

def _ww_track_assign(spec: SynthSpec):
    types = {}
    for head, ch in enumerate(spec.ww_order):
        types[ch] = head
    return types


def _ww_block_transitions(spec: SynthSpec, words, t0: float):
    """Whirlwind: 16-bit words as 8 consecutive 2-bit chars (MSB first).
    Each char occupies one clock time: clock pulse on C and c tracks; a 1 in
    the MSB/LSB position = pulse on M/m / L/l tracks, offset so the pulse
    start falls within one bit time before the clock pulse end
    (decode_ww.c:51-92). A pulse = two flux transitions ~0.3 bit apart."""
    bs = spec.bit_spacing
    types = _ww_track_assign(spec)
    per_trk = [[] for _ in range(spec.ntrks)]
    pw = 0.3 * bs          # pulse width: start->end transition spacing

    def pulse(tracks, t):
        for ch in tracks:
            if ch in types:
                per_trk[types[ch]].append(t)
                per_trk[types[ch]].append(t + pw)

    k = 0
    for w in words:
        for nib in range(8):
            two = (w >> (14 - 2 * nib)) & 3
            t = t0 + k * bs
            pulse("Cc", t)
            # data pulses: start at the same bit time, slightly before clock
            if two & 2:
                pulse("Mm", t - 0.15 * bs)
            if two & 1:
                pulse("Ll", t - 0.15 * bs)
            k += 1
    return per_trk, t0 + k * bs


def _ww_blockmark_transitions(spec: SynthSpec, t0: float):
    """Blockmark: a pulse on the LSB track(s) with no clock (decode_ww.c:161)."""
    bs = spec.bit_spacing
    types = _ww_track_assign(spec)
    per_trk = [[] for _ in range(spec.ntrks)]
    pw = 0.3 * bs
    for ch in "Ll":
        if ch in types:
            per_trk[types[ch]].append(t0)
            per_trk[types[ch]].append(t0 + pw)
    return per_trk, t0 + bs


# ----------------------------------------------------------------------------
# rendering
# ----------------------------------------------------------------------------

def _render(spec: SynthSpec, track_events, total_time: float) -> np.ndarray:
    """track_events: per track, list of (time, direction_or_None). Direction
    None = alternate automatically; True = positive peak, False = negative."""
    rng = np.random.default_rng(spec.seed)
    dt = spec.deltat
    nsamples = int(np.ceil(total_time / dt)) + 1
    out = np.zeros((nsamples, spec.ntrks), dtype=np.float32)
    sigma = spec.pulse_width_bits * spec.bit_spacing
    halfwidth = int(np.ceil(4 * sigma / dt))
    kern_offsets = np.arange(-halfwidth, halfwidth + 1)
    for trk in range(spec.ntrks):
        events = track_events[trk]
        if not events:
            continue
        times = np.array([e[0] for e in events], dtype=np.float64)
        dirs = [e[1] for e in events]
        if spec.time_jitter_bits:
            times = times + rng.normal(
                0, spec.time_jitter_bits * spec.bit_spacing, len(times))
        order = np.argsort(times, kind="stable")
        times = times[order]
        dirs = [dirs[i] for i in order]
        signs = np.empty(len(times), dtype=np.float32)
        cur = 1.0
        for i, d in enumerate(dirs):
            if d is None:
                cur = -cur
            else:
                cur = 1.0 if d else -1.0
            signs[i] = cur
        amps = np.full(len(times), spec.amplitude, dtype=np.float64)
        if spec.amp_jitter:
            amps *= 1.0 + rng.normal(0, spec.amp_jitter, len(times))
        if spec.skew_samples and trk < len(spec.skew_samples):
            times = times + spec.skew_samples[trk] * dt
        centers = times / dt
        base = np.round(centers).astype(np.int64)
        frac = centers - base
        # scatter-add a gaussian bell per transition
        idx = base[:, None] + kern_offsets[None, :]
        prof = np.exp(-0.5 * ((kern_offsets[None, :] - frac[:, None]) / (sigma / dt)) ** 2)
        vals = (signs[:, None] * amps[:, None] * prof).astype(np.float32)
        ok = (idx >= 0) & (idx < nsamples)
        np.add.at(out[:, trk], idx[ok], vals[ok])
    if spec.noise_rms:
        out += rng.normal(0, spec.noise_rms, out.shape).astype(np.float32)
    return out


def synthesize_tape(spec: SynthSpec, items):
    """items: sequence of ("block", payload) and ("tapemark",) tuples.
    For WW, payload is a list of 16-bit words; otherwise bytes.
    Returns (TbinHeader, int16 samples [N, ntrks])."""
    t = spec.start_gap_secs
    all_events = [[] for _ in range(spec.ntrks)]

    def add(per_trk, directed=False):
        for trk in range(spec.ntrks):
            for e in per_trk[trk]:
                all_events[trk].append(e if directed else (e, None))

    for item in items:
        kind = item[0]
        if kind == "block":
            payload = item[1]
            if spec.mode == tb.MODE_NRZI:
                frames = nrzi_block_frames(payload, spec)
                per_trk, t = _nrzi_block_transitions(spec, frames, t)
                add(per_trk)
            elif spec.mode == tb.MODE_PE:
                per_trk, t = _pe_block_transitions(spec, payload, t)
                add(per_trk, directed=True)
            elif spec.mode == tb.MODE_GCR:
                per_trk, t = _gcr_block_transitions(spec, payload, t)
                add(per_trk)
            elif spec.mode == tb.MODE_WW:
                per_trk, t = _ww_block_transitions(spec, payload, t)
                add(per_trk)
            else:
                raise ValueError("bad mode")
        elif kind == "tapemark":
            if spec.mode == tb.MODE_NRZI:
                per_trk, t = _nrzi_block_transitions(
                    spec, nrzi_tapemark_frames(spec), t)
                add(per_trk)
            elif spec.mode == tb.MODE_PE:
                per_trk, t = _pe_tapemark_transitions(spec, t)
                add(per_trk, directed=True)
            elif spec.mode == tb.MODE_GCR:
                per_trk, t = _gcr_tapemark_transitions(spec, t)
                add(per_trk)
            elif spec.mode == tb.MODE_WW:
                per_trk, t = _ww_blockmark_transitions(spec, t)
                add(per_trk)
        else:
            raise ValueError(f"bad item kind {kind}")
        t += spec.ibg_secs

    volts = _render(spec, all_events, t)
    if spec.mode == tb.MODE_PE:
        pass
    samples = tb.volts_to_samples(volts, spec.maxvolts)
    hdr = tb.TbinHeader(
        descr="synthesized by readtape_tpu",
        flags=tb.TBIN_NO_REORDER,
        ntrks=spec.ntrks,
        tdelta_ns=int(round(1e9 / spec.sample_rate_hz)),
        maxvolts=spec.maxvolts,
        mode=spec.mode,
        bpi=spec.bpi, ips=spec.ips)
    if spec.mode == tb.MODE_WW:
        hdr.trkorder = spec.ww_order
        hdr.flags |= tb.TBIN_TRKORDER_INCLUDED
    return hdr, samples
