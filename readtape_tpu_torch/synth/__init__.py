"""Waveform synthesizer (the port's own copy of readtape_tpu/synth)."""

from .synthesize import (SynthSpec, default_spec, synthesize_tape,
                         nrzi_crc9, nrzi_lrc)

__all__ = ["SynthSpec", "default_spec", "synthesize_tape",
           "nrzi_crc9", "nrzi_lrc"]
