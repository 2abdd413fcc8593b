"""The port end to end on the CPU: the four NRZI, two PE, three GCR (one
with -zeros -correct, one a CSV capture decoded with -differentiate
-zeros) and one Whirlwind example tapes (built by chip_smoke.py's recipe
table with the port's own synthesizer, written with its TBIN and CSV
writers) go through the port's command line with each example's own
arguments and write the .tap files whose SHA-256 examples/golden.json
records; importing the port imports no JAX; a decode on a host without a
card, by default or asked for "cuda", raises instead of running on the
CPU; options the port does not run raise NotImplementedError (density
detection only for GCR: the JAX command line detects it for NRZI and PE
tapes alone; -zeros only for PE: the JAX command line refuses it there),
and -parmscan, which is ported, changes no block and without a log logs
nothing, while on NRZI it logs the JAX package's "ignored" line."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from readtape_tpu.formats import tbin as tb
from readtape_tpu.synth import default_spec, synthesize_tape
from readtape_tpu_torch import kernels
from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import pipeline as tpl

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", chip_smoke.GOLDEN_CASES)
def test_golden_tap(name, tmp_path, capsys):
    digest = chip_smoke.run_example(name, "cpu", str(tmp_path))
    with open(os.path.join(REPO, "examples", "golden.json")) as f:
        golden = json.load(f)
    assert digest == golden[name]


def test_import_leaves_jax_out():
    code = ("import sys, readtape_tpu_torch.decode.pipeline, "
            "readtape_tpu_torch.kernels, readtape_tpu_torch.cli, "
            "readtape_tpu_torch.__main__, readtape_tpu_torch.out.charsets, "
            "readtape_tpu_torch.out.labels, readtape_tpu_torch.out.textfile, "
            "readtape_tpu_torch.out.peakstats; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def _tape():
    rng = np.random.default_rng(2)
    spec = default_spec(tb.MODE_NRZI, ibg_secs=0.004, start_gap_secs=0.004)
    hdr, samples = synthesize_tape(
        spec, [("block", bytes(rng.integers(0, 256, 64, dtype=np.uint8)))])
    return hdr, samples


def test_cuda_decode_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    hdr, samples = _tape()
    opts = tpl.DecodeOptions(mode=tb.MODE_NRZI, ntrks=9, bpi=800, ips=50,
                             deltat=hdr.tdelta_ns * 1e-9,
                             maxvolts=hdr.maxvolts)
    calls = tfu.nrzi_fused_scan_plain.calls
    with pytest.raises(RuntimeError, match="cuda"):
        tpl.decode_tape(samples, opts, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tpl.decode_tape(samples, opts)          # the card is the default
    assert tfu.nrzi_fused_scan_plain.calls == calls


def test_kernel_build_raises_without_nvcc():
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()


@pytest.mark.parametrize("over,name", [
    (dict(mode=tb.MODE_GCR, bpi=9042, ips=25, parmscan=True), "-parmscan"),
    (dict(mode=tb.MODE_PE, bpi=1600, find_zeros=True), "-zeros"),
    (dict(adjskew=True), "-adjskew"),
    (dict(do_correct_debug=True), "-correctdbg"),
    (dict(parmscan=True), "-parmscan"),
    (dict(mode=tb.MODE_GCR, bpi=0.0, ips=25), "density detection")])
def test_unported_options_raise(over, name):
    """The options the port does not run raise NotImplementedError. The
    two -parmscan cases, which the port runs: on GCR without a log the
    blocks equal those decoded without -parmscan (the grid only logs); on
    NRZI the JAX package's "ignored" line is logged."""
    if over.get("mode") == tb.MODE_GCR and over.get("parmscan"):
        hdr, samples = _gcr_tape()
    else:
        hdr, samples = _tape()
    kw = dict(mode=tb.MODE_NRZI, ntrks=9, bpi=800, ips=50,
              deltat=hdr.tdelta_ns * 1e-9, maxvolts=hdr.maxvolts)
    kw.update(over)
    opts = tpl.DecodeOptions(**kw)
    if name != "-parmscan":
        with pytest.raises(NotImplementedError, match=name):
            tpl.decode_tape(samples, opts, device="cpu")
        return
    plain = tpl.DecodeOptions(**dict(kw, parmscan=False))
    want, _ = tpl.decode_tape(samples, plain, device="cpu")
    lines = []
    if opts.mode == tb.MODE_GCR:
        got, _ = tpl.decode_tape(samples, opts, device="cpu")
        assert len(want) == 2 and want[0].kind == "data"
    else:
        got, _ = tpl.decode_tape(samples, opts, lines.append, device="cpu")
        assert lines == ["-parmscan is only implemented for GCR (as in the "
                         "reference's GCR_PARMSCAN build); ignored\n"]
    assert got == want


def _gcr_tape():
    """A one-block GCR tape with short gaps."""
    rng = np.random.default_rng(4)
    spec = default_spec(tb.MODE_GCR, ibg_secs=0.002, start_gap_secs=0.002)
    return synthesize_tape(
        spec, [("block", bytes(rng.integers(0, 256, 48, dtype=np.uint8))),
               ("tapemark",)])
