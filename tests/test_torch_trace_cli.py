"""-trace through both command lines: the .trace.csv the port's CLI
writes (readtape_tpu_torch, plain versions on the CPU) equals the JAX
CLI's byte for byte, and both log its line count, on
tests/test_torch_trace.py's one-block tapes. -trace covers the first
10,000 samples, -trace=a,b the seconds a to b, -trace=a the seconds a to
a + 0.01. The trace is written after the decode and before the other
outputs, whose own tests are tests/test_torch_cli.py's. Tolerance:
none."""

import numpy as np
import pytest
import torch

from readtape_tpu import cli as jcli
from readtape_tpu.formats import tbin as tb
from readtape_tpu_torch import cli as tcli

from test_torch_trace import CASES

torch.set_num_threads(2)

# case: (its tape in test_torch_trace.CASES, mode options, -trace option)
RUNS = {
    "nrzi9": ("nrzi9", ["-nrzi"], "-trace"),
    "nrzi7": ("nrzi7", ["-nrzi", "-ntrks=7"], "-trace=0.002,0.0125"),
    "pe": ("pe", ["-pe"], "-trace=0.0035"),
    "gcr": ("gcr", ["-gcr"], "-trace=0.004,0.0095"),
    "ww": ("ww", ["-whirlwind"], "-trace"),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_trace_file_equals_jax_cli(run, tmp_path, monkeypatch, capsys):
    case, flags, opt = RUNS[run]
    hdr, samples = CASES[case][1]()
    files = {}
    for d, cli, kw in (("j", jcli, {}), ("t", tcli, dict(device="cpu"))):
        (tmp_path / d).mkdir()
        monkeypatch.chdir(tmp_path / d)
        tb.write_tbin("t.tbin", hdr, samples)
        cli.main(flags + [opt, "t"], **kw)
        files[d] = ((tmp_path / d / "t.trace.csv").read_bytes(),
                    (tmp_path / d / "t.log").read_text())
    (got, tlog), (want, jlog) = files["t"], files["j"]
    assert got == want
    nl = got.count(b"\n") - 1
    assert nl > 1000
    line = f'created trace file "t.trace.csv" ({nl} lines)'
    assert line in tlog and line in jlog
    if opt == "-trace":
        assert nl == min(len(samples), 10000)
    # the trace saw events: some lane column is not all zero
    rows = np.loadtxt(got.decode().splitlines()[1:], delimiter=",")
    assert np.abs(rows[:, 1 + hdr.ntrks:]).sum() > 0
