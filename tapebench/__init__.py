"""The benchmark of readtape_tpu_torch: see run.py and PERF.md."""
