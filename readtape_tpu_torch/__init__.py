"""readtape_tpu_torch: the PyTorch + CUDA port of readtape_tpu.

The JAX package (``readtape_tpu``) stays the reference; this package runs
the same decode on an NVIDIA GPU. Module names mirror the JAX package's
(``decode/common.py`` <- ``readtape_tpu/decode/common.py`` and so on) so
each counterpart is easy to find. The package imports torch, never jax,
and nothing of the JAX package: it keeps its own copies of the jax-free
modules it needs (``formats``, ``synth``, ``native``, ``version``).

Ported so far: the 9/7-track NRZI main path, the 9-track PE and GCR
paths and the 6-track Whirlwind path (``decode.pipeline``), whose device
kernels are ``decode.fused.nrzi_fused_scan``, ``pe_fused_scan``,
``gcr_fused_scan`` and ``ww_fused_scan`` (CUDA C++ under ``csrc/``, built
by ``kernels.py``).
"""

from .version import __version__

__all__ = ["__version__"]
