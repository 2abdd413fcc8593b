"""The tiered NRZI path on test_fused_bail_rescue's noise-burst tape,
where the JAX package's XLA admission budget binds. The tiered path has no
budget (as the TPU kernels have none), so the port is held to the JAX
decode with the budget lifted (its nrzi_track_scan_pre given S + 1
steps). That the budget binds is shown on the port's own admission
batches: run again with the XLA budget, the plain B5 stops lanes early
(test_torch_scan holds that scan to the JAX one under a budget)."""

import torch

from readtape_tpu_torch.decode import fused as tfu
from readtape_tpu_torch.decode import scan as tsc

from test_torch_pipeline import opts_for
from test_torch_pipeline_more import burst_tape
from test_torch_tiered import tiered

torch.set_num_threads(2)


def test_noise_burst_beyond_the_budget(monkeypatch):
    hdr, samples = burst_tape()
    seen = []
    for name in ("nrzi_track_scan", "nrzi_track_scan_tracks"):
        def spy(feat, nxt, pa, _admit=getattr(tsc, name), **kw):
            seen.append((_admit, feat, nxt, pa, kw))
            return _admit(feat, nxt, pa, **kw)
        spy.launches = 0
        monkeypatch.setattr(tsc, name, spy)
    out, stats, capped, _ = tiered(samples, opts_for(hdr), monkeypatch,
                                   lift_budget=True)
    assert not capped
    assert out and stats["nblocks"] + stats["nunusable"] >= 1

    spb = 1.0 / (800 * 50 * hdr.tdelta_ns * 1e-9)
    bound = []
    for admit, feat, nxt, pa, kw in seen:
        S = feat.shape[3]
        budget = tfu.scan_step_budget(int(S / spb * 3.2) + 64)
        assert not admit(feat, nxt, pa, **kw)["incomplete"].any()
        bound.append(bool(admit(feat, nxt, pa, **dict(kw, max_steps=budget))[
            "incomplete"].any()))
    assert any(bound), bound
