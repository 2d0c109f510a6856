"""The operation and byte counts against hand counts at one small shape,
and the readers that divide by them."""
from __future__ import annotations

import pytest

from perf_bench.harness import bench
from perf_bench.metrics import counts

DENSE = {"family": "dense", "num_layers": 1, "d_model": 4, "num_heads": 2, "num_kv_heads": 1,
         "head_dim": 2, "d_ff": 3, "vocab_size": 5, "sliding_window": 0}
SSM = {"family": "ssm", "num_layers": 1, "d_model": 4, "vocab_size": 5,
       "mamba": {"expand": 2, "head_dim": 4, "d_state": 3, "n_groups": 1}}


def test_dense_by_hand():
    # q 4x4, k and v 4x2 each, o 4x4, gate/in/out 3 x 4x3 = 16 + 16 + 16 + 36
    assert counts.body_weights(DENSE) == 84
    # 2 x 84 weights, QK + PV: 4 x 2 heads x 2 x 3 positions, logits 2 x 4 x 5
    assert counts.token_flops(DENSE, 3, True) == 168 + 48 + 40
    # forward + backward (3x) of positions 1 and 2
    assert counts.train_step_flops(DENSE, 2, 1) == 3 * ((168 + 16 + 40) + (168 + 32 + 40))
    windowed = dict(DENSE, sliding_window=2)
    assert counts.mixer_flops(windowed, 5) == 4 * 2 * 2 * 2


def test_ssm_by_hand():
    # d_inner 8, 2 heads of 4, state 3: in_proj 4 x (16 + 6 + 2), out_proj 8 x 4
    assert counts.body_weights(SSM) == 96 + 32
    # the recurrence: 2 multiply-adds per state element (2 x 4 x 3) per token
    assert counts.token_flops(SSM, 7, True) == 256 + 96 + 40
    assert counts.train_step_flops(SSM, 3, 2) == 3 * 2 * 3 * (256 + 96 + 40)


def test_bytes_by_hand():
    assert counts.b1_bytes(1000) == 12000
    assert counts.b3_bytes(1024) == 5 * 1024 + 4 * 2
    assert counts.b3_bytes(1025) == 5 * 1025 + 4 * 3


class _Trace:
    def __init__(self, kernels, busy, window):
        self.kernels, self.busy_s, self.window_s = kernels, busy, window

    def kernel_s(self, sub):
        hits = [v for k, v in self.kernels.items() if sub in k]
        return sum(c for c, _ in hits), sum(t for _, t in hits)


def _run(**kw):
    r = bench.Run(config=DENSE, cell={"sync": {"groups": 2}}, traffic={"seq_len": 2,
                                                                        "global_batch": 1})
    r.numbers = {"steps": 4, "d": 1000, "misses": 2, "hits": 6}
    r.window_s = 2.0
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_readers():
    rd = lambda name, run: bench.load_py("metrics", name).read(run)  # noqa: E731
    assert rd("b1_roofline.train", _run()) is None
    b1 = 12 * 2 * 1000 * 4 / counts.HBM_BYTES_PER_S
    tr = _Trace({"void quant_kernel<false>(...)": [8, 2 * b1]}, 1.5, 2.0)
    assert rd("b1_roofline.train", _run(trace=tr)) == pytest.approx(50.0)
    assert rd("idle_share.train", _run(trace=tr)) == pytest.approx(25.0)
    assert rd("b3_roofline.churn", _run(trace=tr)) is None
    assert rd("pool_miss_share.churn", _run()) == pytest.approx(25.0)
    spans = [("step/grad", 1.0, 10.0), ("step/grad", 1.0, 30.0), ("step/apply", 1.0, 4.0)]
    assert rd("grad_ms.train", _run(spans=spans)) == pytest.approx(10.0)
    assert rd("sync_ms.train", _run(spans=spans)) is None
    f = counts.train_step_flops(DENSE, 2, 1) * 4 / 2.0
    assert rd("mfu.train", _run()) == pytest.approx(100 * f / counts.PEAK_FLOPS_BF16)
    assert rd("page_in_ms.churn", _run(series={"page_in_ms": [100.0, 300.0]})) == 200.0
