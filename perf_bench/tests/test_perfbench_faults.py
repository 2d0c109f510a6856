"""The comparison that decides ``correct`` rejects the control and every
fault the cells can have, at a size a test run holds: each test drives a
whole run of the cell's driver on the CPU (the harness's look for a card
skipped) with the program broken underneath, or with the float8 reference
in its place, and sees ``correct`` come out false under the cell's limits."""
from __future__ import annotations

import pytest
import torch

from perf_bench.harness import bench
from perf_bench.tests import small

TRAIN = ["danube-train-efbv", "mamba2-train-dense"]
SERVE = ["danube-serve1-churn", "mamba2-serve1-resident"]
# mamba2-train-dense is left out: at full size its control reads within 3x
# of the program on every number, so no limit separates them
CONTROL = ["danube-train-efbv"] + SERVE


def _correct(run: bench.Run) -> bool:
    return bench.result_line(run, {}, {}, None)["correct"]


@pytest.mark.parametrize("cell", CONTROL)
def test_the_float8_control_fails_a_limit(cell):
    """The float8 reference in the program's place, judged by the result
    line under the cell's own limits, is not correct."""
    run = small.run(small.context(cell, dtype="bfloat16", control=True))
    assert run.numbers.get("checked_requests", 1) > 0, run.numbers
    assert {c.name for c in run.control} == set(run.cell["limits"])
    line = bench.result_line(run, {}, {}, None, control=True)
    assert not line["correct"], line["checks"]


def _wrap_step(monkeypatch, wrap):
    from repro_torch.training import steps
    real = steps.make_train_step

    def make(*a, **kw):
        return wrap(real(*a, **kw))

    monkeypatch.setattr(steps, "make_train_step", make)


def _unchanged(step):
    from repro_torch.utils.tree import tree_leaves

    def f(state, batch, survivors=None, noise=None):
        held = [t.clone() for t in tree_leaves((state.params, state.opt_state.mu,
                                                 state.opt_state.nu))]
        _, met = step(state, batch, noise=noise)
        for t, h in zip(tree_leaves((state.params, state.opt_state.mu, state.opt_state.nu)),
                        held):
            t.copy_(h)
        return state, met
    return f


def _half_batch(step):
    def f(state, batch, survivors=None, noise=None):
        half = batch["tokens"].shape[0] // 2
        kept = {k: torch.cat([v[:half]] * 2) for k, v in batch.items()}
        return step(state, kept, noise=noise)
    return f


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_train_fault_is_not_correct(cell, fault, monkeypatch):
    _wrap_step(monkeypatch, {"unchanged": _unchanged, "half_batch": _half_batch}[fault])
    run = small.run(small.context(cell, dtype="bfloat16"))
    assert not _correct(run), [(c.name, c.value, c.limit) for c in run.checks]


def test_efbv_without_the_exchange_is_not_correct(monkeypatch):
    """Each group keeps its own compressed delta: the mean over the groups,
    which stands for the exchange between workers, left out."""
    from repro_torch.core import distributed
    monkeypatch.setattr(distributed, "group_mean", lambda x, dim=0: x.select(dim, 0))
    run = small.run(small.context("danube-train-efbv", dtype="bfloat16"))
    assert not _correct(run), [(c.name, c.value, c.limit) for c in run.checks]


@pytest.mark.parametrize("cell", SERVE)
def test_an_altered_token_is_not_correct(cell, monkeypatch):
    from repro_torch.training.serving import ContinuousBatcher
    real = ContinuousBatcher._greedy

    def greedy(self, logits):
        # slot 0's answer altered where the batcher produces it
        out = real(self, logits).copy()
        out[0] = (out[0] + 1) % self.cfg.vocab_size
        return out

    monkeypatch.setattr(ContinuousBatcher, "_greedy", greedy)
    run = small.run(small.context(cell, dtype="bfloat16"))
    assert not _correct(run), [(c.name, c.value, c.limit) for c in run.checks]


@pytest.mark.parametrize("cell", SERVE)
def test_serving_the_base_without_the_delta_is_not_correct(cell, monkeypatch):
    from repro_torch.serve.engine import PersonalizedBatcher
    monkeypatch.setattr(PersonalizedBatcher, "_on_admit",
                        lambda self, slot, req: self._tables[slot].zero_())
    monkeypatch.setattr(PersonalizedBatcher, "_on_retire", lambda self, slot, req: None)
    run = small.run(small.context(cell, dtype="bfloat16"))
    assert not _correct(run), [(c.name, c.value, c.limit) for c in run.checks]
