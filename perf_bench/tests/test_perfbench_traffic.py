"""The one traffic generator: every seed gets the same work in another
order, and Zipf users come in proportion to 1 / rank."""
from __future__ import annotations

import numpy as np
import pytest

from perf_bench.harness import bench
from perf_bench.harness.traffic import ClosedLoop, zipf_counts

CLOSED = sorted(p.stem for p in (bench.BENCH / "traffic").glob("*.json")
                if bench.load_json("traffic", p.stem)["kind"] == "closed")


def _specs(tr: dict, seed: int) -> list:
    loop = ClosedLoop(tr, seed, vocab=100)
    return [(s.user, s.prompt_len, s.out_len) for q in loop.queues for s in q]


@pytest.mark.parametrize("name", CLOSED)
def test_every_seed_gets_the_same_work_in_another_order(name):
    tr = bench.load_json("traffic", name)
    a, b = _specs(tr, 3_141_592_653_589), _specs(tr, 2_718_281_828_459)
    assert len(a) == len(b) == tr["requests"] and a != b
    for field in range(3):     # users, prompt and output lengths: each the same multiset
        assert sorted(x[field] for x in a) == sorted(x[field] for x in b)
    users = {u for u, _, _ in a}
    assert users == set(range(tr["clients"] if tr["user_dist"] == "per_client"
                              else tr["users"]))


def test_zipf_counts_follow_one_over_rank():
    cnt = np.bincount(zipf_counts(12, 1.0, 64), minlength=12)
    p = 1.0 / np.arange(1, 13)
    assert cnt.sum() == 64 and np.all(np.diff(cnt) <= 0)
    assert np.all(np.abs(cnt - 64 * p / p.sum()) < 1)

