"""Port serving plane (delta store, block pool, engine, batcher) against the
JAX package on ``h2o-danube-1.8b.reduced()``.

Tolerance: none for bytes — payload planes, ``nbytes`` and ledger totals are
identical (JAX's noise injected for ``qsgd_kernel``), and the port's delta
path is bitwise equal to its materialized path.  Generated tokens from the
personalized batcher must equal the JAX batcher's (greedy; logits agree to
~1e-6, see test_torch_model).
"""
import numpy as np
import pytest
import torch

from repro_torch.comm.buckets import bucketize
from repro_torch.comm.ledger import PAGE_IN_TAG, PAGE_OUT_TAG
from repro_torch.core.compressors import Compressor, WireSpec, make_compressor
from repro_torch.interop import params_from_jax
from repro_torch.kernels.ops import tile_rows
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve import (BlockPool, DeltaCertificationError, DeltaServeEngine,
                               DeltaStore, PersonalizedBatcher, PoolExhausted,
                               personalize_leaves)
from repro_torch.training.serving import Request
from repro_torch.utils.tree import tree_flatten_with_path

torch.set_num_threads(2)
ARCH = "h2o-danube-1.8b"
BLOCK = 4096
COMPRESSORS = {"top_k": {"k_frac": 0.01}, "qsgd_kernel": {"bits": 8}}


@pytest.fixture(scope="module")
def world():
    """JAX reduced params + 2 personalized users, and the same trees in the port."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import init_params
    from repro.serve import personalize_leaves as j_personalize
    from repro_torch.configs import get_config as t_get_config

    cfg = get_config(ARCH).reduced()
    jp = init_params(jax.random.PRNGKey(0), cfg)
    pers = [j_personalize(jp, jax.random.fold_in(jax.random.PRNGKey(1), u)) for u in range(2)]
    to_t = lambda t: params_from_jax(jax.tree_util.tree_map(np.asarray, t), device="cpu")
    return dict(jax=jax, jnp=jnp, cfg=cfg, tcfg=t_get_config(ARCH).reduced(), jp=jp,
                pers=pers, tp=to_t(jp), tpers=[to_t(p) for p in pers])


def _stores(w, name):
    """The same two users stored by both packages (JAX's draws injected)."""
    from repro.core.compressors import make_compressor as j_make
    from repro.serve import DeltaStore as JStore

    js = JStore(w["jp"], j_make(name, **COMPRESSORS[name]), block_size=BLOCK, seed=7)
    ts = DeltaStore(w["tp"], make_compressor(name, **COMPRESSORS[name]),
                    block_size=BLOCK, seed=7)
    for uid in range(2):
        js.put(uid, w["pers"][uid])
        noise = None
        if name == "qsgd_kernel":
            noise = torch.from_numpy(np.array(w["jax"].random.uniform(
                js.user_key(uid), (tile_rows(js.layout.padded_d), 512), w["jnp"].float32)))
        ts.put(uid, w["tpers"][uid], noise=noise)
    return js, ts


@pytest.mark.parametrize("name", sorted(COMPRESSORS))
def test_store_payload_bytes_and_ledger_equal_jax(world, name):
    js, ts = _stores(world, name)
    for uid in range(2):
        jpl, tpl = js.payload(uid), ts.payload(uid)
        assert tpl.nbytes == jpl.nbytes and tpl.meta == jpl.meta
        for k in jpl.planes:
            assert tpl.planes[k].tobytes() == np.asarray(jpl.planes[k]).tobytes()
    assert ts.ledger.bytes_by_tag() == js.ledger.bytes_by_tag()
    assert ts.ledger.bytes_by_tag()[PAGE_OUT_TAG] == ts.total_payload_bytes()


def test_personalized_batcher_generates_the_jax_tokens(world):
    """6 requests over 2 slots, two users + the base, qsgd_kernel deltas."""
    from repro.serve import BlockPool as JPool
    from repro.serve import PersonalizedBatcher as JBatcher
    from repro.training.serving import Request as JRequest

    js, ts = _stores(world, "qsgd_kernel")
    runs = []
    for Pool, Batcher, Req, store, cfg in (
            (JPool, JBatcher, JRequest, js, world["cfg"]),
            (BlockPool, PersonalizedBatcher, Request, ts, world["tcfg"])):
        pool = Pool(store, 64, metrics=None)
        b = Batcher(cfg, store, pool, n_slots=2, max_len=64)
        reqs = [Req(rid=i, prompt=np.arange(3 + i, 9 + 2 * i, dtype=np.int32), max_new=4,
                    user_id=(0, 1, None)[i % 3]) for i in range(6)]
        for r in reqs:
            b.submit(r)
        stats = b.run(max_ticks=200)
        assert stats.completed == 6
        runs.append(([r.generated for r in reqs], pool.stats(),
                     store.ledger.bytes_by_tag()[PAGE_IN_TAG]))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("name", sorted(COMPRESSORS))
def test_delta_path_bitwise_equals_materialized(world, name):
    tcfg = world["tcfg"]
    _, ts = _stores(world, name)
    pool = BlockPool(ts, 64, metrics=MetricsRegistry())
    eng = DeltaServeEngine(tcfg, ts, max_len=32)
    tables = torch.stack([pool.acquire(u).table for u in range(2)] +
                         [torch.zeros_like(pool.table_for(0))])
    eff = eng.eff_blocks_for([ts.personalized_params(0), ts.personalized_params(1), world["tp"]])
    toks = torch.arange(1, 16).reshape(3, 5)
    logits, cache = eng.prefill(pool, tables, toks)
    lm, cm = eng.prefill_materialized(eff, toks)
    assert torch.equal(logits, lm)
    for _ in range(4):
        tok = logits[:, -1, :tcfg.vocab_size].argmax(-1)[:, None]
        logits, cache = eng.decode(pool, tables, tok, cache)
        lm, cm = eng.decode_materialized(eff, tok, cm)
        assert torch.equal(logits, lm)


def test_pool_page_accounting_lru_and_pins(world):
    _, ts = _stores(world, "top_k")
    metrics = MetricsRegistry()
    per_user = BlockPool(ts, 64, metrics=MetricsRegistry()).acquire(0).n_blocks
    pool = BlockPool(ts, per_user, metrics=metrics)          # one user fits
    paged = lambda: ts.ledger.bytes_by_tag().get(PAGE_IN_TAG, 0)
    b0 = paged()
    pool.acquire(0)
    assert paged() - b0 == ts.nbytes(0) and pool.misses == 1      # miss
    with pytest.raises(PoolExhausted):                            # 0 is pinned
        pool.acquire(1)
    pool.release(0)
    b1 = paged()
    pool.acquire(0)
    pool.release(0)
    assert paged() == b1 and pool.hits == 1                       # hit: 0 bytes
    pool.acquire(1)                                               # evicts 0
    pool.release(1)
    assert pool.evictions == 1 and not pool.is_resident(0)
    b2 = paged()
    pool.acquire(0)                                               # full-price miss
    assert paged() - b2 == ts.nbytes(0)
    rows = pool.entry(0).rows
    assert (pool.blocks[0] == 0).all() and 0 not in rows          # row 0 stays zero
    assert metrics.get("serve/pool/misses").total == 3
    pool.release(0)
    with pytest.raises(RuntimeError):
        pool.release(0)                                           # not pinned


def test_certificate_rejects_a_payload_that_does_not_decode_to_the_carrier(world):
    calls = []

    def fn(x, noise, gen):                  # a new answer on every call
        calls.append(1)
        return x * float(len(calls))

    comp = Compressor("drifting", fn, eta=None, omega=None, bits_per_dim=32.0,
                      wire=WireSpec("dense"))
    store = DeltaStore(world["tp"], comp, block_size=BLOCK)
    with pytest.raises(DeltaCertificationError):
        store.put(0, world["tpers"][0])


def test_put_draws_seeded_noise_per_user(world):
    store = DeltaStore(world["tp"], make_compressor("qsgd_kernel"), block_size=BLOCK, seed=3)
    a = store.put(0, world["tpers"][0]).planes["q"].tobytes()
    b = store.put(0, world["tpers"][0]).planes["q"].tobytes()
    c = store.put(1, world["tpers"][0]).planes["q"].tobytes()
    assert a == b and a != c
    assert len(store) == 2 and store.user_ids() == [0, 1]


def test_personalize_leaves_touches_only_matching_leaves(world):
    tp = world["tp"]
    pers = personalize_leaves(tp, seed=5, match=("norm",))
    changed = []
    for (name, a), (_, b) in zip(tree_flatten_with_path(tp)[0],
                                 tree_flatten_with_path(pers)[0]):
        if a is not b:
            changed.append(name)
            assert not torch.equal(a, b)
    assert changed and all("norm" in n for n in changed)
    # the delta is nonzero exactly on the blocks those leaves cover
    base, layout = bucketize(tp, BLOCK)
    delta = bucketize(pers, BLOCK)[0] - base
    assert int(delta.ne(0).any(1).sum()) <= 4


def test_bitmap_wire_store_and_pager_equal_jax(world):
    """The documented opt-in: any sparsifier with WireSpec("sparse_bitmap").
    Payload planes (B4's words) and page-in bytes equal the JAX store's; the
    resident blocks equal the store's nonzero decoded blocks (B5)."""
    from dataclasses import replace

    from repro.core.compressors import WireSpec as JWire
    from repro.core.compressors import make_compressor as j_make
    from repro.serve import BlockPool as JPool
    from repro.serve import DeltaStore as JStore

    jcomp = replace(j_make("top_k", k_frac=0.01), wire=JWire("sparse_bitmap"))
    tcomp = replace(make_compressor("top_k", k_frac=0.01), wire=WireSpec("sparse_bitmap"))
    js = JStore(world["jp"], jcomp, block_size=BLOCK, seed=7)
    ts = DeltaStore(world["tp"], tcomp, block_size=BLOCK, seed=7)
    jpool, tpool = JPool(js, 64, metrics=None), BlockPool(ts, 64, metrics=MetricsRegistry())
    for uid in range(2):
        js.put(uid, world["pers"][uid])
        ts.put(uid, world["tpers"][uid])
        jpl, tpl = js.payload(uid), ts.payload(uid)
        assert tpl.scheme == "sparse_bitmap" and tpl.meta == jpl.meta
        assert tpl.nbytes == jpl.nbytes == \
            4 * (ts.layout.padded_d // 32) + 4 * tpl.planes["values"].size
        for k in jpl.planes:
            assert tpl.planes[k].tobytes() == np.asarray(jpl.planes[k]).tobytes(), k
        jpool.acquire(uid)
        entry = tpool.acquire(uid)
        blocks = ts.blocks(uid)
        nz = torch.nonzero(blocks.ne(0).any(dim=1)).reshape(-1)
        assert entry.n_blocks == int(nz.numel()) == jpool.entry(uid).n_blocks
        resident = tpool.blocks[entry.table[nz].long()]
        assert torch.equal(resident.view(torch.int32), blocks[nz].view(torch.int32))
    assert ts.ledger.bytes_by_tag() == js.ledger.bytes_by_tag()
    assert ts.ledger.bytes_by_tag()[PAGE_IN_TAG] == ts.total_payload_bytes()
