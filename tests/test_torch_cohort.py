"""The port's cohort simulator (``repro_torch.cohort``) against the JAX
package's ``repro.cohort``, on the CPU at small sizes.

Tolerances:
- Population laws, Feistel sampling, buckets and capacities, message and
  round bytes, ledger records and the materialized oracle: exact.
- The engine at 16 leaves (``cohort_bitident16``: fanouts 4, 2, 2), faults
  off and on, 3 rounds: every anchor equal to the jitted JAX engine's bit
  for bit, and to a torch per-client loop bit for bit.
- The port computes the source's operations: ``flix_local_step`` as its
  separate multiplies and adds, ``group_mean`` as a sum divided by n
  (``test_flix_step_and_group_mean_are_the_source_ops``).  Jitted, XLA's
  CPU backend may rewrite them (with the jaxlib this was written against it
  contracts FLIX's ``a * b + c`` shapes into multiply-adds and computes a
  mean over n as ``sum * (1/n)``), so where the leaf rows reach the anchors
  unsparsified the last bit can move: the 2-class depth-1 case is bitwise
  equal to the JAX operations dispatched one by one and within atol 1e-6
  of the jitted engine; the edge_fl_tree engine at cohort 200 (fanouts 10,
  5, 4) with faults is within atol 1e-6 of the jitted engine (not bitwise
  with that jaxlib).  At 16 leaves the WAN hop's top_k(0.01) keeps one
  coordinate a round, and the engine is bitwise.
- Every flattenable compressor's ``fn`` on a (G, d) stack of rows equals
  its 1-D call on each row bit for bit (the engine's one-pass leaf hop).
- The stochastic classes (rand_k and the dense qsgd), with the JAX draws
  passed as ``noise=``: within atol 1e-6 of the jitted engine.
- ``target_dist`` / ``root_norm``: rtol 1e-5 (the port sums in another
  order).

Each JAX engine compiles once per module (fixtures), jitted as the
reference runs; none runs op by op.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import cohort as tc
from repro_torch.comm.ledger import CommLedger as TLedger
from repro_torch.comm.topology import Link as TLink
from repro_torch.comm.tree import TreeLevel as TLevel
from repro_torch.comm.tree import TreeTopology as TTree
from repro_torch.comm.tree import get_tree_topology as tget_tree
from repro_torch.comm.tree import register_tree_topology as tregister
from repro_torch.core import compressors as tcomp
from repro_torch.core import distributed as tdist
from repro_torch.faults import FaultConfig as TFault
from repro_torch.obs.metrics import MetricsRegistry as TRegistry

torch.set_num_threads(2)
CPU = torch.device("cpu")
FAULTS = dict(seed=3, availability=0.7, drop_rate=0.1)
BYTE_FAULTS = dict(seed=11, availability=0.9, drop_rate=0.05)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro import cohort as jc
    from repro.comm import ledger as jledger
    from repro.comm import topology as jtopo
    from repro.comm import tree as jtree
    from repro.core import compressors as jcomp
    from repro.core import distributed as jdist
    from repro.faults import FaultConfig as JFault
    from repro.obs.metrics import MetricsRegistry as JRegistry
    return dict(jax=jax, jnp=jnp, c=jc, ledger=jledger, topo=jtopo, tree=jtree,
                comp=jcomp, dist=jdist, Fault=JFault, Registry=JRegistry)


def _both_trees(jx, name, levels):
    """Register the same tree preset in both packages."""
    jx["tree"].register_tree_topology(jx["tree"].TreeTopology(name, tuple(
        jx["tree"].TreeLevel(n, f, jx["topo"].Link(gbps=g, latency_us=l))
        for n, f, g, l in levels)))
    tregister(TTree(name, tuple(TLevel(n, f, TLink(gbps=g, latency_us=l))
                                for n, f, g, l in levels)))


def _both_classes(jx, specs):
    """The same link classes in both packages: (name, weight, gbps, latency,
    compressor, ratio)."""
    j = tuple(jx["c"].LinkClass(n, w, jx["topo"].Link(gbps=g, latency_us=l),
                                compressor=c, compress_ratio=r)
              for n, w, g, l, c, r in specs)
    t = tuple(tc.LinkClass(n, w, TLink(gbps=g, latency_us=l), compressor=c,
                           compress_ratio=r)
              for n, w, g, l, c, r in specs)
    return j, t


def _bitident(jx):
    _both_trees(jx, "cohort_bitident16", (("uplink", 4, 0.00625, 50_000.0),
                                          ("metro", 2, 1.0, 2_000.0),
                                          ("wan", 2, 1.0, 20_000.0)))
    jcls, tcls = _both_classes(jx, (("only", 1.0, 0.00625, 50_000.0, "top_k", 0.25),))
    kw = dict(n_clients=5_000, dim=32, tree="cohort_bitident16")
    return jx["c"].Population(classes=jcls, **kw), tc.Population(classes=tcls, **kw)


def _run(eng, rounds, noise=None):
    state, reps, anchors = eng.init_state(), [], []
    for rnd in range(rounds):
        kw = {} if noise is None else {"noise": noise(rnd)}
        state, rep = eng.round(state, rnd, **kw)
        reps.append(rep)
        anchors.append([np.array(a["x"]) if not isinstance(a["x"], torch.Tensor)
                        else a["x"].numpy().copy() for a in state.anchors])
    return anchors, reps


def _assert_bits(a, b, what):
    for r, (ra, rb) in enumerate(zip(a, b)):
        for l, (x, y) in enumerate(zip(ra, rb)):
            assert x.shape == y.shape and x.dtype == y.dtype, (what, r, l)
            assert x.tobytes() == y.tobytes(), (what, r, l, float(np.abs(x - y).max()))


def _bytes_fields(rb):
    return (rb.round, rb.leaf_class_counts, rb.leaf_class_nbytes, rb.upper_counts,
            rb.upper_nbytes, rb.total_bytes)


# ---------------------------------------------------------------------------
# population law, sampling, buckets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(n_clients=10_000, dim=16),
                                dict(n_clients=50_000, dim=32, alpha=10.0, seed=4,
                                     samples_min=4, samples_max=100, flix_min=0.5)],
                         ids=["default", "custom"])
def test_population_specs_equal_jax_and_slice(jx, kw):
    jp, tp = jx["c"].Population(**kw), tc.Population(**kw)
    ids = np.array([7, 9_999, 0, 4_321, 123, 8_888])
    js, ts = jp.client_spec(ids), tp.client_spec(ids)
    for f in ("ids", "class_ids", "targets", "flix_alpha", "n_samples"):
        a, b = getattr(js, f), getattr(ts, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert tp.prototypes().tobytes() == jp.prototypes().tobytes()
    assert tp.mixtures(ids).tobytes() == jp.mixtures(ids).tobytes()
    np.testing.assert_array_equal(tp.class_mix_counts(np.arange(5_000)),
                                  jp.class_mix_counts(np.arange(5_000)))
    for i, cid in enumerate(ids):  # slicing invariance
        one = tp.client_spec(np.array([cid]))
        assert one.targets[0].tobytes() == ts.targets[i].tobytes()
        assert (one.class_ids[0], one.flix_alpha[0], one.n_samples[0]) == \
               (ts.class_ids[i], ts.flix_alpha[i], ts.n_samples[i])
    fields = [(c.name, c.weight, c.link.gbps, c.link.latency_us, c.compressor,
               c.compress_ratio, c.quant_bits) for c in tp.classes]
    assert fields == [(c.name, c.weight, c.link.gbps, c.link.latency_us, c.compressor,
                       c.compress_ratio, c.quant_bits) for c in jp.classes]


def test_population_validation_as_jax():
    classes = tc.link_classes_from_tree(tget_tree("edge_fl_tree"))
    bad = tuple(dataclasses.replace(lc, weight=0.5) for lc in classes)
    with pytest.raises(ValueError, match="weights"):
        tc.Population(n_clients=10, classes=bad)
    with pytest.raises(ValueError, match="ids outside"):
        tc.Population(n_clients=10).client_spec(np.array([10]))


@pytest.mark.parametrize("args", [(0, 5, 1_000_000, 50_000), (1, 2, 10_000, 500),
                                  (4, 0, 257, 257), (9, 3, 1_000_000, 2_000)])
def test_sample_cohort_equals_jax(jx, args):
    a, b = jx["c"].sample_cohort(*args), tc.sample_cohort(*args)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert len(np.unique(b)) == args[3]
    with pytest.raises(ValueError):
        tc.sample_cohort(0, 0, 100, 101)


@pytest.mark.parametrize("cohort,lo,hi", [(3_000, 8, 64), (200, 8, 64), (5_000, 4, 100)])
def test_buckets_equal_jax(jx, cohort, lo, hi):
    bb = tc.bucket_boundaries(hi, min_size=lo)
    assert bb == jx["c"].bucket_boundaries(hi, min_size=lo)
    caps = tc.bucket_capacities(bb, cohort, lo, hi)
    assert caps == jx["c"].bucket_capacities(bb, cohort, lo, hi)
    sizes = np.random.default_rng(cohort).integers(lo, hi + 1, size=cohort)
    jb, tb = jx["c"].bucket_by_size(sizes, bb, caps), tc.bucket_by_size(sizes, bb, caps)
    assert tb.padded_steps == jb.padded_steps
    for a, b in zip(jb.index + jb.valid, tb.index + tb.valid):
        assert a.tobytes() == b.tobytes()
    with pytest.raises(RuntimeError, match="capacities exhausted"):
        tc.bucket_by_size(np.array([8, 8, 8, 64]), (8, 64), (2, 1))
    with pytest.raises(ValueError, match="top boundary"):
        tc.bucket_by_size(np.array([65]), (8, 64), (2, 2))


def test_cohort_compressor_rejects_unflattenable():
    assert tc.cohort_compressor("qsgd", 0.05, 8).flatten
    assert tc.cohort_compressor("qsgd", 0.05, 8).name == "qsgd(8b,2048)"
    with pytest.raises(ValueError, match="not flattenable"):
        tc.cohort_compressor("qsgd_sharded", 0.05, 8)


# ---------------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,ratio", [("identity", 0.05), ("top_k", 0.05), ("top_k", 0.01),
                                        ("rand_k", 0.25), ("qsgd", 0.05), ("topk_block", 0.05)])
@pytest.mark.parametrize("dim", [16, 32, 100])
def test_message_nbytes_equal_jax(jx, name, ratio, dim):
    want = jx["c"].message_nbytes(jx["c"].cohort_compressor(name, ratio, 8), dim)
    assert tc.message_nbytes(tc.cohort_compressor(name, ratio, 8), dim, device=CPU) == want
    from repro_torch.comm.accounting import PROBE_CAP
    with pytest.raises(ValueError, match="probe cap"):
        tc.message_nbytes(tcomp.identity(), PROBE_CAP + 1, device=CPU)


def test_default_class_and_level_bytes():
    pop = tc.Population(n_clients=1_000, dim=32)
    eng = tc.CohortEngine(pop, cohort_size=100, device=CPU)
    assert eng.accountant.class_nbytes == (128, 16, 8)
    assert eng.accountant.upper_nbytes == (128, 8)


def test_round_bytes_ledger_and_oracle_equal_jax(jx):
    kw = dict(n_clients=10_000, dim=32)
    jp, tp = jx["c"].Population(**kw), tc.Population(**kw)
    jtree = jx["tree"].get_tree_topology("edge_fl_tree").with_n_leaves(60)
    ttree = tget_tree("edge_fl_tree").with_n_leaves(60)
    jup = (jx["c"].cohort_compressor("identity", 0.05, 8), jx["c"].cohort_compressor("top_k", 0.01, 8))
    tup = (tc.cohort_compressor("identity", 0.05, 8), tc.cohort_compressor("top_k", 0.01, 8))
    ja = jx["c"].CohortAccountant(jtree, jp.classes, jup, 32)
    ta = tc.CohortAccountant(ttree, tp.classes, tup, 32, device=CPU)
    from repro.faults import FaultModel as JModel
    from repro_torch.faults import FaultModel as TModel
    jm, tm = JModel(jx["Fault"](**FAULTS), jtree), TModel(TFault(**FAULTS), ttree)
    jl, tl = jx["ledger"].CommLedger(), TLedger()
    for rnd in range(3):
        ids = tc.sample_cohort(0, rnd, 10_000, 60)
        cls = tp.link_class_ids(ids)
        np.testing.assert_array_equal(ta.uplink_time_s(cls), ja.uplink_time_s(cls))
        tmasks = tm.round_plan(rnd, leaf_lanes=ids).survivor_masks()
        jmasks = jm.round_plan(rnd, leaf_lanes=ids).survivor_masks()
        for a, b in zip(tmasks, jmasks):
            assert a.tobytes() == b.tobytes()
        for masks in (None, tmasks):
            trb, jrb = ta.round_bytes(rnd, cls, masks), ja.round_bytes(rnd, cls, masks)
            assert _bytes_fields(trb) == _bytes_fields(jrb)
            assert trb.by_level(ttree) == jrb.by_level(jtree)
            oracle = tc.materialized_round_bytes(rnd, cls, tp.classes, tup, ttree, 32, masks,
                                                 device=CPU)
            assert oracle == trb.total_bytes == jx["c"].materialized_round_bytes(
                rnd, cls, jp.classes, jup, jtree, 32, masks)
            ta.record(tl, trb)
            ja.record(jl, jrb)
    assert [dataclasses.astuple(r) for r in tl.records] == \
           [dataclasses.astuple(r) for r in jl.records]
    assert tl.bytes_by_tag() == jl.bytes_by_tag()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _torch_reference_round(eng, state, rnd):
    """The per-client loop in torch: every sampled client's local steps one
    client at a time, then one direct ``tree_param_sync`` call (the single
    class's compressor, once per row)."""
    ids = eng.round_cohort(rnd)
    spec = eng.pop.client_spec(ids)
    plan = eng.round_plan(rnd, ids, spec.class_ids)
    masks = plan.survivor_masks() if plan is not None else None
    x0 = torch.repeat_interleave(state.anchors[0]["x"], eng.cascade[0].fanout, dim=0)
    rows = []
    for i in range(x0.shape[0]):
        xi, t = x0[i].clone(), torch.from_numpy(spec.targets[i])
        a = torch.tensor(spec.flix_alpha[i])
        for _ in range(int(spec.n_samples[i])):
            xi = tc.flix_local_step(xi, t, a, eng.lr)
        rows.append(xi)
    _, new_state = tdist.tree_param_sync({"x": torch.stack(rows)}, state, eng.cascade,
                                         bucket_size=eng.pop.dim, survivors=masks)
    return new_state


@pytest.mark.parametrize("faults", [False, True], ids=["nofault", "faulted"])
def test_engine16_bitwise_to_jitted_jax_and_per_client_loop(jx, faults):
    jp, tp = _bitident(jx)
    je = jx["c"].CohortEngine(jp, cohort_size=16,
                              fault_config=jx["Fault"](**FAULTS) if faults else None)
    te = tc.CohortEngine(tp, cohort_size=16, fault_config=TFault(**FAULTS) if faults else None,
                         device=CPU)
    ja, jr = _run(je, 3)
    ta, tr = _run(te, 3)
    _assert_bits(ja, ta, "engine vs jitted JAX")
    sr, ref = te.init_state(), []
    for rnd in range(3):
        sr = _torch_reference_round(te, sr, rnd)
        ref.append([a["x"].numpy().copy() for a in sr.anchors])
    _assert_bits(ref, ta, "engine vs per-client loop")
    for a, b in zip(jr, tr):
        assert _bytes_fields(a.bytes) == _bytes_fields(b.bytes)
        assert a.n_participants == b.n_participants
    assert faults == (tr[-1].n_participants < 16)


def test_two_class_case_bitwise_to_jax_ops(jx):
    """tests/test_cohort.py's K=2 case: identity and top_k(0.25) on a depth-1
    tree of 8 leaves, so the root anchor is the one-hot blended update.  Bit
    for bit equal to the JAX package's operations dispatched one by one (the
    reference test's hand-rolled round: each client's FLIX steps, its own
    class compressor under the engine's keys, the mean); within atol 1e-6 of
    the jitted engine, whose FLIX steps XLA may contract into multiply-adds
    (module docstring)."""
    jax, jnp = jx["jax"], jx["jnp"]
    _both_trees(jx, "cohort_het_flat", (("uplink", 8, 0.001, 50_000.0),))
    jcls, tcls = _both_classes(jx, (("fast", 0.5, 0.1, 100.0, "identity", 0.05),
                                    ("slow", 0.5, 0.001, 50_000.0, "top_k", 0.25)))
    kw = dict(n_clients=1_000, dim=32, tree="cohort_het_flat")
    je = jx["c"].CohortEngine(jx["c"].Population(classes=jcls, **kw), cohort_size=8)
    te = tc.CohortEngine(tc.Population(classes=tcls, **kw), cohort_size=8, device=CPU)
    ja, _ = _run(je, 2)
    ta, tr = _run(te, 2)
    spec = te.pop.client_spec(tr[0].cohort_ids)
    assert len(np.unique(spec.class_ids)) == 2
    for x, y in zip(ja, ta):
        np.testing.assert_allclose(y[0], x[0], rtol=0, atol=1e-6)

    root = jnp.zeros((32,), jnp.float32)
    x = jnp.repeat(root[None], 8, axis=0)
    t, a = jnp.asarray(spec.targets), jnp.asarray(spec.flix_alpha)[:, None]
    m = jnp.asarray(spec.n_samples)[:, None]
    for s in range(int(spec.n_samples.max())):
        x = jnp.where(s < m, jx["c"].flix_local_step(x, t, a, te.lr), x)
    comps = [lc.make_compressor() for lc in je.pop.classes]
    keys = jax.random.split(je.round_key(0), 8)
    d = jnp.stack([comps[int(spec.class_ids[i])](keys[i], x[i] - root) for i in range(8)])
    want = root + je.cascade[0].lam * jnp.mean(d, axis=0)
    assert np.asarray(want).tobytes() == ta[0][0].tobytes()


def test_stochastic_classes_with_jax_draws(jx):
    """rand_k(0.25) and the dense qsgd as link classes, the JAX engine's
    own leaf draws (``split(_level_key(round_key, 0, L), G)``, one per class)
    passed as ``noise=``."""
    jax, jnp = jx["jax"], jx["jnp"]
    _both_trees(jx, "cohort_stoch_flat", (("uplink", 8, 0.001, 50_000.0),))
    jcls, tcls = _both_classes(jx, (("rk", 0.5, 0.1, 100.0, "rand_k", 0.25),
                                    ("q8", 0.5, 0.001, 50_000.0, "qsgd", 0.05)))
    kw = dict(n_clients=1_000, dim=32, tree="cohort_stoch_flat")
    je = jx["c"].CohortEngine(jx["c"].Population(classes=jcls, **kw), cohort_size=8)
    te = tc.CohortEngine(tc.Population(classes=tcls, **kw), cohort_size=8, device=CPU)
    assert te.cascade[0].lam == je.cascade[0].lam < 1.0

    def noise(rnd):
        keys = jax.random.split(jx["dist"]._level_key(je.round_key(rnd), 0, 1), 8)
        rk = jnp.stack([jax.random.uniform(k, (32,)) for k in keys])
        q8 = jnp.stack([jax.random.uniform(k, (1, 2048), minval=-0.5, maxval=0.5)
                        for k in keys])
        return ((torch.from_numpy(np.array(rk)), torch.from_numpy(np.array(q8))),)

    ja, _ = _run(je, 2)
    ta, tr = _run(te, 2, noise=noise)
    assert len(np.unique(tr[0].class_ids)) == 2
    for x, y in zip(ja, ta):
        np.testing.assert_allclose(y[0], x[0], rtol=0, atol=1e-6)
    # without noise= the round draws from its own (seed, round) generator
    a, _ = _run(te, 1)
    b, _ = _run(tc.CohortEngine(tc.Population(classes=tcls, **kw), cohort_size=8,
                                device=CPU), 1)
    _assert_bits(a, b, "generator replay")


@pytest.fixture(scope="module")
def edge200(jx):
    """edge_fl_tree at cohort 200 (fanouts 10, 5, 4) with byte faults, 3
    rounds on both engines, each with a ledger and a registry."""
    kw = dict(n_clients=10_000, dim=32)
    jreg, treg = jx["Registry"](), TRegistry()
    jl, tl = jx["ledger"].CommLedger(), TLedger()
    je = jx["c"].CohortEngine(jx["c"].Population(**kw), cohort_size=200,
                              fault_config=jx["Fault"](**BYTE_FAULTS), ledger=jl, metrics=jreg)
    te = tc.CohortEngine(tc.Population(**kw), cohort_size=200,
                         fault_config=TFault(**BYTE_FAULTS), ledger=tl, metrics=treg,
                         device=CPU)
    return dict(jax=_run(je, 3), torch=_run(te, 3), jreg=jreg, treg=treg, jl=jl, tl=tl,
                te=te)


def test_edge200_close_to_jitted_jax(jx, edge200):
    """Within atol 1e-6 of the jitted engine.  Not bitwise with the jaxlib
    this was written against: its XLA contracts the FLIX steps into
    multiply-adds and takes the means as ``sum * (1/n)`` (module
    docstring); the port computes the source's operations."""
    (ja, jr), (ta, tr) = edge200["jax"], edge200["torch"]
    assert [[l.shape for l in r] for r in ta] == [[(20, 32), (4, 32), (32,)]] * 3
    for ra, rb in zip(ja, ta):
        for x, y in zip(ra, rb):
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-6)


def test_flix_step_and_group_mean_are_the_source_ops():
    """The port's FLIX step is the source's ``x - lr * (a * ((a * x + (1 -
    a) * t) - t))`` and its mean over n children the sum in order divided by
    n, each bit for bit in f32."""
    rng = np.random.default_rng(0)
    x0, t = (rng.standard_normal((8, 32)).astype(np.float32) for _ in range(2))
    a = rng.uniform(0.25, 1.0, (8, 1)).astype(np.float32)
    lr, one = np.float32(0.1), np.float32(1.0)
    plain, port = x0.copy(), torch.from_numpy(x0.copy())
    for _ in range(20):
        plain = plain - lr * (a * ((a * plain + (one - a) * t) - t))
        port = tc.flix_local_step(port, torch.from_numpy(t), torch.from_numpy(a), 0.1)
    assert port.numpy().tobytes() == plain.tobytes()

    s = rng.standard_normal((10, 32)).astype(np.float32)
    acc = s[0].copy()
    for i in range(1, 10):
        acc = acc + s[i]
    assert tdist.group_mean(torch.from_numpy(s)).numpy().tobytes() == \
           (acc / np.float32(10)).tobytes()


ROW_WISE = [("identity", {}), ("top_k", dict(k_frac=0.25)), ("rand_k", dict(k_frac=0.25)),
            ("topk_block", dict(k_frac=0.05)), ("qsgd", {}), ("mix_k", dict(
                k_frac_top=0.25, k_frac_rand=0.5)), ("comp_k", dict(
                    k_frac_top=0.1, k_frac_rand=0.5)), ("qsgd_kernel", {})]


@pytest.mark.parametrize("name,kw", ROW_WISE, ids=[n for n, _ in ROW_WISE])
@pytest.mark.parametrize("d", [32, 100, 2_100])
def test_compressor_fn_is_row_wise(name, kw, d):
    """``c.fn`` on a (G, d) stack with the stacked per-row draws equals the
    1-D call on each row bit for bit: the engine's leaf hop runs each link
    class in one pass over all rows this way."""
    c = tcomp.make_compressor(name, **kw)
    g = torch.Generator().manual_seed(d)
    x = torch.randn((6, d), generator=g)
    x[1, :d // 2] = 0.0                      # a row with ties at zero
    x[2] = 0.0                               # an all-zero row
    row_draws = [_row_draw(name, d, g) for _ in range(x.shape[0])]
    stacked = None if row_draws[0] is None else (
        tuple(torch.stack(p) for p in zip(*row_draws)) if isinstance(row_draws[0], tuple)
        else torch.stack(row_draws))
    got = c.fn(x, stacked, None)
    assert got.shape == x.shape
    for i in range(x.shape[0]):
        want = c(x[i], noise=row_draws[i])
        assert got[i].numpy().tobytes() == want.numpy().tobytes(), (name, i)


def _row_draw(name, d, g):
    """One row's injected draws, in the shape the 1-D compressor takes."""
    from repro_torch.kernels.ops import tile_rows

    if name in ("rand_k", "comp_k"):
        return torch.rand((d,), generator=g)
    if name == "mix_k":
        return torch.rand((), generator=g), torch.rand((d,), generator=g)
    if name == "qsgd":
        return torch.rand((-(-d // 2048), 2048), generator=g) - 0.5
    if name == "qsgd_kernel":
        return torch.rand((tile_rows(d), 512), generator=g)
    return None


def test_report_fields_equal_jax_and_replay(edge200):
    (ja, jr), (ta, tr) = edge200["jax"], edge200["torch"]
    for a, b in zip(jr, tr):
        assert a.round == b.round
        for f in ("cohort_ids", "class_ids"):
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
        assert _bytes_fields(a.bytes) == _bytes_fields(b.bytes)
        for la, lb in zip(a.plan.levels, b.plan.levels):
            assert la.survivors.tobytes() == lb.survivors.tobytes()
            assert la.arrival_s.tobytes() == lb.arrival_s.tobytes()
        assert (a.staged_nbytes, a.padded_steps, a.n_participants) == \
               (b.staged_nbytes, b.padded_steps, b.n_participants)
        assert set(a.metrics) == set(b.metrics)
        for k in a.metrics:
            assert b.metrics[k] == pytest.approx(a.metrics[k], rel=1e-5), k
    # (seed, round) fully determines a round: a fresh engine replays round 2
    te = edge200["te"]
    fresh = tc.CohortEngine(te.pop, cohort_size=200, fault_config=TFault(**BYTE_FAULTS),
                            device=CPU)
    state = fresh.init_state()
    for rnd in range(3):
        state, rep = fresh.round(state, rnd)
    assert rep.cohort_ids.tobytes() == tr[2].cohort_ids.tobytes()
    assert _bytes_fields(rep.bytes) == _bytes_fields(tr[2].bytes)
    _assert_bits([[a["x"].numpy() for a in state.anchors]], [ta[2]], "replay")
    assert edge200["tl"].bytes_by_tag() == edge200["jl"].bytes_by_tag()
    by_level = {}
    for b in tr:
        for k, v in b.bytes.by_level(te.tree).items():
            by_level[k] = by_level.get(k, 0) + v
    assert edge200["tl"].bytes_by_tag() == by_level


def test_observe_cohort_round_equals_jax(edge200, tmp_path):
    jd, td = edge200["jreg"].to_dict(), edge200["treg"].to_dict()
    assert [m["name"] for m in jd["metrics"]] == [m["name"] for m in td["metrics"]]
    for a, b in zip(jd["metrics"], td["metrics"]):
        assert a["kind"] == b["kind"], a["name"]
        if a["name"] in ("cohort/target_dist", "cohort/root_norm"):
            np.testing.assert_allclose([v for _, v in b["series"]],
                                       [v for _, v in a["series"]], rtol=1e-5)
        else:
            assert a == b, a["name"]
    treg = edge200["treg"]
    assert treg.get("cohort/bytes/total").total == sum(
        r.bytes.total_bytes for r in edge200["torch"][1])
    assert treg.fault_stats() == edge200["jreg"].fault_stats()
    assert "round_time_s" in treg.fault_stats()
    path = treg.export_json(str(tmp_path / "m.json"), extra={"run": "cohort"})
    doc = json.loads(open(path).read())
    assert doc["run"] == "cohort" and doc["metrics"] == json.loads(json.dumps(td["metrics"]))


def test_engine_memory_is_cohort_shaped():
    """Nothing population-shaped is staged: the staged bytes are equal for a
    10x population at one cohort size and grow with the cohort."""
    def staged(n_pop, cohort):
        eng = tc.CohortEngine(tc.Population(n_clients=n_pop, dim=32), cohort_size=cohort,
                              device=CPU)
        state, rep = eng.round(eng.init_state(), 0)
        return rep.staged_nbytes, [tuple(a["x"].shape) for a in state.anchors]

    a, b, c = staged(20_000, 400), staged(200_000, 400), staged(200_000, 1_600)
    assert a == b
    assert c[0] > 3 * a[0] and c[1] == a[1]
