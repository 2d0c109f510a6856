"""Kernel D1, the serving engine's delta apply (``kernels.delta_apply``).

On the CPU: the work list's pieces cover ``[0, layout.d)`` once, each inside
one leaf, at most ``PIECE`` long and carrying its leaf's dtype, at the full
layouts of mamba2-2.7b and h2o-danube-1.8b (trees on ``meta``: shapes, no
weights) and on a small tree of both dtypes whose leaves have sizes that are
not multiples of 4 and straddle buckets; the work list's addresses, and
``work_list``, the tree's one check, refusing a leaf of the wrong dtype or
shape, a non-contiguous leaf, a dtype D1 does not store and a bucket size
that is not a power of two; the plain version bit for bit equal to
``debucketize(index_select(pool, table) + base)``, with tables aliasing the
zero row, a ``-0.0`` base, denormal sums and sums that round to infinity in
bf16; a table row past the pool refused.

On the card (``cuda``, skipped without one): the kernel bit for bit equal to
the plain version on the same cases, with leaves whose output is aligned
with the flat index and leaves whose output is not; a launch counted per
call; ``work_list`` and the wrapper raising on what the kernel does not
take.
"""
import numpy as np
import pytest
import torch

from repro_torch.comm.buckets import bucket_layout, debucketize, empty_tree, to_dtype
from repro_torch.configs import get_config
from repro_torch.kernels import delta_apply as da
from repro_torch.utils.tree import tree_flatten, tree_unflatten

BS = 16                                  # the small case's bucket
# name -> (shape, dtype): sizes off multiples of 4, two leaves over PIECE
SMALL = {"a": ((3, 5), torch.bfloat16), "b": ((7,), torch.float32),
         "c": ((37,), torch.bfloat16), "d": ((2, 9), torch.float32),
         "e": ((43,), torch.bfloat16), "f": ((64,), torch.float32),
         "g": ((da.PIECE + 1003,), torch.bfloat16), "h": ((da.PIECE + 37,), torch.float32),
         "i": ((5,), torch.bfloat16)}


def _layout(bs=BS):
    tree = {k: torch.empty(shape, dtype=dt, device="meta") for k, (shape, dt) in SMALL.items()}
    return bucket_layout(tree, bs)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _check_pieces(layout, rows, cap):
    starts, lens = rows[:, 1], rows[:, 2]
    assert rows.dtype == np.int64 and rows.shape[1] == 4
    assert starts[0] == 0 and starts[-1] + lens[-1] == layout.d
    assert np.array_equal(starts[1:], starts[:-1] + lens[:-1])     # each element once
    assert lens.min() >= 1 and lens.max() <= cap
    off = np.asarray(layout.offsets)[rows[:, 0]]
    size = np.asarray(layout.sizes)[rows[:, 0]]
    assert (starts >= off).all() and (starts + lens <= off + size).all()
    bf16 = np.asarray([to_dtype(dt) == torch.bfloat16 for dt in layout.dtypes])[rows[:, 0]]
    assert np.array_equal(rows[:, 3], bf16.astype(np.int64))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "h2o-danube-1.8b"])
def test_pieces_cover_a_full_layout_once(arch):
    from repro_torch.models import init_params

    layout = bucket_layout(init_params(0, get_config(arch), device="meta"), 4096)
    rows = da.pieces(layout)
    _check_pieces(layout, rows, da.PIECE)
    assert layout.d > 1.8e9 and len(rows) == sum(-(-s // da.PIECE) for s in layout.sizes)
    assert all(to_dtype(dt) in da.DTYPES for dt in layout.dtypes)      # D1 takes it


@pytest.mark.parametrize("cap", [4, 7, da.PIECE])
def test_pieces_of_a_ragged_tree_stay_inside_their_leaves(cap):
    layout = _layout()
    assert any(s % 4 for s in layout.sizes) and any(o % 4 for o in layout.offsets)
    assert any(o // BS != (o + s - 1) // BS for o, s in zip(layout.offsets, layout.sizes))
    _check_pieces(layout, da.pieces(layout, cap), cap)


def _spoiled(layout, tree, how):
    """``(layout, tree)`` with one thing D1 does not take."""
    leaves = tree_flatten(tree)[0]
    if how == "bucket":
        return _layout(bs=12), tree
    if how == "float16":
        return bucket_layout({"x": torch.empty(40, dtype=torch.float16)}, BS), \
            {"x": torch.empty(40, dtype=torch.float16)}
    bad = {"dtype": lambda leaf: leaf.to(torch.float64),
           "shape": lambda leaf: leaf.reshape(-1)[:-1].clone(),
           "strided": lambda leaf: torch.empty((leaf.numel(), 2), dtype=leaf.dtype)[:, 0]}[how]
    return layout, tree_unflatten(layout.treedef, [bad(leaf) if j == 1 else leaf
                                                   for j, leaf in enumerate(leaves)])


@pytest.mark.parametrize("spoil, error", [(None, None), ("dtype", TypeError),
                                          ("float16", TypeError), ("shape", ValueError),
                                          ("strided", ValueError), ("bucket", ValueError)])
def test_work_list_points_at_each_pieces_first_output_element(spoil, error):
    """The work list's addresses; building it is the tree's one check, so
    it refuses a leaf of the wrong dtype or shape, a non-contiguous leaf, a
    dtype D1 does not store and a bucket size that is not a power of two."""
    layout = _layout()
    tree = empty_tree(layout)
    if spoil is not None:
        with pytest.raises(error):
            da.work_list(*_spoiled(layout, tree, spoil))
        return
    leaves = tree_flatten(tree)[0]
    work = da.work_list(layout, tree).numpy()
    rows = da.pieces(layout)
    assert np.array_equal(work[:, 1:], rows[:, 1:])
    for (j, start, _, _), ptr in zip(rows, work[:, 0]):
        leaf = leaves[j]
        assert ptr == leaf.data_ptr() + (start - layout.offsets[j]) * leaf.element_size()


def test_plain_version_raises_on_a_row_past_the_pool():
    """A table entry must index a row of the pool: the plain version's
    gather refuses one past the end (D1 reads it unchecked, so the
    precondition is the caller's, as the engine's ``BlockPool`` tables
    keep it)."""
    layout, base, pool, table, tree = _case("cpu", 5)
    bad = table.clone()
    bad[3] = pool.shape[0]
    with pytest.raises(IndexError):
        da.delta_apply(base, pool, bad, tree, layout)
    with pytest.raises(IndexError):
        da.delta_apply_plain(base, pool, bad, empty_tree(layout), layout)


def _case(device, seed: int, shifted: bool = False):
    """A small layout's inputs: f32 base (n_blocks, BS), a pool whose row 0
    is zero, a table aliasing row 0 and repeating rows, and an empty tree.
    The values hold -0.0 bases on zero rows, denormal sums and sums past
    bf16's largest finite value.  ``shifted`` makes each leaf a view whose
    element address is congruent to its flat offset mod 4 (the kernel's
    vector path after a head); else leaves start where the allocator put
    them (misaligned outputs take the scalar path)."""
    layout = _layout()
    rng = np.random.default_rng(seed)
    nb = layout.n_buckets
    base = rng.standard_normal((nb, BS)).astype(np.float32)
    pool = rng.standard_normal((nb + 1, BS)).astype(np.float32)
    table = rng.integers(1, nb + 1, nb).astype(np.int32)
    table[rng.random(nb) < 0.3] = 0
    table[1::7] = table[0]                                          # rows repeated
    zero = table == 0
    base[zero, :4] = -0.0
    base[:, 4] = np.float32(1e-40)                                  # denormals
    pool[:, 4] = np.float32(-3e-41)
    base[:, 5] = np.float32(3.39e38)                                # bf16 -> inf
    pool[:, 5] = np.float32(1e36)
    base[:, 6] = np.float32(1.0 + 2.0 ** -8)                        # a bf16 tie
    base[:, 7] = np.float32(-1.0 - 3 * 2.0 ** -8)
    pool[0] = 0.0
    t = lambda a: torch.from_numpy(a).to(device)
    leaves = []
    for shape, dt, off, size in zip(layout.shapes, layout.dtypes, layout.offsets,
                                    layout.sizes):
        shift = off % 4 if shifted else 0
        buf = torch.empty(size + 4, dtype=to_dtype(dt), device=device)
        leaves.append(buf[shift:shift + size].view(shape))
    return (layout, t(base), t(pool), t(table),
            tree_unflatten(layout.treedef, leaves))


def _want(layout, base, pool, table):
    eff = torch.index_select(pool.cpu(), 0, table.cpu().long()) + base.cpu()
    return tree_flatten(debucketize(eff, layout))[0]


def _assert_bits(tree, want):
    got = tree_flatten(tree)[0]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_version_equals_debucketize_of_the_f32_sum_bitwise(seed):
    layout, base, pool, table, tree = _case("cpu", seed)
    want = _want(layout, base, pool, table)
    bf = [w for w in want if w.dtype == torch.bfloat16]
    assert any(bool(torch.isinf(w).any()) for w in bf)
    flat = torch.cat([w.float().reshape(-1) for w in want])
    assert bool(((flat != 0) & (flat.abs() < 1.17549435e-38)).any())     # denormal sums
    # -0.0 + the zero row's 0.0 is +0.0: no element of the sum is -0.0
    assert not bool(((flat == 0) & torch.signbit(flat)).any())
    assert da.delta_apply(base, pool, table, tree, layout) is tree
    _assert_bits(tree, want)
    tree2 = empty_tree(layout)
    _assert_bits(da.delta_apply_plain(base, pool, table, tree2, layout), want)


def test_cpu_tensors_count_no_launch_and_bad_inputs_raise():
    layout, base, pool, table, tree = _case("cpu", 2)
    before = da.delta_apply.launches
    da.delta_apply(base, pool, table, tree, layout)
    assert da.delta_apply.launches == before
    with pytest.raises(TypeError):
        da.delta_apply(base.double(), pool, table, tree, layout)
    with pytest.raises(TypeError):
        da.delta_apply(base, pool, table.long(), tree, layout)
    with pytest.raises(ValueError):
        da.delta_apply(base.t().contiguous().t(), pool, table, tree, layout)
    with pytest.raises(ValueError):
        da.delta_apply(base[:-1], pool, table, tree, layout)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (none present)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed, shifted", [(0, False), (1, False), (2, True), (3, True)])
def test_kernel_equals_the_plain_version_bitwise(cuda_device, seed, shifted):
    layout, base, pool, table, tree = _case(cuda_device, seed, shifted)
    plain = empty_tree(layout, cuda_device)
    da.delta_apply_plain(base, pool, table, plain, layout)
    work = da.work_list(layout, tree)
    before = da.delta_apply.launches
    assert da.delta_apply(base, pool, table, tree, layout, work) is tree
    torch.cuda.synchronize(cuda_device)
    assert da.delta_apply.launches == before + 1
    _assert_bits(tree, [leaf.cpu() for leaf in tree_flatten(plain)[0]])
    _assert_bits(tree, _want(layout, base, pool, table))
    # a second table into the same tree at the same addresses
    ptrs = [leaf.data_ptr() for leaf in tree_flatten(tree)[0]]
    table2 = torch.flip(table, (0,)).contiguous()
    da.delta_apply(base, pool, table2, tree, layout, work)
    torch.cuda.synchronize(cuda_device)
    assert [leaf.data_ptr() for leaf in tree_flatten(tree)[0]] == ptrs
    _assert_bits(tree, _want(layout, base, pool, table2))


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take(cuda_device):
    """A tree or layout D1 does not take raises where its work list is
    built; a call without the work list or with a bad table raises; none
    launches."""
    layout, base, pool, table, tree = _case(cuda_device, 4)
    half = {"x": torch.empty(40, dtype=torch.float16, device=cuda_device)}
    before = da.delta_apply.launches
    with pytest.raises(TypeError):
        da.work_list(bucket_layout(half, BS), half)
    with pytest.raises(ValueError):
        da.work_list(_layout(bs=12), tree)
    leaves = tree_flatten(tree)[0]
    strided = torch.empty((leaves[1].numel(), 2), device=cuda_device)[:, 0]
    bad = tree_unflatten(layout.treedef, [strided if i == 1 else leaf
                                          for i, leaf in enumerate(leaves)])
    with pytest.raises(ValueError):
        da.work_list(layout, bad)
    with pytest.raises(ValueError):
        da.delta_apply(base, pool, table, tree, layout)
    with pytest.raises(TypeError):
        da.delta_apply(base, pool, table.long(), tree, layout, da.work_list(layout, tree))
    assert da.delta_apply.launches == before
