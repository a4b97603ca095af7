"""The route and the tables of the fused HF AdamW (``ops/cuda_adamw.py``), on
the CPU: which leaves the kernel takes and which it refuses, how they group,
their row layouts, the block table, when the device tables are rebuilt, and
the CPU path (the per-leaf loop) against the JAX package.  The kernel itself
runs only on the card (``tests/test_torch_cuda.py``, bit-equal to the loop).
Here :func:`cuda_adamw.gather` is called on CPU tensors, as :func:`split`
calls it on the card's, and the launch is replaced by a stand-in that
applies the loop's update to each block's elements of its leaf, read from
the tables (addresses, row length and row strides), so that the tables must
cover every element of every leaf once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vault_tpu.training import optimizer as jopt
from vault_tpu_torch.ops import cuda_adamw
from vault_tpu_torch.ops.cuda_adamw import CHUNK, MAX_LEAVES
from vault_tpu_torch.training import optimizer as topt

F32, BF16, F16, F64 = torch.float32, torch.bfloat16, torch.float16, torch.float64


def _leaf(shape=(6, 5), p=F32, g=F32, m=F32):
    return (torch.zeros(shape, dtype=p), torch.zeros(shape, dtype=g),
            torch.zeros(shape, dtype=m), torch.zeros(shape, dtype=m))


def _gather(leaves):
    return cuda_adamw.gather(leaves.values())


def _sliced(shape, axis, dtype=F32):
    """The second half of a tensor of ``shape`` along ``axis``, as ZeRO's
    rank 1 holds it (``parallel/zero.py`` ``_slice``)."""
    n = shape[axis] // 2
    return torch.arange(int(np.prod(shape)), dtype=dtype).view(shape).narrow(axis, n, n)


@pytest.mark.parametrize("p", [F32, BF16, F16, F64])
@pytest.mark.parametrize("g", [F32, BF16, F16])
@pytest.mark.parametrize("m", [F32, BF16, F16, torch.int8])
def test_route_by_dtype(p, g, m):
    """fp32 or bf16 parameters, gradients and moments take the kernel, in
    any combination; a leaf on the card with fp16, fp64 or int8 (outside
    the int8 moments' own update) is refused."""
    leaf = _leaf(p=p, g=g, m=m)
    if {p, g, m} <= {F32, BF16}:
        groups = _gather({"a": leaf})
        assert list(groups) == [(-1, p, g, m)] and groups[(-1, p, g, m)].grads[0] is leaf[1]
    else:
        with pytest.raises(ValueError, match="fp32 or bf16"):
            _gather({"a": leaf})


@pytest.mark.parametrize("layout, expect", [
    ("contiguous", (30, 30)), ("size_one_dims", (30, 30)),
    ("last_axis", (1536, 3072)), ("word_table", (384, 768)),
    ("middle_axis", (20, 40)), ("first_axis", (2304, 2304)),
    ("transposed", None), ("channels_last", None), ("expanded", None)])
def test_rows_of_reads_a_layout_as_rows(layout, expect):
    """ZeRO's slices on any axis of a contiguous leaf are rows of one
    length; a permuted or overlapping layout is not."""
    t = {"contiguous": lambda: torch.zeros(6, 5),
         "size_one_dims": lambda: torch.zeros(1, 6, 1, 5)[:, :, :1],
         "last_axis": lambda: _sliced((768, 3072), 1),
         "word_table": lambda: _sliced((11, 768), 1),
         "middle_axis": lambda: _sliced((3, 4, 10), 1),
         "first_axis": lambda: _sliced((6, 768), 0),
         "transposed": lambda: torch.zeros(6, 5).t(),
         "channels_last": lambda: torch.zeros(4, 3, 2, 2).contiguous(
             memory_format=torch.channels_last),
         "expanded": lambda: torch.tensor(7.0).expand(4, 3)}[layout]()
    assert cuda_adamw.rows_of(t) == expect
    if expect is not None:  # the rows cover the tensor's elements in order
        cols, stride = expect
        base = t.as_strided((t.untyped_storage().nbytes() // t.element_size(),), (1,), 0)
        rows = t.numel() // cols
        at = (t.storage_offset() + torch.arange(rows)[:, None] * stride
              + torch.arange(cols)).reshape(-1)
        assert torch.equal(base[at], t.reshape(-1))


@pytest.mark.parametrize("which", [0, 2, 3])
def test_a_sliced_parameter_or_moment_takes_the_kernel_by_its_rows(which):
    """A parameter or moment that is ZeRO's slice of a (12, 16) leaf on its
    last axis: 12 rows of 8, its row stride 16, the other arrays' 8."""
    leaf = list(_leaf((12, 8)))
    leaf[which] = _sliced((12, 16), 1)
    (group,) = _gather({"a": tuple(leaf), "b": _leaf()}).values()
    strides = [8, 8, 8, 8]
    strides[which] = 16
    p, g, m, v = leaf
    assert group.rows[0] == (p.data_ptr(), m.data_ptr(), v.data_ptr(), 96, 8, *strides)
    assert group.rows[1][3:] == (30,) * 6 and group.grads[0] is g


@pytest.mark.parametrize("which", [0, 2, 3])
def test_a_parameter_or_moment_in_another_layout_is_refused(which):
    leaf = list(_leaf((5, 6)))
    leaf[which] = torch.zeros((6, 5), dtype=leaf[which].dtype).t()
    with pytest.raises(ValueError, match="rows of one length"):
        _gather({"a": tuple(leaf), "b": _leaf()})


def test_slices_of_two_row_lengths_are_refused():
    p, g, _, v = _leaf((3, 4, 10))
    with pytest.raises(ValueError, match="rows of one length"):
        _gather({"a": (_sliced((3, 8, 10), 1), g, _sliced((3, 4, 20), 2), v)})


@pytest.mark.parametrize("layout", ["transposed", "channels_last", "expanded", "other_rows"])
def test_a_gradient_in_another_layout_is_copied_for_the_kernel(layout):
    """The ViLT patch projection's gradient comes from the convolution's
    backward channels last; the kernel takes the leaf with a contiguous
    copy of it (equal values), the parameter and moments as they are.  A
    gradient sliced otherwise than its sliced parameter is copied too."""
    p, _, m, v = _leaf((4, 3, 2, 2))
    g = torch.arange(48, dtype=F32).view(4, 3, 2, 2)
    other = {"transposed": g.permute(3, 2, 1, 0).contiguous().permute(3, 2, 1, 0),
             "channels_last": g.contiguous(memory_format=torch.channels_last),
             "expanded": torch.tensor(7.0).expand(4, 3, 2, 2),
             "other_rows": _sliced((4, 3, 2, 4), 3)}[layout]
    if layout == "other_rows":
        p = _sliced((4, 6, 2, 2), 1)
    assert not other.is_contiguous()
    (group,) = _gather({"a": (p, other, m, v)}).values()
    (row,) = group.rows
    cols = 12 if layout == "other_rows" else 48
    assert row[:5] == (p.data_ptr(), m.data_ptr(), v.data_ptr(), 48, cols)
    assert row[6:] == (cols,) * 3 and row[5] == (24 if layout == "other_rows" else 48)
    assert group.grads[0].is_contiguous() and torch.equal(group.grads[0], other)


def test_a_gradient_sliced_as_its_parameter_is_read_in_place():
    """ZeRO's gradient slice has its parameter's layout: no copy."""
    p, g = _sliced((5, 16), 1), _sliced((5, 16), 1)
    m, v = torch.zeros(5, 8), torch.zeros(5, 8)
    (group,) = _gather({"a": (p, g, m, v)}).values()
    assert group.rows == [(p.data_ptr(), m.data_ptr(), v.data_ptr(), 40, 8, 16, 16, 8, 8)]
    assert group.grads[0] is g


@pytest.mark.parametrize("mismatch", ["moments", "size", "shape"])
def test_mismatched_leaves_are_refused(mismatch):
    """Moments of two types, a gradient of another size or shape."""
    p, g, m, v = _leaf()
    leaf = {"moments": (p, g, m, torch.zeros_like(m, dtype=BF16)),
            "size": (p, torch.zeros(31), m, v),
            "shape": (p, torch.zeros(5, 6), m, v)}[mismatch]
    with pytest.raises(ValueError):
        _gather({"ok": _leaf(), "bad": leaf})


def test_the_cpu_takes_the_loop():
    leaves = {"a": _leaf(), "b": _leaf(p=BF16, g=BF16, m=BF16), "c": _leaf(p=F16, m=F64)}
    split = cuda_adamw.split(*({k: leaf[i] for k, leaf in leaves.items()} for i in range(4)))
    assert split == ({}, ["a", "b", "c"])


def test_groups_by_dtype_in_order():
    leaves = {"a": _leaf(), "b": _leaf(p=BF16, g=BF16, m=BF16), "c": _leaf(),
              "d": _leaf(g=BF16, m=BF16), "e": _leaf(p=BF16, g=BF16, m=BF16)}
    groups = _gather(leaves)
    assert list(groups) == [(-1, F32, F32, F32), (-1, BF16, BF16, BF16),
                            (-1, F32, BF16, BF16)]
    assert [[row[0] for row in v.rows] for v in groups.values()] == [
        [leaves[k][0].data_ptr() for k in ks] for ks in (("a", "c"), ("b", "e"), ("d",))]
    assert [v.grads for v in groups.values()] == [
        [leaves[k][1] for k in ks] for ks in (("a", "c"), ("b", "e"), ("d",))]


def test_block_table_cuts_each_leaf_into_chunks():
    sizes = [0, 1, 7, CHUNK, CHUNK + 1, 3 * CHUNK]
    table = cuda_adamw.block_table(sizes)
    assert table.dtype == np.int32
    assert table.tolist() == [[1, 0], [2, 0], [3, 0], [4, 0], [4, 1], [5, 0], [5, 1], [5, 2]]


def _group(sizes, dtype=F32):
    return cuda_adamw.gather([_leaf((n,), p=dtype, g=dtype, m=dtype) for n in sizes])[
        (-1, dtype, dtype, dtype)]


def _same(a, b):
    """The same launches: the same device tables, not rebuilt."""
    return len(a) == len(b) and all(x.leaves is y.leaves and x.blocks is y.blocks
                                    for x, y in zip(a, b))


def test_tables_are_kept_while_the_tensors_stay():
    fused = cuda_adamw.FusedAdamW()
    key = (-1, F32, F32, F32)
    leaves = [_leaf((n,)) for n in (3, CHUNK + 5, 768)]
    first = fused.tables(key, cuda_adamw.gather(leaves)[key])
    assert len(first) == 1
    assert first[0].leaves.tolist() == [[p.data_ptr(), m.data_ptr(), v.data_ptr(), *[n] * 6]
                                        for p, _, m, v in leaves if (n := p.numel())]
    assert first[0].blocks.tolist() == [[0, 0], [1, 0], [1, 1], [2, 0]]
    # new gradients, and new views of the same parameters (ZeRO's slices)
    again = [(p.view(-1), torch.ones_like(g), m, v) for p, g, m, v in leaves]
    assert _same(fused.tables(key, cuda_adamw.gather(again)[key]), first)


@pytest.mark.parametrize("change", ["moments", "parameter", "size", "layout"])
def test_tables_are_rebuilt_when_the_tensors_change(change):
    fused = cuda_adamw.FusedAdamW()
    key = (-1, F32, F32, F32)
    leaves = [_leaf((n, 4)) for n in (3, 8)]
    first = fused.tables(key, cuda_adamw.gather(leaves)[key])
    p, g, m, v = leaves[1]
    leaves[1] = {"moments": (p, g, m.clone(), v.clone()),
                 "parameter": (p.clone(), g, m, v),
                 "size": (p[:4], g[:4], m[:4], v[:4]),
                 # the same first address, the rows of a slice
                 "layout": (p.view(4, 8)[:, :4], g[:4], m[:4], v[:4])}[change]
    group = cuda_adamw.gather(leaves)[key]
    rebuilt = fused.tables(key, group)
    assert not _same(rebuilt, first) and rebuilt[0].leaves.tolist() == [list(r) for r in group.rows]
    assert _same(fused.tables(key, group), rebuilt)


def test_more_leaves_than_a_launch_takes_split_into_launches():
    fused = cuda_adamw.FusedAdamW()
    launches = fused.tables((-1, F32, F32, F32), _group([2] * (MAX_LEAVES + 3)))
    assert [(t.lo, t.leaves.shape[0]) for t in launches] == [(0, MAX_LEAVES),
                                                             (MAX_LEAVES, 3)]
    # each launch indexes its own leaves and gradients from 0
    assert launches[1].blocks.tolist() == [[0, 0], [1, 0], [2, 0]]


def _flat(t):
    """``t``'s whole storage as a 1-d tensor, and ``t``'s offset in it."""
    n = t.untyped_storage().nbytes() // t.element_size()
    return t.as_strided((n,), (1,), 0), t.storage_offset()


def _stand_in(tx, tensors, covered, calls):
    """A launch of csrc/adamw.cu in Python: per block, the loop's update
    of the block's elements of its leaf, each array read at its row
    stride; ``covered`` counts each storage element's updates by
    parameter address."""
    by_ptr = {t.data_ptr(): t for t in tensors}

    def launch(key, launch, grads, hyper):
        assert hyper == (tx.b1, 1 - tx.b1, tx.b2, 1 - tx.b2, hyper.neg_step, tx.eps,
                         hyper.decay, tx.weight_decay > 0.0)
        assert len(grads) == launch.leaves.shape[0] <= MAX_LEAVES
        calls.append(key)
        rows = launch.leaves.tolist()
        for leaf, chunk in launch.blocks.tolist():
            p_ptr, m_ptr, v_ptr, n, cols, *strides = rows[leaf]
            arrays = [by_ptr[p_ptr], grads[leaf], by_ptr[m_ptr], by_ptr[v_ptr]]
            assert [a.dtype for a in arrays[:3]] == list(key[1:])
            i = torch.arange(chunk * CHUNK, min((chunk + 1) * CHUNK, n))
            row, col = i // cols, i % cols
            at = [(*_flat(a), row * s + col) for a, s in zip(arrays, strides)]
            p, g, m, v = (flat[off + idx] for flat, off, idx in at)
            tx._leaf_step(p, g, m, v, -hyper.neg_step, hyper.decay)
            for (flat, off, idx), new in zip(at[::2] + at[3:], (p, m, v)):
                flat[off + idx] = new
            flat, off, idx = at[0]
            covered.setdefault(p_ptr, torch.zeros(flat.numel(), dtype=torch.int64)
                               ).index_add_(0, off + idx, torch.ones_like(idx))

    return launch


# Leaf shapes: one element, a ragged 7, a LayerNorm bias, more than a chunk,
# rows longer than a chunk, and a small matrix
STAND_IN_SHAPES = [(1,), (7,), (768,), (CHUNK + 5,), (3, CHUNK + 100), (48, 64)]


@pytest.mark.parametrize("state_dtype", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("correct_bias", [False, True])
def test_fused_route_updates_every_element_once_as_the_loop(monkeypatch, state_dtype,
                                                             weight_decay, correct_bias):
    """HfAdamW.step_ with the kernel's route and a stand-in launch: every
    element of every fused leaf updated once a step, ZeRO-style slices by
    their row strides (a parameter and its gradient sliced, moments
    contiguous; rows of 5, not a multiple of the kernel's vector), one leaf
    left to the loop as the CPU's would be, the counters, and the result
    bit-equal to the loop's (``plain=True``) over four steps of a warmup
    schedule."""
    rng = np.random.default_rng(4)
    p0 = {f"w{i}": rng.normal(size=s).astype(np.float32) for i, s in enumerate(STAND_IN_SHAPES)}
    p0["half"] = rng.normal(size=(33, 8)).astype(np.float32)
    make = lambda: topt.hf_adamw(topt.linear_warmup_linear_decay(1e-2, 2, 6),
                                 weight_decay=weight_decay, correct_bias=correct_bias,
                                 state_dtype=state_dtype)
    tx, tx_ref = make(), make()
    params = {k: torch.tensor(v) for k, v in p0.items()}
    params["half"] = params["half"].to(BF16)
    whole = {"sliced": torch.tensor(rng.normal(size=(24, 16)).astype(np.float32)),
             "sliced3": torch.tensor(rng.normal(size=(3, 6, 10)).astype(np.float32))}
    params["sliced"] = whole["sliced"].narrow(1, 8, 8)
    params["sliced3"] = whole["sliced3"].narrow(2, 0, 5)
    params["loop"] = torch.tensor(rng.normal(size=(9, 4)).astype(np.float32))
    ref = {k: v.clone() for k, v in params.items()}
    state, ref_state = tx.init(params), tx_ref.init(ref)
    tensors = [*params.values(), *state.mu.values(), *state.nu.values()]
    # the CPU's route takes the loop; these leaves stand for the card's
    monkeypatch.setattr(cuda_adamw, "split", lambda p, g, m, v: (cuda_adamw.gather(
        (p[k], g[k], m[k], v[k]) for k in p if k != "loop"), ["loop"]))
    for step in range(4):
        grads = {k: torch.tensor(rng.normal(size=tuple(p.shape)).astype(np.float32)).to(p.dtype)
                 for k, p in params.items()}
        full = torch.tensor(rng.normal(size=(24, 16)).astype(np.float32))
        grads["sliced"] = full.narrow(1, 8, 8)  # read in place, at its row stride
        covered, calls = {}, []
        monkeypatch.setattr(cuda_adamw, "fused_adamw", _stand_in(tx, tensors, covered, calls))
        state = tx.step_(params, grads, state)
        assert (tx.fused_leaves, tx.loop_leaves) == (len(params) - 1, 1)
        assert len(calls) == 2  # the fp32 and the bf16 parameters
        assert sorted(covered) == sorted(p.data_ptr() for k, p in params.items() if k != "loop")
        for k, p in params.items():
            if k != "loop":
                flat, off = _flat(p)
                mask = torch.zeros_like(flat, dtype=torch.int64)
                mask.as_strided(p.shape, p.stride(), off).fill_(1)
                assert torch.equal(covered[p.data_ptr()], mask), k
        ref_state = tx_ref.step_(ref, grads, ref_state, plain=True)
        assert (tx_ref.fused_leaves, tx_ref.loop_leaves) == (0, len(params))
        for k in params:
            for a, b in ((params[k], ref[k]), (state.mu[k], ref_state.mu[k]),
                         (state.nu[k], ref_state.nu[k])):
                assert torch.equal(a, b), (step, k)
    assert len(tx._fused._tables) == 2 and tx_ref._fused._tables == {}


@pytest.mark.parametrize("state_dtype", [None, "float32", "bfloat16"])
def test_cpu_steps_run_the_loop_and_match_jax(state_dtype):
    """On the CPU every leaf takes the loop (the counters say so), and the
    result is still the JAX hf_adamw's within fp32 rounding, as in
    ``test_torch_training.py``."""
    rng = np.random.default_rng(1)
    p0 = {"w": rng.normal(size=(5, 4)).astype(np.float32),
          "b": rng.normal(size=(4,)).astype(np.float32)}
    tx_t = topt.hf_adamw(1e-2, weight_decay=0.01, state_dtype=state_dtype)
    tx_j = jopt.hf_adamw(1e-2, weight_decay=0.01,
                         state_dtype=jnp.bfloat16 if state_dtype == "bfloat16" else None)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st_t, st_j = tx_t.init(tp), tx_j.init(jp)
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
        st_t = tx_t.step_(tp, {k: torch.tensor(v) for k, v in g.items()}, st_t)
        assert (tx_t.fused_leaves, tx_t.loop_leaves) == (0, 2)
        upd, st_j = tx_j.update({k: jnp.asarray(v) for k, v in g.items()}, st_j, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, upd)
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-7, rtol=0)
    assert tx_t._fused._tables == {}


def test_int8_moments_take_their_own_update():
    tx = topt.hf_adamw(1e-3, state_dtype="int8")
    params = {"w": torch.zeros(300)}
    tx.step_(params, {"w": torch.ones(300)}, tx.init(params))
    assert (tx.fused_leaves, tx.loop_leaves) == (0, 1)
