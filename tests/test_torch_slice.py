"""The ported commit phase end to end: binius_tpu_torch `piop.commit` (plain
versions on the CPU) against the JAX package's `piop.commit` on the same
seeded u32_add witness at total_vars 11 — message, codeword and Merkle
root bit-exact. Also packing of small-field columns and the entry points'
refusal to fall back to the CPU."""

import numpy as np
import pytest
import torch

from binius_tpu.fields import tower as jtower
from binius_tpu.protocols import piop as jpiop
from binius_tpu_torch.convert import from_reference, to_reference
from binius_tpu_torch.fields import tower
from binius_tpu_torch.merkle.tree import commit_codeword_device
from binius_tpu_torch.m3.gadgets.arith import u32_add_columns, u32_add_populate
from binius_tpu_torch.protocols import fri, piop

torch.set_num_threads(1)  # the suite's test processes share the cores

LOG_ROWS = 11   # 4 columns x 2^9 B128 elements: total_vars 11


def _packed(cols, n_vars):
    return [piop.pack_multilinear(tower.P1, from_reference(c, "cpu"), n_vars) for c in cols]


def test_commit_matches_reference():
    import jax.numpy as jnp

    cols = u32_add_columns(LOG_ROWS, seed=3)
    packed = _packed(cols, LOG_ROWS + 5)
    meta = piop.CommitMeta((0,) * packed[0][1] + (4,))
    params = piop.make_commit_params(meta, 100, 1)
    jmeta = jpiop.CommitMeta(meta.n_multilins_by_vars)
    jparams = jpiop.make_commit_params(jmeta, 100, 1)
    assert meta.total_vars == jmeta.total_vars == 11
    assert dataclass_tuple(params) == dataclass_tuple(jparams)

    cw, tree, message = piop.commit(params, meta, packed, device="cpu")
    jcw, jtree, jmessage = jpiop.commit(
        jparams, jmeta, [(jnp.asarray(c.reshape(-1, 4)), pv) for c, (_, pv) in zip(cols, packed)])
    assert np.array_equal(to_reference(message), np.asarray(jmessage))
    assert np.array_equal(to_reference(cw), np.asarray(jcw))
    assert tree.root == jtree.root


def dataclass_tuple(p):
    return (p.log_dim, p.log_inv_rate, p.log_batch_size, p.fold_arities, p.n_test_queries)


def test_u32_add_witness_adds():
    x, y, z, cout = u32_add_columns(8, seed=1)
    assert np.array_equal(z, (x.astype(np.uint64) + y) & 0xFFFFFFFF)
    z2, c2 = u32_add_populate(x, y)
    assert np.array_equal(z2, z) and np.array_equal(c2, cout)


@pytest.mark.parametrize("level,n_vars", [(3, 6), (4, 8), (5, 7), (5, 1), (0, 9)])
def test_pack_multilinear_matches_reference(level, n_vars):
    rng = np.random.default_rng(level * 100 + n_vars)
    data = rng.integers(0, 1 << (1 << level), size=1 << n_vars, dtype=np.uint64).astype(np.uint32)
    got, pv = piop.pack_multilinear(level, from_reference(data, "cpu"), n_vars)
    want, jpv = jpiop.pack_multilinear(level, jtower.from_numpy(level, data), n_vars)
    assert pv == jpv
    assert np.array_equal(to_reference(got), np.asarray(want))


def test_merge_multilins_matches_reference():
    rng = np.random.default_rng(5)
    pieces = [(rng.integers(0, 1 << 32, size=(1 << n, 4), dtype=np.uint32), n) for n in (2, 3, 3, 5)]
    got = piop.merge_multilins([(from_reference(d, "cpu"), n) for d, n in pieces], 7)
    want = jpiop.merge_multilins([(jtower.from_numpy(7, d), n) for d, n in pieces], 7)
    assert np.array_equal(to_reference(got), np.asarray(want))


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    params = fri.FRIParams(log_dim=3, log_inv_rate=1, log_batch_size=2,
                           fold_arities=(2,), n_test_queries=1)
    message = torch.zeros((32, 4), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fri.rs_encode(params, message)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        piop.commit(params, piop.CommitMeta((0,) * 5 + (1,)), [(message, 5)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_reference(np.zeros(4, dtype=np.uint32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        commit_codeword_device(torch.zeros((64, 4), dtype=torch.int32), 2)
