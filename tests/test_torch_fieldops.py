"""binius_tpu_torch tower arithmetic (mul, square, invert, mul_alpha,
scale_subfield) at every level against the JAX package's `fields/tower.py`
on the CPU, the gate network (`bitslice.mul_planes`) against the JAX
package's `bitslice.mul_planes`, and the plain version of K1 (`bitslice.mul`,
packed in and out) against the JAX package's `scalar.mul` and `tower.mul`,
bit-exact, on identical numpy inputs. The JAX calls that are cheaper eagerly than compiled run under
`jax.disable_jit`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binius_tpu.fields import bitslice as jbitslice
from binius_tpu.fields import scalar as jscalar
from binius_tpu.fields import tower as jtower
from binius_tpu_torch.convert import from_reference, to_reference
from binius_tpu_torch.fields import bitslice, bitslice_cuda, scalar, tower

torch.set_num_threads(1)  # the suite's test processes share the cores

N = 40   # not a multiple of 32: the bitsliced levels pad


def _elems(level, seed, n=N):
    rng = np.random.default_rng(seed)
    if tower.has_limb_dim(level):
        shape = (n, tower.n_limbs(level))
        return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return rng.integers(0, 1 << (1 << level), n, dtype=np.uint64).astype(np.uint32)


def _same(got: torch.Tensor, want) -> bool:
    return np.array_equal(to_reference(got), np.asarray(want))


@pytest.mark.parametrize("level", range(8))
def test_tower_ops_match_reference(level):
    a, b = _elems(level, level), _elems(level, level + 100)
    a[0] = 0   # invert(0) = 0 in both
    ta, tb = from_reference(a, "cpu"), from_reference(b, "cpu")
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ints = jtower.to_ints(level, ja)
    assert tower.to_ints(level, ta) == ints
    assert _same(tower.from_ints(level, ints), jtower.from_ints(level, ints))
    prod = tower.mul(level, ta, tb)
    assert _same(prod, jtower.mul(level, ja, jb))
    assert _same(tower.sum_elems(level, prod.reshape(tower.elem_shape(level, (4, N // 4))), -1),
                 jtower.sum_elems(level, jnp.asarray(to_reference(prod)).reshape(
                     tower.elem_shape(level, (4, N // 4))), -1))
    # a scalar operand broadcasts to the batch
    assert torch.equal(tower.mul(level, ta, tb[3]), tower.mul(level, ta, tb[3].expand_as(tb)))
    with jax.disable_jit():
        assert _same(tower.square(level, ta), jtower.square(level, ja))
        assert _same(tower.invert(level, ta), jtower.invert(level, ja))
        assert _same(tower.mul_alpha(level, ta), jtower.mul_alpha(level, ja))
    # the subfields the opening scales by (B1, B8, B32) and the one below
    for sub in sorted({0, 3, 5, level - 1} & set(range(level))):
        x = _elems(sub, sub + 7)
        got = tower.scale_subfield(sub, level, from_reference(x, "cpu"), tb)
        assert _same(got, jtower.scale_subfield(sub, level, jnp.asarray(x), jb)), sub


@pytest.mark.parametrize("level", [5, 6, 7])
def test_mul_planes_matches_reference(level):
    """K1's gate network on a few words; the JAX function is not jitted, so
    its gate network runs eagerly."""
    a, b = _elems(5, level, (1 << level) * 3), _elems(5, level + 9, (1 << level) * 3)
    a, b = a.reshape(1 << level, 3), b.reshape(1 << level, 3)
    want = jbitslice.mul_planes(level, jnp.asarray(a), jnp.asarray(b))
    assert _same(bitslice.mul_planes(level, from_reference(a, "cpu"), from_reference(b, "cpu")),
                 want)


@pytest.mark.parametrize("level", [5, 6, 7])
@pytest.mark.parametrize("scalar_side", [None, 0, 1])
def test_packed_mul_matches_reference(level, scalar_side):
    """The plain version of K1 (`bitslice.mul`, and `bitslice_cuda.mul` on
    CPU tensors) on 300 elements, not a multiple of 32: full x full, and a
    one-element operand on either side, which enters as scalar planes."""
    ops = [_elems(level, level + 20, 300), _elems(level, level + 30, 300)]
    if scalar_side is not None:
        ops[scalar_side] = ops[scalar_side][7]
    ta, tb = (from_reference(np.asarray(x), "cpu") for x in ops)
    got = bitslice.mul(level, ta, tb)
    assert torch.equal(bitslice_cuda.mul(level, ta, tb), got)
    assert _same(got, jtower.mul(level, jnp.asarray(ops[0]), jnp.asarray(ops[1])))
    xs, ys = (jtower.to_ints(level, x.reshape(tower.elem_shape(level, (-1,)))) for x in ops)
    xs, ys = xs * (300 // len(xs)), ys * (300 // len(ys))
    assert tower.to_ints(level, got) == [jscalar.mul(level, x, y) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("level", [5, 6, 7])
def test_bitsliced_mul_broadcasts_like_scalar(level):
    """The K2/K1/K2 composition on (3, 5) x (5,) batches and an empty batch."""
    a, b = from_reference(_elems(level, 1, 15), "cpu"), from_reference(_elems(level, 2, 5), "cpu")
    got = bitslice_cuda.mul(level, a.reshape(tower.elem_shape(level, (3, 5))), b)
    want = [scalar.mul(level, x, y)
            for x, y in zip(tower.to_ints(level, a), tower.to_ints(level, b) * 3)]
    assert tower.to_ints(level, got) == want
    empty = tower.zeros(level, (0,))
    assert bitslice_cuda.mul(level, empty, empty).shape == empty.shape


@pytest.mark.parametrize("level,sub_level", [(7, 0), (7, 3), (7, 5), (7, 6), (5, 2)])
def test_split_and_embed_match_reference(level, sub_level):
    a = _elems(level, level * 10 + sub_level, 6)
    got = tower.split_to_subfield(level, sub_level, from_reference(a, "cpu"))
    want = jtower.split_to_subfield(level, sub_level, jnp.asarray(a))
    assert _same(got, want)
    assert torch.equal(tower.join_from_subfield(level, sub_level, got), from_reference(a, "cpu"))
    x = _elems(sub_level, 3, 6)
    assert _same(tower.embed(sub_level, level, from_reference(x, "cpu")),
                 jtower.embed(sub_level, level, jnp.asarray(x)))


@pytest.mark.parametrize("level", range(8))
def test_scalar_mul_of_subfield_operands_matches_reference(level):
    """The host product runs at the smallest level whose subfield holds
    both operands: operands from every pair of subfields of T_level give
    the JAX package's products."""
    rng = np.random.default_rng(level + 50)
    for la in range(level + 1):
        for lb in range(level + 1):
            for _ in range(4):
                a = int.from_bytes(rng.bytes(16), "little") & ((1 << (1 << la)) - 1)
                b = int.from_bytes(rng.bytes(16), "little") & ((1 << (1 << lb)) - 1)
                assert scalar.mul(level, a, b) == jscalar.mul(level, a, b), (la, lb)
