"""The port's field isomorphisms, AES tower, POLYVAL field, F2 linear maps
on tensors and scalar helpers against the JAX package's. Every comparison
is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binius_tpu.fields import aes as jaes
from binius_tpu.fields import isomorphism as jiso
from binius_tpu.fields import scalar as jscalar
from binius_tpu.fields import tower as jtower
from binius_tpu_torch.fields import aes, isomorphism as iso, scalar, tower

torch.set_num_threads(1)  # the suite's test processes share the cores

# the prime factors of 2^(2^k) - 1 for k = 5, 6, 7 (Fermat numbers F_0..F_6)
_ORDER_PRIMES = {
    5: (3, 5, 17, 257, 65537),
    6: (3, 5, 17, 257, 641, 65537, 6700417),
    7: (3, 5, 17, 257, 641, 65537, 274177, 6700417, 67280421310721),
}


def _ints(rng, bits: int, n: int) -> list[int]:
    return [int.from_bytes(rng.bytes(max(1, bits // 8)), "little") & ((1 << bits) - 1)
            for _ in range(n)]


def test_polyval_matches_reference_and_its_laws():
    rng = np.random.default_rng(1)
    a, b, c = (_ints(rng, 128, 6) for _ in range(3))
    for x, y, z in zip(a, b, c):
        xy = iso.polyval_mul(x, y)
        assert xy == jiso.polyval_mul(x, y) == iso.polyval_mul(y, x)
        assert iso.polyval_mul(xy, z) == iso.polyval_mul(x, iso.polyval_mul(y, z))
        assert iso.polyval_mul(x, y ^ z) == xy ^ iso.polyval_mul(x, z)
        assert iso.polyval_mul(x, iso.polyval_inv(x)) == 1
        assert iso.polyval_pow(x, 77) == jiso.polyval_pow(x, 77)
    assert iso.polyval_inv(a[0]) == jiso.polyval_inv(a[0])
    assert iso.POLYVAL_MODULUS == jiso.POLYVAL_MODULUS


def test_tower_embedding_and_polyval_basis_change():
    assert iso.derive_tower_embedding(iso.polyval_mul) == \
        jiso.derive_tower_embedding(jiso.polyval_mul)
    assert iso.canonical_basis_images("polyval") == jiso.canonical_basis_images("polyval")
    assert iso.canonical_to_polyval_matrix() == jiso.canonical_to_polyval_matrix()
    assert iso.polyval_to_canonical_matrix() == jiso.polyval_to_canonical_matrix()
    rng = np.random.default_rng(2)
    for x, y in zip(_ints(rng, 128, 5), _ints(rng, 128, 5)):
        px, py = iso.canonical_to_polyval(x), iso.canonical_to_polyval(y)
        assert px == jiso.canonical_to_polyval(x)
        assert iso.polyval_to_canonical(px) == x
        # a field isomorphism: products map to products
        assert iso.canonical_to_polyval(scalar.mul(7, x, y)) == iso.polyval_mul(px, py)


def test_aes_b8_and_basis():
    assert iso.aes_to_canonical_b8_matrix() == jiso.aes_to_canonical_b8_matrix()
    assert iso.canonical_to_aes_b8_matrix() == jiso.canonical_to_aes_b8_matrix()
    for a in range(0, 256, 7):
        for b in range(0, 256, 11):
            assert iso.aes_b8_mul(a, b) == jiso.aes_b8_mul(a, b)


@pytest.mark.parametrize("level", [3, 4, 5, 6, 7])
def test_aes_ops_match_reference(level):
    rng = np.random.default_rng(level)
    bits = 1 << level
    for x, y in zip(_ints(rng, bits, 4), _ints(rng, bits, 4)):
        x |= 1
        assert aes.aes_to_canonical(level, x) == jaes.aes_to_canonical(level, x)
        assert aes.canonical_to_aes(level, aes.aes_to_canonical(level, x)) == x
        assert aes.mul(level, x, y) == jaes.mul(level, x, y)
        assert aes.square(level, x) == jaes.square(level, x)
        assert aes.invert(level, x) == jaes.invert(level, x)
        assert aes.mul(level, x, aes.invert(level, x)) == 1
        assert aes.pow(level, x, 1000003) == jaes.pow(level, x, 1000003)
    assert aes.GENERATORS == jaes.GENERATORS
    g = aes.aes_to_canonical(level, aes.GENERATORS[level])
    order = (1 << bits) - 1
    if level <= 4:
        assert scalar.multiplicative_order(level, g) == order == \
            jscalar.multiplicative_order(level, g)
    else:   # a generator: g^(order / p) != 1 for each prime p of the order
        assert all(scalar.pow(level, g, order // p) != 1 for p in _ORDER_PRIMES[level])
        assert scalar.pow(level, g, order) == 1


@pytest.mark.parametrize("level", [3, 5, 6, 7])
def test_aes_convert_device(level):
    rng = np.random.default_rng(10 + level)
    vals = _ints(rng, 1 << level, 9)
    x = tower.from_ints(level, vals, "cpu")
    to_aes = aes.convert_device(level, x, to_canonical=False)
    assert tower.to_ints(level, to_aes) == [aes.canonical_to_aes(level, v) for v in vals]
    assert torch.equal(aes.convert_device(level, to_aes, to_canonical=True), x)
    if level == 7:  # each eager JAX call compiles: one level against its device path
        want = jaes.convert_device(level, jnp.asarray(x.numpy().view(np.uint32)), False)
        assert np.array_equal(to_aes.numpy().view(np.uint32), np.asarray(want))


@pytest.mark.parametrize("level", [0, 2, 3, 4, 5, 6, 7])
def test_apply_bitmatrix_and_pow_int(level):
    rng = np.random.default_rng(20 + level)
    bits = 1 << level
    cols = _ints(rng, bits, bits)
    vals = _ints(rng, bits, 11)
    x = tower.from_ints(level, vals, "cpu")
    got = tower.apply_bitmatrix(level, cols, x)
    assert tower.to_ints(level, got) == [jscalar.apply_linmap(cols, v) for v in vals]
    if level in (5, 7):  # each eager JAX call compiles: the lane and limb layouts
        want = jtower.apply_bitmatrix(level, cols, jnp.asarray(x.numpy().view(np.uint32)))
        assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    for e in (0, 1, 2, 0x1F3A5):
        assert tower.to_ints(level, tower.pow_int(level, x, e)) == \
            [jscalar.pow(level, v, e) for v in vals]


def test_polyval_matrix_on_tensors():
    """The basis change applied to a B128 batch by `apply_bitmatrix`."""
    rng = np.random.default_rng(30)
    vals = _ints(rng, 128, 7)
    got = tower.apply_bitmatrix(7, iso.canonical_to_polyval_matrix(),
                                tower.from_ints(7, vals, "cpu"))
    assert tower.to_ints(7, got) == [jiso.canonical_to_polyval(v) for v in vals]


def test_scalar_helpers_match_reference():
    rng = np.random.default_rng(40)
    a, b = _ints(rng, 128, 2)
    assert scalar.add(a, b) == jscalar.add(a, b)
    for level in (2, 3, 4):
        for v in (1, 2, (1 << (1 << level)) - 1):
            assert scalar.multiplicative_order(level, v) == jscalar.multiplicative_order(level, v)
    for level in (3, 5, 7):
        c = _ints(rng, 1 << level, 1)[0]
        assert scalar.mul_matrix(level, c) == jscalar.mul_matrix(level, c)
        assert scalar.square_matrix(level) == jscalar.square_matrix(level)
        f = (lambda x, c=c, level=level: scalar.mul(level, c, scalar.square(level, x)))
        assert scalar.linmap_columns(level, f) == jscalar.linmap_columns(level, f)
        assert np.array_equal(scalar.matrix_to_numpy_bits(scalar.mul_matrix(level, c), 1 << level),
                              jscalar.matrix_to_numpy_bits(jscalar.mul_matrix(level, c),
                                                           1 << level))
    assert np.array_equal(scalar.b8_mul_alpha_table(), jscalar.b8_mul_alpha_table())
    for level in range(8):
        for v in _ints(rng, 1 << level, 20):
            assert scalar.square(level, v) == jscalar.square(level, v)
