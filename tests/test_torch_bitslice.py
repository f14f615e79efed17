"""binius_tpu_torch bitsliced layout (plain version of K2) against the JAX
package's `fields/bitslice.py`, bit-exact, on identical numpy inputs."""

import numpy as np
import pytest
import torch

from binius_tpu.fields import bitslice as jbs
from binius_tpu.fields import tower as jtower
from binius_tpu_torch.convert import from_reference, to_reference
from binius_tpu_torch.fields import bitslice, bitslice_cuda, tower

torch.set_num_threads(1)  # the suite's test processes share the cores


def _words(shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=shape, dtype=np.uint32)


@pytest.mark.parametrize("groups,n_words", [(1, 1), (4, 3), (2, 130)])
def test_transpose32_matches_reference(groups, n_words):
    import jax.numpy as jnp

    m = _words((groups, 32, n_words), seed=groups * 1000 + n_words)
    want = np.asarray(jbs._transpose32(jnp.asarray(m)))
    got = to_reference(bitslice._transpose32(from_reference(m, "cpu")))
    assert np.array_equal(got, want)


def test_transpose32_is_an_involution():
    m = from_reference(_words((3, 32, 17), seed=5), "cpu")
    assert torch.equal(bitslice._transpose32(bitslice._transpose32(m)), m)


@pytest.mark.parametrize("level", [3, 5, 7])
def test_to_from_bitsliced_match_reference(level):
    import jax.numpy as jnp

    n = 96
    limbs = jtower.n_limbs(level)
    shape = (n, limbs) if jtower.has_limb_dim(level) else (n,)
    a = _words(shape, seed=level)
    if level < 5:
        a &= np.uint32((1 << (1 << level)) - 1)
    planes_want = np.asarray(jbs.to_bitsliced(level, jnp.asarray(a)))
    planes = bitslice_cuda.to_bitsliced(level, from_reference(a, "cpu"))
    assert np.array_equal(to_reference(planes), planes_want)
    back = bitslice_cuda.from_bitsliced(level, planes)
    assert np.array_equal(to_reference(back), np.asarray(jbs.from_bitsliced(level, jnp.asarray(planes_want))))
    assert np.array_equal(to_reference(back), a)


@pytest.mark.parametrize("level", [0, 4, 5, 7])
def test_mul_bs_network_matches_scalar(level):
    """The Karatsuba gate network the NTT kernels run, on 32-element words."""
    from binius_tpu.fields import scalar

    rng = np.random.default_rng(level + 40)
    n = 64
    av = [int.from_bytes(rng.bytes(16), "little") & ((1 << (1 << level)) - 1) for _ in range(n)]
    bv = [int.from_bytes(rng.bytes(16), "little") & ((1 << (1 << level)) - 1) for _ in range(n)]
    a = bitslice.to_bitsliced(level, tower.from_numpy(level, _ints_np(level, av)))
    b = bitslice.to_bitsliced(level, tower.from_numpy(level, _ints_np(level, bv)))
    prod = torch.stack(bitslice._mul_bs(level, list(a.unbind(0)), list(b.unbind(0))))
    got = tower.to_ints(level, bitslice.from_bitsliced(level, prod))
    assert got == [scalar.mul(level, x, y) for x, y in zip(av, bv)]


def _ints_np(level, vals):
    if level <= 5:
        return np.array(vals, dtype=np.uint32)
    k = jtower.n_limbs(level)
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(k)] for v in vals], dtype=np.uint32)


def test_convert_round_trip_keeps_bits():
    a = _words((16, 4), seed=9)
    t = from_reference(a, "cpu")
    assert t.dtype == torch.int32 and t.device.type == "cpu"
    assert np.array_equal(to_reference(t), a)
    assert tower.to_ints(7, t) == jtower.to_ints(7, a)
