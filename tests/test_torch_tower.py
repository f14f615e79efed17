"""binius_tpu_torch tower layout and scalar arithmetic against the JAX
package's `fields/tower.py` and `fields/scalar.py`, bit-exact."""

import numpy as np
import pytest
import torch

from binius_tpu.fields import scalar as jscalar
from binius_tpu.fields import tower as jtower
from binius_tpu_torch.convert import from_reference, to_reference
from binius_tpu_torch.device import i32, shr
from binius_tpu_torch.fields import scalar, tower

torch.set_num_threads(1)  # the suite's test processes share the cores


@pytest.mark.parametrize("level", [3, 4, 5, 6, 7])
def test_scalar_mul_and_invert_match_reference(level):
    rng = np.random.default_rng(level)
    vals = [int.from_bytes(rng.bytes(16), "little") % (1 << (1 << level)) or 1 for _ in range(20)]
    for a, b in zip(vals, vals[1:]):
        assert scalar.mul(level, a, b) == jscalar.mul_py(level, a, b)
    for a in vals:
        assert scalar.invert(level, a) == jscalar.invert_py(level, a)


@pytest.mark.parametrize("level", [5, 6, 7])
def test_layout_round_trips_like_reference(level):
    rng = np.random.default_rng(level)
    shape = jtower.elem_shape(level, (8,))
    arr = rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
    t = tower.from_numpy(level, arr)
    assert tuple(t.shape) == tower.elem_shape(level, (8,)) == shape
    assert tower.to_ints(level, t) == jtower.to_ints(level, arr)
    assert tower.to_ints(level, tower.add(level, t, t)) == [0] * 8
    assert tower.zeros(level, (8,)).shape == t.shape
    if level == 6:
        u64 = rng.integers(0, 1 << 63, size=8, dtype=np.uint64)
        assert np.array_equal(to_reference(tower.from_numpy(6, u64)), np.asarray(jtower.from_numpy(6, u64)))


@pytest.mark.parametrize("level,sub_level", [(7, 0), (7, 3), (7, 4), (7, 5), (5, 3), (6, 4)])
def test_join_from_subfield_matches_reference(level, sub_level):
    n = 1 << (level - sub_level)
    rng = np.random.default_rng(level * 10 + sub_level)
    shape = jtower.elem_shape(sub_level, (4, n))
    coeffs = rng.integers(0, 1 << min(32, 1 << sub_level), size=shape, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jtower.join_from_subfield(level, sub_level, coeffs))
    got = tower.join_from_subfield(level, sub_level, from_reference(coeffs, "cpu"))
    assert np.array_equal(to_reference(got), want)


def test_p1_helpers_match_reference():
    bits = np.random.default_rng(4).integers(0, 2, size=256, dtype=np.uint32)
    packed = tower.pack_b1(from_reference(bits, "cpu"))
    assert np.array_equal(to_reference(packed), np.asarray(jtower.pack_b1(bits)))
    assert np.array_equal(to_reference(tower.unpack_b1(packed)), bits)
    level, data = tower.maybe_pack_b1(0, from_reference(bits, "cpu"))
    assert level == tower.P1 == jtower.P1 and torch.equal(data, packed)
    assert tower.p1_n_elems(level, data) == 256
    assert torch.equal(tower.resolve_p1(level, data)[1], from_reference(bits, "cpu"))
    assert tower.maybe_pack_b1(0, from_reference(bits[:64], "cpu"))[0] == 0


def test_word_helpers():
    x = torch.tensor([i32(0x80000001), -1, 5], dtype=torch.int32)
    assert i32(0xFFFFFFFF) == -1 and i32(0x7FFFFFFF) == 0x7FFFFFFF
    assert shr(x, 1).tolist() == [0x40000000, 0x7FFFFFFF, 2]
    assert shr(x, 31).tolist() == [1, 1, 0]
